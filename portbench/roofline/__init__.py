"""The least time of a kernel's work, computed from the call's shapes, one
module per kernel (`<kernel>.py`), read by the `<kernel>_roofline` metric."""
