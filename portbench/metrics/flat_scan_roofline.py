"""Kernels (`ops/flat_scan.py`: `csrc/flat_scan.cu`, `flat_merge.cu`,
`flat_rescore.cu`): the least time of a call's exact scan
(`roofline/flat_scan.py`, from the call's shapes) over the device time of
every kernel and copy the traced calls launched, per call, in %."""

from portbench.roofline import flat_scan


def read(run):
    tr = run["trace"]
    if tr is None or not run["trace_calls"] or tr["device_s"] <= 0:
        return None
    s = run["shape"]
    least = flat_scan.least_time(s["batch"], s["rows"], s["dim"], s["topk"])["seconds"]
    return 100.0 * least / (tr["device_s"] / run["trace_calls"])
