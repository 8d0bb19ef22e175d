"""Kernels (`ops/topk.py::blockwise_topk_search` and `ops/distance.py` on
int8 codes, the overscan of a quantized FLAT index): the least time of a
call's int8 scan with its candidates (`roofline/quantized_scan.py`, from the
call's shapes) over the device time of every kernel and copy the traced
calls launched, per call, in %."""

from portbench.roofline import quantized_scan


def read(run):
    tr = run["trace"]
    if tr is None or not run["trace_calls"] or tr["device_s"] <= 0:
        return None
    s = run["shape"]
    least = quantized_scan.least_time(s["batch"], s["rows"], s["dim"], s["topk"])["seconds"]
    return 100.0 * least / (tr["device_s"] / run["trace_calls"])
