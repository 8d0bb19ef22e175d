"""The program's span totals over the traced calls, for the per-layer
readers of its spans (`metrics/gc_pause_ms.py`, `docs_ms.py`,
`engine_wait_ms.py`, `engine_host_ms.py`).

`zvec_tpu_torch.utils.profiler.span_totals()` sums each span by its trace
name (`zvec.<name>`: count, total and self seconds) while tracing is on: in a
`--trace 1` run, over the traced calls alone, which run under the profiler.
"""


def per_call(run, names, key):
    """The sum of `key` (`total_s` or `self_s`) over the spans `names`, in
    ms per traced call. None where no call was traced, where the program
    keeps no span totals, or where it recorded no `zvec.query`."""
    if not run.get("trace_calls"):
        return None
    try:
        from zvec_tpu_torch.utils.profiler import span_totals
    except ImportError:
        return None
    totals = span_totals()
    if "zvec.query" not in totals:
        return None
    return sum(totals[n][key] for n in names if n in totals) / run["trace_calls"] * 1e3
