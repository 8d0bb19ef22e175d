"""Engine: the refine, ms per traced call: the total time of the span
`zvec.refine` (the float32 rows of each query's candidates gathered on the
host, re-scored and re-ranked, in `FlatEngine._search_finalize`). None on a
program without the span."""

from portbench.spans import per_call


def read(run):
    try:
        from zvec_tpu_torch.utils.profiler import span_totals
    except ImportError:
        return None
    if "zvec.refine" not in span_totals():
        return None
    return per_call(run, ["zvec.refine"], "total_s")
