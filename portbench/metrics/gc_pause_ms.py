"""Host API: full (generation 2) garbage collections that started inside the
program's query spans, ms per traced call: the total of the span `zvec.gc`
(`zvec_tpu_torch/utils/profiler.py`), 0 where no collection ran."""

from portbench.spans import per_call


def read(run):
    return per_call(run, ["zvec.gc"], "total_s")
