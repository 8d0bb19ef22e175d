"""Engine: the engines' host work, ms per traced call: the self time of the
spans `zvec.vector_scan` and `zvec.bf_by_keys` (the dispatch: padding, the
mask, the host-to-device copies, the launches) and `zvec.engine.finalize`
(the post-processing after the wait, the refine among it)."""

from portbench.spans import per_call


def read(run):
    return per_call(run, ["zvec.vector_scan", "zvec.bf_by_keys", "zvec.engine.finalize"], "self_s")
