"""Engine: the row mask's host work, ms per traced call: the self time of the
span `zvec.mask` (the AND of the alive and filter masks and its pass count,
and in the engine's dispatch the padded mask, its digest, the device-mask
cache and the copy to the card on a miss). None on a program without the
span."""

from portbench.spans import per_call


def read(run):
    try:
        from zvec_tpu_torch.utils.profiler import span_totals
    except ImportError:
        return None
    if "zvec.mask" not in span_totals():
        return None
    return per_call(run, ["zvec.mask"], "self_s")
