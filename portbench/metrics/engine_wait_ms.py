"""Engine: the host blocked on the card for a search's results, then their
copy to the host (`VectorIndexEngine._fetch`), ms per traced call: the self
time of the span `zvec.engine.wait`."""

from portbench.spans import per_call


def read(run):
    return per_call(run, ["zvec.engine.wait"], "self_s")
