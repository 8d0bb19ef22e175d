"""Host API: pk resolution and Doc building (`_docs_from_results`), ms per
traced call: the self time of the span `zvec.docs`, collections inside it
left out."""

from portbench.spans import per_call


def read(run):
    return per_call(run, ["zvec.docs"], "self_s")
