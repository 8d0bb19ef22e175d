"""Engine (`core/flat.py`, `core/hnsw.py`): the engines'
`EngineStats.total_search_secs` over a call (dispatch to the host copy of
the result), ms per call, mean of the window's calls."""


def read(run):
    calls = run["calls"]
    if not calls:
        return None
    return sum(c["engine_s"] for c in calls) / len(calls) * 1e3
