"""Host API (`model/collection.py`, `db/collection_impl.py`: filter masks,
dispatch, `_docs_from_results`): a call's wall time less the engines'
`EngineStats.total_search_secs` over it, ms per call, mean of the window's
calls."""


def read(run):
    calls = run["calls"]
    if not calls:
        return None
    return sum(c["wall_s"] - c["engine_s"] for c in calls) / len(calls) * 1e3
