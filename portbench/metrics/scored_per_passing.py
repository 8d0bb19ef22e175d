"""Engine: rows the engines scanned on the card (padding included) over rows
that passed the filter and the deletes, summed over the traced calls' segments:
the program's counters `zvec.rows_scored` and `zvec.rows_passing`. About 100
where a 1% filter is answered by a scan of the whole segment, 1 where only the
passing rows are scanned. None on a program without the counters."""


def read(run):
    if not run.get("trace_calls"):
        return None
    try:
        from zvec_tpu_torch.utils.profiler import counter_totals
    except ImportError:
        return None
    totals = counter_totals()
    passing = totals.get("zvec.rows_passing", 0)
    if "zvec.rows_scored" not in totals or passing <= 0:
        return None
    return totals["zvec.rows_scored"] / passing
