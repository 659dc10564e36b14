"""store_read_ms.score (ms, program span): the ``store.read_many`` spans
per score tick (``timeseries/store.py``: the fleet runtime's watermark
delta read, each series's window merged with its sorted tail)."""


def read(run):
    ticks = [t for t in run.ticks if t.spans and t.score_jobs
             and not t.train_jobs]
    if not ticks:
        return None
    return 1e3 * sum(s.t1 - s.t0 for t in ticks for s in t.spans
                     if s.name == "store.read_many") / len(ticks)
