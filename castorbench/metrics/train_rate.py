"""train_rate (models/s, host clock): deployments trained in the window's
train ticks over those ticks' wall time; each tick runs from its ingest
to the end of ``Castor.tick`` and a synchronise, and the tick in flight
at the deadline finishes and counts."""


def read(run):
    ticks = [t for t in run.ticks if t.train_jobs]
    if not ticks:
        return None
    return sum(t.trained for t in ticks) / sum(t.seconds for t in ticks)
