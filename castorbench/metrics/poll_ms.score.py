"""poll_ms.score (ms, program span): the ``scheduler.poll`` span's mean
per score tick (``core/scheduler.py`` ``poll``)."""


def read(run):
    ticks = [t for t in run.ticks if t.spans and t.score_jobs
             and not t.train_jobs]
    if not ticks:
        return None
    return 1e3 * sum(s.t1 - s.t0 for t in ticks for s in t.spans
                     if s.name == "scheduler.poll") / len(ticks)
