"""score_rate (forecasts/s, host clock): forecasts persisted in the
window's score ticks over those ticks' wall time."""


def read(run):
    ticks = [t for t in run.ticks if t.score_jobs and not t.train_jobs]
    if not ticks:
        return None
    return sum(t.scored for t in ticks) / sum(t.seconds for t in ticks)
