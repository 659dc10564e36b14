"""score_tick_p80_ms (ms, host clock): the 80th percentile (nearest rank)
of the window's score ticks, each from the hour's ingest to the end of
``Castor.tick`` and a synchronise. The cell it serves runs 48 to 87 ticks
a window: about the highest percentile with ten ticks beyond it."""
import math


def read(run):
    secs = sorted(t.seconds for t in run.ticks
                  if t.score_jobs and not t.train_jobs)
    if not secs:
        return None
    return 1e3 * secs[max(math.ceil(0.80 * len(secs)) - 1, 0)]
