"""rollout_ms.score (ms, program span): the ``rollout.device`` span per
score tick (``forecast/base.py`` ``_device_rollout``: 24 steps through
``fleet_mlp`` and the copy of the forecasts to the host)."""


def read(run):
    ticks = [t for t in run.ticks if t.spans and t.score_jobs
             and not t.train_jobs]
    if not ticks:
        return None
    return 1e3 * sum(s.t1 - s.t0 for t in ticks for s in t.spans
                     if s.name == "rollout.device") / len(ticks)
