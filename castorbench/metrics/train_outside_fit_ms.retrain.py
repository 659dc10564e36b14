"""train_outside_fit_ms.retrain (ms, program span less device time): per
train tick, the train bin's ``exec.bin`` span less the fit's device time
(CUDA events around the program's ``fit_adam``): the runtime's delta load
and design assembly (``core/runtime.py``), the window predictions and
residual quantiles and the versions' persistence."""


def read(run):
    ticks = [t for t in run.ticks if t.spans and t.fits and t.train_jobs]
    if not ticks:
        return None
    total = 0.0
    for t in ticks:
        phase = [s for s in t.spans if s.name == "exec.phase.train"]
        bins = [s for s in t.spans if s.name == "exec.bin" and any(
            s.t0 >= p.t0 and s.t1 <= p.t1 for p in phase)]
        total += sum(b.t1 - b.t0 for b in bins) \
            - sum(f["device_s"] for f in t.fits)
    return 1e3 * total / len(ticks)
