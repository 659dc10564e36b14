"""exec_self_ms.score (ms, program spans): the score bins' own time per
score tick: each ``exec.bin`` span (``core/executor.py`` ``_run_bin``)
less the ``rollout.device``, ``store.read_many`` and ``runtime.build``
spans inside it."""

CHILDREN = ("rollout.device", "store.read_many", "runtime.build")


def read(run):
    ticks = [t for t in run.ticks if t.spans and t.score_jobs
             and not t.train_jobs]
    if not ticks:
        return None
    total = 0.0
    for t in ticks:
        for b in (s for s in t.spans if s.name == "exec.bin"):
            inner = sum(s.t1 - s.t0 for s in t.spans
                        if s.name in CHILDREN and s.tid == b.tid
                        and s.t0 >= b.t0 and s.t1 <= b.t1)
            total += (b.t1 - b.t0) - inner
    return 1e3 * total / len(ticks)
