"""idle_share.retrain (%, device trace): the share of the traced window in which no
operation ran on the card: 1 - (union of the profiler's device
intervals) / (the window)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
