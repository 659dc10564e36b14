"""setup_s (s, host clock): from the process's start to the window's:
imports, the card, the kernels' build where it is not cached, the site,
the set-up ticks that train the fleet and warm the cell's shapes."""


def read(run):
    return run.setup_s
