"""peak_device_gib (GiB): the device memory held when the window opens
(the fleet's versions, rings and the set-up's working set that the
allocator keeps) plus the largest rise of one window tick above what was
held at that tick's start (``torch.cuda.max_memory_allocated()`` over
the tick, reset at its start). It sets how many models a card holds. A
tick's rise includes what the tick leaves held, such as a version trained
in it, so the reading does not grow with the number of ticks that fit in
the window."""


def read(run):
    if run.device == "cpu":
        return None
    return (run.held_bytes + max(t.mem_rise for t in run.ticks)) / 2**30
