"""fleet_mlp_roofline (%, device trace): the launches' least time (each
launch's bytes at the HBM peak or its operations at the f32 peak,
whichever is larger; ``harness/yardstick.py``, a frozen copy of the
smoke's ``fleet_mlp_bound``) over the ``fleet_mlp`` kernels' device time
in the profiler's trace. Launches are counted by the program's counter
(``kernels/fleet_mlp/ops.py`` ``invocation_count``), each at the score
bin's shape: the bin padded to its power-of-two bucket, one row."""
from castorbench.harness.yardstick import fleet_mlp_bytes, fleet_mlp_flops

#: NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores
#: (the program's products are f32 with TF32 off), at the card's full
#: power.limit of 700 W (the cards measured report 700.00 W)
PEAK_F32_FLOP_S = 67e12
#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, at the same power.limit
PEAK_HBM_BYTES_S = 3.35e12


def read(run):
    if run.trace is None:
        return None
    launches = sum(t.launches for t in run.ticks)
    kernel_s = run.trace.time_of("fleet_mlp")
    if not launches or kernel_s <= 0:
        return None
    n = 1 << (run.cell.config["n_prosumers"] - 1).bit_length()
    bound = max(fleet_mlp_bytes(n, 1, run.sizes) / PEAK_HBM_BYTES_S,
                fleet_mlp_flops(n, 1, run.sizes) / PEAK_F32_FLOP_S)
    return 100.0 * launches * bound / kernel_s
