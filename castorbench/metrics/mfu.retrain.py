"""mfu.retrain (%, host clock): the train ticks' model products (each
trained instance's fit and window predictions, each forecast's rollout;
``harness/yardstick.py``) at the f32 peak over the ticks' wall time."""
from castorbench.harness.yardstick import (fit_flops, forward_flops,
                                           rollout_flops)

#: NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores
#: (the program's products are f32 with TF32 off), at the card's full
#: power.limit of 700 W (the cards measured report 700.00 W)
PEAK_F32_FLOP_S = 67e12


def read(run):
    ticks = [t for t in run.ticks if t.train_jobs]
    if not ticks or run.trace is None:
        return None
    cfg = run.cell.config
    flops = sum(fit_flops(t.trained, run.rows, run.sizes, cfg["epochs"])
                + forward_flops(t.trained, run.rows, run.sizes)
                + rollout_flops(t.scored, cfg["horizon"], run.sizes)
                for t in ticks)
    return 100.0 * flops / PEAK_F32_FLOP_S / sum(t.seconds for t in ticks)
