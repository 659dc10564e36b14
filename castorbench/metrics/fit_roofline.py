"""fit_roofline (%, device time): the fits' products (``harness/
yardstick.py`` ``fit_flops``) at the f32 peak over their device time,
from CUDA events around each call of the program's ``fit_adam``
(``forecast/base.py``, called by ``forecast/ann.py``). The fit is bound by
its products: its bytes (Adam's passes over the parameters and moments)
take under a fifth of that time at 3.35 TB/s."""
from castorbench.harness.yardstick import fit_flops

#: NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores
#: (the program's products are f32 with TF32 off), at the card's full
#: power.limit of 700 W (the cards measured report 700.00 W)
PEAK_F32_FLOP_S = 67e12


def read(run):
    fits = [f for t in run.ticks for f in t.fits]
    if not fits:
        return None
    flops = sum(fit_flops(f["n"], run.rows, run.sizes, f["epochs"])
                for f in fits)
    return 100.0 * flops / PEAK_F32_FLOP_S / sum(f["device_s"] for f in fits)
