"""CPU tests of the check that decides ``correct``: the plain reference
against the port at a tiny size, each planted fault caught, and the
reference's hourly alignment against the program's. The control (the
reference in TF32) needs the card: its test skips without one."""
from __future__ import annotations

import time

import numpy as np
import pytest

from castorbench import run as bench_run
from castorbench.harness import cells, check, faults
from castorbench.reference import ann as ref

SEED = 2**31 + 77


def tiny(name: str):
    """The cell at a tiny size: 12 prosumers, width 16, 4 epochs."""
    cell = cells.find_cell(name)
    cell.config = dict(cell.config, n_prosumers=12, hidden=16, epochs=4)
    return cell


def run_tiny(name: str, seconds: float = 0.0) -> dict:
    """A run of the tiny cell on the CPU; ``seconds`` 0: one window tick."""
    return bench_run.run_cell(tiny(name), SEED, seconds, False, "cpu",
                              time.perf_counter())


@pytest.mark.parametrize("name,seconds", [("ann512-n512.retrain", 0.0),
                                          ("ann512-n2048.score", 0.1)])
def test_reference_agrees_with_the_port(name, seconds):
    res = run_tiny(name, seconds)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    checks = res["checks"]
    assert checks["missing"]["value"] == 0
    # every other number a tenth of its limit or less: on the CPU both
    # sides compute in float32 without TF32; the fit's loss a fifth, as
    # its limit sits only 2.3 times over the card's sound readings (the
    # TF32 control reads 4.6 times over them)
    for k, c in checks.items():
        assert c["value"] <= c["limit"] / (5 if k == "fit_loss" else 10), \
            (k, c)


# the retrain cell scores through the score cells' rollout: an altered
# answer is the score cells' to catch
@pytest.mark.parametrize("name,fault", [
    ("ann512-n512.retrain", "state_unchanged"),
    ("ann512-n512.retrain", "half_batch"),
    ("ann512-n2048.score", "state_unchanged"),
    ("ann512-n2048.score", "half_batch"),
    ("ann512-n2048.score", "answer_altered")])
def test_each_planted_fault_is_caught(name, fault):
    with faults.planted(fault):
        res = run_tiny(name)
    assert not res["correct"], res["checks"]


def test_a_loss_over_half_the_rows_is_caught_by_the_fits_loss():
    """The loss's rows cut, the design and its scales whole: the
    standardisation and output scales agree, and only the steps' loss
    tells."""
    with faults.planted("half_batch"):
        res = run_tiny("ann512-n512.retrain")
    checks = res["checks"]
    assert checks["fit_scales"]["value"] <= checks["fit_scales"]["limit"]
    assert checks["fit_loss"]["value"] > checks["fit_loss"]["limit"]


def test_loss_gaps_by_step_and_a_fit_that_never_computed_its_loss():
    want = [[4.0, 2.0, 1.0], [8.0, 4.0, 2.0]]
    got = [[4.0, 2.2, 1.0], [8.0, 4.0, 1.0]]
    assert check.loss_gaps(got, want) == pytest.approx([0.0, 0.1, 0.5])
    assert check.loss_number(got, want) == pytest.approx(0.5)
    assert check.loss_gaps([[], [8.0, 4.0, 2.0]], want) == [1.0, 1.0, 1.0]


def test_hourly_alignment_matches_the_programs():
    from repro_torch.timeseries.transforms import align_resample
    rng = np.random.default_rng(3)
    t0, n_bins = 3600.0 * 100, 72
    ts = t0 + 3600.0 * (np.arange(-5, n_bins + 5)
                        + rng.uniform(-0.1, 0.1, n_bins + 10))
    ts[rng.random(ts.size) < 0.3] = np.nan
    ts[:20] = np.nan            # the window starts with no reading
    vals = rng.normal(size=ts.size)
    got = ref.hourly_window(ts[None], vals[None], t0, n_bins)[0]
    ok = np.isfinite(ts)
    _, want = align_resample(ts[ok], vals[ok], step=3600.0, start=t0,
                             end=t0 + 3600.0 * n_bins)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    return "cuda"


@pytest.mark.gpu
def test_the_control_fails_the_limits(card):
    """At the cells' own sizes: the program's answers within every limit;
    the reference in TF32 in the program's place beyond one, in the
    retrain cell beyond the fit's loss; and the program with its fit alone
    in TF32 beyond the fit's loss too."""
    from castorbench import control
    for name in ("ann512-n512.retrain", "ann512-n2048.score"):
        cell = cells.find_cell(name)
        limits = cell.params["limits"]
        rec = control.readings(cell, SEED, 0.5, card)
        assert check.judge(rec["program"], limits)["correct"], rec
        assert any(v > limits[k] for k, v in rec["control"].items()
                   if k in limits), rec
        if "fit_loss" in limits:
            assert rec["control"]["fit_loss"] > limits["fit_loss"], rec
            rec = control.readings(cell, SEED, 0.5, card, "fit_tf32",
                                   control=False)
            assert rec["program"]["fit_loss"] > limits["fit_loss"], rec
