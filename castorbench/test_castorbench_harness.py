"""CPU tests of the benchmark's harness: it finds cells, configurations,
mixes and metric readers by name; its counts match hand-worked values at
the cells' shapes; its trace reading; and what it refuses to load."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from castorbench import run as bench_run
from castorbench.harness import cells, trace, yardstick

ROOT = Path(__file__).resolve().parents[1]
SIZES = [54, 512, 512, 512, 512, 1]


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_and_metric_has_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = cells.find_cell(w["name"], bench)
        reported = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "peak_device_gib"} <= reported
        assert len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
        assert set(cell.params["limits"]) >= {"missing", "forecast"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_finds_an_added_cell_config_mix_and_metric(tmp_path):
    """A cell, a configuration, a mix and a metric added as files and
    entries, with no file of the harness edited."""
    base = tmp_path / "castorbench"
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(ROOT / "castorbench" / d, base / d)
    cfg = json.loads((base / "configs" / "castor-ann512-n512.json").read_text())
    cfg.update(name="castor-ann512-n1024", n_prosumers=1024)
    (base / "configs" / "castor-ann512-n1024.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "hourly_score.json").read_text())
    mix.update(tick_hours=2, score_every_hours=2)
    (base / "traffic" / "two_hourly.json").write_text(json.dumps(mix))
    (base / "workloads" / "ann512-n1024.two_hourly.json").write_text(
        (base / "workloads" / "ann512-n2048.score.json").read_text())
    (base / "metrics" / "ticks.two_hourly.py").write_text(
        "def read(run):\n    return len(run.ticks)\n")
    bench = _bench()
    bench["configs"].append({"name": "castor-ann512-n1024"})
    bench["workloads"].append({
        "name": "ann512-n1024.two_hourly", "config": "castor-ann512-n1024",
        "traffic": "two_hourly", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "ticks.two_hourly", "unit": "ticks", "better": "higher",
        "source": "program_counter", "layer": "scheduler",
        "moves": "score_rate", "workloads": ["ann512-n1024.two_hourly"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ann512-n2048.score" in m["workloads"]:
            m["workloads"].append("ann512-n1024.two_hourly")
    cell = cells.find_cell("ann512-n1024.two_hourly", bench, base)
    assert cell.config["n_prosumers"] == 1024
    assert cell.traffic["tick_hours"] == 2
    assert "ticks.two_hourly" in {m["name"] for m in cell.per_layer}
    assert "score_rate" in {m["name"] for m in cell.end_to_end}

    class FakeRun:
        ticks = [1, 2, 3]

    assert cells.reader("ticks.two_hourly", base)(FakeRun()) == 3


def test_counts_at_the_cells_shapes():
    # 54 x 512 + 3 x 512 x 512 + 512 x 1 matrix weights
    assert yardstick.matrix_weights(SIZES) == 814_592
    # 816,641 parameters an instance, 4 B each, plus x (54) and the output
    assert yardstick.fleet_mlp_bytes(2048, 1, SIZES) == 6_690_373_632
    assert yardstick.fleet_mlp_bytes(512, 1, SIZES) == 1_672_593_408
    assert yardstick.fleet_mlp_flops(2048, 1, SIZES) == \
        2 * 2048 * 814_592 + 2048 * (4 * 512 + 1)
    # 300 epochs x 512 instances x 624 rows x (6 P - 2 P0), P0 = 54 x 512
    assert yardstick.fit_flops(512, 624, SIZES, 300) == 463_154_341_478_400
    assert yardstick.forward_flops(512, 624, SIZES) == 520_504_737_792
    assert yardstick.rollout_flops(2048, 24, SIZES) == 80_077_651_968


def test_device_trace_union_gaps_and_labels():
    tr = trace.DeviceTrace(
        start=np.array([0.0, 1.0, 1.5, 8.0]),
        end=np.array([2.0, 1.2, 3.0, 12.0]), window=(0.0, 10.0),
        by_name={"fleet_mlp_wide_kernel": 0.5, "x": 1.0})
    np.testing.assert_allclose(tr.merged(), [[0.0, 3.0], [8.0, 10.0]])
    assert tr.busy_s() == pytest.approx(5.0)
    np.testing.assert_allclose(tr.gaps(), [[3.0, 8.0]])
    assert tr.time_of("fleet_mlp") == 0.5

    class Span:
        def __init__(self, name, t0, t1):
            self.name, self.t0, self.t1 = name, t0, t1

    class Tick:
        t0, t_ingested, t_ticked, t1 = 0.0, 0.5, 9.0, 9.5
        spans = [Span("castor.tick", 0.5, 9.0), Span("scheduler.poll", 0.6, 1.0)]

    class Run:
        ticks = [Tick()]
        trace = tr

    labels = trace.host_labels(Run(), np.array([0.2, 0.8, 5.0, 9.2, 9.9]))
    assert labels == ["bench.ingest", "scheduler.poll", "castor.tick",
                      "bench.sync", "bench.loop"]
    got = trace.breakdown(Run())
    assert got["idle_gaps"] == [["castor.tick", 5.0]]
    assert got["device_ops"][0] == ["x", 1.0]


def test_peak_reads_the_held_memory_and_the_largest_tick_rise():
    """The reading does not grow with the number of ticks in the window,
    even where each tick leaves a version held."""

    class Tick:
        def __init__(self, rise):
            self.mem_rise = rise

    class Run:
        device, held_bytes = "cuda", 3 * 2**30
        ticks = [Tick(2**30), Tick(2 * 2**30), Tick(2 * 2**30)]

    read = cells.reader("peak_device_gib")
    assert read(Run()) == 5.0
    Run.ticks = Run.ticks + [Tick(2 * 2**30)]
    assert read(Run()) == 5.0
    Run.device = "cpu"
    assert read(Run()) is None


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_the_store_is_loaded_with_tails_spread_over_their_cycle(seed):
    """Each series holds every reading up to the first tick; its last
    hours sit in the store's tail, one append an hour, their number
    spread over the cycle across the series."""
    from castorbench.harness import driver
    cell = cells.find_cell("ann512-n2048.score")
    n, live = 16, cell.traffic["live_hours"]
    cell.config = dict(cell.config, n_prosumers=n, hidden=8)
    flow = driver.Flow(cell, seed, "cpu")
    store = flow.castor.store
    ts, _ = flow.site.readings(flow.site.t_start, flow.t_first)
    chunks = []
    for i, ts_id in enumerate(flow.ts_ids):
        assert store.read(ts_id)[0].size == np.isfinite(ts[i]).sum()
        s = store._data[ts_id]
        assert len(s.segments) == 1
        chunks.append(len(s.tail_t))
        if s.tail_t:     # an hour's readings, in one append
            assert max(c.size for c in s.tail_t) <= 2
    # k_i = i * live // n, dealt out by the seed; an hour lost to the
    # site's missing readings leaves no append
    assert min(chunks) == 0
    assert 0.65 * live * (n - 1) / n < max(chunks) <= live * (n - 1) / n


def test_forbidden_modules_compares_whole_top_level_names():
    assert bench_run.forbidden_modules(
        ["repro_torch", "repro_torch.core", "reprolib", "numpy"]) == []
    assert bench_run.forbidden_modules(
        ["repro.core.castor", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole small run on the CPU in a fresh process: nothing it loads
    is JAX's or the JAX package's."""
    code = (
        "import sys, time\n"
        "from castorbench import run as R\n"
        "from castorbench.harness import cells\n"
        "cell = cells.find_cell('ann512-n2048.score')\n"
        "cell.config = dict(cell.config, n_prosumers=4, hidden=8, epochs=2)\n"
        "res = R.run_cell(cell, 5, 0.05, False, 'cpu', time.perf_counter())\n"
        "assert res['correct'], res\n"
        "print(R.forbidden_modules(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_to_run_without_a_card():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a host without")
    out = subprocess.run(
        [sys.executable, "castorbench/run.py", "--workload",
         "ann512-n2048.score", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
