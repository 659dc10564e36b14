"""The port's serving engine and launcher: greedy generations equal the JAX
engine's token for token (f32, qwen3-1.7b-smoke, the recurrent
zamba2-2.7b-smoke and rwkv6-7b-smoke and the MoE dbrx-132b-smoke and
llama4-maverick-400b-a17b-smoke, 2 slots, 3 requests, so a request is
admitted while another slot is active and a slot is reused), the
throughput accounting, idle rows kept exactly, the CPU launcher, serve
runs that load no JAX, and chip_smoke.py's language-model, scan and MoE
phases rehearsed at a tiny size."""
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.arch import model as JM
from repro.configs import get_config as jax_get_config
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.arch import model as TM
from repro_torch.arch.params import params_from_numpy, tree_leaves
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


RECURRENT_ARCHS = ["zamba2-2.7b", "rwkv6-7b"]
MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]


def _params(dtype="float32", arch="qwen3-1.7b"):
    jcfg = jax_get_config(arch + "-smoke").replace(dtype=dtype)
    tcfg = get_config(arch + "-smoke").replace(dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _run(engine_cls, request_cls, cfg, params, prompts, new_tokens):
    eng = engine_cls(cfg, params, max_slots=2, max_seq=96)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return eng, reqs


def test_engine_tokens_equal_jax_engine():
    _engine_tokens_equal_jax_engine("qwen3-1.7b")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS + MOE_ARCHS)
def test_recurrent_engine_tokens_equal_jax_engine(arch):
    _engine_tokens_equal_jax_engine(arch)


def _engine_tokens_equal_jax_engine(arch):
    jcfg, tcfg, jp, tp = _params(arch=arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3)]
    new_tokens = [6, 3, 5]       # request 1 ends first: 2 reuses its slot
    _, want = _run(JaxServeEngine, JaxRequest, jcfg, jp, prompts, new_tokens)
    eng, got = _run(ServeEngine, Request, tcfg, tp, prompts, new_tokens)
    assert all(r.done for r in got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    # admission decodes the whole batch once per prompt token but the last
    assert eng.decode_calls == eng.steps + sum(len(p) - 1 for p in prompts)


def test_engine_throughput_accounting():
    cfg = get_config("qwen3-1.7b-smoke")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=cfg.dtype, device="cpu")
    eng = ServeEngine(cfg, params, max_slots=2, max_seq=64)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=np.asarray([1, 2, 3], np.int32),
                           max_new_tokens=4))
    before = dec_ops.invocation_count()
    total = eng.run_until_idle()
    assert total == 8 == eng.tokens_out
    assert dec_ops.invocation_count() - before == \
        cfg.num_layers * eng.decode_calls


def test_engine_keeps_idle_rows_exact_and_stops_when_full():
    """A slot that does not advance keeps its cache and length exactly; a
    request stops at ``max_seq - 1``."""
    _engine_keeps_idle_rows_exact("qwen3-1.7b")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_engine_keeps_idle_rows_exact(arch):
    """The same for the recurrent states (conv / ssd, x_tm / x_cm / wkv)
    beside zamba2's shared k / v."""
    _engine_keeps_idle_rows_exact(arch)


def _engine_keeps_idle_rows_exact(arch):
    _, tcfg, _, tp = _params(arch=arch)
    eng = ServeEngine(tcfg, tp, max_slots=2, max_seq=12)
    eng.submit(Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                       max_new_tokens=50))
    eng.step()
    idle = [leaf[:, 1].clone() for leaf in tree_leaves(eng.state["caches"])]
    eng.run_until_idle()
    assert eng.lengths[1] == 0
    for old, leaf in zip(idle, tree_leaves(eng.state["caches"])):
        assert torch.equal(old, leaf[:, 1])
    assert eng.lengths[0] == eng.max_seq - 1
    assert len(eng.slot_req) == 2 and eng.slot_req[0] is None


def test_engine_sampling_draws_from_step_seeded_rng():
    """``greedy=False`` draws each token from numpy's ``default_rng(step)``
    over the softmax of the slot's logits, as the reference does."""
    _, tcfg, _, tp = _params()
    eng = ServeEngine(tcfg, tp, max_slots=1, max_seq=32, greedy=False)
    req = Request(rid=0, prompt=np.asarray([3, 1, 4], np.int32),
                  max_new_tokens=3)
    eng.submit(req)
    eng.run_until_idle()
    ref = TM.init_decode_state(tcfg, 1, 32, device="cpu")
    want, nxt = [], 4
    for tok in (3, 1):
        _, ref = TM.decode_step(tcfg, tp, ref, {"tokens": torch.tensor([[tok]])})
    for step in range(3):
        logits, ref = TM.decode_step(tcfg, tp, ref,
                                     {"tokens": torch.tensor([[nxt]])})
        row = logits[0].numpy()
        e = np.exp(row - row.max())
        nxt = int(np.random.default_rng(step).choice(len(row), p=e / e.sum()))
        want.append(nxt)
    assert req.tokens == want


def test_launcher_runs_on_cpu(capsys):
    _launcher_runs_on_cpu(capsys, "qwen3-1.7b")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS + MOE_ARCHS)
def test_launcher_runs_recurrent_archs_on_cpu(capsys, arch):
    _launcher_runs_on_cpu(capsys, arch)


def _launcher_runs_on_cpu(capsys, arch):
    reqs = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--slots", "2",
                              "--new-tokens", "4"])
    assert len(reqs) == 3 and all(r.done and len(r.tokens) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert "3/3 requests" in out and "device=cpu" in out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_serve.main(["--smoke"])


def test_serve_never_loads_jax_or_repro():
    """Serve runs of an attention model, of both recurrent families
    (their scans and decode recurrences included) and of both MoE models
    (routing and dispatch included) load no JAX module."""
    code = textwrap.dedent("""
        import sys
        from repro_torch.launch import serve
        for arch in ("qwen3-1.7b", "zamba2-2.7b", "rwkv6-7b", "dbrx-132b",
                     "llama4-maverick-400b-a17b"):
            reqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                               "--requests", "2", "--slots", "2",
                               "--new-tokens", "3", "--prompt-len", "8"])
            assert all(r.done for r in reqs)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_lm_rehearsal_on_cpu():
    """chip_smoke.py's attention kernel phases and its prefill and serve
    paths at a tiny size through the plain versions: the same checks the
    card run makes."""
    smoke = _chip_smoke()
    flash = [("prefill", 1, 64, 64, 4, 2, 16, "bfloat16", True)] + [
        c for c in smoke.FLASH_CASES[1:] if c[1] * c[2] <= 128]
    rec = smoke.flash_phase("cpu", flash, time_it=False)
    assert rec["max_abs_err"] == 0.0 and rec["bound_by"] == "bytes"
    dec = [("serve", 2, 64, 4, 2, 16, "bfloat16")] + smoke.DECODE_CASES[1:3]
    rec = smoke.decode_phase("cpu", dec, time_it=False)
    assert rec["max_abs_err"] == 0.0 and rec["bound_by"] == "bytes"
    cfg, params = smoke.lm_params("qwen3-1.7b-smoke", "cpu")
    pre = smoke.prefill_phase("cpu", cfg, params, batch=2, seq=32,
                              check_len=16)
    assert pre["launches"]["flash_attention"] == cfg.num_layers
    assert pre["rel_l2"] <= smoke.PREFILL_DECODE_TOL
    serve = smoke.serve_phase("cpu", cfg, params, slots=2, max_seq=64,
                              n_requests=3, prompt_lens=(4, 8), new_tokens=4)
    assert serve["requests"] == 3 and serve["tokens"] == 12
    assert serve["launches"]["decode_attention"] == \
        cfg.num_layers * serve["decode_calls"]
    prof = smoke.profile_decode(serve["engine"], calls=2)
    assert prof["device_ms_per_call"] is None      # no device on the CPU


def test_chip_smoke_bounds():
    """The bound counts what this run's data needs: the visible pairs of a
    causal tile, the valid cache entries of a decode row."""
    smoke = _chip_smoke()
    q = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)
    k = torch.zeros(1, 6, 1, 8, dtype=torch.bfloat16)
    # rows see 3, 4, 5, 6 keys (offset 2): 18 pairs x 2 heads x 4 D
    assert smoke.flash_bound(q, k, True)["flops"] == 18 * 2 * 4 * 8
    assert smoke.flash_bound(q, k, False)["flops"] == 24 * 2 * 4 * 8
    assert smoke.flash_bound(q, k, True)["bytes"] == 2 * (64 + 48) * 2
    qd = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    kc = torch.zeros(2, 10, 2, 8, dtype=torch.bfloat16)
    lengths = torch.tensor([3, 12], dtype=torch.int32)   # 12 counts as 10
    b = smoke.decode_bound(qd, kc, lengths)
    assert b["flops"] == 13 * 4 * 4 * 8
    assert b["bytes"] == (2 * 64 + 2 * 13 * 2 * 8) * 2 + 2 * 4


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_chip_smoke_recurrent_rehearsal_on_cpu(arch):
    """chip_smoke.py's scan kernel phase and the recurrent family's prefill
    (launch counts, state check) and serve paths at a tiny size through
    the plain versions: the same checks the card run makes."""
    smoke = _chip_smoke()
    if arch == "zamba2-2.7b":
        cases = [("prefill", 1, 64, 4, 16, 16, "bfloat16", 64)] + \
            smoke.SSD_CASES[1:3]
        rec = smoke.ssd_phase("cpu", cases, time_it=False)
    else:
        cases = [("prefill", 1, 64, 4, 16, "bfloat16", 0.4, 32)] + \
            smoke.WKV_CASES[1:3]
        rec = smoke.wkv_phase("cpu", cases, time_it=False)
    assert rec["max_abs_err"] == 0.0 and rec["bound_by"] == "bytes"
    out = smoke.lm_path(arch + "-smoke", "cpu", profile=False, serve_kw=dict(
        slots=2, max_seq=48, n_requests=3, prompt_lens=(4, 8), new_tokens=3))
    cfg, pre, serve = out["cfg"], out["prefill"], out["serve"]
    assert pre["launches"] == smoke.forward_launches(cfg)
    assert pre["launches"]["ssd_scan"] + pre["launches"]["wkv6_scan"] == \
        cfg.num_layers
    assert pre["rel_l2"] <= pre["tol"] == smoke.RECURRENT_DECODE_TOL
    assert pre["state_rel_l2"] <= smoke.RECURRENT_DECODE_TOL
    assert serve["requests"] == 3 and serve["tokens"] == 9
    assert "engine" not in serve
    per_call = cfg.num_periods if cfg.shared_attn_every_period else 0
    assert serve["launches"]["decode_attention"] == \
        per_call * serve["decode_calls"]


def test_chip_smoke_moe_rehearsal_on_cpu():
    """chip_smoke.py's phase 13 at smoke width through the plain versions:
    each MoE model's prefill (launches, the dropped share, the routes of
    both sides and the check routed as prefill), its engine (one
    decode_attention per attention layer a call), the accounting and the
    decode floor, then the f32 train-step parity with its aux and routes;
    and the new attention cases (GQA groups 5, 6, 7 and 9, the MoE models'
    path shapes) at sizes the CPU takes."""
    smoke = _chip_smoke()
    groups = {c[4] // c[5] for c in smoke.FLASH_CASES}
    assert {5, 6, 7, 9} <= groups
    assert {5, 6, 7, 9} <= {c[3] // c[4] for c in smoke.DECODE_CASES}
    assert ("dbrx", 1, 1024, 1024, 48, 8, 128, "bfloat16", True) in \
        smoke.FLASH_BWD_CASES
    flash = [("prefill", 1, 32, 32, 40, 8, 16, "bfloat16", True)] + [
        c for c in smoke.FLASH_CASES[1:] if c[4] // c[5] in (5, 6, 7, 9)
        and c[1] * c[2] <= 128]
    smoke.flash_phase("cpu", flash, time_it=False)
    smoke.decode_phase("cpu", [("serve", 2, 64, 48, 8, 16, "bfloat16")]
                       + [c for c in smoke.DECODE_CASES[1:]
                          if c[3] // c[4] in (5, 6, 9)], time_it=False)
    out = smoke.moe_phase(
        "cpu", {f"{a}-smoke": 0 for a in MOE_ARCHS},
        serve_kw=dict(slots=2, max_seq=48, n_requests=3,
                      prompt_lens=(4, 8), new_tokens=3), parity_seq=32)
    for arch in MOE_ARCHS:
        rec = out[f"{arch}-smoke"]
        cfg, pre, serve = rec["cfg"], rec["prefill"], rec["serve"]
        assert pre["launches"] == smoke.forward_launches(cfg)
        assert pre["launches"]["flash_attention"] == cfg.num_layers
        assert 0 <= pre["dropped"]["share"] < 1
        assert pre["pinned_rel_l2"] <= smoke.PREFILL_DECODE_TOL
        assert pre["routes"]["entries"] == 128 * cfg.num_experts_per_tok \
            * cfg.num_periods * cfg.pattern.count("attn_moe")
        assert serve["requests"] == 3 and serve["tokens"] == 9
        assert serve["launches"]["decode_attention"] == \
            cfg.num_layers * serve["decode_calls"]
        assert rec["floor_ms"] > 0 and rec["peak_bytes"] is None
        err = out[f"{arch}-smoke-parity"]
        assert {"moe_lb_loss", "moe_z_loss"} <= set(err)
        assert max(err[k] for k in ("loss", "grad", "moe_lb_loss")) == 0
    assert out["seconds"] > 0


def test_chip_smoke_moe_decode_floor():
    """The decode floor counts every weight a call reads in bf16: every
    leaf but the untied embedding table (27.31e9 - 0.62e9 parameters of
    dbrx-132b at 8 layers), over 3.35 TB/s."""
    smoke = _chip_smoke()
    cfg = get_config("dbrx-132b").replace(num_layers=8)
    embed = cfg.vocab_size * cfg.d_model
    assert smoke.weight_bytes(cfg) == 2 * (TM.param_count(cfg) - embed)
    assert abs(smoke.weight_bytes(cfg) / smoke.HBM_BYTES_PER_S * 1e3
               - 15.93) < 0.01


def test_chip_smoke_scan_bounds():
    """The scans' bounds at the path shapes: the bytes each function must
    move (91.5 MB for zamba2's ssd_scan, 205.5 MB for rwkv6's wkv6_scan)
    over 3.35 TB/s bound both; the chunked forms' operations do not."""
    smoke = _chip_smoke()
    bf16 = torch.bfloat16
    b = smoke.ssd_bound(torch.zeros(4, 1024, 80, 64, dtype=bf16),
                        torch.zeros(4, 1024, 80),
                        torch.zeros(4, 1024, 1, 64, dtype=bf16),
                        torch.zeros(80), 64)
    assert b["bytes"] == 2 * 41_943_040 + 1_310_720 + 2 * 524_288 \
        + 5_242_880 + 2 * 320
    assert b["flops"] == 10_737_418_240
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 0.0273) < 1e-4
    w = smoke.wkv_bound(torch.zeros(4, 1024, 64, 64, dtype=bf16),
                        torch.zeros(4, 1024, 64, 64), torch.zeros(64, 64), 32)
    assert w["bytes"] == 4 * 33_554_432 + 67_108_864 + 16_384 + 4_194_304
    assert w["bound_by"] == "bytes" and abs(w["bound_ms"] - 0.0614) < 1e-4


def test_chip_smoke_kernel_line_lists_five_kernels():
    """The five Pallas kernels' rows, each replacing the function that
    reaches pl.pallas_call, then the three backwards, each replacing what
    jax.grad compiles from the reference's XLA form (attention_xla,
    ssd_chunked, wkv6_chunked: no Pallas kernel defines a VJP), in the
    forward kernel's source."""
    smoke = _chip_smoke()
    rec = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
           "bound_by": "bytes"}
    line = smoke.kernel_line({n: rec for n in smoke.COUNT_NAMES},
                             {n: i for i, n in enumerate(smoke.COUNT_NAMES)})
    rows = line["kernels"]
    backwards = {"flash_attention_backward": "def attention_xla(",
                 "ssd_scan_backward": "def ssd_chunked(",
                 "wkv6_scan_backward": "def wkv6_chunked("}
    assert [r["name"] for r in rows] == list(smoke.KERNEL_NAMES) + list(
        backwards)
    assert len(rows) == 8
    by_name = {r["name"]: r for r in rows}
    for r in rows:
        assert (ROOT / r["source"]).is_file()
        path, line_no = r["replaces"].split(":")
        text = (ROOT / path).read_text().splitlines()[int(line_no) - 1]
        if r["name"] in backwards:
            assert text.startswith(backwards[r["name"]])
            forward = r["name"].removesuffix("_backward")
            assert r["source"] == by_name[forward]["source"]
        else:
            assert text.startswith("def ") and "_pallas(" in text
        assert r["library_ms"] is None and r["route"] == "cuda"
