"""chip_smoke.py's phase 16 (training across devices) rehearsed on the CPU
at small sizes, through the plain versions: the train cell against the
undistributed step in a gloo world of one (bit-equal there), the int8
hook's error bound, the sharded checkpoint restored onto an
``elastic_remesh`` mesh, the supervised restart, the dense smoke configs'
training (parity and path, frames and M-RoPE batches included) and the
dry run's roofline against the measured step. The smoke models' loss
barely moves in three steps, so the compressed run's fall is checked on
the card only (``must_fall``)."""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)

# the dense configs' bf16 steps: enough for llama3-8b-smoke's loss to
# fall (a token model's must)
DENSE_STEPS = 5


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def phase(smoke):
    import torch.distributed as dist
    out = smoke.training_across_devices_phase(
        "cpu",
        train_kw=dict(arch="qwen3-1.7b-smoke", batch=2, seq=32, steps=3,
                      must_fall=False,
                      supervised=dict(arch="qwen3-1.7b-smoke", layers=2,
                                      steps=4, every=2, fail_at=3,
                                      batch=2, seq=32)),
        dense_layers={"llama3-8b-smoke": 2, "hubert-xlarge-smoke": 2,
                      "qwen2-vl-7b-smoke": 2},
        dense_kw=dict(parity_seq=32, batch=2, seq=32, steps=DENSE_STEPS))
    assert not dist.is_initialized()         # the world was destroyed
    return out


def test_cell_equals_the_undistributed_step(phase, smoke):
    train = phase["train"]
    assert len(train["steps"]) == 3
    for row in train["steps"]:
        assert row["bit_equal"] and row["loss"] > 0
        assert max(row[k] for k in ("loss_rel", "grad_norm_rel",
                                    "params_rel")) == 0
    assert train["launches"]["flash_attention"] == 4
    assert train["launches"]["flash_attention_backward"] == 2


def test_compression_checkpoint_and_restart(phase, smoke):
    train = phase["train"]
    assert 0.5 <= train["compressed"]["worst_of_scale"] \
        <= 0.5 + smoke.COMPRESS_SLACK
    assert all(x == x for x in train["compressed"]["losses"])
    assert train["checkpoint"]["bytes"] > 0
    assert train["supervised"]["bit_equal"]


def test_dense_training_and_dry_run(phase, smoke):
    dense = phase["dense"]
    assert set(dense) == {"llama3-8b-smoke", "hubert-xlarge-smoke",
                          "qwen2-vl-7b-smoke"}
    for rec in dense.values():
        assert max(rec["parity"][k] for k in ("loss", "grad_norm",
                                               "grad")) == 0
        # 2 layers: two forwards and one backward a layer a step
        assert rec["launches"]["flash_attention"] == 2 * 2 * DENSE_STEPS
        assert rec["launches"]["flash_attention_backward"] == 2 * DENSE_STEPS
    own = phase["dryrun"]["own"]
    assert own["n_devices"] == 1 and own["cost"]["collective_wire_bytes"] == 0
    assert own["roofline"]["compute_s"] <= phase["train"]["step_s"]["cell"]
    assert phase["dryrun"]["production"]["n_devices"] == 256


def test_train_batch_covers_every_frontend(smoke):
    """Token models get the next-token stream; audio frames; the vlm its
    patch embeddings and M-RoPE positions."""
    from repro_torch.configs import get_config
    for arch, keys in (("qwen3-1.7b-smoke", {"tokens", "labels"}),
                       ("hubert-xlarge-smoke", {"frames", "labels"}),
                       ("qwen2-vl-7b-smoke", {"tokens", "vision_embeds",
                                              "positions", "labels"})):
        b = smoke.train_batch(get_config(arch), 2, 16, 0, "cpu")
        assert set(b) == keys
        assert b["labels"].shape == (2, 16)
