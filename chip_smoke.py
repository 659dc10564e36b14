#!/usr/bin/env python3
"""Start the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. card: ``nvidia-smi`` name and power limit; the five kernels
   (``fleet_mlp``, ``flash_attention``, ``decode_attention``,
   ``ssd_scan``, ``wkv6_scan``) are built from the sources in the
   checkout, one ``nvcc`` each, all started together (seconds and
   ``ptxas`` lines).
2. kernel: each kernel through its public op against its plain PyTorch
   version on the same inputs. ``fleet_mlp`` at the scoring shape (N=512,
   b=1, F=54, width 512, depth 5, f32), the unit-test shapes in f32 and
   bf16, and a ragged N=500. ``flash_attention`` at the qwen3-1.7b prefill
   shape (B 4, S 1024, H 16, KV 8, D 128, bf16, causal) and the test
   shapes in both dtypes (D 80, non-causal, Sq < Skv, ragged).
   ``decode_attention`` at the engine shape (B 8, S 2048, H 16, KV 8,
   D 128, bf16, seeded lengths) and the test shapes, GQA groups 5, 6, 7
   and 9 at D 128 among them. Both attention kernels also at zamba2-2.7b's
   shapes (prefill B 4, S 1024, H = KV = 32, D 80, causal; engine B 4,
   S 512, group 1, D 80) and the MoE models' (dbrx-132b H 48, KV 8,
   group 6; llama4-maverick H 40, KV 8, group 5; prefill B 4, S 1024,
   engine B 4, S 512, D 128), timed there too.
   ``flash_attention`` runs its wgmma route on bf16 and its CUDA-core
   route on f32; ``decode_attention`` is two launches per call (split-KV
   partial pass and combine). ``flash_attention``'s backward (preprocess,
   dK/dV and dQ launches; bf16 on wgmma fed by TMA, f32 on CUDA cores) at
   the qwen3-1.7b training shape (B 4, S 1024, H 16, KV 8, D 128, bf16,
   causal), the forward's test shapes and the backward's own (Skv past a
   128-key tile, G 4, D 16 and 80) and dbrx-132b's attention at B 1, S
   1024 (G 6): dq, dk, dv against the plain backward
   on the same inputs, both forward routes' row log-sum-exp against the
   plain one; timed beside forward + backward under autograd of the port's
   op and of ``scaled_dot_product_attention``, each also by the
   profiler's device time (the build prints the bf16 backward kernels'
   registers and spills). ``ssd_scan`` at the
   zamba2-2.7b prefill shape (B 4, S 1024, H 80, P = N = 64, bf16) and
   ``wkv6_scan`` at the rwkv6-7b prefill shape (B 4, S 1024, H 64,
   K = V = 64, bf16, w in f32), both also at the unit-test shapes in f32
   and bf16 (``wkv6_scan`` at mild and aggressive decay), at strong decay
   (SSD, dt |A| up to 10) and extreme decay (WKV, w down to 1e-30) in both
   dtypes, outputs and final states. The scans run their tensor-core
   route on bf16 and their per-token route on f32 (each route's kernel,
   registers and shared memory printed at the build); the f32 route is
   also checked and timed at the path shape. Each path shape is timed
   with CUDA events beside its
   bound, the plain version's time and (for attention)
   ``scaled_dot_product_attention``'s, on rotating copies of its inputs
   that keep them cold in L2: eager calls (``ms``, the host's issue time
   where that is longer), and the kernel's and the library's calls
   replayed from a CUDA graph (device time). The scans' backward kernels
   (f32: one per-token kernel on CUDA cores; bf16: a state sweep, the
   forward's kernel saving the state before each chunk, and a chunked
   reverse sweep on the tensor cores; then launches that sum the
   partials) at the zamba2-2.7b and rwkv6-7b training shapes in
   bf16 and f32 and at the forwards' test, strong and extreme decay cases
   in both dtypes, half of them with a final-state gradient: every
   gradient against the plain backward (float64) at ``SCAN_BWD_TOL``; at
   the bf16 training shapes two calls bitwise equal, the op's autograd
   gradients equal to the wrapper's, two planted faults caught (the decay
   dropped, dy one token late), and the times (eager, graph replay,
   profiler device time by launch, the plain backward's); each bf16 reverse
   sweep's registers, spills and blocks an SM as the card built it (2 or
   more) and its scratch.
3. training parity: for each of LR, GAM, ANN and LSTM a small bin (3
   prosumers at the JAX package's test sizes) trained on the card and on
   the CPU from the same initial weights: params within rtol 5e-2 / atol
   5e-3, forecasts and bands within rtol 2e-3 / atol 1e-3.
   Forecast flow: ``Castor.tick(executor="fleet")`` over a 512-prosumer
   site (``examples/smartgrid_forecasting.py``'s workload at the paper's
   widths): an ANN fleet (hidden 512, 300 epochs, 28-day window) and an
   LR fleet over every prosumer, LR/GAM/ANN/LSTM (ANN and LSTM width 512,
   DEFAULTS epochs) and the current -> energy transform on the
   substation. Tick 1 trains everything and scores on the train handoff,
   ticks 2-3 score warm, then a minutely detection fleet over the ANN
   fleet's bands runs 5 ticks. Every job ok, 24 ``fleet_mlp`` launches
   per ANN score bin, the device rollout once per score bin, the runtime
   modes (cold train bins, warm score bins), the ANN score bin on the
   fit's own tensors, finite trained params, the fleet's median one-step
   training MAPE under 30 %, fleet forecasts equal to per-instance
   ``score()`` for a few prosumers and the four substation kinds, and
   ``fleet_detect`` records bitwise equal to per-sensor ``detect``. It
   prints the train tick's wall, the ANN train bin's ``exec.bin`` span,
   the fit's device time and epochs/s, the peak device memory and the
   substation models' train walls.
4. durable serverless flow: the same flow on ``Castor.open(<tmpdir>,
   device="cuda")`` (a journal over a ``FilesystemStorage`` with fsync),
   every tick through ``tick(executor="serverless")`` (4 inline workers
   sharing the card): A, 3 hourly and 5 minutely ticks with each tick's
   wall, ``journal.commit`` span, journal records / segments /
   auto-flushes / snapshots / bytes, invocations (cold, warm,
   speculative) and ``fleet_mlp`` launches; every job ok, the LR fleet's
   and the substation LR / GAM forecasts equal to step 3's, the ANN and
   LSTM fits under the training-MAPE bound. B, after tick 2 the log is
   copied, its last segment torn mid-frame and ``Castor.open``'d on the
   card, the packages published again and the hourly ticks driven again:
   the stores bitwise equal to A's after its hourly ticks (recovery
   seconds, bytes replayed). C, a ``ProcessBackend`` of 2 spawned workers,
   each building the same flow at 64 prosumers (widths and epochs full)
   on its own CUDA context: 2 ticks through the storage-mediated wire,
   every job ok, the workers' device and ``fleet_mlp`` launches from their
   own spans, forecasts equal to an in-process inline run at rtol 2e-3 /
   atol 1e-3, the shipped-back ANN versions on the parent's card scoring
   there through ``fleet_mlp``; cold starts, per-invocation walls and the
   bucket's bytes.
5. prefill path: qwen3-1.7b at full width (28 layers, bf16 parameters
   from a seeded generator), ``forward(mode="prefill")`` on 4 prompts of
   1024 tokens: 28 ``flash_attention`` launches, finite logits, caches
   (28, 4, 1024, 8, 128), and the same forward timed again warm; then
   one 128-token prompt's prefill logits held against ``decode_step`` fed
   the same tokens one at a time.
6. serve path: ``ServeEngine`` on the same parameters, 8 slots of 2048
   positions, 9 seeded requests (prompts of 16-96 tokens, 32 new tokens
   each but request 0's 16, greedy, so the ninth is admitted into request
   0's slot while the others decode): every request done, 28
   ``decode_attention`` launches per engine decode call; tokens/s, step time, time to first token, peak
   device memory; a profiler window of a few decode calls.
7. zamba2-2.7b at full width (54 Mamba2 blocks, the shared attention
   block once per 6-block period), as 5-6: prefill of 4 x 1024 tokens with
   54 ``ssd_scan`` and 9 ``flash_attention`` launches, a 128-token
   prompt's logits and final ``ssd`` states held against token-by-token
   decode, and ``ServeEngine`` with 4 slots x 512 positions and 5 requests
   (prompts 16-64, 16 new tokens but request 0's 8, the fifth admitted
   into its slot mid-run): 9 ``decode_attention`` launches per decode
   call.
8. rwkv6-7b at full width (32 blocks), the same way: 32 ``wkv6_scan``
   launches per prefill, the ``wkv`` states held, the same engine run
   (its decode runs no kernel: the recurrences are plain, as in the
   reference).
9. LM training parity: one f32 ``make_train_step`` of qwen3-1.7b at full
   width cut to 2 layers (B 1 x S 256) on the card and on the CPU from the
   same params: loss, grad norm, every gradient leaf and the updated
   params within ``LM_PARITY_TOL``; 2 ``flash_attention`` backwards.
10. LM training path: qwen3-1.7b at full width (28 layers, f32 master
   params from a seeded generator, bf16 compute, remat), 8 AdamW steps on
   ``SyntheticTokenStream(vocab, 4, 1024)``: every loss finite and the
   last below the first, 56 ``flash_attention`` forwards and 28 backwards
   a step and no other kernel; step time, tokens/s, peak device memory, a
   profiler window over one more step. Then the recurrent families the
   same way: the parity at one zamba2-2.7b period (6 Mamba2 blocks and
   the shared block, B 1 x S 256) and two rwkv6-7b layers (B 1 x S 128),
   and the path at full width, zamba2-2.7b at full depth (9 periods, 54
   layers) and rwkv6-7b cut to 8 of 32 layers (``RECURRENT_TRAIN_LAYERS``,
   the most that stay under 72 GB): per
   step 12 ``ssd_scan`` forwards, 6 backwards, 2 ``flash_attention``
   forwards and 1 backward a period; 2 ``wkv6_scan`` forwards and 1
   backward a layer; peak device memory under 72 GB.
11. launcher: ``repro_torch.launch.train`` on qwen3-1.7b's smoke config,
   12 steps, checkpoints every 4, a failure injected at step 6: one
   failure handled, one restore, the final checkpoint restored equal.
12. guard: ``decode_attention`` and ``fleet_mlp`` refuse CUDA tensors
   that require grad (no training path differentiates them); ``ssd_scan``
   and ``wkv6_scan`` record a gradient for every input on the card.
13. MoE serving, after rwkv6-7b's serve path: dbrx-132b (16 experts,
   top-4) at full width cut to 8 of 40 layers and llama4-maverick (128
   experts, top-1 and a shared expert) to one of 24 periods, a dense and
   an MoE layer (``MOE_LAYERS``; depth only, for memory), each as 5-6:
   prefill of 4 x 1024 tokens with 8 / 2 ``flash_attention`` launches and
   the share of expert choices its capacity dropped; the 128-token
   prefill vs decode check with every layer's routes recorded on both
   sides (entries and expert sets that differ, their gate margins, the
   flips with none upstream apart) and decode routed as prefill held at
   ``PREFILL_DECODE_TOL`` (logits and router logits); ``ServeEngine`` (4
   slots x 512 positions, 8 requests) with 8 / 2 ``decode_attention``
   launches a call; parameter counts, the decode call against the floor
   its weight bytes set, peak device memory under 72 GB. Then one f32
   ``make_train_step`` of each smoke config on the card against the CPU,
   aux losses and routes included, within ``LM_PARITY_TOL``. Within 120 s.
14. serving and scoring across devices: (a) ``decode_attention``'s stats
   route (o, m, l in f32) against its plain version at qwen3-1.7b's and
   dbrx-132b's engine shapes in bf16 and f32, with an empty row (m =
   -1e30, l = 0, o = 0) and a row that ends in the first shard; each
   cache cut into 2, 4 and 8 sequence shards, the shards' partials
   recombined by the distributed flash-decode's ``combine_partials`` and
   held against the one-shot kernel and the plain version, no NaN; the
   stats route and one shard of each cut timed beside the one-shot
   kernel. (b) qwen3-1.7b at full width in an NCCL world of one on
   127.0.0.1, a (1, 1) mesh: 5 ``decode_step(attn_dist=...)`` against
   the undistributed steps from the same seeded caches, the logits and
   caches held at the bf16 attention tolerance, 28 stats-route launches a
   step. (c) the four forecasters' fleets of 7 prosumers on a fleet mesh
   naming the card three times (pad 2) against no mesh, versions at rtol
   5e-2 / atol 5e-3 and forecasts at rtol 2e-3 / atol 1e-3, one fleet
   call a bin; the ANN score rollout at N 512, width 512 on that mesh:
   the same forecasts and ``fleet_mlp`` 3 x 24 times.
15. dense configs: llama3-8b, starcoder2-7b, internlm2-20b, qwen2-vl-7b
   (M-RoPE) and hubert-xlarge (non-causal, D 80, encoder only) at full
   width cut to 2 layers: one 64-token forward each against the port on
   the CPU in f32 (relative L2 of the logits within
   ``DENSE_GAP_TOL``), the warm time and peak device memory; an engine
   run of 4 requests for each decoder.
16. training across devices, in an NCCL world of one on 127.0.0.1: (a)
   qwen3-1.7b at full width, 14 of its 28 layers (``SHARDED_TRAIN_LAYERS``;
   f32 masters, bf16 compute, remat, B 4 x S 1024) through
   ``launch.cells.build_cell``'s train ``fn`` on a (1, 1) ("data",
   "model") mesh (``baseline_rules``), 4 steps, each from the same state
   as the undistributed ``make_train_step``: loss, grad norm and every
   param leaf within ``LM_PARITY_TOL`` (the bit-equal leaves counted), the
   moments and step count bit-equal (by sums of their bits), 28
   ``flash_attention`` forwards and 14 backwards a step; both steps'
   times, tokens/s and peak memory. (b) The
   same from the same start with ``compress_with_feedback`` as the hook:
   losses finite, the last below the first, each leaf's compression
   error within half a code. (c) (a)'s state through
   ``CheckpointManager.save_async`` (one shard file a rank), a mesh from
   ``elastic_remesh``, ``restore_latest(shardings=)``: bit-equal; then
   ``TrainSupervisor.run(..., shardings=)`` with a ``NodeFailure``
   (qwen3-1.7b at full width, 2 layers): one restore, the final state
   equal to the uninterrupted run's. (d) The five dense configs' training
   at full width, 2 layers: one f32 step's gradients card against CPU
   (``lm_train_parity(gradients_only=True)``), bf16 steps
   (``lm_train_path``; a token model's loss falls) with 2
   ``flash_attention`` forwards and 1 backward a layer. (e) The dry run's ``compute_s`` for (a)'s cell
   no larger than (a)'s measured step, and its count of qwen3-1.7b
   ``train_4k`` on the production mesh. Within 240 s. Since the cells
   compute on their shards, (a) runs through the tensor-parallel code at
   a model extent of 1 (every collective of a one-rank group skipped).
17. the cells on their shards: (a) ``flash_attention`` (forward and
   backward, bf16, B 4, S 1024) and ``decode_attention`` (B 8, S 2048) at
   one rank's head counts on the pod mesh's model axis (``TP_HEADS``:
   qwen3-1.7b at 2, H 8 / KV 4; llama3-8b at 16, H 2 / KV 1;
   internlm2-20b at 16, H 3 / KV 1, group 3; dbrx-132b at 2, H 24 / KV 4,
   group 6) against their plain
   versions, timed beside them and ``scaled_dot_product_attention``,
   with their bounds (the ``per_rank`` entries of the kernels line).
   (b) A world of two gloo processes on the one card (NCCL takes one rank
   a device): each collective the cells issue probed on CUDA tensors; if
   gloo refuses one, the line names it and the world of one (16 (a))
   stands alone. Else qwen3-1.7b at full width, 2 layers, f32, on a
   (1, 2) ("data", "model") mesh: a train step through the cell, a
   prefill and a decode step with and without the distributed
   flash-decode (``serve_rules``) against the world of one's calls on the
   same inputs at ``TP_WORLD_TOL`` (``tests/test_torch_sharded_train.py``'s
   pins). Within ``TP_WORLD_SECONDS``.
18. the MoE cells on their expert shards: dbrx-132b at full width cut to
   one layer, f32, in a world of two gloo processes on the card (every
   collective the cells issue probed on CUDA tensors first; a refused one
   fails the phase). Rank 0 runs the world of one first (the gradients of
   a step, a prefill and a decode step; the prefill and decode again row
   by row) and keeps its figures on the host; then each rank draws its
   shards leaf by leaf: the gradients (``make_sharded_grad_fn``, B 2 x S
   256) on a (1, 2) mesh under ``baseline_rules`` (8 experts a rank)
   against the world of one's at ``LM_PARITY_TOL`` (a full AdamW step
   does not fit the card); prefill and decode, with and without the
   distributed flash-decode, under ``serve_rules`` on (1, 2) and on (2, 1)
   (each expert's columns over ``data``) at ``TP_WORLD_TOL["serve"]``.
   Every rank's routes against the world of one's (a serve call whose
   routes differ is held with the world of one's routes pinned), its
   collectives a call (equal to ``dryrun.account``'s), rank 0's launches
   at H 24 / KV 4, and the times and peak memory beside the world of
   one's. Within ``EP_WORLD_SECONDS``.
19. zamba2 on its shards: zamba2-2.7b at full width cut to one period
   (6 Mamba2 blocks and the shared block), f32, in a world of two gloo
   processes on the card (every collective probed on CUDA tensors first;
   a refused one fails the phase), on a (1, 2) mesh: 40 SSD heads, 16
   shared heads and 16,000 vocabulary rows a rank. A train step (B 2 x
   S 256) under ``baseline_rules`` against the world of one's
   ``make_train_step`` (loss, grad norm and every gradient leaf at
   ``LM_PARITY_TOL``, the params by ``_update_excess``); prefill and
   decode, with and without the distributed flash-decode, under
   ``serve_rules`` at ``MAMBA_SERVE_TOL`` (logits, the shared block's
   k/v, the conv and ssd states: 2e-5 of each tensor's max); each rank's
   collectives equal
   to ``dryrun.account``'s; no Mamba2 weight all-gathered over ``model``
   in decode (in train and prefill only ``in_proj``); the scan launches
   on rank 0. Within ``MAMBA_WORLD_SECONDS``. The per-rank cases at the
   end add the shared block's attention at D 80 (H 2 and H 16) and the
   SSD scan forward and backward at 5 heads (``tp_ssd_phase``: the
   train_4k and prefill_32k cells' rows a device on the pod mesh).
20. rwkv6 on its shards: rwkv6-7b at full width cut to 2 layers, f32, in
   a world of two gloo processes on the card (every collective probed on
   CUDA tensors first; a refused one fails the phase), on a (1, 2) mesh:
   32 WKV heads, 7,168 channel-mix columns and 32,768 vocabulary rows a
   rank. A train step (B 2 x S 256) under ``baseline_rules`` against the
   world of one's ``make_train_step`` (the loss at ``LM_PARITY_TOL``, the
   grad norm and every gradient leaf within ``RWKV_ORDER_FACTOR`` times
   the world of one's own gap summed in two microbatches on the card, the
   params by ``_update_excess``); prefill and decode (with and without
   the distributed flash-decode flag, which an attention-free model
   ignores) under ``serve_rules`` at ``MAMBA_SERVE_TOL`` (logits,
   ``x_tm``, ``x_cm`` and ``wkv``: 2e-5 of each tensor's max); each
   rank's collectives equal to ``dryrun.account``'s; no RWKV6 weight
   all-gathered over ``model``; the scan launches on rank 0 (4 forward
   and 2 backward a train step, 2 a prefill). Within
   ``RWKV_WORLD_SECONDS``. Phases 19 and 20 share ``_shards_world_body``.
   The per-rank cases at the end add the WKV scan forward at 4 heads (the
   train_4k cell's rows a microbatch on a device, B 4 x S 4096, and
   prefill_32k's, B 2 x S 32768) and its backward at B 4 x S 4096
   (``tp_wkv_phase``).
21. the mid-head attention on its head slots: qwen2-vl-7b at full width
   (H 28, KV 4 of D 128) cut to 2 layers, f32, in a world of 8 gloo
   processes on the card (every collective probed on CUDA tensors first,
   the all-to-all with them; a refused one fails the phase), on a (1, 8)
   mesh: each rank's 3.5 heads of q columns exchanged onto slots of 4
   heads (rank 7's empty), 19,008 vocabulary rows a rank. A train step (B
   2 x S 256) under ``baseline_rules``, prefill and decode (with and
   without the distributed flash-decode) under ``serve_rules``, against
   the world of one at phase 17 (b)'s pins (``LM_PARITY_TOL`` for the
   loss, grad norm and every gradient leaf, the params by
   ``_update_excess``, the serve logits and caches at
   ``TP_WORLD_TOL["serve"]``); each rank's collectives equal to
   ``dryrun.account``'s at its model coordinate; no attention weight
   all-gathered over ``model``; the attention launches on rank 0 and on
   the empty rank. Within ``MIDHEAD_WORLD_SECONDS``; it shares
   ``_shards_world_body``. The per-rank cases at the end add the slots of
   the three mid-head configs on 16 model ranks: qwen2-vl-7b's 2 heads
   over 2 KV heads and llama4-maverick's last slot of one head
   (starcoder2-7b's and llama4-maverick's 3 heads over one KV head are
   internlm2-20b's case).

Each model is freed before the next is drawn. The ``kernels`` line has
eight rows: the five kernels and the three backwards (their launches are
the training paths' backward calls: qwen3-1.7b's for
``flash_attention_backward``, zamba2-2.7b's and rwkv6-7b's for the
scans'); ``decode_attention``'s row also carries its stats route's
check, times and bound (``stats_*``) and launches (phase 14 b); the
attention rows carry phase 17 (a)'s per-rank cases, the SSD scan's rows
phase 19's and the WKV scan's rows phase 20's (``per_rank``).
Every kernel count is set to 0 just before each path and read just after.
The last lines are the ``{"kernels": [...]}`` record and the device line.
Without a card, or without ``src/repro_torch`` beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bandwidth
# and float32 outside the tensor cores (the kernel's FMAs are f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the card's L2 cache, which timed inputs must not stay in between calls
L2_BYTES = 50 * 2**20

# same tolerances as tests/test_torch_fleet_mlp.py, on |got - ref| / (1 + |ref|)
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
# (label, N, b, F, hidden, depth, dtype); the first is the scoring shape
SCORING_CASE = ("scoring", 512, 1, 54, 512, 5, "float32")
TEST_SHAPES = [(16, 4, 8, 32, 3), (8, 1, 54, 64, 5), (4, 2, 16, 16, 1)]
KERNEL_CASES = [SCORING_CASE] + [
    (f"test{i}", *s, dt) for dt in ("float32", "bfloat16")
    for i, s in enumerate(TEST_SHAPES)] + [
    ("ragged", 500, 1, 54, 512, 5, dt) for dt in ("float32", "bfloat16")]

# the tensor cores' dense bf16 rate (the attention kernels' inputs are
# bf16 on the path; their bound is the least time for the same work)
BF16_FLOP_PER_S = 989e12
# tests/test_kernels.py's tolerances for the attention kernels, on
# |got - ref| / (1 + |ref|): f32 sums in another order differ in the last
# digits, bf16 outputs keep ~3 significant digits
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (label, B, Sq, Skv, H, KV, D, dtype, causal); the first is the path shape
FLASH_PATH_CASE = ("prefill", 4, 1024, 1024, 16, 8, 128, "bfloat16", True)
FLASH_CASES = [FLASH_PATH_CASE] + [
    (f"test{i}", *s, dt, causal) for dt in ("float32", "bfloat16")
    for causal in (True, False)
    for i, s in enumerate([(1, 128, 128, 4, 4, 32), (2, 256, 256, 4, 2, 32),
                           (1, 128, 128, 8, 2, 64), (1, 96, 96, 4, 4, 80),
                           (1, 64, 256, 4, 2, 32), (2, 37, 200, 4, 1, 80),
                           # GQA groups 5, 6, 7 and 9 at D 128
                           (1, 128, 128, 40, 8, 128), (2, 96, 160, 48, 8, 128),
                           (1, 200, 200, 28, 4, 128), (2, 64, 64, 36, 4, 128)
                           ])] + [
    ("zamba2", 4, 1024, 1024, 32, 32, 80, "bfloat16", True),
    ("dbrx", 4, 1024, 1024, 48, 8, 128, "bfloat16", True),
    ("maverick", 4, 1024, 1024, 40, 8, 128, "bfloat16", True)]
# the attention cases timed beside their plain version and SDPA: the path
# shapes (qwen3-1.7b's, in the kernels line), zamba2-2.7b's and the MoE
# models' (dbrx-132b at GQA group 6, llama4-maverick at group 5)
TIMED_LABELS = ("prefill", "serve", "zamba2", "dbrx", "maverick")
# (label, B, S, H, KV, D, dtype); the first is the engine shape
DECODE_PATH_CASE = ("serve", 8, 2048, 16, 8, 128, "bfloat16")
DECODE_CASES = [DECODE_PATH_CASE] + [
    (f"test{i}", *s, dt) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(3, 256, 4, 2, 32), (2, 128, 8, 8, 64),
                           (3, 200, 4, 4, 80), (2, 300, 28, 4, 128),
                           # GQA groups 5, 6 and 9 at D 128 (7 is the last)
                           (2, 256, 40, 8, 128), (3, 300, 48, 8, 128),
                           (2, 200, 36, 4, 128)])] + [
    ("zamba2", 4, 512, 32, 32, 80, "bfloat16"),
    ("dbrx", 4, 512, 48, 8, 128, "bfloat16"),
    ("maverick", 4, 512, 40, 8, 128, "bfloat16")]
# prefill vs token-by-token decode of the same 128 tokens, relative L2 of
# the last logits: both run in bf16 but round in different places (GEMMs of
# 128 rows against 1, the caches written by prefill against by decode), a
# few bf16 ulps (2^-8 each) that 28 residual layers carry to the logits
PREFILL_DECODE_TOL = 5e-2
# the same check for the recurrent families, on the last logits and on the
# final scan states (``ssd`` / ``wkv``, every layer). There the gap is
# larger: prefill rounds the conv / token-shift inputs and the scan's
# inputs over 128 rows, decode over one, and each flipped bf16 rounding is
# carried by the recurrence as well as by the residual stream. The same
# check at full depth on the CPU, at widths 256-1024 (bf16, 64 tokens),
# read 5.4e-2 to 7.7e-2 on the logits and 4.0e-2 to 7.5e-2 on the states
# for both families, flat in width; 1.5e-1 keeps a 2x margin over that. A
# scan that is wrong (a decay, a state carried wrongly) moves both by O(1);
# the kernels themselves are held to their plain versions far tighter
RECURRENT_DECODE_TOL = 1.5e-1

# tests/test_kernels.py's tolerances for the scans in f32 (per-token sums
# against chunked ones; WKV's decay products over up to 32 steps), on
# |got - ref| / (1 + |ref|); bf16 outputs keep ~3 significant digits. The
# final states are f32 on both sides and always take the f32 tolerance.
SSD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
WKV_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# (label, B, S, H, P, N, dtype, chunk[, dt range]); the first is the
# zamba2-2.7b prefill shape, then tests/test_kernels.py's (dt ~ U(1e-3,
# 0.1), the default), then strong decay: dt ~ U(1, 5), so dt |A| reaches
# 10. The strong cases are held against the per-token recurrence
# (ssd_sequential): there the chunked plain form's f32 differences of
# large cumulative decays lose digits (1e-4 against a float64 recurrence)
SSD_PATH_CASE = ("prefill", 4, 1024, 80, 64, 64, "bfloat16", 64, (1e-3, 0.1))
SSD_CASES = [SSD_PATH_CASE] + [
    (f"test{i}", *s[:5], dt, s[5], (1e-3, 0.1)) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(2, 128, 3, 16, 16, 32), (1, 64, 2, 8, 32, 16),
                           (1, 96, 1, 32, 16, 32)])] + [
    (f"strong{i}", *s[:5], dt, s[5], (1.0, 5.0)) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(2, 128, 3, 16, 16, 32), (1, 256, 4, 64, 64, 64)])]
# (label, B, S, H, K, dtype, wmin, chunk); decays w ~ U(wmin, 0.999): 0.4
# is mild, 0.001 aggressive; below 1e-6 (extreme) w is log-uniform on
# [wmin, 0.999], so decays near 1e-30 occur, and the case is held against
# the per-token recurrence (wkv6_sequential), as the strong SSD cases
# are (the chunked form misses a float64 recurrence by 2e-3 there). The
# first is the rwkv6-7b prefill shape
WKV_PATH_CASE = ("prefill", 4, 1024, 64, 64, "bfloat16", 0.4, 32)
WKV_CASES = [WKV_PATH_CASE] + [
    (f"test{i}", *s[:4], dt, wmin, s[4]) for dt in ("float32", "bfloat16")
    for wmin in (0.4, 0.001)
    for i, s in enumerate([(2, 128, 3, 16, 32), (1, 64, 2, 32, 16)])] + [
    (f"extreme{i}", *s[:4], dt, 1e-30, s[4]) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(2, 128, 3, 16, 32), (1, 256, 4, 64, 32)])]

KERNEL_NAMES = ("fleet_mlp", "flash_attention", "decode_attention",
                "ssd_scan", "wkv6_scan")
# the kernels with a backward, each counted as ``<name>_backward``
BACKWARD_NAMES = ("flash_attention", "ssd_scan", "wkv6_scan")
# every launch count the smoke reads: the five kernels' forwards and the
# three backwards (a flash_attention backward call is three launches, a
# scan's two: the backward and the sum of its partials)
COUNT_NAMES = KERNEL_NAMES + tuple(f"{n}_backward" for n in BACKWARD_NAMES)
DAY, HOUR = 86400.0, 3600.0
HORIZON = 24
# tracer spans summed per tick: the tick, the scheduler poll, the train
# phase, the fleet bins, their store reads, the runtime's cold builds, and
# the device rollouts (each ends in the copy of the forecasts to the host)
SPANS = ("castor.tick", "scheduler.poll", "exec.phase.train", "exec.bin",
         "store.read_many", "runtime.build", "rollout.device")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def _fleet_inputs(N, b, F, hidden, depth, dtype, device, seed):
    """He-scaled weights so every layer's activations stay O(1)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [F] + [hidden] * (depth - 1) + [1]

    def draw(*shape, scale=1.0):
        t = torch.randn(*shape, generator=g, device=device) * scale
        return t.to(getattr(torch, dtype))

    x = draw(N, b, F)
    ws = [draw(N, sizes[i], sizes[i + 1], scale=(2.0 / sizes[i]) ** 0.5)
          for i in range(depth)]
    bs = [draw(N, sizes[i + 1], scale=0.1) for i in range(depth)]
    return x, ws, bs


def _input_sets(inputs: tuple, nbytes: int) -> list:
    """``inputs`` and as many clones as it takes for the other sets' bytes
    between two uses of one set to reach twice the card's L2: a call then
    finds its inputs cold, as it does on the path, where the other layers'
    weights and caches pass through the L2 between two calls."""
    n = 1 if nbytes >= 2 * L2_BYTES else 1 + -(-2 * L2_BYTES // nbytes)
    return [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(n - 1)]


def _time_ms(fn, sets: list, iters: int, graph: bool = False) -> float:
    """Mean milliseconds per call of ``fn(*sets[i % len(sets)])`` between
    CUDA events, after a warm-up. Eager, an op that the host issues more
    slowly than the card runs it reads the host's issue time; with
    ``graph`` the same calls are captured in one CUDA graph and replayed,
    and the time is the device's alone."""
    import torch
    calls = [functools.partial(fn, *sets[i % len(sets)])
             for i in range(iters)]
    for call in calls[:len(sets) + 2]:
        call()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for call in calls:
                call()
        g.replay()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for call in calls:
            call()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fleet_mlp_bound(x, ws, bs) -> dict:
    """Least time the card could take: each input read once and the output
    written once over HBM, against the f32 multiply-adds over the f32
    peak; the larger of the two bounds it."""
    N, b, _ = x.shape
    out_bytes = N * b * ws[-1].shape[2] * x.element_size()
    nbytes = sum(t.numel() * t.element_size() for t in (x, *ws, *bs)) \
        + out_bytes
    flops = sum(2 * N * b * w.shape[1] * w.shape[2] + N * b * w.shape[2]
                for w in ws)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_phase(device: str, cases=KERNEL_CASES, *, time_it: bool) -> dict:
    """``fleet_mlp`` through its public wrapper against the plain version
    on the same inputs, for every case; returns the scoring case's record
    (error, and with ``time_it`` the CUDA-event times and bound)."""
    import torch
    from repro_torch.kernels.fleet_mlp.ops import fleet_mlp
    from repro_torch.kernels.fleet_mlp.ref import fleet_mlp_reference
    record = None
    for seed, (label, N, b, F, hidden, depth, dtype) in enumerate(cases):
        x, ws, bs = _fleet_inputs(N, b, F, hidden, depth, dtype, device,
                                  seed)
        got = fleet_mlp(x, ws, bs)
        want = fleet_mlp_reference(x, ws, bs)
        if device != "cpu":
            torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{label}: kernel gave {tuple(got.shape)} {got.dtype}")
        diff = (got.float() - want.float()).abs()
        rel = float((diff / (1 + want.float().abs())).max())
        max_abs = float(diff.max())
        ok = rel <= TOL[dtype] and bool(torch.isfinite(got.float()).all())
        print(f"kernel {label:8s} N={N} b={b} F={F} width={hidden} "
              f"depth={depth} {dtype}: rel_err={rel:.3e} "
              f"max_abs_err={max_abs:.3e} tol={TOL[dtype]:.0e} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"fleet_mlp disagrees with its plain version at {label} "
                  f"{dtype}: {rel:.3e} > {TOL[dtype]:.0e}")
        if label != SCORING_CASE[0]:
            continue
        record = {"max_abs_err": max_abs, "rel_err": rel,
                  **fleet_mlp_bound(x, ws, bs)}
        if time_it:
            _timed(record, _input_sets((x, ws, bs), record["bytes"]),
                   fleet_mlp, fleet_mlp_reference, None, 50)
            print("kernel scoring time: " + _times(
                record, "no single PyTorch call computes the per-instance "
                        "chain"))
    return record


# the forecast flow's clock: the first tick trains and scores at T0
T0 = 40 * DAY
MINUTE = 60.0
# trained params across reassociation (tests/test_fleet_mesh.py) and
# forecasts/bands (FLEET_RTOL/ATOL, src/repro/testing.py)
PARAM_TOL = dict(rtol=5e-2, atol=5e-3)
FC_TOL = dict(rtol=2e-3, atol=1e-3)
# the card-against-CPU training check: a small bin per kind at the JAX
# package's test sizes (tests/test_fleet_rollout.py)
PARITY_HP = {
    "LR": {"target_lags": 12, "weather_lags": 4},
    "GAM": {"target_lags": 12, "weather_lags": 4},
    "ANN": {"hidden": 24, "epochs": 40, "target_lags": 12},
    "LSTM": {"hidden": 12, "epochs": 40, "target_lags": 12},
}


def flow_modules():
    """The port's classes the forecast flow is built from (``build_flow``
    takes them as an argument, so a test can build the JAX package's twin
    of the same flow)."""
    from types import SimpleNamespace
    from repro_torch.core import Castor, ModelDeployment, Schedule
    from repro_torch.forecast import PAPER_MODELS, EnergyFromCurrentModel
    from repro_torch.forecast.anomaly import BandAnomalyDetector
    from repro_torch.timeseries.ingest import (SiteSpec, build_site,
                                               ingest_current_feed)
    return SimpleNamespace(
        Castor=Castor, ModelDeployment=ModelDeployment, Schedule=Schedule,
        PAPER_MODELS=PAPER_MODELS,
        EnergyFromCurrentModel=EnergyFromCurrentModel,
        BandAnomalyDetector=BandAnomalyDetector, SiteSpec=SiteSpec,
        build_site=build_site, ingest_current_feed=ingest_current_feed)


def build_flow(c, m, *, n_prosumers: int, hidden: int, sub_width: int,
               epochs, seed: int) -> dict:
    """The paper's workload (``examples/smartgrid_forecasting.py``) on one
    site: an ANN fleet over every prosumer (rank 0: the detection flow's
    bands), an LR fleet over every prosumer (rank 1), the four paper
    models on the substation at ``sub_width`` (ANN, LSTM), and the
    current -> 15-minute energy transform. Everything trains weekly and
    scores hourly from T0; ``epochs`` None keeps each model's DEFAULTS
    (ANN 300, LSTM 200). ``m`` holds the classes (``flow_modules``)."""
    info = m.build_site(c, m.SiteSpec("SITE", n_prosumers=n_prosumers,
                                      n_feeders=8, n_substations=1,
                                      seed=seed), t0=0.0, t1=41 * DAY)
    m.ingest_current_feed(c, "SITE_SUB_0", t0=T0 - 5 * DAY, t1=T0)
    train, score = m.Schedule(T0, 7 * DAY), m.Schedule(T0, HOUR)
    fit = {} if epochs is None else {"epochs": epochs}
    publish_flow(c, m)
    fleet = c.deploy_for_all(package="ann", signal="ENERGY_LOAD",
                             name_prefix="ann", kind="PROSUMER", train=train,
                             score=score, user_params={
                                 "hidden": hidden, "train_window_days": 28,
                                 "horizon": HORIZON, **fit})
    lr_fleet = c.deploy_for_all(package="castor-lr", signal="ENERGY_LOAD",
                                name_prefix="fleet-lr", kind="PROSUMER",
                                train=train, score=score,
                                user_params={"train_window_days": 21},
                                rank=1)
    for rank, kind in enumerate(m.PAPER_MODELS):
        hp = {"hidden": sub_width, **fit} if kind in ("ANN", "LSTM") else {}
        c.deploy(m.ModelDeployment(
            name=f"{kind}-sub", package=f"castor-{kind.lower()}",
            signal="ENERGY_LOAD", entity="SITE_SUB_0", train=train,
            score=score, user_params={"train_window_days": 28, **hp},
            rank=rank))
    c.add_signal("ENERGY_LOAD_15MIN", unit="kWh")
    c.deploy(m.ModelDeployment(
        name="xform-sub", package="castor-xform", signal="ENERGY_LOAD_15MIN",
        entity="SITE_SUB_0", train=m.Schedule(T0, 1e12),
        score=m.Schedule(T0, DAY), user_params={"window_days": 5}))
    return {"readings": info["readings"], "fleet": fleet,
            "lr_fleet": lr_fleet}


def publish_flow(c, m) -> None:
    """The flow's implementations. They are code, not journaled data: a
    system recovered by ``Castor.open`` publishes them again."""
    c.publish("ann", "1.0", m.PAPER_MODELS["ANN"])
    for kind, cls in m.PAPER_MODELS.items():
        c.publish(f"castor-{kind.lower()}", "1.0", cls)
    c.publish("castor-xform", "1.0", m.EnergyFromCurrentModel)


def flow_system(n_prosumers: int, hidden: int, sub_width: int, epochs,
                seed: int, device: str):
    """A fresh system holding the flow's site and deployments
    (``build_flow``) on ``device``: the factory a spawned serverless worker
    builds its replica with (module-level, so a ``functools.partial`` of
    it pickles by reference)."""
    m = flow_modules()
    c = m.Castor(device=device)
    build_flow(c, m, n_prosumers=n_prosumers, hidden=hidden,
               sub_width=sub_width, epochs=epochs, seed=seed)
    return c


def flow_forecasts(c, names) -> dict:
    """Every persisted forecast of the named deployments as
    ``{name: [(created_at, values, lower, upper), ...]}`` (host arrays)."""
    return {n: [(f.created_at, f.values, f.lower, f.upper)
                for f in c.predictions.history(n)] for n in names}


def fleet_train_mape(c, names, now: float):
    """One-step training MAPE (%) of the named deployments' versions at
    ``now`` (one class; the flow's sanity check of what a fit learned),
    computed on the system's device from the versions as persisted."""
    import numpy as np
    from repro_torch.forecast.base import stack_versions
    from repro_torch.timeseries.transforms import mape
    deps = [c.deployments.get(n) for n in names]
    cls = c.registry.get(deps[0].package, deps[0].version)
    up = {**cls.DEFAULTS, **deps[0].user_params, "now": now}
    insts = [cls(context=c.graph.context(d.signal, d.entity), task="train",
                 model_id=d.name, model_version=None, user_params=up,
                 system=c) for d in deps]
    X, y, _, _ = cls._fleet_xy(insts)
    stacked, _, _ = stack_versions([c.versions.get(d.name, at=now).params
                                    for d in deps])
    yhat = cls._fleet_window_predict(stacked, X)
    return np.asarray([mape(y[i], yhat[i]) for i in range(len(deps))])


def live_feed(c, m, fleet, t_start: float, n_minutes: int, seed: int):
    """The detection flow over the ANN fleet: one minutely detector per
    prosumer from ``t_start + MINUTE``, and minutely readings around each
    prosumer's best forecast (one sensor spiked far outside its band from
    the window's midpoint on), as ``repro.testing``'s detection fixture
    builds them."""
    import numpy as np
    c.publish("anom", "1.0", m.BandAnomalyDetector)
    c.deploy_detections(package="anom", signal="ENERGY_LOAD",
                        name_prefix="d", kind="PROSUMER",
                        detect=m.Schedule(t_start + MINUTE, MINUTE))
    rng = np.random.default_rng(seed)
    t = t_start + MINUTE * np.arange(1, n_minutes + 1)
    for i, d in enumerate(fleet):
        fc = c.best_forecast(d.signal, d.entity)
        v = np.interp(t, fc.times, fc.values) + rng.normal(0.0, 0.01, t.shape)
        if i == 0:
            v[n_minutes // 2:] += 25.0
        c.ingest(c.graph.context(d.signal, d.entity).ts_id, t, v)


def flow_ticks(c, n_ticks: int, n_minutes: int, fleet, m, seed: int,
               sync=lambda: None) -> list:
    """Drive the flow: ``n_ticks`` hourly ticks from T0 (the first trains
    and scores, the rest score), then the detection flow and
    ``n_minutes`` minutely detect ticks. Returns one record per tick."""
    ticks = []
    times = [T0 + k * HOUR for k in range(n_ticks)]
    t_last = times[-1]
    for k, now in enumerate(times + [t_last + MINUTE * (j + 1)
                                     for j in range(n_minutes)]):
        if k == n_ticks:
            live_feed(c, m, fleet, t_last, n_minutes, seed)
        c.tracer.clear()
        t = time.perf_counter()
        results = c.tick(now, executor="fleet")
        sync()
        secs = time.perf_counter() - t
        ticks.append({"now": now, "seconds": secs, "results": results,
                      "stats": list(c.fleet_executor().last_bin_stats),
                      "spans": c.tracer.spans()})
    return ticks


def _package(stats: dict) -> str:
    return stats["bin"].split("'")[1]


def _task(stats: dict) -> str:
    return stats["bin"].split("'")[5]


def tick_modes(ticks) -> list:
    """(package, task, runtime mode) of every fleet bin, per tick: what
    the runtime reports, compared with the JAX package's in the tests."""
    return [[(_package(s), _task(s), s["runtime"]) for s in t["stats"]]
            for t in ticks]


def forecast_flow(device: str, *, n_prosumers: int = 512, hidden: int = 512,
                  sub_width: int = 512, epochs=None, n_ticks: int = 3,
                  n_minutes: int = 5, n_checked: int = 4,
                  seed: int = 11) -> dict:
    """Drive the forecast flow through ``Castor.tick`` (train -> score ->
    detect) and check what it did. Returns the runtime modes per tick,
    the ``fleet_mlp`` launch total, the fleet's median training MAPE and
    the persisted forecasts of both fleets and the substation models."""
    import numpy as np
    import torch
    from repro_torch.forecast import ann, lstm
    from repro_torch.forecast.anomaly import BandAnomalyDetector
    from repro_torch.kernels.fleet_mlp import ops
    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    m = flow_modules()
    t = time.perf_counter()
    c = m.Castor(device=device)
    built = build_flow(c, m, n_prosumers=n_prosumers, hidden=hidden,
                       sub_width=sub_width, epochs=epochs, seed=seed)
    fleet = built["fleet"]
    check(len(fleet) == len(built["lr_fleet"]) == n_prosumers,
          f"{len(fleet)} ANN deployments")
    print(f"flow setup: {built['readings']} readings, {n_prosumers} ANN "
          f"(hidden {hidden}) + {n_prosumers} LR prosumer deployments, "
          f"LR/GAM/ANN/LSTM (width {sub_width}) + transform on the "
          f"substation, {time.perf_counter() - t:.1f} s")

    # the fits' times: CUDA events around each stacked Adam fit (device
    # time, the fit's whole queue), host clock on the CPU
    fits = []

    def timed(label, fit):
        def run(params, loss_fn, n_epochs, lr):
            n = next(iter(params.values())).shape[0]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if cuda else None
            t0 = time.perf_counter()
            if ev:
                ev[0].record()
            out = fit(params, loss_fn, n_epochs, lr)
            if ev:
                ev[1].record()
            fits.append({"model": label, "n": n, "epochs": n_epochs,
                         "events": ev, "host_s": time.perf_counter() - t0})
            return out
        return run

    originals = (ann.fit_adam, lstm.fit_adam)
    ann.fit_adam = timed("ANN", originals[0])
    lstm.fit_adam = timed("LSTM", originals[1])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        ticks = flow_ticks(c, n_ticks, n_minutes, fleet, m, seed, sync)
    finally:
        ann.fit_adam, lstm.fit_adam = originals
    launches = ops.invocation_count()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    for f in fits:
        f["seconds"] = (f["events"][0].elapsed_time(f["events"][1]) / 1e3
                        if cuda else f["host_s"])

    # ---- what each tick did ----
    rt = c.fleet_executor().runtime
    for k, rec in enumerate(ticks):
        results, stats = rec["results"], rec["stats"]
        errors = [r.error for r in results if not r.ok]
        check(not errors, f"tick {k + 1}: {len(errors)} failed jobs, "
                          f"first: {errors[:1]}")
        tasks = [_task(s) for s in stats]
        ann_scores = [s for s in stats if _task(s) == "score"
                      and _package(s) in ("ann", "castor-ann")]
        spans = {}
        for sp in rec["spans"]:
            if sp.name in SPANS:
                spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration
        rec.update(jobs=len(results), tasks=tasks, span_sums=spans,
                   ann_score_bins=len(ann_scores))
        counts_ = {task: sum(r.job.task == task for r in results)
                   for task in ("train", "score", "detect")}
        print(f"tick {k + 1} (T0 + {rec['now'] - T0:.0f} s): "
              f"{rec['seconds']:.3f} s wall, jobs {len(results)}/"
              f"{len(results)} ok ({counts_['train']} train, "
              f"{counts_['score']} score, {counts_['detect']} detect), "
              f"runtime {[s['runtime'] for s in stats]}")
        print(f"tick {k + 1} spans (host clock, s): " + ", ".join(
            f"{name} {spans.get(name, 0.0):.4f}" for name in SPANS))
        print(f"tick {k + 1} bins (host clock, s): " + ", ".join(
            f"{_package(s)} {_task(s)} {s['jobs']} {s['seconds']:.4f}"
            for s in stats))
        for s in stats:
            if _task(s) == "score":
                # the device rollout ran once per score bin: a fallback to
                # the host loop skips it, a runtime that gave up repeats it
                check(s["rollout_cache_hits"] + s["rollout_cache_misses"]
                      == 1, f"tick {k + 1}: {s['bin'][:60]} rollouts")
                check(s["runtime"] == "warm",
                      f"tick {k + 1}: score bin {s['bin'][:60]} ran "
                      f"{s['runtime']} ({s.get('runtime_reason', '')})")
            elif _task(s) == "train":
                check(s["runtime"] in ("cold", "warm"),
                      f"tick {k + 1}: train bin runtime {s['runtime']}")
    first, hourly, minutely = ticks[0], ticks[:n_ticks], ticks[n_ticks:]
    ann_train = [s for s in first["stats"]
                 if _package(s) == "ann" and _task(s) == "train"]
    check(len(ann_train) == 1 and ann_train[0]["runtime"] == "cold"
          and ann_train[0].get("runtime_reason") == "first load"
          and ann_train[0]["jobs"] == n_prosumers,
          f"tick 1: ANN fleet train bin {ann_train}")
    # the train tick: every deployment trains, then scores; the transform
    # (no fleet hooks) runs on the pool
    n_deps = 2 * n_prosumers + 4
    check(first["jobs"] == 2 * (n_deps + 1),
          f"tick 1: {first['jobs']} jobs for {n_deps + 1} deployments")
    for rec in hourly[1:]:
        check(rec["tasks"] and set(rec["tasks"]) == {"score"}
              and rec["jobs"] == n_deps, f"hourly tick: {rec['jobs']} jobs")
    for rec in hourly:
        check(rec["ann_score_bins"] == 2,
              f"{rec['ann_score_bins']} ANN score bins in an hourly tick")
    for rec in minutely:
        check(rec["jobs"] == n_prosumers and set(rec["tasks"]) == {"detect"},
              f"minutely tick: {rec['jobs']} jobs {set(rec['tasks'])}")
    n_ann_bins = sum(rec["ann_score_bins"] for rec in hourly)
    check(launches == HORIZON * n_ann_bins,
          f"{launches} fleet_mlp launches for {n_ann_bins} ANN score bins")

    # the same-tick score bin took the train handoff: the runtime's padded
    # parameters for the ANN fleet are the fit's own tensors (N is a
    # power of two: no pad, no copy)
    ids = {c.graph.context(d.signal, d.entity).ts_id for d in fleet}
    states = [s for s in rt._states.values() if set(s.ids) == ids
              and s.trained is not None and s.trained[4][0]["kind"] == "ANN"]
    check(len(states) == 1, "no ANN fleet state with a train handoff")
    state = states[0]
    stacked = state.trained[1]
    check(state.param_cache is not None
          and state.param_cache[1]["w0"] is stacked["w0"],
          "the ANN score bin re-stacked its versions")
    print(f"flow handoff: {rt.handoffs} score bins on the train handoff "
          f"over the hourly ticks; runtime cold loads {rt.cold_loads}, "
          f"warm loads {rt.warm_loads}")
    for name, v in stacked.items():
        check(bool(torch.isfinite(v).all()), f"trained ANN {name} not finite")
    for d in ("LR-sub", "GAM-sub", "ANN-sub", "LSTM-sub"):
        for name, v in c.versions.get(d).params["params"].items():
            check(bool(torch.isfinite(v.double()).all()),
                  f"{d} {name} not finite")

    # ---- the train tick's measurements ----
    ann_bin = [sp for sp in first["spans"] if sp.name == "exec.bin"
               and (sp.args or {}).get("bin_id") == ann_train[0]["bin_id"]]
    ann_fit = [f for f in fits if f["model"] == "ANN"
               and f["n"] == n_prosumers]
    check(len(ann_bin) == 1 and len(ann_fit) == 1,
          f"{len(ann_bin)} ANN train bin spans, {len(ann_fit)} fleet fits")
    fit_s = ann_fit[0]["seconds"]
    n_epochs = ann_fit[0]["epochs"]
    print(f"train tick: {first['seconds']:.3f} s wall; ANN fleet train bin "
          f"(exec.bin span) {ann_bin[0].duration:.3f} s, of which the fit "
          f"{fit_s:.3f} s ({'device' if cuda else 'host'} time): "
          f"{n_epochs} epochs x {n_prosumers} instances at width {hidden}, "
          f"{n_epochs / fit_s:.2f} epochs/s")
    if cuda:
        print(f"train tick peak device memory: {peak} bytes "
              f"(torch.cuda.max_memory_allocated over the flow)")
    sub_walls = {}
    for s in first["stats"]:
        if _task(s) == "train" and _package(s).startswith("castor-") \
                and s["jobs"] == 1:
            sub_walls[_package(s)[7:].upper()] = s["seconds"]
    for f in fits:
        if f["n"] == 1:
            print(f"substation fit: {f['model']} {f['epochs']} epochs in "
                  f"{f['seconds']:.3f} s")
    print("substation train walls (exec bin, host clock, s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sub_walls.items()))
    check(set(sub_walls) == {"LR", "GAM", "ANN", "LSTM"},
          f"substation train bins {sorted(sub_walls)}")

    # ---- the full-width fleet learned something ----
    mapes = fleet_train_mape(c, [d.name for d in fleet], T0)
    med = float(np.median(mapes))
    print(f"train check: ANN fleet one-step training MAPE median "
          f"{med:.2f} % (min {mapes.min():.2f}, max {mapes.max():.2f}; "
          f"bound 30 %)")
    check(bool(np.isfinite(mapes).all()) and med < 30.0,
          f"ANN fleet training MAPE median {med}")

    # ---- forecasts: finite, banded; fleet against single ----
    last = hourly[-1]["now"]
    for d in fleet:
        fc = c.predictions.latest(d.signal, d.entity)
        check(fc is not None and fc.created_at == last,
              f"{d.name}: no forecast from the last hourly tick")
        for arr in (fc.values, fc.lower, fc.upper):
            check(arr is not None and arr.shape == (HORIZON,)
                  and bool(np.isfinite(arr).all()),
                  f"{d.name}: forecast or band not finite / not ({HORIZON},)")
    worst = {}
    checked = [(d.name, d.signal, d.entity, last) for d in fleet[:n_checked]]
    checked += [(f"{k}-sub", "ENERGY_LOAD", "SITE_SUB_0", T0)
                for k in m.PAPER_MODELS]
    for name, sig, ent, at in checked:
        dep = c.deployments.get(name)
        cls = c.registry.get(dep.package, dep.version)
        mv = c.versions.get(name, at=at)
        fc = [f for f in c.predictions.history(name) if f.created_at == at]
        inst = cls(context=c.graph.context(sig, ent), task="score",
                   model_id=name, model_version=mv.version,
                   user_params={**dep.user_params, "now": at}, system=c)
        times, vals, lo, hi = inst.score(mv.params)
        np.testing.assert_array_equal(times, fc[0].times)
        for got, want in ((fc[0].values, vals), (fc[0].lower, lo),
                          (fc[0].upper, hi)):
            np.testing.assert_allclose(got, want, **FC_TOL)
            key = cls.KIND
            worst[key] = max(worst.get(key, 0.0),
                             float(np.max(np.abs(got - want))))
    print(f"flow check: fleet forecasts and bands equal the per-instance "
          f"score() path (max |diff| by kind "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }; "
          f"rtol 2e-3, atol 1e-3)")
    xform = c.predictions.history("xform-sub")
    check(len(xform) == 1 and xform[0].values.size > 0
          and bool((xform[0].values >= 0).all()),
          "transform model: no 15-minute energy series")

    # ---- detection: fleet_detect against per-sensor detect, bitwise ----
    t_det = minutely[-1]["now"]
    n_rec = 0
    for d in fleet[:n_checked]:
        name = f"d-{d.entity}"
        stored = [r for r in c.detections.history(name)
                  if r.scheduled_at == t_det]
        inst = BandAnomalyDetector(
            context=c.graph.context(d.signal, d.entity), task="detect",
            model_id=name, model_version=None,
            user_params={"now": t_det}, system=c)
        single = inst.detect(c.predictions.latest(d.signal, d.entity,
                                                  at=t_det))
        check(len(stored) == 1 and vars(stored[0]) == vars(single),
              f"{name}: fleet record {stored} != per-sensor {single}")
        n_rec += 1
    spiked = c.detections.history(f"d-{fleet[0].entity}")[-1]
    check(spiked.score > 1.0 and spiked.n_anomalies >= 1,
          f"the spiked sensor scored {spiked.score}")
    det = c.stats()["detection"]
    check(det["records"] == n_minutes * n_prosumers,
          f"{det['records']} detection records")
    print(f"detect check: {det['records']} records over {n_minutes} "
          f"minutely ticks; {n_rec} sensors' fleet_detect records bitwise "
          f"equal to per-sensor detect; the spiked sensor scored "
          f"{spiked.score:.3f} ({spiked.n_anomalies} anomalies)")
    print(f"flow cut: none ({n_prosumers} prosumers, hidden {hidden}, "
          f"epochs {n_epochs}, {n_ticks} hourly + {n_minutes} minutely "
          f"ticks)")
    names = [d.name for d in fleet + built["lr_fleet"]] + [
        f"{k}-sub" for k in m.PAPER_MODELS]
    return {"modes": tick_modes(ticks), "launches": launches,
            "mape_median": med, "forecasts": flow_forecasts(c, names)}


def _serverless_counts(c) -> dict:
    """The serverless monitor's lifetime counters (zeros before the
    system's first serverless tick)."""
    sv = c.stats().get("serverless", {})
    return {k: sv.get(k, 0) for k in ("invocations", "cold_starts",
                                      "warm_starts", "speculative")}


JOURNAL_KEYS = ("records", "segments", "auto_flushes", "snapshots",
                "bytes_written")


def tear_last_segment(storage) -> str:
    """Cut the newest WAL segment of ``storage`` to its first half, as a
    crash in the middle of its write leaves it (``CrashingStorage``'s torn
    put); checks that the cut fell inside a frame. Returns a description."""
    from repro_torch.durability.wal import decode_records, split_frames
    key = storage.list("wal/")[-1]
    data = storage.get(key)
    frames = split_frames(data)
    torn = data[:len(data) // 2]
    kept, _valid, clean = decode_records(torn)
    check(not clean and len(kept) < len(frames),
          f"tearing {key} at {len(torn)} B did not fall inside a frame")
    storage.put(key, torn)
    return (f"{key} torn at {len(torn)} of {len(data)} B: {len(kept)} of "
            f"{len(frames)} records left")


def _compare(got: dict, want: dict, names, tol: bool) -> tuple:
    """Max |diff| of the named deployments' forecasts and bands (and
    whether all are bitwise equal); with ``tol`` each is held to
    FLEET_RTOL/ATOL."""
    import numpy as np
    worst, bitwise = 0.0, True
    for n in names:
        g, w = got[n], want[n]
        check([x[0] for x in g] == [x[0] for x in w],
              f"{n}: forecasts at {[x[0] for x in g]} != "
              f"{[x[0] for x in w]}")
        for fg, fw in zip(g, w):
            for a, b in zip(fg[1:], fw[1:]):
                if a is None and b is None:
                    continue
                check(a is not None and b is not None
                      and bool(np.isfinite(a).all()),
                      f"{n}: a band or a forecast is missing or not finite")
                if tol:
                    np.testing.assert_allclose(a, b, **FC_TOL,
                                               err_msg=f"{n} at {fg[0]}")
                worst = max(worst, float(np.max(np.abs(a - b))))
                bitwise &= a.tobytes() == b.tobytes()
    return worst, bitwise


def journal_breakdown(c, spans, name: str) -> None:
    """Where the train tick's journal time went: the largest bins (their
    versions' appends run inside them), the flush and fsync spans, and
    the codec alone on one of ``name``'s versions (the best of 3 runs:
    encode = the D2H copy, base64, JSON and crc32; decode the reverse,
    to numpy)."""
    from repro_torch.durability.wal import decode_records, encode_record
    bins = sorted((sp.duration, (sp.args or {}).get("jobs"))
                  for sp in spans if sp.name == "exec.bin")[::-1][:4]
    print("serverless tick 1 largest bins (exec.bin span, s): " + ", ".join(
        f"{jobs} jobs {secs:.3f}" for secs, jobs in bins))
    for span in ("journal.flush", "journal.fsync"):
        d = [sp.duration for sp in spans if sp.name == span]
        print(f"serverless tick 1 {span}: {len(d)} spans, {sum(d):.3f} s "
              f"in all, largest {max(d, default=0.0):.4f} s")
    mv = c.versions.get(name)
    rec = {"model_id": mv.model_id, "trained_at": mv.trained_at,
           "params": mv.params, "metadata": mv.metadata}
    enc = dec = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        frame = encode_record("mv", rec)
        enc = min(enc, time.perf_counter() - t)
        t = time.perf_counter()
        decode_records(frame)
        dec = min(dec, time.perf_counter() - t)
    print(f"codec: one ANN version's mv record {len(frame)} B: encode "
          f"{enc * 1e3:.1f} ms ({len(frame) / enc / 1e6:.0f} MB/s), decode "
          f"{dec * 1e3:.1f} ms ({len(frame) / dec / 1e6:.0f} MB/s)")


def durable_flow(device: str, ref: dict, wal_dir: str, *, n_prosumers: int,
                 hidden: int, sub_width: int, epochs, n_ticks: int,
                 n_minutes: int, seed: int) -> dict:
    """Phase A: the forecast flow of ``forecast_flow`` on a durable system
    (``Castor.open(wal_dir)``: a ``FilesystemStorage`` with fsync), every
    tick through ``tick(executor="serverless")`` (the inline backend: 4
    warm workers sharing the system and its card). Prints each tick's
    wall, its ``journal.commit`` span, what the journal wrote and what the
    invoker did; holds the closed-form forecasts to ``ref`` (the fleet
    executor's run of the same flow) and the fits to the flow's sanity
    bound. After tick 2 it copies the log and tears its last segment (what
    phase B recovers from); after the hourly ticks it snapshots the stores
    (what B must reach)."""
    import numpy as np
    import torch
    from repro_torch.durability.chaos import clone_to_memory
    from repro_torch.kernels.fleet_mlp import ops
    from repro_torch.testing import snapshot_stores
    cuda = device != "cpu"
    m = flow_modules()
    t = time.perf_counter()
    c = m.Castor.open(wal_dir, device=device)
    built = build_flow(c, m, n_prosumers=n_prosumers, hidden=hidden,
                       sub_width=sub_width, epochs=epochs, seed=seed)
    c.journal.commit()
    c.journal.barrier()
    js = c.journal.stats()
    print(f"durable setup: Castor.open({device!r}) over a FilesystemStorage "
          f"(fsync on); the flow's site journaled in {js['records']} "
          f"records, {js['segments']} segments ({js['auto_flushes']} "
          f"auto-flushes), {js['bytes_written']} B, "
          f"{time.perf_counter() - t:.1f} s")
    fleet = built["fleet"]
    n_deps = 2 * n_prosumers + 4
    hourly = [T0 + k * HOUR for k in range(n_ticks)]
    times = hourly + [hourly[-1] + MINUTE * (j + 1) for j in range(n_minutes)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torn = ref_snapshot = clone = None
    walls = []
    for k, now in enumerate(times):
        if k == n_ticks:
            ref_snapshot = snapshot_stores(c)
            live_feed(c, m, fleet, hourly[-1], n_minutes, seed)
        c.tracer.clear()
        j0, s0, l0 = c.journal.stats(), _serverless_counts(c), \
            ops.invocation_count()
        t = time.perf_counter()
        results = c.tick(now, executor="serverless")
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        t = time.perf_counter()
        c.journal.barrier()            # the pipelined segment write lands
        drain = time.perf_counter() - t
        j1, s1 = c.journal.stats(), _serverless_counts(c)
        spans = c.tracer.spans()
        commit = sum(sp.duration for sp in spans
                     if sp.name == "journal.commit")
        fsync = [sp.duration for sp in spans if sp.name == "journal.fsync"]
        errors = [r.error for r in results if not r.ok]
        check(not errors, f"serverless tick {k + 1}: {len(errors)} failed "
                          f"jobs, first: {errors[:1]}")
        want = (2 * (n_deps + 1) if k == 0 else n_deps if k < n_ticks
                else n_prosumers)
        check(len(results) == want,
              f"serverless tick {k + 1}: {len(results)} jobs, not {want}")
        walls.append(secs)
        print(f"serverless tick {k + 1} (T0 + {now - T0:.0f} s): {secs:.3f} "
              f"s wall, jobs {len(results)}/{len(results)} ok; "
              f"journal.commit span {commit:.3f} s, write drained "
              f"{drain:.3f} s after the tick; journal +" + ", +".join(
                  f"{j1[key] - j0[key]} {key}" for key in JOURNAL_KEYS)
              + f", fsync spans {len(fsync)} ({sum(fsync):.3f} s); "
              f"invocations +{s1['invocations'] - s0['invocations']} (cold "
              f"+{s1['cold_starts'] - s0['cold_starts']}, warm "
              f"+{s1['warm_starts'] - s0['warm_starts']}, speculative "
              f"+{s1['speculative'] - s0['speculative']}); fleet_mlp "
              f"launches +{ops.invocation_count() - l0}")
        if k == 0:
            journal_breakdown(c, spans, fleet[0].name)
        if k == 1:                     # after tick 2's commit: the "crash"
            clone = clone_to_memory(c.journal.storage)
            torn = tear_last_segment(clone)
    launches = counts()["fleet_mlp"]
    peak = torch.cuda.max_memory_allocated() if cuda else None
    check(launches >= HORIZON * 2 * n_ticks and launches % HORIZON == 0,
          f"{launches} fleet_mlp launches over {n_ticks} hourly ticks")
    js = c.journal.stats()
    sv = c.stats()["serverless"]
    print(f"durable flow: journal {js['records']} records, "
          f"{js['segments']} segments ({js['auto_flushes']} auto-flushes), "
          f"{js['snapshots']} snapshots, {js['bytes_written']} B written; "
          f"{sv['invocations']} invocations ({sv['cold_starts']} cold, "
          f"{sv['warm_starts']} warm, {sv['speculative']} speculative, "
          f"{sv['retries']} retries), per worker {sv['per_worker']}; "
          f"fleet_mlp launches {launches}"
          + (f"; peak device memory {peak} B" if cuda else ""))

    # ---- against the fleet executor's run of the same flow ----
    names = list(ref["forecasts"])
    got = flow_forecasts(c, names)
    exact = [n for n in names if n.startswith("fleet-lr")
             or n in ("LR-sub", "GAM-sub")]
    worst, bitwise = _compare(got, ref["forecasts"], exact, tol=True)
    print(f"durable check: LR fleet and substation LR/GAM forecasts and "
          f"bands equal the fleet executor's (max |diff| {worst:.3e}, "
          f"bitwise {bitwise}; rtol 2e-3, atol 1e-3)")
    fits = [n for n in names if n not in exact]
    worst, bitwise = _compare(got, ref["forecasts"], fits, tol=False)
    mapes = fleet_train_mape(c, [d.name for d in fleet], T0)
    subs = {k: float(fleet_train_mape(c, [f"{k}-sub"], T0)[0])
            for k in ("ANN", "LSTM")}
    med = float(np.median(mapes))
    print(f"durable check: ANN fleet one-step training MAPE median "
          f"{med:.2f} % (bound 30 %); substation ANN {subs['ANN']:.2f} %, "
          f"LSTM {subs['LSTM']:.2f} %; the ANN and LSTM forecasts against "
          f"the fleet executor's: max |diff| {worst:.3e}, bitwise {bitwise}")
    check(med < 30.0 and bool(np.isfinite([*mapes, *subs.values()]).all()),
          f"training MAPE median {med}, substation {subs}")
    det = c.stats()["detection"]
    check(det["records"] == n_minutes * n_prosumers,
          f"{det['records']} detection records")
    c.close()
    return {"walls": walls, "launches": launches, "clone": clone,
            "torn": torn, "ref_snapshot": ref_snapshot, "hourly": hourly,
            "journal": js, "peak": peak}


def recover_flow(device: str, storage, torn: str, ref_snapshot,
                 hourly) -> dict:
    """Phase B: ``Castor.open`` of the copy of phase A's log taken after
    tick 2 and torn mid-frame, the flow's packages published again, the
    hourly ticks driven again: the stores must equal the uninterrupted
    run's after its hourly ticks, bitwise."""
    import torch
    from repro_torch.testing import assert_stores_bitwise_equal
    m = flow_modules()
    nbytes = sum(len(storage.get(k)) for k in storage.list())
    print(f"recovery: {torn}")
    t = time.perf_counter()
    r = m.Castor.open(storage=storage, device=device)
    secs = time.perf_counter() - t
    st = r._recovery_stats
    print(f"recovery: Castor.open({device!r}) {secs:.3f} s, {nbytes} B "
          f"replayed ({st['records']} records: snapshot {st['snapshot']}, "
          f"{st['segments_replayed']} segments, {st['torn_segments']} torn)")
    check(st["torn_segments"] == 1, f"recovery stats {st}")
    publish_flow(r, m)
    reset_counts()
    for now in hourly:
        t = time.perf_counter()
        res = r.tick(now, executor="serverless")
        if device != "cpu":
            torch.cuda.synchronize()
        errors = [x.error for x in res if not x.ok]
        check(not errors, f"recovered tick at T0 + {now - T0:.0f} s: "
                          f"{errors[:1]}")
        print(f"recovered tick (T0 + {now - T0:.0f} s): {len(res)} jobs ok "
              f"in {time.perf_counter() - t:.3f} s")
    launches = counts()["fleet_mlp"]
    assert_stores_bitwise_equal(ref_snapshot, r, context="recovered flow")
    last = sum(1 for fcs in ref_snapshot["forecasts"].values()
               for fc in fcs if fc[0] == hourly[-1])
    print(f"recovery check: every version, forecast and band bitwise equal "
          f"to the uninterrupted run's ({last} forecasts of the last hourly "
          f"tick among them); fleet_mlp launches {launches}")
    r.close()
    return {"seconds": secs, "bytes": nbytes, "launches": launches}


def process_flow(device: str, *, n_prosumers: int, hidden: int,
                 sub_width: int, epochs, seed: int, n_workers: int = 2,
                 n_ticks: int = 2) -> dict:
    """Phase C: the flow's first ``n_ticks`` ticks through a
    ``ServerlessExecutor`` over a ``ProcessBackend``: ``n_workers`` spawned
    workers, each building the same seeded flow (``flow_system``) on
    ``device``, payloads and results through a shared filesystem bucket.
    The workers' forecasts must equal an in-process inline run's; the
    versions they ship back must land on the parent's device and score
    there through ``fleet_mlp``."""
    import functools
    import numpy as np
    import torch
    from repro_torch.forecast import ANNForecaster
    from repro_torch.serverless import ProcessBackend, ServerlessExecutor
    factory = functools.partial(flow_system, n_prosumers, hidden, sub_width,
                                epochs, seed, device)
    print(f"cut: spawned-worker flow at {n_prosumers} prosumers (the flow's "
          f"instance count cut for the smoke's time; widths full: ANN "
          f"{hidden}, substation ANN/LSTM {sub_width}; epochs "
          f"{'DEFAULTS' if epochs is None else epochs}), {n_ticks} ticks")
    parent = factory()
    names = [d.name for d in parent.deployments.all()]
    times = [T0 + k * HOUR for k in range(n_ticks)]
    ex = ServerlessExecutor(parent, backend=ProcessBackend(
        factory, n_workers=n_workers, spawn_timeout_s=600.0,
        invoke_timeout_s=1200.0), speculative=False)
    mark = parent.tracer.mark()
    try:
        for now in times:
            t = time.perf_counter()
            res = ex.run(parent.scheduler.poll(now))
            errors = [r.error for r in res if not r.ok]
            check(bool(res) and not errors,
                  f"process tick at T0 + {now - T0:.0f} s: {len(errors)} "
                  f"failed, {errors[:1]}")
            print(f"process tick (T0 + {now - T0:.0f} s): {len(res)} jobs ok "
                  f"in {time.perf_counter() - t:.3f} s")
        stats = ex.stats()
        records = list(ex.monitor.records)
        spans = [sp for sp in parent.tracer.export_since(mark)
                 if sp["name"] == "worker.execute"]
    finally:
        ex.close()
    for rec in records:
        print(f"invocation {rec['invocation_id']} on {rec['worker']}: "
              f"{rec['jobs']} jobs in {rec['bins']} bins, "
              f"{'cold' if rec['cold'] else 'warm'}, queue "
              f"{rec['queue_s']:.3f} s (a cold one includes the spawn), "
              f"exec {rec['exec_s']:.3f} s")
    for w in sorted({rec["worker"] for rec in records}):
        cold = [rec["queue_s"] for rec in records
                if rec["worker"] == w and rec["cold"]]
        print(f"cold start {w}: {cold[0]:.3f} s from the invocation's "
              f"enqueue to the spawned worker's pickup")
    st = stats["storage"]
    print(f"bucket: payloads {st['bytes_in']} B in, results {st['bytes_out']}"
          f" B out ({st['puts']} puts, {st['gets']} gets)")
    # the workers ran on the card: their own spans say where, and how many
    # fleet_mlp launches their process made
    children = {}
    for sp in spans:
        a = sp["args"]
        w = children.setdefault(a["worker"], {"devices": set(),
                                              "launches": 0})
        w["devices"].add(a["device"])
        w["launches"] = max(w["launches"], a["fleet_mlp_launches"])
    for w, info in sorted(children.items()):
        print(f"worker {w}: device {sorted(info['devices'])}, fleet_mlp "
              f"launches in its process {info['launches']}")
    child_launches = sum(info["launches"] for info in children.values())
    check(len(children) == n_workers and all(
        info["devices"] == {str(torch.device(device))}
        for info in children.values()), f"worker devices {children}")
    check(child_launches == HORIZON * 2 * n_ticks,
          f"{child_launches} fleet_mlp launches in the workers")

    # ---- the same deployments in process, inline ----
    inline = factory()
    for now in times:
        res = inline.tick(now, executor="serverless")
        check(all(r.ok for r in res), "inline tick failed")
    got, want = flow_forecasts(parent, names), flow_forecasts(inline, names)
    out = {}
    for kind, sel in (("LR", lambda n: n.startswith("fleet-lr")
                       or n in ("LR-sub", "GAM-sub")),
                      ("ANN", lambda n: n.startswith("ann")
                       or n == "ANN-sub"),
                      ("LSTM", lambda n: n == "LSTM-sub")):
        worst, bitwise = _compare(got, want, [n for n in names if sel(n)],
                                  tol=True)
        out[kind] = worst
        print(f"process check: {kind} forecasts and bands from the spawned "
              f"workers against the inline run: max |diff| {worst:.3e}, "
              f"bitwise {bitwise} (rtol 2e-3, atol 1e-3)")

    # ---- shipped-back versions score on the parent's card ----
    fleet = [d for d in parent.deployments.all() if d.package == "ann"]
    now = times[-1]
    mvs = [parent.versions.get(d.name, at=now) for d in fleet]
    check(all(mv.params["params"]["w0"].device.type
              == torch.device(device).type for mv in mvs),
          "a shipped-back version is not on the parent's device")
    insts = [ANNForecaster(context=parent.graph.context(d.signal, d.entity),
                           task="score", model_id=d.name,
                           model_version=mv.version, system=parent,
                           user_params={**d.user_params, "now": now})
             for d, mv in zip(fleet, mvs)]
    reset_counts()
    scored = ANNForecaster.fleet_score(insts, [mv.params for mv in mvs])
    if device != "cpu":
        torch.cuda.synchronize()
    parent_launches = counts()["fleet_mlp"]
    check(parent_launches == HORIZON,
          f"{parent_launches} fleet_mlp launches scoring in the parent")
    worst = 0.0
    for d, (_t, vals, _lo, _hi) in zip(fleet, scored):
        fc = parent.predictions.latest(d.signal, d.entity, at=now)
        np.testing.assert_allclose(vals, fc.values, **FC_TOL)
        worst = max(worst, float(np.max(np.abs(vals - fc.values))))
    print(f"process check: the {len(fleet)} ANN versions shipped back sit on "
          f"the parent's {device}; scored there ({parent_launches} fleet_mlp "
          f"launches) they give the workers' forecasts (max |diff| "
          f"{worst:.3e})")
    return {"child_launches": child_launches, "diffs": out,
            "storage": st, "records": records}


def durable_serverless_flow(device: str, ref: dict, *,
                            n_prosumers: int = 512, hidden: int = 512,
                            sub_width: int = 512, epochs=None,
                            n_ticks: int = 3, n_minutes: int = 5,
                            seed: int = 11,
                            process_prosumers: int = 64) -> dict:
    """Durability and the serverless executor on the forecast flow: A (a
    durable system, inline serverless ticks, the journal at full width),
    B (crash after tick 2, tear, recover, catch up: bitwise), C (spawned
    workers on ``device``). ``ref`` is ``forecast_flow``'s result for the
    same flow."""
    import tempfile
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="castor-wal-") as wal_dir:
        a = durable_flow(device, ref, wal_dir, n_prosumers=n_prosumers,
                         hidden=hidden, sub_width=sub_width, epochs=epochs,
                         n_ticks=n_ticks, n_minutes=n_minutes, seed=seed)
    b = recover_flow(device, a.pop("clone"), a.pop("torn"),
                     a.pop("ref_snapshot"), a["hourly"])
    c = process_flow(device, n_prosumers=process_prosumers, hidden=hidden,
                     sub_width=sub_width, epochs=epochs, seed=seed)
    print(f"durable serverless flow: {time.perf_counter() - t:.1f} s in all")
    return {"durable": a, "recovery": b, "process": c}


def train_parity(device: str, *, seed: int = 5) -> dict:
    """Card against CPU, per kind: a small bin (3 prosumers at the JAX
    package's test sizes) trained on ``device`` and on the CPU from the
    same initial weights (ANN and LSTM draw theirs on the CPU, then move
    them). Parameters must agree at rtol 5e-2 / atol 5e-3, forecasts and
    bands at rtol 2e-3 / atol 1e-3. Returns the worst |diff| per kind."""
    import numpy as np
    from repro_torch.forecast import PAPER_MODELS, ann, lstm, version_to_numpy
    m = flow_modules()
    now = 40 * DAY
    systems = {}
    for dev in dict.fromkeys((device, "cpu")):
        c = m.Castor(device=dev)
        m.build_site(c, m.SiteSpec("P", n_prosumers=3, n_feeders=1,
                                   n_substations=1, seed=seed),
                     t0=0.0, t1=now + 2 * DAY)
        systems[dev] = c

    def on_cpu(init):
        def draw(*args):
            *rest, dev = args
            return {k: v.to(dev) for k, v in init(*rest, "cpu").items()}
        return draw

    originals = (ann._init_fleet, lstm._init_fleet)
    ann._init_fleet, lstm._init_fleet = map(on_cpu, originals)
    worst = {}
    try:
        for kind, cls in PAPER_MODELS.items():
            out = {}
            for dev, c in systems.items():
                insts = [cls(context=c.graph.context("ENERGY_LOAD",
                                                     f"P_PRO_0_{i}"),
                             task="train", model_id=f"p-{i}",
                             model_version=None, system=c,
                             user_params={"train_window_days": 14,
                                          "now": now, **PARITY_HP[kind]})
                         for i in range(3)]
                mos = cls.fleet_train(insts)
                out[dev] = ([version_to_numpy(mo) for mo in mos],
                            cls.fleet_score(insts, mos))
            (got, got_fc), (want, want_fc) = out[device], out["cpu"]
            p_err = fc_err = 0.0
            for g, w in zip(got, want):
                for k, wv in w["params"].items():
                    np.testing.assert_allclose(g["params"][k], wv,
                                               err_msg=f"{kind} {k}",
                                               **PARAM_TOL)
                    p_err = max(p_err, float(np.max(np.abs(
                        np.asarray(g["params"][k], np.float64) - wv))))
                np.testing.assert_allclose(g["resid_q"], w["resid_q"],
                                           **FC_TOL)
            for g, w in zip(got_fc, want_fc):
                np.testing.assert_array_equal(g[0], w[0])
                for a, b in zip(g[1:], w[1:]):
                    np.testing.assert_allclose(a, b, **FC_TOL)
                    fc_err = max(fc_err, float(np.max(np.abs(a - b))))
            worst[kind] = (p_err, fc_err)
            print(f"train parity: {kind} on {device} against cpu, same "
                  f"initial weights: params max |diff| {p_err:.3e} (rtol "
                  f"5e-2, atol 5e-3), forecasts and bands {fc_err:.3e} "
                  f"(rtol 2e-3, atol 1e-3) ok")
    finally:
        ann._init_fleet, lstm._init_fleet = originals
    return worst


def _kernel_ops() -> dict:
    """Each kernel's public op module, by name (each holds its count)."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fleet_mlp import ops as fleet
    from repro_torch.kernels.mamba2_scan import ops as ssd
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    return dict(zip(KERNEL_NAMES, (fleet, fa, dec, ssd, wkv)))


def reset_counts() -> None:
    """Every kernel's launch count to 0 (before each path)."""
    for ops in _kernel_ops().values():
        ops.reset_invocation_count()


def counts() -> dict:
    """Every kernel's launch count, by name (``COUNT_NAMES``)."""
    ops = _kernel_ops()
    n = {name: mod.invocation_count() for name, mod in ops.items()}
    for name in BACKWARD_NAMES:
        n[f"{name}_backward"] = ops[name].backward_invocation_count()
    return n


def _rel_err(got, want) -> float:
    """max |got - want| / (1 + |want|), the kernels' error metric."""
    want = want.float()
    return float(((got.float() - want).abs() / (1 + want.abs())).max())


def _agree(label, got, want, dtype, tol=ATTN_TOL) -> dict:
    """Error of ``got`` against ``want``; fails past ``tol[dtype]``."""
    import torch
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: kernel gave {tuple(got.shape)} {got.dtype}")
    diff = (got.float() - want.float()).abs()
    rel = _rel_err(got, want)
    ok = rel <= tol[dtype] and bool(torch.isfinite(got.float()).all())
    print(f"{label} {dtype}: rel_err={rel:.3e} max_abs_err="
          f"{float(diff.max()):.3e} tol={tol[dtype]:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label} disagrees with its plain version: {rel:.3e} > "
              f"{tol[dtype]:.0e}")
    return {"max_abs_err": float(diff.max()), "rel_err": rel}


def _bound(flops: int, nbytes: int, flop_per_s: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_bound(q, k, causal: bool) -> dict:
    """q, k, v read once and the output written once over HBM, against the
    multiply-adds of the visible (query, key) pairs (2 D for q.k, 2 D for
    p.v) over the bf16 tensor-core rate."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    off = Skv - Sq
    pairs = sum(min(Skv, t + off + 1) for t in range(Sq)) if causal \
        else Sq * Skv
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    return _bound(B * H * pairs * 4 * D, nbytes, BF16_FLOP_PER_S)


def decode_bound(q, k_cache, lengths) -> dict:
    """q read and the output written once, plus the VALID cache entries of
    k and v (the kernel skips the rest), against 4 D operations per valid
    entry and query head over the bf16 tensor-core rate."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    valid = int(lengths.clamp(max=k_cache.shape[1]).sum())
    nbytes = (2 * q.numel() + 2 * valid * KV * D) * q.element_size() \
        + lengths.numel() * lengths.element_size()
    return _bound(valid * H * 4 * D, nbytes, BF16_FLOP_PER_S)


def _timed(record: dict, sets: list, kernel, plain, library,
           iters: int) -> None:
    """Times of ``kernel``, ``plain`` and ``library`` (None where no single
    PyTorch call computes the function), each called on the input sets in
    turn: eager in turns, plain, kernel, library, kernel, plain (``ms``,
    ``plain_ms``, ``library_ms``); then the kernel's and the library's
    calls replayed from a CUDA graph (``graph_ms``, ``library_graph_ms``)."""
    plain_ms = [_time_ms(plain, sets, max(1, iters // 4))]
    kern_ms = [_time_ms(kernel, sets, iters)]
    lib_ms = None if library is None else _time_ms(library, sets, iters)
    kern_ms.append(_time_ms(kernel, sets, iters))
    plain_ms.append(_time_ms(plain, sets, max(1, iters // 4)))
    record.update(
        ms=sum(kern_ms) / 2, plain_ms=sum(plain_ms) / 2, library_ms=lib_ms,
        graph_ms=_time_ms(kernel, sets, iters, graph=True),
        library_graph_ms=None if library is None
        else _time_ms(library, sets, iters, graph=True))


def _times(rec: dict, library: str) -> str:
    """The timing half of a kernel phase's print line."""
    lib = f"{library} {rec['library_ms']:.4f} ms (graph replay " \
          f"{rec['library_graph_ms']:.4f})" if rec["library_ms"] is not None \
        else f"library: none ({library})"
    return (f"{rec['ms']:.4f} ms/call eager, {rec['graph_ms']:.4f} ms by "
            f"CUDA graph replay, inputs cold in L2; bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({rec['bytes']} "
            f"bytes, {rec['flops']} flop); plain version "
            f"{rec['plain_ms']:.4f} ms; {lib}")


def flash_phase(device: str, cases=FLASH_CASES, *, time_it: bool) -> dict:
    """``flash_attention`` through its public op against the plain version
    for every case; returns the path case's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_reference
    record = None
    for seed, (label, B, Sq, Skv, H, KV, D, dtype, causal) in \
            enumerate(cases):
        g = torch.Generator(device=device).manual_seed(100 + seed)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(B, s, n, D, generator=g, device=device).to(dt)
                   for s, n in ((Sq, H), (Skv, KV), (Skv, KV)))
        got = flash_attention(q, k, v, causal=causal)
        want = attention_reference(q, k, v, causal=causal)
        rec = _agree(f"flash_attention {label:7s} B={B} Sq={Sq} Skv={Skv} "
                     f"H={H} KV={KV} D={D} causal={causal}", got, want, dtype)
        if label not in TIMED_LABELS:
            continue
        rec.update(flash_bound(q, k, causal))
        if time_it:     # each set: q, k, v and SDPA's (B, H, S, D) views
            sets = [(*s, *(t.transpose(1, 2) for t in s))
                    for s in _input_sets((q, k, v), rec["bytes"])]
            _timed(rec, sets,
                   lambda q, k, v, *_: flash_attention(q, k, v,
                                                       causal=causal),
                   lambda q, k, v, *_: attention_reference(q, k, v,
                                                           causal=causal),
                   lambda *s: F.scaled_dot_product_attention(
                       *s[3:], is_causal=causal, enable_gqa=True), 20)
            print(f"flash_attention {label} time: " + _times(
                rec, "scaled_dot_product_attention"))
        if label == FLASH_PATH_CASE[0]:
            record = rec
    return record


def decode_phase(device: str, cases=DECODE_CASES, *, time_it: bool) -> dict:
    """``decode_attention`` through its public op against the plain version
    for every case; returns the engine case's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    record = None
    for seed, (label, B, S, H, KV, D, dtype) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(200 + seed)
        dt = getattr(torch, dtype)
        q = torch.randn(B, H, D, generator=g, device=device).to(dt)
        kc, vc = (torch.randn(B, S, KV, D, generator=g, device=device).to(dt)
                  for _ in range(2))
        lengths = torch.randint(1, S + 1, (B,), generator=g, device=device,
                                dtype=torch.int32)
        got = decode_attention(q, kc, vc, lengths)
        want = decode_attention_reference(q, kc, vc, lengths)
        rec = _agree(f"decode_attention {label:5s} B={B} S={S} H={H} KV={KV} "
                     f"D={D} lengths={lengths.tolist() if B <= 8 else '...'}",
                     got, want, dtype)
        if label not in TIMED_LABELS:
            continue
        rec.update(decode_bound(q, kc, lengths))
        if time_it:     # each set: q, caches, lengths and SDPA's views
            mask = (torch.arange(S, device=device)[None, :]
                    < lengths[:, None])[:, None, None, :]
            sets = [(q, kc, vc, n, q[:, :, None], kc.transpose(1, 2),
                     vc.transpose(1, 2)) for q, kc, vc, n in
                    _input_sets((q, kc, vc, lengths), rec["bytes"])]
            _timed(rec, sets,
                   lambda *s: decode_attention(*s[:4]),
                   lambda *s: decode_attention_reference(*s[:4]),
                   lambda *s: F.scaled_dot_product_attention(
                       *s[4:], attn_mask=mask, enable_gqa=True), 50)
            print(f"decode_attention {label} time (partial + combine "
                  "launch): " + _times(rec, "scaled_dot_product_attention"))
        if label == DECODE_PATH_CASE[0]:
            record = rec
    return record


def ssd_bound(x, dt, Bm, D, chunk: int) -> dict:
    """x, dt, A, B, C, D read once, y and the final f32 state written once
    over HBM, against the chunked form's products per (batch row, chunk,
    head): C B^T and (C B^T o L)(dt x), 2 c^2 (N + P), and the chunk's
    state contribution and the state's read-out, 4 c P N; over the bf16
    tensor-core rate."""
    B, S, H, P = x.shape
    N = Bm.shape[3]
    c = min(chunk, S)
    io = (x, dt, Bm, Bm, D, D)                   # B and C, A and D alike
    nbytes = sum(t.numel() * t.element_size() for t in io) \
        + x.numel() * x.element_size() + B * H * P * N * 4
    flops = B * (S // c) * H * (2 * c * c * (N + P) + 4 * c * P * N)
    return _bound(flops, nbytes, BF16_FLOP_PER_S)


def wkv_bound(r, w, u, chunk: int) -> dict:
    """r, k, v (r's type), w and u read once, y and the final f32 state
    written once over HBM, against the chunked form's multiply-adds per
    (batch row, head, chunk): the decayed scores r k dec, 3 c^2 K, their
    product with v, 2 c^2 V, and the state's read-out and update,
    4 c K V; over the bf16 tensor-core rate."""
    B, S, H, K = r.shape
    V = K
    c = min(chunk, S)
    nbytes = 4 * r.numel() * r.element_size() \
        + (w.numel() + u.numel() + B * H * K * V) * 4
    flops = B * H * (S // c) * (3 * c * c * K + 2 * c * c * V + 4 * c * K * V)
    return _bound(flops, nbytes, BF16_FLOP_PER_S)


def _uniform(g, lo, hi, shape, device):
    import torch
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _decays(g, wmin, shape, device):
    """w ~ U(wmin, 0.999); log-uniform on [wmin, 0.999] below 1e-6."""
    import math
    import torch
    if wmin >= 1e-6:
        return _uniform(g, wmin, 0.999, shape, device)
    lo, hi = math.log(wmin), math.log(0.999)
    return torch.exp(_uniform(g, lo, hi, shape, device))


def _f32_route_times(record: dict, inputs: tuple, op) -> None:
    """The f32 route's eager and graph-replay times on copies of ``inputs``
    rotated cold in L2, as the bf16 route is timed (``f32_ms``,
    ``f32_graph_ms``)."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    sets = _input_sets(inputs, nbytes)
    record.update(f32_ms=_time_ms(op, sets, 20),
                  f32_graph_ms=_time_ms(op, sets, 20, graph=True))


def ssd_phase(device: str, cases=SSD_CASES, *, time_it: bool) -> dict:
    """``ssd_scan`` through its public op against the plain chunked version
    for every case, output and final state; returns the path case's
    record. Inputs as tests/test_kernels.py draws them."""
    import torch
    from repro_torch.kernels.mamba2_scan.ops import ssd_scan
    from repro_torch.kernels.mamba2_scan.ref import ssd_chunked, ssd_sequential
    record = None
    for seed, (label, B, S, H, P, N, dtype, chunk, *dt_range) in \
            enumerate(cases):
        dt_range = dt_range[0] if dt_range else (1e-3, 0.1)
        g = torch.Generator(device=device).manual_seed(300 + seed)
        dt_ = getattr(torch, dtype)
        x = torch.randn(B, S, H, P, generator=g, device=device).to(dt_)
        dt = _uniform(g, *dt_range, (B, S, H), device)
        A = -_uniform(g, 0.5, 2.0, (H,), device)
        Bm, Cm = (torch.randn(B, S, 1, N, generator=g, device=device).to(dt_)
                  for _ in range(2))
        D = torch.randn(H, generator=g, device=device)
        y, st = ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
        want_y, want_st = ssd_sequential(x, dt, A, Bm, Cm, D) \
            if label.startswith("strong") \
            else ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk)
        name = f"ssd_scan {label:7s} B={B} S={S} H={H} P={P} N={N}"
        rec = _agree(name, y, want_y, dtype, SSD_TOL)
        _agree(name + " state", st, want_st, "float32", SSD_TOL)
        if label != SSD_PATH_CASE[0]:
            continue
        record = {**rec, **ssd_bound(x, dt, Bm, D, chunk)}
        if time_it:
            _timed(record,
                   _input_sets((x, dt, A, Bm, Cm, D), record["bytes"]),
                   lambda *a: ssd_scan(*a, chunk=chunk),
                   lambda *a: ssd_chunked(*a, chunk=chunk), None, 20)
            print("ssd_scan prefill time: " + _times(
                record, "no single PyTorch call computes the scan"))
            # the per-token route (the first design, which f32 still takes)
            # at the same shape, checked and timed on the same card
            f32 = (x.float(), dt, A, Bm.float(), Cm.float(), D)
            y32, st32 = ssd_scan(*f32, chunk=chunk)
            want32 = ssd_chunked(*f32, chunk=chunk)
            _agree(name + " f32 route", y32, want32[0], "float32", SSD_TOL)
            _agree(name + " f32 route state", st32, want32[1], "float32",
                   SSD_TOL)
            _f32_route_times(record, f32, lambda *a: ssd_scan(*a, chunk=chunk))
            print(f"ssd_scan prefill f32 route (per token, CUDA cores): "
                  f"{record['f32_ms']:.4f} ms/call eager, "
                  f"{record['f32_graph_ms']:.4f} ms by CUDA graph replay; "
                  f"the bf16 route is {record['f32_ms'] / record['ms']:.2f}x "
                  f"faster eager")
    return record


def wkv_phase(device: str, cases=WKV_CASES, *, time_it: bool) -> dict:
    """``wkv6_scan`` through its public op against the plain chunked
    version (exact masked decay) for every case, output and final state;
    returns the path case's record. w is f32 in every case, as on the
    path."""
    import torch
    from repro_torch.kernels.rwkv6_scan.ops import wkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked, wkv6_sequential
    record = None
    for seed, (label, B, S, H, K, dtype, wmin, chunk) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(400 + seed)
        dt_ = getattr(torch, dtype)
        r, k, v = (torch.randn(B, S, H, K, generator=g, device=device).to(dt_)
                   for _ in range(3))
        w = _decays(g, wmin, (B, S, H, K), device)
        u = torch.randn(H, K, generator=g, device=device)
        y, st = wkv6_scan(r, k, v, w, u, chunk=chunk)
        want_y, want_st = wkv6_sequential(r, k, v, w, u) \
            if label.startswith("extreme") \
            else wkv6_chunked(r, k, v, w, u, chunk=chunk)
        name = (f"wkv6_scan {label:7s} B={B} S={S} H={H} K={K} "
                f"wmin={wmin}")
        rec = _agree(name, y, want_y, dtype, WKV_TOL)
        _agree(name + " state", st, want_st, "float32", WKV_TOL)
        if label != WKV_PATH_CASE[0]:
            continue
        record = {**rec, **wkv_bound(r, w, u, chunk)}
        if time_it:
            _timed(record,
                   _input_sets((r, k, v, w, u), record["bytes"]),
                   lambda *a: wkv6_scan(*a, chunk=chunk),
                   lambda *a: wkv6_chunked(*a, chunk=chunk), None, 20)
            print("wkv6_scan prefill time: " + _times(
                record, "no single PyTorch call computes the scan"))
            f32 = (r.float(), k.float(), v.float(), w, u)
            y32, st32 = wkv6_scan(*f32, chunk=chunk)
            want32 = wkv6_chunked(*f32, chunk=chunk)
            _agree(name + " f32 route", y32, want32[0], "float32", WKV_TOL)
            _agree(name + " f32 route state", st32, want32[1], "float32",
                   WKV_TOL)
            _f32_route_times(record, f32,
                             lambda *a: wkv6_scan(*a, chunk=chunk))
            print(f"wkv6_scan prefill f32 route (per token, CUDA cores): "
                  f"{record['f32_ms']:.4f} ms/call eager, "
                  f"{record['f32_graph_ms']:.4f} ms by CUDA graph replay; "
                  f"the bf16 route is {record['f32_ms'] / record['ms']:.2f}x "
                  f"faster eager")
    return record


def lm_params(arch: str, device: str, seed: int = 0, layers: int = 0):
    """The config (cut to ``layers`` layers where given) and its
    parameters, drawn on the device from a seeded generator and stored in
    the config's compute dtype."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    t = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, g, dtype=cfg.dtype, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    print(f"lm setup: {cfg.name}, {M.param_count(cfg)} parameters in "
          f"{cfg.dtype}, drawn in {time.perf_counter() - t:.1f} s")
    return cfg, params


def forward_launches(cfg) -> dict:
    """Kernel launches of one ``forward``: one ``flash_attention`` per
    attention block (dense or MoE) and per application of the shared
    block, one scan per recurrent block, nothing else (the MoE blocks'
    routing and expert GEMMs run no kernel of the port's)."""
    per = cfg.num_periods
    n = {name: 0 for name in COUNT_NAMES}
    n["flash_attention"] = per * (cfg.pattern.count("attn")
                                  + cfg.pattern.count("attn_moe")
                                  + int(cfg.shared_attn_every_period))
    n["ssd_scan"] = per * cfg.pattern.count("mamba2")
    n["wkv6_scan"] = per * cfg.pattern.count("rwkv6")
    return n


def train_launches(cfg) -> dict:
    """Kernel launches of one training step with remat: each forward
    kernel twice (the forward and the period's recompute), each backward
    once, nothing else."""
    fwd = forward_launches(cfg)
    n = {name: 2 * fwd[name] for name in COUNT_NAMES}
    for name in BACKWARD_NAMES:
        n[f"{name}_backward"] = fwd[name]
    return n


def _rel_l2(got, want) -> float:
    import torch
    return float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float()))


def _decode_tokens(cfg, params, prompt, device):
    """``decode_step`` fed ``prompt`` (1, n) one token at a time from a
    zeroed state: (the last logits, the state)."""
    import torch
    from repro_torch.arch import model as M
    with torch.no_grad():
        state = M.init_decode_state(cfg, 1, prompt.shape[1], device=device)
        for i in range(prompt.shape[1]):
            logits, state = M.decode_step(cfg, params, state,
                                          {"tokens": prompt[:, i:i + 1]})
    return logits, state


def prefill_phase(device: str, cfg, params, *, batch: int = 4,
                  seq: int = 1024, check_len: int = 128,
                  seed: int = 12) -> dict:
    """``forward(mode="prefill")`` on seeded prompts, then the decode
    cross-check: the last logits and, for the recurrent families, the
    final scan states (``ssd`` / ``wkv`` of every layer); for the MoE
    models the share of expert choices the prefill's capacity dropped and
    the routes of both sides (``moe_decode_check``). Returns the path's
    record."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.arch.params import tree_leaves
    cuda = device != "cpu"
    moe = "attn_moe" in cfg.pattern
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device=device)

    reset_counts()
    t = time.perf_counter()
    with torch.no_grad(), _recorded_routes() as routes:
        logits, state = M.forward(cfg, params, {"tokens": tokens},
                                  mode="prefill")
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = counts()
    print(f"prefill: {cfg.name} {batch} x {seq} tokens in {secs:.3f} s wall "
          f"({batch * seq / secs:.1f} tokens/s), launches " + ", ".join(
              f"{name} {n}" for name, n in launches.items() if n))
    want = forward_launches(cfg)
    check(launches == want,
          f"prefill: kernel launches {launches}, expected {want}")
    check(tuple(logits.shape) == (batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill: logits {tuple(logits.shape)} not finite / wrong shape")
    specs = tree_leaves(M.decode_state_specs(cfg, batch, seq)["caches"])
    for spec, got in zip(specs, tree_leaves(state["caches"]), strict=True):
        check(tuple(got.shape) == spec.shape and got.dtype == spec.dtype,
              f"prefill: cache {tuple(got.shape)} {got.dtype} != "
              f"{spec.shape} {spec.dtype}")
    check(state["lengths"].tolist() == [seq] * batch,
          f"prefill: lengths {state['lengths'].tolist()}")
    del state, logits
    dropped = dropped_share(cfg, routes) if moe else None
    # the same forward again, warm (allocator, cuBLAS and the kernel
    # libraries loaded): the wall that the kernels' speed moves
    t = time.perf_counter()
    with torch.no_grad():
        M.forward(cfg, params, {"tokens": tokens}, mode="prefill")
    if cuda:
        torch.cuda.synchronize()
    warm = time.perf_counter() - t
    print(f"prefill: {cfg.name} warm forward (the same prompts again) in "
          f"{warm:.3f} s wall ({batch * seq / warm:.1f} tokens/s)")

    # the same prompt through both paths: prefill's last logits (and final
    # scan states) against decode_step fed the tokens one at a time
    prompt = tokens[:1, :check_len]
    with torch.no_grad(), _recorded_routes() as pf_routes:
        pf_logits, pf_state = M.forward(cfg, params, {"tokens": prompt},
                                        mode="prefill")
    with _recorded_routes() as dec_routes:
        dec_logits, dstate = _decode_tokens(cfg, params, prompt, device)
    recurrent = [(key, n) for key, leaves in pf_state["caches"].items()
                 for n in leaves if n in ("ssd", "wkv")]
    tol = RECURRENT_DECODE_TOL if recurrent else PREFILL_DECODE_TOL
    rel = _rel_l2(dec_logits, pf_logits)
    rec = {"seconds": secs, "warm_seconds": warm, "launches": launches,
           "rel_l2": rel, "tol": tol}
    if moe:
        rec["dropped"] = dropped
        rec.update(moe_decode_check(cfg, params, prompt, pf_logits,
                                    pf_routes, dec_routes, rel, device))
        return rec
    ok = rel <= tol
    print(f"prefill check: {check_len}-token prompt, prefill vs "
          f"token-by-token decode logits rel L2 {rel:.3e} (tol {tol:.1e}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"prefill and decode disagree: rel L2 {rel:.3e}")
    if recurrent:
        cat = lambda st: torch.cat([st["caches"][key][n].flatten()  # noqa: E731
                                    for key, n in recurrent])
        rec["state_rel_l2"] = _rel_l2(cat(dstate), cat(pf_state))
        ok = rec["state_rel_l2"] <= tol
        names = sorted({n for _, n in recurrent})
        print(f"prefill check: final {'/'.join(names)} states of "
              f"{len(recurrent) * cfg.num_periods} layers, prefill vs decode "
              f"rel L2 {rec['state_rel_l2']:.3e} (tol {tol:.1e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"prefill and decode states disagree: rel L2 "
                  f"{rec['state_rel_l2']:.3e}")
    return rec


@contextlib.contextmanager
def _recorded_routes(pinned=None):
    """Record every MoE router call while the block runs: its expert
    choices ``idx`` (B, S, k) and its router logits (B, S, E), on the
    host. With ``pinned`` (one idx per call, in call order) each call
    routes to those experts instead of its own, weighted by its own gates
    renormalised over them, as ``_router`` weights its own choices."""
    import torch
    from repro_torch.arch import moe
    calls = []
    own = moe._router

    def router(cfg, p, x, **kw):
        w, idx, aux = own(cfg, p, x, **kw)
        logits = x.to(torch.float32) @ p["router"].to(torch.float32)
        if pinned is not None:
            idx = pinned[len(calls)].to(idx.device)
            w = torch.gather(torch.softmax(logits, dim=-1), -1, idx)
            w = w / torch.sum(w, -1, keepdim=True)
        calls.append({"idx": idx.detach().cpu(),
                      "logits": logits.detach().cpu()})
        return w, idx, aux

    moe._router = router
    try:
        yield calls
    finally:
        moe._router = own


def dropped_share(cfg, routes: list, capacity_factor: float = 1.25) -> dict:
    """The share of expert choices that the dispatch's capacity dropped,
    from each MoE layer's recorded routes of one forward (the dispatch's
    own geometry and first-come slots)."""
    import torch
    from repro_torch.arch import moe
    shares, n_drop, n_all = [], 0, 0
    for call in routes:
        B, S, k = call["idx"].shape
        G, Sg, C = moe.dispatch_geometry(cfg, B * S, capacity_factor)
        slot = moe.dispatch_slots(call["idx"].reshape(G, Sg, k),
                                  cfg.num_experts)
        drop = int((slot >= C).sum())
        shares.append(drop / slot.numel())
        n_drop, n_all = n_drop + drop, n_all + slot.numel()
    print(f"prefill routes: {cfg.name} {B} x {S} tokens in {G} groups of "
          f"{Sg}, {C} slots a (group, expert) for {Sg * k} choices over "
          f"{cfg.num_experts} experts: {n_drop} of {n_all} choices dropped "
          f"(share {n_drop / n_all:.4e}; by layer {min(shares):.4e} to "
          f"{max(shares):.4e}) over {len(routes)} MoE layers")
    return {"dropped": n_drop, "choices": n_all, "share": n_drop / n_all,
            "groups": G, "group_tokens": Sg, "capacity": C}


def route_report(label: str, want: dict, got: dict) -> dict:
    """Two runs' routes of the same (token, layer)s: ``want`` and ``got``
    hold ``idx`` (N, k) and router ``logits`` (N, E) in one order. Prints
    how many (token, layer, choice) entries and expert sets differ, the
    smallest and largest margin among the differing entries (|gate of the
    expert ``want`` chose - gate of the one ``got`` chose|, on ``want``'s
    gates) and the router logits' rel L2. Returns them."""
    import torch
    diff = want["idx"] != got["idx"]
    sets = (torch.sort(want["idx"], -1).values
            != torch.sort(got["idx"], -1).values).any(-1)
    gates = torch.softmax(want["logits"].double(), -1)
    margin = (torch.gather(gates, -1, want["idx"])
              - torch.gather(gates, -1, got["idx"])).abs()[diff]
    rep = {"entries": want["idx"].numel(), "differ": int(diff.sum()),
           "sets_differ": int(sets.sum()), "pairs": int(sets.numel()),
           "min_margin": float(margin.min()) if margin.numel() else None,
           "max_margin": float(margin.max()) if margin.numel() else None,
           "logits_rel_l2": _rel_l2(got["logits"], want["logits"]),
           "diff": diff, "margins": margin}
    fmt = lambda x: "-" if x is None else f"{x:.3e}"  # noqa: E731
    print(f"routes: {label}: {rep['differ']} of {rep['entries']} (token, "
          f"layer, choice) entries differ, {rep['sets_differ']} of "
          f"{rep['pairs']} (token, layer) expert sets; gate margin among "
          f"the differing entries smallest {fmt(rep['min_margin'])}, "
          f"largest {fmt(rep['max_margin'])}; router logits rel L2 "
          f"{rep['logits_rel_l2']:.3e}")
    return rep


def _by_layer(calls: list, layers: int) -> dict:
    """Decode's router calls, token-major (each token through every MoE
    layer), as prefill's order: (layers x tokens) rows of idx and
    logits."""
    import torch
    out = {}
    for key in ("idx", "logits"):
        rows = torch.stack([c[key][0, 0] for c in calls])     # (T*L, .)
        out[key] = rows.reshape(-1, layers, rows.shape[-1]).transpose(
            0, 1).reshape(-1, rows.shape[-1])
    return out


def _flat(calls: list) -> dict:
    """Recorded calls' idx and logits as (rows, .) in call order."""
    import torch
    return {key: torch.cat([c[key].reshape(-1, c[key].shape[-1])
                            for c in calls]) for key in ("idx", "logits")}


def moe_decode_check(cfg, params, prompt, pf_logits, pf_routes, dec_routes,
                     free_rel: float, device: str) -> dict:
    """The MoE models' prefill vs decode check on one prompt. Routing is
    discontinuous: where two experts' gates nearly tie, the bf16 rounding
    that differs between prefill and decode (GEMMs of 128 rows against 1,
    flash against decode attention) can pick the other expert, and a
    flipped choice moves its token's MoE output by that choice's weight
    times the difference of two experts' outputs, far past rounding. So
    (1) the free decode's routes are reported against prefill's
    (``route_report``) beside its logits' rel L2, and (2) decode is run
    again with each (token, layer) routed to prefill's experts: its last
    logits and every layer's router logits are then held at
    ``PREFILL_DECODE_TOL``, the rounding check qwen3-1.7b's prefill gets."""
    import torch
    layers, T = len(pf_routes), prompt.shape[1]
    pf = _flat(pf_routes)
    free = route_report(f"{cfg.name} prefill vs token-by-token decode "
                        f"({T} tokens x {layers} MoE layers)",
                        pf, _by_layer(dec_routes, layers))
    # a flip moves its token's state past rounding, and through attention
    # every later token's: split the flips at (layer, token)s with no flip
    # at an earlier layer and an earlier or the same token from the rest
    flip = free.pop("diff").reshape(layers, T, -1)
    margins = free.pop("margins")
    at = flip.any(-1).int()
    up = (torch.cumsum(at, 0) - at).cumsum(1) > 0       # (layers, T)
    first = ~up[..., None].expand_as(flip)[flip]
    free["first_flips"] = int(first.sum())
    free["first_max_margin"] = float(margins[first].max()) \
        if first.any() else None
    fmt = lambda x: "-" if x is None else f"{x:.3e}"  # noqa: E731
    print(f"routes: {cfg.name} flips with no flip upstream (an earlier "
          f"layer of this or an earlier token) {free['first_flips']}, "
          f"largest gate margin {fmt(free['first_max_margin'])}; the other "
          f"{free['differ'] - free['first_flips']} follow a flip upstream, "
          f"largest margin {fmt(float(margins[~first].max()) if (~first).any() else None)}")
    print(f"prefill check: {prompt.shape[1]}-token prompt, prefill vs "
          f"token-by-token decode routed freely: logits rel L2 "
          f"{free_rel:.3e} with {free['sets_differ']} expert sets flipped "
          f"(reported; the held check routes decode as prefill did)")
    # decode's calls are token-major: token i meets layer l at i * L + l
    pinned = [pf_routes[l]["idx"][:, i:i + 1]
              for i in range(prompt.shape[1]) for l in range(layers)]
    with _recorded_routes(pinned) as pin_routes:
        pin_logits, _ = _decode_tokens(cfg, params, prompt, device)
    pin = _by_layer(pin_routes, layers)
    rel = _rel_l2(pin_logits, pf_logits)
    router_rel = _rel_l2(pin["logits"], pf["logits"])
    ok = rel <= PREFILL_DECODE_TOL and router_rel <= PREFILL_DECODE_TOL
    print(f"prefill check: {prompt.shape[1]}-token prompt, prefill vs "
          f"token-by-token decode routed as prefill: logits rel L2 "
          f"{rel:.3e}, router logits rel L2 {router_rel:.3e} over "
          f"{layers} MoE layers (tol {PREFILL_DECODE_TOL:.1e}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"prefill and decode disagree with the same routes: logits "
              f"rel L2 {rel:.3e}, router logits {router_rel:.3e}")
    return {"routes": free, "pinned_rel_l2": rel,
            "router_rel_l2": router_rel}


def serve_phase(device: str, cfg, params, *, slots: int = 8,
                max_seq: int = 2048, n_requests: int = 16,
                prompt_lens=(16, 96), new_tokens: int = 32,
                first_tokens: int = 0, seed: int = 13) -> dict:
    """``ServeEngine`` over seeded requests until idle, stepped as
    ``run_until_idle`` steps it. A request's time to first token runs from
    its arrival to the end of the engine step that emitted the token (the
    engine stamps the step's start, before that step's admission prefill).
    ``first_tokens`` (where nonzero) are the new tokens of request 0: fewer
    than ``new_tokens``, its slot frees while the others decode, and where
    requests outnumber the slots the next one is admitted there (the
    dirty slot's state zeroed beside live rows), which the phase checks.
    Returns the path's record."""
    import numpy as np
    import torch
    from repro_torch.serve import Request, ServeEngine
    cuda = device != "cpu"
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, int(rng.integers(prompt_lens[0],
                                                    prompt_lens[1] + 1)))
                .astype(np.int32),
                max_new_tokens=first_tokens if i == 0 and first_tokens
                else new_tokens)
            for i in range(n_requests)]
    eng = ServeEngine(cfg, params, max_slots=slots, max_seq=max_seq)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        r.arrived_at = t0
        eng.submit(r)
    first = {}
    total = 0
    with torch.no_grad():
        for _ in range(10_000):
            got = eng.step()
            t = time.perf_counter()    # the step read its tokens to the host
            for r in reqs:
                if r.first_token_at is not None and r.rid not in first:
                    first[r.rid] = t
            if got == 0 and not eng.queue:
                break
            total += got
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts()
    done = sum(r.done for r in reqs)
    check(len(first) == n_requests, "serve: a request emitted no token")
    ttft = [first[r.rid] - r.arrived_at for r in reqs]
    rec = {"seconds": secs, "launches": launches, "requests": done,
           "tokens": total, "engine_steps": eng.steps,
           "decode_calls": eng.decode_calls,
           "tokens_per_s": total / secs,
           "step_ms": secs / eng.steps * 1e3,
           "decode_call_ms": secs / eng.decode_calls * 1e3,
           "ttft_median_s": float(np.median(ttft)),
           "ttft_mean_s": float(np.mean(ttft)),
           "ttft_max_s": float(np.max(ttft)),
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "engine": eng}
    print(f"serve: {cfg.name} {done}/{n_requests} requests, {total} tokens out in "
          f"{secs:.3f} s ({rec['tokens_per_s']:.1f} tokens/s); "
          f"{eng.steps} engine steps (mean {rec['step_ms']:.2f} ms), "
          f"{eng.decode_calls} decode calls with admission (mean "
          f"{rec['decode_call_ms']:.2f} ms); time to first token median "
          f"{rec['ttft_median_s']:.3f} s, mean {rec['ttft_mean_s']:.3f} s, "
          f"max {rec['ttft_max_s']:.3f} s over {n_requests} requests; "
          f"decode_attention launches {launches['decode_attention']}")
    if cuda:
        print(f"serve peak device memory: {rec['peak_bytes']} bytes "
              f"(torch.cuda.max_memory_allocated over the run)")
    print(f"serve cut: none ({n_requests} requests, {slots} slots x "
          f"{max_seq} positions)")
    check(done == n_requests, f"serve: {n_requests - done} requests not done")
    want_out = sum(r.max_new_tokens for r in reqs)
    check(total == want_out == eng.tokens_out,
          f"serve: {total} tokens out, {eng.tokens_out} counted, "
          f"{want_out} asked")
    if first_tokens and n_requests > slots:
        # request ``slots`` took request 0's slot while the others decoded
        live = min(r.finished_at for r in reqs[1:slots])
        refill = reqs[slots].first_token_at
        print(f"serve refill: request {slots} admitted into request 0's "
              f"slot {'while' if refill < live else 'after'} the other "
              f"{slots - 1} decoded")
        check(refill < live, "serve: no request was admitted into a freed "
                             "slot while other rows decoded")
    # decode runs one decode_attention per attention application and no
    # other kernel (the recurrences decode through their plain versions)
    per_call = forward_launches(cfg)["flash_attention"]
    want = {name: 0 for name in COUNT_NAMES}
    want["decode_attention"] = per_call * eng.decode_calls
    check(launches == want,
          f"serve: kernel launches {launches} for {eng.decode_calls} decode "
          f"calls x {per_call} attention applications, expected {want}")
    check(all(len(r.tokens) == r.max_new_tokens and
              all(0 <= t < cfg.vocab_size for t in r.tokens) for r in reqs),
          "serve: a request's tokens are out of range or short")
    return rec


def profile_decode(eng, calls: int = 3, top: int = 6) -> dict:
    """``torch.profiler`` over a few engine decode calls with every slot
    advancing (after the served run): the device's kernel time per call and
    the kernels that take most of it. The kernel time over the call's
    unprofiled wall time is the device's busy share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rows = list(range(eng.max_slots))
    toks = np.ones((eng.max_slots, 1), np.int64)
    cuda = eng.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with torch.no_grad():
        eng._decode(toks, rows)
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                eng._decode(toks, rows)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
    kern = sorted(((e.key, e.device_time_total / 1e3 / calls)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda kv: -kv[1])
    dev_ms = sum(ms for _, ms in kern)
    print(f"serve profile: {calls} decode calls, {wall / calls * 1e3:.2f} "
          f"ms/call under the profiler, device kernel time "
          + (f"{dev_ms:.3f} ms/call" if kern else "not measured (the "
             "profiler saw no device activity)"))
    for name, ms in kern[:top]:
        print(f"serve profile: {ms:.4f} ms/call {name[:90]}")
    return {"device_ms_per_call": dev_ms if kern else None,
            "top": kern[:top]}


def _card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True)
    return proc.stdout.strip()


def _ptxas_table(log: str) -> dict:
    """``ptxas -v`` output as {mangled entry function: (registers, spill
    store bytes, static shared memory bytes)}."""
    import re
    table, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            table[name] = (int(m.group(1)), spill,
                           int(smem.group(1)) if smem else 0)
    return table


# the mangled template arguments of each scan's bf16 forward as the path
# takes it: 16-byte loads (kVec), not the backward's state sweep (kStates)
TC_FORWARD_TAG = {"ssd_scan": "ILb1ELb0E", "wkv6_scan": "ILb1ELb0E"}


def _ptxas_hit(table: dict, fn: str) -> tuple:
    """The one ptxas entry whose mangled name holds ``fn``."""
    hits = [v for k, v in table.items() if fn in k]
    check(len(hits) == 1, f"build: {fn} not found once in ptxas output")
    return hits[0]


def scan_routes(name: str, mod, log: str) -> None:
    """Print each route of a scan kernel: the dtype, the kernel function it
    launches, its registers, spills and shared memory (the bf16 route's
    16-byte-load instantiation, which the path shapes take); then the
    backward's per dtype (bf16: the state sweep and the chunked reverse
    sweep, which must hold 2 blocks an SM)."""
    import torch
    table = _ptxas_table(log)
    for dtype, route in mod.ROUTES.items():
        fn = route.split()[0]
        tc = dtype == torch.bfloat16
        regs, spill, smem = _ptxas_hit(
            table, fn + (TC_FORWARD_TAG[name] if tc else "I"))
        mem = (f"{mod.TC_SMEM_BYTES} B dynamic shared memory a block, "
               f"{mod.blocks_per_sm()} blocks an SM") if tc else \
            f"{smem} B static shared memory a block"
        print(f"build: {name} route {str(dtype)[6:]} -> {route}: {regs} "
              f"registers, {spill} B spilled, {mem}")
    launches = {torch.float32: [(f"{name}_bwd_kernelIfE",
                                 mod.BWD_SMEM_BYTES, mod.BWD_THREADS)],
                torch.bfloat16: [
                    (f"{name}_tc_kernelILb1ELb1E", mod.TC_SMEM_BYTES,
                     mod.TC_THREADS),
                    (f"{name}_bwd_tc_kernelILb1E", mod.BWD_TC_SMEM_BYTES,
                     mod.BWD_TC_THREADS)]}
    for dtype, kernels in launches.items():
        for fn, smem, threads in kernels:
            regs, spill, _ = _ptxas_hit(table, fn)
            blocks = min(mod.SM_SMEM_BYTES // (smem + 1024),
                         65536 // (regs * threads))
            print(f"build: {name} backward {str(dtype)[6:]} -> "
                  f"{mod.BACKWARD_ROUTES[dtype]}: {fn}: {regs} registers, "
                  f"{spill} B spilled, {smem} B dynamic shared memory a "
                  f"block, {blocks} blocks an SM")
            if "bwd_tc" in fn:
                check(blocks >= 2, f"build: {fn}: {blocks} blocks an SM")


def backward_routes(log: str) -> None:
    """Print the bf16 backward's kernels as ``ptxas`` built them (at one
    and at two 64-column atoms of D): registers at entry (the consumer
    warpgroups raise theirs with setmaxnreg), spills and shared memory."""
    from repro_torch.kernels.flash_attention import kernel as fa
    table = _ptxas_table(log)
    for fn in ("flash_bwd_dkdv_sm90_kernel", "flash_bwd_dq_sm90_kernel"):
        for atoms, D in ((1, 64), (2, 128)):
            hits = [v for k, v in table.items() if f"{fn}ILi{atoms}E" in k]
            check(len(hits) == 1, f"build: {fn}<{atoms}> not found once in "
                                  "ptxas output")
            regs, spill, _ = hits[0]
            print(f"build: flash_attention backward route bfloat16 -> "
                  f"{fn}<{atoms}>: {regs} registers at entry, consumers "
                  f"raised to {fa.CONSUMER_REGS} and the producer lowered "
                  f"to {fa.PRODUCER_REGS} by setmaxnreg, {spill} B spilled; "
                  f"{fa.BWD_THREADS} threads, the larger backward block "
                  f"{fa.backward_smem_bytes(D)} B of dynamic shared memory "
                  f"at D {D}")


def build_all() -> None:
    """One ``nvcc`` per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fleet_mlp import kernel as fleet
    from repro_torch.kernels.mamba2_scan import kernel as ssd
    from repro_torch.kernels.rwkv6_scan import kernel as wkv
    mods = (fleet, fa, dec, ssd, wkv)

    def timed(mod):
        t = time.perf_counter()
        lib, log = mod.build()
        return lib, log, time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(zip(KERNEL_NAMES, pool.map(timed, mods)))
    for name, (lib, log, secs) in built:
        print(f"build: {name} {secs:.2f} s -> {lib.relative_to(ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {line.strip()}")
            elif "Compiling entry function" in line:
                print(f"build: {line.strip().split(chr(39))[1][:110]}")
    print(f"build: all kernels in {time.perf_counter() - t:.2f} s")
    logs = {name: log for name, (_, log, _) in built}
    for name, mod in (("ssd_scan", ssd), ("wkv6_scan", wkv)):
        if logs[name]:   # empty when the library was already built
            scan_routes(name, mod, logs[name])
    if logs["flash_attention"]:   # empty when the library was already built
        backward_routes(logs["flash_attention"])
    import torch
    for D in (128, 80):
        print(f"build: dynamic shared memory per block at D {D}: "
              f"flash_attention bf16 {fa.smem_bytes(D, torch.bfloat16)} B, "
              f"f32 {fa.smem_bytes(D, torch.float32)} B; decode_attention "
              f"(group 2) bf16 {dec.smem_bytes(2, D, torch.bfloat16)} B, "
              f"f32 {dec.smem_bytes(2, D, torch.float32)} B")


# ------------------------------------------------------------ LM training

# the backward's cases: the qwen3-1.7b training shape (its first), then
# the forward's test shapes (GQA groups 5, 6, 7 and 9 among them) and the
# backward's own (Skv past a 128-key tile with Sq < Skv, G 4 at D 128,
# D 16 and D 80 over several tiles) in both dtypes, causal and full; then
# dbrx-132b's attention at the training length (B 1, G 6) in bf16
FLASH_BWD_PATH_CASE = ("train", 4, 1024, 1024, 16, 8, 128, "bfloat16", True)
FLASH_BWD_CASES = [FLASH_BWD_PATH_CASE] + [
    c for c in FLASH_CASES if c[0].startswith("test")] + [
    (f"bwd{i}", *s, dt, causal) for dt in ("float32", "bfloat16")
    for causal in (True, False)
    for i, s in enumerate([(1, 200, 328, 8, 2, 64), (1, 256, 256, 8, 2, 128),
                           (2, 192, 192, 4, 2, 16), (1, 160, 300, 6, 3, 80)])
    ] + [("dbrx", 1, 1024, 1024, 48, 8, 128, "bfloat16", True)]
# the forward's lse against the plain one, on |got - ref| / (1 + |ref|):
# f32 sums in another order; the bf16 route's exponentials run on the
# special-function unit (ex2.approx, about 2 ulp)
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
# card against CPU, one f32 train step of qwen3-1.7b at full width cut to
# 2 layers: the loss, as tests/test_torch_lm_train.py pins it against the
# JAX package (the same f32 sums in other orders); the grad norm and each
# gradient leaf (max |diff| over the leaf's max |ref|), the f32 attention
# kernels (tests/test_kernels.py's 2e-5) and cuBLAS against MKL between
# them. The params after AdamW's first step are held to what those
# gradient differences allow, element by element (``_update_excess``).
LM_PARITY_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-4,
                 "update_excess": 0.0}
# the recurrent families' training runs, at full width: the parity's depth
# (one period of zamba2-2.7b: six Mamba2 blocks and the shared block; two
# rwkv6-7b layers) and the path's. f32 masters, AdamW's two moments and
# the eager update's copies take about 28-31 B a parameter, so the path
# keeps the most whole periods whose peak stays under TRAIN_PEAK_BYTES:
# all nine of zamba2-2.7b's (2.49e9 parameters; 64.27e9 B at 48 layers,
# 70.97e9 B at 54 in a 3-step run of ``lm_train_path`` on an H100) and 8
# of rwkv6-7b's 32 layers (2.30e9 of 7.58e9 parameters, 69.75e9 B; 9
# layers ran out of the card's 80 GB)
RECURRENT_PARITY = {"zamba2-2.7b": dict(layers=6, seq=256),
                    "rwkv6-7b": dict(layers=2, seq=128)}
# the recurrent families' parity tolerances, from ``parity_rounding_gaps``
# on the CPU at the parity's shapes (worst gradient leaf of its max):
# the scans as f32 per-token recurrences move zamba2-2.7b's by 2.4e-6 and
# rwkv6-7b's by 1.3e-4 (tm/wr); summing the same f32 step in another order
# (one thread against eight) by 7.2e-6 and 2.5e-4 (cm/wv). rwkv6-7b's
# leaves are that sensitive to rounding at its init; a first card run,
# checked at 5e-4 (set from its scans' gap alone), read 7.87e-4. Its leaf
# tolerance is 2e-3, eight times the summation-order gap: the card sums
# every GEMM in cuBLAS's order. Leaves that amplify rounding cannot show
# which kernel rounds; ``scan_calls`` checks the scan kernels themselves
# at the step's own inputs (``SCAN_CALL_TOL``). The rest as LM_PARITY_TOL
RECURRENT_PARITY_TOL = {
    "zamba2-2.7b": LM_PARITY_TOL,
    "rwkv6-7b": {**LM_PARITY_TOL, "grad": 2e-3}}
# every scan call of the parity's step on the card, its output and its
# gradients against the plain versions on the same inputs and output
# gradient, as max |got - ref| / max |ref| per tensor (the step's
# gradients are far below 1, so 1 + |ref| would hide any error): f32 sums
# over up to 4,096 products and S tokens, each term no larger than the
# largest result, err by a few hundred f32 ulps (2^-24 each) at most;
# 1e-4 is 1,700 of them, and a dropped decay or a token's offset moves a
# gradient by O(1)
SCAN_CALL_TOL = 1e-4
RECURRENT_TRAIN_LAYERS = {"zamba2-2.7b": 54, "rwkv6-7b": 8}
TRAIN_PEAK_BYTES = 72e9


# elements of a leaf ``_update_excess`` takes at once (five float64
# slices of 0.13e9 B on the device)
EXCESS_SLICE = 1 << 24


def _update_excess(p_new, p_ref, g, g_ref, p0, opt, norms) -> float:
    """How far the card's first AdamW update exceeds what its gradient
    differences allow, the most over every element (<= 0 when it does
    not). The first step moves a weight by lr * (u + wd * p) with u =
    g / (|g| + eps / s) (the bias corrections cancel), s = min(1, clip /
    (|grad| + 1e-9)) the clip scale of each side's global norm (``norms``:
    the card's, the CPU's). u has slope at most 1 / eps in g and 1 / (4 e)
    in e = eps / s, and range (-1, 1), so two gradients |dg| apart, with
    scales s_a and s_b, move a weight at most lr * min(2, |dg| / eps +
    |s_a - s_b| / (4 min(s_a, s_b))) apart, plus the f32 rounding of p -
    lr * delta (4 ulp of |p| + 2 lr, which bounds both p and the result).
    Evaluated in float64, so that the check's own roundings do not count,
    on the card where any of a leaf's tensors lies there (else on the
    host), ``EXCESS_SLICE`` elements at a time (elementwise, so the same
    numbers as on the host)."""
    import torch
    from repro_torch.arch.params import tree_leaves
    sa, sb = (min(1.0, opt.grad_clip / (float(n) + 1e-9)) for n in norms)
    clip = abs(sa - sb) / (4 * min(sa, sb))
    worst = float("-inf")
    for leaves in zip(*(tree_leaves(t) for t in
                        (p_new, p_ref, g, g_ref, p0))):
        dev = next((t.device for t in leaves if t.device.type != "cpu"),
                   leaves[0].device)
        flat = [t.reshape(-1) for t in leaves]
        for i in range(0, flat[0].numel(), EXCESS_SLICE):
            a, b, ga, gb, p = (t[i:i + EXCESS_SLICE].to(dev, torch.float64)
                               for t in flat)
            allow = opt.lr * ((ga - gb).abs() / opt.eps
                              + clip).clamp(max=2.0) \
                + 4 * 2.0 ** -23 * (p.abs() + 2 * opt.lr)
            worst = max(worst, float(((a - b).abs() - allow).max()))
    return worst


def flash_backward_bound(q, k, causal: bool) -> dict:
    """q, k, v, the output and its gradient and lse read once, dq, dk, dv
    written once, against the five products of the visible (query, key)
    pairs (dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q and the
    recomputed S = Q K^T: 2 D operations each) over the bf16 tensor-core
    rate: 2.5 times the forward's operations."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    off = Skv - Sq
    pairs = sum(min(Skv, t + off + 1) for t in range(Sq)) if causal \
        else Sq * Skv
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size() \
        + B * H * Sq * 4
    return _bound(B * H * pairs * 10 * D, nbytes, BF16_FLOP_PER_S)


def _flash_with_lse(q, k, v, causal):
    """The forward with its lse: the kernel's on a CUDA tensor, the plain
    version's on a CPU one (the CPU rehearsal)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_reference
    if q.is_cuda:
        return fa_kernel.flash_attention_cuda(q, k, v, causal, with_lse=True)
    return attention_reference(q, k, v, causal=causal, return_lse=True)


def _flash_backward(q, k, v, out, do, lse, causal):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import \
        attention_backward_reference
    if q.is_cuda:
        return fa_kernel.flash_attention_backward_cuda(q, k, v, out, do, lse,
                                                       causal)
    return attention_backward_reference(q, k, v, out, lse, do, causal)


def _planted_faults(name, inputs, want, causal: bool, dtype: str) -> None:
    """The backward's check must fail a wrong kernel at the path shape:
    the plain backward with the output gradient of the last q tile
    (``BLOCK_Q`` rows) zeroed, so dK and dV lose that tile, and with that
    of the last head of every GQA group zeroed, so dK and dV lose that
    head, must each miss ``ATTN_TOL`` in dK and in dV."""
    from repro_torch.kernels.flash_attention.kernel import BLOCK_Q
    from repro_torch.kernels.flash_attention.ref import \
        attention_backward_reference
    q, k, v, out, lse, do = inputs
    G = q.shape[2] // k.shape[2]
    late, head = do.clone(), do.clone()
    late[:, -BLOCK_Q:] = 0
    head[:, :, G - 1::G] = 0
    for fault, d in (("the last q tile", late),
                     ("the last head of each GQA group", head)):
        bad = attention_backward_reference(q, k, v, out, lse, d, causal)
        rel = [_rel_err(a, b) for a, b in zip(bad[1:], want[1:])]
        print(f"{name}: planted fault, dK/dV without {fault}: rel_err dk "
              f"{rel[0]:.3e} dv {rel[1]:.3e}, caught (> "
              f"{ATTN_TOL[dtype]:.0e})")
        check(min(rel) > ATTN_TOL[dtype],
              f"{name}: the check misses dK/dV without {fault}: {rel}")


def _device_ms(fn, sets: list, calls: int = 6) -> tuple:
    """Device time per call of ``fn(*sets[i % len(sets)])`` as
    ``torch.profiler`` reads it: the sum of the kernels' (and memsets')
    own times over ``calls`` calls, and that sum by kernel name (None and
    {} where the profiler saw no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    by_name = {e.key: e.device_time_total / 1e3 / calls
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total}
    return (sum(by_name.values()) if by_name else None), by_name


def flash_backward_phase(device: str, cases=FLASH_BWD_CASES, *,
                         time_it: bool) -> dict:
    """The forward's lse (both routes) and the backward kernels against
    the plain backward on the same inputs (q, k, v, the kernel's output
    and lse, a seeded output gradient) for every case; at the path shape
    the reference gradients' magnitudes, the planted faults the check
    must catch (``_planted_faults``), the gradients through
    ``flash_attention`` under autograd equal to the wrapper's bitwise,
    and the times: the backward alone (eager and graph replay), the plain
    backward, ``scaled_dot_product_attention``'s backward alone
    (``library_ms``), and forward + backward under autograd of the port's
    op and of SDPA (``fwd_bwd_ms``, ``library_fwd_bwd_ms``). Returns the
    path case's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_reference)
    record = None
    for seed, (label, B, Sq, Skv, H, KV, D, dtype, causal) in \
            enumerate(cases):
        g = torch.Generator(device=device).manual_seed(300 + seed)
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(B, s, n, D, generator=g,
                                   device=device).to(dt)
                       for s, n in ((Sq, H), (Skv, KV), (Skv, KV), (Sq, H)))
        name = (f"flash_attention_backward {label:7s} B={B} Sq={Sq} "
                f"Skv={Skv} H={H} KV={KV} D={D} causal={causal}")
        out, lse = _flash_with_lse(q, k, v, causal)
        _, want_lse = attention_reference(q, k, v, causal=causal,
                                          return_lse=True)
        _agree(f"{name} lse", lse, want_lse, dtype, LSE_TOL)
        check(torch.equal(out, flash_attention(q, k, v, causal=causal)),
              f"{name}: the output with lse differs from the output without")
        got = _flash_backward(q, k, v, out, do, lse, causal)
        want = attention_backward_reference(q, k, v, out, lse, do, causal)
        errs = [_agree(f"{name} {part}", a, b, dtype)
                for part, a, b in zip(("dq", "dk", "dv"), got, want)]
        rec = {"max_abs_err": max(e["max_abs_err"] for e in errs),
               "rel_err": max(e["rel_err"] for e in errs)}
        if label != FLASH_BWD_PATH_CASE[0]:
            continue
        print(f"{name}: |ref| median / max " + ", ".join(
            f"{part} {float(b.float().abs().median()):.3e} / "
            f"{float(b.float().abs().max()):.3e}"
            for part, b in zip(("dq", "dk", "dv"), want)))
        _planted_faults(name, (q, k, v, out, lse, do), want, causal, dtype)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        op = torch.autograd.grad(flash_attention(*leaves, causal=causal),
                                 leaves, do)
        check(all(torch.equal(a, b) for a, b in zip(op, got)),
              f"{name}: gradients through the op differ from the wrapper's")
        rec.update(flash_backward_bound(q, k, causal))
        if time_it:
            sets = _input_sets((q, k, v, out, do, lse), rec["bytes"])
            kern = lambda *s: _flash_backward(*s, causal)      # noqa: E731
            plain = lambda q, k, v, o, do, lse: \
                attention_backward_reference(q, k, v, o, lse, do, causal)  # noqa: E731
            grad_sets = [tuple(t.detach().clone().requires_grad_(True)
                               for t in s[:3]) + (s[4],) for s in sets]
            sdpa_sets = [tuple(t.transpose(1, 2).detach().requires_grad_(True)
                               for t in s[:3]) + (s[4].transpose(1, 2),)
                         for s in sets]
            # SDPA's backward alone: each set's forward kept with its graph
            sdpa_bwd_sets = [(F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), q, k, v, do)
                for q, k, v, do in sdpa_sets]

            def port_fb(q, k, v, do):
                return torch.autograd.grad(
                    flash_attention(q, k, v, causal=causal), (q, k, v), do)

            def sdpa_fb(q, k, v, do):
                return torch.autograd.grad(F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), (q, k, v),
                    do)

            def sdpa_b(out, q, k, v, do):
                return torch.autograd.grad(out, (q, k, v), do,
                                           retain_graph=True)

            plain_ms = [_time_ms(plain, sets, 2)]
            kern_ms = [_time_ms(kern, sets, 10)]
            rec["library_ms"] = _time_ms(sdpa_b, sdpa_bwd_sets, 10)
            rec["library_fwd_bwd_ms"] = _time_ms(sdpa_fb, sdpa_sets, 10)
            rec["fwd_bwd_ms"] = _time_ms(port_fb, grad_sets, 10)
            kern_ms.append(_time_ms(kern, sets, 10))
            plain_ms.append(_time_ms(plain, sets, 2))
            rec.update(ms=sum(kern_ms) / 2, plain_ms=sum(plain_ms) / 2,
                       graph_ms=_time_ms(kern, sets, 10, graph=True),
                       library_graph_ms=None)
            # the same calls' device time by the profiler: an eager time
            # above it is the host's time to enqueue them (autograd's engine, the
            # wrapper), not the card's
            parts = {}
            for key, fn, fsets in (("device_ms", kern, sets),
                                   ("library_device_ms", sdpa_b,
                                    sdpa_bwd_sets),
                                   ("fwd_bwd_device_ms", port_fb, grad_sets),
                                   ("library_fwd_bwd_device_ms", sdpa_fb,
                                    sdpa_sets)):
                rec[key], parts[key] = _device_ms(fn, fsets)
            fmt = lambda x: "not measured" if x is None else f"{x:.4f}"  # noqa: E731
            print(f"flash_attention_backward {label} device time by "
                  f"torch.profiler (ms a call): the port's backward "
                  f"{fmt(rec['device_ms'])}, scaled_dot_product_attention's "
                  f"backward {fmt(rec['library_device_ms'])}; forward + "
                  f"backward: the port {fmt(rec['fwd_bwd_device_ms'])}, "
                  f"scaled_dot_product_attention "
                  f"{fmt(rec['library_fwd_bwd_device_ms'])}")
            for key in ("device_ms", "library_device_ms"):
                for name, ms in sorted(parts[key].items(),
                                       key=lambda kv: -kv[1]):
                    print(f"flash_attention_backward {label} {key} part: "
                          f"{ms:.4f} ms {name[:100]}")
            print(f"flash_attention_backward {label} time: "
                  f"{rec['ms']:.4f} ms/call eager, {rec['graph_ms']:.4f} ms "
                  f"by CUDA graph replay, inputs cold in L2; bound "
                  f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                  f"({rec['bytes']} bytes, {rec['flops']} flop); plain "
                  f"backward {rec['plain_ms']:.4f} ms; "
                  f"scaled_dot_product_attention's backward "
                  f"{rec['library_ms']:.4f} ms; forward + backward under "
                  f"autograd: the port's flash_attention "
                  f"{rec['fwd_bwd_ms']:.4f} ms, scaled_dot_product_attention "
                  f"{rec['library_fwd_bwd_ms']:.4f} ms (eager)")
        record = rec
    return record


# ------------------------------------------------------ the scans' backwards

# the scan backwards' cases: the zamba2-2.7b / rwkv6-7b training shapes in
# bf16 (the first, timed) and f32, then the forward phases' test, strong
# (SSD) and aggressive / extreme (WKV) cases in both dtypes; every other
# case also carries a final-state gradient
SSD_BWD_PATH_CASE = ("train", 4, 1024, 80, 64, 64, "bfloat16", 64,
                     (1e-3, 0.1))
SSD_BWD_CASES = [SSD_BWD_PATH_CASE,
                 ("train32", *SSD_BWD_PATH_CASE[1:6], "float32",
                  *SSD_BWD_PATH_CASE[7:])] + SSD_CASES[1:]
WKV_BWD_PATH_CASE = ("train", 4, 1024, 64, 64, "bfloat16", 0.4, 32)
WKV_BWD_CASES = [WKV_BWD_PATH_CASE,
                 ("train32", *WKV_BWD_PATH_CASE[1:5], "float32",
                  *WKV_BWD_PATH_CASE[6:])] + WKV_CASES[1:]
# the backward kernels against the plain backwards (float64 from the same
# inputs), on |got - ref| / (1 + |ref|). In f32 the kernels sum in f32
# over up to S tokens, and SSD's ddt_t = x_t . g_t + A a_t <dS_t, S_{t-1}>
# adds two dot products over the whole (P, N) state (4,096 products at
# the path shape) that nearly cancel at some tokens, leaving their f32
# rounding (about 1e-4 of terms of size 10^2) against a small |ref|: the
# card read 2.0e-4 there at the zamba2-2.7b training shape (a CPU
# emulation of the kernels' code, one head of S 1024, 2.3e-5). bf16
# outputs are rounded once from f32 and keep ~3 significant digits, as
# the forwards'; gradients the kernels return in f32 take the f32 one
SCAN_BWD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _ssd_backward(x, dt, A, Bm, Cm, D, dy, d_final=None):
    """The backward kernel's gradients on a CUDA tensor, the plain
    backward's on a CPU one (the CPU rehearsal)."""
    import math
    from repro_torch.kernels.mamba2_scan import kernel as ssd_kernel
    from repro_torch.kernels.mamba2_scan.ref import ssd_backward_reference
    if x.is_cuda:
        return ssd_kernel.ssd_scan_backward_cuda(x, dt, A, Bm, Cm, D, dy,
                                                 d_final)
    return ssd_backward_reference(x, dt, A, Bm, Cm, D, dy, None, d_final,
                                  chunk=math.gcd(64, x.shape[1]))[:6]


def _wkv_backward(r, k, v, w, u, dy, d_final=None):
    import math
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_backward_reference
    if r.is_cuda:
        return wkv_kernel.wkv6_scan_backward_cuda(r, k, v, w, u, dy, d_final)
    return wkv6_backward_reference(r, k, v, w, u, dy, None, d_final,
                                   chunk=math.gcd(32, r.shape[1]))[:5]


def scan_backward_bound(inputs: tuple, grads: tuple, fwd_flops: int) -> dict:
    """Each input and the output's gradient read once and each gradient
    written once over HBM, against the chunked form's products of the
    backward, three times the forward's (the forward's recomputed, the
    adjoint's within and across chunks, and the gradients' read-outs of
    both), over the bf16 tensor-core rate."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs + grads)
    return _bound(3 * fwd_flops, nbytes, BF16_FLOP_PER_S)


def _scan_faults(name, plain, inputs, want, dtype, decay_index,
                 no_decay) -> None:
    """The backward's check must fail a wrong kernel at the path shape:
    the plain backward with the decay dropped (every token's decay 1) and
    with the output gradient one token late must each miss
    ``SCAN_BWD_TOL`` in some gradient."""
    import torch
    args = list(inputs)
    late = torch.roll(args[-1], 1, dims=1)
    late[:, 0] = 0
    dropped = list(args)
    dropped[decay_index] = no_decay(args[decay_index])
    for fault, bad_args in (("the decay dropped", dropped),
                            ("dy one token late", args[:-1] + [late])):
        bad = plain(*bad_args)
        rel = max(_rel_err(a, b) for a, b in zip(bad, want))
        print(f"{name}: planted fault, {fault}: worst gradient rel_err "
              f"{rel:.3e}, caught (> {SCAN_BWD_TOL[dtype]:.0e})")
        check(rel > SCAN_BWD_TOL[dtype],
              f"{name}: the check misses the backward with {fault}: {rel}")


def _scan_backward_case(name, dtype, inputs, d_final, backward, plain, op,
                        parts, bound, time_it: bool, path: bool,
                        decay_index, no_decay) -> dict:
    """One scan backward case: the kernel's gradients against the plain
    backward's; at the path shape also two calls bitwise equal, the
    gradients through the op under autograd equal to the wrapper's, the
    planted faults, and the times. Returns the case's record."""
    import torch
    got = backward(*inputs, d_final)
    want = plain(*inputs, d_final)
    errs = [_agree(f"{name} {part}", a, b,
                   "float32" if b.dtype == torch.float32 else dtype,
                   SCAN_BWD_TOL)
            for part, a, b in zip(parts, got, want)]
    rec = {"max_abs_err": max(e["max_abs_err"] for e in errs),
           "rel_err": max(e["rel_err"] for e in errs)}
    if not path:
        return rec
    again = backward(*inputs, d_final)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two calls differ")
    leaves = [t.clone().requires_grad_(True) for t in inputs[:-1]]
    y, _ = op(*leaves)
    through = torch.autograd.grad(y, leaves, inputs[-1])
    check(all(torch.equal(a, b) for a, b in zip(through, got)),
          f"{name}: gradients through the op differ from the wrapper's")
    print(f"{name}: two calls bitwise equal, the op's autograd gradients "
          f"equal to the wrapper's; |ref| median / max " + ", ".join(
              f"{part} {float(b.float().abs().median()):.3e} / "
              f"{float(b.float().abs().max()):.3e}"
              for part, b in zip(parts, want)))
    _scan_faults(name, lambda *a: plain(*a, None), inputs, want, dtype,
                 decay_index, no_decay)
    rec.update(bound(got))
    if time_it:
        sets = _input_sets(inputs, rec["bytes"])
        _timed(rec, sets, backward, lambda *a: plain(*a, None), None, 10)
        rec["device_ms"], by_name = _device_ms(backward, sets)
        fmt = lambda x: "not measured" if x is None else f"{x:.4f}"  # noqa: E731
        print(f"{name} device time by torch.profiler: "
              f"{fmt(rec['device_ms'])} ms a call")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
            print(f"{name} device part: {ms:.4f} ms {kname[:100]}")
        print(f"{name} time: " + _times(
            rec, "no single PyTorch call computes the backward"))
    return rec


def scan_backward_phase(device: str, ssd_cases=SSD_BWD_CASES,
                        wkv_cases=WKV_BWD_CASES, *, time_it: bool) -> dict:
    """Both scans' backward kernels against their plain backwards on the
    same inputs and a seeded output gradient (and final-state gradient on
    every other case), each gradient at ``SCAN_BWD_TOL``; at the bf16
    path shapes also the checks and times of ``_scan_backward_case``.
    Returns the path cases' records by row name."""
    import torch
    from repro_torch.kernels.mamba2_scan.ops import ssd_scan
    from repro_torch.kernels.mamba2_scan.ref import (ssd_backward_reference,
                                                     ssd_chunked)
    from repro_torch.kernels.rwkv6_scan.ops import wkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import (wkv6_backward_reference,
                                                    wkv6_chunked)
    records = {}
    for seed, (label, B, S, H, P, N, dtype, chunk, dt_range) in \
            enumerate(ssd_cases):
        g = torch.Generator(device=device).manual_seed(500 + seed)
        dt_ = getattr(torch, dtype)
        x = torch.randn(B, S, H, P, generator=g, device=device).to(dt_)
        dt = _uniform(g, *dt_range, (B, S, H), device)
        A = -_uniform(g, 0.5, 2.0, (H,), device)
        Bm, Cm = (torch.randn(B, S, 1, N, generator=g, device=device).to(dt_)
                  for _ in range(2))
        D = torch.randn(H, generator=g, device=device)
        dy = torch.randn(B, S, H, P, generator=g, device=device).to(dt_)
        d_final = torch.randn(B, H, P, N, generator=g, device=device) \
            if seed % 2 else None
        path = label == SSD_BWD_PATH_CASE[0]
        name = (f"ssd_scan_backward {label:7s} B={B} S={S} H={H} P={P} "
                f"N={N} dt=U{dt_range} final-state grad "
                f"{'yes' if d_final is not None else 'no'}")
        rec = _scan_backward_case(
            name, dtype, (x, dt, A, Bm, Cm, D, dy), d_final, _ssd_backward,
            lambda *a: ssd_backward_reference(*a[:7], None, a[7],
                                              chunk=chunk)[:6],
            lambda *a: ssd_scan(*a, chunk=chunk),
            ("dx", "ddt", "dA", "dBm", "dCm", "dD"),
            lambda grads: scan_backward_bound(
                (x, dt, A, Bm, Cm, D, dy), grads,
                ssd_bound(x, dt, Bm, D, chunk)["flops"]),
            time_it, path, 2, torch.zeros_like)
        if path:
            records["ssd_scan_backward"] = rec
            if x.is_cuda:
                scan_backward_build("ssd_scan", B, S, H, N, x.dtype)
    for seed, (label, B, S, H, K, dtype, wmin, chunk) in \
            enumerate(wkv_cases):
        g = torch.Generator(device=device).manual_seed(600 + seed)
        dt_ = getattr(torch, dtype)
        r, k, v, dy = (torch.randn(B, S, H, K, generator=g,
                                   device=device).to(dt_) for _ in range(4))
        w = _decays(g, wmin, (B, S, H, K), device)
        u = torch.randn(H, K, generator=g, device=device)
        d_final = torch.randn(B, H, K, K, generator=g, device=device) \
            if seed % 2 else None
        path = label == WKV_BWD_PATH_CASE[0]
        name = (f"wkv6_scan_backward {label:7s} B={B} S={S} H={H} K={K} "
                f"wmin={wmin} final-state grad "
                f"{'yes' if d_final is not None else 'no'}")
        rec = _scan_backward_case(
            name, dtype, (r, k, v, w, u, dy), d_final, _wkv_backward,
            lambda *a: wkv6_backward_reference(*a[:6], None, a[6],
                                               chunk=chunk)[:5],
            lambda *a: wkv6_scan(*a, chunk=chunk),
            ("dr", "dk", "dv", "dw", "du"),
            lambda grads: scan_backward_bound(
                (r, k, v, w, u, dy), grads, wkv_bound(r, w, u, chunk)["flops"]),
            time_it, path, 3, torch.ones_like)
        if path:
            records["wkv6_scan_backward"] = rec
            if r.is_cuda:
                scan_backward_build("wkv6_scan", B, S, H, K, r.dtype)
    return records

def scan_backward_build(name: str, B, S, H, N, dtype) -> None:
    """Print a scan backward's bf16 reverse sweep (``<name>_bwd_tc_kernel``)
    as the card built and launches it (registers, spilled bytes and blocks
    an SM from the runtime's attributes and occupancy calculator) and its
    scratch at these shapes (N: SSD's state size, WKV's K): the saved
    states and the whole buffer. It must hold 2 blocks an SM."""
    from repro_torch.kernels.mamba2_scan import kernel as ssd_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    mod = ssd_kernel if name == "ssd_scan" else wkv_kernel
    occ = mod.backward_occupancy()
    work = mod.backward_work_bytes(B, S, H, N) if mod is ssd_kernel else \
        mod.backward_work_bytes(B, S, H, N, dtype)
    print(f"{name}_backward build: {name}_bwd_tc_kernel "
          f"{occ['registers']} registers, {occ['spilled_bytes']} B spilled "
          f"a thread, {occ['blocks_per_sm']} blocks an SM "
          f"({mod.BWD_TC_THREADS} threads, "
          f"{mod.BWD_TC_SMEM_BYTES} B of shared memory a block)")
    print(f"{name}_backward scratch: saved states "
          f"{mod.backward_states_bytes(B, S, H, dtype)} B "
          f"({str(dtype)[6:]} route), the whole buffer {work} B")
    check(occ["blocks_per_sm"] >= 2,
          f"{name}_backward: {occ['blocks_per_sm']} blocks an SM")


def _move(tree, device):
    from repro_torch.distributed.checkpoint import tree_map
    return tree_map(lambda t: t.to(device), tree)


def train_batch(cfg, batch: int, seq: int, seed: int, device: str) -> dict:
    """A seeded training batch of ``cfg``'s inputs: the next-token stream
    of ``synthetic_lm_batch`` for a token model, ``synthetic_batch_for``'s
    frames (audio) or tokens, patch embeddings and M-RoPE positions
    (vlm) otherwise."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.synthetic import (synthetic_batch_for,
                                            synthetic_lm_batch)
    if cfg.frontend == "none":
        return synthetic_lm_batch(cfg.vocab_size, batch, seq, seed=seed,
                                  device=device)
    return synthetic_batch_for(cfg, ShapeSpec("train", seq, batch, "train"),
                               seed=seed, device=device)


def lm_train_parity(device: str, arch: str = "qwen3-1.7b", *,
                    layers: int = 2, batch: int = 1, seq: int = 256,
                    seed: int = 21, tol=LM_PARITY_TOL,
                    gradients_only: bool = False) -> dict:
    """One f32 ``make_train_step`` of ``arch`` at full width cut to
    ``layers`` layers, on ``device`` and on the CPU from the same params
    (drawn on the CPU) and batch: the loss, the grad norm, every gradient
    leaf (read through ``grad_hook``) and the updated params within
    ``tol``. With ``gradients_only``, the step's gradients alone
    (``make_grad_fn``: the CPU's f32 AdamW over a full-width vocabulary
    costs tens of seconds, and its arithmetic does not depend on the
    config) from params drawn on ``device`` and copied to the CPU (whose
    seeded draw of 1.5e9 of them is slow). On the
    device the launches of ``train_launches``
    (each kernel's backward once, its forward twice). Where the model has
    scans, every scan call of the device's step is held to its plain
    version at its own inputs (``_check_scan_calls``). Returns the
    errors."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.arch.params import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.optim import global_norm
    from repro_torch.train.step import _unflatten, make_grad_fn
    check(not torch.backends.cuda.matmul.allow_tf32,
          "train parity: f32 matmuls must not run in TF32")
    cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
    home = device if gradients_only else "cpu"
    params = M.init_params(cfg, torch.Generator(device=home).manual_seed(
        seed), device=home)
    batch0 = train_batch(cfg, batch, seq, seed, "cpu")
    out, moe_routes = {}, {}
    for dev in dict.fromkeys((device, "cpu")):
        p, b = _move(params, dev), _move(batch0, dev)
        seen = []
        step = make_train_step(cfg, grad_hook=lambda gr: seen.append(gr)
                               or gr)
        reset_counts()
        t = time.perf_counter()
        with _recorded_scans() as calls, _recorded_routes() as routes:
            if gradients_only:
                grads, m = make_grad_fn(cfg)(p, [b])
                seen.append(_unflatten(p, grads))
                m["grad_norm"], new = global_norm(seen[0]), None
            else:
                new, _, m = step(p, init_state(p), b)
            loss = float(m["loss"])
        secs = time.perf_counter() - t
        if dev == device:
            device_calls = calls
        out[dev] = (new, m, seen[0], counts(), loss, secs)
        moe_routes[dev] = routes
        del p
    (p_d, m_d, g_d, n_d, loss_d, s_d), (p_c, m_c, g_c, _, loss_c, s_c) = \
        out[device], out["cpu"]
    opt = AdamWConfig()
    gaps = _leaf_gaps(g_d, g_c)
    worst = max(gaps, key=gaps.get)
    rel = {"loss": abs(loss_d - loss_c) / abs(loss_c),
           "grad_norm": abs(float(m_d["grad_norm"]) - float(m_c["grad_norm"]))
           / float(m_c["grad_norm"]),
           "grad": gaps[worst]}
    if not gradients_only:
        rel["update_excess"] = _update_excess(
            p_d, p_c, g_d, g_c, params, opt,
            (m_d["grad_norm"], m_c["grad_norm"]))
        p_diff = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(tree_leaves(p_d), tree_leaves(p_c)))
        params_line = (f"params max |diff| {p_diff:.2e} (excess over what "
                       f"the gradient differences allow "
                       f"{rel['update_excess']:.2e})")
    else:
        params_line = "gradients only (no update)"
    scans = any(kind in cfg.pattern for kind in ("mamba2", "rwkv6"))
    print(f"train parity: {cfg.name} d={cfg.d_model} H={cfg.num_heads} "
          f"KV={cfg.num_kv_heads} hd={cfg.head_dim} vocab={cfg.vocab_size}, "
          f"{layers} layers, f32, B {batch} x S {seq}: {device} against cpu "
          f"from the same params, loss {loss_d:.6f} / {loss_c:.6f} (rel "
          f"{rel['loss']:.2e}), grad norm rel {rel['grad_norm']:.2e}, worst "
          f"gradient leaf {rel['grad']:.2e} of its max ({worst}), "
          f"{params_line}; step {s_d:.3f} s on {device}, {s_c:.3f} s on "
          f"cpu")
    if scans:
        _check_scan_calls(cfg.name, device, device_calls)
    aux = [k for k in m_c if k.startswith("moe_")]
    if aux:
        # the router losses are summed like the loss; the routes of every
        # router call (the forward's and the recompute's) on both sides
        for k in aux:
            rel[k] = abs(float(m_d[k]) - float(m_c[k])) / abs(float(m_c[k]))
        print("train parity: " + ", ".join(
            f"{k} {float(m_d[k]):.6f} / {float(m_c[k]):.6f} (rel "
            f"{rel[k]:.2e})" for k in aux))
        routes = route_report(f"{cfg.name} train step, {device} against cpu",
                              _flat(moe_routes["cpu"]),
                              _flat(moe_routes[device]))
        rel["route_sets_differ"] = routes["sets_differ"]
        check(routes["sets_differ"] == 0,
              f"train parity: {routes['sets_differ']} expert sets differ")
        tol = {**tol, **{k: tol["loss"] for k in aux}}
    for key, bound in tol.items():
        if key in rel:
            check(rel[key] <= bound,
                  f"train parity: {key} {rel[key]:.3e} > {bound}")
    want = train_launches(cfg)
    check(device == "cpu" or n_d == want,
          f"train parity: launches {n_d}, expected {want}")
    print(f"train parity: launches " + ", ".join(
        f"{k} {v}" for k, v in n_d.items() if v) + " ok")
    return rel


def _leaf_paths(tree, pre: str = "") -> list:
    """Each leaf's path in ``tree_leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _leaf_paths(tree[k],
                                                             f"{pre}/{k}")]
    return [pre]


def _leaf_gaps(got, want) -> dict:
    """max |got - want| / max |want| per gradient leaf, by path, on the
    device of ``got``'s leaves."""
    from repro_torch.arch.params import tree_leaves
    gaps = {}
    for path, a, b in zip(_leaf_paths(want), tree_leaves(got),
                          tree_leaves(want)):
        b = b.to(a.device)
        gaps[path] = float((a - b).abs().max() / (b.abs().max() + 1e-30))
    return gaps


@contextlib.contextmanager
def _recorded_scans():
    """Record every scan call while the block runs: its op, inputs, chunk
    and output, and the output's gradient once autograd hands it over
    (under remat only the recomputed call's output gets one)."""
    from repro_torch.kernels.mamba2_scan import ops as ssd
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    calls = []

    def recorder(name, fn):
        def apply(*args):
            y, final = fn(*args)
            if y.requires_grad:
                call = {"name": name, "inputs": [
                    a.detach() for a in args[:-3]], "chunk": args[-2],
                    "y": y.detach()}
                y.register_hook(lambda g: call.update(dy=g.detach()))
                calls.append(call)
            return y, final
        return staticmethod(apply)

    saved = ssd._SSDScan.apply, wkv._WKV6Scan.apply
    ssd._SSDScan.apply = recorder("ssd_scan", saved[0])
    wkv._WKV6Scan.apply = recorder("wkv6_scan", saved[1])
    try:
        yield calls
    finally:
        ssd._SSDScan.apply, wkv._WKV6Scan.apply = saved


def _check_scan_calls(label: str, device: str, calls: list) -> float:
    """Each recorded scan call that got an output gradient: the kernels'
    output and gradients (the wrappers' on a card, the plain versions on
    the CPU) against the plain versions on the same inputs, as max |got -
    ref| / max |ref| per tensor, within ``SCAN_CALL_TOL``. Returns the
    worst."""
    from repro_torch.kernels.mamba2_scan.ref import (ssd_backward_reference,
                                                     ssd_chunked)
    from repro_torch.kernels.rwkv6_scan.ref import (wkv6_backward_reference,
                                                    wkv6_chunked)
    plain = {"ssd_scan": (ssd_chunked, ssd_backward_reference,
                          _ssd_backward),
             "wkv6_scan": (wkv6_chunked, wkv6_backward_reference,
                           _wkv_backward)}
    worst, n = 0.0, 0
    for call in calls:
        if "dy" not in call:
            continue
        forward, backward, kernel = plain[call["name"]]
        args, dy = call["inputs"], call["dy"].contiguous()
        want = (forward(*args, chunk=call["chunk"])[0],
                *backward(*args, dy, chunk=call["chunk"])[:len(args)])
        got = (call["y"], *kernel(*args, dy))
        for a, b in zip(got, want):
            worst = max(worst, float((a.float() - b.float()).abs().max()
                                     / (b.float().abs().max() + 1e-30)))
        n += 1
    print(f"train parity: {label} on {device}, {n} scan calls of the step "
          f"against their plain versions at their own inputs: output and "
          f"gradients within {worst:.2e} of the largest (tol "
          f"{SCAN_CALL_TOL:.0e})")
    check(n > 0 and worst <= SCAN_CALL_TOL,
          f"train parity: {label} scan calls {worst:.3e} (of {n})")
    return worst


def parity_rounding_gaps(arch: str, *, layers: int, batch: int = 1,
                         seq: int = 256, seed: int = 21) -> dict:
    """On the CPU, how far rounding alone moves what ``lm_train_parity``
    compares: one f32 ``train_loss`` of ``arch`` at full width cut to
    ``layers`` layers and its gradient, from the same params and batch,
    three ways: as the CPU route runs it (plain scans in float64, the
    default thread count); with the scans as f32 per-token recurrences
    under autograd (the arithmetic of the kernels' f32 route), ``scans``;
    and on one thread (the same f32 arithmetic summed in another order),
    ``threads``. Each gap is the loss, grad-norm and worst-leaf difference
    as the parity reads them, with the worst leaf's path. Run once to set
    RECURRENT_PARITY_TOL: ``python3 -c "import chip_smoke as s;
    print(s.parity_rounding_gaps('rwkv6-7b', layers=2, seq=128))"`` with
    ``src`` on the path."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.arch.params import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import synthetic_lm_batch
    from repro_torch.kernels.mamba2_scan import ops as ssd
    from repro_torch.kernels.mamba2_scan.ref import ssd_sequential
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_sequential
    from repro_torch.train.step import _unflatten
    cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    batch0 = synthetic_lm_batch(cfg.vocab_size, batch, seq, seed=seed,
                                device="cpu")

    def value_and_grad():
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = M.train_loss(cfg, _unflatten(params, live), batch0)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        return float(loss.detach()), _unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(live, grads)])

    def gap(got, want):
        norm = [float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                     for g in tree_leaves(gs))))
                for gs in (got[1], want[1])]
        gaps = _leaf_gaps(got[1], want[1])
        worst = max(gaps, key=gaps.get)
        return {"loss": abs(got[0] - want[0]) / abs(want[0]),
                "grad_norm": abs(norm[0] - norm[1]) / norm[1],
                "grad": gaps[worst], "worst_leaf": worst}

    base = value_and_grad()
    originals = (ssd._SSDScan.apply, wkv._WKV6Scan.apply)
    ssd._SSDScan.apply = staticmethod(
        lambda x, dt, A, Bm, Cm, D, s0, chunk, kernel:
        ssd_sequential(x, dt, A, Bm, Cm, D, s0))
    wkv._WKV6Scan.apply = staticmethod(
        lambda r, k, v, w, u, s0, chunk, kernel:
        wkv6_sequential(r, k, v, w, u, s0))
    try:
        scans = value_and_grad()
    finally:
        ssd._SSDScan.apply, wkv._WKV6Scan.apply = originals
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = value_and_grad()
    finally:
        torch.set_num_threads(threads)
    return {"scans": gap(scans, base), "threads": gap(one, base)}


def lm_train_path(device: str, arch: str = "qwen3-1.7b", *, batch: int = 4,
                  seq: int = 1024, steps: int = 8, layers: int = 0,
                  profile: bool = True) -> dict:
    """``arch`` at full width, at full depth or cut to ``layers`` layers
    (whole periods): f32 master params from a seeded generator on the
    device, AdamW defaults, ``steps`` steps of ``make_train_step`` (bf16
    compute, remat) on ``SyntheticTokenStream(vocab, batch, seq)`` (a
    frames or patches model: ``train_batch``'s random batches). Every
    loss finite, for a token model the last below the first (random
    labels need not fall); per step the launches of
    ``train_launches`` (each kernel's forward twice, the forward and the
    recompute, its backward once), no other kernel; on a card the peak
    device memory under ``TRAIN_PEAK_BYTES``. Prints the step times,
    tokens/s and peak memory, then a profiler window over one more step.
    The model is freed before returning."""
    import math
    import torch
    from repro_torch.arch import model as M
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticTokenStream
    from repro_torch.train import init_state, make_train_step
    cuda = device != "cpu"
    if cuda:   # what earlier phases left cached, so that it cannot fragment
        torch.cuda.empty_cache()
        print(f"train: {torch.cuda.memory_allocated()} B allocated, "
              f"{torch.cuda.memory_reserved()} B reserved before the draw")
    cfg = get_config(arch)
    full = cfg.num_layers
    if layers:
        cfg = cfg.replace(num_layers=layers)
    t = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    opt_state = init_state(params)
    step = make_train_step(cfg)
    if cfg.frontend == "none":
        stream = SyntheticTokenStream(cfg.vocab_size, batch, seq,
                                      device=device)
        batches = [stream.next() for _ in range(steps + 1)]
    else:                      # frames (audio) or patches + M-RoPE (vlm)
        batches = [train_batch(cfg, batch, seq, i, device)
                   for i in range(steps + 1)]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    n_params = M.param_count(cfg)
    print(f"train setup: {cfg.name} {cfg.num_layers} of {full} layers, "
          f"{n_params} parameters (f32 masters, {cfg.dtype} compute), "
          f"AdamW state {4 * 4 * n_params} B with the gradients, drawn in "
          f"{time.perf_counter() - t:.1f} s")
    per_step = train_launches(cfg)
    losses, walls = [], []
    reset_counts()
    for i, b in enumerate(batches[:steps]):
        before = counts()
        t = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))        # waits for the step
        walls.append(time.perf_counter() - t)
        after = counts()
        got = {k: after[k] - before[k] for k in after}
        check(got == per_step, f"train step {i}: launches {got}, expected "
                               f"{per_step}")
        print(f"train step {i}: loss {losses[-1]:.4f} grad norm "
              f"{float(m['grad_norm']):.4f} in {walls[-1]:.3f} s")
    launches = counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    warm = walls[1:] or walls
    step_s = sum(warm) / len(warm)
    print(f"train: {cfg.name} ({cfg.num_layers} layers) {steps} steps of "
          f"{batch} x {seq} tokens, "
          f"first {walls[0]:.3f} s, then {step_s:.3f} s a step "
          f"({batch * seq / step_s:.1f} tokens/s), peak device memory "
          + (f"{peak} B ({torch.cuda.max_memory_reserved()} B reserved)"
             if cuda else "not measured (cpu)")
          + "; launches " + ", ".join(f"{k} {v}" for k, v in
                                      launches.items() if v))
    check(all(math.isfinite(x) for x in losses),
          f"train: a loss is not finite: {losses}")
    check(cfg.frontend != "none" or losses[-1] < losses[0],
          f"train: the loss did not fall: {losses[0]} -> {losses[-1]}")
    check(peak is None or peak < TRAIN_PEAK_BYTES,
          f"train: peak device memory {peak} B >= {TRAIN_PEAK_BYTES} B")
    rec = {"launches": launches, "losses": losses, "step_s": step_s,
           "first_step_s": walls[0], "tokens_per_s": batch * seq / step_s,
           "peak_bytes": peak}
    if profile and cuda:
        rec["profile"] = profile_train_step(step, params, opt_state,
                                            batches[steps], step_s)
    del params, opt_state
    if cuda:
        torch.cuda.empty_cache()
    return rec


def profile_train_step(step, params, opt_state, batch, step_s: float,
                       top: int = 10) -> dict:
    """``torch.profiler`` over one more train step: the device's kernel
    time by name and its sum over the unprofiled step wall (the busy
    share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step(params, opt_state, batch)
        float(out[2]["loss"])
        torch.cuda.synchronize()
    del out
    kern = sorted(((e.key, e.device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda kv: -kv[1])
    dev_ms = sum(ms for _, ms in kern)
    print("train profile: one step, device kernel time "
          + (f"{dev_ms:.3f} ms, busy share {dev_ms / 1e3 / step_s:.3f} of "
             f"the unprofiled step" if kern else
             "not measured (the profiler saw no device activity)"))
    for name, ms in kern[:top]:
        print(f"train profile: {ms:.3f} ms {name[:100]}")
    tags = {"flash_bwd": "flash_bwd",
            "flash_attention_sm90": "flash_attention_sm90",
            "flash_attention_kernel": "flash_attention_kernel",
            "ssd_scan_bwd": "ssd_scan_bwd",
            "ssd_scan_tc (forward)": "ssd_scan_tc_kernel<true, false>",
            "ssd_scan_tc (backward state sweep)":
                "ssd_scan_tc_kernel<true, true>",
            "wkv6_scan_bwd": "wkv6_scan_bwd",
            "wkv6_scan_tc (forward)": "wkv6_scan_tc_kernel<true, false>",
            "wkv6_scan_tc (backward state sweep)":
                "wkv6_scan_tc_kernel<true, true>",
            "sum_mid": "sum_mid"}
    ours = {label: sum(ms for n, ms in kern if tag in n)
            for label, tag in tags.items()}
    print("train profile: the port's kernels " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ours.items() if v))
    return {"device_ms": dev_ms if kern else None, "top": kern[:top],
            "kernel_ms": ours}


def launcher_phase(device: str, *, steps: int = 12, every: int = 4,
                   fail_at: int = 6) -> dict:
    """``repro_torch.launch.train`` (its ``main``'s run) on qwen3-1.7b's
    smoke config with a failure injected at step ``fail_at``: one failure
    handled, one restore from the step-``every`` checkpoint, the final
    checkpoint written and restored equal to the final state."""
    import tempfile
    import torch
    from repro_torch.distributed.checkpoint import flatten, latest_step, restore
    from repro_torch.launch import train as launch
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        losses, state, rep, ckpt = launch.run(
            ["--arch", "qwen3-1.7b", "--smoke", "--steps", str(steps),
             "--checkpoint-every", str(every), "--inject-failure-at",
             str(fail_at), "--checkpoint-dir", td, "--device", device])
        secs = time.perf_counter() - t
        check((rep.failures_handled, rep.restores, rep.final_step)
              == (1, 1, steps),
              f"launcher: failures {rep.failures_handled}, restores "
              f"{rep.restores}, final step {rep.final_step}")
        redone = fail_at - (fail_at // every) * every
        check(len(losses) == steps + redone,
              f"launcher: {len(losses)} losses for {steps} steps")
        check(latest_step(str(ckpt.root)) == steps,
              f"launcher: latest checkpoint {latest_step(str(ckpt.root))}")
        got, manifest = restore(ckpt.dir_for(steps), state)
        same = all(torch.equal(a, b) for a, b in zip(flatten(got),
                                                     flatten(state)))
        check(same and manifest["step"] == steps,
              "launcher: the final checkpoint does not restore the state")
    print(f"launcher: {steps} steps, failure at {fail_at} handled, restored "
          f"from step {(fail_at // every) * every}, final checkpoint at step "
          f"{steps} restored equal on {device}, {secs:.1f} s ok")
    return {"seconds": secs, "losses": losses}


def guard_phase(device: str) -> None:
    """The kernels under autograd. ``decode_attention`` and ``fleet_mlp``
    (forward only): on a card each refuses the call (``NotImplementedError``,
    nothing counted); on the CPU their plain versions differentiate.
    ``ssd_scan`` and ``wkv6_scan`` record a gradient on both: a finite
    gradient for every leaf, one forward and one backward counted each."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.fleet_mlp import ops as fleet
    from repro_torch.kernels.mamba2_scan import ops as ssd
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    g = torch.Generator(device=device).manual_seed(31)

    def leaf(*shape, lo=None, hi=None):
        t = torch.randn(*shape, generator=g, device=device) if lo is None \
            else torch.rand(*shape, generator=g, device=device) * (hi - lo) + lo
        return t.requires_grad_(True)

    refused = {
        "decode_attention": lambda: dec.decode_attention(
            leaf(2, 4, 64), leaf(2, 128, 2, 64), leaf(2, 128, 2, 64),
            torch.tensor([5, 128], dtype=torch.int32, device=device)),
        "fleet_mlp": lambda: fleet.fleet_mlp(
            leaf(4, 2, 8), [leaf(4, 8, 16), leaf(4, 16, 1)],
            [leaf(4, 16), leaf(4, 1)]),
    }
    trained = {
        "ssd_scan": lambda: (leaf(1, 64, 2, 64), leaf(1, 64, 2, lo=1e-3, hi=0.1),
                             leaf(2, lo=-2.0, hi=-1.0), leaf(1, 64, 1, 64),
                             leaf(1, 64, 1, 64), leaf(2)),
        "wkv6_scan": lambda: (leaf(1, 64, 2, 64), leaf(1, 64, 2, 64),
                              leaf(1, 64, 2, 64),
                              leaf(1, 64, 2, 64, lo=0.4, hi=0.999), leaf(2, 64)),
    }
    reset_counts()
    for name, call in refused.items():
        if device == "cpu":
            call().sum().backward()
            continue
        try:
            call()
        except NotImplementedError as e:
            check(name in str(e) and "no training path" in str(e),
                  f"guard: {name} raised {e}")
        else:
            check(False, f"guard: {name} returned a result under autograd "
                         "on the card")
    for name, op in (("ssd_scan", ssd.ssd_scan), ("wkv6_scan", wkv.wkv6_scan)):
        leaves = trained[name]()
        y, final = op(*leaves)
        (y.float().sum() + final.sum()).backward()
        check(all(t.grad is not None and bool(torch.isfinite(t.grad).all())
                  for t in leaves), f"guard: {name} left a leaf without a "
                                    "finite gradient")
    want = {n: 0 for n in COUNT_NAMES}
    for n in trained:
        want[n] = want[f"{n}_backward"] = 1
    for n in refused:
        want[n] = int(device == "cpu")
    check(counts() == want, f"guard: launches {counts()}, expected {want}")
    print(f"guard: {', '.join(refused)} on {device} under autograd: "
          + ("refused (NotImplementedError), nothing launched"
             if device != "cpu" else "the plain versions differentiate")
          + f"; {', '.join(trained)} record a gradient for every input "
          "(one forward and one backward each) ok")


# where each kernel's TPU twin is defined (file:line of the function that
# reaches pl.pallas_call)
REPLACES = {
    "fleet_mlp": "src/repro/kernels/fleet_mlp/kernel.py:34",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:65",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:53",
    "ssd_scan": "src/repro/kernels/mamba2_scan/kernel.py:63",
    "wkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:60",
    # no Pallas kernel defines a VJP: the reference trains through
    # jax.grad of attention_xla and of the scans' chunked forms, whose
    # backwards XLA compiles
    "flash_attention_backward": "src/repro/kernels/flash_attention/xla.py:14",
    "ssd_scan_backward": "src/repro/kernels/mamba2_scan/ref.py:60",
    "wkv6_scan_backward": "src/repro/kernels/rwkv6_scan/ref.py:37",
}
# the source of each row under src/repro_torch/kernels
SOURCE = {"fleet_mlp": "fleet_mlp/csrc/fleet_mlp.cu",
          "flash_attention": "flash_attention/csrc/flash_attention.cu",
          "decode_attention": "decode_attention/csrc/decode_attention.cu",
          "ssd_scan": "mamba2_scan/csrc/ssd_scan.cu",
          "wkv6_scan": "rwkv6_scan/csrc/wkv6_scan.cu",
          "flash_attention_backward": "flash_attention/csrc/flash_attention.cu",
          "ssd_scan_backward": "mamba2_scan/csrc/ssd_scan.cu",
          "wkv6_scan_backward": "rwkv6_scan/csrc/wkv6_scan.cu"}


def kernel_line(records: dict, launches: dict) -> dict:
    """The ``{"kernels": [...]}`` record: for each kernel its timed path
    case (``records``) and its launches on its main path (``launches``)."""
    rows = []
    for name in COUNT_NAMES:
        rec = records[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{SOURCE[name]}",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            **{key: rec.get(key) for key in
               ("library_ms", "graph_ms", "library_graph_ms", "f32_ms",
                "f32_graph_ms", "fwd_bwd_ms", "library_fwd_bwd_ms",
                "device_ms", "library_device_ms", "fwd_bwd_device_ms",
                "library_fwd_bwd_device_ms", "stats_ms", "stats_graph_ms",
                "stats_plain_ms", "stats_bound_ms", "stats_bound_by",
                "stats_max_abs_err", "stats_launches", "stats_shard_ms",
                "one_shot_ms", "one_shot_graph_ms", "per_rank")}})
    return {"kernels": rows}


def lm_path(arch: str, device: str, *, profile: bool = True,
            serve_kw=None, layers: int = 0) -> dict:
    """One language model's prefill and serve paths (and a profiler window
    over its engine), cut to ``layers`` layers where given; the model is
    freed before returning. Returns the prefill and serve records (the
    serve record without its engine); on a card the prefill record's
    ``peak_bytes`` is the peak from the draw through the prefill checks."""
    import torch
    if device != "cpu":    # what earlier phases left cached
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg, params = lm_params(arch, device, layers=layers)
    prefill = prefill_phase(device, cfg, params)
    prefill["peak_bytes"] = torch.cuda.max_memory_allocated() \
        if device != "cpu" else None
    serve = serve_phase(device, cfg, params, **(serve_kw or {}))
    eng = serve.pop("engine")
    if profile:
        prof = profile_decode(eng)
        if prof["device_ms_per_call"] is not None:
            print(f"serve: {cfg.name} device busy share "
                  f"{prof['device_ms_per_call'] / serve['decode_call_ms']:.3f}"
                  f" of a decode call (kernel time over the unprofiled mean)")
    del eng, params
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"cfg": cfg, "prefill": prefill, "serve": serve}


# the engine runs hold one request more than their slots, and request 0
# asks for half the new tokens, so its slot frees mid-run and the last
# request is admitted there beside live rows. The recurrent families' and
# the MoE models': 4 slots x 512 positions, 5 requests (two full waves of
# 8 took 24-28 s a model, host-bound, and the smoke must end within 1200
# s); qwen3-1.7b's: 8 slots x 2048 positions, 9 requests of 32 new tokens
# (16 took 55.7 s)
RECURRENT_SERVE = dict(slots=4, max_seq=512, n_requests=5,
                       prompt_lens=(16, 64), new_tokens=16, first_tokens=8)
QWEN_SERVE = dict(n_requests=9, first_tokens=16)
# the MoE models at full width, cut in depth for the card's memory: 8 of
# dbrx-132b's 40 layers (27.31e9 parameters, 54.6 GB in bf16) and one of
# llama4-maverick's 24 periods, a dense and an MoE layer (18.55e9, 37.1 GB)
MOE_LAYERS = {"dbrx-132b": 8, "llama4-maverick-400b-a17b": 2}
# the MoE phase's budget of smoke seconds, and its peak device memory
MOE_PHASE_SECONDS = 120.0
MOE_PEAK_BYTES = 72e9


def weight_bytes(cfg) -> int:
    """The bytes of every parameter a decode call must read, in the
    config's dtype: every leaf but an untied embedding table, of which a
    call reads one row a slot. The dispatch runs every expert on its
    capacity slots, so every expert's weights count."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.arch.params import tree_leaves
    specs = M.param_shape_structs(cfg, getattr(torch, cfg.dtype))
    return sum(t.numel() * t.element_size()
               for path, t in zip(_leaf_paths(specs), tree_leaves(specs))
               if path != "/embed" or cfg.tie_embeddings)


def moe_phase(device: str, layers=None, *, serve_kw=None,
              parity_seq: int = 256) -> dict:
    """Phase 13, the MoE block kind: each model of ``layers`` (arch ->
    depth) at full width through ``lm_path`` (prefill, the route checks,
    the engine, a profiler window), freed before the next is drawn; its
    parameter counts, peak device memory and the decode call against the
    floor its weight bytes set; then one f32 train step of each smoke
    config on the device against the CPU (``lm_train_parity``, aux and
    routes included). Within ``MOE_PHASE_SECONDS`` of smoke."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_config
    layers = layers or MOE_LAYERS
    t0 = time.perf_counter()
    out = {}
    for arch, depth in layers.items():
        rec = lm_path(arch, device, layers=depth,
                      serve_kw=serve_kw or RECURRENT_SERVE)
        cfg = rec["cfg"]
        full = get_config(arch)
        nbytes = weight_bytes(cfg)
        rec["floor_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        peak = None if device == "cpu" else max(
            rec["prefill"]["peak_bytes"], rec["serve"]["peak_bytes"])
        rec["peak_bytes"] = peak
        print(f"moe: {cfg.name} {cfg.num_layers} of {full.num_layers} layers "
              f"at full width: {M.param_count(cfg)} parameters, "
              f"{M.active_param_count(cfg)} active a token (the full "
              f"config: {M.param_count(full)}, {M.active_param_count(full)} "
              f"active); peak device memory "
              + (f"{peak} B (limit {MOE_PEAK_BYTES:.0f})" if peak is not None
                 else "not measured (cpu)"))
        print(f"moe: {cfg.name} decode call {rec['serve']['decode_call_ms']:.2f}"
              f" ms (the engine's mean, admission included), floor "
              f"{rec['floor_ms']:.2f} ms from weight bytes alone ({nbytes} B "
              f"over {HBM_BYTES_PER_S:.3g} B/s: every expert is read each "
              f"call)")
        check(peak is None or peak < MOE_PEAK_BYTES,
              f"moe: {cfg.name} peak device memory {peak} B")
        out[arch] = rec
    for arch in layers:
        cfg = get_config(arch.removesuffix("-smoke") + "-smoke")
        out[f"{arch}-parity"] = lm_train_parity(
            device, cfg.name, layers=cfg.num_layers, seq=parity_seq)
    secs = time.perf_counter() - t0
    print(f"moe: phase 13 in {secs:.1f} s (budget {MOE_PHASE_SECONDS:.0f})")
    check(device == "cpu" or secs <= MOE_PHASE_SECONDS,
          f"moe: phase 13 took {secs:.1f} s")
    out["seconds"] = secs
    return out



# ------------------------------------------------------- across devices

# phase 14 (a): decode_attention's stats route at the engine shapes of
# qwen3-1.7b (the path shape of (b)) and dbrx-132b, each cache also cut
# into 2, 4 and 8 sequence shards on the one card and the shards' partials
# recombined by the distributed flash-decode's combine; (label, B, S, H,
# KV, D)
STATS_CASES = [("qwen3", 8, 2048, 16, 8, 128), ("dbrx", 4, 512, 48, 8, 128)]
STATS_SHARDS = (2, 4, 8)
# (b): qwen3-1.7b decode steps at full width in an NCCL world of one, its
# attention through the distributed flash-decode (sequence extent 1),
# against the same steps undistributed
DIST_DECODE = dict(batch=8, max_seq=2048, steps=4)
# (c): the four forecasters' fleet bins on a mesh that names the card three
# times, 7 prosumers (pad 2), at the JAX package's test sizes; then the ANN
# score rollout at the flow's scoring shape on the same mesh
FLEET_MESH_HP = {"lr": ("LinearForecaster", {}),
                 "gam": ("GAMForecaster", {}),
                 "ann": ("ANNForecaster", {"hidden": 8, "epochs": 20}),
                 "lstm": ("LSTMForecaster", {"hidden": 8, "epochs": 20})}
FLEET_MESH_N = 7
MESH_ROLLOUT = dict(n=512, width=512)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def stats_bound(q, k_cache, lengths) -> dict:
    """The stats route's least time: q read once and the valid cache
    entries of k and v, the f32 outputs o (B, H, D), m and l (B, H)
    written once, against ``decode_bound``'s operations."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    valid = int(lengths.clamp(min=0, max=k_cache.shape[1]).sum())
    nbytes = (q.numel() + 2 * valid * KV * D) * q.element_size() \
        + 4 * (B * H * D + 2 * B * H) + lengths.numel() * 4
    return _bound(valid * H * 4 * D, nbytes, BF16_FLOP_PER_S)


def _stats_errors(got, want) -> tuple:
    """Errors of the stats route's ``(o, m, l)`` against the plain
    version's: ``|got - want| / (1 + |want|)`` for m and l, and for o in
    units of the row's denominator (``o / max(l, 1)``, the normalised
    output the combine makes of it): o is an unnormalised sum of up to S
    values, so an element near 0 carries the rounding of the whole sum.
    Returns ``({name: rel_err}, {name: max abs diff})``, o's diff in the
    same units."""
    import torch
    scale = torch.clamp_min(want[2], 1.0)[..., None]
    pairs = {"o": (got[0] / scale, want[0] / scale), "m": (got[1], want[1]),
             "l": (got[2], want[2])}
    return ({n: _rel_err(a, b) for n, (a, b) in pairs.items()},
            {n: float((a - b).abs().max()) for n, (a, b) in pairs.items()})


def stats_phase(device: str, cases=STATS_CASES, shards=STATS_SHARDS, *,
                time_it: bool) -> dict:
    """Phase 14 (a): ``decode_attention_partial`` (the stats route) against
    its plain version on the whole cache, with a length-0 row and a row
    that ends in the first of 8 shards; then the cache cut into
    ``shards`` sequence shards, each shard's partials from the stats route
    at its offset, recombined by ``combine_partials`` and held against the
    one-shot kernel and the plain version. With ``time_it`` the stats
    route on qwen3's whole cache (the path shape of (b)) and on one shard
    of each cut, beside the one-shot kernel, by CUDA events. Returns the
    path record (the qwen3 bf16 case)."""
    import torch
    from repro_torch.kernels.decode_attention.distributed import (
        _partial, combine_partials)
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_partial)
    from repro_torch.kernels.decode_attention.ref import (
        NEG_INF, decode_attention_partial_reference,
        decode_attention_reference)
    record = None
    for seed, (label, B, S, H, KV, D) in enumerate(cases):
        for dtype in ("bfloat16", "float32"):
            g = torch.Generator(device=device).manual_seed(300 + seed)
            dt = getattr(torch, dtype)
            q = torch.randn(B, H, D, generator=g, device=device).to(dt)
            kc, vc = (torch.randn(B, S, KV, D, generator=g,
                                  device=device).to(dt) for _ in range(2))
            lengths = torch.randint(1, S + 1, (B,), generator=g,
                                    device=device, dtype=torch.int32)
            lengths[0] = 0                         # an empty row
            lengths[1] = S // 8 // 2               # ends in the first shard
            live = lengths > 0
            got = decode_attention_partial(q, kc, vc, lengths)
            want = decode_attention_partial_reference(q, kc, vc, lengths)
            errs, diffs = _stats_errors(got, want)
            ok = max(errs.values()) <= ATTN_TOL[dtype] and all(
                bool(torch.isfinite(t).all()) for t in got) \
                and bool((got[1][0] == NEG_INF).all()) \
                and bool((got[2][0] == 0).all()) \
                and bool((got[0][0] == 0).all())
            print(f"decode_attention stats route {label} B={B} S={S} H={H} "
                  f"KV={KV} D={D} {dtype}: rel_err o/max(l, 1) {errs['o']:.3e} m "
                  f"{errs['m']:.3e} l {errs['l']:.3e} (tol "
                  f"{ATTN_TOL[dtype]:.0e}), the empty row m=-1e30 l=0 o=0 "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"stats route {label} {dtype} disagrees with its "
                      f"plain version: {errs}")
            one = decode_attention(q, kc, vc, lengths)
            plain = decode_attention_reference(q, kc, vc, lengths)
            for n in shards:
                S_loc = S // n
                parts = [_partial(q, kc[:, i * S_loc:(i + 1) * S_loc],
                                  vc[:, i * S_loc:(i + 1) * S_loc], lengths,
                                  i * S_loc) for i in range(n)]
                out = combine_partials(
                    *(torch.stack(t) for t in zip(*parts))).to(dt)
                e_one = _rel_err(out[live], one[live])
                e_plain = _rel_err(out[live], plain[live])
                ok = max(e_one, e_plain) <= ATTN_TOL[dtype] \
                    and not bool(torch.isnan(out).any()) \
                    and bool((out[0] == 0).all())
                print(f"decode_attention stats route {label} {dtype} in {n} "
                      f"shards of {S_loc}: recombined against the one-shot "
                      f"kernel {e_one:.3e}, against the plain version "
                      f"{e_plain:.3e} (tol {ATTN_TOL[dtype]:.0e}), no NaN, "
                      f"the empty row 0 {'ok' if ok else 'FAIL'}")
                check(ok, f"stats route {label} {dtype}: {n} shards "
                          f"recombined miss ({e_one:.3e}, {e_plain:.3e})")
            if (label, dtype) != (STATS_CASES[0][0], "bfloat16"):
                continue
            record = {"stats_max_abs_err": max(diffs.values()),
                **{f"stats_{k}": v for k, v in
                   stats_bound(q, kc, lengths).items()}}
            if not time_it:
                continue
            sets = _input_sets((q, kc, vc, lengths), record["stats_bytes"])
            rec = {}
            _timed(rec, sets, decode_attention_partial,
                   decode_attention_partial_reference, None, 50)
            record.update({f"stats_{k}": rec[k]
                           for k in ("ms", "plain_ms", "graph_ms")})
            record["one_shot_ms"] = _time_ms(decode_attention, sets, 50)
            record["one_shot_graph_ms"] = _time_ms(decode_attention, sets, 50,
                                                   graph=True)
            print(f"decode_attention stats route {label} time: "
                  f"{record['stats_ms']:.4f} ms/call eager, "
                  f"{record['stats_graph_ms']:.4f} ms by CUDA graph replay "
                  f"(the one-shot kernel {record['one_shot_ms']:.4f} / "
                  f"{record['one_shot_graph_ms']:.4f} ms on the same "
                  f"inputs); bound {record['stats_bound_ms']:.4f} ms by "
                  f"{record['stats_bound_by']} ({record['stats_bytes']} "
                  f"bytes); plain version {record['stats_plain_ms']:.4f} ms")
            record["stats_shard_ms"] = {}
            for n in shards:         # the first shard of each cut, alone
                S_loc = S // n
                local = lengths.clamp(0, S_loc)
                shard = (q, kc[:, :S_loc].contiguous(),
                         vc[:, :S_loc].contiguous(), local)
                b = stats_bound(*shard[:2], local)
                ssets = _input_sets(shard, b["bytes"])
                ms = _time_ms(decode_attention_partial, ssets, 50)
                gms = _time_ms(decode_attention_partial, ssets, 50,
                               graph=True)
                record["stats_shard_ms"][n] = {"ms": ms, "graph_ms": gms,
                                               "bound_ms": b["bound_ms"]}
                print(f"decode_attention stats route {label} one shard of "
                      f"{n} (S_loc {S_loc}): {ms:.4f} ms/call eager, "
                      f"{gms:.4f} ms by graph replay; bound "
                      f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
    return record


def dist_decode_phase(device: str, arch: str = "qwen3-1.7b", *,
                      layers: int = 0, batch: int = 8, max_seq: int = 2048,
                      steps: int = 4, seed: int = 14) -> dict:
    """Phase 14 (b): a world of one process (NCCL on the card, gloo on the
    CPU) on 127.0.0.1, a (1, 1) ("data", "model") mesh, and ``steps``
    decode steps of ``arch`` over seeded caches: ``decode_step(attn_dist=
    {"mesh": mesh})`` against ``decode_step`` from the same state, each
    step's logits held at the bf16 attention tolerance and the final caches
    too; the stats route's launches (one a layer a step) and none of the
    one-shot kernel's in the distributed steps. The world is destroyed
    before returning."""
    import torch
    import torch.distributed as dist
    from repro_torch.arch import model as M
    from repro_torch.arch.params import tree_leaves, tree_map
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.launch.mesh import make_mesh
    backend = "nccl" if device != "cpu" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg, params = lm_params(arch, device, layers=layers)
        g = torch.Generator(device=device).manual_seed(seed)
        state = M.init_decode_state(cfg, batch, max_seq, device=device)
        for t in tree_leaves(state["caches"]):
            t.normal_(generator=g)
        state["lengths"] = torch.randint(
            max_seq // 4, max_seq - steps, (batch,), generator=g,
            device=device, dtype=torch.int32)
        dstate = tree_map(lambda t: t.clone(), state)
        tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                            device=device)
        worst, secs = 0.0, {"plain": 0.0, "dist": 0.0}
        plain_calls = dist_calls = 0
        with torch.no_grad():
            # step 0 is compared and counted but not timed: the world's
            # first collective sets up its communicator
            for step in range(steps + 1):
                t = time.perf_counter()
                before = dec.invocation_count()
                want, state = M.decode_step(cfg, params, state,
                                            {"tokens": tok})
                plain_calls += dec.invocation_count() - before
                _sync(device)
                secs["plain"] += (time.perf_counter() - t) * (step > 0)
                t = time.perf_counter()
                b0, b1 = dec.invocation_count(), dec.partial_invocation_count()
                got, dstate = M.decode_step(cfg, params, dstate,
                                            {"tokens": tok},
                                            attn_dist={"mesh": mesh})
                check(dec.invocation_count() == b0,
                      "distributed decode ran the one-shot kernel")
                dist_calls += dec.partial_invocation_count() - b1
                _sync(device)
                secs["dist"] += (time.perf_counter() - t) * (step > 0)
                worst = max(worst, _rel_err(got, want))
                tok = want.argmax(-1, keepdim=True)
        # relative L2: only the written slots can differ, through hidden
        # states rounded to bf16 after attention outputs that may differ
        # in the last bit
        cache_err = max(_rel_l2(a, b) for a, b in
                        zip(tree_leaves(dstate["caches"]),
                            tree_leaves(state["caches"])))
        per_call = forward_launches(cfg)["flash_attention"]
        ok = worst <= ATTN_TOL["bfloat16"] \
            and cache_err <= ATTN_TOL["bfloat16"] \
            and torch.equal(dstate["lengths"], state["lengths"]) \
            and dist_calls == plain_calls == (steps + 1) * per_call
        print(f"distributed decode: {cfg.name} in a {backend} world of one, "
              f"mesh (1, 1), {steps + 1} steps x {batch} rows over {max_seq} "
              f"positions: logits against the undistributed step "
              f"{worst:.3e}, caches {cache_err:.3e} relative L2 (tol "
              f"{ATTN_TOL['bfloat16']:.0e}); stats-route launches "
              f"{dist_calls} ({per_call} a step), one-shot kernel launches "
              f"{plain_calls} in the undistributed steps; "
              f"{secs['dist'] / steps * 1e3:.2f} ms a distributed step, "
              f"{secs['plain'] / steps * 1e3:.2f} ms undistributed (the "
              f"last {steps}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"distributed decode of {cfg.name} disagrees: logits "
                  f"{worst:.3e}, caches {cache_err:.3e}, launches "
                  f"{dist_calls} / {plain_calls}")
        del params, state, dstate
        if device != "cpu":
            torch.cuda.empty_cache()
        return {"launches": dist_calls, "max_logit_err": worst,
                "step_ms": secs["dist"] / steps * 1e3}
    finally:
        dist.destroy_process_group()


def _sync(device: str) -> None:
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


def fleet_mesh_phase(device: str, *, n: int = FLEET_MESH_N,
                     rollout=MESH_ROLLOUT, horizon: int = HORIZON) -> dict:
    """Phase 14 (c): with the mesh module's devices set to the card named
    three times, each forecaster's fleet of ``n`` prosumers trained and
    scored sharded (mesh 3, pad ``(-n) % 3``) against the same fleet with
    ``user_params["mesh"] = "off"``: versions at rtol 5e-2 / atol 5e-3,
    forecasts at ``FLEET_RTOL`` / ``FLEET_ATOL``, one fleet call a bin.
    Then the ANN score rollout at ``rollout``'s shape on that mesh against
    the same rollout unsharded: the forecasts, and ``fleet_mlp`` once a
    shard a step."""
    import numpy as np
    import torch
    from repro_torch import forecast
    from repro_torch.forecast import ann
    from repro_torch.forecast.base import version_to_numpy
    from repro_torch.forecast.features import FeatureSpec
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.testing import (FLEET_ATOL, FLEET_RTOL,
                                     build_fleet_castor)
    dev = torch.device(device, 0) if device != "cpu" else torch.device("cpu")
    devices = (dev,) * 3
    pad = (-n) % 3
    original = mesh_mod.local_devices
    mesh_mod.local_devices = lambda: devices
    out = {}
    try:
        for kind, (cls_name, hp) in FLEET_MESH_HP.items():
            cls = getattr(forecast, cls_name)
            t = time.perf_counter()
            ca, fa = build_fleet_castor(kind, cls, hp, "auto", n=n,
                                        device=device)
            cb, fb = build_fleet_castor(kind, cls, hp, "off", n=n,
                                        device=device)
            secs = time.perf_counter() - t
            tele = all(b["sharded"] and b["mesh_devices"] == 3
                       and b["pad"] == pad and b["dispatches"] == 1
                       for b in fa.last_bin_stats) \
                and not any(b["sharded"] for b in fb.last_bin_stats)
            p_err = fc_err = 0.0
            close = True
            for i in range(n):
                name = f"s-Z_PRO_0_{i}"
                pa = version_to_numpy(ca.versions.get(name).params)["params"]
                pb = version_to_numpy(cb.versions.get(name).params)["params"]
                for k in pb:
                    a, b = np.asarray(pa[k], np.float64), \
                        np.asarray(pb[k], np.float64)
                    p_err = max(p_err, float(np.abs(a - b).max()))
                    close &= bool(np.allclose(a, b, rtol=5e-2, atol=5e-3))
                fa_, fb_ = (c.predictions.history(name)[0]
                            for c in (ca, cb))
                fc_err = max(fc_err, float(np.abs(fa_.values
                                                  - fb_.values).max()))
                close &= bool(np.allclose(fa_.values, fb_.values,
                                          rtol=FLEET_RTOL, atol=FLEET_ATOL))
                close &= bool(np.allclose(fa_.lower, fb_.lower,
                                          rtol=FLEET_RTOL, atol=FLEET_ATOL))
            ok = tele and close
            print(f"fleet mesh: {kind} {n} prosumers on [{dev}] x 3 (pad "
                  f"{pad}, one fleet call a bin) against no mesh: params "
                  f"max |diff| {p_err:.3e} (rtol 5e-2, atol 5e-3), "
                  f"forecasts {fc_err:.3e} (rtol {FLEET_RTOL:.0e}, atol "
                  f"{FLEET_ATOL:.0e}); both fleets in {secs:.1f} s "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"fleet mesh: {kind} sharded bins disagree or "
                      f"misreport: {fa.last_bin_stats}")
            out[kind] = {"params_err": p_err, "forecast_err": fc_err}
        # the ANN score rollout at the flow's scoring shape
        N, W = rollout["n"], rollout["width"]
        up = {**ann.ANNForecaster.DEFAULTS, "horizon": horizon}
        spec = FeatureSpec.from_params(up)
        F = spec.n_features
        stacked = ann._init_fleet(21, N, F, W, dev)
        g = np.random.default_rng(21)
        warm = max(spec.target_lags, spec.weather_lags) + 1
        y_hist = g.uniform(0.5, 3.0, (N, warm))
        stacked["y_scale"] = torch.as_tensor(y_hist.max(axis=1) * 1.2,
                                             dtype=torch.float32, device=dev)
        mu = torch.as_tensor(g.normal(0, 0.1, (N, F)), dtype=torch.float32,
                             device=dev)
        sd = torch.as_tensor(g.uniform(0.8, 1.2, (N, F)),
                             dtype=torch.float32, device=dev)
        temp_hist = g.normal(10, 5, (N, warm))
        temps_fut = g.normal(10, 5, (N, horizon))
        mesh = mesh_mod.make_fleet_mesh(3, devices=devices)
        args = (spec, up, stacked, mu, sd, y_hist, temp_hist, temps_fut,
                T0, horizon, dev)
        with torch.no_grad():
            want = ann.ANNForecaster._device_rollout(*args)
            reset_counts()
            t = time.perf_counter()
            got = ann.ANNForecaster._device_rollout(*args, mesh=mesh)
            secs = time.perf_counter() - t
        launches = counts()["fleet_mlp"]
        err = float(np.abs(got - want).max())
        ok = got.shape == (N, horizon) and bool(np.isfinite(got).all()) \
            and bool(np.allclose(got, want, rtol=FLEET_RTOL,
                                 atol=FLEET_ATOL)) \
            and launches == 3 * horizon
        print(f"fleet mesh: ANN score rollout N={N} width={W} over "
              f"{horizon} steps on [{dev}] x 3 against no mesh: forecasts "
              f"max |diff| {err:.3e} (rtol {FLEET_RTOL:.0e}, atol "
              f"{FLEET_ATOL:.0e}); fleet_mlp launches {launches} (3 shards "
              f"x {horizon} steps); {secs:.3f} s {'ok' if ok else 'FAIL'}")
        check(ok, f"fleet mesh: sharded ANN rollout {err:.3e}, launches "
                  f"{launches}")
        out["rollout"] = {"err": err, "launches": launches, "seconds": secs}
    finally:
        mesh_mod.local_devices = original
    return out


def across_devices_phase(device: str, *, time_it: bool = True,
                         decode_kw=None, fleet_kw=None) -> dict:
    """Phase 14, serving and scoring across devices: (a) the stats route,
    (b) the distributed decode in a world of one, (c) the sharded fleet."""
    t0 = time.perf_counter()
    stats = stats_phase(device, time_it=time_it)
    reset_counts()
    decode = dist_decode_phase(device, **(decode_kw or DIST_DECODE))
    fleet = fleet_mesh_phase(device, **(fleet_kw or {}))
    print(f"across devices: phase 14 in {time.perf_counter() - t0:.1f} s")
    return {"stats": stats, "decode": decode, "fleet": fleet}


# Queue 3 gap (a): the five dense configs the card had not run, at full
# width, cut in depth (layers) for the phase's time; each one prefill held
# against the port on the CPU (f32 there) and, for the decoders, an
# engine run of 4 requests
DENSE_GAP_LAYERS = {"llama3-8b": 2, "starcoder2-7b": 2, "internlm2-20b": 2,
                    "qwen2-vl-7b": 2, "hubert-xlarge": 2}
# the card's bf16 prefill against the CPU's f32 one at 2 layers: the bf16
# roundings of the card's GEMMs and attention, a few ulps (2^-8 each)
DENSE_GAP_TOL = PREFILL_DECODE_TOL


def dense_gap_phase(device: str, layers=None, *, seq: int = 64,
                    seed: int = 15) -> dict:
    """Each dense config of ``layers`` (arch -> depth) at full width: one
    ``forward`` (prefill for a decoder, the encoder's full forward for
    hubert-xlarge) of one seeded 64-token prompt, its ``flash_attention``
    launches, the warm time and the peak device memory; the same forward
    on the CPU in f32 from the same parameters, the last logits (all of
    hubert's) held at ``DENSE_GAP_TOL`` relative L2; then for the decoders
    ``serve_phase`` with 4 slots x 256 positions and 4 requests of 2 new
    tokens."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.arch.params import tree_map
    layers = layers or DENSE_GAP_LAYERS
    cuda = device != "cpu"
    out = {}
    for arch, depth in layers.items():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg, params = lm_params(arch, device, layers=depth)
        g = torch.Generator(device="cpu").manual_seed(seed)
        if cfg.frontend == "frames":
            batch = {"frames": torch.randn(1, seq, cfg.d_model, generator=g)}
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, seq),
                                             generator=g)}
        mode = "prefill" if cfg.is_decoder else "train"
        dev_batch = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            reset_counts()
            logits = M.forward(cfg, params, dev_batch, mode=mode)[0]
            launches = counts()
            _sync(device)
            t = time.perf_counter()
            M.forward(cfg, params, dev_batch, mode=mode)
            _sync(device)
            warm = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() if cuda else None
            cpu_cfg = cfg.replace(dtype="float32")
            cpu_params = tree_map(lambda x: x.to("cpu", torch.float32)
                                  if x.is_floating_point() else x.cpu(),
                                  params)
            want = M.forward(cpu_cfg, cpu_params, batch, mode=mode)[0]
        del cpu_params
        rel = _rel_l2(logits.float().cpu(), want)
        err = _rel_err(logits.float().cpu(), want)
        n_flash = forward_launches(cfg)["flash_attention"]
        ok = rel <= DENSE_GAP_TOL and bool(torch.isfinite(logits).all()) \
            and launches["flash_attention"] == n_flash
        print(f"dense: {cfg.name} at full width, {cfg.num_layers} layers "
              f"({M.param_count(cfg)} parameters), {mode} of 1 x {seq}: "
              f"flash_attention launches {launches['flash_attention']}, "
              f"warm {warm * 1e3:.2f} ms, peak device memory "
              + (f"{peak} B" if peak is not None else "not measured (cpu)")
              + f"; logits against the CPU in f32: rel L2 {rel:.3e} (tol "
              f"{DENSE_GAP_TOL:.0e}), max |diff|/(1+|ref|) {err:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"dense: {cfg.name} prefill misses the CPU ({rel:.3e}) or "
                  f"its launches {launches['flash_attention']} != {n_flash}")
        rec = {"rel_l2": rel, "err": err, "warm_s": warm, "peak_bytes": peak}
        if cfg.is_decoder:
            serve = serve_phase(device, cfg, params, slots=4, max_seq=256,
                                n_requests=4, prompt_lens=(16, 32),
                                new_tokens=2)
            serve.pop("engine")
            rec["serve"] = serve
        del params
        out[arch] = rec
    if cuda:
        torch.cuda.empty_cache()
    return out


# Phase 16: training across devices. (a) the train cell of qwen3-1.7b at
# full width and depth on a (1, 1) mesh in a world of one against the
# undistributed step, (b) with the int8 hook, (c) sharded checkpoint,
# elastic remesh, restore, supervised restart, (d) the dense configs'
# training, (e) the dry run's roofline against (a)'s step
SHARDED_TRAIN = dict(batch=4, seq=1024, steps=4)
# the card's (a)-(c) cell: qwen3-1.7b at full width cut to 14 of its 28
# layers (a 12.1e9 B state to checkpoint; the full depth's 20.6e9 B took
# 75 s to snapshot, write and restore), which keeps the smoke inside its
# time limit beside phase 20
SHARDED_TRAIN_LAYERS = 14
# the supervised restart: qwen3-1.7b at full width cut to 2 layers (a
# 4.9e9 B state, most of it the embedding's): two checkpoint writes and
# one restore through restore_latest(shardings=)
SUPERVISED = dict(arch="qwen3-1.7b", layers=2, steps=4, every=2, fail_at=3)
# gap (a): the five dense configs' training, at full width cut to 2
# layers: one f32 step card against CPU, then DENSE_TRAIN_STEPS bf16
# steps. A token model's loss must fall, and at 2 layers the first AdamW
# steps raise it: llama3-8b, starcoder2-7b and internlm2-20b first end
# below their first loss (by 1.8 or more) after 9 steps
DENSE_TRAIN_LAYERS = dict(DENSE_GAP_LAYERS)
DENSE_TRAIN_STEPS = 9
TRAIN_MESH_SECONDS = 240.0
# |compressed - (g + e)| per leaf, in units of the leaf's scale: half a
# code, plus the f32 roundings of x / scale and code x scale, a few ulps
# of max |deq| = 127 scale (2^-14 is 128 ulps of it)
COMPRESS_SLACK = 2.0 ** -14


def _world_of_one(device: str) -> str:
    """A process group of one rank on 127.0.0.1: NCCL on the card, gloo
    on the CPU."""
    import torch.distributed as dist
    backend = "nccl" if device != "cpu" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    return backend


def _locals(tree):
    """Every DTensor leaf's local block (in a world of one: the whole)."""
    from repro_torch.distributed.checkpoint import tree_map
    return tree_map(lambda t: t.to_local(), tree)


def _state_gaps(got, want) -> tuple:
    """(worst max |got - want| / max |want| over the leaves, leaves
    bit-equal, leaves): ``got`` on the device, ``want`` anywhere; a leaf
    at a time is moved to ``got``'s device."""
    import torch
    from repro_torch.distributed.checkpoint import flatten
    worst, same, n = 0.0, 0, 0
    for a, b in zip(flatten(got), flatten(want)):
        b = b.to(a.device)
        same += bool(torch.equal(a, b))
        n += 1
        if a.is_floating_point():
            worst = max(worst, float((a - b).abs().max()
                                     / (b.abs().max() + 1e-30)))
    return worst, same, n


def _bit_sums(t) -> tuple:
    """Two sums of a tensor's bits as integers (all of them, every other
    one): equal for bit-equal tensors, so a state can be compared without
    being kept."""
    import torch
    flat = t.reshape(-1)
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[flat.element_size()]
    bits = flat.view(as_int).to(torch.int64)
    return int(bits.sum()), int(bits[1::2].sum())


def _feedback_hook(record: list):
    """``FeedbackHook`` (``compress_with_feedback`` as a ``grad_hook``);
    per call, the worst leaf's |compressed - (g + e)| in units of its
    scale (max |deq| / 127) is appended to ``record``."""
    import torch
    from repro_torch.distributed.checkpoint import flatten
    from repro_torch.distributed.compression import FeedbackHook
    inner = FeedbackHook()

    def hook(grads):
        grads = inner(grads)
        record.append(max(
            float(e.abs().max() / (g.to(torch.float32).abs().max() / 127))
            for g, e in zip(flatten(grads), flatten(inner.error))
            if float(g.abs().max()) > 0))
        return grads
    return hook


def sharded_train_phase(device: str, arch: str = "qwen3-1.7b", *,
                        batch: int = 4, seq: int = 1024, steps: int = 4,
                        layers: int = 0, supervised=None, seed: int = 16,
                        must_fall: bool = True) -> dict:
    """Phase 16 (a)-(c) in a world of one (NCCL on the card) on 127.0.0.1,
    a (1, 1) ("data", "model") mesh: (a) ``arch`` (f32 masters, bf16
    compute, remat; cut to ``layers`` where given) through ``build_cell``'s
    train ``fn`` (``baseline_rules``) for ``steps`` steps, each from the
    same state as the undistributed ``make_train_step``: loss, grad norm
    and params within ``LM_PARITY_TOL``, the leaves bit-equal counted (the
    moments by sums of their bits: three states do not fit beside a
    step), each kernel's launches of ``train_launches`` a step, the step
    times, tokens/s and peak memory of both; (c) (a)'s state saved with
    ``CheckpointManager.save_async``, a mesh from ``elastic_remesh`` and
    the state restored onto it with ``shardings=``, bit-equal; (b) (a)
    again from its initial state on its batches with
    ``compress_with_feedback`` as the hook: finite losses, the last below
    the first (where ``must_fall``: a smoke model's loss barely moves in a
    few steps), every leaf within half a code; then (c) the supervised
    restart of ``supervised_restart``. The world is destroyed before
    returning."""
    import math
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.arch import model as M
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.synthetic import SyntheticTokenStream
    from repro_torch.distributed.checkpoint import CheckpointManager, flatten
    from repro_torch.distributed.fault import elastic_remesh
    from repro_torch.distributed.sharding import (baseline_rules, place,
                                                  place_tree)
    from repro_torch.launch.cells import build_cell, cell_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import init_state, make_train_step
    cuda = device != "cpu"
    t_phase = time.perf_counter()
    backend = _world_of_one(device)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        if cuda:
            torch.cuda.empty_cache()
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed),
            device=device)
        shape = ShapeSpec("phase16", seq, batch, "train")
        cell = build_cell(cfg, shape, mesh, rules=baseline_rules(),
                          microbatches=1)
        sh = cell_shardings(cell)
        state = place_tree((params, init_state(params)), sh[:2])
        del params
        undistributed = make_train_step(cfg)
        stream = SyntheticTokenStream(cfg.vocab_size, batch, seq,
                                      device=device)
        batches = [stream.next() for _ in range(steps)]
        # the world's first collective sets up its communicator
        dist.all_reduce(torch.zeros(1, device=device))
        per_step = train_launches(cfg)
        rows, secs, peaks = [], {"plain": [], "cell": []}, \
            {"plain": 0, "cell": 0}
        tol = LM_PARITY_TOL
        for i, b in enumerate(batches):
            plain = _locals(state)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            p_u, o_u, m_u = undistributed(plain[0], plain[1], b)
            loss_u = float(m_u["loss"])
            _sync(device)
            secs["plain"].append(time.perf_counter() - t)
            if cuda:
                peaks["plain"] = max(peaks["plain"],
                                     torch.cuda.max_memory_allocated())
            # the updated params stay on the card beside the cell's step;
            # the moments and step count are kept as sums of their bits
            want_bits = [_bit_sums(t) for t in flatten(o_u)]
            del o_u, plain
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.perf_counter()
            p_d, o_d, m_d = cell.fn(state[0], state[1], {
                k: place(v, *sh[2][k]) for k, v in b.items()})
            loss_d = float(m_d["loss"])
            _sync(device)
            secs["cell"].append(time.perf_counter() - t)
            got_counts = counts()
            if cuda:        # less the compared params held beside the step
                held = sum(t.numel() * t.element_size() for t in flatten(p_u))
                peaks["cell"] = max(peaks["cell"],
                                    torch.cuda.max_memory_allocated() - held)
            state = (p_d, o_d)
            worst, same, n = _state_gaps(_locals(p_d), p_u)
            moments = sum(_bit_sums(a) == w for a, w in
                          zip(flatten(_locals(o_d)), want_bits))
            del p_u, p_d, o_d
            rel = {"loss": abs(loss_d - loss_u) / abs(loss_u),
                   "grad_norm": abs(float(m_d["grad_norm"])
                                    - float(m_u["grad_norm"]))
                   / float(m_u["grad_norm"]), "params": worst}
            # bit-equal moments: a fault in how the cell hands its state
            # back would otherwise feed both sides of the next step alike
            ok = rel["loss"] <= tol["loss"] \
                and rel["grad_norm"] <= tol["grad_norm"] \
                and worst <= tol["grad"] and got_counts == per_step \
                and math.isfinite(loss_d) and moments == len(want_bits)
            print(f"sharded train step {i}: {cfg.name} cell on mesh (1, 1) "
                  f"against make_train_step from the same state: loss "
                  f"{loss_d:.6f} / {loss_u:.6f} (rel {rel['loss']:.2e}), "
                  f"grad norm rel {rel['grad_norm']:.2e}, params worst leaf "
                  f"{worst:.2e} of its max, {same}/{n} param leaves "
                  f"bit-equal, moments and step {moments}/{len(want_bits)} "
                  f"bit-equal (sums of their bits); {secs['cell'][-1]:.3f} s / "
                  f"{secs['plain'][-1]:.3f} s; launches " + ", ".join(
                      f"{k} {v}" for k, v in got_counts.items() if v)
                  + f" {'ok' if ok else 'FAIL'}")
            check(ok, f"sharded train step {i}: {rel}, moments and step "
                      f"{moments}/{len(want_bits)} bit-equal, launches "
                      f"{got_counts} (expected {per_step})")
            rows.append({"loss": loss_d, "loss_rel": rel["loss"],
                         "grad_norm_rel": rel["grad_norm"],
                         "params_rel": worst, "bit_equal": same == n
                         and moments == len(want_bits)})
        warm = {k: v[1:] or v for k, v in secs.items()}
        step_s = {k: sum(v) / len(v) for k, v in warm.items()}
        tokens = batch * seq
        print(f"sharded train: {cfg.name} ({cfg.num_layers} layers, "
              f"{M.param_count(cfg)} parameters) in a {backend} world of "
              f"one, B {batch} x S {seq}: {step_s['cell']:.3f} s a step "
              f"({tokens / step_s['cell']:.1f} tokens/s) through the cell, "
              f"{step_s['plain']:.3f} s ({tokens / step_s['plain']:.1f} "
              f"tokens/s) undistributed (mean of steps 1-{steps - 1}); peak "
              f"device memory "
              + (f"{peaks['cell']} B / {peaks['plain']} B (the cell's less "
                 f"the undistributed step's params held for the comparison)"
                 if cuda else
                 "not measured (cpu)")
              + f"; flash_attention {per_step['flash_attention']} forwards "
              f"and {per_step['flash_attention_backward']} backwards a step")
        check(not cuda or peaks["cell"] < TRAIN_PEAK_BYTES,
              f"sharded train: peak {peaks['cell']} B >= {TRAIN_PEAK_BYTES}")
        out = {"steps": rows, "step_s": step_s, "peak_bytes": peaks,
               "launches": per_step, "cfg": cfg,
               "tokens_per_s": tokens / step_s["cell"],
               "seconds_a": time.perf_counter() - t_phase}
        with tempfile.TemporaryDirectory() as td:
            # (c) save, remesh, restore
            mgr = CheckpointManager(f"{td}/ckpt", keep=1)
            t = time.perf_counter()
            mgr.save_async({"params": state[0], "opt": state[1]},
                           step=steps)
            t_snap = time.perf_counter() - t
            mgr.wait()
            t_save = time.perf_counter() - t
            new = elastic_remesh(model_axis=16)
            new_sh = cell_shardings(build_cell(cfg, shape, new,
                                               rules=baseline_rules(),
                                               microbatches=1))
            t = time.perf_counter()
            restored, manifest = mgr.restore_latest(
                {"params": state[0], "opt": state[1]},
                shardings={"params": new_sh[0], "opt": new_sh[1]})
            _sync(device)
            t_restore = time.perf_counter() - t
            pairs = list(zip(flatten(restored), flatten(
                {"params": state[0], "opt": state[1]})))
            same = all(torch.equal(a.to_local(), b.to_local())
                       for a, b in pairs)
            on_new = all(a.device_mesh == new for a, _ in pairs)
            nbytes = sum(a.to_local().numel() * a.to_local().element_size()
                         for a, _ in pairs)
            n_leaves = len(pairs)
            del pairs
            ok = same and on_new and manifest["step"] == steps \
                and tuple(new.shape) == (1, 1)
            print(f"checkpoint: {cfg.name} state ({nbytes} B, "
                  f"{n_leaves} leaves) saved sharded by save_async "
                  f"(host snapshot {t_snap:.1f} s, written {t_save:.1f} s), "
                  f"elastic_remesh -> mesh {tuple(new.shape)}, restored "
                  f"with shardings= in {t_restore:.1f} s: bit-equal "
                  f"{same}, on the new mesh {on_new} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, "checkpoint: the restore onto the new mesh differs")
            out["checkpoint"] = {"bytes": nbytes, "snapshot_s": t_snap,
                                 "save_s": t_save, "restore_s": t_restore}
        del state
        if cuda:
            torch.cuda.empty_cache()
        # (b) the int8 hook, from (a)'s initial state on (a)'s batches
        del restored
        record = []
        hooked = build_cell(cfg, shape, new, rules=baseline_rules(),
                            microbatches=1,
                            grad_hook=_feedback_hook(record))
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed),
            device=device)
        params, opt = place_tree((params, init_state(params)), new_sh[:2])
        losses = []
        for b in batches:
            params, opt, m = hooked.fn(params, opt, {
                k: place(v, *new_sh[2][k]) for k, v in b.items()})
            losses.append(float(m["loss"]))
        worst = max(record)
        ok = all(math.isfinite(x) for x in losses) \
            and (losses[-1] < losses[0] or not must_fall) \
            and worst <= 0.5 + COMPRESS_SLACK
        print(f"compressed train: {cfg.name} cell with compress_with_feedback "
              f"as grad_hook, {steps} steps from (a)'s initial state on its "
              f"batches: losses " + ", ".join(f"{x:.4f}" for x in losses)
              + " (uncompressed " + ", ".join(f"{r['loss']:.4f}"
                                              for r in rows)
              + f"); worst |compressed - (g + e)| {worst:.6f} of a leaf's "
              f"scale (bound {0.5 + COMPRESS_SLACK:.6f}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"compressed train: losses {losses}, error {worst}")
        out["compressed"] = {"losses": losses, "worst_of_scale": worst}
        del params, opt
        if cuda:
            torch.cuda.empty_cache()
        out["supervised"] = supervised_restart(
            device, **(supervised or SUPERVISED))
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def supervised_restart(device: str, arch: str, *, layers: int, steps: int,
                       every: int, fail_at: int, batch: int = 4,
                       seq: int = 1024, seed: int = 17) -> dict:
    """Phase 16 (c), in the open world of one: ``arch`` cut to ``layers``
    through a train cell on a mesh from ``elastic_remesh``,
    ``steps`` steps uninterrupted, then the same under
    ``TrainSupervisor.run(..., shardings=)`` with a checkpoint every
    ``every`` steps and a ``NodeFailure`` injected before step
    ``fail_at``: one failure, one restore, the final state equal to the
    uninterrupted run's (each step's batch chosen by the state's own
    step count, so a replayed step sees its batch again)."""
    import itertools
    import tempfile
    import torch
    from repro_torch.arch import model as M
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.synthetic import SyntheticTokenStream
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import (NodeFailure, TrainSupervisor,
                                               elastic_remesh)
    from repro_torch.distributed.sharding import (baseline_rules, place,
                                                  place_tree)
    from repro_torch.launch.cells import build_cell, cell_shardings
    from repro_torch.train import init_state
    cfg = get_config(arch).replace(num_layers=layers)
    mesh = elastic_remesh(model_axis=16)
    cell = build_cell(cfg, ShapeSpec("restart", seq, batch, "train"), mesh,
                      rules=baseline_rules(), microbatches=1)
    sh = cell_shardings(cell)
    stream = SyntheticTokenStream(cfg.vocab_size, batch, seq, device=device)
    batches = [{k: place(v, *sh[2][k]) for k, v in stream.next().items()}
               for _ in range(steps)]

    def fresh():
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed),
            device=device)
        return place_tree((params, init_state(params)), sh[:2])

    def run(state, _):
        done = int(state[1].step.to_local())
        if failures["left"] and done + 1 == fail_at:
            failures["left"] -= 1
            raise NodeFailure(f"injected before step {fail_at}")
        p, o, _ = cell.fn(state[0], state[1], batches[done])
        return (p, o)

    failures = {"left": 0}
    want = fresh()
    for _ in range(steps):
        want = run(want, None)
    want = _move(_locals(want), "cpu")
    failures["left"] = 1
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        sup = TrainSupervisor(CheckpointManager(f"{td}/ckpt", keep=2),
                              checkpoint_every=every)
        state, rep = sup.run(fresh(), itertools.repeat(None), run,
                             num_steps=steps, shardings=sh[:2])
    secs = time.perf_counter() - t
    worst, same, n = _state_gaps(_locals(state), want)
    ok = (rep.failures_handled, rep.restores, rep.final_step) \
        == (1, 1, steps) and worst <= LM_PARITY_TOL["grad"]
    print(f"supervised restart: {cfg.name} ({layers} layers, "
          f"{M.param_count(cfg)} parameters) on mesh {tuple(mesh.shape)}, "
          f"{steps} steps, checkpoints every {every}, a NodeFailure before "
          f"step {fail_at}: failures {rep.failures_handled}, restores "
          f"{rep.restores}, final step {rep.final_step}; against the "
          f"uninterrupted run worst leaf {worst:.2e}, {same}/{n} leaves "
          f"bit-equal; {secs:.1f} s {'ok' if ok else 'FAIL'}")
    check(ok, f"supervised restart: {rep}, worst leaf {worst}")
    del state
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"seconds": secs, "worst": worst, "bit_equal": same == n}


def dense_train_phase(device: str, layers=None, *, parity_seq: int = 256,
                      batch: int = 4, seq: int = 1024,
                      steps: int = DENSE_TRAIN_STEPS) -> dict:
    """Phase 16 (d), gap (a)'s training half: each dense config of
    ``layers`` (arch -> depth) at full width, one f32 step's loss, grad
    norm and gradients card against the CPU from the same params, drawn
    on the card (``lm_train_parity`` at ``LM_PARITY_TOL``, its launches;
    the update's arithmetic, which no config changes, is held at
    qwen3-1.7b in phase 9), then
    ``steps`` bf16 steps of ``lm_train_path`` (profile off): finite
    losses, a token model's last below its first (random labels need not
    fall), two ``flash_attention`` forwards and one backward a layer a
    step."""
    layers = layers or DENSE_TRAIN_LAYERS
    out = {}
    for arch, depth in layers.items():
        t = time.perf_counter()
        parity = lm_train_parity(device, arch, layers=depth, seq=parity_seq,
                                 gradients_only=True)
        t_parity = time.perf_counter() - t
        path = lm_train_path(device, arch, batch=batch, seq=seq,
                             steps=steps, layers=depth, profile=False)
        secs = time.perf_counter() - t
        print(f"dense train: {arch} at {depth} layers, parity and path in "
              f"{secs:.1f} s (the parity {t_parity:.1f} s)")
        out[arch] = {"parity": parity, "step_s": path["step_s"],
                     "peak_bytes": path["peak_bytes"],
                     "launches": path["launches"], "seconds": secs}
    return out


def dryrun_check(device: str, train: dict, *, batch: int = 4,
                 seq: int = 1024) -> dict:
    """Phase 16 (e): the dry run's count of (a)'s own cell on one device;
    its ``compute_s`` (operations over the card's peak) must not exceed
    (a)'s measured step, or the count is wrong. Then qwen3-1.7b
    ``train_4k`` on the production mesh (host only)."""
    import tempfile
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    cfg = train["cfg"]
    with tempfile.TemporaryDirectory() as td:
        own = dryrun.run_cell(cfg, ShapeSpec("phase16", seq, batch, "train"),
                              multi_pod=False, out_dir=td,
                              mesh=MeshShape((1, 1), ("data", "model")),
                              microbatches=1)
        prod = dryrun.run_cell("qwen3-1.7b", "train_4k", multi_pod=False,
                               out_dir=td)
    step = train["step_s"]["cell"]
    rl = own["roofline"]
    ok = rl["compute_s"] <= step
    mem = own["memory"]["peak_per_device_bytes"]
    print(f"dry run: {cfg.name} B {batch} x S {seq} on one device: "
          f"{own['cost']['flops']:.4e} flops, {own['cost']['bytes']:.4e} "
          f"bytes; roofline compute {rl['compute_s'] * 1e3:.2f} ms, memory "
          f"{rl['memory_s'] * 1e3:.2f} ms ({rl['card']}) against the "
          f"measured step {step * 1e3:.2f} ms "
          f"({rl['compute_s'] / step:.3f} of it); peak per device "
          f"{mem:.4e} B counted, "
          + (f"{train['peak_bytes']['cell']} B measured" if device != "cpu"
             else "not measured (cpu)")
          + f" {'ok' if ok else 'FAIL'}")
    check(ok, f"dry run: compute {rl['compute_s']} s > the measured step "
              f"{step} s: the count is wrong")
    r = prod["roofline"]
    print(f"dry run: qwen3-1.7b train_4k on the production mesh "
          f"{prod['mesh']}: {prod['cost']['flops']:.4e} flops a device, "
          f"microbatches {prod['microbatches']}, batch split "
          f"{prod['batch_split']}, peak "
          f"{prod['memory']['peak_per_device_bytes']:.4e} B a device; "
          f"compute {r['compute_s'] * 1e3:.2f} ms, memory "
          f"{r['memory_s'] * 1e3:.2f} ms, collectives "
          f"{r['collective_s'] * 1e3:.2f} ms, {r['dominant']}")
    return {"own": own, "production": prod}


def training_across_devices_phase(device: str, *, train_kw=None,
                                  dense_layers=None, dense_kw=None) -> dict:
    """Phase 16, training across devices: (a)-(c) ``sharded_train_phase``,
    (d) ``dense_train_phase``, (e) ``dryrun_check``; within
    ``TRAIN_MESH_SECONDS`` on the card."""
    t0 = time.perf_counter()
    kw = {**SHARDED_TRAIN, **(train_kw or {})}
    train = sharded_train_phase(device, **kw)
    t_train = time.perf_counter() - t0
    dense = dense_train_phase(device, dense_layers, **(dense_kw or {}))
    t_dense = time.perf_counter() - t0 - t_train
    dry = dryrun_check(device, train, batch=kw["batch"], seq=kw["seq"])
    secs = time.perf_counter() - t0
    print(f"training across devices: phase 16 in {secs:.1f} s (budget "
          f"{TRAIN_MESH_SECONDS:.0f}): (a) {train['seconds_a']:.1f} s, "
          f"(a)-(c) {t_train:.1f} s, (d) "
          f"{t_dense:.1f} s, (e) {secs - t_train - t_dense:.1f} s")
    check(device == "cpu" or secs <= TRAIN_MESH_SECONDS,
          f"phase 16 took {secs:.1f} s, over {TRAIN_MESH_SECONDS:.0f}")
    return {"train": train, "dense": dense, "dryrun": dry, "seconds": secs}


# ------------------------------------------------ the cells on their shards

# the attention kernels at one rank's heads on the pod mesh's model axis
# (16; qwen3-1.7b at 2 as well): (label, H, KV, D), the forward and
# backward at the training shape (B 4, S 1024, causal, bf16), decode at
# the engine shape (B 8, S 2048). internlm2-20b's group of 3 is one no
# earlier card run had; dbrx-132b's on a model axis of 2 (phase 18's
# world of two) is G 6 on each rank; zamba2-2.7b's shared block (H 32 =
# KV 32, D 80) on 16 model ranks and on 2 (phase 19's world of two)
# and the head slots of the mid-head configs on 16 model ranks:
# starcoder2-7b's 3 of H 36 and llama4-maverick's 3 of H 40 over one KV
# head (internlm2-20b's case), qwen2-vl-7b's slot of 2 of H 28 spanning
# KV heads 0 and 1 (G 7), llama4-maverick's last slot of one head
TP_HEADS = [("qwen3 tp2", 8, 4, 128), ("llama3 tp16", 2, 1, 128),
            ("internlm2 tp16", 3, 1, 128), ("dbrx tp2", 24, 4, 128),
            ("zamba2 shared tp16", 2, 2, 80),
            ("zamba2 shared tp2", 16, 16, 80),
            ("qwen2-vl tp16", 2, 2, 128),
            ("maverick tp16 last slot", 1, 1, 128)]
# the attention cases' shapes: training (B, S) and decode (Bd, Sd)
TP_SHAPES = dict(B=4, S=1024, Bd=8, Sd=2048)
# the SSD scan, forward and backward (bf16), at one rank's heads of
# zamba2-2.7b on the pod mesh's model axis of 16 (80 / 16 = 5): (label,
# B, S, H, P, N) at the train_4k cell's rows a device (16 x 4096) and the
# prefill_32k cell's (2 x 32768). The kernels launch a (H, B) grid (the
# reverse sweep (H, B, 2)): 80 and 10 blocks on the card's 132 SMs
TP_SSD = [("zamba2 train_4k tp16", 16, 4096, 5, 64, 64),
          ("zamba2 prefill_32k tp16", 2, 32768, 5, 64, 64)]
# the world of two on one card: qwen3-1.7b at full width cut to 2 layers
# (f32), a (1, 2) ("data", "model") mesh of two processes over gloo, its
# train step, prefill and decode cells against the world of one's calls
TP_WORLD = dict(arch="qwen3-1.7b", layers=2, batch=2, seq=256, cache=512,
                seed=26)
# tests/test_torch_sharded_train.py's pins (f32): loss, grad norm, the
# moments (of their leaf's max; the first step's are its gradients), the
# serve cells' logits and caches. The params after the step are held as
# phase 9 holds the card's step against the CPU's (``_update_excess``):
# no element past what the two sides' gradient differences allow. A
# fixed 2e-5 does not hold at full width: on an NVIDIA H100 80GB HBM3
# (700.00 W) it read 3.90e-5 where the two sides' gradients, equal to
# 5.5e-6 of their leaf's max, sit near AdamW's eps (1e-8), whose step
# g / (|g| + eps) they then steer
TP_WORLD_TOL = dict(loss=1e-5, grad_norm=1e-4, moment=1e-4,
                    update_excess=0.0, serve=2e-5)
TP_WORLD_SECONDS = 240.0
# the collectives the world of two's cells issue (a train step under
# baseline_rules, prefill and decode under serve_rules), each probed on
# the card's tensors first; and the reduce-scatter, which the cells issue
# under sp_rules and for FSDP shards (a data axis of more than one rank),
# probed and reported too
TP_COLLECTIVES = ("all_reduce", "all_reduce max", "all_gather")
TP_PROBED = TP_COLLECTIVES + ("reduce_scatter",)
# and the all-to-all of a split attention's head slots (phase 21), with
# uneven pieces and an empty one as the slots send them
SLOT_PROBED = TP_PROBED + ("all_to_all",)


def tp_kernel_phase(device: str, heads=TP_HEADS, *, time_it: bool,
                    shapes=None) -> dict:
    """``flash_attention`` (forward and backward) and ``decode_attention``
    at one rank's head counts (``TP_HEADS``: (label, H, KV, D), D 128
    where a case gives none) against their plain versions, with bounds
    and, where ``time_it``, times beside the plain version and
    ``scaled_dot_product_attention``; at ``shapes`` (``TP_SHAPES``'s
    keys) where given. Returns {kernel: [record]}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_reference)
    t0 = time.perf_counter()
    out = {"flash_attention": [], "flash_attention_backward": [],
           "decode_attention": []}
    shp = {**TP_SHAPES, **(shapes or {})}
    B, S, Bd, Sd, dtype = shp["B"], shp["S"], shp["Bd"], shp["Sd"], \
        "bfloat16"
    dt = torch.bfloat16
    for seed, (label, H, KV, *rest) in enumerate(heads):
        D = rest[0] if rest else 128
        g = torch.Generator(device=device).manual_seed(900 + seed)
        tag = f"{label} H={H} KV={KV} G={H // KV} D={D}"
        q, k, v, do = (torch.randn(B, S, n, D, generator=g,
                                   device=device).to(dt)
                       for n in (H, KV, KV, H))
        rec = _agree(f"flash_attention per rank {tag} B={B} S={S} D={D}",
                     flash_attention(q, k, v, causal=True),
                     attention_reference(q, k, v, causal=True), dtype)
        rec.update(label=label, H=H, KV=KV, D=D, **flash_bound(q, k, True))
        if time_it:
            sets = [(*s, *(t.transpose(1, 2) for t in s))
                    for s in _input_sets((q, k, v), rec["bytes"])]
            _timed(rec, sets,
                   lambda q, k, v, *_: flash_attention(q, k, v, causal=True),
                   lambda q, k, v, *_: attention_reference(q, k, v,
                                                           causal=True),
                   lambda *s: F.scaled_dot_product_attention(
                       *s[3:], is_causal=True, enable_gqa=True), 20)
            print(f"flash_attention per rank {label} time: "
                  + _times(rec, "scaled_dot_product_attention"))
        out["flash_attention"].append(rec)
        o, lse = _flash_with_lse(q, k, v, True)
        want = attention_backward_reference(q, k, v, o, lse, do, True)
        errs = [_agree(f"flash_attention_backward per rank {tag} {part}",
                       a, b, dtype)
                for part, a, b in zip(("dq", "dk", "dv"),
                                      _flash_backward(q, k, v, o, do, lse,
                                                      True), want)]
        rec = {"label": label, "H": H, "KV": KV, "D": D,
               "max_abs_err": max(e["max_abs_err"] for e in errs),
               "rel_err": max(e["rel_err"] for e in errs),
               **flash_backward_bound(q, k, True)}
        if time_it:
            sets = _input_sets((q, k, v, o, do, lse), rec["bytes"])
            kern = lambda *s: _flash_backward(*s, True)          # noqa: E731
            plain = lambda q, k, v, o, do, lse: \
                attention_backward_reference(q, k, v, o, lse, do, True)  # noqa: E731
            sdpa = [(F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), q, k, v, do)
                for q, k, v, do in (
                    tuple(t.transpose(1, 2).detach().requires_grad_(True)
                          for t in s[:3]) + (s[4].transpose(1, 2),)
                    for s in sets)]
            rec.update(
                ms=_time_ms(kern, sets, 10), plain_ms=_time_ms(plain, sets, 2),
                library_ms=_time_ms(lambda o, q, k, v, do: torch.autograd.grad(
                    o, (q, k, v), do, retain_graph=True), sdpa, 10),
                graph_ms=_time_ms(kern, sets, 10, graph=True))
            print(f"flash_attention_backward per rank {label} time: "
                  f"{rec['ms']:.4f} ms/call eager, {rec['graph_ms']:.4f} ms "
                  f"by CUDA graph replay, inputs cold in L2; bound "
                  f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                  f"({rec['bytes']} bytes, {rec['flops']} flop); plain "
                  f"backward {rec['plain_ms']:.4f} ms; "
                  f"scaled_dot_product_attention's backward "
                  f"{rec['library_ms']:.4f} ms")
        out["flash_attention_backward"].append(rec)
        qd = torch.randn(Bd, H, D, generator=g, device=device).to(dt)
        kc, vc = (torch.randn(Bd, Sd, KV, D, generator=g,
                              device=device).to(dt) for _ in range(2))
        lengths = torch.randint(1, Sd + 1, (Bd,), generator=g, device=device,
                                dtype=torch.int32)
        rec = _agree(f"decode_attention per rank {tag} B={Bd} S={Sd} D={D}",
                     decode_attention(qd, kc, vc, lengths),
                     decode_attention_reference(qd, kc, vc, lengths), dtype)
        rec.update(label=label, H=H, KV=KV, D=D,
                   **decode_bound(qd, kc, lengths))
        if time_it:
            mask = (torch.arange(Sd, device=device)[None, :]
                    < lengths[:, None])[:, None, None, :]
            sets = [(q_, k_, v_, n_, q_[:, :, None], k_.transpose(1, 2),
                     v_.transpose(1, 2)) for q_, k_, v_, n_ in
                    _input_sets((qd, kc, vc, lengths), rec["bytes"])]
            _timed(rec, sets,
                   lambda *s: decode_attention(*s[:4]),
                   lambda *s: decode_attention_reference(*s[:4]),
                   lambda *s: F.scaled_dot_product_attention(
                       *s[4:], attn_mask=mask, enable_gqa=True), 50)
            print(f"decode_attention per rank {label} time: "
                  + _times(rec, "scaled_dot_product_attention"))
        out["decode_attention"].append(rec)
    print(f"per-rank kernels: {len(heads)} head layouts in "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def tp_ssd_phase(device: str, cases=TP_SSD, *, time_it: bool) -> dict:
    """``ssd_scan`` forward and backward (bf16) at one rank's SSD heads
    (``TP_SSD``) against their plain versions (the chunked form and the
    plain backward) on the same inputs and a seeded output gradient, at
    ``SSD_TOL`` and ``SCAN_BWD_TOL``, with bounds (``ssd_bound``,
    ``scan_backward_bound``) and, where ``time_it``, times beside the
    plain versions (no single PyTorch call computes the scan). Returns
    {kernel: [record]}."""
    import torch
    from repro_torch.kernels.mamba2_scan.ops import ssd_scan
    from repro_torch.kernels.mamba2_scan.ref import (ssd_backward_reference,
                                                     ssd_chunked)
    t0 = time.perf_counter()
    out = {"ssd_scan": [], "ssd_scan_backward": []}
    dtype, chunk = "bfloat16", 64
    for seed, (label, B, S, H, P, N) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(950 + seed)
        dt_ = getattr(torch, dtype)
        x = torch.randn(B, S, H, P, generator=g, device=device).to(dt_)
        dt = _uniform(g, 1e-3, 0.1, (B, S, H), device)
        A = -_uniform(g, 0.5, 2.0, (H,), device)
        Bm, Cm = (torch.randn(B, S, 1, N, generator=g, device=device).to(dt_)
                  for _ in range(2))
        D = torch.randn(H, generator=g, device=device)
        dy = torch.randn(B, S, H, P, generator=g, device=device).to(dt_)
        inputs = (x, dt, A, Bm, Cm, D)
        tag = f"{label} B={B} S={S} H={H} P={P} N={N}"
        y, st = ssd_scan(*inputs, chunk=chunk)
        want_y, want_st = ssd_chunked(*inputs, chunk=chunk)
        rec = _agree(f"ssd_scan per rank {tag}", y, want_y, dtype, SSD_TOL)
        st_err = _agree(f"ssd_scan per rank {tag} state", st, want_st,
                        "float32", SSD_TOL)
        rec.update(label=label, B=B, S=S, H=H,
                   max_abs_err=max(rec["max_abs_err"],
                                   st_err["max_abs_err"]),
                   **ssd_bound(x, dt, Bm, D, chunk))
        del y, st, want_y, want_st
        if time_it:
            _timed(rec, _input_sets(inputs, rec["bytes"]),
                   lambda *a: ssd_scan(*a, chunk=chunk),
                   lambda *a: ssd_chunked(*a, chunk=chunk), None, 20)
            print(f"ssd_scan per rank {label} time: " + _times(
                rec, "no single PyTorch call computes the scan"))
        out["ssd_scan"].append(rec)
        got = _ssd_backward(*inputs, dy)
        want = ssd_backward_reference(*inputs, dy, None, None,
                                      chunk=chunk)[:6]
        errs = [_agree(f"ssd_scan_backward per rank {tag} {part}", a, b,
                       "float32" if b.dtype == torch.float32 else dtype,
                       SCAN_BWD_TOL)
                for part, a, b in zip(("dx", "ddt", "dA", "dBm", "dCm",
                                       "dD"), got, want)]
        rec = {"label": label, "B": B, "S": S, "H": H,
               "max_abs_err": max(e["max_abs_err"] for e in errs),
               "rel_err": max(e["rel_err"] for e in errs),
               **scan_backward_bound(inputs + (dy,), got,
                                     ssd_bound(x, dt, Bm, D, chunk)["flops"])}
        del got, want
        if time_it:
            sets = _input_sets(inputs + (dy,), rec["bytes"])
            _timed(rec, sets, _ssd_backward,
                   lambda *a: ssd_backward_reference(*a, None, None,
                                                     chunk=chunk)[:6],
                   None, 10)
            print(f"ssd_scan_backward per rank {label} time: " + _times(
                rec, "no single PyTorch call computes the backward"))
        out["ssd_scan_backward"].append(rec)
    print(f"per-rank scans: {len(cases)} cases in "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def _world_rank(rank: int, port: int, out_path: str, body, kw: dict,
                ranks: int) -> None:
    """One rank of a world of ``ranks`` gloo processes: ``body(rank,
    **kw)`` between the group's start and end, rank 0's result saved at
    ``out_path``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=ranks)
    try:
        try:
            res = body(rank, **kw)
        except BaseException:
            # every rank's own failure, not only the first the parent sees
            import traceback
            print(f"world rank {rank} of {ranks} failed:\n"
                  + traceback.format_exc(), file=sys.stderr, flush=True)
            raise
        # the rank's cached blocks back to the card while the other works
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(res, out_path)


def _world_of(body, kw: dict, seconds: float, name: str, ranks: int = 2):
    """Rank 0's result of ``body`` run in a world of ``ranks`` spawned
    gloo processes (``_world_rank``). Fails if the world runs past
    ``seconds``; kills any rank still alive when it ends."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/rank0.pt"
        ctx = mp.start_processes(_world_rank,
                                 args=(_free_port(), path, body, kw, ranks),
                                 nprocs=ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + seconds
        try:
            while not ctx.join(timeout=1.0):
                check(time.monotonic() < deadline,
                      f"{name}: still running after {seconds:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(5)
        return torch.load(path, weights_only=False)


def _collectives_report(tally: dict, acc: dict) -> tuple:
    """(whether a call's collectives ``tally`` ({name: (count, wire
    bytes)}) equal the dry run's ``acc``, the tally as text)."""
    same = set(tally) == set(acc) and all(
        tally[k][0] == n and abs(tally[k][1] - w) <= 1e-9 * w + 1e-6
        for k, (n, w) in acc.items())
    return same, ", ".join(f"{k} {n} ({w:.0f} B on the wire)"
                           for k, (n, w) in sorted(tally.items()))


def _probe_collectives(device: str, names=TP_PROBED) -> dict:
    """Each collective of ``names`` on ``device``'s tensors in the world:
    {name: the error it raised} for each one refused."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (all_gather_along,
                                                  all_to_all_last,
                                                  reduce_scatter_along)
    n, r = dist.get_world_size(), dist.get_rank()
    # rank r sends r + 1 elements to each rank but the last, none to it
    send = [r + 1] * (n - 1) + [0]
    recv = [s + 1 for s in range(n)] if r < n - 1 else [0] * n
    probes = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(4, device=device)),
        "all_reduce max": lambda: dist.all_reduce(
            torch.ones(4, device=device), op=dist.ReduceOp.MAX),
        "all_gather": lambda: all_gather_along(
            torch.ones(2, 3, device=device), 1, None, n),
        "reduce_scatter": lambda: reduce_scatter_along(
            torch.ones(2, 2 * n, device=device), 1, None, n),
        "all_to_all": lambda: check(torch.equal(
            all_to_all_last(torch.full((2, sum(send)), float(r),
                                       device=device), send, recv, None),
            torch.cat([torch.full((2, k), float(s), device=device)
                       for s, k in enumerate(recv)], 1)),
            "the all-to-all probe moved the wrong pieces")}
    refused = {}
    for name in names:
        try:
            probes[name]()
            _sync(device)
        except Exception as e:    # noqa: BLE001  (reported, then the world
            refused[name] = (f"{type(e).__name__}: "     # is not used)
                             f"{str(e).splitlines()[0][:200]}")
    return refused


def _tp_world_body(rank: int, *, device: str, arch: str, layers: int,
                   batch: int, seq: int, cache: int, seed: int) -> dict:
    """The world of two's work: the probe, then (where no collective the
    cells issue was refused) a train step, a prefill and a decode step
    (with and without the distributed flash-decode) through the cells on
    a (1, 2) mesh, each held on rank 0 against the undistributed call on
    the same inputs (the world of one: the (1, 1) cell is bit-equal to it,
    phase 16 (a))."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.checkpoint import flatten, tree_map
    from repro_torch.distributed.sharding import (baseline_rules,
                                                  gather_whole, place,
                                                  place_tree, serve_rules)
    from repro_torch.launch.cells import build_cell, cell_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import (AdamWConfig, init_state, make_decode_step,
                                   make_prefill_step, make_train_step)
    if device != "cpu":
        torch.cuda.set_device(0)
    out = {"refused": _probe_collectives(device)}
    if set(out["refused"]) & set(TP_COLLECTIVES):
        return out
    mesh = make_mesh((1, 2), ("data", "model"), device_type=device)
    cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
    g = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, g, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=g,
                           device=device, dtype=torch.int32)
    b = {"tokens": tokens[:, :-1].contiguous(),
         "labels": tokens[:, 1:].contiguous()}
    whole_tree = lambda t: tree_map(gather_whole, t)        # noqa: E731
    # (a) a train step through the cell
    cell = build_cell(cfg, ShapeSpec("tp", seq, batch, "train"), mesh,
                      rules=baseline_rules(), microbatches=1)
    sh = cell_shardings(cell)
    state = place_tree((params, init_state(params)), sh[:2])
    _sync(device)
    reset_counts()
    t = time.perf_counter()
    p_d, o_d, m_d = cell.fn(state[0], state[1],
                            {k: place(v, *sh[2][k]) for k, v in b.items()})
    _sync(device)
    out["train_s"] = time.perf_counter() - t
    out["launches"] = {"train": counts()}
    p_d, mu_d, nu_d = (whole_tree(x) for x in (p_d, o_d.mu, o_d.nu))
    del state
    # (b) prefill and decode through the serve cells (weights stationary)
    rules = serve_rules()
    pre = build_cell(cfg, ShapeSpec("tp", seq, batch, "prefill"), mesh,
                     rules=rules, serve_dtype="float32")
    p_sh = cell_shardings(pre)
    served = place_tree(params, p_sh[0])
    with torch.no_grad():
        reset_counts()
        t = time.perf_counter()
        logits, _ = pre.fn(served, {"tokens": place(b["tokens"],
                                                    *p_sh[1]["tokens"])})
        _sync(device)
        out["prefill_s"] = time.perf_counter() - t
        out["launches"]["prefill"] = counts()
        pre_logits = gather_whole(logits)
        dstate = M.init_decode_state(cfg, batch, cache, device=device)
        dstate["caches"] = tree_map(
            lambda x: torch.randn(x.shape, generator=g, device=device),
            dstate["caches"])
        dstate["lengths"] = torch.randint(1, cache, (batch,), generator=g,
                                          device=device, dtype=torch.int32)
        nxt = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                            device=device, dtype=torch.int32)
        dec = {}
        for dist_decode in (False, True):
            cell_d = build_cell(cfg, ShapeSpec("tp", cache, batch, "decode"),
                                mesh, rules=rules, dist_decode=dist_decode,
                                serve_dtype="float32")
            _, s_sh, b_sh = cell_shardings(cell_d)
            placed = {"caches": place_tree(tree_map(torch.clone,
                                                    dstate["caches"]),
                                           s_sh["caches"]),
                      "lengths": place(dstate["lengths"], *s_sh["lengths"])}
            reset_counts()
            t = time.perf_counter()
            lg, new = cell_d.fn(served, placed,
                                {"tokens": place(nxt, *b_sh["tokens"])})
            _sync(device)
            out["launches"][f"decode dist={dist_decode}"] = {
                **counts(), "decode_attention_partial": _kernel_ops()[
                    "decode_attention"].partial_invocation_count()}
            dec[dist_decode] = {"s": time.perf_counter() - t,
                                "logits": gather_whole(lg),
                                "caches": whole_tree(new["caches"])}
    if rank:
        return out
    # the world of one on rank 0: the undistributed calls
    opt = AdamWConfig()
    p_u, o_u, m_u = make_train_step(cfg)(params, init_state(params), b)
    # the first step's clipped gradients, from the moments (mu = (1 - b1)
    # s g): each side's own clip scale is in them
    grads = [tree_map(lambda m: m / (1 - opt.b1), mu) for mu in (mu_d,
                                                                 o_u.mu)]
    out["train"] = {
        "loss": (float(m_d["loss"]), float(m_u["loss"])),
        "grad_norm": (float(m_d["grad_norm"]), float(m_u["grad_norm"])),
        "params": max(float((a - c).abs().max()) for a, c in
                      zip(flatten(p_d), flatten(p_u))),
        "update_excess": _update_excess(p_d, p_u, *grads, params, opt,
                                        (0.0, 0.0)),
        "moments": max(float((a - b_).abs().max() / b_.abs().max())
                       for a, b_ in zip(flatten((mu_d, nu_d)),
                                        flatten((o_u.mu, o_u.nu))))}
    with torch.no_grad():
        want, _ = make_prefill_step(cfg)(params, {"tokens": b["tokens"]})
        out["prefill"] = float((pre_logits - want).abs().max())
        out["decode"] = {}
        for dist_decode, d in dec.items():
            st = tree_map(torch.clone, dstate)
            wl, wn = make_decode_step(cfg)(params, st, {"tokens": nxt})
            out["decode"][dist_decode] = {
                "s": d["s"], "logits": float((d["logits"] - wl).abs().max()),
                "caches": max(float((a - c).abs().max()) for a, c in
                              zip(flatten(d["caches"]),
                                  flatten(wn["caches"])))}
    return out


def tp_world_phase(device: str, **kw) -> dict:
    """The cells on their shards in a world of two processes on one card
    (gloo: NCCL takes one rank a device): each collective the cells issue
    probed on the card's tensors, then, where none was refused,
    ``_tp_world_body``'s train, prefill and decode cells against the
    world of one, at ``TP_WORLD_TOL``. A refused collective is printed
    and the world of one (phase 16 (a)) stands alone."""
    t0 = time.perf_counter()
    kw = {**TP_WORLD, **kw, "device": device}
    res = _world_of(_tp_world_body, kw, TP_WORLD_SECONDS, "world of two")
    secs = time.perf_counter() - t0
    for name, why in res["refused"].items():
        print(f"world of two: gloo refused {name} on {device} tensors "
              f"({why})" + ("; the world of one (phase 16 (a)) stands alone"
                            if name in TP_COLLECTIVES else
                            "; the cells issue it under sp_rules and for "
                            "FSDP shards, which this world does not run"))
    print(f"world of two: gloo took "
          + ", ".join(n for n in TP_PROBED if n not in res["refused"])
          + f" on {device} tensors")
    if set(res["refused"]) & set(TP_COLLECTIVES):
        print(f"world of two: {secs:.1f} s")
        return {"refused": res["refused"], "seconds": secs}
    tol, tr = TP_WORLD_TOL, res["train"]
    rel = lambda pair: abs(pair[0] - pair[1]) / abs(pair[1])  # noqa: E731
    ok = rel(tr["loss"]) <= tol["loss"] \
        and rel(tr["grad_norm"]) <= tol["grad_norm"] \
        and tr["update_excess"] <= tol["update_excess"] \
        and tr["moments"] <= tol["moment"]
    where = "the CPU" if device == "cpu" else "one card"
    print(f"world of two: {kw['arch']} ({kw['layers']} layers, f32) on a "
          f"(1, 2) mesh of two gloo processes on {where}, B "
          f"{kw['batch']} x S {kw['seq']}: train step through the cell "
          f"{res['train_s']:.3f} s, loss {tr['loss'][0]:.6f} / "
          f"{tr['loss'][1]:.6f} (rel {rel(tr['loss']):.2e}), grad norm rel "
          f"{rel(tr['grad_norm']):.2e}, moments (the first step's "
          f"gradients) worst {tr['moments']:.2e} of their max, params worst "
          f"{tr['params']:.2e} with {tr['update_excess']:.2e} past what "
          f"the gradient differences allow, against the world of one "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"world of two: the train cell differs from the world of one: "
              f"{tr}")
    ok_serve = res["prefill"] <= tol["serve"] and all(
        d["logits"] <= tol["serve"] and d["caches"] <= tol["serve"]
        for d in res["decode"].values())
    print(f"world of two: prefill ({res['prefill_s']:.3f} s) logits max "
          f"|diff| {res['prefill']:.2e}; decode "
          + ", ".join(f"{'distributed' if k else 'gathered cache'} "
                      f"({d['s']:.3f} s) logits {d['logits']:.2e} caches "
                      f"{d['caches']:.2e}" for k, d in res["decode"].items())
          + f" against the world of one (atol {tol['serve']:.0e}) "
          f"{'ok' if ok_serve else 'FAIL'}; {secs:.1f} s in all")
    check(ok_serve, f"world of two: the serve cells differ: {res}")
    print("world of two: launches on rank 0 at its shards' head counts: "
          + "; ".join(f"{call} " + ", ".join(f"{k} {v}" for k, v in
                                             n.items() if v)
                      for call, n in res["launches"].items()))
    return {**res, "seconds": secs}


# ------------------------------------------------ the MoE cells on their expert shards

# phase 18: dbrx-132b at full width (d 6144, 16 experts of d_ff 10752, H 48
# / KV 8, vocab 100,352) cut to one layer, f32 (about 18.0e9 B of
# parameters: 12.68e9 experts, 4.93e9 embedding and head, 0.35e9
# attention), in a world of two gloo processes on the one card: its
# gradients under baseline_rules on a (1, 2) ("data", "model") mesh (EP:
# 8 experts a rank) and its prefill and decode cells under serve_rules on
# (1, 2) and on (2, 1) (each expert's columns over ``data``: the expert
# buffer's groups gathered, its products reduce-scattered), each against
# the world of one on the same inputs. A full AdamW step holds params,
# gradients and two moments, about 72e9 B over the two ranks: the card
# phase takes the gradients alone (``make_sharded_grad_fn``), about 36e9
# B; the update on the expert shards is held on the CPU
# (tests/test_torch_expert_parallel.py). The world of one runs first on
# rank 0 and moves its figures to the host before the ranks draw their
# shards, each leaf drawn whole and cut, so no rank holds the whole layer
# beside its shards
EP_WORLD = dict(arch="dbrx-132b", layers=1, batch=2, seq=256, cache=512,
                seed=27)
EP_WORLD_SECONDS = 150.0
# the gradient pins are phase 16 (d)'s (``LM_PARITY_TOL``: loss, grad norm,
# each leaf's max |diff| over its max |ref|); the serve cells' logits and
# caches phase 17's (``TP_WORLD_TOL["serve"]``, absolute)
EP_SERVE_MESHES = ((1, 2), (2, 1))
# a gradient block a rank sends to rank 0 for the comparison, in pieces
# of at most this many elements (gloo sends each piece whole)
EP_SEND_ELEMS = 1 << 26


def _draw_blocks(cfg, seed: int, device: str, shardings):
    """The parameters ``init_params`` draws from a generator seeded
    ``seed`` on ``device``, each leaf drawn whole and only this rank's
    block at ``shardings`` (``param_shardings``'s tree) kept, as DTensors:
    no rank holds more than one whole leaf beside its blocks."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.arch import model as M
    from repro_torch.arch.params import _init_leaf
    from repro_torch.distributed.sharding import contiguous_stride, local_block
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(spec, sh):
        if isinstance(spec, dict):
            return {k: draw(spec[k], sh[k]) for k in sorted(spec)}
        whole = _init_leaf(spec, g, torch.float32, torch.device(device))
        mesh, pls = sh
        block = local_block(whole, mesh, pls).clone()
        del whole
        return DTensor.from_local(block, mesh, pls, run_check=False,
                                  shape=torch.Size(spec.shape),
                                  stride=contiguous_stride(spec.shape))
    return draw(M.build_param_specs(cfg), shardings)


def _peak(device: str):
    import torch
    return torch.cuda.max_memory_allocated() if device != "cpu" else None


def _reset_peak(device: str) -> None:
    import torch
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()


def _free(device: str) -> None:
    import gc
    import torch
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def _ep_world_of_one(cfg, device, seed, b, dstate, nxt, groups) -> dict:
    """Rank 0's undistributed calls: the gradients (to the host), loss and
    grad norm of one step, prefill and a decode step, with their routes,
    times and peak memory; then prefill and decode again row by row
    (``"by_row"``: each row is one of the ``groups`` token groups, so the
    same function), the reference of the cells whose ranks each hold
    one row, at their GEMMs' row counts."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.distributed.checkpoint import tree_map
    from repro_torch.train import make_decode_step, make_prefill_step
    from repro_torch.train.optim import global_norm
    from repro_torch.train.step import _unflatten, make_grad_fn
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device)
    grad_fn = make_grad_fn(cfg, moe_groups=groups)
    t = time.perf_counter()               # a first call maps its memory
    grad_fn(params, [b])
    _sync(device)
    cold = time.perf_counter() - t
    _reset_peak(device)
    out = {}
    with _recorded_routes() as routes:
        t = time.perf_counter()
        grads, m = grad_fn(params, [b])
        norm = global_norm(_unflatten(params, grads))
        _sync(device)
        out["train"] = {"s": time.perf_counter() - t, "cold_s": cold,
                        "loss": float(m["loss"]), "grad_norm": float(norm),
                        "peak": _peak(device), "routes": list(routes)}
    out["grads"] = [g.cpu() for g in grads]
    del grads
    _free(device)
    with torch.no_grad():
        _reset_peak(device)
        with _recorded_routes() as routes:
            t = time.perf_counter()
            logits, state = make_prefill_step(cfg, moe_groups=groups)(
                params, {"tokens": b["tokens"]})
            _sync(device)
            out["prefill"] = {"s": time.perf_counter() - t,
                              "logits": logits.cpu(),
                              "caches": tree_map(lambda x: x.cpu(),
                                                 state["caches"]),
                              "peak": _peak(device), "routes": list(routes)}
        del state
        _reset_peak(device)
        with _recorded_routes() as routes:
            st = tree_map(torch.clone, dstate)
            t = time.perf_counter()
            logits, new = make_decode_step(cfg, moe_groups=groups)(
                params, st, {"tokens": nxt})
            _sync(device)
            out["decode"] = {"s": time.perf_counter() - t,
                             "logits": logits.cpu(),
                             "caches": tree_map(lambda x: x.cpu(),
                                                new["caches"]),
                             "peak": _peak(device), "routes": list(routes)}
        rows, n = [], b["tokens"].shape[0]
        for i in range(n):
            one = lambda t: t.narrow(1, i, 1)         # noqa: E731
            lg, state = make_prefill_step(cfg, moe_groups=groups // n)(
                params, {"tokens": b["tokens"][i:i + 1]})
            st = {"caches": tree_map(lambda x: one(x).clone(),
                                     dstate["caches"]),
                  "lengths": dstate["lengths"][i:i + 1].clone()}
            dl, new = make_decode_step(cfg, moe_groups=groups // n)(
                params, st, {"tokens": nxt[i:i + 1]})
            rows.append({"prefill": (lg.cpu(), tree_map(
                lambda x: x.cpu(), state["caches"])),
                "decode": (dl.cpu(), tree_map(lambda x: x.cpu(),
                                              new["caches"]))})
        out["by_row"] = {k: {"logits": torch.cat([r[k][0] for r in rows]),
                             "caches": _cat_rows([r[k][1] for r in rows])}
                         for k in ("prefill", "decode")}
    del params, st, new, state
    _free(device)
    return out


def _cat_rows(trees: list):
    """Cache trees of one row each, their rows (dim 1) concatenated."""
    import torch
    if isinstance(trees[0], dict):
        return {k: _cat_rows([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees, 1)


def _rows_of(calls: list, mesh) -> list:
    """Recorded routes (whole batch) cut to this rank's rows on ``mesh``
    (the rows split over ``data``)."""
    names = tuple(mesh.mesh_dim_names)
    n = mesh.shape[names.index("data")]
    r = mesh.get_coordinate()[names.index("data")]
    out = []
    for c in calls:
        k = c["idx"].shape[0] // n
        out.append({key: v[r * k:(r + 1) * k] for key, v in c.items()})
    return out


def _ep_world_body(rank: int, *, device: str, arch: str, layers: int,
                   batch: int, seq: int, cache: int, seed: int) -> dict:
    """The world of two's work (``ep_world_phase``): the probe, rank 0's
    world of one, then the cells on their expert shards, each call's
    collectives, launches, time, peak memory and routes recorded."""
    import torch
    import torch.distributed as dist
    from _torch_dist_worker import CollectiveLog, _count, _leaves, _tally
    from repro_torch.arch import model as M
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.checkpoint import tree_map
    from repro_torch.distributed.sharding import (baseline_rules,
                                                  gather_whole, place,
                                                  place_tree, serve_rules)
    from repro_torch.launch.cells import (build_cell, cell_shardings,
                                          make_sharded_grad_fn)
    from repro_torch.launch.mesh import make_mesh
    if device != "cpu":
        torch.cuda.set_device(0)
    refused = _probe_collectives(device)
    check(not refused, f"world of two: gloo refused {refused} on {device} "
                       "tensors, which the MoE cells issue")
    cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
    g = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=g,
                           device=device, dtype=torch.int32)
    b = {"tokens": tokens[:, :-1].contiguous(),
         "labels": tokens[:, 1:].contiguous()}
    dstate = M.init_decode_state(cfg, batch, cache, device=device)
    dstate["caches"] = tree_map(
        lambda x: torch.randn(x.shape, generator=g, device=device),
        dstate["caches"])
    dstate["lengths"] = torch.randint(1, cache, (batch,), generator=g,
                                      device=device, dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                        device=device, dtype=torch.int32)
    groups = 2                                 # the cells' (the mesh size)
    one = _ep_world_of_one(cfg, device, seed, b, dstate, nxt, groups) \
        if rank == 0 else None
    ref_routes = [None]
    if rank == 0:
        ref_routes = [{k: one[k]["routes"] for k in ("train", "prefill",
                                                     "decode")}]
    dist.broadcast_object_list(ref_routes, src=0)
    ref_routes = ref_routes[0]
    meshes = {s: make_mesh(s, ("data", "model"), device_type=device)
              for s in ((1, 2),) + EP_SERVE_MESHES}
    log = CollectiveLog()
    calls = {}

    def run(label, cell, fn, ref, mesh, pinned=None, warm=False):
        """One call of ``fn`` with its collectives, launches, time, peak
        and routes recorded (``pinned``: the world of one's routes), the
        ranks starting together; with ``warm``, after an untimed first
        call (its time kept as ``cold_s``)."""
        cold = None
        if warm:
            dist.barrier()
            t = time.perf_counter()
            fn()
            _sync(device)
            cold = time.perf_counter() - t
        _sync(device)
        dist.barrier()
        _reset_peak(device)
        reset_counts()
        with _recorded_routes(pinned) as routes:
            log.on = True
            t = time.perf_counter()
            res = fn()
            _sync(device)
            secs = time.perf_counter() - t
            log.on = False
        rec = {"s": secs, "cold_s": cold, "peak": _peak(device),
               "tally": _tally(log.take()),
               "account": _count(cell), "launches": {
                   **{k: v for k, v in counts().items() if v},
                   "decode_attention_partial": _kernel_ops()[
                       "decode_attention"].partial_invocation_count()},
               "routes": {"want": _flat(_rows_of(ref, mesh)),
                          "got": _flat(list(routes))}}
        rec["route_diff"] = int((rec["routes"]["want"]["idx"]
                                 != rec["routes"]["got"]["idx"]).sum())
        if pinned is None:
            calls[label] = rec
        return res, rec

    try:
        # (a) the gradients on the expert shards
        mesh = meshes[(1, 2)]
        cell = build_cell(cfg, ShapeSpec("ep", seq, batch, "train"), mesh,
                          rules=baseline_rules(), microbatches=1)
        p_sh, _, b_sh = cell_shardings(cell)
        params = _draw_blocks(cfg, seed, device, p_sh)
        grads_of = make_sharded_grad_fn(cfg, mesh, baseline_rules(),
                                        moe_groups=mesh.size())
        placed = {k: place(v, *b_sh[k]) for k, v in b.items()}
        (grads, m), _ = run("train", cell, lambda: grads_of(params, placed),
                            ref_routes["train"], mesh, warm=True)
        calls["train"].update(loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]))
        blocks = [x.cpu() for x in grads]
        del grads, params
        _free(device)
        # (b) prefill and decode on each serve mesh, weights stationary
        for shape in EP_SERVE_MESHES:
            mesh = meshes[shape]
            rules = serve_rules()
            pre = build_cell(cfg, ShapeSpec("ep", seq, batch, "prefill"),
                             mesh, rules=rules, serve_dtype="float32")
            s_sh = cell_shardings(pre)
            served = _draw_blocks(cfg, seed, device, s_sh[0])
            tag = "x".join(map(str, shape))
            with torch.no_grad():
                inputs = {"tokens": place(b["tokens"], *s_sh[1]["tokens"])}
                (lg, st), rec = run(f"prefill {tag}", pre,
                                    lambda: pre.fn(served, inputs),
                                    ref_routes["prefill"], mesh)
                out = {"logits": gather_whole(lg).cpu(),
                       "caches": tree_map(lambda x: gather_whole(x).cpu(),
                                          st["caches"])}
                if rec["route_diff"]:
                    pinned = [c["idx"] for c in
                              _rows_of(ref_routes["prefill"], mesh)]
                    (lg, _), _ = run("pinned", pre,
                                     lambda: pre.fn(served, inputs),
                                     ref_routes["prefill"], mesh, pinned)
                    out["pinned_logits"] = gather_whole(lg).cpu()
                calls[f"prefill {tag}"].update(out)
                del lg, st
                for dist_decode in (False, True):
                    dec = build_cell(cfg, ShapeSpec("ep", cache, batch,
                                                    "decode"), mesh,
                                     rules=rules, dist_decode=dist_decode,
                                     serve_dtype="float32")
                    _, d_sh, db_sh = cell_shardings(dec)

                    def state():
                        return {"caches": place_tree(
                            tree_map(torch.clone, dstate["caches"]),
                            d_sh["caches"]),
                            "lengths": place(dstate["lengths"],
                                             *d_sh["lengths"])}
                    tok = {"tokens": place(nxt, *db_sh["tokens"])}
                    label = f"decode {tag} dist={dist_decode}"
                    st0 = state()
                    (lg, new), rec = run(label, dec,
                                         lambda: dec.fn(served, st0, tok),
                                         ref_routes["decode"], mesh)
                    out = {"logits": gather_whole(lg).cpu(),
                           "caches": tree_map(lambda x: gather_whole(x).cpu(),
                                              new["caches"])}
                    if rec["route_diff"]:
                        pinned = [c["idx"] for c in
                                  _rows_of(ref_routes["decode"], mesh)]
                        st1 = state()
                        (lg, _), _ = run("pinned", dec,
                                         lambda: dec.fn(served, st1, tok),
                                         ref_routes["decode"], mesh, pinned)
                        out["pinned_logits"] = gather_whole(lg).cpu()
                    calls[label].update(out)
                    del lg, new
            del served
            _free(device)
    finally:
        log.close()
    # every rank's records on rank 0 (tallies, times, peaks, routes), then
    # rank 1's gradient blocks, piece by piece, for the comparison
    small = {k: {f: v for f, v in r.items() if f not in ("logits", "caches",
                                                         "pinned_logits")}
             for k, r in calls.items()}
    every = [None, None]
    dist.all_gather_object(every, small)
    if rank == 1:
        for x in blocks:
            flat = x.reshape(-1)
            for i in range(0, flat.numel(), EP_SEND_ELEMS):
                dist.send(flat[i:i + EP_SEND_ELEMS].contiguous(), dst=0)
        return {}
    gaps = {}
    mesh = meshes[(1, 2)]
    for path, x, ref, (_, pls) in zip(_leaf_paths(p_sh), blocks,
                                      one["grads"], _leaves(p_sh)):
        other = torch.empty(x.numel(), dtype=x.dtype)
        for i in range(0, other.numel(), EP_SEND_ELEMS):
            piece = torch.empty_like(other[i:i + EP_SEND_ELEMS])
            dist.recv(piece, src=1)
            other[i:i + EP_SEND_ELEMS] = piece
        scale = float(ref.abs().max()) + 1e-30
        gaps[path] = max(
            float((got.reshape(want.shape) - want).abs().max())
            for got, want in ((x, _block_at(ref, mesh, pls, 0)),
                              (other, _block_at(ref, mesh, pls, 1)))) / scale
    return {"ranks": every, "calls": calls, "grad_gaps": gaps,
            "one": {k: one[k] for k in ("train", "prefill", "decode",
                                        "by_row")},
            "heads": {s: f"H {cfg.num_heads // s[1]} / KV "
                         f"{cfg.num_kv_heads // s[1]}" for s in meshes}}


def _block_at(t, mesh, pls, rank: int):
    """The block of ``t`` (whole) that ``rank`` of ``mesh`` holds under
    placements ``pls``: ``local_block`` at that rank's coordinate."""
    from torch.distributed.tensor import Shard
    coord = [int(c) for c in (mesh.mesh == rank).nonzero()[0]]
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            size = t.shape[pl.dim] // mesh.shape[i]
            t = t.narrow(pl.dim, coord[i] * size, size)
    return t


def ep_world_phase(device: str, **kw) -> dict:
    """Phase 18, the MoE cells on their expert shards: ``EP_WORLD`` in a
    world of two processes on one card (gloo), every collective the cells
    issue probed on the card's tensors first (a refused one fails the
    phase). Holds the gradients against the world of one at
    ``LM_PARITY_TOL`` and the serve cells at ``TP_WORLD_TOL["serve"]``;
    prints every rank's routes against the world of one's (a serve cell
    whose routes differ is held with the world of one's routes pinned),
    each rank's collectives a call (held to ``dryrun.account``'s), rank
    0's launches, and the times and peak memory beside the world of one's.
    Within ``EP_WORLD_SECONDS`` on the card."""
    from repro_torch.arch.params import tree_leaves
    t0 = time.perf_counter()
    kw = {**EP_WORLD, **kw, "device": device}
    _free(device)
    card = _card_line() if device != "cpu" else "the CPU"
    res = _world_of(_ep_world_body, kw, 2 * EP_WORLD_SECONDS,
                        "moe world of two")
    secs = time.perf_counter() - t0
    one, calls = res["one"], res["calls"]
    mb = lambda b: "not measured" if b is None else f"{b / 1e9:.2f}e9 B"  # noqa: E731
    print(f"moe world of two ({card}): {kw['arch']} (layers "
          f"{kw['layers']}, f32) in two gloo processes, every collective of "
          f"its cells taken on {device} tensors; the world of one on rank "
          f"0: gradients {one['train']['s']:.3f} s (a first call "
          f"{one['train']['cold_s']:.3f} s; peak "
          f"{mb(one['train']['peak'])}), prefill {one['prefill']['s']:.3f} "
          f"s ({mb(one['prefill']['peak'])}), decode "
          f"{one['decode']['s']:.3f} s ({mb(one['decode']['peak'])})")
    tr = calls["train"]
    rel = {"loss": abs(tr["loss"] - one["train"]["loss"])
           / abs(one["train"]["loss"]),
           "grad_norm": abs(tr["grad_norm"] - one["train"]["grad_norm"])
           / one["train"]["grad_norm"],
           "grad": max(res["grad_gaps"].values())}
    worst = max(res["grad_gaps"], key=res["grad_gaps"].get)
    ok = all(rel[k] <= LM_PARITY_TOL[k] for k in rel)
    print(f"moe world of two ({card}): gradients on the expert shards, (1, "
          f"2) mesh, baseline_rules, B {kw['batch']} x S {kw['seq']}: loss "
          f"{tr['loss']:.6f} / {one['train']['loss']:.6f} (rel "
          f"{rel['loss']:.2e}), grad norm rel {rel['grad_norm']:.2e}, worst "
          f"gradient leaf {rel['grad']:.2e} of its max ({worst}) against "
          f"the world of one {'ok' if ok else 'FAIL'}")
    check(ok, f"moe world of two: the gradients differ: {rel}")
    tol = TP_WORLD_TOL["serve"]
    bad = []
    for label, rec in calls.items():
        if label == "train":
            continue
        kind = "prefill" if label.startswith("prefill") else "decode"
        # a (2, 1) rank holds one row: held against the world of one row
        # by row (at a GEMM's other row count cuBLAS sums in another order)
        by_row = " 2x1" in label
        want = one["by_row"][kind] if by_row else one[kind]
        held = rec.get("pinned_logits", rec["logits"])
        errs = {"logits": float((rec["logits"] - want["logits"]).abs().max()),
                "held": float((held - want["logits"]).abs().max()),
                "batch": float((rec["logits"]
                                - one[kind]["logits"]).abs().max()),
                "caches": max(float((a - b).abs().max()) for a, b in zip(
                    tree_leaves(rec["caches"]), tree_leaves(want["caches"])))}
        good = errs["held"] <= tol and errs["caches"] <= tol
        bad += [] if good else [label]
        print(f"moe world of two ({card}): {label}: logits max |diff| "
              f"{errs['logits']:.2e}"
              + (f" (routes pinned to the world of one's: "
                 f"{errs['held']:.2e})" if "pinned_logits" in rec else "")
              + f", caches {errs['caches']:.2e} against the world of one"
              + (f" row by row (against its call on both rows: logits "
                 f"{errs['batch']:.2e})" if by_row else "")
              + f" (atol {tol:.0e}) {'ok' if good else 'FAIL'}")
    check(not bad, f"moe world of two: serve cells differ: {bad}")
    for r, rank in enumerate(res["ranks"]):
        for label, rec in rank.items():
            rep = route_report(f"rank {r} {label} against the world of one",
                               rec["routes"]["want"], rec["routes"]["got"])
            for i in rep["diff"].nonzero()[:8].tolist():
                print(f"routes: rank {r} {label}: token {i[0]} choice {i[1]}"
                      f" expert {int(rec['routes']['want']['idx'][tuple(i)])}"
                      f" -> {int(rec['routes']['got']['idx'][tuple(i)])}")
            tally, acc = rec["tally"], rec["account"]
            same, text = _collectives_report(tally, acc)
            print(f"moe world of two: rank {r} {label}: collectives {text}"
                  f" {'equal to' if same else 'DIFFER from'} "
                  f"dryrun.account's; {rec['s']:.3f} s"
                  + ("" if rec["cold_s"] is None else
                     f" (a first call {rec['cold_s']:.3f} s)")
                  + f", peak {mb(rec['peak'])} ({card})")
            check(same, f"moe world of two: rank {r} {label} collectives "
                        f"{tally} against the dry run's {acc}")
    cfg_layers = kw["layers"]
    launches = res["ranks"][0]
    want = {"train": {"flash_attention": 2 * cfg_layers,
                      "flash_attention_backward": cfg_layers}}
    for label in launches:
        if label.startswith("prefill"):
            want[label] = {"flash_attention": cfg_layers}
        elif label.endswith("dist=False"):
            want[label] = {"decode_attention": cfg_layers}
        elif label.endswith("dist=True"):
            want[label] = {"decode_attention_partial": cfg_layers}
    for label, n in want.items():
        got = launches[label]["launches"]
        check(all(got.get(k) == v for k, v in n.items()),
              f"moe world of two: launches of {label}: {got}, expected {n}")
    heads = res["heads"]
    print(f"moe world of two ({card}): launches on rank 0 at its shards' "
          f"head counts ((1, 2): {heads[(1, 2)]}; (2, 1): {heads[(2, 1)]}): "
          + "; ".join(f"{label} " + ", ".join(
              f"{k} {v}" for k, v in rec["launches"].items() if v)
              for label, rec in launches.items()))
    print(f"moe world of two ({card}): phase 18 in {secs:.1f} s (budget "
          f"{EP_WORLD_SECONDS:.0f})")
    check(device == "cpu" or secs <= EP_WORLD_SECONDS,
          f"moe world of two: phase 18 took {secs:.1f} s")
    return {**res, "seconds": secs}


# ------------------------------------------------ zamba2 on its shards

# phase 19: zamba2-2.7b at full width (d 2560, 80 SSD heads of P 64, N
# 64, the shared block's H 32 = KV 32 at D 80, vocab 32,000) cut to one
# period (6 Mamba2 blocks and the shared block), f32 (about 0.58e9
# parameters), in a world of two gloo processes on the one card, on a
# (1, 2) ("data", "model") mesh: 40 SSD heads, 16 shared heads and 16,000
# vocabulary rows a rank, ``in_proj``'s 5,224-column shards straddling z
# and x. A train step under baseline_rules (the whole AdamW step fits:
# the parameters beside their moments), prefill and decode (with and
# without the distributed flash-decode) under serve_rules, each against
# the world of one on the same inputs
MAMBA_WORLD = dict(arch="zamba2-2.7b", layers=6, batch=2, seq=256,
                   cache=512, seed=28)
MAMBA_WORLD_SECONDS = 150.0
# the serve cells' logits and caches against the world of one: 2e-5 of
# each tensor's largest |value| (``TP_WORLD_TOL["serve"]``'s number, in
# the gradient leaves' measure). Absolute 2e-5 misses at full width
# through 6 mixers and the shared block: on NVIDIA H100 80GB HBM3
# (700.00 W) the prefill's logits read 2.37e-5 and the shared block's k
# 2.40e-5 off (relative to their max 5.14e-6 and 4.99e-6), where one f32
# GEMM of the same inputs at another row count (the first mixer's conv
# state, 6 rows against 512) already reads 7.27e-6: cuBLAS sums in
# another order
MAMBA_SERVE_TOL = 2e-5


def _call_seconds(device: str, fn, start=None) -> float:
    """Seconds of one call of ``fn`` (its result dropped), after
    ``start()`` where given (a barrier: the ranks start together)."""
    _sync(device)
    if start is not None:
        start()
    t = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t


def _stages(spawned: float, stamps: dict) -> str:
    """Where a world of two's seconds went, from its rank 0's wall-clock
    stamps and the time its processes were spawned."""
    names = (("start", "spawn"), ("drawn", "probe and draw"),
             ("train", "train calls and gathers"),
             ("serve", "serve calls"), ("one", "the world of one"))
    last, out = spawned, []
    for key, name in names:
        out.append(f"{name} {stamps[key] - last:.1f} s")
        last = stamps[key]
    return ", ".join(out)


def _own_blocks(tree):
    """A tree of DTensors, each with a copy of its local block (``place``
    gives views of the whole tensors, which the copies let go)."""
    from repro_torch.distributed.checkpoint import tree_map
    from repro_torch.distributed.sharding import as_local
    return tree_map(lambda d: as_local(d.to_local().clone(), d), tree)


def _sharded_state(params, sh, device: str):
    """(params, a zero AdamW state) at a train cell's placements ``sh``
    (``cell_shardings``), each rank holding copies of its blocks alone:
    the moments drawn as zeros at the params' blocks, never whole."""
    import torch
    from repro_torch.distributed.checkpoint import tree_map
    from repro_torch.distributed.sharding import as_local, place, place_tree
    from repro_torch.train.optim import AdamWState
    p = _own_blocks(place_tree(params, sh[0]))
    zeros = lambda d: as_local(torch.zeros_like(d.to_local()), d)  # noqa: E731
    return p, AdamWState(place(torch.zeros((), dtype=torch.int32,
                                           device=device), *sh[1].step),
                         tree_map(zeros, p), tree_map(zeros, p))


def _shards_world_body(rank: int, *, device: str, arch: str, layers: int,
                       batch: int, seq: int, cache: int, seed: int,
                       watch: str, order: bool = False, ranks: int = 2,
                       probe=TP_PROBED) -> dict:
    """A world's work (phases 19, 20 and 21): the probe of ``probe``'s
    collectives, the cells on their shards on a (1, ``ranks``) mesh of
    ``arch`` (every call's collectives, launches, time and the
    ``watch``-kind weights gathered over ``model`` recorded: ``"mamba"``,
    ``"rwkv"`` or ``"attn"``), their outputs
    gathered whole; then rank 0's world of one on the same inputs and the
    gaps, and, where ``order``, the world of one's own gap summed in
    another order (``_order_gaps``). Only rank 0 keeps the whole
    parameters past the placing."""
    import torch
    import torch.distributed as dist
    from _torch_dist_worker import (CollectiveLog, _count, _model_gathers,
                                    _tally, _watched)
    from repro_torch.arch import model as M
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.checkpoint import flatten, tree_map
    from repro_torch.distributed.sharding import (baseline_rules,
                                                  gather_whole, place,
                                                  place_tree, serve_rules,
                                                  sharded_dims)
    from repro_torch.launch.cells import build_cell, cell_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import (AdamWConfig, init_state, make_decode_step,
                                   make_prefill_step, make_train_step)
    stamps = {"start": time.time()}
    if device != "cpu":
        torch.cuda.set_device(0)
    refused = _probe_collectives(device, probe)
    check(not refused, f"{arch} world of {ranks}: gloo refused {refused} on "
                       f"{device} tensors, which the cells issue")
    mesh = make_mesh((1, ranks), ("data", "model"), device_type=device)
    cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
    g = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, g, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=g,
                           device=device, dtype=torch.int32)
    b = {"tokens": tokens[:, :-1].contiguous(),
         "labels": tokens[:, 1:].contiguous()}
    dstate = M.init_decode_state(cfg, batch, cache, device=device)
    dstate["caches"] = tree_map(
        lambda x: torch.randn(x.shape, generator=g, device=device),
        dstate["caches"])
    dstate["lengths"] = torch.randint(1, cache, (batch,), generator=g,
                                      device=device, dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                        device=device, dtype=torch.int32)
    def whole_tree(tree):
        """Every leaf whole on rank 0 alone, in host memory (None on the
        other ranks): the world of one there reads them, and the card
        holds every rank's blocks meanwhile. A leaf split over ``model``
        is gathered to rank 0 by its blocks on the host (the mesh is (1,
        ``ranks``): rank order is the model coordinate); a whole one is
        rank 0's own."""
        def whole(t):
            dims = sharded_dims(t.device_mesh, t.placements)
            block = t.to_local().detach().cpu()
            if not dims:
                return None if rank else block
            parts = [torch.empty_like(block) for _ in range(ranks)] \
                if not rank else None
            dist.gather(block.contiguous(), parts, dst=0)
            return None if rank else torch.cat(parts, dims[1])
        return tree_map(whole, tree)
    shapes_of = lambda p: _watched({"watch": watch}, p)     # noqa: E731
    log = CollectiveLog()
    calls, outs = {}, {}
    stamps["drawn"] = time.time()

    def run(label, cell, fn, shapes):
        """One call of ``fn``, the ranks starting together, with its
        collectives, launches and time recorded."""
        _sync(device)
        dist.barrier()
        reset_counts()
        log.on = True
        t = time.perf_counter()
        res = fn()
        _sync(device)
        secs = time.perf_counter() - t
        log.on = False
        taken = log.take()
        calls[label] = {
            "s": secs, "tally": _tally(taken), "account": _count(cell),
            "model_gathers": sorted(set(_model_gathers(taken, mesh,
                                                       shapes))),
            "launches": {**{k: v for k, v in counts().items() if v},
                         "decode_attention_partial": _kernel_ops()[
                             "decode_attention"].partial_invocation_count()},
            "mamba_split": cell.mamba_split, "rwkv_split": cell.rwkv_split,
            "in_proj_route": cell.in_proj_route, "peak": _peak(device)}
        return res

    # the train cell's and the serve cells' shards, each rank's own
    cell = build_cell(cfg, ShapeSpec("shards", seq, batch, "train"), mesh,
                      rules=baseline_rules(), microbatches=1)
    sh = cell_shardings(cell)
    state = _sharded_state(params, sh, device)
    rules = serve_rules()
    pre = build_cell(cfg, ShapeSpec("shards", seq, batch, "prefill"), mesh,
                     rules=rules, serve_dtype="float32")
    p_sh = cell_shardings(pre)
    served = _own_blocks(place_tree(params, p_sh[0]))
    if rank:       # the whole parameters' blocks back to the card
        del params
        _free(device)
    try:
        # (a) a train step through the cell
        placed = {k: place(v, *sh[2][k]) for k, v in b.items()}
        p_d, o_d, m_d = run("train", cell,
                            lambda: cell.fn(state[0], state[1], placed),
                            shapes_of(state[0]))
        del state
        calls["train"]["warm_s"] = _call_seconds(device, lambda: cell.fn(
            p_d, o_d, placed), dist.barrier)
        _free(device)        # the first state's and the second call's blocks
        outs["train"] = {"loss": float(m_d["loss"]),
                         "grad_norm": float(m_d["grad_norm"]),
                         "params": whole_tree(p_d), "mu": whole_tree(o_d.mu)}
        del p_d, o_d
        stamps["train"] = time.time()
        # (b) prefill and decode through the serve cells
        shapes = shapes_of(served)
        with torch.no_grad():
            inputs = {"tokens": place(b["tokens"], *p_sh[1]["tokens"])}
            lg, st = run("prefill", pre, lambda: pre.fn(served, inputs),
                         shapes)
            outs["prefill"] = {"logits": gather_whole(lg),
                               "caches": whole_tree(st["caches"])}
            for dist_decode in (False, True):
                dec = build_cell(cfg, ShapeSpec("shards", cache, batch,
                                                "decode"), mesh, rules=rules,
                                 dist_decode=dist_decode,
                                 serve_dtype="float32")
                _, s_sh, b_sh = cell_shardings(dec)
                st0 = {"caches": place_tree(tree_map(torch.clone,
                                                     dstate["caches"]),
                                            s_sh["caches"]),
                       "lengths": place(dstate["lengths"],
                                        *s_sh["lengths"])}
                tok = {"tokens": place(nxt, *b_sh["tokens"])}
                label = f"decode dist={dist_decode}"
                lg, new = run(label, dec, lambda: dec.fn(served, st0, tok),
                              shapes)
                outs[label] = {"logits": gather_whole(lg),
                               "caches": whole_tree(new["caches"])}
    finally:
        log.close()
    stamps["serve"] = time.time()
    every = [None] * ranks
    dist.all_gather_object(every, calls)
    if rank:
        return {}
    # the world of one on rank 0: the undistributed calls
    opt = AdamWConfig()
    step = make_train_step(cfg)
    reset_counts()
    t = time.perf_counter()
    p_u, o_u, m_u = step(params, init_state(params), b)
    _sync(device)
    one = {"train": {"s": time.perf_counter() - t, "launches": counts()}}
    tr = outs["train"]
    grads = [tree_map(lambda m: m / (1 - opt.b1), mu)
             for mu in (tr["mu"], o_u.mu)]
    gaps = {path: float((a.to(c.device) - c).abs().max()
                        / (c.abs().max() + 1e-30))
            for path, a, c in zip(_leaf_paths(grads[1]), flatten(grads[0]),
                                  flatten(grads[1]))}
    res = {"ranks": every, "calls": every[0], "grad_gaps": gaps,
           "train": {"loss": (tr["loss"], float(m_u["loss"])),
                     "grad_norm": (tr["grad_norm"],
                                   float(m_u["grad_norm"])),
                     "update_excess": _update_excess(
                         tr["params"], p_u, *grads, params, opt, (0.0, 0.0))}}
    del grads, tr, outs["train"]
    one["train"]["warm_s"] = _call_seconds(device,
                                           lambda: step(p_u, o_u, b))
    del p_u, o_u
    if order:
        res["rounding"] = _order_gaps(cfg, params, b)
    serve = {}
    with torch.no_grad():
        reset_counts()
        t = time.perf_counter()
        want, wstate = make_prefill_step(cfg)(params, {"tokens": b["tokens"]})
        _sync(device)
        one["prefill"] = {"s": time.perf_counter() - t, "launches": counts()}
        serve["prefill"] = (want, wstate["caches"])
        st = tree_map(torch.clone, dstate)
        t = time.perf_counter()
        wl, wn = make_decode_step(cfg)(params, st, {"tokens": nxt})
        _sync(device)
        one["decode"] = {"s": time.perf_counter() - t}
        for d in (False, True):
            serve[f"decode dist={d}"] = (wl, wn["caches"])
    res["serve"] = {}

    def gap(a, ref):
        """(max |a - ref|, that over max |ref|)."""
        d = float((a.to(ref.device) - ref).abs().max())
        return d, d / (float(ref.abs().max()) + 1e-30)
    for label, (want, wcaches) in serve.items():
        got = outs[label]
        res["serve"][label] = {
            "logits": gap(got["logits"], want),
            "caches": {f"{key}.{n}": gap(got["caches"][key][n], t_)
                       for key, leaves in wcaches.items()
                       for n, t_ in leaves.items()}}
    res["one"] = one
    stamps["one"] = time.time()
    res["stamps"] = stamps
    return res


def mamba_world_phase(device: str, **kw) -> dict:
    """Phase 19, zamba2 on its shards: ``MAMBA_WORLD`` in a world of two
    processes on one card (gloo), every collective the cells issue probed
    on the card's tensors first (a refused one fails the phase). Holds
    the train step against the world of one (loss, grad norm and every
    gradient leaf at ``LM_PARITY_TOL``; the params after AdamW by
    ``_update_excess``), the prefill and decode cells' logits and caches
    (the shared block's k/v, the conv and ssd states) at
    ``MAMBA_SERVE_TOL``, each rank's collectives a call against
    ``dryrun.account``'s, no Mamba2 weight all-gathered over ``model`` in
    a decode cell (in a train or prefill cell only ``in_proj``), and the
    scan launches on rank 0 (12 forward and 6 backward a train step: 6
    mixers, each forward again in its period's recompute; 6 a prefill).
    Within ``MAMBA_WORLD_SECONDS`` on the card."""
    t0 = time.perf_counter()
    kw = {**MAMBA_WORLD, **kw, "device": device}
    _free(device)
    card = _card_line() if device != "cpu" else "the CPU"
    spawned = time.time()
    res = _world_of(_shards_world_body, {**kw, "watch": "mamba"},
                        2 * MAMBA_WORLD_SECONDS, "zamba2 world of two")
    secs = time.perf_counter() - t0
    from repro_torch.configs import get_config
    cfg = get_config(kw["arch"])
    heads = (f"{cfg.ssm_heads // 2} of {cfg.ssm_heads} SSD heads, "
             f"{cfg.num_heads // 2} of {cfg.num_heads} shared heads (D "
             f"{cfg.head_dim}), {cfg.vocab_size // 2} of {cfg.vocab_size} "
             f"vocabulary rows a rank")
    tr = res["train"]
    rel = {"loss": abs(tr["loss"][0] - tr["loss"][1]) / abs(tr["loss"][1]),
           "grad_norm": abs(tr["grad_norm"][0] - tr["grad_norm"][1])
           / tr["grad_norm"][1],
           "grad": max(res["grad_gaps"].values())}
    worst = max(res["grad_gaps"], key=res["grad_gaps"].get)
    ok = all(rel[k] <= LM_PARITY_TOL[k] for k in rel) \
        and tr["update_excess"] <= TP_WORLD_TOL["update_excess"]
    one = res["one"]
    print(f"zamba2 world of two ({card}): {kw['arch']} ({kw['layers']} "
          f"layers, f32) on a (1, 2) mesh of two gloo processes, "
          f"{heads}; train step through the cell "
          f"{res['calls']['train']['s']:.3f} s a first call, "
          f"{res['calls']['train']['warm_s']:.3f} s a second (the world of "
          f"one {one['train']['s']:.3f} / {one['train']['warm_s']:.3f} s), "
          f"B {kw['batch']} x S {kw['seq']}: "
          f"loss {tr['loss'][0]:.6f} / {tr['loss'][1]:.6f} (rel "
          f"{rel['loss']:.2e}), grad norm rel {rel['grad_norm']:.2e}, worst "
          f"gradient leaf {rel['grad']:.2e} of its max ({worst}), params "
          f"{tr['update_excess']:.2e} past what the gradient differences "
          f"allow, against the world of one {'ok' if ok else 'FAIL'}")
    check(ok, f"zamba2 world of two: the train cell differs: {rel}, {tr}")
    tol = MAMBA_SERVE_TOL
    bad = []
    for label, e in res["serve"].items():
        good = e["logits"][1] <= tol \
            and max(r for _, r in e["caches"].values()) <= tol
        bad += [] if good else [label]
        print(f"zamba2 world of two ({card}): {label} "
              f"({res['calls'][label]['s']:.3f} s): logits max |diff| "
              f"{e['logits'][0]:.2e} ({e['logits'][1]:.2e} of their max), "
              f"caches " + ", ".join(
                  f"{k} {a:.2e} ({r:.2e})" for k, (a, r) in sorted(
                      e["caches"].items()))
              + f" against the world of one (tol {tol:.0e} of each "
              f"tensor's max) {'ok' if good else 'FAIL'}")
    check(not bad, f"zamba2 world of two: serve cells differ: {bad}")
    for r, rank in enumerate(res["ranks"]):
        for label, rec in rank.items():
            tally, acc = rec["tally"], rec["account"]
            same, text = _collectives_report(tally, acc)
            gathered = rec["model_gathers"]
            weights_ok = not gathered if label.startswith("decode") \
                else gathered == ["in_proj"]
            print(f"zamba2 world of two: rank {r} {label} "
                  f"({rec['in_proj_route']} route): collectives {text}"
                  f" {'equal to' if same else 'DIFFER from'} "
                  f"dryrun.account's; Mamba2 weights all-gathered over "
                  f"model: {', '.join(gathered) or 'none'} "
                  f"{'ok' if weights_ok else 'FAIL'}; {rec['s']:.3f} s")
            check(same, f"zamba2 world of two: rank {r} {label} collectives "
                        f"{tally} against the dry run's {acc}")
            check(weights_ok, f"zamba2 world of two: rank {r} {label} "
                              f"gathered {gathered} over model")
    launches = res["ranks"][0]
    want = {"train": {"ssd_scan": 12, "ssd_scan_backward": 6,
                      "flash_attention": 2, "flash_attention_backward": 1},
            "prefill": {"ssd_scan": 6, "flash_attention": 1},
            "decode dist=False": {"decode_attention": 1},
            "decode dist=True": {"decode_attention_partial": 1}}
    periods = kw["layers"] // 6
    for label, n in want.items():
        got = launches[label]["launches"]
        n = {k: v * periods for k, v in n.items()}
        check(all(got.get(k) == v for k, v in n.items()),
              f"zamba2 world of two: launches of {label}: {got}, "
              f"expected {n}")
    print(f"zamba2 world of two ({card}): launches on rank 0 at its "
          f"shards: " + "; ".join(
              f"{label} " + ", ".join(f"{k} {v}" for k, v in
                                      rec["launches"].items() if v)
              for label, rec in launches.items())
          + f"; the world of one's train step "
          + ", ".join(f"{k} {v}" for k, v in one["train"]["launches"].items()
                      if v))
    print(f"zamba2 world of two ({card}): phase 19 in {secs:.1f} s (budget "
          f"{MAMBA_WORLD_SECONDS:.0f}): "
          + _stages(spawned, res["stamps"]))
    check(device == "cpu" or secs <= MAMBA_WORLD_SECONDS,
          f"zamba2 world of two: phase 19 took {secs:.1f} s")
    return {**res, "seconds": secs}


# ------------------------------------------------ rwkv6 on its shards

# phase 20: rwkv6-7b at full width (d 4096, 64 WKV heads of K 64, d_ff
# 14,336, vocab 65,536) cut to 2 layers, f32 (about 0.97e9 parameters), in
# a world of two gloo processes on the one card, on a (1, 2) ("data",
# "model") mesh: 32 WKV heads, 7,168 channel-mix columns and 32,768
# vocabulary rows a rank. A train step under baseline_rules (the whole
# AdamW step fits), prefill and decode under serve_rules, each against the
# world of one on the same inputs
RWKV_WORLD = dict(arch="rwkv6-7b", layers=2, batch=2, seq=256, cache=512,
                  seed=29)
RWKV_WORLD_SECONDS = 150.0
# rwkv6-7b's gradients at its init turn on the order of the f32 sums (see
# RECURRENT_PARITY_TOL): on NVIDIA H100 80GB HBM3 (700.00 W) the world of
# one's own step, its rows summed as two microbatches, read grad norm rel
# 1.48e-4 and its worst leaf 1.39e-3 of its max (tm/wr) against itself,
# past LM_PARITY_TOL, where the world of two read 2.64e-4 and 2.10e-3 on
# the same leaves. So the phase measures that gap on its own card
# (``_order_gaps``) and holds the world of two's grad norm and gradient
# leaves within RWKV_ORDER_FACTOR times it (RECURRENT_PARITY_TOL's eight
# times the summation-order gap), never looser than LM_PARITY_TOL; a
# fault of the cells (a sum left out, a cut gradient) moves a leaf by
# O(1) of its max
RWKV_ORDER_FACTOR = 8.0
# the WKV scan, forward and backward (bf16, w in f32), at one rank's heads
# of rwkv6-7b on the pod mesh's model axis of 16 (64 / 16 = 4): (label, B,
# S, H, K, with the backward) at the train_4k cell's rows a microbatch on
# a device (4 x 4096) and the prefill_32k cell's (2 x 32768). The kernels
# launch an (H, B) grid: 16 and 8 blocks on the card's 132 SMs
TP_WKV = [("rwkv6 train_4k tp16", 4, 4096, 4, 64, True),
          ("rwkv6 prefill_32k tp16", 2, 32768, 4, 64, False)]


def tp_wkv_phase(device: str, cases=TP_WKV, *, time_it: bool) -> dict:
    """``wkv6_scan`` forward (bf16, w in f32) at one rank's WKV heads
    (``TP_WKV``) against the plain chunked version on the same inputs, at
    ``WKV_TOL``, and, where a case asks, its backward against the plain
    backward on a seeded output gradient at ``SCAN_BWD_TOL``, with bounds
    (``wkv_bound``, ``scan_backward_bound``) and, where ``time_it``, times
    beside the plain versions (no single PyTorch call computes the scan).
    Returns {kernel: [record]}."""
    import torch
    from repro_torch.kernels.rwkv6_scan.ops import wkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import (wkv6_backward_reference,
                                                    wkv6_chunked)
    t0 = time.perf_counter()
    out = {"wkv6_scan": [], "wkv6_scan_backward": []}
    dtype, chunk = "bfloat16", 32
    for seed, (label, B, S, H, K, backward) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(970 + seed)
        dt_ = getattr(torch, dtype)
        r, k, v, dy = (torch.randn(B, S, H, K, generator=g,
                                   device=device).to(dt_) for _ in range(4))
        w = _decays(g, 0.4, (B, S, H, K), device)
        u = torch.randn(H, K, generator=g, device=device)
        inputs = (r, k, v, w, u)
        tag = f"{label} B={B} S={S} H={H} K={K}"
        y, st = wkv6_scan(*inputs, chunk=chunk)
        want_y, want_st = wkv6_chunked(*inputs, chunk=chunk)
        rec = _agree(f"wkv6_scan per rank {tag}", y, want_y, dtype, WKV_TOL)
        st_err = _agree(f"wkv6_scan per rank {tag} state", st, want_st,
                        "float32", WKV_TOL)
        rec.update(label=label, B=B, S=S, H=H,
                   max_abs_err=max(rec["max_abs_err"],
                                   st_err["max_abs_err"]),
                   **wkv_bound(r, w, u, chunk))
        del y, st, want_y, want_st
        if time_it:
            # the plain version takes about a second a call at S 32768:
            # 4 kernel calls a timing there, one plain
            _timed(rec, _input_sets(inputs, rec["bytes"]),
                   lambda *a: wkv6_scan(*a, chunk=chunk),
                   lambda *a: wkv6_chunked(*a, chunk=chunk), None,
                   20 if S <= 4096 else 4)
            print(f"wkv6_scan per rank {label} time: " + _times(
                rec, "no single PyTorch call computes the scan"))
        out["wkv6_scan"].append(rec)
        if not backward:
            continue
        got = _wkv_backward(*inputs, dy)
        want = wkv6_backward_reference(*inputs, dy, None, None,
                                       chunk=chunk)[:5]
        errs = [_agree(f"wkv6_scan_backward per rank {tag} {part}", a, b,
                       "float32" if b.dtype == torch.float32 else dtype,
                       SCAN_BWD_TOL)
                for part, a, b in zip(("dr", "dk", "dv", "dw", "du"), got,
                                      want)]
        rec = {"label": label, "B": B, "S": S, "H": H,
               "max_abs_err": max(e["max_abs_err"] for e in errs),
               "rel_err": max(e["rel_err"] for e in errs),
               **scan_backward_bound(inputs + (dy,), got,
                                     wkv_bound(r, w, u, chunk)["flops"])}
        del got, want
        if time_it:
            sets = _input_sets(inputs + (dy,), rec["bytes"])
            _timed(rec, sets, _wkv_backward,
                   lambda *a: wkv6_backward_reference(*a, None, None,
                                                      chunk=chunk)[:5],
                   None, 10)
            print(f"wkv6_scan_backward per rank {label} time: " + _times(
                rec, "no single PyTorch call computes the backward"))
        out["wkv6_scan_backward"].append(rec)
    print(f"per-rank WKV scans: {len(cases)} cases in "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def _order_gaps(cfg, params, b) -> dict:
    """How far summation order alone moves the world of one's step on this
    device: its gradients (before the clip) on ``b`` whole against their
    mean over two microbatches of its rows, as the world of two's are
    read (loss and grad norm relative, each leaf's max |diff| over its max
    |ref|)."""
    import torch
    from repro_torch.train.step import make_grad_fn
    grad_fn = make_grad_fn(cfg)
    one = grad_fn(params, [b])
    half = b["tokens"].shape[0] // 2
    two = grad_fn(params, [{k: v[:half] for k, v in b.items()},
                           {k: v[half:] for k, v in b.items()}])
    norm = [float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in gs)))
            for gs in (one[0], two[0])]
    return {"loss": abs(float(two[1]["loss"]) - float(one[1]["loss"]))
            / abs(float(one[1]["loss"])),
            "grad_norm": abs(norm[1] - norm[0]) / norm[0],
            "grad_gaps": {path: float((c - a).abs().max()
                                      / (a.abs().max() + 1e-30))
                          for path, a, c in zip(_leaf_paths(params),
                                                one[0], two[0])}}


def rwkv_world_phase(device: str, **kw) -> dict:
    """Phase 20, rwkv6 on its shards: ``RWKV_WORLD`` in a world of two
    processes on one card (gloo), every collective the cells issue probed
    on the card's tensors first (a refused one fails the phase). Holds
    the train step against the world of one (the loss at
    ``LM_PARITY_TOL``, the grad norm and every gradient leaf within
    ``RWKV_ORDER_FACTOR`` times the world of one's own summation-order
    gap on the card and never looser than ``LM_PARITY_TOL``; the params
    after AdamW by ``_update_excess``), the prefill and decode cells' logits and states
    (``x_tm``, ``x_cm``, ``wkv``) at ``MAMBA_SERVE_TOL`` (2e-5 of each
    tensor's max), each rank's collectives a call against
    ``dryrun.account``'s, no RWKV6 weight all-gathered over ``model``, and
    the scan launches on rank 0 (4 forward and 2 backward a train step of
    2 layers, each forward again in its period's recompute; 2 a prefill).
    Within ``RWKV_WORLD_SECONDS`` on the card."""
    t0 = time.perf_counter()
    kw = {**RWKV_WORLD, **kw, "device": device}
    _free(device)
    card = _card_line() if device != "cpu" else "the CPU"
    spawned = time.time()
    res = _world_of(_shards_world_body,
                        {**kw, "watch": "rwkv", "order": True},
                        2 * RWKV_WORLD_SECONDS, "rwkv6 world of two")
    secs = time.perf_counter() - t0
    from repro_torch.configs import get_config
    cfg = get_config(kw["arch"])
    heads = (f"{cfg.rwkv_heads // 2} of {cfg.rwkv_heads} WKV heads, "
             f"{cfg.d_ff // 2} of {cfg.d_ff} channel-mix columns, "
             f"{cfg.vocab_size // 2} of {cfg.vocab_size} vocabulary rows a "
             f"rank")
    tr = res["train"]
    rel = {"loss": abs(tr["loss"][0] - tr["loss"][1]) / abs(tr["loss"][1]),
           "grad_norm": abs(tr["grad_norm"][0] - tr["grad_norm"][1])
           / tr["grad_norm"][1],
           "grad": max(res["grad_gaps"].values())}
    worst = max(res["grad_gaps"], key=res["grad_gaps"].get)
    rnd = res["rounding"]
    order = {"loss": 0.0, "grad_norm": rnd["grad_norm"],
             "grad": max(rnd["grad_gaps"].values())}
    tol = {k: max(LM_PARITY_TOL[k], RWKV_ORDER_FACTOR * order[k])
           for k in rel}
    ok = all(rel[k] <= tol[k] for k in rel) \
        and tr["update_excess"] <= TP_WORLD_TOL["update_excess"]
    one = res["one"]
    top = lambda g: ", ".join(f"{k} {v:.2e}" for k, v in sorted(  # noqa: E731
        g.items(), key=lambda kv: -kv[1])[:6])
    print(f"rwkv6 world of two ({card}): the world of one against itself "
          f"in two microbatches (the same rows summed in another order): "
          f"loss rel {rnd['loss']:.2e}, grad norm rel {rnd['grad_norm']:.2e},"
          f" worst leaves {top(rnd['grad_gaps'])}; the world of two's "
          f"worst leaves {top(res['grad_gaps'])}; held at grad norm "
          f"{tol['grad_norm']:.2e}, leaves {tol['grad']:.2e}")
    print(f"rwkv6 world of two ({card}): {kw['arch']} ({kw['layers']} "
          f"layers, f32) on a (1, 2) mesh of two gloo processes, "
          f"{heads}; train step through the cell "
          f"{res['calls']['train']['s']:.3f} s a first call, "
          f"{res['calls']['train']['warm_s']:.3f} s a second (the world of "
          f"one {one['train']['s']:.3f} / {one['train']['warm_s']:.3f} s), "
          f"B {kw['batch']} x S {kw['seq']}: "
          f"loss {tr['loss'][0]:.6f} / {tr['loss'][1]:.6f} (rel "
          f"{rel['loss']:.2e}), grad norm rel {rel['grad_norm']:.2e}, worst "
          f"gradient leaf {rel['grad']:.2e} of its max ({worst}), params "
          f"{tr['update_excess']:.2e} past what the gradient differences "
          f"allow, against the world of one {'ok' if ok else 'FAIL'}")
    check(ok, f"rwkv6 world of two: the train cell differs: {rel}, {tr}")
    tol = MAMBA_SERVE_TOL
    bad = []
    for label, e in res["serve"].items():
        good = e["logits"][1] <= tol \
            and max(r for _, r in e["caches"].values()) <= tol
        bad += [] if good else [label]
        print(f"rwkv6 world of two ({card}): {label} "
              f"({res['calls'][label]['s']:.3f} s): logits max |diff| "
              f"{e['logits'][0]:.2e} ({e['logits'][1]:.2e} of their max), "
              f"states " + ", ".join(
                  f"{k} {a:.2e} ({r:.2e})" for k, (a, r) in sorted(
                      e["caches"].items()))
              + f" against the world of one (tol {tol:.0e} of each "
              f"tensor's max) {'ok' if good else 'FAIL'}")
    check(not bad, f"rwkv6 world of two: serve cells differ: {bad}")
    for r, rank in enumerate(res["ranks"]):
        for label, rec in rank.items():
            same, text = _collectives_report(rec["tally"], rec["account"])
            gathered = rec["model_gathers"]
            print(f"rwkv6 world of two: rank {r} {label} (split "
                  f"{', '.join(rec['rwkv_split'])}): collectives {text}"
                  f" {'equal to' if same else 'DIFFER from'} "
                  f"dryrun.account's; RWKV6 weights all-gathered over "
                  f"model: {', '.join(gathered) or 'none'} "
                  f"{'FAIL' if gathered else 'ok'}; {rec['s']:.3f} s")
            check(same, f"rwkv6 world of two: rank {r} {label} collectives "
                        f"{rec['tally']} against the dry run's "
                        f"{rec['account']}")
            check(not gathered, f"rwkv6 world of two: rank {r} {label} "
                                f"gathered {gathered} over model")
    launches = res["ranks"][0]
    n = kw["layers"]
    want = {"train": {"wkv6_scan": 2 * n, "wkv6_scan_backward": n},
            "prefill": {"wkv6_scan": n}}
    for label, w in want.items():
        got = launches[label]["launches"]
        check(all(got.get(k) == v for k, v in w.items()),
              f"rwkv6 world of two: launches of {label}: {got}, "
              f"expected {w}")
    print(f"rwkv6 world of two ({card}): launches on rank 0 at its "
          f"shards: " + "; ".join(
              f"{label} " + (", ".join(f"{k} {v}" for k, v in
                                       rec["launches"].items() if v)
                             or "none")
              for label, rec in launches.items())
          + f"; the world of one's train step "
          + ", ".join(f"{k} {v}" for k, v in one["train"]["launches"].items()
                      if v))
    print(f"rwkv6 world of two ({card}): phase 20 in {secs:.1f} s (budget "
          f"{RWKV_WORLD_SECONDS:.0f}): "
          + _stages(spawned, res["stamps"]))
    check(device == "cpu" or secs <= RWKV_WORLD_SECONDS,
          f"rwkv6 world of two: phase 20 took {secs:.1f} s")
    return {**res, "seconds": secs}


# ------------------------------------------------ mid-head attention on slots

# phase 21: qwen2-vl-7b at full width (d 3584, H 28 of D 128 over KV 4,
# d_ff 18,944, vocab 152,064) cut to 2 layers, f32 (about 1.55e9
# parameters), in a world of 8 gloo processes on the one card, on a (1, 8)
# ("data", "model") mesh: each rank's 448 q columns (3.5 heads) exchanged
# onto slots of 4 heads, rank 7's empty, 19,008 vocabulary rows a rank. A
# train step under baseline_rules, prefill and decode under serve_rules,
# each against the world of one on the same inputs
MIDHEAD_WORLD = dict(arch="qwen2-vl-7b", layers=2, batch=2, seq=256,
                     cache=512, seed=30, world=8)
MIDHEAD_WORLD_SECONDS = 150.0


def midhead_world_phase(device: str, **kw) -> dict:
    """Phase 21, the mid-head attention on its head slots: ``MIDHEAD_WORLD``
    in a world of ``world`` processes on one card (gloo), every collective
    the cells issue probed on the card's tensors first (``SLOT_PROBED``; a
    refused one fails the phase). Holds the train step against the world of one at phase 17 (b)'s
    pins (the loss, grad norm and every gradient leaf at
    ``LM_PARITY_TOL``; the params after AdamW by ``_update_excess``), the
    prefill and decode cells' logits and k/v caches at
    ``TP_WORLD_TOL["serve"]`` (absolute), each rank's collectives a call
    against ``dryrun.account``'s at its model coordinate, no attention
    weight all-gathered over ``model``, and the attention launches on
    rank 0 (2 forward and 1 backward a layer in a train step, 1 a layer a
    prefill and a decode step) and on the last rank, whose slot is empty
    where ``world`` does not divide H (none but the distributed decode's).
    Within ``MIDHEAD_WORLD_SECONDS`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import head_slots
    t0 = time.perf_counter()
    kw = {**MIDHEAD_WORLD, **kw, "device": device}
    ranks = kw.pop("world")
    _free(device)
    card = _card_line() if device != "cpu" else "the CPU"
    spawned = time.time()
    res = _world_of(_shards_world_body,
                    {**kw, "watch": "attn", "ranks": ranks,
                     "probe": SLOT_PROBED},
                    2 * MIDHEAD_WORLD_SECONDS, "mid-head world", ranks)
    secs = time.perf_counter() - t0
    cfg = get_config(kw["arch"])
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    slots = [head_slots(H, ranks, r)[1] for r in range(ranks)]
    check(H % ranks != 0, f"mid-head world: {ranks} ranks divide H {H}")
    layout = (f"H {H} over KV {KV} (D {hd}): {H * hd // ranks} q columns "
              f"({H / ranks:g} heads) a rank, head slots of "
              f"{', '.join(map(str, slots))}; {cfg.vocab_size // ranks} of "
              f"{cfg.vocab_size} vocabulary rows a rank")
    tr = res["train"]
    rel = {"loss": abs(tr["loss"][0] - tr["loss"][1]) / abs(tr["loss"][1]),
           "grad_norm": abs(tr["grad_norm"][0] - tr["grad_norm"][1])
           / tr["grad_norm"][1],
           "grad": max(res["grad_gaps"].values())}
    worst = max(res["grad_gaps"], key=res["grad_gaps"].get)
    ok = all(rel[k] <= LM_PARITY_TOL[k] for k in rel) \
        and tr["update_excess"] <= TP_WORLD_TOL["update_excess"]
    one = res["one"]
    print(f"mid-head world of {ranks} ({card}): {kw['arch']} "
          f"({kw['layers']} layers, f32) on a (1, {ranks}) mesh of gloo "
          f"processes, {layout}; train step through the cell "
          f"{res['calls']['train']['s']:.3f} s a first call, "
          f"{res['calls']['train']['warm_s']:.3f} s a second (the world of "
          f"one {one['train']['s']:.3f} / {one['train']['warm_s']:.3f} s), "
          f"B {kw['batch']} x S {kw['seq']}: "
          f"loss {tr['loss'][0]:.6f} / {tr['loss'][1]:.6f} (rel "
          f"{rel['loss']:.2e}), grad norm rel {rel['grad_norm']:.2e}, worst "
          f"gradient leaf {rel['grad']:.2e} of its max ({worst}), params "
          f"{tr['update_excess']:.2e} past what the gradient differences "
          f"allow, against the world of one {'ok' if ok else 'FAIL'}")
    check(ok, f"mid-head world: the train cell differs: {rel}, {tr}")
    tol = TP_WORLD_TOL["serve"]
    bad = []
    for label, e in res["serve"].items():
        good = e["logits"][0] <= tol \
            and max(a for a, _ in e["caches"].values()) <= tol
        bad += [] if good else [label]
        print(f"mid-head world of {ranks} ({card}): {label} "
              f"({res['calls'][label]['s']:.3f} s): logits max |diff| "
              f"{e['logits'][0]:.2e} ({e['logits'][1]:.2e} of their max), "
              f"caches " + ", ".join(
                  f"{k} {a:.2e} ({r:.2e})" for k, (a, r) in sorted(
                      e["caches"].items()))
              + f" against the world of one (atol {tol:.0e}) "
              f"{'ok' if good else 'FAIL'}")
    check(not bad, f"mid-head world: serve cells differ: {bad}")
    for r, rank in enumerate(res["ranks"]):
        for label, rec in rank.items():
            same, text = _collectives_report(rec["tally"], rec["account"])
            gathered = rec["model_gathers"]
            print(f"mid-head world of {ranks}: rank {r} (slot of "
                  f"{slots[r]} heads) {label}: collectives {text}"
                  f" {'equal to' if same else 'DIFFER from'} "
                  f"dryrun.account's; attention weights all-gathered over "
                  f"model: {', '.join(map(str, gathered)) or 'none'} "
                  f"{'FAIL' if gathered else 'ok'}; {rec['s']:.3f} s"
                  + (f", peak {rec['peak'] / 1e9:.2f} GB" if rec["peak"]
                     else ""))
            check(same, f"mid-head world: rank {r} {label} collectives "
                        f"{rec['tally']} against the dry run's "
                        f"{rec['account']}")
            check(not gathered, f"mid-head world: rank {r} {label} "
                                f"gathered {gathered} over model")
    n = kw["layers"]
    want = {"train": {"flash_attention": 2 * n,
                      "flash_attention_backward": n},
            "prefill": {"flash_attention": n},
            "decode dist=False": {"decode_attention": n},
            "decode dist=True": {"decode_attention_partial": n}}
    for r in (0, ranks - 1):
        empty = slots[r] == 0
        for label, w in want.items():
            got = res["ranks"][r][label]["launches"]
            w = {k: 0 if empty and label != "decode dist=True" else v
                 for k, v in w.items()}
            check(all(got.get(k, 0) == v for k, v in w.items()),
                  f"mid-head world: rank {r} launches of {label}: {got}, "
                  f"expected {w}")
    print(f"mid-head world of {ranks} ({card}): launches on rank 0 and on "
          f"rank {ranks - 1} at their slots: " + "; ".join(
              f"rank {r} {label} " + (", ".join(
                  f"{k} {v}" for k, v in rec["launches"].items() if v)
                  or "none")
              for r in (0, ranks - 1)
              for label, rec in res["ranks"][r].items())
          + f"; the world of one's train step "
          + ", ".join(f"{k} {v}" for k, v in one["train"]["launches"].items()
                      if v))
    print(f"mid-head world of {ranks} ({card}): phase 21 in {secs:.1f} s "
          f"(budget {MIDHEAD_WORLD_SECONDS:.0f}): "
          + _stages(spawned, res["stamps"]))
    check(device == "cpu" or secs <= MIDHEAD_WORLD_SECONDS,
          f"mid-head world: phase 21 took {secs:.1f} s")
    return {**res, "seconds": secs}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    # the training phases peak within 15 GB of the card's memory, and the
    # update's leaves of many sizes leave that much cached but unusable in
    # fixed segments: growable segments keep what is reserved near what is
    # allocated (set before torch starts its allocator)
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    t_all = time.perf_counter()
    print(_card_line())           # name, power limit

    def lap(name: str) -> None:
        print(f"smoke: {name} done at {time.perf_counter() - t_all:.1f} s")
    build_all()
    lap("build_all")

    records = {"fleet_mlp": kernel_phase("cuda", time_it=True),
               "flash_attention": flash_phase("cuda", time_it=True),
               "decode_attention": decode_phase("cuda", time_it=True),
               "ssd_scan": ssd_phase("cuda", time_it=True),
               "wkv6_scan": wkv_phase("cuda", time_it=True),
               "flash_attention_backward":
                   flash_backward_phase("cuda", time_it=True),
               **scan_backward_phase("cuda", time_it=True)}
    lap("kernel phases")
    train_parity("cuda")
    lap("train_parity")
    fleet_path = forecast_flow("cuda")
    lap("forecast_flow")
    durable_serverless_flow("cuda", fleet_path)
    lap("durable_serverless_flow")
    qwen = lm_path("qwen3-1.7b", "cuda", serve_kw=QWEN_SERVE)
    zamba = lm_path("zamba2-2.7b", "cuda", serve_kw=RECURRENT_SERVE)
    rwkv = lm_path("rwkv6-7b", "cuda", serve_kw=RECURRENT_SERVE)
    lap("serve paths")
    moe_phase("cuda")
    lap("moe_phase")
    across = across_devices_phase("cuda")
    lap("across_devices_phase")
    dense_gap_phase("cuda")
    lap("dense_gap_phase")
    training_across_devices_phase("cuda",
                                  train_kw={"layers": SHARDED_TRAIN_LAYERS})
    lap("training_across_devices_phase")
    tp_world_phase("cuda")
    lap("tp_world_phase")
    ep_world_phase("cuda")
    lap("ep_world_phase")
    mamba_world_phase("cuda")
    lap("mamba_world_phase")
    rwkv_world_phase("cuda")
    lap("rwkv_world_phase")
    midhead_world_phase("cuda")
    lap("midhead_world_phase")
    lm_train_parity("cuda")
    train = lm_train_path("cuda")
    lap("qwen3 parity and train path")
    for arch, kw in RECURRENT_PARITY.items():
        lm_train_parity("cuda", arch, tol=RECURRENT_PARITY_TOL[arch], **kw)
    lap("recurrent parities")
    recurrent = {arch: lm_train_path("cuda", arch, layers=layers)
                 for arch, layers in RECURRENT_TRAIN_LAYERS.items()}
    lap("recurrent train paths")
    launcher_phase("cuda")
    guard_phase("cuda")
    lap("launcher and guard")
    # each kernel's launches on the path of the slice that ported it
    launches = {"fleet_mlp": fleet_path["launches"],
                "flash_attention": qwen["prefill"]["launches"]["flash_attention"],
                "decode_attention": qwen["serve"]["launches"]["decode_attention"],
                "ssd_scan": zamba["prefill"]["launches"]["ssd_scan"],
                "wkv6_scan": rwkv["prefill"]["launches"]["wkv6_scan"],
                "flash_attention_backward":
                    train["launches"]["flash_attention_backward"],
                "ssd_scan_backward":
                    recurrent["zamba2-2.7b"]["launches"]["ssd_scan_backward"],
                "wkv6_scan_backward":
                    recurrent["rwkv6-7b"]["launches"]["wkv6_scan_backward"]}
    # the stats route of decode_attention: its check and times (a), its
    # launches on the distributed decode path (b)
    records["decode_attention"].update(across["stats"],
                                       stats_launches=across["decode"]["launches"])
    # each attention kernel at one rank's head counts on the model axis
    # and the SSD and WKV scans at one rank's heads
    per_rank = {**tp_kernel_phase("cuda", time_it=True),
                **tp_ssd_phase("cuda", time_it=True),
                **tp_wkv_phase("cuda", time_it=True)}
    lap("per-rank kernels")
    for name, recs in per_rank.items():
        records[name]["per_rank"] = [
            {key: r.get(key) for key in (
                "label", "H", "KV", "D", "B", "S", "max_abs_err", "ms",
                "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if key in r}
            for r in recs]
    print(f"smoke: {time.perf_counter() - t_all:.1f} s in all")
    print(json.dumps(kernel_line(records, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
