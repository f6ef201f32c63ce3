"""Drive the PyTorch/CUDA port on one GPU: build, check and time every kernel,
run the CONCURRENT and GATED closed-loop campaigns, a multi-cell campaign on
one rank and on two ranks sharing the card, the campaign service, the host
E3/dApp loop and the methodology's perturbation sweep at full width, train
the AI expert, serve granite-20b at its published width through the
ARCHES-switched decoder, serve dbrx-132b and kimi-k2 (MoE) at their
published widths and zamba2-7b (hybrid), mamba2-130m (SSM), whisper-large-v3
(encoder-decoder) and gemma2-9b (local/global) whole, run the public API's
MMSE expert, train granite-20b at its published width, plan dry-run cells of
the sharded training half, and print a JSON verdict.

Usage (from the repository root, on a machine with an H100):

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for ``sm_90a``,
   one process per source, all started together;
3. kernels: each kernel at its path's shapes against its plain
   PyTorch version (switches, scatter, tree and the fused decision phase
   ``policy_step`` bitwise, the per-UE switch and the scatter out of place
   with their inputs untouched, both switches also on the LM decoder's
   (8, 49,152) bf16 logits, ``mmse_interp`` (its 4-multiply form)
   within ``MMSE_TOL`` at the host loop's, the sweep's and the closed
   loop's row counts and at n_prb 24 and 273, with each error against a
   complex128 product beside the plain version's, bitwise the same twice
   and for one UE alone or in a batch, the fused gated expert within ``GATED_F32_TOL`` /
   ``GATED_BF16_TOL`` at n_prb 24, 106 and 273 with untouched UEs bitwise,
   bitwise the same twice and one UE's estimate bitwise the same at any
   capacity, its float32 error against a float64 plain version at most
   ``GATED_EXACT_RATIO`` times the float32 plain version's, all of it at the
   paper's 32 channels, at 64 and, in the kernel's wide form, at 96 and
   128), the CONCURRENT bank's AI expert (``ai_expert_dense``: every UE
   selected into an unfilled output) whole against the plain folded form
   within the same tolerances and against float64, and equal to the masked
   call with every UE selected, with kernel, plain-version and library times and the card's lower
   bound for the same work; the switches, the scatter, ``mmse_interp`` and
   the fused gated expert (against the unfused GATED path, also at K = 32
   with every UE selected and at 64, 96 and 128 channels) and
   ``policy_step`` (against the composition it replaced, and with every
   fault mask, the TTL, the breaker and detached lanes armed over 200
   random slots) are timed against their yardstick in turns (kernel,
   library, library, kernel) and print the ratio, the scatter also against
   the per-UE switch's call over the same bytes, and the switches print the
   host time of a call alone;
3b. surface: ``mmse_interp`` in both forms (the Gauss form, the main path's,
   and the 4-multiply form) at 12, 384 and 2,016 rows against a complex128
   product (within ``MMSE_FORM_RATIO`` times the plain version's error of the
   same form) and their plain versions, timed in turns with ``torch.matmul``;
   ``mmse_interp(use_gauss=False)`` on 32 UEs' LS estimates, the 4-multiply
   kernel's path, one launch; the scalar and per-UE switches and the scatter over a two-leaf
   pytree bitwise, one launch a leaf;
3c. threefry: the generator's kernel on 256 UEs' strided keys at the slot
   loop's shapes (the TX bits' ``bernoulli`` at 127,200 a UE, the AWGN's
   ``normal`` at (4, 1,272, 14), ``uniform``, ``bits``, ``split``,
   ``fold_in``), each bitwise against its plain form on the card, one
   launch and the plain form's ``rng.words`` each, timed in turns against
   the plain form; ``bernoulli`` and ``normal`` against the least time for
   the hash's integer operations and the store's bytes;
4. main path: ``ArchesSession(...).run()`` of the closed-loop campaign at
   the paper's 106-PRB slot with 32 UEs and the estimator's default width,
   on a CONCURRENT bank (its AI expert one ``gated_expert`` launch a slot
   with every UE selected); every kernel of that path must launch during
   the run, every trajectory leaf must be finite, and the device loop must
   equal its host replay;
5. GATED main path: the same campaign on a fused GATED bank of capacity 16,
   with the same checks and the executed-FLOPs leaf held against the
   served AI count; then an unfused GATED run with ``auto_capacity`` at a
   smaller depth, which launches the scatter kernel, and a fused GATED run
   at 96 channels (the kernel's wide form) for a few slots;
5b. runtime: ``ArchesRuntime.from_spec(spec, agent=...)`` on the CONCURRENT
   session, ``run_batched(..., replay_telemetry=True)``: one indication a
   slot and source to a connected dApp, the history equal to the run without
   replay, to the session's run and to explicit ``ue_keys``, bitwise; then
   ``slot_step`` looped over ``SLOT_STEP_SLOTS`` slots equal to
   ``run(use_scan=False)`` bitwise, each kernel of the slot once a slot;
6. faults: the CONCURRENT and fused GATED closed loops, 32 slots, under
   one ``FaultSpec`` (a NaN burst, a telemetry outage, a decision outage
   past the TTL, random drops): the health screen trips in the burst and
   only there, UEs enter quarantine, the outage decays to MMSE, one
   ``tree_infer`` launch a slot, the device loop equals its host replay,
   and ``FaultSpec()`` equals ``faults=None`` on every leaf;
7. streaming: a closed-loop ``churn_cell`` campaign, 48 stable ids over
   32 bank slots in segments of 8, 32 slots: pipelined == serial, killed
   after 2 segments and resumed from its delta chain == uninterrupted,
   zero churn == monolithic, the device loop == its host replay, all
   bitwise; a fused GATED churn run; the executor's stats and ms per slot
   beside the monolithic run's; the re-pack agreement of resident UEs
   against a churn-free 48-UE run on both banks, 1.0 on every leaf read;
7b. topology: 32 UEs in four coupled cells (``multi_cell``: good, poor,
   good_poor_good, bursty_interference; coupling 0.3; noise offsets 0, 3,
   0, -3 dB), closed-loop CONCURRENT and fused GATED (capacity 16) on one
   rank with ms per slot beside the single-cell main path's; CONCURRENT
   and fused GATED at full capacity on one rank and on two ranks sharing
   the card (gloo, spawned after the build): the same bits on every
   trajectory leaf, one ``all_reduce`` a slot on each rank;
7c. service: ``CampaignService`` on the card runs a multi-cell and a
   single-cell churn campaign, each equal to a direct ``run_streaming``
   bitwise; a cancel at the first boundary keeps the checkpoint and a
   resume from it equals the uninterrupted run bitwise; the HTTP API on
   127.0.0.1 answers a status query;
8. width: the fused gated expert at ``PAST_SMEM_CHANNELS`` channels, past
   the width whose weights fit a block's shared memory, at n_prb 273 and 24
   against its plain version and the float64 rule;
9. GATED vs CONCURRENT: the same policy on a full-capacity GATED bank
   against the CONCURRENT run: the same bits on every KPM and decision;
10. host loop: ``ArchesSession(path="host")`` at n_prb 106 with the AI
   expert at its default width and a tree policy, 40 slots: the scalar
   switch must launch exactly once per slot and ``mmse_interp`` (Gauss)
   must launch, every trajectory leaf must be finite, and the loop must
   synchronise with the device exactly once per slot (its one read-back,
   by PyTorch's sync debug mode); ms per slot and the median measured
   policy time are logged;
11. perturbed sweep: ``sensitivity_sweep_batched`` on that session's engine
   at n_prb 106 (the 21 default rhos x 8 trials = 168 UEs, 8 slots a trial),
   then the stage-2 filter and ``design_policy_inputs``;
11b. train: ``train_ai_estimator`` at n_prb 106, 32 channels x 4 blocks,
   200 steps of a mixture sampler on the port's PHY: the loss falls (also on
   held-out samples), the gradient of one sample matches the CPU's within
   ``TRAIN_GRAD_RTOL``, the first 3 steps match the CPU's within
   ``TRAIN_LOSS_RTOL`` and ``TRAIN_WEIGHT_ATOL`` and themselves on the card
   bitwise (deterministic algorithms), no kernel launches, the trained weights through the fused
   ``gated_expert`` kernel match their plain folded form; ms a step;
11c. api: ``mmse_estimate`` (the public API's expert A) on ``DEFAULT_SLOT``
   for 32 UEs, the launch counts zeroed just before it and read just after
   it: ``mmse_interp`` (Gauss) launches once, and the result is within ``MMSE_TOL``
   of ``use_kernel=False``; MMSE-IRC on one UE's slot within
   ``IRC_X_ATOL`` / ``IRC_SINR_RTOL`` of the CPU;
11d. LM training: granite-20b at its published width (bf16, remat
   "block"), ``LM_TRAIN_LAYERS`` of its 52 layers, ``TokenStream`` at 4,096
   tokens, global batch 8 in 4 microbatches, ``LM_TRAIN_STEPS`` steps: the
   draw's time, ms a step, tokens/s, the step against 8 N D at the bf16
   peak, peak memory (at most ``LM_TRAIN_PEAK_GB``), the loss falling, no
   hand-written kernel launched; one step each with quantized moments and
   compressed gradients (also at half the batch) and their peaks; the
   reduced config (float32): 3
   steps card vs CPU and ``microbatches=2`` vs 1 within
   ``LM_STEP_LOSS_RTOL`` / ``LM_STEP_WEIGHT_ATOL``, a ``run_training``
   killed by ``FailureInjector`` and resumed equal to the uninterrupted run
   bitwise; ``python -m repro_torch.launch.train --steps 3`` and
   ``python examples_torch/quickstart.py --n-ues 4`` as subprocesses on the
   card, exiting 0; beside it, on the host only, the dry-run planner
   (``python -m repro_torch.launch.dryrun``) on ``DRYRUN_CELLS``, each record
   status ``ok``, the calibrated FLOP count of ``DRYRUN_CALIBRATE`` equal to
   the direct one, and ``launch/train.py --mesh single`` printing its plan
   and then raising the rank-count ``ValueError``; each record carries the
   collective, temp, accessed and peak bytes (``DRYRUN_FIELDS``), and the
   calibration's collective bytes equal the direct plan's too;
11d'. the sharded step: granite-20b at its published width, 4 of 52 layers,
   bf16, on 2 ranks sharing the card over gloo, the mesh (data 1, model 2):
   one sharded ``train_step`` on 8 x 512 tokens, a sharded ``prefill`` and
   ``decode_step``, each rank's shards of the loss, the gradient norm, the
   new weights and the logits held against the same steps on one rank
   without DTensor (``SHARDED_*`` tolerances); the collective bytes each rank
   counted equal to the fake-group plan of the same steps on the same mesh;
   ms a step and peak memory a rank;
11e. serve (after the training phase, as every LM serving phase):
   granite-20b at its published width (bf16), 4 of its 52
   layers: the weight draw's time and peak memory; ``generate`` 16 steps,
   ``SwitchedDecoder.step`` at modes 0, 1 and an (8,) vector and
   ``generate_switched`` under a dApp, the scalar and per-UE switch kernels
   launching on the bf16 logits, the selected rows the chosen expert's
   bits, the given cache untouched; tokens/s and ms a switched step by
   mode and expert against the decode step's byte bound; bf16 against
   float32 weights on the card;
11f. LM families (after the training phase, whose compressed-gradient
   step needs nearly the whole card): dbrx-132b at its published width (bf16), ``MOE_LAYERS``
   of its 40 layers, served as granite is (``generate``, switched steps at
   modes 0, 1 and a vector, ``generate_switched`` under a dApp, the switch
   kernels launching on its (8, 100,352) bf16 logits, the rows the chosen
   expert's bits, the given cache untouched), ms a decode and a switched
   step against the decode step's byte bound, tokens/s, the share of routed
   token-slots the prefill's capacity drops, bf16 against float32 at
   ``MOE_F32_LAYERS`` layer; kimi-k2-1t-a32b, ``KIMI_LAYERS`` of its 61
   (the dense first layer and one MoE layer): a prefill,
   ``KIMI_DECODE_STEPS`` decode steps and a switched step at a mode vector
   on its (8, 163,840) logits, against the bound; zamba2-7b at full width
   and depth and mamba2-130m whole, served as granite is (no
   ``generate_switched``); both switch kernels held bitwise against their
   plain versions on each family's experts' logits; each model's weights
   freed before the next draw; whisper-large-v3 at full width and depth over
   ``WHISPER_FRAMES`` stub frames (the encoder timed against its bound,
   served as granite is with ``generate_switched``, the switch kernels on its
   (8, 51,866) bf16 logits, the windowed expert the exact one's bits);
   gemma2-9b at full width and depth (``generate``, a decode step against its
   bound, a ``LONG_PREFILL``-token prefill on the chunked path with the window
   on the local layers and the softcap on all, decode steps past the window,
   ``SwitchedDecoder`` refusing it, bf16 against float32 at 2 layers); then the
   reduced configs of granite, dbrx, kimi-k2, mamba2, zamba2, qwen2-vl,
   whisper and gemma2 (float32) card against CPU: prefill and 3 switched
   steps (gemma2: decode steps) within ``LM_LOGIT_TOL``, the MoE expert
   assignment and kept mask equal, one train step within
   ``LM_STEP_LOSS_RTOL`` / ``LM_STEP_WEIGHT_ATOL``;
12. reference: small CONCURRENT, GATED, host and perturbed campaigns on the
   card against the same campaigns run by the plain versions on the CPU;
13. device alone: each kernel's and its yardstick's device time and
    launches per call, under ``torch.profiler``, queued by phase 3 (a
    profiler session slows
    every later launch on the host, so it runs after the timed paths);
14. profile: one more run of each closed loop and of the host loop under
    ``torch.profiler``: the launches per slot, the AI expert's device time
    per slot (on the fused GATED bank also launch by launch, by the UEs each
    slot served), and kernel time by name;
    then one training step: the kernels cuDNN runs for the convolutions'
    forward and backward under deterministic algorithms; then one decode
    step and one switched step of the full-width decoder, by kernel; then
    one full-width LM training step: its device busy and host shares, and
    its kernels by device time.

Each path's launch counts are zeroed just before its ``run()`` (or the
sweep) and read just after it.

The last three lines are ``{"kernels": [...]}``, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Nothing is printed as a
result when CUDA is unavailable or the package cannot be imported.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time
import typing
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
#: the SMs' full issue: 4 warp-instructions a cycle on each of 132 SMs at 1.98
#: GHz, 32 threads each (32-bit integer operations over the ALU and FMA pipes)
PEAK_ISSUE_OPS = 4 * 32 * 132 * 1.98e9
#: threefry2x32's 32-bit integer operations a word: 20 rounds of an add, a
#: rotation (one funnel shift) and a xor, 12 key additions (two before the
#: rounds and two at each of 5 injections, whose key schedule a thread forms
#: once) and the xor of the two output words
THREEFRY_OPS_PER_WORD = 73

#: mmse_interp kernel vs its plain version: both accumulate 636 fp32 products
#: per output in different orders, and the Gauss form's p3 - p1 - p2
#: cancellation doubles the error of the largest partial product; with
#: unit-variance inputs the outputs are O(10), so 1e-4 absolute is ~1e-5
#: relative -- a few hundred ulp of accumulated rounding, far below any
#: physical effect.
MMSE_TOL = 1e-4
#: fused gated expert vs its plain version (cuBLAS folded GEMMs) on the card:
#: the same 3x3 convolutions summed in another order through 2R + 3 layers,
#: the AI expert's float32 bound against the reference on the CPU
#: (tests/test_torch_ai_estimator.py); bf16 operands can round an activation
#: that differs in its last float32 bit to the neighbouring bf16 value
GATED_F32_TOL = dict(rtol=1e-4, atol=1e-5)
GATED_BF16_TOL = dict(rtol=2e-3, atol=2e-3)
#: the fused expert's float32 error against the float64 plain version may be at
#: most this multiple of the float32 plain version's: 3xTF32 with one
#: accumulator per tap errs like a float32 conv, one truncating accumulator
#: across taps errs many times more (PERF.md, the fused gated expert)
GATED_EXACT_RATIO = 4.0
#: GATED against CONCURRENT: discrete agreement the card must reach
AGREE_MIN = 0.95
#: card vs CPU on the small reference campaign: float32 stages that round
#: differently (cuBLAS and the kernel vs the CPU's GEMMs) compound through
#: the slot loop's link adaptation; 1e-3 relative is well under 0.01 dB
REF_KPM_RTOL = 1e-3

N_UES, N_PRB, N_SLOTS = 32, 106, 40
#: the generator's kernel at the benchmark cells' UEs a slot
THREEFRY_UES = 256
CHANNELS, N_RES = 32, 4
#: estimators wider than the paper's: the fused GATED kernel's widest CP form
#: (64), and its wide form (chunks of 32 channels) at 96 and 128
WIDE_CHANNELS = (64, 96, 128)
GATED_CAPACITY, UNFUSED_SLOTS = 16, 12
#: the fused GATED session at 96 channels: its width and its depth in slots
WIDE_SESSION_CHANNELS, WIDE_SESSION_SLOTS = 96, 6
#: the perturbation sweep: every default rho x this many trials rides the UE axis
SWEEP_TRIALS, SWEEP_SLOTS = 8, 8
#: the fused GATED kernel past the width whose stem and head weights fit a
#: block's shared memory (1,408 float32 channels at n_prb 273)
PAST_SMEM_CHANNELS = 1472
#: the fault campaigns' depth and TTL (their spans are in ``_fault_spec``)
FAULT_SLOTS, FAULT_TTL = 32, 4
#: the streaming campaign: bank capacity, stable ids, segment and depth
STREAM_IDS, STREAM_SEG, STREAM_SLOTS = 48, 8, 32
#: the multi-cell campaign: one scenario a cell, the cells' noise offsets,
#: the inter-cell coupling, its depth and the ranks that share the card
TOPO_CELLS = ("good", "poor", "good_poor_good", "bursty_interference")
TOPO_NOISE_DB, TOPO_COUPLING = (0.0, 3.0, 0.0, -3.0), 0.3
TOPO_SLOTS, TOPO_RANKS = 24, 2
#: AI-expert training on the card (the paper's n_prb 106, the estimator's
#: default 32 channels x 4 blocks): steps, learning rate, and the first steps
#: held against the CPU.  The tolerances of card against CPU: the same
#: float32 convolutions reduced in another order (cuDNN against oneDNN).  The
#: losses, on samples whose channel draws round differently on the two
#: devices, read 3.6e-07 relative and the weights after 3 steps 7.87e-06
#: (H100, run AL); one gradient on the same weights and sample is held per
#: leaf as max |diff| / max |g|, the check that sees a gradient wrong in
#: magnitude (AdamW's first steps are nearly lr * sign(g), so the weights
#: and losses barely see one)
TRAIN_STEPS, TRAIN_LR, TRAIN_CPU_STEPS = 200, 2e-3, 3
TRAIN_LOSS_RTOL, TRAIN_WEIGHT_ATOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4, 1e-4
#: the LM serving phase: granite-20b at its published width; the depth is cut
#: from 52 layers to SERVE_LAYERS (the weight draw's time and the script's
#: limit), nothing else
SERVE_ARCH, SERVE_LAYERS = "granite-20b", 4
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_SEQ, SERVE_WINDOW, SERVE_STEPS = 8, 128, 1024, 64, 16
#: the reduced config on the card against the CPU: the CPU tests' float32
#: tolerance against the reference (tests/test_torch_lm.py)
LM_LOGIT_TOL = dict(rtol=1e-5, atol=2e-6)
#: the LM stack's other families at their published widths (bf16), served as
#: granite is (SERVE_BATCH x SERVE_PROMPT, SERVE_MAX_SEQ, SERVE_WINDOW,
#: SERVE_STEPS).  dbrx-132b: MOE_LAYERS of its 40 layers (40 need 263 GB of
#: bf16 weights), its bf16-against-float32 check at MOE_F32_LAYERS (two draws
#: of 4 layers need 86 GB).  kimi-k2-1t-a32b: KIMI_LAYERS of its 61, the dense
#: first layer and one MoE layer (61 need 2 TB), KIMI_DECODE_STEPS decode
#: steps.  zamba2-7b at full depth; mamba2-130m whole.  Nothing else is cut
MOE_ARCH, MOE_LAYERS, MOE_F32_LAYERS = "dbrx-132b", 4, 1
KIMI_ARCH, KIMI_LAYERS, KIMI_DECODE_STEPS = "kimi-k2-1t-a32b", 2, 4
HYBRID_ARCH, SSM_ARCH = "zamba2-7b", "mamba2-130m"
#: the encoder-decoder and local/global families at their published widths and
#: depths (bf16), served as granite is.  whisper-large-v3: WHISPER_FRAMES seeded
#: stub frame embeddings a sequence (the published encoder_seq; the reference's
#: frontend is a stub); its encoder timed alone over ENCODER_ITERS calls.
#: gemma2-9b: beside the serving path one prefill of LONG_PREFILL tokens at
#: batch 1 (past 2,048 query positions: the chunked path; past the 4,096 window:
#: the local layers' window binds), then LONG_DECODE_STEPS decode steps past
#: the window.  Nothing is cut
WHISPER_ARCH, WHISPER_FRAMES, ENCODER_ITERS = "whisper-large-v3", 1500, 5
GEMMA2_ARCH, LONG_PREFILL, LONG_DECODE_STEPS = "gemma2-9b", 4608, 2
#: the reduced configs held card against CPU: the dense, MoE, SSM, hybrid, VLM,
#: encoder-decoder and local/global families
REDUCED_ARCHS = ("granite-20b", "dbrx-132b", "kimi-k2-1t-a32b", "mamba2-130m", "zamba2-7b",
                 "qwen2-vl-72b", "whisper-large-v3", "gemma2-9b")
#: the dry-run planner's cells run on the card's machine (each a subprocess of
#: ``python -m repro_torch.launch.dryrun``), and the cell whose calibrated FLOP
#: count is held against its direct count (equal up to float rounding)
DRYRUN_CELLS = (("gemma2-9b", "train_4k", "single"), ("whisper-large-v3", "prefill_32k", "multi"),
                ("kimi-k2-1t-a32b", "decode_32k", "single"))
DRYRUN_CALIBRATE, DRYRUN_CALIB_RTOL = ("gemma2-9b", "decode_32k", "single"), 1e-12
#: the record's fields a compiled program gives the reference, which the
#: sharded step on a fake group gives the port
DRYRUN_FIELDS = ("temp_bytes_per_device", "bytes_accessed_per_device", "peak_hbm_per_device",
                 "collective_bytes_per_device", "collective_bytes_total")
#: the sharded step on the card: granite-20b at its published width, bf16,
#: remat "block", SHARDED_LAYERS of its 52 layers (as the training phase),
#: on SHARDED_RANKS ranks sharing the card over gloo, the mesh (data 1, model
#: 2); one train step on SHARDED_BATCH x SHARDED_SEQ tokens at LM_TRAIN_LR,
#: then a prefill of those tokens into a cache of SHARDED_SEQ and a decode step
SHARDED_LAYERS, SHARDED_RANKS, SHARDED_BATCH, SHARDED_SEQ = 4, 2, 8, 512
SHARDED_MESH = (("data", "model"), (1, 2))
#: sharded against one rank on the same weights and batch, bf16: a product
#: split over the model axis sums its two halves' bf16 partial outputs in
#: float32 after rounding each, where one rank rounds the whole sum once
#: (2**-9 relative a product), through 4 layers and the head; the loss is a
#: float32 mean over 4,096 tokens, the gradient norm a sum over 2.1 B
#: squares of bf16 gradients.  A new weight: within 2 lr of one rank's (a
#: first AdamW step moves it lr times the sign of its gradient) plus one bf16
#: spacing of its value (the update rounded to bf16 on either side of a tie)
SHARDED_LOSS_RTOL, SHARDED_GNORM_RTOL, SHARDED_LOGIT_REL = 5e-3, 5e-2, 2e-2
#: bf16 weights against float32 weights at full width on the card: the
#: logits' relative L2 error (bf16 keeps 8 bits of mantissa, 2**-9 relative
#: rounding a weight, through 4 layers of 6,144-wide sums)
LM_BF16_REL = 0.05
#: the public API's kernel path: ``mmse_estimate`` on the main path's slot for
#: its UEs, held to ``MMSE_TOL``; MMSE-IRC on the card against the CPU on the
#: same inputs: 4x4 complex solves (cuSOLVER against LAPACK) and the
#: combiner's sums, symbols O(1) (absolute) and the SINR (relative)
IRC_X_ATOL, IRC_SINR_RTOL = 1e-4, 1e-4
#: the LM training phase: granite-20b at its published width, bf16 weights,
#: remat "block"; depth cut from 52 layers to LM_TRAIN_LAYERS (52 layers need
#: 20.3 B params x (2 B weights + 2 B gradients + 8 B float32 moments) ~ 245
#: GB, against 80 GB); the reference's TRAIN_4K sequence (4,096 tokens), its
#: global batch cut from 256 to LM_TRAIN_BATCH to fit, in LM_TRAIN_MICRO
#: microbatches; LM_TRAIN_STEPS steps for the loss curve; the run's peak
#: memory must stay under LM_TRAIN_PEAK_GB (the steps with quantized moments
#: and compressed gradients report theirs).  The learning rate is 1e-5, not
#: the launcher's smoke-size 1e-3: AdamW's first step moves every weight by
#: lr, which at d_model 6,144 moves a logit by about lr x 6,144 x E|x|; at 1e-3
#: and 1e-4 the loss rose from 12.2 to over 26 within three steps
LM_TRAIN_LAYERS, LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_MICRO = 4, 4096, 8, 4
LM_TRAIN_STEPS, LM_TRAIN_LR, LM_TRAIN_PEAK_GB = 20, 1e-5, 70.0
#: the reduced config (float32) on the card against the CPU over 3 steps, and
#: microbatches=2 against 1 on the card: the same products reduced in another
#: order (cuBLAS against oneDNN, or two halves of the batch); the CPU tests read
#: 1.8e-07 relative on the losses and 5.4e-05 on the weights against the
#: reference (tests/test_torch_train.py)
LM_STEP_LOSS_RTOL, LM_STEP_WEIGHT_ATOL = 1e-5, 1e-4


def sweep_ues() -> int:
    """UEs of the perturbation sweep: every default rho x ``SWEEP_TRIALS``."""
    from repro_torch.core.methodology import DEFAULT_RHOS

    return len(DEFAULT_RHOS) * SWEEP_TRIALS


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def turns(kernel, library, iters: int = 50) -> tuple[float, float, str]:
    """A kernel's and its yardstick's call times, taken in turns (kernel,
    library, library, kernel): the means, and both readings of each."""
    k1, l1, l2, k2 = (time_ms(f, iters) for f in (kernel, library, library, kernel))
    return ((k1 + k2) / 2, (l1 + l2) / 2,
            f"{k1 * 1e3:.2f} / {k2 * 1e3:.2f} us vs {l1 * 1e3:.2f} / {l2 * 1e3:.2f} us, "
            f"ratio {(k1 + k2) / (l1 + l2):.3f}")


def turns_of(iters: int = 50, **fns) -> tuple[dict[str, float], str]:
    """Several calls' times taken in turns (a, b, ..., ..., b, a): each mean,
    and both readings of each."""
    names = list(fns)
    first = {k: time_ms(fns[k], iters) for k in names}
    second = {k: time_ms(fns[k], iters) for k in reversed(names)}
    means = {k: (first[k] + second[k]) / 2 for k in names}
    return means, "; ".join(f"{k} {first[k] * 1e3:.2f} / {second[k] * 1e3:.2f} us"
                            for k in names)


#: device-alone measurements the kernel phases queue for ``phase_device_alone``:
#: (label, call, kernel-name substring or None for every kernel, calls)
DEVICE_ALONE: list[tuple[str, object, str | None, int]] = []


def device_alone(label: str, fn, match: str | None, iters: int = 200) -> None:
    """Queue a device-alone measurement.  They run after the main paths,
    because a ``torch.profiler`` session leaves every later launch slower on
    the host, which would bias the call and loop times taken after it."""
    DEVICE_ALONE.append((label, fn, match, iters))


def device_us(fn, match: str | None, iters: int = 200) -> tuple[float, float]:
    """Device time per call of the kernels ``fn`` launches whose name holds
    ``match`` (all of them with ``None``), from ``torch.profiler`` over
    ``iters`` calls back to back: the device work alone, without the host;
    and those kernels' launches per call.  A profiler session that records
    no device activity at all is taken again, up to three sessions: CUPTI
    has been seen on an H100 to drop a whole session's kernel records."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if device:
            break
    events = [e for e in device if match is None or match in e.key]
    if not events:
        raise AssertionError(f"the profiler saw no device kernel named {match!r}")
    return (sum(e.self_device_time_total for e in events) / iters,
            sum(e.count for e in events) / iters)


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn``, ``iters`` calls back to back."""
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    return (time.perf_counter_ns() - t0) / iters / 1e3


def bound_ms(n_bytes: float, n_flops: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} kernels compiled in "
        f"{time.perf_counter() - t0:.1f} s into {build.build_dir()}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line:  # names the lines that follow
                log(f"  ptxas {name}: {line.split('entry function')[1].split(' for ')[0]}")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels() -> list[dict]:
    from repro_torch.kernels.mmse_interp import mmse_interp, mmse_interp_ref
    from repro_torch.kernels.switch_select import (
        switch_select,
        switch_select_batched_ref,
    )
    from repro_torch.kernels.tree_infer import tree_infer, tree_infer_ref
    from repro_torch.phy.estimators import WienerInterpolator
    from repro_torch.phy.nr import SlotConfig

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cfg = SlotConfig(n_prb=N_PRB)
    rows = []

    # -- mmse_interp, the 4-multiply form: (U*ant*dmrs, Np) @ (Np, Nsc) ----------
    # (the main path's Gauss form, the reference's default, is phase_surface's)
    # at each path's row count: the host loop's one UE (12 of a 64-row tile,
    # 16 subcarriers a block), the sweep's 168 UEs (2,016 rows end in a partial
    # tile) and last the closed loop's 32 UEs, which the kernel row reports
    w = WienerInterpolator.build(cfg, device=dev).w
    per_ue = cfg.n_ant * cfg.n_dmrs_sym
    np_, nsc = cfg.n_pilot_sc, cfg.n_sc
    err, alone = 0.0, None
    for n_ues in (1, sweep_ues(), N_UES):
        b = n_ues * per_ue
        h = torch.complex(torch.randn(b, np_, generator=gen, device=dev),
                          torch.randn(b, np_, generator=gen, device=dev))
        got = mmse_interp(h, w, use_gauss=False)
        want = mmse_interp_ref(h, w, use_gauss=False)
        again = mmse_interp(h, w, use_gauss=False)
        exact = torch.matmul(h.to(torch.complex128), w.to(torch.complex128))
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        e64 = (float((got - exact).abs().max()), float((want - exact).abs().max()))
        if not e <= MMSE_TOL:
            raise AssertionError(f"mmse_interp max |err| {e} > {MMSE_TOL} at {b} rows")
        if not torch.equal(got, again):
            raise AssertionError(f"mmse_interp differs between two calls at {b} rows")
        if alone is None:
            alone = (h, got)
        err = max(err, e)
        # bound: the cheapest form at the kernel's accuracy, 3xTF32 in the Gauss
        # form (3 real GEMMs x 3 TF32 products); this kernel's 4-multiply form
        # and the fp32 CUDA-core bound are printed beside it
        n_bytes = 8.0 * (b * np_ + np_ * nsc + b * nsc)
        bms, by = bound_ms(n_bytes, 18.0 * b * np_ * nsc, PEAK_TF32_FLOPS)
        four_m_ms, _ = bound_ms(n_bytes, 24.0 * b * np_ * nsc, PEAK_TF32_FLOPS)
        f32_ms, _ = bound_ms(n_bytes, 6.0 * b * np_ * nsc)
        ms, lib, reading = turns(lambda: mmse_interp(h, w, use_gauss=False), lambda: torch.matmul(h, w))
        device_alone(f"mmse_interp at {b} rows", lambda h=h: mmse_interp(h, w, use_gauss=False),
                     "mmse_interp", 50)
        device_alone(f"torch.matmul at {b} rows", lambda h=h: torch.matmul(h, w), None, 50)
        log(f"  mmse_interp at {b} rows ({n_ues} UEs): max |err| {e:.3g} (vs complex128: "
            f"kernel {e64[0]:.3g}, plain {e64[1]:.3g}), bitwise the same twice; call "
            f"{ms * 1e3:.2f} us vs torch.matmul {lib * 1e3:.2f} us ({reading}); "
            f"bound {bms * 1e3:.2f} us (3xTF32 Gauss form, {by} at 495 TFLOP/s), the "
            f"kernel's 4-multiply form {four_m_ms * 1e3:.2f} us, fp32 bound "
            f"{f32_ms * 1e3:.2f} us")
    # one UE's rows alone and at the head of the closed loop's batch: the
    # same bits (each output is summed in one order, whatever the tile)
    one = torch.cat([alone[0], h[alone[0].shape[0]:]])
    if not torch.equal(mmse_interp(one, w, use_gauss=False)[:per_ue], alone[1]):
        raise AssertionError(f"mmse_interp: one UE's rows differ between {per_ue} and "
                             f"{b} rows")
    # accuracy at the other carrier widths, up to NR's widest at 30 kHz
    for n_prb in (24, 273):
        w2 = WienerInterpolator.build(SlotConfig(n_prb=n_prb), device=dev).w
        h2 = torch.complex(torch.randn(b, w2.shape[0], generator=gen, device=dev),
                           torch.randn(b, w2.shape[0], generator=gen, device=dev))
        got = mmse_interp(h2, w2, use_gauss=False)
        want = mmse_interp_ref(h2, w2, use_gauss=False)
        exact = torch.matmul(h2.to(torch.complex128), w2.to(torch.complex128))
        e = float((got - want).abs().max())
        if not e <= MMSE_TOL:
            raise AssertionError(f"mmse_interp max |err| {e} > {MMSE_TOL} at n_prb {n_prb}")
        log(f"  mmse_interp at {b} rows, n_prb {n_prb}: max |err| {e:.3g} (vs complex128: "
            f"kernel {float((got - exact).abs().max()):.3g}, plain "
            f"{float((want - exact).abs().max()):.3g})")
        err = max(err, e)
    plain = time_ms(lambda: mmse_interp_ref(h, w, use_gauss=False))
    rows.append(dict(
        name="mmse_interp", route="cuda", source="src/repro_torch/csrc/mmse_interp.cu",
        replaces="src/repro/kernels/mmse_interp/mmse_interp.py:54",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"H ({b}, {np_}) @ W ({np_}, {nsc}) complex64 (also checked at "
              f"{per_ue} and {sweep_ues() * per_ue} rows, and at n_prb 24 and 273)",
    ))

    # -- switch_select: (U, ant, 1, Nsc, dmrs) complex64, mixed modes -----------
    # out of place, one launch for every expert: against torch.where, the same
    # function out of place, in turns; at U = 1 and 168 and with three experts too
    shape = (N_UES, cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym)

    def cplx(shape_):
        return torch.complex(torch.randn(shape_, generator=gen, device=dev),
                             torch.randn(shape_, generator=gen, device=dev))

    for n_ues, n_exp in ((N_UES, 2), (N_UES, 3), (1, 2), (sweep_ues(), 3)):
        outs = [cplx((n_ues,) + shape[1:]) for _ in range(n_exp)]
        kept = [o.clone() for o in outs]
        for m in (torch.arange(n_ues, device=dev) % n_exp, torch.zeros(n_ues, device=dev),
                  torch.full((n_ues,), n_exp - 1, device=dev)):
            m = m.to(torch.int32)
            got = switch_select(m, outs)
            torch.cuda.synchronize()
            if not torch.equal(got, switch_select_batched_ref(m, outs)):
                raise AssertionError(f"switch_select differs from its plain version at "
                                     f"{n_ues} UEs, {n_exp} experts")
            if not all(torch.equal(o, k) for o, k in zip(outs, kept)):
                raise AssertionError("switch_select wrote into an expert output")
    des0, alt = cplx(shape), cplx(shape)
    modes = (torch.arange(N_UES, device=dev) % 3 == 0).to(torch.int32)
    plain = time_ms(lambda: switch_select_batched_ref(modes, [des0, alt]))
    mask = (modes != 0).reshape(-1, 1, 1, 1, 1)
    ms, lib, reading = turns(lambda: switch_select(modes, [des0, alt]),
                             lambda: torch.where(mask, alt, des0))
    device_alone("switch_select_batched", lambda: switch_select(modes, [des0, alt]),
                 "copy_rows_kernel")
    device_alone("torch.where, per-UE", lambda: torch.where(mask, alt, des0), None)
    n_sw = int((modes != 0).sum())
    # every UE of the fresh output is read from one expert and written once
    bms, by = bound_ms(2.0 * des0.numel() * 8 + 4 * N_UES, 0.0)
    torch.cuda.synchronize()
    host = {name: host_us(f) for name, f in (
        ("switch", lambda: switch_select(modes, [des0, alt])),
        ("torch.where", lambda: torch.where(mask, alt, des0)))}
    torch.cuda.synchronize()
    log(f"  switch_select_batched: out of place, one launch, bitwise at 1, {N_UES} and "
        f"{sweep_ues()} UEs with 2 and 3 experts, inputs untouched; call {reading} "
        f"(torch.where); host time per call alone (200 calls back to back): "
        + "; ".join(f"{k} {v:.2f} us" for k, v in host.items()))
    rows.append(dict(
        name="switch_select_batched", route="cuda",
        source="src/repro_torch/csrc/switch_select.cu",
        replaces="src/repro/kernels/switch_select/switch_select.py:156",
        launches=0, max_abs_err=0.0, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"{shape} complex64 x 2 experts, {n_sw}/{N_UES} UEs switched, out of place",
    ))

    # -- tree_infer: (U, F=10) against random level-order trees ----------------
    n_feat = 10
    x = torch.randn(N_UES, n_feat, generator=gen, device=dev)
    for depth in (2, 3, 5):
        for _ in range(20):
            n_nodes = 2**depth - 1
            feat = torch.randint(0, n_feat, (n_nodes,), generator=gen, device=dev,
                                 dtype=torch.int32)
            thr = torch.randn(n_nodes, generator=gen, device=dev)
            leaves = torch.randint(0, 2, (2**depth,), generator=gen,
                                   device=dev).to(torch.float32)
            if not torch.equal(tree_infer(x, feat, thr, leaves, depth),
                               tree_infer_ref(x, feat, thr, leaves, depth)):
                raise AssertionError(f"tree_infer differs at depth {depth}")
    feat = torch.tensor([5, 1, 3], dtype=torch.int32, device=dev)
    thr = torch.tensor([0.1, -0.2, 0.3], device=dev)
    leaves = torch.tensor([1.0, 0.0, 0.0, 1.0], device=dev)
    walk_ms = time_ms(lambda: tree_infer(x, feat, thr, leaves, 2))
    walk_plain = time_ms(lambda: tree_infer_ref(x, feat, thr, leaves, 2))
    device_alone("tree_infer (the walk alone)", lambda: tree_infer(x, feat, thr, leaves, 2),
                 "tree_infer")
    log(f"  tree_infer, the walk alone (PerUEPolicy's route): {walk_ms * 1e3:.2f} us a call, "
        f"plain {walk_plain * 1e3:.2f} us")
    rows.append(phase_policy_step(gen))

    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        log(f"kernel {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}), "
            f"max|err| {r['max_abs_err']:.3g}, {r['shape']}")
    return rows


def phase_policy_step(gen) -> dict:
    """The closed loop's decision phase for a depth-2 tree at the main path's
    shape (U = 32, a window of 8 slots over the 10 KPMs): ``policy_step`` (one
    launch) bitwise against its plain version, the composition the loop ran
    before it (``switch_update`` then ``switch_boundary``), over 200 slots of a
    drifting KPM stream with every hysteresis and period setting of the
    campaigns, then over 200 slots with the fault ladder and the streaming
    mask armed (random masks, trips and detached lanes, the TTL and the
    breaker) against ``switch_update`` -> ``switch_boundary`` ->
    ``breaker_update`` -> freeze; the call times in turns (fault-free and
    armed), and all queued for the device-alone phase, which also counts each
    one's launches per decision slot."""
    from repro_torch.core import closed_loop as tcl
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.telemetry import SELECTED_KPMS
    from repro_torch.kernels import build
    from repro_torch.kernels.tree_infer import policy_step, policy_step_ref

    dev = torch.device("cuda")
    n_feat, window, n_slots = len(SELECTED_KPMS), 8, 200
    pol = tcl.export_tree_tables([5, 1, 3], [0.1, -0.2, 0.3], [1.0, 0.0, 0.0, 1.0], device=dev)
    phase = torch.where((torch.arange(n_slots, device=dev) // 7) % 2 == 0, -1.0, 1.0)
    feats = phase[:, None, None] + torch.randn(n_slots, N_UES, n_feat, generator=gen,
                                               device=dev)
    switches = 0
    for hyst, period in ((1, 1), (3, 2)):
        cfg = tcl.SwitchConfig(feature_names=SELECTED_KPMS, window_slots=window,
                               hysteresis_slots=hyst, period_slots=period)
        state = ref = tcl.init_device_switch(N_UES, n_feat, cfg, dev)
        for s in range(n_slots):
            decide = s % period == 0
            before = build.launch_counts["tree_infer"]
            state, raw = policy_step(state, feats[s], pol, cfg, decide=decide)
            if build.launch_counts["tree_infer"] != before + 1:
                raise AssertionError("policy_step is not one launch a slot")
            ref, ref_raw = policy_step_ref(ref, feats[s], pol, cfg, decide=decide)
            same = torch.equal(raw, ref_raw) and all(
                torch.equal(a, b) for a, b in zip((*state.rings, *state[1:]),
                                                  (*ref.rings, *ref[1:])))
            if not same:
                raise AssertionError(f"policy_step differs from its plain version at slot "
                                     f"{s} (hysteresis {hyst}, period {period})")
        switches += int(state.n_switches.sum())
    if switches == 0:
        raise AssertionError("the policy step's stream never switched a UE")
    # the fault ladder and the streaming mask armed: random decision and
    # telemetry masks, trips and detached lanes, the TTL at 3 and the breaker
    faults = FaultSpec(breaker_trips=2, breaker_window=4, breaker_cooldown=3)
    armed_cfg = tcl.SwitchConfig(feature_names=SELECTED_KPMS, window_slots=window,
                                 ttl_slots=3)

    def masks(p):
        return torch.rand(n_slots, N_UES, generator=gen, device=dev) < p

    dv, tv, trip, act = masks(0.8), masks(0.8), masks(0.3), masks(0.9)
    state = ref = tcl.init_device_switch(N_UES, n_feat, armed_cfg, dev, faults=faults)
    quarantined = 0
    for s in range(n_slots):
        kw = dict(decision_valid=dv[s], telemetry_valid=tv[s], trip=trip[s], active=act[s],
                  slot_idx=s, faults=faults, return_register=True)
        before = build.launch_counts["tree_infer"]
        state, raw, reg = policy_step(state, feats[s], pol, armed_cfg, **kw)
        if build.launch_counts["tree_infer"] != before + 1:
            raise AssertionError("the armed policy_step is not one launch a slot")
        ref, ref_raw, ref_reg = policy_step_ref(ref, feats[s], pol, armed_cfg, **kw)
        same = torch.equal(raw, ref_raw) and torch.equal(reg, ref_reg) and all(
            torch.equal(a, b) for a, b in zip((*state.rings, *state[1:]),
                                              (*ref.rings, *ref[1:])))
        if not same:
            raise AssertionError(f"the armed policy_step differs from its plain version at "
                                 f"slot {s}")
        quarantined += int((state.quarantine > 0).sum())
    if quarantined == 0:
        raise AssertionError("the armed policy step's breaker never quarantined a UE")
    armed_kw = dict(decision_valid=dv[-1], telemetry_valid=tv[-1], trip=trip[-1],
                    active=act[-1], slot_idx=n_slots, faults=faults)
    armed_state = state
    cfg = tcl.SwitchConfig(feature_names=SELECTED_KPMS, window_slots=window)
    state = tcl.init_device_switch(N_UES, n_feat, cfg, dev)
    for s in range(n_slots):
        state, _ = policy_step(state, feats[s], pol, cfg)
    kpm = feats[-1]
    ms, plain, reading = turns(lambda: policy_step(state, kpm, pol, cfg),
                               lambda: policy_step_ref(state, kpm, pol, cfg))
    armed = turns_of(
        fault_free=lambda: policy_step(state, kpm, pol, cfg),
        armed=lambda: policy_step(armed_state, kpm, pol, armed_cfg, **armed_kw),
        armed_plain=lambda: policy_step_ref(armed_state, kpm, pol, armed_cfg, **armed_kw))
    device_alone("policy_step", lambda: policy_step(state, kpm, pol, cfg), "policy_step")
    device_alone("policy_step, every mask, the TTL and the breaker armed",
                 lambda: policy_step(armed_state, kpm, pol, armed_cfg, **armed_kw),
                 "policy_step")
    device_alone("decision phase before it (switch_update + switch_boundary)",
                 lambda: policy_step_ref(state, kpm, pol, cfg), None)
    # read the state and the KPMs once, write the new state, the raw decisions
    # and the register once: the ring (float32) and its idx and count (int64),
    # six (U,) int32 leaves and the breaker's trip ring; the window's adds are
    # a few thousand operations
    ring = 4.0 * N_UES * window * n_feat
    leaves = 16.0 * N_UES + 6 * 4.0 * N_UES + 4.0 * N_UES * state.trip_ring.shape[1]
    n_bytes = 2 * (ring + leaves) + 4.0 * N_UES * n_feat + 8.0 * N_UES + 40
    bms, by = bound_ms(n_bytes, 2.0 * N_UES * window * n_feat)
    armed_bytes = n_bytes + 4.0 * N_UES * (faults.breaker_window - 1) * 2 + 4.0 * N_UES
    armed_bms, _ = bound_ms(armed_bytes, 2.0 * N_UES * window * n_feat)
    torch.cuda.synchronize()
    host = host_us(lambda: policy_step(state, kpm, pol, cfg))
    host_armed = host_us(lambda: policy_step(armed_state, kpm, pol, armed_cfg, **armed_kw))
    torch.cuda.synchronize()
    log(f"  policy_step: bitwise its plain version over {n_slots} slots at hysteresis 1 / "
        f"period 1 and hysteresis 3 / period 2 ({switches} switches), and over {n_slots} "
        f"slots with random decision and telemetry masks, trips and detached lanes, TTL 3 "
        f"and the breaker ({quarantined} quarantined slot-UEs); one launch a decision slot; "
        f"call {reading} (the plain composition); fault-free vs armed in turns: "
        f"{armed[1]}; armed / fault-free {armed[0]['armed'] / armed[0]['fault_free']:.3f}; "
        f"host time per call alone {host:.2f} us fault-free, {host_armed:.2f} us armed; "
        f"bound {bms * 1e3:.4f} us fault-free, {armed_bms * 1e3:.4f} us armed")
    return dict(
        name="tree_infer", route="cuda", source="src/repro_torch/csrc/tree_infer.cu",
        replaces="src/repro/kernels/tree_infer/tree_infer.py:43",
        launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"the fused decision phase: ring ({N_UES}, {window}, {n_feat}) float32, "
              f"depth 2; armed {armed[0]['armed'] * 1e3:.2f} us",
    )


def phase_scalar_switch() -> dict:
    """The host loop's scalar switch at its shape: one UE's estimate
    ``(ant, 1, Nsc, dmrs)`` complex64, two experts.  Bitwise on both modes
    (by value and from an int32 on the card) and on a device mode that names
    no expert (the buffer is kept).  Copy and no-op call times against
    ``copy_`` in turns, the device time alone of each, and the host time of a
    call alone against ``copy_``'s, 200 calls back to back."""
    from repro_torch.kernels.switch_select import switch_select, switch_select_ref
    from repro_torch.phy.nr import SlotConfig

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    cfg = SlotConfig(n_prb=N_PRB)
    shape = (cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym)
    des0 = torch.complex(torch.randn(shape, generator=gen, device=dev),
                         torch.randn(shape, generator=gen, device=dev))
    alt = torch.complex(torch.randn(shape, generator=gen, device=dev),
                        torch.randn(shape, generator=gen, device=dev))
    for mode in (0, 1):
        want = switch_select_ref(mode, [des0, alt])
        for m in (mode, torch.tensor(mode, dtype=torch.int32, device=dev)):
            des = des0.clone()
            got = switch_select(m, [des, alt])
            torch.cuda.synchronize()
            if got.data_ptr() != des.data_ptr() or not torch.equal(got, want):
                raise AssertionError(f"scalar switch differs from its plain version, mode {mode}")
    des = des0.clone()
    got = switch_select(torch.tensor(2, dtype=torch.int32, device=dev), [des, alt])
    torch.cuda.synchronize()
    if not torch.equal(got, des0):
        raise AssertionError("scalar switch: an out-of-range device mode did not keep the buffer")
    des = des0.clone()
    copy, lib_copy, copy_reading = turns(lambda: switch_select(1, [des, alt]),
                                         lambda: des.copy_(alt), iters=200)
    noop, lib_noop, noop_reading = turns(lambda: switch_select(0, [des, alt]),
                                         lambda: des.copy_(alt), iters=200)
    plain = time_ms(lambda: switch_select_ref(1, [des0, alt]), iters=200)
    device_alone("scalar switch, copy", lambda: switch_select(1, [des, alt]),
                 "switch_select_scalar")
    device_alone("scalar switch, no-op", lambda: switch_select(0, [des, alt]),
                 "switch_select_scalar")
    device_alone("copy_ of the host leaf", lambda: des.copy_(alt), None)
    # the host bank switches into a copy of the AI estimate on a slot that
    # may switch, so that all_outputs[0] stays unswitched
    clone = time_ms(lambda: des0.clone(), iters=200)
    # under deterministic algorithms a new tensor is filled with NaN first
    empty = time_ms(lambda: torch.empty_like(des0), iters=200)
    modes = {m: torch.tensor(m, dtype=torch.int32, device=dev) for m in (0, 1)}
    lib_where = {m: time_ms(lambda m=m: torch.where(modes[m] == 0, des0, alt), iters=200)
                 for m in (0, 1)}

    # -- host time of a call alone, against copy_'s ---------------------------
    torch.cuda.synchronize()
    host = {name: host_us(f) for name, f in (
        ("copy", lambda: switch_select(1, [des, alt])),
        ("no-op", lambda: switch_select(0, [des, alt])),
        ("copy_", lambda: des.copy_(alt)))}
    torch.cuda.synchronize()
    log("  scalar switch, host time per call alone (200 calls back to back): "
        + "; ".join(f"{k} {v:.2f} us" for k, v in host.items()))
    n_bytes = des0.numel() * 8
    bms, by = bound_ms(2.0 * n_bytes, 0.0)
    log(f"kernel switch_select (scalar): copy {copy * 1e3:.2f} us ({copy_reading} copy_), "
        f"no-op {noop * 1e3:.2f} us ({noop_reading} copy_); plain "
        f"{plain * 1e3:.2f} us; torch.where mode 0 {lib_where[0] * 1e3:.2f} us / mode 1 "
        f"{lib_where[1] * 1e3:.2f} us; bound {bms * 1e3:.3f} us by {by} for the copy; the "
        f"host bank's clone of the estimate {clone * 1e3:.2f} us, of which "
        f"torch.empty_like {empty * 1e3:.2f} us; bitwise on modes 0, 1 and an out-of-range "
        f"device mode, {shape} complex64 = {n_bytes} B")
    return dict(
        name="switch_select", route="cuda", source="src/repro_torch/csrc/switch_select.cu",
        replaces="src/repro/kernels/switch_select/switch_select.py:62",
        launches=0, max_abs_err=0.0, ms=copy, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib_copy, shape=f"{shape} complex64, copy path",
    )


def phase_threefry() -> list[dict]:
    """The generator's kernel (``csrc/threefry.cu``) at the slot loop's
    shapes for ``THREEFRY_UES`` UEs, on strided keys as the slot splits them:
    each public draw bitwise against its plain form on the card, one
    ``threefry`` launch and the plain form's ``rng.words`` each; every draw
    timed in turns against its plain form; the TX bits' ``bernoulli`` and
    the AWGN's ``normal`` against the least time for the hash's integer
    operations (``THREEFRY_OPS_PER_WORD`` at ``PEAK_ISSUE_OPS``) and the
    store's bytes, and queued for device time alone."""
    from repro_torch import random as jr
    from repro_torch import tracing
    from repro_torch.kernels import build
    from repro_torch.phy.mcs import QM_VALUES
    from repro_torch.phy.nr import SlotConfig

    dev = torch.device("cuda")
    cfg = SlotConfig(n_prb=N_PRB)
    ks = jr.split_ref(jr.split_ref(jr.PRNGKey(2_900_000_029, dev), THREEFRY_UES), 4)
    k_tx, k_ch = ks[:, 0], ks[:, 1]
    tx_shape, noise_shape = (cfg.n_data_re() * max(QM_VALUES),), (cfg.n_ant, cfg.n_sc, cfg.n_sym)
    # name: (kernel, plain form, words, timed calls)
    draws = {
        "bernoulli": (lambda: jr.bernoulli(k_tx, 0.5, tx_shape),
                      lambda: jr.bernoulli_ref(k_tx, 0.5, tx_shape), 20),
        "normal": (lambda: jr.normal(k_ch, noise_shape),
                   lambda: jr.normal_ref(k_ch, noise_shape), 20),
        "uniform": (lambda: jr.uniform(k_ch, (cfg.n_sym,)),
                    lambda: jr.uniform_ref(k_ch, (cfg.n_sym,)), 200),
        "bits": (lambda: jr.bits(k_ch, (cfg.n_sc,)), lambda: jr.bits_ref(k_ch, (cfg.n_sc,)), 200),
        "split": (lambda: jr.split(k_ch, 4), lambda: jr.split_ref(k_ch, 4), 200),
        "fold_in": (lambda: jr.fold_in(k_ch, 7), lambda: jr.fold_in_ref(k_ch, 7), 200),
    }
    times = {}
    for name, (kernel, plain, iters) in draws.items():
        launches, words = build.launch_counts["threefry"], tracing.counters["rng.words"]
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        counted = 0 if name in ("split", "fold_in") else want.numel()
        if build.launch_counts["threefry"] != launches + 1:
            raise AssertionError(f"threefry {name}: {build.launch_counts['threefry'] - launches} "
                                 f"launches for one draw")
        if tracing.counters["rng.words"] != words + counted:
            raise AssertionError(f"threefry {name}: rng.words grew by "
                                 f"{tracing.counters['rng.words'] - words}, not {counted}")
        same = got.shape == want.shape and got.dtype == want.dtype and torch.equal(
            *(t.view(torch.int32) if t.dtype.is_floating_point else t for t in (got, want)))
        if not same:
            raise AssertionError(f"threefry {name} differs from its plain form at {tuple(got.shape)}")
        times[name] = turns(kernel, plain, iters) + (got.numel(),)
        del got, want
    rows = []
    for name, shape, store in (("bernoulli", tx_shape, 1), ("normal", noise_shape, 4)):
        ms, plain, reading, n = times[name]
        bms, by = bound_ms(store * n, THREEFRY_OPS_PER_WORD * n, PEAK_ISSUE_OPS)
        device_alone(f"threefry {name}", draws[name][0], "draw_kernel")
        log(f"kernel threefry {name} at {THREEFRY_UES} x {shape}: bitwise; call {reading} "
            f"(plain); {ms * 1e9 / n:.2f} ps a word (plain {plain * 1e9 / n:.1f}); bound "
            f"{bms * 1e3:.2f} us by {by} ({THREEFRY_OPS_PER_WORD} integer operations a word "
            f"at {PEAK_ISSUE_OPS / 1e12:.1f} T/s, {store} B a word stored), "
            f"{bms / ms * 100:.1f} % of it")
        rows.append(dict(
            name="threefry" if name == "bernoulli" else f"threefry_{name}", counter="threefry",
            route="cuda", source="src/repro_torch/csrc/threefry.cu",
            replaces="none: the port's own generator (the reference draws through jax.random)",
            launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
            library_ms=None, shape=f"{name} {THREEFRY_UES} x {shape}"))
    log("kernel threefry, launch-bound draws at " + f"{THREEFRY_UES} keys: " + "; ".join(
        f"{name} {times[name][0] * 1e3:.2f} us against plain {times[name][1] * 1e3:.2f} us"
        for name in ("uniform", "bits", "split", "fold_in")) + "; bitwise, one launch each")
    return rows


def _compaction(mode: torch.Tensor, capacity: int):
    """The GATED bank's stable cumsum partition: ``(idx, src)``."""
    is_gated = mode == 0
    pos = torch.cumsum(is_gated.to(torch.int32), 0, dtype=torch.int32) - 1
    src = torch.where(is_gated & (pos < capacity), pos, torch.full_like(pos, -1))
    idx = torch.argsort((~is_gated).to(torch.int32), stable=True)[:capacity]
    return idx.to(torch.int32), src


def direct_conv_flops(cfg, channels: int, n_res: int, n_rows: int) -> float:
    """FLOPs of the estimator as direct 3x3 convolutions (what the fused kernel
    executes): per antenna and layer 2 * C_out * C_in * 3 subcarrier taps *
    (3S - 2) in-range (output, input) symbol pairs * subcarriers."""
    s, np_ = cfg.n_dmrs_sym, cfg.n_pilot_sc
    pairs = 3 * s - 2
    layers = ([(2, channels, np_)] + [(channels, channels, np_)] * (2 * n_res)
              + [(channels, 2 * channels, np_), (channels, 2, 2 * np_)])
    per_ant = sum(2.0 * co * ci * 3 * pairs * length for ci, co, length in layers)
    return n_rows * cfg.n_ant * per_ant


def phase_gated_kernels() -> list[dict]:
    """The GATED slice's two kernels at the GATED main path's shapes: U = 32,
    capacity 16, 11 UEs selected (so 5 padding rows), full width.  The fused
    expert's bound is its float32 work as 3xTF32 (three TF32 products a
    product); the fp32 and bf16 bounds are logged beside it, with the cluster
    geometry.  The float32 kernel's error against a float64 plain version is
    held to ``GATED_EXACT_RATIO`` times the float32 plain version's, at n_prb
    24, 106 and 273."""
    import copy

    from repro_torch import random as jr
    from repro_torch.kernels.gated_expert import (
        ai_expert_dense,
        gated_expert_apply,
        gated_expert_apply_ref,
    )
    from repro_torch.kernels.gated_expert.ops import cluster_size
    from repro_torch.kernels.switch_select import (
        switch_gather_batched_ref,
        switch_scatter,
        switch_select,
    )
    from repro_torch.phy import ai_estimator as tai
    from repro_torch.phy.nr import SlotConfig

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    cfg = SlotConfig(n_prb=N_PRB)
    cap = GATED_CAPACITY

    def cplx(shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))

    def against_float64(label, idx, src, h_ls, des0, ai, got, want):
        """The kernel's and the float32 plain version's max |err| against the
        float64 plain version; raises past ``GATED_EXACT_RATIO``."""
        ai64 = copy.deepcopy(ai).to(torch.float64)
        exact = gated_expert_apply_ref(idx, src, h_ls.to(torch.complex128),
                                       des0.to(torch.complex128), ai64)
        e_k, e_p = (float((x - exact).abs().max()) for x in (got, want))
        log(f"  {label} f32 vs float64: kernel {e_k:.3g}, plain f32 {e_p:.3g} "
            f"({e_k / e_p:.2f}x)")
        if not e_k <= GATED_EXACT_RATIO * e_p:
            raise AssertionError(f"{label}: kernel errs {e_k:.3g} against float64, over "
                                 f"{GATED_EXACT_RATIO}x the plain version's {e_p:.3g}")

    rows = []
    mode = (torch.arange(N_UES, device=dev) % 3 != 1).to(torch.int32)  # 11 of 32 select AI
    idx, src = _compaction(mode, cap)
    n_sel = int((src >= 0).sum())

    # -- switch_gather_batched: compact (K, ant, 1, Nsc, dmrs) -> designated -------
    shape = (cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym)
    des0, compact = cplx((N_UES,) + shape), cplx((cap,) + shape)
    want = switch_gather_batched_ref(src, compact, des0)
    des, comp = des0.clone(), compact.clone()
    for _ in range(2):  # the second call finds its signature validated
        got = switch_scatter(src, compact, des)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("switch_gather kernel differs from its plain version")
        if not (torch.equal(des, des0) and torch.equal(compact, comp)):
            raise AssertionError("switch_gather wrote into an input")
    full = cplx((N_UES,) + shape)
    for m, c, k in ((torch.ones_like(mode), compact, cap),  # none selected
                    (torch.zeros_like(mode), full, N_UES),  # all selected
                    (mode, compact[:1], 1)):  # K = 1
        _, s_ = _compaction(m, k)
        d = des0.clone()
        if not torch.equal(switch_scatter(s_, c, d), switch_gather_batched_ref(s_, c, des0)):
            raise AssertionError(f"switch_gather differs at capacity {k}")
    plain = time_ms(lambda: switch_gather_batched_ref(src, compact, des0))
    sel = torch.nonzero(src >= 0).flatten()
    # all three out of place: the scatter, index_copy (its library call), and the
    # per-UE switch over the same bytes (one launch, a fresh (U, ...) output)
    alt = cplx((N_UES,) + shape)
    modes = (src < 0).to(torch.int32)
    means, reading = turns_of(
        scatter=lambda: switch_scatter(src, compact, des),
        index_copy=lambda: des.index_copy(0, sel, compact[:n_sel]),
        switch=lambda: switch_select(modes, [des, alt]))
    ms, lib = means["scatter"], means["index_copy"]
    device_alone("switch_gather_batched", lambda d=des: switch_scatter(src, compact, d),
                 "copy_rows_kernel")
    device_alone("index_copy", lambda d=des: d.index_copy(0, sel, compact[:n_sel]), None)
    torch.cuda.synchronize()
    host = {name: host_us(f) for name, f in (
        ("scatter", lambda: switch_scatter(src, compact, des)),
        ("switch", lambda: switch_select(modes, [des, alt])),
        ("index_copy", lambda: des.index_copy(0, sel, compact[:n_sel])))}
    torch.cuda.synchronize()
    log(f"  switch_gather_batched: out of place, bitwise on a second call of the same "
        f"signature; call in turns: {reading}; scatter / switch "
        f"{means['scatter'] / means['switch']:.3f}, scatter / index_copy "
        f"{means['scatter'] / means['index_copy']:.3f}; host time per call alone (200 calls "
        f"back to back): " + "; ".join(f"{k} {v:.2f} us" for k, v in host.items()))
    # every UE of the fresh output is read (compact row or fail-safe) and written
    bms, by = bound_ms(2.0 * des0.numel() * 8 + 4 * N_UES, 0.0)
    rows.append(dict(
        name="switch_gather_batched", route="cuda",
        source="src/repro_torch/csrc/switch_select.cu",
        replaces="src/repro/kernels/switch_select/switch_select.py:256",
        launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib,
        shape=f"compact ({cap},) + {shape} -> ({N_UES},) + {shape} complex64, "
              f"{n_sel}/{N_UES} UEs selected",
    ))

    # -- gated_expert: fused gather + estimator + scatter ---------------------------
    net = tai.AiEstimatorConfig(channels=CHANNELS, n_res_blocks=N_RES)
    params = tai.init_params(jr.PRNGKey(11), cfg, net)
    h_ls = cplx((N_UES, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_pilot_sc))
    des0 = cplx((N_UES,) + shape)
    kept = src < 0
    ai = tai.AiEstimator(params, cfg.n_dmrs_sym).to(dev)
    ai16 = tai.AiEstimator(params, cfg.n_dmrs_sym, torch.bfloat16).to(dev)
    modules = {None: ai, torch.bfloat16: ai16}
    errs = {}
    for cd, tol in ((None, GATED_F32_TOL), (torch.bfloat16, GATED_BF16_TOL)):
        m_ = modules[cd]
        want = gated_expert_apply_ref(idx, src, h_ls, des0, m_, compute_dtype=cd)
        des = des0.clone()
        got = gated_expert_apply(idx, src, h_ls, des, m_, compute_dtype=cd)
        again = gated_expert_apply(idx, src, h_ls, des0.clone(), m_, compute_dtype=cd)
        torch.cuda.synchronize()
        if not torch.equal(des, des0):
            raise AssertionError("gated_expert wrote into its designated input")
        if not torch.equal(got[kept], des0[kept]):
            raise AssertionError("gated_expert touched a padding row's or unselected UE")
        if not torch.equal(got, again):
            raise AssertionError("gated_expert differs between two calls")
        torch.testing.assert_close(got, want, **tol)
        errs[cd] = float((got - want).abs().max())
        if cd is None:
            against_float64(f"gated_expert at n_prb {N_PRB}", idx, src, h_ls, des0, m_, got,
                            want)
    # accuracy at the other carrier widths, one to eight blocks a cluster
    for n_prb in (24, 273):
        c2 = SlotConfig(n_prb=n_prb)
        p2 = tai.init_params(jr.PRNGKey(11), c2, net)
        h2 = cplx((N_UES, c2.n_ant, c2.n_dmrs_sym, c2.n_pilot_sc))
        d2 = cplx((N_UES, c2.n_ant, 1, c2.n_sc, c2.n_dmrs_sym))
        for cd, tol in ((None, GATED_F32_TOL), (torch.bfloat16, GATED_BF16_TOL)):
            a2 = tai.AiEstimator(p2, c2.n_dmrs_sym, cd).to(dev)
            got = gated_expert_apply(idx, src, h2, d2.clone(), a2, compute_dtype=cd)
            want = gated_expert_apply_ref(idx, src, h2, d2, a2, compute_dtype=cd)
            torch.testing.assert_close(got, want, **tol)
            log(f"  gated_expert at n_prb {n_prb} ({cluster_size(c2.n_pilot_sc)} blocks a "
                f"cluster), {'bf16' if cd else 'f32'}: max |err| "
                f"{float((got - want).abs().max()):.3g}")
            if cd is None:
                against_float64(f"gated_expert at n_prb {n_prb}", idx, src, h2, d2, a2, got,
                                want)
    ue = 10  # selected in every case: row 0 alone, row 3 of 16, row 10 of 32
    alone = torch.ones_like(mode)
    alone[ue] = 0
    outs = []
    for m, k in ((alone, 1), (mode, cap), (torch.zeros_like(mode), N_UES)):
        i_, s_ = _compaction(m, k)
        if int(s_[ue]) < 0:
            raise AssertionError(f"UE {ue} is not selected at capacity {k}")
        outs.append(gated_expert_apply(i_, s_, h_ls, des0.clone(), ai)[ue])
    if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])):
        raise AssertionError("gated_expert: one UE's estimate depends on the batch")
    # the CONCURRENT bank's AI expert: every UE selected into a fresh, unfilled
    # output, held whole against the plain folded form and the masked call
    rows_all = torch.arange(N_UES, dtype=torch.int32, device=dev)
    for cd, tol in ((None, GATED_F32_TOL), (torch.bfloat16, GATED_BF16_TOL)):
        m_ = modules[cd]
        # free a NaN block of the output's size first: the allocator hands it to
        # the output, so an element the kernel leaves unwritten reads NaN
        torch.full((N_UES,) + shape, float("nan"), dtype=torch.complex64, device=dev)
        got = ai_expert_dense(h_ls, m_, compute_dtype=cd)
        want = ai_expert_dense(h_ls, m_, compute_dtype=cd, backend="ref")
        masked = gated_expert_apply(rows_all, rows_all, h_ls, torch.zeros_like(des0), m_,
                                    compute_dtype=cd)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(torch.view_as_real(got)).all()):
            raise AssertionError("ai_expert_dense left part of its output unwritten")
        torch.testing.assert_close(got, want, **tol)
        if not torch.equal(got, masked):
            raise AssertionError("ai_expert_dense differs from gated_expert with every UE "
                                 "selected")
        log(f"  ai_expert_dense (the CONCURRENT AI expert), {'bf16' if cd else 'f32'}, "
            f"{N_UES} UEs: max |err| {float((got - want).abs().max()):.3g} against the folded "
            f"form, == gated_expert with every UE selected")
        if cd is None:
            against_float64("ai_expert_dense", rows_all, rows_all, h_ls, des0, m_, got, want)
    # wider than the paper's: 64 channels (the widest CP form), 96 and 128 (the wide
    # form, chunks of 32), held to the same rules (plain version, float64, one UE
    # bitwise at any capacity)
    wide = {}
    for ch in WIDE_CHANNELS:
        net_w = tai.AiEstimatorConfig(channels=ch, n_res_blocks=N_RES)
        p_w = tai.init_params(jr.PRNGKey(12), cfg, net_w)
        wide[ch] = tai.AiEstimator(p_w, cfg.n_dmrs_sym).to(dev)
        for cd, tol in ((None, GATED_F32_TOL), (torch.bfloat16, GATED_BF16_TOL)):
            m_ = wide[ch] if cd is None else tai.AiEstimator(p_w, cfg.n_dmrs_sym, cd).to(dev)
            got = gated_expert_apply(idx, src, h_ls, des0, m_, compute_dtype=cd)
            want = gated_expert_apply_ref(idx, src, h_ls, des0, m_, compute_dtype=cd)
            torch.testing.assert_close(got, want, **tol)
            if not torch.equal(got[kept], des0[kept]):
                raise AssertionError(f"gated_expert at {ch} channels touched an unselected UE")
            log(f"  gated_expert at {ch} channels, {'bf16' if cd else 'f32'}: max "
                f"|err| {float((got - want).abs().max()):.3g}")
            if cd is None:
                against_float64(f"gated_expert at {ch} channels", idx, src, h_ls, des0, m_,
                                got, want)
        outs = []
        for m, k in ((alone, 1), (mode, cap), (torch.zeros_like(mode), N_UES)):
            i_, s_ = _compaction(m, k)
            outs.append(gated_expert_apply(i_, s_, h_ls, des0, wide[ch])[ue])
        if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])):
            raise AssertionError(f"gated_expert at {ch} channels: one UE's estimate depends "
                                 f"on the batch")

    def unfused():  # the unfused GATED path: gather, cuBLAS forward, scatter kernel
        compact_out = ai(h_ls.index_select(0, idx.to(torch.int64)))
        return switch_scatter(src, compact_out, des)

    des = des0.clone()
    ms, lib, reading = turns(lambda: gated_expert_apply(idx, src, h_ls, des, ai), unfused,
                             iters=20)
    ms16, _, reading16 = turns(lambda: gated_expert_apply(idx, src, h_ls, des, ai16,
                                                          compute_dtype=torch.bfloat16),
                               unfused, iters=20)
    plain = time_ms(lambda: gated_expert_apply_ref(idx, src, h_ls, des0, ai), iters=20)
    # K = 32 with every UE selected: 128 (row, antenna) chains
    i32, s32 = _compaction(torch.zeros_like(mode), N_UES)
    ms32, lib32, reading32 = turns(
        lambda: gated_expert_apply(i32, s32, h_ls, des, ai),
        lambda: switch_scatter(s32, ai(h_ls.index_select(0, i32.to(torch.int64))), des),
        iters=10)
    wide_times = {}  # channels -> (call, unfused, reading)
    for ch, m_ in wide.items():
        wide_times[ch] = turns(
            lambda m_=m_: gated_expert_apply(idx, src, h_ls, des, m_),
            lambda m_=m_: switch_scatter(src, m_(h_ls.index_select(0, idx.to(torch.int64))),
                                         des),
            iters=10)
    for label, fn in (("gated_expert f32", lambda: gated_expert_apply(idx, src, h_ls, des, ai)),
                      ("gated_expert bf16", lambda: gated_expert_apply(
                          idx, src, h_ls, des, ai16, compute_dtype=torch.bfloat16)),
                      ("gated_expert f32, K 32 all selected",
                       lambda: gated_expert_apply(i32, s32, h_ls, des, ai)),
                      *((f"gated_expert f32, {ch} channels",
                         lambda m_=m_: gated_expert_apply(idx, src, h_ls, des, m_))
                        for ch, m_ in wide.items())):
        device_alone(label, fn, "gated_expert", 20)
    device_alone("unfused GATED path", unfused, None, 20)
    flops = direct_conv_flops(cfg, CHANNELS, N_RES, n_sel)
    io_bytes = 8.0 * n_sel * cfg.n_ant * cfg.n_dmrs_sym * (cfg.n_pilot_sc + cfg.n_sc)
    w_bytes = 4.0 * (ai.kernel_w.numel() + ai.kernel_b.numel())
    # bound: the kernel's float32 accuracy as 3xTF32 (three TF32 products a product);
    # the CUDA cores' fp32 bound and bf16's bound beside it
    bms, by = bound_ms(io_bytes + w_bytes, 3.0 * flops, PEAK_TF32_FLOPS)
    f32_ms, _ = bound_ms(io_bytes + w_bytes, flops)
    bf16_ms, _ = bound_ms(io_bytes + w_bytes, flops, PEAK_BF16_FLOPS)
    b32_ms, _ = bound_ms(io_bytes * N_UES / n_sel + w_bytes,
                         3.0 * direct_conv_flops(cfg, CHANNELS, N_RES, N_UES), PEAK_TF32_FLOPS)
    n_cl = cluster_size(cfg.n_pilot_sc)
    log(f"  gated_expert: clusters of {n_cl} blocks, "
        f"{-(-cfg.n_pilot_sc // n_cl)} subcarriers a block, {n_sel * cfg.n_ant * n_cl} blocks at "
        f"K {cap}")
    log(f"  gated_expert f32 vs the unfused path: {reading}; bf16: {reading16}; "
        f"K {N_UES} all selected vs unfused: {reading32}")
    for ch, (ms_w, lib_w, reading_w) in wide_times.items():
        b_w, _ = bound_ms(io_bytes, 3.0 * direct_conv_flops(cfg, ch, N_RES, n_sel),
                          PEAK_TF32_FLOPS)
        log(f"  gated_expert at {ch} channels ({'CP' if ch <= 64 else 'wide'} form) vs the "
            f"unfused path: {reading_w}; call {ms_w * 1e3:.2f} us, {ms_w / b_w:.2f}x its 3xTF32 "
            f"bound {b_w * 1e3:.2f} us, {ms_w / ms:.2f}x the {CHANNELS}-channel call")
    log(f"  gated_expert max |err| f32 {errs[None]:.3g}, bf16 {errs[torch.bfloat16]:.3g}; "
        f"bound {bms * 1e3:.2f} us (3xTF32, {by}), fp32 "
        f"bound {f32_ms * 1e3:.2f} us, bf16 bound {bf16_ms * 1e3:.2f} us, 3xTF32 bound at K "
        f"{N_UES} all selected {b32_ms * 1e3:.2f} us")
    rows.append(dict(
        name="gated_expert", route="cuda", source="src/repro_torch/csrc/gated_expert.cu",
        replaces="src/repro/kernels/gated_expert/gated_expert.py:67",
        launches=0, max_abs_err=errs[None], ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib,
        shape=f"K {cap}, {n_sel} rows valid, {CHANNELS} ch x {N_RES} blocks, "
              f"{flops / 1e9:.2f} GFLOP as direct convs; bf16 {ms16 * 1e3:.2f} us; "
              f"K {N_UES} all selected {ms32 * 1e3:.2f} us "
              f"(unfused {lib32 * 1e3:.2f} us); "
              + "; ".join(f"{ch} ch {t[0] * 1e3:.2f} us (unfused {t[1] * 1e3:.2f} us)"
                          for ch, t in wide_times.items())
              + f"; one UE bitwise at K 1, {cap}, {N_UES}",
    ))
    for r in rows:
        log(f"kernel {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library {r['library_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}), "
            f"max|err| {r['max_abs_err']:.3g}, {r['shape']}")
    return rows


def _main_spec(channels: int = CHANNELS, **bank):
    from repro_torch.core.session import CampaignSpec, ExpertBankSpec, PolicySpec

    return CampaignSpec(
        path="closed_loop", scenario="good_poor_good",
        scenario_args=(("poor_start", 13), ("poor_end", 27)), n_prb=N_PRB,
        n_ues=N_UES, n_slots=N_SLOTS, seed=7,
        bank=ExpertBankSpec(channels=channels, n_res_blocks=N_RES, **bank),
        policies=(PolicySpec(kind="tree"),),
    )


def _check_history(sess, hist, n_slots: int) -> None:
    if hist.modes.shape != (n_slots, N_UES):
        raise AssertionError(f"modes shape {hist.modes.shape}")
    for name, v in list(hist.kpms.items()) + list(hist.outputs.items()):
        if not np.isfinite(np.asarray(v, np.float64)).all():
            raise AssertionError(f"trajectory leaf {name} is not finite")
    replay = sess.host_replay(hist)
    if not np.array_equal(hist.modes, replay["active_mode"]):
        bad = np.argwhere(hist.modes != replay["active_mode"])[0]
        raise AssertionError(f"device loop != host replay at (slot, UE) {tuple(bad)}")
    if not np.array_equal(hist.decisions, replay["raw_decision"]):
        raise AssertionError("device decisions != host replay decisions")


#: ms per slot of each path's second run, by its label
LOOP_MS: dict[str, float] = {}


def run_path(label: str, spec, kernels: tuple[str, ...], *, host_policies=None,
             auto_capacity: bool = False, rerun: bool = True):
    """One closed-loop ``ArchesSession.run()`` on the card.

    The counts are zeroed just before ``run()`` (with ``host_policies`` unset
    that includes the policy profiling and the tree fit) and read just
    after it; every kernel in ``kernels`` must have launched.  With
    ``rerun`` a second ``run()`` on the same session (tree already fitted)
    times the closed loop alone.
    """
    from repro_torch.core.session import ArchesSession
    from repro_torch.kernels import build

    sess = ArchesSession(spec, device="cuda", host_policies=host_policies)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    hist = sess.run(auto_capacity=auto_capacity)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label} never launched {missing}: {launches}")
    _check_history(sess, hist, spec.n_slots)
    msg = (f"{label}: closed loop {spec.n_slots} slots x {N_UES} UEs, n_prb {N_PRB}, "
           f"AI {spec.bank.channels} ch x {N_RES} blocks; first run {first_s:.2f} s")
    if rerun:
        t0 = time.perf_counter()
        sess.run()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        LOOP_MS[label] = loop_s / spec.n_slots * 1e3
        msg += (f"; closed loop {loop_s:.3f} s = {spec.n_slots * N_UES / loop_s:.1f} "
                f"slot-UEs/s ({loop_s / spec.n_slots * 1e3:.2f} ms/slot)")
    log(f"{msg}; AI share {hist.ai_share:.4f}; switches {int(hist.n_switches.sum())}; "
        f"overflow slot-UEs {hist.overflow_slot_ues}; launches {launches}; "
        f"device loop == host replay on {hist.modes.size} slot-UEs")
    return sess, hist, launches


def check_executed_flops(sess, hist) -> None:
    """GATED cost leaf: per slot, served AI UEs x AI FLOPs + U x MMSE FLOPs."""
    ai, mmse = (e.flops for e in sess.engine.bank.experts)
    served = (hist.modes == 0) & (hist.outputs["gated_overflow"] == 0)
    want = served.sum(axis=1) * np.float64(ai) + N_UES * np.float64(mmse)
    got = hist.executed_flops_per_slot()
    if not np.allclose(got, want, rtol=1e-6, atol=0.0):
        raise AssertionError(f"executed_flops per slot {got} != {want}")
    log(f"GATED cost: executed {got.sum() / 1e9:.2f} GFLOP over {hist.modes.shape[0]} "
        f"slots == served AI x {ai / 1e9:.3f} G + {N_UES} x MMSE {mmse / 1e6:.3f} M per slot")


def agreement(got, want, label: str) -> tuple[dict, float]:
    """Agreement rates of the discrete leaves, and the worst relative KPM
    difference over slot-UEs whose discrete path agreed so far."""
    agree = {k: float(np.mean(a == b)) for k, (a, b) in {
        "active_mode": (got.modes, want.modes),
        "mcs": (got.outputs["mcs"], want.outputs["mcs"]),
        "tb_ok": (got.outputs["tb_ok"], want.outputs["tb_ok"]),
    }.items()}
    same = np.cumprod((got.modes == want.modes)
                      & (got.outputs["mcs"] == want.outputs["mcs"])
                      & (got.outputs["tb_ok"] == want.outputs["tb_ok"]), axis=0) > 0
    worst = 0.0
    for name, w in want.kpms.items():
        rel = np.abs(got.kpms[name] - w) / (np.abs(w) + 1e-3)
        worst = max(worst, float(rel[same].max(initial=0.0)))
    log(f"{label}: agreement {agree}, max relative KPM difference {worst:.3g} over "
        f"{int(same.sum())} of {same.size} slot-UEs on an agreeing path")
    return agree, worst


def phase_gated_vs_concurrent(conc_hist, host_policies) -> None:
    """The CONCURRENT main path's policy on a full-capacity f32 GATED bank:
    the same campaign.  Both banks run the AI expert through the fused
    kernel, which keeps each UE's bits at any batch and row, so below
    capacity the two are the same bits on every shared leaf."""
    from repro_torch.core.session import ArchesSession

    spec = _main_spec(execution_mode="gated", fused=True)
    hist = ArchesSession(spec, device="cuda", host_policies=host_policies).run()
    agree, _ = agreement(hist, conc_hist, "GATED vs CONCURRENT on the card, capacity None")
    bitwise = {k: float(np.mean(hist.kpms[k] == v)) for k, v in conc_hist.kpms.items()}
    log(f"GATED vs CONCURRENT below capacity: share of slot-UEs with the same bits, by KPM: "
        f"{bitwise}")
    if min(agree.values()) < 1.0 or min(bitwise.values()) < 1.0:
        raise AssertionError(f"GATED and CONCURRENT differ below capacity: {agree}, {bitwise}")
    if not np.array_equal(hist.decisions, conc_hist.decisions):
        raise AssertionError("GATED and CONCURRENT decisions differ below capacity")


def phase_reference() -> None:
    """Small campaigns on the card against the plain versions on the CPU.

    The CPU session fits the tree; the card's session gets that tree, so
    both run one policy.  Kernels, cuBLAS and the CPU's GEMMs round
    differently, so discrete leaves are compared as agreement rates and
    continuous KPMs within ``REF_KPM_RTOL`` while the UE's discrete path
    (mode, MCS, TB outcome) still agrees.
    """
    from repro_torch.core.session import (
        ArchesSession,
        CampaignSpec,
        ExpertBankSpec,
        PolicySpec,
    )

    closed = [CampaignSpec(
        path="closed_loop", scenario="good_poor_good",
        scenario_args=(("poor_start", 4), ("poor_end", 8)), n_prb=24, n_ues=n_ues,
        n_slots=12, seed=7, bank=bank, policies=(PolicySpec(kind="tree"),),
    ) for n_ues, bank in ((2, ExpertBankSpec()), (3, ExpertBankSpec(
        execution_mode="gated", gated_capacity=2, fused=True)))]
    perturbed = CampaignSpec(path="perturbed", scenario="good", n_prb=24, n_ues=4,
                             n_slots=8, seed=7, rho=(0.0, 0.5, 1.0, 1.5))
    for label, spec in (("CONCURRENT", closed[0]), ("GATED fused, capacity 2", closed[1]),
                        ("host", _host_spec(24, 12, (4, 8))), ("perturbed", perturbed)):
        n_ues = spec.n_ues
        cpu_sess = ArchesSession(spec, device="cpu")
        want = cpu_sess.run()
        policies = cpu_sess.host_policies if spec.policies else None
        got = ArchesSession(spec, device="cuda", host_policies=policies).run()
        agree, worst = agreement(got, want, f"reference {label}: card vs CPU plain "
                                            f"versions, n_prb 24, {n_ues} UEs x "
                                            f"{spec.n_slots} slots")
        if agree["active_mode"] < AGREE_MIN or worst > REF_KPM_RTOL:
            raise AssertionError(f"card and CPU disagree: {agree}, KPM {worst}")


def _host_spec(n_prb: int, n_slots: int, poor: tuple[int, int], **bank):
    from repro_torch.core.session import CampaignSpec, ExpertBankSpec, PolicySpec

    return CampaignSpec(
        path="host", scenario="good_poor_good",
        scenario_args=(("poor_start", poor[0]), ("poor_end", poor[1])), n_prb=n_prb,
        n_ues=1, n_slots=n_slots, seed=7, bank=ExpertBankSpec(**bank),
        policies=(PolicySpec(kind="tree"),),
    )


def phase_host():
    """The host E3/dApp loop at full width: one UE, n_prb 106, the AI expert
    at its default width, a tree policy profiled on the batched engine.

    The counts are zeroed just before ``run()`` (profiling and tree fit
    included; they run the batched switch, not the scalar one) and read
    just after it: the scalar switch must launch once per slot.  A second
    ``run()`` times the host loop alone, and a third counts the device
    synchronisations with PyTorch's sync debug mode: one a slot.
    """
    import warnings

    from repro_torch.core.session import ArchesSession
    from repro_torch.kernels import build

    spec = _host_spec(N_PRB, N_SLOTS, (13, 27), channels=CHANNELS, n_res_blocks=N_RES)
    sess = ArchesSession(spec, device="cuda")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    hist = sess.run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    if launches["switch_select"] != N_SLOTS or launches["mmse_interp_gauss"] == 0:
        raise AssertionError(f"host loop launches {launches}: want switch_select == "
                             f"{N_SLOTS} and mmse_interp > 0")
    if hist.modes.shape != (N_SLOTS, 1):
        raise AssertionError(f"host modes shape {hist.modes.shape}")
    for name, v in list(hist.kpms.items()) + list(hist.outputs.items()):
        if not np.isfinite(np.asarray(v, np.float64)).all():
            raise AssertionError(f"host trajectory leaf {name} is not finite")
    t0 = time.perf_counter()
    sess.run()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    policy_us = [d.policy_us for d in sess.dapp.decisions]
    e2e_us = [d.end_to_end_us for d in sess.dapp.decisions]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sess.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's one-time notice on first use ("Synchronization debug mode is
    # a prototype feature ...") names synchronizing operations but is not one
    sync_at = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message) and "debug mode" not in str(w.message))
    syncs = sum(sync_at.values())
    log(f"host loop: {N_SLOTS} slots x 1 UE, n_prb {N_PRB}, AI {CHANNELS} ch x {N_RES} blocks; "
        f"first run (profiling 2 x {N_SLOTS} slots + tree fit + loop) {first_s:.2f} s; host "
        f"loop {loop_s:.3f} s = {loop_s / N_SLOTS * 1e3:.2f} ms/slot; {len(policy_us)} "
        f"decisions, median policy time {np.median(policy_us):.2f} us (host tree walk), "
        f"median modelled end-to-end {np.median(e2e_us):.2f} us (the paper's constants); "
        f"device syncs (sync debug mode) {syncs} = {syncs / N_SLOTS:.2f} per slot; AI share "
        f"{hist.ai_share:.4f}; modes {''.join(map(str, hist.modes[:, 0]))}; launches {launches}")
    log(f"host loop syncs by line: {dict(sync_at)}")
    if syncs != N_SLOTS:
        raise AssertionError(f"host loop: {syncs} device syncs in {N_SLOTS} slots, want one "
                             f"a slot (the read-back): {dict(sync_at)}")
    return sess, launches


def phase_sweep(sess) -> None:
    """Stage 1 at full width on the host session's engine, then stages 2-3."""
    from repro_torch.core.methodology import (
        DEFAULT_RHOS,
        design_policy_inputs,
        monotonicity_filter,
        sensitivity_sweep_batched,
    )
    from repro_torch.kernels import build

    engine = sess.engine
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    sweep = sensitivity_sweep_batched(engine, sess.schedule, rhos=DEFAULT_RHOS,
                                      n_trials=SWEEP_TRIALS, slots_per_trial=SWEEP_SLOTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    if launches["mmse_interp_gauss"] != SWEEP_SLOTS:
        raise AssertionError(f"sweep launches {launches}: want mmse_interp_gauss == "
                             f"{SWEEP_SLOTS}")
    if not np.isfinite(sweep.samples).all():
        raise AssertionError("sweep samples are not finite")
    snr = sweep.kpm_names.index("snr")
    if not sweep.means[-1, snr] < sweep.means[0, snr]:
        raise AssertionError("the perturbation did not lower the SNR")
    kept = monotonicity_filter(sweep)
    flat = {n: sweep.samples[:, :, k].reshape(-1) for k, n in enumerate(sweep.kpm_names)}
    aerial_names = ("code_rate", "sinr", "qam_order", "mcs_index", "tb_size",
                    "n_code_blocks", "pdu_length", "ndi", "rsrp")
    aerial = {n: v for n, v in flat.items() if n in aerial_names}
    oai = {n: v for n, v in flat.items() if n not in aerial_names}
    selected, _, _ = design_policy_inputs(aerial, oai)
    n_ues = len(DEFAULT_RHOS) * SWEEP_TRIALS
    log(f"perturbed sweep: {len(DEFAULT_RHOS)} rhos x {SWEEP_TRIALS} trials = {n_ues} UEs x "
        f"{SWEEP_SLOTS} slots at n_prb {N_PRB}: {wall:.3f} s wall "
        f"({wall / SWEEP_SLOTS * 1e3:.1f} ms/slot); snr {sweep.means[0, snr]:.2f} dB at rho 0 "
        f"-> {sweep.means[-1, snr]:.2f} dB at rho 2; monotonic (|spearman| >= 0.8): "
        f"{sorted(kept)}; design_policy_inputs keeps {list(selected)}; launches {launches}")


def phase_wide_width() -> None:
    """The fused GATED kernel past the width whose stem and head weights fit a
    block's shared memory: ``PAST_SMEM_CHANNELS`` channels (one residual block)
    at n_prb 273 and 24, float32 against its plain version and the float64
    rule, bf16 at n_prb 24; the call and the unfused path timed in turns."""
    import copy

    from repro_torch import random as jr
    from repro_torch.kernels import build
    from repro_torch.kernels.gated_expert import gated_expert_apply, gated_expert_apply_ref
    from repro_torch.kernels.gated_expert.ops import _launch, _smem_optin
    from repro_torch.phy import ai_estimator as tai
    from repro_torch.phy.nr import SlotConfig

    dev = torch.device("cuda")
    ch = PAST_SMEM_CHANNELS
    smem = build.function("gated_expert", "gated_expert_smem_bytes", [ctypes.c_int] * 5,
                          ctypes.c_longlong)
    for n_prb, dtypes in ((273, (None,)), (24, (None, torch.bfloat16))):
        cfg = SlotConfig(n_prb=n_prb)
        staged = smem(cfg.n_dmrs_sym, cfg.n_pilot_sc, ch, 0, 0)
        direct = smem(cfg.n_dmrs_sym, cfg.n_pilot_sc, ch, 0, 1)
        params = tai.init_params(jr.PRNGKey(ch, dev), cfg,
                                 tai.AiEstimatorConfig(channels=ch, n_res_blocks=1))
        gen = torch.Generator(device=dev).manual_seed(n_prb)
        for layer in [params] + params["res"]:
            for k in [k for k in layer if k.endswith("_b") or k in ("b1", "b2")]:
                layer[k] = 0.1 * torch.randn(layer[k].shape, generator=gen, device=dev)

        def cplx(shape):
            return torch.complex(torch.randn(shape, generator=gen, device=dev),
                                 torch.randn(shape, generator=gen, device=dev))

        h_ls = cplx((3, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_pilot_sc))
        des0 = cplx((3, cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym))
        idx = torch.tensor([0, 2], dtype=torch.int32, device=dev)
        src = torch.tensor([0, -1, 1], dtype=torch.int32, device=dev)
        for cd in dtypes:
            ai = tai.AiEstimator(params, cfg.n_dmrs_sym, cd).to(dev)
            got = gated_expert_apply(idx, src, h_ls, des0, ai, compute_dtype=cd)
            want = gated_expert_apply_ref(idx, src, h_ls, des0, ai, compute_dtype=cd)
            torch.cuda.synchronize()
            if not torch.equal(got[1], des0[1]):
                raise AssertionError("the wide kernel wrote an unselected UE")
            e = float((got - want).abs().max())
            tol = GATED_F32_TOL if cd is None else GATED_BF16_TOL
            torch.testing.assert_close(got, want, **tol)
            msg = (f"  gated_expert at {ch} channels, n_prb {n_prb}, "
                   f"{'bf16' if cd is not None else 'float32'}: shared memory a block "
                   f"{staged} B staged / {direct} B with the weights in global memory "
                   f"(the card grants {_smem_optin(0)}); max |err| vs plain {e:.3g}")
            if cd is None:
                exact = gated_expert_apply_ref(idx, src, h_ls.to(torch.complex128),
                                               des0.to(torch.complex128),
                                               copy.deepcopy(ai).to(torch.float64))
                e_k, e_p = (float((x - exact).abs().max()) for x in (got, want))
                if not e_k <= GATED_EXACT_RATIO * e_p:
                    raise AssertionError(f"wide kernel vs float64 {e_k:.3g} > "
                                         f"{GATED_EXACT_RATIO} x plain {e_p:.3g}")
                msg += f"; vs float64: kernel {e_k:.3g}, plain {e_p:.3g}"
                if n_prb == 273:
                    t, reading = turns_of(
                        iters=3,
                        kernel=lambda: gated_expert_apply(idx, src, h_ls, des0, ai),
                        unfused=lambda: gated_expert_apply_ref(idx, src, h_ls, des0, ai))
                    bms, _ = bound_ms(0.0, 3 * direct_conv_flops(cfg, ch, 1, 2),
                                      PEAK_TF32_FLOPS)
                    msg += (f"; call {t['kernel'] * 1e3:.1f} us, {t['kernel'] / bms:.2f}x its "
                            f"3xTF32 bound {bms * 1e3:.1f} us, vs unfused "
                            f"{t['unfused'] * 1e3:.1f} us ({reading})")
            log(msg)
            del ai, got, want
        del params, h_ls, des0
        torch.cuda.empty_cache()
    # the cost of the global-weight variant where both fit: 128 channels at
    # the main path's n_prb, 11 of 16 rows selected, the two variants in turns
    cfg = SlotConfig(n_prb=N_PRB)
    params = tai.init_params(jr.PRNGKey(128, dev), cfg,
                             tai.AiEstimatorConfig(channels=128, n_res_blocks=N_RES))
    ai = tai.AiEstimator(params, cfg.n_dmrs_sym).to(dev)
    gen = torch.Generator(device=dev).manual_seed(128)
    h_ls = torch.complex(*(torch.randn(N_UES, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_pilot_sc,
                                       generator=gen, device=dev) for _ in range(2)))
    des0 = torch.complex(*(torch.randn(N_UES, cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym,
                                       generator=gen, device=dev) for _ in range(2)))
    idx, src = _compaction((torch.arange(N_UES, device=dev) % 3 == 0).to(torch.int32),
                           GATED_CAPACITY)
    variants = {g: (lambda g=g: _launch(idx, src, h_ls, des0, ai, None, global_weights=g))
                for g in (False, True)}
    if not torch.equal(variants[False](), variants[True]()):
        raise AssertionError("the global-weight variant differs from the staged wide form")
    t, reading = turns_of(iters=10, staged=variants[False], global_weights=variants[True])
    log(f"  gated_expert at 128 channels, n_prb {N_PRB}, K {GATED_CAPACITY}: the "
        f"global-weight variant bitwise the staged form; {reading}; global / staged "
        f"{t['global_weights'] / t['staged']:.3f}")


#: each form of ``mmse_interp`` against a complex128 product: at most this many
#: times its plain float32 version's error
MMSE_FORM_RATIO = 4.0
#: slots of the public one-slot step's loop (``phase_runtime``)
SLOT_STEP_SLOTS = 4


def _leaf_pairs(got, want, name: str = ""):
    """(name, got leaf, want leaf) over two nested dicts of tensors."""
    if isinstance(got, dict):
        if set(got) != set(want):
            raise AssertionError(f"{name}: keys {sorted(got)} vs {sorted(want)}")
        for k in got:
            yield from _leaf_pairs(got[k], want[k], f"{name}.{k}" if name else k)
    else:
        yield name, got, want


def _bitwise(got, want, label: str) -> None:
    for name, x, y in _leaf_pairs(got, want):
        xs, ys = (torch.view_as_real(t) if t.is_complex() else t for t in (x, y))
        if x.dtype != y.dtype or not torch.equal(xs, ys):
            raise AssertionError(f"{label}: leaf {name} differs")


def phase_surface() -> tuple[dict, dict[str, int]]:
    """The reference's surface the port gained last, at the main path's width
    (the paper's 106-PRB, 4-antenna, 3-DMRS slot, 32 UEs).

    ``mmse_interp`` in both forms at the host loop's 12, the closed loop's 384
    and the sweep's 2,016 rows: each against a complex128 product (within
    ``MMSE_FORM_RATIO`` times its plain float32 version's error) and against
    its plain version of the same form (``MMSE_TOL``), bitwise the same twice;
    both forms and ``torch.matmul`` timed in turns and queued for their device
    time.  The public kernel entry asked for the 4-multiply form on the
    slot's LS estimates of 32 UEs, ``mmse_interp(ls_estimate(...), w,
    use_gauss=False)`` (what ``mmse_estimate`` does in the Gauss form), with
    the counts zeroed just before and read just after: the 4-multiply
    kernel's one launch, its row's (the main path runs the Gauss form, the
    reference's default).  The three
    switch kernels over a two-leaf pytree (an estimate and a noise variance:
    one UE's for the scalar switch, 32 UEs' for the per-UE switch and the
    scatter), bitwise their plain versions, one launch a leaf a call.
    Returns the Gauss form's row and the 4-multiply path's launch counts."""
    from repro_torch import random as jr
    from repro_torch.kernels import build
    from repro_torch.kernels.mmse_interp import mmse_interp, mmse_interp_ref
    from repro_torch.kernels.switch_select import (
        switch_gather_batched_tree_ref,
        switch_scatter,
        switch_select,
        switch_select_batched_tree_ref,
        switch_select_tree_ref,
    )
    from repro_torch.phy import DEFAULT_SLOT, mmse_estimate
    from repro_torch.phy.dmrs import dmrs_sequence
    from repro_torch.phy.estimators import WienerInterpolator, ls_estimate

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    cfg = DEFAULT_SLOT
    if (cfg.n_prb, cfg.n_ant, cfg.n_dmrs_sym) != (N_PRB, 4, 3):
        raise AssertionError(f"DEFAULT_SLOT is not the main path's slot: {cfg}")

    def cplx(shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))

    # -- mmse_interp, both forms ------------------------------------------------
    w = WienerInterpolator.build(cfg, device=dev).w
    per_ue = cfg.n_ant * cfg.n_dmrs_sym
    np_, nsc = cfg.n_pilot_sc, cfg.n_sc
    err = 0.0
    for n_ues in (1, N_UES, sweep_ues()):
        b = n_ues * per_ue
        h = cplx((b, np_))
        exact = torch.matmul(h.to(torch.complex128), w.to(torch.complex128))
        notes = []
        for gauss in (True, False):
            got = mmse_interp(h, w, use_gauss=gauss)
            plain = mmse_interp_ref(h, w, use_gauss=gauss)
            again = mmse_interp(h, w, use_gauss=gauss)
            e = float((got - plain).abs().max())
            e64, p64 = (float((x - exact).abs().max()) for x in (got, plain))
            form = "Gauss" if gauss else "4-multiply"
            if not (e <= MMSE_TOL and e64 <= MMSE_FORM_RATIO * p64):
                raise AssertionError(f"mmse_interp {form} at {b} rows: |err| {e} vs plain "
                                     f"(limit {MMSE_TOL}), {e64} vs complex128 (plain {p64})")
            if not torch.equal(got, again):
                raise AssertionError(f"mmse_interp {form} differs between two calls at {b} rows")
            if gauss:
                err = max(err, e)
            notes.append(f"{form} |err| vs plain {e:.3g}, vs complex128 {e64:.3g} (plain "
                         f"{p64:.3g}, {e64 / p64:.2f}x)")
        times, reading = turns_of(gauss=lambda h=h: mmse_interp(h, w),
                                  four=lambda h=h: mmse_interp(h, w, use_gauss=False),
                                  matmul=lambda h=h: torch.matmul(h, w))
        n_bytes = 8.0 * (b * np_ + np_ * nsc + b * nsc)
        bms, by = bound_ms(n_bytes, 18.0 * b * np_ * nsc, PEAK_TF32_FLOPS)
        four_ms, _ = bound_ms(n_bytes, 24.0 * b * np_ * nsc, PEAK_TF32_FLOPS)
        device_alone(f"mmse_interp (Gauss) at {b} rows", lambda h=h: mmse_interp(h, w),
                     "mmse_interp_gauss", 50)
        log(f"  mmse_interp at {b} rows ({n_ues} UEs): " + "; ".join(notes)
            + f"; {reading}; bound Gauss {bms * 1e3:.2f} us ({by}), 4-multiply "
            f"{four_ms * 1e3:.2f} us")
        if n_ues == N_UES:
            gauss_row = dict(
                name="mmse_interp_gauss", route="cuda",
                source="src/repro_torch/csrc/mmse_interp.cu",
                replaces="src/repro/kernels/mmse_interp/mmse_interp.py:54",
                launches=0, max_abs_err=0.0, ms=times["gauss"],
                plain_ms=time_ms(lambda h=h: mmse_interp_ref(h, w)),
                bound_ms=bms, bound_by=by, library_ms=times["matmul"],
                shape=f"H ({b}, {np_}) @ W ({np_}, {nsc}) complex64, the Gauss form (also "
                      f"checked at {per_ue} and {sweep_ues() * per_ue} rows)")
    gauss_row["max_abs_err"] = err

    # -- the 4-multiply form through the public entry, on the slot's LS estimates --------
    k1, k2 = jr.split(jr.PRNGKey(25, dev))
    shape = (N_UES, cfg.n_ant, cfg.n_sc, cfg.n_sym)
    rx = torch.complex(jr.normal(k1, shape), jr.normal(k2, shape))
    pilots, interp = dmrs_sequence(cfg, device=dev), WienerInterpolator.build(cfg, device=dev)
    h_ls = ls_estimate(cfg, rx, pilots)
    mmse_interp(h_ls, interp.w, use_gauss=False)  # first call outside the count
    torch.cuda.synchronize()
    build.reset_launch_counts()
    got = mmse_interp(h_ls, interp.w, use_gauss=False)
    torch.cuda.synchronize()
    four_launches = dict(build.launch_counts)
    if four_launches["mmse_interp"] != 1 or sum(four_launches.values()) != 1:
        raise AssertionError(f"mmse_interp(use_gauss=False) launched {four_launches}")
    want = mmse_interp_ref(h_ls, interp.w, use_gauss=False)
    gauss = mmse_estimate(cfg, rx, pilots, interp).squeeze(-3).movedim(-1, -2)
    e, eg = (float((x - y).abs().max()) for x, y in ((got, want), (gauss, got)))
    if not (e <= MMSE_TOL and eg <= MMSE_TOL):
        raise AssertionError(f"mmse_interp(use_gauss=False) on the LS estimates: |err| {e} "
                             f"vs its plain version, {eg} vs mmse_estimate's Gauss form")

    # -- the switch kernels over a two-leaf pytree --------------------------------------
    est = (cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym)

    def tree(lead):
        return {"h": cplx(lead + est), "nv": torch.rand(lead, generator=gen, device=dev)}

    one = [tree(()), tree(())]
    for mode in (0, 1):
        want = switch_select_tree_ref(mode, one)
        des = {k: v.clone() for k, v in one[0].items()}  # the scalar switch works in place
        build.reset_launch_counts()
        got = switch_select(mode, [des, one[1]])
        torch.cuda.synchronize()
        if build.launch_counts["switch_select"] != 2:
            raise AssertionError(f"scalar switch over 2 leaves: {dict(build.launch_counts)}")
        _bitwise(got, want, f"scalar switch over a pytree, mode {mode}")
    outs = [tree((N_UES,)), tree((N_UES,))]
    modes = (torch.arange(N_UES, device=dev) % 3 == 0).to(torch.int32)
    build.reset_launch_counts()
    got = switch_select(modes, outs)
    torch.cuda.synchronize()
    if build.launch_counts["switch_select_batched"] != 2:
        raise AssertionError(f"per-UE switch over 2 leaves: {dict(build.launch_counts)}")
    _bitwise(got, switch_select_batched_tree_ref(modes, outs), "per-UE switch over a pytree")
    compact = tree((GATED_CAPACITY,))
    src = torch.where(torch.arange(N_UES, device=dev) % 2 == 0,
                      torch.arange(N_UES, device=dev) // 2, -1).to(torch.int32)
    build.reset_launch_counts()
    got = switch_scatter(src, compact, outs[0])
    torch.cuda.synchronize()
    if build.launch_counts["switch_gather_batched"] != 2:
        raise AssertionError(f"scatter over 2 leaves: {dict(build.launch_counts)}")
    _bitwise(got, switch_gather_batched_tree_ref(src, compact, outs[0]), "scatter over a pytree")
    log(f"surface: mmse_interp(use_gauss=False) on {N_UES} UEs' LS estimates: launches "
        f"{four_launches}, |err| {e:.3g} vs its plain version, {eg:.3g} vs mmse_estimate's "
        f"Gauss form; the scalar switch (one UE), the "
        f"per-UE switch and the scatter ({N_UES} UEs, capacity {GATED_CAPACITY}) over a "
        f"two-leaf pytree bitwise their plain versions, one launch a leaf a call; "
        f"{time.perf_counter() - t_start:.1f} s")
    return gauss_row, four_launches


def phase_runtime(sess, hist) -> None:
    """The closed-loop runtime's public surface on the main path's session.

    ``ArchesRuntime.from_spec(spec, agent=...)`` then ``run_batched(...,
    replay_telemetry=True)``: the history equals the same call without
    replay and the session's own run, bitwise, and so does a run with
    explicit ``ue_keys`` equal to ``fold_in(key, u)``; a dApp connected to
    the agent receives one indication a slot from each source and decides
    once a slot.  Then ``BatchedPuschPipeline.slot_step`` looped over
    ``SLOT_STEP_SLOTS`` slots of the main path's engine equals
    ``run(use_scan=False)`` bitwise, the counts zeroed just before the loop
    and read just after it: the slot's kernels launch once a slot each."""
    from repro_torch import random as jr
    from repro_torch.core.dapp import DApp, connect_dapp
    from repro_torch.core.e3 import E3Agent, E3Subscription
    from repro_torch.core.runtime import ArchesRuntime
    from repro_torch.kernels import build
    from repro_torch.phy import pipeline as P

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    spec = sess.spec
    agent = E3Agent()
    seen: collections.Counter = collections.Counter()
    agent.subscribe(E3Subscription(callback=lambda m: seen.update([m.source])))
    dapp = DApp(sess.host_policies[0], spec.feature_names,
                window_slots=spec.switch.window_slots)
    connect_dapp(agent, dapp)
    runtime = ArchesRuntime.from_spec(spec, engine=sess.engine,
                                      device_policy=sess.device_policy, agent=agent)
    key = jr.PRNGKey(spec.seed, dev)
    run = dict(n_slots=spec.n_slots, n_ues=spec.n_ues)
    t0 = time.perf_counter()
    replayed = runtime.run_batched(sess.schedule, key=key, replay_telemetry=True, **run)
    replay_s = time.perf_counter() - t0
    if dict(seen) != {"aerial": spec.n_slots, "oai": spec.n_slots}:
        raise AssertionError(f"replay delivered {dict(seen)}, not {spec.n_slots} a source")
    if len(dapp.decisions) != spec.n_slots:
        raise AssertionError(f"the dApp decided {len(dapp.decisions)} times in "
                             f"{spec.n_slots} slots")
    quiet = runtime.run_batched(sess.schedule, key=key, **run)
    keyed = runtime.run_batched(
        sess.schedule, ue_keys=jr.fold_in(key, torch.arange(spec.n_ues, device=dev)), **run)
    if sum(seen.values()) != 2 * spec.n_slots:
        raise AssertionError("a run without replay indicated to the agent")
    _same_history(replayed, quiet, "run_batched with replay vs without")
    _same_history(replayed, hist, "run_batched with replay vs the session's run")
    _same_history(keyed, quiet, "run_batched with ue_keys = fold_in(key, u) vs key")

    # -- slot_step, looped == run(use_scan=False) ---------------------------------------
    eng, n = sess.engine, SLOT_STEP_SLOTS
    grid = (np.arange(n * N_UES).reshape(n, N_UES) % 2).astype(np.int32)
    _, whole = eng.run(sess.schedule, grid, n_slots=n, n_ues=N_UES, key=key, use_scan=False)
    profile, params = P.resolve_schedule(eng.cfg, sess.schedule, n, N_UES, dev)
    modes = P.normalize_modes(grid, n, N_UES, dev)
    ue_keys = jr.fold_in(key, torch.arange(N_UES, device=dev))
    link = P.init_device_link(N_UES, dev)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    outs = []
    for s in range(n):
        link, out = eng.slot_step(profile, link, modes[s], jr.fold_in(ue_keys, s), params.at(s))
        outs.append(out)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    for k in ("mmse_interp_gauss", "switch_select_batched", "gated_expert"):
        if launches[k] != n:
            raise AssertionError(f"slot_step x {n}: {launches}")
    _bitwise(P._stack_tree(outs), whole, f"slot_step x {n} vs run(use_scan=False)")
    log(f"runtime: from_spec(agent=...) + run_batched(replay_telemetry=True), "
        f"{spec.n_slots} slots x {spec.n_ues} UEs in {replay_s:.2f} s: {dict(seen)} "
        f"indications, {len(dapp.decisions)} dApp decisions; == without replay, == the "
        f"session's run, == explicit ue_keys, bitwise; slot_step x {n} == "
        f"run(use_scan=False) bitwise, launches {launches}; "
        f"{time.perf_counter() - t_start:.1f} s")


def _fault_spec():
    from repro_torch.core.faults import FaultSpec

    # a NaN burst while the poor phase has the UEs on the AI expert, a telemetry
    # outage, a decision outage longer than the TTL, and random drops throughout
    return FaultSpec(seed=7, corruption_spans=((6, 14),), corruption_kind="nan",
                     telemetry_spans=((15, 18),), decision_outages=((20, 26),),
                     decision_drop_prob=0.05, telemetry_drop_prob=0.05, breaker_trips=2,
                     breaker_window=4, breaker_cooldown=6)


def _same_history(a, b, label: str) -> None:
    """Every leaf bitwise, or raise naming the first that differs."""
    pairs = [("modes", a.modes, b.modes), ("decisions", a.decisions, b.decisions),
             ("n_switches", a.n_switches, b.n_switches)]
    if set(a.kpms) != set(b.kpms) or set(a.outputs) != set(b.outputs):
        raise AssertionError(f"{label}: the histories carry different leaves")
    pairs += [(k, a.kpms[k], b.kpms[k]) for k in a.kpms]
    pairs += [(k, a.outputs[k], b.outputs[k]) for k in a.outputs]
    for name, x, y in pairs:
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            raise AssertionError(f"{label}: leaf {name} differs")


def phase_faults(host_policies) -> dict:
    """The main path's closed loops (CONCURRENT and fused GATED) under one
    ``FaultSpec``: the screen trips in the corruption span and only there, UEs
    enter quarantine, the decision phase is one ``tree_infer`` launch a slot,
    the device loop equals its host replay; and ``FaultSpec()`` equals
    ``faults=None`` bitwise on every leaf."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.session import ArchesSession

    fs = _fault_spec()
    launches = {}
    for label, bank, kernels in (
            ("CONCURRENT", {}, ("mmse_interp_gauss", "switch_select_batched", "tree_infer",
                                "gated_expert")),
            ("GATED fused", dict(execution_mode="gated", fused=True,
                                 gated_capacity=GATED_CAPACITY),
             ("gated_expert", "mmse_interp_gauss", "tree_infer"))):
        base = _main_spec(**bank)
        spec = dataclasses.replace(base, n_slots=FAULT_SLOTS, faults=fs,
                                   scenario_args=(("poor_start", 2), ("poor_end", 18)),
                                   switch=dataclasses.replace(base.switch, ttl_slots=FAULT_TTL))
        sess, hist, counts = run_path(f"faults {label}", spec, kernels,
                                      host_policies=host_policies, rerun=False)
        if counts["tree_infer"] != FAULT_SLOTS:
            raise AssertionError(f"faults {label}: {counts['tree_infer']} policy-step "
                                 f"launches in {FAULT_SLOTS} slots")
        ht = hist.outputs["health_tripped"]
        span = np.zeros(FAULT_SLOTS, bool)
        span[6:14] = True
        if not (ht[span].sum() > 0 and ht[~span].sum() == 0):
            raise AssertionError(f"faults {label}: health trips {ht.sum(axis=1)} outside or "
                                 f"missing in the corruption span")
        if hist.quarantined_slot_ues == 0:
            raise AssertionError(f"faults {label}: the breaker quarantined no UE")
        # the outage (slots 20-25) outlives the TTL: every UE decays to MMSE
        if not (hist.modes[24:27] == 1).all():
            raise AssertionError(f"faults {label}: the TTL did not decay the outage to MMSE")
        pre_sess = ArchesSession(dataclasses.replace(spec, faults=None), device="cuda",
                                 host_policies=host_policies)
        pre = pre_sess.run()
        zero = ArchesSession(dataclasses.replace(spec, faults=FaultSpec()), device="cuda",
                             host_policies=host_policies).run()
        _same_history(zero, pre, f"faults {label}: FaultSpec() vs faults=None")
        loop_ms = {}
        for name, s_ in (("faulted", sess), ("fault-free", pre_sess), ("faulted again", sess)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_.run()
            torch.cuda.synchronize()
            loop_ms[name] = (time.perf_counter() - t0) / FAULT_SLOTS * 1e3
        log(f"faults {label}: health-tripped slot-UEs {hist.health_tripped_slot_ues} (all in "
            f"slots 6-13), quarantined slot-UEs {hist.quarantined_slot_ues}, AI share "
            f"{hist.ai_share:.4f} (fault-free {pre.ai_share:.4f}), every UE on MMSE in slots "
            f"24-26 (the outage past the TTL of {FAULT_TTL}); FaultSpec() == faults=None on "
            f"every leaf; ms per slot " + ", ".join(f"{k} {v:.2f}" for k, v in loop_ms.items()))
        launches[label] = counts
    return launches


def _churn_schedule():
    """48 stable ids over a 32-slot bank: 28 attached at slot 0, then at each
    segment boundary a few detach and others attach (re-attaches included)."""
    from repro_torch.core.streaming import ChurnSchedule

    rng = np.random.default_rng(18)
    resident = set(range(28))
    events = []
    for t in range(STREAM_SEG, STREAM_SLOTS, STREAM_SEG):
        for u in rng.choice(sorted(resident), 4, replace=False):
            events.append((t, int(u), "detach"))
            resident.discard(int(u))
        free = sorted(set(range(STREAM_IDS)) - resident - {u for _, u, k in events[-4:]})
        for u in rng.choice(free, min(6, N_UES - len(resident)), replace=False):
            events.append((t, int(u), "attach"))
            resident.add(int(u))
    return ChurnSchedule(n_ue_ids=STREAM_IDS, segment_slots=STREAM_SEG,
                         initial=tuple(range(28)), events=tuple(events))


def _stream_spec(**bank):
    from repro_torch.core.session import CampaignSpec, ExpertBankSpec, PolicySpec

    return CampaignSpec(
        path="closed_loop", scenario="churn_cell", n_prb=N_PRB, n_ues=N_UES,
        n_slots=STREAM_SLOTS, seed=7, churn=_churn_schedule(),
        bank=ExpertBankSpec(channels=CHANNELS, n_res_blocks=N_RES, **bank),
        policies=(PolicySpec(kind="tree"),))


def _repack_agreement(churn_hist, mono_hist) -> dict:
    """Over the ids resident in every slot whose bank slot moved at least once:
    the share of slot-UEs whose mode, MCS and TB outcome equal the monolithic
    run's (every id in its own slot of a 48-wide batch), and the share whose
    SNR and RSRP are the same bits."""
    att = churn_hist.attached
    always = att.all(axis=0)
    moved = always & (churn_hist.bank_slot.max(axis=0) != churn_hist.bank_slot.min(axis=0))
    cols = np.nonzero(moved)[0]
    out = {"ids": int(len(cols))}
    for name, a, b in (("mode", churn_hist.modes, mono_hist.modes),
                       ("mcs", churn_hist.outputs["mcs"], mono_hist.outputs["mcs"]),
                       ("tb_ok", churn_hist.outputs["tb_ok"], mono_hist.outputs["tb_ok"]),
                       ("snr_bits", churn_hist.kpms["snr"], mono_hist.kpms["snr"]),
                       ("rsrp_bits", churn_hist.kpms["rsrp"], mono_hist.kpms["rsrp"])):
        out[name] = float(np.mean(a[:, cols] == b[:, cols])) if len(cols) else float("nan")
    return out


def phase_streaming(host_policies) -> None:
    """A closed-loop ``churn_cell`` campaign at the main path's width (32 bank
    slots, 48 stable ids, segments of 8, 32 slots): pipelined == serial, a run
    killed after two segments and resumed from its delta chain == the
    uninterrupted one, the device loop == its host replay, one ``tree_infer``
    launch a slot; zero churn == the monolithic run; one fused GATED churn run;
    the executor's stats and ms per slot beside the monolithic run's; and the
    re-pack agreement of resident UEs against a churn-free 48-UE run on both
    banks, which must be 1.0 (both run the AI expert through the fused kernel,
    one UE bitwise at any row and batch)."""
    import tempfile

    from repro_torch.core.session import ArchesSession, as_streaming_spec
    from repro_torch.kernels import build

    spec = _stream_spec()
    sess = ArchesSession(spec, device="cuda", host_policies=host_policies)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    serial_stats, piped_stats = {}, {}
    t0 = time.perf_counter()
    serial = sess.run_streaming(pipeline=False, stats=serial_stats)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    if counts["tree_infer"] != STREAM_SLOTS:
        raise AssertionError(f"streaming: {counts['tree_infer']} policy-step launches in "
                             f"{STREAM_SLOTS} slots")
    t0 = time.perf_counter()
    piped = sess.run_streaming(stats=piped_stats)
    torch.cuda.synchronize()
    piped_s = time.perf_counter() - t0
    _same_history(piped, serial, "streaming: pipelined vs serial")
    for name in ("attached", "bank_slot"):
        if not np.array_equal(getattr(piped, name), getattr(serial, name)):
            raise AssertionError(f"streaming: {name} differs, pipelined vs serial")
    with tempfile.TemporaryDirectory() as d:
        ck_stats = {}
        sess.run_streaming(checkpoint_dir=d, max_segments=2, stats=ck_stats)
        resumed = sess.run_streaming(resume_from=d)
    _same_history(resumed, serial, "streaming: resumed vs uninterrupted")
    replay = sess.host_replay(serial)
    if not np.array_equal(serial.modes, replay["active_mode"]):
        raise AssertionError("streaming: device loop != host replay")
    if not np.array_equal(serial.decisions, replay["raw_decision"]):
        raise AssertionError("streaming: device decisions != host replay")
    mono_spec = dataclasses.replace(spec, churn=None)
    t0 = time.perf_counter()
    mono = ArchesSession(mono_spec, device="cuda", host_policies=host_policies).run()
    torch.cuda.synchronize()
    mono_s = time.perf_counter() - t0
    zero = ArchesSession(as_streaming_spec(mono_spec, max_segment_slots=STREAM_SEG),
                         device="cuda", host_policies=host_policies).run()
    zero.attached = zero.bank_slot = None
    _same_history(zero, mono, "streaming: zero churn vs monolithic")
    res = serial.resident_ues_per_slot()
    log(f"streaming CONCURRENT: {STREAM_IDS} ids over {N_UES} bank slots, "
        f"{STREAM_SLOTS} slots in segments of {STREAM_SEG}, resident {res.min()}-{res.max()} "
        f"a slot; pipelined == serial, killed after 2 segments and resumed from the delta "
        f"chain == uninterrupted, device loop == host replay, zero churn == monolithic, all "
        f"bitwise; one tree_infer launch a slot")
    per_slot = {k: v / STREAM_SLOTS * 1e3 for k, v in (
        ("serial", serial_s), ("pipelined", piped_s), ("monolithic", mono_s))}
    log("streaming ms per slot: " + ", ".join(f"{k} {v:.2f}" for k, v in per_slot.items()))
    for label, st in (("serial", serial_stats), ("pipelined", piped_stats),
                      ("checkpointed, 2 segments", ck_stats)):
        log(f"streaming stats {label}: " + ", ".join(
            f"{k} {st[k]:.4f}" for k in ("dispatch_s", "wait_s", "assembly_s", "checkpoint_s"))
            + f", segments {st['segments']}, checkpoint bytes a segment "
              f"{st['checkpoint_bytes']}")
    wide = ArchesSession(dataclasses.replace(mono_spec, n_ues=STREAM_IDS), device="cuda",
                         host_policies=host_policies).run()
    agree = {"CONCURRENT": _repack_agreement(serial, wide)}
    gspec = _stream_spec(execution_mode="gated", fused=True)
    gsess = ArchesSession(gspec, device="cuda", host_policies=host_policies)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    ghist = gsess.run()
    torch.cuda.synchronize()
    gcounts = dict(build.launch_counts)
    if gcounts["gated_expert"] == 0 or gcounts["tree_infer"] != STREAM_SLOTS:
        raise AssertionError(f"streaming GATED fused launches {gcounts}")
    if not np.array_equal(ghist.modes, gsess.host_replay(ghist)["active_mode"]):
        raise AssertionError("streaming GATED fused: device loop != host replay")
    gwide = ArchesSession(dataclasses.replace(gspec, churn=None, n_ues=STREAM_IDS),
                          device="cuda", host_policies=host_policies).run()
    agree["GATED fused"] = _repack_agreement(ghist, gwide)
    log(f"streaming GATED fused: launches {gcounts}, device loop == host replay")
    for label, a in agree.items():
        log(f"re-pack agreement {label}: over {a['ids']} ids resident every slot whose bank "
            f"slot moved, against a churn-free {STREAM_IDS}-UE run: mode {a['mode']:.4f}, "
            f"mcs {a['mcs']:.4f}, tb_ok {a['tb_ok']:.4f}, snr bitwise {a['snr_bits']:.4f}, "
            f"rsrp bitwise {a['rsrp_bits']:.4f}")
        # every stage computes each UE on its own: a resident UE keeps its bits
        if a["ids"] == 0 or min(v for k, v in a.items() if k != "ids") < 1.0:
            raise AssertionError(f"re-pack agreement {label}: {a}")


def _topo_spec(**bank):
    from repro_torch.core.session import CampaignSpec, ExpertBankSpec, PolicySpec
    from repro_torch.core.topology import TopologySpec

    n_cells = len(TOPO_CELLS)
    return CampaignSpec(
        path="closed_loop", scenario="multi_cell",
        scenario_args=(("n_cells", n_cells), ("per_cell_scenario", TOPO_CELLS)),
        n_prb=N_PRB, n_ues=N_UES, n_slots=TOPO_SLOTS, seed=7,
        topology=TopologySpec(n_cells=n_cells, coupling=TOPO_COUPLING,
                              cell_noise_offsets_db=TOPO_NOISE_DB),
        bank=ExpertBankSpec(channels=CHANNELS, n_res_blocks=N_RES, **bank),
        policies=(PolicySpec(kind="tree"),))


def _topo_rank(rank, specs, host_policies):
    """One rank of the shared-card run: each spec's session run once, timed,
    with its launches and collectives."""
    torch.use_deterministic_algorithms(True)
    from repro_torch.core import topology
    from repro_torch.core.session import ArchesSession
    from repro_torch.kernels import build

    out = {}
    for label, spec in specs:
        sess = ArchesSession(spec, device="cuda", host_policies=host_policies)
        sess.run()  # warm: first launches, cached constants
        torch.cuda.synchronize()
        build.reset_launch_counts()
        topology.reset_collective_counts()
        t0 = time.perf_counter()
        hist = sess.run()
        torch.cuda.synchronize()
        out[label] = {"hist": hist, "s": time.perf_counter() - t0,
                      "n_shards": sess.cell_topology.n_shards,
                      "launches": dict(build.launch_counts),
                      "collectives": dict(topology.collective_counts)}
    return out


def phase_topology(host_policies, main_ms: float) -> None:
    """The multi-cell closed loop at the main path's width: 32 UEs in four
    coupled cells (one scenario and noise offset a cell), CONCURRENT and fused
    GATED (capacity 16) on one rank, with ms per slot beside the single-cell
    main path's; then CONCURRENT and fused GATED at full capacity on one rank
    and on ``TOPO_RANKS`` ranks sharing the card (gloo), bitwise on every
    trajectory leaf, with one ``all_reduce`` a slot on each rank."""
    from repro_torch.core import topology
    from repro_torch.core.session import ArchesSession
    from repro_torch.kernels import build

    full = {"CONCURRENT": _topo_spec(),
            "GATED fused": _topo_spec(execution_mode="gated", fused=True, gated_capacity=N_UES)}
    runs = (("CONCURRENT", full["CONCURRENT"],
             ("gated_expert", "mmse_interp_gauss", "switch_select_batched", "tree_infer")),
            ("GATED fused, capacity 16", _topo_spec(
                execution_mode="gated", fused=True, gated_capacity=GATED_CAPACITY),
             ("gated_expert", "mmse_interp_gauss", "tree_infer")),
            ("GATED fused", full["GATED fused"],
             ("gated_expert", "mmse_interp_gauss", "tree_infer")))
    one = {}
    for label, spec, kernels in runs:
        sess = ArchesSession(spec, device="cuda", host_policies=host_policies)
        sess.run()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        topology.reset_collective_counts()
        t0 = time.perf_counter()
        hist = sess.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        missing = [k for k in kernels if counts[k] == 0]
        if missing or counts["tree_infer"] != TOPO_SLOTS:
            raise AssertionError(f"topology {label}: launches {counts}")
        if topology.collective_counts["all_reduce"] != 0:
            raise AssertionError(f"topology {label}: a collective on one shard")
        _check_history(sess, hist, TOPO_SLOTS)
        one[label] = {"hist": hist, "s": dt}
        log(f"topology {label}, 1 rank: {len(TOPO_CELLS)} cells {TOPO_CELLS}, coupling "
            f"{TOPO_COUPLING}, noise offsets {TOPO_NOISE_DB} dB, {TOPO_SLOTS} slots x {N_UES} "
            f"UEs: {dt / TOPO_SLOTS * 1e3:.2f} ms/slot (single-cell main path {main_ms:.2f}); "
            f"AI share {hist.ai_share:.4f}, per cell {np.round(hist.per_cell_ai_share, 4)}; "
            f"throughput per cell {np.round(hist.per_cell_throughput / 1e6, 3)} Mbit/s; "
            f"overflow slot-UEs {hist.overflow_slot_ues}; launches {counts}; "
            f"device loop == host replay")
    from repro_torch.core.topology import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(_topo_rank, TOPO_RANKS, (tuple(full.items()), host_policies),
                        device="cuda", backend="gloo")
    spawn_s = time.perf_counter() - t0
    for label in full:
        for r, out in enumerate(ranks):
            got = out[label]
            if got["n_shards"] != TOPO_RANKS:
                raise AssertionError(f"topology {label}: rank {r} ran {got['n_shards']} shards")
            if got["collectives"] != {"all_reduce": TOPO_SLOTS, "all_gather": 1}:
                raise AssertionError(f"topology {label}: rank {r} collectives "
                                     f"{got['collectives']}")
            _same_history(got["hist"], one[label]["hist"],
                          f"topology {label}: rank {r} of {TOPO_RANKS} vs 1 rank")
        ms = max(out[label]["s"] for out in ranks) / TOPO_SLOTS * 1e3
        log(f"topology {label}: {TOPO_RANKS} ranks sharing the card (gloo) == 1 rank on "
            f"every trajectory leaf, bitwise, on every rank; all_reduce "
            f"{ranks[0][label]['collectives']['all_reduce'] / TOPO_SLOTS:g} a slot a rank, "
            f"one all_gather; {ms:.2f} ms/slot on {TOPO_RANKS} ranks (slowest rank) vs "
            f"{one[label]['s'] / TOPO_SLOTS * 1e3:.2f} on 1; launches a rank "
            f"{[out[label]['launches'] for out in ranks]}")
    log(f"topology: {TOPO_RANKS} ranks spawned, run and joined in {spawn_s:.1f} s")


#: the service's campaigns: a threshold policy (no tree to fit per campaign)
SERVICE_POLICY = dict(kind="threshold", feature="snr", threshold=10.0, hysteresis=1.0)


def phase_service() -> None:
    """``CampaignService`` on the card: a multi-cell campaign (the topology
    phase's, with a threshold policy) and a single-cell churn campaign (the
    streaming phase's) each equal to a direct ``run_streaming`` of their
    streaming form, bitwise; a campaign cancelled at its first boundary keeps
    its checkpoint, and a resume from it equals the uninterrupted run
    bitwise; the HTTP API on 127.0.0.1 answers a status query."""
    import tempfile
    import urllib.request

    from repro_torch.core.session import ArchesSession, PolicySpec, as_streaming_spec
    from repro_torch.service import CampaignService, CampaignState, ServiceAPI

    policy = (PolicySpec(**SERVICE_POLICY),)
    specs = {"multi-cell": dataclasses.replace(_topo_spec(), policies=policy),
             "single-cell churn": dataclasses.replace(_stream_spec(), policies=policy)}
    direct = {}
    for label, spec in specs.items():
        run_spec = as_streaming_spec(spec, max_segment_slots=STREAM_SEG)
        direct[label] = ArchesSession(run_spec, device="cuda").run_streaming()
    with tempfile.TemporaryDirectory() as d:
        svc = CampaignService(d, max_segment_slots=STREAM_SEG, device="cuda").start()
        api = ServiceAPI(svc, host="127.0.0.1").start()
        try:
            t0 = time.perf_counter()
            ids = {label: svc.submit(spec) for label, spec in specs.items()}
            for label, cid in ids.items():
                if svc.wait(cid, timeout=300) != CampaignState.COMPLETED:
                    raise AssertionError(f"service {label}: {svc.status(cid)}")
                _same_history(svc.result(cid), direct[label],
                              f"service {label} vs run_streaming")
            service_s = time.perf_counter() - t0
            with urllib.request.urlopen(f"{api.url}/campaigns/{ids['multi-cell']}",
                                        timeout=10) as r:
                status = json.loads(r.read().decode())
            if status["state"] != "completed" or r.status != 200:
                raise AssertionError(f"service API status: {r.status} {status}")
            samples = svc.ring.snapshot()
        finally:
            api.stop()
            svc.drain(timeout=60)

        def cancel_first(service, rec, ev):
            if ev.seg_idx == 0:
                rec.cancel_event.set()

        svc = CampaignService(os.path.join(d, "cancel"), max_segment_slots=STREAM_SEG,
                              device="cuda", segment_callback=cancel_first).start()
        cid = svc.submit(specs["multi-cell"])
        state = svc.wait(cid, timeout=300)
        steps = svc.status(cid)["checkpoint_steps"]
        svc.drain(timeout=60)
        if state != CampaignState.CANCELLED or steps != [1]:
            raise AssertionError(f"service cancel: {state}, checkpoints {steps}")
        run_spec = as_streaming_spec(specs["multi-cell"], max_segment_slots=STREAM_SEG)
        resumed = ArchesSession(run_spec, device="cuda").run_streaming(
            resume_from=svc.ckpt_dir(cid))
        _same_history(resumed, direct["multi-cell"], "service: resumed from a cancel")
    per_cell = [s.get("per_cell_throughput_bps") for s in samples
                if s["campaign_id"] == ids["multi-cell"]]
    log(f"service: {len(specs)} campaigns on the card ({', '.join(specs)}) == direct "
        f"run_streaming on every leaf, in {service_s:.2f} s; cancelled at the first boundary "
        f"with checkpoint {steps} kept, resumed == uninterrupted, bitwise; API status "
        f"{status['state']} ({status['segments_done']}/{status['n_segments']} segments); "
        f"{len(samples)} telemetry samples, multi-cell per-cell throughput (Mbit/s) "
        f"{[np.round(np.asarray(p) / 1e6, 3).tolist() for p in per_cell]}")


def phase_lm_switch_kernels() -> list[dict]:
    """The two switch kernels on the LM decoder's logits at full width:
    ``(SERVE_BATCH, 49,152)`` bf16, two experts.  The per-UE switch bitwise
    against its plain version with its inputs untouched, the scalar switch
    bitwise in place on modes 0 and 1; each timed in turns against its
    yardstick (``torch.where`` out of place, ``copy_``)."""
    from repro_torch.kernels.switch_select import (
        switch_select,
        switch_select_batched_ref,
        switch_select_ref,
    )
    from repro_torch.models import get_config

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2020)
    shape = (SERVE_BATCH, get_config(SERVE_ARCH).vocab)
    des0, alt = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
    kept = (des0.clone(), alt.clone())
    modes = (torch.arange(SERVE_BATCH, device=dev) % 2).to(torch.int32)
    got = switch_select(modes, [des0, alt])
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16),
                       switch_select_batched_ref(modes, [des0, alt]).view(torch.int16)):
        raise AssertionError("bf16 per-UE switch differs from its plain version")
    if not (torch.equal(des0, kept[0]) and torch.equal(alt, kept[1])):
        raise AssertionError("bf16 per-UE switch wrote into an expert output")
    for mode in (0, 1):
        des = des0.clone()
        out = switch_select(mode, [des, alt])
        torch.cuda.synchronize()
        want = switch_select_ref(mode, [des0, alt])
        if out.data_ptr() != des.data_ptr() or not torch.equal(out.view(torch.int16),
                                                                want.view(torch.int16)):
            raise AssertionError(f"bf16 scalar switch differs from its plain version, "
                                 f"mode {mode}")
    n_bytes = des0.numel() * des0.element_size()
    mask = (modes != 0).reshape(-1, 1)
    ms_b, lib_b, reading_b = turns(lambda: switch_select(modes, [des0, alt]),
                                   lambda: torch.where(mask, alt, des0), iters=200)
    plain_b = time_ms(lambda: switch_select_batched_ref(modes, [des0, alt]), iters=200)
    des = des0.clone()
    ms_s, lib_s, reading_s = turns(lambda: switch_select(1, [des, alt]),
                                   lambda: des.copy_(alt), iters=200)
    plain_s = time_ms(lambda: switch_select_ref(1, [des0, alt]), iters=200)
    device_alone("switch_select_batched, bf16 logits",
                 lambda: switch_select(modes, [des0, alt]), "copy_rows_kernel")
    device_alone("torch.where, bf16 logits", lambda: torch.where(mask, alt, des0), None)
    device_alone("scalar switch, bf16 logits, copy", lambda: switch_select(1, [des, alt]),
                 "switch_select_scalar")
    device_alone("copy_ of the bf16 logits", lambda: des.copy_(alt), None)
    # every row of the fresh output read once and written once, plus the modes;
    # the scalar copy reads and writes the buffer once
    bms_b, by_b = bound_ms(2.0 * n_bytes + 4 * SERVE_BATCH, 0.0)
    bms_s, by_s = bound_ms(2.0 * n_bytes, 0.0)
    log(f"kernel switch_select_batched at {shape} bf16 (the LM logits): bitwise, inputs "
        f"untouched; call {reading_b} (torch.where); plain {plain_b * 1e3:.2f} us; bound "
        f"{bms_b * 1e3:.3f} us by {by_b}")
    log(f"kernel switch_select (scalar) at {shape} bf16: bitwise on modes 0 and 1, in "
        f"place; copy {reading_s} (copy_); plain {plain_s * 1e3:.2f} us; bound "
        f"{bms_s * 1e3:.3f} us by {by_s}")
    common = dict(route="cuda", source="src/repro_torch/csrc/switch_select.cu",
                  launches=0, max_abs_err=0.0)
    return [
        dict(name="switch_select_batched_bf16", counter="switch_select_batched",
             replaces="src/repro/kernels/switch_select/switch_select.py:156",
             ms=ms_b, plain_ms=plain_b, bound_ms=bms_b, bound_by=by_b, library_ms=lib_b,
             shape=f"{shape} bf16 logits x 2 experts, out of place", **common),
        dict(name="switch_select_bf16", counter="switch_select",
             replaces="src/repro/kernels/switch_select/switch_select.py:62",
             ms=ms_s, plain_ms=plain_s, bound_ms=bms_s, bound_by=by_s, library_ms=lib_s,
             shape=f"{shape} bf16 logits, copy path", **common),
    ]


def train_sampler(cfg, dev):
    """The training mixture of conditions on the port's PHY, for one device:
    SNR uniform in 5-14 dB, in-band interference on half the draws (INR
    12-26 dB) with the POOR scenario's pilot contamination; returns
    ``sample(key) -> (LS at the pilots, the true channel at the DMRS
    symbols)``.  The same mixture as the reference benchmark's sampler
    (``benchmarks/common.py``), rebuilt here on ``repro_torch``."""
    from repro_torch import random as jr
    from repro_torch.phy import dmrs as D
    from repro_torch.phy.channel import ChannelConfig, apply_channel, simulate_slot_channel
    from repro_torch.phy.estimators import ls_estimate

    pilots = D.dmrs_sequence(cfg, device=dev)
    data = torch.zeros((1, cfg.n_data_re()), dtype=torch.complex64, device=dev)
    grid = D.map_slot_grid(cfg, data, pilots)
    dmrs_idx = torch.as_tensor(cfg.dmrs_symbols, device=dev)
    # unit-amplitude template (snr 0 dB, inr 0 dB), rescaled per draw
    ch = ChannelConfig(snr_db=0.0, interference=True, inr_db=0.0,
                       interference_symbol_duty=3.0 / 14.0, dmrs_collision=True)

    def sample(key):
        k1, k2, k3 = jr.split(key, 3)
        snr = jr.uniform(k3, (), 5.0, 14.0)
        interf = jr.bernoulli(jr.fold_in(k3, 1), 0.5, ())
        inr = jr.uniform(jr.fold_in(k3, 2), (), 12.0, 26.0)
        fields = dict(simulate_slot_channel(k1, cfg, ch))
        noise_var = torch.pow(10.0, -snr / 10.0)
        amp = torch.where(interf, torch.sqrt(noise_var * torch.pow(10.0, inr / 10.0)), 0.0)
        fields["noise_var"] = noise_var
        fields["interference"] = fields["interference"] * amp
        rx = apply_channel(k2[None], grid, {k: v[None] for k, v in fields.items()})[0]
        return ls_estimate(cfg, rx, pilots), fields["h"].index_select(3, dmrs_idx)

    return sample


#: what the training phase leaves for its profile pass after the timed phases
TRAINED: dict = {}


def phase_train() -> None:
    """``train_ai_estimator`` on the card at n_prb 106, 32 channels x 4 blocks,
    ``TRAIN_STEPS`` steps of the mixture sampler: the loss must fall (the last
    20 steps' mean below the first 20's); the first ``TRAIN_CPU_STEPS`` steps
    against the same steps on the CPU (losses within ``TRAIN_LOSS_RTOL``, the
    weights within ``TRAIN_WEIGHT_ATOL``) and against themselves on the card
    under deterministic algorithms (bitwise); one gradient on the same
    weights and sample against the CPU's (``TRAIN_GRAD_RTOL`` of each leaf's
    largest component);
    the trained weights through the fused ``gated_expert`` kernel
    (``ai_expert_dense``) against their plain folded form.  The training path
    reaches no hand-written kernel (the reference's training reaches no Pallas
    kernel): the launch counts over the run must stay 0."""
    from repro_torch import random as jr
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.gated_expert import ai_expert_dense
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    from repro_torch.phy import ai_estimator as tai
    from repro_torch.phy.nr import SlotConfig

    dev = resolve_device("cuda")
    cpu = torch.device("cpu")
    cfg = SlotConfig(n_prb=N_PRB)
    net = tai.AiEstimatorConfig(channels=CHANNELS, n_res_blocks=N_RES)
    samplers = {"cpu": train_sampler(cfg, cpu), "cuda": train_sampler(cfg, dev)}
    short = {}
    for label, d in (("cpu", cpu), ("cuda", dev), ("cuda again", dev)):
        t0 = time.perf_counter()
        short[label] = tai.train_ai_estimator(
            jr.PRNGKey(0, d), cfg, samplers[label.split()[0]], net=net,
            steps=TRAIN_CPU_STEPS, lr=TRAIN_LR, device=d)
        log(f"train: {TRAIN_CPU_STEPS} steps on {label} in {time.perf_counter() - t0:.2f} s, "
            f"losses {short[label][1]}")
    (p_cpu, l_cpu), (p_gpu, l_gpu), (p_again, l_again) = (
        short[k] for k in ("cpu", "cuda", "cuda again"))
    if not np.allclose(l_gpu, l_cpu, rtol=TRAIN_LOSS_RTOL, atol=0.0):
        raise AssertionError(f"train: card losses {l_gpu} vs CPU {l_cpu}")
    w_gpu, w_cpu, w_again = (tree_leaves(p) for p in (p_gpu, p_cpu, p_again))
    if l_gpu != l_again or not all(torch.equal(a, b) for a, b in zip(w_gpu, w_again)):
        raise AssertionError("train: two card runs of the same steps differ under "
                             "deterministic algorithms")
    w_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(w_gpu, w_cpu))
    # one gradient, card and CPU, on the same weights and the same (CPU-drawn) sample
    p0 = tai.init_params(jr.split(jr.PRNGKey(0))[0], cfg, net)
    h_ls, h_true = samplers["cpu"](jr.PRNGKey(7))
    grads = {}
    for label, d in (("cpu", cpu), ("cuda", dev)):
        live = [w.to(d).requires_grad_(True) for w in tree_leaves(p0)]
        tree = tree_unflatten(p0, live)
        with torch.enable_grad():
            loss = tai._loss(tree, h_ls.to(d), h_true.to(d))
            grads[label] = [g.cpu() for g in torch.autograd.grad(loss, live)]
    g_err = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads["cuda"], grads["cpu"]))
    log(f"train: one gradient on the same weights and sample, card vs CPU: max |diff| / "
        f"max |g| over the leaves {g_err:.3g} (limit {TRAIN_GRAD_RTOL}); weights after "
        f"{TRAIN_CPU_STEPS} steps max |diff| {w_err:.3g} (limit {TRAIN_WEIGHT_ATOL})")
    if not g_err <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"train: card gradient {g_err:.3g} from the CPU's")
    if not w_err <= TRAIN_WEIGHT_ATOL:
        raise AssertionError(f"train: card weights {w_err:.3g} from the CPU's after "
                             f"{TRAIN_CPU_STEPS} steps")
    log(f"train: the first {TRAIN_CPU_STEPS} steps, card vs CPU: losses within "
        f"{TRAIN_LOSS_RTOL} relative (max {max(abs(a - b) / b for a, b in zip(l_gpu, l_cpu)):.3g}), "
        f"weights max |diff| {w_err:.3g}; card vs card bitwise (deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()}, cudnn.deterministic "
        f"{torch.backends.cudnn.deterministic}, cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32})")

    sample = samplers["cuda"]
    keys = jr.split(jr.PRNGKey(5, dev), 20)
    sample_ms = time_ms(lambda: [sample(k) for k in keys], iters=1, warmup=1) / len(keys)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    params, losses = tai.train_ai_estimator(jr.PRNGKey(0, dev), cfg, sample, net=net,
                                            steps=TRAIN_STEPS, lr=TRAIN_LR)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    # the sampler's draws run the threefry kernel; no expert kernel may run
    if any(v for k, v in launches.items() if k != "threefry"):
        raise AssertionError(f"train: the training path launched a kernel: {launches}")
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"train: loss did not fall: first 20 {first}, last 20 {last}")
    # held-out samples: the trained weights against the initial ones
    held = [sample(k) for k in jr.split(jr.PRNGKey(99, dev), 8)]
    init = tai.init_params(jr.split(jr.PRNGKey(0, dev))[0], cfg, net)
    with torch.no_grad():
        held_loss = {n: float(np.mean([float(tai._loss(p, h, t)) for h, t in held]))
                     for n, p in (("init", init), ("trained", params))}
    if not held_loss["trained"] < held_loss["init"]:
        raise AssertionError(f"train: held-out loss did not fall: {held_loss}")
    # the trained weights go straight into a session's AI expert: the fused kernel
    ai = tai.AiEstimator(params, cfg.n_dmrs_sym)
    h_ls = torch.stack([h for h, _ in held])
    got = ai_expert_dense(h_ls, ai)
    want = ai_expert_dense(h_ls, ai, backend="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **GATED_F32_TOL)
    log(f"train: {TRAIN_STEPS} steps on the card at n_prb {N_PRB}, {CHANNELS} ch x {N_RES} "
        f"blocks, lr {TRAIN_LR}: {train_s:.2f} s = {train_s / TRAIN_STEPS * 1e3:.2f} ms a step "
        f"(the sampler alone {sample_ms:.2f} ms a sample); loss first-20 mean {first:.5f} -> "
        f"last-20 mean {last:.5f} (first {losses[0]:.5f}, last {losses[-1]:.5f}); held-out "
        f"loss init {held_loss['init']:.5f} -> trained {held_loss['trained']:.5f}; launches "
        f"{launches}; trained weights through gated_expert (ai_expert_dense, 8 UEs) vs the "
        f"plain folded form: max |err| {float((got - want).abs().max()):.3g}")
    TRAINED.update(params=params, sample=sample, cfg=cfg, net=net)


def phase_train_profile() -> None:
    """One training step on the card under ``torch.profiler`` (after every
    timed phase): the kernels the convolutions' forward and backward run
    under deterministic algorithms, by device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as jr
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.phy import ai_estimator as tai

    params, sample = TRAINED["params"], TRAINED["sample"]
    h_ls, h_true = sample(jr.PRNGKey(3, "cuda"))
    cfg = AdamWConfig(learning_rate=TRAIN_LR)
    state = adamw_init(params, cfg)
    tai._train_step(params, state, h_ls, h_true, TRAIN_LR, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tai._train_step(params, state, h_ls, h_true, TRAIN_LR, cfg)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"),
                    key=lambda e: e.self_device_time_total, reverse=True)
    log(f"train profile: one step, {sum(e.count for e in events)} kernel launches, "
        f"{sum(e.self_device_time_total for e in events):.1f} us of device time")
    for e in events:
        name = e.key.lower()
        if any(k in name for k in ("conv", "cudnn", "wgrad", "dgrad", "xmma", "implicit",
                                   "winograd", "fft", "gemm", "sm90")):
            log(f"  train kernel: {e.self_device_time_total:9.1f} us {e.count:4d} calls  "
                f"{e.key[:150]}")


#: what the serving phase leaves for its profile pass after the timed phases
SERVED: dict = {}


def phase_serve_profile() -> None:
    """One plain decode step and one CONCURRENT switched step of the
    full-width decoder under ``torch.profiler`` (after every timed phase):
    device time against the wall, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    model, dec, params, tok, cache = (SERVED[k] for k in
                                      ("model", "dec", "params", "tok", "cache"))
    for label, fn in (("decode_step", lambda: model.decode_step(params, tok, cache)),
                      ("switched step, mode 0", lambda: dec.step(0, params, tok, cache))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"),
                        key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in events)
        log(f"serve profile, {label}: {sum(e.count for e in events)} kernel launches, "
            f"{busy / 1e3:.3f} ms of device time in {wall * 1e3:.3f} ms wall (under the "
            f"profiler)")
        for e in events[:8]:
            log(f"  serve kernel: {e.self_device_time_total:9.1f} us {e.count:4d} calls  "
                f"{e.key[:120]}")


def _sum_counts(*counts: dict[str, int]) -> dict[str, int]:
    """Launch counts of several runs, added kernel by kernel."""
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return dict(out)


class recorded_routing:
    """Within the block, every ``moe_ffn`` call appends its expert assignment,
    its kept mask and its capacity to ``self.calls``: the FFN is wrapped in
    the module the blocks call it through, and the routing recomputed with
    the same operations (deterministic, so the same bits)."""

    def __init__(self):
        self.calls: list[tuple[torch.Tensor, torch.Tensor, int]] = []

    def __enter__(self):
        from repro_torch.models import moe

        self._orig = orig = moe.moe_ffn

        def rec(cfg, p, x, **kw):
            r = moe.route(cfg, p, x.reshape(-1, x.shape[-1]))
            dp = moe.dispatch(cfg, r, **kw)
            self.calls.append((r.topi, dp.keep, dp.cap))
            return orig(cfg, p, x, **kw)

        moe.moe_ffn = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_ffn = self._orig
        return False


def _draw_family(label: str, cfg):
    """``cfg``'s weights on the card from seed 0: the draw's time, its bytes
    and its peak device memory."""
    from repro_torch import random as jr
    from repro_torch.models import Model
    from repro_torch.optim.adamw import tree_leaves

    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(jr.PRNGKey(0, "cuda"))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"{label}: weight draw {draw_s:.2f} s, {w_bytes / 1e9:.3f} GB of {cfg.dtype} weights "
        f"({model.n_params() / 1e9:.3f} B params), peak device memory of the draw "
        f"{peak / 1e9:.3f} GB (threefry in chunks of 2**24 elements)")
    return model, params


def decode_bytes(model, params, cache) -> tuple[float, str]:
    """The bytes one decode step must move, and what they are: every weight
    the step reads once (the reference's dispatch reads every expert's weights
    whatever the batch; zamba2's shared block once at each call site; not
    whisper's encoder, nor its cross ``wk`` / ``wv``, whose products the
    cache holds), the embedding's batch rows only (unless the head is the tied
    embedding), the cached K/V up to the index and every cached cross K/V
    read, the SSM and conv states read and written once."""
    from repro_torch.optim.adamw import tree_leaves

    cfg = model.cfg
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    batch = next(v.shape[1] for k, v in cache.items() if k != "index")  # (L, B, ...)
    weights = sum(nbytes(t) for t in tree_leaves(params))
    emb = params["embed"]
    if not cfg.tie_embeddings:
        weights -= nbytes(emb) - batch * emb.shape[1] * emb.element_size()
    parts = []
    if "encoder" in params:
        cross = params["blocks"]["cross_attn"]
        unread = sum(nbytes(t) for t in tree_leaves(params["encoder"]))
        unread += nbytes(cross["wk"]) + nbytes(cross["wv"])
        weights -= unread
        parts.append(f"less the encoder and the cross wk/wv {unread / 1e9:.3f} GB")
    parts.insert(0, f"weights {weights / 1e9:.3f} GB")
    if "shared_attn" in params:
        sites = cfg.n_layers // cfg.attn_every
        extra = (sites - 1) * sum(nbytes(t) for t in tree_leaves(params["shared_attn"]))
        weights += extra
        parts.append(f"the shared block at {sites} sites +{extra / 1e9:.3f} GB")
    total = float(weights)
    if "k" in cache:
        k = cache["k"]
        pos = int(cache["index"]) + 1
        kv = 2 * k.shape[0] * k.shape[1] * pos * k.shape[3] * k.shape[4] * k.element_size()
        total += kv
        parts.append(f"K/V {kv / 1e9:.4f} GB")
    if "cross_k" in cache:
        ckv = nbytes(cache["cross_k"]) + nbytes(cache["cross_v"])
        total += ckv
        parts.append(f"cross K/V {ckv / 1e9:.3f} GB")
    if "ssm" in cache:
        st = 2 * (nbytes(cache["ssm"]) + nbytes(cache["conv"]))
        total += st
        parts.append(f"states read and written {st / 1e9:.3f} GB")
    return total, ", ".join(parts)


def _hold_switches(label: str, la: torch.Tensor, lb: torch.Tensor) -> None:
    """Both switch kernels on two experts' bf16 logits against their plain
    versions, bitwise: the per-UE switch on a mode vector with its inputs
    untouched, the scalar switch in place on modes 0 and 1.  These launches
    are comparisons and fall outside every counted run."""
    from repro_torch.kernels.switch_select import (
        switch_select,
        switch_select_batched_ref,
        switch_select_ref,
    )

    kept = (la.clone(), lb.clone())
    modes = (torch.arange(la.shape[0], device=la.device) % 2).to(torch.int32)
    got = switch_select(modes, [la, lb])
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16),
                       switch_select_batched_ref(modes, [la, lb]).view(torch.int16)):
        raise AssertionError(f"{label}: per-UE switch differs from its plain version")
    if not (torch.equal(la, kept[0]) and torch.equal(lb, kept[1])):
        raise AssertionError(f"{label}: per-UE switch wrote into an expert's logits")
    for mode in (0, 1):
        des = la.clone()
        out = switch_select(mode, [des, lb])
        torch.cuda.synchronize()
        want = switch_select_ref(mode, [la, lb])
        if out.data_ptr() != des.data_ptr() or not torch.equal(out.view(torch.int16),
                                                                want.view(torch.int16)):
            raise AssertionError(f"{label}: scalar switch differs from its plain version, "
                                 f"mode {mode}")
    log(f"{label}: both switch kernels on the {tuple(la.shape)} {la.dtype} logits bitwise "
        f"their plain versions (per-UE switch inputs untouched; scalar modes 0 and 1)")


class Served(typing.NamedTuple):
    launches: dict[str, int]
    dec: object
    tok: torch.Tensor
    cache: dict
    vec: torch.Tensor
    same: bool  # the two experts' logits the same bits


def stub_frames(cfg, batch: int, n_frames: int, device) -> torch.Tensor | None:
    """Seeded stub frame embeddings ``(batch, n_frames, d_model)`` in the param
    dtype for the encoder-decoder family (the reference's frontend is a
    stub); ``None`` for the other families."""
    from repro_torch import random as jr

    if cfg.family.value != "enc_dec":
        return None
    return jr.normal(jr.PRNGKey(5, device), (batch, n_frames, cfg.d_model)).to(
        cfg.param_dtype())


def _serve_family(label: str, model, params, *, switched_run: bool,
                  frames: torch.Tensor | None = None) -> Served:
    """The serving path at ``SERVE_BATCH`` x ``SERVE_PROMPT`` (max_seq
    ``SERVE_MAX_SEQ``, window ``SERVE_WINDOW``): with the launch counts
    zeroed just before and read just after, ``ServingEngine.generate`` for
    ``SERVE_STEPS`` steps, ``SwitchedDecoder.step`` at mode 0, mode 1 and a
    ``(SERVE_BATCH,)`` mode vector and, with ``switched_run``,
    ``generate_switched`` under a dApp: both switch kernels must launch on
    the bf16 logits, the selected rows must be the chosen expert's logits,
    bitwise, and the cache given to a switched step must stay as it was.
    Then both switch kernels are held against their plain versions on the
    two experts' logits.  ``frames``: the encoder-decoder family's, given to
    every prefill."""
    from repro_torch import random as jr
    from repro_torch.core.dapp import DApp
    from repro_torch.kernels import build
    from repro_torch.serving import ServingEngine, SwitchedDecodeConfig, SwitchedDecoder

    dev = torch.device("cuda")
    cfg = model.cfg
    prompts = jr.randint(jr.PRNGKey(1, dev), (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab)
    eng = ServingEngine(model, params, max_seq=SERVE_MAX_SEQ)
    dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=SERVE_WINDOW))
    dapp = DApp(lambda x: 0 if x[0] > 1e-4 else 1, ["expert_kl"], window_slots=1)
    eng.generate(prompts, 2, encoder_frames=frames)  # first calls outside the run
    _, cache = model.prefill(params, prompts, model.init_cache(
        SERVE_BATCH, SERVE_MAX_SEQ, dtype=torch.float32, device=dev), encoder_frames=frames)
    kept = {k: v.clone() for k, v in cache.items()}
    tok = prompts[:, -1:]
    vec = (torch.arange(SERVE_BATCH, device=dev) % 2).to(torch.int32)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(prompts, SERVE_STEPS, encoder_frames=frames)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    l0, _, k0 = dec.step(0, params, tok, cache)
    l1, _, _ = dec.step(1, params, tok, cache)
    lv, _, _ = dec.step(vec, params, tok, cache)
    tokens = [("generate", res.tokens)]
    if switched_run:
        t0 = time.perf_counter()
        switched = eng.generate_switched(prompts, SERVE_STEPS, decoder=dec, dapp=dapp,
                                         encoder_frames=frames)
        torch.cuda.synchronize()
        sw_s = time.perf_counter() - t0
        tokens.append(("generate_switched", switched.tokens))
    launches = dict(build.launch_counts)
    if launches["switch_select"] == 0 or launches["switch_select_batched"] == 0:
        raise AssertionError(f"{label}: a switch kernel never launched: {launches}")
    outs = [e.fn(None, params, tok, cache) for e in dec.bank.experts]
    torch.cuda.synchronize()
    if not all(torch.equal(cache[k], kept[k]) for k in kept):
        raise AssertionError(f"{label}: a switched step wrote the cache it was given")
    rows_ok = (torch.equal(l0, outs[0]) and torch.equal(l1, outs[1])
               and all(torch.equal(lv[b], outs[int(m)][b]) for b, m in enumerate(vec.tolist())))
    if not rows_ok:
        raise AssertionError(f"{label}: the selected logits are not the chosen expert's, "
                             f"bitwise")
    for name, x in tokens:
        if x.shape != (SERVE_BATCH, SERVE_STEPS) or not ((x >= 0) & (x < cfg.vocab)).all():
            raise AssertionError(f"{label}: {name} tokens {x.shape}")
    if l0.dtype is not torch.bfloat16 or not bool(torch.isfinite(lv.float()).all()):
        raise AssertionError(f"{label}: logits {l0.dtype}, finite {torch.isfinite(lv).all()}")
    same = torch.equal(outs[0], outs[1])
    log(f"{label}: generate {SERVE_BATCH} x {SERVE_STEPS} tokens (prompt {SERVE_PROMPT}, "
        f"max_seq {SERVE_MAX_SEQ}) in {gen_s:.3f} s = {SERVE_BATCH * SERVE_STEPS / gen_s:.1f} "
        f"tokens/s with the prefill; switched steps at modes 0, 1, {vec.tolist()}: the "
        f"selected rows are the chosen expert's bits, the given cache untouched; the two "
        f"experts' logits {'the same bits' if same else 'differ'} (window {SERVE_WINDOW}); "
        f"KPMs mode 0 {k0}"
        + (f"; generate_switched {SERVE_STEPS} steps in {sw_s:.3f} s, modes "
           f"{switched.history.modes.tolist()}" if switched_run else "")
        + f"; launches {launches}")
    _hold_switches(label, outs[0], outs[1])
    return Served(launches=launches, dec=dec, tok=tok, cache=cache, vec=vec, same=same)


def _decode_times(label: str, model, params, tok, cache, iters: int, **fns) -> None:
    """A decode step's (of ``tok`` on ``cache``) and ``fns``' call times, in
    turns, beside the decode step's byte bound, and decode tokens/s."""
    times, reading = turns_of(iters=iters,
                              decode_step=lambda: model.decode_step(params, tok, cache), **fns)
    n_bytes, what = decode_bytes(model, params, cache)
    bms, by = bound_ms(n_bytes, 0.0)
    ms = times["decode_step"]
    log(f"{label}: ms a call, in turns: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f" ({reading}); decode bound {bms:.3f} ms by {by} ({n_bytes / 1e9:.3f} GB: {what}), "
        f"the step at {bms / ms:.4f} of it; decode tokens/s at batch {SERVE_BATCH}: "
        f"{SERVE_BATCH / ms * 1e3:.1f}")


def _bf16_vs_f32(label: str, cfg) -> None:
    """bf16 weights against float32 ones (the same draw) on the card, on the
    prefill's last-position logits: relative L2 error within
    ``LM_BF16_REL`` and the argmax equal on rows whose top-2 margin exceeds
    twice the largest error.  In an MoE model a row whose last token routes
    to other experts in the two precisions (top-k near a tie) takes another
    FFN: the limits hold on the rows whose routing agrees, the others are
    counted."""
    from repro_torch import random as jr
    from repro_torch.models import Model
    from repro_torch.optim.adamw import tree_leaves

    dev = torch.device("cuda")
    model = Model(cfg)
    prompts = jr.randint(jr.PRNGKey(1, dev), (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab)
    p16 = model.init(jr.PRNGKey(0, dev))
    p32 = model.init(jr.PRNGKey(0, dev), dtype=torch.float32)
    if not all(torch.equal(a, b.to(torch.bfloat16)) for a, b in
               zip(tree_leaves(p16), tree_leaves(p32))):
        raise AssertionError(f"{label}: the bf16 draw is not the float32 draw rounded")
    logits, routes = [], []
    for p in (p16, p32):
        with recorded_routing() as rec:
            out = model.prefill(p, prompts, model.init_cache(
                SERVE_BATCH, SERVE_PROMPT, dtype=torch.float32, device=dev))[0].float()
        logits.append(out)
        routes.append([torch.sort(topi.reshape(SERVE_BATCH, SERVE_PROMPT, -1)[:, -1]).values
                       for topi, _, _ in rec.calls])
    del p16, p32
    torch.cuda.empty_cache()
    l16, l32 = logits
    same = torch.ones(SERVE_BATCH, dtype=torch.bool, device=dev)
    for a, b in zip(*routes):
        same &= (a == b).all(-1)
    rel = torch.linalg.vector_norm(l16 - l32, dim=-1) / torch.linalg.vector_norm(l32, dim=-1)
    err = (l16 - l32).abs().max(-1).values
    top2 = torch.topk(l32, 2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 2 * err) & same
    agree = l16.argmax(-1) == l32.argmax(-1)
    log(f"{label}: bf16 vs float32 weights at {cfg.n_layers} layers (prefill logits): "
        f"{int(same.sum())} of {SERVE_BATCH} rows route alike; their relative L2 errors "
        f"{[round(float(r), 5) for r in rel[same]]} (limit {LM_BF16_REL}), the others' "
        f"{[round(float(r), 5) for r in rel[~same]]}; argmax agreement "
        f"{float(agree.float().mean()):.3f} ({int(clear.sum())} rows with a top-2 margin over "
        f"2 x their max |err|, all agreeing)")
    if not (bool(same.any()) and bool((rel[same] <= LM_BF16_REL).all())
            and bool(agree[clear].all())):
        raise AssertionError(f"{label}: bf16 vs float32: relative {rel.tolist()}, routed "
                             f"alike {same.tolist()}, argmax {agree.tolist()}")


def phase_serve() -> dict[str, int]:
    """granite-20b at its published width (d_model 6,144, 48 heads, 1 KV head,
    head_dim 128, d_ff 24,576, vocab 49,152, bf16), ``SERVE_LAYERS`` layers:
    the weight draw (time, peak memory); the serving path (``_serve_family``
    with ``generate_switched``); the call times of a decode step and of the
    switched step by mode (CONCURRENT) and by expert (SELECTED_ONLY); then
    the bf16 weights against float32 ones on the card."""
    from repro_torch.core.expert_bank import ExecutionMode
    from repro_torch.device import resolve_device
    from repro_torch.models import get_config
    from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder

    resolve_device("cuda")
    full = get_config(SERVE_ARCH)
    cfg = full.with_(n_layers=SERVE_LAYERS)
    log(f"serve: {full.name} at its published width (d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} KV head, head_dim {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}); cut: n_layers {full.n_layers} -> "
        f"{SERVE_LAYERS} (the weight draw's time and the script's limit); "
        f"{full.n_params() / 1e9:.3f} B params in the full model")
    model, params = _draw_family("serve", cfg)
    served = _serve_family("serve", model, params, switched_run=True)
    dec, tok, cache, vec = served.dec, served.tok, served.cache, served.vec
    sel = SwitchedDecoder(model, SwitchedDecodeConfig(
        window=SERVE_WINDOW, execution_mode=ExecutionMode.SELECTED_ONLY))
    _decode_times(
        "serve", model, params, tok, cache, 10,
        concurrent_exact=lambda: dec.step(0, params, tok, cache),
        concurrent_windowed=lambda: dec.step(1, params, tok, cache),
        concurrent_vector=lambda: dec.step(vec, params, tok, cache),
        selected_exact=lambda: sel.step(0, params, tok, cache),
        selected_windowed=lambda: sel.step(1, params, tok, cache))
    _bf16_vs_f32("serve", cfg)
    SERVED.update(model=model, dec=dec, params=params, tok=tok, cache=cache)
    return served.launches


def _prefill_drops(label: str, model, params) -> None:
    """The share of routed token-slot pairs that the serving prefill's
    capacity drops (``SERVE_BATCH`` x ``SERVE_PROMPT`` tokens)."""
    from repro_torch import random as jr

    dev = torch.device("cuda")
    prompts = jr.randint(jr.PRNGKey(1, dev), (SERVE_BATCH, SERVE_PROMPT), 0, model.cfg.vocab)
    with recorded_routing() as rec:
        model.prefill(params, prompts, model.init_cache(
            SERVE_BATCH, SERVE_MAX_SEQ, dtype=torch.float32, device=dev))
    dropped = sum(int((~k).sum()) for _, k, _ in rec.calls)
    routed = sum(k.numel() for _, k, _ in rec.calls)
    log(f"{label}: the prefill's {prompts.numel()} tokens at capacity {rec.calls[0][2]} a "
        f"layer drop {dropped} of {routed} routed token-slots ({dropped / routed:.4f}) over "
        f"{len(rec.calls)} MoE layers")


def phase_serve_moe() -> dict[str, int]:
    """dbrx-132b at its published width (d_model 6,144, 48 heads, 8 KV heads,
    16 experts top-4, d_ff_expert 10,752, vocab 100,352, bf16), ``MOE_LAYERS``
    of its 40 layers: the serving path (``_serve_family`` with
    ``generate_switched``), a decode step and a switched step against the
    decode step's bound, the share of routed token-slots the prefill's
    capacity drops; then bf16 against float32 at ``MOE_F32_LAYERS`` layer."""
    from repro_torch.models import get_config

    torch.cuda.empty_cache()  # the training phase's cached segments back to the driver
    full = get_config(MOE_ARCH)
    cfg = full.with_(n_layers=MOE_LAYERS)
    label = "serve moe"
    log(f"{label}: {full.name} at its published width (d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} KV heads, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
        f"d_ff_expert {cfg.moe.d_ff_expert}, vocab {cfg.vocab}, {cfg.dtype}); cut: n_layers "
        f"{full.n_layers} -> {MOE_LAYERS} (40 layers need "
        f"{full.n_params() * 2 / 1e9:.0f} GB of bf16 weights)")
    model, params = _draw_family(label, cfg)
    served = _serve_family(label, model, params, switched_run=True)
    _decode_times(label, model, params, served.tok, served.cache, 5,
                  switched_vector=lambda: served.dec.step(
                      served.vec, params, served.tok, served.cache))
    _prefill_drops(label, model, params)
    launches = served.launches
    del model, params, served
    torch.cuda.empty_cache()
    _bf16_vs_f32(label, full.with_(n_layers=MOE_F32_LAYERS))
    return launches


def phase_serve_kimi() -> dict[str, int]:
    """kimi-k2-1t-a32b at its published width (d_model 7,168, 64 heads, 384
    experts top-8 and the shared expert, d_ff_expert 2,048, the dense first
    layer's d_ff 18,432, vocab 163,840, bf16), ``KIMI_LAYERS`` of its 61
    layers (the dense layer and one MoE layer): one prefill (capacity 32 at
    1,024 tokens), ``KIMI_DECODE_STEPS`` decode steps and one switched step
    at a mode vector, with the launch counts zeroed just before and read just
    after; each step's time against the decode step's byte bound."""
    from repro_torch import random as jr
    from repro_torch.kernels import build
    from repro_torch.models import get_config
    from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder

    full = get_config(KIMI_ARCH)
    cfg = full.with_(n_layers=KIMI_LAYERS)
    label = "serve kimi"
    log(f"{label}: {full.name} at its published width (d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
        f"{cfg.moe.n_shared_experts} shared, d_ff_expert {cfg.moe.d_ff_expert}, dense d_ff "
        f"{cfg.moe.d_ff_dense}, vocab {cfg.vocab}, {cfg.dtype}); cut: n_layers "
        f"{full.n_layers} -> {KIMI_LAYERS} (the dense first layer and one MoE layer; 61 "
        f"layers need {full.n_params() * 2 / 1e12:.2f} TB of bf16 weights)")
    model, params = _draw_family(label, cfg)
    dev = torch.device("cuda")
    prompts = jr.randint(jr.PRNGKey(1, dev), (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab)
    dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=SERVE_WINDOW))
    vec = (torch.arange(SERVE_BATCH, device=dev) % 2).to(torch.int32)

    def prefill():
        return model.prefill(params, prompts, model.init_cache(
            SERVE_BATCH, SERVE_MAX_SEQ, dtype=torch.float32, device=dev))

    prefill()  # first calls outside the run
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    step_ms = []
    for _ in range(KIMI_DECODE_STEPS):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    kept = {k: v.clone() for k, v in cache.items()}
    t0 = time.perf_counter()
    lv, _, kpms = dec.step(vec, params, tok, cache)
    torch.cuda.synchronize()
    sw_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(build.launch_counts)
    if launches["switch_select_batched"] == 0:
        raise AssertionError(f"{label}: the per-UE switch never launched: {launches}")
    outs = [e.fn(None, params, tok, cache) for e in dec.bank.experts]
    torch.cuda.synchronize()
    if not all(torch.equal(cache[k], kept[k]) for k in kept):
        raise AssertionError(f"{label}: the switched step wrote the cache it was given")
    if not all(torch.equal(lv[b], outs[int(m)][b]) for b, m in enumerate(vec.tolist())):
        raise AssertionError(f"{label}: the selected logits are not the chosen expert's")
    if lv.dtype is not torch.bfloat16 or not bool(torch.isfinite(lv.float()).all()):
        raise AssertionError(f"{label}: logits {lv.dtype}, finite {torch.isfinite(lv).all()}")
    n_bytes, what = decode_bytes(model, params, cache)
    bms, by = bound_ms(n_bytes, 0.0)
    best = min(step_ms)
    log(f"{label}: prefill {SERVE_BATCH} x {SERVE_PROMPT} in {prefill_s * 1e3:.2f} ms; "
        f"{KIMI_DECODE_STEPS} decode steps {[round(t, 3) for t in step_ms]} ms (host clock, "
        f"synchronised), the best at {bms / best:.4f} of its bound {bms:.3f} ms by {by} "
        f"({n_bytes / 1e9:.3f} GB: {what}), {SERVE_BATCH / best * 1e3:.1f} tokens/s; switched "
        f"step at {vec.tolist()} {sw_ms:.3f} ms, the selected rows the chosen expert's bits, "
        f"the given cache untouched, the experts' logits "
        f"{'the same bits' if torch.equal(outs[0], outs[1]) else 'differ'}; KPMs {kpms}; "
        f"launches {launches}")
    _hold_switches(label, outs[0], outs[1])
    _prefill_drops(label, model, params)
    return launches


def phase_serve_ssm() -> dict[str, int]:
    """zamba2-7b at its published width and full depth (d_model 3,584, 81
    mamba2 layers with 2 groups, one shared attention block after every 6,
    so 13 call sites each with its own KV cache, bf16), then mamba2-130m
    whole (bf16): each served with ``_serve_family`` (no
    ``generate_switched``).  zamba2's windowed expert differs from the exact
    one (window 64 against a context of 128); mamba2's two experts give the
    same bits (no attention), as in the reference."""
    from repro_torch.models import get_config

    counts = []
    for arch, expect_same in ((HYBRID_ARCH, False), (SSM_ARCH, True)):
        cfg = get_config(arch)
        label = f"serve {arch}"
        s = cfg.ssm
        log(f"{label}: {cfg.name} at its published width and depth ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, SSM state {s.d_state}, {s.n_heads(cfg.d_model)} heads of "
            f"{s.head_dim}, {s.n_groups} groups, chunk {s.chunk}"
            + (f", the shared block every {cfg.attn_every} layers" if cfg.attn_every else "")
            + f", vocab {cfg.vocab}, {cfg.dtype}); no cut")
        model, params = _draw_family(label, cfg)
        served = _serve_family(label, model, params, switched_run=False)
        _decode_times(label, model, params, served.tok, served.cache, 5,
                      switched_vector=lambda: served.dec.step(
                          served.vec, params, served.tok, served.cache))
        counts.append(served.launches)
        del model, params, served
        torch.cuda.empty_cache()
    return _sum_counts(*counts)


def _encoder_flops(cfg, batch: int, n_frames: int) -> float:
    """The encoder's products: per layer the q, k, v and o projections, the
    scores and the values over every frame, the MLP's two; 2 per
    multiply-add."""
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = batch * n_frames
    layer = (2 * tokens * d * (2 * h + 2 * kv) * hd + 2 * 2 * batch * h * n_frames ** 2 * hd
             + 2 * 2 * tokens * d * cfg.d_ff)
    return float(cfg.n_encoder_layers * layer)


def phase_serve_whisper() -> dict[str, int]:
    """whisper-large-v3 at its published width and depth (32 encoder and 32
    decoder layers, d_model 1,280, 20 heads, vocab 51,866, bf16) over
    ``WHISPER_FRAMES`` seeded stub frames a sequence: the encoder's time for
    ``SERVE_BATCH`` x ``WHISPER_FRAMES`` frames against its bound at the bf16
    peak; the serving path (``_serve_family`` with the frames and
    ``generate_switched``): both switch kernels on its (8, 51,866) bf16
    logits, the selected rows the chosen expert's bits, and the windowed
    expert the exact expert's bits (its decode body never windows, as in the
    reference); a decode and a switched step against the decode step's
    bound."""
    from repro_torch.models import get_config
    from repro_torch.models.transformer import encode
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config(WHISPER_ARCH)
    label = "serve whisper"
    log(f"{label}: {cfg.name} at its published width and depth ({cfg.n_encoder_layers} "
        f"encoder and {cfg.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.norm_kind}, {cfg.mlp_kind}, "
        f"{cfg.dtype}), {WHISPER_FRAMES} stub frames a sequence; no cut")
    model, params = _draw_family(label, cfg)
    dev = torch.device("cuda")
    frames = stub_frames(cfg, SERVE_BATCH, WHISPER_FRAMES, dev)
    with torch.no_grad():
        memory = encode(cfg, params, frames)
        enc_ms = time_ms(lambda: encode(cfg, params, frames), iters=ENCODER_ITERS, warmup=1)
    if tuple(memory.shape) != (SERVE_BATCH, WHISPER_FRAMES, cfg.d_model) or not bool(
            torch.isfinite(memory.float()).all()):
        raise AssertionError(f"{label}: encoder output {tuple(memory.shape)}, finite "
                             f"{bool(torch.isfinite(memory.float()).all())}")
    flops = _encoder_flops(cfg, SERVE_BATCH, WHISPER_FRAMES)
    # the encoder's weights read once, the frames read and its output written
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params["encoder"]))
    bms, by = bound_ms(n_bytes + 2 * frames.numel() * frames.element_size(), flops,
                       PEAK_BF16_FLOPS)
    log(f"{label}: encoder over {SERVE_BATCH} x {WHISPER_FRAMES} frames {enc_ms:.3f} ms "
        f"(mean of {ENCODER_ITERS}, CUDA events); bound {bms:.3f} ms by {by} "
        f"({flops / 1e12:.3f} TFLOP at the bf16 peak), the encoder at {bms / enc_ms:.4f} of it")
    del memory
    served = _serve_family(label, model, params, switched_run=True, frames=frames)
    if not served.same:
        raise AssertionError(f"{label}: the windowed expert differs from the exact one; the "
                             f"reference's decode body never windows")
    _decode_times(label, model, params, served.tok, served.cache, 5,
                  switched_vector=lambda: served.dec.step(
                      served.vec, params, served.tok, served.cache))
    launches = served.launches
    del model, params, served, frames
    torch.cuda.empty_cache()
    return launches


class chunked_calls:
    """Within the block, every ``chunked_attention`` call appends its
    ``(window, softcap)``: the function is wrapped in the module the
    attention calls it through."""

    def __init__(self):
        self.calls: list[tuple] = []

    def __enter__(self):
        from repro_torch.models import layers

        self._orig = orig = layers.chunked_attention

        def rec(*args, **kw):
            self.calls.append((kw.get("window"), kw.get("softcap")))
            return orig(*args, **kw)

        layers.chunked_attention = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.chunked_attention = self._orig
        return False


def phase_serve_gemma2() -> None:
    """gemma2-9b at its published width and depth (42 layers alternating local
    (window 4,096) and global, d_model 3,584, 16 heads, 8 KV heads, head_dim
    256, GeGLU d_ff 14,336, the attention softcap 50 and the logits' 30, the
    tied head over vocab 256,000, bf16): the weight draw (time, peak memory);
    ``generate`` ``SERVE_BATCH`` x ``SERVE_STEPS`` and a decode step against
    its bound; one prefill of ``LONG_PREFILL`` tokens at batch 1 on the
    chunked path (the window on the 21 local layers only, the softcap on all
    42), then ``LONG_DECODE_STEPS`` decode steps past the window, with finite
    logits; ``SwitchedDecoder`` refuses the local/global pattern on the card
    as in the reference; bf16 against float32 weights at 2 layers (a local
    and a global one)."""
    from repro_torch import random as jr
    from repro_torch.models import get_config
    from repro_torch.serving import ServingEngine, SwitchedDecoder

    full = get_config(GEMMA2_ARCH)
    cfg = full
    label = "serve gemma2"
    log(f"{label}: {cfg.name} at its published width and depth ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, window {cfg.sliding_window} on the local "
        f"layers, softcaps {cfg.attn_softcap} / {cfg.logit_softcap}, vocab {cfg.vocab}, tied "
        f"head, {cfg.dtype}); no cut")
    model, params = _draw_family(label, cfg)
    dev = torch.device("cuda")
    prompts = jr.randint(jr.PRNGKey(1, dev), (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab)
    eng = ServingEngine(model, params, max_seq=SERVE_MAX_SEQ)
    eng.generate(prompts, 2)  # first calls outside the run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, SERVE_STEPS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if res.tokens.shape != (SERVE_BATCH, SERVE_STEPS) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"{label}: generate tokens {res.tokens.shape}")
    logits, cache = model.prefill(params, prompts, model.init_cache(
        SERVE_BATCH, SERVE_MAX_SEQ, dtype=torch.float32, device=dev))
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    log(f"{label}: generate {SERVE_BATCH} x {SERVE_STEPS} tokens (prompt {SERVE_PROMPT}, "
        f"max_seq {SERVE_MAX_SEQ}) in {gen_s:.3f} s = {SERVE_BATCH * SERVE_STEPS / gen_s:.1f} "
        f"tokens/s with the prefill")
    _decode_times(label, model, params, tok, cache, 5)
    del cache
    try:
        SwitchedDecoder(model)
    except ValueError as e:
        log(f"{label}: SwitchedDecoder refuses it on the card, as in the reference: {e}")
    else:
        raise AssertionError(f"{label}: SwitchedDecoder took the local/global pattern")
    torch.cuda.empty_cache()
    # the long prefill: past 2,048 query positions (chunked) and past the window
    long = jr.randint(jr.PRNGKey(2, dev), (1, LONG_PREFILL), 0, cfg.vocab)
    lcache = model.init_cache(1, LONG_PREFILL + LONG_DECODE_STEPS, dtype=torch.float32,
                              device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with chunked_calls() as spy:
        logits, lcache = model.prefill(params, long, lcache)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    local = cfg.n_layers // 2
    want = [(cfg.sliding_window, cfg.attn_softcap), (None, cfg.attn_softcap)] * local
    if spy.calls != want:
        raise AssertionError(f"{label}: the long prefill's chunked calls {spy.calls[:4]}..., "
                             f"{len(spy.calls)} of them")
    steps_ms, finite = [], bool(torch.isfinite(logits.float()).all())
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for _ in range(LONG_DECODE_STEPS):
        t0 = time.perf_counter()
        logits, lcache = model.decode_step(params, tok, lcache)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= bool(torch.isfinite(logits.float()).all())
    if not finite or int(lcache["index"]) != LONG_PREFILL + LONG_DECODE_STEPS:
        raise AssertionError(f"{label}: long prefill logits finite {finite}, index "
                             f"{int(lcache['index'])}")
    log(f"{label}: prefill of 1 x {LONG_PREFILL} tokens {pre_s * 1e3:.2f} ms (host clock, "
        f"synchronised) = {LONG_PREFILL / pre_s:.1f} tokens/s, on the chunked path: "
        f"{len(spy.calls)} calls, window {cfg.sliding_window} on the {local} local layers "
        f"only, softcap {cfg.attn_softcap} on all; then {LONG_DECODE_STEPS} decode steps past "
        f"the window {[round(t, 3) for t in steps_ms]} ms; logits finite")
    del model, params, lcache, logits
    torch.cuda.empty_cache()
    _bf16_vs_f32(label, full.with_(n_layers=2))


def _dryrun_start() -> list:
    """The planner's subprocesses, started together: each ``DRYRUN_CELLS``
    cell, the calibrated and the direct plan of ``DRYRUN_CALIBRATE``, and
    ``launch/train.py --mesh single``.  They use the host only (``meta``
    tensors), one thread each."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmds = [("plan", c, ["-m", "repro_torch.launch.dryrun", "--arch", c[0], "--shape", c[1],
                         "--mesh", c[2]]) for c in DRYRUN_CELLS]
    a, sh, m = DRYRUN_CALIBRATE
    cell = ["--arch", a, "--shape", sh, "--mesh", m]
    cmds += [("direct", DRYRUN_CALIBRATE, ["-m", "repro_torch.launch.dryrun", *cell]),
             ("calibrated", DRYRUN_CALIBRATE, ["-m", "repro_torch.launch.dryrun",
                                                "--calibrate", *cell]),
             ("launcher", None, ["-m", "repro_torch.launch.train", "--mesh", "single"])]
    return [(kind, c, time.perf_counter(), subprocess.Popen(
        [sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for kind, c, args in cmds]


def phase_dryrun(procs: list) -> None:
    """The dry-run planner on the card's machine: each cell's record has
    status ``ok`` and is printed; the calibrated FLOP count equals the direct
    one within ``DRYRUN_CALIB_RTOL``; the training launcher with ``--mesh
    single`` prints its plan and then raises the rank-count ``ValueError``."""
    records = {}
    for kind, cell, t0, proc in procs:
        out, err = proc.communicate(timeout=900)
        wall = time.perf_counter() - t0
        if kind == "launcher":
            if proc.returncode == 0 or "ValueError: the mesh" not in err or \
                    "needs 256 ranks; the default process group has 1" not in err or \
                    "plan on the single mesh" not in out:
                raise AssertionError(f"dryrun: the launcher's --mesh single: rc "
                                     f"{proc.returncode}, {out[-400:]} {err[-400:]}")
            log(f"dryrun: launch/train.py --mesh single printed its plan ("
                f"{out.count('PartitionSpec')} placements) and raised "
                f"{err.strip().splitlines()[-1]}")
            continue
        if proc.returncode != 0:
            raise AssertionError(f"dryrun: {kind} {cell}: rc {proc.returncode}: {err[-800:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun: {kind} {cell}: {rec}")
        # the calibration extrapolates FLOPs, accessed and collective bytes,
        # as the reference's does
        fields = DRYRUN_FIELDS if kind != "calibrated" else DRYRUN_FIELDS[1::2] + DRYRUN_FIELDS[4:]
        missing = [f for f in fields if rec.get(f) is None]
        if missing:
            raise AssertionError(f"dryrun: {kind} {cell}: no {missing}")
        records[(kind, cell)] = rec
        log(f"dryrun: {kind} {' x '.join(cell)} ({wall:.1f} s wall): {json.dumps(rec)}")
    direct = records[("direct", DRYRUN_CALIBRATE)]["flops_per_device"]
    calib = records[("calibrated", DRYRUN_CALIBRATE)]["flops_per_device"]
    if abs(calib - direct) > DRYRUN_CALIB_RTOL * abs(direct):
        raise AssertionError(f"dryrun: calibrated FLOPs {calib} against direct {direct}")
    log(f"dryrun: {' x '.join(DRYRUN_CALIBRATE)}: calibrated FLOPs a device {calib:.6e} = "
        f"direct {direct:.6e} (relative {abs(calib - direct) / direct:.2e})")
    coll = {k: records[(k, DRYRUN_CALIBRATE)]["collective_bytes_per_device"]
            for k in ("direct", "calibrated")}
    for kind, want in coll["direct"].items():
        if abs(coll["calibrated"][kind] - want) > DRYRUN_CALIB_RTOL * abs(want):
            raise AssertionError(f"dryrun: calibrated {kind} bytes {coll['calibrated'][kind]} "
                                 f"against direct {want}")
    log(f"dryrun: {' x '.join(DRYRUN_CALIBRATE)}: calibrated collective bytes a device "
        f"{coll['calibrated']} = direct")


def _sharded_cfg():
    from repro_torch.models import get_config

    return get_config(SERVE_ARCH).with_(n_layers=SHARDED_LAYERS)


def _sharded_batch(cfg):
    from repro_torch.data import TokenStream

    # the global batch on every rank (the step keeps a rank's rows)
    return TokenStream(vocab=cfg.vocab, seq_len=SHARDED_SEQ, global_batch=SHARDED_BATCH,
                       host_index=0, n_hosts=1).batch_at(0)


def _sharded_steps(model, tc, state, batch, cache):
    """The train step, then a prefill of the batch's tokens and a decode step
    on the weights the train step started from."""
    from repro_torch.train import step as tstep

    new, met = tstep.train_step(model, tc, state, batch)
    toks = torch.as_tensor(batch["tokens"], device=cache["index"].device)
    logits_p, cache = model.prefill(state.params, toks, cache)
    logits_d, _ = model.decode_step(state.params, toks[:, -1:], cache)
    return new, met, logits_p, logits_d


def _shard_of(want: torch.Tensor, got) -> torch.Tensor:
    """The slice of the whole tensor ``want`` that DTensor ``got`` holds here."""
    from torch.distributed.tensor import Shard

    out = want
    mesh = got.device_mesh
    for i, p in enumerate(got.placements):
        if isinstance(p, Shard):
            n = got.shape[p.dim] // mesh.size(i)
            out = out.narrow(p.dim, mesh.get_local_rank(i) * n, n)
    return out


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _sharded_rank(rank, ref_path: str):
    """One rank of the sharded step: its shards of every result held against
    the one-rank run's whole tensors (``ref_path``), its collectives counted,
    a second train step timed, its peak memory."""
    torch.use_deterministic_algorithms(True)
    from repro_torch import random as jr
    from repro_torch.core.topology import MeshSpec
    from repro_torch.device import resolve_device
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.accounting import StepAccount
    from repro_torch.launch import specs as SP
    from repro_torch.models import Model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as tstep

    dev = resolve_device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = _sharded_cfg()
    model, tc = Model(cfg), tstep.TrainConfig(learning_rate=LM_TRAIN_LR)
    mesh, rules = MeshSpec(*SHARDED_MESH), S.make_rules()
    device_mesh = mesh.device_mesh("cuda")
    with S.mesh_context(mesh, rules):
        params = model.init(jr.PRNGKey(0, dev))
        params = S.distribute(params, model.param_pspecs(mesh, rules), device_mesh)
        state = tstep.init_train_state(model, params, tc)
        state = S.distribute(state, SP.train_state_pspecs(model, state, mesh, rules),
                             device_mesh)
        cache = model.init_cache(SHARDED_BATCH, SHARDED_SEQ, device=dev)
        cache = S.distribute(cache, SP.cache_pspecs(cache, mesh, rules), device_mesh)
        batch = _sharded_batch(cfg)
        counts = {}
        acct = StepAccount()
        with acct:
            new, met = tstep.train_step(model, tc, state, batch)
        counts["train"] = dict(acct.collectives)
        tokens = S.distribute({"tokens": torch.as_tensor(batch["tokens"], device=dev)},
                              SP.batch_pspecs(batch, mesh, rules), device_mesh)["tokens"]
        acct = StepAccount()
        with acct:
            logits_p, filled = model.prefill(state.params, tokens, cache)
        counts["prefill"] = dict(acct.collectives)
        acct = StepAccount()
        with acct:
            logits_d, _ = model.decode_step(state.params, tokens[:, -1:], filled)
        counts["decode"] = dict(acct.collectives)
        ref = torch.load(ref_path, mmap=True)
        errs = {"loss": abs(float(met["loss"]) - ref["loss"]) / abs(ref["loss"]),
                "grad_norm": abs(float(met["grad_norm"]) - ref["grad_norm"]) / ref["grad_norm"],
                "logits_prefill": _rel_l2(S.local_value(logits_p).float().cpu(),
                                          _shard_of(ref["logits_prefill"], logits_p).float()),
                "logits_decode": _rel_l2(S.local_value(logits_d).float().cpu(),
                                         _shard_of(ref["logits_decode"], logits_d).float())}
        worst, moved, n = 0.0, 0, 0
        for i, (p0, p1) in enumerate(zip(tree_leaves(state.params), tree_leaves(new.params))):
            want = _shard_of(ref["params"][i], p1).float()
            got = S.local_value(p1).float().cpu()
            start = _shard_of(ref["params0"][i], p0).float()
            # 2 lr plus one bf16 spacing of the weight (2**-7 of its value at most)
            slack = 2 * LM_TRAIN_LR + torch.abs(want) * 2.0 ** -7
            worst = max(worst, float(torch.max(torch.abs(got - want) / slack)))
            moved += int(torch.count_nonzero(want != start))
            n += want.numel()
        errs["params"] = worst
        del new, filled, logits_p, logits_d
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tstep.train_step(model, tc, state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    return {"errs": errs, "counts": counts, "step_ms": step_ms, "moved": moved, "n": n,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_sharded_step() -> None:
    """The sharded step on the card: the one-rank steps first (their results
    written for the ranks), then ``SHARDED_RANKS`` ranks sharing the card over
    gloo run them sharded on ``SHARDED_MESH``; the fake-group plan of the same
    steps on the same mesh counts the same collective bytes as each rank."""
    import tempfile

    from repro_torch import random as jr
    from repro_torch.core.topology import MeshSpec, spawn_ranks
    from repro_torch.device import resolve_device
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as tstep

    dev = resolve_device("cuda")
    cfg = _sharded_cfg()
    model, tc = Model(cfg), tstep.TrainConfig(learning_rate=LM_TRAIN_LR)
    params = model.init(jr.PRNGKey(0, dev))
    state = tstep.init_train_state(model, params, tc)
    cache = model.init_cache(SHARDED_BATCH, SHARDED_SEQ, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    new, met, logits_p, logits_d = _sharded_steps(model, tc, state, _sharded_batch(cfg), cache)
    if not (torch.isfinite(logits_p).all() and torch.isfinite(logits_d).all()
            and torch.isfinite(met["loss"])):
        raise AssertionError("sharded: the one-rank steps are not finite")
    ref = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "logits_prefill": logits_p.cpu(), "logits_decode": logits_d.cpu(),
           "params": [p.cpu() for p in tree_leaves(new.params)],
           "params0": [p.cpu() for p in tree_leaves(state.params)]}
    del new, met, logits_p, logits_d
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstep.train_step(model, tc, state, _sharded_batch(cfg))
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    one_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del params, state, cache
    torch.cuda.empty_cache()
    log(f"sharded: {cfg.name} at its published width, {SHARDED_LAYERS} of 52 layers, "
        f"{cfg.dtype}, remat {cfg.remat}, {model.n_params() / 1e9:.3f} B params; one rank: "
        f"loss {ref['loss']:.6f}, grad norm {ref['grad_norm']:.6f}, a train step on "
        f"{SHARDED_BATCH} x {SHARDED_SEQ} tokens {one_ms:.2f} ms, peak {one_peak:.3f} GB")
    # the fake-group plan of the same steps on the same mesh (host only)
    mesh, rules = MeshSpec(*SHARDED_MESH), S.make_rules()
    planned = {kind: dryrun.plan(model, ShapeCell(f"sharded_{kind}", SHARDED_SEQ,
                                                  SHARDED_BATCH, kind), mesh, rules, tc)
               for kind in ("train", "prefill", "decode")}
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = os.path.join(tmp, "one_rank.pt")
        torch.save(ref, path)
        del ref
        t0 = time.perf_counter()
        ranks = spawn_ranks(_sharded_rank, SHARDED_RANKS, (path,), device="cuda",
                            backend="gloo")
        wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        e = res["errs"]
        log(f"sharded: rank {r} of {SHARDED_RANKS} (mesh {dict(zip(*SHARDED_MESH))}, gloo, "
            f"one card): loss rel {e['loss']:.3e}, grad norm rel {e['grad_norm']:.3e}, "
            f"logits rel L2 prefill {e['logits_prefill']:.3e} decode {e['logits_decode']:.3e}, "
            f"new weights at most {e['params']:.3f} of (2 lr + a bf16 spacing), "
            f"{res['moved']:,} of {res['n']:,} weights of this shard moved; a train step "
            f"{res['step_ms']:.2f} ms, peak {res['peak_gb']:.3f} GB")
        if (e["loss"] > SHARDED_LOSS_RTOL or e["grad_norm"] > SHARDED_GNORM_RTOL
                or e["logits_prefill"] > SHARDED_LOGIT_REL
                or e["logits_decode"] > SHARDED_LOGIT_REL or e["params"] > 1.0):
            raise AssertionError(f"sharded: rank {r} against one rank: {e}")
        for kind, want in planned.items():
            if res["counts"][kind] != want["collective_bytes_per_device"]:
                raise AssertionError(f"sharded: rank {r} {kind}: collective bytes "
                                     f"{res['counts'][kind]} against the plan's "
                                     f"{want['collective_bytes_per_device']}")
    for kind, want in planned.items():
        log(f"sharded: {kind}: collective bytes a rank {want['collective_bytes_per_device']} "
            f"= the fake-group plan's; planned peak {want['peak_hbm_per_device'] / 1e9:.3f} GB, "
            f"FLOPs a rank {want['flops_per_device']:.4e}")
    log(f"sharded: {SHARDED_RANKS} ranks in {wall:.1f} s wall (spawn, draw, steps)")


def phase_families_reduced() -> None:
    """The reduced configs of the dense, MoE, SSM, hybrid, VLM,
    encoder-decoder and local/global families (float32) on the card against
    the CPU: prefill and switched steps at modes 0, 1 and a vector (gemma2,
    which has no switched decoder: 3 decode steps) within ``LM_LOGIT_TOL``,
    the MoE layers' expert assignment and kept mask equal in that prefill,
    and one train step (loss, gradient norm, weights) within
    ``LM_STEP_LOSS_RTOL`` / ``LM_STEP_WEIGHT_ATOL``.  whisper gets 8 seeded
    stub frames; gemma2's prompt and batch run 12 tokens, past its reduced
    window of 8."""
    from repro_torch import random as jr
    from repro_torch.data import TokenStream
    from repro_torch.models import Model, get_config
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder
    from repro_torch.train import step as tstep

    for arch in REDUCED_ARCHS:
        model = Model(get_config(arch, reduced=True))
        lg = model.cfg.local_global_pattern
        n = 12 if lg else 8
        p0 = model.init(jr.PRNGKey(0))
        prompts = jr.randint(jr.PRNGKey(1), (4, n), 0, model.cfg.vocab)
        batch = TokenStream(vocab=model.cfg.vocab, seq_len=n, global_batch=4).batch_at(0)
        frames = stub_frames(model.cfg, 4, 8, "cpu")
        if frames is not None:
            batch["encoder_frames"] = frames
        tc = tstep.TrainConfig(learning_rate=LM_TRAIN_LR)
        dec = None if lg else SwitchedDecoder(model, SwitchedDecodeConfig(window=4))
        got = {}
        for dev in (torch.device("cpu"), torch.device("cuda")):
            p = tree_map(lambda t: t.to(dev), p0)
            with recorded_routing() as rec:
                logits, c = model.prefill(p, prompts.to(dev), model.init_cache(
                    4, 16, dtype=torch.float32, device=dev),
                    encoder_frames=None if frames is None else frames.to(dev))
            seq, t = [logits.cpu()], prompts[:, -1:].to(dev)
            for m in (0, 1, torch.tensor([0, 1, 1, 0], dtype=torch.int32)):
                if dec is None:
                    logits, c = model.decode_step(p, t, c)
                else:
                    logits, c, _ = dec.step(m, p, t, c)
                t = torch.argmax(logits, -1)[:, None].to(torch.int32)
                seq.append(logits.cpu())
            state = tstep.init_train_state(model, p, tc)
            state, met = tstep.train_step(model, tc, state, batch)
            got[dev.type] = (seq, [(a.cpu(), k.cpu()) for a, k, _ in rec.calls],
                             float(met["loss"]), float(met["grad_norm"]),
                             [w.cpu() for w in tree_leaves(state.params)])
        (sc, rc, lc, gc, wc), (sg, rg, lg, gg, wg) = got["cpu"], got["cuda"]
        worst = 0.0
        for a, b in zip(sg, sc):
            torch.testing.assert_close(a, b, **LM_LOGIT_TOL)
            worst = max(worst, float((a - b).abs().max()))
        if len(rc) != len(rg) or not all(torch.equal(a, b) and torch.equal(k, j)
                                         for (a, k), (b, j) in zip(rg, rc)):
            raise AssertionError(f"families: {arch}: the MoE routing or kept mask differs "
                                 f"card vs CPU")
        l_err, g_err = abs(lg - lc) / abs(lc), abs(gg - gc) / abs(gc)
        w_err = max(float((a - b).abs().max()) for a, b in zip(wg, wc))
        if not (l_err <= LM_STEP_LOSS_RTOL and g_err <= LM_STEP_LOSS_RTOL
                and w_err <= LM_STEP_WEIGHT_ATOL):
            raise AssertionError(f"families: {arch}: train step card vs CPU: loss {l_err}, "
                                 f"grad norm {g_err}, weights {w_err}")
        kept = sum(int(k.sum()) for _, k in rg)
        log(f"families: reduced {arch} (float32) card vs CPU: prefill and 3 "
            f"{'decode' if dec is None else 'switched'} steps within {LM_LOGIT_TOL}, max "
            f"|diff| {worst:.3g}; "
            + (f"{len(rg)} MoE layers' assignment and kept mask equal ({kept} of "
               f"{sum(k.numel() for _, k in rg)} pairs kept); " if rg else "")
            + f"one train step: loss {lc:.6f}, rel {l_err:.3g}, grad norm rel {g_err:.3g}, "
            f"weights max |diff| {w_err:.3g} (limits {LM_STEP_LOSS_RTOL}, "
            f"{LM_STEP_WEIGHT_ATOL})")


def phase_api() -> dict[str, int]:
    """The public API's kernel path: ``mmse_estimate`` (LS + Wiener) on the main
    path's slot (n_prb 106, 4 antennas, 3 DMRS symbols) for ``N_UES`` UEs'
    received grids, with the launch counts zeroed just before the call and
    read just after it: ``mmse_interp``'s Gauss form must launch once; against
    ``use_kernel=False`` (the plain version on the card) within ``MMSE_TOL``;
    then MMSE-IRC on UE 0's grid and estimate, on the card against the CPU."""
    from repro_torch import random as jr
    from repro_torch.kernels import build
    from repro_torch.phy import DEFAULT_SLOT, mmse_estimate
    from repro_torch.phy.dmrs import dmrs_sequence
    from repro_torch.phy.equalizer import mmse_irc_equalize
    from repro_torch.phy.estimators import WienerInterpolator

    dev = torch.device("cuda")
    cfg = DEFAULT_SLOT
    if (cfg.n_prb, cfg.n_ant, cfg.n_dmrs_sym) != (N_PRB, 4, 3):
        raise AssertionError(f"DEFAULT_SLOT is not the main path's slot: {cfg}")
    k1, k2 = jr.split(jr.PRNGKey(11, dev))
    shape = (N_UES, cfg.n_ant, cfg.n_sc, cfg.n_sym)
    rx = torch.complex(jr.normal(k1, shape), jr.normal(k2, shape))
    pilots = dmrs_sequence(cfg, device=dev)
    w = WienerInterpolator.build(cfg, device=dev)
    mmse_estimate(cfg, rx, pilots, w)  # first call outside the count
    torch.cuda.synchronize()
    build.reset_launch_counts()
    got = mmse_estimate(cfg, rx, pilots, w, use_kernel=True)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    if launches["mmse_interp_gauss"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"api: mmse_estimate launched {launches}")
    want = mmse_estimate(cfg, rx, pilots, w, use_kernel=False)
    err = float((got - want).abs().max())
    if got.shape != (N_UES, cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym) or not err <= MMSE_TOL:
        raise AssertionError(f"api: mmse_estimate {tuple(got.shape)}, max |err| {err}")
    ms, plain_ms, reading = turns(lambda: mmse_estimate(cfg, rx, pilots, w),
                                  lambda: mmse_estimate(cfg, rx, pilots, w, use_kernel=False))
    x_g, s_g = mmse_irc_equalize(cfg, rx[0], got[0], pilots, 0.1)
    x_c, s_c = mmse_irc_equalize(cfg, rx[0].cpu(), got[0].cpu(), pilots.cpu(), 0.1)
    x_err = float((x_g.cpu() - x_c).abs().max())
    s_err = float(((s_g.cpu() - s_c).abs() / s_c.abs()).max())
    if not (x_err <= IRC_X_ATOL and s_err <= IRC_SINR_RTOL
            and bool(torch.isfinite(x_g).all())):
        raise AssertionError(f"api: MMSE-IRC card vs CPU: symbols {x_err}, SINR {s_err}")
    irc_ms = time_ms(lambda: mmse_irc_equalize(cfg, rx[0], got[0], pilots, 0.1), iters=20)
    log(f"api: mmse_estimate on DEFAULT_SLOT (n_prb {cfg.n_prb}), {N_UES} UEs: launches "
        f"{launches}; kernel vs use_kernel=False max |err| {err:.3g} (limit {MMSE_TOL}); "
        f"{ms * 1e3:.2f} us a call vs plain {plain_ms * 1e3:.2f} us ({reading}); "
        f"mmse_irc_equalize (UE 0) card vs CPU: symbols max |err| {x_err:.3g} (limit "
        f"{IRC_X_ATOL}), SINR max rel {s_err:.3g} (limit {IRC_SINR_RTOL}); {irc_ms:.3f} ms "
        f"a call on the card")
    return launches


def _reduced_lm_checks() -> None:
    """granite-20b's reduced config (float32): 3 steps on the card against the
    same 3 on the CPU, ``microbatches=2`` against 1 on the card, and a
    ``run_training`` killed by ``FailureInjector`` and resumed against the
    uninterrupted run, bitwise, on the card."""
    import tempfile

    from repro_torch import random as jr
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenStream
    from repro_torch.models import Model, get_config
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import FailureInjector, run_training
    from repro_torch.train import step as tstep

    model = Model(get_config(SERVE_ARCH, reduced=True))
    stream = TokenStream(vocab=model.cfg.vocab, seq_len=16, global_batch=4)
    p0 = model.init(jr.PRNGKey(0))  # one draw for both devices

    def steps(dev, **kw):
        tc = tstep.TrainConfig(learning_rate=LM_TRAIN_LR, **kw)
        state = tstep.init_train_state(model, tree_map(lambda p: p.to(dev), p0), tc)
        losses = []
        for i in range(3):
            state, m = tstep.train_step(model, tc, state, stream.batch_at(i))
            losses.append(float(m["loss"]))
        return losses, [t.cpu() for t in tree_leaves(state.params)]

    runs = {"cpu": steps(torch.device("cpu")), "cuda": steps(torch.device("cuda")),
            "cuda mb2": steps(torch.device("cuda"), microbatches=2)}
    for a, b in (("cuda", "cpu"), ("cuda mb2", "cuda")):
        (la, wa), (lb, wb) = runs[a], runs[b]
        l_err = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
        w_err = max(float((x - y).abs().max()) for x, y in zip(wa, wb))
        log(f"lm train: reduced {SERVE_ARCH} (float32), 3 steps, {a} vs {b}: losses max rel "
            f"{l_err:.3g} (limit {LM_STEP_LOSS_RTOL}), weights max |diff| {w_err:.3g} (limit "
            f"{LM_STEP_WEIGHT_ATOL}); losses {la}")
        if not (l_err <= LM_STEP_LOSS_RTOL and w_err <= LM_STEP_WEIGHT_ATOL):
            raise AssertionError(f"lm train: {a} vs {b}: losses {l_err}, weights {w_err}")

    tc = tstep.TrainConfig(learning_rate=LM_TRAIN_LR, microbatches=2, quantize_moments=True,
                           compress_grads=True)

    def init():
        return tstep.init_train_state(model, model.init(jr.PRNGKey(0, "cuda")), tc)

    finals, reports = [], []
    with tempfile.TemporaryDirectory() as root:
        for name, inj in (("clean", None), ("killed", FailureInjector(fail_at_steps=(3, 5)))):
            ckpt = CheckpointManager(os.path.join(root, name), save_every=2, keep=2)
            reports.append(run_training(
                step_fn=lambda s, b: tstep.train_step(model, tc, s, b), init_state=init,
                data=stream.iterate, ckpt=ckpt, total_steps=6, failure_injector=inj,
                log=lambda _msg: None))
            finals.append(ckpt.restore_latest(init()))
    (s0, a), (s1, b) = finals
    leaves = list(zip(tree_leaves(a), tree_leaves(b)))
    same = s0 == s1 == 6 and all((x is None and y is None) or torch.equal(x, y)
                                 for x, y in leaves)
    if not same or reports[1].restarts != 2:
        raise AssertionError(f"lm train: killed and resumed run differs on the card "
                             f"(restarts {reports[1].restarts})")
    log(f"lm train: run_training killed at steps 3 and 5 and resumed == uninterrupted on "
        f"the card, bitwise on all {len(leaves)} state leaves (quantized moments, "
        f"compressed gradients, 2 microbatches)")


def _entry_points() -> None:
    """The launcher and the quickstart as a user runs them, on the card."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as ckpt:
        for argv in ([sys.executable, "-m", "repro_torch.launch.train", "--steps", "3",
                      "--ckpt-dir", ckpt],
                     [sys.executable, str(ROOT / "examples_torch" / "quickstart.py"),
                      "--n-ues", "4"]):
            t0 = time.perf_counter()
            out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                                 timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"{argv[1:]} exited {out.returncode}:\n"
                                     f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
            last = out.stdout.strip().splitlines()[-1]
            log(f"lm train: {' '.join(argv[1:])} on the card exited 0 in "
                f"{time.perf_counter() - t0:.1f} s: {last}")


#: what the LM training phase leaves for its profile pass after the timed phases
LM_TRAINED: dict = {}


def phase_lm_train() -> None:
    """granite-20b at its published width (d_model 6,144, 48 heads, 1 KV head,
    d_ff 24,576, vocab 49,152), bf16 weights, remat "block", ``LM_TRAIN_LAYERS``
    of its 52 layers, trained on ``TokenStream`` at ``LM_TRAIN_SEQ`` tokens, global
    batch ``LM_TRAIN_BATCH`` in ``LM_TRAIN_MICRO`` microbatches: the weight draw's
    time, ``LM_TRAIN_STEPS`` steps (ms a step, tokens/s, the step against its
    bound, peak memory; the loss must fall below its first value), then one
    step each with quantized moments and compressed gradients (this also at
    half the batch) with their peaks; no hand-written kernel
    lies on this path (launch counts 0).  Then the reduced-config checks and the
    entry points as subprocesses."""
    from repro_torch import random as jr
    from repro_torch.data import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import Model, get_config
    from repro_torch.train import step as tstep

    dev = resolve_device("cuda")
    full = get_config(SERVE_ARCH)
    cfg = full.with_(n_layers=LM_TRAIN_LAYERS)
    if cfg.remat != "block" or cfg.dtype != "bfloat16":
        raise AssertionError(f"lm train: the published config's remat {cfg.remat}, {cfg.dtype}")
    model = Model(cfg)
    n_params = model.n_params()
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    # 6 N D for the forward and backward, 2 N D more for the forward that remat
    # runs again in the backward; the attention's own products are not counted
    flops = 8.0 * n_params * tokens
    bound = flops / PEAK_BF16_FLOPS * 1e3
    log(f"lm train: {full.name} at its published width (d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} KV head, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
        f"remat {cfg.remat}); cut: n_layers {full.n_layers} -> {LM_TRAIN_LAYERS}, global "
        f"batch 256 -> {LM_TRAIN_BATCH} (TRAIN_4K); {n_params / 1e9:.3f} B params; seq "
        f"{LM_TRAIN_SEQ}, {LM_TRAIN_MICRO} microbatches, lr {LM_TRAIN_LR}")
    stream = TokenStream(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the phase's own memory: what earlier phases keep on the card (the serving
    # phase's model) is subtracted from every peak below
    base = torch.cuda.memory_allocated()

    def peak_gb() -> float:
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    t0 = time.perf_counter()
    params = model.init(jr.PRNGKey(0, dev))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = peak_gb()

    tc = tstep.TrainConfig(learning_rate=LM_TRAIN_LR, microbatches=LM_TRAIN_MICRO)
    state = tstep.init_train_state(model, params, tc)
    del params
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    losses, step_s, host_draw_s = [], [], []
    for i in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = stream.batch_at(i)
        t1 = time.perf_counter()
        state, metrics = tstep.train_step(model, tc, state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        t2 = time.perf_counter()
        host_draw_s.append(t1 - t0)
        step_s.append(t2 - t1)
    peak = peak_gb()
    launches = dict(build.launch_counts)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    ms = float(np.mean(step_s[1:])) * 1e3  # the first step sets up cuBLAS and the allocator
    log(f"lm train: weight draw {draw_s:.2f} s (peak {draw_peak:.3f} GB); {LM_TRAIN_STEPS} "
        f"steps: first {step_s[0] * 1e3:.1f} ms, then {ms:.1f} ms a step (min "
        f"{min(step_s[1:]) * 1e3:.1f}, max {max(step_s[1:]) * 1e3:.1f}), "
        f"{tokens / ms * 1e3:.1f} tokens/s; bound (8 N D at {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s bf16) {bound:.1f} ms, share {bound / ms:.4f}; the batch draw on the host "
        f"{np.mean(host_draw_s) * 1e3:.2f} ms a step; peak device memory {peak:.3f} GB "
        f"over the {base / 1e9:.3f} GB earlier phases keep; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (first-5 mean {first:.4f}, last-5 mean "
        f"{last:.4f}); launches {launches}")
    log(f"lm train: losses {[round(x, 4) for x in losses]}")
    if any(launches.values()):
        raise AssertionError(f"lm train: the training path launched a kernel: {launches}")
    if not (np.isfinite(losses).all() and last < first and last < losses[0]):
        raise AssertionError(f"lm train: loss did not fall: {losses}")
    if not peak <= LM_TRAIN_PEAK_GB:
        raise AssertionError(f"lm train: peak {peak:.2f} GB over {LM_TRAIN_PEAK_GB} GB")
    params = state.params
    del state
    torch.cuda.empty_cache()
    # one step each; compressed gradients also at half the batch, which shows
    # whether their peak is the backward pass's (activations) or the update's
    half = TokenStream(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH // 2)
    for label, kw, src in (("quantize_moments", dict(quantize_moments=True), stream),
                           ("compress_grads", dict(compress_grads=True), stream),
                           ("compress_grads, half the batch", dict(compress_grads=True), half)):
        tc_k = tstep.TrainConfig(learning_rate=LM_TRAIN_LR, microbatches=LM_TRAIN_MICRO, **kw)
        st = tstep.init_train_state(model, params, tc_k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, m = tstep.train_step(model, tc_k, st, src.batch_at(LM_TRAIN_STEPS))
        loss = float(m["loss"])
        k_ms = (time.perf_counter() - t0) * 1e3
        k_peak = peak_gb()
        del st, m
        torch.cuda.empty_cache()
        log(f"lm train: one step with {label} (batch {src.global_batch}): {k_ms:.1f} ms (its "
            f"first), loss {loss:.4f}, peak device memory {k_peak:.3f} GB")
        if not np.isfinite(loss):
            raise AssertionError(f"lm train: {label} step loss {loss}")
    LM_TRAINED.update(model=model, params=params, stream=stream, ms=ms)
    _reduced_lm_checks()
    _entry_points()


def phase_lm_train_profile() -> None:
    """One full-width training step under ``torch.profiler`` (after every timed
    phase): the device's busy share of the step and its host share (the rest),
    and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import step as tstep

    model, params, stream = (LM_TRAINED[k] for k in ("model", "params", "stream"))
    tc = tstep.TrainConfig(learning_rate=LM_TRAIN_LR, microbatches=LM_TRAIN_MICRO)
    state = tstep.init_train_state(model, params, tc)
    batch = stream.batch_at(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = tstep.train_step(model, tc, state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    events = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    log(f"lm train profile: one step, {sum(e.count for e in events)} kernel launches, "
        f"{busy * 1e3:.1f} ms of device time in {wall * 1e3:.1f} ms wall (under the profiler): "
        f"device busy share {busy / wall:.4f}, host share {1 - busy / wall:.4f}")
    for e in events[:10]:
        log(f"  lm train kernel: {e.self_device_time_total / 1e3:9.2f} ms {e.count:5d} calls  "
            f"{e.key[:110]}")


def phase_device_alone() -> None:
    """The kernels' and their yardsticks' device time alone, queued by the
    kernel phases, under ``torch.profiler``."""
    for label, fn, match, iters in DEVICE_ALONE:
        us, launches = device_us(fn, match, iters)
        log(f"device alone: {label} {us:.2f} us per call, {launches:g} launches a call "
            f"({iters} calls under torch.profiler)")


def phase_profile(sess, label: str, ai_kernels: tuple[str, ...],
                  per_launch: bool = False) -> None:
    """One more ``run()`` of a session under ``torch.profiler``: the launches
    per slot, the AI expert's device time per slot (kernels whose name holds
    one of ``ai_kernels``) and kernel time by name.
    With ``per_launch`` (a GATED bank: one AI launch a slot) the AI kernel's
    device time launch by launch, grouped by the UEs its slot served."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hist = sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    launches = sum(e.count for e in events)
    ai = [e for e in events if any(k in e.key.lower() for k in ai_kernels)]
    ai_ms = sum(e.self_device_time_total for e in ai) / 1e3
    n_slots = sess.spec.n_slots
    log(f"profile {label}: loop wall {wall:.3f} s (under the profiler), "
        f"{launches / n_slots:.0f} kernel launches per slot; AI expert ({ai_kernels}, "
        f"{sum(e.count for e in ai)} calls) {ai_ms / n_slots:.3f} ms of device time per slot")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:12]:
        log(f"  {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d} calls  "
            f"{e.key[:90]}")
    if per_launch:
        launches = sorted((e for e in prof.events() if e.device_type.name == "CUDA"
                           and any(k in e.name.lower() for k in ai_kernels)),
                          key=lambda e: e.time_range.start)
        served = ((hist.modes == 0) & (hist.outputs["gated_overflow"] == 0)).sum(axis=1)
        by_rows = collections.defaultdict(list)
        for n, e in zip(served, launches):
            by_rows[int(n)].append(e.time_range.elapsed_us())
        log(f"profile {label}: {len(launches)} AI launches in {n_slots} slots, "
            f"{float(served.mean()):.2f} UEs served a slot; device us a launch by UEs served: "
            + ", ".join(f"{n}: {np.mean(t):.1f} ({len(t)})" for n, t in sorted(by_rows.items())))


def main() -> int:
    import repro_torch  # noqa: F401  (fails here when run outside the repository)

    t0 = time.perf_counter()
    smi = phase_device()
    torch.use_deterministic_algorithms(True)
    phase_build()
    rows = (phase_kernels() + phase_gated_kernels() + [phase_scalar_switch()]
            + phase_lm_switch_kernels())
    gauss_row, four_launches = phase_surface()
    rows.insert(1, gauss_row)
    rows += phase_threefry()
    conc, conc_hist, launches = run_path(
        "main path CONCURRENT", _main_spec(),
        ("mmse_interp_gauss", "switch_select_batched", "tree_infer", "gated_expert",
         "threefry"))
    gated, gated_hist, gated_launches = run_path(
        "main path GATED fused", _main_spec(execution_mode="gated", fused=True,
                                            gated_capacity=GATED_CAPACITY),
        ("gated_expert", "mmse_interp_gauss", "tree_infer", "threefry"))
    for label, counts in (("CONCURRENT", launches), ("GATED fused", gated_launches)):
        if counts["tree_infer"] != N_SLOTS:  # the whole decision phase in one launch
            raise AssertionError(f"{label}: {counts['tree_infer']} policy-step launches in "
                                 f"{N_SLOTS} decision slots")
    check_executed_flops(gated, gated_hist)
    phase_runtime(conc, conc_hist)
    unfused = dataclasses.replace(
        _main_spec(execution_mode="gated", gated_capacity=GATED_CAPACITY),
        n_slots=UNFUSED_SLOTS, scenario_args=(("poor_start", 4), ("poor_end", 9)))
    unf, unf_hist, unf_launches = run_path(
        "GATED unfused, auto_capacity", unfused, ("switch_gather_batched",),
        host_policies=conc.host_policies, auto_capacity=True, rerun=False)
    log(f"GATED unfused: auto_capacity provisioned {unf_hist.provisioned_capacity} "
        f"(declared {GATED_CAPACITY}), overflow slot-UEs {unf_hist.overflow_slot_ues}")
    # the fused GATED bank past 64 channels (the kernel's wide form), a few slots
    wide_spec = dataclasses.replace(
        _main_spec(WIDE_SESSION_CHANNELS, execution_mode="gated", fused=True,
                   gated_capacity=GATED_CAPACITY),
        n_slots=WIDE_SESSION_SLOTS, scenario_args=(("poor_start", 2), ("poor_end", 5)))
    _, _, wide_launches = run_path(
        f"GATED fused at {WIDE_SESSION_CHANNELS} channels", wide_spec, ("gated_expert",),
        host_policies=conc.host_policies, rerun=False)
    if wide_launches["gated_expert"] != WIDE_SESSION_SLOTS:
        raise AssertionError(f"{wide_launches['gated_expert']} fused GATED launches in "
                             f"{WIDE_SESSION_SLOTS} slots at {WIDE_SESSION_CHANNELS} channels")
    phase_faults(conc.host_policies)
    phase_streaming(conc.host_policies)
    phase_topology(conc.host_policies, LOOP_MS["main path CONCURRENT"])
    phase_service()
    phase_wide_width()
    host, host_launches = phase_host()
    phase_sweep(host)
    phase_train()
    api_launches = phase_api()
    # the planner's subprocesses use the host only: they run beside the
    # device-bound LM training phase
    dryrun = _dryrun_start()
    phase_lm_train()
    phase_dryrun(dryrun)
    phase_sharded_step()
    # every LM serving phase, one model at a time, after the training phase:
    # its compressed-gradient step needs nearly the whole card (72.6 GB on an
    # H100 80GB), and what a serving phase keeps or leaves in cached segments
    # before it has run it out of memory (7.55 GiB of cached segments; or
    # granite's 4.5 GB kept for the serve profile, with 7.44 GiB of fragments)
    lm_launches = _sum_counts(phase_serve(), phase_serve_moe(), phase_serve_kimi(),
                              phase_serve_ssm(), phase_serve_whisper())
    phase_serve_gemma2()
    phase_families_reduced()
    for r in rows:
        counter = r.pop("counter", r["name"])
        source = {"gated_expert": gated_launches, "switch_gather_batched": unf_launches,
                  "mmse_interp": four_launches,
                  "switch_select": host_launches, "switch_select_batched_bf16": lm_launches,
                  "switch_select_bf16": lm_launches}.get(r["name"], launches)
        r["launches"] = source[counter]
        r.pop("shape")
    log(f"kernels held against their plain versions: {[r['name'] for r in rows]}")
    phase_gated_vs_concurrent(conc_hist, conc.host_policies)
    phase_reference()
    phase_device_alone()
    phase_profile(conc, "CONCURRENT", ("gated_expert",))
    phase_profile(gated, "GATED fused", ("gated_expert",), per_launch=True)
    phase_profile(host, "host loop", ("conv", "fprop", "cudnn"))
    phase_train_profile()
    phase_serve_profile()
    SERVED.clear()
    torch.cuda.empty_cache()
    phase_lm_train_profile()
    log(f"api: mmse_interp launches from mmse_estimate on the public path: "
        f"{api_launches['mmse_interp_gauss']}")
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
