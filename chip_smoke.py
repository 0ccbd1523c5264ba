#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

  python3 chip_smoke.py [--seed N] [--parent DIR]

Phases, in order; any failure ends the script with a nonzero exit:

1. Device: the card's name, the device count and its power limit.
2. Build: every CUDA kernel of ``src/repro_torch/csrc`` with nvcc for
   sm_90a into ``build/repro_torch/`` (registers and shared memory from
   ``-Xptxas -v``), and the count of HGMMA (wgmma), HMMA (mma.sync) and
   UTMALDG (TMA load) instructions in the dense flash, paged prefill,
   latent prefill and matmul libraries from ``cuobjdump -sass``.  With
   ``--parent DIR`` (a directory outside the committed tree holding an
   earlier commit's ``flash_fwd.cu``, ``flash_bwd.cu``,
   ``paged_prefill.cu``, ``matmul.cu``, ``paged_decode.cu``,
   ``paged_latent_prefill.cu``, ``paged_latent_decode.cu`` and
   ``lcs_tile.cu`` with their headers; ``--parent-flash`` is the same
   flag), those are built too.
3. Kernels against their plain versions: each of the eight hand-written
   kernels and its plain PyTorch version on the same CUDA inputs, at the
   serving, training or PACO shapes in bf16 and f32 and on small prime/odd
   geometries (GQA: windows and softcaps, decode at G 8 with D 256 and 64
   and a zero-length slot, its row's uniform mean; MLA latent: H = 3 and 5,
   narrow latents, the wgmma latent prefill at deepseek-v2's widths
   on blocks that straddle positions, starts off the tile and chunks
   whose keys split, and the wgmma latent decode in clusters of 4 ranks
   over lengths of 1 to past the table; dense flash forward and backward:
   G 1, 2, 6 and 8, D 16 to 256,
   S 77 and 128, causal or not, windows, softcaps; at the training shape
   the backward bitwise equal over two calls; matmul: odd and prime
   shapes, k = 8192, strided views and every cuboid of plan_mm_1piece(8192,
   8192, 8192, 132), MM_TOL, bitwise equal over two calls, float32 as
   variant ``wgmma_tf32x3`` (three TF32 products); the matmul plan kernel
   on the 8192^3 plans at p = 132 and 131 and on small prime plans with
   k-cuts, MM_TOL against ``matmul_plan_ref`` and bitwise equal over two
   calls, float32 as ``wgmma_tf32x3``; LCS tile: tiles
   1 to 8192 on monotone and on arbitrary int32 borders, whole tables in
   tiles of 1 to 8192, and the main path's table (65,536^2 in tiles of
   256, 256 x 256 tiles) on arbitrary int32 borders, its whole bottom row
   and right column against the plain version on the same tensors,
   bit-exact, one launch each) (tolerances: f32 atol
   1e-4; bf16 atol 2e-2, since the two round the softmax weights at
   different points; the flash kernels relative to max(1, max |plain|),
   FLASH_TOL, and in the rows and at Sq != Sk each gradient relative to
   its own max |plain|).  Device times of the kernel, the plain version and one
   library call (``scaled_dot_product_attention``, on the pre-gathered
   cache for the paged kernels), each from a CUDA-graph replay of many
   calls cycling through the layers' pools (28 for qwen3, 60 for
   deepseek-v2; the eager per-call time of the kernel, host launch cost
   included, is printed beside it; the flash kernels at B 2 x S 4096,
   their plain versions and SDPA timed eagerly, in turns with SDPA and,
   given ``--parent``, the earlier kernels: kernel, parent, SDPA,
   SDPA, parent, kernel; paged decode, paged prefill, the latent pair,
   the matmul plan and the LCS table take turns the same way; the decode,
   latent and LCS kernels bitwise equal over two calls at their serving
   or PACO shapes), SDPA under each of its flash, memory-efficient
   and cuDNN backends pinned in turn (``sdpa_by_backend``: the fastest is
   ``library_ms``, named in ``library_backend``; a backend that refuses
   ``enable_gqa`` gets K/V expanded outside the timed region, one that
   refuses the call is recorded with its reason), and the bound from the
   shapes (bytes at 3.35 TB/s, flops at 989 TFLOP/s bf16; the matmul
   plan row: one launch over the 132 cuboids of a paco_matmul at 8192^3
   in bf16, against torch.matmul on the whole operands (and on the 132
   views), p = 131 beside it, given ``--parent`` bitwise the parent's
   plan launch (and the bf16 product on four shapes bitwise the parent's
   ``matmul``); its float32 rows, each against torch.matmul
   in true f32 (cuBLAS SGEMM, allow_tf32 off) and, given ``--parent``,
   the parent's f32 ``matmul_plan`` launch: ``matmul_plan_f32`` at 8192^3
   (p = 131 beside it) and ``matmul_plan_f32_tall`` at 65536 x 8192 x 512,
   and the matmul row, one 2048^3 f32 Strassen leaf; the latent rows'
   SDPA pinned per backend too, K/V
   expanded to the 128 heads over two layers where a backend refuses
   ``enable_gqa``; the LCS row: the whole 65,536^2 table at p = 132 in
   one launch, int32 operations at 16.7 TOP/s, the row scan as its plain
   version, no library call).  Kernels 5 and 5b at their own key length
   (``check_flash_own_key_length``, a generator of its own): Sq != Sk
   (256 against 1024 and 1024 against 256 at D 64, 300 against 1000
   causal, whose keys past 300 must get zero dK and dV, 512 against 768
   at D 128 and 256) and zamba2's D 112 (S 2048, causal, wgmma padded to
   128), f32 and bf16, against ``attention_ref`` and its gradient
   (FLASH_TOL), bf16 bitwise over two calls; rows ``flash_attention_cross``
   and ``flash_attention_bwd_cross`` (5x, 5bx: seamless-m4t-medium's
   cross-attention, B 2, Hq 16, Sq 256, Sk 1024, D 64) and
   ``flash_attention_d112`` and ``flash_attention_bwd_d112`` (5@112,
   5b@112: zamba2-7b's shared block, B 1, Hq 32, S 2048, D 112, causal),
   and ``flash_attention_d256`` and ``flash_attention_bwd_d256`` (5@256,
   5b@256: gemma2-2b's attention, B 2, Hq 8, Hkv 4, S 4096, D 256,
   causal, softcap 50 as the model's, on the D-256 wgmma kernels; SDPA,
   which has no softcap, uncapped), each against its plain version
   and bitwise over two calls, timed with SDPA (and its backward) per
   backend and, given ``--parent``, the parent's kernels in turns (every
   row of these shapes must report the ``wgmma`` variant).  Rows
   ``flash_attention_f32`` / ``flash_attention_bwd_f32`` and their
   ``_cross_f32`` pair (5f, 5bf: row 5's and 5x's shapes in float32) on
   the float32 family ``wgmma_tf32x3``, and rows ``paged_decode_f32``,
   ``paged_prefill_f32``, ``paged_latent_decode_f32`` and
   ``paged_latent_prefill_f32`` (1f-4f: rows 1-4's shapes in float32, the
   CUDA-core families phases 4 and 6's float32 runs launch, whose counts
   those phases take), each against its plain version and SDPA in
   float32.  Every float32 row's bound is its products as the card makes
   them f32-accurate, three TF32 products at 495 TFLOP/s (or its bytes),
   with ``bound_cuda_cores_ms`` one true f32 product at 67 TFLOP/s beside
   it (``_row``).  With ``--parent`` the flash pair is bitwise the parent's at
   D 16, 64 and 128 in bf16 and at D 16 in float32 (both sides at one
   rank), within FLASH_TOL of it in float32 at D 64 and 128, and the
   wgmma kernels the parent also has (D 64, 112, 128) keep its HGMMA,
   WARPGROUP, BAR and SYNCS counts; the D-256 kernels' counts are
   printed.
3b. verify_kernels: the speculative-verify entries of kernels 2 and 4
   (``paged_verify``, ``paged_latent_verify``: one launch for all slots,
   each slot's start read on the device) against their plain versions in
   f32 and bf16 and bitwise over two calls, at qwen3-0.6b's serving
   verify (8 slots, W 8, Hq 16, Hkv 8, D 128, page 64), gemma2-2b's heads
   with its window and softcap, and deepseek-v2's latent widths (H 128,
   kv_lora 512, qk_rope 64, page 128, W 8), over lengths with an inactive
   slot, a window across a page boundary, one reaching the last mapped
   page and slots splits apart; each timed in bf16 over its model's
   layers' pools beside its plain version, SDPA under the windows' mask
   pinned per backend, and the bound (each slot's live K/V once, q, out),
   and given ``--parent`` the parent's entries in turns; one bf16 call of
   each is one launch of the ``"cluster"`` family (splits sized from the
   lengths on the device, merged on chip) that allocates no scratch.
3c. seq_attention (``seq_attention_phase``): sequence-parallel attention,
   the key-block entries of kernels 5 and 5b (``flash_fwd_block``,
   ``flash_bwd_block``) and their merge (``seq_attention`` with the list
   reduction, the code a mesh runs over its model axis's group) at
   gemma2-2b's full width (B 1, Hq 8, Hkv 4, D 256, softcap 50): S 4096
   causal (train_4k's global layer) and S 8192 with window 4096 (a local
   layer), cut into 16 key blocks (the 16 x 16 mesh's model axis) and
   into 5, f32 and bf16.  Each block against its plain version, the
   merged forward and backward against the whole-sequence kernels 5 and
   5b (FLASH_TOL) and bitwise over two runs, one block at offset 0
   bitwise kernel 5's O.  Then the main path with the counts zeroed and
   read (bf16, S 4096, 16 blocks: 16 launches of each entry, all
   ``wgmma``) and rows ``flash_attention_block`` (5s) and
   ``flash_attention_block_bwd`` (5bs): rank 0's block and the last
   rank's, the plain versions, SDPA under the block's boolean mask per
   backend, the block formula's bound and, given ``--parent``, the
   parent's entries on the same blocks in turns, at B 1 and again at B 16
   (a rank's batch of train_4k on the 16 x 16 mesh, the row's "b16").
4. One full-width qwen3-0.6b prompt chunk per slot and 8 decode ticks
   through the kernels and through the plain path (``use_kernel=False``)
   with the same seeded random weights, in float32 and in bf16: logits
   agree within MODEL_ATOL of the dtype, and greedy tokens agree wherever
   the plain path's top-2 margin exceeds it.
5. Serve: ``ServeEngine`` on full-width qwen3-0.6b (8 slots, max_seq 2048,
   page 64, chunk 64, 8 ticks per dispatch), 16 requests with prompt
   lengths drawn in [48, 1000] and 32 new tokens each.  The launch counts
   of both kernels are zeroed just before and read just after: prefill
   launches == prefill_calls * 28 and decode launches == decode_steps * 28,
   every prefill launch of the tensor-core variant (``mma_sync``) and
   every decode launch of the one-launch cluster kernel's tensor-core
   family (``mma_sync``).
   One served request is replayed through the plain path, teacher-forced,
   and its tokens must agree under the margin rule of phase 4.
5b. serve_speculative: the same requests with ``speculate=0`` (W 8) and
   ``spec_min_accept=0``, so that every dispatch verifies: verify launches
   == decode_steps * 28, all ``mma_sync``, no decode launch; the
   acceptance stats consistent; three requests against the port's
   ``reference_decode`` on the card (agreement up to the first
   difference, where the oracle's top-2 margin is within MODEL_ATOL), the
   longest replayed through the plain path; tok/s, acceptance, tokens per
   verify step and the agreement with phase 5's tokens printed.
5c. serve_legacy: four of the requests with ``fused=False`` (one decode
   step and one host argmax per token): decode launches == decode_steps *
   28, every request replayed through the plain path, one against the
   oracle.
5d. qwen3 non-paged: the same weights on the dense cache
   (``prefill_decoder`` over 8 prompts of 512, max_seq 1024: kernel 5,
   one ``wgmma`` launch a layer; 32 greedy ``decode_step_decoder``
   ticks), the plain path within MODEL_ATOL and the paged path (kernels
   2 and 1) on the same tokens by the margin rule.
6. Full-width deepseek-v2 (MLA + MoE), depth cut to fit the card: one
   128-token chunk per slot and 8 ticks through the kernels and through
   the plain path, in float32 (2 layers) and bf16 (4 layers), each model
   freed before the next; MODEL_ATOL and the margin rule as in phase 4,
   with MoE router near ties handled as ``moe_full_width_parity`` says.
7. Serve deepseek-v2 (bf16, 4 layers, page 128, chunk 128) like phase 5:
   latent prefill launches == prefill_calls * 4 and latent decode
   launches == decode_steps * 4, every one of both ``wgmma``; then every
   model call of
   the run is replayed through the plain path (``replay_schedule``).
7b. serve_speculative on deepseek-v2: the same requests, every dispatch
   verifying: latent verify launches == decode_steps * 4, all ``wgmma``;
   the whole schedule, verify windows included, replayed through the
   plain path on the served routing; the agreement with phase 7's tokens
   printed but not gated (MoE capacity depends on the tokens of a call:
   B x W in a verify window, B in a decode tick).
7c. deepseek-v2 non-paged: per slot a 128-token ``prefill_decoder`` on
   the dense latent cache and a paged chunk (kernel 4), then 16 ticks of
   ``decode_step`` against ``decode_step_paged`` (kernel 3), the dense
   path following the paged path's expert choices: MODEL_ATOL and the
   margin rule.
7d. mamba2 model: mamba2-780m at full width (48 layers), B 2 x S 1024 in
   chunks of 256, f32 and bf16: decode from an empty state over the
   first 64 tokens against the forward at each position (the margin
   rule; f32 also within MODEL_ATOL).  Attention-free: no kernel.
7e. zamba2 model: zamba2-7b at full width (81 layers in 9 groups, ~6.6 B
   parameters, bf16), B 1 x S 2048: the forward through kernel 5 at D 112
   (9 launches, ``wgmma``) within MODEL_ATOL of the plain path, then 64
   decode steps against it by the margin rule.
7f. seamless model: seamless-m4t-medium at full width (bf16), B 2, 1024
   source frames, 256 target tokens: the forward through kernel 5 three
   ways (36 ``wgmma`` launches, 12 at Sq 256 against Sk 1024) within
   MODEL_ATOL of the plain path; ``prefill`` and 32 greedy decode steps
   against the teacher-forced forward by the margin rule.  The launches
   of rows 5@112 and 5x are the zamba2 forward's and this phase's cross
   launches.
8. Full-width qwen3-0.6b train-step parity at B 2 x S 4096: loss and
   gradients through the flash kernels and through the plain path
   (``use_kernel=False``) on the same weights and batch, in float32 at
   depth 2 and in bf16 at depth 28 (TRAIN_PARITY_TOL).
9. Train full-width qwen3-0.6b through ``Trainer`` (the code
   ``launch.train`` runs): 5 steps at B 2 x S 4096, remat on.  Each step's
   loss and time, tokens/s and model FLOP/s (6 N tokens / time, against
   989 TFLOP/s) over steps 2-5, and peak memory.  The flash kernels'
   launch counts are zeroed just before and read just after: 2 x 28
   forward and 28 backward launches per step.  Then the parameters go
   through the port's checkpoint and back, bit for bit.
9b. The new families' train-step parity at full width, as phase 8 (loss,
   gradient norm and every leaf's gradient through the kernels against
   the plain path, TRAIN_PARITY_TOL; the flash counts of one evaluation
   with remat): seamless-m4t-medium at full depth in bf16 and float32, B 2,
   1024 source frames, 256 target tokens (kernel 5b 36 times, 12 of them
   the cross-attention at Sq 256 against Sk 1024; ``cluster`` and
   ``wgmma`` in bf16, ``wgmma_tf32x3`` in float32); zamba2-7b in bf16, B
   1 x S 2048, at 2 of its 9
   groups (``HYBRID_TRAIN_GROUPS``: full depth does not fit one card for
   training), kernels 5 and 5b at D 112 on ``wgmma``.
9c. ``Trainer`` on each new family, 3 steps at the same sizes
   (mamba2-780m at B 2 x S 1024, through ``Trainer`` alone: no attention
   kernel): every loss finite, the flash counts of the steps with remat.
   Rows 5bx's and 5b@112's launches are seamless's and zamba2's.
9d. gemma2-2b trains (``gemma2_train``): full width, 2 of its 26 layers
   (one local with window 4096, one global), B 1 x S 4096, bf16, kernels
   5 and 5b at D 256: one ``train_step`` against the plain path within
   TRAIN_PARITY_TOL (flash counts of one evaluation with remat, all
   ``wgmma``), then 3 ``Trainer`` steps, whose flash launches are rows
   5@256's and 5b@256's; given ``--parent``, the same steps through the
   parent's flash libraries, step times side by side.
10. The paper's PACO algorithms at full size, p = the card's SM count
   (132) and the prime 131 (``paco_algorithms``): LCS of two 65,536-base
   sequences (p = 132 and 131 in tiles of 256, PO and PA), exactly the
   plain row scan; paco_matmul on 8192^3 (f32 and bf16) and
   65536 x 8192 x 512 (f32); Strassen at depth 2 on 8192^2; sample sort
   of 2^26 floats; 1D (n 2048) and GAP (n 64).  The kernels' launch
   counts are zeroed before and read after each call: one matmul plan
   launch walking p cuboids per paco_matmul (bf16 as ``wgmma``, f32 as
   ``wgmma_tf32x3``), 49 matmul launches per depth-2 Strassen (all
   ``wgmma_tf32x3``), one LCS launch per table.
11. mesh: the distributed paths on a one-rank NCCL group over an
   in-process store, the card as a 1 x 1 (data, model) ``DeviceMesh``
   (``mesh_phase``).  The full-width qwen3-0.6b ``train_step`` (bf16, B 2
   x S 4096) with params laid out by ``param_specs`` and the batch by
   ``batch_specs``, against the same step without a mesh: loss and
   gradient norm within TRAIN_PARITY_TOL, every updated leaf within 2 lr
   + 2^-7 of its max, bitwise reported, the flash counts of both (56
   forward, 28 backward) as reckoned.  ``ServeEngine(mesh=...)`` (8
   slots, max_seq 2048, 8 requests of 48..512 tokens, 16 new), fused and
   speculative, against the engine without a mesh: equal tokens, equal
   launch counts of kernels 1, 2 and 2v (each zeroed just before and
   read just after a run).  ``paco_matmul_shmap`` and ``paco_matmul_pjit``
   at 4096^3 bf16 (MM_TOL), ``paco_sort_shmap`` of 2^24 floats (exact),
   ``apply_moe_paco_ep`` on one full-width olmoe-1b-7b layer (64 experts,
   top-1, f32) against the dense top-1 reference (MOE_EP_TOL),
   ``seq_attention`` at rows 5s/5bs's geometry (16 key blocks, f32 and
   bf16) merged over the model axis's NCCL group, forward and backward
   bitwise the list-only merge, and ``ElasticRunner`` on qwen3-0.6b cut
   to 2 layers, replaying from its checkpoint after a simulated loss of
   ranks (rtol 2e-4).
12. launch tooling (``launch_phase``): (a) full-width qwen3-0.6b in bf16
   at two one-card cells, the train step at B 2 x S 4096 and one
   dense-cache decode step at B 8 x S 32768 (30.1 GB of K/V): each traced
   on fake CUDA tensors (``launch.dryrun.trace``: ``launch.cost``'s
   counters and MemTracker), then run for real on the card under the same
   counters; operations and bytes must be equal and the predicted peak
   within PEAK_TOL of ``max_memory_allocated()``; printed beside them,
   the roofline's bound (``launch.roofline.terms``) against the step's
   median of 5 timed runs (CUDA events) and its dominant term.  (b)
   ``launch.dryrun.run_cell("qwen3-0.6b", "train_4k")`` on the host: the
   256-rank production mesh on a fake process group, status ``ok``.  (c)
   the four ``examples/torch`` scripts at their defaults on the card, the
   launches of kernels 1, 2, 5, 5b, 6 and 7 each adds logged (each must
   launch its own).

Each phase prints its time.
The second-to-last line is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# The card's figures and the kernels' work have one home each: the data
# sheet's peaks and HBM rate in repro_torch/card.py, the per-kernel flops
# and bytes in repro_torch/kernels/work.py.
from repro_torch.card import (HBM_BYTES_PER_S, PEAK_FLOPS,  # noqa: E402
                              PEAK_TF32_FLOPS)
from repro_torch.kernels import work as W  # noqa: E402
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Full-model logits of the kernel path vs the plain path, 28 layers deep.
# The paths differ only in how attention rounds: in float32 by summation
# order, so they agree to 1e-3 on logits of unit scale; in bf16 the plain
# version also rounds the softmax weights to bf16, and every layer's bf16
# activations carry a rounding step (2**-8 of the value) that the next
# layers of a random-weight model amplify, so logits of unit scale move by
# up to a tenth: 0.25 bounds that, and float32 shows the math is the same.
MODEL_ATOL = {torch.float32: 1e-3, torch.bfloat16: 0.25}
ARCH = "qwen3-0.6b"
ITERS = 200   # timed calls per kernel
FLASH_ITERS = 20   # timed calls per flash kernel at the training shape
# deepseek-v2 at full width, depth cut to fit one card: about 36 GB of
# float32 weights at 2 layers, 34 GB of bf16 at 4 (each block holds 3.97 B
# parameters, 3.77 B of them routed experts).
DS_ARCH = "deepseek-v2-236b"
DS_DEPTH = {torch.float32: 2, torch.bfloat16: 4}
# A router choice is a near tie when the plain path's k-th and (k+1)-th
# router probabilities differ by less than this: rounding may move the
# other path's probabilities that far and flip its choice.  Set above the
# largest difference measured between the kernel and plain paths at full
# width (2.2e-7 in float32; 3.0e-3 and 3.9e-3 in bf16); each check prints
# its own (router_prob_max_diff) beside the count of near ties.
ROUTER_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
MAX_EXCLUDED = 0.10   # share of logit rows a routing flip may leave out
# Dense flash kernels vs the plain versions, as max abs error over
# max(1, max |plain|).  float32: 1e-4.  bf16: 2e-2, since the kernels round
# the softmax weights (and dS) to bf16 before the products on tensor cores
# (2**-9 relative), and round O, dQ, dK and dV to bf16 on the way out.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_BATCH, TRAIN_SEQ = 2, 4096   # Qwen3 stage-1 pretraining length
TRAIN_STEPS = 5
TRAIN_F32_DEPTH = 2    # float32 full width: logits and grads of 28 layers
#                        would not leave room for the plain path's scores
# Full-width train-step parity, kernel path vs plain path.  float32: the
# paths differ only in the order of attention's sums, so the loss agrees
# to 1e-4 (of ~12), the gradient norm to 1e-4 relative, and each leaf's
# gradient to 1e-3 of the leaf's max.  bf16: the kernels round the
# unnormalized softmax weights and dS to bf16 where the plain path rounds
# the normalized weights, and 28 layers of a random-init model carry each
# difference on, so the loss is held to 0.05, the norm to 5% and each
# leaf's gradient direction to cosine 0.98.
TRAIN_PARITY_TOL = {
    torch.float32: {"loss": 1e-4, "grad_norm": 1e-4, "leaf_rel": 1e-3},
    torch.bfloat16: {"loss": 0.05, "grad_norm": 0.05, "leaf_cosine": 0.98}}
# The new families' training cells (phases 9b-9c), at full width: (batch,
# seq, src_len), the sizes of their model phases.  seamless-m4t-medium at
# full depth in bf16 and in float32: ~0.97 B parameters, ~12 GB of float32
# weights and the two paths' float32 gradients, so no cut.  mamba2-780m at
# full depth, through ``Trainer`` alone: it has no attention kernel, so a
# kernel-against-plain parity would hold the plain path against itself.
# zamba2-7b's 81 layers do not fit one card for training: ~6.75 B
# parameters x (2 + 2 + 8) bytes of bf16 weights, gradients and float32
# AdamW moments is ~81 GB before activations.  AdamW also takes a few
# float32 temporaries of the leaf it updates, and the Mamba layers'
# in_proj is one leaf stacked over every layer of the groups (52 M values
# a layer): at 4 groups (36 layers, ~3.25 B parameters) that leaf's
# temporaries are 7.5 GB each and the step ran out of the card's 80 GB.  2
# of its 9 groups (18 layers, ~1.84 B parameters: ~22 GB of weights,
# gradients and moments, ~3.8 GB a temporary) keep whole groups, so that
# the shared block's gradient sums over two of them.
ENCDEC_TRAIN = {"batch": 2, "seq": 256, "src_len": 1024}
HYBRID_TRAIN = {"batch": 1, "seq": 2048}
HYBRID_TRAIN_GROUPS = 2
SSM_TRAIN = {"batch": 2, "seq": 1024}
FAMILY_TRAIN_STEPS = 3
# The PACO algorithms at full size (phase 10): the shapes of
# benchmarks/bench_mm.py:53-54 and bench_lcs.py's PO and PA settings.
PACO_MM_SHAPES = [((8192, 8192, 8192), torch.float32),
                  ((8192, 8192, 8192), torch.bfloat16),
                  ((65536, 8192, 512), torch.float32)]
# The kernels line's row that counts each shape's plan launches.
PACO_MM_ROWS = ("matmul_plan_f32", "matmul_plan", "matmul_plan_f32_tall")
PACO_MM_N = 8192          # the cube whose 132 cuboids the kernel checks use
PACO_LCS_N = 65536        # two DNA sequences (4 symbols) of 64 Ki bases
PACO_SORT_N = 2 ** 26
PACO_STRASSEN_N = 8192
# Matmul kernel vs its plain version (``matmul_ref``: cuBLAS in float32,
# cast to the dtype), as max abs error over max(1, max |plain|).  float32:
# both sum up to 8192 products in f32 in different orders, which moves a
# result by ~1e-7 of the largest output on normal inputs; 1e-5 leaves two
# orders of margin and still catches any wrong tile (an O(1) error).
# bf16: both sum in f32 and round once to bf16, so a result may differ by
# one bf16 step (2**-8 relative) where the sums straddle a rounding point.
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# paco_matmul and Strassen against the whole product.  paco_matmul in bf16
# rounds each k-cut's partial product to bf16 and adds them in bf16 (as
# repro does): a few bf16 steps, 2e-2 of the largest output.  Strassen's
# pre- and post-additions in f32 cancel terms of the size of the largest
# output: 1e-4 of it at depth 2.
PACO_MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
STRASSEN_TOL = 1e-4
LCS_OPS_PER_CELL = W.LCS_OPS_PER_CELL


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(label: str):
    t0 = time.perf_counter()
    yield
    log(f"[time] {label}: {time.perf_counter() - t0:.1f}s")


def _events_ms(run, iters: int) -> float:
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_ms(fn, iters: int) -> tuple[float, float]:
    """Mean ms per call of fn(i) over ``iters`` calls, by CUDA events after
    a warm-up: (device time, from one replay of a CUDA graph that captured
    the calls; eager time, host launch cost included)."""
    for i in range(3):
        fn(i)
    eager = _events_ms(lambda: [fn(i) for i in range(iters)], iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    device = _events_ms(graph.replay, iters)
    del graph
    return device, eager


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# The library yardstick: scaled_dot_product_attention with each of these
# backends pinned in turn (``torch.nn.attention.sdpa_kernel``); the fastest
# that runs is a row's ``library_ms``, its name ``library_backend``.
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def _refusal(err: Exception, caught) -> str:
    """The error and PyTorch's warnings on why, without the source lines."""
    why = []
    for text in [str(err)] + [str(w.message) for w in caught]:
        text = text.split("(Triggered internally")[0].strip()
        if text and text not in why:
            why.append(text.splitlines()[0])
    return " | ".join(why)[:400]


def sdpa_by_backend(run) -> dict:
    """``run(gqa)`` builds and times one SDPA call its own way and returns
    ms; it is called with each backend of SDPA_BACKENDS pinned: first with
    ``enable_gqa`` (gqa True) and, where the backend refuses that, on K/V
    expanded to the query heads outside the timed region (gqa False).
    Returns the ms of each backend that ran, why each other one refused
    (the error and PyTorch's warnings), which ran on expanded K/V, and the
    fastest."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times, refused, expanded = {}, {}, []
    for name in SDPA_BACKENDS:
        reasons = []
        for gqa in (True, False):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    with sdpa_kernel(getattr(SDPBackend, name)):
                        times[name] = run(gqa)
                except RuntimeError as e:
                    reasons.append(("with enable_gqa: " if gqa else
                                    "on expanded K/V: ")
                                   + _refusal(e, caught))
                    continue
            if not gqa:
                expanded.append(name)
            break
        else:
            refused[name] = "; ".join(reasons)
    best = min(times, key=times.get) if times else None
    return {"ms": times, "refused": refused, "expanded": expanded,
            "best": best}


def _merge_sdpa(turns: list[dict]) -> dict:
    """Per backend, the mean over the turns that timed it."""
    out = dict(turns[0])
    ms = {}
    for name in SDPA_BACKENDS:
        got = [t["ms"][name] for t in turns if name in t["ms"]]
        if got:
            ms[name] = sum(got) / len(got)
    out["ms"] = ms
    out["best"] = min(ms, key=ms.get) if ms else None
    return out


def _with_library(row: dict, sdpa: dict) -> dict:
    row["library_ms"] = sdpa["ms"].get(sdpa["best"]) if sdpa["best"] else None
    row["library_backend"] = sdpa["best"]
    row["library_ms_by_backend"] = sdpa["ms"]
    row["library_refused"] = sdpa["refused"]
    row["library_expanded_kv"] = sdpa["expanded"]
    return row


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_small_geometries(gen: torch.Generator) -> dict[str, float]:
    """The prime/odd pools, windows and softcaps of the repo's serving
    tests, in f32 and bf16: kernel vs plain version."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ops

    dev = "cuda"
    worst = {"paged_decode": 0.0, "paged_prefill": 0.0}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for kw in ({}, {"window": 6}, {"logit_cap": 20.0},
                   {"window": 3, "logit_cap": 5.0}):
            b, hq, hkv, d, page, n_pages = 3, 4, 2, 16, 4, 13
            q = rnd(b, 1, hq, d, dtype=dtype)
            kp = rnd(n_pages, page, hkv, d, dtype=dtype)
            vp = rnd(n_pages, page, hkv, d, dtype=dtype)
            bt = torch.tensor([[0, 3, 5, 7], [1, 2, 4, 6], [8, 9, 10, 11]],
                              dtype=torch.int32, device=dev)
            lens = torch.tensor([5, 16, 1], dtype=torch.int32, device=dev)
            got = K.paged_flash_decode(q, kp, vp, bt, lens,
                                       scale=1 / math.sqrt(d), **kw)
            want = ops.paged_decode_attention(q, kp, vp, bt, lens,
                                              use_kernel=False, **kw)
            err = max_err(got, want)
            assert err <= ATOL[dtype], ("paged_decode", dtype, kw, err)
            worst["paged_decode"] = max(worst["paged_decode"], err)
        # G 8 at D 256 (gemma2's decode) and at D 64; a zero-length slot
        for (hq, hkv, d), kw in itertools.product(
                ((16, 2, 256), (8, 1, 64)),
                ({}, {"window": 40, "logit_cap": 30.0})):
            page, n_pages = 16, 29
            bt = torch.randperm(n_pages - 1, generator=gen, device=dev)
            bt = bt[:24].reshape(3, 8).to(torch.int32)
            lens = torch.tensor([0, 77, 128], dtype=torch.int32, device=dev)
            q = rnd(3, 1, hq, d, dtype=dtype)
            kp = rnd(n_pages, page, hkv, d, dtype=dtype)
            vp = rnd(n_pages, page, hkv, d, dtype=dtype)
            got = K.paged_flash_decode(q, kp, vp, bt, lens,
                                       scale=1 / math.sqrt(d), **kw)
            want = ops.paged_decode_attention(q, kp, vp, bt, lens,
                                              use_kernel=False, **kw)
            # the zero-length slot: its row's uniform mean, as the plain
            # version gives it
            err = max_err(got, want)
            assert err <= ATOL[dtype], ("paged_decode", dtype, hq, d, err)
            worst["paged_decode"] = max(worst["paged_decode"], err)
        for kw in ({}, {"window": 5}, {"logit_cap": 20.0},
                   {"window": 3, "logit_cap": 5.0}):
            hq, hkv, d, page, n_pages, c = 4, 2, 16, 4, 13, 8
            q = rnd(1, c, hq, d, dtype=dtype)
            kp = rnd(n_pages, page, hkv, d, dtype=dtype)
            vp = rnd(n_pages, page, hkv, d, dtype=dtype)
            row = torch.tensor([2, 5, 7, 11], dtype=torch.int32, device=dev)
            got = K.paged_flash_prefill(q, kp, vp, row, 8,
                                        scale=1 / math.sqrt(d), **kw)
            want = ops.paged_prefill_attention(q, kp, vp, row, 8,
                                               use_kernel=False, **kw)
            err = max_err(got, want)
            assert err <= ATOL[dtype], ("paged_prefill", dtype, kw, err)
            worst["paged_prefill"] = max(worst["paged_prefill"], err)
        for page, pps, n_pages, c, start in [(3, 3, 11, 3, 3),
                                             (5, 2, 7, 5, 5),
                                             (2, 4, 13, 6, 0)]:
            hq, hkv, d = 4, 2, 8
            row = torch.randperm(n_pages, generator=gen, device=dev)[:pps]
            row = row.to(torch.int32)
            q = rnd(1, c, hq, d, dtype=dtype)
            kp = rnd(n_pages, page, hkv, d, dtype=dtype)
            vp = rnd(n_pages, page, hkv, d, dtype=dtype)
            got = K.paged_flash_prefill(q, kp, vp, row, start,
                                        scale=1 / math.sqrt(d))
            want = ops.paged_prefill_attention(q, kp, vp, row, start,
                                               use_kernel=False)
            err = max_err(got, want)
            assert err <= ATOL[dtype], ("paged_prefill", dtype, page, err)
            worst["paged_prefill"] = max(worst["paged_prefill"], err)
    return worst


def bench_kernels(cfg, gen: torch.Generator, iters: int,
                  parent: ParentKernels | None = None,
                  dtype: torch.dtype = torch.bfloat16) -> list[dict]:
    """Each kernel at the serving shapes of full-width qwen3-0.6b in
    ``dtype``: checked against its plain version (with and without a
    window and a softcap), then timed over the 28 layers' pools in turn,
    so that each call finds its layer's K/V outside the 50 MB L2 as the
    serving loop does.  float32 (rows 1f and 2f, the CUDA-core families
    phase 4's float32 run launches) names its rows with "_f32" and times
    no parent."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ops

    dev = "cuda"
    n_layers, hkv, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    hq, g = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    slots, page, pps = 8, 64, 32
    n_pool = slots * pps + 1
    scale = 1 / math.sqrt(d)
    rows = []
    tag = "" if dtype == torch.bfloat16 else "_f32"
    parent = parent if dtype == torch.bfloat16 else None

    # ---- decode: B=8 slots, lengths as the serving run's contexts
    lens = torch.randint(48, 1000 + 32 + 1, (slots,), generator=gen,
                         device=dev, dtype=torch.int32)
    perm = torch.randperm(n_pool - 1, generator=gen, device=dev)
    bt = perm[:slots * pps].reshape(slots, pps).to(torch.int32).contiguous()
    q = torch.randn(slots, 1, hq, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pool, page, hkv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_pool, page, hkv, d, generator=gen, device=dev).to(dtype)
    for kw in ({}, {"window": 300}, {"logit_cap": 30.0}):
        err_decode = max_err(K.paged_flash_decode(q, kp, vp, bt, lens,
                                                  scale=scale, **kw),
                             ops.paged_decode_attention(
                                 q, kp, vp, bt, lens, use_kernel=False, **kw))
        assert err_decode <= ATOL[dtype], ("paged_decode", kw, err_decode)
    del kp, vp   # err_decode: the softcap case, the last checked

    # ---- the 28 layers' pools, in the timed dtype
    kpool = torch.randn(n_layers, n_pool, page, hkv, d, generator=gen,
                        device=dev).to(dtype)
    vpool = torch.randn(n_layers, n_pool, page, hkv, d, generator=gen,
                        device=dev).to(dtype)
    q = torch.randn(slots, 1, hq, d, generator=gen, device=dev).to(dtype)
    err_decode = max(err_decode, max_err(
        K.paged_flash_decode(q, kpool[0], vpool[0], bt, lens, scale=scale),
        ops.paged_decode_attention(q, kpool[0], vpool[0], bt, lens,
                                   use_kernel=False)))
    assert err_decode <= ATOL[dtype], ("paged_decode", err_decode)
    first = K.paged_flash_decode(q, kpool[0], vpool[0], bt, lens,
                                 scale=scale)
    assert torch.equal(first, K.paged_flash_decode(
        q, kpool[0], vpool[0], bt, lens, scale=scale)), \
        "paged_decode is not bitwise reproducible"
    # the calls take turns on the card: kernel, parent kernel (given
    # ``parent``), SDPA twice (below), parent, kernel
    dturns = collections.defaultdict(list)

    def decode_kernel_turn():
        dturns["k"].append(time_ms(lambda i: K.paged_flash_decode(
            q, kpool[i % n_layers], vpool[i % n_layers], bt, lens,
            scale=scale), iters))

    def decode_parent_turn():
        if parent is None:
            return
        out = torch.empty_like(q)
        got = parent.paged_decode(q, kpool[0], vpool[0], bt, lens, out)
        dturns["err"].append(max_err(got, first))
        dturns["p"].append(time_ms(lambda i: parent.paged_decode(
            q, kpool[i % n_layers], vpool[i % n_layers], bt, lens, out),
            iters))

    decode_kernel_turn()
    decode_parent_turn()
    plain_ms, _ = time_ms(lambda i: ops.paged_decode_attention(
        q, kpool[i % n_layers], vpool[i % n_layers], bt, lens,
        use_kernel=False), max(iters // 4, 10))
    # library yardstick: SDPA over K/V pre-gathered to (B, Hkv, S, D)
    s_max = int(lens.max())
    ctx_pages = -(-s_max // page)
    kg = [ops.gather_kv_pages(kpool[i], bt[:, :ctx_pages])[:, :s_max]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    vg = [ops.gather_kv_pages(vpool[i], bt[:, :ctx_pages])[:, :s_max]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    mask = (torch.arange(s_max, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qt = q.transpose(1, 2)
    sdpa_decode = _merge_sdpa([sdpa_by_backend(lambda gqa: _paged_sdpa_ms(
        qt, kg, vg, mask, gqa, iters)) for _ in range(2)])
    del kg, vg
    decode_parent_turn()
    decode_kernel_turn()
    n_keys = int(lens.sum())
    flops, nbytes = W.paged_work(q.numel(), bt.numel(), lens.numel(), n_keys,
                                 n_keys, hq, hkv, d, q.element_size())
    ms, eager_ms = (sum(t[i] for t in dturns["k"]) / 2 for i in (0, 1))
    decode = _with_library(_row(
        "paged_decode" + tag, "src/repro_torch/csrc/paged_decode.cu",
        "src/repro/kernels/attention/attention.py:371", err_decode, ms,
        eager_ms, plain_ms, None, nbytes, flops, dtype), sdpa_decode)
    decode["ms_turns"] = [t[0] for t in dturns["k"]]
    before = K.paged_flash_decode.variants.copy()
    K.paged_flash_decode(q, kpool[0], vpool[0], bt, lens, scale=scale)
    (decode["variant"],) = K.paged_flash_decode.variants - before
    if parent is not None:
        decode["parent_ms"] = sum(t[0] for t in dturns["p"]) / 2
        decode["parent_ms_turns"] = [t[0] for t in dturns["p"]]
        decode["parent_max_abs_err"] = max(dturns["err"])
    rows.append(decode)

    # ---- prefill: one 64-token chunk at start 960 of a ~1000-token prompt
    c, start, width = 64, 960, 16
    row = perm[:width].to(torch.int32).contiguous()
    err_prefill = 0.0
    qc = torch.randn(1, c, hq, d, generator=gen, device=dev).to(dtype)
    for kw in ({}, {"window": 300}, {"logit_cap": 30.0}):
        err = max_err(K.paged_flash_prefill(qc, kpool[0], vpool[0], row,
                                            start, scale=scale, **kw),
                      ops.paged_prefill_attention(qc, kpool[0], vpool[0],
                                                  row, start,
                                                  use_kernel=False, **kw))
        assert err <= ATOL[dtype], ("paged_prefill", kw, err)
        err_prefill = max(err_prefill, err)
    qc = torch.randn(1, c, hq, d, generator=gen, device=dev).to(dtype)
    # the calls take turns on the card: kernel, parent kernel (given
    # ``parent``), SDPA (below), parent, kernel
    turns = collections.defaultdict(list)

    def kernel_turn():
        turns["k"].append(time_ms(lambda i: K.paged_flash_prefill(
            qc, kpool[i % n_layers], vpool[i % n_layers], row, start,
            scale=scale), iters))

    def parent_turn():
        if parent is None:
            return
        scratch = parent.prefill_scratch(qc, kpool[0], width, start)
        got = parent.paged_prefill(qc, kpool[0], vpool[0], row, start,
                                   scratch)
        turns["err"].append(max_err(got, K.paged_flash_prefill(
            qc, kpool[0], vpool[0], row, start, scale=scale)))
        turns["p"].append(time_ms(lambda i: parent.paged_prefill(
            qc, kpool[i % n_layers], vpool[i % n_layers], row, start,
            scratch), iters))

    kernel_turn()
    parent_turn()
    plain_ms, _ = time_ms(lambda i: ops.paged_prefill_attention(
        qc, kpool[i % n_layers], vpool[i % n_layers], row, start,
        use_kernel=False), max(iters // 4, 10))
    s_ctx = start + c
    kg = [ops.gather_kv_pages(kpool[i], row[None])[:, :s_ctx]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    vg = [ops.gather_kv_pages(vpool[i], row[None])[:, :s_ctx]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    q_pos = start + torch.arange(c, device=dev)[:, None]
    cmask = q_pos >= torch.arange(s_ctx, device=dev)[None, :]
    qt = qc.transpose(1, 2)
    sdpa_prefill = sdpa_by_backend(lambda gqa: _paged_sdpa_ms(
        qt, kg, vg, cmask, gqa, iters))
    parent_turn()
    kernel_turn()
    before = K.paged_flash_prefill.variants.copy()
    K.paged_flash_prefill(qc, kpool[0], vpool[0], row, start, scale=scale)
    (variant,) = K.paged_flash_prefill.variants - before
    del kg, vg, kpool, vpool
    pairs = int(cmask.sum())
    flops, nbytes = W.paged_work(qc.numel(), row.numel(), 0, s_ctx, pairs,
                                 hq, hkv, d, qc.element_size())
    ms, eager_ms = (sum(t[i] for t in turns["k"]) / 2 for i in (0, 1))
    prefill = _with_library(_row(
        "paged_prefill" + tag, "src/repro_torch/csrc/paged_prefill.cu",
        "src/repro/kernels/attention/attention.py:172", err_prefill, ms,
        eager_ms, plain_ms, None, nbytes, flops, dtype), sdpa_prefill)
    prefill["ms_turns"] = [t[0] for t in turns["k"]]
    prefill["variant"] = variant
    if parent is not None:
        prefill["parent_ms"] = sum(t[0] for t in turns["p"]) / 2
        prefill["parent_ms_turns"] = [t[0] for t in turns["p"]]
        prefill["parent_max_abs_err"] = max(turns["err"])
    rows.append(prefill)
    return rows


def _paged_sdpa_ms(qt, kg, vg, mask, gqa: bool, iters: int) -> float:
    """SDPA over the layers' pre-gathered (B, Hkv, S, D) caches in turn,
    one CUDA-graph replay of ``iters`` calls; without ``gqa`` on caches
    expanded to the query heads first (untimed)."""
    if not gqa:
        g = qt.shape[1] // kg[0].shape[1]
        kg = [t.repeat_interleave(g, 1) for t in kg]
        vg = [t.repeat_interleave(g, 1) for t in vg]
    n = len(kg)
    ms, _ = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, kg[i % n], vg[i % n], attn_mask=mask, enable_gqa=gqa), iters)
    return ms


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over max(1, max |want|): gradients sum over up to S
    positions, so their scale grows with the sequence."""
    return max_err(got, want) / max(1.0, want.float().abs().max().item())


def _own_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over max |want|, with no floor: a gradient whose
    entries all lie well below 1 (a cross-attention's dK and dV) is held
    to its own scale, so that a kernel off by a few percent everywhere
    fails."""
    return max_err(got, want) / want.float().abs().max().item()


def check_flash_small(gen: torch.Generator) -> dict[str, float]:
    """The dense flash kernels against the plain versions (``attention_ref``
    and its autograd gradient) on small geometries: G in {1, 2, 6, 8} (6
    leaves rows of the wgmma kernels' 128 unused), D in {16, 64, 128, 256}
    (bf16: 16 takes the CUDA-core kernels, 64 and 128 the wgmma ones, 256
    the D-256 wgmma ones), S a multiple of the tiles (128) and not (77),
    causal and not, a window, a softcap, f32 and bf16.  Errors are
    relative to max(1, max |plain|) (FLASH_TOL)."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ref

    dev = "cuda"
    worst = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    cases = itertools.product(
        (torch.float32, torch.bfloat16), (1, 2, 6, 8), (16, 64, 128, 256),
        (128, 77),
        ({"causal": True}, {"causal": False}, {"causal": True, "window": 9},
         {"causal": True, "logit_cap": 5.0},
         {"causal": False, "window": 20, "logit_cap": 30.0}))
    for dtype, g, d, s, kw in cases:
        b, hkv = 2, 2
        q, k, v, d_o = (torch.randn(b, s, h, d, generator=gen, device=dev)
                        .to(dtype) for h in (hkv * g, hkv, hkv, hkv * g))
        o, lse = K._flash_fwd(q, k, v, causal=kw["causal"],
                              window=kw.get("window"),
                              logit_cap=kw.get("logit_cap"))
        grads = K.flash_attention_bwd(q, k, v, o, lse, d_o, **kw)
        tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
        want_o = ref.attention_ref(*tr[:3], **kw).transpose(1, 2)
        want_g = [t.transpose(1, 2) for t in
                  ref.attention_ref_grad(*tr, **kw)]
        err_f = _rel_err(o, want_o)
        err_b = max(_rel_err(a, w) for a, w in zip(grads, want_g))
        case = (str(dtype), g, d, s, kw)
        assert err_f <= FLASH_TOL[dtype], ("flash_attention", case, err_f)
        assert err_b <= FLASH_TOL[dtype], ("flash_attention_bwd", case, err_b)
        worst["flash_attention"] = max(worst["flash_attention"], err_f)
        worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"],
                                           err_b)
    return worst


def _events_loop_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    return _events_ms(lambda: [fn() for _ in range(iters)], iters)


class ParentKernels:
    """The parent commit's kernels, built from its sources in ``src``, a
    directory outside the committed tree: the dense flash pair
    (``flash_fwd.cu``, ``flash_bwd.cu``), paged prefill
    (``paged_prefill.cu``), the matmul (``matmul.cu``), paged decode
    (``paged_decode.cu``), MLA latent prefill and decode
    (``paged_latent_prefill.cu``, ``paged_latent_decode.cu``) and the LCS
    tile (``lcs_tile.cu``), with their headers, into
    ``build/parent_kernels/``, so that the benches time them in the same
    call as the current kernels.  Their C interfaces are the parent's: the
    flash pair's (Sq and Sk apart in both), ``matmul``'s, ``matmul_plan``'s
    and paged decode's are the current ones (the decode one launch, no
    scratch; float32 products go through ``matmul_tf32x3`` and
    ``matmul_plan_tf32x3`` where the parent has them, else through
    ``matmul`` and ``matmul_plan`` as CUDA-core variant 0);
    prefill's split count takes (width, page, start, C), latent prefill's
    (dtype, kv_lora, qk_rope, width, page, C, H, start) and latent
    decode's (width, page, B, H), and these three take f32 split scratch;
    so do the verify entries of the prefill libraries (``paged_verify``,
    its split count (width, page); ``paged_latent_verify``, its split
    count (dtype, kv_lora, qk_rope, width, page, B, W, H));
    the LCS kernel takes a whole table in one launch (``lcs_table``) over
    the int32 state ``kernels.lcs`` lays out.  Where the parent's flash
    pair has the key-block entries (``flash_fwd_block``,
    ``flash_bwd_block``) they are bound too, and ``flash_libraries`` lets
    the wrappers run a model step through the parent's pair."""

    NAMES = ("flash_fwd", "flash_bwd", "paged_prefill", "matmul",
             "paged_decode", "paged_latent_prefill", "paged_latent_decode",
             "lcs_tile")

    def __init__(self, src: Path):
        import ctypes

        from repro_torch.kernels import build

        out = build.BUILD_DIR.parent / "parent_kernels"
        out.mkdir(parents=True, exist_ok=True)
        # the headers' namespaces renamed, so that no C++ symbol of a
        # parent library (inline and template ones are weak) can bind to
        # the current libraries' of the same name
        rename = [f"-D{ns}=parent_{ns}"
                  for ns in ("paged", "flash_mma", "flash_wgmma", "latent",
                             "latent_wgmma", "flash_tf32", "tf32x3")]
        procs = [(name, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *rename, "-o",
             str(out / f"lib{name}.so"), str(src / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for name in self.NAMES]
        libs = {}
        for name, proc in procs:
            text, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"parent {name}.cu did not build:\n{text}")
            libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
        self.paths = {name: str(out / f"lib{name}.so") for name in libs}
        self.libs = libs
        P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
        self.fwd = libs["flash_fwd"].flash_fwd
        self.fwd.argtypes = [I, P, P, P, P, P, I, I, I, I, I, I, F, I, I, F,
                             P]
        self.bwd = libs["flash_bwd"].flash_bwd
        self.bwd.argtypes = [I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                             I, F, I, I, F, P]
        # the entries at a fixed rank count, where the parent's libraries
        # have the split family (its chooser would split some of the
        # parity cases, which the current pair runs at one rank)
        self.fwd_split = getattr(libs["flash_fwd"], "flash_fwd_split", None)
        self.bwd_split = getattr(libs["flash_bwd"], "flash_bwd_split", None)
        if self.fwd_split is not None:
            self.fwd_split.argtypes = [I, *self.fwd.argtypes]
            self.bwd_split.argtypes = [I, *self.bwd.argtypes]
            self.fwd_split.restype = self.bwd_split.restype = I
        # the float32 family's entries (f32 at D 64 and 128, with a
        # workspace), where the parent's libraries have them
        self.fwd_tf32 = getattr(libs["flash_fwd"], "flash_fwd_tf32x3", None)
        self.bwd_tf32 = getattr(libs["flash_bwd"], "flash_bwd_tf32x3", None)
        if self.fwd_tf32 is not None:
            from repro_torch.kernels.attention import attention as K
            self.fwd_tf32.argtypes = list(K._FWD_TF32X3)
            self.bwd_tf32.argtypes = list(K._BWD_TF32X3)
            self.fwd_tf32.restype = self.bwd_tf32.restype = I
            self.tf32_ws = {}
            for lib in ("flash_fwd", "flash_bwd"):
                fn = getattr(libs[lib], f"{lib}_tf32x3_ws_floats")
                fn.argtypes, fn.restype = [I] * 6, L
                self.tf32_ws[lib] = fn
        # the key-block entries, where the parent's libraries have them
        self.fwd_block = getattr(libs["flash_fwd"], "flash_fwd_block", None)
        self.bwd_block = getattr(libs["flash_bwd"], "flash_bwd_block", None)
        if self.fwd_block is not None:
            self.fwd_block.argtypes = [I, P, P, P, P, P, I, I, I, I, I, I, F,
                                       I, I, F, I, P]
            self.fwd_block.restype = I
        if self.bwd_block is not None:
            self.bwd_block.argtypes = [I, P, P, P, P, P, P, P, P, P, P, I, I,
                                       I, I, I, I, F, I, I, F, I, P]
            self.bwd_block.restype = I
        self.prefill = libs["paged_prefill"].paged_prefill
        self.prefill.argtypes = [I, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                 I, F, I, F, P]
        self.prefill_splits = libs["paged_prefill"].paged_prefill_splits
        self.prefill_splits.argtypes = [I, I, I, I]
        self.mm = libs["matmul"].matmul
        self.mm.argtypes = [I, P, P, P, I, I, I, L, L, P]
        self.mm_plan = libs["matmul"].matmul_plan
        self.mm_plan.argtypes = [I, I, P, P, P, P, P, P, P, P, P, I, I, I, I,
                                 I, L, L, P]
        self.mm_plan.restype = I
        # the float32 entries on the tensor cores, where the parent has them
        self.mm_tf32 = getattr(libs["matmul"], "matmul_tf32x3", None)
        self.mm_plan_tf32 = getattr(libs["matmul"], "matmul_plan_tf32x3",
                                    None)
        if self.mm_tf32 is not None:
            self.mm_tf32.argtypes = [P, P, P, P, L, I, I, I, L, L, P]
            self.mm_tf32.restype = I
            self.mm_plan_tf32.argtypes = [P, P, P, P, P, L, P, P, P, P, P, I,
                                          I, I, I, I, L, L, P]
            self.mm_plan_tf32.restype = I
            self.mm_ws = libs["matmul"].matmul_tf32x3_ws_floats
            self.mm_ws.argtypes = [I, I, I, L, P]
            self.mm_ws.restype = L
        self.decode = libs["paged_decode"].paged_decode
        self.decode.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, I, F,
                                I, F, P]
        lat = libs["paged_latent_prefill"]
        self.latent = lat.paged_latent_prefill
        self.latent.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                I, I, F, P]
        self.latent_splits = lat.paged_latent_prefill_splits
        self.latent_splits.argtypes = [I] * 8
        self.verify = libs["paged_prefill"].paged_verify
        self.verify.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                I, I, F, I, F, P]
        self.verify_splits = libs["paged_prefill"].paged_verify_splits
        self.verify_splits.argtypes = [I, I]
        self.latent_verify = lat.paged_latent_verify
        self.latent_verify.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I,
                                       I, I, I, I, I, F, P]
        self.latent_verify_splits = lat.paged_latent_verify_splits
        self.latent_verify_splits.argtypes = [I] * 8
        ldec = libs["paged_latent_decode"]
        self.latent_dec = ldec.paged_latent_decode
        self.latent_dec.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I,
                                    I, I, I, F, P]
        self.latent_dec_splits = ldec.paged_latent_decode_splits
        self.latent_dec_splits.argtypes = [I, I, I, I]
        self.lcs_tab = libs["lcs_tile"].lcs_table
        self.lcs_tab.argtypes = [P, P, P, I, I, I, I, P]
        for fn in (self.fwd, self.bwd, self.prefill, self.prefill_splits,
                   self.mm, self.decode, self.latent, self.latent_splits,
                   self.latent_dec, self.latent_dec_splits, self.lcs_tab,
                   self.verify, self.verify_splits, self.latent_verify,
                   self.latent_verify_splits):
            fn.restype = I

    def _tf32(self, q) -> bool:
        """Whether the parent runs this call on its float32 family."""
        return (self.fwd_tf32 is not None and q.dtype == torch.float32
                and q.shape[3] in (64, 128))

    def _tf32_ws(self, lib, q, k) -> torch.Tensor:
        b, sq, hq, d = q.shape
        return torch.empty(self.tf32_ws[lib](d, b, sq, k.shape[1], hq,
                                             k.shape[2]), device=q.device)

    def forward(self, q, k, v, o, lse, causal=True, logit_cap=None,
                ranks=None) -> None:
        """No window; q's dtype, Sq and Sk from the shapes; ``ranks`` set:
        the parent's rank count fixed there (``flash_fwd_split``, where it
        has one)."""
        b, sq, hq, d = q.shape
        if self._tf32(q):
            from repro_torch.kernels.attention import attention as K
            err = K._fwd_tf32x3(q, k, v, o, lse, self._tf32_ws("flash_fwd",
                                                               q, k),
                                0, causal, 2 ** 31 - 1, logit_cap or 0.0, 0,
                                fn=self.fwd_tf32)
            assert err == 0, ("parent flash_fwd_tf32x3", err)
            return
        fwd = self.fwd
        if ranks is not None and self.fwd_split is not None:
            fwd = functools.partial(self.fwd_split, ranks)
        err = fwd(int(q.dtype == torch.bfloat16), q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       lse.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], d,
                       1 / math.sqrt(d), int(causal), 2 ** 31 - 1,
                       logit_cap or 0.0,
                       torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent flash_fwd", err)

    def backward(self, q, k, v, o, lse, d_o, delta, dq, dk, dv,
                 causal=True, logit_cap=None, ranks=None) -> None:
        """No window; q's dtype, Sq and Sk from the shapes; ``ranks`` as
        ``forward`` (``flash_bwd_split``)."""
        b, sq, hq, d = q.shape
        if self._tf32(q):
            from repro_torch.kernels.attention import attention as K
            err = K._bwd_tf32x3(q, k, v, o, lse, d_o, delta, dq, dk, dv,
                                self._tf32_ws("flash_bwd", q, k), 0, causal,
                                2 ** 31 - 1, logit_cap or 0.0, 0,
                                fn=self.bwd_tf32)
            assert err == 0, ("parent flash_bwd_tf32x3", err)
            return
        bwd = self.bwd
        if ranks is not None and self.bwd_split is not None:
            bwd = functools.partial(self.bwd_split, ranks)
        err = bwd(int(q.dtype == torch.bfloat16), q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       d_o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq,
                       k.shape[1], hq, k.shape[2], d, 1 / math.sqrt(d),
                       int(causal), 2 ** 31 - 1, logit_cap or 0.0,
                       torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent flash_bwd", err)

    def forward_block(self, q, k, v, o, lse, k_off, causal=True,
                      window=None, logit_cap=None) -> None:
        """The parent's ``flash_fwd_block``: o (B, Sq, Hq, D) f32."""
        b, sq, hq, d = q.shape
        err = self.fwd_block(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, sq, k.shape[1],
            hq, k.shape[2], d, 1 / math.sqrt(d), int(causal),
            2 ** 31 - 1 if window is None else window, logit_cap or 0.0,
            k_off, torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent flash_fwd_block", err)

    def backward_block(self, q, k, v, o, lse, d_o, delta, dq, dk, dv, k_off,
                       causal=True, window=None, logit_cap=None) -> None:
        """The parent's ``flash_bwd_block``: dq (B, Sq, Hq, D) f32."""
        b, sq, hq, d = q.shape
        err = self.bwd_block(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), d_o.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
            sq, k.shape[1], hq, k.shape[2], d, 1 / math.sqrt(d), int(causal),
            2 ** 31 - 1 if window is None else window, logit_cap or 0.0,
            k_off, torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent flash_bwd_block", err)

    @contextlib.contextmanager
    def flash_libraries(self):
        """Inside the block the wrappers of kernels 5 and 5b
        (``kernels.attention``) call the parent's flash libraries instead
        of the current ones, launch counts and all (their variants as the
        parent names them): a model step timed through the parent's
        kernels."""
        from repro_torch.kernels.attention import attention as K
        from repro_torch.kernels.build import LIBS, c_function

        saved = {n: LIBS.get(n) for n in ("flash_fwd", "flash_bwd")}
        ranks = K._flash_ranks
        try:
            for n in saved:
                LIBS._libs[n] = self.libs[n]
            c_function.cache_clear()
            if not hasattr(self.libs["flash_fwd"], "flash_fwd_ranks"):
                # a parent without the split family names none
                K._flash_ranks = lambda *a: 1
            yield
        finally:
            LIBS._libs.update(saved)
            c_function.cache_clear()
            K._flash_ranks = ranks

    def prefill_scratch(self, q, k_pages, width, start):
        """The output and f32 split scratch of the parent's prefill."""
        _, c, hq, d = q.shape
        n_split = self.prefill_splits(width, k_pages.shape[1], start, c)
        return (torch.empty_like(q),
                torch.empty((n_split, c * hq, d), device=q.device),
                torch.empty((n_split, c * hq, 2), device=q.device))

    def paged_prefill(self, q, k_pages, v_pages, row, start, scratch
                      ) -> torch.Tensor:
        """bf16, no window or softcap: the serving shape's call."""
        _, c, hq, d = q.shape
        n_pool, page, hkv, _ = k_pages.shape
        out, acc, ml = scratch
        err = self.prefill(1, q.data_ptr(), k_pages.data_ptr(),
                           v_pages.data_ptr(), row.data_ptr(),
                           out.data_ptr(), acc.data_ptr(), ml.data_ptr(), c,
                           hq, hkv, d, page, row.shape[0], n_pool, start,
                           1 / math.sqrt(d), 2 ** 31 - 1, 0.0,
                           torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent paged_prefill", err)
        return out

    def paged_decode(self, q, k_pages, v_pages, tables, lengths, out
                     ) -> torch.Tensor:
        """bf16, no window or softcap: the serving shape's call."""
        b, _, hq, d = q.shape
        n_pool, page, hkv, _ = k_pages.shape
        err = self.decode(1, q.data_ptr(), k_pages.data_ptr(),
                          v_pages.data_ptr(), tables.data_ptr(),
                          lengths.data_ptr(), out.data_ptr(), b, hkv,
                          hq // hkv, d, page, tables.shape[1], n_pool,
                          1 / math.sqrt(d), 2 ** 31 - 1, 0.0,
                          torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent paged_decode", err)
        return out

    def latent_scratch(self, q_lat, q_rope, ckv, width, start):
        """The output and f32 split scratch of the parent's latent
        prefill."""
        _, c, h, kv = q_lat.shape
        n_split = self.latent_splits(1, kv, q_rope.shape[-1], width,
                                     ckv.shape[1], c, h, start)
        return (torch.empty_like(q_lat),
                torch.empty((n_split, c * h, kv), device=q_lat.device),
                torch.empty((n_split, c * h, 2), device=q_lat.device))

    def paged_latent_prefill(self, q_lat, q_rope, ckv, kr, row, start,
                             scale, scratch) -> torch.Tensor:
        """bf16: the serving shape's call."""
        _, c, h, kv = q_lat.shape
        n_pool, page, _ = ckv.shape
        out, acc, ml = scratch
        err = self.latent(1, q_lat.data_ptr(), q_rope.data_ptr(),
                          ckv.data_ptr(), kr.data_ptr(), row.data_ptr(),
                          out.data_ptr(), acc.data_ptr(), ml.data_ptr(), c, h,
                          kv, q_rope.shape[-1], page, row.shape[0], n_pool,
                          start, scale,
                          torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent paged_latent_prefill", err)
        return out

    def verify_scratch(self, q, width, page):
        """The output and f32 split scratch of the parent's verify."""
        b, w, hq, d = q.shape
        n_split = self.verify_splits(width, page)
        return (torch.empty_like(q),
                torch.empty((n_split, b * w * hq, d), device=q.device),
                torch.empty((n_split, b * w * hq, 2), device=q.device))

    def paged_verify(self, q, k_pages, v_pages, tables, lengths, scratch
                     ) -> torch.Tensor:
        """bf16, no window or softcap: the serving shape's call (its
        launch and, split, the merge kernel's)."""
        b, w, hq, d = q.shape
        n_pool, page, hkv, _ = k_pages.shape
        out, acc, ml = scratch
        err = self.verify(1, q.data_ptr(), k_pages.data_ptr(),
                          v_pages.data_ptr(), tables.data_ptr(),
                          lengths.data_ptr(), out.data_ptr(), acc.data_ptr(),
                          ml.data_ptr(), b, w, hq, hkv, d, page,
                          tables.shape[1], n_pool, 1 / math.sqrt(d),
                          2 ** 31 - 1, 0.0,
                          torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent paged_verify", err)
        return out

    def latent_verify_scratch(self, q_lat, q_rope, ckv, width):
        """The output and f32 split scratch of the parent's latent
        verify."""
        b, w, h, kv = q_lat.shape
        n_split = self.latent_verify_splits(1, kv, q_rope.shape[-1], width,
                                            ckv.shape[1], b, w, h)
        return (torch.empty_like(q_lat),
                torch.empty((n_split, b * w * h, kv), device=q_lat.device),
                torch.empty((n_split, b * w * h, 2), device=q_lat.device))

    def paged_latent_verify(self, q_lat, q_rope, ckv, kr, tables, lengths,
                            scale, scratch) -> torch.Tensor:
        """bf16: the serving shape's call (its launch and, split, the
        merge kernel's)."""
        b, w, h, kv = q_lat.shape
        n_pool, page, _ = ckv.shape
        out, acc, ml = scratch
        err = self.latent_verify(1, q_lat.data_ptr(), q_rope.data_ptr(),
                                 ckv.data_ptr(), kr.data_ptr(),
                                 tables.data_ptr(), lengths.data_ptr(),
                                 out.data_ptr(), acc.data_ptr(),
                                 ml.data_ptr(), b, w, h, kv,
                                 q_rope.shape[-1], page, tables.shape[1],
                                 n_pool, scale,
                                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent paged_latent_verify", err)
        return out

    def latent_decode_scratch(self, q_lat, ckv, width):
        """The output and f32 split scratch of the parent's latent
        decode."""
        b, _, h, kv = q_lat.shape
        n_split = self.latent_dec_splits(width, ckv.shape[1], b, h)
        return (torch.empty_like(q_lat),
                torch.empty((n_split, b * h, kv), device=q_lat.device),
                torch.empty((n_split, b * h, 2), device=q_lat.device))

    def paged_latent_decode(self, q_lat, q_rope, ckv, kr, tables, lengths,
                            scale, scratch) -> torch.Tensor:
        """bf16: the serving shape's call (its launch and, split, the
        merge kernel's)."""
        b, _, h, kv = q_lat.shape
        n_pool, page, _ = ckv.shape
        out, acc, ml = scratch
        err = self.latent_dec(1, q_lat.data_ptr(), q_rope.data_ptr(),
                              ckv.data_ptr(), kr.data_ptr(),
                              tables.data_ptr(), lengths.data_ptr(),
                              out.data_ptr(), acc.data_ptr(), ml.data_ptr(),
                              b, h, kv, q_rope.shape[-1], page,
                              tables.shape[1], n_pool, scale,
                              torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent paged_latent_decode", err)
        return out

    def lcs(self, s, t, tile) -> torch.Tensor:
        """The parent's whole LCS table of s against t in tile x tile
        tiles, one launch on zero borders; returns the LCS length (0-d
        int32)."""
        from repro_torch.kernels.lcs.lcs import _state

        m, n = s.shape[0], t.shape[0]
        zeros = [torch.zeros(k, dtype=torch.int32, device=s.device)
                 for k in (n, m, 1)]
        state = _state(*zeros, tile, -(-m // tile), -(-n // tile))
        err = self.lcs_tab(s.data_ptr(), t.data_ptr(), state.data_ptr(), m,
                           n, tile, tile,
                           torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("parent lcs_table", err)
        return state[n - 1]

    def _split(self, a, n, m, k, lda):
        """The parent's float32 workspace, where it has the TF32 entries."""
        return torch.empty(max(self.mm_ws(n, m, k, lda, a.data_ptr()), 4),
                           dtype=torch.float32, device=a.device)

    def matmul(self, a, b, out) -> None:
        """One product of views with unit column stride into ``out``."""
        n, k = a.shape
        m = b.shape[1]
        lda = a.stride(0) if n > 1 else max(k, 1)
        ldb = b.stride(0) if k > 1 else max(m, 1)
        stream = torch.cuda.current_stream().cuda_stream
        if a.dtype == torch.float32 and self.mm_tf32 is not None:
            split = self._split(a, n, m, k, lda)
            err = self.mm_tf32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               split.data_ptr(), split.numel(), n, m, k, lda,
                               ldb, stream)
        else:
            err = self.mm(1 if a.dtype == torch.bfloat16 else 0, a.data_ptr(),
                          b.data_ptr(), out.data_ptr(), n, m, k, lda, ldb,
                          stream)
        assert err == 0, ("parent matmul", err)

    def matmul_plan(self, a, b, plan) -> torch.Tensor:
        """The parent's one-launch plan walk (and its k-cut sums) on
        contiguous a and b, over the current wrapper's tables (their layout
        is the parent's); bf16 as the parent's TMA variant (2), float32 as
        its ``matmul_plan_tf32x3`` or else its CUDA-core variant (0)."""
        from repro_torch.kernels.matmul.matmul import _device_table
        n, k = a.shape
        m = b.shape[1]
        table = _device_table(plan, a.device)
        out = torch.empty((n, m), dtype=a.dtype, device=a.device)
        ws = torch.empty(max(table.host.ws_elems, 8), dtype=a.dtype,
                         device=a.device)
        p_off, p_cub, p_cell, p_mem = table.ptrs
        tables = (p_off, p_cub, table.ws_off.data_ptr(), p_cell, p_mem,
                  table.host.n_ctas, len(table.host.cell), n, m, k, k, m,
                  torch.cuda.current_stream().cuda_stream)
        if a.dtype == torch.float32 and self.mm_plan_tf32 is not None:
            split = self._split(a, n, m, k, k)
            err = self.mm_plan_tf32(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), ws.data_ptr(),
                                    split.data_ptr(), split.numel(), *tables)
        else:
            bf16 = a.dtype == torch.bfloat16
            err = self.mm_plan(int(bf16), 2 if bf16 else 0, a.data_ptr(),
                               b.data_ptr(), out.data_ptr(), ws.data_ptr(),
                               *tables)
        assert err == 0, ("parent matmul_plan", err)
        return out


# The dense flash pair's rows, bf16: {row-name suffix: (B, Hq, Hkv, Sq, Sk,
# D, causal)}.  The training shape of full-width qwen3-0.6b (rows 5, 5b);
# seamless-m4t-medium's cross-attention, Sq 256 target positions against
# Sk 1024 source frames, no mask (5x, 5bx), and its decoder's causal
# self-attention at S 256 (5t, 5bt); zamba2-7b's shared block
# (5@112, 5b@112); gemma2-2b's attention (Hq 8, Hkv 4, D 256) at B 2 x S
# 4096, causal, its scores capped at 50 as the model caps them (5@256,
# 5b@256; FLASH_CAPS).
FLASH_TRAIN_SHAPE = {"": (TRAIN_BATCH, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 128,
                          True)}
FLASH_OWN_SHAPES = {"_cross": (2, 16, 16, 256, 1024, 64, False),
                    "_self": (2, 16, 16, 256, 256, 64, True),
                    "_d112": (1, 32, 32, 2048, 2048, 112, True),
                    "_d256": (2, 8, 4, 4096, 4096, 256, True)}
# The pair's float32 family (the CUDA cores) at row 5's shape and at
# seamless's cross-attention (rows 5f, 5bf), timed like the bf16 rows with
# fewer calls a turn: its bound is three TF32 products on the tensor cores
# (``bound_ms``), one f32 product on the CUDA cores beside it
# (``bound_cuda_cores_ms``), as rows 6f-6l give them
FLASH_F32_SHAPES = {"_f32": (TRAIN_BATCH, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 128,
                             True),
                    "_cross_f32": (2, 16, 16, 256, 1024, 64, False)}
FLASH_F32_ITERS = 5
# The softcap of a row's kernels and plain versions: gemma2-2b's
# softcap_attn.  SDPA has no softcap, so its rows' library time stays
# uncapped.
FLASH_CAPS = {"_d256": 50.0}


def bench_flash(shapes: dict, gen: torch.Generator, iters: int,
                parent: ParentKernels | None = None,
                dtype: torch.dtype = torch.bfloat16) -> list[dict]:
    """The dense flash pair at each of ``shapes`` (``FLASH_TRAIN_SHAPE``,
    ``FLASH_OWN_SHAPES``; ``FLASH_F32_SHAPES`` with ``dtype`` float32), in
    ``dtype``, each under the family ``_flash_family`` names for its shape
    (``cluster`` where the items fill few processors: the row's
    ``variant`` and ``ranks``): checked against the plain versions, the
    backward bitwise equal over two calls, each with its row's softcap
    (``FLASH_CAPS``; none by default) (O within FLASH_TOL of
    max(1, max |plain|), each of dQ, dK and dV of its own max |plain|),
    then timed.  Kernel times are
    CUDA-graph replays of ``iters`` calls; the plain versions and SDPA
    (forward, and its backward alone through autograd with the graph
    retained) are timed eagerly with CUDA events: their calls take
    milliseconds, so launch cost is noise.  SDPA runs under each backend in
    turn (``sdpa_by_backend``), the fastest being ``library_ms``.  The
    calls take turns on the card, in positions that balance: kernels,
    parent kernels (when ``parent`` is given), SDPA, parent, kernels,
    kernels, parent, SDPA, parent, kernels; each kernel time is the mean
    of its four turns (on an H100 the mean of two moved by up to 5%
    between calls), SDPA's of its two.
    Bounds: operations, the forward's 4 B Hq D flops a visible (query, key)
    pair and the backward's 2.5 times that (the five products a gradient
    needs), in float32 three TF32 passes of each at 495 TFLOP/s (one
    f32 pass at 67 as ``bound_cuda_cores_ms``), against bytes: the
    forward's q, k, v, o and log-sum-exp once each, the backward's q, k,
    v, o, dO and log-sum-exp in and dq, dk, dv out."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for tag, (b, hq, hkv, sq, sk, d, causal) in shapes.items():
        cap = FLASH_CAPS.get(tag)
        q, d_o = (torch.randn(b, sq, hq, d, generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        k, v = (torch.randn(b, sk, hkv, d, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        o, lse = K._flash_fwd(q, k, v, causal=causal, window=None,
                              logit_cap=cap)
        grads = K.flash_attention_bwd(q, k, v, o, lse, d_o, causal=causal,
                                      logit_cap=cap)
        again = K.flash_attention_bwd(q, k, v, o, lse, d_o, causal=causal,
                                      logit_cap=cap)
        assert all(torch.equal(a, c) for a, c in zip(grads, again)), \
            ("flash_attention_bwd is not bitwise reproducible", tag)
        del again
        tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
        err_f = max_err(o, ref.attention_ref(*tr[:3], causal=causal,
                                             logit_cap=cap).transpose(1, 2))
        err_b = max(_own_rel_err(a, w.transpose(1, 2)) for a, w in zip(
            grads, ref.attention_ref_grad(*tr, causal=causal,
                                          logit_cap=cap)))
        assert err_f <= FLASH_TOL[dtype], ("flash_attention", tag, err_f)
        assert err_b <= FLASH_TOL[dtype], ("flash_attention_bwd", tag, err_b)
        del grads
        torch.cuda.empty_cache()
        times = collections.defaultdict(list)
        with_parent = parent is not None

        def kernels():
            times["f"].append(time_ms(lambda i: K._flash_fwd(
                q, k, v, causal=causal, window=None, logit_cap=cap), iters))
            times["b"].append(time_ms(lambda i: K.flash_attention_bwd(
                q, k, v, o, lse, d_o, causal=causal, logit_cap=cap), iters))

        def parent_kernels():
            if not with_parent:
                return
            o2, lse2, delta = (torch.empty_like(o), torch.empty_like(lse),
                               torch.empty_like(lse))
            g2 = [torch.empty_like(t) for t in (q, k, v)]
            times["pf"].append(time_ms(lambda i: parent.forward(
                q, k, v, o2, lse2, causal, cap), iters))
            times["pb"].append(time_ms(lambda i: parent.backward(
                q, k, v, o, lse, d_o, delta, *g2, causal, cap), iters))

        def kv(gqa):
            return tr[1:3] if gqa else [t.repeat_interleave(hq // hkv, 1)
                                        for t in tr[1:3]]

        def sdpa_fwd(gqa):
            kk, vv = kv(gqa)
            return _events_loop_ms(lambda: sdpa(
                tr[0], kk, vv, is_causal=causal, enable_gqa=gqa), 20)

        def sdpa_bwd(gqa):
            leaves = [t.detach().requires_grad_() for t in (tr[0], *kv(gqa))]
            out = sdpa(*leaves, is_causal=causal, enable_gqa=gqa)
            return _events_loop_ms(lambda: torch.autograd.grad(
                out, leaves, tr[3], retain_graph=True), 20)

        lib = []
        for _ in range(2):
            kernels()
            parent_kernels()
            lib.append((sdpa_by_backend(sdpa_fwd), sdpa_by_backend(sdpa_bwd)))
            parent_kernels()
            kernels()
        plain_f = _events_loop_ms(lambda: ref.attention_ref(
            *tr[:3], causal=causal, logit_cap=cap), 3)
        plain_b = _events_loop_ms(lambda: ref.attention_ref_grad(
            *tr, causal=causal, logit_cap=cap), 3)
        torch.cuda.empty_cache()
        # visible (query, key) pairs: under the causal mask query q sees
        # min(q + 1, Sk) keys
        elem = q.element_size()
        flops, nbytes_f = W.flash_fwd_work(b, sq, sk, hq, hkv, d, elem,
                                           causal=causal)
        flops_b, nbytes_b = W.flash_bwd_work(b, sq, sk, hq, hkv, d, elem,
                                             causal=causal)
        pair = []
        for key, name, src, err, nbytes, fl, lib_i, plain in (
                ("f", f"flash_attention{tag}", "flash_fwd", err_f, nbytes_f,
                 flops, 0, plain_f),
                ("b", f"flash_attention_bwd{tag}", "flash_bwd", err_b,
                 nbytes_b, flops_b, 1, plain_b)):
            turns = times[key]
            row = _with_library(_row(
                name, f"src/repro_torch/csrc/{src}.cu",
                "src/repro/kernels/attention/attention.py:72", err,
                sum(t[0] for t in turns) / len(turns),
                sum(t[1] for t in turns) / len(turns), plain, None, nbytes,
                fl, dtype), _merge_sdpa([t[lib_i] for t in lib]))
            row["ms_turns"] = [t[0] for t in turns]
            row["ranks"] = K._flash_ranks(src, dtype, b, sq, sk, hq, hkv, d,
                                          causal, 2 ** 31 - 1)
            row["variant"] = K._flash_variant(src, dtype, d, row["ranks"])
            want = _flash_family(src, dtype, b, sq, sk, hq, hkv, d, causal)
            assert row["variant"] == want, (name, row["variant"], want)
            if want == "wgmma_tf32x3":   # the family's kernels and passes
                row["source"] = "src/repro_torch/csrc/flash_tf32.cuh"
            row["shape"] = {"b": b, "hq": hq, "hkv": hkv, "sq": sq, "sk": sk,
                            "d": d, "causal": causal, "logit_cap": cap}
            if with_parent:
                pt = times["p" + key]
                row["parent_ms"] = sum(t[0] for t in pt) / len(pt)
                row["parent_ms_turns"] = [t[0] for t in pt]
            pair.append(row)
        pair[1]["fwd_bwd_ms"] = pair[0]["ms"] + pair[1]["ms"]
        pair[1]["library_fwd_bwd_ms"] = (
            None if None in (pair[0]["library_ms"], pair[1]["library_ms"])
            else pair[0]["library_ms"] + pair[1]["library_ms"])
        rows += pair
        del q, k, v, d_o, o, lse, tr
        torch.cuda.empty_cache()
    return rows


def _bound(nbytes, flops, dtype, peak=None) -> tuple[float, str]:
    """The least time of the work on the card, ms, and what sets it: the
    bytes at the HBM rate or the operations at the dtype's peak (or at
    ``peak``, flops a second)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def _row(name, source, replaces, err, ms, eager_ms, plain_ms, library_ms,
         nbytes, flops, dtype) -> dict:
    """A kernel's row; ``flops`` its products' own.  In float32 the card's
    f32-accurate product is three TF32 products on the tensor cores: the
    bound takes W.TF32_PASSES x ``flops`` at PEAK_TF32_FLOPS (the row's
    ``flops``), and ``bound_cuda_cores_ms`` one true f32 pass at
    PEAK_FLOPS[float32] beside it."""
    f32 = dtype == torch.float32
    work = W.TF32_PASSES * flops if f32 else flops
    bound_ms, bound_by = _bound(nbytes, work, dtype,
                                PEAK_TF32_FLOPS if f32 else None)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "ms": ms, "kernel_ms": ms, "eager_ms": eager_ms,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "flops": work}
    if f32:
        row["bound_cuda_cores_ms"] = _bound(nbytes, flops, dtype)[0]
    return row


def check_small_latent(gen: torch.Generator) -> dict[str, float]:
    """The MLA latent kernels on odd geometries (H = 3 and 5, prime pools,
    kv_lora 32 and 64, qk_rope 8 and 16, tables over several key splits),
    in f32 and bf16, and the wgmma prefill and decode at deepseek-v2's
    widths (blocks that straddle positions or end past H, split chunks,
    clusters of 4 ranks over lengths of 1 to past the table): kernel
    vs plain version, the wgmma ones bitwise over two calls."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ops

    dev = "cuda"
    worst = {"paged_latent_decode": 0.0, "paged_latent_prefill": 0.0}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # kv_lora 64 takes the tensor-core kernel in bf16, 32 the CUDA-core one
    for dtype, h, kv, rope in itertools.product(
            (torch.float32, torch.bfloat16), (3, 5), (32, 64), (8, 16)):
        scale = 1 / math.sqrt(kv + rope)
        for page, n_pool, width, lens in [(4, 13, 4, [5, 16, 1]),
                                          (64, 31, 8, [300, 511, 515])]:
            b = len(lens)
            bt = torch.randperm(n_pool - 1, generator=gen, device=dev)
            bt = bt[:b * width].reshape(b, width).to(torch.int32)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            args = (rnd(b, 1, h, kv, dtype=dtype),
                    rnd(b, 1, h, rope, dtype=dtype),
                    rnd(n_pool, page, kv, dtype=dtype),
                    rnd(n_pool, page, rope, dtype=dtype), bt, lens_t)
            err = max_err(K.paged_latent_decode(*args, scale=scale),
                          ops.paged_latent_decode_attention(
                              *args, scale=scale, use_kernel=False))
            assert err <= ATOL[dtype], ("paged_latent_decode", dtype, h,
                                        kv, rope, page, err)
            worst["paged_latent_decode"] = max(
                worst["paged_latent_decode"], err)
        for page, width, n_pool, c, start in [(4, 4, 13, 8, 8),
                                              (3, 3, 11, 3, 3),
                                              (5, 2, 7, 5, 5),
                                              (16, 16, 23, 24, 200)]:
            row = torch.randperm(n_pool, generator=gen, device=dev)
            row = row[:width].to(torch.int32)
            args = (rnd(1, c, h, kv, dtype=dtype),
                    rnd(1, c, h, rope, dtype=dtype),
                    rnd(n_pool, page, kv, dtype=dtype),
                    rnd(n_pool, page, rope, dtype=dtype), row)
            err = max_err(
                K.paged_latent_prefill(*args, start, scale=scale),
                ops.paged_latent_prefill_attention(
                    *args, start, scale=scale, use_kernel=False))
            assert err <= ATOL[dtype], ("paged_latent_prefill", dtype, h,
                                        kv, rope, page, err)
            worst["paged_latent_prefill"] = max(
                worst["paged_latent_prefill"], err)
    # the wgmma kernel (bf16, kv_lora 512, qk_rope 64): 64-row blocks that
    # straddle positions (H 3, 5), starts off the 64-key tile, short chunks
    # whose keys split, a partial last row block
    dtype, kv, rope = torch.bfloat16, 512, 64
    scale = 1 / math.sqrt(kv + rope)
    for h, page, width, n_pool, c, start in [(3, 64, 8, 13, 37, 200),
                                             (5, 128, 4, 7, 9, 3),
                                             (64, 64, 6, 11, 3, 301),
                                             (128, 128, 8, 11, 20, 900)]:
        row = torch.randperm(n_pool, generator=gen, device=dev)
        row = row[:width].to(torch.int32)
        args = (rnd(1, c, h, kv, dtype=dtype), rnd(1, c, h, rope, dtype=dtype),
                rnd(n_pool, page, kv, dtype=dtype),
                rnd(n_pool, page, rope, dtype=dtype), row)
        before = K.paged_latent_prefill.variants.copy()
        got = K.paged_latent_prefill(*args, start, scale=scale)
        assert K.paged_latent_prefill.variants - before == {"wgmma": 1}
        err = max_err(got, ops.paged_latent_prefill_attention(
            *args, start, scale=scale, use_kernel=False))
        assert err <= ATOL[dtype], ("paged_latent_prefill wgmma", h, page,
                                    c, start, err)
        assert torch.equal(got, K.paged_latent_prefill(*args, start,
                                                       scale=scale))
        worst["paged_latent_prefill"] = max(worst["paged_latent_prefill"],
                                            err)
    # the wgmma decode (bf16, kv_lora 512, qk_rope 64): clusters of 4 ranks
    # sharing the live keys, lengths of one tile and past the table,
    # head blocks that end past H (3, 70)
    for h, page, width, lens in [(3, 64, 8, [1, 63, 64, 65, 512, 600]),
                                 (128, 128, 4, [1, 200, 513, 129]),
                                 (70, 64, 6, [130, 384, 5])]:
        b = len(lens)
        n_pool = b * width + 1
        bt = torch.randperm(n_pool - 1, generator=gen, device=dev)
        bt = bt[:b * width].reshape(b, width).to(torch.int32)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (rnd(b, 1, h, kv, dtype=dtype), rnd(b, 1, h, rope, dtype=dtype),
                rnd(n_pool, page, kv, dtype=dtype),
                rnd(n_pool, page, rope, dtype=dtype), bt, lens_t)
        want = ops.paged_latent_decode_attention(*args, scale=scale,
                                                 use_kernel=False)
        before = K.paged_latent_decode.variants.copy()
        got = K.paged_latent_decode(*args, scale=scale)
        assert K.paged_latent_decode.variants - before == {"wgmma": 1}
        err = max_err(got, want)
        assert err <= ATOL[dtype], ("paged_latent_decode wgmma", h, page,
                                    err)
        assert torch.equal(got, K.paged_latent_decode(*args, scale=scale))
        worst["paged_latent_decode"] = max(worst["paged_latent_decode"], err)
    return worst


def bench_latent_kernels(cfg, gen: torch.Generator, iters: int,
                         parent: ParentKernels | None = None,
                         dtype: torch.dtype = torch.bfloat16) -> list[dict]:
    """The MLA latent kernels at the serving shapes of full-width
    deepseek-v2 (8 slots, contexts 48..1032, H = 128, kv_lora 512,
    qk_rope 64, page 128; prefill C = 128 at start 896): checked against
    the plain version in ``dtype``, then timed in it cycling over
    ``cfg.n_layers`` layers' pools (1.1 GB, so each call finds its layer
    outside the 50 MB L2, as serving does after the MoE's 7.5 GB of
    experts).  The prefill kernel takes turns with its parent (given
    ``parent``) and SDPA: kernel, parent, SDPA twice, parent, kernel; it
    and the parent are checked bitwise equal over two calls.  ``dtype``
    float32: rows 3f and 4f (the CUDA-core families phase 6's float32 run
    launches), named with "_f32", no parent."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ops

    dev = "cuda"
    tag = "" if dtype == torch.bfloat16 else "_f32"
    parent = parent if dtype == torch.bfloat16 else None
    m, h = cfg.mla, cfg.n_heads
    kv, rope = m.kv_lora, m.qk_rope
    scale = 1 / math.sqrt(m.qk_nope + m.qk_rope)
    slots, page, pps = 8, 128, 16
    n_pool = slots * pps + 1
    n_layers = cfg.n_layers
    rows = []

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    lens = torch.randint(48, 1000 + 32 + 1, (slots,), generator=gen,
                         device=dev, dtype=torch.int32)
    perm = torch.randperm(n_pool - 1, generator=gen, device=dev)
    bt = perm[:slots * pps].reshape(slots, pps).to(torch.int32).contiguous()
    c, start, width = 128, 896, 8
    row = perm[:width].to(torch.int32).contiguous()
    ck, kr = rnd(n_pool, page, kv, dtype=dtype), rnd(n_pool, page, rope,
                                                     dtype=dtype)
    dq = (rnd(slots, 1, h, kv, dtype=dtype),
          rnd(slots, 1, h, rope, dtype=dtype))
    pq = (rnd(1, c, h, kv, dtype=dtype), rnd(1, c, h, rope, dtype=dtype))
    err = {"paged_latent_decode": max_err(
        K.paged_latent_decode(*dq, ck, kr, bt, lens, scale=scale),
        ops.paged_latent_decode_attention(*dq, ck, kr, bt, lens,
                                          scale=scale, use_kernel=False)),
        "paged_latent_prefill": max_err(
        K.paged_latent_prefill(*pq, ck, kr, row, start, scale=scale),
        ops.paged_latent_prefill_attention(*pq, ck, kr, row, start,
                                           scale=scale, use_kernel=False))}
    assert all(e <= ATOL[dtype] for e in err.values()), err
    del ck, kr

    ckp = rnd(n_layers, n_pool, page, kv, dtype=dtype)
    krp = rnd(n_layers, n_pool, page, rope, dtype=dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q_cat, rows_table, s_ctx, mask):
        """SDPA on the latent pre-gathered per layer: one shared key of
        E = 576 and value of Ev = 512 (Hkv = 1), under each backend pinned
        in turn (``sdpa_by_backend``).  With ``enable_gqa`` it cycles over
        every layer; a backend that refuses it gets K/V expanded to the H
        query heads outside the timed region, over two layers (an expanded
        layer is H times larger, still far past the 50 MB L2)."""
        ctx_pages = -(-s_ctx // page)
        kg, vg = [], []
        for i in range(n_layers):
            ckg = ops.gather_kv_pages(ckp[i], rows_table[:, :ctx_pages])
            krg = ops.gather_kv_pages(krp[i], rows_table[:, :ctx_pages])
            kg.append(torch.cat([ckg, krg], -1)[:, None, :s_ctx]
                      .contiguous())
            vg.append(ckg[:, None, :s_ctx].contiguous())

        def run(gqa):
            ks, vs = kg, vg
            if not gqa:
                ks = [t.expand(-1, h, -1, -1).contiguous() for t in kg[:2]]
                vs = [t.expand(-1, h, -1, -1).contiguous() for t in vg[:2]]
            n = len(ks)
            ms, _ = time_ms(lambda i: sdpa(q_cat, ks[i % n], vs[i % n],
                                           attn_mask=mask, scale=scale,
                                           enable_gqa=gqa), iters)
            return ms

        return sdpa_by_backend(run)

    # ---- decode: in turns with its parent (given ``parent``) and SDPA:
    # kernel, parent, SDPA, parent, kernel; bitwise over two calls
    dq = (rnd(slots, 1, h, kv, dtype=dtype), rnd(slots, 1, h, rope,
                                                 dtype=dtype))
    dfirst = K.paged_latent_decode(*dq, ckp[0], krp[0], bt, lens,
                                   scale=scale)
    assert torch.equal(dfirst, K.paged_latent_decode(
        *dq, ckp[0], krp[0], bt, lens, scale=scale)), \
        "paged_latent_decode is not bitwise reproducible"
    dturns = collections.defaultdict(list)

    def decode_kernel_turn():
        dturns["k"].append(time_ms(lambda i: K.paged_latent_decode(
            *dq, ckp[i % n_layers], krp[i % n_layers], bt, lens,
            scale=scale), iters))

    def decode_parent_turn():
        if parent is None:
            return
        scratch = parent.latent_decode_scratch(dq[0], ckp[0], pps)
        got = parent.paged_latent_decode(*dq, ckp[0], krp[0], bt, lens,
                                         scale, scratch)
        dturns["err"].append(max_err(got, dfirst))
        dturns["p"].append(time_ms(lambda i: parent.paged_latent_decode(
            *dq, ckp[i % n_layers], krp[i % n_layers], bt, lens, scale,
            scratch), iters))

    decode_kernel_turn()
    decode_parent_turn()
    plain_ms, _ = time_ms(lambda i: ops.paged_latent_decode_attention(
        *dq, ckp[i % n_layers], krp[i % n_layers], bt, lens, scale=scale,
        use_kernel=False), max(iters // 4, 10))
    s_max = int(lens.max())
    mask = torch.arange(s_max, device=dev)[None, :] < lens[:, None]
    q_cat = torch.cat(dq, -1).transpose(1, 2)           # (B, H, 1, 576)
    sdpa_decode = library(q_cat, bt, s_max, mask[:, None, None, :])
    decode_parent_turn()
    decode_kernel_turn()
    ms, eager_ms = (sum(t[i] for t in dturns["k"]) / 2 for i in (0, 1))
    n_keys = int(lens.sum())
    flops, nbytes = W.latent_work(dq[0].numel(), dq[1].numel(), bt.numel(),
                                  lens.numel(), n_keys, n_keys, h, kv, rope,
                                  dq[0].element_size())
    decode = _with_library(_row(
        "paged_latent_decode" + tag,
        "src/repro_torch/csrc/paged_latent_decode.cu",
        "src/repro/kernels/attention/attention.py:463",
        err["paged_latent_decode"], ms, eager_ms, plain_ms, None, nbytes,
        flops, dtype), sdpa_decode)
    decode["ms_turns"] = [t[0] for t in dturns["k"]]
    before = K.paged_latent_decode.variants.copy()
    K.paged_latent_decode(*dq, ckp[0], krp[0], bt, lens, scale=scale)
    (decode["variant"],) = K.paged_latent_decode.variants - before
    if parent is not None:
        decode["parent_ms"] = sum(t[0] for t in dturns["p"]) / 2
        decode["parent_ms_turns"] = [t[0] for t in dturns["p"]]
        decode["parent_max_abs_err"] = max(dturns["err"])
    rows.append(decode)

    # ---- prefill: one 128-token chunk at start 896
    pq = (rnd(1, c, h, kv, dtype=dtype), rnd(1, c, h, rope, dtype=dtype))
    first = K.paged_latent_prefill(*pq, ckp[0], krp[0], row, start,
                                   scale=scale)
    assert torch.equal(first, K.paged_latent_prefill(
        *pq, ckp[0], krp[0], row, start, scale=scale)), \
        "paged_latent_prefill is not bitwise reproducible"
    turns = collections.defaultdict(list)

    def kernel_turn():
        turns["k"].append(time_ms(lambda i: K.paged_latent_prefill(
            *pq, ckp[i % n_layers], krp[i % n_layers], row, start,
            scale=scale), iters))

    def parent_turn():
        if parent is None:
            return
        scratch = parent.latent_scratch(*pq, ckp[0], width, start)
        got = parent.paged_latent_prefill(*pq, ckp[0], krp[0], row, start,
                                          scale, scratch).clone()
        assert torch.equal(got, parent.paged_latent_prefill(
            *pq, ckp[0], krp[0], row, start, scale, scratch)), \
            "the parent's paged_latent_prefill is not bitwise reproducible"
        turns["err"].append(max_err(got, first))
        turns["p"].append(time_ms(lambda i: parent.paged_latent_prefill(
            *pq, ckp[i % n_layers], krp[i % n_layers], row, start, scale,
            scratch), iters))

    kernel_turn()
    parent_turn()
    plain_ms, _ = time_ms(lambda i: ops.paged_latent_prefill_attention(
        *pq, ckp[i % n_layers], krp[i % n_layers], row, start, scale=scale,
        use_kernel=False), max(iters // 20, 5))
    s_ctx = start + c
    q_pos = start + torch.arange(c, device=dev)[:, None]
    cmask = q_pos >= torch.arange(s_ctx, device=dev)[None, :]
    q_cat = torch.cat(pq, -1)[0].transpose(0, 1)[None]  # (1, H, C, 576)
    sdpa_prefill = _merge_sdpa([library(q_cat, row[None], s_ctx, cmask)
                                for _ in range(2)])
    parent_turn()
    kernel_turn()
    ckv0, kr0 = ckp[0].clone(), krp[0].clone()
    del ckp, krp
    pairs = int(cmask.sum())
    flops, nbytes = W.latent_work(pq[0].numel(), pq[1].numel(), row.numel(),
                                  0, s_ctx, pairs, h, kv, rope,
                                  pq[0].element_size())
    ms, eager_ms = (sum(t[i] for t in turns["k"]) / 2 for i in (0, 1))
    prefill = _with_library(_row(
        "paged_latent_prefill" + tag,
        "src/repro_torch/csrc/paged_latent_prefill.cu",
        "src/repro/kernels/attention/attention.py:270",
        err["paged_latent_prefill"], ms, eager_ms, plain_ms, None, nbytes,
        flops, dtype), sdpa_prefill)
    prefill["ms_turns"] = [t[0] for t in turns["k"]]
    before = K.paged_latent_prefill.variants.copy()
    K.paged_latent_prefill(*pq, ckv0, kr0, row, start, scale=scale)
    (prefill["variant"],) = K.paged_latent_prefill.variants - before
    if parent is not None:
        prefill["parent_ms"] = sum(t[0] for t in turns["p"]) / 2
        prefill["parent_ms_turns"] = [t[0] for t in turns["p"]]
        prefill["parent_max_abs_err"] = max(turns["err"])
    rows.append(prefill)
    return rows


VERIFY_SLOTS = 8
# the verify phase's lengths over tables of 1,024 keys (by page size): an
# inactive slot (0), a window across a page boundary (60 .. 67 at pages of
# 64, 124 .. 131 at 128), one reaching the last mapped page (1016 .. 1023),
# and slots whose lengths lie more than a 128-key split apart
VERIFY_LENS = {64: [0, 60, 1016, 1000, 300, 777, 48, 555],
               128: [0, 124, 1016, 1000, 300, 777, 48, 555]}


def _verify_sdpa(qt, kg, vg, lens, w, iters, scale=None, window=None):
    """SDPA on the windows' queries qt (B, H, W, E) against each layer's
    K/V pre-gathered to (B, Hkv, S, .) under the windows' boolean mask
    (key position <= lengths[b] + t, and within ``window``), pinned per
    backend (``sdpa_by_backend``); a backend that refuses ``enable_gqa``
    gets K/V expanded outside the timed region, over two layers."""
    dev = qt.device
    s = kg[0].shape[2]
    q_pos = lens[:, None].long() + torch.arange(w, device=dev)[None, :]
    pos = torch.arange(s, device=dev)
    mask = pos[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= pos[None, None, :] > q_pos[:, :, None] - window
    mask = mask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def run(gqa):
        ks, vs = kg, vg
        if not gqa:
            g = qt.shape[1] // kg[0].shape[1]
            ks = [t.repeat_interleave(g, 1) for t in kg[:2]]
            vs = [t.repeat_interleave(g, 1) for t in vg[:2]]
        n = len(ks)
        ms, _ = time_ms(lambda i: sdpa(qt, ks[i % n], vs[i % n],
                                       attn_mask=mask, scale=scale,
                                       enable_gqa=gqa), iters)
        return ms

    return sdpa_by_backend(run)


def _one_launch(wrapper, call, q) -> dict:
    """One bf16 verify call: its family (``variant``), and that it is one
    launch of the cluster family that allocates nothing beside its output
    (no f32 partials: ``scratch_bytes``, the peak beyond the output's
    block, which the caching allocator rounds up to 512 bytes)."""
    launches, before = wrapper.launches, wrapper.variants.copy()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base
             - -(-q.numel() * q.element_size() // 512) * 512)
    (variant,) = wrapper.variants - before
    assert wrapper.launches == launches + 1 and variant == "cluster", \
        (wrapper.__name__, variant)
    assert extra == 0, (wrapper.__name__, "allocated scratch", extra)
    return {"variant": variant, "scratch_bytes": extra}


def bench_verify_kernels(gen: torch.Generator, iters: int,
                         parent: ParentKernels | None = None
                         ) -> tuple[list[dict], dict[str, float]]:
    """The ``verify_kernels`` phase: the verify entries of kernels 2 and 4
    (one launch for all slots) against their plain versions in bf16 and
    f32, bitwise over two calls, at qwen3-0.6b's serving verify (8 slots,
    W 8 = paco_draft_len + 1, Hq 16, Hkv 8, D 128, page 64), at gemma2-2b's
    heads with its window and softcap (and a short window, so that the
    mask cuts), and at deepseek-v2's latent widths (H 128, kv_lora 512,
    qk_rope 64, page 128, W 8), each over VERIFY_LENS; then each timed in
    bf16 over its model's layers' pools in turn (CUDA-graph replay) beside
    its plain version, SDPA under the windows' mask pinned per backend,
    and the bound: each slot's live K/V read once, q and out.  Given
    ``parent``, the parent's entries take turns with the kernels (kernel,
    parent, plain and SDPA, parent, kernel).  One bf16 call of each is one
    launch of the cluster family and allocates no scratch."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ops
    from repro_torch.serve.paging import paco_draft_len

    dev = "cuda"
    b = VERIFY_SLOTS
    worst = {"paged_verify": 0.0, "paged_latent_verify": 0.0}
    rows = []

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def tables(width):
        n_pool = b * width + 1
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev)
        return n_pool, perm[:b * width].reshape(b, width).to(torch.int32)

    def check(fn, plain, name, dtype, what):
        got = fn()
        assert torch.equal(got, fn()), (name, "not bitwise reproducible",
                                        what)
        err = max_err(got, plain())
        assert err <= ATOL[dtype], (name, dtype, what, err)
        worst[name] = max(worst[name], err)

    # ---- kernel 2's verify entry: qwen3-0.6b, then gemma2-2b's heads
    for arch in ("qwen3-0.6b", "gemma2-2b"):
        cfg = get_arch(arch)
        page, width = 64, 16
        w = paco_draft_len(b, 2048, cfg.head_dim) + 1
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        n_pool, bt = tables(width)
        lens = torch.tensor(VERIFY_LENS[page], dtype=torch.int32, device=dev)
        assert int(lens.max()) + w == width * page
        kws = [{}]
        if cfg.local_window:
            kws = [{"logit_cap": cfg.softcap_attn},
                   {"window": cfg.local_window,
                    "logit_cap": cfg.softcap_attn},
                   {"window": 100, "logit_cap": cfg.softcap_attn}]
        for dtype in (torch.float32, torch.bfloat16):
            q = rnd(b, w, hq, d, dtype=dtype)
            kp = rnd(n_pool, page, hkv, d, dtype=dtype)
            vp = rnd(n_pool, page, hkv, d, dtype=dtype)
            for kw in kws:
                check(lambda: K.paged_flash_verify(
                          q, kp, vp, bt, lens, scale=1 / math.sqrt(d), **kw),
                      lambda: ops.paged_verify_attention(
                          q, kp, vp, bt, lens, use_kernel=False, **kw),
                      "paged_verify", dtype, (arch, kw))
        log(f"[verify] {arch}: W {w}, Hq {hq}, Hkv {hkv}, D {d}, page "
            f"{page}, lengths {VERIFY_LENS[page]}: f32 and bf16 within ATOL "
            f"of the plain version, bitwise over two calls")
    del q, kp, vp

    # timed at qwen3-0.6b's serving verify over its 28 layers' pools, in
    # turns with the parent's entry (given ``parent``): kernel, parent,
    # plain and SDPA, parent, kernel
    cfg = get_arch("qwen3-0.6b")
    dtype, page, width = torch.bfloat16, 64, 16
    w = paco_draft_len(b, 2048, cfg.head_dim) + 1
    hq, hkv, d, n_layers = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.n_layers
    n_pool, bt = tables(width)
    lens = torch.tensor(VERIFY_LENS[page], dtype=torch.int32, device=dev)
    kpool = rnd(n_layers, n_pool, page, hkv, d, dtype=dtype)
    vpool = rnd(n_layers, n_pool, page, hkv, d, dtype=dtype)
    q = rnd(b, w, hq, d, dtype=dtype)
    scale = 1 / math.sqrt(d)
    turns = collections.defaultdict(list)

    def call(i):
        return K.paged_flash_verify(q, kpool[i % n_layers],
                                    vpool[i % n_layers], bt, lens,
                                    scale=scale)

    def parent_turn():
        if parent is None:
            return
        scratch = parent.verify_scratch(q, width, page)
        got = parent.paged_verify(q, kpool[0], vpool[0], bt, lens,
                                  scratch).clone()
        turns["err"].append(max_err(got, ops.paged_verify_attention(
            q, kpool[0], vpool[0], bt, lens, use_kernel=False)))
        turns["p"].append(time_ms(lambda i: parent.paged_verify(
            q, kpool[i % n_layers], vpool[i % n_layers], bt, lens, scratch),
            iters))

    turns["k"].append(time_ms(call, iters))
    parent_turn()
    plain_ms, _ = time_ms(lambda i: ops.paged_verify_attention(
        q, kpool[i % n_layers], vpool[i % n_layers], bt, lens,
        use_kernel=False), max(iters // 4, 10))
    s_ctx = int(lens.max()) + w
    ctx_pages = -(-s_ctx // page)
    kg = [ops.gather_kv_pages(kpool[i], bt[:, :ctx_pages])[:, :s_ctx]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    vg = [ops.gather_kv_pages(vpool[i], bt[:, :ctx_pages])[:, :s_ctx]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    sdpa = _verify_sdpa(q.transpose(1, 2), kg, vg, lens, w, iters)
    del kg, vg
    parent_turn()
    turns["k"].append(time_ms(call, iters))
    row_one = _one_launch(K.paged_flash_verify, lambda: call(0), q)
    del kpool, vpool
    keys = int((lens + w).sum())
    pairs = int((lens[:, None] + torch.arange(1, w + 1, device=dev)).sum())
    flops, nbytes = W.paged_work(q.numel(), bt.numel(), lens.numel(), keys,
                                 pairs, hq, hkv, d, 2)
    ms, eager_ms = (sum(t[i] for t in turns["k"]) / 2 for i in (0, 1))
    row = _with_library(_row(
        "paged_verify", "src/repro_torch/csrc/paged_decode.cu",
        "src/repro/kernels/attention/attention.py:172",
        worst["paged_verify"], ms, eager_ms, plain_ms, None, nbytes, flops,
        dtype), sdpa)
    row.update(row_one, ms_turns=[t[0] for t in turns["k"]])
    if parent is not None:
        row["parent_ms"] = sum(t[0] for t in turns["p"]) / 2
        row["parent_ms_turns"] = [t[0] for t in turns["p"]]
        row["parent_max_abs_err"] = max(turns["err"])
    rows.append(row)

    # ---- kernel 4's verify entry: deepseek-v2's latent widths
    cfg = get_arch("deepseek-v2-236b")
    m, h = cfg.mla, cfg.n_heads
    kv, rope = m.kv_lora, m.qk_rope
    scale = 1 / math.sqrt(m.qk_nope + m.qk_rope)
    page, width = 128, 8
    w = paco_draft_len(b, 2048, kv) + 1
    n_pool, bt = tables(width)
    lens = torch.tensor(VERIFY_LENS[page], dtype=torch.int32, device=dev)
    assert int(lens.max()) + w == width * page
    for dtype in (torch.float32, torch.bfloat16):
        args = (rnd(b, w, h, kv, dtype=dtype), rnd(b, w, h, rope, dtype=dtype),
                rnd(n_pool, page, kv, dtype=dtype),
                rnd(n_pool, page, rope, dtype=dtype), bt, lens)
        check(lambda: K.paged_latent_verify(*args, scale=scale),
              lambda: ops.paged_latent_verify_attention(
                  *args, scale=scale, use_kernel=False),
              "paged_latent_verify", dtype, "deepseek-v2")
    log(f"[verify] deepseek-v2-236b: W {w}, H {h}, kv_lora {kv}, qk_rope "
        f"{rope}, page {page}, lengths {VERIFY_LENS[page]}: f32 and bf16 "
        f"within ATOL of the plain version, bitwise over two calls")
    del args
    dtype, n_layers = torch.bfloat16, cfg.n_layers
    ckp = rnd(n_layers, n_pool, page, kv, dtype=dtype)
    krp = rnd(n_layers, n_pool, page, rope, dtype=dtype)
    vq = (rnd(b, w, h, kv, dtype=dtype), rnd(b, w, h, rope, dtype=dtype))
    turns = collections.defaultdict(list)

    def lcall(i):
        return K.paged_latent_verify(*vq, ckp[i % n_layers],
                                     krp[i % n_layers], bt, lens,
                                     scale=scale)

    def latent_parent_turn():
        if parent is None:
            return
        scratch = parent.latent_verify_scratch(*vq, ckp[0], width)
        got = parent.paged_latent_verify(*vq, ckp[0], krp[0], bt, lens,
                                         scale, scratch).clone()
        turns["err"].append(max_err(got, ops.paged_latent_verify_attention(
            *vq, ckp[0], krp[0], bt, lens, scale=scale, use_kernel=False)))
        turns["p"].append(time_ms(lambda i: parent.paged_latent_verify(
            *vq, ckp[i % n_layers], krp[i % n_layers], bt, lens, scale,
            scratch), iters))

    turns["k"].append(time_ms(lcall, iters))
    latent_parent_turn()
    plain_ms, _ = time_ms(lambda i: ops.paged_latent_verify_attention(
        *vq, ckp[i % n_layers], krp[i % n_layers], bt, lens, scale=scale,
        use_kernel=False), max(iters // 20, 5))
    s_ctx = int(lens.max()) + w
    ctx_pages = -(-s_ctx // page)
    kg, vg = [], []
    for i in range(n_layers):
        ckg = ops.gather_kv_pages(ckp[i], bt[:, :ctx_pages])
        krg = ops.gather_kv_pages(krp[i], bt[:, :ctx_pages])
        kg.append(torch.cat([ckg, krg], -1)[:, None, :s_ctx].contiguous())
        vg.append(ckg[:, None, :s_ctx].contiguous())
    q_cat = torch.cat(vq, -1).transpose(1, 2)             # (B, H, W, 576)
    sdpa = _verify_sdpa(q_cat, kg, vg, lens, w, iters, scale=scale)
    del kg, vg
    latent_parent_turn()
    turns["k"].append(time_ms(lcall, iters))
    row_one = _one_launch(K.paged_latent_verify, lambda: lcall(0), vq[0])
    del ckp, krp
    keys = int((lens + w).sum())
    pairs = int((lens[:, None] + torch.arange(1, w + 1, device=dev)).sum())
    flops, nbytes = W.latent_work(vq[0].numel(), vq[1].numel(), bt.numel(),
                                  lens.numel(), keys, pairs, h, kv, rope, 2)
    ms, eager_ms = (sum(t[i] for t in turns["k"]) / 2 for i in (0, 1))
    row = _with_library(_row(
        "paged_latent_verify",
        "src/repro_torch/csrc/paged_latent_prefill.cu",
        "src/repro/kernels/attention/attention.py:270",
        worst["paged_latent_verify"], ms, eager_ms, plain_ms, None, nbytes,
        flops, dtype), sdpa)
    row.update(row_one, ms_turns=[t[0] for t in turns["k"]])
    if parent is not None:
        row["parent_ms"] = sum(t[0] for t in turns["p"]) / 2
        row["parent_ms_turns"] = [t[0] for t in turns["p"]]
        row["parent_max_abs_err"] = max(turns["err"])
    rows.append(row)
    return rows, worst


# ---------------------------------------------------------------------------
# phase 4: one chunk and 8 ticks at full width, kernels vs plain path
# ---------------------------------------------------------------------------

def margin_agrees(logits_plain: torch.Tensor, tok: torch.Tensor,
                  tol: float) -> bool:
    """Each row's token equals the plain argmax wherever the plain top-2
    margin exceeds ``tol``."""
    top2 = torch.topk(logits_plain.float(), 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    ok = (logits_plain.argmax(-1) == tok) | (margin <= tol)
    return bool(ok.all())


def full_width_parity(cfg, params, rng: np.random.Generator) -> dict:
    tol = MODEL_ATOL[cfg.dtype]
    from repro_torch.models import (decode_step_paged,
                                    paged_cache_leaf_specs, prefill_chunk)
    from repro_torch.serve.paging import init_pool

    slots, page, c = 8, 64, 64
    pools = {uk: init_pool(paged_cache_leaf_specs(cfg, page), 2 * slots,
                           page, "cuda").pools for uk in (True, False)}
    bt = torch.arange(2 * slots, dtype=torch.int32,
                      device="cuda").reshape(slots, 2)
    prompts = rng.integers(0, cfg.vocab, size=(slots, c))
    worst = 0.0
    first = []
    for s in range(slots):
        toks = torch.tensor(prompts[s:s + 1], dtype=torch.int32,
                            device="cuda")
        out = {uk: prefill_chunk(params, cfg, toks, 0, pools[uk], bt[s],
                                 use_kernel=uk)[0] for uk in (True, False)}
        worst = max(worst, max_err(out[True], out[False]))
        assert margin_agrees(out[False], out[True].argmax(-1), tol)
        first.append(int(out[False][c - 1].argmax()))
    cur = torch.tensor(first, dtype=torch.int32, device="cuda")
    lens = torch.full((slots,), c, dtype=torch.int32, device="cuda")
    for _ in range(8):
        out = {uk: decode_step_paged(params, cfg, cur[:, None], pools[uk],
                                     bt, lens, use_kernel=uk)[0]
               for uk in (True, False)}
        worst = max(worst, max_err(out[True], out[False]))
        assert torch.isfinite(out[True]).all()
        assert margin_agrees(out[False], out[True].argmax(-1), tol)
        cur = out[False].argmax(-1).to(torch.int32)   # teacher-forced
        lens = lens + 1
    assert worst <= tol, ("full-width logits", cfg.dtype, worst)
    return {"dtype": str(cfg.dtype), "max_abs_logit_err": worst,
            "atol": tol, "slots": slots, "chunk": c, "ticks": 8}


class RouterLog:
    """While active, records every MoE router call: the chosen expert ids
    and, per token, the margin between the k-th and (k+1)-th router
    probability, under the tag the caller sets (one tag per dispatch group
    and path).  With ``forced`` set to a deque of id tensors, each call
    takes the next one as its choice instead of its own top-k, with
    weights renormalized from its own probabilities: the path then follows
    another run's routing, and the comparison stays continuous where
    rounding would flip a near tie."""

    def __init__(self) -> None:
        self.calls: dict = {}
        self.tag = None
        self.forced: collections.deque | None = None

    def __enter__(self):
        from repro_torch.models import moe

        self._orig = orig = moe.router_topk

        def route(p, cfg, x):
            k = cfg.moe.top_k
            probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
            if self.forced is None:
                w, ids = orig(p, cfg, x)
            else:
                ids = self.forced.popleft()
                w = probs.gather(1, ids)
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.calls.setdefault(self.tag, []).append(
                (ids.clone(), top[:, k - 1] - top[:, k], probs))
            return w, ids

        moe.router_topk = route
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe

        moe.router_topk = self._orig

    def near_ties(self, tag, tol: float) -> int:
        return sum(int((margin < tol).sum())
                   for _, margin, _ in self.calls.get(tag, []))

    def flipped(self, tag_a, tag_b) -> bool:
        return any(not torch.equal(a[0], b[0])
                   for a, b in zip(self.calls[tag_a], self.calls[tag_b]))

    def prob_diff(self, tag_a, tag_b) -> float:
        """Largest difference of a router probability between the calls
        of two tags (the same tokens on two paths)."""
        return max((float((a[2] - b[2]).abs().max())
                    for a, b in zip(self.calls[tag_a], self.calls[tag_b])),
                   default=0.0)


def moe_full_width_parity(cfg, params, rng: np.random.Generator, *,
                          share_routing: bool) -> dict:
    """Full-width deepseek-v2 (MLA + MoE), kernel path vs plain path: one
    128-token chunk per slot, then 8 decode ticks teacher-forced by the
    plain path.

    A router near tie can flip an expert choice between the paths, and
    with it the capacity positions of the whole dispatch group (the chunk,
    or the tick's 8 tokens) and the cache the later ticks read.  The near
    ties of the plain path (margin under ROUTER_TOL) are counted.  With
    ``share_routing`` off (float32), each path routes itself, and the
    logit rows of a group where the two paths chose different experts are
    left out: the slot's chunk and its later ticks for a prefill group,
    every later tick for a decode group (a near tie that did not flip
    left both paths with the same dispatch, so its rows are compared); it
    fails if more than MAX_EXCLUDED of the rows are left out.  In bf16
    rounding moves the router probabilities by up to ~4e-3, and about 1%
    of choices lie within 1e-4 of a tie, so most 128-token groups would be
    left out: ``share_routing`` has the kernel path take the plain path's
    expert choices (``RouterLog.forced``), and the comparison holds the
    attention kernels and the rest of the block on every row.  Either way
    a kept row must meet MODEL_ATOL and the margin rule."""
    tol = MODEL_ATOL[cfg.dtype]
    rtol = ROUTER_TOL[cfg.dtype]
    from repro_torch.models import (decode_step_paged,
                                    paged_cache_leaf_specs, prefill_chunk)
    from repro_torch.serve.paging import init_pool

    slots, page, c, ticks = 8, 128, 128, 8
    pools = {uk: init_pool(paged_cache_leaf_specs(cfg, page), 2 * slots,
                           page, "cuda").pools for uk in (True, False)}
    bt = torch.arange(2 * slots, dtype=torch.int32,
                      device="cuda").reshape(slots, 2)
    prompts = rng.integers(0, cfg.vocab, size=(slots, c))
    outs = []                       # (event, {use_kernel: logits})

    def both_paths(log, event, run):
        out = {}
        for uk in (False, True):
            log.tag = (event, uk)
            if uk and share_routing:
                log.forced = collections.deque(
                    call[0] for call in log.calls[(event, False)])
            out[uk] = run(uk)
            log.forced = None
        outs.append((event, out))
        return out

    with RouterLog() as log:
        for s in range(slots):
            toks = torch.tensor(prompts[s:s + 1], dtype=torch.int32,
                                device="cuda")
            both_paths(log, ("prefill", s), lambda uk: prefill_chunk(
                params, cfg, toks, 0, pools[uk], bt[s], use_kernel=uk)[0])
        cur = torch.stack([o[False][c - 1].argmax() for _, o in outs])
        cur = cur.to(torch.int32)
        lens = torch.full((slots,), c, dtype=torch.int32, device="cuda")
        for t in range(ticks):
            out = both_paths(log, ("tick", t), lambda uk: decode_step_paged(
                params, cfg, cur[:, None], pools[uk], bt, lens,
                use_kernel=uk)[0])
            cur = out[False].argmax(-1).to(torch.int32)   # teacher-forced
            lens = lens + 1
    near_ties, flips, prob_diff = 0, 0, 0.0
    tainted_slots, tainted_from = set(), ticks
    for event, _ in outs:
        near = log.near_ties((event, False), rtol)
        flip = log.flipped((event, False), (event, True))
        near_ties += near
        flips += flip
        prob_diff = max(prob_diff, log.prob_diff((event, False),
                                                 (event, True)))
        if flip and not share_routing:
            if event[0] == "prefill":
                tainted_slots.add(event[1])
            else:
                tainted_from = min(tainted_from, event[1])
    worst, worst_all, kept, total = 0.0, 0.0, 0, 0
    for (kind, i), out in outs:
        diff = (out[True] - out[False]).abs().amax(-1)     # per row
        assert torch.isfinite(out[True]).all()
        worst_all = max(worst_all, float(diff.max()))
        if kind == "prefill":
            keep = torch.full_like(diff, i not in tainted_slots,
                                   dtype=torch.bool)
        else:
            keep = torch.tensor([i < tainted_from and s not in tainted_slots
                                 for s in range(slots)], device="cuda")
        total += keep.numel()
        kept += int(keep.sum())
        if keep.any():
            worst = max(worst, float(diff[keep].max()))
            assert margin_agrees(out[False][keep], out[True][keep].argmax(-1),
                                 tol), (kind, i)
    result = {"dtype": str(cfg.dtype), "layers": cfg.n_layers,
              "shared_routing": share_routing,
              "max_abs_logit_err": worst,
              "max_abs_logit_err_all_rows": worst_all, "atol": tol,
              "router_choices": sum(call[0].numel() for (ev, uk), calls
                                    in log.calls.items() if not uk
                                    for call in calls),
              "router_near_ties": near_ties, "router_tol": rtol,
              "router_prob_max_diff": prob_diff,
              "groups_with_flips": flips, "rows": total,
              "rows_excluded": total - kept, "slots": slots, "chunk": c,
              "ticks": ticks}
    log_line = f"[ds-model] kernel path vs plain path: {json.dumps(result)}"
    print(log_line, flush=True)
    assert (total - kept) <= MAX_EXCLUDED * total, \
        ("too many rows left out", result)
    assert worst <= tol, ("full-width logits", result)
    return result


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------

def replay_plain(engine, params, cfg, req) -> None:
    """Teacher-force ``req``'s prompt and served tokens through the plain
    path (``use_kernel=False``) on a fresh pool: every served token must be
    the plain argmax wherever the plain top-2 margin exceeds the
    tolerance."""
    from repro_torch.models import (decode_step_paged,
                                    paged_cache_leaf_specs, prefill_chunk)
    from repro_torch.serve.paging import init_pool

    page, chunk = engine.page, engine.chunk
    ctx = list(req.prompt)
    n_pages = engine.pages_per_seq
    pages = init_pool(paged_cache_leaf_specs(cfg, page), n_pages, page,
                      "cuda").pools
    row = torch.arange(n_pages, dtype=torch.int32, device="cuda")
    logits = None
    for i in range(0, len(ctx), chunk):
        toks = ctx[i:i + chunk] + [0] * max(0, i + chunk - len(ctx))
        logits, pages = prefill_chunk(
            params, cfg, torch.tensor([toks], dtype=torch.int32,
                                      device="cuda"),
            i, pages, row, use_kernel=False)
    step = logits[(len(ctx) - 1) % chunk][None]
    lens = torch.tensor([len(ctx)], dtype=torch.int32, device="cuda")
    for t, tok in enumerate(req.out):
        tok_t = torch.tensor([tok], dtype=torch.int32, device="cuda")
        assert margin_agrees(step, tok_t, MODEL_ATOL[cfg.dtype]), \
            (req.uid, t)
        if t + 1 < len(req.out):
            step, pages = decode_step_paged(params, cfg, tok_t[:, None],
                                            pages, row[None], lens,
                                            use_kernel=False)
            lens = lens + 1


def oracle_agrees(params, cfg, req, max_seq: int) -> int:
    """``req``'s served tokens against the port's ``reference_decode`` on
    the card (a dense re-forward per token, no cache: a path that shares
    nothing with the paged engine): they agree up to the first difference,
    and at that step the oracle's top-2 margin is within MODEL_ATOL (after
    it the contexts differ).  Returns the tokens that agree."""
    from repro_torch.serve.reference import forward_ref, reference_decode

    want = reference_decode(params, cfg, req.prompt,
                            max_new_tokens=req.max_new_tokens,
                            eos_id=req.eos_id, max_seq=max_seq)
    for t, (got, ref) in enumerate(zip(req.out, want)):
        if got != ref:   # the oracle's logits at that step, for its margin
            logits = forward_ref(params, cfg, torch.tensor(
                [req.prompt + want[:t]], device="cuda"))[:, -1]
            assert margin_agrees(logits, torch.tensor([got], device="cuda"),
                                 MODEL_ATOL[cfg.dtype]), (req.uid, t)
            return t
    assert len(req.out) == len(want), (req.uid, len(req.out), len(want))
    return len(want)


def agreement(done_a, done_b) -> dict:
    """How far two runs of the same requests emitted the same tokens."""
    a = {r.uid: r.out for r in done_a}
    b = {r.uid: r.out for r in done_b}
    same = [a[u] == b[u] for u in a]
    prefix = [next((i for i, (x, y) in enumerate(zip(a[u], b[u])) if x != y),
                   min(len(a[u]), len(b[u]))) for u in a]
    return {"requests_equal": sum(same), "requests": len(same),
            "tokens_before_first_difference": sum(prefix),
            "tokens": sum(len(a[u]) for u in a)}


class EngineCalls:
    """Records the engine's model calls while active: each prefill chunk
    (tokens, start, block row, the greedy token of every chunk row), each
    fused decode dispatch and each speculative verify dispatch (its inputs
    and the token blocks it returned), for ``replay_schedule``."""

    def __init__(self) -> None:
        self.calls: list[tuple] = []

    def __enter__(self):
        from repro_torch.serve import engine as E

        self._orig = orig_p, orig_d, orig_v = (E.prefill_chunk,
                                               E.decode_ticks, E.verify_ticks)

        def prefill(params, cfg, tokens, start, pages, row, **kw):
            logits, pages = orig_p(params, cfg, tokens, start, pages, row,
                                   **kw)
            self.calls.append(("prefill", tokens.clone(), start, row.clone(),
                               logits.argmax(-1)))
            return logits, pages

        def decode(params, cfg, toks, pages, bt, lens, act, bud, eos, n,
                   **kw):
            block, pages = orig_d(params, cfg, toks, pages, bt, lens, act,
                                  bud, eos, n, **kw)
            self.calls.append(("decode", toks.clone(), bt.clone(),
                               lens.clone(), act.clone(), bud.clone(),
                               eos.clone(), n, kw["max_seq"],
                               kw["null_page"], block.clone()))
            return block, pages

        def verify(params, cfg, toks, pages, bt, lens, act, bud, eos, hist,
                   limit, n, **kw):
            inputs = tuple(x.clone() for x in (toks, bt, lens, act, bud, eos,
                                               hist, limit))
            blocks, acc, hist_out, pages = orig_v(
                params, cfg, toks, pages, bt, lens, act, bud, eos, hist,
                limit, n, **kw)
            self.calls.append(("verify", *inputs, n, kw["max_seq"],
                               kw["draft_len"], kw["null_page"],
                               blocks.clone()))
            return blocks, acc, hist_out, pages

        E.prefill_chunk, E.decode_ticks, E.verify_ticks = (prefill, decode,
                                                           verify)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.serve import engine as E

        E.prefill_chunk, E.decode_ticks, E.verify_ticks = self._orig


def replay_schedule(engine, params, cfg, calls: list[tuple],
                    routing: list[tuple]) -> dict:
    """Replay every recorded engine call, in order, through the plain path
    (``use_kernel=False``) on a fresh pool of the same layout, teacher-
    forced by the served tokens: every chunk row's greedy token and every
    active lane's served token must be the plain argmax wherever the plain
    top-2 margin exceeds the tolerance.  An MoE model needs the whole
    schedule: a token's expert capacity depends on the other tokens of its
    dispatch group (the chunk, or the tick's active slots), so one request
    replayed alone would route differently.  The replay also takes the
    served run's expert choices (``routing``: the served run's
    ``RouterLog`` calls, in order), for the reason
    ``moe_full_width_parity`` gives for bf16."""
    from repro_torch.models import paged_cache_leaf_specs
    from repro_torch.serve.paging import init_pool

    tol = MODEL_ATOL[cfg.dtype]
    pages = init_pool(paged_cache_leaf_specs(cfg, engine.page),
                      engine.pool.n_pages, engine.page, "cuda").pools
    rows = 0
    with RouterLog() as log:
        log.tag = "replay"
        log.forced = collections.deque(call[0] for call in routing)
        rows = _replay_calls(params, cfg, calls, pages, tol)
        assert not log.forced, "the replay made fewer router calls"
    log.calls["serve"] = routing
    return {"calls": len(calls), "rows_checked": rows,
            "router_choices": sum(call[0].numel() for call in routing),
            "router_near_ties": log.near_ties("replay",
                                              ROUTER_TOL[cfg.dtype]),
            "router_tol": ROUTER_TOL[cfg.dtype],
            "router_prob_max_diff": log.prob_diff("serve", "replay")}


def _replay_verify(params, cfg, call, pages, tol: float) -> int:
    """One recorded verify dispatch through the plain path, teacher-forced
    by the served token blocks: each step drafts from the same history
    (so its window is the served one), scores the window with
    ``use_kernel=False``, requires every emitted token to be the plain
    argmax at its window offset wherever the plain top-2 margin exceeds
    ``tol``, then advances, rolls back and appends as ``verify_ticks``
    does with the served emission."""
    from repro_torch.models import transformer
    from repro_torch.models.draft import draft_ngram_propose

    (_, toks, bt, lens, act, bud, eos, hist, limit, n, max_seq, draft_len,
     null, blocks) = call
    w = draft_len + 1
    b = toks.shape[0]
    page, width = next(iter(pages.values())).shape[2], bt.shape[1]
    offs = torch.arange(w, dtype=torch.int32, device=toks.device)
    rows = 0
    for step in range(n):
        props = draft_ngram_propose(hist, lens + 1, draft_len=draft_len)
        win = torch.cat([toks[:, None], props], dim=1)
        positions = lens[:, None] + offs[None, :]
        wp = bt.gather(1, torch.clamp(positions // page, 0,
                                      width - 1).long())
        in_plan = act[:, None] & (positions < limit[:, None])
        wp = torch.where(in_plan, wp, null).long()
        wo = (positions % page).long()
        old = {k: v[:, wp, wo] for k, v in pages.items()}
        logits, pages = transformer._verify_window(
            params, cfg, win, pages, bt, lens, wp, wo, use_kernel=False)
        served = blocks[step]
        emitted = served >= 0
        assert margin_agrees(logits[emitted], served[emitted], tol), \
            ("verify", step)
        rows += int(emitted.sum())
        n_emit = emitted.sum(1).to(torch.int32)
        keep = offs[None, :] < n_emit[:, None]
        for k, v in pages.items():
            mask = keep.reshape((1, b, w) + (1,) * (v.dim() - 3))
            v[:, wp, wo] = torch.where(mask, v[:, wp, wo], old[k])
        hidx = torch.where(keep, lens[:, None] + 1 + offs[None, :],
                           hist.shape[1])
        pad = torch.cat([hist, hist.new_zeros(b, 1)], dim=1)
        pad.scatter_(1, torch.clamp(hidx, max=hist.shape[1]).long(), served)
        hist = pad[:, :-1].contiguous()
        for j in range(w):                 # verify_ticks' retirement rule
            can = emitted[:, j]
            toks = torch.where(can, served[:, j], toks)
            lens = lens + can.to(torch.int32)
            bud = bud - can.to(torch.int32)
            done = (bud <= 0) | (served[:, j] == eos) | (lens + 1 >= max_seq)
            act = act & ~(can & done)
    return rows


def _replay_calls(params, cfg, calls, pages, tol: float) -> int:
    from repro_torch.models import prefill_chunk, transformer

    rows = 0
    for call in calls:
        if call[0] == "verify":
            rows += _replay_verify(params, cfg, call, pages, tol)
            continue
        if call[0] == "prefill":
            _, tokens, start, row, served = call
            logits, pages = prefill_chunk(params, cfg, tokens, start, pages,
                                          row, use_kernel=False)
            assert margin_agrees(logits, served, tol), ("prefill", start)
            rows += served.numel()
            continue
        _, toks, bt, lens, act, bud, eos, n, max_seq, null, block = call
        for j in range(n):
            logits, pages = transformer._paged_tick(
                params, cfg, toks[:, None], pages, bt, lens, write_mask=act,
                null_page=null, use_kernel=False)
            nxt = torch.where(act, block[j], toks)
            assert margin_agrees(logits[act], nxt[act], tol), ("tick", j)
            rows += int(act.sum())
            step = act.to(torch.int32)       # decode_ticks' retirement rule
            lens, bud = lens + step, bud - step
            done = (bud <= 0) | (nxt == eos) | (lens + 1 >= max_seq)
            act, toks = act & ~done, nxt
    return rows


def serve(cfg, params, rng: np.random.Generator, seed: int,
          geometry: tuple[int, int, int], kernels: dict,
          record: bool = False, prompts: list | None = None,
          **engine_kw) -> tuple[dict, object, list]:
    """ServeEngine at 8 slots and max_seq 2048: 16 requests, prompts of
    48..1000 tokens (or ``prompts``), 32 new tokens each; ``engine_kw``
    goes to the engine (``speculate``, ``fused``).  ``geometry`` is the
    expected (page, chunk, pages_per_seq); ``kernels`` maps each kernel's
    name to its wrapper and the engine counter its launches must equal
    times the depth.  The counts are zeroed just before and read just
    after.  With ``record``, the engine's model calls and expert choices
    are kept for ``replay_schedule``: the third result is then (calls,
    routing), else the finished requests."""
    from repro_torch.serve import Request, ServeEngine

    engine = ServeEngine(params, cfg, slots=8, max_seq=2048,
                         ticks_per_dispatch=8, seed=seed, device="cuda",
                         **engine_kw)
    assert (engine.page, engine.chunk, engine.pages_per_seq) == geometry
    if prompts is None:
        prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
                   for n in rng.integers(48, 1001, size=16)]
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=32)
            for i, p in enumerate(prompts)]
    lengths = np.array([len(p) for p in prompts])
    recorder, router = EngineCalls(), RouterLog()
    router.tag = "serve"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in kernels.values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants.clear()
    t0 = time.perf_counter()
    with (recorder if record else contextlib.nullcontext(),
          router if record else contextlib.nullcontext()):
        for r in reqs:
            engine.submit(r)
        done = engine.run_until_drained()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    by_variant = {name: dict(fn.variants) for name, (fn, _) in kernels.items()
                  if hasattr(fn, "variants")}
    engine.check_page_invariants()
    st = engine.stats
    assert len(done) == len(reqs), len(done)
    assert all(len(r.out) == 32 for r in done), [len(r.out) for r in done]
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)
    for name, (_, stat) in kernels.items():
        assert launches[name] == st[stat] * cfg.n_layers > 0, \
            (name, launches, st[stat])
    gen_tokens = sum(len(r.out) for r in done)
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "requests": len(done), "generated_tokens": gen_tokens,
           "prompt_tokens": int(lengths.sum()), "wall_s": wall,
           "tokens_per_s": gen_tokens / wall,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "prefill_calls": st["prefill_calls"],
           "decode_steps": st["decode_steps"],
           "dispatches": st["dispatches"],
           "preemptions": st["preemptions"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_by_variant": by_variant}
    if engine.draft_len is not None:
        assert st["spec_windows"] > 0
        assert st["drafted_tokens"] == engine.draft_len * st["spec_windows"]
        assert 0 <= st["accepted_tokens"] <= st["drafted_tokens"]
        assert (st["spec_windows"] <= st["decode_tokens"]
                <= st["spec_windows"] + st["accepted_tokens"])
        out.update({
            "draft_len": engine.draft_len,
            "spec_windows": st["spec_windows"],
            "accepted_tokens": st["accepted_tokens"],
            "drafted_tokens": st["drafted_tokens"],
            "acceptance": st["accepted_tokens"] / st["drafted_tokens"],
            "tokens_per_verify_step": (st["decode_tokens"]
                                       / st["decode_steps"]),
            "tokens_per_window": st["decode_tokens"] / st["spec_windows"],
            "spec_fallback_dispatches": st["spec_fallback_dispatches"]})
    if record:
        return out, engine, (recorder.calls, router.calls.get("serve", []))
    return out, engine, done


# ---------------------------------------------------------------------------
# phase 3, continued: kernel 5 at its own key length, and at D 112
# ---------------------------------------------------------------------------

# (Sq, Sk, D, causal, Hq, Hkv, B): a cross-attention ragged on both sides
# (seamless-m4t-medium's 16 heads at D 64, then D 128 and 256; 300 against
# 1000 causal leaves keys no query sees), and zamba2-7b's shared block at
# D 112, whose bf16 runs on wgmma padded to 128
FLASH_SK_SHAPES = [(256, 1024, 64, False, 16, 16, 2),
                   (1024, 256, 64, False, 16, 16, 2),
                   (300, 1000, 64, True, 16, 16, 2),
                   (512, 768, 128, False, 16, 8, 2),
                   (512, 768, 256, False, 8, 4, 2),
                   (2048, 2048, 112, True, 32, 32, 1)]


def check_flash_own_key_length(gen: torch.Generator) -> dict[str, float]:
    """The flash pair with Sq != Sk (and at zamba2's D 112) against
    ``ref.attention_ref`` and its gradient in f32 and bf16 within
    FLASH_TOL, O's error over max(1, max |plain|) and each of dQ, dK and
    dV's over its own max |plain| (``_own_rel_err``); in bf16 the forward
    and the backward bitwise the
    same over two calls; keys no query sees get exactly zero dK and dV.
    The split family (``cluster``) is held so at every case it takes,
    at each of the library's cluster sizes (``ranks``; ``SPLIT_RANKS``:
    2), besides the rank count the chooser gives the case."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ref

    worst = {n: 0.0 for n in ("flash_attention_cross", "flash_attention_d112",
                              "flash_attention_bwd_cross",
                              "flash_attention_bwd_d112")}
    for dtype in (torch.float32, torch.bfloat16):
        for sq, sk, d, causal, hq, hkv, b in FLASH_SK_SHAPES:
            q, d_o = (torch.randn(b, sq, hq, d, generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn(b, sk, hkv, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            o, lse = K._flash_fwd(q, k, v, causal=causal, window=None,
                                  logit_cap=None)
            grads = K.flash_attention_bwd(q, k, v, o, lse, d_o, causal=causal)
            case = (str(dtype), sq, sk, d, causal)
            if dtype == torch.bfloat16:
                again, _ = K._flash_fwd(q, k, v, causal=causal, window=None,
                                        logit_cap=None)
                assert torch.equal(o, again), ("flash at Sq != Sk repeat",
                                               case)
                again = K.flash_attention_bwd(q, k, v, o, lse, d_o,
                                              causal=causal)
                assert all(torch.equal(a, c) for a, c in zip(grads, again)), \
                    ("flash_attention_bwd at Sq != Sk repeat", case)
                del again
            if causal and sq < sk:
                assert not grads[1][:, sq:].any() and \
                    not grads[2][:, sq:].any(), ("unseen keys", case)
            # the split family at every case it takes (bf16, D 64, 112,
            # 128), at each rank count, whatever the chooser picks: within
            # FLASH_TOL of the plain versions below, bitwise over two calls
            tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
            want_o = ref.attention_ref(*tr[:3], causal=causal).transpose(1, 2)
            want_g = [w.transpose(1, 2) for w in ref.attention_ref_grad(
                *tr, causal=causal)]
            split = dtype == torch.bfloat16 and d in (64, 112, 128)
            for r in K.SPLIT_RANKS if split else ():
                o_r, lse_r = K._flash_fwd(q, k, v, causal=causal,
                                          window=None, logit_cap=None,
                                          ranks=r)
                g_r = K.flash_attention_bwd(q, k, v, o_r, lse_r, d_o,
                                            causal=causal, ranks=r)
                again = K._flash_fwd(q, k, v, causal=causal, window=None,
                                     logit_cap=None, ranks=r)
                assert torch.equal(o_r, again[0]) and \
                    torch.equal(lse_r, again[1]), ("split repeat", r, case)
                again = K.flash_attention_bwd(q, k, v, o_r, lse_r, d_o,
                                              causal=causal, ranks=r)
                assert all(torch.equal(a, c) for a, c in zip(g_r, again)), \
                    ("split backward repeat", r, case)
                err_r = max(_rel_err(o_r, want_o), *(
                    _own_rel_err(a, w) for a, w in zip(g_r, want_g)))
                assert err_r <= FLASH_TOL[dtype], ("split", r, case, err_r)
                if causal and sq < sk:
                    assert not g_r[1][:, sq:].any() and \
                        not g_r[2][:, sq:].any(), ("unseen keys", r, case)
                del o_r, lse_r, g_r, again
            err = _rel_err(o, want_o)
            err_b = max(_own_rel_err(a, w) for a, w in zip(grads, want_g))
            assert err <= FLASH_TOL[dtype], ("flash_attention Sq/Sk", case,
                                             err)
            assert err_b <= FLASH_TOL[dtype], ("flash_attention_bwd Sq/Sk",
                                               case, err_b)
            tag = "d112" if d == 112 else "cross"
            worst[f"flash_attention_{tag}"] = max(
                worst[f"flash_attention_{tag}"], err)
            worst[f"flash_attention_bwd_{tag}"] = max(
                worst[f"flash_attention_bwd_{tag}"], err_b)
            del q, k, v, d_o, o, lse, grads, tr, want_o, want_g
    torch.cuda.empty_cache()
    return worst


# The flash pair beside the parent's at the training shape: this many turns
# of each, of this many calls each (one CUDA-graph replay per turn).
FLASH_PARENT_TURNS = 16
FLASH_PARENT_ITERS = 50


def _sass_by_kernel(path: str) -> dict[str, collections.Counter]:
    """The wgmma flash kernels' SASS in a library (``cuobjdump -sass``), by
    kernel and width ("dkv_kernel<128>"): the count of each opcode (its
    first dotted part; WARPGROUP's first two, ARRIVE and DEPBAR apart) and
    of all instructions ("total").  Empty where the toolkit has no
    cuobjdump."""
    from repro_torch.kernels.build import cuobjdump

    tool = cuobjdump()
    if tool is None:
        return {}
    out, key = {}, None
    for line in subprocess.run([tool, "-sass", path], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_wgmma\d+(fwd|dq|dkv)_kernelILi(\d+)E"
                          r"(Lb([01])E)?", line)
            # the key-block instantiations (flag KB) apart from the
            # whole-sequence ones, which keep the parent's names
            key = (f"{m[1]}_kernel<{m[2]}"
                   + (", key block>" if m[4] == "1" else ">")) if m else None
            # the D-256 backward (flash_wgmma256.cuh): "dq_kernel<256>"
            m = re.search(r"flash_wgmma\d+(dq|dkv)256_kernelILb([01])E",
                          line)
            if m:
                key = (f"{m[1]}_kernel<256"
                       + (", key block>" if m[2] == "1" else ">"))
            # the split family: "fwd_split2_kernel<64>"
            m = re.search(r"flash_wgmma\d+(fwd|dq)_split(\d)_kernelILi(\d+)E",
                          line)
            if m:
                key = f"{m[1]}_split{m[2]}_kernel<{m[3]}>"
            if key:
                out[key] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if key and m:
            parts = m[2].split(".")
            op = ".".join(parts[:2]) if parts[0] == "WARPGROUP" else parts[0]
            out[key][op] += 1
            out[key]["total"] += 1
    return out


def flash_against_parent(parent: ParentKernels,
                         gen: torch.Generator) -> dict:
    """With ``--parent``: the wgmma flash kernels beside the parent's.
    SASS: for each kernel and width both libraries hold, the opcodes whose
    counts differ, and the counts of HGMMA, WARPGROUP.ARRIVE,
    WARPGROUP.DEPBAR, BAR, SYNCS and all instructions.  Times: rows 5 and
    5b at the training shape (``FLASH_TRAIN_SHAPE``), each kernel captured
    once in a CUDA graph of FLASH_PARENT_ITERS calls, the current and the
    parent replayed in FLASH_PARENT_TURNS adjacent pairs whose order
    alternates; per row the median turn of each, each one's spread
    ((max - min) / median of its turns) and the current over the parent
    per pair (median, min, max)."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.build import LIBS

    sass, sass_new, every = {}, {}, {}
    kept = ("HGMMA", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR", "BAR", "SYNCS")
    for lib in ("flash_fwd", "flash_bwd"):
        cur = _sass_by_kernel(LIBS.get(lib)._name)
        par = _sass_by_kernel(parent.paths[lib])
        every.update(cur)
        for name in sorted(cur.keys() & par.keys()):
            ops = {op for op in cur[name] | par[name]
                   if cur[name][op] != par[name][op]}
            ops |= {*kept, "total"}
            sass[name] = {op: [cur[name][op], par[name][op]]
                          for op in sorted(ops)}
            # the kernels both hold (D 64, 112, 128) keep their products,
            # fences and barriers
            assert all(cur[name][op] == par[name][op] for op in kept), \
                ("SASS differs from the parent's", name, sass[name])
        for name in sorted(cur.keys() - par.keys()):
            sass_new[name] = {op: cur[name][op] for op in (*kept, "total")}
    # the D-256 kernels and the split family run their products on wgmma
    # (where the toolkit has cuobjdump)
    for name in ("fwd_kernel<256>", "dq_kernel<256>", "dkv_kernel<256>",
                 *(f"{p}_split{r}_kernel<{d}>" for p in ("fwd", "dq")
                   for r in K.SPLIT_RANKS for d in (64, 112, 128))):
        assert not every or every.get(name, {}).get("HGMMA"), \
            ("no wgmma in the kernel", name, sorted(every))
    (b, hq, hkv, sq, sk, d, causal), = FLASH_TRAIN_SHAPE.values()
    q, d_o = (torch.randn(b, sq, hq, d, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, sk, hkv, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    o, lse = K._flash_fwd(q, k, v, causal=causal, window=None,
                          logit_cap=None)
    o2, lse2, delta = (torch.empty_like(o), torch.empty_like(lse),
                       torch.empty_like(lse))
    g2 = [torch.empty_like(t) for t in (q, k, v)]
    calls = {
        "5": lambda: K._flash_fwd(q, k, v, causal=causal, window=None,
                                  logit_cap=None),
        "5b": lambda: K.flash_attention_bwd(q, k, v, o, lse, d_o,
                                            causal=causal),
        "parent 5": lambda: parent.forward(q, k, v, o2, lse2),
        "parent 5b": lambda: parent.backward(q, k, v, o, lse, d_o, delta,
                                             *g2)}
    graphs = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(FLASH_PARENT_ITERS):
                fn()
        graphs[name].replay()
    turns = collections.defaultdict(list)
    for i in range(FLASH_PARENT_TURNS):
        for row in ("5", "5b"):
            pair = (row, f"parent {row}")
            for name in pair if i % 2 == 0 else pair[::-1]:
                turns[name].append(_events_ms(graphs[name].replay,
                                              FLASH_PARENT_ITERS))
    del graphs
    torch.cuda.empty_cache()
    times = {}
    for row in ("5", "5b"):
        ratio = [a / p for a, p in zip(turns[row], turns[f"parent {row}"])]
        times[row] = {"ms": float(np.median(turns[row])),
                      "parent_ms": float(np.median(turns[f"parent {row}"])),
                      "ratio": [float(np.median(ratio)), min(ratio),
                                max(ratio)]}
        for name in (row, f"parent {row}"):
            t = turns[name]
            times[row]["spread" if name == row else "parent_spread"] = (
                (max(t) - min(t)) / float(np.median(t)))
    return {"sass": sass, "sass_d256": sass_new, "times": times,
            "turns": FLASH_PARENT_TURNS, "iters": FLASH_PARENT_ITERS}


def check_flash_same_as_parent(parent: ParentKernels,
                               gen: torch.Generator) -> tuple[int, int]:
    """With ``--parent``: the pair at Sq == Sk, causal, is bitwise the
    parent's (O, the log-sum-exp, dQ, dK and dV) in every family the
    parent shares: bf16 at D 16 on the CUDA cores, 64 and 128 on wgmma, at
    ragged and whole lengths and G 1, 2 and 8; and float32 at D 16 (the
    CUDA cores).  float32 at D 64 and 128 runs ``wgmma_tf32x3``, whose
    sums go in another order than the parent's CUDA cores where the parent
    predates it: held within FLASH_TOL of the parent's (O over max(1, max
    |parent|), dQ, dK, dV each of its own max), its log-sum-exp within
    1e-5.  (bf16 at D 256 runs ``fwd_kernel<256>`` of
    ``flash_wgmma.cuh`` and the backward of ``flash_wgmma256.cuh``, which
    are not the parent's where it predates them: ``check_flash_small`` and
    the rows hold them to their plain versions.)  The current pair runs
    with its rank count fixed at 1 (``ranks``), and so does the parent
    where it has the split family; where the chooser splits a case (its
    B 2 x Hkv 2 items fill few processors), the split family as a caller
    gets it is held within FLASH_TOL of the parent's (dQ, dK, dV each of
    its own max), its log-sum-exp within 1e-3: the split changes the
    order of the sums.  Returns the cases checked, how many of them were
    held within FLASH_TOL rather than bitwise (float32 at D 64 and 128),
    and how many of them split."""
    from repro_torch.kernels.attention import attention as K

    split = near = 0
    cases = [(torch.bfloat16, d, s, g) for d, s, g in itertools.product(
        (16, 64, 128), (77, 1000, 4096), (1, 2, 8))]
    cases += [(torch.float32, d, s, g) for d, s, g in itertools.product(
        (16, 64, 128), (77, 1000), (1, 8))]
    # bitwise at f32 D 64 and 128 only where the parent has that family
    tf32_parent = parent.fwd_tf32 is not None
    for dtype, d, s, g in cases:
        b, hkv = 2, 2
        q, d_o = (torch.randn(b, s, hkv * g, d, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, d, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        # the unsplit families (ranks 1) bitwise the parent's
        o, lse = K._flash_fwd(q, k, v, causal=True, window=None,
                              logit_cap=None, ranks=1)
        grads = K.flash_attention_bwd(q, k, v, o, lse, d_o, causal=True,
                                      ranks=1)
        o2, lse2, delta = (torch.empty_like(o), torch.empty_like(lse),
                           torch.empty_like(lse))
        parent.forward(q, k, v, o2, lse2, ranks=1)
        g2 = [torch.empty_like(t) for t in (q, k, v)]
        parent.backward(q, k, v, o, lse, d_o, delta, *g2, ranks=1)
        torch.cuda.synchronize()
        case = (str(dtype), d, s, g)
        if dtype == torch.float32 and d in (64, 128) and not tf32_parent:
            err = max(_rel_err(o, o2), *(
                _own_rel_err(a, c) for a, c in zip(grads, g2)))
            assert err <= FLASH_TOL[dtype], \
                ("float32 flash differs from the parent's", case, err)
            assert float((lse - lse2).abs().max()) <= 1e-5, \
                ("float32 flash log-sum-exp", case)
            near += 1
            continue
        assert torch.equal(o, o2) and torch.equal(lse, lse2), \
            ("flash forward differs from the parent's", case)
        assert all(torch.equal(a, c) for a, c in zip(grads, g2)), \
            ("flash backward differs from the parent's", case)
        # where the chooser splits the case (B 2 x Hkv 2 fills few
        # processors), the split family within FLASH_TOL of the parent's
        ranks = [K._flash_ranks(lib, dtype, b, s, s, hkv * g, hkv, d, True,
                                2 ** 31 - 1)
                 for lib in ("flash_fwd", "flash_bwd")]
        if max(ranks) > 1:
            split += 1
            o3, lse3 = K._flash_fwd(q, k, v, causal=True, window=None,
                                    logit_cap=None)
            g3 = K.flash_attention_bwd(q, k, v, o3, lse3, d_o, causal=True)
            err = max(_rel_err(o3, o2), *(
                _own_rel_err(a, c) for a, c in zip(g3, g2)))
            assert err <= FLASH_TOL[dtype], \
                ("split flash differs from the parent's", case, ranks, err)
            assert float((lse3 - lse2).abs().max()) <= 1e-3, \
                ("split flash log-sum-exp", case, ranks)
    return len(cases), near, split


# ---------------------------------------------------------------------------
# sequence-parallel attention: the key-block entries of kernels 5 and 5b
# ---------------------------------------------------------------------------

# gemma2-2b's attention at full width (8 query heads, 4 KV heads, D 256,
# softcap 50), causal: a global layer at train_4k's length and a local one
# (window 4096) at 8192, each cut into the 16 x 16 mesh's 16 key blocks and
# into 5 (a prime model axis).  The rows time train_4k's cut into 16.
SEQ_GEOM = {"b": 1, "hq": 8, "hkv": 4, "d": 256, "logit_cap": 50.0}
SEQ_CELLS = {"train_4k": (4096, None), "local": (8192, 4096)}
SEQ_BLOCKS = (16, 5)
SEQ_TRAIN_B = 16   # train_4k's 256 sequences over the 16 x 16 mesh's dp 16


def _key_blocks(s: int, p: int) -> tuple[list[int], list[int]]:
    """p contiguous blocks of s keys, repro's cut where p divides s:
    (offsets, lengths)."""
    bounds = [round(i * s / p) for i in range(p + 1)]
    return bounds[:-1], [c - a for a, c in zip(bounds, bounds[1:])]


def _seq_run(q, k, v, d_o, offs, lens, kw, blocks=None):
    """``seq_attention`` over the blocks of k and v (kernels; the list
    reduction, then ``blocks``' group where given), forward and backward:
    (O, (dq, dk, dv))."""
    from repro_torch.kernels.attention import attention as K

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = K.seq_attention(
        leaves[0], [leaves[1][:, o:o + n] for o, n in zip(offs, lens)],
        [leaves[2][:, o:o + n] for o, n in zip(offs, lens)], offs,
        blocks=blocks or K.KeyBlocks(), **kw)
    grads = torch.autograd.grad(out, leaves, d_o)
    return out.detach(), grads


def check_seq_attention(gen: torch.Generator) -> dict[str, float]:
    """The key-block entries at SEQ_GEOM, each cell of SEQ_CELLS cut into
    each of SEQ_BLOCKS, f32 and bf16: every block's O and lse against its
    plain version (``ref.attention_block_ref``; O within FLASH_TOL of
    max(1, max |plain|), lse -inf on exactly the plain version's rows);
    ``seq_attention`` over the blocks (forward and backward, the list
    reduction) against the whole-sequence kernels 5 and 5b (FLASH_TOL,
    the gradients each of its own max) and bitwise the same over two runs;
    each block's backward at the merged O and lse against
    ``ref.attention_block_ref_grad``; one block at offset 0 bitwise kernel
    5's O.  Returns the worst errors."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ref

    g = SEQ_GEOM
    worst = {"flash_attention_block": 0.0, "flash_attention_block_bwd": 0.0}
    for dtype, (cell, (s, window)) in itertools.product(
            (torch.float32, torch.bfloat16), SEQ_CELLS.items()):
        kw = {"causal": True, "window": window, "logit_cap": g["logit_cap"]}
        q, d_o = (torch.randn(g["b"], s, g["hq"], g["d"], generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(g["b"], s, g["hkv"], g["d"], generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        whole_o, whole_lse = K._flash_fwd(q, k, v, **kw)
        whole_g = K.flash_attention_bwd(q, k, v, whole_o, whole_lse, d_o,
                                        **kw)
        one, _ = _seq_run(q, k, v, d_o, [0], [s], kw)
        assert torch.equal(one, whole_o), ("one key block is not kernel 5",
                                           str(dtype), cell)
        for p in SEQ_BLOCKS:
            case = (str(dtype), cell, p)
            offs, lens = _key_blocks(s, p)
            out, grads = _seq_run(q, k, v, d_o, offs, lens, kw)
            again = _seq_run(q, k, v, d_o, offs, lens, kw)
            assert torch.equal(out, again[0]) and all(
                torch.equal(a, c) for a, c in zip(grads, again[1])), \
                ("seq_attention repeat", case)
            del again
            err_f = _rel_err(out, whole_o)
            err_b = max(_own_rel_err(a, w) for a, w in zip(grads, whole_g))
            parts = []
            for off, n in zip(offs, lens):
                kb, vb = k[:, off:off + n], v[:, off:off + n]
                o_b, lse_b = K.flash_attention_block(q, kb, vb, k_off=off,
                                                     **kw)
                want_o, want_lse = ref.attention_block_ref(q, kb, vb,
                                                           k_off=off, **kw)
                assert torch.equal(torch.isinf(lse_b),
                                   torch.isinf(want_lse)), ("-inf rows", case)
                err_f = max(err_f, _rel_err(o_b, want_o))
                parts.append(lse_b)
            m = torch.stack(parts).amax(0)
            lse = m + torch.log(sum(torch.exp(x - m) for x in parts))
            for off, n in zip(offs, lens):
                kb, vb = (t[:, off:off + n].contiguous() for t in (k, v))
                got = K.flash_attention_block_bwd(q, kb, vb, out, lse, d_o,
                                                  k_off=off, **kw)
                want = ref.attention_block_ref_grad(q, kb, vb, out, lse, d_o,
                                                    k_off=off, **kw)
                err_b = max(err_b, *(_own_rel_err(a, w)
                                     for a, w in zip(got, want)))
                del got, want
            assert err_f <= FLASH_TOL[dtype], ("flash_attention_block",
                                               case, err_f)
            assert err_b <= FLASH_TOL[dtype], ("flash_attention_block_bwd",
                                               case, err_b)
            worst["flash_attention_block"] = max(
                worst["flash_attention_block"], err_f)
            worst["flash_attention_block_bwd"] = max(
                worst["flash_attention_block_bwd"], err_b)
            del out, grads
            torch.cuda.empty_cache()
    return worst


def _seq_times(q, k, v, d_o, offs, lens, kw,
               parent: ParentKernels | None = None) -> dict[str, dict]:
    """Rows 5s and 5bs's numbers on q, k, v, d_o (train_4k's global layer
    cut at offs, lens): for each entry the time of the block of rank 0
    (keys 0-255, which every query sees) and of the last rank (keys
    3840-4095), CUDA-graph replays, and its eager time; the plain versions
    on rank 0's block; SDPA (and its backward) on rank 0's block under the
    block's boolean mask (no softcap: SDPA has none), each backend pinned;
    the bounds from the block formula (``kernels.work``) for both ranks.
    The entries run at the merged O and lse of ``seq_attention``.  Given
    ``parent`` (with its key-block entries), the parent's entries on the
    same blocks in turns with the current ones (kernel, parent, parent,
    kernel), each time the mean of its two turns."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ref

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    out, _ = _seq_run(q, k, v, d_o, offs, lens, kw)
    parts = [K.flash_attention_block(q, k[:, o:o + n].contiguous(),
                                     v[:, o:o + n].contiguous(), k_off=o,
                                     **kw)[1] for o, n in zip(offs, lens)]
    m = torch.stack(parts).amax(0)
    lse = m + torch.log(sum(torch.exp(x - m) for x in parts))
    del parts
    sdpa = torch.nn.functional.scaled_dot_product_attention
    got = {}
    for name, src, fl_fn in (
            ("flash_attention_block", "flash_fwd", W.flash_fwd_work),
            ("flash_attention_block_bwd", "flash_bwd", W.flash_bwd_work)):
        times, parent_times = {}, {}
        with_parent = parent is not None and parent.bwd_block is not None
        for rank, off, n in ((0, offs[0], lens[0]),
                             (len(offs) - 1, offs[-1], lens[-1])):
            kb, vb = (t[:, off:off + n].contiguous() for t in (k, v))
            if src == "flash_fwd":
                call = lambda i: K.flash_attention_block(  # noqa: E731
                    q, kb, vb, k_off=off, **kw)
            else:
                call = lambda i: K.flash_attention_block_bwd(  # noqa: E731
                    q, kb, vb, out, lse, d_o, k_off=off, **kw)
            if not with_parent:
                times[rank] = time_ms(call, FLASH_ITERS)
                torch.cuda.empty_cache()
                continue
            o2 = torch.empty(q.shape, dtype=torch.float32, device="cuda")
            lse2 = torch.empty_like(lse)
            g2 = [o2, torch.empty_like(kb), torch.empty_like(vb)]
            if src == "flash_fwd":
                p_call = lambda i: parent.forward_block(  # noqa: E731
                    q, kb, vb, o2, lse2, off, **kw)
            else:
                p_call = lambda i: parent.backward_block(  # noqa: E731
                    q, kb, vb, out, lse, d_o, lse2, *g2, off, **kw)
            turns = collections.defaultdict(list)
            for who in ("k", "p", "p", "k"):
                turns[who].append(time_ms(call if who == "k" else p_call,
                                          FLASH_ITERS))
            times[rank] = tuple(sum(t[i] for t in turns["k"]) / 2
                                for i in range(2))
            parent_times[rank] = sum(t[0] for t in turns["p"]) / 2
            del o2, lse2, g2
            torch.cuda.empty_cache()
        kb, vb = (t[:, :lens[0]].contiguous() for t in (k, v))
        if src == "flash_fwd":
            plain = _events_loop_ms(lambda: ref.attention_block_ref(
                q, kb, vb, k_off=0, **kw), 3)
        else:
            plain = _events_loop_ms(lambda: ref.attention_block_ref_grad(
                q, kb, vb, out, lse, d_o, k_off=0, **kw), 3)
        tr = [t.transpose(1, 2) for t in (q, kb, vb, d_o)]
        mask = (torch.arange(s, device="cuda")[:, None]
                >= torch.arange(lens[0], device="cuda")[None, :])

        def kv(gqa):
            return tr[1:3] if gqa else [t.repeat_interleave(hq // hkv, 1)
                                        for t in tr[1:3]]

        def lib_fwd(gqa):
            kk, vv = kv(gqa)
            return _events_loop_ms(lambda: sdpa(
                tr[0], kk, vv, attn_mask=mask, enable_gqa=gqa), 20)

        def lib_bwd(gqa):
            leaves = [t.detach().requires_grad_() for t in (tr[0], *kv(gqa))]
            o = sdpa(*leaves, attn_mask=mask, enable_gqa=gqa)
            return _events_loop_ms(lambda: torch.autograd.grad(
                o, leaves, tr[3], retain_graph=True), 20)

        lib = sdpa_by_backend(lib_fwd if src == "flash_fwd" else lib_bwd)
        torch.cuda.empty_cache()
        work = [fl_fn(b, s, lens[i], hq, hkv, d, 2, causal=True,
                      window=kw["window"], k_off=offs[i]) for i in (0, -1)]
        got[name] = {"src": src, "ms": times[0][0], "eager_ms": times[0][1],
                     "ms_last_rank": times[len(offs) - 1][0],
                     "plain_ms": plain, "sdpa": lib, "work": work,
                     "bound_ms_last_rank": _bound(work[1][1], work[1][0],
                                                  q.dtype)[0]}
        if parent_times:
            got[name]["parent_ms"] = parent_times[0]
            got[name]["parent_ms_last_rank"] = parent_times[len(offs) - 1]
    return got


def seq_attention_phase(gen: torch.Generator, smi: str,
                        parent: ParentKernels | None = None
                        ) -> tuple[list[dict], dict[str, int]]:
    """Sequence-parallel attention on the card: ``check_seq_attention``,
    then the main path, ``seq_attention`` forward and backward at
    train_4k's global layer (bf16) cut into 16 blocks, with the block
    entries' counts zeroed just before and read just after (16 launches
    of each, both on ``wgmma`` at D 256), then rows 5s and 5bs
    (``_seq_times``, with the parent's entries beside them given
    ``parent``) at B 1 and, under "b16", at the B 16 that each rank of the
    16 x 16 mesh holds at train_4k (256 sequences over dp 16).  Returns the
    rows and their launches."""
    from repro_torch.kernels.attention import attention as K

    worst = check_seq_attention(gen)
    log(f"[seq] key-block entries against their plain versions and the "
        f"whole-sequence kernels ok: max err {worst}")
    g, dtype = SEQ_GEOM, torch.bfloat16
    s, window = SEQ_CELLS["train_4k"]
    kw = {"causal": True, "window": window, "logit_cap": g["logit_cap"]}
    offs, lens = _key_blocks(s, SEQ_BLOCKS[0])

    def draw(b):
        q, d_o = (torch.randn(b, s, g["hq"], g["d"], generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(b, s, g["hkv"], g["d"], generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        return q, k, v, d_o

    q, k, v, d_o = draw(g["b"])
    for fn in (K.flash_attention_block, K.flash_attention_block_bwd):
        fn.launches = 0
        fn.variants.clear()
    _seq_run(q, k, v, d_o, offs, lens, kw)
    torch.cuda.synchronize()
    launches = {"flash_attention_block": K.flash_attention_block.launches,
                "flash_attention_block_bwd":
                    K.flash_attention_block_bwd.launches}
    variants = [dict(K.flash_attention_block.variants),
                dict(K.flash_attention_block_bwd.variants)]
    log(f"[seq] main path (bf16, S {s}, {len(offs)} key blocks): launches "
        f"{json.dumps(launches)}, variants {json.dumps(variants)}")
    assert variants == [{"wgmma": len(offs)}, {"wgmma": len(offs)}]
    one = _seq_times(q, k, v, d_o, offs, lens, kw, parent)
    del q, k, v, d_o
    torch.cuda.empty_cache()
    b16 = _seq_times(*draw(SEQ_TRAIN_B), offs, lens, kw, parent)
    torch.cuda.empty_cache()
    rows = []
    for name, t in one.items():
        flops, nbytes = t["work"][0]
        row = _with_library(_row(
            name, f"src/repro_torch/csrc/{t['src']}.cu",
            "src/repro/kernels/attention/attention.py:72", worst[name],
            t["ms"], t["eager_ms"], t["plain_ms"], None, nbytes, flops,
            dtype), t["sdpa"])
        row["ms_last_rank"] = t["ms_last_rank"]
        row["bound_ms_last_rank"] = t["bound_ms_last_rank"]
        for key in ("parent_ms", "parent_ms_last_rank"):
            if key in t:
                row[key] = t[key]
        row["variant"] = K._flash_variant(t["src"], dtype, g["d"])
        row["shape"] = {"b": g["b"], "hq": g["hq"], "hkv": g["hkv"],
                        "sq": s, "blocks": len(offs), "block": lens[0],
                        "d": g["d"], "causal": True,
                        "logit_cap": g["logit_cap"]}
        t = b16[name]
        row["b16"] = {"b": SEQ_TRAIN_B, "ms": t["ms"],
                      "ms_last_rank": t["ms_last_rank"],
                      "plain_ms": t["plain_ms"],
                      "library_ms": (t["sdpa"]["ms"].get(t["sdpa"]["best"])
                                     if t["sdpa"]["best"] else None),
                      "library_backend": t["sdpa"]["best"],
                      "bound_ms": _bound(t["work"][0][1], t["work"][0][0],
                                         dtype)[0],
                      "bound_ms_last_rank": t["bound_ms_last_rank"]}
        for key in ("parent_ms", "parent_ms_last_rank"):
            if key in t:
                row["b16"][key] = t[key]
        log(f"[seq] {name} at B {SEQ_TRAIN_B}: {json.dumps(row['b16'])}; "
            f"{smi}")
        rows.append(row)
    return rows, launches


# ---------------------------------------------------------------------------
# the non-paged cache path, and the SSM, hybrid and enc-dec families
# ---------------------------------------------------------------------------

def _flash_counts_zeroed() -> None:
    from repro_torch.kernels.attention import attention as K
    for fn in (K.flash_attention, K.flash_attention_bwd):
        fn.launches = 0
        fn.cross_launches = 0
        fn.variants.clear()


def _flash_counts(bwd: bool = False) -> dict:
    """The forward wrapper's counts, or with ``bwd`` the backward's."""
    from repro_torch.kernels.attention import attention as K
    fn = K.flash_attention_bwd if bwd else K.flash_attention
    return {"launches": fn.launches, "cross_launches": fn.cross_launches,
            "variants": dict(fn.variants)}


def _flash_family(lib: str, dtype: torch.dtype, b: int, sq: int, sk: int,
                  hq: int, hkv: int, d: int, causal: bool) -> str:
    """The family the flash wrappers name for a whole-sequence call of
    ``lib`` at this shape: bf16 at D 64, 112 and 128 ``cluster`` where
    ``attention.split_ranks`` (the mirror of the library's chooser) splits
    it on this card's processors, else ``wgmma`` (and at D 256); float32
    at D 64 and 128 ``wgmma_tf32x3`` (three TF32 products); the CUDA
    cores for other widths."""
    from repro_torch.kernels.attention import attention as K

    if dtype == torch.float32 and d in (64, 128):
        return "wgmma_tf32x3"
    if dtype != torch.bfloat16 or d not in (64, 112, 128, 256):
        return "cuda_cores"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return "cluster" if K.split_ranks(lib, b, sq, sk, hq, hkv, d, dtype,
                                      causal=causal, sms=sms) > 1 \
        else "wgmma"


def _train_flash_counts(cfg, steps: int, batch: int, seq: int,
                        src_len: int = 0) -> tuple[dict, dict]:
    """The forward's and the backward's counts ``steps`` loss-and-gradient
    evaluations with remat make at B ``batch`` x S ``seq``: each layer's
    attention launches the forward twice (forward and recompute) and the
    backward once; the encoder (over ``src_len`` frames), the decoder's
    self- and cross-attention for encdec (the cross ones at Sq != Sk), the
    shared block once a group for the hybrid, nothing for the SSM; each
    call under the family ``_flash_family`` names for its shape (bf16:
    ``wgmma``, or ``cluster`` where the items fill few processors, as
    seamless's cross-attention and its decoder's backward do; float32
    ``wgmma_tf32x3`` at D 64 and 128, the CUDA cores at other widths)."""
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.family == "encdec":   # (calls an evaluation, Sq, Sk, causal)
        calls = [(cfg.n_enc_layers, src_len, src_len, False),
                 (cfg.n_layers, seq, seq, True),
                 (cfg.n_layers, seq, src_len, False)]
    elif cfg.family == "hybrid":
        calls = [(cfg.n_layers // cfg.attn_every, seq, seq, True)]
    elif cfg.family == "ssm":
        calls = []
    else:
        calls = [(cfg.n_layers, seq, seq, True)]

    def counts(lib, per_call):
        out = {"launches": 0, "cross_launches": 0,
               "variants": collections.Counter()}
        for n, sq, sk, causal in calls:
            n *= per_call * steps
            out["launches"] += n
            out["cross_launches"] += n if sq != sk else 0
            out["variants"][_flash_family(lib, cfg.dtype, batch, sq, sk, h,
                                          kv, d, causal)] += n
        out["variants"] = dict(out["variants"])
        return out

    return counts("flash_fwd", 2), counts("flash_bwd", 1)


def nonpaged_qwen3(cfg, params, rng: np.random.Generator) -> dict:
    """qwen3-0.6b (bf16, 28 layers) on the dense cache: ``prefill_decoder``
    over 8 prompts of 512 tokens (max_seq 1024; kernel 5, causal at D 128,
    one launch a layer, all ``wgmma``), then 32 greedy
    ``decode_step_decoder`` ticks.  The plain path (``use_kernel=False``)
    and the paged path (one prompt chunk a slot, ``decode_step_paged``
    ticks: kernels 2 and 1) take the same tokens: the plain logits within
    MODEL_ATOL, and both paths' tokens equal by the margin rule."""
    from repro_torch.models import (decode_step, decode_step_paged,
                                    paged_cache_leaf_specs, prefill,
                                    prefill_chunk)
    from repro_torch.serve.paging import init_pool

    tol = MODEL_ATOL[cfg.dtype]
    slots, n, max_seq, ticks, page = 8, 512, 1024, 32, 64
    prompts = torch.tensor(rng.integers(0, cfg.vocab, size=(slots, n)),
                           dtype=torch.int32, device="cuda")
    _flash_counts_zeroed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache, lens = prefill(params, cfg, {"tokens": prompts}, max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = _flash_counts()
    assert counts["launches"] == cfg.n_layers, counts
    assert counts["variants"] == {"wgmma": cfg.n_layers}, counts
    lg_p, cache_p, lens_p = prefill(params, cfg, {"tokens": prompts},
                                    max_seq, use_kernel=False)
    worst = max_err(lg, lg_p)
    assert margin_agrees(lg_p, lg.argmax(-1), tol)
    pools = init_pool(paged_cache_leaf_specs(cfg, page),
                      slots * max_seq // page, page, "cuda").pools
    bt = torch.arange(slots * max_seq // page, dtype=torch.int32,
                      device="cuda").reshape(slots, -1)
    lg_g = torch.stack([prefill_chunk(params, cfg, prompts[s:s + 1], 0,
                                      pools, bt[s])[0][-1]
                        for s in range(slots)])
    assert margin_agrees(lg_g, lg.argmax(-1), tol)
    cur, lens_g, decode_s = lg.argmax(-1).to(torch.int32), lens.clone(), 0.0
    for _ in range(ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache, lens = decode_step(params, cfg, cur[:, None], cache,
                                       lens)
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        out_p, cache_p, lens_p = decode_step(params, cfg, cur[:, None],
                                             cache_p, lens_p)
        out_g, pools = decode_step_paged(params, cfg, cur[:, None], pools,
                                         bt, lens_g)
        lens_g = lens_g + 1
        assert torch.isfinite(out).all()
        worst = max(worst, max_err(out, out_p))
        assert margin_agrees(out_p, out.argmax(-1), tol)
        assert margin_agrees(out_g, out.argmax(-1), tol)
        cur = out.argmax(-1).to(torch.int32)
    assert worst <= tol, ("non-paged logits", worst)
    assert torch.equal(lens, torch.full_like(lens, n + ticks))
    return {"arch": cfg.name, "layers": cfg.n_layers, "slots": slots,
            "prompt": n, "max_seq": max_seq, "ticks": ticks,
            "max_abs_logit_err_vs_plain": worst, "atol": tol,
            "prefill_s": prefill_s, "decode_ms_per_tick":
            1e3 * decode_s / ticks, "flash": counts}


def nonpaged_deepseek(cfg, params, rng: np.random.Generator) -> dict:
    """deepseek-v2 (bf16, published widths, 4 layers) on the dense latent
    cache against the paged latent path (kernels 4 and 3): per slot one
    128-token ``prefill_decoder`` and one ``prefill_chunk`` (the same MoE
    dispatch group: expert capacity depends on the tokens of a call), the
    caches joined, then 16 ticks of ``decode_step`` and
    ``decode_step_paged`` over the 8 slots, teacher-forced by the dense
    path's greedy tokens.  The dense path follows the paged path's expert
    choices (``RouterLog.forced``), so a router near tie cannot flip
    between them; logits within MODEL_ATOL and tokens by the margin
    rule."""
    from repro_torch.models import (decode_step, decode_step_paged,
                                    paged_cache_leaf_specs, prefill,
                                    prefill_chunk)
    from repro_torch.serve.paging import init_pool

    tol = MODEL_ATOL[cfg.dtype]
    slots, n, max_seq, ticks, page = 8, 128, 256, 16, 128
    prompts = torch.tensor(rng.integers(0, cfg.vocab, size=(slots, n)),
                           dtype=torch.int32, device="cuda")
    pools = init_pool(paged_cache_leaf_specs(cfg, page),
                      slots * max_seq // page, page, "cuda").pools
    bt = torch.arange(slots * max_seq // page, dtype=torch.int32,
                      device="cuda").reshape(slots, -1)
    worst, caches, last, last_g = 0.0, [], [], []

    def follow(log, tag):
        log.forced = collections.deque(c[0] for c in log.calls[tag])

    with RouterLog() as log:
        for s in range(slots):
            log.tag = ("prefill", s, "paged")
            last_g.append(prefill_chunk(params, cfg, prompts[s:s + 1], 0,
                                        pools, bt[s])[0][-1])
            follow(log, ("prefill", s, "paged"))
            log.tag = ("prefill", s, "dense")
            lg, cache_s, _ = prefill(params, cfg,
                                     {"tokens": prompts[s:s + 1]}, max_seq)
            log.forced = None
            last.append(lg[0])
            caches.append(cache_s)
        cache = {k: torch.cat([c[k] for c in caches], dim=1)
                 for k in caches[0]}
        del caches
        lg, lg_g = torch.stack(last), torch.stack(last_g)
        lens = torch.full((slots,), n, dtype=torch.int32, device="cuda")
        for t in range(ticks + 1):
            assert torch.isfinite(lg).all()
            worst = max(worst, max_err(lg, lg_g))
            assert margin_agrees(lg_g, lg.argmax(-1), tol), t
            if t == ticks:
                break
            cur = lg.argmax(-1).to(torch.int32)[:, None]
            log.tag = ("tick", t, "paged")
            lg_g, pools = decode_step_paged(params, cfg, cur, pools, bt,
                                            lens)
            follow(log, ("tick", t, "paged"))
            log.tag = ("tick", t, "dense")
            lg, cache, lens = decode_step(params, cfg, cur, cache, lens)
            log.forced = None
    assert worst <= tol, ("non-paged latent logits", worst)
    return {"arch": cfg.name, "layers": cfg.n_layers, "slots": slots,
            "prompt": n, "ticks": ticks, "atol": tol,
            "max_abs_logit_err_vs_paged": worst,
            "router_near_ties": sum(log.near_ties(tag, ROUTER_TOL[cfg.dtype])
                                    for tag in log.calls if tag[2] == "paged"),
            "router_prob_max_diff": max(
                log.prob_diff(tag, (tag[0], tag[1], "dense"))
                for tag in log.calls if tag[2] == "paged")}


SSM_BATCH, SSM_SEQ, SSM_DECODE = 2, 1024, 64
HYBRID_SEQ, HYBRID_DECODE = 2048, 64
ENCDEC_BATCH, ENCDEC_SRC, ENCDEC_TGT, ENCDEC_DECODE = 2, 1024, 256, 32


def _decode_against_forward(params, cfg, tokens, full, steps, tol) -> dict:
    """``decode_step`` from an empty state over the first ``steps`` tokens:
    each step's tokens equal the forward's at that position by the margin
    rule; returns the largest logit difference and the decode time."""
    from repro_torch.models import decode_step, init_cache

    b = tokens.shape[0]
    state = init_cache(cfg, b, tokens.shape[1], device="cuda")
    lens = torch.zeros((b,), dtype=torch.int32, device="cuda")
    worst = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        lg, state, lens = decode_step(params, cfg, tokens[:, t:t + 1], state,
                                      lens)
        assert torch.isfinite(lg).all()
        worst = max(worst, max_err(lg, full[:, t]))
        assert margin_agrees(full[:, t], lg.argmax(-1), tol), t
    torch.cuda.synchronize()
    return {"decode_steps": steps, "max_abs_logit_err_decode_vs_forward":
            worst, "decode_ms_per_step":
            1e3 * (time.perf_counter() - t0) / steps}


def ssm_model(cfg, seed: int, rng: np.random.Generator) -> list[dict]:
    """mamba2-780m at full width (48 layers, d_model 1536, d_state 128),
    B 2 x S 1024 in chunks of 256: the forward, then decode from an empty
    state over the first 64 tokens, each step against the forward's
    logits at its position: by the margin rule in bf16, and within
    MODEL_ATOL in f32, where only the order of the f32 sums differs
    (chunked scan against the recurrence).  No kernel runs: the family is
    attention-free, as in ``repro``."""
    from repro_torch.models import forward, init_params, param_count

    out = []
    tokens = torch.tensor(rng.integers(0, cfg.vocab,
                                       size=(SSM_BATCH, SSM_SEQ)),
                          dtype=torch.int32, device="cuda")
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, param_dtype=dtype)
        tol = MODEL_ATOL[c.dtype]
        params = init_params(c, seed=seed, device="cuda")
        _flash_counts_zeroed()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = forward(params, c, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        assert torch.isfinite(full).all()
        res = {"arch": c.name, "dtype": dtype, "params": param_count(params),
               "batch": SSM_BATCH, "seq": SSM_SEQ, "chunk": c.ssm.chunk,
               "forward_s": fwd_s, "atol": tol,
               **_decode_against_forward(params, c, tokens, full,
                                         SSM_DECODE, tol)}
        assert _flash_counts()["launches"] == 0
        if c.dtype == torch.float32:
            assert res["max_abs_logit_err_decode_vs_forward"] <= tol, res
        out.append(res)
        del params, full
        torch.cuda.empty_cache()
    return out


def hybrid_model(cfg, seed: int, rng: np.random.Generator) -> dict:
    """zamba2-7b at full width (81 Mamba-2 layers in 9 groups, d_model 3584,
    the shared block's 32 heads at D 112), bf16, B 1 x S 2048: the forward
    through kernel 5 (9 launches, the shared block once a group, on wgmma
    at D 112, padded to 128) within MODEL_ATOL of the plain path, then 64
    decode steps from an empty state against the forward by the margin
    rule."""
    from repro_torch.models import forward, init_params, param_count

    tol = MODEL_ATOL[cfg.dtype]
    params = init_params(cfg, seed=seed, device="cuda")
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(1, HYBRID_SEQ)),
                          dtype=torch.int32, device="cuda")
    _flash_counts_zeroed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = forward(params, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    counts = _flash_counts()
    n_groups = cfg.n_layers // cfg.attn_every
    assert counts["launches"] == n_groups, counts
    assert counts["variants"] == {"wgmma": n_groups}, counts
    plain = forward(params, cfg, {"tokens": tokens}, use_kernel=False)
    err = max_err(full, plain)
    assert margin_agrees(plain, full.argmax(-1), tol)
    del plain
    res = {"arch": cfg.name, "params": param_count(params),
           "dtype": str(cfg.dtype), "seq": HYBRID_SEQ, "groups": n_groups,
           "forward_s": fwd_s, "max_abs_logit_err_vs_plain": err,
           "atol": tol, "flash": counts,
           **_decode_against_forward(params, cfg, tokens, full,
                                     HYBRID_DECODE, tol)}
    assert err <= tol, res
    del params, full
    torch.cuda.empty_cache()
    return res


def encdec_model(cfg, seed: int, rng: np.random.Generator) -> dict:
    """seamless-m4t-medium at full width (12 + 12 layers, d_model 1024, 16
    heads at D 64, vocab 256,206), bf16: B 2, 1024 source frames drawn from
    the seed, 256 target tokens.  The forward runs kernel 5 three ways
    (the encoder without a mask, the decoder's causal self-attention and
    its cross-attention at Sq 256 against Sk 1024: 36 launches, 12 of them
    cross, on ``cluster``, the rest on ``wgmma``) within MODEL_ATOL of the
    plain path; then
    ``prefill`` (the encoder and every layer's cross K/V) and 32 greedy
    decode steps, each against the teacher-forced forward over the decoded
    tokens by the margin rule."""
    from repro_torch.models import (decode_step, forward, init_params,
                                    param_count, prefill)

    tol = MODEL_ATOL[cfg.dtype]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, seed=seed, device="cuda")
    src = torch.randn(ENCDEC_BATCH, ENCDEC_SRC, cfg.d_model, generator=gen,
                      device="cuda").to(cfg.dtype)
    tokens = torch.tensor(rng.integers(0, cfg.vocab,
                                       size=(ENCDEC_BATCH, ENCDEC_TGT)),
                          dtype=torch.int32, device="cuda")
    _flash_counts_zeroed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = forward(params, cfg, {"src_emb": src, "tokens": tokens})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    counts = _flash_counts()
    per_forward = cfg.n_enc_layers + 2 * cfg.n_layers
    # the cross-attention's 64 items take the split family
    want = collections.Counter()
    for n, sq, sk, causal in ((cfg.n_enc_layers, ENCDEC_SRC, ENCDEC_SRC,
                               False),
                              (cfg.n_layers, ENCDEC_TGT, ENCDEC_TGT, True),
                              (cfg.n_layers, ENCDEC_TGT, ENCDEC_SRC, False)):
        want[_flash_family("flash_fwd", cfg.dtype, ENCDEC_BATCH, sq, sk,
                           cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           causal)] += n
    assert want["cluster"] == cfg.n_layers, want
    assert counts == {"launches": per_forward,
                      "cross_launches": cfg.n_layers,
                      "variants": dict(want)}, counts
    plain = forward(params, cfg, {"src_emb": src, "tokens": tokens},
                    use_kernel=False)
    err = max_err(full, plain)
    assert margin_agrees(plain, full.argmax(-1), tol)
    del plain, full
    _, cache, lens = prefill(params, cfg, {"src_emb": src}, ENCDEC_DECODE)
    cur = torch.zeros((ENCDEC_BATCH, 1), dtype=torch.int32, device="cuda")
    fed, logits = [cur], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENCDEC_DECODE):
        lg, cache, lens = decode_step(params, cfg, cur, cache, lens)
        cur = lg.argmax(-1, keepdim=True).to(torch.int32)
        fed.append(cur)
        logits.append(lg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    teacher = forward(params, cfg, {"src_emb": src,
                                    "tokens": torch.cat(fed[:-1], 1)})
    dec = torch.stack(logits, 1)
    assert torch.isfinite(dec).all()
    assert margin_agrees(teacher, dec.argmax(-1), tol)
    counts = _flash_counts()
    res = {"arch": cfg.name, "params": param_count(params),
           "dtype": str(cfg.dtype), "batch": ENCDEC_BATCH,
           "src_frames": ENCDEC_SRC, "tgt_tokens": ENCDEC_TGT,
           "forward_s": fwd_s, "max_abs_logit_err_vs_plain": err,
           "atol": tol, "decode_steps": ENCDEC_DECODE,
           "decode_ms_per_step": 1e3 * decode_s / ENCDEC_DECODE,
           "max_abs_logit_err_decode_vs_teacher_forced":
           max_err(dec, teacher), "flash": counts}
    assert err <= tol, res
    # the phase's forward, prefill's encoder and the teacher-forced
    # forward; the cross launches are the two forwards'
    assert counts["cross_launches"] == 2 * cfg.n_layers, counts
    del params, teacher, cache
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 8-9: training at full width
# ---------------------------------------------------------------------------

def _loss_and_grads(params, cfg, batch, use_kernel: bool):
    """loss_fn and the gradient of every leaf, on one path."""
    from repro_torch.models import loss_fn
    from repro_torch.optim.adamw import tree_leaves, tree_map

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = loss_fn(tree_map(lambda _: next(it), params), cfg, batch,
                      remat=True, use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.float() for g in grads]


def train_step_parity(cfg, seed: int, batch: int = TRAIN_BATCH,
                      seq: int = TRAIN_SEQ, src_len: int = 0) -> dict:
    """One loss-and-gradient evaluation at B ``batch`` x S ``seq`` (and
    ``src_len`` source frames for encdec, drawn by the data pipeline as
    ``launch.train`` draws them) through the flash kernels and through the
    plain path (the port's chunked ``layers.attention`` on CUDA,
    ``use_kernel=False``), on the same weights and batch: full-width
    qwen3-0.6b, and the new families' training cells.  Compared: the loss,
    the global gradient norm, and each leaf's gradient (max abs error over
    the leaf's max |g| in float32; cosine similarity in bf16, where a
    random-init model carries each layer's rounding through its depth),
    within TRAIN_PARITY_TOL.  The kernel path's flash counts must be those
    of one evaluation with remat (``_train_flash_counts``)."""
    from repro_torch.data.pipeline import DataConfig, global_batch_rowwise
    from repro_torch.models import init_params

    tol = TRAIN_PARITY_TOL[cfg.dtype]
    params = init_params(cfg, seed=seed, device="cuda")
    data = global_batch_rowwise(
        DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                   seed=seed, src_len=src_len), 0, d_model=cfg.d_model,
        device="cuda")
    _flash_counts_zeroed()
    loss_k, grads_k = _loss_and_grads(params, cfg, data, True)
    counts = (_flash_counts(), _flash_counts(bwd=True))
    loss_p, grads_p = _loss_and_grads(params, cfg, data, False)
    norm_k = math.sqrt(sum(float(g.square().sum()) for g in grads_k))
    norm_p = math.sqrt(sum(float(g.square().sum()) for g in grads_p))
    rel, cos = [], []
    for gk, gp in zip(grads_k, grads_p):
        rel.append(max_err(gk, gp) / max(float(gp.abs().max()), 1e-30))
        cos.append(float(torch.nn.functional.cosine_similarity(
            gk.flatten(), gp.flatten(), dim=0)))
    result = {"arch": cfg.name, "dtype": str(cfg.dtype),
              "layers": cfg.n_layers, "batch": batch, "seq": seq,
              "src_len": src_len, "loss_kernel": loss_k,
              "loss_plain": loss_p, "loss_abs_err": abs(loss_k - loss_p),
              "grad_norm_kernel": norm_k, "grad_norm_plain": norm_p,
              "grad_norm_rel_err": abs(norm_k - norm_p) / norm_p,
              "leaf_rel_err_max": max(rel), "leaf_cosine_min": min(cos),
              "leaves": len(rel), "tol": tol,
              "flash": {"forward": counts[0], "backward": counts[1]}}
    log(f"[train-parity] kernel path vs plain path: {json.dumps(result)}")
    del params, grads_k, grads_p
    torch.cuda.empty_cache()
    assert math.isfinite(loss_k) and math.isfinite(norm_k), result
    assert counts == _train_flash_counts(cfg, 1, batch, seq, src_len), result
    assert result["loss_abs_err"] <= tol["loss"], result
    assert result["grad_norm_rel_err"] <= tol["grad_norm"], result
    if "leaf_rel" in tol:
        assert result["leaf_rel_err_max"] <= tol["leaf_rel"], result
    else:
        assert result["leaf_cosine_min"] >= tol["leaf_cosine"], result
    return result


def train_family(cfg, seed: int, smi: str, batch: int, seq: int,
                 src_len: int = 0, check_counts: bool = True) -> dict:
    """``Trainer`` (the code ``launch.train`` runs) on a new family's
    training cell: FAMILY_TRAIN_STEPS steps at B ``batch`` x S ``seq`` (and
    ``src_len`` source frames), remat on, AdamW with the launcher's
    defaults.  Every step's loss finite; the flash kernels' counts zeroed
    just before and read just after, those of the steps with remat
    (``_train_flash_counts``) unless ``check_counts`` is off (the parent's
    kernels name other variants)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                      seed=seed, src_len=src_len)
    tcfg = TrainConfig(opt=AdamWConfig(total_steps=FAMILY_TRAIN_STEPS))
    trainer = Trainer(cfg, tcfg, dcfg, log_every=1, device="cuda")
    params, state = trainer.init(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _flash_counts_zeroed()
    params, state, history = trainer.run(FAMILY_TRAIN_STEPS, params=params,
                                         state=state)
    torch.cuda.synchronize()
    counts = (_flash_counts(), _flash_counts(bwd=True))
    result = {"arch": cfg.name, "layers": cfg.n_layers, "dtype":
              str(cfg.dtype), "params": param_count(params), "batch": batch,
              "seq": seq, "src_len": src_len, "steps": FAMILY_TRAIN_STEPS,
              "loss": [h["loss"] for h in history],
              "step_time_s": [h["step_time_s"] for h in history],
              "grad_norm": [h["grad_norm"] for h in history],
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "flash": {"forward": counts[0], "backward": counts[1]}}
    log(f"[train-family] {json.dumps(result)}; card: {smi}")
    del params, state, trainer
    torch.cuda.empty_cache()
    assert all(math.isfinite(x) for x in result["loss"]), result
    if check_counts:
        assert counts == _train_flash_counts(cfg, FAMILY_TRAIN_STEPS, batch,
                                             seq, src_len), result
    return result


# gemma2-2b's training cell (phase 9d): full width, 2 of its 26 layers (a
# local one, window 4096, and a global one), B 1 x S 4096, bf16: the path
# of kernels 5 and 5b at D 256 (rows 5@256 and 5b@256)
GEMMA_TRAIN = {"batch": 1, "seq": 4096}
GEMMA_TRAIN_LAYERS = 2


def gemma2_train(seed: int, smi: str,
                 parent: ParentKernels | None = None) -> dict:
    """gemma2-2b at GEMMA_TRAIN_LAYERS layers: one loss-and-gradient
    evaluation through the kernels against the plain path
    (``train_step_parity``, TRAIN_PARITY_TOL, the flash counts all
    ``wgmma``), then ``Trainer`` steps (``train_family``), and, given
    ``parent``, the same steps through the parent's flash libraries (its
    D-256 kernels) for their step times.  Returns the current steps'
    result, the parent's step times under "parent_step_time_s"."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("gemma2-2b"),
                              n_layers=GEMMA_TRAIN_LAYERS)
    train_step_parity(cfg, seed, **GEMMA_TRAIN)
    result = train_family(cfg, seed, smi, **GEMMA_TRAIN)
    if parent is not None:
        with parent.flash_libraries():
            theirs = train_family(cfg, seed, smi, check_counts=False,
                                  **GEMMA_TRAIN)
        result["parent_step_time_s"] = theirs["step_time_s"]
        result["parent_flash"] = theirs["flash"]
        log(f"[gemma2-train] step time s: kernels {result['step_time_s']}, "
            f"parent's kernels {theirs['step_time_s']}; card: {smi}")
    return result


def _kernel_group(name: str) -> str:
    if any(k in name for k in ("flash_wgmma::fwd", "flash_mma::fwd",
                               "flash_fwd_kernel")):
        return "flash_attention"
    if any(k in name for k in ("flash_wgmma::dq", "flash_wgmma::dkv",
                               "flash_dq_kernel", "flash_dkv_kernel",
                               "delta_kernel")):
        return "flash_attention_bwd"
    if any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profile_step(cfg, params, state, trainer, mean_step_s: float) -> dict:
    """One more train step under ``torch.profiler``: device time per kernel
    group (the two flash kernels, matrix products, and everything else:
    elementwise, reductions, copies), summed over the device-side kernel
    events, the flash groups' time by kernel (forward, Delta, dQ pass,
    dK/dV pass), and the device's busy share over the profiled step's
    wall time and over the unprofiled mean step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import global_batch_rowwise
    from repro_torch.launch.flash_bench import kernel_name
    from repro_torch.train import train_step

    batch = global_batch_rowwise(trainer.dcfg, TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(params, state, batch, cfg=cfg, tcfg=trainer.tcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict[str, float] = collections.defaultdict(float)
    flash: dict[str, float] = collections.defaultdict(float)
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        group = _kernel_group(e.name)
        groups[group] += e.device_time_total / 1e3
        if group.startswith("flash"):
            flash[kernel_name(e.name)] += e.device_time_total / 1e3
        n_kernels += 1
    busy_ms = sum(groups.values())
    return {"wall_ms_profiled": wall * 1e3, "device_ms": busy_ms,
            "kernels": n_kernels,
            "device_ms_by_group": dict(sorted(groups.items())),
            "flash_device_ms_by_kernel": dict(sorted(flash.items())),
            "busy_share_profiled": busy_ms / (wall * 1e3),
            "busy_share_of_mean_step": busy_ms / (mean_step_s * 1e3)}


def train(cfg, seed: int, smi: str) -> dict:
    """``Trainer`` (the code ``launch.train`` runs) on full-width
    qwen3-0.6b: TRAIN_STEPS steps at B 2 x S 4096, remat on, AdamW with
    the launcher's defaults.  The flash kernels' launch counts are zeroed
    just before and read just after: with remat, each step launches the
    forward kernel twice per layer (forward and recompute) and the
    backward kernel once.  Then the parameters go through the port's
    checkpoint and must come back bit for bit."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.attention import attention as K
    from repro_torch.models import active_param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, Trainer

    dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab=cfg.vocab, seed=seed)
    tcfg = TrainConfig(opt=AdamWConfig(total_steps=TRAIN_STEPS))
    trainer = Trainer(cfg, tcfg, dcfg, log_every=1, device="cuda")
    params, state = trainer.init(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.flash_attention.launches = 0
    K.flash_attention_bwd.launches = 0
    K.flash_attention.variants.clear()
    K.flash_attention_bwd.variants.clear()
    params, state, history = trainer.run(TRAIN_STEPS, params=params,
                                         state=state)
    torch.cuda.synchronize()
    launches = {"flash_attention": K.flash_attention.launches,
                "flash_attention_bwd": K.flash_attention_bwd.launches}
    variants = {"flash_attention": dict(K.flash_attention.variants),
                "flash_attention_bwd": dict(K.flash_attention_bwd.variants)}
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [h["step_time_s"] for h in history[1:]]
    mean_s = sum(steady) / len(steady)
    n_active = active_param_count(cfg, params)
    flops_per_s = 6 * n_active * tokens / mean_s
    result = {"arch": cfg.name, "layers": cfg.n_layers, "dtype":
              str(cfg.dtype), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "steps": TRAIN_STEPS,
              "loss": [h["loss"] for h in history],
              "step_time_s": [h["step_time_s"] for h in history],
              "grad_norm": [h["grad_norm"] for h in history],
              "mean_step_s_steps_2_on": mean_s,
              "tokens_per_s_steps_2_on": tokens / mean_s,
              "params_active": n_active,
              "model_flops_per_s": flops_per_s,
              "model_flops_share_of_989e12": flops_per_s / PEAK_FLOPS[
                  torch.bfloat16],
              "peak_memory_bytes": peak, "launches": launches,
              "launches_by_variant": variants}
    log(f"[train] {json.dumps(result)}; card: {smi}")
    assert all(math.isfinite(x) for x in result["loss"]), result
    want = {"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    assert launches == want, (launches, want)
    # bf16 at head_dim 128: every launch took the wgmma kernels
    assert variants == {n: {"wgmma": c} for n, c in want.items()}, variants
    result["profile"] = profile_step(cfg, params, state, trainer, mean_s)
    log(f"[train] one more step under torch.profiler: "
        f"{json.dumps(result['profile'])}")
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent
                                     / "build") as d:
        ckpt.save(d, TRAIN_STEPS, params)
        back, _ = ckpt.restore(d, TRAIN_STEPS, params)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(back), tree_leaves(params))), \
            "checkpoint round trip is not bit-exact"
    log(f"[train] checkpoint round trip of {len(tree_leaves(params))} "
        f"leaves bit-exact")
    return result


# ---------------------------------------------------------------------------
# phase 3, continued: the PACO kernels (matmul, LCS tile)
# ---------------------------------------------------------------------------

def _rel_mm(got: torch.Tensor, want: torch.Tensor) -> float:
    if want.numel() == 0:
        return 0.0
    return max_err(got, want) / max(1.0, want.float().abs().max().item())


def _cuboid_faces(a: torch.Tensor, b: torch.Tensor, plan):
    """(A face, B face) views of each non-empty cuboid of a plan."""
    return [(a[c.n0:c.n1, c.k0:c.k1], b[c.k0:c.k1, c.m0:c.m1])
            for _, c in plan.tiles if c.volume()]


def _symbols(gen: torch.Generator, *shape: int) -> torch.Tensor:
    """int32 sequences over a 4-letter alphabet (DNA), on the card."""
    return torch.randint(0, 4, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _random_borders(gen: torch.Generator, *shape: int, monotone: bool
                    ) -> torch.Tensor:
    """int32 border values: sorted small values along the last axis, as
    ``tests/test_kernels.py:114`` draws them, or any int32 (the kernel's
    function is defined on every input), INT32_MAX and INT32_MIN among
    them."""
    if monotone:
        x = torch.randint(0, 3, shape, generator=gen, device="cuda")
        return torch.sort(x, dim=-1).values.to(torch.int32)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                      device="cuda", dtype=torch.int32)
    x[..., ::7] = 2 ** 31 - 1      # sums that wrap
    x[..., 3::11] = -2 ** 31
    return x


def check_paco_kernels(gen: torch.Generator) -> dict[str, float]:
    """Both PACO kernels against their plain versions.  Matmul, f32 and
    bf16: small, odd and prime shapes (1 x 1 x 1, 17 x 23 x 31,
    97 x 131 x 61, ...), k = 0, strided views, and every cuboid of
    ``plan_mm_1piece(8192, 8192, 8192, 132)`` as a view of the full
    operands (MM_TOL); the plan kernel on the 8192^3 plans at p = 132 and
    131 and on small prime plans with k-cuts, against ``matmul_plan_ref``
    (MM_TOL) and bitwise equal over two calls.  LCS, exact, one launch each:
    single tiles of 1, 7, 64, 256 and 8192 (and ragged M x N, and tiles
    taller or wider than one CTA takes) on monotone and on arbitrary int32
    borders; whole tables in tiles of 1, 7, 128, 256 and 8192 on arbitrary
    borders; and the main path's table, PACO_LCS_N^2 in tiles of 256
    (256 x 256 tiles, as many CTAs claiming and waiting as fit), on
    arbitrary borders: its whole bottom row and right column against
    ``lcs_table_plain`` (``lcs_tiles_ref`` batched per anti-diagonal) on
    the same CUDA tensors, bitwise the same over two calls."""
    from repro_torch.core import plan_mm_1piece
    from repro_torch.core.matmul import plan as mm_plan
    from repro_torch.kernels.lcs import lcs as KL
    from repro_torch.kernels.lcs.ref import lcs_tile_ref, lcs_tiles_ref
    from repro_torch.kernels.matmul import (matmul_kernel, matmul_plan_kernel,
                                            matmul_plan_ref)
    from repro_torch.kernels.matmul.ref import matmul_ref

    dev = "cuda"
    worst = {"matmul": 0.0, "matmul_plan": 0.0, "lcs_tile": 0}
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)

        # k = 8192: the long sum that a single accumulator over all of k
        # let drift past MM_TOL (csrc/matmul.cu, "wgmma_tf32x3")
        pairs = [(rnd(n, k), rnd(k, m)) for n, k, m in
                 [(1, 1, 1), (17, 23, 31), (97, 131, 61), (128, 32, 128),
                  (129, 33, 257), (300, 700, 5), (5, 0, 7), (1, 4099, 3),
                  (128, 8192, 128)]]
        # views: row strides of 400 and 500 give each a 16-byte phase; 61
        # gives none
        big_a, big_b, odd = rnd(300, 400), rnd(400, 500), rnd(40, 61)
        pairs += [(big_a[3:200, 7:190], big_b[5:188, 11:300]),
                  (big_a[1:2, 1:400], big_b[1:400, 499:500]),
                  (big_a[::2, 8:136], big_b[8:136, 128:384]),
                  (big_a[:, 5:], big_b[5:, 3:]),
                  (odd[:, 2:], big_b[:59, 1:9])]
        n = PACO_MM_N
        a, b = rnd(n, n), rnd(n, n)
        pairs += _cuboid_faces(a, b, plan_mm_1piece(n, n, n, 132))
        variant = "wgmma_tf32x3" if dtype == torch.float32 else "mma_sync"
        for x, y in pairs:
            before = matmul_kernel.variants.copy()
            got = matmul_kernel(x, y)
            assert matmul_kernel.variants - before == {variant: 1}, \
                ("matmul variant", dtype, matmul_kernel.variants - before)
            assert torch.equal(got, matmul_kernel(x, y)), \
                ("matmul is not bitwise reproducible", tuple(x.shape))
            err = _rel_mm(got, matmul_ref(x, y))
            assert err <= MM_TOL[dtype], ("matmul", dtype, tuple(x.shape),
                                          x.stride(), tuple(y.shape), err)
            worst["matmul"] = max(worst["matmul"], err)
        # the plan kernel: the 8192^3 plans of the main path, then small
        # prime plans (k-cuts shared by 2 to 4 cuboids) and a view whose
        # base is off 16 bytes (mma_sync); bitwise equal over two calls
        plans = [(a, b, mm_plan(n, n, n, p)) for p in (132, 131)]
        for (nn, kk, mm), p in [((64, 64, 64), 5), ((64, 64, 64), 13),
                                ((61, 97, 67), 12), ((97, 131, 61), 7),
                                ((1000, 776, 904), 13)]:
            x, y = rnd(nn, kk), rnd(kk, mm)
            plans.append((x, y, mm_plan(nn, mm, kk, p)))
        plans.append((big_a[3:200, 7:190], big_b[5:188, 11:300],
                      mm_plan(197, 289, 183, 6)))
        for x, y, pl in plans:
            before = matmul_plan_kernel.variants.copy()
            got = matmul_plan_kernel(x, y, pl)
            if dtype == torch.float32:
                assert matmul_plan_kernel.variants - before == {
                    "wgmma_tf32x3": 1}, matmul_plan_kernel.variants - before
            assert torch.equal(got, matmul_plan_kernel(x, y, pl)), \
                ("matmul_plan is not bitwise reproducible", pl.n, pl.p)
            err = _rel_mm(got, matmul_plan_ref(x, y, pl))
            assert err <= MM_TOL[dtype], ("matmul_plan", dtype, pl.n, pl.m,
                                          pl.k, pl.p, err)
            worst["matmul_plan"] = max(worst["matmul_plan"], err)
        del a, b, pairs, plans
    torch.cuda.synchronize()

    for m, n in [(1, 1), (7, 7), (64, 64), (256, 256), (8192, 8192),
                 (5, 300), (300, 5), (33, 8200), (8200, 33)]:
        for monotone in (True, False):
            s, t = _symbols(gen, m), _symbols(gen, n)
            top = _random_borders(gen, n, monotone=monotone)
            left = _random_borders(gen, m, monotone=monotone)
            corner = (torch.minimum(top[:1], left[:1]) if monotone else
                      _random_borders(gen, 1, monotone=False))
            got = KL.lcs_tile_kernel(s, t, top, left, corner)
            want = lcs_tile_ref(s, t, top, left, corner)
            for g, w in zip(got, want):
                assert torch.equal(g, w), ("lcs_tile", m, n, monotone)

    # whole tables in one launch: tiles 1, 7, 128, 256 and 8192 (ragged
    # where they do not divide), arbitrary borders, as one tile of the plain
    # version
    for tile, m, n in [(1, 23, 41), (7, 61, 45), (128, 300, 520),
                       (256, 700, 600), (8192, 9000, 8500)]:
        s, t = _symbols(gen, m), _symbols(gen, n)
        top, left = (_random_borders(gen, x, monotone=False) for x in (n, m))
        corner = _random_borders(gen, 1, monotone=False)
        want = lcs_tiles_ref(s[None], t[None], top[None], left[None], corner)
        before = KL.lcs_table_kernel.launches
        got = KL.lcs_table_kernel(s, t, top, left, corner, tile, tile)
        assert KL.lcs_table_kernel.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w[0]), ("lcs_table", tile)

    # the main path's table on arbitrary borders: 256 x 256 tiles of 256,
    # the whole bottom row and right column against the plain version
    n, tile = PACO_LCS_N, 256
    s, t = _symbols(gen, n), _symbols(gen, n)
    args = (s, t, *(_random_borders(gen, x, monotone=False)
                    for x in (n, n, 1)), tile, tile)
    before = KL.lcs_table_kernel.launches
    got = KL.lcs_table_kernel(*args)
    again = KL.lcs_table_kernel(*args)
    assert KL.lcs_table_kernel.launches == before + 2
    t0 = time.perf_counter()
    want = KL.lcs_table_plain(*args)
    torch.cuda.synchronize()
    log(f"[kernels] lcs_table {n}^2 in tiles of {tile} on arbitrary borders: "
        f"plain version {time.perf_counter() - t0:.1f} s")
    for g, a, w, side in zip(got, again, want, ("bottom row", "right column")):
        assert torch.equal(g, a), ("lcs_table is not bitwise reproducible",
                                   side)
        assert torch.equal(g, w), ("lcs_table", n, tile, side,
                                   int((g != w).sum()))
    return worst


def bench_paco_kernels(gen: torch.Generator, iters: int,
                       parent: ParentKernels | None = None) -> list[dict]:
    """Both PACO kernels at the shapes their main path gives them.

    Matmul plan (``matmul_plan``): one launch over the 132 cuboids of
    ``plan_mm_1piece(8192, 8192, 8192, 132)`` in bf16 (131 beside it), its
    variant, against the plain version (``matmul_plan_ref``: 132 products
    and adds) and one library call computing the same function
    (``torch.matmul`` on the whole operands; ``torch.matmul`` on the 132
    views beside it).  In turns: kernel, parent (given ``parent``: its 132
    cuboid launches, those plus the adds into C that its ``paco_matmul``
    made, and its one plan launch), library, library, parent, kernel.
    Float32 rows of their own, the same turns (the parent: its one f32
    plan launch), the library ``torch.matmul`` in true f32:
    ``matmul_plan_f32`` (8192^3, p = 131 beside it),
    ``matmul_plan_f32_tall`` (65536 x 8192 x 512, p = 132) and the
    Strassen leaf (``matmul``, one 2048^3 product); their bound three TF32
    products at 495 TFLOP/s (``_row``), ``bound_cuda_cores_ms`` one true
    f32 product at 67.  LCS: the whole
    n = 65,536 table at p = 132 (tiles of 256), one launch a call, bitwise
    over two calls, in turns with the parent's (given ``parent``: one
    launch an anti-diagonal, 511), its variant, p = 131, PO, PA and both
    runs beside it; the plain version is the row scan ``lcs_reference``
    (host clock, once); no library call computes this function.  Kernel
    times: CUDA-graph replays; the plain versions eagerly with CUDA events
    (LCS: the host clock).  Bounds: matmul
    2 n m k flops (bytes: A and B read once, C written once); LCS
    LCS_OPS_PER_CELL int32 operations a cell."""
    from repro_torch.core.matmul import plan as mm_plan
    from repro_torch.kernels.lcs import lcs as KL
    from repro_torch.kernels.matmul import (matmul_kernel, matmul_plan_kernel,
                                            matmul_plan_ref)
    from repro_torch.kernels.matmul.matmul import plan_variant
    from repro_torch.kernels.matmul.ref import matmul_ref

    dev = "cuda"
    n = PACO_MM_N
    src = "src/repro_torch/csrc/matmul.cu"
    replaces = "src/repro/kernels/matmul/matmul.py:35"

    def mean(xs):
        return sum(xs) / len(xs)

    def plan_row(name, a, b, plan, work):
        """The plan kernel on (a, b) in turns: kernel, parent (given
        ``parent``: its one ``matmul_plan`` launch; in bf16 also its
        ``matmul`` launched once a cuboid, with and without the adds into C
        that a ``paco_matmul`` of one launch a cuboid made), library,
        library, parent, kernel."""
        dtype = a.dtype
        (nn, k), m = a.shape, b.shape[1]
        faces = _cuboid_faces(a, b, plan)
        want = matmul_plan_ref(a, b, plan)
        got = matmul_plan_kernel(a, b, plan)
        err = _rel_mm(got, want)
        # bf16 is the parent's kernel: the same bits
        same = (None if parent is None else
                torch.equal(got, parent.matmul_plan(a, b, plan)))
        assert same is not False or dtype != torch.bfloat16, \
            ("the bf16 plan is not the parent's bit for bit", name)
        del want, got
        times = collections.defaultdict(list)

        def kernel_turn():
            times["k"].append(time_ms(
                lambda i: matmul_plan_kernel(a, b, plan), 3))

        def parent_turn():
            if parent is None:
                return
            times["pl"].append(time_ms(
                lambda i: parent.matmul_plan(a, b, plan), 3)[0])
            if dtype != torch.bfloat16:
                return
            parts = [torch.empty((x.shape[0], y.shape[1]), dtype=dtype,
                                 device=dev) for x, y in faces]
            times["p"].append(time_ms(lambda i: [
                parent.matmul(x, y, o) for (x, y), o in zip(faces, parts)],
                3)[0])
            out = torch.empty((nn, m), dtype=dtype, device=dev)

            def with_adds(i):
                out.zero_()
                for (x, y), o, (_, c) in zip(faces, parts, (
                        t for t in plan.tiles if t[1].volume())):
                    parent.matmul(x, y, o)
                    out[c.n0:c.n1, c.m0:c.m1] += o
            times["pp"].append(time_ms(with_adds, 3)[0])
            del parts, out

        def library_turn():
            times["l"].append(_events_loop_ms(lambda: a @ b, 3))
            if dtype == torch.bfloat16:
                times["lv"].append(_events_loop_ms(
                    lambda: [x @ y for x, y in faces], 3))

        kernel_turn()
        parent_turn()
        library_turn()
        library_turn()
        parent_turn()
        kernel_turn()
        plain = _events_loop_ms(lambda: matmul_plan_ref(a, b, plan), 2)
        flops, nbytes = W.matmul_work(nn, m, k, a.element_size())
        row = _row(name, src, replaces, err, mean([t[0] for t in times["k"]]),
                   mean([t[1] for t in times["k"]]), plain, mean(times["l"]),
                   nbytes, flops, dtype)
        row["ms_turns"] = [t[0] for t in times["k"]]
        row["library_ms_turns"] = times["l"]
        row["variant"] = plan_variant(a, b)
        if dtype != torch.float32:
            row["library_views_ms"] = mean(times["lv"])
        if parent is not None:
            row["parent_bitwise"] = same
            if dtype == torch.bfloat16:
                row["parent_ms"] = mean(times["p"])
                row["parent_ms_turns"] = times["p"]
                row["parent_with_adds_ms"] = mean(times["pp"])
                row["parent_plan_ms"] = mean(times["pl"])
            else:
                row["parent_ms"] = mean(times["pl"])
                row["parent_ms_turns"] = times["pl"]
        row["work"] = work
        return row

    # the 8192^3 plan at p = 132 in bf16 and in float32 (p = 131 beside
    # each), then the tall float32 plan at p = 132
    rows = []
    plan = mm_plan(n, n, n, 132)
    plan131 = mm_plan(n, n, n, 131)
    for dtype, name in ((torch.bfloat16, "matmul_plan"),
                        (torch.float32, "matmul_plan_f32")):
        a = torch.randn(n, n, generator=gen, device=dev).to(dtype)
        b = torch.randn(n, n, generator=gen, device=dev).to(dtype)
        row = plan_row(name, a, b, plan,
                       f"one launch over the {len(plan.tiles)} cuboids of "
                       f"plan_mm_1piece({n}, {n}, {n}, 132), "
                       f"{str(dtype)[6:]}")
        row["p131_ms"] = time_ms(
            lambda i: matmul_plan_kernel(a, b, plan131), 3)[0]
        rows.append(row)
        del a, b
        torch.cuda.empty_cache()
    if parent is not None:   # the bf16 single product, the parent's bits
        for shape in ((1, 1, 1), (17, 23, 31), (129, 33, 257),
                      (1024, 1985, 2048)):
            x, y = (torch.randn(*s, generator=gen, device=dev).bfloat16()
                    for s in (shape[:2], shape[1:]))
            o = torch.empty((shape[0], shape[2]), dtype=x.dtype, device=dev)
            parent.matmul(x, y, o)
            assert torch.equal(matmul_kernel(x, y), o), \
                ("the bf16 matmul is not the parent's bit for bit", shape)
    (nn, m, k), _ = PACO_MM_SHAPES[2]
    a = torch.randn(nn, k, generator=gen, device=dev)
    b = torch.randn(k, m, generator=gen, device=dev)
    tall = mm_plan(nn, m, k, 132)
    rows.append(plan_row("matmul_plan_f32_tall", a, b, tall,
                         f"one launch over the {len(tall.tiles)} cuboids of "
                         f"the plan of {nn} x {m} x {k} at p = 132, float32"))
    del a, b
    torch.cuda.empty_cache()

    # one Strassen leaf: 2048^3 float32, in turns: kernel, parent,
    # library, library, parent, kernel
    ls = PACO_STRASSEN_N // 4
    a = torch.randn(ls, ls, generator=gen, device=dev)
    b = torch.randn(ls, ls, generator=gen, device=dev)
    err = _rel_mm(matmul_kernel(a, b), matmul_ref(a, b))
    o = torch.empty_like(a)
    times = collections.defaultdict(list)
    for turn in ("k", "p", "l", "l", "p", "k"):
        if turn == "k":
            times["k"].append(time_ms(lambda i: matmul_kernel(a, b),
                                      iters // 4))
        elif turn == "l":
            times["l"].append(_events_loop_ms(lambda: a @ b, 10))
        elif parent is not None:
            times["p"].append(time_ms(lambda i: parent.matmul(a, b, o),
                                      iters // 4)[0])
    leaf = _row("matmul", src, replaces, err,
                mean([t[0] for t in times["k"]]),
                mean([t[1] for t in times["k"]]),
                _events_loop_ms(lambda: matmul_ref(a, b), 10),
                mean(times["l"]), *W.matmul_work(ls, ls, ls, 4)[::-1],
                torch.float32)
    leaf["ms_turns"] = [t[0] for t in times["k"]]
    leaf["library_ms_turns"] = times["l"]
    before = matmul_kernel.variants.copy()
    matmul_kernel(a, b)
    (leaf["variant"],) = matmul_kernel.variants - before
    if parent is not None:
        leaf["parent_ms"] = mean(times["p"])
        leaf["parent_ms_turns"] = times["p"]
    leaf["work"] = f"one Strassen leaf, {ls}^3 float32"
    rows.append(leaf)
    del a, b, o

    # LCS: the whole n = 65,536 table at p = 132 (tiles of 256), one launch
    # a call, in turns with the parent's 511 launches: kernel, parent,
    # parent, kernel
    from repro_torch.core import lcs_reference
    from repro_torch.kernels.lcs.ops import default_tile, lcs_wavefront
    n = PACO_LCS_N
    s, t = _symbols(gen, n), _symbols(gen, n)
    tile = default_tile(n, 132)
    got = lcs_wavefront(s, t, 132)
    assert torch.equal(got, lcs_wavefront(s, t, 132)), \
        "lcs_table is not bitwise reproducible"
    # the plain version of the whole table: the row scan, timed once
    want, plain_s, _ = _timed(lambda: lcs_reference(s, t))
    err = abs(int(got) - int(want))
    times = collections.defaultdict(list)

    def kernel_turn():
        times["k"].append(time_ms(lambda i: lcs_wavefront(s, t, 132), 5))

    def parent_turn():
        if parent is None:
            return
        times["err"].append(abs(int(parent.lcs(s, t, tile)) - int(want)))
        times["p"].append(time_ms(lambda i: parent.lcs(s, t, tile), 3))

    kernel_turn()
    parent_turn()
    parent_turn()
    kernel_turn()
    ms, eager = (sum(x[i] for x in times["k"]) / 2 for i in (0, 1))
    cells = n * n
    ops, nbytes = W.lcs_work(n, n)
    lcs = _row("lcs_tile", "src/repro_torch/csrc/lcs_tile.cu",
               "src/repro/kernels/lcs/lcs.py:46", err, ms, eager,
               plain_s * 1e3, None, nbytes, ops, torch.int32)
    lcs["ms_turns"] = [x[0] for x in times["k"]]
    before = KL.lcs_table_kernel.variants.copy()
    lcs_wavefront(s, t, 132)
    (lcs["variant"],) = KL.lcs_table_kernel.variants - before
    # the other tilings of the suite, one launch each
    for key, p, tl in [("p131_ms", 131, None), ("po_ms", 1, 128),
                       ("pa_ms", 8, 8192)]:
        lcs[key] = time_ms(lambda i: lcs_wavefront(s, t, p, tile=tl), 3)[0]
    if parent is not None:
        lcs["parent_ms"] = sum(x[0] for x in times["p"]) / 2
        lcs["parent_ms_turns"] = [x[0] for x in times["p"]]
        lcs["parent_max_abs_err"] = max(times["err"])
    lcs["work"] = (f"the whole {n}^2 table in tiles of {tile} (p = 132), "
                   f"{cells} cells, int32; plain: the row scan")
    rows.append(lcs)
    return rows


# ---------------------------------------------------------------------------
# phase 10: the paper's PACO algorithms at full size
# ---------------------------------------------------------------------------

def _timed(fn, counter=None):
    """(result, host seconds to the synchronise, launches of ``counter``
    during the call)."""
    if counter is not None:
        counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (counter.launches
                                           if counter is not None else None)


def paco_algorithms(seed: int, smi: str) -> dict[str, int]:
    """The paper's suite on the card, p = the card's SM count (132) and
    the prime 131, inputs from ``seed``; returns the kernels' launches.

    LCS: two 65,536-symbol sequences over 4 letters through ``paco_lcs`` at
    p = 132 and 131 (tiles of 256), PO (p = 1, tile 128) and PA (p = 8,
    tile 8192) as ``benchmarks/bench_lcs.py`` defines them, each exactly
    equal to the plain row scan ``lcs_reference``; one ``lcs_table``
    launch per call, its variant named.  MM: ``paco_matmul`` on
    PACO_MM_SHAPES at both p against ``matmul_ref`` (PACO_MM_TOL),
    ``torch.matmul``'s time beside it; one ``matmul_plan`` launch per call
    walking the plan's p non-empty cuboids, in bf16 as variant ``wgmma``
    and in f32 as ``wgmma_tf32x3`` (the first call, which builds the plan
    and its table, is timed apart); each shape's launches under its row's
    name (PACO_MM_ROWS).  Strassen: ``paco_strassen`` and ``strassen`` at
    depth 2 on 8192^2 f32 (49 leaf products of 2048^3 each, 49 launches,
    all ``wgmma_tf32x3``) against the f32 product (STRASSEN_TOL).  Sort:
    ``paco_sort`` of 2^26 uniform float32 at p = 132, exactly
    ``torch.sort``, largest bucket <= 3 n / p (eps 2.0, as
    ``tests/test_paco_core.py:297``).  1D (n = 2048) and GAP (n = 64, tile
    4), whose base cases are host loops per element, against their
    references (atol 1e-5, as the JAX tests)."""
    from repro_torch import core
    from repro_torch.kernels.lcs import lcs as KL
    from repro_torch.kernels.lcs.ops import default_tile
    from repro_torch.kernels.matmul import matmul_kernel
    from repro_torch.kernels.matmul import matmul_plan_kernel as K6
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.core.matmul import plan as mm_plan

    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ps = (sms, 131)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    launches = {**dict.fromkeys(PACO_MM_ROWS, 0), "matmul": 0,
                "lcs_tile": 0}

    def report(tag: str, result: dict) -> None:
        log(f"[paco] {tag}: {json.dumps(result)}; card: {smi}")

    # LCS
    n = PACO_LCS_N
    s = torch.tensor(rng.integers(0, 4, n), dtype=torch.int32, device=dev)
    t = torch.tensor(rng.integers(0, 4, n), dtype=torch.int32, device=dev)
    want, ref_s, _ = _timed(lambda: int(core.lcs_reference(s, t)))
    report("lcs reference", {"n": n, "lcs": want, "seconds": ref_s})
    for label, p, tile in [(f"p={ps[0]}", ps[0], None),
                           (f"p={ps[1]}", ps[1], None),
                           ("PO p=1 tile=128", 1, 128),
                           ("PA p=8 tile=n/8", 8, n // 8)]:
        KL.lcs_table_kernel.variants.clear()
        got, secs, nl = _timed(lambda: int(core.paco_lcs(s, t, p, tile=tile)),
                               KL.lcs_table_kernel)
        tile = tile or default_tile(n, p)
        variants = dict(KL.lcs_table_kernel.variants)
        report(f"lcs {label}", {"tile": tile, "lcs": got, "seconds": secs,
                                "cells_per_s": n * n / secs,
                                "launches": nl, "variants": variants})
        assert got == want, ("paco_lcs", label, got, want)
        assert nl == 1 and sum(variants.values()) == 1, \
            ("one lcs_table launch a paco_lcs call", label, nl, variants)
        launches["lcs_tile"] += nl
    del s, t

    # MM
    for ((nn, m, k), dtype), row in zip(PACO_MM_SHAPES, PACO_MM_ROWS):
        a = torch.randn(nn, k, generator=gen, device=dev).to(dtype)
        b = torch.randn(k, m, generator=gen, device=dev).to(dtype)
        want = matmul_ref(a, b)
        lib, lib_s, _ = _timed(lambda: a @ b)
        lib_err = _rel_mm(lib, want)
        del lib
        for p in ps:
            # the first call builds the plan and its table (kept)
            _, first_s, _ = _timed(lambda: core.paco_matmul(a, b, p))
            K6.cuboids = 0
            K6.variants.clear()
            got, secs, nl = _timed(lambda: core.paco_matmul(a, b, p), K6)
            err = _rel_mm(got, want)
            del got
            cuboids = sum(1 for _, c in mm_plan(nn, m, k, p).tiles
                          if c.volume())
            report(f"mm {nn}x{m}x{k} {str(dtype)[6:]} p={p}",
                   {"seconds": secs, "flops_per_s": 2.0 * nn * m * k / secs,
                    "first_call_seconds": first_s,
                    "torch_matmul_seconds": lib_s, "rel_err": err,
                    "torch_matmul_rel_err": lib_err, "launches": nl,
                    "cuboids": K6.cuboids, "variants": dict(K6.variants)})
            assert err <= PACO_MM_TOL[dtype], ("paco_matmul", dtype, p, err)
            assert nl == 1 and K6.cuboids == cuboids == p, \
                ("one matmul_plan launch walking p cuboids", nl, K6.cuboids,
                 cuboids, p)
            assert dict(K6.variants) == {
                "wgmma" if dtype == torch.bfloat16 else "wgmma_tf32x3": 1}, \
                dict(K6.variants)
            launches[row] += nl
        del a, b, want
        torch.cuda.empty_cache()

    # Strassen
    n = PACO_STRASSEN_N
    a = torch.randn(n, n, generator=gen, device=dev)
    b = torch.randn(n, n, generator=gen, device=dev)
    want = matmul_ref(a, b)
    for label, fn in [(f"paco_strassen p={ps[0]}",
                       lambda: core.paco_strassen(a, b, ps[0], depth=2)),
                      ("strassen", lambda: core.strassen(a, b, 2))]:
        matmul_kernel.variants.clear()
        got, secs, nl = _timed(fn, matmul_kernel)
        err = _rel_mm(got, want)
        del got
        report(f"{label} depth=2 {n}^2 float32",
               {"seconds": secs, "rel_err": err, "launches": nl,
                "variants": dict(matmul_kernel.variants)})
        assert err <= STRASSEN_TOL, (label, err)
        assert nl == 49, (label, nl)
        assert dict(matmul_kernel.variants) == {"wgmma_tf32x3": 49}, \
            (label, dict(matmul_kernel.variants))
        launches["matmul"] += nl
    log(f"[paco] strassen_beneficial_depth({n}) at 989 TFLOP/s and "
        f"3.35 TB/s: {core.strassen_beneficial_depth(n)}")
    del a, b, want
    torch.cuda.empty_cache()

    # Sort
    x = torch.rand(PACO_SORT_N, generator=gen, device=dev)
    (got, sizes), secs, _ = _timed(lambda: core.paco_sort(
        x, ps[0], torch.Generator(device=dev).manual_seed(seed + 1)))
    ref, ref_s, _ = _timed(lambda: torch.sort(x).values)
    largest = int(sizes.max())
    report(f"sort 2^26 p={ps[0]}",
           {"seconds": secs, "torch_sort_seconds": ref_s,
            "largest_bucket": largest,
            "largest_over_n_p": largest / (PACO_SORT_N / ps[0])})
    assert torch.equal(got, ref), "paco_sort is not torch.sort"
    assert int(sizes.sum()) == PACO_SORT_N
    assert largest <= 3.0 * PACO_SORT_N / ps[0], largest
    del x, got, ref

    # 1D and GAP
    w = torch.tensor(rng.random((2049, 2049)), dtype=torch.float32,
                     device=dev)
    got, secs, _ = _timed(lambda: core.paco_onedim(w, ps[0]))
    want, ref_s, _ = _timed(lambda: core.onedim_reference(w))
    err = max_err(got, want)
    report(f"onedim n=2048 p={ps[0]}", {"seconds": secs,
                                        "reference_seconds": ref_s,
                                        "max_err": err})
    assert err <= 1e-5, ("paco_onedim", err)
    ng = 64
    sg, wg, w2 = (rng.random((ng + 1, ng + 1)) for _ in range(3))
    got, secs, _ = _timed(lambda: core.paco_gap(
        *(torch.tensor(x, device=dev) for x in (sg, wg, w2)), ps[0], tile=4))
    err = float(np.max(np.abs(got.cpu().numpy()
                              - core.gap_reference(sg, wg, w2))))
    report(f"gap n={ng} tile=4 p={ps[0]}", {"seconds": secs, "max_err": err})
    assert err <= 1e-5, ("paco_gap", err)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the meshed paths on a one-rank NCCL group (a 1 x 1 mesh)
# ---------------------------------------------------------------------------

MESH_SERVE_REQUESTS = 8      # prompts of 48..512 tokens, 16 new tokens each
MESH_SERVE_NEW = 16
MESH_MM_N = 4096             # paco_matmul_shmap / pjit at 4096^3 bf16
MESH_SORT_N = 2 ** 24
# apply_moe_paco_ep on one full-width olmoe-1b-7b layer, top-1, float32:
# capacity factor 1.0, so that on one rank (cap = nb) no token drops; the
# dense reference sums each token's d_model products in another order
MESH_MOE = {"batch": 4, "seq": 256, "capacity_factor": 1.0}
MOE_EP_TOL = 1e-4            # max abs error over max |dense|
MESH_ELASTIC = {"layers": 2, "batch": 2, "seq": 512, "save_every": 2}
MESH_TRAIN_LR = 3e-4         # the train phase's AdamW rate


def _mesh_group():
    """A one-rank NCCL group over an in-process store: the card as a
    1 x 1 (data, model) mesh, the same kernels as without a mesh."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    assert dist.get_backend() == "nccl"


def _serve_wrappers() -> dict:
    from repro_torch.kernels.attention import attention as K
    return {"paged_prefill": K.paged_flash_prefill,
            "paged_decode": K.paged_flash_decode,
            "paged_verify": K.paged_flash_verify}


def _zero_counts(wrappers: dict) -> None:
    for fn in wrappers.values():
        fn.launches = 0
        fn.variants.clear()


def _counts(wrappers: dict) -> dict:
    """{name: (launches, {variant: launches})} since ``_zero_counts``."""
    return {name: (fn.launches, dict(fn.variants))
            for name, fn in wrappers.items()}


def _cuda_core_launches(wrappers: dict) -> dict:
    """{name: launches} since ``_zero_counts``, every launch of the
    CUDA-core family (the float32 runs of phases 4 and 6: rows 1f-4f)."""
    counts = _counts(wrappers)
    for name, (n, variants) in counts.items():
        assert set(variants) == {"cuda_cores"}, (name, variants)
    return {name: n for name, (n, _) in counts.items()}


def mesh_train_step(cfg, mesh, seed: int) -> dict:
    """One full-width ``train_step`` (B 2 x S 4096, remat, AdamW) without a
    mesh and with params laid out by ``param_specs`` and the batch by
    ``batch_specs`` on the 1 x 1 mesh, from the same weights: loss and
    gradient norm within TRAIN_PARITY_TOL, every updated leaf within
    2 lr + 2^-7 of its max (an AdamW step moves a leaf by about lr), and
    whether all of it is bitwise.  The flash counts of each step are
    zeroed just before and read just after: one evaluation with remat
    (``_train_flash_counts``), the same with and without the mesh."""
    from repro_torch.data.pipeline import DataConfig, global_batch_rowwise
    from repro_torch.dist import act_sharding as act
    from repro_torch.dist import sharding as D
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, init_train_state, train_step

    tcfg = TrainConfig(opt=AdamWConfig(lr=MESH_TRAIN_LR,
                                       total_steps=TRAIN_STEPS))
    data = global_batch_rowwise(
        DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                   vocab=cfg.vocab, seed=seed), 0, device="cuda")
    runs = {}
    for meshed in (False, True):
        params = init_params(cfg, seed=seed, device="cuda")
        batch = data
        if meshed:
            params = D.distribute(mesh, params,
                                  D.param_specs(cfg, params, mesh))
            batch = D.distribute(mesh, data, D.batch_specs(cfg, mesh, data))
        state = init_train_state(cfg, tcfg, params)
        torch.cuda.synchronize()
        _flash_counts_zeroed()
        t0 = time.perf_counter()
        params, state, metrics = train_step(params, state, batch, cfg=cfg,
                                            tcfg=tcfg)
        torch.cuda.synchronize()
        runs[meshed] = {
            "s": time.perf_counter() - t0,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "leaves": [act.replicate(p) for p in tree_leaves(params)],
            "flash": (_flash_counts(), _flash_counts(bwd=True))}
        del params, state
    plain, meshed = runs[False], runs[True]
    tol = TRAIN_PARITY_TOL[cfg.dtype]
    leaf_err = max(max_err(a, b) / max(float(a.float().abs().max()), 1e-30)
                   for a, b in zip(plain["leaves"], meshed["leaves"]))
    bitwise = (plain["metrics"] == meshed["metrics"] and all(
        torch.equal(a, b) for a, b in zip(plain["leaves"],
                                          meshed["leaves"])))
    result = {"arch": cfg.name, "dtype": str(cfg.dtype),
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "loss": [plain["metrics"]["loss"], meshed["metrics"]["loss"]],
              "grad_norm": [plain["metrics"]["grad_norm"],
                            meshed["metrics"]["grad_norm"]],
              "leaf_rel_err_max": leaf_err, "bitwise": bitwise,
              "step_s": [plain["s"], meshed["s"]],
              "flash": {"plain": plain["flash"], "mesh": meshed["flash"]}}
    log(f"[mesh] train step, 1 x 1 mesh vs no mesh: {json.dumps(result)}")
    want = _train_flash_counts(cfg, 1, TRAIN_BATCH, TRAIN_SEQ)
    assert plain["flash"] == want and meshed["flash"] == want, result
    assert abs(result["loss"][0] - result["loss"][1]) <= tol["loss"], result
    assert (abs(result["grad_norm"][0] - result["grad_norm"][1])
            <= tol["grad_norm"] * result["grad_norm"][0]), result
    assert leaf_err <= 2 * MESH_TRAIN_LR + 2 ** -7, result
    del runs, plain, meshed
    torch.cuda.empty_cache()
    return result


def mesh_serve(cfg, params, mesh, rng: np.random.Generator, seed: int,
               **engine_kw) -> dict:
    """The same requests through ``ServeEngine`` (8 slots, max_seq 2048)
    without a mesh and with ``mesh=``: equal tokens, and equal launch
    counts of kernels 1, 2 and 2v (zeroed just before each run, read just
    after), each kernel the path runs launched at least once."""
    from repro_torch.serve import Request, ServeEngine

    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in rng.integers(48, 513, size=MESH_SERVE_REQUESTS)]
    runs = {}
    for m in (None, mesh):
        engine = ServeEngine(params, cfg, slots=8, max_seq=2048,
                             ticks_per_dispatch=8, seed=seed, device="cuda",
                             mesh=m, **engine_kw)
        torch.cuda.synchronize()
        _zero_counts(_serve_wrappers())
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=p,
                                  max_new_tokens=MESH_SERVE_NEW))
        done = engine.run_until_drained()
        torch.cuda.synchronize()
        engine.check_page_invariants()
        runs[m is not None] = {
            "s": time.perf_counter() - t0,
            "counts": _counts(_serve_wrappers()),
            "tokens": {r.uid: r.out for r in done},
            "decode_steps": engine.stats["decode_steps"],
            "accepted": engine.stats["accepted_tokens"]}
        del engine
    plain, meshed = runs[False], runs[True]
    step = ("paged_verify" if engine_kw.get("speculate") is not None
            else "paged_decode")
    result = {"mode": "speculative" if step == "paged_verify" else "fused",
              "requests": len(prompts), "tokens_equal":
              plain["tokens"] == meshed["tokens"],
              "wall_s": [plain["s"], meshed["s"]],
              "launches": {"plain": plain["counts"],
                           "mesh": meshed["counts"]},
              "decode_steps": meshed["decode_steps"],
              "accepted_tokens": meshed["accepted"]}
    log(f"[mesh] serve, 1 x 1 mesh vs no mesh: {json.dumps(result)}")
    assert result["tokens_equal"], result
    assert plain["counts"] == meshed["counts"], result
    for name in ("paged_prefill", step):
        assert meshed["counts"][name][0] > 0, result
    if step == "paged_verify":   # every bf16 verify launch one of clusters
        assert meshed["counts"][step][1] == {
            "cluster": meshed["counts"][step][0]}, result
    return result


def mesh_paco(mesh_p, gen: torch.Generator) -> dict:
    """``paco_matmul_shmap`` and ``paco_matmul_pjit`` at 4096^3 bf16 on one
    rank within MM_TOL of ``torch.matmul``, and ``paco_sort_shmap`` of
    2^24 floats exactly ``torch.sort``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import (make_paco_mesh, paco_matmul_pjit,
                                  paco_matmul_shmap, paco_sort_shmap)

    n = MESH_MM_N
    a = torch.randn(n, n, device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn(n, n, device="cuda", generator=gen).to(torch.bfloat16)
    want = torch.matmul(a, b)
    mesh3 = make_paco_mesh(n, n, n, 1)
    mesh1 = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
    out = {}
    for name, run in (("shmap", lambda: paco_matmul_shmap(a, b, mesh3)),
                      ("pjit", lambda: paco_matmul_pjit(a, b, mesh1,
                                                        "model"))):
        got = run().full_tensor()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        out[f"matmul_{name}"] = {"rel_err": _rel_mm(got, want),
                                 "ms": (time.perf_counter() - t0) / 5 * 1e3}
        assert out[f"matmul_{name}"]["rel_err"] <= MM_TOL[torch.bfloat16], \
            out
    x = torch.rand(MESH_SORT_N, device="cuda", generator=gen)
    t0 = time.perf_counter()
    vals, valid = paco_sort_shmap(x, mesh_p, "p", torch.Generator(
        device="cuda").manual_seed(7))
    got = vals.full_tensor()[valid.full_tensor()]
    torch.cuda.synchronize()
    out["sort"] = {"n": MESH_SORT_N, "s": time.perf_counter() - t0,
                   "exact": bool(torch.equal(got, torch.sort(x).values))}
    assert out["sort"]["exact"], out
    return out


def mesh_moe_ep(mesh1, gen: torch.Generator) -> dict:
    """``apply_moe_paco_ep`` on one full-width olmoe-1b-7b layer (64
    experts, top-1, float32) on one rank, against the dense top-1
    reference: each token through its arg-max expert, weighted by its
    router probability (expert by expert, MOE_EP_TOL)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import apply_moe_paco_ep, init_moe

    base = get_arch("olmoe-1b-7b")
    cfg = dataclasses.replace(base, param_dtype="float32", moe=(
        dataclasses.replace(base.moe, top_k=1, capacity_factor=MESH_MOE[
            "capacity_factor"])))
    p = init_moe(gen, cfg, torch.float32)
    x = torch.randn(MESH_MOE["batch"], MESH_MOE["seq"], cfg.d_model,
                    device="cuda", generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = apply_moe_paco_ep(p, cfg, x, mesh1, "model").full_tensor()
    torch.cuda.synchronize()
    ep_s = time.perf_counter() - t0
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    w, eid = probs.max(dim=-1)
    want = torch.zeros_like(xf)
    for e in range(cfg.moe.n_experts):
        rows = (eid == e).nonzero()[:, 0]
        h = torch.nn.functional.silu(xf[rows] @ p["gate"][e]) * (
            xf[rows] @ p["up"][e])
        want[rows] = (h @ p["down"][e]) * w[rows, None]
    want = want.reshape(x.shape)
    result = {"experts": cfg.moe.n_experts, "tokens": xf.shape[0],
              "rel_err": max_err(got, want) / float(want.abs().max()),
              "s": ep_s}
    assert result["rel_err"] <= MOE_EP_TOL, result
    return result


def mesh_seq_attention(mesh1, gen: torch.Generator) -> dict:
    """The merge across a group, on the card: ``seq_attention`` at the
    rows 5s/5bs geometry (train_4k's global layer, 16 key blocks in the
    list), f32 and bf16, with ``KeyBlocks`` over the one-rank NCCL group
    of ``mesh1``'s model axis (the functional all-reduces, their waits and
    dQ's all-reduce in the backward), forward and backward against the
    same blocks reduced over the list alone: bitwise equal, and each run
    16 launches of either entry.  Returns the launches of the group's
    runs."""
    from repro_torch.kernels.attention import attention as K

    g = SEQ_GEOM
    s, window = SEQ_CELLS["train_4k"]
    kw = {"causal": True, "window": window, "logit_cap": g["logit_cap"]}
    offs, lens = _key_blocks(s, SEQ_BLOCKS[0])
    group = K.KeyBlocks(mesh1.get_group("model"))
    launches = {"flash_attention_block": 0, "flash_attention_block_bwd": 0}
    for dtype in (torch.float32, torch.bfloat16):
        q, d_o = (torch.randn(g["b"], s, g["hq"], g["d"], generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(g["b"], s, g["hkv"], g["d"], generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        alone = _seq_run(q, k, v, d_o, offs, lens, kw)
        for fn in (K.flash_attention_block, K.flash_attention_block_bwd):
            fn.launches = 0
        meshed = _seq_run(q, k, v, d_o, offs, lens, kw, blocks=group)
        torch.cuda.synchronize()
        counts = {"flash_attention_block": K.flash_attention_block.launches,
                  "flash_attention_block_bwd":
                      K.flash_attention_block_bwd.launches}
        assert counts == dict.fromkeys(counts, len(offs)), counts
        assert torch.equal(meshed[0], alone[0]) and all(
            torch.equal(a, c) for a, c in zip(meshed[1], alone[1])), \
            ("seq_attention over the group differs from the list", dtype)
        for key in launches:
            launches[key] += counts[key]
        del q, k, v, d_o, alone, meshed
        torch.cuda.empty_cache()
    return launches


def mesh_elastic(cfg, seed: int) -> dict:
    """``ElasticRunner`` on the 1 x 1 mesh: qwen3-0.6b at full width, cut
    to 2 layers, B 2 x S 512.  An uninterrupted run of 4 steps (saved
    every 2), and a run that loses its ranks at step 3 (``fail_at``; the
    survivor count is 1), restores the step-2 checkpoint on a new mesh and
    replays batches 2 and 3: its losses equal the uninterrupted run's
    (rtol 2e-4, as ``tests/test_spmd.py``), and whether bitwise."""
    import shutil
    import tempfile

    from repro_torch.data.pipeline import DataConfig, global_batch_rowwise
    from repro_torch.dist import sharding as D
    from repro_torch.ft import ElasticRunner
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, train_step

    el = MESH_ELASTIC
    cfg = dataclasses.replace(cfg, n_layers=el["layers"])
    tcfg = TrainConfig(opt=AdamWConfig(lr=MESH_TRAIN_LR))
    dcfg = DataConfig(seq_len=el["seq"], global_batch=el["batch"],
                      vocab=cfg.vocab, seed=seed)

    def build(mesh):
        params = init_params(cfg, seed=seed, device="cuda")
        params = D.distribute(mesh, params, D.param_specs(cfg, params, mesh))

        def step_fn(p, s, batch):
            return train_step(p, s, D.distribute(mesh, batch, D.batch_specs(
                cfg, mesh, batch)), cfg=cfg, tcfg=tcfg)
        return {"params": params, "state": init_train_state(cfg, tcfg,
                                                            params),
                "step_fn": step_fn}

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build_dir, prefix="mesh_ckpt_")
    try:
        batches = [global_batch_rowwise(dcfg, i, device="cuda")
                   for i in range(4)]
        _, _, base = ElasticRunner(f"{tmp}/a", build, el["save_every"]).run(
            1, batches)
        _, _, replay = ElasticRunner(f"{tmp}/b", build,
                                     el["save_every"]).run(
            1, batches + batches[2:], fail_at=3, surviving=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = base[:3] + base[2:]
    result = {"layers": cfg.n_layers, "losses": replay, "uninterrupted": base,
              "bitwise": replay == want}
    np.testing.assert_allclose(replay, want, rtol=2e-4)
    assert all(math.isfinite(v) for v in replay), result
    return result


def mesh_phase(seed: int, smi: str) -> dict:
    """The meshed paths on the card (a one-rank NCCL group, a 1 x 1 mesh):
    the train step, serving (fused and speculative), the SPMD matmul and
    sort executors, the expert-parallel MoE, the sequence-parallel merge
    over the group and the elastic restart.
    Returns the kernels' launches of its meshed runs."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from torch.distributed.device_mesh import init_device_mesh

    _mesh_group()
    try:
        mesh = make_host_mesh((1, 1))
        assert mesh.device_type == "cuda"
        cfg = get_arch(ARCH)
        train = mesh_train_step(cfg, mesh, seed)
        params = init_params(cfg, seed=seed, device="cuda")
        rng = np.random.default_rng([seed, 18])
        fused = mesh_serve(cfg, params, mesh, rng, seed)
        spec = mesh_serve(cfg, params, mesh, rng, seed, speculate=0,
                          spec_min_accept=0)
        del params
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(seed + 18)
        mesh_p = init_device_mesh("cuda", (1,), mesh_dim_names=("p",))
        mesh1 = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
        paco = mesh_paco(mesh_p, gen)
        log(f"[mesh] paco executors: {json.dumps(paco)}; {smi}")
        moe = mesh_moe_ep(mesh1, gen)
        log(f"[mesh] apply_moe_paco_ep vs dense top-1: {json.dumps(moe)}; "
            f"{smi}")
        seq = mesh_seq_attention(mesh1, gen)
        log(f"[mesh] seq_attention over the model axis's NCCL group bitwise "
            f"the list's, f32 and bf16: launches {json.dumps(seq)}; {smi}")
        torch.cuda.empty_cache()
        elastic = mesh_elastic(cfg, seed)
        log(f"[mesh] elastic replay: {json.dumps(elastic)}; {smi}")
    finally:
        dist.destroy_process_group()
    return {"flash_attention": train["flash"]["mesh"][0]["launches"],
            "flash_attention_bwd": train["flash"]["mesh"][1]["launches"],
            "paged_prefill": (fused["launches"]["mesh"]["paged_prefill"][0]
                              + spec["launches"]["mesh"]["paged_prefill"][0]),
            "paged_decode": fused["launches"]["mesh"]["paged_decode"][0],
            "paged_verify": spec["launches"]["mesh"]["paged_verify"][0]}


# ---------------------------------------------------------------------------
# phase 12: the launch tooling against the card
# ---------------------------------------------------------------------------

# Two cells of full-width qwen3-0.6b (bf16) sized for one card: the train
# phase's step, and one decode step on the dense cache at B 8 x S 32768
# (28 x 2 x 8 x 128 x 2 B = 114,688 B of K/V a token: 30.1 GB).
LAUNCH_CELLS = {"train": (TRAIN_BATCH, TRAIN_SEQ), "decode": (8, 32768)}
# MemTracker's peak on fake tensors against max_memory_allocated() of the
# real step (less what was allocated before its arguments): the allocator
# rounds each block up to 512 B and cuBLAS keeps a workspace.
PEAK_TOL = 0.10
LAUNCH_TIMED_STEPS = 5


def _launch_cell(cfg, kind: str, seed: int, smi: str) -> dict:
    """One cell traced on fake CUDA tensors (``launch.dryrun.trace``),
    then run for real on the card under the same counters: operations and
    bytes must be equal, the predicted peak within PEAK_TOL of the real
    one.  Then the roofline's bound against the step's median time."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import cost, dryrun, specs
    from repro_torch.launch.roofline import terms
    from repro_torch.models import cache_spec, init_params
    from repro_torch.models.transformer import zeros_of
    from repro_torch.train.train_step import TrainConfig, init_train_state

    b, s = LAUNCH_CELLS[kind]
    shape = ShapeCell(f"{kind}_{s}", s, b, kind)
    tcfg = TrainConfig()
    fn, fn_name = specs.step_fn_for(cfg, shape, tcfg)
    mode = specs.fake_mode()
    fake_args = dryrun.build_args(cfg, shape, mode, tcfg)
    fake = dryrun.trace(fn, fake_args, mode)
    del fake_args

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    params = init_params(cfg, seed=seed, device="cuda")
    ints = lambda *shp: torch.randint(  # noqa: E731
        0, cfg.vocab, shp, generator=gen, device="cuda", dtype=torch.int32)
    if kind == "train":
        args = (params, init_train_state(cfg, tcfg, params),
                {"tokens": ints(b, s), "labels": ints(b, s)})
    else:
        lengths = torch.randint(0, s - 1, (b,), generator=gen,
                                device="cuda", dtype=torch.int32)
        args = (params, ints(b, 1), zeros_of(cache_spec(cfg, b, s), "cuda"),
                lengths)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with cost.StepCounters() as counters:
        fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    real = counters.summary()
    times = []
    for _ in range(LAUNCH_TIMED_STEPS):
        times.append(_events_ms(lambda: fn(*args), 1))
    del args, params
    torch.cuda.empty_cache()
    t = terms(cfg, {"cost": fake["cost"], "collectives": {}}, {})
    bound = {k: t[k] * 1e3 for k in ("compute", "memory")}
    pred = fake["memory"]["peak_bytes_per_device"]
    result = {
        "cell": kind, "fn": fn_name, "batch": b, "seq": s,
        "flops": {"fake": fake["cost"]["flops_per_device"],
                  "real": real["flops_per_device"]},
        "bytes": {"fake": fake["cost"]["bytes_per_device"],
                  "real": real["bytes_per_device"]},
        "kernel_calls": {"fake": fake["cost"]["kernel_calls"],
                         "real": real["kernel_calls"]},
        "peak_bytes": {"predicted": pred, "real": peak,
                       "rel_err": (pred - peak) / peak},
        "trace_s": fake["trace_s"],
        "bound_ms": max(bound.values()), "bound_terms_ms": bound,
        "dominant": max(bound, key=bound.get),
        "step_ms_median": float(np.median(times)), "step_ms": times}
    log(f"[launch] {json.dumps(result)}; card: {smi}")
    assert result["flops"]["fake"] == result["flops"]["real"], result
    assert result["bytes"]["fake"] == result["bytes"]["real"], result
    assert abs(result["peak_bytes"]["rel_err"]) <= PEAK_TOL, result
    return result


def _kernel_launch_counts() -> dict[str, int]:
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.lcs.lcs import lcs_table_kernel
    from repro_torch.kernels.matmul.matmul import (matmul_kernel,
                                                   matmul_plan_kernel)

    return {"paged_decode (1)": K.paged_flash_decode.launches,
            "paged_prefill (2)": K.paged_flash_prefill.launches,
            "flash_attention (5)": K.flash_attention.launches,
            "flash_attention_bwd (5b)": K.flash_attention_bwd.launches,
            "matmul (6)": matmul_kernel.launches,
            "matmul_plan (6)": matmul_plan_kernel.launches,
            "lcs_tile (7)": lcs_table_kernel.launches}


# the kernels each example must launch at its defaults on the card
EXAMPLE_KERNELS = {
    "quickstart": ("matmul (6)", "matmul_plan (6)"),
    "serve_lm": ("paged_decode (1)", "paged_prefill (2)"),
    "train_lm": ("flash_attention (5)", "flash_attention_bwd (5b)"),
    "paco_algorithms": ("matmul (6)", "matmul_plan (6)", "lcs_tile (7)"),
}


def run_examples(smi: str) -> dict:
    """The four ``examples/torch`` scripts at their defaults on the card,
    in this process; the kernel launches each adds."""
    import importlib.util

    added = {}
    for name, want in EXAMPLE_KERNELS.items():
        path = Path(__file__).resolve().parent / "examples" / "torch" \
            / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        before = _kernel_launch_counts()
        t0 = time.perf_counter()
        rc = mod.main([])
        torch.cuda.synchronize()
        assert rc in (None, 0), (name, rc)
        after = _kernel_launch_counts()
        added[name] = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
        added[name]["wall_s"] = round(time.perf_counter() - t0, 2)
        assert all(added[name].get(k, 0) > 0 for k in want), (name, added)
        torch.cuda.empty_cache()
    log(f"[launch] examples' kernel launches: {json.dumps(added)}; {smi}")
    return added


def launch_phase(seed: int, smi: str) -> dict:
    """(a) the dry-run against the real step on the card, (b) one
    full-width cell of the production mesh traced on the host, (c) the
    four examples."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    cfg = get_arch(ARCH)
    cells = [_launch_cell(cfg, kind, seed, smi) for kind in LAUNCH_CELLS]
    rec = dryrun.run_cell(ARCH, "train_4k", False, "")
    log(f"[launch] production mesh {ARCH} train_4k (256 fake ranks): "
        f"status {rec['status']}, trace {rec.get('trace_s')} s, peak "
        f"{rec.get('memory', {}).get('peak_bytes_per_device')} B/card, "
        f"{rec.get('cost', {}).get('flops_per_device')} flops/card"
        + (f"; {rec.get('error')}" if rec["status"] != "ok" else ""))
    assert rec["status"] == "ok", rec.get("trace", rec)
    return {"cells": cells, "mesh_cell": {k: rec.get(k) for k in (
        "status", "trace_s", "memory")}, "examples": run_examples(smi)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", "--parent-flash", dest="parent", type=Path,
                    default=None,
                    help="a directory holding an earlier commit's "
                    "flash_fwd.cu, flash_bwd.cu, paged_prefill.cu, "
                    "matmul.cu, paged_decode.cu, paged_latent_prefill.cu, "
                    "paged_latent_decode.cu and lcs_tile.cu with their "
                    "headers (not the committed tree): those kernels are "
                    "built and timed in turns with the current ones")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.build import LIBS, sass_counts
    from repro_torch.models import init_params, param_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    # 2. build
    LIBS.build_all()
    log(f"[build] nvcc sm_90a, {len(LIBS.ptxas_log)} libraries in "
        f"{LIBS.build_seconds:.1f}s")
    for lib, text in sorted(LIBS.ptxas_log.items()):
        for line in text.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "serialized")):
                log(f"[build] {lib}: {line.strip()}")
    counts = sass_counts(("flash_fwd", "flash_bwd", "paged_prefill",
                          "paged_latent_prefill", "matmul"),
                         ("HGMMA", "HMMA", "UTMALDG"))
    log("[build] sass instructions " + (
        "not counted: no cuobjdump" if counts is None else json.dumps(counts)))
    parent = None
    if args.parent is not None:
        parent = ParentKernels(args.parent)
        log(f"[build] parent kernels {list(ParentKernels.NAMES)} from "
            f"{args.parent}")

    # 3. kernels against their plain versions
    cfg = get_arch(ARCH)
    cfg_ds = get_arch(DS_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    with phase("kernels"):
        worst = check_small_geometries(gen)
        worst.update(check_small_latent(gen))
        worst.update(check_flash_small(gen))
        worst.update(check_paco_kernels(gen))
        log(f"[kernels] small prime/odd/window/softcap geometries ok: "
            f"max err {worst}")
        rows = bench_kernels(cfg, gen, ITERS, parent)
        rows += bench_latent_kernels(cfg_ds, gen, ITERS, parent)
        rows += bench_flash(FLASH_TRAIN_SHAPE, gen, FLASH_ITERS, parent)
        rows += bench_paco_kernels(gen, ITERS, parent)
        # kernels 5 and 5b at their own key length and at D 112, from a
        # generator of their own (the draws of the checks above stay as
        # they were)
        gen_sk = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        worst_sk = check_flash_own_key_length(gen_sk)
        log(f"[kernels] flash pair at Sq != Sk and D 112 ok: max err "
            f"{worst_sk}")
        if parent is not None:
            n_cases, n_near, n_split = check_flash_same_as_parent(parent,
                                                                  gen_sk)
            log(f"[kernels] flash pair at Sq == Sk bitwise the parent's "
                f"in {n_cases - n_near} cases at one rank, within "
                f"FLASH_TOL of it in {n_near} (float32 at D 64 and 128); "
                f"the split family within FLASH_TOL of it in the "
                f"{n_split} of them it takes")
        rows += bench_flash(FLASH_OWN_SHAPES, gen_sk, FLASH_ITERS, parent)
        rows += bench_flash(FLASH_F32_SHAPES, gen_sk, FLASH_F32_ITERS, parent,
                            dtype=torch.float32)
        # the serving kernels' float32 families (rows 1f-4f: the CUDA
        # cores, as phases 4 and 6 launch them in float32), from a
        # generator of their own
        gen_f32 = torch.Generator(device="cuda").manual_seed(args.seed + 4)
        rows += bench_kernels(cfg, gen_f32, ITERS, dtype=torch.float32)
        rows += bench_latent_kernels(cfg_ds, gen_f32, ITERS,
                                     dtype=torch.float32)
        if parent is not None:
            log("[parent] flash pair against the parent's: " + json.dumps(
                flash_against_parent(parent, torch.Generator(
                    device="cuda").manual_seed(args.seed + 2))))
    # 3c. sequence-parallel attention: the key-block entries of kernels 5
    # and 5b and their merge at gemma2-2b's full width, from a generator of
    # their own
    with phase("seq_attention"):
        seq_rows, seq_launches = seq_attention_phase(
            torch.Generator(device="cuda").manual_seed(args.seed + 3), smi,
            parent)
        rows += seq_rows
    with phase("verify_kernels"):
        verify_rows, verify_worst = bench_verify_kernels(gen, ITERS, parent)
        log(f"[verify] both entries against their plain versions: max err "
            f"{verify_worst}")
        rows += verify_rows
    for r in rows:
        library = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
        if r.get("library_backend"):
            library += f" ({r['library_backend']})"
        parent_ms = ("" if "parent_ms" not in r else
                     f" parent {r['parent_ms']:.4f} ms")
        for key, who in (("ms_turns", "kernel"),
                         ("parent_ms_turns", "parent")):   # each turn's ms
            if key in r:
                parent_ms += f" {who} turns " + ", ".join(
                    f"{t:.4f}" for t in r[key])
        if r.get("variant"):
            parent_ms += f" variant {r['variant']}"
        log(f"[kernels] {r['name']}: err {r['max_abs_err']:.3g} kernel "
            f"{r['ms']:.4f} ms (eager call {r['eager_ms']:.4f} ms)"
            f"{parent_ms} plain {r['plain_ms']:.4f} ms library {library} "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); {smi}")
        if "library_ms_by_backend" in r:
            log(f"[kernels] {r['name']}: SDPA by backend "
                f"{json.dumps(r['library_ms_by_backend'])}; refused "
                f"{json.dumps(r['library_refused'])}; on expanded K/V "
                f"{r['library_expanded_kv']}")

    # 4. one chunk and 8 ticks at full width, float32 then bf16
    rng = np.random.default_rng(args.seed)
    f32_launches = {}   # rows 1f-4f: the float32 runs' launches
    with phase("qwen3 model"):
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        f32_wrappers = {"paged_prefill_f32": K.paged_flash_prefill,
                        "paged_decode_f32": K.paged_flash_decode}
        _zero_counts(f32_wrappers)
        parity = full_width_parity(
            cfg32, init_params(cfg32, seed=args.seed, device="cuda"), rng)
        f32_launches.update(_cuda_core_launches(f32_wrappers))
        log(f"[model] kernel path vs plain path: {json.dumps(parity)}")
        params = init_params(cfg, seed=args.seed, device="cuda")
        log(f"[model] {cfg.name} full width, {param_count(params)} params "
            f"{cfg.dtype}")
        parity = full_width_parity(cfg, params, rng)
        log(f"[model] kernel path vs plain path: {json.dumps(parity)}")

    # 5. serve
    launches = dict(seq_launches)
    with phase("qwen3 serve"):
        result, engine, done = serve(
            cfg, params, rng, args.seed, (64, 64, 32),
            {"paged_prefill": (K.paged_flash_prefill, "prefill_calls"),
             "paged_decode": (K.paged_flash_decode, "decode_steps")})
        log(f"[serve] {json.dumps(result)}; card: {smi}")
        launches.update(result["launches"])
        assert result["launches_by_variant"]["paged_prefill"] == {
            "mma_sync": result["launches"]["paged_prefill"]}, \
            ("every bf16 prefill launch on tensor cores",
             result["launches_by_variant"])
        assert result["launches_by_variant"]["paged_decode"] == {
            "mma_sync": result["launches"]["paged_decode"]}, \
            ("every bf16 decode launch on tensor cores",
             result["launches_by_variant"])
        replay_plain(engine, params, cfg,
                     max(done, key=lambda r: len(r.prompt)))
    prompts = [r.prompt for r in sorted(done, key=lambda r: r.uid)]

    # 5b. serve_speculative: the same requests, every dispatch verifying
    with phase("qwen3 serve_speculative"):
        K.paged_flash_decode.launches = 0
        result, engine, done_s = serve(
            cfg, params, rng, args.seed, (64, 64, 32),
            {"paged_prefill": (K.paged_flash_prefill, "prefill_calls"),
             "paged_verify": (K.paged_flash_verify, "decode_steps")},
            prompts=prompts, speculate=0, spec_min_accept=0)
        assert K.paged_flash_decode.launches == 0, "a decode fallback ran"
        assert result["spec_fallback_dispatches"] == 0
        assert result["launches_by_variant"]["paged_verify"] == {
            "cluster": result["launches"]["paged_verify"]}, \
            ("every bf16 verify launch one launch of clusters",
             result["launches_by_variant"])
        launches["paged_verify"] = result["launches"]["paged_verify"]
        result["agreement_with_fused"] = agreement(done_s, done)
        result["oracle_tokens_agreeing"] = {
            r.uid: oracle_agrees(params, cfg, r, engine.max_seq)
            for r in sorted(done_s, key=lambda r: r.uid)[:3]}
        replay_plain(engine, params, cfg,
                     max(done_s, key=lambda r: len(r.prompt)))
        log(f"[serve_speculative] {json.dumps(result)}; card: {smi}")

    # 5c. serve_legacy: the single-tick loop on four of the requests
    with phase("qwen3 serve_legacy"):
        result, engine, done_l = serve(
            cfg, params, rng, args.seed, (64, 64, 32),
            {"paged_prefill": (K.paged_flash_prefill, "prefill_calls"),
             "paged_decode": (K.paged_flash_decode, "decode_steps")},
            prompts=prompts[:4], fused=False)
        assert result["dispatches"] == result["decode_steps"]
        assert result["launches_by_variant"]["paged_decode"] == {
            "mma_sync": result["launches"]["paged_decode"]}
        for r in done_l:
            replay_plain(engine, params, cfg, r)
        result["oracle_tokens_agreeing"] = oracle_agrees(
            params, cfg, done_l[0], engine.max_seq)
        result["agreement_with_fused"] = agreement(
            done_l, [r for r in done if r.uid < 4])
        log(f"[serve_legacy] {json.dumps(result)}; card: {smi}")
    # the new phases draw from a stream of their own, so the earlier
    # phases' prompts stay as they were
    rng_new = np.random.default_rng([args.seed, 16])

    # 5d. the non-paged cache path on the same weights
    with phase("qwen3 non-paged"):
        result = nonpaged_qwen3(cfg, params, rng_new)
        log(f"[non-paged] {json.dumps(result)}; card: {smi}")
    del params, engine
    torch.cuda.empty_cache()

    # 6. deepseek-v2 at full width, depth cut: kernel path vs plain path in
    # float32 (2 layers) and bf16 (4 layers), each model freed before the
    # next is built
    for dtype in (torch.float32, torch.bfloat16):
        cfg_d = dataclasses.replace(
            cfg_ds, n_layers=DS_DEPTH[dtype],
            param_dtype=str(dtype).removeprefix("torch."))
        with phase(f"deepseek-v2 model {cfg_d.param_dtype}"):
            params = init_params(cfg_d, seed=args.seed, device="cuda")
            log(f"[ds-model] {cfg_d.name} full width, {cfg_d.n_layers} "
                f"layers, {param_count(params)} params {cfg_d.dtype}")
            f32_wrappers = ({
                "paged_latent_prefill_f32": K.paged_latent_prefill,
                "paged_latent_decode_f32": K.paged_latent_decode}
                if dtype == torch.float32 else {})
            _zero_counts(f32_wrappers)
            moe_full_width_parity(cfg_d, params, rng,
                                  share_routing=dtype == torch.bfloat16)
            f32_launches.update(_cuda_core_launches(f32_wrappers))
        if dtype == torch.float32:
            del params
            torch.cuda.empty_cache()

    # 7. serve deepseek-v2 (bf16, 4 layers) through the latent kernels,
    # then replay the whole schedule through the plain path
    with phase("deepseek-v2 serve"):
        result, engine, (calls, routing) = serve(
            cfg_d, params, rng, args.seed, (128, 128, 16),
            {"paged_latent_prefill": (K.paged_latent_prefill,
                                      "prefill_calls"),
             "paged_latent_decode": (K.paged_latent_decode,
                                     "decode_steps")}, record=True)
        log(f"[ds-serve] {json.dumps(result)}; card: {smi}")
        launches.update(result["launches"])
        assert result["launches_by_variant"]["paged_latent_prefill"] == {
            "wgmma": result["launches"]["paged_latent_prefill"]}, \
            ("every bf16 latent prefill launch on wgmma",
             result["launches_by_variant"])
        assert result["launches_by_variant"]["paged_latent_decode"] == {
            "wgmma": result["launches"]["paged_latent_decode"]}, \
            ("every bf16 latent decode launch on wgmma",
             result["launches_by_variant"])
    with phase("deepseek-v2 plain replay"):
        replay = replay_schedule(engine, params, cfg_d, calls, routing)
        log(f"[ds-serve] plain-path replay agrees: {json.dumps(replay)}")
    done = list(engine.done)
    del engine, calls, routing

    # 7b. serve_speculative on deepseek-v2: the same requests through the
    # latent verify entry, then the whole schedule (verify windows
    # included) replayed through the plain path on the served routing
    with phase("deepseek-v2 serve_speculative"):
        K.paged_latent_decode.launches = 0
        result, engine, (calls, routing) = serve(
            cfg_d, params, rng, args.seed, (128, 128, 16),
            {"paged_latent_prefill": (K.paged_latent_prefill,
                                      "prefill_calls"),
             "paged_latent_verify": (K.paged_latent_verify,
                                     "decode_steps")}, record=True,
            prompts=[r.prompt for r in sorted(done, key=lambda r: r.uid)],
            speculate=0, spec_min_accept=0)
        assert K.paged_latent_decode.launches == 0, "a decode fallback ran"
        assert result["launches_by_variant"]["paged_latent_verify"] == {
            "cluster": result["launches"]["paged_latent_verify"]}, \
            ("every bf16 latent verify launch one launch of clusters",
             result["launches_by_variant"])
        launches["paged_latent_verify"] = \
            result["launches"]["paged_latent_verify"]
        # MoE capacity depends on the tokens of a call (B x W in verify, B
        # in a decode tick): printed, not gated
        result["agreement_with_fused"] = agreement(engine.done, done)
        log(f"[ds-serve_speculative] {json.dumps(result)}; card: {smi}")
        replay = replay_schedule(engine, params, cfg_d, calls, routing)
        log(f"[ds-serve_speculative] plain-path replay agrees: "
            f"{json.dumps(replay)}")
    del engine, calls, routing, done
    torch.cuda.empty_cache()

    # 7c. deepseek-v2's dense latent cache against the paged latent path
    with phase("deepseek-v2 non-paged"):
        result = nonpaged_deepseek(cfg_d, params, rng_new)
        log(f"[ds-non-paged] {json.dumps(result)}; card: {smi}")
    del params
    torch.cuda.empty_cache()

    # 7d-7f. the SSM, hybrid and enc-dec families at full width
    with phase("mamba2 model"):
        for result in ssm_model(get_arch("mamba2-780m"), args.seed, rng_new):
            log(f"[mamba2] {json.dumps(result)}; card: {smi}")
    with phase("zamba2 model"):
        result = hybrid_model(get_arch("zamba2-7b"), args.seed, rng_new)
        log(f"[zamba2] {json.dumps(result)}; card: {smi}")
        launches["flash_attention_d112"] = result["flash"]["launches"]
    with phase("seamless model"):
        result = encdec_model(get_arch("seamless-m4t-medium"), args.seed,
                              rng_new)
        log(f"[seamless] {json.dumps(result)}; card: {smi}")
        launches["flash_attention_cross"] = result["flash"]["cross_launches"]

    # 8. full-width qwen3-0.6b train-step parity, kernel path vs plain
    # path: float32 at depth 2, bf16 at depth 28
    with phase("qwen3 train-step parity"):
        result = train_step_parity(dataclasses.replace(
            cfg, param_dtype="float32", n_layers=TRAIN_F32_DEPTH), args.seed)
        # row 5f's and 5bf's shape, on wgmma_tf32x3
        launches["flash_attention_f32"] = \
            result["flash"]["forward"]["launches"]
        launches["flash_attention_bwd_f32"] = \
            result["flash"]["backward"]["launches"]
        train_step_parity(cfg, args.seed)

    # 9. train full-width qwen3-0.6b through the flash kernels
    with phase("qwen3 train"):
        result = train(cfg, args.seed, smi)
        launches.update(result["launches"])
    torch.cuda.empty_cache()

    # 9b. the new families' train-step parity at full width: seamless (bf16
    # and float32, full depth; its cross-attention through kernel 5b at
    # Sq != Sk), zamba2 (bf16, 2 of its 9 groups; 5 and 5b at D 112)
    seamless = get_arch("seamless-m4t-medium")
    zamba2 = get_arch("zamba2-7b")
    zamba2 = dataclasses.replace(
        zamba2, n_layers=HYBRID_TRAIN_GROUPS * zamba2.attn_every)
    with phase("seamless train-step parity"):
        for dtype in ("bfloat16", "float32"):
            result = train_step_parity(dataclasses.replace(
                seamless, param_dtype=dtype), args.seed, **ENCDEC_TRAIN)
        # the float32 evaluation's cross-attention: rows 5f and 5bf at
        # seamless's cross shape
        launches["flash_attention_cross_f32"] = \
            result["flash"]["forward"]["cross_launches"]
        launches["flash_attention_bwd_cross_f32"] = \
            result["flash"]["backward"]["cross_launches"]
    with phase("zamba2 train-step parity"):
        train_step_parity(zamba2, args.seed, **HYBRID_TRAIN)

    # 9c. Trainer steps on each new family
    with phase("family train"):
        result = train_family(seamless, args.seed, smi, **ENCDEC_TRAIN)
        launches["flash_attention_bwd_cross"] = \
            result["flash"]["backward"]["cross_launches"]
        # the decoder's self-attention (rows 5t, 5bt): the forward's calls
        # less the encoder's and the cross ones (two a layer a step, with
        # remat); the backward's split calls less the cross ones
        fwd, bwd = result["flash"]["forward"], result["flash"]["backward"]
        launches["flash_attention_self"] = (
            fwd["launches"] - fwd["cross_launches"]
            - 2 * seamless.n_enc_layers * FAMILY_TRAIN_STEPS)
        launches["flash_attention_bwd_self"] = (
            bwd["variants"].get("cluster", 0) - bwd["cross_launches"])
        result = train_family(zamba2, args.seed, smi, **HYBRID_TRAIN)
        launches["flash_attention_bwd_d112"] = \
            result["flash"]["backward"]["launches"]
        train_family(get_arch("mamba2-780m"), args.seed, smi, **SSM_TRAIN)

    # 9d. gemma2-2b trains through kernels 5 and 5b at D 256
    with phase("gemma2 train"):
        result = gemma2_train(args.seed, smi, parent)
        launches["flash_attention_d256"] = \
            result["flash"]["forward"]["launches"]
        launches["flash_attention_bwd_d256"] = \
            result["flash"]["backward"]["launches"]

    # 10. the paper's PACO algorithms at full size, through the matmul and
    # LCS kernels
    with phase("paco algorithms"):
        launches.update(paco_algorithms(args.seed, smi))

    # 11. the meshed paths on a one-rank NCCL group (a 1 x 1 mesh): the
    # same kernels, the same answers and the same launch counts as above
    with phase("mesh"):
        log(f"[mesh] launches on the mesh: "
            f"{json.dumps(mesh_phase(args.seed, smi))}")

    # 12. the launch tooling: the dry-run's count against the real step on
    # the card, a production-mesh cell traced on the host, the examples
    with phase("launch tooling"):
        launch_phase(args.seed, smi)

    launches.update(f32_launches)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
