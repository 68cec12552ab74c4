#!/usr/bin/env python3
"""Drive the PyTorch port of LazyBatching on one NVIDIA H100.

    python3 chip_smoke.py

Phases, always all of them, in order:

  build    compile every CUDA source of ``src/repro_torch/csrc`` with nvcc
           (one process per source, all started together); print seconds
           and what ptxas reports per kernel, then the bf16 flash kernel's
           instantiation at each served shape (registers, spill bytes, CTAs
           an SM holds, heads a CTA: two at recurrentgemma-9b's B 4 x S
           512, one at its serve's prefill of 384); fail when the RMSNorm
           kernel, the float32 flash
           kernel at D 64, any instantiation of the bf16 flash kernel, a
           flash or ragged decode kernel at D 256, any instantiation of
           ragged decode's three tensor-core kernels, a kernel of the SSD
           scan's split-TF32 route or its tensor-core scan spills (the
           scan's registers, spill bytes and CTAs an SM are printed at
           each state size, and the decode tensor-core kernels',
           with their shared memory and the clusters of 8 the card holds,
           at each head dim), when the ragged decode library holds no
           TF32 tensor-core (HMMA) instruction,
           when ptxas serializes the wgmmas of a flash kernel at D 256 (the
           float32 one's 255 registers a thread leave no room; the bf16
           one in either layout), when the flash or
           SSD library holds no
           HGMMA (wgmma) instruction, or when either holds no TF32
           tensor-core instruction.
  kernels  run each hand-written kernel against its plain PyTorch version on
           the card at the serving paths' shapes (flash at llama's, nemo's
           and MiniCPM3's MLA prefill, whose q and k are 96 wide and v 64,
           and at recurrentgemma-9b's, 16 q heads over one kv head of 256
           with its window of 2048, at S 512 and at S 4096 where the window
           binds, and at its serve's prefill of one request of 384; in
           bfloat16 at S 512 and 4096 it takes two heads a CTA and is also
           held and timed against the one-head layout on the same inputs,
           in turns, and fails when its device time is the longer, and
           200 launches in a row must agree bit for bit; ragged decode at
           llama's, nemo's, granite's and
           recurrentgemma-9b's heads (G 16, D 256), and without slots
           over a contiguous (B, 256) stack at B 3 and 7, the legacy
           engine's decode, at llama's heads and at G 16 / D 256, and
           in bfloat16 at recurrentgemma-9b's decode_32k (B 128 over
           full rings of 2048); the bfloat16 cases at G 16 take the
           tensor-core kernel, those at G <= 8 (llama's, nemo's D 128,
           granite's G 3, with and without slots) the n8 kernel, the
           float32 cases at G <= 8 the split-TF32 n8 kernel, and each
           is also held and timed against the CUDA-core kernel through
           its C entry on the same inputs, in turns, and fails when its
           device time is the longer; RMSNorm
           at llama's width 2048, mamba's 2560 and 5120 and
           recurrentgemma-9b's 4096;
           the SSD scan at
           chunks 256, 128
           and 64, which take its tensor-core route in bfloat16 and its
           split-TF32 route in float32, at 1, 2 and 32, which take the
           tensor-core scan in bfloat16 and the recurrent route in
           float32, and at 200, which takes the CUDA-core route;
           the route of each case is printed and checked, with its device
           time by kernel; the split-TF32 cases and the bfloat16 cases at
           chunks 1, 2 and 32 are also held and timed against the pair
           they replaced (the CUDA-core pair; the recurrent pair) on the same
           inputs, device time in turns too, and fail when their device
           time is the longer), in float32
           (tolerance 2e-5; the SSD scan 1e-4) and bfloat16 (2e-2; the SSD
           scan 5e-2 on y, 1e-4 on its float32 final state, and in both
           types every head's ||y - y_ref|| / ||y_ref|| below 1e-2; the
           float32 flash lines name the kernels the library call ran; at S
           512 the float32 flash kernel's output, and at chunk 256 the
           float32 SSD scan's, must be the same bit for bit over 200
           launches in a row); time kernel, plain version and one PyTorch
           library call where one computes the same
           function (the yardstick, never used by the port) as medians over
           CUDA events with the L2 flushed before each call, and as device
           time from the profiler; time the host's cost per call as the
           mean over 200 back-to-back calls with no synchronize inside;
           take kernel and library call in turns (library, kernel, kernel,
           library) for events and host time and report the mean of each
           one's two turns; compute each call's roofline bound at 3.35 TB/s
           and the card's peak rate for the input type (float32: three
           TF32 products per product, 495 / 3 TFLOP/s). A hand-written
           kernel whose trace recorded no device time, or fewer records of
           a kernel its calls launch than calls traced (the SSD scan's by
           route), fails the phase (such a trace is taken again with
           longer pads, three times in all). At the training path's shapes
           (flash in float32 and bfloat16 at (8, 256, 32 / 8, 64), in
           float32 at MLA's (8, 256, 40, 96 / 64) and at hybrid training's
           (8, 256, 16 / 1, 256) with its window of 2048; RMSNorm float32 (8,
           256, 2048); the SSD scan float32 at (4, 256, 80, 64), chunks
           256 and 32) each wrapper also runs under autograd: its output
           has its Function's grad_fn and its forward launched the kernel,
           and every input's gradient for one random upstream gradient
           agrees with autograd through the plain version at the forward's
           tolerance; the backward's device time (PyTorch ops) is printed.
           Only RMSNorm's closed-form backward and the SSD scan's at chunk
           32 (the recurrent plain version against the chunked one) are
           computed otherwise than their reference side: flash's and the
           SSD scan's at chunk 256 re-run the reference's own plain version
           under autograd, so those comparisons check the wiring (the
           Function is taken, its saved inputs and the gradients' order),
           not the gradient's arithmetic, which ``train exact`` and
           ``train mamba`` hold against the CPU.
  serve    full-width llama3.2-1b (16 layers, d_model 2048, random weights
           from a seed) in bfloat16: TorchEngine + ServingSession +
           LazyBatching(max_batch=8) serve 24 Poisson-arriving requests
           after a warmup over every prompt length and batch bucket (the
           dispatch shape keys first seen in the measured serve are
           printed); checks every handle DONE, streamed tokens == engine
           tokens, and
           that every kernel of the llama path (ragged decode, RMSNorm,
           flash prefill) launched during this phase, every ragged decode
           on the n8 route (``ragged_decode_attention_n8``; nemo serve and
           granite serve the same).
  exact    full width in float32 with TF32 off: four requests served
           batched (fused runs), then each alone through the same engine
           (node by node); tokens must be equal, apart from near-ties
           (reference top-2 logit gap below 1e-3), which are printed. The
           launch counters are reset before and read after each of the two
           paths: every kernel of the path must have run on both, every
           ragged decode on the split-TF32 n8 route
           (``ragged_decode_attention_n8_tf32``; float32 at G <= 8) and
           none on either bf16 tensor-core route or the CUDA-core kernel
           (nemo exact and granite exact the same).
  mamba serve  full-width mamba2-2.7b (64 layers, d_model 2560, 80 SSD
           heads of 64, state 128) in bfloat16, as the serve phase: 24
           requests at 20/s with prompts of 128, 257, 259 and 384 tokens
           (prefill lengths 127, 256, 258 and 383: SSD chunks 1, 256, 2
           and 1, as uniform prompt lengths give half chunk 1, a quarter
           chunk 2), after a warmup over every prompt length; RMSNorm and
           the SSD scan, on its tensor-core route (chunk 256) and its
           tensor-core scan (chunks 1 and 2), must launch, and its
           recurrent route must not.
  mamba exact  as exact, on full-width mamba2-2.7b in float32, with prompts
           of 34, 97, 257 and 385 tokens: SSD chunks 1 and 32 (the
           recurrent route), 256 and 128 (the split-TF32 route), each
           route launched on the batched and on the isolated path.
  nemo serve  full-width mistral-nemo-12b (40 layers, d_model 5120, 32 q /
           8 kv heads of 128, d_ff 14336, vocab 131072, an untied head:
           12.25 B parameters, 24.5 GB) in bfloat16, as the serve phase;
           flash and ragged decode at head_dim 128 and 4 q heads per kv
           head, RMSNorm at 5120; prints the parameters on the card and
           the bytes allocated.
  nemo exact  as exact, on full-width mistral-nemo-12b at all 40 layers in
           float32 (49 GB of weights): the float32 flash kernel at
           head_dim 128 on a served path.
  minicpm serve  full-width minicpm3-4b (62 layers, d_model 2560, 40 MLA
           heads: q_lora 768, kv_lora 256, nope 64 / rope 32 / v 64, d_ff
           6400, vocab 73448, tied: 4.1 B parameters, 8.2 GB) in bfloat16,
           as the serve phase: MLA prefill through flash with q and k 96
           wide and v 64, decode over the latent (ckv, krope) arena in
           PyTorch ops; RMSNorm and flash must launch, ragged decode must
           not.
  minicpm exact  as exact, on full-width minicpm3-4b at all 62 layers in
           float32 (16 GB): the float32 flash kernel at (96, 64) on a
           served path.
  granite serve  full-width granite-moe-3b-a800m (32 layers, d_model 1536,
           24 q / 8 kv heads of 64, 40 experts top 8 of d_ff 512, vocab
           49155, tied: 3.3 B parameters, 6.6 GB) in bfloat16, as the serve
           phase: GQA at G 3 on the llama kernels, the MoE FFN in PyTorch
           ops (each request prefills at its exact length: padding would
           take expert capacity).
  granite exact  as exact, on full-width granite-moe-3b-a800m in float32.
  rgemma serve  full-width recurrentgemma-9b (38 layers: 12 x (rec, rec,
           attn) and 2 rec, d_model 4096, RG-LRU width 4096, 16 q heads
           over 1 kv head of 256 with a local window of 2048, d_ff 12288,
           vocab 256000, tied: 9.40 B parameters, 18.8 GB) in bfloat16, as
           the serve phase: flash prefill and ragged decode at head_dim 256,
           RMSNorm at 4096, the RG-LRU in PyTorch ops (each request
           prefills at its exact length: padding would run through the
           recurrence); every ragged decode launch must be on the
           tensor-core route (``ragged_decode_attention_tc``), none on
           the CUDA-core kernel. Also prints the device ops of one decode
           layer-step of a rec layer and of an attn layer apart, at batch 8.
  rgemma exact  as exact, on full-width recurrentgemma-9b at all 38 layers
           in float32 (37.6 GB): the float32 flash kernel at D 256 (split
           TF32 on the tensor cores, ``flash_tf32x3_d256_kernel``) and the
           float32 ragged decode at D 256 on both paths, on the CUDA-core
           kernel alone (G 16: no tensor-core route may launch).
  variants  the ``RuntimeFlags`` variants through the ``Model`` API
           (``prefill`` / ``decode_step`` / ``init_cache``), seed-0
           weights at full width. window: llama3.2-1b at full depth in
           bfloat16 with ``window`` 8192 (its ``long_context_window``),
           ring caches of ``init_cache(4, 524288)`` (8192 rows, 1.07 GB)
           filled from a seed, 32 greedy decode steps at positions around
           524288 with two rows wrapping the ring (ms per step; ragged
           decode and RMSNorm launch). window exact: llama3.2-1b and
           minicpm3-4b at 2 layers, float32, TF32 off, window 256:
           prefill 4 x 200 through windowed flash (D 64; MLA's 96 / 64),
           the prefill cache padded into the ring, 100 decode steps that
           wrap it (MLA's ring decode in PyTorch ops), the CPU's greedy
           tokens fed to both: logits card vs CPU within 1e-3 and greedy
           tokens equal or a near-tie. int8 kv: llama3.2-1b full depth,
           bfloat16, 8 rows prefilled over prompts 64 / 128 / 256 / 384
           into an exact and a ``kv_quant`` cache (``init_cache(8,
           1024)``): cache bytes, layer 0's attention over both within the
           reference test's bound (rtol 0.1, atol 0.05), 64 greedy steps
           from each (ms per step, the share of equal tokens, max |d
           logit|); then 2 layers in float32 card vs CPU: int8 entries at
           most one level apart (counted), logits within 1e-3 until one
           is, 2e-2 after. mla absorbed: minicpm3-4b full depth, bfloat16,
           prefill 4 x 512 with and without ``mla_absorbed`` in turns
           (times, max |d logit|; flash must not launch on the absorbed
           path), then 2 layers in float32 card vs CPU without a window
           and with 256. moe groups: granite-moe-3b-a800m at 2 layers in
           float32, card vs CPU: a decode step at B 8 in routing groups of
           4 rows (capacity 1) and prefill 4 x 64 in groups of 2, with the
           (token, expert) pairs dropped counted; then full depth in
           bfloat16, one decode step at B 8 in groups of 4, timed. The
           phase's launches go on its own line, not into the JSON rows.
  legacy   ``TorchEngine(cache_mode="legacy")`` (per-request caches,
           restacked at every decode node, B unpadded, no slots) beside
           the arena: full-width llama3.2-1b in legacy, arena (node by
           node) and fused mode as ``benchmarks/engine_decode_bench.py``
           runs them (batch 8, max_len 256, prompt 16, 24 merged decode
           cycles, a warmup pass over an identical batch, then a fresh
           same-seed batch timed on the same engine), one set of seed-0
           weights: in float32 with TF32 off the tokens of the three
           must be equal; in bfloat16 the median ms per cycle of each
           (host clock, beside the card's name and power limit), the
           arena-vs-legacy and fused-vs-arena ratios, the tokens that
           agree with legacy's, the timed pass's new shape keys (none
           allowed), host syncs and nodes, and one request's legacy
           cache bytes; flash, ragged decode and RMSNorm must launch in
           legacy mode in both types. Then mamba2-2.7b, minicpm3-4b,
           granite-moe-3b-a800m (2 layers each) and recurrentgemma-9b (4:
           rec, rec, attn, rec) at full width, depth the only cut, in
           float32 with TF32 off: prompts 64 / 128 / 256 / 384 x 16
           tokens through ServingSession + LazyBatching in arena mode
           (fused runs) and in legacy mode on the same weights, tokens
           equal or a printed near-tie, each family's kernels launched in
           legacy mode (the SSD scan in mamba's; ragged decode not in
           minicpm3's). Launches go on the phase's own line.
  launch serve  the port's launcher, ``repro_torch.launch.serve``, in
           process on full-width llama3.2-1b in bfloat16 (20/s for 1.2 s,
           max_batch 8, SLA 10 s) with seeded transient faults (0.02 per
           run, 16 retries) and ``--assert-no-leak``: exit code 0, every
           request DONE with its tokens, faults injected and retried, no
           slot live after the drain, the three llama kernels launched. A
           retried request may have streamed a prefix of its voided
           attempt that its bf16 replay, batched otherwise, does not
           reproduce; such requests are counted and printed. The same
           trace then runs in float32 with TF32 off, with and without the
           faults: every request's tokens must equal the fault-free run's.
  launch tenants  the launcher's multi-tenant path: full-width llama3.2-1b
           and mamba2-2.7b behind one MultiBackend, 16 slots split between
           their arenas, the least-slack arbiter, 16/s for 1.5 s: both
           models complete every request, the SSD scan and the llama
           kernels launch; per-model p50 / p99, busy time and peak memory
           are printed.
  gateway  ``repro_torch.launch.gateway``'s app on port 0 over full-width
           llama3.2-1b in bfloat16 (tiers gold 2 s and bulk 10 s, 16
           slots): 16 concurrent SSE streams and one that disconnects after
           its first token, driven by a small asyncio client of this
           script; every stream ends done with its handle's tokens, the
           disconnected one CANCELLED, ``/metrics`` answers 200, no slot
           is live after the drain, the llama kernels launched. Client
           wall TTFT, SLA attainment by tier and the event loop's stalls
           are printed, not gated.
  train    ``repro_torch.launch.train`` (``--arch llama3.2-1b --steps 30
           --batch 8 --seq 256 --checkpoint build/train_llama.npz``) run
           through its ``train`` (its mesh path: a 1-rank NCCL ``data``
           mesh, DTensor state, the train rules; the group is ended after
           the phase), in float32 with TF32 as the earlier phases left it
           (off): every parameter leaf has a finite,
           nonzero gradient at step 0 (the launcher's weights and first
           batch), the launcher exits 0 with a falling loss, flash and
           RMSNorm launch and ragged decode does not, the checkpoint
           restores bit for bit, the trace of 3 more steps shows the flash
           and RMSNorm kernels; prints seconds per step after step 0,
           training tokens/s, peak memory, ``model_flops(cfg, tokens,
           train=True)`` per second as a share of the 67 TFLOP/s f32 peak,
           the SM clock and power draw sampled by nvidia-smi every 500 ms
           over the launcher's run (min / median / max), and the
           device-busy share and top kernels of 3 traced steps.
  train exact  full-width llama3.2-1b, float32 with TF32 off, one sequence
           of 64 tokens: the loss and every leaf's gradient on the card
           (kernels) against the CPU (plain versions) from the same
           weights: loss rtol 1e-5, each leaf ||dg|| / ||g|| <= 1e-3; the
           worst leaf is printed.
  train mamba  mamba2-2.7b at full width cut to 8 of its 64 layers (the
           only cut), float32, 10 steps of 4 x 256 through ``train_loop``:
           the loss falls, every parameter stays finite, and the SSD scan's
           split-TF32 route and RMSNorm launch in the forward; then, from
           fresh weights with TF32 off, one sequence of 64 tokens (SSD
           chunk 64, the split-TF32 route): the loss and every leaf's
           gradient on the card against the CPU, at ``train exact``'s
           tolerances.
  sharding  full-width llama3.2-1b, float32, TF32 off, 8 x 256, seed 0:
           ``repro_torch.launch.train`` (10 steps) through its mesh path
           (a 1-rank NCCL ``data`` mesh: the card is one H100) against
           ``train_loop`` on plain tensors from the same weights and
           batches: every logged loss within rtol 1e-6 (bit-equality
           printed), flash and RMSNorm launched inside the mesh run, and
           seconds per step of both, a step of each in turns (median of
           6); then ``RuntimeFlags.remat`` off / "full" / "dots" on one
           forward and backward of the same model and batch: the loss
           equal and every leaf's gradient bit-equal or within ||dg|| /
           ||g|| <= 1e-6 of remat off, and flash / RMSNorm launches twice
           the blocks' (the final norm once); then one train step of each
           mode in turns (off, full, dots, dots, full, off): seconds and
           peak memory allocated. Each number line carries the card's name
           and power limit.
  roofline  the dry-run tools (last). (a) ``python -m
           repro_torch.launch.dryrun --all`` in a process of its own (a
           fake group of 256 ranks, the (data 16, model 16) mesh, 7 worker
           processes, its own time limit) under this machine's torch: all
           40 combinations must trace; prints how many did and the slowest.
           (b) four serve steps of ``launch.steps.build_combo`` on a 1-rank
           NCCL (data 1, model 1) mesh at full width, seed-0 bf16 weights,
           at ``num_layers`` base and 2 x base (base 3 for the hybrid, else
           1): llama3.2-1b decode_32k (B 128 over a 32768-row cache, every
           position 32767: ragged decode), llama3.2-1b prefill_32k (B 32 x
           32768: flash and RMSNorm), mamba2-2.7b prefill_32k (the SSD
           scan's tensor-core route at chunk 256) and recurrentgemma-9b
           decode_32k (ragged decode at D 256, G 16): the mesh step's logits
           against the same step on plain tensors (bf16 tolerance 2e-2;
           bit-equality printed), each kernel of the path launched, and
           per layer (t(2 x base) - t(base)) / base by CUDA events of both
           (the faster of two turns, each the median of 3 calls, each call
           queued behind a 100 ms spin kernel so that the events time the
           device and not DTensor's host dispatch; the plain
           step runs on a copy of a decode's cache);
           beside them the roofline's per-layer terms of the same
           combination on a (1, 1) mesh (``python -m
           repro_torch.launch.roofline --mesh 1x1``, computed from the H100
           constants), the analytic bound (``analytic_bytes`` / 3.35 TB/s
           or ``model_flops`` / 989 TFLOP/s, the larger) and each kernel's
           device time per layer (profiler, the mean of 3 traces of a
           step, each holding at least each kernel's launches in it: a
           trace that lost a record is taken again) beside its bound. A measured layer, or a
           kernel's row, under 0.95 x its bound (or below zero) fails: the
           counts would be wrong.

Each serve's profile window must show every hand-written kernel whose
launch counter moved in its traced serve; a window whose trace still
lacks one after its tries prints its shares as not measured.

Each phase frees its engine before the next one builds, and ends with a
line that counts its profiler sessions and those that came back empty
or incomplete. Any failure exits 1 and prints ``[fail] <phase>:
<type>: <message>`` on stdout and on stderr, with the last frames of the
traceback for anything but a failed check. The last lines are the card's
name and power limit, one JSON line of per-kernel numbers (bfloat16 at the
serves' main shapes, the bfloat16 SSD scan's tensor-core scan at chunk
1, S 383, launched in ``mamba serve``, the float32 SSD scan's split-TF32
route at chunk 256, whose launches are those of ``mamba exact``'s batched
and isolated paths together, and flash and ragged decode at head_dim 128
in bfloat16, launched in ``nemo serve``, and float32, in ``nemo exact``;
ragged decode in float32 at llama's heads and at granite's G 3 (the
split-TF32 n8 kernel), launched in ``exact`` and ``granite exact``;
flash at
MiniCPM3's widths in bfloat16, launched in ``minicpm serve``, and
float32, in ``minicpm exact``; ragged decode at granite's G 3 in
bfloat16, launched in ``granite serve``; flash and ragged decode at
head_dim 256 in bfloat16, launched in ``rgemma serve`` (ragged decode:
its tensor-core route's launches there), and float32, in
``rgemma exact``, and RMSNorm at 4096 in bfloat16, launched in ``rgemma
serve``; float32 flash at (8, 256, 32 / 8, 64) and RMSNorm at (8, 256,
2048), launched in ``train``, and the float32 SSD scan at (4, 256, 80,
64) chunk 256, launched in ``train mamba``, each with its backward's
device time), and ``{"ok": true, ...}``.
Exits non-zero before printing any result when no CUDA device is
present.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
# float32 work at float32 accuracy can run on the tensor cores as three TF32
# products per product (hi*hi + hi*lo + lo*hi), so its least time is the
# lower of the CUDA cores' 67 TFLOP/s and a third of dense TF32's 495
PEAK_FLOPS = {"bfloat16": 989e12,             # dense bf16 tensor cores
              "float32": max(67e12, 495e12 / 3)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}    # y; its f32 states: 1e-4
SSD_HEAD_REL_TOL = 1e-2          # per head: ||y - y_ref|| / ||y_ref||
DECODE_TPU = "src/repro/kernels/ragged_decode_attn.py:92"
FLASH_TPU = "src/repro/kernels/flash_attn.py:72"
REPLACES = {
    "ragged_decode_attention": DECODE_TPU,
    "fused_rmsnorm": "src/repro/kernels/rmsnorm.py:28",
    "flash_attention": FLASH_TPU,
    "ssd_chunked": "src/repro/kernels/ssd_chunk.py:64",
    "ssd_chunked_tf32": "src/repro/kernels/ssd_chunk.py:64",
    "ssd_chunked_tc_scan": "src/repro/kernels/ssd_chunk.py:64",
    "ragged_decode_attention_d128": DECODE_TPU,
    "ragged_decode_attention_f32_d128": DECODE_TPU,
    "flash_attention_d128": FLASH_TPU,
    "flash_attention_f32_d128": FLASH_TPU,
    "flash_attention_mla": FLASH_TPU,
    "flash_attention_f32_mla": FLASH_TPU,
    "ragged_decode_attention_g3": DECODE_TPU,
    "ragged_decode_attention_f32": DECODE_TPU,
    "ragged_decode_attention_f32_g3": DECODE_TPU,
    "flash_attention_d256": FLASH_TPU,
    "flash_attention_f32_d256": FLASH_TPU,
    "ragged_decode_attention_d256": DECODE_TPU,
    "ragged_decode_attention_f32_d256": DECODE_TPU,
    "fused_rmsnorm_4096": "src/repro/kernels/rmsnorm.py:28",
    "flash_attention_f32_train": FLASH_TPU,
    "fused_rmsnorm_f32_train": "src/repro/kernels/rmsnorm.py:28",
    "ssd_chunked_tf32_train": "src/repro/kernels/ssd_chunk.py:64",
}
DECODE_CU = ("cuda", "src/repro_torch/csrc/ragged_decode_attn.cu")
FLASH_CU = ("cuda", "src/repro_torch/csrc/flash_attn.cu")
SOURCES = {
    "ragged_decode_attention": DECODE_CU,
    "fused_rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu"),
    "flash_attention": FLASH_CU,
    "ssd_chunked": ("cuda", "src/repro_torch/csrc/ssd_chunk.cu"),
    "ssd_chunked_tf32": ("cuda", "src/repro_torch/csrc/ssd_chunk.cu"),
    "ssd_chunked_tc_scan": ("cuda", "src/repro_torch/csrc/ssd_chunk.cu"),
    "ragged_decode_attention_d128": DECODE_CU,
    "ragged_decode_attention_f32_d128": DECODE_CU,
    "flash_attention_d128": FLASH_CU,
    "flash_attention_f32_d128": FLASH_CU,
    "flash_attention_mla": FLASH_CU,
    "flash_attention_f32_mla": FLASH_CU,
    "ragged_decode_attention_g3": DECODE_CU,
    "ragged_decode_attention_f32": DECODE_CU,
    "ragged_decode_attention_f32_g3": DECODE_CU,
    "flash_attention_d256": FLASH_CU,
    "flash_attention_f32_d256": FLASH_CU,
    "ragged_decode_attention_d256": DECODE_CU,
    "ragged_decode_attention_f32_d256": DECODE_CU,
    "fused_rmsnorm_4096": ("cuda", "src/repro_torch/csrc/rmsnorm.cu"),
    "flash_attention_f32_train": FLASH_CU,
    "fused_rmsnorm_f32_train": ("cuda", "src/repro_torch/csrc/rmsnorm.cu"),
    "ssd_chunked_tf32_train": ("cuda", "src/repro_torch/csrc/ssd_chunk.cu"),
}
# the JSON row a kernels-phase case fills, by (kernel, dtype, head dim):
# llama's bf16 shapes and its float32 decode (its exact check),
# mistral-nemo-12b's D 128 in bf16 (its serve) and float32 (its exact
# check), minicpm3-4b's MLA prefill (q and k 96 wide) and
# recurrentgemma-9b's D 256 in both; granite's G 3 decode rows and the
# RMSNorm row at 4096 are named by their cases
ROWS = {("ragged_decode_attention", "bfloat16", 64): "ragged_decode_attention",
        ("ragged_decode_attention", "float32", 64):
            "ragged_decode_attention_f32",
        ("flash_attention", "bfloat16", 64): "flash_attention",
        ("ragged_decode_attention", "bfloat16", 128):
            "ragged_decode_attention_d128",
        ("ragged_decode_attention", "float32", 128):
            "ragged_decode_attention_f32_d128",
        ("flash_attention", "bfloat16", 128): "flash_attention_d128",
        ("flash_attention", "float32", 128): "flash_attention_f32_d128",
        ("flash_attention", "bfloat16", 96): "flash_attention_mla",
        ("flash_attention", "float32", 96): "flash_attention_f32_mla",
        ("ragged_decode_attention", "bfloat16", 256):
            "ragged_decode_attention_d256",
        ("ragged_decode_attention", "float32", 256):
            "ragged_decode_attention_f32_d256",
        ("flash_attention", "bfloat16", 256): "flash_attention_d256",
        ("flash_attention", "float32", 256): "flash_attention_f32_d256"}
# a substring of each hand-written kernel's symbol, for the profile windows
SYMBOLS = {"ragged decode (CUDA cores)": "ragged_decode_split_kernel",
           "ragged decode (bf16, tensor cores, G > 8)":
               "ragged_decode_tc_kernel",
           "ragged decode (bf16, tensor cores, G <= 8)":
               "ragged_decode_n8_kernel",
           "ragged decode (f32, split TF32 tensor cores, G <= 8)":
               "ragged_decode_n8_tf32_kernel",
           "flash prefill (bf16, tensor cores)": "flash_tc_kernel",
           "flash prefill (f32, split TF32 tensor cores)":
               "flash_tf32x3_kernel",
           "flash prefill (f32, split TF32 tensor cores, D 256)":
               "flash_tf32x3_d256_kernel",
           "SSD scan": "ssd_", "RMSNorm": "rmsnorm_kernel"}
# a substring of every ragged decode kernel's symbol
DECODE_ANY = "ragged_decode_"
# the symbols (substrings) of the kernels one call launches: the SSD
# scan's by route, the others' by launch counter in bfloat16 (the serves'
# type; float32 flash runs flash_tf32x3_kernel). A trace that lacks one of
# them lost device records and is taken again.
SSD_ROUTE_SYMBOLS = {
    "recurrent": ("ssd_scores_kernel", "ssd_recurrent_kernel"),
    "tf32": ("ssd_scores_tf32_kernel", "ssd_intra_tf32_kernel",
             "ssd_state_pass_kernel"),
    "tc": ("ssd_intra_tc_kernel", "ssd_state_pass_kernel"),
    "cuda_cores": ("ssd_intra_kernel", "ssd_state_pass_kernel"),
    "tc_scan": ("ssd_tc_scan_kernel",),
}
COUNTER_SYMBOLS = {
    # every ragged decode launch, any route: a prefix of every kernel
    "ragged_decode_attention": (DECODE_ANY,),
    "ragged_decode_attention_tc": ("ragged_decode_tc_kernel",),
    "ragged_decode_attention_n8": ("ragged_decode_n8_kernel",),
    "ragged_decode_attention_n8_tf32": ("ragged_decode_n8_tf32_kernel",),
    "fused_rmsnorm": ("rmsnorm_kernel",),
    "flash_attention": ("flash_tc_kernel",),
    **{f"ssd_chunked_{route}": syms
       for route, syms in SSD_ROUTE_SYMBOLS.items() if route != "cuda_cores"},
}
# the kernels each serving path must launch; the bf16 mamba serve runs the
# SSD scan's tensor-core route (ssd_chunked_tc counts it) and its
# tensor-core scan (ssd_chunked_tc_scan), not its recurrent route; its
# float32 exact check the recurrent route and the split-TF32 route
# (ssd_chunked_tf32)
LLAMA_KERNELS = ("ragged_decode_attention", "fused_rmsnorm", "flash_attention")
# the bf16 serves of llama3.2-1b, mistral-nemo-12b and granite-moe-3b-a800m
# (G 4 at D 64 and 128, G 3 at D 64): every ragged decode on the n8 route;
# their float32 exact checks every ragged decode on the split-TF32 n8
# route, neither bf16 route; recurrentgemma-9b's (G 16) on the CUDA-core
# kernel alone
DENSE_KERNELS = LLAMA_KERNELS + ("ragged_decode_attention_n8",)
DENSE_EXACT_KERNELS = LLAMA_KERNELS + ("ragged_decode_attention_n8_tf32",)
EXACT_ABSENT = ("ragged_decode_attention_tc", "ragged_decode_attention_n8")
RGEMMA_EXACT_ABSENT = EXACT_ABSENT + ("ragged_decode_attention_n8_tf32",)
# a route's launch counter, each of whose paths must run every decode on it
DECODE_ROUTES = ("tc", "n8", "n8_tf32")
MAMBA_KERNELS = ("ssd_chunked", "ssd_chunked_tc", "ssd_chunked_tc_scan",
                 "fused_rmsnorm")
MAMBA_ABSENT = ("ssd_chunked_recurrent",)
MAMBA_EXACT_KERNELS = ("ssd_chunked", "ssd_chunked_recurrent",
                       "ssd_chunked_tf32", "fused_rmsnorm")
# recurrentgemma-9b's local attention runs the llama kernels at D 256 (the
# RG-LRU is PyTorch ops); minicpm3-4b: MLA prefill through flash at q/k 96,
# v 64; its decode over the latent cache is PyTorch ops, so no ragged
# decode may launch
MLA_KERNELS = ("fused_rmsnorm", "flash_attention")
# recurrentgemma-9b's bf16 serve: every ragged decode on the tensor-core
# route (G 16)
RGEMMA_KERNELS = LLAMA_KERNELS + ("ragged_decode_attention_tc",)
MLA_ABSENT = ("ragged_decode_attention",)
# training: llama's forward runs flash (f32, split TF32) and RMSNorm, and
# mamba's the SSD scan at chunk 256 (the split-TF32 route) and RMSNorm;
# no decode runs
TRAIN_KERNELS = ("fused_rmsnorm", "flash_attention")
TRAIN_MAMBA_KERNELS = ("fused_rmsnorm", "ssd_chunked", "ssd_chunked_tf32")
TRAIN_ABSENT = ("ragged_decode_attention",)
# float32 outside the tensor cores: the rate of the training path's GEMMs
# with TF32 off
F32_CUDA_CORE_FLOPS = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class SmiSampler:
    """``nvidia-smi`` sampling the SM clock (MHz) and the power draw (W)
    every 500 ms while the ``with`` block runs; the process is stopped on
    exit. ``summary()`` gives each one's min / median / max, or "not
    measured" when nvidia-smi gave no sample."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "500"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = []
        for line in out.splitlines():
            try:
                self.samples.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                continue
        return False

    def summary(self) -> str:
        if not self.samples:
            return "clocks and power not measured (no nvidia-smi sample)"
        parts = []
        for i, (name, unit) in enumerate((("SM clock", "MHz"),
                                          ("power", "W"))):
            v = sorted(x[i] for x in self.samples)
            parts.append(f"{name} min {v[0]} / median "
                         f"{statistics.median(v)} / max {v[-1]} {unit}")
        return f"{len(self.samples)} samples: {'; '.join(parts)}"


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = 25, warmup: int = 3,
            ahead_ms: float = 0.0):
    """Median time of ``fn`` in ms over CUDA events, L2 flushed before each
    call (the serving path meets its operands cold); None without ``fn``.
    With ``ahead_ms`` each call is queued behind a spin kernel of at least
    that long, so a call whose host dispatch outlasts its device work is
    timed on the device and not at the host's pace."""
    if fn is None:
        return None
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        if ahead_ms:        # cycles at 2 GHz, above the H100's SM clock
            torch.cuda._sleep(int(ahead_ms * 2e6))
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


PHASE = ["env"]         # the phase running, named by a failure
TRACES = {}             # phase: {"sessions": n, "empty": n, "incomplete": n}
SKEW_US = {"early": 0.0, "late": 0.0}   # farthest device record before /
                                        # after the host's traced span
TRACE_PAD_S = 0.02      # least host time traced before and after the work
TRACE_TRIES = 3
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, launched first in a trace


@functools.lru_cache(maxsize=None)
def _cupti():
    """libcupti as torch loaded it (None where it is not loaded)."""
    for name in ("libcupti.so.12", "libcupti.so.13", "libcupti.so"):
        try:
            return ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_GLOBAL)
        except OSError:
            continue
    return None


def traced_device_s(torch, fn, what: str, symbols=(), calls=1, warm=None):
    """(device seconds, the CUDA events summed by kernel name
    (:func:`kineto_sums`), fn's result, the ``symbols`` the trace lacks)
    of one call of ``fn`` under torch.profiler; device seconds sum every
    kernel's and copy's self
    time. The profiler keeps only the
    device records whose timestamps fall inside the session's window on
    the host's clock, and the device's timestamps, converted to that
    clock, have strayed from it by milliseconds either way on an H100
    (PERF.md §6), so a short session lost its first or last records, or
    all of them. How far the device records reached outside the host's
    span is kept in ``SKEW_US``, and the session idles before and after
    the work for twice the farthest stray seen so far (``TRACE_PAD_S`` at
    least); it makes CUPTI flush its buffers before it stops. Later in a
    run CUPTI also drops the first kernel record of nearly every session
    (its first launch takes milliseconds of set-up on the host; PERF.md
    §6), whatever kernel it is and whatever the pad, so each session
    first launches a spin kernel (``MARKER``), waits for it and leaves its
    record, if kept, out of every sum. A trace that
    still recorded no device event, or lacks a kernel whose symbol
    contains one of ``symbols`` (the hand-written kernels ``fn`` launches,
    or a function that names them after ``fn`` ran: the trace lost
    records), or, with ``calls``, holds fewer than ``calls`` records of
    one (each kernel launched once per call of the kernel's wrapper;
    ``calls`` a number for every symbol, or a dict of each symbol's own
    count, 1 for a symbol it does not name), is
    printed, with ``what`` it traced, and taken again
    with a pad four times longer, ``TRACE_TRIES`` times in all; then None
    seconds for an empty trace. With ``warm`` the session first runs
    ``warm()`` (a call like ``fn``'s) and waits for it, and every device
    record before the marker's is left out: late in a run the roofline's
    one-step traces lost one RMSNorm record on every try (PERF.md §6), and
    a loss at the session's start then falls in the warm call.
    ``TRACES`` counts the sessions of each phase and those that came back
    empty or incomplete."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cupti = _cupti()
    count = TRACES.setdefault(PHASE[0],
                              {"sessions": 0, "empty": 0, "incomplete": 0})
    for attempt in range(TRACE_TRIES):
        pad = max(TRACE_PAD_S, 2e-6 * max(SKEW_US.values())) * 4 ** attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            if warm is not None:
                warm()
                torch.cuda.synchronize()
            torch.cuda._sleep(1000)     # the record CUPTI may drop
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            if cupti is not None:      # CUPTI_ACTIVITY_FLAG_FLUSH_FORCED
                cupti.cuptiActivityFlushAll(ctypes.c_uint32(1))
        host, devs, dev = kineto_sums(prof, DeviceType.CUDA,
                                      after_marker=warm is not None)
        if host and devs:
            early = min(h for h, _ in host) - min(d for d, _ in devs)
            late = max(d for _, d in devs) - max(h for _, h in host)
            SKEW_US["early"] = max(SKEW_US["early"], early)
            SKEW_US["late"] = max(SKEW_US["late"], late)
        us = sum(e.self_device_time_total for e in dev)
        want = symbols() if callable(symbols) else symbols
        seen = {s: sum(e.count for e in dev if s in e.key) for s in want}
        need = {s: (calls.get(s, 1) if isinstance(calls, dict) else calls)
                for s in want}
        missing = [s if not n else f"{s} ({n} of {need[s]} records)"
                   for s, n in seen.items() if n < need[s]]
        count["sessions"] += 1
        if us > 0 and not missing:
            return us / 1e6, dev, out, []
        lost = "no device time" if us <= 0 else f"no {', '.join(missing)}"
        count["empty" if us <= 0 else "incomplete"] += 1
        print(f"[profiler] the trace of {what} recorded {lost} (pad "
              f"{pad * 1e3:.0f} ms, try {attempt + 1} of {TRACE_TRIES})")
    return (us / 1e6 if us > 0 else None), dev, out, missing


# the device's share of a session, summed by kernel name: what
# key_averages() gives for its device events
DeviceSum = collections.namedtuple("DeviceSum",
                                   "key count self_device_time_total")
# events the profiler's own post-processing leaves out
_UTILITY_EVENTS = ("[memory]", "[OutOfMemory]")


def kineto_sums(prof, device_type, after_marker: bool = False):
    """(host spans, device spans, [DeviceSum] by kernel name) of a
    session, in us, from its raw kineto events, leaving out the spin
    kernel (``MARKER``) and, ``after_marker``, every device record that
    started before its last record (none at all when that record was
    lost). This is what ``prof.events()`` and
    ``prof.key_averages()`` give, without building their FunctionEvents,
    which takes about 70 us of Python per event: minutes for a deep
    model's serve window of a million host and device events, against
    seconds for this one pass."""
    from torch.autograd import DeviceType
    host, devs, sums = [], [], {}
    events = list(prof.profiler.kineto_results.events())
    start = None
    if after_marker:
        marks = [e.start_ns() for e in events
                 if e.device_type() == device_type and MARKER in e.name()]
        start = max(marks, default=float("inf"))
    for e in events:
        name = e.name()
        if (MARKER in name or name in _UTILITY_EVENTS
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        span = (e.start_ns() / 1e3, e.end_ns() / 1e3)
        kind = e.device_type()
        if kind == DeviceType.CPU:
            host.append(span)
        elif kind == device_type and (start is None
                                      or e.start_ns() >= start):
            devs.append(span)
            n, us = sums.get(name, (0, 0.0))
            # an asynchronous event has no self time (FunctionEvent's rule)
            sums[name] = (n + 1, us + (0.0 if e.is_async()
                                       else e.duration_ns() / 1e3))
    return host, devs, [DeviceSum(k, n, us) for k, (n, us) in sums.items()]


HOST_CALLS = 200
REPEATS = 200   # launches in a row of a kernel whose ring is checked


def host_us(torch, fn, calls: int = HOST_CALLS):
    """Mean host microseconds per call of ``fn`` over ``calls`` back-to-back
    calls with no synchronize inside, after a warmup (what the launching
    thread spends per call while the card's queue does not fill); None
    without ``fn``."""
    if fn is None:
        return None
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs * 1e6 / calls


def in_turns(measure, kernel_fn, lib_fn):
    """``measure`` of the library call, the kernel, the kernel and the
    library call, in that order: (the kernel's mean, the library's mean or
    None without one, the four)."""
    turns = [measure(f) for f in (lib_fn, kernel_fn, kernel_fn, lib_fn)]
    lib = None if lib_fn is None else (turns[0] + turns[3]) / 2
    return (turns[1] + turns[2]) / 2, lib, turns


def device_ms(torch, fn, what: str, reps: int = 10, symbols=()):
    """(device time per call in ms from the profiler over ``reps`` calls (L2
    warm), the names of the two kernels that took most of it, the
    ``symbols`` its trace lacks after every try); unlike :func:`cuda_ms`
    it excludes the host's launch gaps. (None, [], []) without ``fn``;
    None ms when the profiler recorded nothing."""
    if fn is None:
        return None, [], []
    fn()
    torch.cuda.synchronize()
    secs, dev, _, missing = traced_device_s(
        torch, lambda: [fn() for _ in range(reps)], what, symbols, reps)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:2]
    return (None if secs is None else secs * 1e3 / reps,
            [e.key[:100] for e in top], missing)


def check_trace(ms, missing, what: str):
    """A hand-written kernel's trace recorded device time and every kernel
    it launches, after ``TRACE_TRIES`` tries."""
    check(ms is not None, f"{what}: the profiler recorded no device time "
                          f"for the hand-written kernel")
    check(not missing, f"{what}: the trace still lacks {', '.join(missing)} "
                       f"after {TRACE_TRIES} tries (device records lost)")


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def short_name(key: str) -> str:
    return key.replace("void ", "").replace("(anonymous namespace)::", "")[:44]


def check_decode_route(counts: dict, what: str, kernels):
    """Every ragged decode launch of the path on the route its
    ``kernels`` name (a route's counter among them), none on another."""
    for route in DECODE_ROUTES:
        key = f"ragged_decode_attention_{route}"
        if key in kernels:
            check(counts["ragged_decode_attention"] == counts[key],
                  f"{what}: {counts['ragged_decode_attention']} ragged "
                  f"decode launches, {counts[key]} of them on the {route} "
                  f"route: another kernel ran")


def check_launched(counts: dict, what: str, kernels, absent=()):
    """Every kernel of the path (``kernels``) launched at least once, and
    none of ``absent`` (kernels the path must not run)."""
    for name in kernels:
        check(counts[name] > 0, f"{what}: kernel {name} was never launched "
                                f"on this path (counts {counts})")
    for name in absent:
        check(counts[name] == 0, f"{what}: kernel {name} launched "
                                 f"{counts[name]} times on a path that does "
                                 f"not run it (counts {counts})")


def compare(torch, got, ref, dtype_name: str, what: str, tols=None) -> float:
    """Max |err| of the kernel's outputs ``got`` against the plain
    version's ``ref`` (one tensor each, or tuples with one tolerance per
    output in ``tols``); fails outside the tolerance."""
    if not isinstance(got, tuple):
        got, ref, tols = (got,), (ref,), (TOL[dtype_name],)
    worst = 0.0
    for g, r, tol in zip(got, ref, tols):
        err = (g.float() - r.float()).abs().max().item()
        ok = torch.allclose(g.float(), r.float(), rtol=tol, atol=tol)
        check(bool(ok), f"{what}: kernel disagrees with its plain version "
                        f"(max |err| {err:.3e}, tolerance {tol})")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# the f32 flash kernel at D 64 (llama's head dim) and at D 256
# (recurrentgemma-9b's), every instantiation of the bf16 flash kernel, the
# ragged decode kernel at D 256 and the SSD scan's split-TF32 kernels, as
# ptxas names them
F32_FLASH_D64 = "flash_tf32x3_kernelILi64E"
F32_FLASH_D256 = "flash_tf32x3_d256_kernel"
FLASH_TC = "flash_tc_kernel"
# its instantiations at D 256: one head a CTA, and two (flash_tc_kernel_pp)
FLASH_TC_D256 = ("flash_tc_kernelILi256E", "flash_tc_kernel_pp")
# the bf16 kernel's instantiations on the served paths, by the shape a
# launch gives them: (what, B, S, H, KV, Dqk, Dv)
FLASH_TC_SHAPES = (("llama prefill", 4, 512, 32, 8, 64, 64),
                   ("nemo prefill", 4, 512, 32, 8, 128, 128),
                   ("minicpm3 prefill", 4, 512, 40, 40, 96, 64),
                   ("granite prefill", 4, 512, 24, 8, 64, 64),
                   ("rgemma prefill", 4, 512, 16, 1, 256, 256),
                   ("rgemma serve prefill", 1, 384, 16, 1, 256, 256))

DECODE_D256 = "Li256E"
DECODE_TC = "ragged_decode_tc_kernel"     # every instantiation
DECODE_N8 = "ragged_decode_n8_kernel"     # every instantiation
DECODE_N8_TF32 = "ragged_decode_n8_tf32_kernel"
SSD_TF32 = ("ssd_intra_tf32_kernel", "ssd_scores_tf32_kernel")
SSD_TC_SCAN = "ssd_tc_scan_kernel"


def phase_build():
    import shutil
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(logs)} CUDA sources built in {secs:.2f} s "
          f"(parallel nvcc, sm_90a)")
    import re
    for name, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = line.split(" for ", 1)[1].strip()
            elif "wgmma.mma_async instructions are serialized" in line:
                # the split-TF32 flash kernel at D 256 holds 255 registers
                # a thread: one more live value and ptxas waits after
                # every wgmma; nor may the bf16 kernel's wgmmas at D 256
                # (either layout) be serialized
                print(f"[build] {name}: {line.strip()}")
                check(not (name == "flash_attn" and (
                          F32_FLASH_D256 in line or any(
                              k in line for k in FLASH_TC_D256))),
                      f"{name}: ptxas serializes the wgmmas of a flash "
                      f"kernel at D 256: {line.strip()}")
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.strip()}")
                spilled = [int(b) for b in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", line)]
                # RMSNorm, the f32 flash kernel at llama's head dim, the
                # D-256 flash and decode kernels, every instantiation of
                # the bf16 flash kernel and the SSD scan's split-TF32
                # kernels
                no_spill = name == "rmsnorm" or (
                    name == "flash_attn" and any(
                        k in kernel for k in (F32_FLASH_D64, F32_FLASH_D256,
                                              FLASH_TC))) or (
                    name == "ragged_decode_attn" and any(
                        k in kernel for k in (DECODE_D256, DECODE_TC, DECODE_N8,
                                              DECODE_N8_TF32))) or (
                    name == "ssd_chunk" and any(k in kernel for k in (
                        *SSD_TF32, SSD_TC_SCAN)))
                check(not (no_spill and any(spilled)),
                      f"{name}: ptxas reports spills in {kernel}: "
                      f"{line.strip()}")
    # the bf16 flash kernel's instantiation at each served shape: its
    # registers and local (spill) bytes a thread, CTAs an SM holds
    import repro_torch.kernels as K
    for what, B, S, H, KV, D, Dv in FLASH_TC_SHAPES:
        print(f"[build] flash_tc_kernel at {what} (B {B}, S {S}, H {H}, KV "
              f"{KV}, q/k {D}, v {Dv}): "
              f"{K.flash_attn.tc_info(B, S, S, H, KV, D, Dv)}")
    # ragged decode's tensor-core kernel at each head dim (recurrentgemma-
    # 9b: 256): registers, spill bytes, CTAs an SM, shared memory, clusters
    # of 8 the card holds at once
    for D in K.ragged_decode_attn.HEAD_DIMS:
        print(f"[build] {DECODE_TC}<{D}>: "
              f"{K.ragged_decode_attn.tc_info(D)}")
    # and its n8 kernel (llama3.2-1b and granite: 64; mistral-nemo-12b: 128)
    for D in K.ragged_decode_attn.N8_HEAD_DIMS:
        print(f"[build] {DECODE_N8}<{D}>: "
              f"{K.ragged_decode_attn.tc_info(D, 'n8')}")
    # and its float32 split-TF32 kernel at the same head dims (the exact
    # checks of llama3.2-1b and granite: 64; mistral-nemo-12b: 128)
    for D in K.ragged_decode_attn.N8_HEAD_DIMS:
        print(f"[build] {DECODE_N8_TF32}<{D}>: "
              f"{K.ragged_decode_attn.tc_info(D, 'n8_tf32')}")
    # the SSD scan's tensor-core scan at each state size (mamba2-2.7b: 128)
    for N in K.ssd_chunk.TC_STATES:
        print(f"[build] {SSD_TC_SCAN}<{N}>: "
              f"{K.ssd_chunk.tc_scan_info(N)}")
    # the bf16 flash kernel and the SSD scan's tensor-core route run on the
    # tensor cores: their SASS holds HGMMA (wgmma) instructions; the f32
    # flash kernel's and the f32 SSD route's split products are TF32 ones
    # (HGMMA ... TF32)
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent
                                            / "cuobjdump")
    for name in ("flash_attn", "ssd_chunk"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        n_hgmma = sum(1 for line in sass.splitlines() if "HGMMA" in line)
        print(f"[build] {name}: {n_hgmma} HGMMA (wgmma) instructions in its "
              f"SASS (cuobjdump -sass)")
        check(n_hgmma > 0, f"{name}: no tensor-core (HGMMA) instruction in "
                           f"the built kernels")
        tf32 = [line.split("*/")[1].strip() for line in sass.splitlines()
                if "MMA" in line and "TF32" in line and "*/" in line]
        print(f"[build] {name}: {len(tf32)} TF32 tensor-core instructions "
              f"in its SASS, e.g. {tf32[0] if tf32 else None}")
        check(bool(tf32), f"{name}: no TF32 tensor-core instruction: the "
                          f"f32 kernel does not run on the tensor cores")
    # the float32 decode kernel's split products are mma.sync TF32 ones
    # (HMMA ... TF32)
    sass = subprocess.run([tool, "-sass", str(_build.library_path(
        "ragged_decode_attn"))], capture_output=True, text=True,
        check=True).stdout
    tf32 = [line.split("*/")[1].strip() for line in sass.splitlines()
            if "HMMA" in line and "TF32" in line and "*/" in line]
    print(f"[build] ragged_decode_attn: {len(tf32)} TF32 tensor-core "
          f"(HMMA) instructions in its SASS, e.g. {tf32[0] if tf32 else None}")
    check(bool(tf32), "ragged_decode_attn: no TF32 tensor-core (HMMA) "
                      "instruction: the f32 decode kernel does not run on "
                      "the tensor cores")


# ragged decode shapes: (lengths, slots, ctx); the last slot is a padding
# row. The first is llama's decode step at the arena's full context; one
# long row and a short context bucket check that the split slows neither.
DECODE_CASES = (
    ((1, 1024, 77, 300, 512, 640, 999, 1), (3, 17, 0, 31, 8, 22, 11, 2 ** 30),
     None),
    ((1024,), (9,), None),
    ((1, 64, 17, 33, 50, 64, 9, 1), (3, 17, 0, 31, 8, 22, 11, 2 ** 30), 64),
)


# the legacy engine's decode: no slots, B no power of two, max_len 256
SLOTLESS_LENS = ((1, 256, 133), (1, 256, 17, 133, 255, 64, 200))
# recurrentgemma-9b's decode_32k: B 128 over rings of its window of 2048,
# every row full
LONG_LENS = (2048,) * 128


def kernel_decode(torch, K, dtype, lens, slots, ctx, H=32, KV=8, D=64,
                  n_slots=32, layer=5, row=None, T=1024):
    """Ragged decode over layer ``layer`` of a flat slot arena of 16 layers
    (``slots``), or without slots over a contiguous (B, T) stack, the
    legacy engine's decode (``slots`` None: no slot vector is made). A
    case on a tensor-core route (bf16: "tc" at G > 8, "n8" at G <= 8;
    float32 at G <= 8: "n8_tf32") also holds and times the CUDA-core
    kernel it replaced, through its C entry on the same inputs
    (``before``)."""
    from repro_torch.kernels import ragged_decode_attn as RD
    B, L = len(lens), 16
    g = torch.Generator(device="cuda").manual_seed(1)
    N = B if slots is None else L * n_slots
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((N, T, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((N, T, KV, D), generator=g, device="cuda").to(dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows = None if slots is None else torch.tensor(
        slots, dtype=torch.int32, device="cuda") + layer * n_slots
    out = K.ragged_decode_attention(q, k, v, lengths, slots=rows, ctx=ctx)
    ref = K.ragged_decode_attention_plain(q, k, v, lengths, slots=rows,
                                          ctx=ctx)
    torch.cuda.synchronize()
    cache = "arena" if slots is not None else "stack, no slots, "
    route = K.decode_route(dtype, H // KV, D)
    shown = (list(lens) if len(set(lens)) > 1
             else f"{len(lens)} x [{lens[0]}]")
    res = {"shape": f"q{tuple(q.shape)} {cache}{tuple(k.shape)} "
                    f"lengths{shown} ctx {ctx}"
                    + ({"tc": " (tensor-core route)",
                        "n8": " (n8 route)",
                        "n8_tf32": " (n8 split-TF32 route)"}.get(route, "")),
           "out": out, "ref": ref,
           "row": row or (None if B != 8 or ctx is not None else ROWS.get(
               ("ragged_decode_attention", dtype_name(dtype), D))),
           "symbols": (("ragged_decode_split_kernel",)
                       if route == "cuda_cores" else COUNTER_SYMBOLS[
                           f"ragged_decode_attention_{route}"])}
    res["inputs"] = (q, k, v, lengths, rows, ctx)
    if route != "cuda_cores":
        res["before"] = (lambda: RD._launch_split(q, k, v, lengths, rows,
                                                  ctx),
                         ("ragged_decode_split_kernel",))
    # library yardstick: SDPA over the gathered, head-repeated rows
    span = T if ctx is None else ctx
    grow = (torch.arange(B, device="cuda") if rows is None
            else torch.clamp(rows.long(), max=N - 1))
    kg = k[grow, :span].transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vg = v[grow, :span].transpose(1, 2).repeat_interleave(H // KV, dim=1)
    mask = (torch.arange(span, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    F = torch.nn.functional
    res["fns"] = (
        lambda: K.ragged_decode_attention(q, k, v, lengths, slots=rows,
                                          ctx=ctx),
        lambda: K.ragged_decode_attention_plain(q, k, v, lengths, slots=rows,
                                                ctx=ctx),
        lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask))
    elt = q.element_size()
    tot = sum(lens)
    # q in, the output out, the K/V rows the lengths need, lengths and
    # (with an arena) slots as int32
    res["bytes"] = (2 * q.numel() * elt + 2 * tot * KV * D * elt
                    + (4 if rows is None else 8) * B)
    res["flops"] = 4 * H * D * tot
    return res


def kernel_rmsnorm(torch, K, dtype, shape, row=None, grad=False):
    g = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(shape, generator=g, device="cuda") * 3.0).to(dtype)
    scale = torch.randn((shape[-1],), generator=g, device="cuda")
    out = K.fused_rmsnorm(x, scale)
    ref = K.fused_rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    w = scale.to(dtype)
    F = torch.nn.functional
    return {"shape": f"x{tuple(shape)}", "out": out, "ref": ref,
            "row": row or (None if dtype != torch.bfloat16 else
                           {(8, 2048): "fused_rmsnorm",
                            (8, 4096): "fused_rmsnorm_4096"}.get(
                               tuple(shape))),
            "grad": None if not grad else (K.fused_rmsnorm,
                                           K.fused_rmsnorm_plain,
                                           (x, scale)),
            "symbols": COUNTER_SYMBOLS["fused_rmsnorm"],
            "fns": (lambda: K.fused_rmsnorm(x, scale),
                    lambda: K.fused_rmsnorm_plain(x, scale),
                    lambda: F.rms_norm(x, (shape[-1],), w, 1e-5)),
            "bytes": 2 * x.numel() * x.element_size() + 4 * shape[-1],
            "flops": 4 * x.numel()}


# the bf16 flash kernel's layout at D 256 (q heads a CTA) by (B, S) at
# recurrentgemma-9b's heads: two where the grid still fills the card, one
# at the serve's prefills of one request
D256_HEADS = {(4, 512): 2, (1, 4096): 2, (1, 384): 1}


def kernel_flash(torch, K, dtype, S, B=4, H=32, KV=8, D=64, Dv=None,
                 window=None, row=None, grad=False):
    """Causal prefill at q/k width D and v width Dv (D by default), with a
    sliding ``window`` when given; the scores and P V read q, k at D and v
    at Dv, the output is Dv wide."""
    Dv = Dv or D
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, Dv), generator=g, device="cuda").to(dtype)
    out = K.flash_attention(q, k, v, window=window)
    ref = K.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
    F = torch.nn.functional
    elt = q.element_size()
    kv_shape = (f"kv{tuple(k.shape)}" if Dv == D
                else f"k{tuple(k.shape)} v{tuple(v.shape)}")
    binds = window is not None and window < S
    if binds:       # the library call takes the window as a boolean mask
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
    # the (query, key) pairs the mask keeps: query i sees min(i + 1, window)
    pairs = sum(min(i + 1, window or S) for i in range(S))
    # bf16 at D 256 in the two-head layout (recurrentgemma-9b at B 4): held
    # and timed in turns against the one-head layout on the same inputs
    info = (K.flash_attn.tc_info(B, S, S, H, KV, D, Dv)
            if dtype == torch.bfloat16 and D == 256 else None)
    check(info is None or info["heads"] == D256_HEADS.get((B, S),
                                                          info["heads"]),
          f"flash_attention bf16 q{tuple(q.shape)}: layout {info}")
    two_heads = info is not None and info["heads"] == 2
    return {"shape": f"q{tuple(q.shape)} {kv_shape} causal"
                     + (f" window {window}" if window else ""),
            "out": out, "ref": ref,
            "row": row or (None if S != 512 or B != 4 else
                           ROWS.get(("flash_attention", dtype_name(dtype),
                                     D))),
            "grad": None if not grad else (
                lambda *a: K.flash_attention(*a, window=window),
                lambda *a: K.flash_attention_plain(*a, window=window),
                (q, k, v)),
            "symbols": (COUNTER_SYMBOLS["flash_attention"]
                        if dtype == torch.bfloat16
                        else ("flash_tf32x3_kernel",) if D <= 128
                        else ("flash_tf32x3_d256_kernel",)),
            "lib_kernels": dtype == torch.float32,
            "repeats": dtype == torch.float32 and S == 512 or two_heads,
            **({} if not two_heads else {
                "before": (lambda: K.flash_attn._launch_heads(
                    q, k, v, 1, window=window), COUNTER_SYMBOLS[
                        "flash_attention"]),
                "before_what": "the one-head layout",
                "note": f"two heads a CTA: {info}"}),
            "fns": (lambda: K.flash_attention(q, k, v, window=window),
                    lambda: K.flash_attention_plain(q, k, v, window=window),
                    lib),
            # q, k, v read once and the output written once; Q K^T over D
            # columns and P V over Dv on the pairs the mask keeps
            "bytes": (q.numel() + k.numel() + v.numel() + out.numel()) * elt,
            "flops": 2 * B * H * (D + Dv) * pairs}


def kernel_ssd(torch, K, dtype, S, chunk, nh=80, hd=64, N=128, B=1,
               row=None, grad=False):
    """The SSD scan at mamba2-2.7b's prefill shapes, with the model's own
    input distribution at init: dt = softplus(noise + dt_bias) with dt_bias
    the inverse softplus of a log-uniform [1e-3, 1e-1] draw, A = -(1..nh).
    Checks y and the final state against the plain version; since |y| is
    small on the heads with a large |A| and a small dt, each head's
    ||y - y_ref|| / ||y_ref|| must also stay below SSD_HEAD_REL_TOL."""
    import math
    from repro_torch.kernels import ssd_chunk
    g = torch.Generator(device="cuda").manual_seed(4)
    F = torch.nn.functional
    x = torch.randn((B, S, nh, hd), generator=g, device="cuda").to(dtype)
    Bm = torch.randn((B, S, N), generator=g, device="cuda").to(dtype)
    Cm = torch.randn((B, S, N), generator=g, device="cuda").to(dtype)
    u = torch.rand((nh,), generator=g, device="cuda")
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    dt = F.softplus(torch.randn((B, S, nh), generator=g, device="cuda")
                    + torch.log(torch.expm1(dt0)))
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device="cuda")
    route = K.ssd_route(dtype, chunk, hd, N)
    # every route moves ``launches`` and its own counter; cuda_cores has
    # none of its own, so it moves ``launches`` alone
    counters = ("", "tc_", "tf32_", "recurrent_", "tc_scan_")
    before = [getattr(K.ssd_chunked, f"{c}launches") for c in counters]
    y, st = K.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    y_ref, st_ref = K.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    check(all(getattr(K.ssd_chunked, f"{c}launches")
              == n + (c in ("", f"{route}_"))
              for c, n in zip(counters, before)),
          f"ssd_chunked chunk {chunk}: the {route} route was not the one "
          f"launched")
    yf, rf = y.float(), y_ref.float()
    head_rel = ((yf - rf).square().sum(dim=(0, 1, 3)).sqrt()
                / rf.square().sum(dim=(0, 1, 3)).sqrt())
    rel = head_rel.max().item()
    shape = f"x{tuple(x.shape)} N {N} chunk {chunk} ({route} route)"
    check(rel < SSD_HEAD_REL_TOL,
          f"ssd_chunked {shape}: a head's ||y - y_ref|| / ||y_ref|| is "
          f"{rel:.3e} (tolerance {SSD_HEAD_REL_TOL})")
    ytol = SSD_TOL[str(dtype).replace("torch.", "")]
    nc = S // chunk
    tri = chunk * (chunk + 1) // 2
    elt = x.element_size()
    return {"shape": shape, "out": (y, st), "ref": (y_ref, st_ref),
            "tols": (ytol, 1e-4), "by_kernel": True,
            "symbols": SSD_ROUTE_SYMBOLS[route],
            # the JSON rows: bf16 at the serve's chunk 256 and its chunk 1
            # at S 383 (the tensor-core scan), and the f32 split-TF32 route
            # at mamba exact's chunk 256
            "row": row or (
                "ssd_chunked_tc_scan" if route == "tc_scan" and S == 383
                and B == 1 else None if chunk != 256 or B != 1
                else "ssd_chunked" if dtype == torch.bfloat16
                else "ssd_chunked_tf32"),
            "grad": None if not grad else (
                lambda *a: K.ssd_chunked(*a, chunk),
                lambda *a: K.ssd_chunked_plain(*a, chunk),
                (x, dt, A, Bm, Cm)),
            # the split-TF32 route against the CUDA-core pair it replaced,
            # the tensor-core scan against the recurrent pair, called
            # directly on the same inputs (no launch counted)
            "before": (None if B != 1 else
                       (lambda: ssd_cuda_cores(torch, x, dt, A, Bm, Cm,
                                               chunk),
                        SSD_ROUTE_SYMBOLS["cuda_cores"])
                       if route == "tf32" else
                       (lambda: ssd_chunk._launch_recurrent(x, dt, A, Bm, Cm,
                                                            chunk),
                        SSD_ROUTE_SYMBOLS["recurrent"])
                       if route == "tc_scan" else None),
            "repeats": dtype == torch.float32 and chunk == 256 and B == 1,
            "note": f"median |y_ref| {rf.abs().median().item():.3e}, worst "
                    f"head ||y - y_ref|| / ||y_ref|| {rel:.3e}",
            "fns": (lambda: K.ssd_chunked(x, dt, A, Bm, Cm, chunk),
                    lambda: K.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk),
                    None),
            # read x, dt, A, B, C once; write y and the final state once
            "bytes": (2 * x.numel() + 2 * B * S * N) * elt
            + 4 * (B * S * nh + nh) + 4 * B * nh * hd * N,
            # C.B^T once for all heads over the causal half, W.x and the
            # chunk states per head, the state pass, and y_inter for the
            # chunks after the first (the first enters with a zero state)
            "flops": B * (2 * nc * tri * N + 2 * nc * nh * tri * hd
                          + 2 * S * nh * hd * N + 2 * nc * nh * hd * N
                          + 2 * (nc - 1) * chunk * nh * hd * N)}


def ssd_cuda_cores(torch, x, dt, A, Bm, Cm, chunk):
    """ssd_chunked's steps on its CUDA-core route, at any shape that route
    takes: the pair the split-TF32 route replaced, timed beside it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import _check_inputs, _y_inter
    _check_inputs(x, dt, A, Bm, Cm, chunk)
    Bb, S, nh, hd = x.shape
    N, nc = Bm.shape[-1], S // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h_prev = torch.empty((Bb, nc, nh, hd, N), **f32)
    cum_exp = torch.empty((Bb, S, nh), **f32)
    decay = torch.empty((Bb, nc, nh), **f32)
    final = torch.empty((Bb, nh, hd, N), **f32)
    err = _build.function("ssd_chunk", "repro_ssd_chunk")(
        *(t.data_ptr() for t in (x, dt, A, Bm, Cm, y, h_prev, cum_exp, decay,
                                 final)),
        Bb, S, nh, hd, N, chunk, _build.dtype_code(x.dtype),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"ssd CUDA-core pair: CUDA error {err} at launch")
    if nc == 1:
        return y, final
    return y + _y_inter(Cm, cum_exp, h_prev, chunk, x.dtype), final


def before_vs(torch, r, kernel_fn, dname, what):
    """The kernel against the kernels it replaced (``r["before"]``: their
    call and their profiler symbols; ``r["before_what"]`` names them, by
    default "the kernel it replaced"), on the same inputs in one run: both
    held to the plain version; events, host time and device time from the
    profiler in turns (before, kernel, kernel, before), the replaced pair's
    device time by kernel; fails when the kernel's device time is the
    longer. Returns the replaced pair's numbers for the case's JSON row."""
    before, symbols = r["before"]
    who_b = r.get("before_what", "the kernel it replaced")
    err = compare(torch, before(), r["ref"], dname,
                  f"{what}, {who_b}", r.get("tols"))
    ev, ev_b, _ = in_turns(lambda f: cuda_ms(torch, f), kernel_fn, before)
    host, host_b, _ = in_turns(lambda f: host_us(torch, f), kernel_fn,
                               before)
    turns = []
    for fn, syms, who in ((before, symbols, who_b),
                          (kernel_fn, r["symbols"], "the kernel"),
                          (kernel_fn, r["symbols"], "the kernel"),
                          (before, symbols, who_b)):
        ms, _, missing = device_ms(torch, fn, f"{who}, {what}",
                                   symbols=syms)
        check_trace(ms, missing, f"{what}, {who}")
        turns.append(ms)
    dev, dev_b = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    _, by_kernel, _, _ = traced_device_s(torch, before,
                                         f"{what}, {who_b}, by kernel",
                                         symbols)
    check(dev <= dev_b, f"{what}: device time {dev:.4f} ms, longer than "
                        f"the {dev_b:.4f} ms of {who_b}")
    print(f"[kernels] {what}: against {who_b}, same inputs "
          f"(its max|err| {err:.3e}): events {ev:.4f} vs {ev_b:.4f} ms, host "
          f"{host:.2f} vs {host_b:.2f} us per call, device in turns "
          f"(replaced, kernel, kernel, replaced) "
          f"{', '.join(f'{m:.4f}' for m in turns)} ms: {dev:.4f} vs "
          f"{dev_b:.4f} ms ({dev_b / dev:.2f}x) | the replaced pair's device "
          f"time by kernel: " + ", ".join(
              f"{short_name(e.key)} {e.self_device_time_total:.2f} us"
              for e in sorted(by_kernel,
                              key=lambda e: -e.self_device_time_total)[:4]))
    return {"replaced_device_ms": dev_b, "replaced_ms": ev_b,
            "replaced_host_us": host_b, "device_ms_in_turns": dev}


def grad_check(torch, r, dname, what):
    """The case's wrapper under autograd (``r["grad"]``: the wrapper, its
    plain version, the inputs): its output has the Function's grad_fn and
    its forward launched the kernel; the gradient of every input for one
    random upstream gradient agrees with autograd through the plain
    version on the same inputs, at the forward's tolerance (``r["tols"]``'s
    first, else ``TOL``); the backward's device time (profiler) and events
    time, and the plain version's full backward's. Returns the numbers for
    the case's JSON row.

    Where the Function's backward re-runs that same plain version (flash;
    the SSD scan at chunk 64 and up) both sides run the same ops on the
    same inputs: the check then shows the wiring only. RMSNorm's
    closed-form backward and the SSD scan's recurrent one below chunk 64
    are held against other arithmetic."""
    import repro_torch.kernels as K
    kernel, plain, inputs = r["grad"]
    tol = r["tols"][0] if r.get("tols") else TOL[dname]

    def leaves():
        return [t.detach().clone().requires_grad_(True) for t in inputs]

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    before = K.launch_counts()
    ins = leaves()
    out = first(kernel(*ins))
    launched = [k for k, n in K.launch_counts().items() if n > before[k]]
    check(out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__
          and bool(launched),
          f"{what}: under autograd the wrapper gave grad_fn "
          f"{type(out.grad_fn).__name__} and launched {launched}")
    g = torch.Generator(device=out.device).manual_seed(11)
    up = torch.randn(out.shape, generator=g, device=out.device).to(out.dtype)
    bwd = lambda: torch.autograd.grad(out, ins, up, retain_graph=True)
    got = bwd()
    ref_ins = leaves()
    ref_out = first(plain(*ref_ins))
    ref_bwd = lambda: torch.autograd.grad(ref_out, ref_ins, up,
                                          retain_graph=True)
    want = ref_bwd()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{what}: a gradient is not finite")
    err = compare(torch, tuple(got), tuple(want), dname,
                  f"{what} gradients", (tol,) * len(got))
    dev, _, _ = device_ms(torch, bwd, f"the backward of {what}")
    dev_plain, _, _ = device_ms(torch, ref_bwd,
                                f"the plain backward of {what}")
    ev = cuda_ms(torch, bwd)
    fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"
    print(f"[kernels] {what} gradients: {type(out.grad_fn).__name__} over "
          f"the kernel ({', '.join(launched)}); max|err| {err:.3e} against "
          f"autograd through the plain version (tolerance {tol}) | backward "
          f"(PyTorch ops) device {fmt(dev)}, events {fmt(ev)} | the plain "
          f"version's backward device {fmt(dev_plain)}")
    del out, ref_out, got, want
    return {"backward_device_ms": dev, "backward_ms": ev,
            "backward_max_abs_err": err}


def phase_kernels(torch):
    """Each kernel against its plain version at the main path's shapes;
    returns the bf16 main-shape row per kernel for the JSON line."""
    import repro_torch.kernels as K
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for lens, slots, ctx in DECODE_CASES:
            cases.append(("ragged_decode_attention", dt,
                          lambda dt=dt, a=lens, s=slots, c=ctx:
                          kernel_decode(torch, K, dt, a, s, c)))
        # llama's width, then mamba's (ln1 and the final norm at d_model,
        # the gated norm at d_inner, decode rows and a prefill)
        for shape in ((8, 2048), (4, 256, 2048), (8, 2560), (8, 5120),
                      (1, 384, 5120)):
            cases.append(("fused_rmsnorm", dt,
                          lambda dt=dt, s=shape: kernel_rmsnorm(torch, K, dt,
                                                                s)))
        for S in (64, 128, 256, 512):      # every llama prefill bucket
            cases.append(("flash_attention", dt,
                          lambda dt=dt, S=S: kernel_flash(torch, K, dt, S)))
        # mistral-nemo-12b's heads: 32 q / 8 kv of 128 (RMSNorm at its
        # width 5120 is mamba's d_inner case below)
        lens, slots, _ = DECODE_CASES[0]
        cases.append(("ragged_decode_attention", dt,
                      lambda dt=dt: kernel_decode(torch, K, dt, lens, slots,
                                                  None, D=128)))
        cases.append(("flash_attention", dt,
                      lambda dt=dt: kernel_flash(torch, K, dt, 512, D=128)))
        # minicpm3-4b's MLA prefill: 40 heads, q and k 96 wide, v 64
        cases.append(("flash_attention", dt,
                      lambda dt=dt: kernel_flash(torch, K, dt, 512, H=40,
                                                 KV=40, D=96, Dv=64)))
        # granite-moe-3b-a800m's decode: 24 q / 8 kv heads of 64 (G 3)
        cases.append(("ragged_decode_attention", dt,
                      lambda dt=dt: kernel_decode(
                          torch, K, dt, lens, slots, None, H=24,
                          row=("ragged_decode_attention_g3"
                               if dt == torch.bfloat16
                               else "ragged_decode_attention_f32_g3"))))
        # recurrentgemma-9b: 16 q heads over one kv head of 256, window
        # 2048 (not binding at S 512, binding at S 4096), and its width
        cases.append(("flash_attention", dt,
                      lambda dt=dt: kernel_flash(torch, K, dt, 512, H=16,
                                                 KV=1, D=256, window=2048)))
        cases.append(("flash_attention", dt,
                      lambda dt=dt: kernel_flash(torch, K, dt, 4096, B=1,
                                                 H=16, KV=1, D=256,
                                                 window=2048)))
        # its serve's longest prefill: one request of 384 (one head a CTA)
        cases.append(("flash_attention", dt,
                      lambda dt=dt: kernel_flash(torch, K, dt, 384, B=1,
                                                 H=16, KV=1, D=256,
                                                 window=2048)))
        cases.append(("ragged_decode_attention", dt,
                      lambda dt=dt: kernel_decode(torch, K, dt, lens, slots,
                                                  None, H=16, KV=1, D=256)))
        # the legacy engine's decode: no slot vector, a contiguous (B, 256)
        # stack at B 3 and 7, at llama's heads and recurrentgemma-9b's
        for stack_lens in SLOTLESS_LENS:
            for H, KV, D in ((32, 8, 64), (16, 1, 256)):
                cases.append(("ragged_decode_attention", dt,
                              lambda dt=dt, a=stack_lens, H=H, KV=KV, D=D:
                              kernel_decode(torch, K, dt, a, None, None, H=H,
                                            KV=KV, D=D, T=256)))
        # recurrentgemma-9b's decode_32k (B 128, rings of 2048, full): the
        # tensor-core route at its longest context, in bf16
        if dt == torch.bfloat16:
            cases.append(("ragged_decode_attention", dt,
                          lambda dt=dt: kernel_decode(
                              torch, K, dt, LONG_LENS, None, None, H=16,
                              KV=1, D=256, T=LONG_LENS[0])))
        for shape in ((8, 4096), (1, 384, 4096)):
            cases.append(("fused_rmsnorm", dt,
                          lambda dt=dt, s=shape: kernel_rmsnorm(torch, K, dt,
                                                                s)))
        # the serve's chunks 256, 128 and 64 (the tensor-core route in
        # bf16, split TF32 in f32), chunks 1 and 2 at odd prefill lengths
        # and 32 (the recurrent route), and 200 (the CUDA-core route)
        for S, chunk in ((256, 256), (384, 128), (64, 64), (383, 1),
                         (258, 2), (384, 32), (400, 200)):
            cases.append(("ssd_chunked", dt,
                          lambda dt=dt, S=S, c=chunk: kernel_ssd(torch, K, dt,
                                                                 S, c)))
    # the training path's shapes (llama3.2-1b at batch 8 x 256 in float32,
    # mamba2-2.7b at 4 x 256), each also held for its gradient: the
    # Function's backward against autograd through the plain version
    f32, bf16 = torch.float32, torch.bfloat16
    cases += [
        ("flash_attention", f32, lambda: kernel_flash(
            torch, K, f32, 256, B=8, row="flash_attention_f32_train",
            grad=True)),
        ("flash_attention", bf16, lambda: kernel_flash(torch, K, bf16, 256,
                                                       B=8, grad=True)),
        ("flash_attention", f32, lambda: kernel_flash(
            torch, K, f32, 256, B=8, H=40, KV=40, D=96, Dv=64, grad=True)),
        # recurrentgemma-9b's local attention at hybrid training's batch
        ("flash_attention", f32, lambda: kernel_flash(
            torch, K, f32, 256, B=8, H=16, KV=1, D=256, window=2048,
            grad=True)),
        ("fused_rmsnorm", f32, lambda: kernel_rmsnorm(
            torch, K, f32, (8, 256, 2048), row="fused_rmsnorm_f32_train",
            grad=True)),
        ("ssd_chunked", f32, lambda: kernel_ssd(
            torch, K, f32, 256, 256, B=4, row="ssd_chunked_tf32_train",
            grad=True)),
        ("ssd_chunked", f32, lambda: kernel_ssd(torch, K, f32, 256, 32, B=4,
                                                grad=True)),
    ]
    rows = {}
    for name, dt, make in cases:
        dname = str(dt).replace("torch.", "")
        r = make()
        err = compare(torch, r["out"], r["ref"], dname, f"{name} {r['shape']}",
                      r.get("tols"))
        kernel_fn, plain_fn, lib_fn = r["fns"]
        ms, lib_ms, ev_turns = in_turns(lambda f: cuda_ms(torch, f),
                                        kernel_fn, lib_fn)
        plain_ms = cuda_ms(torch, plain_fn)
        host, lib_host, turns = in_turns(lambda f: host_us(torch, f),
                                         kernel_fn, lib_fn)
        what = f"{name} {dname} {r['shape']}"
        syms = r["symbols"]     # the kernels its trace must show
        (dev_ms, _, missing), (dev_plain, _, _), (dev_lib, lib_ran, _) = (
            device_ms(torch, f, f"{part} of {what}",
                      symbols=syms if part == "kernel" else ())
            for f, part in zip(r["fns"], ("kernel", "plain", "library")))
        check_trace(dev_ms, missing, what)
        b_ms, b_by = bound(r["bytes"], r["flops"], dname)
        fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"
        lib = fmt if r["fns"][2] is not None else (lambda t: "none")
        ratio = lambda a, b: ("not measured" if a is None or b is None
                              else f"{a / b:.2f}x")
        note = f" | {r['note']}" if "note" in r else ""
        if r.get("by_kernel"):   # the call's kernels and PyTorch ops, one call
            r["fns"][0]()
            torch.cuda.synchronize()
            secs, dev, _, missing = traced_device_s(
                torch, r["fns"][0], f"{what} by kernel", syms)
            check_trace(secs, missing, f"{what} by kernel")
            top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
            note += " | device time by kernel: " + ", ".join(
                f"{short_name(e.key)} {e.self_device_time_total:.2f} us"
                for e in top)
        if r.get("lib_kernels"):   # which kernels the library call ran
            note += " | library ran: " + (", ".join(lib_ran) or
                                          "not measured")
        if r.get("repeats"):   # launches in a row agree bit for bit
            first = kernel_fn()
            outs = [kernel_fn() for _ in range(REPEATS)]
            torch.cuda.synchronize()
            same = (lambda a, b: all(map(torch.equal, a, b))) \
                if isinstance(first, tuple) else torch.equal
            n_diff = sum(not same(o, first) for o in outs)
            del first, outs
            check(n_diff == 0, f"{name} {dname} {r['shape']}: {n_diff} of "
                               f"{REPEATS} launches in a row differ from the "
                               f"first")
            note += (f" | {REPEATS} launches in a row equal the first bit "
                     f"for bit")
        vs_lib = (f" | kernel / library: device {ratio(dev_ms, dev_lib)}, "
                  f"events {ratio(ms, lib_ms)}"
                  if r["fns"][2] is not None else "")
        share = ("not measured" if dev_ms is None
                 else f"{100 * b_ms / dev_ms:.1f}%")
        us = lambda t: "none" if t is None else f"{t:.2f} us"
        host_line = (f"in turns (library, kernel, kernel, library): events "
                     f"{', '.join(us(t and t * 1e3) for t in ev_turns)}; "
                     f"host per call ({HOST_CALLS} calls, no sync inside) "
                     f"{', '.join(us(t) for t in turns)}")
        if lib_fn is not None:
            host_line += f" | kernel / library: host {ratio(host, lib_host)}"
        print(f"[kernels] {name} {dname} {r['shape']}: max|err| {err:.3e} | "
              f"events (L2 cold, launch included) kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib(lib_ms)} | device time "
              f"(profiler, L2 warm) kernel {fmt(dev_ms)}, plain "
              f"{fmt(dev_plain)}, library {lib(dev_lib)} | bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), kernel device at {share} of "
              f"it{vs_lib}{note}")
        print(f"[kernels] {name} {dname} {r['shape']}: {host_line}")
        replaced = None
        if r.get("before") is not None:
            replaced = before_vs(torch, r, kernel_fn, dname,
                                 f"{name} {dname} {r['shape']}")
        bwd = (None if r.get("grad") is None
               else grad_check(torch, r, dname, f"{name} {dname} "
                                                f"{r['shape']}"))
        key = r["row"]      # the JSON row this case fills, if any
        if key is not None:
            route, source = SOURCES[key]
            rows[key] = {"name": key, "route": route, "source": source,
                         "kernel": ", ".join(syms),
                         "replaces": REPLACES[key], "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms,
                         "device_ms": dev_ms, "plain_device_ms": dev_plain,
                         "library_device_ms": dev_lib, "host_us": host,
                         "library_host_us": lib_host,
                         "shape": f"{dname} {r['shape']}"}
            if bwd is not None:
                rows[key].update(bwd)
            if replaced is not None:
                rows[key].update(replaced)
        del r
        torch.cuda.empty_cache()
    return rows


def _serve(torch, engine, cfg, *, n, rate, seed, prompts, decodes,
           max_batch, sla, fixed=None):
    """Serve ``n`` requests arriving at ``rate``/s (all at once for 0)
    through ServingSession + LazyBatching; lengths are drawn from
    ``prompts`` x ``decodes``, or taken in order from ``fixed``
    [(prompt, decode), ...]."""
    from repro_torch.core.policies import LazyBatching
    from repro_torch.core.slack import SlackPredictor
    from repro_torch.serving import (H100_SXM, LengthDist, NPUPerfModel,
                                     ServingSession, from_model_config)
    import numpy as np
    wl = from_model_config(
        cfg, prompt_dist=LengthDist(prompts, (1 / len(prompts),) * len(prompts)),
        decode_dist=LengthDist(decodes, (1 / len(decodes),) * len(decodes)))
    pred = SlackPredictor.build([wl], NPUPerfModel(H100_SXM), sla)
    session = ServingSession(LazyBatching(pred, max_batch=max_batch), engine,
                             seed=seed)
    streamed = {}

    def on_token(handle, token):
        streamed.setdefault(handle.request.rid, []).append(token)

    rng = np.random.default_rng(seed)
    handles, t = [], 0.0
    for i in range(n):
        t += rng.exponential(1.0 / rate) if rate else 0.0
        r = wl.sample_request(rng, t)
        if fixed is not None:
            r.prompt_len, r.decode_len = fixed[i]
            r.sequence, r.prefix_len, r.cycle_len = wl.build_sequence(
                *fixed[i])
        handles.append(session.submit(r, on_token=on_token))
    session.duration = t
    t0 = time.perf_counter()
    stats = session.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wl, session, handles, streamed, stats, wall


def phase_serve(torch, arch, tag, kernels, prompts, absent=()):
    """Full-width ``arch`` in bf16: warm up over every prompt length, then
    serve 24 Poisson requests and check them; returns the launch counts
    of the measured serve."""
    import numpy as np
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.serving import HandleState, TorchEngine
    cfg = get_config(arch)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, max_len=1024, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params) bf16 "
          f"init in {time.perf_counter() - t0:.2f} s")
    print(f"[{tag}] {n_params(engine.params) / 1e9:.3f} B parameters on the "
          f"card; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"(weights and the K/V or state arena)")
    kw = dict(rate=20.0, prompts=prompts, decodes=(16, 32, 64), max_batch=8,
              sla=10.0)
    # warmup: first launches load the kernels' libraries; every prompt
    # length once, then a burst of max_batch
    # requests (every batch bucket as they finish, the longest context),
    # then a few Poisson arrivals
    _serve(torch, engine, cfg, n=len(prompts), seed=98,
           fixed=[(p, 4) for p in prompts], **kw)
    burst = [(p, d) for d in (16, max(kw["decodes"])) for p in prompts]
    _serve(torch, engine, cfg, n=len(burst), seed=97, fixed=burst,
           **{**kw, "rate": 0.0})
    _serve(torch, engine, cfg, n=3, seed=99, **kw)
    K.reset_launch_counts()
    runs0 = engine.runs_executed
    san0 = engine.sanitizer_stats()
    keys0 = engine.shape_keys()
    wl, session, handles, streamed, stats, wall = _serve(
        torch, engine, cfg, n=24, seed=0, **kw)
    counts = K.launch_counts()
    states = [h.state for h in handles]
    check(all(s is HandleState.DONE for s in states),
          f"{tag}: not every request finished: {states}")
    n_tok = 0
    for h in handles:
        rid = h.request.rid
        got = engine.states[rid].generated[:h.request.decode_len]
        check(streamed.get(rid, [])[:len(got)] == got == h.tokens[:len(got)],
              f"{tag}: rid {rid} streamed tokens diverge from tokens()")
        check(len(got) == h.request.decode_len,
              f"{tag}: rid {rid} generated {len(got)} tokens, wanted "
              f"{h.request.decode_len}")
        n_tok += len(got)
    check_launched(counts, tag, kernels, absent)
    check_decode_route(counts, tag, kernels)
    san = engine.sanitizer_stats()
    s = stats.summary(sla=kw["sla"])
    lat = [h.latency for h in handles]
    ttft = [h.ttft for h in handles]
    runs = engine.runs_executed - runs0
    print(f"[{tag}] 24 requests, {n_tok} tokens in {wall:.3f} s wall: "
          f"{n_tok / wall:.1f} tokens/s, {runs} runs, "
          f"{runs and n_tok / runs:.2f} tokens/run")
    print(f"[{tag}] session busy {session.log.busy_time:.3f} s: "
          f"{n_tok / session.log.busy_time:.1f} tokens per busy second")
    print(f"[{tag}] latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms p99 "
          f"{np.percentile(lat, 99) * 1e3:.1f} ms; TTFT p50 "
          f"{np.percentile(ttft, 50) * 1e3:.1f} ms p99 "
          f"{np.percentile(ttft, 99) * 1e3:.1f} ms (session clock); "
          f"SLA {kw['sla']} s violation rate "
          f"{s.get('sla_violation_rate', float('nan')):.3f}; preemptions "
          f"{session.policy.n_preemptions}")
    print(f"[{tag}] sanitizer: syncs {san.host_syncs - san0.host_syncs} for "
          f"{san.runs - san0.runs} runs, max/run {san.max_syncs_per_run}, "
          f"new shape keys {san.retraces - san0.retraces}: "
          f"{sorted(engine.shape_keys() - keys0, key=str)}")
    print(f"[{tag}] memory_stats {engine.memory_stats()}")
    print(f"[{tag}] kernel launches on the main path: {counts}")
    check(san.max_syncs_per_run <= 1, f"{tag}: more than one sync in a run")
    profile_window(torch, engine, cfg, kw, tag)
    if len(set(engine.kinds)) > 1:
        ops_by_kind(torch, engine, tag)
    return counts


def ops_by_kind(torch, engine, tag, B=8, ctx=512, reps=10):
    """The device ops and time of one decode layer-step of each layer kind
    of a mixed stack (the hybrid's rec and attn layers), traced apart: the
    first layer of each kind steps B rows at position ctx - 1 of free
    arena slots 0 .. B - 1 (the serves are drained; a prefill rewrites
    every row it takes), ``reps`` times in one session, whose trace must
    hold a record of each hand-written kernel per step (RMSNorm twice,
    ragged decode once in an attn layer). Each kernel launches a whole
    number of times per step, so a count of some kernel that is no
    multiple of ``reps`` says that the trace lost its records (later in a
    run CUPTI drops a few); the step's ops are then also given as the sum
    over kernels of count / reps rounded."""
    x = torch.randn((B, engine.cfg.d_model), device="cuda",
                    dtype=engine.model.flags.dtype)
    pos = torch.full((B,), ctx - 1, dtype=torch.int32, device="cuda")
    slots = torch.arange(B, dtype=torch.int32, device="cuda")
    for kind in sorted(set(engine.kinds)):
        lo = engine.kinds.index(kind)
        (si, _, bps, offs), = engine._span_parts(lo, lo)
        fn = functools.partial(engine.model.apply_span_decode, bps, x,
                               engine.arenas[si], pos, kind=kind, offs=offs,
                               slots=slots, ctx=ctx, live=B)
        syms = ("rmsnorm_kernel",) + ((DECODE_ANY,)
                                      if kind == "attn" else ())
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            secs, dev, _, missing = traced_device_s(
                torch, lambda: [fn() for _ in range(reps)],
                f"{reps} {kind} decode layer-steps", syms, calls=reps)
        n_ops = sum(e.count for e in dev)
        if secs is None or missing:
            print(f"[{tag}] one {kind} decode layer-step: not measured "
                  f"(trace lacks {', '.join(missing) or 'device time'})")
            continue
        lost = [e for e in dev if e.count % reps]
        note = "" if not lost else (
            f" (records lost for {len(lost)} kernels; by kernel, count / "
            f"{reps} rounded: "
            f"{sum(round(e.count / reps) for e in dev)} device ops)")
        print(f"[{tag}] one {kind} decode layer-step (layer {lo}, batch {B}, "
              f"position {ctx - 1}, {reps} in one trace): "
              f"{n_ops / reps:.1f} device ops{note}, device time "
              f"{secs * 1e6 / reps:.1f} us")


def n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    return tree.numel()


def profile_window(torch, engine, cfg, kw, tag, n=8):
    """Where the serve phase's time goes: a separate traced serve of ``n``
    requests (after the measured one, so tracing perturbs none of its
    numbers). Device busy = the sum of every CUDA kernel's and copy's self
    time; its share of the traced wall time is a lower bound on the
    untraced one, since tracing slows the host. The trace must show every
    hand-written kernel whose launch counter moved in the traced serve;
    one that lacks any is taken again, and if it still does, its numbers
    print as not measured."""
    import repro_torch.kernels as K
    window = {}         # the last traced serve's counters and layer-steps

    def traced():
        before, steps = K.launch_counts(), engine.decode_layer_steps
        res = _serve(torch, engine, cfg, n=n, seed=5, **kw)
        after = K.launch_counts()
        window["moved"] = [k for k in after if after[k] > before[k]]
        window["steps"] = engine.decode_layer_steps - steps
        return res

    def symbols():      # of the kernels the traced serve launched
        return sorted({sym for k in window["moved"]
                       for sym in COUNTER_SYMBOLS.get(k, ())})

    busy, dev, res, missing = traced_device_s(
        torch, traced, f"the {tag} window", symbols)
    wall = res[-1]
    if busy is None or missing:
        why = ("the profiler recorded no device time" if busy is None else
               f"trace lacks {', '.join(missing)}")
        print(f"[{tag} profile] traced serve of {n} requests: wall "
              f"{wall:.3f} s; device busy share, ops per decode layer-step "
              f"and kernel shares not measured ({why})")
        return
    print(f"[{tag} profile] traced serve of {n} requests: wall {wall:.3f} s, "
          f"device busy {busy:.3f} s ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%")
    # the engine counts one decode layer-step per layer per batched decode
    # step: the device ops issued per decode layer-step (prefill's few
    # included) say how much launch work the host does for each
    n_ops = sum(e.count for e in dev)
    n_dec = window["steps"]
    print(f"[{tag} profile] {n_ops} device ops (kernels and copies) for "
          f"{n_dec} decode layer-steps: {n_dec and n_ops / n_dec:.1f} ops per "
          f"decode layer-step")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        t = e.self_device_time_total / 1e6
        print(f"[{tag} profile]   {100 * t / busy:5.1f}% {t * 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}")
    # the hand-written kernels' shares, by their symbols' names
    for label, part in SYMBOLS.items():
        hits = [e for e in dev if part in e.key]
        if not hits:
            continue
        t = sum(e.self_device_time_total for e in hits) / 1e6
        n = sum(e.count for e in hits)
        print(f"[{tag} profile] {label}: {100 * t / busy:.2f}% of device "
              f"time, {t * 1e3:.3f} ms over {n} launches "
              f"({t * 1e6 / max(n, 1):.2f} us each)")


def _isolated(engine, wl, prompt, n_tokens):
    """Generate alone through the same engine (batch of 1, node by node):
    the ground truth lazy batching must reproduce."""
    import numpy as np
    from repro_torch.core.request import SubBatch
    req = wl.sample_request(np.random.default_rng(123), 0.0)
    seq, prefix_len, cycle_len = wl.build_sequence(len(prompt), n_tokens)
    req.sequence, req.prefix_len, req.cycle_len = seq, prefix_len, cycle_len
    req.prompt_len, req.decode_len = len(prompt), n_tokens
    engine.register(req, prompt)
    sb = SubBatch([req])
    while not req.done:
        engine.execute("m", sb, req.next_node_id)
        sb.advance(0.0)
    return engine.states[req.rid].generated[:n_tokens]


def near_tie(torch, model, params, prompt, got, ref, what):
    """(j, gap) of the first token where ``got`` leaves ``ref``: the
    reference's top-2 logit gap after ``prompt`` and ``ref[:j]``, which
    must be a near-tie (below 1e-3)."""
    j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
    seq = [int(t) for t in prompt] + ref[:j]
    with torch.no_grad():
        logits, _ = model.prefill(params, torch.tensor([seq], device="cuda"))
    top2 = torch.topk(logits[0].float(), 2).values
    gap = float(top2[0] - top2[1])
    check(gap < 1e-3, f"{what} diverges at token {j} ({got[j]} vs "
                      f"{ref[j]}), top-2 gap {gap:.3e} is no near-tie")
    return j, gap


def phase_exact(torch, arch, tag, kernels, prompts, absent=()):
    """Full-width ``arch`` in f32, TF32 off, at all its layers: one request
    per prompt length batched (fused runs), then each alone node by node;
    tokens equal or a printed near-tie."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.serving import HandleState, TorchEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, max_len=512, dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} full width and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {n_params(engine.params) / 1e9:.3f}"
          f" B parameters) f32 init in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    K.reset_launch_counts()
    wl, session, handles, _, _, wall = _serve(
        torch, engine, cfg, n=len(prompts), seed=7, rate=0.0, prompts=prompts,
        decodes=(16,), max_batch=4, sla=10.0,
        fixed=[(p, 16) for p in prompts])
    batched_counts = K.launch_counts()
    check(all(h.state is HandleState.DONE for h in handles),
          f"{tag}: not every request finished")
    check_launched(batched_counts, f"{tag} (batched, fused runs)", kernels,
                   absent)
    check_decode_route(batched_counts, f"{tag} (batched, fused runs)",
                       kernels)
    print(f"[{tag}] {len(handles)} requests batched (f32, TF32 off, prompts "
          f"{list(prompts)}) in {wall:.3f} s, {engine.runs_executed} runs; "
          f"kernel launches {batched_counts}")
    K.reset_launch_counts()
    refs = {}
    for h in handles:
        r = h.request
        refs[r.rid] = _isolated(engine, wl, engine.states[r.rid].prompt_np,
                                r.decode_len)
    isolated_counts = K.launch_counts()
    check_launched(isolated_counts, f"{tag} (isolated, node by node)",
                   kernels, absent)
    check_decode_route(isolated_counts, f"{tag} (isolated, node by node)",
                       kernels)
    print(f"[{tag}] isolated references (node by node): kernel launches "
          f"{isolated_counts}")
    n_equal, n_ties = 0, 0
    for h in handles:
        r = h.request
        st = engine.states[r.rid]
        got = st.generated[:r.decode_len]
        ref = refs[r.rid]
        if got == ref:
            n_equal += 1
            continue
        j, gap = near_tie(torch, engine.model, engine.params, st.prompt_np,
                          got, ref, f"{tag}: rid {r.rid}")
        n_ties += 1
        print(f"[{tag}] rid {r.rid}: near-tie at token {j} (top-2 gap "
              f"{gap:.3e}); batched {got[j]} vs isolated {ref[j]}")
    print(f"[{tag}] {n_equal}/{len(handles)} batched generations equal the "
          f"isolated ones token for token, {n_ties} near-ties")
    return {k: batched_counts[k] + isolated_counts[k] for k in batched_counts}


LAUNCH_TRACE = ["--engine", "torch", "--policy", "lazyb", "--max-batch", "8",
                "--sla", "10", "--assert-no-leak"]


def _launch_json(name: str) -> Path:
    out = ROOT / "build" / f"{name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    return out


def _launch(torch, tag, argv):
    """``python -m repro_torch.launch.serve <argv>`` in process: ``main``
    is ``serve(parse_args(argv))[1]``, and the checks need the session.
    Returns (session, JSON document, launch counts, wall seconds)."""
    import repro_torch.kernels as K
    from repro_torch.launch import serve as launch
    print(f"[{tag}] python -m repro_torch.launch.serve {' '.join(argv)}")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    session, code = launch.serve(launch.parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    check(code == 0, f"{tag}: exit code {code}")
    out = Path(argv[argv.index("--json-out") + 1])
    return session, json.loads(out.read_text()), counts, wall


def _check_launch_session(session, tag, doc, spliced_ok=False):
    """Every request DONE with its decode_len tokens, streamed == the
    engine's, and no slot resident after the drain. With ``spliced_ok``
    a retried request may stream a prefix of its voided attempt (the
    session never retracts a streamed token) that its replay, batched
    otherwise, does not reproduce; returns (tokens, such requests)."""
    from repro_torch.serving import HandleState
    states = [h.state for h in session.handles.values()]
    check(all(st is HandleState.DONE for st in states),
          f"{tag}: not every request completed: "
          f"{sorted(st.value for st in states)}")
    spliced = []
    for h in session.handles.values():
        r = h.request
        check(len(h.tokens) == r.decode_len,
              f"{tag}: rid {r.rid} has {len(h.tokens)} tokens, wanted "
              f"{r.decode_len}")
        if session.backend.tokens(h.model, r)[:r.decode_len] != h.tokens:
            check(spliced_ok and r.retries > 0,
                  f"{tag}: rid {r.rid} ({r.retries} retries) streamed "
                  f"tokens diverge from the engine's")
            spliced.append(r.rid)
    summary = doc["summary"]
    check(summary["completed"] == len(states)
          and not any(k in summary for k in ("rejected", "cancelled",
                                             "expired", "failed", "shed")),
          f"{tag}: summary {summary}")
    check(doc["memory"]["slots_live"] == 0,
          f"{tag}: {doc['memory']['slots_live']} slots live after drain")
    return sum(len(h.tokens) for h in session.handles.values()), spliced


def _faults_seen(doc, tag):
    injected = sum(per.get("transient", 0)
                   for per in doc["injected_faults"].values())
    retried = doc["summary"].get("retried", 0)
    check(injected > 0 and retried > 0,
          f"{tag}: {injected} transient faults injected, {retried} retries")
    return injected, retried


def phase_launch_serve(torch):
    """``python -m repro_torch.launch.serve`` in process: full-width
    llama3.2-1b in bf16 with seeded transient faults and retries; then
    in float32 (TF32 off) with and without the faults, where every
    request's tokens must be the fault-free run's."""
    # transient faults void every member of the faulted batched run, and a
    # retry replays its request from the prefill: 0.02 per run with 16
    # retries leaves every request room to finish
    argv = [*LAUNCH_TRACE, "--arch", "llama3.2-1b", "--rate", "20",
            "--duration", "1.2", "--fault-spec", "transient:0.02",
            "--max-retries", "16"]
    session, doc, counts, wall = _launch(
        torch, "launch serve",
        [*argv, "--json-out", str(_launch_json("launch_serve"))])
    n_tok, spliced = _check_launch_session(session, "launch serve", doc,
                                           spliced_ok=True)
    injected, retried = _faults_seen(doc, "launch serve")
    check_launched(counts, "launch serve", LLAMA_KERNELS)
    s, log = doc["summary"], doc["log"]
    n_retried = sum(1 for h in session.handles.values()
                    if h.request.retries)
    print(f"[launch serve] {s['completed']} requests, {n_tok} tokens; "
          f"{injected} transient faults injected, {retried} retries of "
          f"{n_retried} requests; wall {wall:.3f} s (engine build "
          f"included); session busy {log['busy_time']:.3f} s over "
          f"{log['runs_executed']} runs: {n_tok / log['busy_time']:.1f} "
          f"tokens per busy second")
    print(f"[launch serve] latency p50 {s['p50_ms']:.1f} ms p99 "
          f"{s['p99_ms']:.1f} ms (session clock); SLA 10 s violation rate "
          f"{s['sla_violation_rate']:.3f}; slots live after drain "
          f"{doc['memory']['slots_live']}")
    print(f"[launch serve] bf16: {len(spliced)} of {n_retried} retried "
          f"requests streamed a voided attempt's prefix that their replay, "
          f"batched otherwise, does not reproduce (rids {spliced})")
    print(f"[launch serve] kernel launches on the main path: {counts}")
    del session
    gc.collect()
    torch.cuda.empty_cache()
    # float32 with TF32 off: batched runs equal isolated ones (the exact
    # phases), so a replay must give the fault-free run's tokens
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = [*argv, "--dtype", "float32"]
    faulty, doc, f32_counts, wall = _launch(
        torch, "launch serve f32",
        [*f32, "--json-out", str(_launch_json("launch_serve_f32"))])
    _check_launch_session(faulty, "launch serve f32", doc)
    injected, retried = _faults_seen(doc, "launch serve f32")
    check_launched(f32_counts, "launch serve f32", LLAMA_KERNELS)
    got = [h.tokens for h in faulty.handles.values()]
    del faulty
    gc.collect()
    torch.cuda.empty_cache()
    clean, doc, _, _ = _launch(
        torch, "launch serve f32 fault-free",
        [*argv[:argv.index("--fault-spec")], "--dtype", "float32",
         "--json-out", str(_launch_json("launch_serve_f32_clean"))])
    _check_launch_session(clean, "launch serve f32 fault-free", doc)
    ref = [h.tokens for h in clean.handles.values()]
    differ = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    check(len(got) == len(ref) and not differ,
          f"launch serve f32: requests {differ} of {len(got)} got other "
          f"tokens than the fault-free run's")
    print(f"[launch serve f32] {len(got)} requests, {injected} transient "
          f"faults injected, {retried} retries: every request's tokens "
          f"equal the fault-free run's")
    return counts


def phase_launch_tenants(torch):
    """The launcher's multi-tenant path: full-width llama3.2-1b and
    mamba2-2.7b in bf16 on one card behind a MultiBackend, 16 slots
    split between their arenas, the least-slack arbiter."""
    argv = [*LAUNCH_TRACE, "--models", "llama3.2-1b:0.5,mamba2-2.7b:0.5",
            "--mem-slots", "16", "--arbiter", "least-slack", "--rate", "16",
            "--duration", "1.5", "--json-out",
            str(_launch_json("launch_tenants"))]
    torch.cuda.reset_peak_memory_stats()
    session, doc, counts, wall = _launch(torch, "launch tenants", argv)
    n_tok, _ = _check_launch_session(session, "launch tenants", doc)
    engines = session.backend.backends
    check(sum(e.max_slots for e in engines.values()) == 16
          and min(e.max_slots for e in engines.values()) >= 1,
          f"launch tenants: arena caps "
          f"{ {n: e.max_slots for n, e in engines.items()} }")
    for name in engines:
        n_model = sum(1 for h in session.handles.values() if h.model == name)
        row = doc["per_model"][name]
        check(n_model > 0 and row["completed"] == n_model,
              f"launch tenants: {name} completed {row['completed']} of "
              f"{n_model}")
    check_launched(counts, "launch tenants", LLAMA_KERNELS + ("ssd_chunked",))
    print(f"[launch tenants] {doc['summary']['completed']} requests, {n_tok} "
          f"tokens in {wall:.3f} s wall (two engine builds included); "
          f"session busy {doc['log']['busy_time']:.3f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    for name, eng in engines.items():
        row = doc["per_model"][name]
        print(f"[launch tenants] [{name}] completed {row['completed']} p50 "
              f"{row['p50_ms']:.1f} ms p99 {row['p99_ms']:.1f} ms "
              f"(session clock), attainment {row['sla_attainment']:.3f}, busy "
              f"{doc['log']['busy_by_model'].get(name, 0.0):.3f} s; "
              f"memory_stats {eng.memory_stats()}")
    print(f"[launch tenants] kernel launches on the main path: {counts}")
    return counts


async def _sse_stream(port, body, disconnect_after=None):
    """One ``POST /v1/generate``: (tokens, fate, wall seconds to the first
    token); the connection is dropped after ``disconnect_after`` tokens."""
    import asyncio
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nhost: 127.0.0.1\r\n"
                  f"content-type: application/json\r\ncontent-length: "
                  f"{len(payload)}\r\nconnection: close\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    while (await reader.readline()).strip():
        pass                                     # headers
    tokens, fate, ttft, event = [], None, None, None
    while True:
        line = (await reader.readline()).decode()
        if not line:
            break
        line = line.strip()
        if line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            data = json.loads(line[5:])
            if event == "token":
                if ttft is None:
                    ttft = loop.time() - t0
                tokens.append(data["token"])
                if disconnect_after is not None \
                        and len(tokens) >= disconnect_after:
                    writer.transport.abort()
                    return tokens, "aborted", ttft
            elif event in ("done", "error"):
                fate = data.get("fate", event)
    writer.close()
    return tokens, fate if status == 200 else f"http {status}", ttft


async def _fetch(port, path):
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nhost: 127.0.0.1\r\n"
                 f"connection: close\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode()


def phase_gateway(torch):
    """``python -m repro_torch.launch.gateway``'s app in process over
    full-width llama3.2-1b in bf16: 16 concurrent SSE streams (gold and
    bulk) and one that disconnects after its first token."""
    import asyncio
    import numpy as np
    import repro_torch.kernels as K
    from repro_torch.launch import gateway
    from repro_torch.launch.serve import FULL_LENGTHS
    from repro_torch.serving import HandleState
    argv = ["--engine", "torch", "--arch", "llama3.2-1b", "--port", "0",
            "--time-scale", "1", "--sla-tiers", "gold:2,bulk:10",
            "--mem-slots", "16", "--max-batch", "8", "--quiet"]
    print(f"[gateway] python -m repro_torch.launch.gateway {' '.join(argv)}")
    args = gateway.parse_args(argv)
    t0 = time.perf_counter()
    app = gateway.build_app(args)           # builds and warms the engine
    print(f"[gateway] engine built and warmed up in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts, decodes = FULL_LENGTHS
    rng = np.random.default_rng(0)
    bodies = [{"sla_class": "gold" if i % 2 else "bulk",
               "prompt_len": int(rng.choice(prompts)),
               "decode_len": int(rng.choice(decodes))} for i in range(16)]

    async def scenario():
        await app.start()
        loop = asyncio.get_running_loop()
        handles = app.session.handles
        tasks = []
        # the stream that disconnects goes first; each stream is submitted
        # once the previous one has its handle, so stream i is handle i
        first = {"sla_class": "bulk", "prompt_len": prompts[1],
                 "decode_len": decodes[-1]}
        for i, body in enumerate([first] + bodies):
            n = len(handles)
            tasks.append(asyncio.create_task(_sse_stream(
                app.port, body, disconnect_after=1 if i == 0 else None)))
            deadline = loop.time() + 60
            while len(handles) == n and loop.time() < deadline:
                await asyncio.sleep(0.001)
        try:
            results = await asyncio.wait_for(asyncio.gather(*tasks), 600)
        except asyncio.TimeoutError:
            pump = app._pump_task          # the SessionDriver.pump() task
            raise SmokeFailure(
                "gateway: streams still open after 600 s; the pump "
                + (f"died: {pump.exception()!r}" if pump.done()
                   else "is running"))
        aborted = list(handles.values())[0]
        deadline = loop.time() + 60
        while not aborted.done and loop.time() < deadline:
            await asyncio.sleep(0.005)
        metrics = await _fetch(app.port, "/metrics")
        stats = await app.drain()
        return results, metrics, stats

    K.reset_launch_counts()
    t0 = time.perf_counter()
    results, (m_status, metrics), stats = asyncio.run(scenario())
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    handles = list(app.session.handles.values())
    check(len(handles) == 17, f"gateway: {len(handles)} handles, wanted 17")
    check(results[0][1] == "aborted"
          and handles[0].state is HandleState.CANCELLED,
          f"gateway: the disconnected stream ended {handles[0].state.value}")
    n_tok = 0
    for i, ((tokens, fate, _), body, h) in enumerate(
            zip(results[1:], bodies, handles[1:]), 1):
        check(fate == "done" and h.state is HandleState.DONE,
              f"gateway: stream {i} ended {fate} ({h.state.value})")
        check(len(tokens) == body["decode_len"] and tokens == h.tokens,
              f"gateway: stream {i} got {len(tokens)} tokens, wanted "
              f"{body['decode_len']} equal to its handle's")
        n_tok += len(tokens)
    check(m_status == 200 and "gateway_requests_total" in metrics,
          f"gateway: GET /metrics returned {m_status}")
    mem = app.session.backend.memory_stats()
    check(mem.slots_live == 0, f"gateway: {mem.slots_live} slots live "
                               f"after drain")
    check_launched(counts, "gateway", LLAMA_KERNELS)
    ttft = [r[2] for r in results[1:]]
    lat = [h.latency for h in handles[1:]]
    loop_stats = app.sanitizer.stats
    print(f"[gateway] 16 streams done, {n_tok} tokens in {wall:.3f} s wall; "
          f"the disconnected stream CANCELLED after {len(results[0][0])} "
          f"token(s); /metrics 200; slots live after drain 0")
    print(f"[gateway] client wall TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f}"
          f" ms p99 {np.percentile(ttft, 99) * 1e3:.1f} ms; latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.1f} ms p99 "
          f"{np.percentile(lat, 99) * 1e3:.1f} ms (session clock)")
    for name, row in stats.per_class(args.sla).items():
        print(f"[gateway] tier {name}: completed {row['completed']}, SLA "
              f"attainment {row['sla_attainment']:.3f}")
    print(f"[gateway] event loop: {loop_stats.ticks} probes, "
          f"{loop_stats.stalls} stall(s) over {args.stall_threshold} s, max "
          f"lag {loop_stats.max_lag_s * 1e3:.1f} ms, lag p99 "
          f"{loop_stats.lag_p99_s() * 1e3:.1f} ms (not gated)")
    print(f"[gateway] kernel launches on the main path: {counts}")
    return counts


# ---------------------------------------------------------------------------
# training: repro_torch.launch.train and the training API on the card
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "llama3.2-1b", "--steps", "30", "--batch", "8",
              "--seq", "256"]


def _leaf_grad_check(torch, grads, tag):
    """Every parameter leaf has a finite, nonzero gradient: (leaves, the
    smallest gradient norm and its leaf)."""
    from repro_torch.training.tree import flatten_with_paths, keystr
    norms = {}
    for path, g in flatten_with_paths(grads):
        key = keystr(path)
        check(bool(torch.isfinite(g).all()), f"{tag}: leaf {key} has a "
                                             f"gradient that is not finite")
        norms[key] = float(g.norm())
        check(norms[key] > 0, f"{tag}: leaf {key} got no gradient (norm 0)")
    low = min(norms, key=norms.get)
    return len(norms), norms[low], low


def phase_train(torch):
    """``repro_torch.launch.train`` on full-width llama3.2-1b in float32:
    every leaf's gradient at step 0, then 30 steps of 8 x 256 through the
    launcher's own ``train`` (counters reset just before, read just after),
    the loss falling, the checkpoint restoring bit for bit, and a profiled
    window of 3 more steps; the SM clock and power draw are sampled over
    the launcher's run."""
    import repro_torch.kernels as K
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models.cost import model_flops
    from repro_torch.sharding import make_rules, use_rules
    from repro_torch.training import (checkpoint, init_state,
                                      make_train_step, value_and_grad)
    from repro_torch.training.trainer import to_device
    from repro_torch.training.tree import leaves
    ck = ROOT / "build" / "train_llama.npz"
    args = launch_train.parse_args(TRAIN_ARGV + ["--checkpoint", str(ck)])
    model, opt_cfg, data, gen = launch_train.build(args)
    cfg = model.cfg
    print(f"[train] python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_ARGV)} --checkpoint {ck}: {cfg.name} full width "
          f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B params) in float32; TF32 "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}")
    # step 0 of the launcher's own run: its weights (seed 0) and batch
    state0 = init_state(model, gen)
    (loss0, _), grads = value_and_grad(model, state0.params,
                                       to_device(next(iter(data)), "cuda"))
    n, low, low_key = _leaf_grad_check(torch, grads, "train")
    print(f"[train] step 0: loss {loss0.item():.4f}; all {n} parameter "
          f"leaves have a finite, nonzero gradient (smallest norm "
          f"{low:.3e} at {low_key})")
    del state0, grads, loss0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with SmiSampler() as smi:
        t0 = time.perf_counter()
        state, log, code = launch_train.train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = K.launch_counts()
    print(f"[train] during the launcher's run: {smi.summary()}")
    check(code == 0, f"train: the launcher exited {code}")
    check(log.losses[-1] < log.losses[0],
          f"train: the loss did not fall ({log.losses})")
    check_launched(counts, "train", TRAIN_KERNELS, TRAIN_ABSENT)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = args.batch * args.seq
    sps = (log.wall[-1] - log.wall[0]) / (log.steps[-1] - log.steps[0])
    flops = model_flops(cfg, tokens, train=True)
    print(f"[train] losses {[round(x, 4) for x in log.losses]} at steps "
          f"{log.steps}; {args.steps} steps in {wall:.2f} s wall (first step "
          f"included)")
    print(f"[train] {sps:.4f} s per step after step 0 "
          f"({tokens / sps:.1f} training tokens/s); peak "
          f"{peak:.2f} GB allocated; model_flops(train) "
          f"{flops / 1e12:.2f} TFLOP per step: {flops / sps / 1e12:.2f} "
          f"TFLOP/s, {100 * flops / sps / F32_CUDA_CORE_FLOPS:.1f}% of "
          f"the f32 peak of {F32_CUDA_CORE_FLOPS / 1e12:.0f} TFLOP/s")
    print(f"[train] kernel launches on the main path: {counts}")
    restored, step = checkpoint.restore(str(ck), state.params)
    same = all(torch.equal(_whole(a), _whole(b).detach()) for a, b in zip(
        leaves(restored), leaves(state.params)))
    check(same and step == args.steps,
          f"train: the checkpoint does not restore bit for bit (step {step})")
    print(f"[train] checkpoint {ck.name} ({ck.stat().st_size / 1e9:.2f} GB) "
          f"restores bit for bit at step {step}")
    del restored
    # where the time goes: 3 more steps of the same state (DTensors on the
    # launcher's 1-rank mesh), under its rules, traced
    step_fn = make_train_step(model, opt_cfg)
    mesh = leaves(state.params)[0].device_mesh
    rules = make_rules(mesh, "train")
    more = iter(TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=args.seq,
                                         batch_size=args.batch, seed=1)))
    with use_rules(rules):
        batches = [to_device(next(more), "cuda", mesh) for _ in range(3)]
    span = {}

    def three():
        t = time.perf_counter()
        with use_rules(rules):
            for b in batches:
                step_fn(state, b)
        torch.cuda.synchronize()
        span["wall"] = time.perf_counter() - t

    busy, dev, _, missing = traced_device_s(
        torch, three, "3 train steps",
        ("flash_tf32x3_kernel", "rmsnorm_kernel"))
    # the trace shows the kernels of the path (fails after its tries)
    check_trace(busy, missing, "train: 3 traced steps")
    print(f"[train profile] 3 traced steps: wall {span['wall']:.3f} s, "
          f"device busy {busy:.3f} s ({100 * busy / span['wall']:.1f}%), "
          f"{sum(e.count for e in dev) / 3:.0f} device ops per step")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        t = e.self_device_time_total / 1e6
        print(f"[train profile]   {100 * t / busy:5.1f}% {t * 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}")
    for label, part in SYMBOLS.items():
        hits = [e for e in dev if part in e.key]
        if hits:
            t = sum(e.self_device_time_total for e in hits) / 1e6
            print(f"[train profile] {label}: {100 * t / busy:.2f}% of device "
                  f"time, {t * 1e3:.3f} ms over "
                  f"{sum(e.count for e in hits)} launches")
    del state, batches
    _end_process_group()
    return counts


def _whole(t):
    """A DTensor read whole (its ``full_tensor``), a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _end_process_group():
    """End the process group the launcher made (a 1-rank NCCL group)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def card_vs_cpu_grads(torch, model, params, batch, tag, kernels):
    """The loss and every leaf's gradient of ``model`` at ``params`` on the
    card (the kernels' forwards, the Functions' backwards; ``kernels``
    must launch) against the CPU (plain versions) from the same weights:
    the loss to rtol 1e-5, each leaf to ||g_card - g_cpu|| / ||g_cpu||
    <= 1e-3. Returns the card's launch counts."""
    import repro_torch.kernels as K
    from repro_torch.training import value_and_grad
    from repro_torch.training.trainer import to_device
    from repro_torch.training.tree import flatten_with_paths, keystr, map_tree
    K.reset_launch_counts()
    t0 = time.perf_counter()
    (loss, _), grads = value_and_grad(model, params, to_device(batch, "cuda"))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    counts = K.launch_counts()
    check_launched(counts, f"{tag} (card)", kernels, TRAIN_ABSENT)
    card = {keystr(p): g.cpu() for p, g in flatten_with_paths(grads)}
    card_loss = loss.item()
    cpu_params = map_tree(lambda t: t.detach().cpu().requires_grad_(True),
                          params)
    del grads, loss
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (loss, _), grads = value_and_grad(model, cpu_params,
                                      to_device(batch, "cpu"))
    t_cpu = time.perf_counter() - t0
    cpu_loss = loss.item()
    check(abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss),
          f"{tag}: loss {card_loss} on the card vs {cpu_loss} on the "
          f"CPU (rtol 1e-5)")
    rel = {}
    for p, g in flatten_with_paths(grads):
        key = keystr(p)
        rel[key] = float((card[key] - g).norm() / g.norm())
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 1e-3, f"{tag}: leaf {worst} gradient differs "
                              f"by {rel[worst]:.3e} (||dg|| / ||g||, "
                              f"tolerance 1e-3)")
    print(f"[{tag}] loss card {card_loss:.7f} vs CPU {cpu_loss:.7f} (rel "
          f"{abs(card_loss - cpu_loss) / abs(cpu_loss):.2e}); {len(rel)} "
          f"leaves, worst ||g_card - g_cpu|| / ||g_cpu|| {rel[worst]:.3e} at "
          f"{worst}; card {t_card:.2f} s, CPU {t_cpu:.2f} s; kernel "
          f"launches on the card {counts}")
    return counts


def phase_train_exact(torch):
    """Full-width llama3.2-1b, float32 with TF32 off, one sequence of 64
    tokens: the loss and every leaf's gradient on the card (the kernels'
    forwards, the Functions' backwards) against the CPU (plain versions)
    from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import Model, RuntimeFlags
    from repro_torch.training import init_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.2-1b")
    model = Model(cfg, RuntimeFlags(dtype=torch.float32))
    state = init_state(model, torch.Generator(device="cuda").manual_seed(0))
    batch = next(iter(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, batch_size=1, seed=2))))
    print(f"[train exact] {cfg.name} full width, f32, TF32 off, batch 1 x "
          f"64")
    return card_vs_cpu_grads(torch, model, state.params, batch,
                             "train exact", TRAIN_KERNELS)


def phase_train_mamba(torch):
    """mamba2-2.7b at full width cut to 8 of its 64 layers, float32, 10
    steps of 4 x 256 through ``train_loop``: the loss falls and the SSD
    scan's split-TF32 route runs in every layer's forward. Then, from
    fresh weights with TF32 off, one sequence of 64 tokens (SSD chunk 64,
    the split-TF32 route): the loss and every leaf's gradient on the card
    against the CPU, as ``train exact``."""
    import dataclasses
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import Model, RuntimeFlags
    from repro_torch.training import OptimizerConfig, init_state, train_loop
    from repro_torch.training.tree import leaves
    full = get_config("mamba2-2.7b")
    cfg = dataclasses.replace(full, num_layers=8)
    steps, B, S = 10, 4, 256
    print(f"[train mamba] {cfg.name}: d_model {cfg.d_model}, "
          f"{cfg.ssm.n_heads(cfg.d_model)} SSD heads of {cfg.ssm.head_dim}, "
          f"state {cfg.ssm.d_state}, vocab {cfg.vocab_size}; cut: "
          f"{cfg.num_layers} of "
          f"{full.num_layers} layers (the only cut), "
          f"{cfg.param_count() / 1e9:.3f} B params; float32, {steps} steps "
          f"of {B} x {S} (SSD chunk 256)")
    model = Model(cfg, RuntimeFlags(dtype=torch.float32))
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    batch_size=B))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, log = train_loop(
        model, OptimizerConfig(warmup_steps=1, total_steps=steps),
        iter(data), steps,
        generator=torch.Generator(device="cuda").manual_seed(0),
        log_every=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    check(log.losses[-1] < log.losses[0],
          f"train mamba: the loss did not fall ({log.losses})")
    check(all(bool(torch.isfinite(p).all()) for p in leaves(state.params)),
          "train mamba: a parameter is not finite")
    check_launched(counts, "train mamba", TRAIN_MAMBA_KERNELS, TRAIN_ABSENT)
    sps = (log.wall[-1] - log.wall[0]) / (log.steps[-1] - log.steps[0])
    print(f"[train mamba] losses {[round(x, 4) for x in log.losses]} at "
          f"steps {log.steps}; {wall:.2f} s wall; {sps:.4f} s per step after "
          f"step 0 ({B * S / sps:.1f} training tokens/s); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    print(f"[train mamba] kernel launches on the main path: {counts}")
    del state, log
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fresh = init_state(model, torch.Generator(device="cuda").manual_seed(3))
    batch = next(iter(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, batch_size=1, seed=2))))
    print(f"[train mamba exact] the same 8 layers, f32, TF32 off, batch 1 x "
          f"64")
    card_vs_cpu_grads(torch, model, fresh.params, batch, "train mamba exact",
                      TRAIN_MAMBA_KERNELS)
    return counts


# ---------------------------------------------------------------------------
# sharding: the launcher's mesh path and the remat flags
# ---------------------------------------------------------------------------

SHARD_ARGV = ["--arch", "llama3.2-1b", "--steps", "10", "--batch", "8",
              "--seq", "256", "--log-every", "1"]
SHARD_LOSS_RTOL = 1e-6
REMAT_GRAD_REL = 1e-6           # ||g - g_off|| / ||g_off|| per leaf
SHARD_ROUNDS = 6                # timed steps of each path, in turns


def _step_s(torch, fn) -> float:
    """Wall seconds of ``fn()`` between two synchronizes."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def phase_sharding(torch):
    """(a) ``repro_torch.launch.train`` through its mesh path (a 1-rank
    NCCL ``data`` mesh, DTensor state, the train rules) on full-width
    llama3.2-1b in float32 with TF32 off, 10 steps of 8 x 256, seed 0:
    every logged loss against ``train_loop`` on plain tensors from the
    same weights and batches (rtol 1e-6; bit-equality printed), flash and
    RMSNorm launched inside the mesh run; then seconds per step of both
    paths, a step of each in turns. (b) ``RuntimeFlags.remat`` off /
    "full" / "dots" on the same model and first batch: the loss and every
    leaf's gradient against remat off (bit-equal or ||dg|| / ||g|| <=
    1e-6), and the flash / RMSNorm launches of one forward and backward:
    the blocks' kernels run twice under remat (the final norm once); then
    one train step per mode in turns: seconds and peak memory."""
    import repro_torch.kernels as K
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model, RuntimeFlags
    from repro_torch.sharding import make_rules, use_rules
    from repro_torch.training import (TrainState, init_adamw, init_state,
                                      make_train_step, train_loop,
                                      value_and_grad)
    from repro_torch.training.trainer import to_device
    from repro_torch.training.tree import flatten_with_paths, keystr, leaves
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = launch_train.parse_args(SHARD_ARGV)
    print(f"[sharding] python -m repro_torch.launch.train "
          f"{' '.join(SHARD_ARGV)}: its mesh path, float32, TF32 off")
    K.reset_launch_counts()
    state_m, log_m, code = launch_train.train(args)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check(code == 0, f"sharding: the launcher exited {code}")
    check_launched(counts, "sharding (mesh path)", TRAIN_KERNELS,
                   TRAIN_ABSENT)
    first = leaves(state_m.params)[0]
    mesh = first.device_mesh
    print(f"[sharding] mesh {mesh.mesh_dim_names} x {tuple(mesh.shape)} on "
          f"the {torch.distributed.get_backend()} backend; parameters "
          f"{type(first).__name__} {tuple(first.placements)}; kernel "
          f"launches in the mesh run {counts}")
    model, opt_cfg, data, gen = launch_train.build(args)
    state_u, log_u = train_loop(model, opt_cfg, iter(data), args.steps,
                                generator=gen, log_every=1, verbose=False)
    check(log_m.steps == log_u.steps, f"sharding: logged steps differ "
                                      f"({log_m.steps} vs {log_u.steps})")
    worst = max(abs(a - b) / abs(b) for a, b in zip(log_m.losses,
                                                    log_u.losses))
    check(worst <= SHARD_LOSS_RTOL,
          f"sharding: mesh losses {log_m.losses} vs unsharded "
          f"{log_u.losses} (worst rel {worst:.3e}, rtol {SHARD_LOSS_RTOL})")
    bit = log_m.losses == log_u.losses
    print(f"[sharding] losses mesh {log_m.losses}")
    print(f"[sharding] losses unsharded {log_u.losses}")
    print(f"[sharding] {len(log_m.losses)} logged losses agree: worst rel "
          f"{worst:.3e} (rtol {SHARD_LOSS_RTOL}); bit-equal: {bit}")

    # seconds per step, one step of each path in turns, on their states
    rules = make_rules(mesh, "train")
    step_fn = make_train_step(model, opt_cfg)
    batch_np = next(iter(data))
    with use_rules(rules):
        b_mesh = to_device(batch_np, "cuda", mesh)
    b_plain = to_device(batch_np, "cuda")

    def mesh_step():
        with use_rules(rules):
            step_fn(state_m, b_mesh)

    times = {"mesh": [], "unsharded": []}
    for _ in range(2):                        # warm both
        mesh_step()
        step_fn(state_u, b_plain)
    for i in range(SHARD_ROUNDS):
        order = ("mesh", "unsharded") if i % 2 == 0 else ("unsharded",
                                                          "mesh")
        for which in order:
            times[which].append(_step_s(torch, mesh_step if which == "mesh"
                                        else lambda: step_fn(state_u,
                                                             b_plain)))
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[sharding] s per step (median of {SHARD_ROUNDS}, in turns): "
          f"mesh {med['mesh']:.4f}, unsharded {med['unsharded']:.4f}, gap "
          f"{med['mesh'] - med['unsharded']:+.4f} s "
          f"({100 * (med['mesh'] / med['unsharded'] - 1):+.2f}%); all "
          f"{times} [{smi}]")
    del state_m, state_u, b_mesh, b_plain
    _end_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # (b) remat off / full / dots on the same weights and first batch
    cfg = model.cfg
    params = init_state(model, torch.Generator(device="cuda").manual_seed(0)
                        ).params
    batch = to_device(batch_np, "cuda")
    modes = {"off": Model(cfg, RuntimeFlags(dtype=torch.float32)),
             "full": Model(cfg, RuntimeFlags(dtype=torch.float32, remat=True,
                                             remat_policy="full")),
             "dots": Model(cfg, RuntimeFlags(dtype=torch.float32, remat=True,
                                             remat_policy="dots"))}
    # the loss, every leaf's gradient and the launches of one forward and
    # backward per mode, on the same weights
    res = {}
    ref = None
    for name in ("off", "full", "dots"):
        K.reset_launch_counts()
        (loss, _), grads = value_and_grad(modes[name], params, batch)
        torch.cuda.synchronize()
        r = res[name] = dict(counts=K.launch_counts(),
                             loss=float(loss.detach()), bit=True, rel=0.0)
        flat = [(keystr(p), g.detach()) for p, g in
                flatten_with_paths(grads)]
        del grads, loss
        if ref is None:
            ref = flat
            continue
        rels = {k: float((g - g0).norm() / g0.norm())
                for (k, g), (_, g0) in zip(flat, ref)}
        r["bit"] = all(torch.equal(g, g0) for (_, g), (_, g0) in zip(flat,
                                                                      ref))
        r["worst"] = max(rels, key=rels.get)
        r["rel"] = rels[r["worst"]]
        del flat
        check(r["loss"] == res["off"]["loss"],
              f"sharding: remat {name} loss {r['loss']} vs "
              f"{res['off']['loss']} without remat")
        check(r["bit"] or r["rel"] <= REMAT_GRAD_REL,
              f"sharding: remat {name} gradient of {r['worst']} differs "
              f"by {r['rel']:.3e} (tolerance {REMAT_GRAD_REL})")
    del ref
    off = res["off"]["counts"]
    for name in ("full", "dots"):
        c = res[name]["counts"]
        # every block's flash and RMSNorms run again in the backward pass;
        # the final norm, outside the blocks, once
        want = {"flash_attention": 2 * off["flash_attention"],
                "fused_rmsnorm": 2 * off["fused_rmsnorm"] - 1}
        check(all(c[k] == v for k, v in want.items()),
              f"sharding: remat {name} launched {c} (expected {want})")
    # one train step (AdamW included) per mode in turns, on one state:
    # seconds, and the peak allocated over each step
    gc.collect()
    torch.cuda.empty_cache()
    state = TrainState(params, init_adamw(params))
    steps = {k: make_train_step(m, opt_cfg) for k, m in modes.items()}
    resident = torch.cuda.memory_allocated()
    times = {k: [] for k in modes}
    peaks = {k: 0 for k in modes}
    for name in ("off", "full", "dots", "dots", "full", "off"):
        torch.cuda.reset_peak_memory_stats()
        times[name].append(_step_s(torch, lambda: steps[name](state, batch)))
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
    for name, r in res.items():
        agree = ("bit-equal to remat off" if r["bit"] else
                 f"within {r['rel']:.3e} of remat off (||dg|| / ||g|| at "
                 f"{r['worst']})")
        print(f"[sharding] remat {name}: train step "
              f"{statistics.mean(times[name]):.4f} s (mean of 2, in turns: "
              f"{times[name]}); peak {peaks[name] / 1e9:.2f} GB allocated, "
              f"{(peaks[name] - resident) / 1e9:.2f} GB above the "
              f"{resident / 1e9:.2f} GB of weights and moments; loss "
              f"{r['loss']!r}; gradients {agree}; flash "
              f"{r['counts']['flash_attention']}, RMSNorm "
              f"{r['counts']['fused_rmsnorm']} launches in one forward and "
              f"backward [{smi}]")
    return counts


# ---------------------------------------------------------------------------
# the dry-run tools: the sweep under this torch, the roofline on the card
# ---------------------------------------------------------------------------

DRYRUN_JOBS = 7                 # the sweep's worker processes (8 cores)
DRYRUN_LIMIT_S = 420            # the sweep's own time limit
ROOFLINE_LIMIT_S = 300          # the (1, 1) roofline probes' own limit
# (arch, shape, the kernels its step must launch, their profiler symbols)
ROOFLINE_PROBES = (
    ("llama3.2-1b", "decode_32k", ("ragged_decode_attention",
                                   "ragged_decode_attention_n8",
                                   "fused_rmsnorm")),
    ("llama3.2-1b", "prefill_32k", ("flash_attention", "fused_rmsnorm")),
    ("mamba2-2.7b", "prefill_32k", ("ssd_chunked", "ssd_chunked_tc",
                                    "fused_rmsnorm")),
    ("recurrentgemma-9b", "decode_32k", ("ragged_decode_attention",
                                         "ragged_decode_attention_tc",
                                         "fused_rmsnorm")),
)
KERNEL_SYMBOL = {"ragged_decode_attention": DECODE_ANY,
                 "ragged_decode_attention_tc": "ragged_decode_tc_kernel",
                 "ragged_decode_attention_n8": "ragged_decode_n8_kernel",
                 "ragged_decode_attention_n8_tf32":
                     "ragged_decode_n8_tf32_kernel",
                 "flash_attention": "flash_tc_kernel",
                 "fused_rmsnorm": "rmsnorm_kernel", "ssd_chunked": "ssd_"}
# a measured layer or kernel row under this share of its bound fails
BOUND_FLOOR = 0.95
ROOFLINE_REPS = 3
# each timed step waits behind a spin kernel this long: a mesh step's host
# dispatch (DTensor's) has taken up to 35 ms, more than a 1-layer step's
# device time, which the difference t(2 x base) - t(base) would otherwise
# take for the layer's
ROOFLINE_AHEAD_MS = 100.0


def _run_module(argv, limit_s: float, log: Path):
    """``python -m argv`` from the repo in a session of its own, stdout
    and stderr to ``log``; (exit code, the log's text). Past ``limit_s``
    the whole session (the sweep's workers too) is killed and the phase
    fails."""
    import signal
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=limit_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise SmokeFailure(f"{' '.join(argv)} outlived its {limit_s} s "
                               f"(log {log})") from None
    return rc, log.read_text()


def _probe_inputs(torch, combo):
    """Seed-0 weights and seeded inputs of a serve combo at its shape, on
    the card: prefill tokens; decode a cache of normal entries (0.5) with
    every row's position at its last row."""
    model, shape = combo.model, combo.shape
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    B, S, V = shape.global_batch, shape.seq_len, combo.cfg.vocab_size
    tok = lambda *shp: torch.randint(2, V, shp, generator=g, device="cuda",
                                     dtype=torch.int32)
    if shape.kind == "prefill":
        return params, {"tokens": tok(B, S)}
    from repro_torch.training.tree import leaves
    cache = model.init_cache(B, S, device="cuda")
    for leaf in leaves(cache):
        leaf.normal_(0.0, 0.5, generator=g)
    return (params, cache, tok(B),
            torch.full((B,), S - 1, dtype=torch.int32, device="cuda"))


def _roofline_step(torch, arch, shape, L, B, mesh, rules, kernels, smi):
    """One probe depth at global batch ``B``: the mesh step against the
    plain one, the launches, both times (in turns), and the kernels'
    device time of a traced mesh step."""
    import repro_torch.kernels as K
    from repro_torch.launch.steps import build_combo
    from repro_torch.sharding import use_rules
    from repro_torch.training.tree import map_tree
    combo = build_combo(arch, shape, mesh, cfg_overrides={"num_layers": L},
                        batch=B)
    args = _probe_inputs(torch, combo)
    # the plain step on a copy of a decode's cache: a recurrent state
    # (the hybrid's) is advanced in place by each step
    plain_args = (args if len(args) == 2 else
                  (args[0], map_tree(torch.clone, args[1]), *args[2:]))
    with torch.no_grad():
        plain = combo.fn(*plain_args)[0].clone()
    placed = combo.place(args)

    def mesh_step():
        with use_rules(rules):
            return combo.fn(*placed)

    K.reset_launch_counts()
    got = mesh_step()[0]
    torch.cuda.synchronize()
    counts = K.launch_counts()
    what = f"roofline {arch} x {shape} at {L} layers"
    check_launched(counts, what, kernels)
    logits = _whole(got)
    check(tuple(logits.shape) == tuple(plain.shape)
          and bool(torch.isfinite(logits).all()),
          f"{what}: logits {tuple(logits.shape)} not finite or not "
          f"{tuple(plain.shape)}")
    err = compare(torch, logits, plain, "bfloat16", f"{what} (mesh vs plain)")
    bit = bool(torch.equal(logits, plain))
    del got, logits, plain
    times = {"mesh": [], "plain": []}
    for which in ("mesh", "plain", "plain", "mesh"):
        fn = mesh_step if which == "mesh" else lambda: combo.fn(*plain_args)
        times[which].append(cuda_ms(torch, fn, reps=ROOFLINE_REPS,
                                    ahead_ms=ROOFLINE_AHEAD_MS,
                                    warmup=1))
    # ROOFLINE_REPS traces of one step each, each kernel's records at
    # least its launches in the step (a trace that lost one would read a
    # layer's difference short); a kernel's device time a step is their
    # mean
    calls = {KERNEL_SYMBOL[k]: counts[k] for k in kernels
             if k in KERNEL_SYMBOL}
    dev_us = {k: 0.0 for k in kernels if k in KERNEL_SYMBOL}
    for _ in range(ROOFLINE_REPS):
        _, dev, _, missing = traced_device_s(torch, mesh_step, what,
                                             list(calls), calls,
                                             warm=mesh_step)
        check(not missing, f"{what}: the trace lacks {missing}")
        for k in dev_us:
            dev_us[k] += sum(e.self_device_time_total for e in dev
                             if KERNEL_SYMBOL[k] in e.key) / ROOFLINE_REPS
    launched = {k: counts[k] for k in kernels}
    print(f"[roofline] {arch} x {shape}, {L} layers, B {B}: mesh vs plain "
          f"logits "
          f"max |err| {err:.3e} (bit-equal {bit}); launches {launched}; "
          f"ms mesh {times['mesh']}, plain {times['plain']}; kernels' "
          f"device us a step (mean of {ROOFLINE_REPS} traces) "
          f"{ {k: round(v, 2) for k, v in dev_us.items()} } [{smi}]")
    del args, plain_args, placed, combo
    gc.collect()
    torch.cuda.empty_cache()
    # the faster turn of each (a turn is a median of ROOFLINE_REPS calls;
    # a host stall in one turn is not the step's time)
    return {"mesh": min(times["mesh"]), "plain": min(times["plain"]),
            "dev_us": dev_us, "counts": launched}


def phase_roofline(torch):
    """(a) the dry-run sweep in a process of its own; (b) the four serve
    steps on a 1-rank mesh against the roofline's per-layer terms and the
    analytic bound (see the module docstring)."""
    import re
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import mesh as M
    from repro_torch.launch.roofline import analytic_per_layer
    from repro_torch.sharding import make_rules
    smi = smi_line()
    build = ROOT / "build"
    rc, out = _run_module(["repro_torch.launch.dryrun", "--all", "--jobs",
                           str(DRYRUN_JOBS), "--out", str(build / "dryrun")],
                          DRYRUN_LIMIT_S, build / "dryrun.log")
    m = re.search(r"(\d+)/(\d+) combinations traced OK in ([\d.]+) s"
                  r"(?:; slowest (\S+) × (\S+) ([\d.]+) s)?", out)
    check(m is not None, f"roofline: the dry run printed no summary (exit "
                         f"{rc}; log build/dryrun.log): {out[-1500:]}")
    n_ok, n = int(m.group(1)), int(m.group(2))
    print(f"[roofline] dry run --all, (data 16, model 16) over a fake group "
          f"of 256 ranks, torch {torch.__version__}: {n_ok} / {n} traced in "
          f"{m.group(3)} s ({DRYRUN_JOBS} processes); slowest {m.group(4)} x "
          f"{m.group(5)} {m.group(6)} s")
    failed = [ln for ln in out.splitlines() if ln.startswith("FAILED")]
    check(rc == 0 and n_ok == n == 40,
          f"roofline: {n_ok} / {n} combinations traced (exit {rc}): "
          f"{failed[:5]}")

    M.init_process_group("cuda")
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    rules = make_rules(mesh, "serve")
    runs = {}
    for arch, shape, kernels in ROOFLINE_PROBES:
        cfg = get_config(arch)
        base = len(cfg.hybrid.block_pattern) if cfg.hybrid else 1
        B = get_shape(shape).global_batch
        while True:       # the deeper probe first: it needs the most memory
            try:
                res = {L: _roofline_step(torch, arch, shape, L, B, mesh,
                                         rules, kernels, smi)
                       for L in (2 * base, base)}
                break
            except torch.cuda.OutOfMemoryError:
                pass
            # out of the handler, the failed probe's frames are gone
            gc.collect()
            torch.cuda.empty_cache()
            check(B >= 8, f"roofline: {arch} x {shape} does not fit at B {B}")
            print(f"[roofline] {arch} x {shape}: B {B} does not fit the card "
                  f"(out of memory): cut to B {B // 2}")
            B //= 2
        runs[(arch, shape)] = (B, base, res)
    _end_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # the roofline's terms of the same combinations, at the batch run
    rc, out = _run_module(
        ["repro_torch.launch.roofline", "--mesh", "1x1", "--out",
         str(build / "roofline_1x1")]
        + [f"--combo={a}:{s}:{runs[(a, s)][0]}"
           for a, s, _ in ROOFLINE_PROBES],
        ROOFLINE_LIMIT_S, build / "roofline_1x1.log")
    check(rc == 0, f"roofline: the (1, 1) probes exited {rc}: {out[-1500:]}")
    for arch, shape, kernels in ROOFLINE_PROBES:
        B, base, res = runs[(arch, shape)]
        with open(build / "roofline_1x1" / f"{arch}__{shape}__mesh1x1.json") \
                as f:
            terms = json.load(f)
        check(terms.get("batch", B) == B and terms["base"] == base,
              f"roofline: {arch} x {shape} terms at another batch or base")
        per = {w: (res[2 * base][w] - res[base][w]) / base
               for w in ("mesh", "plain")}
        t_flops = terms["flops_per_layer"] / M.PEAK_FLOPS * 1e3
        t_bytes = terms["bytes_per_layer"] / M.HBM_BW * 1e3
        largest = max(t_flops, t_bytes)
        ana = analytic_per_layer(arch, shape, 1, batch=B)
        a_ms = ana["bound_s"] * 1e3
        print(f"[roofline] {arch} x {shape} (B {B}) per layer: measured mesh "
              f"{per['mesh']:.4f} ms, plain {per['plain']:.4f} ms; roofline "
              f"terms (computed, H100 constants) compute {t_flops:.4f} ms, "
              f"memory {t_bytes:.4f} ms -> measured / largest "
              f"{per['mesh'] / largest:.3f}; analytic bound {a_ms:.4f} ms "
              f"({ana['bound_by']}: {ana['bytes'] / 1e9:.4f} GB, "
              f"{ana['flops'] / 1e12:.4f} TFLOP) -> measured / bound "
              f"{per['mesh'] / a_ms:.3f} (plain {per['plain'] / a_ms:.3f}) "
              f"[{smi}]")
        for k, us in res[base]["dev_us"].items():
            d_ms = (res[2 * base]["dev_us"][k] - us) / base / 1e3
            kt = terms["kernels_per_layer"].get(k)
            if kt is None:
                continue
            b_ms = max(kt["bytes"] / M.HBM_BW,
                       kt["flops"] / M.PEAK_FLOPS) * 1e3
            print(f"[roofline]   {k}: device {d_ms:.4f} ms per layer over "
                  f"{kt['count']:g} launches, bound {b_ms:.4f} ms "
                  f"({kt['bytes'] / 1e9:.4f} GB, {kt['flops'] / 1e12:.4f} "
                  f"TFLOP) -> {d_ms / b_ms if b_ms else float('nan'):.3f}x")
            check(d_ms >= 0 and d_ms >= BOUND_FLOOR * b_ms,
                  f"roofline: {arch} x {shape} kernel {k} reads {d_ms:.4f} "
                  f"ms per layer, under {BOUND_FLOOR} x its bound "
                  f"{b_ms:.4f} ms: the trace or the counts are wrong")
        for w in ("mesh", "plain"):
            check(per[w] >= BOUND_FLOOR * a_ms,
                  f"roofline: {arch} x {shape} {w} step {per[w]:.4f} ms per "
                  f"layer under {BOUND_FLOOR} x its analytic bound "
                  f"{a_ms:.4f} ms: the counts are wrong")


# ---------------------------------------------------------------------------
# the RuntimeFlags variants, through the Model API
# ---------------------------------------------------------------------------

# float32, TF32 off: the card (kernels) against the CPU (plain versions)
VARIANT_LOGIT_TOL = 1e-3
# the same once an int8 entry of the two caches is stored a level apart
# (the rows to quantize differ in their last bits; one entry moves the
# logits by about 1e-3); no entry may lie further apart
INT8_LOGIT_TOL = 2e-2
# one layer's attention over the int8 cache against the exact cache's:
# tests/test_perf_variants.py::test_int8_kv_cache_close_to_exact
INT8_ATTN_TOL = dict(rtol=0.1, atol=0.05)
LONG_POS = 524288             # the long_500k serve step's depth
RING_KERNELS = ("ragged_decode_attention", "fused_rmsnorm")
WINDOW_EXACT = {"llama3.2-1b": LLAMA_KERNELS, "minicpm3-4b": MLA_KERNELS}


def _to(tree, device):
    """A copy of a tree of tensors (dicts, lists, tuples) on ``device``."""
    from repro_torch.training.tree import map_tree
    return map_tree(lambda t: t.to(device), tree)


def _nbytes(tree) -> int:
    from repro_torch.training.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _variant_model(torch, arch, dtype, layers=None, **flags):
    """(config, model at ``flags``, seed-0 parameters on the card) of
    ``arch`` at full width, cut to ``layers`` layers when given."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RuntimeFlags
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Model(cfg, RuntimeFlags(dtype=dtype, **flags))
    return cfg, model, model.init(
        torch.Generator(device="cuda").manual_seed(0))


def _fill(torch, cache, seed: int):
    """Seeded N(0, 1) values in every leaf of a cache on the card."""
    from repro_torch.training.tree import leaves
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for leaf in leaves(cache):
        leaf.normal_(generator=gen)


def _int8_apart(torch, cache, cpu_cache, tag) -> int:
    """Entries of the int8 leaves that the card and the CPU stored a level
    apart; fails on any further apart."""
    from repro_torch.training.tree import flatten_with_paths
    n = 0
    for (path, a), (_, b) in zip(flatten_with_paths(cache),
                                 flatten_with_paths(cpu_cache)):
        if a.dtype == torch.int8:
            d = (a.cpu().to(torch.int16) - b.to(torch.int16)).abs()
            check(int(d.max()) <= 1, f"{tag}: int8 leaf {path} card vs CPU "
                                     f"{int(d.max())} levels apart")
            n += int(d.sum())
    return n


def _logits_close(lc, lr, tag, tol) -> float:
    err = (lc.float().cpu() - lr.float()).abs().max().item()
    check(err <= tol, f"{tag}: logits card vs CPU max |d| {err:.3e} above "
                      f"{tol}")
    return err


def _decode_card_vs_cpu(torch, tag, model, params, cpu_params, caches, tok,
                        pos, steps):
    """``steps`` decode steps from (card cache, CPU cache), on the card
    and on the CPU, the CPU's greedy tokens fed to both: logits within
    VARIANT_LOGIT_TOL each step (INT8_LOGIT_TOL once an int8 entry lies a
    level apart), the card's greedy token equal to the CPU's or a near-tie
    (the CPU's top-2 gap below 1e-3). Returns (worst |d logit|, near-ties,
    int8 entries a level apart at the end)."""
    cache, cpu_cache = caches
    worst, ties, apart = 0.0, 0, 0
    for step in range(steps):
        lc, _ = model.decode_step(params, cache, tok.cuda(), pos.cuda())
        lr, _ = model.decode_step(cpu_params, cpu_cache, tok, pos)
        apart = _int8_apart(torch, cache, cpu_cache, tag)
        worst = max(worst, _logits_close(
            lc, lr, f"{tag} step {step}",
            INT8_LOGIT_TOL if apart else VARIANT_LOGIT_TOL))
        nxt = lr.argmax(-1)
        for b in (lc.argmax(-1).cpu() != nxt).nonzero().flatten().tolist():
            top2 = torch.topk(lr[b].float(), 2).values
            gap = float(top2[0] - top2[1])
            check(gap < 1e-3, f"{tag}: step {step} row {b}: the card's "
                              f"greedy token differs, top-2 gap {gap:.3e} "
                              f"is no near-tie")
            ties += 1
        tok, pos = nxt, pos + 1
    return worst, ties, apart


def _variants_window(torch):
    """llama3.2-1b, full width and depth, bf16, ``window`` = its
    ``long_context_window``: ring caches of ``init_cache(4, 524288)``
    filled from a seed, then 32 greedy decode steps at ragged positions
    around 524288, rows 0 and 1 wrapping the ring."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    W = get_config("llama3.2-1b").long_context_window
    cfg, model, params = _variant_model(torch, "llama3.2-1b", torch.bfloat16,
                                        window=W)
    cache = model.init_cache(4, LONG_POS, device="cuda")
    T = cache[0]["k"].shape[2]
    check(T == W, f"variants window: ring of {T} rows, not {W}")
    _fill(torch, cache, 5)
    pos = torch.tensor([LONG_POS - 5, LONG_POS - 20, LONG_POS + 3,
                        LONG_POS - 100], dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    tok = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                        device="cuda")
    steps = 32
    wrapping = [b for b in range(4) if (int(pos[b]) // T
                                        != (int(pos[b]) + steps - 1) // T)]
    K.reset_launch_counts()
    with torch.no_grad():
        logits, _ = model.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            pos = pos + 1
            logits, _ = model.decode_step(params, cache, logits.argmax(-1),
                                          pos)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    counts = K.launch_counts()
    check(bool(torch.isfinite(logits.float()).all()),
          "variants window: logits not finite")
    check_launched(counts, "variants window", RING_KERNELS,
                   ("flash_attention",))
    print(f"[variants] window: {cfg.name} full width and depth, bf16, "
          f"window {W}: ring caches of {T} rows for batch 4 at max_len "
          f"{LONG_POS} ({_nbytes(cache) / 1e9:.3f} GB, seeded); {steps} "
          f"greedy decode steps from positions {LONG_POS - 5}, "
          f"{LONG_POS - 20}, {LONG_POS + 3}, {LONG_POS - 100} (rows "
          f"{wrapping} wrap the ring): {ms:.3f} ms per step after the "
          f"first; kernel launches {counts}")
    return counts


def _variants_window_exact(torch, arch, B=4, S=200, window=256, steps=100):
    """``arch`` at full width, 2 layers, f32 with TF32 off, ``window``
    256: prefill B 4 x S 200 through windowed flash, each prefill cache
    padded into a ring (rows below T are ring rows), then 100 greedy
    decode steps that wrap the ring; the card against the CPU."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"variants window exact ({arch})"
    cfg, model, params = _variant_model(torch, arch, torch.float32, layers=2,
                                        window=window)
    cpu_params = _to(params, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(8))
    K.reset_launch_counts()
    with torch.no_grad():
        lc, pc = model.prefill(params, tokens.cuda())
        lr, pr = model.prefill(cpu_params, tokens)
        err = _logits_close(lc, lr, f"{tag} prefill", VARIANT_LOGIT_TOL)
        rings = []
        for c, dev in ((pc, "cuda"), (pr, "cpu")):
            ring = model.init_cache(B, S + steps, device=dev)
            for k, leaf in ring[0].items():
                leaf[:, :, :S] = c[0][k]
            rings.append(ring)
        T = next(iter(rings[0][0].values())).shape[2]
        check(T == window and S < T < S + steps,
              f"{tag}: a ring of {T} rows does not wrap")
        worst, ties, _ = _decode_card_vs_cpu(
            torch, tag, model, params, cpu_params, rings, lr.argmax(-1),
            torch.full((B,), S, dtype=torch.int32), steps)
    counts = K.launch_counts()
    mla = cfg.attention == "mla"
    check_launched(counts, tag, WINDOW_EXACT[arch], MLA_ABSENT if mla else ())
    print(f"[variants] window exact: {cfg.name} full width, 2 of "
          f"{get_config(arch).num_layers} layers, f32, TF32 off, window "
          f"{window}: "
          f"prefill {B} x {S} max |d logit| card vs CPU {err:.3e}; "
          f"{steps} decode steps over a ring of {T} rows (positions {S}.."
          f"{S + steps - 1}) max |d logit| {worst:.3e} (tolerance "
          f"{VARIANT_LOGIT_TOL}), {ties} near-ties; kernel launches on the "
          f"card {counts}")
    return counts


def _prefill_into(torch, model, params, prompts, rows_each, caches, seed,
                  device):
    """Prefill ``rows_each`` rows of seeded tokens per prompt length on
    ``device`` into rows of each cache of ``caches`` (an int8 cache takes
    ``_quantize_rows`` of the rows): the first greedy tokens (B,) and the
    positions (B,) int32."""
    from repro_torch.models.layers import _quantize_rows
    gen = torch.Generator().manual_seed(seed)
    first, pos = [], []
    for i, S in enumerate(prompts):
        rows = slice(i * rows_each, (i + 1) * rows_each)
        toks = torch.randint(0, model.cfg.vocab_size, (rows_each, S),
                             generator=gen).to(device)
        logits, (pc, _) = model.prefill(params, toks)
        first.append(logits.argmax(-1))
        pos += [S] * rows_each
        for cache in caches:
            for name in ("k", "v"):
                if "k_scale" in cache[0]:
                    q, scale = _quantize_rows(pc[name])
                    cache[0][name][:, rows, :S] = q
                    cache[0][f"{name}_scale"][:, rows, :S] = scale
                else:
                    cache[0][name][:, rows, :S] = pc[name]
    return torch.cat(first), torch.tensor(pos, dtype=torch.int32,
                                          device=device)


def _greedy(torch, model, params, cache, tok, pos, steps):
    """(tokens (B, steps), logits (B, steps, V), ms per step) of
    ``steps`` greedy decode steps."""
    toks, logs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, _ = model.decode_step(params, cache, tok, pos)
        tok, pos = logits.argmax(-1), pos + 1
        toks.append(tok)
        logs.append(logits)
    torch.cuda.synchronize()
    return (torch.stack(toks, 1), torch.stack(logs, 1),
            (time.perf_counter() - t0) * 1e3 / steps)


def _variants_int8(torch):
    """llama3.2-1b, full width and depth, bf16: prefill 8 rows over
    prompts {64, 128, 256, 384} into an exact cache and into an int8 one
    (``kv_quant``, ``init_cache(8, 1024)``), one layer's attention over
    each, then 64 greedy decode steps from each. Then 2 layers in f32,
    TF32 off: the int8 path on the card against the CPU."""
    import repro_torch.kernels as K
    from repro_torch.models import Model, RuntimeFlags
    from repro_torch.models import layers as L
    bf16 = torch.bfloat16
    cfg, exact_m, params = _variant_model(torch, "llama3.2-1b", bf16)
    quant_m = Model(cfg, RuntimeFlags(dtype=bf16, kv_quant=True))
    exact = exact_m.init_cache(8, 1024, device="cuda")
    quant = quant_m.init_cache(8, 1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    steps = 64
    K.reset_launch_counts()
    with torch.no_grad():
        first, pos = _prefill_into(torch, exact_m, params, (64, 128, 256, 384),
                                   2, (exact, quant), 9, "cuda")
        attn = exact_m.layer_params(params)[0]["attn"]
        x = torch.randn((8, cfg.d_model), generator=gen,
                        device="cuda").to(bf16)
        ye, _ = L.apply_attention_decode(
            attn, x, {k: v[0].clone() for k, v in exact[0].items()}, pos, cfg)
        yq, _ = L.apply_attention_decode(
            attn, x, {k: v[0].clone() for k, v in quant[0].items()}, pos, cfg)
        attn_err = (yq.float() - ye.float()).abs().max().item()
        check(bool(torch.allclose(yq.float(), ye.float(), **INT8_ATTN_TOL)),
              f"variants int8 kv: layer 0's attention over the int8 cache "
              f"is not within {INT8_ATTN_TOL} of the exact cache's (max "
              f"|d| {attn_err:.3e})")
        te, le, ms_e = _greedy(torch, exact_m, params, exact, first, pos,
                               steps)
        tq, lq, ms_q = _greedy(torch, quant_m, params, quant, first, pos,
                               steps)
    counts = K.launch_counts()
    check_launched(counts, "variants int8 kv", LLAMA_KERNELS)
    same = (tq == te)
    # a step's logits compare while the row's tokens so far agree
    agree = torch.cat([torch.ones_like(same[:, :1]),
                       same[:, :-1].int().cumprod(1).bool()], 1)
    d = (lq.float() - le.float()).abs().amax(-1)
    print(f"[variants] int8 kv: {cfg.name} full width and depth, bf16, "
          f"prompts 64/128/256/384 x 2 rows, init_cache(8, 1024): cache "
          f"bytes int8 + scales {_nbytes(quant)} vs bf16 {_nbytes(exact)} "
          f"({_nbytes(quant) / _nbytes(exact):.4f}); layer 0's attention "
          f"max |d| {attn_err:.3e} (within {INT8_ATTN_TOL}); {steps} greedy "
          f"steps: ms per step int8 {ms_q:.3f} vs bf16 {ms_e:.3f}; greedy "
          f"tokens equal {same.float().mean().item():.4f}; max |d logit| "
          f"{d[:, 0].max().item():.4f} at the first step, "
          f"{d[agree].max().item():.4f} while the tokens agree; kernel "
          f"launches {counts}")
    del exact, quant, te, le, tq, lq, params
    torch.cuda.empty_cache()
    # float32, 2 layers: the card against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = "variants int8 kv exact"
    cfg2, qm, p2 = _variant_model(torch, "llama3.2-1b", torch.float32,
                                  layers=2, kv_quant=True)
    plain = Model(cfg2, RuntimeFlags(dtype=torch.float32))
    cpu_p = _to(p2, "cpu")
    K.reset_launch_counts()
    with torch.no_grad():
        caches = []
        for params_, dev in ((p2, "cuda"), (cpu_p, "cpu")):
            cache = qm.init_cache(8, 1024, device=dev)
            first, pos = _prefill_into(torch, plain, params_, (64, 128),
                                       4, (cache,), 10, dev)
            caches.append(cache)
        prefill_apart = _int8_apart(torch, caches[0], caches[1], tag)
        worst, ties, apart = _decode_card_vs_cpu(
            torch, tag, qm, p2, cpu_p, caches, first.cpu(), pos.cpu(), 16)
    counts2 = K.launch_counts()
    n_int8 = sum(t.numel() for t in (caches[0][0]["k"], caches[0][0]["v"]))
    print(f"[variants] int8 kv exact: {cfg2.name} full width, 2 layers, "
          f"f32, TF32 off, prompts 64/128 x 4 rows, 16 decode steps: int8 "
          f"entries a level apart card vs CPU {prefill_apart} after the "
          f"prefill, {apart} after the steps (of {n_int8}; none further); "
          f"max |d logit| {worst:.3e} (tolerance {VARIANT_LOGIT_TOL}, "
          f"{INT8_LOGIT_TOL} once an entry is a level apart), {ties} "
          f"near-ties; kernel launches on the card {counts2}")
    return {k: counts[k] + counts2[k] for k in counts}


def _variants_absorbed(torch):
    """minicpm3-4b, full width and depth, bf16: prefill 4 x 512 with and
    without ``mla_absorbed`` (in turns), flash absent on the absorbed path.
    Then 2 layers in f32, TF32 off: the absorbed prefill on the card
    against the CPU, without a window and with 256."""
    import repro_torch.kernels as K
    from repro_torch.models import Model, RuntimeFlags
    bf16 = torch.bfloat16
    cfg, plain_m, params = _variant_model(torch, "minicpm3-4b", bf16)
    abs_m = Model(cfg, RuntimeFlags(dtype=bf16, mla_absorbed=True))
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(11))
    times = {"plain": [], "absorbed": []}
    logits, counts = {}, {}
    with torch.no_grad():
        for m, name in ((plain_m, "plain"), (abs_m, "absorbed")):
            m.prefill(params, tokens)                   # warm
        for m, name in ((plain_m, "plain"), (abs_m, "absorbed"),
                        (abs_m, "absorbed"), (plain_m, "plain")):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[name], _ = m.prefill(params, tokens)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            counts[name] = K.launch_counts()
    check_launched(counts["absorbed"], "variants mla absorbed",
                   ("fused_rmsnorm",), ("flash_attention",))
    check_launched(counts["plain"], "variants mla (flash)", MLA_KERNELS)
    diff = (logits["absorbed"].float() - logits["plain"].float()).abs()
    check(bool(torch.isfinite(logits["absorbed"].float()).all()),
          "variants mla absorbed: logits not finite")
    print(f"[variants] mla absorbed: {cfg.name} full width and depth, bf16, "
          f"prefill 4 x 512: absorbed {statistics.mean(times['absorbed']):.2f}"
          f" ms vs flash {statistics.mean(times['plain']):.2f} ms (host "
          f"clock, synchronized, in turns flash, absorbed, absorbed, flash: "
          f"{[round(t, 2) for t in times['plain']]} / "
          f"{[round(t, 2) for t in times['absorbed']]}); last-token logits "
          f"max |d| {diff.max().item():.4f}; kernel launches absorbed "
          f"{counts['absorbed']}, flash path {counts['plain']}")
    del params, logits
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2, _, p2 = _variant_model(torch, "minicpm3-4b", torch.float32,
                                 layers=2)
    cpu_p = _to(p2, "cpu")
    tokens = torch.randint(0, cfg2.vocab_size, (2, 512),
                           generator=torch.Generator().manual_seed(12))
    all_counts = dict(counts["absorbed"])
    for window in (None, 256):
        tag = f"variants mla absorbed exact (window {window})"
        m = Model(cfg2, RuntimeFlags(dtype=torch.float32, mla_absorbed=True,
                                     window=window))
        K.reset_launch_counts()
        with torch.no_grad():
            lc, (cc, _) = m.prefill(p2, tokens.cuda())
            lr, (cr, _) = m.prefill(cpu_p, tokens)
        wc = K.launch_counts()
        check_launched(wc, tag, ("fused_rmsnorm",), ("flash_attention",))
        err = _logits_close(lc, lr, tag, VARIANT_LOGIT_TOL)
        cerr = max((cc[k].cpu() - cr[k]).abs().max().item() for k in cc)
        check(cerr <= VARIANT_LOGIT_TOL, f"{tag}: latent cache card vs CPU "
                                         f"max |d| {cerr:.3e}")
        all_counts = {k: all_counts[k] + wc[k] for k in all_counts}
        print(f"[variants] mla absorbed exact: {cfg2.name} full width, 2 "
              f"layers, f32, TF32 off, prefill 2 x 512, window {window}: "
              f"max |d logit| card vs CPU {err:.3e}, latent cache {cerr:.3e} "
              f"(tolerance {VARIANT_LOGIT_TOL}); kernel launches on the card "
              f"{wc}")
    return all_counts


class _MoEDrops:
    """Counts the (token, expert) pairs that ``apply_moe`` drops at
    capacity while the ``with`` block runs, from its routing recomputed
    on its inputs (the port's own ``apply_moe`` stays free of host
    syncs)."""

    def __enter__(self):
        import torch
        import repro_torch.models.moe as MOE
        self.mod, self.orig = MOE, MOE.apply_moe
        self.dropped = self.pairs = 0

        def counted(p, x, cfg, *, with_aux=False, group_rows=1):
            B, S, d = x.shape
            g = max(1, min(group_rows, B))
            xg = x.reshape(B // g, g * S, d)
            probs = torch.softmax(xg.float() @ p["router"], dim=-1)
            top_e = torch.topk(probs, cfg.moe.experts_per_token,
                               dim=-1).indices
            keep = MOE._dispatch_indices(top_e.reshape(B // g, -1),
                                         MOE.capacity(cfg, g * S))[3]
            self.dropped += int((~keep).sum())
            self.pairs += keep.numel()
            return self.orig(p, x, cfg, with_aux=with_aux,
                             group_rows=group_rows)

        MOE.apply_moe = counted
        return self

    def __exit__(self, *exc):
        self.mod.apply_moe = self.orig
        return False


def _variants_moe(torch):
    """granite-moe-3b-a800m at full width. 2 of 32 layers in f32, TF32
    off, the card against the CPU: a decode step at B 8 in routing groups
    of 4 rows (capacity 1: pairs drop) over a seeded cache, and prefill 4
    x 64 in groups of 2. Then full depth in bf16: one decode step at B 8
    in groups of 4, timed."""
    import repro_torch.kernels as K
    from repro_torch.models import Model, RuntimeFlags
    from repro_torch.models.moe import capacity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = "variants moe groups"
    cfg, m4, p2 = _variant_model(torch, "granite-moe-3b-a800m", torch.float32,
                                 layers=2, moe_group_rows=4)
    m2 = Model(cfg, RuntimeFlags(dtype=torch.float32, moe_group_rows=2))
    cpu_p = _to(p2, "cpu")
    cache = m4.init_cache(8, 128, device="cuda")
    _fill(torch, cache, 13)
    cpu_cache = _to(cache, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (8,),
                        generator=torch.Generator().manual_seed(14))
    pos = torch.tensor([3, 17, 40, 63, 64, 90, 100, 127], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64),
                           generator=torch.Generator().manual_seed(15))
    K.reset_launch_counts()
    with torch.no_grad():
        with _MoEDrops() as dec_drops:
            lc, _ = m4.decode_step(p2, cache, tok.cuda(), pos.cuda())
        lr, _ = m4.decode_step(cpu_p, cpu_cache, tok, pos)
        derr = _logits_close(lc, lr, f"{tag} decode", VARIANT_LOGIT_TOL)
        with _MoEDrops() as pre_drops:
            pc, _ = m2.prefill(p2, tokens.cuda())
        pr, _ = m2.prefill(cpu_p, tokens)
        perr = _logits_close(pc, pr, f"{tag} prefill", VARIANT_LOGIT_TOL)
    counts = K.launch_counts()
    check_launched(counts, tag, LLAMA_KERNELS)
    check(dec_drops.dropped > 0, f"{tag}: no pair dropped at capacity "
                                 f"{capacity(cfg, 4)} in the decode step")
    print(f"[variants] moe groups: {cfg.name} full width, 2 of 32 layers, "
          f"f32, TF32 off: decode_step B 8 in groups of 4 rows (capacity "
          f"{capacity(cfg, 4)}): {dec_drops.dropped} of {dec_drops.pairs} "
          f"(token, expert) pairs dropped, max |d logit| card vs CPU "
          f"{derr:.3e}; prefill 4 x 64 in groups of 2 rows (capacity "
          f"{capacity(cfg, 128)}): {pre_drops.dropped} of {pre_drops.pairs} "
          f"dropped, max |d logit| {perr:.3e} (tolerance "
          f"{VARIANT_LOGIT_TOL}); kernel launches on the card {counts}")
    del p2, cache
    torch.cuda.empty_cache()
    cfg, model, params = _variant_model(torch, "granite-moe-3b-a800m",
                                        torch.bfloat16, moe_group_rows=4)
    cache = model.init_cache(8, 256, device="cuda")
    _fill(torch, cache, 16)
    tok, pos = tok.cuda(), pos.cuda()
    K.reset_launch_counts()
    with torch.no_grad():
        model.decode_step(params, cache, tok, pos)        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.decode_step(params, cache, tok, pos + 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    full = K.launch_counts()
    check(bool(torch.isfinite(logits.float()).all()),
          f"{tag}: full-depth logits not finite")
    check_launched(full, f"{tag} (full depth)", RING_KERNELS,
                   ("flash_attention",))
    print(f"[variants] moe groups: {cfg.name} full width and depth, bf16: "
          f"one decode_step at B 8 in groups of 4 rows {ms:.3f} ms (after "
          f"one warm step); kernel launches {full}")
    return {k: counts[k] + full[k] for k in counts}


def phase_variants(torch):
    """The port's ``RuntimeFlags`` variants through the ``Model`` API at
    full width: ``window`` (ring caches; windowed flash at D 64 and at
    MLA's 96 / 64; the MLA ring decode), ``kv_quant``, ``mla_absorbed``
    and ``moe_group_rows``; every float32 part against the port on the
    CPU (plain versions)."""
    parts = [_variants_window(torch)]
    parts += [_variants_window_exact(torch, arch) for arch in WINDOW_EXACT]
    parts += [_variants_int8(torch), _variants_absorbed(torch),
              _variants_moe(torch)]
    total = {k: sum(c[k] for c in parts) for k in parts[0]}
    print(f"[variants] kernel launches in this phase (card runs only): "
          f"{total}")
    return total


# the legacy phase's full-width llama, as benchmarks/engine_decode_bench.py
# runs its modes: batch 8, max_len 256, prompts of 16, 24 decode cycles
LEGACY_MODES = ("legacy", "arena", "fused")
LEGACY_BATCH, LEGACY_MAX_LEN, LEGACY_PROMPT, LEGACY_TOKENS = 8, 256, 16, 24
# the other families at full width, depth cut to layers that keep every
# block kind: (arch, layers, kernels that must launch, that must not)
LEGACY_FAMILIES = (
    ("mamba2-2.7b", 2, ("ssd_chunked", "fused_rmsnorm"), ()),
    ("minicpm3-4b", 2, MLA_KERNELS, MLA_ABSENT),
    ("granite-moe-3b-a800m", 2, LLAMA_KERNELS, ()),
    # one (rec, rec, attn) group and a rec layer of the tail
    ("recurrentgemma-9b", 4, LLAMA_KERNELS, ()),
)
LEGACY_PROMPTS = (64, 128, 256, 384)


def _legacy_batch(engine, wl, cfg, seed=0):
    """``LEGACY_BATCH`` requests of ``LEGACY_PROMPT`` seeded tokens and
    ``LEGACY_TOKENS`` decode cycles: the bench's ``_build_batch``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(LEGACY_BATCH):
        r = wl.sample_request(rng, 0.0)
        r.sequence, r.prefix_len, r.cycle_len = wl.build_sequence(
            LEGACY_PROMPT, LEGACY_TOKENS)
        r.prompt_len, r.decode_len = LEGACY_PROMPT, LEGACY_TOKENS
        engine.register(r, rng.integers(2, cfg.vocab_size,
                                        size=LEGACY_PROMPT))
        reqs.append(r)
    return reqs


def _legacy_drive(engine, wl, reqs, mode):
    """The bench's ``_drive``: each request prefills alone (one committed
    run in ``fused`` mode, node by node otherwise), then the batch decodes
    ``LEGACY_TOKENS`` merged cycles; wall seconds per cycle. Every dispatch
    ends in a host sync (per node, or at the run boundary), so a cycle's
    wall time covers its work on the card."""
    from repro_torch.core.request import SubBatch
    for r in reqs:
        sb = SubBatch([r])
        if mode == "fused":
            run = sb.run_nodes(stop_before={"D0"})
            engine.execute_run("m", sb, run)
            sb.advance_n(len(run), 0.0)
        else:
            for _ in range(1 + len(engine.kinds)):
                engine.execute("m", sb, r.next_node_id)
                sb.advance(0.0)
    sb = SubBatch(list(reqs))
    per_token = []
    for _ in range(LEGACY_TOKENS):
        t0 = time.perf_counter()
        if mode == "fused":
            run = sb.run_nodes(stop_after={"head"})
            engine.execute_run("m", sb, run)
            sb.advance_n(len(run), 0.0)
        else:
            for _ in range(len(wl.cycle_ids())):
                engine.execute("m", sb, sb.node_id)
                sb.advance(0.0)
        per_token.append(time.perf_counter() - t0)
    return per_token


def _legacy_modes(torch, dtype):
    """Full-width llama3.2-1b in the three modes on one set of seed-0
    weights: per mode a warmup pass over an identical batch, then a fresh
    same-seed batch timed on the same engine. Returns per mode its tokens,
    ms per token (median, mean, min), launches, new shape keys, host
    syncs, runs and nodes of the timed pass, and the bytes of one
    request's caches."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.serving import LengthDist, TorchEngine, from_model_config
    cfg = get_config("llama3.2-1b")
    wl = from_model_config(cfg, prompt_dist=LengthDist((LEGACY_PROMPT,), (1.0,)),
                           decode_dist=LengthDist((4,), (1.0,)))
    params, out = None, {}
    for mode in LEGACY_MODES:
        engine = TorchEngine(
            cfg, max_len=LEGACY_MAX_LEN, dtype=dtype, seed=0,
            n_slots=LEGACY_BATCH, params=params, fused=mode == "fused",
            cache_mode="legacy" if mode == "legacy" else "arena")
        params = engine.params
        _legacy_drive(engine, wl, _legacy_batch(engine, wl, cfg), mode)
        s0, keys0, nodes0 = (engine.sanitizer_stats(), engine.shape_keys(),
                             engine.nodes_executed)
        reqs = _legacy_batch(engine, wl, cfg)
        K.reset_launch_counts()
        secs = _legacy_drive(engine, wl, reqs, mode)
        counts = K.launch_counts()
        s1 = engine.sanitizer_stats()
        caches = engine.states[reqs[0].rid].caches
        out[mode] = {
            "tokens": [list(engine.states[r.rid].generated) for r in reqs],
            "ms": [statistics.median(secs) * 1e3,
                   statistics.mean(secs) * 1e3, min(secs) * 1e3],
            "counts": counts,
            "new_keys": sorted(engine.shape_keys() - keys0, key=str),
            "syncs": s1.host_syncs - s0.host_syncs,
            "runs": s1.runs - s0.runs,
            "nodes": engine.nodes_executed - nodes0,
            "cache_bytes": sum(_nbytes(c) for c in caches.values()),
            "resident": engine.memory_stats().bytes_resident}
        if mode == "legacy":
            check_launched(counts, f"legacy {dtype_name(dtype)} (legacy "
                                   f"mode, timed pass)", LLAMA_KERNELS)
        check(not out[mode]["new_keys"],
              f"legacy: {mode} {dtype_name(dtype)}: new shape keys in the "
              f"timed pass after the warmup: {out[mode]['new_keys']}")
        del engine, reqs, caches
        gc.collect()
    del params
    torch.cuda.empty_cache()
    return out


def _legacy_family(torch, arch, layers, kernels, absent):
    """``arch`` at full width cut to ``layers`` layers, float32 with TF32
    off: prompts ``LEGACY_PROMPTS`` x 16 tokens served through
    ServingSession + LazyBatching in arena mode (fused runs), then in
    legacy mode on the same weights; tokens equal or a printed near-tie
    (the arena's top-2 logit gap below 1e-3). Returns the legacy serve's
    launches."""
    import dataclasses
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.serving import HandleState, TorchEngine
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    fixed = [(p, 16) for p in LEGACY_PROMPTS]
    params, toks, prompts, counts = None, {}, {}, {}
    for mode in ("arena", "legacy"):
        engine = TorchEngine(cfg, max_len=512, dtype=torch.float32, seed=0,
                             cache_mode=mode, params=params)
        params = engine.params
        K.reset_launch_counts()
        _, _, handles, _, _, _ = _serve(
            torch, engine, cfg, n=len(fixed), seed=7, rate=0.0,
            prompts=LEGACY_PROMPTS, decodes=(16,), max_batch=4, sla=10.0,
            fixed=fixed)
        counts[mode] = K.launch_counts()
        check(all(h.state is HandleState.DONE for h in handles),
              f"legacy {arch}: {mode}: not every request finished")
        toks[mode] = [engine.states[h.request.rid].generated[:16]
                      for h in handles]
        prompts[mode] = [engine.states[h.request.rid].prompt_np
                         for h in handles]
        model = engine.model
        del engine, handles
        gc.collect()
    check_launched(counts["legacy"], f"legacy {arch} (legacy mode)", kernels,
                   absent)
    check(all((a == b).all() for a, b in zip(*prompts.values())),
          f"legacy {arch}: the two serves drew different prompts")
    n_equal, ties = 0, []
    for i, (got, ref) in enumerate(zip(toks["legacy"], toks["arena"])):
        if got == ref:
            n_equal += 1
            continue
        j, gap = near_tie(torch, model, params, prompts["arena"][i], got,
                          ref, f"legacy {arch}: request {i} (legacy vs arena)")
        ties.append(f"request {i} token {j} gap {gap:.3e}")
    kinds = model.layer_kinds()
    print(f"[legacy] {arch}: full width, {layers} of "
          f"{get_config(arch).num_layers} layers ({', '.join(kinds)}; the "
          f"depth is the only cut), f32, TF32 off, max_len 512: prompts "
          f"{list(LEGACY_PROMPTS)} x 16 tokens through ServingSession + "
          f"LazyBatching(max_batch=4): legacy tokens equal the arena's "
          f"(fused runs) for {n_equal}/{len(fixed)} requests, near-ties: "
          f"{ties or 'none'}; kernel launches legacy {counts['legacy']}, "
          f"arena {counts['arena']}")
    del params, model
    torch.cuda.empty_cache()
    return counts["legacy"]


def phase_legacy(torch):
    """``TorchEngine(cache_mode="legacy")`` beside the arena, node by node
    and fused: full-width llama3.2-1b in float32 (tokens equal across the
    three modes) and bfloat16 (times); then the other four families
    legacy vs arena in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exact = _legacy_modes(torch, torch.float32)
    n_tok = LEGACY_BATCH * LEGACY_TOKENS
    check(exact["legacy"]["tokens"] == exact["arena"]["tokens"]
          == exact["fused"]["tokens"],
          "legacy: f32 tokens differ across legacy / arena / fused")
    print(f"[legacy] llama3.2-1b full width and depth, batch "
          f"{LEGACY_BATCH}, max_len {LEGACY_MAX_LEN}, prompt {LEGACY_PROMPT},"
          f" {LEGACY_TOKENS} merged decode cycles after a warmup pass over "
          f"an identical batch: f32, TF32 off: the {n_tok} generated tokens "
          f"are equal across legacy / arena / fused")
    timed = _legacy_modes(torch, torch.bfloat16)
    ms = {m: timed[m]["ms"][0] for m in LEGACY_MODES}
    agree = {m: sum(a == b for ra, rb in zip(timed[m]["tokens"],
                                             timed["legacy"]["tokens"])
                    for a, b in zip(ra, rb)) for m in ("arena", "fused")}
    print(f"[legacy] bf16 ms per token, median (mean, min) over "
          f"{LEGACY_TOKENS} cycles of the timed pass, host clock: " +
          ", ".join(f"{m} {timed[m]['ms'][0]:.3f} ({timed[m]['ms'][1]:.3f}, "
                    f"{timed[m]['ms'][2]:.3f})" for m in LEGACY_MODES) +
          f" | arena vs legacy {ms['legacy'] / ms['arena']:.2f}x, fused vs "
          f"arena {ms['arena'] / ms['fused']:.2f}x | tokens equal to "
          f"legacy's: arena {agree['arena']}/{n_tok}, fused "
          f"{agree['fused']}/{n_tok} | {smi_line()}")
    for m in LEGACY_MODES:
        t = timed[m]
        print(f"[legacy] bf16 {m} timed pass: {t['nodes']} nodes, "
              f"{t['runs']} fused runs, {t['syncs']} host syncs "
              f"({t['syncs'] / LEGACY_TOKENS:.1f} per token), new shape keys "
              f"{t['new_keys']}; memory_stats bytes_resident {t['resident']};"
              f" kernel launches {t['counts']}")
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b")
    print(f"[legacy] one request's legacy caches: "
          f"{timed['legacy']['cache_bytes']} bytes in bf16, "
          f"{exact['legacy']['cache_bytes']} in f32 ({cfg.num_layers} layers "
          f"x K and V of {LEGACY_MAX_LEN} rows x {cfg.num_kv_heads} kv heads "
          f"x {cfg.head_dim})")
    total = {k: exact["legacy"]["counts"][k] + timed["legacy"]["counts"][k]
             for k in exact["legacy"]["counts"]}
    for arch, layers, kernels, absent in LEGACY_FAMILIES:
        counts = _legacy_family(torch, arch, layers, kernels, absent)
        total = {k: total[k] + counts[k] for k in total}
    print(f"[legacy] kernel launches in this phase's legacy-mode runs (timed "
          f"passes and serves): {total}")
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the GPU only",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = smi_line()
    print(f"[env] {smi}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    run(phase_build)
    rows = run(phase_kernels, torch)
    # each serving path's own launches: llama's for its three kernels,
    # mamba's for the SSD scan
    counts = run(phase_serve, torch, "llama3.2-1b", "serve", DENSE_KERNELS,
                 (64, 128, 256, 384))
    e_counts = run(phase_exact, torch, "llama3.2-1b", "exact",
                   DENSE_EXACT_KERNELS, (64, 128, 256, 384), EXACT_ABSENT)
    m_counts = run(phase_serve, torch, "mamba2-2.7b", "mamba serve",
                   MAMBA_KERNELS, (128, 257, 259, 384), MAMBA_ABSENT)
    x_counts = run(phase_exact, torch, "mamba2-2.7b", "mamba exact",
                   MAMBA_EXACT_KERNELS, (34, 97, 257, 385))
    # mistral-nemo-12b: head_dim 128, 4 q heads per kv head, an untied head
    n_counts = run(phase_serve, torch, "mistral-nemo-12b", "nemo serve",
                   DENSE_KERNELS, (64, 128, 256, 384))
    nx_counts = run(phase_exact, torch, "mistral-nemo-12b", "nemo exact",
                    DENSE_EXACT_KERNELS, (64, 128, 256, 384), EXACT_ABSENT)
    # minicpm3-4b: MLA, flash at q/k 96 and v 64, no ragged decode
    c_counts = run(phase_serve, torch, "minicpm3-4b", "minicpm serve",
                   MLA_KERNELS, (64, 128, 256, 384), MLA_ABSENT)
    cx_counts = run(phase_exact, torch, "minicpm3-4b", "minicpm exact",
                    MLA_KERNELS, (64, 128, 256, 384), MLA_ABSENT)
    # granite-moe-3b-a800m: 40 experts top 8 over GQA at G 3
    g_counts = run(phase_serve, torch, "granite-moe-3b-a800m",
                   "granite serve", DENSE_KERNELS, (64, 128, 256, 384))
    gx_counts = run(phase_exact, torch, "granite-moe-3b-a800m",
                    "granite exact", DENSE_EXACT_KERNELS, (64, 128, 256, 384),
                    EXACT_ABSENT)
    # recurrentgemma-9b: RG-LRU blocks beside local attention at D 256
    r_counts = run(phase_serve, torch, "recurrentgemma-9b", "rgemma serve",
                   RGEMMA_KERNELS, (64, 128, 256, 384))
    rx_counts = run(phase_exact, torch, "recurrentgemma-9b", "rgemma exact",
                    LLAMA_KERNELS, (64, 128, 256, 384), RGEMMA_EXACT_ABSENT)
    # the RuntimeFlags variants through the Model API; their launches stay
    # on the phase's own line
    run(phase_variants, torch)
    # the legacy cache mode beside the arena, node by node and fused; its
    # launches stay on the phase's own line
    run(phase_legacy, torch)
    # the port's entry points: the launcher (faults, then two tenants) and
    # the HTTP/SSE gateway
    run(phase_launch_serve, torch)
    run(phase_launch_tenants, torch)
    run(phase_gateway, torch)
    # training: the launcher on llama (f32), its gradients against the
    # CPU's, and mamba's forward through the SSD scan
    t_counts = run(phase_train, torch)
    run(phase_train_exact, torch)
    tm_counts = run(phase_train_mamba, torch)
    # the launcher's mesh path against the unsharded one; remat
    run(phase_sharding, torch)
    # the dry-run sweep under this torch; serve steps on a 1-rank mesh
    # against the roofline
    run(phase_roofline, torch)
    PHASE[0] = "result"
    print(f"[done] build, kernels, serve, exact, mamba serve, mamba exact, "
          f"nemo serve, nemo exact, minicpm serve, minicpm exact, granite "
          f"serve, granite exact, rgemma serve, rgemma exact, variants, "
          f"legacy, launch serve, "
          f"launch tenants, gateway, train, train exact, train mamba, "
          f"sharding, roofline in "
          f"{time.perf_counter() - t_all:.1f} s")
    counts["ssd_chunked"] = m_counts["ssd_chunked"]
    # the tensor-core scan: its launches in mamba serve (chunks 1 and 2)
    counts["ssd_chunked_tc_scan"] = m_counts["ssd_chunked_tc_scan"]
    # the split-TF32 route: its launches in mamba exact, batched and isolated
    counts["ssd_chunked_tf32"] = x_counts["ssd_chunked_tf32"]
    # the D 128 rows: bf16 launches in nemo serve, f32 in nemo exact
    for name in ("ragged_decode_attention", "flash_attention"):
        counts[f"{name}_d128"] = n_counts[name]
        counts[f"{name}_f32_d128"] = nx_counts[name]
    # MLA flash: bf16 launches in minicpm serve, f32 in minicpm exact; the
    # G 3 decode row: launches in granite serve
    counts["flash_attention_mla"] = c_counts["flash_attention"]
    counts["flash_attention_f32_mla"] = cx_counts["flash_attention"]
    counts["ragged_decode_attention_g3"] = g_counts[
        "ragged_decode_attention_n8"]
    # the D 256 rows: bf16 launches in rgemma serve, f32 in rgemma exact;
    # RMSNorm at 4096: launches in rgemma serve
    for name in ("ragged_decode_attention", "flash_attention"):
        counts[f"{name}_d256"] = r_counts[name]
        counts[f"{name}_f32_d256"] = rx_counts[name]
    # bf16 decode at D 256 runs the tensor-core kernel, at G <= 8 (llama's
    # row, nemo's D 128, granite's G 3) the n8 kernel
    counts["ragged_decode_attention_d256"] = r_counts[
        "ragged_decode_attention_tc"]
    counts["ragged_decode_attention"] = counts["ragged_decode_attention_n8"]
    counts["ragged_decode_attention_d128"] = n_counts[
        "ragged_decode_attention_n8"]
    # float32 decode at G <= 8 runs the split-TF32 n8 kernel: its launches
    # in exact (llama's row), nemo exact (D 128) and granite exact (G 3),
    # batched and isolated
    counts["ragged_decode_attention_f32"] = e_counts[
        "ragged_decode_attention_n8_tf32"]
    counts["ragged_decode_attention_f32_d128"] = nx_counts[
        "ragged_decode_attention_n8_tf32"]
    counts["ragged_decode_attention_f32_g3"] = gx_counts[
        "ragged_decode_attention_n8_tf32"]
    counts["fused_rmsnorm_4096"] = r_counts["fused_rmsnorm"]
    # the training rows: f32 flash and RMSNorm launches in train, the
    # split-TF32 SSD route's in train mamba
    counts["flash_attention_f32_train"] = t_counts["flash_attention"]
    counts["fused_rmsnorm_f32_train"] = t_counts["fused_rmsnorm"]
    counts["ssd_chunked_tf32_train"] = tm_counts["ssd_chunked_tf32"]
    for name, row in rows.items():
        row["launches"] = counts[name]
    print(smi)
    print(json.dumps({"kernels": [rows[n] for n in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(phase, *args):
    """``phase(*args)``, named for a failure; then how many of its profiler
    sessions came back empty or incomplete."""
    PHASE[0] = (args[2] if phase in (phase_serve, phase_exact)
                else phase.__name__.replace("phase_", "").replace("_", " "))
    t0 = time.perf_counter()
    out = phase(*args)
    # a serving phase's engine sits in reference cycles (handles, session,
    # engine) that only the cycle collector frees once the phase's frame is
    # gone; without it the last engine stays on the card while the next
    # one builds, and nemo exact's 49 GB of float32 weights do not fit
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    count = TRACES.get(PHASE[0], {"sessions": 0, "empty": 0, "incomplete": 0})
    print(f"[{PHASE[0]}] done in {time.perf_counter() - t0:.1f} s")
    print(f"[{PHASE[0]}] profiler: {count['empty']} of {count['sessions']} "
          f"sessions came back empty, {count['incomplete']} incomplete (a "
          f"hand-written kernel's records missing; each taken up to "
          f"{TRACE_TRIES} times, "
          f"pads of at least {TRACE_PAD_S * 1e3:.0f} ms and twice the "
          f"farthest stray, 4x longer on each retry; CUPTI flush forced: "
          f"{_cupti() is not None}); device records so far reached "
          f"{SKEW_US['early']:.1f} us before and {SKEW_US['late']:.1f} us "
          f"after the host's traced span")
    return out


def report_failure(e: BaseException) -> None:
    """The failing phase and check, on stdout and on stderr; the last
    frames of the traceback of anything but a failed check."""
    lines = [f"[fail] {PHASE[0]}: {type(e).__name__}: {e}"]
    if not isinstance(e, SmokeFailure):
        lines += ["[fail] traceback, last frames:"] + [
            ln.rstrip() for ln in traceback.format_tb(e.__traceback__)[-4:]]
    for stream in (sys.stdout, sys.stderr):
        print("\n".join(lines), file=stream, flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:   # a failed check, a CUDA error, anything else
        report_failure(e)
        sys.exit(1)
