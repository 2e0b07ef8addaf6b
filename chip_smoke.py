#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks them against their plain versions, runs the full-width model,
transcribes a synthetic file to MIDI through the port's CLI, takes training
steps, and trains through the training CLI on a synthetic dataset, one
member and a population of 4.

    python3 chip_smoke.py

Needs one CUDA device (Hopper, sm_90a) and nvcc; imports no JAX.  Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. kernels: build from csrc/, then each kernel against its plain version
     -- the forward kernels at the serving shapes (16 windows, S=250 /
     P=256, 4 heads x 64) and at the training shapes (32 windows), kernels 1
     and 2 also at the serving batch of 128 windows, kernel 1 with kernel 3
     twice on the same inputs, which must give the same bits; the
     backward kernels and every dropout kernel (seeded: against the plain
     version on the bytes the dump kernel gives for the seed; bits: on
     random bytes) at the training shapes, f32 and bf16 -- with its time
     beside the plain version's, the
     least time the card could take (bytes over its memory rate or
     operations over its peak rate, whichever is larger), the operations
     over its time and, for the global attention, the time of
     F.scaled_dot_product_attention on the same tensors (CUDA events); the
     global backward also at a ragged S = 65 and, for each mask source,
     twice on the same inputs, which must give the same bits; the local
     forward and backward (kernels 2, 12, 5 and 7, 13, 8) likewise at P = 80,
     a 64-row block cut short, and twice on the same inputs for each mask
     source; the global
     dropout forward (kernels 15 and 4) at S = 250, valid_len 200 and S =
     496 with block 16, where the seeded kernel must equal the bits kernel
     on the dumped bytes and each must repeat bit for bit; the ConvNeXt
     stage backward at the geometry of stages 5 and 6 at 32 windows and at
     519 rows (not a multiple of its product tiles), each twice on the same
     inputs, which must give the same bits, and the stage forward at stages
     4, 5, 6 at 16 windows, likewise twice, each beside autograd through (or
     the forward of) the plain block loop, which is many calls and not one;
     the Philox dump at the bits route's two geometries and at P = 37 and
     496, equal to the plain Philox's bytes, beside torch.randint;
  3. forward: the default model (~11.6 M params) from seeded weights on 16
     seeded windows (16, 2, 80000), kernel path vs plain path, bf16 and f32,
     and 8 launches of each forward kernel per forward;
  4. end to end: ~30 s of synthetic stereo piano tones written as WAV, the
     seeded weights saved as a port checkpoint, then the CLI
     (file -> MIDI, f32, the eventizer on the card) with its launches
     counted; the MIDI is read back and the stitched probabilities are held
     against the plain path's;
  5. training: the same model, dropout-free and with cnn_bwd_kernel=False
     (autograd through the ConvNeXt blocks), bf16 compute over f32
     parameters, 4 optimizer steps on one seeded batch of 64 windows in 2
     minibatches of 32, with 16 launches of each of the four kernels per
     step; the f32 gradient of a minibatch of 4 through the kernels is held
     against the same through the plain path, the bf16 loss of a minibatch
     of 32 likewise, and a step on labels that hold a nan must change nothing;
  6. training with dropout: the reference-parity step -- the same model with
     transformer_dropout_rate 0.1, the same batch, one seeded generator, 4
     optimizer steps with 16 launches per step of each seeded dropout kernel
     (forward and backward, local and global) and none of the dropout-free
     ones; the f32 gradient of a minibatch of 4 through the kernels against
     the plain path under the same seed; the same steps again from the same
     state and seed, which must give the same losses bit for bit; and one
     step by the precomputed-bits route (A2M_PRNG_DROPOUT=0: the dump kernel
     writes the bytes, the bits kernels read them), which must give the
     seeded route's loss;
  7. training, the default configuration untouched (cnn_bwd_kernel=True,
     dropout 0.1): 4 steps with 4 launches of the stage backward per step
     (stages 5 and 6 of 2 minibatches) beside the 16 of each seeded kernel;
     the f32 gradient of a minibatch of 4 with cnn_impl "pallas" against
     "xla"; the first bf16 loss equal to phase 6's bit for bit (the forward
     is the same block loop); the same steps again, identical;
  8. serving with cnn_impl="pallas_stage": 16 windows through
     infer.predict_and_stitch, bf16 and f32, 3 launches of the stage forward
     per forward, the stitched probabilities against the cnn_impl="xla"
     path, and ms per forward beside the default path's at 16 and 128
     windows;
  9. serving with the fused transformer-layer kernels, attention_impl
     "pallas_block" (kernel 11: 8 local + 8 global launches per forward),
     "pallas_fused" (kernel 18: 8 + 8) and "pallas_pair" (kernel 17: 8), none
     of the attention cores: 16 windows through infer.predict_and_stitch,
     bf16 and f32, against the "xla" path; ms per forward beside "pallas" at
     16 and 128 windows; the f32 gradients of a dropout-free minibatch of 4
     through each against "xla"; the CLI with a --config that asks for
     "pallas_pair" on phase 4's WAV and checkpoint, its MIDI events against
     phase 4's;
 10. attention_impl="pallas_rw" (kernel 6 on the local layers' dropout-free
     two-phase route, kernel 1 elsewhere): the same 16 windows, bf16 and f32,
     against the "xla" path with 8 launches of kernels 6 and 1 and none of
     kernel 2, ms per forward beside "pallas" at 16 and 128 windows, the f32
     gradients of a dropout-free minibatch of 4 against "xla", one
     dropout-free step, the CLI with a "pallas_rw" --config against phase
     4's MIDI; f16 serving with "pallas" (no kernel takes f16, as in the JAX
     package: no launch, equal to f16 "xla"); kernels 3 and 10 through their
     functions, forward and backward, against the JAX reference formulations;
 11. the serving paths of a file, f32, phase 4's weights: transcribe_file on
     phase 4's 30 s WAV and on a 300 s one with its stage walls (decode,
     transfer, window, model_stitch, eventize, fetch) and the card's events
     equal to the numpy eventizer's on the fetched probabilities;
     transcribe_file_streaming on the 300 s file against transcribe_file by
     the correctness gate (stitched <= 1e-4, events identical unless a
     probability lies within that of a threshold), with the time to the
     first segment, the total and the peak device memory of each;
     transcribe_samples_fused on the 30 s tones at 44.1 kHz in memory
     against the decode path; the CLI with --stream on phase 4's WAV, whose
     MIDI must be phase 4's;
 12. the native data plane: the port's binding builds cpp/ into build/native/
     and loads it (there is no numpy fallback here); load_full_audio_f16 on
     phase 4's and phase 11's WAVs through it against the numpy path, bit
     for bit; transcribe_file on the 300 s WAV with its stage walls, native
     beside numpy, the events identical;
 13. training through its entry point, cli/train_cli.py, at the default
     ModelConfig and TrainConfig (batch 64 = 2 x 32, bf16, dropout 0.1,
     cnn_bwd_kernel, the device input ring and the augmentation on the
     card; a --config JSON sets only num_steps 6, print_every 1,
     checkpoint_every 3 and testset_loss_every 6) on a synthetic train and
     val set written under build/smoke/: per step 16 launches of each seeded
     dropout kernel and 4 of the stage backward, none of the dropout-free
     ones; finite losses, the val set's hit rate in [0, 1], checkpoints on
     disk, a second invocation resuming at latest + 1, the serving CLI on
     the checkpoint directory; the same with input_ring_capacity=0 (host
     batches augmented on the card); both feed from the default loader, the
     grain pipeline (data.loader.GrainLoader, dataset_num_workers 3 worker
     processes from a forkserver); the ring run again with --threaded-loader, the
     same checks; ms per step, the ring's reuse factor, the pipeline
     workers' start-up wall (to the first batch), the augmentation's ms and
     device events per batch (its waves against its sequential plain
     version, bit for bit) and the peak device memory;
     then one step in flight: the ring feed over 12 steps with the loss
     read every step (print_every 1) and every third (print_every 3), in
     turns, ms per step over steps 4-12;
 14. the ensemble axis at the default configuration, a population of 4:
     cli/train_cli.py --ensemble-size 4 with use_custom_init (per step 64
     launches of each seeded dropout kernel and 16 of the stage backward,
     four finite member losses, the evolution after the evaluations of
     steps 2 and 4, checkpoints whose leaves lead with (4,), a resume at
     latest + 1); one ensemble step in-process, each member the bits of a
     one-member step on its weights and seed; the evolution of that
     population (winners' bits kept, in place, the optimizer still bound);
     members 0 and 3 served from the CLI's checkpoint; infer_cli,
     audio_to_midi --validation [--individual], copy_weights and
     inspect_model on phase 13's checkpoint; f16 training from the CLI,
     which launches no kernel; ms per step at E = 4 beside phase 13's one
     member, the peak device memory and the evolution's host ms;
 15. parallel/, every rank a spawned process sharing the one card over gloo
     (a file rendezvous, a deadline on every collective and on every
     join): kernels 1, 2, 9, 7, 15, 12, 16, 13 on 2 heads of 64 (a TP 2
     shard's) against their plain versions; TP 2 -- phase 3's forward on 2
     local heads against one rank's (8 launches of kernels 1 and 2 per
     forward per rank), one f32 dropout-free step against one rank's (loss,
     updates; 16 launches of kernels 9 and 7 per rank), four default steps
     (16 of each seeded kernel and 4 of the stage backward per rank per
     step) with the replicated parameters alike on both ranks and their
     attention seeds' Philox bytes different; DP 2 -- the same f32 step,
     four default steps (8 and 2 per rank per step), every parameter alike;
     cli/train_cli.py on 2 processes (the three multi-host flags and
     --dist-backend gloo) with the ring in lockstep, one parameter digest,
     each checkpoint written once and a resume at latest + 1, the same with
     model_parallel_size 2, and --ensemble-size 4 over 4 processes with the
     evaluations and evolutions of steps 2 and 4 and (4,) leaves on disk;
     transcribe_file over 2 data ranks on phase 4's WAV against one rank;
     ms per step per layout beside phase 13's, the peak device memory per
     rank and one gradient all-reduce over gloo (the ranks share one card:
     the port's overheads, not scaling);
 16. a. export.py: the default model's programs at f32, bf16 and f16, run
     in a fresh process, every route's nodes, opcheck of each a2m::* op;
     b. the full-geometry parity against the JAX package
     (tests/full_geometry_golden.npz): every route's logits, f32 and bf16;
     c. the same at ConvNeXt layer scale 1, where the blocks weigh
     (tests/full_geometry_blocks_golden.npz): every route's logits, and the
     digest of the training loss's gradients on the default route (kernels
     7, 9 and 20 launched), without the stage-backward kernel and on "xla",
     f32 and bf16, the controls (rotated query heads, stage 5's taps
     reversed) outside every limit; d. the serving CLI on 2 ranks, a trace,
     modelutil and the figures.
Phase 2 also holds kernels 11, 18 and 17 against their plain versions at the
serving shapes, beside the same layer by the default "pallas" route (torch
LayerNorm and products, kernels 1 and 2: many calls, not one), kernels 6, 3
and 10 at the serving shapes beside kernel 2 (whose bits kernel 6 must give:
it runs kernel 2's body), F.scaled_dot_product_attention and rope + kernel 1
(whose bits kernel 10 must give: it runs kernel 1's body on the roped rows),
each with its gradient through autograd on the card, kernel 10 also at S =
496 with block 16, and the eventizer's kernel (not a TPU kernel: it takes
the place of the JAX package's lax.scan) on a seeded 15,000 x 90 array
against the numpy eventizer, bit for bit, timed beside it.  Phase 6's
plain comparator is "pallas" with the seeded dropout wrappers replaced, in
this script only, by their plain versions on the plain Philox bytes of the
same seed: "xla" drops at the exact rate, as the JAX einsum route does.
Prints one JSON line of kernel results, then {"ok": true, "device": ...}
as the last line.  Artifacts go to build/smoke/ in the checkout.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import math
import shutil
import socket
import subprocess
import sys
import textwrap
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
BATCH, SEQ, PADDED, HEADS, HEAD_DIM = 16, 250, 256, 4, 64
EVENT_THRESHOLDS = (0.1, 0.4, 0.5)
# Max abs error of a kernel vs its plain version on O(1) inputs.  f32: both
# accumulate in fp32 and differ only in summation order.  bf16: outputs round
# to 8 mantissa bits (one ulp near 1 is 7.8e-3).
KERNEL_TOL = {"f32": 1e-5, "bf16": 2e-2}
# Whole-model probabilities, kernel path vs plain path on the card.  f32 (TF32
# off): per-layer differences of ~1e-6 carried through 16 attention layers.
# bf16: a 1-ulp flip in any of ~60 bf16 roundings per layer moves the
# residual stream by ~1e-2 relative.
FORWARD_TOL = {"f32": 1e-4, "bf16": 5e-2}
# Backward kernels vs their plain versions, per output (see grad_tol).  f32:
# the same fp32 sums in another order, the kernel's softmax online -- a share
# of the output's largest magnitude.  bf16: outputs round to 8 mantissa bits,
# and an fp32 difference of one ulp can flip the bf16 rounding of a weight
# or a dlogit before the products.  One such flip reads exactly one bf16 ulp
# of the output's top binade, so the limit is 3 of those ulps: a reading of
# one or two ulps never sits on it.
GRAD_TOL_F32 = 2e-5
GRAD_TOL_BF16_ULPS = 3
# Parameter gradients of the whole model in f32 (TF32 off), kernel path vs
# plain path, as a share of each leaf's largest magnitude.  Per-layer
# differences of ~1e-6 carried back through 16 attention layers and 39
# ConvNeXt blocks read 5.7e-7 on an H100; the limit is ~20x that, far below
# what one wrong edge row or masked column of a backward kernel leaves in
# the projections' gradients (a share of 1/S of a leaf's terms, ~4e-3).
MODEL_GRAD_TOL = 1e-5
# The fused layer kernels (11, 17, 18) vs their plain versions: f32 as
# KERNEL_TOL.  bf16: KERNEL_TOL, or 2 ulps of the output's top binade where
# that is larger -- kernels 17 and 18 return the residual stream, whose
# magnitudes reach ~5 on these inputs (one ulp: 0.031).  A rounding flipped
# by an fp32 sum taken in another order moves an output by one ulp; a wrong
# row, column or window moves it by a share of its largest.
FUSED_TOL_BF16_ULPS = 2
# f16 serving with "pallas" against f16 "xla": both take the einsum routes
# (no kernel takes f16, as in the JAX package), the same operations on the
# same tensors, so they agree exactly; the limit, two f16 ulps of a
# probability near 1, only leaves room for a reduction taken in another
# order.  A kernel route taken in f16 would have raised.
F16_TOL = 1e-3
# The bf16 loss of one training minibatch, kernel path vs plain path, as a
# share of the loss: the per-output differences of FORWARD_TOL come with
# either sign and average out over the 32 x 250 x 90 summed outputs, to
# 1.5e-6 on an H100; the limit is ~65x that.
LOSS_TOL_BF16 = 1e-4
# The stage kernels vs their plain versions, per output: f32 as GRAD_TOL_F32;
# bf16 in ulps of the output's top binade.  A rounding flipped by an fp32 sum
# taken in another order is one ulp, and the residual hands each block's
# flips to the next block: 3 ulps for the 3 blocks of stages 4 and 6, 8 for
# the 21 of stage 5 (read on an H100: up to 0.75 and 3).  A wrong tap, row or
# column moves an output by a share of its largest, hundreds of ulps.
STAGE_TOL_BF16_ULPS = {3: GRAD_TOL_BF16_ULPS, 21: 8}
# (depth, L, C, H) of the stages the kernels take in the default model.
STAGES = {4: (3, 1000, 64, 128), 5: (21, 500, 128, 256), 6: (3, 250, 256, 512),
          # kernel 20 where the rows (3 x 173 = 519) are not a multiple of its
          # product's 128-row tile, nor of its depth tile
          "tail": (3, 173, 128, 384)}
TRAIN_STEPS = 4
SERVING_BATCH = 128  # windows per forward in batch transcription
# The eventizer's phase-2 case: 300 s of audio at 50 frames per second.
EVENT_FRAMES = 15_000
# Phase 11's long file, and the limit of the fused path at 44.1 kHz in
# memory against the decode path of the same tones written at 16 kHz: the
# decode path samples them at 16 kHz, as 16-bit PCM, and ships them as f16
# (a relative 2^-11 per sample); the fused path resamples the 44.1 kHz
# samples with the Kaiser filter in f32.  The default model with seed-0
# weights read 2.4e-3 on the CPU (12 s); the limit is 4x that.
LONG_SECONDS = 300.0
FUSED_44K_TOL = 1e-2
TIMED_BATCHES = (BATCH, SERVING_BATCH)  # windows per forward in the serving timings
DROPOUT_THRESHOLD = 26  # round(0.1 * 256): the default transformer_dropout_rate
# Phase 16's full-geometry parity against the JAX package's logits
# (tests/full_geometry.py, tests/full_geometry_golden.npz): the largest
# |logit difference| over the largest |logit|, every route, the kernels on
# the card against JAX on the CPU.  Read on an H100: f32 2.5e-6 to 3.0e-6
# on every route (the CPU's plain forward 3.1e-6), bf16 2.6e-2 to 2.8e-2
# (the plain "xla" route 2.6e-2: bf16 rounding taken in other places; the
# bf16 golden itself lies 3.4e-2 from the f32 one).  The broken control
# (one global layer's query heads rotated) reads 0.14 in both.
PARITY_LIMIT = {"f32": 2e-5, "bf16": 5e-2}
# The routes phase 16 exports and holds against JAX: attention_impl, and
# "pallas_stage" for cnn_impl="pallas_stage" (the "pallas" attention), "xla"
# the plain formulations everywhere.
ROUTES = ("pallas", "pallas_rw", "pallas_block", "pallas_fused", "pallas_pair", "pallas_stage",
          "xla")
# Phase 16c's parity at ConvNeXt layer scale 1
# (tests/full_geometry_blocks_golden.npz): the logits as above, and
# tests/full_geometry.grad_error of the digest of the training loss's
# gradients, on the routes of GRAD_ROUTES.
# Read on an H100 (NVIDIA H100 80GB HBM3, 700.00 W): logits f32 1.48e-6 to
# 1.79e-6 on the 7 routes, bf16 3.23e-2 to 3.99e-2; gradients f32 4.22e-6
# to 6.68e-6 on the 3 routes of GRAD_ROUTES, bf16 0.553 to 0.588 (the worst
# leaves in stage 0, where 39 blocks' bf16 rounding piles up: JAX's own bf16
# gradients lie 0.87 from its f32 ones, its bf16 logits 0.063).  The
# controls read f32 3.2e-2 / 0.68 (logits) and 0.26 / 2.1 (gradients), bf16
# 0.27 / 0.67 and 2.4 / 2.9.  f32 limits ~4x the readings, bf16 ~1.4x.
BLOCKS_PARITY_LIMIT = {"f32": 8e-6, "bf16": 6e-2}
GRAD_PARITY_LIMIT = {"f32": 3e-5, "bf16": 0.8}
# One global layer's rotated query heads moves the bf16 readings no further
# than bf16's own spread (0.043 / 0.59 on the H100), so bf16 takes every
# layer's heads rotated as its control, and logs this one unjudged.
UNJUDGED = "global layer 3's query heads rotated (inside bf16's spread, not judged)"
# The routes a training step takes: name -> (attention_impl, cnn_impl,
# cnn_bwd_kernel).  "pallas" is the default: kernels 1, 2 forward, 7, 9
# and 20 backward.
GRAD_ROUTES = {"pallas": ("pallas", "pallas", True),
               "pallas without the stage-backward kernel": ("pallas", "pallas", False),
               "xla": ("xla", "xla", False)}
ROUTE_NODES = {  # the a2m::* nodes of a route's program, per transformer pair
    "pallas": {"global_attention_fwd": 1, "local_two_phase_fwd": 1},
    "pallas_rw": {"global_attention_fwd": 1, "local_two_phase_fwd": 1},
    "pallas_block": {"attention_block_fwd": 2},
    "pallas_fused": {"fused_sublayer_fwd": 2},
    "pallas_pair": {"transformer_pair_fwd": 1},
    "pallas_stage": {"global_attention_fwd": 1, "local_two_phase_fwd": 1},
}

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the memory
# rate, and the operation rate of the input type -- bf16 on the tensor
# cores, f32 outside them (TF32 would change the f32 kernels' numerics).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
# The TF32 tensor-core rate: the f32 attention kernels run each product as
# three TF32 products (3xTF32), so their f32 work also has this bound.
PEAK_TF32_FLOPS = 495e12


def log(msg: str) -> None:
    print(msg, flush=True)


FUSED_IMPLS = ("pallas_block", "pallas_fused", "pallas_pair")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def all_kernels() -> tuple:
    """Every kernel wrapper of the port, the attention ones first."""
    from audio_to_midi_tpu_torch.ops import attention_kernels, convnext_kernels, eventize
    from audio_to_midi_tpu_torch.ops import fused_layer_kernels

    return (attention_kernels.KERNELS + convnext_kernels.KERNELS + fused_layer_kernels.KERNELS
            + eventize.KERNELS)


def reset_launches() -> None:
    for fn in all_kernels():
        fn.launches = 0


def read_launches() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in all_kernels()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters`` calls.

    The card first spins for ~20 ms while the host queues the calls, so that
    they run back to back: without that, a kernel of a few tens of
    microseconds is timed at the pace of its Python wrapper."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def randn(*shape, seed: int, dtype: torch.dtype) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(device="cuda", dtype=dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def grad_tol(ref: torch.Tensor, dtype: str, ulps: int = GRAD_TOL_BF16_ULPS) -> float:
    """The allowed max abs error of one output of a backward kernel."""
    top = ref.float().abs().max().item()
    if dtype == "f32":
        return GRAD_TOL_F32 * max(1.0, top)
    # One bf16 ulp of the binade that holds the output's largest magnitude.
    ulp = 2.0 ** (math.ceil(math.log2(max(top, 2.0 ** -100))) - 8)
    return ulps * ulp


def fused_tol(ref: torch.Tensor, dtype: str) -> float:
    if dtype == "f32":
        return KERNEL_TOL["f32"]
    return max(KERNEL_TOL["bf16"], grad_tol(ref, "bf16", FUSED_TOL_BF16_ULPS))


def bound(n_tensors: int, numel: int, dtype: str, flops: float, extra_bytes: int = 0) -> dict:
    """The least time the card could take: every input read and every output
    written once over the memory rate, or the operations over the peak rate
    of the input type, whichever is larger."""
    itemsize = 4 if dtype == "f32" else 2
    bytes_ms = (n_tensors * numel * itemsize + extra_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    tf32x3_ms = max(bytes_ms, 3 * flops / PEAK_TF32_FLOPS * 1e3) if dtype == "f32" else None
    return {"bound_ms": max(bytes_ms, ops_ms), "tf32x3_ms": tf32x3_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "flops": flops}


def sdpa_backend(q4, k4, v4) -> str:
    """The first fused backend, in PyTorch's own order, that takes these
    inputs; the default dispatch falls to the math path when none does."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # a refusal also warns, with its reason
                F.scaled_dot_product_attention(q4, k4, v4)
            return backend.name
        except RuntimeError:
            continue
    return "MATH"


def stage_operands(depth: int, b: int, l: int, c: int, hidden: int, dtype: torch.dtype, seed: int):
    """Seeded (carries, weights, dy) of a stage on the card: weights at the
    init's scales but gamma in (0.5, 1.5) and a LayerNorm off the identity,
    so the branch and every gradient count."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    uni = lambda scale, *shape: (torch.rand(*shape, generator=gen) * 2 - 1) * scale
    normal = lambda *shape: torch.randn(*shape, generator=gen)
    weights = (uni(7 ** -0.5, depth, 7, c), uni(7 ** -0.5, depth, 1, c),
               torch.stack([1 + 0.1 * normal(depth, c), 0.1 * normal(depth, c)], 1),
               uni(c ** -0.5, depth, c, hidden), uni(c ** -0.5, depth, 1, hidden),
               uni(hidden ** -0.5, depth, hidden, c), uni(hidden ** -0.5, depth, 1, c),
               0.5 + torch.rand(depth, 1, c, generator=gen))
    weights = tuple((w.to(dtype).float() if i == 2 else w.to(dtype)).cuda().contiguous()
                    for i, w in enumerate(weights))   # 2: ln stays fp32
    return (normal(depth, b, l, c).to(device="cuda", dtype=dtype), weights,
            normal(b, l, c).to(device="cuda", dtype=dtype))


def run_case(results: dict, case, name, kernel, plain, tol, bound_, library=None) -> None:
    """One phase-2 case: the kernel against its plain version (``tol`` maps
    an output of the plain version to its allowed max abs error), then the
    kernel's, the plain version's and the library call's times."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    err, allowed, ok = 0.0, 0.0, True
    for o, r in zip(outs, refs):
        e, limit = max_err(o, r), tol(r)
        if e >= err:
            err, allowed = e, limit
        ok = ok and bool(torch.isfinite(o.float()).all()) and e <= limit
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    library_ms = time_ms(library) if library is not None else None
    lib = f", library {library_ms:.4f} ms" if library is not None else ""
    # The operations the function needs over the kernel's time.
    rate = f", achieved {bound_['flops'] / ms / 1e9:.2f} TFLOP/s" if bound_.get("flops") else ""
    if bound_.get("tf32x3_ms") is not None:
        rate += f", 3xTF32 bound {bound_['tf32x3_ms']:.4f} ms"
    log(f"kernel {case} {name}: max_abs_err {err:.3e} (tol {allowed:.1e}) "
        f"{'OK' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
        f"bound {bound_['bound_ms']:.4f} ms by {bound_['bound_by']}{rate}")
    if not ok:
        raise AssertionError(f"kernel {case} {name} disagrees with its plain version")
    results[f"{case} {name}"] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                 "library_ms": library_ms, **bound_}


def in_turns(fns: dict, iters: int = 50) -> dict[str, list[float]]:
    """ms of each callable, timed in turns a, b, ..., b, a in one call."""
    times = {}
    for label in (*fns, *reversed(fns)):
        times.setdefault(label, []).append(time_ms(fns[label], iters=iters))
    return times


def check_grads(case: str, grads, refs, tol) -> None:
    """The input gradients of a kernel's autograd on the card against the
    plain path's, each within ``tol(ref)``."""
    errs = [(max_err(g, r), tol(r)) for g, r in zip(grads, refs)]
    ok = all(bool(torch.isfinite(g.float()).all()) and e <= lim
             for g, (e, lim) in zip(grads, errs))
    worst = max(errs, key=lambda el: el[0] / el[1] if el[1] else el[0])
    log(f"kernel {case} grads through autograd vs the plain path: max_abs_err {worst[0]:.3e} "
        f"(tol {worst[1]:.1e}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel {case}: the gradient through autograd disagrees")


def check_variant_kernels(ak, results: dict, name: str, dt, ts, qkv) -> None:
    """Phase 2, kernels 6, 3 and 10 at the serving shapes (16 windows, P =
    256 / S = 250, 4 heads x 64), each beside what it stands in for, in turns:
    kernel 6 beside kernel 2 on the same tensors (the point of the TPU
    variant; no one PyTorch call computes the two-phase average), whose bits
    it must give, as it runs kernel 2's body; kernel 3 beside
    F.scaled_dot_product_attention on the same (G, H, S, hd) tensors
    (one call computes it: its library time), kernel 10 beside the "pallas"
    global route -- rope on q and k, then kernel 1, many calls.  Bounds as
    kernels 2 and 1, kernel 10 with its two fp32 tables.  Then each one's
    input gradients through autograd on the card against the plain path's:
    kernel 7's plain version for kernel 6, autograd through the JAX package's
    reference formulations (their backward) for kernels 3 and 10."""
    import torch.nn.functional as F

    from audio_to_midi_tpu_torch.models.rope import precompute_frequencies, rope_with

    run = functools.partial(run_case, results)
    kernel_tol = lambda ref: KERNEL_TOL[name]
    grads_tol = lambda ref: grad_tol(ref, name)
    n, width = ts[0].shape[0], HEADS * HEAD_DIM
    attn_flops = lambda s, cols: 4.0 * n * HEADS * s * cols * HEAD_DIM   # two products

    def autograd_of(fn, inputs, cot):
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, cot)

    # Kernel 6.
    run("local rw P=256", name, lambda: ak.local_two_phase_rw(*ts, HEADS, 16),
        lambda: ak.local_two_phase_rw_plain(*ts, HEADS, 16), kernel_tol,
        bound(6, ts[0].numel(), name, 2 * attn_flops(PADDED, 16)))
    turns = in_turns({"kernel 6": lambda: ak.local_two_phase_rw(*ts, HEADS, 16),
                      "kernel 2": lambda: ak.local_two_phase(*ts, HEADS, 16)})
    same = torch.equal(ak.local_two_phase_rw(*ts, HEADS, 16), ak.local_two_phase(*ts, HEADS, 16))
    results[f"local rw P=256 {name}"]["beside"] = {
        "what": "kernel 2 (local_two_phase) on the same tensors", "ms": turns["kernel 2"]}
    log(f"kernel local rw P=256 {name} in turns with kernel 2 on the same tensors: "
        + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in turns.items())
        + f"; identical bits {same}")
    if not same:
        raise AssertionError("kernel 6 does not give kernel 2's bits on the same tensors")
    g = randn(n, PADDED, width, seed=26, dtype=dt)
    check_grads(f"local rw P=256 {name}",
                autograd_of(lambda *t: ak.local_two_phase_rw(*t, HEADS, 16), ts, g),
                ak.local_two_phase_grads_plain(*ts, g, HEADS, 16), grads_tol)

    # Kernel 3 on the head-major copies of the global attention's tensors.
    heads4 = lambda t: t.reshape(n, SEQ, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    q4, k4, v4 = (heads4(t) for t in qkv)
    run("head major S=250", name, lambda: ak.head_major_attention(q4, k4, v4),
        lambda: ak.head_major_attention_plain(q4, k4, v4), kernel_tol,
        bound(4, q4.numel(), name, attn_flops(SEQ, SEQ)),
        library=lambda: F.scaled_dot_product_attention(q4, k4, v4))
    cot = heads4(randn(n, SEQ, width, seed=27, dtype=dt))
    check_grads(f"head major S=250 {name}",
                autograd_of(ak.head_major_attention, (q4, k4, v4), cot),
                autograd_of(ak.head_major_attention_reference, (q4, k4, v4), cot), grads_tol)

    # Kernel 10 with the model's tables (positions 0..249 of hd 64).
    freqs = precompute_frequencies(HEAD_DIM, SEQ, device="cuda")
    cos, sin = freqs.cos, freqs.sin
    q, k, v = qkv

    def rope_then_kernel1():
        rot = lambda t: rope_with(t.reshape(n, SEQ, HEADS, HEAD_DIM), cos, sin).reshape(t.shape)
        return ak.global_attention(rot(q), rot(k), v, HEADS)

    run("rope S=250", name, lambda: ak.rope_attention(q, k, v, cos, sin, HEADS),
        lambda: ak.rope_attention_plain(q, k, v, cos, sin, HEADS), kernel_tol,
        bound(4, q.numel(), name, attn_flops(SEQ, SEQ), extra_bytes=2 * cos.numel() * 4))
    turns = in_turns({"kernel 10": lambda: ak.rope_attention(q, k, v, cos, sin, HEADS),
                      "rope + kernel 1": rope_then_kernel1})
    same = torch.equal(ak.rope_attention(q, k, v, cos, sin, HEADS), rope_then_kernel1())
    results[f"rope S=250 {name}"]["beside"] = {
        "what": "the pallas global route: rope_with on q and k, then kernel 1",
        "ms": turns["rope + kernel 1"]}
    log(f"kernel rope S=250 {name} in turns with the pallas route (rope, then kernel 1): "
        + ", ".join(f"{k_} {' / '.join(f'{t:.4f}' for t in v_)} ms" for k_, v_ in turns.items())
        + f"; identical bits {same}")
    if not same:
        raise AssertionError("kernel 10 does not give kernel 1's bits on the roped inputs")
    # S = 496 with block 16 (31 blocks of 16 rows), the tables' first 496 rows.
    long_freqs = precompute_frequencies(HEAD_DIM, 496, device="cuda")
    lq, lk, lv = (randn(n, 496, width, seed=29 + i, dtype=dt) for i in range(3))
    run("rope S=496 block=16", name,
        lambda: ak.rope_attention(lq, lk, lv, *long_freqs, HEADS, 16),
        lambda: ak.rope_attention_plain(lq, lk, lv, *long_freqs, HEADS, 16), kernel_tol,
        bound(4, lq.numel(), name, attn_flops(496, 16),
              extra_bytes=2 * long_freqs.cos.numel() * 4))
    cot = randn(n, SEQ, width, seed=28, dtype=dt)
    check_grads(f"rope S=250 {name}",
                autograd_of(lambda *t: ak.rope_attention(*t, cos, sin, HEADS), qkv, cot),
                autograd_of(lambda *t: ak.rope_attention_reference(*t, cos, sin, HEADS), qkv,
                            cot), grads_tol)


def check_kernels(ak, ck, train_minibatch: int) -> dict[str, dict]:
    """Phase 2: each kernel vs its plain version, with its bound and, where
    one PyTorch call computes the same function, that call's time."""
    import torch.nn.functional as F

    width = HEADS * HEAD_DIM
    results = {}
    run = functools.partial(run_case, results)

    def heads4(t):  # (G, S, H*hd) -> the (G, H, S, hd) view SDPA takes
        return t.reshape(t.shape[0], t.shape[1], HEADS, HEAD_DIM).transpose(1, 2)

    for name, dt in DTYPES.items():
        kernel_tol = lambda ref: KERNEL_TOL[name]
        grads_tol = lambda ref: grad_tol(ref, name)
        # --- forward kernels at the serving shapes ---
        n = BATCH
        q, k, v = (randn(n, SEQ, width, seed=i, dtype=dt) for i in range(3))
        attn_flops = lambda groups, s, cols, products: products * 2.0 * groups * HEADS * s * cols * HEAD_DIM
        log(f"library call for the global attention, {name}: F.scaled_dot_product_attention, "
            f"backend {sdpa_backend(heads4(q), heads4(k), heads4(v))}")
        run("global S=250", name,
            lambda: ak.global_attention(q, k, v, HEADS),
            lambda: ak.global_attention_plain(q, k, v, HEADS), kernel_tol,
            bound(4, q.numel(), name, attn_flops(n, SEQ, SEQ, 2)),
            library=lambda: F.scaled_dot_product_attention(heads4(q), heads4(k), heads4(v)))
        run("global S=250 valid_len=200", name,
            lambda: ak.global_attention(q, k, v, HEADS, 0, 200),
            lambda: ak.global_attention_plain(q, k, v, HEADS, 0, 200), kernel_tol,
            bound(4, q.numel(), name, attn_flops(n, SEQ, 200, 2)))
        fq, fk, fv, fg = (randn(n, 31 * 16, width, seed=10 + i, dtype=dt) for i in range(4))
        run("global S=496 block=16", name,
            lambda: ak.global_attention(fq, fk, fv, HEADS, 16),
            lambda: ak.global_attention_plain(fq, fk, fv, HEADS, 16), kernel_tol,
            bound(4, fq.numel(), name, attn_flops(n, 496, 16, 2)))
        # Kernel 1 at the serving batch of 128 windows.
        bq, bk, bv = (randn(SERVING_BATCH, SEQ, width, seed=80 + i, dtype=dt) for i in range(3))
        run(f"global S=250 B={SERVING_BATCH}", name,
            lambda: ak.global_attention(bq, bk, bv, HEADS),
            lambda: ak.global_attention_plain(bq, bk, bv, HEADS), kernel_tol,
            bound(4, bq.numel(), name, attn_flops(SERVING_BATCH, SEQ, SEQ, 2)),
            library=lambda: F.scaled_dot_product_attention(heads4(bq), heads4(bk), heads4(bv)))
        del bq, bk, bv
        ts = [randn(n, PADDED, width, seed=20 + i, dtype=dt) for i in range(5)]
        # Per row and phase 16 keys, two products: no single PyTorch call
        # computes the two-phase average, so there is no library time.
        run("local P=256", name,
            lambda: ak.local_two_phase(*ts, HEADS, 16),
            lambda: ak.local_two_phase_plain(*ts, HEADS, 16), kernel_tol,
            bound(6, ts[0].numel(), name, 2 * attn_flops(n, PADDED, 16, 2)))
        # Kernel 2 at the serving batch of 128 windows.
        bts = [randn(SERVING_BATCH, PADDED, width, seed=85 + i, dtype=dt) for i in range(5)]
        run(f"local P=256 B={SERVING_BATCH}", name,
            lambda: ak.local_two_phase(*bts, HEADS, 16),
            lambda: ak.local_two_phase_plain(*bts, HEADS, 16), kernel_tol,
            bound(6, bts[0].numel(), name, 2 * attn_flops(SERVING_BATCH, PADDED, 16, 2)))
        del bts
        check_variant_kernels(ak, results, name, dt, ts, (q, k, v))

        # --- forward and backward kernels at the training shapes ---
        n = train_minibatch
        q, k, v, g = (randn(n, SEQ, width, seed=30 + i, dtype=dt) for i in range(4))
        run(f"global S=250 B={n}", name,
            lambda: ak.global_attention(q, k, v, HEADS),
            lambda: ak.global_attention_plain(q, k, v, HEADS), kernel_tol,
            bound(4, q.numel(), name, attn_flops(n, SEQ, SEQ, 2)),
            library=lambda: F.scaled_dot_product_attention(heads4(q), heads4(k), heads4(v)))
        # Kernels 1 and 3 share one tensor-core body with no atomics: the same
        # inputs give the same bits.
        for what, call in (("global", lambda: ak.global_attention(q, k, v, HEADS, 0, 200)),
                           ("head major", lambda: ak.head_major_attention(
                               *(heads4(t).contiguous() for t in (q, k, v))))):
            same = torch.equal(call(), call())
            log(f"{what} S=250 B={n} {name}: the same inputs twice, identical bits {same}")
            if not same:
                raise AssertionError(f"the {what} forward does not repeat bit for bit")
        ts = [randn(n, PADDED, width, seed=50 + i, dtype=dt) for i in range(6)]
        run(f"local P=256 B={n}", name,
            lambda: ak.local_two_phase(*ts[:5], HEADS, 16),
            lambda: ak.local_two_phase_plain(*ts[:5], HEADS, 16), kernel_tol,
            bound(6, ts[0].numel(), name, 2 * attn_flops(n, PADDED, 16, 2)))
        q4, k4, v4 = (heads4(t).detach().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(q4, k4, v4)
        run("global grads S=250", name,
            lambda: ak.global_attention_grads(q, k, v, g, HEADS),
            lambda: ak.global_attention_grads_plain(q, k, v, g, HEADS), grads_tol,
            bound(7, q.numel(), name, attn_flops(n, SEQ, SEQ, 5)),
            library=lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), heads4(g),
                                                retain_graph=True))
        run("global grads S=250 valid_len=200", name,
            lambda: ak.global_attention_grads(q, k, v, g, HEADS, 0, 200),
            lambda: ak.global_attention_grads_plain(q, k, v, g, HEADS, 0, 200),
            grads_tol, bound(7, q.numel(), name, attn_flops(n, SEQ, 200, 5)))
        gen = torch.Generator(device="cpu").manual_seed(40)
        bits = torch.randint(0, 256, (n, HEADS, SEQ, SEQ), generator=gen,
                             dtype=torch.uint8).cuda()
        run("global grads S=250 bits", name,
            lambda: ak.global_attention_grads(q, k, v, g, HEADS, 0, None, bits, 26),
            lambda: ak.global_attention_grads_plain(q, k, v, g, HEADS, 0, None, bits, 26),
            grads_tol,
            bound(7, q.numel(), name, attn_flops(n, SEQ, SEQ, 5), extra_bytes=bits.numel()))
        run("global grads S=496 block=16", name,
            lambda: ak.global_attention_grads(fq, fk, fv, fg, HEADS, 16),
            lambda: ak.global_attention_grads_plain(fq, fk, fv, fg, HEADS, 16), grads_tol,
            bound(7, fq.numel(), name, attn_flops(BATCH, 496, 16, 5)))
        # A ragged length: one full 64-row tile and one of a single row.
        rq, rk, rv, rg = (randn(n, 65, width, seed=70 + i, dtype=dt) for i in range(4))
        run("global grads S=65", name,
            lambda: ak.global_attention_grads(rq, rk, rv, rg, HEADS),
            lambda: ak.global_attention_grads_plain(rq, rk, rv, rg, HEADS), grads_tol,
            bound(7, rq.numel(), name, attn_flops(n, 65, 65, 5)))
        run("local grads P=256", name,
            lambda: ak.local_two_phase_grads(*ts, HEADS, 16),
            lambda: ak.local_two_phase_grads_plain(*ts, HEADS, 16), grads_tol,
            bound(11, ts[0].numel(), name, 2 * attn_flops(n, PADDED, 16, 5)))
        # A length that cuts the local backward's 64-row blocks short: 80 = 64 + 16.
        ts80 = [randn(n, 80, width, seed=90 + i, dtype=dt) for i in range(6)]
        run("local grads P=80", name,
            lambda: ak.local_two_phase_grads(*ts80, HEADS, 16),
            lambda: ak.local_two_phase_grads_plain(*ts80, HEADS, 16), grads_tol,
            bound(11, ts80[0].numel(), name, 2 * attn_flops(n, 80, 16, 5)))
        run("local P=80", name,
            lambda: ak.local_two_phase(*ts80[:5], HEADS, 16),
            lambda: ak.local_two_phase_plain(*ts80[:5], HEADS, 16), kernel_tol,
            bound(6, ts80[0].numel(), name, 2 * attn_flops(n, 80, 16, 2)))

        # --- the dropout kernels at the training shapes ---
        thr = DROPOUT_THRESHOLD
        drop = dict(threshold=thr)
        seed = torch.tensor([20260 + len(name), -7], dtype=torch.int32, device="cuda")
        # The library call: SDPA drops at the same rate from its own generator.
        sdpa_drop = lambda: F.scaled_dot_product_attention(heads4(q), heads4(k), heads4(v),
                                                           dropout_p=thr / 256)
        sdpa_drop_out = F.scaled_dot_product_attention(q4, k4, v4, dropout_p=thr / 256)
        for case, qkvg, block, valid, groups in (
                ("S=250", (q, k, v, g), 0, None, n), ("S=250 valid_len=200", (q, k, v, g), 0, 200, n),
                ("S=496 block=16", (fq, fk, fv, fg), 16, None, BATCH)):
            s_len = qkvg[0].shape[1]
            cols = 16 if block else (valid or s_len)
            dumped = ak.philox_bits(seed, groups, HEADS, s_len)
            run(f"global dropout {case}", name,
                lambda: ak.global_attention_dropout(*qkvg[:3], seed, HEADS, block, valid, **drop),
                lambda: ak.global_attention_plain(*qkvg[:3], HEADS, block, valid, dumped, thr),
                kernel_tol, bound(4, qkvg[0].numel(), name, attn_flops(groups, s_len, cols, 2)),
                library=sdpa_drop if case == "S=250" else None)
            # Kernels 15 and 4 are one body with two mask sources: on the
            # dumped bytes they give the same bits, and each repeats itself.
            seeded, again = (ak.global_attention_dropout(*qkvg[:3], seed, HEADS, block, valid,
                                                         **drop) for _ in range(2))
            from_bits, bits_again = (ak.global_attention_dropout_bits(
                *qkvg[:3], dumped, HEADS, block, valid, **drop) for _ in range(2))
            same = (torch.equal(seeded, from_bits), torch.equal(seeded, again),
                    torch.equal(from_bits, bits_again))
            log(f"global dropout {case} {name}: seeded kernel = bits kernel on the dumped bytes "
                f"{same[0]}; the same inputs twice, identical bits {same[1]} (seeded), "
                f"{same[2]} (bits)")
            if not all(same):
                raise AssertionError(f"global dropout {case}: kernels 15 and 4 differ or do not "
                                     f"repeat bit for bit")
            del seeded, again, from_bits, bits_again
            run(f"global grads prng {case}", name,
                lambda: ak.global_attention_grads_prng(*qkvg[:3], seed, qkvg[3], HEADS, block,
                                                       valid, **drop),
                lambda: ak.global_attention_grads_plain(*qkvg, HEADS, block, valid, dumped, thr),
                grads_tol, bound(7, qkvg[0].numel(), name, attn_flops(groups, s_len, cols, 5)),
                library=(lambda: torch.autograd.grad(sdpa_drop_out, (q4, k4, v4), heads4(g),
                                                     retain_graph=True))
                if case == "S=250" else None)
        dumped = ak.philox_bits(seed, n, HEADS, 65)
        run("global grads prng S=65", name,
            lambda: ak.global_attention_grads_prng(rq, rk, rv, seed, rg, HEADS, **drop),
            lambda: ak.global_attention_grads_plain(rq, rk, rv, rg, HEADS, 0, None, dumped, thr),
            grads_tol, bound(7, rq.numel(), name, attn_flops(n, 65, 65, 5)))
        # Kernels 9 and 16 repeat bit for bit: no atomics, sums in a fixed order.
        for what, call in (
                ("", lambda: ak.global_attention_grads(q, k, v, g, HEADS)),
                (" bits", lambda: ak.global_attention_grads(q, k, v, g, HEADS, 0, None, bits, thr)),
                (" prng", lambda: ak.global_attention_grads_prng(q, k, v, seed, g, HEADS, **drop))):
            first, again = call(), call()
            same = all(torch.equal(a, b) for a, b in zip(first, again))
            log(f"global grads{what} S=250 {name}: the same inputs twice, identical bits {same}")
            if not same:
                raise AssertionError(f"global grads{what} does not repeat bit for bit")
            del first, again
        run("global dropout bits S=250", name,
            lambda: ak.global_attention_dropout_bits(q, k, v, bits, HEADS, **drop),
            lambda: ak.global_attention_plain(q, k, v, HEADS, 0, None, bits, thr), kernel_tol,
            bound(4, q.numel(), name, attn_flops(n, SEQ, SEQ, 2), extra_bytes=bits.numel()),
            library=sdpa_drop)
        # Only the bytes of columns below valid_len, or inside a row's block,
        # must move.
        run("global dropout bits S=250 valid_len=200", name,
            lambda: ak.global_attention_dropout_bits(q, k, v, bits, HEADS, 0, 200, **drop),
            lambda: ak.global_attention_plain(q, k, v, HEADS, 0, 200, bits, thr), kernel_tol,
            bound(4, q.numel(), name, attn_flops(n, SEQ, 200, 2),
                  extra_bytes=n * HEADS * SEQ * 200))
        gen = torch.Generator(device="cpu").manual_seed(42)
        fbits = torch.randint(0, 256, (BATCH, HEADS, 496, 496), generator=gen,
                              dtype=torch.uint8).cuda()
        run("global dropout bits S=496 block=16", name,
            lambda: ak.global_attention_dropout_bits(fq, fk, fv, fbits, HEADS, 16, **drop),
            lambda: ak.global_attention_plain(fq, fk, fv, HEADS, 16, None, fbits, thr),
            kernel_tol, bound(4, fq.numel(), name, attn_flops(BATCH, 496, 16, 2),
                              extra_bytes=BATCH * HEADS * 496 * 16))
        del fbits
        dumped_a, dumped_b = ak.two_phase_planes(ak.philox_bits(seed, n, 2 * HEADS, PADDED), HEADS)
        run("local dropout P=256", name,
            lambda: ak.local_two_phase_dropout(*ts[:5], seed, HEADS, 16, **drop),
            lambda: ak.local_two_phase_plain(*ts[:5], HEADS, 16, dumped_a, dumped_b, thr),
            kernel_tol, bound(6, ts[0].numel(), name, 2 * attn_flops(n, PADDED, 16, 2)))
        run("local grads prng P=256", name,
            lambda: ak.local_two_phase_grads_prng(*ts[:5], seed, ts[5], HEADS, 16, **drop),
            lambda: ak.local_two_phase_grads_plain(*ts, HEADS, 16, dumped_a, dumped_b, thr),
            grads_tol, bound(11, ts[0].numel(), name, 2 * attn_flops(n, PADDED, 16, 5)))
        dumped80 = ak.two_phase_planes(ak.philox_bits(seed, n, 2 * HEADS, 80), HEADS)
        run("local dropout P=80", name,
            lambda: ak.local_two_phase_dropout(*ts80[:5], seed, HEADS, 16, **drop),
            lambda: ak.local_two_phase_plain(*ts80[:5], HEADS, 16, *dumped80, thr),
            kernel_tol, bound(6, ts80[0].numel(), name, 2 * attn_flops(n, 80, 16, 2)))
        run("local grads prng P=80", name,
            lambda: ak.local_two_phase_grads_prng(*ts80[:5], seed, ts80[5], HEADS, 16, **drop),
            lambda: ak.local_two_phase_grads_plain(*ts80, HEADS, 16, *dumped80, thr),
            grads_tol, bound(11, ts80[0].numel(), name, 2 * attn_flops(n, 80, 16, 5)))
        gen = torch.Generator(device="cpu").manual_seed(41)
        bits_a, bits_b = (torch.randint(0, 256, (n, HEADS, PADDED, PADDED), generator=gen,
                                        dtype=torch.uint8).cuda() for _ in range(2))
        # Of the two (B, H, P, P) planes only the in-window bytes must move:
        # 16 per row, head and phase.
        window_bytes = 2 * n * HEADS * PADDED * 16
        run("local dropout bits P=256", name,
            lambda: ak.local_two_phase_dropout_bits(*ts[:5], bits_a, bits_b, HEADS, 16, **drop),
            lambda: ak.local_two_phase_plain(*ts[:5], HEADS, 16, bits_a, bits_b, thr),
            kernel_tol, bound(6, ts[0].numel(), name, 2 * attn_flops(n, PADDED, 16, 2),
                              extra_bytes=window_bytes))
        run("local grads bits P=256", name,
            lambda: ak.local_two_phase_grads_bits(*ts[:5], bits_a, bits_b, ts[5], HEADS, 16,
                                                  **drop),
            lambda: ak.local_two_phase_grads_plain(*ts, HEADS, 16, bits_a, bits_b, thr),
            grads_tol, bound(11, ts[0].numel(), name, 2 * attn_flops(n, PADDED, 16, 5),
                             extra_bytes=window_bytes))
        bits80 = [torch.randint(0, 256, (n, HEADS, 80, 80), generator=gen,
                                dtype=torch.uint8).cuda() for _ in range(2)]
        run("local grads bits P=80", name,
            lambda: ak.local_two_phase_grads_bits(*ts80[:5], *bits80, ts80[5], HEADS, 16, **drop),
            lambda: ak.local_two_phase_grads_plain(*ts80, HEADS, 16, *bits80, thr),
            grads_tol, bound(11, ts80[0].numel(), name, 2 * attn_flops(n, 80, 16, 5),
                             extra_bytes=2 * n * HEADS * 80 * 16))
        run("local dropout bits P=80", name,
            lambda: ak.local_two_phase_dropout_bits(*ts80[:5], *bits80, HEADS, 16, **drop),
            lambda: ak.local_two_phase_plain(*ts80[:5], HEADS, 16, *bits80, thr),
            kernel_tol, bound(6, ts80[0].numel(), name, 2 * attn_flops(n, 80, 16, 2),
                              extra_bytes=2 * n * HEADS * 80 * 16))
        # Kernels 2, 12 and 5 repeat bit for bit: no atomics, sums in a fixed order.
        for what, call in (
                ("", lambda: ak.local_two_phase(*ts[:5], HEADS, 16)),
                (" dropout", lambda: ak.local_two_phase_dropout(*ts[:5], seed, HEADS, 16, **drop)),
                (" dropout bits", lambda: ak.local_two_phase_dropout_bits(
                    *ts[:5], bits_a, bits_b, HEADS, 16, **drop))):
            same = torch.equal(call(), call())
            log(f"local{what} P=256 {name}: the same inputs twice, identical bits {same}")
            if not same:
                raise AssertionError(f"local{what} does not repeat bit for bit")
        # Kernels 7, 13 and 8 repeat bit for bit: no atomics, sums in a fixed order.
        for what, call in (
                ("", lambda: ak.local_two_phase_grads(*ts, HEADS, 16)),
                (" prng", lambda: ak.local_two_phase_grads_prng(*ts[:5], seed, ts[5], HEADS, 16,
                                                                **drop)),
                (" bits", lambda: ak.local_two_phase_grads_bits(*ts[:5], bits_a, bits_b, ts[5],
                                                                HEADS, 16, **drop))):
            first, again = call(), call()
            same = all(torch.equal(a, b) for a, b in zip(first, again))
            log(f"local grads{what} P=256 {name}: the same inputs twice, identical bits {same}")
            if not same:
                raise AssertionError(f"local grads{what} does not repeat bit for bit")
            del first, again
        del ts80, bits80, dumped80

        # The same seed twice gives the same bits of output; another seed does not.
        other = seed + 1
        for what, call in (
                ("global", lambda sd: ak.global_attention_dropout(q, k, v, sd, HEADS, **drop)),
                ("local", lambda sd: ak.local_two_phase_dropout(*ts[:5], sd, HEADS, 16, **drop))):
            same = torch.equal(call(seed), call(seed.clone()))
            differs = not torch.equal(call(seed), call(other))
            log(f"seeded {what} dropout {name}: same seed, same output {same}; another seed, "
                f"another output {differs}")
            if not (same and differs):
                raise AssertionError(f"seeded {what} dropout does not follow its seed")

    # Kernels 20 and 19: the ConvNeXt stage backward at the training shapes
    # (stages 5 and 6, 32 windows) and the stage forward at the serving shapes
    # (stages 4, 5, 6, 16 windows).  Operations: six (backward) or two
    # (forward) products of 2 R C H per block, R = B L rows.  Bytes: the rows
    # in and out once, the weights, and for the backward the fp32 gradients.
    # "Library": no one PyTorch call computes a stage; the time beside the
    # kernel is autograd through the plain block loop on the same tensors (the
    # path the backward kernel replaces) and the loop's forward under no_grad
    # -- many calls, not one.
    for name, dt in DTYPES.items():
        itemsize = 4 if name == "f32" else 2
        for stage, batch, backward in ((5, train_minibatch, True), (6, train_minibatch, True),
                                       ("tail", 3, True),
                                       (4, BATCH, False), (5, BATCH, False), (6, BATCH, False)):
            depth, l, c, hidden = STAGES[stage]
            stage_seed = 60 + stage if isinstance(stage, int) else 69
            carries, weights, dy = stage_operands(depth, batch, l, c, hidden, dt, seed=stage_seed)
            rows_flops = 2.0 * batch * l * c * hidden * depth
            weight_elems = sum(w.numel() for w in weights)
            stage_tol = lambda ref: grad_tol(ref, name, STAGE_TOL_BF16_ULPS[depth])
            x = carries[0].contiguous()
            if backward:
                flat = lambda out: (out[0], *out[1])   # (dx, grads) -> the nine outputs
                leaves = [t.clone().requires_grad_() for t in (x, *weights)]
                looped = ck.plain_stage(leaves[0], leaves[1:])
                run(f"stage bwd stage {stage} B={batch}", name,
                    lambda: flat(ck.stage_bwd(carries, weights, dy)),
                    lambda: flat(ck.stage_bwd_plain(carries, weights, dy)), stage_tol,
                    bound(depth + 2, dy.numel(), name, 6 * rows_flops,
                          extra_bytes=weight_elems * (itemsize + 4)),
                    library=lambda: torch.autograd.grad(looped, leaves, dy, retain_graph=True))
                first, again = (flat(ck.stage_bwd(carries, weights, dy)) for _ in range(2))
                same = all(torch.equal(a, b) for a, b in zip(first, again))
                log(f"stage bwd stage {stage} {name}: the same inputs twice, identical bits {same}")
                if not same:
                    raise AssertionError("the stage backward does not repeat bit for bit")
                del leaves, looped, first, again
            else:
                def loop_forward():
                    with torch.no_grad():
                        return ck.plain_stage(x, weights)
                run(f"stage fwd stage {stage} B={batch}", name,
                    lambda: ck.stage_fwd(x, weights), lambda: ck.stage_fwd_plain(x, weights),
                    stage_tol,
                    bound(2, x.numel(), name, 2 * rows_flops, extra_bytes=weight_elems * itemsize),
                    library=loop_forward)
                same = torch.equal(ck.stage_fwd(x, weights), ck.stage_fwd(x, weights))
                log(f"stage fwd stage {stage} {name}: the same inputs twice, identical bits {same}")
                if not same:
                    raise AssertionError("the stage forward does not repeat bit for bit")
            del carries, weights, dy, x
            torch.cuda.empty_cache()

    # Kernel 14: the dump kernel against the plain Philox, bytes equal, and the
    # keep rate of its bytes.  Its work is integer arithmetic, for which the
    # data sheet gives no rate: the bound is its output's bytes.  Library:
    # torch.randint of the same shape (another stream; timed only).
    seed = torch.tensor([123456789, -42], dtype=torch.int32, device="cuda")
    n = train_minibatch
    for case, samples, cores, p_len in (
            ("global S=250", n, HEADS, SEQ), ("local P=256", n, 2 * HEADS, PADDED),
            ("P=37", n, HEADS, 37), ("P=496", BATCH, HEADS, 496)):
        shape = (samples, cores, p_len, p_len)
        run(f"philox bits {case}", "uint8",
            lambda: ak.philox_bits(seed, samples, cores, p_len),
            lambda: ak.philox_bits_plain(seed, samples, cores, p_len), lambda ref: 0.0,
            {"bound_ms": math.prod(shape) / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"},
            library=lambda: torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda"))
        dumped = ak.philox_bits(seed, samples, cores, p_len)
        if not torch.equal(dumped.cpu(), ak.philox_bits_plain(seed.cpu(), samples, cores, p_len)):
            raise AssertionError("the card's mask bytes differ from the CPU's for one seed")
        keep, p_keep = (dumped >= DROPOUT_THRESHOLD).float().mean().item(), 1 - DROPOUT_THRESHOLD / 256
        sigma = math.sqrt(p_keep * (1 - p_keep) / dumped.numel())
        log(f"philox bits {case}: keep rate {keep:.6f} vs {p_keep:.6f}, "
            f"{abs(keep - p_keep) / sigma:.2f} sigma (limit 4)")
        if abs(keep - p_keep) > 4 * sigma:
            raise AssertionError("the mask bytes do not keep at 230/256")
    check_eventize(results)
    return results


def walk_probs(frames: int, seed: int, keys: int = 90) -> np.ndarray:
    """Seeded random-walk probabilities that cross every eventizer threshold."""
    rng = np.random.default_rng(seed)
    logits = np.cumsum(rng.standard_normal((frames, keys)) * 0.8, axis=0)
    return (1 / (1 + np.exp(-(logits - logits.mean(0))))).astype(np.float32)


def check_eventize(results: dict) -> None:
    """Phase 2, the eventizer's kernel (csrc/eventize.cu: it takes the place
    of the JAX package's lax.scan over frames, not of a Pallas kernel) on a
    seeded 15,000 x 90 array -- 300 s of audio -- against its plain version,
    the numpy eventizer: the five dense arrays bit for bit, and the event
    lists.  Times: the kernel by CUDA events; the plain version, which runs
    on the host, by the host's clock over 3 calls; extract_events on the
    card (kernel, the fired cells gathered into a table, the table and the
    final state fetched) by the host's clock.  Bound: p read and the dense
    arrays written once over the memory rate -- the chain over frames sets
    the kernel's floor, not a roof.  No one PyTorch call computes it."""
    from audio_to_midi_tpu_torch.ops import eventize as ev

    p = walk_probs(EVENT_FRAMES, seed=15)
    pc = torch.from_numpy(p).cuda()
    out, ref = ev.eventize(pc), ev.extract_events_dense_plain(p)
    torch.cuda.synchronize()
    same = all(torch.equal(o.cpu(), torch.from_numpy(r)) for o, r in zip(out, ref))
    events, host_events = ev.extract_events(pc), ev.extract_events(p)
    ms = time_ms(lambda: ev.eventize(pc))
    t0 = time.perf_counter()
    for _ in range(3):
        ev.extract_events_dense_plain(p)
    plain_ms = (time.perf_counter() - t0) / 3 * 1e3
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.extract_events(pc)
        walls.append((time.perf_counter() - t0) * 1e3)
    frames, keys = p.shape
    moved = frames * keys * (4 + 1 + 4 + 4) + keys * (1 + 4)  # p; fired, attack, duration; final
    bound_ = {"bound_ms": moved / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
              "p_only_ms": p.nbytes / PEAK_BYTES_PER_S * 1e3}
    log(f"kernel eventize N={frames} x {keys} f32: dense arrays identical to the plain version's "
        f"{same}, event lists identical {events == host_events} ({len(events)} events); kernel "
        f"{ms:.4f} ms, plain (numpy, host clock) {plain_ms:.2f} ms, extract_events on the card "
        f"(kernel, table, fetch) median {sorted(walls)[5]:.3f} ms of 10; bound "
        f"{bound_['bound_ms']:.4f} ms by bytes (p alone {bound_['p_only_ms']:.4f} ms)")
    if not same or events != host_events:
        raise AssertionError("the eventize kernel disagrees with the numpy eventizer")
    results[f"eventize N={frames} f32"] = {"err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                           "library_ms": None,
                                           "extract_events_ms": sorted(walls)[5], **bound_}


def check_fused_kernels(flk, model_lib, cfg) -> dict[str, dict]:
    """Phase 2, kernels 11, 18 and 17 at the serving shapes: 16 windows, S =
    250 -> P = 256 (pad_l 3), D = 256, 4 heads x 64, kv 64, FFN 512, one
    seeded pair with its LayerNorms off the identity.  Operations: the
    products, 2 R (D W + D C + 2 C W + W D) for R rows (+ 6 R D I for the two
    FFN products), and the attention's two products over the keys each row
    sees (16 per window; S global columns).  Bytes: x in and out once, the
    weights.  "Library": the same layer by the default "pallas" route on the
    same tensors (torch LayerNorm and products, kernels 1 and 2) -- many
    calls, not one."""
    import torch.nn.functional as F

    from audio_to_midi_tpu_torch.models import attention as attn_lib
    from audio_to_midi_tpu_torch.models import nn as a2m_nn
    from audio_to_midi_tpu_torch.models import transformer as tf_lib

    c = cfg.model
    results = {}
    run = functools.partial(run_case, results)
    gen = torch.Generator().manual_seed(71)
    pair = tf_lib.AlternatingLayer(c, gen)
    with torch.no_grad():
        for pname, prm in pair.named_parameters():
            if "norm" in pname:
                prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
    pair = pair.cuda()
    local, global_ = pair.get_submodule("local"), pair.get_submodule("global")
    rope = model_lib.make_rope(c, "cuda")
    window = c.local_context_window
    pad_l, pad_r = attn_lib._local_padding(SEQ, window)
    tables = tf_lib._pair_rope_tables(rope, c, PADDED, pad_l)
    d, width = c.transformer_hidden_dim, HEADS * HEAD_DIM
    ckv, inter = c.compressed_attention_kv_size, c.transformer_intermediate_size
    proj = 2.0 * (d * width + d * ckv + 2 * ckv * width + width * d)     # per row
    ffn = 6.0 * d * inter                                                # per row
    local_attn = (PADDED // (window // 2) - 1) * window * window * 4.0 * width  # per sample
    global_attn = lambda rows, cols: 4.0 * rows * cols * width                 # per sample
    geometry = dict(num_heads=HEADS, valid_len=SEQ, pad_l=pad_l)
    with torch.no_grad():
        for name, dt in DTYPES.items():
            itemsize = 4 if name == "f32" else 2
            tol = lambda ref: fused_tol(ref, name)
            x = randn(BATCH, SEQ, d, seed=72, dtype=dt)
            xp = F.pad(x, (0, 0, pad_l, pad_r))
            att = local.attention
            ws = [lin.w.to(dt) for lin in (att.q_up, att.kv_down, att.k_up, att.v_up, att.out)]
            wbytes = sum(w.numel() for w in ws) * itemsize
            cos_w, sin_w = attn_lib._rope_tables(rope, (PADDED // (window // 2) - 1) * window,
                                                 window)
            run("attention block local P=256", name,
                lambda: flk.attention_block(xp, *ws, cos_w, sin_w, HEADS, PADDED, window),
                lambda: flk.attention_block_plain(xp, *ws, cos_w, sin_w, HEADS, PADDED, window),
                tol, bound(2, xp.numel(), name, BATCH * (PADDED * proj + local_attn),
                           extra_bytes=wbytes),
                library=lambda: attn_lib.local_self_attention(x, att, rope, c))
            cos_g, sin_g = attn_lib._rope_tables(rope, SEQ, 0)
            run("attention block global S=250", name,
                lambda: flk.attention_block(x, *ws, cos_g, sin_g, HEADS, SEQ, 0),
                lambda: flk.attention_block_plain(x, *ws, cos_g, sin_g, HEADS, SEQ, 0),
                tol, bound(2, x.numel(), name, BATCH * (SEQ * proj + global_attn(SEQ, SEQ)),
                           extra_bytes=wbytes),
                library=lambda: attn_lib.self_attention(x, att, rope, c))

            def sublayer_library(layer, attend):
                normed = a2m_nn.layer_norm(x, layer.attention_norm.scale,
                                           layer.attention_norm.bias)
                return x + attend(normed, layer.attention, rope, c)

            for side, layer, case_tables, attn_flops, attend in (
                    ("local", local, tables[:4], local_attn, attn_lib.local_self_attention),
                    ("global", global_, tables[4:], global_attn(PADDED, SEQ),
                     attn_lib.self_attention)):
                sw = flk.sublayer_weights(layer, dt)
                kernel = flk.fused_local_sublayer if side == "local" else flk.fused_global_sublayer
                extra = dict(window=window) if side == "local" else {}
                plain_window = window if side == "local" else 0
                run(f"fused {side} sublayer P=256", name,
                    lambda: kernel(xp, sw, case_tables, **extra, **geometry),
                    lambda: flk.fused_sublayer_plain(xp, sw, case_tables, window=plain_window,
                                                     **geometry),
                    tol, bound(2, xp.numel(), name, BATCH * (PADDED * proj + attn_flops),
                               extra_bytes=wbytes + 2 * d * 4),
                    library=lambda: sublayer_library(layer, attend))
            pw = flk.pair_weights(pair, dt)
            pair_flops = BATCH * (PADDED * (2 * proj + 2 * ffn) + local_attn
                                  + global_attn(PADDED, SEQ))
            run("transformer pair P=256", name,
                lambda: flk.transformer_pair(xp, pw, tables, window=window, **geometry),
                lambda: flk.transformer_pair_plain(xp, pw, tables, window=window, **geometry),
                tol, bound(2, xp.numel(), name, pair_flops,
                           extra_bytes=sum(w.numel() * w.element_size() for w in pw)),
                library=lambda: tf_lib.alternating_layer(x, pair, rope, c))
            first, again = (flk.transformer_pair(xp, pw, tables, window=window, **geometry)
                            for _ in range(2))
            rows_zero = not first[:, :pad_l].any() and not first[:, pad_l + SEQ:].any()
            log(f"transformer pair {name}: the same inputs twice, identical bits "
                f"{torch.equal(first, again)}; rows outside the sequence zero {rows_zero}")
            if not (torch.equal(first, again) and rows_zero):
                raise AssertionError("the pair kernel does not repeat or leaves padding rows")
    return results


def check_forward(model_lib, cfg, model) -> None:
    """Phase 3: full-width forward, kernel path vs plain path, 8 launches."""
    from audio_to_midi_tpu_torch.infer import _parity_precision

    plain_cfg = dataclasses.replace(cfg.model, attention_impl="xla")
    rope = model_lib.make_rope(cfg.model, "cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    audio = (torch.randn(BATCH, 2, 80_000, generator=gen) * 0.5).cuda()
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        m = model if dt == torch.float32 else model_lib.cast_params(copy.deepcopy(model), dt)
        x = audio.to(dt)
        with torch.inference_mode(), _parity_precision(dt):
            reset_launches()
            t0 = time.perf_counter()
            _, probs = model_lib.forward(m, cfg.model, x, rope)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = list(read_launches().values())
            _, ref = model_lib.forward(m, plain_cfg, x, rope)
        err = max_err(probs, ref)
        ok = (tuple(probs.shape) == (BATCH, SEQ, cfg.model.output_vocab)
              and bool(torch.isfinite(probs.float()).all()) and err <= FORWARD_TOL[name])
        log(f"forward {name} {tuple(x.shape)} -> {tuple(probs.shape)}: kernel vs plain "
            f"max_abs_err {err:.3e} (tol {FORWARD_TOL[name]:.0e}), launches "
            f"{dict(zip(read_launches(), launches))}, "
            f"first-call wall {wall:.3f} s {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} forward: kernel path disagrees with the plain path")
        # No backward, no dropout and (cnn_impl="pallas") no stage kernel in serving.
        expected = [cfg.model.num_transformer_layers] * 2 + [0] * (len(launches) - 2)
        if launches != expected:
            raise AssertionError(f"{name} forward launched {launches}, expected {expected}")
        if name == "f32":
            log(f"forward f32 probs mean {probs.mean().item():.4f} "
                f"min {probs.min().item():.4f} max {probs.max().item():.4f}")


def synth_audio(seconds: float, rate: int, seed: int) -> np.ndarray:
    """Stereo decaying sines at a few piano pitches, one note every 0.5 s,
    each summed over the 10 s after its start (its envelope exp(-3 t) is
    then 1e-13, below what float32 keeps)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    out = np.zeros((2, n), np.float64)
    for start in np.arange(0.0, seconds - 1.0, 0.5):
        key = int(rng.integers(30, 70))  # piano key index (MIDI key - 21)
        freq = 440.0 * 2 ** ((key + 21 - 69) / 12)
        span = slice(int(np.searchsorted(t, start)), int(np.searchsorted(t, start + 10.0)))
        since = t[span] - start
        tone = np.exp(-since * 3.0) * np.sin(2 * np.pi * freq * since)
        pan = rng.uniform(0.3, 0.7)
        out[0, span] += pan * tone
        out[1, span] += (1 - pan) * tone
    return (0.5 * out / np.abs(out).max()).astype(np.float32)


def end_to_end(model_lib, cfg, model, card: str) -> dict[str, int]:
    """Phase 4: WAV -> CLI -> MIDI; returns the launches of that run."""
    from audio_to_midi_tpu_torch import convert
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main as cli_main
    from audio_to_midi_tpu_torch.data.audio_io import write_wav
    from audio_to_midi_tpu_torch.infer import transcribe_file
    from audio_to_midi_tpu_torch.ops.midi_io import read_midi_file

    WORK.mkdir(parents=True, exist_ok=True)
    wav, ckpt, mid = WORK / "synth.wav", WORK / "params.npz", WORK / "out.mid"
    write_wav(wav, synth_audio(30.0, cfg.data.sample_rate, seed=2), cfg.data.sample_rate)
    convert.save_npz(ckpt, convert.state_dict_to_jax(model.state_dict()))

    reset_launches()
    captured = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = cli_main([str(wav), str(mid), "--checkpoint", str(ckpt)])
    torch.cuda.synchronize()
    cli_wall = time.perf_counter() - t0
    launches = read_launches()
    cli_out = captured.getvalue()
    log("cli: " + " | ".join(cli_out.strip().splitlines()))
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    n_events = int(cli_out.split("Extracted ")[1].split()[0])

    midi = read_midi_file(mid)
    ons = sum(1 for e in midi if e[1] == "note_on")
    offs = sum(1 for e in midi if e[1] == "note_off")
    metas = {e[1] for e in midi if e[1].startswith("meta_")}
    log(f"midi: {mid.name} {mid.stat().st_size} bytes, {ons} note_on, {offs} note_off, "
        f"metas {sorted(metas)}")
    if ons != n_events or offs != n_events or not {"meta_51", "meta_58"} <= metas:
        raise AssertionError("MIDI read back does not hold the events the CLI extracted")

    # The same file through the kernel path (warm) and the plain path.
    from audio_to_midi_tpu_torch.infer import load_params

    m32 = load_params(ckpt, cfg, "cuda", torch.float32)
    t0 = time.perf_counter()
    stitched, _dpf, events = transcribe_file(m32, cfg, wav)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attention_impl="xla"))
    ref, _, ref_events = transcribe_file(m32, plain_cfg, wav)
    err = float(np.abs(stitched - ref).max())
    near = min(float(np.abs(ref - t).min()) for t in EVENT_THRESHOLDS)
    log(f"transcribe: stitched {stitched.shape}, {len(events)} events, kernel vs plain "
        f"stitched max_abs_err {err:.3e} (tol {FORWARD_TOL['f32']:.0e}), events identical "
        f"{events == ref_events} (closest prob to a threshold {near:.2e})")
    if stitched.shape[1] != cfg.model.output_vocab or not np.isfinite(stitched).all():
        raise AssertionError("stitched probabilities are not finite (frames, 90)")
    if err > FORWARD_TOL["f32"]:
        raise AssertionError("end-to-end kernel path disagrees with the plain path")
    if near > FORWARD_TOL["f32"] and events != ref_events:
        raise AssertionError("events differ though no probability is near a threshold")
    if len(events) != n_events:
        raise AssertionError("the CLI and transcribe_file extracted different events")
    audio_s = 30.0
    log(f"e2e wall: CLI {cli_wall:.3f} s (cold: checkpoint load + first call), "
        f"transcribe_file {warm_wall:.3f} s warm for {audio_s:.0f} s of audio "
        f"({audio_s / warm_wall:.1f}x realtime), f32, on {card}")
    return launches


def seeded_model(model_lib, cfg):
    """The default model on the card, its weights from seed 0."""
    return model_lib.Model(cfg.model, torch.Generator().manual_seed(0)).cuda().eval()


def training_setup(model_lib, cfg, model, dropout_rate: float, cnn_bwd_kernel: bool):
    """A training phase's configuration, batch and step, for ``model``:
    (train_cfg, rope, optimizer, step, audio, labels).

    At ``dropout_rate`` 0 the attention routes take the dropout-free kernels
    and their backward kernels, above 0 the seeded dropout kernels.  With
    ``cnn_bwd_kernel`` the ConvNeXt stages 5 and 6 take the fused stage
    backward, without it ordinary autograd (the counterpart of the scanned
    backward); at the configuration's own rate with it, the model
    configuration is the default, untouched.  No warm-up, so the first update
    is not zero.  One seeded batch of ``cfg.train.batch_size`` windows in
    minibatches of ``minibatch_size_per_device``, labels sparse as piano
    rolls are."""
    from audio_to_midi_tpu_torch.train import optim, step as step_lib

    train_cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, warmup_steps=0),
        model=dataclasses.replace(cfg.model, transformer_dropout_rate=dropout_rate,
                                  cnn_bwd_kernel=cnn_bwd_kernel))
    rope = model_lib.make_rope(train_cfg.model, "cuda")
    batch, minibatch = train_cfg.train.batch_size, train_cfg.train.minibatch_size_per_device
    gen = torch.Generator(device="cpu").manual_seed(4)
    audio = step_lib.reshape_to_minibatches(
        (torch.randn(batch, 2, 80_000, generator=gen) * 0.5).cuda(), minibatch)
    labels = step_lib.reshape_to_minibatches(
        (torch.rand(batch, SEQ, train_cfg.model.output_vocab, generator=gen) < 0.03)
        .float().cuda(), minibatch)
    optimizer = optim.setup_optimizers(model, train_cfg.model, train_cfg.train)
    step = step_lib.make_train_step(train_cfg, optimizer, rope)
    return train_cfg, rope, optimizer, step, audio, labels


def check_training(model_lib, cfg, model, card: str) -> dict[str, int]:
    """Phase 5: a few optimizer steps at full width; returns their launches."""
    from audio_to_midi_tpu_torch.infer import _parity_precision
    from audio_to_midi_tpu_torch.train import loss as loss_lib

    train_cfg, rope, optimizer, step, audio, labels = training_setup(
        model_lib, cfg, model, dropout_rate=0.0, cnn_bwd_kernel=False)
    train_model_cfg = train_cfg.model
    names = list(read_launches())

    # f32 gradients of one minibatch of 4 windows, kernel path vs plain path.
    gen = torch.Generator(device="cpu").manual_seed(3)
    audio4 = (torch.randn(4, 2, 80_000, generator=gen) * 0.5).cuda()
    labels4 = (torch.rand(4, SEQ, 90, generator=gen) < 0.03).float().cuda()
    with _parity_precision(torch.float32):
        grads = {impl: model_grads(model, loss_lib,
                                   dataclasses.replace(train_model_cfg, attention_impl=impl),
                                   audio4, labels4, rope)
                 for impl in ("pallas", "xla")}
    compare_model_grads(grads, "")
    del grads

    # The bf16 loss of one training minibatch, kernel path vs plain path:
    # the forward kernels at the shapes and in the dtype the steps give them.
    bf16_loss = {}
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            impl_cfg = dataclasses.replace(train_model_cfg, attention_impl=impl)
            bf16_loss[impl] = loss_lib.batch_loss(model, impl_cfg, audio[0], labels[0], rope, 1.0,
                                                  torch.bfloat16).item()
    rel = abs(bf16_loss["pallas"] - bf16_loss["xla"]) / abs(bf16_loss["xla"])
    ok = np.isfinite(bf16_loss["pallas"]) and rel <= LOSS_TOL_BF16
    log(f"bf16 loss, {audio.shape[1]} windows, kernel path {bf16_loss['pallas']:.2f} vs plain "
        f"path {bf16_loss['xla']:.2f}: relative difference {rel:.3e} (tol {LOSS_TOL_BF16:.0e}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the kernel path's bf16 loss disagrees with the plain path's")

    # The steps: bf16 compute over f32 parameters, batch 64 = 2 x 32.
    # Each of the 8 pairs holds one local and one global layer.
    per_step = train_model_cfg.num_transformer_layers * audio.shape[0]
    expected = dict.fromkeys(names, 0) | dict.fromkeys(names[:4], per_step)
    total, losses, times, peak = run_steps("train step", step, model, optimizer, audio, labels,
                                           TRAIN_STEPS, expected)

    # The guard on the card: a step on labels that hold a nan changes neither
    # the parameters nor the optimizer's moments and count.
    before = [t.clone() for t in optimizer.params + optimizer.mu + optimizer.nu]
    count = optimizer.count
    bad = labels.clone()
    bad[0, 0, 0, 0] = float("nan")
    out = step(model, audio, bad, 1.0)
    same = all(torch.equal(a, b)
               for a, b in zip(before, optimizer.params + optimizer.mu + optimizer.nu))
    log(f"train step on a nan label: grads_valid {bool(out.grads_valid)}, parameters, moments "
        f"and count unchanged {same and optimizer.count == count}")
    if bool(out.grads_valid) or not same or optimizer.count != count:
        raise AssertionError("a step with a non-finite loss was applied")
    del before

    summary = step_summary(times, peak)
    log(f"training: batch {audio.shape[0] * audio.shape[1]} = {audio.shape[0]} x "
        f"{audio.shape[1]}, bf16 compute, f32 params, dropout-free, {summary}, "
        f"losses {losses[0]:.1f} -> {losses[-1]:.1f}, on {card}")
    return total, summary


def step_summary(times: list[float], peak: int) -> str:
    later = sorted(times[1:])
    return (f"{later[len(later) // 2]:.1f} ms/step (median of the last {len(later)}, range "
            f"{later[0]:.1f}-{later[-1]:.1f}; first {times[0]:.1f}), "
            f"peak memory {peak / 2**30:.2f} GiB")


def run_steps(label, step, model, optimizer, audio, labels, steps, expected,
              generator=None):
    """Takes ``steps`` optimizer steps; every step must be valid and launch
    exactly ``expected`` (wrapper name -> launches per step), and the loss
    must fall.  Returns (total launches, losses, ms per step, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = dict.fromkeys(expected, 0)
    losses, times = [], []
    for i in range(steps):
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(model, audio, labels, 1.0, generator)
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        losses.append(out.loss.item())
        times.append(start.elapsed_time(end))
        launched = {n: c for n, c in launches.items() if c}
        log(f"{label} {i}: loss {losses[-1]:.3f}, grads_valid {bool(out.grads_valid)}, "
            f"lr {optimizer.learning_rate():.3e}, {times[-1]:.1f} ms, launches {launched}")
        if not bool(out.grads_valid) or not np.isfinite(losses[-1]):
            raise AssertionError(f"{label} {i}: loss or gradients not finite")
        if launches != expected:
            raise AssertionError(f"{label} {i} launched {launches}, expected {expected}")
        for n, count in launches.items():
            total[n] += count
    if steps > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over {steps} steps: {losses}")
    return total, losses, times, torch.cuda.max_memory_allocated()


def model_grads(model, loss_lib, model_cfg, audio, labels, rope, seed=None) -> dict:
    """The f32 parameter gradients of one minibatch, by name; with ``seed``,
    dropout on from a generator on the card seeded with it."""
    for p in model.parameters():
        p.grad = None
    gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
    with torch.enable_grad():
        loss_lib.batch_loss(model, model_cfg, audio, labels, rope, 1.0, torch.float32,
                            generator=gen).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return grads


def compare_model_grads(grads: dict, what: str) -> None:
    """Kernel path ("pallas") against plain path ("xla"), leaf by leaf."""
    worst, worst_name = 0.0, ""
    for n, ref in grads["xla"].items():
        rel = max_err(grads["pallas"][n], ref) / max(ref.abs().max().item(), 1e-30)
        if not torch.isfinite(grads["pallas"][n]).all():
            raise AssertionError(f"gradient of {n} is not finite")
        if rel > worst:
            worst, worst_name = rel, n
    ok = worst <= MODEL_GRAD_TOL
    log(f"f32 gradients{what}, 4 windows, kernel path vs plain path over {len(grads['xla'])} "
        f"leaves: worst max_abs_err / max|ref| {worst:.3e} at {worst_name} "
        f"(tol {MODEL_GRAD_TOL:.0e}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the kernel path's gradient disagrees with the plain path's")


@contextlib.contextmanager
def seeded_dropout_by_plain(ak):
    """Inside the block, the seeded dropout wrappers that the "pallas" route
    calls are their plain versions on the plain Philox bytes of the same
    seed, differentiated by autograd: the plain comparator of phase 6 (the
    port has no switch for it; "xla" drops at the exact rate)."""
    real = ak.global_attention_dropout, ak.local_two_phase_dropout

    def global_plain(q, k, v, seed, num_heads, block=0, valid_len=None, *, threshold):
        bits = ak.philox_bits_plain(seed, q.shape[0], num_heads, q.shape[1])
        return ak.global_attention_plain(q, k, v, num_heads, block, valid_len, bits, threshold)

    def local_plain(qa, ka, qb, kb, v, seed, num_heads, window, *, threshold):
        planes = ak.two_phase_planes(
            ak.philox_bits_plain(seed, qa.shape[0], 2 * num_heads, qa.shape[1]), num_heads)
        return ak.local_two_phase_plain(qa, ka, qb, kb, v, num_heads, window, *planes, threshold)

    ak.global_attention_dropout, ak.local_two_phase_dropout = global_plain, local_plain
    try:
        yield
    finally:
        ak.global_attention_dropout, ak.local_two_phase_dropout = real


def check_training_dropout(ak, model_lib, cfg, model, card: str, dropout_free: str):
    """Phase 6: the reference-parity step, with dropout; returns the launches
    of its steps by the seeded route and by the precomputed-bits route."""
    import os

    from audio_to_midi_tpu_torch.infer import _parity_precision
    from audio_to_midi_tpu_torch.train import loss as loss_lib

    rate = cfg.model.transformer_dropout_rate
    if ak.dropout_threshold(rate) != DROPOUT_THRESHOLD:
        raise AssertionError(f"the default rate {rate} no longer quantizes to {DROPOUT_THRESHOLD}")
    names = list(read_launches())
    start_state = copy.deepcopy(model.state_dict())

    # f32 gradients of one minibatch of 4 windows under one seed: forward and
    # backward kernels must apply the mask the plain versions draw for it.
    train_cfg, rope, *_ = training_setup(model_lib, cfg, model, rate, cnn_bwd_kernel=False)
    gen = torch.Generator(device="cpu").manual_seed(3)
    audio4 = (torch.randn(4, 2, 80_000, generator=gen) * 0.5).cuda()
    labels4 = (torch.rand(4, SEQ, 90, generator=gen) < 0.03).float().cuda()
    with _parity_precision(torch.float32):
        grads = {"pallas": model_grads(model, loss_lib, train_cfg.model, audio4, labels4, rope,
                                       seed=11)}
        with seeded_dropout_by_plain(ak):
            grads["xla"] = model_grads(model, loss_lib, train_cfg.model, audio4, labels4, rope,
                                       seed=11)
        free = model_grads(model, loss_lib, train_cfg.model, audio4, labels4, rope, seed=12)
    compare_model_grads(grads, " with dropout 0.1 under one seed")
    moved = max(max_err(free[n], g) / max(g.abs().max().item(), 1e-30)
                for n, g in grads["pallas"].items())
    log(f"f32 gradients under another seed differ by up to {moved:.3e} of a leaf's largest")
    if moved <= 100 * MODEL_GRAD_TOL:
        raise AssertionError("another seed gave the same gradients: nothing was dropped")
    del grads, free

    # The steps, twice from the same state and the same seed.
    per_step = train_cfg.model.num_transformer_layers * 2  # two minibatches
    seeded = ["global_attention_dropout", "local_two_phase_dropout",
              "global_attention_grads_prng", "local_two_phase_grads_prng"]
    expected = dict.fromkeys(names, 0) | dict.fromkeys(seeded, per_step)
    runs = []
    for attempt in ("train step (dropout 0.1)", "the same again"):
        model.load_state_dict(start_state)
        _, _, optimizer, step, audio, labels = training_setup(model_lib, cfg, model, rate,
                                                              cnn_bwd_kernel=False)
        runs.append(run_steps(attempt, step, model, optimizer, audio, labels, TRAIN_STEPS,
                              expected, torch.Generator().manual_seed(7)))
    (total, losses, times, peak), (_, again, _, _) = runs
    log(f"rerun from the same state and seed: losses {again} "
        f"{'identical' if again == losses else 'DIFFER from ' + str(losses)}")
    if again != losses:
        raise AssertionError("the same state and seed did not give the same step")

    # One step by the precomputed-bits route from that start: the dump kernel
    # writes the bytes of each seed and the bits kernels read them, so the
    # loss is the seeded route's first loss.
    model.load_state_dict(start_state)
    _, _, optimizer, step, audio, labels = training_setup(model_lib, cfg, model, rate,
                                                          cnn_bwd_kernel=False)
    bits_route = {"philox_bits": 2 * per_step, "global_attention_dropout_bits": per_step,
                  "local_two_phase_dropout_bits": per_step, "global_attention_grads": per_step,
                  "local_two_phase_grads_bits": per_step}
    os.environ["A2M_PRNG_DROPOUT"] = "0"
    try:
        bits_total, bits_losses, _, bits_peak = run_steps(
            "train step (dropout 0.1, precomputed bits)", step, model, optimizer, audio, labels,
            1, dict.fromkeys(names, 0) | bits_route, torch.Generator().manual_seed(7))
    finally:
        del os.environ["A2M_PRNG_DROPOUT"]
    log(f"precomputed-bits route: loss {bits_losses[0]!r} vs seeded route {losses[0]!r}, "
        f"peak memory {bits_peak / 2**30:.2f} GiB")
    if bits_losses[0] != losses[0]:
        raise AssertionError("the bits route and the seeded route disagree on one seed")

    summary = step_summary(times, peak)
    log(f"training with dropout {rate}: batch {audio.shape[0] * audio.shape[1]} = "
        f"{audio.shape[0]} x {audio.shape[1]}, bf16 compute, f32 params, "
        f"{summary}, losses {losses[0]:.1f} -> {losses[-1]:.1f}, on {card}")
    log(f"  beside the dropout-free step: {dropout_free}")
    return total, bits_total, losses, summary


def check_training_default(model_lib, cfg, model, card: str, autograd_losses, autograd: str):
    """Phase 7: the default configuration as it stands -- the ConvNeXt stage
    backward in stages 5 and 6, dropout 0.1; returns the launches of its
    steps.  ``autograd_losses`` and ``autograd``: phase 6's losses and
    summary (the same step with autograd through the ConvNeXt blocks)."""
    from audio_to_midi_tpu_torch.infer import _parity_precision
    from audio_to_midi_tpu_torch.train import loss as loss_lib

    rate = cfg.model.transformer_dropout_rate
    names = list(read_launches())
    start_state = copy.deepcopy(model.state_dict())
    train_cfg, rope, *_ = training_setup(model_lib, cfg, model, rate, cnn_bwd_kernel=True)
    if train_cfg.model != cfg.model:
        raise AssertionError("phase 7 must train the default model configuration, untouched")

    # f32 gradients of one minibatch of 4 windows under one seed: the stage
    # backward kernel (cnn_impl "pallas") against autograd through the blocks
    # ("xla"), every other kernel the same on both sides.
    gen = torch.Generator(device="cpu").manual_seed(3)
    audio4 = (torch.randn(4, 2, 80_000, generator=gen) * 0.5).cuda()
    labels4 = (torch.rand(4, SEQ, 90, generator=gen) < 0.03).float().cuda()
    reset_launches()
    with _parity_precision(torch.float32):
        grads = {impl: model_grads(model, loss_lib,
                                   dataclasses.replace(train_cfg.model, cnn_impl=impl),
                                   audio4, labels4, rope, seed=11)
                 for impl in ("pallas", "xla")}
    if read_launches()["stage_bwd"] != 2:
        raise AssertionError(f"the f32 gradients launched {read_launches()}, expected 2 stage_bwd")
    compare_model_grads(grads, " with the stage backward kernel (cnn_impl pallas vs xla)")
    del grads

    # The steps, twice from the same state and the same seed: stages 5 and 6
    # of two minibatches, and the seeded dropout kernels as in phase 6.
    per_step = train_cfg.model.num_transformer_layers * 2
    seeded = ["global_attention_dropout", "local_two_phase_dropout",
              "global_attention_grads_prng", "local_two_phase_grads_prng"]
    expected = dict.fromkeys(names, 0) | dict.fromkeys(seeded, per_step) | {"stage_bwd": 4}
    runs = []
    for attempt in ("train step (default config)", "the same again"):
        model.load_state_dict(start_state)
        _, _, optimizer, step, audio, labels = training_setup(model_lib, cfg, model, rate,
                                                              cnn_bwd_kernel=True)
        runs.append(run_steps(attempt, step, model, optimizer, audio, labels, TRAIN_STEPS,
                              expected, torch.Generator().manual_seed(7)))
    (total, losses, times, peak), (_, again, _, _) = runs
    log(f"rerun from the same state and seed: losses {again} "
        f"{'identical' if again == losses else 'DIFFER from ' + str(losses)}")
    if again != losses:
        raise AssertionError("the same state and seed did not give the same step")
    # The forward is the same block loop with or without the kernel, so the
    # first loss (before any update) is phase 6's, bit for bit.
    log(f"first loss {losses[0]!r} vs {autograd_losses[0]!r} with autograd through the blocks")
    if losses[0] != autograd_losses[0]:
        raise AssertionError("the stage backward kernel changed the forward's loss")
    log(f"training, default config (cnn_bwd_kernel=True, dropout {rate}): batch "
        f"{audio.shape[0] * audio.shape[1]} = {audio.shape[0]} x {audio.shape[1]}, bf16 compute, "
        f"f32 params, {step_summary(times, peak)}, losses {losses[0]:.1f} -> {losses[-1]:.1f} "
        f"(autograd through the blocks: {autograd_losses[0]:.1f} -> {autograd_losses[-1]:.1f}), "
        f"on {card}")
    log(f"  beside the same step with cnn_bwd_kernel=False: {autograd}")
    return total


def check_stage_serving(model_lib, cfg, model, card: str) -> dict[str, int]:
    """Phase 8: serving with cnn_impl="pallas_stage" -- the stage forward
    kernel in stages 4, 5 and 6; returns the launches of one
    predict_and_stitch."""
    from audio_to_midi_tpu_torch.infer import _parity_precision, predict_and_stitch

    def with_cnn(impl):
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cnn_impl=impl))

    gen = torch.Generator(device="cpu").manual_seed(5)
    windows = torch.randn(BATCH, 2, 80_000, generator=gen) * 0.5
    total = dict.fromkeys(read_launches(), 0)
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        m = model if dt == torch.float32 else model_lib.cast_params(copy.deepcopy(model), dt)
        reset_launches()
        probs, stitched, _ = predict_and_stitch(m, with_cnn("pallas_stage"), windows, 5.0, 0.5)
        launches = read_launches()
        _, ref, _ = predict_and_stitch(m, with_cnn("xla"), windows, 5.0, 0.5)
        err = float(np.abs(stitched - ref).max())
        layers = cfg.model.num_transformer_layers
        expected = dict.fromkeys(launches, 0) | {"global_attention": layers,
                                                 "local_two_phase": layers, "stage_fwd": 3}
        ok = (probs.shape == (BATCH, SEQ, cfg.model.output_vocab) and stitched.shape[1] == 90
              and np.isfinite(stitched).all() and err <= FORWARD_TOL[name])
        log(f"pallas_stage serving {name}: {BATCH} windows -> stitched {stitched.shape}, vs the "
            f"cnn_impl=xla path max_abs_err {err:.3e} (tol {FORWARD_TOL[name]:.0e}), launches "
            f"{ {n: c for n, c in launches.items() if c} } {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} pallas_stage serving disagrees with the plain path")
        if launches != expected:
            raise AssertionError(f"pallas_stage serving launched {launches}, expected {expected}")
        for n, c in launches.items():
            total[n] += c
        # ms per forward, the stage kernel beside the default path, in turns.
        rope = model_lib.make_rope(cfg.model, "cuda")
        for batch in TIMED_BATCHES:
            x = (torch.randn(batch, 2, 80_000, generator=gen) * 0.5).to(device="cuda", dtype=dt)
            times = {}
            with torch.inference_mode(), _parity_precision(dt):
                for impl in ("pallas", "pallas_stage", "pallas_stage", "pallas"):
                    model_cfg = with_cnn(impl).model
                    ms = time_ms(lambda: model_lib.forward(m, model_cfg, x, rope), iters=5,
                                 warmup=2)
                    times.setdefault(impl, []).append(ms)
            shown = {impl: " / ".join(f"{t:.2f}" for t in ms) for impl, ms in times.items()}
            log(f"forward {name}, {batch} windows: cnn_impl=pallas {shown['pallas']} ms, "
                f"cnn_impl=pallas_stage {shown['pallas_stage']} ms per forward, on {card}")

    # At init gamma is 1e-6, and a block's branch all but vanishes beside its
    # residual.  With gamma 0.1 in the three stages the kernel's branches
    # reach the output: f32 again, against the plain path.
    scaled = copy.deepcopy(model)
    with torch.no_grad():
        for stage in scaled.cnn.stages[4:]:
            for blk in stage.blocks:
                blk.gamma.fill_(0.1)
    _, init_out, _ = predict_and_stitch(model, with_cnn("xla"), windows, 5.0, 0.5)
    _, stitched, _ = predict_and_stitch(scaled, with_cnn("pallas_stage"), windows, 5.0, 0.5)
    _, ref, _ = predict_and_stitch(scaled, with_cnn("xla"), windows, 5.0, 0.5)
    err, moved = float(np.abs(stitched - ref).max()), float(np.abs(ref - init_out).max())
    ok = np.isfinite(stitched).all() and err <= FORWARD_TOL["f32"] < moved
    log(f"pallas_stage serving f32 with gamma 0.1 in stages 4-6: vs the cnn_impl=xla path "
        f"max_abs_err {err:.3e} (tol {FORWARD_TOL['f32']:.0e}); the branches move the output by "
        f"{moved:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("pallas_stage serving with gamma 0.1 disagrees with the plain path")
    return total


def check_fused_serving(model_lib, cfg, model, card: str) -> dict[str, dict[str, int]]:
    """Phase 9: serving with attention_impl "pallas_block", "pallas_fused"
    and "pallas_pair"; returns the launches of each value's path."""
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main as cli_main
    from audio_to_midi_tpu_torch.config import config_to_json
    from audio_to_midi_tpu_torch.infer import (
        _parity_precision, load_params, predict_and_stitch, transcribe_file,
    )
    from audio_to_midi_tpu_torch.models import attention as attn_lib
    from audio_to_midi_tpu_torch.ops.midi_io import read_midi_file
    from audio_to_midi_tpu_torch.train import loss as loss_lib

    def with_impl(impl, base=cfg):
        return dataclasses.replace(base, model=dataclasses.replace(base.model,
                                                                   attention_impl=impl))

    layers = cfg.model.num_transformer_layers
    per_forward = {"pallas_block": {"attention_block": 2 * layers},
                   "pallas_fused": {"fused_local_sublayer": layers,
                                    "fused_global_sublayer": layers},
                   "pallas_pair": {"transformer_pair": layers}}
    # Kernel 11's launches by mode, read where the model calls it.
    windows_seen = []
    block_route = attn_lib._attention_block

    def counted_block(*args, **kwargs):
        windows_seen.append(kwargs["window"])
        return block_route(*args, **kwargs)

    gen = torch.Generator(device="cpu").manual_seed(9)
    windows = torch.randn(BATCH, 2, 80_000, generator=gen) * 0.5
    totals = {impl: dict.fromkeys(read_launches(), 0) for impl in FUSED_IMPLS}
    models = {"bf16": model_lib.cast_params(copy.deepcopy(model), torch.bfloat16), "f32": model}
    attn_lib._attention_block = counted_block
    try:
        for name, m in models.items():
            _, ref, _ = predict_and_stitch(m, with_impl("xla"), windows, 5.0, 0.5)
            for impl in FUSED_IMPLS:
                reset_launches()
                windows_seen.clear()
                probs, stitched, _ = predict_and_stitch(m, with_impl(impl), windows, 5.0, 0.5)
                launches = read_launches()
                err = float(np.abs(stitched - ref).max())
                ok = (probs.shape == (BATCH, SEQ, cfg.model.output_vocab)
                      and stitched.shape[1] == 90 and np.isfinite(stitched).all()
                      and err <= FORWARD_TOL[name])
                modes = {"local": windows_seen.count(cfg.model.local_context_window),
                         "global": windows_seen.count(0)}
                log(f"{impl} serving {name}: {BATCH} windows -> stitched {stitched.shape}, vs the "
                    f"xla path max_abs_err {err:.3e} (tol {FORWARD_TOL[name]:.0e}), launches "
                    f"{ {n: c for n, c in launches.items() if c} }"
                    f"{f', kernel 11 by mode {modes}' if impl == 'pallas_block' else ''} "
                    f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {impl} serving disagrees with the plain path")
                expected = dict.fromkeys(launches, 0) | per_forward[impl]
                if launches != expected:
                    raise AssertionError(f"{impl} serving launched {launches}, expected {expected}")
                if impl == "pallas_block" and modes != {"local": layers, "global": layers}:
                    raise AssertionError(f"kernel 11 ran {modes}, expected {layers} of each mode")
                for n, c in launches.items():
                    totals[impl][n] += c
    finally:
        attn_lib._attention_block = block_route

    # ms per forward beside "pallas", in turns, at 16 and 128 windows.
    rope = model_lib.make_rope(cfg.model, "cuda")
    order = ("pallas", *FUSED_IMPLS, *reversed(FUSED_IMPLS), "pallas")
    for name, m in models.items():
        dt = DTYPES[name]
        for batch in TIMED_BATCHES:
            x = (torch.randn(batch, 2, 80_000, generator=gen) * 0.5).to(device="cuda", dtype=dt)
            times = {}
            with torch.inference_mode(), _parity_precision(dt):
                for impl in order:
                    model_cfg = with_impl(impl).model
                    times.setdefault(impl, []).append(
                        time_ms(lambda: model_lib.forward(m, model_cfg, x, rope), iters=5,
                                warmup=2))
            shown = ", ".join(f"{impl} {' / '.join(f'{t:.2f}' for t in ms)}"
                              for impl, ms in times.items())
            log(f"forward {name}, {batch} windows, ms per forward: {shown}, on {card}")
            del x
    del models["bf16"]
    torch.cuda.empty_cache()

    # f32 gradients of a dropout-free minibatch of 4 through each value.
    gen = torch.Generator(device="cpu").manual_seed(3)
    audio4 = (torch.randn(4, 2, 80_000, generator=gen) * 0.5).cuda()
    labels4 = (torch.rand(4, SEQ, 90, generator=gen) < 0.03).float().cuda()
    free = dataclasses.replace(cfg.model, transformer_dropout_rate=0.0)
    train_model = copy.deepcopy(model).train()
    with _parity_precision(torch.float32):
        plain = model_grads(train_model, loss_lib, dataclasses.replace(free, attention_impl="xla"),
                            audio4, labels4, rope)
        for impl in FUSED_IMPLS:
            reset_launches()
            grads = model_grads(train_model, loss_lib,
                                dataclasses.replace(free, attention_impl=impl), audio4, labels4,
                                rope)
            launched = read_launches()
            if any(launched[n] != c for n, c in per_forward[impl].items()):
                raise AssertionError(f"the {impl} gradients launched {launched}")
            compare_model_grads({"pallas": grads, "xla": plain},
                                f" through attention_impl={impl} (kernel) vs xla")
    del train_model, plain, grads

    # The CLI through its normal entry with a config that asks for pallas_pair.
    wav, ckpt, cfg_file = WORK / "synth.wav", WORK / "params.npz", WORK / "pallas_pair.json"
    mid = WORK / "out_pallas_pair.mid"
    cfg_file.write_text(config_to_json(with_impl("pallas_pair")))
    reset_launches()
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = cli_main([str(wav), str(mid), "--checkpoint", str(ckpt), "--config", str(cfg_file)])
    torch.cuda.synchronize()
    launches = read_launches()
    log("cli (pallas_pair): " + " | ".join(captured.getvalue().strip().splitlines())
        + f"; launches { {n: c for n, c in launches.items() if c} }")
    if rc != 0 or launches["transformer_pair"] == 0:
        raise AssertionError(f"the pallas_pair CLI returned {rc} with launches {launches}")
    for n, c in launches.items():
        totals["pallas_pair"][n] += c
    events, ref_events = read_midi_file(mid), read_midi_file(WORK / "out.mid")
    m32 = load_params(ckpt, cfg, "cuda", torch.float32)
    stitched, _, _ = transcribe_file(m32, with_impl("xla"), wav)
    near = min(float(np.abs(stitched - t).min()) for t in EVENT_THRESHOLDS)
    log(f"cli (pallas_pair): {len(events)} MIDI events, identical to phase 4's "
        f"{events == ref_events} (closest prob to a threshold {near:.2e})")
    if events != ref_events and near > 1e-4:
        raise AssertionError("the pallas_pair CLI's MIDI differs from phase 4's")
    return {f"{impl} serving": counts for impl, counts in totals.items()}


def check_rw_and_f16(ak, model_lib, cfg, model, card: str) -> dict[str, dict[str, int]]:
    """Phase 10: attention_impl="pallas_rw" (kernel 6 on the local layers'
    dropout-free two-phase route, kernel 1 elsewhere) in serving and in the
    dropout-free step; f16 serving, which takes no kernel (Fault 3); and the
    functions of kernels 3 and 10, the only way to them.  Returns the
    launches of each path."""
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main as cli_main
    from audio_to_midi_tpu_torch.config import config_to_json
    from audio_to_midi_tpu_torch.infer import (
        _parity_precision, load_params, predict_and_stitch, transcribe_file,
    )
    from audio_to_midi_tpu_torch.ops.midi_io import read_midi_file
    from audio_to_midi_tpu_torch.train import loss as loss_lib

    def with_impl(impl, base=cfg):
        return dataclasses.replace(base, model=dataclasses.replace(base.model,
                                                                   attention_impl=impl))

    layers = cfg.model.num_transformer_layers
    per_forward = {"global_attention": layers, "local_two_phase_rw": layers}
    totals = {}
    gen = torch.Generator(device="cpu").manual_seed(10)
    windows = torch.randn(BATCH, 2, 80_000, generator=gen) * 0.5
    models = {"bf16": model_lib.cast_params(copy.deepcopy(model), torch.bfloat16), "f32": model}
    serving = dict.fromkeys(read_launches(), 0)
    for name, m in models.items():
        _, ref, _ = predict_and_stitch(m, with_impl("xla"), windows, 5.0, 0.5)
        reset_launches()
        probs, stitched, _ = predict_and_stitch(m, with_impl("pallas_rw"), windows, 5.0, 0.5)
        launches = read_launches()
        err = float(np.abs(stitched - ref).max())
        ok = (probs.shape == (BATCH, SEQ, cfg.model.output_vocab) and stitched.shape[1] == 90
              and np.isfinite(stitched).all() and err <= FORWARD_TOL[name])
        log(f"pallas_rw serving {name}: {BATCH} windows -> stitched {stitched.shape}, vs the xla "
            f"path max_abs_err {err:.3e} (tol {FORWARD_TOL[name]:.0e}), launches "
            f"{ {n: c for n, c in launches.items() if c} } {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} pallas_rw serving disagrees with the plain path")
        if launches != dict.fromkeys(launches, 0) | per_forward:
            raise AssertionError(f"pallas_rw serving launched {launches}, expected {per_forward}")
        for n, c in launches.items():
            serving[n] += c

    # ms per forward beside "pallas", in turns, at 16 and 128 windows.
    rope = model_lib.make_rope(cfg.model, "cuda")
    for name, m in models.items():
        for batch in TIMED_BATCHES:
            x = (torch.randn(batch, 2, 80_000, generator=gen) * 0.5).to(device="cuda",
                                                                      dtype=DTYPES[name])
            times = {}
            with torch.inference_mode(), _parity_precision(DTYPES[name]):
                for impl in ("pallas", "pallas_rw", "pallas_rw", "pallas"):
                    model_cfg = with_impl(impl).model
                    times.setdefault(impl, []).append(
                        time_ms(lambda: model_lib.forward(m, model_cfg, x, rope), iters=5,
                                warmup=2))
            shown = ", ".join(f"{impl} {' / '.join(f'{t:.2f}' for t in ms)}"
                              for impl, ms in times.items())
            log(f"forward {name}, {batch} windows, ms per forward: {shown}, on {card}")
            del x
    del models["bf16"]
    torch.cuda.empty_cache()

    # f32 gradients of a dropout-free minibatch of 4, then one dropout-free
    # step (2 minibatches of 32): kernel 6 forward, kernel 7 backward.
    g4 = torch.Generator(device="cpu").manual_seed(3)
    audio4 = (torch.randn(4, 2, 80_000, generator=g4) * 0.5).cuda()
    labels4 = (torch.rand(4, SEQ, 90, generator=g4) < 0.03).float().cuda()
    free = dataclasses.replace(cfg.model, transformer_dropout_rate=0.0)
    train_model = copy.deepcopy(model).train()
    with _parity_precision(torch.float32):
        plain = model_grads(train_model, loss_lib, dataclasses.replace(free, attention_impl="xla"),
                            audio4, labels4, rope)
        reset_launches()
        grads = model_grads(train_model, loss_lib,
                            dataclasses.replace(free, attention_impl="pallas_rw"), audio4, labels4,
                            rope)
    launched = read_launches()
    # The attention kernels only: the default config's stage backward runs too.
    per_pass = per_forward | {"global_attention_grads": layers, "local_two_phase_grads": layers}
    attention = {fn.__name__: launched[fn.__name__] for fn in ak.KERNELS}
    if attention != dict.fromkeys(attention, 0) | per_pass:
        raise AssertionError(f"the pallas_rw gradients launched {attention}, expected {per_pass}")
    compare_model_grads({"pallas": grads, "xla": plain},
                        " through attention_impl=pallas_rw (kernels 6, 7) vs xla")
    del plain, grads
    _, _, optimizer, step, audio, labels = training_setup(
        model_lib, with_impl("pallas_rw"), train_model, dropout_rate=0.0, cnn_bwd_kernel=False)
    per_step = {n: c * audio.shape[0] for n, c in per_pass.items()}
    training, _, _, _ = run_steps("train step (pallas_rw, dropout-free)", step, train_model,
                                  optimizer, audio, labels, 1,
                                  dict.fromkeys(launched, 0) | per_step)
    for n, c in launched.items():
        training[n] += c
    totals["pallas_rw training"] = training
    del train_model, optimizer, step, audio, labels
    torch.cuda.empty_cache()

    # The CLI through its normal entry with a config that asks for pallas_rw.
    wav, ckpt, cfg_file = WORK / "synth.wav", WORK / "params.npz", WORK / "pallas_rw.json"
    mid = WORK / "out_pallas_rw.mid"
    cfg_file.write_text(config_to_json(with_impl("pallas_rw")))
    reset_launches()
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = cli_main([str(wav), str(mid), "--checkpoint", str(ckpt), "--config", str(cfg_file)])
    torch.cuda.synchronize()
    launches = read_launches()
    log("cli (pallas_rw): " + " | ".join(captured.getvalue().strip().splitlines())
        + f"; launches { {n: c for n, c in launches.items() if c} }")
    if rc != 0 or launches["local_two_phase_rw"] == 0 or launches["local_two_phase"] != 0:
        raise AssertionError(f"the pallas_rw CLI returned {rc} with launches {launches}")
    events, ref_events = read_midi_file(mid), read_midi_file(WORK / "out.mid")
    stitched, _, _ = transcribe_file(load_params(ckpt, cfg, "cuda", torch.float32),
                                     with_impl("xla"), wav)
    near = min(float(np.abs(stitched - t).min()) for t in EVENT_THRESHOLDS)
    log(f"cli (pallas_rw): {len(events)} MIDI events, identical to phase 4's "
        f"{events == ref_events} (closest prob to a threshold {near:.2e})")
    if events != ref_events and near > 1e-4:
        raise AssertionError("the pallas_rw CLI's MIDI differs from phase 4's")
    for n, c in launches.items():
        serving[n] += c
    totals["pallas_rw serving"] = serving

    # Fault 3 on the card: f16 serving with "pallas" takes the JAX package's
    # einsum routes, as "xla" does, and launches no kernel at all.
    m16 = model_lib.cast_params(copy.deepcopy(model), torch.float16)
    _, ref16, _ = predict_and_stitch(m16, with_impl("xla"), windows, 5.0, 0.5)
    reset_launches()
    probs16, stitched16, _ = predict_and_stitch(m16, with_impl("pallas"), windows, 5.0, 0.5)
    launches = read_launches()
    _, ref32, _ = predict_and_stitch(model, with_impl("xla"), windows, 5.0, 0.5)
    err, drift = float(np.abs(stitched16 - ref16).max()), float(np.abs(stitched16 - ref32).max())
    ok = (probs16.shape == (BATCH, SEQ, cfg.model.output_vocab) and np.isfinite(stitched16).all()
          and err <= F16_TOL and not any(launches.values()))
    log(f"f16 serving (pallas): {BATCH} windows -> stitched {stitched16.shape}, vs the f16 xla "
        f"path max_abs_err {err:.3e} (tol {F16_TOL:.0e}), vs the f32 path {drift:.3e}, launches "
        f"{ {n: c for n, c in launches.items() if c} } {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("f16 serving took a kernel or disagrees with the f16 plain path")
    del m16

    # Kernels 3 and 10 through their functions, forward and backward, f32.
    from audio_to_midi_tpu_torch.models.rope import precompute_frequencies

    width = HEADS * HEAD_DIM
    freqs = precompute_frequencies(HEAD_DIM, SEQ, device="cuda")
    q, k, v, cot = (randn(BATCH, SEQ, width, seed=100 + i, dtype=torch.float32)
                    for i in range(4))
    heads4 = lambda t: t.reshape(BATCH, SEQ, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    reset_launches()
    with _parity_precision(torch.float32):
        cases = {"head_major_attention": (ak.head_major_attention,
                                          ak.head_major_attention_reference,
                                          [heads4(t) for t in (q, k, v)], heads4(cot)),
                 "rope_attention": (lambda *t: ak.rope_attention(*t, freqs.cos, freqs.sin, HEADS),
                                    lambda *t: ak.rope_attention_reference(
                                        *t, freqs.cos, freqs.sin, HEADS), [q, k, v], cot)}
        for fname, (fn, reference, inputs, c) in cases.items():
            leaves = [t.clone().requires_grad_() for t in inputs]
            out = fn(*leaves)
            out.backward(c)
            ref_leaves = [t.clone().requires_grad_() for t in inputs]
            ref = reference(*ref_leaves)
            ref.backward(c)
            err = max(max_err(out, ref),
                      *(max_err(a.grad, b.grad) / max(1.0, b.grad.abs().max().item())
                        for a, b in zip(leaves, ref_leaves)))
            log(f"{fname} (G={BATCH}, S={SEQ}, {HEADS} heads x {HEAD_DIM}, f32): output and input "
                f"gradients vs the JAX reference formulation max err {err:.3e} "
                f"(tol {GRAD_TOL_F32:.0e}) {'OK' if err <= GRAD_TOL_F32 else 'FAIL'}")
            if err > GRAD_TOL_F32:
                raise AssertionError(f"{fname} disagrees with its reference")
    totals["attention functions"] = read_launches()
    return totals


def gate(stitched: np.ndarray, ref: np.ndarray, events, ref_events, what: str, tol: float):
    """The correctness gate: stitched within ``tol`` of ``ref``, events
    identical unless a probability lies within ``tol`` of a threshold."""
    err = float(np.abs(stitched - ref).max()) if stitched.shape == ref.shape else math.inf
    near = min(float(np.abs(ref - t).min()) for t in EVENT_THRESHOLDS)
    same = events == ref_events
    log(f"{what}: stitched {stitched.shape} max_abs_err {err:.3e} (tol {tol:.0e}), events "
        f"identical {same} ({len(events)} vs {len(ref_events)}; closest prob to a threshold "
        f"{near:.2e})")
    if not np.isfinite(stitched).all() or err > tol or (near > tol and not same):
        raise AssertionError(f"{what}: outside the correctness gate")


def check_file_serving(cfg, card: str) -> dict[str, dict[str, int]]:
    """Phase 11: the serving paths of a file, f32, with the seeded weights of
    phase 4's checkpoint.  transcribe_file on phase 4's 30 s WAV and on a
    300 s one, each after a warm call, with its stage walls (stage_times:
    each stage ends by synchronizing the card) and the card's events against
    the numpy eventizer's on the fetched stitched probabilities;
    transcribe_file_streaming (32 windows a chunk) on the 300 s file against
    transcribe_file by the correctness gate, with the first segment's time,
    the total and the peak device memory of each; transcribe_samples_fused
    on the 30 s tones synthesized at 44.1 kHz, in memory, against the decode
    path of phase 4's WAV (FUSED_44K_TOL); the CLI with --stream on phase
    4's WAV, whose MIDI events must be phase 4's.  Returns the launches of
    each path, counted from 0 just before it."""
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main as cli_main
    from audio_to_midi_tpu_torch.data.audio_io import write_wav
    from audio_to_midi_tpu_torch.infer import (load_params, transcribe_file,
                                               transcribe_file_streaming,
                                               transcribe_samples_fused)
    from audio_to_midi_tpu_torch.models.model import make_rope
    from audio_to_midi_tpu_torch.ops.eventize import extract_events
    from audio_to_midi_tpu_torch.ops.midi_io import read_midi_file

    m32 = load_params(WORK / "params.npz", cfg, "cuda", torch.float32)
    wav30, wav300 = WORK / "synth.wav", WORK / "synth300.wav"
    write_wav(wav300, synth_audio(LONG_SECONDS, cfg.data.sample_rate, seed=4),
              cfg.data.sample_rate)
    launches, batch = {}, {}
    for label, wav, seconds in (("30 s", wav30, 30.0), ("300 s", wav300, LONG_SECONDS)):
        transcribe_file(m32, cfg, wav)  # warm: cuDNN's choices at this batch
        stages = {}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        stitched, _dpf, events = transcribe_file(m32, cfg, wav, stage_times=stages)
        wall = time.perf_counter() - t0
        launches[f"file {label}"] = read_launches()
        peak = torch.cuda.max_memory_allocated()
        host_events = extract_events(stitched)  # a numpy array: the plain eventizer
        batch[label] = (stitched, events, wall, peak)
        log(f"transcribe_file {label}, f32: {wall * 1e3:.1f} ms ({seconds / wall:.0f}x realtime) = "
            + " + ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items())
            + f" ms; peak device memory {peak / 2**20:.1f} MiB; {len(events)} events, the numpy "
            f"eventizer's on the fetched probabilities identical {events == host_events}; "
            f"eventize launches {launches[f'file {label}']['eventize']}; on {card}")
        if events != host_events or stitched.shape[1] != cfg.model.output_vocab:
            raise AssertionError(f"transcribe_file {label}: the card's events are not numpy's")

    stitched, events, wall, peak = batch["300 s"]
    transcribe_file_streaming(m32, cfg, wav300)  # warm: cuDNN's choices at 32 windows
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    streamed, _dpf, stream_events = transcribe_file_streaming(m32, cfg, wav300,
                                                              stage_times=stages)
    launches["streaming 300 s"] = read_launches()
    stream_peak = torch.cuda.max_memory_allocated()
    log(f"transcribe_file_streaming 300 s, f32, 32 windows a chunk: first segment "
        f"{stages['first_segment_s'] * 1e3:.1f} ms, first final event "
        + (f"{stages['first_event_s'] * 1e3:.1f} ms" if stages["first_event_s"] else "none")
        + f", total {stages['total_s'] * 1e3:.1f} ms (decode {stages['decode'] * 1e3:.1f}); "
        f"peak device memory {stream_peak / 2**20:.1f} MiB; transcribe_file: total "
        f"{wall * 1e3:.1f} ms, its first stitched rows with the last, peak {peak / 2**20:.1f} MiB")
    gate(streamed, stitched, stream_events, events, "streaming vs batch, 300 s",
         FORWARD_TOL["f32"])

    audio44 = torch.from_numpy(synth_audio(30.0, 44_100, seed=2)).cuda()
    fused_cfg = dataclasses.replace(cfg, precision=dataclasses.replace(cfg.precision,
                                                                       compute_dtype="f32"))
    rope = make_rope(cfg.model, "cuda")
    fused = lambda: transcribe_samples_fused(m32, fused_cfg, audio44, rope, 44_100,
                                             cfg.data.model_audio_length, 0.5)
    fused()  # warm
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_stitched = fused().cpu().numpy()
    fused_wall = time.perf_counter() - t0
    launches["fused 30 s"] = read_launches()
    log(f"transcribe_samples_fused 30 s at 44.1 kHz in memory, f32: {fused_wall * 1e3:.1f} ms "
        f"(resample, normalize, windows, model, stitch on the card; fetch included)")
    gate(fused_stitched, batch["30 s"][0], extract_events(fused_stitched), batch["30 s"][1],
         "fused 44.1 kHz vs the decode path, 30 s", FUSED_44K_TOL)

    mid = WORK / "out_stream.mid"
    reset_launches()
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = cli_main([str(wav30), str(mid), "--checkpoint", str(WORK / "params.npz"), "--stream"])
    torch.cuda.synchronize()
    launches["cli --stream"] = read_launches()
    same = rc == 0 and read_midi_file(mid) == read_midi_file(WORK / "out.mid")
    log(f"cli --stream: {' | '.join(captured.getvalue().strip().splitlines())}; MIDI identical "
        f"to phase 4's {same}")
    if not same:
        raise AssertionError("the --stream CLI's MIDI differs from phase 4's")
    return launches


@contextlib.contextmanager
def numpy_decode():
    """The numpy decode path, whatever the native plane: in this script only,
    the routing rule of data/audio_io.py answers no."""
    from audio_to_midi_tpu_torch.data import audio_io

    rule = audio_io.use_native
    audio_io.use_native = lambda path: False
    try:
        yield
    finally:
        audio_io.use_native = rule


def check_native_plane(cfg, card: str) -> dict[str, dict[str, int]]:
    """Phase 12: the port's binding builds the C++ data plane from cpp/ into
    build/native/ and loads it (no numpy fallback here); load_full_audio_f16
    on phase 4's 30 s WAV and phase 11's 300 s WAV through the plane against
    the numpy path, bit for bit; transcribe_file on the 300 s WAV with its
    stage walls, native beside numpy, events identical.  Returns the
    launches of the native run."""
    from audio_to_midi_tpu_torch import native
    from audio_to_midi_tpu_torch.data.audio_io import load_full_audio_f16, use_native
    from audio_to_midi_tpu_torch.infer import load_params, transcribe_file

    t0 = time.perf_counter()
    lib = native.build(force=True)  # from cpp/ again, timed (the decodes above built it)
    if not native.available() or not use_native(WORK / "synth.wav"):
        raise AssertionError("the native data plane did not build or load on this machine")
    log(f"native plane: {lib.relative_to(ROOT)} built from cpp/ in "
        f"{time.perf_counter() - t0:.1f} s and loaded")
    for wav in (WORK / "synth.wav", WORK / "synth300.wav"):
        ours = load_full_audio_f16(wav)
        with numpy_decode():
            ref = load_full_audio_f16(wav)
        same = ours.dtype == ref.dtype and np.array_equal(ours.view(np.uint16), ref.view(np.uint16))
        log(f"load_full_audio_f16 {wav.name}: native {ours.shape} {ours.dtype} = numpy bit for "
            f"bit {same}")
        if not same:
            raise AssertionError(f"{wav.name}: the native decode differs from the numpy path")

    m32 = load_params(WORK / "params.npz", cfg, "cuda", torch.float32)
    wav300 = WORK / "synth300.wav"
    runs = {}
    for label in ("native", "numpy", "native again"):
        stages = {}
        reset_launches()
        with numpy_decode() if label == "numpy" else contextlib.nullcontext():
            t0 = time.perf_counter()
            _stitched, _dpf, events = transcribe_file(m32, cfg, wav300, stage_times=stages)
            wall = time.perf_counter() - t0
        runs[label] = (events, stages, wall, read_launches())
        log(f"transcribe_file 300 s, f32, {label} decode: {wall * 1e3:.1f} ms = "
            + " + ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items()) + f" ms; on {card}")
    same = runs["native"][0] == runs["numpy"][0] == runs["native again"][0]
    log(f"decode walls, 300 s: native {runs['native'][1]['decode'] * 1e3:.1f} / "
        f"{runs['native again'][1]['decode'] * 1e3:.1f} ms, numpy "
        f"{runs['numpy'][1]['decode'] * 1e3:.1f} ms; events identical {same}")
    if not same:
        raise AssertionError("the native and numpy decode paths gave different events")
    return {"native file 300 s": runs["native"][3]}


def _quartiles(values) -> str:
    q1, med, q3 = np.percentile(np.asarray(values) * 1e3, [25, 50, 75])
    return f"median {med:.1f} ms (quartiles {q1:.1f}, {q3:.1f})"


def check_augmentation(cfg, card: str) -> dict:
    """Phase 13's augmentation: one default batch (64 x (2, 80000)) on the
    card, the waves against the sequential plain version on the same draws
    (bit for bit), ms per batch (CUDA events) and the launches of one batch
    (torch.profiler), draws included."""
    from audio_to_midi_tpu_torch.data import augment_device as ad

    b, n = cfg.train.batch_size, cfg.data.samples_per_window
    frames = cfg.model.output_frames(n)
    audio = torch.randn((b, 2, n), generator=torch.Generator().manual_seed(3)).cuda()
    labels = torch.rand((b, frames, 90), generator=torch.Generator().manual_seed(4)).cuda()
    gen = torch.Generator().manual_seed(5)
    draws = ad.draw(cfg.transforms, b, n, frames, gen, "cuda")
    a1, l1, a2, l2 = audio.clone(), labels.clone(), audio.clone(), labels.clone()
    ad.augment_(a1, l1, draws)
    ad.augment_sequential(a2, l2, draws)
    same = torch.equal(a1, a2) and torch.equal(l1, l2)
    apps = sum(st.n for st in draws.stages)
    waves = sum(len(st.bounds) - 1 for st in draws.stages)

    def batched():
        return ad.transform_for_training_device(audio, labels, cfg.transforms, gen)

    def plain():
        x, y = audio.clone(), labels.clone()
        ad.augment_sequential(x, y, ad.draw(cfg.transforms, b, n, frames, gen, "cuda"))
        return x, y

    ms, plain_ms = time_ms(batched, iters=20, warmup=3), time_ms(plain, iters=5, warmup=1)
    counts = {}
    for label, fn in (("batched", batched), ("plain", plain)):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts[label] = sum(1 for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"augmentation, batch {b} x (2, {n}), default settings: {apps} applications in {waves} "
        f"waves; waves = sequential on the same draws, bit for bit, {same}; {ms:.3f} ms and "
        f"{counts['batched']} device events per batch (the sequential plain version "
        f"{plain_ms:.3f} ms, {counts['plain']}); on {card}")
    if not same:
        raise AssertionError("the augmentation's waves differ from the sequential version")
    return {"ms": ms, "plain_ms": plain_ms, "events": counts["batched"],
            "plain_events": counts["plain"], "applications": apps, "waves": waves}


def run_train_cli(cfg, name: str, argv: list[str], resume: bool = False, **train) -> dict:
    """One invocation of cli/train_cli.main with a --config JSON that changes
    only ``train``'s fields of ``cfg``; its checkpoints go to
    WORK/train_ck_<name>, emptied first unless ``resume``.  Returns the step
    hooks' (step, host clock, launches so far, info), the test-set
    evaluations, the wall, the launches, the peak device memory, the
    checkpoint directory and the data loader loop.train was given; and the
    spans of the evaluations (host clock,
    launches before and after) and of the evolutions (host clock), with
    each evolution's step, regenerated members and wall."""
    from audio_to_midi_tpu_torch.cli import train_cli
    from audio_to_midi_tpu_torch.config import config_to_json
    from audio_to_midi_tpu_torch.train import loop

    run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))
    cfg_path = WORK / f"train_{name}.json"
    cfg_path.write_text(config_to_json(run_cfg))
    ck = WORK / f"train_ck_{name}"
    if not resume:
        shutil.rmtree(ck, ignore_errors=True)
    argv = argv + ["--config", str(cfg_path), "--checkpoint", str(ck), "--no-tensorboard"]
    hooks, evals, spans, evolutions, loaders = [], [], [], [], []
    real_train, real_eval = loop.train, loop.compute_testset_loss
    real_evolve = loop.evolve_ensemble_

    def traced_train(*args, **kwargs):
        loaders.append(args[4])
        return real_train(*args, step_hook=lambda step, info: hooks.append(
            (step, time.perf_counter(), read_launches(), info)), **kwargs)

    def traced_eval(*args, **kwargs):
        before, t0 = read_launches(), time.perf_counter()
        out = real_eval(*args, **kwargs)
        spans.append((t0, time.perf_counter(), before, read_launches()))
        evals.append(out)
        return out

    def traced_evolve(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_evolve(*args, **kwargs)
        t1 = time.perf_counter()
        spans.append((t0, t1, None, None))
        evolutions.append((hooks[-1][0], out, t1 - t0))
        return out

    loop.train, loop.compute_testset_loss = traced_train, traced_eval
    loop.evolve_ensemble_ = traced_evolve
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        if train_cli.main(argv) != 0:
            raise AssertionError(f"train_cli {name} returned non-zero")
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        loop.train, loop.compute_testset_loss = real_train, real_eval
        loop.evolve_ensemble_ = real_evolve
    return {"hooks": hooks, "evals": evals, "spans": spans, "evolutions": evolutions,
            "wall": wall, "launches": read_launches(),
            "peak": torch.cuda.max_memory_allocated(), "ck": ck, "loader": loaders[0]}


def check_training_entry(cfg, card: str) -> dict[str, dict[str, int]]:
    """Phase 13: training through cli/train_cli.py on a synthetic dataset
    written under build/smoke/, at the default ModelConfig and TrainConfig
    (batch 64 = 2 x 32, bf16, dropout 0.1, cnn_bwd_kernel, the ring and the
    augmentation on the card); a --config JSON changes only num_steps,
    print_every, checkpoint_every and testset_loss_every.  Per step: 16
    launches of each seeded dropout kernel (12, 13, 15, 16), 4 of the stage
    backward (20), none of the dropout-free ones; finite losses; the test
    set's hit rate in [0, 1]; checkpoints on disk; a second invocation
    resumes at latest + 1; the serving CLI transcribes phase 4's WAV from
    the checkpoint directory.  Then the same with input_ring_capacity=0
    (host batches, augmented on the card).  Both runs feed from the default
    loader, the grain pipeline with the config's 3 worker processes; the
    ring run again with --threaded-loader.  Last, one step in flight: the
    ring feed over 12 steps at print_every 1 (the host reads the loss every
    step) and at print_every 3 (steps 4-5, 7-8, 10-11 leave theirs on the
    card), in turns 1, 3, 3, 1, with the final checkpoint only and no
    evaluation; the wall of steps 4-12 between the hooks of steps 3 and 12,
    where the card has drained.  Returns each run's launches and the ring
    run's step times (s, steps 2-6)."""
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main as cli_main
    from audio_to_midi_tpu_torch.data import synthetic
    from audio_to_midi_tpu_torch.data.loader import GrainLoader, ThreadedBatchLoader
    from audio_to_midi_tpu_torch.ops.midi_io import read_midi_file
    from audio_to_midi_tpu_torch.train import checkpoint as ckpt

    started = time.perf_counter()
    train_dir, val_dir = WORK / "train_set", WORK / "val_set"
    for d in (train_dir, val_dir):
        shutil.rmtree(d, ignore_errors=True)
    synthetic.make_synthetic_dataset(train_dir, num_samples=8, duration_s=10.0, seed=1)
    synthetic.make_synthetic_dataset(val_dir, num_samples=2, duration_s=10.0, seed=2)
    log(f"synthetic train set (8 x 10 s) and val set (2 x 10 s) written in "
        f"{time.perf_counter() - started:.1f} s")
    augmentation = check_augmentation(cfg, card)

    per_step = {"global_attention_dropout": 16, "local_two_phase_dropout": 16,
                "global_attention_grads_prng": 16, "local_two_phase_grads_prng": 16,
                "stage_bwd": 4}
    steps = 6
    launches, step_times, reuse_by, first_batch = {}, {}, {}, {}
    dataset = ["--dataset", str(train_dir)]
    workers = cfg.train.dataset_num_workers
    if workers != 3:
        raise AssertionError(f"phase 13 must train on the default 3 loader workers, not {workers}")
    ring = cfg.train.input_ring_capacity
    for label, ring_capacity, flags, loader_type in (
            ("ring", ring, [], GrainLoader), ("host feed", 0, [], GrainLoader),
            ("ring, threaded loader", ring, ["--threaded-loader"], ThreadedBatchLoader)):
        argv = dataset + ["--testset", f"val={val_dir}"] + flags
        train = {"num_steps": steps, "print_every": 1, "checkpoint_every": 3,
                 "testset_loss_every": steps, "input_ring_capacity": ring_capacity}
        name = label.replace(",", "").replace(" ", "_")
        run = run_train_cli(cfg, name, argv, **train)
        if type(run["loader"]) is not loader_type:
            raise AssertionError(f"{label}: trained on a {type(run['loader']).__name__}, "
                                 f"not a {loader_type.__name__}")
        first_batch[label] = getattr(run["loader"], "first_batch_s", None)
        launches[f"train_cli {label}"] = run["launches"]
        first, evals, ck = run["hooks"], run["evals"], run["ck"]
        latest = ckpt.CheckpointManager(ck).latest_step()
        resumed = [h[0] for h in run_train_cli(cfg, name, argv + ["--steps", str(steps + 1)],
                                               resume=True, **train)["hooks"]]

        if [h[0] for h in first] != list(range(1, steps + 1)) or resumed != [latest + 1]:
            raise AssertionError(f"{label}: steps {[h[0] for h in first]}, resumed at {resumed} "
                                 f"after checkpoint {latest}")
        deltas, previous = [], {name: 0 for name in first[0][2]}
        for _step, _t, counts, _info in first:
            deltas.append({k: counts[k] - previous[k] for k in counts})
            previous = counts
        for step, delta in enumerate(deltas, 1):
            wrong = {k: v for k, v in delta.items() if v != per_step.get(k, 0)}
            if wrong:
                raise AssertionError(f"{label}, step {step}: launches {wrong}, expected {per_step}")
        losses = [float(h[3]["loss"][0]) for h in first]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: non-finite losses {losses}")
        test_loss, hit, eventized, _ = evals[0]
        if not (0.0 <= float(hit[0]) <= 1.0 and math.isfinite(float(test_loss[0]))):
            raise AssertionError(f"{label}: test loss {test_loss}, hit rate {hit}")
        on_disk = ckpt.CheckpointManager(ck).all_steps()
        if on_disk != [3, 6, 7] or not (ck / "7" / "params.npz").exists():
            raise AssertionError(f"{label}: checkpoints on disk {on_disk}")
        times = [b[1] - a[1] for a, b in zip(first, first[1:])]
        step_times[label] = times
        reuse = [h[3]["ring"]["reuse_factor"] for h in first if h[3]["ring"] is not None]
        reuse_by[label] = reuse
        log(f"train_cli {label}, default config (batch 64 = 2 x 32, bf16, dropout 0.1, "
            f"cnn_bwd_kernel): {steps} steps in {run['wall']:.1f} s (build, fill and evaluation "
            f"included); per step {_quartiles(times)} over steps 2-{steps}; losses "
            + ", ".join(f"{x:.1f}" for x in losses)
            + f"; launches per step {deltas[-1]}; ring reuse factor "
            + (", ".join(f"{r:.2f}" for r in reuse) if reuse else "none (host feed)")
            + f"; augmentation {augmentation['ms']:.3f} ms, {augmentation['events']} device "
            f"events per batch; test set: loss {float(test_loss[0]):.1f}, hit rate "
            f"{float(hit[0]):.4f}, eventized diff {float(eventized[0]):.1f}; checkpoints "
            f"{on_disk}, resumed at {resumed[0]}; peak device memory "
            f"{run['peak'] / 2**30:.2f} GiB; on {card}")
    log(f"train_cli loaders, default config, ring feed, steps 2-{steps}: grain pipeline "
        f"({workers} worker processes) per step {_quartiles(step_times['ring'])}, reuse factor "
        + ", ".join(f"{r:.2f}" for r in reuse_by["ring"])
        + f", workers' start-up {first_batch['ring']:.2f} s to the first batch (host feed run "
        f"{first_batch['host feed']:.2f} s); threaded loader ({workers} threads) per step "
        f"{_quartiles(step_times['ring, threaded loader'])}, reuse factor "
        + ", ".join(f"{r:.2f}" for r in reuse_by["ring, threaded loader"]) + f"; on {card}")

    in_flight_steps = 12
    walls = {1: [], 3: []}
    for print_every in (1, 3, 3, 1):
        name = f"ring_print_every_{print_every}"
        run = run_train_cli(cfg, name, dataset, num_steps=in_flight_steps,
                            print_every=print_every, checkpoint_every=1000,
                            testset_loss_every=1000)
        launches[f"train_cli {name} {len(walls[print_every])}"] = run["launches"]
        at = {h[0]: h for h in run["hooks"]}
        if sorted(at) != list(range(print_every, in_flight_steps + 1, print_every)):
            raise AssertionError(f"{name}: step hooks at {sorted(at)}")
        expected = {k: v * in_flight_steps for k, v in per_step.items()}
        wrong = {k: v for k, v in run["launches"].items() if v != expected.get(k, 0)}
        if wrong:
            raise AssertionError(f"{name}: launches {wrong}, expected {expected}")
        losses = [float(h[3]["loss"][0]) for h in run["hooks"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        walls[print_every].append((at[in_flight_steps][1] - at[3][1]) / (in_flight_steps - 3))
        log(f"train_cli ring, print_every {print_every}, {in_flight_steps} steps in "
            f"{run['wall']:.1f} s: steps 4-{in_flight_steps} "
            f"{walls[print_every][-1] * 1e3:.1f} ms per step (mean, host clock); reuse factor "
            + ", ".join(f"{h[3]['ring']['reuse_factor']:.2f}" for h in run["hooks"])
            + f"; peak device memory {run['peak'] / 2**30:.2f} GiB; on {card}")
    log("one step in flight: steps 4-12 of the ring feed, in turns 1, 3, 3, 1: print_every 1 "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls[1]) + " ms per step, print_every 3 "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls[3]) + f" ms per step; on {card}")

    mid = WORK / "out_trained.mid"
    captured = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(captured):
        rc = cli_main([str(WORK / "synth.wav"), str(mid), "--checkpoint",
                       str(WORK / "train_ck_ring")])
    torch.cuda.synchronize()
    launches["cli from a training checkpoint"] = read_launches()
    midi = read_midi_file(mid) if rc == 0 else None
    log(f"cli from the checkpoint directory: {' | '.join(captured.getvalue().strip().splitlines())}"
        f"; MIDI {len(midi) if midi is not None else 'missing'} events read back")
    if rc != 0:
        raise AssertionError("the serving CLI failed on the training checkpoint directory")
    log(f"phase 13 took {time.perf_counter() - started:.1f} s")
    return launches, step_times["ring"]


def _interval_without(spans, t0: float, t1: float) -> tuple[float, dict[str, int]]:
    """The host wall between t0 and t1 less the evaluations and evolutions
    that ran inside it, and the launches of those evaluations."""
    wall, launched = t1 - t0, {}
    for a, b, before, after in spans:
        if t0 <= a and b <= t1:
            wall -= b - a
            if before is not None:
                for k in after:
                    launched[k] = launched.get(k, 0) + after[k] - before[k]
    return wall, launched


def check_population(cfg, card: str, one_member_times: list[float]) -> dict[str, dict[str, int]]:
    """Phase 14: the ensemble axis at the default ModelConfig and TrainConfig
    (the full width, dropout 0.1, cnn_bwd_kernel, bf16), a population of 4.

    1. cli/train_cli.py --ensemble-size 4 on phase 13's synthetic sets, a
       --config that sets only num_steps 4, print_every 1, checkpoint_every
       2, testset_loss_every 2 and use_custom_init: per step 64 launches of
       each seeded dropout kernel (12, 13, 15, 16) and 16 of the stage
       backward (20), none of the others once the evaluations' own are
       taken out; four finite member losses a step; the evolution after the
       evaluations of steps 2 and 4; checkpoints whose leaves lead with
       (4,); a second invocation resuming at latest + 1.
    2. In-process, one ensemble step at E = 4 on the card: every member's
       loss and updated parameters are the bits of a one-member step from
       its weights with its generator seed.
    3. The evolution of that population: the winners keep their bits, the
       losers change, in place; the optimizer keeps its parameters and
       moments.
    4. Serving members 0 and 3 of the CLI's checkpoint
       (load_newest_checkpoint with ensemble_size 4, ensemble_select i):
       transcribe_file on phase 4's WAV.
    5. The CLIs on phase 13's one-member checkpoint: infer_cli (its MIDI
       phase 13's serving CLI's), audio_to_midi --validation (its loss the
       in-process compute_testset_loss within 1e-5 relative) and
       --individual, copy_weights (every leaf copied) and inspect_model on
       the copy (exit 0).
    6. f16: train_cli --precision f16, 3 steps: no kernel launches (the f16
       gates take autograd and the einsum routes), the grad scale, every
       step finite or rolled back.
    Prints ms per step at E = 4 (steps 2-4, the evaluations and evolutions
    taken out) beside phase 13's E = 1, the peak device memory and the
    evolution's host ms.  Returns each path's launches."""
    from audio_to_midi_tpu_torch import convert
    from audio_to_midi_tpu_torch.cli import audio_to_midi as serving_cli
    from audio_to_midi_tpu_torch.cli import copy_weights, infer_cli, inspect_model
    from audio_to_midi_tpu_torch.infer import load_newest_checkpoint, transcribe_file
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.train import checkpoint as ckpt
    from audio_to_midi_tpu_torch.train import ensemble as ensemble_lib
    from audio_to_midi_tpu_torch.train import optim, step as step_lib
    from audio_to_midi_tpu_torch.train.evaluate import compute_testset_loss

    started = time.perf_counter()
    size = 4
    train_dir, val_dir = WORK / "train_set", WORK / "val_set"
    per_member = {"global_attention_dropout": 16, "local_two_phase_dropout": 16,
                  "global_attention_grads_prng": 16, "local_two_phase_grads_prng": 16,
                  "stage_bwd": 4}
    per_step = {k: v * size for k, v in per_member.items()}
    launches = {}

    # 1. The CLI run, then the resume.
    argv = ["--dataset", str(train_dir), "--testset", f"val={val_dir}", "--ensemble-size",
            str(size)]
    train = {"num_steps": 4, "print_every": 1, "checkpoint_every": 2, "testset_loss_every": 2,
             "use_custom_init": True}
    run = run_train_cli(cfg, "ensemble", argv, **train)
    launches["train_cli ensemble"] = run["launches"]
    hooks, ck = run["hooks"], run["ck"]
    if [h[0] for h in hooks] != [1, 2, 3, 4]:
        raise AssertionError(f"ensemble: step hooks at {[h[0] for h in hooks]}")
    previous, start = dict.fromkeys(hooks[0][2], 0), None
    step_ms, losses = [], []
    for step, t, counts, info in hooks:
        wall, evaluated = _interval_without(run["spans"], start, t) if start else (None, {})
        delta = {k: counts[k] - previous[k] - evaluated.get(k, 0) for k in counts}
        wrong = {k: v for k, v in delta.items() if v != per_step.get(k, 0)}
        if wrong:
            raise AssertionError(f"ensemble, step {step}: launches {wrong}, expected {per_step}")
        loss = np.asarray(info["loss"])
        if loss.shape != (size,) or not np.isfinite(loss).all():
            raise AssertionError(f"ensemble, step {step}: member losses {loss}")
        losses.append(loss)
        if wall is not None:
            step_ms.append(wall)
        previous, start = counts, t
    evolved_at = [e[0] for e in run["evolutions"]]
    if evolved_at != [2, 4] or any(len(e[1]) != size // 2 for e in run["evolutions"]):
        raise AssertionError(f"ensemble: evolutions {run['evolutions']}")
    evaluated = _interval_without(run["spans"], 0.0, float("inf"))[1]
    on_disk = ckpt.CheckpointManager(ck).all_steps()
    shapes = {v.shape[0] for v in convert.load_npz(ck / "4" / "params.npz").values()}
    resumed = [h[0] for h in run_train_cli(cfg, "ensemble", argv + ["--steps", "5"], resume=True,
                                           **train)["hooks"]]
    if on_disk != [2, 4] or shapes != {size} or resumed != [5]:
        raise AssertionError(f"ensemble: checkpoints {on_disk}, leading axes {shapes}, resumed "
                             f"at {resumed}")
    log(f"train_cli --ensemble-size {size}, default config, use_custom_init: steps 2-4 "
        f"{_quartiles(step_ms)} per step (evaluations and evolutions taken out) against "
        f"phase 13's one member {_quartiles(one_member_times)} (steps 2-6); member losses "
        + "; ".join(", ".join(f"{x:.1f}" for x in loss) for loss in losses)
        + f"; launches per step {delta}; the evaluations' launches {evaluated}; evolved at "
        f"steps {evolved_at}, regenerated {[e[1] for e in run['evolutions']]} in "
        + ", ".join(f"{e[2] * 1e3:.1f}" for e in run["evolutions"])
        + f" ms (host); checkpoints {on_disk} with leading axis {sorted(shapes)}, resumed at "
        f"{resumed[0]}; peak device memory {run['peak'] / 2**30:.2f} GiB; {run['wall']:.1f} s; "
        f"on {card}")

    # 2. Member = one-member step, in-process on the card.
    ensemble, _ = model_lib.init_ensemble(torch.Generator().manual_seed(14), cfg.model, size)
    ensemble = ensemble.cuda().train()
    singles = [copy.deepcopy(member) for member in ensemble]
    train_cfg, rope, _opt, single_step, audio, labels = training_setup(
        model_lib, cfg, singles[0], cfg.model.transformer_dropout_rate, cfg.model.cnn_bwd_kernel)
    if train_cfg.model != cfg.model:
        raise AssertionError("phase 14 must train the default model configuration, untouched")
    single_steps = [single_step] + [
        step_lib.make_train_step(train_cfg, optim.setup_optimizers(
            s, train_cfg.model, train_cfg.train), rope) for s in singles[1:]]
    pop_cfg = dataclasses.replace(train_cfg, train=dataclasses.replace(train_cfg.train,
                                                                       ensemble_size=size))
    pop_opt = optim.setup_optimizers(ensemble, pop_cfg.model, pop_cfg.train)
    pop_step = step_lib.make_train_step(pop_cfg, pop_opt, rope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    out = pop_step(ensemble, audio, labels, 1.0, torch.Generator().manual_seed(15))
    end_ev.record()
    torch.cuda.synchronize()
    launches["ensemble step"] = read_launches()
    pop_ms, pop_peak = start_ev.elapsed_time(end_ev), torch.cuda.max_memory_allocated()
    wrong = {k: v for k, v in launches["ensemble step"].items() if v != per_step.get(k, 0)}
    if wrong:
        raise AssertionError(f"ensemble step: launches {wrong}, expected {per_step}")
    seeds = torch.randint(0, 2 ** 62, (size,),
                          generator=torch.Generator().manual_seed(15)).tolist()
    same_loss, same_params = [], []
    for i, (single, step_fn, seed) in enumerate(zip(singles, single_steps, seeds)):
        ref = step_fn(single, audio, labels, 1.0, torch.Generator().manual_seed(seed))
        same_loss.append(torch.equal(out.loss[i], ref.loss) and bool(ref.grads_valid))
        same_params.append(all(torch.equal(a, b) for a, b in zip(ensemble[i].parameters(),
                                                                 single.parameters())))
    log(f"ensemble step, E = {size}, default config, batch {audio.shape[0]} x {audio.shape[1]}: "
        f"losses {', '.join(f'{x:.3f}' for x in out.loss.tolist())}, grads_valid "
        f"{out.grads_valid.tolist()}, {pop_ms:.1f} ms (CUDA events), peak device memory "
        f"{pop_peak / 2**30:.2f} GiB; each member = the one-member step on its weights and "
        f"seed: losses {same_loss}, parameters {same_params}; on {card}")
    if not (all(same_loss) and all(same_params) and bool(out.grads_valid.all())):
        raise AssertionError("a member of the ensemble step differs from its one-member step")
    del singles, single_steps

    # 3. The evolution of the card's population.
    scores = np.array([3.0, 1.0, 4.0, 2.0])  # winners 1, 3; losers 2, 0
    before = convert.params_to_jax(ensemble)
    bound = list(ensemble.parameters())
    moments = [t.clone() for chain in pop_opt.members for t in (chain._mu_flat, chain._nu_flat)]
    t0 = time.perf_counter()
    regenerated = ensemble_lib.evolve_ensemble_(ensemble, scores, np.random.default_rng(14))
    evolve_ms = (time.perf_counter() - t0) * 1e3
    after = convert.params_to_jax(ensemble)
    winners_kept = all(np.array_equal(after[k][w], before[k][w]) for k in before for w in (1, 3))
    losers_changed = all(any(not np.array_equal(after[k][m], before[k][m]) for k in before)
                         for m in (0, 2))
    still_bound = (all(a is b for a, b in zip(bound, ensemble.parameters()))
                   and all(a is b for a, b in zip(bound, pop_opt.params)))
    kept_moments = all(torch.equal(a, b) for a, b in zip(
        moments, [t for chain in pop_opt.members for t in (chain._mu_flat, chain._nu_flat)]))
    log(f"evolution on the card's population, scores {scores.tolist()}: regenerated "
        f"{regenerated} in {evolve_ms:.1f} ms (host, {sum(v.size for v in before.values()):,} "
        f"parameters); winners' bits kept {winners_kept}, losers changed {losers_changed}, "
        f"the optimizer bound to the members' parameters {still_bound}, its moments kept "
        f"{kept_moments}")
    if sorted(regenerated) != [0, 2] or not (winners_kept and losers_changed and still_bound
                                             and kept_moments):
        raise AssertionError("the evolution of the card's population went wrong")
    del ensemble, pop_opt, pop_step, before, after, moments, bound

    # 4. Serving members of the CLI's checkpoint.
    latest = ckpt.CheckpointManager(ck).latest_step()
    stored = convert.load_npz(ck / str(latest) / "params.npz")
    reset_launches()
    served = {}
    for i in (0, size - 1):
        member, _ = load_newest_checkpoint(ck, cfg, "cuda", ensemble_size=size,
                                           ensemble_select=i)
        ours = convert.state_dict_to_jax(member.state_dict())
        if not all(np.array_equal(ours[k], stored[k][i]) for k in stored):
            raise AssertionError(f"member {i} served is not the checkpoint's")
        _stitched, _dpf, events = transcribe_file(member, cfg, WORK / "synth.wav")
        served[i] = len(events)
    torch.cuda.synchronize()
    launches["serving a member"] = read_launches()
    log(f"serving members 0 and {size - 1} of the step-{latest} checkpoint on phase 4's WAV: "
        f"events {served}; launches {launches['serving a member']}")

    # 5. The CLIs on phase 13's one-member checkpoint.
    ck13, wav = WORK / "train_ck_ring", WORK / "synth.wav"
    reset_launches()
    mid = WORK / "out_infer_cli.mid"
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = infer_cli.main([str(wav), "--midi", str(mid), "--checkpoint", str(ck13),
                             "--overlap", str(cfg.infer.window_overlap)])
    same_midi = rc == 0 and mid.read_bytes() == (WORK / "out_trained.mid").read_bytes()
    frames = captured.getvalue().splitlines()[0]
    log(f"infer_cli on phase 13's checkpoint: {frames}; MIDI identical to phase 13's serving "
        f"CLI's {same_midi}")
    if not same_midi:
        raise AssertionError("infer_cli's MIDI differs from the serving CLI's")
    outputs = {}
    for extra in ([], ["--individual"]):
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            rc = serving_cli.main([str(val_dir), "--validation", "--checkpoint", str(ck13)]
                                  + extra)
        if rc != 0:
            raise AssertionError(f"audio_to_midi --validation {extra} returned {rc}")
        outputs[bool(extra)] = captured.getvalue().strip().splitlines()
    model13, _ = load_newest_checkpoint(ck13, cfg, "cuda")
    num_frames = cfg.model.output_frames(cfg.data.samples_per_window)
    # As the CLI calls it: no figures (the card's machine has no matplotlib).
    in_process = float(compute_testset_loss(model13, cfg, val_dir, num_frames,
                                            model_lib.make_rope(cfg.model, "cuda"),
                                            ensemble=False, generate_visualizations=False)[0][0])
    printed = float(outputs[False][0].split(":")[1])
    rel = abs(printed - in_process) / abs(in_process)
    log(f"audio_to_midi --validation: {' | '.join(outputs[False])}; in-process "
        f"compute_testset_loss {in_process}: relative {rel:.2e} (tol 1e-05); --individual: "
        + " | ".join(outputs[True]))
    if rel > 1e-5 or len(outputs[True]) != 2:
        raise AssertionError("audio_to_midi --validation disagrees with compute_testset_loss")
    copied = WORK / "copied_ck"
    shutil.rmtree(copied, ignore_errors=True)
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc_copy = copy_weights.main([str(ck13), str(copied)])
        rc_inspect = inspect_model.main([str(copied)])
    lines = captured.getvalue().splitlines()
    leaves = len(convert.load_npz(ck13 / str(ckpt.CheckpointManager(ck13).latest_step())
                                  / "params.npz"))
    all_copied = f"Copied {leaves} leaves, kept 0 freshly-initialized leaves" in lines
    log(f"copy_weights: {' | '.join(lines[:3])}; inspect_model on the copy: exit {rc_inspect}, "
        f"{len(lines) - 3} lines, {lines[4] if len(lines) > 4 else ''}")
    if rc_copy != 0 or not all_copied or rc_inspect != 0:
        raise AssertionError("copy_weights or inspect_model failed on phase 13's checkpoint")
    torch.cuda.synchronize()
    launches["phase 14 clis"] = read_launches()

    # 6. f16 training from the CLI: no kernel launches.
    run = run_train_cli(cfg, "f16", ["--dataset", str(train_dir), "--precision", "f16"],
                        num_steps=3, print_every=1, checkpoint_every=1000,
                        testset_loss_every=1000)
    launches["train_cli f16"] = run["launches"]
    hooked = {h[0]: h[3] for h in run["hooks"]}
    rolled_back = [s for s in (1, 2, 3) if s not in hooked]
    finite = all(np.isfinite(info["loss"]).all() for info in hooked.values())
    log(f"train_cli --precision f16, 3 steps: grad scale "
        + ", ".join(f"step {s} {info['grad_scale']}" for s, info in hooked.items())
        + f"; losses {[float(info['loss'][0]) for info in hooked.values()]}; rolled back "
        f"{rolled_back}; launches {dict((k, v) for k, v in run['launches'].items() if v)} "
        f"(none expected); {run['wall']:.1f} s; on {card}")
    if any(run["launches"].values()) or not finite:
        raise AssertionError("f16 training launched a kernel, or a step that was not rolled "
                             "back is not finite")
    log(f"phase 14 took {time.perf_counter() - started:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: parallel/ -- several ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# A group of ranks' deadline, and any collective's (init_process_group's
# timeout): a rank that never reaches a collective fails the phase.
GROUP_TIMEOUT_S = 420
COLLECTIVE_TIMEOUT_S = 120
TWO_HEADS = 2
# The f32 parity step of a sharded layout against one rank's, from the
# readings on the H100: the sound TP 2 and DP 2 steps' updates differed by
# at most 2.2e-7 (the global-norm clip over 11.6M parameters scales a
# typical update to ~3e-4), and the gradients by a few 1e-7 of each leaf's
# largest.  The broken controls that phase 15 runs beside them -- DP without
# the division over "data", TP with a clip norm that skips the model
# all-reduce -- must fail these limits, or the check cannot see them.
UPDATE_ATOL = 2e-6      # largest |update difference|, absolute
GRAD_TOL = 1e-5         # largest |gradient difference| / the leaf's largest |gradient|
# The f32 loss of a sharded step against one rank's, relative: the same sums
# in another order (the TP all-reduces, the mean over data ranks).
PARALLEL_LOSS_TOL = 1e-4
CONTROLS = {"tp": "a clip norm that skips the model all-reduce",
            "dp": "no division of the gradients over the data ranks"}
PARITY_WINDOWS, PARITY_MINIBATCH = 16, 8


def check_two_heads(ak) -> dict[str, dict]:
    """Phase 15.1: the attention kernels on 2 heads of 64, the shapes a TP 2
    shard gives them (no model path launched them with fewer than 4 heads
    before): kernels 1 and 2 at the serving shapes, and 1, 2, 9, 7, 15, 12,
    16, 13 at the training shapes, f32 and bf16, each against its plain
    version with phase 2's tolerances and its time."""
    results = {}
    run = functools.partial(run_case, results)
    h, width = TWO_HEADS, TWO_HEADS * HEAD_DIM
    flops = lambda groups, s, cols, products: products * 2.0 * groups * h * s * cols * HEAD_DIM
    thr = DROPOUT_THRESHOLD
    for name, dt in DTYPES.items():
        kernel_tol = lambda ref: KERNEL_TOL[name]
        grads_tol = lambda ref: grad_tol(ref, name)
        for n in (BATCH, 32):
            q, k, v, g = (randn(n, SEQ, width, seed=300 + i, dtype=dt) for i in range(4))
            ts = [randn(n, PADDED, width, seed=310 + i, dtype=dt) for i in range(6)]
            run(f"2 heads global S=250 B={n}", name, lambda: ak.global_attention(q, k, v, h),
                lambda: ak.global_attention_plain(q, k, v, h), kernel_tol,
                bound(4, q.numel(), name, flops(n, SEQ, SEQ, 2)))
            run(f"2 heads local P=256 B={n}", name, lambda: ak.local_two_phase(*ts[:5], h, 16),
                lambda: ak.local_two_phase_plain(*ts[:5], h, 16), kernel_tol,
                bound(6, ts[0].numel(), name, 2 * flops(n, PADDED, 16, 2)))
            if n == BATCH:
                continue
            run("2 heads global grads S=250", name,
                lambda: ak.global_attention_grads(q, k, v, g, h),
                lambda: ak.global_attention_grads_plain(q, k, v, g, h), grads_tol,
                bound(7, q.numel(), name, flops(n, SEQ, SEQ, 5)))
            run("2 heads local grads P=256", name,
                lambda: ak.local_two_phase_grads(*ts, h, 16),
                lambda: ak.local_two_phase_grads_plain(*ts, h, 16), grads_tol,
                bound(11, ts[0].numel(), name, 2 * flops(n, PADDED, 16, 5)))
            seed = torch.tensor([4242, 17], dtype=torch.int32, device="cuda")
            dumped = ak.philox_bits(seed, n, h, SEQ)
            run("2 heads global dropout S=250", name,
                lambda: ak.global_attention_dropout(q, k, v, seed, h, threshold=thr),
                lambda: ak.global_attention_plain(q, k, v, h, 0, None, dumped, thr), kernel_tol,
                bound(4, q.numel(), name, flops(n, SEQ, SEQ, 2)))
            run("2 heads global grads prng S=250", name,
                lambda: ak.global_attention_grads_prng(q, k, v, seed, g, h, threshold=thr),
                lambda: ak.global_attention_grads_plain(q, k, v, g, h, 0, None, dumped, thr),
                grads_tol, bound(7, q.numel(), name, flops(n, SEQ, SEQ, 5)))
            planes = ak.two_phase_planes(ak.philox_bits(seed, n, 2 * h, PADDED), h)
            run("2 heads local dropout P=256", name,
                lambda: ak.local_two_phase_dropout(*ts[:5], seed, h, 16, threshold=thr),
                lambda: ak.local_two_phase_plain(*ts[:5], h, 16, *planes, thr), kernel_tol,
                bound(6, ts[0].numel(), name, 2 * flops(n, PADDED, 16, 2)))
            run("2 heads local grads prng P=256", name,
                lambda: ak.local_two_phase_grads_prng(*ts[:5], seed, ts[5], h, 16, threshold=thr),
                lambda: ak.local_two_phase_grads_plain(*ts, h, 16, *planes, thr), grads_tol,
                bound(11, ts[0].numel(), name, 2 * flops(n, PADDED, 16, 5)))
    return results


def _rank_entry(job: str, rank: int, world: int, run: str) -> None:
    """A spawned rank on the one card: joins the gloo group of ``world`` by a
    file rendezvous in ``run``, runs ``job`` and leaves its result (or its
    traceback) there."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{run}/rendezvous", rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        out = globals()[job](Path(run))
        torch.save(out, Path(run, f"out{rank}.pt"))
    except BaseException:
        Path(run, f"error{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _cli_rank(argv: list[str], rank: int, run: str) -> None:
    """A spawned rank of cli/train_cli.py (which joins the group itself, by
    --coordinator-address): each step's launches, the lockstep refreshes,
    the checkpoint writes, the evaluations and evolutions, and the loop's
    parameter digest, left in ``run``."""
    import logging
    import traceback

    from audio_to_midi_tpu_torch.cli import train_cli
    from audio_to_midi_tpu_torch.data import device_ring
    from audio_to_midi_tpu_torch.train import checkpoint as ckpt
    from audio_to_midi_tpu_torch.train import loop

    out = {"hooks": [], "lockstep": 0, "saves": [], "evals": [], "evolved": [], "log": [],
           "spans": [], "refresh": []}
    real_train, real_pull, real_save = loop.train, device_ring.DeviceInputRing.pull_lockstep, \
        ckpt.CheckpointManager.save
    real_get, real_push = device_ring._Feeder.get, device_ring.DeviceInputRing.push
    spent = {"feed": 0.0, "push": 0.0}   # host seconds inside one lockstep refresh

    def timed(key, real):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return call
    real_eval, real_evolve = loop.compute_testset_loss, loop.evolve_ensemble_

    def train(*args, **kwargs):
        return real_train(*args, step_hook=lambda step, info: out["hooks"].append(
            (step, read_launches(), np.asarray(info["loss"]).tolist(), time.perf_counter())),
                          **kwargs)

    def pull_lockstep(self, *args, **kwargs):
        out["lockstep"] += 1
        spent.update(feed=0.0, push=0.0)
        try:
            return real_pull(self, *args, **kwargs)
        finally:
            out["refresh"].append((spent["feed"], spent["push"]))

    def save(self, step, *args, **kwargs):
        out["saves"].append(step)
        return real_save(self, step, *args, **kwargs)

    def evaluate(*args, **kwargs):
        t0 = time.perf_counter()
        result = real_eval(*args, **kwargs)
        out["spans"].append((t0, time.perf_counter(), None, None))
        out["evals"].append([np.asarray(v).tolist() for v in result[:3]])
        return result

    def evolve(*args, **kwargs):
        t0 = time.perf_counter()
        regenerated = real_evolve(*args, **kwargs)
        out["spans"].append((t0, time.perf_counter(), None, None))
        out["evolved"].append(regenerated)
        return regenerated

    class Capture(logging.Handler):
        def emit(self, record):
            out["log"].append(record.getMessage())

    loop.train, loop.compute_testset_loss, loop.evolve_ensemble_ = train, evaluate, evolve
    device_ring.DeviceInputRing.pull_lockstep = pull_lockstep
    device_ring._Feeder.get = timed("feed", real_get)
    device_ring.DeviceInputRing.push = timed("push", real_push)
    ckpt.CheckpointManager.save = save
    logging.getLogger("audio_to_midi_tpu_torch").addHandler(Capture())
    try:
        torch.cuda.reset_peak_memory_stats()
        out["rc"] = train_cli.main(argv + ["--process-id", str(rank)])
        out["peak"] = torch.cuda.max_memory_allocated()
        torch.save(out, Path(run, f"out{rank}.pt"))
    except BaseException:
        Path(run, f"error{rank}.txt").write_text(traceback.format_exc())
        raise


def run_group(world: int, target, args: tuple, name: str) -> list[dict]:
    """``target(*args, rank, run)`` on ``world`` spawned processes sharing the
    card -> each rank's result.  Every process is joined by the deadline;
    the stragglers are killed and the phase fails."""
    import multiprocessing as mp

    run = WORK / "ranks" / name
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(*args, rank, world, str(run))
                         if target is _rank_entry else (*args, rank, str(run)))
             for rank in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    errors = [(run / f"error{r}.txt").read_text() for r in range(world)
              if (run / f"error{r}.txt").exists()]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{name} on {world} ranks: hung {hung}, exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(errors)[-8000:])
    log(f"{name}: {world} ranks in {time.perf_counter() - t0:.1f} s (spawn and CUDA set-up "
        "included)")
    return [torch.load(run / f"out{r}.pt", weights_only=False) for r in range(world)]


def _parity_batch(cfg):
    gen = torch.Generator(device="cpu").manual_seed(15)
    audio = (torch.randn(PARITY_WINDOWS, 2, 80_000, generator=gen) * 0.5).cuda()
    labels = (torch.rand(PARITY_WINDOWS, SEQ, cfg.model.output_vocab, generator=gen) < 0.03)
    return audio, labels.float().cuda()


def _parity_step(mesh, control: bool = False) -> dict:
    """One f32 dropout-free step (warm-up 0, lr 1e-2) of the seeded default
    model on 16 windows in 2 minibatches of 8, on ``mesh`` or one rank: the
    loss, the gradients the optimizer took and the parameters after, both
    in full layout, and the step's launches.  ``control``: the step broken
    on purpose as :data:`CONTROLS` says for the mesh's layout."""
    from audio_to_midi_tpu_torch import convert
    from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
    from audio_to_midi_tpu_torch.infer import _parity_precision
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.parallel import mesh as pmesh
    from audio_to_midi_tpu_torch.train import optim, step as step_lib

    cfg = DEFAULT_CONFIG
    data = 1 if mesh is None else mesh.extent(pmesh.DATA_AXIS)
    cfg = dataclasses.replace(
        cfg, precision=dataclasses.replace(cfg.precision, compute_dtype="f32"),
        model=dataclasses.replace(cfg.model, transformer_dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, warmup_steps=0, base_learning_rate=1e-2,
                                  batch_size=PARITY_WINDOWS,
                                  minibatch_size_per_device=PARITY_MINIBATCH // data))
    model = seeded_model(model_lib, cfg).train()
    if mesh is not None:
        model = pmesh.place_model(model, mesh, cfg.model.num_transformer_heads)
    optimizer = optim.setup_optimizers(model, cfg.model, cfg.train, mesh)
    grads, real_update = [], optimizer.update

    def update(step_grads, valid):
        grads[:] = [g.clone() for g in step_grads]
        return real_update(step_grads, valid)

    optimizer.update = update
    if control and data > 1:
        real_reduce = mesh.all_reduce_
        mesh.all_reduce_ = lambda t, axis, *args: (
            real_reduce(t, axis, *args).mul_(data) if axis == pmesh.DATA_AXIS
            else real_reduce(t, axis, *args))  # cancels the step's .div_(data)
    elif control:
        optimizer._tp = types.SimpleNamespace(all_reduce=lambda x: x,
                                              sharded=optimizer._tp.sharded)
    step = step_lib.make_train_step(cfg, optimizer, model_lib.make_rope(cfg.model, "cuda"), mesh)
    audio, labels = (pmesh.local_minibatches(step_lib.reshape_to_minibatches(x, PARITY_MINIBATCH),
                                             mesh) for x in _parity_batch(cfg))
    try:
        with _parity_precision(torch.float32):
            reset_launches()
            out = step(model, audio, labels, 1.0)
            torch.cuda.synchronize()
            launches = read_launches()
    finally:
        if control and data > 1:
            mesh.all_reduce_ = real_reduce
    gather = (lambda: convert.params_to_jax(model)) if mesh is None else (
        lambda: pmesh.gather_params(model, mesh))
    params = {k: np.array(v) for k, v in gather().items()}
    with torch.no_grad():  # the gradients, gathered as the parameters are
        for p, g in zip(optimizer.params, grads, strict=True):
            p.copy_(g)
    return {"loss": float(out.loss), "valid": bool(out.grads_valid), "params": params,
            "grads": {k: np.array(v) for k, v in gather().items()}, "launches": launches}


def _default_steps(mesh, steps: int = 4) -> dict:
    """``steps`` default steps (bf16, dropout 0.1, cnn_bwd_kernel; batch 64,
    minibatch 32 x the data extent) of the seeded default model on ``mesh``
    (None: one rank), the batch of phase 5, no feed: the losses, each step's
    launches and host time, the digests of the parameters and the Philox
    dump of this rank's first attention seed."""
    from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
    from audio_to_midi_tpu_torch.models import attention
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.ops import attention_kernels as ak
    from audio_to_midi_tpu_torch.parallel import mesh as pmesh
    from audio_to_midi_tpu_torch.train import optim, step as step_lib

    cfg = DEFAULT_CONFIG
    train_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, warmup_steps=0))
    model = seeded_model(model_lib, cfg).train()
    if mesh is not None:
        model = pmesh.place_model(model, mesh, cfg.model.num_transformer_heads)
    optimizer = optim.setup_optimizers(model, cfg.model, cfg.train, mesh)
    step = step_lib.make_train_step(train_cfg, optimizer, model_lib.make_rope(cfg.model, "cuda"),
                                    mesh)
    data = 1 if mesh is None else mesh.extent(pmesh.DATA_AXIS)
    minibatch = cfg.train.minibatch_size_per_device * data
    gen = torch.Generator(device="cpu").manual_seed(4)
    audio = (torch.randn(cfg.train.batch_size, 2, 80_000, generator=gen) * 0.5).cuda()
    labels = (torch.rand(cfg.train.batch_size, SEQ, 90, generator=gen) < 0.03).float().cuda()
    audio, labels = (pmesh.local_minibatches(step_lib.reshape_to_minibatches(x, minibatch), mesh)
                     for x in (audio, labels))
    seeds, real_seed = [], attention.new_dropout_seed

    def new_dropout_seed(*args, **kwargs):
        seed = real_seed(*args, **kwargs)
        if not seeds:
            seeds.append(seed.clone())
        return seed

    attention.new_dropout_seed = new_dropout_seed
    generator = torch.Generator().manual_seed(7)
    losses, launches, times = [], [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(steps):
            reset_launches()
            t0 = time.perf_counter()
            out = step(model, audio, labels, 1.0, generator)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(read_launches())
            losses.append(float(out.loss))
            if not bool(out.grads_valid):
                raise AssertionError("a default step under the mesh was not valid")
    finally:
        attention.new_dropout_seed = real_seed
    dump = ak.philox_bits(seeds[0], 2, TWO_HEADS, PADDED)
    return {"losses": losses, "launches": launches, "times": times,
            "peak": torch.cuda.max_memory_allocated(),
            "digest_all": pmesh.param_digest(list(model.parameters())),
            "digest_replicated": pmesh.param_digest(pmesh.replicated_params(model)),
            "philox": pmesh.param_digest([dump]), "seed": seeds[0].tolist()}


def _on_rank_zero_alone(mesh_free_work):
    """Run ``mesh_free_work`` on rank 0 alone while the other ranks wait at a
    barrier, so that it has the card to itself; its result on rank 0."""
    import torch.distributed as dist

    out = mesh_free_work() if dist.get_rank() == 0 else None
    dist.barrier()
    return out


def _parallel_job(run: Path) -> dict:
    """One rank of phase 15's group of 2: one rank's references (phase 3's
    forward, the f32 step, phase 4's file), then TP 2 (the forward on 2
    local heads, the f32 step, the default steps), then DP 2 (the f32
    step, the default steps, one gradient all-reduce, sharded serving)."""
    from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
    from audio_to_midi_tpu_torch.infer import _parity_precision, load_params, transcribe_file
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.parallel import mesh as pmesh

    cfg = DEFAULT_CONFIG
    out = {}
    gen = torch.Generator(device="cpu").manual_seed(1)
    audio = (torch.randn(BATCH, 2, 80_000, generator=gen) * 0.5).cuda()   # phase 3's windows
    rope = model_lib.make_rope(cfg.model, "cuda")

    def forwards(model):
        probs, launches = {}, {}
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            m = model if dt == torch.float32 else model_lib.cast_params(copy.deepcopy(model), dt)
            with torch.inference_mode(), _parity_precision(dt):
                reset_launches()
                probs[name] = model_lib.forward(m, cfg.model, audio.to(dt), rope)[1].float()
                torch.cuda.synchronize()
                launches[name] = read_launches()
        return probs, launches

    single, _ = forwards(seeded_model(model_lib, cfg))
    single_step = _parity_step(None)
    # One rank's default steps with the card to itself, for the times.
    out["one rank steps"] = _on_rank_zero_alone(lambda: _default_steps(None))

    tp = pmesh.make_mesh(1, model_size=2)
    sharded = pmesh.place_model(seeded_model(model_lib, cfg), tp, cfg.model.num_transformer_heads)
    probs, launches = forwards(sharded)
    out["tp forward"] = {"err": {k: max_err(probs[k], single[k]) for k in probs},
                         "finite": all(bool(torch.isfinite(p).all()) for p in probs.values()),
                         "shape": tuple(probs["f32"].shape), "launches": launches}
    del sharded, probs
    out["tp step"] = _parity_step(tp)
    out["tp control"] = _parity_step(tp, control=True)
    out["tp steps"] = _default_steps(tp)

    dp = pmesh.make_mesh(1)
    out["dp step"] = _parity_step(dp)
    out["dp control"] = _parity_step(dp, control=True)
    out["dp steps"] = _default_steps(dp)
    flat = torch.zeros(model_lib.param_count(seeded_model(model_lib, cfg)), device="cuda")
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp.all_reduce_(flat, pmesh.DATA_AXIS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["all_reduce"] = {"times": times[1:], "numel": flat.numel()}

    wav = WORK / "synth.wav"
    m32 = load_params(WORK / "params.npz", cfg, "cuda", torch.float32)
    ref, ref_dpf, ref_events = transcribe_file(m32, cfg, wav)
    reset_launches()
    stitched, dpf, events = transcribe_file(m32, cfg, wav, mesh=dp)
    torch.cuda.synchronize()
    out["serving"] = {"err": float(np.abs(stitched - ref).max()), "dpf": (dpf, ref_dpf),
                      "events": events == ref_events, "n_events": len(events),
                      "near": min(float(np.abs(ref - t).min()) for t in EVENT_THRESHOLDS),
                      "launches": read_launches()}
    out["single step"] = single_step
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def _step_readings(single: dict, got: dict, before: dict) -> dict:
    """A sharded f32 parity step against one rank's: the loss's relative
    difference, the largest gradient difference over the leaf's largest
    gradient, the largest update difference, the share of leaves the
    sharded step moved, and one rank's largest update."""
    grad = upd = largest = 0.0
    moved = 0
    for k, ref in single["params"].items():
        upd_ref, upd_got = ref - before[k], got["params"][k] - before[k]
        moved += bool(np.any(upd_got != 0))
        upd = max(upd, float(np.abs(upd_got - upd_ref).max()))
        largest = max(largest, float(np.abs(upd_ref).max()))
        g_ref = single["grads"][k]
        grad = max(grad, float(np.abs(got["grads"][k] - g_ref).max())
                   / max(float(np.abs(g_ref).max()), 1e-30))
    return {"loss": abs(got["loss"] - single["loss"]) / abs(single["loss"]), "grad": grad,
            "update": upd, "moved": moved / len(single["params"]), "largest": largest}


def _step_verdicts(r: dict) -> dict[str, bool]:
    return {"loss": r["loss"] <= PARALLEL_LOSS_TOL, "gradients": r["grad"] <= GRAD_TOL,
            "updates": r["update"] <= UPDATE_ATOL, "moved": r["moved"] > 0.8}


def _describe_step(r: dict) -> str:
    return (f"loss relative {r['loss']:.2e} (tol {PARALLEL_LOSS_TOL:.0e}); gradients "
            f"{r['grad']:.2e} of the leaf's largest (tol {GRAD_TOL:.0e}); updates largest "
            f"difference {r['update']:.2e} (tol {UPDATE_ATOL:.0e}; one rank's largest update "
            f"{r['largest']:.2e}); {r['moved']:.0%} of the leaves moved")


def check_parallel(cfg, card: str, one_member_times: list[float]) -> dict[str, dict[str, int]]:
    """Phase 15: parallel/ on the card, every rank a process sharing it over
    gloo (NCCL takes one rank per card), spawned, with a rendezvous and a
    join deadline.

    1. kernels 1, 2, 9, 7, 15, 12, 16, 13 on 2 heads of 64 against their
       plain versions (:func:`check_two_heads`);
    2. TP 2: phase 3's forward on 2 local heads, bf16 and f32, against one
       rank's, with 8 launches of kernels 1 and 2 per forward per rank; one
       f32 dropout-free step against one rank's (loss, gradients, updates),
       with 16 launches of kernels 9 and 7 per rank, and the same step with
       a clip norm that skips the model all-reduce, which the check must
       reject; four default steps (dropout
       0.1, bf16) with 16 launches of each of 15, 12, 16, 13 and 4 of 20 per
       rank per step, the replicated parameters bit for bit alike on both
       ranks, and the two ranks' attention seeds' Philox bytes different;
    3. DP 2: the same f32 step, and its control without the division over
       "data", then four default steps (the minibatch
       32 x 2, one per step: 8 launches of each seeded kernel and 2 of 20
       per rank per step), every parameter bit for bit alike;
    4. cli/train_cli.py on 2 processes (--coordinator-address,
       --num-processes, --process-id, --dist-backend gloo) at the default
       config, the ring and the augmentation on the card, 4 steps: the
       lockstep refresh on both ranks, the same parameter digest, each
       checkpoint written once (by rank 0), a resume at latest + 1; the same
       with model_parallel_size 2; and --ensemble-size 4 over 4 processes
       with evaluation and evolution at steps 2 and 4, (4,) leaves on disk;
    5. transcribe_file over 2 data ranks on phase 4's WAV, against one
       rank's (phase 4's tolerance), the events identical;
    6. ms per step per layout beside phase 13's one rank, the peak device
       memory per rank, one gradient all-reduce over gloo.  The ranks share
       one card: these numbers are the port's overheads, not scaling."""
    from audio_to_midi_tpu_torch import convert
    from audio_to_midi_tpu_torch.config import config_to_json
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.ops import attention_kernels as ak

    started = time.perf_counter()
    two_heads = check_two_heads(ak)
    log(f"phase 15.1: {len(two_heads)} cases on 2 heads held against their plain versions")
    before = convert.params_to_jax(seeded_model(model_lib, cfg))
    ranks = run_group(2, _rank_entry, ("_parallel_job",), "tp2_dp2")
    launches: dict[str, dict[str, int]] = {}
    names = list(read_launches())
    sum_ranks = lambda counts: {k: sum(c[k] for c in counts) for k in names}

    single = ranks[0]["single step"]
    for layout in ("tp", "dp"):
        if layout == "tp":
            for r, got in enumerate(rank["tp forward"] for rank in ranks):
                for dt, err in got["err"].items():
                    want = {k: 0 for k in names} | {"global_attention": 8, "local_two_phase": 8}
                    ok = (got["finite"] and err <= FORWARD_TOL[dt] and got["launches"][dt] == want
                          and got["shape"] == (BATCH, SEQ, 90))
                    log(f"tp2 forward rank {r} {dt}: against one rank max_abs_err {err:.3e} (tol "
                        f"{FORWARD_TOL[dt]:.0e}), launches "
                        f"{ {k: v for k, v in got['launches'][dt].items() if v} } "
                        f"{'OK' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"the TP 2 forward ({dt}) disagrees with one rank")
            launches["tp2 forward"] = sum_ranks([rank["tp forward"]["launches"][dt]
                                                 for rank in ranks for dt in ("bf16", "f32")])
        steps = [r[f"{layout} step"] for r in ranks]
        # 2 minibatches per rank (of 8 under TP, of 4 under DP), 8 layers each.
        want = {k: 0 for k in names} | {"global_attention": 16, "local_two_phase": 16,
                                         "global_attention_grads": 16,
                                         "local_two_phase_grads": 16, "stage_bwd": 4}
        for r, got in enumerate(steps):
            readings = _step_readings(single, got, before)
            ok = got["valid"] and all(_step_verdicts(readings).values())
            log(f"{layout}2 f32 step rank {r}: loss {got['loss']:.4f} vs one rank "
                f"{single['loss']:.4f}; {_describe_step(readings)}; launches "
                f"{ {k: v for k, v in got['launches'].items() if v} } "
                f"{'OK' if ok and got['launches'] == want else 'FAIL'}")
            if not ok or got["launches"] != want:
                raise AssertionError(f"the {layout.upper()} 2 f32 step disagrees with one rank "
                                     f"or launched {got['launches']}, expected {want}")
        launches[f"{layout}2 f32 step"] = sum_ranks([s["launches"] for s in steps])
        # The broken control must fail: TP's clip shows in the updates
        # only, DP's missing division in the gradients (Adam's first step
        # hardly sees a gradient's scale).
        must_fail = "updates" if layout == "tp" else "gradients"
        for r, got in enumerate(rank[f"{layout} control"] for rank in ranks):
            readings = _step_readings(single, got, before)
            failed = [k for k, ok in _step_verdicts(readings).items() if not ok]
            log(f"{layout}2 f32 control rank {r} ({CONTROLS[layout]}): "
                f"{_describe_step(readings)}; fails {failed} "
                f"{'OK' if must_fail in failed else 'FAIL'}")
            if must_fail not in failed:
                raise AssertionError(f"the {layout.upper()} 2 parity check passes a step with "
                                     f"{CONTROLS[layout]}")

        runs = [r[f"{layout} steps"] for r in ranks]
        per = 16 if layout == "tp" else 8
        want = {k: 0 for k in names} | {k: per for k in (
            "global_attention_dropout", "local_two_phase_dropout", "global_attention_grads_prng",
            "local_two_phase_grads_prng")} | {"stage_bwd": per // 4}
        for r, got in enumerate(runs):
            wrong = [i for i, c in enumerate(got["launches"]) if c != want]
            if wrong or not all(math.isfinite(x) for x in got["losses"]):
                raise AssertionError(f"{layout}2 default steps, rank {r}: losses {got['losses']}, "
                                     f"steps {wrong} launched otherwise than {want}")
        same_rep = runs[0]["digest_replicated"] == runs[1]["digest_replicated"]
        same_all = runs[0]["digest_all"] == runs[1]["digest_all"]
        seeds_differ = runs[0]["philox"] != runs[1]["philox"]
        log(f"{layout}2 default steps (bf16, dropout 0.1, batch 64): losses "
            + " | ".join(", ".join(f"{x:.2f}" for x in got["losses"]) for got in runs)
            + f"; replicated parameters alike on both ranks {same_rep}, all {same_all}; first "
            f"attention seeds {runs[0]['seed']} / {runs[1]['seed']}, their Philox bytes differ "
            f"{seeds_differ}; per rank per step "
            f"{ {k: v for k, v in want.items() if v} }")
        if not same_rep or (layout == "dp" and not same_all) or (layout == "tp" and same_all):
            raise AssertionError(f"{layout}2: the replicas fell out of step")
        if layout == "tp" and not seeds_differ:
            raise AssertionError("tp2: both model ranks drew the same attention masks")
        if layout == "dp" and runs[0]["losses"] != runs[1]["losses"]:
            raise AssertionError("dp2: the ranks disagree on the loss")
        launches[f"{layout}2 default steps"] = sum_ranks(
            [c for got in runs for c in got["launches"]])
        times = [t for got in runs for t in got["times"][1:]]
        alone = ranks[0]["one rank steps"]
        log(f"{layout}2 default steps on one card shared by 2 ranks: {_quartiles(times)} per "
            f"step (steps 2-4 of both ranks, host clock, no feed) beside one rank's "
            f"{_quartiles(alone['times'][1:])} (the same steps with the card to itself, this "
            f"call); peak device memory per rank "
            + ", ".join(f"{got['peak'] / 2**30:.2f}" for got in runs)
            + f" GiB (one rank: {alone['peak'] / 2**30:.2f}); on {card} (the ranks share one "
            "card: overheads, not scaling)")

    serving = [r["serving"] for r in ranks]
    for r, got in enumerate(serving):
        ok = got["err"] <= FORWARD_TOL["f32"] and (got["events"]
                                                    or got["near"] <= FORWARD_TOL["f32"])
        log(f"sharded serving rank {r}: phase 4's WAV over 2 data ranks against one rank, "
            f"stitched max_abs_err {got['err']:.3e} (tol {FORWARD_TOL['f32']:.0e}), "
            f"{got['n_events']} events, identical {got['events']} {'OK' if ok else 'FAIL'}")
        if not ok or got["dpf"][0] != got["dpf"][1]:
            raise AssertionError("sharded serving disagrees with one rank")
    launches["sharded serving"] = sum_ranks([got["launches"] for got in serving])
    reduce_times = [t for r in ranks for t in r["all_reduce"]["times"]]
    log(f"one gradient all-reduce over gloo ({ranks[0]['all_reduce']['numel']:,} f32 on the "
        f"card, 2 ranks sharing it): {_quartiles(reduce_times)}; on {card}")

    # --- the multi-host CLI ---
    train_dir, val_dir = WORK / "train_set", WORK / "val_set"
    for name, world, train, extra in (
            ("cli dp2", 2, {}, []),
            ("cli tp2", 2, {"model_parallel_size": 2}, []),
            ("cli ensemble axis", 4, {"ensemble_size": 4, "testset_loss_every": 2},
             ["--testset", f"val={val_dir}"])):
        run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, num_steps=4, print_every=1, checkpoint_every=2,
            testset_loss_every=train.pop("testset_loss_every", 1000), **train))
        cfg_path = WORK / f"{name.replace(' ', '_')}.json"
        cfg_path.write_text(config_to_json(run_cfg))
        ck = WORK / f"{name.replace(' ', '_')}_ck"
        shutil.rmtree(ck, ignore_errors=True)
        resumes = (False, True) if name == "cli dp2" else (False,)
        for resume in resumes:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            argv = ["--dataset", str(train_dir), "--config", str(cfg_path), "--checkpoint",
                    str(ck), "--no-tensorboard", "--device", "cuda", "--dist-backend", "gloo",
                    "--coordinator-address", f"127.0.0.1:{port}", "--num-processes",
                    str(world), *extra] + (["--steps", "5"] if resume else [])
            runs = run_group(world, _cli_rank, (argv,),
                             name.replace(" ", "_") + ("_resume" if resume else ""))
            check_cli_ranks(name, runs, resume, ck, run_cfg, names, card, launches,
                            one_member_times)
    log(f"phase 15 took {time.perf_counter() - started:.1f} s")
    return launches


def check_cli_ranks(name, runs, resume, ck, run_cfg, names, card, launches,
                    one_rank: list[float]) -> None:
    """The ranks of one multi-process train_cli run: steps, launches per
    step per rank, the lockstep refresh, the digests, the checkpoint writes
    and, for a population, the evaluations and evolutions."""
    from audio_to_midi_tpu_torch.train import checkpoint as ckpt

    world = len(runs)
    e = run_cfg.train.ensemble_size
    data = world // (run_cfg.train.model_parallel_size * e)
    minibatch = min(run_cfg.train.minibatch_size_per_device * data, run_cfg.train.batch_size)
    minibatches = run_cfg.train.batch_size // minibatch   # per rank per step
    seeded = ("global_attention_dropout", "local_two_phase_dropout",
              "global_attention_grads_prng", "local_two_phase_grads_prng")
    want = {k: run_cfg.model.num_transformer_layers * minibatches for k in seeded} | {
        "stage_bwd": 2 * minibatches}
    steps = [5] if resume else [1, 2, 3, 4]
    digests = set()
    for r, got in enumerate(runs):
        got_steps = [h[0] for h in got["hooks"]]
        deltas, previous = [], {k: 0 for k in names}
        for _step, counts, _loss, _t in got["hooks"]:
            deltas.append({k: counts[k] - previous[k] for k in want})
            previous = counts
        digest = [m for m in got["log"] if "parameter digest" in m]
        digests |= {m.split("parameter digest ")[1] for m in digest}
        losses = [x for h in got["hooks"] for x in np.reshape(h[2], -1)]
        ok = (got["rc"] == 0 and got_steps == steps and all(d == want for d in deltas)
              and got["lockstep"] == len(steps) and len(digest) == 1
              and all(math.isfinite(x) for x in losses))
        log(f"{name}{' resume' if resume else ''} rank {r}: steps {got_steps}, lockstep "
            f"refreshes {got['lockstep']}, launches per step {deltas[-1]} (expected {want}), "
            f"losses {', '.join(f'{x:.2f}' for x in losses)}, checkpoint writes {got['saves']}, "
            f"evaluations {len(got['evals'])}, evolutions {got['evolved']}, peak device memory "
            f"{got['peak'] / 2**30:.2f} GiB {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} rank {r}: {got['log'][-20:]}")
        if (r == 0) != bool(got["saves"]):
            raise AssertionError(f"{name}: rank {r} wrote checkpoints {got['saves']}")
    if len(digests) != 1:
        raise AssertionError(f"{name}: the ranks end with different parameters {digests}")
    on_disk = ckpt.CheckpointManager(ck).all_steps()
    want_disk = [2, 4, 5] if resume else [2, 4]
    flat, _ = ckpt.restore_raw(ck)
    lead = {v.shape[0] for v in flat.values()}
    if on_disk != want_disk or (e > 1 and lead != {e}) or runs[0]["saves"] != (
            [5] if resume else [2, 4]):
        raise AssertionError(f"{name}: checkpoints {on_disk}, leading axes {lead}")
    if e > 1:
        for got in runs:
            if len(got["evals"]) != 2 or len(got["evolved"]) != 2 or got["evolved"] != runs[0][
                    "evolved"]:
                raise AssertionError(f"{name}: evaluations {got['evals']}, evolutions "
                                     f"{got['evolved']}")
    # ms per step between the hooks, the evaluations and evolutions taken out.
    times = [_interval_without(got["spans"], a[3], b[3])[0] for got in runs
             for a, b in zip(got["hooks"], got["hooks"][1:])]
    # The refreshes of the same steps: waiting for the rank's feed, and the
    # pushes (the gather over the ranks, queuing the copy).
    feed, push = ([r[i] for got in runs for r in got["refresh"][1:]] for i in (0, 1))
    log(f"{name}{' resume' if resume else ''}: {world} ranks, one parameter digest, "
        f"checkpoints {on_disk} written by rank 0"
        + (f", leaves lead with ({e},)" if e > 1 else "")
        + (f"; {_quartiles(times)} per step (steps 2-4 of every rank, host clock, evaluations "
           f"and evolutions taken out) beside phase 13's one rank {_quartiles(one_rank)}; peak "
           "device memory per rank " + ", ".join(f"{got['peak'] / 2**30:.2f}" for got in runs)
           + " GiB; the lockstep refresh of those steps: waiting for the feed "
           + _quartiles(feed) + ", the pushes " + _quartiles(push) if times else "")
        + f"; on {card} (the ranks share one card: overheads, not scaling)")
    key = name + (" resume" if resume else "")
    launches[key] = {k: sum(got["hooks"][-1][1][k] for got in runs) for k in names}


def route_cfg(cfg, route: str):
    """``cfg`` on one of ``ROUTES``."""
    attention, cnn = {"pallas_stage": ("pallas", "pallas_stage"),
                      "xla": ("xla", "xla")}.get(route, (route, cfg.model.cnn_impl))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attention_impl=attention, cnn_impl=cnn))


def expected_nodes(cfg, route: str) -> dict[str, int]:
    layers = cfg.model.num_transformer_layers
    nodes = {op: n * layers for op, n in ROUTE_NODES[route].items()}
    if route == "pallas_stage":
        nodes["convnext_stage_fwd"] = 3  # stages 4, 5, 6
    return nodes


def _recording(module, name: str, calls: dict):
    """``module.name`` (a kernel's operator) replaced by one that keeps its
    first call's arguments beside ``torch.ops.a2m.<name>``; returns the
    original."""
    real = getattr(module, name)

    def recorded(*args):
        calls.setdefault(name, (getattr(torch.ops.a2m, name).default, args))
        return real(*args)

    setattr(module, name, recorded)
    return real


def check_exported_programs(model_lib, cfg, model, card: str) -> dict[str, dict[str, int]]:
    """Phase 16a: ``export.py`` on the card.  The default model exported at
    f32 and bf16 (8 + 8 kernel nodes each) and at JAX's default f16 (none),
    saved, loaded and run in a fresh process with its launches counted,
    its outputs held against eager ``predict`` bit for bit; each other route
    exported at bf16, its nodes counted, run here against eager ``predict``
    bit for bit; every kernel operator's fake implementation against its
    CUDA implementation (``torch.library.opcheck``) on the arguments the
    model gives it.  Returns the launches of each program's run."""
    from audio_to_midi_tpu_torch import export as ex
    from audio_to_midi_tpu_torch.infer import _parity_precision
    from audio_to_midi_tpu_torch.ops import attention_kernels as ak
    from audio_to_midi_tpu_torch.ops import convnext_kernels as ck
    from audio_to_midi_tpu_torch.ops import fused_layer_kernels as flk

    out_dir = WORK / "export"
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cpu").manual_seed(16)
    samples = torch.randn(2, cfg.data.samples_per_window, generator=gen) * 0.5
    np.save(out_dir / "samples.npy", samples.numpy())
    rope = model_lib.make_rope(cfg.model, "cuda")
    models = {"f32": model, "bf16": model_lib.cast_params(copy.deepcopy(model), torch.bfloat16)}

    def eager(m, run_cfg, dt):
        with torch.no_grad(), _parity_precision(dt):
            return model_lib.predict(m, run_cfg.model, samples.cuda().to(dt), rope)

    for name, m in models.items():
        dt = DTYPES[name]
        t0 = time.perf_counter()
        program = ex.export_program(m, cfg, example_dtype=dt, output_file=out_dir / f"{name}.pt2")
        wall = time.perf_counter() - t0
        nodes = ex.kernel_nodes(program)
        log(f"export {name} (default route): a2m nodes {nodes}, export wall {wall:.2f} s, "
            f".pt2 {(out_dir / f'{name}.pt2').stat().st_size:,} bytes")
        if nodes != expected_nodes(cfg, "pallas"):
            raise AssertionError(f"the {name} program holds {nodes}")
        for part, t in zip(("logits", "probs"), eager(m, cfg, dt)):
            np.save(out_dir / f"{name}_eager_{part}.npy", t.float().cpu().numpy())
    t0 = time.perf_counter()
    f16_nodes = ex.kernel_nodes(ex.export_program(model, cfg))
    log(f"export f16 (JAX's default example dtype, f32 parameters): a2m nodes {f16_nodes} "
        f"(none expected: no kernel takes f16), export wall {time.perf_counter() - t0:.2f} s")
    if f16_nodes:
        raise AssertionError("the f16 program reaches a kernel")

    code = textwrap.dedent(f"""
        import json, time
        import numpy as np, torch
        from audio_to_midi_tpu_torch import export as ex
        from audio_to_midi_tpu_torch.ops import attention_kernels as ak, convnext_kernels as ck
        from audio_to_midi_tpu_torch.ops import eventize, fused_layer_kernels as flk
        kernels = ak.KERNELS + ck.KERNELS + flk.KERNELS + eventize.KERNELS
        out = {{}}
        samples = torch.from_numpy(np.load({str(out_dir / "samples.npy")!r})).cuda()
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            t0 = time.perf_counter()
            program = ex.load_program({str(out_dir)!r} + "/" + name + ".pt2")
            load = time.perf_counter() - t0
            for fn in kernels:
                fn.launches = 0
            logits, probs = ex.run_program(program, samples.to(dt))
            torch.cuda.synchronize()
            np.save({str(out_dir)!r} + "/" + name + "_loaded_logits.npy", logits.float().cpu().numpy())
            np.save({str(out_dir)!r} + "/" + name + "_loaded_probs.npy", probs.float().cpu().numpy())
            out[name] = {{"load_s": load, "launches": {{fn.__name__: fn.launches for fn in kernels}}}}
        print(json.dumps(out))
    """)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"loading the programs in a fresh process failed:\n{proc.stderr}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    paths = {"exported program": dict.fromkeys(read_launches(), 0)}
    for name in models:
        same = all(np.array_equal(np.load(out_dir / f"{name}_loaded_{part}.npy"),
                                  np.load(out_dir / f"{name}_eager_{part}.npy"))
                   for part in ("logits", "probs"))
        launches = {k: v for k, v in loaded[name]["launches"].items() if v}
        log(f"loaded program {name} in a fresh process (load {loaded[name]['load_s']:.2f} s): "
            f"logits and probs equal to eager predict's bit for bit {same}; launches {launches}")
        if not same or launches != {"global_attention": cfg.model.num_transformer_layers,
                                    "local_two_phase": cfg.model.num_transformer_layers}:
            raise AssertionError(f"the loaded {name} program is not eager predict")
        for k, v in loaded[name]["launches"].items():
            paths["exported program"][k] += v
    log(f"fresh-process round: {time.perf_counter() - t0:.1f} s")

    # The other routes, bf16, and the operators' fakes against their CUDA
    # implementations on the model's own arguments.
    calls: dict = {}
    hooks = [(ak, "global_attention_fwd"), (ak, "local_two_phase_fwd"),
             (flk, "attention_block_fwd"), (flk, "fused_sublayer_fwd"),
             (flk, "transformer_pair_fwd"), (ck, "convnext_stage_fwd")]
    bf16 = models["bf16"]
    for route in ROUTES[1:-1]:
        run_cfg = route_cfg(cfg, route)
        t0 = time.perf_counter()
        program = ex.export_program(bf16, run_cfg, example_dtype=torch.bfloat16)
        wall = time.perf_counter() - t0
        nodes = ex.kernel_nodes(program)
        reset_launches()
        got = ex.run_program(program, samples.cuda().bfloat16())
        torch.cuda.synchronize()
        launches = read_launches()
        reals = [(mod, name, _recording(mod, name, calls)) for mod, name in hooks]
        try:
            ref = eager(bf16, run_cfg, torch.bfloat16)
        finally:
            for mod, name, real in reals:
                setattr(mod, name, real)
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"export bf16 {route}: a2m nodes {nodes}, export wall {wall:.2f} s; its run "
            f"equal to eager predict's bit for bit {same}, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if nodes != expected_nodes(cfg, route) or not same:
            raise AssertionError(f"the {route} program is not eager predict's route")
        paths[f"exported program {route}"] = launches
    for name, (op, args) in calls.items():
        t0 = time.perf_counter()
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
        log(f"opcheck a2m::{name} on the card (schema; fake vs CUDA implementation: shape, "
            f"dtype, strides) at {tuple(args[0].shape)} {args[0].dtype}: OK "
            f"({time.perf_counter() - t0:.2f} s)")
    if len(calls) != len(hooks):
        raise AssertionError(f"operators never called: {sorted({n for _, n in hooks} - set(calls))}")
    return paths


def full_geometry_case() -> types.ModuleType:
    """tests/full_geometry.py of this checkout, loaded by its path: a
    ``tests`` package installed elsewhere may take the name."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("full_geometry",
                                                  ROOT / "tests" / "full_geometry.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def full_geometry_weights(model_lib, cfg, fg, layer_scale: float) -> dict[str, np.ndarray]:
    from audio_to_midi_tpu_torch import convert

    shapes = {k: v.shape for k, v in
              convert.state_dict_to_jax(model_lib.Model(cfg.model).state_dict()).items()}
    return fg.weights(shapes, layer_scale=layer_scale)


def full_geometry_model(model_lib, run_cfg, weights, dtype: torch.dtype):
    """The port's model of ``run_cfg`` on the card, loaded with the flat JAX
    ``weights`` and cast to ``dtype``."""
    from audio_to_midi_tpu_torch import convert

    m = model_lib.Model(run_cfg.model)
    m.load_state_dict(convert.jax_to_state_dict(weights), strict=True)
    return m.to(device="cuda", dtype=dtype)


def logits_error(model_lib, m, run_cfg, fg, golden, name: str) -> float:
    """The largest |logit difference| over the largest |logit| of the
    full-geometry forward of ``m`` (in ``name``'s dtype) on ``run_cfg``'s
    route against ``golden``'s JAX logits."""
    from audio_to_midi_tpu_torch.infer import _parity_precision

    dt = DTYPES[name]
    x = torch.from_numpy(fg.audio()).cuda().to(dt)
    with torch.inference_mode(), _parity_precision(dt):
        logits, _ = model_lib.forward(m, run_cfg.model, x,
                                      model_lib.make_rope(run_cfg.model, "cuda"))
    return fg.relative_error(logits.float().cpu().numpy(), golden[f"logits_{name}"])


def grad_digest(model_lib, m, run_cfg, fg, name: str) -> tuple[dict, float]:
    """The digest (tests/full_geometry.grad_digest) of the gradients of the
    training loss of ``m`` (f32 parameters) on the card: the forward in
    ``name``'s dtype on ``run_cfg``'s route, no dropout, scale 1, the seeded
    labels; and the loss."""
    from audio_to_midi_tpu_torch import convert
    from audio_to_midi_tpu_torch.infer import _parity_precision
    from audio_to_midi_tpu_torch.train import loss as loss_lib

    for p in m.parameters():
        p.grad = None
    with _parity_precision(DTYPES[name]):
        loss = loss_lib.batch_loss(m, run_cfg.model, torch.from_numpy(fg.audio()).cuda(),
                                   torch.from_numpy(fg.labels()).cuda(),
                                   model_lib.make_rope(run_cfg.model, "cuda"), 1.0, DTYPES[name],
                                   enable_dropout=False)
        loss.backward()
    grads = convert.state_dict_to_jax({n: p.grad for n, p in m.named_parameters()})
    if not all(np.isfinite(g).all() for g in grads.values()):
        raise AssertionError(f"a {name} gradient is not finite on {run_cfg.model.attention_impl}")
    return fg.grad_digest(grads), loss.item()


def judge(what: str, readings: dict, broken: dict, limit: dict) -> None:
    """Raise unless every reading ((route, dtype) -> error) lies within its
    dtype's ``limit`` and every control ((control, dtype) -> error) outside."""
    bad = {k: v for k, v in readings.items() if v > limit[k[1]]}
    if bad:
        raise AssertionError(f"{what} outside the limits {limit}: {bad}")
    caught = {k: v for k, v in broken.items() if v <= limit[k[1]] and k[0] != UNJUDGED}
    if caught:
        raise AssertionError(f"the limits {limit} of {what} do not catch the controls {caught}")


def full_geometry_logits(model_lib, cfg, fg, golden, flat, controls: dict, limit: dict,
                         what: str) -> None:
    """The full-geometry logits of ``flat`` on every route of ``ROUTES`` in f32
    and bf16 against ``golden``'s JAX logits within ``limit``, and each of
    ``controls`` (dtype -> name -> broken weights, on the default route)
    outside it."""
    readings, broken = {}, {}
    for name in ("f32", "bf16"):
        m = full_geometry_model(model_lib, cfg, flat, DTYPES[name]).eval()
        for route in ROUTES:
            readings[(route, name)] = logits_error(model_lib, m, route_cfg(cfg, route), fg, golden,
                                                   name)
        for c, w in controls[name].items():
            broken[(c, name)] = logits_error(
                model_lib, full_geometry_model(model_lib, cfg, w, DTYPES[name]).eval(), cfg, fg,
                golden, name)
        log(f"{what} {name} against JAX (max |dlogit| / max |logit|, limit "
            f"{limit[name]:.0e}): " + ", ".join(f"{r} {readings[(r, name)]:.3e}" for r in ROUTES)
            + "; controls (pallas) "
            + ", ".join(f"{c} {v:.3e}" for (c, n), v in broken.items() if n == name))
    judge(what, readings, broken, limit)


def check_full_geometry(model_lib, cfg, card: str) -> None:
    """Phase 16b: the full-geometry parity against the JAX package (the case
    of tests/full_geometry.py, the JAX logits of its golden file) on every
    route in f32 and bf16, and the broken control outside the limits."""
    fg = full_geometry_case()
    flat = full_geometry_weights(model_lib, cfg, fg, fg.LAYER_SCALE_INIT)
    control = {"global layer 3's query heads rotated":
               fg.rotate_heads(flat, 3, cfg.model.num_transformer_heads)}
    full_geometry_logits(model_lib, cfg, fg, np.load(ROOT / "tests" / fg.GOLDEN), flat,
                         {"f32": control, "bf16": control}, PARITY_LIMIT, "full-geometry parity")


def blocks_controls(cfg, fg, flat) -> dict[str, dict[str, dict[str, np.ndarray]]]:
    """Phase 16c's broken controls by dtype.  One global layer's rotated
    query heads move the logits at layer scale 1 by ~0.03 of the largest,
    inside bf16's own spread, so bf16 takes every layer's heads rotated and
    reads that one unjudged (``UNJUDGED``)."""
    heads, layers = cfg.model.num_transformer_heads, cfg.model.num_transformer_layers
    one_layer, taps = fg.rotate_heads(flat, 3, heads), fg.reverse_taps(flat)
    return {"f32": {"global layer 3's query heads rotated": one_layer,
                    "stage 5's taps reversed": taps},
            "bf16": {"every layer's query heads rotated": fg.rotate_every_head(flat, layers, heads),
                     "stage 5's taps reversed": taps, UNJUDGED: one_layer}}


def full_geometry_grads(model_lib, cfg, fg, golden, flat, controls: dict):
    """Phase 16c's gradient readings: each route of ``GRAD_ROUTES`` and each
    control (on the default route) against the JAX digest of ``golden``, f32
    and bf16, logged.  Returns (readings, controls' readings, the launches
    of the default route)."""
    from audio_to_midi_tpu_torch import convert

    paths = sorted(convert.state_dict_to_jax(model_lib.Model(cfg.model).state_dict()))
    meta = json.loads(str(golden["meta"]))
    launches = dict.fromkeys(read_launches(), 0)
    readings, broken = {}, {}
    m = full_geometry_model(model_lib, cfg, flat, torch.float32).train()
    for name in ("f32", "bf16"):
        want = fg.golden_digest(golden, name)
        for route, (attention, cnn, bwd_kernel) in GRAD_ROUTES.items():
            run_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, attention_impl=attention, cnn_impl=cnn, cnn_bwd_kernel=bwd_kernel))
            reset_launches()
            got, loss = grad_digest(model_lib, m, run_cfg, fg, name)
            counted = read_launches()
            if route == "pallas":
                launches = {k: launches[k] + v for k, v in counted.items()}
            readings[(route, name)], leaf = fg.grad_error(got, want)
            log(f"full-geometry gradients {name}, {route}: loss {loss:.4f} (JAX "
                f"{meta['loss'][name]:.4f}), worst leaf {paths[leaf]} "
                f"{readings[(route, name)]:.3e} (limit {GRAD_PARITY_LIMIT[name]:.0e}); launches "
                + str({k: v for k, v in counted.items() if v}))
        for c, w in controls[name].items():
            broken[(c, name)], leaf = fg.grad_error(grad_digest(
                model_lib, full_geometry_model(model_lib, cfg, w, torch.float32).train(), cfg, fg,
                name)[0], want)
            log(f"full-geometry gradients {name}, control {c} (pallas): "
                f"{broken[(c, name)]:.3e} at {paths[leaf]}")
    return readings, broken, launches


def check_full_geometry_blocks(model_lib, cfg, card: str) -> dict[str, dict[str, int]]:
    """Phase 16c: the full-geometry parity at ConvNeXt layer scale 1, where
    the blocks weigh (tests/full_geometry_blocks_golden.npz): the logits on
    every route, and the digest of the training loss's gradients on every
    route a training step takes, in f32 and bf16 against JAX's; the broken
    controls outside every limit.  Returns the launches of the default
    route's gradients, which must include kernels 7, 9 and 20."""
    fg = full_geometry_case()
    golden = np.load(ROOT / "tests" / fg.BLOCKS_GOLDEN)
    flat = full_geometry_weights(model_lib, cfg, fg, fg.BLOCKS_LAYER_SCALE)
    controls = blocks_controls(cfg, fg, flat)
    spread = fg.grad_error(fg.golden_digest(golden, "bf16"), fg.golden_digest(golden, "f32"))[0]
    log("full-geometry parity at layer scale 1: JAX's own bf16 against its f32, logits "
        f"{fg.relative_error(golden['logits_bf16'], golden['logits_f32']):.3e}, gradients "
        f"{spread:.3e}")
    full_geometry_logits(model_lib, cfg, fg, golden, flat, controls, BLOCKS_PARITY_LIMIT,
                         "full-geometry parity at layer scale 1")
    readings, broken, launches = full_geometry_grads(model_lib, cfg, fg, golden, flat, controls)
    judge("full-geometry gradients", readings, broken, GRAD_PARITY_LIMIT)
    missing = [k for k in ("local_two_phase_grads", "global_attention_grads", "stage_bwd")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"the default route's gradients never launched {missing}")
    return {"full-geometry grads": launches}


def check_serving_tools(model_lib, cfg, model, card: str) -> None:
    """Phase 16d: the serving CLI on two ranks (torchrun, gloo on the one
    card) against one rank's MIDI byte for byte; a trace of one forward and
    one capture on demand; modelutil against infer on the 30 s file; --plot
    and --visualize-audio."""
    from audio_to_midi_tpu_torch import modelutil, native
    from audio_to_midi_tpu_torch.cli import audio_to_midi as serve_cli
    from audio_to_midi_tpu_torch.cli import infer_cli
    from audio_to_midi_tpu_torch.data.loader import load_and_slice_full_audio
    from audio_to_midi_tpu_torch.infer import _parity_precision, predict_and_stitch
    from audio_to_midi_tpu_torch.ops.eventize import extract_events
    from audio_to_midi_tpu_torch.utils import profiling

    wav, ckpt, one_rank = WORK / "synth.wav", WORK / "params.npz", WORK / "out.mid"
    two_ranks = WORK / "out_ranks2.mid"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "audio_to_midi_tpu_torch.cli.audio_to_midi", str(wav), str(two_ranks),
         "--checkpoint", str(ckpt), "--dist-backend", "gloo"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the two-rank CLI failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    same = two_ranks.read_bytes() == one_rank.read_bytes()
    log(f"cli on 2 ranks (torchrun, gloo, one card): {proc.stdout.strip().splitlines()[-2:]}; "
        f"MIDI identical to one rank's (phase 4) byte for byte {same}; "
        f"wall {time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError("the two-rank CLI's MIDI differs from one rank's")

    rope = model_lib.make_rope(cfg.model, "cuda")
    gen = torch.Generator(device="cpu").manual_seed(17)
    x = (torch.randn(BATCH, 2, 80_000, generator=gen) * 0.5).cuda()

    def forward():
        with torch.inference_mode(), _parity_precision(torch.float32):
            return model_lib.forward(model, cfg.model, x, rope)

    kernel_names = ("global_attention_fwd_kernel", "local_two_phase_fwd_kernel")

    def read_trace(path):
        events = json.loads(Path(path).read_text())["traceEvents"]
        kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        found = {k: any(k in n for n in kernels) for k in kernel_names}
        ops = {e.get("name", "") for e in events if e.get("cat") == "cpu_op"}
        return found, len(kernels), ops

    trace_dir = WORK / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    forward()
    with profiling.trace(str(trace_dir)):
        forward()
    (trace_file,) = trace_dir.glob("*.json")
    found, n_kernels, ops = read_trace(trace_file)
    log(f"trace of one forward ({trace_file.stat().st_size:,} bytes, {n_kernels} kernel "
        f"names): kernel 1's and 2's CUDA functions named {found}; main thread's "
        f"a2m::global_attention_fwd op recorded {'a2m::global_attention_fwd' in ops}")
    if not all(found.values()):
        raise AssertionError("the trace does not name kernels 1 and 2")

    server = profiling.start_server(0)
    cap_dir = WORK / "capture"
    shutil.rmtree(cap_dir, ignore_errors=True)
    client = subprocess.Popen(
        [sys.executable, "-c", "from audio_to_midi_tpu_torch.utils.profiling import capture; "
         f"print(capture({server.port}, 1500, {str(cap_dir)!r}))"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        forwards = 0
        while client.poll() is None:
            forward()
            torch.cuda.synchronize()
            forwards += 1
        out, err = client.communicate(timeout=120)
    finally:
        if client.poll() is None:
            client.kill()
        server.close()
    if client.returncode != 0:
        raise AssertionError(f"the capture client failed:\n{err}")
    found, n_kernels, ops = read_trace(out.strip().splitlines()[-1])
    log(f"capture on demand (start_server / capture from another process, 1500 ms while the "
        f"main thread ran {forwards} forwards): {n_kernels} kernel names, kernel 1's and 2's "
        f"named {found}; the main thread's CPU operators recorded "
        f"{bool(ops & {'a2m::global_attention_fwd', 'aten::linear', 'aten::mm'})} "
        f"({len(ops)} operator names)")

    windows, window_duration = load_and_slice_full_audio(
        wav, overlap=cfg.infer.window_overlap, sample_rate=cfg.data.sample_rate,
        window_duration=cfg.data.model_audio_length)
    probs, stitched, dpf = predict_and_stitch(model, cfg, windows, window_duration,
                                              overlap=cfg.infer.window_overlap)
    mu_stitched = modelutil.stitch_probs(probs, cfg.infer.window_overlap, dpf)
    err = float(np.abs(mu_stitched - stitched).max())
    # The eventizers on the same probabilities: infer's on the card.
    mu_events = modelutil.extract_events(stitched)
    events = extract_events(torch.from_numpy(stitched).cuda())
    frames = modelutil.to_frame_events([mu_events], mu_stitched.shape[0])[0]
    log(f"modelutil on the 30 s file's {probs.shape} probabilities (native plane "
        f"{native.available()}): stitch_probs vs infer's stitch on the card max_abs_err "
        f"{err:.3e} (tol {FORWARD_TOL['f32']:.0e}); extract_events = infer's eventizer on the "
        f"card {list(map(tuple, mu_events)) == list(events)} ({len(events)} events); "
        f"to_frame_events {frames.shape}")
    if err > FORWARD_TOL["f32"] or list(map(tuple, mu_events)) != list(events):
        raise AssertionError("modelutil disagrees with infer on the 30 s file")

    try:
        import matplotlib

        matplotlib.use("Agg")
    except ImportError:
        matplotlib = None
    figures = WORK / "figures"
    runs = {"infer_cli --plot": (infer_cli.main, [str(wav), "--plot", "--checkpoint", str(ckpt)]),
            "audio_to_midi --visualize-audio": (serve_cli.main, [
                str(wav), str(WORK / "out_visualize.mid"), "--checkpoint", str(ckpt),
                "--visualize-audio"])}
    for what, (main_fn, argv) in runs.items():
        captured = io.StringIO()
        if matplotlib is None:
            try:
                with contextlib.redirect_stdout(captured):
                    main_fn(argv)
            except ImportError as e:
                if "matplotlib" not in str(e):
                    raise
                log(f"{what}: no matplotlib on this machine; raised ImportError naming it: {e}")
                continue
            raise AssertionError(f"{what} ran without matplotlib")
        import matplotlib.pyplot as plt

        plt.close("all")
        with contextlib.redirect_stdout(captured):
            rc = main_fn(argv)
        figures.mkdir(parents=True, exist_ok=True)
        nums = plt.get_fignums()
        for n in nums:
            plt.figure(n).savefig(figures / f"{what.split()[-1].strip('-')}_{n}.png")
        plt.close("all")
        log(f"{what}: rc {rc}, {len(nums)} figures written under Agg to {figures}")
        if rc != 0 or not nums:
            raise AssertionError(f"{what} drew no figure")


def check_export_and_tools(model_lib, cfg, model, card: str) -> dict[str, dict[str, int]]:
    """Phase 16: the exported programs, the full-geometry parity against
    JAX, and the serving tools.  Returns the programs' launches by path."""
    started = time.perf_counter()
    paths = check_exported_programs(model_lib, cfg, model, card)
    log(f"phase 16a took {time.perf_counter() - started:.1f} s")
    t0 = time.perf_counter()
    check_full_geometry(model_lib, cfg, card)
    log(f"phase 16b took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths |= check_full_geometry_blocks(model_lib, cfg, card)
    log(f"phase 16c took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_serving_tools(model_lib, cfg, model, card)
    log(f"phase 16d took {time.perf_counter() - t0:.1f} s; phase 16 took "
        f"{time.perf_counter() - started:.1f} s")
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.ops import attention_kernels as ak
    from audio_to_midi_tpu_torch.ops import convnext_kernels as ck
    from audio_to_midi_tpu_torch.ops import cuda_build
    from audio_to_midi_tpu_torch.ops import fused_layer_kernels as flk

    card = card_line()
    log(card)  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    started = t0 = time.perf_counter()
    lib = cuda_build.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    cfg = DEFAULT_CONFIG
    kernel_results = check_kernels(ak, ck, cfg.train.minibatch_size_per_device)
    kernel_results |= check_fused_kernels(flk, model_lib, cfg)

    model = seeded_model(model_lib, cfg)
    log(f"model: {model_lib.param_count(model):,} params, dims {cfg.model.dims}, "
        f"depths {cfg.model.depths}, {cfg.model.num_transformer_layers} pairs")
    check_forward(model_lib, cfg, model)
    serving = end_to_end(model_lib, cfg, model, card)
    log(f"serving main-path launches: {serving}")
    training, dropout_free = check_training(model_lib, cfg, copy.deepcopy(model).train(), card)
    log(f"training main-path launches: {training}")
    dropout, bits_route, dropout_losses, with_dropout = check_training_dropout(
        ak, model_lib, cfg, copy.deepcopy(model).train(), card, dropout_free)
    log(f"training-with-dropout main-path launches: seeded route {dropout}, "
        f"precomputed-bits route {bits_route}")
    default_training = check_training_default(model_lib, cfg, copy.deepcopy(model).train(), card,
                                              dropout_losses, with_dropout)
    log(f"default-config training main-path launches: {default_training}")
    stage_serving = check_stage_serving(model_lib, cfg, model, card)
    log(f"pallas_stage serving main-path launches: {stage_serving}")
    t9 = time.perf_counter()
    fused_serving = check_fused_serving(model_lib, cfg, model, card)
    log(f"fused-layer serving main-path launches: {fused_serving}; phase 9 took "
        f"{time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    rw_paths = check_rw_and_f16(ak, model_lib, cfg, model, card)
    log(f"pallas_rw and attention-function main-path launches: {rw_paths}; phase 10 took "
        f"{time.perf_counter() - t10:.1f} s")
    t11 = time.perf_counter()
    file_serving = check_file_serving(cfg, card)
    log(f"file serving main-path launches: {file_serving}; phase 11 took "
        f"{time.perf_counter() - t11:.1f} s")
    t12 = time.perf_counter()
    native_serving = check_native_plane(cfg, card)
    log(f"native-plane serving main-path launches: {native_serving}; phase 12 took "
        f"{time.perf_counter() - t12:.1f} s")
    training_entry, one_member_times = check_training_entry(cfg, card)
    log(f"training entry main-path launches: {training_entry}")
    population = check_population(cfg, card, one_member_times)
    log(f"population main-path launches: {population}")
    parallel = check_parallel(cfg, card, one_member_times)
    log(f"parallel main-path launches (summed over the ranks): {parallel}")
    exported = check_export_and_tools(model_lib, cfg, model, card)
    log(f"exported-program launches: {exported}")
    paths = {"serving": serving, "training": training, "dropout": dropout, "bits": bits_route,
             "default-config training": default_training, "pallas_stage serving": stage_serving,
             **fused_serving, **rw_paths, **file_serving, **native_serving, **training_entry,
             **population, **parallel, **exported}
    # Phase 15's paths: the sharded steps and the multi-process CLIs.
    sharded_f32 = ("tp2 f32 step", "dp2 f32 step")
    sharded_default = ("tp2 default steps", "dp2 default steps", "cli dp2", "cli dp2 resume",
                       "cli tp2", "cli ensemble axis")
    on_path = {
        "global_attention": ("serving", "training", "serving a member", "phase 14 clis",
                             "tp2 forward", "sharded serving", *sharded_f32, "exported program",
                             "exported program pallas_stage", "full-geometry grads"),
        "local_two_phase": ("serving", "training", "serving a member", "phase 14 clis",
                            "tp2 forward", "sharded serving", *sharded_f32, "exported program",
                            "exported program pallas_stage", "full-geometry grads"),
        "global_attention_grads": ("training", "bits", *sharded_f32, "full-geometry grads"),
        "local_two_phase_grads": ("training", *sharded_f32, "full-geometry grads"),
        "global_attention_dropout": ("dropout", "train_cli ring", "train_cli host feed",
                                     "train_cli ensemble", "ensemble step", *sharded_default),
        "local_two_phase_dropout": ("dropout", "train_cli ring", "train_cli host feed",
                                    "train_cli ensemble", "ensemble step", *sharded_default),
        "global_attention_grads_prng": ("dropout", "train_cli ring", "train_cli host feed",
                                        "train_cli ensemble", "ensemble step", *sharded_default),
        "local_two_phase_grads_prng": ("dropout", "train_cli ring", "train_cli host feed",
                                       "train_cli ensemble", "ensemble step", *sharded_default),
        "global_attention_dropout_bits": ("bits",), "local_two_phase_dropout_bits": ("bits",),
        "local_two_phase_grads_bits": ("bits",), "philox_bits": ("bits",),
        "stage_bwd": ("default-config training", "train_cli ring", "train_cli host feed",
                      "train_cli ensemble", "ensemble step", *sharded_f32, *sharded_default,
                      "full-geometry grads"),
        "stage_fwd": ("pallas_stage serving", "exported program pallas_stage"),
        "attention_block": ("pallas_block serving", "exported program pallas_block"),
        "fused_local_sublayer": ("pallas_fused serving", "exported program pallas_fused"),
        "fused_global_sublayer": ("pallas_fused serving", "exported program pallas_fused"),
        "transformer_pair": ("pallas_pair serving", "exported program pallas_pair"),
        "local_two_phase_rw": ("pallas_rw serving", "pallas_rw training",
                               "exported program pallas_rw"),
        "head_major_attention": ("attention functions",),
        "rope_attention": ("attention functions",),
        "eventize": ("serving", "file 30 s", "file 300 s", "streaming 300 s", "cli --stream",
                     "native file 300 s", "train_cli ring", "train_cli host feed",
                     "cli from a training checkpoint", "train_cli ensemble",
                     "serving a member", "phase 14 clis", "sharded serving"),
    }
    if set(on_path) != set(read_launches()):
        raise AssertionError("a kernel wrapper has no main path that drives it")
    for name, runs_it in on_path.items():
        if any(paths[path][name] == 0 for path in runs_it):
            raise AssertionError(f"{name} was never launched on a path that runs it: {paths}")

    src, tpu = "audio_to_midi_tpu_torch/csrc/", "audio_to_midi_tpu/ops/"
    # wrapper -> (source, the TPU kernel's file:line, the phase-2 case reported)
    sources = {
        "stage_bwd": ("convnext_stage_bwd.cu", "pallas_convnext_bwd.py:287",
                      "stage bwd stage 5 B=32 bf16"),
        "stage_fwd": ("convnext_stage_fwd.cu", "pallas_convnext.py:131",
                      "stage fwd stage 5 B=16 bf16"),
        "attention_block": ("attention_block.cu", "pallas_attention.py:1391",
                            "attention block global S=250 bf16"),
        "fused_local_sublayer": ("fused_sublayer.cu", "pallas_sublayer.py:133",
                                 "fused local sublayer P=256 bf16"),
        "fused_global_sublayer": ("fused_sublayer.cu", "pallas_sublayer.py:133",
                                  "fused global sublayer P=256 bf16"),
        "transformer_pair": ("transformer_pair.cu", "pallas_pair.py:229",
                             "transformer pair P=256 bf16"),
    }
    attention = {
        "global_attention": ("global_attention_fwd.cuh", "140", "global S=250 f32"),
        "local_two_phase": ("local_attention_fwd.cuh", "608", "local P=256 f32"),
        "global_attention_grads": ("global_attention_bwd.cuh", "1104", "global grads S=250 bf16"),
        "local_two_phase_grads": ("local_attention_bwd.cuh", "992", "local grads P=256 bf16"),
        "global_attention_dropout": ("global_attention_fwd.cuh", "1783",
                                     "global dropout S=250 bf16"),
        "local_two_phase_dropout": ("local_attention_fwd.cuh", "1622",
                                    "local dropout P=256 bf16"),
        "global_attention_grads_prng": ("global_attention_bwd.cuh", "1833",
                                        "global grads prng S=250 bf16"),
        "local_two_phase_grads_prng": ("local_attention_bwd.cuh", "1682",
                                       "local grads prng P=256 bf16"),
        "global_attention_dropout_bits": ("global_attention_fwd.cuh", "381",
                                          "global dropout bits S=250 bf16"),
        "local_two_phase_dropout_bits": ("local_attention_fwd.cuh", "697",
                                         "local dropout bits P=256 bf16"),
        "local_two_phase_grads_bits": ("local_attention_bwd.cuh", "1025",
                                       "local grads bits P=256 bf16"),
        "philox_bits": ("philox_dump.cu", "1744", "philox bits local P=256 uint8"),
        "local_two_phase_rw": ("local_attention_fwd.cuh", "847", "local rw P=256 f32"),
        "head_major_attention": ("global_attention_fwd.cuh", "219", "head major S=250 f32"),
        "rope_attention": ("rope_attention.cu", "1229", "rope S=250 f32"),
    }
    sources = {name: (source, "pallas_attention.py:" + line, case)
               for name, (source, line, case) in attention.items()} | sources
    # Not a Pallas kernel: the eventizer's lax.scan, which XLA compiles.
    sources["eventize"] = ("eventize.cu", "eventize.py:43 extract_events_dense (lax.scan)",
                           f"eventize N={EVENT_FRAMES} f32")
    # Where a kernel's products live apart from its entry: the tensor-core
    # product of kernels 20 and 19 and of the fused layers, whose device code
    # is in fused_layer_impl.cuh.
    products = dict.fromkeys(("stage_bwd", "stage_fwd", "attention_block", "fused_local_sublayer",
                              "fused_global_sublayer", "transformer_pair"), "convnext_gemm.cuh")
    products["rope_attention"] = "global_attention_fwd.cuh"  # kernel 1's body, after rope_rows.cuh
    kernels = []
    for name, (source, replaces, case) in sources.items():
        r = kernel_results[case]
        by_path = {path: counts[name] for path, counts in paths.items()}
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": tpu + replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "case": case,
                        **({"beside": r["beside"]} if "beside" in r else {}),
                        **({"products": src + products[name]} if name in products else {})})
    log(f"smoke: {time.perf_counter() - started:.1f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
