#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Drives the port's mapping, analytics, serving, deployment, LM serving,
training and MoE paths through their public entry points
(``GeoEngine.build`` / ``assign`` / ``assign_padded``, ``ops.pip_one``,
``BlockAggregator``, ``ops.assign_aggregate``, ``GeoServer``,
``GeoIndexSet.save`` / ``GeoServer.from_artifact``, ``AsyncGeoServer``,
``enrich``, ``data.make_source``, ``repro_torch.launch.serve``,
``launch.train``'s ``setup`` / ``run_config`` with
``runtime.driver.train_loop`` over ``runtime.steps.make_train_step``,
``checkpoint.manager``, and the MoE family through
``make_prefill_step`` and ``launch.serve``) on the card:

  1. prints the card (nvidia-smi name and power limit), torch and nvcc
     versions, and builds the CUDA kernels from ``src/repro_torch/
     kernels/csrc`` (build seconds, ptxas register counts), and beside
     them a copy of the tensor-core flash kernel with a planted fault
     (one KV tile skipped); meanwhile a child process builds the host map
     of phase 3;
  2. LM path: ``flash_attn_bhsd`` against its twin on both routes (f32
     and bf16, causal and full, D 12 / 16 / 24 / 32 / 64 / 128, S 64 /
     100 / 300 / 2048: bf16 at D 64 / 128 on the tensor-core kernel, the
     rest on the CUDA-core one, D 12 and 24 zero-padded to 16 and 32 by
     the wrapper and held against the twin at the true D; a second
     launch bit-equal; GQA through ``flash_attn`` and
     ``ops.flash_attn``), then
     Qwen1.5-0.5B at full width (24 layers, d 1024, vocab 151,936; random
     weights from ``LM_SEED``) serving 8 prompts of 2,048 tokens and 64
     greedy tokens through ``launch.serve.serve``: the prefill launches
     the flash kernel once per layer, every call on the tensor-core route
     (each call held against the twin, and the planted fault shown to
     fail the same bound on each), decode
     launches none of the eight kernels, and a teacher-forced
     ``forward`` over prompt + generated tokens agrees with decode's
     logits and, wherever its top-2 margin is clear, with its tokens;
     after the LM timing of phase 7, MiniCPM-2B's reduced config (head
     dim 12) served through ``launch.serve.serve``, each prefill flash
     call held against the twin, and one flash call over 65,537 heads
     (two launches), its first, last and sampled heads against the twin;
  3. the benchmark-scale census (benchmarks/common.py SCALE: 16 states /
     128 counties / 3,072 blocks) and its covering at max_level 9, from
     the child process, and six engines on cuda: ``fast`` (gathered PIP
     kernel), ``fast`` with ``fused=True`` (candidate PIP kernel),
     ``fast_onepass`` (one-pass cascade kernel), ``simple`` and
     ``simple`` with ``fused=True`` (the bbox kernels, then gathered /
     candidate PIP per level) and ``hybrid`` (the cell lookup, then the
     simple cascade on boundary points);
  4. kernel phase: a 2^16-point batch through each engine, and through
     ``ops.pip_one`` against each state's edge table; every kernel call
     is held against its plain PyTorch twin on the same inputs (exact
     equality), and each engine against a CPU engine of the same config
     (the twins) on ids and stats, and on ``flat[1:].view(-1, 2)``, a
     misaligned view of the batch, equal to the aligned copy;
     ``crossings_one`` on E = 0, 1 and 284 (no tile multiple) and a state
     table over 2^16 + 5 points with NaN / inf / off-extent ones, and
     ``crossings_candidates`` on the state tables packed at BE = 64
     (2-3 blocks a polygon), a pool with a polygon of 0 live edges and a
     pool rebuilt through ``EdgePool.from_numpy`` (derived live counts),
     each bit-equal to its twin and a second launch bit-equal;
     ``bbox_mask`` at 1 / 7 / 16 / 33 / 56 / 513 / 3,072 boxes (both
     kernel layouts) x 0 / 1 / 2^16 + 3 points with NaN / inf / FAR
     points, points on box edges and empty boxes, the points also 8
     bytes into a buffer: bit-equal to the twin, a second launch
     bit-equal, one launch a call; ``segment_reduce_sorted`` on 2^16
     rows of uniform, skewed (40 % in one segment), invalid (parked and
     unparked), odd-``S``, ``S`` = 1, ``S`` > rows, 2^16 + 3 rows and
     empty ids, and on 2^21 rows with one segment over more than 64 row
     tiles: integer-valued and absent (zero) columns exact against the
     twin and the numpy oracle, f32 columns within rtol 1e-5 of the
     oracle, a second launch bit-equal to the first, a column 4 bytes
     into a buffer bit-equal to the aligned one, 1 launch a call without
     values and 2 with;
  5. main path: 2^24 points through each engine, with every launch
     counter set to 0 just before and read just after (the kernels each
     engine must launch, and no other); block ids equal across the exact
     paths and to ground truth (accuracy 1.0), ``hybrid`` equal to
     ``fast`` id for id, ``simple`` equal to ``simple`` fused in ids and
     stats, no overflow, ``assign_padded`` -1 on its pad rows; then the
     2^24 points against all 16 state tables through ``ops.pip_one``;
     then the analytics path: ``BlockAggregator.fused_counts`` of the
     2^24 points through ``fast`` (equal to ``np.bincount`` of the
     assigned ids; the segment kernel launched once), ``reduce`` with an
     integer-valued column (equal to the numpy oracle) and
     ``ops.assign_aggregate`` on the ``fast_onepass`` index (equal to the
     segment reduction of the cascade's ids);
  6. serving path: a ``GeoServer`` over ``fast`` with the windowed
     analytics mounted replays examples/analytics_geo.py's stream on
     this map (served ids equal direct assigns, cache on = cache off,
     analytics snapshot equal to a CPU port server's on the same
     requests, spans and histograms for every stage), then serves 256
     requests of 16,384 points (pts/s, p50/p99 request latency);
  7. times each engine (pts/s), ``fused_counts`` (pts/s, and its
     assign / sort / kernel split), the LM's prefill and decode tok/s
     (right after phase 2, while the child process builds the host map),
     and each kernel at the main path's inputs beside its plain twin,
     its bound and, for flash attention, ``scaled_dot_product_attention``
     and, for the segment counts, ``torch.bincount`` (timed only: the
     port never calls them) and an empty kernel (the least time a launch
     shows by the same clock), ``bbox_mask`` at a second width (56
     county boxes), with each ``crossings_candidates`` call's
     rows, those with a candidate and those at the padding slots' alias
     point; then ``assign_cascade`` on
     three more batches sampled (seed CASCADE_SEED) from the main path's
     points as its call classified them: 2^20 points all in boundary
     cells, 2^20 all in interior cells, and 2^20 + 37 points with
     off-extent, infinite and NaN ones mixed in, each bit-equal to the
     twin, the first two timed (the locate stage alone against locate +
     edge tests);
  8. deployment paths (after phase 7, whose pts/s name the winner):
     a. the winner among ``fast``, ``fast`` fused and ``fast_onepass``
        recorded in a ``GeoIndexSet`` (``record_tuning``: winner, pool
        block size, device kind, pts/s), saved (seconds, bytes on disk),
        and a ``GeoServer.from_artifact(strategy="auto")`` cold start on
        the card (load + ensure + first assign seconds beside phase 3's
        covering BFS): its plan is the winner's strategy, its served ids
        on 2^20 of the main path's points equal the warm engine's, and
        only that strategy's kernel launched; a copy whose tuning names
        device kind "tpu" replans to ``fast`` (``crossings_gathered``);
     b. ``AsyncGeoServer`` over ``fast`` with phase 6's ServeConfig
        (analytics mounted), 4 submitters and 2 replicas: phase 6's
        stream from one client in order (ids and analytics snapshot
        equal to the sync server's), then phase 6's 256 requests of
        16,384 points from 8 client threads (every future resolves with
        a direct assign's ids, no failed flush or request; pts/s and
        p50 / p99 beside the sync server's), ``crossings_gathered`` the
        only kernel launched;
     c. ``core.enrich.enrich`` of the 2^24 points (ids equal the ``fast``
        engine's) and ``data.make_source`` of Qwen1.5-0.5B's full config
        (8 x 2,048 tokens) over the ``fast`` engine: ``batch_at(0..3)``'s
        geo blocks equal a direct assign of the sampled points, its
        tokens a CPU source's, most points on the map, and
        ``crossings_gathered`` launched;
  9. training (after phase 8):
     a. ``make_flash_attn_trainable`` at [2, 2048, 16, 64] bf16: output
        equal to ``flash_attn``'s bit for bit (the wgmma kernel launched
        once), dq / dk / dv equal to ``torch.autograd.grad`` through
        ``blockwise_attn`` bit for bit;
     b. Qwen1.5-0.5B at full width built to train (f32 master weights,
        random from TRAIN_SEED), ``launch.train.run_config`` with remat
        "full", 8 x 2,048 GeoEnriched tokens over the ``fast`` engine,
        ``train_loop`` over ``make_train_step`` for a warm-up step and 4
        timed ones: each step launches ``flash_attn_bhsd`` 48 times (24
        forward + 24 recompute), all on wgmma, and nothing else of the
        eight; the warm-up's calls each held against the twin; losses
        and grad norms finite, the first ce near ln(V), the loss falling;
        step ms, tok/s, peak device memory; one more step split into
        forward / backward / optimizer (CUDA events) and one under
        torch.profiler (busy share, top kernels and operators);
     c. the step's loss, ce and grad norm against the plain path's (the
        same parameters and batch with flash's twin in the kernel's
        place), within TRAIN_LOSS_ATOL / TRAIN_GNORM_RTOL;
     d. one checkpoint save and restore of the full-width state (params,
        m, v; free disk printed first), timed, the restored tensors equal
        to the saved ones;
     e. ``train_loop`` at the reduced config, 8 x 2,048 tokens: a failure
        injected at step 6, restored from step 4, ends with parameters
        and optimizer state equal to a run without it, bit for bit;
 10. the MoE family (after phase 9):
     a. Mixtral-8x7B at its published widths, MOE_LAYERS of 32 layers,
        random weights drawn leaf by leaf (``launch.serve.load_model``):
        ``runtime.steps.make_prefill_step`` over MOE_BATCH x MOE_SEQ
        tokens launches ``flash_attn_bhsd`` once a layer (S <= window),
        all on the tensor-core route, and nothing else of the eight; each
        call held against the twin and the planted fault shown to fail
        it; the forward's logits within LOGIT_TOL of the plain path's
        (flash's twin), that run routed as the kernel's (each choice of
        its own that differs a near tie, ROUTE_GAP) and dropping the
        same choices; step tok/s, peak memory and a profile by part
        (router, dispatch, expert products, flash, unembedding); the
        flash kernel timed at that shape beside its bound and
        ``scaled_dot_product_attention``;
     b. ``launch.serve.serve`` with MOE_SERVE (the prompt fed token by
        token: the MoE model has no ``prefill``, as in ``repro``): no
        kernel of the eight launched, tok/s;
     c. the no-drop copy (capacity_factor E / k): decode over the prompt
        and generated tokens, routed as a teacher-forced ``forward``
        routed, within LOGIT_TOL of its logits, argmax equal where its
        margin is clear;
     d. DeepSeek-V2 at its published widths, DSV2_LAYERS of 60 layers:
        a forward over DSV2_BATCH x DSV2_SEQ and the token-loop serve of
        DSV2_SERVE, no kernel of the eight launched (head dim 192; MLA);
     e. Mixtral's reduced config trained MOE_TRAIN_STEPS steps through
        ``launch.train.setup`` and ``train_loop``: losses finite,
        ``lb_loss`` and ``dropped`` reported.

Kernel calls are held against their twins as they happen when their
arguments are too large to keep (the simple path's gathered state edges
are 19 GB a call at 2^24 points); the calls that are timed are kept.
Any failed check raises and the script exits non-zero.  The last line
is the device JSON; the line before it the kernels JSON.  Without a
CUDA device it exits non-zero and prints no result.
"""
import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# benchmarks/common.py SCALE: 16 states / 128 counties / 3,072 blocks.
SCALE = dict(seed=0, n_states=16, counties_per_state=8, blocks_per_county=24)
MAX_LEVEL = 9
N_MAIN = 1 << 24
N_KERNEL = 1 << 16
N_PADDED, PAD_TO = 1000, 4096
TWIN_CHUNK = 1 << 18          # rows per plain-twin call (bounds its memory)
TIMED_BATCHES = 3
KERNEL_REPS = 5
LEAD_CYCLES = 10_000_000      # ~5 ms of spin on the card before a timing
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor) peak, dense
# bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
OPS_PER_EDGE_TEST = 6         # 4 subtractions + 2 products (crosses())
OPS_PER_BOX_TEST = 4          # 4 comparisons (in_box())
OPS_PER_SEGMENT_ROW = 3       # add, min, max (segment.cu add_value())
SECTOR_BYTES = 32             # one DRAM sector: a binary-search step's read
# f32 segment sums vs the f64 oracle: the card's fixed-order tree sums
# came within 1.44e-7 relative on the kernel phase's cases.
SUM_RTOL = 1e-5
# examples/analytics_geo.py's stream and analytics mount.
SERVE_BUCKETS = (1024, 4096, 16384)
SERVE_SECONDS, SERVE_BACKGROUND, SERVE_VENUE, SERVE_TAIL_T = 16, 2048, 1024, 32.0
LOAD_REQUESTS, LOAD_POINTS = 256, 16384
# The deployment paths: points served after the cold start; the async
# server's threads; the GeoEnriched pipeline's shape and steps.
N_COLD = 1 << 20
ASYNC_SUBMITTERS, ASYNC_REPLICAS, ASYNC_CLIENTS = 4, 2, 8
PIPE_BATCH, PIPE_SEQ, PIPE_STEPS = 8, 2048, 4
# The LM serving path: Qwen1.5-0.5B at full width, a chat-style batch.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = "qwen1.5-0.5b", 8, 2048, 64, 0
# Head dims 12 and 24 are no kernel instance: the wrapper pads them.
FLASH_DIMS, FLASH_LENGTHS = (12, 16, 24, 32, 64, 128), (64, 100, 300, 2048)
# MiniCPM-2B's reduced config (head dim 12) served on the card.
MINICPM_ARCH, MINICPM_BATCH, MINICPM_PROMPT, MINICPM_GEN = (
    "minicpm-2b", 4, 64, 8)
# One flash call over more heads than the kernels' grid y (65,535).
MANY_HEADS, MANY_HEADS_SAMPLE = (65537, 128, 64), 8
# The candidate-PIP pool cases: the block polygon emptied of its edges;
# crossings_one's extra cases: rows (no multiple of 4 or 1,024).
EMPTY_POLY, ONE_ROWS = 5, (1 << 16) + 5
# bbox_mask's kernel-phase shapes: box counts in both of the kernel's
# layouts (513 alone in its box tiles), most no multiple of 16; the second
# timed width (56, the paper's count of US state-level entities).
BBOX_BOXES, BBOX_ROWS, BBOX_WIDE = ((1, 7, 16, 33, 56, 513, 3072),
                                    (0, 1, (1 << 16) + 3), 56)
# segment_reduce_sorted's long-span case: one segment over more than
# SPAN_TILES of the kernel's row tiles, in SPAN_ROWS rows.
SPAN_TILES, SPAN_ROWS = 64, 1 << 21
# Flash kernel vs its twin.  f32: within 1e-5 absolute (summation order
# only; on an H100 the cases came within 1.4e-6).  bf16, element by
# element: two bf16 ulps of the twin's output plus 2^-7 times the twin's
# spread, sum_j p_j |v_j| / l (``ref.flash_attn_bhsd(spread=True)``).
# Kernel and twin round p to bf16 from scores summed in another order, so
# a p at a rounding edge can round to the neighbouring value, a step of
# at most 2^-7 p_j; those steps move the output by at most 2^-7 times the
# spread, and its own rounding by up to two ulps.  (On an H100 a 2-ulp
# bound alone failed a [2, 2048, 64] case at 2.5 ulps.)  The f32 cases
# run the CUDA-core kernel without the roundings and hold its arithmetic
# to 1e-5.  The bound must also have teeth at the prefill's shape: a copy
# of the tensor-core kernel that skips KV tile FAULT_TILE must fail it on
# every prefill call.
FLASH_F32_ATOL, FLASH_BF16_ULPS, FLASH_P_STEP = 1e-5, 2.0, 2.0 ** -7
FAULT_TILE = 12               # keys 1,536-1,663 of the prefill's 2,048
# The cascade's extra batches: 2^20 boundary points, 2^20 interior ones,
# and a ragged 2^20 + 37 with off-extent points mixed in.
CASCADE_SEED, CASCADE_BATCH, CASCADE_RAGGED = 7, 1 << 20, (1 << 20) + 37
# Training (phase 9): Qwen1.5-0.5B at full width, a warm-up step then
# TRAIN_STEPS - 1 timed ones of TRAIN_BATCH x TRAIN_SEQ tokens; the
# trainable flash checked at one [B, S, H, D] bf16 shape; the restart at
# the reduced config.  The first ce sits near ln(V) (random weights give
# unit-scale logits, which add ~0.5).  The kernel's step against the
# plain path's (flash's twin on the card): the CPU tests' bounds of the
# port's step against repro's (tests/test_torch_train.py: loss 5e-3
# absolute, grad norm 5e-3 relative).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED = 5, 8, 2048, 0
TRAIN_FLASH_SHAPE = (2, 2048, 16, 64)
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 8, 4, 6
TRAIN_CE0_TOL, TRAIN_LOSS_ATOL, TRAIN_GNORM_RTOL = 1.0, 5e-3, 5e-3
# Phase 10, the MoE family: Mixtral-8x7B at its published widths, cut to
# MOE_LAYERS of 32 layers (32 are 93 GB in bf16, more than the card's 80),
# forward over MOE_BATCH x MOE_SEQ tokens, served MOE_SERVE (prompts,
# prompt tokens, generated tokens) through the token loop; DeepSeek-V2 at
# its published widths, DSV2_LAYERS of 60 (the dense first layer and two
# MoE layers, ~20 GB); Mixtral's reduced config trained MOE_TRAIN_STEPS
# steps at MOE_TRAIN_SEQ (<= its window of 32).  Two runs of the port
# compared (kernel vs plain path, decode vs forward) are routed alike: the
# second takes the first's expert choices, and each choice of its own
# that differs must be a near tie, the k-th and (k+1)-th probabilities
# within ROUTE_GAP (tests/moe_pair.py's bound).  Random weights leave
# the router's probabilities close together, so near ties are common.
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_SEQ, MOE_SEED = (
    "mixtral-8x7b", 8, 8, 2048, 0)
MOE_SERVE = (8, 128, 32)
DSV2_ARCH, DSV2_LAYERS, DSV2_BATCH, DSV2_SEQ = "deepseek-v2-236b", 3, 2, 2048
DSV2_SERVE = (2, 64, 16)
MOE_TRAIN_STEPS, MOE_TRAIN_SEQ = 2, 32
ROUTE_GAP = 2.0 ** -6
# Teacher-forced logits (f32, scale ~1): decode against forward over the
# same tokens, both in bf16 through 24 layers; on an H100 they came
# 0.068-0.071 apart (the CPU tests see 0.05 between repro and the port
# over two layers).
LOGIT_TOL = 0.125
SERVE_STAGES = ("queue_wait", "host_prepare", "device_assign", "merge",
                "request", "analytics_observe")
SPAN_NAMES = {"request", "submit", "queue_wait", "host_prepare", "route",
              "cache_lookup", "cache_learn", "device_assign", "merge"}
KERNELS = {
    "assign_cascade": ("src/repro_torch/kernels/csrc/cascade.cu",
                       "src/repro/kernels/cascade.py:224"),
    "crossings_candidates": ("src/repro_torch/kernels/csrc/gather_pip.cu",
                             "src/repro/kernels/gather_pip.py:151"),
    "crossings_gathered": ("src/repro_torch/kernels/csrc/pip.cu",
                           "src/repro/kernels/pip.py:113"),
    "crossings_one": ("src/repro_torch/kernels/csrc/pip.cu",
                      "src/repro/kernels/pip.py:86"),
    "bbox_mask": ("src/repro_torch/kernels/csrc/bbox.cu",
                  "src/repro/kernels/bbox.py:57"),
    "bbox_count_select": ("src/repro_torch/kernels/csrc/bbox.cu",
                          "src/repro/kernels/bbox.py:80"),
    "segment_reduce_sorted": ("src/repro_torch/kernels/csrc/segment.cu",
                              "src/repro/kernels/segment.py:83"),
    "flash_attn_bhsd": ("src/repro_torch/kernels/csrc/flash_attn_wgmma.cu",
                        "src/repro/kernels/flash_attn.py:78"),
}
# The kernels each engine's assign must launch (and no other).
ENGINE_KERNELS = {
    "fast": ("crossings_gathered",),
    "fast_fused": ("crossings_candidates",),
    "fast_onepass": ("assign_cascade",),
    "simple": ("bbox_mask", "bbox_count_select", "crossings_gathered"),
    "simple_fused": ("bbox_mask", "bbox_count_select",
                     "crossings_candidates"),
    "hybrid": ("bbox_mask", "bbox_count_select", "crossings_gathered"),
    "fused_counts": ("crossings_gathered", "segment_reduce_sorted"),
    "serving": ("crossings_gathered",),
    "lm_prefill": ("flash_attn_bhsd",),
    "lm_decode": (),
    "lm_forward": ("flash_attn_bhsd",),
    "train_step": ("flash_attn_bhsd",),
}
# The main-path run whose calls each kernel's row is measured on.
ROW_PATH = {"assign_cascade": "fast_onepass",
            "crossings_candidates": "fast_fused",
            "crossings_gathered": "fast", "bbox_mask": "simple",
            "bbox_count_select": "simple", "crossings_one": "pip_one",
            "segment_reduce_sorted": "fused_counts"}
# Positional arguments of each kernel wrapper that are per-row.
ROW_ARGS = {"assign_cascade": (0,), "crossings_candidates": (0, 1),
            "crossings_gathered": (0, 1), "crossings_one": (0,),
            "bbox_mask": (0,), "bbox_count_select": (0, 1),
            "segment_reduce_sorted": (0, 1)}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events,
    after one warm run).  A spin kernel ahead of the start event keeps
    the card busy while the host queues the runs, so a kernel shorter
    than its launch's host overhead is timed on the device, not at the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flash_over(out, want, spread) -> float:
    """Max over the elements of |out - want| / (FLASH_BF16_ULPS bf16 ulps
    of want + FLASH_P_STEP spread); equal elements count 0."""
    if not out.numel():
        return 0.0
    want = want.float()
    diff = (out.float() - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)   # 0 at 0
    tol = FLASH_BF16_ULPS * ulp + FLASH_P_STEP * spread
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


def flash_err(out, want, spread, what) -> tuple:
    """(max abs err, max err / tolerance) of a flash output against its
    twin's ``(want, spread)``; raises unless it is within the dtype's
    tolerance (see FLASH_*)."""
    err = max_abs_err(out, want, what)
    if out.dtype == torch.float32:
        check(err <= FLASH_F32_ATOL, f"{what}: max abs err {err} > "
                                     f"{FLASH_F32_ATOL}")
        return err, err / FLASH_F32_ATOL
    over = flash_over(out, want, spread)
    check(over <= 1.0, f"{what}: max abs err {err}, {over:.3g}x the "
                       f"tolerance")
    return err, over


def max_abs_err(a, b, what):
    """Max |a - b| of two same-shape, same-type tensors; equal values
    (infinities included) count 0."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: output {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if not a.numel():
        return 0
    if a.is_floating_point():
        d = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
        return float(torch.nan_to_num(d, nan=float("inf")).max())
    return int((a.long() - b.long()).abs().max())


def call_bytes(args, outs) -> int:
    return sum(t.numel() * t.element_size() for t in list(args) + list(outs)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Capture:
    """What ``Smoke.capture`` saw: ``calls[name]`` the kept calls (args,
    kwargs, outputs); ``checked[name]`` the calls held against the twin
    as they happened (count, rows, bytes, max abs err)."""

    calls: dict
    checked: dict


class Smoke:
    def __init__(self):
        from repro_torch.kernels import (_build, bbox, cascade, flash_attn,
                                         gather_pip, pip, ref, segment)
        self.build, self.ref, self.flash = _build, ref, flash_attn
        self.modules = {"assign_cascade": cascade,
                        "crossings_candidates": gather_pip,
                        "crossings_gathered": pip, "crossings_one": pip,
                        "bbox_mask": bbox, "bbox_count_select": bbox,
                        "segment_reduce_sorted": segment,
                        "flash_attn_bhsd": flash_attn}

    @contextlib.contextmanager
    def capture(self, keep=None):
        """Record every kernel-wrapper call made through ``ops`` inside the
        block; the calls still launch.  Calls of the kernels in ``keep``
        (default: all) are kept whole; every other call is held against
        its twin at once, and only its summary is kept."""
        keep = set(self.modules) if keep is None else set(keep)
        cap = Capture({name: [] for name in self.modules},
                      {name: dict(calls=0, rows=0, bytes=0, max_abs_err=0)
                       for name in self.modules})
        saved = {name: getattr(m, name) for name, m in self.modules.items()}

        def recorder(name, fn):
            def rec(*args, **kw):
                out = fn(*args, **kw)
                call = (args, kw, out if isinstance(out, tuple) else (out,))
                if name in keep:
                    cap.calls[name].append(call)
                else:
                    c = cap.checked[name]
                    c["calls"] += 1
                    c["rows"] += args[0].shape[0]
                    c["bytes"] += call_bytes(args, call[2])
                    c["max_abs_err"] = max(c["max_abs_err"],
                                           self.compare(name, [call]))
                return out
            return rec

        for name, m in self.modules.items():
            setattr(m, name, recorder(name, saved[name]))
        try:
            yield cap
        finally:
            for name, m in self.modules.items():
                setattr(m, name, saved[name])

    def twin(self, name, args, kw):
        """The kernel's plain twin on one call's inputs, run over
        TWIN_CHUNK-row slices (the twins materialize [rows, ...] temps)."""
        ref = self.ref
        if name == "segment_reduce_sorted":    # a reduction over all rows
            return ref.segment_reduce(*args)
        if name == "flash_attn_bhsd":          # (out, spread): see FLASH_*
            q = args[0]
            return ref.flash_attn_bhsd(
                *args, **kw, bk=self.flash.kv_tile(q.dtype, q.shape[2]),
                spread=True)
        rows = args[0].shape[0]
        parts = []
        for lo in range(0, rows, TWIN_CHUNK):
            a = [x[lo:lo + TWIN_CHUNK] if i in ROW_ARGS[name] else x
                 for i, x in enumerate(args)]
            if name == "assign_cascade":
                count = a[9]
                out = ref.assign_cascade(
                    *a, **kw, max_blocks=max(int(count.max()), 1))
            else:
                out = getattr(ref, name)(*a, **kw)
                out = out if isinstance(out, tuple) else (out,)
            parts.append(out)
        return tuple(torch.cat(p) for p in zip(*parts))

    def compare(self, name, calls):
        """Max |kernel - twin| over every output of every call (float
        outputs: equal values, infinities included, count 0; NaN against
        a number counts inf).  Flash attention is held to its tolerance
        here (``flash_err``); every other kernel must give 0."""
        err = 0
        for args, kw, outs in calls:
            want = self.twin(name, args, kw)
            if name == "flash_attn_bhsd":
                err = max(err, flash_err(outs[0], *want, name)[0])
            else:
                err = max([err] + [max_abs_err(a, b, name)
                                   for a, b in zip(outs, want)])
        return err

    def check_all(self, cap, what: str) -> dict:
        """Hold every call of ``cap`` against its twin; return the number
        of calls per kernel."""
        n = {}
        for name in self.modules:
            kept = cap.calls[name]
            err = max(self.compare(name, kept),
                      cap.checked[name]["max_abs_err"])
            check(err == 0 or name == "flash_attn_bhsd",
                  f"{name} differs from its twin (max abs err {err}) on "
                  f"{what}")
            n[name] = len(kept) + cap.checked[name]["calls"]
        return n


def cascade_edge_tests(fast_mod, index, pts, bid, flags, nskip) -> int:
    """Edge tests the cascade kernel ran on this batch: for each boundary
    point, the BE-edge blocks of every candidate slot it attempted
    (valid, no earlier hit) whose bbox held the point.  The hit slot is
    read back from the kernel's outputs (slot 0 from flags bit 1, a later
    slot from bid; candidate ids in a row are unique), and the rebuilt
    bbox rejections must equal the kernel's nskip."""
    pool, bbox = index.edge_pool, index.block_bbox
    k = index.cand.shape[1]
    slots = torch.arange(k, device=pts.device)[None, :]
    tests = 0
    for lo in range(0, pts.shape[0], 1 << 22):
        sl = slice(lo, lo + (1 << 22))
        p, b, f = pts[sl], bid[sl], flags[sl]
        v = fast_mod.cell_values(index, p)
        boundary = (f & 1) == 1
        cand = index.cand[(-(v + 1)).clamp(0, index.cand.shape[0] - 1)]
        valid = boundary[:, None] & (cand >= 0)
        safe = cand.clamp(0, bbox.shape[0] - 1)
        bb = bbox[safe]
        px, py = p[:, 0:1], p[:, 1:2]
        inb = ((px > bb[..., 0]) & (px < bb[..., 1])
               & (py > bb[..., 2]) & (py < bb[..., 3]))
        hit = (cand == b[:, None]) & valid
        hit[:, 0] = (f & 2) == 2
        hit_slot = torch.where(hit.any(1), hit.int().argmax(1), k)
        attempted = valid & (slots <= hit_slot[:, None])
        check(torch.equal((attempted & ~inb).sum(1).int(), nskip[sl]),
              "cascade work count: rebuilt bbox rejections != nskip")
        tests += int((pool.count[safe] * (attempted & inb)).sum())
    return tests * pool.be


def cascade_batches(smoke, call, extent, main_ms) -> dict:
    """``assign_cascade`` on three batches drawn (seed CASCADE_SEED) from
    the main path's points as its call classified them: CASCADE_BATCH
    points all in boundary cells, CASCADE_BATCH all in interior cells, and
    CASCADE_RAGGED points (no multiple of the block's 256) with one in a
    hundred replaced by an off-extent, FAR, infinite or NaN point.  Each
    must be bit-equal to the twin.  The first two are then timed: the
    interior batch runs the locate stage alone, the boundary batch the
    locate and the edge tests, which splits ``main_ms`` (the main path's
    batch) between the two stages."""
    (pts, *tables), kw, (bid, flags, _, _) = call
    fn = smoke.modules["assign_cascade"].assign_cascade
    gen = torch.Generator(device="cuda").manual_seed(CASCADE_SEED)

    def sample(rows, n):
        return rows[torch.randperm(rows.numel(), generator=gen,
                                   device="cuda")[:n]]

    is_bnd = (flags & 1) == 1
    bnd_rows = is_bnd.nonzero().squeeze(1)
    int_rows = (~is_bnd & (bid >= 0)).nonzero().squeeze(1)
    x0, x1, y0, y1 = extent
    odd = torch.tensor([[x0 - 1.0, y0], [x1 + 1.0, y1], [1e30, 1e30],
                        [-1e30, -1e30], [math.inf, y0], [x0, -math.inf],
                        [math.nan, y0], [x0, math.nan]], device="cuda")
    ragged = pts[sample(torch.arange(pts.shape[0], device="cuda"),
                        CASCADE_RAGGED)].clone()
    at = sample(torch.arange(CASCADE_RAGGED, device="cuda"),
                CASCADE_RAGGED // 100)
    ragged[at] = odd[torch.arange(at.numel(), device="cuda") % len(odd)]
    batches = {"boundary": pts[sample(bnd_rows, CASCADE_BATCH)],
               "interior": pts[sample(int_rows, CASCADE_BATCH)],
               "ragged": ragged}
    out = {}
    for name, b in batches.items():
        got = fn(b, *tables, **kw)
        want = smoke.twin("assign_cascade", (b, *tables), kw)
        err = max(max_abs_err(g, w, f"assign_cascade {name}")
                  for g, w in zip(got, want))
        check(err == 0, f"assign_cascade differs from its twin on the "
                        f"{name} batch (max abs err {err})")
        bflags = got[1] & 1
        out[name] = dict(rows=b.shape[0], max_abs_err=err,
                         boundary=int(bflags.sum()))
    check(out["boundary"]["boundary"] == CASCADE_BATCH
          and out["interior"]["boundary"] == 0,
          f"assign_cascade batches not as sampled: {out}")
    odd_out = fn(ragged[at], *tables, **kw)
    check(bool((odd_out[0] == -1).all()) and all(
        bool((o == 0).all()) for o in odd_out[1:]),
        "assign_cascade: an off-extent point got an id or flags")
    for name in ("interior", "boundary"):
        b = batches[name]
        out[name]["ms"] = cuda_ms(lambda: fn(b, *tables, **kw), KERNEL_REPS)
    per_pt = {k: out[k]["ms"] / CASCADE_BATCH for k in ("interior",
                                                        "boundary")}
    n_bnd = bnd_rows.numel()
    locate = pts.shape[0] * per_pt["interior"]
    edges = n_bnd * (per_pt["boundary"] - per_pt["interior"])
    out["split"] = dict(main_ms=main_ms, locate_ms=locate, edge_ms=edges,
                        boundary_points=n_bnd)
    print(f"assign_cascade on three more batches (seed {CASCADE_SEED}), "
          f"each == twin: {CASCADE_BATCH} boundary points "
          f"{out['boundary']['ms']:.4f} ms, {CASCADE_BATCH} interior points "
          f"{out['interior']['ms']:.4f} ms, {CASCADE_RAGGED} points with "
          f"{at.numel()} off-extent / FAR / infinite / NaN ones (-1, no "
          f"flags); the main batch's {main_ms:.4f} ms modelled as locate "
          f"{locate:.4f} ms ({pts.shape[0]} points at the interior rate) + "
          f"edge tests {edges:.4f} ms ({n_bnd} boundary points at the "
          f"boundary rate's excess)")
    return out


def segment_work(ids, values, n_segments) -> tuple:
    """(bytes, operations) that ``segment_reduce_sorted`` needs: the
    values read once (none for a zero column), 16 bytes out per segment,
    and, since the ids are sorted, only the sectors of the S + 1 binary
    searches over them (one per step); 3 operations a row with values,
    one subtraction a segment without."""
    n = ids.shape[0]
    steps = max(1, (n - 1).bit_length())
    nbytes = 16 * n_segments + (n_segments + 1) * steps * SECTOR_BYTES
    if values is None:
        return nbytes, n_segments
    return nbytes + 4 * n, n * OPS_PER_SEGMENT_ROW


def candidates_work(pids, points, first, count, live, blocks,
                    max_blocks=1) -> tuple:
    """(bytes, live-edge tests) that one ``crossings_candidates`` call
    needs: each row's id and point read once and its count written (16
    bytes), the pool's per-polygon tables and its live edges (16 bytes
    each) read once; one test for each live edge of each row's
    candidate (none for a row without one), as ``ops`` clamps the ids."""
    valid = pids >= 0
    safe = pids.clamp(0, first.shape[0] - 1).long()
    n = torch.minimum(live[safe].long(), count[safe].long() * blocks.shape[2])
    tests = int(torch.where(valid, n, 0).sum())
    nbytes = (16 * pids.shape[0] + 12 * first.shape[0]
              + 16 * int(live.long().sum()))
    return nbytes, tests


def live_edges(edges) -> int:
    """Rows of an [E, 4] table that ``crossings_one`` stages: y1 != y2."""
    return int((edges[:, 1] != edges[:, 3]).sum())


def bound_ms(name, calls, index, fast_mod) -> tuple:
    """Least time for the work of ``calls`` on an H100: the larger of the
    bytes moved (each input read once, each output written once; the
    segment kernel's sorted ids only where searched; the candidate
    pool's live edges only) over the HBM rate and the operations
    (crossing tests, box tests, segment rows) over the fp32 peak.  The
    crossing tests are those these inputs need: ``crossings_candidates``
    tests each row's candidate's live edges, ``crossings_one`` the
    table's edges with y1 != y2 (the others never straddle, and its
    staging drops them)."""
    nbytes = ops = 0
    for args, kw, outs in calls:
        if name == "segment_reduce_sorted":
            b, o = segment_work(*args)
            nbytes, ops = nbytes + b, ops + o
            continue
        if name == "crossings_candidates":
            b, tests = candidates_work(*args, **kw)
            nbytes, ops = nbytes + b, ops + tests * OPS_PER_EDGE_TEST
            continue
        nbytes += call_bytes(args, outs)
        if name == "crossings_gathered":
            ops += args[1].shape[0] * args[1].shape[1] * OPS_PER_EDGE_TEST
        elif name == "crossings_one":
            ops += args[0].shape[0] * live_edges(args[1]) * OPS_PER_EDGE_TEST
        elif name == "bbox_mask":
            ops += args[0].shape[0] * args[1].shape[0] * OPS_PER_BOX_TEST
        elif name == "bbox_count_select":
            ops += args[1].shape[0] * args[1].shape[1] * OPS_PER_BOX_TEST
        else:
            bid, flags, _, nskip = outs
            ops += cascade_edge_tests(fast_mod, index, args[0], bid, flags,
                                      nskip) * OPS_PER_EDGE_TEST
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def segment_phase(n_blocks, tile_rows) -> list:
    """``segment_reduce_sorted`` against its twin and the numpy oracle on
    2^16 rows: uniform, skewed (40 % in one segment), invalid (ids < 0
    and >= S, parked at S as ``ops`` parks them, and unparked, straight
    to the wrapper), an odd segment count, one segment, more segments
    than rows, a row count that is no multiple of 4 and an empty input;
    and SPAN_ROWS rows with one segment over more than SPAN_TILES row
    tiles of ``tile_rows``.  Each with an integer-valued column, a uniform
    f32 column and no column (a zero column the kernel never reads);
    each column also from a view that starts 4 bytes into a buffer (not
    16-byte aligned), which must give the aligned call's bits.  A call
    launches once without values and twice with them.  Returns one
    summary row per case."""
    from repro_torch.kernels import _build, ref, segment
    rng = np.random.default_rng(2)
    n = N_KERNEL
    uniform = rng.integers(0, n_blocks, n)
    skewed = uniform.copy()
    skewed[rng.random(n) < 0.4] = n_blocks // 3
    invalid = rng.integers(-3, n_blocks + 3, n)
    span = SPAN_TILES * tile_rows + 1237
    long_span = np.sort(np.concatenate([
        rng.integers(0, n_blocks, SPAN_ROWS - span),
        np.full(span, n_blocks // 2)]))
    cases = [("uniform", uniform, n_blocks, True),
             ("skewed", skewed, n_blocks, True),
             ("invalid", invalid, n_blocks, True),
             ("unparked", invalid, n_blocks, False),
             ("odd_segments", rng.integers(0, 1000, n), 1000, True),
             ("one_segment", rng.integers(-1, 2, n), 1, True),
             ("sparse", rng.integers(0, 4 * n, n), 4 * n, True),
             ("odd_rows", rng.integers(0, 500, n + 3), 500, True),
             ("long_span", long_span, n_blocks, True),
             ("empty", np.zeros(0, np.int64), n_blocks, True)]
    rows = []
    for name, ids, n_seg, parked in cases:
        ids = ids.astype(np.int32)
        for kind in ("int", "float", "none"):
            vals = None if kind == "none" else (
                rng.integers(-50, 50, len(ids)) if kind == "int"
                else rng.random(len(ids))).astype(np.float32)
            t_ids = torch.from_numpy(ids).cuda()
            if parked:
                t_ids = torch.where((t_ids < 0) | (t_ids >= n_seg), n_seg,
                                    t_ids)
            s_ids, order = torch.sort(t_ids, stable=True)
            s_vals = None if vals is None \
                else torch.from_numpy(vals).cuda()[order]
            what = f"segment_reduce_sorted, {name} ids, {kind} values"
            _build.reset_launches()
            first = segment.segment_reduce_sorted(s_ids, s_vals, n_seg)
            launched = _build.LAUNCHES["segment_reduce_sorted"]
            # An empty column is counts alone: one launch.
            check(launched == (1 if vals is None or not len(ids) else 2),
                  f"{what}: {launched} launches")
            second = segment.segment_reduce_sorted(s_ids, s_vals, n_seg)
            twin = ref.segment_reduce(s_ids, s_vals, n_seg)
            if s_vals is not None:
                buf = torch.empty(len(ids) + 1, device="cuda")
                buf[1:] = s_vals
                view = buf[1:]
                check(not len(ids) or view.data_ptr() % 16 != 0,
                      "the column view is 16-byte aligned")
                shifted = segment.segment_reduce_sorted(s_ids, view, n_seg)
                check(all(torch.equal(a, b) for a, b in zip(first, shifted)),
                      f"{what}: a column 4 bytes into a buffer differs "
                      f"from the aligned one")
            torch.cuda.synchronize()
            oracle = ref.np_segment_reduce(ids, vals, n_seg)
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"{what}: a second launch is not bit-equal")
            err = 0
            for out, got, tw, want in zip(("count", "sum", "min", "max"),
                                          first, twin, oracle):
                host = got.cpu().numpy()
                if out == "sum" and kind == "float":
                    check(np.allclose(host, want, rtol=SUM_RTOL, atol=0),
                          f"{what}: sum beyond rtol {SUM_RTOL}")
                    continue
                e = max_abs_err(got, tw, what)
                check(e == 0 and np.array_equal(host, want),
                      f"{what}: {out} differs from the twin / oracle "
                      f"(max abs err {e})")
                err = max(err, e)
            total = np.abs(oracle[1]).astype(np.float64)
            rel = float(np.max(np.abs(first[1].cpu().numpy() - oracle[1])
                               / np.maximum(total, 1e-30))) \
                if len(ids) and kind == "float" else 0.0
            rows.append(dict(case=name, values=kind, rows=len(ids),
                             segments=n_seg, launches=launched,
                             max_abs_err=err, sum_max_rel_err=rel))
    return rows


def bbox_phase(smoke, pts, extent) -> list:
    """``bbox_mask`` against its twin at BBOX_BOXES boxes x BBOX_ROWS
    points: seeded boxes over the extent, one in five empty (xmin >
    xmax); the kernel phase's points with NaN, infinite and FAR rows and
    rows exactly on a box's edges mixed in; each batch also as a view
    that starts 8 bytes into a buffer (float2-aligned, not 16-byte).
    Each call bit-equal to the twin, a second launch bit-equal to the
    first, one launch a call."""
    mod = smoke.modules["bbox_mask"]
    x0, x1, y0, y1 = extent
    gen = torch.Generator(device="cuda").manual_seed(8)
    odd = torch.tensor([[math.nan, y0], [x0, math.nan], [math.inf, y0],
                        [-math.inf, y1], [x0, math.inf], [1e30, 1e30]],
                       device="cuda")
    out = []
    for m in BBOX_BOXES:
        u = torch.rand((m, 4), generator=gen, device="cuda")
        xa = x0 + (x1 - x0) * u[:, 0]
        ya = y0 + (y1 - y0) * u[:, 2]
        boxes = torch.stack([xa, xa + 0.5 * (x1 - x0) * u[:, 1], ya,
                             ya + 0.5 * (y1 - y0) * u[:, 3]], 1)
        boxes[2::5] = boxes[2::5][:, [1, 0, 3, 2]]    # empty boxes
        rows = torch.cat([pts, odd])[:max(BBOX_ROWS)].clone()
        k = torch.arange(rows.shape[0], device="cuda") % m
        edge = (torch.arange(rows.shape[0], device="cuda") % 13) == 0
        rows[edge, 0] = boxes[k[edge], 0]             # on xmin
        rows[edge, 1] = 0.5 * (boxes[k[edge], 2] + boxes[k[edge], 3])
        top = (torch.arange(rows.shape[0], device="cuda") % 17) == 5
        rows[top, 1] = boxes[k[top], 3]               # on ymax
        rows[3::97] = odd[torch.arange(rows[3::97].shape[0],
                                       device="cuda") % odd.shape[0]]
        for n in BBOX_ROWS:
            p = rows[:n].contiguous()
            buf = torch.empty(2 * n + 2, device="cuda")
            buf[2:] = p.reshape(-1)
            view = buf[2:].view(-1, 2)
            check(n == 0 or view.data_ptr() % 16 == 8,
                  "the +8-byte view is aligned")
            for layout, q in (("aligned", p), ("plus8", view)):
                what = f"bbox_mask, {n} points x {m} boxes, {layout}"
                smoke.build.reset_launches()
                got = mod.bbox_mask(q, boxes)
                launched = smoke.build.LAUNCHES["bbox_mask"]
                again = mod.bbox_mask(q, boxes)
                want = smoke.ref.bbox_mask(q, boxes)
                torch.cuda.synchronize()
                check(launched == (1 if n else 0),
                      f"{what}: {launched} launches")
                check(torch.equal(got, again), f"{what}: a second launch "
                                               f"differs")
                err = max_abs_err(got, want, what)
                check(err == 0, f"{what}: differs from its twin (max abs "
                                f"err {err})")
                out.append(dict(boxes=m, rows=n, points=layout,
                                inside=int(got.sum()), max_abs_err=err))
    print(f"kernel phase: bbox_mask == twin (and a second launch == the "
          f"first, one launch a call) at {BBOX_BOXES} boxes x {BBOX_ROWS} "
          f"points, aligned and 8 bytes into a buffer, with NaN / inf / "
          f"FAR points, points on box edges and one box in five empty; "
          f"inside bits at {max(BBOX_ROWS)} points: " + ", ".join(
              f"M {r['boxes']} {r['inside']}" for r in out
              if r["rows"] == max(BBOX_ROWS) and r["points"] == "aligned"))
    return out


def flash_phase(smoke) -> list:
    """``flash_attn_bhsd`` against its twin on the card: f32 and bf16,
    causal and full, D in FLASH_DIMS, S in FLASH_LENGTHS (100 and 300 are
    no tile multiple), BH 3 (2 at S = 2048), each within its tolerance
    and a second launch bit-equal to the first, each on the route
    ``flash_route`` names (both routes run); then GQA 8:2 through
    ``flash_attn`` (S = 256, a tile multiple) and ``ops.flash_attn``
    (S = 100).  Returns one summary row per case."""
    from repro_torch.kernels import ops
    fa, ref = smoke.flash, smoke.ref
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = []
    for dtype, causal, d, s in itertools.product(
            (torch.float32, torch.bfloat16), (True, False), FLASH_DIMS,
            FLASH_LENGTHS):
        bh = 2 if s >= 2048 else 3
        q, k, v = (rand(bh, s, d, dtype=dtype) for _ in range(3))
        route = fa.flash_route(dtype, d)
        before = smoke.build.ROUTE_LAUNCHES[f"flash_attn_bhsd:{route}"]
        out = fa.flash_attn_bhsd(q, k, v, causal=causal)
        again = fa.flash_attn_bhsd(q, k, v, causal=causal)
        twin = smoke.twin("flash_attn_bhsd", (q, k, v), {"causal": causal})
        torch.cuda.synchronize()
        what = (f"flash_attn_bhsd {route} {dtype} causal={causal} "
                f"[{bh}, {s}, {d}]")
        check(smoke.build.ROUTE_LAUNCHES[f"flash_attn_bhsd:{route}"]
              == before + 2, f"{what}: not launched on its route")
        check(torch.equal(out, again), f"{what}: a second launch is not "
                                       f"bit-equal")
        err, over = flash_err(out, *twin, what)
        rows.append(dict(case="bhsd", route=route,
                         dtype=str(dtype).split(".")[-1], causal=causal,
                         bh=bh, s=s, d=d, max_abs_err=err, over=over))

    def twin_part(i):          # the twin's output (0) or spread (1)
        return lambda q, k, v, causal: ref.flash_attn_bhsd(
            q, k, v, causal=causal, bk=fa.kv_tile(q.dtype, q.shape[2]),
            spread=True)[i]

    b, h, kh, d = 2, 8, 2, 64
    for s, fn, name in ((256, fa.flash_attn, "flash_attn"),
                        (100, ops.flash_attn, "ops.flash_attn")):
        q = rand(b, s, h, d, dtype=torch.bfloat16)
        k, v = (rand(b, s, kh, d, dtype=torch.bfloat16) for _ in range(2))
        out = fn(q, k, v, causal=True)
        want, spread = (fa.attend_bshd(twin_part(i), q, k, v, causal=True)
                        for i in (0, 1))
        torch.cuda.synchronize()
        err, over = flash_err(out, want, spread, f"GQA via {name}")
        rows.append(dict(case=f"gqa {h}:{kh} via {name}",
                         route=fa.flash_route(q.dtype, d), dtype="bfloat16",
                         causal=True, bh=b * h, s=s, d=d, max_abs_err=err,
                         over=over))
    return rows


def start_fault_build(build, tmp):
    """Start nvcc on a copy of ``csrc/flash_attn_wgmma.cu`` in ``tmp`` with
    one fault planted: the consumers of every block skip KV tile
    FAULT_TILE (they still release its stage, so the ring runs on).
    Returns (the nvcc process, the library it writes)."""
    src = (build.CSRC / "flash_attn_wgmma.cu").read_text()
    wait = "    mbar_wait(full + 8 * stage, phase);\n"
    check(src.count(wait) == 1, "flash_attn_wgmma.cu: the consumers' KV "
                                "tile wait is not where the planted fault "
                                "goes")
    cu = os.path.join(tmp, "flash_attn_fault.cu")
    with open(cu, "w") as f:
        f.write(src.replace(wait, wait + (
            f"    if (t == {FAULT_TILE}) {{\n"
            f"      mbar_arrive(empty + 8 * stage);\n"
            f"      continue;\n"
            f"    }}\n")))
    lib = os.path.join(tmp, "libflash_fault.so")
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", lib, cu,
         *build.LINK_FLAGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def load_fault(build, proc, lib_path):
    """Wait for ``start_fault_build``'s nvcc and bind its library: a
    function of bf16 q, k, v [BH, S, D] -> the faulty causal output.  Its
    launches are counted nowhere."""
    log = proc.communicate()[0]
    check(proc.returncode == 0, f"planted-fault flash build failed:\n{log}")
    fn = ctypes.CDLL(lib_path).repro_flash_attn_wgmma
    fn.argtypes = build._SIGNATURES["repro_flash_attn_wgmma"]
    fn.restype = ctypes.c_int

    def faulty(q, k, v):
        out = torch.empty_like(q)
        bh, s, d = q.shape
        status = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
                    bh, s, d, 1, ctypes.c_float(1.0 / math.sqrt(d)),
                    build.stream_of(q))
        check(status == 0, f"planted-fault flash launch failed ({status})")
        return out
    return faulty


def flash_bound(q, causal: bool) -> tuple:
    """(bound ms, by, bytes, operations) of one flash call on an H100: q,
    k, v read once and o written once, over the HBM rate; 4 BH S^2 D
    operations (2 products of [S, D] by [D, S]), half under the causal
    mask, over the tensor-core peak of the input dtype (bf16) or the
    fp32 peak."""
    bh, s, d = q.shape
    nbytes = 4 * q.numel() * q.element_size()
    ops = 4 * bh * s * s * d // (2 if causal else 1)
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def pip_one_states(ops, state_edges, pts):
    """[S, N] inside masks of every point against each state's edge
    table, through the public ``ops.pip_one``."""
    return torch.stack([ops.pip_one(pts, state_edges[s])
                        for s in range(state_edges.shape[0])])


def lm_path(smoke, result, launches, main_calls, faulty):
    """The LM serving path on the card (phase 2 of the module doc): the
    flash kernel phase, then Qwen1.5-0.5B at full width through
    ``launch.serve.serve`` with the launch counts of each phase, every
    prefill flash call held against the twin (and ``faulty``, the kernel
    with a planted fault, shown to fail the same bound on each), and the
    teacher-forced check.  Records the prefill's flash launches and its
    first call (for the timing) in ``launches`` / ``main_calls``; returns
    (model, prompts, generated tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    result["flash_phase"] = flash_phase(smoke)
    f32_err = max(r["max_abs_err"] for r in result["flash_phase"]
                  if r["dtype"] == "float32")
    worst = {route: max(r["over"] for r in result["flash_phase"]
                        if r["dtype"] == "bfloat16" and r["route"] == route)
             for route in ("wgmma", "simt")}
    n_route = {route: sum(r["route"] == route for r in result["flash_phase"])
               for route in ("wgmma", "simt")}
    print(f"kernel phase: flash_attn_bhsd == twin on "
          f"{len(result['flash_phase'])} cases (f32 and bf16, causal and "
          f"full, D {FLASH_DIMS}, S {FLASH_LENGTHS}; GQA 8:2 via "
          f"flash_attn and ops.flash_attn; {n_route['wgmma']} on the "
          f"tensor-core route, {n_route['simt']} on the CUDA-core one): f32 "
          f"max abs err {f32_err:.3g} (tol {FLASH_F32_ATOL}), bf16 within "
          f"{worst['wgmma']:.3g}x (wgmma) / {worst['simt']:.3g}x (simt) the "
          f"tolerance ({FLASH_BF16_ULPS} ulps + {FLASH_P_STEP} spread, "
          f"element by element); second launch bit-equal")
    lm_cfg = get_config(LM_ARCH)
    n_layers = lm_cfg.n_layers
    t0 = time.perf_counter()
    model = serve_mod.load_model(lm_cfg, seed=LM_SEED, device="cuda")
    prompts = serve_mod.make_prompts(lm_cfg, LM_BATCH, LM_PROMPT, LM_SEED,
                                     "cuda")
    torch.cuda.synchronize()
    result["lm_load_s"] = time.perf_counter() - t0
    result["lm_params"] = model.param_count()
    print(f"LM: {lm_cfg.name} at full width ({n_layers} layers, d "
          f"{lm_cfg.d_model}, {lm_cfg.n_heads} heads of {lm_cfg.hd}, d_ff "
          f"{lm_cfg.d_ff}, vocab {lm_cfg.vocab}): {result['lm_params']} "
          f"parameters, random from seed {LM_SEED}, on the card in "
          f"{result['lm_load_s']:.2f} s")
    phase_counts, phase_routes = {}, {}

    def on_phase(name, edge):
        if edge == "start":
            smoke.build.reset_launches()
        else:
            phase_counts[name] = dict(smoke.build.LAUNCHES)
            phase_routes[name] = dict(smoke.build.ROUTE_LAUNCHES)

    with smoke.capture(keep=["flash_attn_bhsd"]) as cap:
        res = serve_mod.serve(model, prompts, LM_GEN, on_phase=on_phase)
    for name, counts in phase_counts.items():
        for kname, n in counts.items():
            want = kname in ENGINE_KERNELS[f"lm_{name}"]
            check((n > 0) == want, f"LM {name}: {kname} launched {n} times")
    check(phase_counts["prefill"]["flash_attn_bhsd"] == n_layers,
          f"LM prefill: flash_attn_bhsd launched "
          f"{phase_counts['prefill']['flash_attn_bhsd']} times, not once "
          f"per layer ({n_layers})")
    check(phase_routes["prefill"]["flash_attn_bhsd:wgmma"] == n_layers,
          f"LM prefill: flash calls by route {phase_routes['prefill']}, not "
          f"all {n_layers} on the tensor cores")
    prefill_calls = cap.calls["flash_attn_bhsd"]
    bhsd = (LM_BATCH * lm_cfg.n_heads, LM_PROMPT, lm_cfg.hd)
    check(len(prefill_calls) == n_layers and all(
        a[0].shape == bhsd and a[0].dtype == torch.bfloat16
        and kw == {"causal": True} for a, kw, _ in prefill_calls),
        f"LM prefill: flash calls not {n_layers} causal bf16 {bhsd}")
    lm_err, lm_over, fault_over, fault_vmax = 0.0, 0.0, [], []
    for args, kw, (out,) in prefill_calls:
        want, spread = smoke.twin("flash_attn_bhsd", args, kw)
        err, over = flash_err(out, want, spread, "LM prefill flash call")
        lm_err, lm_over = max(lm_err, err), max(lm_over, over)
        # The planted fault must fail where the kernel passes.
        bad = faulty(*args)
        fault_over.append(flash_over(bad, want, spread))
        # What the earlier whole-call rule (2^-7 max|v|) would have said.
        fault_vmax.append(float((bad.float() - want.float()).abs().max()
                                / (FLASH_P_STEP
                                   * args[2].float().abs().max())))
        del want, spread, bad
    check(min(fault_over) > 1.0,
          f"LM prefill: a kernel that skips KV tile {FAULT_TILE} passes the "
          f"flash tolerance on a call ({min(fault_over):.3g}x)")
    launches["flash_attn_bhsd"] = phase_counts["prefill"]["flash_attn_bhsd"]
    main_calls["flash_attn_bhsd"] = prefill_calls[:1]
    del cap, prefill_calls
    gen_tok = res.tokens
    check(gen_tok.shape == (LM_BATCH, LM_GEN)
          and bool(((gen_tok >= 0) & (gen_tok < lm_cfg.vocab)).all())
          and torch.equal(gen_tok[:, 0], res.prefill_logits.argmax(-1).int())
          and bool(torch.isfinite(res.prefill_logits).all()),
          "LM: generated tokens out of range or not the prefill's argmax")
    print(f"main path LM prefill: {LM_BATCH} x {LM_PROMPT} tokens, launches "
          f"{ {k: v for k, v in phase_counts['prefill'].items() if v} } (one "
          f"per layer over B * H = {bhsd[0]} heads; by route "
          f"{ {k: v for k, v in phase_routes['prefill'].items() if v} }); "
          f"each call == twin "
          f"(max abs err {lm_err:.3g}, {lm_over:.3g}x the tolerance; the "
          f"kernel with KV tile {FAULT_TILE} skipped fails it on every call, "
          f"{min(fault_over):.3g}-{max(fault_over):.3g}x; against the earlier "
          f"2^-7 max|v| rule {min(fault_vmax):.3g}-{max(fault_vmax):.3g}x); "
          f"decode "
          f"{LM_GEN - 1} steps, launches "
          f"{ {k: v for k, v in phase_counts['decode'].items() if v} } (none "
          f"of the eight kernels)")
    # Teacher-forced: forward over prompt + generated tokens (its flash
    # calls held against the twin as they run), and decode fed the same
    # tokens; position S - 1 + i predicts generated token i.
    full = torch.cat([prompts, gen_tok], dim=1)
    run = serve_mod.run_config(LM_PROMPT)
    with smoke.capture(keep=[]) as cap, torch.no_grad():
        smoke.build.reset_launches()
        logits, _ = model.forward(run, {"tokens": full})
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
        routes = dict(smoke.build.ROUTE_LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["lm_forward"]
        check((n > 0) == want, f"LM forward: {kname} launched {n} times")
    check(counts["flash_attn_bhsd"] == n_layers
          and cap.checked["flash_attn_bhsd"]["calls"] == n_layers
          and routes["flash_attn_bhsd:wgmma"] == n_layers,
          f"LM forward: flash_attn_bhsd not once per layer on the tensor "
          f"cores ({routes})")
    fwd_err = cap.checked["flash_attn_bhsd"]["max_abs_err"]
    pred = logits[:, LM_PROMPT - 1:LM_PROMPT - 1 + LM_GEN].clone()
    del logits
    with torch.inference_mode():
        lg, cache = model.prefill(run, prompts, LM_PROMPT + LM_GEN)
        dec = [lg[:, -1]]
        for i in range(LM_GEN - 1):
            lg, cache = model.decode_step(run, gen_tok[:, i:i + 1], cache)
            dec.append(lg[:, -1])
    dec = torch.stack(dec, dim=1)
    del cache
    dec_diff = float((dec - pred).abs().max())
    check(bool(torch.isfinite(pred).all()) and dec_diff <= LOGIT_TOL,
          f"LM: decode logits differ from forward's by {dec_diff} > "
          f"{LOGIT_TOL}")
    top = pred.topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > LOGIT_TOL
    agree = top.indices[..., 0] == gen_tok.long()
    check(bool(agree[clear].all()), "LM: forward's argmax differs from a "
                                    "generated token where its margin is "
                                    "clear")
    result["lm_check"] = dict(
        prefill_flash_max_abs_err=lm_err, prefill_flash_over=lm_over,
        fault_over=fault_over, fault_over_vmax_rule=fault_vmax,
        forward_flash_max_abs_err=fwd_err, decode_vs_forward=dec_diff,
        skipped=int((~clear).sum()), agree_all=int(agree.sum()),
        distinct_tokens=int(torch.unique(gen_tok).numel()))
    print(f"main path LM teacher-forced: forward over {LM_BATCH} x "
          f"{full.shape[1]} tokens (flash once per layer, each == twin as it "
          f"ran, max abs err {fwd_err:.3g}); decode logits within "
          f"{dec_diff:.4g} of forward's (tol {LOGIT_TOL}); forward's argmax "
          f"== the generated token on all {int(clear.sum())} steps whose "
          f"top-2 margin > {LOGIT_TOL}, {result['lm_check']['skipped']} of "
          f"{clear.numel()} skipped ({int(agree.sum())} agree in all); "
          f"{result['lm_check']['distinct_tokens']} distinct tokens "
          f"generated")
    del pred, dec

    return model, prompts, gen_tok


def device_us(evt, names=("self_device_time_total",
                          "self_cuda_time_total")) -> float:
    """A profiler event's own device microseconds (the attribute's name
    differs across torch versions)."""
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_total(evt) -> float:
    """A profiler event's device microseconds, its children's included."""
    return device_us(evt, ("device_time_total", "cuda_time_total"))


def profile_busy(fn, top: int = 5, ops: bool = False, ranges=()) -> dict:
    """Run ``fn`` once under torch.profiler: host wall ms (synchronized),
    device ms summed over kernels, the busy share, launches and the
    ``top`` kernels by device time; with ``ops``, also the ``top``
    operators (aten ops and the like) by the device time of the kernels
    they launched themselves; with ``ranges`` ((module, attribute,
    label), ...), each of those functions wrapped in a
    ``record_function(label)`` range for the run, and ``ranges`` {label:
    (device ms of the kernels launched inside, calls)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = []
    for mod, attr, label in ranges:
        real = getattr(mod, attr)

        def wrap(*a, _real=real, _label=label, **kw):
            with record_function(_label):
                return _real(*a, **kw)
        saved.append((mod, attr, real))
        setattr(mod, attr, wrap)
    labels = {label for _, _, label in ranges}
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in labels), key=device_us, reverse=True)
    busy = sum(device_us(e) for e in kernels) / 1e3
    out = dict(wall_ms=wall, device_ms=busy, busy=busy / wall,
               launches=sum(e.count for e in kernels),
               top=[(e.key[:60], device_us(e) / 1e3, e.count)
                    for e in kernels[:top]])
    if ops:
        cpu = sorted((e for e in events if e.device_type == DeviceType.CPU
                      and device_us(e) > 0), key=device_us, reverse=True)
        out["ops"] = [(e.key[:60], device_us(e) / 1e3, e.count)
                      for e in cpu[:top]]
    if ranges:
        out["ranges"] = {e.key: (device_total(e) / 1e3, e.count)
                         for e in events if e.key in labels
                         and e.device_type == DeviceType.CPU}
    return out


def lm_timing(model, prompts, gen_tok, result, card) -> None:
    """Prefill and decode tok/s and peak device memory of one more
    ``serve`` run (no capture, no checks inside it); then one prefill and
    four decode steps under torch.profiler (device busy share, top
    kernels)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime.steps import make_serve_step
    res_t = serve_mod.serve(model, prompts, LM_GEN)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    result["lm"] = dict(
        batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN,
        prefill_s=res_t.prefill_s, decode_s=res_t.decode_s,
        prefill_tok_s=res_t.prefill_tok_s(),
        decode_tok_s=res_t.decode_tok_s(), weight_bytes=weights,
        peak_bytes=weights + res_t.peak_bytes,
        same_tokens=bool(torch.equal(res_t.tokens, gen_tok)))
    lm = result["lm"]
    print(f"LM serving ({card}): prefill {LM_BATCH} x {LM_PROMPT} in "
          f"{lm['prefill_s'] * 1e3:.1f} ms = {lm['prefill_tok_s']:.5g} tok/s; "
          f"{LM_GEN - 1} decode steps in {lm['decode_s'] * 1e3:.1f} ms = "
          f"{lm['decode_tok_s']:.5g} tok/s "
          f"({lm['decode_s'] / (LM_GEN - 1) * 1e3:.2f} ms a step); peak "
          f"device memory {lm['peak_bytes'] / 2**30:.2f} GiB (the weights "
          f"{weights / 2**30:.2f} GiB + the run's own peak); tokens equal "
          f"to the first run: {lm['same_tokens']}")
    run = serve_mod.run_config(LM_PROMPT)
    state = {}

    def prefill():
        state["out"] = model.prefill(run, prompts, LM_PROMPT + LM_GEN)

    step = make_serve_step(model, run)

    def decode():
        tok, cache = gen_tok[:, :1], state["out"][1]
        for _ in range(4):
            tok, cache = step(tok, cache)

    lm["profile"] = {"prefill": profile_busy(prefill),
                     "decode_4_steps": profile_busy(decode)}
    for name, p in lm["profile"].items():
        print(f"LM {name} under torch.profiler: wall {p['wall_ms']:.2f} ms, "
              f"device {p['device_ms']:.2f} ms (busy {p['busy']:.1%}), "
              f"{p['launches']} launches; top kernels "
              + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in p["top"]))


def flash_row(smoke, calls, launches: int, batch: int = LM_BATCH,
              path: str = "lm_prefill") -> dict:
    """The flash kernel's row, per call at a path's shape ([B * H, S, hd]
    bf16, causal: ``calls`` holds the path's first call, ``batch`` its
    B), beside its twin and PyTorch's fused attention on the same tensors
    viewed [B, H, S, hd] (timed only; the port never calls it)."""
    (q, k, v), kw, (out,) = calls[0]
    err = smoke.compare("flash_attn_bhsd", calls)
    fa_fn = smoke.flash.flash_attn_bhsd
    ms = cuda_ms(lambda: fa_fn(q, k, v, **kw), KERNEL_REPS)
    plain = cuda_ms(lambda: smoke.ref.flash_attn_bhsd(
        q, k, v, **kw, bk=smoke.flash.kv_tile(q.dtype, q.shape[2])),
        2)                                             # without the spread
    bh, s, d = q.shape
    q4, k4, v4 = (x.view(batch, bh // batch, s, d) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_diff = float((sdpa(q4, k4, v4, is_causal=True).float().reshape(
        out.shape) - out.float()).abs().max())
    library = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True), KERNEL_REPS)
    bound, bound_by, nbytes, n_ops = flash_bound(q, kw["causal"])
    route = smoke.flash.flash_route(q.dtype, q.shape[2])
    print(f"flash_attn_bhsd ({route} route): {ms:.4f} ms per call at "
          f"{list(q.shape)} bf16 causal (the {path} path: {launches} calls, "
          f"{ms * launches:.2f} ms a pass; {n_ops / ms / 1e9:.4g} "
          f"TFLOP/s) vs plain twin {plain:.3f} ms, "
          f"scaled_dot_product_attention {library:.4f} ms (output within "
          f"{lib_diff:.3g} of the kernel's; kernel / library "
          f"{ms / library:.3g}x); bound {bound:.4f} ms by {bound_by} "
          f"({nbytes} B, {n_ops} ops); {bound / ms:.2%} of bound")
    return {"name": "flash_attn_bhsd", "route": "cuda",
            "source": KERNELS["flash_attn_bhsd"][0],
            "replaces": KERNELS["flash_attn_bhsd"][1], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
            "kernel_route": route}


def minicpm_path(smoke, result) -> None:
    """MiniCPM-2B's reduced config (head dim 72 / 6 = 12, which no flash
    kernel instance has) through ``launch.serve.serve`` on the card:
    MINICPM_BATCH prompts of MINICPM_PROMPT tokens and MINICPM_GEN greedy
    tokens.  The prefill must launch the flash kernel once per layer (its
    wrapper pads D to 16 and slices it back), each call held against the
    twin at the true D; decode launches none of the eight kernels."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as serve_mod
    cfg = get_reduced_config(MINICPM_ARCH)
    model = serve_mod.load_model(cfg, seed=LM_SEED, device="cuda")
    prompts = serve_mod.make_prompts(cfg, MINICPM_BATCH, MINICPM_PROMPT,
                                     LM_SEED, "cuda")
    counts = {}

    def on_phase(name, edge):
        if edge == "start":
            smoke.build.reset_launches()
        else:
            counts[name] = dict(smoke.build.LAUNCHES)

    with smoke.capture(keep=["flash_attn_bhsd"]) as cap:
        res = serve_mod.serve(model, prompts, MINICPM_GEN, on_phase=on_phase)
    torch.cuda.synchronize()
    for name in ("prefill", "decode"):
        for kname, n in counts[name].items():
            want = kname in ENGINE_KERNELS[f"lm_{name}"]
            check((n > 0) == want, f"{cfg.name} {name}: {kname} launched "
                                   f"{n} times")
    calls = cap.calls["flash_attn_bhsd"]
    hd = cfg.d_model // cfg.n_heads
    check(counts["prefill"]["flash_attn_bhsd"] == cfg.n_layers
          and len(calls) == cfg.n_layers
          and all(a[0].shape[2] == hd for a, _, _ in calls),
          f"{cfg.name} prefill: flash calls {len(calls)} / launches "
          f"{counts['prefill']['flash_attn_bhsd']}, not one per layer at "
          f"head dim {hd}")
    err = over = 0.0
    for args, kw, (out,) in calls:
        want, spread = smoke.twin("flash_attn_bhsd", args, kw)
        e, o = flash_err(out, want, spread, f"{cfg.name} prefill flash call")
        err, over = max(err, e), max(over, o)
    tok = res.tokens
    check(tok.shape == (MINICPM_BATCH, MINICPM_GEN)
          and bool(((tok >= 0) & (tok < cfg.vocab)).all())
          and bool(torch.isfinite(res.prefill_logits).all())
          and torch.equal(tok[:, 0], res.prefill_logits.argmax(-1).int()),
          f"{cfg.name}: generated tokens out of range or not the prefill's "
          f"argmax")
    result["minicpm"] = dict(
        head_dim=hd, padded_to=smoke.flash.padded_head_dim(hd),
        route=smoke.flash.flash_route(calls[0][0][0].dtype, hd),
        dtype=str(calls[0][0][0].dtype).split(".")[-1],
        prefill_flash_launches=counts["prefill"]["flash_attn_bhsd"],
        max_abs_err=err, over=over, prefill_tok_s=res.prefill_tok_s(),
        decode_tok_s=res.decode_tok_s())
    m = result["minicpm"]
    print(f"main path {cfg.name} (head dim {hd}, padded to "
          f"{m['padded_to']} on the {m['route']} route, {m['dtype']}): "
          f"{MINICPM_BATCH} x {MINICPM_PROMPT} prompt tokens and "
          f"{MINICPM_GEN} greedy tokens through launch.serve.serve; prefill "
          f"launches {m['prefill_flash_launches']} flash calls (one per "
          f"layer), each == twin at the true head dim (max abs err "
          f"{err:.3g}, {over:.3g}x the tolerance); decode launches none")


def flash_many_heads(smoke, result) -> None:
    """One ``flash_attn_bhsd`` call over MANY_HEADS = 65,537 heads (more
    than the kernels' grid y of 65,535): the wrapper launches it in two
    chunks on one stream.  The first and last heads (past 65,535) and a
    seeded sample are held against the twin."""
    fa = smoke.flash
    bh, s, d = MANY_HEADS
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = smoke.build.ROUTE_LAUNCHES["flash_attn_bhsd:wgmma"]
    out = fa.flash_attn_bhsd(q, k, v, causal=True)
    torch.cuda.synchronize()
    n_launch = smoke.build.ROUTE_LAUNCHES["flash_attn_bhsd:wgmma"] - before
    want_launch = -(-bh // fa.MAX_BH)
    check(n_launch == want_launch, f"flash over {bh} heads: {n_launch} "
                                   f"launches, not {want_launch}")
    heads = torch.cat([torch.arange(4, device="cuda"),
                       torch.arange(bh - 4, bh, device="cuda"),
                       torch.randperm(bh, generator=gen,
                                      device="cuda")[:MANY_HEADS_SAMPLE]])
    args = (q[heads], k[heads], v[heads])
    want, spread = smoke.twin("flash_attn_bhsd", args, {"causal": True})
    err, over = flash_err(out[heads], want, spread,
                          f"flash over {bh} heads")
    ms = cuda_ms(lambda: fa.flash_attn_bhsd(q, k, v, causal=True), 2)
    result["flash_many_heads"] = dict(
        shape=[bh, s, d], launches=n_launch, heads_checked=heads.numel(),
        max_abs_err=err, over=over, ms=ms)
    print(f"kernel phase: flash_attn_bhsd over [{bh}, {s}, {d}] bf16 "
          f"causal ({q.numel() * 2 / 2**30:.2f} GiB a tensor): {n_launch} "
          f"launches of at most {fa.MAX_BH} heads; heads 0-3, "
          f"{bh - 4}-{bh - 1} and {MANY_HEADS_SAMPLE} seeded ones == twin "
          f"(max abs err {err:.3g}, {over:.3g}x the tolerance); {ms:.3f} ms "
          f"a call")
    del q, k, v, out, args, want, spread
    torch.cuda.empty_cache()


def misaligned_phase(engines, pts) -> None:
    """Each engine's ``assign`` on ``flat[1:].view(-1, 2)``: contiguous
    points whose data starts 4 bytes past a float2 boundary.  Ids and
    stats must equal those of the aligned copy."""
    flat = torch.empty(2 * pts.shape[0] + 1, device="cuda")
    flat[1:] = pts.reshape(-1)
    view = flat[1:].view(-1, 2)
    check(view.is_contiguous() and view.data_ptr() % 8 != 0,
          "the misaligned view is aligned")
    for name, eng in engines.items():
        got, want = eng.assign(view), eng.assign(view.clone())
        for f in ("state", "county", "block"):
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"{name}: {f} ids on misaligned points differ")
        check(got.stats.as_dict() == want.stats.as_dict(),
              f"{name}: stats on misaligned points differ")
    print(f"kernel phase: every engine's assign on flat[1:].view(-1, 2) of "
          f"{pts.shape[0]} points (data_ptr % 8 == {view.data_ptr() % 8}) == "
          f"on the aligned copy (ids, stats)")


def pool_phase(smoke, ops, sindex, findex, pts, truth_block,
               truth_state) -> list:
    """``crossings_candidates`` against its twin on pools the main path
    does not build: the state tables packed at BE = 64 (polygons of
    92-142 live edges over 2-3 blocks), the block table with one polygon
    emptied (0 live edges), and the block pool rebuilt through
    ``EdgePool.from_numpy`` from its host arrays (live counts derived
    from the blocks, equal to the packed ones).  Rows: each point's true
    polygon, a random one, -1 and an id past the table, unsorted and
    sorted; every count bit-equal to the twin and a second launch
    bit-equal to the first."""
    gp = smoke.modules["crossings_candidates"]
    block_edges = findex.block_edges.cpu().numpy()
    emptied = block_edges.copy()
    emptied[EMPTY_POLY] = 0.0
    base = ops.build_edge_pool(block_edges, device="cuda")
    derived = ops.EdgePool.from_numpy(*(getattr(base, f).cpu().numpy()
                                        for f in ("blocks", "first",
                                                  "count")), device="cuda")
    check(torch.equal(derived.live, base.live),
          "EdgePool.from_numpy: derived live counts differ from the packed")
    state = ops.build_edge_pool(sindex.state_edges.cpu().numpy(), be=64,
                                device="cuda")
    check(int(state.count.min()) >= 2, "state pool at BE 64: a polygon in "
                                       "one block")
    empty = ops.build_edge_pool(emptied, device="cuda")
    check(int(empty.live[EMPTY_POLY]) == 0
          and int(empty.count[EMPTY_POLY]) == 0, "emptied polygon has edges")
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = []
    for name, pool, truth in (("state_be64", state, truth_state),
                              ("empty_polygon", empty, truth_block),
                              ("from_numpy", derived, truth_block)):
        n, p = pts.shape[0], pool.n_poly
        pick = torch.randint(0, 4, (n,), generator=gen, device="cuda")
        rand = torch.randint(0, p, (n,), generator=gen, device="cuda")
        pid = torch.where(pick == 0, rand, truth.long())
        pid = torch.where(pick == 1, -1, pid)
        pid = torch.where((pick == 2) & (rand % 8 == 0), p, pid)
        if name == "empty_polygon":
            pid = torch.where(rand % 16 == 0, EMPTY_POLY, pid)
        pid = pid.int()
        for order in ("unsorted", "sorted"):
            rows = pid if order == "unsorted" else torch.sort(pid)[0]
            args = (rows, pts, pool.first, pool.count, pool.live,
                    pool.blocks)
            kw = {"max_blocks": pool.max_blocks}
            got = gp.crossings_candidates(*args, **kw)
            again = gp.crossings_candidates(*args, **kw)
            want = smoke.twin("crossings_candidates", args, kw)[0]
            check(torch.equal(got, again), f"crossings_candidates {name}: "
                                           f"a second launch differs")
            err = max_abs_err(got, want, f"crossings_candidates {name}")
            check(err == 0, f"crossings_candidates differs from its twin "
                            f"on the {name} pool ({order}; max abs err "
                            f"{err})")
            out.append(dict(pool=name, order=order, rows=n,
                            blocks_per_poly=[int(pool.count.min()),
                                             int(pool.count.max())],
                            live=[int(pool.live.min()),
                                  int(pool.live.max())],
                            inside=int((got & 1).sum()), max_abs_err=err))
    print("kernel phase: crossings_candidates == twin (and a second launch "
          "== the first) on " + "; ".join(
              f"{r['pool']} ({r['order']}: blocks a polygon "
              f"{r['blocks_per_poly']}, live edges {r['live']}, "
              f"{r['inside']} of {r['rows']} rows inside)" for r in out))
    return out


def one_phase(smoke, sindex, pts, extent) -> list:
    """``crossings_one`` against its twin on tables the main path does
    not pass: E = 0, E = 1, E = 284 (two state tables, no multiple of
    the 256-edge tile, their y1 == y2 padding rows among them), and a
    state table, each over ONE_ROWS points (no multiple of the 4-point
    thread or the 1,024-point block) with NaN, infinite, FAR and
    off-extent ones mixed in; bit-equal, and a second launch bit-equal
    to the first."""
    fn = smoke.modules["crossings_one"].crossings_one
    x0, x1, y0, y1 = extent
    odd = torch.tensor([[x0 - 1.0, y0], [x1 + 1.0, y1], [1e30, 1e30],
                        [-1e30, -1e30], [math.inf, y0], [x0, -math.inf],
                        [math.nan, y0], [x0, math.nan]], device="cuda")
    rows = torch.cat([pts, odd])[:ONE_ROWS]
    rows[::97] = odd[torch.arange(rows[::97].shape[0], device="cuda")
                     % odd.shape[0]]
    se = sindex.state_edges
    tables = {"E=0": se[0, :0], "E=1": se[0, :1],
              "E=284": torch.cat([se[0], se[1]])[:284],
              "state 0": se[0]}
    out = []
    for name, edges in tables.items():
        edges = edges.contiguous()
        got, again = fn(rows, edges), fn(rows, edges)
        want = smoke.ref.crossings_one(rows, edges)
        check(torch.equal(got, again), f"crossings_one {name}: a second "
                                       f"launch differs")
        err = max_abs_err(got, want, f"crossings_one {name}")
        check(err == 0, f"crossings_one differs from its twin at {name} "
                        f"(max abs err {err})")
        out.append(dict(table=name, edges=edges.shape[0],
                        staged=live_edges(edges), rows=rows.shape[0],
                        max_abs_err=err))
    print(f"kernel phase: crossings_one == twin (and a second launch == "
          f"the first) on {rows.shape[0]} points with NaN / inf / FAR / "
          f"off-extent ones against " + ", ".join(
              f"{r['table']} ({r['staged']} of {r['edges']} edges staged)"
              for r in out))
    return out


def candidate_rows(calls) -> list:
    """Per ``crossings_candidates`` call: its rows, the rows that carry a
    candidate, and the rows at the call's most repeated point: the
    compaction's unfilled slots, which all alias one row
    (core/compact.py), times the candidate slots a point brings."""
    out = []
    for args, _, _ in calls:
        pids, points = args[0], args[1]
        _, reps = torch.unique(points.view(torch.int64), return_counts=True)
        out.append(dict(rows=pids.shape[0],
                        with_candidate=int((pids >= 0).sum()),
                        alias_rows=int(reps.max()) if reps.numel() else 0))
    return out


def launched_only(smoke, path: str, kernels) -> dict:
    """The launch counts since the last reset; fails unless each of
    ``kernels`` launched and no other kernel did."""
    counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        check((n > 0) == (kname in kernels),
              f"{path}: {kname} launched {n} times (expected "
              f"{'> 0' if kname in kernels else '0'})")
    return {k: v for k, v in counts.items() if v}


def same_ids(res, want, what: str) -> None:
    """Served (numpy) or assigned (tensor) ids equal ``want``'s tensors."""
    for field, w in zip(("state", "county", "block"), want):
        got = getattr(res, field)
        got = got if isinstance(got, np.ndarray) else got.cpu().numpy()
        check(np.array_equal(got, w.cpu().numpy()),
              f"{what}: {field} ids differ")


def cold_start_phase(smoke, engines, census, cov, cfg, xy, pts, result):
    """Phase 8a: record the measured winner among the three fast paths in
    a GeoIndexSet, save it, cold-start a GeoServer from it on cuda
    (``strategy="auto"``), and serve 2^20 of the main path's points; then
    a copy whose tuning names another device kind replans to ``fast``."""
    import shutil
    from repro_torch.core.artifact import GeoIndexSet, MANIFEST_NAME
    from repro_torch.serving import GeoServer, ServeConfig
    rates = {n: result["pts_per_s"][n]
             for n in ("fast", "fast_fused", "fast_onepass")}
    winner = max(rates, key=rates.get)
    want_strategy = "fast_onepass" if winner == "fast_onepass" else "fast"
    be = engines["fast_onepass"].fast_index.edge_pool.be
    iset = GeoIndexSet(census=census, covering=cov, max_level=MAX_LEVEL,
                       gbits=cfg.gbits, max_cand=cfg.max_cand)
    iset.record_tuning({"winner": winner, "be": int(be),
                        "device_kind": "cuda",
                        "pts_per_sec": float(rates[winner])})
    out = {"winner": winner, "rates": rates, "be": int(be)}
    with tempfile.TemporaryDirectory(dir=smoke.build.BUILD_ROOT) as tmp:
        path = os.path.join(tmp, "artifact")
        t0 = time.perf_counter()
        iset.save(path)
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = {f: os.path.getsize(os.path.join(path, f))
                        for f in sorted(os.listdir(path))}
        serve_cfg = ServeConfig(buckets=SERVE_BUCKETS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = GeoServer.from_artifact(path, strategy="auto",
                                       cfg=serve_cfg, engine_cfg=cfg)
        t1 = time.perf_counter()
        engine = cold.regions[0].engine
        smoke.build.reset_launches()
        first = engine.assign(pts[:N_COLD])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        served = cold.submit(xy[:N_COLD])
        torch.cuda.synchronize()
        out["launches"] = launched_only(smoke, "cold start",
                                        ENGINE_KERNELS[want_strategy])
        out.update(from_artifact_s=t1 - t0, first_assign_s=t2 - t1,
                   cold_start_s=t2 - t0, plan=engine.explain())
        check(engine.device.type == "cuda", "cold-start index not on cuda")
        check(out["plan"]["strategy"] == want_strategy,
              f"cold start planned {out['plan']['strategy']}, the recorded "
              f"winner is {winner}")
        warm = engines[want_strategy].assign(pts[:N_COLD])
        warm_ids = (warm.state, warm.county, warm.block)
        same_ids(first, warm_ids, "cold-start assign vs the warm engine")
        same_ids(served, warm_ids, "cold-start server vs the warm engine")
        check(engine.indices.memory_footprint()
              == engines[want_strategy].indices.memory_footprint(),
              "cold-start footprint differs from the warm engine's")
        # Another device kind's record must not steer the plan on cuda.
        other = os.path.join(tmp, "artifact_tpu")
        shutil.copytree(path, other)
        mpath = os.path.join(other, MANIFEST_NAME)
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["tuning"]["device_kind"] = "tpu"
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        foreign = GeoServer.from_artifact(other, strategy="auto",
                                          cfg=serve_cfg, engine_cfg=cfg)
        plan = foreign.regions[0].engine.explain()
        check(plan["strategy"] == "fast" and plan["fused"] is False,
              f"a tpu tuning record replanned to {plan['strategy']} "
              f"fused={plan['fused']} on cuda, not fast")
        smoke.build.reset_launches()
        served = foreign.submit(xy[:N_KERNEL])
        torch.cuda.synchronize()
        out["foreign_launches"] = launched_only(
            smoke, "cold start with a tpu record", ENGINE_KERNELS["fast"])
        same_ids(served, [t[:N_KERNEL] for t in warm_ids],
                 "tpu-record cold start vs the warm engine")
    result["cold_start"] = out
    print(f"cold start: winner {winner} (pts/s "
          f"{ {k: f'{v:.4g}' for k, v in rates.items()} }), be {be}; saved "
          f"in {out['save_s']:.3f} s, {sum(out['bytes'].values())} bytes on "
          f"disk {out['bytes']}; from_artifact (load + ensure + server) "
          f"{out['from_artifact_s']:.3f} s + first assign of {N_COLD} points "
          f"{out['first_assign_s']:.3f} s = {out['cold_start_s']:.3f} s, "
          f"against the covering BFS's {result['covering_s']:.2f} s; plan "
          f"{out['plan']['strategy']} fused={out['plan']['fused']}, "
          f"launches {out['launches']}; served ids == the warm engine's on "
          f"{N_COLD} points; a tpu tuning record plans {plan['strategy']} "
          f"(launches {out['foreign_launches']}), ids equal")


def async_phase(smoke, engine, make_server, replay, stream, now, served,
                snap, want_ids, reqs, result):
    """Phase 8b: AsyncGeoServer over ``fast`` with phase 6's ServeConfig
    (analytics mounted): phase 6's stream from one client in order (ids
    and analytics snapshot equal to the sync server's), then the 256
    requests of 16,384 points from 8 client threads (every future
    resolves with a direct assign's ids, no failed flush)."""
    import threading
    from repro_torch.serving import AsyncGeoServer, FrontendConfig
    frontend = FrontendConfig(n_submitters=ASYNC_SUBMITTERS,
                              n_replicas=ASYNC_REPLICAS)
    out = {"submitters": ASYNC_SUBMITTERS, "replicas": ASYNC_REPLICAS}
    with make_server(engine, True, cls=AsyncGeoServer,
                     frontend=frontend) as srv:
        srv.warm()
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        got = replay(srv)
        torch.cuda.synchronize()
        out["stream_launches"] = launched_only(smoke, "async stream",
                                               ENGINE_KERNELS["serving"])
        for a, b in zip(got, served):
            check(all(np.array_equal(getattr(a, f), getattr(b, f))
                      for f in ("state", "county", "block", "region")),
                  "async served ids differ from the sync server's")
        check(srv.snapshot_analytics() == snap,
              "async analytics snapshot differs from the sync server's")
    with make_server(engine, True, cls=AsyncGeoServer,
                     frontend=frontend) as srv:
        srv.warm()
        now[0] = 100.0
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        futures = [None] * len(reqs)

        def client(c):
            for i in range(c, len(reqs), ASYNC_CLIENTS):
                futures[i] = srv.submit_async(reqs[i])

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(ASYNC_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        out["load_launches"] = launched_only(smoke, "async load",
                                             ENGINE_KERNELS["serving"])
        counters = srv.metrics.snapshot()["counters"]
        lat = srv.metrics.latency.snapshot_ms()
        stages = srv.metrics.snapshot()["stages"]
    for field in ("failed_flushes", "failed_requests", "shed_requests"):
        check(counters.get(field, 0) == 0, f"async load: {field} "
                                           f"{counters.get(field, 0)}")
    n = len(reqs) * LOAD_POINTS
    for field, w in zip(("state", "county", "block"), want_ids):
        got = np.concatenate([getattr(r, field) for r in results])
        check(np.array_equal(got, w[:n].cpu().numpy()),
              f"async load: {field} ids differ from a direct assign")
    sync = result["serve_load"]
    out.update(clients=ASYNC_CLIENTS, requests=len(reqs),
               points_per_request=LOAD_POINTS, seconds=load_s,
               pts_per_s=n / load_s, latency_ms=lat,
               stage_p50_ms={k: v["p50"] for k, v in stages.items()},
               batches=counters.get("batches", 0))
    result["async_serving"] = out
    print(f"async serving: phase 6's stream from one client == the sync "
          f"server (ids, analytics snapshot), launches "
          f"{out['stream_launches']}; {len(reqs)} requests x {LOAD_POINTS} "
          f"points from {ASYNC_CLIENTS} client threads ({ASYNC_SUBMITTERS} "
          f"submitters, {ASYNC_REPLICAS} replicas) in {load_s:.3f} s = "
          f"{out['pts_per_s']:.4g} pts/s (sync: {sync['pts_per_s']:.4g}); "
          f"request latency p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms "
          f"(sync: {sync['latency_ms']['p50']:.3f} / "
          f"{sync['latency_ms']['p99']:.3f} ms); stage p50 ms "
          f"{ {k: round(v, 3) for k, v in out['stage_p50_ms'].items()} }; "
          f"every future == a direct assign, no failed flush; launches "
          f"{out['load_launches']}")


def pipeline_phase(smoke, engine, cpu_engine, pts, want_ids, result):
    """Phase 8c: ``enrich`` of the main path's points through the fast
    index (ids equal the engine's), then the GeoEnriched source of
    Qwen1.5-0.5B's full config: geo blocks equal a direct assign of the
    sampled points, tokens equal a CPU source's."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.enrich import enrich
    from repro_torch.data import make_source
    out = {}
    index, fcfg = engine.fast_index, engine.cfg.fast_cfg()
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    feats = enrich(index, pts, fcfg)
    torch.cuda.synchronize()
    out["enrich_s"] = time.perf_counter() - t0
    out["enrich_launches"] = launched_only(smoke, "enrich",
                                           ENGINE_KERNELS["fast"])
    for key, w in zip(("state", "county", "block"), want_ids):
        check(torch.equal(feats[key], w), f"enrich {key} ids differ from "
                                          f"the fast engine's")
    bid = want_ids[2]
    check(torch.equal(feats["feature_token"],
                      torch.where(bid >= 0, bid % 1024, 1024).int()),
          "enrich feature tokens")
    out["enrich_pts_per_s"] = N_MAIN / out["enrich_s"]
    lm_cfg = get_config(LM_ARCH)
    shape = ShapeConfig("geo_smoke", PIPE_SEQ, PIPE_BATCH, "train")
    src = make_source(lm_cfg, shape, geo=engine)
    cpu_src = make_source(lm_cfg, shape, geo=cpu_engine, device="cpu")
    check(engine.cfg.mode == "exact", "the pipeline's engine is not exact")
    src.batch_at(0)
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    batches = [src.batch_at(step) for step in range(PIPE_STEPS)]
    torch.cuda.synchronize()
    out["batch_ms"] = (time.perf_counter() - t0) * 1e3 / PIPE_STEPS
    out["pipeline_launches"] = launched_only(smoke, "GeoEnriched",
                                             ENGINE_KERNELS["fast"])
    on_map, ulps = 0, 0
    for step, b in enumerate(batches):
        check(b["tokens"].shape == (PIPE_BATCH, PIPE_SEQ)
              and b["tokens"].device.type == "cuda", "pipeline batch shape")
        xy_s = src.sample_points(step, PIPE_BATCH)
        check(torch.equal(b["geo_block"], engine.assign(xy_s).block),
              f"step {step}: geo_block differs from a direct assign")
        cb = cpu_src.batch_at(step)
        for key in ("tokens", "labels", "geo_block"):
            check(torch.equal(b[key].cpu(), cb[key]),
                  f"step {step}: {key} differs from the CPU source's")
        cxy = cpu_src.sample_points(step, PIPE_BATCH)
        ulps = max(ulps, int((xy_s.cpu().view(torch.int32)
                              - cxy.view(torch.int32)).abs().max()))
        on_map += int((b["geo_block"] >= 0).sum())
    check(on_map * 2 > PIPE_STEPS * PIPE_BATCH,
          f"only {on_map} of {PIPE_STEPS * PIPE_BATCH} pipeline points on "
          f"the map")
    out.update(on_map=on_map, points=PIPE_STEPS * PIPE_BATCH,
               point_ulps_vs_cpu=ulps)
    result["pipeline"] = out
    print(f"enrich: {N_MAIN} points in {out['enrich_s'] * 1e3:.2f} ms "
          f"({out['enrich_pts_per_s']:.4g} pts/s), ids == the fast engine's, "
          f"launches {out['enrich_launches']}; GeoEnriched({LM_ARCH} full "
          f"config, {PIPE_BATCH} x {PIPE_SEQ}): batch_at(0..{PIPE_STEPS - 1}) "
          f"{out['batch_ms']:.3f} ms a batch, geo_block == a direct assign, "
          f"tokens == the CPU source's (points {ulps} ulps apart), {on_map} "
          f"of {PIPE_STEPS * PIPE_BATCH} on the map, launches "
          f"{out['pipeline_launches']}")


def trainable_flash_check(smoke) -> dict:
    """Phase 9a: ``make_flash_attn_trainable`` at TRAIN_FLASH_SHAPE bf16 on
    the card: its output equals ``flash_attn``'s (the kernel, no grad) bit
    for bit, its gradients equal ``torch.autograd.grad`` through
    ``blockwise_attn`` (the program its backward runs) bit for bit, and
    its forward launched the tensor-core kernel once."""
    from repro_torch.models.attention import blockwise_attn
    b, s, h, d = TRAIN_FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    f = smoke.flash.make_flash_attn_trainable(causal=True)
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    out = f(q, k, v)
    torch.cuda.synchronize()
    launches = dict(smoke.build.ROUTE_LAUNCHES)
    check(launches["flash_attn_bhsd:wgmma"] == 1
          and smoke.build.LAUNCHES["flash_attn_bhsd"] == 1,
          f"trainable flash: launches {launches}, not one wgmma call")
    grads = torch.autograd.grad(out, (q, k, v), g)
    with torch.no_grad():
        want = smoke.flash.flash_attn(q, k, v, causal=True)
    check(torch.equal(out.detach(), want), "trainable flash: output differs "
                                           "from flash_attn's")
    c = min(1024, s)
    ref = blockwise_attn(q, k, v, causal=True, chunk_q=c, chunk_kv=c)
    want_g = torch.autograd.grad(ref, (q, k, v), g)
    for name, a, w in zip("qkv", grads, want_g):
        check(torch.equal(a, w), f"trainable flash: d{name} differs from "
                                 f"autograd through blockwise_attn "
                                 f"(max abs err {max_abs_err(a, w, name)})")
    print(f"phase 9: make_flash_attn_trainable at {list(TRAIN_FLASH_SHAPE)} "
          f"bf16: output == flash_attn (the wgmma kernel, launched once: "
          f"{ {k: n for k, n in launches.items() if n} }), dq / dk / dv == "
          f"autograd through blockwise_attn (chunk {c}) bit for bit")
    return {"shape": list(TRAIN_FLASH_SHAPE), "launches": launches}


def twin_flash(smoke):
    """``flash_attn_bhsd`` replaced by its plain twin (at the route's KV
    tile) inside the block: the plain path of the training step."""
    ref, flash = smoke.ref, smoke.flash
    saved = flash.flash_attn_bhsd

    def twin(q, k, v, *, causal=True):
        return ref.flash_attn_bhsd(q, k, v, causal=causal,
                                   bk=flash.kv_tile(q.dtype, q.shape[2]))

    @contextlib.contextmanager
    def ctx():
        flash.flash_attn_bhsd = twin
        try:
            yield
        finally:
            flash.flash_attn_bhsd = saved
    return ctx()


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def state_of(params, opt) -> dict:
    return {**{f"params/{k}": p for k, p in params.items()},
            **{f"m/{k}": t for k, t in opt.m.items()},
            **{f"v/{k}": t for k, t in opt.v.items()}, "step": opt.step}


def checkpoint_round_trip(params, opt, root, result) -> None:
    """Phase 9d: one save and one restore of the full-width state (params,
    m, v: f32; the step), timed; every restored tensor equal to the saved
    one after the live tensors were moved (+1)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    free = shutil.disk_usage(root).free
    state_bytes = sum(t.numel() * t.element_size()
                      for t in state_of(params, opt).values())
    print(f"phase 9: checkpoint at full width: {state_bytes / 1e9:.3f} GB of "
          f"state; {free / 1e9:.1f} GB free on the disk under {root}")
    path = os.path.join(root, "ckpt")
    shutil.rmtree(path, ignore_errors=True)
    mgr = CheckpointManager(path, keep=1, async_save=False)
    before = {k: t.detach().clone() for k, t in state_of(params, opt).items()}
    step = int(opt.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(step, {"params": params, "opt": opt})
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(path)
    with torch.no_grad():
        for t in state_of(params, opt).values():
            t.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.restore(step, {"params": params, "opt": opt})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for k, t in state_of(params, opt).items():
        check(torch.equal(t, before[k]), f"checkpoint: {k} restored unequal")
    keys = len(mgr.meta(step)["keys"])
    shutil.rmtree(path)
    result["checkpoint"] = dict(state_bytes=state_bytes, disk_bytes=nbytes,
                                free_bytes=free, save_s=save_s,
                                restore_s=restore_s, keys=keys)
    print(f"phase 9: checkpoint save {save_s:.2f} s ({nbytes} B on disk, "
          f"{keys} keys, {nbytes / save_s / 1e9:.3g} GB/s), restore "
          f"{restore_s:.2f} s ({nbytes / restore_s / 1e9:.3g} GB/s); every "
          f"restored tensor == the saved one")


def restart_check(smoke, root, result) -> None:
    """Phase 9e: ``train_loop`` at the reduced config, TRAIN_BATCH x
    TRAIN_SEQ tokens (vocab 512: tokens repeat, so the embedding's
    backward sums duplicates), RESTART_STEPS steps, a checkpoint every
    RESTART_EVERY; with a failure injected at RESTART_FAIL its final
    parameters and optimizer state equal a run without it, bit for
    bit."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.driver import DriverConfig, train_loop
    from repro_torch.runtime.steps import make_train_step
    cfg = get_reduced_config(LM_ARCH)
    run = train_mod.run_config(LM_ARCH, RESTART_STEPS, TRAIN_SEQ,
                               remat="full")
    src = SyntheticLM(cfg=cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      seed=TRAIN_SEED, device="cuda")
    runs = []
    for name, fail in (("clean", None), ("fault", {RESTART_FAIL})):
        model, params, opt = train_mod.setup(cfg, seed=TRAIN_SEED,
                                             device="cuda")
        dcfg = DriverConfig(total_steps=RESTART_STEPS,
                            ckpt_every=RESTART_EVERY,
                            ckpt_dir=os.path.join(root, f"restart_{name}"),
                            keep=2, log_every=RESTART_STEPS)
        smoke.build.reset_launches()
        t0 = time.perf_counter()
        params, opt, hist = train_loop(make_train_step(model, run), params,
                                       opt, src, dcfg, fail_at=fail,
                                       log=lambda *_: None)
        runs.append((params, opt, hist, time.perf_counter() - t0,
                     dict(smoke.build.ROUTE_LAUNCHES)))
    (p1, o1, h1, s1, l1), (p2, o2, h2, s2, l2) = runs
    check(h1["restarts"] == 0 and h2["restarts"] == 1
          and h2["steps_run"] == RESTART_STEPS + RESTART_FAIL - RESTART_EVERY,
          f"restart: histories {h1} / {h2}")
    check(int(o1.step) == int(o2.step) == RESTART_STEPS, "restart: steps")
    diff = [k for k in p1 if not (torch.equal(p1[k], p2[k])
                                  and torch.equal(o1.m[k], o2.m[k])
                                  and torch.equal(o1.v[k], o2.v[k]))]
    check(not diff, f"restart: {len(diff)} tensors differ from the clean "
                    f"run's, first {diff[:3]}")
    check(l1["flash_attn_bhsd:simt"] > 0, f"restart: flash launches {l1}")
    result["restart"] = dict(steps=RESTART_STEPS, clean_s=s1, fault_s=s2,
                             loss=h1["loss"], launches=l1)
    print(f"phase 9: restart at the reduced config ({TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, vocab {cfg.vocab}): failure at step {RESTART_FAIL}, "
          f"restored from step {RESTART_EVERY}; {len(p1)} params and their "
          f"m, v == the clean run's bit for bit (clean {s1:.2f} s, with the "
          f"restart {s2:.2f} s; flash {l1['flash_attn_bhsd:simt']} launches "
          f"on the CUDA-core route); loss {h1['loss'][0]:.4f} -> "
          f"{h1['loss'][-1]:.4f}")
    shutil.rmtree(os.path.join(root, "restart_clean"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "restart_fault"), ignore_errors=True)


def train_phase(smoke, engine, result) -> dict:
    """Phase 9: training on the card (see the module doc).  Returns the
    flash kernel's launches on the training path, for the kernels line."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import make_source
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import DriverConfig, train_loop
    out = result["train"] = {
        "trainable_flash": trainable_flash_check(smoke)}
    cfg = get_config(LM_ARCH)
    n_flash = 2 * cfg.n_layers      # forward + the remat="full" recompute
    root = str(smoke.build.BUILD_ROOT.parent / "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, params, opt = train_mod.setup(cfg, seed=TRAIN_SEED, device="cuda")
    run = train_mod.run_config(LM_ARCH, TRAIN_STEPS, TRAIN_SEQ, remat="full")
    src = make_source(cfg, ShapeConfig("train_smoke", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), seed=TRAIN_SEED, geo=engine,
                      device="cuda")
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    # The step train_loop calls, timed and counted: every counter set to 0
    # just before a step and read just after it (the batch's geo join runs
    # before, in batch_at); the warm-up step's flash calls each held
    # against the twin as they run.
    inner = steps.make_train_step(model, run)
    rec = []

    def step(params, opt, batch):
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        t0 = time.perf_counter()
        with (smoke.capture(keep=[]) if not rec
              else contextlib.nullcontext()) as cap:
            params, opt, metrics = inner(params, opt, batch)
            loss = float(metrics["loss"])
        rec.append(dict(
            s=time.perf_counter() - t0, loss=loss, ce=float(metrics["ce"]),
            grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
            launches=dict(smoke.build.LAUNCHES),
            routes=dict(smoke.build.ROUTE_LAUNCHES),
            checked=cap and dict(cap.checked["flash_attn_bhsd"])))
        return params, opt, metrics

    dcfg = DriverConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                        ckpt_dir=os.path.join(root, "loop"), keep=1,
                        log_every=1)
    t0 = time.perf_counter()
    params, opt, hist = train_loop(step, params, opt, src, dcfg)
    out["loop_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    shutil.rmtree(os.path.join(root, "loop"))
    for i, r in enumerate(rec):
        for kname, n in r["launches"].items():
            check((n > 0) == (kname in ENGINE_KERNELS["train_step"]),
                  f"train step {i}: {kname} launched {n} times")
        check(r["launches"]["flash_attn_bhsd"] == n_flash
              and r["routes"]["flash_attn_bhsd:wgmma"] == n_flash,
              f"train step {i}: flash launches {r['routes']}, not {n_flash} "
              f"on the tensor cores")
        check(all(math.isfinite(r[k]) for k in ("loss", "grad_norm")),
              f"train step {i}: loss {r['loss']}, grad norm "
              f"{r['grad_norm']}")
    checked = rec[0]["checked"]
    check(checked["calls"] == n_flash, f"train warm-up: {checked['calls']} "
                                       f"flash calls held against the twin")
    lnv = math.log(cfg.vocab)
    check(abs(rec[0]["ce"] - lnv) < TRAIN_CE0_TOL,
          f"train: first ce {rec[0]['ce']} not near ln(V) = {lnv:.4f}")
    check(hist["loss"] == [r["loss"] for r in rec]
          and hist["loss"][-1] < hist["loss"][0] and hist["restarts"] == 0,
          f"train: losses {hist['loss']} do not fall")
    timed = [r["s"] for r in rec[1:]]
    step_s = float(np.median(timed))
    out.update(steps=rec, step_s=step_s, step_s_all=timed,
               tok_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
               flash_per_step=n_flash, params=model.param_count())
    print(f"phase 9: {cfg.name} at full width ({out['params']} params, f32 "
          f"master weights, remat full, z-loss {run.z_loss}) through "
          f"train_loop over make_train_step, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"GeoEnriched tokens ({card_line()}): losses "
          f"{[round(x, 4) for x in hist['loss']]} (ln V = {lnv:.4f}), grad "
          f"norms {[round(r['grad_norm'], 4) for r in rec]}, lr "
          f"{[r['lr'] for r in rec]}; each step launched "
          f"flash_attn_bhsd {n_flash} times, all on wgmma, and nothing else "
          f"of the eight; the warm-up's {checked['calls']} calls each == twin "
          f"(max abs err {checked['max_abs_err']:.3g}); step "
          f"{step_s * 1e3:.1f} ms (median of {timed}), "
          f"{out['tok_s']:.5g} tok/s; peak device memory "
          f"{out['peak_bytes'] / 2**30:.2f} GiB; train_loop with its two "
          f"checkpoints {out['loop_s']:.1f} s")
    batch = src.batch_at(TRAIN_STEPS)
    # Forward / backward (with the remat recompute) / optimizer on the
    # card, by CUDA events around the step's own pieces.
    loss_fn = steps.make_loss_fn(model, run)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = loss_fn(batch)
    ev[1].record()
    grads = torch.autograd.grad(loss, list(params.values()))
    ev[2].record()
    adamw.update(dict(zip(params, grads)), opt, params, run,
                 adamw.schedule(run, opt.step))
    ev[3].record()
    torch.cuda.synchronize()
    out["split_ms"] = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in
                       enumerate(("forward", "backward", "optimizer"))}
    del loss, grads
    out["profile"] = profile_busy(
        lambda: float(inner(params, opt, batch)[2]["loss"]), top=10,
        ops=True)
    p = out["profile"]
    print(f"phase 9: a step on the card: forward "
          f"{out['split_ms']['forward']:.1f} ms, backward (with the "
          f"recompute) {out['split_ms']['backward']:.1f} ms, optimizer "
          f"{out['split_ms']['optimizer']:.1f} ms; under torch.profiler: "
          f"wall {p['wall_ms']:.1f} ms, device {p['device_ms']:.1f} ms (busy "
          f"{p['busy']:.1%}), {p['launches']} launches; top kernels "
          + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in p["top"])
          + "; top operators " + "; ".join(f"{k} {ms:.1f} ms x{n}"
                                           for k, ms, n in p["ops"]))
    # The plain path: the same parameters and batch, flash's twin in the
    # kernel's place.
    grad_fn = steps.make_grad_fn(model, run)
    cmp = {}
    for name in ("kernel", "plain"):
        with (twin_flash(smoke) if name == "plain"
              else contextlib.nullcontext()):
            smoke.build.reset_launches()
            g, m = grad_fn(params, batch)
            cmp[name] = dict(loss=float(m["loss"]), ce=float(m["ce"]),
                             grad_norm=float(adamw.global_norm(g)),
                             flash=smoke.build.LAUNCHES["flash_attn_bhsd"])
            del g, m
    k, pl = cmp["kernel"], cmp["plain"]
    check(k["flash"] == n_flash and pl["flash"] == 0,
          f"train plain path: flash launches {k['flash']} / {pl['flash']}")
    check(abs(k["loss"] - pl["loss"]) <= TRAIN_LOSS_ATOL
          and abs(k["ce"] - pl["ce"]) <= TRAIN_LOSS_ATOL
          and abs(k["grad_norm"] - pl["grad_norm"])
          <= TRAIN_GNORM_RTOL * pl["grad_norm"],
          f"train: the kernel's step differs from the plain path's: {cmp}")
    out["plain_path"] = cmp
    print(f"phase 9: the step's loss / ce / grad norm on the kernel "
          f"{k['loss']:.6f} / {k['ce']:.6f} / {k['grad_norm']:.6f} vs the "
          f"plain path (flash's twin) {pl['loss']:.6f} / {pl['ce']:.6f} / "
          f"{pl['grad_norm']:.6f} (tol {TRAIN_LOSS_ATOL} abs, "
          f"{TRAIN_GNORM_RTOL} rel)")
    checkpoint_round_trip(params, opt, root, out)
    del model, params, opt, inner, loss_fn, grad_fn, src
    torch.cuda.empty_cache()
    restart_check(smoke, root, out)
    shutil.rmtree(root, ignore_errors=True)
    return {"train_step": n_flash, "train_run": sum(
        r["launches"]["flash_attn_bhsd"] for r in rec)}


class RouteLog:
    """The port's router calls inside ``record()``: ([T, k] ids, [T] gap
    between the k-th and (k+1)-th probability), on the host, in call
    order (one call a MoE layer a pass)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe = moe

    @contextlib.contextmanager
    def record(self, force=None):
        """With ``force`` (another run's calls, in order), each call routes
        as that run's did: its ids, weighted by this run's probabilities
        at them (renormalized, as the router does); the call's own choice
        is what is recorded."""
        calls, real = [], self.moe._router

        def rec(params, cfg, x2d):
            out = real(params, cfg, x2d)
            probs = torch.softmax(x2d.float() @ params["router"]["w"].float(),
                                  dim=-1)
            top = probs.topk(cfg.top_k + 1, dim=-1).values
            calls.append((out[1].cpu(), (top[:, -2] - top[:, -1]).cpu()))
            if force is None:
                return out
            ids = force[len(calls) - 1][0].to(x2d.device)
            p = probs.gather(1, ids.long())
            return p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-9), ids, \
                out[2]
        self.moe._router = rec
        try:
            yield calls
        finally:
            self.moe._router = real


def route_flips(ref_calls, calls, what) -> int:
    """The routing choices of ``calls`` that differ from ``ref_calls``'
    (the same pass in another run); each must be a near tie in the
    reference, its k-th and (k+1)-th probabilities within ROUTE_GAP.
    Returns their count."""
    check(len(ref_calls) == len(calls) > 0, f"{what}: router calls "
                                            f"{len(ref_calls)} vs {len(calls)}")
    flips = 0
    for (rids, gap), (ids, _) in zip(ref_calls, calls):
        flip = (rids.sort(-1).values != ids.sort(-1).values).any(-1)
        bad = flip & (gap >= ROUTE_GAP)
        check(not bool(bad.any()),
              f"{what}: routing differs at a clear gap (tokens "
              f"{bad.nonzero().flatten()[:5].tolist()}, gaps "
              f"{gap[bad][:5].tolist()})")
        flips += int(flip.sum())
    return flips


def moe_load(arch, layers, result_key, result):
    """``arch``'s full config cut to ``layers`` layers, on the card with
    random weights (``launch.serve.load_model``, drawn leaf by leaf)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = serve_mod.load_model(cfg, seed=MOE_SEED, device="cuda")
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    result[result_key] = dict(
        layers=layers, published_layers=get_config(arch).n_layers,
        params=model.param_count(), weight_bytes=weights,
        load_s=time.perf_counter() - t0,
        load_peak_bytes=torch.cuda.max_memory_allocated() - base)
    r = result[result_key]
    print(f"phase 10: {cfg.name} at full width, {layers} of "
          f"{r['published_layers']} layers (d {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.hd}, {cfg.n_experts} experts of {cfg.d_ff_expert} "
          f"+ {cfg.n_shared_experts} shared, top-{cfg.top_k}, vocab "
          f"{cfg.vocab}): {r['params']} params, {weights / 2**30:.2f} GiB on "
          f"the card, drawn leaf by leaf in {r['load_s']:.2f} s (peak "
          f"{r['load_peak_bytes'] / 2**30:.2f} GiB during the load)")
    return cfg, model


def moe_serve(smoke, model, shape, out, what):
    """``launch.serve.serve`` (no ``prefill``: the prompt fed token by
    token) with the counts of each phase: no kernel of the eight
    launched.  Returns the ServeResult."""
    from repro_torch.launch import serve as serve_mod
    b, s, gen = shape
    prompts = serve_mod.make_prompts(model.cfg, b, s, MOE_SEED, "cuda")
    counts = {}

    def on_phase(name, edge):
        if edge == "start":
            smoke.build.reset_launches()
        else:
            counts[name] = dict(smoke.build.LAUNCHES)

    res = serve_mod.serve(model, prompts, gen, on_phase=on_phase)
    for name, c in counts.items():
        check(not any(c.values()), f"{what} serve {name}: launches {c}")
    tok = res.tokens
    check(tok.shape == (b, gen) and bool(((tok >= 0)
                                          & (tok < model.cfg.vocab)).all())
          and bool(torch.isfinite(res.prefill_logits).all())
          and torch.equal(tok[:, 0], res.prefill_logits.argmax(-1).int()),
          f"{what} serve: tokens out of range or not the last prompt "
          f"step's argmax")
    out["serve"] = dict(batch=b, prompt=s, gen=gen,
                        prompt_tok_s=res.prefill_tok_s(),
                        decode_tok_s=res.decode_tok_s(),
                        prompt_s=res.prefill_s, decode_s=res.decode_s,
                        peak_bytes=res.peak_bytes)
    sv = out["serve"]
    print(f"phase 10: {what} through launch.serve.serve, {b} prompts of {s} "
          f"tokens fed token by token (no prefill, as repro) in "
          f"{res.prefill_s:.2f} s = {sv['prompt_tok_s']:.5g} tok/s, then "
          f"{gen - 1} greedy steps in {res.decode_s:.2f} s = "
          f"{sv['decode_tok_s']:.5g} tok/s; no kernel of the eight launched; "
          f"peak {res.peak_bytes / 2**30:.2f} GiB above the weights")
    return res


def mixtral_forward(smoke, cfg, model, faulty, out):
    """Phase 10a: ``make_prefill_step`` over MOE_BATCH x MOE_SEQ tokens
    (flash once a layer, each call against the twin and the planted
    fault), the forward's logits and aux against the plain path (flash's
    twin), then tok/s, peak memory and a profile by operator.  Returns
    the first flash call (for the timing)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    from repro_torch.runtime.steps import make_prefill_step
    run = serve_mod.run_config(MOE_SEQ)
    toks = serve_mod.make_prompts(cfg, MOE_BATCH, MOE_SEQ, MOE_SEED, "cuda")
    step = make_prefill_step(model, run)
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    with smoke.capture(keep=["flash_attn_bhsd"]) as cap:
        last = step({"tokens": toks})
        torch.cuda.synchronize()
    counts = dict(smoke.build.LAUNCHES)
    routes = dict(smoke.build.ROUTE_LAUNCHES)
    for kname, n in counts.items():
        check((n > 0) == (kname == "flash_attn_bhsd"),
              f"mixtral forward: {kname} launched {n} times")
    bhsd = (MOE_BATCH * cfg.n_heads, MOE_SEQ, cfg.hd)
    calls = cap.calls["flash_attn_bhsd"]
    check(counts["flash_attn_bhsd"] == cfg.n_layers == len(calls)
          and routes["flash_attn_bhsd:wgmma"] == cfg.n_layers
          and all(a[0].shape == bhsd and a[0].dtype == torch.bfloat16
                  for a, _, _ in calls),
          f"mixtral forward: flash launches {routes}, not {cfg.n_layers} "
          f"wgmma calls at {bhsd}")
    check(bool(torch.isfinite(last).all()) and last.shape == (MOE_BATCH,
                                                              cfg.vocab),
          "mixtral forward: last logits not finite")
    err = over = 0.0
    fault = []
    for args, kw, (o,) in calls:
        want, spread = smoke.twin("flash_attn_bhsd", args, kw)
        e, ov = flash_err(o, want, spread, "mixtral forward flash call")
        err, over = max(err, e), max(over, ov)
        fault.append(flash_over(faulty(*args), want, spread))
        del want, spread
    check(min(fault) > 1.0, f"mixtral forward: the kernel with KV tile "
                            f"{FAULT_TILE} skipped passes the flash "
                            f"tolerance on a call ({min(fault):.3g}x)")
    first = calls[:1]
    del cap, calls
    # The kernel's forward and the plain path's (flash's twin), the plain
    # path routed as the kernel's routed (its own choices recorded: each
    # that differs must be a near tie), so the two compute the same
    # function and drop the same choices.
    log = RouteLog()
    res = {}
    for name in ("kernel", "plain"):
        force = res["kernel"][3] if name == "plain" else None
        with (twin_flash(smoke) if name == "plain"
              else contextlib.nullcontext()), log.record(force) as rc, \
                torch.inference_mode():
            smoke.build.reset_launches()
            logits, aux = model.forward(run, {"tokens": toks})
            torch.cuda.synchronize()
            res[name] = (logits, int(aux["dropped"]), float(aux["lb_loss"]),
                         rc, smoke.build.LAUNCHES["flash_attn_bhsd"])
    (kl, kd, klb, krc, kn), (pl, pd, plb, prc, pn) = res["kernel"], \
        res["plain"]
    check(kn == cfg.n_layers and pn == 0,
          f"mixtral plain path: flash launches {kn} / {pn}")
    flips = route_flips(krc, prc, "mixtral kernel vs plain")
    diff = float((kl - pl).abs().max())
    check(bool(torch.isfinite(kl).all()) and diff <= LOGIT_TOL,
          f"mixtral forward: logits differ from the plain path's by {diff}")
    check(kd == pd, f"mixtral forward: dropped {kd} vs the plain path's {pd}")
    del kl, pl, res
    out["forward"] = dict(
        batch=MOE_BATCH, seq=MOE_SEQ, flash_launches=cfg.n_layers,
        flash_max_abs_err=err, flash_over=over, fault_over=fault,
        logits_vs_plain=diff, near_tie_flips=flips,
        routing_decisions=MOE_BATCH * MOE_SEQ * cfg.n_layers, dropped=kd,
        dropped_plain=pd, lb_loss=klb, lb_loss_plain=plb,
        capacity=moe.capacity_of(cfg, MOE_BATCH * MOE_SEQ))
    f = out["forward"]
    print(f"phase 10: mixtral make_prefill_step over {MOE_BATCH} x {MOE_SEQ} "
          f"tokens: flash_attn_bhsd launched {cfg.n_layers} times (one a "
          f"layer, all wgmma at {list(bhsd)}) and nothing else of the eight; "
          f"each call == twin (max abs err {err:.3g}, {over:.3g}x the "
          f"tolerance; the planted fault fails each, "
          f"{min(fault):.3g}-{max(fault):.3g}x); forward's logits within "
          f"{diff:.4g} of the plain path's (tol {LOGIT_TOL}; routed as the "
          f"kernel's, whose choice it would have made otherwise in {flips} "
          f"of {f['routing_decisions']} token-layers, all near ties, gap < "
          f"{ROUTE_GAP}); dropped {kd} (plain {pd}) of "
          f"{MOE_BATCH * MOE_SEQ * cfg.top_k} choices at capacity "
          f"{f['capacity']}; lb_loss {klb:.6f} (plain {plb:.6f})")
    # Timing: tok/s of the step, peak memory, a profile by operator.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step({"tokens": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    f["step_s"] = float(np.median(times))
    f["step_s_all"] = times
    f["tok_s"] = MOE_BATCH * MOE_SEQ / f["step_s"]
    f["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    patches = [(moe, "_router", "router"),
               (moe, "plan_routes", "dispatch: plan (sort)"),
               (moe, "slot_tables", "dispatch: slot tables"),
               (moe, "scatter_to_buckets", "dispatch: scatter"),
               (moe, "gather_from_buckets", "dispatch: gather"),
               (moe, "_expert_ffn", "expert products"),
               (ops, "flash_attn", "flash attention"),
               (model_mod, "unembed", "unembedding (f32)")]
    f["profile"] = p = profile_busy(lambda: step({"tokens": toks}), top=8,
                                    ranges=patches)
    print(f"phase 10: mixtral forward step {f['step_s'] * 1e3:.1f} ms "
          f"(median of {[round(t * 1e3, 1) for t in times]}) = "
          f"{f['tok_s']:.5g} tok/s ({card_line()}); peak "
          f"{f['peak_bytes'] / 2**30:.2f} GiB above the weights; under "
          f"torch.profiler: wall {p['wall_ms']:.1f} ms, device "
          f"{p['device_ms']:.1f} ms (busy {p['busy']:.1%}), {p['launches']} "
          f"launches; by operator "
          + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n)
                      in p["ranges"].items())
          + "; top kernels " + "; ".join(f"{k} {ms:.2f} ms x{n}"
                                         for k, ms, n in p["top"]))
    return first


def mixtral_teacher_forced(smoke, cfg, model, gen_tok, prompts, out):
    """Phase 10c: the no-drop copy (capacity_factor = E / k, so capacity
    = T and nothing drops, in decode as in the forward): decode fed the
    prompt and generated tokens one at a time, each step routed as the
    teacher-forced forward routed those positions (its own choices
    recorded: each that differs must be a near tie), against that
    forward; logits within LOGIT_TOL at every position, argmax equal
    where the forward's margin is clear."""
    from repro_torch.launch import serve as serve_mod
    full = torch.cat([prompts, gen_tok], dim=1)
    b, n = full.shape
    run = serve_mod.run_config(prompts.shape[1])
    saved = model.cfg
    model.cfg = nodrop = dataclasses.replace(
        saved, capacity_factor=saved.n_experts / saved.top_k)
    log = RouteLog()
    flips = 0
    try:
        with torch.inference_mode():
            with log.record() as fwd_calls:
                smoke.build.reset_launches()
                pred, aux = model.forward(run, {"tokens": full})
                torch.cuda.synchronize()
                fwd_flash = smoke.build.LAUNCHES["flash_attn_bhsd"]
            check(int(aux["dropped"]) == 0, "no-drop forward dropped "
                                            f"{int(aux['dropped'])}")
            cache = model.init_cache(b, n)
            dec = []
            for i in range(n):
                # Step i's rows are the forward's positions i.
                force = [(ids.reshape(b, n, -1)[:, i], gap.reshape(b, n)[:, i])
                         for ids, gap in fwd_calls]
                with log.record(force) as rc:
                    lg, cache = model.decode_step(run, full[:, i:i + 1],
                                                  cache)
                flips += route_flips(force, rc, "no-drop decode vs forward")
                dec.append(lg[:, -1])
            dec = torch.stack(dec, dim=1)
    finally:
        model.cfg = saved
    check(fwd_flash == cfg.n_layers, f"no-drop forward: {fwd_flash} flash "
                                     f"launches")
    diff = float((dec - pred).abs().max())
    check(bool(torch.isfinite(pred).all()) and diff <= LOGIT_TOL,
          f"no-drop decode: logits differ from the forward's by {diff}")
    top = pred.topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > LOGIT_TOL
    agree = dec.argmax(-1) == top.indices[..., 0]
    check(bool(agree[clear].all()), "no-drop decode: argmax differs from the "
                                    "forward's where its margin is clear")
    out["teacher_forced"] = dict(
        positions=n, decode_vs_forward=diff, near_tie_flips=flips,
        routing_decisions=b * n * cfg.n_layers,
        argmax_checked=int(clear.sum()),
        capacity_factor=nodrop.capacity_factor)
    print(f"phase 10: the no-drop copy (capacity_factor "
          f"{nodrop.capacity_factor}: capacity = T): decode over {b} x {n} "
          f"tokens, routed as the teacher-forced forward routed (whose "
          f"choice it would have made otherwise in {flips} of "
          f"{b * n * cfg.n_layers} token-layers, all near ties), within "
          f"{diff:.4g} of the forward's logits (tol {LOGIT_TOL}); argmax "
          f"equal at all {int(clear.sum())} positions whose margin > "
          f"{LOGIT_TOL}")


def deepseek_path(smoke, out):
    """Phase 10d: DeepSeek-V2 at full width, DSV2_LAYERS layers (the dense
    first one, MLA + MoE after): ``make_prefill_step`` over DSV2_BATCH x
    DSV2_SEQ tokens and the token-loop serve; no kernel of the eight
    launched (head dim 192 and MLA's dv != d are no flash instance)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime.steps import make_prefill_step
    cfg, model = moe_load(DSV2_ARCH, DSV2_LAYERS, "deepseek", out)
    r = out["deepseek"]
    run = serve_mod.run_config(DSV2_SEQ)
    toks = serve_mod.make_prompts(cfg, DSV2_BATCH, DSV2_SEQ, MOE_SEED, "cuda")
    step = make_prefill_step(model, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    smoke.build.reset_launches()
    with torch.inference_mode():
        logits, aux = model.forward(run, {"tokens": toks})
        torch.cuda.synchronize()
    check(not any(smoke.build.LAUNCHES.values()),
          f"deepseek forward: launches {dict(smoke.build.LAUNCHES)}")
    check(logits.shape == (DSV2_BATCH, DSV2_SEQ, cfg.vocab)
          and bool(torch.isfinite(logits).all())
          and math.isfinite(float(aux["lb_loss"])),
          "deepseek forward: logits or lb_loss not finite")
    r["forward_dropped"] = int(aux["dropped"])
    r["forward_lb_loss"] = float(aux["lb_loss"])
    del logits, aux
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        step({"tokens": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    r["forward_s"] = float(np.median(times))
    r["forward_tok_s"] = DSV2_BATCH * DSV2_SEQ / r["forward_s"]
    r["forward_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    print(f"phase 10: {cfg.name} forward over {DSV2_BATCH} x {DSV2_SEQ} "
          f"tokens in {r['forward_s'] * 1e3:.1f} ms = "
          f"{r['forward_tok_s']:.5g} tok/s ({card_line()}), peak "
          f"{r['forward_peak_bytes'] / 2**30:.2f} GiB above the weights; "
          f"no kernel of the eight launched; dropped {r['forward_dropped']}, "
          f"lb_loss {r['forward_lb_loss']:.6f}")
    moe_serve(smoke, model, DSV2_SERVE, r, cfg.name)
    del model, step
    torch.cuda.empty_cache()


def moe_train_check(smoke, out):
    """Phase 10e: Mixtral's reduced config trained MOE_TRAIN_STEPS steps on
    the card through ``launch.train.setup`` and ``train_loop`` over
    ``make_train_step``: the loss finite, ``lb_loss`` and ``dropped``
    reported each step."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import DriverConfig, train_loop
    cfg = get_reduced_config(MOE_ARCH)
    model, params, opt = train_mod.setup(cfg, seed=MOE_SEED, device="cuda")
    run = train_mod.run_config(MOE_ARCH, MOE_TRAIN_STEPS, MOE_TRAIN_SEQ)
    src = SyntheticLM(cfg=cfg, batch=8, seq=MOE_TRAIN_SEQ, seed=MOE_SEED,
                      device="cuda")
    inner = steps.make_train_step(model, run)
    rec = []

    def step(params, opt, batch):
        smoke.build.reset_launches()
        params, opt, m = inner(params, opt, batch)
        rec.append(dict({k: float(v) for k, v in m.items()},
                        flash=smoke.build.LAUNCHES["flash_attn_bhsd"]))
        return params, opt, m

    root = str(smoke.build.BUILD_ROOT.parent / "moe_train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    dcfg = DriverConfig(total_steps=MOE_TRAIN_STEPS,
                        ckpt_every=MOE_TRAIN_STEPS, ckpt_dir=root, keep=1,
                        log_every=1)
    _, _, hist = train_loop(step, params, opt, src, dcfg,
                            log=lambda *_: None)
    shutil.rmtree(root, ignore_errors=True)
    check(hist["steps_run"] == MOE_TRAIN_STEPS and len(rec) == MOE_TRAIN_STEPS
          and all(math.isfinite(r["loss"]) and math.isfinite(r["lb_loss"])
                  and r["flash"] == cfg.n_layers for r in rec),
          f"mixtral reduced train_loop: {rec}")
    out["train"] = rec
    print(f"phase 10: {cfg.name} through train_loop over make_train_step on "
          f"the card, {MOE_TRAIN_STEPS} steps of 8 x {MOE_TRAIN_SEQ} (S <= "
          f"window: flash's CUDA-core route at head dim {cfg.hd}): "
          + "; ".join(f"loss {r['loss']:.4f} lb_loss {r['lb_loss']:.4f} "
                      f"dropped {r['dropped']:.0f} (flash {r['flash']} "
                      f"launches)" for r in rec))


def moe_phase(smoke, result, faulty) -> dict:
    """Phase 10 (see the module doc).  Returns the flash kernel's launches
    on the Mixtral forward and its timing at that shape."""
    out = result["moe"] = {}
    cfg, model = moe_load(MOE_ARCH, MOE_LAYERS, "mixtral", out)
    first = mixtral_forward(smoke, cfg, model, faulty, out["mixtral"])
    timing = flash_row(smoke, first, cfg.n_layers, batch=MOE_BATCH,
                       path="mixtral forward")
    del first
    res = moe_serve(smoke, model, MOE_SERVE, out["mixtral"], cfg.name)
    from repro_torch.launch import serve as serve_mod
    prompts = serve_mod.make_prompts(cfg, MOE_SERVE[0], MOE_SERVE[1],
                                     MOE_SEED, "cuda")
    mixtral_teacher_forced(smoke, cfg, model, res.tokens, prompts,
                           out["mixtral"])
    del model, res
    torch.cuda.empty_cache()
    deepseek_path(smoke, out)
    moe_train_check(smoke, out)
    return {"launches": cfg.n_layers, "timing": timing}


def host_map():
    """The census and its covering at SCALE, on the host (numpy; no card).
    Returns (census, covering, census s, covering s)."""
    from repro_torch.core.cells import build_cell_covering
    from repro_torch.core.synth import build_synth_census
    t0 = time.perf_counter()
    sc = build_synth_census(**SCALE)
    t1 = time.perf_counter()
    cov = build_cell_covering(sc.census, max_level=MAX_LEVEL)
    return sc, cov, t1 - t0, time.perf_counter() - t1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on "
              "the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_s = {}
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import fast as fast_mod
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.kernels import ops

    result = {}
    # -- 1. card, toolchain, kernel build ------------------------------------
    card = card_line()
    print(card)
    nvcc = subprocess.run([os.path.join(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), "--version"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"{nvcc[-1] if nvcc else 'nvcc not found'}")
    # The host map (phase 3) needs no card: a child process builds it
    # while the card builds the kernels and runs the LM path.
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        host = pool.apply_async(host_map)
        smoke = Smoke()
        smoke.build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=smoke.build.BUILD_ROOT) as tmp:
            fault_build = start_fault_build(smoke.build, tmp)
            try:
                smoke.build.load()
            finally:
                faulty = load_fault(smoke.build, *fault_build)
        info = smoke.build.BUILD_INFO
        result["build_s"] = time.perf_counter() - t0
        print(f"kernel build: {result['build_s']:.2f} s "
              f"(cached={info['cached']}) -> {info['path']}; beside it the "
              f"flash kernel with KV tile {FAULT_TILE} skipped")
        for line in info["log"].splitlines():
            if ("Used" in line and "registers" in line) or "Compiling" in line:
                print(f"  {line.strip()}")

        phase_s["build"] = time.perf_counter() - t_start
        # -- 2. LM path -------------------------------------------------------
        main_calls, launches = {}, {}
        model, prompts, gen_tok = lm_path(smoke, result, launches,
                                          main_calls, faulty)
        flash_kernel = flash_row(smoke, main_calls["flash_attn_bhsd"],
                                 launches["flash_attn_bhsd"])
        phase_s["lm_path"] = time.perf_counter() - t_start
        # The LM's timing needs no host map: it runs while the child
        # process still builds the covering.
        lm_timing(model, prompts, gen_tok, result, card)
        del model, prompts, gen_tok
        phase_s["lm_timing"] = time.perf_counter() - t_start
        minicpm_path(smoke, result)
        flash_many_heads(smoke, result)
        phase_s["lm_faults"] = time.perf_counter() - t_start
        # -- 3. census, covering, engines -------------------------------------
        t0 = time.perf_counter()
        sc, cov, result["census_s"], result["covering_s"] = host.get()
        result["host_map_wait_s"] = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    census = sc.census
    cfg = EngineConfig(mode="exact", cap_boundary=0.5, max_level=MAX_LEVEL)
    # The cascade's caps of examples/quickstart.py.
    scfg = EngineConfig(cap_state=0.5, cap_county=0.5, cap_block=0.5,
                        max_level=MAX_LEVEL)
    specs = {
        "fast": ("fast", cfg),
        "fast_fused": ("fast", dataclasses.replace(cfg, fused=True)),
        "fast_onepass": ("fast_onepass", cfg),
        "simple": ("simple", scfg),
        "simple_fused": ("simple", dataclasses.replace(scfg, fused=True)),
        "hybrid": ("hybrid", EngineConfig(cap_boundary=0.5,
                                          max_level=MAX_LEVEL)),
    }
    t0 = time.perf_counter()
    engines = {name: GeoEngine.build(census, strategy, c, covering=cov)
               for name, (strategy, c) in specs.items()}
    torch.cuda.synchronize()
    result["engines_s"] = time.perf_counter() - t0
    result["footprint"] = engines["fast_onepass"].indices.memory_footprint()
    print(f"host build (a child process, waited for "
          f"{result['host_map_wait_s']:.2f} s after the LM path): census "
          f"{result['census_s']:.2f} s, covering "
          f"{result['covering_s']:.2f} s ({len(cov.lo)} cells, "
          f"{cov.n_boundary} boundary), {len(engines)} engines "
          f"{result['engines_s']:.2f} s; footprint {result['footprint']}")
    for name, eng in engines.items():
        check(eng.device.type == "cuda", f"{name} index not on cuda")
        print(f"  {name}: plan {eng.explain()['strategy']} "
              f"fused={eng.explain()['fused']}")
    sindex = engines["simple"].simple_index
    print(f"  simple index: state_edges {list(sindex.state_edges.shape)}, "
          f"county_edges {list(sindex.county_edges.shape)}, block_edges "
          f"{list(sindex.block_edges.shape)}, county_children "
          f"{list(sindex.county_children.shape)}, block_children "
          f"{list(sindex.block_children.shape)}")

    phase_s["host_build"] = time.perf_counter() - t_start
    # -- 4. kernel phase: each kernel vs its twin, each engine vs the CPU ---
    xy_k, truth_k, _, sid_k = sc.sample_points(np.random.default_rng(1),
                                                N_KERNEL)
    pts_k = torch.from_numpy(xy_k).cuda()
    for name, eng in engines.items():
        strategy, c = specs[name]
        cpu_ref = GeoEngine.build(census, strategy, c, covering=cov,
                                  device="cpu").assign(xy_k)
        check(float(np.mean(cpu_ref.block.numpy() == truth_k)) == 1.0,
              f"CPU twin engine {name}: accuracy below 1.0")
        with smoke.capture() as cap:
            res = eng.assign(pts_k)
        torch.cuda.synchronize()
        n_calls = smoke.check_all(cap, f"the {N_KERNEL}-point batch")
        for kname in ENGINE_KERNELS[name]:
            check(n_calls[kname] > 0, f"{name}: {kname} was not called")
        for a, b in zip((res.state, res.county, res.block),
                        (cpu_ref.state, cpu_ref.county, cpu_ref.block)):
            check(torch.equal(a.cpu(), b), f"{name} ids differ from the "
                                           f"CPU twin engine")
        check(res.stats.as_dict() == cpu_ref.stats.as_dict(),
              f"{name} stats {res.stats.as_dict()} differ from the CPU "
              f"twin engine {cpu_ref.stats.as_dict()}")
        print(f"kernel phase: {name}: "
              + ", ".join(f"{k} == twin on {n_calls[k]} call(s)"
                          for k in ENGINE_KERNELS[name])
              + f"; {name} == CPU twin engine (ids, stats)")
    with smoke.capture() as cap:
        pip_one_states(ops, sindex.state_edges, pts_k)
    torch.cuda.synchronize()
    n_calls = smoke.check_all(cap, f"the {N_KERNEL}-point batch")
    check(n_calls["crossings_one"] == sindex.state_edges.shape[0],
          "pip_one: crossings_one not called once per state")
    print(f"kernel phase: crossings_one == twin on "
          f"{n_calls['crossings_one']} call(s) (one per state table)")
    misaligned_phase(engines, pts_k)
    result["one_phase"] = one_phase(smoke, sindex, pts_k, census.extent)
    result["pool_phase"] = pool_phase(
        smoke, ops, sindex, engines["fast_fused"].fast_index, pts_k,
        torch.from_numpy(truth_k).cuda(), torch.from_numpy(sid_k).cuda())
    n_blocks = int(engines["fast"].fast_index.block_parent.shape[0])
    result["bbox_phase"] = bbox_phase(smoke, pts_k, census.extent)
    tile_rows = smoke.build.load().repro_segment_tile_rows()
    result["segment_phase"] = segment_phase(n_blocks, tile_rows)
    worst = max(r["sum_max_rel_err"] for r in result["segment_phase"]
                if r["values"] == "float")
    print(f"kernel phase: segment_reduce_sorted == twin and oracle on "
          f"{len(result['segment_phase'])} cases of {N_KERNEL} rows "
          f"(uniform, skewed 40 %, invalid parked and unparked, S = 1000, "
          f"S = 1, S = {4 * N_KERNEL}, {N_KERNEL + 3} rows, empty) and of "
          f"{SPAN_ROWS} rows (one segment over more than {SPAN_TILES} tiles of "
          f"{tile_rows} rows); integer, f32 and no values, each column also "
          f"4 bytes into a buffer (bit-equal to the aligned call): count / "
          f"min / max and integer-valued and zero-column sums exact, f32 "
          f"sums within {worst:.3g} of the f64 oracle (rtol {SUM_RTOL}), "
          f"second launch bit-equal, 1 launch without values and 2 with")

    phase_s["kernel_phase"] = time.perf_counter() - t_start
    # -- 5. main path ---------------------------------------------------------
    t0 = time.perf_counter()
    xy, truth, _, truth_sid = sc.sample_points(np.random.default_rng(0),
                                               N_MAIN)
    result["sample_s"] = time.perf_counter() - t0
    pts = torch.from_numpy(xy).cuda()
    ids, stats = {}, {}
    result["peak_bytes"], result["checked_in_flight"] = {}, {}
    for name, eng in engines.items():
        keep = [k for k, path in ROW_PATH.items() if path == name]
        torch.cuda.reset_peak_memory_stats()
        with smoke.capture(keep=keep) as cap:
            smoke.build.reset_launches()
            res = eng.assign(pts)
            torch.cuda.synchronize()
            counts = dict(smoke.build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for kname, n in counts.items():
            want = kname in ENGINE_KERNELS[name]
            check((n > 0) == want, f"{name}: {kname} launched {n} times "
                                   f"(expected {'> 0' if want else '0'})")
        for kname in keep:
            launches[kname] = counts[kname]
            main_calls[kname] = cap.calls[kname]
        # The kept calls are held against their twins in section 7.
        checked = {k: v for k, v in cap.checked.items() if v["calls"]}
        for kname, c in checked.items():
            check(c["max_abs_err"] == 0, f"{kname} differs from its twin "
                  f"(max abs err {c['max_abs_err']}) on the {name} path")
        ids[name] = (res.state, res.county, res.block)
        stats[name] = res.stats.as_dict()
        result["peak_bytes"][name] = peak
        result["checked_in_flight"][name] = checked
        acc = float(np.mean(res.block.cpu().numpy() == truth))
        check(acc == 1.0, f"{name}: accuracy {acc} != 1.0")
        launched = {k: v for k, v in counts.items() if v}
        kept = sum(call_bytes(a, o) for calls in main_calls.values()
                   for a, _, o in calls)
        print(f"main path {name}: launches {launched}, accuracy {acc}, "
              f"peak device memory {peak / 2**30:.2f} GiB (of it, "
              f"{kept / 2**30:.2f} GiB of calls kept for timing), stats "
              f"{stats[name]}")
        for kname, c in checked.items():
            print(f"  {kname} == twin as it ran: {c['calls']} call(s), "
                  f"{c['rows']} rows, {c['bytes'] / 2**30:.2f} GiB")
    blocks = {name: v[2] for name, v in ids.items()}
    check(torch.equal(blocks["fast"], blocks["fast_fused"])
          and torch.equal(blocks["fast"], blocks["fast_onepass"]),
          "the three fast paths' block ids differ")
    check(stats["fast"] == stats["fast_fused"], "fast stats differ")
    check(stats["fast"]["overflow"] == 0
          and stats["fast"]["phase2_miss"] == 0, "fast overflowed")
    for key in ("n_boundary", "n_pip"):
        check(stats["fast_onepass"][key] == stats["fast"][key],
              f"fast_onepass {key} differs")
    check(all(torch.equal(a, b) for a, b in zip(ids["hybrid"], ids["fast"])),
          "hybrid ids differ from fast's")
    check(all(torch.equal(a, b)
              for a, b in zip(ids["simple"], ids["simple_fused"])),
          "simple ids differ from simple fused's")
    check(stats["simple"] == stats["simple_fused"],
          "simple stats differ from simple fused's")
    for name in ("simple", "hybrid"):
        check(stats[name]["overflow"] == 0, f"{name} overflowed")
    result["stats"] = stats
    padded = torch.zeros(PAD_TO, 2, device="cuda")
    padded[:N_PADDED] = pts[:N_PADDED]
    for name, eng in engines.items():
        rp = eng.assign_padded(padded, N_PADDED)
        ru = eng.assign(pts[:N_PADDED])
        for a, b in zip((rp.state, rp.county, rp.block),
                        (ru.state, ru.county, ru.block)):
            check(torch.equal(a[:N_PADDED], b), f"{name} padded ids differ")
            check(bool((a[N_PADDED:] == -1).all()),
                  f"{name} pad rows not -1")
        check(rp.stats.as_dict() == ru.stats.as_dict(),
              f"{name} padded stats differ")
    print(f"assign_padded: {N_PADDED} rows padded to {PAD_TO}: pad rows -1, "
          f"stats equal, on all {len(engines)} paths")
    # ops.pip_one: every point against each state's edge table.
    with smoke.capture() as cap:
        smoke.build.reset_launches()
        inside = pip_one_states(ops, sindex.state_edges, pts)
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
    check(counts["crossings_one"] == sindex.state_edges.shape[0]
          and sum(counts.values()) == counts["crossings_one"],
          f"pip_one: unexpected launches {counts}")
    launches["crossings_one"] = counts["crossings_one"]
    main_calls["crossings_one"] = cap.calls["crossings_one"]
    pip_sid = torch.where(inside.any(0), inside.int().argmax(0), -1)
    share = float(np.mean(pip_sid.cpu().numpy() == truth_sid))
    result["pip_one_state_share"] = share
    print(f"main path pip_one: launches {counts['crossings_one']} "
          f"(crossings_one), {N_MAIN} points x "
          f"{sindex.state_edges.shape[0]} state tables; share of points "
          f"whose inside-state is the true state: {share}")

    phase_s["main_path"] = time.perf_counter() - t_start
    # -- 5b. analytics path --------------------------------------------------
    from repro_torch.analytics import AnalyticsConfig, BlockAggregator
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels import segment as segment_mod
    agg = BlockAggregator.from_engine(engines["fast"])
    check(agg.n_blocks == n_blocks, "aggregator block count")
    with smoke.capture(keep=["segment_reduce_sorted"]) as cap:
        smoke.build.reset_launches()
        fused = agg.fused_counts(pts)
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["fused_counts"]
        check((n > 0) == want, f"fused_counts: {kname} launched {n} times")
    check(counts["segment_reduce_sorted"] == 1,
          "fused_counts: segment_reduce_sorted not launched exactly once")
    for kname, c in cap.checked.items():
        check(c["max_abs_err"] == 0, f"{kname} differs from its twin on "
                                     f"the fused_counts path")
    launches["segment_reduce_sorted"] = counts["segment_reduce_sorted"]
    main_calls["segment_reduce_sorted"] = cap.calls["segment_reduce_sorted"]
    bid_np = blocks["fast"].cpu().numpy()
    expect = np.bincount(bid_np[bid_np >= 0], minlength=n_blocks)
    check(np.array_equal(fused, expect),
          "fused_counts differs from np.bincount of the assigned ids")
    vals_np = np.random.default_rng(4).integers(-50, 50, N_MAIN).astype(
        np.float32)
    vals = torch.from_numpy(vals_np).cuda()
    smoke.build.reset_launches()
    red = agg.reduce(blocks["fast"], vals)
    torch.cuda.synchronize()
    check(smoke.build.LAUNCHES["segment_reduce_sorted"] == 2,
          f"BlockAggregator.reduce: segment_reduce_sorted launched "
          f"{smoke.build.LAUNCHES['segment_reduce_sorted']} times, not 2")
    oracle = ref_mod.np_segment_reduce(bid_np, vals_np, n_blocks)
    for out, got, want in zip(("count", "sum", "min", "max"), red, oracle):
        check(np.array_equal(got.cpu().numpy(), want),
              f"BlockAggregator.reduce {out} differs from the numpy oracle")
    oidx = engines["fast_onepass"].fast_index
    agg_red, raw = ops.assign_aggregate(
        pts, oidx.quant, oidx.cell_lo, oidx.cell_hi, oidx.cell_val,
        oidx.top_start, oidx.cand, oidx.block_bbox, oidx.edge_pool,
        n_segments=n_blocks, max_level=oidx.max_level, gbits=oidx.gbits,
        search_iters=oidx.search_iters, values=vals)
    check(torch.equal(raw[0], blocks["fast_onepass"]),
          "assign_aggregate's cascade ids differ from fast_onepass's")
    again = ops.segment_reduce(raw[0], vals, n_segments=n_blocks)
    check(all(torch.equal(a, b) for a, b in zip(agg_red, again)),
          "assign_aggregate differs from segment_reduce of its cascade ids")
    check(all(np.array_equal(a.cpu().numpy(), b)
              for a, b in zip(agg_red, oracle)),
          "assign_aggregate differs from the numpy oracle")
    result["fused_counts_active_blocks"] = int((fused > 0).sum())
    print(f"main path fused_counts: launches "
          f"{ {k: v for k, v in counts.items() if v} }; counts == "
          f"np.bincount of fast's ids on {N_MAIN} points "
          f"({result['fused_counts_active_blocks']} of {n_blocks} blocks "
          f"hit); reduce(ids, integer-valued column) == np_segment_reduce; "
          f"assign_aggregate(fast_onepass index) == segment_reduce of its "
          f"cascade ids == oracle")

    phase_s["analytics"] = time.perf_counter() - t_start
    # -- 6. serving path -----------------------------------------------------
    from repro_torch.obs import Tracer
    from repro_torch.serving import GeoServer, ServeConfig
    from repro_torch.serving import server as server_mod
    rng = np.random.default_rng(11)
    xy_s, bid_s, *_ = sc.sample_points(rng, 40_000)
    venue = int(np.bincount(bid_s[bid_s >= 0]).argmax())
    venue_pts = xy_s[bid_s == venue]
    stream, off = [], 0
    for second in range(SERVE_SECONDS):
        req = xy_s[off:off + SERVE_BACKGROUND]
        off += len(req)
        if len(venue_pts) and second >= 4:
            req = np.concatenate([req, venue_pts[rng.integers(
                0, len(venue_pts), SERVE_VENUE)]])
        stream.append((float(second), req))
    stream.append((SERVE_TAIL_T, xy_s[:1]))
    now = [0.0]

    def make_server(engine, cache, tracer=None, cls=GeoServer, **kw):
        return cls(engine, ServeConfig(
            buckets=SERVE_BUCKETS, cache=cache, analytics=AnalyticsConfig(
                window_s=8.0, slide_s=2.0, k_anon=5, sketch_bits=2048,
                clock=lambda: now[0])), tracer=tracer, **kw)

    def replay(server):
        # Every replay stamps the same request sequence (the analytics
        # source ids), so the distinct-source sketches can be compared.
        server_mod._Ticket._seq = itertools.count()
        out = []
        for ts, req in stream:
            now[0] = ts
            out.append(server.submit(req))
        return out

    tracer = Tracer(sample_rate=1.0)
    srv = make_server(engines["fast"], True, tracer)
    warm_s = srv.warm()
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    served = replay(srv)
    torch.cuda.synchronize()
    result["serve_stream_s"] = time.perf_counter() - t0
    counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["serving"]
        check((n > 0) == want, f"serving: {kname} launched {n} times")
    for (_, req), res in zip(stream, served):
        direct = engines["fast"].assign(req)
        for field in ("state", "county", "block"):
            check(np.array_equal(getattr(res, field),
                                 getattr(direct, field).cpu().numpy()),
                  f"served {field} ids differ from a direct assign")
    served_off = replay(make_server(engines["fast"], False))
    for a, b in zip(served, served_off):
        check(all(np.array_equal(getattr(a, f), getattr(b, f))
                  for f in ("state", "county", "block", "region")),
              "served ids differ with the hot-cell cache off")
    cpu_engine = GeoEngine.build(census, "fast", cfg, covering=cov,
                                 device="cpu")
    cpu_srv = make_server(cpu_engine, True)
    served_cpu = replay(cpu_srv)
    snap = srv.snapshot_analytics()
    check(snap == cpu_srv.snapshot_analytics(),
          "the card server's analytics snapshot differs from the CPU "
          "server's")
    for a, b in zip(served, served_cpu):
        check(np.array_equal(a.block, b.block),
              "served ids differ from the CPU server's")
    region = snap["regions"][0]
    check(region["observed"] == sum(len(r) for _, r in stream),
          "analytics observed count")
    check(region["finalized_total"] > 0, "no analytics window finalized")
    # The busiest window holds 8 requests (8 distinct sources): the venue
    # passes k_anon = 5 there and must top it.
    busiest = max(region["finalized"], key=lambda w: w["n_events"])
    check(busiest["top"] and busiest["top"][0]["block"] == venue,
          "the venue block does not top the busiest finalized window")
    text = srv.metrics_text()
    for stage in SERVE_STAGES:
        check(f'stage_latency_seconds_count{{stage="{stage}"}}' in text,
              f"metrics_text has no {stage} histogram")
    names = {sp.name for sp in tracer.buffer.snapshot()}
    check(SPAN_NAMES <= names, f"spans missing: {SPAN_NAMES - names}")
    result["serve_stream"] = dict(
        requests=len(stream), points=sum(len(r) for _, r in stream),
        warm_s=warm_s, finalized=region["finalized_total"],
        cache=srv.cache_snapshot(), spans=len(tracer.buffer))
    print(f"serving path: {len(stream)} requests "
          f"({result['serve_stream']['points']} points) in "
          f"{result['serve_stream_s']:.3f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }; ids == direct "
          f"assign, cache on == off, analytics snapshot == CPU server's "
          f"({region['finalized_total']} windows finalized, venue block "
          f"{venue} tops the busiest, [{busiest['start']}, "
          f"{busiest['end']}), with {busiest['top'][0]['count']} points); "
          f"spans {sorted(names)}; cache hit rate "
          f"{srv.cache_snapshot()['hit_rate']:.3f}")
    load = make_server(engines["fast"], True)
    load.warm()
    reqs = xy[:LOAD_REQUESTS * LOAD_POINTS].reshape(LOAD_REQUESTS,
                                                    LOAD_POINTS, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        now[0] = 100.0 + 0.05 * i
        load.submit(req)
    load_s = time.perf_counter() - t0
    lat = load.metrics.latency.snapshot_ms()
    stages = load.metrics.snapshot()["stages"]
    result["serve_load"] = dict(
        requests=LOAD_REQUESTS, points_per_request=LOAD_POINTS,
        seconds=load_s, pts_per_s=LOAD_REQUESTS * LOAD_POINTS / load_s,
        latency_ms=lat, stage_p50_ms={k: v["p50"] for k, v in stages.items()},
        cache=load.cache_snapshot())
    print(f"serving load: {LOAD_REQUESTS} requests x {LOAD_POINTS} points "
          f"in {load_s:.3f} s = {result['serve_load']['pts_per_s']:.4g} "
          f"pts/s; request latency p50 {lat['p50']:.3f} ms, p99 "
          f"{lat['p99']:.3f} ms; stage p50 ms "
          f"{ {k: round(v, 3) for k, v in result['serve_load']['stage_p50_ms'].items()} }"
          f"; cache hit rate {load.cache_snapshot()['hit_rate']:.3f}")

    phase_s["serving"] = time.perf_counter() - t_start
    # -- 7. timing ------------------------------------------------------------
    result["pts_per_s"], result["batch_device_ms"] = {}, {}
    for name, eng in engines.items():
        ts, dev = [], []
        for _ in range(TIMED_BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            eng.assign(pts)
            end.record()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            dev.append(start.elapsed_time(end))
        result["pts_per_s"][name] = N_MAIN / float(np.median(ts))
        result["batch_device_ms"][name] = float(np.median(dev))
        print(f"{name}: {result['pts_per_s'][name]:.4g} pts/s (median of "
              f"{TIMED_BATCHES} batches of {N_MAIN}: host "
              f"{[round(t * 1e3, 3) for t in ts]} ms, CUDA events "
              f"{[round(t, 3) for t in dev]} ms)")
    # fused_counts end to end (host clock, synced by the counts' copy to
    # the host) and its parts on the card (CUDA events).
    ts = []
    for _ in range(TIMED_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg.fused_counts(pts)
        ts.append(time.perf_counter() - t0)
    parked = agg.fused_ids(pts)
    split = {
        "assign": cuda_ms(lambda: engines["fast"].assign(pts), 2),
        "fused_ids": cuda_ms(lambda: agg.fused_ids(pts), 2),
        "sort": cuda_ms(lambda: torch.sort(parked, stable=True),
                        KERNEL_REPS),
        "segment_counts": cuda_ms(lambda: ops.segment_counts(
            parked, n_segments=n_blocks), KERNEL_REPS),
    }
    sk_rng = np.random.default_rng(5)
    skewed = torch.where(torch.from_numpy(sk_rng.random(N_MAIN) < 0.4).cuda(),
                         venue, parked)
    skewed_sorted = torch.sort(skewed, stable=True)[0]
    zeros = torch.zeros(N_MAIN, device="cuda")
    # What reading a value column costs: the kernel on a zero column read
    # from memory against the main path's call, which reads none; their
    # outputs must be equal.
    parked_sorted = torch.sort(parked, stable=True)[0]
    read = segment_mod.segment_reduce_sorted(parked_sorted, zeros, n_blocks)
    unread = segment_mod.segment_reduce_sorted(parked_sorted, None, n_blocks)
    check(all(torch.equal(a, b) for a, b in zip(read, unread)),
          "segment_reduce_sorted: a zero column read differs from none")
    split["kernel_zero_column_read"] = cuda_ms(
        lambda: segment_mod.segment_reduce_sorted(parked_sorted, zeros,
                                                  n_blocks), KERNEL_REPS)
    split["kernel_no_values"] = cuda_ms(
        lambda: segment_mod.segment_reduce_sorted(parked_sorted, None,
                                                  n_blocks), KERNEL_REPS)
    sk_out = segment_mod.segment_reduce_sorted(skewed_sorted, zeros, n_blocks)
    sk_twin = ref_mod.segment_reduce(skewed_sorted, zeros, n_blocks)
    check(max(max_abs_err(a, b, "skewed") for a, b in zip(sk_out, sk_twin))
          == 0, "segment_reduce_sorted differs from its twin on the skewed "
                "2^24 rows")
    split["kernel_skewed"] = cuda_ms(lambda: segment_mod.segment_reduce_sorted(
        skewed_sorted, zeros, n_blocks), KERNEL_REPS)
    hot = int(sk_out[0][venue])
    result["fused_counts"] = dict(
        pts_per_s=N_MAIN / float(np.median(ts)),
        host_ms=[t * 1e3 for t in ts], device_ms=split,
        skewed_hot_rows=hot)
    print(f"fused_counts: {result['fused_counts']['pts_per_s']:.4g} pts/s "
          f"(median of {TIMED_BATCHES} batches of {N_MAIN}: host "
          f"{[round(t * 1e3, 3) for t in ts]} ms); on the card: assign "
          f"{split['assign']:.3f} ms, assign + park {split['fused_ids']:.3f}"
          f" ms, stable sort {split['sort']:.4f} ms (glue), segment_counts "
          f"(park + sort + kernel + normalize) {split['segment_counts']:.4f}"
          f" ms; kernel without values (the counts path) "
          f"{split['kernel_no_values']:.4f} ms, with a zero column read "
          f"{split['kernel_zero_column_read']:.4f} ms, with a zero column "
          f"on skewed ids ({hot} of {N_MAIN} rows in block {venue}) "
          f"{split['kernel_skewed']:.4f} ms")
    phase_s["geo_timing"] = time.perf_counter() - t_start
    kernels = []
    index = engines["fast_onepass"].fast_index
    # The least time a launch shows by the same clock: an empty kernel (a
    # spin of 0 cycles), timed as the kernels are.
    result["launch_floor_ms"] = floor = cuda_ms(
        lambda: torch.cuda._sleep(0), KERNEL_REPS)
    for kname in KERNELS:
        if kname == "flash_attn_bhsd":
            continue
        calls = main_calls[kname]
        err = smoke.compare(kname, calls)
        check(err == 0, f"{kname} differs from its twin at the main "
                        f"path's inputs (max abs err {err})")
        fn = getattr(smoke.modules[kname], kname)
        ms = cuda_ms(lambda: [fn(*a, **kw) for a, kw, _ in calls],
                     KERNEL_REPS)
        plain = cuda_ms(lambda: [smoke.twin(kname, a, kw)
                                 for a, kw, _ in calls], 2)
        bound, bound_by, nbytes, n_ops = bound_ms(kname, calls, index,
                                                  fast_mod)
        rows = sum(a[0].shape[0] for a, _, _ in calls)
        library, extra = None, ""
        if kname == "segment_reduce_sorted":
            # torch.bincount computes the counts-only call's counts (its
            # parked segment S lands in one more bin); timed, never called
            # by the port.
            (ids_s, _, n_seg), _, (count, *_) = calls[0]
            check(torch.equal(torch.bincount(ids_s, minlength=n_seg)[:n_seg]
                              .int(), count.int()),
                  "torch.bincount differs from the segment kernel's counts")
            library = cuda_ms(lambda: torch.bincount(ids_s, minlength=n_seg),
                              KERNEL_REPS)
            extra = (f"; torch.bincount {library:.4f} ms; an empty kernel "
                     f"{floor:.4f} ms; with a value column (2 launches) "
                     f"{split['kernel_zero_column_read']:.4f} ms")
        elif kname == "crossings_candidates":
            result["candidate_rows"] = candidate_rows(calls)
            extra = "; rows a call " + ", ".join(
                f"{c['rows']} ({c['with_candidate']} with a candidate, "
                f"{c['alias_rows']} at the padding slots' alias point)"
                for c in result["candidate_rows"])
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library})
        print(f"{kname}: {ms:.4f} ms per batch on the {ROW_PATH[kname]} "
              f"path ({len(calls)} call(s), {rows} rows) vs plain twin "
              f"{plain:.3f} ms; bound {bound:.4f} ms by {bound_by} "
              f"({nbytes} B, {n_ops} ops); {bound / ms:.1%} of bound{extra}")
    # bbox_mask at a second width: the main path's points against the
    # first BBOX_WIDE county boxes.
    bm = smoke.modules["bbox_mask"].bbox_mask
    wide = sindex.county_bbox[:BBOX_WIDE].contiguous()
    wide_call = ((pts, wide), {}, (bm(pts, wide),))
    err = smoke.compare("bbox_mask", [wide_call])
    check(err == 0, f"bbox_mask differs from its twin at {BBOX_WIDE} boxes "
                    f"(max abs err {err})")
    wide_ms = cuda_ms(lambda: bm(pts, wide), KERNEL_REPS)
    bound, bound_by, nbytes, _ = bound_ms("bbox_mask", [wide_call], index,
                                          fast_mod)
    del wide_call
    result["bbox_wide"] = dict(boxes=BBOX_WIDE, rows=N_MAIN, ms=wide_ms,
                               bound_ms=bound, bound_by=bound_by)
    print(f"bbox_mask at [{N_MAIN}, {BBOX_WIDE}] (county boxes): "
          f"{wide_ms:.4f} ms vs bound {bound:.4f} ms by {bound_by} "
          f"({nbytes} B); {bound / wide_ms:.1%} of bound")
    result["cascade_batches"] = cascade_batches(
        smoke, main_calls["assign_cascade"][0], census.extent,
        next(k["ms"] for k in kernels if k["name"] == "assign_cascade"))
    phase_s["kernel_timing"] = time.perf_counter() - t_start
    # The kept calls are timed: free them before the deployment paths.
    main_calls.clear()
    torch.cuda.empty_cache()
    # -- 8. deployment paths ---------------------------------------------------
    cold_start_phase(smoke, engines, census, cov, cfg, xy, pts, result)
    phase_s["cold_start"] = time.perf_counter() - t_start
    async_phase(smoke, engines["fast"], make_server, replay, stream, now,
                served, snap, ids["fast"], reqs, result)
    phase_s["async_serving"] = time.perf_counter() - t_start
    pipeline_phase(smoke, engines["fast"], cpu_engine, pts, ids["fast"],
                   result)
    phase_s["pipeline"] = time.perf_counter() - t_start
    # -- 9. training -----------------------------------------------------------
    torch.cuda.empty_cache()
    train_launches = train_phase(smoke, engines["fast"], result)
    phase_s["train"] = time.perf_counter() - t_start
    # -- 10. the MoE family ----------------------------------------------------
    torch.cuda.empty_cache()
    moe = moe_phase(smoke, result, faulty)
    phase_s["moe"] = time.perf_counter() - t_start
    # Flash's launches: the training run (and, by path, the prefill's, a
    # training step's and the Mixtral forward's); its time at the Mixtral
    # forward's shape beside the prefill's.
    flash_kernel["launches_by_path"] = {
        "lm_prefill": flash_kernel["launches"], **train_launches,
        "moe_forward": moe["launches"]}
    flash_kernel["launches"] = train_launches["train_run"]
    flash_kernel["moe_forward_shape"] = {
        k: moe["timing"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
    kernels.append(flash_kernel)
    result["kernels"] = kernels
    result["card"] = card
    result["total_s"] = phase_s["moe"]
    result["phase_end_s"] = phase_s
    print(f"smoke ran {result['total_s']:.1f} s; each phase ended at "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} } s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("kernels: " + ", ".join(sorted(k["name"] for k in kernels)))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
