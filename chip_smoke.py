#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then
drives these paths, each with the kernels' launch counts set to 0 just
before it and read just after:

1. the main path at full width: a 2-D exponential covariance (N = 32768,
   tile 512) built on the card, ``TLROperator.compress`` (batched SVD, no
   rank may reach r_max) -> ``cholesky`` (left-looking dynamic ARA, the
   default ``batching="auto"``, whose decision it logs) -> solve / logdet
   / sample / matvec, gated on the randomized factor residual
   ``||K z - L (L^T z)|| / ||K z|| <= 100 eps``; then the same compressed
   operator factored with the other ``batching`` value under the same
   gate, so that flat and rank-bucketed batching both run (each logs its
   ranks, the gather widths wA / wL and projection widths wQ of the ranked
   run, and its launches per shape);
2. the rounding pass on the same operator: ``op.round(1e-6)`` flat and
   ranked (batched QR of the factors, SVD of the cores; per rank bucket
   when ranked), each gated on no rank rising and the rounded matvec
   within 1e-5 of ``K x``;
3. the right-looking driver: the same covariance at N = 8192, tile 128,
   ``cholesky`` and ``ldlt`` with ``algo="right"``, flat and ranked,
   gated on the same residual and finite solves; it logs flushes, append
   widths, peak memory, ``small_svd``'s launches per (T, m, n),
   ``batched_qr``'s per (T, b, r) and ``batched_gemm``'s per (T, m, k, n)
   with their mean live rank and, timed apart, launches x kernel ms
   against the bound per shape;
4. the fractional-diffusion PCG path (paper section 6.2): the 3-D
   operator at N = 16384, tile 512 built on the card, compressed at 1e-10,
   ``tlr_add_diag(op.A, eps)`` factored by the left-looking Cholesky at
   eps = 1e-2 and 1e-4, each used by ``pcg`` as the preconditioner of the
   compressed operator, then unpreconditioned ``pcg`` (the sampling
   kernels' launches per shape are then timed apart, launches x kernel ms
   against launches x bound ms, summed over all shapes and over those past
   width 128 beside the factorizations' seconds); gated on the final
   relative residual (< 1e-6), ``||K x - b|| / ||b|| < 1e-5`` against the
   dense K, and fewer iterations at 1e-2 than without, no more at 1e-4;
5. the Newton-Schulz path: the same generator at N = 8192, tile 128,
   ``tlr_newton_schulz`` (norm scaling, eps 1e-8) after 4 and 8
   iterations, and ranked after 8; gated on fewer PCG iterations than
   plain CG, the residual, ranked within 1e-8 of flat, and one
   ``op.compose(op, 1e-8)`` within 1e-6 of the dense ``K @ K``;
6. inter-tile pivoting (Algorithm 9) on the main path's compressed operator:
   the left Cholesky with ``pivot="frobenius"`` and ``pivot="power"``,
   gated on the randomized residual of ``P K P^T`` (100 eps) and a finite
   solve, logging the pivot sequence and the time against the unpivoted
   factorization; then ``check=True`` on the default left Cholesky, gated
   within 1e-12 of the unchecked factor with no health event (its bitwise
   status and the clean-path overhead logged);
7. the right driver's lookahead schedule on the right path's operator:
   Cholesky and LDL^T, flat and ranked, each after the sequential run of
   the same options, gated within 1e-12 of it, on the right phase's
   residual, a finite solve and the second CUDA stream, logging both times,
   the bitwise status, peak memory, flushes, append widths and the first
   stages of the order;
8. the fault matrix of tests/test_health.py on the same operator with
   ``check=True``: an indefinite diagonal tile near the end recovers (left,
   right, right with lookahead; at column 2 the right driver must end with
   finite factors or a breakdown), a rank spike under ``r_max_out``
   recovers on the left and is accepted on the right, a NaN diagonal tile
   and a NaN panel raise ``FactorizationBreakdown`` with the expected
   reason and column (left, right).
9. the TLR inference server (``repro_torch.serve``), twice, on residents
   the paths above already built (no further compression): the main
   path's factor with its operator, ``fact.serve(operator=op, slots=8,
   check_every=4)``, draining 64 requests that cycle through solve /
   logdet / sample / pcg_solve (one solve column poisoned by a
   ``serve.solve`` fault), gated on each solve within 1e-10 of
   ``fact.solve``, each sample within 1e-10 of ``fact.sample(z=draw)``,
   logdet equal to the memoized value, each pcg_solve at ``||K x - b|| /
   ||b|| < 1e-5``, the poisoned request a ``nonfinite_result``; and
   path 4's operator with its eps = 1e-2 Cholesky as preconditioner
   (factored again once path 4's counts are read, so that no earlier
   phase holds two factors at once), draining 16 pcg_solve requests (tol 1e-6) through 8 slots, gated on
   convergence, the residual against K, the first two within 2 iterations
   of scalar ``pcg`` and occupancy >= 0.8. Both gate on every request
   completing once and on no new dispatch shape after warmup
   (``trace_counts_diff``), and log warmup seconds, ticks, occupancy,
   requests/s, p50 / p99 per kind, peak memory, the kernels' launches
   during the drain (none: the read paths are stock torch products) and
   whether batched and sequential results agree bit for bit;
10. the telemetry layer (``repro_torch.obs``) on residents the paths above
    built: the main path's left Cholesky with telemetry off and on (the
    factor, the launches and the dispatch shapes unchanged, ``chol.diag``
    / ``chol.panel`` once a column, the enabled run within 1.25x + 0.1 s),
    its Chrome trace held to the schema check of tests/test_obs.py, the
    same run under torch.profiler (every ``lr_sample`` and ``tile_chain``
    kernel launched inside a ``chol.panel`` user range; device ms per span
    name logged), the serve cov2d-32k drain recorded (a ``serve.tick`` span
    and an ``occupancy`` sample a tick, no kernel launch), and the ranked
    right Cholesky, sequential and with lookahead, and the flat one on path
    3's operator (its spans, one ``chol.flush`` per flush, the factor
    bitwise as with telemetry off); it logs the cost of a disabled span;
11. mixed-precision storage (the paper's section 7) on path 3's K:
    ``TLROperator.compress(..., store_dtype=torch.float32)``, gated on half
    the logical low-rank bytes, the matvec within 1e-4 of ``K x`` and the
    default left Cholesky at eps 1e-5 (residual 100 eps, solve error
    1e-2), its kernels running in f64 on the promoted factors;
12. the right driver on a tile mesh of two ranks on path 3's operator
    (``core.set_tile_mesh``; each rank holds half the accumulators, the
    panels gather their column across the ranks): NCCL with one rank per
    card, or gloo with both ranks on one card; the flat and ranked
    Cholesky and the ranked one with lookahead, each gated on every rank
    equal to rank 0 bit for bit, rank 0 within 1e-12 of the single-device
    factor, the residual gate, a finite solve and half the accumulator
    bytes a rank, logging each rank's seconds, peak memory and launches;
13. the dense LM path at qwen1.5-0.5b's full width (``lm_phase``): the
    ``Trainer`` on the card at batch 8 x 1024 (AdamW's defaults, keep 1):
    8 steps (finite losses, the last below the first), 4 steps whose
    checkpoint restores bitwise, a resume of those to 8 steps (at step 4,
    each loss within 2e-2 of the 8-step run's) and 2 steps with rank-8
    gradient compression (ratio > 1, only the 2-D leaves compressed), each
    putting back the signal handlers it installed; then
    ``DecodeServer(slots=4, max_len=256)`` on the trained parameters (8
    greedy requests of 16 tokens, each completing once, a second server
    giving the same tokens, the decode step's logits within 5e-2 of
    ``prefill``'s); then TLR-KFAC on a least-squares problem of qwen's down
    projection's shape (2816 inputs, 1024 outputs, tile 32: the left
    Cholesky of the curvature factor launches the three sampling kernels),
    gated on beating AdamW, on 0.2 x its first loss and on each refresh's
    factor residual (100 eps_tlr).
14. the other model families at their published widths
    (``families_phase``): mamba2-130m (8 x 1024 tokens a step),
    whisper-large-v3 (4 x 1024 and 256 frames) and granite-moe-3b-a800m
    (4 x 1024) at full depth, each 4 AdamW steps (bf16, remat; finite
    losses, the last below the first), mamba2's also as 2 steps, a
    checkpoint and 2 resumed through ``Trainer.run`` (its losses the
    straight run's bit for bit), each then served as path 13 serves;
    jamba-v0.1-52b, llama-3.2-vision-90b and llama4-maverick-400b-a17b at
    one pattern repeat: a prefill of 2 x 1024 tokens (1600 patches for
    the VLM) and 8 decode ticks. In every family the decode step fed a
    16-token prompt ends within 5e-2 of ``prefill``'s logits (cross caches
    filled from the context; MoE at a capacity that drops nothing, and in
    float32 on the same weights where bf16 routing differs between the
    two); one granite and one llama4 MoE layer match a dense top-k oracle.
    No kernel of the port is on this path.
15. model sharding and the dry run (``model_sharding_phase``): in a
    subprocess on the host, the dry run's cells qwen1.5-0.5b x train_4k
    and granite-moe-3b-a800m x train_4k on a (16, 16) (data, model) mesh
    of 256 fake ranks and mamba2-130m x decode_32k on (2, 16, 16) of 512
    (``launch/dryrun.run_cell``, a CUDA-typed mesh, full width, one
    pattern repeat), gated on a rank's FLOPs and peak within
    ``rank_bounds`` of the unsharded step's, rank 0's parameter bytes
    equal to what the placements imply and collectives > 0, logging peak
    and FLOPs per rank, collective bytes by op and link and the roofline
    estimate; beside them, on the card, qwen1.5-0.5b at full width on two
    gloo ranks sharing cuda:0, a (1, 2) (data, model) mesh with parameters
    placed by ``params_shardings`` and the hook installed: one AdamW step
    of 8 x 1024 tokens in float32 (loss within 1e-4 of one device's, each
    parameter's update within 1e-3 of the norm of one device's and 0.1 lr
    of it everywhere), 8 greedy ticks of 8 sequences in float32 (the
    tokens one device's) and 8 in bf16 fed one device's tokens (logits
    within 5e-2 of the largest). No kernel of the port is on this path.

Then it holds each kernel against its plain PyTorch version on the card
(f64, f32 and bf16; f64 and f32 for the QR and SVD) at the paths' shapes
(``lr_sample`` at each of the main path's column buckets, ``batched_gemm``
at the right driver's and the rounding pass's shapes and with garbage past
each rank, ``small_svd`` and
``batched_qr`` at the right driver's panel shapes, ``small_svd`` on a
spectrum whose unsorted factors must match the plain version's rotations,
``batched_qr`` on graded tiles like the right driver's densified ones under
the QR contract), checks that each gate rejects a planted fault and that
two kernel calls agree bit for bit, and checks a small end-to-end run on
the card against the same run on the CPU (flat and ranked; and both
fractional-diffusion preconditioners at n = 512, tile 64; and each of
path 14's six families at smoke size in float32: loss, gradients, prefill
and decode logits). The kernels
are also held at the rank-bucket widths of ranked batching (width 1 to
128, zero-tile count padding), at each kernel's widest bucket on its
ranked path, at each kernel's widest shape on the two
fractional-diffusion paths and at the sampling kernels' widest tile-32
shape on the TLR-KFAC path; the two sampling kernels also in f64 at widths
129, 256, 384 and 512 (their tensor-core kernels past r = 128), at b = 512
and ragged. Kernel times are CUDA events
over back-to-back calls; a sampling kernel's case under DISPATCH_MS is
also timed from a CUDA graph (``graph_ms`` and its kin beside ``ms``),
since the host's dispatch sets the pace of back-to-back calls there.

Run from the root of a checkout:  python3 chip_smoke.py
(``--n`` cuts the main path's size for a quick look;
``--profile DIR`` adds torch.profiler tables of the left-looking and the
right-looking Cholesky, the fractional-diffusion Cholesky at eps 1e-2 and
the 8-iteration Newton-Schulz build.)

Exits non-zero, printing no result, without a CUDA card or outside a
checkout. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): FP64 tensor core 67 TFLOP/s,
# FP32 67 TFLOP/s outside the tensor cores (TF32 is off), BF16 989 TFLOP/s;
# HBM3 3.35 TB/s.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# The main path's configuration: tile 512, compression at eps 1e-8 with
# ranks up to R_MAX, factorization at EPS.
TILE, R_MAX, EPS = 512, 128, 1e-6
# The right-looking path's configuration: N = 8192 at tile 128 (the
# right-looking benchmark's, benchmarks/bench_tlr.py:312; nb = 64, the main
# path's 2016 tiles), r_max 128, same eps.
N_RIGHT, TILE_RIGHT = 8192, 128
# The fractional-diffusion PCG path (paper section 6.2, Figs. 9/10): the 3-D
# operator of ``fractional_diffusion_problem`` at N = 16384 (the full 32^3
# grid, N = 32768, whose compression took 218 s, was halved to make room in
# the smoke's time limit; the paper's N = 2^17 needs a 137 GB dense K),
# s = 0.75, tile 512, compressed at 1e-10 with r_max = tile; PCG to 1e-6
# preconditioned by the TLR Cholesky of K + eps I at each eps of FRAC_EPS.
FRAC_N, FRAC_TILE, FRAC_S, FRAC_EPS = 16384, 512, 0.75, (1e-2, 1e-4)
FRAC_CELL = f"frac3d-{FRAC_N // 1024}k"
# The Newton-Schulz path: the same generator at N = 8192, tile 128 (nb = 64;
# at tile 512 every tlr_gemm output tile is a dense 512^2 SVD), compressed
# at 1e-10; the inverse at eps 1e-8 with norm scaling after each iteration
# count of NS_ITERS (the example's defaults).
NS_N, NS_TILE, NS_EPS, NS_ITERS = 8192, 128, 1e-8, (4, 8)
# The server (phase 9): SERVE_SLOTS columns, a PCG window of SERVE_CHECK
# iterations a tick (``fact.serve``'s defaults); SERVE_REQUESTS mixed
# requests on the main path's resident, FRAC_SERVE_REQUESTS pcg_solve
# requests on the fractional-diffusion one (twice the slots, so columns
# refill mid-flight).
SERVE_SLOTS, SERVE_CHECK, SERVE_REQUESTS, FRAC_SERVE_REQUESTS = 8, 4, 64, 16
# The dense LM path (path 13): qwen1.5-0.5b at its published width
# (``repro_torch.configs.qwen1_5_0_5b``: 24 layers, d 1024, 16 heads, ff
# 2816, V 151936, bf16, remat), trained at LM_BATCH x LM_SEQ tokens a step
# with AdamW's defaults (run A LM_STEPS steps; run B the first LM_SPLIT,
# resumed by run C; LM_COMPRESS_STEPS more from run C's state with rank-8
# gradient compression, not checkpointed),
# then served (LM_REQUESTS greedy requests of LM_NEW tokens through
# LM_SLOTS slots of LM_MAX_LEN); and TLR-KFAC on a least-squares problem of
# qwen's down projection's shape: KFAC_N inputs (d_ff), KFAC_M outputs
# (d_model), KFAC_SAMPLES samples, KFAC_STEPS steps, curvature tiles of
# KFAC_TILE factored at ``CholOptions(bs=KFAC_BS)``.
LM_ARCH, LM_BATCH, LM_SEQ = "qwen1.5-0.5b", 8, 1024
LM_STEPS, LM_SPLIT, LM_COMPRESS_STEPS = 8, 4, 2
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 4, 256, 8, 16
KFAC_N, KFAC_M, KFAC_SAMPLES, KFAC_STEPS = 2816, 1024, 4096, 30
KFAC_TILE, KFAC_BS = 32, 8
# The other families (path 14), at their published widths: FAM_TRAIN at
# full depth too, (arch, batch, AdamW learning rate) trained FAM_STEPS
# steps of batch x FAM_SEQ tokens (bf16, remat; the pure-SSM model also
# FAM_SPLIT steps resumed to FAM_STEPS through Trainer.run) and served as
# path 13 serves (whisper at a lower rate: from its initial state, 4 steps
# at AdamW's default 3e-4, or at 1e-4, end above its first loss;
# ``tools/lm_profile.py --steps-at`` prints them);
# FAM_REPEAT at one pattern repeat (num_layers = the pattern's length): a
# prefill of FAM_PREFILL (batch, tokens), then FAM_TICKS decode ticks. Each
# decode step is held against prefill on a FAM_PROMPT-token prompt; the MoE
# layers of FAM_ORACLE against a dense top-k oracle on (tokens, dtype, tol).
FAM_TRAIN = (("mamba2-130m", 8, 3e-4), ("whisper-large-v3", 4, 5e-5),
             ("granite-moe-3b-a800m", 4, 3e-4))
FAM_STEPS, FAM_SPLIT, FAM_SEQ = 4, 2, 1024
FAM_REPEAT = ("jamba-v0.1-52b", "llama-3.2-vision-90b",
              "llama4-maverick-400b-a17b")
FAM_PREFILL, FAM_TICKS, FAM_PROMPT = (2, 1024), 8, 16
FAM_ORACLE = (("granite-moe-3b-a800m", 256, "float32", 1e-4),
              ("llama4-maverick-400b-a17b", 512, "bfloat16", 2e-2))
FAM_SMOKE = ("jamba_v0_1_52b", "whisper_large_v3",
             "llama4_maverick_400b_a17b", "granite_moe_3b_a800m",
             "mamba2_130m", "llama_3_2_vision_90b")
# Model sharding and the dry run (path 15): the dry run's cells (arch,
# shape, mesh) at full width on the production meshes (a fake process group
# of 256 or 512 ranks, CUDA-typed, in a subprocess), DRY_REPEATS repeat of
# the layer pattern deep (the smoke's time limit; PERF.md has the full-depth
# table); beside them qwen1.5-0.5b at full width on SHARD_RANKS
# ranks sharing cuda:0 over gloo, a (1, SHARD_RANKS) (data, model) mesh: one
# AdamW step of SHARD_BATCH x LM_SEQ tokens and SHARD_TICKS greedy decode
# ticks of SHARD_BATCH sequences, against the same on one device.
DRY_CELLS = (("qwen1_5_0_5b", "train_4k", "single"),
             ("granite_moe_3b_a800m", "train_4k", "single"),
             ("mamba2_130m", "decode_32k", "multi"))
DRY_REPEATS = 1
SHARD_RANKS, SHARD_BATCH, SHARD_TICKS, SHARD_MAX_LEN = 2, 8, 8, 64
# Kernel against plain version: max abs error <= TOL * max |plain output|
# (the tolerances of tests/test_kernels.py, relative to the output's scale),
# for every output of the kernel. small_svd is held at TOL_SCALE = 10 times
# that on its sorted singular values and its reconstruction U diag(s) V^T:
# 8 sweeps of rotations, each rounded, sit between input and output, and
# tests/test_kernels.py gives the SVD 100 times the kernel tolerance.
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 5e-2}
TOL_SCALE = {"small_svd": 10.0}
# small_svd's "same rotations" case: unsorted s, U and V elementwise against
# the plain version, whose rotation sequence the kernel keeps, after each
# column pair of U and V is given the sign that makes V's largest entry
# positive: a rotation of two converged columns with alpha < beta swaps
# them, taking the sign of a rounding-level gamma (the plain version on the
# CPU and on the card differ so in 2 of 512 f64 columns of one input, and
# in about 30 % of f32 columns). On the CPU, reordering M's rows (which changes
# only the dot products' summation order) moves the matched factors by
# 4e-14 in f64 and 2.4e-5 in f32.
SAME_ROTATIONS_ATOL = {"float64": 1e-10, "float32": 2e-4}
SAME_ROTATIONS = "same rotations T=4 m=128 n=128"
# batched_qr's graded case: on such tiles Q elementwise is no gate for any
# summation order, nor R at 1e-12 (the plain version with Y's rows permuted
# moves R by 4.7e-12 per tile, relative, at T = 2016 in f64 on an NVIDIA
# H100 80GB HBM3), so it is held to the QR contract (``qr_graded_gate``).
QR_GRADED = "right densified graded T=2016 b=128 r=128"
# Cases held to an absolute tolerance per dtype name, in place of the
# gate's relative one: (kernel, shape label) -> {dtype name: atol}.
CASE_ATOL = {("small_svd", SAME_ROTATIONS): SAME_ROTATIONS_ATOL}
KERNELS = ("batched_gemm", "tile_chain", "lr_sample", "batched_qr",
           "small_svd")
# Below DISPATCH_MS a sampling kernel's mean over back-to-back calls
# (``event_ms``) is the host's dispatch rate, not the kernel: such cases are
# also timed as GRAPH_CALLS calls replayed from a CUDA graph (``graph_ms``).
DISPATCH_MS, GRAPH_CALLS = 0.1, 50
# a plain or library call at least this long is timed once (long_or_mean_ms)
LONG_MS = 100.0
MAIN_KERNELS = ("batched_gemm", "tile_chain", "lr_sample")
ROUND_KERNELS = ("batched_gemm", "batched_qr", "small_svd")
REPLACES = {
    "batched_gemm": "src/repro/kernels/batched_gemm.py:41",
    "tile_chain": "src/repro/kernels/tlr_matvec.py:35",
    "lr_sample": "src/repro/kernels/lr_sample.py:57",
    "batched_qr": "src/repro/kernels/batched_qr.py:68",
    "small_svd": "src/repro/kernels/small_svd.py:70",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in KERNELS}
# The (T, J) shapes of the main path's lr_sample calls: the left-looking
# factorization's column buckets, _column_buckets(64, k, _bucket_ladder(63)) for k < 63
# (src/repro_torch/core/buckets.py; tests/test_torch_kernels.py checks it).
LR_BUCKETS = ((63, 30), (32, 46), (16, 54), (8, 58), (4, 60), (2, 61),
              (1, 62))
# The (tile, ARA block size) of a path's lr_sample calls where they are not
# (TILE, 16).
PATH_BS = {"kfac": (KFAC_TILE, KFAC_BS)}
# Label prefix of the kernel cases at the widest rank bucket a ranked path
# gave each kernel (``widest_bucket``).
RANKED_HEAD = "ranked widest bucket"
# Label prefix of the sampling kernels' f64 cases past r = 128 (the
# tensor-core kernels of 128 < r <= 512; checked in f64 only, since f32 and
# bf16 run the FMA kernels there as at every width), at each (width, row
# stride of the ragged case) of WIDE_WIDTHS.
WIDE_HEAD = "f64 past r=128"
WIDE_WIDTHS = ((129, 160), (256, 259), (384, 512), (512, 515))


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def graph_ms(fn, replays: int = 5) -> float:
    """Mean device time of ``fn`` with the host's dispatch taken out:
    GRAPH_CALLS calls captured in one CUDA graph (after two warm calls on
    the capturing stream), the graph replayed ``replays`` times between
    CUDA events. Inputs stay in L2 from one call to the next when they
    fit."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (GRAPH_CALLS * replays)
    del graph
    return ms


def event_call(fn):
    """``fn()`` once between CUDA events: (its result, device ms)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def long_or_mean_ms(fn, reps: int, first_ms: float | None = None) -> float:
    """Device ms of ``fn``: one call's (``first_ms``, else a new call's)
    when it takes LONG_MS or more, else ``event_ms(fn, reps)``. The plain
    SVD is ~3000 small launches (2-4 s a call on an H100 whatever the
    batch) and cuSOLVER's SVD loops over the batch: repeating such calls
    took ~190 s of the smoke."""
    if first_ms is None:
        _, first_ms = event_call(fn)
    return first_ms if first_ms >= LONG_MS else event_ms(fn, reps)


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -- phase 1/2: device and build ---------------------------------------------------


def device_line() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi}
    log(f"device: {dev['name']} x{dev['count']}")
    return dev


def build_kernels() -> None:
    from repro_torch.kernels import build
    info = build.build_all()
    log(f"build: {info['seconds']:.1f} s for {info['built'] or 'nothing'} "
        f"(cached libraries reused otherwise)")
    for name, text in info["ptxas"].items():
        regs = [int(w.split()[0]) for w in text.split("Used")[1:]]
        spills = [int(line.split("bytes spill stores")[0].split(",")[-1])
                  for line in text.splitlines() if "spill stores" in line]
        log(f"  ptxas {name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} B")
        if name in ("small_svd", "batched_qr", "tile_chain", "lr_sample"):
            # each kernel: its entry, then registers and spills
            for line in text.splitlines():
                if "Compiling entry" in line or "spill stores" in line \
                        or "Used" in line:
                    log(f"    {line.strip()}")


# -- phase 3: kernels against their plain versions ------------------------------------


def kernel_cases(torch, ranks_a, device="cuda", ranked=None):
    """(name, shape label, headline, make(dtype) -> (kernel, plain, fault,
    library, bytes_needed, flops_needed, post[, gate])) at the paths' shapes
    (``CASE_ATOL`` gives some cases an absolute tolerance; a case with its
    own ``gate(out, want) -> (ok, info)`` is held to that instead).

    Main path: N=32768, tile 512, r_max 128, bs 16 (``lr_sample`` at each
    (T, J) column bucket of ``LR_BUCKETS``); ``ranks_a`` are the A-tile
    ranks the main path's first column gives ``batched_gemm``. Rounding pass on that operator:
    ``batched_qr`` of (2016, 512, 128) factor panels, ``small_svd`` of
    (2016, 128, 128) cores. Right-looking path (tile 128): ``batched_qr``
    and ``small_svd`` of (T <= 2016, 128, 128) densified tiles, (63, 128,
    128) and (1, 128, 128) at a panel rounding. Inputs are
    scaled so that outputs are O(1); the square QR inputs are shifted by
    3 I so that Q is well conditioned (a random square panel's Q moves by
    cond x rounding); ``QR_GRADED`` takes graded covariance tiles under
    the QR contract instead. ``fault`` is the plain version with one rank
    (``batched_gemm``; one term of a K-reduction), one factor column
    (``tile_chain``: ``width`` one less), the last j term (``lr_sample``),
    the last column (``batched_qr``) or seven of the eight sweeps
    (``small_svd``) dropped: a result the gate must reject. The
    "same rotations" case holds the unsorted s, U and V of a well-separated
    spectrum elementwise, column signs matched as ``SAME_ROTATIONS_ATOL``
    says. ``post`` maps a
    raw result to the outputs that are gated (None: the result itself);
    timing runs the raw calls. ``headline`` marks the shape that takes most
    of the kernel's time on its path; its numbers go into the kernels
    line.

    Ranked batching runs every kernel at rank-bucket widths: ``lr_sample``
    and ``tile_chain`` at the left driver's gather widths (1 to 128, the
    factors gathered at that width, so an odd width is an odd row stride),
    ``batched_qr`` at (bucket count, b, w), ``small_svd`` at (count, w, w)
    (no rotation at all for w = 1), ``batched_gemm`` at k = w; a bucket's
    count is padded with all-zero tiles, which must come out at rank 0 with
    no NaN. ``ranked`` maps a kernel to a list of ``(path, shape, ranks)``,
    the widest-bucket shape each ranked path gave it (``widest_bucket``),
    with ``batched_gemm``'s live ranks there (None: full rank): such a
    case's label starts with ``RANKED_HEAD`` and its times go into the
    kernels line beside the headline's."""
    g = torch.Generator(device=device).manual_seed(0)
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import batched_qr as qr
    from repro_torch.kernels import lr_sample as lr
    from repro_torch.kernels import small_svd as svd
    from repro_torch.kernels import tlr_matvec as tc

    def randn(shape, dtype, scale=1.0):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32) * scale
        return x.to(dtype)

    def bgemm(m, k, n, ranks, garbage=False, drop=1):
        # garbage: A's columns and B's rows past each rank hold +-1e6, which
        # the plain version masks by multiplication and the kernel must
        # never read; drop: the columns of each rank the fault leaves out
        def make(dtype):
            T = ranks.shape[0]
            A = randn((T, m, k), dtype)
            B = randn((T, k, n), dtype, 1 / math.sqrt(k))
            if garbage:
                dead = (torch.arange(k, device=device)[None, :]
                        >= ranks[:, None])
                A = A.masked_fill(dead[:, None, :], 1e6)
                B = B.masked_fill(dead[:, :, None], -1e6)
            rs = int(ranks.clamp(0, k).sum())
            isz = A.element_size()
            mask = (torch.arange(k, device=device)[None, :]
                    < ranks[:, None]).to(dtype)
            return (lambda: bg.batched_gemm_cuda(A, B, ranks),
                    lambda: bg.batched_gemm_plain(A, B, ranks),
                    lambda: bg.batched_gemm_plain(A, B,
                                                  (ranks - drop).clamp(0)),
                    lambda: torch.einsum("tmk,tk,tkn->tmn", A, mask, B),
                    (m * rs + n * rs + T * m * n) * isz + 4 * T,
                    2.0 * m * n * rs, None)
        return make

    def chain(T, b, r, s, width=None):
        # factors of row stride r read at ``width`` columns (all r if None)
        w = r if width is None else width

        def make(dtype):
            U = randn((T, b, r), dtype, 1 / math.sqrt(w))
            V = randn((T, b, r), dtype, 1 / math.sqrt(b))
            X = randn((T, b, s), dtype)
            isz = U.element_size()
            return (lambda: tc.tile_chain_cuda(U, V, X, width=width),
                    lambda: tc.tile_chain_plain(U, V, X, width=width),
                    lambda: tc.tile_chain_plain(U, V, X, width=w - 1),
                    lambda: torch.einsum("tbr,tcr,tcs->tbs", U[..., :w],
                                         V[..., :w], X),
                    (2 * T * b * w + 2 * T * b * s) * isz,
                    4.0 * T * b * w * s, None)
        return make

    def lrs(T, k, b, r, s, width=None):
        # factors of row stride r read at ``width`` columns (all r if None)
        w = r if width is None else width

        def make(dtype):
            Ui = randn((T, k, b, r), dtype, 1 / math.sqrt(w * k))
            Vi = randn((T, k, b, r), dtype, 1 / math.sqrt(b))
            W2 = randn((k, b, s), dtype)
            isz = Ui.element_size()
            return (lambda: lr.lr_sample_cuda(Ui, Vi, W2, width=width),
                    lambda: lr.lr_sample_plain(Ui, Vi, W2, width=width),
                    lambda: lr.lr_sample_plain(Ui[:, :-1].contiguous(),
                                               Vi[:, :-1].contiguous(),
                                               W2[:-1].contiguous(),
                                               width=width),
                    lambda: torch.einsum("tjbr,tjcr,jcs->tbs", Ui[..., :w],
                                         Vi[..., :w], W2),
                    (2 * T * k * b * w + k * b * s + T * b * s) * isz,
                    4.0 * T * k * b * w * s, None)
        return make

    def mgs(T, b, r, shift=0.0, dead=False, zero_tail=0):
        # MGS2 with R = Q^T Y: 2 sweeps x 2 b r^2 + 2 b r^2 = 6 b r^2 a tile.
        # zero_tail: the last tiles all zero, as a rank bucket's count padding
        def make(dtype):
            Y = randn((T, b, r), torch.float64, 1 / math.sqrt(b))
            if shift:
                Y += shift * torch.eye(b, r, device=device, dtype=Y.dtype)
            if dead:
                Y[0, :, 3] = 2.0 * Y[0, :, 1] - Y[0, :, 0]
            if zero_tail:
                Y[T - zero_tail:] = 0.0
            Y = Y.to(dtype)
            Yf = Y.clone()
            Yf[:, :, -1] = 0.0
            isz = Y.element_size()
            return (lambda: qr.batched_qr_cuda(Y),
                    lambda: qr.batched_qr_plain(Y),
                    lambda: qr.batched_qr_plain(Yf),
                    lambda: torch.linalg.qr(Y),
                    (2 * T * b * r + T * r * r) * isz,
                    6.0 * T * b * r * r, None)
        return make

    def graded(T):
        # exponential-covariance tiles between two clusters of 128 points
        # (l = 0.1), as the right driver densifies them: graded, about a
        # quarter of the columns live at the drop tolerance
        def make(dtype):
            Y = graded_tiles(torch, T, g, device).to(dtype)
            Yf = Y.clone()
            Yf[:, :, -1] = 0.0
            isz = Y.element_size()
            return (lambda: qr.batched_qr_cuda(Y),
                    lambda: qr.batched_qr_plain(Y),
                    lambda: qr.batched_qr_plain(Yf),
                    lambda: torch.linalg.qr(Y),
                    (2 * T * 128 * 128 + T * 128 * 128) * isz,
                    6.0 * T * 128 ** 3, None, qr_graded_gate(Y, TOL[
                        str(dtype).removeprefix("torch.")]))
        return make

    def jacobi(T, m, n, zero_tail=0):
        # 8 sweeps of n(n-1)/2 rotations at 12 m + 6 n FLOPs each, skipped
        # rotations included (the Pallas kernel does their arithmetic too).
        # For n <= 2 one sweep already converges, so the planted fault drops
        # the last column instead. zero_tail: the last tiles all zero.
        def make(dtype):
            M = randn((T, m, n), dtype, 1 / math.sqrt(m))
            if zero_tail:
                M[T - zero_tail:] = 0.0
            Mf = M.clone()
            Mf[:, :, -1] = 0.0
            isz = M.element_size()

            def post(out):
                U, s, V = out
                return (s.sort(dim=-1, descending=True).values,
                        (U * s[:, None, :]) @ V.transpose(1, 2))
            return (lambda: svd.small_svd_cuda(M),
                    lambda: svd.small_svd_plain(M),
                    (lambda: svd.small_svd_plain(Mf)) if n <= 2 else
                    (lambda: svd.small_svd_plain(M, sweeps=1)),
                    lambda: torch.linalg.svd(M, full_matrices=False),
                    (2 * T * m * n + T * n + T * n * n) * isz,
                    8.0 * T * n * (n - 1) / 2 * (12 * m + 6 * n), post)
        return make

    def same_rotations(T, n):
        # M = Qa diag(linspace(3, 0.1)) Qb: singular values 0.023 apart
        def make(dtype):
            Qa = torch.linalg.qr(randn((T, n, n), torch.float64)).Q
            Qb = torch.linalg.qr(randn((T, n, n), torch.float64)).Q
            sig = torch.linspace(3.0, 0.1, n, device=device,
                                 dtype=torch.float64)
            M = ((Qa * sig) @ Qb).to(dtype)
            isz = M.element_size()

            def post(out):
                U, s, V = out
                sign = svd_column_signs(V)
                return s, U * sign, V * sign
            return (lambda: svd.small_svd_cuda(M),
                    lambda: svd.small_svd_plain(M),
                    lambda: svd.small_svd_plain(M, sweeps=1),
                    lambda: torch.linalg.svd(M, full_matrices=False),
                    (2 * T * n * n + T * n + T * n * n) * isz,
                    8.0 * T * n * (n - 1) / 2 * (18 * n), post)
        return make

    def ranked_cases(shapes):
        """The widest-bucket case of each kernel on each ranked path."""
        out = []
        for name, path, shape, ranks in sorted(
                (name, *case) for name, cases in shapes.items()
                for case in cases):
            label = f"{RANKED_HEAD} on {path} {shape}"
            if ranks is not None:
                label += (f" live ranks {int(ranks.min())}.."
                          f"{int(ranks.max())}")
            if name == "lr_sample":
                Tr, J, r = shape
                b, sc = PATH_BS.get(path, (TILE, 16))
                out.append((name, label, False, lrs(Tr, J, b, r, sc)))
            elif name == "tile_chain":
                Tr, b, r, sc = shape
                out.append((name, label, False, chain(Tr, b, r, sc)))
            elif name == "batched_gemm":
                # On frac_ns a call wider than the own-term assembly (k >
                # m + n) is tlr_gemm's K-reduction over concatenated terms of
                # n columns: its fault drops the last term, since one column
                # of 8064 hides inside bf16's tolerance.
                Tr, m, k, n = shape
                drop = n if path == "frac_ns" and k > m + n else 1
                out.append((name, label, False, bgemm(
                    m, k, n, full(Tr, k) if ranks is None else ranks,
                    drop=drop)))
            elif name == "batched_qr":
                Tr, b, r = shape
                out.append((name, label, False,
                            mgs(Tr, b, r, shift=3.0 if b == r else 0.0)))
            else:
                Tr, m, n = shape
                out.append((name, label, False, jacobi(Tr, m, n)))
        return out

    T = ranks_a.shape[0]
    ragged = torch.randint(1, 25, (5,), generator=g, device=device,
                           dtype=torch.int32)
    # ranks of the right path's batched_gemm calls (their own generator, so
    # that the other cases keep their inputs): full rank at the flushes'
    # densify (k = w_acc = 384) and truncation; L's ranks at the trailing
    # SYRK (cov2d-8k-right: mean 8.19, max 39); ranks from -2 to k + 3 with
    # garbage past them
    gr = torch.Generator(device=device).manual_seed(1)

    def full(T, k):
        return torch.full((T,), k, device=device, dtype=torch.int32)
    syrk = (-8.7 * torch.log(torch.rand((1953,), generator=gr, device=device,
                                        dtype=torch.float64))).floor()
    syrk = syrk.clamp(0, 39).to(torch.int32)
    syrk[:2] = torch.tensor([39, 0], dtype=torch.int32)
    wild = torch.randint(-2, 388, (100,), generator=gr, device=device,
                         dtype=torch.int32)
    return [
        ("batched_gemm", f"sample T={T} m=512 k=128 n=16", True,
         bgemm(512, 128, 16, ranks_a)),
        ("batched_gemm", f"sample_t T={T} m=512 k=128 n=128", False,
         bgemm(512, 128, 128, ranks_a)),
        ("batched_gemm", "ragged T=5 m=96 k=24 n=20", False,
         bgemm(96, 24, 20, ragged)),
        ("batched_gemm", "flush densify T=2016 m=128 k=384 n=128", False,
         bgemm(128, 384, 128, full(2016, 384))),
        ("batched_gemm", "truncation T=2016 m=128 k=128 n=128", False,
         bgemm(128, 128, 128, full(2016, 128))),
        ("batched_gemm", "SYRK T=1953 m=128 k=128 n=128 (L ranks)", False,
         bgemm(128, 128, 128, syrk)),
        ("batched_gemm", "op.round T=2016 m=512 k=128 n=128", False,
         bgemm(512, 128, 128, full(2016, 128))),
        ("batched_gemm", f"garbage tail T={T} m=512 k=128 n=16", False,
         bgemm(512, 128, 16, ranks_a, garbage=True)),
        ("batched_gemm", "garbage tail T=100 m=128 k=384 n=128 ranks -2..387",
         False, bgemm(128, 384, 128, wild, garbage=True)),
        ("tile_chain", "W2 hoist T=30 b=512 r=128 s=16", False,
         chain(30, 512, 128, 16)),
        ("tile_chain", "sample_t T*J=1890 b=512 r=128 s=128", True,
         chain(1890, 512, 128, 128)),
        ("tile_chain", "ragged T=3 b=96 r=24 s=70", False,
         chain(3, 96, 24, 70)),
        ("tile_chain", "ragged T*J=1891 b=500 ldr=128 width=100 s=128", False,
         chain(1891, 500, 128, 128, width=100)),
        ("tile_chain", "past r=128 T=3 b=100 ldr=160 width=129 s=70", False,
         chain(3, 100, 160, 70, width=129)),
        ("tile_chain", "FMA past r=512 T=2 b=100 ldr=640 width=520 s=70",
         False, chain(2, 100, 640, 70, width=520)),
        *[("lr_sample", f"T={Tb} J={Jb} b=512 r=128 s=16", Tb == 63,
           lrs(Tb, Jb, 512, 128, 16)) for Tb, Jb in LR_BUCKETS],
        ("lr_sample", "ragged T=5 J=2 b=96 r=24 s=20", False,
         lrs(5, 2, 96, 24, 20)),
        ("lr_sample", "two 16-column chunks T=3 J=5 b=100 ldr=128 width=37 "
         "s=20", False, lrs(3, 5, 100, 128, 20, width=37)),
        ("lr_sample", "one j T=63 J=1 b=512 r=128 s=16", False,
         lrs(63, 1, 512, 128, 16)),
        ("lr_sample", "8-byte copies T=5 J=3 b=100 ldr=127 s=16", False,
         lrs(5, 3, 100, 127, 16)),
        ("lr_sample", "rows past 512 T=4 J=3 b=1000 r=128 s=16", False,
         lrs(4, 3, 1000, 128, 16)),
        ("lr_sample", "FMA past r=512 T=2 J=3 b=100 ldr=640 width=520 s=16",
         False, lrs(2, 3, 100, 640, 16, width=520)),
        # the f64 tensor-core kernels past r = 128, each width at b = 512 and
        # ragged (b = 500, s = 70 / 20, a width= slice of a wider row
        # stride, odd at 256 and 512: 8-byte copies)
        *[case for w, ldr in WIDE_WIDTHS for case in (
            ("tile_chain", f"{WIDE_HEAD} T=8 b=512 r={w} s=256", False,
             chain(8, 512, w, 256)),
            ("tile_chain", f"{WIDE_HEAD} ragged T=3 b=500 ldr={ldr} "
             f"width={w} s=70", False, chain(3, 500, ldr, 70, width=w)),
            ("lr_sample", f"{WIDE_HEAD} T=8 J=6 b=512 r={w} s=16", False,
             lrs(8, 6, 512, w, 16)),
            ("lr_sample", f"{WIDE_HEAD} ragged T=3 J=5 b=500 ldr={ldr} "
             f"width={w} s=20", False, lrs(3, 5, 500, ldr, 20, width=w)))],
        ("batched_qr", "op.round T=2016 b=512 r=128", True,
         mgs(2016, 512, 128)),
        ("batched_qr", "right T=2016 b=128 r=128 (+3I)", False,
         mgs(2016, 128, 128, shift=3.0)),
        ("batched_qr", "panel T=63 b=128 r=128 (+3I)", False,
         mgs(63, 128, 128, shift=3.0)),
        ("batched_qr", "one tile T=1 b=128 r=128 (+3I)", False,
         mgs(1, 128, 128, shift=3.0)),
        ("batched_qr", QR_GRADED, False, graded(2016)),
        ("batched_qr", "ragged T=5 b=96 r=24 dead column", False,
         mgs(5, 96, 24, dead=True)),
        ("small_svd", "core T=2016 m=128 n=128", True,
         jacobi(2016, 128, 128)),
        ("small_svd", "panel T=63 m=128 n=128", False, jacobi(63, 128, 128)),
        ("small_svd", "one tile T=1 m=128 n=128", False,
         jacobi(1, 128, 128)),
        ("small_svd", SAME_ROTATIONS, False, same_rotations(4, 128)),
        ("small_svd", "ragged T=3 m=20 n=13", False, jacobi(3, 20, 13)),
        ("small_svd", "scratch T=2 m=300 n=200", False, jacobi(2, 300, 200)),
        # rank-bucket widths (ranked batching)
        *[("lr_sample", f"bucket T=63 J=30 b=512 r={w} s=16", False,
           lrs(63, 30, 512, w, 16)) for w in (1, 8, 32)],
        *[("tile_chain", f"bucket T*J=1890 b=512 r={w} s=128", False,
           chain(1890, 512, w, 128)) for w in (2, 16)],
        ("tile_chain", "odd stride T=63 b=512 ldr=5 width=3 s=128", False,
         chain(63, 512, 5, 128, width=3)),
        *[("batched_qr", f"bucket T=64 b={b} r={w}", False, mgs(64, b, w))
          for b in (128, 512) for w in (1, 4, 32)],
        ("batched_qr", "bucket T=64 b=128 r=4, 21 zero tiles", False,
         mgs(64, 128, 4, zero_tail=21)),
        *[("small_svd", f"bucket core T=64 m={w} n={w}", False,
           jacobi(64, w, w)) for w in (1, 2, 8, 64)],
        ("small_svd", "bucket core T=64 m=4 n=4, 21 zero tiles", False,
         jacobi(64, 4, 4, zero_tail=21)),
        *[("batched_gemm", f"bucket truncation T=64 m=128 k={w} n={w}", False,
           bgemm(128, w, w, full(64, w))) for w in (1, 4, 32)],
        ("batched_gemm", "bucket core T=64 m=2 k=2 n=2", False,
         bgemm(2, 2, 2, full(64, 2))),
        ("batched_gemm", "bucket densify T=64 m=128 k=256 n=128 ranks 129..256",
         False, bgemm(128, 256, 128, torch.randint(
             129, 257, (64,), generator=gr, device=device,
             dtype=torch.int32))),
        *[("batched_gemm", f"A-term T=63 m=512 k={w} n=16", False,
           bgemm(512, w, 16, ranks_a.clamp(max=w))) for w in (1, 4)],
        *ranked_cases(ranked or {}),
    ]


def gate(got, want, tol: float, atol: float | None = None
         ) -> tuple[float, float]:
    """(max abs error, allowed) of the output closest to failing: ``got``
    passes when, for every output, its largest deviation from ``want`` is
    at most ``tol`` times the largest |want| of that output (at most
    ``atol``, if given)."""
    if not isinstance(want, (tuple, list)):
        got, want = (got,), (want,)
    worst, worst_ratio = (0.0, 0.0), -1.0
    for x, w in zip(got, want):
        w = w.double()
        err = float((x.double() - w).abs().max())
        allowed = atol if atol is not None else tol * float(w.abs().max())
        ratio = err / allowed if allowed > 0 else (math.inf if err else 0.0)
        if ratio > worst_ratio:
            worst, worst_ratio = (err, allowed), ratio
    return worst


def svd_column_signs(V):
    """(T, 1, n): the sign of each column's largest |entry| of V."""
    import torch
    top = V.abs().argmax(dim=1, keepdim=True)
    return torch.sign(torch.take_along_dim(V, top, dim=1))


def graded_tiles(torch, T, g, device="cuda"):
    """(T, 128, 128) f64 exponential-covariance tiles (l = 0.1) between two
    clusters of 128 points, in [0, 0.5]^2 and [0.5, 1]^2."""
    pa = torch.rand((T, 128, 2), generator=g, device=device,
                    dtype=torch.float64) * 0.5
    pb = pa.new_empty(pa.shape).uniform_(0.5, 1.0, generator=g)
    return torch.exp(-torch.cdist(pa, pb) / 0.1).contiguous()


def qr_graded_gate(Y, tol: float):
    """The QR contract on graded tiles, as a gate ``(out, want) -> (ok,
    info)`` against the plain version:

    - the same dead columns, except at the cut: a column that one version
      keeps and the other drops must have, in the version that keeps it,
      |R[j, j]| (its residual norm) at most twice the first sweep's
      tolerance rel * max_j |y_j| (f32 puts a few of 2016 x 128 columns
      within rounding of it);
    - R, over the tiles without such a column, within max(tol, 10x the
      plain version's own move when Y's rows are permuted) per tile
      (relative Frobenius; a row permutation changes only the summation
      order, and moves R by 4.7e-12 at T = 2016 in f64 on an H100);
    - ||Q R - Y|| / ||Y|| and ||Q_live^T Q_live - I||, over all tiles,
      within 10x the plain version's."""
    import torch
    from repro_torch.kernels import batched_qr as qr
    Yd = Y.double()
    tol1 = qr.REL[Y.dtype] * Yd.norm(dim=1).amax(dim=1, keepdim=True)

    def contract(Q, R):
        Q, R = Q.double(), R.double()
        dead = Q.abs().amax(dim=1) == 0
        res = ((Q @ R - Yd).norm(dim=(1, 2)) / Yd.norm(dim=(1, 2))).max()
        gram = Q.transpose(1, 2) @ Q - torch.diag_embed((~dead).double())
        return dead, float(res), float(gram.norm(dim=(1, 2)).max())

    def flips(dead, R, dead_p, Rp):
        """Columns decided differently, and each one's kept |R[j, j]| /
        tol1 (0 elsewhere)."""
        flipped = dead != dead_p
        kept = torch.where(dead_p, R.diagonal(dim1=1, dim2=2),
                           Rp.diagonal(dim1=1, dim2=2)).double().abs()
        return flipped, torch.where(flipped, kept / tol1,
                                    torch.zeros_like(kept))

    def r_rel(R, Rp, tiles):
        R, Rp = R[tiles].double(), Rp[tiles].double()
        if R.shape[0] == 0:
            return 0.0
        return float(((R - Rp).norm(dim=(1, 2))
                      / Rp.norm(dim=(1, 2))).max())

    perm = torch.randperm(Y.shape[1], generator=torch.Generator().manual_seed(
        0)).to(Y.device)
    Qq, Rq = qr.batched_qr_plain(Y[:, perm].contiguous())

    def check(out, want):
        (Q, R), (Qp, Rp) = out, want
        dead, res, orth = contract(Q, R)
        dead_p, res_p, orth_p = contract(Qp, Rp)
        flipped, ratio = flips(dead, R, dead_p, Rp)
        flipped_q, _ = flips(Qq.abs().amax(dim=1) == 0, Rq, dead_p, Rp)
        spread = r_rel(Rq, Rp, ~flipped_q.any(dim=1))
        info = {"r_rel_err": r_rel(R, Rp, ~flipped.any(dim=1)),
                "r_allowed": max(tol, 10 * spread),
                "r_spread_row_permuted": spread,
                "dead_differ": int(flipped.sum()),
                "dead_differ_max_rjj_over_tol": float(ratio.max()),
                "dead_differ_row_permuted": int(flipped_q.sum()),
                "live": int((~dead_p).sum()), "columns": dead_p.numel(),
                "residual": res, "residual_plain": res_p,
                "orthogonality": orth, "orthogonality_plain": orth_p}
        ok = (info["dead_differ_max_rjj_over_tol"] <= 2.0
              and info["r_rel_err"] <= info["r_allowed"]
              and res <= 10 * res_p and orth <= 10 * orth_p)
        return ok, info
    return check


def bitwise_equal(a, b) -> bool:
    """Whether two kernel results (a tensor or a tuple of them) are equal
    bit for bit."""
    import torch
    if not isinstance(a, (tuple, list)):
        a, b = (a,), (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_kernels(ranks_a, only=None, ranked=None) -> dict:
    """Every case of ``kernel_cases`` (those of the kernels named in
    ``only``, if given; ``ranked`` as ``kernel_cases`` takes it): gate,
    planted fault, two calls bitwise equal, and timings."""
    import torch
    all_dtypes = (torch.float64, torch.float32, torch.bfloat16)
    results = {}
    for name, label, headline, make in kernel_cases(torch, ranks_a,
                                                     ranked=ranked):
        if only is not None and name not in only:
            continue
        for dtype in (all_dtypes[:1] if label.startswith(WIDE_HEAD) else
                      all_dtypes[:2] if name in ("batched_qr", "small_svd")
                      else all_dtypes):
            dn = str(dtype).removeprefix("torch.")
            tol = TOL[dn] * TOL_SCALE.get(name, 1.0)
            abs_tol = CASE_ATOL.get((name, label), {}).get(dn)
            t_case = time.perf_counter()
            case = make(dtype)
            kernel, plain, fault, library, nbytes, flops, post = case[:7]
            post = post or (lambda out: out)
            # timed: f64 (the kernels line's dtype) and each headline in
            # every dtype; a widest-bucket case's f32 / bf16 times went
            # nowhere and took ~56 s of the run on an H100
            timed = dtype == torch.float64 or headline
            raw, plain_first = event_call(plain)
            want = post(raw)
            got = kernel()
            rec = {"kernel": name, "shape": label, "dtype": dn}
            if len(case) > 7:   # the case's own gate
                ok, info = case[7](got, raw)
                fault_ok, fault_info = case[7](fault(), raw)
                err, atol = info["r_rel_err"], info["r_allowed"]
                fault_err, fault_atol = (fault_info["r_rel_err"],
                                         fault_info["r_allowed"])
                rec.update(contract=info, planted_fault_contract=fault_info)
            else:
                err, atol = gate(post(got), want, tol, abs_tol)
                fault_err, fault_atol = gate(post(fault()), want, tol,
                                             abs_tol)
                ok, fault_ok = err <= atol, fault_err <= fault_atol
            same = bitwise_equal(got, kernel())
            rec.update({"max_abs_err": err, "atol": atol, "ok": ok,
                        "planted_fault_err": fault_err,
                        "planted_fault_atol": fault_atol,
                        "deterministic": same})
            if label == SAME_ROTATIONS:
                # columns whose sign the kernel and the plain version differ in
                rec["sign_flips"] = int((svd_column_signs(got[2]) !=
                                         svd_column_signs(raw[2])).sum())
            if timed:
                reps = 3 if flops > 5e10 else 10
                rec["ms"] = event_ms(kernel, reps)
                rec["plain_ms"] = long_or_mean_ms(plain, reps, plain_first)
                rec["library_ms"] = long_or_mean_ms(library, reps)
                if name in MAIN_KERNELS and rec["ms"] < DISPATCH_MS:
                    # back-to-back calls time the host's dispatch here:
                    # replay them from a CUDA graph for the device time
                    rec["graph_ms"] = graph_ms(kernel)
                    rec["graph_plain_ms"] = graph_ms(plain)
                    rec["graph_library_ms"] = graph_ms(library)
                rec["bound_ms"] = 1e3 * max(nbytes / PEAK_BYTES,
                                            flops / PEAK_FLOPS[dn])
                rec["bound_by"] = ("bytes" if nbytes / PEAK_BYTES
                                   >= flops / PEAK_FLOPS[dn] else "operations")
            rec["s"] = time.perf_counter() - t_case   # the case's seconds
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"{name} {label} {dn}: kernel disagrees "
                                     f"with its plain version "
                                     f"(max abs err {err:.3e} > {atol:.3e})")
            if fault_ok:
                raise AssertionError(f"{name} {label} {dn}: the gate let a "
                                     f"planted fault through (err "
                                     f"{fault_err:.3e} <= {fault_atol:.3e})")
            if not same:
                raise AssertionError(f"{name} {label} {dn}: two kernel calls "
                                     f"on the same inputs differ")
            results[(name, label, dn)] = dict(rec, headline=headline,
                                              own_gate=len(case) > 7)
            del want, got, kernel, plain, fault, library
        torch.cuda.empty_cache()
    return results


# -- phase 4: small end-to-end run, card against CPU ---------------------------------------


def small_parity() -> None:
    """The same factorization on the card and on the CPU (n = 2048, tile
    256), with flat and with ranked batching: equal ranks, factors and
    solves within 1e-8."""
    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.convert import operator_from_numpy

    n, tile, eps = 2048, 256, 1e-6
    _, K = covariance_problem(n, 2, tile, device="cuda")
    op_gpu = TLROperator.compress(K, tile, r_max=128, eps=1e-8)
    op_cpu = operator_from_numpy(*(t.cpu().numpy() for t in (
        op_gpu.A.D, op_gpu.A.U, op_gpu.A.V, op_gpu.A.ranks)), device="cpu")
    y = torch.randn((n, 4), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    for batching in ("flat", "ranked"):
        opts = CholOptions(eps=eps, bs=16, mode="dynamic", batching=batching)
        f_gpu = op_gpu.cholesky(opts)
        f_cpu = op_cpu.cholesky(opts)
        rg, rc = f_gpu.L.ranks.cpu(), f_cpu.L.ranks
        assert torch.equal(rg, rc), \
            f"{batching}: ranks differ in {(rg != rc).sum()} tiles"
        Lg = torch.tril(f_gpu.L.to_dense().cpu())
        Lc = torch.tril(f_cpu.L.to_dense())
        rel = float((Lg - Lc).norm() / Lc.norm())
        xg, xc = f_gpu.solve(y.cuda()).cpu(), f_cpu.solve(y)
        rel_x = float((xg - xc).norm() / xc.norm())
        log(f"small parity n={n} tile={tile} batching={batching}: ranks "
            f"equal, ||L_gpu - L_cpu||/||L_cpu|| = {rel:.3e}, solve rel "
            f"diff {rel_x:.3e}")
        assert rel <= 1e-8 and rel_x <= 1e-8, \
            f"{batching}: card and CPU runs disagree"
    frac_parity()


def frac_parity() -> None:
    """Both fractional-diffusion preconditioners on the card and on the CPU
    (n = 512, tile 64, the same compressed operator): the loose-eps
    Cholesky of ``tlr_add_diag(op.A, 1e-2)`` and two Newton-Schulz
    iterations (norm scaling, eps 1e-8; the CPU runs the plain Jacobi SVD,
    which sets the count). Gates: equal PCG iterations with each, and the
    Newton-Schulz X within 1e-10 (relative, Frobenius)."""
    import numpy as np
    import torch
    from repro_torch import CholOptions, TLROperator, pcg, tlr_newton_schulz
    from repro_torch.convert import operator_from_numpy
    from repro_torch.core import (fractional_diffusion_matrix,
                                  fractional_diffusion_points, tlr_add_diag)

    n, tile, eps = 512, 64, 1e-2
    K = fractional_diffusion_matrix(fractional_diffusion_points(n, tile),
                                    device="cuda")
    op = {"cuda": TLROperator.compress(K, tile, eps=1e-10)}
    op["cpu"] = operator_from_numpy(*(t.cpu().numpy() for t in (
        op["cuda"].A.D, op["cuda"].A.U, op["cuda"].A.V, op["cuda"].A.ranks)),
        device="cpu")
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(n))
    it, X = {}, {}
    for dev, o in op.items():
        b = rhs.to(dev)
        fact = TLROperator(tlr_add_diag(o.A, eps)).cholesky(
            CholOptions(eps=eps, bs=16))
        Xop, _ = tlr_newton_schulz(o, iters=2, eps=1e-8, scale="norm")
        it[dev] = (pcg(o, b, precond=fact, tol=1e-6, maxiter=300)[1],
                   pcg(o, b, precond=Xop, tol=1e-6, maxiter=300)[1])
        X[dev] = Xop.to_dense().cpu()
    rel = float((X["cuda"] - X["cpu"]).norm() / X["cpu"].norm())
    log(f"small parity frac n={n} tile={tile}: pcg iterations (Cholesky "
        f"eps={eps:g}, Newton-Schulz) card {it['cuda']}, CPU {it['cpu']}; "
        f"Newton-Schulz X card vs CPU rel {rel:.3e} (gate 1e-10)")
    assert it["cuda"] == it["cpu"] and rel <= 1e-10, \
        "frac: card and CPU preconditioners disagree"


# -- phase 5: the main path at full width --------------------------------------------------


def _dev_us(event) -> float:
    """Self device time of a device-side profiler event (kernel, memcpy,
    memset); 0 for host-side ops, whose "self device time" repeats the
    kernels they launched, and for the profiler's own buffer events."""
    if not str(getattr(event, "device_type", "")).endswith("CUDA") or \
            "Buffer" in event.key:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def timed(fn, profile: str | None, name: str):
    """``sync_time(fn)``; with ``profile`` set, under torch.profiler as
    well: its table goes to ``<profile>/<name>_profile.txt`` and the device
    busy time, idle share and top kernels to the log."""
    if not profile:
        return sync_time(fn)
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        out, sec = sync_time(fn)
    path = Path(profile) / f"{name}_profile.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(prof.key_averages().table(row_limit=60))
    evs = [e for e in prof.key_averages() if _dev_us(e) > 0]
    busy_us = sum(_dev_us(e) for e in evs)
    log(f"profile {name}: device busy {busy_us / 1e6:.3f} s of {sec:.3f} s "
        f"wall (idle share {1 - busy_us / 1e6 / sec:.3f}); table in {path}")
    top = sorted(evs, key=lambda e: -_dev_us(e))
    # the twelve largest, then every other kernel of the port (templates
    # are named with their return type, plain functions without)
    for e in top[:12] + [e for e in top[12:] if e.key.removeprefix(
            "void ").removeprefix("(anonymous namespace)::").startswith(
            ("bgemm", "tile_chain", "lr_sample", "mgs_qr", "jacobi_svd"))]:
        log(f"  {_dev_us(e) / 1e3:10.1f} ms {e.count:7d}x  {e.key[:90]}")
    return out, sec


def path_shapes() -> dict:
    """Launches per shape of each kernel since the last reset."""
    from repro_torch.kernels import ops
    return {name: dict(mod.SHAPES) for name, mod in ops.KERNELS.items()}


def widest_bucket(shapes: dict, width_axis: int = 2):
    """The shape of ``shapes`` (launches per shape) at the widest rank
    bucket, the largest batch among those; None if there is none."""
    if not shapes:
        return None
    return max(shapes, key=lambda sh: (sh[width_axis], sh[-1], sh[0]))


def left_summary(fact, label: str, r_max: int) -> None:
    """Logs a left-looking factorization's batching decision, ranks and
    widths: the policy record, wA, the wL ladder the driver reached and
    each column's projection width wQ."""
    st = fact.stats
    rl = fact.L.ranks.float()
    ev = st["column_events"]
    ladder = []
    for e in ev:
        if e["wL"] is not None and (not ladder or ladder[-1] != e["wL"]):
            ladder.append(e["wL"])
    log(f"{label}: batching {st['batching']}, policy "
        f"{json.dumps(st['policy'])}")
    log(f"{label}: L ranks max {int(rl.max())} mean {float(rl.mean()):.2f} "
        f"(r_max {r_max}); wA {ev[0]['wA'] if ev else None}, wL ladder {ladder or None}, wQ "
        f"per column {[e['wQ'] for e in ev] if ladder else None}; "
        f"{sum(st['column_iters'])} ARA block iterations over "
        f"{len(st['column_iters'])} columns, modified_chol "
        f"{st['modified_chol']}, safety_valve {st['safety_valve']}, stage "
        f"seconds {json.dumps({k: round(v, 3) for k, v in st['schedule']['kind_seconds'].items()})}")


def log_shapes(label: str, shapes: dict) -> None:
    for name in ("lr_sample", "tile_chain", "batched_gemm", "batched_qr",
                 "small_svd"):
        if shapes.get(name):
            log(f"{label}: {name} launches per shape: "
                f"{shapes_line(shapes[name])}")


def left_residual(K, fact, Z) -> float:
    """max_z ||P K P^T z - L (L^T z)|| / ||P K P^T z|| over the columns of
    Z, for the factorization's tile permutation P (the identity unless it
    pivoted): P K P^T z is (K w)[e] with w[e] = z, e the element
    permutation of ``fact.perm``."""
    import torch
    from repro_torch.core import tile_perm_to_element_perm
    e = torch.as_tensor(tile_perm_to_element_perm(fact.perm, fact.L.b),
                        device=Z.device)
    W = torch.zeros_like(Z)
    W[e] = Z
    KZ = (K @ W)[e]
    LLZ = fact.tri_matvec(fact.tri_matvec(Z, trans=True))
    return float(((KZ - LLZ).norm(dim=0) / KZ.norm(dim=0)).max())


def main_path(n: int, profile: str | None) -> dict:
    import dataclasses

    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.kernels import build, ops

    tile, r_max, eps = TILE, R_MAX, EPS

    torch.cuda.reset_peak_memory_stats()
    phases = {}
    (pts, K), phases["covariance"] = sync_time(
        lambda: covariance_problem(n, 2, tile, device="cuda"))
    log(f"main path: 2-D exp covariance N={n} tile={tile} "
        f"(nb={n // tile}), K on {K.device}; compress method=svd "
        f"eps=1e-8 r_max={r_max}")

    ops.reset_launch_counts()
    op, phases["compress"] = sync_time(
        lambda: TLROperator.compress(K, tile, r_max=r_max, eps=1e-8,
                                     method="svd", bs=16))
    opts = CholOptions(eps=eps, bs=16, mode="dynamic")   # batching "auto"
    fact, phases["factor"] = timed(lambda: op.cholesky(opts), profile,
                                   "factor")
    g = torch.Generator(device="cuda").manual_seed(0)
    x_true = torch.randn((n,), generator=g, device="cuda", dtype=K.dtype)
    y = K @ x_true
    Y4 = K @ torch.randn((n, 4), generator=g, device="cuda", dtype=K.dtype)
    x, phases["solve_1"] = sync_time(lambda: fact.solve(y))
    X4, phases["solve_4"] = sync_time(lambda: fact.solve(Y4))
    ld, phases["logdet"] = sync_time(lambda: fact.logdet())
    S, phases["sample_2"] = sync_time(lambda: fact.sample(2, generator=g))
    Ax, phases["matvec"] = sync_time(lambda: op @ x)
    launches = ops.launch_counts()
    shapes = path_shapes()
    batching = fact.stats["batching"]
    log(f"launches on the main path (batching auto -> {batching}): "
        f"{json.dumps(launches)}")
    log_shapes("main path", shapes)
    # the source's j split at the lr_sample shapes: groups of j per row tile
    # (the partials' workspace holds groups x T x b x s words when groups > 1)
    groups = {sh: max(1, build.query("lr_sample", "workspace", K.dtype,
                                     sh[0], sh[1], tile, sh[2], 16)
                      // (sh[0] * tile * 16)) for sh in shapes["lr_sample"]}
    log("lr_sample j groups (blocks) per (T, J, r): " + ", ".join(
        f"{sh} {gr} ({sh[0] * gr})" for sh, gr in sorted(groups.items(),
                                                         reverse=True)))

    ra = op.A.ranks.float()
    log(f"phase seconds: {json.dumps({k: round(v, 4) for k, v in phases.items()})}")
    log(f"A ranks: max {int(ra.max())} mean {float(ra.mean()):.2f} median "
        f"of the positive {op.plan().median_rank} (r_max {r_max})")
    assert int(ra.max()) < r_max, \
        f"A's max rank reached r_max={r_max}: compression clipped; raise R_MAX"
    mem = torch.cuda.max_memory_allocated()
    log(f"max_memory_allocated: {mem / 2**30:.2f} GiB")
    left_summary(fact, f"main path ({batching})", r_max)

    # Gates: every kernel of the path ran, outputs finite, randomized factor
    # residual.
    for name in MAIN_KERNELS:
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the main path"
    for name, t in (("solve_1", x), ("solve_4", X4), ("sample", S),
                    ("matvec", Ax), ("logdet", ld)):
        assert bool(torch.isfinite(t).all()), f"{name} has non-finite values"
    assert S.shape == (n, 2) and X4.shape == (n, 4)
    Z = torch.randn((n, 3), generator=g, device="cuda", dtype=K.dtype)
    resid = left_residual(K, fact, Z)
    solve_err = float((x - x_true).norm() / x_true.norm())
    mv_err = float((Ax - y).norm() / y.norm())
    log(f"factor residual max_z ||Kz - L L^T z||/||Kz|| = {resid:.3e} "
        f"(gate {100 * eps:.0e}); solve rel err {solve_err:.3e}; "
        f"matvec rel err {mv_err:.3e}")
    assert resid <= 100 * eps, "factor residual above 100 eps"
    assert mv_err <= 1e-6, "TLR matvec disagrees with the dense K"
    del X4, S, Y4

    # The same compressed operator factored with the other batching value,
    # so that flat and ranked both run at full size.
    other = "flat" if batching == "ranked" else "ranked"
    ops.reset_launch_counts()
    fact2, sec2 = sync_time(lambda: op.cholesky(
        dataclasses.replace(opts, batching=other)))
    launches2 = ops.launch_counts()
    shapes2 = path_shapes()
    resid2 = left_residual(K, fact2, Z)
    differ = int((fact2.L.ranks != fact.L.ranks).sum())
    log(f"main path, batching={other}: factor {sec2:.3f} s (the {batching} "
        f"factorization: {phases['factor']:.3f} s); launches "
        f"{json.dumps(launches2)}; residual {resid2:.3e} (gate "
        f"{100 * eps:.0e}); L ranks differ from the {batching} factor's in "
        f"{differ} of {fact.L.ranks.numel()} tiles")
    log_shapes(f"main path ({other})", shapes2)
    left_summary(fact2, f"main path ({other})", r_max)
    for name in MAIN_KERNELS:
        assert launches2[name] > 0, \
            f"kernel {name} was not launched by the {other} factorization"
    assert resid2 <= 100 * eps, f"{other} factor residual above 100 eps"
    del fact2
    # The run's first factorization also pays the kernels' module loading:
    # time the default once more, warm, beside the other value's run.
    _, sec_warm = sync_time(lambda: op.cholesky(opts))
    phases["factor_warm"] = sec_warm
    log(f"main path factorization seconds, warm: {batching} {sec_warm:.3f}, "
        f"{other} {sec2:.3f} (the first, cold: {batching} "
        f"{phases['factor']:.3f})")

    reads = read_paths(op, fact, g)
    rounding = rounding_phase(op, K, g)
    pivots = pivot_phase(op, K, Z, y, x_true, opts, sec_warm)
    checked = check_phase(op, fact, opts, sec_warm)
    served = serve_main_phase(op, fact, K)
    telem = telemetry_phase(op, fact, opts)
    # The A-tile ranks batched_gemm gets in the first column (rows 1..nb-1).
    nb = n // tile
    rows = torch.arange(1, nb, device="cuda")
    ranks_a = op.A.ranks[rows * (rows - 1) // 2].contiguous()
    log(f"A ranks of the first column (batched_gemm's shape check): max "
        f"{int(ranks_a.max())} mean {float(ranks_a.float().mean()):.2f}")
    del op, fact
    torch.cuda.empty_cache()
    Ld, t_dense = sync_time(lambda: torch.linalg.cholesky(K))
    ld_dense = float(2 * torch.log(torch.diagonal(Ld)).sum())
    log(f"logdet: TLR {float(ld):.6f}, dense cholesky {ld_dense:.6f} "
        f"(rel diff {abs(float(ld) - ld_dense) / abs(ld_dense):.2e}; dense "
        f"check {t_dense:.2f} s)")
    by_batching = {batching: (launches, shapes), other: (launches2, shapes2)}
    return {"launches": launches, "batching": batching,
            "flat": by_batching["flat"], "ranked": by_batching["ranked"],
            "phases": phases, "ranks_a": ranks_a, "reads": reads,
            **rounding, **pivots, **checked, **served, **telem}


def read_paths(op, fact, g, reps: int = 20) -> dict:
    """The read paths on the main path's operator and factor, flat beside
    ranked: ``op.matvec``, the factor's ``tri_matvec`` (L and L^T) and the
    two triangular solves of ``solve`` (``tri_solve`` forward, then
    transposed), on 1 and 4 right-hand sides. Each is timed warm by CUDA
    events over ``reps`` back-to-back calls (the host's dispatch and index
    work included, as a caller pays it). Gate: ranked agrees with flat to
    1e-12 (products) or 1e-9 (solves), relative."""
    import torch
    n = op.n
    out = {}
    for m in (1, 4):
        x = torch.randn((n, m), generator=g, device=op.device,
                        dtype=op.dtype)[:, 0 if m == 1 else slice(None)]
        calls = {
            "matvec": lambda b: op.matvec(x, batching=b),
            "tri_matvec": lambda b: fact.tri_matvec(x, batching=b),
            "tri_matvec_t": lambda b: fact.tri_matvec(x, trans=True,
                                                      batching=b),
            "solve": lambda b: fact.tri_solve(
                fact.tri_solve(x, batching=b), trans=True, batching=b),
        }
        for name, call in calls.items():
            got = {b: call(b) for b in ("flat", "ranked")}
            rel = float((got["ranked"] - got["flat"]).norm()
                        / got["flat"].norm())
            ms = {b: event_ms(lambda: call(b), reps)
                  for b in ("flat", "ranked")}
            tol = 1e-9 if name == "solve" else 1e-12
            log(f"read path {name} ({m} rhs): flat {ms['flat']:.4f} ms, "
                f"ranked {ms['ranked']:.4f} ms (x "
                f"{ms['ranked'] / ms['flat']:.2f}); ranked vs flat rel "
                f"{rel:.2e} (gate {tol:.0e})")
            assert rel <= tol, f"read path {name}: ranked disagrees with flat"
            out[f"{name}_{m}"] = ms
    return out


# -- phase 6: the rounding pass on the main path's operator -------------------------------


def rounding_phase(op, K, g, eps: float = 1e-6) -> dict:
    """``op.round(eps)`` on the compressed main-path operator, flat (one
    r_max-wide batch: QR of the (nt, b, r_max) factor stacks, SVD of the
    (nt, r_max, r_max) cores) and ranked (the same per rank bucket at its
    width), each timed on its second call. Gates for each: the QR and SVD
    kernels ran, no tile's rank rose, and the rounded operator's matvec is
    within 1e-5 (relative) of the dense ``K x``."""
    import torch
    from repro_torch.kernels import ops

    x = torch.randn((K.shape[0],), generator=g, device="cuda", dtype=K.dtype)
    y = K @ x
    out, ranks = {}, {}
    r0 = op.A.ranks
    for batching in ("flat", "ranked"):
        op.round(eps, batching=batching)     # warm: module loading
        ops.reset_launch_counts()
        rop, sec = sync_time(lambda: op.round(eps, batching=batching))
        launches = ops.launch_counts()
        shapes = path_shapes()
        log_shapes(f"round path ({batching})", shapes)
        r1 = ranks[batching] = rop.A.ranks
        mv_err = float((rop @ x - y).norm() / y.norm())
        log(f"rounding phase ({batching}): op.round({eps:g}) in {sec:.3f} "
            f"s; launches {json.dumps(launches)}; ranks max {int(r0.max())} "
            f"-> {int(r1.max())}, mean {float(r0.float().mean()):.2f} -> "
            f"{float(r1.float().mean()):.2f}, {int((r1 < r0).sum())} of "
            f"{r0.numel()} tiles lower; matvec rel err {mv_err:.3e} (gate "
            f"1e-5)")
        for name in ("batched_qr", "small_svd"):
            assert launches[name] > 0, \
                f"{name} not launched by op.round ({batching})"
        assert bool((r1 <= r0).all()), f"op.round ({batching}) raised a rank"
        assert mv_err <= 1e-5, \
            f"rounded operator's matvec ({batching}) disagrees with K"
        out[f"round_{batching}"] = (launches, shapes)
        del rop
    log(f"rounding phase: ranks flat vs ranked differ in "
        f"{int((ranks['flat'] != ranks['ranked']).sum())} of {r0.numel()} "
        f"tiles (max |diff| "
        f"{int((ranks['flat'] - ranks['ranked']).abs().max())})")
    return out


# -- phase 7: the right-looking driver ----------------------------------------------------


def shapes_line(shapes: dict) -> str:
    return ", ".join(f"{shape} {c}" for shape, c in
                     sorted(shapes.items(), reverse=True))


@contextlib.contextmanager
def gemm_rank_log():
    """While open, records every ``ops.batched_gemm`` call of the paths:
    yields a dict (T, m, k, n) -> list of the calls' rank tensors (copied
    on the card, no host sync). Only the smoke installs it, around the
    right-looking driver, whose shapes ``shape_times`` then times at those
    ranks."""
    from repro_torch.kernels import ops
    calls, inner = {}, ops.batched_gemm

    def recording(A, B, ranks):
        if ranks.numel():
            calls.setdefault((*A.shape, B.shape[-1]), []).append(
                ranks.clone())
        return inner(A, B, ranks)
    ops.batched_gemm = recording
    try:
        yield calls
    finally:
        ops.batched_gemm = inner


def gemm_shapes(calls: dict) -> dict:
    """(T, m, k, n) -> (launches, per-t mean live rank min(max(rank, 0), k)
    over them, the live ranks of the call with the most live columns) from
    a ``gemm_rank_log``."""
    import torch
    out = {}
    for (T, m, k, n), rs in calls.items():
        live = torch.stack(rs).clamp(0, k)
        out[(T, m, k, n)] = (len(rs), live.double().mean(dim=0),
                             live[int(live.sum(dim=1).argmax())])
    return out


def gemm_shapes_line(shapes: dict) -> str:
    return ", ".join(
        f"{shape} {c} (live rank mean {float(r.mean()):.2f}, max "
        f"{float(r.max()):.0f})"
        for shape, (c, r, _) in sorted(shapes.items(), reverse=True))


def shape_times(name: str, shapes: dict, dtype_name: str = "float64",
                bs: tuple[int, int] = (TILE, 16)) -> dict:
    """Times ``small_svd`` (shapes (T, m, n)), ``batched_qr`` ((T, b, r)),
    ``batched_gemm`` ((T, m, k, n), from ``gemm_shapes``: at that shape's
    per-t mean live ranks, rounded), ``tile_chain`` ((T, b, r, s)) or
    ``lr_sample`` ((T, J, r) at ``bs`` = (b, s)) at each shape a path
    launched it with (random inputs, the square QR panels shifted by 3 I;
    CUDA events, and a CUDA graph too under DISPATCH_MS) and logs launches x
    kernel ms against launches x bound ms per shape (``batched_gemm`` also
    its library call, ``torch.einsum`` of the masked product). Returns the
    summed kernel and bound seconds (the graph's time where taken), the
    path's time in that kernel as these shapes give it: ``"all"`` over
    every shape, ``"wide"`` over those whose third dimension (a factor
    width, k or r) passes R_MAX."""
    import torch
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import batched_qr as qr
    from repro_torch.kernels import lr_sample as lr
    from repro_torch.kernels import small_svd as svd
    from repro_torch.kernels import tlr_matvec as tc
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(3)
    sums = {"all": [0.0, 0.0], "wide": [0.0, 0.0]}
    for shape, count in sorted(shapes.items(), reverse=True):
        T, m, n = shape[0], shape[1], shape[-1]
        if name == "lr_sample":     # (T, J, r): Ui, Vi (T, J, b, r)
            m, n = bs
            X = torch.randn((T, shape[1], m, shape[2]), generator=g,
                            device="cuda", dtype=torch.float64)
        else:
            X = torch.randn((T, m, shape[2]), generator=g, device="cuda",
                            dtype=torch.float64) / math.sqrt(m)
        if name == "batched_qr" and m == n:
            X += 3.0 * torch.eye(m, device="cuda", dtype=X.dtype)
        X = X.to(dtype)
        library, note = None, ""
        if name in ("tile_chain", "lr_sample"):
            # X and V = X / sqrt(b) are U and V (the time does not depend
            # on the values); B is X of tile_chain or W2 of lr_sample
            r, V = shape[2], X / math.sqrt(m)
            B = torch.randn((T if name == "tile_chain" else shape[1], m, n),
                            generator=g, device="cuda",
                            dtype=torch.float64).to(dtype)
            if name == "tile_chain":
                call = functools.partial(tc.tile_chain_cuda, X, V, B)
                words = 2 * T * m * r + 2 * T * m * n
                flops = 4.0 * T * m * r * n
            else:
                J = shape[1]
                call = functools.partial(lr.lr_sample_cuda, X, V, B)
                words = 2 * T * J * m * r + J * m * n + T * m * n
                flops = 4.0 * T * J * m * r * n
        elif name == "batched_gemm":
            count, mean, _ = count
            k = shape[2]
            B = (torch.randn((T, k, n), generator=g, device="cuda",
                             dtype=torch.float64) / math.sqrt(k)).to(dtype)
            ranks = mean.round().to(torch.int32)
            mask = (torch.arange(k, device="cuda")[None, :]
                    < ranks[:, None]).to(dtype)
            rs = int(ranks.clamp(0, k).sum())
            call = functools.partial(bg.batched_gemm_cuda, X, B, ranks)
            library = functools.partial(torch.einsum, "tmk,tk,tkn->tmn", X,
                                        mask, B)
            flops = 2.0 * m * n * rs
            words = m * rs + n * rs + T * m * n
            note = f", live rank mean {rs / T:.2f}"
        elif name == "small_svd":
            call = functools.partial(svd.small_svd_cuda, X)
            flops = 8.0 * T * n * (n - 1) / 2 * (12 * m + 6 * n)
            words = 2 * T * m * n + T * n + T * n * n
        else:
            call = functools.partial(qr.batched_qr_cuda, X)
            flops = 6.0 * T * m * n * n
            words = 2 * T * m * n + T * n * n
        reps = 3 if T > 500 else 10
        ms = event_ms(call, reps)
        timing = f"{ms:.4f} ms"
        if library is not None:
            note += f"; library {event_ms(library, reps):.4f} ms"
        if ms < DISPATCH_MS:
            ms = graph_ms(call)
            timing += f" by events, {ms:.4f} ms by graph"
            if library is not None:
                note += f", {graph_ms(library):.4f} ms by graph"
        bound = 1e3 * max(words * X.element_size() / PEAK_BYTES,
                          flops / PEAK_FLOPS[dtype_name])
        for key in ("all", "wide") if shape[2] > R_MAX else ("all",):
            sums[key][0] += count * ms / 1e3
            sums[key][1] += count * bound / 1e3
        log(f"  {name} {shape} {dtype_name}: {count} launches x {timing} = "
            f"{count * ms:.1f} ms (bound {bound:.4f} ms, x {count} = "
            f"{count * bound:.1f} ms{note})")
        del X, call
    for key, label in (("all", "all shapes"),
                       ("wide", f"shapes past width {R_MAX}")):
        log(f"  {name} {label}: {1e3 * sums[key][0]:.1f} ms (bound "
            f"{1e3 * sums[key][1]:.1f} ms)")
    return {key: tuple(v) for key, v in sums.items()}


def right_phase(n: int, profile: str | None) -> dict:
    """The 2-D exponential covariance at N = ``n``, tile 128, compressed at
    1e-8 with r_max 128, factored by the right-looking driver: Cholesky and
    LDL^T, each with flat and with ranked batching, and the ranked Cholesky
    again at accumulation cadences (``right_flush``) 2 and 4. Gates per
    factorization: the QR, SVD and GEMM kernels ran, the randomized
    residual ``||K z - L D L^T z|| / ||K z|| <= 100 eps`` holds and a solve
    is finite. Logs flushes, append widths, peak memory and
    ``small_svd``'s, ``batched_qr``'s and ``batched_gemm``'s launches per
    shape and, after all four, their times per shape."""
    import dataclasses

    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.kernels import ops

    tile, eps = TILE_RIGHT, EPS
    _, K = covariance_problem(n, 2, tile, device="cuda")
    op, t_comp = sync_time(lambda: TLROperator.compress(
        K, tile, r_max=R_MAX, eps=1e-8, method="svd"))
    ra = op.A.ranks.float()
    log(f"right phase: 2-D exp covariance N={n} tile={tile} "
        f"(nb={n // tile}, nt={op.A.U.shape[0]}); compress {t_comp:.2f} s, "
        f"A ranks max {int(ra.max())} mean {float(ra.mean()):.2f} median of "
        f"the positive {op.plan().median_rank}")
    g = torch.Generator(device="cuda").manual_seed(2)
    Z = torch.randn((n, 3), generator=g, device="cuda", dtype=K.dtype)
    KZ = K @ Z
    y = K @ torch.randn((n,), generator=g, device="cuda", dtype=K.dtype)
    out = {}
    base = CholOptions(eps=eps, algo="right")
    # (kind, batching, right_flush; 0 is the policy's cadence): the ranked
    # Cholesky also at cadences 2 and 4, for its time against peak memory
    runs = [(kind, b, 0) for kind in ("cholesky", "ldlt")
            for b in ("flat", "ranked")]
    runs += [("cholesky", "ranked", f) for f in (2, 4)]
    for kind, batching, flush in runs:
        key = (f"right_{kind}" + ("" if batching == "flat" else "_ranked")
               + (f"_flush{flush}" if flush else ""))
        opts = dataclasses.replace(base, batching=batching,
                                   right_flush=flush)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with gemm_rank_log() as gemm_calls:
            fact, sec = timed(lambda: getattr(op, kind)(opts),
                              profile if kind == "cholesky" and not flush
                              else None,
                              key)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        shapes = {"small_svd": path_shapes()["small_svd"],
                  "batched_qr": path_shapes()["batched_qr"],
                  "batched_gemm": gemm_shapes(gemm_calls)}
        resid = right_residual(fact, Z, KZ)
        x, t_solve = sync_time(lambda: fact.solve(y))
        st = fact.stats
        rl = fact.L.ranks.float()
        aw = st["append_widths"]
        log(f"{key}: factor {sec:.3f} s, batching {st['batching']}, policy "
            f"right_flush {st['policy']['right_flush']}, {st['flushes']} "
            f"flushes, acc_width {st['acc_width']}, append widths "
            f"{dict(sorted(collections.Counter(aw).items())) or None}, peak "
            f"memory {peak / 2**30:.2f} GiB, L ranks max {int(rl.max())} "
            f"mean {float(rl.mean()):.2f}, modified_chol "
            f"{st['modified_chol']}, stage seconds "
            f"{json.dumps({k: round(v, 3) for k, v in st['schedule']['kind_seconds'].items()})}; "
            f"residual {resid:.3e} (gate {100 * eps:.0e}); solve "
            f"{t_solve:.3f} s; launches {json.dumps(launches)}")
        for name in ROUND_KERNELS:
            assert launches[name] > 0, \
                f"kernel {name} was not launched by {key}"
        assert resid <= 100 * eps, f"{key}: residual above 100 eps"
        assert bool(torch.isfinite(x).all()), f"{key}: solve not finite"
        out[key] = launches
        out[f"{key}_seconds"] = sec
        out[f"{key}_shapes"] = shapes
        out[f"{key}_max_rank"] = int(rl.max())
        log(f"{key}: small_svd launches per (T, m, n): "
            f"{shapes_line(shapes['small_svd'])}; batched_qr per (T, b, r): "
            f"{shapes_line(shapes['batched_qr'])}")
        log(f"{key}: batched_gemm launches per (T, m, k, n): "
            f"{gemm_shapes_line(shapes['batched_gemm'])}")
        del fact, x, gemm_calls
    out.update(lookahead_phase(op, Z, KZ, y))
    out.update(telemetry_right_phase(op))
    out.update(fault_phase(op, out["right_cholesky_max_rank"]))
    out.update(mixed_phase(op, K, Z))
    out.update(mesh_phase(op, Z, KZ, y))
    del op, K, KZ, Z
    torch.cuda.empty_cache()
    for kind, batching, flush in runs:
        if flush:
            continue
        key = f"right_{kind}" + ("" if batching == "flat" else "_ranked")
        for name in ("small_svd", "batched_qr", "batched_gemm"):
            log(f"{key}: {name} per shape (f64, timed apart from the "
                f"path):")
            sec = shape_times(name, out[f"{key}_shapes"][name])["all"][0]
            log(f"{key}: {name} {sec:.3f} s of the factorization's "
                f"{out[f'{key}_seconds']:.3f} s")
    return out


# -- phase 8: the fractional-diffusion PCG path (paper section 6.2) ---------------


def rank_histogram(ranks, cap: int) -> str:
    """Tiles per rank range: 0, 1-16, 17-32, 33-64, ... up to ``cap``."""
    r = ranks.cpu()
    edges = [0, 1, 17]
    while edges[-1] <= cap:
        edges.append(2 * edges[-1] - 1)
    parts = []
    for lo, hi in zip(edges, edges[1:]):
        count = int(((r >= lo) & (r < hi)).sum())
        if count:
            parts.append(f"{lo}" + (f"-{min(hi - 1, cap)}" if hi - 1 > lo
                                    else "") + f": {count}")
    return ", ".join(parts)


def frac_pcg_phase(profile: str | None = None) -> dict:
    """The 3-D fractional-diffusion operator (``FRAC_N``, tile
    ``FRAC_TILE``) built on the card and compressed at 1e-10 with r_max =
    tile; for each eps of ``FRAC_EPS``, ``tlr_add_diag(op.A, eps)`` factored
    by the left-looking Cholesky (``CholOptions(eps=eps, bs=16)``, batching
    "auto"; a diagonal shift leaves every off-diagonal tile as it is, so
    this is exactly the compression of K + eps I) and used by ``pcg`` as
    the preconditioner of the compressed operator; then ``pcg`` without
    one. Gates: final relative residual below 1e-6 and ``||K x - b|| /
    ||b|| < 1e-5`` with the dense K for each preconditioned solve; fewer
    iterations at 1e-2 than without, no more at 1e-4 than at 1e-2. With
    ``profile``, the factorization at the first eps runs under
    torch.profiler (``timed``)."""
    import numpy as np
    import torch
    from repro_torch import CholOptions, TLROperator, pcg
    from repro_torch.core import (fractional_diffusion_matrix,
                                  fractional_diffusion_points, tlr_add_diag)
    from repro_torch.kernels import ops

    n, tile = FRAC_N, FRAC_TILE
    pts = fractional_diffusion_points(n, tile)
    torch.cuda.reset_peak_memory_stats()
    K, t_build = sync_time(lambda: fractional_diffusion_matrix(
        pts, s=FRAC_S, device="cuda"))
    log(f"frac pcg: 3-D fractional diffusion N={n} s={FRAC_S} tile={tile} "
        f"(nb={n // tile}) built on the card in {t_build:.2f} s (peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    ops.reset_launch_counts()
    with gemm_rank_log() as gemm_calls:
        op, t_comp = sync_time(lambda: TLROperator.compress(K, tile,
                                                            eps=1e-10))
        ra = op.A.ranks
        log(f"frac pcg: compress eps=1e-10 r_max={op.r_max} in {t_comp:.2f} "
            f"s; A ranks max {int(ra.max())} mean "
            f"{float(ra.float().mean()):.2f}, histogram "
            f"{rank_histogram(ra, op.r_max)}")
        assert int(ra.max()) < op.r_max, "frac pcg: compression clipped"
        rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                              device="cuda")
        bnorm = float(rhs.norm())
        iters, fact_s = {}, {}
        for eps in FRAC_EPS:
            torch.cuda.reset_peak_memory_stats()
            op_eps = TLROperator(tlr_add_diag(op.A, eps))
            fact, t_fact = timed(lambda: op_eps.cholesky(
                CholOptions(eps=eps, bs=16)),
                profile if eps == FRAC_EPS[0] else None, "frac_factor")
            peak = torch.cuda.max_memory_allocated()
            (x, it, hist), t_pcg = sync_time(lambda: pcg(
                op, rhs, precond=fact, tol=1e-6, maxiter=300))
            true = float((K @ x - rhs).norm()) / bnorm
            left_summary(fact, f"frac pcg eps={eps:g}", op.r_max)
            log(f"frac pcg eps={eps:g}: factor {t_fact:.3f} s (peak "
                f"{peak / 2**30:.2f} GiB), batching {fact.stats['batching']}"
                f"; pcg {it} iterations in {t_pcg:.3f} s, relative "
                f"residual {hist[-1]:.3e} (gate 1e-6), ||K x - b||/||b|| "
                f"{true:.3e} (gate 1e-5), breakdown {hist.breakdown}")
            assert hist.breakdown is None and hist[-1] < 1e-6, \
                f"frac pcg eps={eps:g}: pcg did not converge"
            assert true < 1e-5, f"frac pcg eps={eps:g}: K x far from b"
            iters[eps], fact_s[eps] = it, t_fact
            del fact, op_eps, x
        (x, it_plain, hist), t_plain = sync_time(lambda: pcg(
            op, rhs, tol=1e-6, maxiter=300))
    launches = ops.launch_counts()
    shapes = path_shapes()
    shapes["batched_gemm"] = gemm_shapes(gemm_calls)
    log(f"frac pcg: unpreconditioned pcg {it_plain} iterations in "
        f"{t_plain:.3f} s, relative residual {hist[-1]:.3e}; iterations "
        f"{json.dumps({f'{e:g}': i for e, i in iters.items()})}; launches "
        f"{json.dumps(launches)}")
    for name in ("lr_sample", "tile_chain"):
        log(f"frac pcg: {name} launches per shape: "
            f"{shapes_line(shapes[name])}")
    log(f"frac pcg: batched_gemm launches per (T, m, k, n): "
        f"{gemm_shapes_line(shapes['batched_gemm'])}")
    for name in MAIN_KERNELS:
        assert launches[name] > 0, f"frac pcg: {name} was not launched"
    # the sampling kernels' share of the two factorizations, timed apart
    sampled = {"all": [0.0, 0.0], "wide": [0.0, 0.0]}
    for name in ("lr_sample", "tile_chain"):
        log(f"frac pcg: {name} per shape (f64, timed apart from the path):")
        for key, (sec, bound) in shape_times(
                name, shapes[name], bs=(FRAC_TILE, 16)).items():
            sampled[key][0] += sec
            sampled[key][1] += bound
    log(f"frac pcg: lr_sample + tile_chain {sampled['all'][0]:.4f} s (bound "
        f"{sampled['all'][1]:.4f} s) over all shapes, {sampled['wide'][0]:.4f}"
        f" s (bound {sampled['wide'][1]:.4f} s) past width {R_MAX}, of the "
        f"factorizations' {sum(fact_s.values()):.3f} s ("
        + ", ".join(f"eps={e:g} {t:.3f} s" for e, t in fact_s.items()) + ")")
    e1, e2 = FRAC_EPS
    assert iters[e1] < it_plain, \
        f"frac pcg: eps={e1:g} took {iters[e1]} iterations, plain {it_plain}"
    assert iters[e2] <= iters[e1], \
        f"frac pcg: eps={e2:g} took more iterations than eps={e1:g}"
    del x
    served = serve_frac_phase(op, K, FRAC_EPS[0])
    del op, K
    torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes, "factor_s": fact_s,
            "sampled_s": sampled, **served}


# -- phase 9: the Newton-Schulz TLR inverse as preconditioner --------------------


def frac_ns_phase(profile: str | None = None) -> dict:
    """The fractional-diffusion operator at ``NS_N``, tile ``NS_TILE``,
    compressed at 1e-10; ``tlr_newton_schulz(op, iters, eps=NS_EPS,
    scale="norm")`` for each count of ``NS_ITERS`` (flat, the default) and
    ranked at the last, each used by ``pcg``; one ``op.compose(op,
    NS_EPS)``. Gates: each Newton-Schulz PCG ends below 1e-6, and the best
    takes fewer iterations than plain PCG (the example's ``--check``); ranked X within 1e-8 of flat (relative,
    Frobenius); the composed product within 1e-6 of the dense ``K @ K``
    (relative, Frobenius). The product is compressed at NS_EPS: the
    threshold is absolute and per tile, and the tiles of K @ K keep
    singular values above 1e-6 far down their spectra, so at 1e-6 the
    truncation alone would leave more than 1e-6 of ||K @ K||. With
    ``profile``, the
    flat build at the last iteration count runs under torch.profiler."""
    import numpy as np
    import torch
    from repro_torch import TLROperator, pcg, tlr_newton_schulz
    from repro_torch.core import (fractional_diffusion_matrix,
                                  fractional_diffusion_points)
    from repro_torch.core.algebra import gemm_chunks
    from repro_torch.kernels import ops

    n, tile = NS_N, NS_TILE
    K = fractional_diffusion_matrix(fractional_diffusion_points(n, tile),
                                    s=FRAC_S, device="cuda")
    ops.reset_launch_counts()
    with gemm_rank_log() as gemm_calls:
        op, t_comp = sync_time(lambda: TLROperator.compress(K, tile,
                                                            eps=1e-10))
        ra = op.A.ranks
        log(f"frac ns: 3-D fractional diffusion N={n} tile={tile} "
            f"(nb={op.nb}); compress eps=1e-10 in {t_comp:.2f} s, A ranks "
            f"max {int(ra.max())} mean {float(ra.float().mean()):.2f} "
            f"(r_max {op.r_max}); tlr_gemm middle terms in "
            f"{gemm_chunks(op.nb, tile, op.r_max, op.r_max)} chunks of "
            f"output tiles (flat)")
        assert int(ra.max()) < op.r_max, "frac ns: compression clipped"
        rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                              device="cuda")
        (_, it_plain, hist), t_plain = sync_time(lambda: pcg(
            op, rhs, tol=1e-6, maxiter=300))
        log(f"frac ns: unpreconditioned pcg {it_plain} iterations in "
            f"{t_plain:.3f} s, relative residual {hist[-1]:.3e}")
        X, best = {}, it_plain
        for iters, batching in [(i, "flat") for i in NS_ITERS] + [
                (NS_ITERS[-1], "ranked")]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (Xop, info), t_build = timed(lambda: tlr_newton_schulz(
                op, iters=iters, eps=NS_EPS, scale="norm",
                batching=batching), profile if (iters, batching) == (
                    NS_ITERS[-1], "flat") else None, "frac_ns_build")
            peak = torch.cuda.max_memory_allocated()
            (x, it, hist), t_pcg = sync_time(lambda: pcg(
                op, rhs, precond=Xop, tol=1e-6, maxiter=300))
            log(f"frac ns iters={iters} {batching}: build {t_build:.3f} s "
                f"(peak {peak / 2**30:.2f} GiB), alpha {info.alpha:.6e}, X "
                f"ranks mean {info.avg_rank:.2f} max {info.max_rank}; pcg "
                f"{it} iterations in {t_pcg:.3f} s (plain {it_plain}), "
                f"relative residual {hist[-1]:.3e}")
            assert hist.breakdown is None and hist[-1] < 1e-6, \
                f"frac ns iters={iters} {batching}: pcg did not converge"
            best = min(best, it)
            X[(iters, batching)] = Xop.to_dense()
            del Xop, x
        Xf, Xr = X[(NS_ITERS[-1], "flat")], X[(NS_ITERS[-1], "ranked")]
        rel_x = float((Xr - Xf).norm() / Xf.norm())
        del X, Xf, Xr
        C, t_comp2 = sync_time(lambda: op.compose(op, NS_EPS))
        KK = K @ K
        rel_c = float((C.to_dense() - KK).norm() / KK.norm())
    launches = ops.launch_counts()
    shapes = path_shapes()
    shapes["batched_gemm"] = gemm_shapes(gemm_calls)
    cr = C.ranks.float()
    log(f"frac ns: ranked X vs flat rel {rel_x:.3e} (gate 1e-8); "
        f"op.compose(op, {NS_EPS:g}) in {t_comp2:.3f} s, ranks max "
        f"{int(cr.max())} mean {float(cr.mean()):.2f}, vs dense K @ K rel "
        f"{rel_c:.3e} (gate 1e-6); launches {json.dumps(launches)}")
    for name in ("batched_qr", "small_svd"):
        log(f"frac ns: {name} launches per shape: "
            f"{shapes_line(shapes[name])}")
    log(f"frac ns: batched_gemm launches per (T, m, k, n): "
        f"{gemm_shapes_line(shapes['batched_gemm'])}")
    for name in ROUND_KERNELS:
        assert launches[name] > 0, f"frac ns: {name} was not launched"
    assert best < it_plain, \
        f"frac ns: Newton-Schulz pcg took {best} iterations, plain {it_plain}"
    assert rel_x <= 1e-8, "frac ns: ranked Newton-Schulz differs from flat"
    assert rel_c <= 1e-6, "frac ns: op.compose(op) differs from K @ K"
    del op, K, KK, C
    torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes}


# -- phase 10: the right driver's lookahead schedule ---------------------------------


def factor_diff(a, b) -> tuple[float, bool]:
    """Max over L.D, L.U, L.V (and d) of max |a - b| / max |b|, and whether
    every one of them is bitwise equal."""
    import torch
    pairs = [(a.L.D, b.L.D), (a.L.U, b.L.U), (a.L.V, b.L.V)]
    if b.d is not None:
        pairs.append((a.d, b.d))
    rel = max(float((x - y).abs().max() / y.abs().max()) for x, y in pairs)
    same = all(torch.equal(x, y) for x, y in pairs) and \
        torch.equal(a.L.ranks, b.L.ranks)
    return rel, same


def right_residual(fact, Z, KZ) -> float:
    """max_z ||K z - L D L^T z|| / ||K z|| over the columns of Z."""
    LtZ = fact.tri_matvec(Z, trans=True)
    if fact.d is not None:
        LtZ = LtZ * fact.d.reshape(-1, 1)
    return float(((KZ - fact.tri_matvec(LtZ)).norm(dim=0)
                  / KZ.norm(dim=0)).max())


def lookahead_phase(op, Z, KZ, y) -> dict:
    """The right-looking driver under ``lookahead=True`` on the
    cov2d-8k-right operator: Cholesky and LDL^T, flat and ranked, each
    beside the sequential run of the same options (sequential first, then
    lookahead). Gates: the lookahead factor within 1e-12 of the sequential
    one (max abs over L.D, L.U, L.V and d, relative to the sequential
    array's max), the right phase's residual gate, a finite solve, the QR,
    SVD and GEMM kernels launched and the second CUDA stream in use. Logs
    both wall times, the bitwise status, peak memory, flushes, append
    widths and the first 8 stages of the executed order."""
    import dataclasses

    import torch
    from repro_torch import CholOptions
    from repro_torch.kernels import ops

    out = {}
    for kind in ("cholesky", "ldlt"):
        for batching in ("flat", "ranked"):
            key = f"right_{kind}_{batching}_lookahead"
            opts = CholOptions(eps=EPS, algo="right", batching=batching)
            seq, t_seq = sync_time(lambda: getattr(op, kind)(opts))
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            la, t_la = sync_time(lambda: getattr(op, kind)(
                dataclasses.replace(opts, lookahead=True)))
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            rel, same = factor_diff(la, seq)
            resid = right_residual(la, Z, KZ)
            x = la.solve(y)
            st, sched = la.stats, la.stats["schedule"]
            aw = st["append_widths"]
            log(f"{key}: factor {t_la:.3f} s (sequential {t_seq:.3f} s, "
                f"ratio {t_la / t_seq:.3f}); against sequential max rel "
                f"diff {rel:.3e} (gate 1e-12), bitwise "
                f"{'yes' if same else 'no'}; peak memory "
                f"{peak / 2**30:.2f} GiB; {st['flushes']} flushes "
                f"(sequential {seq.stats['flushes']}), append widths "
                f"{dict(sorted(collections.Counter(aw).items())) or None}; "
                f"schedule {sched['name']}, streams {sched['streams']}, "
                f"first stages {sched['order'][:8]}; stage seconds "
                f"{json.dumps({k: round(v, 3) for k, v in sched['kind_seconds'].items()})}; "
                f"residual {resid:.3e} (gate {100 * EPS:.0e}); launches "
                f"{json.dumps(launches)}")
            for name in ROUND_KERNELS:
                assert launches[name] > 0, \
                    f"kernel {name} was not launched by {key}"
            assert sched["name"] == "lookahead" and sched["streams"] == 2, \
                f"{key}: the tail updates did not run on a second stream"
            assert rel <= 1e-12, f"{key}: lookahead factor differs from " \
                f"the sequential one by {rel:.3e}"
            assert st["flushes"] == seq.stats["flushes"]
            assert resid <= 100 * EPS, f"{key}: residual above 100 eps"
            assert bool(torch.isfinite(x).all()), f"{key}: solve not finite"
            out[key] = launches
            out[f"{key}_seconds"] = (t_seq, t_la)
            del seq, la, x
    return out


# -- phase 11: inter-tile pivoting (Algorithm 9) on the main path's operator -----


def pivot_phase(op, K, Z, y, x_true, opts, t_plain: float) -> dict:
    """The left-looking Cholesky of the main path's compressed operator
    with ``pivot="frobenius"`` and ``pivot="power"``. Gates: the sampling
    kernels launched, the randomized residual of ``P K P^T`` within 100
    eps, a finite solve. Logs the pivot sequence, the columns that swapped
    and the time against the unpivoted factorization's (warm)."""
    import dataclasses

    import torch
    from repro_torch.kernels import ops

    out = {}
    for pivot in ("frobenius", "power"):
        key = f"main_pivot_{pivot}"
        ops.reset_launch_counts()
        fact, sec = sync_time(lambda: op.cholesky(
            dataclasses.replace(opts, pivot=pivot)))
        launches = ops.launch_counts()
        resid = left_residual(K, fact, Z)
        x = fact.solve(y)
        err = float((x - x_true).norm() / x_true.norm())
        piv = fact.stats["pivots"]
        swapped = sum(int(p != k) for k, p in enumerate(piv))
        log(f"{key}: factor {sec:.3f} s (unpivoted, warm: {t_plain:.3f} s, "
            f"ratio {sec / t_plain:.3f}); pivots {piv}; {swapped} of "
            f"{len(piv)} columns swapped; perm {fact.perm.tolist()}; "
            f"residual of P K P^T {resid:.3e} (gate {100 * EPS:.0e}); "
            f"solve rel err {err:.3e}; batching {fact.stats['batching']}; "
            f"launches {json.dumps(launches)}")
        for name in MAIN_KERNELS:
            assert launches[name] > 0, \
                f"kernel {name} was not launched by {key}"
        assert len(piv) == op.nb and \
            sorted(fact.perm.tolist()) == list(range(op.nb))
        assert resid <= 100 * EPS, f"{key}: residual above 100 eps"
        assert bool(torch.isfinite(x).all()), f"{key}: solve not finite"
        out[key] = launches
        del fact, x
    return out


# -- phase 12: health checks on the main path ------------------------------------------


def check_phase(op, fact, opts, t_plain: float) -> dict:
    """``check=True`` on the main path's default left Cholesky: the factor
    within 1e-12 of the unchecked one (``fact``), no health event, every
    column checked. Logs the bitwise status and the clean-path overhead
    against the unchecked factorization's warm time."""
    import dataclasses

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    fc, sec = sync_time(lambda: op.cholesky(
        dataclasses.replace(opts, check=True)))
    launches = ops.launch_counts()
    rel, same = factor_diff(fc, fact)
    h = fc.stats["health"]
    log(f"main_check: factor {sec:.3f} s (unchecked, warm: {t_plain:.3f} s; "
        f"overhead {sec - t_plain:+.3f} s); against check=False max rel "
        f"diff {rel:.3e} (gate 1e-12), bitwise {'yes' if same else 'no'}; "
        f"columns_checked {h['columns_checked']}, events {h['events']}, "
        f"check seconds {fc.stats['schedule']['kind_seconds'].get('check', 0):.3f}; "
        f"launches {json.dumps(launches)}")
    for name in MAIN_KERNELS:
        assert launches[name] > 0, f"kernel {name} was not launched by " \
            "main_check"
    assert rel <= 1e-12, f"main_check: factor differs by {rel:.3e}"
    assert h["events"] == [] and h["columns_checked"] == op.nb
    return {"main_check": launches}


# -- phase 13: the TLR inference server -----------------------------------------


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| of two host arrays."""
    import numpy as np
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def drive_server(label: str, srv, reqs, t_warm: float, faults_=()) -> dict:
    """Submit ``reqs`` to the warm server ``srv`` and drain it, with the
    kernels' launch counts set to 0 just before and read just after, and
    the ``trace_counts`` registry snapshot taken after warmup. Gates: every
    rid completes exactly once and no new dispatch shape appears. Logs
    warmup seconds, ticks, occupancy, requests/s, p50 / p99 per kind, peak
    memory and the kernels' launches during the drain."""
    import torch
    from repro_torch import faults
    from repro_torch.core import trace_counts, trace_counts_diff
    from repro_torch.kernels import ops
    from repro_torch.serve import KINDS

    snap = trace_counts()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [srv.submit(r) for r in reqs]
    with (faults.inject(*faults_) if faults_ else contextlib.nullcontext()):
        results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    new_shapes = trace_counts_diff(snap)
    st = srv.stats
    summ = st.summary()
    lat = {k: summ[f"latency_{k}"] for k in KINDS if f"latency_{k}" in summ}
    log(f"{label}: warmup {t_warm:.3f} s; {st.completed} requests in "
        f"{st.ticks} ticks, drain {wall:.3f} s ({st.completed / wall:.1f} "
        f"requests/s; tick seconds {summ['wall_s']:.3f}, "
        f"{summ['requests_per_s']:.1f} requests/s), occupancy "
        f"{st.occupancy():.4f}, slots active per tick {st.tick_active}")
    log(f"{label}: latency ms p50 / p99 per kind: " + ", ".join(
        f"{k} {v['p50_s'] * 1e3:.2f} / {v['p99_s'] * 1e3:.2f} "
        f"({v['count']})" for k, v in lat.items()))
    log(f"{label}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; health {json.dumps(summ['health'])}; kernel launches during "
        f"the drain {json.dumps(launches)}; trace registry "
        f"{json.dumps(trace_counts())}, new shapes {json.dumps(new_shapes)}")
    assert sorted(results) == sorted(rids) == list(range(len(reqs))), \
        f"{label}: not every request completed"
    assert st.completed == len(reqs), f"{label}: a request completed twice"
    assert new_shapes == {}, f"{label}: new dispatch shapes {new_shapes}"
    return {"results": results, "launches": launches, "wall": wall,
            "stats": summ}


def serve_main_phase(op, fact, K) -> dict:
    """The server on the main path's operator and factor:
    ``fact.serve(operator=op, slots=SERVE_SLOTS, check_every=4)``, the 64
    requests of ``serve_requests``, one solve column poisoned by a
    ``serve.solve`` fault. Gates: each solve within 1e-10 of
    ``fact.solve`` on its column, each sample within 1e-10
    of ``fact.sample(z=draw)``, logdet equal to the memoized value, each
    pcg_solve converged with ``||K x - b|| / ||b|| < 1e-5``, the poisoned
    rid a ``nonfinite_result``, and ``drive_server``'s. Logs whether the
    batched solves and the first pcg_solve equal their sequential runs bit
    for bit."""
    import numpy as np
    import torch
    from repro_torch import faults, pcg
    from repro_torch.serve import KINDS

    n = fact.n
    torch.cuda.reset_peak_memory_stats()
    srv, t_warm = sync_time(lambda: fact.serve(
        operator=op, slots=SERVE_SLOTS, check_every=SERVE_CHECK))
    reqs = serve_requests(n)
    poisoned = len(KINDS)           # the second solve request's rid
    out = drive_server("serve cov2d-32k", srv, reqs, t_warm, (faults.Fault(
        site="serve.solve", rid=poisoned),))
    results = out["results"]
    bad = results[poisoned]
    assert not bad.ok and bad.error == "nonfinite_result", \
        f"serve: poisoned rid {poisoned} ended as {bad.error}"
    memo = srv._residents["default"].logdet
    errs = {k: 0.0 for k in KINDS}
    bitwise = {"solve": True}
    for r in reqs:
        res = results[r.rid]
        if r.rid == poisoned:
            continue
        assert res.ok, f"serve: rid {r.rid} ({r.kind}) failed: {res.error}"
        if r.kind == "solve":
            want = fact.solve(torch.as_tensor(r.rhs, device="cuda")).cpu()
            errs["solve"] = max(errs["solve"], rel_err(res.value,
                                                       want.numpy()))
            bitwise["solve"] &= bool(np.array_equal(res.value, want.numpy()))
        elif r.kind == "sample":
            z = torch.randn((n, 1), generator=r.sample_generator(),
                            dtype=fact.dtype)
            want = fact.sample(z=z.to("cuda")).cpu().numpy()
            errs["sample"] = max(errs["sample"], rel_err(res.value, want))
        elif r.kind == "logdet":
            assert res.value == memo, "serve: logdet differs from the memo"
        else:
            assert res.converged and res.breakdown is None, \
                f"serve: pcg_solve rid {r.rid} did not converge"
            x = torch.as_tensor(res.value, device="cuda")
            b = torch.as_tensor(r.rhs, device="cuda")
            errs["pcg_solve"] = max(errs["pcg_solve"], float(
                (K @ x - b).norm() / b.norm()))
    first = next(r for r in reqs if r.kind == "pcg_solve")
    xs, its, _ = pcg(op, torch.as_tensor(first.rhs, device="cuda"),
                     precond=fact, tol=first.tol, maxiter=first.maxiter,
                     check_every=SERVE_CHECK)
    bitwise["pcg_solve"] = bool(np.array_equal(results[first.rid].value,
                                               xs.cpu().numpy()))
    iters = sorted(results[r.rid].iterations for r in reqs
                   if r.kind == "pcg_solve")
    logdet_now = float(fact.logdet())
    log(f"serve cov2d-32k: solve max rel err {errs['solve']:.3e} (gate "
        f"1e-10), sample {errs['sample']:.3e} (gate 1e-10), logdet memo "
        f"{memo!r} (a fresh fact.logdet() {logdet_now!r}), pcg_solve "
        f"iterations {iters}, max ||Kx - b||/||b|| {errs['pcg_solve']:.3e} "
        f"(gate 1e-5); poisoned rid {poisoned}: {bad.error}, every other "
        f"request ok; batched vs sequential bit for bit: solve "
        f"{'yes' if bitwise['solve'] else 'no'}, pcg_solve rid {first.rid} "
        f"{'yes' if bitwise['pcg_solve'] else 'no'} (scalar {its} "
        f"iterations, batched {results[first.rid].iterations})")
    assert errs["solve"] <= 1e-10, "serve: a solve differs from fact.solve"
    assert errs["sample"] <= 1e-10, "serve: a sample differs from fact.sample"
    assert errs["pcg_solve"] < 1e-5, "serve: a pcg_solve is far from K^-1 b"
    del srv
    return {"serve": out["launches"]}


def serve_frac_phase(op, K, eps: float) -> dict:
    """The server on the frac pcg path's compressed operator with the loose
    Cholesky of ``tlr_add_diag(op.A, eps)`` as preconditioner, factored
    here again (as that path factors it, after its launch counts were
    read, so that no earlier phase holds two factors at once;
    benchmarks/bench_tlr.py::bench_serve's shape at the paper's section
    6.2 size): FRAC_SERVE_REQUESTS pcg_solve requests (tol 1e-6, maxiter
    300, rhs from ``default_rng(1)``) into SERVE_SLOTS slots, so columns
    refill mid-flight. Gates: every request converges with ``||K x - b|| /
    ||b|| < 1e-5``, the first two within 2 iterations of scalar ``pcg`` on
    the same rhs, occupancy >= 0.8, and ``drive_server``'s. Logs whether
    the batched and scalar iterates agree bit for bit."""
    import numpy as np
    import torch
    from repro_torch import CholOptions, TLROperator, pcg
    from repro_torch.core import tlr_add_diag
    from repro_torch.serve import ServeRequest

    n = op.n
    torch.cuda.reset_peak_memory_stats()
    fact, t_fact = sync_time(lambda: TLROperator(
        tlr_add_diag(op.A, eps)).cholesky(CholOptions(eps=eps, bs=16)))
    log(f"serve {FRAC_CELL}: resident Cholesky at eps={eps:g} in "
        f"{t_fact:.3f} s")
    srv, t_warm = sync_time(lambda: fact.serve(
        operator=op, slots=SERVE_SLOTS, check_every=SERVE_CHECK))
    rng = np.random.default_rng(1)
    reqs = [ServeRequest("pcg_solve", rhs=rng.standard_normal(n), tol=1e-6,
                         maxiter=300) for _ in range(FRAC_SERVE_REQUESTS)]
    out = drive_server(f"serve {FRAC_CELL}", srv, reqs, t_warm)
    results = out["results"]
    worst = 0.0
    for r in reqs:
        res = results[r.rid]
        assert res.ok and res.converged, \
            f"serve frac: rid {r.rid} did not converge ({res.breakdown})"
        x = torch.as_tensor(res.value, device="cuda")
        b = torch.as_tensor(r.rhs, device="cuda")
        worst = max(worst, float((K @ x - b).norm() / b.norm()))
    scalar = []
    for r in reqs[:2]:
        (xs, its, _), t_s = sync_time(lambda: pcg(
            op, torch.as_tensor(r.rhs, device="cuda"), precond=fact,
            tol=r.tol, maxiter=r.maxiter, check_every=SERVE_CHECK))
        res = results[r.rid]
        scalar.append((its, res.iterations, t_s, bool(np.array_equal(
            res.value, xs.cpu().numpy())), rel_err(res.value,
                                                   xs.cpu().numpy())))
    iters = [results[r.rid].iterations for r in reqs]
    occ = out["stats"]["occupancy"]
    log(f"serve {FRAC_CELL}: pcg_solve iterations {iters}, max "
        f"||Kx - b||/||b|| {worst:.3e} (gate 1e-5), occupancy {occ:.4f} "
        f"(gate 0.8); first two against scalar pcg (iterations scalar / "
        f"batched, scalar seconds, bit for bit, rel diff): " + "; ".join(
            f"{a} / {b}, {t:.3f} s, {'yes' if same else 'no'}, {d:.3e}"
            for a, b, t, same, d in scalar))
    assert worst < 1e-5, "serve frac: a pcg_solve is far from K^-1 b"
    for its, it_b, *_ in scalar:
        assert abs(its - it_b) <= 2, \
            f"serve frac: batched {it_b} iterations, scalar {its}"
    assert occ >= 0.8, f"serve frac: occupancy {occ:.3f} < 0.8"
    del srv
    return {"frac_serve": out["launches"]}


# -- phase 14: the fault matrix ------------------------------------------------------


def spike_scale(b: int, r: int, R: int, seed: int) -> tuple[float, float]:
    """The ``scale`` of ``faults.spike_rank(..., seed=seed)`` (an r-wide
    factor pair on a b-row tile) that puts the spike's (R+1)-th singular
    value at 2e-6 -- over eps = 1e-6, so a factorization capped at rank R
    overflows there -- and the norm of its singular values past R at that
    scale (within the policy's eps floor, 1.6e-5, so a remedy can accept
    it). The pair is numpy's draw, as the mutator makes it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    Us, Vs = rng.standard_normal((b, r)), rng.standard_normal((b, r))
    s = np.linalg.svd(Us @ Vs.T, compute_uv=False)
    scale = math.sqrt(2e-6 / s[R])
    return scale, float(np.sqrt((s[R:] ** 2).sum())) * scale ** 2


def fault_phase(op, natural_rank: int) -> dict:
    """The fault matrix of tests/test_health.py on the cov2d-8k-right
    operator, ``check=True``, each case on the drivers the JAX package's
    test runs it on: an indefinite diagonal tile at column nb - 2 recovers
    (left, right, right with lookahead) with spd_breakdown events at its
    column and finite factors (at column 2 the right driver either ends
    with finite factors or raises a breakdown: logged); a rank spike under ``r_max_out`` recovers on the left
    (an eps_loosen remedy) and is accepted on the right; a NaN diagonal
    tile raises ``FactorizationBreakdown(spd_breakdown)`` at its column and
    a NaN panel ``FactorizationBreakdown(nonfinite_panel)`` at its column
    (left, right). A breakdown that does not come, or comes with another
    reason or column, fails the run. The cap ``r_max_out`` is the operator's
    natural L rank rounded up past 16 more (a multiple of bs = 16), and the
    spike at tile (4, 0) -- the first panel sees it bare -- is scaled by
    ``spike_scale``."""
    import torch
    from repro_torch import CholOptions, faults
    from repro_torch.core import FactorizationBreakdown, tlr_cholesky
    from repro_torch.kernels import ops

    A = op.A
    drivers = {"left": dict(algo="left"), "right": dict(algo="right"),
               "right-lookahead": dict(algo="right", lookahead=True)}
    R = 16 * math.ceil((natural_rank + 17) / 16)
    scale, tail = spike_scale(A.b, A.r_max, R, seed=3)
    log(f"fault phase: natural L rank {natural_rank}, cap r_max_out {R}; "
        f"spike at tile (4, 0) scale {scale:.4e}: singular value {R + 1} "
        f"2e-6, norm past {R} {tail:.3e} (eps floor 1.6e-05)")
    assert R < A.r_max and tail <= 1.6e-5 / 2
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    def finite(fact):
        return all(bool(torch.isfinite(x).all())
                   for x in (fact.L.D, fact.L.U, fact.L.V))

    def summary(events):
        return [(e["kind"], e["column"], e["stage"], e["remedy"],
                 e["attempt"]) for e in events]

    k_ind = A.nb - 2
    bad = faults.make_diag_indefinite(A, k_ind, magnitude=4.0)
    for name, kw in drivers.items():
        fact, sec = sync_time(lambda: tlr_cholesky(
            bad, CholOptions(eps=EPS, check=True, **kw)))
        ev = fact.stats["health"]["events"]
        log(f"fault indefinite diag {k_ind}, {name}: recovered in "
            f"{sec:.3f} s, events {summary(ev)}")
        spd = [e for e in ev if e["kind"] == "spd_breakdown"]
        assert finite(fact) and spd \
            and any(e["column"] == k_ind for e in spd) \
            and all(e["remedy"] in ("clamp", "jitter") for e in spd), \
            f"indefinite diagonal, {name}: not recovered as expected"
        del fact
    # The same fault at column 2: the clamp leaves L(2,2) with eps-sized
    # singular values, so L(i,2) and every later Schur update grow by
    # ~1/eps a clamped column, and each later diagonal tile is clamped in
    # turn. Either the run ends with finite factors or it raises a
    # structured breakdown -- never non-finite factors.
    try:
        fact, sec = sync_time(lambda: tlr_cholesky(
            faults.make_diag_indefinite(A, 2, magnitude=4.0),
            CholOptions(eps=EPS, check=True, algo="right")))
    except FactorizationBreakdown as e:
        rep = e.report
        log(f"fault indefinite diag 2, right: breakdown {rep.reason} at "
            f"column {rep.column} ({rep.stage}), remedies {rep.remedies}")
    else:
        clamps = sum(e["remedy"] == "clamp"
                     for e in fact.stats["health"]["events"])
        log(f"fault indefinite diag 2, right: finite factors in {sec:.3f} s "
            f"after {clamps} clamped diagonal tiles")
        assert finite(fact)
        del fact
    spiked = faults.spike_rank(A, 4, 0, seed=3, scale=scale)
    for name, want in (("left", {"eps_loosen"}), ("right", {"accept"})):
        fact, sec = sync_time(lambda: tlr_cholesky(spiked, CholOptions(
            eps=EPS, r_max_out=R, check=True, **drivers[name])))
        over = [e for e in fact.stats["health"]["events"]
                if e["kind"] == "rank_overflow"]
        log(f"fault rank spike (4, 0), {name}: {sec:.3f} s, rank_overflow "
            f"events {summary(over)}, rows "
            f"{[e['detail'].get('rows') for e in over]}")
        assert finite(fact) and over and any(e["column"] == 0 for e in over)
        if name == "left":
            assert want <= {e["remedy"] for e in over}
        else:
            assert {e["remedy"] for e in over} == want
        del fact
    for site, column, reason in (("chol.diag", 2, "spd_breakdown"),
                                 ("chol.panel", 1, "nonfinite_panel")):
        for name in ("left", "right"):
            fault = faults.Fault(site=site, kind="nan", column=column)
            try:
                with faults.inject(fault):
                    tlr_cholesky(A, CholOptions(eps=EPS, check=True,
                                                **drivers[name]))
            except FactorizationBreakdown as e:
                rep = e.report
            else:
                raise AssertionError(f"NaN {site} at column {column}, "
                                     f"{name}: no breakdown raised")
            log(f"fault NaN {site} column {column}, {name}: breakdown "
                f"{rep.reason} at column {rep.column} ({rep.stage}), "
                f"remedies {rep.remedies}")
            assert (rep.reason, rep.column) == (reason, column), \
                f"NaN {site}, {name}: breakdown {rep.reason} at column " \
                f"{rep.column}, expected {reason} at {column}"
            if site == "chol.diag":
                assert "jitter" in rep.remedies
    launches = ops.launch_counts()
    log(f"fault phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(launches)}")
    for name in KERNELS:
        assert launches[name] > 0, f"kernel {name} was not launched by " \
            "the fault matrix"
    return {"faults": launches}


# -- phase 15: telemetry (repro_torch.obs) -----------------------------------------


def chrome_trace_schema(obj) -> None:
    """The schema check of tests/test_obs.py (the part of the Trace Event
    Format Perfetto validates): the object form, ph / pid / tid / name on
    every event, ts + dur on complete events, JSON throughout."""
    assert isinstance(obj, dict) and isinstance(obj["traceEvents"], list)
    json.dumps(obj)
    for ev in obj["traceEvents"]:
        assert ev["ph"] in ("X", "C", "M")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert isinstance(ev["name"], str)
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
        if ev["ph"] == "M":
            assert ev["name"] in ("process_name", "thread_name")
            assert isinstance(ev["args"]["name"], str)


# The port's kernels by the prefix of their device function names
# (templates are named with their return type, plain functions without).
KERNEL_PREFIXES = {"bgemm": "batched_gemm", "tile_chain": "tile_chain",
                   "lr_sample": "lr_sample", "mgs_qr": "batched_qr",
                   "jacobi_svd": "small_svd"}


def kernel_family(name: str) -> str | None:
    key = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    for prefix, family in KERNEL_PREFIXES.items():
        if key.startswith(prefix):
            return family
    return None


def profile_spans(fn) -> tuple:
    """Runs ``fn`` under torch.profiler (CPU and CUDA activities) and reads
    its Chrome trace: every device kernel, with the host time of the
    runtime call that launched it (matched by correlation id), against the
    span user ranges (``record_function``) on the host timeline. Returns
    ``(out, seconds, spans, kernels)``: span name -> sorted host
    intervals, and (kernel name, host launch time or None, device us) per
    kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out, sec = sync_time(fn)
        t1 = time.perf_counter()
        path = Path(tmp) / "profile.json"
        prof.export_chrome_trace(str(path))
        size = path.stat().st_size
        t2 = time.perf_counter()
        events = json.loads(path.read_text())["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    log(f"profile trace: {size} bytes; profiled run and stop "
        f"{t1 - t0:.3f} s, export {t2 - t1:.3f} s, read "
        f"{time.perf_counter() - t2:.3f} s; events per category "
        + json.dumps(dict(collections.Counter(
            e.get("cat") for e in xs).most_common())))
    spans = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation":
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [(e["name"], launch_ts.get(e.get("args", {}).get(
        "correlation")), e["dur"]) for e in xs if e.get("cat") == "kernel"]
    for v in spans.values():
        v.sort()
    return out, sec, dict(spans), kernels


def inside(t: float, intervals: list) -> bool:
    """Whether host time ``t`` falls in one of the sorted ``intervals``."""
    import bisect
    i = bisect.bisect_right(intervals, (t, math.inf)) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def serve_requests(n: int) -> list:
    """SERVE_REQUESTS requests cycling through ``KINDS`` (rhs from
    ``default_rng(0)``, pcg_solve tol 10^-U{4..8}, maxiter 100, as
    examples/serve_gp.py)."""
    import numpy as np
    from repro_torch.serve import KINDS, ServeRequest
    rng = np.random.default_rng(0)
    reqs = []
    for u in range(SERVE_REQUESTS):
        kind = KINDS[u % len(KINDS)]
        y = rng.standard_normal(n) if kind in ("solve", "pcg_solve") else None
        reqs.append(ServeRequest(kind, rhs=y, tol=10.0 ** -rng.integers(4, 9),
                                 maxiter=100, seed=u))
    return reqs


def telemetry_phase(op, fact, opts) -> dict:
    """The telemetry layer on the main path's operator (cov2d-32k).

    1. The default left Cholesky with telemetry off, then on (the same
       probe seed). Gates: L's D, U, V and ranks bitwise equal, equal
       kernel launches, no new dispatch shape, ``chol.diag`` nb times and
       ``chol.panel`` nb - 1 times in ``stats["telemetry"]``, and the
       enabled run within 1.25x the disabled one + 0.1 s.
    2. The recording exported as a Chrome trace (a temporary file), held
       to the schema check of tests/test_obs.py.
    3. The enabled factorization once more under torch.profiler: the span
       user ranges ``chol.factorize`` and ``chol.panel`` appear, and every
       ``lr_sample`` and ``tile_chain`` kernel was launched inside a
       ``chol.panel`` range on the host timeline. Logs the device ms of
       the kernels launched inside each span name.
    4. The serve cov2d-32k drain (no fault) with telemetry on: one
       ``serve.tick`` span a tick, the ``occupancy`` counter,
       ``summary()["telemetry"]``, no kernel launch and no new dispatch
       shape.
    5. The cost of one disabled span on this host."""
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.core import trace_counts, trace_counts_diff
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    nb = op.nb
    ops.reset_launch_counts()
    off, t_off = sync_time(lambda: op.cholesky(opts))
    launches_off = ops.launch_counts()
    snap = trace_counts()
    ops.reset_launch_counts()
    obs.enable()
    on, t_on = sync_time(lambda: op.cholesky(opts))
    tel = obs.disable()
    launches = ops.launch_counts()
    new_shapes = trace_counts_diff(snap)
    rel, same = factor_diff(on, off)
    snap_on = on.stats["telemetry"]
    ph = snap_on["phases"]
    log(f"telemetry cov2d-32k: left Cholesky off {t_off:.3f} s, on "
        f"{t_on:.3f} s (x{t_on / t_off:.3f}; gate 1.25x + 0.1 s); "
        f"{len(tel.spans)} spans ({snap_on['spans']} under chol.factorize), "
        f"per name " + json.dumps({k: v["count"] for k, v in ph.items()})
        + f"; bitwise {'yes' if same else 'no'} (max rel {rel:.3e}); "
        f"launches off {json.dumps(launches_off)}, on {json.dumps(launches)}"
        f"; new dispatch shapes {json.dumps(new_shapes)}")
    log("telemetry cov2d-32k: span seconds per name (host) " + json.dumps(
        {k: round(v["seconds"], 4) for k, v in ph.items()}))
    assert same, "telemetry changed the left factor"
    assert launches == launches_off, "telemetry changed the kernel launches"
    assert new_shapes == {}, f"telemetry added dispatch shapes {new_shapes}"
    assert ph["chol.diag"]["count"] == nb \
        and ph["chol.panel"]["count"] == nb - 1, "span counts"
    assert t_on <= 1.25 * t_off + 0.1, "telemetry overhead above its gate"
    del off

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "telemetry.json"
        obj = obs.export_chrome_trace(str(path), tel)
        size = path.stat().st_size
    chrome_trace_schema(obj)
    log(f"telemetry cov2d-32k: Chrome trace {len(obj['traceEvents'])} "
        f"events, {size} bytes; schema check held")

    obs.enable()
    prof_fact, t_prof, ranges, kernels = profile_spans(
        lambda: op.cholesky(opts))
    obs.disable()
    assert {"chol.factorize", "chol.panel"} <= set(ranges), \
        f"span user ranges missing from the profile: {sorted(ranges)}"
    ms_by_span = {name: 0.0 for name in ranges}
    ms_by_family = collections.Counter()
    outside, unmatched, sampled = [], 0, 0
    for name, t_launch, dur in kernels:
        fam = kernel_family(name)
        if fam:
            ms_by_family[fam] += dur / 1e3
        if t_launch is None:
            unmatched += 1
            if fam in ("lr_sample", "tile_chain"):
                outside.append(name)
            continue
        for span, iv in ranges.items():
            if inside(t_launch, iv):
                ms_by_span[span] += dur / 1e3
        if fam in ("lr_sample", "tile_chain"):
            sampled += 1
            if not inside(t_launch, ranges["chol.panel"]):
                outside.append(name)
    log(f"telemetry cov2d-32k profile: {t_prof:.3f} s under the profiler, "
        f"{len(kernels)} device kernels ({unmatched} without a launch "
        f"record), user ranges " + json.dumps(
            {k: len(v) for k, v in sorted(ranges.items())})
        + f"; lr_sample + tile_chain launches {sampled}, outside chol.panel "
        f"{len(outside)}")
    log("telemetry cov2d-32k profile: device ms of the kernels launched "
        "inside each span name (nested names overlap) " + json.dumps(
            {k: round(v, 3) for k, v in sorted(ms_by_span.items())})
        + "; the port's kernels " + json.dumps(
            {k: round(v, 3) for k, v in sorted(ms_by_family.items())}))
    assert sampled > 0 and not outside, \
        f"{len(outside)} sampling kernels outside chol.panel ranges"
    del prof_fact

    srv, t_warm = sync_time(lambda: fact.serve(
        operator=op, slots=SERVE_SLOTS, check_every=SERVE_CHECK))
    obs.enable()
    out = drive_server("telemetry serve cov2d-32k", srv,
                       serve_requests(fact.n), t_warm)
    stel = obs.disable()
    summ = out["stats"]
    ticks = sum(s.name == "serve.tick" for s in stel.spans)
    occ = [c for c in stel.counters if c[0] == "occupancy"]
    log(f"telemetry serve cov2d-32k: {ticks} serve.tick spans for "
        f"{summ['ticks']} ticks, {len(occ)} occupancy samples; serve span "
        f"seconds " + json.dumps({k: round(v["seconds"], 4) for k, v in
                                  summ["telemetry"]["phases"].items()}))
    assert ticks == summ["ticks"] and len(occ) == summ["ticks"]
    assert "telemetry" in summ
    assert all(v == 0 for v in out["launches"].values()), \
        "the serve drain launched kernels"
    del srv

    reps = 200_000
    t0 = time.perf_counter()
    for _ in range(reps):
        with obs.span("x", cat="factor"):
            pass
    per = (time.perf_counter() - t0) / reps
    log(f"telemetry: one disabled span costs {per * 1e9:.1f} ns on this host "
        f"(over {reps} spans); phase {time.perf_counter() - t_phase:.1f} s")
    return {"telemetry": launches, "telemetry_serve": out["launches"]}


def telemetry_right_phase(op) -> dict:
    """Telemetry on the right path's operator (cov2d-8k-right): the ranked
    right Cholesky, sequential and with ``lookahead=True``, and the flat
    sequential one, each with telemetry off and then on. Gates: the
    ``chol.flush``, ``chol.syrk`` and ``algebra.syrk_column`` spans appear,
    ``round.bucket`` on the ranked runs and ``algebra.round_tiles`` on the
    flat one (the ranked path rounds through the bucket cores, in both
    packages), one ``chol.flush`` span per flush, and the factor bitwise
    equal to the run with telemetry off."""
    import dataclasses

    from repro_torch import CholOptions, obs
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    out = {}
    base = CholOptions(eps=EPS, algo="right", batching="ranked")
    for key, opts, want in (
            ("ranked", base, "round.bucket"),
            ("ranked_lookahead", dataclasses.replace(base, lookahead=True),
             "round.bucket"),
            ("flat", dataclasses.replace(base, batching="flat"),
             "algebra.round_tiles")):
        off, t_off = sync_time(lambda: op.cholesky(opts))
        ops.reset_launch_counts()
        obs.enable()
        on, t_on = sync_time(lambda: op.cholesky(opts))
        tel = obs.disable()
        launches = ops.launch_counts()
        counts = collections.Counter(s.name for s in tel.spans)
        rel, same = factor_diff(on, off)
        log(f"telemetry right {key}: off {t_off:.3f} s, on {t_on:.3f} s; "
            f"spans {json.dumps(dict(sorted(counts.items())))}; flushes "
            f"{on.stats['flushes']}; bitwise {'yes' if same else 'no'} (max "
            f"rel {rel:.3e}); launches {json.dumps(launches)}")
        assert {"chol.flush", "chol.syrk", "algebra.syrk_column",
                want} <= set(counts), f"telemetry right {key}: spans"
        assert counts["chol.flush"] == on.stats["flushes"]
        assert same, f"telemetry right {key}: factor differs"
        out[f"telemetry_right_{key}"] = launches
        del off, on
    log(f"telemetry right: phase {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 16: mixed-precision storage (compress(store_dtype=)) ------------------


@contextlib.contextmanager
def dtype_log():
    """While open, counts the sampling and rounding kernels' calls per
    (kernel, dtype) of their first operand (installed by the smoke only)."""
    from repro_torch.kernels import ops
    counts = collections.Counter()
    names = ("batched_gemm", "tile_chain", "lr_sample", "batched_qr")
    inner = {name: getattr(ops, name) for name in names}

    def wrap(name):
        def call(*args, **kw):
            counts[(name, str(args[0].dtype).removeprefix("torch."))] += 1
            return inner[name](*args, **kw)
        return call
    for name in names:
        setattr(ops, name, wrap(name))
    try:
        yield counts
    finally:
        for name in names:
            setattr(ops, name, inner[name])


def mixed_phase(op, K, Z) -> dict:
    """The paper's section 7 mixed-precision storage on the right path's K
    (N = 8192, tile 128): ``TLROperator.compress(K, 128, 128, 1e-8,
    store_dtype=torch.float32)``. Gates (tests/test_mixed_precision.py):
    the logical low-rank bytes half those of the f64 operator ``op`` (the
    same compression in f64), ``op @ x`` within 1e-4 of ``K x``
    (relative), and the default left Cholesky at eps 1e-5, bs 8 meets the
    randomized residual gate (100 eps) with a solve error below 1e-2. Logs
    the compress and factor seconds and the kernels' launches per dtype:
    they run in f64 on the promoted factors."""
    import torch
    from repro_torch import CholOptions, TLROperator
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    eps = 1e-5
    ops.reset_launch_counts()
    with dtype_log() as by_dtype:
        op32, t_comp = sync_time(lambda: TLROperator.compress(
            K, TILE_RIGHT, TILE_RIGHT, 1e-8, store_dtype=torch.float32))
        fact, t_fact = sync_time(lambda: op32.cholesky(
            CholOptions(eps=eps, bs=8)))
    launches = ops.launch_counts()
    m32, m64 = op32.memory_stats(), op.memory_stats()
    g = torch.Generator(device=K.device).manual_seed(5)
    x = torch.randn((op.n,), generator=g, device=K.device, dtype=K.dtype)
    Kx = K @ x
    mv = float((op32 @ x - Kx).norm() / Kx.norm())
    resid = left_residual(K, fact, Z)
    sol = float((fact.solve(Kx) - x).norm() / x.norm())
    log(f"mixed f32 storage: compress {t_comp:.3f} s (U/V "
        f"{m32['store_dtype']}, D {m32['compute_dtype']}), low-rank bytes "
        f"{m32['lowrank_bytes_logical']} against f64 "
        f"{m64['lowrank_bytes_logical']}, ranks equal "
        f"{'yes' if torch.equal(op32.ranks, op.ranks) else 'no'}; matvec rel "
        f"err {mv:.3e} (gate 1e-4); left Cholesky eps {eps:g} bs 8 in "
        f"{t_fact:.3f} s, L {str(fact.L.U.dtype).removeprefix('torch.')}, "
        f"residual {resid:.3e} (gate {100 * eps:.0e}), solve rel err "
        f"{sol:.3e} (gate 1e-2); kernel calls per dtype "
        + json.dumps({f"{k} {d}": c for (k, d), c in sorted(
            by_dtype.items())}) + f"; launches {json.dumps(launches)}")
    assert 2 * m32["lowrank_bytes_logical"] == m64["lowrank_bytes_logical"]
    assert mv <= 1e-4, "mixed matvec disagrees with K"
    assert resid <= 100 * eps, "mixed factor residual above 100 eps"
    assert sol < 1e-2, "mixed solve error"
    for name in MAIN_KERNELS:
        assert launches[name] > 0, f"kernel {name} not launched (mixed)"
    assert all(d == "float64" for _, d in by_dtype), \
        "a kernel ran below the working precision"
    log(f"mixed f32 storage: phase {time.perf_counter() - t_phase:.1f} s")
    return {"mixed": launches}


# -- phase 18: the dense LM path (models, optim, train, checkpoint) -------------


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def d_step(tr, step: int, ccfg, params, ostate, cstate):
    """One step of ``Trainer._run`` with compressed gradients, without its
    checkpointing: (loss, params, ostate, cstate, compression stats)."""
    import torch
    from repro_torch.optim import compress_grads
    from repro_torch.train.trainer import step_generator
    batch = {k: torch.from_numpy(v).to(tr.device)
             for k, v in tr.data.batch_at(step).items()}
    loss, grads, _ = tr.fwd_bwd(params, batch)
    grads, cstate, stats = compress_grads(
        grads, cstate, ccfg, step_generator(tr.tcfg.seed, step, tr.device))
    params, ostate = tr.apply(grads, ostate, params)
    return loss, params, ostate, cstate, stats


def lm_train_phase(cfg, work: Path, dev: str = "cuda") -> dict:
    """Path 13 (a): ``Trainer`` runs on the card at ``cfg``'s full width,
    each in its own directory under ``work``, each saving once, at its end
    (``save_every`` past its steps: the loop's save at a multiple of
    ``save_every`` would repeat the final one), with ``keep=1``. Run A:
    LM_STEPS steps, every loss finite and the last below the first. Run B:
    LM_SPLIT steps; its checkpoint restored bitwise equal to its final
    (params, AdamW state). Run C: LM_STEPS on B's directory, resumed at
    LM_SPLIT, each loss within 2e-2 relative of run A's at that step (the
    bf16 embedding backward sums with atomics, so the runs are not
    bitwise). Run D: LM_COMPRESS_STEPS more steps from run C's state
    through the trainer's step (``d_step``, no checkpoint) with
    ``CompressConfig(rank=8)``: finite losses, ``ratio > 1``, and the
    compressed leaves those of the JAX package's rule: the 2-D ones (the
    embedding, the stacked biases and norm scales), none of the stacked
    3-D projections.
    Each run must put back the SIGTERM / SIGINT handlers it installed. Logs
    step seconds, tokens/s, peak memory, and the checkpoints' bytes and
    save / restore seconds. Returns the launches and run C's parameters."""
    import shutil
    import signal
    import numpy as np
    import torch
    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
    from repro_torch.kernels import ops
    from repro_torch.optim import CompressConfig, compress_init
    from repro_torch.optim.tlr_newton import _leaf_names
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.tree import leaves

    sigs = (signal.SIGTERM, signal.SIGINT)
    handlers = [signal.getsignal(s) for s in sigs]
    saves = []
    inner = trainer_mod.save_checkpoint

    def timed_save(directory, step, tree, **kw):
        path, sec = sync_time(lambda: inner(directory, step, tree, **kw))
        saves.append((step, sec, dir_bytes(path)))
        return path

    def run(name: str, steps: int, ckpt: str | None = None,
            compress=None):
        d = work / (ckpt or name)
        tcfg = TrainConfig(steps=steps, batch=LM_BATCH, seq_len=LM_SEQ,
                           ckpt_dir=str(d), save_every=10**9, log_every=1,
                           keep=1, seed=0, compress=compress,
                           metrics_path=str(work / f"{name}.jsonl"))
        tr = Trainer(cfg, tcfg, device=dev)
        torch.cuda.reset_peak_memory_stats()
        n_saves = len(saves)
        try:
            res, sec = sync_time(tr.run)
        finally:
            tr.close()
        assert [signal.getsignal(s) for s in sigs] == handlers, \
            f"lm run {name}: Trainer.run left its signal handlers installed"
        peak = torch.cuda.max_memory_allocated()
        dts = [json.loads(x)["dt"] for x in
               (work / f"{name}.jsonl").read_text().splitlines()
               if json.loads(x)["event"] == "step"]
        losses = res["losses"]
        tok_s = LM_BATCH * LM_SEQ / float(np.median(dts[1:] or dts))
        save = saves[n_saves:]
        log(f"lm run {name}: {res['status']} at step {res['step']} "
            f"(resumed from {tr.resumed_from}) in {sec:.2f} s; losses "
            f"{[round(x, 4) for x in losses]}; step seconds "
            f"{[round(x, 3) for x in dts]}; {tok_s:.0f} tokens/s (median "
            f"step after the first); peak {peak / 2**30:.2f} GiB; saves "
            f"(step, s, bytes) {[(st, round(t, 2), b) for st, t, b in save]}")
        assert res["status"] == "done", f"lm run {name}: {res['status']}"
        assert all(math.isfinite(x) for x in losses), \
            f"lm run {name}: a loss is not finite"
        return tr, res, {"seconds": sec, "step_seconds": dts,
                         "tokens_per_s": tok_s, "peak": peak, "saves": save}

    trainer_mod.save_checkpoint = timed_save
    ops.reset_launch_counts()
    try:
        _, res_a, stats_a = run("A", LM_STEPS)
        la = res_a["losses"]
        assert la[-1] < la[0], f"lm run A: loss {la[0]} -> {la[-1]}"
        del res_a
        shutil.rmtree(work / "A")
        torch.cuda.empty_cache()

        _, res_b, stats_b = run("B", LM_SPLIT)
        tree_b = (res_b["params"], res_b["ostate"])
        ck = latest_checkpoint(work / "B")
        (step, got, _), t_restore = sync_time(
            lambda: restore_checkpoint(ck, tree_b))
        same = all(torch.equal(a, b) for a, b in zip(leaves(got),
                                                     leaves(tree_b)))
        log(f"lm run B: {ck.name} ({dir_bytes(ck)} bytes, "
            f"{len(leaves(tree_b))} leaves) restored in {t_restore:.2f} s, "
            f"bitwise {'yes' if same else 'no'}")
        assert step == LM_SPLIT and same, \
            "lm run B: the restored checkpoint differs from what was saved"
        del res_b, tree_b, got
        torch.cuda.empty_cache()

        tr_c, res_c, stats_c = run("C", LM_STEPS, ckpt="B")
        lc = res_c["losses"]
        rel_c = [abs(c - a) / abs(a) for c, a in zip(lc, la[LM_SPLIT:])]
        log(f"lm run C against A at steps {LM_SPLIT}..{LM_STEPS - 1}: "
            f"relative loss differences {[f'{x:.2e}' for x in rel_c]} "
            f"(gate 2e-2)")
        assert tr_c.resumed_from == LM_SPLIT, \
            f"lm run C resumed from {tr_c.resumed_from}, not {LM_SPLIT}"
        assert len(lc) == LM_STEPS - LM_SPLIT and max(rel_c) <= 2e-2, \
            "lm run C: losses differ from run A's"
        params = res_c["params"]
        shutil.rmtree(work / "B")
        torch.cuda.empty_cache()

        # run D: the trainer's own step (fwd_bwd, compress_grads, apply)
        # from run C's state, with no checkpoint (no gate reads one)
        ccfg = CompressConfig(rank=8)
        p_d, o_d, c_d = params, res_c["ostate"], compress_init(params, ccfg)
        torch.cuda.reset_peak_memory_stats()
        ld, dts = [], []
        for step in range(LM_STEPS, LM_STEPS + LM_COMPRESS_STEPS):
            (loss, p_d, o_d, c_d, cs), sec = sync_time(lambda: d_step(
                tr_c, step, ccfg, p_d, o_d, c_d))
            ld.append(float(loss))
            dts.append(sec)
        stats_d = {"step_seconds": dts,
                   "peak": torch.cuda.max_memory_allocated()}
        names = _leaf_names(params)
        compressed = [names[i] for i in cs["compressed"]]
        # the JAX package's rule: 2-D, at least min_size entries, both
        # sides above the rank; the stacked (R, width) biases and norm
        # scales are 2-D too, the stacked projections 3-D
        want = [name for name, x in zip(names, leaves(params))
                if x.ndim == 2 and x.numel() >= 64 * 64 and
                min(x.shape) > 8]
        log(f"lm run D (compress rank 8, steps {LM_STEPS}.."
            f"{LM_STEPS + LM_COMPRESS_STEPS - 1} from run C's state): losses "
            f"{[round(x, 4) for x in ld]}; step seconds "
            f"{[round(x, 3) for x in dts]}; peak "
            f"{stats_d['peak'] / 2**30:.2f} GiB; payload "
            f"{cs['payload_bytes']} of {cs['raw_bytes']} bytes, ratio "
            f"{cs['ratio']:.3f}; compressed leaves {compressed}")
        assert all(math.isfinite(x) for x in ld), \
            "lm run D: a loss is not finite"
        assert cs["ratio"] > 1, "lm run D: compression ratio not above 1"
        assert compressed == want and "emb/tok" in compressed, \
            f"lm run D: compressed {compressed}, not {want}"
        del res_c, p_d, o_d, c_d
    finally:
        trainer_mod.save_checkpoint = inner
    launches = ops.launch_counts()
    log(f"lm train: launches {json.dumps(launches)}")
    return {"params": params, "launches": launches,
            "runs": {"A": stats_a, "B": stats_b, "C": stats_c,
                     "D": stats_d}}


def serve_drain(label: str, cfg, params, dev: str = "cuda") -> dict:
    """``DecodeServer(slots=LM_SLOTS, max_len=LM_MAX_LEN)`` drains
    LM_REQUESTS greedy requests (prompts of 3 to LM_REQUESTS + 2 tokens) of
    LM_NEW tokens. Gates: every request completes once with LM_NEW
    in-vocabulary tokens; a second server gives the same tokens. Logs
    tokens/s, ticks and ms a tick."""
    import numpy as np
    from repro_torch.train import DecodeServer, Request

    V = cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, V, size=3 + i).tolist()
               for i in range(LM_REQUESTS)]

    def drain():
        srv = DecodeServer(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                           device=dev)
        reqs = [Request(prompt=p, max_new_tokens=LM_NEW, rid=i)
                for i, p in enumerate(prompts)]
        done, sec = sync_time(lambda: srv.run(reqs))
        return srv, {c.rid: c.tokens for c in done}, len(done), sec

    srv, toks, n_done, sec = drain()
    ticks = srv.ticks
    del srv
    ntok = sum(len(t) for t in toks.values())
    log(f"{label}: {n_done} completions, {ntok} tokens in {sec:.3f} s "
        f"({ntok / sec:.1f} tokens/s), {ticks} ticks "
        f"({1e3 * sec / ticks:.2f} ms a tick), {LM_SLOTS} slots")
    assert n_done == LM_REQUESTS and sorted(toks) == \
        list(range(LM_REQUESTS)), f"{label}: a request did not complete once"
    for rid, t in toks.items():
        assert len(t) == LM_NEW and all(0 <= x < V for x in t), \
            f"{label}: request {rid} gave {t}"
    _, toks2, _, sec2 = drain()
    log(f"{label}: a second server in {sec2:.3f} s gives the same tokens: "
        f"{toks2 == toks}")
    assert toks2 == toks, f"{label}: two servers differ"
    return {"tokens_per_s": ntok / sec, "ticks": ticks, "seconds": sec,
            "prompts": prompts}


def lm_serve_phase(cfg, params, dev: str = "cuda") -> dict:
    """Path 13 (b): ``serve_drain`` on the trained parameters; then the
    server's step, fed the longest prompt alone in slot 0, ends on logits
    within 5e-2 (relative to their max; bf16) of ``prefill``'s
    last-position logits for it, on the trained weights and on freshly
    drawn ones."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, prefill
    from repro_torch.train import DecodeServer

    ops.reset_launch_counts()
    drained = serve_drain("lm serve", cfg, params, dev)
    prompts = drained["prompts"]

    # the decode step against prefill, on the trained weights and on fresh
    # ones (8 steps from a loss of 15 leave a near-constant prediction)
    prompt = prompts[-1]
    for label, weights in (("trained", params),
                           ("initial", init_model(1, cfg, device=dev))):
        srv = DecodeServer(cfg, weights, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                           device=dev)
        tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=dev)
        for pos, t in enumerate(prompt):
            tok[0, 0] = t
            logits, srv.caches = srv._serve(weights, srv.caches, tok, pos)
        want = prefill(weights, {"tokens": torch.tensor(
            [prompt], dtype=torch.int32, device=dev)}, cfg)[0, 0].float()
        got = logits[0, 0].float()
        err = float((got - want).abs().max() / want.abs().max())
        log(f"lm serve: step logits after a {len(prompt)}-token prompt "
            f"against prefill's, {label} weights: max rel diff {err:.3e} "
            f"(gate 5e-2), argmax {int(got.argmax())} / "
            f"{int(want.argmax())}")
        assert err <= 5e-2, f"lm serve: decode logits far from prefill's " \
            f"({label} weights)"
        del srv, weights
    launches = ops.launch_counts()
    return {"launches": launches, "tokens_per_s": drained["tokens_per_s"],
            "ticks": drained["ticks"], "seconds": drained["seconds"]}


def kfac_phase(dev: str = "cuda") -> dict:
    """Path 13 (c): TLR-KFAC at a K-FAC factor's real size: the
    least-squares problem of tests/test_training.py::
    test_tlr_newton_least_squares with qwen's down projection's shape
    (KFAC_N inputs, KFAC_M outputs, KFAC_SAMPLES samples, inputs
    conditioned by ``geomspace(1, 1e-2)``) built on the card from a seeded
    generator; ``TLRNewtonConfig(tile=KFAC_TILE, refresh_every=5,
    beta=0)`` with AdamW grafting at lr 3e-2 and no weight decay, against
    AdamW alone, KFAC_STEPS steps. Gates: the final TLR-KFAC loss below
    AdamW's and below 0.2 x its first; each refresh's factor at
    ``max_z ||A z - L L^T z|| / ||A z|| <= 100 eps_tlr`` over three probes
    (A the damped activation factor); ``lr_sample``, ``tile_chain`` and
    ``batched_gemm`` launched. Logs the refresh steps' seconds (each
    compresses and factors A), the ranks and the launches per shape."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.optim import (AdamWConfig, TLRNewtonConfig, adamw_init,
                                   adamw_update, tlr_newton_init,
                                   tlr_newton_update)
    from repro_torch.optim import tlr_newton as tn

    t_phase = time.perf_counter()
    n, m, B = KFAC_N, KFAC_M, KFAC_SAMPLES
    g = torch.Generator(device=dev).manual_seed(1)
    f64 = {"dtype": torch.float64, "device": dev}
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g, **f64))
    cov = (U * torch.logspace(0, -2, n, **f64)) @ U.T
    X = torch.randn(B, n, generator=g, **f64) @ cov
    Y = X @ torch.randn(n, m, generator=g, **f64)

    def loss_and_grad(W):
        R = X @ W.T - Y
        return float((R * R).mean()), 2 * R.T @ X / B

    ncfg = TLRNewtonConfig(tile=KFAC_TILE, refresh_every=5, beta=0.0,
                           grafting=AdamWConfig(lr=3e-2, weight_decay=0.0))
    params = {"w": torch.zeros((m, n), **f64)}
    nstate = tlr_newton_init(params, ncfg)
    aw = {"w": torch.zeros((m, n), **f64)}
    astate = adamw_init(aw, ncfg.grafting)
    # each refresh step's factorization (the TLR branch's solve is the
    # factorization's bound method) and the step's seconds
    newton, adam, step_s, facts = [], [], [], []
    ops.reset_launch_counts()
    with gemm_rank_log() as gemm_calls:
        for _ in range(KFAC_STEPS):
            refresh = nstate.step % ncfg.refresh_every == 0
            l_n, g_n = loss_and_grad(params["w"])
            newton.append(l_n)
            (params, nstate), sec = sync_time(lambda: tlr_newton_update(
                {"w": g_n}, nstate, params, ncfg,
                curvature={"w": (X, None)}))
            step_s.append(sec)
            if refresh:
                facts.append((nstate.facts["w"]["A"], sec))
            l_a, g_a = loss_and_grad(aw["w"])
            adam.append(l_a)
            aw, astate = adamw_update({"w": g_a}, astate, aw, ncfg.grafting)
    launches = ops.launch_counts()
    shapes = path_shapes()
    shapes["batched_gemm"] = gemm_shapes(gemm_calls)
    A = tn.damped(X.T @ X / B, ncfg)
    Z = torch.randn(n, 3, generator=g, **f64)
    AZ = A @ Z
    resid, ranks = [], []
    for solve, _ in facts:
        fact = getattr(solve, "__self__", None)
        assert fact is not None and fact.L.nb == n // KFAC_TILE, \
            "kfac: a factor took the dense branch"
        LZ = fact.tri_matvec(fact.tri_matvec(Z, trans=True))
        resid.append(float(((AZ - LZ).norm(dim=0) / AZ.norm(dim=0)).max()))
        ranks.append((int(fact.L.ranks.max()),
                      round(float(fact.L.ranks.float().mean()), 2)))
    log(f"kfac: n={n} m={m} samples={B} tile={KFAC_TILE} (nb={n // KFAC_TILE})"
        f"; {len(facts)} refresh steps (factorization and update) in "
        f"{[round(s, 3) for _, s in facts]} s, L ranks (max, mean) {ranks},"
        f" residuals {[f'{r:.2e}' for r in resid]} (gate "
        f"{100 * ncfg.eps_tlr:.0e}); steps {[round(s, 3) for s in step_s]} "
        f"s; losses TLR-KFAC {newton[0]:.4e} -> {newton[-1]:.4e}, AdamW "
        f"{adam[0]:.4e} -> {adam[-1]:.4e}; launches {json.dumps(launches)}"
        f"; phase {time.perf_counter() - t_phase:.1f} s")
    for name in ("lr_sample", "tile_chain"):
        log(f"kfac: {name} launches per shape: {shapes_line(shapes[name])}")
    log(f"kfac: batched_gemm launches per (T, m, k, n): "
        f"{gemm_shapes_line(shapes['batched_gemm'])}")
    assert len(facts) == -(-KFAC_STEPS // ncfg.refresh_every), \
        "kfac: refreshes missing"
    assert max(resid) <= 100 * ncfg.eps_tlr, "kfac: factor residual"
    assert newton[-1] < adam[-1], "kfac: TLR-KFAC did not beat AdamW"
    assert newton[-1] < 0.2 * newton[0], "kfac: loss fell too little"
    for name in MAIN_KERNELS:
        assert launches[name] > 0, f"kfac: {name} was not launched"
    out = {"launches": launches, "shapes": shapes,
           "refresh_seconds": [s for _, s in facts], "residuals": resid,
           "losses": (newton[-1], adam[-1])}
    del facts, params, nstate, X, Y, A
    torch.cuda.empty_cache()
    return out


def lm_phase(cfg=None, dev: str = "cuda") -> dict:
    """Path 13: train, resume and serve qwen1.5-0.5b at its full width (or
    ``cfg``), then TLR-KFAC (``lm_train_phase``, ``lm_serve_phase``,
    ``kfac_phase``), on ``dev``; checkpoints go to a temporary directory
    removed afterwards."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = cfg or get_config(LM_ARCH)
    log(f"lm: {cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
        f"heads={cfg.num_heads} ff={cfg.d_ff} V={cfg.vocab_size} "
        f"{cfg.dtype} remat={cfg.remat}; {cfg.param_count()} parameters; "
        f"batch {LM_BATCH} x {LM_SEQ}")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    try:
        train = lm_train_phase(cfg, work, dev)
        serve = lm_serve_phase(cfg, train.pop("params"), dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    kfac = kfac_phase(dev)
    log(f"lm: phase {time.perf_counter() - t_phase:.1f} s")
    return {"train": train, "serve": serve, "kfac": kfac}


# -- phase 17: the right driver on a mesh of ranks (tile sharding) -------------

# The ranks of the mesh phase and its right Cholesky runs, (batching,
# lookahead).
MESH_RANKS = 2
MESH_RUNS = (("flat", False), ("ranked", False), ("ranked", True))


def mesh_key(batching: str, lookahead: bool) -> str:
    return f"mesh_{batching}" + ("_lookahead" if lookahead else "")


def mesh_rank(rank: int, world: int, backend: str, work: str) -> None:
    """One rank of ``mesh_phase``, started by torch.multiprocessing.spawn:
    the operator the parent saved in ``work``, then the right Cholesky of
    each of MESH_RUNS with the tile mesh installed, a (world, 1) ``("data",
    "model")`` mesh, so that each rank holds half the accumulators. Rank 0
    saves its factors; every rank compares its factor with rank 0's
    (broadcast) and writes its seconds, peak memory, launch counts and
    accumulator bytes to ``work/rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import CholOptions, TLRMatrix, TLROperator
    from repro_torch.core import set_tile_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh

    work = Path(work)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_test_mesh((world, 1), ("data", "model"))
        op = TLROperator(TLRMatrix(**torch.load(work / "op.pt",
                                                map_location=dev)))
        set_tile_mesh(mesh)
        out = {"device": str(dev)}
        for batching, lookahead in MESH_RUNS:
            key = mesh_key(batching, lookahead)
            opts = CholOptions(eps=EPS, algo="right", batching=batching,
                               lookahead=lookahead)
            dist.barrier()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            fact, sec = sync_time(lambda: op.cholesky(opts))
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated(dev)
            L = fact.L
            parts = {"D": L.D, "U": L.U, "V": L.V, "ranks": L.ranks}
            if rank == 0:
                torch.save(parts, work / f"{key}.pt")
            same, rel = True, 0.0
            for name, x in parts.items():
                y = x.clone()
                dist.broadcast(y, src=0)
                same = same and torch.equal(x, y)
                if name != "ranks":
                    rel = max(rel, float((x - y).abs().max()
                                         / y.abs().max()))
            st = fact.stats
            out[key] = {"seconds": sec, "peak": peak, "launches": launches,
                        "acc_bytes": st["acc_bytes"],
                        "tile_rows": st["tile_rows"],
                        "acc_width": st["acc_width"],
                        "flushes": st["flushes"],
                        "schedule": st["schedule"]["name"],
                        "rank0_rel": rel, "rank0_bitwise": same}
            del fact, L, parts
        set_tile_mesh(None)
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def mesh_phase(op, Z, KZ, y) -> dict:
    """The right driver with its accumulators split over MESH_RANKS ranks
    (``core.set_tile_mesh`` on a ``torch.distributed`` device mesh), on the
    cov2d-8k-right operator, which it saves under build/ for the ranks:
    NCCL with one rank per card when the machine has MESH_RANKS cards, else
    gloo with every rank on cuda:0 (NCCL takes one rank per card). The
    flat and ranked Cholesky, and the ranked one with lookahead
    (``mesh_rank``). Gates, per run: both ranks ran and launched the QR,
    SVD and GEMM kernels, each rank's factor equals rank 0's bit for bit
    and rank 0's is within 1e-12 of this process's single-device factor of
    the same options (max abs over L.D, L.U and L.V relative to its max;
    the bitwise status logged), the right phase's residual gate and a
    finite solve on rank 0's factor, and each rank's accumulator bytes
    exactly half the single device's. Logs the seconds of each run on each
    rank (the first runs of fresh processes, two sharing one card under
    gloo: a check of correctness, not of scaling), peak memory and launch
    counts per rank."""
    import shutil

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch import CholOptions, TLRFactorization, TLRMatrix

    t_phase = time.perf_counter()
    backend = "nccl" if torch.cuda.device_count() >= MESH_RANKS else "gloo"
    where = ("one rank per card" if backend == "nccl"
             else f"all {MESH_RANKS} ranks on cuda:0")
    work = ROOT / "build" / "mesh_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    A = op.A
    torch.save({"D": A.D, "U": A.U, "V": A.V, "ranks": A.ranks},
               work / "op.pt")
    refs = {}
    for batching, lookahead in MESH_RUNS:
        opts = CholOptions(eps=EPS, algo="right", batching=batching,
                           lookahead=lookahead)
        refs[mesh_key(batching, lookahead)] = sync_time(
            lambda: op.cholesky(opts))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(mesh_rank, args=(MESH_RANKS, backend, str(work)),
             nprocs=MESH_RANKS, join=True)
    t_ranks = time.perf_counter() - t0
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(MESH_RANKS)]
    log(f"mesh: {MESH_RANKS} ranks on a ({MESH_RANKS}, 1) (data, model) "
        f"mesh, backend {backend} ({where}), cov2d-8k-right; the ranks' "
        f"processes took {t_ranks:.1f} s from spawn to join")
    out = {}
    for batching, lookahead in MESH_RUNS:
        key = mesh_key(batching, lookahead)
        ref, t_ref = refs[key]
        fact = TLRFactorization(
            L=TLRMatrix(**torch.load(work / f"{key}.pt",
                                     map_location="cuda")),
            d=None, perm=np.arange(ref.nb), stats={})
        rel, same = factor_diff(fact, ref)
        resid = right_residual(fact, Z, KZ)
        x = fact.solve(y)
        runs = [r[key] for r in res]
        half = ref.stats["acc_bytes"] // MESH_RANKS
        log(f"{key}: seconds per rank "
            f"{[round(r['seconds'], 3) for r in runs]} (one device "
            f"{t_ref:.3f} s); against one device max rel diff {rel:.3e} "
            f"(gate 1e-12), bitwise {'yes' if same else 'no'}; ranks equal "
            f"bitwise {all(r['rank0_bitwise'] for r in runs)} (max rel "
            f"{max(r['rank0_rel'] for r in runs):.3e}); accumulator bytes "
            f"per rank {[r['acc_bytes'] for r in runs]} (one device "
            f"{ref.stats['acc_bytes']}), tile rows "
            f"{[r['tile_rows'] for r in runs]}; peak memory per rank "
            f"{[round(r['peak'] / 2**30, 2) for r in runs]} GiB; flushes "
            f"{runs[0]['flushes']} (one device {ref.stats['flushes']}), "
            f"schedule {runs[0]['schedule']}; residual {resid:.3e} (gate "
            f"{100 * EPS:.0e}); launches per rank "
            f"{json.dumps([r['launches'] for r in runs])}")
        for r, run in enumerate(runs):
            for name in ROUND_KERNELS:
                assert run["launches"][name] > 0, \
                    f"{key}: rank {r} did not launch {name}"
            assert run["rank0_bitwise"], f"{key}: rank {r} differs from 0"
            assert run["acc_bytes"] == half, \
                f"{key}: rank {r} holds {run['acc_bytes']} accumulator " \
                f"bytes, not half of {ref.stats['acc_bytes']}"
        assert rel <= 1e-12, f"{key}: differs from one device by {rel:.3e}"
        assert resid <= 100 * EPS, f"{key}: residual above 100 eps"
        assert bool(torch.isfinite(x).all()), f"{key}: solve not finite"
        out[key] = runs[0]["launches"]
        out[f"{key}_seconds"] = [r["seconds"] for r in runs]
        del fact, ref, x
    shutil.rmtree(work)
    log(f"mesh: phase {time.perf_counter() - t_phase:.1f} s")
    return out


# -- path 14: the MoE, SSM, hybrid, audio and VLM families -------------------------


def gate_config(cfg):
    """``cfg`` with a capacity that drops nothing (C >= the group size):
    decode and prefill group tokens differently, so only without drops do
    they compute the same function (tests/test_model_units.py's
    ``cf=10``)."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=max(10.0, m.num_experts / m.top_k)))


def context_input(cfg, batch: int, seed: int, dev: str,
                  seq: int = LM_MAX_LEN) -> dict:
    """The family's context for ``seq`` tokens as ``materialize_inputs``
    draws it (0.02 x a standard normal, from ``seed``): ``frames`` (audio,
    ``_enc_len(cfg, seq)``; at LM_MAX_LEN the server's cross caches'
    length) or ``patches`` (VLM, ``frontend_tokens``); nothing for the
    other families."""
    import numpy as np
    import torch
    from repro_torch.models.api import _enc_len
    if cfg.family == "audio":
        key, T = "frames", _enc_len(cfg, seq)
    elif cfg.frontend_tokens:
        key, T = "patches", cfg.frontend_tokens
    else:
        return {}
    x = np.random.default_rng(seed).standard_normal((batch, T, cfg.d_model))
    return {key: torch.as_tensor(x * 0.02).to(device=dev, dtype=cfg.tdtype)}


def fill_context_caches(cfg, params, caches, ctx_in: dict) -> None:
    """Write the cross-attention K/V of a batch's context into the cross
    caches (JAX's server leaves them zero, and ``prefill`` reads the
    context): ``cross_kv`` of the encoder's output over the frames into
    each decoder layer's ``cross`` cache (audio), or of the patches into
    each ``cross`` mixer's (VLM), slot b from context row b."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import apply_encoder
    if not ctx_in:
        return
    pat, R = cfg.layer_pattern(), cfg.num_pattern_repeats
    with torch.no_grad():
        if cfg.family == "audio":
            ctx = apply_encoder(params, ctx_in["frames"], cfg)
            where = [(len(pat) + i, i, "cross") for i in range(len(pat))]
        else:
            ctx = ctx_in["patches"]
            where = [(i, i, "mixer") for i, (m, _) in enumerate(pat)
                     if m == "cross"]
        n = ctx.shape[0]
        for c, i, name in where:
            for r in range(R):
                k, v = L.cross_kv({key: x[r] for key, x in
                                   params["blocks"][i][name].items()},
                                  ctx, cfg)
                caches[c].k[r, :n] = k
                caches[c].v[r, :n] = v


@contextlib.contextmanager
def moe_log():
    """The routing of each ``apply_moe`` call, in call order: (its expert
    indices (B, S, K) on the host, how many (token, slot) pairs its
    capacity drops), from ``moe._route`` on the same input."""
    from repro_torch.models import moe
    inner, calls = moe.apply_moe, []

    def logged(p, x, cfg):
        B, S, D = x.shape
        gs = min(cfg.moe.group_size, B * S)
        _, _, idx, _, pos, C = moe._route(p, x.reshape(B * S // gs, gs, D),
                                          cfg)
        calls.append((idx.reshape(B, S, -1).cpu(), int((pos >= C).sum())))
        return inner(p, x, cfg)

    moe.apply_moe = logged
    try:
        yield calls
    finally:
        moe.apply_moe = inner


def to_float32_in_place(tree) -> None:
    """Replace every leaf of a parameter tree (dicts and lists) by its
    float32 copy, the largest first, each original dropped as soon as its
    copy exists: the peak is the tree in float32 plus one leaf."""
    slots, todo = [], [tree]
    while todo:
        t = todo.pop()
        for k, v in (t.items() if isinstance(t, dict) else enumerate(t)):
            if isinstance(v, (dict, list)):
                todo.append(v)
            else:
                slots.append((v.numel(), t, k))
    for _, t, k in sorted(slots, key=lambda s: -s[0]):
        t[k] = t[k].float()


def decode_against_prefill(label: str, cfg, params, dev: str) -> float:
    """The last-position logits of ``serve_step`` fed a FAM_PROMPT-token
    prompt token by token (slot 0 of LM_SLOTS, its cross caches filled from
    the prompt's context) against ``prefill``'s for it, both under
    ``gate_config``. Gate: max relative difference <= 5e-2 (path 13's;
    bf16). A MoE layer's top-k is a step function of bf16-rounded router
    logits (ties are exact in bf16), so where a decode step's experts
    differ from prefill's for the same token anywhere, the bf16 numbers are
    logged and the gate holds the same weights cast to float32 in place
    (``to_float32_in_place``: ``params`` is float32 afterwards). Logs the
    slots the same prefill drops at the published capacity."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import init_decode_caches, prefill, serve_step
    from repro_torch.models.api import _enc_len
    prompt = np.random.default_rng(7).integers(1, cfg.vocab_size,
                                               FAM_PROMPT).tolist()

    def run(c):
        """(max rel diff, argmaxes, (layer, token)s routed otherwise, MoE
        layers)."""
        ctx_in = {k: v.to(c.tdtype) for k, v in
                  context_input(cfg, 1, 7, dev).items()}
        caches = init_decode_caches(c, LM_SLOTS, LM_MAX_LEN,
                                    ctx_len=_enc_len(c, LM_MAX_LEN),
                                    device=dev)
        fill_context_caches(c, params, caches, ctx_in)
        tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=dev)
        with moe_log() as dec:
            for pos, t in enumerate(prompt):
                tok[0, 0] = t
                logits, caches = serve_step(params, caches, tok, pos, c)
        del caches
        batch = {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                        device=dev), **ctx_in}
        with moe_log() as pre:
            want = prefill(params, batch, c)[0, 0].float()
        got = logits[0, 0].float()
        err = float((got - want).abs().max() / want.abs().max())
        n = len(pre)
        differ = sum(set(dec[t * n + i][0][0, 0].tolist()) !=
                     set(pre[i][0][0, t].tolist())
                     for t in range(len(prompt)) for i in range(n))
        return err, (int(got.argmax()), int(want.argmax())), differ, n

    gcfg = gate_config(cfg)
    err, amax, differ, n = run(gcfg)
    note = ""
    if cfg.moe is not None:
        with moe_log() as pub:
            prefill(params, {"tokens": torch.tensor(
                [prompt], dtype=torch.int32, device=dev),
                **context_input(cfg, 1, 7, dev)}, cfg)
        note = (f" (capacity factor {gcfg.moe.capacity_factor:g}; at the "
                f"published {cfg.moe.capacity_factor:g} that prefill drops "
                f"{sum(d for _, d in pub)} of "
                f"{FAM_PROMPT * cfg.moe.top_k * n} slots in {n} MoE layers)"
                f"; decode and prefill route {differ} of {FAM_PROMPT * n} "
                f"(layer, token) pairs to other experts")
    filled = " (cross caches filled)" if cfg.family in ("audio", "vlm") \
        else ""
    log(f"{label}: decode step logits after a {FAM_PROMPT}-token prompt "
        f"against prefill's{filled} in {cfg.dtype}: max rel diff "
        f"{err:.3e}, argmax {amax[0]} / {amax[1]}{note}")
    if differ:
        to_float32_in_place(params)
        torch.cuda.empty_cache()
        err, amax, differ, _ = run(dataclasses.replace(gcfg,
                                                       dtype="float32"))
        log(f"{label}: the same weights in float32: max rel diff "
            f"{err:.3e}, argmax {amax[0]} / {amax[1]}, {differ} pairs "
            f"routed otherwise")
    log(f"{label}: decode against prefill {err:.3e} (gate 5e-2)")
    assert err <= 5e-2, f"{label}: decode logits far from prefill's"
    return err


def fam_steps(cfg, tr, dev: str):
    """FAM_STEPS steps of the trainer's own step (``fwd_bwd`` then
    ``apply``, as ``Trainer.run``, with no checkpoint) from its initial
    state, the family's context (frames / patches) beside the synthetic
    tokens: (losses, step seconds, peak bytes, parameters)."""
    import torch
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init
    torch.cuda.reset_peak_memory_stats()
    params = init_model(tr.tcfg.seed, cfg, device=dev)
    ostate = adamw_init(params, tr.tcfg.optimizer)
    losses, dts = [], []
    for step in range(FAM_STEPS):
        def one():
            nonlocal params, ostate
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in tr.data.batch_at(step).items()}
            batch.update(context_input(cfg, tr.tcfg.batch, step, dev,
                                       tr.tcfg.seq_len))
            loss, grads, _ = tr.fwd_bwd(params, batch)
            params, ostate = tr.apply(grads, ostate, params)
            return float(loss)
        loss, sec = sync_time(one)
        losses.append(loss)
        dts.append(sec)
    peak = torch.cuda.max_memory_allocated()
    return losses, dts, peak, params


def fam_train_phase(cfg, batch: int, lr: float, work: Path,
                    dev: str = "cuda"):
    """Path 14 (a), training: FAM_STEPS AdamW steps (learning rate ``lr``)
    of ``batch`` x FAM_SEQ tokens (``fam_steps``). Gates: finite losses, the last below the
    first. The pure-SSM model also runs ``Trainer.run`` for FAM_SPLIT steps
    (its checkpoint) and again to FAM_STEPS, resumed: those losses equal
    the straight run's bit for bit. Logs step seconds, tokens/s, peak
    memory and the checkpoint's bytes. Returns (parameters, numbers)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    label = f"fam {cfg.name}"
    tcfg = TrainConfig(steps=FAM_STEPS, batch=batch, seq_len=FAM_SEQ,
                       ckpt_dir=str(work / cfg.name), save_every=10**9,
                       log_every=1, keep=1, seed=0,
                       optimizer=AdamWConfig(lr=lr))
    tr = Trainer(cfg, tcfg, device=dev)
    losses, dts, peak, params = fam_steps(cfg, tr, dev)
    tok_s = batch * FAM_SEQ / float(np.median(dts[1:]))
    ctx = {k: tuple(v.shape) for k, v in
           context_input(cfg, batch, 0, "meta", FAM_SEQ).items()}
    log(f"{label} train: {FAM_STEPS} steps of {batch} x {FAM_SEQ} tokens"
        f" at learning rate {lr:g}"
        f"{' with ' + str(ctx) if ctx else ''}; losses {losses}; step "
        f"seconds {[round(x, 3) for x in dts]}; {tok_s:.0f} tokens/s "
        f"(median step after the first); peak {peak / 2**30:.2f} GiB")
    assert all(math.isfinite(x) for x in losses), \
        f"{label}: a loss is not finite"
    assert losses[-1] < losses[0], \
        f"{label}: loss {losses[0]} -> {losses[-1]}"
    out = {"losses": losses, "step_seconds": dts, "tokens_per_s": tok_s,
           "peak": peak}
    if cfg.family == "ssm":
        runs = []
        for steps in (FAM_SPLIT, FAM_STEPS):
            t = Trainer(cfg, dataclasses.replace(tcfg, steps=steps),
                        device=dev)
            try:
                res, sec = sync_time(t.run)
            finally:
                t.close()
            runs.append((t.resumed_from, res["losses"], sec,
                         dir_bytes(work / cfg.name)))
            del res
        resumed = runs[0][1] + runs[1][1]
        log(f"{label} resume: Trainer.run for {FAM_SPLIT} steps in "
            f"{runs[0][2]:.2f} s (a {runs[0][3]}-byte checkpoint), then "
            f"resumed from step {runs[1][0]} to {FAM_STEPS} in "
            f"{runs[1][2]:.2f} s: losses {resumed}, the straight run's bit "
            f"for bit: {resumed == losses}")
        assert runs[1][0] == FAM_SPLIT, f"{label}: resumed from {runs[1][0]}"
        assert resumed == losses, \
            f"{label}: the resumed losses differ from the straight run's"
        out["checkpoint_bytes"] = runs[0][3]
        torch.cuda.empty_cache()
    return params, out


def fam_repeat_phase(arch: str, dev: str = "cuda", smoke: bool = False
                     ) -> dict:
    """Path 14 (b): ``arch`` at its published width and one pattern repeat
    (``num_layers`` = the pattern's length): a prefill of FAM_PREFILL
    tokens (with the family's context), then FAM_TICKS greedy decode ticks
    of that batch (cross caches filled), then ``decode_against_prefill``.
    Gates: finite logits. Logs seconds, peak memory and the prefill's MoE
    drops."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (init_decode_caches, init_model, prefill,
                                    serve_step)
    from repro_torch.models.api import _enc_len
    from repro_torch.tree import leaves
    full = get_config(arch, smoke=smoke)
    cfg = dataclasses.replace(full, num_layers=len(full.layer_pattern()))
    label = f"fam {cfg.name} x1"
    torch.cuda.reset_peak_memory_stats()
    params, t_init = sync_time(lambda: init_model(0, cfg, device=dev))
    B, S = FAM_PREFILL
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, S)),
                                       dtype=torch.int32, device=dev),
             **context_input(cfg, B, 0, dev)}
    with moe_log() as calls:
        logits, t_prefill = sync_time(lambda: prefill(params, batch, cfg))
    dropped = [d for _, d in calls]
    assert torch.isfinite(logits).all(), f"{label}: prefill not finite"
    caches = init_decode_caches(cfg, B, LM_MAX_LEN,
                                ctx_len=_enc_len(cfg, LM_MAX_LEN), device=dev)
    fill_context_caches(cfg, params, caches, {
        k: v for k, v in batch.items() if k != "tokens"})
    tok, ticks = batch["tokens"][:, :1], []
    for t in range(FAM_TICKS):
        (out, caches), sec = sync_time(
            lambda: serve_step(params, caches, tok, t, cfg))
        assert torch.isfinite(out).all(), f"{label}: tick {t} not finite"
        tok = out[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        ticks.append(sec)
    del caches
    peak = torch.cuda.max_memory_allocated()
    n = sum(x.numel() for x in leaves(params))
    log(f"{label}: layers {cfg.num_layers} of {full.num_layers} "
        f"{cfg.layer_pattern()}, d={cfg.d_model}, {n} parameters "
        f"({full.param_count()} at full depth); init {t_init:.2f} s; "
        f"prefill {B} x {S} tokens in {t_prefill:.3f} s "
        f"({B * S / t_prefill:.0f} tokens/s)"
        f"{'; MoE drops per layer ' + str(dropped) if dropped else ''}; "
        f"{FAM_TICKS} decode ticks of {B} in "
        f"{[round(1e3 * x, 2) for x in ticks]} ms; peak "
        f"{peak / 2**30:.2f} GiB")
    err = decode_against_prefill(label, cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    return {"prefill_s": t_prefill, "tick_s": ticks, "peak": peak,
            "drops": dropped, "decode_err": err}


def moe_oracle_phase(dev: str = "cuda", smoke: bool = False) -> dict:
    """One MoE layer of each FAM_ORACLE config at its published width on
    the card (``init_moe`` from a seeded generator, the layer in ``dtype``,
    capacity raised so nothing drops) against a per-token dense top-k
    oracle in float32 on the same weights, inputs and routing (the layer's
    own top-k): each token's experts run one by one, weighted by its gate,
    plus the shared expert. Gate: max |y - oracle| <= tol x max |oracle|."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    errs = {}
    for arch, T, dtype, tol in FAM_ORACLE:
        cfg = gate_config(dataclasses.replace(get_config(arch, smoke=smoke),
                                              dtype=dtype))
        m, D = cfg.moe, cfg.d_model
        T = min(T, m.group_size)
        gen = torch.Generator(device=dev).manual_seed(3)
        p = moe.init_moe(gen, cfg, cfg.tdtype, dev)
        x = torch.randn((1, T, D), generator=gen, device=dev).to(cfg.tdtype)
        (y, aux), sec = sync_time(lambda: moe.apply_moe(p, x, cfg))
        _, gv, gi, _, pos, C = moe._route(p, x, cfg)
        assert bool((pos < C).all()), f"moe oracle {arch}: a slot dropped"
        xf = x[0].float()

        def expert(w, rows):
            h = F.silu(xf[rows] @ w["wg"].float()) * (xf[rows] @ w["wu"].float())
            return h @ w["wd"].float()

        want = torch.zeros((T, D), dtype=torch.float32, device=dev)
        for e in gi.unique().tolist():
            w = {k: p[k][e] for k in ("wg", "wu", "wd")}
            for k in range(m.top_k):
                rows = (gi[0, :, k] == e).nonzero()[:, 0]
                if rows.numel():
                    want[rows] += gv[0, rows, k:k + 1] * expert(w, rows)
        if m.shared_expert:
            want += expert(p["shared"], slice(None))
        err = float((y[0].float() - want).abs().max() / want.abs().max())
        log(f"moe oracle {cfg.name}: one layer, {m.num_experts} experts "
            f"top-{m.top_k}, d={D} ff={m.d_ff_expert}"
            f"{', shared expert' if m.shared_expert else ''}, {T} tokens in "
            f"{dtype} ({sec * 1e3:.2f} ms, {len(gi.unique())} experts used, "
            f"capacity {C}, aux {float(aux):.4f}) against the float32 "
            f"oracle: max rel diff {err:.3e} (gate {tol:g})")
        assert err <= tol, f"moe oracle {arch}: {err} > {tol}"
        errs[arch] = err
        del p, x, y, want, w
        torch.cuda.empty_cache()
    return errs


def families_phase(dev: str = "cuda", smoke: bool = False) -> dict:
    """Path 14: FAM_TRAIN trained and served at full depth and width
    (``fam_train_phase``, ``serve_drain``, ``decode_against_prefill``),
    FAM_REPEAT at one pattern repeat (``fam_repeat_phase``), the MoE
    oracle (``moe_oracle_phase``); ``smoke`` runs the smoke configs (a CPU
    rehearsal). No kernel of the port is on this path: its launches are
    logged (all 0)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    out = {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fam_"))
    try:
        for arch, batch, lr in FAM_TRAIN:
            t0 = time.perf_counter()
            cfg = get_config(arch, smoke=smoke)
            log(f"fam {cfg.name}: family {cfg.family}, layers "
                f"{cfg.num_layers} {cfg.layer_pattern()}, d={cfg.d_model}, "
                f"{cfg.param_count()} parameters "
                f"({cfg.active_param_count()} active), {cfg.dtype}, remat "
                f"{cfg.remat}")
            params, train = fam_train_phase(cfg, batch, lr, work, dev)
            serve = serve_drain(f"fam {cfg.name} serve", cfg, params, dev)
            err = decode_against_prefill(f"fam {cfg.name} serve", cfg,
                                         params, dev)
            out[arch] = {"train": train, "serve": serve, "decode_err": err}
            del params
            torch.cuda.empty_cache()
            log(f"fam {cfg.name}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for arch in FAM_REPEAT:
        t0 = time.perf_counter()
        out[arch] = fam_repeat_phase(arch, dev, smoke)
        log(f"fam {arch} x1: {time.perf_counter() - t0:.1f} s")
    out["oracle"] = moe_oracle_phase(dev, smoke)
    launches = ops.launch_counts()
    log(f"fam: launches {json.dumps(launches)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    out["launches"] = launches
    return out


def family_parity(dev: str = "cuda") -> None:
    """The six families at smoke size in float32 on the card (``dev``) and
    on the CPU, on the same weights and inputs (tokens, labels, frames /
    patches): the loss (1e-5 relative), every gradient leaf (max |diff| <=
    1e-4 x max |CPU|), prefill logits and 4 ``serve_step`` logits (1e-5 x
    max |CPU|)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (init_decode_caches, init_model, prefill,
                                    serve_step, train_loss)
    from repro_torch.models.api import _enc_len
    from repro_torch.tree import leaves, tree_map, unflatten

    def rel(a, b) -> float:
        d = float((a.cpu().double() - b.double()).abs().max())
        return d / max(float(b.double().abs().max()), 1e-30) if d else 0.0

    for arch in FAM_SMOKE:
        cfg = get_config(arch, smoke=True)
        rng = np.random.default_rng(5)
        nb = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)),
              "labels": rng.integers(-1, cfg.vocab_size, (2, 64))}
        base = {"cpu": init_model(0, cfg, device="cpu")}
        base[dev] = tree_map(lambda x: x.to(dev), base["cpu"])
        res = {}
        for on, p in base.items():
            batch = {k: torch.as_tensor(v, dtype=torch.int32, device=on)
                     for k, v in nb.items()}
            batch.update({k: v.to(on) for k, v in
                          context_input(cfg, 2, 5, "cpu").items()})
            live = [x.clone().requires_grad_(True) for x in leaves(p)]
            loss = train_loss(unflatten(p, live), batch, cfg)
            grads = torch.autograd.grad(loss, live)
            inputs = {k: v for k, v in batch.items() if k != "labels"}
            logits = [prefill(p, inputs, cfg)]
            caches = init_decode_caches(cfg, 2, 16,
                                        ctx_len=_enc_len(cfg, 16), device=on)
            for t in range(4):
                lg, caches = serve_step(p, caches, batch["tokens"][:, t:t + 1],
                                        t, cfg)
                logits.append(lg)
            res[on] = (loss.detach(), grads, logits)
        e_loss = rel(res[dev][0], res["cpu"][0])
        e_grad = max(rel(a, b) for a, b in zip(res[dev][1], res["cpu"][1]))
        e_logs = [rel(a, b) for a, b in zip(res[dev][2], res["cpu"][2])]
        e_log = max(e_logs)
        log(f"family parity {cfg.name} (smoke, float32): card against CPU: "
            f"loss {e_loss:.2e}, gradients {e_grad:.2e} (max over "
            f"{len(res['cpu'][1])} leaves), prefill and 4 decode logits "
            f"{[f'{e:.2e}' for e in e_logs]}")
        assert e_loss <= 1e-5 and e_grad <= 1e-4 and e_log <= 1e-5, \
            f"family parity {arch}: card and CPU disagree"


# -- path 15: model sharding and the dry run ------------------------------------


def dryrun_cells(out: str) -> None:
    """The DRY_CELLS on the card's host, in this (sub)process: each cell's
    record (``launch.dryrun.run_cell``, a CUDA-typed fake mesh), the
    parameter bytes rank 0 holds by the placements (each leaf's local
    block, computed apart from the run), and the roofline estimate. Writes
    them as JSON to ``out``."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.sharding import params_shardings
    from repro_torch.tree import flatten_with_path
    from repro_torch.launch.sharding import _at

    res = []
    for arch, shape, mesh_kind in DRY_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh_kind, save=False,
                              repeats=DRY_REPEATS)
        sec = time.perf_counter() - t0
        cfg = get_config(arch)
        cfg = dataclasses.replace(
            cfg, num_layers=DRY_REPEATS * len(cfg.layer_pattern()))
        _, args, _ = dryrun._build_step(cfg, shape)
        layout = dryrun.MeshLayout(rec["exec_mesh_shape"],
                                   rec["exec_mesh_axes"])
        placed = params_shardings(args[0], layout)
        implied = 0
        for path, x in flatten_with_path(args[0]):
            local, _ = _compute_local_shape_and_global_offset(
                tuple(x.shape), layout.shape, [0] * len(layout.shape),
                _at(placed, path))
            implied += math.prod(local) * x.element_size()
        res.append({"cell": [arch, shape, mesh_kind], "seconds": sec,
                    "record": rec, "implied_param_bytes": implied,
                    "bounds": dryrun.rank_bounds(rec),
                    "roofline": roofline.analyze(rec)})
    Path(out).write_text(json.dumps(res))


def dryrun_start():
    """Path 15 (a), started: ``dryrun_cells`` in a subprocess (its fake
    process group and DTensor state stay there; it uses the host's cores
    while ``shard_phase`` holds the card). Returns what ``dryrun_finish``
    reads."""
    work = ROOT / "build" / "dryrun_phase"
    work.mkdir(parents=True, exist_ok=True)
    out = work / "cells.json"
    out.unlink(missing_ok=True)
    logs = open(work / "cells.log", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun-cells", str(out)],
                            stdout=logs, stderr=subprocess.STDOUT)
    return proc, logs, work, time.perf_counter()


def dryrun_finish(started) -> list:
    """Path 15 (a), read: gates per cell, each against the unsharded
    step (``launch.dryrun.rank_bounds``): a rank's FLOPs at least the
    whole step's over the ranks and at most F times that, F 1.05 where the
    model axis divides every dim and its size where the rules leave a dim
    whole (named); a rank's peak at most F times the whole step's peak over
    the ranks plus the parameters twice and the rank's arguments; rank 0's
    parameter bytes equal to what the placements imply; collectives > 0.
    Logs peak GiB and FLOPs per rank, whole-module FLOPs, collective bytes
    by op and by link, and the roofline terms (estimates at the H100's
    datasheet rates, not measurements)."""
    proc, logs, work, t0 = started
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logs.close()
    text = (work / "cells.log").read_text()
    assert rc == 0, f"dry-run cells failed (rc {rc}):\n{text[-6000:]}"
    cells = json.loads((work / "cells.json").read_text())
    for c in cells:
        rec, rl, bd = c["record"], c["roofline"], c["bounds"]
        tag = " x ".join(c["cell"])
        coll, mem = rec["collectives"], rec["memory"]
        flops = rec["cost"]["flops_per_rank"]
        lo, hi = bd["flops_per_rank"]
        log(f"dryrun {tag}: {rec['devices']} ranks, mesh "
            f"{rec['mesh_shape']} {rec['mesh_axes']} (run on "
            f"{rec['exec_mesh_shape']} {rec['exec_mesh_axes']}), "
            f"{rec['num_layers']} layers, full width; {c['seconds']:.1f} s "
            f"(fake step {rec['trace_s']} s); peak/rank "
            f"{mem['peak_bytes_est'] / 2**30:.3f} GiB (bound "
            f"{bd['peak_bytes_est'] / 2**30:.3f}; unsharded step "
            f"{mem['peak_bytes_whole'] / 2**30:.3f}), params/rank "
            f"{mem['param_bytes']} B (implied "
            f"{c['implied_param_bytes']} B); flops/rank {flops:.4e} = "
            f"{flops / lo:.4f} x whole/ranks (bound {bd['factor']}; whole "
            f"over the model axis: {rec['model']['whole_over_model']}), "
            f"whole-module {rec['cost']['flops_total']:.6e}; collectives "
            f"{json.dumps(coll['counts'])}, bytes/rank by op and link "
            f"{json.dumps(coll['bytes_by_link'])}")
        log(f"dryrun {tag} roofline estimate (H100 datasheet rates): "
            f"compute {rl['t_compute_s'] * 1e3:.4g} ms (the busiest rank's "
            f"{rl['t_compute_rank_s'] * 1e3:.4g}), memory "
            f"{rl['t_memory_s'] * 1e3:.4g} ms, collective "
            f"{rl['t_collective_s'] * 1e3:.4g} ms, dominant "
            f"{rl['dominant']}, useful {rl['useful_ratio']:.3f}, roofline "
            f"{100 * rl['roofline_fraction']:.3g} %")
        assert lo * (1 - 1e-9) <= flops <= hi * (1 + 1e-9), \
            f"{tag}: a rank's FLOPs {flops:.4e} outside [{lo:.4e}, {hi:.4e}]"
        assert mem["peak_bytes_est"] <= bd["peak_bytes_est"], \
            f"{tag}: a rank's peak above its bound"
        assert mem["param_bytes"] == c["implied_param_bytes"], \
            f"{tag}: rank 0's parameter bytes differ from the placements'"
        assert coll["total_bytes"] > 0 and sum(coll["counts"].values()) > 0, \
            f"{tag}: no collective"
    log(f"dryrun: {len(cells)} cells in {time.perf_counter() - t0:.1f} s "
        f"from start (beside the sharded run)")
    return cells


def model_sharding_phase() -> dict:
    """Path 15: the dry-run cells (a subprocess on the host) beside the
    sharded qwen on the card."""
    t0 = time.perf_counter()
    started = dryrun_start()
    try:
        shard = shard_phase()
    except BaseException:
        started[0].kill()
        raise
    cells = dryrun_finish(started)
    log(f"path 15: {time.perf_counter() - t0:.1f} s")
    return {"shard": shard, "cells": cells}


def shard_rank(rank: int, world: int, work: str) -> None:
    """One rank of ``shard_phase``, started by torch.multiprocessing.spawn:
    qwen1.5-0.5b's parameters (the parent's seed) in float32, the parent's
    batch and first tokens, one AdamW step and SHARD_TICKS greedy ticks in
    float32, then SHARD_TICKS ticks in bf16 fed the parent's bf16 tokens,
    on a (1, world) (data, model) mesh over gloo on cuda:0. Rank 0 saves
    each parameter's update whole and the bf16 ticks' logits; every rank
    writes its seconds, peak memory, parameter bytes, loss and tokens to
    ``work/rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import gloo_cuda_all_gather

    work = Path(work)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        with gloo_cuda_all_gather():
            shard_rank_work(rank, world, work)
    finally:
        dist.destroy_process_group()


def shard_rank_work(rank: int, world: int, work: Path) -> None:
    """``shard_rank``'s work, in its process group."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import greedy_decode, sharded_train_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_model
    from repro_torch.tree import flatten_with_path, path_str, tree_map

    mesh = make_test_mesh((1, world), ("data", "model"))
    cfg = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_model(0, cfg, device="cuda")
    p32 = tree_map(lambda x: x.float(), params)
    inp = torch.load(work / "inputs.pt", map_location="cuda")
    torch.cuda.reset_peak_memory_stats()
    (loss, new, state), sec = sync_time(lambda: sharded_train_step(
        cfg32, p32, inp["batch"], mesh))
    peak = torch.cuda.max_memory_allocated()
    flat = flatten_with_path(new)
    nbytes = sum(x.to_local().numel() * x.to_local().element_size()
                 for _, x in flat)
    old = dict((path_str(p, "/"), x) for p, x in flatten_with_path(p32))
    upd = {path_str(p, "/"): (x.full_tensor() - old[path_str(p, "/")]
                              ).cpu() for p, x in flat}
    m = {path_str(p, "/"): x.full_tensor().cpu()
         for p, x in flatten_with_path(state.m)}
    if rank == 0:
        torch.save({"update": upd, "m": m}, work / "updates.pt")
    del new, state, upd, m, old
    toks, tsec = sync_time(lambda: greedy_decode(
        cfg32, p32, inp["token"], SHARD_TICKS, SHARD_MAX_LEN, mesh)[0])
    del p32
    (picks, logits), bsec = sync_time(lambda: greedy_decode(
        cfg, params, inp["token"], SHARD_TICKS, SHARD_MAX_LEN, mesh,
        feed=inp["feed"]))
    if rank == 0:
        torch.save(logits.cpu(), work / "logits_bf16.pt")
    (work / f"rank{rank}.json").write_text(json.dumps({
        "loss": float(loss.full_tensor()), "seconds": sec,
        "decode_seconds": tsec, "bf16_decode_seconds": bsec,
        "peak": peak, "param_bytes": nbytes,
        "tokens": toks.cpu().tolist(), "bf16_picks": picks.cpu().tolist()}))


def shard_phase() -> dict:
    """Path 15 (b): qwen1.5-0.5b at its published width on SHARD_RANKS
    ranks sharing cuda:0 over gloo (``shard_rank``; NCCL takes one rank per
    card), parameters and moments placed by ``params_shardings``, the hook
    installed, against the same step and ticks on one device (this
    process, same seed and inputs). The step runs in float32, so that its
    update (about lr, a few bf16 ulps of a parameter) is compared and not
    its rounding. Per parameter: the first moment, (1 - b1) times the
    gradient, within 1e-4 of the norm of one device's (the sharded
    backward); the update within 1e-2 lr of one device's at every element
    whose gradient is at least 1e-6 (AdamW's first step is
    lr g / (|g| + eps); where a gradient cancels to about eps = 1e-8, the
    rounding of the two reduction orders moves it by up to lr times that
    rounding over eps, 0.59 lr at one element on an H100: those elements
    are counted and their norm logged); the loss within 1e-4 relative. A
    wrong, partial or missing gradient or update moves them by about
    their size. The greedy ticks in float32 give one device's tokens.
    The ticks in bf16 are fed one device's bf16 tokens, so that both see
    the same inputs; their logits are held at the decode-against-prefill
    tolerance of paths 13 and 14 (5e-2 of the largest), and where the
    sharded argmax differs from one device's, both top-2 margins are
    logged. Logs seconds, peak memory and parameter bytes per rank beside
    one device's."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import greedy_decode, train_step_fn
    from repro_torch.models import init_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import flatten_with_path, path_str, tree_map

    t0 = time.perf_counter()
    work = ROOT / "build" / "shard_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    inp = {"batch": {k: torch.as_tensor(rng.integers(
               0, V, (SHARD_BATCH, LM_SEQ), dtype=np.int32), device="cuda")
               for k in ("tokens", "labels")},
           "token": torch.as_tensor(rng.integers(1, V, (SHARD_BATCH, 1),
                                                 dtype=np.int32),
                                    device="cuda")}
    params = init_model(0, cfg, device="cuda")
    ref_picks, ref_logits = greedy_decode(cfg, params, inp["token"],
                                          SHARD_TICKS, SHARD_MAX_LEN)
    inp["feed"] = ref_picks[:, :-1].contiguous()
    torch.save(inp, work / "inputs.pt")
    p32 = tree_map(lambda x: x.float(), params)
    del params
    fn, ocfg = train_step_fn(cfg32)
    torch.cuda.reset_peak_memory_stats()
    (loss, new, state), sec = sync_time(lambda: fn(
        p32, adamw_init(p32, ocfg), inp["batch"]))
    peak = torch.cuda.max_memory_allocated()
    old = dict((path_str(p, "/"), x) for p, x in flatten_with_path(p32))
    # the references stay on the card, where the comparison runs
    ref = {path_str(p, "/"): x - old[path_str(p, "/")]
           for p, x in flatten_with_path(new)}
    ref_m = {path_str(p, "/"): x for p, x in flatten_with_path(state.m)}
    one_bytes = sum(x.numel() * x.element_size() for x in old.values())
    ref_loss = float(loss)
    del new, state, loss, old
    ref_toks, tsec = sync_time(lambda: greedy_decode(
        cfg32, p32, inp["token"], SHARD_TICKS, SHARD_MAX_LEN)[0])
    del p32
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    mp.spawn(shard_rank, args=(SHARD_RANKS, str(work)), nprocs=SHARD_RANKS,
             join=True)
    t_ranks = time.perf_counter() - t1
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(SHARD_RANKS)]
    got = torch.load(work / "updates.pt", map_location="cuda")
    lr, floor = ocfg.lr, 1e-6 * (1 - ocfg.b1)
    e_m = e_u = e_norm = 0.0
    worst_m = worst_u = ""
    n_ill = 0
    for k, u in ref.items():
        mo, m = ref_m[k], got["m"][k]
        em = float((m - mo).double().norm()) / max(
            float(mo.double().norm()), 1e-300)
        d = (got["update"][k] - u).double()
        well = mo.abs() >= floor
        n_ill += int((~well).sum())
        eu = float(d[well].abs().max()) / lr if bool(well.any()) else 0.0
        if em > e_m:
            e_m, worst_m = em, k
        if eu > e_u:
            e_u, worst_u = eu, k
        e_norm = max(e_norm, float(d.norm()) / max(float(
            u.double().norm()), 1e-300))
    n_all = sum(u.numel() for u in ref.values())
    u_max = max(float(u.abs().max()) for u in ref.values()) / lr
    tokens_equal = all(r["tokens"] == ref_toks.cpu().tolist() for r in ranks)
    sh_logits = torch.load(work / "logits_bf16.pt")
    ref_logits = ref_logits.cpu()
    scale = float(ref_logits.abs().max())
    e_log = float((sh_logits - ref_logits).abs().max())
    picks = torch.tensor(ranks[0]["bf16_picks"])
    parted = []
    for b, t in (picks != ref_picks.cpu()).nonzero().tolist():
        top = ref_logits[b, t].topk(2).values
        mine = sh_logits[b, t].topk(2).values
        parted.append(f"seq {b} tick {t}: one device top-2 margin "
                      f"{float(top[0] - top[1]):.4g}, sharded "
                      f"{float(mine[0] - mine[1]):.4g}")
    log(f"shard: qwen1.5-0.5b at full width on {SHARD_RANKS} ranks "
        f"sharing cuda:0 (gloo), a (1, {SHARD_RANKS}) (data, model) mesh; "
        f"the ranks took {t_ranks:.1f} s from spawn to join")
    log(f"shard train {SHARD_BATCH} x {LM_SEQ} (float32): loss per rank "
        f"{[r['loss'] for r in ranks]} (one device {ref_loss!r}, gate 1e-4 "
        f"rel); first moment against one device's: {e_m:.3e} of its norm "
        f"(gate 1e-4; worst leaf {worst_m}); update where the gradient is "
        f"at least 1e-6: max abs {e_u:.3e} lr (gate 1e-2 lr; worst leaf "
        f"{worst_u}; the largest update {u_max:.4f} lr), {n_ill} of {n_all} "
        f"elements below it; update norm apart at most {e_norm:.3e} of a "
        f"leaf's (logged); seconds per rank "
        f"{[round(r['seconds'], 3) for r in ranks]}"
        f" (one device {sec:.3f}); peak memory per rank "
        f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB (one device "
        f"{peak / 2**30:.2f}); parameter bytes per rank "
        f"{[r['param_bytes'] for r in ranks]} (one device {one_bytes})")
    log(f"shard decode: {SHARD_TICKS} greedy ticks of {SHARD_BATCH} "
        f"sequences (float32), tokens equal to one device's: {tokens_equal};"
        f" seconds per rank {[round(r['decode_seconds'], 3) for r in ranks]} "
        f"(one device {tsec:.3f}); first sequence {ref_toks[0].tolist()}")
    log(f"shard decode bf16, fed one device's tokens: logits max abs diff "
        f"{e_log:.4e} (gate 5e-2 x {scale:.4g}); argmax apart in "
        f"{len(parted)} of {picks.numel()} (sequence, tick)"
        f"{': ' + '; '.join(parted) if parted else ''}; seconds per rank "
        f"{[round(r['bf16_decode_seconds'], 3) for r in ranks]}")
    for r, res in enumerate(ranks):
        assert abs(res["loss"] - ref_loss) <= 1e-4 * abs(ref_loss), \
            f"shard: rank {r}'s loss differs from one device's"
        assert res["param_bytes"] < one_bytes, \
            f"shard: rank {r} holds every parameter byte"
    assert e_m <= 1e-4, \
        f"shard: gradients differ from one device's ({worst_m})"
    assert e_u <= 1e-2, f"shard: updates differ from one device's ({worst_u})"
    assert tokens_equal, "shard: greedy tokens differ from one device's"
    assert e_log <= 5e-2 * scale, "shard: bf16 logits differ"
    shutil.rmtree(work)
    log(f"shard: phase {time.perf_counter() - t0:.1f} s")
    return {"ranks": ranks, "one_device_bytes": one_bytes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--profile", default=None, metavar="DIR")
    ap.add_argument("--dryrun-cells", default=None, metavar="JSON",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.dryrun_cells:       # path 15's subprocess
        dryrun_cells(args.dryrun_cells)
        return 0

    t_start = time.perf_counter()
    dev = device_line()
    build_kernels()
    def elapsed(after: str) -> None:
        log(f"elapsed: {time.perf_counter() - t_start:.1f} s after {after}")

    main = main_path(args.n, args.profile)
    elapsed("the main path")
    right = right_phase(N_RIGHT, args.profile)
    elapsed("the right phase")
    frac_pcg = frac_pcg_phase(args.profile)
    elapsed("frac pcg")
    frac_ns = frac_ns_phase(args.profile)
    elapsed("frac ns")
    lm = lm_phase()
    elapsed("the LM path")
    fam = families_phase()
    elapsed("the other families")
    model_sharding_phase()
    elapsed("model sharding and the dry run")
    # each kernel's widest rank bucket on the ranked paths that launch it:
    # the sampling kernels' on the ranked main path, QR's, SVD's and
    # batched_gemm's (at that call's live ranks) on the ranked
    # right-looking Cholesky
    ranked = {name: [] for name in KERNELS}
    for name in MAIN_KERNELS:
        shape = widest_bucket(main["ranked"][1][name])
        if shape:
            ranked[name].append(("main", shape, None))
    right_shapes = right["right_cholesky_ranked_shapes"]
    for name in ROUND_KERNELS:
        shape = widest_bucket(right_shapes[name])
        if shape:
            ranks = (right_shapes[name][shape][2]
                     if name == "batched_gemm" else None)
            ranked[name].append(("right_cholesky_ranked", shape, ranks))
    # each kernel's widest shape on the fractional-diffusion paths (the
    # sampling kernels' at wA > 128 on frac_pcg; on frac_ns the K-reduction
    # of batched_gemm and its widest call over all no = nb (nb - 1) output
    # tiles, QR and SVD at T = no), at batched_gemm's live ranks
    no = (NS_N // NS_TILE) * (NS_N // NS_TILE - 1)
    for path, res, names in (("frac_pcg", frac_pcg, MAIN_KERNELS),
                             ("frac_ns", frac_ns, ROUND_KERNELS)):
        for name in names:
            sh = res["shapes"][name]
            picks = {widest_bucket(sh)}
            if name == "batched_gemm" and path == "frac_ns":
                picks.add(max((k for k in sh if k[0] == no),
                              key=lambda k: k[2]))
            for shape in sorted(picks):
                ranked[name].append((path, shape, sh[shape][2]
                                     if name == "batched_gemm" else None))
    # the sampling kernels' widest tile-32 shapes on the TLR-KFAC path (its
    # curvature factors' left Cholesky), batched_gemm's at its live ranks
    kfac_shapes = lm["kfac"]["shapes"]
    for name in MAIN_KERNELS:
        shape = widest_bucket(kfac_shapes[name])
        if shape:
            ranked[name].append(("kfac", shape, kfac_shapes[name][shape][2]
                                 if name == "batched_gemm" else None))
    log("widest rank buckets on the ranked paths: " + json.dumps(
        {name: [(path, shape) for path, shape, _ in cases]
         for name, cases in ranked.items()}))
    results = check_kernels(main["ranks_a"], ranked=ranked)
    elapsed("the kernel checks")
    small_parity()
    family_parity()

    other = "flat" if main["batching"] == "ranked" else "ranked"
    by_path = {"main": main["launches"],
               f"main_{other}": main[other][0],
               "round_flat": main["round_flat"][0],
               "round_ranked": main["round_ranked"][0],
               **{key: right[key] for key in (
                   "right_cholesky", "right_ldlt", "right_cholesky_ranked",
                   "right_ldlt_ranked")},
               "frac_pcg": frac_pcg["launches"],
               "serve": main["serve"], "frac_serve": frac_pcg["frac_serve"],
               "frac_ns": frac_ns["launches"],
               **{key: right[key] for key in (
                   "right_cholesky_flat_lookahead",
                   "right_cholesky_ranked_lookahead",
                   "right_ldlt_flat_lookahead",
                   "right_ldlt_ranked_lookahead", "faults")},
               **{key: main[key] for key in (
                   "main_pivot_frobenius", "main_pivot_power",
                   "main_check", "telemetry", "telemetry_serve")},
               **{key: right[key] for key in (
                   "telemetry_right_ranked",
                   "telemetry_right_ranked_lookahead",
                   "telemetry_right_flat", "mixed",
                   *(mesh_key(*run) for run in MESH_RUNS))},
               "kfac": lm["kfac"]["launches"],
               "families": fam["launches"]}
    log(f"main path batching: auto -> {main['batching']} (main_{other}: "
        f"the same operator factored with batching={other})")
    kernels = []
    for name in KERNELS:
        head = next(r for (k, _, d), r in results.items()
                    if k == name and d == "float64" and r["headline"])
        rheads = [r for (k, lbl, d), r in results.items()
                  if k == name and d == "float64"
                  and lbl.startswith(RANKED_HEAD)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the count on the kernel's own path: the main path for the
            # sampling kernels, the right-looking Cholesky for QR and SVD
            "launches": by_path["main" if name in MAIN_KERNELS
                                else "right_cholesky"][name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            # the elementwise gates' largest error (a case with its own
            # gate logs its numbers in its line)
            "max_abs_err": max(r["max_abs_err"] for (k, _, d), r in
                               results.items() if k == name and
                               d == "float64" and not r["own_gate"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            # device time of a headline under DISPATCH_MS (CUDA graph of
            # GRAPH_CALLS calls, inputs warm in L2)
            **{k: head[k] for k in ("graph_ms", "graph_plain_ms",
                                    "graph_library_ms") if k in head},
            "shape": head["shape"], "dtype": "float64",
            # the same numbers at the widest rank bucket of each ranked
            # path that launches it (the path is in the shape label)
            "ranked": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "graph_ms")
                        if k in r} for r in rheads],
            "checked": sorted({f"{lbl} {d}" for (k, lbl, d) in results
                               if k == name}),
        })
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(dev["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
