#!/usr/bin/env python
"""GPU smoke test of cedar_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, and drives the 2D V-cycle (fused and
dense), line-xy and F-cycle solves, the 3D 7- and 27-point V-cycle (fused
and dense) and F-cycle solves and the 3D plane-relaxation solve on the
card, the 2D and 3D periodic solves, the inner multigrid coarse solve
(``cg-solver: cedar``) and the plane-configs beyond line-xy V-cycles,
``solver.ml-relax.enabled`` (K4 and K10 at the full PCR stride), the
handle API (``capi``), the examples and ``profile_trace``, and the
distributed solvers (``DistSolver2``, ``DistSolver3`` over
``torch.distributed``: point, line and plane relaxation, the distributed
SPIKE line solve, periodic axes) in worlds of processes sharing the card,
and ``kernels.backend: xla`` (the plain versions on the card).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. device: the card's name and power limit;
2. build: the kernels from ``cedar_tpu_torch/csrc``, one nvcc per source,
   all started together;
3. kernel against plain version for the sweep (K1), restrict (K2),
   interp-add (K3), zebra line sweep (K4: x and y) and interp (K5) at
   (4096, 4096), (2049, 2049) and (2048, 2048) in float32 and (400, 400)
   and (1025, 771) in float64, and the sweep (K1, bit-equal, one launch a
   sweep: DOWN and UP, with and without the residual and an origin, q
   left as it was) also at the main path's dense levels, the 400² gate's levels, the edges of
   its resident regime and a few points (SWEEP_SHAPES), float32 and
   float64, and the line sweep (K4, bit-equal) also on
   lines of 63, 64 and 65 points, of lengths that are not a multiple of
   the PCR stride, and on lines too long for shared memory (LINE_SHAPES);
   then the 3D sweep (K6, bit-equal, in the regime its plan picks: one
   resident launch, a launch a colour phase, or K14's launches; DOWN and
   UP, with and without the residual and an origin, q left as it was),
   restrict (K7), interp-add (K8) and interp (K9) at (256, 256, 256)
   7-point and (128, 128, 128) 27-point float32 and (33, 21, 17) and
   (65, 65, 65) float64, both kinds, and K6 also at the 3D paths' dense
   levels, the 200³ gate's levels and the edges of its regimes
   (K6_SHAPES); then the batched line-xy smooth (K10, bit-equal)
   at SHAPES_B (from (64, 128, 128) float32 to lines of 63-65 points and
   lines too long for shared memory), 5- and 9-point, DOWN and UP, 1 and
   2 sweeps, with and without the residual,
   and the batched restrict and interp-add (K2, K3, bit-equal) at
   SHAPES_BT, a batch of one against the unbatched launch; K2 and K3
   (bit-equal) also at every batch of planes of the plane-xy cycle, at odd
   and even sizes and at the dense levels of the 4096² path and of the
   400² gate (TRANSFER_SHAPES), float32 and float64, and with q, res and
   the stencil at odd element offsets; then the fused fine-level kernels,
   sweep (K11),
   sweep-residual-restrict (K12) and interp-add-sweep (K13), at the 2D
   shapes and (5, 4) float64, 5- and 9-point, DOWN and UP, every output
   mode, K11 with and without an origin: q, the residual and cb bit-equal,
   the norm's partial sums to rtol NORM_RTOL, K12 and K13 also at the
   edges of their strips and chunks (EDGE2) and K12 at the main path's
   fused levels, after a check that the wrappers' launch plans size shared
   memory as the kernels lay it out; then the fused 3D kernels,
   sweep (K14), sweep-residual-restrict (K15) and interp-add-sweep (K16),
   at the 3D shapes and (5, 4, 3) float64, both kinds, DOWN and UP, every
   output mode, K14 with and without an origin, K15 with and without the
   residual, held to their plain versions the same way (a 27-point one is
   K6's sweep and the edge kernel), and the edge kernel alone in each mode
   against the plain ops it stands for; also at the edges of their tiling
   (EDGE3, float32 and 27-point float64) and at the 3D paths' 27-point
   levels and the 200³ gate's odd ones (LEVELS27), after a check that the
   wrappers' launch plans size their shared memory as the kernels lay it
   out; then the periodic modes (PERIODIC_SWEEP, PERIODIC_TRANSFER,
   PERIODIC_LINES: x-, y- and doubly periodic, 5- and 9-point, bit-equal):
   K1 in both regimes at 4096², 2049² and the periodic paths' levels,
   odd extents included (the small ones on the streamed tile kernel too),
   K2, K3 and K5 at 4096² and odd/even level pairs, K4 cyclic along the
   line and wrapped across it (an odd line count across a periodic axis
   must raise); then the 3D periodic modes (PERIODIC3_SWEEP,
   PERIODIC3_TRANSFER: x-, y-, z- and triply periodic, 7- and 27-point,
   bit-equal): K6 in the regime of its plan (a launch a colour at 256³
   7-point and 128³ 27-point, resident at 16³ float32 and 12³ float64)
   and the resident levels on the per-colour launches too, odd periodic
   extents included (Jacobi phases), K7, K8 and K9; then the batched K1
   (both regimes, the small planes on the tile kernel too), K4 (x and y:
   K10's one-direction mode, a sweep and 2 sweeps + the residual) and K5
   at every batch of the plane-xy 128³ cycle and at BATCH_EDGES (odd
   plane counts and sizes, one-row planes, lines of 63-65 points, K1's
   resident edge), float32 and float64, bit-equal, and a batch of one
   bit-equal to the unbatched launch; then K4 and K10 at the full PCR
   stride (``solver.ml-relax.enabled``), bit-equal to their plain versions
   at the full stride: K4 x and y, 5- and 9-point, DOWN and UP, at 2048²
   float32 and LINE_SHAPES, cyclic and wrapped at PERIODIC_LINES, K10 in
   both modes, a sweep and 2 sweeps with the residual, at (64, 128²) and
   BATCH_EDGES, float32 and float64; then K1 and K6 on the distributed
   paths' shard shapes (a block extended by H = 8: 4096² and 400² on
   (2, 2), 256³ and 200³ on (2, 2, 2), levels 0 and 1) at the origins of
   the first rank of an axis (-H), another rank's and an odd one, DOWN
   and UP, with and without the residual, bit-equal; K4 on the
   distributed line paths' shapes (DIST_LINE_SHAPES: gathered windows,
   cyclic lines on one, SPIKE interiors) and K1 and K6 with a replicated
   periodic axis beside an origin, bit-equal; K10, the batched K1, K4
   and K5, and K2/K3 at the batches of a rank's plane cycles
   (``dist_plane_shapes``: 32 planes of 128² down to 4 of 8² float32, 16
   of 64² down to 4 of 8² float64) and odd batches (DIST_PLANE_ODD),
   5- and 9-point, bit-equal;
4. Cedar's 400² float64 residual history through the kernels (the fused
   cycle, the card's default); a 400² float64 V(2,2) solve, fused on the
   card against dense on the CPU;
4b. float64 gates of the line-xy and F-cycle paths: the 400² solves on the
   card against the same solves on the CPU (plain versions);
4c. Cedar's 3D integration test (200³ float64 7-point Poisson) through
   the kernels (the fused cycle: K14-K16 and the edge kernel on levels
   0-3), then the float64 3D gates, fused on the card against dense on the
   CPU: a 33³ 7-point V(2,2) and a 17³ 27-point V(1,1) solve and a 33³
   F-cycle;
4d. float64 plane-relaxation gates, card against CPU: 16³
   ``diag_diffusion3(1, 1, 1e-3)`` plane-xy (to 1e-9 within 5 cycles),
   8³ Poisson plane-xyz, a 12x10x9 ``fe3`` 27-point plane-yz solve;
4e. every configuration the port runs (GRAPH_CONFIGS: 2D point V, V(2,2)
   and F fused and dense, line-x, -y, -xy; 3D 7- and 27-point V and F,
   fused and dense, plane-xy, -xz, -yz, -xyz; 2D periodic point V,
   line-x, -y, -xy, F and the doubly periodic indefinite solve; 3D
   periodic 7-point V, the 27-point triply periodic indefinite V, F,
   plane-yz and fine-split asked for, at 22x16x16), small, float32 and
   float64, through the solver's captured graph;
4f. float64 periodic gates at 256², card against CPU (PERIODIC_CONFIGS:
   x-periodic point V(1,1), line-x, y-periodic line-y, line-xy, 9-point,
   F-cycle, the doubly periodic indefinite solve to 1e-10);
4g. float64 3D periodic gates at 32³ and 44x32x32, card against CPU
   (PERIODIC3_CONFIGS: 7-point x-periodic V(1,1), the 27-point triply
   periodic indefinite V, (44, 32, 32) x-periodic, odd at its third level,
   the z-periodic F-cycle, x-periodic plane-yz), every K6-K9 launch
   periodic;
4h. float64 inner coarse solve gates: tests/test_cgsolve.py's cases (2D
   128², 3D 24³, nested to depth 2) on the card against its LU solve
   within 1e-10; the plane-config variants (PLANE_GATES: point, line-x
   27-point, line-y, F-cycle, cedar) at 32³, card against CPU;
4i. float64 gates, card against CPU (rtol 1e-9, atol 1e-14): ml-relax
   line-xy at 400² ``diag_diffusion(100, 1)``, plane-xy 64x64x8 with a
   plane-config ml-relax (every K4 and K10 launch at the full stride), a
   2D and a 3D handle solve through ``capi`` (``operator_apply`` to
   1e-13); the four examples on the card at their default sizes (each
   finishes; the planes example's cycles equal the CPU's) and on the card
   and the CPU at their CPU tests' sizes (error norms to rtol 1e-3, as
   those tests hold them to cedar_tpu's examples);
4j. distribution gates: the serial dense solves on the card first
   (``kernels.fine-split`` false, the distributed solvers' cycle), then
   Cedar's 400² float64 history through ``DistSolver2`` on a (2, 2) world
   of 4 processes over gloo, each rank on the card (every message staged
   through the host: one card, so no NCCL among them), x bit for bit the
   serial solve's and the history within the norm's NORM_RTOL; Cedar's
   200³ float64 test through ``DistSolver3`` on a (2, 2, 2) world of 8,
   x bit for bit; a world of one over NCCL (its all-reduce on the card),
   bit for bit; the same worlds run phase 4k's, 5i's and 5j's paths;
4k. distributed float64 gates (the (2, 2) world's DIST_RUNS2 "f64_*"):
   512² line-xy ``diag_diffusion(50, 1)`` within 1e-10 of the serial
   solve, SPIKE on level 0 for x and y; with ml-relax (the gather) and
   256² doubly periodic (indefinite) bit for bit;
4l. ``kernels.backend: xla``: the 4096² float32 V(1,1) solve through the
   graph bit for bit the kernels' dense cycle, no kernel of the table in
   a captured cycle, the two graphs' ms in alternating pairs;
4m. distributed plane relaxation, float64 (the (2, 2, 2) world's
   DIST_PLANE_RUNS "f64_*"): 64³ ``diag_diffusion3(1, 1, 1e-3)``
   plane-xy and plane-xyz to tol 1e-9, x bit for bit the serial solve on
   the card; every rank's colour hierarchies and their batched coarse
   solve bit for bit the serial ones cut to its planes;
5. the main path: 2D Poisson 4096² float32, V(1,1), the fused cycle (the
   solver's default on the card), setup and a solve of four cycles, with
   every kernel's launch count and the launches of one cycle (K1 twice a
   dense level, streamed or resident as its plan says, at most 32
   launches in all); the convergence rate on A x
   = 0 from a random start; then the per-cycle time; then the same solve
   with the dense cycle (``kernels.fine-split`` false) and the fused
   V(2,2), with launches and per-cycle time;
5b. the 2D slices at full width: ``2d_fe_9pt_linexy_2048`` and
   ``2d_poisson_fcycle_4096`` (``bench.py``'s configurations), each with
   setup, a solve, launch counts, per-cycle time and peak memory, and the
   line-xy cycle's K4 launches (one a zebra colour) asserted;
5c. the 3D slice at full width: ``3d_poisson_7pt_256`` and
   ``3d_fe_27pt_128`` (``bench.py``'s configurations), each fused
   (``kernels.fine-split`` true) and dense (false), the fused
   256³ V(2,2) and the fused 256³ F-cycle, each with the same numbers and
   the launches of one cycle;
5d. the plane-relaxation slice at full width: ``3d_aniso_planexy_128``
   (``bench.py``'s configuration), with the same numbers and the launches
   of one cycle, K10's asserted;
5e. the 2D periodic path at full width: 4096² x-periodic and doubly
   periodic (indefinite) Poisson V(1,1), 2048² x-periodic line-x, each
   with setup, a solve, the launches of one cycle (all periodic, no plain
   version), per-cycle time and peak memory;
5f. the 3D periodic path at full width: ``3d_poisson_7pt_256`` periodic
   in x and triply periodic (indefinite), 128³ ``fe3`` triply periodic,
   ``3d_aniso_planexy_128`` periodic in z, each with the same numbers
   (K6-K9's launches all periodic);
5g. the new configurations at full width: ``3d_aniso_planexy_128`` with
   plane-config point, line-x, line-xy F-cycle and ``cedar``, 4096²
   V(1,1) and ``3d_poisson_7pt_256`` with ``num-levels: 3`` and
   ``cedar``, each with the same numbers, the inner steps that were
   active in one cycle and one inner solve's graph ms;
5h. ``2d_fe_9pt_linexy_2048`` with ml-relax (K4 once a zebra colour,
   every launch at the full stride) and ``3d_aniso_planexy_128`` with a
   plane-config ml-relax (K10 at the full stride), each beside its default
   stride: setup, a solve, the launches of one cycle and the two graphs'
   cycle ms in alternating pairs; a 4096² float64 5-point V(1,1) handle
   solve (``bmg2_operator_set_full``, ``bmg2_solver_run``), its x bit for
   bit ``Solver2``'s, with setup, solve and copy seconds; a 4096² V(1,1)
   graph solve of four cycles inside ``profile_trace``, whose trace must
   parse and name the K12 and K13 launches of the replays;
5i. the distributed paths at full width (run in phase 4j's worlds):
   4096² float32 5-point V(1,1) on (2, 2) and ``3d_poisson_7pt_256`` on
   (2, 2, 2), a solve of four cycles, x bit for bit the serial dense
   solve's, then one counted cycle (its exchanges, bytes sent, gathers,
   reductions, host-staged bytes, K1 and K6 launches on rank 0) and ms a
   cycle over DIST_CYCLES eager cycles on every rank: N processes sharing
   one card over gloo, not a multi-GPU figure;
5j. the line and periodic paths at full width (run in phase 4j's
   worlds): ``2d_fe_9pt_linexy_2048`` float32 V(1,1) on (2, 2) with
   ml-relax (the gather, x bit for bit the serial solve) and by default
   (SPIKE, x within SPIKE_RTOL32 of max |x|), 4096² doubly periodic and
   2048² x-periodic line-x on (2, 2), ``3d_poisson_7pt_256`` x-periodic
   on (2, 2, 2) (x bit for bit), each with one counted cycle beside
   tools/dist_comm.py's prediction, the line paths with ms a cycle and
   ms a level-0 sweep by path;
5k. distributed plane relaxation at full width (run in phase 4j's
   (2, 2, 2) world): ``3d_aniso_planexy_128`` float32 V(1,1), x bit for
   bit the serial solve, rank 0's counted cycle equal to
   tools/dist_comm.py's model (exchanges, bytes, gathers, plane gathers,
   reductions, K10's 120 launches), the ranks' colour hierarchies
   checked as in 4m, ms a cycle over DIST_CYCLES eager cycles and
   ms a level-0 xy sweep (host figures);
6. per-kernel times at the main paths' shapes, kernel against plain, and
   each kernel's bound: the least time for its bytes and operations at the
   H100's data-sheet rates; K1's resident regime at 64² 9-point (its
   own entry, ``sweep2_resident``, in the kernel table; ``sweep2`` is the
   streamed one); K10 and the batched K2/K3 at (64, 128, 128); K2 and
   K3 also by their device time with the L2 flushed, at 4096² and (64,
   128, 128);
   K12 and K13 against the dense sequences they replace (K1 with the
   residual, then K2; K3, then K1; K13 also 9-point at 2048²); K14-K16 at
   256³ 7-point and 128³ 27-point (a whole 27-point K14 sweep, the fused
   27-point pre- and post-sweeps), and K15 and K16 against the dense
   sequences they replace (K6 with the residual, then K7; K8, then K6, and
   with the residual and its norm for K16 with the norm); K1 at each of
   the main path's dense levels and K12 at each of its fused levels, with
   their bounds; K6 at 16³ 27-point DOWN with the residual (resident,
   ``sweep3_resident``) and at 64³ (a launch a colour phase and the
   residual, ``sweep3``), and at 256³ 7-point and 128³ 27-point (K14's
   launches, ``sweep3_fused``); the periodic modes at the same shapes
   (K1 streamed 4096² and resident 64², K2, K3, K5 at 4096², K4 2048²
   cyclic x and wrapped y), with their bounds; K6-K9's periodic modes at
   256³ 7-point and 128³ 27-point (K6 per colour, beside the same launches
   without the wrap) and K6 resident at 16³ 27-point; the batched K1
   (5-point + res at (64, 128²), 9-point at (64, 64²)), K4 (x and y at
   (64, 128²)) and K5 ((64, 64²) -> (64, 128²)); K4 (2048² 9-point, x
   and y) and K10 ((64, 128²) 5-point) at the full stride against their
   plain versions and beside the default stride; K1 and K6 on the
   distributed paths' full-size shards ((2064, 2064) 5-point and 144³
   7-point float32) at origin -H; K4 on the gathered x-line window of
   ``2d_fe_9pt_linexy_2048`` on (2, 2) and on its level-0 SPIKE
   interior; K10, the batched K1, K4, K5 and K2/K3 at a rank's level-0
   plane batch of ``3d_aniso_planexy_128`` on (2, 2, 2), (32, 128²).

Every solve of phases 4-5f runs as the solvers run it on the card, one
replay of a captured CUDA graph a cycle, and is held bit for bit to the
same solve run eagerly (``cycle_residual`` a cycle), a ``vcycle`` to
``run_cycle``; the launches of a cycle are counted at a fresh capture,
which prints its warm-up and capture seconds and its memory beside an
eager cycle's, and a replay must count none; the per-cycle times are
eager against graph, 5 alternating pairs of 25 cycles.

It imports neither JAX nor cedar_tpu.  Without a CUDA device it exits
non-zero before printing any result.  The line before the last is the
kernel table as JSON (the periodic, batched and full-stride modes as
entries of their own, ``*_periodic``, ``*_batched``, ``*_fullpcr``); the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cedar_tpu_torch import (
    Config, FivePt, NinePt, SevenPt, Solver2, Solver3, TwentySevenPt,
    capi, gallery,
)
from cedar_tpu_torch.core.types import Dir3, StencilKind
from cedar_tpu_torch.ops import (
    backend, cuda2, cuda3, cuda_build, cuda_fused2, cuda_fused3, cuda_lines2,
    cuda_planes2, cuda_transfer2, cuda_transfer3, interp2, interp3, lines2,
    stencil3,
)
from cedar_tpu_torch.ops.stencil2 import offdiag_apply, residual
from cedar_tpu_torch.parallel import DistSolver2, DistSolver3, make_mesh
from cedar_tpu_torch.parallel import comm, shard_relax
from cedar_tpu_torch.parallel.launch import spawn
from cedar_tpu_torch.solver import cycle2, cycle3, graph, inner
from cedar_tpu_torch.tools import dist_comm
from cedar_tpu_torch.tools.profile_cycle import inner_of
from cedar_tpu_torch.tools.tune_fused2 import plane_transfer_shapes
from cedar_tpu_torch.tools.tune_fused3 import device_ms
from cedar_tpu_torch.utils.timing import profile_trace

CEDAR_HISTORY = [
    0.388629, 0.0443548, 0.00494131, 0.000513399, 5.44908e-05,
    5.60612e-06, 5.86933e-07, 6.04942e-08, 6.30975e-09, 6.52713e-10,
]
CEDAR_ERROR = 2.04592e-05
# kernel against plain version: max |kernel - plain| <= TOL * max |plain|
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the fused kernels' norm partials against the plain version's sum: both
# sum res² in another order
NORM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SHAPES = [((4096, 4096), torch.float32), ((2049, 2049), torch.float32),
          ((2048, 2048), torch.float32),
          ((400, 400), torch.float64), ((1025, 771), torch.float64)]
SHAPES3 = [((256, 256, 256), torch.float32, (False,)),
           ((128, 128, 128), torch.float32, (True,)),
           ((33, 21, 17), torch.float64, (False, True)),
           ((65, 65, 65), torch.float64, (False, True))]
# K14-K16's further shapes (float32), at the edges of their tiling: nx
# not a multiple of the x chunk, nz not a multiple of 4, ny smaller than
# one tile, more tiles than resident blocks (7-point, 27-point)
EDGE3 = [((97, 45, 131), (False,)), ((67, 33, 45), (True,)),
         ((40, 30, 37), (False, True)), ((50, 5, 70), (False, True)),
         ((33, 200, 300), (False,)), ((7, 700, 250), (True,)),
         ((5, 600, 700), (True,))]
# K13's further shapes: widths not a multiple of its strip, rows not a
# multiple of its chunk, fewer rows than its halo, a few points
EDGE2 = [((300, 997), torch.float32), ((3, 1000), torch.float32),
         ((1031, 250), torch.float64), ((2, 3), torch.float64),
         ((777, 513), torch.float32), ((4, 260), torch.float64)]
# K1's further shapes, float32 and float64: the main path's dense levels
# (256² .. 8²), the 400² gate's (25², 13², 7²), the edges of the resident
# regime (90²: 9-point float32 in one block; 64²: 9-point float64; 65²,
# 91² streamed) and a few points
SWEEP_SHAPES = [(256, 256), (128, 128), (64, 64), (32, 32), (16, 16), (8, 8),
                (25, 25), (13, 13), (7, 7), (90, 90), (91, 91), (65, 65),
                (5, 4), (2, 3)]
# K6's further shapes: the 3D paths' dense levels (27-point float32 64³,
# 32³ a launch a colour phase, 16³, 8³ resident), the 200³ float64 gate's
# (25³, 13³ a launch a colour phase, 7³ resident), the edges of the
# regimes (resident 27-point: float32 16³ / 17³ and 512 / 513 points an
# octant, float64 12³ / 13³; the 27-point marches from 96³ float32; the
# 7-point ring from 200³) and a few points, as (shape, dtype, 27-point or
# not)
K6_SHAPES = [((16,) * 3, torch.float32, (False, True)),
             ((8,) * 3, torch.float32, (False, True)),
             ((32,) * 3, torch.float32, (True,)),
             ((64,) * 3, torch.float32, (True,)),
             ((17,) * 3, torch.float32, (True,)),
             ((52, 38, 2), torch.float32, (True,)),
             ((54, 38, 2), torch.float32, (True,)),
             ((95, 96, 96), torch.float32, (True,)),
             ((96,) * 3, torch.float32, (True,)),
             ((199, 200, 200), torch.float32, (False,)),
             ((200,) * 3, torch.float32, (False,)),
             ((25,) * 3, torch.float64, (False, True)),
             ((13,) * 3, torch.float64, (True,)),
             ((12,) * 3, torch.float64, (True,)),
             ((7,) * 3, torch.float64, (False, True)),
             ((5, 4, 3), torch.float64, (False, True)),
             ((2, 3, 1), torch.float32, (False, True))]
# K4's further shapes: lines of 63 (LDLᵀ), 64 and 65 points (PCR), lengths
# that are not a multiple of the PCR stride (1000, 777), and lines too long
# for shared memory (9000 f32, 5000 f64: a device-memory scratch)
LINE_SHAPES = [((63, 65), torch.float32), ((64, 63), torch.float64),
               ((65, 64), torch.float64), ((1000, 777), torch.float32),
               ((9000, 5), torch.float32), ((6, 5000), torch.float64)]
# batched planes (B, nx, ny): the K10 shapes (with lines of 63-65 points,
# of a length that is not a multiple of the PCR stride and too long for
# shared memory), and the batched K2/K3 shapes
SHAPES_B = [((64, 128, 128), torch.float32), ((7, 33, 21), torch.float64),
            ((5, 4, 3), torch.float64), ((3, 63, 65), torch.float32),
            ((2, 64, 1000), torch.float64), ((1, 5, 7000), torch.float64)]
SHAPES_BT = [((64, 128, 128), torch.float32), ((5, 33, 17), torch.float64),
             ((3, 129, 65), torch.float32), ((7, 2, 3), torch.float64)]
# K2 and K3's further shapes (B, nx, ny), float32 and float64, beside the
# plane-xy cycle's batches (tools/tune_fused2.plane_transfer_shapes): odd and even sizes, a row or a
# column of one point, and unbatched the 4096² path's dense levels (256²
# .. 8²) and the 400² gate's levels (200² .. 7²; 400² is in SHAPES)
TRANSFER_SHAPES = ([(3, 129, 65), (5, 33, 17), (7, 2, 3), (1, 65, 63),
                    (2, 1, 9), (4, 9, 1), (2, 66, 130)]
                   + [(1, n, n) for n in (256, 128, 64, 32, 16, 8)]
                   + [(1, n, n) for n in (200, 100, 50, 25, 13, 7)])
# every row of the TPU kernel table (PERF.md) a kernel covers
REPLACES = {
    # K1 in its two regimes: streamed (the tile kernel) and resident
    "sweep2": "cedar_tpu/ops/pallas2.py:137",
    "sweep2_resident": "cedar_tpu/ops/pallas2.py:137",
    "restrict2": "cedar_tpu/ops/pallas_transfer2.py:126",
    # row 7 (the split interp-add) is K3's function in the dense layout
    "interp_add2": ("cedar_tpu/ops/pallas_transfer2.py:256, "
                    "cedar_tpu/ops/pallas_transfer2.py:266"),
    "line2": "cedar_tpu/ops/pallas_lines2.py:142",
    "interp2": "cedar_tpu/ops/pallas_transfer2.py:817",
    # K6 in its regimes: one launch a colour phase and the residual, one
    # block at the coarse levels (resident); K14's launches above them
    "sweep3": "cedar_tpu/ops/pallas3.py:190, cedar_tpu/ops/pallas3.py:473",
    "sweep3_resident": ("cedar_tpu/ops/pallas3.py:190, "
                        "cedar_tpu/ops/pallas3.py:473"),
    "restrict3": ("cedar_tpu/ops/pallas_transfer3.py:192, "
                  "cedar_tpu/ops/pallas3_split.py:723, "
                  "cedar_tpu/ops/pallas3_split.py:823"),
    "interp_add3": ("cedar_tpu/ops/pallas3_split.py:1063, "
                    "cedar_tpu/ops/pallas3_split.py:1247"),
    "interp3": ("cedar_tpu/ops/pallas3_split.py:1101, "
                "cedar_tpu/ops/pallas3_split.py:1198"),
    "line_xy2": "cedar_tpu/ops/pallas_planes2.py:158",
    "sweep2_fused": "cedar_tpu/ops/pallas2_split.py:200",
    "sweep_restrict2": "cedar_tpu/ops/pallas_transfer2.py:341",
    "interp_sweep2": "cedar_tpu/ops/pallas_transfer2.py:545",
    # rows 14 and 20 (the split sweep and its wavefront schedule; K6's
    # levels above one block, rows 11 and 12, run it too), 15 (+ the
    # wavefront sweep_restrict_stream3 route), 17 and 21
    "sweep3_fused": ("cedar_tpu/ops/pallas3_split.py:442, "
                     "cedar_tpu/ops/pallas3_stream.py:161, "
                     "cedar_tpu/ops/pallas3_stream.py:227, "
                     "cedar_tpu/ops/pallas3.py:190, "
                     "cedar_tpu/ops/pallas3.py:473"),
    "sweep_restrict3": ("cedar_tpu/ops/pallas3_split.py:465, "
                        "cedar_tpu/ops/pallas3_stream.py:893"),
    "interp_sweep3": ("cedar_tpu/ops/pallas3_split.py:492, "
                      "cedar_tpu/ops/pallas3_stream.py:175, "
                      "cedar_tpu/ops/pallas3_stream.py:192"),
    # the 27-point K15 and K16 beside K6's sweep: the residual and its
    # restriction (row 15), the interp-add of the recomputed residual
    # (row 17), and the norm of a 27-point fused top level
    "edge27": ("cedar_tpu/ops/pallas3_split.py:465, "
               "cedar_tpu/ops/pallas3_split.py:492"),
    # the periodic modes, entries of their own (their launches are those
    # of the periodic paths): K1's is the Pallas sweep's periodic mode;
    # the JAX package runs the periodic transfers and line solves in XLA,
    # so K2-K5's periodic modes extend the kernels of those rows
    "sweep2_periodic": "cedar_tpu/ops/pallas2.py:137",
    "sweep2_resident_periodic": "cedar_tpu/ops/pallas2.py:137",
    "restrict2_periodic": "cedar_tpu/ops/pallas_transfer2.py:126",
    "interp_add2_periodic": ("cedar_tpu/ops/pallas_transfer2.py:256, "
                             "cedar_tpu/ops/pallas_transfer2.py:266"),
    "line2_periodic": "cedar_tpu/ops/pallas_lines2.py:142",
    "interp2_periodic": "cedar_tpu/ops/pallas_transfer2.py:817",
    # the 3D periodic modes: the JAX package runs every periodic 3D cycle
    # in XLA (cedar_tpu/solver/cycle3.py:24-25), so K6-K9's periodic modes
    # extend the kernels of their rows
    "sweep3_periodic": ("cedar_tpu/ops/pallas3.py:190, "
                        "cedar_tpu/ops/pallas3.py:473"),
    "sweep3_resident_periodic": ("cedar_tpu/ops/pallas3.py:190, "
                                 "cedar_tpu/ops/pallas3.py:473"),
    "restrict3_periodic": ("cedar_tpu/ops/pallas_transfer3.py:192, "
                           "cedar_tpu/ops/pallas3_split.py:723, "
                           "cedar_tpu/ops/pallas3_split.py:823"),
    "interp_add3_periodic": ("cedar_tpu/ops/pallas3_split.py:1063, "
                             "cedar_tpu/ops/pallas3_split.py:1247"),
    "interp3_periodic": ("cedar_tpu/ops/pallas3_split.py:1101, "
                         "cedar_tpu/ops/pallas3_split.py:1198"),
    # the batched modes, entries of their own (their launches are those of
    # the plane-config paths): the Pallas sweep batched by pallas_call's
    # vmap rule, the zebra line sweep through its custom_vmap, the F-cycle's
    # interpolation under the vmapped plane cycles
    "sweep2_batched": ("cedar_tpu/ops/pallas2.py:137, "
                       "cedar_tpu/ops/pallas2.py:346"),
    "line2_batched": ("cedar_tpu/ops/pallas_lines2.py:142, "
                      "cedar_tpu/ops/pallas_lines2.py:296"),
    "interp2_batched": "cedar_tpu/ops/pallas_transfer2.py:817",
    # the full-stride modes (solver.ml-relax.enabled), entries of their own
    # (their launches are those of the ml-relax paths): under ml-relax the
    # JAX package solves the lines by its full-length PCR in XLA
    # (`_pcr_solve`) in place of the line kernels of rows 9 and 10
    "line2_fullpcr": ("cedar_tpu/ops/lines2.py:80, "
                      "cedar_tpu/ops/pallas_lines2.py:142"),
    "planes2_fullpcr": ("cedar_tpu/ops/lines2.py:80, "
                        "cedar_tpu/ops/pallas_planes2.py:158"),
    # the distributed modes, entries of their own (their launches are the
    # distributed paths' on one rank): K1 and K6 on halo-extended shards
    # with the global colour origin, as cedar_tpu's shard_map sweeps
    # (cedar_tpu/parallel/shard_relax.py:137, :169) call the Pallas kernels
    "sweep2_dist": "cedar_tpu/ops/pallas2.py:137",
    "sweep3_dist": ("cedar_tpu/ops/pallas3.py:190, "
                    "cedar_tpu/ops/pallas3.py:473"),
}
SOURCES = {
    "sweep2": "cedar_tpu_torch/csrc/sweep2.cu",
    "sweep2_resident": "cedar_tpu_torch/csrc/sweep2.cu",
    "restrict2": "cedar_tpu_torch/csrc/transfer2.cu",
    "interp_add2": "cedar_tpu_torch/csrc/transfer2.cu",
    "line2": "cedar_tpu_torch/csrc/lines2.cu",
    "interp2": "cedar_tpu_torch/csrc/transfer2.cu",
    "sweep3": "cedar_tpu_torch/csrc/sweep3.cu",
    "sweep3_resident": "cedar_tpu_torch/csrc/sweep3.cu",
    "restrict3": "cedar_tpu_torch/csrc/transfer3.cu",
    "interp_add3": "cedar_tpu_torch/csrc/transfer3.cu",
    "interp3": "cedar_tpu_torch/csrc/transfer3.cu",
    "line_xy2": "cedar_tpu_torch/csrc/planes2.cu",
    "sweep2_fused": "cedar_tpu_torch/csrc/fused2.cu",
    "sweep_restrict2": "cedar_tpu_torch/csrc/fused2.cu",
    "interp_sweep2": "cedar_tpu_torch/csrc/fused2.cu",
    "sweep3_fused": "cedar_tpu_torch/csrc/fused3.cu",
    "sweep_restrict3": "cedar_tpu_torch/csrc/fused3.cu",
    "interp_sweep3": "cedar_tpu_torch/csrc/fused3.cu",
    "edge27": "cedar_tpu_torch/csrc/edge3.cu",
    "sweep2_periodic": "cedar_tpu_torch/csrc/tile2.cuh",
    "sweep2_resident_periodic": "cedar_tpu_torch/csrc/sweep2.cu",
    "restrict2_periodic": "cedar_tpu_torch/csrc/transfer2.cu",
    "interp_add2_periodic": "cedar_tpu_torch/csrc/transfer2.cu",
    "line2_periodic": "cedar_tpu_torch/csrc/lines2.cu",
    "interp2_periodic": "cedar_tpu_torch/csrc/transfer2.cu",
    "sweep3_periodic": "cedar_tpu_torch/csrc/sweep3.cu",
    "sweep3_resident_periodic": "cedar_tpu_torch/csrc/sweep3.cu",
    "restrict3_periodic": "cedar_tpu_torch/csrc/transfer3.cu",
    "interp_add3_periodic": "cedar_tpu_torch/csrc/transfer3.cu",
    "interp3_periodic": "cedar_tpu_torch/csrc/transfer3.cu",
    "sweep2_batched": "cedar_tpu_torch/csrc/sweep2.cu",
    "line2_batched": "cedar_tpu_torch/csrc/planes2.cu",
    "interp2_batched": "cedar_tpu_torch/csrc/transfer2.cu",
    "line2_fullpcr": "cedar_tpu_torch/csrc/lines2.cu",
    "planes2_fullpcr": "cedar_tpu_torch/csrc/planes2.cu",
    "sweep2_dist": "cedar_tpu_torch/csrc/sweep2.cu",
    "sweep3_dist": "cedar_tpu_torch/csrc/sweep3.cu",
}
# the periodic modes' entries, each with the entry of its kernel
PERIODIC_OF = {k + "_periodic": k for k in (
    "sweep2", "sweep2_resident", "restrict2", "interp_add2", "line2",
    "interp2")}
PERIODIC3_OF = {k + "_periodic": k for k in (
    "sweep3", "sweep3_resident", "restrict3", "interp_add3", "interp3")}
PERIODIC_OF.update(PERIODIC3_OF)
KERNELS = tuple(REPLACES)
# K1 launched in either regime
K1 = ("sweep2", "sweep2_resident")
# full widths: the V-cycle main path and the F-cycle at N_MAIN², line-xy
# at N_LINES², the 3D 7-point V- and F-cycle at N_3D³ and the 27-point
# V-cycle at N_27³, plane-xy at N_PLANES³ (bench.py's configurations)
N_MAIN = 4096
N_LINES = 2048
N_3D = 256
N_27 = 128
N_PLANES = 128
# the float64 periodic gates (card against CPU)
N_PERIODIC_GATE = 256
# the float64 plane-config gates (card against CPU)
N_PLANE_GATE = 32
# kernels.split-levels: the top levels that run the fused cycle (the
# solver's default)
SPLIT_LEVELS = 4
# Cedar's 3D integration test size (test/3d/test_poisson.cc:74-105)
N_CEDAR3 = 200
# the H100 SXM data sheet at its 700 W limit: HBM bytes/s, and FLOP/s
# outside the tensor cores by dtype (the bound of phase 6)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

DEV = torch.device("cuda", 0)
# eager against graph cycle times: alternating pairs of runs
PAIRS = 5


def counts() -> dict:
    return {
        "sweep2": cuda2.launches,
        "sweep2_resident": cuda2.resident_launches,
        "restrict2": cuda_transfer2.restrict_launches,
        "interp_add2": cuda_transfer2.interp_launches,
        "line2": cuda_lines2.launches,
        "interp2": cuda_transfer2.interp2_launches,
        "sweep3": cuda3.launches,
        "sweep3_resident": cuda3.resident_launches,
        "restrict3": cuda_transfer3.restrict_launches,
        "interp_add3": cuda_transfer3.interp_add_launches,
        "interp3": cuda_transfer3.interp_launches,
        "line_xy2": cuda_planes2.launches,
        "sweep2_fused": cuda_fused2.sweep_launches,
        "sweep_restrict2": cuda_fused2.sweep_restrict_launches,
        "interp_sweep2": cuda_fused2.interp_sweep_launches,
        "sweep3_fused": cuda_fused3.sweep_launches,
        "sweep_restrict3": cuda_fused3.sweep_restrict_launches,
        "interp_sweep3": cuda_fused3.interp_sweep_launches,
        "edge27": cuda_fused3.edge_launches,
        "sweep2_periodic": cuda2.periodic_launches,
        "sweep2_resident_periodic": cuda2.periodic_resident_launches,
        "restrict2_periodic": cuda_transfer2.restrict_periodic_launches,
        "interp_add2_periodic": cuda_transfer2.interp_periodic_launches,
        "line2_periodic": cuda_lines2.periodic_launches,
        "interp2_periodic": cuda_transfer2.interp2_periodic_launches,
        "sweep3_periodic": cuda3.periodic_launches,
        "sweep3_resident_periodic": cuda3.periodic_resident_launches,
        "restrict3_periodic": cuda_transfer3.restrict_periodic_launches,
        "interp_add3_periodic": cuda_transfer3.interp_add_periodic_launches,
        "interp3_periodic": cuda_transfer3.interp_periodic_launches,
        "sweep2_batched": cuda2.batched_launches,
        "line2_batched": cuda_planes2.line_launches,
        "interp2_batched": cuda_transfer2.interp2_batched_launches,
        "line2_fullpcr": cuda_lines2.fullpcr_launches,
        "planes2_fullpcr": cuda_planes2.fullpcr_launches,
        "sweep2_plain": cuda2.plain_calls,
        "sweep2_resident_plain": cuda2.plain_calls,
        "restrict2_plain": cuda_transfer2.restrict_plain_calls,
        "interp_add2_plain": cuda_transfer2.interp_plain_calls,
        "line2_plain": cuda_lines2.plain_calls,
        "interp2_plain": cuda_transfer2.interp2_plain_calls,
        "sweep3_plain": cuda3.plain_calls,
        "sweep3_resident_plain": cuda3.plain_calls,
        "restrict3_plain": cuda_transfer3.restrict_plain_calls,
        "interp_add3_plain": cuda_transfer3.interp_add_plain_calls,
        "interp3_plain": cuda_transfer3.interp_plain_calls,
        "line_xy2_plain": cuda_planes2.plain_calls,
        "sweep2_fused_plain": cuda_fused2.sweep_plain_calls,
        "sweep_restrict2_plain": cuda_fused2.sweep_restrict_plain_calls,
        "interp_sweep2_plain": cuda_fused2.interp_sweep_plain_calls,
        "sweep3_fused_plain": cuda_fused3.sweep_plain_calls,
        "sweep_restrict3_plain": cuda_fused3.sweep_restrict_plain_calls,
        "interp_sweep3_plain": cuda_fused3.interp_sweep_plain_calls,
        "edge27_plain": cuda_fused3.edge_plain_calls,
        "sweep2_periodic_plain": cuda2.plain_calls,
        "sweep2_resident_periodic_plain": cuda2.plain_calls,
        "restrict2_periodic_plain": cuda_transfer2.restrict_plain_calls,
        "interp_add2_periodic_plain": cuda_transfer2.interp_plain_calls,
        "line2_periodic_plain": cuda_lines2.plain_calls,
        "interp2_periodic_plain": cuda_transfer2.interp2_plain_calls,
        "sweep3_periodic_plain": cuda3.plain_calls,
        "sweep3_resident_periodic_plain": cuda3.plain_calls,
        "restrict3_periodic_plain": cuda_transfer3.restrict_plain_calls,
        "interp_add3_periodic_plain": cuda_transfer3.interp_add_plain_calls,
        "interp3_periodic_plain": cuda_transfer3.interp_plain_calls,
        "sweep2_batched_plain": cuda2.plain_calls,
        "line2_batched_plain": cuda_planes2.plain_calls,
        "interp2_batched_plain": cuda_transfer2.interp2_plain_calls,
        "line2_fullpcr_plain": cuda_lines2.plain_calls,
        "planes2_fullpcr_plain": cuda_planes2.plain_calls,
        # the distributed entries' plain versions are K1's and K6's (their
        # launches: dist_counts, in a rank)
        "sweep2_dist_plain": cuda2.plain_calls,
        "sweep3_dist_plain": cuda3.plain_calls,
    }


def dist_counts() -> dict:
    """:func:`counts` with the distributed entries (in a rank of a
    distributed path): K1's and K6's launches in any regime."""
    c = counts()
    c["sweep2_dist"] = c["sweep2"] + c["sweep2_resident"]
    c["sweep3_dist"] = (c["sweep3"] + c["sweep3_resident"]
                        + c["sweep3_fused"])
    return c


def reset_counts() -> None:
    cuda2.launches = cuda2.resident_launches = cuda2.plain_calls = 0
    cuda2.periodic_launches = cuda2.periodic_resident_launches = 0
    cuda2.batched_launches = 0
    cuda_planes2.line_launches = 0
    cuda_lines2.fullpcr_launches = cuda_planes2.fullpcr_launches = 0
    cuda_transfer2.interp2_batched_launches = 0
    cuda_transfer2.restrict_launches = cuda_transfer2.interp_launches = 0
    cuda_transfer2.restrict_periodic_launches = 0
    cuda_transfer2.interp_periodic_launches = 0
    cuda_transfer2.interp2_periodic_launches = 0
    cuda_lines2.periodic_launches = 0
    cuda_transfer2.restrict_plain_calls = 0
    cuda_transfer2.interp_plain_calls = 0
    cuda_transfer2.interp2_launches = cuda_transfer2.interp2_plain_calls = 0
    cuda_lines2.launches = cuda_lines2.plain_calls = 0
    cuda3.launches = cuda3.resident_launches = cuda3.plain_calls = 0
    cuda3.periodic_launches = cuda3.periodic_resident_launches = 0
    cuda_transfer3.restrict_periodic_launches = 0
    cuda_transfer3.interp_add_periodic_launches = 0
    cuda_transfer3.interp_periodic_launches = 0
    cuda_transfer3.restrict_launches = 0
    cuda_transfer3.interp_add_launches = 0
    cuda_transfer3.interp_launches = 0
    cuda_transfer3.restrict_plain_calls = 0
    cuda_transfer3.interp_add_plain_calls = 0
    cuda_transfer3.interp_plain_calls = 0
    cuda_planes2.launches = cuda_planes2.plain_calls = 0
    cuda_fused2.sweep_launches = cuda_fused2.sweep_plain_calls = 0
    cuda_fused2.sweep_restrict_launches = 0
    cuda_fused2.sweep_restrict_plain_calls = 0
    cuda_fused2.interp_sweep_launches = 0
    cuda_fused2.interp_sweep_plain_calls = 0
    for k in ("sweep", "sweep_restrict", "interp_sweep", "edge"):
        setattr(cuda_fused3, f"{k}_launches", 0)
        setattr(cuda_fused3, f"{k}_plain_calls", 0)


def require_launched(c: dict, names, what: str) -> None:
    """Each kernel of ``names`` launched (a tuple of names: one of them),
    and no plain version ran."""
    for k in names:
        if sum(c[n] for n in (k if isinstance(k, tuple) else (k,))) <= 0:
            raise AssertionError(f"{what} did not launch {k}")
    for k in KERNELS:
        if c[k + "_plain"] != 0:
            raise AssertionError(f"{what} ran the plain version of {k}")


def random_problem(shape, nine: bool, dtype, seed: int):
    """A diagonally dominant random stencil (the layout of
    tests/test_kernels_2d.random_so) with random q and b, made on the card
    from ``seed``; ``shape`` ``(nx, ny)``, or ``(B, nx, ny)`` for a batch of
    independent planes (stencil ``(ndir, B, nx, ny)``)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    *batch, nx, ny = shape

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand((*batch, *s), generator=g,
                                           device=DEV, dtype=dtype)

    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    so = torch.zeros((kind.ndirs, *shape), dtype=dtype, device=DEV)
    so[1, ..., 1:, :] = u(0.5, 1.5, nx - 1, ny)
    so[2, ..., :, 1:] = u(0.5, 1.5, nx, ny - 1)
    if nine:
        so[3, ..., 1:, 1:] = u(0.1, 0.5, nx - 1, ny - 1)
        so[4, ..., 1:, 1:] = u(0.1, 0.5, nx - 1, ny - 1)
    so[0] = offdiag_apply(so, torch.ones(shape, dtype=dtype, device=DEV),
                          kind) + u(0.05, 0.2, nx, ny)
    q = torch.randn(shape, generator=g, device=DEV, dtype=dtype)
    b = torch.randn(shape, generator=g, device=DEV, dtype=dtype)
    return so, q, b, kind


def compare(what: str, got: torch.Tensor, want: torch.Tensor,
            exact: bool = False) -> float:
    """max |got - want|, at most TOL · max |want|, or 0 when ``exact``."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or "
                             "non-finite values")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = 0.0 if exact else TOL[want.dtype] * scale
    print(f"  {what}: max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{what}: kernel disagrees with plain version")
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[1] device: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_build.load_all()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (secs, log) in cuda_build.build_log.items():
        print(f"  nvcc {name}: {secs:.2f} s", flush=True)
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line:
                print(f"    {entry}: {line.split(':', 1)[1].strip()}",
                      flush=True)


def phase_kernels() -> dict:
    print("[3] kernels against plain versions", flush=True)
    errs = dict.fromkeys(KERNELS, 0.0)
    for i, (shape, dtype) in enumerate(SHAPES):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 100 + i)
            pts = "9pt" if nine else "5pt"
            k, e = compare_sweep(so, q, b, kind, pts, tag)
            errs[k] = max(errs[k], e)
            ci = interp2.setup_interp(so, kind)
            nc = (ci.shape[1] - 1, ci.shape[2] - 1)
            g = torch.Generator(device=DEV).manual_seed(200 + i)
            qc = torch.randn(nc, generator=g, device=DEV, dtype=dtype)
            e = compare(f"K2 restrict2 {pts} {tag}",
                        cuda_transfer2.restrict(ci, b),
                        cuda_transfer2.restrict_plain(ci, b), exact=True)
            errs["restrict2"] = max(errs["restrict2"], e)
            e = compare(f"K3 interp_add2 {pts} {tag}",
                        cuda_transfer2.interp_add(ci, so, qc, b, q.clone()),
                        cuda_transfer2.interp_add_plain(ci, so, qc, b,
                                                        q.clone()),
                        exact=True)
            errs["interp_add2"] = max(errs["interp_add2"], e)
            e = compare(f"K5 interp2 {pts} {tag}",
                        cuda_transfer2.interp(ci, qc, shape),
                        cuda_transfer2.interp_plain(ci, qc, shape))
            errs["interp2"] = max(errs["interp2"], e)
            errs["line2"] = max(errs["line2"],
                                compare_lines(so, q, b, kind, pts, tag))
    for i, (shape, dtype) in enumerate(LINE_SHAPES):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 300 + i)
            pts = "9pt" if nine else "5pt"
            errs["line2"] = max(errs["line2"],
                                compare_lines(so, q, b, kind, pts, tag))
    for i, (shape, dtype) in enumerate(
            itertools.product(SWEEP_SHAPES, (torch.float32, torch.float64))):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 1100 + i)
            pts = "9pt" if nine else "5pt"
            k, e = compare_sweep(so, q, b, kind, pts, tag)
            errs[k] = max(errs[k], e)
    return errs


def compare_sweep(so, q, b, kind, pts: str, tag: str,
                  periodic=(False, False), p=None,
                  origins=((0, 0), (1, 2))) -> float:
    """K1, DOWN and UP, with and without the residual and an origin,
    bit-equal to its plain version, and q left as it was (out of place in
    both regimes); ``periodic`` the periodic axes, ``p`` a plan (default
    :func:`cuda2.plan`'s); returns the regime's kernel name and the
    largest error."""
    e = 0.0
    nine = kind == StencilKind.nine_pt
    if p is None:
        p = cuda2.plan(q.element_size(), nine, tuple(q.shape))
    regime = "resident" if p.resident else "streamed"
    if any(periodic):
        regime += f", periodic {tuple(int(a) for a in periodic)}"
    q0 = q.clone()
    for updown, fuse, origin in itertools.product(
            ("down", "up"), (False, True), origins):
        got = cuda2._sweep(p, so, q, b, kind, updown, fuse, origin, periodic)
        want = cuda2.sweep_plain(so, q, b, kind, updown, fuse, origin,
                                 periodic)
        what = (f"K1 sweep2 {pts} {updown} fuse={int(fuse)} "
                f"origin={origin} {tag} ({regime})")
        if not torch.equal(q, q0):
            raise AssertionError(f"{what}: the sweep changed q")
        if fuse:
            e = max(e, compare(what + " q", got[0], want[0], exact=True),
                    compare(what + " res", got[1], want[1], exact=True))
        else:
            e = max(e, compare(what, got, want, exact=True))
    return ("sweep2_resident" if p.resident else "sweep2"), e


def compare_lines(so, q, b, kind, pts: str, tag: str,
                  periodic=(False, False), full: bool = False) -> float:
    """K4, x- and y-lines, DOWN and UP, bit-equal to its plain version;
    on ``periodic`` axes cyclic along the line and wrapped across it.  An
    odd number of lines across a periodic axis must raise in both.
    ``full``: both at the full PCR stride (``solver.ml-relax.enabled``)."""
    e = 0.0
    per = tuple(bool(a) for a in periodic)
    if any(per):
        tag += f" periodic {tuple(int(a) for a in per)}"
    if full:
        tag += " full-stride"
    for axis in ("x", "y"):
        kernel = cuda_lines2.line_x if axis == "x" else cuda_lines2.line_y
        plain = (cuda_lines2.line_x_plain if axis == "x"
                 else cuda_lines2.line_y_plain)
        across, nlines = ((per[1], q.shape[1]) if axis == "x"
                          else (per[0], q.shape[0]))
        if across and nlines % 2:
            for fn in (kernel, plain):
                try:
                    fn(so, q.clone(), b, kind, "down", periodic=per)
                except ValueError:
                    continue
                raise AssertionError(f"K4 {axis} {tag}: {nlines} lines "
                                     "across a periodic axis did not raise")
            print(f"  K4 line2 {axis} {pts} {tag}: {nlines} lines across a "
                  "periodic axis raise", flush=True)
            continue
        for updown in ("down", "up"):
            e = max(e, compare(f"K4 line2 {axis} {pts} {updown} {tag}",
                               kernel(so, q.clone(), b, kind, updown,
                                      periodic=per, full=full),
                               plain(so, q.clone(), b, kind, updown,
                                     periodic=per, full=full),
                               exact=True))
    return e


def random_problem3(shape, ts: bool, dtype, seed: int):
    """A diagonally dominant random 3D stencil (the layout of
    tests/test_kernels_3d.random_so) with random q and b, made on the card
    from ``seed``."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    nx, ny, nz = shape

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(s, generator=g, device=DEV,
                                           dtype=dtype)

    kind = TwentySevenPt if ts else SevenPt
    so = torch.zeros((kind.ndirs, nx, ny, nz), dtype=dtype, device=DEV)
    so[Dir3.PW, 1:] = u(0.5, 1.5, nx - 1, ny, nz)
    so[Dir3.PS, :, 1:] = u(0.5, 1.5, nx, ny - 1, nz)
    so[Dir3.B, :, :, 1:] = u(0.5, 1.5, nx, ny, nz - 1)
    if ts:
        so[Dir3.PSW, 1:, 1:] = u(0.1, 0.4, nx - 1, ny - 1, nz)
        so[Dir3.PNW, 1:, 1:] = u(0.1, 0.4, nx - 1, ny - 1, nz)
        so[Dir3.BW, 1:, :, 1:] = u(0.1, 0.4, nx - 1, ny, nz - 1)
        so[Dir3.BE, 1:, :, 1:] = u(0.1, 0.4, nx - 1, ny, nz - 1)
        so[Dir3.BS, :, 1:, 1:] = u(0.1, 0.4, nx, ny - 1, nz - 1)
        so[Dir3.BN, :, 1:, 1:] = u(0.1, 0.4, nx, ny - 1, nz - 1)
        for d in (Dir3.BSW, Dir3.BNW, Dir3.BNE, Dir3.BSE):
            so[d, 1:, 1:, 1:] = u(0.05, 0.2, nx - 1, ny - 1, nz - 1)
    so[Dir3.P] = stencil3.offdiag_apply(
        so, torch.ones(shape, dtype=dtype, device=DEV), kind) + u(
            0.05, 0.2, nx, ny, nz)
    q = torch.randn(shape, generator=g, device=DEV, dtype=dtype)
    b = torch.randn(shape, generator=g, device=DEV, dtype=dtype)
    return so, q, b, kind


def phase_kernels3(errs: dict) -> dict:
    """K6-K9 against their plain versions at the 3D shapes, K6 also at
    K6_SHAPES."""
    print("[3] 3D kernels against plain versions", flush=True)
    for k in ("sweep3", "sweep3_resident", "restrict3", "interp_add3",
              "interp3"):
        errs.setdefault(k, 0.0)
    threads, smem = (cuda_build.load("sweep3").cedar_sweep3_threads(),
                     cuda_build.load("sweep3").cedar_sweep3_smem())
    if (threads, smem) != (cuda3.THREADS, cuda_build.BLOCK_SMEM):
        raise AssertionError(f"K6 built with {threads} threads a block and "
                             f"{smem} bytes of shared memory")
    for i, (shape, dtype, kinds) in enumerate(K6_SHAPES):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for ts in kinds:
            so, q, b, kind = random_problem3(shape, ts, dtype, 1300 + i)
            k, e = compare_sweep3(so, q, b, kind, tag)
            errs[k] = max(errs.get(k, 0.0), e)
            del so, q, b
    for i, (shape, dtype, kinds) in enumerate(SHAPES3):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for ts in kinds:
            so, q, b, kind = random_problem3(shape, ts, dtype, 300 + i)
            pts = "27pt" if ts else "7pt"
            k, e = compare_sweep3(so, q, b, kind, tag)
            errs[k] = max(errs.get(k, 0.0), e)
            ci = interp3.setup_interp(so, kind)
            nc = tuple(n - 1 for n in ci.shape[1:])
            g = torch.Generator(device=DEV).manual_seed(400 + i)
            qc = torch.randn(nc, generator=g, device=DEV, dtype=dtype)
            e = compare(f"K7 restrict3 {pts} {tag}",
                        cuda_transfer3.restrict(ci, b),
                        cuda_transfer3.restrict_plain(ci, b))
            errs["restrict3"] = max(errs["restrict3"], e)
            e = compare(f"K8 interp_add3 {pts} {tag}",
                        cuda_transfer3.interp_add(ci, so, qc, b, q.clone()),
                        cuda_transfer3.interp_add_plain(ci, so, qc, b,
                                                        q.clone()))
            errs["interp_add3"] = max(errs["interp_add3"], e)
            e = compare(f"K9 interp3 {pts} {tag}",
                        cuda_transfer3.interp(ci, qc, shape),
                        cuda_transfer3.interp_plain(ci, qc, shape))
            errs["interp3"] = max(errs["interp3"], e)
            del so, q, b, ci, qc
    return errs


def compare_sweep3(so, q, b, kind, tag: str, periodic=(False,) * 3,
                   plan=None, origins=((0, 0, 0), (1, 2, 3))):
    """K6, DOWN and UP, with and without the residual and an odd origin,
    bit-equal to its plain version, and q left as it was, in the regime
    its plan picks (resident in one block, one launch a colour phase, or
    K14's launches; ``plan``: that one instead), with the couplings
    wrapping around the ``periodic`` axes; returns the kernel's name in
    the table (K14's launches count as ``sweep3_fused``; a periodic one's
    ends in ``_periodic``) and the largest error."""
    ts = kind == StencilKind.twenty_seven_pt
    p = plan or cuda3.plan(q.element_size(), ts, tuple(q.shape),
                           periodic=any(periodic))
    regime = p.route
    pts = "27pt" if ts else "7pt"
    if any(periodic):
        regime += (f" periodic {tuple(int(a) for a in periodic)}"
                   + (" jacobi" if cuda3.odd_wrap(q.shape, periodic)
                      else ""))
    q0, e = q.clone(), 0.0
    for updown, fuse, origin in itertools.product(
            ("down", "up"), (False, True), origins):
        what = (f"K6 sweep3 {pts} {updown} fuse={int(fuse)} "
                f"origin={origin} {tag} ({regime})")
        got = (cuda3.sweep(so, q, b, kind, updown, fuse, origin, periodic)
               if plan is None else
               cuda3._sweep(p, so, q, b, kind, updown, fuse, origin,
                            periodic))
        want = cuda3.sweep_plain(so, q, b, kind, updown, fuse, origin,
                                 periodic)
        if not torch.equal(q, q0):
            raise AssertionError(f"{what}: the sweep changed q")
        if fuse:
            e = max(e, compare(what + " q", got[0], want[0], exact=True),
                    compare(what + " res", got[1], want[1], exact=True))
        else:
            e = max(e, compare(what, got, want, exact=True))
    name = {"resident": "sweep3_resident", "phases": "sweep3"}.get(
        p.route, "sweep3_fused")
    return name + ("_periodic" if any(periodic) else ""), e


def phase_kernels_planes(errs: dict) -> dict:
    """K10 and the batched K2/K3 against their plain versions on batches
    of planes; a batch of one against today's unbatched K2/K3 launch."""
    print("[3] batched plane kernels against plain versions", flush=True)
    errs.setdefault("line_xy2", 0.0)
    for i, (shape, dtype) in enumerate(SHAPES_B):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 500 + i)
            pts = "9pt" if nine else "5pt"
            for updown in ("down", "up"):
                for nsweeps in (1, 2):
                    for res in (False, True):
                        got = cuda_planes2.smooth(so, q.clone(), b, kind,
                                                  updown, nsweeps, res)
                        want = cuda_planes2.smooth_plain(
                            so, q.clone(), b, kind, updown, nsweeps, res)
                        what = (f"K10 line_xy2 {pts} {updown} x{nsweeps} "
                                f"res={int(res)} {tag}")
                        if res:
                            e = max(compare(what + " q", got[0], want[0],
                                            exact=True),
                                    compare(what + " res", got[1], want[1],
                                            exact=True))
                        else:
                            e = compare(what, got, want, exact=True)
                        errs["line_xy2"] = max(errs["line_xy2"], e)
            del so, q, b
    for i, (shape, dtype) in enumerate(SHAPES_BT):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 600 + i)
            pts = "9pt" if nine else "5pt"
            ci = interp2.setup_interp(so, kind)
            g = torch.Generator(device=DEV).manual_seed(700 + i)
            qc = torch.randn((shape[0], ci.shape[2] - 1, ci.shape[3] - 1),
                             generator=g, device=DEV, dtype=dtype)
            e = compare(f"K2 restrict2 batched {pts} {tag}",
                        cuda_transfer2.restrict(ci, b),
                        cuda_transfer2.restrict_plain(ci, b), exact=True)
            errs["restrict2"] = max(errs["restrict2"], e)
            e = compare(f"K3 interp_add2 batched {pts} {tag}",
                        cuda_transfer2.interp_add(ci, so, qc, b, q.clone()),
                        cuda_transfer2.interp_add_plain(ci, so, qc, b,
                                                        q.clone()),
                        exact=True)
            errs["interp_add2"] = max(errs["interp_add2"], e)
            # B = 1 is today's unbatched launch: bit-equal
            ci1, so1 = ci[:, :1].contiguous(), so[:, :1].contiguous()
            b1, q1, qc1 = b[:1].contiguous(), q[:1], qc[:1].contiguous()
            got = cuda_transfer2.restrict(ci1, b1)[0]
            want = cuda_transfer2.restrict(ci1[:, 0].contiguous(), b1[0])
            if not torch.equal(got, want):
                raise AssertionError(f"K2 batch of one {pts} {tag} differs "
                                     "from the unbatched launch")
            got = cuda_transfer2.interp_add(ci1, so1, qc1, b1, q1.clone())[0]
            want = cuda_transfer2.interp_add(
                ci1[:, 0].contiguous(), so1[:, 0].contiguous(), qc1[0],
                b1[0], q1[0].clone())
            if not torch.equal(got, want):
                raise AssertionError(f"K3 batch of one {pts} {tag} differs "
                                     "from the unbatched launch")
            print(f"  K2, K3 batch of one {pts} {tag}: bit-equal to the "
                  "unbatched launch", flush=True)
            del so, q, b, ci, qc
    return errs


def at_odd_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element into its
    buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def phase_transfers2(errs: dict) -> dict:
    """K2 and K3 bit-equal to their plain versions at every batch of the
    plane-xy cycle and at TRANSFER_SHAPES, float32 and float64, 5- and
    9-point; and with q, res and the stencil at odd element offsets (rows
    whose pairs start at odd addresses)."""
    print("[3] K2, K3 at the plane-xy batches, odd sizes and the gates' "
          "levels", flush=True)
    shapes = [*plane_transfer_shapes(N_PLANES), *TRANSFER_SHAPES]
    for i, (shape, dtype) in enumerate(
            itertools.product(shapes, (torch.float32, torch.float64))):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 1500 + i)
            pts = "9pt" if nine else "5pt"
            if shape[0] == 1:  # unbatched
                so, q, b = so[:, 0], q[0], b[0]
            ci = interp2.setup_interp(so, kind)
            g = torch.Generator(device=DEV).manual_seed(1700 + i)
            qc = torch.randn(b.shape[:-2] + (ci.shape[-2] - 1,
                                             ci.shape[-1] - 1),
                             generator=g, device=DEV, dtype=dtype)
            e = compare(f"K2 restrict2 {pts} {tag}",
                        cuda_transfer2.restrict(ci, b),
                        cuda_transfer2.restrict_plain(ci, b), exact=True)
            errs["restrict2"] = max(errs["restrict2"], e)
            e = compare(f"K3 interp_add2 {pts} {tag}",
                        cuda_transfer2.interp_add(ci, so, qc, b, q.clone()),
                        cuda_transfer2.interp_add_plain(ci, so, qc, b,
                                                        q.clone()),
                        exact=True)
            errs["interp_add2"] = max(errs["interp_add2"], e)
            if shape in ((5, 33, 17), (2, 66, 130)):
                # res, then q and the stencil, one element into their
                # buffers: every row's pairs at the other parity
                tag += " odd offsets"
                e = compare(f"K2 restrict2 {pts} {tag}",
                            cuda_transfer2.restrict(ci, at_odd_offset(b)),
                            cuda_transfer2.restrict_plain(ci, b), exact=True)
                errs["restrict2"] = max(errs["restrict2"], e)
                e = compare(f"K3 interp_add2 {pts} {tag}",
                            cuda_transfer2.interp_add(
                                ci, at_odd_offset(so), qc, b,
                                at_odd_offset(q)),
                            cuda_transfer2.interp_add_plain(
                                ci, so, qc, b, q.clone()), exact=True)
                errs["interp_add2"] = max(errs["interp_add2"], e)
            del so, q, b, ci, qc
    return errs


# the periodic axes of a 2D grid: x, y and both
PERIODIC = ((True, False), (False, True), (True, True))
# K1's periodic mode: both regimes at full width (streamed 4096² and the
# odd 2049²) and at the levels of the periodic paths (4096² .. 8², the
# 400² gate's 25², 13², 7²: odd extents, where the wrap couples points of
# one colour), the resident regime's edges (90², 64²), an odd and an even
# extent (65x64) and a few points, float32 and float64 (the full widths
# float32 only); the small ones also forced onto the streamed tile kernel
PERIODIC_SWEEP = ([((4096, 4096), torch.float32),
                   ((2049, 2049), torch.float32)]
                  + [(s, dt) for s in ((256, 256), (64, 64), (90, 90),
                                       (65, 64), (25, 25), (13, 13), (7, 7),
                                       (8, 8), (5, 4), (2, 3))
                     for dt in (torch.float32, torch.float64)])
# K2, K3 and K5's periodic mode: the 4096² -> 2048² transfer, the 400²
# gate's (400² float64 and its odd levels 25², 13², 7²) and odd/even pairs
PERIODIC_TRANSFER = [((4096, 4096), torch.float32),
                     ((400, 400), torch.float64),
                     ((50, 50), torch.float32), ((25, 25), torch.float64),
                     ((13, 13), torch.float32), ((7, 7), torch.float64),
                     ((65, 64), torch.float32), ((8, 8), torch.float64)]
# K4's periodic mode: the 2048² line-x path, lines of 63 (LDLᵀ), 64 and 65
# points, 1000 points, lines too long for shared memory (9000 float32,
# 5000 float64: the device-memory scratch), and line counts odd and even
PERIODIC_LINES = [((2048, 2048), torch.float32), ((63, 64), torch.float32),
                  ((64, 64), torch.float64), ((65, 66), torch.float64),
                  ((1000, 778), torch.float32), ((9000, 6), torch.float32),
                  ((6, 5000), torch.float64), ((24, 9), torch.float64)]


def random_periodic_problem(shape, nine: bool, dtype, seed: int, periodic):
    """:func:`random_problem` with the couplings across the periodic axes
    (the planes' row or column 0, which the wrap reads) made too, and the
    diagonal dominant over the wrapped couplings."""
    so, q, b, kind = random_problem(shape, nine, dtype, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 7)

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(s, generator=g, device=DEV,
                                           dtype=dtype)

    nx, ny = shape
    if periodic[0]:
        so[1, 0, :] = u(0.5, 1.5, ny)
        if nine:
            so[3, 0, :] = u(0.1, 0.5, ny)
            so[4, 0, :] = u(0.1, 0.5, ny)
    if periodic[1]:
        so[2, :, 0] = u(0.5, 1.5, nx)
        if nine:
            so[3, :, 0] = u(0.1, 0.5, nx)
            so[4, :, 0] = u(0.1, 0.5, nx)
    so[0] = offdiag_apply(so, torch.ones(shape, dtype=dtype, device=DEV),
                          kind, periodic) + u(0.05, 0.2, nx, ny)
    return so, q, b, kind


def phase_kernels_periodic(errs: dict) -> dict:
    """The periodic modes, bit-equal to their plain versions, on x-, y-
    and doubly periodic grids, 5- and 9-point: K1 at PERIODIC_SWEEP (DOWN
    and UP, with and without the residual and an origin, q left as it was,
    in the regime of its plan, and the small shapes on the streamed tile
    kernel too), K2, K3 and K5 at PERIODIC_TRANSFER (CI from the periodic
    setup), K4 at PERIODIC_LINES (x and y)."""
    print("[3] periodic modes against plain versions", flush=True)

    def note(k: str, e: float) -> None:
        errs[k + "_periodic"] = max(errs[k + "_periodic"], e)

    streamed = cuda2.Plan(0)
    for i, ((shape, dtype), per) in enumerate(
            itertools.product(PERIODIC_SWEEP, PERIODIC)):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_periodic_problem(shape, nine, dtype,
                                                     2100 + i, per)
            pts = "9pt" if nine else "5pt"
            k, e = compare_sweep(so, q, b, kind, pts, tag, per)
            note(k, e)
            if shape[0] < 1000 and k == "sweep2_resident":
                k, e = compare_sweep(so, q, b, kind, pts, tag, per, streamed)
                note(k, e)
    for i, ((shape, dtype), per) in enumerate(
            itertools.product(PERIODIC_TRANSFER, PERIODIC)):
        tag = (f"{shape} {str(dtype).replace('torch.', '')} periodic "
               f"{tuple(int(a) for a in per)}")
        for nine in (False, True):
            so, q, b, kind = random_periodic_problem(shape, nine, dtype,
                                                     2300 + i, per)
            pts = "9pt" if nine else "5pt"
            ci = interp2.setup_interp(so, kind, per)
            nc = (ci.shape[1] - 1, ci.shape[2] - 1)
            g = torch.Generator(device=DEV).manual_seed(2500 + i)
            qc = torch.randn(nc, generator=g, device=DEV, dtype=dtype)
            e = compare(f"K2 restrict2 {pts} {tag}",
                        cuda_transfer2.restrict(ci, b, per),
                        cuda_transfer2.restrict_plain(ci, b, per),
                        exact=True)
            note("restrict2", e)
            e = compare(f"K3 interp_add2 {pts} {tag}",
                        cuda_transfer2.interp_add(ci, so, qc, b, q.clone(),
                                                  per),
                        cuda_transfer2.interp_add_plain(ci, so, qc, b,
                                                        q.clone(), per),
                        exact=True)
            note("interp_add2", e)
            e = compare(f"K5 interp2 {pts} {tag}",
                        cuda_transfer2.interp(ci, qc, shape, per),
                        cuda_transfer2.interp_plain(ci, qc, shape, per),
                        exact=True)
            note("interp2", e)
            del so, q, b, ci, qc
    for i, ((shape, dtype), per) in enumerate(
            itertools.product(PERIODIC_LINES, PERIODIC)):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_periodic_problem(shape, nine, dtype,
                                                     2700 + i, per)
            pts = "9pt" if nine else "5pt"
            note("line2", compare_lines(so, q, b, kind, pts, tag, per))
            del so, q, b
    torch.cuda.empty_cache()
    return errs


# the 3D periodic axes checked: x, y, z, and all three
PERIODIC3 = [(True, False, False), (False, True, False),
             (False, False, True), (True, True, True)]
# K6's periodic mode, as (shape, dtype, 27-point or not): the full-width
# periodic paths' top levels (256³ 7-point, 128³ 27-point: per colour), an
# odd extent on x alone (65, 64, 64) and on every axis (65, 63, 33), the
# 22x16x16 -> 11x8x8 levels (odd at the second), the resident regime's
# edges (16³ float32, 12³ float64) and odd extents there (11x8x8, 11x9x7
# float64: its Jacobi phases), and a few points
PERIODIC3_SWEEP = [((256,) * 3, torch.float32, (False,)),
                   ((128,) * 3, torch.float32, (True,)),
                   ((65, 64, 64), torch.float32, (False, True)),
                   ((65, 63, 33), torch.float32, (False, True)),
                   ((22, 16, 16), torch.float32, (False, True)),
                   ((16,) * 3, torch.float32, (True,)),
                   ((12,) * 3, torch.float64, (True,)),
                   ((11, 8, 8), torch.float64, (False, True)),
                   ((11, 9, 7), torch.float64, (False, True)),
                   ((5, 4, 3), torch.float64, (False, True))]
# K7, K8 and K9's periodic mode: the 256³ 7-point and 128³ 27-point
# transfers, odd and even extents, a few points
PERIODIC3_TRANSFER = [((256,) * 3, torch.float32, (False,)),
                      ((128,) * 3, torch.float32, (True,)),
                      ((65, 63, 33), torch.float32, (False, True)),
                      ((22, 16, 16), torch.float32, (False, True)),
                      ((11, 9, 7), torch.float64, (False, True)),
                      ((12,) * 3, torch.float64, (True,)),
                      ((5, 4, 3), torch.float64, (False, True))]


def random_periodic_problem3(shape, ts: bool, dtype, seed: int, periodic):
    """:func:`random_problem3` on a grid periodic along ``periodic``: the
    couplings across those axes (index 0 of the planes that reach across,
    which the wrap reads) copied from index 1 (``gallery.periodic3``), and
    the diagonal dominant over the wrapped couplings."""
    so, q, b, kind = random_problem3(shape, ts, dtype, seed)
    so = gallery.periodic3(so, periodic)
    g = torch.Generator(device=DEV).manual_seed(seed + 7)
    so[Dir3.P] = stencil3.offdiag_apply(
        so, torch.ones(shape, dtype=dtype, device=DEV), kind, periodic) + (
            0.05 + 0.15 * torch.rand(shape, generator=g, device=DEV,
                                     dtype=dtype))
    return so, q, b, kind


def phase_kernels_periodic3(errs: dict) -> dict:
    """K6-K9's periodic modes, bit-equal to their plain versions, on x-,
    y-, z- and triply periodic grids, 7- and 27-point: K6 at
    PERIODIC3_SWEEP (DOWN and UP, with and without the residual and an
    origin, q left as it was) in the regime of its plan (resident or a
    launch a colour phase; Jacobi phases at odd periodic extents) and the
    resident levels on the per-colour launches too; K7, K8 and K9 at
    PERIODIC3_TRANSFER (CI from the periodic setup)."""
    print("[3] 3D periodic modes against plain versions", flush=True)

    def note(k: str, e: float) -> None:
        errs[k] = max(errs.get(k, 0.0), e)

    phases = cuda3.Plan("phases")
    for i, ((shape, dtype, kinds), per) in enumerate(
            itertools.product(PERIODIC3_SWEEP, PERIODIC3)):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for ts in kinds:
            so, q, b, kind = random_periodic_problem3(shape, ts, dtype,
                                                      3100 + i, per)
            k, e = compare_sweep3(so, q, b, kind, tag, per)
            note(k, e)
            if k == "sweep3_resident_periodic":
                note(*compare_sweep3(so, q, b, kind, tag, per, phases))
            del so, q, b
    for i, ((shape, dtype, kinds), per) in enumerate(
            itertools.product(PERIODIC3_TRANSFER, PERIODIC3)):
        tag = (f"{shape} {str(dtype).replace('torch.', '')} periodic "
               f"{tuple(int(a) for a in per)}")
        for ts in kinds:
            so, q, b, kind = random_periodic_problem3(shape, ts, dtype,
                                                      3300 + i, per)
            pts = "27pt" if ts else "7pt"
            ci = interp3.setup_interp(so, kind, per)
            nc = tuple(n - 1 for n in ci.shape[1:])
            g = torch.Generator(device=DEV).manual_seed(3500 + i)
            qc = torch.randn(nc, generator=g, device=DEV, dtype=dtype)
            note("restrict3_periodic", compare(
                f"K7 restrict3 {pts} {tag}",
                cuda_transfer3.restrict(ci, b, per),
                cuda_transfer3.restrict_plain(ci, b, per), exact=True))
            note("interp_add3_periodic", compare(
                f"K8 interp_add3 {pts} {tag}",
                cuda_transfer3.interp_add(ci, so, qc, b, q.clone(), per),
                cuda_transfer3.interp_add_plain(ci, so, qc, b, q.clone(),
                                                per), exact=True))
            note("interp3_periodic", compare(
                f"K9 interp3 {pts} {tag}",
                cuda_transfer3.interp(ci, qc, shape, per),
                cuda_transfer3.interp_plain(ci, qc, shape, per),
                exact=True))
            del so, q, b, ci, qc
    torch.cuda.empty_cache()
    return errs


FUSED = ("sweep2_fused", "sweep_restrict2", "interp_sweep2")


def compare_fused(what: str, got, want, mode: str) -> float:
    """A fused kernel's outputs against its plain version's: q and the
    residual bit-equal, the norm's partial sums to rtol NORM_RTOL."""
    if mode == "none":
        return compare(what, got, want, exact=True)
    err = compare(what + " q", got[0], want[0], exact=True)
    if mode == "res":
        return max(err, compare(what + " res", got[1], want[1], exact=True))
    norm, ref = float(got[1].sum()), float(want[1].sum())
    rel = abs(norm - ref) / ref
    print(f"  {what} norm: {norm:.9e} over {got[1].numel()} partials, "
          f"plain {ref:.9e}, rel err {rel:.3e}", flush=True)
    if not rel <= NORM_RTOL[want[0].dtype]:
        raise AssertionError(f"{what}: norm disagrees with plain version")
    return err


def check_fused2_plans() -> None:
    """The wrapper's plan (ops/cuda_fused2.py) sizes K12's and K13's shared
    memory as the kernels lay it out, for every variant that is built, and
    takes the kernels' threads a block and steps ahead; K1's (ops/cuda2.py)
    takes its resident block's threads."""
    lib = cuda_build.load("fused2")
    build = (lib.cedar_fused2_threads(), lib.cedar_fused2_ahead())
    if build != (cuda_fused2.THREADS, cuda_fused2.AHEAD):
        raise AssertionError(f"K12/K13 built with (threads, ahead) {build}")
    for itemsize, nine, mode in itertools.product((4, 8), (False, True),
                                                  (0, 1, 2, 3)):
        want = cuda_fused2.ring_words(nine, mode) * itemsize
        dt = 0 if itemsize == 4 else 1
        got = lib.cedar_fused2_smem(dt, int(nine), mode, 0)
        if got != want:
            raise AssertionError(f"K12/K13 smem {itemsize} nine={nine} "
                                 f"mode={mode}: kernel {got}, plan {want}")
        # the plan's blocks an SM must all be resident at once, or a grid
        # planned as one wave runs in two
        per_sm = cuda_fused2.plan(itemsize, nine, mode,
                                  (N_MAIN, N_MAIN)).per_sm
        fits = lib.cedar_fused2_smem(dt, int(nine), mode, 1)
        if fits < per_sm:
            raise AssertionError(f"K12/K13 {itemsize} nine={nine} mode={mode}"
                                 f": an SM holds {fits} blocks, the plan "
                                 f"counts on {per_sm}")
    threads = cuda_build.load("sweep2").cedar_sweep2_threads()
    if threads != cuda2.THREADS:
        raise AssertionError(f"K1 built with {threads} threads a block")
    print("  K1, K12 and K13 plans match the kernels' layouts", flush=True)


def phase_kernels_fused(errs: dict) -> dict:
    """K11-K13 against their plain versions at the 2D shapes and (5, 4)
    float64: every output mode, DOWN and UP, K11 with and without an
    origin, K12 with and without the residual; K12 and K13 also at their
    strips' and chunks' edge shapes (EDGE2), K12 at the main path's fused
    levels 1024² and 512² 9-point too."""
    print("[3] fused kernels against plain versions", flush=True)
    errs.update(dict.fromkeys(FUSED, 0.0))
    check_fused2_plans()
    shapes = SHAPES + [((5, 4), torch.float64)]
    for i, (shape, dtype) in enumerate(shapes + EDGE2):
        edge = i >= len(shapes)
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 800 + i)
            pts = "9pt" if nine else "5pt"
            ci = interp2.setup_interp(so, kind)
            g = torch.Generator(device=DEV).manual_seed(900 + i)
            qc = torch.randn((ci.shape[1] - 1, ci.shape[2] - 1),
                             generator=g, device=DEV, dtype=dtype)
            for updown in ("down", "up"):
                for mode in ("none", "res", "norm"):
                    fr, fn = mode == "res", mode == "norm"
                    for origin in () if edge else ((0, 0), (1, 2)):
                        e = compare_fused(
                            f"K11 sweep2_fused {pts} {updown} {mode} "
                            f"origin={origin} {tag}",
                            cuda_fused2.sweep(so, q, b, kind, updown, fr,
                                              origin, fn),
                            cuda_fused2.sweep_plain(so, q, b, kind, updown,
                                                    fr, origin, fn), mode)
                        errs["sweep2_fused"] = max(errs["sweep2_fused"], e)
                    e = compare_fused(
                        f"K13 interp_sweep2 {pts} {updown} {mode} {tag}",
                        cuda_fused2.interp_sweep(ci, qc, so, b, q, kind,
                                                 updown, fr, fn),
                        cuda_fused2.interp_sweep_plain(ci, qc, so, b, q,
                                                       kind, updown, fr, fn),
                        mode)
                    errs["interp_sweep2"] = max(errs["interp_sweep2"], e)
                errs["sweep_restrict2"] = max(
                    errs["sweep_restrict2"],
                    compare_k12(so, q, b, ci, kind, updown, pts, tag))
            del so, q, b, ci, qc
    # K12 at the main path's 9-point fused levels below 2048²
    for i, n in enumerate((1024, 512)):
        so, q, b, kind = random_problem((n, n), True, torch.float32, 870 + i)
        ci = interp2.setup_interp(so, kind)
        for updown in ("down", "up"):
            errs["sweep_restrict2"] = max(
                errs["sweep_restrict2"],
                compare_k12(so, q, b, ci, kind, updown, "9pt",
                            f"({n}, {n}) float32"))
        del so, q, b, ci
    return errs


def compare_k12(so, q, b, ci, kind, updown: str, pts: str, tag: str) -> float:
    """K12 with and without the residual, q, res and cb bit-equal to its
    plain version."""
    e = 0.0
    for emit in (False, True):
        what = f"K12 sweep_restrict2 {pts} {updown} res={int(emit)} {tag}"
        got = cuda_fused2.sweep_restrict(so, q, b, ci, kind, updown, emit)
        want = cuda_fused2.sweep_restrict_plain(so, q, b, ci, kind, updown,
                                                emit)
        e = max(e, compare(what + " q", got[0], want[0], exact=True),
                compare(what + " cb", got[2], want[2], exact=True))
        if emit:
            e = max(e, compare(what + " res", got[1], want[1], exact=True))
        elif got[1] is not None:
            raise AssertionError(f"{what}: residual returned")
    return e


FUSED3 = ("sweep3_fused", "sweep_restrict3", "interp_sweep3")


def check_fused3_plans() -> None:
    """The wrappers' plans (ops/cuda_fused3.py) size the shared memory of
    the 7-point K14-K16, the 27-point K14 and the edge kernel as the
    kernels lay it out, for every variant that is built and fits a block,
    and take the builds' constants (the 7-point K14's tile rows and the
    blocks an SM of its registers' cap, the 27-point K14's colours a march,
    the edge kernel's threads and tile columns)."""
    lib = cuda_build.load("fused3")
    rows14, blocks14 = cuda_fused3._ring14_of(lib)
    if blocks14 != cuda_fused3.RING14_BLOCKS:
        raise AssertionError(f"7-point K14 registers capped for {blocks14} "
                             "blocks an SM")
    if rows14 != cuda_fused3.RING14_ROWS:
        raise AssertionError(f"7-point K14 built with tile rows {rows14}")
    for itemsize in (4, 8):
        dt = 0 if itemsize == 4 else 1
        for interp, mode in [(False, 3), (True, 0), (True, 1), (True, 2),
                             (False, 0), (False, 1), (False, 2)]:
            k14 = cuda_fused3.is_k14(interp, mode)
            rows = ((cuda_fused3.RING14_ROWS[itemsize],) if k14 else
                    cuda_fused3.RING_ROWS[itemsize])
            for ty in rows:
                words = cuda_fused3.ring_words(itemsize, interp, mode, ty)
                if words * itemsize > cuda_build.BLOCK_SMEM:
                    continue  # built, never planned: it does not fit
                want = cuda_fused3.plan(itemsize, interp, mode,
                                        (64, 64, 64), ty=ty).smem
                got = lib.cedar_fused3_smem(dt, int(interp), mode, ty)
                if got != want:
                    raise AssertionError(
                        f"K14-K16 smem {itemsize} interp={interp} "
                        f"mode={mode} ty={ty}: kernel {got}, plan {want}")
    # the 27-point K14: every tile-row count the plan may take
    n = lib.cedar_fused3_pass27_stages()
    if n != cuda_fused3.PASS27_STAGES:
        raise AssertionError(f"27-point K14 built with {n} colours a march")
    for itemsize in (4, 8):
        for ty in range(2, 2 * 16 + 1, 2):
            want = cuda_fused3.pass27_words(itemsize, ty) * itemsize
            got = lib.cedar_fused3_pass27_smem(0 if itemsize == 4 else 1, ty)
            if ty + 2 * n > 2 * cuda_fused3.pass27_warps(n):
                want = -1
            if got != want:
                raise AssertionError(f"K14 27-pt smem {itemsize} ty={ty}: "
                                     f"kernel {got}, plan {want}")
    # the edge kernel: its build, every even tile-row count up to the most
    # a block holds, and the plans of the 3D paths' 27-point levels
    edge = cuda_build.load("edge3")
    build = cuda_fused3._edge_of(edge)
    if build != cuda_fused3.EDGE_BUILD:
        raise AssertionError(f"edge kernel built as {build}")
    for itemsize, mode in itertools.product(
            (4, 8), cuda_fused3.EDGE_MODES.values()):
        dt = 0 if itemsize == 4 else 1
        tz = build[1] if itemsize == 4 else build[2]
        for ty in range(2, 34, 2):
            want = cuda_fused3.edge_words(itemsize, mode, ty, tz) * itemsize
            got = edge.cedar_edge3_smem(dt, mode, ty)
            if got != want:
                raise AssertionError(f"edge smem {itemsize} mode={mode} "
                                     f"ty={ty}: kernel {got}, plan {want}")
        for n in (128, 64, 32, 16, 8, 25, 13):
            p = cuda_fused3.edge_plan(itemsize, mode, (n,) * 3,
                                      build=build)
            if edge.cedar_edge3_smem(dt, mode, p.ty) != p.smem:
                raise AssertionError(f"edge plan {itemsize} mode={mode} "
                                     f"{n}^3: smem {p.smem}")
    print("  K14-K16 and edge plans size shared memory as the kernels do",
          flush=True)


# the 27-point levels of the 3D paths (float32 64³ .. 8³ below the 128³ of
# SHAPES3) and the 200³ float64 gate's odd levels, where the fused
# kernels are held too (27-point only)
LEVELS27 = [((64,) * 3, torch.float32), ((32,) * 3, torch.float32),
            ((16,) * 3, torch.float32), ((8,) * 3, torch.float32),
            ((25,) * 3, torch.float64), ((13,) * 3, torch.float64),
            ((7,) * 3, torch.float64)]


def phase_kernels_fused3(errs: dict) -> dict:
    """K14-K16 and the edge kernel against their plain versions at the 3D
    shapes and (5, 4, 3) float64, both kinds: every output mode, DOWN and
    UP, K14 with and without an origin, K15 with and without the residual;
    also at the tilings' edge shapes (EDGE3; float32, and the 27-point
    ones in float64 too) with an odd origin, and at the 3D paths' 27-point
    levels and the 200³ gate's odd ones (LEVELS27).  A 27-point K14, K15
    or K16 sweeps on K6's route with the edge kernel beside it
    (``cuda_fused3.launch_list``); the edge kernel is also held alone, in
    each mode, against stencil3.residual, interp3.restrict_torch and
    interp3.interp_add_torch."""
    print("[3] fused 3D kernels against plain versions", flush=True)
    for k in FUSED3 + ("edge27",):
        errs.setdefault(k, 0.0)
    check_fused3_plans()
    shapes = SHAPES3 + [((5, 4, 3), torch.float64, (False, True))]
    shapes += [(shape, torch.float32, kinds) for shape, kinds in EDGE3]
    shapes += [(shape, torch.float64, (True,)) for shape, kinds in EDGE3
               if True in kinds]
    shapes += [(shape, dtype, (True,)) for shape, dtype in LEVELS27]
    for i, (shape, dtype, kinds) in enumerate(shapes):
        edge = i >= len(SHAPES3) + 1
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for ts in kinds:
            so, q, b, kind = random_problem3(shape, ts, dtype, 1000 + i)
            pts = "27pt" if ts else "7pt"
            ci = interp3.setup_interp(so, kind)
            g = torch.Generator(device=DEV).manual_seed(1100 + i)
            qc = torch.randn(tuple(n - 1 for n in ci.shape[1:]),
                             generator=g, device=DEV, dtype=dtype)
            for updown in ("down", "up"):
                for mode in ("none", "res", "norm"):
                    fr, fn = mode == "res", mode == "norm"
                    origins = ((0, 0, 0), (1, 2, 3))
                    if edge:
                        origins = ((1, 0, 1),)
                    for origin in origins:
                        e = compare_fused(
                            f"K14 sweep3_fused {pts} {updown} {mode} "
                            f"origin={origin} {tag}",
                            cuda_fused3.sweep(so, q, b, kind, updown, fr,
                                              origin, fn),
                            cuda_fused3.sweep_plain(so, q, b, kind, updown,
                                                    fr, origin, fn), mode)
                        errs["sweep3_fused"] = max(errs["sweep3_fused"], e)
                    e = compare_fused(
                        f"K16 interp_sweep3 {pts} {updown} {mode} {tag}",
                        cuda_fused3.interp_sweep(ci, qc, so, b, q, kind,
                                                 updown, fr, fn),
                        cuda_fused3.interp_sweep_plain(ci, qc, so, b, q,
                                                       kind, updown, fr, fn),
                        mode)
                    errs["interp_sweep3"] = max(errs["interp_sweep3"], e)
                for emit in (False, True):
                    what = (f"K15 sweep_restrict3 {pts} {updown} "
                            f"res={int(emit)} {tag}")
                    got = cuda_fused3.sweep_restrict(so, q, b, ci, kind,
                                                     updown, emit)
                    want = cuda_fused3.sweep_restrict_plain(
                        so, q, b, ci, kind, updown, emit)
                    e = max(compare(what + " q", got[0], want[0], exact=True),
                            compare(what + " cb", got[2], want[2],
                                    exact=True))
                    if emit:
                        e = max(e, compare(what + " res", got[1], want[1],
                                           exact=True))
                    elif got[1] is not None:
                        raise AssertionError(f"{what}: residual returned")
                    errs["sweep_restrict3"] = max(errs["sweep_restrict3"], e)
                    del got, want
            if ts:
                errs["edge27"] = max(errs["edge27"],
                                     compare_edge(so, q, b, ci, qc, tag))
            del so, q, b, ci, qc
    return errs


def compare_edge(so, q, b, ci, qc, tag: str) -> float:
    """The edge kernel alone in each mode against the plain ops it stands
    for (stencil3.residual, interp3.restrict_torch,
    interp3.interp_add_torch): bit-equal, the norm's partials summing to
    the sum of res² within NORM_RTOL, q left as it was."""
    kind = StencilKind.twenty_seven_pt
    q0 = q.clone()
    r = stencil3.residual(so, q, b, kind)
    e = compare(f"edge27 res {tag}", cuda_fused3.edge(so, q, b, "res"), r,
                exact=True)
    for emit in (False, True):
        what = f"edge27 restrict res={int(emit)} {tag}"
        got_r, got_cb = cuda_fused3.edge(so, q, b, "restrict", ci,
                                         emit_res=emit)
        e = max(e, compare(what + " cb", got_cb,
                           interp3.restrict_torch(ci, r), exact=True))
        if emit:
            e = max(e, compare(what + " res", got_r, r, exact=True))
        elif got_r is not None:
            raise AssertionError(f"{what}: residual returned")
    e = max(e, compare(f"edge27 interp {tag}",
                       cuda_fused3.edge(so, q, b, "interp", ci, qc),
                       interp3.interp_add_torch(ci, so, qc, r, q),
                       exact=True))
    n, want = (float(cuda_fused3.edge(so, q, b, "norm").sum()),
               float((r * r).sum()))
    if not abs(n - want) <= NORM_RTOL[q.dtype] * want:
        raise AssertionError(f"edge27 norm {tag}: {n} against {want}")
    if not torch.equal(q, q0):
        raise AssertionError(f"edge27 {tag}: q changed")
    return e


def phase_cedar_gate() -> None:
    print("[4] Cedar 400^2 float64 history through the kernels", flush=True)
    reset_counts()
    conf = Config({"log": [], "solver": {
        "num-levels": 7, "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-10, "max-iter": 10}})
    so = gallery.poisson(400, 400, torch.float64, DEV)
    b = gallery.poisson_rhs(400, 400, torch.float64, DEV)
    s = Solver2(so, FivePt, conf)
    x = s.solve(b)
    err = float((x - gallery.poisson_solution(400, 400, torch.float64,
                                              DEV)).abs().max())
    c = counts()
    print(f"  history: {' '.join(f'{h:g}' for h in s.history)}", flush=True)
    print(f"  solution error: {err:g}; counts: {c}", flush=True)
    np.testing.assert_allclose(s.history, CEDAR_HISTORY, rtol=2e-5)
    np.testing.assert_allclose(err, CEDAR_ERROR, rtol=1e-4)
    # the card's default: the fused cycle on levels 0-3, dense on 4 and 5
    if not cycle2.fine_split_ok(s.levels, s.settings):
        raise AssertionError("Cedar gate: the fused cycle is not the default")
    require_launched(c, (K1, "restrict2", "interp_add2",
                         "sweep_restrict2", "interp_sweep2"), "Cedar gate")
    check_graph(s, b, x, "Cedar gate")


def phase_fused_gate() -> None:
    """A float64 V(2,2) solve through the fused cycle on the card (K11-K13
    on levels 0-3) against the dense cycle on the CPU."""
    print("[4] float64 fused V(2,2) gate, card against CPU", flush=True)
    n, cpu = 400, torch.device("cpu")
    solver = {"cycle": {"nrelax-pre": 2, "nrelax-post": 2}, "tol": 1e-10,
              "max-iter": 10}
    so = gallery.poisson(n, n, torch.float64, cpu)
    b = gallery.poisson_rhs(n, n, torch.float64, cpu)
    s, _, c = gate_solve(DEV, so, FivePt, Config({"log": [],
                                                   "solver": solver}), b)
    sc, _, _ = gate_solve(cpu, so, FivePt, Config({
        "log": [], "solver": solver, "kernels": {"fine-split": False}}), b)
    print(f"  Poisson {n}^2 V(2,2): card (fused) "
          f"{' '.join(f'{h:.9g}' for h in s.history)}", flush=True)
    print(f"  CPU (dense) {' '.join(f'{h:.9g}' for h in sc.history)}; "
          f"counts {c}", flush=True)
    # the absolute floor in relative-residual units as in phase 4b
    np.testing.assert_allclose(s.history, sc.history, rtol=1e-9, atol=1e-14)
    if not s.history[-1] < 1e-9:
        raise AssertionError("fused V(2,2) gate did not converge")
    require_launched(c, ("sweep2_fused", "sweep_restrict2", "interp_sweep2",
                         K1, "restrict2", "interp_add2"),
                     "fused V(2,2) gate")


def gate_solve(dev, so, kind, conf, b):
    """Setup and solve on ``dev``; returns (solver, x, counts).  On the
    card the graph solve is held to the eager one (:func:`check_graph`)
    after the counts are read."""
    reset_counts()
    s = Solver2(so.to(dev), kind, conf)
    x = s.solve(b.to(dev))
    c = counts()
    if x.is_cuda:
        check_graph(s, b.to(dev), x, f"{kind.name} {tuple(so.shape[1:])} "
                    f"{s.settings.relaxation.value} "
                    f"{s.settings.cycle.value}-cycle gate")
    return s, x, c


def phase_f64_gates() -> None:
    """The line-xy and F-cycle paths in float64: on the card through the
    kernels, and on the CPU through the plain versions."""
    print("[4b] float64 line-xy and F-cycle gates, card against CPU",
          flush=True)
    n = 400
    cpu = torch.device("cpu")
    conf = Config({"log": [], "solver": {
        "relaxation": "line-xy", "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-10, "max-iter": 10}})
    so = gallery.fe(n, n, torch.float64, cpu)
    b = gallery.poisson_rhs(n, n, torch.float64, cpu)
    s, x, c = gate_solve(DEV, so, NinePt, conf, b)
    sc, xc, _ = gate_solve(cpu, so, NinePt, conf, b)
    print(f"  fe {n}^2 line-xy V(1,1): card {' '.join(f'{h:.6g}' for h in s.history)}",
          flush=True)
    print(f"  CPU: {' '.join(f'{h:.6g}' for h in sc.history)}; counts {c}",
          flush=True)
    # rtol 1e-9 holds while the residual is well above its rounding floor;
    # near 1e-10 relative, b - A x keeps only a few digits on either
    # device (setup and coarse solve sum in another order on the card),
    # hence the absolute floor of 1e-14 in relative-residual units
    np.testing.assert_allclose(s.history, sc.history, rtol=1e-9, atol=1e-14)
    if not s.history[-1] < 1e-9:
        raise AssertionError("line-xy gate did not converge")
    require_launched(c, ("line2", "restrict2", "interp_add2"), "line-xy gate")

    conf = Config({"log": [], "solver": {
        "cycle": {"type": "f", "nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-10, "max-iter": 3}})
    so = gallery.poisson(n, n, torch.float64, cpu)
    b = gallery.poisson_rhs(n, n, torch.float64, cpu)
    s, x, c = gate_solve(DEV, so, FivePt, conf, b)
    sc, _, _ = gate_solve(cpu, so, FivePt, conf, b)
    err = float((x - gallery.poisson_solution(n, n, torch.float64,
                                              DEV)).abs().max())
    print(f"  Poisson {n}^2 F-cycle: card {' '.join(f'{h:.9g}' for h in s.history)}"
          f"; CPU {' '.join(f'{h:.9g}' for h in sc.history)}", flush=True)
    print(f"  solution error {err:g}; counts {c}", flush=True)
    if len(set(s.history)) != 1:
        raise AssertionError("F-cycle history is not constant")
    np.testing.assert_allclose(s.history, sc.history, rtol=1e-9, atol=1e-14)
    if not err < 1e-3:
        raise AssertionError("F-cycle error above discretisation accuracy")
    require_launched(c, (K1, "restrict2", "interp_add2", "interp2",
                         "sweep_restrict2", "interp_sweep2"), "F-cycle gate")


def phase_cedar3() -> None:
    """Cedar's 3D integration test through the kernels: V(2,1), the
    package defaults but ``kernels.fine-split: true``: fused on levels 0-3
    (K14 for the extra pre-sweep; the 27-point levels' K15 and K16 are
    K6's sweeps and the edge kernel), dense on levels 4 and 5."""
    n = N_CEDAR3
    print(f"[4c] Cedar 3D test: Poisson {n}^3 float64 7-pt through the "
          "kernels", flush=True)
    reset_counts()
    conf = Config({"log": [], "kernels": {"fine-split": True},
                   "solver": {"tol": 1e-9, "max-iter": 30}})
    so = gallery.poisson3(n, n, n, torch.float64, DEV)
    b = gallery.poisson3_rhs(n, n, n, torch.float64, DEV)
    s = Solver3(so, SevenPt, conf)
    x = s.solve(b)
    c = counts()
    rnorm = float(stencil3.residual(so, x, b, SevenPt).norm())
    err = float((x - gallery.poisson3_solution(n, n, n, torch.float64,
                                               DEV)).abs().max())
    print(f"  history: {' '.join(f'{h:.6g}' for h in s.history)}",
          flush=True)
    print(f"  |b - A x|_2 = {rnorm:.4e}, |x - x*|_inf = {err:.6g}; "
          f"counts: {c}", flush=True)
    # test/3d/test_poisson.cc:74-105
    if not (rnorm < 1e-8 and err < 1e-4):
        raise AssertionError("Cedar 3D test failed")
    if not cycle3.fine_split_ok(s.levels, s.settings):
        raise AssertionError("Cedar 3D test: the cycle is not fused")
    require_launched(c, ("sweep3_resident", "restrict3", "interp_add3",
                         "edge27") + FUSED3,
                     "Cedar 3D test")
    check_graph(s, b, x, "Cedar 3D test", cycle3)


def phase_3d_gates() -> None:
    """The float64 3D V-cycle and F-cycle solves on the card against the
    same solves on the CPU (plain versions): the card runs the fused cycle
    (``kernels.fine-split: true``; every level but the coarsest at these
    sizes) and the CPU the dense one."""
    print("[4c] float64 3D gates, card (fused) against CPU (dense)",
          flush=True)
    cpu = torch.device("cpu")
    gates = [
        ("poisson3 33^3 V(2,2)", 33, gallery.poisson3, SevenPt,
         {"tol": 1e-10, "max-iter": 10,
          "cycle": {"nrelax-pre": 2, "nrelax-post": 2}}, FUSED3),
        ("fe3 17^3 V(1,1)", 17, gallery.fe3, TwentySevenPt,
         {"tol": 1e-10, "max-iter": 10,
          "cycle": {"nrelax-pre": 1, "nrelax-post": 1}},
         ("edge27", "sweep3", "sweep3_resident")),
        ("poisson3 33^3 F", 33, gallery.poisson3, SevenPt,
         {"cycle": {"type": "f"}, "tol": 1e-10, "max-iter": 3},
         ("restrict3", "interp3") + FUSED3),
    ]
    for what, n, make, kind, solver, need in gates:
        so = make(n, n, n, torch.float64, cpu)
        b = gallery.poisson3_rhs(n, n, n, torch.float64, cpu)
        reset_counts()
        s = Solver3(so.to(DEV), kind, Config({
            "log": [], "kernels": {"fine-split": True}, "solver": solver}))
        x = s.solve(b.to(DEV))
        c = counts()
        check_graph(s, b.to(DEV), x, what, cycle3)
        sc = Solver3(so, kind, Config({"log": [], "solver": solver}))
        sc.solve(b)
        print(f"  {what}: card {' '.join(f'{h:.9g}' for h in s.history)}",
              flush=True)
        print(f"  {what}: CPU  {' '.join(f'{h:.9g}' for h in sc.history)};"
              f" counts {c}", flush=True)
        if not (s.settings.fine_split and not sc.settings.fine_split):
            raise AssertionError(f"{what}: not fused on the card and dense "
                                 "on the CPU")
        # the absolute floor in relative-residual units as in phase 4b
        np.testing.assert_allclose(s.history, sc.history, rtol=1e-9,
                                   atol=1e-14)
        require_launched(c, need, what)


def aniso3(nx, ny, nz, dtype=None, device=None):
    """``3d_aniso_planexy_128``'s operator: ``diag_diffusion3(1, 1, 1e-3)``
    (bench.py:173-184), strong coupling in the xy planes."""
    return gallery.diag_diffusion3(nx, ny, nz, 1.0, 1.0, 1e-3, dtype, device)


# a plane-relaxation solve launches K10 and the batched K2/K3 in its
# embedded cycles and K7/K8 on the outer 3D levels
PLANE_KERNELS = ("line_xy2", "restrict2", "interp_add2", "restrict3",
                 "interp_add3")


def phase_plane_gates() -> None:
    """The float64 plane-relaxation solves on the card against the same
    solves on the CPU (plain versions)."""
    print("[4d] float64 plane-relaxation gates, card against CPU",
          flush=True)
    cpu = torch.device("cpu")
    gates = [
        ("diag_diffusion3 16^3 plane-xy", (16, 16, 16), aniso3, SevenPt,
         "plane-xy"),
        ("poisson3 8^3 plane-xyz", (8, 8, 8), gallery.poisson3, SevenPt,
         "plane-xyz"),
        ("fe3 12x10x9 plane-yz", (12, 10, 9), gallery.fe3, TwentySevenPt,
         "plane-yz"),
    ]
    for what, shape, make, kind, relax in gates:
        conf = Config({"log": [], "solver": {
            "relaxation": relax, "tol": 1e-9, "max-iter": 20}})
        so = make(*shape, torch.float64, cpu)
        b = gallery.poisson3_rhs(*shape, torch.float64, cpu)
        reset_counts()
        s = Solver3(so.to(DEV), kind, conf)
        x = s.solve(b.to(DEV))
        c = counts()
        check_graph(s, b.to(DEV), x, what, cycle3)
        sc = Solver3(so, kind, conf)
        sc.solve(b)
        print(f"  {what}: card {' '.join(f'{h:.9g}' for h in s.history)}",
              flush=True)
        print(f"  {what}: CPU  {' '.join(f'{h:.9g}' for h in sc.history)};"
              f" counts {c}", flush=True)
        np.testing.assert_allclose(s.history, sc.history, rtol=1e-9,
                                   atol=1e-14)
        if not s.history[-1] < 1e-9:
            raise AssertionError(f"{what}: did not converge to 1e-9")
        # near-direct on plane-aligned anisotropy (tests/test_planes_3d.py)
        if make is aniso3 and len(s.history) > 5:
            raise AssertionError(f"{what}: {len(s.history)} cycles > 5")
        require_launched(c, PLANE_KERNELS, what)


def periodic_grid(make, per):
    """``make``'s operator (a 2D gallery function) on a grid periodic along
    ``per``: the couplings across those axes (the planes' row or column 0,
    which the wrap reads) copied from row or column 1."""
    def periodic(nx, ny, dtype=None, device=None):
        so = make(nx, ny, dtype, device)
        nine = so.shape[0] == 5
        if per[0]:
            planes = [1, 3, 4] if nine else [1]
            so[planes, 0, :] = so[planes, 1, :]
        if per[1]:
            planes = [2, 3, 4] if nine else [2]
            so[planes, :, 0] = so[planes, :, 1]
        return so
    return periodic


def aniso_x(nx, ny, dtype=None, device=None):
    """Strong coupling along x: the line-x cells' operator."""
    return gallery.diag_diffusion(nx, ny, 1.0, 0.1, dtype, device)


def aniso_y(nx, ny, dtype=None, device=None):
    return gallery.diag_diffusion(nx, ny, 0.1, 1.0, dtype, device)


def periodic_conf(per, **solver) -> dict:
    return {"grid": {"periodic": list(per)}, "solver": solver}


X, Y, XY = (True, False), (False, True), (True, True)
# the 2D periodic configurations: name -> (operator, kind, conf); the
# doubly periodic one is singular (solver.definite false, b with its mean
# removed)
PERIODIC_CONFIGS = {
    "point x": (periodic_grid(gallery.poisson, X), FivePt, periodic_conf(X)),
    "line-x": (periodic_grid(aniso_x, X), FivePt,
               periodic_conf(X, relaxation="line-x")),
    "line-y": (periodic_grid(aniso_y, Y), FivePt,
               periodic_conf(Y, relaxation="line-y")),
    "line-xy": (periodic_grid(gallery.fe, X), NinePt,
                periodic_conf(X, relaxation="line-xy")),
    "9pt x": (periodic_grid(gallery.fe, X), NinePt, periodic_conf(X)),
    "F x": (periodic_grid(gallery.poisson, X), FivePt,
            periodic_conf(X, cycle={"type": "f"})),
    "indefinite xy": (periodic_grid(gallery.poisson, XY), FivePt,
                      periodic_conf(XY, definite=False)),
}


def periodic_rhs(conf: dict, nx: int, ny: int, dtype, device):
    """poisson_rhs, its mean removed where the operator is singular."""
    b = gallery.poisson_rhs(nx, ny, dtype, device)
    if not conf["solver"].get("definite", True):
        b = b - b.mean()
    return b


def phase_periodic_gates() -> dict:
    """Float64 periodic gates at 256², card against CPU (rtol 1e-9, atol
    1e-14, as the other gates): :data:`PERIODIC_CONFIGS` (point V(1,1)
    x-periodic, line-x, line-y, line-xy, 9-point, the F-cycle, the doubly
    periodic indefinite solve to 1e-10).  Returns the F-cycle's counts."""
    print("[4f] float64 periodic gates, card against CPU", flush=True)
    n, cpu = N_PERIODIC_GATE, torch.device("cpu")
    out = {}
    for name, (make, kind, conf) in PERIODIC_CONFIGS.items():
        conf = {**conf, "log": [], "solver": {
            "cycle": {"nrelax-pre": 1, "nrelax-post": 1}, "tol": 1e-10,
            "max-iter": 20, **conf["solver"]}}
        so = make(n, n, torch.float64, cpu)
        b = periodic_rhs(conf, n, n, torch.float64, cpu)
        s, x, c = gate_solve(DEV, so, kind, Config(conf), b)
        sc, _, _ = gate_solve(cpu, so, kind, Config(conf), b)
        print(f"  {name} {n}^2: card "
              f"{' '.join(f'{h:.9g}' for h in s.history)}", flush=True)
        print(f"  CPU {' '.join(f'{h:.9g}' for h in sc.history)}; counts "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
        np.testing.assert_allclose(s.history, sc.history, rtol=1e-9,
                                   atol=1e-14)
        if name.startswith("F"):
            if len(set(s.history)) != 1 or not s.history[0] < 1:
                raise AssertionError(f"{name}: F-cycle history")
            out = c
        elif not s.history[-1] < 1e-10:
            raise AssertionError(f"{name}: did not reach 1e-10")
        point = "relaxation" not in conf["solver"]
        need = ([K1, ("sweep2_periodic", "sweep2_resident_periodic")]
                if point else ["line2", "line2_periodic"])
        need += ["restrict2_periodic", "interp_add2_periodic"]
        if name.startswith("F"):
            need.append("interp2_periodic")
        require_launched(c, need, f"periodic gate {name}")
        for k, base in PERIODIC_OF.items():
            if c[k] != c[base]:
                raise AssertionError(f"{name}: {c[base] - c[k]} launches "
                                     f"of {base} not periodic")
    return out


def periodic3(make, per):
    """``make``'s 3D operator on a grid periodic along ``per``: every
    coupling kept across the wrap (``gallery.periodic3``)."""
    def periodic(nx, ny, nz, dtype=None, device=None):
        return gallery.periodic3(make(nx, ny, nz, dtype, device), per)
    periodic.__name__ = f"{make.__name__} periodic {per}"
    return periodic


def aniso_yz(nx, ny, nz, dtype=None, device=None):
    """Strong coupling in the yz planes (plane-yz's operator)."""
    return gallery.diag_diffusion3(nx, ny, nz, 1e-3, 1.0, 1.0, dtype, device)


X3, Z3, XYZ3 = (True, False, False), (False, False, True), (True,) * 3
# the 3D periodic configurations: name -> (operator, kind, shape of the
# float64 gate, conf); the triply periodic ones are singular
# (solver.definite false, b with its mean removed).  (44, 32, 32) coarsens
# to 22, 11 and 6 along its periodic x: odd at the third level.  Plane
# relaxation with the periodic axis normal to its planes (inside them,
# the JAX package's non-periodic plane solves stall, and the port copies
# them)
PERIODIC3_CONFIGS = {
    "7pt x V": (periodic3(gallery.poisson3, X3), SevenPt, (32, 32, 32),
                periodic_conf(X3)),
    "27pt xyz indefinite V": (periodic3(gallery.fe3, XYZ3), TwentySevenPt,
                              (32, 32, 32),
                              periodic_conf(XYZ3, definite=False)),
    "7pt x V odd": (periodic3(gallery.poisson3, X3), SevenPt, (44, 32, 32),
                    periodic_conf(X3)),
    "7pt z F": (periodic3(gallery.poisson3, Z3), SevenPt, (32, 32, 32),
                periodic_conf(Z3, cycle={"type": "f"})),
    "plane-yz x": (periodic3(aniso_yz, X3), SevenPt, (32, 32, 32),
                   periodic_conf(X3, relaxation="plane-yz")),
}


def periodic_rhs3(conf: dict, shape, dtype, device):
    """poisson3_rhs, its mean removed where the operator is singular."""
    b = gallery.poisson3_rhs(*shape, dtype, device)
    if not conf["solver"].get("definite", True):
        b = b - b.mean()
    return b


def require_periodic3(c: dict, what: str) -> None:
    """Every launch of K6-K9 periodic."""
    for k, base in PERIODIC3_OF.items():
        if c[k] != c[base]:
            raise AssertionError(f"{what}: {c[base] - c[k]} launches of "
                                 f"{base} not periodic")


def phase_periodic3_gates() -> dict:
    """Float64 3D periodic gates at 32³-44x32x32, card against CPU (rtol
    1e-9, atol 1e-14, as the other gates): :data:`PERIODIC3_CONFIGS` (the
    7-point x-periodic V(1,1), the 27-point triply periodic indefinite V,
    the x-periodic (44, 32, 32) V, the z-periodic F-cycle, x-periodic
    plane-yz), each through the solver's graph.  Returns the F-cycle's
    counts."""
    print("[4g] float64 3D periodic gates, card against CPU", flush=True)
    cpu = torch.device("cpu")
    out = {}
    for name, (make, kind, shape, conf) in PERIODIC3_CONFIGS.items():
        fcycle = conf["solver"].get("cycle", {}).get("type") == "f"
        conf = {**conf, "log": [], "solver": {
            "tol": 1e-10, "max-iter": 3 if fcycle else 20,
            **conf["solver"]}}
        so = make(*shape, torch.float64, cpu)
        b = periodic_rhs3(conf, shape, torch.float64, cpu)
        reset_counts()
        s = Solver3(so.to(DEV), kind, Config(conf))
        x = s.solve(b.to(DEV))
        c = counts()
        check_graph(s, b.to(DEV), x, f"periodic3 gate {name}", cycle3)
        sc = Solver3(so, kind, Config(conf))
        sc.solve(b)
        print(f"  {name} {shape}: card "
              f"{' '.join(f'{h:.9g}' for h in s.history)}", flush=True)
        print(f"  CPU {' '.join(f'{h:.9g}' for h in sc.history)}; counts "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
        np.testing.assert_allclose(s.history, sc.history, rtol=1e-9,
                                   atol=1e-14)
        if fcycle:
            if len(set(s.history)) != 1 or not s.history[0] < 1:
                raise AssertionError(f"{name}: F-cycle history")
            out = c
        elif not s.history[-1] < 1e-10:
            raise AssertionError(f"{name}: did not reach 1e-10")
        relax = conf["solver"].get("relaxation", "point")
        need = ["restrict3_periodic", "interp_add3_periodic"]
        if relax == "point":
            need.append(("sweep3_periodic", "sweep3_resident_periodic"))
        else:
            need += ["line_xy2", "restrict2", "interp_add2"]
        if fcycle:
            need.append("interp3_periodic")
        require_launched(c, need, f"periodic3 gate {name}")
        require_periodic3(c, f"periodic3 gate {name}")
    return out


# every configuration the port runs, small: name -> (gallery operator,
# kind, shape, conf); each in float32 and float64 through the graph
def cedar_conf(levels: int, cg: dict, **solver) -> dict:
    """``cg-solver: cedar`` below ``levels`` outer levels, the cg-config's
    solver section ``cg``."""
    return {"solver": {"num-levels": levels, "cg-solver": "cedar", **solver},
            "cg-config": {"solver": cg}}


# tests/test_cgsolve.py's cases (tests/test_torch_cgsolve.py): name ->
# (gallery function, kind, shape, config)
CEDAR_GATES = {
    "2d 128^2": (gallery.poisson, FivePt, (128, 128), cedar_conf(
        3, {"tol": 1e-12, "max-iter": 20})),
    "3d 24^3": (gallery.poisson3, SevenPt, (24, 24, 24), cedar_conf(
        2, {"tol": 1e-12, "max-iter": 20})),
    "2d 128^2 nested": (gallery.poisson, FivePt, (128, 128), {
        "solver": {"num-levels": 2, "cg-solver": "cedar"},
        "cg-config": {"solver": {"tol": 1e-12, "max-iter": 20,
                                 "num-levels": 2, "cg-solver": "cedar"},
                      "cg-config": {"solver": {"tol": 1e-12,
                                               "max-iter": 20}}}}),
}


# solver.ml-relax.enabled: the full-length PCR line solve
ML = {"ml-relax": {"enabled": True}}


def plane_conf(relax: str, pconf: dict) -> dict:
    return {"solver": {"relaxation": relax}, "plane-config": pconf}


# the float64 plane-config gates at 32³, card against CPU: name ->
# (gallery function, kind, config)
PLANE_GATES = {
    "plane-xy point": (aniso3, SevenPt, plane_conf(
        "plane-xy", {"solver": {"relaxation": "point"}})),
    "plane-yz line-x 27pt": (gallery.fe3, TwentySevenPt, plane_conf(
        "plane-yz", {"solver": {"relaxation": "line-x"}})),
    "plane-xyz line-y": (gallery.poisson3, SevenPt, plane_conf(
        "plane-xyz", {"solver": {"relaxation": "line-y", "max-iter": 1}})),
    "plane-xy F": (aniso3, SevenPt, plane_conf(
        "plane-xy", {"solver": {"relaxation": "line-xy", "max-iter": 1,
                                "cycle": {"type": "f"}}})),
    "plane-xy cedar": (aniso3, SevenPt, plane_conf(
        "plane-xy", {"solver": {"relaxation": "point", "cg-solver": "cedar",
                                "min-coarse": 5},
                     "cg-config": {"solver": {"tol": 1e-6,
                                              "max-iter": 6}}})),
}


GRAPH_CONFIGS = {
    "2d point V fused": (gallery.poisson, FivePt, (129, 97), {}),
    "2d point V dense": (gallery.poisson, FivePt, (129, 97),
                         {"kernels": {"fine-split": False}}),
    "2d point V(2,2) fused": (gallery.poisson, FivePt, (129, 97), {
        "solver": {"cycle": {"nrelax-pre": 2, "nrelax-post": 2}}}),
    "2d point F fused": (gallery.poisson, FivePt, (129, 97),
                         {"solver": {"cycle": {"type": "f"}}}),
    "2d point F dense": (gallery.poisson, FivePt, (129, 97), {
        "kernels": {"fine-split": False},
        "solver": {"cycle": {"type": "f"}}}),
    "2d line-x": (gallery.fe, NinePt, (129, 97),
                  {"solver": {"relaxation": "line-x"}}),
    "2d line-y": (gallery.fe, NinePt, (129, 97),
                  {"solver": {"relaxation": "line-y"}}),
    "2d line-xy": (gallery.fe, NinePt, (257, 257),
                   {"solver": {"relaxation": "line-xy"}}),
    "3d 7pt V dense": (gallery.poisson3, SevenPt, (33, 33, 33), {}),
    "3d 7pt V fused": (gallery.poisson3, SevenPt, (33, 33, 33),
                       {"kernels": {"fine-split": True}}),
    "3d 7pt V(2,2) fused": (gallery.poisson3, SevenPt, (33, 33, 33), {
        "kernels": {"fine-split": True},
        "solver": {"cycle": {"nrelax-pre": 2, "nrelax-post": 2}}}),
    "3d 7pt F fused": (gallery.poisson3, SevenPt, (33, 33, 33), {
        "kernels": {"fine-split": True},
        "solver": {"cycle": {"type": "f"}}}),
    "3d 7pt F dense": (gallery.poisson3, SevenPt, (33, 33, 33),
                       {"solver": {"cycle": {"type": "f"}}}),
    "3d 27pt V dense": (gallery.fe3, TwentySevenPt, (33, 33, 33), {}),
    "3d 27pt V fused": (gallery.fe3, TwentySevenPt, (33, 33, 33),
                        {"kernels": {"fine-split": True}}),
    "3d 27pt F fused": (gallery.fe3, TwentySevenPt, (33, 33, 33), {
        "kernels": {"fine-split": True},
        "solver": {"cycle": {"type": "f"}}}),
    "3d plane-xy": (aniso3, SevenPt, (32, 32, 32),
                    {"solver": {"relaxation": "plane-xy"}}),
    "3d plane-xz": (aniso3, SevenPt, (24, 20, 16),
                    {"solver": {"relaxation": "plane-xz"}}),
    "3d 27pt plane-yz": (gallery.fe3, TwentySevenPt, (16, 20, 24),
                         {"solver": {"relaxation": "plane-yz"}}),
    "3d plane-xyz": (gallery.poisson3, SevenPt, (16, 16, 16),
                     {"solver": {"relaxation": "plane-xyz"}}),
    # the periodic ones (even extents on every relaxed level, as lines
    # across a periodic axis need)
    **{f"2d periodic {name}": (make, kind, (64, 48), conf)
       for name, (make, kind, conf) in PERIODIC_CONFIGS.items()
       if name != "9pt x"},
    # the 3D periodic ones at an odd periodic extent on a swept level
    # (22 -> 11) and the fused cycle asked for
    **{f"3d periodic {name}": (make, kind, (22, 16, 16), conf)
       for name, (make, kind, _, conf) in PERIODIC3_CONFIGS.items()
       if name != "7pt x V odd"},
    "3d periodic fine-split": (periodic3(gallery.poisson3, X3), SevenPt,
                               (22, 16, 16), {"kernels": {"fine-split": True},
                                              **periodic_conf(X3)}),
    # the inner multigrid coarse solve (cg-solver cedar) and the
    # plane-configs beyond line-xy V-cycles
    "2d cedar V fused": (gallery.poisson, FivePt, (129, 97), cedar_conf(
        3, {"tol": 1e-6, "max-iter": 4})),
    "2d cedar V dense nested": (gallery.poisson, FivePt, (129, 97), {
        "kernels": {"fine-split": False},
        "solver": {"num-levels": 2, "cg-solver": "cedar"},
        "cg-config": {"solver": {"tol": 1e-6, "max-iter": 3,
                                 "num-levels": 2, "cg-solver": "cedar"},
                      "cg-config": {"solver": {"max-iter": 3}}}}),
    "2d cedar F": (gallery.poisson, FivePt, (129, 97), cedar_conf(
        3, {"tol": 1e-6, "max-iter": 4}, cycle={"type": "f"})),
    "2d cedar periodic indefinite": (periodic_grid(gallery.poisson,
                                                   (True, True)),
                                     FivePt, (64, 48), {
        **cedar_conf(2, {"tol": 1e-6, "max-iter": 4}, definite=False),
        "grid": {"periodic": [True, True]}}),
    "3d cedar V dense": (gallery.poisson3, SevenPt, (33, 33, 33), cedar_conf(
        2, {"tol": 1e-6, "max-iter": 4})),
    "3d cedar V fused 27pt": (gallery.fe3, TwentySevenPt, (33, 33, 33), {
        "kernels": {"fine-split": True},
        **cedar_conf(3, {"tol": 1e-6, "max-iter": 4})}),
    **{f"3d {name}": (make, kind, (24, 24, 24), conf)
       for name, (make, kind, conf) in PLANE_GATES.items()},
    # solver.ml-relax.enabled: the lines of 64 points or more by the
    # full-length PCR (K4 and K10 at the full stride), at the top level, in
    # a plane-config and in a cg-config
    "2d ml line-x": (gallery.fe, NinePt, (129, 97),
                     {"solver": {"relaxation": "line-x", **ML}}),
    "2d ml line-y": (gallery.fe, NinePt, (129, 97),
                     {"solver": {"relaxation": "line-y", **ML}}),
    "2d ml line-xy": (gallery.fe, NinePt, (257, 257),
                      {"solver": {"relaxation": "line-xy", **ML}}),
    "3d plane-xy ml line-xy": (aniso3, SevenPt, (64, 64, 8), plane_conf(
        "plane-xy", {"solver": {"relaxation": "line-xy", "max-iter": 1,
                                **ML}})),
    "2d cedar ml line-x": (gallery.poisson, FivePt, (257, 129), cedar_conf(
        2, {"relaxation": "line-x", "tol": 1e-6, "max-iter": 4, **ML})),
}


def phase_graph_configs() -> None:
    """Every configuration the port runs (:data:`GRAPH_CONFIGS`), float32
    and float64, through the solver's captured graph: a solve of at most
    six cycles held bit for bit to the eager loop and a vcycle to
    ``run_cycle`` (:func:`check_graph`)."""
    print("[4e] every configuration through the graph, float32 and "
          "float64", flush=True)
    for dt in (torch.float32, torch.float64):
        for name, (make, kind, shape, conf) in GRAPH_CONFIGS.items():
            what = f"{name} {shape} {str(dt)[6:]}"
            cls, rhs, cyc = (
                (Solver2, gallery.poisson_rhs, cycle2) if len(shape) == 2
                else (Solver3, gallery.poisson3_rhs, cycle3))
            solver = {"tol": 1e-6 if dt == torch.float32 else 1e-10,
                      "max-iter": 6, **conf.get("solver", {})}
            s = cls(make(*shape, dt, DEV), kind,
                    Config({"log": [], **conf, "solver": solver}))
            b = rhs(*shape, dt, DEV)
            if not conf.get("solver", {}).get("definite", True):
                b = b - b.mean()   # the singular fully periodic operator
            x = s.solve(b)
            if not torch.isfinite(x).all():
                raise AssertionError(f"{what}: bad solution")
            check_graph(s, b, x, what, cyc)
            del s, b, x
    torch.cuda.empty_cache()


def run_cycles(one, ncycles: int) -> tuple[float, float, float, float]:
    """CUDA-event ms of each of ``ncycles`` calls of ``one``: (median, min,
    max, host clock ms a cycle)."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(ncycles)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e0, e1 in ev:
        e0.record()
        one()
        e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / ncycles
    cyc = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
    return statistics.median(cyc), cyc[0], cyc[-1], host_ms


def time_cycles(s, b, x, ncycles=25, cycle=cycle2, pairs=PAIRS):
    """Eager against graph: ``pairs`` pairs of ``ncycles`` CUDA-event-timed
    cycles as the solve runs them (the cycle and the convergence norm, no
    readback), the eager ``cycle_residual`` and a replay of the solver's
    captured iteration, alternating which goes first, after three warm-up
    cycles each; prints each run's median, min, max and host clock, and
    per way the median of the medians and the range of the medians.
    ``cycle`` is the cycle module of the solver's dimension.  Returns the
    graph's median of medians."""
    g = s.graphs.graph("solve", b)
    g.x.copy_(x)
    g.b.copy_(b)
    xe = x.clone()

    def eager():
        nonlocal xe
        xe = cycle.cycle_residual(s.levels, s.kinds, xe, b, s.settings,
                                  **s.graphs.cycle_kw)[0]

    ways = {"eager": eager, "graph": g.replay}
    for one in ways.values():
        for _ in range(3):
            one()
    runs = {"eager": [], "graph": []}
    for k in range(pairs):
        for way in (("eager", "graph") if k % 2 == 0 else ("graph", "eager")):
            ms, lo, hi, host = run_cycles(ways[way], ncycles)
            runs[way].append(ms)
            print(f"  pair {k} {way} cycle ms: median {ms:.4f}, min "
                  f"{lo:.4f}, max {hi:.4f} (host clock {host:.4f} ms/cycle)",
                  flush=True)
    med = {w: statistics.median(v) for w, v in runs.items()}
    wins = sum(a < e for a, e in zip(runs["graph"], runs["eager"]))
    print(f"  cycle ms, median of {pairs} medians: eager {med['eager']:.4f} "
          f"({min(runs['eager']):.4f}-{max(runs['eager']):.4f}), graph "
          f"{med['graph']:.4f} ({min(runs['graph']):.4f}-"
          f"{max(runs['graph']):.4f}); graph faster in {wins} of {pairs}",
          flush=True)
    return med["graph"]


def check_graph(s, b, x, what: str, cycle=cycle2, x0=None) -> None:
    """The solver's last solve, from ``x0`` (default zeros), which replayed
    its captured iteration (``x``, ``s.history``), against the same solve
    run eagerly (``cycle_residual`` a cycle, the loop of the CPU), and one
    ``vcycle`` (its own graph) against ``run_cycle``: bit for bit."""
    xe = torch.zeros_like(b) if x0 is None else x0.clone()

    def step():
        nonlocal xe
        xe, rnorm = cycle.cycle_residual(s.levels, s.kinds, xe, b,
                                         s.settings, **s.graphs.cycle_kw)
        return rnorm

    hist = graph.iterate(step, s.res0, s.settings)
    if hist != s.history:
        raise AssertionError(f"{what}: graph history {s.history} != eager "
                             f"{hist}")
    if not torch.equal(x, xe):
        raise AssertionError(f"{what}: graph x != eager x (max |diff| "
                             f"{float((x - xe).abs().max()):.3e})")
    xv = s.vcycle(x, b)
    xr = cycle.run_cycle(s.levels, s.kinds, x.clone(), b, s.settings,
                         **s.graphs.cycle_kw)
    if not torch.equal(xv, xr):
        raise AssertionError(f"{what}: graph vcycle != run_cycle (max "
                             f"|diff| {float((xv - xr).abs().max()):.3e})")
    print(f"  {what}: graph = eager bit for bit ({len(hist)} cycles: "
          "history and x; a vcycle)", flush=True)


def phase_main_path() -> dict:
    n = N_MAIN
    print(f"[5] main path: Poisson {n}^2 float32 V(1,1)", flush=True)
    conf = Config({"log": [], "solver": {
        "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-7, "max-iter": 4}})
    so = gallery.poisson(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = Solver2(so, FivePt, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  levels {s.nlevels}: {s.shapes[0]} .. {s.shapes[-1]}; "
          f"setup {setup_s:.3f} s", flush=True)
    print(f"  history: {' '.join(f'{h:.6g}' for h in s.history)}", flush=True)
    print(f"  counts: {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != (n, n):
        raise AssertionError("main path: bad solution")
    # At this size the first cycle leaves |b - A x| / |b| near 1 (0.34 at
    # 256^2, 0.62 at 1024^2, in both packages and in float64 too), and in
    # float32 the later cycles stop near eps * cond(A), about 2e-2: four
    # cycles must still cut the residual >= 5x overall
    if not s.history[-1] < s.history[0] / 5:
        raise AssertionError("main path: the solve did not converge")
    require_launched(launches, ("sweep2", "sweep2_resident", "restrict2",
                                "interp_add2", "sweep_restrict2",
                                "interp_sweep2"), "main path")
    check_graph(s, b, x, "main path")
    # one solve-loop cycle: K12 and K13 on the fused levels 0-3, K1-K3 on
    # the dense levels below (K1 one launch a sweep: the pre-sweep with its
    # residual and the post-sweep; streamed at 256² and 128², resident
    # below), no K11 at V(1,1); 32 launches in all
    dense = s.nlevels - 1 - SPLIT_LEVELS
    resident = sum(cuda2.plan(4, True, shape).resident
                   for shape in s.shapes[SPLIT_LEVELS:-1])
    one = one_cycle_launches(s, b, "main path", {
        "sweep_restrict2": SPLIT_LEVELS, "interp_sweep2": SPLIT_LEVELS,
        "sweep2_fused": 0, "restrict2": dense, "interp_add2": dense,
        "sweep2": 2 * (dense - resident), "sweep2_resident": 2 * resident})
    total = sum(one.get(k, 0) for k in KERNELS)
    k1 = sum(one.get(k, 0) for k in K1)
    print(f"  main path: {total} kernel launches a cycle, K1 {k1}",
          flush=True)
    if k1 != 2 * dense:
        raise AssertionError(f"main path: K1 launched {k1} times a cycle")
    if total > 32:
        raise AssertionError(f"main path: {total} launches a cycle > 32")

    # the convergence rate, free of that floor: A x = 0 from a random x0
    # (the error itself is what shrinks); each of 4 cycles must cut >= 5x
    g = torch.Generator(device=DEV).manual_seed(11)
    x0 = torch.randn((n, n), generator=g, device=DEV, dtype=torch.float32)
    xr = s.solve(torch.zeros_like(b), x0)
    h = [1.0] + s.history
    print(f"  A x = 0 from random x0: {' '.join(f'{v:.6g}' for v in h[1:])}",
          flush=True)
    check_graph(s, torch.zeros_like(b), xr, "main path, A x = 0", x0=x0)
    if len(h) < 5 or any(h[i + 1] > h[i] / 5 for i in range(4)):
        raise AssertionError("main path: a cycle cut the residual < 5x")

    ms = time_cycles(s, b, x)
    print(f"  DOF/s: {n * n / (ms * 1e-3):.4e}; "
          f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
          flush=True)
    return launches


def one_cycle_launches(s, b, what: str, want: dict | None,
                       cycle=cycle2) -> dict:
    """The launches of one captured solve-loop cycle, checked against
    ``want`` (kernel -> count; None: not checked): a graph of the solver's
    iteration over its hierarchy, warmed up, the counts reset, captured
    from x = 0; a replay then adds no launch and runs no plain version.
    Prints the warm-up and capture seconds, and the device memory of one
    eager cycle (its peak above what was allocated before it) and of the
    graph (what its pool keeps reserved after the capture, beside its
    static buffers).  ``cycle`` is the cycle module of the solver's
    dimension."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cycle.cycle_residual(s.levels, s.kinds, torch.zeros_like(b), b,
                         s.settings, **s.graphs.cycle_kw)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    g = graph.CycleGraphs(cycle, s.levels, s.kinds, s.settings,
                          **s.graphs.cycle_kw).graph("solve", b)
    g.b.copy_(b)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    g.warm()
    t1 = time.perf_counter()
    reset_counts()
    # the capture empties the allocator's cache first: the warm-up's
    # memory is not the pool's
    g.capture()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    one = {k: v for k, v in counts().items() if v}
    pool = torch.cuda.memory_reserved() - reserved
    reset_counts()
    g.replay()
    torch.cuda.synchronize()
    if any(counts().values()):
        raise AssertionError(f"{what}: a replay counted {counts()}")
    if not torch.isfinite(g.norm) or not torch.isfinite(g.x).all():
        raise AssertionError(f"{what}: the replayed cycle is not finite")
    del g
    torch.cuda.empty_cache()
    print(f"  {what}: launches a captured cycle {one}", flush=True)
    print(f"  {what}: warm-up {t1 - t0:.3f} s, capture {t2 - t1:.3f} s; "
          f"memory: eager cycle peak {eager_peak / 2**20:.1f} MiB, graph "
          f"pool {pool / 2**20:.1f} MiB (+ static x, b "
          f"{2 * b.nbytes / 2**20:.1f} MiB)", flush=True)
    if any(k.endswith("_plain") for k in one):
        raise AssertionError(f"{what}: the captured cycle ran a plain "
                             "version")
    for k, v in (want or {}).items():
        if one.get(k, 0) != v:
            raise AssertionError(f"{what}: {k} launched {one.get(k, 0)} "
                                 f"times a cycle, not {v}")
    return one


def phase_main_variants() -> dict:
    """The main path's problem with the dense cycle (``kernels.fine-split``
    false: the path before the fused kernels) and with the fused V(2,2),
    which runs K11: setup, a solve of four cycles, the launches of one
    cycle, the per-cycle time.  Returns the V(2,2) solve's launches."""
    n = N_MAIN
    so = gallery.poisson(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    out = {}
    for name, cycle, kernels, want in (
            ("dense V(1,1)", {"nrelax-pre": 1, "nrelax-post": 1},
             {"fine-split": False},
             {"sweep_restrict2": 0, "interp_sweep2": 0, "sweep2_fused": 0}),
            ("fused V(2,2)", {"nrelax-pre": 2, "nrelax-post": 2}, {},
             {"sweep_restrict2": SPLIT_LEVELS, "interp_sweep2": SPLIT_LEVELS,
              "sweep2_fused": 2 * SPLIT_LEVELS})):
        print(f"[5] main path variant: Poisson {n}^2 float32 {name}",
              flush=True)
        conf = Config({"log": [], "kernels": kernels, "solver": {
            "cycle": cycle, "tol": 1e-7, "max-iter": 4}})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        s = Solver2(so, FivePt, conf)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        x = s.solve(b)
        torch.cuda.synchronize()
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"  {name}: setup {setup_s:.3f} s; history "
              f"{' '.join(f'{h:.6g}' for h in s.history)}", flush=True)
        print(f"  {name}: counts {launches}", flush=True)
        if not torch.isfinite(x).all() or tuple(x.shape) != (n, n):
            raise AssertionError(f"{name}: bad solution")
        if not s.history[-1] < s.history[0] / 5:
            raise AssertionError(f"{name}: the solve did not converge")
        require_launched(launches, (K1, "restrict2", "interp_add2"), name)
        check_graph(s, b, x, name)
        one_cycle_launches(s, b, name, want)
        ms = time_cycles(s, b, x)
        print(f"  {name}: DOF/s {n * n / (ms * 1e-3):.4e}; "
              f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
              flush=True)
        out[name] = launches
        del s, x
    return out["fused V(2,2)"]


def phase_linexy_2048() -> dict:
    """``2d_fe_9pt_linexy_2048`` (bench.py:139-149) on the port."""
    name, n = "2d_fe_9pt_linexy_2048", N_LINES
    print(f"[5b] {name}: fe {n}^2 9-pt float32, line-xy V(1,1)", flush=True)
    conf = Config({"log": [], "solver": {
        "relaxation": "line-xy", "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "max-iter": 4, "tol": 1e-6}})
    so = gallery.fe(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = Solver2(so, NinePt, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  {name}: levels {s.nlevels}: {s.shapes[0]} .. {s.shapes[-1]}; "
          f"setup {setup_s:.3f} s", flush=True)
    print(f"  {name}: history {' '.join(f'{h:.6g}' for h in s.history)}",
          flush=True)
    print(f"  {name}: counts {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != (n, n):
        raise AssertionError(f"{name}: bad solution")
    if not s.history[-1] < s.history[0] / 5:
        raise AssertionError(f"{name}: the solve did not converge")
    require_launched(launches, ("line2", "restrict2", "interp_add2"), name)
    check_graph(s, b, x, name)
    # one launch a zebra colour: x- and y-lines, two colours each, pre- and
    # post-relaxation, on every level but the coarsest
    one_cycle_launches(s, b, name, {"line2": 8 * (s.nlevels - 1)})

    # the convergence rate on A x = 0 from a random x0, cycle by cycle as
    # the solve loop runs them (a tolerance would stop it at the f32 floor)
    g = torch.Generator(device=DEV).manual_seed(12)
    xr = torch.randn((n, n), generator=g, device=DEV, dtype=torch.float32)
    zero = torch.zeros_like(b)
    fine = s.levels[0]
    r0 = float(residual(fine.so, xr, zero, NinePt).norm())
    h = [1.0]
    for _ in range(4):
        xr = cycle2.run_cycle(s.levels, s.kinds, xr, zero, s.settings)
        h.append(float(residual(fine.so, xr, zero, NinePt).norm()) / r0)
    print(f"  {name}: A x = 0 from random x0: "
          f"{' '.join(f'{v:.6g}' for v in h[1:])}", flush=True)
    if any(not h[i + 1] <= h[i] / 5 for i in range(4)):
        raise AssertionError(f"{name}: a cycle cut the residual < 5x")

    ms = time_cycles(s, b, x)
    print(f"  {name}: DOF/s {n * n / (ms * 1e-3):.4e}; "
          f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
          flush=True)
    return launches


def phase_fcycle_4096() -> dict:
    """``2d_poisson_fcycle_4096`` (bench.py:151-160) on the port."""
    name, n = "2d_poisson_fcycle_4096", N_MAIN
    print(f"[5b] {name}: Poisson {n}^2 float32, F-cycle, V(1,1) inside",
          flush=True)
    conf = Config({"log": [], "solver": {
        "cycle": {"type": "f", "nrelax-pre": 1, "nrelax-post": 1},
        "max-iter": 4, "tol": 1e-6}})
    so = gallery.poisson(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = Solver2(so, FivePt, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    err = float((x - gallery.poisson_solution(n, n, torch.float32,
                                              DEV)).abs().max())
    print(f"  {name}: levels {s.nlevels}; setup {setup_s:.3f} s", flush=True)
    print(f"  {name}: history {' '.join(f'{h:.9g}' for h in s.history)}; "
          f"solution error {err:g}", flush=True)
    print(f"  {name}: counts {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != (n, n):
        raise AssertionError(f"{name}: bad solution")
    # the F-cycle recomputes the same x each iteration (as cedar_tpu's);
    # one F-cycle reaches discretisation accuracy up to float32 rounding
    if len(set(s.history)) != 1 or not s.history[0] < 1:
        raise AssertionError(f"{name}: history not constant and < 1")
    if not err < 1e-2:
        raise AssertionError(f"{name}: solution error {err:g}")
    require_launched(launches, (K1, "restrict2", "interp_add2",
                                "interp2"), name)
    check_graph(s, b, x, name)
    one_cycle_launches(s, b, name, None)
    ms = time_cycles(s, b, x)
    print(f"  {name}: DOF/s {n * n / (ms * 1e-3):.4e}; "
          f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
          flush=True)
    return launches


def phase_periodic_full() -> dict:
    """The 2D periodic path at full width, float32: 4096² x-periodic
    5-point Poisson V(1,1) (the dense cycle: K1 streamed at 4096² .. 128²,
    resident from 64² down, K2/K3 on every level), the same grid doubly
    periodic with ``solver.definite: false`` (b with its mean removed), and
    2048² line-x on an x-periodic anisotropic operator.  Each: setup, a
    solve, the launches of one captured cycle asserted (every launch
    periodic, no plain version; K4 one launch a zebra colour), graph
    against eager ms a cycle, peak memory.  Returns the periodic entries'
    launches in the solves."""
    out = {}
    cases = (
        ("2d_poisson_periodic_x_4096", N_MAIN, "point x"),
        ("2d_poisson_periodic_xy_4096", N_MAIN, "indefinite xy"),
        ("2d_aniso_periodic_x_linex_2048", N_LINES, "line-x"),
    )
    for name, n, which in cases:
        make, kind, conf = PERIODIC_CONFIGS[which]
        conf = {**conf, "log": [], "solver": {
            "cycle": {"nrelax-pre": 1, "nrelax-post": 1}, "tol": 1e-7,
            "max-iter": 4, **conf["solver"]}}
        print(f"[5e] {name}: {which}, {n}^2 float32 V(1,1)", flush=True)
        so = make(n, n, torch.float32, DEV)
        b = periodic_rhs(conf, n, n, torch.float32, DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        s = Solver2(so, kind, Config(conf))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        x = s.solve(b)
        torch.cuda.synchronize()
        c = counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"  {name}: levels {s.nlevels}; setup {setup_s:.3f} s; "
              f"history {' '.join(f'{h:.6g}' for h in s.history)}",
              flush=True)
        print(f"  {name}: counts { {k: v for k, v in c.items() if v} }",
              flush=True)
        if not torch.isfinite(x).all() or tuple(x.shape) != (n, n):
            raise AssertionError(f"{name}: bad solution")
        if not s.history[-1] < s.history[0]:
            raise AssertionError(f"{name}: the solve did not converge")
        point = which != "line-x"
        require_launched(c, ["restrict2_periodic", "interp_add2_periodic",
                             ("sweep2_periodic", "sweep2_resident_periodic")
                             if point else "line2_periodic"], name)
        check_graph(s, b, x, name)
        relaxed = s.nlevels - 1
        if point:
            resident = sum(
                cuda2.plan(4, kind == StencilKind.nine_pt, shape).resident
                for kind, shape in zip(s.kinds[:-1], s.shapes[:-1]))
            want = {"sweep2": 2 * (relaxed - resident),
                    "sweep2_resident": 2 * resident, "line2": 0}
        else:
            want = {"line2": 4 * relaxed, "sweep2": 0, "sweep2_resident": 0}
        want.update({"restrict2": relaxed, "interp_add2": relaxed,
                     "sweep_restrict2": 0, "interp_sweep2": 0,
                     "sweep2_fused": 0})
        want.update({k: want[base] for k, base in PERIODIC_OF.items()
                     if base in want})
        one = one_cycle_launches(s, b, name, want)
        total = sum(one.get(k, 0) for k in KERNELS
                    if k not in PERIODIC_OF and k not in BATCHED_OF)
        print(f"  {name}: {total} kernel launches a cycle, all periodic",
              flush=True)
        ms = time_cycles(s, b, x)
        print(f"  {name}: DOF/s {n * n / (ms * 1e-3):.4e}; "
              f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
              flush=True)
        for k in PERIODIC_OF:
            if c[k]:
                out[k] = out.get(k, 0) + c[k]
        del s, x, so, b
        torch.cuda.empty_cache()
    return out


def periodic3_cycle_launches(s) -> dict:
    """The launches of one solve-loop cycle of a dense periodic 3D point
    V(1,1) cycle, from the plans: each level but the coarsest one sweep
    DOWN with the residual (that feeds K7) and one UP (the top level's
    with the convergence residual) on K6's periodic route
    (``cuda3.plan(..., periodic=True)``: resident or a launch a colour and
    the residual), K7 and K8 once; every launch periodic."""
    smem = cuda3._build_of(cuda_build.load("sweep3"))
    c = {}
    for lvl, (kind, shape) in enumerate(zip(s.kinds[:-1], s.shapes[:-1])):
        ts = kind == StencilKind.twenty_seven_pt
        p = cuda3.plan(4, ts, shape, smem, True)
        for k, _ in (cuda3.launch_list(p, kind, "down", True)
                     + cuda3.launch_list(p, kind, "up", lvl == 0)):
            c[k] = c.get(k, 0) + 1
    c["restrict3"] = c["interp_add3"] = s.nlevels - 1
    for k in ("sweep3", "sweep3_resident"):
        c.setdefault(k, 0)
    c.update({k: c[base] for k, base in PERIODIC3_OF.items() if base in c})
    c.update(dict.fromkeys(FUSED3 + ("edge27",), 0))
    return c


def phase_periodic3_full() -> dict:
    """The 3D periodic path at full width, float32, each with setup, a
    solve of four cycles, the launches of one captured cycle asserted
    (every K6-K9 launch periodic, no plain version), graph against eager
    ms a cycle, the capture's seconds and memory, peak memory:
    ``3d_poisson_7pt_256`` (bench.py:162-171) periodic in x, the same grid
    triply periodic and singular (b with its mean removed), 128³ 27-point
    ``fe3`` triply periodic (every coupling kept across the wrap), each
    point V(1,1) on the dense cycle; ``3d_aniso_planexy_128``
    (bench.py:173-184) periodic in z, normal to the planes.  Returns the
    periodic entries' launches in the solves."""
    out = {}
    cases = (
        ("3d_poisson_7pt_256_periodic_x", N_3D,
         periodic3(gallery.poisson3, X3), SevenPt, periodic_conf(X3)),
        ("3d_poisson_7pt_256_periodic_xyz", N_3D,
         periodic3(gallery.poisson3, XYZ3), SevenPt,
         periodic_conf(XYZ3, definite=False)),
        ("3d_fe_27pt_128_periodic_xyz", N_27, periodic3(gallery.fe3, XYZ3),
         TwentySevenPt, periodic_conf(XYZ3, definite=False)),
        ("3d_aniso_planexy_128_periodic_z", N_PLANES, periodic3(aniso3, Z3),
         SevenPt, periodic_conf(Z3, relaxation="plane-xy")),
    )
    for name, n, make, kind, conf in cases:
        conf = {**conf, "log": [], "solver": {
            "cycle": {"nrelax-pre": 1, "nrelax-post": 1}, "tol": 1e-6,
            "max-iter": 4, **conf["solver"]}}
        print(f"[5f] {name}: {make.__name__}, {n}^3 float32 V(1,1)",
              flush=True)
        so = make(n, n, n, torch.float32, DEV)
        b = periodic_rhs3(conf, (n,) * 3, torch.float32, DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        s = Solver3(so, kind, Config(conf))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        del so
        x = s.solve(b)
        torch.cuda.synchronize()
        c = counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"  {name}: levels {s.nlevels}: {s.shapes[0]} .. "
              f"{s.shapes[-1]}; setup {setup_s:.3f} s; history "
              f"{' '.join(f'{h:.6g}' for h in s.history)}", flush=True)
        print(f"  {name}: counts { {k: v for k, v in c.items() if v} }",
              flush=True)
        if not torch.isfinite(x).all() or tuple(x.shape) != (n,) * 3:
            raise AssertionError(f"{name}: bad solution")
        if not s.history[-1] < s.history[0]:
            raise AssertionError(f"{name}: the solve did not converge")
        point = "relaxation" not in conf["solver"]
        require_launched(c, ["restrict3_periodic", "interp_add3_periodic"]
                         + ([("sweep3_periodic", "sweep3_resident_periodic")]
                            if point else list(PLANE_KERNELS)), name)
        require_periodic3(c, name)
        check_graph(s, b, x, name, cycle3)
        if point:
            want = periodic3_cycle_launches(s)
        else:
            # K10 as in phase_planes_128; the outer transfers periodic
            want = {"line_xy2": sum(
                2 * 2 * (len(h) - 1) for lev in s.levels[:-1]
                for h in lev.planes["xy"] if h is not None),
                "restrict3_periodic": s.nlevels - 1,
                "interp_add3_periodic": s.nlevels - 1}
        one = one_cycle_launches(s, b, name, want, cycle3)
        require_periodic3({k: one.get(k, 0) for k in c}, name)
        total = sum(one.get(k, 0) for k in KERNELS
                    if k not in PERIODIC_OF and k not in BATCHED_OF)
        print(f"  {name}: {total} kernel launches a cycle, K6-K9's all "
              "periodic", flush=True)
        ms = time_cycles(s, b, x, cycle=cycle3)
        print(f"  {name}: DOF/s {n ** 3 / (ms * 1e-3):.4e}; "
              f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
              flush=True)
        for k in PERIODIC3_OF:
            if c[k]:
                out[k] = out.get(k, 0) + c[k]
        del s, x, b
        torch.cuda.empty_cache()
    return out


def run_path3(name: str, n: int, make, kind, solver: dict, need,
              kernels=None, want=None) -> dict:
    """One of ``bench.py``'s 3D configurations on the port, float32:
    setup, a solve of four cycles with launch counts, the launches of one
    cycle checked against ``want`` (kernel -> count), the convergence rate
    on A x = 0 from a random x0 (V-cycles) or the solution error
    (F-cycle), the per-cycle time, DOF/s and peak memory.  ``kernels`` is
    the configuration's ``kernels`` section (default: none, the card's
    fused cycle)."""
    cyc = {"nrelax-pre": 1, "nrelax-post": 1, **solver.get("cycle", {})}
    fcycle = cyc.get("type") == "f"
    kind_of = ("F-cycle with V(1,1) inside" if fcycle else
               f"V({cyc['nrelax-pre']},{cyc['nrelax-post']})")
    print(f"[5c] {name}: {make.__name__} {n}^3 float32, {kind_of}, "
          f"kernels {kernels or {}}", flush=True)
    conf = Config({"log": [], "kernels": kernels or {}, "solver": {
        **solver, "cycle": cyc, "max-iter": 4, "tol": 1e-6}})
    so = make(n, n, n, torch.float32, DEV)
    b = gallery.poisson3_rhs(n, n, n, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = Solver3(so, kind, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    del so
    print(f"  {name}: levels {s.nlevels}: {s.shapes[0]} .. {s.shapes[-1]}; "
          f"setup {setup_s:.3f} s", flush=True)
    print(f"  {name}: history {' '.join(f'{h:.9g}' for h in s.history)}",
          flush=True)
    print(f"  {name}: counts {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != (n, n, n):
        raise AssertionError(f"{name}: bad solution")
    require_launched(launches, need, name)
    check_graph(s, b, x, name, cycle3)
    one_cycle_launches(s, b, name, want, cycle3)
    if fcycle:
        # the F-cycle recomputes the same x each iteration (as cedar_tpu's),
        # so A x = 0 from a random x0 gives x = 0: the solution error
        # against the analytic solution is its check
        err = float((x - gallery.poisson3_solution(
            n, n, n, torch.float32, DEV)).abs().max())
        print(f"  {name}: solution error {err:g}", flush=True)
        if len(set(s.history)) != 1 or not s.history[0] < 1:
            raise AssertionError(f"{name}: history not constant and < 1")
        if not err < 1e-2:
            raise AssertionError(f"{name}: solution error {err:g}")
    else:
        if not s.history[-1] < s.history[0] / 5:
            raise AssertionError(f"{name}: the solve did not converge")
        # the rate on A x = 0 from a random x0, free of the f32 floor;
        # every cycle must cut the residual >= 4x (7-point V(1,1) cuts
        # ~7x, 27-point ~20x at 64^3 on the CPU)
        g = torch.Generator(device=DEV).manual_seed(13)
        x0 = torch.randn((n, n, n), generator=g, device=DEV,
                         dtype=torch.float32)
        xr = s.solve(torch.zeros_like(b), x0)
        h = [1.0] + s.history
        print(f"  {name}: A x = 0 from random x0: "
              f"{' '.join(f'{v:.6g}' for v in h[1:])}", flush=True)
        check_graph(s, torch.zeros_like(b), xr, f"{name}, A x = 0", cycle3,
                    x0=x0)
        del x0, xr
        if len(h) < 5 or any(h[i + 1] > h[i] / 4 for i in range(4)):
            raise AssertionError(f"{name}: a cycle cut the residual < 4x")
    ms = time_cycles(s, b, x, cycle=cycle3)
    print(f"  {name}: DOF/s {n ** 3 / (ms * 1e-3):.4e}; "
          f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
          flush=True)
    return launches


def counts3() -> dict:
    """Kernel launches of one solve-loop cycle of the 3D paths, derived
    from the plans.  A fused level runs K15 and K16 once each and K14 for
    each further sweep (the last post-sweep of the top level with the
    norm), each call as ``cuda_fused3.launch_list`` gives it: 7-point one
    ring launch; 27-point the sweep on K6's route (``cuda3.plan``:
    resident, a launch a colour and the residual, or K14's marches) and an
    edge launch for K15's restriction, K16's interpolation and the top
    level's norm.  A dense level runs its pre-sweeps DOWN, the last with
    the residual that feeds K7, then K8, then its post-sweeps UP (the dense
    top level's last with the convergence residual), each as
    ``cuda3.launch_list`` gives it."""
    m = cuda_fused3._stages_of(cuda_build.load("fused3"))
    smem = cuda3._build_of(cuda_build.load("sweep3"))
    none, norm = cuda_fused3._NONE, cuda_fused3._NORM

    def cycle(levels, fused, pre=1, post=1):
        """The launches of a cycle over ``levels`` ((n, 27-point), from
        the top, the coarse solve's level left out), the first ``fused``
        of them fused, V(pre, post)."""
        c = {}

        def add(launches):
            for k, _ in launches:
                c[k] = c.get(k, 0) + 1

        for k, (n, t) in enumerate(levels):
            kind, shape = (TwentySevenPt if t else SevenPt), (n,) * 3
            if k < fused:
                def call(updown, role, mode=none):
                    add(cuda_fused3.launch_list(4, kind, shape, updown, role,
                                                mode, m, smem))
                for _ in range(pre - 1):
                    call("down", "sweep")
                call("down", "restrict")
                call("up", "interp", norm if k == 0 and post == 1 else none)
                for j in range(post - 1):
                    call("up", "sweep",
                         norm if k == 0 and j == post - 2 else none)
                continue
            p = cuda3.plan(4, t, shape, smem)
            for j in range(pre):
                add(cuda3.launch_list(p, kind, "down", j == pre - 1, m))
            for j in range(post):
                add(cuda3.launch_list(p, kind, "up",
                                      k == 0 and j == post - 1, m))
        c["restrict3"] = c["interp_add3"] = len(levels) - fused
        return c

    # 256^3 7-point, 7 levels (the coarsest 4^3 solved); 128^3 27-point,
    # 6 levels; fused on the top SPLIT_LEVELS
    l256 = [(256, False)] + [(n, True) for n in (128, 64, 32, 16, 8)]
    l128 = [(n, True) for n in (128, 64, 32, 16, 8)]
    return {
        "3d_poisson_7pt_256": cycle(l256, SPLIT_LEVELS),
        "3d_poisson_7pt_256 V(2,2)": cycle(l256, SPLIT_LEVELS, 2, 2),
        "3d_poisson_7pt_256 dense": cycle(l256, 0),
        "3d_fe_27pt_128": cycle(l128, SPLIT_LEVELS),
        "3d_fe_27pt_128 dense": cycle(l128, 0),
    }


DENSE3 = ("sweep3_resident", "restrict3", "interp_add3")


def phase_paths3() -> dict:
    """The 3D slice at full width (bench.py:162-171, :186-195): each
    V-cycle configuration fused (``kernels.fine-split: true``) and dense,
    the fused 256³ V(2,2) and the fused F-cycle, each cycle's launches
    checked against :func:`counts3`."""
    fused, dense = {"fine-split": True}, {"fine-split": False}
    want = counts3()
    # no 27-point level launches the 7-point K15 or K16: a 27-point fused
    # level's K15 and K16 are K6's sweep and an edge launch each
    if (want["3d_fe_27pt_128"].get("sweep_restrict3", 0)
            or want["3d_fe_27pt_128"].get("interp_sweep3", 0)
            or want["3d_poisson_7pt_256"]["sweep_restrict3"] != 1
            or want["3d_fe_27pt_128"]["edge27"] != 2 * SPLIT_LEVELS + 1
            or want["3d_poisson_7pt_256"]["edge27"]
            != 2 * (SPLIT_LEVELS - 1)):
        raise AssertionError(f"3D launches a cycle: {want}")
    print(f"  3D launches a cycle: {want}", flush=True)

    def need(cell):
        return tuple(k for k, v in want[cell].items() if v)

    v7 = run_path3("3d_poisson_7pt_256", N_3D, gallery.poisson3, SevenPt,
                   {}, need("3d_poisson_7pt_256"), fused,
                   want["3d_poisson_7pt_256"])
    torch.cuda.empty_cache()
    d7 = run_path3("3d_poisson_7pt_256 dense", N_3D, gallery.poisson3,
                   SevenPt, {}, need("3d_poisson_7pt_256 dense"), dense,
                   want["3d_poisson_7pt_256 dense"])
    torch.cuda.empty_cache()
    v22 = run_path3("3d_poisson_7pt_256 V(2,2)", N_3D, gallery.poisson3,
                    SevenPt, {"cycle": {"nrelax-pre": 2, "nrelax-post": 2}},
                    need("3d_poisson_7pt_256 V(2,2)"), fused,
                    want["3d_poisson_7pt_256 V(2,2)"])
    torch.cuda.empty_cache()
    run_path3("3d_fe_27pt_128", N_27, gallery.fe3, TwentySevenPt, {},
              need("3d_fe_27pt_128"), fused, want["3d_fe_27pt_128"])
    torch.cuda.empty_cache()
    run_path3("3d_fe_27pt_128 dense", N_27, gallery.fe3, TwentySevenPt, {},
              need("3d_fe_27pt_128 dense"), dense,
              want["3d_fe_27pt_128 dense"])
    torch.cuda.empty_cache()
    f7 = run_path3("3d_poisson_fcycle_256", N_3D, gallery.poisson3, SevenPt,
                   {"cycle": {"type": "f"}},
                   ("restrict3", "interp3") + DENSE3 + FUSED3, fused)
    torch.cuda.empty_cache()
    # K6's per-colour launches run on the dense cycle (its 64³ and 32³
    # levels, the 128³ level's residual)
    return {k: v7[k] for k in DENSE3 + FUSED3 + ("edge27",)} | {
        "sweep3_fused": v22["sweep3_fused"], "interp3": f7["interp3"],
        "sweep3": d7["sweep3"]}


def phase_planes_128() -> dict:
    """``3d_aniso_planexy_128`` (bench.py:173-184) on the port: 7-point
    plane-xy V(1,1) with the default plane-config (one embedded V(2,1)
    line-xy cycle a colour)."""
    name, n = "3d_aniso_planexy_128", N_PLANES
    print(f"[5d] {name}: diag_diffusion3(1, 1, 1e-3) {n}^3 float32, "
          "plane-xy V(1,1)", flush=True)
    conf = Config({"log": [], "solver": {
        "relaxation": "plane-xy", "cycle": {"nrelax-pre": 1,
                                            "nrelax-post": 1},
        "max-iter": 4, "tol": 1e-6}})
    so = aniso3(n, n, n, torch.float32, DEV)
    b = gallery.poisson3_rhs(n, n, n, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = Solver3(so, SevenPt, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    del so
    print(f"  {name}: levels {s.nlevels}: {s.shapes[0]} .. {s.shapes[-1]}; "
          f"setup {setup_s:.3f} s", flush=True)
    print(f"  {name}: history {' '.join(f'{h:.9g}' for h in s.history)}",
          flush=True)
    print(f"  {name}: counts {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != (n, n, n):
        raise AssertionError(f"{name}: bad solution")
    # one cycle is near-direct here (>= 60x in float64 at 16^3); later
    # cycles may sit on the float32 floor of |b - A x| / |b|
    if not s.history[0] < 0.2 or not s.history[-1] <= s.history[0]:
        raise AssertionError(f"{name}: the solve did not converge")
    require_launched(launches, PLANE_KERNELS, name)
    check_graph(s, b, x, name, cycle3)
    # K10 once a call: on every outer level but the coarsest, a pre- and a
    # post-relaxation, each one embedded V-cycle a plane colour, whose
    # levels but the coarsest smooth in two calls (pre-smooths with the
    # residual, post-smooths)
    one_cycle_launches(s, b, name, {"line_xy2": sum(
        2 * 2 * (len(h) - 1) for lev in s.levels[:-1]
        for h in lev.planes["xy"] if h is not None)}, cycle=cycle3)

    # the rate on A x = 0 from a random x0: every cycle cuts >= 4x until
    # the residual reaches the float32 floor (1e-5 relative)
    g = torch.Generator(device=DEV).manual_seed(14)
    x0 = torch.randn((n, n, n), generator=g, device=DEV, dtype=torch.float32)
    zero = torch.zeros_like(b)
    r0 = float(stencil3.residual(s.levels[0].so, x0, zero, SevenPt).norm())
    h = [1.0]
    for _ in range(4):
        x0 = cycle3.run_cycle(s.levels, s.kinds, x0, zero, s.settings)
        h.append(float(stencil3.residual(s.levels[0].so, x0, zero,
                                         SevenPt).norm()) / r0)
    print(f"  {name}: A x = 0 from random x0: "
          f"{' '.join(f'{v:.6g}' for v in h[1:])}", flush=True)
    del x0
    if any(h[i] > 1e-5 and not h[i + 1] <= h[i] / 4 for i in range(4)):
        raise AssertionError(f"{name}: a cycle cut the residual < 4x")
    ms = time_cycles(s, b, x, cycle=cycle3)
    print(f"  {name}: DOF/s {n ** 3 / (ms * 1e-3):.4e}; "
          f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
          flush=True)
    return launches


def time_ms(fn, reps=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def print_transfer_device_ms(cases: dict, work: dict, keys) -> None:
    """K2's and K3's device ms of ``keys`` with the L2 flushed before each
    call (a 256 MB write, not counted) beside their bounds."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEV)
    for k in keys:
        dms = device_ms(cases[k][1], between=flush.zero_,
                        only=("restrict_kernel", "interp_add_kernel"))
        bms, by = bound(*work[k], torch.float32)
        print(f"  {k}: device {dms:.4f} ms (L2 flushed), bound {bms:.4f} "
              f"ms by {by}", flush=True)


def phase_times() -> dict:
    """Kernel against plain at the main paths' shapes (4096² f32; the line
    sweeps at 2048² 9-point f32), in turns (plain, kernel, kernel, plain)."""
    print("[6] per-kernel ms at 4096^2 float32, line sweeps at 2048^2 "
          "9-pt, K1 resident at 64^2 9-pt (plain, kernel, kernel, plain)",
          flush=True)
    n, n9 = N_MAIN, N_MAIN // 2 + 1
    so, q, b, kind = random_problem((n, n), False, torch.float32, 7)
    so9, q9, b9, kind9 = random_problem((n9, n9), True, torch.float32, 8)
    # K1's resident regime at a dense level of the main path (64² 9-point)
    r = N_MAIN >> 6
    sr, qr, br, kr = random_problem((r, r), True, torch.float32, 12)
    # K13 on the main path's first 9-point level (2048²)
    m9 = N_MAIN // 2
    sk, qk, bk, kk = random_problem((m9, m9), True, torch.float32, 11)
    cik = interp2.setup_interp(sk, kk)
    ck = torch.randn((cik.shape[1] - 1, cik.shape[2] - 1), device=DEV,
                     dtype=torch.float32)
    ci = interp2.setup_interp(so, kind)
    g = torch.Generator(device=DEV).manual_seed(9)
    qc = torch.randn((ci.shape[1] - 1, ci.shape[2] - 1), generator=g,
                     device=DEV, dtype=torch.float32)
    cases = {
        "sweep2": (lambda: cuda2.sweep_plain(so, q, b, kind, "down"),
                   lambda: cuda2.sweep(so, q, b, kind, "down")),
        "sweep2 +res": (
            lambda: cuda2.sweep_plain(so, q, b, kind, "down", True),
            lambda: cuda2.sweep(so, q, b, kind, "down", True)),
        "sweep2 9pt 2049^2": (
            lambda: cuda2.sweep_plain(so9, q9, b9, kind9, "down"),
            lambda: cuda2.sweep(so9, q9, b9, kind9, "down")),
        # as the cycle runs it there: the pre-sweep with its residual
        "sweep2_resident": (
            lambda: cuda2.sweep_plain(sr, qr, br, kr, "down", True),
            lambda: cuda2.sweep(sr, qr, br, kr, "down", True)),
        "restrict2": (lambda: cuda_transfer2.restrict_plain(ci, b),
                      lambda: cuda_transfer2.restrict(ci, b)),
        "interp_add2": (
            lambda: cuda_transfer2.interp_add_plain(ci, so, qc, b, q),
            lambda: cuda_transfer2.interp_add(ci, so, qc, b, q)),
        "interp2": (
            lambda: cuda_transfer2.interp_plain(ci, qc, (n, n)),
            lambda: cuda_transfer2.interp(ci, qc, (n, n))),
        # the fused kernels as the cycle runs them: K11 for extra sweeps
        # (+ the norm for the last), K12 without the residual, K13 on the
        # levels below the top (+ the norm on the top one)
        "sweep2_fused": (
            lambda: cuda_fused2.sweep_plain(so, q, b, kind, "down"),
            lambda: cuda_fused2.sweep(so, q, b, kind, "down")),
        "sweep2_fused +norm": (
            lambda: cuda_fused2.sweep_plain(so, q, b, kind, "up",
                                            fuse_norm=True),
            lambda: cuda_fused2.sweep(so, q, b, kind, "up", fuse_norm=True)),
        "sweep_restrict2": (
            lambda: cuda_fused2.sweep_restrict_plain(so, q, b, ci, kind,
                                                     "down", False),
            lambda: cuda_fused2.sweep_restrict(so, q, b, ci, kind, "down",
                                               False)),
        "interp_sweep2": (
            lambda: cuda_fused2.interp_sweep_plain(ci, qc, so, b, q, kind,
                                                   "up"),
            lambda: cuda_fused2.interp_sweep(ci, qc, so, b, q, kind, "up")),
        "interp_sweep2 +norm": (
            lambda: cuda_fused2.interp_sweep_plain(ci, qc, so, b, q, kind,
                                                   "up", fuse_norm=True),
            lambda: cuda_fused2.interp_sweep(ci, qc, so, b, q, kind, "up",
                                             fuse_norm=True)),
        "interp_sweep2 9pt 2048^2": (
            lambda: cuda_fused2.interp_sweep_plain(cik, ck, sk, bk, qk, kk,
                                                   "up"),
            lambda: cuda_fused2.interp_sweep(cik, ck, sk, bk, qk, kk, "up")),
    }
    sl, ql, bl, kl = random_problem((N_LINES, N_LINES), True, torch.float32,
                                    10)
    lines = {
        "line2 x": (lambda: cuda_lines2.line_x_plain(sl, ql, bl, kl, "down"),
                    lambda: cuda_lines2.line_x(sl, ql, bl, kl, "down")),
        "line2 y": (lambda: cuda_lines2.line_y_plain(sl, ql, bl, kl, "down"),
                    lambda: cuda_lines2.line_y(sl, ql, bl, kl, "down")),
    }
    out = time_turns({**cases, **lines}, slow=lines)
    # one entry per kernel: the line kernel's is the mean of its x and y
    # zebra sweeps
    out["line2"] = tuple((a + c) / 2 for a, c in zip(out["line2 x"],
                                                     out["line2 y"]))
    # K12 and K13 against the dense launches they replace (the dense ones
    # update q in place, so it drifts: the timing does not depend on it)
    print("[6] fused kernels against the dense sequences they replace "
          "(dense, fused, fused, dense)", flush=True)
    time_turns({
        "K1 +res, K2 -> K12": (
            lambda: cuda_transfer2.restrict(
                ci, cuda2.sweep(so, q, b, kind, "down", True)[1]),
            lambda: cuda_fused2.sweep_restrict(so, q, b, ci, kind, "down",
                                               False)),
        "K3, K1 -> K13": (
            lambda: cuda2.sweep(so, cuda_transfer2.interp_add(
                ci, so, qc, b, q), b, kind, "up"),
            lambda: cuda_fused2.interp_sweep(ci, qc, so, b, q, kind, "up")),
        "K3, K1 -> K13 9pt 2048^2": (
            lambda: cuda2.sweep(sk, cuda_transfer2.interp_add(
                cik, sk, ck, bk, qk), bk, kk, "up"),
            lambda: cuda_fused2.interp_sweep(cik, ck, sk, bk, qk, kk, "up")),
    }, labels=("dense", "fused"))
    # the bytes each function must move (inputs read once, outputs written
    # once; interp-add reads only the diagonal plane of so) and its
    # floating-point operations, at the timed shapes, float32
    nc, m, e = ci.shape[1] - 1, N_LINES, 4
    mc = cik.shape[1] - 1
    work = {
        "sweep2": ((3 + 3) * n * n * e, 10 * n * n),
        # 9-point: 5 stencil planes, b and q read, q and the residual
        # written; 18 operations a point for the sweep, 18 the residual
        "sweep2_resident": ((5 + 3 + 1) * r * r * e, 36 * r * r),
        "restrict2": ((8 * (nc + 1) ** 2 + n * n + nc * nc) * e,
                      16 * nc * nc),
        "interp_add2": ((8 * (nc + 1) ** 2 + nc * nc + 4 * n * n) * e,
                        23 * n * n // 4),
        "interp2": ((8 * (nc + 1) ** 2 + nc * nc + n * n) * e,
                    13 * n * n // 4),
        # 9-point zebra sweep: 12 operations a point for the rhs, then 12 a
        # PCR step (log2 h of them) and 8 for the interleaved Thomas
        "line2": ((5 + 3) * m * m * e,
                  (12 + 12 * pcr_steps(m) + 8) * m * m),
        # the fused kernels: so (3 planes), b, q read and q written, as K1;
        # K12 adds the CI planes and writes cb, K13 reads them and qc; a
        # residual is 10 operations a point, as a 5-point sweep
        "sweep2_fused": ((3 + 3) * n * n * e, 10 * n * n),
        "sweep_restrict2": ((8 * (nc + 1) ** 2 + 6 * n * n + nc * nc) * e,
                            20 * n * n + 16 * nc * nc),
        "interp_sweep2": ((8 * (nc + 1) ** 2 + nc * nc + 6 * n * n) * e,
                          20 * n * n + 23 * n * n // 4),
        # 9-point: five stencil planes; a residual 18 operations a point
        "interp_sweep2 9pt 2048^2": (
            (8 * (mc + 1) ** 2 + mc * mc + 8 * m9 * m9) * e,
            36 * m9 * m9 + 23 * m9 * m9 // 4),
    }
    for k in ("interp_sweep2", "interp_sweep2 9pt 2048^2"):
        bms, by = bound(*work[k], torch.float32)
        print(f"  {k}: bound {bms:.4f} ms by {by}; kernel {out[k][0]:.4f} "
              "ms", flush=True)
    print_transfer_device_ms(cases, work, ("restrict2", "interp_add2"))
    return {k: v + work[k] for k, v in out.items() if k in work}


def phase_times_levels() -> None:
    """K1 at each dense level of the main path (256² .. 8² 9-point float32:
    the pre-sweep with its residual, the post-sweep) and K12 at each fused
    level (4096² 5-point, 2048² .. 512² 9-point, no residual out), kernel
    against plain in turns, each with its bound; every K1 call one
    launch."""
    print("[6] K1 at the main path's dense levels, K12 at its fused levels "
          "(plain, kernel, kernel, plain)", flush=True)
    e = 4
    cases, work = {}, {}
    for k, n in enumerate(N_MAIN >> s for s in range(SPLIT_LEVELS + 5,
                                                     SPLIT_LEVELS - 1, -1)):
        so, q, b, kind = random_problem((n, n), True, torch.float32, 40 + k)
        tag = f"{n}^2"
        # a 9-point sweep: 5 stencil planes, b and q read, q written; 18
        # operations a point, and the residual (written) 18 more
        cases[f"K1 9pt {tag} down +res"] = (
            lambda a=(so, q, b, kind): cuda2.sweep_plain(*a, "down", True),
            lambda a=(so, q, b, kind): cuda2.sweep(*a, "down", True))
        work[f"K1 9pt {tag} down +res"] = ((5 + 3 + 1) * n * n * e,
                                           36 * n * n)
        cases[f"K1 9pt {tag} up"] = (
            lambda a=(so, q, b, kind): cuda2.sweep_plain(*a, "up"),
            lambda a=(so, q, b, kind): cuda2.sweep(*a, "up"))
        work[f"K1 9pt {tag} up"] = ((5 + 3) * n * n * e, 18 * n * n)
    for k, n in enumerate(N_MAIN >> s for s in range(SPLIT_LEVELS)):
        nine = k > 0
        so, q, b, kind = random_problem((n, n), nine, torch.float32, 50 + k)
        ci = interp2.setup_interp(so, kind)
        nc, nd = ci.shape[1] - 1, kind.ndirs
        name = f"K12 {'9pt' if nine else '5pt'} {n}^2"
        cases[name] = (
            lambda a=(so, q, b, ci, kind): cuda_fused2.sweep_restrict_plain(
                *a, "down", False),
            lambda a=(so, q, b, ci, kind): cuda_fused2.sweep_restrict(
                *a, "down", False))
        # the stencil, b and q read, q written, CI read and cb written; a
        # sweep and its residual (20 or 36 operations a point), 16 a coarse
        # point
        work[name] = ((8 * (nc + 1) ** 2 + (nd + 3) * n * n + nc * nc) * e,
                      (36 if nine else 20) * n * n + 16 * nc * nc)
    out = time_turns(cases)
    k12 = [0.0, 0.0]
    for name, (ms, plain_ms) in out.items():
        bms, by = bound(*work[name], torch.float32)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bms:.6f} ms by {by}", flush=True)
        if name.startswith("K12"):
            k12 = [k12[0] + ms, k12[1] + bms]
    print(f"  K12, the four fused levels: {k12[0]:.4f} ms a cycle, bound "
          f"{k12[1]:.6f} ms", flush=True)


def time_turns(cases: dict, slow=(), labels=("plain", "kernel")) -> dict:
    """Each case timed in turns (plain, kernel, kernel, plain); returns
    name -> (kernel ms, plain ms), the means of the two runs of each.
    ``labels`` name the two in the printout."""
    out = {}
    for name, (plain, kernel) in cases.items():
        # the plain line sweep is a Python loop along the line: few reps
        pr, pw = (2, 1) if name in slow else (20, 3)
        p1, k1, k2, p2 = (time_ms(plain, pr, pw), time_ms(kernel),
                          time_ms(kernel), time_ms(plain, pr, pw))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        lp, lk = labels
        print(f"  {name}: {lp} {p1:.4f} {lk} {k1:.4f} {lk} {k2:.4f} "
              f"{lp} {p2:.4f}", flush=True)
    return out


def phase_times3() -> dict:
    """K6-K9 and K14-K16 against plain at the 3D paths' shapes (256³
    7-point float32; the 27-point sweeps at 128³), in turns (plain,
    kernel, kernel, plain); K15 and K16 against the dense sequences they
    replace."""
    print("[6] per-kernel ms at 256^3 7-pt float32, 27-pt sweeps at 128^3, "
          "K6 at 16^3 (resident) and 64^3 (a launch a colour) 27-pt (plain, "
          "kernel, kernel, plain)", flush=True)
    n, n27 = N_3D, N_27
    so, q, b, kind = random_problem3((n,) * 3, False, torch.float32, 17)
    so27, q27, b27, kind27 = random_problem3((n27,) * 3, True,
                                             torch.float32, 18)
    ci = interp3.setup_interp(so, kind)
    nc = ci.shape[1] - 1
    g = torch.Generator(device=DEV).manual_seed(19)
    qc = torch.randn((nc,) * 3, generator=g, device=DEV, dtype=torch.float32)
    ci27 = interp3.setup_interp(so27, kind27)
    nc27 = ci27.shape[1] - 1
    qc27 = torch.randn((nc27,) * 3, generator=g, device=DEV,
                       dtype=torch.float32)
    # K6 at dense levels of the 3D paths (27-point): resident at 16³, one
    # launch a colour phase (and the residual) at 64³
    r, r6 = N_3D >> 4, N_3D >> 2
    sr, qr, br, kr = random_problem3((r,) * 3, True, torch.float32, 20)
    s6, q6, b6, k6 = random_problem3((r6,) * 3, True, torch.float32, 21)
    cases = {
        "sweep3_resident": (
            lambda: cuda3.sweep_plain(sr, qr, br, kr, "down", True),
            lambda: cuda3.sweep(sr, qr, br, kr, "down", True)),
        "sweep3": (
            lambda: cuda3.sweep_plain(s6, q6, b6, k6, "down", True),
            lambda: cuda3.sweep(s6, q6, b6, k6, "down", True)),
        # K6 at 256³ 7-point and 128³ 27-point: K14's launches
        "K6 256^3 (ring)": (
            lambda: cuda3.sweep_plain(so, q, b, kind, "down"),
            lambda: cuda3.sweep(so, q, b, kind, "down")),
        "K6 256^3 +res (ring)": (
            lambda: cuda3.sweep_plain(so, q, b, kind, "down", True),
            lambda: cuda3.sweep(so, q, b, kind, "down", True)),
        "K6 27pt 128^3 (pass27)": (
            lambda: cuda3.sweep_plain(so27, q27, b27, kind27, "down"),
            lambda: cuda3.sweep(so27, q27, b27, kind27, "down")),
        "K6 27pt 128^3 +res (pass27)": (
            lambda: cuda3.sweep_plain(so27, q27, b27, kind27, "down", True),
            lambda: cuda3.sweep(so27, q27, b27, kind27, "down", True)),
        "restrict3": (lambda: cuda_transfer3.restrict_plain(ci, b),
                      lambda: cuda_transfer3.restrict(ci, b)),
        "interp_add3": (
            lambda: cuda_transfer3.interp_add_plain(ci, so, qc, b, q),
            lambda: cuda_transfer3.interp_add(ci, so, qc, b, q)),
        "interp3": (
            lambda: cuda_transfer3.interp_plain(ci, qc, (n,) * 3),
            lambda: cuda_transfer3.interp(ci, qc, (n,) * 3)),
        # the fused kernels as the cycle runs them: K14 for extra sweeps
        # (+ the norm for the last), K15 without the residual, K16 (+ the
        # norm on the top level); 27-point: K14 a march of colours a launch
        "sweep3_fused": (
            lambda: cuda_fused3.sweep_plain(so, q, b, kind, "down"),
            lambda: cuda_fused3.sweep(so, q, b, kind, "down")),
        "sweep3_fused +norm": (
            lambda: cuda_fused3.sweep_plain(so, q, b, kind, "up",
                                            fuse_norm=True),
            lambda: cuda_fused3.sweep(so, q, b, kind, "up", fuse_norm=True)),
        "sweep3_fused 27pt 128^3": (
            lambda: cuda_fused3.sweep_plain(so27, q27, b27, kind27, "down"),
            lambda: cuda_fused3.sweep(so27, q27, b27, kind27, "down")),
        "sweep_restrict3": (
            lambda: cuda_fused3.sweep_restrict_plain(so, q, b, ci, kind,
                                                     "down", False),
            lambda: cuda_fused3.sweep_restrict(so, q, b, ci, kind, "down",
                                               False)),
        "sweep_restrict3 27pt 128^3": (
            lambda: cuda_fused3.sweep_restrict_plain(so27, q27, b27, ci27,
                                                     kind27, "down", False),
            lambda: cuda_fused3.sweep_restrict(so27, q27, b27, ci27, kind27,
                                               "down", False)),
        "interp_sweep3": (
            lambda: cuda_fused3.interp_sweep_plain(ci, qc, so, b, q, kind,
                                                   "up"),
            lambda: cuda_fused3.interp_sweep(ci, qc, so, b, q, kind, "up")),
        "interp_sweep3 +norm": (
            lambda: cuda_fused3.interp_sweep_plain(ci, qc, so, b, q, kind,
                                                   "up", fuse_norm=True),
            lambda: cuda_fused3.interp_sweep(ci, qc, so, b, q, kind, "up",
                                             fuse_norm=True)),
        "interp_sweep3 27pt 128^3": (
            lambda: cuda_fused3.interp_sweep_plain(ci27, qc27, so27, b27,
                                                   q27, kind27, "up"),
            lambda: cuda_fused3.interp_sweep(ci27, qc27, so27, b27, q27,
                                             kind27, "up")),
        # the edge kernel as the 27-point K15 runs it (the residual and
        # its restriction, no residual out), and in its other modes
        "edge27": (
            lambda: cuda_fused3.edge_plain(so27, q27, b27, "restrict",
                                           ci27),
            lambda: cuda_fused3.edge(so27, q27, b27, "restrict", ci27)),
        "edge27 interp": (
            lambda: cuda_fused3.edge_plain(so27, q27, b27, "interp", ci27,
                                           qc27),
            lambda: cuda_fused3.edge(so27, q27, b27, "interp", ci27, qc27)),
        "edge27 res": (
            lambda: cuda_fused3.edge_plain(so27, q27, b27, "res"),
            lambda: cuda_fused3.edge(so27, q27, b27, "res")),
        "edge27 norm": (
            lambda: cuda_fused3.edge_plain(so27, q27, b27, "norm"),
            lambda: cuda_fused3.edge(so27, q27, b27, "norm")),
    }
    out = time_turns(cases)
    # K15 and K16 against the dense launches they replace (K8's interp-add
    # updates qd in place, so it drifts: the timing does not depend on it)
    print("[6] fused 3D kernels against the dense sequences they replace "
          "(dense, fused, fused, dense)", flush=True)
    qd, qd27 = q.clone(), q27.clone()
    time_turns({
        "K6 +res, K7 -> K15": (
            lambda: cuda_transfer3.restrict(
                ci, cuda3.sweep(so, qd, b, kind, "down", True)[1]),
            lambda: cuda_fused3.sweep_restrict(so, q, b, ci, kind, "down",
                                               False)),
        "K8, K6 -> K16": (
            lambda: cuda3.sweep(so, cuda_transfer3.interp_add(
                ci, so, qc, b, qd), b, kind, "up"),
            lambda: cuda_fused3.interp_sweep(ci, qc, so, b, q, kind, "up")),
        # with the convergence norm: the dense top level's residual sweep
        # and the norm's reduction
        "K8, K6 +res, norm -> K16 +norm": (
            lambda: torch.linalg.vector_norm(cuda3.sweep(
                so, cuda_transfer3.interp_add(ci, so, qc, b, qd), b, kind,
                "up", True)[1]),
            lambda: cuda_fused3.interp_sweep(ci, qc, so, b, q, kind, "up",
                                             fuse_norm=True)),
        "K6 +res, K7 -> K15 27pt 128^3": (
            lambda: cuda_transfer3.restrict(
                ci27, cuda3.sweep(so27, qd27, b27, kind27, "down", True)[1]),
            lambda: cuda_fused3.sweep_restrict(so27, q27, b27, ci27, kind27,
                                               "down", False)),
        "K8, K6 -> K16 27pt 128^3": (
            lambda: cuda3.sweep(so27, cuda_transfer3.interp_add(
                ci27, so27, qc27, b27, qd27), b27, kind27, "up"),
            lambda: cuda_fused3.interp_sweep(ci27, qc27, so27, b27, q27,
                                             kind27, "up")),
    }, labels=("dense", "fused"))
    # bytes and operations as in phase_times: per fine point, interp-add
    # does 67/8 operations on average over the 8 parity classes (1 at
    # coincident points, 6 / 10 / 18 at edge / face / cell points), interp
    # 52/8; a 7-point sweep 14, a 27-point one 54
    N, Nc, W, e = n ** 3, nc ** 3, 26 * (nc + 1) ** 3, 4
    N27, Nc27, W27 = n27 ** 3, nc27 ** 3, 26 * (nc27 + 1) ** 3
    work = {
        # the sweep and its residual: the stencil, q and b read, q and res
        # written
        "sweep3_resident": ((14 + 4) * r ** 3 * e, 108 * r ** 3),
        "sweep3": ((14 + 4) * r6 ** 3 * e, 108 * r6 ** 3),
        "K6 256^3 (ring)": ((4 + 3) * N * e, 14 * N),
        "K6 256^3 +res (ring)": ((4 + 4) * N * e, 28 * N),
        "K6 27pt 128^3 (pass27)": ((14 + 3) * N27 * e, 54 * N27),
        "K6 27pt 128^3 +res (pass27)": ((14 + 4) * N27 * e, 108 * N27),
        "restrict3": ((W + N + Nc) * e, 52 * Nc),
        "interp_add3": ((W + Nc + 4 * N) * e, 67 * N // 8),
        "interp3": ((W + Nc + N) * e, 52 * N // 8),
        # the fused kernels: so, b, q read and q written, as K6; K15 adds
        # the CI planes and writes cb, K16 reads them and qc; a residual
        # costs what a sweep does, the norm one more read-free pass
        "sweep3_fused": ((4 + 3) * N * e, 14 * N),
        "sweep3_fused +norm": ((4 + 3) * N * e, 28 * N),
        "sweep3_fused 27pt 128^3": ((14 + 3) * N27 * e, 54 * N27),
        "sweep_restrict3": ((W + 7 * N + Nc) * e, 28 * N + 52 * Nc),
        "sweep_restrict3 27pt 128^3": ((W27 + 17 * N27 + Nc27) * e,
                                       108 * N27 + 52 * Nc27),
        "interp_sweep3": ((W + Nc + 7 * N) * e, 28 * N + 67 * N // 8),
        "interp_sweep3 +norm": ((W + Nc + 7 * N) * e,
                                42 * N + 67 * N // 8),
        "interp_sweep3 27pt 128^3": ((W27 + Nc27 + 17 * N27) * e,
                                     108 * N27 + 67 * N27 // 8),
        # the edge kernel: the 14 stencil planes, q and b read; restrict:
        # the CI planes read and cb written; interp: CI and qc read and q
        # written; res: res written; norm: no grid written
        "edge27": ((W27 + 16 * N27 + Nc27) * e, 54 * N27 + 52 * Nc27),
        "edge27 interp": ((W27 + Nc27 + 17 * N27) * e,
                          54 * N27 + 67 * N27 // 8),
        "edge27 res": (17 * N27 * e, 54 * N27),
        "edge27 norm": (16 * N27 * e, 56 * N27),
    }
    for k, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, torch.float32)
        print(f"  {k}: bound {bms:.4f} ms by {by} ({nbytes / 1e9:.4f} GB, "
              f"{flops / 1e9:.4f} GFLOP); kernel {out[k][0]:.4f} ms",
              flush=True)
    return {k: v + work[k] for k, v in out.items() if k in work}


def phase_times_planes() -> dict:
    """K10 (2 sweeps + the residual: the embedded pre-smooth) and the
    batched K2/K3 against plain on a (64, 128, 128) float32 batch, in turns
    (plain, kernel, kernel, plain)."""
    shape = (64, N_PLANES, N_PLANES)
    print(f"[6] per-kernel ms on a {shape} float32 batch of planes "
          "(plain, kernel, kernel, plain)", flush=True)
    nb, n = shape[0], shape[1]
    cases, work = {}, {}
    for nine in (False, True):
        so, q, b, kind = random_problem(shape, nine, torch.float32,
                                        20 + nine)
        pts = "9pt" if nine else "5pt"
        cases[f"line_xy2 {pts} x2 +res"] = (
            lambda so=so, q=q, b=b, kind=kind: cuda_planes2.smooth_plain(
                so, q, b, kind, "down", 2, True),
            lambda so=so, q=q, b=b, kind=kind: cuda_planes2.smooth(
                so, q, b, kind, "down", 2, True))
        # bytes: the stencil planes, b and q read, q and res written;
        # operations a point: per smooth two line passes of the rhs (4 or
        # 12), 12 a PCR step and 8 for the interleaved Thomas, then the
        # residual (10 or 18)
        N = nb * n * n
        ndir, rhs_ops, res_ops = (5, 12, 18) if nine else (3, 4, 10)
        work[f"line_xy2 {pts} x2 +res"] = (
            (ndir + 4) * N * 4,
            (2 * 2 * (rhs_ops + 12 * pcr_steps(n) + 8) + res_ops) * N)
        if not nine:
            ci = interp2.setup_interp(so, kind)
            g = torch.Generator(device=DEV).manual_seed(22)
            nc = ci.shape[2] - 1
            qc = torch.randn((nb, nc, nc), generator=g, device=DEV,
                             dtype=torch.float32)
            args = (ci, so, qc, b, q)
            cases["restrict2 batched"] = (
                lambda: cuda_transfer2.restrict_plain(args[0], args[3]),
                lambda: cuda_transfer2.restrict(args[0], args[3]))
            cases["interp_add2 batched"] = (
                lambda: cuda_transfer2.interp_add_plain(*args),
                lambda: cuda_transfer2.interp_add(*args))
            W, Nc = 8 * nb * (nc + 1) ** 2, nb * nc * nc
            work["restrict2 batched"] = ((W + N + Nc) * 4, 16 * Nc)
            work["interp_add2 batched"] = ((W + Nc + 4 * N) * 4,
                                           23 * N // 4)
    out = time_turns(cases, slow=[k for k in cases if "line_xy2" in k])
    for k, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, torch.float32)
        print(f"  {k}: bound {bms:.4f} ms by {by} ({nbytes / 1e9:.4f} GB, "
              f"{flops / 1e9:.4f} GFLOP); kernel {out[k][0]:.4f} ms",
              flush=True)
    print_transfer_device_ms(cases, work, ("restrict2 batched",
                                           "interp_add2 batched"))
    # the table's K10 entry: the 5-point smooth of the main path's planes
    key = "line_xy2 5pt x2 +res"
    return {"line_xy2": out[key] + work[key]}


def phase_times_periodic() -> dict:
    """The periodic modes against plain, in turns (plain, kernel, kernel,
    plain), at the shapes of phase_times' non-periodic entries (this call
    times those too): K1 streamed at 4096² 5-point (x- and doubly
    periodic, with and without the residual), resident at 64² 9-point
    with the residual, K2, K3 and K5 at 4096², K4 at 2048² 9-point (x-lines
    cyclic, y-lines across the periodic x axis); each with its bound (the
    bytes and operations of the non-periodic entry; a cyclic line solves
    two systems)."""
    print("[6] periodic modes: per-kernel ms at the main paths' shapes "
          "(plain, kernel, kernel, plain)", flush=True)
    n, r, m = N_MAIN, N_MAIN >> 6, N_LINES
    so, q, b, kind = random_periodic_problem((n, n), False, torch.float32,
                                             31, XY)
    sr, qr, br, kr = random_periodic_problem((r, r), True, torch.float32,
                                             32, X)
    sl, ql, bl, kl = random_periodic_problem((m, m), True, torch.float32,
                                             33, X)
    ci = interp2.setup_interp(so, kind, X)
    g = torch.Generator(device=DEV).manual_seed(34)
    qc = torch.randn((ci.shape[1] - 1, ci.shape[2] - 1), generator=g,
                     device=DEV, dtype=torch.float32)
    cases = {
        "sweep2_periodic": (
            lambda: cuda2.sweep_plain(so, q, b, kind, "down", periodic=X),
            lambda: cuda2.sweep(so, q, b, kind, "down", periodic=X)),
        "sweep2 +res periodic x": (
            lambda: cuda2.sweep_plain(so, q, b, kind, "down", True,
                                      periodic=X),
            lambda: cuda2.sweep(so, q, b, kind, "down", True, periodic=X)),
        "sweep2 periodic xy": (
            lambda: cuda2.sweep_plain(so, q, b, kind, "down", periodic=XY),
            lambda: cuda2.sweep(so, q, b, kind, "down", periodic=XY)),
        "sweep2_resident_periodic": (
            lambda: cuda2.sweep_plain(sr, qr, br, kr, "down", True,
                                      periodic=X),
            lambda: cuda2.sweep(sr, qr, br, kr, "down", True, periodic=X)),
        "restrict2_periodic": (
            lambda: cuda_transfer2.restrict_plain(ci, b, X),
            lambda: cuda_transfer2.restrict(ci, b, X)),
        "interp_add2_periodic": (
            lambda: cuda_transfer2.interp_add_plain(ci, so, qc, b, q, X),
            lambda: cuda_transfer2.interp_add(ci, so, qc, b, q, X)),
        "interp2_periodic": (
            lambda: cuda_transfer2.interp_plain(ci, qc, (n, n), X),
            lambda: cuda_transfer2.interp(ci, qc, (n, n), X)),
    }
    lines = {
        "line2 x cyclic": (
            lambda: cuda_lines2.line_x_plain(sl, ql, bl, kl, "down",
                                             periodic=X),
            lambda: cuda_lines2.line_x(sl, ql, bl, kl, "down", periodic=X)),
        "line2 y periodic x": (
            lambda: cuda_lines2.line_y_plain(sl, ql, bl, kl, "down",
                                             periodic=X),
            lambda: cuda_lines2.line_y(sl, ql, bl, kl, "down", periodic=X)),
    }
    out = time_turns({**cases, **lines}, slow=lines)
    out["line2_periodic"] = tuple(
        (a + c) / 2 for a, c in zip(out["line2 x cyclic"],
                                    out["line2 y periodic x"]))
    nc, e, s_ = ci.shape[1] - 1, 4, pcr_steps(m)
    work = {
        "sweep2_periodic": ((3 + 3) * n * n * e, 10 * n * n),
        "sweep2_resident_periodic": ((5 + 3 + 1) * r * r * e, 36 * r * r),
        "restrict2_periodic": ((8 * (nc + 1) ** 2 + n * n + nc * nc) * e,
                               16 * nc * nc),
        "interp_add2_periodic": ((8 * (nc + 1) ** 2 + nc * nc + 4 * n * n)
                                 * e, 23 * n * n // 4),
        "interp2_periodic": ((8 * (nc + 1) ** 2 + nc * nc + n * n) * e,
                             13 * n * n // 4),
        # the mean of the two sweeps: a cyclic x-line solves two systems
        # and combines them (4 operations a point), a y-line one
        "line2_periodic": ((5 + 3) * m * m * e,
                           (12 + (3 * (12 * s_ + 8) + 4) // 2) * m * m),
    }
    for k, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, torch.float32)
        print(f"  {k}: bound {bms:.4f} ms by {by}; kernel {out[k][0]:.4f} "
              f"ms, plain {out[k][1]:.4f} ms", flush=True)
    return {k: v + work[k] for k, v in out.items() if k in work}


def phase_times_periodic3() -> dict:
    """K6-K9's periodic modes against plain, in turns (plain, kernel,
    kernel, plain), at the full-width periodic paths' shapes: K6 per colour
    at 256³ 7-point (x- and triply periodic, DOWN with the residual) and
    128³ 27-point (triply periodic), beside the same per-colour launches
    without the wrap (the non-periodic paths take K14's routes there:
    phase_times3's ``K6 256^3 +res (ring)`` and ``K6 27pt 128^3 +res
    (pass27)``), K6 resident at 16³ 27-point (and at 15³, its Jacobi
    phases), K7, K8 and K9 at 256³ 7-point x-periodic beside the same
    kernels without the wrap; each with its bound (the bytes and
    operations of the non-periodic entry)."""
    print("[6] 3D periodic modes: per-kernel ms at the periodic paths' "
          "shapes (plain, kernel, kernel, plain)", flush=True)
    n, n27, r = N_3D, N_27, N_3D >> 4
    so, q, b, kind = random_periodic_problem3((n,) * 3, False,
                                              torch.float32, 41, X3)
    s27, q27, b27, k27 = random_periodic_problem3((n27,) * 3, True,
                                                  torch.float32, 42, XYZ3)
    sr, qr, br, kr = random_periodic_problem3((r,) * 3, True,
                                              torch.float32, 43, XYZ3)
    so15, q15, b15, k15 = random_periodic_problem3((r - 1,) * 3, True,
                                                   torch.float32, 44, XYZ3)
    ci = interp3.setup_interp(so, kind, X3)
    nc = ci.shape[1] - 1
    g = torch.Generator(device=DEV).manual_seed(45)
    qc = torch.randn((nc,) * 3, generator=g, device=DEV, dtype=torch.float32)
    ph, no = cuda3.Plan("phases"), (False,) * 3
    cases = {
        "sweep3_periodic": (
            lambda: cuda3.sweep_plain(so, q, b, kind, "down", True,
                                      periodic=X3),
            lambda: cuda3.sweep(so, q, b, kind, "down", True, periodic=X3)),
        "K6 256^3 +res phases, no wrap": (
            lambda: cuda3.sweep_plain(so, q, b, kind, "down", True),
            lambda: cuda3._sweep(ph, so, q, b, kind, "down", True)),
        "K6 256^3 +res periodic xyz": (
            lambda: cuda3.sweep_plain(so, q, b, kind, "down", True,
                                      periodic=XYZ3),
            lambda: cuda3.sweep(so, q, b, kind, "down", True,
                                periodic=XYZ3)),
        "K6 27pt 128^3 +res periodic xyz": (
            lambda: cuda3.sweep_plain(s27, q27, b27, k27, "down", True,
                                      periodic=XYZ3),
            lambda: cuda3.sweep(s27, q27, b27, k27, "down", True,
                                periodic=XYZ3)),
        "K6 27pt 128^3 +res phases, no wrap": (
            lambda: cuda3.sweep_plain(s27, q27, b27, k27, "down", True),
            lambda: cuda3._sweep(ph, s27, q27, b27, k27, "down", True, no)),
        "sweep3_resident_periodic": (
            lambda: cuda3.sweep_plain(sr, qr, br, kr, "down", True,
                                      periodic=XYZ3),
            lambda: cuda3.sweep(sr, qr, br, kr, "down", True,
                                periodic=XYZ3)),
        "K6 27pt 16^3 +res resident, no wrap": (
            lambda: cuda3.sweep_plain(sr, qr, br, kr, "down", True),
            lambda: cuda3.sweep(sr, qr, br, kr, "down", True)),
        "K6 27pt 15^3 +res resident periodic xyz (jacobi)": (
            lambda: cuda3.sweep_plain(so15, q15, b15, k15, "down", True,
                                      periodic=XYZ3),
            lambda: cuda3.sweep(so15, q15, b15, k15, "down", True,
                                periodic=XYZ3)),
        "restrict3_periodic": (
            lambda: cuda_transfer3.restrict_plain(ci, b, X3),
            lambda: cuda_transfer3.restrict(ci, b, X3)),
        "restrict3, no wrap": (
            lambda: cuda_transfer3.restrict_plain(ci, b),
            lambda: cuda_transfer3.restrict(ci, b)),
        "interp_add3_periodic": (
            lambda: cuda_transfer3.interp_add_plain(ci, so, qc, b, q, X3),
            lambda: cuda_transfer3.interp_add(ci, so, qc, b, q, X3)),
        "interp_add3, no wrap": (
            lambda: cuda_transfer3.interp_add_plain(ci, so, qc, b, q),
            lambda: cuda_transfer3.interp_add(ci, so, qc, b, q)),
        "interp3_periodic": (
            lambda: cuda_transfer3.interp_plain(ci, qc, (n,) * 3, X3),
            lambda: cuda_transfer3.interp(ci, qc, (n,) * 3, X3)),
        "interp3, no wrap": (
            lambda: cuda_transfer3.interp_plain(ci, qc, (n,) * 3),
            lambda: cuda_transfer3.interp(ci, qc, (n,) * 3)),
    }
    out = time_turns(cases)
    # bytes and operations as in phase_times3: the sweep with its residual
    # reads the stencil, q and b and writes q and res
    N, Nc, W, e = n ** 3, nc ** 3, 26 * (nc + 1) ** 3, 4
    N27 = n27 ** 3
    work = {
        "sweep3_periodic": ((4 + 4) * N * e, 28 * N),
        "K6 256^3 +res phases, no wrap": ((4 + 4) * N * e, 28 * N),
        "K6 256^3 +res periodic xyz": ((4 + 4) * N * e, 28 * N),
        "K6 27pt 128^3 +res periodic xyz": ((14 + 4) * N27 * e, 108 * N27),
        "K6 27pt 128^3 +res phases, no wrap": ((14 + 4) * N27 * e,
                                               108 * N27),
        "sweep3_resident_periodic": ((14 + 4) * r ** 3 * e, 108 * r ** 3),
        "K6 27pt 16^3 +res resident, no wrap": ((14 + 4) * r ** 3 * e,
                                                108 * r ** 3),
        "K6 27pt 15^3 +res resident periodic xyz (jacobi)": (
            (14 + 4) * (r - 1) ** 3 * e, 108 * (r - 1) ** 3),
        "restrict3_periodic": ((W + N + Nc) * e, 52 * Nc),
        "restrict3, no wrap": ((W + N + Nc) * e, 52 * Nc),
        "interp_add3_periodic": ((W + Nc + 4 * N) * e, 67 * N // 8),
        "interp_add3, no wrap": ((W + Nc + 4 * N) * e, 67 * N // 8),
        "interp3_periodic": ((W + Nc + N) * e, 52 * N // 8),
        "interp3, no wrap": ((W + Nc + N) * e, 52 * N // 8),
    }
    for k, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, torch.float32)
        print(f"  {k}: bound {bms:.4f} ms by {by}; kernel {out[k][0]:.4f} "
              f"ms, plain {out[k][1]:.4f} ms", flush=True)
    return {k: v + work[k] for k, v in out.items() if k in work}


# --- the batched kernels, the inner coarse solve and the plane-configs ---

# the batched modes' entries of the kernel table (their launches: those of
# the plane-config paths), each with the entry of its unbatched kernel
BATCHED_OF = {"sweep2_batched": "sweep2", "line2_batched": "line2",
              "interp2_batched": "interp2"}
# K1, K4 and K5's batched comparisons beyond the plane-xy 128³ cycle's
# batches: an odd plane count at odd sizes, one-row and one-column planes,
# lines of 63, 64 and 65 points, K1's resident regime at its edge (9-point
# float32 90² resident, 91² streamed; float64 64², 65²)
BATCH_EDGES = [(7, 33, 21), (5, 1, 9), (3, 9, 1), (3, 63, 65), (2, 64, 63),
               (2, 65, 64), (3, 90, 90), (3, 91, 91)]
# the inner solve's cg-config at full width (the coarse grids are far past
# what an LU could hold)
CG_FULL = {"solver": {"tol": 1e-4, "max-iter": 10}}
# the plane-config variants of 3d_aniso_planexy_128 (one embedded cycle a
# colour, as the default plane-config); cedar: plane hierarchies stop at
# 16² (plane min-coarse 16), each plane's inner solver 16², 8², 4²
PLANE_VARIANTS = {
    "point": {"solver": {"relaxation": "point", "max-iter": 1}},
    "line-x": {"solver": {"relaxation": "line-x", "max-iter": 1}},
    "line-xy F": {"solver": {"relaxation": "line-xy", "max-iter": 1,
                             "cycle": {"type": "f"}}},
    "cedar": {"solver": {"relaxation": "line-xy", "max-iter": 1,
                         "cg-solver": "cedar", "min-coarse": 16},
              "cg-config": CG_FULL},
}
# what each plane-config variant must launch (its batched kernel)
PLANE_VARIANT_KERNELS = {"point": ("sweep2_batched",),
                         "line-x": ("line2_batched",),
                         "line-xy F": ("interp2_batched", "line_xy2"),
                         "cedar": ("line_xy2",)}


def batched_shapes():
    """The (B, nx, ny) batches of K1, K4 and K5's comparisons: every
    batch of planes of the plane-xy 128³ cycle (64 planes of 128² down to
    the 8² planes), then BATCH_EDGES."""
    return [*plane_transfer_shapes(N_PLANES), *BATCH_EDGES]


def phase_kernels_batched(errs: dict) -> dict:
    """The batched K1 (DOWN and UP, with and without the residual and an
    origin, 5- and 9-point, in its plan's regime and the small planes on
    the tile kernel too), K4 (x and y lines: the batched sweep, and K10's
    one-direction mode with 2 sweeps and the residual) and K5 bit-equal to
    their plain versions on batches of planes, float32 and float64; a
    batch of one equal to the unbatched launch."""
    print("[3] batched K1, K4, K5 against plain versions", flush=True)
    for k in BATCHED_OF:
        errs.setdefault(k, 0.0)
    n = 0
    for i, (shape, dtype) in enumerate(
            itertools.product(batched_shapes(),
                              (torch.float32, torch.float64))):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 2100 + i)
            pts = "9pt" if nine else "5pt"
            p = cuda2.plan(q.element_size(), nine, shape[1:])
            plans = [p] + ([cuda2.Plan(0)] if p.resident else [])
            for pl in plans:
                _, e = compare_sweep(so, q, b, kind, pts, tag + " batched",
                                     p=pl)
                errs["sweep2_batched"] = max(errs["sweep2_batched"], e)
                n += 12
            for axis in ("x", "y"):
                kernel = (cuda_lines2.line_x if axis == "x"
                          else cuda_lines2.line_y)
                plain = (cuda_lines2.line_x_plain if axis == "x"
                         else cuda_lines2.line_y_plain)
                for updown in ("down", "up"):
                    what = f"K4 line2 batched {axis} {pts} {updown} {tag}"
                    e = compare(what, kernel(so, q.clone(), b, kind, updown),
                                plain(so, q.clone(), b, kind, updown),
                                exact=True)
                    got = cuda_planes2.smooth(so, q.clone(), b, kind, updown,
                                              2, True, axes=axis)
                    want = cuda_planes2.smooth_plain(so, q.clone(), b, kind,
                                                     updown, 2, True,
                                                     axes=axis)
                    e = max(e, compare(what + " x2 +res q", got[0], want[0],
                                       exact=True),
                            compare(what + " x2 +res res", got[1], want[1],
                                    exact=True))
                    errs["line2_batched"] = max(errs["line2_batched"], e)
                    n += 3
            ci = interp2.setup_interp(so, kind)
            g = torch.Generator(device=DEV).manual_seed(2300 + i)
            qc = torch.randn((shape[0], ci.shape[-2] - 1, ci.shape[-1] - 1),
                             generator=g, device=DEV, dtype=dtype)
            e = compare(f"K5 interp2 batched {pts} {tag}",
                        cuda_transfer2.interp(ci, qc, shape),
                        cuda_transfer2.interp_plain(ci, qc, shape),
                        exact=True)
            errs["interp2_batched"] = max(errs["interp2_batched"], e)
            n += 1
            if shape == (7, 33, 21):
                # a batch of one: today's unbatched launches, bit for bit
                one = [t[:, :1].contiguous() if t.ndim == 4 else
                       t[:1].contiguous() for t in (so, q, b, ci, qc)]
                got = cuda2.sweep(one[0], one[1], one[2], kind, "down",
                                  True)
                want = cuda2.sweep(one[0][:, 0], one[1][0], one[2][0], kind,
                                   "down", True)
                got5 = cuda_transfer2.interp(one[3], one[4], (1, 33, 21))
                want5 = cuda_transfer2.interp(one[3][:, 0].contiguous(),
                                              one[4][0], (33, 21))
                if not (torch.equal(got[0][0], want[0])
                        and torch.equal(got[1][0], want[1])
                        and torch.equal(got5[0], want5)):
                    raise AssertionError(f"K1/K5 batch of one {pts} {tag} "
                                         "differs from the unbatched launch")
                print(f"  K1, K5 batch of one {pts} {tag}: bit-equal to the "
                      "unbatched launch", flush=True)
            del so, q, b, ci, qc
    print(f"  {n} batched comparisons, max_abs_err "
          f"{max(errs[k] for k in BATCHED_OF):.3e}", flush=True)
    return errs


def phase_cedar_gates() -> None:
    """[4h] float64: tests/test_cgsolve.py's cases on the card (the inner
    multigrid coarse solve to its LU solve within 1e-10, through the
    graph), and the plane-config variants at 32³, card against CPU (rtol
    1e-9, atol 1e-14)."""
    print("[4h] float64 inner coarse solve and plane-config gates",
          flush=True)
    cpu = torch.device("cpu")
    for what, (make, kind, shape, conf) in CEDAR_GATES.items():
        cls, rhs, cyc = ((Solver2, gallery.poisson_rhs, cycle2)
                         if len(shape) == 2
                         else (Solver3, gallery.poisson3_rhs, cycle3))
        so = make(*shape, torch.float64, DEV)
        b = rhs(*shape, torch.float64, DEV)
        reset_counts()
        s = cls(so, kind, Config({"log": [], **conf, "solver": {
            **conf["solver"], "tol": 1e-10, "max-iter": 30}}))
        x = s.solve(b)
        c = counts()
        check_graph(s, b, x, what, cyc)
        xa = cls(so, kind, Config({"log": [], "solver": {
            "tol": 1e-10, "max-iter": 30}})).solve(b)
        err = float((x - xa).abs().max())
        print(f"  {what}: cedar {len(s.history)} cycles, "
              f"{s.history[-1]:.6g}; max |x - x_LU| {err:.3e}", flush=True)
        if not err < 1e-10:
            raise AssertionError(f"{what}: cedar differs from LU by {err}")
        require_launched(c, (K1, "restrict2") if len(shape) == 2 else
                         (("sweep3", "sweep3_resident", "sweep3_fused"),
                          "restrict3"), what)
        del s, so, b, x, xa
    for what, (make, kind, conf) in PLANE_GATES.items():
        shape = (N_PLANE_GATE,) * 3
        conf = Config({"log": [], **conf, "solver": {
            **conf["solver"], "tol": 1e-9, "max-iter": 12}})
        so = make(*shape, torch.float64, cpu)
        b = gallery.poisson3_rhs(*shape, torch.float64, cpu)
        reset_counts()
        s = Solver3(so.to(DEV), kind, conf)
        x = s.solve(b.to(DEV))
        c = counts()
        check_graph(s, b.to(DEV), x, what, cycle3)
        sc = Solver3(so, kind, conf)
        sc.solve(b)
        print(f"  {what}: card {' '.join(f'{h:.9g}' for h in s.history)}",
              flush=True)
        print(f"  {what}: CPU  {' '.join(f'{h:.9g}' for h in sc.history)}",
              flush=True)
        np.testing.assert_allclose(s.history, sc.history, rtol=1e-9,
                                   atol=1e-14)
        relax = s.settings.plane_settings.relaxation.value
        need = {"point": "sweep2_batched", "line-x": "line2_batched",
                "line-y": "line2_batched"}.get(relax, "line_xy2")
        require_launched(c, (need,), what)
        del s, sc, so, b, x


def inner_steps(s, b, cycle) -> tuple[int, int, int, int]:
    """The inner solves' steps in one eager cycle from x = 0: those in
    which the grid (a plane of a batch) was still active, as the JAX
    package's loop (vmapped) would run them, and all the masked loops ran;
    then the same counted a plane."""
    inner.record_active = steps = []
    try:
        cycle.cycle_residual(s.levels, s.kinds, torch.zeros_like(b), b,
                             s.settings, **s.graphs.cycle_kw)
        torch.cuda.synchronize()
    finally:
        inner.record_active = None
    return (sum(bool(a.any()) for a in steps), len(steps),
            int(sum(int(a.sum()) for a in steps)),
            sum(a.numel() for a in steps))


def inner_solve_ms(found) -> float:
    """CUDA-event ms of one inner coarse solve (``found``: :func:`inner_of`)
    on a random rhs, as replays of a graph of its own."""
    coarse, settings, cyc = found
    g = torch.Generator(device=DEV).manual_seed(40)
    cb = torch.randn(tuple(coarse.so.shape[1:]), generator=g, device=DEV,
                     dtype=coarse.so.dtype)
    out = torch.empty_like(cb)

    def one():
        out.copy_(cyc.coarse_solve(coarse, cb, settings))

    backend = graph.CudaGraphs(DEV)
    backend.warm(one)
    gr = backend.capture(one)
    ms = time_ms(lambda: backend.replay(gr))
    del gr, backend
    torch.cuda.empty_cache()
    return ms


def run_cell(name: str, cls, make, kind, shape, conf: dict, need,
             cycle) -> dict:
    """One configuration at full width, float32: setup, a solve of four
    cycles with launch counts (``need`` launched), graph against eager bit
    for bit, the launches of one captured cycle with its warm-up and
    capture seconds and memory, the inner solve's active steps, the
    per-cycle time (eager against graph in pairs), peak memory."""
    print(f"[5g] {name}: {make.__name__} {shape} float32, {conf}",
          flush=True)
    rhs = gallery.poisson_rhs if len(shape) == 2 else gallery.poisson3_rhs
    conf = Config({"log": [], **conf, "solver": {
        "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        **conf.get("solver", {}), "max-iter": 4, "tol": 1e-6}})
    so = make(*shape, torch.float32, DEV)
    b = rhs(*shape, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = cls(so, kind, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    del so
    print(f"  {name}: levels {s.nlevels}: {s.shapes[0]} .. {s.shapes[-1]}; "
          f"setup {setup_s:.3f} s", flush=True)
    print(f"  {name}: history {' '.join(f'{h:.9g}' for h in s.history)}",
          flush=True)
    print(f"  {name}: counts {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != shape:
        raise AssertionError(f"{name}: bad solution")
    # (the first cycle of the 4096² problem leaves 1.07 of the residual,
    # as the main path's leaves 1.20; plane F-cycles stall at their plane
    # solves' accuracy, as in cedar_tpu)
    if not s.history[-1] < s.history[0]:
        raise AssertionError(f"{name}: the solve did not converge")
    require_launched(launches, need, name)
    check_graph(s, b, x, name, cycle)
    one_cycle_launches(s, b, name, None, cycle)
    found = inner_of(s, cycle)
    if found is not None:
        useful, steps, pa, pt = inner_steps(s, b, cycle)
        maxiter = found[1].cg_settings.maxiter
        ms = inner_solve_ms(found)
        print(f"  {name}: inner solves of one cycle: {useful} of {steps} "
              f"steps with the grid (a plane) still active ({pa} of {pt} "
              f"plane-steps); one solve {ms:.4f} ms (graph, "
              f"{tuple(found[0].so.shape[1:])}, {maxiter} steps), the "
              f"discarded steps about {(steps - useful) * ms / maxiter:.4f} "
              "ms a cycle (at that solve's size)", flush=True)
    ms = time_cycles(s, b, x, ncycles=10, cycle=cycle)
    print(f"  {name}: DOF/s {math.prod(shape) / (ms * 1e-3):.4e}; "
          f"peak memory (setup and solve) {peak / 2**20:.1f} MiB",
          flush=True)
    return launches


def phase_cedar_full() -> dict:
    """[5g] The new configurations at full width through the graph and
    eagerly: ``3d_aniso_planexy_128`` with plane-config point, line-x,
    line-xy F-cycle and cg-solver cedar; 4096² 5-point V(1,1) and
    ``3d_poisson_7pt_256`` with ``num-levels: 3`` and ``cg-solver:
    cedar``.  Returns the batched kernels' launches (their cells' solves)."""
    out = {}
    n = N_PLANES
    for variant, pconf in PLANE_VARIANTS.items():
        c = run_cell(f"3d_aniso_planexy_128 plane-config {variant}",
                     Solver3, aniso3, SevenPt, (n, n, n),
                     plane_conf("plane-xy", pconf),
                     PLANE_VARIANT_KERNELS[variant] + ("restrict2",
                                                       "interp_add2",
                                                       "restrict3"),
                     cycle3)
        for k in PLANE_VARIANT_KERNELS[variant]:
            if k in BATCHED_OF:
                out[k] = c[k]
    run_cell("4096^2 V(1,1) num-levels 3 cedar", Solver2, gallery.poisson,
             FivePt, (N_MAIN, N_MAIN), cedar_conf(3, CG_FULL["solver"]),
             (K1, "restrict2", "interp_add2", "sweep_restrict2",
              "interp_sweep2"), cycle2)
    run_cell("3d_poisson_7pt_256 num-levels 3 cedar", Solver3,
             gallery.poisson3, SevenPt, (N_3D,) * 3,
             cedar_conf(3, CG_FULL["solver"]),
             ("restrict3", "interp_add3", ("sweep3", "sweep3_resident",
                                           "sweep3_fused")), cycle3)
    return out


def phase_times_batched() -> dict:
    """The batched K1 (5-point + the residual at (64, 128²), streamed;
    9-point at (64, 64²), resident), K4 (x and y sweeps at (64, 128²)
    5-point) and K5 ((64, 64²) -> (64, 128²)) against plain, float32, in
    turns, with their bounds."""
    print("[6] batched K1, K4, K5 ms (plain, kernel, kernel, plain)",
          flush=True)
    cases, work = {}, {}
    for shape, nine in (((64, N_PLANES, N_PLANES), False),
                        ((64, N_PLANES // 2, N_PLANES // 2), True)):
        so, q, b, kind = random_problem(shape, nine, torch.float32,
                                        30 + nine)
        nb, n = shape[0], shape[1]
        N = nb * n * n
        pts = "9pt" if nine else "5pt"
        key = f"sweep2_batched {pts} {shape} +res"
        cases[key] = (
            lambda so=so, q=q, b=b, kind=kind: cuda2.sweep_plain(
                so, q, b, kind, "down", True),
            lambda so=so, q=q, b=b, kind=kind: cuda2.sweep(
                so, q, b, kind, "down", True))
        ndir = kind.ndirs
        # the stencil planes, q and b read, q and res written; 2 ndir + 1
        # operations a point a sweep and the residual
        work[key] = ((ndir + 4) * N * 4, 2 * (2 * ndir + 1) * N)
        if nine:
            continue
        for axis in ("x", "y"):
            key = f"line2_batched {axis} {pts} {shape}"
            fn = cuda_lines2.line_x if axis == "x" else cuda_lines2.line_y
            pf = (cuda_lines2.line_x_plain if axis == "x"
                  else cuda_lines2.line_y_plain)
            cases[key] = (
                lambda pf=pf, so=so, q=q, b=b, kind=kind: pf(
                    so, q, b, kind, "down"),
                lambda fn=fn, so=so, q=q, b=b, kind=kind: fn(
                    so, q, b, kind, "down"))
            # the stencil planes, b and q read, q written; the rhs (4), 12
            # a PCR step and 8 for the interleaved Thomas a point
            work[key] = ((ndir + 3) * N * 4, (4 + 12 * pcr_steps(n) + 8) * N)
        ci = interp2.setup_interp(so, kind)
        nc = ci.shape[-1] - 1
        g = torch.Generator(device=DEV).manual_seed(31)
        qc = torch.randn((nb, nc, nc), generator=g, device=DEV,
                         dtype=torch.float32)
        key = f"interp2_batched {pts} {shape}"
        cases[key] = (
            lambda ci=ci, qc=qc, sh=shape: cuda_transfer2.interp_plain(
                ci, qc, sh),
            lambda ci=ci, qc=qc, sh=shape: cuda_transfer2.interp(ci, qc, sh))
        work[key] = ((8 * nb * (nc + 1) ** 2 + nb * nc * nc + N) * 4,
                     4 * N)
    out = time_turns(cases, slow=[k for k in cases if "line2" in k])
    for k, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, torch.float32)
        # the device time beside the event time of back-to-back calls,
        # which a wrapper's host time bounds at these sizes
        dms = device_ms(cases[k][1])
        print(f"  {k}: bound {bms:.4f} ms by {by} ({nbytes / 1e9:.4f} GB, "
              f"{flops / 1e9:.4f} GFLOP); kernel {out[k][0]:.4f} ms "
              f"(device {dms:.4f}), plain {out[k][1]:.4f} ms", flush=True)
    # the table's entries: the 5-point sweep + res, the x sweep, the interp
    top = (64, N_PLANES, N_PLANES)
    main = {"sweep2_batched": f"sweep2_batched 5pt {top} +res",
            "line2_batched": f"line2_batched x 5pt {top}",
            "interp2_batched": f"interp2_batched 5pt {top}"}
    return {k: out[v] + work[v] for k, v in main.items()}


# ---- solver.ml-relax.enabled, the handle API, the examples, profile_trace


def phase_kernels_fullpcr(errs: dict) -> dict:
    """K4 and K10 at the full PCR stride (``solver.ml-relax.enabled``:
    h the power of two at or above the line's length), bit-equal to their
    plain versions at the full stride: K4 x and y, 5- and 9-point, DOWN and
    UP, at 2048² float32 and LINE_SHAPES (lines of 63, 64 and 65 points,
    lengths that are no power of two, lines too long for shared memory) in
    float32 and float64, and cyclic and wrapped at PERIODIC_LINES; K10 in
    both modes (line-xy, x, y), DOWN and UP, a sweep and 2 sweeps with the
    residual, at (64, 128²) and BATCH_EDGES in float32 and float64."""
    print("[3] K4 and K10 at the full PCR stride against plain versions",
          flush=True)
    for k in ("line2_fullpcr", "planes2_fullpcr"):
        errs.setdefault(k, 0.0)
    dts = (torch.float32, torch.float64)
    n = 0
    shapes = [((N_LINES, N_LINES), torch.float32)] + [
        (s, dt) for s, _ in LINE_SHAPES for dt in dts]
    for i, (shape, dtype) in enumerate(shapes):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 3100 + i)
            pts = "9pt" if nine else "5pt"
            e = compare_lines(so, q, b, kind, pts, tag, full=True)
            errs["line2_fullpcr"] = max(errs["line2_fullpcr"], e)
            n += 4
            del so, q, b
    for i, ((shape, dtype), per) in enumerate(
            itertools.product(PERIODIC_LINES, PERIODIC)):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        for nine in (False, True):
            so, q, b, kind = random_periodic_problem(shape, nine, dtype,
                                                     3300 + i, per)
            pts = "9pt" if nine else "5pt"
            e = compare_lines(so, q, b, kind, pts, tag, per, full=True)
            errs["line2_fullpcr"] = max(errs["line2_fullpcr"], e)
            n += 4
            del so, q, b
    for i, (shape, dtype) in enumerate(itertools.product(
            [(64, N_PLANES, N_PLANES), *BATCH_EDGES], dts)):
        tag = f"{shape} {str(dtype).replace('torch.', '')} full-stride"
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 3500 + i)
            pts = "9pt" if nine else "5pt"
            for axes, updown, (nsweeps, res) in itertools.product(
                    ("xy", "x", "y"), ("down", "up"),
                    ((1, False), (2, True))):
                got = cuda_planes2.smooth(so, q.clone(), b, kind, updown,
                                          nsweeps, res, axes, full=True)
                want = cuda_planes2.smooth_plain(so, q.clone(), b, kind,
                                                 updown, nsweeps, res,
                                                 axes=axes, full=True)
                what = (f"K10 {axes} {pts} {updown} x{nsweeps} "
                        f"res={int(res)} {tag}")
                if res:
                    e = max(compare(what + " q", got[0], want[0],
                                    exact=True),
                            compare(what + " res", got[1], want[1],
                                    exact=True))
                else:
                    e = compare(what, got, want, exact=True)
                errs["planes2_fullpcr"] = max(errs["planes2_fullpcr"], e)
                n += 1 + res
            del so, q, b
    torch.cuda.empty_cache()
    print(f"  {n} full-stride comparisons, max_abs_err "
          f"{max(errs['line2_fullpcr'], errs['planes2_fullpcr']):.3e}",
          flush=True)
    return errs


def require_full(c: dict, what: str) -> None:
    """Every K4 and K10 launch of ``c`` at the full stride, one at least."""
    line = c["line2"]
    plane = c["line_xy2"] + c["line2_batched"]
    if (c["line2_fullpcr"], c["planes2_fullpcr"]) != (line, plane) or not (
            line or plane):
        raise AssertionError(f"{what}: full-stride launches "
                             f"{c['line2_fullpcr']} K4, "
                             f"{c['planes2_fullpcr']} K10 of {line}, {plane}")


def example_norm(line: str) -> float:
    return float(re.search(r"Solution norm: (\S+)", line).group(1))


def phase_mlrelax_gates() -> None:
    """[4i] float64 gates, card against CPU (rtol 1e-9, atol 1e-14): the
    ml-relax line-xy solve of 400² ``diag_diffusion(100, 1)`` (its top
    lines of 400 and 200 points by the full-length PCR), plane-xy 64x64x8
    with a plane-config ml-relax, a 2D and a 3D handle solve through
    ``capi`` (and ``operator_apply``, card against CPU, to 1e-13); then
    the four examples on the card and on the CPU (:func:`run_example`), at
    their default sizes and at their CPU tests' sizes."""
    print("[4i] float64 ml-relax, handle API and example gates, card "
          "against CPU", flush=True)
    cpu = torch.device("cpu")
    n = 400
    conf = Config({"log": [], "solver": {
        "relaxation": "line-xy", "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-10, "max-iter": 10, **ML}})
    so = gallery.diag_diffusion(n, n, 100.0, 1.0, torch.float64, cpu)
    b = gallery.poisson_rhs(n, n, torch.float64, cpu)
    s, x, c = gate_solve(DEV, so, FivePt, conf, b)
    sc, xc, _ = gate_solve(cpu, so, FivePt, conf, b)
    print(f"  ml-relax line-xy {n}^2: card "
          f"{' '.join(f'{h:.9g}' for h in s.history)}", flush=True)
    print(f"  CPU: {' '.join(f'{h:.9g}' for h in sc.history)}; counts {c}",
          flush=True)
    np.testing.assert_allclose(s.history, sc.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.cpu().numpy(), xc.numpy(), rtol=1e-9,
                               atol=1e-9 * float(xc.abs().max()))
    require_launched(c, ("line2", "line2_fullpcr", "restrict2",
                         "interp_add2"), "ml-relax line-xy gate")
    require_full(c, "ml-relax line-xy gate")

    what, shape = "plane-xy 64x64x8 plane-config ml-relax", (64, 64, 8)
    conf = Config({"log": [], "solver": {
        "relaxation": "plane-xy", "tol": 1e-9, "max-iter": 20},
        "plane-config": {"solver": {"relaxation": "line-xy", "max-iter": 1,
                                    **ML}}})
    so = aniso3(*shape, torch.float64, cpu)
    b = gallery.poisson3_rhs(*shape, torch.float64, cpu)
    reset_counts()
    s = Solver3(so.to(DEV), SevenPt, conf)
    x = s.solve(b.to(DEV))
    c = counts()
    check_graph(s, b.to(DEV), x, what, cycle3)
    sc = Solver3(so, SevenPt, conf)
    xc = sc.solve(b)
    print(f"  {what}: card {' '.join(f'{h:.9g}' for h in s.history)}; CPU "
          f"{' '.join(f'{h:.9g}' for h in sc.history)}; counts {c}",
          flush=True)
    np.testing.assert_allclose(s.history, sc.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.cpu().numpy(), xc.numpy(), rtol=1e-9,
                               atol=1e-9 * float(xc.abs().max()))
    require_launched(c, PLANE_KERNELS + ("planes2_fullpcr",), what)
    require_full(c, what)

    # the handle API: the same numpy operator on both devices
    for what, mk, dims in (
            ("capi 2D fe 200^2", lambda: gallery.fe(200, 200, torch.float64,
                                                    cpu), 2),
            ("capi 3D poisson3 40^3", lambda: gallery.poisson3(
                40, 40, 40, torch.float64, cpu), 3)):
        so = mk().numpy()
        shape = so.shape[1:]
        topo = (capi.bmg2_topo_create if dims == 2 else capi.bmg3_topo_create)
        solve = {}
        rng = np.random.default_rng(40 + dims)
        b = rng.standard_normal(shape)
        xin = rng.standard_normal(shape)
        for dev in (None, "cpu"):   # None: the topology's default, the card
            op = capi.bmg2_operator_create(topo(*shape, device=dev)) \
                if dims == 2 else capi.bmg3_operator_create(
                    topo(*shape, device=dev))
            capi.bmg2_operator_set_full(op, so)
            ax = capi.bmg2_operator_apply(op, xin)
            slv = (capi.bmg2_solver_create if dims == 2
                   else capi.bmg3_solver_create)(op, {
                       "log": [], "solver": {"tol": 1e-10, "max-iter": 20}})
            x = np.zeros(shape)
            capi.bmg2_solver_run(slv, x, b)
            solve[dev] = (ax, x, capi._get(slv).history,
                          capi._get(slv).levels[0].so.device)
            capi.bmg2_solver_destroy(slv)
            capi.bmg2_operator_destroy(op)
        (ax, x, h, d), (axc, xc, hc, dc) = solve[None], solve["cpu"]
        print(f"  {what}: card ({d}) {' '.join(f'{v:.9g}' for v in h)}; "
              f"CPU ({dc}) {' '.join(f'{v:.9g}' for v in hc)}; apply max "
              f"|card - CPU| {np.abs(ax - axc).max():.3e}", flush=True)
        if d.type != "cuda" or dc.type != "cpu":
            raise AssertionError(f"{what}: solved on {d} and {dc}")
        np.testing.assert_allclose(ax, axc, rtol=0, atol=1e-13)
        np.testing.assert_allclose(h, hc, rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose(x, xc, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(xc).max()))
        if not h[-1] < 1e-10:
            raise AssertionError(f"{what}: did not converge to 1e-10")

    # the examples: at their default sizes on the card (no --device: the
    # default), then at the sizes of their CPU tests (EXAMPLE_SIZES) on the
    # card and the CPU, where the error norms must agree to rtol 1e-3, as
    # the CPU tests hold them to cedar_tpu's examples; at the default sizes
    # the float32 solves stall at their floor (400²: 2.3e-4 relative) and
    # the norm carries that floor's noise (card 2.21133e-05, CPU
    # 1.96099e-05), so there only the planes example is compared, by its
    # cycle count.  In a scratch directory: the 2D one writes timings.json
    # where it runs.
    from cedar_tpu_torch.examples import (
        anisotropic_3d_planes, basic_2d_ser, basic_3d_ser, capi_poisson,
    )

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for mod in (basic_2d_ser, basic_3d_ser, anisotropic_3d_planes,
                        capi_poisson):
                name = mod.__name__.rsplit(".", 1)[1]
                for size in [[]] + ([EXAMPLE_SIZES[name]]
                                     if EXAMPLE_SIZES[name] else []):
                    run_example(mod, name, size)
        finally:
            os.chdir(here)


# the sizes of tests/test_torch_examples.py's runs
EXAMPLE_SIZES = {"basic_2d_ser": ["64", "48"], "basic_3d_ser": ["16"],
                 "anisotropic_3d_planes": ["16"], "capi_poisson": []}


def run_example(mod, name: str, size: list) -> None:
    """One example at ``size`` (``[]``: its defaults) on the card, and on
    the CPU where the two are compared: each must finish, the card through
    kernels only; the planes example takes as many cycles on both, and at
    its CPU test's size (``EXAMPLE_SIZES``) another's error norms agree to
    rtol 1e-3."""
    tag = f"{name} {' '.join(size) or 'default size'}"
    reset_counts()
    t0 = time.perf_counter()
    card = mod.main(size)
    t1 = time.perf_counter()
    c = {k: v for k, v in counts().items() if v}
    compared = (name == "anisotropic_3d_planes"
                or size == EXAMPLE_SIZES[name])
    host = mod.main([*size, "--device", "cpu"]) if compared else card
    t2 = time.perf_counter()
    print(f"  example {tag}: card {card[0]!r} ({t1 - t0:.2f} s)"
          + (f", CPU {host[0]!r} ({t2 - t1:.2f} s)" if compared else "")
          + f"; launches {c}", flush=True)
    if card[-1] != "Finished Test" or host[-1] != card[-1]:
        raise AssertionError(f"{tag}: did not finish")
    if not c or any(k.endswith("_plain") for k in c):
        raise AssertionError(f"{tag}: the card ran no kernel or a plain "
                             "version")
    if name == "anisotropic_3d_planes":
        cycles = [re.match(r"converged in (\d+) cycles", v).group(1)
                  for v in (card[0], host[0])]
        if cycles[0] != cycles[1]:
            raise AssertionError(f"{tag}: {cycles[0]} cycles on the card, "
                                 f"{cycles[1]} on the CPU")
    elif size == EXAMPLE_SIZES[name]:
        np.testing.assert_allclose(example_norm(card[0]),
                                   example_norm(host[0]), rtol=1e-3)
    elif not math.isfinite(example_norm(card[0])):
        raise AssertionError(f"{tag}: error norm {card[0]!r}")


def graph_pairs(cases: dict, ncycles: int = 25, pairs: int = PAIRS) -> dict:
    """Replays of solvers' captured iterations against each other:
    ``cases`` name -> (solver, b, x); ``pairs`` rounds of ``ncycles``
    CUDA-event-timed replays of each, the order turned each round, after
    three warm-up replays each.  Prints each run and the median of the
    medians; returns name -> that median."""
    one = {}
    for name, (s, b, x) in cases.items():
        g = s.graphs.graph("solve", b)
        g.x.copy_(x)
        g.b.copy_(b)
        one[name] = g.replay
        for _ in range(3):
            g.replay()
    runs = {k: [] for k in cases}
    names = list(cases)
    for k in range(pairs):
        for name in (names if k % 2 == 0 else names[::-1]):
            ms, lo, hi, host = run_cycles(one[name], ncycles)
            runs[name].append(ms)
            print(f"  pair {k} {name}: graph cycle ms median {ms:.4f}, min "
                  f"{lo:.4f}, max {hi:.4f} (host clock {host:.4f})",
                  flush=True)
    med = {k: statistics.median(v) for k, v in runs.items()}
    print("  graph cycle ms, median of medians: " + "; ".join(
        f"{k} {med[k]:.4f} ({min(runs[k]):.4f}-{max(runs[k]):.4f})"
        for k in names), flush=True)
    return med


def ml_cell(name: str, cls, make, kind, shape, conf: dict, need,
            want, cycle) -> tuple:
    """One cell at full width, float32, with ``solver.ml-relax.enabled``
    (``conf`` the ml-relax configuration) beside the same configuration at
    the default stride: for each, setup, a solve of four cycles with its
    launch counts, graph against eager bit for bit and the launches of one
    captured cycle (``want(s)``: kernel -> count, the ml-relax one's K4 and
    K10 all at the full stride); then the two graphs' cycle ms in
    alternating pairs.  Returns (the ml-relax solve's launches, the medians)."""
    rhs = gallery.poisson_rhs if len(shape) == 2 else gallery.poisson3_rhs
    so = make(*shape, torch.float32, DEV)
    b = rhs(*shape, torch.float32, DEV)
    solved, out = {}, None
    for stride, c in (("full", conf), ("default", strip_ml(conf))):
        label = f"{name} {stride} stride"
        print(f"[5h] {label}: {make.__name__} {shape} float32, {c}",
              flush=True)
        c = Config({"log": [], **c})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        s = cls(so, kind, c)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x = s.solve(b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"  {label}: setup {t1 - t0:.3f} s, solve {t2 - t1:.3f} s "
              f"({len(s.history)} cycles, the first with its warm-up and "
              f"capture); history {' '.join(f'{h:.9g}' for h in s.history)}"
              f"; peak memory {peak / 2**20:.1f} MiB", flush=True)
        print(f"  {label}: counts {launches}", flush=True)
        if not torch.isfinite(x).all() or tuple(x.shape) != shape:
            raise AssertionError(f"{label}: bad solution")
        if not s.history[-1] < s.history[0]:
            raise AssertionError(f"{label}: the solve did not converge")
        require_launched(launches, need if stride == "full" else [
            k for k in need if not k.endswith("_fullpcr")], label)
        check_graph(s, b, x, label, cycle)
        w = want(s)
        if stride == "full":
            out = launches
            require_full(launches, label)
        else:
            w = {k: (0 if k.endswith("_fullpcr") else v)
                 for k, v in w.items()}
        one_cycle_launches(s, b, label, w, cycle)
        solved[f"{stride} stride"] = (s, b, x)
    return out, graph_pairs(solved)


def strip_ml(conf: dict) -> dict:
    """``conf`` with every ``ml-relax`` section removed (the default
    stride), nested sections included."""
    if not isinstance(conf, dict):
        return conf
    return {k: strip_ml(v) for k, v in conf.items() if k != "ml-relax"}


def handle_solve_4096() -> None:
    """A 4096² float64 5-point V(1,1) solve through the handle API
    (``bmg2_operator_set_full``, ``bmg2_solver_run``, the default device:
    the card), its x bit for bit that of ``Solver2`` on the same tensors;
    setup, solve and the numpy <-> card copies in seconds."""
    n = N_MAIN
    print(f"[5h] handle solve: Poisson {n}^2 float64 V(1,1) through capi",
          flush=True)
    conf = {"log": [], "solver": {
        "cycle": {"nrelax-pre": 1, "nrelax-post": 1}, "tol": 1e-10,
        "max-iter": 4}}
    so = gallery.poisson(n, n, torch.float64, "cpu").numpy()
    b = gallery.poisson_rhs(n, n, torch.float64, "cpu").numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = capi.bmg2_operator_create(capi.bmg2_topo_create(n, n))
    capi.bmg2_operator_set_full(op, so)
    slv = capi.bmg2_solver_create(op, conf)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x = np.zeros((n, n))
    capi.bmg2_solver_run(slv, x, b)
    t2 = time.perf_counter()
    s = capi._get(slv)
    # the copies a run makes: b and x to the card, x back
    t3 = time.perf_counter()
    tb = torch.as_tensor(b, device=DEV)
    tx = torch.as_tensor(x, device=DEV)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    back = tx.cpu().numpy()
    t5 = time.perf_counter()
    print(f"  handle solve: setup {t1 - t0:.3f} s (with the stencil's copy "
          f"to the card), run {t2 - t1:.3f} s ({len(s.history)} cycles, "
          f"the first with its warm-up and capture; history "
          f"{' '.join(f'{h:.9g}' for h in s.history)}); numpy -> card "
          f"{t4 - t3:.4f} s (b and x, {2 * b.nbytes / 2**20:.0f} MiB), card "
          f"-> numpy {t5 - t4:.4f} s (x)", flush=True)
    ref = Solver2(torch.as_tensor(so[:3], device=DEV), FivePt, conf)
    xr = ref.solve(tb, torch.zeros_like(tb))
    if not np.array_equal(x, xr.cpu().numpy()) or not np.array_equal(
            back, x):
        raise AssertionError("handle solve: x differs from Solver2's (max "
                             f"|diff| {np.abs(x - xr.cpu().numpy()).max()})")
    if ref.history != s.history or s.levels[0].so.device.type != "cuda":
        raise AssertionError("handle solve: history or device differs")
    print("  handle solve: x bit for bit Solver2's on the same tensors",
          flush=True)
    capi.bmg2_solver_destroy(slv)
    capi.bmg2_operator_destroy(op)
    del s, ref, xr, tb, tx
    torch.cuda.empty_cache()


# K12 and K13 by the kernel's name in a trace: csrc/fused2.cu `ring2<T,
# NINE, EPI>`, EPI 3 (kRestrict) for K12, else K13
RING2 = re.compile(
    r"ring2<(?:float|double), (?:true|false|\(bool\)\d), (?:\(int\))?(\d)>")


def traced_solve_4096() -> None:
    """A 4096² float32 V(1,1) graph solve of four cycles inside
    ``profile_trace``, after a first solve that captured the graph: the
    trace file must parse as JSON and name K12 and K13 launched inside the
    replays (the fused cycle's four levels each, every cycle)."""
    n = N_MAIN
    print(f"[5h] profile_trace: Poisson {n}^2 float32 V(1,1), a graph solve "
          "of four cycles", flush=True)
    conf = Config({"log": [], "solver": {
        "cycle": {"nrelax-pre": 1, "nrelax-post": 1}, "tol": 1e-30,
        "max-iter": 4}})
    s = Solver2(gallery.poisson(n, n, torch.float32, DEV), FivePt, conf)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    s.solve(b)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profile_trace(tmp):
            s.solve(b)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        files = [f for f in os.listdir(tmp) if f.endswith(".json")]
        if len(files) != 1:
            raise AssertionError(f"profile_trace wrote {files}")
        path = os.path.join(tmp, files[0])
        size = os.path.getsize(path)
        with open(path) as f:
            trace = json.load(f)
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    k12 = k13 = 0
    for e in kernels:
        m = RING2.search(e.get("name", ""))
        if m:
            k12 += m.group(1) == "3"
            k13 += m.group(1) != "3"
    want = 4 * SPLIT_LEVELS
    print(f"  profile_trace: {t1 - t0:.3f} s, {size / 2**20:.1f} MiB, "
          f"{len(trace['traceEvents'])} events, {len(kernels)} kernels: K12 "
          f"{k12}, K13 {k13}", flush=True)
    if k12 != want or k13 != want:
        raise AssertionError(f"profile_trace: K12 {k12}, K13 {k13} in the "
                             f"replays, not {want} each")


def phase_mlrelax_full() -> dict:
    """[5h] ``2d_fe_9pt_linexy_2048`` with ml-relax (K4 once a zebra
    colour, every launch at the full stride) and ``3d_aniso_planexy_128``
    with a plane-config ml-relax (K10 at the full stride), each beside its
    default stride; the 4096² float64 handle solve; the 4096² traced graph
    solve.  Returns the full-stride launches of the two cells."""
    n = N_LINES
    lines, _ = ml_cell(
        "2d_fe_9pt_linexy_2048 ml-relax", Solver2, gallery.fe, NinePt,
        (n, n), {"solver": {"relaxation": "line-xy",
                            "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
                            "max-iter": 4, "tol": 1e-6, **ML}},
        ("line2", "line2_fullpcr", "restrict2", "interp_add2"),
        lambda s: {"line2": 8 * (s.nlevels - 1),
                   "line2_fullpcr": 8 * (s.nlevels - 1)}, cycle2)

    def k10(s):
        k = sum(2 * 2 * (len(h) - 1) for lev in s.levels[:-1]
                for h in lev.planes["xy"] if h is not None)
        return {"line_xy2": k, "planes2_fullpcr": k}

    n = N_PLANES
    planes, _ = ml_cell(
        "3d_aniso_planexy_128 plane-config ml-relax", Solver3, aniso3,
        SevenPt, (n, n, n), {
            "solver": {"relaxation": "plane-xy",
                       "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
                       "max-iter": 4, "tol": 1e-6},
            "plane-config": {"solver": {"relaxation": "line-xy",
                                        "max-iter": 1, **ML}}},
        PLANE_KERNELS + ("planes2_fullpcr",), k10, cycle3)
    handle_solve_4096()
    traced_solve_4096()
    return {"line2_fullpcr": lines["line2_fullpcr"],
            "planes2_fullpcr": planes["planes2_fullpcr"]}


def phase_times_fullpcr() -> dict:
    """K4 (2048² 9-point float32, x and y) and K10 ((64, 128²) 5-point
    float32, 2 smooths + the residual) at the full stride against their
    plain versions at the full stride, and beside the default stride in
    the same call (default, full, full, default), event and device ms; the
    bound is the default stride's bytes (unchanged) or the full stride's
    operations, whichever is larger."""
    print("[6] K4 and K10 at the full PCR stride (plain, kernel, kernel, "
          "plain; then default against full stride)", flush=True)
    m = N_LINES
    sl, ql, bl, kl = random_problem((m, m), True, torch.float32, 10)
    shape = (64, N_PLANES, N_PLANES)
    sp, qp, bp, kp = random_problem(shape, False, torch.float32, 20)

    def k4(axis, full, plain=False):
        fn = {("x", False): cuda_lines2.line_x,
              ("y", False): cuda_lines2.line_y,
              ("x", True): cuda_lines2.line_x_plain,
              ("y", True): cuda_lines2.line_y_plain}[axis, plain]
        return lambda: fn(sl, ql, bl, kl, "down", full=full)

    def k10(full, plain=False):
        if plain:
            return lambda: cuda_planes2.smooth_plain(sp, qp, bp, kp, "down",
                                                     2, True, full=full)
        return lambda: cuda_planes2.smooth(sp, qp, bp, kp, "down", 2, True,
                                           full=full)

    cases = {"line2_fullpcr x": (k4("x", True, True), k4("x", True)),
             "line2_fullpcr y": (k4("y", True, True), k4("y", True)),
             "planes2_fullpcr 5pt x2 +res": (k10(True, True), k10(True))}
    out = time_turns(cases, slow=list(cases))
    time_turns({
        "K4 x 2048^2 9pt": (k4("x", False), k4("x", True)),
        "K4 y 2048^2 9pt": (k4("y", False), k4("y", True)),
        "K10 (64, 128^2) 5pt x2 +res": (k10(False), k10(True)),
    }, labels=("default", "full"))
    for name, fd, ff in (("K4 x", k4("x", False), k4("x", True)),
                         ("K4 y", k4("y", False), k4("y", True)),
                         ("K10", k10(False), k10(True))):
        print(f"  {name}: device ms default stride {device_ms(fd):.4f}, "
              f"full stride {device_ms(ff):.4f}", flush=True)
    N = shape[0] * shape[1] * shape[2]
    work = {
        # as phase_times' line2 and phase_times_planes' line_xy2, with the
        # full stride's PCR steps
        "line2_fullpcr": ((5 + 3) * m * m * 4,
                          (12 + 12 * pcr_steps(m, True) + 8) * m * m),
        "planes2_fullpcr": ((3 + 4) * N * 4, (2 * 2 * (
            4 + 12 * pcr_steps(N_PLANES, True) + 8) + 10) * N),
    }
    res = {"line2_fullpcr": tuple((a + c) / 2 for a, c in zip(
               out["line2_fullpcr x"], out["line2_fullpcr y"])),
           "planes2_fullpcr": out["planes2_fullpcr 5pt x2 +res"]}
    for k, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, torch.float32)
        print(f"  {k}: bound {bms:.4f} ms by {by} ({nbytes / 1e9:.4f} GB, "
              f"{flops / 1e9:.4f} GFLOP); kernel {res[k][0]:.4f} ms, plain "
              f"{res[k][1]:.4f} ms", flush=True)
    return {k: res[k] + work[k] for k in work}


# -- distribution (phases 3, 4j, 5i, 6): DistSolver2/3 over torch.distributed

DIST_H = shard_relax.H
# the shard shapes of the distributed paths (a block extended by H), with
# the origins of the first rank of an axis (-H), of another rank and an
# odd one: the 4096² and 400² levels 0 and 1 on a (2, 2) mesh, the 256³
# and 200³ levels 0 and 1 on (2, 2, 2)
DIST_SWEEP_SHAPES = [
    ((N_MAIN // 2 + 2 * DIST_H,) * 2, torch.float32, False),
    ((N_MAIN // 4 + 2 * DIST_H,) * 2, torch.float32, True),
    ((200 + 2 * DIST_H,) * 2, torch.float64, False),
    ((100 + 2 * DIST_H,) * 2, torch.float64, True)]
DIST_SWEEP3_SHAPES = [
    ((N_3D // 2 + 2 * DIST_H,) * 3, torch.float32, False),
    ((N_3D // 4 + 2 * DIST_H,) * 3, torch.float32, True),
    ((N_CEDAR3 // 2 + 2 * DIST_H,) * 3, torch.float64, False),
    ((N_CEDAR3 // 4 + 2 * DIST_H,) * 3, torch.float64, True)]
DIST_ORIGINS2 = ((-DIST_H, -DIST_H), (N_MAIN // 2 - DIST_H, -DIST_H),
                 (-7, 3))
DIST_ORIGINS3 = ((-DIST_H,) * 3, (N_3D // 2 - DIST_H, -DIST_H, -DIST_H),
                 (-7, 3, 1))
# a world's ranks share the one card, over gloo: every message goes
# through the host (comm.staged_bytes)
DIST_WORLD_TIMEOUT = 420
CEDAR_CONF2 = {"log": [], "solver": {
    "num-levels": 7, "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
    "tol": 1e-10, "max-iter": 10}}
CEDAR_CONF3 = {"log": [], "solver": {"tol": 1e-9, "max-iter": 30}}
DIST_CYCLES = 5
V11 = {"nrelax-pre": 1, "nrelax-post": 1}
LINEXY = {"relaxation": "line-xy", "cycle": V11, "tol": 1e-30,
          "max-iter": 4}
ML = {"ml-relax": {"enabled": True}}
# the (2, 2) world's line and periodic runs: key -> (operator, kind, conf,
# n, dtype, whether its ms a cycle is timed); "f64_*": phase 4k's gates,
# the others phase 5j's full-width paths
DIST_RUNS2 = {
    "linexy_ml": (gallery.fe, NinePt,
                  {"log": [], "solver": {**LINEXY, **ML}}, N_LINES,
                  torch.float32, True),
    "linexy": (gallery.fe, NinePt, {"log": [], "solver": LINEXY}, N_LINES,
               torch.float32, True),
    "per_xy": (periodic_grid(gallery.poisson, XY), FivePt,
               {"log": [], **periodic_conf(XY, definite=False, cycle=V11,
                                           tol=1e-30, **{"max-iter": 4})},
               N_MAIN, torch.float32, False),
    "per_linex": (periodic_grid(aniso_x, X), FivePt,
                  {"log": [], **periodic_conf(X, relaxation="line-x",
                                              cycle=V11, tol=1e-30,
                                              **{"max-iter": 4})},
                  N_LINES, torch.float32, False),
    "f64_lxy": (lambda nx, ny, dtype, device: gallery.diag_diffusion(
        nx, ny, 50.0, 1.0, dtype, device), FivePt,
        {"log": [], "solver": {"relaxation": "line-xy", "tol": 1e-8,
                               "max-iter": 25}}, 512, torch.float64, False),
    "f64_lxy_ml": (lambda nx, ny, dtype, device: gallery.diag_diffusion(
        nx, ny, 50.0, 1.0, dtype, device), FivePt,
        {"log": [], "solver": {"relaxation": "line-xy", "tol": 1e-8,
                               "max-iter": 25, **ML}}, 512, torch.float64,
        False),
    "f64_per_xy": (periodic_grid(gallery.poisson, XY), FivePt,
                   {"log": [], **periodic_conf(XY, definite=False, tol=1e-8,
                                               **{"max-iter": 30})},
                   256, torch.float64, False),
}
# the (2, 2, 2) world's periodic run: 3d_poisson_7pt_256 x-periodic
DIST_RUN3 = (periodic3(gallery.poisson3, X3), SevenPt,
             {"log": [], **periodic_conf(X3, tol=1e-30, **{"max-iter": 4})},
             N_3D, torch.float32, False)
# the SPIKE solve of 2d_fe_9pt_linexy_2048 f32 against the serial line
# sweep's factorisation: x within this share of max |x| after 4 cycles
SPIKE_RTOL32 = 1e-4


def phase_kernels_dist(errs: dict) -> dict:
    """K1 and K6 on the distributed paths' shard shapes at the origins of
    DIST_ORIGINS2 / 3 (-H on the first rank of an axis), bit-equal to
    their plain versions."""
    print("[3] K1 and K6 on shard shapes, origin -H and others",
          flush=True)
    e2 = e3 = 0.0
    for i, (shape, dtype, nine) in enumerate(DIST_SWEEP_SHAPES):
        so, q, b, kind = random_problem(shape, nine, dtype, 2000 + i)
        tag = f"{shape} {str(dtype).replace('torch.', '')} shard"
        _, e = compare_sweep(so, q, b, kind, "9pt" if nine else "5pt", tag,
                             origins=DIST_ORIGINS2)
        e2 = max(e2, e)
        del so, q, b
    for i, (shape, dtype, ts) in enumerate(DIST_SWEEP3_SHAPES):
        so, q, b, kind = random_problem3(shape, ts, dtype, 2100 + i)
        tag = f"{shape} {str(dtype).replace('torch.', '')} shard"
        _, e = compare_sweep3(so, q, b, kind, tag, origins=DIST_ORIGINS3)
        e3 = max(e3, e)
        del so, q, b
    errs["sweep2_dist"], errs["sweep3_dist"] = e2, e3
    return errs


def _dist_cycle(s, cycle, bb, xb) -> tuple:
    """One counted cycle of a distributed solver on this rank's blocks:
    the kernels' launches and the communication."""
    torch.cuda.synchronize()
    reset_counts()
    comm.reset()
    xb, r = cycle.cycle_residual(s.levels, s.kinds, xb, bb, s.settings,
                                 s.periodic, dist=s.dist)
    float(r)
    return xb, dist_counts(), comm.counts()


def _dist_ms(s, cycle, bb, xb, ncycles=DIST_CYCLES) -> float:
    """ms a cycle over ``ncycles`` eager cycles (each reads its norm
    back), the ranks started together."""
    import torch.distributed as tdist

    torch.cuda.synchronize()
    tdist.barrier()
    t0 = time.perf_counter()
    for _ in range(ncycles):
        xb, r = cycle.cycle_residual(s.levels, s.kinds, xb, bb, s.settings,
                                     s.periodic, dist=s.dist)
        float(r)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ncycles * 1e3


def _line_sweep_ms(s, bb, xb, reps: int = 5) -> dict:
    """ms of one zebra sweep (both colours) of level 0 along each line
    axis of a distributed solver, by the path it takes there (the SPIKE
    solve or the gather), the ranks started together."""
    import torch.distributed as tdist

    out = {}
    for axis in ("x", "y"):
        if (0, axis) not in s.dist.spike and (
                0, 0 if axis == "x" else 1) not in s.dist._line_so:
            continue
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            s.dist.line_relax(0, axis, s.kinds[0], xb, bb, "down",
                              s.settings.ml_relax_enabled)
        torch.cuda.synchronize()
        path = "spike" if (0, axis) in s.dist.spike else "gather"
        out[f"{axis} {path}"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def _dist_run(rank, cls, cycle, so, kind, conf, b, mesh, full: bool,
              timed: bool = True):
    """Setup, solve and (``full``) one counted cycle and (``timed``) the
    ms a cycle of a distributed solver on this rank."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_counts()
    comm.reset()
    s = cls(so, kind, copy_conf(conf), mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x = s.solve(b)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {"setup_s": t1 - t0, "solve_s": t2 - t1, "history": s.history,
           "specs": s.specs, "solve_counts": dist_counts(),
           "solve_comm": comm.counts(), "finite": bool(torch.isfinite(
               x).all()), "shape": tuple(x.shape)}
    if rank == 0:
        out["x"] = x.cpu()
    out["spike"] = sorted(s.dist.spike)
    if full:
        bb, xb = s._block(b), s._block(x)
        xb, out["cycle_counts"], out["cycle_comm"] = _dist_cycle(
            s, cycle, bb, xb)
        if timed:
            out["ms"] = _dist_ms(s, cycle, bb, xb)
            if s.dist.spike or s.dist._line_so:
                out["line_ms"] = _line_sweep_ms(s, bb, xb)
    return s, x, out


def copy_conf(conf: dict) -> dict:
    return json.loads(json.dumps(conf))


def dist_world2(rank: int) -> dict:
    """The 2D distributed path on a (2, 2) gloo world, each rank on the
    card: Cedar's 400² float64 gate (phase 4j) and the 4096² float32
    V(1,1) path (phase 5i)."""
    mesh = make_mesh(2, shape=(2, 2), device=DEV)
    out = {"backend": mesh.backend, "staged": mesh.staged}
    so = gallery.poisson(400, 400, torch.float64, DEV)
    b = gallery.poisson_rhs(400, 400, torch.float64, DEV)
    s, x, out["gate"] = _dist_run(rank, DistSolver2, cycle2, so, FivePt,
                                  CEDAR_CONF2, b, mesh, False)
    out["gate"]["err"] = float((x - gallery.poisson_solution(
        400, 400, torch.float64, DEV)).abs().max())
    del s, x, so, b
    n = N_MAIN
    so = gallery.poisson(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    conf = {"log": [], "solver": {"cycle": {"nrelax-pre": 1,
                                            "nrelax-post": 1},
                                  "tol": 1e-30, "max-iter": 4}}
    _, _, out["full"] = _dist_run(rank, DistSolver2, cycle2, so, FivePt,
                                  conf, b, mesh, True)
    del so, b
    for key, (make, kind, conf, n, dtype, timed) in DIST_RUNS2.items():
        so = make(n, n, dtype, DEV)
        b = periodic_rhs(conf, n, n, dtype, DEV)
        _, _, out[key] = _dist_run(rank, DistSolver2, cycle2, so, kind,
                                   conf, b, mesh, True, timed)
        del so, b
        torch.cuda.empty_cache()
    return out


def dist_world3(rank: int) -> dict:
    """The 3D distributed path on a (2, 2, 2) gloo world, each rank on
    the card: Cedar's 200³ float64 test (phase 4j) and
    ``3d_poisson_7pt_256`` float32 (phase 5i)."""
    mesh = make_mesh(3, shape=(2, 2, 2), device=DEV)
    out = {"backend": mesh.backend, "staged": mesh.staged}
    n = N_CEDAR3
    so = gallery.poisson3(n, n, n, torch.float64, DEV)
    b = gallery.poisson3_rhs(n, n, n, torch.float64, DEV)
    s, x, out["gate"] = _dist_run(rank, DistSolver3, cycle3, so, SevenPt,
                                  CEDAR_CONF3, b, mesh, False)
    out["gate"]["rnorm"] = float(stencil3.residual(so, x, b,
                                                   SevenPt).norm())
    out["gate"]["err"] = float((x - gallery.poisson3_solution(
        n, n, n, torch.float64, DEV)).abs().max())
    del s, x, so, b
    n = N_3D
    so = gallery.poisson3(n, n, n, torch.float32, DEV)
    b = gallery.poisson3_rhs(n, n, n, torch.float32, DEV)
    conf = {"log": [], "solver": {"tol": 1e-30, "max-iter": 4}}
    _, _, out["full"] = _dist_run(rank, DistSolver3, cycle3, so, SevenPt,
                                  conf, b, mesh, True)
    del so, b
    make, kind, conf, n, dtype, timed = DIST_RUN3
    so = make(n, n, n, dtype, DEV)
    b = periodic_rhs3(conf, (n, n, n), dtype, DEV)
    _, _, out["per_x3"] = _dist_run(rank, DistSolver3, cycle3, so, kind,
                                    conf, b, mesh, True, timed)
    del so, b
    dist_world3_planes(rank, mesh, out)
    return out


def dist_world_nccl(rank: int) -> dict:
    """A world of one over NCCL: the 400² float64 gate, its norm's
    all-reduce on the card."""
    mesh = make_mesh(2, shape=(1, 1), device=DEV)
    so = gallery.poisson(400, 400, torch.float64, DEV)
    b = gallery.poisson_rhs(400, 400, torch.float64, DEV)
    _, _, out = _dist_run(rank, DistSolver2, cycle2, so, FivePt,
                          CEDAR_CONF2, b, mesh, False)
    out["backend"] = mesh.backend
    return out


def _serial(cls, so, kind, conf):
    """The serial solve on the card with the dense cycle (the distributed
    solvers' cycle), through the solver's captured graphs."""
    conf = {**copy_conf(conf), "kernels": {"fine-split": False}}
    return cls(so, kind, conf)


def _check_dist(what: str, got: dict, want_x, want_hist) -> None:
    x = got["x"].to(DEV)
    if not torch.equal(x, want_x):
        err = float((x - want_x).abs().max())
        raise AssertionError(f"{what}: x differs from the serial solve on "
                             f"the card ({err:.3e})")
    if len(got["history"]) != len(want_hist):
        raise AssertionError(f"{what}: {len(got['history'])} cycles, serial "
                             f"{len(want_hist)}")
    # the norm's partial sums are added in another order
    np.testing.assert_allclose(got["history"], want_hist,
                               rtol=NORM_RTOL[x.dtype])


def _world(fn, nranks: int, backend: str = "gloo") -> list:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(fn, nranks, backend=backend, timeout=DIST_WORLD_TIMEOUT,
                    init_dir=tmp, threads=None)
    print(f"  world of {nranks} ({backend}) {fn.__name__}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res


def phase_dist_gates() -> dict:
    """4j: Cedar's 400² float64 history through DistSolver2 on a (2, 2)
    gloo world, x bit for bit against Solver2 with the dense cycle on the
    card; Cedar's 200³ float64 test through DistSolver3 on (2, 2, 2), x bit
    for bit against Solver3 (dense); a world of one over NCCL equal to
    Solver2 bit for bit.  Also runs phase 4k's and phase 5i's and 5j's
    runs in the same worlds (their results are returned, with the serial
    references on the card)."""
    print("[4j] distributed gates: 4 and 8 processes sharing the card over "
          "gloo (host-staged messages), 1 over NCCL", flush=True)
    so = gallery.poisson(400, 400, torch.float64, DEV)
    b = gallery.poisson_rhs(400, 400, torch.float64, DEV)
    s2 = _serial(Solver2, so, FivePt, CEDAR_CONF2)
    x2 = s2.solve(b)
    n = N_CEDAR3
    so3 = gallery.poisson3(n, n, n, torch.float64, DEV)
    b3 = gallery.poisson3_rhs(n, n, n, torch.float64, DEV)
    s3 = _serial(Solver3, so3, SevenPt, CEDAR_CONF3)
    x3 = s3.solve(b3)
    full2 = _serial(Solver2, gallery.poisson(N_MAIN, N_MAIN, torch.float32,
                                             DEV), FivePt, {
        "log": [], "solver": {"cycle": {"nrelax-pre": 1, "nrelax-post": 1},
                              "tol": 1e-30, "max-iter": 4}})
    x_full2 = full2.solve(gallery.poisson_rhs(N_MAIN, N_MAIN, torch.float32,
                                              DEV))
    hist_full2 = full2.history
    del full2
    full3 = _serial(Solver3, gallery.poisson3(N_3D, N_3D, N_3D,
                                              torch.float32, DEV), SevenPt,
                    {"log": [], "solver": {"tol": 1e-30, "max-iter": 4}})
    x_full3 = full3.solve(gallery.poisson3_rhs(N_3D, N_3D, N_3D,
                                               torch.float32, DEV))
    hist_full3 = full3.history
    del full3, so, so3
    refs = {}
    for key, (make, kind, conf, n, dtype, _) in DIST_RUNS2.items():
        s = _serial(Solver2, make(n, n, dtype, DEV), kind, conf)
        refs[key] = (s.solve(periodic_rhs(conf, n, n, dtype, DEV)),
                     s.history)
        del s
    make, kind, conf, n, dtype, _ = DIST_RUN3
    s = _serial(Solver3, make(n, n, n, dtype, DEV), kind, conf)
    refs["per_x3"] = (s.solve(periodic_rhs3(conf, (n, n, n), dtype, DEV)),
                      s.history)
    del s
    for key, (make, kind, conf, n, dtype, _) in DIST_PLANE_RUNS.items():
        s = _serial(Solver3, make(n, n, n, dtype, DEV), kind, conf)
        refs[key] = (s.solve(gallery.poisson3_rhs(n, n, n, dtype, DEV)),
                     s.history)
        del s
    torch.cuda.empty_cache()

    w2 = _world(dist_world2, 4)
    g = w2[0]["gate"]
    print(f"  2D: backend {w2[0]['backend']}, host-staged "
          f"{w2[0]['staged']}; specs {g['specs']}", flush=True)
    print(f"  400^2 history: {' '.join(f'{h:g}' for h in g['history'])}; "
          f"error {g['err']:g}; setup {g['setup_s']:.2f} s, solve "
          f"{g['solve_s']:.2f} s", flush=True)
    np.testing.assert_allclose(g["history"], CEDAR_HISTORY, rtol=2e-5)
    np.testing.assert_allclose(g["err"], CEDAR_ERROR, rtol=1e-4)
    _check_dist("400^2 DistSolver2", g, x2, s2.history)
    require_launched(g["solve_counts"], ("sweep2_dist", "restrict2",
                                         "interp_add2"), "400^2 dist gate")
    if not (w2[0]["backend"] == "gloo" and w2[0]["staged"]):
        raise AssertionError("the 2D world is not gloo with host staging")

    w3 = _world(dist_world3, 8)
    g = w3[0]["gate"]
    print(f"  3D: specs {g['specs']}; history "
          f"{' '.join(f'{h:.6g}' for h in g['history'])}; |b - A x|_2 = "
          f"{g['rnorm']:.4e}, |x - x*|_inf = {g['err']:.6g}; setup "
          f"{g['setup_s']:.2f} s, solve {g['solve_s']:.2f} s", flush=True)
    if not (g["rnorm"] < 1e-8 and g["err"] < 1e-4):
        raise AssertionError("Cedar 3D test through DistSolver3 failed")
    _check_dist("200^3 DistSolver3", g, x3, s3.history)
    require_launched(g["solve_counts"], ("sweep3_dist", "restrict3",
                                         "interp_add3"), "200^3 dist gate")

    w1 = _world(dist_world_nccl, 1, "nccl")
    print(f"  world of one over {w1[0]['backend']}: history "
          f"{' '.join(f'{h:g}' for h in w1[0]['history'])}", flush=True)
    if w1[0]["backend"] != "nccl":
        raise AssertionError("the world of one is not NCCL")
    _check_dist("400^2 DistSolver2 over NCCL", w1[0], x2, s2.history)
    return {"w2": w2, "w3": w3, "x_full2": x_full2, "hist_full2": hist_full2,
            "x_full3": x_full3, "hist_full3": hist_full3, "refs": refs}


def phase_dist_full(worlds: dict) -> dict:
    """5i: the 4096² float32 5-point V(1,1) path on a (2, 2) world and
    ``3d_poisson_7pt_256`` on (2, 2, 2) (run in phase 4j's worlds): per
    cycle the exchanges, bytes, gathers, reductions, host-staged bytes,
    K1 and K6 launches a rank and ms a cycle; x bit for bit against the
    serial dense solve on the card."""
    print("[5i] distributed paths at full width: N processes sharing ONE "
          "card over gloo (host-staged), not a multi-GPU figure", flush=True)
    out = {}
    for key, name, n, xs, hs, k in (
            ("w2", f"{N_MAIN}^2 5pt f32 V(1,1) (2,2)", N_MAIN,
             worlds["x_full2"], worlds["hist_full2"], "sweep2_dist"),
            ("w3", f"3d_poisson_7pt_256 f32 (2,2,2)", N_3D,
             worlds["x_full3"], worlds["hist_full3"], "sweep3_dist")):
        res = worlds[key]
        f = res[0]["full"]
        _check_dist(name, f, xs, hs)
        for r, w in enumerate(res):
            if not (w["full"]["finite"] and w["full"]["shape"] == xs.shape):
                raise AssertionError(f"{name}: rank {r} result")
        cc, cm = f["cycle_counts"], f["cycle_comm"]
        print(f"  {name}: specs {f['specs']}; setup {f['setup_s']:.2f} s, "
              f"solve (4 cycles) {f['solve_s']:.2f} s; history "
              f"{' '.join(f'{h:.4g}' for h in f['history'])}", flush=True)
        print(f"    a cycle on rank 0: {cm['exchanges']} exchanges, "
              f"{cm['exchange_bytes']} B sent, {cm['gathers']} gathers "
              f"({cm['gather_bytes']} B), {cm['reductions']} reductions, "
              f"{cm['staged_bytes']} B host-staged; K1 {cc['sweep2_dist']}, "
              f"K6 {cc['sweep3_dist']} launches", flush=True)
        print(f"    ms a cycle ({DIST_CYCLES} eager cycles, ranks "
              f"together): " + ", ".join(f"rank {r} {w['full']['ms']:.2f}"
                                         for r, w in enumerate(res)),
              flush=True)
        require_launched(cc, (k,), name)
        out[k] = f["solve_counts"][k]
        out[k + " ms"] = f["ms"]
    return out


def phase_times_dist() -> dict:
    """K1 and K6 on the full-size shards (4096² on (2, 2): (2064, 2064)
    5-point f32; 256³ on (2, 2, 2): 144³ 7-point f32) at origin -H, DOWN,
    kernel against plain, with their bounds."""
    print("[6] K1 and K6 on full-size shards at origin -H (plain, kernel, "
          "kernel, plain)", flush=True)
    n2 = N_MAIN // 2 + 2 * DIST_H
    n3 = N_3D // 2 + 2 * DIST_H
    so, q, b, kind = random_problem((n2, n2), False, torch.float32, 2200)
    s3, q3, b3, k3 = random_problem3((n3,) * 3, False, torch.float32, 2201)
    o2, o3 = (-DIST_H,) * 2, (-DIST_H,) * 3
    out = time_turns({
        "sweep2_dist": (
            lambda: cuda2.sweep_plain(so, q, b, kind, "down", origin=o2),
            lambda: cuda2.sweep(so, q, b, kind, "down", origin=o2)),
        "sweep3_dist": (
            lambda: cuda3.sweep_plain(s3, q3, b3, k3, "down", origin=o3),
            lambda: cuda3.sweep(s3, q3, b3, k3, "down", origin=o3)),
    })
    e = 4
    work = {"sweep2_dist": ((3 + 3) * n2 * n2 * e, 10 * n2 * n2),
            "sweep3_dist": ((4 + 3) * n3 ** 3 * e, 14 * n3 ** 3)}
    return {k: out[k] + work[k] for k in work}


# -- line relaxation and periodic axes under a mesh, kernels.backend xla
# (phases 3, 4k, 4l, 5j, 6)

# K4 on the shapes of the distributed line paths: the gathered windows of
# 2d_fe_9pt_linexy_2048 on (2, 2) (whole x-lines by the block's columns
# and H more on each side, and the y-lines' transpose), cyclic x-lines of
# the 2048² x-periodic line-x, the SPIKE interior systems of its level 0
# (1022 rows by one colour's 512 lines) and of the 512² f64 gate, and the
# f64 gate's window
DIST_LINE_SHAPES = [
    ((N_LINES, N_LINES // 2 + 2 * DIST_H), torch.float32, True, (0, 0)),
    ((N_LINES // 2 + 2 * DIST_H, N_LINES), torch.float32, True, (0, 0)),
    ((N_LINES, N_LINES // 2 + 2 * DIST_H), torch.float32, False, (1, 0)),
    ((N_LINES // 2 - 2, N_LINES // 4), torch.float32, False, (0, 0)),
    ((254, 128), torch.float64, False, (0, 0)),
    ((512, 256 + 2 * DIST_H), torch.float64, False, (0, 0)),
]


def phase_kernels_dist_lines(errs: dict) -> dict:
    """K4 on the distributed line paths' shapes (:data:`DIST_LINE_SHAPES`),
    and K1 and K6 with a periodic axis that the level replicates beside an
    origin on a partitioned one (the wrap of the replicated axis in the
    kernel, the other's in the halo; odd extents take the Jacobi phases),
    bit-equal to their plain versions."""
    print("[3] K4 on gathered line windows and SPIKE interiors; K1 and K6 "
          "periodic with an origin", flush=True)
    for i, (shape, dtype, nine, per) in enumerate(DIST_LINE_SHAPES):
        per = tuple(bool(a) for a in per)
        so, q, b, kind = random_periodic_problem(shape, nine, dtype,
                                                 2300 + i, per)
        tag = f"{shape} {str(dtype).replace('torch.', '')} dist"
        key = "line2_periodic" if any(per) else "line2"
        errs[key] = max(errs[key], compare_lines(
            so, q, b, kind, "9pt" if nine else "5pt", tag, per))
        del so, q, b
    for i, (shape, dtype, nine) in enumerate((
            ((63, 48), torch.float64, False), ((64, 80), torch.float32,
                                               True))):
        per = (True, False)
        so, q, b, kind = random_periodic_problem(shape, nine, dtype,
                                                 2310 + i, per)
        name, e = compare_sweep(so, q, b, kind, "9pt" if nine else "5pt",
                                f"{shape} dist", per,
                                origins=((0, -DIST_H), (0, 3)))
        errs[name + "_periodic"] = max(errs[name + "_periodic"], e)
    for i, (shape, dtype, ts) in enumerate((
            ((21, 24, 24), torch.float64, False),
            ((32, 24, 24), torch.float32, True))):
        per = (True, False, False)
        so, q, b, kind = random_periodic_problem3(shape, ts, dtype,
                                                  2320 + i, per)
        name, e = compare_sweep3(so, q, b, kind, f"{shape} dist", per,
                                 origins=((0, -DIST_H, -DIST_H), (0, 3, 1)))
        errs[name] = max(errs[name], e)
    return errs


def _model(res: dict, n: int, ndim: int, conf: dict, kind,
           itemsize: int) -> dict:
    """tools/dist_comm.py's prediction of one cycle on rank 0 of the run
    ``res`` (its specs)."""
    from cedar_tpu_torch.solver import solver2, solver3

    sm = solver2 if ndim == 2 else solver3
    st = conf["solver"]
    shapes = sm.level_shapes(*(n,) * ndim, len(res["specs"]))
    pts = {FivePt: 5, NinePt: 9, SevenPt: 7, TwentySevenPt: 27}[kind]
    return dist_comm.predict(
        shapes, res["specs"], (2,) * ndim, itemsize,
        st.get("cycle", {}).get("nrelax-pre", 2),
        st.get("cycle", {}).get("nrelax-post", 1),
        {5: 2, 7: 2, 9: 4, 27: 8}[pts], 4 if ndim == 2 else 8,
        st.get("relaxation", "point"),
        st.get("ml-relax", {}).get("enabled", False),
        conf.get("grid", {}).get("periodic"))


def _report_dist(name: str, res: list, key: str, ref, n: int, ndim: int,
                 conf: dict, kind, exact: bool = True) -> dict:
    """Check one distributed run of a world (``res``: its ranks' results
    under ``key``) against its serial reference on the card (bit for bit,
    or for the f32 SPIKE solve within :data:`SPIKE_RTOL32` of max |x|, the
    same cycle count), print its counted cycle beside the model's and its
    ms; returns rank 0's result."""
    f = res[0][key]
    x_ser, hist_ser = ref
    if exact:
        _check_dist(name, f, x_ser, hist_ser)
    else:
        x = f["x"].to(DEV)
        err = float((x - x_ser).abs().max())
        scale = float(x_ser.abs().max())
        print(f"  {name}: max |x - x_serial| {err:.4e} = "
              f"{err / scale:.3e} of max |x|", flush=True)
        if not err <= SPIKE_RTOL32 * scale:
            raise AssertionError(f"{name}: x off the serial solve by "
                                 f"{err / scale:.3e} of max |x|")
        if len(f["history"]) != len(hist_ser):
            raise AssertionError(f"{name}: cycle count differs")
    for r, w in enumerate(res):
        if not (w[key]["finite"] and w[key]["shape"] == x_ser.shape):
            raise AssertionError(f"{name}: rank {r} result")
    cm = f["cycle_comm"]
    model = _model(f, n, ndim, conf, kind, x_ser.element_size())
    print(f"  {name}: specs {f['specs']}; SPIKE on {f['spike']}; setup "
          f"{f['setup_s']:.2f} s, solve {f['solve_s']:.2f} s; history "
          f"{' '.join(f'{h:.4g}' for h in f['history'])}", flush=True)
    print(f"    a cycle on rank 0: {cm['exchanges']} exchanges "
          f"({cm['wrap_exchanges']} along a periodic axis), "
          f"{cm['exchange_bytes']} B sent, {cm['gathers']} gathers "
          f"({cm['line_gathers']} of lines, {cm['spike_gathers']} SPIKE "
          f"interfaces; {cm['gather_bytes']} B), {cm['reductions']} "
          f"reductions, {cm['staged_bytes']} B host-staged; K4 "
          f"{f['cycle_counts']['line2']}, K1 {f['cycle_counts']['sweep2_dist']}"
          f", K6 {f['cycle_counts']['sweep3_dist']} launches", flush=True)
    print(f"    model (tools/dist_comm.py): {model}", flush=True)
    if "ms" in f:
        print(f"    ms a cycle ({DIST_CYCLES} eager cycles, ranks "
              f"together): " + ", ".join(f"rank {r} {w[key]['ms']:.2f}"
                                         for r, w in enumerate(res)),
              flush=True)
    if "line_ms" in f:
        print("    ms a level-0 sweep (two colours), rank 0: " + ", ".join(
            f"{k} {v:.2f}" for k, v in f["line_ms"].items()), flush=True)
    return f


def phase_dist_f64_gates(worlds: dict) -> None:
    """4k: float64 gates of the (2, 2) world (run in phase 4j): 512²
    line-xy ``diag_diffusion(50, 1)`` within 1e-10 of the serial solve
    with SPIKE on level 0 for both axes; the same with ml-relax (the
    gather) bit for bit; 256² doubly periodic (indefinite) bit for bit.
    Cedar's 400² history through DistSolver2 is phase 4j's."""
    print("[4k] distributed f64 gates: SPIKE, the line gather, the wrap",
          flush=True)
    w2, refs = worlds["w2"], worlds["refs"]
    for key in ("f64_lxy", "f64_lxy_ml", "f64_per_xy"):
        make, kind, conf, n, dtype, _ = DIST_RUNS2[key]
        f = w2[0][key]
        x_ser, hist_ser = refs[key]
        if key == "f64_lxy":
            err = float((f["x"].to(DEV) - x_ser).abs().max())
            print(f"  {key}: max |x - x_serial| {err:.3e}; SPIKE on "
                  f"{f['spike']}; {len(f['history'])} cycles (serial "
                  f"{len(hist_ser)})", flush=True)
            if not err < 1e-10:
                raise AssertionError(f"{key}: x off the serial solve")
            if not {(0, "x"), (0, "y")} <= set(f["spike"]):
                raise AssertionError(f"{key}: level 0 takes no SPIKE")
        else:
            _check_dist(key, f, x_ser, hist_ser)
            print(f"  {key}: x bit for bit the serial solve, "
                  f"{len(f['history'])} cycles", flush=True)
        require_launched(f["solve_counts"], (
            "line2",) if "lxy" in key else (("sweep2_dist",)), key)


def phase_dist_lines_full(worlds: dict) -> dict:
    """5j: the line and periodic paths at full width on the (2, 2) and
    (2, 2, 2) worlds (run in phase 4j): ``2d_fe_9pt_linexy_2048`` f32
    V(1,1) with ml-relax (the gather on every level, x bit for bit the
    serial ml-relax solve) and by default (SPIKE where eligible, x within
    :data:`SPIKE_RTOL32`), each with its counted cycle, ms a cycle and ms
    a level-0 sweep; 4096² doubly periodic and 2048² x-periodic line-x
    f32 V(1,1), and ``3d_poisson_7pt_256`` x-periodic, x bit for bit.
    Returns K4's launches in the distributed solves."""
    print("[5j] distributed lines and periodic axes at full width: N "
          "processes sharing ONE card over gloo (host-staged), not a "
          "multi-GPU figure", flush=True)
    refs, out = worlds["refs"], {"line2": 0}
    for key, ndim in (("linexy_ml", 2), ("linexy", 2), ("per_xy", 2),
                      ("per_linex", 2), ("per_x3", 3)):
        res = worlds["w2" if ndim == 2 else "w3"]
        make, kind, conf, n, dtype, _ = (DIST_RUNS2[key] if ndim == 2
                                         else DIST_RUN3)
        f = _report_dist(f"{key} {n}^{ndim}", res, key, refs[key], n, ndim,
                         conf, kind, exact=key != "linexy")
        need = ("line2",) if "line" in key else (
            "sweep2_dist" if ndim == 2 else "sweep3_dist",)
        require_launched(f["cycle_counts"], need, key)
        if key == "linexy" and not {(0, "x"), (0, "y")} <= set(f["spike"]):
            raise AssertionError("linexy: level 0 takes no SPIKE")
        out["line2"] += f["solve_counts"]["line2"]
    return out


def _xla_cycle_launches(s, b) -> dict:
    """The launches and plain calls of one captured cycle of ``s`` under
    its own backend (a fresh capture, as :func:`one_cycle_launches`)."""
    with backend.using(s.settings.kernel_backend):
        g = graph.CycleGraphs(cycle2, s.levels, s.kinds, s.settings,
                              **s.graphs.cycle_kw).graph("solve", b)
        g.b.copy_(b)
        g.warm()
        reset_counts()
        g.capture()
        torch.cuda.synchronize()
        one = {k: v for k, v in counts().items() if v}
        del g
    return one


def phase_backend_xla() -> None:
    """4l: ``kernels.backend: xla`` (fault F1): the 4096² f32 5-point
    V(1,1) solve through the solver's graph, x bit for bit the default
    backend's dense cycle (``kernels.fine-split: false``), no kernel of
    the table launched in a captured cycle (its plain versions instead),
    and its graph ms beside the kernels' in alternating pairs."""
    n = N_MAIN
    print(f"[4l] kernels.backend xla: {n}^2 5pt f32 V(1,1), the plain "
          "versions on the card", flush=True)
    so = gallery.poisson(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    solver = {"cycle": V11, "tol": 1e-30, "max-iter": 4}
    sk = Solver2(so, FivePt, {"log": [], "solver": solver,
                              "kernels": {"fine-split": False}})
    sx = Solver2(so, FivePt, {"log": [], "solver": solver,
                              "kernels": {"backend": "xla"}})
    if sx.settings.fine_split:
        raise AssertionError("xla: the fused cycle is on")
    xk = sk.solve(b)
    reset_counts()
    xx = sx.solve(b)
    c = counts()
    if not torch.equal(xk, xx) or sk.history != sx.history:
        raise AssertionError("xla: x differs from the kernels' dense cycle "
                             f"({float((xk - xx).abs().max()):.3e})")
    one = _xla_cycle_launches(sx, b)
    launched = {k: v for k, v in one.items() if k in KERNELS}
    print(f"  xla: x bit for bit the kernels' dense cycle; history "
          f"{' '.join(f'{h:.6g}' for h in sx.history)}", flush=True)
    print(f"  xla: a captured cycle {one}", flush=True)
    if launched or any(c.get(k, 0) for k in KERNELS):
        raise AssertionError(f"xla launched kernels: {launched}")
    if not one.get("sweep2_plain"):
        raise AssertionError("xla: no plain sweep in the captured cycle")
    med = graph_pairs({"kernels": (sk, b, xk), "xla": (sx, b, xx)})
    print(f"  graph ms a cycle: kernels {med['kernels']:.4f}, xla "
          f"{med['xla']:.4f} ({med['xla'] / med['kernels']:.2f}x)",
          flush=True)
    del sk, sx, so, b
    torch.cuda.empty_cache()


def phase_times_dist_lines() -> None:
    """K4 on the distributed line paths' full-size shapes (the gathered
    x-line window of ``2d_fe_9pt_linexy_2048`` on (2, 2), 9-point, and
    the level-0 SPIKE interior, 5-point; DOWN, f32), kernel against plain,
    with their bounds (printed; the table's line2 entry keeps its
    shape)."""
    print("[6] K4 on the distributed line shapes (plain, kernel, kernel, "
          "plain)", flush=True)
    cases, work = {}, {}
    e = 4
    for name, shape, nine in (
            ("K4 window x", (N_LINES, N_LINES // 2 + 2 * DIST_H), True),
            ("K4 SPIKE interior", (N_LINES // 2 - 2, N_LINES // 4), False)):
        so, q, b, kind = random_problem(shape, nine, torch.float32, 2400)
        m, k = shape
        cases[name] = (
            lambda so=so, q=q, b=b, kind=kind: cuda_lines2.line_x_plain(
                so, q.clone(), b, kind, "down"),
            lambda so=so, q=q, b=b, kind=kind: cuda_lines2.line_x(
                so, q.clone(), b, kind, "down"))
        planes = 5 if nine else 3
        work[name] = ((planes + 3) * m * k * e,
                      ((12 if nine else 4) + 12 * pcr_steps(m) + 8) * m * k)
    out = time_turns(cases, slow=tuple(cases))
    for name in cases:
        ms, plain_ms = out[name]
        bms, by = bound(*work[name], torch.float32)
        print(f"  {name}: kernel {ms:.4f} ms (with q's copy), plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)


# -- plane relaxation under a mesh (phases 3, 4m, 5k, 6): DistSolver3 with
# plane-xy and plane-xyz, each rank's planes gathered whole in-plane and
# relaxed by the batched plane cycles (K10, K1/K4/K5 batched, K2/K3)

# the (2, 2, 2) world's plane runs: key -> (operator, kind, conf, n,
# dtype, whether a cycle is counted and timed); "f64_*": phase 4m's gates,
# "planes_128": phase 5k's 3d_aniso_planexy_128 cell
DIST_PLANE_RUNS = {
    "f64_pxy": (aniso3, SevenPt, {"log": [], "solver": {
        "relaxation": "plane-xy", "tol": 1e-9, "max-iter": 10}}, 64,
        torch.float64, False),
    "f64_pxyz": (aniso3, SevenPt, {"log": [], "solver": {
        "relaxation": "plane-xyz", "tol": 1e-9, "max-iter": 10}}, 64,
        torch.float64, False),
    "planes_128": (aniso3, SevenPt, {"log": [], "solver": {
        "relaxation": "plane-xy", "cycle": V11, "tol": 1e-30,
        "max-iter": 4}}, N_PLANES, torch.float32, True),
}
# the batched kernels' odd batches (odd blocks along the plane axis give
# an odd count of a colour's planes)
DIST_PLANE_ODD = [((5, 20, 20), torch.float64), ((3, 40, 40), torch.float32),
                  ((9, 10, 10), torch.float32)]


def dist_plane_shapes(n: int, dtype) -> list:
    """The ``(B, n1, n2)`` batches of a rank's plane cycles of plane-xy on
    an ``n``³ grid on (2, 2, 2) (rank 0: each level's block along z, its
    planes of a colour, at every plane level but the coarsest), in
    ``dtype``: 32 planes of 128² down to 4 of 8² at 128³."""
    from cedar_tpu_torch.parallel.policy import level_specs
    from cedar_tpu_torch.solver import solver2, solver3

    shapes3 = solver3.level_shapes(n, n, n, solver3.compute_num_levels(
        n, n, n, 3))
    specs = level_specs(shapes3, (2, 2, 2), 8)
    out = []
    for (nx, ny, nz), spec in zip(shapes3[:-1], specs):
        nb = (nz // 2 if spec[2] is not None else nz) // 2
        levels2 = solver2.level_shapes(nx, ny, solver2.compute_num_levels(
            nx, ny, 3))
        out += [((nb, *s), dtype) for s in levels2[:-1]]
    return list(dict.fromkeys(out))


def compare_batched(shape, dtype, seed: int, errs: dict) -> int:
    """K10 (DOWN and UP, 2 sweeps, with and without the residual), the
    batched K1 (its plan's regime), K4 (x and y, DOWN and UP), K5, K2 and
    K3 on one batch of planes, 5- and 9-point, each bit-equal to its plain
    version; returns the number of comparisons."""
    n = 0
    tag = f"{shape} {str(dtype).replace('torch.', '')} rank batch"
    for nine in (False, True):
        so, q, b, kind = random_problem(shape, nine, dtype, seed + nine)
        pts = "9pt" if nine else "5pt"
        for updown in ("down", "up"):
            for res in (False, True):
                got = cuda_planes2.smooth(so, q.clone(), b, kind, updown, 2,
                                          res)
                want = cuda_planes2.smooth_plain(so, q.clone(), b, kind,
                                                 updown, 2, res)
                what = f"K10 line_xy2 {pts} {updown} x2 res={int(res)} {tag}"
                got, want = ((got, want) if res else ((got,), (want,)))
                errs["line_xy2"] = max(errs["line_xy2"], *(
                    compare(what, g, w, exact=True)
                    for g, w in zip(got, want)))
                n += len(got)
            for axis in ("x", "y"):
                kernel = (cuda_lines2.line_x if axis == "x"
                          else cuda_lines2.line_y)
                plain = (cuda_lines2.line_x_plain if axis == "x"
                         else cuda_lines2.line_y_plain)
                errs["line2_batched"] = max(errs["line2_batched"], compare(
                    f"K4 line2 batched {axis} {pts} {updown} {tag}",
                    kernel(so, q.clone(), b, kind, updown),
                    plain(so, q.clone(), b, kind, updown), exact=True))
                n += 1
        _, e = compare_sweep(so, q, b, kind, pts, tag, p=cuda2.plan(
            q.element_size(), nine, shape[1:]))
        errs["sweep2_batched"] = max(errs["sweep2_batched"], e)
        n += 12
        ci = interp2.setup_interp(so, kind)
        g = torch.Generator(device=DEV).manual_seed(seed + 7)
        qc = torch.randn((shape[0], ci.shape[-2] - 1, ci.shape[-1] - 1),
                         generator=g, device=DEV, dtype=dtype)
        errs["interp2_batched"] = max(errs["interp2_batched"], compare(
            f"K5 interp2 batched {pts} {tag}",
            cuda_transfer2.interp(ci, qc, shape),
            cuda_transfer2.interp_plain(ci, qc, shape), exact=True))
        errs["restrict2"] = max(errs["restrict2"], compare(
            f"K2 restrict2 batched {pts} {tag}",
            cuda_transfer2.restrict(ci, b),
            cuda_transfer2.restrict_plain(ci, b), exact=True))
        errs["interp_add2"] = max(errs["interp_add2"], compare(
            f"K3 interp_add2 batched {pts} {tag}",
            cuda_transfer2.interp_add(ci, so, qc, b, q.clone()),
            cuda_transfer2.interp_add_plain(ci, so, qc, b, q.clone()),
            exact=True))
        n += 3
        del so, q, b, ci, qc
    return n


def phase_kernels_dist_planes(errs: dict) -> dict:
    """K10, the batched K1, K4 and K5, and K2/K3 at the batches of a
    rank's plane cycles (:func:`dist_plane_shapes`: ``3d_aniso_planexy_
    128`` float32 and the 64³ gates float64 on (2, 2, 2)) and at odd
    batches (:data:`DIST_PLANE_ODD`), bit-equal to their plain versions."""
    print("[3] K10, batched K1/K4/K5, K2/K3 at the ranks' plane batches",
          flush=True)
    for k in ("line_xy2", *BATCHED_OF):
        errs.setdefault(k, 0.0)
    shapes = (dist_plane_shapes(N_PLANES, torch.float32)
              + dist_plane_shapes(64, torch.float64) + DIST_PLANE_ODD)
    n = sum(compare_batched(shape, dtype, 2500 + 10 * i, errs)
            for i, (shape, dtype) in enumerate(shapes))
    print(f"  {n} comparisons at {len(shapes)} batches, all bit-equal",
          flush=True)
    return errs


def _same_hier(a, b) -> bool:
    """Two batched 2D hierarchies (None for no plane) equal field by
    field."""
    if a is None or b is None:
        return a is None and b is None
    if len(a) != len(b):
        return False
    for la, lb in zip(a, b):
        for k in ("so", "recip", "ci", "sor_x", "sor_y", "ainv"):
            fa, fb = getattr(la, k), getattr(lb, k)
            if (fa is None) != (fb is None) or (
                    fa is not None and not torch.equal(fa, fb)):
                return False
        if not _same_hier(la.inner, lb.inner):
            return False
    return True


def _plane_setup_check(s, so, kind, conf) -> dict:
    """This rank's colour hierarchies against the serial solver's on the
    card cut to its planes, field by field, and their batched coarse
    solve (the last plane level's ``ainv``) against the serial one at the
    serial batch, on a random rhs."""
    from cedar_tpu_torch.ops import cg, planes3
    from cedar_tpu_torch.parallel import planes

    ser = _serial(Solver3, so, kind, conf)
    equal, err, n = True, 0.0, 0
    for (lvl, orient), ws in s.dist.planes.items():
        lay = s.layouts[lvl]
        p = planes3.PLANE_SPECS[orient][0]
        glob = ser.levels[lvl].planes[orient]
        want = planes.cut_colours(glob, lay.lo[p], lay.hi[p])
        for c, (hr, hw, hs) in enumerate(zip(ws.colours, want, glob)):
            equal &= _same_hier(hr, hw)
            n += 1
            if hr is None:
                continue
            g = torch.Generator(device=DEV).manual_seed(lvl)
            cb = torch.randn((hs[-1].ainv.shape[0], *hs[-1].so.shape[-2:]),
                             generator=g, device=DEV, dtype=so.dtype)
            first = (lay.lo[p] + planes3.colour_start(c, lay.lo[p]) - c) // 2
            nb = hr[-1].ainv.shape[0]
            got = cg.solve_cg(hr[-1].ainv,
                              cb[first:first + nb].contiguous())
            err = max(err, float((got - cg.solve_cg(hs[-1].ainv, cb)[
                first:first + nb]).abs().max()))
    del ser
    return {"equal": bool(equal), "coarse_err": err, "hierarchies": n}


def _plane_sweep_ms(s, bb, xb, reps: int = 5) -> float:
    """ms of one level-0 xy plane sweep (both colours) of a distributed
    solver, the ranks started together."""
    import torch.distributed as tdist

    torch.cuda.synchronize()
    tdist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        s.dist.plane_relax(0, s.kinds[0], xb, bb, "xy", "down", s.settings)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def dist_world3_planes(rank: int, mesh, out: dict) -> None:
    """The plane runs of the (2, 2, 2) world (:data:`DIST_PLANE_RUNS`):
    each solve with its launches and communication; the setup check
    (:func:`_plane_setup_check`) of the plane-xy gate and the cell; the
    cell's counted cycle, ms a cycle and ms a level-0 sweep."""
    for key, (make, kind, conf, n, dtype, full) in DIST_PLANE_RUNS.items():
        so = make(n, n, n, dtype, DEV)
        b = gallery.poisson3_rhs(n, n, n, dtype, DEV)
        s, x, r = _dist_run(rank, DistSolver3, cycle3, so, kind, conf, b,
                            mesh, full, False)
        if full:
            bb, xb = s._block(b), s._block(x)
            r["cycle_ms"] = _dist_ms(s, cycle3, bb, xb)
            r["sweep_ms"] = _plane_sweep_ms(s, bb, xb)
        if key != "f64_pxyz":
            r["setup_check"] = _plane_setup_check(s, so, kind, conf)
        out[key] = r
        del s, x, so, b
        torch.cuda.empty_cache()


def _require_plane_setup(name: str, res: list, key: str) -> None:
    for r, w in enumerate(res):
        sc = w[key]["setup_check"]
        if not sc["equal"] or sc["coarse_err"] != 0.0:
            raise AssertionError(f"{name}: rank {r}'s colour hierarchies or "
                                 f"coarse solve differ from the serial "
                                 f"ones cut to its planes ({sc})")
    print(f"  {name}: every rank's colour hierarchies ("
          f"{res[0][key]['setup_check']['hierarchies']} on rank 0) and "
          "their batched coarse solve bit for bit the serial ones cut to "
          "its planes", flush=True)


def phase_dist_planes_gates(worlds: dict) -> None:
    """4m: float64 gates of the (2, 2, 2) world (run in phase 4j): 64³
    ``diag_diffusion3(1, 1, 1e-3)`` plane-xy and plane-xyz to tol 1e-9, x
    bit for bit the serial solve on the card, the ranks' colour
    hierarchies and coarse solves bit for bit the serial ones."""
    print("[4m] distributed plane relaxation f64 gates (64^3 on (2,2,2))",
          flush=True)
    w3, refs = worlds["w3"], worlds["refs"]
    for key in ("f64_pxy", "f64_pxyz"):
        f = w3[0][key]
        _check_dist(key, f, *refs[key])
        for r, w in enumerate(w3):
            if not (w[key]["finite"]
                    and w[key]["shape"] == tuple(refs[key][0].shape)):
                raise AssertionError(f"{key}: rank {r} result")
        print(f"  {key}: x bit for bit the serial solve, "
              f"{len(f['history'])} cycles, history "
              f"{' '.join(f'{h:.4g}' for h in f['history'])}; setup "
              f"{f['setup_s']:.2f} s, solve {f['solve_s']:.2f} s",
              flush=True)
        if f["history"][-1] >= 1e-9:
            raise AssertionError(f"{key}: did not converge")
        require_launched(f["solve_counts"], ("line_xy2", "restrict2",
                                             "interp_add2"), key)
    _require_plane_setup("f64_pxy", w3, "f64_pxy")


def phase_dist_planes_full(worlds: dict) -> dict:
    """5k: ``3d_aniso_planexy_128`` float32 V(1,1) on the (2, 2, 2) world
    (run in phase 4j): x bit for bit the serial solve on the card, the
    counted cycle of rank 0 equal to tools/dist_comm.py's model (the
    exchanges, bytes, gathers, plane gathers, reductions and K10
    launches), ms a cycle and a level-0 sweep (host figures: 8 processes
    share the card over gloo).  Returns K10's launches in the cycle."""
    print("[5k] distributed plane relaxation at full width: 8 processes "
          "sharing ONE card over gloo (host-staged), not a multi-GPU "
          "figure", flush=True)
    res, key = worlds["w3"], "planes_128"
    make, kind, conf, n, dtype, _ = DIST_PLANE_RUNS[key]
    f = _report_dist(f"3d_aniso_planexy_128 {n}^3 (2,2,2)", res, key,
                     worlds["refs"][key], n, 3, conf, kind)
    _require_plane_setup(key, res, key)
    cm, cc = f["cycle_comm"], f["cycle_counts"]
    model = _model(f, n, 3, conf, kind, 4)
    for k in ("exchanges", "exchange_bytes", "gathers", "plane_gathers",
              "reductions"):
        if cm[k] != model[k]:
            raise AssertionError(f"{key}: {k} {cm[k]}, model {model[k]}")
    if cc["line_xy2"] != model["k10"]:
        raise AssertionError(f"{key}: K10 {cc['line_xy2']} a cycle, model "
                             f"{model['k10']}")
    print(f"  {key}: the counted cycle equals the model; K10 "
          f"{cc['line_xy2']} launches a cycle on rank 0 (serial cycle: "
          f"120), K2 {cc['restrict2']}, K3 {cc['interp_add2']}; ms a "
          f"cycle ({DIST_CYCLES} eager cycles) "
          + ", ".join(f"rank {r} {w[key]['cycle_ms']:.2f}"
                      for r, w in enumerate(res))
          + f"; ms a level-0 xy sweep, rank 0: {f['sweep_ms']:.2f}",
          flush=True)
    require_launched(cc, ("line_xy2", "restrict2", "interp_add2",
                          "restrict3", "interp_add3"), key)
    return {"line_xy2": cc["line_xy2"]}


def phase_times_dist_planes() -> None:
    """K10 (2 sweeps + the residual), the batched K1 (+ the residual), K4
    (x), K5, K2 and K3 at a rank's level-0 batch of
    ``3d_aniso_planexy_128`` on (2, 2, 2) (32 planes of 128², 5-point
    float32), kernel against plain in turns, with their bounds
    (printed)."""
    nb, n = 32, N_PLANES
    shape = (nb, n, n)
    print(f"[6] the rank's plane batch {shape} float32 (plain, kernel, "
          "kernel, plain)", flush=True)
    so, q, b, kind = random_problem(shape, False, torch.float32, 2600)
    ci = interp2.setup_interp(so, kind)
    nc = ci.shape[-1] - 1
    g = torch.Generator(device=DEV).manual_seed(2601)
    qc = torch.randn((nb, nc, nc), generator=g, device=DEV,
                     dtype=torch.float32)
    N, Nc, W = nb * n * n, nb * nc * nc, 8 * nb * (nc + 1) ** 2
    cases = {
        "line_xy2 x2 +res": (
            lambda: cuda_planes2.smooth_plain(so, q, b, kind, "down", 2,
                                              True),
            lambda: cuda_planes2.smooth(so, q, b, kind, "down", 2, True)),
        "sweep2_batched +res": (
            lambda: cuda2.sweep_plain(so, q, b, kind, "down", True),
            lambda: cuda2.sweep(so, q, b, kind, "down", True)),
        "line2_batched x": (
            lambda: cuda_lines2.line_x_plain(so, q, b, kind, "down"),
            lambda: cuda_lines2.line_x(so, q, b, kind, "down")),
        "interp2_batched": (
            lambda: cuda_transfer2.interp_plain(ci, qc, shape),
            lambda: cuda_transfer2.interp(ci, qc, shape)),
        "restrict2 batched": (
            lambda: cuda_transfer2.restrict_plain(ci, b),
            lambda: cuda_transfer2.restrict(ci, b)),
        "interp_add2 batched": (
            lambda: cuda_transfer2.interp_add_plain(ci, so, qc, b, q),
            lambda: cuda_transfer2.interp_add(ci, so, qc, b, q)),
    }
    # bytes and operations as phase_times_planes and phase_times_batched
    # count them (5-point: 3 stencil planes)
    work = {
        "line_xy2 x2 +res": (7 * N * 4,
                             (2 * 2 * (4 + 12 * pcr_steps(n) + 8) + 10) * N),
        "sweep2_batched +res": (7 * N * 4, 2 * 7 * N),
        "line2_batched x": (6 * N * 4, (4 + 12 * pcr_steps(n) + 8) * N),
        "interp2_batched": ((W + Nc + N) * 4, 4 * N),
        "restrict2 batched": ((W + N + Nc) * 4, 16 * Nc),
        "interp_add2 batched": ((W + Nc + 4 * N) * 4, 23 * N // 4),
    }
    out = time_turns(cases, slow=("line_xy2 x2 +res", "line2_batched x"))
    for k, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, torch.float32)
        print(f"  {k} {shape}: bound {bms:.4f} ms by {by}; kernel "
              f"{out[k][0]:.4f} ms (device {device_ms(cases[k][1]):.4f}), "
              f"plain {out[k][1]:.4f} ms", flush=True)
    del so, q, b, ci, qc


def pcr_steps(n: int, full: bool = False) -> int:
    """PCR steps of the line solve of a line of ``n`` points (log2 h;
    ``full``: at the full stride)."""
    return max(lines2.pcr_stride(n, full), 1).bit_length() - 1


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """The least time on the card, ms: the larger of the bytes over the HBM
    rate and the operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(phase, *args):
    """``phase(*args)``, its host seconds printed after it."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s)",
          flush=True)
    return out


def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    timed(phase_build)
    errs = timed(phase_kernels)
    errs = timed(phase_kernels3, errs)
    errs = timed(phase_kernels_planes, errs)
    errs = timed(phase_kernels_batched, errs)
    errs = timed(phase_kernels_fullpcr, errs)
    errs = timed(phase_transfers2, errs)
    errs = timed(phase_kernels_periodic, errs)
    errs = timed(phase_kernels_periodic3, errs)
    errs = timed(phase_kernels_fused, errs)
    errs = timed(phase_kernels_fused3, errs)
    errs = timed(phase_kernels_dist, errs)
    errs = timed(phase_kernels_dist_lines, errs)
    errs = timed(phase_kernels_dist_planes, errs)
    timed(phase_cedar_gate)
    timed(phase_fused_gate)
    timed(phase_f64_gates)
    timed(phase_cedar3)
    timed(phase_3d_gates)
    timed(phase_plane_gates)
    fcycle_periodic = timed(phase_periodic_gates)
    fcycle_periodic3 = timed(phase_periodic3_gates)
    timed(phase_cedar_gates)
    timed(phase_mlrelax_gates)
    timed(phase_graph_configs)
    worlds = timed(phase_dist_gates)
    timed(phase_dist_f64_gates, worlds)
    timed(phase_dist_planes_gates, worlds)
    timed(phase_backend_xla)
    launches = timed(phase_main_path)
    launches["sweep2_fused"] = timed(phase_main_variants)["sweep2_fused"]
    launches["line2"] = timed(phase_linexy_2048)["line2"]
    launches["interp2"] = timed(phase_fcycle_4096)["interp2"]
    launches.update(timed(phase_paths3))
    launches["line_xy2"] = timed(phase_planes_128)["line_xy2"]
    launches.update(timed(phase_periodic_full))
    launches.update(timed(phase_periodic3_full))
    launches.update(timed(phase_cedar_full))
    launches.update(timed(phase_mlrelax_full))
    dist_full = timed(phase_dist_full, worlds)
    timed(phase_dist_lines_full, worlds)
    timed(phase_dist_planes_full, worlds)
    launches["sweep2_dist"] = dist_full["sweep2_dist"]
    launches["sweep3_dist"] = dist_full["sweep3_dist"]
    # K5's and K9's periodic modes run in the periodic F-cycles (phases 4f
    # and 4g)
    launches["interp2_periodic"] = fcycle_periodic["interp2_periodic"]
    launches["interp3_periodic"] = fcycle_periodic3["interp3_periodic"]
    times = (timed(phase_times) | timed(phase_times3)
             | timed(phase_times_planes) | timed(phase_times_periodic)
             | timed(phase_times_periodic3) | timed(phase_times_batched)
             | timed(phase_times_fullpcr) | timed(phase_times_dist))
    timed(phase_times_dist_lines)
    timed(phase_times_dist_planes)
    timed(phase_times_levels)
    print(f"  (all phases: {time.perf_counter() - t0:.1f} s)", flush=True)
    table = []
    for name in KERNELS:
        ms, plain_ms, nbytes, flops = times[name]
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        # no single PyTorch call computes a variable-coefficient stencil
        # sweep or BoxMG transfer from these inputs: library_ms is null
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
