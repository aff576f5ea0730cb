#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. Phases:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernel build (``nvcc`` for sm_90a, from ``stepth_tpu_torch/csrc``);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (1080p, D=128 effective), on the smooth ``make_pair``
   scene and on the ``box`` edge scene:
   a. SAD: K1 at the 135×240 coarse level with D=16, K2 at the three refine
      levels (priors from the plain pipeline), each level's plan (K2 plan)
      against the plain plan of the same padded prior, K3 at 1080×1920;
   b. census (window 7, two planes): the census kernel at the four
      levels (one launch a pair, bit-equal to the plain census; its ms,
      device ms, plain ms and byte bound), K1 at the coarse level, K2 at
      the three levels, level 0 with the right view (``lr=True``, both
      outputs), the right-view emit on a synthetic buffer;
   c. K1 with SAD, D=128 and its LR check (K4) at 1080×1920 (``flagship``);
   d. K4 and K5 at 1080×1920 on the production maps and on a random map;
   e. at a small unaligned size, the branches the main paths do not take
      (SSD, uniqueness, windows 5 and 7, census windows 5 and 9, a row
      window ``g_row0``/``g_h`` in K1, K2 and K6 — negative ``g_row0`` and
      rows past ``g_h``, as a row shard's halo has them — R=4, the right
      view with R=4);
   f. the SGM kernels: K6 at the 135×240 coarse level (D=16, window 9, SAD
      and census) on both scenes and at 1080×1920 (D=64, window 5, SAD);
      K7 in each of the 8 directions, K8 and K9 (2 directions) at
      1080×1920 D=64; K7 and K8 of the coarse level; at 70×300, D=24 and
      D=144, census window 5, SSD, uniqueness and bf16 volumes;
   g. K11, the bilinear remap, through the 1080×1920 rectification maps of
      a calibrated, lens-distorted rig (both views, gray and 3 channels,
      fill 3.5), a 720×1280 output from the 1080×1920 source, the identity
      map (output equals input) and a map spiked with NaN, ±inf and
      far-away entries; beside it, ``grid_sample`` on the same view as a
      yardstick (``library_ms``; the port never calls it), and both timed
      on the device alone, in turns (``device_ms``);
   h. K10, the sharded relay's seeded scan: the 1080p D=64 volume of 3f
      split at rows 360 and 720, each of the six relayed directions (↓y,
      ↑y, ↘, ↙, ↗, ↖) scanned shard by shard through K10 against one
      continuous K7 scan (output) and its plain version (final carry); K10
      against its plain version on the middle shard from the relayed
      carry; at 70×300, D=24, D=144 and bf16;
   i. the edges of the redesigned kernels (``check_cost_front_edges``, then
      ``check_edges``): K6 on ``K6_EDGES`` (D from 1 to 200, windows 1-17
      and two above, SAD, SSD, census with 1-3 and 7 planes, f32 and bf16,
      w below D, h below the tile, row shards) and K2 with its right-view
      emit on ``K2_EDGES`` (R = 1, 2, 4, windows 5/7/9, census with 2, 3
      and 6 planes, SAD and SSD, ``lr``
      on and off, plans with bases below 0 and at or beyond w - R, nw = 0,
      1 and above K, ``tile_rows`` 8/24/64, w = 130 and w < 128, a shard
      with ``g_row0`` < 0); K1 on
      ``K1_EDGES`` (D from 1 to 200, w below D and below a tile, w not a
      multiple of the tile width, right-view winners one or two tiles
      away, census with 1–3 planes, row shards with ``g_row0`` < 0 and
      ``g_row0 + h > g_h``, one 1080-row case); K7 in all 8 directions at D
      = 1, 33, 64, 129, 200, 256, 257, 290, 320 and 512 (``K7_EDGE_D``),
      f32 and bf16, ``acc`` None, separate and in place, on ragged shapes
      down to one row and one column and on rows of 16-byte multiples (the
      ring at 128 < D ≤ 256, the deep tiling past 256), at 1080×1920,
      D=256, and over rows as wide as one block an SM takes and wider; K8
      on
      ``K8_EDGES`` (D = 1, 16, 33, 64, 128, f32 and bf16, uniqueness on
      and off, h = 1, 2, 9, w = 1, 17, 300); K10 relayed over shards of 13,
      28 and 29 rows; K11 with 1–4 channels, every width residue mod 4,
      views with a storage offset and NaN/inf/far map entries; then
      (``check_post_edges``) K3 on ``K3_EDGES`` and K5 on ``K5_EDGES`` (h
      1-1080, w 1-4100: every residue mod 4, above K5's 2048-column
      on-chip row; views one row or one element into their storage) on maps
      holding NaN, ±inf and ±0, K5 with rows all, none, one (first or last
      column) or 1 in 500 valid; NaN must sit where the plain version has
      it, every other value in the same bits.
   Kernel and plain version add the same values in the same order, so every
   comparison must be bit-equal (the "close" rule is checked too);
4. end to end through the user's entry points, each with the launch counts
   set to 0 just before it and read just after, the recovered disparity,
   and agreement with the plain path on the same card:
   a. the SAD slice, ``StereoModel(backend="hierarchical-pallas")``;
   b. production, the same with census cost and ``lr_check=True``;
   c. ``flagship()`` (the ``pallas`` backend);
   d. ``video(keyframe_interval=4)`` of the production model on a 5-frame
      clip whose disparity drifts 1 px per frame;
   e. ``hierarchical-sgm`` with SAD (path 1) and in production (path 2);
   f. ``sgm-pallas``, 4 directions, D=64, window 5, LR (path 3), and its 8-
      and 2-direction branches;
   g. ``video(keyframe_interval=4)`` of the path-2 model on the clip;
   h. the rig path: a textured plane at Z = 5 seen by the rig of 3g (raw
      distorted RGB views, the right one at 0.85× brightness) through
      ``photometric.normalize_brightness_f32``, ``rectify.rectify_pair(...,
      backend="pallas")`` (K11 once per view), production,
      ``geometry.disparity_to_depth``, ``depth_to_points`` and
      ``io.save_ply``, then ``kmeans.depth_split`` and ``depth.slice_mask``
      on its u8 depth: launch counts, the analytic disparity f·B/Z_rect and
      depth (medians within 0.5 px and 2%), the PLY's vertex count, the
      plain path on the same card, and the depth utilities against the same
      calls on CPU tensors;
   i. ``sgm-pallas`` sharded (``StereoModel.sharded``) over a mesh of
      ``[cuda:0] * 3``: 4 directions exact (K10 relays ↓y and ↑y from shard
      to shard), bit-equal to the unsharded kernel path and to its own plain
      path; 8 directions, bit-equal to unsharded; windowed mode (warm-up
      16) within the reference's statistical rule and equal to its plain
      path;
   j. the other sharded paths, each bit-equal to its unsharded kernel path
      and to its own plain path: ``flagship()`` on 4 shards at 1080p;
      production ``hierarchical-pallas`` on 4 shards at 1024×1920, through
      ``match_hierarchical_sharded(..., lr_check=True)`` (``sharded()``
      drops the LR check, as the reference's does) (no row
      count of 1080 admits a mesh at ``levels=4``: the shard's coarsest
      height must divide by a multiple of 8) with ``tile_rows=32``, and
      ``hierarchical-sgm`` there (close to its unsharded path only: its
      coarse level is the plain-torch SGM relay); a 5-frame
      ``match_temporal_sharded``; ``match_batch_hierarchical_sharded`` with
      ``data=2``; ``dense`` and ``sgm`` on 3 shards at 270×480 (integer
      images, so their cumulative sums are exact); ``normalize_depth_
      sharded``;
5. times (CUDA events, median of ``REPS`` runs after a warm-up; the plain
   SGM paths at 1080p loop over thousands of scan steps and take
   ``PLAIN_SGM_REPS``) of kernel and plain paths, per kernel and per frame,
   and each kernel's bound: the larger of its bytes over the card's memory
   rate and its operations over its f32 rate; the rig path per frame
   against production alone on its rectified pair; K10 per launch on a
   360-row shard; the sharded ``sgm-pallas``, ``flagship()`` and production
   frames against their unsharded frames, timed in turns (one card carries
   every shard, so the sharded frames are not expected to be faster).
   Device times (``device_ms``: 50 launches captured in one CUDA graph,
   its replay between CUDA events; 10 for K6 and K8) beside the one-call
   times, for every kernel: K1 and K2 launched on census planes computed
   beforehand, so that their bounds meet a time of the same work (K2 on
   both scenes: ``box`` plans multi-window tiles at depth edges), K1 and
   K8 with the fill of their right-view buffer, K7 per direction, K11
   against ``grid_sample``; K1 alone at the ``flagship()`` shape
   against its bound there; and K7 on its deep tiling at the Middlebury F
   frame (1988×2880, D=290), each direction in place against its byte
   bound (``deep_scan_times``, JSON ``K7.deep``), once that frame has
   passed ``check_deep_frame``: K6, the 8 K7 scans in place, K9 with K4
   and ``StereoModel.__call__`` (launches and counters read) bit-equal to
   the plain path, f32 and bf16;
6. the reference's own flows through the port's entry points
   (``reference_flows``): a. parity through ``DepthFrame`` on a 400×600
   RGB pair (the shape of the reference's bundled images; a 4×4-block
   random field shifted 6 columns, ±3 of noise), then ``invert_depth``,
   ``select_foreground``, ``apply_mask``: card equal to CPU bit for bit,
   depth not all zero, the phase times (subdivision, phase A, phase B,
   normalise) there and at 1080p on ``make_pair``; b. ``StereoModel(
   backend="hierarchical")`` (SAD, D=128, ``levels=4``) at 1080p: no
   kernel launched, median disparity 24 ± 0.5, ms/frame, the frame's peak
   memory, the share within 1 px of ``hierarchical-pallas``; card against
   CPU at 270×480 ``levels=3`` under the close rule; c. the CLI in-process
   (``cli.main``) on PNGs: ``stereo`` in production (launch counts equal
   to 4b's, PNG equal to the model call's u8 depth), ``video`` on a
   9-frame 1080p clip drifting 24…28…24 px (census, LR, chunks of 4: every
   frame equal to ``model.video(4)``, frames/s end to end and of
   ``model.video`` alone), ``depth`` and ``foreground`` (equal to a.);
   d. ``image_pair_loader`` onto the card over the clip's PNGs (order,
   device, values).

7. the mapping path and the two-view flow (``mapping_flows``): a.
   ``tools/mapping_bench.py``'s defaults at 1088×1920 (``mapping_run``):
   8 keyframes of a strafing rig over the ``curved`` world, each pair
   rendered anew from its ground-truth depth (the port's
   ``warp_depth_to_ref``); the production matcher's ``video(4)`` (census,
   LR, D=128, ``levels=4``), metric depth and ``fuse_depths``,
   ``posegraph.optimize`` on noisy odometry with a loop closure, and
   ``solve_resumable`` over 4,096 points × 8 cameras (10 LM iterations,
   ``cg_iters=10``, a checkpoint every 5): the clip's K1–K5 launches, each
   stage's time (``StageTimes``, synchronised) and peak memory, the end-to-
   end wall time, the device's busy share over one run from a
   ``device_trace`` Chrome trace; checked: the fused median |dZ|/Z beats
   the single view's, the pose-graph residual < 1e-6, the BA cost falls
   and ends below 1.5 × 2σ² (σ = 0.3 px), the solve interrupted at
   iteration 5 and rerun, a straight solve and a second straight solve
   equal bit for bit, the card's BA within 5e-3 (cost rtol 0.3) of CPU
   tensors and its fusion within 1e-5 relative on ≥ 99.9% of pixels;
   b. ``examples/two_view_reconstruction.py``'s rig at 160×224: features,
   ``pose_from_correspondences``, ``rectify_pair(backend="pallas")`` (K11
   twice) and ``hierarchical-pallas`` SAD D=64 (K1, K2 twice, K3) for
   RANSAC seeds 0-9, the example's checks (rotation error < 3e-2 and t
   direction < 9° on every draw, the dense median depth within 0.4 of the
   ground truth on at least 7 draws, the JAX package's count on its own
   draws) and the corner set equal to the CPU's.

8. the multi-process layer (``multiprocess_drills``): two workers of
   ``python -m stepth_tpu_torch.parallel.drill`` share the card under gloo
   (transfers staged through the host), each holding half the slots of a
   ``distributed.global_mesh`` and poisoning the input rows it does not
   own with NaN: a.-c. in one worker pair, production
   ``hierarchical-pallas`` at 1024×1920 on ``tile=4``, the exact
   ``sgm-pallas`` relay (K10 across the process boundary) at 1088×1920 on
   ``tile=4`` and BA at the mapping size (4,096 points × 8 cameras, 10 LM
   iterations) on ``data=8``: each rank equal bit for bit to the same call
   on a one-process mesh of the same shape and to the other rank, every
   kernel call of a. and b. equal to its plain version, median disparity
   24 ± 0.5, launches per frame and rank, the bytes sent across, and the
   2-process call against the one-process call timed in turns; d. the
   resumable drill (rank 1 dies after the first checkpointed segment, the
   supervisor relaunches the survivor alone on ``auto_mesh`` over four
   slots of ``cuda:0``, its cost below 7a's limit); e. the failure drill
   (the seconds from the peer's death to its detection).

9. the communication model (``comm_checks``): a. the transport tally
   (``distributed.traffic``) of one call of each one-process sharded path
   of 4i-4j (path 3 exact on 3 shards at 4 and 8 directions,
   ``flagship()`` on 4, production and ``hierarchical-sgm`` on 4 at
   1024×1920) against ``parallel.comm_model``, kind by kind (permute,
   gather, max), bytes, moves and relay hops, exactly; b. each rank's bytes
   sent in 8a-c against ``comm_model.bytes_sent`` for the drill's slot
   owners; c. ``depth --backend native`` (the C++ host engine, built with
   g++) and ``--backend oracle`` (the NumPy oracle, in a process of its own
   started after the build, beside phases 3-8: it takes minutes at
   400×600) on 6a's pair, each PNG equal to parity's depth from the card
   byte for byte, with the host ms of each beside parity's; d. a scaling
   projection (2, 4 and 8 cards on 1 and 2 hosts) of production and the
   exact ``sgm-pallas`` from this run's unsharded frames: a model, its link
   rates assumptions, not a measurement.

Any failed check raises and the script exits non-zero. The line before the
last is a JSON summary of the kernels (launches from the run named in each
entry's ``path``, ``mapping_launches`` from 7a's clip and
``drill_launches``, each rank's, from 8a-b); the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 2 and prints no result. Imports nothing of
JAX.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from stepth_tpu_torch.parallel import distributed
from stepth_tpu_torch.parallel.drill import BA_SIZES, checked_stages, make_clip, make_pair

SEED = 0  # seed of the smooth pair, the clip and the random maps
REPS = 10  # timed runs per measurement (median)
PLAIN_SGM_REPS = 3  # timed runs of a plain SGM path at 1080p
MAX_ERR = 0.0  # kernel vs plain version: bit-equal
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12  # H100 SXM f32 operations/s outside the tensor cores


def bound(nbytes, ops):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    to move ``nbytes`` (each input read once, each output written once) and
    do ``ops`` f32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cost_ops(cfg, planes):
    """f32 operations per (pixel, d) of a cost and its separable box sums:
    sub + abs (or mul), or xor + popcount per census plane and the adds
    joining them; then the adds of the box sums per axis: 4 for window 9
    (the reference's association: each cell's 3-sum once, 2 adds, then 2
    joining three 3-sums), ``window − 1`` for the others."""
    cost = 3 * planes - 1 if cfg.cost == "census" else 2
    return cost + 2 * (4 if cfg.window == 9 else cfg.window - 1)


def rot(axis, deg):
    """Rotation by ``deg`` degrees about the x or y axis."""
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


# the calibrated rig of phases 3g and 4h: 1080p pinhole cameras 12 cm apart,
# the right one turned 2° about y and -0.5° about x, both lenses distorted
RIG_K = np.array([[1400.0, 0, 959.5], [0, 1400.0, 539.5], [0, 0, 1]], np.float32)
RIG_R = (rot("y", 2.0) @ rot("x", -0.5)).astype(np.float32)
RIG_T = np.array([-0.12, 0.002, 0.001], np.float32)
RIG_DIST1 = (-0.05, 0.01, 0.0005, -0.0003)
RIG_DIST2 = (-0.04, 0.008, -0.0004, 0.0002)
RIG_Z = 5.0  # the plane's depth: f·B/Z ≈ 33.6 px


def affine_map(h, w, sh, sw, angle, scale, shift, dev):
    """f32[h, w, 2] sample map into an (sh, sw) source: output pixels rotated
    by ``angle`` about the centre, scaled and shifted."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    c, s = float(np.cos(angle)), float(np.sin(angle))
    u, v = xx - (w - 1) / 2, yy - (h - 1) / 2
    x = (u * c - v * s) * scale + (sw - 1) / 2 + shift[0]
    y = (u * s + v * c) * scale + (sh - 1) / 2 + shift[1]
    return torch.stack([x, y], -1).contiguous()


def check_equal(name, ref_disp, ref_valid, got_disp, got_valid, atol=0.05, exact=True):
    """The reference's "close" rule (valid masks agree on > 99.9% of pixels,
    99.9th percentile of |Δd| over pixels valid in both ≤ atol px), then,
    with ``exact``, equality: masks equal and max |Δd| over all pixels ≤
    ``MAX_ERR``. Returns the largest |Δd|."""
    rv, gv = ref_valid.cpu().numpy(), got_valid.cpu().numpy()
    agree = float((rv == gv).mean())
    d = (ref_disp.double() - got_disp.double()).abs().cpu().numpy()
    both = rv & gv
    q = float(np.quantile(d[both], 0.999))
    max_err = float(d.max())
    print(f"  {name}: valid agree {agree:.6f}, p99.9 |dd| {q:.3g}, max |dd| {max_err:.3g}")
    if not (agree > 0.999 and q <= atol):
        raise AssertionError(f"{name}: not close (agree {agree}, p99.9 {q})")
    if exact and not (agree == 1.0 and max_err <= MAX_ERR):
        raise AssertionError(f"{name}: not bit-equal (agree {agree}, max |dd| {max_err})")
    return max_err


def check_map(name, want, got):
    """A map compared everywhere (no mask): bit-equal."""
    ones = torch.ones_like(want, dtype=torch.bool)
    return check_equal(name, want, ones, got, ones)


def check_mask(name, want, got):
    """A bool mask: equal."""
    if not torch.equal(want, got):
        raise AssertionError(f"{name}: masks differ at {int((want != got).sum())} pixels")
    print(f"  {name}: equal ({float(want.float().mean()):.4f} true)")
    return 0.0


def check_k1(name, want, got):
    """K1's four outputs (disp, disp_r, cbest, valid) bit-equal; returns
    the largest |Δ| over them."""
    errs = [check_equal(name, want[0], want[3] > 0.5, got[0], got[3] > 0.5),
            check_equal(name + " disp_r", want[1], want[1] >= 0, got[1], got[1] >= 0)]
    ones = torch.ones_like(want[2], dtype=torch.bool)
    errs.append(check_equal(name + " cbest", want[2], ones, got[2], ones, atol=0.0))
    return max(errs)


def event_ms(fn):
    """ms of one run of ``fn``, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps=REPS):
    """Median ms of ``fn`` over ``reps`` runs, by CUDA events, after a
    warm-up."""
    for _ in range(2 if reps > 3 else 1):
        fn()
    torch.cuda.synchronize()
    return float(np.median([event_ms(fn) for _ in range(reps)]))


DEVICE_LAUNCHES = 50  # launches per device-time measurement


def device_ms(fn, launches=DEVICE_LAUNCHES):
    """ms per launch of ``fn`` on the device: ``launches`` calls captured in
    one CUDA graph, its replay timed by CUDA events and divided by their
    number, after a warm-up call and a warm-up replay (no host time between
    the launches, however small the kernel)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def device_ms_turns(a, b, rounds=4):
    """Median :func:`device_ms` of ``a`` and of ``b`` over ``rounds`` rounds
    timed in turns (a b, b a, ...)."""
    ta, tb = [], []
    for r in range(rounds):
        for fn, t in ((a, ta), (b, tb))[:: 1 if r % 2 == 0 else -1]:
            t.append(device_ms(fn))
    return float(np.median(ta)), float(np.median(tb))


def cuda_ms_turns(a, b, reps=REPS):
    """Median ms of ``a`` and of ``b``, timed in turns (a b, b a, a b, ...)
    after a warm-up: host-bound frames drift between blocks of runs, so two
    of them are compared run by run."""
    a(), b()
    torch.cuda.synchronize()
    ta, tb = [], []
    for r in range(reps):
        for fn, t in ((a, ta), (b, tb))[:: 1 if r % 2 == 0 else -1]:
            t.append(event_ms(fn))
    return float(np.median(ta)), float(np.median(tb))


# K1's edge cases (h, w, D, window, cost, census_window, uniqueness, g_row0,
# g_h, shift of the right view): D from 1 to 200; w below D and below the
# 128-column tile, w not a multiple of it; true disparities near D - 1, so
# that right-view winners come from columns one or two tiles away; census
# with 1-3 planes; row shards with g_row0 < 0 and g_row0 + h > g_h; one
# 1080-row case with uniqueness, the window-9 kernel's other instantiation
K1_EDGES = (
    (37, 300, 1, 9, "sad", 7, None, 0, None, 0),
    (40, 100, 16, 9, "census", 5, 0.1, 0, None, 5),
    (40, 300, 127, 9, "sad", 7, None, 0, None, 120),
    (33, 257, 128, 9, "census", 7, 0.1, 0, None, 100),
    (20, 100, 129, 7, "ssd", 7, None, 0, None, 30),
    (24, 150, 200, 5, "census", 9, None, 0, None, 140),
    (50, 260, 64, 9, "sad", 7, 0.1, -8, 38, 60),
    (45, 131, 48, 9, "census", 7, None, -3, 40, 40),
    (1080, 515, 129, 9, "census", 9, 0.1, 0, None, 100),
)
# K7's (h, w): ragged shapes (the staged kernel: bands and stages cut by
# the image, one row, one column), then rows of 16-byte multiples, where the
# scans over rows at D > 128 take the ring (one band, several, h > w, a band
# wider than the image)
K7_EDGE_SHAPES = ((13, 21), (5, 7), (1, 37), (29, 1), (3, 40),
                  (37, 64), (70, 32), (9, 128), (5, 256), (3, 8))
# K7's D: each ND class of a lane's path costs (1-8 on the staged tiles, 9-16
# on the deep tiling past 256: 257, 290 and 320 share ND = 10), the ring's
# range 129-256
K7_EDGE_D = (1, 33, 64, 129, 200, 256, 257, 290, 320, 512)
# K7's at D=256 over rows: as wide as one block an SM takes (2112 = 132
# bands of 16 on an H100's 132 SMs: the ring) and wider (the staged kernel)
K7_WIDE_SHAPES = ((1, 2112), (1, 4240), (3, 4240))

# K8's: every D class, f32 and bf16, uniqueness on and off, h and w down to 1
K8_EDGES = [(D, dtype, uniq, h, w) for D in (1, 16, 33, 64, 128)
            for dtype in (torch.float32, torch.bfloat16) for uniq in (None, 0.1)
            for h in (1, 2, 9) for w in (1, 17, 300)]

# K6's: D from 1 to 200; windows 1-17 and two above 17 (the run-time radius);
# SAD, SSD, census with 1-3 planes (census windows 5, 7, 9) and with 7
# (census window 15: tiles too large for shared memory); f32 and bf16;
# w below D and not a multiple of the 128-column tile; h below the 8-row
# tile; row shards with g_row0 < 0 and g_row0 + h > g_h, or g_row0 > 0
# (h, w, D, window, cost, census_window, dtype, g_row0, g_h)
K6_EDGES = (
    (37, 300, 1, 5, "sad", 7, torch.float32, 0, None),
    (20, 100, 16, 9, "census", 5, torch.bfloat16, 0, None),
    (9, 40, 33, 3, "ssd", 7, torch.float32, 0, None),
    (5, 131, 64, 7, "census", 7, torch.bfloat16, 0, None),
    (24, 257, 128, 11, "census", 9, torch.float32, -4, 18),
    (30, 130, 200, 17, "sad", 7, torch.bfloat16, 0, None),
    (12, 300, 64, 1, "sad", 7, torch.float32, 0, None),
    (16, 129, 33, 21, "census", 9, torch.float32, -3, 10),
    (40, 256, 16, 5, "ssd", 7, torch.bfloat16, 6, 40),
    (3, 600, 100, 25, "sad", 7, torch.float32, 0, None),
    (7, 1, 16, 5, "sad", 7, torch.float32, 0, None),
    (20, 140, 16, 17, "census", 15, torch.bfloat16, 0, None),
)
# K2's: R = 1, 2, 4; windows 5, 7, 9; census and SAD (and SSD), census with
# 6 planes (tiles too large for shared memory); the right view on and off; plans with bases below 0, at and beyond w - R, nw = 0, 1
# and above K, and one from a stepped prior; tile_rows 8, 24, 64; w = 130
# and w < 128; row shards with g_row0 < 0
# (h, w, R, window, cost, census_window, lr, tile_rows, g_row0, g_h, plan)
K2_EDGES = (
    (24, 200, 2, 9, "census", 7, True, 8, 0, None, "negative"),
    (24, 200, 2, 9, "sad", 7, False, 8, 0, None, "negative"),
    (24, 130, 1, 5, "sad", 7, True, 24, 0, None, "beyond"),
    (24, 130, 4, 7, "census", 5, False, 24, 0, None, "beyond"),
    (70, 100, 2, 9, "census", 7, True, 64, 0, None, "nw0"),
    (70, 100, 4, 5, "sad", 7, False, 64, 0, None, "nwK"),
    (40, 300, 1, 7, "census", 9, False, 8, -4, 30, "nw1"),
    (40, 300, 4, 9, "sad", 7, True, 24, -5, 33, "nwK"),
    (64, 515, 2, 9, "census", 7, True, 64, 0, None, "step"),
    (30, 260, 2, 5, "ssd", 7, True, 8, 0, None, "nw1"),
    (24, 200, 2, 9, "census", 13, True, 8, 0, None, "nw1"),
)


# K3's and K5's edge cases (h, w): heights down to one row, widths of every
# residue mod 4 (w % 4 != 0: the scalar paths), below and above a warp's 128
# columns, and above K5's 2048-column on-chip row (2049, 4100: rows in
# chunks); and (h, w, view) for views that start one row into a width-1919
# map (rows not 16-byte aligned: scalar), one row into a width-1920 map
# (aligned: vector) and one element into a buffer (w % 4 = 0, misaligned)
POST_EDGE_W = (1, 2, 3, 5, 31, 33, 127, 129, 1921, 2049, 4100)
K3_EDGES = [(h, w) for h in (1, 2, 3, 7, 1080) for w in POST_EDGE_W]
POST_EDGE_VIEWS = [(h, w, view) for h in (7, 1080)
                   for w, view in ((1919, "row"), (1920, "row"), (1920, "element"))]
# K5's rows take one of FILL_PATTERNS validity patterns each (edge_validity)
FILL_PATTERNS = 6
K5_EDGES = [(h, w, k) for h, w in K3_EDGES for k in range(FILL_PATTERNS)]


def edge_values(rng, h, w):
    """f32[h, w] of uniform [0, 64) with NaN, +inf, −inf, +0 and −0 at 5%
    each, and NaN, ±inf at the four corners."""
    x = rng.uniform(0, 64, (h, w)).astype(np.float32)
    u = rng.uniform(size=(h, w))
    for i, v in enumerate((np.nan, np.inf, -np.inf, 0.0, -0.0)):
        x[(u >= 0.05 * i) & (u < 0.05 * (i + 1))] = v
    x[0, 0], x[0, -1], x[-1, 0], x[-1, -1] = np.nan, np.inf, -np.inf, np.nan
    return x


def edge_validity(rng, h, w, k):
    """bool[h, w] whose row y takes pattern (y + k) % FILL_PATTERNS: 70%
    valid, 1 in 500 valid (runs across K5's chunks), none, all, only
    column 0, only column w − 1."""
    v = np.zeros((h, w), bool)
    for y in range(h):
        p = (y + k) % FILL_PATTERNS
        if p == 0:
            v[y] = rng.uniform(size=w) < 0.7
        elif p == 1:
            v[y] = rng.uniform(size=w) < 0.002
        elif p == 3:
            v[y] = True
        elif p == 4:
            v[y, 0] = True
        elif p == 5:
            v[y, -1] = True
    return v


def edge_view(a, view, dev):
    """``a`` on ``dev`` as a contiguous view that does not start its
    storage: ``"row"``, one row into a map one row taller; ``"element"``,
    one element into a buffer; else ``a`` itself."""
    t = torch.as_tensor(a, device=dev)
    if view == "row":
        buf = torch.cat([t[:1], t])
        return buf[1:]
    if view == "element":
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:].copy_(t.flatten())
        return buf[1:].view(t.shape)
    return t


def bits_equal(want, got):
    """NaN at the same pixels and equal bits at every other pixel (the sign
    of a zero included)."""
    nw, ng = torch.isnan(want), torch.isnan(got)
    return bool(torch.equal(nw, ng) and torch.equal(
        want.contiguous().view(torch.int32)[~nw], got.contiguous().view(torch.int32)[~ng]))


def check_post_edges(dev, err):
    """K3 on ``K3_EDGES`` and K5 on ``K5_EDGES`` and on the offset views of
    ``POST_EDGE_VIEWS`` (every validity pattern), against their plain
    versions on maps of ``edge_values`` (the ``cuda``-marked cases of
    ``tests/test_torch_fused_post.py``): NaN where the plain version has
    NaN, the same bits elsewhere; any difference raises."""
    from stepth_tpu_torch.match import fused_post

    rng = np.random.default_rng(SEED + 9)
    cases = [(h, w, None) for h, w in K3_EDGES] + POST_EDGE_VIEWS
    for h, w, view in cases:
        x = edge_values(rng, h, w)
        xt = edge_view(x, view, dev)
        got, want = fused_post.median3_fused(xt), fused_post.median3_plain(xt)
        torch.cuda.synchronize()
        if not bits_equal(want, got):
            raise AssertionError(f"K3 {h}x{w} view {view}: not bit-equal (NaN as NaN)")
        err("K3", 0.0)
        for k in range(FILL_PATTERNS):
            vt = edge_view(edge_validity(rng, h, w, k), view, dev)
            got, want = fused_post.fill_invalid_fused(xt, vt), fused_post.fill_invalid_plain(xt, vt)
            torch.cuda.synchronize()
            if not bits_equal(want, got):
                raise AssertionError(f"K5 {h}x{w} view {view} patterns from {k}: not bit-equal")
            err("K5", 0.0)
    print(f"  K3: {len(cases)} edge cases, K5: {len(cases) * FILL_PATTERNS}, bit-equal with NaN as "
          f"NaN (h 1-1080, w 1-4100, offset views; NaN, +-inf, +-0; rows all, none, one or "
          f"1/500 valid)")


def edge_plan(rng, h, w, tile_rows, kind, radius, K=4):
    """A refine plan ``(bases, nw)`` the prior never gives (or, ``step``,
    the plan of a prior with two disparity steps): bases below 0, at and
    beyond w - R, nw = 0, 1 or above K."""
    nr, nc = -(-h // tile_rows), -(-w // 128)
    if kind == "step":
        prior = np.full((h, w), 6.0, np.float32) + rng.normal(0, 1, (h, w)).astype(np.float32)
        prior[:, w // 3:] += 10.0
        prior[h // 2:, 2 * w // 3:] -= 7.0
        from stepth_tpu_torch.match import fused_refine
        bases, nw, _ = fused_refine.plan_level(torch.from_numpy(prior), tile_rows, 64, radius, 16)
        return bases.numpy(), nw.numpy()
    bases = rng.integers(0, 40, (nr, nc, K)).astype(np.int32)
    nw = rng.integers(1, K + 1, (nr, nc)).astype(np.int32)
    if kind == "negative":
        bases[..., 0] = -3
        bases[0, 0, 1] = -1
    elif kind == "beyond":
        bases[..., 0] = w - radius
        bases[0, -1, 1] = w + 3
        nw[:] = 2
    elif kind == "nw0":
        nw[:] = 0
    elif kind == "nw1":
        nw[:] = 1
    else:
        nw[:] = K + 2
    return bases, nw


def check_cost_front_edges(dev, err):
    """K6 on ``K6_EDGES`` and K2 (with its right-view emit under ``lr``) on
    ``K2_EDGES`` against their plain versions, on float images (the
    ``cuda``-marked cases of ``tests/test_torch_fused_sgm.py`` and
    ``test_torch_fused_refine.py``); any difference raises."""
    from stepth_tpu_torch.config import MatchConfig
    from stepth_tpu_torch.match import fused_refine, fused_sgm

    rng = np.random.default_rng(SEED + 8)

    def images(h, w, shift):
        left = rng.uniform(0, 255, (h, w)).astype(np.float32)
        right = np.roll(left, -shift, axis=1) + rng.uniform(0, 4, (h, w)).astype(np.float32)
        return torch.as_tensor(left, device=dev), torch.as_tensor(right, device=dev)

    for h, w, D, win, cost, cw, dtype, g_row0, g_h in K6_EDGES:
        lg, rg = images(h, w, 3)
        c = MatchConfig(num_disparities=D, window=win, cost=cost, census_window=cw)
        got = fused_sgm.aggregated_volume(lg, rg, c, dtype, g_row0, g_h)
        want = fused_sgm.aggregated_volume_plain(lg, rg, c, dtype, g_row0, g_h)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K6 {h}x{w} D={D} window {win} {cost} census_window {cw} "
                                 f"{dtype} g_row0 {g_row0} g_h {g_h}: not bit-equal")
        err("K6", 0.0)
    print(f"  K6: {len(K6_EDGES)} edge cases bit-equal (D 1-200, windows 1-25, SAD/SSD/census "
          f"1-3 and 7 planes, f32/bf16, w < D, h < 8, row shards)")
    for h, w, R, win, cost, cw, lr, tr, g_row0, g_h, kind in K2_EDGES:
        lg, rg = images(h, w, 6)
        bases, nw = (torch.as_tensor(a, device=dev) for a in edge_plan(rng, h, w, tr, kind, R))
        c = MatchConfig(window=win, cost=cost, census_window=cw)
        args = (lg, rg, bases, nw, c, R, tr, g_row0, g_h, lr)
        got = fused_refine.refine_planned(*args)
        want = fused_refine.refine_planned_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in (zip(got, want) if lr else ((got, want),))):
            raise AssertionError(f"K2 {h}x{w} R={R} window {win} {cost} census_window {cw} "
                                 f"lr {lr} tile_rows {tr} g_row0 {g_row0} plan {kind}: "
                                 f"not bit-equal")
        err("K2", 0.0)
        if lr:
            err("K2 emit", 0.0)
    print(f"  K2: {len(K2_EDGES)} edge cases bit-equal (R 1/2/4, windows 5/7/9, census 2/3/6 "
          f"planes, SAD, SSD, lr on/off, bases < 0 and >= w - R, nw 0/1/> K, tile_rows 8/24/64, w 130 and < 128, "
          f"row shards)")


def edge_pair(rng, h, w, shift):
    """Integer-valued gray views, the right one the left shifted by
    ``shift`` columns (wrapped) plus small noise."""
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    right = np.roll(left, -shift, axis=1) + rng.integers(0, 3, (h, w)).astype(np.float32)
    return left, right


DEEP_SHAPE, DEEP_D = (1988, 2880), 290  # the middlebury2014-f-sgm8-census frame
DEEP_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "configs",
                           "middlebury2014-f-sgm8-census.json")


def check_deep_frame(dev, err):
    """The middlebury2014-f-sgm8-census frame (1988×2880, D=290) against
    the plain path, stage by stage, with an f32 volume (the
    configuration's) and a bf16 one (its control): K6 on the census
    planes; each of the 8 K7 scans onto the accumulator in place, on the
    deep tiling (one ``sgm.scan_deep`` a launch); K9 with K4 on the stored
    sum; then the whole frame through ``StereoModel.__call__`` against
    ``match_pair_sgm_plain``, its launches and counters read. The input is
    the ``middlebury-f-sgm8-census-box`` cell's first frame. Any
    difference raises; ``deep_scan_times`` runs after it."""
    from portbench import traffic
    from stepth_tpu_torch import kernels
    from stepth_tpu_torch.config import from_dict
    from stepth_tpu_torch.match import dense, fused_sgm
    from stepth_tpu_torch.match.sgm import penalties
    from stepth_tpu_torch.models.stereo import StereoModel
    from stepth_tpu_torch.utils import tracing

    def moved(before):
        now = tracing.counters()
        return {k: now[k] - before.get(k, 0) for k in now if now[k] != before.get(k, 0)}

    with open(DEEP_CONFIG) as f:
        model_cfg = json.load(f)["model"]
    params = dict(traffic.load("middlebury-f-sgm8-census-box"), pool=1)
    lefts, rights = traffic.make_pool(params, DEEP_SHAPE, SEED)
    left, right = (torch.as_tensor(a[0], device=dev).to(torch.float32) for a in (lefts, rights))
    registry = kernels.registry()
    frame_launches = {n: 0 for n in registry} | {
        "census": 1, "K6": 1, "K7": 8, "K9": 1, "K4": 1, "K5": 1, "K3": 1}
    h, w = DEEP_SHAPE
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model_cfg["sgm"]["volume_dtype"] = name
        model = from_dict(StereoModel, model_cfg)
        cfg, sg = model.match, model.sgm
        tag = f"{h}x{w} D={cfg.num_disparities} {name}"
        lg, rg = dense.grayscale(left), dense.grayscale(right)
        vol = fused_sgm.aggregated_volume(lg, rg, cfg, dtype)
        if not torch.equal(vol, fused_sgm.aggregated_volume_plain(lg, rg, cfg, dtype)):
            raise AssertionError(f"K6 {tag}: not bit-equal")
        err("K6", 0.0)
        p1, p2 = penalties(cfg, sg)
        acc = acc_p = None
        for axis, rev, sh in fused_sgm.directions(8):
            kw = dict(axis=axis, reverse=rev, shift=sh)
            before = tracing.counters()
            into = acc
            acc = fused_sgm.scan_direction(vol, acc, p1, p2, **kw)
            torch.cuda.synchronize()
            counted = moved(before)
            acc_p = fused_sgm.scan_direction_plain(vol, acc_p, p1, p2, **kw)
            if not (torch.equal(acc, acc_p) and counted == {"sgm.scan_deep": 1}
                    and (into is None or acc.data_ptr() == into.data_ptr())):
                raise AssertionError(f"K7 {tag} {kw}: not bit-equal, not in place or "
                                     f"miscounted ({counted})")
            err("K7", 0.0)
        del vol, acc_p
        got, want = fused_sgm.wta_from_volume(acc, cfg), fused_sgm.wta_from_volume_plain(acc, cfg)
        torch.cuda.synchronize()
        if not all(bits_equal(a, b) for a, b in zip(want, got)):
            raise AssertionError(f"K9 and K4 {tag} on the stored sum: not bit-equal")
        err("K9", 0.0)
        err("K4", 0.0)
        del acc, got, want
        torch.cuda.empty_cache()
        for k in registry.values():
            k.launches = 0
        before = tracing.counters()
        got = model(left, right)
        torch.cuda.synchronize()
        launches, counted = {n: k.launches for n, k in registry.items()}, moved(before)
        want = fused_sgm.match_pair_sgm_plain(left, right, cfg, sg)
        torch.cuda.synchronize()
        if not (bits_equal(want.disparity, got.disparity) and torch.equal(want.valid, got.valid)
                and bits_equal(want.cost, got.cost)):
            raise AssertionError(f"StereoModel sgm-pallas {tag}: not bit-equal to the plain path")
        want_counted = {"census.kernel": 1, "sgm.wta_stored": 1, "sgm.scan_deep": 8}
        if launches != frame_launches or counted != want_counted:
            raise AssertionError(f"StereoModel sgm-pallas {tag}: launches {launches} (want "
                                 f"{frame_launches}), counters {counted} (want {want_counted})")
        del got, want
        torch.cuda.empty_cache()
        print(f"  {tag}: K6, the 8 K7 scans in place (each one sgm.scan_deep), K9 + K4 and "
              f"StereoModel.__call__ bit-equal to the plain path; a frame launches "
              f"{ {n: c for n, c in launches.items() if c} }")


def deep_scan_times(dev, arrows, launches=5):
    """K7 on its deep tiling at the Middlebury F frame (1988×2880, D=290,
    f32), each direction onto an accumulator in place: device ms a launch
    (``launches`` in one graph) against the byte bound of vol and acc read
    and the sum written (12 bytes a cell)."""
    from stepth_tpu_torch.match import fused_sgm

    h, w = DEEP_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vol, acc = (torch.randint(0, hi, (DEEP_D, h, w), generator=gen, device=dev).float()
                for hi in (60, 600))
    bound_ms = bound(12 * DEEP_D * h * w, 8 * DEEP_D * h * w)[0]  # 3 f32 reads and writes
    out = {"shape": [h, w], "D": DEEP_D, "bound_ms": bound_ms, "device_ms_by_direction": {}}
    for axis, rev, sh in fused_sgm.directions(8):
        ms = device_ms(lambda axis=axis, rev=rev, sh=sh: fused_sgm.scan_direction(
            vol, acc, 8.0, 96.0, axis=axis, reverse=rev, shift=sh), launches)
        out["device_ms_by_direction"][arrows[(axis, rev, sh)]] = ms
        print(f"  K7 {arrows[(axis, rev, sh)]} {h}x{w} D={DEEP_D} (deep tiling): {ms:.4f} ms "
              f"per launch, bound {bound_ms:.4f} ms (bytes), {bound_ms / ms:.1%}")
    del vol, acc
    torch.cuda.empty_cache()
    return out


def check_edges(dev, err):
    """K1, K7, K8, K10 and K11 against their plain versions on the shapes
    and inputs the main paths do not reach (the CPU suite's
    ``cuda``-marked cases of ``tests/test_torch_fused_dense.py``,
    ``test_torch_fused_sgm.py``, ``test_torch_sgm_relay.py`` and
    ``test_torch_fused_remap.py``, which import JAX and so cannot run on the
    card): K1 on ``K1_EDGES``; K7 in all 8 directions at ``K7_EDGE_D``
    (D 1-512), f32 and bf16, ``acc`` None, separate and in place, on
    ``K7_EDGE_SHAPES`` (each launch counted on ``sgm.scan_ring``,
    ``sgm.scan_deep`` or ``sgm.scan_staged`` by the tiling it takes), at
    1080×1920, D=256, f32 and bf16, and over rows on ``K7_WIDE_SHAPES`` at
    D=256 (the ring up to one block an SM, the staged kernel past it); K8
    on ``K8_EDGES``; K10 relayed
    over shards of 13, 28 and 29 rows against one continuous K7 scan; K11
    with 1–4 channels, widths of every residue mod 4, views with a storage
    offset and maps with NaN, ±inf and far entries. ``err(name,
    max_abs_err)`` records each comparison; any difference raises."""
    from stepth_tpu_torch.config import MatchConfig
    from stepth_tpu_torch.match import fused_dense
    from stepth_tpu_torch.match import fused_sgm
    from stepth_tpu_torch.ops import fused_remap
    from stepth_tpu_torch.utils import tracing

    rng = np.random.default_rng(SEED)
    for h, w, D, win, cost, cw, uniq, g_row0, g_h, shift in K1_EDGES:
        lg, rg = (torch.as_tensor(a, device=dev) for a in edge_pair(rng, h, w, shift))
        c = MatchConfig(num_disparities=D, window=win, cost=cost, census_window=cw,
                        uniqueness=uniq, lr_threshold=None)
        want = fused_dense.raw_match_plain(lg, rg, c, 16, g_row0, g_h)
        got = fused_dense.raw_match(lg, rg, c, 16, g_row0, g_h)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(want, got)):
            raise AssertionError(f"K1 {h}x{w} D={D} window {win} {cost} census_window {cw} "
                                 f"uniqueness {uniq} g_row0 {g_row0} g_h {g_h}: not bit-equal")
        err("K1", 0.0)
    print(f"  K1: {len(K1_EDGES)} edge cases bit-equal (D 1-200, w < D, w % 128 != 0, "
          f"right view across tiles, census 1-3 planes, row shards)")
    for D, dtype, uniq, h, w in K8_EDGES:
        vol, acc = (torch.as_tensor(rng.integers(0, hi, (D, h, w)).astype(np.float32),
                                    device=dev).to(dtype) for hi in (50, 500))
        c = MatchConfig(num_disparities=D, window=5, uniqueness=uniq)
        want = fused_sgm.scan_wta_direction_plain(vol, acc, 25.0, 100.0, c)
        got = fused_sgm.scan_wta_direction(vol, acc, 25.0, 100.0, c)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(want, got)):
            raise AssertionError(f"K8 {h}x{w} D={D} {dtype} uniqueness {uniq}: not bit-equal")
        err("K8", 0.0)
    print(f"  K8: {len(K8_EDGES)} cases bit-equal (D 1-128, f32/bf16, uniqueness on/off, "
          f"h 1/2/9, w 1/17/300)")
    n = rings = deep = 0
    for D in K7_EDGE_D:
        for dtype in (torch.float32, torch.bfloat16):
            for h, w in K7_EDGE_SHAPES:
                vol, acc0 = (torch.as_tensor(rng.integers(0, hi, (D, h, w)).astype(np.float32),
                                             device=dev).to(dtype) for hi in (50, 500))
                for axis, rev, sh in fused_sgm.directions(8):
                    kw = dict(axis=axis, reverse=rev, shift=sh)
                    dy, dx = fused_sgm._step(axis, rev, sh)
                    ring = 128 < D <= 256 and dy != 0 and w * vol.element_size() % 16 == 0
                    for mode in ("none", "separate", "in place"):
                        acc = None if mode == "none" else acc0.clone()
                        want = fused_sgm.scan_direction_plain(
                            vol, None if acc is None else acc.clone(), 25.0, 100.0, **kw)
                        before = tracing.counters()
                        if mode == "separate":  # out beside acc, which stays as it was
                            got = torch.empty_like(vol)
                            fused_sgm._launch_k7(vol, acc, got, dy, dx, 25.0, 100.0)
                        else:
                            got = fused_sgm.scan_direction(vol, acc, 25.0, 100.0, **kw)
                        torch.cuda.synchronize()
                        ok = torch.equal(got, want) and (
                            mode != "separate" or torch.equal(acc, acc0)) and (
                            mode != "in place" or got.data_ptr() == acc.data_ptr())
                        counter = ("sgm.scan_ring" if ring else
                                   "sgm.scan_deep" if D > 256 else "sgm.scan_staged")
                        after = tracing.counters()
                        ok = ok and {k: after[k] - before.get(k, 0) for k in after
                                     if after[k] != before.get(k, 0)} == {counter: 1}
                        if not ok:
                            raise AssertionError(f"K7 {h}x{w} D={D} {dtype} {kw} acc {mode} "
                                                 f"({counter}): not bit-equal or miscounted")
                        err("K7", 0.0)
                        n += 1
                        rings += ring
                        deep += D > 256
    print(f"  K7: {n} edge cases bit-equal, {rings} of them on the ring, {deep} on the deep "
          f"tiling (D {K7_EDGE_D}, f32/bf16, acc none/separate/in place)")
    # the ring at its main shape: 1080x1920, D=256, every direction, onto an
    # accumulator in place
    for dtype in (torch.float32, torch.bfloat16):
        vol, acc0 = (torch.randint(0, hi, (256, 1080, 1920), device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(SEED + hi))
                     .to(dtype) for hi in (60, 600))
        for axis, rev, sh in fused_sgm.directions(8):
            kw = dict(axis=axis, reverse=rev, shift=sh)
            want = fused_sgm.scan_direction_plain(vol, acc0.clone(), 8.0, 96.0, **kw)
            got = fused_sgm.scan_direction(vol, acc0.clone(), 8.0, 96.0, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K7 1080x1920 D=256 {dtype} {kw}: not bit-equal")
            err("K7", 0.0)
            del want, got
        del vol, acc0
    print("  K7: 1080x1920 D=256, all 8 directions, f32 and bf16, bit-equal")
    # rows as wide as one block an SM takes, and wider: the ring, then the
    # staged kernel
    sms, counts = fused_sgm._sm_count(dev), {"ring": 0, "staged": 0}
    for dtype in (torch.float32, torch.bfloat16):
        for h, w in K7_WIDE_SHAPES:
            vol, acc0 = (torch.as_tensor(rng.integers(0, hi, (256, h, w)).astype(np.float32),
                                         device=dev).to(dtype) for hi in (50, 500))
            for axis, rev, sh in fused_sgm.directions(8)[2:]:  # the six over rows
                dy, dx = fused_sgm._step(axis, rev, sh)
                ring = len(fused_sgm.ring_schedule(h, w, dy, dx)[0]) - 1 <= sms
                kw = dict(axis=axis, reverse=rev, shift=sh)
                want = fused_sgm.scan_direction_plain(vol, acc0.clone(), 25.0, 100.0, **kw)
                before = tracing.counters().get("sgm.scan_ring", 0)
                got = fused_sgm.scan_direction(vol, acc0.clone(), 25.0, 100.0, **kw)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and
                        tracing.counters().get("sgm.scan_ring", 0) - before == int(ring)):
                    raise AssertionError(f"K7 {h}x{w} D=256 {dtype} {kw} (ring {ring}): "
                                         f"not bit-equal or miscounted")
                err("K7", 0.0)
                counts["ring" if ring else "staged"] += 1
    print(f"  K7: wide rows {K7_WIDE_SHAPES} at D=256, f32 and bf16, bit-equal: "
          f"{counts['ring']} on the ring, {counts['staged']} on the staged kernel")
    h, w, n = 70, 300, 0
    for D in (24, 144):
        for dtype in (torch.float32, torch.bfloat16):
            vol, acc = (torch.as_tensor(rng.integers(0, hi, (D, h, w)).astype(np.float32),
                                        device=dev).to(dtype) for hi in (50, 500))
            for axis, rev, sh in fused_sgm.directions(8):
                if axis != 1:
                    continue
                bounds = ((0, 13), (13, 41), (41, h))
                outs, carry = [None] * 3, None
                for i in ((2, 1, 0) if rev else (0, 1, 2)):
                    a, b = bounds[i]
                    v, ac = vol[:, a:b].contiguous(), acc[:, a:b].contiguous()
                    want = fused_sgm.scan_direction_carry_plain(v, ac.clone(), carry, 25.0,
                                                                100.0, reverse=rev, shift=sh)
                    outs[i], carry = fused_sgm.scan_direction_carry(v, ac, carry, 25.0, 100.0,
                                                                    reverse=rev, shift=sh)
                    torch.cuda.synchronize()
                    if not (torch.equal(outs[i], want[0]) and torch.equal(carry, want[1])):
                        raise AssertionError(f"K10 D={D} {dtype} {(rev, sh)} rows {a}-{b}: "
                                             f"not bit-equal to its plain version")
                cont = fused_sgm.scan_direction(vol, acc.clone(), 25.0, 100.0, axis=1,
                                                reverse=rev, shift=sh)
                _, cont_c = fused_sgm.scan_direction_carry_plain(vol, None, None, 25.0, 100.0,
                                                                 reverse=rev, shift=sh)
                torch.cuda.synchronize()
                if not (torch.equal(torch.cat(outs, 1), cont) and torch.equal(carry, cont_c)):
                    raise AssertionError(f"K10 D={D} {dtype} {(rev, sh)} shards 13/28/29: "
                                         f"relay != continuous scan")
                err("K10", 0.0)
                n += 1
    print(f"  K10: {n} relays over shards of 13, 28 and 29 rows bit-equal to the plain "
          f"version, shard by shard, and to one continuous K7 scan")
    n = 0
    for c, (hs, ws), (h, w) in ((1, (70, 161), (70, 161)), (2, (64, 162), (60, 162)),
                                (3, (50, 163), (50, 163)), (4, (48, 164), (44, 160))):
        shape = (hs, ws) if c == 1 else (hs, ws, c)
        img = rng.uniform(0, 255, shape).astype(np.float32)
        m = affine_map(h, w, hs, ws, 0.05, 1.05, (1.3, -0.7), "cpu").numpy()
        flat = m.reshape(-1, 2)
        idx = rng.choice(flat.shape[0], size=(6, 30), replace=False)
        for i, (col, val) in enumerate(((0, np.nan), (1, np.nan), (0, np.inf), (1, -np.inf),
                                        (0, 1e6), (1, -1e6))):
            flat[idx[i], col] = val
        for offset in (False, True):
            if offset:  # views one element into a larger buffer: 4-byte aligned only
                img_t, m_t = (torch.empty(a.size + 1, device=dev)[1:].view(a.shape)
                              for a in (img, m))
                img_t.copy_(torch.as_tensor(img)), m_t.copy_(torch.as_tensor(m))
            else:
                img_t, m_t = torch.as_tensor(img, device=dev), torch.as_tensor(m, device=dev)
            got = fused_remap.remap_bilinear_fused(img_t, m_t, -2.0)
            want = fused_remap.remap_bilinear_plain(img_t, m_t, -2.0)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K11 C={c} {h}x{w} offset={offset}: not bit-equal")
            err("K11", 0.0)
            n += 1
    print(f"  K11: {n} cases bit-equal (C 1-4, W % 4 = 1, 2, 3, 0, offset views, "
          f"NaN/inf/far entries)")


# the reference's flows (phase 6): the parity pair has the shape of the
# reference's bundled main.jpg/additional.jpg; the video clip drifts 1 px a
# frame up and back
PRECISION = (36, 36, 36)
PARITY_SHAPE = (400, 600)
PARITY_REPS = 3
FLOW_SHIFTS = [24, 25, 26, 27, 28, 27, 26, 25, 24]


def parity_pair(h, w, seed=0):
    """tests/test_match_parity.py's pair at (h, w): a 4×4-block random field
    (u8 RGB), the additional view shifted by 6 columns with ±3 of per-pixel
    noise, so that phase B has rings to sweep."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(-(-h // 4), -(-w // 4), 3)).astype(np.float32)
    main = np.kron(base, np.ones((4, 4, 1), np.float32))[:h, :w].astype(np.uint8)
    add = np.roll(main, 6, axis=1).astype(np.int16) + rng.integers(-3, 4, main.shape)
    return main, np.clip(add, 0, 255).astype(np.uint8)


def gray_rgb(x):
    """A float gray view as u8 RGB (rounded, clipped)."""
    g = np.clip(np.round(x), 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def parity_times(main, add, dev, reps=PARITY_REPS):
    """The parity pipeline on the card: the median over ``reps`` runs (after
    a warm-up) of each phase's ms and of the whole call's (host clock,
    synchronised), with the rings phase B swept, the distinct leaves and the
    share of pixels matched."""
    from stepth_tpu_torch.match import parity

    m, a = torch.as_tensor(main, device=dev), torch.as_tensor(add, device=dev)
    parity.depth_from_additional(m, a, PRECISION)
    runs = []
    for _ in range(reps):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parity.depth_from_additional(m, a, PRECISION, stats=stats)
        torch.cuda.synchronize()
        stats["total_s"] = time.perf_counter() - t0
        runs.append(stats)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def print_parity_times(shape, t, card):
    print(f"  parity {shape[0]}x{shape[1]} on the card (median of {PARITY_REPS}), {card}: "
          f"total {t['total_s'] * 1e3:.4f} ms = subdivide {t['subdivide_s'] * 1e3:.4f} + "
          f"phase A {t['phase_a_s'] * 1e3:.4f} + phase B {t['phase_b_s'] * 1e3:.4f} + "
          f"normalise {t['normalize_s'] * 1e3:.4f} ms; phase B swept {int(t['rings'])} "
          f"rings; {int(t['leaves'])} distinct leaves; {t['matched_share']:.6f} of pixels "
          f"matched")


def reference_flows(dev, card, drive, prod, prod_launches, sad_model, pair):
    """Phase 6, the reference's own flows through the port's entry points
    (returns 6a's pair, its parity depth from the card and parity's ms):
    a. parity at the reference's own size through ``DepthFrame`` (depth,
       then invert, foreground, apply_mask), the card bit-equal to the CPU,
       and its phase times there and at 1080p;
    b. the ``hierarchical`` backend at 1080p (median disparity, ms/frame,
       peak memory, agreement with ``hierarchical-pallas``) and the card
       against the CPU at 270×480;
    c. the CLI in-process: ``stereo`` (production, launch counts equal to
       ``prod_launches``, PNG equal to the model call), ``video`` on a
       9-frame 1080p clip (every disparity equal to ``model.video(4)``),
       ``depth`` and ``foreground`` (equal to a.);
    d. ``image_pair_loader`` onto the card over the clip's PNGs."""
    from stepth_tpu_torch import DepthFrame, cli
    from stepth_tpu_torch.config import MatchConfig, PyramidConfig
    from stepth_tpu_torch.core import io
    from stepth_tpu_torch.core.loader import image_pair_loader
    from stepth_tpu_torch.models.stereo import StereoModel

    t_phase = time.perf_counter()
    H, W = pair[0].shape
    left, right = (torch.as_tensor(a, device=dev) for a in pair)

    # 6a. parity through DepthFrame: the card against the CPU
    print(f"== 6a. parity through DepthFrame, {PARITY_SHAPE[0]}x{PARITY_SHAPE[1]} RGB, "
          f"precision {PRECISION}, card: {card}")
    main, add = parity_pair(*PARITY_SHAPE, seed=SEED)
    flows = []  # the card's, then the CPU's
    for d in (dev, torch.device("cpu")):
        f = DepthFrame.from_array(main, device=d).load_depth_from_additional(add, PRECISION)
        fg = f.invert_depth().select_foreground().apply_mask()
        if f.depth.device.type != d.type or fg.image.device.type != d.type:
            raise AssertionError(f"parity frames left {d}")
        flows.append([t.cpu() for t in (f.depth, fg.mask, fg.image)])
    for name, got, want in zip(("depth", "foreground mask", "masked image"), *flows):
        if not torch.equal(want, got):
            raise AssertionError(f"parity {name}: card != CPU at {int((want != got).sum())}")
    depth, fg_mask, fg_image = flows[0]
    if not bool(depth.any()):
        raise AssertionError("parity depth is all zero")
    print(f"  depth, foreground mask and masked image: card == CPU bit for bit; depth max "
          f"{int(depth.max())}, {float((depth > 0).float().mean()):.4f} of pixels nonzero, "
          f"foreground share {float((fg_mask == 255).float().mean()):.4f}")
    parity_t = parity_times(main, add, dev)
    print_parity_times(PARITY_SHAPE, parity_t, card)
    main_hd, add_hd = gray_rgb(pair[0]), gray_rgb(pair[1])
    print_parity_times((H, W), parity_times(main_hd, add_hd, dev), card)

    # 6b. the hierarchical backend (plain torch: no kernel)
    print(f"== 6b. StereoModel(backend='hierarchical'), sad, D=128, levels=4, {H}x{W}")
    sad = MatchConfig(num_disparities=128, window=9, cost="sad")
    hier = StereoModel(backend="hierarchical", match=sad,
                       pyramid=PyramidConfig(levels=4, coarsest_disparities=16))
    res, launches = drive(lambda: hier(left, right))
    if any(launches.values()):
        raise AssertionError(f"hierarchical launched kernels: {launches}")
    d = res.disparity
    if d.shape != (H, W) or not bool(torch.isfinite(d).all()):
        raise AssertionError(f"hierarchical: bad disparity {tuple(d.shape)}")
    med = float(d[50:-50, 100:-100].median())
    print(f"  median disparity {med:.4f} (want 24 +- 0.5); no kernel launched")
    if not abs(med - 24.0) <= 0.5:
        raise AssertionError(f"hierarchical: median disparity {med}")
    near = float(((d - sad_model(left, right).disparity).abs() <= 1.0).float().mean())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hier(left, right)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(lambda: hier(left, right), reps=3)
    print(f"  {H}x{W}: {ms:.4f} ms/frame (median of 3), peak memory of the frame "
          f"{peak / 2**30:.4f} GiB over {base / 2**30:.4f} GiB held; {near:.4f} of pixels "
          f"within 1 px of hierarchical-pallas, card: {card}")
    small = StereoModel(backend="hierarchical", match=sad,
                        pyramid=PyramidConfig(levels=3, coarsest_disparities=16))
    l3, r3 = make_pair(270, 480, seed=SEED)
    want = small(l3, r3, device="cpu")
    got = small(torch.as_tensor(l3, device=dev), torch.as_tensor(r3, device=dev))
    check_equal("hierarchical 270x480 levels=3, card vs CPU", want.disparity, want.valid,
                got.disparity.cpu(), got.valid.cpu(), exact=False)

    # 6c. the CLI, in-process
    census = MatchConfig(num_disparities=128, window=9, cost="census")
    on_card = ["--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp:
        print(f"== 6c. the CLI: stereo --backend hierarchical-pallas --cost census --lr-check "
              f"--disparities 128, {H}x{W}")
        lp, rp, out = (os.path.join(tmp, n) for n in ("l.png", "r.png", "stereo.png"))
        io.save(lp, main_hd)
        io.save(rp, add_hd)
        args = ["stereo", lp, rp, out, "--backend", "hierarchical-pallas", "--cost", "census",
                "--lr-check", "--disparities", "128"]
        rc, launches = drive(lambda: cli.main(on_card + args))
        print(f"  launches: {launches}")
        if rc != 0 or launches != prod_launches:
            raise AssertionError(f"cli stereo: rc {rc}, launches {launches} != {prod_launches}")
        want = StereoModel(backend="hierarchical-pallas", match=census, lr_check=True).depth_u8(
            io.open_rgb(lp), io.open_rgb(rp), dev)
        if not np.array_equal(io.open_luma(out), want.cpu().numpy()):
            raise AssertionError("cli stereo: PNG != disparity_to_depth_u8 of the model call")
        print("  PNG equal to the model call's u8 depth")

        print(f"== 6c. the CLI: video, {len(FLOW_SHIFTS)} frames {H}x{W}, census, --lr-check, "
              f"--chunk 4 --keyframe-interval 4 --format npz")
        cl, crs = make_clip(H, W, FLOW_SHIFTS, seed=SEED)
        ldir, rdir, odir = (os.path.join(tmp, n) for n in ("left", "right", "depth"))
        os.makedirs(ldir)
        os.makedirs(rdir)
        lefts = [os.path.join(ldir, f"{i:03d}.png") for i in range(len(crs))]
        rights = [os.path.join(rdir, f"{i:03d}.png") for i in range(len(crs))]
        for lpath, rpath, cr in zip(lefts, rights, crs):
            io.save(lpath, gray_rgb(cl))
            io.save(rpath, gray_rgb(cr))
        args = on_card + ["video", ldir, rdir, odir, "--cost", "census", "--lr-check",
                          "--chunk", "4", "--keyframe-interval", "4", "--format", "npz"]
        rc, launches = drive(lambda: cli.main(args))
        # keyframes 0, 4 and 8 run the pyramid (K1, K2 at 3 levels), the
        # other 6 frames the seeded level 0 (K2); every frame its right view
        # and epilogue
        n = len(FLOW_SHIFTS)
        want_launches = {k: 0 for k in launches}
        want_launches.update({"K1": 3, "K2": 3 * 3 + n - 3, "K2 plan": 3 * 3 + n - 3,
                              "census": 3 * 4 + n - 3, "K2 emit": n, "K3": n, "K4": n,
                              "K5": n})
        print(f"  launches for {n} frames: {launches}")
        if rc != 0 or launches != want_launches:
            raise AssertionError(f"cli video: rc {rc}, launches {launches} != {want_launches}")
        files = sorted(os.listdir(odir))
        if len(files) != len(crs):
            raise AssertionError(f"cli video wrote {len(files)} files")
        ls = torch.as_tensor(np.stack([io.open_rgb(p) for p in lefts]), device=dev).float()
        rs = torch.as_tensor(np.stack([io.open_rgb(p) for p in rights]), device=dev).float()
        vmodel = StereoModel(backend="hierarchical-pallas", match=census,
                             pyramid=PyramidConfig(levels=4, coarsest_disparities=16),
                             lr_check=True)
        vres = vmodel.video(4)(ls, rs)
        meds = []
        for t, name in enumerate(files):
            data = np.load(os.path.join(odir, name))
            if not (np.array_equal(data["disparity"], vres.disparity[t].cpu().numpy())
                    and np.array_equal(data["valid"], vres.valid[t].cpu().numpy())):
                raise AssertionError(f"cli video frame {t} != model.video(4)")
            meds.append(float(np.median(data["disparity"][50:-50, 100:-100])))
            if not abs(meds[-1] - FLOW_SHIFTS[t]) <= 0.5:  # shifts 24 ... 28 ... 24
                raise AssertionError(f"cli video frame {t}: median {meds[-1]}")
        print(f"  every frame equal to model.video(4); medians {meds}")
        t0 = time.perf_counter()
        cli.main(args)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        vms = cuda_ms(lambda: vmodel.video(4)(ls, rs), reps=3)
        print(f"  frames/s: CLI end to end (decode, copies and npz writes included) "
              f"{len(crs) / e2e:.4f}, model.video(4) alone {len(crs) / vms * 1e3:.4f} "
              f"({vms / len(crs):.4f} ms/frame), card: {card}")

        print(f"== 6c. the CLI: depth and foreground on 6a's pair")
        mp, ap, dout, fout = (os.path.join(tmp, n) for n in ("m.png", "a.png", "d.png", "f.png"))
        io.save(mp, main)
        io.save(ap, add)
        if cli.main(on_card + ["depth", mp, ap, dout]) != 0 or \
                cli.main(on_card + ["foreground", mp, ap, fout]) != 0:
            raise AssertionError("cli depth/foreground failed")
        if not np.array_equal(io.open_luma(dout), depth.numpy()):
            raise AssertionError("cli depth != 6a's depth")
        if not np.array_equal(io.open_rgba(fout), fg_image.numpy()):
            raise AssertionError("cli foreground != 6a's masked image")
        print("  depth PNG equal to 6a's depth; foreground PNG equal to 6a's masked image")

        # 6d. the loader onto the card
        print(f"== 6d. image_pair_loader(device={str(dev)!r}) over the clip's PNGs")
        batches = list(image_pair_loader(list(zip(lefts, rights)), device=dev))
        if len(batches) != len(lefts):
            raise AssertionError(f"loader gave {len(batches)} pairs")
        for b, lpath, rpath in zip(batches, lefts, rights):
            for key, path in (("left", lpath), ("right", rpath)):
                if not (b[key].device.type == dev.type and torch.equal(b[key].cpu(),
                                                       torch.as_tensor(io.open_rgb(path)))):
                    raise AssertionError(f"loader {key} {path}: not on the card or not equal")
        print(f"  {len(batches)} pairs in order, on the card, equal to io.open_rgb")
    print(f"== phase 6 took {time.perf_counter() - t_phase:.1f} s")
    return {"main": main, "add": add, "depth": depth, "parity_ms": parity_t["total_s"] * 1e3}


# the mapping path (phase 7a): tools/mapping_bench.py's defaults, config 5
MAP_SHAPE = (1088, 1920)
MAP_D, MAP_LEVELS, MAP_COARSEST = 128, 4, 16
MAP_KEYFRAMES = 8
MAP_F, MAP_B, MAP_STRAFE = 1000.0, 0.05, 0.02  # focal px, stereo baseline m, m a keyframe
# its BA (points, LM and CG iterations, a checkpoint every, px of noise on
# the observations), which phase 8's drills solve too
MAP_BA_POINTS, MAP_LM, MAP_CG, MAP_EVERY, MAP_SIGMA = (
    BA_SIZES["full"][k] for k in ("pts", "iters", "cg", "every", "sigma"))
MAP_SEED = 7
# the two-view flow (phase 7b): examples/two_view_reconstruction.py's scene.
# Its dense-depth check holds or fails with the RANSAC draw (the pose's
# rectification error), and the port draws other samples than the JAX
# package (a torch generator, not threefry). So the check is made twice:
# on the example's own run, with the pose the JAX package's RANSAC draws
# there (seed 0; tests/test_torch_epipolar.py pins these numbers to it),
# through the port's rectification and dense match; and over the port's
# draws 0-9, on at least as many as the JAX package passes over its own
# draws 0-9 (7, measured by the same test).
TWO_VIEW_SHAPE = (160, 224)
TWO_VIEW_SEEDS = 10
TWO_VIEW_MIN_DEPTH_PASSES = 7
TWO_VIEW_EXAMPLE_POSE = (  # R, t_unit
    [[0.99551922082901, -0.007426485884934664, 0.09426703304052353],
     [0.005092128645628691, 0.9996749758720398, 0.02497962862253189],
     [-0.09442190080881119, -0.024387679994106293, 0.9952334761619568]],
    [-0.9924408793449402, 0.11182159185409546, 0.05056792125105858])


def fill_rows(depth):
    """Row-wise nearest fill of splat holes (0s), as mapping_bench's."""
    d = np.array(depth)
    for r in range(d.shape[0]):
        row = d[r]
        bad = row <= 0
        if bad.all():
            continue
        idx = np.where(~bad, np.arange(len(row)), -1)
        np.maximum.accumulate(idx, out=idx)
        idx[idx < 0] = np.where(~bad)[0][0]
        d[r] = row[idx]
    return d


def mapping_world(h, w, keyframes, dmax, dev, f=MAP_F):
    """mapping_bench's world: the ``curved`` scene's disparity in keyframe 0
    as metric depth (focal ``f`` px, baseline ``MAP_B``); keyframe k strafes
    ``MAP_STRAFE`` m a step in +X, its
    ground-truth depth is keyframe 0's depth splatted into it by the port's
    ``warp_depth_to_ref`` on ``dev`` (holes filled row-wise), and its pair
    is rendered anew from that depth's disparity with a fresh texture
    (``scenes._render``). Returns numpy arrays: ``Z0``, ``poses`` [K, 6],
    ``gt`` [K, H, W], ``lefts``, ``rights`` [K, H, W] and ``intr``."""
    from stepth_tpu_torch.fusion import depthfusion
    from stepth_tpu_torch.utils import scenes

    fb = f * MAP_B
    intr = np.array([f, f, w / 2.0, h / 2.0], np.float32)
    base = scenes.make_scene("curved", h, w, dmax, seed=1)
    z0 = (fb / base.disparity.astype(np.float64)).astype(np.float32)
    poses = np.stack([np.array([0, 0, 0, MAP_STRAFE * k, 0, 0], np.float32)
                      for k in range(keyframes)])
    gt = [z0]
    for k in range(1, keyframes):
        wk = depthfusion.warp_depth_to_ref(z0, poses[0], poses[k], intr, device=dev)
        gt.append(fill_rows(wk.cpu().numpy()))
    gt = np.stack(gt)
    lefts, rights = [], []
    for k in range(keyframes):
        disp_k = np.clip(fb / np.maximum(gt[k], 1e-3), 0.0, dmax - 1.0).astype(np.float32)
        tex = scenes._tex(np.random.default_rng(100 + k), h, w)
        sc = scenes._render([scenes._Layer(disp_k, None, tex)], h, w, 8, f"kf{k}")
        lefts.append(sc.left)
        rights.append(sc.right)
    return dict(z0=z0, poses=poses, gt=gt, lefts=np.stack(lefts), rights=np.stack(rights),
                intr=intr)


def mapping_model(dmax, levels, coarsest):
    """The production matcher of mapping_bench: census + LR."""
    from stepth_tpu_torch.config import MatchConfig, PyramidConfig
    from stepth_tpu_torch.models.stereo import StereoModel

    return StereoModel(backend="hierarchical-pallas",
                       match=MatchConfig(num_disparities=dmax, window=9, cost="census"),
                       pyramid=PyramidConfig(levels=levels, coarsest_disparities=coarsest),
                       lr_check=True)


def mapping_run(world, model, dev, ckpt, ba_points=MAP_BA_POINTS, lm=MAP_LM, cg=MAP_CG,
                every=MAP_EVERY, stages=None, peaks=None):
    """One run of the mapping path on ``dev`` through the port's entry
    points, as mapping_bench runs it: the matcher (``video(4)``) over the
    clip, metric depth and ``fuse_depths`` into keyframe 0, ``posegraph.
    optimize`` over noisy odometry plus a loop closure, and
    ``solve_resumable`` over ``ba_points`` points seen by every keyframe
    (checkpoint at ``ckpt``, removed first). ``stages`` (a ``StageTimes``)
    times each stage, synchronised; ``peaks`` gets, on a card, each stage's
    peak memory above what was allocated when it began (``max_memory_
    allocated`` after ``reset_peak_memory_stats``, less ``memory_
    allocated`` then). Returns the stages' outputs."""
    from stepth_tpu_torch.fusion import ba, depthfusion, geometry as geo, posegraph, resumable
    from stepth_tpu_torch.utils.tracing import StageTimes

    stages = stages if stages is not None else StageTimes()
    rng = np.random.default_rng(MAP_SEED)
    poses_np, intr_np = world["poses"], world["intr"]
    keyframes = poses_np.shape[0]
    h, w = world["z0"].shape
    out = {}

    held = {}

    def stage(name):
        if peaks is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held[name] = torch.cuda.memory_allocated(dev)
        return stages.stage(name, block_on=out)

    def peak(name):
        if peaks is not None and dev.type == "cuda":
            peaks[name] = torch.cuda.max_memory_allocated(dev) - held[name]

    with stage("match"):
        clip_l = torch.as_tensor(world["lefts"], device=dev)
        clip_r = torch.as_tensor(world["rights"], device=dev)
        out["match"] = model.video(keyframe_interval=4)(clip_l, clip_r)
    peak("match")
    with stage("fuse"):
        res = out["match"]
        fb = torch.tensor(float(intr_np[0]) * MAP_B, dtype=torch.float32, device=dev)
        out["depths"] = torch.where(res.valid, fb / torch.clamp(res.disparity, min=1e-3), 0.0)
        poses = torch.as_tensor(poses_np, device=dev)
        intr = torch.as_tensor(intr_np, device=dev)
        out["fused"] = depthfusion.fuse_depths(out["depths"], poses, poses[0], intr)
    peak("fuse")
    with stage("pose graph"):
        noisy = poses + torch.as_tensor(rng.normal(0, 0.01, (keyframes, 6)).astype(np.float32),
                                        device=dev)
        noisy[0] = poses[0]
        ei = torch.tensor(list(range(keyframes - 1)) + [0], dtype=torch.int32, device=dev)
        ej = torch.tensor(list(range(1, keyframes)) + [keyframes - 1], dtype=torch.int32,
                          device=dev)
        out["graph"] = posegraph.PoseGraph(noisy, ei, ej, geo.relative(poses[ei], poses[ej]),
                                           torch.ones(keyframes, dtype=torch.float32,
                                                      device=dev))
        out["opt"] = posegraph.optimize(out["graph"], iters=10)
    peak("pose graph")
    with stage("bundle adjustment"):
        ys = rng.integers(8, h - 8, ba_points)
        xs = rng.integers(8, w - 8, ba_points)
        z = torch.as_tensor(world["z0"][ys, xs], device=dev)
        uv0 = torch.as_tensor(np.stack([xs, ys], -1).astype(np.float32), device=dev)
        pts = geo.transform(geo.inverse(poses[0])[None], geo.unproject(uv0, z, intr))
        ci = torch.as_tensor(np.repeat(np.arange(keyframes), ba_points).astype(np.int32),
                             device=dev)
        pi = torch.as_tensor(np.tile(np.arange(ba_points), keyframes).astype(np.int32),
                             device=dev)
        uv = geo.project(geo.transform(poses[ci], pts[pi]), intr)
        uv = uv + torch.as_tensor(rng.normal(0, MAP_SIGMA, tuple(uv.shape)).astype(np.float32),
                                  device=dev)
        pts0 = pts + torch.as_tensor(rng.normal(0, 0.002, tuple(pts.shape)).astype(np.float32),
                                     device=dev)
        out["problem"] = ba.BAProblem(poses=out["opt"], points=pts0, intrinsics=intr,
                                      cam_idx=ci, pt_idx=pi, uv=uv,
                                      weight=torch.ones(keyframes * ba_points,
                                                        dtype=torch.float32, device=dev))
        if os.path.exists(ckpt):
            os.remove(ckpt)
        out["ba"] = resumable.solve_resumable(out["problem"], ckpt, iters=lm, cg_iters=cg,
                                              every=every)
    peak("bundle adjustment")
    out["stages"] = stages
    return out


def print_paired(tag, seen):
    """One line: the kernels a ``drill.checked_stages`` table checked, their
    calls and shapes."""
    print(f"  {tag}, stage by stage against the plain versions, bit-equal: " + "; ".join(
        f"{k} {n}x at " + ", ".join("x".join(map(str, s)) for s in sorted(shapes))
        for k, (n, shapes) in seen.items()))


def depth_accuracy(world, out):
    """mapping_bench's accuracy numbers: fused coverage, conf ≥ 3 share,
    median |dZ|/Z and the share within 1% (fused, conf ≥ 3; single view,
    keyframe 0's own depth)."""
    z0 = world["z0"]
    fdepth = out["fused"].depth.cpu().numpy()
    fconf = out["fused"].confidence.cpu().numpy()
    have = fdepth > 0
    core = have & (fconf >= 3)
    relerr = np.abs(fdepth - z0) / z0
    d0 = out["depths"][0].cpu().numpy()
    single = np.abs(d0 - z0) / z0
    ok = d0 > 0
    return dict(coverage=float(have.mean()), conf3=float(core.mean()),
                fused_median=float(np.median(relerr[core])),
                fused_in1=float((relerr[core] < 0.01).mean()),
                single_median=float(np.median(single[ok])),
                single_in1=float((single[ok] < 0.01).mean()))


def busy_share(trace_path):
    """The device's busy share over a ``device_trace`` Chrome trace: the
    union of its kernel, copy and fill intervals over the span of every
    event traced; with the device's busy ms and the span's ms."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device:
        raise AssertionError(f"{trace_path}: no device activity traced")
    start = min(e["ts"] for e in events)
    span = max(e["ts"] + e.get("dur", 0) for e in events) - start
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / span, busy / 1e3, span / 1e3


def two_view_scene(h, w):
    """examples/two_view_reconstruction.py's rig: a textured curved surface
    seen by two cameras (``x_cam2 = R x_cam1 + T``); returns the views, K,
    R, T and a function giving the ground-truth rectified depth median of
    the interior crop for the rectification of a pose estimate."""
    K = np.array([[200.0, 0.0, w / 2], [0.0, 200.0, h / 2], [0.0, 0.0, 1.0]], np.float32)
    R = (rot("y", 5.0) @ rot("x", -2.0)).astype(np.float32)
    T = np.array([-0.8, 0.04, 0.02], np.float32)

    def zsurf(xw, yw):
        return 5.0 + 1.2 * np.sin(1.3 * xw) + 0.9 * np.cos(1.1 * yw)

    def tex(xw, yw):
        v = 120 + 60 * np.sin(7.1 * xw) + 50 * np.cos(5.3 * yw)
        v += 25 * np.sin(13.7 * xw + 11.9 * yw) + 15 * np.cos(23.0 * xw * yw)
        return v

    def render(rays, origin):
        s = (5.0 - origin[2]) / rays[..., 2]
        for _ in range(60):
            X = origin + s[..., None] * rays
            s = (zsurf(X[..., 0], X[..., 1]) - origin[2]) / rays[..., 2]
        X = origin + s[..., None] * rays
        return tex(X[..., 0], X[..., 1]).astype(np.float32)

    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    pix = np.stack([xx, yy, np.ones_like(xx)], -1)
    rays1 = np.einsum("ij,hwj->hwi", np.linalg.inv(K), pix)
    img1 = render(rays1, np.zeros(3, np.float32))
    img2 = render(np.einsum("ji,hwj->hwi", R, rays1), -R.T @ T)

    def gt_median(R_est, T_est, K_new):
        """Median ground-truth depth of the rectified left camera over the
        interior crop (rays from K_new and the rectifying rotation of the
        estimate, intersected with the surface)."""
        c2 = -R_est.T @ T_est
        v1 = c2 / np.linalg.norm(c2)
        v2 = np.cross([0.0, 0.0, 1.0], v1)
        v2 /= np.linalg.norm(v2)
        v3 = np.cross(v1, v2)
        R_new = np.stack([v1, v2, v3]).astype(np.float32)
        rays = np.einsum("ji,hwj->hwi", R_new, np.einsum("ij,hwj->hwi", np.linalg.inv(K_new), pix))
        s = 5.0 / rays[..., 2]
        for _ in range(60):
            X = s[..., None] * rays
            s = zsurf(X[..., 0], X[..., 1]) / rays[..., 2]
        z = np.einsum("j,hwj->hw", v3.astype(np.float32), s[..., None] * rays)
        return float(np.median(z[24:-24, 32:-32]))

    return img1, img2, K, R, T, gt_median


def two_view(img1, img2, K, dev, rectify_backend, seed=0, matches=None, pose=None):
    """The two-view flow on ``dev``: features, pose (RANSAC drawn from
    ``seed``, cheirality, two-view BA), rectification with the estimate (the
    known baseline sets the scale), the dense match (``hierarchical-pallas``,
    SAD, D=64) and metric depth. ``matches`` (uv1, uv2) skips the features;
    ``pose`` (R, t_unit) skips the features and the pose. Returns the
    corners (None when skipped), the matches, the pose, the dense median
    depth of the interior crop, the views, the maps, the rectified pair, the
    model and its match result."""
    from stepth_tpu_torch.config import MatchConfig, PyramidConfig
    from stepth_tpu_torch.fusion import epipolar, geometry as geo
    from stepth_tpu_torch.match import features
    from stepth_tpu_torch.models.stereo import StereoModel
    from stepth_tpu_torch.ops import rectify

    baseline = float(np.linalg.norm(np.array([-0.8, 0.04, 0.02], np.float32)))
    l1 = torch.as_tensor(img1, device=dev)
    l2 = torch.as_tensor(img2, device=dev)
    corners = None
    if pose is not None:
        R_est, t_unit = (torch.as_tensor(np.asarray(v, np.float32), device=dev) for v in pose)
    else:
        if matches is None:
            corners = features.harris_corners(l1, max_corners=512)
            matches = features.match_pair_features(l1, l2, max_corners=512, min_similarity=0.8)
        R_est, t_unit, _ = epipolar.pose_from_correspondences(*matches, K, K, seed=seed)
    T_est = t_unit * baseline
    maps = rectify.rectify_maps(K, K, R_est, T_est, img1.shape)
    rl, rr = rectify.rectify_pair(l1, l2, maps, backend=rectify_backend)
    model = StereoModel(backend="hierarchical-pallas",
                        match=MatchConfig(num_disparities=64, window=9, cost="sad"),
                        pyramid=PyramidConfig(levels=3, coarsest_disparities=16))
    res = model(rl, rr)
    depth = geo.disparity_to_depth(res.disparity, maps.focal, maps.baseline)
    med = float(torch.median(depth[24:-24, 32:-32]))
    return dict(corners=corners, matches=matches, R=R_est.cpu().numpy(),
                t=t_unit.cpu().numpy(), K_new=maps.K_new.cpu().numpy(), depth_median=med,
                T_est=T_est.cpu().numpy(), views=(l1, l2), maps=maps, rectified=(rl, rr),
                model=model, match=res)


def segsum_times(prob, dev, card):
    """Device ms of BA's deterministic segment sums at ``prob``'s index
    sets, both ways: the one-hot product (a full-f32 matmul) and the rows
    sorted once by segment then ``segment_reduce``; beside them the
    library's ``index_add_`` (atomics: not deterministic, never used by the
    port). Widths as one LM step sums them (Hessian blocks with gradients,
    then S·x inside CG)."""
    from stepth_tpu_torch.fusion import ba

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for which, idx, n, widths in (("cameras", prob.cam_idx, prob.poses.shape[0], (42, 6)),
                                  ("points", prob.pt_idx, prob.points.shape[0], (12, 3))):
        order = torch.argsort(idx, stable=True)
        lengths = torch.bincount(idx, minlength=n)
        segs = torch.arange(n, dtype=idx.dtype, device=dev)
        idx64 = idx.long()
        for width in widths:
            x = torch.randn((idx.shape[0], width), generator=gen, device=dev)
            fns = {
                "one-hot": lambda: ba.matmul_f32((idx[:, None] == segs[None, :]).float().T, x),
                "sorted": lambda: torch.segment_reduce(x[order], "sum", lengths=lengths,
                                                       axis=0, unsafe=True),
                "index_add_": lambda: torch.zeros((n, width), device=dev).index_add_(0, idx64, x),
            }
            ms = {k: device_ms(f, launches=20) for k, f in fns.items()}
            gap = float((fns["one-hot"]() - fns["sorted"]()).abs().max())
            print(f"  BA segment sum, {idx.shape[0]} rows x {width} into {n} {which}: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f" (device); one-hot vs sorted max |d| {gap:.3g}, card: {card}")


def mapping_flows(dev, card, drive, err):
    """Phase 7: a. the mapping path at 1088×1920 with 8 keyframes
    (``mapping_run``): the K1–K5 launches of the clip, each stage's time
    and peak memory, the device's busy share over one run (a
    ``device_trace``), the accuracy checks, the resumable and repeated BA
    bit for bit, the card's BA and fusion against CPU tensors, every kernel
    call of the clip against its plain version (``drill.checked_stages``),
    BA's segment sums timed both ways (``segsum_times``); b. the two-view flow at
    160×224 (K11 twice, K1–K3), its kernels against their plain versions,
    the example's pose and depth checks and the corner set against the
    CPU's. Returns the clip's launch counts."""
    from stepth_tpu_torch.fusion import ba, depthfusion, posegraph, resumable
    from stepth_tpu_torch.match import fused_refine
    from stepth_tpu_torch.ops import fused_remap
    from stepth_tpu_torch.utils.tracing import device_trace

    t_phase = time.perf_counter()
    h, w = MAP_SHAPE
    print(f"== 7a. the mapping path, {h}x{w}, {MAP_KEYFRAMES} keyframes, census + LR D={MAP_D} "
          f"levels {MAP_LEVELS}, {MAP_BA_POINTS} BA points x {MAP_KEYFRAMES} cameras, "
          f"{MAP_LM} LM iterations (cg {MAP_CG}, checkpoint every {MAP_EVERY}), card: {card}")
    t0 = time.perf_counter()
    world = mapping_world(h, w, MAP_KEYFRAMES, MAP_D, dev)
    print(f"  world, ground truth and {MAP_KEYFRAMES} pairs rendered in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    model = mapping_model(MAP_D, MAP_LEVELS, MAP_COARSEST)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ba.npz")
        mapping_run(world, model, dev, ckpt)  # warm-up
        torch.cuda.synchronize()
        peaks = {}
        t0 = time.perf_counter()
        out, launches = drive(lambda: mapping_run(world, model, dev, ckpt, peaks=peaks))
        wall = time.perf_counter() - t0
        for k in ("K1", "K2", "K2 emit", "K3", "K4", "K5"):
            if launches[k] < 1:
                raise AssertionError(f"mapping clip: {k} not launched")
        if launches["K2 plan"] != launches["K2"]:
            raise AssertionError(f"mapping clip: K2 plan launched {launches['K2 plan']} times, "
                                 f"K2 {launches['K2']}")
        if launches["census"] != launches["K1"] + launches["K2"]:  # one a K1 or K2 call
            raise AssertionError(f"mapping clip: the census launched {launches['census']} "
                                 f"times, K1 and K2 {launches['K1']} + {launches['K2']}")
        print("  launches on the clip: " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                                     if v))
        s = out["stages"].summary()
        t = {k: v["total_s"] for k, v in s.items()}
        print(f"  matcher {MAP_KEYFRAMES / t['match']:.4f} frames/s ({t['match'] * 1e3:.4f} ms "
              f"for the clip), fuse {t['fuse'] * 1e3:.4f} ms, pose graph "
              f"{t['pose graph'] * 1e3:.4f} ms, BA {MAP_LM / t['bundle adjustment']:.4f} LM "
              f"iterations/s ({t['bundle adjustment'] * 1e3:.4f} ms with 2 checkpoints); end "
              f"to end {wall * 1e3:.4f} ms (stages synchronised, host clock), card: {card}")
        print("  peak memory per stage, above what was held when it began: " + ", ".join(
            f"{k} {v / 2 ** 30:.4f} GiB" for k, v in peaks.items())
            + f" ({torch.cuda.memory_allocated(dev) / 2 ** 30:.4f} GiB held after the run), "
            f"card: {card}")
        with device_trace(tmp) as prof:
            mapping_run(world, model, dev, ckpt)
            torch.cuda.synchronize()
        share, busy_ms, span_ms = busy_share(os.path.join(tmp, "trace.json"))
        print(f"  device busy {share:.4f} of one traced mapping run ({busy_ms:.4f} of "
              f"{span_ms:.4f} ms; the profiler's own cost included), card: {card}")
        del prof

        acc = depth_accuracy(world, out)
        res = out["match"]
        gt_disp = np.clip(float(world["intr"][0]) * MAP_B / np.maximum(world["gt"], 1e-3), 0,
                          MAP_D - 1)
        valid = res.valid.cpu().numpy()
        epe = float(np.abs(res.disparity.cpu().numpy() - gt_disp)[valid].mean())
        print(f"  clip EPE {epe:.4f} px (valid {valid.mean():.4f}); fused coverage "
              f"{acc['coverage']:.4f}, conf>=3 {acc['conf3']:.4f}; fused |dZ|/Z median "
              f"{acc['fused_median']:.6f} / within 1% {acc['fused_in1']:.4f} against the "
              f"single view's {acc['single_median']:.6f} / {acc['single_in1']:.4f}")
        if not acc["fused_median"] < acc["single_median"]:
            raise AssertionError("fused median |dZ|/Z does not beat the single view's")
        pg_err = float(posegraph.total_error(out["graph"], out["opt"]))
        pose_rmse = float(np.sqrt(np.mean((out["opt"].cpu().numpy() - world["poses"]) ** 2)))
        print(f"  pose graph residual {pg_err:.3e}, pose RMSE against ground truth "
              f"{pose_rmse:.3e}")
        if not pg_err < 1e-6:
            raise AssertionError(f"pose-graph residual {pg_err} >= 1e-6")
        prob, st = out["problem"], out["ba"]
        c0, c1 = float(ba._cost(prob, prob.poses, prob.points)), float(st.cost)
        limit = 1.5 * 2 * MAP_SIGMA ** 2
        print(f"  BA cost {c0:.6f} -> {c1:.6f} (limit 1.5 x 2 sigma^2 = {limit:.4f})")
        if not (c1 < c0 and c1 < limit):
            raise AssertionError(f"BA cost {c0} -> {c1}")

        # the resumable solve interrupted after the first checkpoint, rerun
        class Interrupt(Exception):
            pass

        def interrupt(done, _state):
            if done == MAP_EVERY:
                raise Interrupt()

        os.remove(ckpt)
        try:
            resumable.solve_resumable(prob, ckpt, iters=MAP_LM, cg_iters=MAP_CG,
                                      every=MAP_EVERY, on_segment=interrupt)
            raise AssertionError("the interrupting hook never fired")
        except Interrupt:
            pass
        resumed = resumable.solve_resumable(prob, ckpt, iters=MAP_LM, cg_iters=MAP_CG,
                                            every=MAP_EVERY)
        straight = ba.solve(prob, iters=MAP_LM, cg_iters=MAP_CG)
        again = ba.solve(prob, iters=MAP_LM, cg_iters=MAP_CG)
        for name, a, b in (("resumed (interrupted at 5) vs straight", resumed, straight),
                           ("second straight run vs first", again, straight),
                           ("solve_resumable vs straight", st, straight)):
            for field in ("poses", "points", "cost", "lm_lambda"):
                if not bits_equal(getattr(b, field), getattr(a, field)):
                    raise AssertionError(f"BA {name}: {field} differs")
        print("  BA bit for bit on the card: solve_resumable interrupted at iteration "
              f"{MAP_EVERY} and rerun == a straight solve == a second straight solve")
        cpu = torch.device("cpu")
        prob_cpu = ba.BAProblem(*(t.cpu() for t in prob))
        t0 = time.perf_counter()
        on_cpu = ba.solve(prob_cpu, iters=MAP_LM, cg_iters=MAP_CG)
        t_cpu = time.perf_counter() - t0
        dp = float((straight.poses.cpu() - on_cpu.poses).abs().max())
        dx = float((straight.points.cpu() - on_cpu.points).abs().max())
        print(f"  BA card vs CPU tensors: poses {dp:.3e}, points {dx:.3e}, cost "
              f"{float(straight.cost):.6f} vs {float(on_cpu.cost):.6f} (CPU solve "
              f"{t_cpu:.1f} s)")
        if not (dp <= 5e-3 and dx <= 5e-3 and
                abs(float(straight.cost) - float(on_cpu.cost)) <= 1e-4 + 0.3 * float(on_cpu.cost)):
            raise AssertionError("BA card vs CPU outside the 5e-3 rule")
        poses = torch.as_tensor(world["poses"])
        intr = torch.as_tensor(world["intr"])
        fused_cpu = depthfusion.fuse_depths(out["depths"].cpu(), poses, poses[0], intr)
        fd, fc = out["fused"].depth.cpu(), fused_cpu.depth
        close = (fd - fc).abs() <= 1e-5 * fc.abs()
        share_close = float(close.float().mean())
        print(f"  fuse card vs CPU: {share_close:.6f} of pixels within 1e-5 relative, "
              f"confidence equal at {float((out['fused'].confidence.cpu() == fused_cpu.confidence).float().mean()):.6f}")
        if share_close < 0.999:
            raise AssertionError("fuse card vs CPU: under 99.9% within 1e-5")

        # the clip's kernels at the shapes and plans the clip gives them,
        # against their plain versions, through fused_refine's own loops; the
        # checked path's output is the driven video's
        seen = {}
        checked = fused_refine._match_temporal(
            checked_stages("mapping clip", seen, err),
            torch.as_tensor(world["lefts"], device=dev),
            torch.as_tensor(world["rights"], device=dev), model.match, model.pyramid, 4,
            64, model.lr_check, model._coarse(), None, model.sgm)  # video()'s tile_rows
        if not (torch.equal(checked.disparity, out["match"].disparity)
                and torch.equal(checked.valid, out["match"].valid)):
            raise AssertionError("mapping clip: the checked path's output is not the video's")
        print_paired(f"mapping clip ({MAP_KEYFRAMES} frames, keyframes every 4)", seen)
        for k in ("K1", "K2 plan", "K2", "K2 emit", "K3", "K4", "K5"):
            if seen[k][0] != launches[k]:
                raise AssertionError(f"mapping clip: {k} checked {seen[k][0]} times, "
                                     f"launched {launches[k]}")
        segsum_times(prob, dev, card)
    del out, world

    h2, w2 = TWO_VIEW_SHAPE
    print(f"== 7b. the two-view flow, {h2}x{w2}: features, pose, rectify_pair(backend="
          f"'pallas'), hierarchical-pallas SAD D=64 levels 3, card: {card}")
    img1, img2, K, R_gt, T_gt, gt_median = two_view_scene(h2, w2)
    t0 = time.perf_counter()
    got, tv_launches = drive(lambda: two_view(img1, img2, K, dev, "pallas"))
    t_tv = time.perf_counter() - t0
    print("  launches: " + ", ".join(f"{k} {v}" for k, v in tv_launches.items() if v)
          + f"; {t_tv * 1e3:.4f} ms end to end (first call of the flow), card: {card}")
    for k, n in (("K11", 2), ("K1", 1), ("K2", 2), ("K2 plan", 2), ("census", 0), ("K3", 1)):
        if tv_launches[k] != n:
            raise AssertionError(f"two-view: {k} launched {tv_launches[k]} times, not {n}")
    # K11 and the matcher's kernels at the flow's shapes, against their plain
    # versions on the same inputs
    maps = got["maps"]
    for side, img, m, warped in zip(("left", "right"), got["views"],
                                    (maps.map_left, maps.map_right), got["rectified"]):
        if not bits_equal(fused_remap.remap_bilinear_plain(img, m), warped):
            raise AssertionError(f"two-view: K11 ({side} view) differs from its plain version")
        err("K11", 0.0)
    seen, tv_model = {}, got["model"]
    checked = fused_refine._match_hierarchical(checked_stages("two-view", seen, err),
                                               *got["rectified"], tv_model.match,
                                               tv_model.pyramid, 64, False, "wta", None)
    if not torch.equal(checked.disparity, got["match"].disparity):
        raise AssertionError("two-view: the checked path's output is not the model's")
    print(f"  K11 2x at {h2}x{w2} (gray): bit-equal to its plain version")
    print_paired("two-view matcher", seen)
    ex = two_view(img1, img2, K, dev, "pallas", pose=TWO_VIEW_EXAMPLE_POSE)
    med_gt = gt_median(ex["R"], ex["T_est"], ex["K_new"])
    print(f"  the example's run (the JAX package's pose of its draw 0): dense median depth "
          f"{ex['depth_median']:.4f} vs ground truth {med_gt:.4f}")
    if not abs(ex["depth_median"] - med_gt) < 0.4:
        raise AssertionError("two-view: the example's depth check failed on its own pose")
    depth_passes = 0
    for seed in range(TWO_VIEW_SEEDS):
        r = got if seed == 0 else two_view(img1, img2, K, dev, "pallas", seed=seed,
                                           matches=got["matches"])
        rot_err = float(np.abs(r["R"] - R_gt).max())
        cosang = float(np.dot(r["t"], T_gt / np.linalg.norm(T_gt)))
        t_ang = float(np.rad2deg(np.arccos(np.clip(cosang, -1.0, 1.0))))
        med_gt = gt_median(r["R"], r["T_est"], r["K_new"])
        depth_ok = abs(r["depth_median"] - med_gt) < 0.4
        depth_passes += depth_ok
        print(f"  seed {seed}: {r['matches'][0].shape[0]} matches; |R - R_gt|max {rot_err:.4f}, "
              f"t-direction error {t_ang:.4f} deg; dense median depth "
              f"{r['depth_median']:.4f} vs ground truth {med_gt:.4f}"
              + ("" if depth_ok else " (off by 0.4 or more)"))
        if not (rot_err < 3e-2 and t_ang < 9.0):
            raise AssertionError(f"two-view seed {seed}: the example's pose checks failed")
    print(f"  dense depth within 0.4 on {depth_passes} of the port's {TWO_VIEW_SEEDS} draws (at "
          f"least {TWO_VIEW_MIN_DEPTH_PASSES}, the JAX package's count over its own)")
    if depth_passes < TWO_VIEW_MIN_DEPTH_PASSES:
        raise AssertionError("two-view: the dense depth check held on too few draws")
    from stepth_tpu_torch.match import features
    c_card = got["corners"]
    c_cpu = features.harris_corners(img1, max_corners=512, device="cpu")

    def corner_set(c):
        xy = c.xy.cpu().numpy()[c.valid.cpu().numpy()]
        return xy[np.lexsort((xy[:, 1], xy[:, 0]))]

    a, b = corner_set(c_card), corner_set(c_cpu)
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError("two-view: the card's corner set differs from the CPU's")
    print(f"  corner set on the card == on the CPU ({a.shape[0]} valid corners)")
    print(f"== phase 7 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 8: the drills of stepth_tpu_torch.parallel.drill, two worker
# processes on the one card (gloo, transfers staged through the host)
DRILL_TIMEOUT = 600  # seconds a worker pair may take
DRILL_REPS = 3  # timed runs of each distributed call against one process
DRILL_DIE_AT = 5  # 8d: rank 1 exits after the first checkpointed segment
# launches per frame and rank: 8a production on 2 of 4 shards, 8b sgm-pallas
# 4 directions on 2 of 4 shards (K10: ↓y and ↑y on each)
DRILL_LAUNCHES = {
    "hierarchical": {"K1": 2, "K2": 6, "K2 plan": 6, "census": 8, "K2 emit": 2, "K4": 2, "K5": 2,
                     "K3": 2},
    "sgm-pallas": {"K6": 2, "K7": 4, "K10": 4, "K9": 2, "K4": 2, "K5": 2, "K3": 2},
}


def drill_pair(modes, out, *extra, expect=(0, 0), env=None):
    """Run the two workers of a drill against a ``TCPStore`` served here;
    raise unless they exit with ``expect``. Returns their outputs and each
    rank's JSON lines by mode."""
    import datetime

    import torch.distributed as dist

    root = os.path.dirname(os.path.abspath(__file__))
    store = dist.TCPStore("localhost", 0, None, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=DRILL_TIMEOUT))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stepth_tpu_torch.parallel.drill", str(r), "2",
         str(store.port), modes, "--device", "cuda", "--out", out, *extra],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline = time.monotonic() + DRILL_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        print("\n".join(f"    [worker {r}] {line}" for line in o.splitlines()
                        if not line.startswith("{") and "c10d" not in line))
        if p.returncode != expect[r]:
            raise AssertionError(f"drill {modes}: rank {r} exited {p.returncode}, want "
                                 f"{expect[r]}:\n{o[-4000:]}")
    numbers = [{x["drill"]: x for x in map(json.loads, (ln for ln in o.splitlines()
                                                         if ln.startswith("{")))}
               for o in outs]
    return outs, numbers


def multiprocess_drills(card):
    """Phase 8: the multi-process layer on the card, two drill workers
    (``python -m stepth_tpu_torch.parallel.drill``) sharing it under gloo.
    a.-c. in one worker pair: production ``hierarchical-pallas`` at
    1024×1920 on ``global_mesh(data=1, tile=4)`` (2 slots a rank), the
    exact ``sgm-pallas`` relay at 1088×1920 on ``tile=4`` (a shard's rows
    must be a multiple of 8) and BA at the mapping size on ``data=8``; each
    rank's result equal bit for bit to the same call on a one-process mesh
    of the same shape and to the other rank's, every kernel call of a.
    and b. equal to its plain version, the median disparity, the launches
    per frame and rank, the bytes that crossed the process boundary, and
    the distributed call timed against the one-process one in turns. d.
    the resumable drill: rank 1 dies after the first checkpointed segment,
    ``supervisor.supervise`` relaunches rank 0 alone on ``auto_mesh(n_obs,
    devices=["cuda:0"] * 4)``, and the resumed cost must meet phase 7a's
    limit. e. the failure drill: the seconds from the peer's death to its
    detection. Returns each kernel's launches in a. and b., by rank, and
    each rank's bytes sent with the slot owners of a.-c. (``(bytes,
    owners)`` by mode)."""
    from stepth_tpu_torch.utils import supervisor

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        print(f"== 8a-c. two processes on one card: hierarchical-pallas production 1024x1920 "
              f"tile=4, sgm-pallas exact 1088x1920 tile=4, BA 4096 points x 8 cameras "
              f"data=8; card: {card}")
        modes = "hierarchical,sgm-pallas,ba"
        _, nums = drill_pair(modes, out, "--size", "full", "--check", "--paired", "--reps",
                             str(DRILL_REPS))
        launches = [{} for _ in range(2)]
        sent = {m: [(nums[r][m]["bytes_per_solve" if m == "ba" else "bytes_per_frame"],
                     nums[r][m]["owners"]) for r in range(2)] for m in modes.split(",")}
        for mode in modes.split(","):
            results = [np.load(os.path.join(out, f"{mode}_r{r}.npz")) for r in range(2)]
            for name in results[0].files:
                a, b = results[0][name], results[1][name]
                same = a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
                if not same:
                    raise AssertionError(f"drill {mode}: the ranks' {name} differ")
            n0 = nums[0][mode]
            if mode == "ba":
                print(f"  8c. BA {n0['cams']} cameras x {n0['points']} points, "
                      f"{n0['lm_iters']} LM iterations (cg {n0['cg_iters']}): cost "
                      f"{n0['cost0']:.6f} -> {n0['cost']:.6f}; both ranks equal to each other "
                      f"and to the one-process 8-shard solve bit for bit; "
                      f"{n0['lm_iters_per_s_2p']:.4f} LM iterations/s on 2 processes against "
                      f"{n0['lm_iters_per_s_1p']:.4f} on 1 (median of {DRILL_REPS}, in turns); "
                      f"bytes sent a solve: {nums[0][mode]['bytes_per_solve']} + "
                      f"{nums[1][mode]['bytes_per_solve']}; card: {card}")
                continue
            for r in range(2):
                got = {k: v for k, v in nums[r][mode]["launches"].items() if v}
                if got != DRILL_LAUNCHES[mode]:
                    raise AssertionError(f"drill {mode}: rank {r} launches {got} != "
                                         f"{DRILL_LAUNCHES[mode]}")
                for k, v in got.items():
                    launches[r][k] = launches[r].get(k, 0) + v
                checked = nums[r][mode]["paired"]
                # the census runs inside the K1, K2 and K6 stages
                stages = {"census": ("K1", "K2", "K6")}
                if any(sum(checked.get(st, [0])[0] for st in stages.get(k, (k,))) < v
                       for k, v in DRILL_LAUNCHES[mode].items()):
                    raise AssertionError(f"drill {mode}: rank {r} checked {checked}")
            tag = "8a" if mode == "hierarchical" else "8b"
            print(f"  {tag}. {mode} {tuple(n0['shape'])} on a {n0['mesh'][0]}x{n0['mesh'][1]} "
                  f"mesh over 2 processes: median disparity {n0['median_disparity']:.4f}; "
                  f"both ranks equal to the one-process mesh and to each other bit for bit; "
                  f"every kernel call equal to its plain version ("
                  + ", ".join(f"{k} {v[0]}x" for k, v in nums[0][mode]["paired"].items())
                  + " on rank 0); launches per frame and rank "
                  f"{DRILL_LAUNCHES[mode]}; bytes sent a frame {nums[0][mode]['bytes_per_frame']}"
                  f" + {nums[1][mode]['bytes_per_frame']}; {n0['ms_2p']:.4f} ms/frame on 2 "
                  f"processes against {n0['ms_1p']:.4f} on 1 (median of {DRILL_REPS}, in turns, "
                  f"read on rank 0; runs {[round(x, 4) for x in n0['ms_2p_runs']]} / "
                  f"{[round(x, 4) for x in n0['ms_1p_runs']]}); card: {card}")

        print(f"== 8d. the resumable drill: rank 1 dies after iteration {DRILL_DIE_AT}, the "
              f"survivor resumes alone; card: {card}")
        outs, _ = drill_pair("resumable", out, "--size", "full", expect=(1, 43),
                             env=dict(os.environ, STEPTH_DIE_AT=str(DRILL_DIE_AT)))
        if "resumable drill OK" in outs[0]:
            raise AssertionError("resumable: rank 0 finished after its peer died")
        logs = []
        argv = [sys.executable, "-m", "stepth_tpu_torch.parallel.drill", "0", "1", "0",
                "resumable", "--device", "cuda", "--size", "full", "--out", out]
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        rc = supervisor.supervise(lambda attempt: argv, max_restarts=1, backoff_s=0.1, env=env,
                                  attempt_timeout_s=DRILL_TIMEOUT, log=logs.append)
        if rc != 0:
            raise AssertionError(f"resumable: the relaunched survivor exited {rc}: {logs}")
        final = np.load(os.path.join(out, "final_p0.npz"))
        limit = 1.5 * 2 * MAP_SIGMA ** 2
        if not float(final["cost"]) < limit:
            raise AssertionError(f"resumable: cost {float(final['cost'])} >= {limit}")
        print(f"  resumed on auto_mesh over 4 slots of cuda:0: cost {float(final['cost']):.6f} "
              f"(limit {limit:.4f})")

        print(f"== 8e. the failure drill: rank 1 dies without goodbye; card: {card}")
        _, nums = drill_pair("failure", out, expect=(0, 42))
        print(f"  rank 0 detected the death {nums[0]['failure']['since_death_s']:.4f} s after it "
              f"(barrier raised {nums[0]['failure']['detect_s']:.4f} s after it began)")
    print(f"== phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return launches, sent


# phase 9: the communication model, the host anchors, the projection
PROJECT_CARDS = (2, 4, 8)  # 9d's card counts, on 1 and 2 hosts
ORACLE_TIMEOUT = 900  # seconds 9c's oracle may take at 400x600


def stop(proc):
    """End ``proc`` if it still runs."""
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def start_oracle_depth():
    """9c's ``depth --backend oracle`` on phase 6a's pair, started in a
    process of its own on the host (one core) so that it runs beside phases
    3-8; it prints its own wall ms, and is killed at exit if still running."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_oracle_")
    main, add = parity_pair(*PARITY_SHAPE, seed=SEED)
    paths = [os.path.join(tmp, n) for n in ("main.png", "add.png", "oracle.png")]
    from stepth_tpu_torch.core import io

    io.save(paths[0], main)
    io.save(paths[1], add)
    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, time; from stepth_tpu_torch import cli; t0 = time.perf_counter(); "
            "rc = cli.main(sys.argv[1:]); print('ms', (time.perf_counter() - t0) * 1e3); "
            "sys.exit(rc)")
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", code, "--device", "cpu", "depth", *paths,
                             "--precision", str(PRECISION[0]), "--backend", "oracle"],
                            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    atexit.register(shutil.rmtree, tmp, True)  # runs after the stop below
    atexit.register(stop, proc)
    return {"proc": proc, "dir": tmp, "paths": paths}


def comm_checks(card, tallies, drill_bytes, flows, oracle_run, projections):
    """Phase 9. a. each one-process sharded call of 4i-4j (``tallies``:
    tag -> (tally, report)) against its model, kind by kind, bytes, moves
    and relay hops, exactly; b. each rank's bytes sent in 8a-c against
    ``comm_model.bytes_sent`` for the drill's slot owners; c. ``depth
    --backend native`` and ``--backend oracle`` (host engines) on 6a's pair
    against parity's depth from the card, byte for byte, with the host ms
    of each beside parity's card ms; d. the scaling projection of each of
    ``projections`` (name -> (report of n cards, unsharded ms/frame)), a
    model whose link rates are assumptions."""
    from stepth_tpu_torch import cli, native
    from stepth_tpu_torch.core import io
    from stepth_tpu_torch.parallel import comm_model
    from stepth_tpu_torch.parallel.drill import ba_report, frame_drill

    t_phase = time.perf_counter()
    print(f"== 9a. the transport tally of one call against the communication model "
          f"(one process, the mesh repeating cuda:0); card: {card}")
    for tag, (got, report) in tallies.items():
        want = report.by_kind()
        if got != want:
            raise AssertionError(f"{tag}: tally {got} != model {want}\n{report.table()}")
        print(f"  {tag}: equal by kind, (bytes, moves, relay hops) "
              + ", ".join(f"{k} {v}" for k, v in got.items()))

    print("== 9b. each rank's bytes sent in phase 8 against comm_model.bytes_sent")
    for mode, per_rank in drill_bytes.items():
        report = ba_report("full") if mode == "ba" else frame_drill(mode, "full").report
        for r, (nbytes, owners) in enumerate(per_rank):
            want = comm_model.bytes_sent(report, owners, r)
            if nbytes != want:
                raise AssertionError(f"drill {mode} rank {r}: sent {nbytes} != model {want}")
        print(f"  {mode}: slot owners {per_rank[0][1]}, each rank "
              f"{[b for b, _ in per_rank]} bytes, equal to the model")

    print(f"== 9c. depth --backend native and --backend oracle on 6a's "
          f"{PARITY_SHAPE[0]}x{PARITY_SHAPE[1]} pair against parity on the card; card: {card}")
    t0 = time.perf_counter()
    out, _ = oracle_run["proc"].communicate(timeout=ORACLE_TIMEOUT)
    waited = time.perf_counter() - t0
    if oracle_run["proc"].returncode != 0:
        raise AssertionError(f"depth --backend oracle failed:\n{out[-4000:]}")
    oracle_ms = float(out.split("ms ")[-1])
    mpath, apath, opath = oracle_run["paths"]
    npath = os.path.join(oracle_run["dir"], "native.png")
    t0 = time.perf_counter()
    native.load()  # the g++ build, apart from the call's time
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cli.main(["--device", "cpu", "depth", mpath, apath, npath, "--precision",
                 str(PRECISION[0]), "--backend", "native"]) != 0:
        raise AssertionError("depth --backend native failed")
    native_ms = (time.perf_counter() - t0) * 1e3
    want = flows["depth"].numpy()
    for name, path in (("native", npath), ("oracle", opath)):
        got = io.open_luma(path)
        if not np.array_equal(got, want):
            raise AssertionError(f"depth --backend {name} != parity on the card at "
                                 f"{int((got != want).sum())} pixels")
    print(f"  both PNGs equal to parity's depth from the card byte for byte; host ms (CLI, "
          f"PNG decode and encode included): native {native_ms:.4f} (after its g++ build, "
          f"{build_s:.1f} s), oracle {oracle_ms:.4f} "
          f"(its own process, beside phases 3-8; waited {waited:.1f} s for it here); parity "
          f"on the card {flows['parity_ms']:.4f} ms (6a, median of {PARITY_REPS})")

    print(f"== 9d. scaling projection: a model, not a measurement (no machine here holds "
          f"two cards; NCCL across cards unverified). Link rates assumed: NVLink "
          f"{comm_model.NVLINK_GBPS} GB/s within a host, network {comm_model.NET_GBPS} GB/s "
          f"between hosts; compute: this run's unsharded frame on {card}, divided by n")
    for name, (report_of, ms1) in projections.items():
        for hosts in (1, 2):
            cells = []
            for n in PROJECT_CARDS:
                p = comm_model.project(report_of(n), ms1, n, hosts)
                cells.append(f"n={n}: comm {p.comm_ms:.4f} ms, efficiency {p.efficiency:.4f}")
            print(f"  {name} ({ms1:.4f} ms on 1 card), {hosts} host(s): " + "; ".join(cells))
    print(f"== phase 9 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2

    from stepth_tpu_torch import kernels
    from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
    from stepth_tpu_torch.match import (dense, fused_dense, fused_post, fused_refine,
                                        fused_sgm, pyramid)
    from stepth_tpu_torch.match.sgm import penalties
    from stepth_tpu_torch.core import io
    from stepth_tpu_torch.fusion import geometry
    from stepth_tpu_torch.models.stereo import StereoModel, flagship
    from stepth_tpu_torch.ops import depth as depth_ops
    from stepth_tpu_torch.ops import fused_remap, kmeans, photometric, rectify
    from stepth_tpu_torch.parallel import comm_model, sgm_pallas_sharded, sharded
    from stepth_tpu_torch.parallel.mesh import make_mesh
    from stepth_tpu_torch.utils import scenes
    from stepth_tpu_torch.utils.rig import plane_rig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print("== card (nvidia-smi name, power.limit)")
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 2. build
    print("== build")
    kernels.load()
    info = kernels.build_info
    print(f"  {'built' if info['built'] else 'loaded'} {info['path']} "
          f"in {info['seconds']:.2f} s")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    # 9c's NumPy oracle takes minutes at 400x600: it runs on one host core
    # beside phases 3-8
    oracle_run = start_oracle_depth()

    KERNELS = kernels.registry()
    NOT_WTA = {"K6": 0, "K7": 0, "K8": 0, "K9": 0, "K10": 0, "K11": 0}  # off the WTA paths
    errs = {n: 0.0 for n in KERNELS}
    times = {}

    def err(name, e):
        errs[name] = max(errs[name], e)

    def drive(fn):
        """Run ``fn`` with every launch count and the traffic tally set to
        0; return its output and the counts."""
        for k in KERNELS.values():
            k.launches = 0
        distributed.traffic.reset()
        out = fn()
        torch.cuda.synchronize()
        return out, {n: k.launches for n, k in KERNELS.items()}

    sad = MatchConfig(num_disparities=128, window=9, cost="sad")
    census = MatchConfig(num_disparities=128, window=9, cost="census")
    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    H, W = 1080, 1920
    t_start = t0 = time.perf_counter()
    pairs = {"make_pair": make_pair(H, W, seed=SEED)}
    box = scenes.make_scene("box", H, W, 128, seed=1)
    pairs["box"] = (box.left, box.right)
    print(f"  scenes made in {time.perf_counter() - t0:.1f} s")

    def coarse_of(cfg):
        return MatchConfig(num_disparities=pyr.coarsest_disparities, window=cfg.window,
                           cost=cfg.cost, census_window=cfg.census_window,
                           lr_threshold=None)

    def check_levels(scene, cfg, lefts, rights, lr0):
        """K1 at the coarse level and K2 at each refine level against their
        plain versions (priors from the plain path); with ``lr0`` level 0
        also returns and checks the right view. Returns the plain level-0
        outputs, the K1 times and the per-frame K2 times."""
        c_cfg = coarse_of(cfg)
        got = fused_dense.raw_match(lefts[-1], rights[-1], c_cfg, 16)
        want = fused_dense.raw_match_plain(lefts[-1], rights[-1], c_cfg, 16)
        torch.cuda.synchronize()
        tag = f"{scene} {cfg.cost} K1 {tuple(lefts[-1].shape)} D={c_cfg.num_disparities}"
        err("K1", check_k1(tag, want, got))
        k1 = (cuda_ms(lambda: fused_dense.raw_match(lefts[-1], rights[-1], c_cfg, 16)),
              cuda_ms(lambda: fused_dense.raw_match_plain(lefts[-1], rights[-1], c_cfg, 16)))
        planes_of = None
        if cfg.cost == "census":
            # the census kernel, one launch a pair, against its plain version
            # at each level: bit-equal; ms a call, device ms a launch, plain
            # ms, and its bound (gray read, P planes written, both views)
            rows = []
            for lvl, (lg, rg) in enumerate(zip(lefts, rights)):
                kplanes = dense.census_pair(lg, rg, cfg.census_window)
                pplanes = dense.census_pair_plain(lg, rg, cfg.census_window)
                if not all(torch.equal(g, w_) for g, w_ in zip(kplanes, pplanes)):
                    raise AssertionError(f"{scene} census level {lvl}: not bit-equal")
                err("census", 0.0)
                hl, wl = lg.shape
                out = torch.empty((2, *kplanes[0].shape), dtype=torch.int32, device=dev)
                radius = cfg.census_window // 2
                rows.append((
                    tuple(lg.shape),
                    cuda_ms(lambda: dense.census_pair(lg, rg, cfg.census_window)),
                    device_ms(lambda: dense.CENSUS.launch(
                        dev, lg.data_ptr(), rg.data_ptr(), out.data_ptr(), hl, wl, radius)),
                    cuda_ms(lambda: dense.census_pair_plain(lg, rg, cfg.census_window)),
                    bound(2 * (4 + 4 * dense.census_plane_count(cfg.census_window)) * hl * wl,
                          0)))
            census_rows[scene] = rows
            print(f"  {scene} census kernel (window {cfg.census_window}), bit-equal to the "
                  f"plain census at levels 0-{len(rows) - 1}; a pair: ms, device ms, plain ms, "
                  f"bound ms (bytes), share of the device time:")
            for shape, ms, dms, pms, (bms, _) in rows:
                print(f"    {shape[0]}x{shape[1]}: {ms:.4f}, {dms:.4f}, {pms:.4f}, {bms:.4f}, "
                      f"{bms / dms:.1%}")
            # the kernels alone: K1 and K2 launched on planes computed once
            planes_of = [dense.census_pair(lg, rg, cfg.census_window)
                         for lg, rg in zip(lefts, rights)]
            lc, rc = planes_of[-1]
            hc_, wc_ = lefts[-1].shape
            k1_outs = [torch.empty_like(lefts[-1]) for _ in range(3)]
            k1_right = torch.empty((hc_, wc_), dtype=torch.int64, device=dev)

            def k1_alone():  # the right view's buffer fill, then K1
                k1_right.fill_(fused_dense._RIGHT_START)
                fused_dense.K1.launch(
                    dev, None, None, lc.data_ptr(), rc.data_ptr(), lc.shape[0],
                    k1_outs[0].data_ptr(), k1_right.data_ptr(), k1_outs[1].data_ptr(),
                    k1_outs[2].data_ptr(), hc_, wc_, c_cfg.num_disparities, c_cfg.window, 0, 0,
                    1.0, 0, hc_)

            k1_only = device_ms(k1_alone)
            kernel_only[(scene, cfg.cost, "K1")] = k1_only
            print(f"  {scene} {cfg.cost} K1 alone on precomputed planes: {k1_only:.4f} ms")
        disp, disp_r = want[0], None
        max_base = pyr.coarsest_disparities
        multi = 0
        k2_ms = k2_plain_ms = plan_ms = k2_only = 0.0
        plan_dev = plan_plain = 0.0  # K2_PLAN alone, the plain plan
        plan_bytes = 0  # K2_PLAN's bytes over the three levels, for its bound
        planes = 2 if cfg.cost == "census" else 1  # census window 7: 48 bits
        cand = k2_bytes = 0  # K2's work over the three levels, for its bound
        for lvl in range(pyr.levels - 2, -1, -1):
            h, w = lefts[lvl].shape
            prior = pyramid.upsample2_disparity(disp, h, w)
            max_base *= 2
            radius = pyr.final_radius if lvl == 0 else pyr.refine_radius
            nwin = pyr.final_windows if lvl == 0 else pyr.refine_windows
            lr = lr0 and lvl == 0
            bases, nw, tr = fused_refine.plan_level(prior, 64, max_base, radius, nwin)
            # K2_PLAN against the plain plan of the same padded prior
            padded = fused_refine.pad_prior(prior, tr)
            want_plan = fused_refine.tile_windows_from_prior(padded, tr, max_base, radius, nwin)
            torch.cuda.synchronize()
            if not (torch.equal(bases, want_plan[0]) and torch.equal(nw, want_plan[1])):
                raise AssertionError(f"{scene} {cfg.cost} K2 plan level {lvl}: not bit-equal")
            err("K2 plan", 0.0)
            mean = fused_refine._tile_mean(padded, tr)
            plan_out = (torch.empty_like(bases), torch.empty_like(nw))
            cap = fused_refine._window_cap(max_base, radius, nwin)

            def plan_alone():
                fused_refine.K2_PLAN.launch(
                    dev, padded.data_ptr(), mean.data_ptr(), plan_out[0].data_ptr(),
                    plan_out[1].data_ptr(), *padded.shape, tr, bases.shape[-1], max_base,
                    radius, int(cap <= 1))

            pdev = device_ms(plan_alone)
            pplain = cuda_ms(lambda: fused_refine.tile_windows_from_prior(
                padded, tr, max_base, radius, nwin))
            pbytes = 4 * (padded.numel() + mean.numel() + bases.numel() + nw.numel())
            pbound = bound(pbytes, 0)[0]
            print(f"    level {lvl} plan {tuple(padded.shape)} K={bases.shape[-1]}: bit-equal; "
                  f"K2_PLAN {pdev:.4f} ms on the device, bound {pbound:.4f} ms (bytes), "
                  f"plain plan {pplain:.4f} ms")
            plan_dev, plan_plain, plan_bytes = (plan_dev + pdev, plan_plain + pplain,
                                                plan_bytes + pbytes)
            args_l = (lefts[lvl], rights[lvl], bases, nw, cfg, radius, tr)
            got = fused_refine.refine_planned(*args_l, lr=lr)
            want = fused_refine.refine_planned_plain(*args_l, lr=lr)
            torch.cuda.synchronize()
            n_multi = int((nw > 1).sum())
            multi += n_multi
            nr, nc = nw.shape  # candidates the plan runs: windows x (2R+1) per pixel
            rows = (h - torch.arange(nr, device=dev) * tr).clamp(max=tr)
            cols = (w - torch.arange(nc, device=dev) * 128).clamp(max=128)
            cand += int((nw.clamp(min=1) * rows[:, None] * cols[None, :]).sum()) * (2 * radius + 1)
            k2_bytes += (2 * planes * h * w * 4 + 4 * (bases.numel() + nw.numel())
                         + 4 * h * w + (8 * h * w if lr else 0))
            tag = (f"{scene} {cfg.cost} K2 level {lvl} {h}x{w} R={radius} lr={lr} "
                   f"K={bases.shape[-1]} tiles nw>1: {n_multi}/{nw.numel()}")
            if lr:
                err("K2", check_map(tag, want[0], got[0]))
                e = check_map(tag + " disp_r", want[1], got[1])
                err("K2", e)
                err("K2 emit", e)
                print(f"    right view: {float((want[1] == -1e6).float().mean()):.4f} "
                      f"of pixels uncovered")
            else:
                err("K2", check_map(tag, want, got))
            k2 = cuda_ms(lambda: fused_refine.refine_planned(*args_l, lr=lr))
            if planes_of is not None:  # K2 alone (with its packed buffer's fill under lr)
                lc, rc = planes_of[lvl]
                k2_out = torch.empty_like(lefts[lvl])
                packed = torch.empty((h, w), dtype=torch.int64, device=dev)
                M = fused_refine._region_margin(cfg, radius)

                def k2_alone():
                    if lr:
                        packed.fill_(-1)
                    fused_refine.K2.launch(
                        dev, None, None, lc.data_ptr(), rc.data_ptr(), lc.shape[0],
                        bases.data_ptr(), nw.data_ptr(), k2_out.data_ptr(),
                        packed.data_ptr() if lr else None, h, w, nw.shape[1], bases.shape[-1],
                        tr, radius, cfg.window, M, 0, 0, h, int(lr))

                k2_only += device_ms(k2_alone)
            k2p = cuda_ms(lambda: fused_refine.refine_planned_plain(*args_l, lr=lr))
            pl = cuda_ms(lambda: fused_refine.plan_level(prior, 64, max_base, radius, nwin))
            print(f"    level {lvl}: kernel {k2:.4f} ms, plain {k2p:.4f} ms, plan {pl:.4f} ms")
            k2_ms, k2_plain_ms, plan_ms = k2_ms + k2, k2_plain_ms + k2p, plan_ms + pl
            disp, disp_r = want if lr else (want, None)
        print(f"  {scene} {cfg.cost} K2 per frame (3 levels): kernel {k2_ms:.4f} ms, "
              f"plain {k2_plain_ms:.4f} ms, plan {plan_ms:.4f} ms; tiles nw>1: {multi}")
        print(f"  {scene} {cfg.cost} K2_PLAN per frame (3 levels): {plan_dev:.4f} ms on the "
              f"device, bound {bound(plan_bytes, 0)[0]:.4f} ms, plain plan {plan_plain:.4f} ms")
        plans[(scene, cfg.cost)] = (plan_dev, plan_bytes, plan_ms, plan_plain)
        if planes_of is not None:
            kernel_only[(scene, cfg.cost, "K2")] = k2_only
            print(f"  {scene} {cfg.cost} K2 alone on precomputed planes, 3 levels: "
                  f"{k2_only:.4f} ms")
        if scene == "box" and multi == 0:
            raise AssertionError("box scene planned no multi-window tile")
        work[(scene, cfg.cost)] = bound(k2_bytes, cand * (cost_ops(cfg, planes) + 1))
        return disp, disp_r, k1, (k2_ms, k2_plain_ms)

    # 3a/3b. each kernel against its plain version, at the main paths' shapes
    print("== kernels vs plain versions on the card")
    work = {}  # (scene, cost) -> K2's bound over three levels
    kernel_only = {}  # (scene, cost, kernel) -> device ms of K1 or K2 on precomputed planes
    plans = {}  # (scene, cost) -> K2_PLAN's device ms, bytes, plan_level ms, plain ms (3 levels)
    census_rows = {}  # scene -> per level: shape, ms, device ms, plain ms, bound of the census
    device = {}  # kernel -> device ms per launch at the shape its "ms" was timed at
    prod_maps = {}
    for scene, (left, right) in pairs.items():
        lg = dense.grayscale(left, dev)
        rg = dense.grayscale(right, dev)
        lefts, rights = [lg], [rg]
        for _ in range(pyr.levels - 1):
            lefts.append(pyramid.downsample2(lefts[-1]))
            rights.append(pyramid.downsample2(rights[-1]))
        disp, _, k1, k2 = check_levels(scene, sad, lefts, rights, lr0=False)
        got = fused_post.median3_fused(disp)
        want = fused_post.median3_plain(disp)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{scene} K3: not bit-equal")
        print(f"  {scene} K3 {tuple(disp.shape)}: bit-equal")
        disp_c, disp_r, k1_c, k2_c = check_levels(scene, census, lefts, rights, lr0=True)
        prod_maps[scene] = (disp_c, disp_r)
        if scene == "make_pair":
            times["K1 sad, 135x240 D=16"], times["K2 sad, 3 levels"] = k1, k2
            times["K1"], times["K2"] = k1_c, k2_c
            c0 = census_rows[scene][0]  # the census at 1080x1920
            times["census"], device["census"] = (c0[1], c0[3]), c0[2]
            p = plans[(scene, "census")]
            device["K2 plan"], times["K2 plan"] = p[0], (p[2], p[3])
            times["K3"] = (cuda_ms(lambda: fused_post.median3_fused(disp)),
                           cuda_ms(lambda: fused_post.median3_plain(disp)))
            device["K3"] = device_ms(lambda: fused_post.median3_fused(disp))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = torch.rand((H, W), generator=gen, device=dev) * 128
    if not torch.equal(fused_post.median3_fused(noise), fused_post.median3_plain(noise)):
        raise AssertionError("K3 on a random map: not bit-equal")
    print(f"  K3 random {H}x{W} map: bit-equal")

    # the right-view emit alone, on a synthetic buffer of the level-0 shape:
    # random winners of random plan tiles, a quarter untouched
    nr, nc, K, R = -(-H // 64), -(-W // 128), 16, pyr.final_radius
    bases = torch.randint(0, 128, (nr, nc, K), generator=gen, device=dev, dtype=torch.int32)
    key = torch.randint(0, nc * K * (2 * R + 1), (H, W), generator=gen, device=dev)
    cost = torch.randint(0, 1 << 20, (H, W), generator=gen, device=dev)
    packed = (cost << 32) | key
    packed[torch.rand((H, W), generator=gen, device=dev) < 0.25] = -1
    emit = (packed, bases, 64, R)
    err("K2 emit", check_map(f"K2 emit {H}x{W} synthetic", fused_refine.emit_right_plain(*emit),
                             fused_refine.emit_right(*emit)))
    times["K2 emit"] = (cuda_ms(lambda: fused_refine.emit_right(*emit)),
                        cuda_ms(lambda: fused_refine.emit_right_plain(*emit)))
    device["K2 emit"] = device_ms(lambda: fused_refine.emit_right(*emit))

    # 3c. K1 at full resolution with D=128 and its LR check (flagship)
    fcfg = flagship().match
    lg, rg = (dense.grayscale(a, dev) for a in pairs["make_pair"])
    got = fused_dense.raw_match(lg, rg, fcfg, 32)
    want = fused_dense.raw_match_plain(lg, rg, fcfg, 32)
    torch.cuda.synchronize()
    err("K1", check_k1(f"make_pair sad K1 {H}x{W} D=128 + LR (K4)", want, got))
    times["K1 sad, 1080x1920 D=128 + K4"] = (
        cuda_ms(lambda: fused_dense.raw_match(lg, rg, fcfg, 32)),
        cuda_ms(lambda: fused_dense.raw_match_plain(lg, rg, fcfg, 32)))
    # its bound at this shape: K1 reads two images and writes four maps, K4
    # reads two and writes one (9 B/px); K1 costs and box-sums every
    # (pixel, d) and takes its WTA (2 ops), K4 ~12 ops per pixel
    flagship_bound = bound((24 + 9) * H * W, H * W * (fcfg.num_disparities
                                                     * (cost_ops(fcfg, 1) + 2) + 12))
    print(f"  K1 + K4 {H}x{W} D=128: {times['K1 sad, 1080x1920 D=128 + K4'][0]:.4f} ms, bound "
          f"{flagship_bound[0]:.4f} ms ({flagship_bound[1]})")
    # K1 alone at this shape: the right view's buffer fill and the launch, on
    # the device; its bound without K4 (two images read, four maps written)
    fl_outs = [torch.empty_like(lg) for _ in range(3)]
    fl_right = torch.empty((H, W), dtype=torch.int64, device=dev)

    def k1_flagship():
        fl_right.fill_(fused_dense._RIGHT_START)
        fused_dense.K1.launch(dev, lg.data_ptr(), rg.data_ptr(), None, None, 0,
                              fl_outs[0].data_ptr(), fl_right.data_ptr(), fl_outs[1].data_ptr(),
                              fl_outs[2].data_ptr(), H, W, fcfg.num_disparities, fcfg.window,
                              0, 0, 1.0, 0, H)

    k1_flag_device = device_ms(k1_flagship)
    k1_flag_bound = bound(24 * H * W, H * W * fcfg.num_disparities * (cost_ops(fcfg, 1) + 2))
    print(f"  K1 alone {H}x{W} D=128 (device, with its buffer fill): {k1_flag_device:.4f} ms, "
          f"bound {k1_flag_bound[0]:.4f} ms ({k1_flag_bound[1]}), "
          f"{k1_flag_bound[0] / k1_flag_device:.1%} of it")

    # 3d. K4 and K5 at 1080p: on the production level-0 maps, then on a
    # random map with ~30% invalid pixels
    d_eff = pyr.coarsest_disparities << (pyr.levels - 1)
    for scene, (disp, disp_r) in prod_maps.items():
        want = fused_post.lr_consistency_plain(disp, disp_r, 1.0, d_eff)
        err("K4", check_mask(f"{scene} K4 {H}x{W} D={d_eff}", want,
                             fused_post.lr_consistency_fused(disp, disp_r, 1.0, d_eff)))
        err("K5", check_map(f"{scene} K5 {H}x{W}", fused_post.fill_invalid_plain(disp, want),
                            fused_post.fill_invalid_fused(disp, want)))
        if scene == "make_pair":
            times["K4"] = (cuda_ms(lambda: fused_post.lr_consistency_fused(disp, disp_r, 1.0, d_eff)),
                           cuda_ms(lambda: fused_post.lr_consistency_plain(disp, disp_r, 1.0, d_eff)))
            times["K5"] = (cuda_ms(lambda: fused_post.fill_invalid_fused(disp, want)),
                           cuda_ms(lambda: fused_post.fill_invalid_plain(disp, want)))
            device["K4"] = device_ms(lambda: fused_post.lr_consistency_fused(disp, disp_r, 1.0,
                                                                             d_eff))
            device["K5"] = device_ms(lambda: fused_post.fill_invalid_fused(disp, want))
    rand_l = torch.rand((H, W), generator=gen, device=dev) * 100
    rand_r = torch.where(torch.rand((H, W), generator=gen, device=dev) < 0.3,
                         rand_l + 5.0, rand_l)
    rand_r[:, ::97] = -1e6  # columns no candidate reached
    want = fused_post.lr_consistency_plain(rand_l, rand_r, 1.0, d_eff)
    err("K4", check_mask(f"random K4 {H}x{W}", want,
                         fused_post.lr_consistency_fused(rand_l, rand_r, 1.0, d_eff)))
    invalid = torch.rand((H, W), generator=gen, device=dev) < 0.3
    invalid[7] = True  # an all-invalid row
    err("K5", check_map(f"random K5 {H}x{W}, {float(invalid.float().mean()):.3f} invalid",
                        fused_post.fill_invalid_plain(rand_l, ~invalid),
                        fused_post.fill_invalid_fused(rand_l, ~invalid)))

    # 3e. branches the main paths do not take, at a small unaligned size:
    # SSD, uniqueness, windows 5 and 7, census windows 5 (one plane) and 9
    # (three), a row window (the rows outside [0, g_h) of a halo-extended
    # shard), R=4, the right view, tile_rows rounded up to 8
    print("== off-path branches vs plain versions (70x300)")
    h, w = 70, 300
    sl, sr = make_pair(h, w, shift=12, seed=SEED)
    lg, rg = (torch.as_tensor(a, device=dev).contiguous() for a in (sl, sr))
    for cost, cw, win, uniq, lr_thr, g_row0, g_h in (
            ("ssd", 7, 5, 0.1, None, -4, h - 8), ("sad", 7, 7, 0.1, None, 0, None),
            ("census", 5, 9, 0.1, 1.0, -4, h - 8), ("census", 9, 5, None, 1.0, 0, None)):
        c = MatchConfig(num_disparities=24, window=win, cost=cost, census_window=cw,
                        uniqueness=uniq, lr_threshold=lr_thr)
        got = fused_dense.raw_match(lg, rg, c, 16, g_row0, g_h)
        want = fused_dense.raw_match_plain(lg, rg, c, 16, g_row0, g_h)
        torch.cuda.synchronize()
        tag = (f"K1 {cost} census_window {cw} window {win} uniqueness {uniq} lr {lr_thr} "
               f"g_row0 {g_row0} g_h {g_h}")
        err("K1", check_k1(tag, want, got))
    prior = torch.full((h, w), 10.0, device=dev)
    prior[:, 200:] = 30.0  # a step inside the second 128-column tile: nw > 1
    for cost, cw, win, radius, g_row0, g_h, lr in (
            ("ssd", 7, 5, 2, -4, h - 8, False), ("sad", 7, 7, 4, 0, None, False),
            ("census", 5, 9, 2, 0, None, False), ("sad", 7, 7, 4, 0, None, True),
            ("census", 5, 9, 4, -4, h - 8, True)):
        c = MatchConfig(num_disparities=64, window=win, cost=cost, census_window=cw)
        bases, nw, tr = fused_refine.plan_level(prior, 20, 64, radius, 16)
        args_l = (lg, rg, bases, nw, c, radius, tr, g_row0, g_h, lr)
        got = fused_refine.refine_planned(*args_l)
        want = fused_refine.refine_planned_plain(*args_l)
        torch.cuda.synchronize()
        n_multi = int((nw > 1).sum())
        if n_multi == 0:
            raise AssertionError("step prior planned no multi-window tile")
        tag = (f"K2 {cost} census_window {cw} window {win} R={radius} tile_rows {tr} "
               f"g_row0 {g_row0} g_h {g_h} lr {lr} tiles nw>1: {n_multi}/{nw.numel()}")
        if lr:
            err("K2", check_map(tag, want[0], got[0]))
            e = check_map(tag + " disp_r", want[1], got[1])
            err("K2", e)
            err("K2 emit", e)
        else:
            err("K2", check_map(tag, want, got))
    # K6 on a halo-extended row shard: rows above the image (g_row0 < 0) and
    # past its last row (g_row0 + rows > g_h) cost nothing
    for cost, cw, dtype, g_row0, g_h in (("sad", 7, torch.float32, -4, h - 8),
                                         ("census", 5, torch.bfloat16, -6, h - 9),
                                         ("ssd", 7, torch.float32, 9, 50)):
        c = MatchConfig(num_disparities=24, window=5, cost=cost, census_window=cw)
        got = fused_sgm.aggregated_volume(lg, rg, c, dtype, g_row0, g_h)
        want = fused_sgm.aggregated_volume_plain(lg, rg, c, dtype, g_row0, g_h)
        torch.cuda.synchronize()
        err("K6", check_map(f"K6 {cost} census_window {cw} {str(dtype)[6:]} g_row0 {g_row0} "
                            f"g_h {g_h}", want.float(), got.float()))

    # 3f. the SGM kernels against their plain versions: K6, K7 in every
    # direction (kernel and plain accumulators compared after each launch),
    # K8 onto the sum of all directions but the last, K9 on a 2-direction sum
    print("== SGM kernels vs plain versions on the card")
    sgm4 = SGMConfig(directions=4)
    arrows = {(2, False, 0): "→x", (2, True, 0): "←x", (1, False, 1): "↘",
              (1, False, -1): "↙", (1, True, 1): "↗", (1, True, -1): "↖",
              (1, False, 0): "↓y", (1, True, 0): "↑y"}

    def check_maps(name, want, got, names=("disp", "disp_r", "cbest", "valid")):
        return max(check_map(f"{name} {n}", a, b) for n, a, b in zip(names, want, got))

    def check_sgm(tag, lg, rg, cfg, dtype, ndir, k9=False):
        """K6, K7 for each of the ``ndir`` directions in order, K8 (``ndir``
        4 or 8) and, with ``k9``, K9 (+ K4 under LR) after the first two.
        Returns the plain volume and the sums of 2 and of ``ndir − 1``
        directions."""
        vol = fused_sgm.aggregated_volume(lg, rg, cfg, dtype)
        vol_p = fused_sgm.aggregated_volume_plain(lg, rg, cfg, dtype)
        torch.cuda.synchronize()
        err("K6", check_map(f"{tag} K6", vol_p.float(), vol.float()))
        del vol
        p1, p2 = penalties(cfg, sgm4)
        dirs = fused_sgm.directions(ndir)
        acc = acc_p = None
        sums = {}
        for i, (axis, reverse, shift) in enumerate(dirs):
            if i == len(dirs) - 1:
                sums[ndir - 1] = acc_p.clone()
                if ndir > 2:
                    got = fused_sgm.scan_wta_direction(vol_p, acc_p, p1, p2, cfg)
                    want = fused_sgm.scan_wta_direction_plain(vol_p, acc_p, p1, p2, cfg)
                    torch.cuda.synchronize()
                    err("K8", check_maps(f"{tag} K8", want, got,
                                         ("disp", "disp_r", "cbest", "uok")))
            kw = dict(axis=axis, reverse=reverse, shift=shift)
            acc = fused_sgm.scan_direction(vol_p, acc, p1, p2, **kw)
            acc_p = fused_sgm.scan_direction_plain(vol_p, acc_p, p1, p2, **kw)
            torch.cuda.synchronize()
            err("K7", check_map(f"{tag} K7 {arrows[(axis, reverse, shift)]}",
                                acc_p.float(), acc.float()))
            if i == 1:
                sums[2] = acc_p.clone()
                if k9:
                    want = fused_sgm.wta_from_volume_plain(acc_p, cfg)
                    got = fused_sgm.wta_from_volume(acc_p, cfg)
                    torch.cuda.synchronize()
                    err("K9", check_maps(f"{tag} K9 (2 directions)", want, got))
        return vol_p, sums

    coarse_vols = {}
    for scene, (left, right) in pairs.items():
        lg = dense.grayscale(left, dev)
        rg = dense.grayscale(right, dev)
        for _ in range(pyr.levels - 1):
            lg, rg = pyramid.downsample2(lg), pyramid.downsample2(rg)
        for cfg in (sad, census):
            c_cfg = coarse_of(cfg)
            tag = f"{scene} {cfg.cost} {tuple(lg.shape)} D={c_cfg.num_disparities} window 9"
            coarse_vols[(scene, cfg.cost)] = (lg, rg, c_cfg, *check_sgm(
                tag, lg, rg, c_cfg, torch.float32, 4))
    sgm_cfg = MatchConfig(num_disparities=64, window=5, cost="sad", lr_threshold=1.0)
    lg, rg = (dense.grayscale(a, dev) for a in pairs["make_pair"])
    vol3, sums3 = check_sgm(f"make_pair sad {H}x{W} D=64 window 5", lg, rg, sgm_cfg,
                            torch.float32, 8, k9=True)

    print("== SGM off-path branches vs plain versions (70x300)")
    sl, sr = make_pair(h, w, shift=12, seed=SEED)
    sl, sr = (torch.as_tensor(a, device=dev).contiguous() for a in (sl, sr))
    for cost, cw, D, win, uniq, dtype, ndir in (
            ("ssd", 7, 24, 5, 0.1, torch.float32, 8),
            ("census", 5, 24, 5, 0.1, torch.bfloat16, 4),
            ("census", 5, 144, 5, None, torch.float32, 4),
            ("sad", 7, 144, 7, 0.1, torch.bfloat16, 8)):
        c = MatchConfig(num_disparities=D, window=win, cost=cost, census_window=cw,
                        uniqueness=uniq, lr_threshold=1.0)
        tag = (f"{h}x{w} {cost} census_window {cw} D={D} window {win} uniqueness {uniq} "
               f"{str(dtype)[6:]} {ndir} directions")
        check_sgm(tag, sl, sr, c, dtype, ndir, k9=True)

    # the SGM kernels' times: the sgm-pallas shapes (1080p, D=64) and the
    # hierarchical-sgm coarse level (135x240, D=16, census)
    p1, p2 = penalties(sgm_cfg, sgm4)
    cfg_nolr = MatchConfig(num_disparities=64, window=5, cost="sad", lr_threshold=None)

    def scans(scan_fn, vol, p1, p2):
        """The three K7 launches of a 4-direction frame (→x, ←x, ↓y)."""
        acc = None
        for axis, reverse, shift in fused_sgm.directions(4)[:3]:
            acc = scan_fn(vol, acc, p1, p2, axis=axis, reverse=reverse, shift=shift)
        return acc

    pr = PLAIN_SGM_REPS
    times["K6"] = (cuda_ms(lambda: fused_sgm.aggregated_volume(lg, rg, sgm_cfg)),
                   cuda_ms(lambda: fused_sgm.aggregated_volume_plain(lg, rg, sgm_cfg), pr))
    k7 = (cuda_ms(lambda: scans(fused_sgm.scan_direction, vol3, p1, p2)),
          cuda_ms(lambda: scans(fused_sgm.scan_direction_plain, vol3, p1, p2), pr))
    times["K7"] = (k7[0] / 3, k7[1] / 3)  # per launch, over the three of a frame
    acc3 = scans(fused_sgm.scan_direction, vol3, p1, p2)
    times["K8"] = (cuda_ms(lambda: fused_sgm.scan_wta_direction(vol3, acc3, p1, p2, sgm_cfg)),
                   cuda_ms(lambda: fused_sgm.scan_wta_direction_plain(vol3, acc3, p1, p2,
                                                                       sgm_cfg), pr))
    times["K9"] = (cuda_ms(lambda: fused_sgm.wta_from_volume(sums3[2], cfg_nolr)),
                   cuda_ms(lambda: fused_sgm.wta_from_volume_plain(sums3[2], cfg_nolr), pr))
    # device times: K6 into a volume made once; K8 with its buffer fill; K9
    vol6 = torch.empty_like(vol3)
    device["K6"] = device_ms(lambda: fused_sgm.K6.launch(
        dev, lg.data_ptr(), rg.data_ptr(), None, None, 0, vol6.data_ptr(), 0, H, W, 64,
        sgm_cfg.window, 0, 0, H), 10)
    del vol6
    k8_outs = [torch.empty((H, W), device=dev) for _ in range(3)]
    k8_right = torch.empty((H, W), dtype=torch.int64, device=dev)

    def k8_alone():
        k8_right.fill_(-1)
        fused_sgm.K8.launch(dev, vol3.data_ptr(), acc3.data_ptr(), 0,
                            *(o.data_ptr() for o in k8_outs), k8_right.data_ptr(), 64, H, W,
                            p1, p2, 0, 1.0)

    device["K8"] = device_ms(k8_alone, 10)
    device["K9"] = device_ms(lambda: fused_sgm.wta_from_volume(sums3[2], cfg_nolr))
    scratch = vol3.clone()
    k7_dirs = {}  # arrow -> (one wrapper call, device time per launch) ms
    for axis, reverse, shift in fused_sgm.directions(8):
        def one(axis=axis, reverse=reverse, shift=shift):
            fused_sgm.scan_direction(vol3, scratch, p1, p2, axis=axis, reverse=reverse,
                                     shift=shift)
        a = arrows[(axis, reverse, shift)]
        k7_dirs[a] = (cuda_ms(one), device_ms(one))
        print(f"  K7 {a} {H}x{W} D=64: {k7_dirs[a][0]:.4f} ms one call, {k7_dirs[a][1]:.4f} ms "
              f"per launch over {DEVICE_LAUNCHES} back to back")
    del scratch
    device["K7"] = float(np.mean([k7_dirs[a][1] for a in ("→x", "←x", "↓y")]))
    check_deep_frame(dev, err)
    k7_deep = deep_scan_times(dev, arrows)
    for name in ("K6", "K7", "K8", "K9"):
        print(f"  {name} {H}x{W} D=64: kernel {times[name][0]:.4f} ms, "
              f"plain {times[name][1]:.4f} ms (plain: median of {pr})")
    lg_c, rg_c, c_cfg, vol_c, sums_c = coarse_vols[("make_pair", "census")]
    p1c, p2c = penalties(c_cfg, sgm4)
    acc_c = sums_c[3]
    coarse_times = {
        "K6": (lambda: fused_sgm.aggregated_volume(lg_c, rg_c, c_cfg),
               lambda: fused_sgm.aggregated_volume_plain(lg_c, rg_c, c_cfg)),
        "K7 x3": (lambda: scans(fused_sgm.scan_direction, vol_c, p1c, p2c),
                  lambda: scans(fused_sgm.scan_direction_plain, vol_c, p1c, p2c)),
        "K8": (lambda: fused_sgm.scan_wta_direction(vol_c, acc_c, p1c, p2c, c_cfg),
               lambda: fused_sgm.scan_wta_direction_plain(vol_c, acc_c, p1c, p2c, c_cfg)),
    }
    for name, (k_fn, p_fn) in coarse_times.items():
        k_ms, p_ms = times[f"{name} census 135x240 D=16"] = (cuda_ms(k_fn), cuda_ms(p_fn))
        print(f"  {name} census 135x240 D=16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")

    # 3g. K11 against its plain version: the rig's 1080p rectification maps
    # (both views, gray and 3 channels, fill 3.5), a 720x1280 output from the
    # 1080x1920 source, the identity map, and a map spiked with NaN, +-inf,
    # +-1e6, the last row and column exactly and a value just past the edge
    print("== K11 (bilinear remap) vs its plain version on the card")
    rig_maps = rectify.rectify_maps(RIG_K, RIG_K, RIG_R, RIG_T, (H, W), dist1=RIG_DIST1,
                                    dist2=RIG_DIST2, device=dev)
    gray = torch.rand((H, W), generator=gen, device=dev) * 255
    color = torch.rand((H, W, 3), generator=gen, device=dev) * 255
    wild = rig_maps.map_left.clone()
    flat = wild.view(-1, 2)
    spikes = torch.randperm(H * W, generator=gen, device=dev)[: 8 * 4096].view(8, -1)
    for i, (col, val) in enumerate(((0, float("nan")), (1, float("nan")), (0, float("inf")),
                                    (1, float("-inf")), (0, 1e6), (1, -1e6))):
        flat[spikes[i], col] = val
    flat[spikes[6]] = torch.tensor([W - 1.0, H - 1.0], device=dev)  # both +1 taps clamp
    flat[spikes[7], 0] = float(np.nextafter(np.float32(W - 1), np.float32(W)))
    ident = affine_map(H, W, H, W, 0.0, 1.0, (0.0, 0.0), dev)
    for name, img, m, fill in (
            ("rig left, gray", gray, rig_maps.map_left, 0.0),
            ("rig right, gray", gray, rig_maps.map_right, 0.0),
            ("rig left, 3 channels", color, rig_maps.map_left, 0.0),
            ("rig right, 3 channels, fill 3.5", color, rig_maps.map_right, 3.5),
            ("720x1280 output, fill 3.5", color,
             affine_map(720, 1280, H, W, 0.03, 1.5, (7.3, -4.1), dev), 3.5),
            ("identity", color, ident, 0.0),
            ("NaN/inf/far entries, fill -2", gray, wild, -2.0)):
        got = fused_remap.remap_bilinear_fused(img, m, fill)
        want = fused_remap.remap_bilinear_plain(img, m, fill)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err("K11", e)
        if not (torch.equal(got == fill, want == fill) and torch.equal(got, want)):
            raise AssertionError(f"K11 {name}: not bit-equal (max |d| {e})")
        print(f"  K11 {name}, {tuple(img.shape)} -> {tuple(got.shape)}: bit-equal, fill "
              f"masks equal ({float((got == fill).float().mean()):.4f} filled)")
    if not torch.equal(fused_remap.remap_bilinear_fused(color, ident), color):
        raise AssertionError("K11 identity map: output != input")
    print("  K11 identity map: output equals input")
    # times of one view as the rig path warps it (3 channels), and of a gray
    # one; the yardstick is grid_sample on the same view, its grid normalised
    # once per rig and the image in its NCHW layout (never called by the port)
    m = rig_maps.map_left
    grid = torch.stack([m[..., 0] * (2.0 / (W - 1)) - 1.0, m[..., 1] * (2.0 / (H - 1)) - 1.0],
                       -1)[None].contiguous()
    nchw = color.permute(2, 0, 1)[None].contiguous()

    def grid_sample(x):
        return torch.nn.functional.grid_sample(x, grid, mode="bilinear", padding_mode="border",
                                               align_corners=True)

    times["K11"] = (cuda_ms(lambda: fused_remap.remap_bilinear_fused(color, m)),
                    cuda_ms(lambda: fused_remap.remap_bilinear_plain(color, m)))
    library_ms = {"K11": cuda_ms(lambda: grid_sample(nchw))}
    # device times, in turns: the kernel launched straight into a buffer
    # (no wrapper checks) against grid_sample
    k11_out = torch.empty_like(color)
    k11_device = device_ms_turns(lambda: fused_remap.K11.launch(
        dev, color.data_ptr(), m.data_ptr(), k11_out.data_ptr(), H, W, H, W, 3, 0.0),
        lambda: grid_sample(nchw))
    print(f"  K11 {H}x{W}x3 device time per launch ({DEVICE_LAUNCHES} back to back, in turns): "
          f"kernel {k11_device[0]:.4f} ms, grid_sample {k11_device[1]:.4f} ms")
    k11_gray = (cuda_ms(lambda: fused_remap.remap_bilinear_fused(gray, m)),
                cuda_ms(lambda: fused_remap.remap_bilinear_plain(gray, m)),
                cuda_ms(lambda: grid_sample(gray[None, None])))
    want_in = fused_remap.remap_bilinear_plain(color, m)
    lib = grid_sample(nchw)[0].permute(1, 2, 0)
    inb = ((m[..., 0] >= 0) & (m[..., 0] <= W - 1) & (m[..., 1] >= 0) & (m[..., 1] <= H - 1))
    inside = float((lib - want_in).abs()[inb].max())
    print(f"  K11 {H}x{W}x3 view: kernel {times['K11'][0]:.4f} ms, plain {times['K11'][1]:.4f} ms, "
          f"grid_sample {library_ms['K11']:.4f} ms (in-image max |d| vs grid_sample "
          f"{inside:.3g}); gray: kernel {k11_gray[0]:.4f}, plain {k11_gray[1]:.4f}, "
          f"grid_sample {k11_gray[2]:.4f} ms")

    # 3h. K10 against its plain version: the 1080p D=64 window-5 SAD volume of
    # 3f split at rows 360 and 720 (the shards of 4i), onto its 2-direction
    # sum; each relayed direction through K10 shard by shard against one
    # continuous K7 scan (outputs) and its plain version (the final carry);
    # K10 against its plain version on the middle shard from the relayed
    # carry; at 70x300, D=24, D=144 and bf16, from random carries
    print("== K10 (the sharded relay's seeded scan) vs K7 and its plain version")
    relayed = [(rev, sh) for axis, rev, sh in fused_sgm.directions(8) if axis == 1]

    def relay(scan_carry, vol, acc, cuts, reverse, shift, p1, p2):
        """``acc + L`` of one direction over ``vol`` split at the rows
        ``cuts``, one seeded scan per shard in owner order; returns the sum,
        the carry that entered the middle shard and the last final carry."""
        bounds = list(zip((0,) + cuts, cuts + (vol.shape[1],)))
        outs, carry, into_mid = [None] * len(bounds), None, None
        for i in (range(len(bounds) - 1, -1, -1) if reverse else range(len(bounds))):
            a, b = bounds[i]
            if i == len(bounds) // 2:
                into_mid = carry
            outs[i], carry = scan_carry(vol[:, a:b].contiguous(), acc[:, a:b].contiguous(),
                                        carry, p1, p2, reverse=reverse, shift=shift)
        return torch.cat(outs, 1), into_mid, carry

    acc2 = sums3[2]
    th3 = H // 3  # the shard height of 4i
    for rev, sh in relayed:
        tag = f"{H}x{W} D=64 K10 {arrows[(1, rev, sh)]} split at rows {th3}, {2 * th3}"
        got, into_mid, got_c = relay(fused_sgm.scan_direction_carry, vol3, acc2,
                                     (th3, 2 * th3), rev, sh, p1, p2)
        cont = fused_sgm.scan_direction(vol3, acc2.clone(), p1, p2, axis=1, reverse=rev,
                                        shift=sh)
        _, want_c = fused_sgm.scan_direction_carry_plain(vol3, None, None, p1, p2,
                                                         reverse=rev, shift=sh)
        torch.cuda.synchronize()
        err("K10", check_map(f"{tag} vs continuous K7", cont, got))
        err("K10", check_map(f"{tag}, last carry vs the plain continuous scan's", want_c,
                             got_c))
        mid = (vol3[:, th3:2 * th3].contiguous(), acc2[:, th3:2 * th3].contiguous())
        want = fused_sgm.scan_direction_carry_plain(mid[0], mid[1].clone(), into_mid, p1, p2,
                                                    reverse=rev, shift=sh)
        got = fused_sgm.scan_direction_carry(mid[0], mid[1].clone(), into_mid, p1, p2,
                                             reverse=rev, shift=sh)
        torch.cuda.synchronize()
        err("K10", check_maps(f"{H}x{W} D=64 K10 {arrows[(1, rev, sh)]} middle shard vs plain",
                              want, got, ("out", "carry")))
    for D, dtype in ((24, torch.float32), (144, torch.float32), (24, torch.bfloat16)):
        vol = torch.randint(0, 50, (D, h, w), generator=gen, device=dev).to(dtype)
        acc = torch.randint(0, 500, (D, h, w), generator=gen, device=dev).to(dtype)
        c0 = torch.randint(0, 200, (D, w), generator=gen, device=dev).float()
        for rev, sh in relayed:
            tag = f"{h}x{w} D={D} {str(dtype)[6:]} K10 {arrows[(1, rev, sh)]}"
            kw = dict(reverse=rev, shift=sh)
            want = fused_sgm.scan_direction_carry_plain(vol, acc.clone(), c0, 25.0, 100.0, **kw)
            got = fused_sgm.scan_direction_carry(vol, acc.clone(), c0, 25.0, 100.0, **kw)
            split = relay(fused_sgm.scan_direction_carry, vol, acc, (24, 48), rev, sh, 25.0,
                          100.0)
            cont = fused_sgm.scan_direction(vol, acc.clone(), 25.0, 100.0, axis=1, **kw)
            torch.cuda.synchronize()
            err("K10", check_maps(f"{tag} vs plain", want, got, ("out", "carry")))
            err("K10", check_map(f"{tag} split at rows 24, 48 vs continuous K7", cont.float(),
                                 split[0].float()))
    mid = (vol3[:, th3:2 * th3].contiguous(), acc2[:, th3:2 * th3].clone(),
           vol3[:, 100].clone())
    times["K10"] = (
        cuda_ms(lambda: fused_sgm.scan_direction_carry(*mid, p1, p2, reverse=False)),
        cuda_ms(lambda: fused_sgm.scan_direction_carry_plain(*mid, p1, p2, reverse=False),
                PLAIN_SGM_REPS))
    device["K10"] = device_ms(lambda: fused_sgm.scan_direction_carry(*mid, p1, p2,
                                                                     reverse=False))
    print(f"  K10 ↓y {th3}x{W} D=64 shard: kernel {times['K10'][0]:.4f} ms, plain "
          f"{times['K10'][1]:.4f} ms (plain: median of {PLAIN_SGM_REPS})")

    # 3i. the edges of K1, K2, K3, K5, K6, K7, K8, K10 and K11
    print("== K1, K2, K3, K5, K6, K7, K8, K10 and K11 on ragged shapes, every D, edge plans, "
          "offset views, NaN/inf/signed-zero maps (vs plain versions)")
    check_cost_front_edges(dev, err)
    check_edges(dev, err)
    check_post_edges(dev, err)

    # 4a. the SAD slice end to end, through the user's entry point
    print(f"== end to end: StereoModel(backend='hierarchical-pallas'), sad, {H}x{W}")
    model = StereoModel(backend="hierarchical-pallas", match=sad, pyramid=pyr)
    left, right = (torch.as_tensor(a, device=dev) for a in pairs["make_pair"])
    bl, br = (torch.as_tensor(a, device=dev) for a in pairs["box"])
    res, launches = drive(lambda: model(left, right))
    print(f"  launches per frame: {launches}")
    want_launches = {"K1": 1, "K2": 3, "K2 plan": 3, "census": 0, "K2 emit": 0, "K3": 1,
                     "K4": 0, "K5": 0, **NOT_WTA}
    if launches != want_launches:
        raise AssertionError(f"launch counts {launches} != {want_launches}")

    def check_output(name, res, scene_left, scene_right, plain_fn):
        d = res.disparity
        if d.shape != (H, W) or d.dtype != torch.float32 or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"{name}: bad disparity {d.shape} {d.dtype}")
        plain = plain_fn(scene_left, scene_right)
        e = check_equal(f"{name} kernel path vs plain path", plain.disparity, plain.valid,
                        res.disparity, res.valid)
        if not torch.equal(plain.valid, res.valid):
            raise AssertionError(f"{name}: valid masks differ")
        return e

    def check_median(name, d, want=24.0):
        med = float(d[50:-50, 100:-100].median())
        print(f"  {name}: median disparity {med:.4f} (want {want} +- 0.5)")
        if not abs(med - want) <= 0.5:  # a NaN median fails too
            raise AssertionError(f"{name}: median disparity {med} != {want}")

    gt = torch.as_tensor(box.disparity, device=dev)
    occluded = torch.as_tensor(box.occluded, device=dev)

    def box_quality(name, res):
        epe = float((res.disparity - gt)[~occluded].abs().mean())
        flagged = float((~res.valid & occluded).sum() / occluded.sum())
        print(f"  {name} box scene: EPE vs ground truth (non-occluded) {epe:.4f} px; "
              f"ground-truth-occluded pixels flagged invalid {flagged:.4f}")

    check_median("sad", res.disparity)
    plain_sad = (lambda l, r: fused_refine.match_hierarchical_plain(l, r, sad, pyr))
    check_output("make_pair sad", res, left, right, plain_sad)
    res_box = model(bl, br)
    check_output("box sad", res_box, bl, br, plain_sad)
    box_quality("sad", res_box)

    # 4b. production: census + lr_check
    print(f"== end to end: production, census window 7 + lr_check, {H}x{W}")
    prod = StereoModel(backend="hierarchical-pallas", match=census, pyramid=pyr, lr_check=True)
    plain_prod = (lambda l, r: fused_refine.match_hierarchical_plain(
        l, r, census, pyr, lr_check=True))
    res, prod_launches = drive(lambda: prod(left, right))
    print(f"  launches per frame: {prod_launches}")
    want_launches = {"K1": 1, "K2": 3, "K2 plan": 3, "census": 4, "K2 emit": 1, "K3": 1,
                     "K4": 1, "K5": 1, **NOT_WTA}
    if prod_launches != want_launches:
        raise AssertionError(f"launch counts {prod_launches} != {want_launches}")
    check_median("production", res.disparity)
    print(f"  make_pair valid share {float(res.valid.float().mean()):.4f}")
    check_output("make_pair production", res, left, right, plain_prod)
    res_box = prod(bl, br)
    check_output("box production", res_box, bl, br, plain_prod)
    box_quality("production", res_box)

    # 4c. flagship(): the pallas backend, SAD, D=128 at full resolution, LR
    print(f"== end to end: flagship() (pallas backend), {H}x{W}")
    flag = flagship()
    res, flag_launches = drive(lambda: flag(left, right))
    print(f"  launches per frame: {flag_launches}")
    want_launches = {"K1": 1, "K2": 0, "K2 plan": 0, "census": 0, "K2 emit": 0, "K3": 1,
                     "K4": 1, "K5": 1, **NOT_WTA}
    if flag_launches != want_launches:
        raise AssertionError(f"launch counts {flag_launches} != {want_launches}")
    check_median("flagship", res.disparity)
    plain_flag = (lambda l, r: fused_dense.match_pair_plain(l, r, flag.match))
    check_output("make_pair flagship", res, left, right, plain_flag)

    # 4d. video(keyframe_interval=4) of the production model: 5 frames whose
    # disparity drifts 1 px per frame (keyframes 0 and 4, seeded 1-3)
    print(f"== end to end: production video(keyframe_interval=4), 5 frames {H}x{W}")
    shifts = [24, 25, 26, 27, 28]
    cl, crs = make_clip(H, W, shifts, seed=SEED)
    clip_l = torch.as_tensor(np.stack([cl] * len(shifts)), device=dev)
    clip_r = torch.as_tensor(np.stack(crs), device=dev)
    run = prod.video(keyframe_interval=4)
    vres, video_launches = drive(lambda: run(clip_l, clip_r))
    print(f"  launches for 2 keyframes + 3 seeded frames: {video_launches}")
    want_launches = {"K1": 2, "K2": 2 * 3 + 3, "K2 plan": 2 * 3 + 3, "census": 2 * 4 + 3,
                     "K2 emit": 5, "K3": 5, "K4": 5, "K5": 5, **NOT_WTA}
    if video_launches != want_launches:
        raise AssertionError(f"launch counts {video_launches} != {want_launches}")
    vplain = fused_refine.match_temporal_plain(clip_l, clip_r, census, pyr, 4, lr_check=True)
    for t, s in enumerate(shifts):
        check_median(f"video frame {t}", vres.disparity[t], float(s))
        check_equal(f"video frame {t} kernel path vs plain path", vplain.disparity[t],
                    vplain.valid[t], vres.disparity[t], vres.valid[t])
        if not torch.equal(vplain.valid[t], vres.valid[t]):
            raise AssertionError(f"video frame {t}: valid masks differ")
    _, seeded_launches = drive(lambda: fused_refine.seeded_frame(
        fused_refine.FUSED, clip_l[1], clip_r[1], vres.disparity[0], census, pyr,
        lr_check=True))
    print(f"  launches per seeded frame: {seeded_launches}")
    want_launches = {"K1": 0, "K2": 1, "K2 plan": 1, "census": 1, "K2 emit": 1, "K3": 1,
                     "K4": 1, "K5": 1, **NOT_WTA}
    if seeded_launches != want_launches:
        raise AssertionError(f"launch counts {seeded_launches} != {want_launches}")

    def drive_checked(name, fn, want):
        """``drive(fn)``, then the launch counts against ``want`` (zero for
        kernels it does not name)."""
        out, launches = drive(fn)
        print(f"  {name}: launches {launches}")
        want = {n: want.get(n, 0) for n in KERNELS}
        if launches != want:
            raise AssertionError(f"{name}: launch counts {launches} != {want}")
        return out, launches

    # 4e. hierarchical-sgm: path 1 (SAD) and path 2 (production)
    sgm_paths = {}
    for tag, cfg, lr_check, want in (
            ("path 1, hierarchical-sgm sad", sad, False,
             {"K6": 1, "K7": 3, "K8": 1, "K5": 1, "K3": 2, "K2": 3, "K2 plan": 3}),
            ("path 2, hierarchical-sgm production", census, True,
             {"K6": 1, "K7": 3, "K8": 1, "K5": 2, "K3": 2, "K2": 3, "K2 plan": 3, "census": 4,
              "K2 emit": 1, "K4": 1})):
        print(f"== end to end: {tag}, {H}x{W}")
        m = StereoModel(backend="hierarchical-sgm", match=cfg, pyramid=pyr, sgm=sgm4,
                        lr_check=lr_check)
        plain = (lambda l, r, cfg=cfg, lr_check=lr_check: fused_refine.match_hierarchical_plain(
            l, r, cfg, pyr, lr_check=lr_check, coarse_backend="sgm", sgm=sgm4))
        res, launches = drive_checked(tag, lambda: m(left, right), want)
        check_median(tag, res.disparity)
        check_output(f"make_pair {tag}", res, left, right, plain)
        res_box = m(bl, br)
        check_output(f"box {tag}", res_box, bl, br, plain)
        box_quality(tag, res_box)
        sgm_paths[tag] = (m, plain, launches)

    # 4f. sgm-pallas: path 3 (4 directions), and its 8- and 2-direction branches
    for ndir, want in ((4, {"K6": 1, "K7": 3, "K8": 1, "K4": 1, "K5": 1, "K3": 1}),
                       (8, {"K6": 1, "K7": 7, "K8": 1, "K4": 1, "K5": 1, "K3": 1}),
                       (2, {"K6": 1, "K7": 2, "K9": 1, "K4": 1, "K5": 1, "K3": 1})):
        tag = f"path 3, sgm-pallas {ndir} directions D=64 window 5 LR"
        print(f"== end to end: {tag}, {H}x{W}")
        s_cfg = SGMConfig(directions=ndir)
        m = StereoModel(backend="sgm-pallas", match=sgm_cfg, sgm=s_cfg)
        plain = (lambda l, r, s_cfg=s_cfg: fused_sgm.match_pair_sgm_plain(l, r, sgm_cfg, s_cfg))
        res, launches = drive_checked(tag, lambda: m(left, right), want)
        check_median(tag, res.disparity)
        print(f"  make_pair valid share {float(res.valid.float().mean()):.4f}")
        check_output(f"make_pair {tag}", res, left, right, plain)
        sgm_paths[tag] = (m, plain, launches)

    # 4g. video(keyframe_interval=4) of the path-2 model on the drifting clip
    print(f"== end to end: hierarchical-sgm production video(keyframe_interval=4), "
          f"5 frames {H}x{W}")
    hs_prod = sgm_paths["path 2, hierarchical-sgm production"][0]
    run = hs_prod.video(keyframe_interval=4)
    vres, _ = drive_checked("2 keyframes + 3 seeded frames", lambda: run(clip_l, clip_r),
                            {"K6": 2, "K7": 6, "K8": 2, "K2": 9, "K2 plan": 9, "census": 11,
                             "K2 emit": 5, "K4": 5, "K5": 7, "K3": 7})
    vplain = fused_refine.match_temporal_plain(clip_l, clip_r, census, pyr, 4, lr_check=True,
                                               coarse_backend="sgm", sgm=sgm4)
    for t, s in enumerate(shifts):
        check_median(f"sgm video frame {t}", vres.disparity[t], float(s))
        check_equal(f"sgm video frame {t} kernel path vs plain path", vplain.disparity[t],
                    vplain.valid[t], vres.disparity[t], vres.valid[t])
        if not torch.equal(vplain.valid[t], vres.valid[t]):
            raise AssertionError(f"sgm video frame {t}: valid masks differ")

    # 4h. the rig path: raw distorted RGB views of a textured plane, the gain
    # match, K11 per view, production, metric depth, points and the PLY; then
    # the depth utilities on its u8 depth
    print(f"== end to end: the rig path, {H}x{W} RGB, a textured plane at Z = {RIG_Z}")
    t0 = time.perf_counter()
    rig = plane_rig(H, W, RIG_K, RIG_R, RIG_T, RIG_DIST1, RIG_DIST2, depth=RIG_Z,
                    feature_px=3.5, right_gain=0.85, seed=SEED)
    print(f"  scene rendered in {time.perf_counter() - t0:.1f} s (rig maps made once, in 3g)")
    raw_l, raw_r = (torch.as_tensor(a, device=dev) for a in (rig.left, rig.right))
    K_new = rig_maps.K_new
    intr = torch.stack([K_new[0, 0], K_new[1, 1], K_new[0, 2], K_new[1, 2]])

    def rig_path(ply=None, plain=False):
        """One frame: the user's entry points, or (``plain``) the same steps
        through every kernel's plain version; ``ply`` names a file to write
        the point cloud to."""
        right_n = photometric.normalize_brightness_f32(raw_r, raw_l)
        if plain:
            lr, rr = (fused_remap.remap_bilinear_plain(v.float(), mp)
                      for v, mp in ((raw_l, rig_maps.map_left), (right_n, rig_maps.map_right)))
            res = plain_prod(lr, rr)
        else:
            lr, rr = rectify.rectify_pair(raw_l, right_n, rig_maps, backend="pallas")
            res = prod(lr, rr)
        z = geometry.disparity_to_depth(res.disparity, rig_maps.focal, rig_maps.baseline)
        pts = geometry.depth_to_points(z, intr)
        n = io.save_ply(ply, pts, colors=lr, valid=res.valid) if ply else None
        return lr, rr, res, z, pts, n

    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "rig.ply")
        (lr, rr, res, z, pts, n), rig_launches = drive_checked(
            "rig path, one frame", lambda: rig_path(ply),
            {"K11": 2, "K1": 1, "K2": 3, "K2 plan": 3, "census": 4, "K2 emit": 1, "K4": 1,
             "K5": 1, "K3": 1})
        with open(ply, "rb") as f:
            header = f.read(200).split(b"end_header")[0].decode()
    crop = (slice(100, -100), slice(250, -250))
    med, want = float(res.disparity[crop].median()), float(np.median(rig.disparity[crop]))
    print(f"  rig: median disparity {med:.4f} over [100:-100, 250:-250] (analytic f*B/Z_rect "
          f"{want:.4f} +- 0.5); valid share {float(res.valid.float().mean()):.4f}")
    if abs(med - want) > 0.5:
        raise AssertionError(f"rig path: median disparity {med} != {want}")
    z_med, z_want = float(z[crop].median()), float(np.median(rig.z_rect[crop]))
    print(f"  rig: median depth {z_med:.5f} (analytic {z_want:.5f} +- 2%)")
    if abs(z_med / z_want - 1) > 0.02:
        raise AssertionError(f"rig path: median depth {z_med} != {z_want}")
    keep = int((res.valid & torch.isfinite(pts).all(-1)).sum())
    print(f"  rig: PLY of {n} vertices ({keep} valid finite points; header "
          f"{header.splitlines()[2]!r})")
    if not (n == keep > 0 and f"element vertex {keep}" in header):
        raise AssertionError(f"rig path: PLY holds {n} vertices, want {keep}")
    p_lr, p_rr, p_res, p_z, p_pts, _ = rig_path(plain=True)
    torch.cuda.synchronize()
    for name, a, b in (("rectified left", p_lr, lr), ("rectified right", p_rr, rr)):
        err("K11", check_map(f"rig path {name}, kernel vs plain", a, b))
    check_equal("rig path disparity, kernel path vs plain path", p_res.disparity, p_res.valid,
                res.disparity, res.valid)
    if not (torch.equal(p_res.valid, res.valid) and torch.equal(p_z, z)
            and torch.equal(p_pts, pts)):
        raise AssertionError("rig path: valid, depth or points differ from the plain path")
    print("  rig path: valid mask, depth and points equal to the plain path's")
    d8 = dense.disparity_to_depth_u8(res.disparity, census.num_disparities)
    zones = kmeans.depth_split(d8, 4)
    if zones != kmeans.depth_split(d8.cpu(), 4):
        raise AssertionError("depth_split: the card and the CPU disagree")
    for lo, hi in zones:
        if not torch.equal(depth_ops.slice_mask(d8, lo, hi).cpu(),
                           depth_ops.slice_mask(d8.cpu(), lo, hi)):
            raise AssertionError(f"slice_mask {lo}-{hi}: the card and the CPU disagree")
    print(f"  depth_split(depth_u8, 4) {zones} and slice_mask per zone: card equals CPU")

    def check_same(name, want, got, exact=True):
        """Two MatchResults: the disparity by ``check_equal``; with ``exact``
        the valid masks and costs equal too."""
        e = check_equal(name, want.disparity, want.valid, got.disparity, got.valid, exact=exact)
        if exact and not (torch.equal(want.valid, got.valid) and torch.equal(want.cost, got.cost)):
            raise AssertionError(f"{name}: valid masks or costs differ")
        return e

    # 4i. sgm-pallas sharded over a mesh of [cuda:0] * 3 (path 3 sharded):
    # exact mode at 4 and 8 directions, then windowed mode. ``tallies``: the
    # transport tally of one call of each sharded path of 4i-4j, with its
    # model (phase 9a)
    tallies = {}
    mesh3 = make_mesh(tile=3, devices=["cuda:0"] * 3)
    for ndir in (4, 8):
        tag = f"path 3 sharded, sgm-pallas {ndir} directions exact, 3 shards"
        print(f"== end to end: {tag}, {H}x{W}")
        s_cfg = SGMConfig(directions=ndir)
        m = StereoModel(backend="sgm-pallas", match=sgm_cfg, sgm=s_cfg)
        run = m.sharded(mesh3)
        res, launches = drive_checked(tag, lambda: run(left, right),
                                      {"K6": 3, "K7": 6, "K10": 6 if ndir == 4 else 18,
                                       "K9": 3, "K4": 3, "K5": 3, "K3": 3})
        tallies[tag] = (distributed.traffic.by_kind(), comm_model.comm_sgm_sharded(
            sgm_cfg, H, W, 3, ndir, exact=True, pallas=True))
        check_median(tag, res.disparity)
        unsharded = m(left, right)
        check_same(f"{tag} vs unsharded sgm-pallas", unsharded, res)
        if ndir == 4:
            sharded_launches, run4, model4, unsharded4 = launches, run, m, unsharded
            check_same(f"{tag} vs its plain path", sgm_pallas_sharded.match_pair_sgm_pallas_sharded(
                left, right, sgm_cfg, s_cfg, mesh3, stages=fused_refine.PLAIN), res)
    tag = "path 3 sharded, sgm-pallas 4 directions windowed (warm-up 16), 3 shards"
    print(f"== end to end: {tag}, {H}x{W}")
    res_w, _ = drive_checked(tag, lambda: run4(left, right, exact=False, warmup=16),
                             {"K6": 3, "K7": 12, "K9": 3, "K4": 3, "K5": 3, "K3": 3})
    check_same(f"{tag} vs its plain path", sgm_pallas_sharded.match_pair_sgm_pallas_sharded(
        left, right, sgm_cfg, sgm4, mesh3, exact=False, warmup=16,
        stages=fused_refine.PLAIN), res_w)
    # the reference's statistical rule (tests/test_sgm_pallas_sharded.py:
    # 101-124) against the unsharded frame; "far" = rows at least 64 from a seam
    d = (res_w.disparity - unsharded4.disparity).abs()
    rows = torch.arange(H, device=dev)[:, None]
    far = ((rows - th3).abs() >= 64) & ((rows - 2 * th3).abs() >= 64)
    med, le1 = float(d.median()), float((d <= 1.0).float().mean())
    far_ok = float((d <= 1e-4)[far.expand(H, W)].float().mean())
    print(f"  windowed vs unsharded: median |dd| {med:.4g}, share |dd| <= 1 {le1:.6f}, share "
          f"equal 64+ rows from a seam {far_ok:.6f}")
    if not (med <= 0.1 and le1 > 0.97 and far_ok > 0.99):
        raise AssertionError(f"{tag}: outside the reference's rule")

    # 4j. the other sharded paths
    mesh4 = make_mesh(tile=4, devices=["cuda:0"] * 4)
    tag = "flagship() sharded, 4 shards"
    print(f"== end to end: {tag}, {H}x{W}")
    flag4 = flag.sharded(mesh4)
    res, _ = drive_checked(tag, lambda: flag4(left, right), {"K1": 4, "K4": 4})
    tallies[tag] = (distributed.traffic.by_kind(),
                    comm_model.comm_pallas_sharded(flag.match, H, W, 4))
    check_median(tag, res.disparity)
    check_same(f"{tag} vs unsharded flagship()", flag(left, right), res)
    check_same(f"{tag} vs its plain path", sharded.match_pair_sharded_pallas(
        left, right, flag.match, mesh4, stages=fused_refine.PLAIN), res)

    H2 = H - H % 64  # 1024: 1080 rows admit no mesh at levels=4 (see the docstring)
    l2, r2 = left[:H2], right[:H2]
    refine4 = {"K2": 12, "K2 plan": 12, "K2 emit": 4, "K4": 4, "K5": 4, "K3": 4}
    # the SGM coarse level is the plain-torch relay: close to the unsharded
    # path's fused SGM only (exact-cost ties may break the other way)
    # the census: one launch a shard and level that runs K1 or K2
    for model_, coarse, want, exact in ((prod, "wta", dict(refine4, K1=4, census=16), True),
                                        (hs_prod, "sgm", dict(refine4, census=12), False)):
        tag = f"{model_.backend} production sharded, 4 shards"
        print(f"== end to end: {tag}, {H2}x{W}, tile_rows 32")
        # sharded() drops lr_check, as the reference's does: the LR check
        # goes through the sharded function itself
        run = (lambda l, r, coarse=coarse: sharded.match_hierarchical_sharded(
            l, r, census, pyr, mesh4, coarse_backend=coarse, sgm=sgm4, lr_check=True))
        res, _ = drive_checked(tag, lambda: run(l2, r2), want)
        tallies[tag] = (distributed.traffic.by_kind(), comm_model.comm_hierarchical_sharded(
            census, pyr, H2, W, 4, 32, coarse, sgm4.directions))
        check_median(tag, res.disparity)
        check_same(f"{tag} vs unsharded at tile_rows 32", fused_refine.match_hierarchical_fused(
            l2, r2, census, pyr, 32, lr_check=True, coarse_backend=coarse, sgm=sgm4), res,
            exact=exact)
        check_same(f"{tag} vs its plain path", sharded.match_hierarchical_sharded(
            l2, r2, census, pyr, mesh4, coarse_backend=coarse, sgm=sgm4, lr_check=True,
            stages=fused_refine.PLAIN), res)
        if coarse == "wta":
            prod4 = run

    tag = "production match_temporal_sharded(keyframe_interval=4), 5 frames, 4 shards"
    print(f"== end to end: {tag}, {H2}x{W}")
    cl2, cr2 = clip_l[:, :H2], clip_r[:, :H2]
    vres2, _ = drive_checked(tag, lambda: sharded.match_temporal_sharded(
        cl2, cr2, census, pyr, mesh4, keyframe_interval=4, lr_check=True),
        {"K1": 8, "K2": 36, "K2 plan": 36, "census": 44, "K2 emit": 20, "K4": 20, "K5": 20,
         "K3": 20})
    vwant = fused_refine.match_temporal_fused(cl2, cr2, census, pyr, 4, 32, lr_check=True)
    vplain = sharded.match_temporal_sharded(cl2, cr2, census, pyr, mesh4, keyframe_interval=4,
                                            lr_check=True, stages=fused_refine.PLAIN)
    for t, sft in enumerate(shifts):
        check_median(f"sharded video frame {t}", vres2.disparity[t], float(sft))
        frame_t = [dense.MatchResult(*(f[t] for f in r)) for r in (vwant, vplain, vres2)]
        check_same(f"sharded video frame {t} vs unsharded", frame_t[0], frame_t[2])
        check_same(f"sharded video frame {t} vs its plain path", frame_t[1], frame_t[2])

    tag = "production match_batch_hierarchical_sharded, data=2 (make_pair, box)"
    print(f"== end to end: {tag}, {H}x{W}")
    mesh_d = make_mesh(data=2, tile=1, devices=["cuda:0"] * 2)
    bl2, br2 = torch.stack([left, bl]), torch.stack([right, br])
    bres, _ = drive_checked(tag, lambda: sharded.match_batch_hierarchical_sharded(
        bl2, br2, census, pyr, mesh_d, lr_check=True),
        {"K1": 2, "K2": 6, "K2 plan": 6, "census": 8, "K2 emit": 2, "K4": 2, "K5": 2,
         "K3": 2})
    bplain = sharded.match_batch_hierarchical_sharded(bl2, br2, census, pyr, mesh_d,
                                                      lr_check=True, stages=fused_refine.PLAIN)
    for i, (sl_, sr_) in enumerate(((left, right), (bl, br))):
        got = dense.MatchResult(*(f[i] for f in bres))
        check_same(f"batch frame {i} vs unsharded production", prod(sl_, sr_), got)
        check_same(f"batch frame {i} vs its plain path",
                   dense.MatchResult(*(f[i] for f in bplain)), got)

    # dense and sgm (plain torch) on integer-valued images: every cumulative
    # and path sum is then exact, whatever rows a shard's sums start from
    lq, rq = (torch.round(t[:H // 4, :W // 4]).contiguous() for t in (left, right))
    for backend, kw in (("dense", dict(match=MatchConfig(num_disparities=64, window=9))),
                        ("sgm", dict(match=sgm_cfg, sgm=sgm4))):
        tag = f"{backend} sharded, 3 shards"
        print(f"== end to end: {tag}, {H // 4}x{W // 4} integer images")
        m = StereoModel(backend=backend, **kw)
        res, _ = drive_checked(tag, lambda: m.sharded(mesh3)(lq, rq), {})
        check_median(tag, res.disparity)
        check_same(f"{tag} vs unsharded {backend}", m(lq, rq), res)

    d8 = dense.disparity_to_depth_u8(prod(bl, br).disparity, census.num_disparities)
    want = (d8.int() * 255 // int(d8.max())).to(torch.uint8)
    if not (torch.equal(sharded.normalize_depth_sharded(d8, mesh3), want)
            and not bool(sharded.normalize_depth_sharded(torch.zeros_like(d8), mesh3).any())):
        raise AssertionError("normalize_depth_sharded: not the global max rule")
    print(f"  normalize_depth_sharded on 3 shards of {tuple(d8.shape)} u8 depth: equal to the "
          f"global max rule; all-zero input stays zero")

    # 5. per-frame times
    print(f"== times (CUDA events, median of {REPS} after warm-up), card: {smi[0]}")
    frame = {
        "sad slice": (lambda: model(left, right), lambda: plain_sad(left, right)),
        "sad slice, box": (lambda: model(bl, br), lambda: plain_sad(bl, br)),
        "production": (lambda: prod(left, right), lambda: plain_prod(left, right)),
        "production, box": (lambda: prod(bl, br), lambda: plain_prod(bl, br)),
        "flagship": (lambda: flag(left, right), lambda: plain_flag(left, right)),
        "seeded frame": tuple(
            (lambda p=p: fused_refine.seeded_frame(p, clip_l[1], clip_r[1], vres.disparity[0],
                                                   census, pyr, lr_check=True))
            for p in (fused_refine.FUSED, fused_refine.PLAIN)),
    }
    for tag, (m, plain, _) in sgm_paths.items():
        frame[tag] = (lambda m=m: m(left, right), lambda plain=plain: plain(left, right))
        if tag.startswith("path 1") or tag.startswith("path 2"):
            frame[f"{tag}, box"] = (lambda m=m: m(bl, br), lambda plain=plain: plain(bl, br))
    for name, (k_fn, p_fn) in frame.items():
        reps = PLAIN_SGM_REPS if name.startswith("path 3") else REPS
        k_ms, p_ms = cuda_ms(k_fn), cuda_ms(p_fn, reps)
        print(f"  {H}x{W} {name}: kernel path {k_ms:.4f} ms/frame, plain path {p_ms:.4f} "
              f"ms/frame (plain: median of {reps})")
    t0 = time.perf_counter()
    for _ in range(REPS):
        prod(left, right)
    torch.cuda.synchronize()
    print(f"  production, host wall clock back to back: "
          f"{(time.perf_counter() - t0) * 1e3 / REPS:.4f} ms/frame")
    rig_ms = cuda_ms_turns(rig_path, lambda: prod(lr, rr))
    rig_plain_ms = cuda_ms_turns(lambda: rig_path(plain=True), lambda: plain_prod(lr, rr))
    print(f"  {H}x{W} rig path (no PLY) / production alone on its rectified pair, timed in "
          f"turns: kernel paths {rig_ms[0]:.4f} / {rig_ms[1]:.4f} ms/frame, plain paths "
          f"{rig_plain_ms[0]:.4f} / {rig_plain_ms[1]:.4f} ms/frame")
    with tempfile.TemporaryDirectory() as tmp:
        rig_path(os.path.join(tmp, "rig.ply"))
        t0 = time.perf_counter()
        for _ in range(REPS):
            rig_path(os.path.join(tmp, "rig.ply"))
        torch.cuda.synchronize()
    print(f"  rig path with the PLY written, host wall clock back to back: "
          f"{(time.perf_counter() - t0) * 1e3 / REPS:.4f} ms/frame")
    turns = {}  # sharded / unsharded ms/frame (phase 9d's compute times)
    for name, a, b in (
            ("sgm-pallas 4 directions, 3 shards / unsharded", lambda: run4(left, right),
             lambda: model4(left, right)),
            ("flagship(), 4 shards / unsharded", lambda: flag4(left, right),
             lambda: flag(left, right)),
            (f"production {H2}x{W}, 4 shards / unsharded (tile_rows 32)", lambda: prod4(l2, r2),
             lambda: fused_refine.match_hierarchical_fused(l2, r2, census, pyr, 32,
                                                           lr_check=True))):
        ms = cuda_ms_turns(a, b)
        print(f"  {name}, timed in turns: {ms[0]:.4f} / {ms[1]:.4f} ms/frame")
        turns[name] = ms
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")

    # 6. the reference's flows: parity, DepthFrame/MaskFrame, the hierarchical
    # backend, the CLI and the loader
    flows = reference_flows(dev, smi[0], drive, prod, prod_launches, model, pairs["make_pair"])

    # 7. the mapping path (depth fusion, pose graph, resumable BA) and the
    # two-view flow
    mapping_launches = mapping_flows(dev, smi[0], drive, err)

    # 8. the multi-process layer: the drills on two processes sharing the card
    drill_launches, drill_bytes = multiprocess_drills(smi[0])

    # 9. the communication model against the transport, the host anchors
    # against parity on the card, the scaling projection (9d: the report for
    # n cards, and the unsharded frame's ms)
    comm_checks(smi[0], tallies, drill_bytes, flows, oracle_run, {
        f"production {H2}x{W}": (
            lambda n: comm_model.comm_hierarchical_sharded(census, pyr, H2, W, n, 32),
            turns[f"production {H2}x{W}, 4 shards / unsharded (tile_rows 32)"][1]),
        f"sgm-pallas exact 1088x{W} (compute: path 3's {H}x{W} frame)": (
            lambda n: comm_model.comm_sgm_sharded(sgm_cfg, 1088, W, n, 4, pallas=True),
            turns["sgm-pallas 4 directions, 3 shards / unsharded"][1])})

    # bounds at the shapes each kernel was timed at: K1-K5 on the production
    # path (K1 and K2 census, planes in the bytes; K2 counts the candidates
    # its plans ran), K6-K10 on sgm-pallas at 1080p, D=64 (K7 per launch,
    # averaged over the three of a frame; ops per (pixel, d): a scan step ~8,
    # K8 ~11, K9 3)
    hc, wc = 135, 240
    HW, DV = H * W, 64 * H * W
    ops6 = cost_ops(sgm_cfg, 1)
    bounds = {
        "K1": bound(2 * 2 * hc * wc * 4 + 16 * hc * wc, hc * wc * 16 * (cost_ops(census, 2) + 2)),
        "K2": work[("make_pair", "census")],
        "K2 plan": bound(plans[("make_pair", "census")][1], 0),
        "census": census_rows["make_pair"][0][4],
        "K2 emit": bound(8 * HW + 4 * HW + 4 * nr * nc * K, 0),
        "K3": bound(8 * HW, 38 * HW),
        "K4": bound(9 * HW, 12 * HW),
        "K5": bound(9 * HW, 4 * HW),
        "K6": bound(8 * HW + 4 * DV, DV * ops6),
        "K7": bound((2 + 3 + 3) / 3 * 4 * DV, 8 * DV),
        "K8": bound(8 * DV + 16 * HW, 11 * DV),
        "K9": bound(4 * DV + 16 * HW, 3 * DV),
        # one launch on an H/3-row shard: vol + acc read, out written, and the
        # two f32 [D, W] carries; ~8 ops per (pixel, d), as K7
        "K10": bound(12 * DV // 3 + 2 * 4 * 64 * W, 8 * DV // 3),
        # one 3-channel view: the map (8 B/px), source and output (12 B/px
        # each); weights 8 ops/px, 7 per channel
        "K11": bound(32 * HW, 29 * HW),
    }
    path3 = "path 3, sgm-pallas 4 directions D=64 window 5 LR"
    origin = {n: ("production, hierarchical-pallas", prod_launches) for n in KERNELS}
    origin.update({n: (path3, sgm_paths[path3][2]) for n in ("K6", "K7", "K8")})
    origin["K9"] = ("path 3, 2 directions", sgm_paths[
        "path 3, sgm-pallas 2 directions D=64 window 5 LR"][2])
    origin["K10"] = ("path 3 sharded, 3 shards, 4 directions", sharded_launches)
    origin["K11"] = ("rig path", rig_launches)
    device["K1"] = kernel_only[("make_pair", "census", "K1")]
    device["K2"] = kernel_only[("make_pair", "census", "K2")]
    box_k2 = (kernel_only[("box", "census", "K2")], work[("box", "census")])
    print(f"  K2 alone on census planes, 3 levels: make_pair {device['K2']:.4f} ms (bound "
          f"{bounds['K2'][0]:.4f}), box {box_k2[0]:.4f} ms (bound {box_k2[1][0]:.4f}, "
          f"{box_k2[1][1]}), card: {smi[0]}")
    device["K11"] = k11_device[0]
    print(f"== kernels against their bounds (H100 SXM peaks: {PEAK_BYTES / 1e12} TB/s, "
          f"{PEAK_F32 / 1e12} TFLOP/s f32), card: {smi[0]}")
    for n in KERNELS:
        print(f"  {n}: {times[n][0]:.4f} ms a call, {device[n]:.4f} ms on the device, bound "
              f"{bounds[n][0]:.4f} ms ({bounds[n][1]}), {bounds[n][0] / device[n]:.1%} of the "
              f"device time")
    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": origin[n][1][n], "path": origin[n][0], "max_abs_err": errs[n],
         "ms": times[n][0], "plain_ms": times[n][1], "bound_ms": bounds[n][0],
         "bound_by": bounds[n][1], "library_ms": library_ms.get(n), "device_ms": device[n],
         "mapping_launches": mapping_launches[n],
         "drill_launches": [drill_launches[r].get(n, 0) for r in range(2)]}
        for n, k in KERNELS.items()
    ]}
    extra = {
        "K1": {"flagship_ms": times["K1 sad, 1080x1920 D=128 + K4"][0],
               "flagship_device_ms": k1_flag_device, "flagship_bound_ms": k1_flag_bound[0],
               "flagship_bound_by": k1_flag_bound[1]},
        "K2": {"box_device_ms": box_k2[0], "box_bound_ms": box_k2[1][0],
               "box_bound_by": box_k2[1][1]},
        "K7": {"ms_by_direction": {a: t[0] for a, t in k7_dirs.items()},
               "device_ms_by_direction": {a: t[1] for a, t in k7_dirs.items()},
               "deep": k7_deep},
        "K11": {"library_device_ms": k11_device[1]},
        "census": {"window": census.census_window, "levels": {
            scene: [{"shape": list(shape), "ms": ms, "device_ms": dms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by}
                    for shape, ms, dms, pms, (bms, by) in rows]
            for scene, rows in census_rows.items()}},
    }
    for n, entry in zip(KERNELS, summary["kernels"]):
        entry.update(extra.get(n, {}))
    for entry in summary["kernels"]:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']}: not launched on {entry['path']}")
    print(f"== chip_smoke took {time.perf_counter() - t_start:.1f} s after the imports")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
