#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. Phases:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernel build (``nvcc`` for sm_90a, from ``stepth_tpu_torch/csrc``);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (1080p hierarchical SAD matcher, D=128 effective): K1 at the
   135×240 coarse level with D=16, K2 at the three refine levels (priors from
   the plain pipeline) on the smooth ``make_pair`` scene and on the ``box``
   edge scene, K3 at 1080×1920; then, at a small unaligned size, the branches
   the main path does not take (SSD cost, uniqueness, windows 5 and 7, a row
   window ``g_row0``/``g_h``, R=4). Kernel and plain version add the same f32
   values in the same order, so every comparison must be bit-equal (the
   "close" rule is checked too);
4. the slice end to end through ``StereoModel(backend="hierarchical-pallas")``:
   launch counts per frame, the recovered disparity, and agreement with the
   plain path on the same card;
5. times (CUDA events, median of ``REPS`` runs after a warm-up) of kernel
   and plain paths, per kernel and per frame.

Any failed check raises and the script exits non-zero. The line before the
last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0  # seed of the smooth pair and the random median input
REPS = 10  # timed runs per measurement (median)
MAX_ERR = 0.0  # kernel vs plain version: bit-equal


def make_pair(h, w, shift=24, seed=0):
    """The benchmark's smooth textured pair (right = left shifted by
    ``shift`` px): box-blurred uniform noise."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, size=(h, w + shift)).astype(np.float32)
    k = np.ones(9, np.float32) / 9
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1, tex)
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0, tex)
    return tex[:, :w], tex[:, shift : shift + w]


def check_equal(name, ref_disp, ref_valid, got_disp, got_valid, atol=0.05):
    """The reference's "close" rule (valid masks agree on > 99.9% of pixels,
    99.9th percentile of |Δd| over pixels valid in both ≤ atol px), then
    equality: masks equal and max |Δd| over all pixels ≤ ``MAX_ERR``.
    Returns the largest |Δd|."""
    rv, gv = ref_valid.cpu().numpy(), got_valid.cpu().numpy()
    agree = float((rv == gv).mean())
    d = (ref_disp.double() - got_disp.double()).abs().cpu().numpy()
    both = rv & gv
    q = float(np.quantile(d[both], 0.999))
    max_err = float(d.max())
    print(f"  {name}: valid agree {agree:.6f}, p99.9 |dd| {q:.3g}, max |dd| {max_err:.3g}")
    if not (agree > 0.999 and q <= atol):
        raise AssertionError(f"{name}: not close (agree {agree}, p99.9 {q})")
    if not (agree == 1.0 and max_err <= MAX_ERR):
        raise AssertionError(f"{name}: not bit-equal (agree {agree}, max |dd| {max_err})")
    return max_err


def check_k1(name, want, got):
    """K1's four outputs (disp, disp_r, cbest, valid) bit-equal; returns
    the largest |Δ| over them."""
    errs = [check_equal(name, want[0], want[3] > 0.5, got[0], got[3] > 0.5),
            check_equal(name + " disp_r", want[1], want[1] >= 0, got[1], got[1] >= 0)]
    ones = torch.ones_like(want[2], dtype=torch.bool)
    errs.append(check_equal(name + " cbest", want[2], ones, got[2], ones, atol=0.0))
    return max(errs)


def cuda_ms(fn):
    """Median ms of ``fn`` over ``REPS`` runs, by CUDA events, after a
    warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2

    from stepth_tpu_torch import kernels
    from stepth_tpu_torch.config import MatchConfig, PyramidConfig
    from stepth_tpu_torch.match import dense, fused_dense, fused_post, fused_refine, pyramid
    from stepth_tpu_torch.models.stereo import StereoModel
    from stepth_tpu_torch.utils import scenes

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
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    cfg = MatchConfig(num_disparities=128, window=9, cost="sad")
    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    coarse_cfg = MatchConfig(num_disparities=pyr.coarsest_disparities, window=cfg.window,
                             cost=cfg.cost, lr_threshold=None)
    H, W = 1080, 1920
    t0 = time.perf_counter()
    pairs = {"make_pair": make_pair(H, W, seed=SEED)}
    box = scenes.make_scene("box", H, W, 128, seed=1)
    pairs["box"] = (box.left, box.right)
    print(f"  scenes made in {time.perf_counter() - t0:.1f} s")

    # 3. each kernel against its plain version, at the main path's shapes
    print("== kernels vs plain versions on the card")
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    times = {}
    for scene, (left, right) in pairs.items():
        lg = dense.grayscale(left, dev)
        rg = dense.grayscale(right, dev)
        lefts, rights = [lg], [rg]
        for _ in range(pyr.levels - 1):
            lefts.append(pyramid.downsample2(lefts[-1]))
            rights.append(pyramid.downsample2(rights[-1]))

        got = fused_dense.raw_match(lefts[-1], rights[-1], coarse_cfg, 16)
        want = fused_dense.raw_match_plain(lefts[-1], rights[-1], coarse_cfg, 16)
        torch.cuda.synchronize()
        tag = f"{scene} K1 {tuple(lefts[-1].shape)} D={coarse_cfg.num_disparities}"
        errs["K1"] = max(errs["K1"], check_k1(tag, want, got))
        if scene == "make_pair":
            times["K1"] = (
                cuda_ms(lambda: fused_dense.raw_match(lefts[-1], rights[-1], coarse_cfg, 16)),
                cuda_ms(lambda: fused_dense.raw_match_plain(lefts[-1], rights[-1], coarse_cfg, 16)),
            )

        disp = want[0]  # priors come from the plain pipeline
        max_base = pyr.coarsest_disparities
        multi = 0
        k2_ms = k2_plain_ms = plan_ms = 0.0
        for lvl in range(pyr.levels - 2, -1, -1):
            h, w = lefts[lvl].shape
            prior = pyramid.upsample2_disparity(disp, h, w)
            max_base *= 2
            radius = pyr.final_radius if lvl == 0 else pyr.refine_radius
            nwin = pyr.final_windows if lvl == 0 else pyr.refine_windows
            bases, nw, tr = fused_refine.plan_level(prior, 64, max_base, radius, nwin)
            args_l = (lefts[lvl], rights[lvl], bases, nw, cfg, radius, tr)
            got = fused_refine.refine_planned(*args_l)
            want = fused_refine.refine_planned_plain(*args_l)
            torch.cuda.synchronize()
            n_multi = int((nw > 1).sum())
            multi += n_multi
            tag = (f"{scene} K2 level {lvl} {h}x{w} R={radius} K={bases.shape[-1]} "
                   f"tiles nw>1: {n_multi}/{nw.numel()}")
            ones = torch.ones_like(want, dtype=torch.bool)
            errs["K2"] = max(errs["K2"], check_equal(tag, want, ones, got, ones))
            k2 = cuda_ms(lambda: fused_refine.refine_planned(*args_l))
            k2p = cuda_ms(lambda: fused_refine.refine_planned_plain(*args_l))
            pl = cuda_ms(lambda: fused_refine.plan_level(prior, 64, max_base, radius, nwin))
            print(f"    level {lvl}: kernel {k2:.4f} ms, plain {k2p:.4f} ms, plan {pl:.4f} ms")
            k2_ms, k2_plain_ms, plan_ms = k2_ms + k2, k2_plain_ms + k2p, plan_ms + pl
            disp = want
        print(f"  {scene} K2 per frame (3 levels): kernel {k2_ms:.4f} ms, "
              f"plain {k2_plain_ms:.4f} ms, plan {plan_ms:.4f} ms; tiles nw>1: {multi}")
        if scene == "box" and multi == 0:
            raise AssertionError("box scene planned no multi-window tile")
        if scene == "make_pair":
            times["K2"] = (k2_ms, k2_plain_ms)

        got = fused_post.median3_fused(disp)
        want = fused_post.median3_plain(disp)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{scene} K3: not bit-equal")
        print(f"  {scene} K3 {tuple(disp.shape)}: bit-equal")
        if scene == "make_pair":
            times["K3"] = (
                cuda_ms(lambda: fused_post.median3_fused(disp)),
                cuda_ms(lambda: fused_post.median3_plain(disp)),
            )
    noise = torch.rand((H, W), generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev) * 128
    if not torch.equal(fused_post.median3_fused(noise), fused_post.median3_plain(noise)):
        raise AssertionError("K3 on a random map: not bit-equal")
    print(f"  K3 random {H}x{W} map: bit-equal")

    # 3b. branches the main path does not take, at a small unaligned size:
    # SSD, uniqueness, windows 5 and 7, a row window (the rows outside
    # [0, g_h) of a halo-extended shard), R=4, tile_rows rounded up to 8
    print("== off-path branches vs plain versions (70x300)")
    h, w = 70, 300
    lg, rg = (torch.as_tensor(a, device=dev).contiguous()
              for a in make_pair(h, w, shift=12, seed=SEED))
    for cost, win, uniq, g_row0, g_h in (("ssd", 5, 0.1, -4, h - 8), ("sad", 7, 0.1, 0, None)):
        c = MatchConfig(num_disparities=24, window=win, cost=cost, uniqueness=uniq,
                        lr_threshold=None)
        got = fused_dense.raw_match(lg, rg, c, 16, g_row0, g_h)
        want = fused_dense.raw_match_plain(lg, rg, c, 16, g_row0, g_h)
        torch.cuda.synchronize()
        tag = f"K1 {cost} window {win} uniqueness {uniq} g_row0 {g_row0} g_h {g_h}"
        errs["K1"] = max(errs["K1"], check_k1(tag, want, got))
    prior = torch.full((h, w), 10.0, device=dev)
    prior[:, 200:] = 30.0  # a step inside the second 128-column tile: nw > 1
    for cost, win, radius, g_row0, g_h in (("ssd", 5, 2, -4, h - 8), ("sad", 7, 4, 0, None)):
        c = MatchConfig(num_disparities=64, window=win, cost=cost)
        bases, nw, tr = fused_refine.plan_level(prior, 20, 64, radius, 16)
        args_l = (lg, rg, bases, nw, c, radius, tr, g_row0, g_h)
        got = fused_refine.refine_planned(*args_l)
        want = fused_refine.refine_planned_plain(*args_l)
        torch.cuda.synchronize()
        n_multi = int((nw > 1).sum())
        if n_multi == 0:
            raise AssertionError("step prior planned no multi-window tile")
        tag = (f"K2 {cost} window {win} R={radius} tile_rows {tr} g_row0 {g_row0} "
               f"g_h {g_h} tiles nw>1: {n_multi}/{nw.numel()}")
        ones = torch.ones_like(want, dtype=torch.bool)
        errs["K2"] = max(errs["K2"], check_equal(tag, want, ones, got, ones))

    # 4. the slice end to end, through the user's entry point
    print(f"== end to end: StereoModel(backend='hierarchical-pallas') at {H}x{W}")
    model = StereoModel(backend="hierarchical-pallas", match=cfg, pyramid=pyr)
    left, right = (torch.as_tensor(a, device=dev) for a in pairs["make_pair"])
    launch_kernels = {"K1": fused_dense.K1, "K2": fused_refine.K2, "K3": fused_post.K3}
    for k in launch_kernels.values():
        k.launches = 0
    res = model(left, right)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in launch_kernels.items()}
    print(f"  launches per frame: {launches}")
    if launches != {"K1": 1, "K2": 3, "K3": 1}:
        raise AssertionError(f"launch counts {launches} != K1=1, K2=3, K3=1")
    d = res.disparity
    if d.shape != (H, W) or d.dtype != torch.float32 or not bool(torch.isfinite(d).all()):
        raise AssertionError(f"bad disparity: {d.shape} {d.dtype}")
    med = float(d[50:-50, 100:-100].median())
    print(f"  median disparity {med:.4f} (want 24 +- 0.5)")
    if abs(med - 24.0) > 0.5:
        raise AssertionError(f"median disparity {med} != 24")
    plain = fused_refine.match_hierarchical_plain(left, right, cfg, pyr)
    check_equal("make_pair kernel path vs plain path", plain.disparity, plain.valid,
                res.disparity, res.valid)
    bl, br = (torch.as_tensor(a, device=dev) for a in pairs["box"])
    res_box = model(bl, br)
    plain_box = fused_refine.match_hierarchical_plain(bl, br, cfg, pyr)
    check_equal("box kernel path vs plain path", plain_box.disparity, plain_box.valid,
                res_box.disparity, res_box.valid)
    ok_box = ~torch.as_tensor(box.occluded, device=dev)
    epe = float((res_box.disparity - torch.as_tensor(box.disparity, device=dev))[ok_box].abs().mean())
    print(f"  box scene EPE vs ground truth (non-occluded): {epe:.4f} px")

    # 5. per-frame times
    print(f"== times (CUDA events, median of {REPS} after warm-up), "
          f"card: {smi[0]}")
    frame_ms = cuda_ms(lambda: model(left, right))
    plain_ms = cuda_ms(lambda: fused_refine.match_hierarchical_plain(left, right, cfg, pyr))
    box_ms = cuda_ms(lambda: model(bl, br))
    t0 = time.perf_counter()
    for _ in range(REPS):
        model(left, right)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / REPS
    print(f"  {H}x{W} slice, make_pair: kernel path {frame_ms:.4f} ms/frame, "
          f"plain path {plain_ms:.4f} ms/frame; box scene kernel path {box_ms:.4f} ms/frame; "
          f"host wall clock, back to back: {wall_ms:.4f} ms/frame")
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")

    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[n], "max_abs_err": errs[n],
         "ms": times[n][0], "plain_ms": times[n][1]}
        for n, k in launch_kernels.items()
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
