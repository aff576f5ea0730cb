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
      levels (priors from the plain pipeline), K3 at 1080×1920;
   b. census (window 7, two planes): K1 at the coarse level, K2 at the
      three levels, level 0 with the right view (``lr=True``, both
      outputs), the right-view emit on a synthetic buffer;
   c. K1 with SAD, D=128 and its LR check (K4) at 1080×1920 (``flagship``);
   d. K4 and K5 at 1080×1920 on the production maps and on a random map;
   e. at a small unaligned size, the branches the main paths do not take
      (SSD, uniqueness, windows 5 and 7, census windows 5 and 9, a row
      window ``g_row0``/``g_h``, R=4, the right view with R=4).
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
5. times (CUDA events, median of ``REPS`` runs after a warm-up) of kernel
   and plain paths, per kernel and per frame.

Any failed check raises and the script exits non-zero. The line before the
last is a JSON summary of the kernels (launches from the production run);
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits 2 and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0  # seed of the smooth pair, the clip and the random maps
REPS = 10  # timed runs per measurement (median)
MAX_ERR = 0.0  # kernel vs plain version: bit-equal


def make_pair(h, w, shift=24, seed=0):
    """The benchmark's smooth textured pair (right = left shifted by
    ``shift`` px): box-blurred uniform noise."""
    left, rights = make_clip(h, w, [shift], seed)
    return left, rights[0]


def make_clip(h, w, shifts, seed=0):
    """One left view and a right view per shift of the same texture."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, size=(h, w + max(shifts))).astype(np.float32)
    k = np.ones(9, np.float32) / 9
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1, tex)
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0, tex)
    return tex[:, :w], [tex[:, s : s + w] for s in shifts]


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
    from stepth_tpu_torch.models.stereo import StereoModel, flagship
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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    KERNELS = {"K1": fused_dense.K1, "K2": fused_refine.K2, "K2 emit": fused_refine.K2_EMIT,
               "K3": fused_post.K3, "K4": fused_post.K4, "K5": fused_post.K5}
    errs = {n: 0.0 for n in KERNELS}
    times = {}

    def err(name, e):
        errs[name] = max(errs[name], e)

    def drive(fn):
        """Run ``fn`` with every launch count set to 0; return its output
        and the counts."""
        for k in KERNELS.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {n: k.launches for n, k in KERNELS.items()}

    sad = MatchConfig(num_disparities=128, window=9, cost="sad")
    census = MatchConfig(num_disparities=128, window=9, cost="census")
    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    H, W = 1080, 1920
    t0 = time.perf_counter()
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
        if cfg.cost == "census":  # the planes both wrappers compute in torch
            ms = [cuda_ms(lambda: dense.census_pair(lg, rg, cfg.census_window))
                  for lg, rg in zip(lefts, rights)]
            print(f"  {scene} census planes of a pair, levels 0-{len(ms) - 1}: "
                  + ", ".join(f"{m:.4f}" for m in ms) + " ms")
        disp, disp_r = want[0], None
        max_base = pyr.coarsest_disparities
        multi = 0
        k2_ms = k2_plain_ms = plan_ms = 0.0
        for lvl in range(pyr.levels - 2, -1, -1):
            h, w = lefts[lvl].shape
            prior = pyramid.upsample2_disparity(disp, h, w)
            max_base *= 2
            radius = pyr.final_radius if lvl == 0 else pyr.refine_radius
            nwin = pyr.final_windows if lvl == 0 else pyr.refine_windows
            lr = lr0 and lvl == 0
            bases, nw, tr = fused_refine.plan_level(prior, 64, max_base, radius, nwin)
            args_l = (lefts[lvl], rights[lvl], bases, nw, cfg, radius, tr)
            got = fused_refine.refine_planned(*args_l, lr=lr)
            want = fused_refine.refine_planned_plain(*args_l, lr=lr)
            torch.cuda.synchronize()
            n_multi = int((nw > 1).sum())
            multi += n_multi
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
            k2p = cuda_ms(lambda: fused_refine.refine_planned_plain(*args_l, lr=lr))
            pl = cuda_ms(lambda: fused_refine.plan_level(prior, 64, max_base, radius, nwin))
            print(f"    level {lvl}: kernel {k2:.4f} ms, plain {k2p:.4f} ms, plan {pl:.4f} ms")
            k2_ms, k2_plain_ms, plan_ms = k2_ms + k2, k2_plain_ms + k2p, plan_ms + pl
            disp, disp_r = want if lr else (want, None)
        print(f"  {scene} {cfg.cost} K2 per frame (3 levels): kernel {k2_ms:.4f} ms, "
              f"plain {k2_plain_ms:.4f} ms, plan {plan_ms:.4f} ms; tiles nw>1: {multi}")
        if scene == "box" and multi == 0:
            raise AssertionError("box scene planned no multi-window tile")
        return disp, disp_r, k1, (k2_ms, k2_plain_ms)

    # 3a/3b. each kernel against its plain version, at the main paths' shapes
    print("== kernels vs plain versions on the card")
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
            times["K3"] = (cuda_ms(lambda: fused_post.median3_fused(disp)),
                           cuda_ms(lambda: fused_post.median3_plain(disp)))
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

    # 4a. the SAD slice end to end, through the user's entry point
    print(f"== end to end: StereoModel(backend='hierarchical-pallas'), sad, {H}x{W}")
    model = StereoModel(backend="hierarchical-pallas", match=sad, pyramid=pyr)
    left, right = (torch.as_tensor(a, device=dev) for a in pairs["make_pair"])
    bl, br = (torch.as_tensor(a, device=dev) for a in pairs["box"])
    res, launches = drive(lambda: model(left, right))
    print(f"  launches per frame: {launches}")
    want_launches = {"K1": 1, "K2": 3, "K2 emit": 0, "K3": 1, "K4": 0, "K5": 0}
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
        if abs(med - want) > 0.5:
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
    want_launches = {"K1": 1, "K2": 3, "K2 emit": 1, "K3": 1, "K4": 1, "K5": 1}
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
    want_launches = {"K1": 1, "K2": 0, "K2 emit": 0, "K3": 1, "K4": 1, "K5": 1}
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
    want_launches = {"K1": 2, "K2": 2 * 3 + 3, "K2 emit": 5, "K3": 5, "K4": 5, "K5": 5}
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
    want_launches = {"K1": 0, "K2": 1, "K2 emit": 1, "K3": 1, "K4": 1, "K5": 1}
    if seeded_launches != want_launches:
        raise AssertionError(f"launch counts {seeded_launches} != {want_launches}")

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
    for name, (k_fn, p_fn) in frame.items():
        k_ms, p_ms = cuda_ms(k_fn), cuda_ms(p_fn)
        print(f"  {H}x{W} {name}: kernel path {k_ms:.4f} ms/frame, plain path {p_ms:.4f} ms/frame")
    t0 = time.perf_counter()
    for _ in range(REPS):
        prod(left, right)
    torch.cuda.synchronize()
    print(f"  production, host wall clock back to back: "
          f"{(time.perf_counter() - t0) * 1e3 / REPS:.4f} ms/frame")
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")

    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": prod_launches[n], "max_abs_err": errs[n],
         "ms": times[n][0], "plain_ms": times[n][1]}
        for n, k in KERNELS.items()
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
