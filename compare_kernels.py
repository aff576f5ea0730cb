#!/usr/bin/env python3
"""Time the port's matchers (K1, K2), volume (K6), scans (K7, K8, K10), remap (K11),
fill (K5) and median (K3) kernels against an earlier version of them, in
turns, on one NVIDIA GPU.

    python3 compare_kernels.py --old-csrc DIR [--out FILE]

``DIR`` holds an earlier ``stepth_tpu_torch/csrc`` (for example unpacked by
``git archive <commit> stepth_tpu_torch/csrc`` into an ignored directory):
its sources are built with the same ``nvcc`` flags into a library of their
own beside the current one, and each of its C functions is called with
as many arguments as its prototype there declares (an older version may
lack trailing arguments). Both versions run on the same inputs:

- K1 (SAD, window 9) at the ``flagship()`` shape, 1080×1920 with D=128, on
  ``chip_smoke.make_pair``; at the 135×240 coarse level with D=16, SAD and
  census (window 7, two planes given); on the first of the 4 row shards of
  the sharded ``flagship()`` (286 rows, ``g_row0`` = −8); both versions
  through the C interface of the packed u64 right view (an older ``DIR``
  needs the script of its own time), whose buffer a call fills first
  (timed with the fill);
- K6 at 1080×1920, D=64, window 5, f32 and bf16 (path 3's volume), at
  the 135×240 coarse level with D=16, window 9, census (two planes given),
  and on the first of 3 row shards of 360 rows with an 8-row halo
  (``g_row0`` = −8);
- K2 on census planes given, with the plans and priors of the
  hierarchical pipeline (``tile_rows`` 64, R=2, up to 16 windows): each
  of the three levels of the ``box`` scene (``lr`` at level 0, timed with
  its buffer fill), the three levels of ``make_pair`` together, and the
  three ``box`` levels with SAD;
- K8 at 1080×1920, D=64, f32 and bf16, and at 135×240, D=16, on the
  volume and 3-direction sum that path 3 (``sgm-pallas``, 4 directions,
  window 5) and its coarse level give it, each with its buffer fill;
- K7 in each of the 8 directions at 1080×1920, D=64, f32, onto an
  accumulator, then at D=256 in place, at 1080×1920 and 1920×1080 (each
  version as its wrapper would launch it: the ring where the new
  ``takes_ring`` says so), at 1080×1920, D=128, onto an accumulator, and
  three K7 launches of the 135×240 D=16 coarse level; and the new version
  alone at 1988×2880, D=290 (the deep tiling, which an older version
  refuses), in place, against its byte bound;
- K10 on one 360×1920 shard, D=64, seeded from a carry;
- K11 on a 1080×1920×3 view through the 1080p rig map of ``chip_smoke.py``,
  and ``grid_sample`` on the same view as a yardstick;
- K5 and K3 on the inputs the pipelines give them: production's level 0
  at 1080×1920 (census, LR mask), the 135×240 coarse SGM level of
  ``hierarchical-sgm`` production (path 2's second K5), rows 270–539 of
  the production map (a 270-row shard, an aligned view into it) and a
  random map with ~30% invalid pixels; then old and new K3 on a 1080×1920
  map with 1% each of NaN, +inf and −inf, each against the plain version
  (NaN compared by position: an old K3 whose exchanges drop NaN has its
  mismatch recorded, not raised; the new kernel must match);
- the device-bound frames, ``flagship()`` and path 3 (``sgm-pallas``, 4
  directions, D=64, window 5, LR) at 1080×1920, with every kernel launched
  from the old library or from the new one (their disparities held
  equal): CUDA events around one frame, 10 in turns, 5 times; the median
  of the 5 medians and their range.

Each measurement is CUDA events around ``LAUNCHES`` back-to-back launches
divided by their number (device time: a direct launch costs the host far
less than the kernel takes), repeated ``ROUNDS`` times in the order old,
new, new, old, ...; the medians are printed. The two versions' outputs must
be equal bit for bit (on NaN-free inputs). The last line is one JSON object with the card's name
and power limit (``nvidia-smi``) and every median.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

LAUNCHES = 50
ROUNDS = 6
SEED = 0


def build_old(csrc: pathlib.Path, out_dir: pathlib.Path) -> ctypes.CDLL:
    """The library of the sources in ``csrc``, built with the current flags."""
    from stepth_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels.find_nvcc()
    srcs = sorted(csrc.glob("*.cu"))
    objs = [out_dir / f"{s.stem}.o" for s in srcs]
    kernels._run_all([[nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                      for s, o in zip(srcs, objs)])
    lib = out_dir / "libold.so"
    kernels._run_all([[nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
                       *map(str, objs)]])
    return ctypes.CDLL(str(lib))


def c_arity(csrc: pathlib.Path, symbol: str) -> int:
    """How many arguments, the stream included, ``symbol``'s prototype in
    the sources under ``csrc`` declares."""
    for src in sorted(csrc.glob("*.cu")):
        m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src.read_text())
        if m:
            return m.group(1).count(",") + 1
    raise ValueError(f"{symbol} is not in {csrc}")


def c_function(lib: ctypes.CDLL, k, arity: int):
    """``k``'s C function in ``lib``, taking ``arity`` arguments, the stream
    last: called as ``Kernel.launch`` calls it, with the arguments past its
    first ``arity - 1`` left out."""
    fn = getattr(lib, k.symbol)
    keep = arity - 1
    fn.argtypes = k.argtypes[:keep] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lambda *a: fn(*a[:keep], a[-1])


def bind(lib: ctypes.CDLL, k, arity: int):
    """:func:`c_function`, launched on the current stream; raises on a
    failed launch."""
    fn = c_function(lib, k, arity)

    def call(*args):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{k.name}: launch failed ({rc})")

    return call


def turns(fns: dict) -> dict:
    """Median device ms per launch of each function (``chip_smoke.
    device_ms``: events around ``LAUNCHES`` launches), timed in turns, the
    order reversed every round."""
    from chip_smoke import device_ms

    times = {n: [] for n in fns}
    names = list(fns)
    for r in range(ROUNDS):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(device_ms(fns[n], LAUNCHES))
    return {n: float(np.median(t)) for n, t in times.items()}


def k2_levels(lg, rg, cfg, lr0):
    """The three refine levels of the hierarchical pipeline (``levels=4``,
    ``coarsest_disparities=16``, ``tile_rows`` 64) on gray images ``lg``,
    ``rg`` of the card, priors from the plain path: for each, ``(level, K2
    launch arguments, outputs, lr, tensors the arguments point into, tiles
    with nw > 1)``; ``lr`` at level 0 when ``lr0``. K2 reads the census
    planes (given) or the gray images."""
    from stepth_tpu_torch.config import MatchConfig, PyramidConfig
    from stepth_tpu_torch.match import dense, fused_dense, fused_refine, pyramid

    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    lefts, rights = [lg], [rg]
    for _ in range(3):
        lefts.append(pyramid.downsample2(lefts[-1]))
        rights.append(pyramid.downsample2(rights[-1]))
    coarse = MatchConfig(num_disparities=16, window=cfg.window, cost=cfg.cost,
                         census_window=cfg.census_window, lr_threshold=None)
    disp = fused_dense.raw_match_plain(lefts[-1], rights[-1], coarse, 16)[0]
    max_base, out = 16, []
    for lvl in (2, 1, 0):
        h, w = lefts[lvl].shape
        prior = pyramid.upsample2_disparity(disp, h, w)
        max_base *= 2
        lr = lr0 and lvl == 0
        bases, nw, tr = fused_refine.plan_level(prior, 64, max_base, pyr.refine_radius,
                                                pyr.refine_windows)
        keep = [lefts[lvl], rights[lvl], bases, nw]
        images = (lefts[lvl].data_ptr(), rights[lvl].data_ptr(), None, None, 0)
        if cfg.cost == "census":
            lcc, rcc = dense.census_pair(lefts[lvl], rights[lvl], cfg.census_window)
            images = (None, None, lcc.data_ptr(), rcc.data_ptr(), lcc.shape[0])
            keep += [lcc, rcc]
        disp_k = torch.empty_like(lefts[lvl])
        packed = torch.empty((h, w), dtype=torch.int64, device=lg.device)
        args = (*images, bases.data_ptr(), nw.data_ptr(), disp_k.data_ptr(),
                packed.data_ptr() if lr else None, h, w, nw.shape[1], bases.shape[-1], tr,
                pyr.refine_radius, cfg.window,
                fused_refine._region_margin(cfg, pyr.refine_radius),
                int(cfg.cost == "ssd"), 0, h, int(lr))
        out.append((lvl, args, [disp_k, packed] if lr else [disp_k], lr, keep,
                    int((nw > 1).sum())))
        disp = fused_refine.refine_planned_plain(lefts[lvl], rights[lvl], bases, nw, cfg,
                                                 pyr.refine_radius, tr, lr=lr)
        disp = disp[0] if lr else disp
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from stepth_tpu_torch import kernels
    from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
    from stepth_tpu_torch.match import dense, fused_dense, fused_refine, fused_sgm, pyramid
    from stepth_tpu_torch.match.sgm import penalties
    from stepth_tpu_torch.ops import fused_remap, rectify
    from stepth_tpu_torch.utils import scenes

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    kernels.load()
    old = build_old(args.old_csrc, kernels.BUILD_ROOT / "old")

    def bound(lib, k):
        """``k`` in ``lib`` (``old`` or the current one), with the arguments its
        prototype there declares."""
        return bind(lib, k, c_arity(args.old_csrc, k.symbol) if lib is old
                    else len(k.argtypes) + 1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    result = {"card": card, "launches_per_timing": LAUNCHES, "rounds": ROUNDS}

    def versions(k, *args):
        new_fn, old_fn = bound(kernels.load(), k), bound(old, k)
        return {"old": lambda: old_fn(*args), "new": lambda: new_fn(*args)}

    def same(k, outs, *args):
        """Run both versions once on cleared outputs; raise unless equal."""
        got = []
        for fn in versions(k, *args).values():
            for o in outs:
                o.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            got.append([o.clone() for o in outs])
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            raise AssertionError(f"{k.name}: old and new outputs differ")

    def same_runs(name, fns, outs):
        """Run each version once; raise unless the outputs ``outs()`` gives
        after each are equal."""
        got = []
        for fn in fns.values():
            fn()
            torch.cuda.synchronize()
            got.append([o.clone() for o in outs()])
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            raise AssertionError(f"{name}: old and new outputs differ")

    def k1_versions(name, lg, rg, D, planes=None, g_row0=0, g_h=None):
        """K1 without uniqueness (its flagship()/coarse use), old against new
        through the same C interface (each fills its packed right-view
        buffer first), all four outputs held equal, then timed."""
        h, w = lg.shape
        images = ((lg.data_ptr(), rg.data_ptr(), None, None, 0) if planes is None else
                  (None, None, planes[0].data_ptr(), planes[1].data_ptr(), planes[0].shape[0]))
        tail = (h, w, D, 9, 0, 0, 1.0, g_row0, h if g_h is None else g_h)
        fns, outs = {}, {}
        for v, lib in (("old", old), ("new", kernels.load())):
            fn = bound(lib, fused_dense.K1)
            o = [torch.full_like(lg, float("nan")) for _ in range(3)]
            right = torch.empty((h, w), dtype=torch.int64, device=dev)

            def run(fn=fn, o=o, right=right):
                right.fill_(fused_dense._RIGHT_START)
                fn(*images, o[0].data_ptr(), right.data_ptr(), o[1].data_ptr(),
                   o[2].data_ptr(), *tail)

            fns[v], outs[v] = run, o + [right]
        fns["old"](), fns["new"]()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"])):
            raise AssertionError(f"K1 {name}: old and new outputs differ")
        result[f"K1 {name}, ms"] = turns(fns)
        print(f"K1 {name}: {result[f'K1 {name}, ms']}")

    H, W = 1080, 1920
    left, right_img = chip_smoke.make_pair(H, W, seed=SEED)
    lg, rg = (dense.grayscale(a, dev) for a in (left, right_img))
    k1_versions("sad 1080x1920 D=128 window 9 (flagship)", lg, rg, 128)
    halo = 8  # flagship()'s sharded halo: window radius + 1, rounded up to 8
    shard = [torch.cat([t[:1].expand(halo, W), t[:270 + halo]]).contiguous() for t in (lg, rg)]
    k1_versions("sad 286x1920 D=128 window 9, shard 0 of 4 (g_row0 -8)", *shard, 128,
                g_row0=-halo, g_h=H)
    lc_, rc_ = lg, rg
    for _ in range(3):
        lc_, rc_ = pyramid.downsample2(lc_), pyramid.downsample2(rc_)
    k1_versions("sad 135x240 D=16 window 9 (coarse)", lc_, rc_, 16)
    k1_versions("census 135x240 D=16 window 9, 2 planes given (coarse)", lc_, rc_, 16,
                dense.census_pair(lc_, rc_, 7))

    # K6: path 3's volume (f32, bf16), the hierarchical-sgm coarse level
    # (census, planes given) and a halo-extended row shard, in turns
    def k6_versions(name, lg_, rg_, cfg, dtype, g_row0=0, g_h=None):
        h, w = lg_.shape
        vol = torch.empty((cfg.num_disparities, h, w), dtype=dtype, device=dev)
        images = (lg_.data_ptr(), rg_.data_ptr(), None, None, 0)
        if cfg.cost == "census":
            lcc, rcc = dense.census_pair(lg_, rg_, cfg.census_window)
            images = (None, None, lcc.data_ptr(), rcc.data_ptr(), lcc.shape[0])
        a6 = (*images, vol.data_ptr(), int(dtype == torch.bfloat16), h, w,
              cfg.num_disparities, cfg.window, int(cfg.cost == "ssd"), g_row0,
              h if g_h is None else g_h)
        same(fused_sgm.K6, [vol], *a6)
        result[f"K6 {name}, ms"] = turns(versions(fused_sgm.K6, *a6))
        print(f"K6 {name}: {result[f'K6 {name}, ms']}")

    cfg6 = MatchConfig(num_disparities=64, window=5)
    k6_versions("1080x1920 D=64 window 5 f32", lg, rg, cfg6, torch.float32)
    k6_versions("1080x1920 D=64 window 5 bf16", lg, rg, cfg6, torch.bfloat16)
    k6_versions("census 135x240 D=16 window 9, 2 planes given (coarse)", lc_, rc_,
                MatchConfig(num_disparities=16, window=9, cost="census"), torch.float32)
    shard6 = [torch.cat([t[:1].expand(halo, W), t[:360 + halo]]).contiguous() for t in (lg, rg)]
    k6_versions("376x1920 D=64 window 5 f32, shard 0 of 3 (g_row0 -8)", *shard6, cfg6,
                torch.float32, -halo, H)

    # K2 on census planes given (or the gray images for SAD) with the plans
    # of the hierarchical pipeline: priors from the plain path
    def k2_fns(levels):
        fns = {}
        for v, lib in (("old", old), ("new", kernels.load())):
            fn = bound(lib, fused_refine.K2)

            def run(fn=fn):
                for _, args, outs, lr, _, _ in levels:
                    if lr:
                        outs[1].fill_(-1)
                    fn(*args)

            fns[v] = run
        return fns

    census7 = MatchConfig(num_disparities=128, window=9, cost="census")
    box = scenes.make_scene("box", H, W, 128, seed=1)
    bl, br = (dense.grayscale(a, dev) for a in (box.left, box.right))
    for scene, (l_, r_), cfg, lr0, split in (
            ("box census", (bl, br), census7, True, True),
            ("make_pair census", (lg, rg), census7, True, False),
            ("box sad", (bl, br), MatchConfig(num_disparities=128, window=9), False, False)):
        levels = k2_levels(l_, r_, cfg, lr0)
        groups = [[lv] for lv in levels] if split else [levels]
        for group in groups:
            tag = (f"{scene}, level {group[0][0]} (tiles nw>1: {group[0][5]}"
                   f"{', lr' if group[0][3] else ''})" if split else f"{scene}, 3 levels")
            fns = k2_fns(group)
            same_runs(f"K2 {tag}", fns, lambda g=group: [o for lv in g for o in lv[2]])
            result[f"K2 {tag}, ms"] = turns(fns)
            print(f"K2 {tag}: {result[f'K2 {tag}, ms']}")

    # K8 on what path 3 gives it: the window-5 volume and its 3-direction sum
    def k8_versions(name, vol, acc, cfg):
        d, h, w = vol.shape
        p1, p2 = penalties(cfg, SGMConfig(directions=4))
        outs = [torch.empty((h, w), device=dev) for _ in range(3)]
        right = torch.empty((h, w), dtype=torch.int64, device=dev)
        args = (vol.data_ptr(), acc.data_ptr(), int(vol.dtype == torch.bfloat16),
                *(o.data_ptr() for o in outs), right.data_ptr(), d, h, w, p1, p2, 0, 1.0)
        fns = {}
        for v, lib in (("old", old), ("new", kernels.load())):
            fn = bound(lib, fused_sgm.K8)

            def run(fn=fn):
                right.fill_(-1)
                fn(*args)

            fns[v] = run
        same_runs(f"K8 {name}", fns, lambda: outs + [right])
        result[f"K8 {name}, ms"] = turns(fns)
        print(f"K8 {name}: {result[f'K8 {name}, ms']}")

    s4 = SGMConfig(directions=4)
    for tag, lg_, rg_, cfg in (
            ("1080x1920 D=64", lg, rg, MatchConfig(num_disparities=64, window=5)),
            ("135x240 D=16", lc_, rc_, MatchConfig(num_disparities=16, window=9))):
        p1, p2 = penalties(cfg, s4)
        for dtype in ((torch.float32, torch.bfloat16) if tag.startswith("1080") else
                      (torch.float32,)):
            vol_ = fused_sgm.aggregated_volume(lg_, rg_, cfg, dtype)
            acc_ = None
            for axis, rev, sh in fused_sgm.directions(4)[:3]:
                acc_ = fused_sgm.scan_direction(vol_, acc_, p1, p2, axis=axis, reverse=rev,
                                                shift=sh)
            k8_versions(f"{tag} {str(dtype)[6:]}", vol_, acc_, cfg)
            del vol_, acc_

    H, W, D = 1080, 1920, 64
    vol = torch.randint(0, 60, (D, H, W), generator=gen, device=dev).float()
    acc = torch.randint(0, 600, (D, H, W), generator=gen, device=dev).float()
    out = torch.empty_like(vol)
    arrows = {(2, False, 0): "→x", (2, True, 0): "←x", (1, False, 1): "↘",
              (1, False, -1): "↙", (1, True, 1): "↗", (1, True, -1): "↖",
              (1, False, 0): "↓y", (1, True, 0): "↑y"}
    k7 = {}
    for axis, rev, sh in fused_sgm.directions(8):
        dy, dx = fused_sgm._step(axis, rev, sh)
        a = (vol.data_ptr(), acc.data_ptr(), out.data_ptr(), 0, D, H, W, dy, dx, 8.0, 96.0,
             None, 0, None)
        same(fused_sgm.K7, [out], *a)
        k7[arrows[(axis, rev, sh)]] = turns(versions(fused_sgm.K7, *a))
        print(f"K7 {arrows[(axis, rev, sh)]} {H}x{W} D={D}: {k7[arrows[(axis, rev, sh)]]}")
    result["K7 1080x1920 D=64 f32, ms per direction"] = k7
    three = [k7[a] for a in ("→x", "←x", "↓y")]
    result["K7 per launch over →x ←x ↓y"] = {
        v: sum(t[v] for t in three) / 3 for v in ("old", "new")}

    # K7 at D=256, the census SGM cell's scans, and the same image upright:
    # the new version takes the ring where its wrapper would (the old one
    # ignores the schedule); outputs compared beside the accumulator, times
    # taken in place, as the pipeline runs them
    del vol, acc, out
    D2 = 256
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for H2, W2 in ((H, W), (W, H)):
        vol2 = torch.randint(0, 60, (D2, H2, W2), generator=gen, device=dev).float()
        acc2 = torch.randint(0, 600, (D2, H2, W2), generator=gen, device=dev).float()
        out2 = torch.empty_like(vol2)
        k7w = {}
        for axis, rev, sh in fused_sgm.directions(8):
            dy, dx = fused_sgm._step(axis, rev, sh)
            ring = fused_sgm.takes_ring(D2, H2, W2, dy, dx, vol2.dtype, sms, vol2.data_ptr(),
                                        acc2.data_ptr(), out2.data_ptr())
            sched, blocks, bands = (fused_sgm._ring_schedule_on(dev, H2, W2, dy, dx) if ring
                                    else (None, 0, 0))
            prog = torch.empty(bands, dtype=torch.int32, device=dev) if ring else None
            tail = (dy, dx, 8.0, 96.0, None if sched is None else sched.data_ptr(), blocks,
                    None if prog is None else prog.data_ptr())
            same(fused_sgm.K7, [out2], vol2.data_ptr(), acc2.data_ptr(), out2.data_ptr(), 0,
                 D2, H2, W2, *tail)
            a_ = arrows[(axis, rev, sh)]
            k7w[a_] = dict(turns(versions(fused_sgm.K7, vol2.data_ptr(), acc2.data_ptr(),
                                          acc2.data_ptr(), 0, D2, H2, W2, *tail)), ring=ring)
            print(f"K7 {a_} {H2}x{W2} D={D2}: {k7w[a_]}")
        result[f"K7 {H2}x{W2} D={D2} f32 in place, ms per direction"] = k7w
        for name, arrows_ in (("diagonals", ("↘", "↙", "↗", "↖")), ("↓y ↑y", ("↓y", "↑y")),
                              ("→x ←x", ("→x", "←x"))):
            result[f"K7 {H2}x{W2} D={D2} {name}, ms summed"] = {
                v: sum(k7w[a][v] for a in arrows_) for v in ("old", "new")}
        del vol2, acc2, out2
    # K7 at D=128 (ND = 4, the staged kernel in both versions), old against
    # new; then at D=290 on the Middlebury F frame (1988×2880), the deep
    # tiling, which an older version refuses: the new one alone, in place,
    # against the byte bound of vol and acc read and the sum written
    vol2 = torch.randint(0, 60, (128, H, W), generator=gen, device=dev).float()
    acc2 = torch.randint(0, 600, (128, H, W), generator=gen, device=dev).float()
    out2 = torch.empty_like(vol2)
    k7m = {}
    for axis, rev, sh in fused_sgm.directions(8):
        a_ = (vol2.data_ptr(), acc2.data_ptr(), out2.data_ptr(), 0, 128, H, W,
              *fused_sgm._step(axis, rev, sh), 8.0, 96.0, None, 0, None)
        same(fused_sgm.K7, [out2], *a_)
        k7m[arrows[(axis, rev, sh)]] = turns(versions(fused_sgm.K7, *a_))
        print(f"K7 {arrows[(axis, rev, sh)]} {H}x{W} D=128: {k7m[arrows[(axis, rev, sh)]]}")
    result[f"K7 {H}x{W} D=128 f32, ms per direction"] = k7m
    del vol2, acc2, out2
    D3, H3, W3 = chip_smoke.DEEP_D, *chip_smoke.DEEP_SHAPE
    vol3 = torch.randint(0, 60, (D3, H3, W3), generator=gen, device=dev).float()
    acc3 = torch.randint(0, 600, (D3, H3, W3), generator=gen, device=dev).float()
    # vol and acc read, the sum written: 3 × 4 bytes a cell
    bound3 = chip_smoke.bound(12 * D3 * H3 * W3, 8 * D3 * H3 * W3)[0]
    new_k7 = bound(kernels.load(), fused_sgm.K7)
    k7d = {}
    for axis, rev, sh in fused_sgm.directions(8):
        a_ = (vol3.data_ptr(), acc3.data_ptr(), acc3.data_ptr(), 0, D3, H3, W3,
              *fused_sgm._step(axis, rev, sh), 8.0, 96.0, None, 0, None)
        ms = turns({"new": lambda a_=a_: new_k7(*a_)})["new"]
        k7d[arrows[(axis, rev, sh)]] = {"new": ms, "bound": bound3, "share": bound3 / ms}
        print(f"K7 {arrows[(axis, rev, sh)]} {H3}x{W3} D={D3}: {ms:.4f} ms, bound "
              f"{bound3:.4f} ms ({bound3 / ms:.1%})")
    result[f"K7 {H3}x{W3} D={D3} f32 in place (deep tiling), ms per direction"] = k7d
    del vol3, acc3
    torch.cuda.empty_cache()
    vol = torch.randint(0, 60, (D, H, W), generator=gen, device=dev).float()
    acc = torch.randint(0, 600, (D, H, W), generator=gen, device=dev).float()

    hc, wc, dc = 135, 240, 16
    vc = torch.randint(0, 60, (dc, hc, wc), generator=gen, device=dev).float()
    ac = torch.randint(0, 600, (dc, hc, wc), generator=gen, device=dev).float()
    oc = torch.empty_like(vc)
    coarse = {}
    for v in ("old", "new"):
        fns = [versions(fused_sgm.K7, vc.data_ptr(), ac.data_ptr(), oc.data_ptr(), 0, dc, hc,
                        wc, *fused_sgm._step(axis, rev, sh), 8.0, 96.0, None, 0, None)[v]
               for axis, rev, sh in fused_sgm.directions(4)[:3]]
        coarse[v] = lambda fns=fns: [f() for f in fns]
    result["K7 x3 coarse 135x240 D=16 f32, ms"] = turns(coarse)
    print(f"K7 x3 coarse: {result['K7 x3 coarse 135x240 D=16 f32, ms']}")

    th = H // 3
    vs, as_ = vol[:, th:2 * th].contiguous(), acc[:, th:2 * th].contiguous()
    os_ = torch.empty_like(vs)
    c_in = vol[:, 100].contiguous()
    c_out = torch.empty((D, W), device=dev)
    a = (vs.data_ptr(), as_.data_ptr(), os_.data_ptr(), c_in.data_ptr(), c_out.data_ptr(), 0,
         D, th, W, 1, 0, 8.0, 96.0)
    same(fused_sgm.K10, [os_, c_out], *a)
    result["K10 360x1920 D=64 f32 ↓y, ms"] = turns(versions(fused_sgm.K10, *a))
    print(f"K10: {result['K10 360x1920 D=64 f32 ↓y, ms']}")

    maps = rectify.rectify_maps(chip_smoke.RIG_K, chip_smoke.RIG_K, chip_smoke.RIG_R,
                                chip_smoke.RIG_T, (H, W), dist1=chip_smoke.RIG_DIST1,
                                dist2=chip_smoke.RIG_DIST2, device=dev)
    m = maps.map_left
    color = torch.rand((H, W, 3), generator=gen, device=dev) * 255
    res = torch.empty_like(color)
    a = (color.data_ptr(), m.data_ptr(), res.data_ptr(), H, W, H, W, 3, 0.0)
    same(fused_remap.K11, [res], *a)
    grid = torch.stack([m[..., 0] * (2.0 / (W - 1)) - 1.0, m[..., 1] * (2.0 / (H - 1)) - 1.0],
                       -1)[None].contiguous()
    nchw = color.permute(2, 0, 1)[None].contiguous()
    fns = versions(fused_remap.K11, *a)
    fns["grid_sample"] = lambda: torch.nn.functional.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)
    result["K11 1080x1920x3 rig map, ms"] = turns(fns)
    print(f"K11: {result['K11 1080x1920x3 rig map, ms']}")
    # K5 and K3 on the maps the pipelines give them: production's level 0
    # (1080x1920, its LR mask), path 2's coarse SGM level (135x240, K5's
    # second launch there), a 270-row shard of the production map (an
    # aligned view into it) and a random map with ~30% invalid pixels
    post_in = {}

    def capture(tag, fn):
        def run(*a):
            post_in.setdefault(tag, a)
            return fn(*a)
        return run

    from stepth_tpu_torch.match import fused_post
    census = MatchConfig(num_disparities=128, window=9, cost="census")
    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    # each run's first fill and median: production's level 0 (the WTA coarse
    # level has none), and path 2's coarse SGM level
    for tag, coarse in (("production", "wta"), ("coarse", "sgm")):
        fused_refine._match_hierarchical(
            fused_refine.FUSED._replace(fill=capture(f"K5 {tag}", fused_post.fill_invalid_fused),
                                        median=capture(f"K3 {tag}", fused_post.median3_fused)),
            lg, rg, census, pyr, 64, True, coarse, None, SGMConfig(directions=4))
    disp, valid = post_in["K5 production"]
    rand = torch.rand((H, W), generator=gen, device=dev) * 100
    rand_valid = torch.rand((H, W), generator=gen, device=dev) >= 0.3
    k5_maps = {
        "production 1080x1920": (disp, valid),
        "path 2 coarse SGM level 135x240": post_in["K5 coarse"],
        "production rows 270-539 (a 270-row shard, view)": (disp[270:540], valid[270:540]),
        f"random 1080x1920, {float((~rand_valid).float().mean()):.3f} invalid": (rand, rand_valid),
    }
    k3_maps = {
        "production 1080x1920": post_in["K3 production"][0],
        "path 2 coarse SGM level 135x240": post_in["K3 coarse"][0],
        "production rows 270-539 (a 270-row shard, view)": post_in["K3 production"][0][270:540],
        "random 1080x1920": rand,
    }
    for tag, (d_, v_) in k5_maps.items():
        out = torch.empty_like(d_)
        a = (d_.data_ptr(), v_.data_ptr(), out.data_ptr(), *d_.shape)
        same(fused_post.K5, [out], *a)
        result[f"K5 {tag}, ms"] = turns(versions(fused_post.K5, *a))
        print(f"K5 {tag}: {result[f'K5 {tag}, ms']}")
    for tag, x_ in k3_maps.items():
        out = torch.empty_like(x_)
        a = (x_.data_ptr(), out.data_ptr(), *x_.shape)
        same(fused_post.K3, [out], *a)
        result[f"K3 {tag}, ms"] = turns(versions(fused_post.K3, *a))
        print(f"K3 {tag}: {result[f'K3 {tag}, ms']}")
    # the NaN rule: the median of a map with NaN and +-inf, old and new
    # against the plain version (NaN compared by position)
    x_ = rand.clone()
    x_[torch.rand((H, W), generator=gen, device=dev) < 0.01] = float("nan")
    x_[torch.rand((H, W), generator=gen, device=dev) < 0.01] = float("inf")
    x_[torch.rand((H, W), generator=gen, device=dev) < 0.01] = -float("inf")
    want = fused_post.median3_plain(x_)
    nan_rule = {"plain NaN pixels": int(torch.isnan(want).sum())}
    for v, lib in (("old", old), ("new", kernels.load())):
        out = torch.full_like(x_, 7.0)
        bound(lib, fused_post.K3)(x_.data_ptr(), out.data_ptr(), H, W)
        torch.cuda.synchronize()
        nan_rule[f"{v} NaN pixels"] = int(torch.isnan(out).sum())
        nan_rule[f"{v} equal to plain (NaN as NaN)"] = chip_smoke.bits_equal(want, out)
    result["K3 1080x1920 with 1% NaN, +inf, -inf each"] = nan_rule
    print(f"K3 NaN rule: {nan_rule}")
    if not nan_rule["new equal to plain (NaN as NaN)"]:
        raise AssertionError("K3: the new kernel does not follow the plain version's NaN rule")

    # the device-bound frames, every kernel launched from the old library or
    # from the new one, in turns
    from stepth_tpu_torch.models.stereo import StereoModel, flagship
    from stepth_tpu_torch.ops import fused_remap as remap_mod
    every = (fused_dense.K1, fused_refine.K2, fused_refine.K2_EMIT, fused_post.K3,
             fused_post.K4, fused_post.K5, fused_sgm.K6, fused_sgm.K7, fused_sgm.K8,
             fused_sgm.K9, fused_sgm.K10, remap_mod.K11)

    def launch_from(lib):
        for k in every:
            k._fn = None
            if lib is not None:
                k._fn = c_function(lib, k, c_arity(args.old_csrc, k.symbol))

    left_t, right_t = (torch.as_tensor(a, device=dev) for a in (left, right_img))
    path3 = StereoModel(backend="sgm-pallas", match=MatchConfig(
        num_disparities=64, window=5, cost="sad", lr_threshold=1.0), sgm=SGMConfig(directions=4))
    for name, model in (("flagship()", flagship()), ("path 3, sgm-pallas 4 directions", path3)):
        frames = {}
        for v, lib in (("old", old), ("new", None)):
            launch_from(lib)
            frames[v] = model(left_t, right_t).disparity
        torch.cuda.synchronize()
        if not torch.equal(frames["old"], frames["new"]):
            raise AssertionError(f"{name}: old and new frames differ")

        def frame(lib, model=model):
            launch_from(lib)
            return model(left_t, right_t)

        ms = {"old": [], "new": []}
        for _ in range(5):
            t_new, t_old = chip_smoke.cuda_ms_turns(lambda: frame(None), lambda: frame(old))
            ms["new"].append(t_new)
            ms["old"].append(t_old)
        result[f"{name} {H}x{W} ms/frame, median of 5 medians in turns"] = {
            v: float(np.median(t)) for v, t in ms.items()}
        result[f"{name} ms/frame range"] = {v: [min(t), max(t)] for v, t in ms.items()}
        print(f"{name}: {result[f'{name} {H}x{W} ms/frame, median of 5 medians in turns']}, "
              f"range {result[f'{name} ms/frame range']}")
    launch_from(None)
    line = json.dumps(result, ensure_ascii=False)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
