#!/usr/bin/env python3
"""Time the port's scan (K7, K10) and remap (K11) kernels against an earlier
version of them, in turns, on one NVIDIA GPU.

    python3 compare_kernels.py --old-csrc DIR [--out FILE]

``DIR`` holds an earlier ``stepth_tpu_torch/csrc`` (for example unpacked by
``git archive <commit> stepth_tpu_torch/csrc`` into an ignored directory):
its sources are built with the same ``nvcc`` flags into a library of their
own beside the current one. Both versions run on the same inputs:

- K7 in each of the 8 directions at 1080×1920, D=64, f32, onto an
  accumulator, and three K7 launches of the 135×240 D=16 coarse level;
- K10 on one 360×1920 shard, D=64, seeded from a carry;
- K11 on a 1080×1920×3 view through the 1080p rig map of ``chip_smoke.py``,
  and ``grid_sample`` on the same view as a yardstick.

Each measurement is CUDA events around ``LAUNCHES`` back-to-back launches
divided by their number (device time: a direct launch costs the host far
less than the kernel takes), repeated ``ROUNDS`` times in the order old,
new, new, old, ...; the medians are printed. The two versions' outputs must
be equal bit for bit. The last line is one JSON object with the card's name
and power limit (``nvidia-smi``) and every median.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
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


def bind(lib: ctypes.CDLL, k):
    """``k``'s C function in ``lib``, as ``Kernel.launch`` binds it."""
    fn = getattr(lib, k.symbol)
    fn.argtypes = k.argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

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
    from stepth_tpu_torch.match import fused_sgm
    from stepth_tpu_torch.ops import fused_remap, rectify

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    kernels.load()
    old = build_old(args.old_csrc, kernels.BUILD_ROOT / "old")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    result = {"card": card, "launches_per_timing": LAUNCHES, "rounds": ROUNDS}

    def versions(k, *args):
        new_fn = bind(kernels.load(), k)
        old_fn = bind(old, k)
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
        a = (vol.data_ptr(), acc.data_ptr(), out.data_ptr(), 0, D, H, W, dy, dx, 8.0, 96.0)
        same(fused_sgm.K7, [out], *a)
        k7[arrows[(axis, rev, sh)]] = turns(versions(fused_sgm.K7, *a))
        print(f"K7 {arrows[(axis, rev, sh)]} {H}x{W} D={D}: {k7[arrows[(axis, rev, sh)]]}")
    result["K7 1080x1920 D=64 f32, ms per direction"] = k7
    three = [k7[a] for a in ("→x", "←x", "↓y")]
    result["K7 per launch over →x ←x ↓y"] = {
        v: sum(t[v] for t in three) / 3 for v in ("old", "new")}

    hc, wc, dc = 135, 240, 16
    vc = torch.randint(0, 60, (dc, hc, wc), generator=gen, device=dev).float()
    ac = torch.randint(0, 600, (dc, hc, wc), generator=gen, device=dev).float()
    oc = torch.empty_like(vc)
    coarse = {}
    for v in ("old", "new"):
        fns = [versions(fused_sgm.K7, vc.data_ptr(), ac.data_ptr(), oc.data_ptr(), 0, dc, hc,
                        wc, *fused_sgm._step(axis, rev, sh), 8.0, 96.0)[v]
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
    line = json.dumps(result, ensure_ascii=False)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
