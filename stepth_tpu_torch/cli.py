"""Command-line interface of the port (twin of ``stepth_tpu/cli.py``): a
wrapper over the same public API a library user calls.

    python -m stepth_tpu_torch depth MAIN ADD OUT         # the reference's own flow
        [--backend parity|native|oracle]
    python -m stepth_tpu_torch stereo LEFT RIGHT OUT      # rectified-stereo depth
    python -m stepth_tpu_torch video 'l/*.png' 'r/*.png' OUTDIR   # depth stream
    python -m stepth_tpu_torch foreground MAIN ADD OUT    # README foreground flow

Everything runs on ``--device`` (before the command; ``cuda`` by default,
``cpu`` on request), except ``depth --backend native|oracle``, host engines
by design.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

BACKENDS = ["dense", "pallas", "hierarchical", "hierarchical-pallas", "hierarchical-sgm",
            "sgm", "sgm-pallas", "parity"]


def _cmd_depth(args) -> int:
    from stepth_tpu_torch.core import io

    main, add = io.open_rgb(args.main), io.open_rgb(args.additional)
    prec = (args.precision,) * 3
    if args.backend == "native":  # the C++ host engine
        from stepth_tpu_torch import native

        depth = native.depth_from_additional(main, add, prec)
    elif args.backend == "oracle":  # the NumPy oracle, on the host
        from stepth_tpu_torch.oracle import pipeline

        depth = pipeline.depth_from_additional_oracle(main, add, prec)
    else:
        from stepth_tpu_torch.match import parity

        depth = parity.depth_from_additional(main, add, prec, device=args.device)
    io.save(args.out, depth)
    print(f"wrote {args.out} ({depth.shape[1]}x{depth.shape[0]})")
    return 0


def _cmd_stereo(args) -> int:
    from stepth_tpu_torch.config import MatchConfig
    from stepth_tpu_torch.core import io
    from stepth_tpu_torch.models import StereoModel

    model = StereoModel(
        backend=args.backend,
        match=MatchConfig(num_disparities=args.disparities, window=args.window,
                          cost=args.cost),
        lr_check=args.lr_check,
    )
    depth = model.depth_u8(io.open_rgb(args.left), io.open_rgb(args.right), args.device)
    io.save(args.out, depth)
    print(f"wrote {args.out} ({depth.shape[1]}x{depth.shape[0]})")
    return 0


def _cmd_foreground(args) -> int:
    from stepth_tpu_torch.core.frame import DepthFrame

    frame = DepthFrame.open(args.main, args.device).open_depth_from_additional(
        args.additional, (args.precision,) * 3)
    out = frame.invert_depth().select_foreground().apply_mask()
    out.save(args.out)  # quirk Q7: saves the masked image, like the reference
    print(f"wrote {args.out}")
    return 0


def _expand(pattern: str) -> list:
    """Sorted frame paths of a directory (png/jpg) or a glob."""
    if os.path.isdir(pattern):
        names = sorted(os.path.join(pattern, n) for n in os.listdir(pattern)
                       if n.lower().endswith((".png", ".jpg", ".jpeg")))
    else:
        names = sorted(glob.glob(pattern))
    if not names:
        raise SystemExit(f"no frames match {pattern!r}")
    return names


def _cmd_video(args) -> int:
    """Stereo video serving: frame streams in, a depth stream out.

    Left/right frames come from globs (sorted) or directories; decoding and
    the copy to the device ride :class:`stepth_tpu_torch.core.loader.
    PrefetchLoader` worker threads, and matching runs a chunk at a time
    through ``StereoModel.video`` (non-keyframes skip the coarse pyramid,
    seeded by the previous frame's disparity; a chunk starts at a keyframe).
    ``--shard-tiles N`` runs the row-tile-sharded temporal twin
    (``parallel.sharded.match_temporal_sharded``) over N devices: the
    visible cards, or N CPU devices under ``--device cpu``. ``--trace-dir
    DIR`` profiles the stream (``utils.tracing.device_trace``: the
    program's ``stepth/`` spans beside the card's kernels and copies in
    ``DIR/trace.json``) and writes what the stream added to the counters
    (``utils.tracing.counters()``: the loader's takes and starved takes,
    the census kernel's pairs) to ``DIR/counters.json``."""
    from stepth_tpu_torch.config import MatchConfig, PyramidConfig
    from stepth_tpu_torch.core import io
    from stepth_tpu_torch.core.loader import PrefetchLoader
    from stepth_tpu_torch.match import dense
    from stepth_tpu_torch.models import StereoModel
    from stepth_tpu_torch.utils import tracing

    lefts, rights = _expand(args.left), _expand(args.right)
    if len(lefts) != len(rights):
        raise SystemExit(f"frame count mismatch: {len(lefts)} left vs {len(rights)} right")
    os.makedirs(args.out, exist_ok=True)

    match = MatchConfig(num_disparities=args.disparities, window=args.window, cost=args.cost)
    pyr = PyramidConfig(levels=args.levels, coarsest_disparities=args.coarsest)
    if args.coarsest << (args.levels - 1) < args.disparities:
        raise SystemExit(
            f"coarsest*2^(levels-1) = {args.coarsest << (args.levels - 1)} "
            f"< disparities {args.disparities}: raise --coarsest or --levels")
    model = StereoModel(backend=args.backend, match=match, pyramid=pyr, lr_check=args.lr_check)

    if args.shard_tiles:
        from stepth_tpu_torch.parallel import mesh as mesh_mod, sharded

        devices = [args.device] * args.shard_tiles if args.device.type == "cpu" else None
        mesh = mesh_mod.make_mesh(data=1, tile=args.shard_tiles, devices=devices)

        def run(ls, rs):
            return sharded.match_temporal_sharded(
                ls, rs, match, pyr, mesh, keyframe_interval=args.keyframe_interval,
                lr_check=args.lr_check)
    else:
        run = model.video(keyframe_interval=args.keyframe_interval)

    def load_pair(i):
        return io.open_rgb(lefts[i]), io.open_rgb(rights[i])

    loader = PrefetchLoader(range(len(lefts)), load_pair, num_threads=args.threads,
                            buffer=2 * args.chunk, device=args.device)
    n_done = 0
    chunk = []

    def flush():
        nonlocal n_done
        if not chunk:
            return
        ls = torch.stack([l for l, _ in chunk]).to(torch.float32)
        rs = torch.stack([r for _, r in chunk]).to(torch.float32)
        res = run(ls, rs)
        for t in range(res.disparity.shape[0]):
            path = os.path.join(args.out, f"depth_{n_done + t:05d}")
            if args.format == "png":
                io.save(path + ".png",
                        dense.disparity_to_depth_u8(res.disparity[t], args.disparities))
            else:
                np.savez(path + ".npz", disparity=res.disparity[t].cpu().numpy(),
                         valid=res.valid[t].cpu().numpy())
        n_done += res.disparity.shape[0]
        chunk.clear()

    counted = tracing.counters()
    with tracing.device_trace(args.trace_dir):
        for pair in loader:
            chunk.append(pair)
            if len(chunk) == args.chunk:
                flush()
        flush()
    if args.trace_dir is not None:
        added = {k: v - counted.get(k, 0) for k, v in tracing.counters().items()}
        with open(os.path.join(args.trace_dir, "counters.json"), "w") as f:
            json.dump(added, f, indent=1, sort_keys=True)
    print(f"wrote {n_done} depth frames to {args.out} ({args.format})")
    return 0


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available: pass --device cpu to run on the CPU")
    return device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stepth_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=_device, default="cuda",
                   help="torch device every command runs on (default: cuda)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("depth", help="reference-parity depth from an additional view")
    d.add_argument("main")
    d.add_argument("additional")
    d.add_argument("out")
    d.add_argument("--precision", type=int, default=36)
    d.add_argument("--backend", choices=["parity", "native", "oracle"], default="parity",
                   help="parity: torch on --device (default); native: the C++ host engine; "
                   "oracle: the NumPy oracle (both on the host, the same output)")
    d.set_defaults(fn=_cmd_depth)

    s = sub.add_parser("stereo", help="dense rectified-stereo disparity")
    s.add_argument("left")
    s.add_argument("right")
    s.add_argument("out")
    s.add_argument("--disparities", type=int, default=64)
    s.add_argument("--window", type=int, default=9)
    s.add_argument("--cost", choices=["sad", "ssd", "census"], default="sad",
                   help="census is the exposure-robust production cost")
    s.add_argument("--lr-check", action="store_true", dest="lr_check",
                   help="flag occlusions by the left-right consistency check "
                   "(hierarchical-pallas/-sgm: the final level's right view; the "
                   "others take it from the matcher's lr_threshold)")
    s.add_argument("--backend", choices=BACKENDS, default="dense")
    s.set_defaults(fn=_cmd_stereo)

    v = sub.add_parser("video", help="stereo video -> depth stream (temporally seeded)")
    v.add_argument("left", help="glob or directory of left frames")
    v.add_argument("right", help="glob or directory of right frames")
    v.add_argument("out", help="output directory")
    v.add_argument("--backend", choices=["hierarchical-pallas", "hierarchical-sgm"],
                   default="hierarchical-pallas")
    v.add_argument("--disparities", type=int, default=128)
    v.add_argument("--window", type=int, default=9)
    v.add_argument("--cost", choices=["sad", "ssd", "census"], default="sad",
                   help="census is the exposure-robust production cost")
    v.add_argument("--lr-check", action="store_true", dest="lr_check")
    v.add_argument("--levels", type=int, default=4)
    v.add_argument("--coarsest", type=int, default=16, help="coarsest-level disparity range")
    v.add_argument("--keyframe-interval", type=int, default=8, dest="keyframe_interval")
    v.add_argument("--chunk", type=int, default=8,
                   help="frames per model.video call (a chunk starts at a keyframe)")
    v.add_argument("--threads", type=int, default=4, help="decode/prefetch worker threads")
    v.add_argument("--format", choices=["png", "npz"], default="png",
                   help="png: u8 depth frames; npz: f32 disparity + validity")
    v.add_argument("--shard-tiles", type=int, default=0, dest="shard_tiles",
                   help="row-tile-shard each frame over this many devices")
    v.add_argument("--trace-dir", default=None, dest="trace_dir",
                   help="profile the stream: DIR/trace.json (a Chrome trace) and "
                   "DIR/counters.json (the loader's takes and starved takes, the census "
                   "kernel's pairs)")
    v.set_defaults(fn=_cmd_video)

    f = sub.add_parser("foreground", help="README foreground-extraction flow")
    f.add_argument("main")
    f.add_argument("additional")
    f.add_argument("out")
    f.add_argument("--precision", type=int, default=36)
    f.set_defaults(fn=_cmd_foreground)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
