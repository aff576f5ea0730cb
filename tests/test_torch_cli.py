"""The port's command line (``python -m stepth_tpu_torch``, ``--device
cpu``): the counterparts of ``tests/test_cli_debug.py``'s ``stereo`` and
``video`` cases, and ``depth`` and ``foreground`` against the JAX
package's outputs."""

import collections
import json

import numpy as np
import pytest
import torch

from stepth_tpu import cli as ref_cli
from stepth_tpu_torch import cli
from stepth_tpu_torch.config import MatchConfig, PyramidConfig
from stepth_tpu_torch.core import io
from stepth_tpu_torch.models import StereoModel

from tests.torch_port import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = ["--device", "cpu"]


@pytest.fixture
def small_pair(tmp_path, rng):
    main = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    add = np.roll(main, 3, axis=1)
    mp, ap = str(tmp_path / "m.png"), str(tmp_path / "a.png")
    io.save(mp, main)
    io.save(ap, add)
    return mp, ap


@pytest.mark.parametrize("cmd", ["depth", "foreground"])
def test_depth_and_foreground_match_reference(small_pair, tmp_path, cmd):
    mp, ap = small_pair
    got, want = str(tmp_path / "got.png"), str(tmp_path / "want.png")
    assert cli.main(CPU + [cmd, mp, ap, got, "--precision", "30"]) == 0
    assert ref_cli.main([cmd, mp, ap, want, "--precision", "30"]) == 0
    np.testing.assert_array_equal(io.open_rgba(got), io.open_rgba(want))


@pytest.mark.parametrize("backend", ["dense", "hierarchical", "parity"])
def test_stereo(small_pair, tmp_path, backend):
    mp, ap = small_pair
    out = str(tmp_path / "s.png")
    args = ["stereo", mp, ap, out, "--disparities", "8", "--window", "5", "--backend", backend]
    assert cli.main(CPU + args) == 0
    got = io.open_luma(out)
    assert got.shape == (24, 32)
    model = StereoModel(backend=backend, match=MatchConfig(num_disparities=8, window=5))
    want = model.depth_u8(io.open_rgb(mp), io.open_rgb(ap), device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    if backend == "dense":  # the JAX package's CLI on the same files
        ref_out = str(tmp_path / "r.png")
        assert ref_cli.main(args[:3] + [ref_out] + args[4:]) == 0
        np.testing.assert_array_equal(got, io.open_luma(ref_out))


def _clip(tmp_path, rng, n, h=64, w=96, shift=3, vary=True):
    ldir, rdir = tmp_path / "l", tmp_path / "r"
    ldir.mkdir(), rdir.mkdir()
    base = rng.integers(0, 255, (h, w + shift, 3), dtype=np.uint8)
    for i in range(n):
        f = np.clip(base.astype(np.int16) + (i % 3 if vary else 0), 0, 255).astype(np.uint8)
        io.save(str(ldir / f"{i:03d}.png"), f[:, :w])
        io.save(str(rdir / f"{i:03d}.png"), f[:, shift : shift + w])
    return ldir, rdir


VIDEO = ["--disparities", "8", "--window", "5", "--levels", "2", "--coarsest", "4",
         "--chunk", "3", "--format", "npz"]


def test_video(tmp_path, rng):
    """Globs in, a depth stream out, chunk by chunk through model.video (a
    partial last chunk too); npz carries f32 disparity and validity."""
    h, w, shift, n = 64, 96, 3, 5
    ldir, rdir = _clip(tmp_path, rng, n, h, w, shift)
    out = tmp_path / "depth"
    assert cli.main(CPU + ["video", str(ldir), str(rdir), str(out), "--keyframe-interval",
                           "2"] + VIDEO) == 0
    files = sorted(out.iterdir())
    assert len(files) == n, files
    model = StereoModel(backend="hierarchical-pallas",
                        match=MatchConfig(num_disparities=8, window=5),
                        pyramid=PyramidConfig(levels=2, coarsest_disparities=4))
    frames = [(io.open_rgb(str(ldir / f"{i:03d}.png")), io.open_rgb(str(rdir / f"{i:03d}.png")))
              for i in range(n)]
    for c0 in range(0, n, 3):
        ls = torch.from_numpy(np.stack([l for l, _ in frames[c0:c0 + 3]])).to(torch.float32)
        rs = torch.from_numpy(np.stack([r for _, r in frames[c0:c0 + 3]])).to(torch.float32)
        want = model.video(keyframe_interval=2)(ls, rs)
        for t in range(ls.shape[0]):
            data = np.load(files[c0 + t])
            np.testing.assert_array_equal(data["disparity"], want.disparity[t].numpy())
            np.testing.assert_array_equal(data["valid"], want.valid[t].numpy())
    data = np.load(files[0])
    assert data["disparity"].shape == (h, w)
    assert abs(np.median(data["disparity"][8:-8, 16:-16]) - shift) <= 1.0


def test_video_png_frames(tmp_path, rng):
    ldir, rdir = _clip(tmp_path, rng, 2)
    out = tmp_path / "png"
    args = ["video", str(ldir), str(rdir), str(out)] + VIDEO[:-2] + ["--lr-check"]
    assert cli.main(CPU + args) == 0
    files = sorted(out.iterdir())
    assert [f.name for f in files] == ["depth_00000.png", "depth_00001.png"]
    assert io.open_luma(str(files[1])).shape == (64, 96)


def test_video_trace_dir(tmp_path, rng):
    """--trace-dir profiles the stream: the program's spans in the Chrome
    trace, and what the stream added to the loader's counters."""
    ldir, rdir = _clip(tmp_path, rng, 2)
    trace = tmp_path / "trace"
    args = ["video", str(ldir), str(rdir), str(tmp_path / "o"), "--trace-dir", str(trace)]
    assert cli.main(CPU + args + VIDEO) == 0
    with open(trace / "trace.json") as fh:
        names = collections.Counter(e.get("name") for e in json.load(fh)["traceEvents"])
    assert names["stepth/call"] == 1 and names["stepth/loader/take"] == 2
    assert names["stepth/refine"] == 2 and names["stepth/post"] == 2
    with open(trace / "counters.json") as fh:
        counted = json.load(fh)
    assert counted["loader.takes"] == 2 and 0 <= counted.get("loader.starved", 0) <= 2


def test_video_frame_count_mismatch(tmp_path, rng):
    ldir, rdir = tmp_path / "l2", tmp_path / "r2"
    ldir.mkdir(), rdir.mkdir()
    img = rng.integers(0, 255, (16, 32, 3), dtype=np.uint8)
    io.save(str(ldir / "0.png"), img)
    io.save(str(ldir / "1.png"), img)
    io.save(str(rdir / "0.png"), img)
    with pytest.raises(SystemExit, match="mismatch"):
        cli.main(CPU + ["video", str(ldir), str(rdir), str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="no frames"):
        cli.main(CPU + ["video", str(tmp_path / "*.none"), str(rdir), str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="coarsest"):
        cli.main(CPU + ["video", str(ldir), str(ldir), str(tmp_path / "o"), "--disparities",
                        "64", "--levels", "2", "--coarsest", "16"])


def test_video_sharded(tmp_path, rng):
    """--shard-tiles N runs the row-tile-sharded temporal twin over N CPU
    devices; it equals the unsharded video at its tile rows."""
    h, w, shift, n = 64, 96, 3, 3
    ldir, rdir = _clip(tmp_path, rng, n, h, w, shift, vary=False)
    out = tmp_path / "ds"
    assert cli.main(CPU + ["video", str(ldir), str(rdir), str(out), "--shard-tiles", "2"]
                    + VIDEO) == 0
    files = sorted(out.iterdir())
    assert len(files) == n
    dd = np.load(files[-1])["disparity"]
    assert abs(np.median(dd[8:-8, 16:-16]) - shift) <= 1.0


def test_device_flag():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(["stereo", "l.png", "r.png", "o.png"])
    with pytest.raises(SystemExit):
        cli.main(CPU + ["stereo", "l.png", "r.png", "o.png", "--backend", "nope"])
