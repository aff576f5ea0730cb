"""The port's host anchors (``stepth_tpu_torch.oracle``, ``stepth_tpu_torch.
native``) against the JAX package's, bit for bit, and the entry points that
name them (``depth --backend native|oracle``, ``DepthFrame`` method
``"native"``); and the guard that no module of the port imports ``jax`` or
``stepth_tpu``.

The pairs are the noisy 4×4-block pairs of ``chip_smoke.parity_pair`` at the
shapes and precisions the ROADMAP's re-anchor held parity on. Each test that
builds the native engine takes the ``gxx`` fixture: it skips where ``g++``
is missing.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from stepth_tpu import native as ref_native
from stepth_tpu.core.frame import DepthFrame as RefDepthFrame
from stepth_tpu.oracle import kmeans as ref_kmeans
from stepth_tpu.oracle import pipeline as ref_pipeline
from stepth_tpu.oracle import resize as ref_resize
from stepth_tpu.oracle import ring as ref_ring
from stepth_tpu.oracle import subdivision as ref_subdivision
from stepth_tpu_torch import DepthFrame, cli, native
from stepth_tpu_torch.core import io
from stepth_tpu_torch.match import parity
from stepth_tpu_torch.oracle import kmeans, pipeline, resize, ring, subdivision

import chip_smoke
from tests.torch_port import gxx, np_, one_torch_thread  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (shape, precision, seed): the pairs parity was held bit-equal on
CASES = [((120, 160), (20, 20, 20), 0), ((97, 131), (8, 30, 12), 1), ((64, 200), (50, 50, 50), 2)]


def _case(i):
    (h, w), prec, seed = CASES[i]
    main, add = chip_smoke.parity_pair(h, w, seed)
    return main, add, prec


@pytest.mark.parametrize("i", range(len(CASES)))
def test_oracle_equals_reference(gxx, i):
    """The subdivision in full; the whole pipeline at 64×200, and at the
    two larger pairs the ring search of 256 leaves drawn from a seed, since
    the NumPy ring search takes ~50 s a pair there on one core. The native
    engine's raw map, which the next test holds to the JAX package's, is
    the oracle's at every drawn leaf."""
    main, add, prec = _case(i)
    sub, ref_sub = subdivision.subdivide(main, prec), ref_subdivision.subdivide(main, prec)
    for name in ("value", "seed_x", "seed_y", "level", "x0", "y0", "bw", "bh"):
        np.testing.assert_array_equal(getattr(sub, name), getattr(ref_sub, name), err_msg=name)
    if CASES[i][0] == (64, 200):
        got = pipeline.depth_from_additional_oracle(main, add, prec)
        np.testing.assert_array_equal(got, ref_pipeline.depth_from_additional_oracle(main, add,
                                                                                     prec))
        np.testing.assert_array_equal(got, native.depth_from_additional(main, add, prec))
        assert got.dtype == np.uint8 and got.any()
        return
    raw = native.raw_disparity(main, add, prec)
    flat = np.random.default_rng(i).choice(main.shape[0] * main.shape[1], 256, replace=False)
    for y, x in zip(*np.unravel_index(flat, main.shape[:2])):
        args = (sub.value[y, x], add, int(sub.seed_x[y, x]), int(sub.seed_y[y, x]), prec)
        got = ring.ring_search(*args)
        assert got == ref_ring.ring_search(*args)
        assert raw[y, x] == got[0] & 0xFF


def test_oracle_utilities_equal_reference(rng):
    depth = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    rgba = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    for zones in (1, 2, 3, 5):
        assert kmeans.depth_split_oracle(depth, zones) == ref_kmeans.depth_split_oracle(depth,
                                                                                          zones)
    np.testing.assert_array_equal(pipeline.foreground_oracle(rgba, depth),
                                  ref_pipeline.foreground_oracle(rgba, depth))
    np.testing.assert_array_equal(resize.resize_u8_np(depth, 20, 30),
                                  ref_resize.resize_u8_np(depth, 20, 30))
    np.testing.assert_array_equal(resize.blur_u8_np(depth, 1.5), ref_resize.blur_u8_np(depth, 1.5))
    # parity's static geometry is the oracle's own, not a copy
    assert parity.level_geometry is subdivision.level_geometry
    assert parity.default_max_splits is subdivision.default_max_splits


@pytest.mark.parametrize("i", range(len(CASES)))
def test_native_equals_reference_and_parity(gxx, i):
    main, add, prec = _case(i)
    got = native.depth_from_additional(main, add, prec)
    np.testing.assert_array_equal(got, ref_native.depth_from_additional(main, add, prec))
    np.testing.assert_array_equal(got, np_(parity.depth_from_additional(main, add, prec,
                                                                        device="cpu")))
    np.testing.assert_array_equal(native.raw_disparity(main, add, prec, min_splits=4,
                                                       max_splits=9, max_radius=30),
                                  ref_pipeline.raw_disparity_map(main, add, prec, min_splits=4,
                                                                 max_splits=9, max_radius=30))


def test_native_matchers_equal_reference(gxx, rng):
    """The hierarchical matcher and SGM of the engine, on an integer gray
    pair, equal the JAX package's engine."""
    left = np.round(rng.uniform(0, 255, (48, 96))).astype(np.float32)
    right = np.roll(left, -5, axis=1)
    np.testing.assert_array_equal(
        native.hier_disparity(left, right, levels=2, coarsest_disparities=8, window=5),
        ref_native.hier_disparity(left, right, levels=2, coarsest_disparities=8, window=5))
    for directions in (4, 8):
        got = native.sgm_disparity(left, right, num_disparities=16, directions=directions)
        want = ref_native.sgm_disparity(left, right, num_disparities=16, directions=directions)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_native_build_is_the_ports_own(gxx):
    path = native.lib_path()
    native.load()
    assert path.exists() and path.is_relative_to(os.path.join(REPO, "stepth_tpu_torch", "_build"))
    assert path.name != os.path.basename(ref_native._so_path())


def test_native_build_failure_raises(tmp_path, monkeypatch, gxx):
    """A source that does not compile raises with the compiler's message;
    nothing falls back to the oracle."""
    bad = tmp_path / "engine.cc"
    bad.write_text("int stepth_native_version( { return 1; }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        native.depth_from_additional(*_case(2))
    assert not list((tmp_path / "_build").rglob("*.so"))


def test_cli_depth_backends(gxx, tmp_path):
    main, add = chip_smoke.parity_pair(40, 56, 3)
    prec = (20, 20, 20)
    mpath, apath = str(tmp_path / "main.png"), str(tmp_path / "add.png")
    io.save(mpath, main)
    io.save(apath, add)
    got = {}
    for backend in ("parity", "native", "oracle"):
        out = str(tmp_path / f"{backend}.png")
        argv = ["--device", "cpu", "depth", mpath, apath, out, "--precision", str(prec[0])]
        assert cli.main(argv + ([] if backend == "parity" else ["--backend", backend])) == 0
        got[backend] = io.open_luma(out)
    np.testing.assert_array_equal(got["native"], got["parity"])
    np.testing.assert_array_equal(got["oracle"], got["parity"])
    np.testing.assert_array_equal(np_(got["parity"]),
                                  ref_pipeline.depth_from_additional_oracle(main, add, prec))


def test_depth_frame_native(gxx):
    main, add, prec = _case(1)
    got = DepthFrame.from_array(main, device="cpu").load_depth_from_additional(
        add, prec, method="native")
    want = RefDepthFrame.from_array(main).load_depth_from_additional(add, prec, method="native")
    np.testing.assert_array_equal(np_(got.depth), np.asarray(want.depth))
    np.testing.assert_array_equal(np_(got.depth), np_(DepthFrame.from_array(
        main, device="cpu").load_depth_from_additional(add, prec).depth))


def test_port_imports_no_jax():
    """Every module of the port, but ``__main__``, imported in a fresh
    interpreter: neither ``jax`` nor ``stepth_tpu`` is loaded."""
    code = (
        "import pkgutil, importlib, sys, stepth_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(stepth_tpu_torch.__path__,"
        " 'stepth_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'stepth_tpu'))\n"
        "print(len(names), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) > 50 and bad.strip() == "[]", out.stdout
