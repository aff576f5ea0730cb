"""``fusion.geometry`` and ``core.io`` of the port against the JAX package's on
random inputs made with numpy.

Tolerances: every geometry function within 1e-5 relative (the SE(3) maps
go through sin/cos/arccos, whose last bits differ between the libraries;
≤ 4.8e-7 measured). ``project``, ``unproject``, ``disparity_to_depth`` and
``depth_to_points`` are bit-equal (the same f32 ops in the same order).
``save_ply`` writes the same bytes as the JAX package's, and the image I/O
round-trips the same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.core import io as ref_io
from stepth_tpu.fusion import geometry as ref_geometry
from stepth_tpu_torch.core import io
from stepth_tpu_torch.fusion import geometry

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)

INTR = np.array([500.0, 480.0, 320.0, 240.0], np.float32)


def _inputs(rng):
    w = rng.normal(0, 0.8, (24, 3)).astype(np.float32)
    w[0] = 0.0  # θ = 0: the series branch
    w[1] = 3e-5
    xi = rng.normal(0, 0.5, (24, 6)).astype(np.float32)
    xb = rng.normal(0, 0.5, (24, 6)).astype(np.float32)
    pts = rng.uniform(-1, 1, (24, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    pts[3, 2] = 0.0  # z clamped away from 0
    uv = rng.uniform(0, 640, (24, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 10, (24,)).astype(np.float32)
    R = np.array(ref_geometry.exp_so3(jnp.asarray(w)))
    return dict(w=w, xi=xi, xb=xb, pts=pts, uv=uv, depth=depth, R=R)


CALLS = {  # name: (argument names, exact)
    "hat": (("w",), True),
    "exp_so3": (("w",), False),
    "log_so3": (("R",), False),
    "exp_se3": (("xi",), False),
    "transform": (("xi", "pts"), False),
    "compose": (("xi", "xb"), False),
    "inverse": (("xi",), False),
    "relative": (("xi", "xb"), False),
    "project": (("pts", "intr"), True),
    "unproject": (("uv", "depth", "intr"), True),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_function_matches_reference(rng, name):
    data = dict(_inputs(rng), intr=INTR)
    names, exact = CALLS[name]
    want = getattr(ref_geometry, name)(*(jnp.asarray(data[n]) for n in names))
    got = getattr(geometry, name)(*(torch.from_numpy(data[n]) for n in names))
    if name == "exp_se3":
        want, got = jnp.concatenate([want[0].reshape(-1), want[1].reshape(-1)]), \
            torch.cat([got[0].reshape(-1), got[1].reshape(-1)])
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    if exact:
        np.testing.assert_array_equal(np_(got), np_(want))
    else:
        np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["python floats", "f32 scalars"])
def test_disparity_to_depth_and_points_bit_equal(rng, kind):
    disp = rng.uniform(-1, 70, (60, 80)).astype(np.float32)
    disp[0, :5] = [0.0, 1e-3, 2e-3, np.nan, -1.0]
    if kind == "python floats":
        f, b, pf, pb = 1400.0, 0.12, 1400.0, 0.12
    else:
        f, b = jnp.float32(1399.7), jnp.float32(0.1203)
        pf, pb = torch.tensor(1399.7), torch.tensor(0.1203)
    want = ref_geometry.disparity_to_depth(jnp.asarray(disp), f, b)
    got = geometry.disparity_to_depth(torch.from_numpy(disp), pf, pb)
    np.testing.assert_array_equal(np_(got), np_(want))
    want_p = ref_geometry.depth_to_points(want, jnp.asarray(INTR))
    got_p = geometry.depth_to_points(got, torch.from_numpy(INTR))
    assert got_p.shape == (60, 80, 3)
    np.testing.assert_array_equal(np_(got_p), np_(want_p))


@pytest.mark.parametrize("colors", ["none", "u8", "float"])
def test_save_ply_writes_reference_bytes(rng, tmp_path, colors):
    depth = rng.uniform(0.5, 8, (30, 40)).astype(np.float32)
    depth[2, :7] = np.inf
    pts = np.array(ref_geometry.depth_to_points(jnp.asarray(depth), jnp.asarray(INTR)))
    valid = rng.uniform(size=(30, 40)) > 0.2
    col = {"none": None, "u8": rng.integers(0, 256, (30, 40, 3), dtype=np.uint8),
           "float": rng.uniform(-20, 300, (30, 40, 3)).astype(np.float32)}[colors]
    n_ref = ref_io.save_ply(tmp_path / "ref.ply", pts, colors=col, valid=valid)
    n = io.save_ply(tmp_path / "port.ply", torch.from_numpy(pts),
                    colors=None if col is None else torch.from_numpy(col),
                    valid=torch.from_numpy(valid))
    assert n == n_ref == int((valid & np.isfinite(pts).all(-1)).sum())
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()


def test_image_io_round_trip(rng, tmp_path):
    rgb = rng.integers(0, 256, (12, 17, 3), dtype=np.uint8)
    io.save(tmp_path / "a.png", torch.from_numpy(rgb))
    np.testing.assert_array_equal(io.open_rgb(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(io.open_luma(tmp_path / "a.png"),
                                  ref_io.open_luma(tmp_path / "a.png"))
    np.testing.assert_array_equal(io.open_rgba(tmp_path / "a.png"), ref_io.rgb_to_rgba(rgb))
    np.testing.assert_array_equal(io.rgba_to_rgb(io.rgb_to_rgba(rgb)), rgb)
    with pytest.raises(io.ImageIOError):
        io.open_rgb(tmp_path / "missing.png")
