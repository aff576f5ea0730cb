"""The sharded ``sgm-pallas`` path (``parallel/sgm_pallas_sharded.py``):
exact mode against the port's unsharded pipeline, a few direct anchors
against the JAX package's ``match_pair_sgm_pallas_sharded`` (interpret
mode, the 8-fake-device mesh), windowed mode, ``StereoModel.sharded`` and
the reference's errors.

Rules: on integer-valued gray images every cost and path sum is an exact f32
integer, so exact mode equals the unsharded pipeline bit for bit at 2, 4 and
8 directions (the port never transposes a diagonal scan), and the port
equals the JAX sharded function bit for bit in both modes — windowed mode is
approximate against the unsharded path, but it is a fixed function. A JAX
sharded call costs 8–20 s here, so there are three, each made once
(module-scoped).
"""

import numpy as np
import pytest
import torch

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.match.sgm import SGMConfig as RefSGMConfig
from stepth_tpu.parallel import mesh as ref_mesh
from stepth_tpu.parallel import sgm_pallas_sharded as ref_sps
from stepth_tpu_torch.config import MatchConfig, SGMConfig
from stepth_tpu_torch.match import fused_sgm
from stepth_tpu_torch.models.stereo import StereoModel
from stepth_tpu_torch.parallel import mesh, sgm_pallas_sharded

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)

CFG = dict(num_disparities=16, window=5, lr_threshold=1.0)


def int_pair(h=64, w=96, shift=5, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    return left, np.roll(left, -shift, axis=1)


def cpu_mesh(ntile, data=1):
    return mesh.make_mesh(data=data, tile=ntile, devices=["cpu"] * (data * ntile))


def assert_equal(want, got):
    for f in ("disparity", "valid", "cost"):
        np.testing.assert_array_equal(np_(getattr(got, f)), np_(getattr(want, f)), err_msg=f)


def _sgm(cost, **kw):
    """The reference tests' penalties: the defaults for SAD, 2/8 for census."""
    return dict(kw, p1=2.0, p2=8.0) if cost == "census" else kw


@pytest.mark.parametrize("ndir", [2, 4, 8])
@pytest.mark.parametrize("ntile", [2, 4])
@pytest.mark.parametrize("cost", ["sad", "census"])
def test_exact_mode_equals_unsharded(cost, ntile, ndir):
    """Disparity, valid and cost equal the unsharded plain pipeline's."""
    left, right = int_pair()
    cfg = MatchConfig(**CFG, cost=cost, census_window=5)
    sgm = SGMConfig(**_sgm(cost, directions=ndir))
    want = fused_sgm.match_pair_sgm_plain(left, right, cfg, sgm, device="cpu")
    got = sgm_pallas_sharded.match_pair_sgm_pallas_sharded(left, right, cfg, sgm,
                                                           cpu_mesh(ntile))
    assert got.disparity.shape == (64, 96) and got.valid.dtype == torch.bool
    assert_equal(want, got)


ANCHORS = {  # name: (cfg, sgm, tiles, mode)
    "exact census 4 tiles": (dict(cost="census", census_window=5),
                             _sgm("census", directions=4), 4, dict(exact=True)),
    "exact bf16 2 tiles": ({}, dict(directions=4, volume_dtype="bf16"), 2, dict(exact=True)),
    "windowed 2 tiles": ({}, dict(directions=4), 2, dict(exact=False, warmup=16)),
}


@pytest.fixture(scope="module")
def reference():
    """The JAX sharded outputs, each computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, sgm, ntile, mode = ANCHORS[name]
            cache[name] = ref_sps.match_pair_sgm_pallas_sharded(
                *int_pair(), RefMatchConfig(**CFG, **cfg), RefSGMConfig(**sgm),
                mesh=ref_mesh.make_mesh(data=1, tile=ntile), **mode)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ANCHORS)
def test_matches_reference(reference, name):
    cfg, sgm, ntile, mode = ANCHORS[name]
    got = sgm_pallas_sharded.match_pair_sgm_pallas_sharded(
        *int_pair(), MatchConfig(**CFG, **cfg), SGMConfig(**sgm), cpu_mesh(ntile), **mode)
    assert_equal(reference(name), got)


def test_windowed_mode_close_to_unsharded(reference):
    """The reference's statistical rule (``tests/test_sgm_pallas_sharded.py:
    101-124``): the warm-up approximation decays away from the seam."""
    left, right = int_pair()
    cfg, sgm = MatchConfig(**CFG), SGMConfig(directions=4)
    want = fused_sgm.match_pair_sgm_plain(left, right, cfg, sgm, device="cpu")
    got = sgm_pallas_sharded.match_pair_sgm_pallas_sharded(left, right, cfg, sgm, cpu_mesh(2),
                                                           exact=False, warmup=16)
    np.testing.assert_array_equal(np_(got.disparity),
                                  np.asarray(reference("windowed 2 tiles").disparity))
    d = np.abs(np_(want.disparity) - np_(got.disparity))
    assert np.median(d) <= 0.1
    assert (d <= 1.0).mean() > 0.97
    far = np.concatenate([d[:16], d[-16:]])
    assert (far <= 1e-4).mean() > 0.99


def test_model_sharded_dispatch():
    """``StereoModel(backend="sgm-pallas").sharded(mesh)`` runs the sharded
    path and passes its keywords through."""
    left, right = int_pair()
    model = StereoModel(backend="sgm-pallas", match=MatchConfig(**CFG),
                        sgm=SGMConfig(directions=4))
    run = model.sharded(cpu_mesh(2))
    assert_equal(model(left, right, device="cpu"), run(left, right))
    assert_equal(sgm_pallas_sharded.match_pair_sgm_pallas_sharded(
        left, right, model.match, model.sgm, cpu_mesh(2), exact=False, warmup=16),
        run(left, right, exact=False, warmup=16))


@pytest.mark.parametrize("h, ntile, cfg, sgm, mode, error", [
    (66, 4, {}, {}, {}, ValueError),  # H % tiles
    (60, 4, {}, {}, {}, ValueError),  # a shard height of 15 is not a multiple of 8
    (32, 4, {}, {}, dict(exact=False, warmup=16), ValueError),  # 8 < halo 3 + warm-up 16
    (32, 4, dict(window=9, cost="census", census_window=9), {}, {}, ValueError),  # 8 < 9
    (32, 2, {}, dict(directions=6), {}, ValueError),
    (32, 2, dict(cost="ncc"), {}, {}, NotImplementedError),
])
def test_reference_errors(h, ntile, cfg, sgm, mode, error):
    """The port rejects what the reference rejects, with the same type."""
    left, right = int_pair(h=h)
    cfg = dict(CFG, **cfg)
    with pytest.raises(error):
        ref_sps.match_pair_sgm_pallas_sharded(
            left, right, RefMatchConfig(**cfg), RefSGMConfig(**sgm),
            mesh=ref_mesh.make_mesh(data=1, tile=ntile), **mode)
    with pytest.raises(error):
        sgm_pallas_sharded.match_pair_sgm_pallas_sharded(
            left, right, MatchConfig(**cfg), SGMConfig(**sgm), cpu_mesh(ntile), **mode)
