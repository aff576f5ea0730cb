"""The port's device mesh and halo exchange (``stepth_tpu_torch/parallel``)
against the JAX package's (``stepth_tpu/parallel/mesh.py``,
``sharded.py:35-63``), and the rule that entry points run on the card.

The JAX meshes come from the 8-fake-device conftest; the port's are meshes
of ``"cpu"`` devices with the same ``(data, tile)``. Halos are copies, so
they must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from stepth_tpu.config import MatchConfig as RefMatchConfig
from stepth_tpu.parallel import mesh as ref_mesh
from stepth_tpu.parallel import sharded as ref_sharded
from stepth_tpu_torch.config import MatchConfig, SGMConfig
from stepth_tpu_torch.match import fused_sgm
from stepth_tpu_torch.models.stereo import StereoModel
from stepth_tpu_torch.ops import rectify
from stepth_tpu_torch.parallel import mesh, sharded

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("data, tile", [(1, None), (2, None), (2, 4), (4, 2), (1, 3)])
def test_make_mesh_shapes_match_reference(data, tile):
    want = ref_mesh.make_mesh(data=data, tile=tile)
    got = mesh.make_mesh(data=data, tile=tile, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert all(d == torch.device("cpu") for row in got.devices for d in row)
    assert got.first == torch.device("cpu")


@pytest.mark.parametrize("data, tile", [(3, None), (3, 3), (1, 9)])
def test_make_mesh_errors_match_reference(data, tile):
    with pytest.raises(ValueError) as want:
        ref_mesh.make_mesh(data=data, tile=tile)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(data=data, tile=tile, devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)


def test_mesh_keeps_repeated_and_distinct_devices():
    m = mesh.make_mesh(data=2, tile=2, devices=["cpu", "cpu", "meta", "meta"])
    assert m.devices == ((torch.device("cpu"),) * 2, (torch.device("meta"),) * 2)


def test_make_mesh_without_devices_takes_the_cuda_devices():
    """No ``devices``: every visible CUDA device, and with none it raises
    (no CPU fallback); so does ``single_device_mesh``."""
    if torch.cuda.is_available():
        assert mesh.make_mesh().shape["tile"] == torch.cuda.device_count()
        assert mesh.single_device_mesh().devices == ((torch.device("cuda", 0),),)
        return
    for fn in (mesh.make_mesh, mesh.single_device_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def _ref_halos(x, ntile, halo, edge):
    """The reference's ``halo_exchange_rows`` under ``shard_map``: per-shard
    (top, bottom) slabs, stacked [ntile, halo, W]."""
    fn = shard_map(
        lambda blk: ref_sharded.halo_exchange_rows(blk, halo, "tile", edge),
        mesh=ref_mesh.make_mesh(data=1, tile=ntile),
        in_specs=P("tile", None), out_specs=(P("tile", None), P("tile", None)),
    )
    return [np.asarray(a).reshape(ntile, halo, -1) for a in fn(jnp.asarray(x))]


@pytest.mark.parametrize("edge", ["zero", "replicate"])
@pytest.mark.parametrize("ntile, halo", [(2, 1), (4, 3), (8, 4)])
def test_halo_exchange_matches_reference(rng, ntile, halo, edge):
    x = rng.uniform(-100, 100, (ntile * 6, 40)).astype(np.float32)
    want_top, want_bot = _ref_halos(x, ntile, halo, edge)
    blocks = sharded.scatter_rows(x, mesh.make_mesh(tile=ntile, devices=["cpu"] * ntile)
                                  .devices[0])
    got = sharded.halo_exchange_rows(blocks, halo, edge)
    for i, (top, bot) in enumerate(got):
        np.testing.assert_array_equal(np_(top), want_top[i])
        np.testing.assert_array_equal(np_(bot), want_bot[i])
    ext = sharded._with_halo(blocks, halo, edge)
    np.testing.assert_array_equal(np_(ext[1]), np.concatenate([want_top[1], x[6:12],
                                                               want_bot[1]]))
    with pytest.raises(ValueError, match="edge"):
        sharded.halo_exchange_rows(blocks, halo, "wrap")


@pytest.mark.parametrize("cfg", [dict(window=9), dict(window=5, cost="census"),
                                 dict(window=1), dict(window=9, cost="census",
                                                      census_window=9)])
def test_required_halo_matches_reference(cfg):
    assert sharded.required_halo(MatchConfig(**cfg)) == ref_sharded.required_halo(
        RefMatchConfig(**cfg))


def test_scatter_and_gather_rows(rng):
    rgb = rng.integers(0, 256, (12, 7, 3)).astype(np.uint8)
    devs = mesh.make_mesh(tile=3, devices=["cpu"] * 3).devices[0]
    for x in (rgb, torch.from_numpy(rgb)):
        blocks = sharded.scatter_rows(x, devs)
        assert [tuple(b.shape) for b in blocks] == [(4, 7, 3)] * 3
        assert all(b.is_contiguous() for b in blocks)
        np.testing.assert_array_equal(np_(sharded.gather_rows(blocks, "cpu")), rgb)
    with pytest.raises(ValueError, match="not divisible by tile axis 5"):
        sharded.scatter_rows(rgb, ["cpu"] * 5)


def test_arrays_default_to_the_card(rng):
    """Entry points put arrays given without ``device=`` on the card; with no
    card they raise instead of running on the CPU (``device="cpu"`` asks for
    the CPU)."""
    g = rng.integers(0, 256, (32, 96)).astype(np.float32)
    cfg = MatchConfig(num_disparities=8, window=5)
    if torch.cuda.is_available():
        assert StereoModel(backend="dense", match=cfg)(g, g).disparity.is_cuda
        return
    calls = [
        lambda: StereoModel(backend="dense", match=cfg)(g, g),
        lambda: StereoModel(backend="hierarchical-pallas")(g, g),
        lambda: fused_sgm.match_pair_sgm_fused(g, g, cfg, SGMConfig()),
        lambda: rectify.maps_from_arrays(np.zeros((4, 4, 2)), np.zeros((4, 4, 2)), 1.0, 0.1,
                                         np.eye(3)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no CUDA device"):
            call()
    assert StereoModel(backend="dense", match=cfg)(g, g, device="cpu").disparity.is_cpu
