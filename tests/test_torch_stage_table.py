"""The matcher's one stage table and the one kernel registry.

``fused_refine.Stages`` holds every stage of the matcher's pipelines;
``FUSED`` and ``PLAIN`` are its only instances, and every pipeline takes
one as its first argument. ``drill.checked_stages`` builds a table whose
every stage runs the kernel's wrapper against its plain version, so a
checked run needs no module global patched. Every ``kernels.Kernel``
records itself under the key the tools print. This file imports neither
JAX nor the JAX package: ``pytest --noconftest tests/test_torch_stage_table.py``
runs it on the card."""

import sys

import pytest
import torch

from stepth_tpu_torch import kernels
from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.parallel import drill, sgm_pallas_sharded
from stepth_tpu_torch.parallel.mesh import make_mesh

from tests.torch_port import cuda, one_torch_thread  # noqa: F401 (fixtures)

CENSUS = MatchConfig(num_disparities=16, window=9, cost="census", census_window=5)
PYR = PyramidConfig(levels=2, coarsest_disparities=8)


def test_every_kernel_is_registered_once():
    """Each ``Kernel`` that is a module attribute of the package is in the
    registry exactly once, under its own key; a second kernel under a key
    already taken is refused."""
    registry = kernels.registry()
    defined = {id(v): v for name, mod in list(sys.modules.items())
               if name.startswith("stepth_tpu_torch.") for v in vars(mod).values()
               if isinstance(v, kernels.Kernel)}
    assert len(defined) == len(registry)
    assert sorted(map(id, registry.values())) == sorted(defined)
    assert all(k.key == key for key, k in registry.items())
    assert list(registry)[:4] == ["K1", "K2", "K2 emit", "K2 plan"]
    assert list(registry)[-1] == "census"
    with pytest.raises(ValueError, match="already registered"):
        kernels.Kernel("K1", "K1 again", "stepth_fused_dense", [], source="", replaces="")
    assert kernels.REGISTRY["K1"] is registry["K1"]


def test_every_kernel_takes_what_its_c_prototype_declares():
    """Each kernel's argument types, and the stream after them, are as many
    as its ``extern "C"`` prototype declares (``compare_kernels.c_arity``,
    which calls an older library with as many as its own sources declare)."""
    import compare_kernels

    for key, k in kernels.registry().items():
        assert compare_kernels.c_arity(kernels.CSRC_DIR, k.symbol) == len(k.argtypes) + 1, key


def test_stage_kernels_name_every_stage_by_registered_keys():
    registry = kernels.registry()
    assert set(fused_refine.STAGE_KERNELS) == set(fused_refine.Stages._fields)
    assert "plan" in fused_refine.Stages._fields and "sgm" not in fused_refine.Stages._fields
    for field, names in fused_refine.STAGE_KERNELS.items():
        assert names and all(n in registry for n in names), field


def _pair(h, w, shift, device):
    left = torch.round(torch.rand((h, w), generator=torch.Generator().manual_seed(3)) * 255)
    return left.to(device), torch.roll(left, -shift, 1).to(device)


def _assert_bits_equal(want, got):
    for name, w, g in zip(want._fields, want, got):
        assert drill.bits_equal(w, g), name


def _paired_hierarchical(device):
    """hierarchical-pallas (census, ``lr_check``, 2 levels) through the
    checked table: equal to the unchecked run, the plan a stage of its own,
    and ``FUSED`` untouched."""
    left, right = _pair(64, 128, 5, device)
    fused = fused_refine.FUSED
    want = fused_refine.match_hierarchical_fused(left, right, CENSUS, PYR, tile_rows=8,
                                                 lr_check=True)
    seen = {}
    got = fused_refine._match_hierarchical(drill.checked_stages("test", seen), left, right,
                                           CENSUS, PYR, 8, True, "wta", None)
    assert fused_refine.FUSED is fused
    _assert_bits_equal(want, got)
    assert set(seen) == {"K1", "K2 plan", "K2", "K2 emit", "K4", "K5", "K3"}
    calls, shapes = seen["K2 plan"]  # the bases of 8 x 1 tiles of 8 x 128
    assert calls == seen["K2"][0] == PYR.levels - 1
    assert [s[:2] for s in shapes] == [(8, 1)]


def test_paired_hierarchical_run_reports_the_plan():
    _paired_hierarchical("cpu")


@pytest.mark.cuda
def test_paired_hierarchical_run_reports_the_plan_on_card(cuda):
    _paired_hierarchical(cuda)


def test_paired_sharded_sgm_relay():
    """The sharded ``sgm-pallas`` exact path (K6, K7, the K10 relay, K9 and
    K4, K5, K3) through the checked table equals its run on ``FUSED``."""
    left, right = _pair(32, 64, 3, "cpu")
    cfg = MatchConfig(num_disparities=8, window=5, lr_threshold=1.0)
    mesh = make_mesh(tile=2, devices=["cpu"] * 2)

    def run(stages):
        return sgm_pallas_sharded.match_pair_sgm_pallas_sharded(
            left, right, cfg, SGMConfig(directions=4), mesh, stages=stages)

    seen = {}
    _assert_bits_equal(run(fused_refine.FUSED), run(drill.checked_stages("relay", seen)))
    assert set(seen) == {"K6", "K7", "K10", "K9", "K4", "K5", "K3"}
    assert seen["K10"][0] == 2 * 2  # ↓y and ↑y, one launch a shard
