"""The port's configs and StereoModel fields equal the reference's, and
``from_dict(asdict(reference_config))`` rebuilds the same config."""

import dataclasses

import pytest

from stepth_tpu import config as ref_config
from stepth_tpu.match import sgm as ref_sgm
from stepth_tpu.models import stereo as ref_stereo
from stepth_tpu_torch import config
from stepth_tpu_torch.models import stereo

from tests.torch_port import one_torch_thread  # noqa: F401 (autouse fixture)

PAIRS = [
    (ref_config.SubdivisionConfig, config.SubdivisionConfig),
    (ref_config.RingSearchConfig, config.RingSearchConfig),
    (ref_config.MeshConfig, config.MeshConfig),
    (ref_config.MatchConfig, config.MatchConfig),
    (ref_config.PyramidConfig, config.PyramidConfig),
    (ref_sgm.SGMConfig, config.SGMConfig),
    (ref_stereo.StereoModel, stereo.StereoModel),
]


@pytest.mark.parametrize("ref_cls, cls", PAIRS, ids=lambda c: c.__name__)
def test_fields_and_defaults_equal(ref_cls, cls):
    names = [f.name for f in dataclasses.fields(cls)]
    assert names == [f.name for f in dataclasses.fields(ref_cls)]
    # defaults compare as dicts (nested configs are instances of two classes)
    assert dataclasses.asdict(cls()) == dataclasses.asdict(ref_cls())
    assert cls.__dataclass_params__.frozen and ref_cls.__dataclass_params__.frozen


@pytest.mark.parametrize(
    "ref",
    [
        ref_config.SubdivisionConfig(min_splits=10, max_splits=18),
        ref_config.RingSearchConfig(max_radius=40),
        ref_config.MeshConfig(data=2, tile=4, axis_names=("batch", "rows")),
        ref_config.MatchConfig(num_disparities=128, cost="ssd", uniqueness=0.1,
                               lr_threshold=None),
        ref_config.PyramidConfig(levels=3, coarsest_disparities=8, refine_radius=4,
                                 refine_radius_final=2, refine_windows_final=6),
        ref_sgm.SGMConfig(p1=2.0, p2=8.0, directions=8, volume_dtype="bf16"),
        ref_stereo.StereoModel(
            backend="hierarchical-pallas",
            match=ref_config.MatchConfig(num_disparities=128, window=9, cost="sad"),
            pyramid=ref_config.PyramidConfig(levels=4, coarsest_disparities=16),
            lr_check=True,
        ),
    ],
    ids=lambda r: type(r).__name__,
)
def test_from_dict_round_trips(ref):
    cls = dict((a.__name__, b) for a, b in PAIRS)[type(ref).__name__]
    got = config.from_dict(cls, dataclasses.asdict(ref))
    assert isinstance(got, cls)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if isinstance(ref, ref_config.SubdivisionConfig):
        assert got.resolved_max(400, 600) == ref.resolved_max(400, 600)
        assert config.SubdivisionConfig().resolved_max(400, 600) == \
            ref_config.SubdivisionConfig().resolved_max(400, 600)
    if isinstance(ref, ref_config.PyramidConfig):
        assert (got.final_radius, got.final_windows) == (ref.final_radius, ref.final_windows)
    if isinstance(ref, ref_stereo.StereoModel):
        assert isinstance(got.match, config.MatchConfig)
        assert isinstance(got.pyramid, config.PyramidConfig)


def test_pyramid_final_level_defaults_inherit():
    ref = ref_config.PyramidConfig()
    got = config.PyramidConfig()
    assert (got.final_radius, got.final_windows) == (ref.final_radius, ref.final_windows)
    assert (got.final_radius, got.final_windows) == (2, 16)
    assert config.DEFAULT_PRECISION == ref_config.DEFAULT_PRECISION


def test_from_dict_rejects_unknown_field():
    with pytest.raises(ValueError, match="unknown fields"):
        config.from_dict(config.MatchConfig, {"num_disparities": 8, "bogus": 1})
