"""The frozen reference equals the program's plain paths, bit for bit, at
small sizes on the CPU (the tests may import the program; the reference
may not)."""

import ast
import json

import numpy as np
import pytest
import torch

from portbench import run, traffic
from portbench.reference import common, hierarchical, sgm
from stepth_tpu_torch.config import from_dict
from stepth_tpu_torch.match import dense, fused_refine, fused_sgm, pyramid
from stepth_tpu_torch.models.stereo import StereoModel

CONFIGS = {n: json.loads((run.HERE / "configs" / f"{n}.json").read_text())
           for n in ("hd1080-production", "kitti2015-sgm")}


def frames(name, cell, seed, n):
    cfg = CONFIGS[name]
    lefts, rights = traffic.make_pool(traffic.load(cell), cfg["rehearsal_shape"], seed)
    return (torch.as_tensor(lefts[:n]).to(torch.float32),
            torch.as_tensor(rights[:n]).to(torch.float32))


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def test_reference_imports_nothing_of_the_program():
    for path in (run.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "portbench", "__future__",
                                           "typing"), (path.name, n)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_pieces_equal_the_programs(seed):
    ls, rs = frames("hd1080-production", "hd1080-prod-keyframe", seed, 1)
    lg, rg = common.grayscale(ls[0]), common.grayscale(rs[0])
    assert same(lg, dense.grayscale(ls[0]))
    assert same(common.census_pair(lg, rg, 7)[0], dense.census_pair(lg, rg, 7)[0])
    assert same(hierarchical.downsample2(lg), pyramid.downsample2(lg))
    prior = torch.rand(lg.shape, generator=torch.Generator().manual_seed(seed)) * 60
    prior = pyramid.upsample2_disparity(hierarchical.downsample2(prior), *lg.shape)
    assert same(hierarchical.upsample2_disparity(hierarchical.downsample2(prior), *lg.shape),
                pyramid.upsample2_disparity(pyramid.downsample2(prior), *lg.shape))
    bases, nw = hierarchical.plan(prior, 128, 2, 16)
    want_b, want_nw, _ = fused_refine.plan_level(prior, 64, 128, 2, 16)
    assert same(bases, want_b) and same(nw, want_nw)
    match = CONFIGS["hd1080-production"]["model"]["match"]
    cfg = from_dict(StereoModel, CONFIGS["hd1080-production"]["model"]).match
    got = hierarchical.refine(lg, rg, bases, nw, match, 2, True, lambda x: x)
    want = fused_refine.refine_planned_plain(lg, rg, want_b, want_nw, cfg, 2, 64, lr=True)
    assert same(got[0], want[0]) and same(got[1], want[1])


@pytest.mark.parametrize("cell", ["hd1080-prod-keyframe", "hd1080-prod-seeded"])
def test_hierarchical_calls_equal_the_programs_plain_path(cell):
    t = traffic.load(cell)
    ls, rs = frames("hd1080-production", cell, 11, t["chunk"])
    model_cfg = CONFIGS["hd1080-production"]["model"]
    model = from_dict(StereoModel, model_cfg)
    outs = hierarchical.run_call(ls, rs, model_cfg, t)
    if t["entry"] == "video":
        want = fused_refine.match_temporal_plain(
            ls, rs, model.match, model.pyramid, keyframe_interval=t["keyframe_interval"],
            lr_check=True)
        want = [(want.disparity[i], want.valid[i]) for i in range(t["chunk"])]
    else:
        w = fused_refine.match_hierarchical_plain(ls[0], rs[0], model.match, model.pyramid,
                                                  lr_check=True)
        want = [(w.disparity, w.valid)]
    for (d, v), (wd, wv) in zip(outs, want):
        assert same(d, wd) and same(v, wv)


def test_sgm_frames_equal_the_programs_plain_path():
    t = traffic.load("kitti2015-sgm")
    ls, rs = frames("kitti2015-sgm", "kitti2015-sgm", 5, 2)
    model_cfg = CONFIGS["kitti2015-sgm"]["model"]
    model = from_dict(StereoModel, model_cfg)
    for (d, v), i in zip(sgm.run_call(ls, rs, model_cfg, t), range(2)):
        w = fused_sgm.match_pair_sgm_plain(ls[i], rs[i], model.match, model.sgm)
        assert same(d, w.disparity) and same(v, w.valid)


def test_records_count_the_kernel_path_launches():
    t = traffic.load("hd1080-prod-seeded")
    ls, rs = frames("hd1080-production", "hd1080-prod-seeded", 3, 8)
    rec = []
    hierarchical.run_call(ls, rs, CONFIGS["hd1080-production"]["model"], t, record=rec)
    kinds = [[launch["kernel"] for launch in frame] for frame in rec]
    post = ["lr_check_kernel", "fill_invalid_kernel", "median3_kernel"]
    assert kinds[0] == (["fused_dense_kernel"] + ["fused_refine_kernel"] * 3
                        + ["refine_emit_r_kernel"] + post)
    assert kinds[1] == ["fused_refine_kernel", "refine_emit_r_kernel"] + post
    rec = []
    ls, rs = frames("kitti2015-sgm", "kitti2015-sgm", 3, 1)
    sgm.run_call(ls, rs, CONFIGS["kitti2015-sgm"]["model"], {}, record=rec)
    assert [launch["kernel"] for launch in rec[0]] == (
        ["sgm_volume_kernel"] + ["sgm_scan_kernel"] * 3 + ["sgm_scan_wta_kernel"] + post)
