"""The port's ``utils`` (``metrics``, ``debug``, ``tracing``,
``checkpoint``) against the JAX package's.

Metrics return equal floats on the same values, from arrays and from
tensors. ``debug.checked`` raises ``FloatingPointError`` naming the output
leaf that holds NaN/inf, where the reference's ``checkify`` raises its own
error. The checkpoint's ``.npz`` layout is the reference's: each package
restores the other's file."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stepth_tpu.utils import checkpoint as ref_checkpoint
from stepth_tpu.utils import debug as ref_debug
from stepth_tpu.utils import metrics as ref_metrics
from stepth_tpu_torch.fusion.ba import BAState
from stepth_tpu_torch.utils import checkpoint, debug, metrics, tracing

from tests.torch_port import one_torch_thread  # noqa: F401 (autouse fixture)


def _metric_inputs(rng):
    disp = rng.uniform(0, 40, (24, 32)).astype(np.float32)
    gt = disp + rng.normal(0, 2.0, disp.shape).astype(np.float32)
    valid = rng.uniform(size=disp.shape) < 0.7
    a = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-3, 4, a.shape), 0, 255).astype(np.uint8)
    pa = rng.normal(size=(7, 6)).astype(np.float32)
    pb = pa + rng.normal(0, 0.1, pa.shape).astype(np.float32)
    mask = np.where(rng.uniform(size=(24, 32)) < 0.4, 255, 0).astype(np.uint8)
    return disp, gt, valid, a, b, pa, pb, mask


@pytest.mark.parametrize("as_tensor", [False, True])
def test_metrics_equal_floats(rng, as_tensor):
    disp, gt, valid, a, b, pa, pb, mask = _metric_inputs(rng)
    conv = torch.from_numpy if as_tensor else (lambda x: x)
    cases = [
        ("end_point_error", (disp, gt)),
        ("end_point_error", (disp, gt, valid)),
        ("end_point_error", (disp, gt, np.zeros_like(valid))),
        ("depth_agreement", (a, b)),
        ("depth_agreement", (a, a)),
        ("ate_rmse", (pa, pb)),
        ("masked_fraction", (mask,)),
    ]
    for name, args in cases:
        want = getattr(ref_metrics, name)(*args)
        got = getattr(metrics, name)(*(conv(x) for x in args))
        assert type(got) is type(want)
        if isinstance(want, dict):
            assert got.keys() == want.keys()
            for k in want:
                assert type(got[k]) is type(want[k])
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got == want, name


def test_metrics_reference_cases():
    """The reference's own cases (tests/test_utils_temporal.py:57-78)."""
    gt = np.full((4, 4), 5.0)
    est = gt.copy()
    est[0, 0] = 9.0
    m = metrics.end_point_error(torch.from_numpy(est), torch.from_numpy(gt))
    assert m["bad3"] == pytest.approx(1 / 16) and m["epe"] == pytest.approx(4.0 / 16)
    z = np.zeros((3, 3), np.uint8)
    assert metrics.depth_agreement(z, z) == {"exact": 1.0, "mean_abs": 0.0, "max_abs": 0}
    a = np.zeros((3, 6), np.float32)
    b = a.copy()
    b[:, 3] = 2.0
    assert metrics.ate_rmse(a, b) == pytest.approx(2.0)


def test_checked_names_the_leaf():
    def f(x):
        return {"ok": x + 1, "log": torch.log(x)}, [torch.arange(3)]

    g = debug.checked(f)
    out = g(torch.tensor([1.0, 2.0]))
    np.testing.assert_allclose(out[0]["log"].numpy(), np.log([1.0, 2.0]), rtol=1e-6)
    with pytest.raises(FloatingPointError, match=r"output\[0\]\['log'\] holds 1 NaN"):
        g(torch.tensor([-1.0, 2.0]))
    with pytest.raises(FloatingPointError, match="poses"):
        debug.checked(lambda: BAState(torch.tensor([np.inf]), torch.zeros(2),
                                      torch.zeros(()), torch.zeros(())))()
    # the reference raises on the same input, through checkify
    from jax.experimental import checkify

    with pytest.raises(checkify.JaxRuntimeError):
        ref_debug.checked(lambda x: jnp.log(x))(jnp.asarray([-1.0]))


def test_assert_finite():
    for tree in ({"a": np.ones(3)}, {"a": torch.ones(3), "b": (torch.arange(4), None)}):
        debug.assert_finite(tree)
    for bad in ({"a": np.array([1.0, np.nan])}, [torch.ones(2), torch.tensor([-np.inf])]):
        with pytest.raises(AssertionError):
            debug.assert_finite(bad)
        with pytest.raises(AssertionError):
            ref_debug.assert_finite(jnp.asarray(np.asarray(bad["a"] if isinstance(bad, dict)
                                                           else bad[1])))


def test_stage_times_and_annotate():
    st = tracing.StageTimes()
    x = torch.ones(4)
    for _ in range(2):
        with st.stage("a", block_on={"x": x}):
            x = x + 1
    out = {}
    with st.stage("b", block_on=out):  # read when the stage ends
        out["x"] = x + 1
    s = st.summary()
    assert list(s) == ["a", "b"] and s["a"]["count"] == 2 and s["a"]["total_s"] >= 0
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 2)

    @tracing.annotate("x")
    def f(v):
        return v + 1

    assert f(1) == 2 and f.__name__ == "f"


def test_device_trace_writes_chrome_trace(tmp_path):
    with tracing.device_trace(None) as prof:
        assert prof is None
    with tracing.device_trace(str(tmp_path / "tr")) as prof:
        with tracing.StageTimes().stage("span"):
            torch.ones(8).sum()
    assert prof is not None
    with open(tmp_path / "tr" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "span" in names


def test_checkpoint_layout_is_the_references(tmp_path):
    """Leaves in jax.tree order (dict keys sorted), metadata as JSON bytes;
    each package restores the other's file."""
    state = {"poses": torch.arange(12, dtype=torch.float32).reshape(2, 6),
             "cost": torch.tensor(0.5), "lm": np.float32(2.0)}
    p = str(tmp_path / "port.npz")
    checkpoint.save(p, state, metadata={"round": 1})
    like_np = {k: np.asarray(v) for k, v in state.items()}
    back = ref_checkpoint.restore(p, like=like_np)
    for k in state:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(state[k]))
    assert ref_checkpoint.metadata(p) == {"round": 1} == checkpoint.metadata(p)

    q = str(tmp_path / "ref.npz")
    ref_checkpoint.save(q, {k: jnp.asarray(v) for k, v in like_np.items()},
                        metadata={"iter": 3})
    got = checkpoint.restore(q, like=state)
    assert isinstance(got["poses"], torch.Tensor) and isinstance(got["lm"], np.ndarray)
    for k in state:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(state[k]))
    assert checkpoint.metadata(q) == {"iter": 3}


def test_checkpoint_namedtuple_suffix_and_corruption(tmp_path):
    st = BAState(torch.ones(3, 6), torch.zeros(5, 3), torch.tensor(0.25), torch.tensor(1e-3))
    p = str(tmp_path / "state")  # no suffix: .npz is appended
    checkpoint.save(p, st)
    assert sorted(os.listdir(tmp_path)) == ["state.npz"]
    back = checkpoint.restore(p, like=st)
    assert isinstance(back, BAState)
    for a, b in zip(back, st):
        assert torch.equal(a, b)
    assert checkpoint.metadata(p) is None  # saved without metadata
    with pytest.raises(ValueError, match="like"):
        checkpoint.restore(p, like=None)
    with open(p + ".npz", "r+b") as f:
        f.truncate(40)
    assert checkpoint.metadata(p) is None
    assert checkpoint.metadata(str(tmp_path / "absent.npz")) is None
