"""The port's tracing on its served path (``stepth_tpu_torch.utils.tracing``):
with no profiler recording a span is one shared no-op; under
``torch.profiler`` every served call gives each ``stepth/`` span as often as
its stage runs, on the kernel path and the plain one; the loader's counters
say which takes had to wait."""

import collections
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.core.loader import PrefetchLoader
from stepth_tpu_torch.match import fused_refine
from stepth_tpu_torch.models import StereoModel
from stepth_tpu_torch.utils import tracing

from tests.torch_port import one_torch_thread  # noqa: F401 (autouse fixture)

# the production matcher (README.md:306-311) at 96×256
PROD = dict(match=MatchConfig(num_disparities=128, window=9, cost="census", census_window=7,
                              lr_threshold=1.0),
            pyramid=PyramidConfig(levels=4, refine_radius=2, coarsest_disparities=16,
                                  refine_windows=16))
# each keyframe: K1's census at the coarsest level, then three refine levels
KEYFRAME = {"stepth/coarse": 1, "stepth/census": 4, "stepth/plan": 3, "stepth/refine": 3,
            "stepth/post": 1}


def _pair(h, w, shift, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift, 3)).astype(np.float32)
    return torch.from_numpy(base[:, shift:].copy()), torch.from_numpy(base[:, :w].copy())


def _spans(fn):
    """The ``stepth/`` spans ``fn()`` opens under ``torch.profiler``, by
    name."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events() if e.name.startswith("stepth/"))


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"), tracing.StageTimes().stage("b"):
        pass
    assert tracing.annotate("c")(lambda v: v + 1)(1) == 2


def test_annotate_is_gated_and_keeps_the_function():
    @tracing.annotate("stepth/test")
    def f(v):
        return v + 1

    assert f.__name__ == "f" and f(1) == 2
    assert _spans(lambda: f(torch.ones(2))) == {"stepth/test": 1}
    assert not torch._C._autograd._profiler_enabled()


def _model_call():
    left, right = _pair(96, 256, 24)
    StereoModel(backend="hierarchical-pallas", lr_check=True, **PROD)(left, right)


def _plain_pyramid():
    left, right = _pair(96, 256, 24)
    fused_refine.match_hierarchical_plain(left, right, PROD["match"], PROD["pyramid"],
                                          lr_check=True)


def _video():
    (l0, r0), (l1, r1) = _pair(96, 256, 24, 0), _pair(96, 256, 24, 1)
    model = StereoModel(backend="hierarchical-pallas", lr_check=True, **PROD)
    model.video(keyframe_interval=2)(torch.stack([l0, l1]), torch.stack([r0, r1]))


def _sgm(directions):
    def call():
        left, right = _pair(48, 96, 12)
        StereoModel(backend="sgm-pallas",
                    match=MatchConfig(num_disparities=64, window=5, cost="sad",
                                      lr_threshold=1.0),
                    sgm=SGMConfig(directions=directions))(left, right)

    return call


@pytest.mark.parametrize("fn,want", [
    (_model_call, {"stepth/call": 1, **KEYFRAME}),
    (_plain_pyramid, KEYFRAME),
    # a keyframe, then a seeded frame: its level-0 refine and the epilogue
    (_video, {"stepth/call": 1, "stepth/coarse": 1, "stepth/census": 5, "stepth/plan": 4,
              "stepth/refine": 4, "stepth/post": 2}),
    (_sgm(4), {"stepth/call": 1, "stepth/sgm/volume": 1, "stepth/sgm/scan": 3,
               "stepth/sgm/scan_wta": 1, "stepth/post": 1}),
    # two directions: every direction scanned, then K9's WTA with its K4
    (_sgm(2), {"stepth/call": 1, "stepth/sgm/volume": 1, "stepth/sgm/scan": 2,
               "stepth/sgm/wta": 1, "stepth/post": 1}),
], ids=["call", "plain", "video", "sgm4", "sgm2"])
def test_served_calls_open_each_span(fn, want):
    assert _spans(fn) == want


def _delta(before):
    now = tracing.counters()
    return {k: now[k] - before.get(k, 0) for k in now if now[k] != before.get(k, 0)}


def test_loader_counts_a_starved_take_for_every_blocked_item():
    """Each item is made only once the consumer has found it missing, so
    every take waits."""
    n = 5
    gates = [threading.Event() for _ in range(n)]
    before = tracing.counters()

    def opener():  # opens item i's gate once the consumer counted its wait
        for i in range(n):
            deadline = time.monotonic() + 30
            while _delta(before).get("loader.starved", 0) <= i and time.monotonic() < deadline:
                time.sleep(0.001)
            gates[i].set()

    t = threading.Thread(target=opener, daemon=True)
    t.start()
    out = list(PrefetchLoader(range(n), lambda i: gates[i].wait(30) and i, num_threads=2,
                              buffer=n))
    t.join(timeout=30)
    assert not t.is_alive() and out == list(range(n))
    assert _delta(before) == {"loader.takes": n, "loader.starved": n}


def test_loader_counts_no_starved_take_from_a_filled_buffer():
    """One worker makes items in order, so once it has started on item 6,
    items 1-5 are in the buffer; taking them waits for nothing."""
    started, release = threading.Event(), threading.Event()

    def fn(i):
        if i == 6:
            started.set()
            release.wait(30)
        return i

    it = iter(PrefetchLoader(range(7), fn, num_threads=1, buffer=6))
    try:
        assert next(it) == 0
        assert started.wait(30)
        before = tracing.counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert [next(it) for _ in range(5)] == [1, 2, 3, 4, 5]
        assert _delta(before) == {"loader.takes": 5}
        takes = [e for e in prof.events() if e.name == "stepth/loader/take"]
        assert len(takes) == 5
    finally:
        release.set()
        it.close()


def test_counters_snapshot_and_reset(monkeypatch):
    monkeypatch.setattr(tracing, "_counters", collections.defaultdict(int))
    tracing.count("a")
    tracing.count("a", 2)
    snap = tracing.counters()
    tracing.count("b")
    assert snap == {"a": 3} and tracing.counters() == {"a": 3, "b": 1}
    tracing.reset_counters()
    assert tracing.counters() == {}
