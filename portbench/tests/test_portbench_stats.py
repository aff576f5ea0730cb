"""The end-to-end arithmetic over synthetic calls, and the reservoir."""

import pytest

from portbench import check, record, stats
from portbench.metrics import call_ms_p95, frames_per_s  # noqa: F401 (the readers)


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))  # 1..100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 50) == 50
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 100) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _run(call_s, chunk, window_s):
    calls = [{"call": s, "loader_wait": 0.001, "model_call": s / 2} for s in call_s]
    return record.Run(setup_s=12.5, window_s=window_s, chunk=chunk, calls=calls)


def test_rate_and_tail_over_a_call_list():
    # 200 calls of 8 frames: 190 at 100 ms, 10 slow ones at 300 ms
    call_s = [0.1] * 190 + [0.3] * 10
    run = _run(call_s, 8, sum(call_s))
    assert frames_per_s.read(run) == pytest.approx(1600 / 22.0)
    assert call_ms_p95.read(run) == pytest.approx(100.0)  # rank 190 of 200
    run = _run([0.1] * 189 + [0.3] * 11, 8, 1.0)
    assert call_ms_p95.read(run) == pytest.approx(300.0)
    assert run.mean_ms("loader_wait") == pytest.approx(1.0)
    assert _run([], 1, 1.0).mean_ms("model_call") is None


def test_reservoir_draws_from_the_seed_over_the_whole_stream():
    def draw(seed, n=1000, k=4):
        r = check.Reservoir(k, seed)
        for i in range(n):
            r.offer(i)
        return r.items

    assert draw(2 ** 31 + 5) == draw(2 ** 31 + 5)
    assert draw(1) != draw(2)
    assert len(draw(3, n=2)) == 2
    late = sum(max(draw(s)) >= 500 for s in range(50))
    assert late > 40  # not just the stream's first calls
