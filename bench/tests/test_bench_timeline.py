"""The end-to-end arithmetic over a synthetic timeline that holds a stall."""
import pytest

from bench.harness.timeline import RequestTimes, end_to_end, percentile


def test_metrics_over_a_stall():
    reqs = [
        RequestTimes(0.0, [0.1, 0.2, 0.3, 1.3, 1.4]),  # a 1 s stall between its third and fourth tokens
        RequestTimes(0.5, [1.3, 1.4]),  # sent during the stall: waits it out
        RequestTimes(1.9, [2.5, 2.6]),  # first token after the window: no TTFT, no tokens
        RequestTimes(-1.0, [-0.5, 0.05]),  # first token before the window: its gap ending inside counts
    ]
    m = end_to_end(reqs, 0.0, 2.0)
    assert m["ttft_samples"] == 2
    assert m["ttft_p95_ms"] == pytest.approx(1e3 * (0.1 + 0.95 * 0.7))
    assert m["ttft_p50_ms"] == pytest.approx(1e3 * 0.45)
    # gaps whose later token lands in the window: 0.55, 0.1, 0.1, 1.0, 0.1 and 0.1
    assert m["itl_samples"] == 6
    assert m["itl_p95_ms"] == pytest.approx(1e3 * percentile([0.55, 0.1, 0.1, 1.0, 0.1, 0.1], 95))
    assert m["itl_p95_ms"] == pytest.approx(1e3 * (0.55 + 0.75 * 0.45))
    assert m["decode_tok_s"] == pytest.approx(8 / 2.0)


def test_percentile_is_linear_between_order_statistics():
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert percentile([1.0], 95) == 1.0
    with pytest.raises(ValueError):
        percentile([], 50)
