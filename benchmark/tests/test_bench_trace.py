"""The reduction of a traced step to busy and idle time, launches and the
breakdown, on a made-up timeline (the profiler itself runs only on the
card)."""
import pytest

from benchmark.trace import TracedStep, busy_us, idle_gaps, summary


def step():
    dev = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("splat_fwd_kernel",
                                                    50.0, 60.0),
           ("memcpy", 90.0, 95.0)]
    host = [("aten::mm", 0.0, 12.0), ("aten::nonzero", 30.0, 50.0),
            ("outer", 25.0, 100.0)]
    return TracedStep((0.0, 100.0), dev, host)


def test_busy_is_the_union_of_activities():
    assert busy_us([(10, 20), (15, 30), (50, 60)]) == 30.0
    assert busy_us([]) == 0.0


def test_gaps_are_named_by_the_innermost_host_op():
    gaps = {}
    for sec, name in idle_gaps(step()):
        gaps[name] = gaps.get(name, 0.0) + sec
    assert gaps["aten::nonzero"] == pytest.approx(20e-6)   # 30-50 us
    assert gaps["aten::mm"] == pytest.approx(10e-6)        # 0-10 us
    assert gaps["outer"] == pytest.approx(35e-6)           # 60-90, 95-100
    no_host = TracedStep((0.0, 10.0), [("k", 0.0, 4.0)], [])
    assert idle_gaps(no_host) == [(pytest.approx(6e-6), "(python)")]


def test_summary():
    s = summary([step(), step()], step())
    assert s["busy_s"] == pytest.approx(2 * 35e-6)
    assert s["window_s"] == pytest.approx(2 * 100e-6)
    assert s["activities"] == 8
    assert s["splat_device_s"] == pytest.approx(2 * 10e-6)
    assert s["device_ops"][0][0] in ("k2", "k1", "splat_fwd_kernel")
    assert len(s["idle_gaps"]) <= 10
