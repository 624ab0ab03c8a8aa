"""metrics module: stage timers, throughput counters, profiler hooks."""

import jax.numpy as jnp

from hybridquantization import metrics


def test_stage_timer(capsys):
    t = metrics.StageTimer(verbose=True)
    with t.stage("scielab"):
        pass
    with t.stage("scielab"):
        pass
    with t.stage("optimization"):
        pass
    out = capsys.readouterr().out
    # addPerfLabel-style "name : Nms" lines (HybridQuantization.java:259-263)
    assert out.count("scielab :") == 2
    assert "optimization :" in out
    assert set(t.stages) == {"scielab", "optimization"}
    assert all(v >= 0.0 for v in t.stages.values())
    assert t.total() >= 0.0


def test_throughput_counters():
    tp = metrics.Throughput()
    assert tp.mpix_per_s == 0.0 and tp.iters_per_s == 0.0  # no div-by-zero
    tp.add(pixels=2_000_000, iterations=4, seconds=2.0)
    assert tp.mpix_per_s == 1.0
    assert tp.iters_per_s == 2.0


def test_profiler_trace_noop_and_capture(tmp_path):
    with metrics.profiler_trace(None):
        pass  # no-op path
    with metrics.profiler_trace(str(tmp_path / "trace")):
        metrics.block_until_ready(jnp.ones((8,)) * 2)
    assert any((tmp_path / "trace").rglob("*"))  # trace files written


def test_timeit():
    t = metrics.timeit(lambda x: x + 1, jnp.ones((16,)), warmup=1, iters=3)
    assert t >= 0.0
