"""SWASA schedule math vs the reference's scalar formulas, and loop semantics."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hybridquantization.config import SWASAConfig
from hybridquantization.swasa import loop, schedule
from hybridquantization.swasa.state import (
    state_from_numpy,
    state_to_numpy,
)


def test_max_step_width():
    # s(i) = 2*s0/(1+exp(beta*i/imax)) (SWASA.java:69-72)
    s0, beta, imax = 100.0, 5.3, 5000
    for i in [0, 1, 100, 2500, 5000]:
        want = 2 * s0 / (1 + math.exp(beta * i / imax))
        got = float(schedule.max_step_width(i, s0, beta, imax))
        assert got == pytest.approx(want, rel=1e-5)
    assert float(schedule.max_step_width(0, s0, beta, imax)) == pytest.approx(s0)


def test_cooling():
    t = jnp.float32(20.0)
    assert float(schedule.cool_temperature(t, 19, 20, 0.9)) == pytest.approx(20.0)
    assert float(schedule.cool_temperature(t, 20, 20, 0.9)) == pytest.approx(18.0)
    assert float(schedule.cool_temperature(t, 40, 20, 0.9)) == pytest.approx(18.0)


def test_keep_probability():
    # -(tanh((i - d*imax)/(r*imax)))/2 + 0.5 (SWASA.java:59-62)
    d, r, imax = 0.75, 0.15, 5000
    for i in [0, 1875, 3750, 5000]:
        want = -math.tanh((i - d * imax) / (r * imax)) / 2 + 0.5
        assert float(schedule.keep_probability(i, d, r, imax)) == pytest.approx(
            want, rel=1e-5
        )
    # early iterations: keep ~1; late: keep ~ small
    assert float(schedule.keep_probability(0, d, r, imax)) > 0.99
    assert float(schedule.keep_probability(imax, d, r, imax)) < 0.2


def test_accept_negative_always():
    key = jax.random.PRNGKey(0)
    de = jnp.array([-1.0, 0.0, -1e-8])
    assert bool(schedule.accept(key, de, jnp.float32(1e-9)).all())


def test_accept_rate_matches_boltzmann():
    key = jax.random.PRNGKey(42)
    de, T = 2.0, 4.0
    n = 20000
    keys = jax.random.split(key, n)
    acc = jax.vmap(lambda k: schedule.accept(k, jnp.float32(de), jnp.float32(T)))(keys)
    rate = float(jnp.mean(acc))
    assert rate == pytest.approx(math.exp(-de / T), abs=0.02)


def test_propose_bounds_and_scale():
    key = jax.random.PRNGKey(7)
    colors = jnp.full((2, 8, 3), 0.5)
    out = schedule.propose(key, colors, 0, 100.0, 5.3, 5000)
    step = 100.0 / 256.0
    assert float(jnp.max(jnp.abs(out - colors))) <= step + 1e-6
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    # clamping at the boundary
    out = schedule.propose(key, jnp.zeros((1, 4, 3)), 0, 256.0, 5.3, 5000)
    assert float(out.min()) >= 0.0


def test_unused_penalty():
    usage = jnp.array([True, False, False, True])
    assert float(schedule.unused_penalty(usage, 2.0)) == 4.0


def _toy_fitness(target):
    """Fitness = mean squared distance of palette to a fixed target palette."""

    def fitness(palette):
        err = jnp.mean(jnp.sum((palette - target) ** 2, axis=-1))
        return err, jnp.ones((palette.shape[0],), bool)

    return fitness


def _toy_cfg(**kw):
    base = dict(
        num_colors=4, population=3, imax=200, delta=0.0, t0=0.5, i_tc=10,
        alpha=0.8, s0=100.0, beta=5.3,
    )
    base.update(kw)
    return SWASAConfig(**base)


def test_loop_optimizes_toy_problem():
    cfg = _toy_cfg()
    target = jnp.tile(jnp.array([[0.25, 0.5, 0.75]]), (cfg.num_colors, 1))
    fitness = _toy_fitness(target)
    key = jax.random.PRNGKey(3)
    state = loop.init_state(key, fitness, cfg)
    init_err = float(state.best_error)
    state, telem = loop.run_chunk(state, fitness, cfg, cfg.imax)
    # best error never increases and the anneal makes real progress
    be = np.asarray(telem["best_error"])
    assert (np.diff(be) <= 1e-7).all()
    assert float(state.best_error) < init_err * 0.2
    assert int(state.iteration) == cfg.imax


def test_loop_deterministic():
    cfg = _toy_cfg(imax=50)
    target = jnp.zeros((cfg.num_colors, 3)) + 0.3
    fitness = _toy_fitness(target)
    outs = []
    for _ in range(2):
        state = loop.init_state(jax.random.PRNGKey(9), fitness, cfg)
        state, _ = loop.run_chunk(state, fitness, cfg, 50)
        outs.append(np.asarray(state.best_colors))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_chunked_equals_single_scan():
    cfg = _toy_cfg(imax=40)
    target = jnp.zeros((cfg.num_colors, 3)) + 0.6
    fitness = _toy_fitness(target)
    s1 = loop.init_state(jax.random.PRNGKey(1), fitness, cfg)
    s2 = s1
    s1, _ = loop.run_chunk(s1, fitness, cfg, 40)
    for _ in range(4):
        s2, _ = loop.run_chunk(s2, fitness, cfg, 10)
    np.testing.assert_allclose(
        np.asarray(s1.best_colors), np.asarray(s2.best_colors), rtol=1e-6
    )
    assert float(s1.best_error) == pytest.approx(float(s2.best_error), rel=1e-6)
    assert float(s1.temperature) == pytest.approx(float(s2.temperature), rel=1e-6)


def test_population_one_and_no_convergence():
    for cfg in [_toy_cfg(population=1, imax=30), _toy_cfg(convergence=False, imax=30)]:
        target = jnp.zeros((cfg.num_colors, 3)) + 0.4
        fitness = _toy_fitness(target)
        state = loop.init_state(jax.random.PRNGKey(5), fitness, cfg)
        state, _ = loop.run_chunk(state, fitness, cfg, 30)
        assert np.isfinite(float(state.best_error))


def test_state_serialization_round_trip():
    cfg = _toy_cfg(imax=10)
    fitness = _toy_fitness(jnp.zeros((cfg.num_colors, 3)))
    state = loop.init_state(jax.random.PRNGKey(11), fitness, cfg)
    state, _ = loop.run_chunk(state, fitness, cfg, 10)
    d = state_to_numpy(state)
    restored = state_from_numpy(d)
    # resuming from the restored state is bit-identical
    a, _ = loop.run_chunk(state, fitness, cfg, 5)
    b, _ = loop.run_chunk(restored, fitness, cfg, 5)
    np.testing.assert_array_equal(np.asarray(a.best_colors), np.asarray(b.best_colors))
    np.testing.assert_array_equal(
        np.asarray(a.current_errors), np.asarray(b.current_errors)
    )
