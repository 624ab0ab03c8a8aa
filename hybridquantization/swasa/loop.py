"""The SWASA annealing main loop as an on-device `lax.scan`.

On-device redesign of the reference's host-side Java loop + OpenCL event DAG
(ImageManipulation.findBestQuantization, ImageManipulation.java:383-591, and
computeQuantizationErrorPopulation, :620-727):

  - The reference evaluates each population member through a 9-stage device
    pipeline with hand-chained events and reads the FULL per-pixel error
    image back to the host every evaluation (:667,:698) for a multithreaded
    CPU mean (:736-768). Here the population is a vmapped batch, the mean is
    an on-device reduction, and the entire iteration — proposal, fitness,
    Metropolis acceptance, best-tracking, population convergence — is one
    fused scan step. Only scalar telemetry ever reaches the host.
  - Iteration semantics match the reference loop exactly (ite = 1..imax,
    temperature reduced before proposing, acceptance per member, convergence
    overwrite with the round's best *proposal* — including the reference's
    quirk of copying the proposal rather than the accepted state,
    ImageManipulation.java:538-545).

The loop runs in host-visible chunks (`run_chunk`) so progress reporting,
cooperative cancellation, and checkpointing happen between chunks, mirroring
the reference's every-10-iterations progress hook (:546-567) without
breaking the scan.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..config import SWASAConfig
from . import schedule
from .state import SWASAState

# fitness: (K, 3) sRGB palette -> (scalar error, (K,) bool usage)
FitnessFn = Callable[[jax.Array], Tuple[jax.Array, jax.Array]]
# population fitness: (pop, K, 3) -> ((pop,) errors, (pop, K) usage)
PopFitnessFn = Callable[[jax.Array], Tuple[jax.Array, jax.Array]]


def as_population_fitness(fitness: FitnessFn) -> PopFitnessFn:
    """Lift a per-palette fitness to a population batch via vmap."""
    return jax.vmap(fitness)


def _pop_fitness(fitness) -> PopFitnessFn:
    """Accept either form: functions marked .is_population evaluate whole
    populations at once (e.g. the fused assignment kernel's population
    grid)."""
    if getattr(fitness, "is_population", False):
        return fitness
    return as_population_fitness(fitness)


def init_state(
    key: jax.Array, fitness, cfg: SWASAConfig, init_colors=None
) -> SWASAState:
    """Initial palettes + fitness eval (ImageManipulation.java:413-493).

    init_colors: optional (pop, K, 3) starting palettes (e.g. the
    histogram-weighted k-means seeds of ops/kmeans.py); defaults to the
    reference's uniform-random init (SWASA.java:40-52).
    """
    pop_fitness = _pop_fitness(fitness)
    key, sub = jax.random.split(key)
    if init_colors is not None:
        colors = jnp.asarray(init_colors, jnp.float32)
    else:
        pal_keys = jax.random.split(sub, cfg.population)
        colors = jax.vmap(
            lambda k: schedule.random_palette(k, cfg.num_colors)
        )(pal_keys)
    errors, _ = pop_fitness(colors)
    best = jnp.argmin(errors)
    return SWASAState(
        colors=colors,
        current_errors=errors,
        best_colors=colors[best],
        best_error=errors[best],
        temperature=jnp.float32(cfg.t0),
        iteration=jnp.int32(0),
        key=key,
    )


def make_step(fitness, cfg: SWASAConfig):
    """One annealing iteration as a scan-compatible step function."""

    pop_fitness = _pop_fitness(fitness)
    pop = cfg.population

    def step(state: SWASAState, ite: jax.Array):
        # Temperature schedule (applied before evaluation, like the
        # reference's reduceTemperatureIfNecessary at ImageManipulation.java:507).
        temperature = schedule.cool_temperature(
            state.temperature, ite, cfg.i_tc, cfg.alpha
        )

        key, k_prop, k_acc, k_conv = jax.random.split(state.key, 4)

        # Proposals for every member (ImageManipulation.java:508-511).
        proposals = schedule.propose(
            k_prop, state.colors, ite, cfg.s0, cfg.beta, cfg.imax
        )

        # Batched fitness (replaces the event-pipelined population loop,
        # ImageManipulation.java:620-727).
        errors, usage = pop_fitness(proposals)
        del usage  # the penalty is folded into `errors` by the fitness fn

        # Metropolis acceptance per member (ImageManipulation.java:516-537).
        accepted = schedule.accept(
            k_acc, errors - state.current_errors, temperature
        )
        current_errors = jnp.where(accepted, errors, state.current_errors)
        colors = jnp.where(accepted[:, None, None], proposals, state.colors)

        # Best tracking: sequential-scan-equivalent batched update.
        cand_errors = jnp.where(accepted, errors, jnp.inf)
        m = jnp.argmin(cand_errors)
        improved = cand_errors[m] < state.best_error
        best_error = jnp.where(improved, cand_errors[m], state.best_error)
        best_colors = jnp.where(improved, proposals[m], state.best_colors)

        # Population convergence (ImageManipulation.java:538-545): members
        # losing the keep-draw are overwritten with this round's best
        # *proposal* and its raw error — reference quirk preserved.
        if cfg.convergence and pop > 1:
            min_idx = jnp.argmin(errors)
            keep = schedule.keeps_values(
                k_conv, ite, cfg.conv_delay, cfg.conv_spread, cfg.imax, (pop,)
            )
            colors = jnp.where(keep[:, None, None], colors, proposals[min_idx])
            current_errors = jnp.where(keep, current_errors, errors[min_idx])

        new_state = SWASAState(
            colors=colors,
            current_errors=current_errors,
            best_colors=best_colors,
            best_error=best_error,
            temperature=temperature,
            iteration=ite,
            key=key,
        )
        telemetry = {
            "best_error": best_error,
            "mean_error": jnp.mean(errors),
            "min_error": jnp.min(errors),
            "std_error": jnp.std(errors),
        }
        return new_state, telemetry

    return step


def run_chunk(
    state: SWASAState,
    fitness,
    cfg: SWASAConfig,
    num_iters: int,
):
    """Scan `num_iters` iterations starting after state.iteration.

    Returns (new_state, telemetry dict of (num_iters,) arrays). Jit this with
    cfg/num_iters static; consecutive equal-sized chunks reuse the compile.
    """
    ites = state.iteration + 1 + jnp.arange(num_iters, dtype=jnp.int32)
    return jax.lax.scan(make_step(fitness, cfg), state, ites)
