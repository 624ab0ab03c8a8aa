"""Annealing state pytree.

The reference kept this state in scattered host variables
(ImageManipulation.java:389-493: colors/currentColors/bestColors/
currentErrors/bestError plus SWASA.temperature); here it is a single
serializable device pytree so the whole loop runs under `lax.scan` and can be
checkpointed/resumed (the reference had no checkpointing — SURVEY.md
section 5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SWASAState:
    """Carry of the annealing scan.

    colors:         (pop, K, 3) accepted palettes, sRGB in [0, 1]
    current_errors: (pop,) fitness of the accepted palettes
    best_colors:    (K, 3) best palette seen so far
    best_error:     () best fitness seen so far
    temperature:    () current annealing temperature
    iteration:      () int32, iterations completed (0 = only initial eval)
    key:            PRNG key for all subsequent draws
    """

    colors: jax.Array
    current_errors: jax.Array
    best_colors: jax.Array
    best_error: jax.Array
    temperature: jax.Array
    iteration: jax.Array
    key: jax.Array

    @property
    def population(self) -> int:
        return self.colors.shape[0]

    @property
    def num_colors(self) -> int:
        return self.colors.shape[1]


def state_to_numpy(state: SWASAState) -> dict:
    """Flatten to a dict of host arrays (for npz checkpoints)."""
    return {
        "colors": jax.device_get(state.colors),
        "current_errors": jax.device_get(state.current_errors),
        "best_colors": jax.device_get(state.best_colors),
        "best_error": jax.device_get(state.best_error),
        "temperature": jax.device_get(state.temperature),
        "iteration": jax.device_get(state.iteration),
        "key": jax.device_get(jax.random.key_data(state.key)),
    }


def state_from_numpy(d: dict) -> SWASAState:
    return SWASAState(
        colors=jnp.asarray(d["colors"]),
        current_errors=jnp.asarray(d["current_errors"]),
        best_colors=jnp.asarray(d["best_colors"]),
        best_error=jnp.asarray(d["best_error"]),
        temperature=jnp.asarray(d["temperature"]),
        iteration=jnp.asarray(d["iteration"]),
        key=jax.random.wrap_key_data(jnp.asarray(d["key"])),
    )
