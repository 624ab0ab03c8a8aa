"""Platform decisions (kernel choice, compile cache), the SWASA state pytree,
and the chip smoke script's refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hybridquantization import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization import runtime
from hybridquantization.swasa.state import (
    SWASAState,
    state_from_numpy,
    state_to_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "use_pallas,platform,want",
    [
        ("auto", "gpu", "triton"),
        ("on", "gpu", "triton"),
        ("off", "gpu", "xla"),
        ("auto", "cpu", "xla"),
        ("off", "cpu", "xla"),
        ("auto", "rocm", "xla"),
    ],
)
def test_assign_kernel_choice(use_pallas, platform, want):
    assert runtime.assign_kernel(use_pallas, 256, platform) == want


def test_assign_kernel_serves_any_k():
    for k in (1, 3, 16, 256, 1 << 20):
        assert runtime.assign_kernel("auto", k, "gpu") == "triton"
    with pytest.raises(ValueError, match="num_colors"):
        runtime.assign_kernel("auto", 0, "gpu")


def test_use_pallas_on_off_gpu_raises():
    """No silent fallback and no interpreter: "on" needs a GPU."""
    with pytest.raises(ValueError, match="needs a GPU"):
        runtime.assign_kernel("on", 16, "cpu")
    with pytest.raises(ValueError, match="needs a GPU"):
        HybridQuantizer(
            QuantizationConfig(swasa=SWASAConfig(num_colors=4), use_pallas="on")
        )
    with pytest.raises(ValueError, match="use_pallas"):
        runtime.assign_kernel("interpret", 16, "gpu")


def test_engine_takes_xla_on_cpu():
    assert jax.default_backend() == "cpu"
    assert HybridQuantizer(QuantizationConfig()).kernel == "xla"


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compilation_cache_dir() == str(tmp_path)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert runtime.enable_compilation_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing set in code


def test_cache_dir_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert runtime.compilation_cache_dir() == want
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert runtime.enable_compilation_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    assert os.path.isdir(want)


def test_cache_dir_listed_in_gitignore():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _state(rng):
    return SWASAState(
        colors=jnp.asarray(rng.random((2, 4, 3)), jnp.float32),
        current_errors=jnp.asarray([1.0, 2.0], jnp.float32),
        best_colors=jnp.asarray(rng.random((4, 3)), jnp.float32),
        best_error=jnp.float32(1.0),
        temperature=jnp.float32(20.0),
        iteration=jnp.int32(7),
        key=jax.random.PRNGKey(3),
    )


def test_state_flatten_unflatten(rng):
    st = _state(rng)
    leaves, treedef = jax.tree_util.tree_flatten(st)
    assert len(leaves) == 7
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, SWASAState)
    for a, b in zip(jax.tree_util.tree_leaves(st), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a pytree through jit, and the numpy checkpoint round trip
    out = jax.jit(lambda s: s)(st)
    assert out.population == 2 and out.num_colors == 4
    again = state_from_numpy(state_to_numpy(st))
    np.testing.assert_array_equal(np.asarray(again.colors), np.asarray(st.colors))
    assert int(again.iteration) == 7


def test_main_path_imports_without_flax():
    """The engine imports only jax, numpy, scipy, optax, chex and einops."""
    code = (
        "import sys, hybridquantization, hybridquantization.cli, "
        "hybridquantization.parallel;"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'flax', 'torch', 'triton', 'tensorflow'});"
        "assert not bad, bad"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120,
    )
    assert r.returncode == 0, r.stderr


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py refuses to run (non-zero exit, no result line) when
    there is no GPU."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
