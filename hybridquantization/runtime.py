"""Platform decisions in one place: the assignment kernel and the compile cache."""

from __future__ import annotations

import os

import jax

USE_PALLAS_MODES = ("auto", "on", "off")

# Fixed path inside the checkout (listed in .gitignore): the path is part of
# the cache key, so it must not move between runs.
_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def assign_kernel(use_pallas: str, num_colors: int, platform: str | None = None) -> str:
    """Which nearest-palette implementation the single-image path runs.

    Returns "triton" (the fused Pallas kernel, ops.triton_assign) or "xla"
    (ops.assign.nearest_palette + palette_usage + gather).

    use_pallas: "auto" takes the kernel on a GPU and XLA elsewhere; "on"
    requires the kernel and raises off a GPU (the kernel is never run in
    interpret mode outside tests); "off" always takes XLA. The kernel loops
    over the palette in chunks, so it serves every K >= 1.
    """
    if use_pallas not in USE_PALLAS_MODES:
        raise ValueError(
            f"use_pallas must be one of {USE_PALLAS_MODES}, got {use_pallas!r}"
        )
    if num_colors < 1:
        raise ValueError(f"num_colors must be >= 1, got {num_colors}")
    if use_pallas == "off":
        return "xla"
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if use_pallas == "on":
        raise ValueError(
            f"use_pallas='on' needs a GPU (the assignment kernel is compiled "
            f"by Triton); this process runs on {platform!r}"
        )
    return "xla"


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache/` in the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Persistent XLA compile cache: repeat runs skip recompilation.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already reads it; nothing
    else is set in code. Returns the directory in use.
    """
    cache_dir = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
