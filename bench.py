"""Benchmark harness — prints ONE JSON line with the primary metric.

Primary metric: END-TO-END seconds to quantize a 4K (3840x2160) image to
K=256 on one GPU at reference-or-better quality, against the BASELINE
north star "<= 10 s" (the reference itself publishes no numbers;
BASELINE.json "published": {}). vs_baseline = 10 s / measured e2e seconds
of the SAME quantity. The quantized image's mean S-CIELAB Delta-E is
measured in the same run and reported next to it — the speed claim is only
valid with the quality number beside it.

Quality-matched schedule: k-means seeding + 50 SWASA iterations + 10
histogram-Lloyd polish steps, default precision. The reference's
random-init imax=5000 anneal reaches mean Delta-E 5.66 on uniform 4K/K=256
content; the per-run number is in extra.e2e_mean_delta_e.

Context metrics (assignment Mpix/s of the engine's chosen assignment,
fitness eval, SWASA iters/s, natural content, CIELAB assignment, row-engine
scaling over the visible GPUs) ride in "extra", with the platform, device
kind and count, and the card's name and power limit.

Run on a GPU: `python bench.py`. Without a GPU it exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

NORTH_STAR_E2E_SECONDS = 10.0  # <= 10 s to quantize 4K to K=256
E2E_ANNEAL_ITERS = 50
H, W, K, POP = 2160, 3840, 256, 4


def _median(ts):
    ts = sorted(ts)
    return ts[len(ts) // 2]


def _card() -> list[str]:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]


def assign_mpix_per_s(engine, cfg, ctx, palettes, inner=24, outer=5):
    """Mpix/s of the engine's chosen assignment (kernel or XLA) + winner
    gather + usage, `inner` calls with rotating palettes inside ONE jitted
    fori_loop so dispatch is amortized; median and [min, max] over `outer`
    repetitions."""
    import jax
    import jax.numpy as jnp

    from hybridquantization import colorspace as cs
    from hybridquantization.ops import assign as aj
    from hybridquantization.ops import triton_assign as ta

    P = H * W

    def assign(pals):
        if engine.kernel == "triton":
            _, q, u = ta.assign_population(
                ctx["x_planar"], pals, jax.vmap(cs.srgb_to_opp)(pals), P,
                precision=cfg.precision,
            )
            return q[0, 0, 0] + u[0, 0]

        def one(pal):
            idx = aj.nearest_palette(
                ctx["assign_pixels"], pal, precision=cfg.precision
            )
            return cs.srgb_to_opp(pal).T[:, idx][0, 0] + aj.palette_usage(idx, K)[0]

        return jnp.sum(jax.vmap(one)(pals))

    @jax.jit
    def loop(pals):
        return jax.lax.fori_loop(
            0, inner, lambda i, acc: acc + assign(pals[i % len(palettes)]),
            jnp.float32(0.0),
        )

    pals = jnp.asarray(np.stack(palettes))
    jax.device_get(loop(pals))
    rates = []
    for _ in range(outer):
        t0 = time.perf_counter()
        jax.device_get(loop(pals))
        rates.append(inner * POP * P / (time.perf_counter() - t0) / 1e6)
    rates.sort()
    return _median(rates), [round(rates[0], 1), round(rates[-1], 1)]


def main() -> int:
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX runs on {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1

    from hybridquantization import QuantizationConfig, SWASAConfig, synth
    from hybridquantization.ops.assign import polish_palette
    from hybridquantization.ops.kmeans import kmeans_init_palettes
    from hybridquantization.pipeline import (
        HybridQuantizer,
        _chunk_jit,
        _init_jit,
        _make_context,
        make_population_fitness,
    )
    from hybridquantization.runtime import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(0)
    image = jnp.asarray(rng.random((H, W, 3), dtype=np.float32))
    palettes = [rng.random((POP, K, 3)).astype(np.float32) for _ in range(8)]

    def make(space="srgb"):
        cfg = QuantizationConfig(
            swasa=SWASAConfig(num_colors=K, population=POP, imax=100),
            assignment_space=space,
        )
        return cfg, HybridQuantizer(cfg)

    cfg, engine = make()
    half = engine.filters.half_width
    ctx = _make_context(image, engine.filters, cfg, engine.kernel)
    assign_rate, assign_spread = assign_mpix_per_s(engine, cfg, ctx, palettes)

    fitness = jax.jit(
        lambda c, p: make_population_fitness(c, cfg, half)(p)[0]
    )
    jax.device_get(fitness(ctx, jnp.asarray(palettes[0])))
    ts = []
    for i in range(1, 4):
        t0 = time.perf_counter()
        jax.device_get(fitness(ctx, jnp.asarray(palettes[i])))
        ts.append(time.perf_counter() - t0)
    t_fitness = _median(ts)

    state = _init_jit(jax.random.PRNGKey(0), ctx, cfg, half)
    state, _ = _chunk_jit(state, ctx, cfg, 10, half)
    jax.device_get(state.best_error)
    ts = []
    for _ in range(4):
        t0 = time.perf_counter()
        state, _ = _chunk_jit(state, ctx, cfg, 10, half)
        jax.device_get(state.best_error)
        ts.append(time.perf_counter() - t0)
    iters_per_s = 10.0 / _median(ts)

    def schedule(img, key, cfg_, eng):
        # EVERYTHING a fresh image needs: context build, k-means seeding,
        # the anneal, Lloyd polish, the final quantize.
        ctx_i = _make_context(img, eng.filters, cfg_, eng.kernel)
        pixels = img.reshape(-1, 3)
        seeds = kmeans_init_palettes(key, pixels, K, POP)
        st = _init_jit(key, ctx_i, cfg_, half, seeds)
        for _ in range(E2E_ANNEAL_ITERS // 10):
            st, _ = _chunk_jit(st, ctx_i, cfg_, 10, half)
        pal = polish_palette(
            pixels, st.best_colors, cfg_.assignment_space,
            ctx_i["whitepoint"], 10,
        )
        return jax.block_until_ready(eng.quantize(img, pal))

    def e2e(img, key, cfg_, eng):
        schedule(image, jax.random.PRNGKey(99), cfg_, eng)  # compile
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        out = schedule(img, key, cfg_, eng)
        t = time.perf_counter() - t0
        de = float(jax.device_get(eng.error_image(img, out)[0]))
        return t, de

    img2 = jnp.asarray(rng.random((H, W, 3), dtype=np.float32))
    t_e2e, e2e_de = e2e(img2, jax.random.PRNGKey(2), cfg, engine)
    nat = jnp.asarray(synth.natural_image(H, W, seed=7))
    t_nat, de_nat = e2e(nat, jax.random.PRNGKey(3), cfg, engine)
    cfg_lab, engine_lab = make("lab")
    t_lab, de_lab = e2e(img2, jax.random.PRNGKey(5), cfg_lab, engine_lab)

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    from bench_multichip import measure_scaling

    counts = [n for n in (1, 2, 4, 8) if n <= len(jax.devices())]
    scaling = measure_scaling(counts, H, W, K, POP, iters=10, reps=3)

    print(json.dumps({
        "metric": "e2e_seconds_quality_matched_4k_k256_1gpu",
        "value": round(t_e2e, 3),
        "unit": "s",
        "vs_baseline": round(NORTH_STAR_E2E_SECONDS / t_e2e, 4),
        "extra": {
            "e2e_mean_delta_e": round(e2e_de, 3),
            "reference_schedule_delta_e_same_image_class": 5.66,
            "e2e_schedule": (
                f"kmeans seed + {E2E_ANNEAL_ITERS} SWASA iters + 10 "
                f"histogram-Lloyd steps; precision {cfg.precision}"
            ),
            "assignment": engine.kernel,
            "assignment_mpix_per_s_k256_pop4": round(assign_rate, 1),
            "assignment_mpix_spread": assign_spread,
            "pop4_fitness_eval_seconds_4k_k256": round(t_fitness, 4),
            "swasa_iters_per_s_pop4_4k_k256": round(iters_per_s, 3),
            "natural_content_4k_k256": {
                "e2e_seconds": round(t_nat, 3), "e2e_mean_delta_e": round(de_nat, 3),
            },
            "lab_assignment_4k_k256": {
                "e2e_seconds": round(t_lab, 3), "e2e_mean_delta_e": round(de_lab, 3),
            },
            "row_engine_scaling": scaling,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
            "cards": _card(),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
