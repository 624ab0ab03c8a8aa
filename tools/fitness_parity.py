"""Deterministic engine-vs-oracle fitness parity at arbitrary scale.

`tools/parity_check.py` compares FINAL anneal quality — statistically,
because the anneal is stochastic and per-seed std is ~0.24 ΔE at
config-2 (1024x1024/K64), so an 8-seed mean resolves the 1% budget only
to ~±1.3%. This tool removes the anneal from the comparison entirely:
for IDENTICAL palettes it evaluates the engine's jitted population
fitness (the exact function the SWASA loop optimizes — the fused assignment
kernel on a GPU, the banded S-CIELAB conv, the on-device ΔE reduction)
against the NumPy
oracle's definitional fitness (tests/oracle.py, f64), and reports the
relative gap plus the fraction of per-pixel assignment disagreements.
Zero seed noise: every digit of the gap is numerics, not luck.

Together the two tools give the config-2 parity case: this one shows the
engine optimizes the SAME objective to ~1e-4, parity_check shows the
optimized RESULTS agree within the anneal's intrinsic noise.

Usage:
  python tools/fitness_parity.py [--size 1024] [--colors 64]
      [--palettes 12] [--population 4] [--precision f32x3]
      [--tolerance 1e-3]

`measure(argv)` runs the same comparison in-process and returns its
numbers (chip_smoke.py calls it).

Reference semantics under test: fitness = mean CIE76 ΔE between
S-CIELAB(original) and S-CIELAB(quantized) + δ·(unused colors)
(ImageManipulation.java:701-714, SWASA.java:74-82); assignment =
first-minimum sRGB nearest (OptimizedConvolution.cl:147-170).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from parity_check import content_image  # noqa: E402


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="smooth",
                    choices=["smooth", "natural"],
                    help="content class (natural = 1/f value noise, the "
                    "reference's bioimage-statistics workload); this layer "
                    "is deterministic, so it reaches config-2-natural "
                    "scale without paying the anneal's per-seed noise")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--colors", "-k", type=int, default=64)
    ap.add_argument("--palettes", type=int, default=12,
                    help="number of palette batches to evaluate")
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--precision", default="f32x3",
                    choices=["highest", "f32x3", "bf16"])
    ap.add_argument("--tolerance", type=float, default=1e-3,
                    help="max relative fitness gap for PASS (0.1% default "
                    "— 10x tighter than the 1% quality budget)")
    return ap


def measure(argv=None, log=print) -> dict:
    """Engine-vs-oracle fitness gaps; returns max/mean gap, flip rate, ok."""
    args = _parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    from hybridquantization import QuantizationConfig, SWASAConfig
    from hybridquantization.ops import assign as assign_ops
    from hybridquantization.ops import triton_assign
    from hybridquantization.pipeline import (
        HybridQuantizer,
        _make_context,
        make_population_fitness,
    )
    from tests import oracle

    img = content_image(args.content, args.size)
    cfg = QuantizationConfig(
        swasa=SWASAConfig(
            num_colors=args.colors, population=args.population
        ),
        precision=args.precision,
    )
    engine = HybridQuantizer(cfg)
    ctx = _make_context(jnp.asarray(img), engine.filters, cfg, engine.kernel)
    fit = jax.jit(make_population_fitness(ctx, cfg, engine.filters.half_width))
    if engine.kernel == "triton":
        def nearest(px, pal):
            return triton_assign.nearest_palette(px, pal, precision=args.precision)
    else:
        def nearest(px, pal):
            return assign_ops.nearest_palette(px, pal, precision=args.precision)
    nearest = jax.jit(nearest)

    ofilters, abs_k3, _ = oracle.build_filters(72, 45.0)
    target = oracle.srgb_to_scielab(img.astype(np.float64), ofilters, abs_k3)

    rng = np.random.default_rng(7)
    gaps, tie_gaps, flips = [], [], []
    npix = args.size * args.size
    for b in range(args.palettes):
        pals = rng.random((args.population, args.colors, 3)).astype(np.float32)
        if b == 0:
            # Near-tie stress (informational, NOT gated): duplicate and
            # sub-f32-resolution perturbed entries. The engine — like the
            # reference's all-`float` OpenCL path — collapses a 1e-7
            # relative perturbation to an exact tie (first index wins),
            # while the f64 oracle resolves it; when that flips an entry's
            # usage, the fitness jumps by a whole unused-color penalty
            # quantum (δ=2). The f64 oracle is STRICTER than the reference
            # here, so this measures tie semantics, not realistic parity.
            pals[0, 1] = pals[0, 0]
            pals[1, 1] = pals[1, 0] * (1 + 1e-7)
        t0 = time.time()
        errs, _usage = jax.device_get(fit(jnp.asarray(pals)))
        dt_eng = time.time() - t0
        o_errs = np.array([
            oracle.fitness(
                img.astype(np.float64), target, p.astype(np.float64),
                ofilters, abs_k3,
            )
            for p in pals
        ])
        gap = np.abs(errs - o_errs) / o_errs
        (tie_gaps if b == 0 else gaps).extend(gap.tolist())
        # per-pixel assignment agreement, engine vs oracle (member 0)
        eng_idx = np.asarray(jax.device_get(
            nearest(jnp.asarray(img.reshape(-1, 3)), jnp.asarray(pals[0]))
        ))
        o_idx = oracle.nearest_palette(
            img.reshape(-1, 3).astype(np.float64),
            pals[0].astype(np.float64),
        )
        flips.append(float((eng_idx != o_idx).mean()))
        log(
            f"batch {b}: rel fitness gap "
            + " ".join(f"{g:.2e}" for g in gap)
            + f"  assign flips {flips[-1]:.2e}"
            + f"  (engine {dt_eng:.2f}s)"
        )

    gaps = np.asarray(gaps if gaps else tie_gaps)
    return {
        "max_gap": float(gaps.max()),
        "mean_gap": float(gaps.mean()),
        "tie_stress_max_gap": max(tie_gaps) if tie_gaps else None,
        "max_flip_rate": max(flips),
        "pixels": npix,
        "kernel": engine.kernel,
        "precision": args.precision,
        "tolerance": args.tolerance,
        "ok": bool(gaps.max() <= args.tolerance),
    }


def main(argv=None) -> int:
    from hybridquantization.runtime import enable_compilation_cache

    enable_compilation_cache()
    r = measure(argv)
    print(
        f"\nfitness gap over the random-palette evals: "
        f"max {r['max_gap']:.3e} mean {r['mean_gap']:.3e}  "
        f"(precision={r['precision']}, assignment={r['kernel']}, f64 oracle)"
    )
    if r["tie_stress_max_gap"] is not None:
        print(
            f"tie-stress batch (informational): max gap "
            f"{r['tie_stress_max_gap']:.3e} — sub-f32 perturbations resolved "
            "by the f64 oracle but not by the engine or the reference's "
            "float OpenCL path"
        )
    print(
        f"assignment flips: max {r['max_flip_rate']:.3e} of {r['pixels']} px "
        "(near-tie f32-rounding class)"
    )
    print("DETERMINISTIC PARITY:", "PASS" if r["ok"] else "FAIL",
          f"(tolerance {r['tolerance']:.0e}, random palettes)")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
