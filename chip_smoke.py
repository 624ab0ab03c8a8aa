#!/usr/bin/env python3
"""Smoke test of the quantizer on one GPU: the main path at real sizes.

    python3 chip_smoke.py              # one GPU
    python3 chip_smoke.py --four-gpus  # the batch engine on four GPUs only

Phases, each reported as one JSON line with its seconds, compile seconds,
the device's peak_bytes_in_use so far and its Delta-E or gap:

  1. device      nvidia-smi name/power limit; JAX must report a GPU
  2. gpu_tests   the `gpu`-marked tests, in a child pytest process started
                 before this process touches the GPU
  3. config1     BASELINE config 1 (512^2, K=16, random init, imax 200)
     4k          the production schedule on 3840x2160 (K=256, pop 4,
                 --init kmeans --imax 50 --polish 10); both through
                 `cli.main` on PPM inputs, checked for <= K colours, a
                 finite Delta-E, a schedule that lowered the error below
                 the initial population's best fitness, and `cli error` on
                 the output agreeing
  4. kernel      the Triton assignment kernel against the XLA reference at
                 4K/K=256/pop 4 and 512^2/K=16/pop 4, plus their timings
                 inside the SWASA loop and end to end
     parity      tools/fitness_parity.py (1024^2, K=64) against the f64
                 oracle, in-process

The last line is {"ok": true, "device": {...}}; any failed phase exits
non-zero before it. Without a GPU the script exits non-zero at phase 1.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The reference schedule's mean Delta-E on uniform 4K/K=256 content
# (random init, imax 5000): a loose sanity bound for the 4K run.
REFERENCE_4K_DELTA_E = 5.66


class PhaseError(RuntimeError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# Phase 1/2: outside JAX
# ---------------------------------------------------------------------------

def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines; [] without a GPU."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if r.returncode != 0:
        return []
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]


def jax_device_in_child() -> dict:
    """Platform, kind and count as JAX reports them, in a child process that
    releases the GPU when it exits."""
    code = (
        "import json, jax; d = jax.devices();"
        "print(json.dumps({'platform': d[0].platform,"
        " 'kind': d[0].device_kind, 'count': len(d)}))"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO,
    )
    _check(r.returncode == 0, f"JAX failed to start:\n{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_gpu_tests() -> dict:
    tests = os.path.join(REPO, "tests", "test_gpu_hw.py")
    _check(os.path.exists(tests), f"{tests} not found")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", tests, "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        capture_output=True, text=True, timeout=900, cwd=REPO,
        env={**os.environ, "HQ_GPU_TESTS": "1"},
    )
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    m = re.search(r"(\d+) passed", tail)
    passed = int(m.group(1)) if m else 0
    _check(
        r.returncode == 0 and passed > 0 and "skipped" not in tail,
        f"gpu tests failed (rc {r.returncode}): {r.stdout[-3000:]}"
        f"{r.stderr[-2000:]}",
    )
    return {"seconds": time.perf_counter() - t0, "passed": passed, "summary": tail}


# ---------------------------------------------------------------------------
# In-process helpers (JAX imported lazily)
# ---------------------------------------------------------------------------

class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, via monitoring."""

    def __init__(self):
        import jax

        self.total = 0.0

        def listener(event, duration, **_):
            if event.startswith("/jax/core/compile/"):
                self.total += duration

        jax.monitoring.register_event_duration_secs_listener(listener)


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _run_cli(argv) -> str:
    from hybridquantization.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    _check(rc == 0, f"cli {argv[0]} returned {rc}:\n{out[-2000:]}")
    return out


def _float_after(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    _check(m is not None, f"{pattern!r} not in CLI output:\n{text[-2000:]}")
    return float(m.group(1))


def cli_case(workdir, name, H, W, seed, quantize_args, colors, de_bound=None):
    """Quantize a natural-statistics PPM through `cli.main`, then score the
    output with `cli error`; returns the phase record."""
    import numpy as np

    from hybridquantization import io as hio
    from hybridquantization import synth

    src = os.path.join(workdir, f"{name}.ppm")
    out = os.path.join(workdir, f"{name}_q.ppm")
    hio.save_image(src, synth.natural_image(H, W, seed=seed))
    t0 = time.perf_counter()
    log = _run_cli([
        "quantize", src, out, "--colors", str(colors), "--verbose",
        "--seed", str(seed), "--error-image",
        os.path.join(workdir, f"{name}_de.ppm"), *quantize_args,
    ])
    seconds = time.perf_counter() - t0
    initial = _float_after(r"iter 0/\d+\s+best ([-\d.eE+]+)", log)
    final = _float_after(r"final error ([-\d.eE+]+)", log)
    de = _float_after(r"DeltaE : ([-\d.eE+naif]+)", log)
    q = hio.load_image(out)
    n_colours = len(np.unique(q.reshape(-1, 3), axis=0))
    err_log = _run_cli(
        ["error", src, out, "--out", os.path.join(workdir, f"{name}_de2.ppm")]
    )
    de_again = _float_after(r"DeltaE : ([-\d.eE+naif]+)", err_log)
    _check(q.shape == (H, W, 3), f"{name}: output shape {q.shape}")
    _check(n_colours <= colors, f"{name}: {n_colours} colours > K={colors}")
    _check(math.isfinite(de), f"{name}: Delta-E {de}")
    # The schedule must improve on the initial population: the anneal for
    # random seeds; with k-means seeds a short anneal rarely beats the seed
    # and the Lloyd polish does the improving, so the output's Delta-E
    # counts too (with no unused colour, fitness is that same mean).
    _check(
        min(final, de) < initial,
        f"{name}: best {final} and Delta-E {de} !< initial fitness {initial}",
    )
    _check(
        abs(de - de_again) <= 1e-5 * max(abs(de), 1.0),
        f"{name}: quantize Delta-E {de} != error Delta-E {de_again}",
    )
    if de_bound is not None:
        _check(de < de_bound, f"{name}: Delta-E {de} >= {de_bound}")
    return {
        "seconds": seconds, "delta_e": de, "error_cli_delta_e": de_again,
        "colours": n_colours, "initial_best_fitness": initial,
        "final_best_fitness": final, "anneal_improved": final < initial,
        "image": f"{W}x{H}", "K": colors,
    }


def _median_time(fn, args_list, reps=5):
    import jax

    jax.block_until_ready(fn(*args_list[0]))
    ts = []
    for r in range(reps):
        a = args_list[(r + 1) % len(args_list)]
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def kernel_vs_reference(H, W, K, pop, seed=0, reps=5):
    """Triton kernel vs XLA nearest_palette(highest) + usage + gather on the
    same natural-statistics pixels. Indices must agree except where the two
    best f32 scores are within 1e-6 relative; usage exactly; gathered
    colours to 1e-6. Returns the record with both timings."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hybridquantization import colorspace as cs
    from hybridquantization import synth
    from hybridquantization.ops import assign as aj
    from hybridquantization.ops import triton_assign as ta

    P = H * W
    feats = jnp.asarray(synth.natural_image(H, W, seed=seed).reshape(-1, 3))
    rng = np.random.default_rng(seed)
    pal_sets = [
        jnp.asarray(rng.random((pop, K, 3), dtype=np.float32)) for _ in range(4)
    ]
    x = ta.pack_pixels(feats)

    @jax.jit
    def kernel(x, pals):
        return ta.assign_population(x, pals, jax.vmap(cs.srgb_to_opp)(pals), P)

    @jax.jit
    def reference(px, pals):
        def one(pal):
            idx = aj.nearest_palette(px, pal, precision="highest")
            return idx, cs.srgb_to_opp(pal).T[:, idx], aj.palette_usage(idx, K)
        return jax.vmap(one)(pals)

    k_idx, k_q, k_use = jax.device_get(kernel(x, pal_sets[0]))
    r_idx, r_q, r_use = jax.device_get(reference(feats, pal_sets[0]))
    _check((k_use == r_use).all(), f"{W}x{H}/K={K}: usage differs")
    px = np.asarray(feats, np.float64)
    worst_gap, flips = 0.0, 0
    for m in range(pop):
        pal = np.asarray(pal_sets[0][m], np.float64)
        opp = np.asarray(cs.srgb_to_opp(pal_sets[0][m]))
        # the gather is exact: the kernel's colour is the winner's colour
        _check(
            np.abs(k_q[m] - opp[k_idx[m]].T).max() <= 1e-6,
            f"K={K}: gathered colours differ from the winner's",
        )
        diff = np.nonzero(k_idx[m] != r_idx[m])[0]
        flips += len(diff)
        if len(diff):
            p = px[diff]
            # the scores both paths maximise, f.c - |c|^2/2, in f64; the gap
            # is relative to the size of the terms that f32 rounds
            ck, cr = pal[k_idx[m][diff]], pal[r_idx[m][diff]]
            sk = (p * ck).sum(-1) - 0.5 * (ck**2).sum(-1)
            sr = (p * cr).sum(-1) - 0.5 * (cr**2).sum(-1)
            scale = 0.5 * ((p**2).sum(-1) + np.maximum((ck**2).sum(-1), (cr**2).sum(-1)))
            gap = np.abs(sk - sr) / np.maximum(scale, 1e-30)
            worst_gap = max(worst_gap, float(gap.max()))
        same = k_idx[m] == r_idx[m]
        _check(
            np.abs(k_q[m][:, same] - r_q[m][:, same]).max() <= 1e-6,
            f"K={K}: colours differ where the indices agree",
        )
    _check(worst_gap < 1e-6, f"K={K}: index flip with score gap {worst_gap:.2e}")
    t_kernel = _median_time(kernel, [(x, p) for p in pal_sets], reps)
    t_xla = _median_time(reference, [(feats, p) for p in pal_sets], reps)
    return {
        "image": f"{W}x{H}", "K": K, "pop": pop,
        "kernel_ms": t_kernel * 1e3, "xla_ms": t_xla * 1e3,
        "index_flips": flips, "flip_max_rel_score_gap": worst_gap,
        "usage_equal": True,
    }


def schedule_times(H, W, K, pop, init, iters, polish, seed=0):
    """SWASA iteration time, population fitness time and the end-to-end
    schedule (context, seeding, anneal, polish, final quantize) with the
    kernel and with XLA assignment (use_pallas="off"), same image."""
    import jax
    import jax.numpy as jnp

    from hybridquantization import QuantizationConfig, SWASAConfig, synth
    from hybridquantization.pipeline import (
        HybridQuantizer,
        _chunk_jit,
        _init_jit,
        _make_context,
        make_population_fitness,
    )

    img = synth.natural_image(H, W, seed=seed)
    out = {"image": f"{W}x{H}", "K": K, "pop": pop}
    for mode in ("auto", "off"):
        cfg = QuantizationConfig(
            swasa=SWASAConfig(num_colors=K, population=pop, imax=iters),
            init=init, use_pallas=mode, seed=seed,
        )
        eng = HybridQuantizer(cfg)
        half = eng.filters.half_width
        ctx = _make_context(jnp.asarray(img), eng.filters, cfg, eng.kernel)

        fit = jax.jit(lambda c, p: make_population_fitness(c, cfg, half)(p)[0])
        pals = [jax.random.uniform(jax.random.PRNGKey(i), (pop, K, 3)) for i in range(3)]
        t_fit = _median_time(fit, [(ctx, p) for p in pals])

        state = _init_jit(jax.random.PRNGKey(seed), ctx, cfg, half)
        state, _ = _chunk_jit(state, ctx, cfg, 10, half)  # compile
        jax.block_until_ready(state.best_error)
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = _chunk_jit(state, ctx, cfg, 10, half)
        jax.block_until_ready(state.best_error)
        t_iter = (time.perf_counter() - t0) / 20

        def e2e():
            pal, _info = eng.find_palette(img)
            if polish:
                pal = eng.polish(img, pal, iters=polish)
            return jax.block_until_ready(eng.quantize(img, pal))

        e2e()  # compile every program of the schedule
        t0 = time.perf_counter()
        e2e()
        t_e2e = time.perf_counter() - t0
        key = "kernel" if eng.kernel == "triton" else "xla"
        out[f"{key}_fitness_ms"] = t_fit * 1e3
        out[f"{key}_iter_ms"] = t_iter * 1e3
        out[f"{key}_e2e_s"] = t_e2e
    return out


# ---------------------------------------------------------------------------
# Four GPUs: the batch engine against the single-card engine
# ---------------------------------------------------------------------------

# Scatter-adds (k-means histogram sums) and cross-device psums add floats in
# an order that changes from run to run on a GPU, so the two engines agree
# only up to last bits. Such a bit can flip a k-means bin between two nearly
# equidistant centres, or a Metropolis decision whose draw lies within ~1e-7
# of its threshold, and then one low-weight palette entry moves (by 2.3e-3
# in one four-card run). So the check is: best fitness within 1e-3 relative,
# and at most 1% of the palette entries farther apart than 1e-4.
FOUR_GPU_ENTRY_ATOL = 1e-4
FOUR_GPU_MOVED_FRACTION = 0.01
FOUR_GPU_ERROR_RTOL = 1e-3


# (name, data, pixel, pop) for the three meshes of the batch engine.
FOUR_GPU_MESHES = [
    ("data=4", 4, 1, 1),
    ("data=2,pixel=2", 2, 2, 1),
    ("data=1,pop=2,pixel=2", 1, 2, 2),
]


def batch_vs_single(images, K, pop, imax, seeds):
    """ShardedBatchQuantizer on each mesh vs HybridQuantizer per image."""
    import jax
    import numpy as np

    from hybridquantization import HybridQuantizer, QuantizationConfig, SWASAConfig
    from hybridquantization.parallel import ShardedBatchQuantizer, make_mesh

    # The row engine assigns with XLA at true f32; so does the reference.
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=K, population=pop, imax=imax),
        init="kmeans", precision="highest", use_pallas="off",
    )
    single = HybridQuantizer(cfg)
    want = []
    for img, s in zip(images, seeds):
        pal, info = single.find_palette(
            img, key=jax.random.PRNGKey(int(s)), chunk_size=imax
        )
        want.append((np.asarray(pal), info["best_error"]))
    records = []
    for name, n_data, n_pixel, n_pop in FOUR_GPU_MESHES:
        mesh = make_mesh(n_data, n_pixel, n_pop=n_pop)
        q = ShardedBatchQuantizer(cfg, mesh)
        t0 = time.perf_counter()
        pals, info = q.find_palettes(np.stack(images), seeds=seeds, chunk_size=imax)
        seconds = time.perf_counter() - t0
        entry_diff = np.stack([
            np.abs(np.asarray(pals[b]) - want[b][0]).max(axis=-1)
            for b in range(len(images))
        ])  # (B, K) per-entry max difference
        moved = int((entry_diff > FOUR_GPU_ENTRY_ATOL).sum())
        err_diff = max(
            abs(float(info["best_errors"][b]) - want[b][1]) / abs(want[b][1])
            for b in range(len(images))
        )
        _check(
            moved <= FOUR_GPU_MOVED_FRACTION * entry_diff.size
            and err_diff <= FOUR_GPU_ERROR_RTOL,
            f"mesh {name}: {moved} of {entry_diff.size} palette entries moved "
            f"(max {entry_diff.max():.2e}), error diff {err_diff:.2e}",
        )
        records.append({
            "mesh": name, "seconds": seconds,
            "max_palette_diff": float(entry_diff.max()),
            "moved_entries": moved, "entries": int(entry_diff.size),
            "max_rel_error_diff": err_diff,
            "best_errors": [float(e) for e in info["best_errors"]],
        })
    return records


def four_gpu_phase() -> None:
    import jax
    import numpy as np

    from hybridquantization import synth

    _check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs, need 4")
    clock = CompileClock()
    t0 = time.perf_counter()
    images = [synth.natural_image(1080, 1920, seed=10 + i) for i in range(4)]
    seeds = np.arange(4, dtype=np.uint32) + 3
    records = batch_vs_single(images, K=256, pop=4, imax=20, seeds=seeds)
    _emit(
        "four_gpus", seconds=time.perf_counter() - t0,
        compile_seconds=clock.total, peak_bytes_in_use=peak_bytes(),
        batch="4 x 1920x1080, K=256, pop 4, kmeans + 20 iterations",
        entry_atol=FOUR_GPU_ENTRY_ATOL, moved_fraction=FOUR_GPU_MOVED_FRACTION,
        error_rtol=FOUR_GPU_ERROR_RTOL,
        meshes=records,
    )


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-gpus", action="store_true",
        help="run only the batch engine on 4 GPUs against the single card",
    )
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    try:
        # -- 1. device ------------------------------------------------------
        t0 = time.perf_counter()
        cards = card_lines()
        _check(bool(cards), "nvidia-smi found no GPU")
        for line in cards:
            print(line, flush=True)
        device = jax_device_in_child()
        _check(device["platform"] == "gpu", f"JAX runs on {device['platform']}")
        _emit("device", seconds=time.perf_counter() - t0, cards=cards, **device)

        if not args.four_gpus:
            # -- 2. GPU-marked tests, before this process holds the GPU ------
            _emit("gpu_tests", **run_gpu_tests())

        import jax

        from hybridquantization.runtime import enable_compilation_cache

        enable_compilation_cache()
        device = {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        }
        _check(device["platform"] == "gpu", f"JAX runs on {device['platform']}")

        if args.four_gpus:
            four_gpu_phase()
        else:
            clock = CompileClock()
            with tempfile.TemporaryDirectory() as work:
                # -- 3. the main path through the CLI ----------------------
                for name, H, W, seed, qargs, K, bound in [
                    ("config1", 512, 512, 1, ["--imax", "200"], 16, None),
                    ("4k", 2160, 3840, 2,
                     ["--init", "kmeans", "--imax", "50", "--polish", "10"],
                     256, REFERENCE_4K_DELTA_E),
                ]:
                    c0 = clock.total
                    rec = cli_case(work, name, H, W, seed, qargs, K, bound)
                    _emit(name, compile_seconds=clock.total - c0,
                          peak_bytes_in_use=peak_bytes(), **rec)

            # -- 4. kernels against the plain reference ---------------------
            for H, W, K in [(2160, 3840, 256), (512, 512, 16)]:
                c0, t0 = clock.total, time.perf_counter()
                rec = kernel_vs_reference(H, W, K, pop=4)
                _emit("kernel", seconds=time.perf_counter() - t0,
                      compile_seconds=clock.total - c0,
                      peak_bytes_in_use=peak_bytes(), **rec)
            for H, W, K, init, iters, polish in [
                (2160, 3840, 256, "kmeans", 50, 10),
                (512, 512, 16, "random", 200, 0),
            ]:
                c0, t0 = clock.total, time.perf_counter()
                rec = schedule_times(H, W, K, 4, init, iters, polish)
                _emit("kernel_in_schedule", seconds=time.perf_counter() - t0,
                      compile_seconds=clock.total - c0,
                      peak_bytes_in_use=peak_bytes(), **rec)

            sys.path.insert(0, os.path.join(REPO, "tools"))
            import fitness_parity

            c0, t0 = clock.total, time.perf_counter()
            parity = fitness_parity.measure(
                ["--size", "1024", "--colors", "64", "--palettes", "3"],
                log=lambda _msg: None,
            )
            _emit("parity", seconds=time.perf_counter() - t0,
                  compile_seconds=clock.total - c0,
                  peak_bytes_in_use=peak_bytes(), **parity)
            _check(parity["ok"], f"fitness parity gap {parity['max_gap']:.3e}")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
