"""Quality-parity check: our engine vs the reference-semantics NumPy oracle.

BASELINE north star: "match the reference plugin's quantization quality —
mean CIELAB Delta-E and MSE at the same palette size K — within 1% on
identical inputs". The reference itself is a GUI plugin (no OpenCL runtime
here), so the comparison target is tests/oracle.py — an independent NumPy
implementation of the reference pipeline verified formula-by-formula.

The anneal is stochastic (and the reference is unseeded), so parity is
statistical: both sides run S seeds and the mean final S-CIELAB Delta-E and
sRGB MSE are compared.

Defaults (--seeds 24 --imax 1500) are the documented trustworthy config
(docs/PERFORMANCE.md): per-seed final-error std is ~0.3 on BOTH sides, so a
few-seed mean has ~1% noise and can spuriously FAIL (or PASS) the 1%
tolerance; 24 seeds brings the comparison to ~0.1%. At imax << 1500 the
anneal has not converged and the comparison is meaningless.

Usage:
  python tools/parity_check.py [--image PATH] [--size 128] [--colors 8]
      [--imax 1500] [--seeds 24]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__)) if "__file__" in globals() else os.getcwd()
sys.path.insert(0, os.path.dirname(_HERE) if _HERE.endswith("tools") else _HERE)


def make_test_image(size: int, rng) -> np.ndarray:
    """Historical smooth parity workload (delegates to synth; the committed
    JSONL evidence depends on this staying bit-identical)."""
    from hybridquantization import synth

    return synth.smooth_test_image(size, rng)


def content_image(content: str, size: int, seed: int = 0) -> np.ndarray:
    """Shared content-axis dispatch for the parity runners."""
    from hybridquantization import synth

    if content == "smooth":
        return make_test_image(size, np.random.default_rng(seed))
    if content == "natural":
        return synth.natural_image(size, size, seed=seed)
    raise ValueError(f"unknown content class {content!r}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", help="input image (default: synthetic)")
    ap.add_argument(
        "--content", default="smooth", choices=["smooth", "natural"],
        help="synthetic content class: 'smooth' (historical parity "
        "workload) or 'natural' (1/f multi-octave value noise — the "
        "natural-statistics axis, synth.natural_image)",
    )
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--colors", "-k", type=int, default=8)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--tolerance", type=float, default=0.01, help="relative gap for PASS")
    ap.add_argument(
        "--oracle-jobs", type=int, default=1,
        help="run the oracle seeds in N parallel processes, launched "
        "BEFORE the engine seeds (the engine mostly waits on the device, so "
        "the overlap is nearly free). Use for the config-2-scale check "
        "(--size 1024 --colors 64), where one oracle seed is ~30-60 min "
        "of NumPy",
    )
    ap.add_argument(
        "--oracle-dtype", default="f64", choices=["f64", "f32"],
        help="oracle SEARCH precision (the judge is always f64). f32 "
        "matches the reference's active OpenCL path (every device buffer "
        "in OptimizedConvolution.cl is `float`) and runs ~2x faster — "
        "use for the config-2-scale check",
    )
    ap.add_argument("--precision", default="f32x3", choices=["highest", "f32x3", "bf16"])
    ap.add_argument(
        "--fast", action="store_true",
        help="validate the fast mode: --precision bf16",
    )
    args = ap.parse_args()
    if args.fast:
        args.precision = "bf16"
    if args.seeds < 24:
        print(
            f"WARNING: --seeds {args.seeds} < 24. Per-seed final-error std is "
            "~0.3 on both sides (docs/PERFORMANCE.md); a few-seed mean aliases "
            "into the 1% tolerance and the PASS/FAIL verdict is NOISE. Use "
            ">= 24 seeds for a trustworthy comparison.",
            file=sys.stderr,
        )
    if args.imax < 1500:
        print(
            f"WARNING: --imax {args.imax} < 1500: the anneal has not converged "
            "and the quality comparison is not meaningful (gap ~6% at imax=300).",
            file=sys.stderr,
        )

    from tests import oracle

    if args.image:
        from hybridquantization import io as hio

        img = hio.load_image(args.image)
    else:
        img = content_image(args.content, args.size)

    print(
        f"engine precision={args.precision} "
        f"oracle_dtype={args.oracle_dtype} content={args.content}"
    )
    ofilters, abs_k3, _ = oracle.build_filters(72, 45.0)
    target = oracle.srgb_to_scielab(img.astype(np.float64), ofilters, abs_k3)

    def quality(palette: np.ndarray):
        """Final-quality metrics via the oracle (one judge for both sides)."""
        idx = oracle.nearest_palette(
            img.reshape(-1, 3).astype(np.float64), palette.astype(np.float64)
        )
        q = palette[idx].reshape(img.shape)
        q_lab = oracle.srgb_to_scielab(q, ofilters, abs_k3)
        de = oracle.delta_e76(target, q_lab).mean()
        mse = float(((q - img) ** 2).mean())
        return de, mse

    odtype = np.float32 if args.oracle_dtype == "f32" else np.float64

    def oracle_seed(s):
        t0 = time.time()

        def progress(ite):
            print(
                f"[oracle] seed {s}: iter {ite}/{args.imax} "
                f"({time.time() - t0:.0f}s)", flush=True,
            )

        pal_o, _ = oracle.swasa_search(
            img.astype(odtype),
            args.colors,
            seed=s,
            population=args.population,
            imax=args.imax,
            dtype=odtype,
            progress=progress,
        )
        return pal_o, time.time() - t0

    ours_de, ours_mse, oracle_de, oracle_mse = [], [], [], []
    procs, q = [], None
    if args.oracle_jobs > 1:
        # fork Processes, not Pool: Pool pickles the task callable (fails
        # on this closure); fork Process inherits it directly. Workers are
        # pure NumPy — they never touch jax. Launched BEFORE the engine
        # seeds: the engine mostly blocks on the device. Each worker judges
        # its own seeds (f64 quality) and streams results so a partial
        # log still yields per-seed values.
        import multiprocessing as mp

        ctx_mp = mp.get_context("fork")
        q = ctx_mp.Queue()

        def worker(seed_list):
            for s in seed_list:
                pal_o, dt = oracle_seed(s)
                de, mse = quality(np.asarray(pal_o, np.float64))
                q.put((s, de, mse, dt))

        chunks = [
            c
            for j in range(args.oracle_jobs)
            if (c := list(range(args.seeds))[j :: args.oracle_jobs])
        ]
        procs = [
            ctx_mp.Process(target=worker, args=(c,), daemon=True)
            for c in chunks
        ]
        for p in procs:
            p.start()

    # jax only touched AFTER the oracle workers forked: forking a process
    # whose device client threads hold locks can deadlock the children.
    import jax

    from hybridquantization import (
        HybridQuantizer,
        QuantizationConfig,
        SWASAConfig,
    )
    from hybridquantization.runtime import enable_compilation_cache

    enable_compilation_cache()
    cfg = QuantizationConfig(
        swasa=SWASAConfig(
            num_colors=args.colors, population=args.population, imax=args.imax
        ),
        precision=args.precision,
    )
    engine = HybridQuantizer(cfg)

    for s in range(args.seeds):
        t0 = time.time()
        pal, info = engine.find_palette(
            img, key=jax.random.PRNGKey(s), chunk_size=args.imax
        )
        de, mse = quality(np.asarray(pal, np.float64))
        ours_de.append(de)
        ours_mse.append(mse)
        print(
            f"[ours]   seed {s}: deltaE {de:.4f}  mse {mse:.6f}  "
            f"({time.time() - t0:.1f}s)", flush=True,
        )

    if procs:
        # Poll with a timeout and check worker liveness: if a forked oracle
        # worker dies (exception, OOM) mid-run, write off only ITS
        # undelivered seeds and keep collecting from the live workers
        # (seeds take ~1 h each, so the queue being empty says nothing
        # about the survivors — round-4 advisor finding); block-free exit
        # once every live worker's seeds are in.
        import queue as queue_mod

        undelivered = {i: set(c) for i, c in enumerate(chunks)}
        written_off = set()
        pending = args.seeds
        while pending:
            try:
                s, de, mse, dt = q.get(timeout=30.0)
            except queue_mod.Empty:
                for i, p in enumerate(procs):
                    if (
                        i not in written_off
                        and not p.is_alive()
                        and p.exitcode not in (0, None)
                    ):
                        written_off.add(i)
                        lost = len(undelivered[i])
                        pending -= lost
                        print(
                            f"ERROR: oracle worker {i} died (exitcode "
                            f"{p.exitcode}), abandoning its {lost} "
                            f"undelivered seed(s) {sorted(undelivered[i])}; "
                            "continuing with live workers",
                            file=sys.stderr,
                        )
                if pending and all(not p.is_alive() for p in procs) and q.empty():
                    print(
                        f"ERROR: all oracle workers exited with only "
                        f"{len(oracle_de)}/{args.seeds} seeds delivered",
                        file=sys.stderr,
                    )
                    break
                continue
            pending -= 1
            for dset in undelivered.values():
                dset.discard(s)
            oracle_de.append(de)
            oracle_mse.append(mse)
            print(
                f"[oracle] seed {s}: deltaE {de:.4f}  mse {mse:.6f}  "
                f"({dt:.1f}s)", flush=True,
            )
        for p in procs:
            p.join()
        if not oracle_de:
            print("no oracle seeds collected — cannot compare", file=sys.stderr)
            return 2
    else:
        for s in range(args.seeds):
            pal_o, dt = oracle_seed(s)
            de, mse = quality(np.asarray(pal_o, np.float64))
            oracle_de.append(de)
            oracle_mse.append(mse)
            print(
                f"[oracle] seed {s}: deltaE {de:.4f}  mse {mse:.6f}  "
                f"({dt:.1f}s)", flush=True,
            )

    m_ours, m_oracle = np.mean(ours_de), np.mean(oracle_de)
    gap_de = abs(m_ours - m_oracle) / m_oracle
    gap_mse = abs(np.mean(ours_mse) - np.mean(oracle_mse)) / max(
        np.mean(oracle_mse), 1e-12
    )
    print(
        f"\nmean deltaE: ours {m_ours:.4f} vs oracle {m_oracle:.4f} "
        f"(gap {gap_de * 100:.2f}%)"
    )
    print(
        f"mean MSE:    ours {np.mean(ours_mse):.6f} vs oracle "
        f"{np.mean(oracle_mse):.6f} (gap {gap_mse * 100:.2f}%)"
    )
    ok = gap_de <= args.tolerance
    print("PARITY:", "PASS" if ok else "FAIL", f"(deltaE tolerance {args.tolerance:.0%})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
