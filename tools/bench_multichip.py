"""Multi-device throughput bench of the row-sharded batch engine.

Times SWASA chunks per pixel-shard count on ShardedBatchQuantizer
(parallel.sharded: per-shard XLA assignment and S-CIELAB filter, halo
ppermutes, error/usage psums). On several GPUs this measures scaling; on
virtual CPU devices it only shows that the sharded programs compile and run
at every shard count (no device timing).

`measure_scaling` is the library entry — bench.py folds its rows into its
JSON line.

Run:
  python tools/bench_multichip.py                      # all device counts
  python tools/bench_multichip.py --shards 2,4 --size 512x768 --iters 10
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/bench_multichip.py --cpu            # 8 virtual devices
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure_scaling(
    shard_counts, H, W, colors=256, population=4, iters=10, reps=3,
    log=None,
):
    """Per-pixel-shard-count SWASA timing rows for the row-sharded engine.

    Returns a list of row dicts (pixel_shards, iter_ms, iters_per_s,
    eval_mpix_per_s, and — beyond the first count — an explicit
    speedup_vs_<baseline> plus scaling_efficiency). Counts whose strips
    would be shorter than the filter half-width are skipped.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hybridquantization import QuantizationConfig, SWASAConfig
    from hybridquantization.parallel import ShardedBatchQuantizer, make_mesh

    devices = jax.devices()
    cfg = QuantizationConfig(
        swasa=SWASAConfig(
            num_colors=colors, population=population, imax=10**6
        ),
    )
    rng = np.random.default_rng(0)
    images = rng.random((1, H, W, 3), dtype=np.float32)

    results = []
    for n_pixel in shard_counts:
        if n_pixel > len(devices):
            continue
        q = ShardedBatchQuantizer(
            cfg, make_mesh(1, n_pixel, devices=devices[:n_pixel])
        )
        try:
            q._row_plan(H)
        except ValueError:
            if log:
                log(f"shards={n_pixel}: strips too short, skipped")
            continue
        prepare, init_fn, chunk_fn = q._prepare, q._init, q._chunk
        imgs, h_true = q._pad_rows(jnp.asarray(images))
        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(1, dtype=jnp.uint32))
        ctx = prepare(imgs)
        hv = None if imgs.shape[1] == h_true else h_true
        state = init_fn(imgs, ctx, keys, None, hv)
        state, _ = chunk_fn(state, imgs, ctx, iters, hv)  # compile + warm
        jax.device_get(state.best_error)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            state, _ = chunk_fn(state, imgs, ctx, iters, hv)
            jax.device_get(state.best_error)
            ts.append(time.perf_counter() - t0)
        ts.sort()
        dt = ts[len(ts) // 2] / iters
        row = {
            "pixel_shards": n_pixel,
            "iter_ms": round(dt * 1e3, 2),
            "iters_per_s": round(1.0 / dt, 2),
            "eval_mpix_per_s": round(population * H * W / dt / 1e6, 1),
        }
        if results:
            # Baseline = the FIRST measured shard count (--shards 2,4 starts
            # at 2); the key names it so scaling is never read against the
            # wrong denominator.
            base = results[0]
            row[f"speedup_vs_{base['pixel_shards']}"] = round(
                base["iter_ms"] / row["iter_ms"], 3
            )
            row["scaling_efficiency"] = round(
                base["iter_ms"] / row["iter_ms"]
                * base["pixel_shards"] / n_pixel, 3
            )
        results.append(row)
        if log:
            log(json.dumps(row))
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", default="", help="comma list of pixel-shard counts")
    ap.add_argument("--size", default="", help="HxW (default 4K on a GPU, 256x1040 on CPU)")
    ap.add_argument("--colors", "-k", type=int, default=256)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10, help="iterations per timed chunk")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (virtual devices via XLA_FLAGS)",
    )
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    devices = jax.devices()
    if args.size:
        H, W = (int(v) for v in args.size.split("x"))
    elif jax.default_backend() == "gpu":
        H, W = 2160, 3840
    else:
        H, W = 256, 1040
    shard_counts = (
        [int(s) for s in args.shards.split(",")]
        if args.shards
        else [n for n in (1, 2, 4, 8) if n <= len(devices)]
    )
    print(
        f"device[0]={devices[0]}, n_devices={len(devices)}, image {H}x{W}, "
        f"K={args.colors}, pop={args.population}",
        file=sys.stderr,
    )
    rows = measure_scaling(
        shard_counts, H, W, args.colors, args.population, args.iters,
        args.reps, log=print,
    )
    return 0 if rows else 1


if __name__ == "__main__":
    raise SystemExit(main())
