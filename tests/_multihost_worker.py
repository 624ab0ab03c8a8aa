"""Subprocess worker for tests/test_multihost.py — NOT a pytest module.

Each worker is one "host" of a 2-process jax.distributed CPU cluster with
4 virtual devices (global mesh: data=2 hosts x pixel=4 local devices —
exactly the multihost.distributed_mesh policy: pixel/halo traffic stays
within a process, the data axis spans processes). Two modes:

  engine  — drive ShardedBatchQuantizer directly (find_palettes, quantize,
            error_images) and dump the results to .npz
  cli     — drive the real `quantize-batch --distributed` CLI flow
            (cli.py --distributed -> multihost.init_distributed ->
            distributed_mesh), writing output/error images to disk

Usage: python tests/_multihost_worker.py <pid> <coordinator> <mode> <out> [cli args...]
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    pid = int(sys.argv[1])
    coord = sys.argv[2]
    mode = sys.argv[3]
    out = sys.argv[4]

    # Launched by script path, so sys.path[0] is tests/ — make the package
    # importable without touching PYTHONPATH.
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)

    # 4 virtual CPU devices per process (replace any inherited count).
    flags = [
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f
    ]
    os.environ["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=4"]
    )

    import jax

    # Force CPU via config (tests/conftest.py does the same for the parent
    # process).
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    if mode == "cli":
        # The REAL multi-host CLI flow: --distributed makes cli.py call
        # init_distributed + distributed_mesh itself.
        from hybridquantization.cli import main as cli_main

        rc = cli_main(
            sys.argv[5:]
            + [
                "--distributed",
                "--coordinator", coord,
                "--num-processes", "2",
                "--process-id", str(pid),
            ]
        )
        assert jax.process_count() == 2, jax.process_count()
        return rc

    if mode == "config5":
        # Config-5-shaped combined run: a REAL 2-process jax.distributed
        # cluster and a bucketed mixed-resolution batch (B=8, two shape
        # buckets, odd heights padded) through the row engine in ONE
        # program. Mesh: data=4 (2 hosts x 2), pixel=2 per host, so the
        # halo ppermutes and the error/usage psums stay intra-process.
        from hybridquantization import QuantizationConfig, SWASAConfig
        from hybridquantization.batching import run_bucketed
        from hybridquantization.parallel import ShardedBatchQuantizer
        from hybridquantization.parallel.multihost import (
            distributed_mesh,
            init_distributed,
        )

        init_distributed(coord, num_processes=2, process_id=pid)
        assert jax.process_count() == 2, jax.process_count()
        mesh = distributed_mesh(pixel_per_host=2)
        assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
            "data": 4, "pixel": 2,
        }
        for row in mesh.devices:
            assert len({d.process_index for d in row}) == 1

        cfg = QuantizationConfig(
            swasa=SWASAConfig(num_colors=5, population=2, imax=4), seed=7
        )
        q = ShardedBatchQuantizer(cfg, mesh)

        rng = np.random.default_rng(5)
        sizes = [(100, 200), (90, 170)]
        images = [
            rng.random(sizes[i % 2] + (3,)).astype(np.float32)
            for i in range(8)
        ]

        def run_batch(stack):
            o, info = q.run(stack)
            return (
                np.asarray(o),
                np.asarray(info["palettes"]),
                np.asarray(info["best_errors"]),
            )

        results = run_bucketed(images, run_batch, n_data=q.n_data)
        flat = {}
        for i, (o, pal, err) in enumerate(results):
            flat[f"out{i}"] = o
            flat[f"pal{i}"] = pal
            flat[f"err{i}"] = np.asarray(err)
        np.savez(out, **flat)
        return 0

    assert mode == "engine", mode
    from hybridquantization import QuantizationConfig, SWASAConfig
    from hybridquantization.parallel import ShardedBatchQuantizer
    from hybridquantization.parallel.multihost import (
        distributed_mesh,
        init_distributed,
    )

    init_distributed(coord, num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()
    init_distributed()  # idempotence: a second call must be a no-op

    mesh = distributed_mesh(pixel_per_host=4)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "data": 2, "pixel": 4,
    }
    # pixel axis confined to one process (halo ppermute never crosses DCN)
    for row in mesh.devices:
        assert len({d.process_index for d in row}) == 1

    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=4, population=2, imax=4), seed=7
    )
    q = ShardedBatchQuantizer(cfg, mesh)
    rng = np.random.default_rng(0)
    images = rng.random((2, 48, 16, 3)).astype(np.float32)

    palettes, info = q.find_palettes(images)
    quant = np.asarray(q._fetch(q.quantize(images, palettes)))
    de, viz = q.error_images(images, quant)

    np.savez(
        out,
        palettes=np.asarray(palettes),
        best_errors=np.asarray(info["best_errors"]),
        quant=quant,
        de=np.asarray(de),
        viz=np.asarray(viz),
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
