"""Mixed-resolution bucketing + batch CLI smoke test."""

import subprocess
import sys

import numpy as np

from hybridquantization.batching import (
    bucket_by_resolution,
    pad_indices,
    run_bucketed,
)


def test_bucketing():
    sizes = [(64, 64), (32, 48), (64, 64), (32, 48), (128, 128)]
    buckets = bucket_by_resolution(sizes)
    assert sorted(b.resolution for b in buckets) == [(32, 48), (64, 64), (128, 128)]
    by_res = {b.resolution: b.indices for b in buckets}
    assert by_res[(64, 64)] == [0, 2]
    assert by_res[(32, 48)] == [1, 3]


def test_pad_indices():
    assert pad_indices([1, 2, 3], 2) == ([1, 2, 3, 3], 3)
    assert pad_indices([1, 2], 2) == ([1, 2], 2)
    assert pad_indices([5], 4) == ([5, 5, 5, 5], 1)


def test_run_bucketed_reorders(rng):
    images = [
        rng.random((8, 8, 3), dtype=np.float32),
        rng.random((4, 6, 3), dtype=np.float32),
        rng.random((8, 8, 3), dtype=np.float32),
    ]

    def run_batch(stack):
        # "result" = per-image mean; shapes prove correct grouping
        return (stack * 2, np.array([im.mean() for im in stack]))

    out = run_bucketed(images, run_batch, n_data=2)
    for i in range(3):
        doubled, mean = out[i]
        np.testing.assert_allclose(doubled, images[i] * 2)
        assert mean == np.float32(images[i].mean())


def test_batch_cli_smoke(tmp_path, rng):
    """Drive the quantize-batch CLI end-to-end on the CPU backend."""
    from hybridquantization import io as hio

    paths = []
    for i, shape in enumerate([(64, 48), (64, 48), (80, 64)]):
        img = rng.random((*shape, 3), dtype=np.float32)
        p = str(tmp_path / f"img{i}.ppm")
        hio.save_image(p, img)
        paths.append(p)

    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from hybridquantization.cli import main;"
        f"raise SystemExit(main(['quantize-batch', *{paths!r},"
        f" '--out-dir', {str(tmp_path / 'out')!r}, '--colors', '4',"
        " '--imax', '10', '--population', '2', '--mesh-data', '1',"
        " '--mesh-pixel', '4']))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=300,
        env={
            **__import__("os").environ,
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        },
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out_files = sorted((tmp_path / "out").iterdir())
    assert len(out_files) == 3
    assert "batch done" in proc.stdout


def test_batch_kmeans_init_and_polish(rng):
    """kmeans seeding + Lloyd polish through the sharded batch engine."""
    import dataclasses

    import jax
    import numpy as np

    from hybridquantization import QuantizationConfig, SWASAConfig
    from hybridquantization.parallel import ShardedBatchQuantizer, make_mesh

    imgs = rng.random((2, 24, 32, 3)).astype(np.float32)
    mesh = make_mesh(2, 2)
    for init in ["random", "kmeans"]:
        cfg = QuantizationConfig(
            swasa=SWASAConfig(num_colors=6, population=2, imax=4), init=init
        )
        q = ShardedBatchQuantizer(cfg, mesh)
        out, info = q.run(imgs, polish_iters=3)
        assert out.shape == imgs.shape
        assert np.isfinite(info["best_errors"]).all()
        # polished palettes stay in gamut and keep their shape
        assert info["palettes"].shape == (2, 6, 3)
        assert info["palettes"].min() >= 0.0 and info["palettes"].max() <= 1.0


def test_bucketed_batch_64_mixed_resolutions(rng):
    """BASELINE config-4-shaped evidence at B=64 (round-3 VERDICT Next #7):
    the bucketing/padding machinery existed but had only ever been
    exercised at B<=3. 64 mixed-resolution images flow through
    run_bucketed + ShardedBatchQuantizer on the 8-virtual-device mesh;
    every image must come back in input order with a finite palette, a
    correctly shaped output, and <= K distinct colors."""
    import time

    from hybridquantization import QuantizationConfig, SWASAConfig
    from hybridquantization.parallel import ShardedBatchQuantizer, make_mesh

    K = 5
    sizes = [(24, 32), (32, 24), (40, 40), (24, 24)]
    images = [
        rng.random(sizes[i % len(sizes)] + (3,)).astype(np.float32)
        for i in range(64)
    ]
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=K, population=2, imax=4)
    )
    q = ShardedBatchQuantizer(cfg, make_mesh(2, 4))

    def run_batch(stack):
        out, info = q.run(stack)
        return np.asarray(out), np.asarray(info["palettes"]), np.asarray(
            info["best_errors"]
        )

    t0 = time.time()
    results = run_bucketed(images, run_batch, n_data=2)
    elapsed = time.time() - t0

    assert len(results) == 64 and all(r is not None for r in results)
    for img, (out, pal, err) in zip(images, results):
        assert out.shape == img.shape
        assert pal.shape == (K, 3) and np.isfinite(pal).all()
        assert np.isfinite(err)
        assert len(np.unique(out.reshape(-1, 3), axis=0)) <= K
    # 4 shape buckets x 16 images on tiny shapes: minutes would mean the
    # bucketing recompiled per image instead of per bucket
    assert elapsed < 300, f"B=64 bucketed run took {elapsed:.0f}s"
