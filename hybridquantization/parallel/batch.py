"""Batched multi-image quantization over a device mesh.

The scale-out driver for BASELINE configs 4-5: a batch of images, each
annealed to its own K-color palette, images data-parallel over the "data"
mesh axis and pixels row-sharded over "pixel". The reference processes one
image at a time in a GUI (HybridQuantization.java:93-137); this is the
production-batch equivalent.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import jax.numpy as jnp

import functools

from ..config import QuantizationConfig
from ..scielab.filters import build_filters
from .mesh import DATA_AXIS, PIXEL_AXIS, make_mesh
from .sharded import build_sharded_fns


@functools.partial(jax.jit, static_argnames=("num_colors", "population"))
def _kmeans_seeds_batch(keys, images, num_colors, population):
    """(B, pop, K, 3) per-image k-means seed palettes (module-level jit so
    repeated same-shape batches hit the compile cache)."""
    from ..ops.kmeans import kmeans_init_palettes

    return jax.vmap(
        lambda k, im: kmeans_init_palettes(
            k, im.reshape(-1, 3), num_colors, population
        )
    )(keys, images)


@functools.partial(jax.jit, static_argnames=("space", "iters"))
def _polish_batch(images, palettes, wp, space, iters):
    """Per-image Lloyd polish (ops.assign.polish_palette), batch-vmapped."""
    from ..ops.assign import polish_palette

    return jax.vmap(
        lambda im, pal: polish_palette(
            im.reshape(-1, 3), pal, space, wp, iters
        )
    )(images, palettes)


class ShardedBatchQuantizer:
    """Quantize a batch of same-resolution images across a device mesh.

    Usage:
        mesh = make_mesh(n_data=2, n_pixel=4)
        q = ShardedBatchQuantizer(QuantizationConfig(...), mesh)
        palettes, info = q.find_palettes(images)     # images: (B, H, W, 3)
        out = q.quantize(images, palettes)
    """

    def __init__(self, config: QuantizationConfig | None = None, mesh=None):
        """Rows of each image are sharded over the "pixel" axis (XLA path,
        parallel.sharded); any height is padded to the shard multiple."""
        self.config = config or QuantizationConfig()
        self.mesh = mesh if mesh is not None else make_mesh(1, None)
        self.filters = build_filters(
            self.config.scielab.dpi, self.config.scielab.viewing_distance_cm
        )
        self._prepare, self._init, self._chunk, self._quantize = build_sharded_fns(
            self.mesh, self.config, self.filters
        )
        self._error_fn = None

    @property
    def n_data(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def n_pixel(self) -> int:
        return self.mesh.shape[PIXEL_AXIS]

    @property
    def n_pop(self) -> int:
        """Population (EP) mesh-axis size; 1 when the mesh has no pop axis
        (e.g. multihost.distributed_mesh). See parallel.population."""
        from .mesh import POP_AXIS

        return dict(self.mesh.shape).get(POP_AXIS, 1)

    def _check(self, images) -> None:
        """Input validation (batch/channel shape only); the row path pads
        arbitrary H in _pad_rows, raising only when padding is infeasible."""
        B, H, W, C = images.shape
        if C != 3:
            raise ValueError("images must be (B, H, W, 3)")
        if B % self.n_data:
            raise ValueError(f"batch {B} not divisible by data axis {self.n_data}")

    def _row_plan(self, H: int) -> int:
        """Padded height for the row-sharded path: the smallest multiple of
        n_pixel whose strips are >= the filter half-width. When padding is
        needed at all, it must be >= half_width rows: only the first `pad`
        pad rows are exact reflections of the true bottom edge, so every
        valid row's vertical-conv context must come from pad rows (the halo
        logic reflects at the PADDED boundary, which is wrong for context
        beyond the pad). Raises when the symmetric pad would exceed the
        image extent (jnp.pad limit)."""
        n = self.n_pixel
        half = self.filters.half_width
        H_pad = max(-(-H // n) * n, half * n)
        if H_pad > H:
            H_pad = max(H_pad, -(-(H + half) // n) * n)
        if H_pad - H > H:
            raise ValueError(
                f"height {H} too short to row-shard over {n} devices: strips "
                f"must be >= the filter half-width {self.filters.half_width} "
                f"and the symmetric pad of {H_pad - H} rows exceeds the image; "
                f"use a smaller pixel axis"
            )
        return H_pad

    def _pad_rows(self, images):
        """(padded (B, H_pad, W, 3), H_true) for the row-sharded path.

        mode="symmetric" pad rows are mirror duplicates of real rows: they
        give the true bottom edge exactly the reference's half-sample
        reflection context (OptimizedConvolution.cl:21-27 semantics), cannot
        introduce new palette usage, and are masked out of the Delta-E mean
        via h_valid (parallel.sharded.make_strip_fitness)."""
        B, H, W, _ = images.shape
        H_pad = self._row_plan(H)
        if H_pad == H:
            return images, H
        return (
            jnp.pad(
                images, ((0, 0), (0, H_pad - H), (0, 0), (0, 0)),
                mode="symmetric",
            ),
            H,
        )

    def _to_global(self, arr, dtype=jnp.float32):
        """Host array -> device array, multi-host-correct.

        Single process: a plain device transfer. Multi-process (pod slice):
        every host holds the SAME full batch (the CLI loads the same input
        list everywhere, and keys/palettes derive deterministically from
        seeds); each process materializes only its addressable shards of a
        batch-sharded global array, so no host ships data it does not own.
        """
        if jax.process_count() == 1:
            return jnp.asarray(arr, dtype)
        from jax.sharding import NamedSharding, PartitionSpec as P

        arr = np.asarray(jax.device_get(arr)).astype(dtype)
        sharding = NamedSharding(self.mesh, P(DATA_AXIS))
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    def _fetch(self, x):
        """device_get that works on cross-host-sharded arrays.

        Multi-process arrays are not fully addressable locally; gather them
        to every host first (init/telemetry-rate data only — small)."""
        if jax.process_count() == 1:
            return jax.device_get(x)
        from jax.experimental import multihost_utils

        return jax.device_get(
            jax.tree.map(
                lambda a: multihost_utils.process_allgather(a, tiled=True), x
            )
        )

    def find_palettes(self, images, seeds=None, progress=None, chunk_size=None):
        """(B, K, 3) palettes + info. images: (B, H, W, 3) float sRGB."""
        cfg = self.config
        images = self._to_global(images)
        self._check(images)
        B = images.shape[0]
        if seeds is None:
            seeds = np.arange(B, dtype=np.uint32) + cfg.seed
        seeds = np.asarray(seeds, np.uint32)
        # Keys derive deterministically from seeds on every host, then become
        # batch-sharded global arrays like the images. k-means seeding takes
        # the second half of a split, as HybridQuantizer.find_palette does,
        # so one image gets the same run on any mesh and on one device.
        keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
        km_keys = None
        if cfg.init == "kmeans":
            pairs = jax.vmap(jax.random.split)(keys)
            keys, km_keys = pairs[:, 0], pairs[:, 1]
        keys = self._to_global(keys, jnp.uint32)

        prepare, init_fn, chunk_fn = self._prepare, self._init, self._chunk
        run_images, h_valid = self._pad_rows(images)
        if run_images is images:
            h_valid = None

        init_colors = None
        if cfg.init == "kmeans":
            # Seeds come from the ORIGINAL pixels (no mirror-duplicate rows).
            init_colors = _kmeans_seeds_batch(
                self._to_global(km_keys, jnp.uint32), images,
                cfg.swasa.num_colors, cfg.swasa.population,
            )
        elif cfg.init != "random":
            raise ValueError(f"unknown init {cfg.init!r}")

        targets = prepare(run_images)
        if h_valid is None:
            state = init_fn(run_images, targets, keys, init_colors)
        else:
            state = init_fn(run_images, targets, keys, init_colors, h_valid)

        imax = cfg.swasa.imax
        chunk = chunk_size or max(cfg.progress_every, 1)
        done = 0
        start = time.time()
        traj = []
        while done < imax:
            n = min(chunk, imax - done)
            if h_valid is None:
                state, telemetry = chunk_fn(state, run_images, targets, n)
            else:
                state, telemetry = chunk_fn(
                    state, run_images, targets, n, h_valid
                )
            done += n
            traj.append(self._fetch(telemetry["best_error"][:, -1]))
            if progress is not None:
                elapsed = time.time() - start
                stats = {
                    "best_error_mean": float(np.mean(traj[-1])),
                    "eta_s": elapsed / done * (imax - done),
                }
                if progress(done, imax, stats) is False:
                    break

        info = {
            "best_errors": np.asarray(self._fetch(state.best_error)),
            "iterations": done,
            "seconds": time.time() - start,
            "state": state,
        }
        return self._fetch(state.best_colors), info

    def quantize(self, images, palettes):
        images = self._to_global(images)
        B, H, W, _ = images.shape
        pad = (-H) % self.n_pixel
        if pad:
            # The final assignment pass is pointwise — pad content is
            # irrelevant (cropped below); "edge" mode has no extent limit.
            images_p = jnp.pad(
                images, ((0, 0), (0, pad), (0, 0), (0, 0)), mode="edge"
            )
            return self._quantize(images_p, self._to_global(palettes))[:, :H]
        return self._quantize(images, self._to_global(palettes))

    # -- batch error-image mode ---------------------------------------------

    def _build_error_fn(self):
        from functools import partial

        from jax import lax
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        from .. import colorspace as cs
        from ..scielab import transform as sct
        from .sharded import strip_scielab

        mats_h, mats_v = sct.band_matrices(self.filters)
        half = self.filters.half_width
        wp = jnp.asarray(cs.WHITEPOINTS[self.config.scielab.whitepoint])
        de_fn = cs.DELTA_E_FNS[self.config.deltaE]
        img_spec = P(DATA_AXIS, PIXEL_AXIS)
        mesh = self.mesh

        # Band matrices as traced args (not closure constants): constants
        # feeding the banded einsum stall XLA's constant folding.
        @jax.jit
        def _err_fn(orig, quant, h_valid, mh, mv):
            def body(o_local, q_local, hv, mh, mv):
                def per_image(o, q):
                    lab_o = strip_scielab(o, mh, mv, half, wp)
                    lab_q = strip_scielab(q, mh, mv, half, wp)
                    e = de_fn(lab_o, lab_q)
                    Hs = o.shape[0]
                    i = lax.axis_index(PIXEL_AXIS)
                    row_ok = (i * Hs + jnp.arange(Hs)) < hv
                    s = lax.psum(
                        jnp.sum(jnp.where(row_ok[:, None], e, 0.0)), PIXEL_AXIS
                    )
                    mean = s / (hv.astype(jnp.float32) * o.shape[1])
                    # reference viz mapping ((255 - e)^2)/255^2
                    # (ImageManipulation.java:890)
                    viz = ((255.0 - e) ** 2) / (255.0**2)
                    return mean, jnp.repeat(viz[..., None], 3, axis=-1)

                return jax.vmap(per_image)(o_local, q_local)

            return shard_map(
                body, mesh=mesh,
                in_specs=(img_spec, img_spec, P(), P(), P()),
                out_specs=(P(DATA_AXIS), img_spec),
            )(orig, quant, jnp.asarray(h_valid, jnp.int32), mh, mv)

        def err_fn(orig, quant, h_valid):
            return _err_fn(orig, quant, h_valid, mats_h, mats_v)

        return err_fn

    def error_images(self, originals, quantized):
        """((B,) mean S-CIELAB Delta-E, (B, H, W, 3) viz) across the mesh.

        Batch counterpart of HybridQuantizer.error_image — the reference's
        error-image mode (HybridQuantization.java:139-182,
        ImageManipulation.computeError :858-894) including the
        ((255 - e)^2)/255^2 visualization (:890), with the S-CIELAB
        transforms row-sharded (halo exchange) and the mean combined by
        psum. Arbitrary H: rows are symmetric-padded to the shard multiple
        (correct reflection context, masked out of the mean, cropped from
        the viz). Both returns are host (NumPy) values: the viz must be
        gathered through _fetch because under a multi-process mesh the
        sharded global array is not fully addressable and np.asarray on it
        (e.g. the CLI save path) would fail.
        """
        originals = self._to_global(originals)
        quantized = self._to_global(quantized)
        if originals.shape != quantized.shape:
            raise ValueError(
                f"shape mismatch {originals.shape} vs {quantized.shape}"
            )
        self._check(originals)
        H = originals.shape[1]
        orig_p, _ = self._pad_rows(originals)
        quant_p, _ = self._pad_rows(quantized)
        if self._error_fn is None:
            self._error_fn = self._build_error_fn()
        mean, viz = self._error_fn(orig_p, quant_p, H)
        return self._fetch(mean), self._fetch(viz[:, :H])

    def polish(self, images, palettes, iters: int = 10):
        """Per-image Lloyd refinement (pipeline.HybridQuantizer.polish doc)."""
        from .. import colorspace as cs

        images = self._to_global(images)
        palettes = self._to_global(palettes)
        wp = jnp.asarray(cs.WHITEPOINTS[self.config.scielab.whitepoint])
        return _polish_batch(
            images, palettes, wp, self.config.assignment_space, iters
        )

    def run(self, images, seeds=None, progress=None, polish_iters: int = 0):
        """find_palettes + optional Lloyd polish + quantize.

        info["best_errors"] are the ANNEAL's final fitness values; with
        polish_iters > 0 the returned palettes/images are post-polish (the
        polish optimizes assignment-space MSE, a different objective), so
        info["palettes_polished"] flags that the errors describe the
        pre-polish palettes. Use error_images() on the outputs for the
        actual post-polish S-CIELAB Delta-E.
        """
        palettes, info = self.find_palettes(images, seeds, progress)
        info["palettes_polished"] = bool(polish_iters)
        if polish_iters:
            palettes = self._fetch(self.polish(images, palettes, polish_iters))
        out = self.quantize(images, palettes)
        info["palettes"] = palettes
        return self._fetch(out), info
