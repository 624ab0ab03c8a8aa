"""Pixel-sharded, image-batched SWASA under `shard_map`.

Distribution of the engine over a device mesh (SURVEY.md section 2f):

  - mesh ("data", "pixel"): images of a batch over "data" (DP), rows of each
    image over "pixel" (the CP-analog axis)
  - every per-pixel stage (assignment, filtering, Delta-E) runs on local row
    strips; the separable convolution exchanges `half` halo rows between
    devices via ppermute (parallel.halo); the error mean and usage flags
    combine with one psum each — the equivalent of the reference's full-image
    device->host
    error readback + multithreaded CPU sum (ImageManipulation.java:667-714),
    which never leaves the device here
  - annealing state (palettes, temperatures, PRNG keys) is replicated over
    "pixel" and sharded over "data": every device computes identical
    proposals/acceptance from the same key, so no extra communication

Constraints: H must divide evenly by the pixel-axis size, and each strip
must be at least `filters.half_width` rows tall.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .. import colorspace as cs
from ..config import QuantizationConfig
from ..ops import assign as assign_ops
from ..scielab import transform as sct
from ..scielab.filters import ScielabFilters
from ..swasa import loop as swasa_loop
from ..swasa import schedule
from .halo import exchange_row_halos
from .mesh import DATA_AXIS, PIXEL_AXIS, POP_AXIS
from .population import shard_population
from ..ops.band_conv import conv_h_banded, conv_v_banded_valid


def scielab_filter_strip(
    opp_strip_chw, mats_h, mats_v, half: int, axis_name=PIXEL_AXIS
):
    """S-CIELAB filtering of a (3, Hs, W) row strip with halo exchange.

    Horizontal pass: banded matmul conv with reflection (rows are complete
    locally). Vertical pass: exchange `half` halo rows (reflected
    only at true image edges), then a VALID-mode banded conv.
    """
    x7 = jnp.concatenate([opp_strip_chw, opp_strip_chw, opp_strip_chw[:1]], axis=0)
    t = conv_h_banded(x7, mats_h, half)
    top, bottom = exchange_row_halos(t, half, axis_name)
    t_ext = jnp.concatenate([top, t, bottom], axis=1)
    y = conv_v_banded_valid(t_ext, mats_v, half)
    out = y[:3] + y[3:6]
    return out.at[0].add(y[6])


def strip_scielab(image_strip_hwc, mats_h, mats_v, half, whitepoint, axis_name=PIXEL_AXIS):
    """sRGB strip (Hs, W, 3) -> S-CIELAB strip (Hs, W, 3), sharded."""
    opp = cs.xyz_to_opp(cs.srgb_to_xyz(image_strip_hwc))
    filtered = scielab_filter_strip(
        jnp.moveaxis(opp, -1, 0), mats_h, mats_v, half, axis_name
    )
    return cs.opp_to_lab(jnp.moveaxis(filtered, 0, -1), whitepoint)


def make_strip_fitness(
    image_strip_hwc, target_lab_strip, mats_h, mats_v, half, whitepoint,
    cfg: QuantizationConfig, h_valid=None, axis_name=PIXEL_AXIS,
):
    """Per-palette fitness on a row strip; collectives combine shards.

    Same math as pipeline.make_fitness, plus one psum for the error sum and
    one for the usage OR (global penalty needs a cross-shard OR of used-color
    flags — SURVEY.md section 5 "collectives needed").

    h_valid: optional traced int32 — the TRUE global image height when the
    batch was row-padded to the shard multiple (ShardedBatchQuantizer pads
    with mode="symmetric", so pad rows are mirror duplicates of real rows:
    they give the true bottom edge exactly the reference's half-sample
    reflection context and cannot introduce new palette usage). Rows with
    global index >= h_valid are masked out of the Delta-E mean.
    """
    Hs, W, _ = image_strip_hwc.shape
    de_fn = cs.DELTA_E_FNS[cfg.deltaE]
    lab_assign = cfg.assignment_space == "lab"
    pixels = image_strip_hwc.reshape(-1, 3)
    assign_pixels = cs.srgb_to_lab(pixels, whitepoint) if lab_assign else pixels

    def fitness(palette):
        pal_feats = cs.srgb_to_lab(palette, whitepoint) if lab_assign else palette
        idx = assign_ops.nearest_palette(assign_pixels, pal_feats)
        local_usage = assign_ops.palette_usage(idx, palette.shape[0])
        usage = lax.psum(local_usage.astype(jnp.int32), axis_name) > 0

        # Planar gather (see pipeline.make_fitness: avoids 42x lane padding)
        opp_palette = cs.srgb_to_opp(palette)
        q_opp_chw = opp_palette.T[:, idx].reshape(3, Hs, W)
        q_lab = cs.opp_to_lab(
            jnp.moveaxis(
                scielab_filter_strip(
                    q_opp_chw, mats_h, mats_v, half, axis_name
                ),
                0, -1,
            ),
            whitepoint,
        )
        de = de_fn(target_lab_strip, q_lab)
        if h_valid is None:
            local_err = jnp.sum(de)
            total = jnp.float32(Hs * W * lax.axis_size(axis_name))
        else:
            i = lax.axis_index(axis_name)
            row_ok = (i * Hs + jnp.arange(Hs)) < h_valid
            local_err = jnp.sum(jnp.where(row_ok[:, None], de, 0.0))
            total = h_valid.astype(jnp.float32) * W
        err = lax.psum(local_err, axis_name) / total
        err = err + schedule.unused_penalty(usage, cfg.swasa.delta)
        return err, usage

    return fitness


# ---------------------------------------------------------------------------
# Batched + sharded runners (jit entry points)
# ---------------------------------------------------------------------------

def build_sharded_fns(mesh, cfg: QuantizationConfig, filters: ScielabFilters):
    """Compile-ready (prepare, init, chunk, quantize) closures for a mesh.

    All take/return GLOBAL arrays; sharding is expressed with shard_map
    in/out specs: images (B, H, W, 3) P(data, pixel), per-image state
    P(data) (replicated over pixel).
    """
    mats_h, mats_v = sct.band_matrices(filters)
    half = filters.half_width
    wp = jnp.asarray(cs.WHITEPOINTS[cfg.scielab.whitepoint])
    n_pop = dict(mesh.shape).get(POP_AXIS, 1)  # EP axis (parallel.population)
    if cfg.swasa.population % n_pop:
        raise ValueError(
            f"population {cfg.swasa.population} not divisible by the pop "
            f"mesh axis ({n_pop})"
        )
    img_spec = P(DATA_AXIS, PIXEL_AXIS)
    state_spec = P(DATA_AXIS)

    def _image_fitness(img, tgt, hv):
        fitness = make_strip_fitness(
            img, tgt, mats_h, mats_v, half, wp, cfg, h_valid=hv
        )
        if n_pop == 1:
            return fitness
        return shard_population(
            swasa_loop.as_population_fitness(fitness),
            cfg.swasa.population, n_pop, POP_AXIS,
        )

    def _sm(fn, in_specs, out_specs):
        return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

    # -- target S-CIELAB of the originals (once per batch) ------------------
    # Band matrices as traced args (not closure constants): constants
    # feeding the HIGHEST banded einsum trigger multi-second XLA
    # constant-folding stalls on first compile.
    @jax.jit
    def _prepare(images, mh, mv):  # (B, H, W, 3) -> (B, H, W, 3) target LAB
        def body(imgs_local, mh, mv):
            return jax.vmap(
                lambda im: strip_scielab(im, mh, mv, half, wp)
            )(imgs_local)

        return _sm(body, (img_spec, P(), P()), img_spec)(images, mh, mv)

    def prepare(images):
        return _prepare(images, mats_h, mats_v)

    # -- init: palettes + initial fitness ------------------------------------
    # init_colors: optional (B, pop, K, 3) seed palettes (e.g. ops.kmeans);
    # None = the reference's uniform-random init. h_valid: optional traced
    # () int32 true image height when the batch is row-padded (replicated;
    # make_strip_fitness doc).
    @jax.jit
    def init(images, targets, keys, init_colors=None, h_valid=None):
        def body(imgs_local, tgt_local, keys_local, *rest):
            rest = list(rest)
            hv = rest.pop() if h_valid is not None else None
            def per_image(img, tgt, key, *colors):
                fitness = _image_fitness(img, tgt, hv)
                return swasa_loop.init_state(
                    key, fitness, cfg.swasa, colors[0] if colors else None
                )

            return jax.vmap(per_image)(imgs_local, tgt_local, keys_local, *rest)

        in_specs = [img_spec, img_spec, state_spec]
        args = [images, targets, keys]
        if init_colors is not None:
            in_specs.append(state_spec)
            args.append(init_colors)
        if h_valid is not None:
            in_specs.append(P())
            args.append(jnp.asarray(h_valid, jnp.int32))
        return _sm(body, tuple(in_specs), state_spec)(*args)

    # -- one scan chunk of num_iters annealing iterations -------------------
    @functools.partial(jax.jit, static_argnames=("num_iters",))
    def chunk(state, images, targets, num_iters, h_valid=None):
        def body(state_local, imgs_local, tgt_local, *rest):
            hv = rest[0] if h_valid is not None else None
            def per_image(st, img, tgt):
                fitness = _image_fitness(img, tgt, hv)
                return swasa_loop.run_chunk(st, fitness, cfg.swasa, num_iters)

            return jax.vmap(per_image)(state_local, imgs_local, tgt_local)

        in_specs = [state_spec, img_spec, img_spec]
        args = [state, images, targets]
        if h_valid is not None:
            in_specs.append(P())
            args.append(jnp.asarray(h_valid, jnp.int32))
        return _sm(
            body, tuple(in_specs), (state_spec, state_spec),
        )(*args)

    # -- final quantize pass ------------------------------------------------
    @jax.jit
    def quantize(images, palettes):  # (B,H,W,3), (B,K,3) -> (B,H,W,3)
        def body(imgs_local, pals_local):
            def per_image(img, pal):
                if cfg.assignment_space == "lab":
                    feats = cs.srgb_to_lab(img, wp)
                    pal_feats = cs.srgb_to_lab(pal, wp)
                else:
                    feats, pal_feats = img, pal
                idx = assign_ops.nearest_palette(feats.reshape(-1, 3), pal_feats)
                return pal[idx].reshape(img.shape)

            return jax.vmap(per_image)(imgs_local, pals_local)

        return _sm(body, (img_spec, state_spec), img_spec)(images, palettes)

    return prepare, init, chunk, quantize
