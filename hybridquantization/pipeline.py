"""End-to-end quantization engine.

The equivalent of the reference's driver flow
(HybridQuantization.quantization, HybridQuantization.java:93-137):

  1. build the S-CIELAB filter bank (host, init-time)
  2. S-CIELAB transform of the original image (device, once)
  3. SWASA search for the best palette (device `lax.scan`, chunked)
  4. final nearest-palette quantize pass
  5. optional Delta-E error image (HybridQuantization.java:139-182)

Everything per-iteration stays on device; the host only sees scalar
telemetry between scan chunks (progress/ETA/verbose parity with
ImageManipulation.java:533-567) and can cooperatively cancel via the
progress callback (the reference's stopFlag, HybridQuantization.java:312-318).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import colorspace as cs
from . import runtime
from .config import QuantizationConfig
from .ops import assign as assign_ops
from .ops import triton_assign
from .scielab import transform as sct
from .scielab.filters import ScielabFilters, build_filters
from .swasa import loop as swasa_loop
from .swasa import schedule
from .swasa.state import SWASAState

@jax.jit
def _dither_perturb_jit(image_hwc, palette, strength):
    """sRGB Bayer perturbation (single source: ops.assign.dither_perturbation)."""
    return assign_ops.dither_perturbation(image_hwc, palette, strength)


# ProgressFn(iteration, imax, telemetry) -> bool: return False to stop early.
ProgressFn = Callable[[int, int, dict], bool]


def _make_context(
    image_hwc: jnp.ndarray,
    filters: ScielabFilters,
    cfg: QuantizationConfig,
    kernel: str | None = None,
):
    """Device-resident per-image constants for the fitness function.

    kernel: "triton" or "xla" (runtime.assign_kernel decides when None).
    With "triton" the context also holds the planar pixel features the
    assignment kernel reads, packed once per image rather than once per
    fitness evaluation.
    """
    if kernel is None:
        kernel = runtime.assign_kernel(cfg.use_pallas, cfg.swasa.num_colors)
    wp = jnp.asarray(cs.WHITEPOINTS[cfg.scielab.whitepoint])
    image_hwc = jnp.asarray(image_hwc, jnp.float32)
    pixels = image_hwc.reshape(-1, 3)
    if cfg.assignment_space == "lab":
        assign_pixels = cs.srgb_to_lab(pixels, wp)
    elif cfg.assignment_space == "srgb":
        assign_pixels = pixels
    else:
        raise ValueError(f"unknown assignment_space {cfg.assignment_space!r}")

    mats_h, mats_v = sct.band_matrices(filters)
    half = filters.half_width
    opp = cs.xyz_to_opp(cs.srgb_to_xyz(image_hwc))
    target_lab = cs.opp_to_lab(
        jnp.moveaxis(
            sct.scielab_filter_banded(
                jnp.moveaxis(opp, -1, 0), mats_h, mats_v, half
            ),
            0,
            -1,
        ),
        wp,
    )
    ctx = {
        "assign_pixels": assign_pixels,
        "target_lab": target_lab,
        "mats_h": mats_h,
        "mats_v": mats_v,
        "whitepoint": wp,
    }
    if kernel == "triton":
        ctx["x_planar"] = triton_assign.pack_pixels(assign_pixels)
    elif kernel != "xla":
        raise ValueError(f"unknown assignment kernel {kernel!r}")
    return ctx


def _fitness_tail(ctx: dict, cfg: QuantizationConfig, half: int, q_opp_chw, usage):
    """Quantized opponent image (3, H, W) + usage -> scalar fitness.

    S-CIELAB filter, Opp->LAB, Delta-E against the target and the mean, plus
    the unused-colour penalty: the reference's computeScielabKernelsTemp/End
    -> Opp2LAB -> CIEDE -> mean (ImageManipulation.java:620-727).
    """
    q_lab = cs.opp_to_lab(
        jnp.moveaxis(
            sct.scielab_filter_banded(q_opp_chw, ctx["mats_h"], ctx["mats_v"], half),
            0,
            -1,
        ),
        ctx["whitepoint"],
    )
    err = jnp.mean(cs.DELTA_E_FNS[cfg.deltaE](ctx["target_lab"], q_lab))
    return err + schedule.unused_penalty(usage, cfg.swasa.delta)


def make_fitness(
    ctx: dict, cfg: QuantizationConfig, half: int = 10
) -> swasa_loop.FitnessFn:
    """Palette -> (scalar fitness, usage) on one image context (XLA path).

    Fuses the reference's per-evaluation device pipeline
    (quantizeAndConvertToOpp -> computeScielabKernelsTemp/End -> Opp2LAB ->
    CIEDE -> mean + penalty; ImageManipulation.java:620-727) into a single
    XLA-compiled function with an on-device mean. `half` is the filter
    half-width (static; filters.half_width).
    """
    H, W, _ = ctx["target_lab"].shape
    lab_assign = cfg.assignment_space == "lab"

    def fitness(palette: jax.Array):
        pal_feats = (
            cs.srgb_to_lab(palette, ctx["whitepoint"]) if lab_assign else palette
        )
        idx = assign_ops.nearest_palette(
            ctx["assign_pixels"], pal_feats, precision=cfg.precision
        )
        usage = assign_ops.palette_usage(idx, palette.shape[0])

        # Gather the *precomputed* opponent-space palette instead of
        # gamma-expanding the winning color per pixel
        # (OptimizedConvolution.cl:194-198 does the latter; K << P makes the
        # palette-side conversion free). Planar (3, P) gather, so the filter
        # reads channel planes directly.
        opp_palette = cs.srgb_to_opp(palette)
        q_opp_chw = opp_palette.T[:, idx].reshape(3, H, W)
        return _fitness_tail(ctx, cfg, half, q_opp_chw, usage), usage

    return fitness


def make_population_fitness(
    ctx: dict, cfg: QuantizationConfig, half: int = 10, interpret: bool = False
):
    """(pop, K, 3) palettes -> ((pop,) errors, (pop, K) usage).

    When the context carries packed pixels (`_make_context` with the
    "triton" kernel), assignment, winner gather and usage for the whole
    population run in one fused kernel (ops.triton_assign) with the
    population as a grid axis, followed by the XLA filter tail of
    `make_fitness`. Otherwise it is the vmapped XLA `make_fitness`.
    `interpret` runs the kernel in the Pallas interpreter (tests only).
    """
    if "x_planar" not in ctx:
        fn = jax.vmap(make_fitness(ctx, cfg, half))
        fn.is_population = True
        return fn

    H, W, _ = ctx["target_lab"].shape
    lab_assign = cfg.assignment_space == "lab"

    def pop_fitness(palettes: jax.Array):
        pal_feats = (
            jax.vmap(lambda p: cs.srgb_to_lab(p, ctx["whitepoint"]))(palettes)
            if lab_assign
            else palettes
        )
        _, q_opp, usage = triton_assign.assign_population(
            ctx["x_planar"],
            pal_feats,
            jax.vmap(cs.srgb_to_opp)(palettes),
            H * W,
            precision=cfg.precision,
            interpret=interpret,
        )
        errors = jax.vmap(
            lambda q, u: _fitness_tail(ctx, cfg, half, q.reshape(3, H, W), u)
        )(q_opp, usage)
        return errors, usage

    pop_fitness.is_population = True
    return pop_fitness


@functools.partial(jax.jit, static_argnames=("cfg", "half"))
def _init_jit(
    key, ctx, cfg: QuantizationConfig, half: int = 10, init_colors=None
) -> SWASAState:
    return swasa_loop.init_state(
        key, make_population_fitness(ctx, cfg, half), cfg.swasa, init_colors
    )


@functools.partial(jax.jit, static_argnames=("cfg", "num_iters", "half"))
def _chunk_jit(state, ctx, cfg: QuantizationConfig, num_iters: int, half: int = 10):
    return swasa_loop.run_chunk(
        state, make_population_fitness(ctx, cfg, half), cfg.swasa, num_iters
    )


class HybridQuantizer:
    """Drop-in engine mirroring the reference plugin's capabilities.

    Usage:
        q = HybridQuantizer(QuantizationConfig(...))
        palette, info = q.find_palette(image)          # (H, W, 3) sRGB float
        out = q.quantize(image, palette)
        mean_de, err_viz = q.error_image(image, out)
    """

    def __init__(self, config: QuantizationConfig | None = None):
        self.config = config or QuantizationConfig()
        self.filters = build_filters(
            self.config.scielab.dpi, self.config.scielab.viewing_distance_cm
        )
        self._whitepoint = cs.WHITEPOINTS[self.config.scielab.whitepoint]
        self.kernel = runtime.assign_kernel(
            self.config.use_pallas, self.config.swasa.num_colors
        )
        mats_h, mats_v = sct.band_matrices(self.filters)
        half = self.filters.half_width
        wp = jnp.asarray(self._whitepoint)

        # Band matrices as traced args (not closure constants): constants
        # feeding the HIGHEST banded einsum trigger multi-second XLA
        # constant-folding stalls on first compile.
        def _scielab(img, mh, mv):
            opp = cs.xyz_to_opp(cs.srgb_to_xyz(img))
            filtered = sct.scielab_filter_banded(
                jnp.moveaxis(opp, -1, 0), mh, mv, half
            )
            return cs.opp_to_lab(jnp.moveaxis(filtered, 0, -1), wp)

        # One compiled function per image shape (jit caches on shape).
        _scielab_inner = jax.jit(_scielab)
        self._scielab_jit = lambda img: _scielab_inner(img, mats_h, mats_v)
        de_fn = cs.DELTA_E_FNS[self.config.deltaE]

        def _error_image(orig, quant, mh, mv):
            e = de_fn(
                _scielab(orig, mh, mv), _scielab(quant, mh, mv)
            )
            viz = ((255.0 - e) ** 2) / (255.0**2)
            return jnp.mean(e), jnp.repeat(viz[..., None], 3, axis=-1)

        _error_inner = jax.jit(_error_image)
        self._error_image_jit = lambda o, q: _error_inner(o, q, mats_h, mats_v)
        self._quantize_jit = jax.jit(self._quantize_impl)

    # -- S-CIELAB -----------------------------------------------------------

    def scielab(self, image_hwc) -> jax.Array:
        """sRGB (H, W, 3) -> S-CIELAB (H, W, 3)."""
        return self._scielab_jit(jnp.asarray(image_hwc, jnp.float32))

    # -- Optimization -------------------------------------------------------

    def find_palette(
        self,
        image_hwc,
        key: jax.Array | None = None,
        progress: Optional[ProgressFn] = None,
        chunk_size: int | None = None,
        initial_state: SWASAState | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 500,
    ):
        """SWASA search for the best K-color palette.

        Returns (palette (K, 3) float32 sRGB, info dict with the fitness
        trajectory and final state). Pass `initial_state` (e.g. from
        checkpoint.load_state) to resume a run; `checkpoint_path` writes the
        state atomically every `checkpoint_every` iterations — the reference
        had no checkpointing (SURVEY.md section 5).
        """
        cfg = self.config
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        chunk = chunk_size or cfg.progress_every
        half = self.filters.half_width
        ctx = _make_context(image_hwc, self.filters, cfg, self.kernel)
        if initial_state is not None:
            state = initial_state
        else:
            init_colors = None
            if cfg.init == "kmeans":
                from .ops.kmeans import kmeans_init_palettes

                key, sub = jax.random.split(key)
                init_colors = kmeans_init_palettes(
                    sub,
                    jnp.asarray(image_hwc, jnp.float32).reshape(-1, 3),
                    cfg.swasa.num_colors,
                    cfg.swasa.population,
                )
            elif cfg.init != "random":
                raise ValueError(f"unknown init {cfg.init!r}")
            state = _init_jit(key, ctx, cfg, half, init_colors)

        imax = cfg.swasa.imax
        traj = []
        start = time.time()
        done = int(jax.device_get(state.iteration))
        if cfg.verbose:
            print(f"iter {done}/{imax}  best {float(state.best_error):.5f}")
        resumed_at = done
        last_ckpt = done
        while done < imax:
            n = min(chunk, imax - done)
            state, telemetry = _chunk_jit(state, ctx, cfg, n, half)
            done += n
            if checkpoint_path and done - last_ckpt >= checkpoint_every:
                from .checkpoint import save_state

                save_state(checkpoint_path, state)
                last_ckpt = done
            traj.append(jax.device_get(telemetry))
            if cfg.verbose:
                # Population stats parity (ImageManipulation.java:552-565).
                t = traj[-1]
                print(
                    f"iter {done}/{imax}  best {float(t['best_error'][-1]):.5f}"
                    f"  Population:  Mean : {float(t['mean_error'][-1]):.4f}"
                    f"  Best : {float(t['min_error'][-1]):.4f}"
                    f"  Std. Dev. : {float(t['std_error'][-1]):.4f}"
                )
            if progress is not None:
                elapsed = time.time() - start
                eta = elapsed / max(done - resumed_at, 1) * (imax - done)
                last = {k: float(v[-1]) for k, v in traj[-1].items()}
                last["eta_s"] = eta
                if progress(done, imax, last) is False:
                    break  # cooperative stop (reference stopFlag semantics)

        telemetry = {
            k: np.concatenate([t[k] for t in traj]) for k in traj[0]
        } if traj else {}
        info = {
            "best_error": float(jax.device_get(state.best_error)),
            "iterations": done,
            "telemetry": telemetry,
            "state": state,
            "seconds": time.time() - start,
        }
        if cfg.verbose:
            print(f"Final error : {info['best_error']:.5f}")
        return jax.device_get(state.best_colors), info

    # -- Palette refinement ---------------------------------------------------

    def polish(self, image_hwc, palette, iters: int = 10):
        """Lloyd (k-means) refinement of a palette in the assignment space.

        Beyond-reference feature (the reference's anneal is its only
        optimizer): each step moves every palette entry to the centroid of
        its assigned pixels — monotone in assignment-space MSE. In "lab"
        mode centroids are computed in CIELAB and mapped back to sRGB with
        gamut clamping. Note the SWASA fitness is the *spatial* S-CIELAB
        Delta-E, a different objective: polishing usually also lowers the
        mean Delta-E, but compare with error_image when it matters.
        """
        image = jnp.asarray(image_hwc, jnp.float32)
        palette = jnp.asarray(palette, jnp.float32)
        return assign_ops.polish_palette(
            image.reshape(-1, 3),
            palette,
            self.config.assignment_space,
            self._whitepoint,
            iters,
            use_kernel=self.kernel == "triton",
        )

    # -- Quantize / error image --------------------------------------------

    def _quantize_impl(self, image, palette):
        feats, pal_feats = image.reshape(-1, 3), palette
        if self.config.assignment_space == "lab":
            feats = cs.srgb_to_lab(feats, self._whitepoint)
            pal_feats = cs.srgb_to_lab(palette, self._whitepoint)
        if self.kernel == "triton":
            # The kernel gathers the winning sRGB colour itself.
            _, q, _ = triton_assign.assign_population(
                triton_assign.pack_pixels(feats), pal_feats[None],
                palette[None], feats.shape[0],
            )
            return q[0].T.reshape(image.shape)
        idx = assign_ops.nearest_palette(feats, pal_feats)
        return palette[idx].reshape(image.shape)

    def quantize(self, image_hwc, palette, dither: float = 0.0) -> jax.Array:
        """Apply a palette (nearest in the configured assignment space).

        dither > 0 perturbs the pixels with a tiled mean-zero Bayer
        threshold matrix scaled by the sRGB palette spacing BEFORE the
        nearest lookup (beyond-reference; reduces banding in smooth
        gradients at small K). The perturbation is in sRGB; the assignment
        itself still uses the configured assignment space. Strength is a
        traced scalar, so varying it never recompiles.
        """
        image = jnp.asarray(image_hwc, jnp.float32)
        pal = jnp.asarray(palette, jnp.float32)
        if dither > 0.0:
            image = _dither_perturb_jit(image, pal, jnp.float32(dither))
        return self._quantize_jit(image, pal)

    def error_image(self, original_hwc, quantized_hwc):
        """Mean S-CIELAB Delta-E + visualization image.

        Mirrors HybridQuantization.errorImage (HybridQuantization.java:139-182)
        and ImageManipulation.computeError (:858-894), including the
        ((255 - e)^2) / 255^2 visualization mapping (:890).
        """
        return self._error_image_jit(
            jnp.asarray(original_hwc, jnp.float32),
            jnp.asarray(quantized_hwc, jnp.float32),
        )

    # -- Full flow ----------------------------------------------------------

    def run(self, image_hwc, key=None, progress: Optional[ProgressFn] = None):
        """Full reference flow: palette search + quantize (+ metadata)."""
        palette, info = self.find_palette(image_hwc, key, progress)
        out = self.quantize(image_hwc, palette)
        info["palette"] = palette
        return jax.device_get(out), info
