"""Configuration dataclasses — the framework's entire parameter surface.

Mirrors every parameter of the reference's EzPlug GUI panel with its default
value, range, and meaning (HybridQuantization.java:185-257); defaults are the
GUI defaults (SURVEY.md section 2b). These are frozen (hashable) so they can
be passed as static arguments to jitted entry points.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SWASAConfig:
    """Annealing parameters (HybridQuantization.java:196-225)."""

    num_colors: int = 8          # palette size K            (:192)
    population: int = 4          # candidate palettes        (:197)
    imax: int = 5000             # max iterations            (:199)
    delta: float = 2.0           # unused-color penalty      (:201)
    convergence: bool = True     # population convergence    (:204)
    conv_delay: float = 0.75     # convergence delay         (:206)
    conv_spread: float = 0.15    # convergence spread        (:208)
    t0: float = 20.0             # initial temperature       (:212)
    i_tc: int = 20               # iterations per temp step  (:214)
    alpha: float = 0.9           # cooling coefficient       (:216)
    s0: float = 100.0            # initial max step width    (:223)
    beta: float = 5.3            # step-width adaptation     (:224)


@dataclasses.dataclass(frozen=True)
class ScielabConfig:
    """Human-visual-system model parameters (HybridQuantization.java:228-235)."""

    dpi: int = 72                      # screen dpi          (:229)
    viewing_distance_cm: float = 45.0  # viewing distance    (:231)
    whitepoint: str = "D65"            # D65 | D50           (:233)


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Full engine configuration.

    deltaE: fitness Delta-E formula; the reference plugin hardcodes CIE76
      (HybridQuantization.java:96,145) and selects it at OpenCL compile time
      (ImageManipulation.java:63). CIE94 and CIEDE2000 are also available.
    assignment_space: "srgb" reproduces the reference's Euclidean-in-sRGB
      palette assignment (OptimizedConvolution.cl:155,180); "lab" assigns by
      CIELAB Delta-E76 (the BASELINE north-star kernel).
    precision: nearest-palette score precision —
      "highest" (true f32 scores),
      "f32x3" (XLA path: hi/lo bf16 split, 3 bf16 dots, |err| ~2^-18 |s|
      ~ 1e-6 — assignment flips only on score gaps below that; the fused
      GPU kernel computes in f32 for this mode; the default),
      "bf16" (fast mode: pixel and palette features rounded to bf16, f32
      accumulation; flips ~0.7% of assignments, and its mean-deltaE cost
      grows with image size and K — use f32x3 whenever quality matters).
      The reference computes f32 distances (OptimizedConvolution.cl:155).
    use_pallas: nearest-palette implementation (runtime.assign_kernel) —
      "auto" runs the fused Pallas kernel (ops.triton_assign) on a GPU and
      XLA elsewhere; "on" requires the kernel (raises off a GPU); "off"
      always runs XLA.
    """

    swasa: SWASAConfig = SWASAConfig()
    scielab: ScielabConfig = ScielabConfig()
    deltaE: str = "CIE76"
    assignment_space: str = "srgb"
    precision: str = "f32x3"      # "highest" | "f32x3" | "bf16"
    init: str = "random"        # "random" (reference parity, SWASA.java:40-52)
                                # | "kmeans" (histogram-weighted k-means
                                # seeds, ops/kmeans.py — beyond-reference)
    verbose: bool = False
    seed: int = 0
    progress_every: int = 10      # host progress cadence (ImageManipulation.java:546)
    use_pallas: str = "auto"      # "auto" (GPU kernel) | "on" | "off"
