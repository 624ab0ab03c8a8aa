"""hybridquantization — perceptual color quantization in JAX.

A from-scratch JAX/XLA/Pallas re-design of the hybrid color-quantization
scheme of Schaefer & Nolle ("A Hybrid Color Quantization Algorithm
Incorporating a Human Visual Perception Model"), with the same capabilities
as the reference Icy/OpenCL plugin (Helios77760/HybridQuantization):
S-CIELAB perceptual fitness, SWASA simulated annealing over candidate
palettes, nearest-palette assignment, and Delta-E error images — with a
fused Pallas assignment kernel for the GPU, XLA for the S-CIELAB fitness,
on-device `lax.scan` annealing, and `shard_map` pixel/population sharding
across devices.
"""

from .config import QuantizationConfig, ScielabConfig, SWASAConfig
from .pipeline import HybridQuantizer
from . import colorspace

__version__ = "0.1.0"

__all__ = [
    "HybridQuantizer",
    "QuantizationConfig",
    "SWASAConfig",
    "ScielabConfig",
    "colorspace",
]
