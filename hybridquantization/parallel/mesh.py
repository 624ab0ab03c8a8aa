"""Device-mesh construction for the quantization engine.

The workload's three parallel axes (SURVEY.md section 2f):
  - "data":  independent images of a batch (DP; BASELINE configs 4-5)
  - "pop":   SWASA population members of one image (the EP analog — each
    shard evaluates its slice of the candidate palettes, results combined
    by one all_gather; useful when pop x images < devices)
  - "pixel": row-sharding of each image across devices (the CP/SP analog —
    the separable convolution needs a halo exchange across this axis)

The reference had no distributed backend at all (single JVM + one OpenCL
queue); collectives here are psum/ppermute/all_gather inside shard_map,
which XLA hands to NCCL on GPUs. The cards of one host are joined all to
all, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
POP_AXIS = "pop"
PIXEL_AXIS = "pixel"


def make_mesh(
    n_data: int = 1, n_pixel: int | None = None, devices=None, n_pop: int = 1
) -> Mesh:
    """(data, pop, pixel) mesh over the available devices.

    If n_pixel is None, uses all remaining devices for the pixel axis.
    The pop axis defaults to 1 (population evaluated device-locally); a
    size-1 axis is always present so engine code can address it uniformly.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_pixel is None:
        if len(devices) % (n_data * n_pop):
            raise ValueError(
                f"{len(devices)} devices not divisible by "
                f"n_data*n_pop={n_data * n_pop}"
            )
        n_pixel = len(devices) // (n_data * n_pop)
    need = n_data * n_pop * n_pixel
    if need > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_pop}x{n_pixel} needs {need} devices, "
            f"have {len(devices)}"
        )
    grid = np.array(devices[:need]).reshape(n_data, n_pop, n_pixel)
    return Mesh(grid, (DATA_AXIS, POP_AXIS, PIXEL_AXIS))


def batch_image_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W, 3) images: batch over data, rows over pixel."""
    return NamedSharding(mesh, P(DATA_AXIS, PIXEL_AXIS, None, None))


def batch_state_sharding(mesh: Mesh) -> NamedSharding:
    """Per-image annealing state: batch over data, replicated over pixel."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
