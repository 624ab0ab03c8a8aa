"""Multi-chip distribution: mesh, halo exchange, sharded fitness, batch API."""

from .mesh import (
    DATA_AXIS,
    PIXEL_AXIS,
    POP_AXIS,
    make_mesh,
    batch_image_sharding,
    batch_state_sharding,
    replicated,
)
from .population import shard_population
from .halo import conv1d_vertical_sharded, exchange_row_halos
from .sharded import (
    build_sharded_fns,
    make_strip_fitness,
    scielab_filter_strip,
    strip_scielab,
)
from .batch import ShardedBatchQuantizer

__all__ = [
    "DATA_AXIS",
    "PIXEL_AXIS",
    "POP_AXIS",
    "shard_population",
    "make_mesh",
    "batch_image_sharding",
    "batch_state_sharding",
    "replicated",
    "conv1d_vertical_sharded",
    "exchange_row_halos",
    "build_sharded_fns",
    "make_strip_fitness",
    "scielab_filter_strip",
    "strip_scielab",
    "ShardedBatchQuantizer",
]
