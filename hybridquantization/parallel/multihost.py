"""Multi-host runtime wiring.

The reference is a single-JVM, single-GPU program with no distributed
backend at all (SURVEY.md section 5). Here multi-host scale-out is the same
`shard_map` code as single-host: `jax.distributed.initialize` brings up the
cross-host runtime, the mesh spans all processes' devices, and the existing
psum/ppermute collectives run within a host and across hosts.

Mesh policy for >= 2 hosts (BASELINE config 5): the "data" axis spans hosts
(each host feeds its local images; the error/usage psums inside an image
never cross hosts) and the "pixel" axis stays within a host so the conv
halo ppermute never leaves it. `distributed_mesh` encodes that layout.

Each process must call `init_distributed` before any jax op, then only
interact with GLOBAL arrays (ShardedBatchQuantizer._to_global builds them:
every process holds the same host batch and materializes only its
addressable shards via make_array_from_callback; _fetch allgathers results
back). Proven by tests/test_multihost.py, which runs a real 2-process
jax.distributed CPU cluster and asserts equality with single-process.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import DATA_AXIS, PIXEL_AXIS


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the multi-host JAX runtime (idempotent).

    With no arguments, relies on the environment (JAX_COORDINATOR_ADDRESS
    etc.).

    MUST run before anything initializes XLA backends — even
    jax.process_count()/jax.devices() does, after which
    jax.distributed.initialize raises RuntimeError. The already-initialized
    check therefore inspects the distributed client directly.
    """
    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None:
        if is_init():
            return  # distributed runtime already up (idempotent)
    else:  # older JAX without the public probe
        from jax._src import distributed as _dist

        if getattr(_dist.global_state, "client", None) is not None:
            return
    # Cross-process collectives on the CPU backend need gloo (GPUs use
    # NCCL and ignore this flag). Set it only when CPU has been explicitly
    # forced, BEFORE the backend initializes.
    try:
        if (jax.config.jax_platforms or "") == "cpu":
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # older/newer jax without the option: use its default
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except ValueError:
        # single-process environment (e.g. local testing): nothing to do
        pass


def distributed_mesh(pixel_per_host: int | None = None) -> Mesh:
    """(data, pixel) mesh over all hosts' devices.

    The pixel axis is confined to one host (halo exchange stays local);
    the data axis = hosts x remaining local devices.
    """
    local = jax.local_device_count()
    n_pixel = pixel_per_host or local
    if local % n_pixel:
        raise ValueError(f"{local} local devices not divisible by pixel={n_pixel}")
    devices = np.array(jax.devices())  # globally ordered, process-major
    n_data = devices.size // n_pixel
    grid = devices.reshape(n_data, n_pixel)
    return Mesh(grid, (DATA_AXIS, PIXEL_AXIS))
