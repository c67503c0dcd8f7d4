"""Multi-host launch helpers.

The reference is a single MATLAB process; multi-host here means
`jax.distributed` + a global mesh whose "channel" (and optionally
"time") axes span hosts.  Channel fan-out needs no cross-host traffic
besides the initial placement; time-sharded acquisition exchanges
overlap-save halos between processes via the same ppermute path
validated on the virtual mesh (parallel/timeshard.py).
"""
from __future__ import annotations

import os

import jax


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed (no-op if already initialized or single
    process).  Arguments default to the JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID environment variables set by
    tools/launch_multihost.py (read explicitly — this jax version's
    initialize() does not consume them itself).  Nothing discovers a
    cluster on its own: give all three, by argument or environment."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def global_channel_mesh(axis: str = "channel"):
    """One-axis mesh over every addressable device across all hosts."""
    from bds3_tpu.parallel.mesh import make_mesh

    return make_mesh(len(jax.devices()), (axis,))
