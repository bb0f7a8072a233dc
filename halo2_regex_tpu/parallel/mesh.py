"""Device mesh and distributed-runtime helpers.

The reference is single-threaded library code with no distributed components
(SURVEY §2 "Parallelism: NONE") — scaling is a first-class component here:
corpora shard data-parallel over a ``jax.sharding.Mesh``, transition tables
are replicated per device, and reductions ride XLA collectives (NCCL).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (``jax.distributed``). No-op for
    single-process runs; on a multi-host cluster each host calls this with
    the coordinator address, the process count and its own process id."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()


def make_mesh(
    data: Optional[int] = None,
    seq: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(data, seq)`` mesh over the available devices.

    ``data`` defaults to ``n_devices // seq``.  The cards of a host are
    joined all to all (NVLink), so the layout follows the algorithm alone:
    the data axis carries independent shards, the seq axis the
    boundary-state exchanges of a sharded long input.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if data is None:
        if n % seq != 0:
            raise ValueError(f"{n} devices not divisible by seq={seq}")
        data = n // seq
    if data * seq != n:
        raise ValueError(f"mesh {data}x{seq} != {n} devices")
    arr = np.asarray(devs).reshape(data, seq)
    return Mesh(arr, (DATA_AXIS, SEQ_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading batch dimension over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def batch_seq_sharding(mesh: Mesh) -> NamedSharding:
    """Shard batch over data and sequence-length over seq."""
    return NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch_size(global_batch: int, mesh: Mesh) -> Tuple[int, int]:
    """(per-shard batch, n_shards) for the data axis; global must divide."""
    n = mesh.shape[DATA_AXIS]
    if global_batch % n != 0:
        raise ValueError(f"batch {global_batch} not divisible by data axis {n}")
    return global_batch // n, n
