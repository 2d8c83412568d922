"""Device mesh setup (SURVEY.md §5.8).

The reference has no distributed code; this subsystem is built on
``jax.sharding.Mesh`` + ``shard_map``, with XLA collectives between devices
(NCCL over NVLink on a multi-GPU host).

Mesh axes used by the framework:
  * ``"d"`` -- data/shard axis: reads are data-parallel over it, and the
    k-mer hash space is range-partitioned over it (each device owns the
    k-mers whose hash-prefix == its index).
  * ``"s"`` (optional) -- sequence axis for long-contig sequence
    parallelism with (k-1)-base halo exchange (see parallel.halo).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              seq_shards: int = 1) -> Mesh:
    """Build a ("d",) or ("d", "s") mesh over the first n_devices devices."""
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if seq_shards == 1:
        return Mesh(np.asarray(devices[:n]), axis_names=("d",))
    if n % seq_shards:
        raise ValueError(f"n={n} not divisible by seq_shards={seq_shards}")
    arr = np.asarray(devices[:n]).reshape(n // seq_shards, seq_shards)
    return Mesh(arr, axis_names=("d", "s"))


def batch_sharding(mesh: Mesh):
    """Sharding for a [batch, ...] array: batch split over 'd'."""
    return NamedSharding(mesh, P("d"))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def process_local_batch(global_batch: int, mesh: Mesh) -> int:
    """Per-device batch size (ceil)."""
    d = mesh.shape["d"]
    return (global_batch + d - 1) // d


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up: jax.distributed.initialize (SURVEY.md §5.8).

    Pass the coordinator address, process count and process id explicitly
    (nothing in a plain GPU host or a CPU multi-process simulation tells
    JAX of a cluster).  Call before any other JAX
    API.  After this, jax.devices() spans all hosts and make_mesh() builds
    a global mesh; each process feeds its local shard of every batch
    (process_index-based loading, see `local_read_slice`).
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def local_read_slice(global_batch: int) -> slice:
    """The slice of each global read batch this process should load
    (data-parallel host loading, jax.process_index)."""
    n = jax.process_count()
    i = jax.process_index()
    per = (global_batch + n - 1) // n
    return slice(i * per, min((i + 1) * per, global_batch))


def make_global_array(local_rows: "np.ndarray", mesh: Mesh):
    """Assemble a process-local [B_local, L] block into a global array
    sharded over 'd' (jax.make_array_from_process_local_data)."""
    from jax.sharding import NamedSharding, PartitionSpec

    sharding = NamedSharding(mesh, PartitionSpec("d"))
    return jax.make_array_from_process_local_data(sharding, local_rows)
