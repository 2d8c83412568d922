"""Sequence parallelism: long contigs sharded across chips with halo exchange.

SURVEY.md §5.7: the k-mer analog of context parallelism.  A long sequence is
split into contiguous blocks, one per device along a mesh axis; k-mer
windows that span a cut need the (k-1)-base prefix of the right neighbor's
block.  One ``jax.lax.ppermute`` ships that prefix left between devices -- no ring
attention / Ulysses-style machinery is needed: halo exchange is the entire
communication pattern (and for minimizers the halo is still k-1 bases,
since every w-mer of a k-mer lies inside the k-mer).

The last device's halo slot is filled with zero bytes -- invalid ASCII, so
windows past the global end are masked by the ordinary N machinery rather
than special-cased.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import kmer as kmer_ops


def halo_exchange(block: jnp.ndarray, halo: int, axis_name: str
                  ) -> jnp.ndarray:
    """Extend each device's [L] ASCII block with the next device's first
    `halo` bases: returns [L + halo].  The last device gets zero bytes
    (invalid -> masked windows)."""
    n = jax.lax.axis_size(axis_name)
    prefix = block[..., :halo]
    # send my prefix to my LEFT neighbor (device i -> i-1)
    perm = [(i, i - 1) for i in range(1, n)]
    nbr = jax.lax.ppermute(prefix, axis_name, perm)
    return jnp.concatenate([block, nbr], axis=-1)


def sharded_windows(block: jnp.ndarray, k: int, axis_name: str):
    """All k-mer windows of a sequence sharded over `axis_name`.

    block: [L_local] ASCII bytes (the device's contiguous piece).
    Returns KmerWindows over the extended block; window p (p < L_local) is
    the k-mer starting at global position device_index * L_local + p.
    """
    ext = halo_exchange(block, k - 1, axis_name)
    win = kmer_ops.kmer_windows(ext[None, :], k)
    L_local = block.shape[-1]
    idx = jnp.arange(ext.shape[-1], dtype=jnp.int32)
    valid = win.valid & (idx < L_local)[None, :]
    return kmer_ops.KmerWindows(fw=win.fw, rc=win.rc, valid=valid,
                                n_windows=L_local)


def sharded_windows_wide(block: jnp.ndarray, k: int, axis_name: str):
    """Multi-word variant (33 <= k <= 64)."""
    ext = halo_exchange(block, k - 1, axis_name)
    win = kmer_ops.kmer_windows_wide(ext[None, :], k)
    L_local = block.shape[-1]
    idx = jnp.arange(ext.shape[-1], dtype=jnp.int32)
    valid = win.valid & (idx < L_local)[None, :]
    return kmer_ops.KmerWindowsWide(fw=win.fw, rc=win.rc, valid=valid,
                                    n_windows=L_local)
