"""The -M depth counter sharded over dp (rkmh-tpu's expert-parallel analog).

Counterpart of ``rkmh_tpu/parallel/ep.py:35-141``.  Row o of the grid
owns the slots [o * size/dp, (o + 1) * size/dp) of the logical ``hash %
size`` table, replicated over tp (``P("dp")`` on a (dp, tp) mesh), so no
device holds the whole table.

* ``add_codes``: each dp slice of a batch is hashed by K1 on its row; its
  hashes go to every owner, which adds only its own slots (K6 over a slot
  range).  Integer addition commutes, so the table is bit-equal to
  rkmh-tpu's ``psum_scatter`` result and to one device's ``HashCounter``.
  rkmh-tpu's transient full-size table per device and batch is not
  carried over (at the default 2e8 slots it would be an 800 MB memset a
  batch).
* ``mask``: a row's hashes visit each owner in turn; K7 over a slot range
  zeroes the owned hashes counted outside [lo, hi] and passes every other
  hash as it is.  Each slot has one owner, so the result is one device's
  K7 on the whole table (``counter_get_local`` then ``mask_by_frequency``
  in rkmh-tpu).
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.ops.counter import INT32_MAX, HashCounter, counter_mask
from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes


class ShardedCounter:
    """A ``hash % size`` int32 counter in dp shards over ``mesh``: shard o
    a ``HashCounter`` of the slot range on device (o, 0), copied to the
    other devices of row o once, when the first mask needs it."""

    def __init__(self, mesh, size: int):
        if size % mesh.dp:
            raise ValueError(f"counter size {size} not divisible by {mesh.dp} dp shards")
        self.mesh, self.size = mesh, size
        self.shard_size = size // mesh.dp
        self.owners = [HashCounter(size, mesh[o, 0], base=o * self.shard_size,
                                   n_slots=self.shard_size) for o in range(mesh.dp)]
        self._replicas: dict = {}

    def add_codes(self, codes: np.ndarray, lens: np.ndarray, ks) -> ShardedCounter:
        """Count every window of the reads (host codes [B, L], B a multiple
        of dp; rows of length 0 count nothing)."""
        dp, L = self.mesh.dp, codes.shape[1]
        if codes.shape[0] % dp:
            raise ValueError(f"a batch of {codes.shape[0]} rows does not split over dp {dp}")
        for i, (c, n) in enumerate(zip(np.split(codes, dp), np.split(np.asarray(lens), dp))):
            row = self.mesh[i, 0]
            hashes = multi_k_window_hashes(torch.from_numpy(c).to(row, non_blocking=True), ks)
            lengths = torch.from_numpy(np.ascontiguousarray(n, dtype=np.int32)).to(row)
            for owner in self.owners:
                at = owner.table.device
                owner.add_windows(hashes.to(at, non_blocking=True),
                                  lengths.to(at, non_blocking=True), L, ks)
        self._replicas = {}
        return self

    def shard(self, o: int, j: int) -> torch.Tensor:
        """Shard o's table on device (o, j)."""
        table = self.owners[o].table
        dev = self.mesh[o, j]
        if dev == table.device:
            return table
        if (o, dev) not in self._replicas:
            self._replicas[(o, dev)] = table.to(dev)
        return self._replicas[(o, dev)]

    def mask(self, hashes: torch.Tensor, j: int, lo: int, hi: int = INT32_MAX) -> torch.Tensor:
        """The hashes (of a row of column j) counted in [lo, hi], 0
        elsewhere, back on their device: each owner o masks its slots on
        device (o, j)."""
        home = hashes.device
        for o in range(self.mesh.dp):
            table = self.shard(o, j)
            hashes = counter_mask(table, hashes.to(table.device, non_blocking=True), lo, hi,
                                  base=o * self.shard_size, size=self.size)
        return hashes.to(home, non_blocking=True)

    def to_numpy(self) -> np.ndarray:
        """The whole [size] int32 table on the host."""
        return np.concatenate([o.table.cpu().numpy() for o in self.owners])
