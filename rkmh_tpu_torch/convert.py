"""Carry tables built by the JAX package over to the port without a rebuild.

``rkmh_tpu``'s ``RefPanel`` holds uint64 sketches and a uint32 bucket
table, and its ``Hpv16Tables.comb_table`` is a uint32 set table; as numpy
arrays they become the port's tensors by reinterpreting the bits as int64
and int32.  A ``HashCounter``'s int32 table (``.to_numpy()``) carries over
as it is, and so does the table ``count -o`` saves (either package's npz).
A ``HashMap``'s four arrays (``call``'s depth map) become the port's one
[T, 4] table.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.commands.common import RefPanel
from rkmh_tpu_torch.ops.counter import HashCounter
from rkmh_tpu_torch.ops.hashmap import HashMap, map_table
from rkmh_tpu_torch.ops.lookup import table_slots


def panel_from_numpy(keys, sketches_u64, lens, table_u32, device) -> RefPanel:
    """(names, [R, s] uint64 sketches, [R] lengths, [NB, width] uint32
    table) -> RefPanel on ``device``."""
    sk = np.array(sketches_u64, dtype=np.uint64).view(np.int64)  # own, writable copies
    table = np.array(table_u32, dtype=np.uint32).view(np.int32)
    table_slots(table.shape[1], len(keys))  # raises on a foreign layout
    return RefPanel(
        keys,
        torch.from_numpy(sk).to(device),
        torch.from_numpy(np.array(lens, dtype=np.int32)).to(device),
        torch.from_numpy(table).to(device),
    )


def set_table_from_numpy(table_u32, device) -> torch.Tensor:
    """[NB, width] uint32 set table (e.g. the JAX package's device-built
    ``Hpv16Tables.comb_table``, fetched as numpy) -> int32 tensor on
    ``device``, bit for bit."""
    table = np.array(table_u32, dtype=np.uint32)
    if table.ndim != 2:
        raise ValueError(f"a set table is 2-D, got shape {table.shape}")
    return torch.from_numpy(table.view(np.int32)).to(device)


def counter_from_numpy(table_i32, device) -> HashCounter:
    """[size] int32 counter table (the JAX package's ``HashCounter.to_numpy()``)
    -> a HashCounter on ``device`` holding the same counts, bit for bit."""
    table = np.array(table_i32)  # an own, writable copy
    if table.ndim != 1 or table.dtype != np.int32:
        raise ValueError(f"a counter table is 1-D int32, got {table.dtype} {table.shape}")
    counter = HashCounter(table.shape[0], device)
    counter.table.copy_(torch.from_numpy(table))
    return counter


def counter_from_npz(path, device) -> HashCounter:
    """The table a ``count -o`` run saved (``rkmh-tpu`` or this port: npz
    with ``table``, ``size`` and ``ks``) -> a HashCounter on ``device``,
    bit for bit."""
    with np.load(path) as z:
        table, size = z["table"], int(z["size"])
    if table.shape != (size,):
        raise ValueError(f"{path}: a table of shape {table.shape} for a counter size of {size}")
    return counter_from_numpy(table, device)


def hashmap_from_numpy(hash_hi, hash_lo, used, values, device) -> torch.Tensor:
    """The four [T] arrays of a ``HashMap`` (the JAX package's, or this
    port's numpy build: uint32 hi and lo halves, bool used flags, int32
    values) -> the [T, 4] int32 (hi, lo, value, used) table on ``device``
    that ``ops.hashmap.hashmap_get`` and the call scan read, bit for bit."""
    hm = HashMap(np.asarray(hash_hi), np.asarray(hash_lo), np.asarray(used),
                 np.asarray(values))
    T = hm.used.shape[0]
    if T & (T - 1) or any(a.shape != (T,) for a in (hm.hash_hi, hm.hash_lo, hm.values)):
        raise ValueError("a hash map is four [T] arrays, T a power of two")
    return map_table(hm, device)
