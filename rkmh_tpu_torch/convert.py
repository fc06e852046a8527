"""Carry tables built by the JAX package over to the port without a rebuild.

``rkmh_tpu``'s ``RefPanel`` holds uint64 sketches and a uint32 bucket
table, and its ``Hpv16Tables.comb_table`` is a uint32 set table; as numpy
arrays they become the port's tensors by reinterpreting the bits as int64
and int32.  A ``HashCounter``'s int32 table (``.to_numpy()``) carries over
as it is, and so does the table ``count -o`` saves (either package's npz).
A ``HashMap``'s four arrays (``call``'s depth map, a cuckoo table) become
the port's ``SortedMap`` of the same keys and values.  A sorted-key panel
(``build_sorted_panel``'s uint64 keys and uint32 masks, either package's)
becomes a ``SortedPanel`` with the directory over its keys that K10 reads.
A VW model of ``rkmh_tpu.ml.wabbit`` (its numpy weights, or the npz file
its ``save_model`` writes) becomes the port's ``WabbitModel``.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.commands.common import RefPanel
from rkmh_tpu_torch.ml.wabbit import WabbitModel, load_model
from rkmh_tpu_torch.ops.counter import HashCounter
from rkmh_tpu_torch.ops.hashmap import SortedMap, build_sorted_map
from rkmh_tpu_torch.ops.lookup import flip_keys, table_slots
from rkmh_tpu_torch.ops.probe import device_table
from rkmh_tpu_torch.ops.sorted_probe import SortedPanel, build_directory


def panel_from_numpy(keys, sketches_u64, lens, table_u32, device) -> RefPanel:
    """(names, [R, s] uint64 sketches, [R] lengths, [NB, width] uint32
    table) -> RefPanel on ``device`` (past ``ops/probe.MAX_REFS`` on a GPU
    the table's ``WideTable``)."""
    sk = np.array(sketches_u64, dtype=np.uint64).view(np.int64)  # own, writable copies
    table = np.array(table_u32, dtype=np.uint32).view(np.int32)
    table_slots(table.shape[1], len(keys))  # raises on a foreign layout
    return RefPanel(
        keys,
        torch.from_numpy(sk).to(device),
        torch.from_numpy(np.array(lens, dtype=np.int32)).to(device),
        device_table(table, len(keys), device),
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


def hashmap_from_numpy(hash_hi, hash_lo, used, values, device) -> SortedMap:
    """The four [T] arrays of a ``HashMap`` (the JAX package's: uint32 hi
    and lo halves, bool used flags, int32 values) -> the ``SortedMap`` of
    its used keys and their values on ``device``, which
    ``ops.hashmap.hashmap_get`` and the call scan read: every key reads
    the value the JAX ``hashmap_get`` gives it."""
    hi, lo = np.asarray(hash_hi, np.uint32), np.asarray(hash_lo, np.uint32)
    used, vals = np.asarray(used, bool), np.asarray(values, np.int32)
    if not hi.ndim == 1 or any(a.shape != hi.shape for a in (lo, used, vals)):
        raise ValueError("a hash map is four [T] arrays of one length")
    keys = (hi[used].astype(np.uint64) << np.uint64(32)) | lo[used].astype(np.uint64)
    order = np.argsort(keys, kind="stable")
    return build_sorted_map(keys[order], vals[used][order]).to(device)


def sorted_panel_from_numpy(keys_u64, masks_u32, device, directory=None) -> SortedPanel:
    """(sorted distinct keys [U] uint64, masks [U, Wm] uint32), as
    ``build_sorted_panel`` of either package makes them -> a SortedPanel on
    ``device``: the keys with the sign bit flipped, the masks' bits as
    int32, and the directory over the keys' top bits (``directory``, as
    ``ops/sorted_probe.build_directory`` gives it, or built here).  The
    keys, padded to an even count, and the directory go to the device in
    one int64 buffer, so that the keys start on a 16-byte boundary and the
    directory on an 8-byte one."""
    keys = np.asarray(keys_u64, dtype=np.uint64)
    masks = np.asarray(masks_u32, dtype=np.uint32)
    if keys.ndim != 1 or masks.ndim != 2 or masks.shape[0] != keys.shape[0]:
        raise ValueError(f"a sorted panel is [U] keys and [U, Wm] masks, got "
                         f"{keys.shape} and {masks.shape}")
    if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
        raise ValueError("the keys of a sorted panel are distinct and ascending")
    d, bits = build_directory(keys) if directory is None else directory
    U, even = keys.size, keys.size + keys.size % 2
    buf = torch.empty(even + (d.size + 1) // 2, dtype=torch.int64)
    host = buf.numpy()
    host[:U] = flip_keys(keys)
    host[U:even] = np.iinfo(np.int64).max
    host[even:].view(np.int32)[: d.size] = d
    buf = buf.to(device)
    return SortedPanel(buf[:U], torch.from_numpy(np.ascontiguousarray(masks).view(np.int32))
                       .to(device), buf[even:].view(torch.int32)[: d.size], bits)


def wabbit_from_numpy(kind: str, weights, bits: int, interactions, ignore,
                      device) -> WabbitModel:
    """A VW model as ``rkmh_tpu.ml.wabbit`` holds it (``kind`` "binary" with
    weights [2**bits] or "ect" with [C, 2**bits], float32) -> a WabbitModel
    on ``device`` with the same weights, bit for bit."""
    W = np.array(weights, dtype=np.float32)  # an own, writable copy
    if kind not in ("binary", "ect") or W.ndim != (1 if kind == "binary" else 2):
        raise ValueError(f"a {kind!r} model's weights cannot be {W.dtype} {W.shape}")
    return WabbitModel(kind, torch.from_numpy(W.reshape(-1, W.shape[-1])).to(device), bits,
                       interactions, ignore)


def wabbit_from_npz(path, device) -> WabbitModel:
    """A model file ``save_model`` of either package wrote (npz: ``kind``,
    ``weights``, ``bits``, ``interactions``, ``ignore``) -> a WabbitModel on
    ``device``."""
    return wabbit_from_numpy(*load_model(path), device)
