"""The fused hpv16 set-table probe: sorted hash rows -> per-read
(best type, its count, unique-group counts).

One call runs, per read, the bucket probe of the combined type + group
set table, the distinct counts per reference, the split into T type
counts and U group counts, and the first-max argmax over the types.  On a
CUDA tensor it is the set-probe kernel (``csrc/set_probe.cu``, K3); on a
CPU tensor it is ``set_probe_plain``, the plain port of the JAX package's
``hpv16_comb_stage1`` ranks and bucket indices, row gather and
``hpv16_comb_finish`` (``rkmh_tpu/classify/engine.py:736-791``), which the
kernel must match exactly.

Rows are [B, n] int64 hashes sorted in unsigned order (bottom_s_sketch
over every window, cut to the first n columns) with lens [B]: valid = i <
len and h != SENTINEL.  The table must be a set table (every entry occ 0,
``ops/lookup.build_set_table``): the kernel probes only the first element
of each run of equal hashes, which is exact only for such a table.
"""

from __future__ import annotations

import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.intersect import occ_ranks
from rkmh_tpu_torch.ops.lookup import M32, bucket_indices, counts_from_rows, table_slots
from rkmh_tpu_torch.ops.sketch import SENTINEL

# the plain version gathers [reads, n, width] rows; it goes through the
# batch in pieces of at most this many int32 lanes to bound its memory
_PLAIN_LANES = 1 << 28


def set_probe_plain(rows: torch.Tensor, lens: torch.Tensor, table: torch.Tensor,
                    num_types: int, num_uniq: int) -> torch.Tensor:
    B, n = rows.shape
    step = max(1, _PLAIN_LANES // max(1, n * table.shape[1]))
    parts = []
    for r0 in range(0, B, step):
        full, ln = rows[r0 : r0 + step], lens[r0 : r0 + step]
        occ = occ_ranks(full)
        qmask = (torch.arange(n, device=rows.device)[None, :] < ln[:, None]) & (full != SENTINEL)
        lo, hi = full & M32, (full >> 32) & M32
        gathered = table[bucket_indices(lo, hi, occ, table.shape[0])]
        parts.append(counts_from_rows(gathered, lo, hi, occ, qmask, num_types + num_uniq))
    counts = torch.cat(parts) if parts else torch.zeros(
        (0, num_types + num_uniq), dtype=torch.int32, device=rows.device)
    # jnp.argmax over the types (the first maximal index, 0 when all are
    # 0), their max, then the group counts
    tc = counts[:, :num_types]
    return torch.cat([tc.argmax(dim=-1, keepdim=True).to(torch.int64),
                      tc.amax(dim=-1, keepdim=True).to(torch.int64),
                      counts[:, num_types:].to(torch.int64)], dim=1)


def _set_probe_cuda(rows, lens, table, num_types, num_uniq):
    if rows.dtype != torch.int64 or rows.dim() != 2:
        raise ValueError(f"set probe takes [B, n] int64 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if table.dtype != torch.int32 or table.dim() != 2 or table.device != rows.device:
        raise ValueError("set probe takes an int32 [NB, width] table on the rows' device")
    if num_types < 1 or num_uniq < 0:
        raise ValueError(f"set probe needs >= 1 type and >= 0 groups, got "
                         f"{num_types} and {num_uniq}")
    nb = table.shape[0]
    if nb & (nb - 1):
        raise ValueError(f"bucket count {nb} is not a power of two")
    B, n = rows.shape
    if lens.shape != (B,) or lens.device != rows.device:
        raise ValueError("lens must be [B] on the rows' device")
    S = table_slots(table.shape[1], num_types + num_uniq)
    Wm = table.shape[1] // S - 3
    if n and rows.stride(1) != 1:
        rows = rows.contiguous()
    table = table.contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty((B, 2 + num_uniq), dtype=torch.int64, device=rows.device)
    if B:
        kernels.SET_PROBE(rows, rows.stride(0), lens, B, n, table, nb.bit_length() - 1,
                          S, Wm, num_types, num_uniq, out)
    return out


def set_probe(rows: torch.Tensor, lens: torch.Tensor, table: torch.Tensor,
              num_types: int, num_uniq: int) -> torch.Tensor:
    """[B, n] sorted int64 rows + lens -> int64 [B, 2+U]."""
    if rows.device.type == "cuda":
        return _set_probe_cuda(rows, lens, table, num_types, num_uniq)
    if rows.device.type != "cpu":
        raise ValueError(f"no set-probe path for device {rows.device}")
    return set_probe_plain(rows, lens, table, num_types, num_uniq)
