"""A (dp, tp) grid of devices, the tp-sharded panel and the sharded steps.

Counterpart of ``rkmh_tpu/parallel/mesh.py:1-259`` and ``:662-670``
(``make_mesh``, ``build_sharded_tables``, ``sharded_classify_table_fn``,
``sharded_filter_table_fn``, ``shard_batch``) for ``--devices N [--tp
T]``.  rkmh-tpu runs one controller process over a ``jax.sharding.Mesh``;
so does the port, over a grid of ``torch.device`` entries: one process
reads the input, launches every shard's kernels on its device's current
stream and writes the output in input order.  Entry (i, j) of the grid is
``devices[i * tp + j]``, and the same device may appear more than once (a
grid of one card's entries runs the whole sharded program on that card,
shard after shard; a grid of ``cpu`` entries runs the plain versions).

* ``dp``: the reads of a batch split into dp contiguous row slices, slice
  i on row i of the grid;
* ``tp``: the panel's references split into tp shards of R / tp, shard j
  on every device of column j (``ShardedPanel``, placed once a run), each
  with a table of one geometry (``build_sharded_tables``, whose tables are
  bit-equal to rkmh-tpu's).

A step runs on device (i, j) K1 on slice i, the -M mask (``ep.py``), then
the panel probe's partial epilogue against shard j (K2 or, past 8,192
references a shard, K11: ``ops/probe.panel_probe_partial``).  In place of
rkmh-tpu's ``all_gather`` of the [B/dp, R/tp] counts over tp and the
argmax over them, the tp partials meet on device (i, 0), where
``merge_tp_partials`` joins them exactly (a few elementwise ops on [tp,
B/dp] int32).  Copies between devices are non-blocking; the host waits
where the caller fetches.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.classify.engine import probe_rows
from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
from rkmh_tpu_torch.ops.lookup import build_panel_table, table_slots
from rkmh_tpu_torch.ops.probe import (
    device_table,
    pack_filter_result,
    pack_result,
    panel_probe_partial,
)

STREAM_INIT, FILTER_INIT = -1, 0  # where the running max starts (engine.argmax_*)


def visible_devices(device) -> list[torch.device]:
    """The devices a ``--devices`` run may use: every CUDA device for
    ``cuda``, the one CPU for ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the ``cuda:i`` its tensors report, so entries compare
    equal to tensors' devices."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A dp x tp grid of devices: entry (i, j) is ``devices[i * tp + j]``,
    the order of ``np.asarray(devices).reshape(dp, tp)``."""

    def __init__(self, devices, dp: int, tp: int):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        self.dp, self.tp = dp, tp

    def __getitem__(self, ij) -> torch.device:
        i, j = ij
        return self.devices[i * self.tp + j]


def make_mesh(devices, dp: int | None = None, tp: int = 1) -> Mesh:
    """A (dp, tp) grid over ``devices`` (dp defaults to len / tp)."""
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    return Mesh(devices, dp, tp)


def build_sharded_tables(ref_sk, ref_lens, tp: int):
    """Split a panel row-wise into tp shard tables of one shape, as
    ``rkmh_tpu/parallel/mesh.py:75-117`` does: shard j holds references [j
    * R/tp, (j + 1) * R/tp), its mask bit r being its local reference r.
    Every shard is rebuilt at the largest bucket count and slot width any
    shard picked until the geometries agree.  -> ([tp, NB, width] uint32,
    references per shard)."""
    ref_sk = np.asarray(ref_sk)
    if ref_sk.dtype == np.int64:
        ref_sk = ref_sk.view(np.uint64)
    ref_lens = np.asarray(ref_lens)
    R = ref_sk.shape[0]
    if R % tp:
        raise ValueError(f"num refs {R} not divisible by tp {tp}")
    rps = R // tp

    def build(i, **geometry):
        return build_panel_table(ref_sk[i * rps: (i + 1) * rps],
                                 ref_lens[i * rps: (i + 1) * rps], **geometry)

    def geometry(p):
        return p.table.shape[0], table_slots(p.table.shape[1], rps)

    parts = [build(i) for i in range(tp)]
    for _ in range(8):  # a forced rebuild can still double its buckets on an overflow
        want = max(geometry(p)[0] for p in parts), max(geometry(p)[1] for p in parts)
        if all(geometry(p) == want for p in parts):
            break
        parts = [p if geometry(p) == want
                 else build(i, num_buckets=want[0], slots=want[1])
                 for i, p in enumerate(parts)]
    return np.stack([p.table for p in parts]), rps


class ShardedPanel:
    """A panel's tp shard tables on a mesh: shard j on every device of
    column j (``P("tp", None, None)``, placed once a run; past 8,192
    references a shard on a GPU as K11's ``WideTable``), and the
    references' sketch lengths on the first device of every row (filter's
    total union indexes the global best)."""

    def __init__(self, mesh: Mesh, tables: np.ndarray, ref_lens):
        """``tables``: [tp, NB, width] uint32 (``build_sharded_tables``);
        ``ref_lens``: the [R] sketch lengths."""
        if tables.shape[0] != mesh.tp or len(ref_lens) % mesh.tp:
            raise ValueError(f"{tables.shape[0]} shard tables of {len(ref_lens)} references "
                             f"for tp {mesh.tp}")
        self.mesh = mesh
        self.rps = len(ref_lens) // mesh.tp
        self.num_refs = len(ref_lens)
        self._tables = {}
        for i in range(mesh.dp):
            for j in range(mesh.tp):
                key = (j, mesh[i, j])
                if key not in self._tables:
                    self._tables[key] = device_table(
                        np.ascontiguousarray(tables[j]).view(np.int32), self.rps, mesh[i, j])
        lens = torch.from_numpy(np.ascontiguousarray(ref_lens, dtype=np.int32))
        self.ref_lens = {mesh[i, 0]: lens.to(mesh[i, 0]) for i in range(mesh.dp)}

    @classmethod
    def from_sketches(cls, mesh: Mesh, ref_sk, ref_lens) -> ShardedPanel:
        """The panel of sketches [R, s] (uint64 or int64 bit patterns) and
        their lengths [R], sharded over the mesh's tp."""
        return cls(mesh, build_sharded_tables(ref_sk, ref_lens, mesh.tp)[0], ref_lens)

    def table(self, i: int, j: int):
        """Shard j's table on device (i, j)."""
        return self._tables[(j, self.mesh[i, j])]


def merge_tp_partials(parts: torch.Tensor, rps: int, min_diff: int, min_matches: int,
                      ref_lens: torch.Tensor | None = None) -> torch.Tensor:
    """The tp shards' partials [tp, 4, B] (local best, max, max before the
    best, sketch length; ``ops/probe.panel_probe_partial``) -> the int32
    [3, B] stream result or, with ``ref_lens`` [R], the [5, B] filter
    result, equal to ``argmax_stream`` / ``argmax_filter`` on the gathered
    [B, R] counts.  The max is the shards' largest, the best lies in the
    first shard s* that holds it (s* * rps + its local best), and the max
    before it is the largest of init, the maxima of the shards before s*
    (each below the max) and s*'s own max before its best."""
    init = STREAM_INIT if ref_lens is None else FILTER_INIT
    tp = parts.shape[0]
    local_best, m, before_best = parts[:, 0], parts[:, 1], parts[:, 2]
    mx = m.amax(dim=0)
    star = (m == mx).to(torch.uint8).argmax(dim=0)  # the first shard holding the max
    best = star.to(torch.int64) * rps + local_best.gather(0, star[None]).squeeze(0)
    earlier = torch.arange(tp, device=parts.device)[:, None] < star[None, :]
    pm = torch.maximum(torch.where(earlier, m, torch.full_like(m, init)).amax(dim=0),
                       before_best.gather(0, star[None]).squeeze(0))
    sk_len = parts[0, 3]
    if ref_lens is None:
        return pack_result(best, mx, (mx - pm) > min_diff, sk_len <= min_matches,
                           mx < min_matches)
    updated = mx > 0
    best = torch.where(updated, best, -1)
    shared = torch.where(updated, mx, 0)
    tu = torch.where(updated, torch.minimum(sk_len, ref_lens[best.clamp(min=0)]), 0)
    diff_ok = (shared - torch.where(updated, pm, 0)) > min_diff
    depth_fail = sk_len <= 0
    match_fail = shared < min_matches
    keep = ~depth_fail & ~match_fail & diff_ok
    return pack_filter_result(best, shared, tu, keep, depth_fail, match_fail, diff_ok)


def sharded_partials(mesh: Mesh, panel: ShardedPanel, codes: np.ndarray, ks,
                     sketch_size: int, init: int, counter=None, min_occ: int = 0) -> list:
    """Host codes [B, L] (B a multiple of dp) -> for each row i of the
    grid the [tp, 4, B/dp] partials of slice i on device (i, 0): on device
    (i, j) K1, the -M mask through ``counter`` (``ep.ShardedCounter``)
    when given, then the partial epilogue against shard j."""
    if codes.shape[0] % mesh.dp:
        raise ValueError(f"a batch of {codes.shape[0]} rows does not split over dp {mesh.dp}")
    out = []
    for i, part in enumerate(np.split(codes, mesh.dp)):
        host = torch.from_numpy(part)
        parts = []
        for j in range(mesh.tp):
            hashes = multi_k_window_hashes(host.to(mesh[i, j], non_blocking=True), ks)
            if counter is not None:
                hashes = counter.mask(hashes, j, min_occ)
            rows, lens = probe_rows(hashes, sketch_size)
            partial = panel_probe_partial(rows, lens, panel.table(i, j), panel.rps, init)
            parts.append(partial.to(mesh[i, 0], non_blocking=True))
        out.append(torch.stack(parts))
    return out


def _in_row_order(mesh: Mesh, results: list) -> torch.Tensor:
    """The dp row results [C, B/dp] joined [C, B] on device (0, 0)."""
    home = mesh[0, 0]
    return torch.cat([r.to(home, non_blocking=True) for r in results], dim=1)


def sharded_classify_step(mesh: Mesh, panel: ShardedPanel, codes: np.ndarray, ks,
                          sketch_size: int, min_diff: int, min_matches: int, counter=None,
                          min_occ: int = 0) -> torch.Tensor:
    """The stream step over the grid: host codes [B, L] (B % dp == 0) ->
    int32 [3, B] (best, shared, flags) on device (0, 0), as
    ``engine.classify_codes_table`` gives it on one device."""
    partials = sharded_partials(mesh, panel, codes, ks, sketch_size, STREAM_INIT, counter,
                                min_occ)
    return _in_row_order(mesh, [merge_tp_partials(p, panel.rps, min_diff, min_matches)
                                for p in partials])


def sharded_filter_step(mesh: Mesh, panel: ShardedPanel, codes: np.ndarray, ks,
                        sketch_size: int, min_diff: int, min_matches: int, counter=None,
                        min_occ: int = 0) -> torch.Tensor:
    """The filter step over the grid: -> int32 [5, B] (best, shared,
    total_union, keep, flags) on device (0, 0), as
    ``engine.filter_codes_table`` gives it."""
    partials = sharded_partials(mesh, panel, codes, ks, sketch_size, FILTER_INIT, counter,
                                min_occ)
    return _in_row_order(mesh, [
        merge_tp_partials(p, panel.rps, min_diff, min_matches, panel.ref_lens[mesh[i, 0]])
        for i, p in enumerate(partials)])
