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

hpv16 (``rkmh_tpu/parallel/mesh.py:261-504``): ``ShardedSetPanel`` holds
the combined type + group set table in tp shards of contiguous columns
(``ops/lookup.build_sharded_set_tables_device``, pad columns last);
``ShardedHpv16Comb`` runs on device (i, j) K1 on slice i, the -M mask,
the full-width sort cut to Wc and K3's partial epilogue against shard j
(``ops/set_probe.set_probe_partial``), and merges the tp partials on (i, 0)
(``merge_hpv16_partials``, in place of the all_gather and argmax of
``finish_local``); past the set-table cap ``ShardedHpv16Sorted`` probes
the replicated sorted panel with K10 on each dp slice, with no tp split.
``call`` (``:553-660``): ``ShardedCallScan`` splits the positions of a
reference into dp slices, each scanned on its device from a host-built
slice of the codes with its (k+1)-code halo (K1, K8, the window average
over the previous slice's last w depths, K9 at the slice's global offset);
``ShardedCallEnum`` (``:507-551``, which no command calls) the depths of
every window and of its 1-bp substitutions over dp slices (K1, K8).
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.call_engine import (
    call_scan_slice,
    plain_getter,
    positional_depths,
    snp_codes,
)
from rkmh_tpu_torch.classify.engine import probe_rows
from rkmh_tpu_torch.io.packing import PAD_CODE
from rkmh_tpu_torch.ops.counter import INT32_MAX
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes, multi_k_window_hashes
from rkmh_tpu_torch.ops.hashmap import hashmap_get
from rkmh_tpu_torch.ops.lookup import build_panel_table, table_slots
from rkmh_tpu_torch.ops.probe import (
    device_table,
    pack_filter_result,
    pack_result,
    panel_probe_partial,
)
from rkmh_tpu_torch.ops.set_probe import merge_hpv16_partials, pack_set_table, set_probe_partial
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch
from rkmh_tpu_torch.ops.sorted_probe import SortedPanel, sorted_probe

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
    out = []
    for i, host in enumerate(_slices(mesh, codes)):
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


def _slices(mesh: Mesh, codes: np.ndarray) -> list:
    """Host codes [B, L] (B a multiple of dp) -> the dp row slices as CPU tensors."""
    if codes.shape[0] % mesh.dp:
        raise ValueError(f"a batch of {codes.shape[0]} rows does not split over dp {mesh.dp}")
    return [torch.from_numpy(part) for part in np.split(codes, mesh.dp)]


def _in_row_order(mesh: Mesh, results: list, dim: int = 1) -> torch.Tensor:
    """The dp row results ([C, B/dp], or [B/dp, C] with dim 0) joined on
    device (0, 0)."""
    home = mesh[0, 0]
    return torch.cat([r.to(home, non_blocking=True) for r in results], dim=dim)


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


# ---- hpv16 (rkmh_tpu/parallel/mesh.py:261-504)


class ShardedSetPanel:
    """hpv16's combined set table in tp shards on a mesh: shard j (the
    combined columns [j * rps, (j + 1) * rps)) on every device of column
    j, placed once per (shard, device), so a grid that repeats a device
    holds each shard there once; on a GPU in K3's packed layout, packed
    once with ``rps`` references."""

    def __init__(self, mesh: Mesh, tables: torch.Tensor, rps: int):
        """``tables``: [tp, NB, width] int32 on any device
        (``ops/lookup.build_sharded_set_tables_device``)."""
        if tables.shape[0] != mesh.tp:
            raise ValueError(f"{tables.shape[0]} shard tables for tp {mesh.tp}")
        self.mesh, self.rps = mesh, rps
        self._tables = {}
        for i in range(mesh.dp):
            for j in range(mesh.tp):
                key = (j, mesh[i, j])
                if key not in self._tables:
                    t = tables[j].to(mesh[i, j])
                    self._tables[key] = pack_set_table(t, rps) if t.device.type == "cuda" else t

    def table(self, i: int, j: int):
        """Shard j's table on device (i, j)."""
        return self._tables[(j, self.mesh[i, j])]


def _masked(hashes: torch.Tensor, counter, j: int, min_occ: int) -> torch.Tensor:
    """The -M mask through the dp-sharded counter (rows of column j)."""
    return hashes if counter is None else counter.mask(hashes, j, min_occ, INT32_MAX)


class ShardedHpv16Comb:
    """The hpv16 step over the grid against a ``ShardedSetPanel``
    (``rkmh_tpu/parallel/mesh.py:261-397``): host codes [B, L] (B % dp ==
    0) -> int64 [B, 2+U] on device (0, 0), as ``engine.hpv16_batch_comb``
    gives it on one device.  On device (i, j): K1 on slice i, the -M mask
    through ``counter`` (``ep.ShardedCounter``), every window hash sorted
    and cut to Wc columns, K3's partial epilogue against shard j; the tp
    partials meet on device (i, 0) (``merge_hpv16_partials``)."""

    def __init__(self, mesh: Mesh, panel: ShardedSetPanel, ks, num_types: int, num_uniq: int,
                 counter=None, min_occ: int = 0):
        self.mesh, self.panel, self.ks = mesh, panel, tuple(ks)
        self.num_types, self.num_uniq = num_types, num_uniq
        self.counter, self.min_occ = counter, min_occ

    def __call__(self, codes: np.ndarray, Wc: int) -> torch.Tensor:
        mesh, rps = self.mesh, self.panel.rps
        out = []
        for i, host in enumerate(_slices(mesh, codes)):
            parts = []
            for j in range(mesh.tp):
                hashes = multi_k_window_hashes(host.to(mesh[i, j], non_blocking=True), self.ks)
                hashes = _masked(hashes, self.counter, j, self.min_occ)
                full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
                partial = set_probe_partial(full[:, :Wc], lens, self.panel.table(i, j), j * rps,
                                            rps, self.num_types, self.num_uniq)
                parts.append(partial.to(mesh[i, 0], non_blocking=True))
            out.append(merge_hpv16_partials(torch.stack(parts)))
        return _in_row_order(mesh, out, dim=0)


def _panel_on(panel: SortedPanel, device: torch.device) -> SortedPanel:
    """A copy of a sorted panel on ``device`` (fresh buffers: the keys and
    the directory keep the alignment K10 needs)."""
    if panel.device == device:
        return panel
    return SortedPanel(panel.keys.to(device), panel.masks.to(device),
                       None if panel.dir is None else panel.dir.to(device), panel.bits)


class ShardedHpv16Sorted:
    """The hpv16 step past the set-table cap over the grid
    (``rkmh_tpu/parallel/mesh.py:400-478``): the sorted panel replicated
    on the first device of every row, K10 on each dp slice there, no tp
    split (rkmh-tpu's tp columns compute the same counts); the same int64
    [B, 2+U] on device (0, 0) as ``engine.hpv16_sorted_batch``."""

    def __init__(self, mesh: Mesh, panel: SortedPanel, ks, num_types: int, num_uniq: int,
                 counter=None, min_occ: int = 0):
        self.mesh, self.ks = mesh, tuple(ks)
        self.panels = {}
        for i in range(mesh.dp):
            self.panels.setdefault(mesh[i, 0], _panel_on(panel, mesh[i, 0]))
        self.num_types, self.num_uniq = num_types, num_uniq
        self.counter, self.min_occ = counter, min_occ

    def __call__(self, codes: np.ndarray, Wc: int) -> torch.Tensor:
        out = []
        for i, host in enumerate(_slices(self.mesh, codes)):
            dev = self.mesh[i, 0]
            hashes = multi_k_window_hashes(host.to(dev, non_blocking=True), self.ks)
            hashes = _masked(hashes, self.counter, 0, self.min_occ)
            full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
            out.append(sorted_probe(full[:, :Wc], lens, self.panels[dev], self.num_types,
                                    self.num_uniq))
        return _in_row_order(self.mesh, out, dim=0)


# ---- call (rkmh_tpu/parallel/mesh.py:553-660)


def _on_first_column(mesh: Mesh, table) -> dict:
    """The depth map copied once to each distinct device of the grid's first
    column, by device."""
    maps = {}
    for d in range(mesh.dp):
        if mesh[d, 0] not in maps:
            maps[mesh[d, 0]] = table.to(mesh[d, 0])
    return maps


class ShardedCallScan:
    """``call``'s positional scan with the positions over the grid's dp
    rows (``sharded_call_scan_fn``): the depth map copied once to each
    distinct device of the grid's first column; a reference's P positions
    in dp slices of Pl = ceil(P / dp), slice d scanned on device (d, 0)
    from the codes [d * Pl - 1, (d + 1) * Pl + k) (one code before, a
    pad code for d = 0, and the k-halo), the window average reading the
    previous slice's last w depths (zeros for d = 0), K9's deletions
    guarded on the global index.  Needs Pl >= w (callers fall back below).
    ``scan`` runs a run of the slices of a finer cut (a --dist-* rank's)."""

    def __init__(self, mesh: Mesh, table, k: int, window_len: int):
        self.mesh, self.k, self.window_len = mesh, k, window_len
        self.maps = _on_first_column(mesh, table)

    def slice_len(self, P: int) -> int:
        return -(-P // self.mesh.dp)

    def __call__(self, ref_codes: np.ndarray) -> dict:
        """[L] uint8 codes -> ``call_scan_ref``'s dict as host arrays of P
        = L - k + 1 positions."""
        P = ref_codes.shape[0] - self.k + 1
        return {name: v[:P] for name, v in self.scan(ref_codes, self.mesh.dp, 0).items()}

    def scan(self, ref_codes: np.ndarray, n_slices: int, first: int) -> dict:
        """Slices [first, first + dp) of the reference's P positions cut in
        ``n_slices`` slices of Pl = ceil(P / n_slices), slice first + d on
        device (d, 0) -> ``call_scan_ref``'s dict for the positions [first
        * Pl, (first + dp) * Pl) as host arrays (those past P are padding).
        The halo of slice ``first`` > 0 is made here from the whole map (the
        depths of its w positions before, K1 and K8, as slice first - 1 would
        have given them); each later slice takes the previous one's."""
        n, k, w = self.mesh.dp, self.k, self.window_len
        L = ref_codes.shape[0]
        P = L - k + 1
        Pl = -(-P // n_slices)
        if Pl < w:
            raise ValueError(f"{P} positions over {n_slices} slices leave {Pl} a slice, "
                             f"< window {w}")
        if not 0 <= first <= n_slices - n:
            raise ValueError(f"slices [{first}, {first + n}) of {n_slices}")
        padded = np.full(n_slices * Pl + k + 1, PAD_CODE, dtype=np.uint8)
        padded[0] = 4          # row j reaches ref[j - 1] for the deletion (k+1)-mers
        padded[1: 1 + L] = ref_codes
        parts, halo = [], None
        if first:
            dev = self.mesh[0, 0]
            lo = first * Pl  # the window codes of positions [lo - w, lo)
            codes = torch.from_numpy(padded[lo - w + 1: lo + k]).to(dev)
            table = self.maps[dev]
            halo = positional_depths(codes, table, k,
                                     plain_getter(table) if dev.type == "cpu" else None)
        for d in range(n):
            dev = self.mesh[d, 0]
            s = first + d
            pref = torch.from_numpy(padded[s * Pl: s * Pl + Pl + k + 1]).to(dev)
            res = call_scan_slice(pref, self.maps[dev], k, w, Pl, base=s * Pl,
                                  halo=None if halo is None else halo.to(dev))
            halo = res["depth"][-w:]
            parts.append(res)
        return {name: torch.cat([p[name].cpu() for p in parts]).numpy() for name in parts[0]}


class ShardedCallEnum:
    """``call``'s mutation enumeration with the positions over the grid's
    dp rows (``sharded_call_enum_fn``, ``rkmh_tpu/parallel/mesh.py:
    507-551``): the depth map (``ops/hashmap.SortedMap``) copied once to
    each distinct device of the grid's first column; slice d, host codes
    [Pl + k] with a k-code halo, on device (d, 0): K1 over its Pl windows
    and K8 (their depths), the [Pl, k, 3] substitutions of each window
    (``call_engine.snp_codes``), K1 over them as [Pl * k * 3, k] rows and
    K8.  The JAX ``pmax`` is one max over the slices' maxima.  No command
    calls it, as in rkmh-tpu."""

    def __init__(self, mesh: Mesh, table, k: int):
        self.mesh, self.k = mesh, k
        self.maps = _on_first_column(mesh, table)

    def __call__(self, slices: np.ndarray):
        """[dp, Pl + k] uint8 codes -> ([dp * Pl] int32 window depths, [dp *
        Pl, k, 3] int32 substitution depths, [dp] int32 global max of the
        latter), on device (0, 0)."""
        mesh, k = self.mesh, self.k
        if slices.shape[0] != mesh.dp or slices.shape[1] <= k:
            raise ValueError(f"call enumeration takes [{mesh.dp}, Pl + {k}] slices, got "
                             f"{tuple(slices.shape)}")
        Pl = slices.shape[1] - k
        first = mesh[0, 0]
        depths, snps = [], []
        for d in range(mesh.dp):
            dev = mesh[d, 0]
            codes = torch.from_numpy(np.ascontiguousarray(slices[d])).to(dev)
            table = self.maps[dev]
            depths.append(hashmap_get(table, kmer_window_hashes(codes[None], k)[0][:Pl]))
            alt = snp_codes(codes.unfold(0, k, 1)[:Pl]).reshape(-1, k)
            snps.append(hashmap_get(table, kmer_window_hashes(alt, k)[:, 0]).reshape(Pl, k, 3))
        gmax = torch.stack([s.amax().to(first) for s in snps]).amax()
        return (torch.cat([x.to(first) for x in depths]), torch.cat([x.to(first) for x in snps]),
                gmax.repeat(mesh.dp))
