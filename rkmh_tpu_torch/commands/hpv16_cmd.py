"""`hpv16` command — tiered HPV type / lineage / sublineage classifier.

Counterpart of ``rkmh_tpu/commands/hpv16_cmd.py`` (rkmh main_hpv16,
rkmh.cpp:2366-2723).  Per read: the type whose
full hash set shares the most distinct hashes with the read's (the first
type wins ties), and the read's distinct shared counts with each lineage
and sublineage unique-k-mer table (each group's hashes minus those of
every other group of its family), ranked by similarity = count / hashnum.
Output lines, the ``lineage_specific_hashes.<k>.tst`` side file in the
working directory and the stderr table stats are byte-identical to
``rkmh-tpu hpv16``.

All of it reads one combined set table over the T types and the U unique
groups: the hashing, the group differences and the table's build
(``ops/lookup.build_set_table_device``, the fill by K13) run on the
device, where the set-probe kernel's packed layout of it is made once
(``ops/set_probe.pack_set_table``).  A panel whose projected table passes
RKMH_TPU_SET_TABLE_MAX_MB (default 2048) takes the sorted-key panel
instead, built on the host (``ops/lookup.build_sorted_panel``, probed by
``engine.hpv16_sorted_batch``; rkmh_tpu/commands/hpv16_cmd.py:273-286),
with the same output.  With -M, a first pass counts every read k-mer in a
``hash % counter_size`` counter on the device (rkmh.cpp:2513-2530) and
the classify pass drops the k-mers counted fewer than min_kmer_occ times
before it sorts a read's hashes (rkmh.cpp:2663).  With -o FILE --resume,
FILE's complete lines count the reads already classified (a torn last line
is cut); those reads are skipped after the tables and the -M counter pass,
which still counts every read, and the rest is appended
(rkmh_tpu/commands/hpv16_cmd.py:136-157, 491-496).

``--devices N [--tp T]`` (rkmh_tpu/commands/hpv16_cmd.py:320-360,
417-444, 513-531) runs each batch over a (dp, tp) grid of devices in one
process (``parallel/mesh.py``): the reads split into dp slices, the
combined table into tp shards of contiguous columns, pad columns last
(``ops/lookup.build_sharded_set_tables_device``), each shard's partial epilogue
(K3's partial route) merged exactly; -M's counter in dp slot ranges
(``parallel/ep.ShardedCounter``); past the cap the sorted panel
replicated, K10 on each dp slice.  Where the geometry cannot apply,
rkmh-tpu's line is logged and the run takes one device; ``--tp`` without
``--devices`` > 1 runs on one device, as in rkmh-tpu.  ``--dist-*`` runs
one rank of a multi-process drain (``commands/dist_stream.
run_distributed_hpv16``, rkmh_tpu/commands/hpv16_cmd.py:129-133).
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import (
    ChunkState,
    ChunkedPipeline,
    count_read_kmers,
    count_read_kmers_sharded,
    iter_packed_chunks,
    load_packed,
    log,
    mesh_candidates,
    pad_rows,
    resolve_batch_size,
    resolve_chunk_reads,
    sharded_geometry_reason,
    two_pass_chunks,
)
from rkmh_tpu_torch.commands.recovery import count_complete_lines, fail_after_chunks, skip_reads
from rkmh_tpu_torch.convert import sorted_panel_from_numpy
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device, to_device
from rkmh_tpu_torch.observability import span, traced
from rkmh_tpu_torch.ops.lookup import (
    build_set_table_device,
    build_sharded_set_tables_device,
    build_sorted_panel,
    count_unique_keys_device,
    projected_table_bytes,
)
from rkmh_tpu_torch.ops.set_probe import pack_set_table
from rkmh_tpu_torch.ops.sketch import INT64_MIN, SENTINEL
from rkmh_tpu_torch.ops.sorted_probe import build_directory
from rkmh_tpu_torch.parallel import distributed
from rkmh_tpu_torch.parallel.ep import ShardedCounter
from rkmh_tpu_torch.parallel.mesh import (
    ShardedHpv16Comb,
    ShardedHpv16Sorted,
    ShardedSetPanel,
    make_mesh,
)

DEFAULT_COUNTER_SIZE = 800_000_000  # rkmh.cpp:2516


@dataclass
class Hpv16Config:
    read_files: list = field(default_factory=list)
    refpath: str = "data"
    ks: tuple = ()
    sketch_size: int = 4000        # parsed for parity; dead in the live path
    min_kmer_occ: int = 0          # -M: read k-mer depth filter when > 0
    min_matches: int = -1          # parsed, unused (reference too)
    min_diff: int = 0              # parsed, unused (reference too)
    counter_size: int = DEFAULT_COUNTER_SIZE  # slots of -M's counter
    batch_size: int = 512          # 0 = auto (16384 on cuda, 2048 on cpu)
    tst_file: bool = True          # write lineage_specific_hashes.<k>.tst
    chunk_reads: int = 0           # streaming window; 0 = default (65536)
    out_file: str = ""             # -o: write here instead of stdout
    resume: bool = False           # --resume: go on with a partial -o file
    devices: int = 0               # --devices: a (dp, tp) grid of N devices; 0 = one device
    tp: int = 1                    # --tp: set-table shards (devices = dp * tp)
    dist_coordinator: str = ""     # --dist-coordinator host:port
    dist_procs: int = 0            # --dist-procs: the number of processes
    dist_rank: int = -1            # --dist-rank: this process's rank
    device: str = DEFAULT_DEVICE
    mesh_devices: tuple | None = None  # the devices --devices takes (None: the visible ones)


def devices_reason(cfg: Hpv16Config, n_visible: int) -> str | None:
    """Why ``--devices`` cannot apply (None = it can), rkmh-tpu's reasons
    word for word (rkmh_tpu/commands/hpv16_cmd.py:425-433): the -M one only
    with -M on, and none for the panel, which pads to a multiple of tp."""
    return sharded_geometry_reason(cfg.devices, cfg.tp, None, n_visible,
                                   cfg.min_kmer_occ if cfg.min_kmer_occ > 0 else -1,
                                   cfg.counter_size)


def _fmt_double(x: float) -> str:
    """C++ `cout << double` default formatting: 6 significant digits."""
    return f"{x:.6g}"


def _group_unique_keep(hashes, mask, rows_g, rows_other):
    """Keep-mask for the hashes of rows ``rows_g`` found in no row of
    ``rows_other`` (one iterated set_difference of rkmh.cpp:2575-2590), as
    a sort and a searchsorted.  Hashes are int64 bit patterns: the unsigned
    order is the signed order of ``h ^ INT64_MIN``, where the SENTINEL pad
    sorts last."""
    g_h = hashes[rows_g]
    g_m = mask[rows_g] & (g_h != 0)
    oth = torch.where(mask[rows_other], hashes[rows_other], SENTINEL).reshape(-1)
    oth = torch.sort(oth ^ INT64_MIN).values
    key = g_h ^ INT64_MIN
    pos = torch.searchsorted(oth, key.reshape(-1)).reshape(key.shape).clamp(0, oth.numel() - 1)
    return g_h, g_m & (oth[pos] != key)


def _family_unique(hashes, mask, groups):
    """Per-group unique-hash rows of one family (lineage or sublineage):
    group g keeps the hashes found in none of the other groups.  Returns
    ([G, Lmax] SENTINEL-padded hash rows, [G, Lmax] keep masks)."""
    parts = []
    for g, rows_g in enumerate(groups):
        rows_other = [r for gg, rs in enumerate(groups) if gg != g for r in rs]
        rows_g = torch.tensor(rows_g, dtype=torch.long, device=hashes.device)
        if not rows_other:
            # single-group family: nothing to subtract (the reference's
            # set_difference loop body never runs)
            g_h = hashes[rows_g]
            keep = mask[rows_g] & (g_h != 0)
        else:
            other = torch.tensor(rows_other, dtype=torch.long, device=hashes.device)
            g_h, keep = _group_unique_keep(hashes, mask, rows_g, other)
        parts.append((g_h.reshape(-1), keep.reshape(-1)))
    Lmax = max(h.numel() for h, _ in parts)
    out_h = torch.full((len(groups), Lmax), SENTINEL, dtype=torch.int64, device=hashes.device)
    out_m = torch.zeros((len(groups), Lmax), dtype=torch.bool, device=hashes.device)
    for g, (h, m) in enumerate(parts):
        out_h[g, : h.numel()] = h
        out_m[g, : m.numel()] = m
    return out_h, out_m


class Hpv16Tables:
    """What the read loop needs: the combined set table on the device
    (``comb_table``, the logical layout; ``probe_table``, what the probe
    takes there: on a GPU the kernel's packed layout, on the CPU the same
    logical table), or for tp shards the shard tables (``shard_tables``
    [tp, NB, width] int32 on the device, ``rps`` columns a shard; the grid
    places them),
    or past the set-table cap the sorted-key panel (``comb_sorted``, a
    ``SortedPanel``); what is not built is None; the name maps, the set-up
    seconds of each build phase, and the projected table bytes that chose
    between them."""

    __slots__ = ("type_names", "comb_table", "probe_table", "comb_sorted", "shard_tables",
                 "rps", "lin_names", "sublin_names", "setup_s", "projected_bytes")

    @property
    def n_lin(self):
        return len(self.lin_names)

    @property
    def n_sub(self):
        return len(self.sublin_names)


@contextmanager
def _lap(laps: dict, name: str, device: torch.device):
    """One set-up phase: a span ``hpv16.tables.<name>`` ended by a device
    sync, its host seconds into ``laps[name]``."""
    with span(f"hpv16.tables.{name}") as s:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    laps[name] = s.seconds


def _pad_width(a: torch.Tensor, width: int, fill) -> torch.Tensor:
    """[n, w] -> [n, width], the new columns ``fill``."""
    out = a.new_full((a.shape[0], width), fill)
    out[:, : a.shape[1]] = a
    return out


def _host_rows(hashes, mask) -> list[np.ndarray]:
    """Device rows -> the masked hashes of each row as host uint64 arrays."""
    h = hashes.cpu().numpy().view(np.uint64)
    m = mask.cpu().numpy()
    return [h[i][m[i]] for i in range(h.shape[0])]


class PanelRows(NamedTuple):
    """The combined panel's window hashes on the device: ``hashes`` [T + U,
    W] int64 and ``mask`` [T + U, W] bool, the T type rows (every valid
    window) and then the U unique-group rows (the lineages', then the
    sublineages'), zero-padded to one width."""

    type_names: list
    lin_names: list
    sublin_names: list
    hashes: torch.Tensor
    mask: torch.Tensor


def panel_rows(cfg: Hpv16Config, k0: int, device: torch.device,
               laps: dict | None = None) -> PanelRows:
    """Parse and hash the refpath's genomes at k0 on ``device`` and take each
    group's unique hashes (rkmh.cpp:2544-2653); the seconds of ``parse``,
    ``hash`` and ``family_unique`` into ``laps``."""
    laps = {} if laps is None else laps
    with _lap(laps, "parse", device):
        type_recs = load_packed([f"{cfg.refpath}/all_pave_ref.fa"])
        sub_recs = load_packed([f"{cfg.refpath}/new_refs.fa"])
        sub_names_all = list(sub_recs.names)
        lin_names = sorted({n[0] for n in sub_names_all})            # map<char,..>
        sublin_names = sorted({n[:2] for n in sub_names_all})        # map<string,..>

    def hash_panel(packed):
        return engine.hash_batch_with_mask(torch.from_numpy(packed.codes).to(device),
                                           torch.from_numpy(packed.lens).to(device), (k0,))

    with _lap(laps, "hash", device):
        th, tm = hash_panel(type_recs)
        sh, sm = hash_panel(sub_recs)

    with _lap(laps, "family_unique", device):
        lin_groups = [[i for i, n in enumerate(sub_names_all) if n[0] == ln]
                      for ln in lin_names]
        sublin_groups = [[i for i, n in enumerate(sub_names_all) if n[:2] == sn]
                         for sn in sublin_names]
        lin_h, lin_keep = _family_unique(sh, sm, lin_groups)
        sub_h, sub_keep = _family_unique(sh, sm, sublin_groups)
    W = max(th.shape[1], lin_h.shape[1], sub_h.shape[1])
    return PanelRows(list(type_recs.names), lin_names, sublin_names,
                     torch.cat([_pad_width(h, W, 0) for h in (th, lin_h, sub_h)]),
                     torch.cat([_pad_width(m, W, False) for m in (tm, lin_keep, sub_keep)]))


def build_tables(cfg: Hpv16Config, ks: tuple, device: torch.device,
                 tp_shards: int = 0) -> Hpv16Tables:
    """Type panel + lineage/sublineage unique-k-mer tables as ONE combined
    set table (rkmh.cpp:2544-2653), with the .tst side file and the
    stderr stats.  Reference genomes are hashed at ks[0] only
    (rkmh.cpp:2546), as the reference does.  The window hashes stay on the
    device (``panel_rows``), where they are counted and the table is built
    (``ops/lookup.build_set_table_device``); ``tp_shards`` >= 1 (the sharded
    step) builds the table's tp shards there in place of the whole table
    (``build_sharded_set_tables_device``, the rows padded to a multiple of
    tp at the end); past the cap the sorted panel on the host either way.
    Only the group rows come to the host, for the .tst file and the stats
    (rkmh_tpu/commands/hpv16_cmd.py:180-317)."""
    k0 = ks[0]
    tb = Hpv16Tables()
    tb.setup_s = {}
    rows = panel_rows(cfg, k0, device, tb.setup_s)
    lin_names, sublin_names = rows.lin_names, rows.sublin_names
    # ONE table over every "reference": ref bit r is type r for r < T and
    # unique group r - T after
    all_h, all_m = rows.hashes, rows.mask
    n_all, Wall = all_h.shape
    groups_h, groups_m = all_h[len(rows.type_names):], all_m[len(rows.type_names):]
    with _lap(tb.setup_s, "count", device):
        n_entries = count_unique_keys_device(all_h, all_m)
    # past the cap the bucket table would outgrow the card: the sorted-key
    # panel, ~10x smaller, instead (rkmh_tpu/commands/hpv16_cmd.py:273-286)
    cap_mb = int(os.environ.get("RKMH_TPU_SET_TABLE_MAX_MB", "2048"))
    tb.projected_bytes = projected_table_bytes(n_entries, n_all)
    tb.comb_table = tb.probe_table = tb.comb_sorted = tb.shard_tables = tb.rps = None
    if tb.projected_bytes > cap_mb << 20:
        with _lap(tb.setup_s, "host_build", device):
            keys, masks = build_sorted_panel(_host_rows(all_h, all_m), num_refs=n_all)
        with _lap(tb.setup_s, "directory", device):
            directory = build_directory(keys)  # K10's bucket directory over the keys
        with _lap(tb.setup_s, "h2d", device):
            tb.comb_sorted = sorted_panel_from_numpy(keys, masks, device, directory)
        log(f"hpv16 panel: projected bucket table exceeds "
            f"RKMH_TPU_SET_TABLE_MAX_MB={cap_mb}; using the sorted-key "
            f"panel ({keys.nbytes + masks.nbytes >> 20} MB)")
    elif tp_shards >= 1:
        # pad rows go last, past every real column (rkmh_tpu/parallel/mesh.py:494-500)
        pad = (-n_all) % tp_shards
        with _lap(tb.setup_s, "device_build", device):
            tb.shard_tables, tb.rps = build_sharded_set_tables_device(
                torch.cat([all_h, all_h.new_zeros((pad, Wall))]),
                torch.cat([all_m, all_m.new_zeros((pad, Wall))]), tp_shards)
    else:
        with _lap(tb.setup_s, "device_build", device):
            tb.comb_table = tb.probe_table = build_set_table_device(all_h, all_m, n_all,
                                                                    est_entries=n_entries)
        if device.type == "cuda":
            with _lap(tb.setup_s, "repack", device):
                tb.probe_table = pack_set_table(tb.comb_table, n_all)

    # the .tst side file and the stats: the group rows' distinct hashes, one fetch
    uniq_rows = [np.unique(r) for r in _host_rows(groups_h, groups_m)]
    lin_uniqs, sublin_uniqs = uniq_rows[: len(lin_names)], uniq_rows[len(lin_names):]
    if cfg.tst_file:
        with open(f"lineage_specific_hashes.{k0}.tst", "w") as fh:
            for ln, uniq in zip(lin_names, lin_uniqs):
                fh.write(ln + "\t" + "".join(f"{h}\t" for h in uniq.tolist()) + "\n")
    log("Lineage specific kmer table created:")
    for ln, uniq in zip(lin_names, lin_uniqs):
        log(f"\t{ln}\t{len(uniq)}")
    log("Sublineage specific kmer table created:")
    for sn, uniq in zip(sublin_names, sublin_uniqs):
        log(f"\t{sn}\t{len(uniq)}")

    tb.type_names = rows.type_names
    tb.lin_names = lin_names
    tb.sublin_names = sublin_names
    return tb


def format_read_lines(tb: Hpv16Tables, ks: tuple, row_names, lens, packed) -> list[str]:
    """Per-read output lines (rkmh.cpp:2681-2715) from a fetched [n, 2+U]
    int64 result; similarities divide in float64 on the host."""
    n_lin, n_sub = tb.n_lin, tb.n_sub
    best_np, shared_np, uc_np = packed[:, 0], packed[:, 1], packed[:, 2:]
    hashnum = np.zeros(len(lens), dtype=np.int64)
    for k_ in ks:
        hashnum += np.maximum(np.asarray(lens).astype(np.int64) - (k_ - 1), 0)

    lines = []
    for i, name in enumerate(row_names):
        hn = int(hashnum[i])
        lin_ints = uc_np[i, :n_lin]
        sub_ints = uc_np[i, n_lin:]
        lin_sims = lin_ints / hn if hn else np.zeros_like(lin_ints, dtype=float)
        sub_sims = sub_ints / hn if hn else np.zeros_like(sub_ints, dtype=float)
        lin_order = sorted(range(n_lin), key=lambda x: -lin_sims[x])
        sub_order = sorted(range(n_sub), key=lambda x: -sub_sims[x])
        parts = [
            name,
            tb.type_names[int(best_np[i])],
            f"{int(shared_np[i])}/{hn}",
            "".join(f"{tb.lin_names[x]}:{_fmt_double(lin_sims[x])};" for x in lin_order),
            "".join(f"{tb.sublin_names[x]}:{_fmt_double(sub_sims[x])};" for x in sub_order),
            "".join(f"{int(lin_ints[x])};" for x in lin_order),
            "".join(f"{int(sub_ints[x])};" for x in sub_order),
        ]
        lines.append("\t".join(parts) + "\n")
    return lines


@traced("hpv16")
def run(cfg: Hpv16Config, out=None) -> int:
    if distributed.requested(cfg.dist_procs, cfg.dist_coordinator):
        from rkmh_tpu_torch.commands.dist_stream import run_distributed_hpv16

        return run_distributed_hpv16(cfg, out)
    if cfg.resume and not cfg.out_file:
        log("hpv16 --resume requires -o <file> (resume state is the "
            "partial output itself); refusing to reclassify to stdout")
        return 1
    if out is None and cfg.out_file:
        resume_skip, mode = 0, "w"
        if cfg.resume and os.path.exists(cfg.out_file):
            resume_skip, mode = count_complete_lines(cfg.out_file), "a"
            log(f"Resuming: {resume_skip} reads already classified in {cfg.out_file}")
        with open(cfg.out_file, mode) as fh:
            return _run(cfg, fh, resume_skip)
    return _run(cfg, out or sys.stdout)


class _Chunk(ChunkState):
    __slots__ = ("names", "lines")

    def __init__(self, chunk):
        super().__init__(len(chunk))
        self.names = chunk.names
        self.lines = [None] * self.n


def make_sharded_hpv16_step(mesh, tb: Hpv16Tables, ks: tuple, counter=None,
                            min_occ: int = 0):
    """The sharded step over ``mesh`` (rkmh_tpu/commands/hpv16_cmd.py:320-360):
    the tp shard tables placed on the grid (``parallel/mesh.ShardedSetPanel``)
    under ``ShardedHpv16Comb``, or past the cap the sorted panel replicated
    under ``ShardedHpv16Sorted``; ``counter`` the dp-sharded -M counter.
    -> ``step(codes [B, L] host, Wc)``, B a multiple of dp, giving int64
    [B, 2+U] on the grid's first device.  The placement's seconds go to
    ``tb.setup_s["place"]``."""
    num_types, num_uniq = len(tb.type_names), tb.n_lin + tb.n_sub
    with _lap(tb.setup_s, "place", mesh[0, 0]):
        if tb.comb_sorted is not None:
            step = ShardedHpv16Sorted(mesh, tb.comb_sorted, ks, num_types, num_uniq, counter,
                                      min_occ)
        else:
            panel = ShardedSetPanel(mesh, tb.shard_tables, tb.rps)
            step = ShardedHpv16Comb(mesh, panel, ks, num_types, num_uniq, counter, min_occ)
    return step


def make_step(tb: Hpv16Tables, ks: tuple, device: torch.device, mesh=None, counter=None,
              min_occ: int = 0):
    """-> ``step(codes [n, L] host uint8, lens [n])``: int64 [n, 2+U] on the
    device, on one device (K3, or past the cap K10; ``counter`` the -M
    table) or over ``mesh`` (``make_sharded_hpv16_step``; ``counter`` a
    ``ShardedCounter``).  The probe width comes from the unpadded lengths
    (``engine.hpv16_compact_width``)."""
    num_types, num_uniq = len(tb.type_names), tb.n_lin + tb.n_sub
    sharded = (make_sharded_hpv16_step(mesh, tb, ks, counter, min_occ)
               if mesh is not None else None)

    def step(codes: np.ndarray, lens) -> torch.Tensor:
        Wc = engine.hpv16_compact_width(lens, codes.shape[1], ks)
        if sharded is not None:
            return sharded(pad_rows(codes, None, mesh.dp)[0], Wc)[: len(codes)]
        batch = to_device(codes, device)
        if tb.comb_sorted is not None:
            return engine.hpv16_sorted_batch(batch, tb.comb_sorted, ks, num_types, num_uniq,
                                             Wc, counter, min_occ)
        return engine.hpv16_batch_comb(batch, tb.probe_table, ks, num_types, num_uniq, Wc,
                                       counter, min_occ)

    return step


def _run(cfg: Hpv16Config, out, resume_skip: int = 0) -> int:
    device = resolve_device(cfg.device)
    batch_size = resolve_batch_size(cfg.batch_size, device)
    if not cfg.ks:
        log("NO KMER SIZE PROVIDED. USING A DEFAULT KMER SIZE OF 16")
    ks = tuple(cfg.ks) if cfg.ks else (16,)
    chunk_reads = resolve_chunk_reads(cfg.chunk_reads)

    # --devices first: the table build and -M's counter depend on the grid
    mesh = None
    if cfg.devices > 1:
        candidates = mesh_candidates(device, cfg.mesh_devices)
        reason = devices_reason(cfg, len(candidates))
        if reason is not None:
            log(f"hpv16 --devices ignored ({reason}); running single-device")
        else:
            mesh = make_mesh(candidates[: cfg.devices], dp=cfg.devices // cfg.tp, tp=cfg.tp)

    tb = build_tables(cfg, ks, device, tp_shards=cfg.tp if mesh is not None else 0)
    counter = None
    if cfg.min_kmer_occ > 0:
        pass1, pass2 = two_pass_chunks(cfg.read_files, chunk_reads)
        if mesh is not None:  # the counter itself shards over dp (parallel/ep.py)
            counter = ShardedCounter(mesh, cfg.counter_size)
            count_read_kmers_sharded(pass1, ks, counter, batch_size)
        else:
            counter = count_read_kmers(pass1, ks, cfg.counter_size, batch_size, device).table
        chunks = pass2()
    else:
        chunks = iter_packed_chunks(cfg.read_files, chunk_reads)
    if resume_skip:  # the -M counter pass above counted every read
        chunks = skip_reads(chunks, resume_skip)
    step = make_step(tb, ks, device, mesh, counter, cfg.min_kmer_occ)

    def dispatch(st, rows, codes, lens):
        return (rows, lens), step(codes, lens)

    def on_result(st, meta, arr):
        rows, lens = meta
        lines = format_read_lines(tb, ks, [st.names[r] for r in rows], lens, arr)
        for r, line in zip(rows.tolist(), lines):
            st.lines[r] = line
        st.filled += len(rows)

    pipeline = ChunkedPipeline(on_result=on_result,
                               emit=lambda st: out.write("".join(st.lines)),
                               fetch=lambda results: [r.cpu().numpy() for r in results],
                               fail_after=fail_after_chunks())
    pipeline.run(chunks, make_state=_Chunk, dispatch=dispatch, batch_size=batch_size)
    return 0
