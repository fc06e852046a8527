"""`hpv16` command — tiered HPV type / lineage / sublineage classifier.

Counterpart of ``rkmh_tpu/commands/hpv16_cmd.py`` (rkmh main_hpv16,
rkmh.cpp:2366-2723) on one device.  Per read: the type whose
full hash set shares the most distinct hashes with the read's (the first
type wins ties), and the read's distinct shared counts with each lineage
and sublineage unique-k-mer table (each group's hashes minus those of
every other group of its family), ranked by similarity = count / hashnum.
Output lines, the ``lineage_specific_hashes.<k>.tst`` side file in the
working directory and the stderr table stats are byte-identical to
``rkmh-tpu hpv16``.

All of it reads one combined set table over the T types and the U unique
groups (``ops/lookup.build_set_table``): the hashing and the group
differences run on the device, the table is built on the host and copied
to the device once, where the set-probe kernel's packed layout of it is
made once as well (``ops/set_probe.pack_set_table``).  A panel whose
projected table passes RKMH_TPU_SET_TABLE_MAX_MB (default 2048) takes the
sorted-key panel instead (``ops/lookup.build_sorted_panel``, probed by
``engine.hpv16_sorted_batch``; rkmh_tpu/commands/hpv16_cmd.py:273-286),
with the same output.  With -M, a first pass counts every read k-mer in a
``hash % counter_size`` counter on the device (rkmh.cpp:2513-2530) and
the classify pass drops the k-mers counted fewer than min_kmer_occ times
before it sorts a read's hashes (rkmh.cpp:2663).  With -o FILE --resume,
FILE's complete lines count the reads already classified (a torn last line
is cut); those reads are skipped after the tables and the -M counter pass,
which still counts every read, and the rest is appended
(rkmh_tpu/commands/hpv16_cmd.py:136-157, 491-496).  Not ported yet:
--devices / --tp, --dist-* and the device-side table build.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import (
    ChunkState,
    ChunkedPipeline,
    count_read_kmers,
    iter_packed_chunks,
    load_packed,
    log,
    resolve_batch_size,
    resolve_chunk_reads,
    two_pass_chunks,
)
from rkmh_tpu_torch.commands.recovery import count_complete_lines, fail_after_chunks, skip_reads
from rkmh_tpu_torch.convert import sorted_panel_from_numpy
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from rkmh_tpu_torch.ops.lookup import (
    build_set_table,
    build_sorted_panel,
    count_unique_keys,
    projected_table_bytes,
)
from rkmh_tpu_torch.ops.set_probe import pack_set_table
from rkmh_tpu_torch.ops.sketch import INT64_MIN, SENTINEL
from rkmh_tpu_torch.ops.sorted_probe import build_directory

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
    devices: int = 0               # not ported yet (> 1)
    tp: int = 1                    # not ported yet (> 1)
    dist_coordinator: str = ""     # not ported yet
    dist_procs: int = 0            # not ported yet
    dist_rank: int = -1            # not ported yet
    device: str = DEFAULT_DEVICE


def not_ported(cfg: Hpv16Config) -> list[str]:
    """The rkmh-tpu hpv16 flags set in cfg that this port does not run yet."""
    return [flag for flag, given in (
        ("--devices", cfg.devices > 1),
        ("--tp", cfg.tp != 1),
        ("--dist-coordinator", bool(cfg.dist_coordinator)),
        ("--dist-procs", cfg.dist_procs > 1),
    ) if given]


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
    logical table), or past the set-table cap the sorted-key panel
    (``comb_sorted``, a ``SortedPanel``; then ``comb_table`` and
    ``probe_table`` are None); the name maps, the set-up seconds of each
    build phase, and the projected table bytes that chose between them."""

    __slots__ = ("type_names", "comb_table", "probe_table", "comb_sorted", "lin_names",
                 "sublin_names", "setup_s", "projected_bytes")

    @property
    def n_lin(self):
        return len(self.lin_names)

    @property
    def n_sub(self):
        return len(self.sublin_names)


class _PhaseClock:
    """Host seconds per set-up phase, each ended by a device sync."""

    def __init__(self, device: torch.device):
        self.device = device
        self.laps: dict[str, float] = {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


def _host_rows(hashes, mask) -> list[np.ndarray]:
    """Device rows -> the masked hashes of each row as host uint64 arrays."""
    h = hashes.cpu().numpy().view(np.uint64)
    m = mask.cpu().numpy()
    return [h[i][m[i]] for i in range(h.shape[0])]


def build_tables(cfg: Hpv16Config, ks: tuple, device: torch.device) -> Hpv16Tables:
    """Type panel + lineage/sublineage unique-k-mer tables as ONE combined
    set table (rkmh.cpp:2544-2653), with the .tst side file and the
    stderr stats.  Reference genomes are hashed at ks[0] only
    (rkmh.cpp:2546), as the reference does."""
    k0 = ks[0]
    tb = Hpv16Tables()
    clock = _PhaseClock(device)

    type_recs = load_packed([f"{cfg.refpath}/all_pave_ref.fa"])
    sub_recs = load_packed([f"{cfg.refpath}/new_refs.fa"])
    sub_names_all = list(sub_recs.names)
    lin_names = sorted({n[0] for n in sub_names_all})            # map<char,..>
    sublin_names = sorted({n[:2] for n in sub_names_all})        # map<string,..>
    clock.lap("parse")

    def hash_panel(packed):
        return engine.hash_batch_with_mask(torch.from_numpy(packed.codes).to(device),
                                           torch.from_numpy(packed.lens).to(device), (k0,))

    th, tm = hash_panel(type_recs)
    sh, sm = hash_panel(sub_recs)
    clock.lap("hash")

    lin_groups = [[i for i, n in enumerate(sub_names_all) if n[0] == ln] for ln in lin_names]
    sublin_groups = [[i for i, n in enumerate(sub_names_all) if n[:2] == sn]
                     for sn in sublin_names]
    lin_h, lin_keep = _family_unique(sh, sm, lin_groups)
    sub_h, sub_keep = _family_unique(sh, sm, sublin_groups)
    clock.lap("family_unique")

    # ref bit r is type r for r < T and unique group r - T after
    rows = _host_rows(th, tm) + _host_rows(lin_h, lin_keep) + _host_rows(sub_h, sub_keep)
    n_all = len(rows)
    # past the cap the bucket table would outgrow the card: the sorted-key
    # panel, ~10x smaller, instead (rkmh_tpu/commands/hpv16_cmd.py:273-286)
    cap_mb = int(os.environ.get("RKMH_TPU_SET_TABLE_MAX_MB", "2048"))
    tb.projected_bytes = projected_table_bytes(count_unique_keys(rows), n_all)
    tb.comb_table = tb.probe_table = tb.comb_sorted = None
    if tb.projected_bytes > cap_mb << 20:
        keys, masks = build_sorted_panel(rows, num_refs=n_all)
        clock.lap("host_build")
        directory = build_directory(keys)  # K10's bucket directory over the keys
        clock.lap("directory")
        tb.comb_sorted = sorted_panel_from_numpy(keys, masks, device, directory)
        clock.lap("h2d")
        log(f"hpv16 panel: projected bucket table exceeds "
            f"RKMH_TPU_SET_TABLE_MAX_MB={cap_mb}; using the sorted-key "
            f"panel ({keys.nbytes + masks.nbytes >> 20} MB)")
    else:
        table = build_set_table(rows, num_refs=n_all).table
        clock.lap("host_build")
        tb.comb_table = torch.from_numpy(table.view(np.int32)).to(device)
        clock.lap("h2d")
        tb.probe_table = tb.comb_table
        if device.type == "cuda":
            tb.probe_table = pack_set_table(tb.comb_table, n_all)
            clock.lap("repack")

    uniq_rows = [np.unique(r) for r in rows[len(type_recs):]]
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

    tb.type_names = list(type_recs.names)
    tb.lin_names = lin_names
    tb.sublin_names = sublin_names
    tb.setup_s = clock.laps
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


def run(cfg: Hpv16Config, out=None) -> int:
    missing = not_ported(cfg)
    if missing:
        raise ValueError(f"hpv16: {', '.join(missing)} not yet ported to rkmh-tpu-torch")
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


def _run(cfg: Hpv16Config, out, resume_skip: int = 0) -> int:
    device = resolve_device(cfg.device)
    batch_size = resolve_batch_size(cfg.batch_size, device)
    if not cfg.ks:
        log("NO KMER SIZE PROVIDED. USING A DEFAULT KMER SIZE OF 16")
    ks = tuple(cfg.ks) if cfg.ks else (16,)
    chunk_reads = resolve_chunk_reads(cfg.chunk_reads)

    tb = build_tables(cfg, ks, device)
    num_types, num_uniq = len(tb.type_names), tb.n_lin + tb.n_sub
    counter = None
    if cfg.min_kmer_occ > 0:
        pass1, pass2 = two_pass_chunks(cfg.read_files, chunk_reads)
        counter = count_read_kmers(pass1, ks, cfg.counter_size, batch_size, device).table
        chunks = pass2()
    else:
        chunks = iter_packed_chunks(cfg.read_files, chunk_reads)
    if resume_skip:  # the -M counter pass above counted every read
        chunks = skip_reads(chunks, resume_skip)

    def dispatch(st, rows, codes, lens):
        # the probe width comes from the UNPADDED lengths (engine docstring)
        Wc = engine.hpv16_compact_width(lens, codes.shape[1], ks)
        batch = torch.from_numpy(codes).to(device, non_blocking=True)
        if tb.comb_sorted is not None:
            return (rows, lens), engine.hpv16_sorted_batch(
                batch, tb.comb_sorted, ks, num_types, num_uniq, Wc, counter, cfg.min_kmer_occ)
        return (rows, lens), engine.hpv16_batch_comb(batch, tb.probe_table, ks, num_types,
                                                     num_uniq, Wc, counter, cfg.min_kmer_occ)

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
