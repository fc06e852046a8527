"""`call` command: alignment-free variant calling, VCF output.

Counterpart of ``rkmh_tpu/commands/call_cmd.py`` on one device (rkmh's
main_call, rkmh.cpp:1455-1904).  Flow: hash every read k-mer (K1) ->
the exact hash -> depth map, built on the host from ``np.unique``'s sorted
keys and counts (``ops/hashmap.SortedMap``) and copied to the device
-> per reference: positional depth, trailing-window average, low-depth
sites and the SNP/DEL rescue scan (``call_engine``: K1, K8, K9) -> records
aggregated into VCF lines keyed and sorted as the reference's
std::map<string> (lexicographic over "ref\\tpos\\t.\\tREF\\tALT", so
positions sort as strings: 10 < 2).

Kept byte for byte (rkmh.cpp:1740-1747): the header's INFO declares ID=KD
while records print KC=, and the RD and OD INFO lines share one line.  As
in rkmh-tpu, ``-d`` prints its "j\\tavg\\tdepth\\trescue" lines (rkmh builds
them and never prints them) in place of the VCF.  With ``-o FILE``, each
reference's aggregate goes to the JSON-lines sidecar ``FILE.progress``
as it is scanned, and ``--resume`` merges the complete sections and scans
only the rest, so the VCF equals an uninterrupted run's.

Not ported yet: ``--devices`` and ``--dist-*`` (rejected by the CLI).
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from rkmh_tpu_torch import call_engine
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import (
    bucketed_batches, load_packed, load_records, log, resolve_batch_size,
)
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.ops.hashmap import SortedMap, build_sorted_map, unique_counts

_BASE = "ACGT"


@dataclass
class CallConfig:
    ref_files: list = field(default_factory=list)
    read_files: list = field(default_factory=list)
    ks: tuple = ()
    window_len: int = 100
    show_depth: bool = False
    batch_size: int = 2048   # reads a K1 batch of the depth map; 0 = auto
    out_file: str = ""       # -o: write the VCF here (required for --resume)
    resume: bool = False     # skip refs whose partials are checkpointed
    device: str = DEFAULT_DEVICE


def _code_char(c: int) -> str:
    return _BASE[c] if c < 4 else "N"


class CallAggregator:
    """The reference's four per-key maps (rkmh.cpp:1818-1830) and the
    JSON-lines partial format of the .progress sidecar.  Aggregation
    commutes (count sum, depth maxes), so sections merge exactly."""

    def __init__(self):
        self.count: dict[str, int] = {}
        self.max_depth: dict[str, int] = {}
        self.avg_depth: dict[str, int] = {}
        self.orig_depth: dict[str, int] = {}

    def record(self, key: str, alt_depth: int, avg_d: int, depth: int):
        self.count[key] = self.count.get(key, 0) + 1
        self.avg_depth[key] = max(avg_d, self.avg_depth.get(key, 0))
        self.orig_depth[key] = max(depth, self.orig_depth.get(key, 0))
        if alt_depth > self.max_depth.get(key, 0):
            self.max_depth[key] = alt_depth

    def merge_entry(self, e: dict):
        k = e["key"]
        self.count[k] = self.count.get(k, 0) + int(e["c"])
        self.max_depth[k] = max(int(e["m"]), self.max_depth.get(k, 0))
        self.avg_depth[k] = max(int(e["a"]), self.avg_depth.get(k, 0))
        self.orig_depth[k] = max(int(e["o"]), self.orig_depth.get(k, 0))

    def dump_lines(self) -> list[str]:
        """One JSON line per key; merge_entry of every line into a fresh
        aggregator reproduces this one exactly."""
        return [
            json.dumps({
                "key": k, "c": c,
                "m": self.max_depth.get(k, 0),
                "a": self.avg_depth.get(k, 0),
                "o": self.orig_depth.get(k, 0),
            }) + "\n"
            for k, c in self.count.items()
        ]

    def merge_from(self, other: "CallAggregator"):
        for k, c in other.count.items():
            self.merge_entry({
                "key": k, "c": c, "m": other.max_depth.get(k, 0),
                "a": other.avg_depth.get(k, 0),
                "o": other.orig_depth.get(k, 0),
            })

    def emit_vcf_records(self, out):
        for key in sorted(self.count):  # std::map iteration order
            out.write(
                f"{key}\t99\tPASS\tKC={self.count[key]};"
                f"MD={self.max_depth.get(key, 0)};"
                f"RD={self.avg_depth.get(key, 0)};"
                f"OD={self.orig_depth.get(key, 0)}\n"
            )


def vcf_header(ref_file: str) -> str:
    """Header quirks preserved: KD vs KC, RD+OD on one line
    (rkmh.cpp:1740-1747)."""
    return (
        "##fileformat=VCF4.2\n##source=rkmh\n"
        f"##reference={ref_file}\n"
        '##INFO=<ID=KD,Number=1,Type=Integer,Description="Number of times call for specific kmer appears">\n'
        '##INFO=<ID=MD,Number=1,Type=Integer,Description="Maximum depth found for the rescue kmer.">\n'
        '##INFO=<ID=RD,Number=1,Type=Integer,Description="Average depth in region">'
        '##INFO=<ID=OD,Number=1,Type=Integer,Description="Depth of original kmer at site before modification.">\n'
    )


def extract_records(ref_name, codes_row, res, P: int, k: int, record,
                    j_lo: int = 0, j_hi: int | None = None,
                    row_off: int = 0):
    """Walk one (stripe of a) scan result, as host arrays, and feed the
    aggregator.  res arrays are indexed [j - row_off]; only positions j
    in [j_lo, min(j_hi, P)) are recorded."""
    j_hi = P if j_hi is None else min(j_hi, P)
    if j_hi <= j_lo:
        return
    row = codes_row
    win = np.lib.stride_tricks.sliding_window_view(row, k)[:P]
    dpad = np.concatenate([np.full(1, 4, np.uint8), row])
    dwin = np.lib.stride_tricks.sliding_window_view(dpad, k + 1)[:P]

    sl = slice(j_lo - row_off, j_hi - row_off)
    depth = res["depth"][sl]
    avg = res["avg"][sl]
    snp_call = res["snp_call"][sl]
    snp_depth = res["snp_depth"][sl]
    del_call = res["del_call"][sl]
    del_depth = res["del_depth"][sl]

    for j, ap, b in zip(*np.nonzero(snp_call)):
        jg = int(j) + j_lo
        orig = _code_char(int(win[jg, ap]))
        alt = _code_char(int(call_engine.ROT[int(win[jg, ap]), b]))
        pos = jg + int(ap) + 1
        key = f"{ref_name}\t{pos}\t.\t{orig}\t{alt}"
        record(key, int(snp_depth[j, ap, b]), int(avg[j]), int(depth[j]))

    for j, api in zip(*np.nonzero(del_call)):
        jg = int(j) + j_lo
        ap = int(api) + 1               # the reference loops alt_pos in [1, k]
        orig = _code_char(int(dwin[jg, ap]))
        pos = jg + ap + 1
        key = f"{ref_name}\t{pos}\t.\t{orig}\t-"
        record(key, int(del_depth[j, api]), int(avg[j]), int(depth[j]))


def build_depth_map(reads, ks: tuple, batch_size: int, device: torch.device,
                    stats: dict | None = None) -> SortedMap:
    """The exact hash -> depth map over every read k-mer occurrence, zeros
    included (rkmh.cpp:1616-1623), on ``device``: K1 over bucketed
    batches, the existing windows' hashes fetched to the host,
    ``np.unique``, the sorted map laid out from its keys and counts, then
    one copy to the device.  ``stats`` (a dict) gets the seconds of the
    hashing, the unique and the layout, the map's keys and its bytes by
    part."""
    t0 = time.perf_counter()
    parts = []
    for _, codes, lens in bucketed_batches(reads, batch_size):
        batch = torch.from_numpy(codes).to(device)
        hashes, mask = engine.hash_batch_with_mask(batch, torch.from_numpy(lens).to(device), ks)
        parts.append(hashes[mask].cpu().numpy())
    t1 = time.perf_counter()
    keys, counts = unique_counts(np.concatenate(parts) if parts else np.zeros(0, np.int64))
    t2 = time.perf_counter()
    sm = build_sorted_map(keys, counts)
    t3 = time.perf_counter()
    sm = sm.to(device)
    if stats is not None:
        stats.update(read_hashing_s=t1 - t0, map_unique_s=t2 - t1, map_layout_s=t3 - t2,
                     map_copy_s=time.perf_counter() - t3, map_keys=sm.n, map_bits=sm.bits,
                     map_overflow=sm.m, map_bytes=sm.buf.numel() * 8,
                     map_part_bytes=sm.part_bytes())
    return sm


def load_partials(path: str, truncate: bool = False):
    """(complete-ref names in order, merged aggregator) from a partial
    JSON-lines file; sections without a ref_done marker are dropped
    (crash mid-section), and with truncate=True the file is cut back to
    its complete prefix so appended sections parse on the NEXT resume."""
    done: list[str] = []
    agg = CallAggregator()
    if not os.path.exists(path):
        return done, agg
    pending: list[dict] = []
    good_end = 0
    pos = 0
    with open(path, "rb") as fh:
        for raw in fh:
            pos += len(raw)
            try:
                e = json.loads(raw)
            except json.JSONDecodeError:
                break  # truncated tail (crash mid-write)
            if "ref_done" in e:
                if e.get("n") != len(pending):
                    break  # inconsistent section; treat as truncated
                for p in pending:
                    agg.merge_entry(p)
                pending = []
                done.append(e["ref_done"])
                good_end = pos
            else:
                pending.append(e)
    if truncate and os.path.getsize(path) != good_end:
        with open(path, "r+b") as fh:
            fh.truncate(good_end)
    return done, agg


def run(cfg: CallConfig, out=None, stats: dict | None = None) -> int:
    """``stats`` (a dict), if given, gets the seconds of each phase
    (parse, read hashing, the map's unique, layout and copy, scan, record
    extraction, write) and the depth map's keys and bytes on the device."""
    out = out or sys.stdout
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")
        ks = (16,)
    elif len(cfg.ks) > 1:
        log("Only a single kmer size may be used for calling.")
        return 1
    else:
        ks = tuple(cfg.ks)
    k = ks[0]

    if cfg.resume and not cfg.out_file:
        log("call --resume requires -o <file> (resume state is the "
            ".progress sidecar next to it)")
        return 1

    if not cfg.ref_files or not cfg.read_files:
        log("call requires at least one reference and one read file.")
        return 1
    device = resolve_device(cfg.device)
    stats = {} if stats is None else stats
    phase = {"parse_s": 0.0, "scan_s": 0.0, "extract_s": 0.0, "write_s": 0.0}
    t0 = time.perf_counter()
    log("Parsing sequences...")
    refs = load_records(cfg.ref_files)
    reads = load_packed(cfg.read_files)
    phase["parse_s"] = time.perf_counter() - t0
    if not refs or not len(reads):
        log("call requires at least one reference and one read file.")
        return 1

    table = build_depth_map(reads, ks, resolve_batch_size(cfg.batch_size, device), device,
                            stats)

    if len(refs) > 1:
        log("WARNING: more than one ref provided. VCF will not be correct")

    output_vcf = not cfg.show_depth

    # --resume: per-ref partial aggregates checkpoint into a .progress
    # sidecar; completed refs skip their scan and their sections merge
    # back (aggregation commutes, so the VCF is an uninterrupted run's)
    agg = CallAggregator()
    done_refs: list[str] = []
    progress_fh = None
    if cfg.out_file and output_vcf:
        ppath = f"{cfg.out_file}.progress"
        if cfg.resume:
            done_refs, agg = load_partials(ppath, truncate=True)
            if done_refs:
                log(f"call --resume: {len(done_refs)} reference(s) already "
                    f"scanned in {ppath}")
            progress_fh = open(ppath, "a")
        else:
            progress_fh = open(ppath, "w")

    done_iter = iter(done_refs)
    pending_done = next(done_iter, None)
    try:
        for ref in refs:
            if len(ref.seq) < k:
                continue
            if pending_done is not None and pending_done == ref.name:
                pending_done = next(done_iter, None)
                continue  # --resume: this ref's section is already merged
            P = len(ref.seq) - k + 1
            t0 = time.perf_counter()
            codes, _ = encode_seqs([ref.seq])
            row = codes[0, : len(ref.seq)]
            res = call_engine.call_scan_ref(torch.from_numpy(row).to(device), table, k,
                                            cfg.window_len)
            res = {name: v.cpu().numpy() for name, v in res.items()}
            t1 = time.perf_counter()
            phase["scan_s"] += t1 - t0

            if cfg.show_depth:
                depth, avg, rescue = res["depth"], res["avg"], res["max_rescue"]
                shown = np.where(rescue > 0, rescue, depth)
                for j in range(P):
                    out.write(f"{j}\t{avg[j]}\t{depth[j]}\t{shown[j]}\n")
                phase["write_s"] += time.perf_counter() - t1
                continue

            ref_agg = CallAggregator()
            extract_records(ref.name, row, res, P, k, ref_agg.record)
            if progress_fh is not None:
                lines = ref_agg.dump_lines()
                progress_fh.writelines(lines)
                progress_fh.write(json.dumps({"ref_done": ref.name, "n": len(lines)}) + "\n")
                progress_fh.flush()
            agg.merge_from(ref_agg)
            phase["extract_s"] += time.perf_counter() - t1
    finally:
        if progress_fh is not None:
            progress_fh.close()

    if output_vcf:
        t0 = time.perf_counter()
        dest = open(cfg.out_file, "w") if cfg.out_file else out
        try:
            dest.write(vcf_header(cfg.ref_files[0]))
            agg.emit_vcf_records(dest)
        finally:
            if cfg.out_file:
                dest.close()
        phase["write_s"] += time.perf_counter() - t0
    stats.update(phase)
    return 0
