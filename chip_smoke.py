#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rkmh_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It fails (non-zero exit, no result
line) without CUDA or without the package beside it.  In order it:

1. reports the card (torch and nvidia-smi);
2. builds the CUDA kernels from ``rkmh_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and times the build;
3. checks the window-hash kernel (K1) bit for bit against its plain
   PyTorch version on the card: random codes with invalid bases, poly-A
   and (AC)n rows, k in {1, 4, 12, 16, 17, 18, 31, 32, 33, 64} (packed
   variant to 32, one instance compiled for each k; byte-wise above) and
   multi-k;
4. checks the panel-probe kernel (K2) against its plain version on a
   synthetic zika-shaped panel (60 refs, k=12, s=1000) at B=16384, in
   both row modes and with thresholds, and prints the probes, hits and
   mask bits per read; then on duplicate-heavy rows (a value 40 times, a
   row of one value) with R = 60, 200 and 257 (counters in 2 registers,
   in 8, in shared memory), both row modes and both epilogues, and on raw
   rows of 1,000 and 12,000 hashes (ranks tables of 3n and of n slots
   per read, one of them filled by a row of distinct values); outputs
   must be equal;
5. times both kernels and their plain versions at the stream slice's
   shapes (B=16384, L=160, k=12, zika table) with CUDA events, and
   computes their bounds (``bench/bounds.py``: bytes over 3.35 TB/s).
   Every kernel's (and library call's) time is device time, its calls
   replayed from a CUDA graph (``bench/timing.cuda_graph_time_ms``); an
   eager loop of a tens-of-microseconds kernel measures its Python
   wrapper, so that time is kept beside it as ``eager_ms``; plain
   versions are timed eagerly;
6. drives the stream slice: synthetic 60 x 10,807 bp panel and 2**20
   reads of 150 bp through ``commands.stream.run`` (k=12, s=1000, device
   cuda), with the launch counters zeroed just before and read just
   after; it checks one line per read, that K1 and K2 ran, and that the
   first 16,384 lines equal the port's CPU plain-path output on the same
   reads; it reports e2e reads/s, device-step reads/s over resident
   batches and the share of reads assigned to their source genome;
7. checks the LUT-gather kernels (K4, K5) bit for bit against their plain
   versions at every N of the gather sweep and times both, beside one
   ``torch.gather`` on an int64 index (the library yardstick);
8. drives the gather path, ``rkmh_tpu_torch.bench.bench_gather.main()``,
   with the counters zeroed just before and read just after;
9. builds the hpv16 tables on the card from a synthetic full-width
   refpath (182 types of ~7.9 kb, 10 sublineages, k=18), the kernel's
   packed layout of the set table included (once, timed), and checks the
   set-probe kernel (K3) against its plain version on the logical table
   (and K1 against its own) on 512 nanopore-like reads, on the same
   batch with every seventh read emptied, on one 40 kb read and on a
   small table of 280 references (9 mask words), outputs exactly equal;
   checks that the batch launches more blocks than reads; times both and
   counts the table sectors K3 reaches in either layout;
10. drives the hpv16 slice: 12,800 reads (~57 Mbp) through
    ``commands.hpv16_cmd.run`` (k=18, batch 512, device cuda) in a
    temporary working directory, counters zeroed just before and read
    just after; it checks one line per read, that K1 and K3 ran, and
    that the first 64 lines and the .tst file equal the CPU plain path's;
    it reports the table, the set-up seconds, e2e and device-step Mbp/s
    and reads/s, the share of reads typed as their source type, and one
    step at the auto batch size;
11. checks the counter kernels (K6 counter_add, K7 counter_mask) exactly
    against their plain versions on the card: random hashes (>= 2**63 and
    zeros among them) with a mask tensor, with the window mask derived in
    the kernel from read lengths and without a mask, three calls into one
    table, through the bins and as one atomic per element, at counter
    sizes 2e8, 1e7, 2**27 and the prime 1009; times both and their plain
    versions at the stream shape (B=16384, L=160, k=12, the counter
    pass's window mask, derived in the kernel) on a 2e8-slot counter, and
    reports how many distinct slots one batch adds to and K6's time on as
    many random hashes; checks that a ``HashCounter`` keeps the bins for
    the batch and leaves them for the random hashes;
12. checks K2's filter mode against its plain version on the zika panel
    in both row modes with -N/-D thresholds, and times it;
13. drives ``stream -M 2 -I 40`` over the slice's 2**20 reads (default
    2e8-slot counters, device cuda), counters zeroed just before and read
    just after (K1, K6, K7 and K2 must run); checks one line per read and
    that the whole first 16,384 reads, run alone, give byte-identical
    output on the card and on the CPU plain path; reports e2e reads/s,
    the counter pass's seconds and the device step;
14. drives ``filter -M 2 -I 40 -N 10`` over the same reads with -o (K1,
    K6, K7 and K2's filter mode must run); checks that the records
    written equal the reads kept, that the whole first 16,384 reads give
    byte-identical output on the card and the CPU, and that a ``-f`` plus
    ``-i`` run over them (the stream given as a file object) does too;
    reports e2e reads/s and the share of reads kept;
15. drives ``hpv16 -M 2`` over 12,800 reads with N bases (default
    8e8-slot counter; K1, K6, K7 and K3 must run); checks that a whole
    256-read input gives byte-identical stdout and .tst on the card and
    the CPU; reports e2e Mbp/s.

The last three lines are the card's name and power limit, the kernels'
JSON record (per kernel: launches on the driven paths, in all and by
path, max_abs_err against the plain version, ms, eager_ms, plain_ms, bound_ms,
bound_by, bound_share = bound_ms / ms, and library_ms, one PyTorch call
computing the same function where there is one: ``torch.gather`` for K4
and K5, none for the others) and ``{"ok": true, "device": {...}}``.  Any
failure raises.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_SLICE_READS = 1 << 20
N_CPU_LINES = 16384
B = 16384
KS_K1 = (1, 4, 12, 16, 17, 18, 31, 32, 33, 64)  # packed k <= 32, byte-wise above
GATHER_NS = (8, 64, 512, 4096, 16384)
N_HPV16_READS = 12800
N_HPV16_CPU_LINES = 64
HPV16_K = 18
HPV16_BATCH = 512
COUNTER_SIZES = (200_000_000, 10_000_000, 1 << 27, 1009)
MIN_OCC, MAX_SAMPLES, FILTER_MIN_MATCHES = 2, 40, 10
N_HPV16_M_CPU_READS = 256
HPV16_N_RATE = 0.001


def say(msg: str) -> None:
    print(msg, flush=True)


def reads_to_codes(ascii_reads, L: int):
    """[n, read_len] ASCII -> [n, L] uint8 codes, 255-padded."""
    import numpy as np

    from rkmh_tpu_torch.io.packing import CODE_LUT

    codes = np.full((len(ascii_reads), L), 255, np.uint8)
    codes[:, : ascii_reads.shape[1]] = CODE_LUT[ascii_reads]
    return codes


def max_abs_err(got, want) -> int:
    """Largest |got - want| over integer tensors; 0 means bit-identical."""
    return int((got.to(want.dtype) - want).abs().max()) if want.numel() else 0


def require_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {path} path")


def check_k1(dev) -> int:
    import numpy as np
    import torch

    from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain, multi_k_window_hashes

    rng = np.random.default_rng(7)
    # 2047 rows: the flattened windows end inside a block of the packed variant
    codes = rng.integers(0, 4, size=(2047, 160), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[rng.random(codes.shape) < 0.005] = 255
    codes[:, 150:] = 255
    codes[:16, :150] = 0  # duplicate-heavy: poly-A reads and (AC)n repeats
    codes[16:32, :150] = np.arange(150) % 2
    x = torch.from_numpy(codes).to(dev)
    worst = 0
    for k in KS_K1:
        got = multi_k_window_hashes(x, [k])
        want = kmer_window_hashes_plain(x, k)
        err = max_abs_err(got, want)
        say(f"K1 k={k}: {tuple(got.shape)} bit-exact={err == 0} "
            f"nonzero={int((want != 0).sum())}")
        if err or not torch.equal(got, want):
            raise AssertionError(f"window-hash kernel disagrees with the plain version at k={k}")
        worst = max(worst, err)
    got = multi_k_window_hashes(x, [12, 16, 33])
    want = torch.cat([kmer_window_hashes_plain(x, k) for k in (12, 16, 33)], dim=-1)
    if not torch.equal(got, want):
        raise AssertionError("window-hash kernel disagrees with the plain version at multi-k")
    say(f"K1 multi-k (12, 16, 33): {tuple(got.shape)} bit-exact=True")
    return worst


def zika_panel(dev):
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.commands.common import PyPacked, build_ref_panel
    from rkmh_tpu_torch.io.fastx import SeqRecord

    names, genomes = synth.make_panel()
    ascii_g = synth._ACGTN[genomes]
    recs = [SeqRecord(n, g.tobytes()) for n, g in zip(names, ascii_g)]
    return build_ref_panel(PyPacked(recs), (12,), 1000, dev), genomes


def check_k2(dev, panel, genomes) -> tuple:
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
    from rkmh_tpu_torch.ops.probe import _panel_probe_cuda, panel_probe_plain
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    reads, _ = synth.make_reads(genomes, B, seed=11)
    codes = torch.from_numpy(reads_to_codes(reads, 160)).to(dev)
    hashes = multi_k_window_hashes(codes, [12])
    R = panel.num_refs
    worst = 0
    for s in (1000, 50):
        sk, lens = bottom_s_sketch(hashes, s)
        for mode, rows, ln in (("a raw", hashes, None), (f"b sketch s={s}", sk, lens)):
            if s != 1000 and ln is None:
                continue
            for min_diff, min_matches in ((0, -1), (2, 60)):
                got = _panel_probe_cuda(rows, ln, panel.table, R, min_diff, min_matches)
                want = panel_probe_plain(rows, ln, panel.table, R, min_diff, min_matches)
                err = max_abs_err(got, want)
                say(f"K2 mode {mode} -D {min_diff} -N {min_matches}: exact={err == 0} "
                    f"mean shared={want[1].float().mean().item():.2f} "
                    f"flag histogram={torch.bincount(want[2], minlength=8).tolist()}")
                if err or not torch.equal(got, want):
                    raise AssertionError(f"panel-probe kernel disagrees in mode {mode}")
                worst = max(worst, err)
    # the counting design's premise: hits are a minority of the probes
    st = bounds.panel_probe_stats(hashes, None, panel.table, R)
    say(f"K2 raw rows: {st.probes / B:.2f} probes, {st.hits / B:.2f} hits per read; a hit's "
        f"mask holds {st.mask_bits / max(st.hits, 1):.2f} of {R} reference bits; the probes "
        f"reach {st.table_bytes} bytes of the {panel.table.numel() * 4}-byte table")
    return worst, (codes, hashes), st


def dup_heavy_panel(dev, R: int, n_reads: int, width: int = 149):
    """A table over R random references in which references 0 and R-1
    hold one value 40 times, and raw rows of `width` hashes drawn from the
    same pool: a third hold that value 40 times, a third nothing else (a
    low-complexity read), a third two values alternating; 5% zeros.  The
    last row holds distinct values (60 from the pool), so a ranks table of
    one slot per element fills up."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.ops.lookup import build_panel_table
    from rkmh_tpu_torch.ops.sketch import SENTINEL

    rng = np.random.default_rng(R)
    pool = rng.integers(1, 2**63, size=4096, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    v = pool[0]
    sk = np.full((R, 1000), SENTINEL, dtype=np.int64)
    for r in range(R):
        vals = rng.choice(pool[1:], 1000)
        if r in (0, R - 1):
            vals[:40] = v
        sk[r] = np.sort(vals.view(np.uint64)).view(np.int64)
    table = build_panel_table(sk, np.full(R, 1000, np.int32)).table.view(np.int32)
    rows = rng.choice(pool, size=(n_reads, width))
    rows[0::3, rng.permutation(width)[:40]] = v
    rows[1::3] = v
    rows[2::3, ::2] = pool[5]
    rows[rng.random(rows.shape) < 0.05] = 0
    rows[-1] = rng.integers(1, 2**63, size=width)
    rows[-1, :60] = np.unique(pool)[:60]
    if np.unique(rows[-1]).size != width:
        raise AssertionError("the distinct row repeats a value")
    return torch.from_numpy(table).to(dev), torch.from_numpy(rows).to(dev)


def check_k2_variants(dev) -> int:
    """K2 on duplicate-heavy rows, with its counters in 2 registers (R =
    60), in 8 (R = 200) and in shared memory (R = 257), both row modes,
    both epilogues; B = 4099 is no multiple of the reads per block.  Then
    raw rows wider than the engine sends (NOSORT_MAX_W = 256), which the
    kernel takes: 1,000 (3n ranks slots per read, R = 60 and 257) and
    12,000 (n slots: 3n do not fit in shared memory; the distinct row
    fills its table), both epilogues."""
    import torch

    from rkmh_tpu_torch.ops.probe import (
        _panel_probe_cuda,
        _panel_probe_filter_cuda,
        panel_probe_filter_plain,
        panel_probe_plain,
    )
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    worst = 0
    cases = [(60, 149, 4099, "2 register counters"), (200, 149, 4099, "8 register counters"),
             (257, 149, 4099, "shared counters"), (60, 1000, 99, "3n ranks slots"),
             (257, 1000, 99, "3n ranks slots, shared counters"),
             (60, 12000, 5, "n ranks slots")]
    for R, width, n_reads, variant in cases:
        table, raw = dup_heavy_panel(dev, R, n_reads, width)
        ref_lens = torch.full((R,), 1000, dtype=torch.int32, device=dev)
        modes = [("raw", raw, None)]
        if width == 149:
            modes.append(("sorted s=50", *bottom_s_sketch(raw, 50)))
        for mode, rows, ln in modes:
            got = _panel_probe_cuda(rows, ln, table, R, 1, 20)
            want = panel_probe_plain(rows, ln, table, R, 1, 20)
            got_f = _panel_probe_filter_cuda(rows, ln, table, R, ref_lens, 1, 20)
            want_f = panel_probe_filter_plain(rows, ln, table, R, ref_lens, 1, 20)
            err = max(max_abs_err(got, want), max_abs_err(got_f, want_f))
            say(f"K2 duplicate-heavy R={R} width={width} ({variant}), {mode}: "
                f"exact={err == 0}, max shared {int(want[1].max())}, distinct row shared "
                f"{int(want[1, -1])}, flag histogram "
                f"{torch.bincount(want[2], minlength=8).tolist()}")
            if err or not (torch.equal(got, want) and torch.equal(got_f, want_f)):
                raise AssertionError(f"panel-probe kernel disagrees on duplicate-heavy rows, "
                                     f"R={R}, width={width}, {mode}")
            worst = max(worst, err)
        if int(want[1].max()) < 40:
            raise AssertionError("the duplicate-heavy rows did not reach rank 40")
    return worst


def time_kernels(panel, codes, hashes, k2_stats) -> dict:
    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops.hashing import _window_hashes_cuda, kmer_window_hashes_plain
    from rkmh_tpu_torch.ops.probe import _panel_probe_cuda, panel_probe_plain

    R = panel.num_refs
    B = codes.shape[0]
    rows_and_table = bounds.tensor_bytes(hashes) + k2_stats.table_bytes
    t = {
        "window_hash": cuda_graph_time_ms(lambda: _window_hashes_cuda(codes, [12], 42), 20),
        "window_hash_eager": cuda_time_ms(lambda: _window_hashes_cuda(codes, [12], 42), 50),
        "window_hash_plain": cuda_time_ms(lambda: kmer_window_hashes_plain(codes, 12), 10),
        "panel_probe": cuda_graph_time_ms(
            lambda: _panel_probe_cuda(hashes, None, panel.table, R, 0, -1), 20),
        "panel_probe_eager": cuda_time_ms(
            lambda: _panel_probe_cuda(hashes, None, panel.table, R, 0, -1), 50),
        "panel_probe_plain": cuda_time_ms(
            lambda: panel_probe_plain(hashes, None, panel.table, R, 0, -1), 5),
    }
    for name, ms in t.items():
        say(f"time {name}: {ms:.4f} ms per call at B={codes.shape[0]}, "
            f"L={codes.shape[1]}, k=12, table {tuple(panel.table.shape)}")
    bound = {"window_hash": bounds.bound_ms(bounds.tensor_bytes(codes, hashes)),
             "panel_probe": bounds.bound_ms(rows_and_table + 3 * 4 * B),
             "panel_probe_filter": bounds.bound_ms(rows_and_table + 4 * R + 5 * 4 * B)}
    say(f"bounds (ms, bytes over 3.35 TB/s): {bound}")
    return t, bound


def bound_fields(ms: float, bound_ms: float, library_ms=None) -> dict:
    return {"bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / ms,
            "library_ms": library_ms}


def write_zika(tmp: str) -> dict:
    """The stream slice's input: the zika-shaped panel and 2**20 reads
    (with N bases at synth.N_RATE), plus a file of the first N_CPU_LINES."""
    from rkmh_tpu_torch import synth

    t0 = time.perf_counter()
    refs, reads, names, src = synth.write_workload(tmp, N_SLICE_READS)
    head = os.path.join(tmp, "head.fq")
    with open(reads) as src_fh, open(head, "w") as dst:
        for _ in range(4 * N_CPU_LINES):
            dst.write(src_fh.readline())
    say(f"slice input: {N_SLICE_READS} reads x {synth.READ_LEN} bp, "
        f"{len(names)} refs x {synth.GENOME_LEN} bp, made in "
        f"{time.perf_counter() - t0:.2f} s")
    return {"dir": tmp, "refs": refs, "reads": reads, "head": head, "names": names,
            "src": src}


def driven(fn, path: str, kernels_needed) -> tuple[float, dict]:
    """Run one main path with the launch counters zeroed just before and
    read just after; -> (wall seconds, launches).  Raises if a kernel of
    the path was not launched."""
    import torch

    from rkmh_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    say(f"{path} launches: {launches}")
    require_launches(launches, kernels_needed, path)
    return seconds, launches


def read_text(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def require_same(gpu: str, cpu: str, what: str) -> None:
    """Byte-identical GPU and CPU outputs, or an error naming the first
    differing line."""
    if gpu != cpu:
        g, c = gpu.splitlines(), cpu.splitlines()
        bad = next((i for i, (a, b) in enumerate(zip(g, c)) if a != b), min(len(g), len(c)))
        raise AssertionError(f"{what}: GPU and CPU outputs differ at line {bad} "
                             f"({len(g)} vs {len(c)} lines)")


def run_slice(dev, card: str, panel, zika: dict) -> dict:
    import numpy as np
    import torch

    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import stream

    tmp = zika["dir"]
    out_gpu = os.path.join(tmp, "gpu.tsv")
    cfg = dict(ref_files=[zika["refs"]], ks=(12,), sketch_size=1000)
    e2e_s, launches = driven(
        lambda: stream.run(stream.StreamConfig(read_files=[zika["reads"]], out_file=out_gpu,
                                               device="cuda", **cfg)),
        "stream", ("window_hash", "panel_probe"))

    with open(out_gpu) as fh:
        gpu_lines = fh.readlines()
    if len(gpu_lines) != N_SLICE_READS:
        raise AssertionError(f"{len(gpu_lines)} lines for {N_SLICE_READS} reads")
    for i in (0, len(gpu_lines) - 1):
        if gpu_lines[i].split("\t")[1] != f"read{i}":
            raise AssertionError(f"line {i} is out of order: {gpu_lines[i]!r}")

    out_cpu = os.path.join(tmp, "cpu.tsv")
    t0 = time.perf_counter()
    stream.run(stream.StreamConfig(read_files=[zika["head"]], out_file=out_cpu,
                                   device="cpu", **cfg))
    cpu_s = time.perf_counter() - t0
    require_same("".join(gpu_lines[:N_CPU_LINES]), read_text(out_cpu), "stream")
    say(f"slice: first {N_CPU_LINES} GPU lines byte-identical to the CPU plain "
        f"path ({cpu_s:.2f} s on the CPU)")

    assigned = np.array([ln.split("\t", 1)[0] for ln in gpu_lines])
    share = float(np.mean(assigned == np.asarray(zika["names"])[zika["src"]]))

    # device step over resident batches (parse and format excluded)
    genomes = synth.make_panel()[1]
    reads_ascii, _ = synth.make_reads(genomes, N_SLICE_READS, seed=5)
    codes = torch.from_numpy(reads_to_codes(reads_ascii, 160)).to(dev)
    batches = list(torch.split(codes, B))
    step = lambda: [engine.classify_codes_table(b, panel, (12,), 1000, 0, -1)  # noqa: E731
                    for b in batches]
    step_ms = cuda_time_ms(step, 3, warmup=1)
    res = {
        "e2e_reads_per_s": N_SLICE_READS / e2e_s,
        "e2e_s": e2e_s,
        "device_step_reads_per_s": N_SLICE_READS / (step_ms / 1e3),
        "device_step_ms_per_16k_batch": step_ms / len(batches),
        "assigned_to_source_share": share,
        "launches": launches,
    }
    say(f"slice on {card}: e2e {res['e2e_reads_per_s']:.1f} reads/s "
        f"({e2e_s:.2f} s for {N_SLICE_READS} reads, panel build and parse included); "
        f"device step {res['device_step_reads_per_s']:.1f} reads/s "
        f"({res['device_step_ms_per_16k_batch']:.4f} ms per {B}-read batch); "
        f"assigned to source genome {share:.4f}")
    return res


def check_gathers(dev) -> dict:
    """K4 at every N of the sweep and K5 against their plain versions;
    returns {name: (max_abs_err, ms, plain_ms, library_ms, bound_ms)} at
    the sweep's largest N for K4 and at N = 512 for K5.  The library call
    is one ``torch.gather`` on an index made int64 before the timing."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops import gather

    rng = np.random.default_rng(13)
    res = {}
    cases = [("lut_gather_rows", gather._lut_gather_rows_cuda, gather.lut_gather_rows_plain,
              N, N) for N in GATHER_NS]
    cases.append(("lut_gather_lanes", gather._lut_gather_lanes_cuda,
                  gather.lut_gather_lanes_plain, 512, 128))
    for name, kern, plain, N, hi in cases:
        lut = torch.from_numpy(rng.integers(-2**31, 2**31, (N, 128)).astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, hi, (N, 128)).astype(np.int32)).to(dev)
        got, want = kern(lut, idx), plain(lut, idx)
        err = max_abs_err(got.long(), want.long())
        if err or not torch.equal(got, want):
            raise AssertionError(f"{name} kernel disagrees with the plain version at N={N}")
        idx64 = idx.long()
        dim = 0 if name == "lut_gather_rows" else 1
        if not torch.equal(torch.gather(lut, dim, idx64), want):
            raise AssertionError(f"torch.gather does not compute {name}")
        ms = cuda_graph_time_ms(lambda: kern(lut, idx), 50)
        eager_ms = cuda_time_ms(lambda: kern(lut, idx), 50)
        plain_ms = cuda_time_ms(lambda: plain(lut, idx), 50)
        library_ms = cuda_graph_time_ms(lambda: torch.gather(lut, dim, idx64), 50)
        bound_ms = bounds.bound_ms(bounds.tensor_bytes(lut, idx, got))
        variant = gather.rows_variant(lut) if name == "lut_gather_rows" else "smem row"
        say(f"{name} N={N} ({variant}): bit-exact=True, {ms:.4f} ms ({eager_ms:.4f} eager) vs "
            f"{plain_ms:.4f} ms plain, {library_ms:.4f} ms torch.gather, bound {bound_ms:.6f} ms")
        res[name] = (err, ms, plain_ms, library_ms, bound_ms, eager_ms)
    return res


def run_gather_path() -> dict:
    import torch

    from rkmh_tpu_torch.bench import bench_gather
    from rkmh_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    bench_gather.main()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say(f"gather path launches: {launches}")
    require_launches(launches, ("lut_gather_rows", "lut_gather_lanes"), "gather")
    return launches


def check_k3(dev, tb, packed, panel) -> tuple[int, dict]:
    """K3 against its plain version on the first HPV16_BATCH reads (one
    padded batch), the same batch with every seventh read emptied, one 40
    kb read, and a small table of 9 mask words; returns (max_abs_err,
    times)."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.io.packing import encode_seqs
    from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain, multi_k_window_hashes
    from rkmh_tpu_torch.ops.lookup import build_set_table
    from rkmh_tpu_torch.ops.set_probe import (
        SEGMENT,
        _set_probe_cuda,
        pack_set_table,
        set_probe_plain,
    )
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    T, U = len(tb.type_names), tb.n_lin + tb.n_sub
    lens = packed.lens[:HPV16_BATCH]
    batch = packed.codes[:HPV16_BATCH, : -(-int(lens.max()) // 128) * 128]
    long_read, _ = synth.make_nanopore_reads(1, 99, panel, mean_len=40000, min_len=40000,
                                             max_len=40000)
    long_codes, long_lens = encode_seqs([long_read[0].tobytes()])
    worst, times = 0, {}
    for label, codes, ln in (("B=512 batch", batch, lens), ("one 40 kb read", long_codes,
                                                            long_lens)):
        x = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        hashes = multi_k_window_hashes(x, [HPV16_K])
        if not torch.equal(hashes, kmer_window_hashes_plain(x, HPV16_K)):
            raise AssertionError(f"window-hash kernel disagrees with the plain version on {label}")
        full, sk_lens = bottom_s_sketch(hashes, x.shape[1] - HPV16_K + 1)
        Wc = engine.hpv16_compact_width(ln, x.shape[1], (HPV16_K,))
        rows = full[:, :Wc]
        cases = [(label, sk_lens)]
        if not times:
            emptied = sk_lens.clone()
            emptied[::7] = 0
            cases.append((f"{label}, every seventh read emptied", emptied))
        for name, row_lens in cases:
            got = _set_probe_cuda(rows, row_lens, tb.probe_table, T, U)
            want = set_probe_plain(rows, row_lens, tb.comb_table, T, U)
            err = max_abs_err(got, want)
            blocks = int((-(-row_lens.clamp(max=Wc) // SEGMENT)).clamp(min=1).sum())
            say(f"K3 {name}: rows {tuple(rows.shape)}, exact={err == 0}, {blocks} blocks with "
                f"work for {rows.shape[0]} reads, "
                f"mean shared={want[:, 1].float().mean().item():.1f}, "
                f"mean group hits={want[:, 2:].sum(1).float().mean().item():.2f}")
            if err or not torch.equal(got, want):
                raise AssertionError(f"set-probe kernel disagrees with the plain version on "
                                     f"{name}")
            worst = max(worst, err)
        if not times:
            blocks = int((-(-sk_lens.clamp(max=Wc) // SEGMENT)).clamp(min=1).sum())
            if blocks <= rows.shape[0]:
                raise AssertionError("the set-probe kernel has no more blocks with work than "
                                     "reads")
            probe = tb.probe_table
            times = {"set_probe": cuda_graph_time_ms(
                         lambda: _set_probe_cuda(rows, sk_lens, probe, T, U), 10),
                     "set_probe_eager": cuda_time_ms(
                         lambda: _set_probe_cuda(rows, sk_lens, probe, T, U), 20),
                     "set_probe_plain": cuda_time_ms(
                         lambda: set_probe_plain(rows, sk_lens, tb.comb_table, T, U), 3,
                         warmup=1)}
            st = bounds.set_probe_stats(rows, sk_lens, tb.comb_table, T + U)
            row_bytes = bounds.read_row_bytes(rows, sk_lens) + bounds.tensor_bytes(sk_lens, got)
            times["set_probe_bound"] = bounds.bound_ms(row_bytes + st.table_bytes)
            packed_bytes = bounds.packed_set_table_bytes(st, probe)
            say(f"time set_probe: {times['set_probe']:.4f} ms ({times['set_probe_eager']:.4f} "
                f"eager) vs {times['set_probe_plain']:.4f}"
                f" ms plain per {HPV16_BATCH}-read batch, rows {tuple(rows.shape)}, "
                f"table {tuple(tb.comb_table.shape)}; {st.probes} run starts probed, {st.hits} "
                f"hit, {st.mask_bits} mask bits, {st.table_bytes} table bytes reached (of "
                f"{tb.comb_table.numel() * 4}); bound {times['set_probe_bound']:.4f} ms; in "
                f"the packed layout ({probe.nbytes} bytes) {st.buckets} key records and "
                f"{st.hit_slots} slot records, {packed_bytes} bytes, "
                f"{bounds.bound_ms(row_bytes + packed_bytes):.4f} ms")

    # a table of 280 references: 9 mask words, slot records of 48 bytes
    rng = np.random.default_rng(41)
    pool = rng.integers(1, 2**63, size=4000, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    wide = torch.from_numpy(build_set_table([rng.choice(pool, 500) for _ in range(280)],
                                            num_refs=280).table.view(np.int32)).to(dev)
    rows, row_lens = bottom_s_sketch(torch.from_numpy(
        rng.choice(np.concatenate([pool, rng.integers(1, 2**63, 4000)]), size=(64, 5000))).to(dev),
        5000)
    got = _set_probe_cuda(rows, row_lens, pack_set_table(wide, 280), 250, 30)
    want = set_probe_plain(rows, row_lens, wide, 250, 30)
    err = max_abs_err(got, want)
    say(f"K3 280 references (9 mask words): table {tuple(wide.shape)}, rows "
        f"{tuple(rows.shape)}, exact={err == 0}, mean shared="
        f"{want[:, 1].float().mean().item():.1f}")
    if err or not torch.equal(got, want):
        raise AssertionError("set-probe kernel disagrees with the plain version at 9 mask words")
    return max(worst, err), times


def run_hpv16(dev, card: str) -> dict:
    """Table build + K3 check + the hpv16 slice (see the module doc)."""
    import numpy as np
    import torch

    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import hpv16_cmd
    from rkmh_tpu_torch.commands.common import bucketed_batches, load_packed
    from rkmh_tpu_torch.ops import kernels
    from rkmh_tpu_torch.ops.lookup import table_slots

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        reads, truth = synth.write_hpv16_workload(tmp, N_HPV16_READS)
        panel = synth.make_hpv16_panel(0)
        packed = load_packed([reads])
        mbp = int(packed.lens.sum()) / 1e6
        say(f"hpv16 input: {N_HPV16_READS} reads, {mbp:.3f} Mbp (mean "
            f"{packed.lens.mean():.0f} bp, max {packed.lens.max()}), "
            f"{len(panel.types)} types + {len(panel.subs)} sublineages, made and parsed in "
            f"{time.perf_counter() - t0:.2f} s")
        cfg = dict(read_files=[reads], refpath=tmp, ks=(HPV16_K,), batch_size=HPV16_BATCH)

        tb = hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(**cfg, tst_file=False),
                                    (HPV16_K,), dev)
        T, U = len(tb.type_names), tb.n_lin + tb.n_sub
        table = tb.comb_table
        S = table_slots(table.shape[1], T + U)
        say(f"hpv16 table: {tuple(table.shape)} int32 = {table.numel() * 4 / 2**20:.1f} MiB, "
            f"S={S}, Wm={table.shape[1] // S - 3}, {T} types + {U} groups; packed for the "
            f"probe: {tb.probe_table.nbytes / 2**20:.1f} MiB beside it; set-up s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in tb.setup_s.items()))
        err_k3, times = check_k3(dev, tb, packed, panel)

        gpu_dir, cpu_dir = os.path.join(tmp, "gpu"), os.path.join(tmp, "cpu")
        os.makedirs(gpu_dir)
        os.makedirs(cpu_dir)
        out_gpu = os.path.join(gpu_dir, "out.tsv")
        try:
            os.chdir(gpu_dir)  # the .tst side file lands in the working directory
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hpv16_cmd.run(hpv16_cmd.Hpv16Config(**cfg, out_file=out_gpu, device="cuda"))
            torch.cuda.synchronize()
            e2e_s = time.perf_counter() - t0
            launches = kernels.launch_counts()
            say(f"hpv16 slice launches: {launches}")
            require_launches(launches, ("window_hash", "set_probe"), "hpv16")

            head = os.path.join(tmp, "head.fq")
            with open(reads) as src_fh, open(head, "w") as dst:
                for _ in range(4 * N_HPV16_CPU_LINES):
                    dst.write(src_fh.readline())
            os.chdir(cpu_dir)
            t0 = time.perf_counter()
            out_cpu = os.path.join(cpu_dir, "out.tsv")
            hpv16_cmd.run(hpv16_cmd.Hpv16Config(**{**cfg, "read_files": [head]},
                                                out_file=out_cpu, device="cpu"))
            cpu_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)

        with open(out_gpu) as fh:
            gpu_lines = fh.readlines()
        with open(out_cpu) as fh:
            cpu_lines = fh.readlines()
        if len(gpu_lines) != N_HPV16_READS:
            raise AssertionError(f"{len(gpu_lines)} hpv16 lines for {N_HPV16_READS} reads")
        for i in (0, len(gpu_lines) - 1):
            if gpu_lines[i].split("\t")[0] != f"read{i}":
                raise AssertionError(f"hpv16 line {i} is out of order: {gpu_lines[i]!r}")
        if cpu_lines != gpu_lines[:N_HPV16_CPU_LINES]:
            bad = next(i for i, (a, b) in enumerate(zip(cpu_lines, gpu_lines)) if a != b)
            raise AssertionError(f"hpv16 GPU and CPU outputs differ at line {bad}: "
                                 f"{gpu_lines[bad]!r} vs {cpu_lines[bad]!r}")
        tst = f"lineage_specific_hashes.{HPV16_K}.tst"
        with open(os.path.join(gpu_dir, tst)) as a, open(os.path.join(cpu_dir, tst)) as b:
            if a.read() != b.read():
                raise AssertionError("hpv16 GPU and CPU .tst files differ")
        say(f"hpv16 slice: first {N_HPV16_CPU_LINES} GPU lines and the .tst file "
            f"byte-identical to the CPU plain path ({cpu_s:.2f} s on the CPU)")
        typed = float(np.mean([ln.split("\t")[1] == t for ln, t in zip(gpu_lines, truth)]))

    # device step over resident batches (parse, table build and format excluded)
    batches = [(torch.from_numpy(codes).to(dev),
                engine.hpv16_compact_width(lens, codes.shape[1], (HPV16_K,)))
               for _, codes, lens in bucketed_batches(packed, HPV16_BATCH)]
    probe = tb.probe_table
    step = lambda: [engine.hpv16_batch_comb(c, probe, (HPV16_K,), T, U, Wc)  # noqa: E731
                    for c, Wc in batches]
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_time_ms(step, 2, warmup=1)
    peak_512 = torch.cuda.max_memory_allocated() / 2**30

    # one step at the auto batch size (16384) on the longest length bucket
    longest, wc_long = batches[-1]
    big = longest.repeat(-(-16384 // longest.shape[0]), 1)[:16384]
    del batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    big_ms = cuda_time_ms(
        lambda: engine.hpv16_batch_comb(big, probe, (HPV16_K,), T, U, wc_long), 1, warmup=1)
    peak_big = torch.cuda.max_memory_allocated() / 2**30

    res = {"e2e_s": e2e_s, "e2e_mbp_per_s": mbp / e2e_s,
           "e2e_reads_per_s": N_HPV16_READS / e2e_s,
           "device_step_mbp_per_s": mbp / (step_ms / 1e3),
           "device_step_reads_per_s": N_HPV16_READS / (step_ms / 1e3),
           "typed_share": typed, "launches": launches, "err_k3": err_k3, **times}
    say(f"hpv16 slice on {card}: e2e {res['e2e_mbp_per_s']:.3f} Mbp/s, "
        f"{res['e2e_reads_per_s']:.1f} reads/s ({e2e_s:.2f} s for {N_HPV16_READS} reads, "
        f"table build and parse included); device step {res['device_step_mbp_per_s']:.1f} "
        f"Mbp/s, {res['device_step_reads_per_s']:.1f} reads/s ({step_ms:.2f} ms for all "
        f"{N_HPV16_READS} reads in {HPV16_BATCH}-read batches, peak "
        f"{peak_512:.2f} GiB allocated); typed as source type {typed:.4f}")
    say(f"hpv16 auto batch: one step of {tuple(big.shape)} codes: {big_ms:.2f} ms, "
        f"peak {peak_big:.2f} GiB allocated, on {card}")
    return res


def random_hashes(seed: int, shape):
    """int64 hashes, about half >= 2**63 as uint64, ~5% zeros, repeated
    values, and a mask of ~80% of the elements, on the host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    h = rng.integers(-(2**63), 2**63 - 1, size=shape, dtype=np.int64)
    h[rng.random(shape) < 0.05] = 0
    h[:, 1::4] = h[:, ::4][:, : h[:, 1::4].shape[1]]
    return torch.from_numpy(h), torch.from_numpy(rng.random(shape) < 0.8)


def check_counters(dev, hashes) -> dict:
    """K6 and K7 exactly against their plain versions at every size of
    COUNTER_SIZES, then timed at the stream shape (``hashes`` = K1's
    [16384, 149] output for 150 bp reads padded to 160, with the window
    mask of the counter pass) on a 2e8-slot counter; returns {name:
    (max_abs_err, ms, plain_ms)}."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops import counter
    from rkmh_tpu_torch.ops.hashing import window_mask

    h, m = (t.to(dev) for t in random_hashes(17, (4096, 149)))
    read_lens = torch.from_numpy(np.random.default_rng(18).integers(0, 161, 4096)).to(dev)
    read_lens[:3] = torch.tensor([0, 5, 160], device=dev)  # shorter than k, and full
    by_lens = window_mask(read_lens, 160, [12])
    worst = {"counter_add": 0, "counter_mask": 0}
    for size in COUNTER_SIZES:
        want = torch.zeros(size, dtype=torch.int32, device=dev)
        counter.counter_add_plain(want, h, m)
        counter.counter_add_plain(want, h, by_lens)
        counter.counter_add_plain(want, h[:64], None)
        for binned in (True, False):  # through the bins, and one atomic per element
            got = torch.zeros(size, dtype=torch.int32, device=dev)
            counter._counter_add_cuda(got, h, m, binned=binned)
            counter._counter_add_cuda(got, h, None, (read_lens, 160, [12]), binned=binned)
            counter._counter_add_cuda(got, h[:64], None, binned=binned)
            err_add = max_abs_err(got, want)
            if err_add or not torch.equal(got, want):
                raise AssertionError(f"counter-add kernel (binned={binned}) disagrees with the "
                                     f"plain version at size {size}")
        kept = []
        for lo, hi in ((MIN_OCC, counter.INT32_MAX), (0, MAX_SAMPLES), (3, 5)):
            g = counter._counter_mask_cuda(got, h, lo, hi)
            w = counter.counter_mask_plain(want, h, lo, hi)
            err_mask = max_abs_err(g, w)
            if err_mask or not torch.equal(g, w):
                raise AssertionError(f"counter-mask kernel disagrees with the plain version "
                                     f"at size {size}, bounds ({lo}, {hi})")
            worst["counter_mask"] = max(worst["counter_mask"], err_mask)
            kept.append(f"({lo}, {hi}) {float((w != 0).float().mean()):.3f}")
        say(f"K6/K7 size {size}: table and masks exact=True, slot 0 count "
            f"{int(want[0])}, max count {int(want.max())}, share kept {', '.join(kept)}")
        worst["counter_add"] = max(worst["counter_add"], err_add)
        del got, want

    big = COUNTER_SIZES[0]
    table = torch.zeros(big, dtype=torch.int32, device=dev)
    lens150 = torch.full((hashes.shape[0],), 150, dtype=torch.int32, device=dev)
    windows = (lens150, 160, [12])  # as the counter pass calls K6
    mask = window_mask(lens150, 160, [12])
    plain_table = table.clone()
    t = {
        "counter_add": cuda_graph_time_ms(
            lambda: counter._counter_add_cuda(table, hashes, None, windows), 20),
        "counter_add_eager": cuda_time_ms(
            lambda: counter._counter_add_cuda(table, hashes, None, windows), 20),
        "counter_add_direct": cuda_graph_time_ms(
            lambda: counter._counter_add_cuda(table, hashes, None, windows, binned=False), 20),
        "counter_add_mask_tensor": cuda_graph_time_ms(
            lambda: counter._counter_add_cuda(table, hashes, mask), 20),
        "counter_add_plain": cuda_time_ms(
            lambda: counter.counter_add_plain(plain_table, hashes, mask), 5),
        "counter_mask": cuda_graph_time_ms(
            lambda: counter._counter_mask_cuda(table, hashes, MIN_OCC, counter.INT32_MAX), 20),
        "counter_mask_eager": cuda_time_ms(
            lambda: counter._counter_mask_cuda(table, hashes, MIN_OCC, counter.INT32_MAX), 20),
        "counter_mask_plain": cuda_time_ms(
            lambda: counter.counter_mask_plain(table, hashes, MIN_OCC, counter.INT32_MAX), 5),
    }
    for name, ms in t.items():
        say(f"time {name}: {ms:.4f} ms per call, hashes {tuple(hashes.shape)}, "
            f"counter {big} slots")
    # what K6's atomics contend on: reads repeat k-mers, so one batch sends
    # many adds to one slot; the same launch on distinct random hashes
    added = counter.slots(hashes[mask], big)
    _, mult = torch.unique(added, return_counts=True)
    gen = torch.Generator(device=dev).manual_seed(23)
    distinct = torch.randint(-(2**63), 2**63 - 1, tuple(hashes.shape), dtype=torch.int64,
                             device=dev, generator=gen)
    ms_distinct = cuda_graph_time_ms(lambda: counter._counter_add_cuda(table, distinct, mask),
                                     20)
    say(f"counter_add contention: the batch's {added.numel()} counted hashes fall in "
        f"{mult.numel()} distinct slots (the hottest takes {int(mult.max())} adds, slot 0 "
        f"{int((added == 0).sum())}); K6 on as many random hashes: {ms_distinct:.4f} ms")
    # the route a counter pass settles on, read from its first call through the bins
    for label, hs, merges in (("the stream batch", hashes, True),
                              ("as many random hashes", distinct, False)):
        c = counter.HashCounter(big, dev)
        want = torch.zeros_like(c.table)
        for _ in range(2):
            c.add_windows(hs, lens150, 160, 12)
            counter.counter_add_plain(want, hs, mask)
        if c.binned is not merges or not torch.equal(c.table, want):
            raise AssertionError(f"HashCounter on {label}: through the bins={c.binned}, table "
                                 f"exact={torch.equal(c.table, want)}")
        say(f"HashCounter on {label}: later calls through the bins={c.binned}, table exact=True")
        del c, want
    # bounds: the hashes and read lengths (K6) or the hashes in and out (K7), plus
    # the counter's sectors the slots reach, read and written (K6) or read
    add_sectors = bounds.sector_bytes(torch.unique(added) * 4)
    get_sectors = bounds.sector_bytes(torch.unique(counter.slots(hashes.reshape(-1), big)) * 4)
    bound = {"counter_add": bounds.bound_ms(bounds.tensor_bytes(hashes, lens150)
                                            + 2 * add_sectors),
             "counter_mask": bounds.bound_ms(2 * bounds.tensor_bytes(hashes) + get_sectors)}
    say(f"counter bounds (ms): {bound}; sectors reached: add {add_sectors} B, "
        f"mask {get_sectors} B")
    return {name: (worst[name], t[name], t[name + "_plain"], bound[name], t[name + "_eager"])
            for name in worst}


def check_k2_filter(dev, panel, hashes) -> tuple[int, float, float, float]:
    """K2's filter mode against its plain version on the zika panel in both
    row modes with -N/-D thresholds; -> (max_abs_err, ms, plain_ms,
    eager_ms)."""
    import torch

    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops.probe import _panel_probe_filter_cuda, panel_probe_filter_plain
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    R = panel.num_refs
    worst = 0
    for s in (1000, 50):
        sk, lens = bottom_s_sketch(hashes, s)
        for mode, rows, ln in (("a raw", hashes, None), (f"b sketch s={s}", sk, lens)):
            if s != 1000 and ln is None:
                continue
            for min_diff, min_matches in ((0, -1), (0, FILTER_MIN_MATCHES), (2, 60)):
                got = _panel_probe_filter_cuda(rows, ln, panel.table, R, panel.lens,
                                               min_diff, min_matches)
                want = panel_probe_filter_plain(rows, ln, panel.table, R, panel.lens,
                                                min_diff, min_matches)
                err = max_abs_err(got, want)
                say(f"K2 filter mode {mode} -D {min_diff} -N {min_matches}: exact={err == 0} "
                    f"kept={float(want[3].float().mean()):.4f} "
                    f"flag histogram={torch.bincount(want[4], minlength=8).tolist()}")
                if err or not torch.equal(got, want):
                    raise AssertionError(f"panel-probe filter mode disagrees in mode {mode}")
                worst = max(worst, err)
    eager_ms = cuda_time_ms(lambda: _panel_probe_filter_cuda(hashes, None, panel.table, R,
                                                             panel.lens, 0, FILTER_MIN_MATCHES), 50)
    ms = cuda_graph_time_ms(lambda: _panel_probe_filter_cuda(hashes, None, panel.table, R,
                                                             panel.lens, 0, FILTER_MIN_MATCHES), 20)
    plain_ms = cuda_time_ms(lambda: panel_probe_filter_plain(
        hashes, None, panel.table, R, panel.lens, 0, FILTER_MIN_MATCHES), 5)
    say(f"time panel_probe_filter: {ms:.4f} ms ({eager_ms:.4f} eager) vs {plain_ms:.4f} ms plain "
        f"per call at rows {tuple(hashes.shape)}, table {tuple(panel.table.shape)}")
    return worst, ms, plain_ms, eager_ms


def run_stream_counters(dev, card: str, zika: dict) -> dict:
    """The stream -M 2 -I 40 path (see the module doc)."""
    import torch

    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import stream
    from rkmh_tpu_torch.commands.common import (
        DEFAULT_CHUNK_READS,
        bucketed_batches,
        build_ref_panel_from_files,
        count_read_kmers,
        iter_packed_chunks,
        load_packed,
    )

    tmp = zika["dir"]
    cfg = dict(ref_files=[zika["refs"]], ks=(12,), sketch_size=1000, min_kmer_occ=MIN_OCC,
               max_samples=MAX_SAMPLES)
    out_gpu = os.path.join(tmp, "stream_mi.tsv")
    e2e_s, launches = driven(
        lambda: stream.run(stream.StreamConfig(read_files=[zika["reads"]], out_file=out_gpu,
                                               device="cuda", **cfg)),
        "stream -M -I", ("window_hash", "counter_add", "counter_mask", "panel_probe"))
    with open(out_gpu) as fh:
        n_lines = sum(1 for _ in fh)
    if n_lines != N_SLICE_READS:
        raise AssertionError(f"stream -M -I: {n_lines} lines for {N_SLICE_READS} reads")

    outs = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(tmp, f"stream_mi_head.{device}.tsv")
        stream.run(stream.StreamConfig(read_files=[zika["head"]], out_file=path,
                                       device=device, **cfg))
        outs[device] = read_text(path)
    require_same(outs["cuda"], outs["cpu"], "stream -M -I")
    say(f"stream -M {MIN_OCC} -I {MAX_SAMPLES}: the whole {N_CPU_LINES}-read input "
        "byte-identical on the card and the CPU plain path")

    # the counter pass alone, then the device step over resident batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counter = count_read_kmers(iter_packed_chunks([zika["reads"]], DEFAULT_CHUNK_READS), (12,),
                               stream.DEFAULT_COUNTER_SIZE, B, dev)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    if counter.binned is not True:
        raise AssertionError(f"the counter pass of reads that repeat their k-mers took K6's "
                             f"route binned={counter.binned}")
    panel = build_ref_panel_from_files([zika["refs"]], (12,), 1000, dev,
                                       max_samples=MAX_SAMPLES)
    packed = load_packed([zika["head"]])
    batch = torch.from_numpy(next(bucketed_batches(packed, B))[1]).to(dev)
    step_ms = cuda_time_ms(lambda: engine.classify_codes_table(
        batch, panel, (12,), 1000, 0, -1, counter.table, MIN_OCC), 20)
    res = {"e2e_s": e2e_s, "e2e_reads_per_s": N_SLICE_READS / e2e_s, "count_pass_s": count_s,
           "device_step_ms_per_16k_batch": step_ms,
           "device_step_reads_per_s": batch.shape[0] / (step_ms / 1e3), "launches": launches}
    say(f"stream -M {MIN_OCC} -I {MAX_SAMPLES} on {card}: e2e {res['e2e_reads_per_s']:.1f} "
        f"reads/s ({e2e_s:.2f} s for {N_SLICE_READS} reads, two passes, panel build "
        f"included); counter pass alone {count_s:.2f} s; device step "
        f"{res['device_step_reads_per_s']:.1f} reads/s ({step_ms:.4f} ms per "
        f"{batch.shape[0]}-read batch)")
    return res


def run_filter(dev, card: str, zika: dict) -> dict:
    """The filter -M 2 -I 40 -N 10 path (see the module doc)."""
    from rkmh_tpu_torch.commands import filter_cmd

    tmp = zika["dir"]
    cfg = dict(ref_files=[zika["refs"]], ks=(12,), sketch_size=1000, min_kmer_occ=MIN_OCC,
               max_samples=MAX_SAMPLES, min_matches=FILTER_MIN_MATCHES)
    out_gpu = os.path.join(tmp, "filter.fq")
    stats = {}
    e2e_s, launches = driven(
        lambda: filter_cmd.run(filter_cmd.FilterConfig(read_files=[zika["reads"]],
                                                       out_file=out_gpu, device="cuda", **cfg),
                               stats=stats),
        "filter", ("window_hash", "counter_add", "counter_mask", "panel_probe_filter"))
    with open(out_gpu) as fh:
        n_lines = sum(1 for _ in fh)
    if stats.get("reads") != N_SLICE_READS or n_lines != 4 * stats["kept"]:
        raise AssertionError(f"filter: {n_lines} lines for {stats} reads kept")

    outs = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(tmp, f"filter_head.{device}.fq")
        filter_cmd.run(filter_cmd.FilterConfig(read_files=[zika["head"]], out_file=path,
                                               device=device, **cfg))
        with open(zika["head"], "rb") as stdin:
            both = os.path.join(tmp, f"filter_fi.{device}.txt")
            filter_cmd.run(filter_cmd.FilterConfig(read_files=[zika["head"]], in_stream=True,
                                                   out_file=both, device=device, **cfg),
                           stdin=stdin)
        outs[device] = (read_text(path), read_text(both))
    require_same(outs["cuda"][0], outs["cpu"][0], "filter")
    require_same(outs["cuda"][1], outs["cpu"][1], "filter -f -i")
    n_sample = outs["cuda"][1].count("Sample: ")
    if n_sample != N_CPU_LINES or not outs["cuda"][1].startswith(outs["cuda"][0]):
        raise AssertionError(f"filter -f -i: {n_sample} Sample lines for {N_CPU_LINES} reads")
    say(f"filter: the whole {N_CPU_LINES}-read input byte-identical on the card and the CPU "
        "plain path, in file mode and with -f plus -i (the stream as a file object)")
    res = {"e2e_s": e2e_s, "e2e_reads_per_s": N_SLICE_READS / e2e_s,
           "kept_share": stats["kept"] / N_SLICE_READS, "launches": launches}
    say(f"filter -M {MIN_OCC} -I {MAX_SAMPLES} -N {FILTER_MIN_MATCHES} on {card}: e2e "
        f"{res['e2e_reads_per_s']:.1f} reads/s ({e2e_s:.2f} s for {N_SLICE_READS} reads, two "
        f"passes, panel build and record output included); kept {stats['kept']} "
        f"({res['kept_share']:.4f})")
    return res


def run_hpv16_counter(dev, card: str) -> dict:
    """The hpv16 -M 2 path (see the module doc)."""
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.commands import hpv16_cmd

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        reads, _ = synth.write_hpv16_workload(tmp, N_HPV16_READS, n_rate=HPV16_N_RATE)
        head = os.path.join(tmp, "head.fq")
        with open(reads) as src_fh, open(head, "w") as dst:
            for _ in range(4 * N_HPV16_M_CPU_READS):
                dst.write(src_fh.readline())
        with open(head) as fh:
            head_mbp = sum(len(ln) - 1 for i, ln in enumerate(fh) if i % 4 == 1) / 1e6
        with open(reads) as fh:
            mbp = sum(len(ln) - 1 for i, ln in enumerate(fh) if i % 4 == 1) / 1e6
        cfg = dict(refpath=tmp, ks=(HPV16_K,), batch_size=HPV16_BATCH, min_kmer_occ=MIN_OCC)
        try:
            run_dir = os.path.join(tmp, "run")
            os.makedirs(run_dir)
            os.chdir(run_dir)
            e2e_s, launches = driven(
                lambda: hpv16_cmd.run(hpv16_cmd.Hpv16Config(
                    read_files=[reads], out_file=os.path.join(run_dir, "out.tsv"),
                    device="cuda", **cfg)),
                "hpv16 -M", ("window_hash", "counter_add", "counter_mask", "set_probe"))
            n_lines = read_text(os.path.join(run_dir, "out.tsv")).count("\n")
            if n_lines != N_HPV16_READS:
                raise AssertionError(f"hpv16 -M: {n_lines} lines for {N_HPV16_READS} reads")
            outs = {}
            for device in ("cuda", "cpu"):
                wd = os.path.join(tmp, device)
                os.makedirs(wd)
                os.chdir(wd)
                path = os.path.join(wd, "out.tsv")
                hpv16_cmd.run(hpv16_cmd.Hpv16Config(read_files=[head], out_file=path,
                                                    device=device, **cfg))
                outs[device] = (read_text(path),
                                read_text(f"lineage_specific_hashes.{HPV16_K}.tst"))
        finally:
            os.chdir(cwd)
    require_same(outs["cuda"][0], outs["cpu"][0], "hpv16 -M")
    require_same(outs["cuda"][1], outs["cpu"][1], "hpv16 -M .tst")
    say(f"hpv16 -M: the whole {N_HPV16_M_CPU_READS}-read input ({head_mbp:.3f} Mbp) gives "
        "byte-identical stdout and .tst on the card and the CPU plain path")
    res = {"e2e_s": e2e_s, "e2e_mbp_per_s": mbp / e2e_s, "launches": launches}
    say(f"hpv16 -M {MIN_OCC} on {card}: e2e {res['e2e_mbp_per_s']:.3f} Mbp/s "
        f"({e2e_s:.2f} s for {N_HPV16_READS} reads, {mbp:.3f} Mbp, N rate {HPV16_N_RATE}, two "
        "passes, table build included)")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to test", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "rkmh_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout holding rkmh_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rkmh_tpu_torch.ops import kernels

    from rkmh_tpu_torch.bench.timing import card_name_and_power_limit

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = card_name_and_power_limit()
    say(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    lib = kernels.build()
    say(f"built {lib.name} from {[p.name for p in kernels.sources()]} in "
        f"{time.perf_counter() - t0:.2f} s")

    err_k1 = check_k1(dev)
    panel, genomes = zika_panel(dev)
    err_k2, (codes, hashes), k2_stats = check_k2(dev, panel, genomes)
    err_k2 = max(err_k2, check_k2_variants(dev))
    times, bound = time_kernels(panel, codes, hashes, k2_stats)
    card_smi = f"{card} ({smi})"
    with tempfile.TemporaryDirectory() as work:
        zika = write_zika(work)
        sl = run_slice(dev, card_smi, panel, zika)
        gathers = check_gathers(dev)
        gather_launches = run_gather_path()
        hp = run_hpv16(dev, card_smi)
        counters = check_counters(dev, hashes)
        filt = check_k2_filter(dev, panel, hashes)
        st_mi = run_stream_counters(dev, card_smi, zika)
        fl = run_filter(dev, card_smi, zika)
    hpm = run_hpv16_counter(dev, card_smi)
    paths = {"stream": sl, "hpv16": hp, "stream -M -I": st_mi, "filter": fl, "hpv16 -M": hpm}

    def launched(name):
        return sum(r["launches"][name] for r in paths.values())

    def entry(name, source, replaces, err, ms, eager_ms, plain_ms, bound_ms, library_ms=None,
              launches=None):
        by_path = {p: r["launches"][name] for p, r in paths.items() if r["launches"][name]}
        return {"name": name, "route": "cuda", "source": f"rkmh_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": launched(name) if launches is None else launches,
                "launches_by_path": by_path if launches is None else {"gather": launches},
                "max_abs_err": err, "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                **bound_fields(ms, bound_ms, library_ms)}

    def gather_entry(name, line):
        err, ms, plain_ms, library_ms, bound_ms, eager_ms = gathers[name]
        return entry(name, "lut_gather.cu", f"scripts/bench_gather.py:{line}", err, ms,
                     eager_ms, plain_ms, bound_ms, library_ms, gather_launches[name])

    def counter_entry(name, line):
        err, ms, plain_ms, bound_ms, eager_ms = counters[name]
        return entry(name, "counter.cu", f"rkmh_tpu/ops/counter.py:{line}", err, ms, eager_ms,
                     plain_ms, bound_ms)

    record = {"kernels": [
        entry("window_hash", "window_hash.cu", "rkmh_tpu/ops/pallas_hash.py:39", err_k1,
              times["window_hash"], times["window_hash_eager"], times["window_hash_plain"],
              bound["window_hash"]),
        entry("panel_probe", "panel_probe.cu", "rkmh_tpu/ops/lookup.py:321", err_k2,
              times["panel_probe"], times["panel_probe_eager"], times["panel_probe_plain"],
              bound["panel_probe"]),
        entry("panel_probe_filter", "panel_probe.cu", "rkmh_tpu/classify/engine.py:56",
              filt[0], filt[1], filt[3], filt[2], bound["panel_probe_filter"]),
        entry("set_probe", "set_probe.cu", "rkmh_tpu/classify/engine.py:794", hp["err_k3"],
              hp["set_probe"], hp["set_probe_eager"], hp["set_probe_plain"],
              hp["set_probe_bound"]),
        gather_entry("lut_gather_rows", 109),
        gather_entry("lut_gather_lanes", 140),
        counter_entry("counter_add", 37),
        counter_entry("counter_mask", 46),
    ]}
    say(smi)
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
