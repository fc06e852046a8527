#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rkmh_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It fails (non-zero exit, no result
line) without CUDA or without the package beside it.  In order it:

1. reports the card (torch and nvidia-smi);
2. builds the CUDA kernels from ``rkmh_tpu_torch/csrc`` and times the build;
3. checks the window-hash kernel (K1) bit for bit against its plain
   PyTorch version on the card: random codes with invalid bases,
   k in {4, 12, 16, 17, 31, 32, 33} and multi-k;
4. checks the panel-probe kernel (K2) against its plain version on a
   synthetic zika-shaped panel (60 refs, k=12, s=1000) at B=16384, in
   both row modes and with thresholds; best, shared and flags must be
   equal;
5. times both kernels and their plain versions at the slice's shapes
   (B=16384, L=160, k=12, zika table) with CUDA events;
6. drives the slice: synthetic 60 x 10,807 bp panel and 2**20 reads of
   150 bp through ``commands.stream.run`` (k=12, s=1000, device cuda),
   with the launch counters zeroed just before and read just after; it
   checks one line per read, that both kernels ran, and that the first
   16,384 lines equal the port's CPU plain-path output on the same reads;
   it reports e2e reads/s, device-step reads/s over resident batches and
   the share of reads assigned to the genome they were drawn from.

The last three lines are the card's name and power limit, the kernels'
JSON record and ``{"ok": true, "device": {...}}``.  Any failure raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_SLICE_READS = 1 << 20
N_CPU_LINES = 16384
B = 16384
KS_K1 = (4, 12, 16, 17, 31, 32, 33)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_k1(dev) -> int:
    import numpy as np
    import torch

    from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain, multi_k_window_hashes

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=(2048, 160), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[rng.random(codes.shape) < 0.005] = 255
    codes[:, 150:] = 255
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


def check_k2(dev, panel, genomes) -> tuple[int, object]:
    import torch

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
    return worst, (codes, hashes)


def time_kernels(panel, codes, hashes) -> dict:
    from rkmh_tpu_torch.ops.hashing import _window_hashes_cuda, kmer_window_hashes_plain
    from rkmh_tpu_torch.ops.probe import _panel_probe_cuda, panel_probe_plain

    R = panel.num_refs
    t = {
        "window_hash": cuda_time_ms(lambda: _window_hashes_cuda(codes, [12], 42), 50),
        "window_hash_plain": cuda_time_ms(lambda: kmer_window_hashes_plain(codes, 12), 10),
        "panel_probe": cuda_time_ms(
            lambda: _panel_probe_cuda(hashes, None, panel.table, R, 0, -1), 50),
        "panel_probe_plain": cuda_time_ms(
            lambda: panel_probe_plain(hashes, None, panel.table, R, 0, -1), 5),
    }
    for name, ms in t.items():
        say(f"time {name}: {ms:.4f} ms per call at B={codes.shape[0]}, "
            f"L={codes.shape[1]}, k=12, table {tuple(panel.table.shape)}")
    return t


def run_slice(dev, card: str, panel) -> dict:
    import numpy as np
    import torch

    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import stream
    from rkmh_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        refs, reads, names, src = synth.write_workload(tmp, N_SLICE_READS)
        say(f"slice input: {N_SLICE_READS} reads x {synth.READ_LEN} bp, "
            f"{len(names)} refs x {synth.GENOME_LEN} bp, made in "
            f"{time.perf_counter() - t0:.2f} s")
        out_gpu = os.path.join(tmp, "gpu.tsv")
        cfg = dict(ref_files=[refs], ks=(12,), sketch_size=1000)

        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream.run(stream.StreamConfig(read_files=[reads], out_file=out_gpu,
                                       device="cuda", **cfg))
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        say(f"slice launches: {launches}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} was not launched by the slice")

        with open(out_gpu) as fh:
            gpu_lines = fh.readlines()
        if len(gpu_lines) != N_SLICE_READS:
            raise AssertionError(f"{len(gpu_lines)} lines for {N_SLICE_READS} reads")
        for i in (0, len(gpu_lines) - 1):
            if gpu_lines[i].split("\t")[1] != f"read{i}":
                raise AssertionError(f"line {i} is out of order: {gpu_lines[i]!r}")

        head = os.path.join(tmp, "head.fq")
        with open(reads) as src_fh, open(head, "w") as dst:
            for _ in range(4 * N_CPU_LINES):
                dst.write(src_fh.readline())
        out_cpu = os.path.join(tmp, "cpu.tsv")
        t0 = time.perf_counter()
        stream.run(stream.StreamConfig(read_files=[head], out_file=out_cpu,
                                       device="cpu", **cfg))
        cpu_s = time.perf_counter() - t0
        with open(out_cpu) as fh:
            cpu_lines = fh.readlines()
        if cpu_lines != gpu_lines[:N_CPU_LINES]:
            bad = next(i for i, (a, b) in enumerate(zip(cpu_lines, gpu_lines)) if a != b)
            raise AssertionError(f"GPU and CPU outputs differ at line {bad}: "
                                 f"{gpu_lines[bad]!r} vs {cpu_lines[bad]!r}")
        say(f"slice: first {N_CPU_LINES} GPU lines byte-identical to the CPU plain "
            f"path ({cpu_s:.2f} s on the CPU)")

        assigned = np.array([ln.split("\t", 1)[0] for ln in gpu_lines])
        share = float(np.mean(assigned == np.asarray(names)[src]))

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

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    lib = kernels.build()
    say(f"built {lib.name} from {[p.name for p in kernels.sources()]} in "
        f"{time.perf_counter() - t0:.2f} s")

    err_k1 = check_k1(dev)
    panel, genomes = zika_panel(dev)
    err_k2, (codes, hashes) = check_k2(dev, panel, genomes)
    times = time_kernels(panel, codes, hashes)
    sl = run_slice(dev, f"{card} ({smi})", panel)

    record = {"kernels": [
        {"name": "window_hash", "route": "cuda",
         "source": "rkmh_tpu_torch/csrc/window_hash.cu",
         "replaces": "rkmh_tpu/ops/pallas_hash.py:39",
         "launches": sl["launches"]["window_hash"], "max_abs_err": err_k1,
         "ms": times["window_hash"], "plain_ms": times["window_hash_plain"]},
        {"name": "panel_probe", "route": "cuda",
         "source": "rkmh_tpu_torch/csrc/panel_probe.cu",
         "replaces": "rkmh_tpu/ops/lookup.py:321",
         "launches": sl["launches"]["panel_probe"], "max_abs_err": err_k2,
         "ms": times["panel_probe"], "plain_ms": times["panel_probe_plain"]},
    ]}
    say(smi)
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
