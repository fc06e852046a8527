"""The hand kernels of this checkout against other builds of them, in
turns, in one process on one card.

    python -m rkmh_tpu_torch.bench.kernel_ab --old-csrc DIR [--variant NAME=DIR ...]
                                             [--only PREFIX ...]

``--old-csrc`` DIR holds earlier versions of some of ``window_hash.cu``,
``panel_probe.cu``, ``counter.cu``, ``set_probe.cu``, ``lut_gather.cu``,
``hashmap.cu``, ``call_scan.cu`` and ``set_table.cu`` (headers they include that DIR lacks
come from this checkout's ``csrc/``),
for example an earlier commit's (``git show REV:rkmh_tpu_torch/csrc/counter.cu
> DIR/counter.cu``), whose entry points have this checkout's parameter
lists (read from both sources; the script refuses a directory whose
sources declare one otherwise).  Each ``--variant`` DIR holds some of this
checkout's sources with one design choice edited, entry points unchanged.
Each directory builds with nvcc into a library of its own.  The wrappers
then run on each library in turn (old, new, the variants, the variants in
reverse, new, old; a library is timed only in the cases whose kernels it
holds), timed with CUDA events as device time (calls replayed from a CUDA
graph) and as an eager loop (which, for a kernel of tens of microseconds,
measures the Python launch path), at:

* the stream batch: 16,384 synthetic 150 bp reads padded to 160 codes,
  k=12, the synthetic zika panel (60 references, s=1000, table [131072,
  20] int32): K1 (and K1 at k=21, a k none of the repo's configurations
  uses); K2 on the raw rows, on sorted s=50 sketches and in its filter
  mode; K2 on the raw rows and in its filter mode against the same panel
  built at S = 2 (``k2_raw_s2``, ``k2_filter_raw_s2``: K2's S = 2 route,
  Wm = 2); K2's partial epilogue (``rkmh_panel_probe_partial``) on the raw
  rows against shard 0 of the panel at tp = 2 (30 references, rkmh-tpu's
  S = 2 geometry: ``k2_partial_shard0``, beside ``k2_raw``, the whole
  table's); the device step (K1 + K2); K6 into a 2e8-slot counter as the
  counter pass calls it (the window mask from the read lengths), through
  the bins and as one atomic per element, and with a mask tensor; K7 on
  the batch's hashes against a 2e8-slot counter that holds the batch, as
  -M 2 calls it (``k7_stream``);
* the hpv16 batch: 512 nanopore-like reads, k=18, padded to the longest
  read: K1; K6 into an 8e8-slot counter; K7 on the batch's window hashes,
  padding zeros included, against an 8e8-slot counter that holds the
  batch, as hpv16 -M 2 calls it (``k7_hpv16``); K3 on the sorted rows
  against the 182-type + 14-group set table (480 MiB), also with other
  segment sizes; the hpv16 step (K1, sort, K3); K13, the set-table fill,
  on the 182-type panel's 1,445,268 entries into its [1048576, 120] table,
  the entries made as ``chip_smoke.py`` phase 40 makes them
  (``k13_hpv16``);
* the gather sweep's [N, 128] int32 LUTs and [N, 128] indices at N = 512,
  4096 and 16384: K4 by the route the shape takes (``k4_N``);
* K5 at the sweep's [512, 128] with indices in 0..127, by the route the
  shape takes (``k5_512``) and by the staged route (``k5_512_smem``), with
  M = 512 indices a row (``k5_512x512``), and at a ragged [300, 128] LUT
  with M = 77 (``k5_300x77``, the staged route's: M % 4 != 0),
  beside the launch floor: an empty kernel (``bench/diag_launch.cu``) on
  the grids of either K5 route and on one block, in graph replay
  (``launch_floor_ms``);
* call's workload (``bench/call_inputs``: HPV16REF and the depth map of
  1,100 nanopore-like reads, k=16, w=100): K8 on the reference's
  positional hashes (``k8_scan``) and on 2**20 read hashes (``k8_2e20``),
  K9 on the reference by its packed route (``k9_call``) and its byte-wise
  route (``k9_call_bytewise``), and on a 1 Mbp reference against the same
  map (``k9_1mbp``, checked on its first 20,000 positions).  A
  ``hashmap.cu`` or ``call_scan.cu`` from before the sorted depth map
  takes a cuckoo table (other entry points): ``bench/call_ab.sh`` times
  such a checkout's K8, K9 and ``call`` against this one's instead.

K6's diagnostics (printed, and under ``k6_diagnostics`` in the JSON):
one atomicAdd per slot computed beforehand (``bench/diag_atomics.cu``),
on the batch's slots as they come, sorted, and on as many random slots;
K6, old and new, on counters of 1e7, 2e8 and 8e8 slots; its device time
kernel by kernel; and, for either batch, how many elements the merge put
into how many adds to the table, from which a ``HashCounter`` takes the
route of a counter pass (``k6_merge``).  K7's diagnostics (with the k7
cases, under ``k7_diagnostics``): K7, old and new, at the stream batch on
counters of 1e7, 2e8 and 8e8 slots, on the same hashes sorted by slot,
and on as many zero hashes (no table load in the new kernel: the stream of
hashes alone).

Before timing, every library's output must equal the plain version's.
It also prints the registers ptxas gives each new kernel and the SASS
instruction count of each (cuobjdump).  The last line is one JSON object.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from rkmh_tpu_torch import call_engine, synth
from rkmh_tpu_torch.bench import bounds, call_inputs
from rkmh_tpu_torch.bench.timing import (
    card_name_and_power_limit,
    cuda_graph_time_ms,
    cuda_time_ms,
    launch_floor_ms,
)
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.io.packing import CODE_LUT, encode_seqs
from rkmh_tpu_torch.ops import counter, gather, hashmap, kernels, lookup
from rkmh_tpu_torch.ops.hashing import (
    _window_hashes_cuda,
    kmer_window_hashes_plain,
    window_mask,
)
from rkmh_tpu_torch.ops.probe import (
    _panel_probe_cuda,
    _panel_probe_filter_cuda,
    _panel_probe_partial_cuda,
    panel_probe_filter_plain,
    panel_probe_partial_plain,
    panel_probe_plain,
)
from rkmh_tpu_torch.ops.set_probe import _set_probe_cuda, set_probe_plain
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

SOURCES = ("window_hash.cu", "panel_probe.cu", "counter.cu", "set_probe.cu", "lut_gather.cu",
           "hashmap.cu", "call_scan.cu", "set_table.cu")
SWAPPED = (kernels.WINDOW_HASH, kernels.PANEL_PROBE, kernels.PANEL_PROBE_FILTER,
           kernels.PANEL_PROBE_PARTIAL, kernels.COUNTER_ADD, kernels.COUNTER_MASK,
           kernels.SET_PROBE, kernels.LUT_GATHER_ROWS, kernels.LUT_GATHER_LANES,
           kernels.HASHMAP_GET, kernels.CALL_SCAN, kernels.SET_TABLE_FILL)
_p, _i64 = ctypes.c_void_p, ctypes.c_int64
DIAG_ADD_SLOTS = kernels.Kernel("rkmh_diag_add_slots", [_p, _i64, _p])
DIAG_SOURCE = Path(__file__).resolve().parent / "diag_atomics.cu"
B, L, K, S = 16384, 160, 12, 1000
K_OTHER = 21  # a k <= 32 that none of the repo's configurations uses
HPV16_B, HPV16_K = 512, 18
STREAM_COUNTER, HPV16_COUNTER = 200_000_000, 800_000_000
DIAG_COUNTERS = (10_000_000, 200_000_000, 800_000_000)
K3_SEGMENTS = (512, 1024, 4096)  # beside ops/set_probe.SEGMENT
MIN_OCC = 2  # -M 2, as the README's stream -M example and chip_smoke.py
K4_NS = (512, 4096, 16384)  # the gather sweep's N that take the cache route
# (N, M) of [N, 128] LUTs: the sweep's shape, 4 outputs a lane, a ragged one
K5_SHAPES = {"512": (512, 128), "512x512": (512, 512), "300x77": (300, 77)}
# grids (blocks, threads) of the launch floor: K5's reg route and staged route at
# N = 512, and one block
FLOOR_GRIDS = ((128, 128), (512, 128), (1, 32))
K9_CHECKED = 20_000  # positions of the 1 Mbp scan held against the plain version
ITERS = 50        # eager calls per timing
GRAPH_CALLS = 20  # calls per CUDA graph, replayed 5 times


def say(msg: str) -> None:
    print(msg, flush=True)


def entry_points(src: Path) -> dict[str, str]:
    """{C entry point: its parameter list, whitespace collapsed} of a source."""
    return {m.group(1): " ".join(m.group(2).split())
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text())}


def changed_entry_points(d: Path) -> frozenset:
    """The entry points that DIR's sources declare with another parameter
    list than this checkout's."""
    changed = set()
    for src in held_sources(d):
        ours = entry_points(kernels.CSRC / src.name)
        changed |= {sym for sym, params in entry_points(src).items()
                    if ours.get(sym, params) != params}
    return frozenset(changed)


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The wrappers launch the entry points of ``lib`` (those it has)."""
    saved = [kern._fn for kern in SWAPPED]
    try:
        for kern in SWAPPED:
            if hasattr(lib, kern.symbol):
                kern._fn = kern.function(lib)
        yield
    finally:
        for kern, fn in zip(SWAPPED, saved):
            kern._fn = fn


def variant(arg: str) -> tuple[str, Path]:
    """``NAME=DIR`` -> (NAME, DIR)."""
    name, sep, path = arg.partition("=")
    if not sep or not name or not path or name in ("old", "new"):
        raise argparse.ArgumentTypeError(f"expected NAME=DIR with NAME not old or new, got {arg!r}")
    return name, Path(path)


def has_kernels(lib, kerns) -> bool:
    return all(hasattr(lib, kern.symbol) for kern in kerns)


def held_sources(d: Path) -> list[Path]:
    """The kernel sources a directory holds."""
    return [d / s for s in SOURCES if (d / s).exists()]


def build_libraries(old_csrc: Path, variants: list) -> dict:
    """{name: library}; raises for a directory whose sources declare an
    entry point with another parameter list than this checkout's."""
    ab = kernels.BUILD_DIR / "ab"
    paths = {}
    for name, d in (("old", old_csrc), *variants):
        srcs = held_sources(d)
        if not srcs:
            raise FileNotFoundError(f"{name}: {d} holds none of {SOURCES}")
        changed = changed_entry_points(d)
        if changed:
            raise ValueError(f"{name}: {d} declares {sorted(changed)} with another parameter "
                             "list than this checkout's")
        paths[name] = kernels.build(srcs, ab / f"lib{name}.so")
    paths["new"] = kernels.build()
    paths["diag"] = kernels.build([DIAG_SOURCE], ab / "libdiag.so")
    say(f"libraries: {paths}")
    return {name: ctypes.CDLL(str(p)) for name, p in paths.items()}


def ptxas_registers() -> dict:
    """{mangled kernel: registers} from ``nvcc -Xptxas -v`` on the new sources."""
    regs = {}
    out = kernels.BUILD_DIR / "ab" / "ptxas.o"
    for src in SOURCES:
        err = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                              "-o", str(out), str(kernels.CSRC / src)],
                             capture_output=True, text=True, check=True).stderr
        name = None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            name = m.group(1) if m else name
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name] = int(m.group(1))
    out.unlink(missing_ok=True)
    return regs


def sass_counts(lib_path: Path) -> dict:
    """{kernel: SASS instructions} of the kernels in a library."""
    tool = shutil.which("cuobjdump") or str(Path(kernels._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


def stream_batch(dev):
    from rkmh_tpu_torch.commands.common import PyPacked, build_ref_panel
    from rkmh_tpu_torch.io.fastx import SeqRecord

    names, genomes = synth.make_panel()
    recs = [SeqRecord(n, g.tobytes()) for n, g in zip(names, synth._ACGTN[genomes])]
    panel = build_ref_panel(PyPacked(recs), (K,), S, dev)
    reads, _ = synth.make_reads(genomes, B, seed=11)
    codes = np.full((B, L), 255, np.uint8)
    codes[:, : reads.shape[1]] = CODE_LUT[reads]
    return panel, torch.from_numpy(codes).to(dev)


def hpv16_batch(dev):
    """-> (codes [512, Lmax] on the card, unpadded lengths [512] int32)."""
    panel = synth.make_hpv16_panel(0)
    reads, _ = synth.make_nanopore_reads(HPV16_B, 1, panel)
    codes, lens = encode_seqs([r.tobytes() for r in reads])
    return torch.from_numpy(codes).to(dev), torch.from_numpy(lens.astype(np.int32)).to(dev)


def hpv16_tables(dev):
    """The full-width synthetic hpv16 tables, as ``chip_smoke.py`` builds
    them, and K13's inputs for the set table (the panel's entries at its
    bucket count, as phase 40 makes them)."""
    from rkmh_tpu_torch.commands import hpv16_cmd

    with tempfile.TemporaryDirectory() as tmp:
        synth.write_hpv16_refpath(tmp, 0)
        conf = hpv16_cmd.Hpv16Config(refpath=tmp, ks=(HPV16_K,), tst_file=False)
        tb = hpv16_cmd.build_tables(conf, (HPV16_K,), dev)
        rows = hpv16_cmd.panel_rows(conf, HPV16_K, dev)
    R = rows.hashes.shape[0]
    nb, width = tb.comb_table.shape
    fill = lookup.fill_inputs(lookup._unique_entries(rows.hashes, rows.mask, R), nb, False)
    return tb, (fill, nb, lookup.table_slots(width, R))


class Case:
    """One timed call of the wrappers, on whichever library they point at;
    ``check`` compares one run with the plain version."""

    def __init__(self, kerns, new, check=None):
        self.kerns, self.new, self.check = kerns, new, check

    def runs_on(self, lib) -> bool:
        return has_kernels(lib, self.kerns)


def equals(plain):
    """A check for a call that returns its result (a tensor or a tuple of
    them): equal to plain()."""
    want = []

    def check(fn):
        if not want:
            want.append(plain())
        got, ref = fn(), want[0]
        if isinstance(ref, tuple):
            return all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))
        return torch.equal(got, ref)
    return check


def adds_like_plain(table, hashes, mask):
    """A check for a counter add into ``table`` (zeroed before and after):
    the table equals counter_add_plain's."""
    want = []

    def check(fn):
        if not want:
            want.append(counter.counter_add_plain(torch.zeros_like(table), hashes, mask))
        table.zero_()
        fn()
        ok = torch.equal(table, want[0])
        table.zero_()
        return ok
    return check


def device_time_by_kernel(fn, calls: int = 10) -> dict:
    """{kernel name: mean device microseconds per call of fn}, from
    torch.profiler over ``calls`` eager calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        us = getattr(ev, "cuda_time_total", 0) if us is None else us
        if us and ev.device_type.name == "CUDA":
            out[ev.key[:60]] = us / calls
    return out


def k6_diagnostics(libs, hashes, mask, windows, dev) -> dict:
    """What sets K6's time: the atomics alone on precomputed slots (as
    they come, sorted, random), and K6 old and new by counter size."""
    diag = DIAG_ADD_SLOTS.function(libs["diag"])
    DIAG_ADD_SLOTS._fn = diag
    res = {}
    table = torch.zeros(STREAM_COUNTER, dtype=torch.int32, device=dev)
    slots = counter.slots(hashes[mask], STREAM_COUNTER).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(29)
    cases = {"as they come": slots, "sorted": torch.sort(slots).values,
             "random": torch.randint(0, STREAM_COUNTER, slots.shape, dtype=torch.int32,
                                     device=dev, generator=gen)}
    for label, sl in cases.items():
        want = torch.bincount(sl.long(), minlength=1)
        table.zero_()
        DIAG_ADD_SLOTS(sl, sl.numel(), table)
        if not torch.equal(table[: want.numel()].long(), want):
            raise AssertionError(f"the atomics diagnostic miscounts on slots {label}")
        ms = [cuda_graph_time_ms(lambda: DIAG_ADD_SLOTS(sl, sl.numel(), table), GRAPH_CALLS)
              for _ in range(2)]
        res[f"atomics alone, {sl.numel()} slots {label} ({int(torch.unique(sl).numel())} "
            f"distinct), 2e8-slot table"] = ms
    del table
    for size in DIAG_COUNTERS:
        table = torch.zeros(size, dtype=torch.int32, device=dev)
        runs = {label: [] for name in ("old", "new")
                for label in (name, f"{name}, one atomic per element")}
        for name in ("old", "new", "new", "old"):
            if not has_kernels(libs[name], (kernels.COUNTER_ADD,)):
                continue
            with using(libs[name]):  # K6's entry point is the same in an old library
                runs[name].append(cuda_graph_time_ms(
                    lambda: counter._counter_add_cuda(table, hashes, None, windows),
                    GRAPH_CALLS))
                runs[f"{name}, one atomic per element"].append(cuda_graph_time_ms(
                    lambda: counter._counter_add_cuda(table, hashes, None, windows,
                                                      binned=False), GRAPH_CALLS))
        for label, ms in runs.items():
            if ms:
                res[f"K6 {label}, {size}-slot table"] = ms
        del table
    # as many random hashes, nearly all distinct slots: nothing to merge
    table = torch.zeros(STREAM_COUNTER, dtype=torch.int32, device=dev)
    distinct = torch.randint(-(2**63), 2**63 - 1, tuple(hashes.shape), dtype=torch.int64,
                             device=dev, generator=gen)
    with using(libs["new"]):
        for label, kw in (("through the bins", {"binned": True}),
                          ("one atomic per element", {"binned": False})):
            res[f"K6 new, {label}, random hashes, 2e8-slot table"] = [
                cuda_graph_time_ms(lambda: counter._counter_add_cuda(
                    table, distinct, None, windows, **kw), GRAPH_CALLS) for _ in range(2)]
        by_kernel = device_time_by_kernel(
            lambda: counter._counter_add_cuda(table, hashes, None, windows))
    say(f"K6 through the bins, device microseconds per call by kernel: {by_kernel}")
    for label, ms in res.items():
        say(f"K6 diagnostic: {label}: {', '.join(f'{x:.4f}' for x in ms)} ms")
    res["device_us_by_kernel"] = by_kernel
    return res


def k6_merge_stats(table, hashes, windows) -> dict:
    """What K6's merge does with one batch, and the route a HashCounter
    would give the rest of a pass of such batches."""
    stats = torch.zeros(2, dtype=torch.int32, device=table.device)
    counter._counter_add_cuda(table, hashes, None, windows, binned=True, stats=stats)
    table.zero_()
    adds, elements = stats.tolist()
    return {"elements": elements, "adds": adds,
            "through_the_bins": counter.merge_pays(elements, adds)}


def k7_diagnostics(libs, hashes, dev) -> dict:
    """What sets K7's time: K7, old and new, at the stream batch on
    counters of 1e7, 2e8 and 8e8 slots (each holding the batch), on the
    same hashes sorted by slot, and on as many zero hashes."""
    res = {}
    flat = hashes.reshape(-1)
    for size in DIAG_COUNTERS:
        table = counter.counter_add_plain(torch.zeros(size, dtype=torch.int32, device=dev),
                                          hashes)
        by_slot = flat[torch.argsort(counter.slots(flat, size))].reshape(hashes.shape)
        cases = {f"{size}-slot table": hashes, f"{size}-slot table, sorted by slot": by_slot}
        if size == STREAM_COUNTER:
            cases["zero hashes"] = torch.zeros_like(hashes)
        for label, x in cases.items():
            runs = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                if has_kernels(libs[name], (kernels.COUNTER_MASK,)):
                    with using(libs[name]):
                        runs[name].append(cuda_graph_time_ms(lambda: counter._counter_mask_cuda(
                            table, x, MIN_OCC, counter.INT32_MAX), GRAPH_CALLS))
            for name, ms in runs.items():
                if ms:
                    res[f"K7 {name}, {label}"] = ms
        del table
    for label, ms in res.items():
        say(f"K7 diagnostic: {label}: {', '.join(f'{x:.4f}' for x in ms)} ms")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, required=True,
                    help="directory with earlier versions of some of " + ", ".join(SOURCES))
    ap.add_argument("--variant", type=variant, action="append", default=[],
                    metavar="NAME=DIR", help="a further build, of the sources DIR holds")
    ap.add_argument("--only", action="append", default=[], metavar="PREFIX",
                    help="time only the cases whose name starts so (k1, k2, k3, k6, ...)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = f"{torch.cuda.get_device_name(0)} ({card_name_and_power_limit()})"
    say(f"card: {card}")
    libs = build_libraries(args.old_csrc, args.variant)
    panel, codes = stream_batch(dev)
    R = panel.num_refs
    # the zika panel at S = 2 (K2's S = 2 route, Wm = 2), and its shard 0 of 2
    # (30 references: rkmh-tpu's S = 2 geometry, Wm = 1)
    from rkmh_tpu_torch.parallel.mesh import build_sharded_tables

    sk_np, lens_np = panel.sketches.cpu().numpy(), panel.lens.cpu().numpy()
    s2_table = torch.from_numpy(lookup.build_panel_table(sk_np, lens_np, slots=2).table
                                .view(np.int32)).to(dev)
    shards, rps = build_sharded_tables(sk_np, lens_np, 2)
    shard0 = torch.from_numpy(np.ascontiguousarray(shards[0]).view(np.int32)).to(dev)
    say(f"zika panel at S = 2: {tuple(s2_table.shape)}; shard 0 of 2: {tuple(shard0.shape)}, "
        f"{rps} references")
    hashes = _window_hashes_cuda(codes, [K], 42)
    sk, lens = bottom_s_sketch(hashes, 50)
    hp, hp_lens = hpv16_batch(dev)
    say(f"stream batch {tuple(codes.shape)}, table {tuple(panel.table.shape)}; "
        f"hpv16 batch {tuple(hp.shape)}")

    # K6: the counter pass's call on both batches
    read_lens = torch.full((B,), 150, dtype=torch.int32, device=dev)
    windows, mask = (read_lens, L, [K]), window_mask(read_lens, L, [K])
    stream_table = torch.zeros(STREAM_COUNTER, dtype=torch.int32, device=dev)
    hp_hashes = _window_hashes_cuda(hp, [HPV16_K], 42)
    hp_windows = (hp_lens, hp.shape[1], [HPV16_K])
    hp_mask = window_mask(hp_lens, hp.shape[1], [HPV16_K])
    hp_table = torch.zeros(HPV16_COUNTER, dtype=torch.int32, device=dev)
    # K7: -M 2 against counters that hold each batch once
    k7_tables = {}
    for key, h, msk, size in (("stream", hashes, mask, STREAM_COUNTER),
                              ("hpv16", hp_hashes, hp_mask, HPV16_COUNTER)):
        k7_tables[key] = counter.counter_add_plain(
            torch.zeros(size, dtype=torch.int32, device=dev), h, msk)
    say(f"K7 hpv16 batch: {tuple(hp_hashes.shape)} hashes, "
        f"{float((hp_hashes == 0).float().mean()):.4f} of them 0")
    # K4: the gather sweep's LUTs and indices
    rng = np.random.default_rng(13)
    luts = {N: (torch.from_numpy(rng.integers(-2**31, 2**31, (N, 128)).astype(np.int32)).to(dev),
                torch.from_numpy(rng.integers(0, N, (N, 128)).astype(np.int32)).to(dev))
            for N in K4_NS}
    k5_luts = {key: (torch.from_numpy(rng.integers(-2**31, 2**31, (N, 128)).astype(np.int32))
                     .to(dev), torch.from_numpy(rng.integers(0, 128, (N, M)).astype(np.int32))
                     .to(dev)) for key, (N, M) in K5_SHAPES.items()}

    # K3: the sorted rows of the hpv16 batch against the full-width tables
    tb, (k13_in, k13_nb, k13_S) = hpv16_tables(dev)
    T, U = len(tb.type_names), tb.n_lin + tb.n_sub
    Wc = engine.hpv16_compact_width(hp_lens.cpu().numpy(), hp.shape[1], (HPV16_K,))
    full, hp_sk_lens = bottom_s_sketch(hp_hashes, hp_hashes.shape[1])
    hp_rows = full[:, :Wc]
    k3_plain = equals(lambda: set_probe_plain(hp_rows, hp_sk_lens, tb.comb_table, T, U))
    say(f"hpv16 tables: logical {tuple(tb.comb_table.shape)}, packed "
        f"{tb.probe_table.nbytes / 2**20:.1f} MiB (set-up s: {tb.setup_s}); rows "
        f"{tuple(hp_rows.shape)}")

    K1, K2, K2F = (kernels.WINDOW_HASH,), (kernels.PANEL_PROBE,), (kernels.PANEL_PROBE_FILTER,)
    K6, K3 = (kernels.COUNTER_ADD,), (kernels.SET_PROBE,)
    K2P, K13 = (kernels.PANEL_PROBE_PARTIAL,), (kernels.SET_TABLE_FILL,)
    K7, K4, K5 = (kernels.COUNTER_MASK,), (kernels.LUT_GATHER_ROWS,), (kernels.LUT_GATHER_LANES,)
    K8, K9 = (kernels.HASHMAP_GET,), (kernels.CALL_SCAN,)
    ck = call_inputs.CALL_K
    with tempfile.TemporaryDirectory() as tmp:
        cw = call_inputs.call_workload(dev, tmp)
    ctable = cw["table"]
    pos_hashes = call_engine.positional_hashes(cw["codes"], ck)
    scans = {key: (codes_, *call_inputs.scan_inputs(codes_, ctable))
             for key, codes_ in (("k9_call", cw["codes"]), ("k9_1mbp", cw["big"]))}
    say(f"call workload: map {cw['map_stats']}, reference {cw['codes'].numel()} codes, "
        f"1 Mbp reference {cw['big'].numel()} codes")

    def k8_case(h):
        return Case(K8, lambda: hashmap._hashmap_get_cuda(ctable, h),
                    check=equals(lambda: hashmap.hashmap_get_plain(ctable, h)))

    get = call_engine.plain_getter(ctable)

    def k9_case(key, positions=None, route=None):
        codes_, depth, avg, site = scans[key]
        n = positions or codes_.numel() - ck + 1

        def plain():
            return call_engine._enumerate_plain(codes_, get, ck, depth, avg, site, 0, n)

        def first(fn):  # the kernel's outputs at the plain version's positions
            return lambda: tuple(t[:n] for t in fn())

        check = equals(plain)
        return Case(K9, lambda: call_engine._call_scan_cuda(codes_, ctable, ck, depth, avg,
                                                            site, route),
                    check=lambda fn: check(first(fn)))

    def k6_case(table, h, win, msk, **kw):
        return Case(K6, lambda: counter._counter_add_cuda(table, h, None, win, **kw),
                    check=adds_like_plain(table, h, msk))

    def k7_case(key, h):
        table = k7_tables[key]
        return Case(K7, lambda: counter._counter_mask_cuda(table, h, MIN_OCC, counter.INT32_MAX),
                    check=equals(lambda: counter.counter_mask_plain(table, h, MIN_OCC,
                                                                    counter.INT32_MAX)))

    def k4_case(N):
        lut, idx = luts[N]
        return Case(K4, lambda: gather._lut_gather_rows_cuda(lut, idx),
                    equals(lambda: gather.lut_gather_rows_plain(lut, idx)))

    def k5_case(key, route=None):
        lut, idx = k5_luts[key]
        return Case(K5, lambda: gather._lut_gather_lanes_cuda(lut, idx, route),
                    equals(lambda: gather.lut_gather_lanes_plain(lut, idx)))

    cases = {
        "k1_stream": Case(K1, lambda: _window_hashes_cuda(codes, [K], 42),
                          check=equals(lambda: kmer_window_hashes_plain(codes, K))),
        "k1_stream_k21": Case(K1, lambda: _window_hashes_cuda(codes, [K_OTHER], 42),
                              check=equals(lambda: kmer_window_hashes_plain(codes, K_OTHER))),
        "k1_hpv16": Case(K1, lambda: _window_hashes_cuda(hp, [HPV16_K], 42),
                         check=equals(lambda: kmer_window_hashes_plain(hp, HPV16_K))),
        "k2_raw": Case(K2, lambda: _panel_probe_cuda(hashes, None, panel.table, R, 0, -1),
                       check=equals(lambda: panel_probe_plain(hashes, None, panel.table, R, 0,
                                                              -1))),
        "k2_sorted_s50": Case(K2, lambda: _panel_probe_cuda(sk, lens, panel.table, R, 0, -1),
                              check=equals(lambda: panel_probe_plain(sk, lens, panel.table, R,
                                                                     0, -1))),
        "k2_filter_raw": Case(
            K2F, lambda: _panel_probe_filter_cuda(hashes, None, panel.table, R, panel.lens, 0, 10),
            check=equals(lambda: panel_probe_filter_plain(hashes, None, panel.table, R,
                                                          panel.lens, 0, 10))),
        "k2_raw_s2": Case(K2, lambda: _panel_probe_cuda(hashes, None, s2_table, R, 0, -1),
                          check=equals(lambda: panel_probe_plain(hashes, None, s2_table, R, 0,
                                                                 -1))),
        "k2_filter_raw_s2": Case(
            K2F, lambda: _panel_probe_filter_cuda(hashes, None, s2_table, R, panel.lens, 0, 10),
            check=equals(lambda: panel_probe_filter_plain(hashes, None, s2_table, R,
                                                          panel.lens, 0, 10))),
        "k2_partial_shard0": Case(
            K2P, lambda: _panel_probe_partial_cuda(hashes, None, shard0, rps, -1),
            check=equals(lambda: panel_probe_partial_plain(hashes, None, shard0, rps, -1))),
        "k13_hpv16": Case(K13, lambda: lookup.set_table_fill(*k13_in, k13_nb, k13_S),
                          check=equals(lambda: lookup.set_table_fill_plain(*k13_in, k13_nb,
                                                                           k13_S))),
        "device_step": Case(K1 + K2,
                            lambda: engine.classify_codes_table(codes, panel, (K,), S, 0, -1)),
        "k6_stream": k6_case(stream_table, hashes, windows, mask),
        "k6_stream_one_atomic_each": k6_case(stream_table, hashes, windows, mask, binned=False),
        "k6_stream_mask_tensor": Case(
            K6, lambda: counter._counter_add_cuda(stream_table, hashes, mask),
            check=adds_like_plain(stream_table, hashes, mask)),
        "k6_hpv16": k6_case(hp_table, hp_hashes, hp_windows, hp_mask),
        "k6_hpv16_one_atomic_each": k6_case(hp_table, hp_hashes, hp_windows, hp_mask,
                                            binned=False),
        "k3_hpv16": Case(K3, lambda: _set_probe_cuda(hp_rows, hp_sk_lens, tb.probe_table, T, U),
                         check=k3_plain),
        **{f"k3_hpv16_seg{seg}": Case(
            K3, lambda seg=seg: _set_probe_cuda(hp_rows, hp_sk_lens, tb.probe_table, T, U,
                                                seg=seg), check=k3_plain) for seg in K3_SEGMENTS},
        "hpv16_step": Case(K1 + K3, lambda: engine.hpv16_batch_comb(hp, tb.probe_table,
                                                                     (HPV16_K,), T, U, Wc)),
        "k7_stream": k7_case("stream", hashes),
        "k7_hpv16": k7_case("hpv16", hp_hashes),
        **{f"k4_{N}": k4_case(N) for N in K4_NS},
        "k5_512": k5_case("512"),
        "k5_512_smem": k5_case("512", "smem"),
        "k5_512x512": k5_case("512x512"),
        "k5_300x77": k5_case("300x77"),
        "k8_scan": k8_case(pos_hashes),
        "k8_2e20": k8_case(cw["read_hashes"]),
        "k9_call": k9_case("k9_call"),
        "k9_call_bytewise": k9_case("k9_call", route="bytewise"),
        "k9_1mbp": k9_case("k9_1mbp", K9_CHECKED),
    }
    if args.only:
        cases = {c: v for c, v in cases.items() if c.startswith(tuple(args.only))}

    raw_stats = bounds.panel_probe_stats(hashes, None, panel.table, R)
    s2_stats = bounds.panel_probe_stats(hashes, None, s2_table, R)
    shard_stats = bounds.panel_probe_stats(hashes, None, shard0, rps)
    k13_n, k13_wm = k13_in[0].numel(), k13_in[5].shape[1]
    sk_stats = bounds.panel_probe_stats(sk, lens, panel.table, R)
    k3_stats = bounds.set_probe_stats(hp_rows, hp_sk_lens, tb.comb_table, T + U)
    k1_bytes = {"k1_stream": bounds.tensor_bytes(codes, hashes),
                "k1_stream_k21": bounds.tensor_bytes(codes) + B * (L - K_OTHER + 1) * 8,
                "k1_hpv16": hp.numel() * 9 - hp.shape[0] * (HPV16_K - 1) * 8}
    k2_bytes = bounds.tensor_bytes(hashes) + raw_stats.table_bytes

    def k6_bound(h, msk, ln, size):  # the hashes and read lengths, the slots' sectors twice
        sectors = bounds.sector_bytes(torch.unique(counter.slots(h[msk], size)) * 4)
        return bounds.bound_ms(bounds.tensor_bytes(h, ln) + 2 * sectors)

    def k7_bound(h, size):  # the hashes in and out, the non-zero hashes' sectors once
        sectors = bounds.sector_bytes(torch.unique(counter.slots(h[h != 0], size)) * 4)
        return bounds.bound_ms(2 * bounds.tensor_bytes(h) + sectors)

    k3_rows = bounds.read_row_bytes(hp_rows, hp_sk_lens) + 4 * HPV16_B + 8 * HPV16_B * (2 + U)
    bound = {**{c: bounds.bound_ms(b) for c, b in k1_bytes.items()},
             "k2_raw": bounds.bound_ms(k2_bytes + 3 * 4 * B),
             "k2_filter_raw": bounds.bound_ms(k2_bytes + 5 * 4 * B + 4 * R),
             "k2_raw_s2": bounds.bound_ms(bounds.tensor_bytes(hashes) + s2_stats.table_bytes
                                          + 3 * 4 * B),
             "k2_filter_raw_s2": bounds.bound_ms(bounds.tensor_bytes(hashes)
                                                 + s2_stats.table_bytes + 5 * 4 * B + 4 * R),
             "k2_partial_shard0": bounds.bound_ms(bounds.tensor_bytes(hashes)
                                                  + shard_stats.table_bytes
                                                  + bounds.PARTIAL_OUT * B),
             # the table written once, the entries and their mask rows read once
             "k13_hpv16": bounds.bound_ms(4 * k13_nb * k13_S * (3 + k13_wm)
                                          + bounds.tensor_bytes(*k13_in[:5])
                                          + 4 * k13_n * k13_wm + 4),
             "k2_sorted_s50": bounds.bound_ms(bounds.read_row_bytes(sk, lens) + 4 * B
                                              + sk_stats.table_bytes + 3 * 4 * B),
             "k6_stream": k6_bound(hashes, mask, read_lens, STREAM_COUNTER),
             "k6_hpv16": k6_bound(hp_hashes, hp_mask, hp_lens, HPV16_COUNTER),
             "k3_hpv16": bounds.bound_ms(k3_rows + k3_stats.table_bytes),
             "k3_hpv16_packed_layout": bounds.bound_ms(
                 k3_rows + bounds.packed_set_table_bytes(k3_stats, tb.probe_table)),
             "k7_stream": k7_bound(hashes, STREAM_COUNTER),
             "k7_hpv16": k7_bound(hp_hashes, HPV16_COUNTER),
             **{f"k4_{N}": bounds.bound_ms(3 * bounds.tensor_bytes(luts[N][0])) for N in K4_NS},
             **{f"k5_{key}": bounds.bound_ms(bounds.tensor_bytes(lut, idx, idx))  # out = idx
                for key, (lut, idx) in k5_luts.items()}}
    bound["k5_512_smem"] = bound["k5_512"]
    if any(c.startswith(("k8", "k9")) for c in cases):
        bound.update({"k8_scan": bounds.bound_ms(bounds.hashmap_get_bytes(ctable, pos_hashes)),
                      "k8_2e20": bounds.bound_ms(bounds.hashmap_get_bytes(ctable,
                                                                          cw["read_hashes"])),
                      **{key: bounds.bound_ms(bounds.call_scan_bytes(scans[key][0], ctable, ck))
                         for key in scans}})
        bound["k9_call_bytewise"] = bound["k9_call"]
    say(f"K2 raw rows: {raw_stats.probes / B:.2f} probes, {raw_stats.hits / B:.2f} hits per "
        f"read, {raw_stats.mask_bits / max(raw_stats.hits, 1):.2f} of {R} mask bits set per "
        f"hit, {raw_stats.table_bytes} table bytes reached (at S = 2 "
        f"{s2_stats.table_bytes}, shard 0 of 2 {shard_stats.table_bytes}); K3: "
        f"{vars(k3_stats)}; K13: {k13_n} entries into [{k13_nb}, {k13_S * (3 + k13_wm)}]; "
        f"bounds (ms): {bound}")
    names = [name for name, _ in args.variant]
    order = ("old", "new", *names, *names[::-1], "new", "old")
    res = {"card": card, "iters": ITERS, "order": list(order), "bound_ms": bound,
           "k2_raw_probe_stats": vars(raw_stats), "k2_s2_probe_stats": vars(s2_stats),
           "k2_shard0_probe_stats": vars(shard_stats), "k3_probe_stats": vars(k3_stats),
           "ms": {}, "eager_ms": {}}
    timed = [n for n in libs if n != "diag"]
    for name, case in cases.items():
        runs = {n: [] for n in timed}
        eager = {n: [] for n in timed}
        for lib in order:
            if not case.runs_on(libs[lib]):
                continue
            with using(libs[lib]):
                fn = case.new
                if case.check is not None and not case.check(fn):
                    raise AssertionError(f"{name}: the {lib} kernels disagree with the plain "
                                         "version")
                runs[lib].append(cuda_graph_time_ms(fn, GRAPH_CALLS))
                eager[lib].append(cuda_time_ms(fn, ITERS))
        res["ms"][name] = {n: r for n, r in runs.items() if r}
        res["eager_ms"][name] = {n: r for n, r in eager.items() if r}
        say(f"{name}: " + ", ".join(
            f"{n} {np.mean(r):.5f} ms ({', '.join(f'{x:.5f}' for x in r)}; eager "
            f"{', '.join(f'{x:.4f}' for x in eager[n])})" for n, r in runs.items() if r))
    if not args.only or any(o.startswith("k6") for o in args.only):
        res["k6_diagnostics"] = k6_diagnostics(libs, hashes, mask, windows, dev)
        res["k6_merge"] = {"stream": k6_merge_stats(stream_table, hashes, windows),
                           "hpv16": k6_merge_stats(hp_table, hp_hashes, hp_windows)}
        say(f"K6 merge, elements into adds to the table, and a counter pass's route: "
            f"{res['k6_merge']}")
    if not args.only or any(o.startswith("k7") for o in args.only):
        res["k7_diagnostics"] = k7_diagnostics(libs, hashes, dev)
    if any(c.startswith("k5") for c in cases):
        res["launch_floor_ms"] = {f"{b}x{t}": [launch_floor_ms(dev, b, t, GRAPH_CALLS)
                                               for _ in range(2)] for b, t in FLOOR_GRIDS}
        say(f"launch floor, an empty kernel by graph replay, ms per launch (blocks x threads): "
            f"{res['launch_floor_ms']}")
    res["ptxas_registers"] = ptxas_registers()
    res["sass_instructions"] = sass_counts(kernels.library_path())
    res["sass_instructions_old"] = sass_counts(kernels.BUILD_DIR / "ab" / "libold.so")
    say(f"registers: {res['ptxas_registers']}")
    say(f"SASS instructions (new): {res['sass_instructions']}")
    say(f"SASS instructions (old): {res['sass_instructions_old']}")
    say(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
