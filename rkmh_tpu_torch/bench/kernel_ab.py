"""K1 and K2 of this checkout against other builds of the same kernels,
in turns, in one process on one card.

    python -m rkmh_tpu_torch.bench.kernel_ab --old-csrc DIR [--variant NAME=DIR ...]

``--old-csrc`` DIR holds an earlier ``window_hash.cu`` and
``panel_probe.cu`` with the same C entry points, for example an earlier
commit's (``git show REV:rkmh_tpu_torch/csrc/panel_probe.cu >
DIR/panel_probe.cu``).  Each ``--variant`` DIR holds one or both of them,
for example this checkout's source with one design choice edited.  Each
directory builds with nvcc into a library of its own.  The wrappers of
``ops/hashing`` and ``ops/probe`` then run on each library in turn (old,
new, the variants, the variants in reverse, new, old; a library is timed
only in the cases whose kernels it holds), timed with CUDA events as
device time (calls replayed from a CUDA graph) and as an eager loop
(which, for a kernel of tens of microseconds, measures the Python launch
path), at:

* the stream batch: 16,384 synthetic 150 bp reads padded to 160 codes,
  k=12, the synthetic zika panel (60 references, s=1000, table [131072,
  20] int32): K1 (and K1 at k=21, a k none of the repo's configurations
  uses); K2 on the raw rows, on sorted s=50 sketches and in its filter
  mode; the device step (K1 + K2);
* the hpv16 batch: 512 nanopore-like reads, k=18, padded to the longest
  read: K1.

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
from pathlib import Path

import numpy as np
import torch

from rkmh_tpu_torch import synth
from rkmh_tpu_torch.bench import bounds
from rkmh_tpu_torch.bench.timing import (
    card_name_and_power_limit,
    cuda_graph_time_ms,
    cuda_time_ms,
)
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.io.packing import CODE_LUT, encode_seqs
from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.hashing import _window_hashes_cuda, kmer_window_hashes_plain
from rkmh_tpu_torch.ops.probe import (
    _panel_probe_cuda,
    _panel_probe_filter_cuda,
    panel_probe_filter_plain,
    panel_probe_plain,
)
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

SOURCES = ("window_hash.cu", "panel_probe.cu")
SWAPPED = (kernels.WINDOW_HASH, kernels.PANEL_PROBE, kernels.PANEL_PROBE_FILTER)
B, L, K, S = 16384, 160, 12, 1000
K_OTHER = 21  # a k <= 32 that none of the repo's configurations uses
HPV16_B, HPV16_K = 512, 18
ITERS = 50        # eager calls per timing
GRAPH_CALLS = 20  # calls per CUDA graph, replayed 5 times


def say(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The K1/K2 wrappers launch the entry points of ``lib`` (those it has)."""
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


def build_libraries(old_csrc: Path, variants: list) -> dict:
    ab = kernels.BUILD_DIR / "ab"
    paths = {"old": kernels.build([old_csrc / s for s in SOURCES], ab / "libold.so"),
             "new": kernels.build()}
    for name, d in variants:
        srcs = [d / s for s in SOURCES if (d / s).exists()]
        if not srcs:
            raise FileNotFoundError(f"variant {name}: {d} holds none of {SOURCES}")
        paths[name] = kernels.build(srcs, ab / f"lib{name}.so")
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
    """{kernel: SASS instructions} of the K1 and K2 kernels in a library."""
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
    return {n: c for n, c in counts.items() if "window_hash" in n or "panel_probe" in n}


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
    panel = synth.make_hpv16_panel(0)
    reads, _ = synth.make_nanopore_reads(HPV16_B, 1, panel)
    codes, _ = encode_seqs([r.tobytes() for r in reads])
    return torch.from_numpy(codes).to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, required=True,
                    help="directory with the earlier window_hash.cu and panel_probe.cu")
    ap.add_argument("--variant", type=variant, action="append", default=[],
                    metavar="NAME=DIR", help="a further build, of the sources DIR holds")
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
    hashes = _window_hashes_cuda(codes, [K], 42)
    sk, lens = bottom_s_sketch(hashes, 50)
    hp = hpv16_batch(dev)
    say(f"stream batch {tuple(codes.shape)}, table {tuple(panel.table.shape)}; "
        f"hpv16 batch {tuple(hp.shape)}")

    K1, K2, K2F = (kernels.WINDOW_HASH,), (kernels.PANEL_PROBE,), (kernels.PANEL_PROBE_FILTER,)
    # case: (call, its plain version or None, the kernels it launches)
    cases = {
        "k1_stream": (lambda: _window_hashes_cuda(codes, [K], 42),
                      lambda: kmer_window_hashes_plain(codes, K), K1),
        "k1_stream_k21": (lambda: _window_hashes_cuda(codes, [K_OTHER], 42),
                          lambda: kmer_window_hashes_plain(codes, K_OTHER), K1),
        "k1_hpv16": (lambda: _window_hashes_cuda(hp, [HPV16_K], 42),
                     lambda: kmer_window_hashes_plain(hp, HPV16_K), K1),
        "k2_raw": (lambda: _panel_probe_cuda(hashes, None, panel.table, R, 0, -1),
                   lambda: panel_probe_plain(hashes, None, panel.table, R, 0, -1), K2),
        "k2_sorted_s50": (lambda: _panel_probe_cuda(sk, lens, panel.table, R, 0, -1),
                          lambda: panel_probe_plain(sk, lens, panel.table, R, 0, -1), K2),
        "k2_filter_raw": (
            lambda: _panel_probe_filter_cuda(hashes, None, panel.table, R, panel.lens, 0, 10),
            lambda: panel_probe_filter_plain(hashes, None, panel.table, R, panel.lens, 0, 10),
            K2F),
        "device_step": (lambda: engine.classify_codes_table(codes, panel, (K,), S, 0, -1),
                        None, K1 + K2),
    }
    raw_stats = bounds.panel_probe_stats(hashes, None, panel.table, R)
    sk_stats = bounds.panel_probe_stats(sk, lens, panel.table, R)
    k1_bytes = {"k1_stream": bounds.tensor_bytes(codes, hashes),
                "k1_stream_k21": bounds.tensor_bytes(codes) + B * (L - K_OTHER + 1) * 8,
                "k1_hpv16": hp.numel() * 9 - hp.shape[0] * (HPV16_K - 1) * 8}
    k2_bytes = bounds.tensor_bytes(hashes) + raw_stats.table_bytes
    bound = {**{c: bounds.bound_ms(b) for c, b in k1_bytes.items()},
             "k2_raw": bounds.bound_ms(k2_bytes + 3 * 4 * B),
             "k2_filter_raw": bounds.bound_ms(k2_bytes + 5 * 4 * B + 4 * R),
             "k2_sorted_s50": bounds.bound_ms(bounds.read_row_bytes(sk, lens) + 4 * B
                                              + sk_stats.table_bytes + 3 * 4 * B)}
    say(f"K2 raw rows: {raw_stats.probes / B:.2f} probes, {raw_stats.hits / B:.2f} hits per "
        f"read, {raw_stats.mask_bits / max(raw_stats.hits, 1):.2f} of {R} mask bits set per "
        f"hit, {raw_stats.table_bytes} table bytes reached; bounds (ms): {bound}")
    names = [name for name, _ in args.variant]
    order = ("old", "new", *names, *names[::-1], "new", "old")
    res = {"card": card, "iters": ITERS, "order": list(order), "bound_ms": bound,
           "k2_raw_probe_stats": vars(raw_stats), "ms": {}, "eager_ms": {}}
    for case, (fn, plain, kerns) in cases.items():
        want = plain() if plain is not None else None
        runs = {name: [] for name in libs}
        eager = {name: [] for name in libs}
        for name in order:
            if not has_kernels(libs[name], kerns):
                continue
            with using(libs[name]):
                if want is not None and not torch.equal(fn(), want):
                    raise AssertionError(f"{case}: the {name} kernels disagree with the plain "
                                         "version")
                runs[name].append(cuda_graph_time_ms(fn, GRAPH_CALLS))
                eager[name].append(cuda_time_ms(fn, ITERS))
        res["ms"][case] = {n: r for n, r in runs.items() if r}
        res["eager_ms"][case] = {n: r for n, r in eager.items() if r}
        say(f"{case}: " + ", ".join(
            f"{n} {np.mean(r):.4f} ms ({', '.join(f'{x:.4f}' for x in r)}; eager "
            f"{', '.join(f'{x:.4f}' for x in eager[n])})" for n, r in runs.items() if r))
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
