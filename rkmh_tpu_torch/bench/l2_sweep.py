"""Random loads on the card against the footprint of the table they hit.

    python -m rkmh_tpu_torch.bench.l2_sweep [--mb 8 16 ...] [--queries N]

Times ``bench/diag_l2.cu`` (built with nvcc at first use) by CUDA-graph
replay at each footprint: one random 16-byte load a query, two independent
ones (the cuckoo map's probe), and two dependent 8-byte loads (the sorted
map's directory word, then its entry).  The rate in G queries/s falls
where the table stops fitting in the L2 that every SM reads; that size
decides the depth map's layout (``ops/hashmap.py``).  Prints one line a
footprint, then the card's name and power limit, then one JSON object.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from rkmh_tpu_torch.bench.timing import card_name_and_power_limit, cuda_graph_time_ms
from rkmh_tpu_torch.ops import kernels

SOURCE = Path(__file__).resolve().parent / "diag_l2.cu"
# rkmh_diag_random_loads(table, entries, n, mode, seed, sink, stream)
RANDOM_LOADS = kernels.Kernel("rkmh_diag_random_loads",
                              [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_uint64, ctypes.c_void_p])
MODES = {0: "one_16b", 1: "two_16b", 2: "two_dependent_8b"}
FOOTPRINTS_MB = (4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 64, 128, 512)


def sweep(footprints_mb, queries: int, device) -> dict:
    if RANDOM_LOADS._fn is None:
        path = kernels.build([SOURCE], kernels.BUILD_DIR / "diag" / "libdiag_l2.so")
        RANDOM_LOADS._fn = RANDOM_LOADS.function(ctypes.CDLL(str(path)))
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    out = {}
    for mb in footprints_mb:
        entries = int(mb * 1e6) // 16
        table = torch.randint(-2**31, 2**31 - 1, (entries, 4), dtype=torch.int32, device=device)
        row = {}
        for mode, name in MODES.items():
            ms = cuda_graph_time_ms(lambda: RANDOM_LOADS(table, entries, queries, mode, 7, sink),
                                    10)
            row[name] = {"ms": ms, "g_queries_per_s": queries / ms / 1e6}
        out[mb] = row
        print(f"{mb} MB: " + ", ".join(f"{n} {r['ms']:.5f} ms ({r['g_queries_per_s']:.2f} G/s)"
                                       for n, r in row.items()), flush=True)
        del table
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, nargs="+", default=list(FOOTPRINTS_MB))
    ap.add_argument("--queries", type=int, default=1 << 22)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("l2_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    res = sweep(args.mb, args.queries, torch.device("cuda"))
    print(card_name_and_power_limit())
    print(json.dumps({"card": torch.cuda.get_device_name(0), "queries": args.queries,
                      "by_mb": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
