"""Build, load and launch the port's CUDA kernels.

The sources are ``rkmh_tpu_torch/csrc/*.cu``, with the device code they
share in ``csrc/*.cuh`` headers.  Each source compiles with its own
``nvcc`` process for ``sm_90a``, all started together, and the objects
link into one shared library with a plain C interface, loaded with
ctypes.  The library goes to ``rkmh_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the flags and of every
source and header, so the first use in a fresh checkout builds it, later
uses load it, and a changed header builds it anew.  Nothing is built or
loaded on import.

Each C entry point returns ``cudaGetLastError()`` after its launch on the
stream it is given (PyTorch's current stream); ``Kernel`` raises if that
is not 0 and counts successful launches, in all and, for a kernel with
several routes (K4, K5, K9) or epilogues (K11), by the route the caller
names.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib = None  # the loaded library, shared by every Kernel of this process


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def headers(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cuh"))


def library_path(csrc: Path = CSRC) -> Path:
    """The library's path, keyed by the flags and by every source and
    header under ``csrc``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources(csrc) + headers(csrc)):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librkmh_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME); "
                           "the CUDA kernels cannot be built")
    return str(path)


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel, wait for every one, raise on a failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    results = [(cmd, *proc.communicate(), proc.returncode) for cmd, proc in zip(cmds, procs)]
    for cmd, out, err, rc in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}{err}")


def build(srcs: list[Path] | None = None, path: Path | None = None) -> Path:
    """Compile the sources (default: every source; one nvcc each, in
    parallel) and link them into the library at ``path`` (default:
    ``library_path()``); returns its path.  A source's own directory is
    searched for its headers first, then ``csrc/``."""
    nvcc = _nvcc()
    srcs = sources() if srcs is None else srcs
    path = library_path() if path is None else path
    path.parent.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    objs = [path.parent / f"{stem}.{src.stem}.o" for src in srcs]
    tmp = path.parent / f"{stem}.tmp.so"
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(srcs, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        for leftover in (*objs, tmp):
            leftover.unlink(missing_ok=True)
    return path


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build()
        _lib = ctypes.CDLL(str(path))
    return _lib


class Kernel:
    """One C entry point of the library, with a count of its launches.

    Call it with the entry point's arguments minus the trailing stream:
    tensors pass as their data pointers, None as a null pointer.
    """

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes + [ctypes.c_void_p]  # + the stream
        self.launches = 0
        self.by_route: dict[str, int] = {}  # launches by the route the caller named
        self._fn = None

    def function(self, lib: ctypes.CDLL):
        """This entry point of a loaded library, with its argument types."""
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args, route: str | None = None):
        if self._fn is None:
            self._fn = self.function(load_library())
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            err = self._fn(*cargs, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with error {err}")
        self.launches += 1
        if route is not None:
            self.by_route[route] = self.by_route.get(route, 0) + 1


_p, _i, _i64, _u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64

# rkmh_window_hash(codes, B, L, k, seed, out, out_cols, col0, stream)
WINDOW_HASH = Kernel("rkmh_window_hash", [_p, _i, _i, _i, ctypes.c_uint64, _p, _i64, _i64])
# rkmh_panel_probe(rows, lens|NULL, B, n, table, log2_buckets, slots,
#                  mask_words, num_refs, min_diff, min_matches, out, stream)
PANEL_PROBE = Kernel("rkmh_panel_probe", [_p, _p, _i, _i, _p, _i, _i, _i, _i, _i, _i, _p])
# rkmh_panel_probe_filter(rows, lens|NULL, B, n, table, log2_buckets, slots,
#                         mask_words, num_refs, ref_lens, min_diff, min_matches,
#                         out, stream)
PANEL_PROBE_FILTER = Kernel("rkmh_panel_probe_filter",
                            [_p, _p, _i, _i, _p, _i, _i, _i, _i, _p, _i, _i, _p])
# rkmh_panel_probe_wide(rows, lens|NULL, B, n, slot records, mask rows, log2_buckets, slots,
#                       mask_words, row_words, num_refs, ref_lens|NULL (NULL: stream, else
#                       filter), min_diff, min_matches, out, stream)
PANEL_PROBE_WIDE = Kernel("rkmh_panel_probe_wide",
                          [_p, _p, _i, _i, _p, _p, _i, _i, _i, _i, _i, _p, _i, _i, _p])
# rkmh_set_probe(rows, row_stride, lens, B, n, key records, slot records, log2_buckets,
#                slots, mask_words, num_types, num_uniq, segment, counts|NULL, done|NULL,
#                out, stream)
SET_PROBE = Kernel("rkmh_set_probe", [_p, _i64, _p, _i, _i, _p, _p, _i, _i, _i, _i, _i, _i,
                                      _p, _p, _p])
# rkmh_sorted_probe(rows, row_stride, lens, B, n, keys, nkeys, dir, bits, masks, mask_words,
#                   num_types, num_uniq, segment, counts|NULL, done|NULL, out, stream)
SORTED_PROBE = Kernel("rkmh_sorted_probe", [_p, _i64, _p, _i, _i, _p, _i, _p, _i, _p, _i, _i,
                                            _i, _i, _p, _p, _p])
# rkmh_lut_gather_rows(lut, idx, out, N, C, M, smem, stream)
LUT_GATHER_ROWS = Kernel("rkmh_lut_gather_rows", [_p, _p, _p, _i, _i, _i64, _i])
# rkmh_lut_gather_lanes(lut, idx, out, N, C, M, reg, stream)
LUT_GATHER_LANES = Kernel("rkmh_lut_gather_lanes", [_p, _p, _p, _i, _i, _i, _i])
# rkmh_counter_add(hashes, mask|NULL, lens|NULL, L, ks (host ints), nk, n, table, size,
#                  magic, log2_ceil, cursor|NULL, bins|NULL, shift, nbins, cap, stats|NULL,
#                  stream)
COUNTER_ADD = Kernel("rkmh_counter_add", [_p, _p, _p, _i, _p, _i, _i64, _p, _i64, _u64, _i,
                                          _p, _p, _i, _i, _i, _p])
# rkmh_counter_mask(hashes, n, table, size, magic, log2_ceil, lo, hi, out, stream)
COUNTER_MASK = Kernel("rkmh_counter_mask", [_p, _i64, _p, _i64, _u64, _i, _i, _i, _p])

# the depth map's arguments (ops/hashmap.map_args): words, dir, ov_keys, ov_values, m, bits
_MAP = [_p, _p, _p, _p, _i, _i]
# rkmh_hashmap_get(keys, n, <map>, out, stream)
HASHMAP_GET = Kernel("rkmh_hashmap_get", [_p, _i64, *_MAP, _p])
# rkmh_call_scan(pref, P, k, depth, avg, site, <map>, snp_depth, snp_call,
#                max_rescue, del_depth, del_call, route, stream)
CALL_SCAN = Kernel("rkmh_call_scan", [_p, _i64, _i, _p, _p, _p, *_MAP, _p, _p, _p, _p, _p, _i])

# rkmh_sparse_margin(W, idx, val, m, N, F, C, D, stream)
SPARSE_MARGIN = Kernel("rkmh_sparse_margin", [_p, _p, _p, _p, _i, _i, _i, _i64])
# rkmh_sparse_margin_grad(dm, idx, val, dW, N, F, C, D, stream)
SPARSE_MARGIN_GRAD = Kernel("rkmh_sparse_margin_grad", [_p, _p, _p, _p, _i, _i, _i, _i64])

KERNELS = {"window_hash": WINDOW_HASH, "panel_probe": PANEL_PROBE,
           "panel_probe_filter": PANEL_PROBE_FILTER, "panel_probe_wide": PANEL_PROBE_WIDE,
           "set_probe": SET_PROBE,
           "sorted_probe": SORTED_PROBE,
           "lut_gather_rows": LUT_GATHER_ROWS, "lut_gather_lanes": LUT_GATHER_LANES,
           "counter_add": COUNTER_ADD, "counter_mask": COUNTER_MASK,
           "hashmap_get": HASHMAP_GET, "call_scan": CALL_SCAN,
           "sparse_margin": SPARSE_MARGIN, "sparse_margin_grad": SPARSE_MARGIN_GRAD}


def reset_launch_counts() -> None:
    for kern in KERNELS.values():
        kern.launches = 0
        kern.by_route = {}


def launch_counts() -> dict[str, int]:
    return {name: kern.launches for name, kern in KERNELS.items()}
