"""Build, load and launch the port's CUDA kernels.

The sources are ``rkmh_tpu_torch/csrc/*.cu``.  They compile with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded
with ctypes.  The library goes to ``rkmh_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags, so
the first use in a fresh checkout builds it and later uses load it.
Nothing is built or loaded on import.

Each C entry point returns ``cudaGetLastError()`` after its launch on the
stream it is given (PyTorch's current stream); ``Kernel`` raises if that
is not 0 and counts successful launches.
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
              "-shared", "-Xcompiler", "-fPIC")

_lib = None  # the loaded library, shared by every Kernel of this process


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
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


def build() -> Path:
    """Compile every source into the library; returns its path."""
    nvcc = _nvcc()
    path = library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
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
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            err = self._fn(*cargs, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with error {err}")
        self.launches += 1


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# rkmh_window_hash(codes, B, L, k, seed, out, out_cols, col0, stream)
WINDOW_HASH = Kernel("rkmh_window_hash", [_p, _i, _i, _i, ctypes.c_uint64, _p, _i64, _i64])
# rkmh_panel_probe(rows, lens|NULL, B, n, table, log2_buckets, slots,
#                  mask_words, num_refs, min_diff, min_matches, out, stream)
PANEL_PROBE = Kernel("rkmh_panel_probe", [_p, _p, _i, _i, _p, _i, _i, _i, _i, _i, _i, _p])

KERNELS = {"window_hash": WINDOW_HASH, "panel_probe": PANEL_PROBE}


def reset_launch_counts() -> None:
    for kern in KERNELS.values():
        kern.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: kern.launches for name, kern in KERNELS.items()}
