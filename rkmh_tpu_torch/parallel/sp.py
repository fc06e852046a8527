"""Sequence parallelism: sketch long genomes in chunks over several devices.

Counterpart of ``rkmh_tpu/parallel/sp.py:23-72`` (``make_sp_mesh``,
``sp_sketch_fn``).  The genome axis splits into sp chunks, chunk c on
device c; each chunk is hashed by K1 together with a halo, the next
chunk's first kmax - 1 codes (cut to k - 1 for each k; the last chunk's
halo is code 255, invalid, as its final windows do not exist), so every
chunk gives L/sp windows a k and no window is hashed twice.  Each chunk
keeps its local bottom-s, and the union of the local sketches, sorted
again on the first device, is the bottom-s of the whole genome: every
element of the global bottom-s is in its chunk's local one.  No command
calls it; it needs no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.io.packing import PAD_CODE
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch
from rkmh_tpu_torch.parallel.mesh import Mesh, make_mesh


def make_sp_mesh(devices) -> Mesh:
    """The ``sp`` axis over ``devices`` (entries may repeat), as the rows
    of a (sp, 1) grid: chunk c on ``mesh[c, 0]``."""
    return make_mesh(list(devices), dp=len(devices), tp=1)


def sp_sketch(mesh: Mesh, codes, ks, sketch_size: int):
    """[R, L] uint8 codes (L a multiple of sp; numpy or a CPU tensor) ->
    (sketch [R, s'] int64, lens [R] int32) on the first device, as
    ``engine.sketch_batch`` gives them on one device (s' = min(s, sp *
    min(s, windows a chunk))."""
    codes = torch.as_tensor(np.asarray(codes))
    R, L = codes.shape
    n = mesh.dp
    if L % n:
        raise ValueError(f"{L} codes a row do not split into {n} chunks")
    Lc, halo = L // n, max(ks) - 1
    home = mesh[0, 0]
    local = []
    for c in range(n):
        dev = mesh[c, 0]
        chunk = codes[:, c * Lc: (c + 1) * Lc]
        if c < n - 1:
            edge = codes[:, (c + 1) * Lc: (c + 1) * Lc + min(halo, Lc)]
        else:
            edge = torch.full((R, min(halo, Lc)), int(PAD_CODE), dtype=torch.uint8)
        parts = [kmer_window_hashes(torch.cat([chunk, edge[:, : k - 1]], dim=1).to(dev), k)
                 for k in ks]
        sk, _ = bottom_s_sketch(torch.cat(parts, dim=-1), sketch_size)
        local.append(sk.to(home, non_blocking=True))
    return bottom_s_sketch(torch.cat(local, dim=-1), sketch_size)
