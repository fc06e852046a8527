"""Inputs for K12 (``ops/sparse_margin``) and its check against the plain
version, shared by the kernel tests and ``chip_smoke.py``.

``margin_case`` makes wabbit-shaped inputs from a seed: W [C, D] and dm
[C, N] normal, idx [N, F] uniform in [0, D), val [N, F] normal, each row cut
to a random length and padded as ``ml.wabbit.vectorize`` pads (idx 0,
val 0).  ``edge_cases`` adds a row of padding only, one index repeated
within a row and across every row (many atomics on one slot), index D - 1
and N = 1.  ``check_margins`` runs K12's forward and backward and the plain
version (``sparse_margins_plain`` under autograd) on the same inputs and
returns the largest errors; it raises past the tolerance:

    |kernel - plain| <= 1e-5 * (sum of |terms|) + 1e-6

for each margin (terms W[c, idx] * val) and each gradient entry (terms
val * dm).  Both sums are float32 in another order (K12's warp tree and,
backward, atomics in an order that changes from run to run): each partial
sum rounds at 2**-24 of its size, and 1e-5 allows ~170 roundings of the
whole in one direction.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.ops.sparse_margin import _margins_cuda, _margins_grad_cuda, \
    sparse_margins_plain

REL_TOL, ABS_TOL = 1e-5, 1e-6


def margin_case(N: int, F: int, C: int, bits: int, seed: int, device, pad: float = 0.3):
    """-> (W, idx, val, dm) on ``device``; about a share ``pad`` of each
    row is padding."""
    rng = np.random.default_rng(seed)
    D = 1 << bits
    idx = rng.integers(0, D, size=(N, F)).astype(np.int32)
    val = rng.standard_normal((N, F)).astype(np.float32)
    lens = rng.integers(int(F * (1 - 2 * pad)), F + 1, size=N) if pad else np.full(N, F)
    cut = np.arange(F)[None, :] >= lens[:, None]
    idx[cut], val[cut] = 0, 0.0
    W = rng.standard_normal((C, D)).astype(np.float32)
    dm = rng.standard_normal((C, N)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (W, idx, val, dm))


def edge_cases(device, bits: int = 18):
    """-> {name: (W, idx, val, dm)}: the shapes that stress K12's edges."""
    D = 1 << bits
    cases = {}
    W, idx, val, dm = margin_case(64, 40, 5, bits, 1, device)
    idx[3], val[3] = 0, 0.0  # a row of padding only
    idx[7, :] = 12345        # one index over a whole row ...
    idx[:, 5] = 12345        # ... and in every row
    val[:, 5] = 1.0
    idx[9, :4] = D - 1       # the last slot
    cases["edges"] = (W, idx, val, dm)
    W, idx, val, dm = margin_case(4096, 32, 1, bits, 2, device, pad=0)
    idx[:] = 77              # 131,072 atomics on one slot
    cases["one slot"] = (W, idx, val, dm)
    cases["N = 1"] = margin_case(1, 1002, 11, bits, 3, device)
    cases["all padding"] = margin_case(8, 16, 3, bits, 4, device, pad=0)
    cases["all padding"][1].zero_()
    cases["all padding"][2].zero_()
    return cases


def _abs_terms(W, idx, val, dm):
    """Per-output sums of |terms|: [C, N] forward, [C, D] backward."""
    fwd = (W[:, idx.long()] * val).abs().sum(-1)
    bwd = torch.zeros_like(W).index_add_(
        1, idx.long().reshape(-1), (val.abs()[None] * dm.abs()[:, :, None]).reshape(
            W.shape[0], -1))
    return fwd, bwd


def check_margins(W, idx, val, dm) -> tuple[float, float]:
    """K12 forward and backward against the plain version on W's device
    (a CUDA device); -> (largest forward error, largest gradient error).
    Raises past the tolerance."""
    got_m = _margins_cuda(W, idx, val)
    got_g = _margins_grad_cuda(dm, idx, val, W.shape[1])
    Wp = W.detach().clone().requires_grad_(True)
    want_m = sparse_margins_plain(Wp, idx, val)
    (want_g,) = torch.autograd.grad(want_m, Wp, dm)
    torch.cuda.synchronize()
    bound_m, bound_g = _abs_terms(W, idx, val, dm)
    errs = []
    for what, got, want, bound in (("forward", got_m, want_m.detach(), bound_m),
                                   ("backward", got_g, want_g, bound_g)):
        err = (got - want).abs()
        bad = err > REL_TOL * bound + ABS_TOL
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K12 {what} off its plain version by up to "
                                 f"{float(err.max())} at {int(bad.sum())} outputs")
        errs.append(float(err.max()) if err.numel() else 0.0)
    return errs[0], errs[1]
