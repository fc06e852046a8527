"""Sparse margins of the VW trainer's linear models, and their gradient.

Counterpart of ``_margins`` (``rkmh_tpu/ml/wabbit.py:171-174``), vmapped
over the classes (:219), and of its ``jax.grad`` (:195, :228):

    m[c, n] = sum_f W[c, idx[n, f]] * val[n, f]

with W [C, D] float32, idx [N, F] int32 in [0, D) and val [N, F] float32 in
wabbit's padded layout (idx 0, val 0), m [C, N].  On a CUDA tensor
``sparse_margins`` is a ``torch.autograd.Function`` over K12's two kernels
(``csrc/sparse_margin.cu``): the forward gathers, the backward adds val *
dm into dW with float atomics; nothing flows to idx or val.  On a CPU
tensor it is ``sparse_margins_plain``, the same sum under autograd.  As
with K4 and K5, the kernels do not check the indices: the caller keeps them
in range (``ml.wabbit.vectorize`` masks them to ``bits``).
"""

from __future__ import annotations

import torch

from rkmh_tpu_torch.ops import kernels


def sparse_margins_plain(W: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return (W[:, idx.long()] * val).sum(-1)


def _check(W, idx, val):
    if W.dtype != torch.float32 or W.dim() != 2:
        raise ValueError(f"sparse_margins takes W as 2-D float32, got {W.dtype} "
                         f"{tuple(W.shape)}")
    if (idx.dtype != torch.int32 or val.dtype != torch.float32 or idx.dim() != 2
            or idx.shape != val.shape):
        raise ValueError(f"sparse_margins takes idx [N, F] int32 and val [N, F] float32, got "
                         f"{idx.dtype} {tuple(idx.shape)} and {val.dtype} {tuple(val.shape)}")
    if not (W.device == idx.device == val.device):
        raise ValueError(f"sparse_margins: W, idx and val lie on {W.device}, {idx.device} "
                         f"and {val.device}")


def _margins_cuda(W: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """K12's forward: [C, N] margins."""
    _check(W, idx, val)
    W, idx, val = W.contiguous(), idx.contiguous(), val.contiguous()
    (C, D), (N, F) = W.shape, idx.shape
    m = torch.zeros((C, N), dtype=torch.float32, device=W.device)
    if C * N * F:
        kernels.SPARSE_MARGIN(W, idx, val, m, N, F, C, D)
    return m


def _margins_grad_cuda(dm: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                       D: int) -> torch.Tensor:
    """K12's backward: dW [C, D] for the margins' gradient dm [C, N]."""
    dm, idx, val = dm.contiguous(), idx.contiguous(), val.contiguous()
    (C, N), F = dm.shape, idx.shape[1]
    if dm.dtype != torch.float32 or idx.shape[0] != N:
        raise ValueError(f"sparse_margins backward takes dm [C, {idx.shape[0]}] float32, "
                         f"got {dm.dtype} {tuple(dm.shape)}")
    dW = torch.zeros((C, D), dtype=torch.float32, device=dm.device)
    if C * N * F:
        kernels.SPARSE_MARGIN_GRAD(dm, idx, val, dW, N, F, C, D)
    return dW


class SparseMargins(torch.autograd.Function):
    """K12's forward, with K12's backward as its gradient with respect to W."""

    @staticmethod
    def forward(ctx, W, idx, val):
        ctx.save_for_backward(idx, val)
        ctx.D = W.shape[1]
        return _margins_cuda(W, idx, val)

    @staticmethod
    def backward(ctx, dm):
        idx, val = ctx.saved_tensors
        return _margins_grad_cuda(dm, idx, val, ctx.D), None, None


def sparse_margins(W: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """[C, D] weights, [N, F] idx and val -> [C, N] margins, differentiable
    in W."""
    if W.device.type == "cuda":
        return SparseMargins.apply(W, idx, val)
    if W.device.type != "cpu":
        raise ValueError(f"no sparse_margins path for device {W.device}")
    return sparse_margins_plain(W, idx, val)
