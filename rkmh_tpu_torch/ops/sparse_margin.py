"""Sparse margins of the VW trainer's linear models, and their gradient.

Counterpart of ``_margins`` (``rkmh_tpu/ml/wabbit.py:171-174``), vmapped
over the classes (:219), and of its ``jax.grad`` (:195, :228):

    m[c, n]           = sum_f W[c, idx[n, f]] * val[n, f]
    dW[c, idx[n, f]] += val[n, f] * dm[c, n]

with W [C, D] float32, idx [N, F] int32 in [0, D) and val [N, F] float32 in
wabbit's padded layout (idx 0, val 0), m [C, N].

K12 (``csrc/sparse_margin.cu``) reads the weights class-minor, Wp [D, Cp]
(``pack_weights``: one index's C weights side by side, zero-padded to
``padded_classes(C)``), and its backward needs a ``MarginPlan``: the
entries whose val is not 0 in a stable order by (index, position), cut
into fixed-size chunks (``build_plan``, a library sort, once a training
run since idx and val do not change across passes).  The backward is an
ordered sum over the plan with no atomics, so the same inputs give the
same gradient bits on every run.

* ``sparse_margins_packed(Wp, idx, val, C, plan)``: the trainer's form,
  differentiable in Wp; without a plan the backward builds one;
* ``sparse_margins(W, idx, val)``: the [C, D] form, which packs W once a
  call (differentiably, so its gradient is [C, D]).

On CUDA tensors they launch K12's two kernels; on CPU tensors the plain
versions: ``margins_packed_plain`` (a gather and a sum) and
``margins_grad_plain`` (the plan's entries summed in the plan's order).
``sparse_margins_plain`` is the function in the JAX package's layout under
autograd, the reference the kernels are held against.  As with K4 and K5,
the kernels do not check the indices: the caller keeps them in range
(``ml.wabbit.vectorize`` masks them to ``bits``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as nnf

from rkmh_tpu_torch.ops import kernels

SPAN = 256      # entries a warp of the backward takes a step (csrc/sparse_margin.cu)
HEAD = 1 << 31  # the bit that marks a run's first entry in MarginPlan.rows


def padded_classes(C: int) -> int:
    """Wp's row width for C classes: C up to 2, else the next of 4, 8, 12
    and 16, past 16 a multiple of 16 (16-byte vectors; K12 sums up to 16
    classes a pass)."""
    if C <= 2:
        return C
    if C <= 8:
        return 4 if C <= 4 else 8
    return -(-C // 4) * 4 if C <= 16 else -(-C // 16) * 16


def pack_weights(W: torch.Tensor) -> torch.Tensor:
    """[C, D] weights -> Wp [D, padded_classes(C)], the padding 0;
    differentiable."""
    C = W.shape[0]
    return nnf.pad(W.t(), (0, padded_classes(C) - C)).contiguous()


def unpack_weights(Wp: torch.Tensor, C: int) -> torch.Tensor:
    """Wp [D, Cp] -> the [C, D] weights, a view."""
    return Wp[:, :C].t()


@dataclass
class MarginPlan:
    """idx and val [N, F] sorted for K12's backward.

    ``rows`` and ``vals`` [E]: the E entries whose val is not 0, ordered by
    (index, position n * F + f); rows[e] is the example n, with ``HEAD``
    set (the int32 sign bit) on the first entry of each run of equal
    indices.  ``keys`` [U]: each run's index.  The order is cut into
    chunks of ``chunk`` entries: ``chunk_run`` is the run of each chunk's
    first entry, ``chunk_slot`` the first of its partial slots (a chunk
    leaves a partial sum for a run that began in an earlier chunk and for
    one that goes on past its end).  ``cross_keys`` [X] are the runs that
    cross a chunk's edge; run i's partials are slots
    [cross_slot[i], cross_slot[i + 1]), one a chunk it touches, of
    ``slots`` in all (a host int: the backward allocates them without a
    sync, so it can be captured in a CUDA graph).  ``touched`` [ceil(D /
    32)] int32: bit i % 32 of word i // 32 is set where index i is a key
    (the backward writes zeros to the other rows)."""

    N: int
    F: int
    D: int
    chunk: int
    rows: torch.Tensor
    vals: torch.Tensor
    keys: torch.Tensor
    chunk_run: torch.Tensor
    chunk_slot: torch.Tensor
    cross_keys: torch.Tensor
    cross_slot: torch.Tensor
    slots: int
    touched: torch.Tensor

    @property
    def entries(self) -> int:
        return self.rows.numel()


def default_chunk(E: int) -> int:
    """Entries a warp of the backward takes: one step (SPAN) up to 2**20
    entries, where the warps are few and each adds latency; 4 steps past
    it, where fewer chunks leave fewer partial sums."""
    return SPAN if E <= 1 << 20 else 4 * SPAN


def build_plan(idx: torch.Tensor, val: torch.Tensor, D: int, chunk: int | None = None
               ) -> MarginPlan:
    """The plan of idx and val [N, F] (int32, float32) for weights of D
    rows, on their device; the sort is ``torch.sort(stable=True)``;
    ``chunk``: default_chunk of the entries."""
    _check_inputs(idx, val)
    N, F = idx.shape
    dev = idx.device
    flat_val = val.reshape(-1)
    pos = torch.nonzero(flat_val != 0).squeeze(1)
    skey, perm = torch.sort(idx.reshape(-1)[pos], stable=True)
    pos = pos[perm]
    E = pos.numel()
    chunk = default_chunk(E) if chunk is None else chunk
    if chunk <= 0:
        raise ValueError(f"a plan's chunk must be positive, got {chunk}")
    head = torch.ones(E, dtype=torch.bool, device=dev)
    head[1:] = skey[1:] != skey[:-1]
    rows = (torch.div(pos, F, rounding_mode="floor") - head.long() * HEAD).to(torch.int32)
    starts = torch.nonzero(head).squeeze(1)
    run_of = torch.cumsum(head, 0) - 1
    lo = torch.arange(0, E, chunk, device=dev)
    hi = torch.clamp(lo + chunk, max=E)
    lo_head = head[lo]
    hi_head = torch.ones_like(lo_head)
    inner = hi < E
    hi_head[inner] = head[hi[inner]]
    has_head = run_of[hi - 1] > run_of[lo] - lo_head.long()
    nslots = (~lo_head).long() + ((~hi_head) & has_head).long()
    chunk_slot = torch.cumsum(nslots, 0) - nslots
    ends = torch.cat([starts[1:], starts.new_full((min(E, 1),), E)])
    first_chunk = torch.div(starts, chunk, rounding_mode="floor")
    last_chunk = torch.div(ends - 1, chunk, rounding_mode="floor")
    cross = last_chunk > first_chunk
    span = (last_chunk - first_chunk + 1)[cross]
    cross_slot = torch.cat([torch.zeros(1, dtype=span.dtype, device=dev), torch.cumsum(span, 0)])
    keys = skey[starts]
    bits = torch.zeros(-(-D // 32) * 32, dtype=torch.int64, device=dev)
    bits[keys.long()] = 1
    words = (bits.view(-1, 32) << torch.arange(32, device=dev)).sum(1)
    touched = (words - (words >= 1 << 31).long() * (1 << 32)).to(torch.int32)
    return MarginPlan(N, F, D, chunk, rows, flat_val[pos].contiguous(), keys.to(torch.int32),
                      run_of[lo].to(torch.int32), chunk_slot.to(torch.int32),
                      keys[cross].to(torch.int32), cross_slot.to(torch.int32),
                      int(cross_slot[-1]), touched)


def sparse_margins_plain(W: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """The function in the JAX package's layout: W [C, D] -> [C, N]."""
    return (W[:, idx.long()] * val).sum(-1)


def margins_packed_plain(Wp: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                         C: int) -> torch.Tensor:
    """K12's forward, plain: Wp [D, Cp] -> [C, N]."""
    return (Wp[idx.long()] * val[..., None]).sum(1)[:, :C].t()


def margins_grad_plain(dm: torch.Tensor, plan: MarginPlan, Cp: int) -> torch.Tensor:
    """K12's backward, plain: dWp [D, Cp] for the margins' gradient dm
    [C, N], each run of the plan summed in the plan's order."""
    dmT = nnf.pad(dm.t(), (0, Cp - dm.shape[0]))
    n = (plan.rows & (HEAD - 1)).long()
    run_of = torch.cumsum(plan.rows < 0, 0) - 1
    sums = torch.zeros((plan.keys.numel(), Cp), dtype=torch.float32, device=dm.device)
    sums.index_add_(0, run_of, plan.vals[:, None] * dmT[n])
    dW = torch.zeros((plan.D, Cp), dtype=torch.float32, device=dm.device)
    dW[plan.keys.long()] = sums
    return dW


def _check_inputs(idx, val):
    if (idx.dtype != torch.int32 or val.dtype != torch.float32 or idx.dim() != 2
            or idx.shape != val.shape):
        raise ValueError(f"sparse_margins takes idx [N, F] int32 and val [N, F] float32, got "
                         f"{idx.dtype} {tuple(idx.shape)} and {val.dtype} {tuple(val.shape)}")
    if idx.device != val.device:
        raise ValueError(f"sparse_margins: idx and val lie on {idx.device} and {val.device}")


def _check(Wp, idx, val, C):
    _check_inputs(idx, val)
    if Wp.dtype != torch.float32 or Wp.dim() != 2 or Wp.shape[1] != padded_classes(C):
        raise ValueError(f"sparse_margins takes Wp as [D, {padded_classes(C)}] float32 for "
                         f"{C} classes, got {Wp.dtype} {tuple(Wp.shape)}")
    if Wp.device != idx.device:
        raise ValueError(f"sparse_margins: Wp, idx and val lie on {Wp.device}, {idx.device} "
                         f"and {val.device}")


def _margins_cuda(Wp: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                  C: int) -> torch.Tensor:
    """K12's forward: [C, N] margins of the packed weights Wp [D, Cp]."""
    _check(Wp, idx, val, C)
    Wp, idx, val = Wp.contiguous(), idx.contiguous(), val.contiguous()
    (N, F), Cp = idx.shape, Wp.shape[1]
    m = torch.zeros((C, N), dtype=torch.float32, device=Wp.device)
    if C * N * F:
        kernels.SPARSE_MARGIN(Wp, idx, val, m, N, F, C, Cp)
    return m


def _margins_grad_cuda(dm: torch.Tensor, plan: MarginPlan) -> torch.Tensor:
    """K12's backward: dWp [D, Cp] for the margins' gradient dm [C, N]."""
    C, N = dm.shape
    if dm.dtype != torch.float32 or N != plan.N:
        raise ValueError(f"sparse_margins backward takes dm [C, {plan.N}] float32, got "
                         f"{dm.dtype} {tuple(dm.shape)}")
    Cp = padded_classes(C)
    if N == 0:
        return torch.zeros((plan.D, Cp), dtype=torch.float32, device=dm.device)
    dm = dm.contiguous()
    dmT = torch.empty((N, Cp), dtype=torch.float32, device=dm.device)
    dW = torch.empty((plan.D, Cp), dtype=torch.float32, device=dm.device)
    part = torch.empty((plan.slots, Cp), dtype=torch.float32, device=dm.device)
    kernels.SPARSE_MARGIN_GRAD(dm, plan.rows, plan.vals, plan.keys, plan.chunk_run,
                               plan.chunk_slot, plan.cross_keys, plan.cross_slot, plan.touched,
                               dmT, dW, part, N, C, plan.D, plan.entries, plan.chunk,
                               plan.chunk_run.numel(), plan.cross_keys.numel(), Cp)
    return dW


class SparseMargins(torch.autograd.Function):
    """K12's forward (on the CPU its plain version), with K12's backward
    over the plan as its gradient with respect to Wp."""

    @staticmethod
    def forward(ctx, Wp, idx, val, C, plan):
        ctx.save_for_backward(idx, val)
        ctx.D, ctx.plan = Wp.shape[0], plan
        if Wp.device.type == "cuda":
            return _margins_cuda(Wp, idx, val, C)
        if Wp.device.type != "cpu":
            raise ValueError(f"no sparse_margins path for device {Wp.device}")
        _check(Wp, idx, val, C)
        return margins_packed_plain(Wp, idx, val, C)

    @staticmethod
    def backward(ctx, dm):
        idx, val = ctx.saved_tensors
        plan = ctx.plan if ctx.plan is not None else build_plan(idx, val, ctx.D)
        dm = dm.contiguous()
        if dm.device.type == "cuda":
            return _margins_grad_cuda(dm, plan), None, None, None, None
        return margins_grad_plain(dm, plan, padded_classes(dm.shape[0])), None, None, None, None


def sparse_margins_packed(Wp: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, C: int,
                          plan: MarginPlan | None = None) -> torch.Tensor:
    """Packed weights Wp [D, padded_classes(C)], [N, F] idx and val -> [C, N]
    margins, differentiable in Wp; ``plan`` (``build_plan`` of the same idx
    and val) serves the backward, which builds one without it."""
    if plan is not None and (plan.N, plan.F, plan.D) != (*idx.shape, Wp.shape[0]):
        raise ValueError(f"a plan of [{plan.N}, {plan.F}] entries over {plan.D} weights does "
                         f"not fit idx {tuple(idx.shape)} and Wp {tuple(Wp.shape)}")
    return SparseMargins.apply(Wp, idx, val, C, plan)


def sparse_margins(W: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """[C, D] weights, [N, F] idx and val -> [C, N] margins, differentiable
    in W (packed once a call)."""
    if W.dtype != torch.float32 or W.dim() != 2:
        raise ValueError(f"sparse_margins takes W as 2-D float32, got {W.dtype} "
                         f"{tuple(W.shape)}")
    return sparse_margins_packed(pack_weights(W), idx, val, W.shape[0])
