"""K12's class-minor weights and its backward's plan (``ops/sparse_margin``)
on the CPU, against the JAX package's ``_margins`` and its ``jax.grad``.

Inputs are made from a seed with numpy (``bench/margin_inputs``).
Tolerances, and why:
* the plan's arrays, the layout round trip, the model files and any sum of
  small integers: equal (integers up to 2**24 add exactly in float32, so
  the order of a sum cannot show; that is how the chunked reduction below
  is held to the plain backward bit for bit);
* margins and gradients of normal floats against JAX: 1e-5 of the sum of
  |terms| + 1e-6 (float32 sums in another order; ``bench/margin_inputs``
  says why), the tolerance the card's kernels are held to.

``_chunked_backward`` repeats what K12's backward kernels do with a plan
(``csrc/sparse_margin.cu``: a warp a chunk, 8 entries a lane, the open
run's state across steps, partial slots, pass 2), lane by lane in Python,
so that the bookkeeping the card runs is tested here too.
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.ml import wabbit as jw
from rkmh_tpu_torch import convert
from rkmh_tpu_torch.bench.margin_inputs import _abs_terms, edge_cases, margin_case
from rkmh_tpu_torch.ml import wabbit as tw
from rkmh_tpu_torch.ops.sparse_margin import (
    HEAD,
    SPAN,
    build_plan,
    margins_grad_plain,
    margins_packed_plain,
    pack_weights,
    padded_classes,
    sparse_margins,
    sparse_margins_packed,
    unpack_weights,
)

CASES = ["random", "edges", "one slot", "N = 1", "all padding"]


def _case(name, bits=14):
    if name == "random":
        return margin_case(70, 33, 5, bits, 5, "cpu")
    return edge_cases("cpu", bits)[name]


def _small_ints(rng, shape):
    return torch.from_numpy(rng.integers(-8, 9, size=shape).astype(np.float32))


def _jax_margins_and_grad(W, idx, val, dm):
    Wj, idxj, valj, dmj = (jnp.asarray(t.numpy()) for t in (W, idx, val, dm))

    def margins_all(Wj):
        return jax.vmap(lambda w: jw._margins(w, idxj, valj))(Wj)

    m = np.asarray(margins_all(Wj))
    g = np.asarray(jax.grad(lambda Wj: jnp.sum(margins_all(Wj) * dmj))(Wj))
    return m, g


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_plan_leaves_out_padding_in_a_stable_order(name):
    """rows and vals are the entries whose val is not 0, stably sorted by
    index (numpy's stable argsort of the same entries), HEAD on the first
    entry of each run, keys each run's index, and the touched bitmap has
    the keys' bits set and no other."""
    W, idx, val, _ = _case(name)
    plan = build_plan(idx, val, W.shape[1])
    i, v = idx.numpy().reshape(-1), val.numpy().reshape(-1)
    pos = np.flatnonzero(v != 0)
    order = pos[np.argsort(i[pos], kind="stable")]
    key = i[order]
    head = np.r_[True, key[1:] != key[:-1]] if key.size else np.zeros(0, bool)
    want_rows = (order // idx.shape[1]).astype(np.int64) - head * HEAD
    assert plan.entries == int((v != 0).sum())
    assert plan.rows.dtype == torch.int32 and np.array_equal(plan.rows.numpy(), want_rows)
    assert np.array_equal(plan.vals.numpy(), v[order]) and not (plan.vals == 0).any()
    assert np.array_equal(plan.keys.numpy(), key[head])
    bits = np.unpackbits(plan.touched.numpy().view(np.uint8), bitorder="little")
    assert plan.touched.dtype == torch.int32 and bits.size == -(-W.shape[1] // 32) * 32
    assert np.array_equal(np.flatnonzero(bits), key[head])  # the rows the backward writes


@pytest.mark.parametrize("chunk", [1, 3, 8, 256, 512])
@pytest.mark.parametrize("name", CASES)
def test_plan_chunks_hold_each_entry_once(name, chunk):
    """The chunks tile [0, E) in order, each chunk's run is its first
    entry's, and the partial slots add up: one a chunk each crossing run
    touches, in the order the chunks take them."""
    W, idx, val, _ = _case(name)
    plan = build_plan(idx, val, W.shape[1], chunk=chunk)
    E = plan.entries
    n_chunks = plan.chunk_run.numel()
    assert n_chunks == -(-E // chunk)
    covered = np.concatenate([np.arange(j * chunk, min(j * chunk + chunk, E))
                              for j in range(n_chunks)] or [np.zeros(0, int)])
    assert np.array_equal(covered, np.arange(E))
    run_of = np.cumsum(plan.rows.numpy() < 0) - 1
    assert np.array_equal(plan.chunk_run.numpy(), run_of[::chunk][:n_chunks])
    starts = np.flatnonzero(plan.rows.numpy() < 0)
    ends = np.r_[starts[1:], E]
    touched = ends // chunk - starts // chunk + (ends % chunk != 0)  # chunks a run touches
    cross = touched > 1
    assert np.array_equal(plan.cross_keys.numpy(), plan.keys.numpy()[cross])
    assert np.array_equal(np.diff(plan.cross_slot.numpy()), touched[cross])
    assert plan.slots == int(touched[cross].sum())
    assert np.all(np.diff(plan.chunk_slot.numpy()) >= 0)
    if name == "one slot":  # one run over every entry, cut into the chunks
        assert plan.keys.tolist() == [77] and plan.slots == (n_chunks if n_chunks > 1 else 0)
    if name == "all padding":
        assert E == 0 and plan.keys.numel() == 0 and plan.slots == 0


def test_default_chunk():
    """One warp step (SPAN entries) a chunk up to 2**20 entries, four past
    it; a plan built without a chunk takes it."""
    from rkmh_tpu_torch.ops.sparse_margin import default_chunk

    assert [default_chunk(e) for e in (0, 1, 1 << 20, (1 << 20) + 1)] == \
        [SPAN, SPAN, SPAN, 4 * SPAN]
    W, idx, val, _ = _case("one slot")
    assert build_plan(idx, val, W.shape[1]).chunk == SPAN


def _chunked_backward(plan, dmT):
    """K12's two backward passes over the plan (csrc/sparse_margin.cu),
    lane by lane: dWp [D, Cp]."""
    NONE, PREV, HERE = range(3)
    rows, vals = plan.rows.numpy(), plan.vals.numpy()
    keys, E, Cp = plan.keys.numpy(), plan.entries, dmT.shape[1]
    dW = np.zeros((plan.D, Cp), np.float32)
    part = np.full((plan.slots, Cp), np.nan, np.float32)
    for j in range(plan.chunk_run.numel()):
        lo = j * plan.chunk
        hi = min(lo + plan.chunk, E)
        lo_head, hi_head = rows[lo] < 0, hi == E or rows[hi] < 0
        state = NONE if lo_head else PREV
        run = int(plan.chunk_run[j]) - int(lo_head)
        slot = int(plan.chunk_slot[j])
        carry = np.zeros(Cp, np.float32)
        for w0 in range(lo, hi, SPAN):
            lanes = []  # (seen, first, acc, heads before the lane)
            before = 0
            for lane in range(32):
                e0 = w0 + 8 * lane
                seen, first, acc = False, np.zeros(Cp, np.float32), np.zeros(Cp, np.float32)
                my_run = run + before
                heads = 0
                for e in range(e0, min(e0 + 8, hi)):
                    if rows[e] < 0:
                        heads += 1
                        if seen:
                            dW[keys[my_run]] = acc
                        else:
                            first, seen = acc, True
                        acc = np.zeros(Cp, np.float32)
                        my_run += 1
                    acc = acc + vals[e] * dmT[rows[e] & (HEAD - 1)]
                lanes.append((seen, first, acc, before))
                before += heads
            running = carry  # the open run's sum, lane by lane
            any_seen = False
            for seen, first, acc, before_l in lanes:
                if seen:
                    open_ = HERE if any_seen else state
                    if open_ != NONE:
                        total = running + first
                        if open_ == HERE:
                            dW[keys[run + before_l]] = total
                        else:
                            part[slot] = total
                    running = acc
                    any_seen = True
                else:
                    running = running + acc
            if any_seen:
                slot += state == PREV
                state = HERE
            carry = running
            run += before
        if hi_head and state == HERE:
            dW[keys[run]] = carry
        else:
            part[slot] = carry
    for i in range(plan.cross_keys.numel()):
        s0, s1 = int(plan.cross_slot[i]), int(plan.cross_slot[i + 1])
        dW[plan.cross_keys[i]] = part[s0:s1].sum(0)
    assert not np.isnan(part).any()  # every slot written
    return dW


@pytest.mark.parametrize("chunk", [256, 512])
@pytest.mark.parametrize("name", [*CASES, "long runs"])
def test_chunked_backward_equals_the_plain_backward(name, chunk):
    """K12's chunked reduction (``_chunked_backward``) and the plain
    backward over the plan, on small integers: equal, bit for bit."""
    rng = np.random.default_rng(7)
    if name == "long runs":  # ~1,000 entries a run over 8 indices: runs span chunks
        W, idx, val, dm = margin_case(600, 20, 3, 10, 8, "cpu")
        idx = torch.from_numpy(rng.integers(0, 8, size=idx.shape).astype(np.int32))
    else:
        W, idx, val, dm = _case(name)
    val = torch.where(val != 0, _small_ints(rng, val.shape), val)
    dm = _small_ints(rng, dm.shape)
    C, D = W.shape
    Cp = padded_classes(C)
    plan = build_plan(idx, val, D, chunk=chunk)
    want = margins_grad_plain(dm, plan, Cp).numpy()
    dmT = np.zeros((dm.shape[1], Cp), np.float32)
    dmT[:, :C] = dm.numpy().T
    got = _chunked_backward(plan, dmT)
    assert np.array_equal(got, want)
    exact = np.zeros((D, Cp), np.float32)
    i, v = idx.numpy(), val.numpy()
    for n in range(i.shape[0]):
        for f in range(i.shape[1]):
            exact[i[n, f], :C] += v[n, f] * dm.numpy()[:, n]
    assert np.array_equal(want, exact)
    if name == "long runs":
        assert plan.cross_keys.numel() > 0 and plan.slots > 2 * plan.cross_keys.numel()


# ---------------------------------------------------------------------------
# the plain versions against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [1, 2, 5, 10, 17])
@pytest.mark.parametrize("name", ["random", "edges", "N = 1"])
def test_plain_backward_over_the_plan_matches_jax_grad(name, C):
    """margins_grad_plain over the plan and margins_packed_plain against
    ``_margins`` vmapped over the classes and its jax.grad: within 1e-5 of
    the sum of |terms| + 1e-6 (float32 sums in another order)."""
    W, idx, val, _ = _case(name)
    rng = np.random.default_rng(C)
    W = torch.from_numpy(rng.standard_normal((C, W.shape[1])).astype(np.float32))
    dm = torch.from_numpy(rng.standard_normal((C, idx.shape[0])).astype(np.float32))
    want_m, want_g = _jax_margins_and_grad(W, idx, val, dm)
    Wp = pack_weights(W)
    plan = build_plan(idx, val, W.shape[1])
    got_m = margins_packed_plain(Wp, idx, val, C).numpy()
    got_g = unpack_weights(margins_grad_plain(dm, plan, padded_classes(C)), C).numpy()
    bound_m, bound_g = (b.numpy() for b in _abs_terms(W, idx, val, dm))
    assert got_m.shape == (C, idx.shape[0]) and got_g.shape == (C, W.shape[1])
    assert np.all(np.abs(got_m - want_m) <= 1e-5 * bound_m + 1e-6)
    assert np.all(np.abs(got_g - want_g) <= 1e-5 * bound_g + 1e-6)
    assert np.count_nonzero(want_g) > 0


@pytest.mark.parametrize("C", [1, 3, 10])
def test_margins_under_autograd_with_and_without_a_plan(C):
    """sparse_margins_packed on the CPU (the plain versions as an autograd
    Function): the same gradient bits with a prebuilt plan, with one built
    in the backward and through sparse_margins' [C, D] form; the padding's
    gradient 0."""
    W, idx, val, _ = margin_case(90, 21, C, 9, C, "cpu")
    dm = torch.from_numpy(np.random.default_rng(C).standard_normal((C, 90)).astype(np.float32))
    grads = []
    for plan in (build_plan(idx, val, W.shape[1]), None):
        Wp = pack_weights(W).requires_grad_(True)
        (sparse_margins_packed(Wp, idx, val, C, plan) * dm).sum().backward()
        grads.append(Wp.grad)
    Wc = W.clone().requires_grad_(True)
    (sparse_margins(Wc, idx, val) * dm).sum().backward()
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(unpack_weights(grads[0], C), Wc.grad)
    assert not grads[0][:, C:].any()
    with pytest.raises(ValueError, match="does not fit"):
        sparse_margins_packed(pack_weights(W), idx[:5], val[:5], C, build_plan(idx, val, 512))


# ---------------------------------------------------------------------------
# the weights' layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [1, 2, 3, 10, 17])
def test_weights_layout_round_trip_is_bit_equal(C, tmp_path):
    """The JAX package's [C, D] (or [D]) weights -> the port's Wp [D, Cp]
    -> back: equal bits, the padding 0, and save_model writes the same npz
    members as rkmh_tpu's save_model of the original array."""
    rng = np.random.default_rng(C)
    W = rng.standard_normal((C, 1 << 7)).astype(np.float32)
    W[0, 3] = -0.0
    kind = "binary" if C == 1 else "ect"
    weights = W[0] if kind == "binary" else W
    model = convert.wabbit_from_numpy(kind, weights, 7, ["vv"], {"s"}, "cpu")
    assert model.Wp.shape == (1 << 7, padded_classes(C)) and not model.Wp[:, C:].any()
    assert torch.equal(model.Wp[:, :C], torch.from_numpy(W).t())
    back = model.weights_numpy()
    assert back.dtype == np.float32 and back.flags.c_contiguous
    assert back.tobytes() == weights.tobytes()
    assert torch.equal(model.W, torch.from_numpy(W))
    paths = [str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")]
    jw.save_model(paths[0], kind, weights, 7, ["vv"], {"s"})
    tw.save_model(paths[1], kind, back, 7, ["vv"], {"s"})
    members = []
    for path in paths:
        with zipfile.ZipFile(path) as z:
            members.append({name: z.read(name) for name in z.namelist()})
    assert members[0] == members[1]


def test_training_keeps_the_padding_at_zero():
    """A 10-class model trains in the packed layout: its two padding
    columns stay 0 through Adam, and the result is what train_multiclass
    returns."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 1 << 9, size=(40, 12)).astype(np.int32)
    val = rng.standard_normal((40, 12)).astype(np.float32)
    y = rng.integers(1, 11, size=40)
    Y = -np.ones((10, 40), np.float32)
    Y[y - 1, np.arange(40)] = 1
    model = tw.WabbitModel("ect", torch.zeros((10, 1 << 9)), 9)
    idx_t, val_t, Y_t = map(torch.from_numpy, (idx, val, Y))
    plan = build_plan(idx_t, val_t, 1 << 9)
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    for _ in range(5):
        opt.zero_grad(set_to_none=True)
        model.loss(idx_t, val_t, Y_t, plan).backward()
        opt.step()
    assert model.Wp.shape == (1 << 9, 12) and not model.Wp[:, 10:].any()
    want = tw.train_multiclass(idx, val, y, 10, 9, 5, 0.05, device="cpu")
    assert np.array_equal(model.weights_numpy(), want)
