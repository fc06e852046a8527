"""The panel probe past 8,192 references (K11's function) vs the JAX chain.

At R = 8,193 and 9,000 the port's plain versions, ``panel_probe_plain``
and ``panel_probe_filter_plain`` (what K11 must match on the card), are
held against the JAX package's ``lookup_intersection_counts_masked`` then
``argmax_stream`` / ``argmax_filter``, on a table the JAX host builder
made, in both row modes: raw rows with prefix-equality ranks, and sorted
sketches with lens.  The inputs (``bench/wide_inputs.straddling_panel``,
made from a seed) put ties and maxima on both sides of reference 8,192
and hold duplicate-heavy rows.  Also: what the K11 wrapper refuses.
Tolerance: none, every output is an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.classify import engine as jengine
from rkmh_tpu.ops import intersect as jintersect
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu_torch.bench.wide_inputs import PAST, straddling_panel
from rkmh_tpu_torch.ops.intersect import prefix_eq_ranks
from rkmh_tpu_torch.ops.probe import (
    MAX_REFS,
    _panel_probe_cuda,
    _panel_probe_filter_cuda,
    pack_filter_result,
    pack_result,
    panel_probe_filter_plain,
    panel_probe_plain,
)
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch


@pytest.fixture(scope="module", params=[PAST + 1, 9000])
def wide(request):
    R = request.param
    ref_sk, ref_lens, reads, set_lens = straddling_panel(R, seed=R, n_reads=16)
    table = jlookup.build_panel_table(ref_sk.view(np.uint64), ref_lens).table
    return R, table, torch.from_numpy(reads), set_lens


def _jax_counts(rows, lens, table, R):
    """The JAX chain's [B, R] counts and sketch lengths in either row mode."""
    x = rows.numpy().view(np.uint64)
    if lens is None:
        valid = x != 0
        occ = prefix_eq_ranks(rows).numpy().astype(np.int32)
        sk_lens = valid.sum(axis=1).astype(np.int32)
    else:
        n = x.shape[1]
        sk_lens = lens.numpy()
        valid = (np.arange(n)[None, :] < sk_lens[:, None]) & (x != np.uint64(2**64 - 1))
        occ = np.asarray(jintersect.occ_ranks(jnp.asarray(x)))
    counts = jlookup.lookup_intersection_counts_masked(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(occ), (jnp.asarray(table),), R)
    return counts, jnp.asarray(sk_lens)


@pytest.mark.parametrize("mode", ["raw", "sorted"])
def test_wide_probe_plain_matches_the_jax_chain(wide, mode):
    R, table, raw, set_lens = wide
    rows, lens = (raw, None) if mode == "raw" else bottom_s_sketch(raw, 32)
    t = torch.from_numpy(table.view(np.int32))
    counts, sk_lens = _jax_counts(rows, lens, table, R)
    ref_lens = torch.from_numpy(set_lens)
    for md, mm in ((0, -1), (1, 9), (-1, 0)):
        want = pack_result(*(torch.from_numpy(np.asarray(a)) for a in
                             jengine.argmax_stream(counts, md, mm, sk_lens)))
        got = panel_probe_plain(rows, lens, t, R, md, mm)
        assert torch.equal(got, want), (md, mm)
        want_f = pack_filter_result(*(torch.from_numpy(np.asarray(a)) for a in
                                      jengine.argmax_filter(counts, md, mm, sk_lens,
                                                            jnp.asarray(set_lens))))
        assert torch.equal(panel_probe_filter_plain(rows, lens, t, R, ref_lens, md, mm), want_f)
    best, shared = got[0].tolist(), got[1].tolist()
    # the straddling cases (bench/wide_inputs): first max below, first max
    # past 8,192, a tie across it; X's three ranks hit
    assert best[:3] == [100, PAST, PAST - 2] and shared[:3] == [10, 12, 8]
    assert shared[5] == 3


def test_wide_probe_wrapper_refuses_what_it_cannot_take():
    R = MAX_REFS + 1
    Wm = -(-R // 32)
    table = torch.zeros((4, 2 * (3 + Wm)), dtype=torch.int32)
    rows = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="counters"):  # K2 forced past its counters
        _panel_probe_cuda(rows, None, table, R, 0, -1, wide=False)
    with pytest.raises(ValueError, match="not fit"):  # a raw row of 15,000 hashes
        _panel_probe_cuda(torch.zeros((2, 15000), dtype=torch.int64), None, table, R, 0, -1)
    with pytest.raises(ValueError, match="table width"):  # too few mask words
        _panel_probe_cuda(rows, None, torch.zeros((4, 2 * (3 + Wm - 1)), dtype=torch.int32),
                          R, 0, -1)
    with pytest.raises(ValueError, match="ref_lens"):
        _panel_probe_filter_cuda(rows, None, table, R, torch.zeros(3, dtype=torch.int32), 0, -1)
