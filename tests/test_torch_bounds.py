"""The kernels' bounds (rkmh_tpu_torch/bench/bounds.py) on the CPU.

The probe statistics must agree with the plain probe: the reference bits
of the hits add up to the plain counts, and only the table sectors that
probes reach are counted.  Inputs are made from a seed with numpy.
Tolerance: none (integer counts; the bound is bytes over a fixed rate).
"""

import argparse
from pathlib import Path

import numpy as np
import pytest
import torch

from rkmh_tpu_torch.bench import bounds, kernel_ab
from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.lookup import build_panel_table, build_set_table
from rkmh_tpu_torch.ops.probe import _plain_counts
from rkmh_tpu_torch.ops.set_probe import set_probe_plain
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch


def _panel(seed, R=40):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=200, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    sk = np.sort(rng.choice(pool, size=(R, 64)).view(np.uint64), axis=1)
    table = torch.from_numpy(build_panel_table(sk).table.view(np.int32))
    rows = rng.choice(np.concatenate([pool, rng.integers(1, 2**63, 100)]), size=(30, 50))
    rows[rng.random(rows.shape) < 0.1] = 0
    return table, torch.from_numpy(rows), pool, rng


def test_bound_is_bytes_over_the_memory_rate():
    assert bounds.bound_ms(3.35e9) == pytest.approx(1.0)
    x = torch.zeros((4, 5), dtype=torch.int64)
    assert bounds.tensor_bytes(x, None, x[:, 0].to(torch.int32)) == 160 + 16
    assert bounds.sector_bytes(torch.tensor([0, 4, 31, 32, 95, 1000])) == 4 * 32


@pytest.mark.parametrize("sorted_rows", [False, True])
def test_panel_probe_stats_agree_with_the_plain_probe(sorted_rows):
    table, rows, _, _ = _panel(3)
    lens = None
    if sorted_rows:
        rows, lens = bottom_s_sketch(rows, 20)
    st = bounds.panel_probe_stats(rows, lens, table, 40)
    counts, _ = _plain_counts(rows, lens, table, 40)
    assert st.mask_bits == int(counts.sum()) > 0
    assert 0 < st.hits <= st.probes
    assert st.probes == (int((rows != 0).sum()) if lens is None else int(lens.sum()))
    assert st.table_bytes % 32 == 0 and 0 < st.table_bytes <= table.numel() * 4
    assert bounds.read_row_bytes(rows, lens) == (
        rows.numel() * 8 if lens is None else int(lens.sum()) * 8)


def test_set_probe_stats_probe_run_starts_only():
    _, _, pool, rng = _panel(4)
    T, U = 12, 3
    table = torch.from_numpy(build_set_table([rng.choice(pool, 60) for _ in range(T + U)],
                                             num_refs=T + U).table.view(np.int32))
    rows, lens = bottom_s_sketch(torch.from_numpy(rng.choice(pool, size=(6, 120))), 120)
    st = bounds.set_probe_stats(rows, lens, table, T + U)
    assert st.probes == sum(len(torch.unique(r[:n])) for r, n in zip(rows, lens))
    want = set_probe_plain(rows, lens, table, T, U)
    assert st.hits >= int(want[:, 1].max()) > 0


def test_kernel_ab_variant_argument():
    assert kernel_ab.variant("n_slots=_scratch/v/n") == ("n_slots", Path("_scratch/v/n"))
    for bad in ("n_slots", "=dir", "n_slots=", "old=dir", "new=dir"):
        with pytest.raises(argparse.ArgumentTypeError):
            kernel_ab.variant(bad)


def test_kernel_ab_times_a_library_only_on_its_kernels():
    class PanelProbeOnly:  # a library built from panel_probe.cu alone
        rkmh_panel_probe = rkmh_panel_probe_filter = object()

    lib = PanelProbeOnly()
    assert kernel_ab.has_kernels(lib, (kernels.PANEL_PROBE, kernels.PANEL_PROBE_FILTER))
    assert not kernel_ab.has_kernels(lib, (kernels.WINDOW_HASH,))
    assert not kernel_ab.has_kernels(lib, (kernels.WINDOW_HASH, kernels.PANEL_PROBE))
