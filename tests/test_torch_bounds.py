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


def test_probe_stats_count_the_packed_layout_too():
    from rkmh_tpu_torch.ops.set_probe import pack_set_table

    _, _, pool, rng = _panel(6)
    T, U = 12, 3
    table = torch.from_numpy(build_set_table([rng.choice(pool, 60) for _ in range(T + U)],
                                             num_refs=T + U).table.view(np.int32))
    rows, lens = bottom_s_sketch(torch.from_numpy(rng.choice(pool, size=(6, 120))), 120)
    st = bounds.set_probe_stats(rows, lens, table, T + U)
    assert 0 < st.hit_slots <= st.hits and 0 < st.buckets <= min(st.probes, table.shape[0])
    packed = pack_set_table(table, T + U)
    # one key record per bucket and one slot record per entry hit, in whole sectors
    key_bytes = -(-4 * packed.keys.shape[1] // 32) * 32
    assert bounds.packed_set_table_bytes(st, packed) == st.buckets * key_bytes + st.hit_slots * 32


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


def test_kernel_ab_takes_the_counter_and_set_probe_sources(tmp_path):
    assert set(kernel_ab.SOURCES) == {"window_hash.cu", "panel_probe.cu", "counter.cu",
                                      "set_probe.cu", "lut_gather.cu", "hashmap.cu",
                                      "call_scan.cu"}
    assert kernel_ab.held_sources(tmp_path) == []
    for name in ("set_probe.cu", "counter.cu", "notes.txt"):
        (tmp_path / name).write_text("")
    assert kernel_ab.held_sources(tmp_path) == [tmp_path / "counter.cu",
                                                tmp_path / "set_probe.cu"]
    assert kernel_ab.DIAG_SOURCE.exists() and kernel_ab.DIAG_SOURCE.parent.name == "bench"
    assert kernel_ab.DIAG_SOURCE not in kernels.sources()  # not part of the port's library


class _OldCounters:  # a library built from an old counter.cu and lut_gather.cu
    rkmh_counter_add = rkmh_counter_mask = rkmh_lut_gather_rows = staticmethod(lambda *a: 0)


def test_kernel_ab_calls_an_old_library_by_its_old_entry_points():
    lib = _OldCounters()
    new = [kern._fn for kern in kernel_ab.SWAPPED]
    with kernel_ab.using(lib):
        # the wrappers launch the old library's entry points, which have
        # this checkout's parameter lists; kernels it lacks keep theirs
        assert kernels.COUNTER_ADD._fn is not None and kernels.COUNTER_MASK._fn is not None
        assert kernels.LUT_GATHER_ROWS._fn is not None
        assert kernels.SET_PROBE._fn is new[kernel_ab.SWAPPED.index(kernels.SET_PROBE)]
    assert [kern._fn for kern in kernel_ab.SWAPPED] == new


def test_kernel_ab_reads_which_entry_points_changed(tmp_path):
    from rkmh_tpu_torch.ops import kernels as k

    for name in ("counter.cu", "lut_gather.cu"):
        (tmp_path / name).write_text((k.CSRC / name).read_text())
    assert kernel_ab.changed_entry_points(tmp_path) == frozenset()
    assert kernel_ab.entry_points(tmp_path / "lut_gather.cu")["rkmh_lut_gather_rows"] == (
        "const int32_t* lut, const int32_t* idx, int32_t* out, int N, int C, int64_t M, "
        "int smem, cudaStream_t stream")
    older = (tmp_path / "counter.cu").read_text().replace(  # K6 before its binned design
        "const int32_t* lens, int L, const int* ks, int nk, int64_t n,", "int64_t n,")
    (tmp_path / "counter.cu").write_text(older)
    assert kernel_ab.changed_entry_points(tmp_path) == {"rkmh_counter_add"}
    with pytest.raises(ValueError, match="rkmh_counter_add"):
        kernel_ab.build_libraries(tmp_path, [])


def test_kernel_ab_case_runs_where_its_kernels_are():
    lib = _OldCounters()
    case = kernel_ab.Case((kernels.LUT_GATHER_ROWS,), new=lambda: "new")
    assert case.new() == "new" and case.runs_on(lib)
    k1 = kernel_ab.Case((kernels.WINDOW_HASH,), new=lambda: 1)
    assert not k1.runs_on(lib)


def test_kernel_ab_checks_compare_with_the_plain_version():
    table = torch.zeros(101, dtype=torch.int32)
    hashes = torch.arange(-40, 40).reshape(4, 20)
    mask = hashes % 3 != 0
    check = kernel_ab.adds_like_plain(table, hashes, mask)
    from rkmh_tpu_torch.ops import counter

    assert check(lambda: counter.counter_add(table, hashes, mask)) and int(table.sum()) == 0
    assert not check(lambda: counter.counter_add(table, hashes, None))
    same = kernel_ab.equals(lambda: torch.ones(3))
    assert same(lambda: torch.ones(3)) and not same(lambda: torch.zeros(3))


@pytest.mark.parametrize("argv,ok", [
    (["--old-csrc", "d"], True),
    (["--old-csrc", "d", "--only", "k6", "--only", "k3", "--variant", "plain_flush=v"], True),
    (["--old-csrc", "d", "--only", "k7", "--only", "k4"], True),
    ([], False),
    (["--old-csrc", "d", "--variant", "old=v"], False),
])
def test_kernel_ab_arguments(argv, ok, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if ok:
        assert kernel_ab.main(argv) == 1  # parsed; then refuses to run without a card
        assert "needs a CUDA device" in capsys.readouterr().err
    else:
        with pytest.raises(SystemExit):
            kernel_ab.main(argv)


def test_e2e_ab_script_parses_and_names_both_paths():
    import subprocess

    script = Path(kernel_ab.__file__).with_name("e2e_ab.sh")
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    text = script.read_text()
    assert "cli stream" in text and "cli hpv16" in text and "outputs identical" in text
    assert text.count('run "$OTHER" other') == text.count('run "$ROOT" this') == 2
