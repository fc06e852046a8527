"""The kernels' bounds (rkmh_tpu_torch/bench/bounds.py) on the CPU.

The probe statistics must agree with the plain probe: the reference bits
of the hits add up to the plain counts, and only the table sectors that
probes reach are counted.  The depth map's bounds (K8, K9) count its
function's work, whatever the layout.  Inputs are made from a seed with numpy.
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
                                      "call_scan.cu", "set_table.cu"}
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


def test_call_ab_script_parses_and_runs_both_checkouts_in_turns():
    import subprocess

    script = Path(kernel_ab.__file__).with_name("call_ab.sh")
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    text = script.read_text()
    assert "call_cmd.run" in text and "_call_scan_cuda" in text and "same VCF" in text
    assert text.count('run "$OTHER" other') == text.count('run "$ROOT" this') == 2


def test_probe_ab_script_parses_and_runs_both_checkouts_in_turns():
    import subprocess

    script = Path(kernel_ab.__file__).with_name("probe_ab.sh")
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    text = script.read_text()
    assert "bench.probe_inputs" in text and "_sorted_probe_cuda" in text
    assert "_panel_probe_cuda" in text and "same outputs" in text
    assert text.count('run "$OTHER" other') == text.count('run "$ROOT" this') == 3


def test_probe_inputs_refuses_to_run_without_a_card(monkeypatch, capsys):
    from rkmh_tpu_torch.bench import probe_inputs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_inputs.main(["out"]) == 1 and "needs a CUDA device" in capsys.readouterr().err
    assert probe_inputs.main([]) == 2


def test_e2e_ab_script_parses_and_names_both_paths():
    import subprocess

    script = Path(kernel_ab.__file__).with_name("e2e_ab.sh")
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    text = script.read_text()
    assert "cli stream" in text and "cli hpv16" in text and "outputs identical" in text
    assert text.count('run "$OTHER" other') == text.count('run "$ROOT" this') == 2


def test_map_bounds_count_the_function_not_the_layout():
    """K8's and K9's bounds: the queries in, the outputs, 12 bytes for each
    distinct key the queries find; the same for two layouts of one
    function (here: counts in the words, or all of them in the overflow)."""
    from rkmh_tpu_torch import call_engine
    from rkmh_tpu_torch.ops import hashmap

    rng = np.random.default_rng(4)
    ref = torch.from_numpy(rng.integers(0, 4, 300).astype(np.uint8))
    ref[100:103] = 4
    k = 12
    _, snp, dels = call_engine.mutation_hashes(ref, k, 0, 300 - k + 1)
    found_keys = torch.cat([snp.reshape(-1)[::50], dels.reshape(-1)[::40]]).unique()
    keys = np.unique(np.concatenate([found_keys.numpy().view(np.uint64),
                                     rng.integers(0, 2**64 - 1, 500, dtype=np.uint64)]))
    small = hashmap.build_sorted_map(keys, np.ones(len(keys), np.int32))
    big = hashmap.build_sorted_map(keys, np.full(len(keys), 2**30, np.int32))
    assert small.m == 0 and big.m == len(keys)
    queries = torch.cat([found_keys, found_keys, torch.tensor([5, 6, 7])])
    for sm in (small, big):
        assert bounds.hashmap_get_bytes(sm, queries) == 12 * queries.numel() + 12 * int(
            found_keys.numel())
        P = 300 - k + 1
        assert bounds.call_scan_bytes(ref, sm, k, chunk=100) == (
            301 + 9 * P + 20 * P * k + 4 * P + 12 * int(found_keys.numel()))
    empty = hashmap.build_sorted_map(np.zeros(0, np.uint64), np.zeros(0, np.int32))
    assert bounds.hashmap_get_bytes(empty, queries) == 12 * queries.numel()


def test_sorted_probe_work_counts_the_function_not_the_layout():
    """K10's bound: the rows and lens in, the [B, 2 + U] output, a key and
    its mask row for each distinct key that the valid run starts find,
    counted directly."""
    from rkmh_tpu_torch import convert
    from rkmh_tpu_torch.ops.lookup import build_sorted_panel, sorted_panel_counts

    _, _, pool, rng = _panel(7)
    T, U = 30, 10
    keys, masks = build_sorted_panel([rng.choice(pool, 50) for _ in range(T + U)], T + U)
    panel = convert.sorted_panel_from_numpy(keys, masks, "cpu")
    raw = torch.from_numpy(rng.choice(np.concatenate([pool, rng.integers(1, 2**63, 100)]),
                                      size=(16, 80)))
    raw[:, 1::5] = raw[:, ::5][:, : raw[:, 1::5].shape[1]]  # repeats
    rows, lens = bottom_s_sketch(raw, 60)
    work = bounds.sorted_probe_work(rows, lens, panel.keys, panel.masks, U)
    row_of = {int(k): i for i, k in enumerate(keys.tolist())}
    found, hits, bits = set(), 0, 0
    for row, n in zip(rows.numpy().view(np.uint64), lens.tolist()):
        values = (set(row[:n].tolist()) - {2**64 - 1}) & row_of.keys()
        found |= values
        hits += len(values)
        bits += sum(bin(int(w)).count("1") for v in values for w in masks[row_of[v]])
    Wm = masks.shape[1]
    assert (work.found, work.hits) == (len(found), hits) and work.found > 0
    assert work.nbytes == (8 * int(lens.sum()) + 4 * 16 + 16 * (2 + U) * 8
                           + len(found) * (8 + 4 * Wm))
    # the keys counted are those whose masks the function adds up
    assert int(sorted_panel_counts(rows, lens, panel.keys, panel.masks, T + U).sum()) == bits


@pytest.mark.parametrize("sorted_rows", [False, True])
def test_wide_probe_work_counts_the_function_not_the_layout(sorted_rows):
    """K11's bound: the rows and lens (ref_lens in filter mode) in, the
    [3, B] or [5, B] output, and a hash, occ and mask row for each distinct
    (hash, occ) entry hit, counted directly from the sketches."""
    from rkmh_tpu_torch.bench.wide_inputs import straddling_panel
    from rkmh_tpu_torch.ops.probe import pack_wide_table
    from rkmh_tpu_torch.ops.intersect import occ_ranks, prefix_eq_ranks

    R = 8193
    ref_sk, ref_lens, reads, set_lens = straddling_panel(R, seed=3, n_reads=16, width=48)
    table = torch.from_numpy(build_panel_table(ref_sk, ref_lens).table.view(np.int32))
    wide = pack_wide_table(table, R)
    entries = set()
    for row, n in zip(ref_sk.view(np.uint64), ref_lens.tolist()):
        vals, counts = np.unique(row[:n], return_counts=True)
        entries |= {(int(v), o) for v, c in zip(vals, counts) for o in range(c)}
    rows, lens = torch.from_numpy(reads), None
    if sorted_rows:
        rows, lens = bottom_s_sketch(rows, 32)
    occ = (occ_ranks(rows) if sorted_rows else prefix_eq_ranks(rows)).numpy()
    x = rows.numpy().view(np.uint64)
    valid = x != (2**64 - 1 if sorted_rows else 0)
    if sorted_rows:
        valid &= np.arange(x.shape[1])[None, :] < lens.numpy()[:, None]
    pairs = {(int(h), int(o)) for h, o in zip(x[valid], occ[valid])}
    found = pairs & entries
    Wm = -(-R // 32)
    rows_in = 8 * (int(lens.sum()) if sorted_rows else rows.numel()) + (4 * 16 if sorted_rows
                                                                         else 0)
    for ref_lens_arg, out_rows in ((None, 3), (torch.from_numpy(set_lens), 5)):
        work = bounds.wide_probe_work(rows, lens, wide, ref_lens_arg)
        assert work.found == len(found) > 0 and work.probes == int(valid.sum())
        assert work.nbytes == (rows_in + (0 if ref_lens_arg is None else 4 * R)
                               + out_rows * 4 * 16 + len(found) * (12 + 4 * Wm))
