"""rkmh_tpu_torch classify step vs the JAX package, bit for bit.

The argmax with ties, all-zero counts and -N/-D thresholds; the whole
per-batch step on random reads in both probe row modes and multi-k; and a
port run on a panel the JAX package built, carried over by convert.py.
The JAX step is run as it runs on the CPU (its sort path).  Tolerance:
none.
"""

import numpy as np
import pytest
import torch

from rkmh_tpu.classify import engine as jengine
from rkmh_tpu.commands.common import build_ref_panel_from_files as jax_panel_from_files
from rkmh_tpu.ops.lookup import build_panel_table as jax_build_table
from rkmh_tpu.utils import to_host
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import PyPacked, build_ref_panel
from rkmh_tpu_torch.convert import panel_from_numpy
from rkmh_tpu_torch.device import resolve_device
from rkmh_tpu_torch.io.fastx import SeqRecord, read_fastx
from rkmh_tpu_torch.ops.probe import pack_result

CPU = torch.device("cpu")


def _counts():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 6, size=(40, 7)).astype(np.int32)
    c[0] = 0                          # all zero
    c[1] = [3, 5, 5, 1, 5, 0, 2]      # tie for the max: first wins
    c[2] = [5, 5, 5, 5, 5, 5, 5]      # all tied
    c[3] = [0, 0, 0, 0, 0, 0, 9]      # best last
    c[4] = [9, 8, 0, 0, 0, 0, 0]      # best first (diff against -1)
    lens = rng.integers(0, 12, size=40).astype(np.int32)
    return c, lens


@pytest.mark.parametrize("min_diff,min_matches", [(0, -1), (1, 3), (4, 5), (0, 9)])
def test_argmax_stream_matches_jax(min_diff, min_matches):
    c, lens = _counts()
    want = [np.asarray(a) for a in jengine.argmax_stream(c, min_diff, min_matches, lens)]
    got = engine.argmax_stream(torch.from_numpy(c), min_diff, min_matches,
                               torch.from_numpy(lens))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def small_panel():
    names, genomes = synth.make_panel(num_refs=6, genome_len=1500, seed=3)
    seqs = synth._ACGTN[genomes]
    return names, genomes, PyPacked([SeqRecord(n, s.tobytes()) for n, s in zip(names, seqs)])


def _reads_codes(genomes, n, read_len, L, seed):
    from rkmh_tpu_torch.io.packing import CODE_LUT

    reads, _ = synth.make_reads(genomes, n, read_len, noise=0.02, n_rate=0.01, seed=seed)
    codes = np.full((n, L), 255, np.uint8)
    codes[:, :read_len] = CODE_LUT[reads]
    codes[0] = 255  # an empty read
    return codes


@pytest.mark.parametrize("ks,s,read_len,L", [
    ((12,), 1000, 150, 160),      # W <= s: raw rows, prefix-equality ranks
    ((12,), 50, 150, 160),        # W > s: sorted sketches
    ((12, 16), 1000, 100, 128),   # multi-k, raw rows
    ((12, 16), 1000, 150, 160),   # multi-k past the raw-row cap
])
def test_classify_step_matches_jax(small_panel, ks, s, read_len, L):
    _, genomes, packed = small_panel
    panel = build_ref_panel(packed, ks, s, CPU)
    jsk, jlens = jengine.sketch_batch(packed.codes, ks, s)
    assert np.array_equal(panel.sketches.numpy().view(np.uint64), np.asarray(jsk))
    table = jax_build_table(np.asarray(jsk), np.asarray(jlens)).table
    assert np.array_equal(panel.table.numpy().view(np.uint32), table)

    codes = _reads_codes(genomes, 64, read_len, L, seed=len(ks) + s)
    for md, mm in ((0, -1), (2, 8)):
        want = to_host(jengine.classify_codes_table_packed(
            codes, table, ks=ks, sketch_size=s, num_refs=panel.num_refs,
            min_diff=md, min_matches=mm))
        got = engine.classify_codes_table(torch.from_numpy(codes), panel, ks, s, md, mm)
        assert got.dtype == torch.int32 and got.shape == (3, 64)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_port_runs_on_a_jax_built_panel(tmp_path):
    refs, reads, names, src = synth.write_workload(
        str(tmp_path), 96, num_refs=5, genome_len=1200, seed=4)
    jp = jax_panel_from_files([refs], (12,), 1000)
    sk, lens = to_host((jp.sketches, jp.lens))
    panel = panel_from_numpy(jp.keys, sk, lens, to_host(jp.table[0]), CPU)
    assert panel.keys == names and panel.table.dtype == torch.int32

    from rkmh_tpu_torch.io.packing import encode_seqs

    codes, _ = encode_seqs([r.seq for r in read_fastx(reads)], pad_to=160)
    want = to_host(jengine.classify_codes_table_packed(
        codes, jp.table[0], ks=(12,), sketch_size=1000, num_refs=jp.num_refs,
        min_diff=0, min_matches=-1))
    got = engine.classify_codes_table(torch.from_numpy(codes), panel, (12,), 1000, 0, -1)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.mean(np.asarray(want)[0] == src) > 0.8  # reads find their genome


def test_pack_result_layout():
    out = pack_result(torch.tensor([2, 0]), torch.tensor([7, 0]), torch.tensor([True, False]),
                      torch.tensor([False, True]), torch.tensor([True, True]))
    assert out.dtype == torch.int32
    assert out.tolist() == [[2, 0], [7, 0], [5, 6]]


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == CPU
    with pytest.raises(ValueError):
        resolve_device("meta")
