"""portbench/gen is a frozen copy of rkmh_tpu_torch/synth.py: the same seed
and sizes write the same bytes."""

import filecmp

import pytest

from portbench import gen
from portbench.gen import call_sample, panel_reads, refpath_reads
from rkmh_tpu_torch import synth

HPV16 = dict(types=182, genome_len=7900, sublineages=list(synth.HPV16_SUBLINEAGES),
             lineage_divergence=0.006, sublineage_divergence=0.004, read_mean_len=4500,
             read_len_sigma=0.6, read_min_len=500, read_max_len=20000, read_sub_rate=0.08,
             from_sublineage=0.8)
SEEDS = [0, 2**31 + 12345]


def _same(a, b, names):
    return [n for n in names if not filecmp.cmp(a / n, b / n, shallow=False)]


@pytest.mark.parametrize("seed", SEEDS)
def test_panel_reads_byte_identical(tmp_path, seed):
    # more than one 65,536-read chunk, and names of 1 to 5 digits
    panel_reads.write_panel_reads(str(tmp_path / "a"), 70000, 150, 60, 10807, 0.05, 0.01, 0.001, seed)
    synth.write_workload(str(tmp_path / "b"), 70000, seed=seed)
    assert _same(tmp_path / "a", tmp_path / "b", ["refs.fa", "reads.fq"]) == []


@pytest.mark.parametrize("seed", SEEDS)
def test_refpath_reads_byte_identical(tmp_path, seed):
    out = refpath_reads.write_refpath_reads(str(tmp_path / "a"), HPV16, 150, 0.0, seed)
    synth.write_hpv16_workload(str(tmp_path / "b"), 150, seed)
    assert _same(tmp_path / "a", tmp_path / "b",
                 ["all_pave_ref.fa", "new_refs.fa", "reads.fq"]) == []
    assert out["reads_n"] == 150
    assert out["bases"] == sum(len(r) for r in (tmp_path / "b" / "reads.fq").read_text()
                               .splitlines()[1::4])


@pytest.mark.parametrize("seed", SEEDS)
def test_call_sample_byte_identical(tmp_path, seed):
    call_sample.write_call_sample(str(tmp_path / "a"), HPV16, 1100, 40, 10, 0.0, seed)
    synth.write_call_workload(str(tmp_path / "b"), seed=seed)
    assert _same(tmp_path / "a", tmp_path / "b", ["ref.fa", "reads.fq", "truth.tsv"]) == []


def test_make_inputs_keeps_one_seed(tmp_path):
    """Each call writes the seed's files anew over the last seed's: the same
    seed gives the same bytes, and one directory holds one seed's files."""
    cfg = dict(refs=3, genome_len=500, read_len=50, divergence=0.05, read_noise=0.01)
    tr = {"command": "stream", "inputs": "panel_reads", "reads": 10, "flags": {"ks": [12]}}
    a = gen.make_inputs(cfg, tr, 1, str(tmp_path))
    first = open(a["reads"], "rb").read()
    b = gen.make_inputs(cfg, tr, 2, str(tmp_path))
    assert b["reads"] == a["reads"] and open(b["reads"], "rb").read() != first
    assert gen.make_inputs(cfg, tr, 1, str(tmp_path)) == a
    assert open(a["reads"], "rb").read() == first
    assert [p.name for p in tmp_path.iterdir()] == ["panel_reads"]
