"""``call_sample`` (hpv16's call): HPV16REF as the reference, a sample with
``snps`` substitutions and ``dels`` 1-bp deletions planted, and ``reads``
nanopore-like reads of the sample (``synth.write_call_workload``)."""

from __future__ import annotations

import os

import numpy as np

from portbench.gen import ACGTN, rng_seed, fasta_bytes, fastq_bytes
from portbench.gen._hpv16 import hpv16_panel, nanopore_read, read_lengths, read_model


def plant_variants(ref: np.ndarray, n_snps: int, n_dels: int, seed: int):
    """-> (the sample genome, its variants as (VCF pos, REF, ALT, index))."""
    rng = np.random.default_rng(rng_seed(seed))
    n = n_snps + n_dels
    slot = (len(ref) - 200) // max(n, 1)
    if n and slot < 60:
        raise ValueError(f"{n} variants do not fit a {len(ref)} bp reference")
    kinds = rng.permutation(np.array([True] * n_snps + [False] * n_dels, dtype=bool))
    sample = ref.copy()
    variants, dels = [], []
    for i, is_snp in enumerate(kinds):
        p = 100 + i * slot + int(rng.integers(10, slot - 40))
        ref_base = "ACGT"[ref[p]]
        if is_snp:
            sample[p] = (ref[p] + rng.integers(1, 4)) % 4
            variants.append((p + 1, ref_base, "ACGT"[sample[p]], p))
        else:
            while ref[p] == ref[p - 1] or ref[p] == ref[p + 1]:
                p += 1
            dels.append(p)
            variants.append((p + 2, "ACGT"[ref[p]], "-", p))
    return np.delete(sample, dels), variants


def write_call_sample(out_dir: str, cfg: dict, n_reads: int, n_snps: int, n_dels: int,
                      n_rate: float, seed: int) -> dict:
    """out_dir/ref.fa, out_dir/reads.fq and out_dir/truth.tsv, as
    synth.write_call_workload."""
    os.makedirs(out_dir, exist_ok=True)
    panel = hpv16_panel(cfg, seed)
    ref = panel.types[panel.hpv16]
    name = panel.type_names[panel.hpv16]
    sample, variants = plant_variants(ref, n_snps, n_dels, seed + 1)
    rng = np.random.default_rng(rng_seed(seed + 2))
    m = read_model(cfg)
    reads = [nanopore_read(sample, length, rng, m.sub_rate, n_rate)
             for length in read_lengths(n_reads, rng, m)]
    paths = [os.path.join(out_dir, f) for f in ("ref.fa", "reads.fq", "truth.tsv")]
    with open(paths[0], "wb") as fh:
        fh.write(fasta_bytes([name], [ACGTN[ref]]))
    with open(paths[1], "wb") as fh:
        fh.write(fastq_bytes(reads))
    with open(paths[2], "w") as fh:
        fh.write("#name\tpos\tref\talt\tindex0\n")
        fh.writelines(f"{name}\t{pos}\t{r}\t{a}\t{i}\n" for pos, r, a, i in variants)
    return {"refs": paths[0], "reads": paths[1], "truth": paths[2], "reads_n": n_reads,
            "bases": int(sum(len(r) for r in reads))}


def write(out_dir: str, cfg: dict, traffic: dict, seed: int) -> dict:
    return write_call_sample(out_dir, cfg, traffic["reads"], traffic["snps"], traffic["dels"],
                             traffic.get("n_rate", 0.0), seed)
