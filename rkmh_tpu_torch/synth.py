"""Deterministic synthetic workloads, made with numpy from a seed.

The zika-shaped panel of the repo's headline configuration: 60 genomes of
10,807 bp that derive from one random base genome at ~5% substitution
divergence each, like a strain panel, and 150 bp reads sampled from known
genomes with i.i.d. true substitutions (a replacement base is drawn from
the three other bases, the noise model of tests/test_quant_accuracy.py)
plus a small share of ``N`` bases.  The tests and ``chip_smoke.py`` use
it in place of real reference data.

    python -m rkmh_tpu_torch.synth --out-dir DIR [--reads N] [--seed S]

writes DIR/refs.fa and DIR/reads.fq.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

NUM_REFS = 60
GENOME_LEN = 10807
READ_LEN = 150
DIVERGENCE = 0.05
READ_NOISE = 0.01
N_RATE = 0.001

_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def make_panel(num_refs: int = NUM_REFS, genome_len: int = GENOME_LEN,
               divergence: float = DIVERGENCE, seed: int = 0):
    """-> (names, [R, G] uint8 codes 0..3), every genome a mutant of one base."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, genome_len, dtype=np.uint8)
    genomes = np.tile(base, (num_refs, 1))
    mut = rng.random(genomes.shape) < divergence
    genomes[mut] = (genomes[mut] + rng.integers(1, 4, int(mut.sum()), dtype=np.uint8)) % 4
    names = [f"syn{r:03d}" for r in range(num_refs)]
    return names, genomes


def make_reads(genomes: np.ndarray, n_reads: int, read_len: int = READ_LEN,
               noise: float = READ_NOISE, n_rate: float = N_RATE, seed: int = 1):
    """-> ([n, read_len] uint8 ASCII reads, [n] source genome index)."""
    rng = np.random.default_rng(seed)
    R, G = genomes.shape
    src = rng.integers(0, R, n_reads)
    start = rng.integers(0, G - read_len + 1, n_reads)
    codes = genomes[src[:, None], start[:, None] + np.arange(read_len)]
    sub = rng.random(codes.shape) < noise
    codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
    codes[rng.random(codes.shape) < n_rate] = 4  # N
    return _ACGTN[codes], src


def write_fasta(path: str, names, seqs: np.ndarray, width: int = 70):
    with open(path, "w") as fh:
        for name, seq in zip(names, seqs):
            s = seq.tobytes().decode()
            fh.write(f">{name}\n")
            fh.writelines(s[i : i + width] + "\n" for i in range(0, len(s), width))


def write_fastq(path: str, seqs: np.ndarray, first: int = 0, mode: str = "w"):
    """Reads named read<i> for i = first, first+1, ..."""
    L = seqs.shape[1]
    qual = "I" * L
    blob = seqs.tobytes().decode()
    with open(path, mode) as fh:
        fh.write("".join(
            f"@read{first + i}\n{blob[i * L:(i + 1) * L]}\n+\n{qual}\n"
            for i in range(len(seqs))))


def write_workload(out_dir: str, n_reads: int, read_len: int = READ_LEN,
                   num_refs: int = NUM_REFS, genome_len: int = GENOME_LEN,
                   seed: int = 0, chunk: int = 1 << 16):
    """Write out_dir/refs.fa and out_dir/reads.fq; returns (refs path,
    reads path, ref names, [n_reads] source index of every read)."""
    os.makedirs(out_dir, exist_ok=True)
    names, genomes = make_panel(num_refs, genome_len, seed=seed)
    refs = os.path.join(out_dir, "refs.fa")
    reads = os.path.join(out_dir, "reads.fq")
    write_fasta(refs, names, _ACGTN[genomes])
    srcs = []
    for first in range(0, n_reads, chunk):
        n = min(chunk, n_reads - first)
        seqs, src = make_reads(genomes, n, read_len, seed=seed + 1 + first // chunk)
        write_fastq(reads, seqs, first, mode="w" if first == 0 else "a")
        srcs.append(src)
    if not srcs:
        open(reads, "w").close()
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    return refs, reads, names, src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--reads", type=int, default=1000)
    ap.add_argument("--read-len", type=int, default=READ_LEN)
    ap.add_argument("--refs", type=int, default=NUM_REFS)
    ap.add_argument("--genome-len", type=int, default=GENOME_LEN)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write_workload(args.out_dir, args.reads, args.read_len, args.refs,
                   args.genome_len, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
