"""``panel_reads`` (zika): ``refs`` genomes of ``genome_len`` bp, each a
mutant of one random base genome at ``divergence``; reads of ``read_len`` bp
sampled from them with i.i.d. substitutions at ``read_noise`` and N at the
traffic's ``n_rate``; written in chunks of 65,536 reads, each chunk from its
own seed (``synth.write_workload``)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.gen import ACGTN, rng_seed, fasta_bytes, fastq_bytes_fixed

CHUNK = 1 << 16
GEN_THREADS = 4


def make_panel(num_refs: int, genome_len: int, divergence: float, seed: int):
    """-> (names, [R, G] uint8 codes 0..3), every genome a mutant of one base."""
    rng = np.random.default_rng(rng_seed(seed))
    base = rng.integers(0, 4, genome_len, dtype=np.uint8)
    genomes = np.tile(base, (num_refs, 1))
    mut = rng.random(genomes.shape) < divergence
    genomes[mut] = (genomes[mut] + rng.integers(1, 4, int(mut.sum()), dtype=np.uint8)) % 4
    return [f"syn{r:03d}" for r in range(num_refs)], genomes


def make_reads(genomes: np.ndarray, n_reads: int, read_len: int, noise: float,
               n_rate: float, seed: int) -> np.ndarray:
    """-> [n, read_len] uint8 ASCII reads."""
    rng = np.random.default_rng(rng_seed(seed))
    R, G = genomes.shape
    src = rng.integers(0, R, n_reads)
    start = rng.integers(0, G - read_len + 1, n_reads)
    codes = genomes[src[:, None], start[:, None] + np.arange(read_len)]
    sub = rng.random(codes.shape) < noise
    codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
    codes[rng.random(codes.shape) < n_rate] = 4  # N
    return ACGTN[codes]


def write_panel_reads(out_dir: str, n_reads: int, read_len: int, num_refs: int,
                      genome_len: int, divergence: float, noise: float, n_rate: float,
                      seed: int) -> dict:
    """out_dir/refs.fa and out_dir/reads.fq, as synth.write_workload."""
    os.makedirs(out_dir, exist_ok=True)
    names, genomes = make_panel(num_refs, genome_len, divergence, seed)
    refs, reads = (os.path.join(out_dir, f) for f in ("refs.fa", "reads.fq"))
    with open(refs, "wb") as fh:
        fh.write(fasta_bytes(names, ACGTN[genomes]))

    def chunk(first: int) -> bytes:
        n = min(CHUNK, n_reads - first)
        return fastq_bytes_fixed(make_reads(genomes, n, read_len, noise, n_rate,
                                            seed + 1 + first // CHUNK), first)

    # each chunk draws from its own seed, so threads (numpy's bulk draws and
    # array work release the GIL) make the same bytes in the same order
    with open(reads, "wb") as fh, ThreadPoolExecutor(GEN_THREADS) as pool:
        for block in pool.map(chunk, range(0, n_reads, CHUNK)):
            fh.write(block)
    return {"refs": refs, "reads": reads, "reads_n": n_reads, "bases": n_reads * read_len}


def write(out_dir: str, cfg: dict, traffic: dict, seed: int) -> dict:
    return write_panel_reads(out_dir, traffic["reads"], cfg["read_len"], cfg["refs"],
                             cfg["genome_len"], cfg["divergence"], cfg["read_noise"],
                             traffic.get("n_rate", 0.0), seed)
