"""What the hpv16 generators share: the PaVE-shaped panel of type genomes
with HPV16's lineages and sublineages, and nanopore-like reads of a genome
(``synth.py``'s HPV16 workloads).  Not a kind of input itself."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.gen import ACGTN, rng_seed


@dataclass
class Hpv16Panel:
    type_names: list
    types: list
    sub_names: list
    subs: list
    hpv16: int  # index of the HPV16 type genome


@dataclass
class ReadModel:
    mean_len: int
    sigma: float
    min_len: int
    max_len: int
    sub_rate: float


def _substitute(codes: np.ndarray, rate: float, rng) -> np.ndarray:
    out = codes.copy()
    mut = rng.random(out.shape) < rate
    out[mut] = (out[mut] + rng.integers(1, 4, int(mut.sum()), dtype=np.uint8)) % 4
    return out


def make_hpv16_panel(seed: int, num_types: int, genome_len: int, sublineages,
                     lineage_div: float, sublineage_div: float) -> Hpv16Panel:
    rng = np.random.default_rng(rng_seed(seed))
    hpv16 = min(15, num_types - 1)
    numbers = [i + 1 for i in range(num_types)]
    numbers[hpv16] = 16
    types = [rng.integers(0, 4, int(n), dtype=np.uint8)
             for n in genome_len + rng.integers(-200, 201, num_types)]
    lineages = {ln: _substitute(types[hpv16], lineage_div, rng)
                for ln in sorted({s[0] for s in sublineages})}
    subs = [_substitute(lineages[s[0]], sublineage_div, rng) for s in sublineages]
    return Hpv16Panel([f"HPV{n}REF" for n in numbers], types, list(sublineages), subs, hpv16)


def read_lengths(n: int, rng, m: ReadModel) -> np.ndarray:
    return np.clip(rng.lognormal(np.log(m.mean_len) - m.sigma**2 / 2, m.sigma, n),
                   m.min_len, m.max_len).astype(np.int64)


def nanopore_read(genome: np.ndarray, length: int, rng, sub_rate: float,
                   n_rate: float) -> np.ndarray:
    codes = genome[(rng.integers(len(genome)) + np.arange(length)) % len(genome)]
    if rng.random() < 0.5:
        codes = 3 - codes[::-1]  # the other strand
    codes = _substitute(codes, sub_rate, rng)
    if n_rate > 0:
        codes[rng.random(codes.shape) < n_rate] = 4  # N
    return ACGTN[codes]


def make_nanopore_reads(n: int, seed: int, panel: Hpv16Panel, m: ReadModel,
                        from_sublineage: float, n_rate: float) -> list:
    rng = np.random.default_rng(rng_seed(seed))
    others = [i for i in range(len(panel.types)) if i != panel.hpv16] or [panel.hpv16]
    reads = []
    for length in read_lengths(n, rng, m):
        if rng.random() < from_sublineage:
            genome = panel.subs[rng.integers(len(panel.subs))]
        else:
            genome = panel.types[others[rng.integers(len(others))]]
        reads.append(nanopore_read(genome, length, rng, m.sub_rate, n_rate))
    return reads


def hpv16_panel(cfg: dict, seed: int) -> Hpv16Panel:
    return make_hpv16_panel(seed, cfg["types"], cfg["genome_len"], cfg["sublineages"],
                            cfg["lineage_divergence"], cfg["sublineage_divergence"])


def read_model(cfg: dict) -> ReadModel:
    return ReadModel(cfg["read_mean_len"], cfg["read_len_sigma"], cfg["read_min_len"],
                     cfg["read_max_len"], cfg["read_sub_rate"])
