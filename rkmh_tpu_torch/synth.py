"""Deterministic synthetic workloads, made with numpy from a seed.

The tests and ``chip_smoke.py`` use them in place of real reference data.

* stream: the zika-shaped panel of the repo's headline configuration: 60
  genomes of 10,807 bp that derive from one random base genome at ~5%
  substitution divergence each, like a strain panel, and 150 bp reads
  sampled from known genomes with i.i.d. true substitutions (a
  replacement base is drawn from the three other bases, the noise model
  of tests/test_quant_accuracy.py) plus a small share of ``N`` bases.
* hpv16: a refpath at the shape of the real one: ``all_pave_ref.fa``
  with 182 unrelated type genomes of ~7,900 bp (one named ``HPV16REF``)
  and ``new_refs.fa`` with the 10 HPV16 sublineage genomes A1 A2 A3 A4
  B1 B2 C1 D1 D2 D3, each ~1% from the HPV16 genome (a lineage-level and
  a sublineage-level set of substitutions); and nanopore-like reads of
  ~4.5 kb on average (log-normal, clipped to 500-20,000 bp, from either
  strand of the circular genomes, so a read longer than its genome wraps
  around) with ~8% substitutions.  The noise is substitutions only: real
  nanopore reads also carry indels, which this model leaves out.

* call: the HPV16 type genome of the hpv16 panel (HPV16REF, ~7.9 kb) as
  the reference, a sample genome made from it by planting 1-bp
  substitutions (40 by default) and 1-bp deletions (10), each at least
  ~150 bp from the next and each deletion outside a run of equal bases
  (so its call has one position), and rkmh's load for ``call``: 1,100
  nanopore-like reads of the sample (the hpv16 length and noise model),
  with a truth file of the planted variants.

``n_rate`` (``--n-rate``) sets the share of bases turned to ``N`` (stream
reads: 0.001 by default; hpv16 and call reads: none by default), so that
reads hold invalid k-mers, whose hash is 0.

    python -m rkmh_tpu_torch.synth --out-dir DIR [--reads N] [--seed S] [--n-rate F]
    python -m rkmh_tpu_torch.synth --hpv16 --out-dir DIR [--reads N] [--seed S] [--n-rate F]
    python -m rkmh_tpu_torch.synth --call --out-dir DIR [--reads N] [--seed S] [--n-rate F]

write DIR/refs.fa and DIR/reads.fq; or the refpath DIR/all_pave_ref.fa,
DIR/new_refs.fa and the reads DIR/reads.fq; or DIR/ref.fa, DIR/reads.fq
and DIR/truth.tsv (one planted variant a line: name, the position and
alleles as rkmh's VCF prints them, the 0-based index of the changed base).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

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
                   seed: int = 0, chunk: int = 1 << 16, n_rate: float = N_RATE):
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
        seqs, src = make_reads(genomes, n, read_len, n_rate=n_rate,
                               seed=seed + 1 + first // chunk)
        write_fastq(reads, seqs, first, mode="w" if first == 0 else "a")
        srcs.append(src)
    if not srcs:
        open(reads, "w").close()
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    return refs, reads, names, src


HPV16_NUM_TYPES = 182
HPV16_GENOME_LEN = 7900
HPV16_SUBLINEAGES = ("A1", "A2", "A3", "A4", "B1", "B2", "C1", "D1", "D2", "D3")
LINEAGE_DIVERGENCE = 0.006
SUBLINEAGE_DIVERGENCE = 0.004
NANOPORE_MEAN_LEN = 4500
NANOPORE_LEN_SIGMA = 0.6
NANOPORE_MIN_LEN = 500
NANOPORE_MAX_LEN = 20000
NANOPORE_SUB_RATE = 0.08
FROM_SUBLINEAGE = 0.8


@dataclass
class Hpv16Panel:
    """Type genomes and HPV16 sublineage genomes as uint8 codes 0..3."""

    type_names: list
    types: list
    sub_names: list
    subs: list
    hpv16: int  # index of the HPV16 type genome


def _substitute(codes: np.ndarray, rate: float, rng) -> np.ndarray:
    out = codes.copy()
    mut = rng.random(out.shape) < rate
    out[mut] = (out[mut] + rng.integers(1, 4, int(mut.sum()), dtype=np.uint8)) % 4
    return out


def make_hpv16_panel(seed: int = 0, num_types: int = HPV16_NUM_TYPES,
                     genome_len: int = HPV16_GENOME_LEN,
                     sublineages=HPV16_SUBLINEAGES) -> Hpv16Panel:
    """Random type genomes of genome_len +- 200 bp; the one at index
    min(15, num_types - 1) is named HPV16REF and the sublineages derive
    from it: per lineage letter one set of substitutions, per sublineage
    another."""
    rng = np.random.default_rng(seed)
    hpv16 = min(15, num_types - 1)
    numbers = [i + 1 for i in range(num_types)]
    numbers[hpv16] = 16
    types = [rng.integers(0, 4, int(n), dtype=np.uint8)
             for n in genome_len + rng.integers(-200, 201, num_types)]
    lineages = {ln: _substitute(types[hpv16], LINEAGE_DIVERGENCE, rng)
                for ln in sorted({s[0] for s in sublineages})}
    subs = [_substitute(lineages[s[0]], SUBLINEAGE_DIVERGENCE, rng) for s in sublineages]
    return Hpv16Panel([f"HPV{n}REF" for n in numbers], types, list(sublineages), subs, hpv16)


def make_nanopore_reads(n: int, seed: int, panel: Hpv16Panel,
                        mean_len: int = NANOPORE_MEAN_LEN, min_len: int = NANOPORE_MIN_LEN,
                        max_len: int = NANOPORE_MAX_LEN, sub_rate: float = NANOPORE_SUB_RATE,
                        n_rate: float = 0.0):
    """-> (n ASCII reads of varying length, the type name each was drawn
    from).  A share FROM_SUBLINEAGE of the reads comes from the sublineage
    genomes (type HPV16), the rest from the other types; a share n_rate of
    bases becomes N (drawn only when n_rate > 0, so the reads of a seed
    stay the same without it)."""
    rng = np.random.default_rng(seed)
    others = [i for i in range(len(panel.types)) if i != panel.hpv16] or [panel.hpv16]
    reads, truth = [], []
    for length in _read_lengths(n, rng, mean_len, min_len, max_len):
        if rng.random() < FROM_SUBLINEAGE:
            genome = panel.subs[rng.integers(len(panel.subs))]
            truth.append(panel.type_names[panel.hpv16])
        else:
            t = others[rng.integers(len(others))]
            genome = panel.types[t]
            truth.append(panel.type_names[t])
        reads.append(_nanopore_read(genome, length, rng, sub_rate, n_rate))
    return reads, truth


def make_strain_reads(genome: np.ndarray, n: int, seed: int,
                      mean_len: int = NANOPORE_MEAN_LEN, min_len: int = NANOPORE_MIN_LEN,
                      max_len: int = NANOPORE_MAX_LEN,
                      sub_rate: float = NANOPORE_SUB_RATE) -> list:
    """n nanopore-like ASCII reads of one genome (a sublineage's, for the
    VW model pipeline's samples): the length and noise model of
    make_nanopore_reads, without N."""
    rng = np.random.default_rng(seed)
    return [_nanopore_read(genome, int(length), rng, sub_rate, 0.0)
            for length in _read_lengths(n, rng, mean_len, min_len, max_len)]


def _read_lengths(n: int, rng, mean_len: int, min_len: int, max_len: int) -> np.ndarray:
    """Log-normal read lengths of the given mean, clipped."""
    sigma = NANOPORE_LEN_SIGMA
    return np.clip(rng.lognormal(np.log(mean_len) - sigma**2 / 2, sigma, n),
                   min_len, max_len).astype(np.int64)


def _nanopore_read(genome: np.ndarray, length: int, rng, sub_rate: float,
                   n_rate: float) -> np.ndarray:
    """One ASCII read of a circular genome: a random start, either strand,
    substitutions at sub_rate and N at n_rate (drawn only when > 0)."""
    codes = genome[(rng.integers(len(genome)) + np.arange(length)) % len(genome)]
    if rng.random() < 0.5:
        codes = 3 - codes[::-1]  # the other strand
    codes = _substitute(codes, sub_rate, rng)
    if n_rate > 0:
        codes[rng.random(codes.shape) < n_rate] = 4  # N
    return _ACGTN[codes]


def write_fastq_records(path: str, seqs, first: int = 0):
    """Reads of any lengths, named read<i> for i = first, first+1, ..."""
    with open(path, "w") as fh:
        for i, seq in enumerate(seqs):
            s = seq.tobytes().decode()
            fh.write(f"@read{first + i}\n{s}\n+\n{'I' * len(s)}\n")


def write_hpv16_refpath(out_dir: str, seed: int = 0, **panel_kw) -> Hpv16Panel:
    """Write out_dir/all_pave_ref.fa and out_dir/new_refs.fa, the layout
    ``hpv16 -R out_dir`` reads; returns the panel."""
    os.makedirs(out_dir, exist_ok=True)
    panel = make_hpv16_panel(seed, **panel_kw)
    write_fasta(os.path.join(out_dir, "all_pave_ref.fa"),
                [f"{n} synthetic type genome" for n in panel.type_names],
                [_ACGTN[g] for g in panel.types])
    write_fasta(os.path.join(out_dir, "new_refs.fa"),
                [f"{n} synthetic HPV16 sublineage" for n in panel.sub_names],
                [_ACGTN[g] for g in panel.subs])
    return panel


def write_hpv16_workload(out_dir: str, n_reads: int, seed: int = 0, n_rate: float = 0.0,
                         **panel_kw):
    """The refpath plus out_dir/reads.fq of n_reads nanopore-like reads;
    returns (reads path, the type name each read was drawn from)."""
    panel = write_hpv16_refpath(out_dir, seed, **panel_kw)
    reads, truth = make_nanopore_reads(n_reads, seed + 1, panel, n_rate=n_rate)
    path = os.path.join(out_dir, "reads.fq")
    write_fastq_records(path, reads)
    return path, truth


CALL_READS = 1100  # rkmh's load for call (README: ~10 s for 1,100 reads)
CALL_SNPS = 40
CALL_DELS = 10


def plant_variants(ref: np.ndarray, n_snps: int, n_dels: int, seed: int):
    """-> (the sample genome, its variants sorted by position as (VCF pos,
    REF, ALT, 0-based index)).  The reference is cut into n_snps + n_dels
    equal slots and each slot gets one variant at a random offset; a
    deletion moves right to the first base that differs from both
    neighbours.  rkmh's VCF prints a substitution at index + 1 and a
    deletion at index + 2 (pos = j + alt_pos + 1 for both)."""
    rng = np.random.default_rng(seed)
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


def write_call_workload(out_dir: str, n_reads: int = CALL_READS, seed: int = 0,
                        n_snps: int = CALL_SNPS, n_dels: int = CALL_DELS,
                        n_rate: float = 0.0):
    """Write out_dir/ref.fa (HPV16REF of the hpv16 panel of ``seed``),
    out_dir/reads.fq (nanopore-like reads of the planted sample) and
    out_dir/truth.tsv; returns (ref path, reads path, truth path, variants)."""
    os.makedirs(out_dir, exist_ok=True)
    panel = make_hpv16_panel(seed)
    ref = panel.types[panel.hpv16]
    name = panel.type_names[panel.hpv16]
    sample, variants = plant_variants(ref, n_snps, n_dels, seed + 1)
    rng = np.random.default_rng(seed + 2)
    reads = [_nanopore_read(sample, length, rng, NANOPORE_SUB_RATE, n_rate)
             for length in _read_lengths(n_reads, rng, NANOPORE_MEAN_LEN, NANOPORE_MIN_LEN,
                                         NANOPORE_MAX_LEN)]
    paths = [os.path.join(out_dir, f) for f in ("ref.fa", "reads.fq", "truth.tsv")]
    write_fasta(paths[0], [name], [_ACGTN[ref]])
    write_fastq_records(paths[1], reads)
    with open(paths[2], "w") as fh:
        fh.write("#name\tpos\tref\talt\tindex0\n")
        fh.writelines(f"{name}\t{pos}\t{r}\t{a}\t{i}\n" for pos, r, a, i in variants)
    return (*paths, variants)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--reads", type=int, default=None,
                    help=f"reads to write (default 1000; {CALL_READS} with --call)")
    ap.add_argument("--read-len", type=int, default=READ_LEN)
    ap.add_argument("--refs", type=int, default=NUM_REFS)
    ap.add_argument("--genome-len", type=int, default=GENOME_LEN)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-rate", type=float, default=None,
                    help=f"share of bases turned to N (default {N_RATE} for stream "
                         "reads, 0 for hpv16 and call reads)")
    ap.add_argument("--hpv16", action="store_true",
                    help="write an hpv16 refpath and nanopore-like reads instead "
                         "(--read-len, --refs and --genome-len do not apply)")
    ap.add_argument("--call", action="store_true",
                    help=f"write call's reference, reads of a sample with planted "
                         f"variants and the truth file instead (--reads defaults to "
                         f"{CALL_READS}; --read-len, --refs and --genome-len do not apply)")
    args = ap.parse_args(argv)
    reads = args.reads if args.reads is not None else CALL_READS if args.call else 1000
    if args.call:
        write_call_workload(args.out_dir, reads, args.seed, n_rate=args.n_rate or 0.0)
    elif args.hpv16:
        write_hpv16_workload(args.out_dir, reads, args.seed, n_rate=args.n_rate or 0.0)
    else:
        write_workload(args.out_dir, reads, args.read_len, args.refs, args.genome_len, args.seed,
                       n_rate=N_RATE if args.n_rate is None else args.n_rate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
