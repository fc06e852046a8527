"""Simulate coinfection read mixes from per-strain read files.

Clean-room equivalent of scripts/make_mix.py + make_random_mix.py.  The
reference shells out to ``seqtk sample -s42``; the sampler here is
built-in (reservoir-free: index choice without replacement, seeded 42
by default) so no external binary is needed.  Output filenames follow
the reference's truth-encoding convention consumed by score_test_data /
crunch_score: ``<cov>_<strain>_0-<prop>_..._<n>_.fq``.

Two modes:
* --sample-file: explicit mixes, one block per output file — TSV lines
  ``Strain  Proportion  TotalCoverage  ReadFile`` separated by blank
  lines (the reference's format).
* --random: N random mixes from a ``LABEL\\tPATH`` strain table, with
  the reference's proportion scheme (first U(0.04, 0.5), each next
  U(0.04, prev), remainder to the last strain).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from rkmh_tpu_torch.io.fastx import read_fastx

READ_LEN_NORM = 250  # reference's reads-per-coverage divisor


_PARSE_CACHE: dict = {}


def sample_reads(path: str, n: int, rng) -> list:
    recs = _PARSE_CACHE.get(path)
    if recs is None:
        recs = _PARSE_CACHE[path] = read_fastx(path)
    if n >= len(recs):
        return recs
    idx = rng.choice(len(recs), size=n, replace=False)
    return [recs[i] for i in sorted(idx)]


def num_reads(total_cov: float, genome_len: float, prop: float) -> int:
    return int(math.ceil(total_cov * (genome_len / READ_LEN_NORM) * prop))


def write_mix(out_path: str, parts: list, rng) -> None:
    with open(out_path, "w") as fh:
        for path, n in parts:
            for rec in sample_reads(path, n, rng):
                qual = (rec.qual or b"I" * len(rec.seq)).decode()
                fh.write(f"@{rec.name}\n{rec.seq.decode()}\n+\n{qual}\n")


def random_proportions(n: int, rng) -> list[float]:
    if n == 1:
        return [1.0]
    props = [float(rng.uniform(0.04, 0.50))]
    for _ in range(n - 2):
        props.append(float(rng.uniform(0.04, props[-1])))
    props.append(1.0 - sum(props))
    return props if props[-1] >= 0 else random_proportions(n, rng)


def mix_name(cov: int, strains: list[str], props: list[float], n_reads: int) -> str:
    mid = "_".join(f"{s}_0-{p}" for s, p in zip(strains, props))
    return f"{cov}_{mid}_{n_reads}_.fq"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--sample-file", help="explicit mix blocks (TSV)")
    ap.add_argument("-l", "--genome-length", type=float, default=7906.0)
    ap.add_argument("--random", help="LABEL\\tPATH strain table for random mixes")
    ap.add_argument("-n", "--num-mixes", type=int, default=10)
    ap.add_argument("--num-strains", type=int, default=2)
    ap.add_argument("-m", "--min-cov", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)

    if args.sample_file:
        block: list = []
        cov = 0
        with open(args.sample_file) as fh:
            lines = [l.rstrip("\n") for l in fh] + [""]
        for line in lines:
            if line.startswith("#"):
                continue
            t = line.split("\t")
            if len(t) >= 4:
                block.append((t[0], float(t[1]), t[3]))
                cov = int(float(t[2]))
            elif block:
                strains = [b[0] for b in block]
                props = [b[1] for b in block]
                parts = [
                    (b[2], num_reads(cov, args.genome_length, b[1])) for b in block
                ]
                total = sum(n for _, n in parts)
                out = mix_name(cov, strains, props, total)
                write_mix(out, parts, rng)
                print(f"wrote {out}", file=sys.stderr)
                block, cov = [], 0
        return 0

    if args.random:
        table = {}
        with open(args.random) as fh:
            for line in fh:
                if line.strip():
                    k, v = line.split("\t")[:2]
                    table[k.strip()] = v.strip()
        labels = sorted(table)
        for _ in range(args.num_mixes):
            cov = int(rng.integers(args.min_cov, 10_000))
            chosen = [labels[i] for i in rng.choice(len(labels), size=args.num_strains, replace=False)]
            props = random_proportions(len(chosen), rng)
            parts = [
                (table[s], num_reads(cov, args.genome_length, p))
                for s, p in zip(chosen, props)
            ]
            total = sum(n for _, n in parts)
            out = mix_name(cov, chosen, props, total)
            write_mix(out, parts, rng)
            print(f"wrote {out}", file=sys.stderr)
        return 0

    print("one of --sample-file or --random is required", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
