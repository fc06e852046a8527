"""Quick per-reference quantification from classify/stream output.

Clean-room equivalent of scripts/rkmh_quant.sh
(``grep -v FAIL | cut -f2 | cut -f2 -d' ' | cut -f3 -d'|' | sort |
uniq -c``): counts passing reads per extracted label.  The default
extraction replicates the shell pipeline (read-name field); --by-ref
counts by the classified reference instead (the generally useful
variant), with fractions.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter


def shell_style_label(line: str) -> str | None:
    t = line.rstrip("\n").split("\t")
    if len(t) < 2:
        return None
    tok = t[1].split(" ")
    tok = tok[1] if len(tok) > 1 else tok[0]
    parts = tok.split("|")
    return parts[2] if len(parts) > 2 else tok


def main(argv=None, stdin=None, stdout=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile", nargs="?", default="-")
    ap.add_argument("--by-ref", action="store_true",
                    help="count by classified reference (field 1) with fractions")
    args = ap.parse_args(argv)
    stdout = stdout or sys.stdout
    fh = (stdin or sys.stdin) if args.infile == "-" else open(args.infile)

    counts: Counter = Counter()
    try:
        for line in fh:
            if "FAIL" in line:
                continue
            if args.by_ref:
                counts[line.split("\t")[0]] += 1
            else:
                label = shell_style_label(line)
                if label is not None:
                    counts[label] += 1
    finally:
        if args.infile != "-":
            fh.close()

    total = sum(counts.values()) or 1
    for label in sorted(counts):
        if args.by_ref:
            print(f"{counts[label]}\t{label}\t{counts[label] / total:.6g}", file=stdout)
        else:
            print(f"{counts[label]:7d} {label}", file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
