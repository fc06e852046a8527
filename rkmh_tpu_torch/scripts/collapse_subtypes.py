"""Collapse sublineage features to lineages in VW vectors.

Clean-room equivalent of scripts/collapse_subtypes.py: for each VW line
on stdin, sums every A*/B*/C*/D* strain count into one feature per
lineage (unclassified -> U) and rewrites the |vir namespace with the
normalized fractions.
"""

from __future__ import annotations

import sys
from collections import Counter


def collapse_line(line: str) -> str:
    parts = line.split("|")
    sums: Counter = Counter()
    for feat in parts[1].split(" "):
        feat = feat.strip()
        if not feat or ":" not in feat:
            continue
        name, val = feat.split(":")
        v = float(val)
        v = int(v) if v.is_integer() else v
        if name[0] in "ABCD":
            sums[name[0]] += v
        elif name.startswith("u"):
            sums["U"] = v  # overwrite, as the reference does
    total = sum(sums.values()) or 1
    feats = " ".join(f"{k}:{v / total}" for k, v in sums.items())
    return f"{parts[0].strip()} |vir {feats}".strip()


def main(argv=None, stdin=None, stdout=None) -> int:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    for line in stdin:
        print(collapse_line(line), file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
