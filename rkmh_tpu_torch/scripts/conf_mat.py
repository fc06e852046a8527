"""Confusion counts for Vowpal Wabbit binary coinfection predictions.

Clean-room equivalent of scripts/conf_mat.py: input lines are
``logit label`` where label is "hpv" (pure) or "coinf"; positive logit
predicts pure.  Emits one ``status correct`` row per prediction (the
long format the reference prints for downstream R plotting).
"""

from __future__ import annotations

import sys
from collections import Counter


def classify_line(logit: float, label: str) -> str:
    if label == "hpv":
        return "pure_correct" if logit > 0 else "pure_incorrect"
    return "coinf_correct" if logit < 0 else "coinf_incorrect"


def main(argv=None, stdout=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    stdout = stdout or sys.stdout

    counts: Counter = Counter()
    with open(argv[0]) as fh:
        for line in fh:
            t = line.split(" ")
            counts[classify_line(float(t[0]), t[1].strip())] += 1

    print("status", "correct", file=stdout)
    for key in ("coinf_correct", "coinf_incorrect", "pure_correct", "pure_incorrect"):
        status, correct = key.split("_")
        for _ in range(counts[key]):
            print(status, correct, file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
