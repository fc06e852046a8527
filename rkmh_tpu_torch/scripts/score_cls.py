"""Accuracy + composition estimates from process_cls output.

Clean-room equivalent of scripts/score_cls.py: stdin lines of
``truth lin:sim sublin:sim``; prints per-sublineage accuracy at the
lineage and sublineage level, then the estimated sublineage composition
over reads whose sublineage similarity exceeds 0.01.  Bare "C" truth
labels normalize to C1 as in the reference.
"""

from __future__ import annotations

import sys
from collections import Counter


def main(argv=None, stdin=None, stdout=None) -> int:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout

    correct_lin: Counter = Counter()
    wrong_lin: Counter = Counter()
    correct_sub: Counter = Counter()
    wrong_sub: Counter = Counter()
    comp: Counter = Counter()

    for line in stdin:
        t = line.split()
        truth = "C1" if t[0] == "C" else t[0]
        lin_name, lin_sim = t[1].split(":")
        sub_name, sub_sim = t[2].split(":")

        if truth[0] == lin_name[0] and float(lin_sim) > 0.0:
            correct_lin[truth] += 1
        else:
            wrong_lin[truth] += 1
        if truth == sub_name and float(sub_sim) > 0.0:
            correct_sub[truth] += 1
        else:
            wrong_sub[truth] += 1
        if float(sub_sim) > 0.01:
            comp[sub_name] += 1

    print("Sublins: % correct sublineage: % correct lineage", file=stdout)
    for name in correct_sub:
        sub_acc = correct_sub[name] / (correct_sub[name] + wrong_sub[name])
        lin_acc = correct_lin[name] / (correct_lin[name] + wrong_lin[name])
        print(name, sub_acc, lin_acc, file=stdout)
    print(file=stdout)

    total = sum(comp.values())
    print("Estimated sublineage composition", file=stdout)
    for name in comp:
        print(name, comp[name] / total, file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
