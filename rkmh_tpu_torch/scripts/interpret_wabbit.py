"""Human-readable interpretation of VW logit output.

Clean-room equivalent of scripts/interpret_wabbit.py (whose lineage /
sublineage branches are empty stubs); here all three modes work.
Input lines: ``logit tag``.
"""

from __future__ import annotations

import argparse
import sys

LINEAGES = {1: "A", 2: "B", 3: "C", 4: "D", 5: "coinfected"}
SUBLINEAGES = dict(
    enumerate(["A1", "A2", "A3", "A4", "B1", "B2", "C1", "D1", "D2", "D3"], start=1)
)


def interpret(kind: str, value: float, tag: str) -> str:
    if kind == "BINARY":
        if value > 0:
            return f"STATUS:COINF. Sample {tag} is coinfected. Logit score was {value}"
        if value == 0:
            return f"STATUS:UNKNOWN. Sample {tag} was inconclusive. Logit score was 0"
        return f"STATUS:PURE. Sample {tag} is not coinfected. Logit score was {value}"
    table = LINEAGES if kind == "LIN" else SUBLINEAGES
    name = table.get(int(value), "unknown")
    level = "lineage" if kind == "LIN" else "sublineage"
    return f"STATUS:{name}. Sample {tag} classified as {level} {name} (class {int(value)})"


def main(argv=None, stdout=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--infile", required=True)
    ap.add_argument("-T", "--type", default="BINARY", choices=["BINARY", "LIN", "SUB"])
    args = ap.parse_args(argv)
    stdout = stdout or sys.stdout

    with open(args.infile) as fh:
        for line in fh:
            t = line.split()
            if not t:
                continue
            tag = t[1] if len(t) > 1 else ""
            print(interpret(args.type, float(t[0]), tag), file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
