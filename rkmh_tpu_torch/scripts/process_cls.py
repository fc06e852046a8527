"""Per-read truth/top-call extraction from hpv16 output.

Clean-room equivalent of scripts/process_cls.py (simulated reads; skips
names containing "rand"; columns 2/3) and process_cls_real_data.py
(columns 3/4), selected with --real-data.  Truth label comes from the
read name: token 2 of the '|'-split, up to the first '_' (the wgsim-
style naming of the bundled simulated reads).
"""

from __future__ import annotations

import argparse
import sys


def top_call(field: str) -> str:
    return field.strip().strip(";").split(";")[0]


def main(argv=None, stdout=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("--real-data", action="store_true",
                    help="use the real-data column layout (lin sims col 3, sublin col 4)")
    args = ap.parse_args(argv)
    stdout = stdout or sys.stdout

    a, b = (3, 4) if args.real_data else (2, 3)
    with open(args.infile) as fh:
        for line in fh:
            if not args.real_data and "rand" in line:
                continue
            t = [x.strip().strip(";") for x in line.rstrip("\n").split("\t")]
            truth = t[0].split("|")[2].split("_")[0]
            print(truth, top_call(t[a]), top_call(t[b]), file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
