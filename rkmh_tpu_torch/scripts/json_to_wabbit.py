"""JSON sketch dumps -> Vowpal Wabbit vectors.

Clean-room equivalent of scripts/json_to_wabbit.py: each sketch record
becomes ``<label> 1.0 `name |f hash:1 ...`` (or hash:count with
--kollapse), label 1 when --coinf else 0.  Reads the schema written by
`rkmh-tpu hash -o` (io/sketch_json.py) or the reference's dump_hashes.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter


def record_to_vw(rec: dict, coinf: bool, kollapse: bool) -> str:
    name = "_".join(str(rec.get("name", "")).split("|"))
    hashes = rec.get("sketches", [])
    if isinstance(hashes, dict):
        hashes = hashes.get("hashes", [])
    if kollapse:
        c = Counter(hashes)
        feats = " ".join(f"{h}:{n}" for h, n in c.items())
    else:
        feats = " ".join(f"{h}:1" for h in hashes)
    return f"{1 if coinf else 0} 1.0 `{name} |f {feats}"


def main(argv=None, stdout=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--infile", required=True)
    ap.add_argument("-c", "--coinf", action="store_true")
    ap.add_argument("-k", "--kollapse", action="store_true")
    args = ap.parse_args(argv)
    stdout = stdout or sys.stdout

    with open(args.infile) as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        data = [data]
    for rec in data:
        print(record_to_vw(rec, args.coinf, args.kollapse), file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
