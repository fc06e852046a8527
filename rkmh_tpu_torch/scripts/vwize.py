"""rkmh classification output -> Vowpal Wabbit training vectors.

Clean-room equivalent of scripts/vwize.py: quantifies per-strain read
counts from one or more classification files (field 1 of each tab line,
second space token, first char when collapsing) and emits one VW line
per file:

    <label> 1.0 '<tag> |vir STRAIN:count ...

Binary mode labels 1 (coinfected) / -1; --multiclass maps lineages
A..D + coinfected to classes 1..5 (or a --predict TSV mapping);
--normalize divides counts by the file total.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

MULTICLASS = {"A": "1", "B": "2", "C": "3", "D": "4", "coinfected": "5"}


def quantify(path: str, strains, collapse: bool,
             fmt: str = "cls") -> Counter:
    """Per-strain read counts from a classification file.

    fmt="cls": the reference's filter-streaming layout — field 1 is
    ``Result: <strain> ...`` (rkmh.cpp:1397-1399), strain = second space
    token.  fmt="stream": native stream/classify output — field 0 is the
    winning reference name (``ref\\tread\\tshared...``), strain = its
    first space token (e.g. "A1" for data/new_refs.fa headers).
    """
    counts: Counter = Counter()
    for s in strains or ():
        counts[s] = 0
    with open(path) as fh:
        for line in fh:
            t = line.split("\t")
            try:
                if fmt == "stream":
                    cls = t[0].strip().split(" ")[0]
                    if not cls:
                        raise IndexError
                else:
                    cls = t[1].strip().split(" ")[1]
                if collapse:
                    cls = cls[0]
            except IndexError:
                cls = "U" if collapse else "unclassified"
            counts[cls] += 1
    return counts


def vw_line(counts: Counter, label: str, tag: str, normalize: bool) -> str:
    total = sum(counts.values()) or 1
    feats = " ".join(
        f"{name}:{count / total if normalize else count}"
        for name, count in counts.items()
    )
    return f"{label} 1.0 '{tag} |vir {feats}"


def main(argv=None, stdout=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-s", "--strains", nargs="+", default=None)
    ap.add_argument("-i", "--input", dest="files", nargs="+", required=True)
    ap.add_argument("-K", "--kmer", type=int, default=16)
    ap.add_argument("-N", "--sketchSize", type=int, default=1000)
    ap.add_argument("-C", "--coinf", type=int, nargs="+", required=True)
    ap.add_argument("-M", "--multiclass", action="store_true")
    ap.add_argument("-n", "--normalize", action="store_true")
    ap.add_argument("-c", "--collapse", action="store_true")
    ap.add_argument("-L", "--label", default="hpv")
    ap.add_argument("-P", "--predict", default=None,
                    help="TSV strain->class mapping; implies --multiclass")
    ap.add_argument("--format", choices=("cls", "stream"), default="cls",
                    help="input layout: 'cls' = filter-streaming lines "
                         "(Result: <strain>), 'stream' = native "
                         "stream/classify lines (field 0 = ref name)")
    args = ap.parse_args(argv)
    stdout = stdout or sys.stdout

    class_map = dict(MULTICLASS)
    if args.predict:
        args.multiclass = True
        class_map = {}
        with open(args.predict) as fh:
            for line in fh:
                k, v = line.split("\t")[:2]
                class_map[k] = str(int(v))

    for path, coinf in zip(args.files, args.coinf):
        counts = quantify(path, args.strains, args.collapse, args.format)
        if args.multiclass:
            # truth key from the filename (make_mix convention): the full
            # first underscore token when the -P map knows it (sublineage
            # models), else its first char (lineage models, the
            # reference's behavior)
            tok = os.path.basename(path).split("_")[0]
            key = ("coinfected" if coinf
                   else tok if tok in class_map else tok[:1])
            label = class_map[key]
        else:
            label = "1" if coinf else "-1"
        print(vw_line(counts, label, args.label, args.normalize), file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
