"""Sample-level lineage/sublineage prevalence from `hpv16` read output.

Clean-room equivalent of scripts/score_real_classification.py: consumes
the per-read hpv16 lines on stdin and emits one summary line with
lineage percentages, sublineage percentages, raw sublineage counts, and
INFO/WARN read-count tokens.

Decision rules (identical thresholds to the reference, lines cited):
* drop reads with total k-mers < 50 or HPV16 type matches < 15 (l.26-27)
* a lineage is called when its unique-kmer count > 5; on a second
  lineage match the scan stops but the FIRST match is kept (the
  reference's ambiguity reset is commented out, l.36-46)
* a sublineage needs count > 2 AND similarity > 0.005 (l.50)
* lineage/sublineage disagreement: if the top lineage is strong
  (count > 10) and the *second* sublineage agrees with it (count > 2),
  switch to that sublineage (logged to stderr); otherwise drop the
  sublineage call (l.56-68)
* totals < 1000 reads emit WARN tokens (l.93-102)
"""

from __future__ import annotations

import sys
from collections import Counter

MIN_READ_KMERS = 50
MIN_HPV_MATCHES = 15
LIN_COUNT_MIN = 6       # "> 5"
SUBLIN_COUNT_MIN = 3    # "> 2"
SUBLIN_SIM_MIN = 0.005


def _ranked(d: dict) -> str:
    """k:v pairs joined by ';', descending by value (dict_to_string)."""
    items = sorted(d.items(), key=lambda kv: float(kv[1]), reverse=True)
    return ";".join(f"{k}:{v}" for k, v in items)


def parse_read_line(line: str):
    """hpv16 line -> (hpv_match, total, [(lin, sim, count)], [(sub, sim, count)])."""
    t = line.split()
    match, total = (int(x) for x in t[2].split("/"))

    def pairs(simfield, countfield):
        sims = [p.split(":") for p in simfield.strip(";").split(";")]
        counts = [int(c) for c in countfield.strip(";").split(";")]
        return [(name, float(sim), n) for (name, sim), n in zip(sims, counts)]

    return match, total, pairs(t[3], t[5]), pairs(t[4], t[6])


def call_read(lins, subs):
    """Exclusive lineage + sublineage call for one read (or empty)."""
    l_match = ""
    for name, _sim, count in lins:
        if count >= LIN_COUNT_MIN:
            if l_match:
                break  # ambiguous: second lineage match voids nothing more
            l_match = name
    s_match = ""
    tripped = False
    for name, sim, count in subs:
        if count >= SUBLIN_COUNT_MIN and sim > SUBLIN_SIM_MIN:
            if tripped:
                break
            tripped = True
            s_match = name
    return l_match, s_match


def main(argv=None, stdin=None, stdout=None, stderr=None) -> int:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr

    lin_counts: Counter = Counter()
    sub_counts: Counter = Counter()

    for line in stdin:
        if not line.strip():
            continue
        hpv_match, total, lins, subs = parse_read_line(line)
        if total < MIN_READ_KMERS or hpv_match < MIN_HPV_MATCHES:
            continue
        l_match, s_match = call_read(lins, subs)

        # lineage/sublineage mismatch correction (reference l.56-68)
        if l_match and s_match and l_match != s_match[0]:
            top_lin_name, _, top_lin_count = lins[0]
            second = subs[1] if len(subs) > 1 else None
            if (
                top_lin_count > 10
                and second is not None
                and second[2] > 2
                and top_lin_name == second[0][0]
            ):
                stderr.write(
                    f"Lin / Sublin mistmatch: {l_match} {s_match}"
                    f" {s_match}->{second[0]}\n"
                )
                s_match = second[0]
            else:
                s_match = ""

        if l_match:
            lin_counts[l_match] += 1
        if s_match:
            sub_counts[s_match] += 1

    l_total = sum(lin_counts.values())
    s_total = sum(sub_counts.values())
    l_pct = {k: v / l_total for k, v in lin_counts.items()} if l_total else {}
    s_pct = {k: v / s_total for k, v in sub_counts.items()} if s_total else {}

    lin_note = ("WARN:low_lineage_counts:" if l_total < 1000 else "INFO:lineage_counts:") + str(l_total)
    sub_note = ("WARN:low_sublineage_counts:" if s_total < 1000 else "INFO:sublineage_counts:") + str(s_total)

    print(_ranked(l_pct), _ranked(s_pct), _ranked(dict(sub_counts)), lin_note, sub_note, file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
