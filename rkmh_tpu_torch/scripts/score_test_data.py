"""Score a simulated-coinfection hpv16 output file against the truth
encoded in its filename.

Clean-room equivalent of scripts/score_test_data.py.  Filenames look
like ``1088_D3_0-0.25_C_0-0.20_A4_0-0.54_4941_.fq``: alternating strain
tokens and ``0-<proportion>`` tokens, a bare ``C`` meaning C1.  A read
votes for every lineage/sublineage with similarity > 0.01 (inclusive,
unlike the exclusive real-data scorer).  Emits the primary/secondary
detection verdicts and total absolute composition error.
"""

from __future__ import annotations

import sys
from collections import Counter

ALL_SUBLINS = ["A1", "A2", "A3", "A4", "B1", "B2", "C1", "D1", "D2", "D3"]
SIM_THRESHOLD = 0.01


def truth_from_filename(name: str) -> dict[str, float]:
    import os

    name = os.path.basename(name)  # the reference assumes a local filename
    # the reference does name.replace("C", "C1"), which mangles filenames
    # already containing C1 into C11 — map the bare token only
    toks = ["C1" if t == "C" else t for t in name.split("_")]
    strains = toks[1:-2:2]
    amts = [float(a.split("-")[1]) for a in name.split("_")[2:-2:2]]
    truth = dict.fromkeys(ALL_SUBLINS, 0.0)
    truth.update(dict(zip(strains, amts)))
    return truth


def vote_counts(fh) -> tuple[Counter, Counter]:
    lin_votes: Counter = Counter()
    sub_votes: Counter = Counter()
    for line in fh:
        t = line.split()
        for field, votes in ((t[3], lin_votes), (t[4], sub_votes)):
            for pair in field.strip(";").split(";"):
                name, sim = pair.split(":")
                if float(sim) > SIM_THRESHOLD:
                    votes[name] += 1
    return lin_votes, sub_votes


def main(argv=None, stdout=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    stdout = stdout or sys.stdout
    path = argv[0]

    truth = truth_from_filename(path)
    with open(path) as fh:
        _lin_votes, sub_votes = vote_counts(fh)

    s_total = sum(sub_votes.values())
    est = {k: v / s_total for k, v in sub_votes.items()} if s_total else {}

    strains = [s for s in truth if truth[s] > 0]
    strains.sort(key=lambda s: -truth[s])
    est_rank = sorted(est, key=lambda s: -est[s])

    total_err = sum(abs(est.get(s, 0.0) - truth[s]) for s in truth)
    primary, secondary = strains[0], strains[1] if len(strains) > 1 else ""
    correct_primary = bool(est_rank) and est_rank[0] == primary
    correct_secondary = len(est_rank) > 1 and est_rank[1] == secondary
    flipped = (
        len(est_rank) > 1 and est_rank[0] == secondary and est_rank[1] == primary
    )
    diff = abs(truth[primary] - truth.get(secondary, 0.0))
    sdiff = abs(truth[strains[1]] - truth[strains[2]]) if len(strains) >= 3 else 0.0
    primary_detected = (
        est.get(primary, 0.0) > 0.05
        and abs(est.get(primary, 0.0) - truth[primary]) < 0.1
    )
    secondary_detected = (
        bool(secondary) and abs(est.get(secondary, 0.0) - truth[secondary]) < 0.1
    )
    n_present = len([s for s in truth if truth[s] > 0.005])

    print(
        correct_primary, correct_secondary, flipped,
        primary_detected, secondary_detected, n_present,
        diff, sdiff, total_err, dict(truth), est, path,
        file=stdout,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
