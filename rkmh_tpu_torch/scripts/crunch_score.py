"""Per-strain absolute error of a quant estimate vs filename truth.

Clean-room equivalent of scripts/crunch_score.py: the input file name
encodes the simulated composition (see score_test_data.truth_from_
filename); the file body holds ``STRAIN ESTIMATE`` lines.  Prints each
strain with estimate > 0.005 as ``strain truth est err`` followed by the
total error.
"""

from __future__ import annotations

import sys

from rkmh_tpu_torch.scripts.score_test_data import ALL_SUBLINS, truth_from_filename


def main(argv=None, stdout=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    stdout = stdout or sys.stdout
    path = argv[0]

    truth = truth_from_filename(path)
    est = dict.fromkeys(ALL_SUBLINS, 0.0)
    with open(path) as fh:
        for line in fh:
            if line[:2] in ALL_SUBLINS:
                t = line.split()
                est[t[0]] = float(t[1])

    total_err = 0.0
    for strain in sorted(truth):
        err = abs(est.get(strain, 0.0) - truth[strain])
        total_err += err
        if est.get(strain, 0.0) > 0.005:
            print(strain, truth[strain], est[strain], err, file=stdout)
    print(total_err, file=stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
