"""The benchmark's control: the plain reference put in the program's place,
with one of the hash's guarantees broken, judged as a run's output is.

    python3 -m portbench.control --config CONFIG --traffic TRAFFIC --seed N [--seed M ...]

For each seed it makes a cell's inputs at their full size, computes the
reference's output, then the output of the reference with the control's
switch (``CONTROLS``, by the traffic's command) and prints the lines that
differ, the number ``lines_wrong`` a run is held to with limit 0.  A
control must read above the limit on every seed: a sound run of the
program reads 0, and the limit has room on both sides only if the control
reads well above it.

* stream, hpv16: hashes kept to their low 32 bits (the nearest width below
  the 64 bits rkmh's MurmurHash3 gives, the step a change that halves the
  hash traffic would take);
* call: k-mers hashed as read, not as the smaller of the two strands
  (rkmh's canonical hashing, rkmh.cpp:494-497): at this size the depth
  map's 2.1 M keys collide too rarely at 32 bits to change a record.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

from portbench import gen
from portbench.run import CACHE, HERE, lines_wrong, load_json

CONTROLS = {"stream": {"hash_bits": 32}, "hpv16": {"hash_bits": 32},
            "call": {"canonical": False}}


def control_reading(cfg: dict, traffic: dict, seed: int, device: str) -> dict:
    """-> {seed, lines, lines_wrong, seconds} of the control on one seed."""
    inputs = gen.make_inputs(cfg, traffic, seed, os.path.join(CACHE, "inputs"))
    ref = importlib.import_module(f"portbench.reference.{traffic['command']}")
    t = time.perf_counter()
    text, _ = ref.expected(inputs, cfg, traffic, device)
    ctl, _ = ref.expected(inputs, cfg, traffic, device, **CONTROLS[traffic["command"]])
    return {"seed": seed, "lines": text.count("\n"), "lines_wrong": lines_wrong(text, ctl),
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = load_json(HERE, "configs", f"{args.config}.json")
    traffic = load_json(HERE, "traffic", f"{args.traffic}.json")
    for seed in args.seed:
        r = control_reading(cfg, traffic, seed, args.device)
        print(json.dumps({"config": args.config, "traffic": args.traffic, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
