"""stream's end-to-end seconds with the native parse on its reader thread
(``commands.common.read_ahead``, as shipped) against the parse inline
(``read_ahead`` replaced by the identity), in turns in one process on one
card: inline, ahead, ahead, inline.  Host time spreads widely between
calls, so the two compare only like this.

    python -m rkmh_tpu_torch.bench.read_ahead_ab [--reads N]

It writes the zika-shaped synthetic panel and N reads of 150 bp (default
2**20, ``rkmh_tpu_torch.synth``, seed 0) to a temporary directory, builds
the kernels in one small run that is not timed, then runs
``commands.stream.run`` (k=12, s=1000, device cuda) four times.  It
raises unless the four outputs are byte-identical.  Needs one CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from rkmh_tpu_torch import synth
from rkmh_tpu_torch.bench.timing import card_name_and_power_limit
from rkmh_tpu_torch.commands import common, stream


def run_once(refs: str, reads: str, out: str) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream.run(stream.StreamConfig(ref_files=[refs], read_files=[reads], ks=(12,),
                                   sketch_size=1000, out_file=out, device="cuda"))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    print(card_name_and_power_limit(), flush=True)
    shipped = common.read_ahead
    runs = {"inline": [], "ahead": []}
    outs = set()
    with tempfile.TemporaryDirectory() as d:
        refs, reads, _, _ = synth.write_workload(d, args.reads)
        small_dir = os.path.join(d, "small")
        _, small, _, _ = synth.write_workload(small_dir, 2000, seed=1)
        run_once(refs, small, os.path.join(d, "warm.tsv"))
        try:
            for label in ("inline", "ahead", "ahead", "inline"):
                common.read_ahead = shipped if label == "ahead" else (lambda items: items)
                out = os.path.join(d, f"{label}.tsv")
                runs[label].append(run_once(refs, reads, out))
                with open(out, "rb") as fh:
                    outs.add(fh.read())
        finally:
            common.read_ahead = shipped
    if len(outs) != 1:
        raise AssertionError("stream's output differs with and without the reader thread")
    print(f"stream e2e s on {args.reads} reads, parse on the reader thread (ahead) and inline, "
          "in turns: " + "; ".join(f"{k} {', '.join(f'{x:.3f}' for x in v)}"
                                   for k, v in runs.items()) + "; outputs byte-identical",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
