"""The tracer's cost a span (``observability.span``): N spans with tracing
off, then N inside a run under ``torch.profiler.profile`` (CPU activity, and
CUDA activity where a card is present), where each is recorded and opens a
``record_function``; the best of three passes each, and an empty loop's.

    python -m rkmh_tpu_torch.bench.span_cost [--spans N]

Prints one JSON line: the card's name and power limit, N, and the
microseconds an empty loop's pass and a span take, off and on.  Runs on the CPU too.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from rkmh_tpu_torch import observability
from rkmh_tpu_torch.bench.timing import card_name_and_power_limit


def _pass_us(n: int, with_span: bool) -> float:
    t0 = time.perf_counter()
    if with_span:
        for _ in range(n):
            with observability.span("bench"):
                pass
    else:
        for _ in range(n):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=10**5)
    n = ap.parse_args(argv).spans
    loop = min(_pass_us(n, False) for _ in range(3))
    off = min(_pass_us(n, True) for _ in range(3))
    with observability._profiler(), observability.run_scope("span_cost"):
        on = min(_pass_us(n, True) for _ in range(3))
    recorded = len(observability.finished_runs()[-1].spans)
    if recorded != 3 * n + 1:  # the passes' spans and the root
        raise RuntimeError(f"{recorded} spans recorded of {3 * n + 1}")
    card = card_name_and_power_limit() if torch.cuda.is_available() else "cpu"
    print(json.dumps({"card": card, "spans": n, "loop_us": loop, "off_us": off, "on_us": on}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
