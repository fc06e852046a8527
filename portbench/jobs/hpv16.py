"""``rkmh-tpu-torch hpv16 -f READS -R REFPATH -k K``: ``hpv16_cmd.run``.
The tables' set-up laps (``Hpv16Tables.setup_s``, the program's own clock)
go to ``stats["tables_s"]``.  The job runs in the inputs' directory, where
its .tst side file lands."""

from __future__ import annotations

import contextlib

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands import common, hpv16_cmd

SPANS = [(hpv16_cmd, "build_tables", "tables"),
         (common, "read_ahead", "input wait"),
         (engine, "hpv16_batch_comb", "device step"),
         (hpv16_cmd, "format_read_lines", "format")]


def run(inputs: dict, cfg: dict, traffic: dict, sink, stats: dict, device: str) -> int:
    build = hpv16_cmd.build_tables

    def build_and_read_laps(*a, **kw):
        tb = build(*a, **kw)
        stats["tables_s"] = sum(tb.setup_s.values())
        return tb

    hpv16_cmd.build_tables = build_and_read_laps
    try:
        with contextlib.chdir(inputs["refpath"]):
            return hpv16_cmd.run(hpv16_cmd.Hpv16Config(
                read_files=[inputs["reads"]], refpath=inputs["refpath"],
                ks=tuple(traffic["flags"]["ks"]), device=device), out=sink)
    finally:
        hpv16_cmd.build_tables = build
