"""``rkmh-tpu-torch call -r REF -f READS -k K -w W``: ``call_cmd.run``, with
the program's phase seconds (``stats=``); the depth map's four phases go to
``stats["depth_map_s"]``."""

from __future__ import annotations

from rkmh_tpu_torch import call_engine
from rkmh_tpu_torch.commands import call_cmd

SPANS = [(call_cmd, "load_records", "parse refs"),
         (call_cmd, "load_packed", "parse reads"),
         (call_cmd, "build_depth_map", "depth map"),
         (call_engine, "call_scan_ref", "scan"),
         (call_cmd, "extract_records", "records")]

DEPTH_MAP_PHASES = ("read_hashing_s", "map_unique_s", "map_layout_s", "map_copy_s")


def run(inputs: dict, cfg: dict, traffic: dict, sink, stats: dict, device: str) -> int:
    fl = traffic["flags"]
    phases: dict = {}
    rc = call_cmd.run(call_cmd.CallConfig(
        ref_files=[inputs["refs"]], read_files=[inputs["reads"]], ks=tuple(fl["ks"]),
        window_len=fl["window_len"], device=device), out=sink, stats=phases)
    if all(p in phases for p in DEPTH_MAP_PHASES):
        stats["depth_map_s"] = sum(phases[p] for p in DEPTH_MAP_PHASES)
    return rc
