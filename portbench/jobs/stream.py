"""``rkmh-tpu-torch stream`` in file mode: ``stream.run`` with the config
that ``-r REFS -f READS -k K -s S [-M M] [-I I]`` makes."""

from __future__ import annotations

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands import common, stream

SPANS = [(stream, "load_or_build_panel", "panel"),
         (stream, "count_read_kmers", "counter pass"),
         (common, "read_ahead", "input wait"),
         (engine, "classify_codes_table", "device step"),
         (stream._NativeFormatCtx, "format_block", "format")]


def run(inputs: dict, cfg: dict, traffic: dict, sink, stats: dict, device: str) -> int:
    fl = traffic["flags"]
    return stream.run(stream.StreamConfig(
        ref_files=[inputs["refs"]], read_files=[inputs["reads"]], ks=tuple(fl["ks"]),
        sketch_size=fl["sketch_size"], min_kmer_occ=fl.get("min_kmer_occ", -1),
        max_samples=fl.get("max_samples"), counter_size=cfg["counter_size"],
        device=device), out=sink)
