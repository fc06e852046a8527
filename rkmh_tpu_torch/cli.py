"""Command line: ``rkmh-tpu-torch {stream|classify}``.

The flags are those of ``rkmh-tpu stream`` (``rkmh_tpu/cli.py``).  Ported:
``-r -f -k -s -N -D -t --batch-size --chunk-reads -o``, plus ``--device``
(``cuda`` by default, ``cpu`` for the plain path).  Every other flag of
``rkmh-tpu stream`` is parsed and rejected with an error naming it, so an
rkmh-tpu command line never runs with a flag silently dropped.
"""

from __future__ import annotations

import argparse
import sys

from rkmh_tpu_torch.device import DEFAULT_DEVICE

# (flags, dest, argparse keywords) of rkmh-tpu stream flags the port
# does not run yet
_NOT_PORTED = (
    (("-M", "--min-kmer-occurence"), "min_kmer_occ", {"type": int}),
    (("-I", "--max-samples"), "max_samples", {"type": int}),
    (("--counter-size",), "counter_size", {"type": int}),
    (("--ref-sketches",), "ref_sketches", {}),
    (("-R", "--pre-references"), "pre_references", {}),
    (("-F", "--pre-reads"), "pre_reads", {"action": "append"}),
    (("-p", "--read-kmer-map-file"), "read_kmer_map_file", {}),
    (("-q", "--ref-kmer-map-file"), "ref_kmer_map_file", {}),
    (("-d",), "dead_d", {"action": "store_true", "default": None}),
    (("-S", "--ref-sketch"), "ref_sketch", {"type": int}),
    (("-i", "--in-stream"), "in_stream", {"action": "store_true", "default": None}),
    (("-z", "--output-reads"), "output_reads", {"action": "store_true", "default": None}),
    (("-m", "--merge-sketch"), "merge_sketch", {"action": "store_true", "default": None}),
    (("--resume",), "resume", {"action": "store_true", "default": None}),
    (("--devices",), "devices", {"type": int}),
    (("--tp",), "tp", {"type": int}),
    (("--dist-coordinator",), "dist_coordinator", {}),
    (("--dist-procs",), "dist_procs", {"type": int}),
    (("--dist-rank",), "dist_rank", {"type": int}),
    (("--metrics",), "metrics", {"action": "store_true", "default": None}),
)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="rkmh-tpu-torch",
        description="MinHash read classification (rkmh capabilities) on PyTorch + CUDA.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    for name in ("classify", "stream"):
        p = sub.add_parser(name)
        p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
        p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
        p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
        p.add_argument("-s", "--sketch-size", type=int, default=1000)
        p.add_argument("-t", "--threads", type=int, default=1,
                       help="accepted for rkmh parity; no effect")
        p.add_argument("-N", "--min-matches", type=int, default=-1, dest="min_matches")
        p.add_argument("-D", "--min-diff", type=int, default=0, dest="min_diff")
        p.add_argument("--batch-size", type=int, default=0,
                       help="reads per device step; 0 = auto (16384 on cuda, 2048 on cpu)")
        p.add_argument("--chunk-reads", type=int, default=0,
                       help="reads parsed per streaming window; 0 = auto (65536)")
        p.add_argument("-o", "--output", default="", dest="out_file",
                       help="write classification lines here instead of stdout")
        p.add_argument("--device", default=DEFAULT_DEVICE,
                       help="cuda (default; an error without a GPU) or cpu")
        for flags, dest, kw in _NOT_PORTED:
            p.add_argument(*flags, dest=dest, help=argparse.SUPPRESS,
                           **{"default": None, **kw})
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    given = [flags[0] for flags, dest, _ in _NOT_PORTED
             if getattr(args, dest) not in (None, False)]
    if given:
        ap.error(f"{args.command}: {', '.join(given)} not yet ported to rkmh-tpu-torch")
    if args.command == "classify":
        print("classify is an alias of stream in rkmh; running stream.", file=sys.stderr)
    from rkmh_tpu_torch.commands.stream import StreamConfig, run

    try:
        return run(StreamConfig(
            ref_files=args.refs, read_files=args.reads, ks=tuple(args.ks),
            sketch_size=args.sketch_size, min_matches=args.min_matches,
            min_diff=args.min_diff, batch_size=args.batch_size,
            chunk_reads=args.chunk_reads, out_file=args.out_file, device=args.device,
        ))
    except (FileNotFoundError, IsADirectoryError, PermissionError) as e:
        print(f"rkmh-tpu-torch {args.command}: {e.strerror}: {e.filename}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0  # e.g. `rkmh-tpu-torch ... | head`


if __name__ == "__main__":
    sys.exit(main())
