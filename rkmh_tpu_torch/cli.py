"""Command line: ``rkmh-tpu-torch {stream|classify|filter|hpv16}``.

The flags are those of ``rkmh-tpu`` (``rkmh_tpu/cli.py``), plus
``--device`` (``cuda`` by default, ``cpu`` for the plain path).  Ported:
``stream``'s ``-r -f -k -s -M -N -D -I -t --counter-size --batch-size
--chunk-reads -o``, ``filter``'s ``-r -f -k -s -M -N -D -I -i -t
--counter-size --batch-size --chunk-reads -o`` and ``hpv16``'s ``-f -R
-k -s -M -t -N -D --counter-size --batch-size --chunk-reads -o``.
``stream -i`` (and ``classify -i``) with ``-f`` runs as in rkmh-tpu: it
logs that -i is ignored and classifies the files.  rkmh's dead parity
flags (``-S -F -p -q -d``, and ``-z -m`` for stream) are accepted with
rkmh-tpu's warnings.  Every other flag (``--ref-sketches``, ``-R`` of
stream and filter, ``--resume``, ``--devices``, ``--tp``, ``--dist-*``,
``--metrics``, and ``-i`` of stream without ``-f``) is parsed and
rejected with an error naming it (for ``hpv16``: when it would change
what runs, ``commands.hpv16_cmd.not_ported``), so an rkmh-tpu command
line never runs with a flag silently dropped.
"""

from __future__ import annotations

import argparse
import sys

from rkmh_tpu_torch.device import DEFAULT_DEVICE

# (flags, dest, argparse keywords) of rkmh-tpu stream/filter flags the
# port does not run yet (stream -i: only without -f, checked in main)
_NOT_PORTED = (
    (("--ref-sketches",), "ref_sketches", {}),
    (("-R", "--pre-references"), "pre_references", {}),
    (("--resume",), "resume", {"action": "store_true", "default": None}),
    (("--devices",), "devices", {"type": int}),
    (("--tp",), "tp", {"type": int}),
    (("--dist-coordinator",), "dist_coordinator", {}),
    (("--dist-procs",), "dist_procs", {"type": int}),
    (("--dist-rank",), "dist_rank", {"type": int}),
    (("--metrics",), "metrics", {"action": "store_true", "default": None}),
)


def _add_dead_flags(p, stream: bool) -> None:
    """rkmh's parsed-but-dead flags (rkmh.cpp:639-642, 659-669, 697-700):
    accepted, as rkmh-tpu accepts them; _warn_dead_flags warns."""
    hidden = argparse.SUPPRESS
    p.add_argument("-S", "--ref-sketch", type=int, default=None, help=hidden)
    p.add_argument("-F", "--pre-reads", action="append", default=[], dest="pre_reads",
                   help=hidden)
    p.add_argument("-p", "--read-kmer-map-file", default="", dest="read_kmer_map_file",
                   help=hidden)
    p.add_argument("-q", "--ref-kmer-map-file", default="", dest="ref_kmer_map_file",
                   help=hidden)
    p.add_argument("-d", action="store_true", dest="dead_d", help=hidden)
    if stream:
        p.add_argument("-z", "--output-reads", action="store_true", help=hidden)
        p.add_argument("-m", "--merge-sketch", action="store_true", help=hidden)


def _warn_dead_flags(args) -> None:
    """The warnings of rkmh_tpu/cli.py:291-319, in its order."""
    for flag, name in (("output_reads", "-z"), ("merge_sketch", "-m")):
        if getattr(args, flag, False):
            print(f"warning: stream {name} is parsed but dead in rkmh too "
                  f"(rkmh.cpp:608-714); ignored.", file=sys.stderr)
    for val, name in ((args.pre_reads, "-F"), (args.read_kmer_map_file, "-p"),
                      (args.ref_kmer_map_file, "-q")):
        if val:
            print(f"warning: {name} is parsed but dead in rkmh too "
                  f"(rkmh.cpp:744-769 commented out); ignored.", file=sys.stderr)


def _add_classify_parser(sub, name: str):
    """stream, classify and filter: rkmh-tpu's flags and defaults
    (rkmh_tpu/cli.py:16-128)."""
    p = sub.add_parser(name)
    p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-s", "--sketch-size", type=int, default=1000)
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for rkmh parity; no effect")
    p.add_argument("-M", "--min-kmer-occurence", type=int, default=-1, dest="min_kmer_occ",
                   help="drop read k-mers seen fewer times than this over all reads")
    p.add_argument("-N", "--min-matches", type=int, default=-1, dest="min_matches")
    p.add_argument("-D", "--min-diff", type=int, default=0, dest="min_diff")
    p.add_argument("-I", "--max-samples", type=int, default=None, dest="max_samples",
                   help="sketch references from k-mers seen in at most this many samples")
    p.add_argument("--counter-size", type=int,
                   default=10_000_000 if name == "filter" else 200_000_000,
                   help="slots of each -M/-I k-mer counter (rkmh's HASHTCounter size)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="reads per device step; 0 = auto (16384 on cuda, 2048 on cpu)")
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads parsed per streaming window; 0 = auto (65536)")
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write the output here instead of stdout")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default; an error without a GPU) or cpu")
    _add_dead_flags(p, stream=name != "filter")
    p.add_argument("-i", "--in-stream", action="store_true", dest="in_stream",
                   help="classify reads from stdin" if name == "filter" else
                   "ignored with -f, as in rkmh (stdin streaming is not ported yet)")
    for flags, dest, kw in _NOT_PORTED:
        p.add_argument(*flags, dest=dest, help=argparse.SUPPRESS, **{"default": None, **kw})


def _add_hpv16_parser(sub):
    p = sub.add_parser("hpv16")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-R", "--refpath", default="data")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-s", "--sketch", type=int, default=4000)
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
    p.add_argument("-M", "--min-kmer-occurence", type=int, default=0, dest="min_kmer_occ",
                   help="drop read k-mers seen fewer times than this over all reads")
    p.add_argument("--counter-size", type=int, default=800_000_000,
                   help="slots of -M's k-mer counter (rkmh's HASHTCounter size)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default; an error without a GPU) or cpu")
    # rkmh-tpu hpv16 flags with rkmh-tpu's defaults, not run by the port yet
    hidden = argparse.SUPPRESS
    p.add_argument("--resume", action="store_true", help=hidden)
    p.add_argument("--devices", type=int, default=0, help=hidden)
    p.add_argument("--tp", type=int, default=1, help=hidden)
    p.add_argument("--dist-coordinator", default="", help=hidden)
    p.add_argument("--dist-procs", type=int, default=0, help=hidden)
    p.add_argument("--dist-rank", type=int, default=-1, help=hidden)
    p.add_argument("--metrics", action="store_true", help=hidden)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="rkmh-tpu-torch",
        description="MinHash read classification (rkmh capabilities) on PyTorch + CUDA.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    for name in ("classify", "stream", "filter"):
        _add_classify_parser(sub, name)
    _add_hpv16_parser(sub)
    return ap


def _run_stream(args):
    if args.command == "classify":
        print("classify is an alias of stream in rkmh; running stream.", file=sys.stderr)
    _warn_dead_flags(args)
    from rkmh_tpu_torch.commands.stream import StreamConfig, run

    return run(StreamConfig(
        ref_files=args.refs, read_files=args.reads, ks=tuple(args.ks),
        sketch_size=args.sketch_size, min_kmer_occ=args.min_kmer_occ,
        min_matches=args.min_matches, min_diff=args.min_diff,
        max_samples=args.max_samples, counter_size=args.counter_size,
        batch_size=args.batch_size, chunk_reads=args.chunk_reads,
        out_file=args.out_file, in_stream=args.in_stream, device=args.device,
    ))


def _run_filter(args):
    _warn_dead_flags(args)
    from rkmh_tpu_torch.commands.filter_cmd import FilterConfig, run

    return run(FilterConfig(
        ref_files=args.refs, read_files=args.reads, ks=tuple(args.ks),
        sketch_size=args.sketch_size, min_kmer_occ=args.min_kmer_occ,
        min_matches=args.min_matches, min_diff=args.min_diff,
        max_samples=args.max_samples, in_stream=args.in_stream,
        counter_size=args.counter_size, batch_size=args.batch_size,
        chunk_reads=args.chunk_reads, out_file=args.out_file, device=args.device,
    ))


def _hpv16_config(args):
    from rkmh_tpu_torch.commands.hpv16_cmd import Hpv16Config

    return Hpv16Config(
        read_files=args.reads, refpath=args.refpath, ks=tuple(args.ks),
        sketch_size=args.sketch, min_kmer_occ=args.min_kmer_occ,
        min_matches=args.min_matches, min_diff=args.min_diff,
        counter_size=args.counter_size, batch_size=args.batch_size,
        chunk_reads=args.chunk_reads, out_file=args.out_file, resume=args.resume,
        devices=args.devices, tp=args.tp, dist_coordinator=args.dist_coordinator,
        dist_procs=args.dist_procs, dist_rank=args.dist_rank, device=args.device,
    )


def _run_hpv16(cfg):
    if cfg.min_matches != -1 or cfg.min_diff:
        print("warning: hpv16 -N/-D are parsed but dead in rkmh too "
              "(declared rkmh.cpp:2371-2372, never read); ignored.", file=sys.stderr)
    from rkmh_tpu_torch.commands.hpv16_cmd import run

    return run(cfg)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.command == "hpv16":
        from rkmh_tpu_torch.commands.hpv16_cmd import not_ported

        cfg = _hpv16_config(args)
        given = not_ported(cfg) + (["--metrics"] if args.metrics else [])
    else:
        given = [flags[0] for flags, dest, _ in _NOT_PORTED
                 if getattr(args, dest) is not None]  # given (--dist-rank 0 too)
        if args.command != "filter" and args.in_stream and not args.reads:
            given.append("-i")  # stdin streaming (rkmh_tpu/commands/stream.py:315)
    if given:
        ap.error(f"{args.command}: {', '.join(given)} not yet ported to rkmh-tpu-torch")
    run = {"hpv16": lambda: _run_hpv16(cfg), "filter": lambda: _run_filter(args)}.get(
        args.command, lambda: _run_stream(args))
    try:
        return run()
    except (FileNotFoundError, IsADirectoryError, PermissionError) as e:
        print(f"rkmh-tpu-torch {args.command}: {e.strerror}: {e.filename}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0  # e.g. `rkmh-tpu-torch ... | head`


if __name__ == "__main__":
    sys.exit(main())
