"""Command line: ``rkmh-tpu-torch {stream|classify|filter|hpv16|hash|count|search|call}``.

The flags are those of ``rkmh-tpu`` (``rkmh_tpu/cli.py``), with its
defaults, plus ``--device`` (``cuda`` by default, ``cpu`` for the plain
path).  Ported: ``stream``'s ``-r -f -k -s -M -N -D -I -i -t --counter-size
--batch-size --chunk-reads --ref-sketches -R -o --resume``, ``filter``'s
``-r -f -k -s -M -N -D -I -i -t --counter-size --batch-size --chunk-reads
--ref-sketches -R -o --resume``, ``hpv16``'s ``-f -R -k -s -M -t -N -D
--counter-size --batch-size --chunk-reads -o --resume --devices --tp``,
``hash``'s ``-f -r -k -s -t -K -w -c -o --json --sourmash --batch-size
--chunk-reads --out --resume`` (``-M -I -m -T`` accepted with rkmh-tpu's
warnings), ``count``'s ``-f -k -t --counter-size --batch-size -o --dump
--chunk-reads``, ``search``'s ``-f -r -k -t --batch-size --chunk-reads
-o --resume`` and ``call``'s ``-r -f -k -s -t -w -d -o --resume
--devices`` (``-s`` and ``-t`` accepted and unused, as in rkmh-tpu).
``-R`` of stream and
filter is an alias of ``--ref-sketches`` (rkmh's own -R is dead), with
rkmh-tpu's warning when both are given.  ``stream -i`` (and ``classify
-i``) classifies stdin, flushed batch by batch; with ``-f`` it logs that
-i is ignored and classifies the files, as rkmh-tpu does.  rkmh's dead
parity flags (``-S -F -p -q -d``, and ``-z -m`` for stream) are accepted
with rkmh-tpu's warnings.  Every command takes ``--metrics`` (one JSON
line of counts and rates on stderr at exit, as ``RKMH_TPU_METRICS=1``
does; ``RKMH_TPU_PROFILE=<dir>`` adds a profiler trace:
``observability.py``).  ``--devices N`` (with ``--tp T`` for
``stream``, ``classify`` and ``filter``) runs ``stream``, ``classify``,
``filter``, ``hash``, ``count`` and ``search`` over N devices of the
machine (``parallel/``), with rkmh-tpu's defaults (0 and 1) and its
logged fallback to one device where the geometry cannot apply;
``hpv16 --devices N --tp T`` shards its reads over dp = N / T and its set
table over T of them, and ``call --devices N`` its reference positions
over N, with their own fallback lines.  ``--dist-coordinator HOST:PORT
--dist-procs N --dist-rank R`` run one rank of a multi-process run of
any command (``commands/dist_stream.py``; merge the stripes with
``rkmh-tpu-torch-dist-merge``; ``count``'s rank 0 writes the one table).
"""

from __future__ import annotations

import argparse
import sys

from rkmh_tpu_torch.device import DEFAULT_DEVICE

_MERGE = ", merge with rkmh-tpu-torch-dist-merge"  # the --dist-rank help's end


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


def _add_dist(p, writes: str = "-o FILE writes FILE.<rank>" + _MERGE) -> None:
    """--dist-* with rkmh-tpu's defaults (rkmh_tpu/cli.py:91-100, 121-128,
    162-168, 183-189, 208-214, 232-235, 264-270)."""
    p.add_argument("--dist-coordinator", default="", dest="dist_coordinator",
                   help="host:port of rank 0's rendezvous (multi-process; or "
                        "JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--dist-procs", type=int, default=0, dest="dist_procs",
                   help="the number of processes (or JAX_NUM_PROCESSES)")
    p.add_argument("--dist-rank", type=int, default=-1, dest="dist_rank",
                   help=f"this process's rank (or JAX_PROCESS_ID); {writes}")


def _add_devices(p, tp: bool) -> None:
    """--devices (and --tp) with rkmh-tpu's defaults (rkmh_tpu/cli.py:84-90,
    154-155)."""
    p.add_argument("--devices", type=int, default=0,
                   help="run over N local devices (reads data-parallel); 0 = one device")
    if tp:
        p.add_argument("--tp", type=int, default=1,
                       help="shard the reference panel over T of the --devices "
                            "(devices = dp x tp)")


def _warn_dead_flags(args) -> None:
    """The warnings of rkmh_tpu/cli.py:291-319, in its order; -R becomes
    --ref-sketches (rkmh_tpu/cli.py:262-269)."""
    for flag, name in (("output_reads", "-z"), ("merge_sketch", "-m")):
        if getattr(args, flag, False):
            print(f"warning: stream {name} is parsed but dead in rkmh too "
                  f"(rkmh.cpp:608-714); ignored.", file=sys.stderr)
    if args.pre_references:
        if args.ref_sketches:
            print("warning: both -R and --ref-sketches given; using "
                  "--ref-sketches.", file=sys.stderr)
        else:
            args.ref_sketches = args.pre_references
    for val, name in ((args.pre_reads, "-F"), (args.read_kmer_map_file, "-p"),
                      (args.ref_kmer_map_file, "-q")):
        if val:
            print(f"warning: {name} is parsed but dead in rkmh too "
                  f"(rkmh.cpp:744-769 commented out); ignored.", file=sys.stderr)


def _add_run_flags(p) -> None:
    """--batch-size, --chunk-reads and --device, which every command takes."""
    p.add_argument("--batch-size", type=int, default=0,
                   help="reads per device step; 0 = auto (16384 on cuda, 2048 on cpu)")
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads parsed per streaming window; 0 = auto (65536)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default; an error without a GPU) or cpu")


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
    _add_run_flags(p)
    p.add_argument("--ref-sketches", default="",
                   help="take the panel from a JSON sketch file (hash -o, sourmash, "
                        "mash info -d) in place of hashing -r files")
    p.add_argument("-R", "--pre-references", default="", dest="pre_references",
                   help="alias of --ref-sketches (rkmh's -R is parsed but dead)")
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write the output here instead of stdout")
    p.add_argument("--resume", action="store_true",
                   help="go on with an interrupted -o run: skip the reads already "
                        "written, append the rest")
    _add_dead_flags(p, stream=name != "filter")
    p.add_argument("-i", "--in-stream", action="store_true", dest="in_stream",
                   help="classify reads from stdin (ignored with -f, as in rkmh)")
    _add_devices(p, tp=True)
    _add_dist(p)


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
    _add_run_flags(p)
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write classification lines here instead of stdout")
    p.add_argument("-M", "--min-kmer-occurence", type=int, default=0, dest="min_kmer_occ",
                   help="drop read k-mers seen fewer times than this over all reads")
    p.add_argument("--counter-size", type=int, default=800_000_000,
                   help="slots of -M's k-mer counter (rkmh's HASHTCounter size)")
    p.add_argument("--resume", action="store_true",
                   help="go on with an interrupted -o run: skip the reads already "
                        "written, append the rest")
    p.add_argument("--devices", type=int, default=0,
                   help="classify reads data-parallel over N local devices; 0 = one device")
    p.add_argument("--tp", type=int, default=1,
                   help="shard the combined type + group set table over T of the "
                        "--devices (devices = dp x tp)")
    _add_dist(p)


def _add_hash_parsers(sub) -> None:
    """hash, count and search: rkmh-tpu's flags and defaults
    (rkmh_tpu/cli.py:130-214)."""
    p = sub.add_parser("hash")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-s", "--sketch-size", type=int, default=0)
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for rkmh parity; no effect")
    p.add_argument("-K", "--output-kmers", action="store_true")
    p.add_argument("-w", "--wabbitize", action="store_true")
    p.add_argument("-c", "--count", action="store_true", dest="output_counts")
    p.add_argument("-M", "--min-kmer-occurence", type=int, default=0, dest="min_kmer_occ",
                   help=argparse.SUPPRESS)  # dead in rkmh (rkmh.cpp:2109-2111)
    p.add_argument("-I", "--max-samples", type=int, default=None, dest="max_samples",
                   help=argparse.SUPPRESS)
    p.add_argument("-m", "--merge-sample", action="store_true", dest="merge_sample",
                   help=argparse.SUPPRESS)
    p.add_argument("-T", action="store_true", dest="traditional_minhash",
                   help=argparse.SUPPRESS)
    p.add_argument("-o", "--out-prefix", default="",
                   help="write the sketches to PREFIX.rkmh.json (PREFIX.sig with --sourmash)")
    p.add_argument("--json", action="store_true", help="emit Mash/sourmash-style JSON sketches")
    p.add_argument("--sourmash", action="store_true",
                   help="emit sourmash_signature JSON (single -k sketches only)")
    _add_run_flags(p)
    p.add_argument("--out", default="", dest="out_file", help="write the lines here")
    p.add_argument("--resume", action="store_true",
                   help="go on with an interrupted --out run")
    _add_devices(p, tp=False)
    _add_dist(p, "--out FILE writes FILE.<rank>" + _MERGE)

    p = sub.add_parser("count")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for rkmh parity; no effect")
    p.add_argument("--counter-size", type=int, default=640_000)  # rkmh.cpp:2322
    p.add_argument("-o", "--out-file", default="", help="save the counter table (npz)")
    p.add_argument("--dump", action="store_true", help="print the occupied slots")
    _add_run_flags(p)
    _add_devices(p, tp=False)
    _add_dist(p, "rank 0 writes -o and --dump")

    p = sub.add_parser("search")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for rkmh parity; no effect")
    _add_run_flags(p)
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write the match lines here")
    p.add_argument("--resume", action="store_true", help="go on with an interrupted -o run")
    _add_devices(p, tp=False)
    _add_dist(p, "-o FILE writes FILE.<rank> and FILE.<rank>.idx" + _MERGE)


def _add_call_parser(sub):
    """call: rkmh-tpu's flags and defaults (rkmh_tpu/cli.py:216-235)."""
    p = sub.add_parser("call")
    p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-s", "--sketch", type=int, default=1000,
                   help="accepted for rkmh parity; no effect")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for rkmh parity; no effect")
    p.add_argument("-w", "--window-len", type=int, default=100)
    p.add_argument("-d", "--show-depth", action="store_true")
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write the VCF here (required for --resume)")
    p.add_argument("--resume", action="store_true",
                   help="skip references whose partial aggregates are already "
                        "checkpointed in <out>.progress")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default; an error without a GPU) or cpu")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the positional scan over N local devices (reference "
                        "positions data-parallel); 0 = one device")
    _add_dist(p, "-o FILE writes partial sections to FILE.<rank>" + _MERGE)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="rkmh-tpu-torch",
        description="MinHash read classification (rkmh capabilities) on PyTorch + CUDA.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    add_parser = sub.add_parser

    def _add_parser(*a, **kw):  # every command takes --metrics (rkmh_tpu/cli.py:62-67)
        p = add_parser(*a, **kw)
        p.add_argument("--metrics", action="store_true",
                       help="emit one JSON metrics line (reads/s, bp/s, timers) to stderr; "
                            "RKMH_TPU_PROFILE=<dir> additionally writes a profiler trace")
        return p

    sub.add_parser = _add_parser
    for name in ("classify", "stream", "filter"):
        _add_classify_parser(sub, name)
    _add_hpv16_parser(sub)
    _add_hash_parsers(sub)
    _add_call_parser(sub)
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
        ref_sketches=args.ref_sketches, out_file=args.out_file, resume=args.resume,
        in_stream=args.in_stream, devices=args.devices, tp=args.tp, device=args.device,
        dist_coordinator=args.dist_coordinator, dist_procs=args.dist_procs,
        dist_rank=args.dist_rank,
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
        chunk_reads=args.chunk_reads, ref_sketches=args.ref_sketches,
        out_file=args.out_file, resume=args.resume, devices=args.devices, tp=args.tp,
        device=args.device, dist_coordinator=args.dist_coordinator,
        dist_procs=args.dist_procs, dist_rank=args.dist_rank,
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


def _dist_kw(args) -> dict:
    return dict(dist_coordinator=args.dist_coordinator, dist_procs=args.dist_procs,
                dist_rank=args.dist_rank)


def _run_hash(args):
    if args.min_kmer_occ or args.max_samples is not None:
        print("warning: hash -M/-I are dead in rkmh (empty branch, "
              "rkmh.cpp:2109-2111); use stream/filter for depth filters.", file=sys.stderr)
    for flag, name in (("merge_sample", "-m"), ("traditional_minhash", "-T")):
        if getattr(args, flag):
            print(f"warning: hash {name} is parsed but dead in rkmh too "
                  f"(rkmh.cpp:2040-2111); ignored.", file=sys.stderr)
    from rkmh_tpu_torch.commands.hash_cmd import HashConfig, run

    return run(HashConfig(
        read_files=args.reads + args.refs, ks=tuple(args.ks), sketch_size=args.sketch_size,
        output_kmers=args.output_kmers, wabbitize=args.wabbitize,
        output_counts=args.output_counts, json_out=args.json, sourmash_out=args.sourmash,
        out_prefix=args.out_prefix, batch_size=args.batch_size, chunk_reads=args.chunk_reads,
        out_file=args.out_file, resume=args.resume, devices=args.devices, device=args.device,
        **_dist_kw(args),
    ))


def _run_count(args):
    from rkmh_tpu_torch.commands.count_cmd import CountConfig, run

    return run(CountConfig(
        read_files=args.reads, ks=tuple(args.ks), counter_size=args.counter_size,
        batch_size=args.batch_size, out_file=args.out_file, dump=args.dump,
        chunk_reads=args.chunk_reads, devices=args.devices, device=args.device,
        **_dist_kw(args),
    ))


def _run_search(args):
    from rkmh_tpu_torch.commands.search_cmd import SearchConfig, run

    return run(SearchConfig(
        ref_files=args.refs, read_files=args.reads, ks=tuple(args.ks),
        batch_size=args.batch_size, chunk_reads=args.chunk_reads, out_file=args.out_file,
        resume=args.resume, devices=args.devices, device=args.device, **_dist_kw(args),
    ))


def _run_call(args):
    from rkmh_tpu_torch.commands.call_cmd import CallConfig, run

    return run(CallConfig(
        ref_files=args.refs, read_files=args.reads, ks=tuple(args.ks),
        window_len=args.window_len, show_depth=args.show_depth, out_file=args.out_file,
        resume=args.resume, devices=args.devices, device=args.device, **_dist_kw(args),
    ))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run = {"hpv16": lambda: _run_hpv16(_hpv16_config(args)),
           "filter": lambda: _run_filter(args),
           "hash": lambda: _run_hash(args), "count": lambda: _run_count(args),
           "search": lambda: _run_search(args),
           "call": lambda: _run_call(args)}.get(args.command, lambda: _run_stream(args))
    from rkmh_tpu_torch.observability import observed_run

    try:
        with observed_run(args.command, enabled=args.metrics or None):
            return run()
    except (FileNotFoundError, IsADirectoryError, PermissionError) as e:
        print(f"rkmh-tpu-torch {args.command}: {e.strerror}: {e.filename}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0  # e.g. `rkmh-tpu-torch ... | head`


if __name__ == "__main__":
    sys.exit(main())
