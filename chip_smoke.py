#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rkmh_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It fails (non-zero exit, no result
line) without CUDA or without the package beside it.  In order it:

1. reports the card (torch and nvidia-smi);
2. builds the CUDA kernels from ``rkmh_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and the native FASTA/FASTQ reader and line
   formatter from ``rkmh_tpu_torch/io/native`` (g++), and times the
   builds; a failed build fails the run;
3. checks the window-hash kernel (K1) bit for bit against its plain
   PyTorch version on the card: random codes with invalid bases, poly-A
   and (AC)n rows, k in {1, 4, 12, 16, 17, 18, 31, 32, 33, 64} (packed
   variant to 32, one instance compiled for each k; byte-wise above) and
   multi-k;
4. checks the panel-probe kernel (K2) against its plain version on a
   synthetic zika-shaped panel (60 refs, k=12, s=1000) at B=16384, in
   both row modes and with thresholds, and prints the probes, hits and
   mask bits per read; then on duplicate-heavy rows (a value 40 times, a
   row of one value) with R = 60, 200 and 257 (counters in 2 registers,
   in 8, in shared memory), both row modes and both epilogues, and on raw
   rows of 1,000 and 12,000 hashes (ranks tables of 3n and of n slots
   per read, one of them filled by a row of distinct values); outputs
   must be equal;
5. times both kernels and their plain versions at the stream slice's
   shapes (B=16384, L=160, k=12, zika table) with CUDA events, and
   computes their bounds (``bench/bounds.py``: bytes over 3.35 TB/s).
   Every kernel's (and library call's) time is device time, its calls
   replayed from a CUDA graph (``bench/timing.cuda_graph_time_ms``); an
   eager loop of a tens-of-microseconds kernel measures its Python
   wrapper, so that time is kept beside it as ``eager_ms``; plain
   versions are timed eagerly;
6. drives the stream slice: synthetic 60 x 10,807 bp panel and 2**20
   reads of 150 bp.  First, on the card's host, it times parse and
   encode of the reads by the native reader and by the Python parser,
   and line formatting by the native block formatter and by
   ``format_lines_host``, and checks that both give equal codes, lengths,
   names and lines.  Then it runs ``commands.stream.run`` (k=12, s=1000,
   device cuda; the native reader and formatter), with the launch
   counters zeroed just before and read just after; it checks one line
   per read, that K1 and K2 ran, and that the first 16,384 lines equal
   the port's CPU plain-path output on the same reads; it reports e2e
   reads/s, device-step reads/s over resident batches and the share of
   reads assigned to their source genome.  Last, one more stream run
   under cProfile says where the host time goes;
7. checks the LUT-gather kernels (K4, K5) bit for bit against their plain
   versions: K4 at every N of the gather sweep by every route that takes
   the shape (LUT staged whole, read through the cache), K5 at the
   sweep's [512, 128] and at [300, 128] with 300 and 77 indices a row by
   every route that takes the inputs (the row in a warp's registers where
   M % 4 == 0 and the tensors are 16-byte aligned, the row staged in
   shared memory everywhere), on aligned and unaligned indices; times K4
   at N = 512, 4096 and 16384, and K5 at [512, 128] by either route beside the launch
   floor (an empty kernel on K5's grid, graph replay), each beside one
   ``torch.gather`` on an int64 index (the library yardstick);
8. drives the gather path, ``rkmh_tpu_torch.bench.bench_gather.main()``,
   with the counters zeroed just before and read just after; every K4
   route and K5's register route must have launched (launches by route);
9. builds the hpv16 tables on the card from a synthetic full-width
   refpath (182 types of ~7.9 kb, 10 sublineages, k=18), the kernel's
   packed layout of the set table included (once, timed), and checks the
   set-probe kernel (K3) against its plain version on the logical table
   (and K1 against its own) on 512 nanopore-like reads, on the same
   batch with every seventh read emptied, on one 40 kb read and on a
   small table of 280 references (9 mask words), outputs exactly equal;
   checks that the batch launches more blocks than reads; times both and
   counts the table sectors K3 reaches in either layout;
10. drives the hpv16 slice: 12,800 reads (~57 Mbp) through
    ``commands.hpv16_cmd.run`` (k=18, batch 512, device cuda) in a
    temporary working directory, counters zeroed just before and read
    just after; it checks one line per read, that K1 and K3 ran, and
    that the first 64 lines and the .tst file equal the CPU plain path's;
    it reports the table, the set-up seconds, e2e and device-step Mbp/s
    and reads/s, the share of reads typed as their source type, and one
    step at the auto batch size;
11. checks the counter kernels (K6 counter_add, K7 counter_mask) exactly
    against their plain versions on the card: random hashes (>= 2**63 and
    zeros among them) with a mask tensor, with the window mask derived in
    the kernel from read lengths and without a mask, three calls into one
    table, through the bins and as one atomic per element, at counter
    sizes 2e8, 1e7, 2**27 and the prime 1009, K7 also on views 1-3
    elements in (8 bytes off a 16-byte boundary at odd offsets); times both
    and their plain versions at the stream shape (B=16384, L=160, k=12,
    the counter pass's window mask, derived in the kernel) on a 2e8-slot
    counter, and K7 at the hpv16 -M shape (K1's output for the 512-read
    hpv16 batch of step 9, padding zeros included) on an 8e8-slot counter,
    checked exactly there too; reports how many distinct slots one batch
    adds to and K6's time on as many random hashes; checks that a
    ``HashCounter`` keeps the bins for the batch and leaves them for the
    random hashes;
12. checks K2's filter mode against its plain version on the zika panel
    in both row modes with -N/-D thresholds, and times it;
13. drives ``stream -M 2 -I 40`` over the slice's 2**20 reads (default
    2e8-slot counters, device cuda), counters zeroed just before and read
    just after (K1, K6, K7 and K2 must run); checks one line per read and
    that the whole first 16,384 reads, run alone, give byte-identical
    output on the card and on the CPU plain path; reports e2e reads/s,
    the counter pass's seconds and the device step;
14. drives ``filter -M 2 -I 40 -N 10`` over the same reads with -o (K1,
    K6, K7 and K2's filter mode must run); checks that the records
    written equal the reads kept, that the whole first 16,384 reads give
    byte-identical output on the card and the CPU, and that a ``-f`` plus
    ``-i`` run over them (the stream given as a file object) does too;
    reports e2e reads/s and the share of reads kept;
15. drives ``hpv16 -M 2`` over 12,800 reads with N bases (default
    8e8-slot counter; K1, K6, K7 and K3 must run); checks that a whole
    256-read input gives byte-identical stdout and .tst on the card and
    the CPU; reports e2e Mbp/s;
16. the sketch round trip: ``hash -r refs.fa -k 12 -s 1000 -o P`` writes
    P.rkmh.json and, with ``--sourmash``, P.sig (K1 must run); then
    ``stream --ref-sketches P.rkmh.json`` and ``stream -R P.sig`` (through
    the CLI) over the slice's 2**20 reads (K1, K2) must equal the slice's
    ``stream -r`` output byte for byte; reports their e2e reads/s and the
    panel set-up seconds from the references and from the sketch file;
17. ``hash`` over the first 2**18 reads into a file (the default dump of
    2**20 reads would be ~2.9 GB of text): the default lines, ``-s 1000``
    and ``-k 12 -k 16`` (K1), each with its bytes, seconds and e2e
    reads/s, and its first 4,096 lines against the CPU plain path; one
    default run under cProfile;
18. ``count --counter-size 640000 -o T.npz --dump`` over the 2**20 reads
    (K1, K6), the K6 route the counter took, and the table of the first
    65,536 reads counted on the card and on the CPU plain path, equal;
19. ``search`` of 50,000 distinct 12-mers drawn from the genomes (plus
    lowercase tokens, tokens of other lengths and with N) over the 2**20
    reads (K1, then the membership step: ``torch.searchsorted`` on
    sign-flipped int64); its first 4,096 lines against the CPU plain path;
    the membership step's device ms per 16,384-read batch; one run under
    cProfile;
20. ``stream -o`` and ``hash --out`` over the 2**18 reads: each output cut
    mid-line at about 40% and run again with ``--resume`` (K1, and K2 for
    stream) must equal the uninterrupted bytes; then times K1 at k=16 and
    at -k 12 -k 16, hash -s's ``torch.sort``, and K6 at count's
    640,000-slot table by either route, with the route a ``HashCounter``
    takes there and its bound;
21. ``stream -i`` in a child process (``python3 -m rkmh_tpu_torch.cli stream
    -r refs.fa -i -k 12 -s 1000``): the 2**20 reads piped in must give the
    slice's file-mode output byte for byte (reads/s, the child's start-up
    included); then on a pipe held open, the seconds until the lines of
    100 reads arrive, twice (the second shows the idle flush);
22. the call workload (``bench/call_inputs``: HPV16REF, ~7.9 kb, with 40
    planted substitutions and 10 deletions in the sample, 1,100
    nanopore-like reads, k=16): the depth map built as ``call`` builds it
    (K1, ``np.unique``, the sorted map's layout, the copy to the card), a
    1 Mbp reference made from a seed, and a map ~10x the L2 (50M keys);
    checks K8 (``csrc/hashmap.cu``) exactly against its plain version on
    a map holding key 0, keys >= 2**63, counts in the overflow and
    misses, on the workload map and on the large map; K9
    (``csrc/call_scan.cu``, through ``call_scan_ref``, and its byte-wise
    route at every k) against ``call_scan_plain`` on a reference with runs
    of N at each k of KS_CALL (both routes where k <= 32) and window
    lengths 1, 100 and more than P, and on the workload;
23. times K8 at the scan's shape (~7,900 positional hashes), at 2**20 read
    hashes and on the large map, beside ``torch.searchsorted`` over the
    map's sorted keys (``ops/hashmap.searchsorted_get``, its library
    yardstick), and K9 on the workload reference (packed route, and its
    byte-wise route beside it) and on the 1 Mbp reference (64M mutated
    k-mers), in mutated k-mers per second beside K1's windows per second,
    each with its bound (bytes: the queries in, the outputs, 12 bytes for
    each distinct key found) and its plain version's time;
24. drives ``call`` (``commands.call_cmd.run``, k=16, w=100, device cuda),
    counters zeroed just before and read just after (K1, K8, K9 must
    run): its VCF and a ``-d`` run byte-identical to the CPU plain path's,
    and, on three slices of the reference, a ``--resume`` from a
    ``.progress`` sidecar cut inside its second section equal to the
    uninterrupted VCF; reports the e2e seconds and the seconds by phase
    (parse, read hashing, the map's unique, layout and copy, scan, record
    extraction, write), the map's keys and bytes by part on the card, and
    the share of planted variants called;
25. (run after 24) builds the hpv16 panel of a synthetic refpath of 640
    type genomes (``synth.write_hpv16_workload(num_types=640)``), whose
    projected bucket table passes the default 2,048 MB cap, so
    ``hpv16_cmd.build_tables`` takes the sorted-key panel (printed: the
    projected bytes, the panel's keys, its directory's and its own bytes
    on the card, set-up seconds by phase, the directory's among them);
    checks hpv16's sorted probe (K10, ``rkmh_sorted_probe`` in
    ``csrc/set_probe.cu``: a directory over the keys' top bits, then the
    bucket's keys) exactly against ``sorted_probe_plain`` on a 512-read
    batch of its reads (654 references: 20 mask words and a partial one;
    keys on both sides of 2**63; reads of several 2,048-element segments),
    on rows of one repeated value, on rows with 40% of the hashes zeroed
    as -M zeroes them, on a one-reference panel with a 4,500-element read,
    and on three edge directories (one bucket holding every key, one key,
    empty buckets on both sides of 2**63); times K10 on the batch (graph
    and eager) beside its plain version, its bound (the function's work:
    rows, lens and output once, a key and its mask row for each distinct
    key found, ``bench/bounds.sorted_probe_work``) and its library
    yardstick, ``torch.searchsorted`` of the batch's run starts into the
    keys plus the mask gather;
26. drives that fallback through ``commands.hpv16_cmd.run`` (12,800 reads
    in 512-read batches, device cuda; K1 and K10 must run, K3 must not): the
    first 64 lines equal the CPU plain path's; reports e2e Mbp/s; then
    ``hpv16 -M 2`` on the fallback (K1, K6, K7, K10); and, inside phase 10,
    the 182-type panel under ``RKMH_TPU_SET_TABLE_MAX_MB=256`` (its 480 MiB
    table is past it): K10 and no K3, lines byte-identical to its
    bucket-table run;
27. checks the wide panel probe (K11, ``rkmh_panel_probe_wide`` in
    ``csrc/panel_probe.cu``, on its packed table ``ops/probe.WideTable``)
    exactly against the plain versions on the logical table at R = 8,193,
    12,288 and 20,000 (``bench/wide_inputs.straddling_panel``: ties and
    maxima on both sides of reference 8,192, duplicate-heavy rows), both
    epilogues and both row modes, on a table of one occupied slot, and
    against K2 at R = 8,192; then times K11 beside K2 at R = 257, 1,024,
    4,096 and 8,192 on 16,384 rows, raw and sorted;
28. drives ``stream`` over 12,288 synthetic references of 1,000 bp (k =
    12, s = 32: the cut from s = 1000 is printed with its reason) and 2**18
    reads of 150 bp (``commands.stream.run``, device cuda; K1 and K11 must
    run), printing the projected table bytes first: the first 16,384 lines
    equal the CPU plain path's; reports e2e reads/s, the host table
    build's and the packing's seconds and the packed table's bytes on the
    card beside the logical table's; then times K11 on one 16,384-read
    batch of it (raw rows and the path's sorted rows) beside its plain
    version, its bound (the function's work: rows, lens and output, an
    entry and its mask row for each distinct entry hit,
    ``bench/bounds.wide_probe_work``) and K2 on a table of the first 8,192
    references;
29. (run after 21, on the slice's input) ``stream --metrics`` over the
    first 16,384 slice reads through the CLI: the JSON line's reads and bp
    must be the input's; then the same run under ``RKMH_TPU_PROFILE``: the
    trace file must exist and name the K1 and K2 kernels;
30. (run after 28) checks K12 (``csrc/sparse_margin.cu``: the VW trainer's
    sparse margins on class-minor weights and their gradient over a sorted
    plan, no atomics; ``ops/sparse_margin.py``) forward and backward
    against the plain version (``bench/margin_inputs``, within 1e-5 of the
    sum of |terms| + 1e-6: float sums in another order), and the backward
    against itself (two runs equal, bit for bit), at the pipeline's shapes
    (N = 180, F = 10 with C = 1, 5, 11 and F = 110 with C = 1, D = 2**18),
    at phase 32's per-read shape (N = 4,096, F = 1,002, C = 10) and on the
    edge cases (a row of padding only, one index in a whole row and in
    every row, index D - 1, 131,072 entries on one slot, N = 1, all
    padding), then times forward, backward and both at the per-read shape
    (graph and eager) beside the plain version, ``embedding_bag`` (graph
    and eager), the bound (``bench/bounds.sparse_margin_bytes``) and the
    plan's build;
31. the VW model pipeline (``bench/model_pipeline``): 180 training and 36
    held-out samples (single-strain and mixed, ``make_mix``'s machinery)
    of nanopore-like reads of the 10 sublineages of
    ``synth.write_hpv16_refpath``; ``stream -k 18 -s 4000`` on each (K1,
    K2), ``vwize -n --format stream``; the four models trained (25 passes)
    on the card (K12 forward and backward) and on the CPU; applied to the
    held-out samples on both (K12 forward); conf_mat and interpret_wabbit;
    weights within lr = 0.05 of the CPU's, margins within lr times the
    row's sum of |val| (+ the sum order), class ids and ``--binary``
    labels equal; the four shipped ``model_docker`` models applied on both
    with equal class ids and labels; prints each model's held-out accuracy;
32. per-read training at the trainer's full width: ``hash -w -k 18 -s
    1000`` (K1) over 4,096 training and 1,024 held-out reads of the 10
    sublineages, each line's XYX replaced by its sublineage (1-10);
    ``--ect 10`` trained for 25 passes at -b 18 on the card (K12), twice:
    the two runs' weights must be equal, bit for bit; applied to the
    held-out reads; prints the host's vectorize seconds, the train
    seconds, the plan's build, device ms a pass (and its forward,
    backward, Adam and the rest), K12's launches and the held-out
    accuracy;
33. (run after 29, on the slice's input) the library's batch forms
    (``classify/library.py``) on the card against the CPU on the zika
    panel's sketches and the slice batch's (hashes on both sides of
    2**63), every output equal; then the panel cache
    (``RKMH_TPU_PANEL_CACHE`` at a temporary directory; every other phase
    runs with it off): the set-up on a miss and on a hit (K1 0 launches),
    and ``stream`` over the first 16,384 reads twice, byte-identical;
34. (run after 12) ``--devices`` / ``--tp``'s kernels: K2's partial
    epilogue (``rkmh_panel_probe_partial``: a tp shard's local best, max,
    max before the best and sketch length) exactly against its plain
    version on every shard of the zika panel at tp = 2 and 4 (raw rows and
    sorted s = 50 rows, the running max from -1 and from 0) and of
    ``bench/wide_inputs.straddling_panel`` at R = 20,000, tp = 2 (10,000
    references a shard: K11's route); the shards merged
    (``parallel/mesh.merge_tp_partials``) equal the unsharded K2 / K11
    stream and filter outputs word for word; K6 and K7 over each of 4 slot
    ranges of a 2e8-slot table exactly against their plain versions, the
    ranges' tables together equal to the single-table K6's and K7 over the
    ranges in turn equal to the single-table K7; the partial epilogue, K6
    and K7 over a range timed with their bounds;
35. (run after 33, and inside 28) the ``--devices`` paths on a grid of
    ``(cuda:0,) * 4`` (``mesh_devices``; the four shards share the card),
    each with the counters zeroed just before and read just after, byte
    for byte against the same command on one device: ``stream`` at (dp,
    tp) = (4, 1) and (2, 2), ``stream -M 2 -I 40`` and ``filter -M 2 -I 40
    -N 10`` at (2, 2) (K6 and K7 launched over slot ranges), ``stream`` over
    phase 28's 12,288 references at tp = 2, ``stream -i`` at (2, 2) over the
    first 16,384 reads, ``hash``, ``count`` and ``search`` with ``--devices
    4``; reads/s beside one device's; then ``rkmh-tpu-torch stream --devices
    2`` through the CLI: on one card stderr holds the fallback line and
    stdout is one device's;
36. the kernels' new modes: (inside 9) K3's partial epilogue
    (``rkmh_set_probe_partial``, a tp shard's window of the combined
    columns) on every shard of the 182-type panel at tp = 2 and 4 (the
    shard tables of ``hpv16_cmd.build_tables(tp_shards=tp)``) on the
    512-read batch, whose reads take 1, 2 and 3+ 2,048-element segments:
    each shard exactly against ``set_probe_partial_plain``, the merged
    shards (``merge_hpv16_partials``) against the whole table's K3, the
    window (0, T + U) against ``rkmh_set_probe`` bit for bit; timed on shard
    0 of 2 (graph, eager) beside its plain version, its bound
    (``bench/bounds.set_probe_partial_bytes``) and the whole table's K3;
    (after 22) K9 with a base > 0: the call workload's reference in 2 and 4
    slices (``call_engine.call_scan_slice``) against each slice's plain
    version and the whole row's scan, and timed on slice 1 of 4;
37. the last sharded paths on a grid of ``(cuda:0,) * 4``, each driven
    with the counters zeroed just before and read just after, byte for
    byte against the same command on one device, Mbp/s (seconds for call)
    beside one device's, the peak memory reckoned before each hpv16 run
    and measured: (inside 10, on its input) ``hpv16`` at (2, 2) over the
    12,800 reads, at (4, 1) and (1, 4), ``-M 2`` (2 dp slot ranges of the
    8e8-slot counter) and the 182 types under a 256 MB cap (the sorted
    panel, K10 on each dp slice) at (2, 2) over the first 3,200, and
    ``rkmh-tpu-torch hpv16 --devices 2`` through the CLI (the fallback
    line on one card); (after 24) ``call --devices 4``: the workload's VCF
    and ``-d`` and the 1 Mbp reference's VCF; ``parallel/sp.sp_sketch`` of
    two 4.2 Mbp genomes over 4 chunks, k = 16 and -k 12 -k 16, against one
    device's sketch;
38. ``--dist-*`` (after 35): two rank processes (this script with
    ``--dist-rank-worker``, both on cuda:0, a gloo group whose rendezvous
    is a file store), each with its launch counters zeroed before and read
    after each job and written to a file this process reads, run over the
    slice's 2**20 reads ``stream -o``, ``stream -M 2 -I 40 -o`` (2e8
    slots: one 800 MB ``all_reduce``), ``filter -M 2 -I 40 -N 10 -o`` and
    ``stream --tp 2`` on local grids of ``(cuda:0,) * 2``, then ``stream``
    and ``filter`` again with --resume after rank 1's stripe (and filter's
    idx) is cut at 40%; each merged by ``rkmh-tpu-torch-dist-merge`` and
    held byte for byte against the one-process output of phases 6, 13 and
    14; the pair's reads/s (the slower rank) beside one process's, each
    rank's peak memory, and the -M reduction's bytes and seconds.  A rank
    that fails or outlives its limit fails the run (the pair is killed).
39. the rest of ``--dist-*`` (after 24 and 37, whose inputs and one-process
    outputs it keeps): the same rank pair runs ``hash`` and ``hash -s
    1000`` over phase 17's 2**18 reads, ``count`` (640,000 slots, ``-o``
    and ``--dump``: one 2.56 MB ``all_reduce``) and ``search`` (phase
    19's 12-mers) over the slice's 2**20 reads, ``hpv16`` at the published
    shape over phase 37's 3,200-read head, ``hpv16 --tp 2`` on local grids
    of ``(cuda:0,) * 2``, ``hpv16 -M 2`` at the default 8e8 slots (one 3.2
    GB ``all_reduce`` and a 1.6 GB checkpoint a rank), ``call`` on phase
    22's workload and ``call --resume`` after rank 1's stripe is cut inside
    its section; each merged output held byte for byte against one
    process's of phases 17-19, 37 and 24 (count: rank 0's npz arrays and
    dump lines), every rank's kernels required, and the same figures as
    38's.
40. the device table builds (``ops/lookup.py`` section (d)): (inside 9) on
    the 182-type panel's window hashes, K13 (``rkmh_set_table_fill`` in
    ``csrc/set_table.cu``: the fill of a device-built bucket table) exactly
    against ``set_table_fill_plain`` on the same sorted entries at the
    path's geometry, at 1/64 of its buckets (an overflow) and with a row of
    two hashes that collide in a bucket, every lane and ``max_rank``; the
    path's table equal to K13's and to the same build on the CPU, K3's
    counts on the 512-read batch equal on it and on the numpy
    ``build_set_table``, the tp = 2 shard stack equal to the CPU's and its
    merged K3 partials to the numpy table's K3; K13 timed (graph, eager)
    beside its plain version, its bound (the table written once, the
    entries read once) and the sorts before it, with the set-up laps; every
    hpv16 path that builds a bucket table (10, 15, 37, 39) must launch K13;
    (after 28) ``stream`` over 2,048 references at s = 1000 (2,048,000
    sketch elements: the table built on the card) and 2**17 reads (K1, K13,
    K2), the first 16,384 lines against the CPU's; (after 22)
    ``parallel/mesh.ShardedCallEnum`` on ``(cuda:0,) * 4`` (K1, K8) against
    one device's K1 + K8 depths.

Before them, one line gives the host seconds of each phase (or group of
phases) in the order they ran, which add up to the run.

The last three lines are the card's name and power limit, the kernels'
JSON record (per kernel: launches on the driven paths, in all and by
path, phase 38's ranks' among them, max_abs_err against the plain version, ms, eager_ms, plain_ms, bound_ms,
bound_by, bound_share = bound_ms / ms, and library_ms, one PyTorch call
computing the same function where there is one: ``torch.gather`` for K4
and K5, ``torch.searchsorted`` and the mask gather for K10,
``embedding_bag`` forward and its backward for K12 (graph replay where
it can be captured, else eager; both kept), none for the
others; K11 adds K2's time at R = 8,192, its times on the sorted rows and
its times beside K2's at R = 257-8,192; K4 and K5 add their launches by route, K4
its times at each timed N, K5 its staged route's time and the launch
floor, K7 its times at the hpv16 -M shape, K1 its times at hash's shapes,
K6 its time and route at count's table, K8 its times at 2**20 queries and
on the large map with ``torch.searchsorted`` as its library_ms, K9 its
launches by route, its mutated k-mers per second, its byte-wise route's
time and its times on the 1 Mbp reference, K12 its forward + backward
times, its plan's build time and size, phase 32's numbers and phase 31's
accuracies; K6 and K7 their launches over a slot range and their times on
one; the partial epilogue its shape; K3 its launches by route, whole table
and partial; K3's partial epilogue its shape, the whole table's K3 time
and the batch's reads by segments; K9 its base mode's time and error; K13 the time of the sorts before it,
their bound and its shape) and
``{"ok": true, "device":
{...}}``.  Any failure raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

T_START = time.perf_counter()

REPO = os.path.dirname(os.path.abspath(__file__))
N_SLICE_READS = 1 << 20
N_CPU_LINES = 16384
B = 16384
KS_K1 = (1, 4, 12, 16, 17, 18, 31, 32, 33, 64)  # packed k <= 32, byte-wise above
GATHER_NS = (8, 64, 512, 4096, 16384)
GATHER_TIMED_NS = (512, 4096, 16384)  # K4's cache route; the last one is the record's
K5_N = 512  # the gather sweep's K5 shape, [512, 128]
N_HPV16_READS = 12800
N_HPV16_CPU_LINES = 64
HPV16_K = 18
HPV16_BATCH = 512
COUNTER_SIZES = (200_000_000, 10_000_000, 1 << 27, 1009)
HPV16_COUNTER = 800_000_000  # hpv16 -M's default counter
MIN_OCC, MAX_SAMPLES, FILTER_MIN_MATCHES = 2, 40, 10
N_HPV16_M_CPU_READS = 256
HPV16_N_RATE = 0.001
N_HASH_READS = 1 << 18  # the default dump of 2**20 reads would be ~2.9 GB of text
N_HASH_CPU_LINES = 4096
COUNT_SLOTS = 640_000   # count's default table (rkmh.cpp:2322)
N_COUNT_CPU_READS = 65536
N_SEARCH_KMERS = 50_000


class PhaseClock:
    """Host seconds by phase: each ``lap`` closes the interval since the
    last one (the first since the clock was made), so the laps add up to
    the run."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: dict[str, float] = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = self.laps.get(name, 0.0) + now - self.t
        self.t = now

    def report(self) -> None:
        total = time.perf_counter() - T_START
        say(f"seconds by phase: {json.dumps({k: round(v, 3) for k, v in self.laps.items()})}; "
            f"the record and the rest {time.perf_counter() - self.t:.3f} s; since the script "
            f"started {total:.3f} s")


def say(msg: str) -> None:
    print(msg, flush=True)


def reads_to_codes(ascii_reads, L: int):
    """[n, read_len] ASCII -> [n, L] uint8 codes, 255-padded."""
    import numpy as np

    from rkmh_tpu_torch.io.packing import CODE_LUT

    codes = np.full((len(ascii_reads), L), 255, np.uint8)
    codes[:, : ascii_reads.shape[1]] = CODE_LUT[ascii_reads]
    return codes


def max_abs_err(got, want) -> int:
    """Largest |got - want| over integer tensors; 0 means bit-identical."""
    return int((got.to(want.dtype) - want).abs().max()) if want.numel() else 0


def require_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {path} path")


def check_k1(dev) -> int:
    import numpy as np
    import torch

    from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain, multi_k_window_hashes

    rng = np.random.default_rng(7)
    # 2047 rows: the flattened windows end inside a block of the packed variant
    codes = rng.integers(0, 4, size=(2047, 160), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[rng.random(codes.shape) < 0.005] = 255
    codes[:, 150:] = 255
    codes[:16, :150] = 0  # duplicate-heavy: poly-A reads and (AC)n repeats
    codes[16:32, :150] = np.arange(150) % 2
    x = torch.from_numpy(codes).to(dev)
    worst = 0
    for k in KS_K1:
        got = multi_k_window_hashes(x, [k])
        want = kmer_window_hashes_plain(x, k)
        err = max_abs_err(got, want)
        say(f"K1 k={k}: {tuple(got.shape)} bit-exact={err == 0} "
            f"nonzero={int((want != 0).sum())}")
        if err or not torch.equal(got, want):
            raise AssertionError(f"window-hash kernel disagrees with the plain version at k={k}")
        worst = max(worst, err)
    got = multi_k_window_hashes(x, [12, 16, 33])
    want = torch.cat([kmer_window_hashes_plain(x, k) for k in (12, 16, 33)], dim=-1)
    if not torch.equal(got, want):
        raise AssertionError("window-hash kernel disagrees with the plain version at multi-k")
    say(f"K1 multi-k (12, 16, 33): {tuple(got.shape)} bit-exact=True")
    return worst


def zika_panel(dev):
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.commands.common import PyPacked, build_ref_panel
    from rkmh_tpu_torch.io.fastx import SeqRecord

    names, genomes = synth.make_panel()
    ascii_g = synth._ACGTN[genomes]
    recs = [SeqRecord(n, g.tobytes()) for n, g in zip(names, ascii_g)]
    return build_ref_panel(PyPacked(recs), (12,), 1000, dev), genomes


def check_k2(dev, panel, genomes) -> tuple:
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
    from rkmh_tpu_torch.ops.probe import _panel_probe_cuda, panel_probe_plain
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    reads, _ = synth.make_reads(genomes, B, seed=11)
    codes = torch.from_numpy(reads_to_codes(reads, 160)).to(dev)
    hashes = multi_k_window_hashes(codes, [12])
    R = panel.num_refs
    worst = 0
    for s in (1000, 50):
        sk, lens = bottom_s_sketch(hashes, s)
        for mode, rows, ln in (("a raw", hashes, None), (f"b sketch s={s}", sk, lens)):
            if s != 1000 and ln is None:
                continue
            for min_diff, min_matches in ((0, -1), (2, 60)):
                got = _panel_probe_cuda(rows, ln, panel.table, R, min_diff, min_matches)
                want = panel_probe_plain(rows, ln, panel.table, R, min_diff, min_matches)
                err = max_abs_err(got, want)
                say(f"K2 mode {mode} -D {min_diff} -N {min_matches}: exact={err == 0} "
                    f"mean shared={want[1].float().mean().item():.2f} "
                    f"flag histogram={torch.bincount(want[2], minlength=8).tolist()}")
                if err or not torch.equal(got, want):
                    raise AssertionError(f"panel-probe kernel disagrees in mode {mode}")
                worst = max(worst, err)
    # the counting design's premise: hits are a minority of the probes
    st = bounds.panel_probe_stats(hashes, None, panel.table, R)
    say(f"K2 raw rows: {st.probes / B:.2f} probes, {st.hits / B:.2f} hits per read; a hit's "
        f"mask holds {st.mask_bits / max(st.hits, 1):.2f} of {R} reference bits; the probes "
        f"reach {st.table_bytes} bytes of the {panel.table.numel() * 4}-byte table")
    return worst, (codes, hashes), st


def dup_heavy_panel(dev, R: int, n_reads: int, width: int = 149):
    """A table over R random references in which references 0 and R-1
    hold one value 40 times, and raw rows of `width` hashes drawn from the
    same pool: a third hold that value 40 times, a third nothing else (a
    low-complexity read), a third two values alternating; 5% zeros.  The
    last row holds distinct values (60 from the pool), so a ranks table of
    one slot per element fills up."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.ops.lookup import build_panel_table
    from rkmh_tpu_torch.ops.sketch import SENTINEL

    rng = np.random.default_rng(R)
    pool = rng.integers(1, 2**63, size=4096, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    v = pool[0]
    sk = np.full((R, 1000), SENTINEL, dtype=np.int64)
    for r in range(R):
        vals = rng.choice(pool[1:], 1000)
        if r in (0, R - 1):
            vals[:40] = v
        sk[r] = np.sort(vals.view(np.uint64)).view(np.int64)
    table = build_panel_table(sk, np.full(R, 1000, np.int32)).table.view(np.int32)
    rows = rng.choice(pool, size=(n_reads, width))
    rows[0::3, rng.permutation(width)[:40]] = v
    rows[1::3] = v
    rows[2::3, ::2] = pool[5]
    rows[rng.random(rows.shape) < 0.05] = 0
    rows[-1] = rng.integers(1, 2**63, size=width)
    rows[-1, :60] = np.unique(pool)[:60]
    if np.unique(rows[-1]).size != width:
        raise AssertionError("the distinct row repeats a value")
    return torch.from_numpy(table).to(dev), torch.from_numpy(rows).to(dev)


def check_k2_variants(dev) -> int:
    """K2 on duplicate-heavy rows, with its counters in 2 registers (R =
    60), in 8 (R = 200) and in shared memory (R = 257), both row modes,
    both epilogues; B = 4099 is no multiple of the reads per block.  Then
    raw rows wider than the engine sends (NOSORT_MAX_W = 256), which the
    kernel takes: 1,000 (3n ranks slots per read, R = 60 and 257) and
    12,000 (n slots: 3n do not fit in shared memory; the distinct row
    fills its table), both epilogues."""
    import torch

    from rkmh_tpu_torch.ops.probe import (
        _panel_probe_cuda,
        _panel_probe_filter_cuda,
        panel_probe_filter_plain,
        panel_probe_plain,
    )
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    worst = 0
    cases = [(60, 149, 4099, "2 register counters"), (200, 149, 4099, "8 register counters"),
             (257, 149, 4099, "shared counters"), (60, 1000, 99, "3n ranks slots"),
             (257, 1000, 99, "3n ranks slots, shared counters"),
             (60, 12000, 5, "n ranks slots")]
    for R, width, n_reads, variant in cases:
        table, raw = dup_heavy_panel(dev, R, n_reads, width)
        ref_lens = torch.full((R,), 1000, dtype=torch.int32, device=dev)
        modes = [("raw", raw, None)]
        if width == 149:
            modes.append(("sorted s=50", *bottom_s_sketch(raw, 50)))
        for mode, rows, ln in modes:
            got = _panel_probe_cuda(rows, ln, table, R, 1, 20)
            want = panel_probe_plain(rows, ln, table, R, 1, 20)
            got_f = _panel_probe_filter_cuda(rows, ln, table, R, ref_lens, 1, 20)
            want_f = panel_probe_filter_plain(rows, ln, table, R, ref_lens, 1, 20)
            err = max(max_abs_err(got, want), max_abs_err(got_f, want_f))
            say(f"K2 duplicate-heavy R={R} width={width} ({variant}), {mode}: "
                f"exact={err == 0}, max shared {int(want[1].max())}, distinct row shared "
                f"{int(want[1, -1])}, flag histogram "
                f"{torch.bincount(want[2], minlength=8).tolist()}")
            if err or not (torch.equal(got, want) and torch.equal(got_f, want_f)):
                raise AssertionError(f"panel-probe kernel disagrees on duplicate-heavy rows, "
                                     f"R={R}, width={width}, {mode}")
            worst = max(worst, err)
        if int(want[1].max()) < 40:
            raise AssertionError("the duplicate-heavy rows did not reach rank 40")
    return worst


def time_kernels(panel, codes, hashes, k2_stats) -> dict:
    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops.hashing import _window_hashes_cuda, kmer_window_hashes_plain
    from rkmh_tpu_torch.ops.probe import _panel_probe_cuda, panel_probe_plain

    R = panel.num_refs
    B = codes.shape[0]
    rows_and_table = bounds.tensor_bytes(hashes) + k2_stats.table_bytes
    t = {
        "window_hash": cuda_graph_time_ms(lambda: _window_hashes_cuda(codes, [12], 42), 20),
        "window_hash_eager": cuda_time_ms(lambda: _window_hashes_cuda(codes, [12], 42), 50),
        "window_hash_plain": cuda_time_ms(lambda: kmer_window_hashes_plain(codes, 12), 10),
        "panel_probe": cuda_graph_time_ms(
            lambda: _panel_probe_cuda(hashes, None, panel.table, R, 0, -1), 20),
        "panel_probe_eager": cuda_time_ms(
            lambda: _panel_probe_cuda(hashes, None, panel.table, R, 0, -1), 50),
        "panel_probe_plain": cuda_time_ms(
            lambda: panel_probe_plain(hashes, None, panel.table, R, 0, -1), 5),
    }
    for name, ms in t.items():
        say(f"time {name}: {ms:.4f} ms per call at B={codes.shape[0]}, "
            f"L={codes.shape[1]}, k=12, table {tuple(panel.table.shape)}")
    bound = {"window_hash": bounds.bound_ms(bounds.tensor_bytes(codes, hashes)),
             "panel_probe": bounds.bound_ms(rows_and_table + 3 * 4 * B),
             "panel_probe_filter": bounds.bound_ms(rows_and_table + 4 * R + 5 * 4 * B)}
    say(f"bounds (ms, bytes over 3.35 TB/s): {bound}")
    return t, bound


def bound_fields(ms: float, bound_ms: float, library_ms=None) -> dict:
    return {"bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / ms,
            "library_ms": library_ms}


def write_zika(tmp: str) -> dict:
    """The stream slice's input: the zika-shaped panel and 2**20 reads
    (with N bases at synth.N_RATE), plus a file of the first N_CPU_LINES."""
    from rkmh_tpu_torch import synth

    t0 = time.perf_counter()
    refs, reads, names, src = synth.write_workload(tmp, N_SLICE_READS)
    head = os.path.join(tmp, "head.fq")
    with open(reads) as src_fh, open(head, "w") as dst:
        for _ in range(4 * N_CPU_LINES):
            dst.write(src_fh.readline())
    say(f"slice input: {N_SLICE_READS} reads x {synth.READ_LEN} bp, "
        f"{len(names)} refs x {synth.GENOME_LEN} bp, made in "
        f"{time.perf_counter() - t0:.2f} s")
    return {"dir": tmp, "refs": refs, "reads": reads, "head": head, "names": names,
            "src": src}


def driven(fn, path: str, kernels_needed) -> tuple[float, dict]:
    """Run one main path with the launch counters zeroed just before and
    read just after; -> (wall seconds, launches).  Raises if a kernel of
    the path was not launched."""
    import torch

    from rkmh_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc not in (None, 0):
        raise AssertionError(f"the {path} path exited {rc}")
    launches = kernels.launch_counts()
    say(f"{path} launches: {launches}")
    require_launches(launches, kernels_needed, path)
    return seconds, launches


def read_text(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def require_same(gpu: str, cpu: str, what: str) -> None:
    """Byte-identical GPU and CPU outputs, or an error naming the first
    differing line."""
    if gpu != cpu:
        g, c = gpu.splitlines(), cpu.splitlines()
        bad = next((i for i, (a, b) in enumerate(zip(g, c)) if a != b), min(len(g), len(c)))
        raise AssertionError(f"{what}: GPU and CPU outputs differ at line {bad} "
                             f"({len(g)} vs {len(c)} lines)")


def check_native_io(zika: dict) -> dict:
    """The native reader and block formatter against the Python parser and
    the per-line formatter on the slice's 2**20 reads: parse-and-encode and
    format seconds on the card's host, and that both give equal codes,
    lengths, names and lines.  The formatter formats each chunk as one
    block, with a [3, n] result made from a seed."""
    import numpy as np

    from rkmh_tpu_torch.commands import stream
    from rkmh_tpu_torch.commands import common
    from rkmh_tpu_torch.commands.common import DEFAULT_CHUNK_READS, PyPacked, iter_packed_chunks
    from rkmh_tpu_torch.io.fastx import iter_batches

    reads = zika["reads"]
    t0 = time.perf_counter()
    native_chunks = list(iter_packed_chunks([reads], DEFAULT_CHUNK_READS))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_names = [c.names for c in native_chunks]
    names_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_chunks = [PyPacked(recs) for recs in iter_batches(reads, DEFAULT_CHUNK_READS)]
    python_s = time.perf_counter() - t0
    if [len(c) for c in native_chunks] != [len(c) for c in py_chunks]:
        raise AssertionError("the native and Python readers cut different chunks")
    for i, (a, b, names) in enumerate(zip(native_chunks, py_chunks, native_names)):
        if not (np.array_equal(a.codes, b.codes) and np.array_equal(a.lens, b.lens)
                and names == b.names):
            raise AssertionError(f"the native and Python readers differ in chunk {i}")
    n = sum(len(c) for c in native_chunks)
    if n != N_SLICE_READS:
        raise AssertionError(f"the native reader read {n} of {N_SLICE_READS} reads")

    rng = np.random.default_rng(19)
    results = [np.stack([rng.integers(0, len(zika["names"]), len(c)),
                         rng.integers(0, 1001, len(c)), rng.integers(0, 8, len(c))])
               for c in native_chunks]
    fmt = stream._NativeFormatCtx(zika["names"], 1000)
    t0 = time.perf_counter()
    blocks = [fmt.format_block(arr, np.arange(len(c)), common.NamesOnly(c))
              for arr, c in zip(results, native_chunks)]
    native_fmt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = ["".join(stream.format_lines_host(zika["names"], c.names, arr, 1000))
             for arr, c in zip(results, py_chunks)]
    python_fmt_s = time.perf_counter() - t0
    if blocks != lines:
        raise AssertionError("the native block formatter and format_lines_host differ")
    res = {"reads": n, "parse_encode_native_s": native_s, "names_to_str_s": names_s,
           "parse_encode_python_s": python_s, "format_native_s": native_fmt_s,
           "format_python_s": python_fmt_s}
    say(f"host reader on {n} reads x 150 bp ({len(native_chunks)} chunks): parse and encode "
        f"native {native_s:.3f} s (+ {names_s:.3f} s for the names as str), Python parser "
        f"+ encode_seqs {python_s:.3f} s; codes, lengths and names equal")
    say(f"host formatter on the same reads: native block {native_fmt_s:.3f} s, "
        f"format_lines_host {python_fmt_s:.3f} s; lines equal")
    return res


def profile_stream(zika: dict, top: int = 12) -> dict:
    """One stream run of the slice under cProfile, on the card: where the
    main thread's time goes, by the functions that hold it (cumulative
    seconds: the wait for the native parse on the reader thread,
    bucketed_batches, the dispatch of the device step, the host-to-device
    copy, the fetch, which waits for the device, and the output)."""
    import cProfile
    import pstats

    from rkmh_tpu_torch.commands import stream

    out = os.path.join(zika["dir"], "profiled.tsv")
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(stream.run, stream.StreamConfig(
        ref_files=[zika["refs"]], read_files=[zika["reads"]], ks=(12,), sketch_size=1000,
        out_file=out, device="cuda"))
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    # (file name part, function name part) of each span's functions; the
    # native parse runs on the reader thread, which cProfile does not see:
    # the main thread's wait for it is the queue's get
    spans = {"wait for the reader thread (Queue.get)": ("queue.py", "get"),
             "bucketed_batches": ("common.py", "bucketed_batches"),
             "device step dispatch (classify_codes_table)": ("engine.py",
                                                             "classify_codes_table"),
             "H2D copy (Tensor.to)": ("~", "method 'to' of"),
             "fetch (Tensor.cpu)": ("~", "method 'cpu' of"),
             "format (on_result)": ("stream.py", "on_result"),
             "render": ("stream.py", "render"),
             "write": ("~", "method 'write' of '_io"),
             "panel build (build_ref_panel_from_files)": ("common.py",
                                                          "build_ref_panel_from_files")}
    by_span = {label: sum(v[3] for (f, _, fn), v in stats.stats.items()
                          if file_part in f and func in fn)
               for label, (file_part, func) in spans.items()}
    say(f"stream slice under cProfile: {wall:.2f} s wall (profiled); cumulative s by span: "
        + ", ".join(f"{k} {v:.3f}" for k, v in by_span.items()))
    ranked = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    say("stream slice under cProfile, top functions by own time: " + "; ".join(
        f"{os.path.basename(f)}:{ln} {fn} {v[2]:.3f} s ({v[1]} calls)"
        for (f, ln, fn), v in ranked))
    return {"wall_s": wall, "cumulative_s": by_span}


def run_slice(dev, card: str, panel, zika: dict) -> dict:
    import numpy as np
    import torch

    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import stream

    tmp = zika["dir"]
    out_gpu = os.path.join(tmp, "gpu.tsv")
    cfg = dict(ref_files=[zika["refs"]], ks=(12,), sketch_size=1000)
    e2e_s, launches = driven(
        lambda: stream.run(stream.StreamConfig(read_files=[zika["reads"]], out_file=out_gpu,
                                               device="cuda", **cfg)),
        "stream", ("window_hash", "panel_probe"))

    with open(out_gpu) as fh:
        gpu_lines = fh.readlines()
    if len(gpu_lines) != N_SLICE_READS:
        raise AssertionError(f"{len(gpu_lines)} lines for {N_SLICE_READS} reads")
    for i in (0, len(gpu_lines) - 1):
        if gpu_lines[i].split("\t")[1] != f"read{i}":
            raise AssertionError(f"line {i} is out of order: {gpu_lines[i]!r}")

    out_cpu = os.path.join(tmp, "cpu.tsv")
    t0 = time.perf_counter()
    stream.run(stream.StreamConfig(read_files=[zika["head"]], out_file=out_cpu,
                                   device="cpu", **cfg))
    cpu_s = time.perf_counter() - t0
    require_same("".join(gpu_lines[:N_CPU_LINES]), read_text(out_cpu), "stream")
    say(f"slice: first {N_CPU_LINES} GPU lines byte-identical to the CPU plain "
        f"path ({cpu_s:.2f} s on the CPU)")

    assigned = np.array([ln.split("\t", 1)[0] for ln in gpu_lines])
    share = float(np.mean(assigned == np.asarray(zika["names"])[zika["src"]]))

    # device step over resident batches (parse and format excluded)
    genomes = synth.make_panel()[1]
    reads_ascii, _ = synth.make_reads(genomes, N_SLICE_READS, seed=5)
    codes = torch.from_numpy(reads_to_codes(reads_ascii, 160)).to(dev)
    batches = list(torch.split(codes, B))
    step = lambda: [engine.classify_codes_table(b, panel, (12,), 1000, 0, -1)  # noqa: E731
                    for b in batches]
    step_ms = cuda_time_ms(step, 3, warmup=1)
    res = {
        "e2e_reads_per_s": N_SLICE_READS / e2e_s,
        "e2e_s": e2e_s,
        "device_step_reads_per_s": N_SLICE_READS / (step_ms / 1e3),
        "device_step_ms_per_16k_batch": step_ms / len(batches),
        "assigned_to_source_share": share,
        "launches": launches,
    }
    say(f"slice on {card}: e2e {res['e2e_reads_per_s']:.1f} reads/s "
        f"({e2e_s:.2f} s for {N_SLICE_READS} reads, panel build and parse included); "
        f"device step {res['device_step_reads_per_s']:.1f} reads/s "
        f"({res['device_step_ms_per_16k_batch']:.4f} ms per {B}-read batch); "
        f"assigned to source genome {share:.4f}")
    return res


def check_gathers(dev) -> tuple[dict, dict]:
    """K4 by every route that takes each N of the sweep (the LUT staged
    whole where it fits a block, the cache route everywhere), against its
    plain version; then K4 by its shape's own route timed at N = 512, 4096
    and 16384.  Returns ({name: (max_abs_err, ms, plain_ms, library_ms,
    bound_ms, eager_ms)} at the sweep's largest N, {N: K4's fields}).
    The library call is one ``torch.gather`` on an index made int64 before
    the timing."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops import gather

    rng = np.random.default_rng(13)
    res, by_n = {}, {}
    cases = [("lut_gather_rows", gather._lut_gather_rows_cuda, gather.lut_gather_rows_plain,
              N, N) for N in GATHER_NS]
    for name, kern, plain, N, hi in cases:
        lut = torch.from_numpy(rng.integers(-2**31, 2**31, (N, 128)).astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, hi, (N, 128)).astype(np.int32)).to(dev)
        want = plain(lut, idx)
        routes = [None, "ldg"] + (["smem"] if N * 128 * 4 <= gather._SMEM_BYTES else [])
        err = 0
        for route in routes:
            got = kern(lut, idx, route)
            err = max(err, max_abs_err(got.long(), want.long()))
            if err or not torch.equal(got, want):
                raise AssertionError(f"{name} kernel disagrees with the plain version at N={N}"
                                     f" by route {route or 'of the shape'}")
        idx64 = idx.long()
        if not torch.equal(torch.gather(lut, 0, idx64), want):
            raise AssertionError(f"torch.gather does not compute {name}")
        variant = gather.rows_variant(lut)
        say(f"{name} N={N}: bit-exact=True by its shape's route ({variant}) and by "
            f"{', '.join(routes[1:])}")
        if N not in GATHER_TIMED_NS:
            continue
        ms = cuda_graph_time_ms(lambda: kern(lut, idx), 50)
        eager_ms = cuda_time_ms(lambda: kern(lut, idx), 50)
        plain_ms = cuda_time_ms(lambda: plain(lut, idx), 50)
        library_ms = cuda_graph_time_ms(lambda: torch.gather(lut, 0, idx64), 50)
        bound_ms = bounds.bound_ms(bounds.tensor_bytes(lut, idx, want))
        say(f"{name} N={N} ({variant}): {ms:.5f} ms ({eager_ms:.4f} eager) vs "
            f"{plain_ms:.4f} ms plain, {library_ms:.5f} ms torch.gather, bound {bound_ms:.6f} ms")
        res[name] = (err, ms, plain_ms, library_ms, bound_ms, eager_ms)
        by_n[N] = {"route": variant, "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms}
    return res, by_n


def check_k5(dev) -> tuple[tuple, dict]:
    """K5 against its plain version by each route that takes the inputs
    (the register route at C = 128 with M % 4 == 0 on 16-byte aligned
    tensors, the staged route everywhere), at the sweep's [512, 128], at a
    ragged [300, 128] LUT with M = 300 (a last pass of 44 indices) and with
    M = 77 (the staged route's alone), each also on indices that are not
    16-byte aligned (the staged route's); then K5 at [512, 128] timed by
    its shape's route and by the staged route, beside the launch floor (an
    empty kernel on the register route's grid, graph replay) and one
    ``torch.gather``.  Returns ((max_abs_err, ms, plain_ms, library_ms,
    bound_ms, eager_ms), extra record fields)."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms, launch_floor_ms
    from rkmh_tpu_torch.ops import gather

    rng = np.random.default_rng(14)
    err, timed = 0, None
    for N, M in ((K5_N, 128), (300, 300), (300, 77)):
        lut = torch.from_numpy(rng.integers(-2**31, 2**31, (N, 128)).astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, 128, (N, M)).astype(np.int32)).to(dev)
        want = gather.lut_gather_lanes_plain(lut, idx)
        shifted = torch.empty(N * M + 1, dtype=torch.int32, device=dev)[1:].view(N, M)
        shifted.copy_(idx)  # 4 bytes past an aligned allocation
        checked = []
        for x in (idx, shifted):
            variant = gather.lanes_variant(lut, x)
            for route in ("reg", "smem") if variant == "reg" else ("smem",):
                got = gather._lut_gather_lanes_cuda(lut, x, route)
                err = max(err, max_abs_err(got.long(), want.long()))
                if err or not torch.equal(got, want):
                    raise AssertionError(f"lut_gather_lanes disagrees with the plain version at "
                                         f"[{N}, 128], M={M}, by route {route}")
                checked.append(f"{route} ({'aligned' if x is idx else 'unaligned'} indices)")
        if (N, M) != (300, 77) and gather.lanes_variant(lut, idx) != "reg":
            raise AssertionError(f"lut_gather_lanes [{N}, 128] M={M} does not take the reg route")
        say(f"lut_gather_lanes [{N}, 128] M={M}: bit-exact=True by " + ", ".join(checked))
        timed = timed or (lut, idx, want)
    lut, idx, want = timed
    idx64 = idx.long()
    if not torch.equal(torch.gather(lut, 1, idx64), want):
        raise AssertionError("torch.gather does not compute lut_gather_lanes")
    kern = gather._lut_gather_lanes_cuda
    ms = cuda_graph_time_ms(lambda: kern(lut, idx), 50)
    staged_ms = cuda_graph_time_ms(lambda: kern(lut, idx, "smem"), 50)
    floor_ms = launch_floor_ms(dev, -(-K5_N // 4), 128)  # the register route's grid
    eager_ms = cuda_time_ms(lambda: kern(lut, idx), 50)
    plain_ms = cuda_time_ms(lambda: gather.lut_gather_lanes_plain(lut, idx), 50)
    library_ms = cuda_graph_time_ms(lambda: torch.gather(lut, 1, idx64), 50)
    bound_ms = bounds.bound_ms(bounds.tensor_bytes(lut, idx, want))
    say(f"lut_gather_lanes N={K5_N} (reg): {ms:.5f} ms ({eager_ms:.4f} eager); staged route "
        f"{staged_ms:.5f} ms; launch floor {floor_ms:.5f} ms; {plain_ms:.4f} ms plain, "
        f"{library_ms:.5f} ms torch.gather, bound {bound_ms:.6f} ms")
    return ((err, ms, plain_ms, library_ms, bound_ms, eager_ms),
            {"staged_route_ms": staged_ms, "launch_floor_ms": floor_ms,
             "launch_floor_share": bound_ms / floor_ms})


def run_gather_path() -> dict:
    import torch

    from rkmh_tpu_torch.bench import bench_gather
    from rkmh_tpu_torch.ops import gather, kernels

    kernels.reset_launch_counts()
    bench_gather.main()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    by_route = dict(kernels.LUT_GATHER_ROWS.by_route)
    say(f"gather path launches: {launches}; lut_gather_rows by route: {by_route}")
    lanes_by_route = dict(kernels.LUT_GATHER_LANES.by_route)
    say(f"gather path: lut_gather_lanes by route: {lanes_by_route}")
    require_launches(launches, ("lut_gather_rows", "lut_gather_lanes"), "gather")
    for route in gather.ROUTES:
        if by_route.get(route, 0) <= 0:
            raise AssertionError(f"the gather path launched no lut_gather_rows by the {route} "
                                 "route")
    if lanes_by_route.get("reg", 0) <= 0:
        raise AssertionError("the gather path launched no lut_gather_lanes by the reg route")
    return {**launches, "lut_gather_rows_by_route": by_route,
            "lut_gather_lanes_by_route": lanes_by_route}


def check_k3(dev, tb, packed, panel) -> tuple[int, dict, object]:
    """K3 against its plain version on the first HPV16_BATCH reads (one
    padded batch), the same batch with every seventh read emptied, one 40
    kb read, and a small table of 9 mask words; returns (max_abs_err,
    times, K1's hashes of the batch)."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.io.packing import encode_seqs
    from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain, multi_k_window_hashes
    from rkmh_tpu_torch.ops.lookup import build_set_table
    from rkmh_tpu_torch.ops.set_probe import (
        SEGMENT,
        _set_probe_cuda,
        pack_set_table,
        set_probe_plain,
    )
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    T, U = len(tb.type_names), tb.n_lin + tb.n_sub
    lens = packed.lens[:HPV16_BATCH]
    batch = packed.codes[:HPV16_BATCH, : -(-int(lens.max()) // 128) * 128]
    long_read, _ = synth.make_nanopore_reads(1, 99, panel, mean_len=40000, min_len=40000,
                                             max_len=40000)
    long_codes, long_lens = encode_seqs([long_read[0].tobytes()])
    worst, times, batch_hashes = 0, {}, None
    for label, codes, ln in (("B=512 batch", batch, lens), ("one 40 kb read", long_codes,
                                                            long_lens)):
        x = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        hashes = multi_k_window_hashes(x, [HPV16_K])
        if not torch.equal(hashes, kmer_window_hashes_plain(x, HPV16_K)):
            raise AssertionError(f"window-hash kernel disagrees with the plain version on {label}")
        batch_hashes = hashes if batch_hashes is None else batch_hashes
        full, sk_lens = bottom_s_sketch(hashes, x.shape[1] - HPV16_K + 1)
        Wc = engine.hpv16_compact_width(ln, x.shape[1], (HPV16_K,))
        rows = full[:, :Wc]
        cases = [(label, sk_lens)]
        if not times:
            emptied = sk_lens.clone()
            emptied[::7] = 0
            cases.append((f"{label}, every seventh read emptied", emptied))
        for name, row_lens in cases:
            got = _set_probe_cuda(rows, row_lens, tb.probe_table, T, U)
            want = set_probe_plain(rows, row_lens, tb.comb_table, T, U)
            err = max_abs_err(got, want)
            blocks = int((-(-row_lens.clamp(max=Wc) // SEGMENT)).clamp(min=1).sum())
            say(f"K3 {name}: rows {tuple(rows.shape)}, exact={err == 0}, {blocks} blocks with "
                f"work for {rows.shape[0]} reads, "
                f"mean shared={want[:, 1].float().mean().item():.1f}, "
                f"mean group hits={want[:, 2:].sum(1).float().mean().item():.2f}")
            if err or not torch.equal(got, want):
                raise AssertionError(f"set-probe kernel disagrees with the plain version on "
                                     f"{name}")
            worst = max(worst, err)
        if not times:
            blocks = int((-(-sk_lens.clamp(max=Wc) // SEGMENT)).clamp(min=1).sum())
            if blocks <= rows.shape[0]:
                raise AssertionError("the set-probe kernel has no more blocks with work than "
                                     "reads")
            probe = tb.probe_table
            times = {"set_probe": cuda_graph_time_ms(
                         lambda: _set_probe_cuda(rows, sk_lens, probe, T, U), 10),
                     "set_probe_eager": cuda_time_ms(
                         lambda: _set_probe_cuda(rows, sk_lens, probe, T, U), 20),
                     "set_probe_plain": cuda_time_ms(
                         lambda: set_probe_plain(rows, sk_lens, tb.comb_table, T, U), 3,
                         warmup=1)}
            st = bounds.set_probe_stats(rows, sk_lens, tb.comb_table, T + U)
            row_bytes = bounds.read_row_bytes(rows, sk_lens) + bounds.tensor_bytes(sk_lens, got)
            times["set_probe_bound"] = bounds.bound_ms(row_bytes + st.table_bytes)
            packed_bytes = bounds.packed_set_table_bytes(st, probe)
            say(f"time set_probe: {times['set_probe']:.4f} ms ({times['set_probe_eager']:.4f} "
                f"eager) vs {times['set_probe_plain']:.4f}"
                f" ms plain per {HPV16_BATCH}-read batch, rows {tuple(rows.shape)}, "
                f"table {tuple(tb.comb_table.shape)}; {st.probes} run starts probed, {st.hits} "
                f"hit, {st.mask_bits} mask bits, {st.table_bytes} table bytes reached (of "
                f"{tb.comb_table.numel() * 4}); bound {times['set_probe_bound']:.4f} ms; in "
                f"the packed layout ({probe.nbytes} bytes) {st.buckets} key records and "
                f"{st.hit_slots} slot records, {packed_bytes} bytes, "
                f"{bounds.bound_ms(row_bytes + packed_bytes):.4f} ms")

    # a table of 280 references: 9 mask words, slot records of 48 bytes
    rng = np.random.default_rng(41)
    pool = rng.integers(1, 2**63, size=4000, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    wide = torch.from_numpy(build_set_table([rng.choice(pool, 500) for _ in range(280)],
                                            num_refs=280).table.view(np.int32)).to(dev)
    rows, row_lens = bottom_s_sketch(torch.from_numpy(
        rng.choice(np.concatenate([pool, rng.integers(1, 2**63, 4000)]), size=(64, 5000))).to(dev),
        5000)
    got = _set_probe_cuda(rows, row_lens, pack_set_table(wide, 280), 250, 30)
    want = set_probe_plain(rows, row_lens, wide, 250, 30)
    err = max_abs_err(got, want)
    say(f"K3 280 references (9 mask words): table {tuple(wide.shape)}, rows "
        f"{tuple(rows.shape)}, exact={err == 0}, mean shared="
        f"{want[:, 1].float().mean().item():.1f}")
    if err or not torch.equal(got, want):
        raise AssertionError("set-probe kernel disagrees with the plain version at 9 mask words")
    return max(worst, err), times, batch_hashes


def run_hpv16(dev, card: str, keep: str) -> dict:
    """Table build + K3 check + the hpv16 slice (see the module doc);
    ``keep``: where phase 37 leaves phase 39's input."""
    import numpy as np
    import torch

    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import hpv16_cmd
    from rkmh_tpu_torch.commands.common import bucketed_batches, load_packed
    from rkmh_tpu_torch.ops import kernels
    from rkmh_tpu_torch.ops.lookup import table_slots

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        reads, truth = synth.write_hpv16_workload(tmp, N_HPV16_READS)
        panel = synth.make_hpv16_panel(0)
        packed = load_packed([reads])
        mbp = int(packed.lens.sum()) / 1e6
        say(f"hpv16 input: {N_HPV16_READS} reads, {mbp:.3f} Mbp (mean "
            f"{packed.lens.mean():.0f} bp, max {packed.lens.max()}), "
            f"{len(panel.types)} types + {len(panel.subs)} sublineages, made and parsed in "
            f"{time.perf_counter() - t0:.2f} s")
        cfg = dict(read_files=[reads], refpath=tmp, ks=(HPV16_K,), batch_size=HPV16_BATCH)

        tb = hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(**cfg, tst_file=False),
                                    (HPV16_K,), dev)
        T, U = len(tb.type_names), tb.n_lin + tb.n_sub
        table = tb.comb_table
        S = table_slots(table.shape[1], T + U)
        say(f"hpv16 table: {tuple(table.shape)} int32 = {table.numel() * 4 / 2**20:.1f} MiB, "
            f"S={S}, Wm={table.shape[1] // S - 3}, {T} types + {U} groups; packed for the "
            f"probe: {tb.probe_table.nbytes / 2**20:.1f} MiB beside it; set-up s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in tb.setup_s.items()))
        err_k3, times, batch_hashes = check_k3(dev, tb, packed, panel)
        err_partial3, partial3_t = check_set_probe_partial(dev, tb, cfg, packed)
        k13 = check_device_builds(dev, card, cfg, tb, packed)

        gpu_dir, cpu_dir = os.path.join(tmp, "gpu"), os.path.join(tmp, "cpu")
        os.makedirs(gpu_dir)
        os.makedirs(cpu_dir)
        out_gpu = os.path.join(gpu_dir, "out.tsv")
        try:
            os.chdir(gpu_dir)  # the .tst side file lands in the working directory
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hpv16_cmd.run(hpv16_cmd.Hpv16Config(**cfg, out_file=out_gpu, device="cuda"))
            torch.cuda.synchronize()
            e2e_s = time.perf_counter() - t0
            launches = kernels.launch_counts()
            say(f"hpv16 slice launches: {launches}")
            require_launches(launches, ("window_hash", "set_table_fill", "set_probe"), "hpv16")

            head = os.path.join(tmp, "head.fq")
            with open(reads) as src_fh, open(head, "w") as dst:
                for _ in range(4 * N_HPV16_CPU_LINES):
                    dst.write(src_fh.readline())
            os.chdir(cpu_dir)
            t0 = time.perf_counter()
            out_cpu = os.path.join(cpu_dir, "out.tsv")
            hpv16_cmd.run(hpv16_cmd.Hpv16Config(**{**cfg, "read_files": [head]},
                                                out_file=out_cpu, device="cpu"))
            cpu_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)

        with open(out_gpu) as fh:
            gpu_lines = fh.readlines()
        with open(out_cpu) as fh:
            cpu_lines = fh.readlines()
        if len(gpu_lines) != N_HPV16_READS:
            raise AssertionError(f"{len(gpu_lines)} hpv16 lines for {N_HPV16_READS} reads")
        for i in (0, len(gpu_lines) - 1):
            if gpu_lines[i].split("\t")[0] != f"read{i}":
                raise AssertionError(f"hpv16 line {i} is out of order: {gpu_lines[i]!r}")
        if cpu_lines != gpu_lines[:N_HPV16_CPU_LINES]:
            bad = next(i for i, (a, b) in enumerate(zip(cpu_lines, gpu_lines)) if a != b)
            raise AssertionError(f"hpv16 GPU and CPU outputs differ at line {bad}: "
                                 f"{gpu_lines[bad]!r} vs {cpu_lines[bad]!r}")
        tst = f"lineage_specific_hashes.{HPV16_K}.tst"
        with open(os.path.join(gpu_dir, tst)) as a, open(os.path.join(cpu_dir, tst)) as b:
            if a.read() != b.read():
                raise AssertionError("hpv16 GPU and CPU .tst files differ")
        say(f"hpv16 slice: first {N_HPV16_CPU_LINES} GPU lines and the .tst file "
            f"byte-identical to the CPU plain path ({cpu_s:.2f} s on the CPU)")
        typed = float(np.mean([ln.split("\t")[1] == t for ln, t in zip(gpu_lines, truth)]))
        capped = run_hpv16_capped(tmp, cfg, gpu_lines)
        sharded = run_sharded_hpv16(dev, card, tmp, cfg, reads, gpu_lines, e2e_s, mbp,
                                    tb.probe_table.nbytes, keep)

    # device step over resident batches (parse, table build and format excluded)
    batches = [(torch.from_numpy(codes).to(dev),
                engine.hpv16_compact_width(lens, codes.shape[1], (HPV16_K,)))
               for _, codes, lens in bucketed_batches(packed, HPV16_BATCH)]
    probe = tb.probe_table
    step = lambda: [engine.hpv16_batch_comb(c, probe, (HPV16_K,), T, U, Wc)  # noqa: E731
                    for c, Wc in batches]
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_time_ms(step, 2, warmup=1)
    peak_512 = torch.cuda.max_memory_allocated() / 2**30

    # one step at the auto batch size (16384) on the longest length bucket
    longest, wc_long = batches[-1]
    big = longest.repeat(-(-16384 // longest.shape[0]), 1)[:16384]
    del batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    big_ms = cuda_time_ms(
        lambda: engine.hpv16_batch_comb(big, probe, (HPV16_K,), T, U, wc_long), 1, warmup=1)
    peak_big = torch.cuda.max_memory_allocated() / 2**30

    res = {"e2e_s": e2e_s, "e2e_mbp_per_s": mbp / e2e_s,
           "e2e_reads_per_s": N_HPV16_READS / e2e_s,
           "device_step_mbp_per_s": mbp / (step_ms / 1e3),
           "device_step_reads_per_s": N_HPV16_READS / (step_ms / 1e3),
           "typed_share": typed, "launches": launches, "err_k3": err_k3, **times,
           "capped": capped, "sharded": sharded, "err_partial": err_partial3, "k13": k13,
           "partial_t": partial3_t,
           "batch_hashes": batch_hashes}  # K7's hpv16 -M shape, for check_counters
    say(f"hpv16 slice on {card}: e2e {res['e2e_mbp_per_s']:.3f} Mbp/s, "
        f"{res['e2e_reads_per_s']:.1f} reads/s ({e2e_s:.2f} s for {N_HPV16_READS} reads, "
        f"table build and parse included); device step {res['device_step_mbp_per_s']:.1f} "
        f"Mbp/s, {res['device_step_reads_per_s']:.1f} reads/s ({step_ms:.2f} ms for all "
        f"{N_HPV16_READS} reads in {HPV16_BATCH}-read batches, peak "
        f"{peak_512:.2f} GiB allocated); typed as source type {typed:.4f}")
    say(f"hpv16 auto batch: one step of {tuple(big.shape)} codes: {big_ms:.2f} ms, "
        f"peak {peak_big:.2f} GiB allocated, on {card}")
    return res


def random_hashes(seed: int, shape):
    """int64 hashes, about half >= 2**63 as uint64, ~5% zeros, repeated
    values, and a mask of ~80% of the elements, on the host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    h = rng.integers(-(2**63), 2**63 - 1, size=shape, dtype=np.int64)
    h[rng.random(shape) < 0.05] = 0
    h[:, 1::4] = h[:, ::4][:, : h[:, 1::4].shape[1]]
    return torch.from_numpy(h), torch.from_numpy(rng.random(shape) < 0.8)


def check_counters(dev, hashes, hp_hashes) -> tuple[dict, dict]:
    """K6 and K7 exactly against their plain versions at every size of
    COUNTER_SIZES (K7 also on views at element offsets 1-3, 8 bytes off a
    16-byte boundary), then timed at the stream shape (``hashes`` = K1's
    [16384, 149] output for 150 bp reads padded to 160, with the window
    mask of the counter pass) on a 2e8-slot counter, and K7 at the hpv16 -M
    shape (``hp_hashes`` = K1's output for a 512-read hpv16 batch, padding
    zeros included) on an 8e8-slot counter; returns ({name: (max_abs_err,
    ms, plain_ms, bound_ms, eager_ms)}, K7's hpv16 -M fields)."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops import counter
    from rkmh_tpu_torch.ops.hashing import window_mask

    h, m = (t.to(dev) for t in random_hashes(17, (4096, 149)))
    read_lens = torch.from_numpy(np.random.default_rng(18).integers(0, 161, 4096)).to(dev)
    read_lens[:3] = torch.tensor([0, 5, 160], device=dev)  # shorter than k, and full
    by_lens = window_mask(read_lens, 160, [12])
    worst = {"counter_add": 0, "counter_mask": 0}
    for size in COUNTER_SIZES:
        want = torch.zeros(size, dtype=torch.int32, device=dev)
        counter.counter_add_plain(want, h, m)
        counter.counter_add_plain(want, h, by_lens)
        counter.counter_add_plain(want, h[:64], None)
        for binned in (True, False):  # through the bins, and one atomic per element
            got = torch.zeros(size, dtype=torch.int32, device=dev)
            counter._counter_add_cuda(got, h, m, binned=binned)
            counter._counter_add_cuda(got, h, None, (read_lens, 160, [12]), binned=binned)
            counter._counter_add_cuda(got, h[:64], None, binned=binned)
            err_add = max_abs_err(got, want)
            if err_add or not torch.equal(got, want):
                raise AssertionError(f"counter-add kernel (binned={binned}) disagrees with the "
                                     f"plain version at size {size}")
        kept = []
        for lo, hi in ((MIN_OCC, counter.INT32_MAX), (0, MAX_SAMPLES), (3, 5)):
            w = counter.counter_mask_plain(want, h, lo, hi)
            for off in range(4):  # views 0-3 elements in: odd ones are 8 bytes off 16
                view = h.reshape(-1)[off:]
                g = counter._counter_mask_cuda(got, view, lo, hi)
                err_mask = max_abs_err(g, w.reshape(-1)[off:])
                if err_mask or not torch.equal(g, w.reshape(-1)[off:]):
                    raise AssertionError(f"counter-mask kernel disagrees with the plain version "
                                         f"at size {size}, bounds ({lo}, {hi}), offset {off}")
                worst["counter_mask"] = max(worst["counter_mask"], err_mask)
            kept.append(f"({lo}, {hi}) {float((w != 0).float().mean()):.3f}")
        say(f"K6/K7 size {size}: table and masks (K7 also at offsets 1-3) exact=True, slot 0 count "
            f"{int(want[0])}, max count {int(want.max())}, share kept {', '.join(kept)}")
        worst["counter_add"] = max(worst["counter_add"], err_add)
        del got, want

    big = COUNTER_SIZES[0]
    table = torch.zeros(big, dtype=torch.int32, device=dev)
    lens150 = torch.full((hashes.shape[0],), 150, dtype=torch.int32, device=dev)
    windows = (lens150, 160, [12])  # as the counter pass calls K6
    mask = window_mask(lens150, 160, [12])
    plain_table = table.clone()
    t = {
        "counter_add": cuda_graph_time_ms(
            lambda: counter._counter_add_cuda(table, hashes, None, windows), 20),
        "counter_add_eager": cuda_time_ms(
            lambda: counter._counter_add_cuda(table, hashes, None, windows), 20),
        "counter_add_direct": cuda_graph_time_ms(
            lambda: counter._counter_add_cuda(table, hashes, None, windows, binned=False), 20),
        "counter_add_mask_tensor": cuda_graph_time_ms(
            lambda: counter._counter_add_cuda(table, hashes, mask), 20),
        "counter_add_plain": cuda_time_ms(
            lambda: counter.counter_add_plain(plain_table, hashes, mask), 5),
        "counter_mask": cuda_graph_time_ms(
            lambda: counter._counter_mask_cuda(table, hashes, MIN_OCC, counter.INT32_MAX), 20),
        "counter_mask_eager": cuda_time_ms(
            lambda: counter._counter_mask_cuda(table, hashes, MIN_OCC, counter.INT32_MAX), 20),
        "counter_mask_plain": cuda_time_ms(
            lambda: counter.counter_mask_plain(table, hashes, MIN_OCC, counter.INT32_MAX), 5),
    }
    for name, ms in t.items():
        say(f"time {name}: {ms:.4f} ms per call, hashes {tuple(hashes.shape)}, "
            f"counter {big} slots")
    # what K6's atomics contend on: reads repeat k-mers, so one batch sends
    # many adds to one slot; the same launch on distinct random hashes
    added = counter.slots(hashes[mask], big)
    _, mult = torch.unique(added, return_counts=True)
    gen = torch.Generator(device=dev).manual_seed(23)
    distinct = torch.randint(-(2**63), 2**63 - 1, tuple(hashes.shape), dtype=torch.int64,
                             device=dev, generator=gen)
    ms_distinct = cuda_graph_time_ms(lambda: counter._counter_add_cuda(table, distinct, mask),
                                     20)
    say(f"counter_add contention: the batch's {added.numel()} counted hashes fall in "
        f"{mult.numel()} distinct slots (the hottest takes {int(mult.max())} adds, slot 0 "
        f"{int((added == 0).sum())}); K6 on as many random hashes: {ms_distinct:.4f} ms")
    # the route a counter pass settles on, read from its first call through the bins
    for label, hs, merges in (("the stream batch", hashes, True),
                              ("as many random hashes", distinct, False)):
        c = counter.HashCounter(big, dev)
        want = torch.zeros_like(c.table)
        for _ in range(2):
            c.add_windows(hs, lens150, 160, 12)
            counter.counter_add_plain(want, hs, mask)
        if c.binned is not merges or not torch.equal(c.table, want):
            raise AssertionError(f"HashCounter on {label}: through the bins={c.binned}, table "
                                 f"exact={torch.equal(c.table, want)}")
        say(f"HashCounter on {label}: later calls through the bins={c.binned}, table exact=True")
        del c, want
    # bounds: the hashes and read lengths (K6) or the hashes in and out (K7), plus
    # the counter's sectors the slots reach, read and written (K6) or read (K7:
    # those of the non-zero hashes; hash 0's output is 0 whatever its count)
    def mask_sectors(h, size):
        return bounds.sector_bytes(torch.unique(counter.slots(h[h != 0], size)) * 4)

    add_sectors = bounds.sector_bytes(torch.unique(added) * 4)
    get_sectors = mask_sectors(hashes, big)
    bound = {"counter_add": bounds.bound_ms(bounds.tensor_bytes(hashes, lens150)
                                            + 2 * add_sectors),
             "counter_mask": bounds.bound_ms(2 * bounds.tensor_bytes(hashes) + get_sectors)}
    say(f"counter bounds (ms): {bound}; sectors reached: add {add_sectors} B, "
        f"mask {get_sectors} B")
    del table, plain_table

    # K7 at the hpv16 -M shape: an 8e8-slot counter that holds the batch once
    hp_size = HPV16_COUNTER
    hp_table = torch.zeros(hp_size, dtype=torch.int32, device=dev)
    counter.counter_add_plain(hp_table, hp_hashes, hp_hashes != 0)
    g = counter._counter_mask_cuda(hp_table, hp_hashes, MIN_OCC, counter.INT32_MAX)
    w = counter.counter_mask_plain(hp_table, hp_hashes, MIN_OCC, counter.INT32_MAX)
    err = max_abs_err(g, w)
    if err or not torch.equal(g, w):
        raise AssertionError("counter-mask kernel disagrees with the plain version at the "
                             "hpv16 -M shape")
    worst["counter_mask"] = max(worst["counter_mask"], err)
    hp_sectors = mask_sectors(hp_hashes, hp_size)
    run = lambda: counter._counter_mask_cuda(hp_table, hp_hashes, MIN_OCC,  # noqa: E731
                                             counter.INT32_MAX)
    hp_k7 = {"shape": list(hp_hashes.shape), "counter_slots": hp_size,
             "zero_share": float((hp_hashes == 0).float().mean()),
             "ms": cuda_graph_time_ms(run, 20), "eager_ms": cuda_time_ms(run, 20),
             "plain_ms": cuda_time_ms(lambda: counter.counter_mask_plain(
                 hp_table, hp_hashes, MIN_OCC, counter.INT32_MAX), 3, warmup=1),
             "bound_ms": bounds.bound_ms(2 * bounds.tensor_bytes(hp_hashes) + hp_sectors)}
    hp_k7["bound_share"] = hp_k7["bound_ms"] / hp_k7["ms"]
    say(f"time counter_mask at the hpv16 -M shape {tuple(hp_hashes.shape)} "
        f"({hp_k7['zero_share']:.4f} zeros), {hp_size}-slot counter: {hp_k7['ms']:.4f} ms "
        f"({hp_k7['eager_ms']:.4f} eager) vs {hp_k7['plain_ms']:.4f} ms plain; exact=True; "
        f"bound {hp_k7['bound_ms']:.4f} ms ({hp_sectors} B of sectors)")
    del hp_table
    return {name: (worst[name], t[name], t[name + "_plain"], bound[name], t[name + "_eager"])
            for name in worst}, hp_k7


def check_k2_filter(dev, panel, hashes) -> tuple[int, float, float, float]:
    """K2's filter mode against its plain version on the zika panel in both
    row modes with -N/-D thresholds; -> (max_abs_err, ms, plain_ms,
    eager_ms)."""
    import torch

    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops.probe import _panel_probe_filter_cuda, panel_probe_filter_plain
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    R = panel.num_refs
    worst = 0
    for s in (1000, 50):
        sk, lens = bottom_s_sketch(hashes, s)
        for mode, rows, ln in (("a raw", hashes, None), (f"b sketch s={s}", sk, lens)):
            if s != 1000 and ln is None:
                continue
            for min_diff, min_matches in ((0, -1), (0, FILTER_MIN_MATCHES), (2, 60)):
                got = _panel_probe_filter_cuda(rows, ln, panel.table, R, panel.lens,
                                               min_diff, min_matches)
                want = panel_probe_filter_plain(rows, ln, panel.table, R, panel.lens,
                                                min_diff, min_matches)
                err = max_abs_err(got, want)
                say(f"K2 filter mode {mode} -D {min_diff} -N {min_matches}: exact={err == 0} "
                    f"kept={float(want[3].float().mean()):.4f} "
                    f"flag histogram={torch.bincount(want[4], minlength=8).tolist()}")
                if err or not torch.equal(got, want):
                    raise AssertionError(f"panel-probe filter mode disagrees in mode {mode}")
                worst = max(worst, err)
    eager_ms = cuda_time_ms(lambda: _panel_probe_filter_cuda(hashes, None, panel.table, R,
                                                             panel.lens, 0, FILTER_MIN_MATCHES), 50)
    ms = cuda_graph_time_ms(lambda: _panel_probe_filter_cuda(hashes, None, panel.table, R,
                                                             panel.lens, 0, FILTER_MIN_MATCHES), 20)
    plain_ms = cuda_time_ms(lambda: panel_probe_filter_plain(
        hashes, None, panel.table, R, panel.lens, 0, FILTER_MIN_MATCHES), 5)
    say(f"time panel_probe_filter: {ms:.4f} ms ({eager_ms:.4f} eager) vs {plain_ms:.4f} ms plain "
        f"per call at rows {tuple(hashes.shape)}, table {tuple(panel.table.shape)}")
    return worst, ms, plain_ms, eager_ms


def run_stream_counters(dev, card: str, zika: dict) -> dict:
    """The stream -M 2 -I 40 path (see the module doc)."""
    import torch

    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import stream
    from rkmh_tpu_torch.commands.common import (
        DEFAULT_CHUNK_READS,
        bucketed_batches,
        build_ref_panel_from_files,
        count_read_kmers,
        iter_packed_chunks,
        load_packed,
    )

    tmp = zika["dir"]
    cfg = dict(ref_files=[zika["refs"]], ks=(12,), sketch_size=1000, min_kmer_occ=MIN_OCC,
               max_samples=MAX_SAMPLES)
    out_gpu = os.path.join(tmp, "stream_mi.tsv")
    e2e_s, launches = driven(
        lambda: stream.run(stream.StreamConfig(read_files=[zika["reads"]], out_file=out_gpu,
                                               device="cuda", **cfg)),
        "stream -M -I", ("window_hash", "counter_add", "counter_mask", "panel_probe"))
    with open(out_gpu) as fh:
        n_lines = sum(1 for _ in fh)
    if n_lines != N_SLICE_READS:
        raise AssertionError(f"stream -M -I: {n_lines} lines for {N_SLICE_READS} reads")

    outs = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(tmp, f"stream_mi_head.{device}.tsv")
        stream.run(stream.StreamConfig(read_files=[zika["head"]], out_file=path,
                                       device=device, **cfg))
        outs[device] = read_text(path)
    require_same(outs["cuda"], outs["cpu"], "stream -M -I")
    say(f"stream -M {MIN_OCC} -I {MAX_SAMPLES}: the whole {N_CPU_LINES}-read input "
        "byte-identical on the card and the CPU plain path")

    # the counter pass alone, then the device step over resident batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counter = count_read_kmers(iter_packed_chunks([zika["reads"]], DEFAULT_CHUNK_READS), (12,),
                               stream.DEFAULT_COUNTER_SIZE, B, dev)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    if counter.binned is not True:
        raise AssertionError(f"the counter pass of reads that repeat their k-mers took K6's "
                             f"route binned={counter.binned}")
    panel = build_ref_panel_from_files([zika["refs"]], (12,), 1000, dev,
                                       max_samples=MAX_SAMPLES)
    packed = load_packed([zika["head"]])
    batch = torch.from_numpy(next(bucketed_batches(packed, B))[1]).to(dev)
    step_ms = cuda_time_ms(lambda: engine.classify_codes_table(
        batch, panel, (12,), 1000, 0, -1, counter.table, MIN_OCC), 20)
    res = {"e2e_s": e2e_s, "e2e_reads_per_s": N_SLICE_READS / e2e_s, "count_pass_s": count_s,
           "device_step_ms_per_16k_batch": step_ms,
           "device_step_reads_per_s": batch.shape[0] / (step_ms / 1e3), "launches": launches}
    say(f"stream -M {MIN_OCC} -I {MAX_SAMPLES} on {card}: e2e {res['e2e_reads_per_s']:.1f} "
        f"reads/s ({e2e_s:.2f} s for {N_SLICE_READS} reads, two passes, panel build "
        f"included); counter pass alone {count_s:.2f} s; device step "
        f"{res['device_step_reads_per_s']:.1f} reads/s ({step_ms:.4f} ms per "
        f"{batch.shape[0]}-read batch)")
    return res


def run_filter(dev, card: str, zika: dict) -> dict:
    """The filter -M 2 -I 40 -N 10 path (see the module doc)."""
    from rkmh_tpu_torch.commands import filter_cmd

    tmp = zika["dir"]
    cfg = dict(ref_files=[zika["refs"]], ks=(12,), sketch_size=1000, min_kmer_occ=MIN_OCC,
               max_samples=MAX_SAMPLES, min_matches=FILTER_MIN_MATCHES)
    out_gpu = os.path.join(tmp, "filter.fq")
    stats = {}
    e2e_s, launches = driven(
        lambda: filter_cmd.run(filter_cmd.FilterConfig(read_files=[zika["reads"]],
                                                       out_file=out_gpu, device="cuda", **cfg),
                               stats=stats),
        "filter", ("window_hash", "counter_add", "counter_mask", "panel_probe_filter"))
    with open(out_gpu) as fh:
        n_lines = sum(1 for _ in fh)
    if stats.get("reads") != N_SLICE_READS or n_lines != 4 * stats["kept"]:
        raise AssertionError(f"filter: {n_lines} lines for {stats} reads kept")

    outs = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(tmp, f"filter_head.{device}.fq")
        filter_cmd.run(filter_cmd.FilterConfig(read_files=[zika["head"]], out_file=path,
                                               device=device, **cfg))
        with open(zika["head"], "rb") as stdin:
            both = os.path.join(tmp, f"filter_fi.{device}.txt")
            filter_cmd.run(filter_cmd.FilterConfig(read_files=[zika["head"]], in_stream=True,
                                                   out_file=both, device=device, **cfg),
                           stdin=stdin)
        outs[device] = (read_text(path), read_text(both))
    require_same(outs["cuda"][0], outs["cpu"][0], "filter")
    require_same(outs["cuda"][1], outs["cpu"][1], "filter -f -i")
    n_sample = outs["cuda"][1].count("Sample: ")
    if n_sample != N_CPU_LINES or not outs["cuda"][1].startswith(outs["cuda"][0]):
        raise AssertionError(f"filter -f -i: {n_sample} Sample lines for {N_CPU_LINES} reads")
    say(f"filter: the whole {N_CPU_LINES}-read input byte-identical on the card and the CPU "
        "plain path, in file mode and with -f plus -i (the stream as a file object)")
    res = {"e2e_s": e2e_s, "e2e_reads_per_s": N_SLICE_READS / e2e_s,
           "kept_share": stats["kept"] / N_SLICE_READS, "launches": launches}
    say(f"filter -M {MIN_OCC} -I {MAX_SAMPLES} -N {FILTER_MIN_MATCHES} on {card}: e2e "
        f"{res['e2e_reads_per_s']:.1f} reads/s ({e2e_s:.2f} s for {N_SLICE_READS} reads, two "
        f"passes, panel build and record output included); kept {stats['kept']} "
        f"({res['kept_share']:.4f})")
    return res


def run_hpv16_counter(dev, card: str) -> dict:
    """The hpv16 -M 2 path (see the module doc)."""
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.commands import hpv16_cmd

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        reads, _ = synth.write_hpv16_workload(tmp, N_HPV16_READS, n_rate=HPV16_N_RATE)
        head = os.path.join(tmp, "head.fq")
        with open(reads) as src_fh, open(head, "w") as dst:
            for _ in range(4 * N_HPV16_M_CPU_READS):
                dst.write(src_fh.readline())
        with open(head) as fh:
            head_mbp = sum(len(ln) - 1 for i, ln in enumerate(fh) if i % 4 == 1) / 1e6
        with open(reads) as fh:
            mbp = sum(len(ln) - 1 for i, ln in enumerate(fh) if i % 4 == 1) / 1e6
        cfg = dict(refpath=tmp, ks=(HPV16_K,), batch_size=HPV16_BATCH, min_kmer_occ=MIN_OCC)
        try:
            run_dir = os.path.join(tmp, "run")
            os.makedirs(run_dir)
            os.chdir(run_dir)
            e2e_s, launches = driven(
                lambda: hpv16_cmd.run(hpv16_cmd.Hpv16Config(
                    read_files=[reads], out_file=os.path.join(run_dir, "out.tsv"),
                    device="cuda", **cfg)),
                "hpv16 -M", ("window_hash", "set_table_fill", "counter_add", "counter_mask",
                             "set_probe"))
            n_lines = read_text(os.path.join(run_dir, "out.tsv")).count("\n")
            if n_lines != N_HPV16_READS:
                raise AssertionError(f"hpv16 -M: {n_lines} lines for {N_HPV16_READS} reads")
            outs = {}
            for device in ("cuda", "cpu"):
                wd = os.path.join(tmp, device)
                os.makedirs(wd)
                os.chdir(wd)
                path = os.path.join(wd, "out.tsv")
                hpv16_cmd.run(hpv16_cmd.Hpv16Config(read_files=[head], out_file=path,
                                                    device=device, **cfg))
                outs[device] = (read_text(path),
                                read_text(f"lineage_specific_hashes.{HPV16_K}.tst"))
        finally:
            os.chdir(cwd)
    require_same(outs["cuda"][0], outs["cpu"][0], "hpv16 -M")
    require_same(outs["cuda"][1], outs["cpu"][1], "hpv16 -M .tst")
    say(f"hpv16 -M: the whole {N_HPV16_M_CPU_READS}-read input ({head_mbp:.3f} Mbp) gives "
        "byte-identical stdout and .tst on the card and the CPU plain path")
    res = {"e2e_s": e2e_s, "e2e_mbp_per_s": mbp / e2e_s, "launches": launches}
    say(f"hpv16 -M {MIN_OCC} on {card}: e2e {res['e2e_mbp_per_s']:.3f} Mbp/s "
        f"({e2e_s:.2f} s for {N_HPV16_READS} reads, {mbp:.3f} Mbp, N rate {HPV16_N_RATE}, two "
        "passes, table build included)")
    return res


def head_file(src: str, dst: str, n_reads: int) -> str:
    """The first n_reads records of a FASTQ file into dst."""
    with open(src) as src_fh, open(dst, "w") as out:
        for _ in range(4 * n_reads):
            out.write(src_fh.readline())
    return dst


def head_lines(path: str, n: int) -> str:
    with open(path) as fh:
        return "".join(fh.readline() for _ in range(n))


def same_file(a: str, b: str, what: str) -> None:
    import filecmp

    if not filecmp.cmp(a, b, shallow=False):
        raise AssertionError(f"{what}: {a} and {b} differ ({os.path.getsize(a)} and "
                             f"{os.path.getsize(b)} bytes)")


def report(path: str, card: str, reads: int, seconds: float, extra: str = "") -> dict:
    say(f"{path} on {card}: e2e {reads / seconds:.1f} reads/s ({seconds:.3f} s for {reads} "
        f"reads{extra})")
    return {"e2e_s": seconds, "e2e_reads_per_s": reads / seconds}


def run_ref_sketches(dev, card: str, zika: dict) -> dict:
    """The sketch round trip: ``hash -r refs -k 12 -s 1000 -o P`` (and
    ``--sourmash``), then ``stream --ref-sketches P.rkmh.json`` and ``stream
    -R P.sig`` (through the CLI) over the slice's 2**20 reads, each
    byte-identical to the slice's ``stream -r`` output; and the panel set-up
    seconds from the references against from the sketch file."""
    import torch

    from rkmh_tpu_torch import cli
    from rkmh_tpu_torch.commands import hash_cmd, stream
    from rkmh_tpu_torch.commands.common import build_ref_panel_from_files, load_or_build_panel

    tmp = zika["dir"]
    prefix = os.path.join(tmp, "panel")
    res = {}
    for label, sourmash in (("hash -r -o", False), ("hash -r --sourmash", True)):
        seconds, launches = driven(lambda: hash_cmd.run(hash_cmd.HashConfig(
            read_files=[zika["refs"]], ks=(12,), sketch_size=1000, sourmash_out=sourmash,
            out_prefix=prefix, device="cuda")), label, ("window_hash",))
        res[label] = {"e2e_s": seconds, "launches": launches}
        say(f"{label} on {card}: {seconds:.3f} s for the 60 references")
    want = os.path.join(tmp, "gpu.tsv")  # the slice's stream -r output
    out = os.path.join(tmp, "ref_sketches.tsv")
    seconds, launches = driven(lambda: stream.run(stream.StreamConfig(
        ref_sketches=prefix + ".rkmh.json", read_files=[zika["reads"]], ks=(12,),
        sketch_size=1000, out_file=out, device="cuda")), "stream --ref-sketches",
        ("window_hash", "panel_probe"))
    same_file(out, want, "stream --ref-sketches P.rkmh.json against stream -r")
    res["stream --ref-sketches"] = {**report("stream --ref-sketches", card, N_SLICE_READS,
                                             seconds, ", sketch load included"),
                                    "launches": launches}
    out_r = os.path.join(tmp, "ref_sketches_R.tsv")
    seconds, launches = driven(lambda: cli.main(
        ["stream", "-R", prefix + ".sig", "-f", zika["reads"], "-k", "12", "-s", "1000",
         "-o", out_r, "--device", "cuda"]), "stream -R", ("window_hash", "panel_probe"))
    same_file(out_r, want, "stream -R P.sig against stream -r")
    res["stream -R"] = {**report("stream -R (CLI)", card, N_SLICE_READS, seconds),
                        "launches": launches}
    say(f"sketch round trip: stream --ref-sketches P.rkmh.json and stream -R P.sig "
        f"byte-identical to stream -r over {N_SLICE_READS} reads")
    setup = {}
    for label, fn in (("from -r refs.fa", lambda: build_ref_panel_from_files(
            [zika["refs"]], (12,), 1000, dev)),
                      ("from --ref-sketches", lambda: load_or_build_panel(
            [], prefix + ".rkmh.json", (12,), 1000, dev))):
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best or 1e9, time.perf_counter() - t0)
        setup[label] = best
    say(f"panel set-up on {card}, best of 3: {setup['from -r refs.fa']:.4f} s from the 60 "
        f"references, {setup['from --ref-sketches']:.4f} s from the sketch file")
    res["setup_s"] = setup
    os.remove(out_r)
    return res


def profile_run(fn, label: str, top: int = 10) -> dict:
    """One run of fn under cProfile: wall seconds and the top functions by
    own time (the main thread; the native parse runs on the reader thread)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    ranked = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    say(f"{label} under cProfile: {wall:.2f} s wall; top functions by own time: " + "; ".join(
        f"{os.path.basename(f)}:{ln} {fn_} {v[2]:.3f} s ({v[1]} calls)"
        for (f, ln, fn_), v in ranked))
    return {"wall_s": wall, "top": [(f"{os.path.basename(f)}:{ln} {fn_}", v[2])
                                    for (f, ln, fn_), v in ranked]}


def run_hash_lines(dev, card: str, zika: dict) -> dict:
    """``hash`` over N_HASH_READS reads into a file: the default lines, ``-s
    1000`` and ``-k 12 -k 16``, each with its bytes and seconds, and its
    first N_HASH_CPU_LINES lines against the CPU plain path on the same
    reads; then one default run under cProfile.  The default output stays
    for the resume phase, it and the -s output for phase 39."""
    from rkmh_tpu_torch.commands import hash_cmd

    tmp = zika["dir"]
    reads = head_file(zika["reads"], os.path.join(tmp, "hash_reads.fq"), N_HASH_READS)
    head = head_file(zika["reads"], os.path.join(tmp, "hash_head.fq"), N_HASH_CPU_LINES)
    res = {"reads": reads}
    for label, kw in (("hash", dict(ks=(12,))), ("hash -s 1000", dict(ks=(12,), sketch_size=1000)),
                      ("hash -k 12 -k 16", dict(ks=(12, 16)))):
        out = os.path.join(tmp, f"{label.replace(' ', '_')}.txt")
        seconds, launches = driven(lambda: hash_cmd.run(hash_cmd.HashConfig(
            read_files=[reads], out_file=out, device="cuda", **kw)), label, ("window_hash",))
        nbytes = os.path.getsize(out)
        cpu_out = os.path.join(tmp, "hash_cpu.txt")
        hash_cmd.run(hash_cmd.HashConfig(read_files=[head], out_file=cpu_out, device="cpu", **kw))
        require_same(head_lines(out, N_HASH_CPU_LINES), read_text(cpu_out), label)
        res[label] = {**report(label, card, N_HASH_READS, seconds,
                               f", {nbytes} bytes written"),
                      "bytes": nbytes, "launches": launches}
        say(f"{label}: first {N_HASH_CPU_LINES} lines byte-identical to the CPU plain path")
        if label == "hash":
            res["out"] = out
        elif label == "hash -s 1000":
            res["out -s"] = out
        else:
            os.remove(out)
    prof_out = os.path.join(tmp, "hash_profiled.txt")
    res["profile"] = profile_run(lambda: hash_cmd.run(hash_cmd.HashConfig(
        read_files=[reads], ks=(12,), out_file=prof_out, device="cuda")), "hash (default lines)")
    os.remove(prof_out)
    return res


def run_count(dev, card: str, zika: dict) -> dict:
    """``count --counter-size 640000 -o T.npz --dump`` over the slice's
    2**20 reads (K1 + K6), with the K6 route the counter took; then the
    table of the first N_COUNT_CPU_READS reads, counted on the card and on
    the CPU plain path with the same flags, must be equal.  The table and
    the dump stay for phase 39."""
    import numpy as np

    from rkmh_tpu_torch import convert
    from rkmh_tpu_torch.commands import count_cmd

    tmp = zika["dir"]
    npz, dump = os.path.join(tmp, "count.npz"), os.path.join(tmp, "count_dump.txt")
    stats = {}
    cfg = dict(ks=(12,), counter_size=COUNT_SLOTS, dump=True)
    with open(dump, "w") as fh:
        seconds, launches = driven(lambda: count_cmd.run(count_cmd.CountConfig(
            read_files=[zika["reads"]], out_file=npz, device="cuda", **cfg), out=fh,
            stats=stats), "count", ("window_hash", "counter_add"))
    table = convert.counter_from_npz(npz, "cpu").to_numpy()
    n_dump = read_text(dump).count("\n")
    if n_dump != int((table > 0).sum()) or int(table.sum()) != N_SLICE_READS * 139:
        raise AssertionError(f"count: {n_dump} dump lines, {int(table.sum())} windows counted")
    head = head_file(zika["reads"], os.path.join(tmp, "count_head.fq"), N_COUNT_CPU_READS)
    tables = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(tmp, f"count_head.{device}.npz")
        with open(os.devnull, "w") as sink:
            count_cmd.run(count_cmd.CountConfig(read_files=[head], out_file=path,
                                                device=device, **cfg), out=sink)
        with np.load(path) as z:
            tables[device] = {k: z[k] for k in z.files}
    for key in ("table", "size", "ks"):
        if not np.array_equal(tables["cuda"][key], tables["cpu"][key]):
            raise AssertionError(f"count: the {key} of the first {N_COUNT_CPU_READS} reads "
                                 "differs on the card and the CPU")
    say(f"count: the table of the first {N_COUNT_CPU_READS} reads equal on the card and the CPU "
        f"plain path; K6 route of the 2**20-read run: binned={stats['binned']}")
    return {**report("count --counter-size 640000 -o --dump", card, N_SLICE_READS, seconds,
                     f", {n_dump} occupied slots dumped"), "launches": launches,
            "k6_binned": stats["binned"], "npz": npz, "dump": dump}


def write_search_refs(tmp: str, n: int = N_SEARCH_KMERS) -> str:
    """n distinct 12-mers drawn with a fixed seed from the slice's genomes,
    one per line, plus lowercase tokens, tokens of other lengths and
    tokens with N."""
    import numpy as np

    from rkmh_tpu_torch import synth

    _, genomes = synth.make_panel()
    ascii_g = synth._ACGTN[genomes]
    rng = np.random.default_rng(31)
    mers = set()
    while len(mers) < n:
        r = rng.integers(0, genomes.shape[0], n)
        p = rng.integers(0, genomes.shape[1] - 12, n)
        for a, b in zip(r.tolist(), p.tolist()):
            mers.add(ascii_g[a, b: b + 12].tobytes().decode())
            if len(mers) == n:
                break
    mers = sorted(mers)
    path = os.path.join(tmp, "search_kmers.txt")
    with open(path, "w") as fh:
        fh.write("".join(f"{m}\n" for m in mers))
        fh.write("".join(f"{m.lower()}\n{m[:11]}\n{m}A\n{m[:6]}N{m[7:]}\n"
                         for m in rng.choice(mers, 20)))
    return path


def run_search(dev, card: str, zika: dict, hashes) -> dict:
    """``search`` of N_SEARCH_KMERS reference 12-mers over the slice's 2**20
    reads; the first N_HASH_CPU_LINES lines against the CPU plain path;
    the membership step's device ms on one 16,384-read batch (``hashes``);
    one run under cProfile.  The k-mers and the output stay for phase 39."""
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms
    from rkmh_tpu_torch.commands import search_cmd

    tmp = zika["dir"]
    refs = write_search_refs(tmp)
    out = os.path.join(tmp, "search.txt")
    seconds, launches = driven(lambda: search_cmd.run(search_cmd.SearchConfig(
        ref_files=[refs], read_files=[zika["reads"]], ks=(12,), out_file=out, device="cuda")),
        "search", ("window_hash",))
    head = head_file(zika["reads"], os.path.join(tmp, "search_head.fq"), N_HASH_CPU_LINES)
    cpu_out = os.path.join(tmp, "search_cpu.txt")
    search_cmd.run(search_cmd.SearchConfig(ref_files=[refs], read_files=[head], ks=(12,),
                                           out_file=cpu_out, device="cpu"))
    require_same(head_lines(out, N_HASH_CPU_LINES), read_text(cpu_out), "search")
    n_lines = n_commas = n_empty = 0
    with open(out, "rb") as fh:
        last = b""
        while block := fh.read(1 << 26):
            n_lines += block.count(b"\n")
            n_commas += block.count(b",")
            n_empty += (last + block).count(b"\t\n")  # a line without a k-mer
            last = block[-1:]
    n_hits = n_commas + n_lines - n_empty
    if n_lines != N_SLICE_READS:
        raise AssertionError(f"search: {n_lines} lines for {N_SLICE_READS} reads")
    keys = search_cmd.sorted_keys(search_cmd.load_ref_kmers([refs]), dev)
    member_ms = cuda_graph_time_ms(lambda: search_cmd.member_mask(hashes, keys), 20)
    say(f"search: first {N_HASH_CPU_LINES} lines byte-identical to the CPU plain path; "
        f"{n_hits} reference k-mers found in {N_SLICE_READS} reads; membership step "
        f"(searchsorted + gather + compare, {keys.numel()} keys) {member_ms:.4f} ms per "
        f"{tuple(hashes.shape)} batch")
    res = {**report("search", card, N_SLICE_READS, seconds,
                    f", {keys.numel()} reference hashes"), "launches": launches,
           "membership_ms": member_ms, "hits": n_hits, "refs": refs, "out": out}
    prof_out = os.path.join(tmp, "search_profiled.txt")
    res["profile"] = profile_run(lambda: search_cmd.run(search_cmd.SearchConfig(
        ref_files=[refs], read_files=[zika["reads"]], ks=(12,), out_file=prof_out,
        device="cuda")), "search")
    os.remove(prof_out)
    return res


def cut_mid_line(path: str, share: float = 0.4) -> None:
    """Truncate a file of non-empty lines inside the line at ``share`` of
    its bytes: the line keeps about half of what followed that byte and
    loses its newline."""
    at = int(os.path.getsize(path) * share)
    with open(path, "rb") as fh:
        fh.seek(at)
        at += fh.read(1 << 16).index(b"\n") // 2
    with open(path, "r+b") as fh:
        fh.truncate(at)


def run_resume(dev, card: str, zika: dict, hash_res: dict) -> dict:
    """``stream -o`` and ``hash --out`` over N_HASH_READS reads: each output
    cut mid-line at about 40%, then run again with --resume, must equal the
    uninterrupted bytes."""
    import shutil

    from rkmh_tpu_torch.commands import hash_cmd, stream

    tmp = zika["dir"]
    reads = hash_res["reads"]
    full = os.path.join(tmp, "resume_full.tsv")
    scfg = dict(ref_files=[zika["refs"]], read_files=[reads], ks=(12,), sketch_size=1000,
                device="cuda")
    stream.run(stream.StreamConfig(out_file=full, **scfg))
    res = {}
    for label, want, fn in (
            ("stream --resume", full,
             lambda out: stream.run(stream.StreamConfig(out_file=out, resume=True, **scfg))),
            ("hash --resume", hash_res["out"],
             lambda out: hash_cmd.run(hash_cmd.HashConfig(read_files=[reads], ks=(12,),
                                                          out_file=out, resume=True,
                                                          device="cuda")))):
        part = os.path.join(tmp, "resumed.txt")
        shutil.copyfile(want, part)
        cut_mid_line(part)
        kept = os.path.getsize(part)
        with open(part, "rb") as fh:
            done = sum(block.count(b"\n") for block in iter(lambda: fh.read(1 << 26), b""))
        seconds, launches = driven(lambda: fn(part), label, (
            ("window_hash", "panel_probe") if label.startswith("stream") else ("window_hash",)))
        same_file(part, want, label)
        say(f"{label}: an output cut mid-line at byte {kept} of {os.path.getsize(want)} "
            f"({done} reads done), resumed, equals the uninterrupted bytes")
        res[label] = {**report(label, card, N_HASH_READS - done, seconds,
                               ", the reads after the cut"), "launches": launches}
        os.remove(part)
    os.remove(full)
    return res


def time_slice_library_calls(codes, hashes, card: str) -> dict:
    """K1 at k=16 and at -k 12 -k 16 on a 16,384-read batch (hash's
    default k and multi-k), and ``torch.sort`` of hash -s (``bottom_s_sketch``
    at s = 1000), by graph replay."""
    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms
    from rkmh_tpu_torch.ops.hashing import _window_hashes_cuda
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    res = {}
    for label, ks in (("k=16", [16]), ("k=12,16", [12, 16])):
        out = _window_hashes_cuda(codes, ks, 42)
        res[label] = {"ms": cuda_graph_time_ms(lambda: _window_hashes_cuda(codes, ks, 42), 20),
                      "bound_ms": bounds.bound_ms(bounds.tensor_bytes(codes, out)),
                      "shape": list(out.shape)}
    res["sort_s1000_ms"] = cuda_graph_time_ms(lambda: bottom_s_sketch(hashes, 1000), 20)
    say(f"time K1 on {card}: k=16 {res['k=16']['ms']:.4f} ms (bound "
        f"{res['k=16']['bound_ms']:.4f}), -k 12 -k 16 {res['k=12,16']['ms']:.4f} ms (bound "
        f"{res['k=12,16']['bound_ms']:.4f}) per {tuple(codes.shape)} batch; hash -s 1000's "
        f"torch.sort (bottom_s_sketch) {res['sort_s1000_ms']:.4f} ms per {tuple(hashes.shape)}")
    return res


def time_k6_count_shape(dev, hashes, card: str) -> dict:
    """K6 at count's shape: the stream batch's windows (the counter pass's
    mask derived in the kernel) into count's 640,000-slot table, through
    the bins and as one atomic per element; the route a HashCounter takes
    there; the bound from the sectors the slots reach."""
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops import counter
    from rkmh_tpu_torch.ops.hashing import window_mask

    lens150 = torch.full((hashes.shape[0],), 150, dtype=torch.int32, device=dev)
    windows = (lens150, 160, [12])
    table = torch.zeros(COUNT_SLOTS, dtype=torch.int32, device=dev)
    binned_ms = cuda_graph_time_ms(
        lambda: counter._counter_add_cuda(table, hashes, None, windows, binned=True), 20)
    direct_ms = cuda_graph_time_ms(
        lambda: counter._counter_add_cuda(table, hashes, None, windows, binned=False), 20)
    c = counter.HashCounter(COUNT_SLOTS, dev)
    want = torch.zeros_like(c.table)
    mask = window_mask(lens150, 160, [12])
    for _ in range(2):
        c.add_windows(hashes, lens150, 160, 12)
        counter.counter_add_plain(want, hashes, mask)
    if not torch.equal(c.table, want):
        raise AssertionError("HashCounter at count's table size disagrees with the plain version")
    plain_ms = cuda_time_ms(lambda: counter.counter_add_plain(table, hashes, mask), 5)
    added = counter.slots(hashes[mask], COUNT_SLOTS)
    bound = bounds.bound_ms(bounds.tensor_bytes(hashes, lens150)
                            + 2 * bounds.sector_bytes(torch.unique(added) * 4))
    ms = binned_ms if c.binned else direct_ms
    res = {"counter_slots": COUNT_SLOTS, "route": "binned" if c.binned else "direct",
           "ms": ms, "binned_ms": binned_ms, "direct_ms": direct_ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_share": bound / ms}
    say(f"time counter_add at count's shape on {card}: {tuple(hashes.shape)} into "
        f"{COUNT_SLOTS} slots: through the bins {binned_ms:.4f} ms, one atomic per element "
        f"{direct_ms:.4f} ms, plain {plain_ms:.4f} ms; a HashCounter takes route "
        f"{res['route']} (exact=True); bound {bound:.4f} ms")
    return res


KS_CALL = (1, 12, 16, 21, 31, 32, 33, 40)  # K9: around its packed / byte-wise boundary


def check_k8(dev, cw: dict) -> int:
    """K8 exactly against its plain version on the card: a map holding key
    0, keys >= 2**63, random keys and counts past a word (the overflow),
    queried by every key and as many misses; the call workload's map
    queried by 2**20 read hashes and by the reference's positional
    hashes; the large map by its queries."""
    import numpy as np
    import torch

    from rkmh_tpu_torch import call_engine
    from rkmh_tpu_torch.ops import hashmap

    rng = np.random.default_rng(17)
    keys = np.unique(np.concatenate([
        np.array([0, 2**63, 2**64 - 1, 0x80000001_7FFFFFFF, 0x80000000], dtype=np.uint64),
        rng.integers(0, 2**64 - 1, size=200_000, dtype=np.uint64, endpoint=True)]))
    vals = rng.integers(1, 1000, size=len(keys)).astype(np.int32)
    vals[::97] = 2**31 - 1  # past the 16-bit count field
    table = hashmap.build_sorted_map(keys, vals).to(dev)
    miss = rng.integers(0, 2**64 - 1, size=len(keys), dtype=np.uint64, endpoint=True)
    q = torch.from_numpy(np.concatenate([keys, miss]).view(np.int64)).to(dev)
    cases = [(f"random map (overflow {table.m}), key 0, keys >= 2**63, misses", table, q),
             ("workload map, 2**20 read hashes", cw["table"], cw["read_hashes"]),
             ("workload map, positional hashes", cw["table"],
              call_engine.positional_hashes(cw["codes"], 16)),
             (f"large map ({cw['big_map'].n} keys)", cw["big_map"], cw["big_queries"])]
    worst = 0
    for label, t, h in cases:
        got = hashmap._hashmap_get_cuda(t, h)
        want = hashmap.hashmap_get_plain(t, h)
        err = max_abs_err(got, want)
        say(f"K8 {label}: {h.numel()} queries, {int((want != 0).sum())} found, exact={err == 0}")
        if err or not torch.equal(got, want):
            raise AssertionError(f"hash-map kernel disagrees with the plain version: {label}")
        worst = max(worst, err)
    if int(hashmap.hashmap_get(table, torch.zeros(1, dtype=torch.int64, device=dev))) != 2**31 - 1:
        raise AssertionError("key 0 of the random map did not read its overflow count")
    return worst


def check_k9(dev, cw: dict) -> int:
    """K9 (through call_scan_ref: K1, K8, the glue, K9; and its byte-wise
    route) exactly against call_scan_plain on the card: a 1,500 bp
    reference with runs of N and the map of reads of a mutated sample, at
    each k of KS_CALL and window lengths 1, 100 and more than P; then the
    call workload's reference against its own map (k=16, w=100)."""
    import numpy as np
    import torch

    from rkmh_tpu_torch import call_engine
    from rkmh_tpu_torch.ops import hashmap
    from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain

    worst = 0

    def compare(label, codes, table, k, w):
        nonlocal worst
        got = call_engine.call_scan_ref(codes, table, k, w)
        want = call_engine.call_scan_plain(codes, table, k, w)
        scan = call_engine._call_scan_cuda(codes, table, k, want["depth"], want["avg"],
                                           want["site"], "bytewise")
        names = ("snp_depth", "snp_call", "max_rescue", "del_depth", "del_call")
        err = max(max(max_abs_err(got[n].to(torch.int64), want[n].to(torch.int64))
                      for n in want),
                  max(max_abs_err(a.to(torch.int64), want[n].to(torch.int64))
                      for a, n in zip(scan, names)))
        if err or not all(torch.equal(got[n], want[n]) for n in want) \
                or not all(torch.equal(a, want[n]) for a, n in zip(scan, names)):
            raise AssertionError(f"call-scan kernel disagrees with the plain version: {label}")
        worst = max(worst, err)
        return want

    rng = np.random.default_rng(19)
    ref = rng.integers(0, 4, 1500).astype(np.uint8)
    ref[200:230] = 4
    ref[900] = 4
    ref[1300:1302] = 4
    sample = ref.copy()
    sample[600] = (sample[600] + 1) % 4
    sample = np.delete(sample, 1100)
    reads = sample[rng.integers(0, len(sample) - 150, 300)[:, None] + np.arange(150)]
    reads[rng.random(reads.shape) < 0.005] = 4
    codes = torch.from_numpy(ref).to(dev)
    for k in KS_CALL:
        h = kmer_window_hashes_plain(torch.from_numpy(reads), k)
        table = hashmap.depth_map_from_hashes(h.numpy()).to(dev)
        for w in (1, 100, 5000):
            want = compare(f"k={k} w={w}", codes, table, k, w)
        say(f"K9 k={k} ({'packed and byte-wise routes' if k <= 32 else 'byte-wise route'}), "
            f"w in (1, 100, 5000): exact=True; at w=5000 {int(want['site'].sum())} sites, "
            f"{int(want['snp_call'].sum())} SNP and {int(want['del_call'].sum())} DEL calls")
    want = compare("the call workload", cw["codes"], cw["table"], 16, 100)
    say(f"K9 call workload (k=16, w=100, P={cw['codes'].numel() - 15}): exact=True on both "
        f"routes, {int(want['site'].sum())} sites, {int(want['snp_call'].sum())} SNP and "
        f"{int(want['del_call'].sum())} DEL calls")
    return worst


def time_call_kernels(cw: dict, card: str, k1_windows_per_s: float) -> dict:
    """K8 at the scan's shape (the positional hashes, P ~ 7,900), at 2**20
    read hashes and on the large map, beside the library yardstick
    (torch.searchsorted over the sorted sign-flipped keys, a gather, a
    compare); K9 on the workload reference (packed route, then its
    byte-wise route) and on a 1 Mbp reference against the same map, in
    mutated k-mers per second beside K1's windows per second; each by
    graph replay (eager beside it), with its plain version's time and its
    bound (bench/bounds.py)."""
    from rkmh_tpu_torch import call_engine
    from rkmh_tpu_torch.bench import bounds, call_inputs
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops import hashmap

    table, k = cw["table"], call_inputs.CALL_K
    res = {}
    for label, t, h in (("scan", table, call_engine.positional_hashes(cw["codes"], k)),
                        ("2e20", table, cw["read_hashes"]),
                        ("large_map", cw["big_map"], cw["big_queries"])):
        flipped, values = hashmap.sorted_keys(t)
        if not hashmap.hashmap_get(t, h).equal(hashmap.searchsorted_get(flipped, values, h)):
            raise AssertionError("the searchsorted yardstick disagrees with K8")
        res[f"k8_{label}"] = {
            "queries": h.numel(), "keys": t.n, "map_bytes": t.buf.numel() * 8,
            "ms": cuda_graph_time_ms(lambda: hashmap._hashmap_get_cuda(t, h), 20),
            "eager_ms": cuda_time_ms(lambda: hashmap._hashmap_get_cuda(t, h), 50),
            "plain_ms": cuda_time_ms(lambda: hashmap.hashmap_get_plain(t, h), 5),
            "library_ms": cuda_graph_time_ms(
                lambda: hashmap.searchsorted_get(flipped, values, h), 20),
            "bound_ms": bounds.bound_ms(bounds.hashmap_get_bytes(t, h))}
    for label, codes, route in (("call", cw["codes"], None), ("call_bytewise", cw["codes"],
                                                              "bytewise"),
                                ("1mbp", cw["big"], None)):
        depth, avg, site = call_inputs.scan_inputs(codes, table)
        P = codes.numel() - k + 1
        r = {"positions": P, "mutated_kmers": 4 * k * P, "route": route or "packed",
             "ms": cuda_graph_time_ms(lambda: call_engine._call_scan_cuda(
                 codes, table, k, depth, avg, site, route), 5 if P > 100_000 else 20),
             "eager_ms": cuda_time_ms(lambda: call_engine._call_scan_cuda(
                 codes, table, k, depth, avg, site, route), 5 if P > 100_000 else 50),
             "bound_ms": bounds.bound_ms(bounds.call_scan_bytes(codes, table, k))}
        if label == "call":  # the plain version of 64M mutated k-mers is not timed
            r["plain_ms"] = cuda_time_ms(
                lambda: call_engine.call_scan_plain(codes, table, k, call_inputs.CALL_W), 2)
        r["mutated_kmers_per_s"] = r["mutated_kmers"] / (r["ms"] / 1e3)
        r["k1_windows_per_s"] = k1_windows_per_s
        res[f"k9_{label}"] = r
    for name, r in res.items():
        say(f"time {name} on {card}: " + ", ".join(
            f"{key} {val:.5g}" if isinstance(val, float) else f"{key} {val}"
            for key, val in r.items()))
    return res


def run_call(dev, card: str, cw: dict) -> dict:
    """``commands.call_cmd.run`` on the call workload (k=16, w=100, device
    cuda), the counters zeroed just before and read just after (K1, K8
    and K9 must run); its VCF and a ``-d`` run against the CPU plain
    path's, byte for byte; on three slices of the reference, a ``--resume``
    from the .progress sidecar cut in the middle of its second section
    against the uninterrupted VCF; the seconds by phase, the map and the
    share of planted variants called; K9's launches by route (the packed
    one alone at k=16)."""
    import io

    from rkmh_tpu_torch.commands import call_cmd
    from rkmh_tpu_torch.ops import kernels

    def k9_routes(path):  # K9's launches by route in the run just driven: packed at k=16
        routes = dict(kernels.CALL_SCAN.by_route)
        if not routes.get("packed") or routes.get("bytewise"):
            raise AssertionError(f"{path} did not take K9's packed route alone: {routes}")
        return routes

    tmp = os.path.dirname(cw["ref"])
    kw = dict(ref_files=[cw["ref"]], read_files=[cw["reads"]], ks=(16,), window_len=100)
    vcf = os.path.join(tmp, "gpu.vcf")
    stats: dict = {}
    seconds, launches = driven(lambda: call_cmd.run(call_cmd.CallConfig(
        out_file=vcf, device="cuda", **kw), stats=stats), "call",
        ("window_hash", "hashmap_get", "call_scan"))
    routes = k9_routes("call")
    gpu = read_text(vcf)
    cpu_vcf = os.path.join(tmp, "cpu.vcf")
    t0 = time.perf_counter()
    call_cmd.run(call_cmd.CallConfig(out_file=cpu_vcf, device="cpu", **kw))
    cpu_s = time.perf_counter() - t0
    require_same(gpu, read_text(cpu_vcf), "call VCF")
    depth_gpu, depth_cpu = io.StringIO(), io.StringIO()
    d_seconds, d_launches = driven(lambda: call_cmd.run(call_cmd.CallConfig(
        show_depth=True, device="cuda", **kw), out=depth_gpu), "call -d",
        ("window_hash", "hashmap_get", "call_scan"))
    d_routes = k9_routes("call -d")
    call_cmd.run(call_cmd.CallConfig(show_depth=True, device="cpu", **kw), out=depth_cpu)
    require_same(depth_gpu.getvalue(), depth_cpu.getvalue(), "call -d")

    keys = {"\t".join(ln.split("\t")[:5]) for ln in gpu.splitlines() if ln[:2] != "##"}
    name = "HPV16REF"
    called = sum(f"{name}\t{pos}\t.\t{r}\t{a}" in keys for pos, r, a, _ in cw["variants"])

    seq = "".join(read_text(cw["ref"]).split("\n")[1:])
    multi = os.path.join(tmp, "multi.fa")
    with open(multi, "w") as fh:
        fh.write(f">partA\n{seq[:2600]}\n>partB\n{seq[2500:5100]}\n>partC\n{seq[5000:]}\n")
    mkw = {**kw, "ref_files": [multi]}
    full = os.path.join(tmp, "multi.vcf")
    call_cmd.run(call_cmd.CallConfig(out_file=full, device="cuda", **mkw))
    with open(full + ".progress", "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    done = [i for i, ln in enumerate(lines) if b"ref_done" in ln]
    with open(full + ".progress", "wb") as fh:
        fh.write(b"".join(lines[: done[0] + 1 + (done[1] - done[0]) // 2]))
    want = read_text(full)
    os.remove(full)
    r_seconds, r_launches = driven(lambda: call_cmd.run(call_cmd.CallConfig(
        out_file=full, resume=True, device="cuda", **mkw)), "call --resume",
        ("window_hash", "hashmap_get", "call_scan"))
    r_routes = k9_routes("call --resume")
    require_same(read_text(full), want, "call --resume")
    res = {"e2e_s": seconds, "phase_s": {key: v for key, v in stats.items() if key.endswith("_s")},
           "map": {key: v for key, v in stats.items() if not key.endswith("_s")},
           "planted": len(cw["variants"]), "planted_called": called,
           "planted_called_share": called / len(cw["variants"]), "records": len(keys),
           "cpu_s": cpu_s, "launches": launches, "k9_routes": routes}
    say(f"call on {card}: {seconds:.3f} s e2e for 1,100 reads and a {len(seq)} bp reference "
        f"(CPU plain path {cpu_s:.2f} s, VCF byte-identical); by phase {res['phase_s']}; "
        f"map {res['map']}; {len(keys)} VCF records, {called} of {len(cw['variants'])} planted "
        f"variants called; -d {d_seconds:.3f} s, byte-identical; --resume from a sidecar cut "
        f"mid-section {r_seconds:.3f} s, equal to the uninterrupted VCF")
    return {"call": res,
            "call -d": {"e2e_s": d_seconds, "launches": d_launches, "k9_routes": d_routes},
            "call --resume": {"e2e_s": r_seconds, "launches": r_launches,
                              "k9_routes": r_routes}}


def run_stream_stdin(card: str, zika: dict) -> dict:
    """``stream -i`` in a child process (``python3 -m rkmh_tpu_torch.cli``,
    device cuda): the slice's 2**20 reads piped in must give the file-mode
    run's stdout; then, on a pipe held open, the seconds until the lines
    of 100 reads arrive (the first 100 include the start-up, the next 100
    show the idle flush; the last record written waits for the next
    header, as the parser reads one line ahead)."""
    import queue
    import subprocess
    import threading

    argv = [sys.executable, "-m", "rkmh_tpu_torch.cli", "stream", "-r", zika["refs"], "-i",
            "-k", "12", "-s", "1000"]
    want = os.path.join(zika["dir"], "gpu.tsv")  # the slice's file-mode output
    out = os.path.join(zika["dir"], "stdin.tsv")
    t0 = time.perf_counter()
    with open(zika["reads"], "rb") as src, open(out, "wb") as dst:
        rc = subprocess.run(argv, stdin=src, stdout=dst, cwd=REPO, timeout=600).returncode
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"stream -i exited {rc}")
    same_file(out, want, "stream -i against file mode")
    os.remove(out)

    with open(zika["reads"], "rb") as fh:
        records = [b"".join(fh.readline() for _ in range(4)) for _ in range(200)]
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=REPO)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    # the parser reads one line past a FASTQ record before it yields the
    # record, so the last record written waits for the next header (or EOF)
    got, waits = [], []
    try:
        for part, expect in ((records[:100], 99), (records[100:], 100)):
            t0 = time.perf_counter()
            proc.stdin.write(b"".join(part))
            proc.stdin.flush()
            for _ in range(expect):
                got.append(lines.get(timeout=300))
            waits.append(time.perf_counter() - t0)
        proc.stdin.close()
        got.append(lines.get(timeout=120))
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(10)
    if rc != 0:
        raise AssertionError(f"stream -i on an open pipe exited {rc}")
    require_same(b"".join(got).decode(), head_lines(want, 200), "stream -i on an open pipe")
    res = {"e2e_s": seconds, "e2e_reads_per_s": N_SLICE_READS / seconds,
           "first_100_lines_s": waits[0], "next_100_lines_s": waits[1]}
    say(f"stream -i on {card}: {N_SLICE_READS} reads piped in, {res['e2e_reads_per_s']:.1f} "
        f"reads/s ({seconds:.3f} s, the child's start-up included), stdout equal to file mode; "
        f"on an open pipe the lines of the first 100 reads (99: the last waits for the next "
        f"header) arrived after {waits[0]:.3f} s (start-up included), of the next 100 after "
        f"{waits[1]:.3f} s")
    return res


# ---- phases 25-29: hpv16's sorted-panel fallback (K10), the panel probe past
# 8,192 references (K11), --metrics and the profile hook

N_TYPES_FALLBACK = 640       # synthetic type genomes whose bucket table passes the cap
WIDE_RS = (8193, 12288, 20000)
K2_SWEEP_RS = (257, 1024, 4096, 8192)  # K11 timed beside K2's shared-memory route
N_WIDE_REFS = 12288          # phase 28: a gene-panel scale of references
WIDE_REF_LEN = 1000
WIDE_SKETCH = 32             # s = 1000 would make the table ~0.4 TB (see run_wide_stream)
N_WIDE_READS = 1 << 18
N_WIDE_CPU_LINES = 16384
N_METRICS_READS = 16384


def sorted_rows_of(dev, codes, lens):
    """K1 then the full-width sort, cut to the batch's probe width, as
    ``engine.hpv16_sorted_batch`` takes them -> (rows, lens, K1 hashes)."""
    import torch

    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    x = torch.from_numpy(codes).to(dev)
    hashes = multi_k_window_hashes(x, [HPV16_K])
    full, sk_lens = bottom_s_sketch(hashes, hashes.shape[-1])
    return full[:, : engine.hpv16_compact_width(lens, x.shape[1], (HPV16_K,))], sk_lens, hashes


def check_k10(dev, tb, packed) -> tuple[int, dict]:
    """K10 against its plain version on the card (see the module doc), then
    its times, bound and library yardstick on the 512-read batch."""
    import numpy as np
    import torch

    from rkmh_tpu_torch import convert
    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops.lookup import build_sorted_panel
    from rkmh_tpu_torch.ops.sketch import INT64_MIN, SENTINEL, bottom_s_sketch
    from rkmh_tpu_torch.ops.sorted_probe import _sorted_probe_cuda, sorted_probe_plain

    panel = tb.comb_sorted
    T, U = len(tb.type_names), tb.n_lin + tb.n_sub
    if (T + U) % 32 == 0 or not ((panel.keys < 0).any() and (panel.keys >= 0).any()):
        raise AssertionError("the fallback panel should hold a partial mask word and keys "
                             "on both sides of 2**63")
    lens = packed.lens[:HPV16_BATCH]
    codes = packed.codes[:HPV16_BATCH, : -(-int(lens.max()) // 128) * 128]
    rows, sk_lens, hashes = sorted_rows_of(dev, codes, lens)
    rng = np.random.default_rng(25)
    zeroed = hashes.clone()  # -M: the hashes counted below min_occ become 0
    zeroed[torch.from_numpy(rng.random(tuple(hashes.shape)) < 0.4).to(dev)] = 0
    z_rows, z_lens = bottom_s_sketch(zeroed, zeroed.shape[-1])
    z_rows = z_rows[:, : rows.shape[1]]
    one_val = rows.clone()
    one_val[:] = rows[:, :1]  # rows of one repeated value
    one_val[sk_lens == 0] = SENTINEL
    pool = panel.keys[torch.randperm(panel.keys.numel(), device=dev)[:4000]] ^ INT64_MIN
    one_ref = convert.sorted_panel_from_numpy(*build_sorted_panel(
        [pool[:3000].cpu().numpy()], num_refs=1), dev)  # R = 1
    mix = torch.sort(torch.cat([pool, pool[:500]])[None] ^ INT64_MIN).values ^ INT64_MIN
    cases = [("512-read batch", rows, sk_lens, panel, T, U),
             ("rows of one repeated value", one_val, sk_lens, panel, T, U),
             ("-M-zeroed rows", z_rows, z_lens, panel, T, U),
             ("R = 1", mix, torch.tensor([mix.shape[1]], device=dev), one_ref, 1, 0),
             *edge_directory_cases(dev)]
    worst = 0
    for label, r, ln, p, t, u in cases:
        got = _sorted_probe_cuda(r, ln, p, t, u)
        want = sorted_probe_plain(r, ln, p, t, u)
        err = max_abs_err(got, want)
        say(f"K10 {label}: rows {tuple(r.shape)}, keys {p.keys.numel()}, R = {t + u}, "
            f"exact={err == 0}, mean shared={want[:, 1].float().mean().item():.1f}")
        if err or not torch.equal(got, want):
            raise AssertionError(f"sorted-probe kernel disagrees with the plain version on {label}")
        worst = max(worst, err)
    if int((sk_lens > 2048).sum()) == 0:
        raise AssertionError("no read of the batch spans more than one segment")

    q = rows[(torch.arange(rows.shape[1], device=dev)[None, :] < sk_lens[:, None])
             & (rows != SENTINEL)]
    q = torch.unique_consecutive(q) ^ INT64_MIN  # run starts (rows are sorted within reads)
    keys, masks = panel.keys, panel.masks

    def library():
        return masks[torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)]

    t = {"ms": cuda_graph_time_ms(lambda: _sorted_probe_cuda(rows, sk_lens, panel, T, U), 10),
         "eager_ms": cuda_time_ms(lambda: _sorted_probe_cuda(rows, sk_lens, panel, T, U), 20),
         "plain_ms": cuda_time_ms(lambda: sorted_probe_plain(rows, sk_lens, panel, T, U), 3,
                                  warmup=1),
         "library_ms": cuda_graph_time_ms(library, 10)}
    work = bounds.sorted_probe_work(rows, sk_lens, keys, masks, U)
    t["bound_ms"] = bounds.bound_ms(work.nbytes)
    say(f"time sorted_probe (K10): {t['ms']:.4f} ms ({t['eager_ms']:.4f} eager) vs "
        f"{t['plain_ms']:.4f} ms plain per {HPV16_BATCH}-read batch, rows {tuple(rows.shape)}; "
        f"{work.probes} run starts probed in {keys.numel()} keys under a 2**{panel.bits}-bucket "
        f"directory, {work.hits} found, {work.found} distinct keys; bound "
        f"{t['bound_ms']:.4f} ms ({work.nbytes} bytes: rows, lens, output, a key and its mask "
        f"row a distinct key found); library (torch.searchsorted of the {q.numel()} run starts "
        f"+ the mask gather) {t['library_ms']:.4f} ms")
    return worst, t


def edge_directory_cases(dev) -> list:
    """K10's edge directories: one bucket holding every key of a small
    panel (the binary search inside a bucket), a panel of one key, and
    keys on both sides of 2**63 with empty buckets around them; 40
    references, rows of 120 hashes half of them keys."""
    import numpy as np
    import torch

    from rkmh_tpu_torch import convert
    from rkmh_tpu_torch.ops.lookup import build_sorted_panel
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    rng = np.random.default_rng(2510)
    sets = {
        "one bucket holding every key": (np.uint64(0xABCDE) << np.uint64(44))
        | rng.integers(0, 2**44, 3000, dtype=np.uint64),
        "U = 1": np.array([2**63 + 5], dtype=np.uint64),
        "empty buckets on both sides of 2**63": np.concatenate([
            2**63 - 1 - rng.integers(0, 2**40, 300, dtype=np.uint64),
            2**63 + rng.integers(0, 2**40, 300, dtype=np.uint64)]),
    }
    cases = []
    for label, keys in sets.items():
        keys = np.unique(keys)
        panel = convert.sorted_panel_from_numpy(*build_sorted_panel(
            [rng.choice(keys, max(1, keys.size // 2)) for _ in range(40)], num_refs=40), dev)
        sizes = panel.dir.diff()
        if label.startswith("one") and int((sizes > 0).sum()) != 1:
            raise AssertionError("the one-bucket panel spreads over several buckets")
        strangers = rng.integers(1, 2**64 - 1, 200, dtype=np.uint64)
        raw = np.concatenate([rng.choice(keys, (64, 60)), rng.choice(strangers, (64, 60))], 1)
        rows, lens = bottom_s_sketch(torch.from_numpy(raw.view(np.int64)).to(dev), 120)
        cases.append((label, rows, lens, panel, 30, 10))
    return cases


def run_hpv16_fallback(dev, card: str) -> tuple[dict, dict]:
    """Phases 25-26: the 640-type refpath past the cap (see the module doc)."""
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.commands import hpv16_cmd
    from rkmh_tpu_torch.commands.common import load_packed

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        reads, _ = synth.write_hpv16_workload(tmp, N_HPV16_READS, num_types=N_TYPES_FALLBACK)
        packed = load_packed([reads])
        mbp = int(packed.lens.sum()) / 1e6
        say(f"hpv16 fallback input: {N_TYPES_FALLBACK} types, {N_HPV16_READS} reads, "
            f"{mbp:.3f} Mbp, made in {time.perf_counter() - t0:.2f} s")
        cfg = dict(refpath=tmp, ks=(HPV16_K,), batch_size=HPV16_BATCH)
        tb = hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(**cfg, tst_file=False),
                                    (HPV16_K,), dev)
        if tb.comb_sorted is None:
            raise AssertionError("the 640-type panel did not take the sorted-key panel")
        T, U = len(tb.type_names), tb.n_lin + tb.n_sub
        sp = tb.comb_sorted
        growth = sp.nbytes / (sp.nbytes - sp.directory_bytes)
        say(f"hpv16 fallback panel: projected bucket table {tb.projected_bytes} bytes "
            f"({tb.projected_bytes / 2**30:.2f} GiB) past the 2,048 MB cap; sorted panel "
            f"{sp.keys.numel()} keys x {sp.mask_words} mask words and a directory of 2**{sp.bits}"
            f" + 1 entries ({sp.directory_bytes} bytes, built in {tb.setup_s['directory']:.3f} "
            f"s) = {sp.nbytes} bytes on the card ({growth:.4f} x the keys and masks alone); "
            f"{T} types + {U} groups; set-up s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in tb.setup_s.items()))
        err_k10, times = check_k10(dev, tb, packed)
        del packed

        outs = {}
        try:
            for device in ("cuda", "cpu"):
                wd = os.path.join(tmp, device)
                os.makedirs(wd)
                os.chdir(wd)
                path = os.path.join(wd, "out.tsv")
                files = [reads] if device == "cuda" else [head_file(
                    reads, os.path.join(tmp, "head.fq"), N_HPV16_CPU_LINES)]
                run = lambda: hpv16_cmd.run(hpv16_cmd.Hpv16Config(  # noqa: E731
                    read_files=files, out_file=path, device=device, **cfg))
                if device == "cuda":
                    e2e_s, launches = driven(run, "hpv16 fallback",
                                             ("window_hash", "sorted_probe"))
                    if launches["set_probe"]:
                        raise AssertionError("the hpv16 fallback launched the set probe")
                else:
                    run()
                outs[device] = read_text(path)
            os.chdir(os.path.join(tmp, "cuda"))
            m_s, m_launches = driven(
                lambda: hpv16_cmd.run(hpv16_cmd.Hpv16Config(
                    read_files=[reads], out_file="m.tsv", device="cuda", min_kmer_occ=MIN_OCC,
                    **cfg)), "hpv16 -M fallback",
                ("window_hash", "counter_add", "counter_mask", "sorted_probe"))
            m_lines = read_text("m.tsv").count("\n")
        finally:
            os.chdir(cwd)
    gpu_lines = outs["cuda"].splitlines(keepends=True)
    if len(gpu_lines) != N_HPV16_READS or m_lines != N_HPV16_READS:
        raise AssertionError(f"hpv16 fallback: {len(gpu_lines)} and {m_lines} lines for "
                             f"{N_HPV16_READS} reads")
    require_same("".join(gpu_lines[:N_HPV16_CPU_LINES]), outs["cpu"], "hpv16 fallback")
    res = {"e2e_s": e2e_s, "e2e_mbp_per_s": mbp / e2e_s, "launches": launches,
           "projected_table_bytes": tb.projected_bytes, "panel_bytes": tb.comb_sorted.nbytes,
           "directory_bytes": tb.comb_sorted.directory_bytes, "setup_s": tb.setup_s}
    say(f"hpv16 fallback on {card}: e2e {res['e2e_mbp_per_s']:.3f} Mbp/s ({e2e_s:.2f} s for "
        f"{N_HPV16_READS} reads, {mbp:.3f} Mbp, panel build and parse included); first "
        f"{N_HPV16_CPU_LINES} lines byte-identical to the CPU plain path; -M {MIN_OCC} "
        f"{mbp / m_s:.3f} Mbp/s ({m_s:.2f} s, two passes)")
    return res, {"err": err_k10, **times,
                 "m": {"e2e_s": m_s, "e2e_mbp_per_s": mbp / m_s, "launches": m_launches}}


def run_hpv16_capped(tmp: str, cfg: dict, table_lines: list) -> dict:
    """The published 182-type panel under RKMH_TPU_SET_TABLE_MAX_MB=256 (its
    480 MiB table is past it) on the card: lines byte-identical to its
    bucket-table run; K10 runs, K3 does not."""
    from rkmh_tpu_torch.commands import hpv16_cmd

    cwd = os.getcwd()
    wd = os.path.join(tmp, "capped")
    os.makedirs(wd)
    old = os.environ.get("RKMH_TPU_SET_TABLE_MAX_MB")
    os.environ["RKMH_TPU_SET_TABLE_MAX_MB"] = "256"
    try:
        os.chdir(wd)
        seconds, launches = driven(lambda: hpv16_cmd.run(hpv16_cmd.Hpv16Config(
            **cfg, out_file="out.tsv", device="cuda")),
            "hpv16 capped", ("window_hash", "sorted_probe"))
        lines = read_text("out.tsv").splitlines(keepends=True)
    finally:
        os.chdir(cwd)
        if old is None:
            del os.environ["RKMH_TPU_SET_TABLE_MAX_MB"]
        else:
            os.environ["RKMH_TPU_SET_TABLE_MAX_MB"] = old
    if launches["set_probe"]:
        raise AssertionError("the capped hpv16 run launched the set probe")
    require_same("".join(lines), "".join(table_lines), "hpv16 under a 256 MB cap")
    say(f"hpv16 182 types under RKMH_TPU_SET_TABLE_MAX_MB=256: the sorted-key panel, "
        f"{len(lines)} lines byte-identical to the bucket-table run ({seconds:.2f} s)")
    return {"e2e_s": seconds, "launches": launches}


def _random_panel_table(R: int, seed: int, t: int = 24, n_reads: int = 256):
    """A bucket table over R references of t values from one pool, and
    n_reads raw rows of 149 hashes drawn from it."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.ops.lookup import build_panel_table

    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=4 * t * 64, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    sk = np.sort(rng.choice(pool, (R, t)).view(np.uint64), axis=1).view(np.int64)
    table = build_panel_table(sk, np.full(R, t, np.int32)).table.view(np.int32)
    reads = rng.choice(pool, size=(n_reads, 149))
    reads[rng.random(reads.shape) < 0.1] = 0
    reads[1::7, :40] = pool[3]
    return torch.from_numpy(table), torch.from_numpy(reads)


def check_k11(dev) -> tuple[int, dict]:
    """K11 on its packed table (``ops/probe.device_table``: packed on the
    host, copied alone) against the plain versions on the logical table at
    R = 8,193, 12,288 and 20,000 (both epilogues, both row modes), on a
    table of one occupied slot, and against K2 at R = 8,192; then K11
    beside K2 at R = 257, 1,024, 4,096 and 8,192 on 16,384 rows, timed."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms
    from rkmh_tpu_torch.bench.wide_inputs import PAST, straddling_panel
    from rkmh_tpu_torch.ops.lookup import build_panel_table
    from rkmh_tpu_torch.ops.probe import (
        _panel_probe_cuda,
        _panel_probe_filter_cuda,
        device_table,
        pack_wide_table,
        panel_probe_filter_plain,
        panel_probe_plain,
    )
    from rkmh_tpu_torch.ops.sketch import SENTINEL, bottom_s_sketch

    worst = 0
    for R in WIDE_RS:
        ref_sk, ref_lens, reads, set_lens = straddling_panel(R, seed=R, n_reads=512, width=149)
        logical = torch.from_numpy(build_panel_table(ref_sk, ref_lens).table.view(np.int32))
        wide = device_table(logical, R, dev)
        table = logical.to(dev)
        raw = torch.from_numpy(reads).to(dev)
        set_lens = torch.from_numpy(set_lens).to(dev)
        sk, lens = bottom_s_sketch(raw, 32)
        for mode, rows, ln in (("raw", raw, None), ("sorted", sk, lens)):
            for md, mm in ((0, -1), (1, 9)):
                got = _panel_probe_cuda(rows, ln, wide, R, md, mm)
                want = panel_probe_plain(rows, ln, table, R, md, mm)
                got_f = _panel_probe_filter_cuda(rows, ln, wide, R, set_lens, md, mm)
                want_f = panel_probe_filter_plain(rows, ln, table, R, set_lens, md, mm)
                err = max(max_abs_err(got, want), max_abs_err(got_f, want_f))
                if err or not (torch.equal(got, want) and torch.equal(got_f, want_f)):
                    raise AssertionError(f"K11 disagrees with the plain version at R = {R}, "
                                         f"{mode} rows, -D {md} -N {mm}")
                worst = max(worst, err)
        if want[0, :3].tolist() != [100, PAST, PAST - 2]:
            raise AssertionError(f"K11 inputs lost their straddling ties at R = {R}")
        say(f"K11 R = {R}: table {tuple(table.shape)} ({table.numel() * 4} bytes), packed "
            f"{wide.nbytes} bytes (Wm = {wide.mask_words}, rows of {wide.rows.shape[1]} words), "
            f"raw and sorted rows, stream and filter epilogues: exact; firsts across 8,192 "
            f"{want[0, :3].tolist()}")

    one = np.full((PAST + 1, 1), SENTINEL, dtype=np.int64)
    one[PAST, 0] = 12345
    logical = torch.from_numpy(build_panel_table(one, (one[:, 0] != SENTINEL).astype(np.int32))
                               .table.view(np.int32))
    wide = device_table(logical, PAST + 1, dev)
    rows = torch.tensor([[12345, 0, 7], [1, 2, 3], [12345, 12345, 5]], device=dev)
    for r, ln in ((rows, None), bottom_s_sketch(rows, 3)):
        got = _panel_probe_cuda(r, ln, wide, PAST + 1, 0, -1)
        if wide.rows.shape[0] != 1 or not torch.equal(
                got, panel_probe_plain(r, ln, logical.to(dev), PAST + 1, 0, -1)):
            raise AssertionError("K11 disagrees with the plain version on one occupied slot")
    say(f"K11 on a WideTable of one occupied slot: exact, best {got[0].tolist()}")

    table, raw = _random_panel_table(PAST, 27)
    table, raw = table.to(dev), raw.to(dev)
    wide = pack_wide_table(table, PAST)
    sk, lens = bottom_s_sketch(raw, 32)
    for rows, ln in ((raw, None), (sk, lens)):
        k2 = _panel_probe_cuda(rows, ln, table, PAST, 1, 3, wide=False)
        k11 = _panel_probe_cuda(rows, ln, wide, PAST, 1, 3, wide=True)
        if not torch.equal(k2, k11) or not torch.equal(k2, panel_probe_plain(rows, ln, table,
                                                                             PAST, 1, 3)):
            raise AssertionError("K11 and K2 disagree at R = 8,192")
    say("K11 at R = 8,192: the packed table's answer equals K2's on the logical table and the "
        "plain version's, raw and sorted rows")

    sweep = {}
    for R in K2_SWEEP_RS:
        table, raw = _random_panel_table(R, 27 + R, n_reads=B)
        table, raw = table.to(dev), raw.to(dev)
        wide = pack_wide_table(table, R)
        sk, lens = bottom_s_sketch(raw, 32)
        for mode, rows, ln in (("raw", raw, None), ("sorted", sk, lens)):
            k2 = lambda: _panel_probe_cuda(rows, ln, table, R, 0, -1, wide=False)  # noqa: E731
            k11 = lambda: _panel_probe_cuda(rows, ln, wide, R, 0, -1, wide=True)  # noqa: E731
            if not torch.equal(k2(), k11()):
                raise AssertionError(f"K11 and K2 disagree at R = {R}, {mode} rows")
            sweep[f"{R} {mode}"] = {"k2_ms": cuda_graph_time_ms(k2, 5),
                                    "k11_ms": cuda_graph_time_ms(k11, 5)}
            say(f"K11 beside K2 at R = {R}, {mode} rows {tuple(rows.shape)}: K2 "
                f"{sweep[f'{R} {mode}']['k2_ms']:.4f} ms, K11 {sweep[f'{R} {mode}']['k11_ms']:.4f}"
                " ms")
    return worst, sweep


def run_wide_stream(dev, card: str) -> tuple[dict, dict]:
    """Phase 28: stream over 12,288 references of 1,000 bp (k = 12, s = 32)
    and 2**18 reads of 150 bp through ``commands.stream.run`` on the card;
    then K11 timed on its batch beside K2 on the first 8,192 references."""
    import numpy as np
    import torch

    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import stream
    from rkmh_tpu_torch.commands.common import load_packed
    from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
    from rkmh_tpu_torch.ops.intersect import occ_ranks
    from rkmh_tpu_torch.ops.lookup import build_panel_table, projected_table_bytes
    from rkmh_tpu_torch.ops.probe import _panel_probe_cuda, pack_wide_table, panel_probe_plain

    say(f"wide stream: s = {WIDE_SKETCH}, cut from rkmh's s = 1000: every bucket of the "
        f"table holds 3 + ceil(R/32) words a slot, so at R = {N_WIDE_REFS} and s = 1000 the "
        "table would be ~0.4 TB, past one card; a panel of this many references runs only "
        "with a small sketch")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        refs, reads, names, src = synth.write_workload(tmp, N_WIDE_READS, num_refs=N_WIDE_REFS,
                                                       genome_len=WIDE_REF_LEN, seed=28)
        ref_packed = load_packed([refs])
        ref_sk, ref_lens = engine.sketch_batch(torch.from_numpy(ref_packed.codes).to(dev),
                                               (12,), WIDE_SKETCH)
        valid = (torch.arange(ref_sk.shape[1], device=dev)[None, :] < ref_lens[:, None])
        keys = torch.stack([ref_sk[valid], occ_ranks(ref_sk)[valid]])
        n_entries = int(torch.unique(keys, dim=1).shape[1])
        projected = projected_table_bytes(n_entries, N_WIDE_REFS, policy="narrow")
        say(f"wide stream input: {N_WIDE_REFS} refs x {WIDE_REF_LEN} bp, {N_WIDE_READS} reads x "
            f"150 bp, made in {time.perf_counter() - t0:.2f} s; {n_entries} (hash, occ) "
            f"entries: projected table {projected} bytes ({projected / 2**30:.2f} GiB)")
        n_reads = N_WIDE_READS
        if projected > 12 << 30:  # the card holds the table and the batches' work
            n_reads //= 2
            reads = head_file(reads, os.path.join(tmp, "half.fq"), n_reads)
            src = src[:n_reads]
            say(f"wide stream: the projected table passes 12 GiB; {n_reads} reads")
        out_gpu = os.path.join(tmp, "gpu.tsv")
        cfg = dict(ref_files=[refs], ks=(12,), sketch_size=WIDE_SKETCH)
        e2e_s, launches = driven(
            lambda: stream.run(stream.StreamConfig(read_files=[reads], out_file=out_gpu,
                                                   device="cuda", **cfg)),
            "stream 12,288 refs", ("window_hash", "panel_probe_wide"))
        gpu = read_text(out_gpu)
        if gpu.count("\n") != n_reads:
            raise AssertionError(f"wide stream: {gpu.count(chr(10))} lines for {n_reads}")
        head = head_file(reads, os.path.join(tmp, "head.fq"), N_WIDE_CPU_LINES)
        out_cpu = os.path.join(tmp, "cpu.tsv")
        t0 = time.perf_counter()
        stream.run(stream.StreamConfig(read_files=[head], out_file=out_cpu, device="cpu",
                                       batch_size=512, **cfg))
        cpu_s = time.perf_counter() - t0
        require_same("".join(gpu.splitlines(keepends=True)[:N_WIDE_CPU_LINES]),
                     read_text(out_cpu), "stream 12,288 refs")
        assigned = np.array([ln.split("\t", 1)[0] for ln in gpu.splitlines()])
        share = float(np.mean(assigned == np.asarray(names)[src]))
        # phase 35: the same run with the panel in 2 shards of 6,144 references
        out_grid = os.path.join(tmp, "grid.tsv")
        label = "stream 12,288 refs --devices 4 --tp 2"
        grid_s, grid_launches = driven(
            lambda: stream.run(stream.StreamConfig(
                read_files=[reads], out_file=out_grid, device="cuda", devices=GRID, tp=2,
                mesh_devices=(torch.device("cuda", 0),) * GRID, **cfg)),
            label, ("window_hash", "panel_probe_partial"))
        same_file(out_grid, out_gpu, label)
        sharded = sharded_report(label, card, n_reads, grid_s, e2e_s, grid_launches)
        t0 = time.perf_counter()
        pt = build_panel_table(ref_sk.cpu().numpy(), ref_lens.cpu().numpy())
        build_s = time.perf_counter() - t0
        logical = torch.from_numpy(pt.table.view(np.int32))
        del pt
        t0 = time.perf_counter()
        wide = pack_wide_table(logical, N_WIDE_REFS)  # on the host, as the path packs it
        pack_s = time.perf_counter() - t0
        wide = wide.to(dev)
        table = logical.to(dev)  # the plain version's and the bound's
        say(f"stream 12,288 refs on {card}: e2e {n_reads / e2e_s:.1f} reads/s "
            f"({e2e_s:.2f} s, panel build and parse included; the host table build alone "
            f"{build_s:.2f} s, logical table {tuple(table.shape)} = {table.numel() * 4} bytes "
            f"on the host; packed on the host in {pack_s:.3f} s: {wide.nbytes} bytes on the "
            f"card, slots {tuple(wide.slots.shape)}, rows {tuple(wide.rows.shape)}); first "
            f"{N_WIDE_CPU_LINES} lines byte-identical to the CPU plain path ({cpu_s:.2f} s on "
            f"the CPU); assigned to the source reference {share:.4f}")

        # K11 on one 16,384-read batch of the path, raw rows and the path's sorted rows,
        # beside K2 on a table of the first 8,192 references
        packed = load_packed([head])
        x = torch.from_numpy(packed.codes[:B]).to(dev)
        raw = multi_k_window_hashes(x, (12,))
        sk, lens = engine.bottom_s_sketch(raw, WIDE_SKETCH)
        t8 = torch.from_numpy(build_panel_table(ref_sk[:8192].cpu().numpy(),
                                                ref_lens[:8192].cpu().numpy())
                              .table.view(np.int32)).to(dev)
        times = {}
        for label, rows, ln in (("raw", raw, None), ("sorted", sk, lens)):
            work = bounds.wide_probe_work(rows, ln, wide)
            k11 = lambda: _panel_probe_cuda(rows, ln, wide, N_WIDE_REFS, 0, -1)  # noqa: E731
            times[label] = {
                "ms": cuda_graph_time_ms(k11, 5), "eager_ms": cuda_time_ms(k11, 10),
                "plain_ms": cuda_time_ms(
                    lambda: panel_probe_plain(rows, ln, table, N_WIDE_REFS, 0, -1), 1, warmup=1),
                "bound_ms": bounds.bound_ms(work.nbytes),
                "k2_8192_ms": cuda_graph_time_ms(
                    lambda: _panel_probe_cuda(rows, ln, t8, 8192, 0, -1), 5),
                "hits_per_read": work.hits / B, "entries_found": work.found}
            if not torch.equal(k11(), panel_probe_plain(rows, ln, table, N_WIDE_REFS, 0, -1)):
                raise AssertionError(f"K11 disagrees with the plain version on the {label} "
                                     "rows of the wide stream batch")
            say(f"time panel_probe_wide (K11) {label} rows {tuple(rows.shape)}, R = "
                f"{N_WIDE_REFS}: {times[label]['ms']:.4f} ms ({times[label]['eager_ms']:.4f} "
                f"eager) vs {times[label]['plain_ms']:.4f} ms plain; K2 at R = 8,192 "
                f"{times[label]['k2_8192_ms']:.4f} ms; {work.hits / B:.2f} hits a read, "
                f"{work.found} distinct entries; bound {times[label]['bound_ms']:.4f} ms "
                f"({work.nbytes} bytes: rows, lens, output, an entry and its mask row a "
                f"distinct entry hit)")
    res = {"e2e_s": e2e_s, "e2e_reads_per_s": n_reads / e2e_s, "launches": launches,
           "sharded": sharded, "host_table_build_s": build_s, "pack_s": pack_s, "packed_table_bytes": wide.nbytes,
           "logical_table_bytes": table.numel() * 4, "projected_table_bytes": projected}
    return res, times


def run_metrics(zika: dict) -> dict:
    """Phase 29: ``stream --metrics`` over the first 16,384 slice reads (the
    JSON line's reads and bp), then the same run under RKMH_TPU_PROFILE (a
    trace naming the K1 and K2 kernels)."""
    import contextlib
    import io

    from rkmh_tpu_torch import cli, observability

    argv = ["stream", "-r", zika["refs"], "-f", zika["head"], "-k", "12", "--metrics",
            "-o", os.path.join(zika["dir"], "metrics.tsv")]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        if cli.main(argv) != 0:
            raise AssertionError("stream --metrics failed")
    line = json.loads([ln for ln in err.getvalue().splitlines() if ln.startswith("{")][-1])
    if (line["reads"], line["bp"]) != (N_METRICS_READS, N_METRICS_READS * 150):
        raise AssertionError(f"--metrics counted {line['reads']} reads, {line['bp']} bp")
    say(f"stream --metrics: {json.dumps(line)}")
    trace_dir = os.path.join(zika["dir"], "trace")
    os.environ["RKMH_TPU_PROFILE"] = trace_dir
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            if cli.main(argv[:-3] + argv[-2:]) != 0:
                raise AssertionError("stream under RKMH_TPU_PROFILE failed")
    finally:
        del os.environ["RKMH_TPU_PROFILE"]
    path = os.path.join(trace_dir, observability.TRACE_FILE)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernel_names = {ev["name"] for ev in events if ev.get("cat") == "kernel"}
    for want in ("window_hash", "panel_probe_kernel"):
        if not any(want in n for n in kernel_names):
            raise AssertionError(f"the profiler trace names no {want} kernel: "
                                 f"{sorted(kernel_names)[:8]}")
    say(f"RKMH_TPU_PROFILE: {path}, {os.path.getsize(path)} bytes, {len(events)} events, "
        f"{len(kernel_names)} kernel names, K1 and K2 among them")
    return {"metrics_line": line, "trace_events": len(events)}


# ---- phases 30-33: the VW trainer's kernel (K12), the model pipeline, per-read
# training at the trainer's full width, the library and the panel cache

K12_PIPELINE_SHAPES = ((10, 1), (10, 5), (10, 11), (110, 1))  # (F, C): vwize's 10, vv's 110
N_READ_TRAIN, N_READ_HELD = 4096, 1024   # phase 32's reads of the 10 sublineages
READ_SKETCH = 1000                       # hash -w -s 1000: F = 1,002 features a read
MP_POOL_READS, MP_MEAN_LEN, MP_MAX_READS = 400, 1500, 120
MP_TRAIN, MP_HELD = (10, 80), (2, 16)    # (singles per sublineage, mixes): 180 and 36 samples
PASSES, LR = 25, 0.05                    # wabbit's defaults; train_the_wabbit.sh's 25 passes


def check_k12(dev) -> tuple[dict, dict]:
    """Phase 30: K12 forward and backward against the plain version at the
    pipeline's shapes, phase 32's per-read shape and the edge cases
    (``bench/margin_inputs``: 1e-5 of the sum of |terms| + 1e-6; two
    backward runs equal, bit for bit), then their times at the per-read
    shape: graph replay and eager, the plain version, ``embedding_bag``
    forward + backward (graph replay and eager), the bound, and the plan's
    build (its library sort, once a training run)."""
    import torch
    import torch.nn.functional as F

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.margin_inputs import check_margins, edge_cases, margin_case
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops.sparse_margin import (_margins_cuda, _margins_grad_cuda, build_plan,
                                                  pack_weights, sparse_margins_plain)

    per_read = f"per-read N={N_READ_TRAIN} F={READ_SKETCH + 2} C=10"
    cases = {f"pipeline N=180 F={f} C={c}": margin_case(180, f, c, 18, f + c, dev)
             for f, c in K12_PIPELINE_SHAPES}
    cases[per_read] = margin_case(N_READ_TRAIN, READ_SKETCH + 2, 10, 18, 30, dev, pad=0.02)
    cases.update(edge_cases(dev))
    errs = {"forward": 0.0, "backward": 0.0}
    for label, case in cases.items():
        ef, eb = check_margins(*case)
        errs = {"forward": max(errs["forward"], ef), "backward": max(errs["backward"], eb)}
        say(f"K12 {label}: forward max |err| {ef:.3g}, backward {eb:.3g} (within 1e-5 of "
            f"the sum of |terms| + 1e-6); two backward runs equal, bit for bit")

    W, idx, val, dm = cases[per_read]
    C, D = W.shape
    Wp, plan = pack_weights(W), build_plan(idx, val, D)
    Wq = W.clone().requires_grad_(True)
    plain_m = sparse_margins_plain(Wq, idx, val)
    WT = W.T.contiguous().requires_grad_(True)  # embedding_bag's layout: [D, C]
    dmT = dm.T.contiguous()
    lib_m = F.embedding_bag(idx, WT, per_sample_weights=val, mode="sum")
    if not torch.allclose(lib_m.T, plain_m, rtol=1e-4, atol=1e-3):
        raise AssertionError("embedding_bag does not compute K12's forward")

    def lib_fwd():
        return F.embedding_bag(idx, WT, per_sample_weights=val, mode="sum")

    def lib_both():  # a fresh leaf: its gradient node is made on the capturing stream
        Wl = WT.detach().requires_grad_(True)
        torch.autograd.grad(F.embedding_bag(idx, Wl, per_sample_weights=val, mode="sum"),
                            Wl, dmT)

    def plain_both():
        Wr = W.detach().requires_grad_(True)
        torch.autograd.grad(sparse_margins_plain(Wr, idx, val), Wr, dm)

    def graph_ms(fn):
        try:
            return cuda_graph_time_ms(fn, 10)
        except RuntimeError as exc:  # a library call that syncs cannot be captured
            say(f"  (not captured in a CUDA graph: {str(exc).splitlines()[0][:120]})")
            return None

    fns = {"forward": (lambda: _margins_cuda(Wp, idx, val, C),
                       lambda: sparse_margins_plain(W, idx, val), lib_fwd),
           "backward": (lambda: _margins_grad_cuda(dm, plan),
                        lambda: torch.autograd.grad(plain_m, Wq, dm, retain_graph=True),
                        lambda: torch.autograd.grad(lib_m, WT, dmT, retain_graph=True)),
           "both": (lambda: (_margins_cuda(Wp, idx, val, C), _margins_grad_cuda(dm, plan)),
                    plain_both, lib_both)}
    one_way = bounds.sparse_margin_bytes(idx, val, C)
    times = {}
    for way, (kern, plain, lib) in fns.items():
        times[way] = {"ms": cuda_graph_time_ms(kern, 10), "eager_ms": cuda_time_ms(kern, 20),
                      "plain_ms": cuda_time_ms(plain, 5, warmup=2),
                      "library_ms": graph_ms(lib),
                      "library_eager_ms": cuda_time_ms(lib, 10, warmup=2),
                      "bound_ms": bounds.bound_ms(one_way * (2 if way == "both" else 1))}
        say(f"time K12 {way} at {per_read} (D = 2**18, Wp [D, 12]): {times[way]['ms']:.4f} ms "
            f"graph, {times[way]['eager_ms']:.4f} eager; plain {times[way]['plain_ms']:.4f}; "
            f"embedding_bag {times[way]['library_ms']} graph, "
            f"{times[way]['library_eager_ms']:.4f} eager; bound {times[way]['bound_ms']:.4f} ms "
            f"({one_way} bytes a way)")
    t0 = time.perf_counter()
    build_plan(idx, val, D)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times["plan_ms"] = cuda_time_ms(lambda: build_plan(idx, val, D), 5, warmup=1)
    times["plan"] = {"entries": plan.entries, "runs": int(plan.keys.numel()),
                     "chunks": int(plan.chunk_run.numel()),
                     "crossing_runs": int(plan.cross_keys.numel()), "slots": plan.slots}
    say(f"K12's plan at {per_read}: {times['plan']}; built in {times['plan_ms']:.4f} ms "
        f"(library sort and glue, once a training run; {first_s * 1e3:.1f} ms host clock)")
    W, idx, val, dm = cases["pipeline N=180 F=10 C=11"]
    Wp, plan = pack_weights(W), build_plan(idx, val, D)
    times["pipeline_both_ms"] = cuda_graph_time_ms(
        lambda: (_margins_cuda(Wp, idx, val, 11), _margins_grad_cuda(dm, plan)), 10)
    say(f"time K12 forward + backward at N=180 F=10 C=11: {times['pipeline_both_ms']:.4f} ms")
    return errs, times


def _wabbit(argv, stdout=None) -> int:
    from rkmh_tpu_torch.ml import wabbit

    return wabbit.main(argv, stdout=stdout)


def _floats_of(path: str):
    import numpy as np

    with open(path) as fh:
        return np.array([float(x) for x in fh.read().split()])


def run_model_pipeline(dev, card: str) -> dict:
    """Phase 31: the model pipeline of run_models.sh on the card
    (``bench/model_pipeline``): stream, vwize, the four models trained and
    applied on the card and on the CPU, conf_mat and interpret_wabbit, and
    the four shipped model_docker models applied on both."""
    import io

    import numpy as np

    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench import model_pipeline as mp
    from rkmh_tpu_torch.ml.wabbit import load_model
    from rkmh_tpu_torch.scripts import conf_mat, interpret_wabbit

    res, gpu = {}, str(dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        panel = synth.write_hpv16_refpath(os.path.join(tmp, "ref"), num_types=16)
        refs = os.path.join(tmp, "ref", "new_refs.fa")
        pools = mp.write_pools(os.path.join(tmp, "pools"), panel, MP_POOL_READS, 31, MP_MEAN_LEN)
        sets = {tag: mp.write_samples(os.path.join(tmp, tag), pools, synth.HPV16_GENOME_LEN,
                                      seed, *shape, MP_MAX_READS, tag)
                for tag, seed, shape in (("train", 32, MP_TRAIN), ("held", 33, MP_HELD))}
        say(f"model pipeline input: {len(sets['train'])} training and {len(sets['held'])} "
            f"held-out samples of nanopore-like reads (mean {MP_MEAN_LEN} bp, 8% substitutions,"
            f" <= {MP_MAX_READS} reads a sample) from {len(pools)} sublineage pools; made in "
            f"{time.perf_counter() - t0:.2f} s")
        cls = {}
        secs, res["model pipeline: stream"] = driven(
            lambda: cls.update({tag: mp.classify_samples(s, refs, dev) for tag, s in sets.items()}),
            "model pipeline: stream -k 18 -s 4000", ["window_hash", "panel_probe"])
        say(f"stream over {sum(map(len, sets.values()))} samples: {secs:.2f} s")
        vw = {tag: mp.write_vw_files(cls[tag], [c for _, c in sets[tag]], tmp, tag)
              for tag in sets}
        models = {}

        def train(device):
            for name, kind, extra in mp.JOBS:
                models[name, device] = os.path.join(tmp, f"{name}.{device}.npz")
                if _wabbit([vw["train"][kind], "-f", models[name, device], "--passes",
                            str(PASSES), *extra, "--device", device]) != 0:
                    raise AssertionError(f"wabbit failed to train {name} on {device}")

        secs, res["model pipeline: train"] = driven(
            lambda: train(gpu), "model pipeline: wabbit train",
            ["sparse_margin", "sparse_margin_grad"])
        say(f"trained the four models on the card ({PASSES} passes each): {secs:.2f} s")
        train("cpu")
        preds = {}

        def apply(device, which):
            for name, kind, _ in mp.JOBS:
                model = models[name, device] if which == "trained" else os.path.join(
                    REPO, "model_docker", f"{name}.npz")
                for flag in ([[]] + [["--binary"]] * (kind == "binary")):
                    out = os.path.join(tmp, f"{name}.{device}.{which}{''.join(flag)}.pred")
                    if _wabbit([vw["held"][kind], "-i", model, "-t", "-p", out, *flag,
                                "--device", device]) != 0:
                        raise AssertionError(f"wabbit failed to apply {name} on {device}")
                    preds[name, device, which, bool(flag)] = out

        def apply_both():
            apply(gpu, "trained")
            apply(gpu, "shipped")

        secs, res["model pipeline: apply"] = driven(apply_both, "model pipeline: wabbit -t -p",
                                                    ["sparse_margin"])
        apply("cpu", "trained")
        apply("cpu", "shipped")
        accuracy = {}
        for name, kind, _ in mp.JOBS:
            w_gpu, w_cpu = (load_model(models[name, d])[1] for d in (gpu, "cpu"))
            w_err = float(np.abs(w_gpu - w_cpu).max())
            if w_err > LR:
                raise AssertionError(f"{name}: card- and CPU-trained weights differ by {w_err} "
                                     f"> lr = {LR}")
            s = np.array([sum(abs(float(f.split(":")[1])) for f in ln.split("|vir")[1].split())
                          for ln in open(vw["held"][kind])])
            sum_val = s + s * s if "vv" in name else s  # vv adds every ordered pair's product
            for which in ("trained", "shipped"):
                w_max = float(np.abs(w_gpu if which == "trained" else load_model(
                    os.path.join(REPO, "model_docker", f"{name}.npz"))[1]).max())
                ids_gpu = read_text(preds[name, gpu, which, False])
                ids_cpu = read_text(preds[name, "cpu", which, False])
                if kind == "binary":
                    m_gpu, m_cpu = (_floats_of(preds[name, d, which, False])
                                    for d in (gpu, "cpu"))
                    # the sum order (1e-5 of the sum of |terms|, bounded by max |w| *
                    # sum |val|); weights trained apart, up to lr each: lr * sum |val| more
                    tol = 1e-5 + (1e-5 * w_max + (LR if which == "trained" else 0)) * sum_val
                    if not np.all(np.abs(m_gpu - m_cpu) <= tol):
                        raise AssertionError(f"{name} ({which}): margins on the card and the "
                                             f"CPU differ past the tolerance")
                    require_same(read_text(preds[name, gpu, which, True]),
                                 read_text(preds[name, "cpu", which, True]),
                                 f"{name} ({which}) --binary labels")
                else:
                    require_same(ids_gpu, ids_cpu, f"{name} ({which}) class ids")
            truth = mp.labels(vw["held"][kind])
            got = read_text(preds[name, gpu, "trained", False]).split()
            accuracy[name] = mp.accuracy(kind, got, truth)
            accuracy[name + " (shipped)"] = mp.accuracy(
                kind, read_text(preds[name, gpu, "shipped", False]).split(), truth)
            out = io.StringIO()
            pred_tags = os.path.join(tmp, f"{name}.tags")
            with open(pred_tags, "w") as fh:
                fh.writelines(f"{p} {os.path.basename(fq)}\n"
                              for p, (fq, _) in zip(got, sets["held"]))
            interpret_wabbit.main(["-i", pred_tags, "-T", {"binary": "BINARY", "lineage": "LIN",
                                                            "sublineage": "SUB"}[kind]], stdout=out)
            if kind == "binary":
                cm = os.path.join(tmp, f"{name}.cm")
                with open(cm, "w") as fh:
                    fh.writelines(f"{-float(p)} {'coinf' if t > 0 else 'hpv'}\n"
                                  for p, t in zip(got, truth))
                conf_mat.main([cm], stdout=out)
            lines = out.getvalue().splitlines()
            say(f"{name}: weights card vs CPU max |diff| {w_err:.3g} (tolerance lr = {LR}); "
                f"held-out accuracy {accuracy[name]:.3f} (the shipped model: "
                f"{accuracy[name + ' (shipped)']:.3f}); interpret_wabbit: {lines[0]!r}"
                + (f"; conf_mat: {len(lines) - len(got) - 1} rows" if kind == "binary" else ""))
    say("model pipeline: class ids and --binary labels equal on the card and the CPU, "
        "trained and shipped models")
    res["accuracy"] = accuracy
    return res


def run_per_read_training(dev, card: str) -> dict:
    """Phase 32: ``hash -w -k 18 -s 1000`` over N_READ_TRAIN + N_READ_HELD
    nanopore-like reads of the 10 sublineages, labelled 1-10 in place of
    XYX, then ``--ect 10 --passes 25 -b 18`` trained on the card and
    applied to the held-out reads, each part timed."""
    import io

    import numpy as np
    import torch

    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench.timing import cuda_time_ms
    from rkmh_tpu_torch.commands.hash_cmd import HashConfig, run as hash_run
    from rkmh_tpu_torch.convert import wabbit_from_numpy
    from rkmh_tpu_torch.ml import wabbit
    from rkmh_tpu_torch.ops.sparse_margin import _margins_cuda, _margins_grad_cuda, build_plan

    panel = synth.make_hpv16_panel(num_types=16)
    rng = np.random.default_rng(32)
    res = {}
    data = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, n in (("train", N_READ_TRAIN), ("held", N_READ_HELD)):
            labels = rng.integers(1, len(panel.subs) + 1, n)
            reads = [None] * n
            for c in range(1, len(panel.subs) + 1):
                at = np.flatnonzero(labels == c)
                for i, r in zip(at, synth.make_strain_reads(panel.subs[c - 1], at.size,
                                                            int(rng.integers(1 << 30)))):
                    reads[i] = r
            fq = os.path.join(tmp, f"{tag}.fq")
            synth.write_fastq_records(fq, reads)
            out = io.StringIO()
            secs, res[f"per-read: hash -w ({tag})"] = driven(
                lambda: hash_run(HashConfig(read_files=[fq], ks=(18,), sketch_size=READ_SKETCH,
                                            wabbitize=True, device=str(dev)), out=out),
                f"per-read: hash -w ({tag})", ["window_hash"])
            lines = out.getvalue().splitlines()
            if len(lines) != n or not all(ln.startswith("XYX 1.0 `") for ln in lines):
                raise AssertionError(f"hash -w wrote {len(lines)} lines for {n} reads")
            t0 = time.perf_counter()
            examples = [wabbit.parse_example(f"{lab}{ln[3:]}") for lab, ln in zip(labels, lines)]
            idx, val, y = wabbit.vectorize(examples, 18, [], set())
            data[tag] = (idx, val, y, time.perf_counter() - t0, secs)
            say(f"per-read {tag}: {n} reads ({sum(map(len, reads)) / 1e6:.2f} Mbp), hash -w "
                f"{secs:.2f} s, vectorize on the host {data[tag][3]:.2f} s, idx {idx.shape}")
    idx, val, y, vec_s, _ = data["train"]
    W = {}
    train_s, res["per-read: train"] = driven(
        lambda: W.update(w=wabbit.train_multiclass(idx, val, y, 10, 18, PASSES, LR, device=dev)),
        "per-read: wabbit --ect 10 train", ["sparse_margin", "sparse_margin_grad"])
    if res["per-read: train"]["sparse_margin_grad"] != PASSES:
        raise AssertionError("one backward launch a pass expected")
    again_s, res["per-read: train again"] = driven(
        lambda: W.update(again=wabbit.train_multiclass(idx, val, y, 10, 18, PASSES, LR,
                                                       device=dev)),
        "per-read: wabbit --ect 10 train, a second run", ["sparse_margin", "sparse_margin_grad"])
    if W["w"].tobytes() != W["again"].tobytes():
        raise AssertionError("two trainings on the card gave weights that differ")
    say(f"per-read: two trainings on the card ({train_s:.3f} s, {again_s:.3f} s) gave weights "
        f"equal bit for bit")
    # one pass's device time, as _train takes it: forward, backward, Adam and the loss
    model = wabbit_from_numpy("ect", np.zeros((10, 1 << 18), np.float32), 18, [], set(), dev)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    idx_t, val_t = torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)
    Y = -torch.ones((10, len(y)), device=dev)
    Y[torch.from_numpy(y.astype(np.int64) - 1).to(dev), torch.arange(len(y), device=dev)] = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = build_plan(idx_t, val_t, 1 << 18)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss(idx_t, val_t, Y, plan).backward()
        opt.step()

    pass_ms = cuda_time_ms(step, PASSES, warmup=2)
    Wp = model.Wp.detach()
    m = _margins_cuda(Wp, idx_t, val_t, 10).requires_grad_(True)
    (dm,) = torch.autograd.grad(torch.logaddexp(torch.zeros((), device=dev), -Y * m).mean(), m)
    split = {"forward_ms": cuda_time_ms(lambda: _margins_cuda(Wp, idx_t, val_t, 10), PASSES),
             "backward_ms": cuda_time_ms(lambda: _margins_grad_cuda(dm, plan), PASSES),
             "adam_ms": cuda_time_ms(opt.step, PASSES)}
    split["loss_and_glue_ms"] = pass_ms - sum(split.values())
    h_idx, h_val, h_y, h_vec_s, _ = data["held"]
    scores = {}
    apply_s, res["per-read: apply"] = driven(
        lambda: scores.update(m=wabbit.margins(
            wabbit_from_numpy("ect", W["w"], 18, [], set(), dev), h_idx, h_val)),
        "per-read: wabbit -t apply", ["sparse_margin"])
    acc = float(np.mean(scores["m"].argmax(axis=0) + 1 == h_y))
    stats = {"vectorize_s": vec_s, "held_vectorize_s": h_vec_s, "train_s": train_s,
             "train_again_s": again_s, "plan_s": plan_s, "pass_ms": pass_ms, "pass": split,
             "apply_s": apply_s, "accuracy": acc,
             "hash_s": data["train"][4] + data["held"][4],
             "launches": {k: sum(res[f"per-read: {p}"][k] for p in ("train", "train again",
                                                                     "apply"))
                          for k in ("sparse_margin", "sparse_margin_grad")}}
    say(f"per-read training at the trainer's width ({card}): {N_READ_TRAIN} reads x "
        f"{idx.shape[1]} features, C = 10, D = 2**18: vectorize {vec_s:.2f} s on the host, "
        f"train {train_s:.3f} s ({PASSES} passes; the plan {plan_s * 1e3:.1f} ms once; "
        f"{pass_ms:.4f} device ms a pass: {json.dumps(split)}), apply {apply_s:.3f} s to "
        f"{N_READ_HELD} held-out reads (vectorize "
        f"{h_vec_s:.2f} s); K12 launches {stats['launches']}; held-out accuracy {acc:.3f}")
    res["stats"] = stats
    return res


def check_library(panel, hashes) -> None:
    """Phase 33a: the library's batch forms on the card against the CPU on
    the zika panel's sketches and a 16,384-read batch's (hashes on both sides
    of 2**63): every output equal."""
    import torch

    from rkmh_tpu_torch.classify import library
    from rkmh_tpu_torch.ops.sketch import SENTINEL, bottom_s_sketch

    ref_rows = torch.where(panel.sketches == SENTINEL, 0, panel.sketches)
    read_sorted, read_lens = bottom_s_sketch(hashes, 1000)  # the slice batch's K1 output
    read_rows = torch.where(read_sorted == SENTINEL, 0, read_sorted)
    if not ((read_rows < 0).any() and (read_rows > 0).any()):
        raise AssertionError("the read hashes should lie on both sides of 2**63")
    names = [str(k) for k in panel.keys]
    calls = {"merge_sketches_batch": lambda r, *_: library.merge_sketches_batch(r, 1000),
             "merge_sketches_with_counts_batch":
                 lambda r, *_: library.merge_sketches_with_counts_batch(r, 1000),
             "informative_mask_batch": lambda r, *_: library.informative_mask_batch(r, 3),
             "all_hash_compare_batch": lambda r, s, ln, fs, fl: library.all_hash_compare_batch(
                 s, ln, fs, fl)}
    devices = (str(panel.sketches.device), "cpu")
    sides = {d: (ref_rows.to(d), read_sorted.to(d), read_lens.to(d), panel.sketches.to(d),
                 panel.lens.to(d)) for d in devices}
    for name, fn in calls.items():
        for label, pick in (("panel", 0), ("reads", 1)):
            outs = []
            for d in devices:
                ref_r, rs, rl, fs, fl = sides[d]
                rows = ref_r if pick == 0 else torch.where(rs == SENTINEL, 0, rs)
                got = fn(rows, rs, rl, fs, fl)
                outs.append([t.cpu() for t in (got if isinstance(got, tuple) else (got,))])
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"library.{name} ({label}) differs on the card and the CPU")
            if name == "all_hash_compare_batch":
                break  # reads against the panel: one case
    got = [library.classify_batch(*sides[d][1:], names) for d in devices]
    require_same("\n".join(got[0]), "\n".join(got[1]), "library.classify_batch")
    say(f"library batch forms on the card equal the CPU's: merge, merge with counts, the "
        f"informative mask (60 x 1000 panel sketches and {read_rows.shape[0]} x "
        f"{read_rows.shape[1]} read sketches), all_hash_compare_batch and classify_batch "
        f"({sum(1 for n in got[0] if n)} reads named)")


def run_panel_cache(dev, card: str, zika: dict) -> dict:
    """Phase 33b: stream twice with RKMH_TPU_PANEL_CACHE at a temporary
    directory: a miss, then a hit that hashes no reference (K1 0 launches
    in the panel's set-up) with byte-identical output."""
    from rkmh_tpu_torch.commands.common import build_ref_panel_from_files
    from rkmh_tpu_torch.commands.stream import StreamConfig, run

    res = {}
    with tempfile.TemporaryDirectory() as cache:
        os.environ["RKMH_TPU_PANEL_CACHE"] = cache
        try:
            def set_up():
                build_ref_panel_from_files([zika["refs"]], (12,), 1000, dev)

            setup = {}
            for label in ("miss", "hit"):
                secs, launches = driven(set_up, f"panel cache set-up ({label})",
                                        ["window_hash"] if label == "miss" else [])
                setup[label] = (secs, launches["window_hash"])
            if setup["hit"][1] != 0 or not os.listdir(cache):
                raise AssertionError("the second set-up hashed the references")
            for p in os.listdir(cache):
                os.unlink(os.path.join(cache, p))
            outs = []
            for label in ("miss", "hit"):
                path = os.path.join(zika["dir"], f"cache_{label}.tsv")
                secs, res[f"stream, panel cache {label}"] = driven(
                    lambda: run(StreamConfig(ref_files=[zika["refs"]],
                                             read_files=[zika["head"]], ks=(12,),
                                             sketch_size=1000, device=str(dev), out_file=path)),
                    f"stream, panel cache {label}", ["window_hash", "panel_probe"])
                outs.append(read_text(path))
            require_same(outs[1], outs[0], "stream on a panel-cache hit")
        finally:
            os.environ["RKMH_TPU_PANEL_CACHE"] = "0"
    n_hit, n_miss = (res[f"stream, panel cache {k}"]["window_hash"] for k in ("hit", "miss"))
    say(f"panel cache ({card}): set-up {setup['miss'][0]:.3f} s on a miss (K1 "
        f"{setup['miss'][1]} launches), {setup['hit'][0]:.3f} s on a hit (K1 "
        f"{setup['hit'][1]}); stream over {N_CPU_LINES} reads: K1 {n_miss} launches on the "
        f"miss, {n_hit} on the hit, the same bytes")
    res["setup_s"] = {k: v[0] for k, v in setup.items()}
    return res


# ---- phases 34-35: --devices / --tp (``parallel/``): K2's partial epilogue and K6 / K7
# over slot ranges, then the sharded paths on a grid of (cuda:0,) * 4

GRID = 4              # the grid's entries, all cuda:0 on a one-card machine
RANGE_PARTS = 4       # K6 / K7 over each of 4 ranges of a 2e8-slot table
PARTIAL_TPS = (2, 4)  # the zika panel's 60 references in 2 and 4 shards
N_WIDE_PARTIAL = 20000  # K11's route a shard: 10,000 references each at tp = 2


def check_partials(dev, panel, hashes) -> tuple[int, dict]:
    """Phase 34a: K2's partial epilogue (``rkmh_panel_probe_partial``)
    exactly against ``panel_probe_partial_plain`` on every shard of the zika
    panel at tp = 2 and 4 (raw rows and sorted s = 50 rows, init -1 and 0)
    and of ``bench/wide_inputs.straddling_panel`` at R = 20,000, tp = 2 (K11's
    route: 10,000 references a shard); the merged shards
    (``parallel/mesh.merge_tp_partials``) must equal the unsharded K2 or K11
    output word for word, stream and filter, with and without -D/-N.  K2's
    S = 2 route in the stream, filter and partial epilogues against their
    plain versions, on shard 0 of 2 (Wm = 1) and on the zika panel built at
    S = 2 (Wm = 2).  Then times, in turns, the partial epilogue on one zika
    shard (tp = 2, raw rows), the whole table's K2 and K2 on the S = 2
    panel."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.bench.wide_inputs import straddling_panel
    from rkmh_tpu_torch.ops import lookup
    from rkmh_tpu_torch.ops.lookup import build_panel_table
    from rkmh_tpu_torch.ops.probe import (
        _panel_probe_cuda,
        _panel_probe_filter_cuda,
        _panel_probe_partial_cuda,
        device_table,
        panel_probe_filter_plain,
        panel_probe_partial_plain,
        panel_probe_plain,
    )
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch
    from rkmh_tpu_torch.parallel.mesh import build_sharded_tables, merge_tp_partials

    worst = 0

    def check(label, sk_np, lens_np, full, ref_lens, rows_modes, tp):
        nonlocal worst
        R = sk_np.shape[0]
        tables, rps = build_sharded_tables(sk_np, lens_np, tp)
        logical = [torch.from_numpy(np.ascontiguousarray(t).view(np.int32)).to(dev)
                   for t in tables]
        shards = [device_table(t.cpu(), rps, dev) for t in logical]
        for mode, rows, ln in rows_modes:
            for init in (-1, 0):
                got = [_panel_probe_partial_cuda(rows, ln, s, rps, init) for s in shards]
                want = [panel_probe_partial_plain(rows, ln, t, rps, init) for t in logical]
                err = max(max_abs_err(g, w) for g, w in zip(got, want))
                if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"partial epilogue disagrees with the plain version: "
                                         f"{label}, tp {tp}, {mode} rows, init {init}")
                worst = max(worst, err)
                for md, mm in ((0, -1), (1, 9)):
                    if init == -1:
                        merged = merge_tp_partials(torch.stack(got), rps, md, mm)
                        whole = _panel_probe_cuda(rows, ln, full, R, md, mm)
                    else:
                        merged = merge_tp_partials(torch.stack(got), rps, md, mm, ref_lens)
                        whole = _panel_probe_filter_cuda(rows, ln, full, R, ref_lens, md, mm)
                    if not torch.equal(merged, whole):
                        raise AssertionError(f"merged partials differ from the unsharded "
                                             f"kernel: {label}, tp {tp}, {mode} rows, init "
                                             f"{init}, -D {md} -N {mm}")
        route = "K11" if rps > 8192 else "K2 registers" if rps <= 256 else "K2 shared memory"
        say(f"partial epilogue, {label}, tp = {tp} ({rps} references a shard, {route}): every "
            f"shard exact against its plain version, raw and sorted rows, init -1 and 0; the "
            f"merged shards equal the unsharded stream and filter outputs word for word")
        return logical, shards, rps

    sk_np, lens_np = panel.sketches.cpu().numpy(), panel.lens.cpu().numpy()
    sk50, lens50 = bottom_s_sketch(hashes, 50)
    zika_rows = (("raw", hashes, None), ("sorted s=50", sk50, lens50))
    timed = None
    for tp in PARTIAL_TPS:
        got = check("zika", sk_np, lens_np, panel.table, panel.lens, zika_rows, tp)
        if timed is None:
            timed = got
    ref_sk, ref_lens, reads, set_lens = straddling_panel(N_WIDE_PARTIAL, seed=34, n_reads=512,
                                                         width=149)
    full = device_table(torch.from_numpy(build_panel_table(ref_sk, ref_lens).table
                                         .view(np.int32)), N_WIDE_PARTIAL, dev)
    raw = torch.from_numpy(reads).to(dev)
    sk, ln = bottom_s_sketch(raw, 32)
    check("straddling panel", ref_sk, ref_lens, full, torch.from_numpy(set_lens).to(dev),
          (("raw", raw, None), ("sorted s=32", sk, ln)), 2)

    # K2's S = 2 route in all three epilogues: shard 0 of 2 as a 30-reference panel
    # (Wm = 1: the whole 32-byte row in one trip) and the zika panel built at S = 2
    # (Wm = 2: lo and occ pairs, then hi and the mask words as pairs)
    logical, shards, rps = timed
    s2 = torch.from_numpy(build_panel_table(sk_np, lens_np, slots=2).table.view(np.int32)).to(dev)
    for label, table, R, ref_lens in (("zika shard 0 of 2", logical[0], rps, panel.lens[:rps]),
                                      ("zika panel at S = 2", s2, panel.num_refs, panel.lens)):
        if lookup.table_slots(table.shape[1], R) != 2:
            raise AssertionError(f"{label}: not an S = 2 table")
        for mode, rows, ln in zika_rows:
            for md, mm in ((0, -1), (1, 9)):
                got = (_panel_probe_cuda(rows, ln, table, R, md, mm),
                       _panel_probe_filter_cuda(rows, ln, table, R, ref_lens, md, mm))
                want = (panel_probe_plain(rows, ln, table, R, md, mm),
                        panel_probe_filter_plain(rows, ln, table, R, ref_lens, md, mm))
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"K2's S = 2 route disagrees with the plain versions: "
                                         f"{label}, {mode} rows, -D {md} -N {mm}")
            for init in (-1, 0):
                if not torch.equal(_panel_probe_partial_cuda(rows, ln, table, R, init),
                                   panel_probe_partial_plain(rows, ln, table, R, init)):
                    raise AssertionError(f"K2's S = 2 partial disagrees with its plain version: "
                                         f"{label}, {mode} rows, init {init}")
    say(f"K2's S = 2 route (Wm = 1 and 2): stream, filter and partial epilogues exact against "
        f"their plain versions on raw and sorted rows")

    run = lambda: _panel_probe_partial_cuda(hashes, None, shards[0], rps, -1)  # noqa: E731
    whole = lambda: _panel_probe_cuda(hashes, None, panel.table, panel.num_refs, 0, -1)  # noqa: E731
    s2_run = lambda: _panel_probe_cuda(hashes, None, s2, panel.num_refs, 0, -1)  # noqa: E731
    runs = {"partial": [], "whole": [], "s2": []}
    for name in ("partial", "whole", "s2", "s2", "whole", "partial"):  # in turns
        runs[name].append(cuda_graph_time_ms({"partial": run, "whole": whole, "s2": s2_run}[name],
                                             20))
    st = bounds.panel_probe_stats(hashes, None, logical[0], rps)
    st_s2 = bounds.panel_probe_stats(hashes, None, s2, panel.num_refs)
    t = {"ms": float(np.mean(runs["partial"])), "runs_ms": runs["partial"],
         "eager_ms": cuda_time_ms(run, 50),
         "plain_ms": cuda_time_ms(lambda: panel_probe_partial_plain(
             hashes, None, logical[0], rps, -1), 5),
         "bound_ms": bounds.bound_ms(bounds.tensor_bytes(hashes) + st.table_bytes
                                     + bounds.PARTIAL_OUT * hashes.shape[0]),
         "shape": list(hashes.shape), "shard_refs": rps,
         "whole_ms": float(np.mean(runs["whole"])), "whole_runs_ms": runs["whole"],
         "s2_stream": {"ms": float(np.mean(runs["s2"])), "runs_ms": runs["s2"],
                       "table": list(s2.shape),
                       "bound_ms": bounds.bound_ms(bounds.tensor_bytes(hashes)
                                                   + st_s2.table_bytes + 12 * hashes.shape[0])}}
    say(f"time panel_probe_partial (zika shard 0 of 2, raw rows {tuple(hashes.shape)}): "
        f"{t['ms']:.4f} ms ({t['eager_ms']:.4f} eager) vs {t['plain_ms']:.4f} ms plain; bound "
        f"{t['bound_ms']:.4f} ms (rows, {st.table_bytes} B of the shard table's sectors, "
        f"{bounds.PARTIAL_OUT} B a read out); in turns beside the whole table's K2 "
        f"{t['whole_ms']:.4f} ms and K2 on the zika panel at S = 2 {t['s2_stream']['ms']:.4f} ms "
        f"(bound {t['s2_stream']['bound_ms']:.4f}); runs {json.dumps(runs)}")
    return worst, t


def check_counter_ranges(dev, hashes) -> tuple[dict, dict]:
    """Phase 34b: K6 and K7 over each of RANGE_PARTS slot ranges of a
    2e8-slot table, exactly against their plain versions (the stream
    batch's hashes with the counter pass's window mask derived in the
    kernel, binned and direct; random hashes, zeros and >= 2**63 among
    them, with a mask tensor); the ranges put together equal the
    single-table K6's table bit for bit, and K7 run over the ranges in turn
    equals the single-table K7.  Then times K6 and K7 on the second range
    at the stream shape.  -> ({name: max_abs_err}, {name: times})."""
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops import counter
    from rkmh_tpu_torch.ops.hashing import window_mask

    size = COUNTER_SIZES[0]
    n = size // RANGE_PARTS
    lens150 = torch.full((hashes.shape[0],), 150, dtype=torch.int32, device=dev)
    windows = (lens150, 160, [12])
    mask = window_mask(lens150, 160, [12])
    rh, rm = (t.to(dev) for t in random_hashes(34, (4096, 149)))
    whole = torch.zeros(size, dtype=torch.int32, device=dev)
    counter._counter_add_cuda(whole, hashes, None, windows)
    counter._counter_add_cuda(whole, rh, rm)
    worst = {"counter_add": 0, "counter_mask": 0}
    parts = []
    for o in range(RANGE_PARTS):
        at = {"base": o * n, "size": size}
        want = torch.zeros(n, dtype=torch.int32, device=dev)
        counter.counter_add_plain(want, hashes, mask, **at)
        counter.counter_add_plain(want, rh, rm, **at)
        for binned in (True, False):
            got = torch.zeros(n, dtype=torch.int32, device=dev)
            counter._counter_add_cuda(got, hashes, None, windows, binned=binned, **at)
            counter._counter_add_cuda(got, rh, rm, binned=binned, **at)
            err = max_abs_err(got, want)
            if err or not torch.equal(got, want):
                raise AssertionError(f"K6 over slots [{o * n}, {(o + 1) * n}) (binned={binned}) "
                                     "disagrees with the plain version")
            worst["counter_add"] = max(worst["counter_add"], err)
        parts.append(got)
    if not torch.equal(torch.cat(parts), whole):
        raise AssertionError("K6's ranges put together differ from the single-table K6")
    for h in (hashes, rh):
        out = h
        for o in range(RANGE_PARTS):
            at = {"base": o * n, "size": size}
            g = counter._counter_mask_cuda(parts[o], out, MIN_OCC, counter.INT32_MAX, **at)
            w = counter.counter_mask_plain(parts[o], out, MIN_OCC, counter.INT32_MAX, **at)
            err = max_abs_err(g, w)
            if err or not torch.equal(g, w):
                raise AssertionError(f"K7 over slots [{o * n}, {(o + 1) * n}) disagrees with "
                                     "the plain version")
            worst["counter_mask"] = max(worst["counter_mask"], err)
            out = g
        if not torch.equal(out, counter._counter_mask_cuda(whole, h, MIN_OCC, counter.INT32_MAX)):
            raise AssertionError("K7 over the ranges in turn differs from the single-table K7")
    say(f"K6/K7 over {RANGE_PARTS} ranges of {n} slots of a {size}-slot table: each exact "
        f"against its plain version (binned and direct, the window mask and a mask tensor); "
        f"the ranges equal the single-table K6 table and K7 bit for bit")

    # timed on the second range (base > 0), as a dp shard of the -M counter runs them
    at = {"base": n, "size": size}
    table = parts[1]
    in_range = counter.slots(hashes[mask], size)
    in_range = in_range[(in_range >= n) & (in_range < 2 * n)]
    add_sectors = bounds.sector_bytes(torch.unique(in_range) * 4)
    nz = counter.slots(hashes[hashes != 0], size)
    get_sectors = bounds.sector_bytes(torch.unique(nz[(nz >= n) & (nz < 2 * n)]) * 4)
    plain_table = table.clone()
    add = lambda: counter._counter_add_cuda(table, hashes, None, windows, **at)  # noqa: E731
    get = lambda: counter._counter_mask_cuda(table, hashes, MIN_OCC,  # noqa: E731
                                             counter.INT32_MAX, **at)
    t = {"counter_add": {
            "ms": cuda_graph_time_ms(add, 20), "eager_ms": cuda_time_ms(add, 20),
            "plain_ms": cuda_time_ms(lambda: counter.counter_add_plain(plain_table, hashes,
                                                                       mask, **at), 5),
            "bound_ms": bounds.bound_ms(bounds.tensor_bytes(hashes, lens150) + 2 * add_sectors)},
         "counter_mask": {
            "ms": cuda_graph_time_ms(get, 20), "eager_ms": cuda_time_ms(get, 20),
            "plain_ms": cuda_time_ms(lambda: counter.counter_mask_plain(
                table, hashes, MIN_OCC, counter.INT32_MAX, **at), 5),
            "bound_ms": bounds.bound_ms(2 * bounds.tensor_bytes(hashes) + get_sectors)}}
    for name, v in t.items():
        v.update(slots=n, base=n)
        say(f"time {name} over slots [{n}, {2 * n}): {v['ms']:.4f} ms ({v['eager_ms']:.4f} "
            f"eager) vs {v['plain_ms']:.4f} ms plain, hashes {tuple(hashes.shape)}; bound "
            f"{v['bound_ms']:.4f} ms")
    return worst, t


def sharded_report(label: str, card: str, reads: int, seconds: float, single_s: float,
                   launches: dict) -> dict:
    say(f"{label} on {card}, {GRID} shards sharing one card: e2e {reads / seconds:.1f} reads/s "
        f"({seconds:.3f} s for {reads} reads); one device {reads / single_s:.1f} reads/s")
    return {"e2e_s": seconds, "e2e_reads_per_s": reads / seconds,
            "one_device_reads_per_s": reads / single_s, "launches": launches}


def run_sharded_paths(dev, card: str, zika: dict, single: dict, hash_res: dict) -> dict:
    """Phase 35: the --devices paths on a grid of (cuda:0,) * 4, each
    driven with the counters zeroed just before and read just after and
    held byte for byte against the same command on one device on the card:
    stream at (dp, tp) = (4, 1) and (2, 2), stream -M 2 -I 40 and filter -M
    2 -I 40 -N 10 at (2, 2) (K6 and K7 over slot ranges), stream -i at (2,
    2) over the first 16,384 reads, hash, count and search with --devices
    4 (over the 2**18 reads of phase 17 for hash and search); then
    ``rkmh-tpu-torch stream --devices 2`` through the CLI: on one card its
    stderr holds the fallback line and its stdout is unchanged.  ``single``:
    the one-device results of phases 6, 13 and 14."""
    import subprocess

    import numpy as np
    import torch

    from rkmh_tpu_torch.commands import count_cmd, filter_cmd, hash_cmd, search_cmd, stream
    from rkmh_tpu_torch.ops import kernels

    grid = (torch.device("cuda", 0),) * GRID
    tmp = zika["dir"]
    res = {}
    base = dict(ref_files=[zika["refs"]], ks=(12,), sketch_size=1000)
    one = {"stream": os.path.join(tmp, "gpu.tsv"),
           "stream -M -I": os.path.join(tmp, "stream_mi.tsv"),
           "filter": os.path.join(tmp, "filter.fq")}
    probe = ("window_hash", "panel_probe_partial")
    counted = probe + ("counter_add", "counter_mask")
    for label, run, want, single_s, needed in (
            *[(f"stream --devices 4 --tp {tp}", lambda out, tp=tp: stream.run(
                stream.StreamConfig(read_files=[zika["reads"]], out_file=out, device="cuda",
                                    devices=GRID, tp=tp, mesh_devices=grid, **base)),
               one["stream"], single["stream"]["e2e_s"], probe) for tp in (1, 2)],
            ("stream -M 2 -I 40 --devices 4 --tp 2", lambda out: stream.run(stream.StreamConfig(
                read_files=[zika["reads"]], out_file=out, device="cuda", devices=GRID, tp=2,
                mesh_devices=grid, min_kmer_occ=MIN_OCC, max_samples=MAX_SAMPLES, **base)),
             one["stream -M -I"], single["stream -M -I"]["e2e_s"], counted),
            ("filter -M 2 -I 40 -N 10 --devices 4 --tp 2", lambda out: filter_cmd.run(
                filter_cmd.FilterConfig(read_files=[zika["reads"]], out_file=out, device="cuda",
                                        devices=GRID, tp=2, mesh_devices=grid,
                                        min_kmer_occ=MIN_OCC, max_samples=MAX_SAMPLES,
                                        min_matches=FILTER_MIN_MATCHES, **base)),
             one["filter"], single["filter"]["e2e_s"], counted)):
        out = os.path.join(tmp, "sharded.out")
        seconds, launches = driven(lambda: run(out), label, needed)
        same_file(out, want, label)
        if "-M" in label:
            ranges = {k: kernels.KERNELS[k].by_route.get("range", 0)
                      for k in ("counter_add", "counter_mask")}
            if not all(ranges.values()):
                raise AssertionError(f"{label}: K6/K7 launches over a slot range {ranges}")
            launches = {**launches, "by_range": ranges}
        res[label] = sharded_report(label, card, N_SLICE_READS, seconds, single_s, launches)
        os.remove(out)

    out = os.path.join(tmp, "sharded_i.tsv")
    with open(zika["head"], "rb") as stdin:
        seconds, launches = driven(lambda: stream.run(stream.StreamConfig(
            in_stream=True, out_file=out, device="cuda", devices=GRID, tp=2, mesh_devices=grid,
            **base), stdin=stdin), "stream -i --devices 4 --tp 2", probe)
    require_same(read_text(out), head_lines(one["stream"], N_CPU_LINES), "stream -i --devices")
    res["stream -i --devices 4 --tp 2"] = {**report(
        "stream -i --devices 4 --tp 2", card, N_CPU_LINES, seconds,
        f", the Python parser; {GRID} shards sharing one card"), "launches": launches}

    reads = hash_res["reads"]
    refs = write_search_refs(tmp)
    for label, run, needed, n_reads in (
            ("hash --devices 4", lambda out, **kw: hash_cmd.run(hash_cmd.HashConfig(
                read_files=[reads], ks=(12,), out_file=out, device="cuda", **kw)),
             ("window_hash",), N_HASH_READS),
            ("count --devices 4", lambda out, **kw: count_cmd.run(count_cmd.CountConfig(
                read_files=[zika["reads"]], ks=(12,), counter_size=COUNT_SLOTS, out_file=out,
                device="cuda", **kw)), ("window_hash", "counter_add"), N_SLICE_READS),
            ("search --devices 4", lambda out, **kw: search_cmd.run(search_cmd.SearchConfig(
                ref_files=[refs], read_files=[reads], ks=(12,), out_file=out, device="cuda",
                **kw)), ("window_hash",), N_HASH_READS)):
        ext = ".npz" if label.startswith("count") else ".txt"
        want, out = os.path.join(tmp, "one" + ext), os.path.join(tmp, "grid" + ext)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(want)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        seconds, launches = driven(lambda: run(out, devices=GRID, mesh_devices=grid), label,
                                   needed)
        if ext == ".npz":
            with np.load(want) as a, np.load(out) as b:
                if not all(np.array_equal(a[k], b[k]) for k in a.files):
                    raise AssertionError(f"{label}: the table differs from one device's")
        else:
            same_file(out, want, label)
        res[label] = sharded_report(label, card, n_reads, seconds, single_s, launches)
        os.remove(want)
        os.remove(out)

    head = head_file(zika["reads"], os.path.join(tmp, "cli_head.fq"), N_CPU_LINES)
    proc = subprocess.run([sys.executable, "-m", "rkmh_tpu_torch.cli", "stream", "-r",
                           zika["refs"], "-f", head, "-k", "12", "--devices", "2"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    n_visible = torch.cuda.device_count()
    fallback = (f"stream --devices ignored (--devices 2 > {n_visible} visible device(s)); "
                "running single-device")
    if n_visible == 1:
        if proc.returncode or fallback not in proc.stderr.splitlines():
            raise AssertionError(f"stream --devices 2 on one card: rc {proc.returncode}, "
                                 f"stderr {proc.stderr[-500:]!r}")
    elif proc.returncode:
        raise AssertionError(f"stream --devices 2: rc {proc.returncode}")
    require_same(proc.stdout, head_lines(one["stream"], N_CPU_LINES), "stream --devices 2 (CLI)")
    say(f"CLI stream --devices 2 on {n_visible} card(s): stdout byte-identical to one device"
        + (f"; stderr: {fallback}" if n_visible == 1 else ""))
    return res


N_SHARDED_HEAD = 3200    # phase 37: the reads of the (4, 1), (1, 4), -M and capped grids
N_CLI_HPV16 = 256        # phase 37: the CLI's --devices 2 run on one card
SP_LEN = 1 << 22         # phase 37: sp_sketch over 4 chunks of two genomes of 4.2 Mbp
SP_SKETCH = 1000


def check_set_probe_partial(dev, tb, cfg: dict, packed) -> tuple[int, dict]:
    """Phase 36a: K3's partial epilogue (``rkmh_set_probe_partial``) on
    every shard of the 182-type panel at tp = 2 and 4 (the shard tables as
    ``hpv16_cmd.build_tables(tp_shards=tp)`` builds them) on the first
    HPV16_BATCH reads, whose rows take 1, 2 and 3 or more 2,048-element
    segments: each shard exactly against ``set_probe_partial_plain`` on its
    logical table, the merged shards (``merge_hpv16_partials``) against the
    whole table's K3, and the window (0, T + U) against the whole table's K3
    bit for bit.  Then times the partial epilogue on shard 0 of 2 (graph
    and eager) beside its plain version and its bound.  -> (max_abs_err,
    times)."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import hpv16_cmd
    from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
    from rkmh_tpu_torch.ops.set_probe import (
        SEGMENT,
        _set_probe_cuda,
        _set_probe_partial_cuda,
        merge_hpv16_partials,
        pack_set_table,
        set_probe_partial_plain,
    )
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    T, U = len(tb.type_names), tb.n_lin + tb.n_sub
    lens = packed.lens[:HPV16_BATCH]
    codes = packed.codes[:HPV16_BATCH, : -(-int(lens.max()) // 128) * 128]
    x = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    full, sk_lens = bottom_s_sketch(multi_k_window_hashes(x, [HPV16_K]),
                                    x.shape[1] - HPV16_K + 1)
    Wc = engine.hpv16_compact_width(lens, x.shape[1], (HPV16_K,))
    rows = full[:, :Wc]
    segs = (-(-sk_lens.clamp(max=Wc) // SEGMENT)).clamp(min=1)
    by_segs = {n: int((segs == n).sum()) for n in (1, 2)}
    by_segs["3+"] = int((segs >= 3).sum())
    if not all(by_segs.values()):
        raise AssertionError(f"the batch lacks reads of 1, 2 or 3+ segments: {by_segs}")
    whole = _set_probe_cuda(rows, sk_lens, tb.probe_table, T, U)
    if not torch.equal(_set_probe_partial_cuda(rows, sk_lens, tb.probe_table, 0, T + U, T, U),
                       whole):
        raise AssertionError("K3's partial route over (0, T + U) differs from rkmh_set_probe")
    worst, timed = 0, None
    for tp in PARTIAL_TPS:
        stb = hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(**cfg, tst_file=False),
                                     (HPV16_K,), dev, tp_shards=tp)
        rps, parts = stb.rps, []
        for j in range(tp):
            logical = stb.shard_tables[j]
            shard = pack_set_table(logical, rps)
            got = _set_probe_partial_cuda(rows, sk_lens, shard, j * rps, rps, T, U)
            want = set_probe_partial_plain(rows, sk_lens, logical, j * rps, rps, T, U)
            err = max_abs_err(got, want)
            if err or not torch.equal(got, want):
                raise AssertionError(f"K3's partial epilogue disagrees with the plain version: "
                                     f"tp {tp}, shard {j}")
            worst = max(worst, err)
            parts.append(got)
            if timed is None:
                timed = (logical, shard, rps)
        if not torch.equal(merge_hpv16_partials(torch.stack(parts)), whole):
            raise AssertionError(f"merged K3 partials differ from the whole table's K3 at tp {tp}")
        say(f"K3 partial epilogue, 182-type panel, tp = {tp} ({rps} columns a shard, "
            f"{tp * rps - T - U} pad columns, shard table {tuple(stb.shard_tables.shape)}): every "
            f"shard exact against its plain version on rows {tuple(rows.shape)} (reads of 1, 2, "
            f"3+ segments: {by_segs}); the merged shards equal the whole table's K3")
        del stb
    logical, shard, rps = timed
    run = lambda: _set_probe_partial_cuda(rows, sk_lens, shard, 0, rps, T, U)  # noqa: E731
    t = {"ms": cuda_graph_time_ms(run, 10), "eager_ms": cuda_time_ms(run, 20),
         "plain_ms": cuda_time_ms(lambda: set_probe_partial_plain(
             rows, sk_lens, logical, 0, rps, T, U), 3, warmup=1),
         "bound_ms": bounds.bound_ms(bounds.set_probe_partial_bytes(rows, sk_lens, logical,
                                                                    shard, rps, U)),
         "whole_ms": cuda_graph_time_ms(
             lambda: _set_probe_cuda(rows, sk_lens, tb.probe_table, T, U), 10),
         "shape": list(rows.shape), "shard_columns": rps, "reads_by_segments": by_segs}
    say(f"time set_probe_partial (182-type panel, shard 0 of 2, {rps} columns, rows "
        f"{tuple(rows.shape)}): {t['ms']:.4f} ms ({t['eager_ms']:.4f} eager) vs "
        f"{t['plain_ms']:.4f} ms plain; the whole table's K3 {t['whole_ms']:.4f} ms; bound "
        f"{t['bound_ms']:.4f} ms (share {t['bound_ms'] / t['ms']:.3f})")
    return worst, t


def check_k9_base(dev, cw: dict) -> tuple[int, dict]:
    """Phase 36b: K9 with a slice's global offset (base > 0) on the call
    workload's reference cut into 2 and 4 slices as ``call --devices``
    cuts it: each slice's K1, K8, window average over the previous slice's
    last w depths and K9 (``call_scan_slice``) exactly against the same
    slice's plain version (``_enumerate_plain`` at the same base) and
    against the whole row's scan sliced.  Then times K9 on slice 1 of 4.
    -> (max_abs_err, times)."""
    import torch

    from rkmh_tpu_torch import call_engine
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.io.packing import PAD_CODE

    k, w = 16, 100
    codes, table = cw["codes"], cw["table"]
    whole = call_engine.call_scan_plain(codes, table, k, w)
    P = codes.numel() - k + 1
    worst, timed = 0, None
    for n in (2, 4):
        Pl = -(-P // n)
        padded = torch.full((n * Pl + k + 1,), int(PAD_CODE), dtype=torch.uint8, device=dev)
        padded[0] = 4
        padded[1: 1 + codes.numel()] = codes
        halo = None
        for d in range(n):
            j0, j1 = d * Pl, min((d + 1) * Pl, P)
            pref = padded[j0: j0 + Pl + k + 1]
            got = call_engine.call_scan_slice(pref, table, k, w, Pl, j0, halo)
            want = call_engine.call_scan_slice(pref, table, k, w, Pl, j0, halo, plain=True)
            for name in want:
                err = max_abs_err(got[name].to(torch.int64), want[name].to(torch.int64))
                if err or not torch.equal(got[name], want[name]) \
                        or not torch.equal(got[name][: j1 - j0], whole[name][j0:j1]):
                    raise AssertionError(f"K9 at base {j0} (slice {d} of {n}) disagrees: {name}")
                worst = max(worst, err)
            if n == 4 and d == 1:
                timed = (pref, got, j0, Pl)
            halo = got["depth"][-w:]
    pref, got, base, Pl = timed
    run = lambda: call_engine._call_scan_pref_cuda(  # noqa: E731
        pref, table, k, got["depth"], got["avg"], got["site"], base=base)
    t = {"ms": cuda_graph_time_ms(run, 20), "eager_ms": cuda_time_ms(run, 50), "base": base,
         "positions": Pl}
    say(f"K9 with a base: the workload reference in 2 and 4 slices, every slice exact against "
        f"its plain version and the whole row's scan; slice 1 of 4 ({Pl} positions from "
        f"{base}): {t['ms']:.5f} ms ({t['eager_ms']:.5f} eager)")
    return worst, t


def reckon_peak(step_rows: int, width: int, extra: dict) -> str:
    """The peak device memory a sharded run should reach, reckoned before
    it: what is allocated now, the named extras, and one batch's working set
    (the K1 hashes, the sort's keys, values and output: ~4 int64 copies of
    [rows, width] a tp column)."""
    import torch

    parts = {"resident": torch.cuda.memory_allocated(), **extra,
             "batch working set": 4 * 8 * step_rows * width}
    total = sum(parts.values())
    return (f"{total / 2**30:.2f} GiB ("
            + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in parts.items()) + ")")


def run_sharded_hpv16(dev, card: str, tmp: str, cfg: dict, reads: str, one_lines: list,
                      one_s: float, mbp: float, table_bytes: int, keep: str) -> dict:
    """Phase 37a (inside phase 10, on its input): hpv16 on a grid of
    (cuda:0,) * 4, each run driven with the counters zeroed just before and
    read just after, byte for byte against one device on the card: (2, 2)
    over all N_HPV16_READS reads (against phase 10's run), (4, 1) and (1, 4)
    over the first N_SHARDED_HEAD, -M 2 at (2, 2) (the 8e8-slot counter in
    2 dp slot ranges) and the 182 types under a 256 MB cap at (2, 2) (the
    sorted panel replicated, K10 on each dp slice) over the same head, each
    beside its one-device run; the peak memory reckoned before each run and
    measured; then ``rkmh-tpu-torch hpv16 --devices 2`` through the CLI: on
    one card the fallback line on stderr and one device's stdout.  Phase
    39's input goes to ``keep``: the refpath, the head, and the one-device
    runs' lines and seconds."""
    import shutil
    import subprocess

    import torch

    from rkmh_tpu_torch.commands import hpv16_cmd
    from rkmh_tpu_torch.ops import kernels

    grid = (torch.device("cuda", 0),) * GRID
    head = head_file(reads, os.path.join(tmp, "head37.fq"), N_SHARDED_HEAD)
    with open(head) as fh:
        head_mbp = sum(len(ln) - 1 for i, ln in enumerate(fh) if i % 4 == 1) / 1e6
    with open(reads) as fh:
        max_len = max(len(ln) - 1 for i, ln in enumerate(fh) if i % 4 == 1)
    cwd, res = os.getcwd(), {}

    def one_run(label, read_files, needed, **kw):
        wd = os.path.join(tmp, label.replace(" ", "_"))
        os.makedirs(wd)
        os.chdir(wd)
        seconds, launches = driven(lambda: hpv16_cmd.run(hpv16_cmd.Hpv16Config(
            **{**cfg, "read_files": read_files}, out_file="out.tsv", device="cuda", **kw)),
            label, needed)
        return seconds, launches, read_text("out.tsv")

    def grid_run(label, read_files, want, single_s, n_mbp, tp, needed, extra, **kw):
        say(f"{label}: reckoned peak {reckon_peak(HPV16_BATCH // (GRID // tp), max_len, extra)}")
        torch.cuda.reset_peak_memory_stats()
        seconds, launches, text = one_run(label, read_files, needed, devices=GRID, tp=tp,
                                          mesh_devices=grid, **kw)
        peak = torch.cuda.max_memory_allocated()
        require_same(text, want, label)
        r = {"e2e_s": seconds, "e2e_mbp_per_s": n_mbp / seconds,
             "one_device_mbp_per_s": n_mbp / single_s, "ratio": single_s / seconds,
             "peak_gib": peak / 2**30, "launches": launches,
             "set_probe_by_route": {"whole": launches["set_probe"],
                                    "partial": launches["set_probe_partial"]}}
        say(f"{label} on {card}, {GRID} shards sharing one card: e2e {r['e2e_mbp_per_s']:.3f} "
            f"Mbp/s ({seconds:.2f} s); one device {r['one_device_mbp_per_s']:.3f} Mbp/s; ratio "
            f"{r['ratio']:.3f}; peak {r['peak_gib']:.2f} GiB allocated; byte-identical")
        res[label] = r
        return r

    part = ("window_hash", "set_table_fill", "set_probe_partial")
    try:
        head_s, _, head_text = one_run("hpv16 one device head", [head], ("window_hash",
                                                                        "set_table_fill",
                                                                        "set_probe"))
        require_same(head_text, "".join(one_lines[:N_SHARDED_HEAD]), "hpv16 head")
        shards = {"shard tables (about the whole table's)": table_bytes}
        grid_run("hpv16 --devices 4 --tp 2", [reads], "".join(one_lines), one_s, mbp, 2, part,
                 shards)
        for tp in (1, 4):
            grid_run(f"hpv16 --devices 4 --tp {tp}", [head], head_text, head_s, head_mbp, tp,
                     part, shards)
        m_s, _, m_text = one_run("hpv16 -M one device head", [head],
                                 ("window_hash", "set_table_fill", "counter_add", "counter_mask",
                                  "set_probe"),
                                 min_kmer_occ=MIN_OCC)
        for name in ("all_pave_ref.fa", "new_refs.fa"):
            shutil.copyfile(os.path.join(tmp, name), os.path.join(keep, name))
        shutil.copyfile(head, os.path.join(keep, "head.fq"))
        for name, text in (("one.tsv", head_text), ("m.tsv", m_text)):
            with open(os.path.join(keep, name), "w") as fh:
                fh.write(text)
        with open(os.path.join(keep, "one.json"), "w") as fh:
            json.dump({"hpv16": head_s, "hpv16 -M 2": m_s, "mbp": head_mbp}, fh)
        r = grid_run("hpv16 -M 2 --devices 4 --tp 2", [head], m_text, m_s, head_mbp, 2,
                     part + ("counter_add", "counter_mask"),
                     {**shards, "counter (2 slot ranges)": 4 * HPV16_COUNTER},
                     min_kmer_occ=MIN_OCC)
        ranges = {k: kernels.KERNELS[k].by_route.get("range", 0)
                  for k in ("counter_add", "counter_mask")}
        if not all(ranges.values()):
            raise AssertionError(f"hpv16 -M --devices: K6/K7 launches over a slot range {ranges}")
        r["launches"] = {**r["launches"], "by_range": ranges}
        old = os.environ.get("RKMH_TPU_SET_TABLE_MAX_MB")
        os.environ["RKMH_TPU_SET_TABLE_MAX_MB"] = "256"
        try:
            c_s, _, c_text = one_run("hpv16 capped one device head", [head],
                                     ("window_hash", "sorted_probe"))
            require_same(c_text, head_text, "hpv16 capped head")
            r = grid_run("hpv16 capped --devices 4 --tp 2", [head], c_text, c_s, head_mbp, 2,
                         ("window_hash", "sorted_probe"),
                         {"sorted panel (~1/10 of the table)": table_bytes // 10})
            if r["launches"]["set_probe"] or r["launches"]["set_probe_partial"]:
                raise AssertionError("the capped sharded hpv16 run launched K3")
        finally:
            if old is None:
                del os.environ["RKMH_TPU_SET_TABLE_MAX_MB"]
            else:
                os.environ["RKMH_TPU_SET_TABLE_MAX_MB"] = old
        wd = os.path.join(tmp, "cli37")
        os.makedirs(wd)
        small = head_file(reads, os.path.join(tmp, "cli37.fq"), N_CLI_HPV16)
        proc = subprocess.run([sys.executable, "-m", "rkmh_tpu_torch.cli", "hpv16", "-f", small,
                               "-R", tmp, "-k", str(HPV16_K), "--devices", "2"], cwd=wd,
                              env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
                              text=True, timeout=300)
    finally:
        os.chdir(cwd)
    n_visible = torch.cuda.device_count()
    fallback = (f"hpv16 --devices ignored (--devices 2 > {n_visible} visible device(s)); "
                "running single-device")
    if proc.returncode or (n_visible == 1 and fallback not in proc.stderr.splitlines()):
        raise AssertionError(f"hpv16 --devices 2 through the CLI: rc {proc.returncode}, "
                             f"stderr {proc.stderr[-500:]!r}")
    require_same(proc.stdout, "".join(one_lines[:N_CLI_HPV16]), "hpv16 --devices 2 (CLI)")
    say(f"CLI hpv16 --devices 2 on {n_visible} card(s): stdout byte-identical to one device"
        + (f"; stderr: {fallback}" if n_visible == 1 else ""))
    return res


def run_sharded_call(dev, card: str, cw: dict) -> dict:
    """Phase 37b: ``call --devices 4`` on the grid of (cuda:0,) * 4 (each
    run driven with the counters zeroed just before and read just after)
    byte for byte against one device on the card: the call workload's VCF
    and ``-d``, and the VCF of the 1 Mbp reference of ``bench/call_inputs``
    (written as FASTA) against the same map's reads; seconds beside one
    device's."""
    import io

    import torch

    from rkmh_tpu_torch.commands import call_cmd
    from rkmh_tpu_torch.ops import kernels

    grid = (torch.device("cuda", 0),) * GRID
    tmp = os.path.dirname(cw["ref"])
    big = os.path.join(tmp, "big.fa")
    with open(big, "w") as fh:
        fh.write(">big1mbp\n" + bytes(b"ACGTN"[c] for c in cw["big"].cpu().tolist())
                 .decode() + "\n")
    needed = ("window_hash", "hashmap_get", "call_scan")
    res = {}
    for label, ref, show_depth in (("call --devices 4", cw["ref"], False),
                                   ("call -d --devices 4", cw["ref"], True),
                                   ("call 1 Mbp --devices 4", big, False)):
        kw = dict(ref_files=[ref], read_files=[cw["reads"]], ks=(16,), window_len=100,
                  show_depth=show_depth)
        outs = {}
        for devices in (0, GRID):
            buf = io.StringIO()
            seconds, launches = driven(lambda: call_cmd.run(call_cmd.CallConfig(
                devices=devices, device="cuda", mesh_devices=grid, **kw), out=buf),
                label if devices else label.replace(" --devices 4", " one device"), needed)
            outs[devices] = (buf.getvalue(), seconds, launches,
                             dict(kernels.CALL_SCAN.by_route))
        require_same(outs[GRID][0], outs[0][0], label)
        _, seconds, launches, routes = outs[GRID]
        res[label] = {"e2e_s": seconds, "one_device_s": outs[0][1],
                      "ratio": outs[0][1] / seconds, "launches": launches, "k9_routes": routes,
                      "bytes": len(outs[GRID][0])}
        say(f"{label} on {card}, {GRID} slices sharing one card: {seconds:.3f} s; one device "
            f"{outs[0][1]:.3f} s; byte-identical ({len(outs[GRID][0])} bytes); K9 launches "
            f"{routes}")
    return res


def run_sp_sketch(dev, card: str) -> dict:
    """Phase 37c: ``parallel/sp.sp_sketch`` of two synthetic genomes of
    SP_LEN codes (runs of N) over 4 chunks on (cuda:0,) * 4, driven with
    the counters zeroed just before and read just after (K1), against one
    device's ``bottom_s_sketch`` of the whole rows (``engine.sketch_batch``),
    for k = 16 and for -k 12 -k 16; seconds beside one device's."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.parallel.sp import make_sp_mesh, sp_sketch

    rng = np.random.default_rng(37)
    codes = rng.integers(0, 4, (2, SP_LEN)).astype(np.uint8)
    for start in range(10_000, SP_LEN, 500_000):
        codes[:, start: start + 40] = 4
    mesh = make_sp_mesh([torch.device("cuda", 0)] * GRID)
    res = {}
    for ks in ((16,), (12, 16)):
        out = {}
        seconds, launches = driven(lambda: out.update(sp=sp_sketch(mesh, codes, ks, SP_SKETCH)),
                                   f"sp_sketch k={ks}", ("window_hash",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = engine.sketch_batch(torch.from_numpy(codes).to(dev), ks, SP_SKETCH)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        sk, lens = out["sp"]
        if not (torch.equal(sk, one[0]) and torch.equal(lens, one[1])):
            raise AssertionError(f"sp_sketch over {GRID} chunks differs from one device, ks {ks}")
        label = f"sp_sketch -k {' -k '.join(map(str, ks))}"
        res[label] = {"e2e_s": seconds, "one_device_s": one_s, "launches": launches}
        say(f"{label} on {card}: {GRID} chunks of {SP_LEN // GRID} codes x 2 genomes, s = "
            f"{SP_SKETCH}: {seconds:.4f} s (one device {one_s:.4f} s), equal to one device's "
            f"sketch")
    return res


# ---- phase 38: --dist-* (commands/dist_stream.py): two rank processes on the one card

N_DIST_RANKS = 2
DIST_GRID = 2             # (d): each rank's local grid, (cuda:0,) * 2 at tp = 2
DIST_TIMEOUT_S = 420      # the pair's own limit; a failed rank's peer gets DIST_GRACE_S
DIST_GRACE_S = 30
DIST_CUT_SHARE = 0.4      # rank 1's stripe (and filter's idx) cut at 40%


def _dist_cfg(job: dict):
    """The config and the ``run`` of a phase 38 or 39 job, with this rank's
    --dist-* settings."""
    import torch

    from rkmh_tpu_torch.commands import (
        call_cmd, count_cmd, filter_cmd, hash_cmd, hpv16_cmd, search_cmd, stream,
    )

    cfg = dict(job["cfg"])
    if job.get("grid"):
        cfg["mesh_devices"] = (torch.device("cuda", 0),) * job["grid"]
    mod, make = {"stream": (stream, stream.StreamConfig),
                 "filter": (filter_cmd, filter_cmd.FilterConfig),
                 "hash": (hash_cmd, hash_cmd.HashConfig),
                 "count": (count_cmd, count_cmd.CountConfig),
                 "search": (search_cmd, search_cmd.SearchConfig),
                 "hpv16": (hpv16_cmd, hpv16_cmd.Hpv16Config),
                 "call": (call_cmd, call_cmd.CallConfig)}[job["run"]]
    return make(**cfg), mod.run


def _dist_cut(job: dict, rank: int) -> None:
    """Copy this rank's stripe (and idx, and -M checkpoint) and the sidecar
    from the job's ``src`` prefix to ``dst``; rank ``cut_rank`` then cuts its copy as an
    interrupted run leaves it: a stream stripe inside the line at
    DIST_CUT_SHARE of its bytes; a filter idx to DIST_CUT_SHARE of its lines
    (the last one torn) and the stripe to the records those lines cover
    plus half a line."""
    import shutil

    src, dst = job["src"], job["dst"]
    suffixes = [f".{rank}"] + ([f".{rank}.idx"] if job["filter"] else [])
    if os.path.exists(f"{src}.mctr.{rank}.npz"):
        suffixes.append(f".mctr.{rank}.npz")  # the -M counter: --resume restores it
    for suffix in suffixes:
        shutil.copyfile(src + suffix, dst + suffix)
    tmp = f"{dst}.dist.json.{rank}.tmp"
    shutil.copyfile(src + ".dist.json", tmp)
    os.replace(tmp, dst + ".dist.json")
    if rank != job["cut_rank"]:
        return
    stripe = f"{dst}.{rank}"
    if not job["filter"]:
        cut_mid_line(stripe, DIST_CUT_SHARE)
        return
    with open(stripe + ".idx") as fh:
        counts = fh.read().split()
    keep = int(len(counts) * DIST_CUT_SHARE)
    with open(stripe + ".idx", "w") as fh:
        fh.write("".join(f"{c}\n" for c in counts[:keep]) + counts[keep][:1])
    lines = 4 * sum(int(c) for c in counts[:keep])
    with open(stripe, "rb") as fh:
        data = fh.readlines()
    torn = data[lines][: len(data[lines]) // 2] if lines < len(data) else b""
    with open(stripe, "wb") as fh:
        fh.write(b"".join(data[:lines]) + torn)


def dist_rank_worker(spec_path: str) -> int:
    """A rank of phase 38 or 39 (``chip_smoke.py --dist-rank-worker SPEC``):
    the spec's jobs in order, each run with the launch counters zeroed just
    before and read just after (in ``<cwd>/<rank>`` where the job names a
    ``cwd``; what it writes to its output stream into ``<stdout>.<rank>``
    where it names a ``stdout``); writes each job's seconds, launches (in
    all and over slot ranges), peak memory and counter reduction (timed
    here around ``dist_stream._reduce_counter`` and ``_save_counter_ckpt``)
    to the spec's result file for this rank as it goes."""
    import torch

    sys.path.insert(0, REPO)
    from rkmh_tpu_torch.commands import dist_stream
    from rkmh_tpu_torch.ops import kernels

    reduce: dict = {}
    reduce_counter, save_ckpt = dist_stream._reduce_counter, dist_stream._save_counter_ckpt

    def timed_reduce(tables):
        t0 = time.perf_counter()
        host = reduce_counter(tables)
        reduce.update(bytes=host.nbytes, seconds=time.perf_counter() - t0)
        return host

    def timed_save(*args):
        t0 = time.perf_counter()
        save_ckpt(*args)
        reduce["checkpoint_seconds"] = time.perf_counter() - t0

    dist_stream._reduce_counter, dist_stream._save_counter_ckpt = timed_reduce, timed_save
    with open(spec_path) as fh:
        spec = json.load(fh)
    rank = int(os.environ["RKMH_SMOKE_RANK"])
    dist = dict(dist_coordinator=spec["coordinator"], dist_procs=N_DIST_RANKS,
                dist_rank=rank)
    results = []
    for job in spec["jobs"]:
        if "src" in job:
            _dist_cut(job, rank)
            results.append({"label": job["label"]})
        else:
            cfg, run = _dist_cfg({**job, "cfg": {**job["cfg"], **dist}})
            cwd = os.getcwd()
            if job.get("cwd"):
                os.makedirs(os.path.join(job["cwd"], str(rank)), exist_ok=True)
                os.chdir(os.path.join(job["cwd"], str(rank)))  # hpv16's .tst lands here
            out = open(f"{job['stdout']}.{rank}", "w") if job.get("stdout") else None
            kernels.reset_launch_counts()
            reduce.clear()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                rc = run(cfg) if out is None else run(cfg, out)
                torch.cuda.synchronize()
            finally:
                os.chdir(cwd)
                if out is not None:
                    out.close()
            seconds = time.perf_counter() - t0
            results.append({
                "label": job["label"], "rc": rc, "seconds": seconds,
                "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                "by_range": {k: kernels.KERNELS[k].by_route.get("range", 0)
                             for k in ("counter_add", "counter_mask")},
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "counter_reduce": dict(reduce)})
        with open(f"{spec['results']}.{rank}", "w") as fh:
            json.dump(results, fh)
        if results[-1].get("rc") not in (None, 0):
            return 1
    return 0


def _run_rank_pair(spec: dict, work: str, phase: str = "phase 38") -> list:
    """Start the two ranks (this script in worker mode, each on cuda:0,
    the gloo group's rendezvous a file store in ``work``, its connections
    on the loopback interface) and wait for them; a rank that fails gets
    its peer killed after DIST_GRACE_S, a pair past DIST_TIMEOUT_S is
    killed; either raises, naming the ``phase``.  -> each rank's results."""
    import subprocess

    store = os.path.join(work, "dist_store")
    if os.path.exists(store):
        os.remove(store)
    spec["coordinator"] = f"file://{store}"
    spec["results"] = os.path.join(work, "dist_results")
    spec_path = os.path.join(work, "dist_spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    logs = [os.path.join(work, f"dist_rank.{r}.log") for r in range(N_DIST_RANKS)]
    env = {**os.environ, "RKMH_TPU_INPUT_INDEX": os.path.join(work, "idx"),
           "GLOO_SOCKET_IFNAME": "lo"}
    ranks = []
    ok = False
    try:
        for r in range(N_DIST_RANKS):
            with open(logs[r], "w") as log_fh:
                ranks.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--dist-rank-worker", spec_path],
                    cwd=REPO, env={**env, "RKMH_SMOKE_RANK": str(r)}, stdout=log_fh,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while any(p.poll() is None for p in ranks):
            if any(p.poll() not in (None, 0) for p in ranks):
                deadline = min(deadline, time.monotonic() + DIST_GRACE_S)
            if time.monotonic() > deadline:
                raise AssertionError(f"{phase}: the rank pair did not end in time (exit "
                                     f"codes {[p.poll() for p in ranks]})")
            time.sleep(0.1)
        ok = all(p.returncode == 0 for p in ranks)
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
            p.wait()
        for r, p in enumerate(ranks):
            if not ok:
                with open(logs[r]) as fh:
                    say(f"{phase} rank {r} (exit {p.returncode}) log tail:\n{fh.read()[-2000:]}")
    if not ok:
        raise AssertionError(f"{phase}: rank exit codes {[p.returncode for p in ranks]}")
    got = []
    for r in range(N_DIST_RANKS):
        with open(f"{spec['results']}.{r}") as fh:
            got.append(json.load(fh))
    return got


def _merge_stripes(prefix: str, dst: str) -> str:
    """rkmh-tpu-torch-dist-merge (``dist_stream.merge_main``, which the
    console script and ``python -m rkmh_tpu_torch.commands.dist_stream``
    call) of the two stripes into dst, in this process: a process of its
    own would spend seconds on imports for each merge."""
    from rkmh_tpu_torch.commands import dist_stream

    with open(dst, "w") as out, contextlib.redirect_stdout(out):
        if dist_stream.merge_main([f"{prefix}.{r}" for r in range(N_DIST_RANKS)]) != 0:
            raise AssertionError(f"the merge of {prefix}.* failed")
    return dst


def run_dist_paths(card: str, zika: dict, single: dict) -> dict:
    """Phase 38: two rank processes on the one card (each on cuda:0, a gloo
    group on the loopback) run, over the slice's 2**20 reads, (a) ``stream
    -o``, (b) ``stream -M 2 -I 40 -o`` (2e8 slots), (c) ``filter -M 2 -I 40
    -N 10 -o`` and (d) ``stream --tp 2`` on local grids of ``(cuda:0,) *
    2``; then (a) and (c) again with --resume after rank 1's stripe (and
    filter's idx) is cut at 40%.  Each merged output
    (``rkmh-tpu-torch-dist-merge``) must equal one process's (phases 6, 13,
    14) byte for byte; every rank must launch its path's kernels (a
    resumed rank whose stripe is whole classifies nothing).  ->
    per path: the pair's reads/s (the slower rank's seconds) beside one
    process's, each rank's launches, peak memory and -M reduction."""
    tmp = zika["dir"]
    one = {"stream": os.path.join(tmp, "gpu.tsv"),
           "stream -M -I": os.path.join(tmp, "stream_mi.tsv"),
           "filter": os.path.join(tmp, "filter.fq")}
    base = dict(ref_files=[zika["refs"]], read_files=[zika["reads"]], ks=[12],
                sketch_size=1000, device="cuda")
    mi = dict(min_kmer_occ=MIN_OCC, max_samples=MAX_SAMPLES)
    out = {k: os.path.join(tmp, f"dist_{k}") for k in ("a", "b", "c", "d", "ar", "cr")}
    probe = ("window_hash", "panel_probe")
    counted = ("window_hash", "counter_add", "counter_mask")
    runs = [  # label, job, one process's output, its seconds, the kernels a rank needs
        # (one tuple for every rank, or a tuple a rank)
        ("a", {"run": "stream", "cfg": {**base, "out_file": out["a"]}},
         one["stream"], single["stream"]["e2e_s"], probe),
        ("b", {"run": "stream", "cfg": {**base, **mi, "out_file": out["b"]}},
         one["stream -M -I"], single["stream -M -I"]["e2e_s"], counted + ("panel_probe",)),
        ("c", {"run": "filter", "cfg": {**base, **mi, "min_matches": FILTER_MIN_MATCHES,
                                        "out_file": out["c"]}},
         one["filter"], single["filter"]["e2e_s"], counted + ("panel_probe_filter",)),
        ("d", {"run": "stream", "cfg": {**base, "tp": 2, "out_file": out["d"]},
               "grid": DIST_GRID},
         one["stream"], single["stream"]["e2e_s"], ("window_hash", "panel_probe_partial")),
    ]
    jobs = [dict(job, label=label) for label, job, *_ in runs]
    for label, src, filt in (("ar", "a", False), ("cr", "c", True)):
        jobs.append({"label": f"cut {src}", "src": out[src], "dst": out[label], "filter": filt,
                     "cut_rank": 1})
    # resumed, rank 0 (its stripe whole) classifies nothing: K1 hashes the panel
    runs += [
        ("ar", {"run": "stream", "cfg": {**base, "out_file": out["ar"], "resume": True}},
         one["stream"], single["stream"]["e2e_s"], [("window_hash",), probe]),
        ("cr", {"run": "filter", "cfg": {**base, **mi, "min_matches": FILTER_MIN_MATCHES,
                                         "out_file": out["cr"], "resume": True}},
         one["filter"], single["filter"]["e2e_s"],
         [("window_hash",), ("window_hash", "panel_probe_filter")]),
    ]
    jobs += [dict(job, label=label) for label, job, *_ in runs[-2:]]
    names = {"a": "stream", "b": "stream -M 2 -I 40", "c": "filter -M 2 -I 40 -N 10",
             "d": f"stream --tp 2 on (cuda:0,) * {DIST_GRID}", "ar": "stream --resume",
             "cr": "filter -M 2 -I 40 -N 10 --resume"}
    t0 = time.perf_counter()
    ranks = _run_rank_pair({"jobs": jobs}, tmp)
    say(f"phase 38: the rank pair ran {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s "
        "(both processes' start-up included)")
    by_label = [{res["label"]: res for res in results} for results in ranks]
    res = {}
    for label, job, want, single_s, needed in runs:
        per_rank = [by[label] for by in by_label]
        for r, got in enumerate(per_rank):
            if got["rc"] != 0:
                raise AssertionError(f"phase 38 {names[label]}: rank {r} exited {got['rc']}")
            mine = needed[r] if isinstance(needed, list) else needed
            require_launches({k: got["launches"].get(k, 0) for k in mine}, mine,
                             f"dist {names[label]} (rank {r})")
        same_file(_merge_stripes(out[label], out[label] + ".merged"), want,
                  f"dist {names[label]}")
        seconds = max(got["seconds"] for got in per_rank)
        launches = {}
        for got in per_rank:
            for k, v in got["launches"].items():
                launches[k] = launches.get(k, 0) + v
        by_range = {k: sum(got["by_range"][k] for got in per_rank)
                    for k in ("counter_add", "counter_mask")}
        reduce = [got["counter_reduce"] for got in per_rank]
        peaks = [got["peak_bytes"] / 2**30 for got in per_rank]
        res[f"dist {names[label]}"] = {
            "e2e_s": seconds, "e2e_reads_per_s": N_SLICE_READS / seconds,
            "one_process_reads_per_s": N_SLICE_READS / single_s,
            "launches": {**launches, "by_range": by_range},
            "launches_by_rank": [got["launches"] for got in per_rank],
            "rank_seconds": [got["seconds"] for got in per_rank],
            "peak_gib_by_rank": peaks, "counter_reduce_by_rank": reduce}
        reduced = "".join(f"; rank {r} -M all_reduce {x['bytes']} bytes in {x['seconds']:.4f} s"
                          f" (checkpoint saved in {x.get('checkpoint_seconds', 0):.4f} s)"
                          for r, x in enumerate(reduce) if x)
        rank_s = ", ".join(f"{got['seconds']:.3f}" for got in per_rank)
        peak_s = ", ".join(f"{p:.3f}" for p in peaks)
        say(f"dist {names[label]} on {card}, {N_DIST_RANKS} ranks sharing one card (the "
            f"machinery's cost, not scaling): {N_SLICE_READS / seconds:.1f} reads/s (ranks "
            f"{rank_s} s); one process {N_SLICE_READS / single_s:.1f} reads/s (ratio "
            f"{single_s / seconds:.2f}); merged output byte-identical to one process's; peak "
            f"{peak_s} GiB by rank{reduced}")
    return res


# ---- phase 39: the rest of --dist-* (hash, count, search, hpv16, call)


def _same_arrays(a: str, b: str, what: str) -> None:
    import numpy as np

    with np.load(a) as x, np.load(b) as y:
        if sorted(x.files) != sorted(y.files) or not all(
                x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x.files):
            raise AssertionError(f"{what}: the arrays of {a} and {b} differ")


def run_dist_rest(card: str, p39: dict) -> dict:
    """Phase 39: the rank pair of phase 38 (two processes on cuda:0, a gloo
    group) runs ``hash`` and ``hash -s 1000`` over phase 17's 2**18 reads,
    ``count`` (640,000 slots, ``-o`` and ``--dump``) and ``search`` (the
    50,000 12-mers) over the slice's 2**20 reads, ``hpv16`` at the
    published shape over phase 37's 3,200-read head (182 types, 512-read
    batches), ``hpv16 --tp 2`` on local grids of ``(cuda:0,) * 2``, ``hpv16
    -M 2`` at the default 8e8 slots, ``call`` on phase 22's workload, and
    ``call --resume`` after rank 1's stripe is cut inside its section.
    Each merged output (``rkmh-tpu-torch-dist-merge``) must equal one
    process's of phases 17-19, 37 and 24 byte for byte (count: rank 0's
    npz arrays and ``--dump`` lines; rank 1 prints none); every rank must
    launch its path's kernels.  -> per path: the pair's rate (the slower
    rank) beside one process's, each rank's launches, peak memory and
    counter reduction (bytes, seconds, the checkpoint's seconds)."""
    work, hp = p39["dir"], p39["hpv16"]
    with open(os.path.join(hp, "one.json")) as fh:
        hp_one = json.load(fh)
    out = {k: os.path.join(work, f"d39_{k}") for k in ("h", "hs", "c", "s", "p", "pt", "pm",
                                                       "v", "vr")}
    hcfg = dict(read_files=[p39["hash_reads"]], ks=[12], device="cuda")
    pcfg = dict(read_files=[os.path.join(hp, "head.fq")], refpath=hp, ks=[HPV16_K],
                batch_size=HPV16_BATCH, device="cuda")
    vcfg = dict(ref_files=[p39["call_ref"]], read_files=[p39["call_reads"]], ks=[16],
                window_len=100, device="cuda")
    cwd = os.path.join(work, "d39_cwd")
    scan = ("window_hash", "hashmap_get", "call_scan")
    # label, job, one process's output, its seconds, the work (reads or Mbp), the kernels
    # a rank needs (one tuple for every rank, or a tuple a rank)
    runs = [
        ("hash", {"run": "hash", "cfg": {**hcfg, "out_file": out["h"]}},
         p39["hash_out"], p39["hash_s"], N_HASH_READS, ("window_hash",)),
        ("hash -s 1000", {"run": "hash", "cfg": {**hcfg, "sketch_size": 1000,
                                                 "out_file": out["hs"]}},
         p39["hash_s_out"], p39["hash_s_s"], N_HASH_READS, ("window_hash",)),
        ("count", {"run": "count", "cfg": dict(read_files=[p39["reads"]], ks=[12],
                                               counter_size=COUNT_SLOTS, out_file=out["c"],
                                               dump=True, device="cuda"),
                   "stdout": out["c"] + ".dump"},
         p39["count_npz"], p39["count_s"], N_SLICE_READS, ("window_hash", "counter_add")),
        ("search", {"run": "search", "cfg": dict(ref_files=[p39["search_refs"]],
                                                 read_files=[p39["reads"]], ks=[12],
                                                 out_file=out["s"], device="cuda")},
         p39["search_out"], p39["search_s"], N_SLICE_READS, ("window_hash",)),
        ("hpv16", {"run": "hpv16", "cfg": {**pcfg, "out_file": out["p"]}, "cwd": cwd},
         os.path.join(hp, "one.tsv"), hp_one["hpv16"], hp_one["mbp"],
         ("window_hash", "set_table_fill", "set_probe")),
        ("hpv16 --tp 2", {"run": "hpv16", "cfg": {**pcfg, "tp": 2, "out_file": out["pt"]},
                          "grid": DIST_GRID, "cwd": cwd},
         os.path.join(hp, "one.tsv"), hp_one["hpv16"], hp_one["mbp"],
         ("window_hash", "set_table_fill", "set_probe_partial")),
        ("hpv16 -M 2", {"run": "hpv16", "cfg": {**pcfg, "min_kmer_occ": MIN_OCC,
                                                "out_file": out["pm"]}, "cwd": cwd},
         os.path.join(hp, "m.tsv"), hp_one["hpv16 -M 2"], hp_one["mbp"],
         ("window_hash", "set_table_fill", "counter_add", "counter_mask", "set_probe")),
        ("call", {"run": "call", "cfg": {**vcfg, "out_file": out["v"]}},
         p39["call_vcf"], p39["call_s"], None, scan),
    ]
    jobs = [dict(job, label=label) for label, job, *_ in runs]
    jobs.append({"label": "cut call", "src": out["v"], "dst": out["vr"], "filter": False,
                 "cut_rank": 1})
    # resumed, rank 0 (its section whole) scans nothing: K1 builds the depth map
    runs.append(("call --resume", {"run": "call", "cfg": {**vcfg, "out_file": out["vr"],
                                                          "resume": True}},
                 p39["call_vcf"], p39["call_s"], None, [("window_hash",), scan]))
    jobs.append(dict(runs[-1][1], label="call --resume"))
    t0 = time.perf_counter()
    ranks = _run_rank_pair({"jobs": jobs}, work, "phase 39")
    say(f"phase 39: the rank pair ran {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s "
        "(both processes' start-up included)")
    by_label = [{res["label"]: res for res in results} for results in ranks]
    res = {}
    for label, job, want, single_s, work_done, needed in runs:
        per_rank = [by[label] for by in by_label]
        for r, got in enumerate(per_rank):
            if got["rc"] != 0:
                raise AssertionError(f"phase 39 {label}: rank {r} exited {got['rc']}")
            mine = needed[r] if isinstance(needed, list) else needed
            require_launches({k: got["launches"].get(k, 0) for k in mine}, mine,
                             f"dist {label} (rank {r})")
        prefix = out[{"hash": "h", "hash -s 1000": "hs", "count": "c", "search": "s",
                      "hpv16": "p", "hpv16 --tp 2": "pt", "hpv16 -M 2": "pm", "call": "v",
                      "call --resume": "vr"}[label]]
        t0 = time.perf_counter()
        if label == "count":
            _same_arrays(prefix + ".npz", want, "dist count")
            same_file(prefix + ".dump.0", p39["count_dump"], "dist count --dump (rank 0)")
            if os.path.getsize(prefix + ".dump.1"):
                raise AssertionError("dist count: rank 1 printed a dump")
        else:
            same_file(_merge_stripes(prefix, prefix + ".merged"), want, f"dist {label}")
            os.remove(prefix + ".merged")
        check_s = time.perf_counter() - t0
        seconds = max(got["seconds"] for got in per_rank)
        launches: dict = {}
        for got in per_rank:
            for k, v in got["launches"].items():
                launches[k] = launches.get(k, 0) + v
        by_range = {k: sum(got["by_range"][k] for got in per_rank)
                    for k in ("counter_add", "counter_mask")}
        reduce = [got["counter_reduce"] for got in per_rank]
        peaks = [got["peak_bytes"] / 2**30 for got in per_rank]
        r_res = {"e2e_s": seconds, "one_process_s": single_s, "ratio": single_s / seconds,
                 "merge_and_check_s": check_s,
                 "launches": {**launches, "by_range": by_range},
                 "launches_by_rank": [got["launches"] for got in per_rank],
                 "rank_seconds": [got["seconds"] for got in per_rank],
                 "peak_gib_by_rank": peaks, "counter_reduce_by_rank": reduce}
        if label.startswith("hpv16"):
            unit, rate, one_rate = "Mbp/s", work_done / seconds, work_done / single_s
        elif work_done:
            unit, rate, one_rate = "reads/s", work_done / seconds, work_done / single_s
        else:
            unit = rate = one_rate = None
        if unit:
            r_res.update(unit=unit, rate=rate, one_process_rate=one_rate)
        res[f"dist {label}"] = r_res
        reduced = "".join(
            f"; rank {r} all_reduce {x['bytes']} bytes in {x['seconds']:.4f} s"
            + (f" (checkpoint saved in {x['checkpoint_seconds']:.4f} s)"
               if "checkpoint_seconds" in x else "")
            for r, x in enumerate(reduce) if x)
        rank_s = ", ".join(f"{got['seconds']:.3f}" for got in per_rank)
        peak_s = ", ".join(f"{p:.3f}" for p in peaks)
        speed = (f"{rate:.1f} {unit} (ranks {rank_s} s); one process {one_rate:.1f} {unit}"
                 if unit else f"{seconds:.3f} s (ranks {rank_s} s); one process "
                              f"{single_s:.3f} s")
        say(f"dist {label} on {card}, {N_DIST_RANKS} ranks sharing one card (the machinery's "
            f"cost, not scaling): {speed} (ratio {single_s / seconds:.2f}); merged output "
            f"byte-identical to one process's (merged and compared in {check_s:.2f} s); peak "
            f"{peak_s} GiB by rank{reduced}")
    return res


N_DEVICE_PANEL_REFS = 2048   # phase 40: 2,048 x s = 1000 sketch elements, the device build
DEVICE_PANEL_LEN = 1500
N_DEVICE_PANEL_READS = 1 << 17
COLLIDE_ROW = 64             # phase 40: the collision case's extra row (two hashes)


def _colliding_pair(dev, nb: int):
    """Two hashes of one lo word, of other hi words, in one bucket at nb
    buckets: a (lo, occ) collision for K13 to report."""
    import torch

    from rkmh_tpu_torch.ops.lookup import bucket_indices

    lo = 0x2545F491
    hi = (torch.arange(1, 8 * nb + 1, dtype=torch.int64, device=dev) * 2654435761) & 0xFFFFFFFF
    b = bucket_indices(torch.full_like(hi, lo), hi, torch.zeros_like(hi), nb)
    j = int(torch.nonzero(b[1:] == b[0])[0, 0]) + 1
    return [(int(x) << 32 | lo) - ((int(x) >> 31) << 64) for x in (hi[0], hi[j])]  # as int64


# phase 40a: K13 at the geometries of its tiles, timed at table sizes a build meets: a
# tp shard's S = 2 rows over 4M buckets (128 MiB), phase 40b's 2,048 references at S = 8
# (140 MiB) and rows wider than a tile, two windows a row (138 MiB)
FILL_TIMED = {"S2-Wm1": (2, 1, (1 << 22) + 5), "S8-Wm64": (8, 64, (1 << 16) + 5),
              "windows-S12-Wm700": (12, 700, 4096 + 5)}


def check_fill_geometries(dev) -> dict:
    """Phase 40a: K13 (``csrc/set_table.cu``) against ``set_table_fill_plain``
    on ``bench/fill_cases``: every S x Wm of its tiles at 1,029 buckets (the
    last tile partial), with a crowded bucket, a collision and left-out
    entries and without (a table that fits), no entries, rows of 8,436
    lanes (two windows a row), and 64 k + 5 buckets at S = 2 and 12; every
    lane and max_rank.  Then K13 at FILL_TIMED (graph, eager, plain, bound).
    -> {geometry: times}."""
    import torch

    from rkmh_tpu_torch.bench import bounds, fill_cases
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.ops import lookup

    def inputs(S, Wm, nb, n=None, crowd=True):
        return [torch.from_numpy(a).to(dev)
                for a in fill_cases.fill_case(S, Wm, nb, n, seed=40, crowd=crowd)]

    cases = 0
    for S, Wm in [*fill_cases.GEOMETRIES, fill_cases.WIDE]:
        nbs = [7] if (S, Wm) == fill_cases.WIDE else [fill_cases.NB] + (
            [64 * 1024 + 5] if S in (2, 12) and Wm < 64 else [])
        for nb in nbs:
            for n, crowd in ((None, True), (None, False), (0, True)):
                inp = inputs(S, Wm, nb, n, crowd)
                got, rank = lookup.set_table_fill(*inp, nb, S)
                want, want_rank = lookup.set_table_fill_plain(*inp, nb, S)
                if not torch.equal(got, want) or int(rank) != int(want_rank) or (
                        int(rank) >= S) != (crowd and n is None):
                    raise AssertionError(f"K13 disagrees with its plain version at S = {S}, "
                                         f"Wm = {Wm}, {nb} buckets, n {n}, crowd {crowd} "
                                         f"(max_rank {int(rank)} vs {int(want_rank)})")
                cases += 1
    say(f"K13 at its tile geometries: {cases} cases exact against set_table_fill_plain")
    res = {}
    for label, (S, Wm, nb) in FILL_TIMED.items():
        inp = inputs(S, Wm, nb, crowd=False)
        fill = lambda: lookup.set_table_fill(*inp, nb, S)  # noqa: E731
        got, _ = fill()
        if not torch.equal(got, lookup.set_table_fill_plain(*inp, nb, S)[0]):
            raise AssertionError(f"K13 disagrees with its plain version at {label}")
        del got
        n, width = inp[0].numel(), S * (3 + Wm)
        t = {"ms": cuda_graph_time_ms(fill, 5), "eager_ms": cuda_time_ms(fill, 10),
             "plain_ms": cuda_time_ms(lambda: lookup.set_table_fill_plain(*inp, nb, S), 3,
                                      warmup=1),
             "bound_ms": bounds.bound_ms(4 * nb * width + bounds.tensor_bytes(*inp[:5])
                                         + 4 * n * Wm + 4),
             "shape": {"entries": n, "buckets": nb, "slots": S, "mask_words": Wm,
                       "table_bytes": 4 * nb * width}}
        t["bound_share"] = t["bound_ms"] / t["ms"]
        res[label] = t
        say(f"time set_table_fill (K13) at {label}: {n} entries into [{nb}, {width}]: "
            f"{t['ms']:.4f} ms ({t['eager_ms']:.4f} eager) vs {t['plain_ms']:.4f} ms plain; "
            f"bound {t['bound_ms']:.4f} ms (share {t['bound_share']:.3f})")
        del inp
    return res


def check_device_builds(dev, card: str, cfg: dict, tb, packed) -> dict:
    """Phase 40a (inside 9): the device table builds.  On the 182-type
    panel's window hashes (``hpv16_cmd.panel_rows`` on the card): the sorts
    and K13's inputs (``ops/lookup._unique_entries``, ``fill_inputs``), K13
    (``csrc/set_table.cu``) against ``set_table_fill_plain`` on the same
    inputs at the path's geometry (and its output against the path's table),
    at 1/64 of its buckets (an overflow) and with a row of two hashes that
    collide in a bucket; every lane and max_rank equal.  The path's table
    against the same build on the CPU, bit for bit; K3's counts on the
    512-read batch against those on the numpy ``build_set_table``; the tp =
    2 shard stack against the CPU's, and its merged K3 partials against the
    numpy table's K3.  Times K13 (graph, eager) beside its plain version
    and its bound (the table written once, the entries read once), and the
    library calls before it.  -> K13's record."""
    import numpy as np
    import torch

    from rkmh_tpu_torch.bench import bounds
    from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
    from rkmh_tpu_torch.classify import engine
    from rkmh_tpu_torch.commands import hpv16_cmd
    from rkmh_tpu_torch.ops import lookup
    from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
    from rkmh_tpu_torch.ops.set_probe import (
        _set_probe_cuda,
        _set_probe_partial_cuda,
        merge_hpv16_partials,
        pack_set_table,
    )
    from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

    conf = hpv16_cmd.Hpv16Config(**cfg, tst_file=False)
    rows = hpv16_cmd.panel_rows(conf, HPV16_K, dev)
    h, m = rows.hashes, rows.mask
    R = h.shape[0]
    T, U = len(tb.type_names), tb.n_lin + tb.n_sub
    nb, width = tb.comb_table.shape
    S = lookup.table_slots(width, R)

    def prepare(nb_):
        return lookup.fill_inputs(lookup._unique_entries(h, m, R), nb_, False)

    inputs = prepare(nb)
    n = inputs[0].numel()
    cases = {"path": (inputs, nb), "overflow": (prepare(nb // 64), nb // 64)}
    pair = torch.tensor(_colliding_pair(dev, nb), dtype=torch.int64, device=dev)
    h2 = torch.cat([h, torch.zeros((1, h.shape[1]), dtype=h.dtype, device=dev)])
    m2 = torch.cat([m, torch.zeros((1, h.shape[1]), dtype=torch.bool, device=dev)])
    h2[R, :2], m2[R, :2] = pair, True
    cases["collision"] = (lookup.fill_inputs(lookup._unique_entries(h2, m2, R + 1), nb, False),
                          nb)
    worst = 0
    for label, (inp, nb_) in cases.items():
        got, rank = lookup.set_table_fill(*inp, nb_, S)
        want, want_rank = lookup.set_table_fill_plain(*inp, nb_, S)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err or not torch.equal(got, want) or int(rank) != int(want_rank):
            raise AssertionError(f"K13 disagrees with its plain version on the {label} case "
                                 f"(max_rank {int(rank)} vs {int(want_rank)})")
        worst = max(worst, err)
        expect_over = label != "path"
        if (int(rank) >= S) != expect_over:
            raise AssertionError(f"K13's {label} case: max_rank {int(rank)} at S = {S}")
        if label == "path" and not torch.equal(got, tb.comb_table):
            raise AssertionError("K13's table differs from the hpv16 path's table")
        say(f"K13 {label}: {n} entries into [{nb_}, {width}] (S = {S}), max_rank "
            f"{int(rank)}, exact against set_table_fill_plain")
        del got, want

    # the path's builds against the CPU's, and K3 on the numpy host table
    t0 = time.perf_counter()
    tb_cpu = hpv16_cmd.build_tables(conf, (HPV16_K,), torch.device("cpu"))
    cpu_s, cpu_laps = time.perf_counter() - t0, tb_cpu.setup_s
    if not torch.equal(tb.comb_table.cpu(), tb_cpu.comb_table):
        raise AssertionError("the device-built hpv16 table differs from the CPU build")
    t0 = time.perf_counter()
    host = lookup.build_set_table(hpv16_cmd._host_rows(h, m), num_refs=R).table
    numpy_s = time.perf_counter() - t0
    host = pack_set_table(torch.from_numpy(host.view(np.int32)).to(dev), R)
    lens = packed.lens[:HPV16_BATCH]
    x = torch.from_numpy(np.ascontiguousarray(
        packed.codes[:HPV16_BATCH, : -(-int(lens.max()) // 128) * 128])).to(dev)
    full, sk_lens = bottom_s_sketch(multi_k_window_hashes(x, [HPV16_K]),
                                    x.shape[1] - HPV16_K + 1)
    br = full[:, : engine.hpv16_compact_width(lens, x.shape[1], (HPV16_K,))]
    whole = _set_probe_cuda(br, sk_lens, tb.probe_table, T, U)
    if not torch.equal(whole, _set_probe_cuda(br, sk_lens, host, T, U)):
        raise AssertionError("K3's counts on the device table differ from the numpy table's")
    del host, tb_cpu
    stb = hpv16_cmd.build_tables(conf, (HPV16_K,), dev, tp_shards=2)
    stb_cpu = hpv16_cmd.build_tables(conf, (HPV16_K,), torch.device("cpu"), tp_shards=2)
    if not torch.equal(stb.shard_tables.cpu(), stb_cpu.shard_tables):
        raise AssertionError("the device-built tp = 2 shard stack differs from the CPU build")
    parts = [_set_probe_partial_cuda(br, sk_lens, pack_set_table(stb.shard_tables[j], stb.rps),
                                     j * stb.rps, stb.rps, T, U) for j in range(2)]
    if not torch.equal(merge_hpv16_partials(torch.stack(parts)), whole):
        raise AssertionError("merged K3 partials on the device-built shards differ from K3 on "
                             "the numpy table")
    say(f"device builds: the hpv16 table {tuple(tb.comb_table.shape)} and the tp = 2 stack "
        f"{tuple(stb.shard_tables.shape)} bit-equal to the CPU builds (the CPU's whole "
        f"build {cpu_s:.2f} s, laps {json.dumps({k: round(v, 3) for k, v in cpu_laps.items()})}); "
        f"K3 on the 512-read "
        f"batch equal on the device table and the numpy build_set_table ({numpy_s:.2f} s on "
        f"the host), and on the merged shards; set-up laps on the card: "
        f"{json.dumps({k: round(v, 4) for k, v in tb.setup_s.items()})}")
    del stb, stb_cpu

    fill = lambda: lookup.set_table_fill(*inputs, nb, S)  # noqa: E731
    t = {"ms": cuda_graph_time_ms(fill, 5), "eager_ms": cuda_time_ms(fill, 10),
         "plain_ms": cuda_time_ms(lambda: lookup.set_table_fill_plain(*inputs, nb, S), 3,
                                  warmup=1),
         "sorts_ms": cuda_time_ms(lambda: prepare(nb), 5, warmup=1),
         "bound_ms": bounds.bound_ms(4 * nb * width + bounds.tensor_bytes(*inputs[:5])
                                     + 4 * n * inputs[5].shape[1] + 4),
         "shape": {"entries": n, "buckets": nb, "slots": S, "mask_words": inputs[5].shape[1],
                   "table_bytes": 4 * nb * width},
         "max_abs_err": worst}
    t["sorts_bound_ms"] = bounds.bound_ms(bounds.tensor_bytes(h, m) + bounds.tensor_bytes(
        *inputs))
    del inputs, cases
    t["geometries"] = check_fill_geometries(dev)
    say(f"time set_table_fill (K13) on {card}: {t['ms']:.4f} ms ({t['eager_ms']:.4f} eager) "
        f"vs {t['plain_ms']:.4f} ms plain for {n} entries into [{nb}, {width}]; bound "
        f"{t['bound_ms']:.4f} ms (share {t['bound_ms'] / t['ms']:.3f}); the sorts and glue "
        f"before it {t['sorts_ms']:.4f} ms eager (bound {t['sorts_bound_ms']:.4f} ms)")
    return t


def run_device_panel_stream(dev, card: str) -> dict:
    """Phase 40b: ``stream`` over 2,048 synthetic references at s = 1000
    (2,048,000 sketch elements: ``common._panel_from_sketches`` builds the
    table on the card, K13's fill) and 2**17 reads of 150 bp, counters
    zeroed just before and read just after (K1, K13, K2); the first
    16,384 lines against the CPU plain path's (whose table is built by the
    same device build on the CPU)."""
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.commands import common, stream

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        refs, reads, _, _ = synth.write_workload(
            tmp, N_DEVICE_PANEL_READS, num_refs=N_DEVICE_PANEL_REFS,
            genome_len=DEVICE_PANEL_LEN, seed=40)
        say(f"device-build stream input: {N_DEVICE_PANEL_REFS} refs x {DEVICE_PANEL_LEN} bp "
            f"(s = 1000: {N_DEVICE_PANEL_REFS * 1000} sketch elements, the device build from "
            f"{common.DEVICE_BUILD_MIN_ELEMENTS}), {N_DEVICE_PANEL_READS} reads, made in "
            f"{time.perf_counter() - t0:.2f} s")
        cfg = dict(ref_files=[refs], ks=(12,), sketch_size=1000)
        out_gpu = os.path.join(tmp, "gpu.tsv")
        label = "stream 2,048 refs (device build)"
        e2e_s, launches = driven(
            lambda: stream.run(stream.StreamConfig(read_files=[reads], out_file=out_gpu,
                                                   device="cuda", **cfg)),
            label, ("window_hash", "set_table_fill", "panel_probe"))
        gpu = read_text(out_gpu)
        if gpu.count("\n") != N_DEVICE_PANEL_READS:
            raise AssertionError(f"{label}: {gpu.count(chr(10))} lines")
        head = head_file(reads, os.path.join(tmp, "head.fq"), N_CPU_LINES)
        out_cpu = os.path.join(tmp, "cpu.tsv")
        t0 = time.perf_counter()
        stream.run(stream.StreamConfig(read_files=[head], out_file=out_cpu, device="cpu",
                                       batch_size=512, **cfg))
        cpu_s = time.perf_counter() - t0
        require_same("".join(gpu.splitlines(keepends=True)[:N_CPU_LINES]), read_text(out_cpu),
                     label)
    res = {"e2e_s": e2e_s, "e2e_reads_per_s": N_DEVICE_PANEL_READS / e2e_s,
           "launches": launches}
    say(f"{label} on {card}: e2e {res['e2e_reads_per_s']:.1f} reads/s ({e2e_s:.2f} s, the "
        f"panel's hashing, sketching and device build and the parse included); first "
        f"{N_CPU_LINES} lines byte-identical to the CPU plain path ({cpu_s:.2f} s)")
    return res


def check_call_enum(dev, card: str, cw: dict) -> dict:
    """Phase 40c (after 22): ``parallel/mesh.ShardedCallEnum`` on a grid of
    ``(cuda:0,) * 4`` over the call workload's reference, cut as
    ``__graft_entry__.py:282-297`` cuts it (Pl = (L - k) // 4 positions a
    slice, a k-code halo), counters zeroed just before and read just after
    (K1, K8), against one device's K1 + K8 over the whole reference: the
    window depths, the substitution depths and the global max."""
    import torch

    from rkmh_tpu_torch.call_engine import positional_hashes, snp_codes
    from rkmh_tpu_torch.ops.hashing import kmer_window_hashes
    from rkmh_tpu_torch.ops.hashmap import hashmap_get
    from rkmh_tpu_torch.parallel.mesh import ShardedCallEnum, make_mesh

    k = 16
    ref = cw["codes"]
    L = ref.shape[0]
    Pl = (L - k) // GRID
    slices = torch.stack([ref[d * Pl: d * Pl + Pl + k] for d in range(GRID)]).cpu().numpy()
    enum = ShardedCallEnum(make_mesh((torch.device("cuda", 0),) * GRID, dp=GRID), cw["table"], k)
    out = {}
    seconds, launches = driven(lambda: out.update(r=enum(slices)), "call enumeration",
                               ("window_hash", "hashmap_get"))
    depth, snp, gmax = out["r"]
    P = GRID * Pl
    want_depth = hashmap_get(cw["table"], positional_hashes(ref, k))[:P]
    alt = snp_codes(ref[: P + k - 1].unfold(0, k, 1)).reshape(-1, k)
    want_snp = hashmap_get(cw["table"], kmer_window_hashes(alt, k)[:, 0]).reshape(P, k, 3)
    if not (torch.equal(depth, want_depth) and torch.equal(snp, want_snp)
            and torch.equal(gmax, want_snp.amax().repeat(GRID))):
        raise AssertionError("ShardedCallEnum on (cuda:0,) * 4 differs from one device's K1 + K8")
    say(f"call enumeration on (cuda:0,) * {GRID} ({card}): {P} positions in {GRID} slices of "
        f"{Pl}, depths [{P}], substitution depths {tuple(snp.shape)}, max {int(gmax[0])}: equal "
        f"to one device's K1 + K8 ({seconds:.3f} s)")
    return {"e2e_s": seconds, "launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to test", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "rkmh_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout holding rkmh_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rkmh_tpu_torch.io import native
    from rkmh_tpu_torch.ops import kernels

    from rkmh_tpu_torch.bench.timing import card_name_and_power_limit

    # every phase but 33 builds its panels: no cache entry may stand in for a build
    os.environ["RKMH_TPU_PANEL_CACHE"] = "0"
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = card_name_and_power_limit()
    say(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"nvidia-smi: {smi}")

    clock = PhaseClock()
    t0 = time.perf_counter()
    lib = kernels.build()
    say(f"built {lib.name} from {[p.name for p in kernels.sources()]} in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    io_lib = native.build()
    native.load()
    say(f"built {io_lib.name} from {native.SOURCE.name} with {native.CXX} "
        f"{' '.join(native.CXX_FLAGS)} in {time.perf_counter() - t0:.2f} s")
    clock.lap("1-2 start-up, builds")
    err_k1 = check_k1(dev)
    panel, genomes = zika_panel(dev)
    err_k2, (codes, hashes), k2_stats = check_k2(dev, panel, genomes)
    err_k2 = max(err_k2, check_k2_variants(dev))
    clock.lap("3-4 K1, K2 checked")
    times, bound = time_kernels(panel, codes, hashes, k2_stats)
    clock.lap("5 K1, K2 timed")
    card_smi = f"{card} ({smi})"
    # the zika slice's and the call workload's directories, and what phase 39
    # takes from phase 37, stay until phase 39 has run
    with contextlib.ExitStack() as dirs:
        work = dirs.enter_context(tempfile.TemporaryDirectory())
        keep39 = os.path.join(work, "hpv16_39")
        os.makedirs(keep39)
        zika = write_zika(work)
        check_native_io(zika)
        clock.lap("6 input written, native reader")
        sl = run_slice(dev, card_smi, panel, zika)
        profile_stream(zika)
        clock.lap("6 stream slice")
        gathers, gathers_by_n = check_gathers(dev)
        gathers["lut_gather_lanes"], k5_extra = check_k5(dev)
        gather_launches = run_gather_path()
        clock.lap("7-8 K4, K5, gather path")
        hp = run_hpv16(dev, card_smi, keep39)
        clock.lap("9-10 hpv16 (36, 37, 40a inside)")
        counters, k7_hpv16 = check_counters(dev, hashes, hp.pop("batch_hashes"))
        filt = check_k2_filter(dev, panel, hashes)
        err_partial, partial_t = check_partials(dev, panel, hashes)
        err_ranges, ranges_t = check_counter_ranges(dev, hashes)
        clock.lap("11-12, 34 K6, K7, K2 filter, partials, ranges")
        st_mi = run_stream_counters(dev, card_smi, zika)
        clock.lap("13 stream -M -I")
        fl = run_filter(dev, card_smi, zika)
        clock.lap("14 filter")
        sketches = run_ref_sketches(dev, card_smi, zika)
        clock.lap("16 sketch round trip")
        hashed = run_hash_lines(dev, card_smi, zika)
        clock.lap("17 hash")
        counted = run_count(dev, card_smi, zika)
        clock.lap("18 count")
        searched = run_search(dev, card_smi, zika, hashes)
        clock.lap("19 search")
        resumed = run_resume(dev, card_smi, zika, hashed)
        clock.lap("20 --resume")
        k1_hash = time_slice_library_calls(codes, hashes, card_smi)
        k6_count = time_k6_count_shape(dev, hashes, card_smi)
        clock.lap("17-18 K1, sort, K6 at hash/count shapes")
        run_stream_stdin(card_smi, zika)
        clock.lap("21 stream -i")
        metrics = run_metrics(zika)
        check_library(panel, hashes)
        cached = run_panel_cache(dev, card_smi, zika)
        clock.lap("29, 33 --metrics, library, panel cache")
        sharded = run_sharded_paths(dev, card_smi, zika,
                                    {"stream": sl, "stream -M -I": st_mi, "filter": fl}, hashed)
        clock.lap("35 --devices paths")
        dist = run_dist_paths(card_smi, zika, {"stream": sl, "stream -M -I": st_mi,
                                               "filter": fl})
        clock.lap("38 --dist-* stream, filter")
        hpm = run_hpv16_counter(dev, card_smi)
        clock.lap("15 hpv16 -M")
        from rkmh_tpu_torch.bench import call_inputs

        call_work = dirs.enter_context(tempfile.TemporaryDirectory())
        t0 = time.perf_counter()
        cw = call_inputs.call_workload(dev, call_work)
        cw["big_map"], cw["big_queries"] = call_inputs.big_map(dev)
        say(f"call input: 1,100 reads, map {cw['map_stats']}, a 1 Mbp reference, a map of "
            f"{cw['big_map'].n} keys ({cw['big_map'].part_bytes()}); made in "
            f"{time.perf_counter() - t0:.2f} s")
        err_k8 = check_k8(dev, cw)
        err_k9 = check_k9(dev, cw)
        err_k9_base, k9_base = check_k9_base(dev, cw)
        enum = check_call_enum(dev, card_smi, cw)
        call_times = time_call_kernels(
            cw, card_smi, codes.shape[0] * (codes.shape[1] - 11) / (times["window_hash"] / 1e3))
        clock.lap("22-23, 36, 40c call input, K8, K9, enumeration")
        called = run_call(dev, card_smi, cw)
        clock.lap("24 call")
        sharded_call = run_sharded_call(dev, card_smi, cw)
        clock.lap("37 call --devices")
        del cw["big_map"], cw["big_queries"], cw["big"]
        torch.cuda.empty_cache()  # the ranks share the card with this process
        dist_rest = run_dist_rest(card_smi, {
            "dir": work, "reads": zika["reads"], "hash_reads": hashed["reads"],
            "hash_out": hashed["out"], "hash_s": hashed["hash"]["e2e_s"],
            "hash_s_out": hashed["out -s"], "hash_s_s": hashed["hash -s 1000"]["e2e_s"],
            "count_npz": counted["npz"], "count_dump": counted["dump"],
            "count_s": counted["e2e_s"], "search_refs": searched["refs"],
            "search_out": searched["out"], "search_s": searched["e2e_s"], "hpv16": keep39,
            "call_ref": cw["ref"], "call_reads": cw["reads"],
            "call_vcf": os.path.join(call_work, "gpu.vcf"),
            "call_s": called["call"]["e2e_s"]})
        clock.lap("39 --dist-* hash, count, search, hpv16, call")
    sp = run_sp_sketch(dev, card_smi)
    clock.lap("37 sp_sketch")
    fallback, k10 = run_hpv16_fallback(dev, card_smi)
    clock.lap("25-26 hpv16 past the cap")
    err_k11, k2_sweep = check_k11(dev)
    wide, k11 = run_wide_stream(dev, card_smi)
    clock.lap("27-28 K11, 12,288 references")
    device_panel = run_device_panel_stream(dev, card_smi)
    clock.lap("40 stream over 2,048 references (the device build)")
    err_k12, k12 = check_k12(dev)
    clock.lap("30 K12")
    pipeline = run_model_pipeline(dev, card_smi)
    clock.lap("31 model pipeline")
    per_read = run_per_read_training(dev, card_smi)
    clock.lap("32 per-read training")
    paths = {"stream": sl, "hpv16": hp, "stream -M -I": st_mi, "filter": fl, "hpv16 -M": hpm,
             "hpv16 capped": hp.pop("capped"), "hpv16 fallback": fallback,
             "hpv16 -M fallback": k10.pop("m"), "stream 12,288 refs": wide,
             **{k: v for k, v in sketches.items() if k != "setup_s"},
             **{k: v for k, v in hashed.items() if k.startswith("hash")},
             "count": counted, "search": searched, **resumed, **called,
             **{k: {"launches": v} for k, v in {**pipeline, **per_read}.items()
                if k not in ("accuracy", "stats")},
             **{k: {"launches": v} for k, v in cached.items() if k != "setup_s"},
             **sharded, "stream 12,288 refs --devices 4 --tp 2": wide.pop("sharded"),
             **hp.pop("sharded"), **sharded_call, **sp, **dist, **dist_rest,
             "stream 2,048 refs (device build)": device_panel, "call enumeration": enum}
    by_range = {name: sum(r["launches"].get("by_range", {}).get(name, 0) for r in paths.values())
                for name in ("counter_add", "counter_mask")}

    def launched(name):
        return sum(r["launches"].get(name, 0) for r in paths.values())

    def entry(name, source, replaces, err, ms, eager_ms, plain_ms, bound_ms, library_ms=None,
              launches=None):
        by_path = {p: r["launches"][name] for p, r in paths.items()
                   if r["launches"].get(name, 0)}
        return {"name": name, "route": "cuda", "source": f"rkmh_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": launched(name) if launches is None else launches,
                "launches_by_path": by_path if launches is None else {"gather": launches},
                "max_abs_err": err, "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                **bound_fields(ms, bound_ms, library_ms)}

    def gather_entry(name, line, **extra):
        err, ms, plain_ms, library_ms, bound_ms, eager_ms = gathers[name]
        return {**entry(name, "lut_gather.cu", f"scripts/bench_gather.py:{line}", err, ms,
                        eager_ms, plain_ms, bound_ms, library_ms, gather_launches[name]),
                **extra}

    def counter_entry(name, line, **extra):
        err, ms, plain_ms, bound_ms, eager_ms = counters[name]
        return {**entry(name, "counter.cu", f"rkmh_tpu/ops/counter.py:{line}", err, ms,
                        eager_ms, plain_ms, bound_ms),
                "launches_by_range": by_range[name],
                "range": {**ranges_t[name], "max_abs_err": err_ranges[name],
                          "bound_share": ranges_t[name]["bound_ms"] / ranges_t[name]["ms"]},
                **extra}

    def k12_entry(name, replaces, way):
        t = k12[way]
        library_ms = t["library_ms"] if t["library_ms"] is not None else t["library_eager_ms"]
        return {**entry(name, "sparse_margin.cu", replaces, err_k12[way], t["ms"], t["eager_ms"],
                        t["plain_ms"], t["bound_ms"], library_ms),
                "library_graph_ms": t["library_ms"], "library_eager_ms": t["library_eager_ms"]}

    record = {"kernels": [
        {**entry("window_hash", "window_hash.cu", "rkmh_tpu/ops/pallas_hash.py:39", err_k1,
                 times["window_hash"], times["window_hash_eager"], times["window_hash_plain"],
                 bound["window_hash"]), "hash_shapes": k1_hash},
        entry("panel_probe", "panel_probe.cu", "rkmh_tpu/ops/lookup.py:321", err_k2,
              times["panel_probe"], times["panel_probe_eager"], times["panel_probe_plain"],
              bound["panel_probe"]),
        entry("panel_probe_filter", "panel_probe.cu", "rkmh_tpu/classify/engine.py:56",
              filt[0], filt[1], filt[3], filt[2], bound["panel_probe_filter"]),
        {**entry("set_probe", "set_probe.cu", "rkmh_tpu/classify/engine.py:794", hp["err_k3"],
                 hp["set_probe"], hp["set_probe_eager"], hp["set_probe_plain"],
                 hp["set_probe_bound"]),
         "launches_by_route": {"whole": launched("set_probe"),
                               "partial": launched("set_probe_partial")}},
        {**entry("set_probe_partial", "set_probe.cu", "rkmh_tpu/parallel/mesh.py:369",
                 hp["err_partial"], hp["partial_t"]["ms"], hp["partial_t"]["eager_ms"],
                 hp["partial_t"]["plain_ms"], hp["partial_t"]["bound_ms"]),
         **{key: hp["partial_t"][key] for key in ("whole_ms", "shape", "shard_columns",
                                                  "reads_by_segments")}},
        gather_entry("lut_gather_rows", 109, launches_by_route=gather_launches[
            "lut_gather_rows_by_route"], by_n=gathers_by_n),
        gather_entry("lut_gather_lanes", 140, launches_by_route=gather_launches[
            "lut_gather_lanes_by_route"], **k5_extra),
        counter_entry("counter_add", 37, count_shape=k6_count),
        counter_entry("counter_mask", 46, hpv16_m_shape=k7_hpv16),
        {**entry("hashmap_get", "hashmap.cu", "rkmh_tpu/ops/hashmap.py:159", err_k8,
                 call_times["k8_scan"]["ms"], call_times["k8_scan"]["eager_ms"],
                 call_times["k8_scan"]["plain_ms"], call_times["k8_scan"]["bound_ms"],
                 call_times["k8_scan"]["library_ms"]), "at_2e20": call_times["k8_2e20"],
         "at_large_map": call_times["k8_large_map"]},
        {**entry("call_scan", "call_scan.cu", "rkmh_tpu/call_engine.py:54", err_k9,
                 call_times["k9_call"]["ms"], call_times["k9_call"]["eager_ms"],
                 call_times["k9_call"]["plain_ms"], call_times["k9_call"]["bound_ms"]),
         "launches_by_route": {p: r.get("k9_routes", {}) for p, r in paths.items()
                               if r.get("k9_routes")},
         "base_mode": {**k9_base, "max_abs_err": err_k9_base},
         "mutated_kmers_per_s": call_times["k9_call"]["mutated_kmers_per_s"],
         "bytewise_route": call_times["k9_call_bytewise"], "at_1mbp": call_times["k9_1mbp"]},
        entry("sorted_probe", "set_probe.cu", "rkmh_tpu/classify/engine.py:829", k10["err"],
              k10["ms"], k10["eager_ms"], k10["plain_ms"], k10["bound_ms"], k10["library_ms"]),
        {**entry("panel_probe_partial", "panel_probe.cu", "rkmh_tpu/parallel/mesh.py:157",
                 err_partial, partial_t["ms"], partial_t["eager_ms"], partial_t["plain_ms"],
                 partial_t["bound_ms"]),
         **{key: partial_t[key] for key in ("shape", "shard_refs", "runs_ms", "whole_ms",
                                            "whole_runs_ms", "s2_stream")}},
        {**entry("panel_probe_wide", "panel_probe.cu", "rkmh_tpu/ops/lookup.py:341", err_k11,
                 k11["raw"]["ms"], k11["raw"]["eager_ms"], k11["raw"]["plain_ms"],
                 k11["raw"]["bound_ms"]),
         "k2_at_8192_ms": k11["raw"]["k2_8192_ms"], "sorted_rows": k11["sorted"],
         "beside_k2": k2_sweep},
        {**k12_entry("sparse_margin", "rkmh_tpu/ml/wabbit.py:171", "forward"),
         "forward_and_backward": k12["both"], "pipeline_both_ms": k12["pipeline_both_ms"],
         "per_read_training": per_read["stats"], "pipeline_accuracy": pipeline["accuracy"]},
        {**k12_entry("sparse_margin_grad", "rkmh_tpu/ml/wabbit.py:195", "backward"),
         "plan_ms": k12["plan_ms"], "plan": k12["plan"]},
        {**entry("set_table_fill", "set_table.cu", "rkmh_tpu/ops/lookup.py:489",
                 hp["k13"]["max_abs_err"], hp["k13"]["ms"], hp["k13"]["eager_ms"],
                 hp["k13"]["plain_ms"], hp["k13"]["bound_ms"]),
         **{key: hp["k13"][key] for key in ("sorts_ms", "sorts_bound_ms", "shape",
                                            "geometries")}},
    ]}
    say(f"stream --metrics and the profile hook: {json.dumps(metrics)}")
    say(f"panel cache set-up seconds: {json.dumps(cached['setup_s'])}")
    clock.report()
    say(smi)
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank-worker"]:
        sys.exit(dist_rank_worker(sys.argv[2]))
    sys.exit(main())
