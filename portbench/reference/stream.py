"""rkmh ``stream`` (rkmh.cpp:820-893), with -M and -I, in plain PyTorch.

Each reference's sketch is the bottom ``s`` of its valid k-mer hashes in
unsigned order, repeats kept; with -I (``max_samples``) only the hashes
whose slot in a ``hash % counter_size`` counter of every panel window
holds at most max_samples enter it.  A read's sketch is made the same way
from its hashes; with -M (``min_kmer_occ``) the hashes whose slot in a
counter of every read window (invalid k-mers, hash 0, included) holds
fewer than min_kmer_occ are dropped first.  A read shares with a
reference the size of the multiset intersection of their sketches; the
first reference with the most wins.  The output line is

    ref \\t read \\t shared \\t s[FAIL:DEPTH] \\t [FAIL:MATCHES] \\t [FAIL:DIFF]
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.reference.kmers import hash_rows, read_fastx
from portbench.reference.match import Entries, count_of, row_runs, slot_counts, unsigned_sort

SENT = -1  # all ones: sorts last as uint64


def _sketch(h: torch.Tensor, keep: torch.Tensor, s: int):
    """Bottom-s of the kept nonzero hashes of each row -> ([n, min(s, W)]
    sorted, SENT-padded; [n] lengths)."""
    x = unsigned_sort(torch.where(keep & (h != 0), h, torch.full_like(h, SENT)))
    x = x[:, : min(s, x.shape[1])]
    return x, (x != SENT).sum(1)


def _counter(files_codes, k: int, size: int, device, **hash_kw):
    """slot_counts over every existing window of the given code rows."""
    parts = []
    for codes, lens in files_codes:
        for _, h, exists in hash_rows(codes, lens, k, device, **hash_kw):
            parts.append(h[exists])
    return slot_counts(torch.cat(parts), size)


def expected(inputs: dict, cfg: dict, traffic: dict, device, **hash_kw):
    """-> (the output text, the least bytes of one job's device work)."""
    flags = traffic["flags"]
    (k,) = flags["ks"]
    s = flags["sketch_size"]
    size = cfg["counter_size"]
    min_occ = flags.get("min_kmer_occ", -1)
    max_samples = flags.get("max_samples")
    min_diff, min_matches = flags.get("min_diff", 0), flags.get("min_matches", -1)

    ref_names, rc, rl = read_fastx(inputs["refs"])
    rtab = (_counter([(rc, rl)], k, size, device, **hash_kw)
            if max_samples is not None else None)
    sk_rows = []
    for _, h, exists in hash_rows(rc, rl, k, device, **hash_kw):
        keep = exists if rtab is None else exists & (count_of(h, size, rtab) <= max_samples)
        sk_rows.append(_sketch(h, keep, s)[0])
    sk = torch.cat(sk_rows)
    r_idx = torch.arange(sk.shape[0], device=device)[:, None].expand_as(sk)
    ok = sk != SENT
    er, ev, em = row_runs(r_idx[ok], sk[ok])
    panel = Entries(ev, er, em)
    R = len(ref_names)

    names, codes, lens = read_fastx(inputs["reads"])
    mtab = _counter([(codes, lens)], k, size, device, **hash_kw) if min_occ >= 0 else None
    best_all, shared_all, flags_all = [], [], []
    found = torch.zeros(panel.vals.numel(), dtype=torch.bool, device=device)
    for r0, h, exists in hash_rows(codes, lens, k, device, **hash_kw):
        keep = exists if mtab is None else exists & (count_of(h, size, mtab) >= min_occ)
        x, sk_len = _sketch(h, keep, s)
        n = x.shape[0]
        rows = torch.arange(n, device=device)[:, None].expand_as(x)
        ok = x != SENT
        qr, qv, qm = row_runs(rows[ok], x[ok])
        qi, ei = panel.hits(qv)
        found[ei] = True
        counts = torch.zeros(n * R, dtype=torch.int64, device=device)
        counts.index_add_(0, qr[qi] * R + panel.cols[ei],
                          torch.minimum(qm[qi], panel.weights[ei]))
        counts = counts.view(n, R)
        mx, best = counts.max(1)  # the first maximal reference
        before = torch.where(torch.arange(R, device=device)[None, :] < best[:, None],
                             counts, torch.full_like(counts, -1)).amax(1)
        fl = (((mx - before) > min_diff).to(torch.int64)
              | ((sk_len <= min_matches).to(torch.int64) << 1)
              | ((mx < min_matches).to(torch.int64) << 2))
        best_all.append(best.cpu())
        shared_all.append(mx.cpu())
        flags_all.append(fl.cpu())
    best = torch.cat(best_all).tolist()
    shared = torch.cat(shared_all).tolist()
    fl = torch.cat(flags_all).tolist()
    tails = [f"\t{s}{'FAIL:DEPTH' if f & 2 else ''}\t{'FAIL:MATCHES' if f & 4 else ''}\t"
             f"{'' if f & 1 else 'FAIL:DIFF'}\n" for f in range(8)]
    text = "".join([f"{ref_names[b]}\t{nm}\t{c}{tails[f]}"
                    for b, nm, c, f in zip(best, names, shared, fl)])

    bases = int(lens.sum())
    entries = int(torch.unique(panel.vals[found]).numel())
    slots_touched = int(mtab[0].numel()) if mtab is not None else 0
    nbytes = work.stream_bytes(bases, entries, R, len(names), slots_touched)
    return text, nbytes
