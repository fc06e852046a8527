"""rkmh ``call`` (rkmh.cpp:1610-1904) in plain PyTorch.

The depth of a hash is the number of read windows that have it (every
existing window, invalid ones as hash 0).  Along each reference, at
position j: depth d of its k-mer, the window average a = floor of the mean
depth over positions max(0, j - w + 1)..j; where d < 0.5 a, each of the 3k
substitutions of the k-mer whose depth x has x >= 0.1 a and x > d is a SNP
call at j + p + 1, and for j > 0 each of the k single-base deletions from
the k + 1 bases before and at j whose depth x > 0.9 a is a deletion call at
j + p + 1 (p = 1..k, the deleted base).  Calls of one key aggregate: KC
their count, MD the largest x, RD the largest a, OD the largest d; the
records print in the string order of "ref \\t pos \\t . \\t REF \\t ALT"
under rkmh's header (its KD / KC and RD + OD quirks kept).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.reference.kmers import hash_rows, read_fastx, window_hashes

ROTATE = {0: (1, 3, 2), 1: (3, 2, 0), 2: (0, 1, 3), 3: (1, 2, 0)}  # rkmh.cpp:1634-1654
ACGT = "ACGTN"


def header(ref_file: str) -> str:
    return (
        "##fileformat=VCF4.2\n##source=rkmh\n"
        f"##reference={ref_file}\n"
        '##INFO=<ID=KD,Number=1,Type=Integer,Description="Number of times call for specific kmer appears">\n'
        '##INFO=<ID=MD,Number=1,Type=Integer,Description="Maximum depth found for the rescue kmer.">\n'
        '##INFO=<ID=RD,Number=1,Type=Integer,Description="Average depth in region">'
        '##INFO=<ID=OD,Number=1,Type=Integer,Description="Depth of original kmer at site before modification.">\n'
    )


def _depth(keys, cnt, h):
    at = torch.searchsorted(keys, h).clamp(max=keys.numel() - 1)
    return torch.where(keys[at] == h, cnt[at], torch.zeros_like(h)), at


def expected(inputs: dict, cfg: dict, traffic: dict, device, **hash_kw):
    """-> (the VCF text, the least bytes of one job's device work)."""
    flags = traffic["flags"]
    (k,) = flags["ks"]
    w = flags["window_len"]
    names, codes, lens = read_fastx(inputs["reads"])
    parts = [h[exists] for _, h, exists in hash_rows(codes, lens, k, device, **hash_kw)]
    keys, cnt = torch.unique(torch.cat(parts), return_counts=True)

    ref_names, rcodes, rlens = read_fastx(inputs["refs"])
    agg: dict[str, list] = {}
    found = torch.zeros(keys.numel(), dtype=torch.bool, device=device)
    positions = 0
    for name, row, n in zip(ref_names, rcodes, rlens):
        if n < k:
            continue
        row = row[:n]
        P = int(n) - k + 1
        positions += P
        r = torch.from_numpy(row).to(device)
        d, at = _depth(keys, cnt, window_hashes(r[None], k, **hash_kw)[0])
        found[at[d > 0]] = True
        cs = torch.cat([d.new_zeros(1), d.cumsum(0)])
        j = torch.arange(P, device=device)
        lo = (j - w + 1).clamp(min=0)
        avg = (cs[j + 1] - cs[lo]) // (j + 1 - lo)
        low = (d.double() < 0.5 * avg.double()).nonzero().squeeze(1)
        # the substitutions: [n_low, k, 3] mutated k-mers
        jl = low.cpu().numpy()
        base = row[jl[:, None] + np.arange(k)]                      # [n, k]
        rot = np.array([ROTATE.get(c, (4, 4, 4)) for c in range(5)], dtype=np.uint8)
        mut = np.repeat(base[:, None, None, :], k, 1).repeat(3, 2)  # [n, k, 3, k]
        ap = np.arange(k)
        mut[:, ap, :, ap] = rot[base][:, ap, :].transpose(1, 0, 2)
        snp_h = window_hashes(torch.from_numpy(mut.reshape(-1, k)).to(device), k,
                              **hash_kw)[:, 0].view(len(jl), k, 3)
        snp_d, at = _depth(keys, cnt, snp_h)
        found[at[snp_d > 0]] = True
        # the deletions: [n_low, k] k-mers of the k + 1 bases from j - 1
        jd = jl[jl > 0]
        dwin = row[jd[:, None] - 1 + np.arange(k + 1)]              # [m, k + 1]
        keep = np.ones((k, k + 1), dtype=bool)
        keep[np.arange(k), np.arange(1, k + 1)] = False
        dels = np.stack([dwin[:, keep[p]] for p in range(k)], 1)    # [m, k, k]
        del_h = window_hashes(torch.from_numpy(dels.reshape(-1, k)).to(device), k,
                              **hash_kw)[:, 0].view(len(jd), k)
        del_d, at = _depth(keys, cnt, del_h)
        found[at[del_d > 0]] = True

        a_np, d_np = avg.cpu().numpy(), d.cpu().numpy()
        snp_np, del_np = snp_d.cpu().numpy(), del_d.cpu().numpy()

        def record(key, x, jj):
            e = agg.setdefault(key, [0, 0, 0, 0])
            e[0] += 1
            e[1] = max(e[1], int(x))
            e[2] = max(e[2], int(a_np[jj]))
            e[3] = max(e[3], int(d_np[jj]))

        for i, jj in enumerate(jl):
            a, dd = float(a_np[jj]), int(d_np[jj])
            for p in range(k):
                if base[i, p] > 3:  # no substitution of a base other than ACGT
                    continue
                for t in range(3):
                    x = int(snp_np[i, p, t])
                    if x >= 0.1 * a and x > dd:
                        record(f"{name}\t{jj + p + 1}\t.\t{ACGT[base[i, p]]}"
                               f"\t{ACGT[rot[base[i, p], t]]}", x, jj)
        for i, jj in enumerate(jd):
            a = float(a_np[jj])
            for p in range(1, k + 1):
                x = int(del_np[i, p - 1])
                if x > 0.9 * a:
                    record(f"{name}\t{jj + p + 1}\t.\t{ACGT[dwin[i, p]]}\t-", x, jj)
    text = header(inputs["refs"]) + "".join(
        f"{key}\t99\tPASS\tKC={c};MD={md};RD={rd};OD={od}\n"
        for key, (c, md, rd, od) in sorted(agg.items()))
    nbytes = work.call_bytes(int(lens.sum()), int(rlens.sum()),
                             int(found.sum()), positions)
    return text, nbytes
