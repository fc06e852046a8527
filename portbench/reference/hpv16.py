"""rkmh ``hpv16`` (rkmh.cpp:2544-2715) in plain PyTorch.

Columns: each type genome of ``all_pave_ref.fa`` with the set of its valid
k-mer hashes; then each lineage (a sublineage name's first letter, in
sorted order) and each sublineage (its first two letters) of
``new_refs.fa`` with the nonzero hashes of its genomes that no genome of
another group of its family holds.  Per read, over the set of its nonzero
hashes: the first type sharing the most, that count over the read's
window count, and each group's shared count, the lineages and then the
sublineages each ordered by similarity (count / windows, ties in name
order), written as rkmh writes them:

    read \\t type \\t shared/windows \\t L:sim;... \\t S:sim;... \\t n;... \\t n;...
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.reference.kmers import hash_rows, read_fastx
from portbench.reference.match import Entries, row_runs


def _row_sets(codes, lens, k, device, zeros: bool = False, **hash_kw):
    """-> ([n] row, value) pairs of the distinct hashes of each row's existing
    windows (nonzero ones only unless ``zeros``), sorted by row and value."""
    rows, vals = [], []
    for r0, h, exists in hash_rows(codes, lens, k, device, **hash_kw):
        keep = exists if zeros else exists & (h != 0)
        r = torch.arange(r0, r0 + h.shape[0], device=device)[:, None].expand_as(h)
        rows.append(r[keep])
        vals.append(h[keep])
    r, v = torch.cat(rows), torch.cat(vals)
    order = torch.argsort(v)
    r, v = r[order], v[order]
    order = torch.argsort(r, stable=True)
    rr, vv, _ = row_runs(r[order], v[order])
    return rr, vv


def _family_unique(rows, vals, all_rows, all_vals, groups):
    """Per group (a list of row indices): its rows' nonzero hashes that no
    other group's rows hold (zeros included on that side) -> (column,
    value) pairs."""
    cols, out = [], []
    for g, members in enumerate(groups):
        m = torch.tensor(members, device=vals.device)
        mine = torch.isin(rows, m)
        others = torch.isin(all_rows, torch.tensor(
            [r for gg, rs in enumerate(groups) if gg != g for r in rs] or [-1],
            device=vals.device))
        v = torch.unique(vals[mine])
        v = v[~torch.isin(v, all_vals[others])]
        cols.append(torch.full_like(v, g))
        out.append(v)
    return torch.cat(cols), torch.cat(out)


def _fmt(x: float) -> str:
    return f"{x:.6g}"


def expected(inputs: dict, cfg: dict, traffic: dict, device, **hash_kw):
    """-> (the output text, the least bytes of one job's device work)."""
    (k,) = traffic["flags"]["ks"]
    refpath = inputs["refpath"]
    type_names, tc, tl = read_fastx(f"{refpath}/all_pave_ref.fa")
    sub_names, sc, sl = read_fastx(f"{refpath}/new_refs.fa")
    T = len(type_names)
    lin_names = sorted({n[0] for n in sub_names})
    sublin_names = sorted({n[:2] for n in sub_names})
    lin_groups = [[i for i, n in enumerate(sub_names) if n[0] == ln] for ln in lin_names]
    sub_groups = [[i for i, n in enumerate(sub_names) if n[:2] == sn] for sn in sublin_names]

    t_rows, t_vals = _row_sets(tc, tl, k, device, **hash_kw)
    s_rows, s_vals = _row_sets(sc, sl, k, device, **hash_kw)
    z_rows, z_vals = _row_sets(sc, sl, k, device, zeros=True, **hash_kw)
    lc, lv = _family_unique(s_rows, s_vals, z_rows, z_vals, lin_groups)
    uc, uv = _family_unique(s_rows, s_vals, z_rows, z_vals, sub_groups)
    L, U = len(lin_names), len(lin_names) + len(sublin_names)
    cols = torch.cat([t_rows, lc + T, uc + T + L])
    vals = torch.cat([t_vals, lv, uv])
    table = Entries(vals, cols, torch.ones_like(cols))
    C = T + U

    names, codes, lens = read_fastx(inputs["reads"])
    order = np.argsort(lens, kind="stable")  # hash in blocks of like lengths
    counts = torch.zeros(len(names) * C, dtype=torch.int64, device=device)
    found = torch.zeros(table.vals.numel(), dtype=torch.bool, device=device)
    step = 512
    for b0 in range(0, len(order), step):
        idx = order[b0: b0 + step]
        blk = codes[idx][:, : int(lens[idx].max())]
        r, v = _row_sets(blk, lens[idx], k, device, **hash_kw)
        qi, ei = table.hits(v)
        found[ei] = True
        read = torch.from_numpy(idx).to(device)[r[qi]]
        counts.index_add_(0, read * C + table.cols[ei], torch.ones_like(qi))
    counts = counts.view(len(names), C).cpu().numpy()
    tcounts = counts[:, :T]
    best, shared = tcounts.argmax(1), tcounts.max(1)
    hashnum = np.maximum(lens - (k - 1), 0)
    lines = []
    for i, name in enumerate(names):
        hn = int(hashnum[i])
        li, si = counts[i, T: T + L], counts[i, T + L:]
        lsim = li / hn if hn else np.zeros(L)
        ssim = si / hn if hn else np.zeros(U - L)
        lo = sorted(range(L), key=lambda x: -lsim[x])
        so = sorted(range(U - L), key=lambda x: -ssim[x])
        lines.append("\t".join([
            name, type_names[int(best[i])], f"{int(shared[i])}/{hn}",
            "".join(f"{lin_names[x]}:{_fmt(lsim[x])};" for x in lo),
            "".join(f"{sublin_names[x]}:{_fmt(ssim[x])};" for x in so),
            "".join(f"{int(li[x])};" for x in lo),
            "".join(f"{int(si[x])};" for x in so)]) + "\n")
    entries = int(torch.unique(table.vals[found]).numel())
    nbytes = work.hpv16_bytes(int(lens.sum()), entries, C, len(names), U)
    return "".join(lines), nbytes
