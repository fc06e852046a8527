"""Inputs of K10 and K11 at the shapes their paths give them, for
``bench/probe_ab.sh``, made once and saved so that two checkouts time
their kernels on the same arrays.

* K10: the first 512 reads of hpv16's fallback workload past the
  set-table cap (``synth.write_hpv16_workload``: 640 type genomes, 12,800
  nanopore-like reads, k = 18), sorted and cut as the hpv16 step cuts
  them, and the sorted-key panel's keys (uint64) and masks (uint32) as
  ``hpv16_cmd.build_tables`` builds them;
* K11: the logical table of 12,288 synthetic references of 1,000 bp
  (k = 12, s = 32; ``synth.write_workload``, seed 28) and the raw window
  hashes of the first 16,384 of its 2**18 reads.

These are the inputs of ``chip_smoke.py``'s phases 25 and 28.  Needs a
CUDA card (the tables are built as the paths build them, on the card).

    python -m rkmh_tpu_torch.bench.probe_inputs OUT_DIR   # k10.npz, k11.npz
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from rkmh_tpu_torch import synth
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands import hpv16_cmd
from rkmh_tpu_torch.commands.common import load_packed
from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
from rkmh_tpu_torch.ops.lookup import build_panel_table
from rkmh_tpu_torch.ops.sketch import INT64_MIN, bottom_s_sketch

HPV16_READS, HPV16_TYPES, HPV16_K, HPV16_BATCH = 12800, 640, 18, 512
WIDE_REFS, WIDE_REF_LEN, WIDE_SKETCH, WIDE_READS, WIDE_BATCH = 12288, 1000, 32, 1 << 18, 16384


def k10_inputs(dev, tmp: str) -> dict:
    reads, _ = synth.write_hpv16_workload(tmp, HPV16_READS, num_types=HPV16_TYPES)
    tb = hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(refpath=tmp, ks=(HPV16_K,),
                                                      tst_file=False), (HPV16_K,), dev)
    packed = load_packed([reads])
    lens = packed.lens[:HPV16_BATCH]
    codes = packed.codes[:HPV16_BATCH, : -(-int(lens.max()) // 128) * 128]
    x = torch.from_numpy(codes).to(dev)
    hashes = multi_k_window_hashes(x, [HPV16_K])
    full, sk_lens = bottom_s_sketch(hashes, hashes.shape[-1])
    Wc = engine.hpv16_compact_width(lens, x.shape[1], (HPV16_K,))
    panel = tb.comb_sorted
    return {"rows": full[:, :Wc].cpu().numpy(), "lens": sk_lens.cpu().numpy(),
            "keys": (panel.keys ^ INT64_MIN).cpu().numpy().view(np.uint64),
            "masks": panel.masks.cpu().numpy().view(np.uint32),
            "T": len(tb.type_names), "U": tb.n_lin + tb.n_sub}


def k11_inputs(dev, tmp: str) -> dict:
    refs, reads, _, _ = synth.write_workload(tmp, WIDE_READS, num_refs=WIDE_REFS,
                                             genome_len=WIDE_REF_LEN, seed=28)
    ref_packed = load_packed([refs])
    ref_sk, ref_lens = engine.sketch_batch(torch.from_numpy(ref_packed.codes).to(dev), (12,),
                                           WIDE_SKETCH)
    table = build_panel_table(ref_sk.cpu().numpy(), ref_lens.cpu().numpy()).table
    packed = load_packed([reads])
    raw = multi_k_window_hashes(torch.from_numpy(packed.codes[:WIDE_BATCH]).to(dev), (12,))
    return {"table": table.view(np.int32), "raw": raw.cpu().numpy(), "R": WIDE_REFS}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m rkmh_tpu_torch.bench.probe_inputs OUT_DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_inputs: needs a CUDA device", file=sys.stderr)
        return 1
    out = argv[0]
    os.makedirs(out, exist_ok=True)
    dev = torch.device("cuda")
    for name, make in (("k10", k10_inputs), ("k11", k11_inputs)):
        with tempfile.TemporaryDirectory() as tmp:
            np.savez(os.path.join(out, f"{name}.npz"), **make(dev, tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
