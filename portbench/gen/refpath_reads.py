"""``refpath_reads`` (hpv16): the refpath's all_pave_ref.fa (the type
genomes) and new_refs.fa (the sublineages), and ``reads`` nanopore-like
reads, 80% of them from the sublineages (``synth.write_hpv16_workload``)."""

from __future__ import annotations

import os

from portbench.gen import ACGTN, fasta_bytes, fastq_bytes
from portbench.gen._hpv16 import hpv16_panel, make_nanopore_reads, read_model


def write_refpath_reads(out_dir: str, cfg: dict, n_reads: int, n_rate: float,
                        seed: int) -> dict:
    """out_dir/all_pave_ref.fa, out_dir/new_refs.fa and out_dir/reads.fq, as
    synth.write_hpv16_workload."""
    os.makedirs(out_dir, exist_ok=True)
    panel = hpv16_panel(cfg, seed)
    with open(os.path.join(out_dir, "all_pave_ref.fa"), "wb") as fh:
        fh.write(fasta_bytes([f"{n} synthetic type genome" for n in panel.type_names],
                             [ACGTN[g] for g in panel.types]))
    with open(os.path.join(out_dir, "new_refs.fa"), "wb") as fh:
        fh.write(fasta_bytes([f"{n} synthetic HPV16 sublineage" for n in panel.sub_names],
                             [ACGTN[g] for g in panel.subs]))
    reads = make_nanopore_reads(n_reads, seed + 1, panel, read_model(cfg),
                                cfg["from_sublineage"], n_rate)
    path = os.path.join(out_dir, "reads.fq")
    with open(path, "wb") as fh:
        fh.write(fastq_bytes(reads))
    return {"refpath": out_dir, "reads": path, "reads_n": n_reads,
            "bases": int(sum(len(r) for r in reads))}


def write(out_dir: str, cfg: dict, traffic: dict, seed: int) -> dict:
    return write_refpath_reads(out_dir, cfg, traffic["reads"], traffic.get("n_rate", 0.0),
                               seed)
