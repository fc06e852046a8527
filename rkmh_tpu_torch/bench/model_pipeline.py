"""The VW model pipeline on synthetic samples, as ``chip_smoke.py`` and the
tests drive it.

It is the pipeline of ``model_docker/run_models.sh`` and
``scripts/train_models.py``, on the port's own pieces:

    stream -k 18 -s 4000 (each sample against new_refs.fa's 10 sublineages)
    -> vwize -n --format stream (one VW line a sample: strain fractions)
    -> wabbit: train coinf_binary, coinf_interactions (--interactions vv),
       lineage_ect (--ect 5), sublineage_ect (--ect 11); apply with -t -p
    -> conf_mat and interpret_wabbit on the predictions.

The samples are made here from a seed: per sublineage a pool of
nanopore-like reads (``synth.make_strain_reads``) in a FASTQ file, then
single-strain and mixed samples drawn from the pools by ``make_mix``'s
machinery (``num_reads``, ``mix_name``, ``write_mix``), their truth in
their file names as ``make_mix`` encodes it (each mix in a directory of
its own, since two mixes may draw the same name).
"""

from __future__ import annotations

import io
import os

import numpy as np

from rkmh_tpu_torch import synth
from rkmh_tpu_torch.scripts import make_mix

KS, SKETCH = (18,), 4000  # run_models.sh's stream settings
SUBLINEAGES = list(synth.HPV16_SUBLINEAGES)
# (model, training file, wabbit flags), as scripts/train_models.py trains them
JOBS = (("coinf_binary", "binary", ["--binary"]),
        ("coinf_interactions", "binary", ["--binary", "--interactions", "vv"]),
        ("lineage_ect", "lineage", ["--ect", "5"]),
        ("sublineage_ect", "sublineage", ["--ect", str(len(SUBLINEAGES) + 1)]))


def write_pools(out_dir: str, panel, reads_per_strain: int, seed: int,
                mean_len: int) -> dict:
    """One FASTQ of nanopore-like reads per sublineage -> {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    pools = {}
    for i, (name, genome) in enumerate(zip(panel.sub_names, panel.subs)):
        reads = synth.make_strain_reads(genome, reads_per_strain, seed + i, mean_len=mean_len,
                                        max_len=4 * mean_len)
        pools[name] = os.path.join(out_dir, f"{name}_pool.fq")
        synth.write_fastq_records(pools[name], reads)
    return pools


def write_samples(out_dir: str, pools: dict, genome_len: int, seed: int, singles: int,
                  mixes: int, max_reads: int, tag: str) -> list:
    """``singles`` single-strain samples of each sublineage and ``mixes``
    samples of 2-3 sublineages -> [(FASTQ path, coinfected)]."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    samples = []
    for name in SUBLINEAGES:
        for j in range(singles):
            n = min(make_mix.num_reads(float(rng.uniform(3, 10)), genome_len, 1.0), max_reads)
            path = os.path.join(out_dir, f"{name}_{tag}_{j}_.fq")
            make_mix.write_mix(path, [(pools[name], n)], rng)
            samples.append((path, 0))
    for j in range(mixes):
        k = int(rng.integers(2, 4))
        strains = [str(s) for s in rng.choice(SUBLINEAGES, size=k, replace=False)]
        props = [round(float(p), 2) for p in rng.dirichlet(np.ones(k) * 1.5)]
        cov = int(rng.integers(4, 12))
        parts = [(pools[s], min(make_mix.num_reads(cov, genome_len, p), max_reads // k))
                 for s, p in zip(strains, props)]
        sample_dir = os.path.join(out_dir, f"{tag}{j}")  # mix names may repeat
        os.makedirs(sample_dir)
        path = os.path.join(sample_dir, make_mix.mix_name(cov, strains, props,
                                                          sum(n for _, n in parts)))
        make_mix.write_mix(path, parts, rng)
        samples.append((path, 1))
    return samples


def classify_samples(samples, refs: str, device) -> list:
    """The port's ``stream -k 18 -s 4000`` on each sample, its lines written
    beside it (``.rk``) -> the paths."""
    from rkmh_tpu_torch.commands.stream import StreamConfig, run

    out = []
    for fq, _ in samples:
        path = fq[:-3] + ".rk"
        with open(path, "w") as fh:
            if run(StreamConfig(ref_files=[refs], read_files=[fq], ks=KS, sketch_size=SKETCH,
                                device=str(device)), out=fh) != 0:
                raise RuntimeError(f"stream failed on {fq}")
        out.append(path)
    return out


def write_vw_files(cls_files, coinfs, out_dir: str, tag: str, vwize_main=None) -> dict:
    """vwize -n --format stream over the classified samples, as
    train_models.py runs it: -> {"binary", "lineage" (-M: A-D + coinfected
    = 1-5), "sublineage" (-P: A1-D3 + coinfected = 1-11)}: paths."""
    if vwize_main is None:
        from rkmh_tpu_torch.scripts.vwize import main as vwize_main
    submap = os.path.join(out_dir, "sublineage_classes.tsv")
    with open(submap, "w") as fh:
        for i, name in enumerate(SUBLINEAGES + ["coinfected"]):
            fh.write(f"{name}\t{i + 1}\n")
    files = {}
    for kind, extra in (("binary", []), ("lineage", ["-M"]), ("sublineage", ["-P", submap])):
        buf = io.StringIO()
        argv = ["-n", "--format", "stream", "-s", *SUBLINEAGES, "-i", *cls_files,
                "-C", *map(str, coinfs), *extra]
        if vwize_main(argv=argv, stdout=buf) != 0:
            raise RuntimeError(f"vwize failed ({kind})")
        files[kind] = os.path.join(out_dir, f"{tag}_{kind}.vw")
        with open(files[kind], "w") as fh:
            fh.write(buf.getvalue())
    return files


def labels(vw_path: str) -> np.ndarray:
    """The first token of each VW line, as floats."""
    with open(vw_path) as fh:
        return np.array([float(ln.split()[0]) for ln in fh if ln.strip()])


def accuracy(kind: str, preds: list, truth: np.ndarray) -> float:
    """Share of right predictions: a binary model's margin > 0 means
    coinfected (label 1); an ect model's class id is the label."""
    got = np.array([float(p) for p in preds])
    if kind == "binary":
        return float(np.mean((got > 0) == (truth > 0)))
    return float(np.mean(got == truth))
