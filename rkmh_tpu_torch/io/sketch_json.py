"""Mash/sourmash-style JSON sketch files: write and load.

A copy of ``rkmh_tpu/io/sketch_json.py`` (``SketchRecord``,
``dump_sketches`` :32, ``dump_sourmash`` :55, ``_from_sourmash`` :98,
``_from_mash_dump`` :137, ``load_sketches`` :168), whose files it writes
byte for byte and reads as it does: the rkmh ``dump_hashes`` array, a
``sourmash_signature`` file or a ``mash info -d`` dump, told apart per
entry.  Hashes are unsigned Python ints here, sorted ascending as uint64.
``panel_from_sketches`` (:213 there) builds the port's own ``RefPanel`` on
a torch device, with the hashes as int64 bit patterns.

Schema note (as in rkmh-tpu): rkmh's ``dump_hashes`` writes "canonical":
"false" while the hashes are canonical; "true" is written and either is
accepted on load.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np
import torch

from rkmh_tpu_torch.commands.common import RefPanel
from rkmh_tpu_torch.ops.lookup import build_panel_table
from rkmh_tpu_torch.ops.probe import device_table
from rkmh_tpu_torch.ops.sketch import SENTINEL


@dataclass
class SketchRecord:
    name: str
    hashes: list[int]          # sorted ascending, zeros excluded
    ks: list[int]
    sketch_size: int
    seq_len: int = 0


def dump_sketches(records: list[SketchRecord], fh) -> None:
    """Write the rkmh dump_hashes JSON array schema (rkmh.cpp:527-550)."""
    arr = []
    for r in records:
        arr.append(
            {
                "name": r.name,
                "alphabet": "ATGC",
                "canonical": "true",
                "hashBits": 64,
                "hash_type": "MurmurHash3_x64_128",
                "hash_seed": 42,
                "seqLen": r.seq_len,
                "sketches": [int(h) for h in r.hashes],
                "length": r.sketch_size,
                "kmer": [int(k) for k in r.ks],
                "preserveCase": "false",
            }
        )
    json.dump(arr, fh, indent=1)
    fh.write("\n")


def dump_sourmash(records: list[SketchRecord], fh) -> None:
    """Write sketches as a ``sourmash_signature`` JSON file (one
    signature object per record, sourmash's documented on-disk format)
    so rkmh-tpu sketches feed straight into `sourmash search/gather`.

    The md5sum follows sourmash's recipe (md5 over str(ksize) then each
    min in order).  Multi-k rkmh sketches interleave hashes from every
    k in one bottom-s set and cannot be split back per k, so they are
    refused — re-sketch with a single -k for sourmash export."""
    arr = []
    for r in records:
        if len(r.ks) != 1:
            raise ValueError(
                f"record {r.name!r} is a multi-k sketch {r.ks}; sourmash "
                "signatures carry one ksize — re-sketch with a single -k")
        md5 = hashlib.md5()
        md5.update(str(int(r.ks[0])).encode())
        for m in r.hashes:
            md5.update(str(int(m)).encode())
        arr.append({
            "class": "sourmash_signature",
            "email": "",
            "hash_function": "0.murmur64",
            "filename": "",
            "name": r.name,
            "license": "CC0",
            "signatures": [{
                "ksize": int(r.ks[0]),
                "max_hash": 0,
                "md5sum": md5.hexdigest(),
                "mins": [int(h) for h in r.hashes],
                "molecule": "dna",
                "num": int(r.sketch_size),
                "seed": 42,
            }],
            "version": 0.4,
        })
    json.dump(arr, fh, indent=1)
    fh.write("\n")


def _from_sourmash(sig) -> list[SketchRecord]:
    """One ``sourmash_signature`` JSON object -> SketchRecords.

    sourmash's DNA hashing ("0.murmur64") is exactly rkmh's scheme:
    MurmurHash3_x64_128 low 64 bits, seed 42, over min(kmer, revcomp) —
    so `mins` interop directly at a matching k.  Signatures with a
    different hash function, seed, or molecule are refused loudly
    rather than silently misclassified.  Scaled signatures (num=0,
    max_hash>0) load with sketch_size = len(mins): every retained hash
    participates, which is the closest bottom-s reading of a scaled
    sketch."""
    hf = str(sig.get("hash_function", "0.murmur64"))
    if not hf.endswith("murmur64"):
        raise ValueError(
            f"sourmash signature hash_function {hf!r} is not murmur64 "
            "(rkmh-compatible hashing is MurmurHash3_x64_128/64-bit)")
    name = sig.get("name") or sig.get("filename", "")
    out = []
    for s in sig.get("signatures", []):
        mol = str(s.get("molecule", "dna")).lower()
        if mol != "dna":
            raise ValueError(
                f"sourmash signature molecule {mol!r} unsupported (rkmh "
                "sketches DNA only)")
        seed = int(s.get("seed", 42))
        if seed != 42:
            raise ValueError(
                f"sourmash signature seed {seed} != 42 (rkmh.cpp seed)")
        mins = sorted(int(m) for m in s.get("mins", []))
        num = int(s.get("num") or 0)
        out.append(SketchRecord(
            name=name,
            hashes=mins,
            ks=[int(s.get("ksize", 0))],
            sketch_size=num or len(mins),
        ))
    return out


def _from_mash_dump(j) -> list[SketchRecord]:
    """A ``mash info -d`` dump: one top-level header (kmer / hashSeed /
    hashType / ...) plus per-record ``{"name", "length", "hashes"}``
    entries — the very schema rkmh's dump_hash_json mirrors per record
    (rkmh.cpp:489-525).  Mash emits 32-bit hashes for small k
    (hashBits 32); those cannot match 64-bit panels, so they are
    refused loudly."""
    seed = int(j.get("hashSeed", 42))
    if seed != 42:
        raise ValueError(f"mash dump hashSeed {seed} != 42 (rkmh.cpp seed)")
    bits = int(j.get("hashBits", 64))
    if bits != 64:
        raise ValueError(
            f"mash dump hashBits {bits} != 64 — re-sketch with a k large "
            "enough for 64-bit hashes (mash -k >= 17) or use rkmh-tpu hash")
    ks = j.get("kmer", [])
    if isinstance(ks, (int, float)):
        ks = [int(ks)]
    out = []
    for e in j.get("sketches", []):
        hashes = sorted(int(h) for h in e.get("hashes", []))
        out.append(SketchRecord(
            name=e.get("name", ""),
            hashes=hashes,
            ks=[int(k) for k in ks],
            sketch_size=int(e.get("length", len(hashes)) or len(hashes)),
            seq_len=int(e.get("seqLen", 0)),
        ))
    return out


def load_sketches(fh) -> list[SketchRecord]:
    """Load sketches from any of three JSON schemas, auto-detected per
    entry: the rkmh dump_hashes array (dump_sketches above), a
    ``sourmash_signature`` file, or a ``mash info -d`` dump.

    Implements what rkmh's load_hashes stubs out (rkmh.cpp:552-582),
    plus the external-consumer interop the reference only declares
    (README.md:13 "compatible with existing JSON output from Mash and
    sourmash").
    """
    data = json.load(fh)
    if isinstance(data, dict):
        data = [data]
    out = []
    for j in data:
        if j.get("class") == "sourmash_signature":
            out.extend(_from_sourmash(j))
            continue
        hashes = j.get("sketches", [])
        if hashes and isinstance(hashes, list) and isinstance(hashes[0], dict):
            out.extend(_from_mash_dump(j))  # mash info -d top-level dump
            continue
        length = j.get("length")
        # tolerate the dump_hash_json nested form {"name","length","hashes"}
        if isinstance(hashes, dict):
            if length is None:
                length = hashes.get("length")
            hashes = hashes.get("hashes", [])
        ks = j.get("kmer", [])
        if isinstance(ks, str):  # dump_hash_json writes "12 16"-style strings
            ks = [int(x) for x in ks.split()]
        if isinstance(ks, int):
            ks = [ks]
        out.append(
            SketchRecord(
                name=j.get("name", ""),
                hashes=sorted(int(h) for h in hashes),
                ks=[int(k) for k in ks],
                sketch_size=int(length if length is not None else len(hashes)),
                seq_len=int(j.get("seqLen", 0)),
            )
        )
    return out


def panel_from_sketches(records: list[SketchRecord], sketch_size: int | None,
                        device) -> RefPanel:
    """Loaded sketches -> the RefPanel the hashing path builds, on
    ``device``, so that `stream --ref-sketches panel.json` skips reference
    hashing: each record's hashes cut to ``sketch_size`` (None or 0: the
    longest record's length), SENTINEL-padded, as int64 bit patterns; the
    keys are the records' names."""
    s = sketch_size or max((len(r.hashes) for r in records), default=1)
    sk = np.full((len(records), s), SENTINEL, dtype=np.int64)
    lens = np.zeros((len(records),), dtype=np.int32)
    for i, r in enumerate(records):
        h = np.asarray(r.hashes[:s], dtype=np.uint64).view(np.int64)
        sk[i, : len(h)] = h
        lens[i] = len(h)
    table = build_panel_table(sk, lens).table.view(np.int32)
    return RefPanel([r.name for r in records], torch.from_numpy(sk).to(device),
                    torch.from_numpy(lens).to(device),
                    device_table(table, len(records), device))
