#!/usr/bin/env bash
# call's kernels and end-to-end seconds on another checkout against this
# one, in turns in one call: other, this, this, other.  For checkouts whose
# depth maps differ in layout (the kernels' entry points differ, so
# bench/kernel_ab.py cannot load one beside the other): each run uses its
# own checkout's modules through the names both keep (call_inputs,
# hashmap._hashmap_get_cuda, call_engine._call_scan_cuda, call_cmd.run).
# Needs one CUDA card and nvcc.
#
#     bash rkmh_tpu_torch/bench/call_ab.sh OTHER_CHECKOUT
#
# from the root of this checkout; OTHER_CHECKOUT holds rkmh_tpu_torch/ of
# the other version (for example `git archive REV | tar -x -C DIR`).  Each
# run prints one JSON line: K8 at the scan's shape and at 2**20 read hashes,
# K9 on the call workload and at 1 Mbp (device ms, CUDA-graph replay), and
# `call` on the workload three times (e2e and phase seconds) with the VCF's
# sha256 (its ##reference line, a temporary path, left out).  The last
# line says whether both versions wrote the same VCF.
set -e
ROOT=$PWD
OTHER=$(cd "$1" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
D=$(mktemp -d)
trap 'rm -rf "$D"' EXIT
CODE=$(cat <<'PY'
import hashlib, json, sys, tempfile, time
import torch
from rkmh_tpu_torch import call_engine
from rkmh_tpu_torch.bench import call_inputs
from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms
from rkmh_tpu_torch.commands import call_cmd
from rkmh_tpu_torch.ops import hashmap

dev, k = torch.device("cuda"), call_inputs.CALL_K
res = {"label": sys.argv[1]}
with tempfile.TemporaryDirectory() as tmp:
    cw = call_inputs.call_workload(dev, tmp)
    t = cw["table"]
    pos = call_engine.positional_hashes(cw["codes"], k)
    for name, h in (("k8_scan", pos), ("k8_2e20", cw["read_hashes"])):
        res[name] = cuda_graph_time_ms(lambda: hashmap._hashmap_get_cuda(t, h), 20)
    for name, codes in (("k9_call", cw["codes"]), ("k9_1mbp", cw["big"])):
        d, a, s = call_inputs.scan_inputs(codes, t)
        res[name] = cuda_graph_time_ms(
            lambda: call_engine._call_scan_cuda(codes, t, k, d, a, s),
            5 if codes.numel() > 100_000 else 20)
    runs, vcf = [], f"{tmp}/calls.vcf"
    for _ in range(3):
        stats = {}
        t0 = time.perf_counter()
        rc = call_cmd.run(call_cmd.CallConfig(
            ref_files=[cw["ref"]], read_files=[cw["reads"]], ks=(k,), window_len=100,
            out_file=vcf, device="cuda"), stats=stats)
        seconds = time.perf_counter() - t0
        assert rc == 0
        runs.append({"e2e_s": seconds, **{n: v for n, v in stats.items() if n.endswith("_s")}})
    res["call"] = runs
    res["call_best_s"] = min(r["e2e_s"] for r in runs)
    body = [ln for ln in open(vcf, "rb") if not ln.startswith(b"##reference=")]  # a temp path
    res["vcf_sha256"] = hashlib.sha256(b"".join(body)).hexdigest()
print(json.dumps(res))
PY
)
run() {  # checkout, label
  (cd "$1" && python -c "$CODE" "$2")
}
run "$OTHER" other | tee "$D/call_ab.other.1.json"
run "$ROOT" this | tee "$D/call_ab.this.1.json"
run "$ROOT" this | tee "$D/call_ab.this.2.json"
run "$OTHER" other | tee "$D/call_ab.other.2.json"
python - "$D" <<'PY'
import json, sys
rows = [json.loads(open(f"{sys.argv[1]}/call_ab.{n}.json").read().splitlines()[-1])
        for n in ("other.1", "this.1", "this.2", "other.2")]
print("same VCF" if len({r["vcf_sha256"] for r in rows}) == 1 else "VCFs differ")
PY
