#!/usr/bin/env bash
# K10 (hpv16's sorted probe) and K11 (the panel probe past 8,192
# references) on another checkout against this one, in turns in one call:
# other, this, this, other, other, this.  For checkouts whose K10 and K11
# differ in their tables' layouts (the entry points differ, so
# bench/kernel_ab.py cannot load one beside the other): each run builds its
# own checkout's kernels and its own layouts from the same arrays, made
# once by this checkout (bench/probe_inputs.py: the 512-read batch of the
# 640-type panel past the set-table cap; 16,384 reads against 12,288
# references, raw rows and their s = 32 sketches), through the names both
# keep (convert.sorted_panel_from_numpy, sorted_probe._sorted_probe_cuda,
# probe._panel_probe_cuda; probe.device_table where the checkout has it).
# Needs one CUDA card and nvcc.
#
#     bash rkmh_tpu_torch/bench/probe_ab.sh OTHER_CHECKOUT
#
# from the root of this checkout; OTHER_CHECKOUT holds rkmh_tpu_torch/ of
# the other version (for example `git archive REV | tar -x -C DIR`).  Each
# run checks its kernels against its plain versions and prints one JSON
# line: device ms by CUDA-graph replay and eagerly, the tables' bytes on
# the card and the outputs' sha256.  The last lines give each version's
# best of its three runs and whether both gave the same outputs.
set -eo pipefail
ROOT=$PWD
OTHER=$(cd "$1" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
D=$(mktemp -d)
trap 'rm -rf "$D"' EXIT
python -m rkmh_tpu_torch.bench.probe_inputs "$D"
CODE=$(cat <<'PY'
import hashlib, json, sys
import numpy as np
import torch
from rkmh_tpu_torch import convert
from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
from rkmh_tpu_torch.ops import probe, sorted_probe
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

dev = torch.device("cuda")
res = {"label": sys.argv[1]}
digest = hashlib.sha256()

def timed(key, fn, graph_iters, eager_iters):
    res[key] = {"ms": cuda_graph_time_ms(fn, graph_iters),
                "eager_ms": cuda_time_ms(fn, eager_iters)}

z = np.load(f"{sys.argv[2]}/k10.npz")
rows, lens = torch.from_numpy(z["rows"]).to(dev), torch.from_numpy(z["lens"]).to(dev)
T, U = int(z["T"]), int(z["U"])
panel = convert.sorted_panel_from_numpy(z["keys"], z["masks"], dev)
res["k10_panel_bytes"] = panel.nbytes
got = sorted_probe._sorted_probe_cuda(rows, lens, panel, T, U)
assert torch.equal(got, sorted_probe.sorted_probe_plain(rows, lens, panel, T, U)), "K10"
digest.update(got.cpu().numpy().tobytes())
timed("k10", lambda: sorted_probe._sorted_probe_cuda(rows, lens, panel, T, U), 10, 20)
del panel

z = np.load(f"{sys.argv[2]}/k11.npz")
R, raw = int(z["R"]), torch.from_numpy(z["raw"]).to(dev)
logical = torch.from_numpy(z["table"]).to(dev)
pack = getattr(probe, "device_table", None)
table = pack(z["table"], R, dev) if pack else logical
res["k11_table_bytes"] = table.nbytes
for mode, r, ln in (("raw", raw, None), ("sorted", *bottom_s_sketch(raw, 32))):
    got = probe._panel_probe_cuda(r, ln, table, R, 0, -1)
    assert torch.equal(got, probe.panel_probe_plain(r, ln, logical, R, 0, -1)), f"K11 {mode}"
    digest.update(got.cpu().numpy().tobytes())
    timed(f"k11_{mode}", lambda: probe._panel_probe_cuda(r, ln, table, R, 0, -1), 5, 10)
res["sha256"] = digest.hexdigest()
print(json.dumps(res))
PY
)
run() {  # checkout, label, output
  (cd "$1" && python -c "$CODE" "$2" "$D") | tee "$3"
}
run "$OTHER" other "$D/other.1.json"
run "$ROOT" this "$D/this.1.json"
run "$ROOT" this "$D/this.2.json"
run "$OTHER" other "$D/other.2.json"
run "$OTHER" other "$D/other.3.json"
run "$ROOT" this "$D/this.3.json"
python - "$D" <<'PY'
import json, sys
runs = {n: [json.loads(open(f"{sys.argv[1]}/{n}.{i}.json").read().splitlines()[-1])
            for i in (1, 2, 3)] for n in ("other", "this")}
for n, rs in runs.items():
    best = {k: {t: min(r[k][t] for r in rs) for t in ("ms", "eager_ms")}
            for k in ("k10", "k11_raw", "k11_sorted")}
    print(json.dumps({"best_of_3": n, **best, "k10_panel_bytes": rs[0]["k10_panel_bytes"],
                      "k11_table_bytes": rs[0]["k11_table_bytes"]}))
shas = {r["sha256"] for rs in runs.values() for r in rs}
print("same outputs" if len(shas) == 1 else "outputs differ")
PY
