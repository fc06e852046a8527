#!/usr/bin/env bash
# K12 (the VW trainer's sparse margins and their gradient) of another
# checkout against this one, in turns in one call: other, this, this,
# other, other, this.  For checkouts whose K12 entry points differ (since
# the class-minor weights and the backward's plan, the kernels take Wp
# [D, Cp] and a MarginPlan; before, W [C, D] and idx, val), so
# bench/kernel_ab.py cannot load one beside the other: each run imports
# its own checkout's ops/sparse_margin and builds its kernels, on the same
# inputs, made once by this checkout (bench/margin_inputs.margin_case at
# phase 32's per-read shape, N = 4,096, F = 1,002, C = 10, D = 2**18, and
# at the pipeline's N = 180, F = 10, C = 11, as chip_smoke.py makes them).
# A checkout with the plan times its kernels as the trainer calls them:
# the weights packed once, the plan built once (its build is timed on its
# own, "plan_ms").  Needs one CUDA card and nvcc.
#
#     bash rkmh_tpu_torch/bench/margin_ab.sh OTHER_CHECKOUT
#
# from the root of this checkout; OTHER_CHECKOUT holds rkmh_tpu_torch/ of
# the other version (for example `git archive REV | tar -x -C DIR`).  Each
# run checks its kernels against the plain version (check_margins) and
# prints one JSON line: device ms by CUDA-graph replay ("ms") and eagerly
# ("eager_ms") of the forward, the backward and both, and embedding_bag's
# forward, backward and both on the same inputs (graph replay where
# the call can be captured, else null, and eager).  The last lines give
# each version's best of its three runs.
set -eo pipefail
ROOT=$PWD
OTHER=$(cd "$1" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
D=$(mktemp -d)
trap 'rm -rf "$D"' EXIT
python - "$D" <<'PY'
import sys
import numpy as np
from rkmh_tpu_torch.bench.margin_inputs import margin_case
for name, args in (("per_read", (4096, 1002, 10, 18, 30, "cpu", 0.02)),
                   ("pipeline", (180, 10, 11, 18, 21, "cpu"))):
    W, idx, val, dm = margin_case(*args)
    np.savez(f"{sys.argv[1]}/{name}.npz", W=W.numpy(), idx=idx.numpy(), val=val.numpy(),
             dm=dm.numpy())
PY
CODE=$(cat <<'PY'
import json, sys
import numpy as np
import torch
import torch.nn.functional as F
from rkmh_tpu_torch.bench.margin_inputs import check_margins
from rkmh_tpu_torch.bench.timing import cuda_graph_time_ms, cuda_time_ms
from rkmh_tpu_torch.ops import sparse_margin as sm

dev = torch.device("cuda")
res = {"label": sys.argv[1], "plan": hasattr(sm, "build_plan")}

def graph_ms(fn):
    try:
        return cuda_graph_time_ms(fn, 10)
    except RuntimeError:
        return None

for name in ("per_read", "pipeline"):
    z = np.load(f"{sys.argv[2]}/{name}.npz")
    W, idx, val, dm = (torch.from_numpy(z[k]).to(dev) for k in ("W", "idx", "val", "dm"))
    C, Dw = W.shape
    check_margins(W, idx, val, dm)
    if res["plan"]:
        Wp, plan = sm.pack_weights(W), sm.build_plan(idx, val, Dw)
        fwd = lambda: sm._margins_cuda(Wp, idx, val, C)
        bwd = lambda: sm._margins_grad_cuda(dm, plan)
        res[f"{name}_plan_ms"] = cuda_time_ms(lambda: sm.build_plan(idx, val, Dw), 5, warmup=1)
        res[f"{name}_pack_ms"] = cuda_graph_time_ms(lambda: sm.pack_weights(W), 10)
    else:
        fwd = lambda: sm._margins_cuda(W, idx, val)
        bwd = lambda: sm._margins_grad_cuda(dm, idx, val, Dw)
    for way, fn in (("forward", fwd), ("backward", bwd), ("both", lambda: (fwd(), bwd()))):
        res[f"{name}_{way}"] = {"ms": cuda_graph_time_ms(fn, 10),
                                "eager_ms": cuda_time_ms(fn, 20)}
    WT = W.T.contiguous().requires_grad_(True)
    dmT = dm.T.contiguous()
    lib_fwd = lambda: F.embedding_bag(idx, WT, per_sample_weights=val, mode="sum")
    lib_m = lib_fwd()
    lib_bwd = lambda: torch.autograd.grad(lib_m, WT, dmT, retain_graph=True)
    def lib_both():  # a fresh leaf: its gradient node is made on the capturing stream
        Wl = WT.detach().requires_grad_(True)
        torch.autograd.grad(F.embedding_bag(idx, Wl, per_sample_weights=val, mode="sum"), Wl,
                            dmT)

    for way, fn in (("forward", lib_fwd), ("backward", lib_bwd), ("both", lib_both)):
        res[f"{name}_embedding_bag_{way}"] = {"ms": graph_ms(fn),
                                              "eager_ms": cuda_time_ms(fn, 10, warmup=2)}
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
for n in ("other", "this"):
    rs = [json.loads(open(f"{sys.argv[1]}/{n}.{i}.json").read().splitlines()[-1])
          for i in (1, 2, 3)]
    best = {"best_of_3": n}
    for k, v in rs[0].items():
        if isinstance(v, dict):
            got = {t: [r[k][t] for r in rs if r[k][t] is not None] for t in v}
            best[k] = {t: min(g) if g else None for t, g in got.items()}
        elif isinstance(v, float):
            best[k] = min(r[k] for r in rs)
    print(json.dumps(best))
PY
