#!/usr/bin/env bash
# hpv16's set-up seconds by phase (``hpv16_cmd.build_tables``' laps) and
# its end-to-end Mbp/s (12,800 synthetic nanopore-like reads, set-up
# included, through the CLI) on another checkout against this one, in
# turns in one call: other, this, this, other.  Host time spreads widely
# between calls, so two versions compare only like this.  Needs one CUDA
# card and nvcc.
#
#     bash rkmh_tpu_torch/bench/setup_ab.sh OTHER_CHECKOUT
#
# from the root of this checkout; OTHER_CHECKOUT holds rkmh_tpu_torch/ of
# the other version (for example `git archive REV | tar -x -C DIR`).  Each
# run first builds the tables once untimed (the kernels' build and load,
# the card's start), then prints the laps of a second build.  The last line
# says whether both versions printed the same bytes.
set -e
ROOT=$PWD
OTHER=$(cd "$1" && pwd)
D=$(mktemp -d)
trap 'rm -rf "$D"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m rkmh_tpu_torch.synth --hpv16 --out-dir "$D" --reads 12800 --n-rate 0.001 > /dev/null
MBP=$(python -c "
print(sum(len(ln) - 1 for i, ln in enumerate(open('$D/reads.fq')) if i % 4 == 1) / 1e6)")
run() {  # checkout, label
  cd "$D"
  PYTHONPATH=$1 python -c "
import json, torch
from rkmh_tpu_torch.commands import hpv16_cmd
cfg = hpv16_cmd.Hpv16Config(refpath='$D', tst_file=False)
hpv16_cmd.build_tables(cfg, (18,), torch.device('cuda'))
tb = hpv16_cmd.build_tables(cfg, (18,), torch.device('cuda'))
print('$2 set-up laps (s):', json.dumps({k: round(v, 4) for k, v in tb.setup_s.items()}),
      'total', round(sum(tb.setup_s.values()), 4))" 2> /dev/null
  t0=$(date +%s%N)
  PYTHONPATH=$1 python -m rkmh_tpu_torch.cli hpv16 -f "$D/reads.fq" -R "$D" -k 18 \
    --device cuda > "$D/out.$2.tsv" 2> /dev/null
  t1=$(date +%s%N)
  python -c "print('$2: hpv16 e2e', ($t1 - $t0) / 1e9, 's,', $MBP / (($t1 - $t0) / 1e9), 'Mbp/s')"
  cd "$ROOT"
}
run "$OTHER" other
run "$ROOT" this
run "$ROOT" this
run "$OTHER" other
cmp "$D/out.other.tsv" "$D/out.this.tsv" && echo "outputs identical"
