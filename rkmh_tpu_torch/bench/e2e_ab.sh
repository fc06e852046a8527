#!/usr/bin/env bash
# End-to-end seconds of `stream -M 2 -I 40` (2^20 synthetic 150 bp reads,
# the zika-shaped panel) and `hpv16 -M 2` (12,800 synthetic nanopore-like
# reads) on another checkout against this one, in turns in one call:
# other, this, this, other.  Host time spreads widely between calls, so
# two versions compare only like this.  Needs one CUDA card and nvcc.
#
#     bash rkmh_tpu_torch/bench/e2e_ab.sh OTHER_CHECKOUT
#
# from the root of this checkout; OTHER_CHECKOUT holds rkmh_tpu_torch/ of
# the other version (for example `git archive REV | tar -x -C DIR`).  Each
# tree builds its kernels in a small run first, which is not timed.  The
# last line says whether both versions printed the same bytes.
set -e
ROOT=$PWD
OTHER=$(cd "$1" && pwd)
D=$(mktemp -d)
trap 'rm -rf "$D"' EXIT
mkdir -p "$D/h"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m rkmh_tpu_torch.synth --out-dir "$D" --reads 1048576 --seed 0 > /dev/null
python -m rkmh_tpu_torch.synth --out-dir "$D/small" --reads 2000 --seed 1 > /dev/null
python -m rkmh_tpu_torch.synth --hpv16 --out-dir "$D/h" --reads 12800 --n-rate 0.001 > /dev/null
STREAM="-k 12 -s 1000 -M 2 -I 40 --device cuda"
run() {  # checkout, label
  cd "$1"
  python -m rkmh_tpu_torch.cli stream -r "$D/small/refs.fa" -f "$D/small/reads.fq" $STREAM > /dev/null
  t0=$(date +%s%N)
  python -m rkmh_tpu_torch.cli stream -r "$D/refs.fa" -f "$D/reads.fq" $STREAM > "$D/out.$2.tsv"
  t1=$(date +%s%N)
  (cd "$D/h" && PYTHONPATH=$1 python -m rkmh_tpu_torch.cli hpv16 -f "$D/h/reads.fq" -R "$D/h" \
    -k 18 -M 2 --device cuda > "$D/hout.$2.tsv" 2> /dev/null)
  t2=$(date +%s%N)
  echo "$2: stream -M 2 -I 40 $(( (t1 - t0) / 1000000 )) ms, hpv16 -M 2 $(( (t2 - t1) / 1000000 )) ms"
  cd "$ROOT"
}
run "$OTHER" other
run "$ROOT" this
run "$ROOT" this
run "$OTHER" other
cmp "$D/out.other.tsv" "$D/out.this.tsv" && cmp "$D/hout.other.tsv" "$D/hout.this.tsv" \
  && echo "outputs identical"
