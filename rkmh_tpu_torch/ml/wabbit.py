"""VW-format linear models on PyTorch: the port's ``vw`` stand-in.

Counterpart of ``rkmh_tpu/ml/wabbit.py``: the same text formats in and
out, the same flags, messages and exit codes, and the same npz models, so
a model either package trains is applied by the other.

* input: VW example lines (``label [imp] ['tag] |ns f:v f ...``), the
  output of ``rkmh-tpu-torch-vwize`` or ``hash -w``;
* features: ``parse_example``, ``example_features`` and ``vectorize`` are
  copies of the JAX package's (murmur3, seed 42, namespace-salted, vw-style
  ``--interactions``), with a memo from feature string to hash, and give
  the same idx and val arrays;
* models: binary logistic (+-1 labels, margin predictions) and one-vs-all
  multiclass (``--ect k``, class-id predictions), trained full-batch with
  ``torch.optim.Adam`` from zeros, ``passes`` steps, on the JAX package's
  loss.  The weights W [C, D] are the parameter of ``WabbitModel``, whose
  margins (training and ``-t -p`` apply) are ``ops/sparse_margin``'s: K12
  on the card, the plain sum on the CPU;
* vw's own binary ``.model`` files are applied on the host by the port's
  copy of ``vw_model``, as the JAX package does.

Margins agree with the JAX package's to round-off, not bit for bit: the
sums run in another order (K12's warp sums and atomics, torch's CPU sum),
and torch's Adam rounds differently from optax's.  Class ids and
``--binary`` labels are compared for equality.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from functools import lru_cache
from itertools import product

import numpy as np
import torch
from torch import nn

from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from rkmh_tpu_torch.ops.murmur3 import murmur3_x64_128_np
from rkmh_tpu_torch.ops.sparse_margin import sparse_margins

L2 = 1e-6  # the loss's weight on sum(W * W) (rkmh_tpu/ml/wabbit.py:186, :220)


# ---------------------------------------------------------------------------
# VW text format (copies of rkmh_tpu/ml/wabbit.py:55-168)
# ---------------------------------------------------------------------------


@dataclass
class Example:
    label: float | None
    importance: float
    tag: str
    namespaces: list  # [(ns_name, [(feat, val), ...])]


def parse_example(line: str) -> Example | None:
    line = line.rstrip("\n")
    if not line.strip():
        return None
    head, *nss = line.split("|")
    toks = head.split()
    label = importance = None
    tag = ""
    pos = 0  # positional: token 0 = label, token 1 = importance
    for t in toks:
        if t.startswith("'"):
            tag = t[1:]
            continue
        if pos == 0:
            try:
                label = float(t)
            except ValueError:
                label = None  # unlabeled (e.g. the XYX placeholder)
        elif pos == 1:
            try:
                importance = float(t)
            except ValueError:
                pass
        pos += 1
    # a quoted tag may be glued to the last token (vwize: `1.0 'tag`)
    if not tag and toks and "'" in toks[-1]:
        tag = toks[-1].split("'", 1)[1]
    namespaces = []
    for ns in nss:
        parts = ns.split()
        if not parts:
            continue
        # "name f:v ..." — a namespace token has no ':'; a bare feature does
        if ":" not in parts[0] or parts[0].endswith(":"):
            ns_name, feats = parts[0], parts[1:]
        else:
            ns_name, feats = "", parts
        fv = []
        for f in feats:
            if ":" in f:
                name, v = f.rsplit(":", 1)
                try:
                    fv.append((name, float(v)))
                except ValueError:
                    fv.append((f, 1.0))
            else:
                fv.append((f, 1.0))
        namespaces.append((ns_name, fv))
    return Example(label, importance if importance is not None else 1.0,
                   tag, namespaces)


@lru_cache(maxsize=1 << 20)
def _feat_hash(s: str) -> int:
    """Low 64 bits of MurmurHash3_x64_128(s, seed 42); memoised, since
    sketch features recur across the examples of a file."""
    return murmur3_x64_128_np(s.encode())[0]


def _hash_feat(s: str, bits: int) -> int:
    return _feat_hash(s) & ((1 << bits) - 1)


def example_features(ex: Example, bits: int, interactions: list[str],
                     ignore: set[str]) -> list[tuple[int, float]]:
    """Hashed (index, value) features incl. namespace interactions.

    `interactions` entries are vw-style namespace-first-letter strings
    ("vvvv" = 4-way product of namespaces starting with 'v')."""
    spaces = [(n, fv) for n, fv in ex.namespaces
              if not (n[:1] in ignore)]
    out = []
    for ns_name, fv in spaces:
        for name, val in fv:
            out.append((_hash_feat(f"{ns_name}^{name}", bits), val))
    for spec in interactions:
        slots = []
        for ch in spec:
            cand = [fv for n, fv in spaces if n[:1] == ch]
            slots.append([f for fv in cand for f in fv])
        n_combo = 1
        for s in slots:
            n_combo *= max(1, len(s))
        if n_combo > 2_000_000:
            raise ValueError(
                f"interaction {spec!r} expands to {n_combo} features/example"
            )
        if any(not s for s in slots):
            continue
        for combo in product(*slots):
            key = "*".join(name for name, _ in combo)
            val = 1.0
            for _, v in combo:
                val *= v
            out.append((_hash_feat(f"I{spec}^{key}", bits), val))
    return out


def vectorize(examples, bits: int, interactions, ignore):
    """Examples -> padded (idx [N, F] i32, val [N, F] f32) + labels."""
    rows = [example_features(ex, bits, interactions, ignore) for ex in examples]
    F = max(1, max((len(r) for r in rows), default=1))
    idx = np.zeros((len(rows), F), np.int32)
    val = np.zeros((len(rows), F), np.float32)
    for i, r in enumerate(rows):
        if r:
            ix, v = zip(*r)
            idx[i, : len(r)] = ix
            val[i, : len(r)] = v
    labels = np.asarray(
        [ex.label if ex.label is not None else 0.0 for ex in examples],
        np.float32,
    )
    return idx, val, labels


# ---------------------------------------------------------------------------
# Models (torch)
# ---------------------------------------------------------------------------


class WabbitModel(nn.Module):
    """A feature-hashed linear model: W [C, 2**bits] (C = 1 for
    ``binary``, the class count for ``ect``) and the features it reads."""

    def __init__(self, kind: str, weights: torch.Tensor, bits: int, interactions=(),
                 ignore=()):
        super().__init__()
        if weights.dim() != 2 or weights.shape[1] != 1 << bits:
            raise ValueError(f"a model of {bits} bits has weights [C, {1 << bits}], got "
                             f"{tuple(weights.shape)}")
        self.kind, self.bits = kind, bits
        self.interactions, self.ignore = list(interactions), set(ignore)
        self.W = nn.Parameter(weights)

    def forward(self, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        """[N, F] idx and val -> [C, N] margins."""
        return sparse_margins(self.W, idx, val)

    def weights_numpy(self) -> np.ndarray:
        """The JAX package's layout: [D] for binary, [C, D] for ect."""
        W = self.W.detach().cpu().numpy()
        return W[0] if self.kind == "binary" else W


def _train(Y: np.ndarray, idx, val, bits: int, passes: int, lr: float, device) -> np.ndarray:
    """Full-batch Adam from zeros on mean(logaddexp(0, -Y * m)) + L2 *
    sum(W * W), the mean over all C * N entries; Y [C, N] in {-1, +1}."""
    device = resolve_device(device)
    C = Y.shape[0]
    model = WabbitModel("binary" if C == 1 else "ect",
                        torch.zeros((C, 1 << bits), dtype=torch.float32, device=device), bits)
    idx_t = torch.as_tensor(np.asarray(idx, np.int32)).to(device)
    val_t = torch.as_tensor(np.asarray(val, np.float32)).to(device)
    Y_t = torch.as_tensor(Y).to(device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(max(1, passes)):
        opt.zero_grad(set_to_none=True)
        m = model(idx_t, val_t)
        loss = torch.logaddexp(zero, -Y_t * m).mean() + L2 * (model.W * model.W).sum()
        loss.backward()
        opt.step()
    return model.weights_numpy()


def train_binary(idx, val, y, bits: int, passes: int = 25, lr: float = 0.05,
                 device=DEFAULT_DEVICE) -> np.ndarray:
    """Full-batch adam logistic regression; y in {-1, +1}; returns w [2^b]."""
    Y = np.asarray(y, np.float32).reshape(1, -1)
    return _train(Y, idx, val, bits, passes, lr, device)


def train_multiclass(idx, val, y, n_classes: int, bits: int, passes: int = 25,
                     lr: float = 0.05, device=DEFAULT_DEVICE) -> np.ndarray:
    """One-vs-all logistic (the --ect use case); y in {1..k}; W [k, 2^b]."""
    Y = np.zeros((n_classes, len(y)), np.float32) - 1.0
    for i, lab in enumerate(y):
        Y[int(lab) - 1, i] = 1.0
    return _train(Y, idx, val, bits, passes, lr, device)


def margins(model: WabbitModel, idx: np.ndarray, val: np.ndarray) -> np.ndarray:
    """[C, N] float32 margins of the examples, on the model's device."""
    device = model.W.device
    with torch.no_grad():
        m = model(torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(device),
                  torch.from_numpy(np.ascontiguousarray(val, np.float32)).to(device))
    return m.cpu().numpy()


def save_model(path: str, kind: str, weights, bits: int, interactions, ignore):
    # write through a file object: np.savez would otherwise append .npz to
    # the name, breaking `-f trained.model`-style invocations
    with open(path, "wb") as fh:
        np.savez_compressed(
            fh, kind=kind, weights=weights, bits=bits,
            interactions=np.asarray(list(interactions), dtype=object),
            ignore=np.asarray(sorted(ignore), dtype=object),
        )


def load_model(path: str):
    z = np.load(path, allow_pickle=True)
    return (str(z["kind"]), z["weights"], int(z["bits"]),
            [str(s) for s in z["interactions"]],
            {str(s) for s in z["ignore"]})


# ---------------------------------------------------------------------------
# CLI — the vw-flag subset the reference pipeline uses
# ---------------------------------------------------------------------------


def _apply_vw_blob(args, examples, stdout) -> int:
    """-i on a vw binary model: vw-native hashing and predict on the host
    (ml/vw_model.py); apply-only."""
    from rkmh_tpu_torch.ml.vw_model import load_vw_model, predict_examples

    if args.out_model:
        print("vw binary models are apply-only here (pass -t -p; "
              "train new models to npz instead)", file=sys.stderr)
        return 1
    model = load_vw_model(args.in_model)
    preds_out = (stdout if args.predictions in ("-", "/dev/stdout")
                 else open(args.predictions, "w")
                 if args.predictions else None)
    if preds_out is None:
        print("vw binary model loaded; nothing to do without -p",
              file=sys.stderr)
        return 0
    try:
        for v in predict_examples(model, examples, binary=args.binary):
            if model.kind == "ect":
                preds_out.write(f"{int(v)}\n")
            else:
                preds_out.write(f"{v:.6f}\n")
    finally:
        if preds_out is not stdout:
            preds_out.close()
    return 0


def main(argv=None, stdin=None, stdout=None) -> int:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    ap = argparse.ArgumentParser(
        prog="rkmh-tpu-torch-wabbit",
        description="vw-compatible train/predict over VW example lines "
                    "(PyTorch; npz models).",
    )
    ap.add_argument("data", nargs="?", default="-",
                    help="VW examples file ('-' = stdin)")
    ap.add_argument("-d", "--data", dest="data_flag", default=None)
    ap.add_argument("-f", "--final-regressor", dest="out_model", default="")
    ap.add_argument("-i", "--initial-regressor", dest="in_model", default="")
    ap.add_argument("-p", "--predictions", default="",
                    help="write predictions here ('/dev/stdout' works)")
    ap.add_argument("-t", "--testonly", action="store_true")
    ap.add_argument("--binary", action="store_true")
    ap.add_argument("--ect", type=int, default=0, metavar="K",
                    help="K-way multiclass (one-vs-all)")
    ap.add_argument("--passes", type=int, default=25)
    ap.add_argument("-b", "--bit-precision", dest="bits", type=int, default=18)
    ap.add_argument("--interactions", action="append", default=[])
    ap.add_argument("--ignore", action="append", default=[])
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--cache_file", default="", help="accepted, unused")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    path = args.data_flag or args.data
    fh = stdin if path == "-" else open(path)
    try:
        examples = [e for e in (parse_example(l) for l in fh) if e is not None]
    finally:
        if path != "-":
            fh.close()
    if not examples:
        print("no examples", file=sys.stderr)
        return 1

    if args.in_model:
        from rkmh_tpu_torch.ml.vw_model import is_vw_model

        if is_vw_model(args.in_model):
            return _apply_vw_blob(args, examples, stdout)
        kind, weights, bits, interactions, ignore = load_model(args.in_model)
    else:
        kind = "ect" if args.ect else "binary"
        bits, interactions, ignore = args.bits, args.interactions, set(args.ignore)
        weights = None

    idx, val, labels = vectorize(examples, bits, interactions, set(ignore))

    if weights is None and not args.testonly:
        # train only on labeled examples (vwize's unlabeled placeholder
        # lines would otherwise silently skew the model)
        labeled = np.asarray([ex.label is not None for ex in examples])
        if not labeled.all():
            print(f"skipping {int((~labeled).sum())} unlabeled examples "
                  "for training", file=sys.stderr)
        if not labeled.any():
            print("no labeled examples to train on", file=sys.stderr)
            return 1
        t_idx, t_val, t_lab = idx[labeled], val[labeled], labels[labeled]
        if kind == "binary":
            y = np.where(t_lab >= 0, 1.0, -1.0).astype(np.float32)
            weights = train_binary(t_idx, t_val, y, bits, args.passes,
                                   args.learning_rate, device)
        else:
            if not np.isin(t_lab, np.arange(1, args.ect + 1)).all():
                print(f"--ect {args.ect}: labels must be in 1..{args.ect}",
                      file=sys.stderr)
                return 1
            weights = train_multiclass(t_idx, t_val, t_lab, args.ect, bits,
                                       args.passes, args.learning_rate, device)
        if args.out_model:
            save_model(args.out_model, kind, weights, bits,
                       interactions, ignore)

    if weights is None and (args.testonly or args.predictions):
        print("no model: pass -i <model> (or drop -t to train)", file=sys.stderr)
        return 1

    preds_out = None
    if args.predictions:
        preds_out = (stdout if args.predictions in ("-", "/dev/stdout")
                     else open(args.predictions, "w"))
    if preds_out is not None:
        from rkmh_tpu_torch.convert import wabbit_from_numpy

        try:
            model = wabbit_from_numpy(kind, weights, bits, interactions, ignore, device)
            scores = margins(model, idx, val)
            if kind == "binary":
                if args.binary:
                    for v in scores[0]:
                        preds_out.write(f"{1 if v > 0 else -1}\n")
                else:
                    for v in scores[0]:
                        preds_out.write(f"{v:.6f}\n")
            else:
                for c in scores.argmax(axis=0) + 1:
                    preds_out.write(f"{c}\n")
        finally:
            if preds_out is not stdout:
                preds_out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
