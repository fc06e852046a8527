"""The port's VW trainer and vw-model reader against rkmh-tpu's.

``rkmh_tpu_torch.ml.wabbit`` (torch, its plain path on the CPU) against
``rkmh_tpu.ml.wabbit`` (jax + optax on the CPU), and ``ml.vw_model``
against its JAX-package original, on VW lines made from a numpy seed.

Tolerances, and why:
* vectorized idx and val arrays, class ids, ``--binary`` labels, vw-blob
  predictions and the text of every message: equal;
* trained weights, no feature shared by every example: atol 1e-5.  Both
  trainers take the same full-batch Adam steps from zeros; they differ only
  in float32 round-off (the sum order of the margins and of the gradient,
  and optax's m_hat / (sqrt(v_hat) + eps) against torch's
  m / bc1 / (sqrt(v) / sqrt(bc2) + eps)), ~2e-7 here;
* trained weights, with the constant features of ``hash -w`` lines
  (``|sketch k:18 s:1000`` on every example, balanced labels): atol = lr.
  Their gradient cancels to ~0, where the sum order decides between 0 and
  ~1e-9, and Adam turns either into a step of up to lr; lr bounds one such
  step;
* margins printed from the same weights: atol 1e-5 + rtol 1e-5 (the sum
  order alone, float32 round-off of values up to ~10; the port's CPU sum
  is torch's, not numpy's, so the printed digits may differ in the last
  place); from weights trained by each package: the weights' tolerance
  times the row's sum of |val|, plus the same.
"""

import io
import os
import struct

import numpy as np
import pytest
import torch

from rkmh_tpu.ml import vw_model as jax_vw
from rkmh_tpu.ml import wabbit as jw
from rkmh_tpu_torch import convert
from rkmh_tpu_torch.ml import vw_model
from rkmh_tpu_torch.ml import wabbit as tw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("coinf_binary", "coinf_interactions", "lineage_ect", "sublineage_ect")
STRAINS = ["A1", "A2", "A3", "A4", "B1", "B2", "C1", "D1", "D2", "D3"]
LR = 0.05


def _sample_lines(seed, n, multiclass=0, sketch=False):
    """vwize --format stream -n style lines: normalized strain fractions of
    single-strain (label -1, or its lineage class) and mixed samples (1, or
    class ``multiclass``)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        k = 1 if i % 2 else int(rng.integers(2, 4))
        strains = rng.choice(len(STRAINS), size=k, replace=False)
        frac = np.zeros(len(STRAINS))
        frac[strains] = rng.dirichlet(np.ones(k) * 2) * 0.9
        frac += rng.random(len(STRAINS)) * 0.02  # misassigned reads
        frac /= frac.sum()
        if multiclass:
            label = multiclass if k > 1 else "ABCD".index(STRAINS[strains[0]][0]) + 1
        else:
            label = 1 if k > 1 else -1
        feats = " ".join(f"{s}:{v}" for s, v in zip(STRAINS, frac))
        lines.append(f"{label} 1.0 'hpv |vir {feats}" + (" |sketch k:18 s:1000" if sketch
                                                        else ""))
    return "\n".join(lines) + "\n"


def _main_both(argv, stdin_text):
    """-> ((rc, stdout) of rkmh_tpu.ml.wabbit.main, of the port's on the CPU)."""
    out = []
    for main, extra in ((jw.main, []), (tw.main, ["--device", "cpu"])):
        buf = io.StringIO()
        rc = main(argv=[*argv, *extra], stdin=io.StringIO(stdin_text), stdout=buf)
        out.append((rc, buf.getvalue()))
    return out


def _floats(text):
    return np.array([float(x) for x in text.split()])


# ---------------------------------------------------------------------------
# parsing and features
# ---------------------------------------------------------------------------

LINES = [
    "1 1.0 'hpv |vir A1:0.5 B2:0.25",
    "XYX 1.0 `k|vir 123:1 456:2 |sketch k:16 s:200",
    "-1 2.5 'tag2 |vir A1:1 |sketch k:16",
    "3 1.0 'glued|vir C1:0.125 bare D1:x",
    "2 |vir A1:3 |other q:2 r |void",
    "1.0 'x |  noname:4 f2",
    "5 0.5 label'tail |vir A2:1e-3 A3:-2",
    "",
    "   ",
]


@pytest.mark.parametrize("line", LINES)
def test_parse_example_equal(line):
    got, want = tw.parse_example(line), jw.parse_example(line)
    assert (got is None and want is None) or got.__dict__ == want.__dict__


@pytest.mark.parametrize("interactions,ignore", [
    ([], set()), (["vv"], set()), (["vvvv"], set()), (["vv", "vs"], {"o"}),
    ([], {"s"}), (["vv"], {"v"}),
])
@pytest.mark.parametrize("bits", [18, 4])
def test_vectorize_equal(interactions, ignore, bits):
    text = _sample_lines(3, 6, sketch=True) + "\n".join(LINES) + "\n"
    ex = [e for e in map(jw.parse_example, text.splitlines()) if e is not None]
    ext = [e for e in map(tw.parse_example, text.splitlines()) if e is not None]
    want = jw.vectorize(ex, bits, interactions, ignore)
    got = tw.vectorize(ext, bits, interactions, ignore)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for e, f in zip(ex, ext):
        assert tw.example_features(f, bits, interactions, ignore) == \
            jw.example_features(e, bits, interactions, ignore)


def test_vectorize_refuses_huge_interactions():
    ex = tw.parse_example("1 |vir " + " ".join(f"f{i}:1" for i in range(40)))
    with pytest.raises(ValueError, match="expands to"):
        tw.example_features(ex, 18, ["vvvvv"], set())


# ---------------------------------------------------------------------------
# the margins and their gradient (ops/sparse_margin, K12's plain path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [1, 5])
def test_sparse_margins_match_jax_margins_and_grad(C):
    """``sparse_margins`` on the CPU against ``_margins`` vmapped over the
    classes and its jax.grad: within 1e-5 of the sum of |terms| + 1e-6
    (float32 sums in another order; bench/margin_inputs.py)."""
    import jax
    import jax.numpy as jnp

    from rkmh_tpu_torch.bench.margin_inputs import _abs_terms, margin_case
    from rkmh_tpu_torch.ops.sparse_margin import sparse_margins

    W, idx, val, dm = margin_case(70, 33, C, 10, C, "cpu")
    Wj, idxj, valj, dmj = (jnp.asarray(t.numpy()) for t in (W, idx, val, dm))

    def margins_all(Wj):
        return jax.vmap(lambda w: jw._margins(w, idxj, valj))(Wj)

    want_m = np.asarray(margins_all(Wj))
    want_g = np.asarray(jax.grad(lambda Wj: jnp.sum(margins_all(Wj) * dmj))(Wj))
    Wt = W.clone().requires_grad_(True)
    got_m = sparse_margins(Wt, idx, val)
    (got_m * dm).sum().backward()
    bound_m, bound_g = (b.numpy() for b in _abs_terms(W, idx, val, dm))
    assert np.all(np.abs(got_m.detach().numpy() - want_m) <= 1e-5 * bound_m + 1e-6)
    assert np.all(np.abs(Wt.grad.numpy() - want_g) <= 1e-5 * bound_g + 1e-6)
    assert np.count_nonzero(want_g) > 0


# ---------------------------------------------------------------------------
# training (the port's plain path against optax)
# ---------------------------------------------------------------------------


def _arrays(text, interactions=()):
    ex = [e for e in map(jw.parse_example, text.splitlines()) if e is not None]
    return jw.vectorize(ex, 18, list(interactions), set())


@pytest.mark.parametrize("interactions", [(), ("vv",)])
def test_train_binary_matches_optax(interactions):
    idx, val, lab = _arrays(_sample_lines(4, 60), interactions)
    y = np.where(lab >= 0, 1.0, -1.0).astype(np.float32)
    want = jw.train_binary(idx, val, y, 18, 25, LR)
    got = tw.train_binary(idx, val, y, 18, 25, LR, device="cpu")
    assert got.shape == want.shape == (1 << 18,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.5  # it learned something


def test_train_multiclass_matches_optax():
    idx, val, lab = _arrays(_sample_lines(5, 80, multiclass=5))
    want = jw.train_multiclass(idx, val, lab, 5, 18, 25, LR)
    got = tw.train_multiclass(idx, val, lab, 5, 18, 25, LR, device="cpu")
    assert got.shape == want.shape == (5, 1 << 18)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ect", [0, 5])
def test_train_with_constant_features_within_lr(ect):
    """hash -w's constant features on every example: weights within lr."""
    idx, val, lab = _arrays(_sample_lines(6, 80, multiclass=ect, sketch=True))
    if ect:
        want = jw.train_multiclass(idx, val, lab, ect, 18, 25, LR)
        got = tw.train_multiclass(idx, val, lab, ect, 18, 25, LR, device="cpu")
    else:
        y = np.where(lab >= 0, 1.0, -1.0).astype(np.float32)
        want = jw.train_binary(idx, val, y, 18, 25, LR)
        got = tw.train_binary(idx, val, y, 18, 25, LR, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=LR)


# ---------------------------------------------------------------------------
# the CLI: train, apply, save and load across packages
# ---------------------------------------------------------------------------


def _margin_tol(val, w_tol):
    return w_tol * np.abs(val).sum(axis=1) + 1e-5


@pytest.mark.parametrize("extra", [[], ["--interactions", "vv"]])
def test_main_binary_train_and_predict(tmp_path, extra):
    train, test = _sample_lines(7, 60), _sample_lines(8, 30)
    models = [str(tmp_path / "jax.model"), str(tmp_path / "port.model")]
    for (main, dev), model in zip(((jw.main, []), (tw.main, ["--device", "cpu"])), models):
        assert main(argv=["-", "-f", model, "--passes", "40", *extra, *dev],
                    stdin=io.StringIO(train), stdout=io.StringIO()) == 0
    _, val, _ = _arrays(test, [e for e in extra if e != "--interactions"])
    for model in models:  # each model applied by both packages
        (rc_j, m_j), (rc_t, m_t) = _main_both(["-", "-i", model, "-t", "-p", "/dev/stdout"],
                                              test)
        assert rc_j == rc_t == 0
        np.testing.assert_allclose(_floats(m_t), _floats(m_j), rtol=1e-5, atol=1e-5)
        (_, b_j), (_, b_t) = _main_both(["-", "-i", model, "-t", "--binary", "-p", "-"], test)
        assert b_t == b_j
    # the two models: weights within 1e-5, so margins within that times sum |val|
    (_, m_j), _ = _main_both(["-", "-i", models[0], "-t", "-p", "-"], test)
    (_, m_t), _ = _main_both(["-", "-i", models[1], "-t", "-p", "-"], test)
    assert np.all(np.abs(_floats(m_t) - _floats(m_j)) <= _margin_tol(val, 1e-5))
    assert m_t.count("\n") == 30


def test_main_ect_train_and_predict(tmp_path):
    train, test = _sample_lines(9, 80, multiclass=5), _sample_lines(10, 40, multiclass=5)
    (rc_j, p_j), (rc_t, p_t) = _main_both(["-", "--ect", "5", "--passes", "60", "-p", "-"],
                                          train)
    assert rc_j == rc_t == 0 and p_t == p_j
    model = str(tmp_path / "ect.model")
    assert tw.main(argv=["-", "--ect", "5", "-f", model, "--device", "cpu"],
                   stdin=io.StringIO(train), stdout=io.StringIO()) == 0
    (_, c_j), (_, c_t) = _main_both(["-", "-i", model, "-t", "-p", "-"], test)
    assert c_t == c_j
    truth = [int(ln.split()[0]) for ln in test.splitlines()]
    assert np.mean(np.array(c_t.split(), int) == truth) >= 0.6


def test_save_and_load_both_ways(tmp_path):
    rng = np.random.default_rng(12)
    W = rng.standard_normal((3, 1 << 6)).astype(np.float32)
    for kind, weights in (("ect", W), ("binary", W[0])):
        a, b = str(tmp_path / f"{kind}_jax.npz"), str(tmp_path / f"{kind}_port.npz")
        jw.save_model(a, kind, weights, 6, ["vv"], {"s", "q"})
        tw.save_model(b, kind, weights, 6, ["vv"], {"s", "q"})
        for path in (a, b):
            for load in (jw.load_model, tw.load_model):
                k, w, bits, inter, ign = load(path)
                assert (k, bits, inter, ign) == (kind, 6, ["vv"], {"s", "q"})
                assert w.dtype == np.float32 and np.array_equal(w, weights)
            m = convert.wabbit_from_npz(path, "cpu")
            assert m.kind == kind and m.W.shape == (3 if kind == "ect" else 1, 64)
            assert torch.equal(m.W.detach(), torch.from_numpy(W if kind == "ect" else W[:1]))
            assert np.array_equal(m.weights_numpy(), weights)
        with np.load(a, allow_pickle=True) as za, np.load(b, allow_pickle=True) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                assert za[key].dtype == zb[key].dtype and np.array_equal(za[key], zb[key])


def test_wabbit_from_numpy_refuses_a_foreign_shape():
    with pytest.raises(ValueError):
        convert.wabbit_from_numpy("binary", np.zeros((2, 64), np.float32), 6, [], set(), "cpu")
    with pytest.raises(ValueError):
        convert.wabbit_from_numpy("ect", np.zeros((2, 32), np.float32), 6, [], set(), "cpu")


@pytest.mark.parametrize("model", MODELS)
def test_shipped_models_by_both_mains(model):
    """model_docker's four npz models applied by both packages."""
    path = os.path.join(REPO, "model_docker", f"{model}.npz")
    text = _sample_lines(13, 40) + "XYX 1.0 'u |vir\n"
    (rc_j, p_j), (rc_t, p_t) = _main_both(["-", "-i", path, "-t", "-p", "/dev/stdout"], text)
    assert rc_j == rc_t == 0 and p_t.count("\n") == 41
    if model.endswith("_ect"):
        assert p_t == p_j and len(set(p_t.split())) > 1
    else:
        np.testing.assert_allclose(_floats(p_t), _floats(p_j), rtol=1e-5, atol=1e-5)
        (_, b_j), (_, b_t) = _main_both(["-", "-i", path, "-t", "--binary", "-p", "-"], text)
        assert b_t == b_j and set(b_t.split()) == {"1", "-1"}


def test_margins_of_a_shipped_model_against_numpy():
    kind, w, bits, inter, ign = jw.load_model(
        os.path.join(REPO, "model_docker", "sublineage_ect.npz"))
    ex = [e for e in map(tw.parse_example, _sample_lines(14, 50).splitlines()) if e]
    idx, val, _ = tw.vectorize(ex, bits, inter, ign)
    got = tw.margins(convert.wabbit_from_numpy(kind, w, bits, inter, ign, "cpu"), idx, val)
    want = np.stack([(w[c][idx] * val).sum(axis=1) for c in range(w.shape[0])])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("argv,text,message", [
    ([], "", "no examples"),
    ([], "XYX 1.0 |vir A1:1\n", "no labeled examples to train on"),
    (["--ect", "3"], "4 1.0 |vir A1:1\n", "--ect 3: labels must be in 1..3"),
    (["-t", "-p", "-"], "1 |vir A1:1\n", "no model: pass -i <model> (or drop -t to train)"),
])
def test_main_errors(argv, text, message, capsys):
    (rc_j, out_j), (rc_t, out_t) = _main_both(["-", *argv], text)
    err = capsys.readouterr().err
    assert rc_j == rc_t == 1 and out_j == out_t == ""
    assert err.count(message) == 2


def test_main_skips_unlabeled_examples(capsys):
    text = _sample_lines(15, 20) + "XYX 1.0 |vir A1:1\nXYX 1.0 |vir B1:1\n"
    (rc_j, out_j), (rc_t, out_t) = _main_both(["-", "--binary", "-p", "-"], text)
    assert rc_j == rc_t == 0 and out_t == out_j
    assert capsys.readouterr().err.count("skipping 2 unlabeled examples for training") == 2


def test_main_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.main(argv=["-"], stdin=io.StringIO("1 |vir A1:1\n"), stdout=io.StringIO())


# ---------------------------------------------------------------------------
# vw binary models (ml/vw_model.py)
# ---------------------------------------------------------------------------


def test_murmur32_golden_vectors():
    """Public MurmurHash3_x86_32 test vectors (the hash vw uses for
    namespaces and non-numeric feature names)."""
    assert vw_model.murmur3_x86_32(b"", 0) == 0
    assert vw_model.murmur3_x86_32(b"", 1) == 0x514E28B7
    assert vw_model.murmur3_x86_32(b"hello", 0) == 0x248BFA47
    assert vw_model.murmur3_x86_32(b"hello, world", 0) == 0x149BBB7F
    assert vw_model.murmur3_x86_32(
        b"The quick brown fox jumps over the lazy dog", 0x9747B28C) == 0x2FA826CD
    for name in ("", "A1", "12345", "vir", "x" * 37):
        assert vw_model.hashstring(name, 7) == jax_vw.hashstring(name, 7)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 9, 11])
def test_ect_bracket(k):
    directions, root = vw_model.ect_bracket(k)
    assert (directions, root) == jax_vw.ect_bracket(k)
    assert len(directions) == k - 1 and root == 2 * k - 2
    leaves = set()
    stack = [root]
    while stack:
        node = stack.pop()
        if node < k:
            leaves.add(node)
        else:
            stack.extend(directions[node])
    assert leaves == set(range(k))


def _write_vw_blob(path, bits, options, weights):
    """A vw 8.3.1 regressor file: the layout ml/vw_model.py documents."""
    def nstr(s):
        b = s.encode() + b"\0"
        return struct.pack("<I", len(b)) + b

    nz = np.nonzero(weights)[0]
    body = (nstr("8.3.1") + nstr("") + b"m" + struct.pack("<ff", -1.0, 1.0)
            + struct.pack("<IIII", bits, 0, 0, 0) + nstr(options)
            + struct.pack("<II", 4, 0) + b"\0"
            + b"".join(struct.pack("<If", int(i), float(weights[i])) for i in nz))
    with open(path, "wb") as fh:
        fh.write(body)


@pytest.mark.parametrize("options", ["", " --ect 4 --error 0", " --interactions vv"])
def test_vw_blob_applied_by_both_mains(tmp_path, options):
    rng = np.random.default_rng(16)
    weights = np.where(rng.random(1 << 10) < 0.6,
                       rng.standard_normal(1 << 10), 0).astype(np.float32)
    path = str(tmp_path / "m.model")
    _write_vw_blob(path, 10, options, weights)
    assert vw_model.is_vw_model(path) and jax_vw.is_vw_model(path)
    assert not vw_model.is_vw_model(os.path.join(REPO, "model_docker", "coinf_binary.npz"))
    a, b = vw_model.load_vw_model(path), jax_vw.load_vw_model(path)
    assert a.__dict__.keys() == b.__dict__.keys()
    assert all(np.array_equal(a.__dict__[k], b.__dict__[k]) for k in a.__dict__)
    text = "XYX 1.0 `r|vir 123456789:1 98765:1 A1:2 |sketch k:18 s:1000\n" + _sample_lines(17, 8)
    for flags in ([], ["--binary"]):
        (rc_j, p_j), (rc_t, p_t) = _main_both(["-", "-i", path, "-t", "-p", "-", *flags], text)
        assert rc_j == rc_t == 0 and p_t == p_j and p_t.count("\n") == 9
    (rc_j, _), (rc_t, _) = _main_both(["-", "-i", path, "-f", str(tmp_path / "x")], text)
    assert rc_j == rc_t == 1


# ---------------------------------------------------------------------------
# the slice: stream -> vwize -> wabbit -> conf_mat / interpret_wabbit
# ---------------------------------------------------------------------------


def test_model_pipeline_matches_rkmh_tpu(tmp_path):
    """bench/model_pipeline's samples through both packages: the classified
    samples (the first and last of each set) and the VW files byte-identical; the four models trained by
    each package: weights within lr (the margins' tolerance above), and the
    class ids, --binary labels, conf_mat and interpret_wabbit outputs of
    the held-out samples equal."""
    from rkmh_tpu.commands.stream import StreamConfig, run as jax_stream
    from rkmh_tpu.scripts import conf_mat as jax_conf_mat
    from rkmh_tpu.scripts import interpret_wabbit as jax_interpret
    from rkmh_tpu.scripts.vwize import main as jax_vwize
    from rkmh_tpu_torch import synth
    from rkmh_tpu_torch.bench import model_pipeline as mp
    from rkmh_tpu_torch.scripts import conf_mat, interpret_wabbit

    panel = synth.write_hpv16_refpath(str(tmp_path / "ref"), num_types=16)
    refs = str(tmp_path / "ref" / "new_refs.fa")
    pools = mp.write_pools(str(tmp_path / "pools"), panel, 40, 5, 1500)
    data = {}
    for tag, seed, mixes in (("train", 1, 6), ("test", 2, 3)):
        samples = mp.write_samples(str(tmp_path / tag), pools, 7900, seed, 1, mixes, 30, tag)
        cls = mp.classify_samples(samples, refs, "cpu")
        for path, (fq, _) in list(zip(cls, samples))[:: len(samples) - 1]:  # first, last
            want = io.StringIO()
            assert jax_stream(StreamConfig(ref_files=[refs], read_files=[fq], ks=mp.KS,
                                           sketch_size=mp.SKETCH), out=want) == 0
            assert open(path).read() == want.getvalue()
        coinfs = [c for _, c in samples]
        data[tag] = mp.write_vw_files(cls, coinfs, str(tmp_path), tag)
        jax_files = mp.write_vw_files(cls, coinfs, str(tmp_path), "jax_" + tag, jax_vwize)
        for kind in data[tag]:
            assert open(data[tag][kind]).read() == open(jax_files[kind]).read()
    for name, kind, extra in mp.JOBS:
        models = [str(tmp_path / f"{name}_{pkg}.npz") for pkg in ("jax", "port")]
        assert jw.main([data["train"][kind], "-f", models[0], *extra]) == 0
        assert tw.main([data["train"][kind], "-f", models[1], *extra, "--device", "cpu"]) == 0
        np.testing.assert_allclose(tw.load_model(models[1])[1], jw.load_model(models[0])[1],
                                   rtol=0, atol=LR)
        test_text = open(data["test"][kind]).read()
        (_, p_j), (_, p_t) = [_main_both(["-", "-i", m, "-t", "-p", "-", *flags], test_text)[i]
                              for i, m in enumerate(models)
                              for flags in [["--binary"] if kind == "binary" else []]]
        assert p_t == p_j
        truth = mp.labels(data["test"][kind])
        assert mp.accuracy(kind, p_t.split(), truth) > 0.5
        pred = tmp_path / f"{name}.pred"
        pred.write_text("".join(f"{p} s{i}\n" for i, p in enumerate(p_t.split())))
        outs = []
        for interpret, cm in ((jax_interpret, jax_conf_mat), (interpret_wabbit, conf_mat)):
            buf = io.StringIO()
            interpret.main(["-i", str(pred), "-T", {"binary": "BINARY", "lineage": "LIN",
                                                     "sublineage": "SUB"}[kind]], stdout=buf)
            if kind == "binary":
                cm_in = tmp_path / f"{name}.cm"
                cm_in.write_text("".join(f"{-float(p)} {'coinf' if t > 0 else 'hpv'}\n"
                                         for p, t in zip(p_t.split(), truth)))
                cm.main([str(cm_in)], stdout=buf)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and outs[1].startswith("STATUS:")
