"""`rkmh-tpu-torch count` against `rkmh-tpu count`, and the counter's new parts.

Both packages count the same synthetic files (rkmh_tpu_torch.synth, made
from a seed: 150 bp reads with N bases, and reads of mixed lengths, empty
and shorter than k included) into tables of a decimal prime, a
non-power-of-two and a power-of-two size, at one k and at -k 12 -k 16,
over several chunks and batches.  Required equal: the stderr summary
line, the ``--dump`` lines, and the ``-o`` npz's arrays (``table``,
``size``, ``ks``: values and dtypes; ``np.savez_compressed`` promises no
byte-identical file).  Also: ``convert.counter_from_npz`` on tables
written by either package, ``HashCounter.get`` / ``to_numpy`` against the
JAX counter, and that ``HashCounter`` takes no default device.  The port
runs its plain path on the CPU.  Tolerance: none.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.count_cmd import CountConfig as JaxConfig
from rkmh_tpu.commands.count_cmd import run as jax_run
from rkmh_tpu.ops import counter as jcounter
from rkmh_tpu_torch import cli, convert, synth
from rkmh_tpu_torch.commands.count_cmd import CountConfig, run
from rkmh_tpu_torch.ops import counter


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("count")
    _, short, _, _ = synth.write_workload(str(d / "short"), 80, 150, num_refs=4,
                                          genome_len=1500, seed=5, n_rate=0.02)
    _, genomes = synth.make_panel(4, 1500, seed=5)
    reads, _ = synth.make_reads(genomes, 30, 400, seed=6)
    lens = np.random.default_rng(7).integers(0, 400, 30)
    lens[:3] = (0, 4, 11)
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as fh:
        for i, (r, n) in enumerate(zip(reads, lens)):
            fh.write(f">c{i}\n{r[:n].tobytes().decode()}\n")
    return {"short": short, "mixed": mixed}


def _summary(err: str) -> list[str]:
    return [ln for ln in err.splitlines() if ln.startswith(("Counted", "Saved", "Using"))]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kw", [
    dict(ks=(12,), counter_size=1009),
    dict(ks=(12, 16), counter_size=1000, batch_size=16, chunk_reads=37),
    dict(ks=(16,), counter_size=4096),
    dict(ks=(), counter_size=640_000),
], ids=["prime", "multi-k-non-power-of-two", "power-of-two", "default-k-and-size"])
def test_count_matches_jax(workload, capsys, tmp_path, kw):
    files = [workload["short"], workload["mixed"]]
    outs = {}
    for name, fn, cfg, extra in (("jax", jax_run, JaxConfig, {}),
                                 ("torch", run, CountConfig, {"device": "cpu"})):
        capsys.readouterr()
        buf = io.StringIO()
        path = str(tmp_path / f"{name}.npz")
        assert fn(cfg(read_files=files, out_file=path, dump=True, **kw, **extra), out=buf) == 0
        outs[name] = (buf.getvalue(), _summary(capsys.readouterr().err), _npz(path))
    (want_dump, want_err, want_npz), (got_dump, got_err, got_npz) = outs["jax"], outs["torch"]
    assert got_dump == want_dump and len(want_dump.splitlines()) > 10
    assert got_err == [ln.replace("jax.npz", "torch.npz") for ln in want_err]
    assert len(got_err) == 2 + (not kw["ks"])
    assert set(got_npz) == set(want_npz) == {"table", "size", "ks"}
    for key in want_npz:
        assert got_npz[key].dtype == want_npz[key].dtype, key
        assert np.array_equal(got_npz[key], want_npz[key]), key


def test_cli_count_matches_jax(workload, capsys, tmp_path):
    argv = ["count", "-f", workload["mixed"], "-k", "12", "--counter-size", "997", "--dump"]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and _summary(got.err) == _summary(want.err)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_counter_from_npz_loads_either_packages_table(workload, tmp_path, writer):
    path = str(tmp_path / "t.npz")
    if writer == "jax":
        jax_run(JaxConfig(read_files=[workload["short"]], ks=(12,), counter_size=1009,
                          out_file=path), out=io.StringIO())
    else:
        run(CountConfig(read_files=[workload["short"]], ks=(12,), counter_size=1009,
                        out_file=path, device="cpu"), out=io.StringIO())
    hc = convert.counter_from_npz(path, "cpu")
    table = _npz(path)["table"]
    assert isinstance(hc, counter.HashCounter) and hc.table.dtype == torch.int32
    assert np.array_equal(hc.to_numpy(), table) and int(table.sum()) > 0
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, table=table, size=table.shape[0] + 1, ks=np.asarray([12]))
    with pytest.raises(ValueError, match="size"):
        convert.counter_from_npz(bad, "cpu")


def test_counter_get_and_to_numpy_match_jax():
    rng = np.random.default_rng(1)
    h = rng.integers(-(2**63), 2**63 - 1, size=(20, 33), dtype=np.int64)
    h[:, ::5] = h[:, 1::5][:, : h[:, ::5].shape[1]]
    jc = jcounter.HashCounter(1009).add(jnp.asarray(h.view(np.uint64)))
    hc = counter.HashCounter(1009, "cpu").add(torch.from_numpy(h))
    assert np.array_equal(hc.to_numpy(), jc.to_numpy())
    probe = torch.from_numpy(h[::3])
    assert np.array_equal(hc.get(probe).numpy(),
                          np.asarray(jc.get(jnp.asarray(h[::3].view(np.uint64)))))


def test_hash_counter_takes_no_default_device():
    with pytest.raises(TypeError):
        counter.HashCounter(1009)  # the device is explicit: no table lands on the host unasked
