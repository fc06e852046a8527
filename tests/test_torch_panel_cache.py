"""The port's on-disk panel cache against rkmh-tpu's.

``rkmh_tpu_torch.commands.common.build_ref_panel_from_files`` keeps the
JAX package's cache (``rkmh_tpu/commands/common.py:110-230``): the same
key, file name and pickle-free payload.  On the same synthetic panel (made
from a seed; s = 1000 of ~1,490 k-mers a reference, so the sketches hold
hashes on both sides of 2**63): a second run is a hit and
hashes no reference; an entry either package writes is a hit for the other,
under the same file name, with byte-identical ``stream`` output and equal
payload arrays; RKMH_TPU_PANEL_CACHE=0 writes nothing; a corrupt entry is
rebuilt with rkmh-tpu's log line; -I and filter's distinct counter key
their own entries.  tests/conftest.py turns the cache off by default, so
each test points it at its own directory.  No tolerance: every output is
text or integers and must be equal.
"""

import io
import os

import numpy as np
import pytest

from rkmh_tpu.commands.filter_cmd import FilterConfig as JaxFilterConfig
from rkmh_tpu.commands.filter_cmd import run as jax_filter
from rkmh_tpu.commands.stream import StreamConfig as JaxConfig
from rkmh_tpu.commands.stream import run as jax_run
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands import common
from rkmh_tpu_torch.commands.filter_cmd import FilterConfig, run as port_filter
from rkmh_tpu_torch.commands.stream import StreamConfig, run

@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("panel_cache")
    refs, reads, _, _ = synth.write_workload(str(d), 120, 150, num_refs=5, genome_len=1500,
                                             seed=21)
    return {"refs": refs, "reads": reads}


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    path = tmp_path / "panels"
    monkeypatch.setenv("RKMH_TPU_PANEL_CACHE", str(path))
    return path


def _port(workload, **kw):
    out = io.StringIO()
    assert run(StreamConfig(ref_files=[workload["refs"]], read_files=[workload["reads"]],
                            ks=(12,), sketch_size=1000, device="cpu", **kw), out=out) == 0
    return out.getvalue()


def _jax(workload, **kw):
    out = io.StringIO()
    assert jax_run(JaxConfig(ref_files=[workload["refs"]], read_files=[workload["reads"]],
                             ks=(12,), sketch_size=1000, **kw), out=out) == 0
    return out.getvalue()


def _entries(cache_dir):
    return sorted(p.name for p in cache_dir.glob("*.npz")) if cache_dir.exists() else []


def _no_hashing(monkeypatch):
    """Make any reference hashing fail: a hit must not build a panel."""
    def refuse(*args, **kwargs):
        raise AssertionError("the references were hashed on a cache hit")

    monkeypatch.setattr(common, "build_ref_panel", refuse)


def _payload(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_second_run_is_a_hit(workload, cache_dir, monkeypatch):
    first = _port(workload)
    (entry,) = _entries(cache_dir)
    _no_hashing(monkeypatch)
    assert _port(workload) == first
    assert _entries(cache_dir) == [entry]
    z = _payload(cache_dir / entry)
    assert z["sk"].dtype == np.uint64 and z["lens"].dtype == np.int32
    assert z["names"].dtype.kind == "U"
    assert (z["sk"] >= np.uint64(1 << 63)).any() and (z["sk"] < np.uint64(1 << 63)).any()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hit_across_packages(workload, cache_dir, monkeypatch, writer):
    want = _jax(workload)
    jax_entries = _entries(cache_dir)
    jax_payload = _payload(cache_dir / jax_entries[0])
    for p in cache_dir.glob("*.npz"):
        p.unlink()
    assert _port(workload) == want
    assert _entries(cache_dir) == jax_entries  # the same key, so the same file name
    port_payload = _payload(cache_dir / jax_entries[0])
    assert sorted(port_payload) == sorted(jax_payload)
    for k in jax_payload:
        assert port_payload[k].dtype == jax_payload[k].dtype, k
        assert np.array_equal(port_payload[k], jax_payload[k]), k
    if writer == "jax":  # the JAX package writes, the port reads
        for p in cache_dir.glob("*.npz"):
            p.unlink()
        assert _jax(workload) == want
        _no_hashing(monkeypatch)
        assert _port(workload) == want
    else:  # the port writes (above), the JAX package reads
        import rkmh_tpu.commands.common as jax_common

        def refuse(*args, **kwargs):
            raise AssertionError("rkmh-tpu hashed the references on a hit")

        monkeypatch.setattr(jax_common, "build_ref_panel", refuse)
        assert _jax(workload) == want
    assert _entries(cache_dir) == jax_entries


def test_cache_off_writes_nothing(workload, tmp_path, monkeypatch):
    monkeypatch.setenv("RKMH_TPU_PANEL_CACHE", "0")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert common._panel_cache_path([workload["refs"]], (12,), 1000, None, 1, False) is None
    assert _port(workload) == _jax(workload)
    assert not (tmp_path / "home").exists()


def test_default_directory_is_rkmh_tpus(workload, tmp_path, monkeypatch):
    monkeypatch.delenv("RKMH_TPU_PANEL_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    path = common._panel_cache_path([workload["refs"]], (12,), 1000, None, 1, False)
    assert os.path.dirname(path) == str(tmp_path / ".cache" / "rkmh_tpu" / "panels")
    assert common._panel_cache_path(["-"], (12,), 1000, None, 1, False) is None


def test_corrupt_entry_is_rebuilt(workload, cache_dir, capsys):
    want = _port(workload)
    (entry,) = _entries(cache_dir)
    (cache_dir / entry).write_bytes(b"not an npz")
    capsys.readouterr()
    assert _port(workload) == want
    assert "panel cache entry unreadable (" in capsys.readouterr().err
    assert _payload(cache_dir / entry)["sk"].dtype == np.uint64  # overwritten, readable
    assert not list(cache_dir.glob("*.tmp"))


def test_key_covers_every_parameter(workload, cache_dir):
    key = dict(ref_files=[workload["refs"]], ks=(12,), sketch_size=1000, max_samples=None,
               counter_size=1009, distinct_counter=False)
    paths = {common._panel_cache_path(**key)}
    for change in (dict(ks=(12, 16)), dict(sketch_size=500), dict(max_samples=2),
                   dict(distinct_counter=True), dict(ref_files=[workload["refs"]] * 2)):
        paths.add(common._panel_cache_path(**{**key, **change}))
    assert len(paths) == 6
    # counter_size keys the entry only with -I
    assert common._panel_cache_path(**{**key, "counter_size": 7}) == \
        common._panel_cache_path(**key)
    assert common._panel_cache_path(**{**key, "max_samples": 2, "counter_size": 7}) != \
        common._panel_cache_path(**{**key, "max_samples": 2})


def test_informative_and_filter_entries_across_packages(workload, cache_dir, monkeypatch):
    """stream -I and filter (distinct counter) write their own entries, and
    each package's entry is a hit for the other."""
    want_i = _jax(workload, max_samples=2, counter_size=1009)
    jax_filter_out = io.StringIO()
    assert jax_filter(JaxFilterConfig(ref_files=[workload["refs"]],
                                      read_files=[workload["reads"]], ks=(12,),
                                      sketch_size=1000, min_matches=5),
                      out=jax_filter_out) == 0
    assert len(_entries(cache_dir)) == 2
    _no_hashing(monkeypatch)
    assert _port(workload, max_samples=2, counter_size=1009) == want_i
    got = io.StringIO()
    assert port_filter(FilterConfig(ref_files=[workload["refs"]],
                                    read_files=[workload["reads"]], ks=(12,),
                                    sketch_size=1000, min_matches=5, device="cpu"),
                       out=got) == 0
    assert got.getvalue() == jax_filter_out.getvalue()
    assert len(_entries(cache_dir)) == 2
