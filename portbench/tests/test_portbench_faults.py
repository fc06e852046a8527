"""A run with the timed path broken underneath comes out not correct: the
harness as a GPU run drives it, past its look for a card, on the CPU at a tiny
size, once for each fault a cell can have (one card: no exchange between
cards to leave out)."""

import pytest

from portbench import run
from portbench.tests.conftest import tiny
from rkmh_tpu_torch import call_engine
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands import call_cmd, common, stream
from rkmh_tpu_torch.ops.counter import HashCounter


def _run(traffic):
    cfg, tr = tiny(traffic)
    return run.run_cell(cfg, tr, 4242, 0.0, False, [], "cpu", 0.0)


def _alter_stream(monkeypatch):
    orig = engine.classify_codes_table

    def altered(codes, panel, *a, **kw):
        res = orig(codes, panel, *a, **kw).clone()
        res[1, 0] += 1  # read 0's shared count, as the step produced it
        return res

    monkeypatch.setattr(engine, "classify_codes_table", altered)


def _alter_hpv16(monkeypatch):
    orig = engine.hpv16_batch_comb

    def altered(*a, **kw):
        res = orig(*a, **kw).clone()
        res[0, 1] += 1  # read 0's shared count with its type
        return res

    monkeypatch.setattr(engine, "hpv16_batch_comb", altered)


def _alter_call(monkeypatch):
    orig = call_engine.call_scan_ref

    def altered(*a, **kw):
        res = dict(orig(*a, **kw))
        res["avg"] = res["avg"] + 1  # the window averages, as the scan produced them
        return res

    monkeypatch.setattr(call_engine, "call_scan_ref", altered)


ALTER = {"stream": _alter_stream, "stream_depth": _alter_stream, "lineage": _alter_hpv16,
         "call": _alter_call}


@pytest.mark.parametrize("traffic", sorted(ALTER))
def test_answer_altered_where_produced(traffic, cache, monkeypatch):
    ALTER[traffic](monkeypatch)
    out = _run(traffic)
    assert not out["correct"] and out["checks"]["lines_wrong"]["value"] > 0


def _half(batches):
    def half(*a, **kw):
        for rows, codes, lens in batches(*a, **kw):
            n = max(1, len(rows) // 2)
            yield rows[:n], codes[:n], lens[:n]

    return half


@pytest.mark.parametrize("traffic", ["stream", "stream_depth", "lineage", "call"])
def test_half_of_each_batch_left_out(traffic, cache, monkeypatch):
    monkeypatch.setattr(common, "bucketed_batches", _half(common.bucketed_batches))
    monkeypatch.setattr(call_cmd, "bucketed_batches", _half(call_cmd.bucketed_batches))
    out = _run(traffic)
    assert not out["correct"]


def test_counter_state_left_unchanged(cache, monkeypatch):
    """stream -M's counter pass returns its counter as it was made: empty."""
    def untouched(chunks, ks, counter_size, batch_size, device, dpc=None):
        for _ in chunks:
            pass
        return HashCounter(counter_size, device)

    monkeypatch.setattr(stream, "count_read_kmers", untouched)
    out = _run("stream_depth")
    assert not out["correct"] and out["checks"]["lines_wrong"]["value"] > 0


def test_job_that_raises_is_a_failure(cache, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(engine, "classify_codes_table", boom)
    with pytest.raises(RuntimeError):  # the warm job in set-up: no result at all
        _run("stream")
