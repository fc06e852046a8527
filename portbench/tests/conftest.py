"""Shared fixtures of the benchmark's tests: tiny configurations for the CPU,
and ``card``, which skips a test unless a CUDA device is present (decided
when the test runs, never at import)."""

from __future__ import annotations

import os

import pytest

from portbench import run

os.environ.setdefault("RKMH_TPU_PANEL_CACHE", "0")  # no panel cache shared across tests

TINY_READS = {"stream": 1500, "stream_depth": 1500, "lineage": 40, "call": 200}


def tiny(traffic_name: str):
    """(config, traffic) of a cell cut to a CPU test's size: fewer reads, 20
    hpv16 types, a counter of 1,000,003 slots."""
    tr = run.load_json(run.HERE, "traffic", f"{traffic_name}.json")
    cfg_name = "hpv16" if tr["command"] in ("hpv16", "call") else "zika"
    cfg = run.load_json(run.HERE, "configs", f"{cfg_name}.json")
    cfg["counter_size"] = 1000003
    cfg["types"] = 20
    tr["reads"] = TINY_READS[traffic_name]
    return cfg, tr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The harness's cache directory in a temporary place."""
    monkeypatch.setattr(run, "CACHE", str(tmp_path / "cache"))
    return tmp_path / "cache"
