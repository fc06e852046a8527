"""The least-bytes counts, against cases counted by hand."""

import pytest

from portbench import work


def test_base_bytes():
    assert work.base_bytes(0) == 0
    assert work.base_bytes(4) == 1
    assert work.base_bytes(5) == 2      # 10 bits -> 2 bytes
    assert work.base_bytes(150) == 38   # 300 bits


def test_entry_bytes():
    assert work.entry_bytes(1, 60) == 16       # 8-byte hash + 60 bits -> 8 bytes
    assert work.entry_bytes(10, 196) == 330    # 8 + 25 bytes each
    assert work.entry_bytes(3, 1) == 27


def test_stream_bytes():
    # 2 reads of 150 bp, 5 panel entries found over 60 refs, 7 counter slots
    assert work.stream_bytes(300, 5, 60, 2, 7) == 75 + 80 + 28 + 16


def test_hpv16_bytes():
    # 1 read of 1,000 bp, 4 entries over 196 columns, 14 groups
    assert work.hpv16_bytes(1000, 4, 196, 1, 14) == 250 + 132 + 64


def test_call_bytes():
    assert work.call_bytes(4000, 100, 9, 85) == 1000 + 25 + 108 + 680


def test_roofline_pct():
    assert work.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert work.roofline_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert work.roofline_pct(1, 0) is None
