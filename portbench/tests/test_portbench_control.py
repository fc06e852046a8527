"""The control, the reference with one of the hash's guarantees broken,
comes out not correct: at a tiny size here, at the cell's own size on the
card (``python -m pytest -m cuda portbench/tests`` on a GPU machine)."""

import pytest

from portbench import control, run
from portbench.tests.conftest import TINY_READS, tiny


@pytest.mark.parametrize("traffic", sorted(TINY_READS))
def test_control_fails_at_a_tiny_size(traffic, cache):
    cfg, tr = tiny(traffic)
    if traffic == "lineage":  # 32-bit collisions need a panel of some size
        cfg["types"], tr["reads"] = 182, 150
    r = control.control_reading(cfg, tr, 11, "cpu")
    assert r["lines_wrong"] > 0, r


@pytest.mark.cuda
@pytest.mark.parametrize("config,traffic", [("zika", "stream"), ("hpv16", "lineage"),
                                            ("zika", "stream_depth"), ("hpv16", "call")])
def test_control_fails_at_the_cells_size(config, traffic, card, cache):
    cfg = run.load_json(run.HERE, "configs", config + ".json")
    tr = run.load_json(run.HERE, "traffic", traffic + ".json")
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        assert control.control_reading(cfg, tr, seed, card)["lines_wrong"] > 0
