"""``stream --dist-*``'s merged stripes are, by contract, one process's
``stream`` output: the plain reference of ``stream`` (``stream.py`` here)
with the same flags."""

from __future__ import annotations

from portbench.reference import stream


def expected(inputs: dict, cfg: dict, traffic: dict, device, **hash_kw):
    """-> (the output text, the least bytes of one job's device work)."""
    return stream.expected(inputs, cfg, traffic, device, **hash_kw)
