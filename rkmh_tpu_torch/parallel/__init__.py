"""Sharded modes on one host: a (dp, tp) grid of devices driven by one process.

Counterpart of ``rkmh_tpu/parallel/`` for ``--devices`` / ``--tp``:
``mesh.py`` (the grid, the tp-sharded panel and the sharded classify and
filter steps) and ``ep.py`` (the dp-sharded -M counter).
"""
