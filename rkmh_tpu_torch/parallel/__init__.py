"""Sharded modes: a (dp, tp) grid of devices driven by one process, and
a group of such processes.

Counterpart of ``rkmh_tpu/parallel/`` for ``--devices`` / ``--tp``:
``mesh.py`` (the grid, the tp-sharded panels and the sharded classify,
filter, hpv16 and call steps), ``ep.py`` (the dp-sharded -M counter) and
``sp.py`` (long genomes sketched in chunks over the grid); for
``--dist-*``: ``distributed.py`` (the process group and its collectives).
"""
