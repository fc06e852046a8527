"""The VW model layer on PyTorch: counterpart of ``rkmh_tpu/ml``.

``wabbit`` trains and applies feature-hashed linear models over VW example
lines (the ``rkmh-tpu-torch-wabbit`` console script), its margins and
their gradient on the card through K12 (``ops/sparse_margin.py``);
``vw_model`` reads and applies vw's own binary models on the host.
"""
