"""rkmh-tpu-torch: the rkmh-tpu MinHash read classifier on PyTorch and CUDA.

A second package beside ``rkmh_tpu`` (the JAX reference).  It mirrors
``rkmh_tpu``'s module names, so each module's counterpart is found under
the same path there.  It imports ``torch`` and numpy and never ``jax``;
importing it has no side effects.

Conventions:

* hashes travel as int64 bit patterns and panel-table lanes as int32 bit
  patterns (torch's unsigned types lack ``>>``, ``<``, ``max`` and
  ``sort``); the CUDA kernels reinterpret the bits as uint64/uint32;
* the device is explicit (``device=`` / ``--device``, ``cuda`` by
  default) and a missing GPU is an error, never a silent CPU run;
* every kernel (``csrc/``) has a plain PyTorch version beside its wrapper;
  the wrapper takes the plain version only for CPU tensors.
"""

__version__ = "0.1.0"
