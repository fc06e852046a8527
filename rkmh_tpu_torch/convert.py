"""Carry a panel built by the JAX package over to the port without a rebuild.

``rkmh_tpu``'s ``RefPanel`` holds uint64 sketches and a uint32 bucket
table; as numpy arrays they become the port's ``RefPanel`` by
reinterpreting the bits as int64 and int32.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.commands.common import RefPanel
from rkmh_tpu_torch.ops.lookup import table_slots


def panel_from_numpy(keys, sketches_u64, lens, table_u32, device) -> RefPanel:
    """(names, [R, s] uint64 sketches, [R] lengths, [NB, width] uint32
    table) -> RefPanel on ``device``."""
    sk = np.array(sketches_u64, dtype=np.uint64).view(np.int64)  # own, writable copies
    table = np.array(table_u32, dtype=np.uint32).view(np.int32)
    table_slots(table.shape[1], len(keys))  # raises on a foreign layout
    return RefPanel(
        keys,
        torch.from_numpy(sk).to(device),
        torch.from_numpy(np.array(lens, dtype=np.int32)).to(device),
        torch.from_numpy(table).to(device),
    )
