"""Parameter counting and display (counterpart of ``pcaudio/utils/params.py``;
reference ``Code/utils.py:7-20``, minus the prettytable dependency)."""
from __future__ import annotations

from typing import List, Tuple

import torch


def named_parameters(model: torch.nn.Module) -> List[Tuple[str, int]]:
    """``(name, size)`` of each trainable parameter, under torch's dotted
    names (``enc.0.mab0.fc_q.weight``)."""
    return [(name, p.numel()) for name, p in model.named_parameters()
            if p.requires_grad]


def count_parameters(model: torch.nn.Module, display: bool = True) -> int:
    """Print a per-parameter table and return the trainable-parameter total,
    the reference's ``count_parameters`` contract.  For the same
    architecture the total equals the JAX function's on the flax params."""
    rows = named_parameters(model)
    total = sum(n for _, n in rows)
    if display:
        width = max((len(n) for n, _ in rows), default=7)
        print(f"{'Modules'.ljust(width)} | Parameters")
        print("-" * (width + 13))
        for name, n in rows:
            print(f"{name.ljust(width)} | {n}")
        print(f"Total Trainable Params: {total}")
    return total
