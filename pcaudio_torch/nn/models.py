"""The ST classifier (counterpart of ``pcaudio/nn/models.py::ST``).

``enc`` = ISAB × 2 and ``dec`` = PMA → Linear, held in ``nn.Sequential``s so
the parameter names are the reference's (``enc.0.mab0.fc_q.weight`` …,
``Code/models.py:13-44``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pcaudio_torch.nn.attention import ISAB, PMA


class ST(nn.Module):
    """Set Transformer classifier.

    Output is ``[B, dim_output]`` when ``num_outputs == 1`` (the reference's
    ``.squeeze()``), else ``[B, num_outputs, dim_output]``.
    ``fused_attn=True`` runs every attend through kernel K4 (training).
    """

    def __init__(self, dim_input: int = 2, num_outputs: int = 1,
                 dim_output: int = 10, num_inds: int = 4, dim_hidden: int = 4,
                 num_heads: int = 2, fused_attn: bool = False):
        super().__init__()
        self.num_outputs = num_outputs
        self.num_heads = num_heads
        self.enc = nn.Sequential(
            ISAB(dim_input, dim_hidden, num_heads, num_inds, fused_attn),
            ISAB(dim_hidden, dim_hidden, num_heads, num_inds, fused_attn),
        )
        self.dec = nn.Sequential(
            PMA(dim_hidden, num_heads, num_outputs, fused_attn),
            nn.Linear(dim_hidden, dim_output),
        )

    def forward(self, X: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.enc[0](X, mask)
        x = self.enc[1](x, mask)
        x = self.dec[1](self.dec[0](x, mask))
        if self.num_outputs == 1:
            x = x[:, 0, :]
        return x
