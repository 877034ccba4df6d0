"""The model zoo (counterpart of ``pcaudio/nn/models.py``): the paper's ST
classifier, its two baselines, and the generic DeepSet and SetTransformer.

Parameter names are the reference's, held in ``nn.Sequential``s, so a
reference state dict loads with ``load_state_dict``:

  * ``ST``: ``enc.{0,1}`` ISABs, ``dec.0`` PMA, ``dec.1`` Linear
    (``Code/models.py:13-44``);
  * ``BaselineFF``: ``ENC_NN.Encoder_Layer_{i}``, ``ENC_NN.Code_Linear``
    (``Code/models.py:47-88``);
  * ``CNNClassifier``: ``cnn``, ``linear.Encoder_Layer_{i}``,
    ``linear.Logits`` (``Code/models.py:91-119``);
  * ``DeepSet``: ``enc.{0,2,4,6}``, ``dec.{0,2,4,6}``
    (``set_transformer-master/models.py:3-28``);
  * ``SetTransformer``: ``enc.{0,1}``, ``dec.{0..3}``
    (``set_transformer-master/models.py:30-44``; the ModelNet40 variant of
    ``main_pointcloud.py:13-37`` with dropouts at ``dec.0`` and ``dec.2``).

Dropout draws its mask from the ``torch.Generator`` the caller passes
(``generator=``), never from the global RNG, and only in training mode
(``model.train()``); a training-mode forward that would drop without a
generator raises.  The masks cannot match ``jax.random``'s.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch
from torch import nn

from pcaudio_torch.nn.attention import ISAB, PMA, SAB


class Dropout(nn.Module):
    """Inverted dropout with an explicit generator: each element is kept
    with probability ``1 - p`` and scaled by ``1 / (1 - p)``; the identity
    in eval mode."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p={p} outside [0, 1)")
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode draws its mask from a "
                             "torch.Generator: pass generator= or call "
                             ".eval()")
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.p
        return x * keep / (1.0 - self.p)


def _mlp(layer_dims: Sequence[int], nclass: int, last: str) -> nn.Sequential:
    """``Encoder_Layer_{i}`` Linear + LeakyReLU(0.01) over ``layer_dims``,
    then the Linear ``last`` to ``nclass`` logits."""
    layers = OrderedDict()
    for i, (fi, fo) in enumerate(zip(layer_dims[:-1], layer_dims[1:])):
        layers[f"Encoder_Layer_{i}"] = nn.Linear(fi, fo)
        layers[f"Activation_{i}"] = nn.LeakyReLU(0.01)
    layers[last] = nn.Linear(layer_dims[-1], nclass)
    return nn.Sequential(layers)


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


class BaselineFF(nn.Module):
    """The framewise feed-forward baseline: input dropout ("emulate rand
    sampling", ``Code/models.py:60``), Linear + LeakyReLU over
    ``layer_dims`` (input dim first, e.g. ``(1025, 513, 256)``), a Linear to
    ``nclasses``, then a softmax.  The reference trains the softmaxed output
    through ``CrossEntropyLoss`` (a double softmax, ``Code/models.py:75``);
    this module keeps that softmax, and ``ENC_NN`` gives the logits before
    it."""

    def __init__(self, layer_dims: Sequence[int], nclasses: int = 10,
                 p: float = 0.5):
        super().__init__()
        self.drop = Dropout(p)
        self.ENC_NN = _mlp(layer_dims, nclasses, "Code_Linear")

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x [B, layer_dims[0]]`` → ``[B, nclasses]``."""
        return torch.softmax(self.ENC_NN(self.drop(x, generator)), dim=-1)


class CNNClassifier(nn.Module):
    """The temporal CNN baseline on ``[B, Nt, Nf]`` log-spectrogram chunks:
    input dropout, one 1 → 1-channel convolution with kernel ``(Nt, Nf + 1 -
    layer_dims[0])`` (``(10, 1)`` in the recipe) that collapses time into
    ``layer_dims[0]`` features, then Linear + LeakyReLU layers and the
    logits.

    The convolution is computed as a contraction of the input's windows
    with the kernel (a matrix product), not by ``F.conv2d``: cuDNN runs
    convolutions in TF32 under ``torch.backends.cudnn.allow_tf32``, which
    is on by default, while matrix products stay f32 unless
    ``torch.backends.cuda.matmul.allow_tf32`` is set, as the Linear layers
    do."""

    def __init__(self, Nt: int, Nf: int, layer_dims: Sequence[int],
                 nclass: int = 10, p: float = 0.5):
        super().__init__()
        kw = Nf + 1 - layer_dims[0]
        if kw < 1:
            raise ValueError(f"layer_dims[0]={layer_dims[0]} exceeds Nf={Nf}")
        self.drop = Dropout(p)
        self.cnn = nn.Conv2d(1, 1, (Nt, kw))
        self.linear = _mlp(layer_dims, nclass, "Logits")

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution, ``[B, Nt, Nf]`` → ``[B, layer_dims[0]]`` in f32."""
        w = self.cnn.weight[0, 0]                                 # [Nt, kw]
        windows = x.unfold(2, w.shape[1], 1)                      # [B, Nt, W, kw]
        return torch.einsum("btws,ts->bw", windows, w) + self.cnn.bias

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(self.conv(self.drop(x, generator)))


class DeepSet(nn.Module):
    """DeepSets: a per-point MLP, a masked mean over the set, an MLP →
    ``[B, num_outputs, dim_output]``."""

    def __init__(self, dim_input: int, num_outputs: int, dim_output: int,
                 dim_hidden: int = 128):
        super().__init__()
        self.num_outputs = num_outputs
        self.dim_output = dim_output

        def mlp(din, dout):
            return nn.Sequential(
                nn.Linear(din, dim_hidden), nn.ReLU(),
                nn.Linear(dim_hidden, dim_hidden), nn.ReLU(),
                nn.Linear(dim_hidden, dim_hidden), nn.ReLU(),
                nn.Linear(dim_hidden, dout))

        self.enc = mlp(dim_input, dim_hidden)
        self.dec = mlp(dim_hidden, num_outputs * dim_output)

    def forward(self, X: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.enc(X)
        if mask is None:
            x = x.mean(dim=-2)
        else:
            m = mask[..., None].to(x.dtype)
            x = (x * m).sum(dim=-2) / m.sum(dim=-2).clamp_min(1.0)
        return self.dec(x).reshape(-1, self.num_outputs, self.dim_output)


class SetTransformer(nn.Module):
    """The generic Set Transformer: ISAB × 2, then PMA → SAB × 2 → Linear
    (``[B, num_outputs, dim_output]``).

    ``pointcloud_variant=True`` is the ModelNet40 classifier instead:
    Dropout → PMA → Dropout → Linear, squeezed to ``[B, dim_output]`` when
    ``num_outputs == 1``."""

    def __init__(self, dim_input: int, num_outputs: int, dim_output: int,
                 num_inds: int = 32, dim_hidden: int = 128,
                 num_heads: int = 4, ln: bool = False,
                 pointcloud_variant: bool = False, dropout_rate: float = 0.5):
        super().__init__()
        self.num_outputs = num_outputs
        self.pointcloud_variant = pointcloud_variant
        self.enc = nn.Sequential(
            ISAB(dim_input, dim_hidden, num_heads, num_inds, ln=ln),
            ISAB(dim_hidden, dim_hidden, num_heads, num_inds, ln=ln))
        pma = PMA(dim_hidden, num_heads, num_outputs, ln=ln)
        out = nn.Linear(dim_hidden, dim_output)
        if pointcloud_variant:
            self.dec = nn.Sequential(Dropout(dropout_rate), pma,
                                     Dropout(dropout_rate), out)
        else:
            self.dec = nn.Sequential(pma,
                                     SAB(dim_hidden, dim_hidden, num_heads, ln=ln),
                                     SAB(dim_hidden, dim_hidden, num_heads, ln=ln),
                                     out)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.enc[1](self.enc[0](X, mask), mask)
        if self.pointcloud_variant:
            x = self.dec[0](x, generator)
            x = self.dec[2](self.dec[1](x, mask), generator)
            x = self.dec[3](x)
            return x[:, 0, :] if self.num_outputs == 1 else x
        x = self.dec[0](x, mask)
        return self.dec[3](self.dec[2](self.dec[1](x)))
