"""Seeded weights for the ST classifier, made on the device in one draw.

Names and shapes are the reference's (``Code/models.py:13-44`` over
``set_transformer-master/modules.py``), so the same dict loads into the
port's ``ST`` with ``load_state_dict`` and feeds the plain reference.  The
scales are PyTorch's defaults for the same modules: a Linear's weight and
bias uniform in ±1/sqrt(fan_in), the inducing points and seeds
Xavier-uniform.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch


def derived_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws of a run (weights, traffic,
    ...), mixed from the run's ``--seed`` by ``np.random.SeedSequence``."""
    s = int(seed) % (1 << 64)
    words = [s & 0xFFFFFFFF, s >> 32, *stream]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def _linear(prefix: str, d_in: int, d_out: int) -> List[Tuple[str, tuple, float]]:
    b = 1.0 / math.sqrt(d_in)
    return [(prefix + ".weight", (d_out, d_in), b), (prefix + ".bias", (d_out,), b)]


def _mab(prefix: str, dim_q: int, dim_k: int, dim_v: int):
    return (_linear(prefix + ".fc_q", dim_q, dim_v) + _linear(prefix + ".fc_k", dim_k, dim_v)
            + _linear(prefix + ".fc_v", dim_k, dim_v) + _linear(prefix + ".fc_o", dim_v, dim_v))


def st_shapes(dim_input: int, dim_hidden: int, num_inds: int, num_classes: int,
              num_outputs: int = 1) -> List[Tuple[str, tuple, float]]:
    """``(name, shape, uniform bound)`` of every ST parameter."""
    h, m = dim_hidden, num_inds
    out = []
    for i, d_in in enumerate((dim_input, dim_hidden)):
        out.append((f"enc.{i}.I", (1, m, h), math.sqrt(6.0 / (m * h + h))))
        out += _mab(f"enc.{i}.mab0", h, d_in, h)
        out += _mab(f"enc.{i}.mab1", d_in, h, h)
    out.append(("dec.0.S", (1, num_outputs, h),
                math.sqrt(6.0 / (num_outputs * h + h))))
    out += _mab("dec.0.mab", h, h, h)
    out += _linear("dec.1", h, num_classes)
    return out


def st_state_dict(seed: int, model_cfg: dict, device) -> Dict[str, torch.Tensor]:
    """The ST's f32 parameters for ``model_cfg`` (``dim_input``,
    ``dim_hidden``, ``num_inds``, ``num_classes``) from ``seed``: one draw
    of uniform numbers on ``device``, cut and scaled."""
    shapes = st_shapes(model_cfg["dim_input"], model_cfg["dim_hidden"],
                       model_cfg["num_inds"], model_cfg["num_classes"])
    total = sum(math.prod(s) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = OrderedDict(), 0
    for name, shape, bound in shapes:
        n = math.prod(shape)
        out[name] = (u[at: at + n] * bound).reshape(shape).clone()
        at += n
    return out


def standardize_output(params: Dict[str, torch.Tensor], clouds: torch.Tensor,
                       heads: int) -> None:
    """Scale and shift the output layer in place so that each class's logit
    has mean 0 and variance 1 over ``clouds`` (the plain reference's
    forward): a seeded ST left as drawn names one class for nearly every
    input, and accuracies of 0 or 1 would tell a right count from a wrong
    one on nothing."""
    from pcbench.reference.st import st_forward_blocks

    logits = st_forward_blocks(params, clouds, None, heads)
    mean, std = logits.mean(0), logits.std(0).clamp_min(1e-12)
    params["dec.1.weight"].div_(std[:, None])
    params["dec.1.bias"].sub_(mean).div_(std)
