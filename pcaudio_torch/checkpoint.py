"""ST weights across the two stacks (the ST parts of
``pcaudio/checkpoint/torch_export.py`` and ``torch_import.py``).

The port's modules keep the reference's parameter names, so a reference
``.pth`` needs no importer: strip the ``nn.DataParallel`` ``module.`` prefix
and call ``load_state_dict``.  Flax trees come in as nested dicts of numpy
arrays (``np.asarray`` of every leaf); a flax ``Dense`` kernel is ``[in, out]``
and a torch ``Linear`` weight ``[out, in]``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _dense(p: Mapping, prefix: str, out: StateDict) -> None:
    out[prefix + ".weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(p["kernel"]).T))
    out[prefix + ".bias"] = torch.from_numpy(np.array(p["bias"]))


def _mab(p: Mapping, prefix: str, out: StateDict) -> None:
    for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
        _dense(p[name], f"{prefix}.{name}", out)


def st_state_dict_from_jax(params: Any) -> StateDict:
    """Flax ``ST`` params (numpy leaves) → the port ``ST``'s state dict."""
    p = params["params"] if "params" in params else params
    out: StateDict = {}
    for i, enc in enumerate(("enc_0", "enc_1")):
        out[f"enc.{i}.I"] = torch.from_numpy(np.array(p[enc]["I"]))
        _mab(p[enc]["mab0"], f"enc.{i}.mab0", out)
        _mab(p[enc]["mab1"], f"enc.{i}.mab1", out)
    out["dec.0.S"] = torch.from_numpy(np.array(p["dec_pma"]["S"]))
    _mab(p["dec_pma"]["mab"], "dec.0.mab", out)
    _dense(p["dec_out"], "dec.1", out)
    return out


def load_reference_pth(path: str) -> StateDict:
    """Load a reference ``.pth`` state dict, ``module.`` prefix stripped."""
    sd = torch.load(path, map_location="cpu")
    return {k.removeprefix("module."): v for k, v in sd.items()}
