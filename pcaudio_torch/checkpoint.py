"""Checkpoints: ST weights across the two stacks (the ST parts of
``pcaudio/checkpoint/torch_export.py`` and ``torch_import.py``), and the
training checkpoints of ``pcaudio/checkpoint/orbax_io.py`` as ``torch.save``
files (save every N, ``latest_step``, resume).

The port's modules keep the reference's parameter names, so a reference
``.pth`` needs no importer: strip the ``nn.DataParallel`` ``module.`` prefix
and call ``load_state_dict``.  Flax trees come in as nested dicts of numpy
arrays (``np.asarray`` of every leaf); a flax ``Dense`` kernel is ``[in, out]``
and a torch ``Linear`` weight ``[out, in]``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from pcaudio_torch.core.config import ExperimentConfig

StateDict = Dict[str, torch.Tensor]
CONFIG_FILE = "reference_config.json"
_STEP_FILE = re.compile(r"step_(\d+)\.pt")


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


def export_reference_pth(model: torch.nn.Module, path: str) -> None:
    """Write ``model``'s weights as a reference-convention ``.pth``: the
    reference names with the ``nn.DataParallel`` ``module.`` prefix that
    the reference FST/3ST checkpoints carry."""
    torch.save({f"module.{k}": v.detach().cpu()
                for k, v in model.state_dict().items()}, path)


def save_checkpoint(directory: str, state, config: Optional[ExperimentConfig]
                    = None, *, step: int) -> str:
    """Save a train state (model state dict under the reference names,
    optimizer state, ``state.step``) as ``directory/step_<step>.pt``, and
    the reference-schema config sidecar.  Saving a step twice overwrites."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": step, "train_steps": state.step}, tmp)
    os.replace(tmp, path)
    if config is not None:
        with open(os.path.join(directory, CONFIG_FILE), "w") as f:
            json.dump(config.to_reference_json(), f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_FILE.fullmatch,
                                           os.listdir(directory)) if m]
    return max(steps) if steps else None


def load_checkpoint(directory: str, map_location="cpu"
                    ) -> Tuple[Dict[str, Any], int]:
    """Restore the latest ``(tree, step)``; ``tree`` holds ``model``,
    ``optimizer``, ``step`` and ``train_steps``."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    tree = torch.load(os.path.join(directory, f"step_{step}.pt"),
                      map_location=map_location)
    return tree, step
