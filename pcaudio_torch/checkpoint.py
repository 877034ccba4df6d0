"""Checkpoints: the model zoo's weights across the two stacks (the port's
own copy of the mappings in ``pcaudio/checkpoint/torch_export.py`` and
``torch_import.py``), and the training checkpoints of
``pcaudio/checkpoint/orbax_io.py`` as ``torch.save`` files (save every N,
``latest_step``, resume).

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


def _array(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _mab(p: Mapping, prefix: str, out: StateDict) -> None:
    """One MAB; a flax ``LayerNorm``'s ``scale`` is torch's ``weight``."""
    for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
        _dense(p[name], f"{prefix}.{name}", out)
    for name in ("ln0", "ln1"):
        if name in p:
            out[f"{prefix}.{name}.weight"] = _array(p[name]["scale"])
            out[f"{prefix}.{name}.bias"] = _array(p[name]["bias"])


def _params(params: Any) -> Mapping:
    return params["params"] if "params" in params else params


def _isabs(p: Mapping, out: StateDict) -> None:
    for i, enc in enumerate(("enc_0", "enc_1")):
        out[f"enc.{i}.I"] = _array(p[enc]["I"])
        _mab(p[enc]["mab0"], f"enc.{i}.mab0", out)
        _mab(p[enc]["mab1"], f"enc.{i}.mab1", out)


def _pma(p: Mapping, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.S"] = _array(p["S"])
    _mab(p["mab"], f"{prefix}.mab", out)


def st_state_dict_from_jax(params: Any) -> StateDict:
    """Flax ``ST`` params (numpy leaves) → the port ``ST``'s state dict."""
    p = _params(params)
    out: StateDict = {}
    _isabs(p, out)
    _pma(p["dec_pma"], "dec.0", out)
    _dense(p["dec_out"], "dec.1", out)
    return out


def _encoder_layers(p: Mapping, prefix: str, out: StateDict) -> None:
    i = 0
    while f"enc_{i}" in p:
        _dense(p[f"enc_{i}"], f"{prefix}.Encoder_Layer_{i}", out)
        i += 1


def baseline_ff_state_dict_from_jax(params: Any) -> StateDict:
    """Flax ``BaselineFF`` params → the port ``BaselineFF``'s state dict."""
    p = _params(params)
    out: StateDict = {}
    _encoder_layers(p, "ENC_NN", out)
    _dense(p["code_linear"], "ENC_NN.Code_Linear", out)
    return out


def cnn_classifier_state_dict_from_jax(params: Any) -> StateDict:
    """Flax ``CNNClassifier`` params → the port ``CNNClassifier``'s state
    dict (the kernel is OIHW in both)."""
    p = _params(params)
    out: StateDict = {"cnn.weight": _array(p["cnn_kernel"]),
                      "cnn.bias": _array(p["cnn_bias"])}
    _encoder_layers(p, "linear", out)
    _dense(p["logits"], "linear.Logits", out)
    return out


def deepset_state_dict_from_jax(params: Any) -> StateDict:
    """Flax ``DeepSet`` params → the port ``DeepSet``'s state dict (the
    Linears sit at 0, 2, 4, 6 of each ``nn.Sequential``)."""
    p = _params(params)
    out: StateDict = {}
    for part in ("enc", "dec"):
        for i, j in enumerate((0, 2, 4, 6)):
            _dense(p[f"{part}_{i}"], f"{part}.{j}", out)
    return out


def set_transformer_state_dict_from_jax(params: Any) -> StateDict:
    """Flax ``SetTransformer`` params → the port ``SetTransformer``'s state
    dict; the ModelNet40 variant (no ``dec_sab_*``) has its PMA at
    ``dec.1``."""
    p = _params(params)
    out: StateDict = {}
    _isabs(p, out)
    if "dec_sab_0" in p:
        _pma(p["dec_pma"], "dec.0", out)
        for i in (0, 1):
            _mab(p[f"dec_sab_{i}"]["mab"], f"dec.{i + 1}.mab", out)
    else:
        _pma(p["dec_pma"], "dec.1", out)
    _dense(p["dec_out"], "dec.3", out)
    return out


def small_set_transformer_state_dict_from_jax(params: Any) -> StateDict:
    """Flax ``tasks.max_regression.SmallSetTransformer`` params (``sab0``,
    ``sab1``, ``pma``, ``out``) → the port's state dict (the same names)."""
    p = _params(params)
    out: StateDict = {}
    for name in ("sab0", "sab1"):
        _mab(p[name]["mab"], f"{name}.mab", out)
    _pma(p["pma"], "pma", out)
    _dense(p["out"], "out", out)
    return out


def small_deepset_state_dict_from_jax(params: Any) -> StateDict:
    """Flax ``tasks.max_regression.SmallDeepSet`` params (flax's automatic
    names ``Dense_0``-``Dense_3``) → the port's ``enc.{0,2}``,
    ``dec.{0,2}``."""
    p = _params(params)
    out: StateDict = {}
    for i, name in enumerate(("enc.0", "enc.2", "dec.0", "dec.2")):
        _dense(p[f"Dense_{i}"], name, out)
    return out


def load_reference_pth(path: str) -> StateDict:
    """Load a reference ``.pth`` state dict, ``module.`` prefix stripped."""
    sd = torch.load(path, map_location="cpu")
    return {k.removeprefix("module."): v for k, v in sd.items()}


_HF_AST = "audio_spectrogram_transformer."
# per encoder layer: the port's name, then transformers' under
# ``encoder.layer.<i>.``
_HF_AST_LAYER = (("ln1", "layernorm_before"), ("proj", "attention.output.dense"),
                 ("ln2", "layernorm_after"), ("fc1", "intermediate.dense"),
                 ("fc2", "output.dense"))


def ast_state_dict_from_hf(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """``transformers``' ``ASTForAudioClassification`` state dict → the
    port ``AST``'s (``nn/ast.py``): the patch convolution's ``[D, 1, 16,
    16]`` kernel as the patch Linear's ``[D, 256]`` weight (``(f, t)``
    flattened), the query, key and value Linears stacked into the fused
    ``qkv`` (in that order), and the other names mapped one to one."""
    e = _HF_AST + "embeddings."
    out: StateDict = {
        "patch.weight": sd[e + "patch_embeddings.projection.weight"].flatten(1).clone(),
        "patch.bias": sd[e + "patch_embeddings.projection.bias"].clone(),
        "cls_token": sd[e + "cls_token"].clone(),
        "dist_token": sd[e + "distillation_token"].clone(),
        "pos": sd[e + "position_embeddings"].clone(),
    }
    i = 0
    while f"{_HF_AST}encoder.layer.{i}.attention.attention.query.weight" in sd:
        hf = f"{_HF_AST}encoder.layer.{i}."
        att = hf + "attention.attention."
        for kind in ("weight", "bias"):
            out[f"blocks.{i}.qkv.{kind}"] = torch.cat(
                [sd[f"{att}{n}.{kind}"] for n in ("query", "key", "value")])
            for port, theirs in _HF_AST_LAYER:
                out[f"blocks.{i}.{port}.{kind}"] = sd[f"{hf}{theirs}.{kind}"].clone()
        i += 1
    for port, theirs in (("norm", _HF_AST + "layernorm"), ("head_norm", "classifier.layernorm"),
                         ("head", "classifier.dense")):
        for kind in ("weight", "bias"):
            out[f"{port}.{kind}"] = sd[f"{theirs}.{kind}"].clone()
    return out


def export_reference_pth(model: torch.nn.Module, path: str,
                         config: ExperimentConfig) -> None:
    """Write ``model``'s weights as a reference-convention ``.pth`` of
    ``config``'s architecture: the reference names, with the
    ``nn.DataParallel`` ``module.`` prefix that the reference's set
    transformer checkpoints (FST, 3ST) carry and its baselines' (FB,
    CNN_temp) do not."""
    prefix = "module." if config.is_set_model else ""
    torch.save({prefix + k: v.detach().cpu()
                for k, v in model.state_dict().items()}, path)


def save_checkpoint(directory: str, state, config: Optional[ExperimentConfig]
                    = None, *, step: int) -> str:
    """Save a train state (model state dict under the reference names,
    optimizer state, ``state.step``, and the dropout generator's state when
    the state has a generator) as ``directory/step_<step>.pt``, and the
    reference-schema config sidecar.  Saving a step twice overwrites."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    tree = {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": step, "train_steps": state.step}
    if state.generator is not None:
        tree["generator"] = state.generator.get_state()
    torch.save(tree, tmp)
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
    ``optimizer``, ``step``, ``train_steps`` and, where the run had one,
    the dropout ``generator``'s state."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    tree = torch.load(os.path.join(directory, f"step_{step}.pt"),
                      map_location=map_location)
    return tree, step
