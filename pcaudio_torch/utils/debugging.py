"""Numerical-debugging utilities (counterpart of
``pcaudio/utils/debugging.py``): NaNs in the backward, non-finite values in
a tree of tensors, and functions whose result changes between calls."""
from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn on autograd's anomaly detection, the nearest counterpart of
    JAX's NaN checker: a backward that makes a NaN raises and names the
    forward op whose backward made it.  It does not look at the forward's
    values: check those with :func:`assert_finite_tree`."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of nested dicts (a state dict too), lists and tuples;
    a dict key is its ``str``, a sequence index ``[i]``, as JAX's key
    paths print."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first leaf (tensor, array or
    number) that holds a non-finite value, its path, how many values are
    non-finite, and its shape."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            finite = torch.isfinite(leaf.detach())
            bad, shape = int((~finite).sum()), tuple(leaf.shape)
        else:
            arr = np.asarray(leaf)
            bad, shape = int((~np.isfinite(arr)).sum()), arr.shape
        if bad:
            raise FloatingPointError(
                f"{name}{'/' + path if path else ''}: {bad} non-finite values "
                f"(shape {shape})")


def check_jit_purity(fn, *args, atol: float = 0.0) -> bool:
    """Call ``fn(*args)`` twice and say whether the outputs agree (every
    leaf within ``atol``).  Eager PyTorch traces nothing, so the hazard the
    JAX check names (Python-side state read once, while tracing) shows here
    as state that changes between calls; the name is kept so that callers
    of either package find the check."""
    a = [leaf for _, leaf in _leaves(fn(*args))]
    b = [leaf for _, leaf in _leaves(fn(*args))]
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if x.shape != y.shape or not np.allclose(x, y, atol=atol, rtol=0):
            return False
    return True
