"""Numerical-debugging utilities (counterpart of
``pcaudio/utils/debugging.py``): NaNs in the backward, non-finite values in
a tree of tensors, and functions whose result changes between calls; and
the ``torch.distributed`` collectives a block of code issues (the JAX tests
read them from the compiled program's text)."""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Mapping, Optional, Tuple

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


COLLECTIVES = ("all_reduce", "broadcast", "reduce", "all_gather",
               "all_gather_into_tensor", "gather", "scatter", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "send", "recv", "isend", "irecv", "barrier")


@contextlib.contextmanager
def collective_calls(groups: Optional[Mapping[str, Any]] = None
                     ) -> Iterator[List[str]]:
    """Yields the list of the ``torch.distributed`` collectives called
    (through the module's functions) inside the block, in order, each as
    ``"<name>[:<op>]@<group>"``: the group's key in ``groups`` (matched by
    identity), ``world`` for the default group, else ``other``.  Calls made
    inside torch's C++ (DDP's gradient all-reduces) are not seen."""
    import torch.distributed as dist

    groups = groups or {}
    calls: List[str] = []
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def call(*args, **kwargs):
            op, group = kwargs.get("op"), kwargs.get("group")
            where = next((k for k, g in groups.items() if g is group),
                         "world" if group is None else "other")
            tag = name if op is None else f"{name}:{str(op).split('.')[-1]}"
            calls.append(f"{tag}@{where}")
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
