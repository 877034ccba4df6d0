"""Timing on the card, shared by the probes and ``chip_smoke.py``: the card's
name and power limit, CUDA-event timing, the least time the card could take
for a given amount of work, and the measurement of one probe case (kernel
vs its plain version, and a library call where one computes the same
function).  Nothing here runs without an NVIDIA GPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess
from typing import Callable, Dict, Optional, Tuple

import torch

# One H100 SXM at its 700 W limit, dense (NVIDIA's data sheet; "tf32" the
# tensor cores' TF32 rate).  "sfu": 132 SMs x 16 MUFU results a clock
# (NVIDIA's CUDA arithmetic-instruction throughput table for compute
# capability 9.0) x 1.98 GHz boost, for exp.
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12,
                  "sfu": 132 * 16 * 1.98e9}
HBM_BYTES_PER_S = 3.35e12
# Tensor-core operations a clock an SM (dense).  The data sheet's tensor
# rates are these x 132 SMs at 1.83 GHz, while its f32 rate (and "sfu")
# take the 1.98 GHz boost: a tensor kernel that the card runs above 1.83
# GHz can beat the rate of its bound_ms.  tensor_bound_ms is the bound at
# the SM clock measured under the kernel.
TENSOR_OPS_PER_CLOCK = {"bf16": 4096, "int8": 8192, "tf32": 2048}


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def tf32_off():
    """Plain f32 products in full f32 on the card, as the references are."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class SortCalls(torch.overrides.TorchFunctionMode):
    """Counts the sorts and top-Ks (``sort``, ``argsort``, ``msort``,
    ``topk``, ``kthvalue``, as functions or methods) called on CUDA tensors
    while it is active, by name in ``calls``: a path that must select with
    a kernel alone shows none."""

    NAMES = ("sort", "argsort", "msort", "topk", "kthvalue")

    def __init__(self):
        super().__init__()
        self.calls: Dict[str, int] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.NAMES and any(isinstance(a, torch.Tensor) and a.is_cuda
                                      for a in args):
            self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after one warm-up,
    between two CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs an NVIDIA GPU")
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters: int, plain_iters: int):
    """plain, kernel, kernel, plain in one process on one card; returns
    ``(kernel ms, plain ms)``, each the mean of its two turns."""
    p0 = cuda_ms(plain, plain_iters)
    k0 = cuda_ms(kernel, iters)
    k1 = cuda_ms(kernel, iters)
    p1 = cuda_ms(plain, plain_iters)
    return (k0 + k1) / 2, (p0 + p1) / 2


def profile_device(fn, iters: int):
    """``torch.profiler`` over ``iters`` calls of ``fn`` after one warm-up:
    returns ``({kernel name: device ms per call}, idle share)``, the names
    by falling time, the idle share over the window from the first device
    activity's start to the last one's end, busy where any device activity
    runs (copies on another stream overlap kernels).  Raises where the
    trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = device_events(prof.events())
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    per: Dict[str, float] = {}
    for e in dev:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    return (dict(sorted(per.items(), key=lambda kv: -kv[1])),
            1.0 - busy_time(spans) / span)


def device_events(events):
    """The device activity among a profile's events: kernels and copies,
    without the ranges of user annotations (``Optimizer.step#Adam.step``),
    which the profiler also places on the device's timeline and which span
    kernels already counted."""
    from torch.autograd import DeviceType

    events = list(events)
    # a device range mirrors a host-side annotation of the same name
    notes = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in notes]


def busy_time(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


def bound_ms(ops: Dict[str, float], nbytes: float):
    """The least time the card could take for the work: the larger of the
    bytes over the memory rate (each input read once, each output written
    once) and the operations over their type's peak (types run on separate
    units, so the slowest type).  Returns ``(ms, "bytes" | "operations")``."""
    t_ops = max((n / PEAK_OPS_PER_S[k] for k, n in ops.items()), default=0.0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def tensor_bound_ms(ops: float, kind: str, sm_mhz: float, sms: int) -> float:
    """The least ms for ``ops`` tensor-core operations of ``kind`` on
    ``sms`` SMs held at ``sm_mhz`` MHz."""
    return ops / (TENSOR_OPS_PER_CLOCK[kind] * sms * sm_mhz * 1e6) * 1e3


def abs_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|got − ref| in f32, 0 where the two are equal (infinities included)."""
    got, ref = got.float(), ref.float()
    return torch.where(got == ref, torch.zeros_like(ref), (got - ref).abs())


@dataclasses.dataclass
class Case:
    """One probe measurement: a kernel call, its plain version, the bound on
    their elementwise difference (a function of the plain output; 0 means
    exact), the work it does, and optionally a library call computing the
    same function.  ``check``, where given, is a (kernel, plain) pair on
    other inputs that the comparison uses instead: for a probe whose timed
    inputs make every output the same (the lane-width chains decay to 0 or
    overflow to +inf), so that the comparison still tells a right kernel
    from a wrong one."""

    name: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    bound: Callable[[torch.Tensor], object]
    wrapper: Callable            # the kernel's wrapper (its launch count)
    source: str
    replaces: str
    instruction: str
    ops: Dict[str, float]
    nbytes: float
    library: Optional[Callable[[], object]] = None
    library_note: str = ""
    iters: int = 10
    plain_iters: int = 2
    check: Optional[Tuple[Callable[[], torch.Tensor], Callable[[], torch.Tensor]]] = None
    args: tuple = ()  # the kernel call's operands and shape, for another design
    check_args: tuple = ()  # the check's kernel calls' operands, a tuple each


def measure(case: Case) -> dict:
    """Time kernel and plain in turns, counting the kernel's launches from
    0, and the library call; then hold the kernel against its plain version
    (on ``case.check``'s inputs where given; raises outside the bound, or
    where the plain output is not finite or is all zero, which no kernel
    could be told apart on; these launches are not counted).  Returns the
    numbers of ``chip_smoke.py``'s kernels record plus ``out`` and
    ``tol``."""
    case.wrapper.launches = 0
    ms, plain_ms = paired_ms(case.kernel, case.plain, case.iters, case.plain_iters)
    launches = case.wrapper.launches
    lib_ms = cuda_ms(case.library, case.iters) if case.library else None
    kernel, plain = case.check or (case.kernel, case.plain)
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        raise AssertionError(f"{case.name}: kernel {tuple(out.shape)} vs plain "
                             f"{tuple(ref.shape)}")
    if not bool(torch.isfinite(ref).all()) or not bool((ref != 0).any()):
        raise AssertionError(f"{case.name}: the plain output is not finite or is all "
                             f"zero, so the comparison could not catch a wrong kernel")
    err = abs_err(out, ref)
    tol = case.bound(ref)
    tol = torch.as_tensor(tol, dtype=torch.float32, device=ref.device)
    bad = err > tol
    if bool(bad.any()):
        i = int(torch.argmax((err - tol).flatten()))
        raise AssertionError(
            f"{case.name}: |kernel − plain| {err.max().item():.4e} outside its bound "
            f"at {int(bad.sum())} of {err.numel()} elements (worst: err "
            f"{err.flatten()[i].item():.4e}, bound {tol.expand_as(err).flatten()[i].item():.4e})")
    b_ms, b_by = bound_ms(case.ops, case.nbytes)
    return {"name": case.name, "kernel": case.wrapper.__name__, "route": "cuda",
            "source": case.source,
            "replaces": case.replaces, "instruction": case.instruction,
            "launches": launches,
            "max_abs_err": err.max().item(), "tol": tol.max().item(),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library": case.library_note, "out": out}


def describe(r: dict) -> str:
    """One case of :func:`measure` as a line (without the card)."""
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms ({r['library']})")
    return (f"{r['kernel']} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"launches {r['launches']}, max |err| {r['max_abs_err']:.3e} (bound "
            f"{r['tol']:.3e}); {r['instruction']}")
