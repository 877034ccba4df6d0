"""The two probe kernels redesigned for Hopper (``csrc/probe_mma.cu``'s
windowed GEMM, P1 and P2; ``csrc/probe_attend.cu``'s v6 attend, P3) beside
the earlier ``mma.sync`` design, on the card, in one process.

The earlier sources (``--old-mma-source``, ``--old-attend-source``; by
default ``probes/earlier/``, the ``mma.sync`` design as of git ``1bc6fde``)
are each built as their own shared library into ``build/probe_stages/``,
while the main library builds, and launched as their wrapper was (B
transposed a call, ``per`` repeats a block; 16 groups of attend steps).
At every shape of P1, P2a-c and P3 the script holds both designs against
the plain version, then times plain, old, new, new, old, plain and the
library call (CUDA events), and prints each beside the bound, TFLOP/s and
% of the peak.

``--attend-stages``: P3 as built and with parts of it left out (the
copies and conversions alone, the copies and products, the conversions
and products), each a library of its own: what limits the attend.

``--host``: where one P1 call's host time goes.  Each piece of the launch
path (the wrapper's checks, the plan, the output's allocation, the stream
lookup, the ctypes call that the entry point refuses at once, the call
that launches) is called 1,000 times back to back with no synchronise,
timed by ``time.perf_counter``; then the whole wrapper (and the earlier
one, with its transpose of B), one ``torch.bmm``, and one K4 forward
launch at the FST step's MAB0 attend with the stream looked up as before
(``torch.cuda.current_stream``) and as now, in turns; last (the profiler
slows later launches), P1's device time a call, new and earlier.

    python -m pcaudio_torch.probes.probe_stages [--host] [--attend-stages]
        [--old-mma-source PATH] [--old-attend-source PATH]

(about 90 s on the card with its builds).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import time
from pathlib import Path

import torch

from pcaudio_torch.ops.kernels import _build, probes
from pcaudio_torch.probes import batched_dot, int8_attend, int8_matmul
from pcaudio_torch.probes.k2_stages import apply_edits
from pcaudio_torch.probes.timing import (
    PEAK_OPS_PER_S, abs_err, bound_ms, card, cuda_ms, tf32_off)

CALLS = 1000
OUT = _build.BUILD_DIR.parent / "probe_stages"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_MATMUL_ARGS = [_P, _L, _P, _L, _P, _L] + [_I] * 8 + [_P]
OLD_ATTEND_ARGS = [_P] * 5 + [_I] * 5 + [_P]
OLD_ATTEND_GROUPS = 16
EARLIER = Path(__file__).resolve().parent / "earlier"
EARLIER_MMA = str(EARLIER / "probe_mma.cu")
EARLIER_ATTEND = str(EARLIER / "probe_attend.cu")


def per_call_us(fn, calls: int = CALLS) -> float:
    """Mean µs of host time per call over ``calls`` calls, no synchronise
    between them (the card is synchronised before the first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def start_old_builds(mma_source=EARLIER_MMA, attend_source=EARLIER_ATTEND) -> dict:
    """Start ``nvcc`` on the earlier design's sources, each into its own
    library, without waiting (:func:`finish_old_builds` collects them)."""
    jobs = {}
    for name, src, entry, args in (
            ("old_mma", mma_source, "pcaudio_probe_matmul", OLD_MATMUL_ARGS),
            ("old_attend", attend_source, "pcaudio_probe_attend", OLD_ATTEND_ARGS)):
        if src is None:
            continue
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for header in ("common.cuh", "mma.cuh"):
            (d / header).write_text((_build.CSRC / header).read_text())
        (d / "src.cu").write_text(open(src).read())
        jobs[name] = (d / "lib.so", entry, args, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "src.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return jobs


def finish_old_builds(jobs: dict) -> dict:
    """Wait for :func:`start_old_builds`' compilers; the entry points with
    their C signatures."""
    libs = {}
    for name, (lib, entry, args, p) in jobs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = args, ctypes.c_int
        libs[name] = fn
    return libs


def old_matmul(fn, a, b, reps=1, shift=0, repeats=1):
    """The earlier wrapper (``1bc6fde``'s ``probe_matmul``): B transposed on
    every call, ``per`` repeats a block, atomics into a zeroed output."""
    rows, K = a.shape[-2:]
    N = b.shape[-1]
    M = rows - shift * (reps - 1)
    int8 = a.dtype == torch.int8
    odt = torch.int32 if int8 else torch.float32
    bt = b.transpose(-1, -2).contiguous()
    batch = a.shape[0] if a.dim() == 3 else 1
    es = a.element_size()
    if repeats > 1:
        out = torch.zeros((M, N), dtype=odt, device=a.device)
        nb, a_b, b_b, o_b, per = repeats, 0, 0, 0, 8 if repeats % 8 == 0 else 1
    else:
        out = torch.empty(a.shape[:-2] + (M, N), dtype=odt, device=a.device)
        nb, a_b, b_b, o_b, per = batch, rows * K * es, N * K * es, M * N, 1
    code = fn(a.data_ptr(), a_b, bt.data_ptr(), b_b, out.data_ptr(), o_b, int(int8), M, N,
              K, reps, shift, nb, per, _build.stream_of(a))
    if code:
        raise RuntimeError(f"the earlier pcaudio_probe_matmul failed ({code})")
    return out


def old_attend(fn, iq, kmat, mode, pairs, keys, steps):
    """The earlier wrapper: 16 groups of steps, 128 rows a block."""
    rows, dv = iq.shape
    out = torch.zeros((rows, dv), dtype=torch.float32, device=iq.device)
    int8 = mode == "int8"
    iq8 = torch.empty((rows, dv) if int8 else (1,), dtype=torch.int8, device=iq.device)
    sq = torch.empty(1, dtype=torch.float32, device=iq.device)
    groups = OLD_ATTEND_GROUPS if steps % OLD_ATTEND_GROUPS == 0 else 1
    code = fn(iq.data_ptr(), kmat.data_ptr(), iq8.data_ptr(), sq.data_ptr(), out.data_ptr(),
              int(int8), rows, pairs, steps, groups, _build.stream_of(iq))
    if code:
        raise RuntimeError(f"the earlier pcaudio_probe_attend failed ({code})")
    return out


def rate(work: float, ms: float, kind: str) -> str:
    """``work`` operations of type ``kind`` in ``ms``: the rate and its
    share of the card's peak."""
    per_s = work / (ms * 1e-3)
    unit = "TOP/s" if kind == "int8" else "TFLOP/s"
    return f"{per_s / 1e12:.1f} {unit}, {100 * per_s / PEAK_OPS_PER_S[kind]:.1f} % of peak"


def compare(dev, old: dict, where: str) -> None:
    """Old and new in one process at every shape: both held against the
    plain version, then timed in turns."""
    gen = torch.Generator(dev).manual_seed(0)
    with tf32_off():
        for name, new, old_call, plain, bound, ops, nbytes, lib, fam, iters, p_iters in (
                _matmul_cases(dev, gen) + _attend_cases(dev, gen)):
            fn = old.get("old_mma" if fam == "mma" else "old_attend")
            old_fn = (lambda fn=fn, old_call=old_call: old_call(fn)) if fn else None
            ref = plain()
            tol = torch.as_tensor(bound(ref), dtype=torch.float32, device=ref.device)
            errs = {}
            for tag, f in (("new", new), ("old", old_fn)):
                if f is None:
                    continue
                err = abs_err(f(), ref)
                if bool((err > tol).any()):
                    raise AssertionError(f"{name}: the {tag} design is outside its bound "
                                         f"({err.max().item():.3e})")
                errs[tag] = err.max().item()
            t = {"plain": [cuda_ms(plain, p_iters)]}
            order = ["old", "new", "new", "old"] if old_fn else ["new", "new"]
            for tag in order:
                t.setdefault(tag, []).append(cuda_ms(new if tag == "new" else old_fn, iters))
            t["plain"].append(cuda_ms(plain, p_iters))
            lib_ms = cuda_ms(lib, iters) if lib else None
            b_ms, b_by = bound_ms(ops, nbytes)
            kind = next(k for k in ops if k != "sfu")
            ms = {k: sum(v) / len(v) for k, v in t.items()}
            parts = [f"{tag} {ms[tag]:.4f} ms ({rate(ops[kind], ms[tag], kind)})"
                     for tag in ("new", "old") if tag in ms]
            parts.append(f"plain {ms['plain']:.4f} ms")
            parts.append("library " + ("none" if lib_ms is None else f"{lib_ms:.4f} ms"))
            parts.append(f"bound {b_ms:.4f} ms by {b_by}")
            parts.append("max |err| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                         + f" (bound {tol.max().item():.3e})")
            print(f"[compare] {name}: " + "; ".join(parts) + f" ({where})")


def _matmul_cases(dev, gen):
    cases = []
    for c in batched_dot.cases(dev, gen) + int8_matmul.cases(dev, gen):
        kind = {"batched_dot": "P1", "small int8": "P2a"}.get(c.name)
        kind = kind or {"big": "P2b", "attend": "P2c"}[c.name.split()[0]]
        cases.append((f"{kind} {c.name}", c.kernel,
                      lambda fn, args=c.args: old_matmul(fn, *args), c.plain, c.bound,
                      c.ops, c.nbytes, c.library, "mma", c.iters, c.plain_iters))
    return cases


def _attend_cases(dev, gen):
    return [(f"P3 attend {c.name}", c.kernel,
             lambda fn, args=c.args: old_attend(fn, *args), c.plain, c.bound, c.ops,
             c.nbytes, c.library, "attend", c.iters, c.plain_iters)
            for c in int8_attend.cases(dev, gen)]


ATTEND_VARIANTS = {  # kLeaveOut of csrc/probe_attend.cu
    "whole": 0,
    "copies and conversions only": 1,
    "copies and products, no conversion": 2,
    "conversions and products, no copies": 3,
}


def attend_variant_sources() -> dict:
    """csrc/probe_attend.cu with its variant constants set (k2_stages'
    edits: each must apply)."""
    text = (_build.CSRC / "probe_attend.cu").read_text()
    out = {}
    for name, v in ATTEND_VARIANTS.items():
        edits = [("constexpr int kLeaveOut = 0;", f"constexpr int kLeaveOut = {v};")] if v else []
        out[name] = apply_edits(text, edits, f"attend variant {name!r}")
    return out


def attend_stages(dev, where) -> None:
    """P3 as built and with parts left out (ATTEND_VARIANTS), each its own
    library, at the probe's shape in both modes: what limits the kernel.
    Only the whole is a right answer; the others time parts."""
    procs = {}
    for name, text in attend_variant_sources().items():
        d = OUT / ("attend_" + name.replace(" ", "_").replace(",", ""))
        d.mkdir(parents=True, exist_ok=True)
        for header in ("common.cuh", "mma.cuh", "hopper.cuh"):
            (d / header).write_text((_build.CSRC / header).read_text())
        (d / "src.cu").write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "src.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for attend variant {name}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(lib)).pcaudio_probe_attend
        fn.argtypes, fn.restype = OLD_ATTEND_ARGS, ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(dev).manual_seed(0)
    for c in int8_attend.cases(dev, gen):
        iq, kmat, mode, pairs, keys, steps = c.args
        rows = iq.shape[0]
        plan = probes.attend_plan(rows, pairs, steps, probes.sm_count(0))
        out = torch.zeros_like(iq)
        iq8 = torch.empty(iq.shape, dtype=torch.int8, device=dev)
        sq = torch.empty(1, device=dev)

        def run(fn):
            code = fn(iq.data_ptr(), kmat.data_ptr(), iq8.data_ptr(), sq.data_ptr(),
                      out.data_ptr(), int(mode == "int8"), rows, pairs, steps, plan.blocks,
                      _build.stream_of(iq))
            if code:
                raise RuntimeError(f"attend variant failed ({code})")
        ms = {name: cuda_ms(lambda fn=fn: run(fn), c.iters) for name, fn in fns.items()}
        ms["whole (again)"] = cuda_ms(lambda: run(fns["whole"]), c.iters)
        print(f"[attend stages] {mode}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f" ({where})")


def host_split(dev, old: dict) -> dict:
    """µs a call of each piece of one P1 launch (bf16 [8, 512, 64] ·
    [8, 64, 128]), of the whole wrapper (and the earlier one), of
    ``torch.bmm`` and of one K4 forward at the FST step's MAB0 attend
    (B = 128, 64 queries, 1025 keys) with the earlier and the present
    stream lookup."""
    from pcaudio_torch.ops.kernels.mha import fused_mha_fwd

    gen = torch.Generator(dev).manual_seed(0)
    a = torch.randn(8, 512, 64, generator=gen, device=dev).bfloat16()
    b = torch.randn(8, 64, 128, generator=gen, device=dev).bfloat16()
    lib = _build.library()
    out = torch.empty(8, 512, 128, device=dev)
    stream = _build.stream_of(a)
    call = probes._matmul_call(a.shape, b.shape, a.dtype, b.dtype, 1, 0, 1, 0)
    args = [a.data_ptr(), b.data_ptr(), out.data_ptr(), call.params_ptr, stream]
    bad = (ctypes.c_int * 12)(*call.params)
    bad[3] = 0  # M = 0: the entry point returns before any launch
    refused = args[:3] + [ctypes.addressof(bad), stream]
    launch = _build.launch

    def wrapper_without_launch():
        _build.launch = lambda *args: None
        try:
            probes.probe_matmul(a, b)
        finally:
            _build.launch = launch
    res = {
        "checks (uncached)": per_call_us(lambda: probes._check_matmul(a, b, 1, 0, 1)),
        "checks and plan (cached)": per_call_us(
            lambda: probes._matmul_call(a.shape, b.shape, a.dtype, b.dtype, 1, 0, 1,
                                        a.get_device())),
        "torch.empty": per_call_us(lambda: torch.empty((8, 512, 128), device=dev)),
        "a.new_empty": per_call_us(lambda: a.new_empty((8, 512, 128), dtype=torch.float32)),
        "wrapper without its launch": per_call_us(wrapper_without_launch),
        "stream_of (raw stream)": per_call_us(lambda: _build.stream_of(a)),
        "torch.cuda.current_stream(device) (the earlier stream_of)": per_call_us(
            lambda: torch.cuda.current_stream(a.device).cuda_stream),
        "ctypes call, refused (no launch)": per_call_us(
            lambda: lib.pcaudio_probe_matmul(*refused)),
        "ctypes call that launches": per_call_us(lambda: lib.pcaudio_probe_matmul(*args)),
        "_build.launch that launches": per_call_us(
            lambda: _build.launch("pcaudio_probe_matmul", *args)),
        "wrapper (new)": per_call_us(lambda: probes.probe_matmul(a, b)),
        "transpose of b (the earlier wrapper's)": per_call_us(
            lambda: b.transpose(-1, -2).contiguous()),
    }
    if "old_mma" in old:
        res["wrapper (earlier design)"] = per_call_us(lambda: old_matmul(old["old_mma"], a, b))
    res["torch.bmm"] = per_call_us(lambda: torch.bmm(a, b))
    q = torch.randn(128, 64, 64, generator=gen, device=dev)
    k = torch.randn(128, 1025, 64, generator=gen, device=dev)
    present = _build.stream_of

    def earlier(t):
        return torch.cuda.current_stream(t.device).cuda_stream
    for turn in ("earlier", "present", "present", "earlier"):
        _build.stream_of = earlier if turn == "earlier" else present
        try:
            us = per_call_us(lambda: fused_mha_fwd(q, k, k, None, 8, 0.125))
        finally:
            _build.stream_of = present
        key = f"K4 forward launch (fused_mha_fwd, MAB0), {turn} stream lookup"
        res[key] = (res.get(key, 0.0) + us / 2)
    torch.cuda.synchronize()
    return res


def device_times(dev, old: dict, where: str) -> None:
    """One P1 call's device time by kernel (``torch.profiler``), new and
    earlier; last, since the profiler leaves launches slower after it."""
    from pcaudio_torch.probes.timing import profile_device

    gen = torch.Generator(dev).manual_seed(0)
    a = torch.randn(8, 512, 64, generator=gen, device=dev).bfloat16()
    b = torch.randn(8, 64, 128, generator=gen, device=dev).bfloat16()
    for tag, fn in (("new", lambda: probes.probe_matmul(a, b)),
                    ("earlier design", old.get("old_mma") and (
                        lambda: old_matmul(old["old_mma"], a, b)))):
        if fn:
            per, _ = profile_device(fn, 20)
            for k, ms in per.items():
                print(f"[device] P1, {tag}: {k[:70]} {ms * 1e3:.2f} µs a call "
                      f"(torch.profiler, 20 calls; {where})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pcaudio_torch.probes.probe_stages")
    ap.add_argument("--host", action="store_true", help="split one P1 call's host time")
    ap.add_argument("--attend-stages", action="store_true",
                    help="time P3 with parts left out (ATTEND_VARIANTS)")
    ap.add_argument("--old-mma-source", default=EARLIER_MMA,
                    help="an earlier csrc/probe_mma.cu (default: probes/earlier/)")
    ap.add_argument("--old-attend-source", default=EARLIER_ATTEND,
                    help="an earlier csrc/probe_attend.cu (default: probes/earlier/)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_stages needs an NVIDIA GPU")
    dev = torch.device("cuda")
    where = card()
    print(f"[probe_stages] {where}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    jobs = start_old_builds(args.old_mma_source, args.old_attend_source)
    _build.library()
    old = finish_old_builds(jobs)
    print(f"[probe_stages] built in {time.perf_counter() - t0:.1f} s: {sorted(old)}")
    if args.host:
        for name, us in host_split(dev, old).items():
            print(f"[host] {name}: {us:.2f} µs a call ({CALLS} calls, no "
                  f"synchronise; {where})")
    compare(dev, old, where)
    if args.attend_stages:
        attend_stages(dev, where)
    if args.host:
        device_times(dev, old, where)


if __name__ == "__main__":
    main()
