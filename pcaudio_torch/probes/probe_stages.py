"""The probe kernels redesigned for Hopper (``csrc/probe_mma.cu``'s
windowed GEMM, P1 and P2, and bf16 chain, P4a; ``csrc/probe_attend.cu``'s
v6 attend, P3; ``csrc/probe_stream.cu``'s int16 gram, P6a;
``csrc/probe_featurize.cu``'s DFT, P8 and P9) beside their earlier design,
on the card, in one process.

The earlier sources (``--old-mma-source``, ``--old-attend-source``,
``--old-dft-source``, ``--old-stream-source``; by default
``probes/earlier/``: the ``mma.sync`` designs as of git ``1bc6fde``, whose
``probe_mma.cu`` also holds the ``mma.sync`` chain; for the DFT
``785c6d4``; for the gram ``a0f098b``) are each built as their own shared
library into ``build/probe_stages/``, while the main library builds, and
launched as their wrapper was (B or w transposed a call, ``per`` repeats a
block; 16 groups of attend steps; W concatenated and transposed a call).
At every shape of P1, P2a-c, P3, P4a (d 64 and 128), P6a, P8 (seven forms)
and P9 (five variants) the script holds both designs against the plain
version (P9 on the rows a variant writes, P4a exactly on its check
inputs), then times plain, old, new, new, old, plain and the library
call (CUDA events), and prints each beside the bound, TFLOP/s and % of
the data sheet's peak; for P4a also the SM clock the card holds under the
new design and the bound at that clock.

``--attend-stages``: P3 as built and with parts of it left out (the
copies and conversions alone, the copies and products, the conversions
and products), each a library of its own: what limits the attend.

``--dft-stages``: the DFT kernel as built and with parts of it left out
or scheduled otherwise (``DFT_VARIANTS``), each a library of its own, at
P8's G = 1 unrolled and G = 8 stacked forms and P9's v0, then the SM clock
and power draw (``nvidia-smi``) under the kernel on the probe's data and
on zeros, under its products alone, and under P2b's bf16 GEMM: what
limits the DFT.

``--chain-stages``: P4a's chain as built, its products alone (no pack)
and its pack alone (no products) (``CHAIN_VARIANTS``), each a library of
its own (ptxas' registers and spills printed for each), at d 64 and 128,
then the SM clock and power under it on the probe's values and at the
signed permutation, with the bound at that clock: what limits the chain.

``--host``: where one P1 call's host time goes.  Each piece of the launch
path (the wrapper's checks, the plan, the output's allocation, the stream
lookup, the ctypes call that the entry point refuses at once, the call
that launches) is called 1,000 times back to back with no synchronise,
timed by ``time.perf_counter``; then the whole wrapper (and the earlier
one, with its transpose of B), one ``torch.bmm``, and one K4 forward
launch at the FST step's MAB0 attend with the stream looked up as before
(``torch.cuda.current_stream``) and as now, in turns; last (the profiler
slows later launches), P1's and P6a's device time a call, new and
earlier.

    python -m pcaudio_torch.probes.probe_stages [--host] [--attend-stages]
        [--dft-stages] [--chain-stages] [--old-mma-source PATH]
        [--old-attend-source PATH] [--old-dft-source PATH]
        [--old-stream-source PATH]

(about 120 s on the card with its builds; each stage flag adds its own).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from pcaudio_torch.ops.kernels import _build, probes
from pcaudio_torch.ops.kernels.featurize_probes import DFT_MODES, dft_plan, dft_written
from pcaudio_torch.probes import (
    batched_dot, featurize_blockc, featurize_variants, int8_attend, int8_matmul, int16_load,
    lane_width)
from pcaudio_torch.probes.k2_stages import apply_edits
from pcaudio_torch.probes.timing import (
    PEAK_OPS_PER_S, abs_err, bound_ms, card, cuda_ms, tensor_bound_ms, tf32_off)

CALLS = 1000
OUT = _build.BUILD_DIR.parent / "probe_stages"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_MATMUL_ARGS = [_P, _L, _P, _L, _P, _L] + [_I] * 8 + [_P]
OLD_ATTEND_ARGS = [_P] * 5 + [_I] * 5 + [_P]
OLD_ATTEND_GROUPS = 16
OLD_DFT_ARGS = [_P] * 4 + [_I] * 8 + [_P]
OLD_CHAIN_ARGS = [_P] * 3 + [_I] * 5 + [_P]
DFT_ARGS = [_P] * 5 + [_I] * 9 + [_P]
CHAIN_ARGS = [_P] * 5
GRAM_ARGS = [_P, _P, _I, _I, _P]
EARLIER = Path(__file__).resolve().parent / "earlier"
EARLIER_MMA = str(EARLIER / "probe_mma.cu")
EARLIER_ATTEND = str(EARLIER / "probe_attend.cu")
EARLIER_DFT = str(EARLIER / "probe_featurize.cu")
EARLIER_STREAM = str(EARLIER / "probe_stream.cu")


def per_call_us(fn, calls: int = CALLS) -> float:
    """Mean µs of host time per call over ``calls`` calls, no synchronise
    between them (the card is synchronised before the first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def start_build(name: str, text: str, entry: str, args: list,
                headers=("common.cuh", "mma.cuh"), also=None) -> tuple:
    """Start ``nvcc`` on the source ``text`` into its own library under
    ``OUT / name`` (with today's ``headers`` beside it), without waiting.
    :func:`finish_old_builds` then binds ``entry`` under the job's key and
    each further entry point of ``also`` ({key: (entry, args)}) under its
    own key."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in headers:
        (d / header).write_text((_build.CSRC / header).read_text())
    (d / "src.cu").write_text(text)
    return (d / "lib.so", (entry, args), also or {}, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
         str(d / "src.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))


def start_old_builds(mma_source=EARLIER_MMA, attend_source=EARLIER_ATTEND,
                     dft_source=EARLIER_DFT, stream_source=EARLIER_STREAM) -> dict:
    """Start ``nvcc`` on the earlier design's sources, each into its own
    library, without waiting (:func:`finish_old_builds` collects them):
    the windowed GEMM and the chain from one, the attend, the DFT and the
    int16 gram from the others."""
    jobs = {}
    for name, src, entry, args, also in (
            ("old_mma", mma_source, "pcaudio_probe_matmul", OLD_MATMUL_ARGS,
             {"old_chain": ("pcaudio_probe_chain", OLD_CHAIN_ARGS)}),
            ("old_attend", attend_source, "pcaudio_probe_attend", OLD_ATTEND_ARGS, None),
            ("old_dft", dft_source, "pcaudio_probe_dft_mag2", OLD_DFT_ARGS, None),
            ("old_stream", stream_source, "pcaudio_probe_int16_gram", GRAM_ARGS, None)):
        if src is not None:
            jobs[name] = start_build(name, open(src).read(), entry, args, also=also)
    return jobs


def finish_old_builds(jobs: dict) -> dict:
    """Wait for :func:`start_old_builds`' compilers; the entry points with
    their C signatures, by key."""
    libs = {}
    for name, (lib, main, also, p) in jobs.items():
        log = p.communicate()[0]
        (Path(lib).parent / "build.log").write_text(log)
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        dll = ctypes.CDLL(str(lib))
        for key, (entry, args) in {name: main, **also}.items():
            fn = getattr(dll, entry)
            fn.argtypes, fn.restype = args, ctypes.c_int
            libs[key] = fn
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


def old_dft(fn, x3, w0, w1, C, Nt, mode="direct", s0=None, G=1, stacked=False):
    """The earlier wrapper (``785c6d4``'s ``dft_mag2``): ``[w0; w1]``
    concatenated and transposed on every call, one entry point."""
    B, R, hop = x3.shape
    F = w0.shape[1] // 2
    wt = torch.cat([w0, w1]).t().contiguous()
    out = torch.empty((B, C, Nt, F), dtype=torch.bfloat16, device=x3.device)
    code = fn(x3.data_ptr(), wt.data_ptr(), s0.data_ptr() if s0 is not None else None,
              out.data_ptr(), B, R, hop, F, C * Nt, G, int(stacked), DFT_MODES.index(mode),
              _build.stream_of(x3))
    if code:
        raise RuntimeError(f"the earlier pcaudio_probe_dft_mag2 failed ({code})")
    return out


def old_chain(fn, x, w, reps, repeats):
    """The earlier wrapper (``a0f098b``'s ``probe_chain``): w transposed on
    every call, ``per`` repeats a block, atomics into a zeroed output."""
    n, d = x.shape
    wt = w.t().contiguous()
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    per = 8 if repeats % 8 == 0 else 1
    code = fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, d, reps, repeats, per,
              _build.stream_of(x))
    if code:
        raise RuntimeError(f"the earlier pcaudio_probe_chain failed ({code})")
    return out


def chain_call(fn, x, w, reps, repeats):
    """``probe_chain``'s launch through another build's entry point ``fn``."""
    _, ptr = probes._chain_call(x.shape, w.shape, x.dtype, w.dtype, reps, repeats,
                                x.get_device())
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), ptr, _build.stream_of(x))
    if code:
        raise RuntimeError(f"a chain build's pcaudio_probe_chain failed ({code})")
    return out


def old_gram(fn, x):
    """The earlier int16 gram (``a0f098b``): one block of 64 threads a row."""
    n, L = x.shape
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    code = fn(x.data_ptr(), out.data_ptr(), n, L, _build.stream_of(x))
    if code:
        raise RuntimeError(f"the earlier pcaudio_probe_int16_gram failed ({code})")
    return out


def rate(work: float, ms: float, kind: str) -> str:
    """``work`` operations of type ``kind`` in ``ms``: the rate and its
    share of the card's peak."""
    per_s = work / (ms * 1e-3)
    unit = "TOP/s" if kind == "int8" else "TFLOP/s"
    return (f"{per_s / 1e12:.1f} {unit}, {100 * per_s / PEAK_OPS_PER_S[kind]:.1f} % of the "
            f"data sheet's peak")


class Comparison(NamedTuple):
    """One shape of :func:`compare`: the new call, the earlier design's
    call given its entry point, the plain version, the bound on their
    difference, the work, the library call, the earlier library's key
    (``old_<fam>``), timing counts, a map applied to both designs' outputs
    before the check, and, where the timed inputs could not tell a wrong
    kernel from a right one, (new, earlier, plain) calls on check inputs."""

    name: str
    new: Callable
    old_call: Callable
    plain: Callable
    bound: Callable
    ops: dict
    nbytes: float
    lib: Optional[Callable]
    fam: str
    iters: int
    p_iters: int
    post: Optional[Callable] = None
    check: Optional[tuple] = None


def compare(dev, old: dict, where: str) -> None:
    """Old and new in one process at every shape: both held against the
    plain version (on the check inputs where a case has them), then timed
    in turns."""
    gen = torch.Generator(dev).manual_seed(0)
    with tf32_off():
        for c in (_matmul_cases(dev, gen) + _chain_cases(dev, gen) + _attend_cases(dev, gen)
                  + _gram_cases(dev, gen) + _dft_cases(dev, gen)):
            fn = old.get("old_" + c.fam)
            old_fn = (lambda fn=fn, c=c: c.old_call(fn)) if fn else None
            if c.check:
                new_k, old_k, plain_k = c.check
                old_k = (lambda fn=fn, old_k=old_k: old_k(fn)) if fn else None
            else:
                new_k, old_k, plain_k = c.new, old_fn, c.plain
            ref = plain_k()
            if not bool(torch.isfinite(ref).all()) or not bool((ref != 0).any()):
                raise AssertionError(f"{c.name}: the plain output is not finite or is all "
                                     f"zero, so the check could not catch a wrong kernel")
            tol = torch.as_tensor(c.bound(ref), dtype=torch.float32, device=ref.device)
            errs = {}
            for tag, f in (("new", new_k), ("old", old_k)):
                if f is None:
                    continue
                err = abs_err(c.post(f()) if c.post else f(), ref)
                if bool((err > tol).any()):
                    raise AssertionError(f"{c.name}: the {tag} design is outside its bound "
                                         f"({err.max().item():.3e})")
                errs[tag] = err.max().item()
            t = {"plain": [cuda_ms(c.plain, c.p_iters)]}
            order = ["old", "new", "new", "old"] if old_fn else ["new", "new"]
            for tag in order:
                t.setdefault(tag, []).append(cuda_ms(c.new if tag == "new" else old_fn, c.iters))
            t["plain"].append(cuda_ms(c.plain, c.p_iters))
            lib_ms = cuda_ms(c.lib, c.iters) if c.lib else None
            b_ms, b_by = bound_ms(c.ops, c.nbytes)
            kind = next(k for k in c.ops if k != "sfu")
            ms = {k: sum(v) / len(v) for k, v in t.items()}
            parts = [f"{tag} {ms[tag]:.4f} ms ({rate(c.ops[kind], ms[tag], kind)})"
                     for tag in ("new", "old") if tag in ms]
            parts.append(f"plain {ms['plain']:.4f} ms")
            parts.append("library " + ("none" if lib_ms is None else f"{lib_ms:.4f} ms"))
            parts.append(f"bound {b_ms:.4f} ms by {b_by}")
            if c.fam == "chain":  # the bound at the clock the card holds under it
                mhz = clocks_under_load(c.new, seconds=2.0)["sm_mhz"]
                t_ms = tensor_bound_ms(c.ops["bf16"], "bf16", mhz, probes.sm_count(0))
                parts.append(f"at the {mhz:.0f} MHz held under the new design bound "
                             f"{t_ms:.4f} ms, new at {100 * t_ms / ms['new']:.1f} % of its rate")
            parts.append("max |err| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                         + f" (bound {tol.max().item():.3e}"
                         + (", on the check inputs)" if c.check else ")"))
            print(f"[compare] {c.name}: " + "; ".join(parts) + f" ({where})")
            del ref, tol


def _matmul_cases(dev, gen):
    cases = []
    for c in batched_dot.cases(dev, gen) + int8_matmul.cases(dev, gen):
        kind = {"batched_dot": "P1", "small int8": "P2a"}.get(c.name)
        kind = kind or {"big": "P2b", "attend": "P2c"}[c.name.split()[0]]
        cases.append(Comparison(
            f"{kind} {c.name}", c.kernel, lambda fn, args=c.args: old_matmul(fn, *args),
            c.plain, c.bound, c.ops, c.nbytes, c.library, "mma", c.iters, c.plain_iters))
    return cases


def _chain_cases(dev, gen):
    """P4a at d 64 and 128: timed on the probe's values, held (exactly)
    against the plain version on the check inputs."""
    return [Comparison(
        f"P4a {c.name}", c.kernel, lambda fn, args=c.args: old_chain(fn, *args), c.plain,
        c.bound, c.ops, c.nbytes, c.library, "chain", c.iters, c.plain_iters,
        check=(c.check[0], lambda fn, checks=c.check_args: lane_width.chain_check(
            lambda *a: old_chain(fn, *a), checks), c.check[1]))
        for c in lane_width.cases(dev, gen) if c.name.startswith("chain")]


def _attend_cases(dev, gen):
    return [Comparison(f"P3 attend {c.name}", c.kernel,
                       lambda fn, args=c.args: old_attend(fn, *args), c.plain, c.bound, c.ops,
                       c.nbytes, c.library, "attend", c.iters, c.plain_iters)
            for c in int8_attend.cases(dev, gen)]


def _gram_cases(dev, gen):
    return [Comparison(f"P6a int16 gram {c.name}", c.kernel,
                       lambda fn, args=c.args: old_gram(fn, *args), c.plain, c.bound, c.ops,
                       c.nbytes, c.library, "stream", c.iters, c.plain_iters)
            for c in int16_load.cases(dev, gen) if c.name == "kern"]


def _dft_cases(dev, gen):
    """P8's seven forms and P9's five variants; P9's outputs compared on
    the rows a variant writes (``dft_written``), the others zeroed."""
    cases = []
    for tag, c in ([("P8", c) for c in featurize_blockc.cases(dev, gen)]
                   + [("P9", c) for c in featurize_variants.cases(dev, gen)]):
        x3, _, _, C, Nt, mode, s0 = c.args[:7]
        written = dft_written(x3, C, Nt, mode, s0)
        post = (lambda out, written=written: featurize_variants.masked(out, written)
                ) if tag == "P9" else None
        cases.append(Comparison(
            f"{tag} {c.name}", c.kernel, lambda fn, args=c.args: old_dft(fn, *args), c.plain,
            c.bound, c.ops, c.nbytes, c.library, "dft", c.iters, c.plain_iters, post))
    return cases


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
    jobs = {name: start_build("attend_" + name.replace(" ", "_").replace(",", ""), text,
                              "pcaudio_probe_attend", OLD_ATTEND_ARGS,
                              ("common.cuh", "mma.cuh", "hopper.cuh"))
            for name, text in attend_variant_sources().items()}
    fns = finish_old_builds(jobs)
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


def _leave_out(v):
    return [("constexpr int kLeaveOut = 0;", f"constexpr int kLeaveOut = {v};")]


DFT_VARIANTS = {  # edits of csrc/probe_featurize.cu (kLeaveOut, or another schedule)
    "whole": [],
    "copies only": _leave_out(1),
    "copies and conversions, no products": _leave_out(2),
    "copies and products, no conversion": _leave_out(3),
    "products only, no copies": _leave_out(4),
    "products only, nothing stored": _leave_out(5),
    # the products alone with A from shared memory (whatever the ring
    # holds, K-major), against A from registers: what the RS form costs
    "products only, A from shared memory": _leave_out(4) + [(
        "hw::wgmma_bf16_rs_n256<1>(acc, fa[u][i], db, (kt | i) ? 1u : 0u);",
        "hw::wgmma_bf16_ss_n256<1>(acc, hw::smem_desc(ring_u + stage * kStageBytes + cw * "
        "8192 + (i % 2) * 32 + (i / 2) * 64, 16, hw::kSbo), db, (kt | i) ? 1u : 0u);")],
    # each warpgroup waits for its stage's products and frees the stage at
    # once: one stage held a warpgroup, not two, so one more in flight
    # the proxy fence that orders a warp's reads of a stage before the
    # copies that refill it, left out: what it costs
    "whole, no proxy fence on release": [
        ("hw::fence_proxy_async();   // its reads, before the copies that refill it", "")],
    "whole, each stage freed after its own products": [
        ("hw::wgmma_wait<1>();  // the stage before this one is read", "hw::wgmma_wait<0>();"),
        ("if (kCopies && held >= 0) release(held);", "if (kCopies) release(stage);"),
        ("if constexpr (kCopies) release(held);", "")],
}
DFT_STAGE_CASES = ("P8 G=1 unrolled", "P8 G=8 stacked", "P9 v0 matmul+sq (bf16 in)")


def ptxas_lines(kernel: str, log=None) -> list:
    """ptxas' lines (registers, spills, C75xx notes) for every
    instantiation of ``kernel`` (a part of the mangled name, such as
    ``12chain_kernel``, which ``exp_chain_kernel`` lacks) in the main
    build's ``build.log``, or in ``log``."""
    lines, current = [], False
    for line in Path(log or _build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            current = kernel in line
            if current:
                lines.append(f"ptxas {line.split(chr(39))[1][:100]}")
        elif current and ("registers" in line or "spill" in line or "C75" in line):
            lines.append(f"ptxas   {line.strip()[:160]}")
    return lines


def dft_variant_sources() -> dict:
    """csrc/probe_featurize.cu with its variant constants set (k2_stages'
    edits: each must apply)."""
    text = (_build.CSRC / "probe_featurize.cu").read_text()
    return {name: apply_edits(text, e, f"DFT variant {name!r}")
            for name, e in DFT_VARIANTS.items()}


# Wrong builds of csrc/probe_featurize.cu that the card tests feed the
# probes' check (which must then fail): the last K stage's wave fragments
# zeroed (its products dropped), and w0 and w1 swapped.
DFT_WRONG = {
    "one K stage dropped": [(
        "load_a(fa[u], sa);",
        "load_a(fa[u], sa);\n          if (kt == p.nk - 1)\n"
        "            for (auto& k : fa[u]) for (auto& r : k) r = 0u;")],
    "w0 and w1 swapped": [(
        "const CUtensorMap* map = half ? &map_w1 : &map_w0;",
        "const CUtensorMap* map = half ? &map_w0 : &map_w1;")],
}


def dft_wrong_sources() -> dict:
    """csrc/probe_featurize.cu with each DFT_WRONG edit (each must apply)."""
    text = (_build.CSRC / "probe_featurize.cu").read_text()
    return {name: apply_edits(text, e, f"wrong DFT build {name!r}")
            for name, e in DFT_WRONG.items()}


def build_dft_sources(sources: dict, prefix: str) -> dict:
    """Each DFT source of ``sources`` built into its own library at once;
    their entry points by name."""
    return finish_old_builds({
        name: start_build(prefix + name.replace(" ", "_").replace(",", ""), text,
                          "pcaudio_probe_dft_mag2", DFT_ARGS, ("hopper.cuh",))
        for name, text in sources.items()})


def dft_call(fn, x3, w0, w1, C, Nt, mode="direct", s0=None, G=1, stacked=False):
    """``dft_mag2``'s launch through another build's entry point ``fn``."""
    B, R, hop = x3.shape
    F = w0.shape[1] // 2
    plan = dft_plan(B, R, hop, F, G, stacked, mode, probes.sm_count(x3.get_device()))
    out = torch.empty((B, C, Nt, F), dtype=torch.bfloat16, device=x3.device)
    code = fn(x3.data_ptr(), w0.data_ptr(), w1.data_ptr(),
              s0.data_ptr() if s0 is not None else None, out.data_ptr(), B, R, hop, F,
              C * Nt, G, int(stacked), DFT_MODES.index(mode), plan.blocks,
              _build.stream_of(x3))
    if code:
        raise RuntimeError(f"a DFT build's pcaudio_probe_dft_mag2 failed ({code})")
    return out


def clocks_under_load(fn, seconds: float = 3.0) -> dict:
    """``fn`` called back to back for ``seconds`` while ``nvidia-smi``
    samples the card every 100 ms: the median SM clock (MHz), power draw
    (W) and the calls' rate.  The sampler is stopped before returning."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            calls += 10
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    samples = [tuple(float(v) for v in line.split(",")) for line in out.splitlines()
               if line.count(",") == 1]
    samples = samples[len(samples) // 4:]  # past the ramp
    if not samples:
        raise RuntimeError("nvidia-smi gave no samples")
    clk = sorted(c for c, _ in samples)
    pwr = sorted(w for _, w in samples)
    return {"sm_mhz": clk[len(clk) // 2], "watts": pwr[len(pwr) // 2],
            "ms": elapsed / calls * 1e3, "samples": len(samples)}


def dft_clocks(dev, fns, where) -> None:
    """The SM clock and power under the DFT kernel (P8 G = 1 on the
    probe's data and on zeros), its products alone, and P2b's bf16 GEMM."""
    gen = torch.Generator(dev).manual_seed(0)
    c8 = {c.name: c for c in featurize_blockc.cases(dev, gen)}["G=1 unrolled"]
    x3, w0, w1 = c8.args[:3]
    zeros = (torch.zeros_like(x3),) + c8.args[1:]
    gemm = {c.name: c for c in int8_matmul.cases(dev, gen)}["big bf16"]
    runs = {"DFT whole, the probe's data": lambda: dft_call(fns["whole"], *c8.args),
            "DFT whole, a zero wave": lambda: dft_call(fns["whole"], *zeros),
            "DFT products only (zeros)": lambda: dft_call(fns["products only, no copies"],
                                                          *c8.args),
            "P2b bf16 GEMM (integers in [-4, 4))": gemm.kernel}
    for name, fn in runs.items():
        r = clocks_under_load(fn)
        print(f"[dft clocks] {name}: SM clock {r['sm_mhz']:.0f} MHz, power {r['watts']:.1f} W, "
              f"{r['ms']:.4f} ms a call ({r['samples']} samples; {where})")


def dft_stages(dev, where) -> None:
    """The DFT kernel as built and with parts left out (DFT_VARIANTS), each
    its own library, at DFT_STAGE_CASES: what limits the kernel.  The
    whole is held against the plain version; the others time parts."""
    fns = build_dft_sources(dft_variant_sources(), "dft_")
    for line in ptxas_lines("dft_mag2_kernel"):
        print(f"[dft stages] {line}")
    gen = torch.Generator(dev).manual_seed(0)
    with tf32_off():
        for tag, mod in (("P8", featurize_blockc), ("P9", featurize_variants)):
            for c in mod.cases(dev, gen):
                name = f"{tag} {c.name}"
                if name not in DFT_STAGE_CASES:
                    continue
                x3, _, _, C, Nt, mode, s0 = c.args[:7]
                written = dft_written(x3, C, Nt, mode, s0)

                def run(fn, args=c.args):
                    return dft_call(fn, *args)
                ref = c.plain()
                tol = torch.as_tensor(c.bound(ref), dtype=torch.float32, device=dev)
                for v, fn in fns.items():
                    if v.startswith("whole"):
                        err = abs_err(featurize_variants.masked(run(fn), written), ref)
                        if bool((err > tol).any()):
                            raise AssertionError(f"{name}: DFT variant {v!r} is outside its "
                                                 f"bound ({err.max().item():.3e})")
                del ref, tol
                ms = {v: cuda_ms(lambda fn=fn: run(fn), c.iters) for v, fn in fns.items()}
                ms["whole (again)"] = cuda_ms(lambda: run(fns["whole"]), c.iters)
                print(f"[dft stages] {name}: " + "; ".join(
                    f"{k} {v:.4f} ms" + (f" ({rate(c.ops['bf16'], v, 'bf16')})"
                                         if k.startswith("whole") else "")
                    for k, v in ms.items()) + f" ({where})")
    dft_clocks(dev, fns, where)


def _chain_edit(name, v):
    return [(f"constexpr int {name} = 0;", f"constexpr int {name} = {v};")]


CHAIN_VARIANTS = {  # kChainLeaveOut of csrc/probe_mma.cu
    "whole": [],
    "products only, no pack": _chain_edit("kChainLeaveOut", 1),
    "pack only, no products": _chain_edit("kChainLeaveOut", 2),
}
# Wrong builds of csrc/probe_mma.cu that the card tests feed the lane-width
# check (which must then fail): the chain's last step dropped, the pack
# skipped (A keeps x: the products alone), and the pack truncating to bf16
# in place of rounding to nearest even.
CHAIN_WRONG = {
    "last step dropped": [("for (int s = 0; s < reps; ++s) {",
                           "for (int s = 0; s < reps - 1; ++s) {")],
    "pack skipped": _chain_edit("kChainLeaveOut", 1),
    "pack truncates": [("a[i / 4][i % 4] = pack_bf16(acc[2 * i], acc[2 * i + 1]);",
                        "a[i / 4][i % 4] = __byte_perm(__float_as_uint(acc[2 * i]), "
                        "__float_as_uint(acc[2 * i + 1]), 0x7632);")],
}


def chain_sources(edits: dict, what: str) -> dict:
    """csrc/probe_mma.cu with each edit list of ``edits`` (each must
    apply)."""
    text = (_build.CSRC / "probe_mma.cu").read_text()
    return {name: apply_edits(text, e, f"{what} {name!r}") for name, e in edits.items()}


def _chain_dir(prefix: str, name: str) -> str:
    return prefix + name.replace(" ", "_").replace(",", "").replace("/", "of")


def build_chain_sources(sources: dict, prefix: str) -> dict:
    """Each chain source of ``sources`` built into its own library at once
    (under ``OUT / _chain_dir(prefix, name)``); their
    ``pcaudio_probe_chain`` entry points by name."""
    return finish_old_builds({
        name: start_build(_chain_dir(prefix, name), text, "pcaudio_probe_chain", CHAIN_ARGS,
                          ("mma.cuh", "hopper.cuh"))
        for name, text in sources.items()})


def chain_stages(dev, where) -> None:
    """The chain as built and with parts left out (CHAIN_VARIANTS), each its
    own library, at the probe's d 64 and 128: what limits the kernel.  The
    whole is held against the plain version on the check inputs; the
    others time parts.  Then the SM clock and power under the whole chain
    on the probe's values and at the signed permutation, and the bound at
    that clock."""
    fns = build_chain_sources(chain_sources(CHAIN_VARIANTS, "chain variant"), "chain_")
    for v in fns:
        for line in ptxas_lines("12chain_kernel", OUT / _chain_dir("chain_", v) / "build.log"):
            print(f"[chain stages] {v}: {line}")
    gen = torch.Generator(dev).manual_seed(0)
    with tf32_off():
        for c in lane_width.cases(dev, gen):
            if not c.name.startswith("chain"):
                continue
            whole = lane_width.chain_check(lambda *a: chain_call(fns["whole"], *a),
                                           c.check_args)
            if not torch.equal(whole, c.check[1]()):
                raise AssertionError(f"{c.name}: the whole chain differs from the plain "
                                     f"version on the check inputs")
            ms = {v: cuda_ms(lambda fn=fn: chain_call(fn, *c.args), c.iters)
                  for v, fn in fns.items()}
            ms["whole (again)"] = cuda_ms(lambda: chain_call(fns["whole"], *c.args), c.iters)
            print(f"[chain stages] {c.name}: " + "; ".join(
                f"{k} {v:.4f} ms" + (f" ({rate(c.ops['bf16'], v, 'bf16')})"
                                     if k.startswith("whole") else "")
                for k, v in ms.items()) + f" ({where})")
            for data, args in (("the probe's values", c.args),
                               ("the signed permutation", c.check_args[0])):
                r = clocks_under_load(lambda args=args: chain_call(fns["whole"], *args))
                t_ms = tensor_bound_ms(c.ops["bf16"], "bf16", r["sm_mhz"], probes.sm_count(0))
                print(f"[chain clocks] {c.name}, {data}: SM clock {r['sm_mhz']:.0f} MHz, "
                      f"power {r['watts']:.1f} W, {r['ms']:.4f} ms a call ({r['samples']} "
                      f"samples), bound at this clock {t_ms:.4f} ms, the call at "
                      f"{100 * t_ms / r['ms']:.1f} % of its rate ({where})")


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
    """One P1 call's and one P6a call's device time by kernel
    (``torch.profiler``), new and earlier; last, since the profiler leaves
    launches slower after it."""
    from pcaudio_torch.ops.kernels.featurize_probes import int16_gram
    from pcaudio_torch.probes.timing import profile_device

    gen = torch.Generator(dev).manual_seed(0)
    a = torch.randn(8, 512, 64, generator=gen, device=dev).bfloat16()
    b = torch.randn(8, 64, 128, generator=gen, device=dev).bfloat16()
    x = torch.randint(-32768, 32767, (int16_load.B, int16_load.L), generator=gen, device=dev,
                      dtype=torch.int16)
    for tag, fn in (("P1, new", lambda: probes.probe_matmul(a, b)),
                    ("P1, earlier design", old.get("old_mma") and (
                        lambda: old_matmul(old["old_mma"], a, b))),
                    ("P6a, new", lambda: int16_gram(x)),
                    ("P6a, earlier design", old.get("old_stream") and (
                        lambda: old_gram(old["old_stream"], x)))):
        if fn:
            per, _ = profile_device(fn, 20)
            for k, ms in per.items():
                print(f"[device] {tag}: {k[:70]} {ms * 1e3:.2f} µs a call "
                      f"(torch.profiler, 20 calls; {where})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pcaudio_torch.probes.probe_stages")
    ap.add_argument("--host", action="store_true", help="split one P1 call's host time")
    ap.add_argument("--attend-stages", action="store_true",
                    help="time P3 with parts left out (ATTEND_VARIANTS)")
    ap.add_argument("--dft-stages", action="store_true",
                    help="time the DFT with parts left out and other clusters (DFT_VARIANTS)")
    ap.add_argument("--chain-stages", action="store_true",
                    help="time P4a's chain with parts left out (CHAIN_VARIANTS), and the "
                         "SM clock and power under it")
    ap.add_argument("--old-mma-source", default=EARLIER_MMA,
                    help="an earlier csrc/probe_mma.cu (default: probes/earlier/)")
    ap.add_argument("--old-attend-source", default=EARLIER_ATTEND,
                    help="an earlier csrc/probe_attend.cu (default: probes/earlier/)")
    ap.add_argument("--old-dft-source", default=EARLIER_DFT,
                    help="an earlier csrc/probe_featurize.cu (default: probes/earlier/)")
    ap.add_argument("--old-stream-source", default=EARLIER_STREAM,
                    help="an earlier csrc/probe_stream.cu (default: probes/earlier/)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_stages needs an NVIDIA GPU")
    dev = torch.device("cuda")
    where = card()
    print(f"[probe_stages] {where}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    jobs = start_old_builds(args.old_mma_source, args.old_attend_source, args.old_dft_source,
                            args.old_stream_source)
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
    if args.dft_stages:
        dft_stages(dev, where)
    if args.chain_stages:
        chain_stages(dev, where)
    if args.host:
        device_times(dev, old, where)


if __name__ == "__main__":
    main()
