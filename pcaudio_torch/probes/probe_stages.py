"""The probe kernels redesigned for Hopper (``csrc/probe_mma.cu``'s
windowed GEMM, P1 and P2, and bf16 chain, P4a; ``csrc/probe_attend.cu``'s
v6 attend, P3; ``csrc/probe_stream.cu``'s int16 gram, P6a;
``csrc/probe_featurize.cu``'s DFT, P8 and P9), on the card, in one process.

At every shape of P1, P2a-c, P3, P4a (d 64 and 128), P6a, P8 (seven forms)
and P9 (five variants) the script holds the kernel against its plain
version (P9 on the rows a variant writes, P4a exactly on its check
inputs), times plain, kernel, kernel, plain and the library call (CUDA
events, ``timing.measure``), and prints each beside the bound, TFLOP/s and
% of the data sheet's peak; for P4a also the SM clock the card holds under
the kernel and the bound at that clock.  An earlier design of a probe
kernel is in git (``git show REV:pcaudio_torch/csrc/probe_mma.cu``).

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
timed by ``time.perf_counter``; then the whole wrapper, one ``torch.bmm``,
and one K4 forward launch at the FST step's MAB0 attend with the stream
looked up through ``torch.cuda.current_stream`` and through
``_build.stream_of``, in turns; last (the profiler slows later launches),
P1's and P6a's device time a call.

Every library is built through ``_build.build``: the probe library and
each variant, all at once.

    python -m pcaudio_torch.probes.probe_stages [--host] [--attend-stages]
        [--dft-stages] [--chain-stages]

(about 60 s on the card with its builds; each stage flag adds its own).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from pcaudio_torch.ops.kernels import _build, probes
from pcaudio_torch.ops.kernels.featurize_probes import DFT_MODES, dft_plan, dft_written
from pcaudio_torch.probes import (
    batched_dot, featurize_blockc, featurize_variants, int8_attend, int8_matmul, int16_load,
    lane_width)
from pcaudio_torch.probes.k2_stages import apply_edits, build_variants, variant_name
from pcaudio_torch.probes.timing import (
    PEAK_OPS_PER_S, abs_err, card, cuda_ms, measure, tensor_bound_ms, tf32_off)

CALLS = 1000


def per_call_us(fn, calls: int = CALLS) -> float:
    """Mean µs of host time per call over ``calls`` calls, no synchronise
    between them (the card is synchronised before the first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def build_probe_variants(prefix: str, file: str, texts: dict, entry: str) -> dict:
    """Each text of ``file`` built as a library of its own
    (``k2_stages.build_variants``), all at once; their entry points
    ``entry``, bound to the probe library's prototype, by name."""
    libs = build_variants(prefix, {name: {file: text} for name, text in texts.items()},
                          {entry: probes.SIGNATURES[entry]})
    return {name: getattr(lib, entry) for name, lib in libs.items()}


def chain_call(fn, x, w, reps, repeats):
    """``probe_chain``'s launch through another build's entry point ``fn``."""
    _, ptr = probes._chain_call(x.shape, w.shape, x.dtype, w.dtype, reps, repeats,
                                x.get_device())
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), ptr, _build.stream_of(x))
    if code:
        raise RuntimeError(f"a chain build's pcaudio_probe_chain failed ({code})")
    return out


def rate(work: float, ms: float, kind: str) -> str:
    """``work`` operations of type ``kind`` in ``ms``: the rate and its
    share of the card's peak."""
    per_s = work / (ms * 1e-3)
    unit = "TOP/s" if kind == "int8" else "TFLOP/s"
    return (f"{per_s / 1e12:.1f} {unit}, {100 * per_s / PEAK_OPS_PER_S[kind]:.1f} % of the "
            f"data sheet's peak")


def redesigned_cases(dev, gen) -> list:
    """(tag, case) for every shape of the redesigned probe kernels: P1,
    P2a-c, P4a at d 64 and 128, P3, P6a, P8's seven forms and P9's five
    variants."""
    out = []
    for c in batched_dot.cases(dev, gen) + int8_matmul.cases(dev, gen):
        tag = {"batched_dot": "P1", "small int8": "P2a"}.get(c.name)
        out.append((tag or {"big": "P2b", "attend": "P2c"}[c.name.split()[0]], c))
    out += [("P4a", c) for c in lane_width.cases(dev, gen) if c.name.startswith("chain")]
    out += [("P3 attend", c) for c in int8_attend.cases(dev, gen)]
    out += [("P6a int16 gram", c) for c in int16_load.cases(dev, gen) if c.name == "kern"]
    out += [("P8", c) for c in featurize_blockc.cases(dev, gen)]
    out += [("P9", c) for c in featurize_variants.cases(dev, gen)]
    return out


def compare(dev, where: str) -> None:
    """Each redesigned probe kernel at every shape, held against its plain
    version (on the check inputs where a case has them) and timed in turns
    with it (``timing.measure``), beside its bound and its rate."""
    gen = torch.Generator(dev).manual_seed(0)
    with tf32_off():
        for tag, c in redesigned_cases(dev, gen):
            r = measure(c)
            kind = next(k for k in c.ops if k != "sfu")
            parts = [f"kernel {r['ms']:.4f} ms ({rate(c.ops[kind], r['ms'], kind)})",
                     f"plain {r['plain_ms']:.4f} ms",
                     "library " + ("none" if r["library_ms"] is None
                                   else f"{r['library_ms']:.4f} ms"),
                     f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}"]
            if tag == "P4a":  # the bound at the clock the card holds under it
                mhz = clocks_under_load(c.kernel, seconds=2.0)["sm_mhz"]
                t_ms = tensor_bound_ms(c.ops["bf16"], "bf16", mhz, probes.sm_count(0))
                parts.append(f"at the {mhz:.0f} MHz held under the kernel bound "
                             f"{t_ms:.4f} ms, the kernel at {100 * t_ms / r['ms']:.1f} % "
                             f"of its rate")
            parts.append(f"max |err| {r['max_abs_err']:.3e} (bound {r['tol']:.3e}"
                         + (", on the check inputs)" if c.check else ")"))
            print(f"[compare] {tag} {c.name}: " + "; ".join(parts) + f" ({where})")
            del r


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
    fns = build_probe_variants("attend_", "probe_attend.cu", attend_variant_sources(),
                               "pcaudio_probe_attend")
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
    return build_probe_variants(prefix, "probe_featurize.cu", sources,
                                "pcaudio_probe_dft_mag2")


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
    for line in _build.ptxas_lines(probes.NAME, "dft_mag2_kernel"):
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


def build_chain_sources(sources: dict, prefix: str) -> dict:
    """Each chain source of ``sources`` built into its own library at once;
    their ``pcaudio_probe_chain`` entry points by name."""
    return build_probe_variants(prefix, "probe_mma.cu", sources, "pcaudio_probe_chain")


def chain_stages(dev, where) -> None:
    """The chain as built and with parts left out (CHAIN_VARIANTS), each its
    own library, at the probe's d 64 and 128: what limits the kernel.  The
    whole is held against the plain version on the check inputs; the
    others time parts.  Then the SM clock and power under the whole chain
    on the probe's values and at the signed permutation, and the bound at
    that clock."""
    fns = build_chain_sources(chain_sources(CHAIN_VARIANTS, "chain variant"), "chain_")
    for v in fns:
        for line in _build.ptxas_lines(variant_name("chain_", v), "12chain_kernel"):
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


def host_split(dev) -> dict:
    """µs a call of each piece of one P1 launch (bf16 [8, 512, 64] ·
    [8, 64, 128]), of the whole wrapper, of ``torch.bmm`` and of one K4
    forward at the FST step's MAB0 attend (B = 128, 64 queries, 1025 keys)
    with the stream looked up through ``torch.cuda.current_stream`` and
    through ``_build.stream_of``."""
    from pcaudio_torch.ops.kernels.mha import fused_mha_fwd

    gen = torch.Generator(dev).manual_seed(0)
    a = torch.randn(8, 512, 64, generator=gen, device=dev).bfloat16()
    b = torch.randn(8, 64, 128, generator=gen, device=dev).bfloat16()
    lib = probes.library()
    out = torch.empty(8, 512, 128, device=dev)
    stream = _build.stream_of(a)
    call = probes._matmul_call(a.shape, b.shape, a.dtype, b.dtype, 1, 0, 1, 0)
    args = [a.data_ptr(), b.data_ptr(), out.data_ptr(), call.params_ptr, stream]
    bad = (ctypes.c_int * 12)(*call.params)
    bad[3] = 0  # M = 0: the entry point returns before any launch
    refused = args[:3] + [ctypes.addressof(bad), stream]
    launch = probes.launch

    def wrapper_without_launch():
        probes.launch = lambda *args: None
        try:
            probes.probe_matmul(a, b)
        finally:
            probes.launch = launch
    res = {
        "checks (uncached)": per_call_us(lambda: probes._check_matmul(a, b, 1, 0, 1)),
        "checks and plan (cached)": per_call_us(
            lambda: probes._matmul_call(a.shape, b.shape, a.dtype, b.dtype, 1, 0, 1,
                                        a.get_device())),
        "torch.empty": per_call_us(lambda: torch.empty((8, 512, 128), device=dev)),
        "a.new_empty": per_call_us(lambda: a.new_empty((8, 512, 128), dtype=torch.float32)),
        "wrapper without its launch": per_call_us(wrapper_without_launch),
        "stream_of (raw stream)": per_call_us(lambda: _build.stream_of(a)),
        "torch.cuda.current_stream(device)": per_call_us(
            lambda: torch.cuda.current_stream(a.device).cuda_stream),
        "ctypes call, refused (no launch)": per_call_us(
            lambda: lib.pcaudio_probe_matmul(*refused)),
        "ctypes call that launches": per_call_us(lambda: lib.pcaudio_probe_matmul(*args)),
        "probes.launch that launches": per_call_us(
            lambda: probes.launch("pcaudio_probe_matmul", *args)),
        "wrapper": per_call_us(lambda: probes.probe_matmul(a, b)),
        "torch.bmm": per_call_us(lambda: torch.bmm(a, b)),
    }
    q = torch.randn(128, 64, 64, generator=gen, device=dev)
    k = torch.randn(128, 1025, 64, generator=gen, device=dev)
    present = _build.stream_of

    def current_stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream
    for turn in ("current_stream", "stream_of", "stream_of", "current_stream"):
        _build.stream_of = current_stream if turn == "current_stream" else present
        try:
            us = per_call_us(lambda: fused_mha_fwd(q, k, k, None, 8, 0.125))
        finally:
            _build.stream_of = present
        key = f"K4 forward launch (fused_mha_fwd, MAB0), stream by {turn}"
        res[key] = (res.get(key, 0.0) + us / 2)
    torch.cuda.synchronize()
    return res


def device_times(dev, where: str) -> None:
    """One P1 call's and one P6a call's device time by kernel
    (``torch.profiler``); last, since the profiler leaves launches slower
    after it."""
    from pcaudio_torch.ops.kernels.featurize_probes import int16_gram
    from pcaudio_torch.probes.timing import profile_device

    gen = torch.Generator(dev).manual_seed(0)
    a = torch.randn(8, 512, 64, generator=gen, device=dev).bfloat16()
    b = torch.randn(8, 64, 128, generator=gen, device=dev).bfloat16()
    x = torch.randint(-32768, 32767, (int16_load.B, int16_load.L), generator=gen, device=dev,
                      dtype=torch.int16)
    for tag, fn in (("P1", lambda: probes.probe_matmul(a, b)), ("P6a", lambda: int16_gram(x))):
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_stages needs an NVIDIA GPU")
    dev = torch.device("cuda")
    where = card()
    print(f"[probe_stages] {where}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    # the path's library for --host's K4 launch, built beside the probes'
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(probes.library)] + (
                [pool.submit(_build.library)] if args.host else []):
            job.result()
    print(f"[probe_stages] built in {time.perf_counter() - t0:.1f} s")
    if args.host:
        for name, us in host_split(dev).items():
            print(f"[host] {name}: {us:.2f} µs a call ({CALLS} calls, no "
                  f"synchronise; {where})")
    compare(dev, where)
    if args.attend_stages:
        attend_stages(dev, where)
    if args.dft_stages:
        dft_stages(dev, where)
    if args.chain_stages:
        chain_stages(dev, where)
    if args.host:
        device_times(dev, where)


if __name__ == "__main__":
    main()
