"""Where K1's time goes, on the card: the time of ``csrc/fused_st.cu`` at
the bench shape (44,032 clouds of 128 bf16 points, a full-width 3ST made
from a seed) cut after each of its three passes, and of two variants built
from the same source for comparison: one that lets two blocks share an SM
(255 registers, no spills, against three blocks at 168), and one whose
softmax exps are taken out (wrong logits; what the exps cost).  Given the
source of the f32 SIMT design it replaced (``--simt-source``, e.g. from
``git show d9a9fb9:pcaudio_torch/csrc/fused_st.cu``), it also splits that
kernel's time by ISAB 1, ISAB 2 and PMA + Linear.  Each variant is its own shared
library, built with ``nvcc`` into ``build/k1_stages/``.

    python -m pcaudio_torch.probes.k1_stages [--simt-source PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.fused_st import _packed_weights
from pcaudio_torch.probes.st_launch import seeded_3st
from pcaudio_torch.probes.timing import card, cuda_ms, tf32_off

N, K, DIN, M, NCLS = 44032, 128, 3, 64, 10
OUT = _build.BUILD_DIR.parent / "k1_stages"
VARIANTS = {  # name: (text in fused_st.cu, its replacement)
    "two blocks an SM": ("NW == 4 ? 3 : 1", "NW == 4 ? 2 : 1"),
    "exps taken out": ("s[jj][e] = ex2(fmaf(s[jj][e], kC, -ms[e >> 1]));",
                       "s[jj][e] = fmaf(s[jj][e], kC, -ms[e >> 1]);"),
}


def _simt_with_stages(text: str) -> str:
    """The f32 SIMT kernel with a ``stages`` argument that returns after ISAB 1
    (1) or ISAB 2 (2)."""
    edits = [
        ("int K, int M, int ncls) {\n  extern", "int K, int M, int ncls, int stages) {\n  extern"),
        ("  isab<DIN>(xa, xb, s, K, M, w, scale);   // -> xb\n",
         "  isab<DIN>(xa, xb, s, K, M, w, scale);   // -> xb\n  if (stages < 2) return;\n"),
        ("  isab<kDV>(xb, xa, s, K, M, w, scale);   // -> xa\n",
         "  isab<kDV>(xb, xa, s, K, M, w, scale);   // -> xa\n  if (stages < 3) return;\n"),
        ("int K, int M, int ncls,\n           cudaStream_t stream)",
         "int K, int M, int ncls, int stages,\n           cudaStream_t stream)"),
        ("weights, out, K, M, ncls);", "weights, out, K, M, ncls, stages);"),
        ("int din, int M, int ncls, void* stream) {", "int din, int M, int ncls, int stages, void* stream) {"),
        ("(float*)out, N, K, M, ncls, st)", "(float*)out, N, K, M, ncls, stages, st)"),
    ]
    for old, new in edits:
        if old not in text:
            raise ValueError(f"not the f32 SIMT kernel: {old[:40]!r} missing")
        text = text.replace(old, new)
    return text


def _build_lib(name: str, source: str) -> ctypes.CDLL:
    d = OUT / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "mma.cuh").write_text((_build.CSRC / "mma.cuh").read_text())
    (d / "fused_st.cu").write_text(source)
    lib = d / "lib.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                          str(d / "fused_st.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout[-3000:]}{res.stderr[-3000:]}")
    entry = ""
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry" in line:
            entry = line
        elif ("registers" in line or "spill" in line) and "fused_st_kernelILi3E" in entry:
            print(f"[ptxas] {name}: {line.strip()}")
    return ctypes.CDLL(str(lib))


def _simt_pack(model) -> torch.Tensor:
    """The f32 SIMT kernel's weight buffer: linear weights as [in, out],
    the inducing and seed queries projected."""
    def mab(m, with_q):
        out = [m.fc_q.weight.T, m.fc_q.bias] if with_q else []
        return out + [m.fc_k.weight.T, m.fc_k.bias, m.fc_v.weight.T, m.fc_v.bias,
                      m.fc_o.weight.T, m.fc_o.bias]
    with torch.no_grad():
        parts = []
        for isab in model.enc:
            parts += [isab.mab0.fc_q(isab.I[0])] + mab(isab.mab0, False) + mab(isab.mab1, True)
        pma = model.dec[0]
        parts += ([pma.mab.fc_q(pma.S[0])] + mab(pma.mab, False)
                  + [model.dec[1].weight.T, model.dec[1].bias])
        return torch.cat([p.detach().float().reshape(-1) for p in parts]).contiguous()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--simt-source", help="the f32 SIMT design's fused_st.cu")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    name_limit = card()
    src = (_build.CSRC / "fused_st.cu").read_text()
    libs = {"K1": _build.library()}
    for name, (old, new) in VARIANTS.items():
        if old not in src:
            raise ValueError(f"variant {name!r}: {old!r} not in fused_st.cu")
        libs[name] = _build_lib(name, src.replace(old, new))
    model = seeded_3st(dev, torch.Generator(dev).manual_seed(0))
    pts = torch.randn(N, K, DIN, generator=torch.Generator(dev).manual_seed(1),
                      device=dev).bfloat16()
    out = torch.empty(N, NCLS, device=dev)
    wb, wf = _packed_weights(model, dev)
    stream = torch.cuda.current_stream().cuda_stream
    with tf32_off():
        for name, lib in libs.items():
            fn = lib.pcaudio_fused_st
            fn.argtypes = _build._SIGNATURES["pcaudio_fused_st"]

            def launch(passes, fn=fn, name=name):
                code = fn(pts.data_ptr(), 1, None, wb.data_ptr(), wb.numel(), wf.data_ptr(),
                          wf.numel(), out.data_ptr(), N, K, DIN, M, NCLS, passes, stream)
                if code:
                    raise RuntimeError(f"{name}: launch failed ({code})")
            t = [cuda_ms(lambda p=p: launch(p), 5) for p in (1, 2, 3)]
            print(f"[K1 stages] {name}, {N} clouds of {K} points: pass A (ISAB 1 MAB0) "
                  f"{t[0]:.3f} ms, pass B (ISAB 1 MAB1 + ISAB 2 MAB0) {t[1] - t[0]:.3f} ms, "
                  f"pass C (ISAB 2 MAB1 + PMA + Linear) {t[2] - t[1]:.3f} ms, whole "
                  f"{t[2]:.3f} ms ({name_limit})", flush=True)
        if args.simt_source:
            with open(args.simt_source) as f:
                lib = _build_lib("f32 SIMT design", _simt_with_stages(f.read()))
            fn = lib.pcaudio_fused_st
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            w1 = _simt_pack(model)

            def launch_simt(stages):
                code = fn(pts.data_ptr(), 1, None, w1.data_ptr(), w1.numel(), out.data_ptr(),
                          N, K, DIN, M, NCLS, stages, stream)
                if code:
                    raise RuntimeError(f"f32 SIMT design: launch failed ({code})")
            t = [cuda_ms(lambda s=s: launch_simt(s), 3) for s in (1, 2, 3)]
            print(f"[K1 stages] f32 SIMT design, {N} clouds of {K} points: ISAB 1 {t[0]:.3f} ms, "
                  f"ISAB 2 {t[1] - t[0]:.3f} ms, PMA + Linear {t[2] - t[1]:.3f} ms, whole "
                  f"{t[2]:.3f} ms ({name_limit})", flush=True)


if __name__ == "__main__":
    main()
