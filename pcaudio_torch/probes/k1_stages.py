"""Where K1's time goes, on the card: the time of ``csrc/fused_st.cu`` at
the bench shape (44,032 clouds of 128 bf16 points, a full-width 3ST made
from a seed) cut after each of its three passes, and of two variants built
from the same source for comparison: one that lets two blocks share an SM
(255 registers, no spills, against three blocks at 168), and one whose
softmax exps are taken out (wrong logits; what the exps cost).  Given an
earlier ``fused_st.cu`` of the same C interface (``--earlier-source``, e.g.
from ``git show REV:pcaudio_torch/csrc/fused_st.cu``), it times that build
and the package's library whole, in turns (earlier, now, now, earlier), and
compares their SASS of ``fused_st_kernel<3, 4>`` (the serving
instantiation) instruction by instruction.  Each variant is its own shared
library, built through ``_build.build`` with the path's flags, all at once;
ptxas' registers and spills of ``fused_st_kernel<3, NW>`` are printed for
the path's library and each variant.

    python -m pcaudio_torch.probes.k1_stages [--earlier-source PATH]
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess

import torch

from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.fused_st import _packed_weights
from pcaudio_torch.probes.k2_stages import build_variants, print_ptxas
from pcaudio_torch.probes.st_launch import seeded_3st
from pcaudio_torch.probes.timing import card, cuda_ms, tf32_off

N, K, DIN, M, NCLS = 44032, 128, 3, 64, 10
VARIANTS = {  # name: (text in fused_st.cu or fused_st.cuh, its replacement)
    "two blocks an SM": ("NW == 4 ? 3 : 1", "NW == 4 ? 2 : 1"),
    "exps taken out": ("s[jj][e] = ex2(fmaf(s[jj][e], kC, -ms[e >> 1]));",
                       "s[jj][e] = fmaf(s[jj][e], kC, -ms[e >> 1]);"),
}
K1_FILES = ("fused_st.cu", "fused_st.cuh", "mma.cuh")  # the shared-memory form
K1_KERNEL = "fused_st_kernelILi3E"  # its instantiations at din 3


def k1_sources() -> dict:
    """The shared-memory form of K1 as it is built: ``{file name: text}``."""
    return {n: (_build.CSRC / n).read_text() for n in K1_FILES}


def variant_sources(sources: dict, old: str, new: str) -> dict:
    """``sources`` with ``old`` replaced by ``new`` in the one file that
    holds it (once); raises where no file or several hold it."""
    hits = [n for n, text in sources.items() if old in text]
    if len(hits) != 1 or sources[hits[0]].count(old) != 1:
        raise ValueError(f"{old!r} is not in exactly one place of {list(sources)}")
    return {n: text.replace(old, new) if n == hits[0] else text
            for n, text in sources.items()}


def _kernel_sass(lib, kernel: str = "fused_st_kernelILi3ELi4E") -> list:
    """The SASS instructions of the kernel of ``lib`` whose mangled name
    holds ``kernel``, without their addresses and encodings."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ins, inside = [], False
    for line in text.splitlines():
        if "Function : " in line:
            inside = kernel in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                ins.append(m.group(1))
    return ins


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier-source", help="an earlier fused_st.cu of the "
                    "same C interface, compared with today's")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    name_limit = card()
    src = k1_sources()
    builds = {name: variant_sources(src, old, new)
              for name, (old, new) in VARIANTS.items()}
    if args.earlier_source:
        with open(args.earlier_source) as f:
            builds["earlier"] = {"fused_st.cu": f.read()}
    libs = {"K1": _build.library()}
    built = build_variants("k1_", builds,
                           {"pcaudio_fused_st": _build.SIGNATURES["pcaudio_fused_st"]})
    libs.update((n, built[n]) for n in VARIANTS)
    for line in _build.ptxas_lines(_build.NAME, K1_KERNEL):
        if "registers" in line or "spill" in line:
            print(f"[ptxas] K1: {line}")
    print_ptxas("k1_", builds, K1_KERNEL)
    model = seeded_3st(dev, torch.Generator(dev).manual_seed(0))
    pts = torch.randn(N, K, DIN, generator=torch.Generator(dev).manual_seed(1),
                      device=dev).bfloat16()
    out = torch.empty(N, NCLS, device=dev)
    wb, wf = _packed_weights(model, dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, name):
        fn = lib.pcaudio_fused_st

        def launch(passes):
            code = fn(pts.data_ptr(), 1, None, None, wb.data_ptr(), wb.numel(), wf.data_ptr(),
                      wf.numel(), out.data_ptr(), N, K, DIN, M, NCLS, passes, stream)
            if code:
                raise RuntimeError(f"{name}: launch failed ({code})")
        return launch

    with tf32_off():
        for name, lib in libs.items():
            launch = launcher(lib, name)
            t = [cuda_ms(lambda p=p: launch(p), 5) for p in (1, 2, 3)]
            print(f"[K1 stages] {name}, {N} clouds of {K} points: pass A (ISAB 1 MAB0) "
                  f"{t[0]:.3f} ms, pass B (ISAB 1 MAB1 + ISAB 2 MAB0) {t[1] - t[0]:.3f} ms, "
                  f"pass C (ISAB 2 MAB1 + PMA + Linear) {t[2] - t[1]:.3f} ms, whole "
                  f"{t[2]:.3f} ms ({name_limit})", flush=True)
        if args.earlier_source:
            runs = {"earlier": launcher(built["earlier"], "earlier"),
                    "now": launcher(libs["K1"], "K1")}
            turns = ("earlier", "now", "now", "earlier")
            t = [cuda_ms(lambda n=n: runs[n](3), 5) for n in turns]
            a, b = _kernel_sass(built["earlier"]._name), _kernel_sass(libs["K1"]._name)
            print(f"[K1 before/after] {N} clouds of {K} points, whole kernel in turns "
                  + ", ".join(f"{n} {ms:.3f} ms" for n, ms in zip(turns, t))
                  + f"; SASS of fused_st_kernel<3, 4>: {len(a)} / {len(b)} "
                  f"instructions, identical: {a == b} ({name_limit})", flush=True)


if __name__ == "__main__":
    main()
