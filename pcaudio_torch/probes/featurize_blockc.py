"""P8, G clips a block (``scripts/probe_featurize_blockc.py``: ``k_unroll``
at :78, ``k_stack`` at :93): on the TPU, whether processing G clips per grid
step amortises a fixed per-step cost of the DFT-as-matmul featurize core.
Here the same core, K3's DFT as one bf16 tensor-core product a clip with
|·|² in the epilogue (``dft_mag2``), on 1024 clips of 220,672 samples (R =
431 frames of hop 512, F = 512, 43 chunks of 10 frames), in two forms:

- unrolled: G ∈ {1, 2, 4, 8} clips a block, each clip's 430 frames in
  row tiles of 128 (4 tiles, 84 % of the rows useful);
- stacked: G ∈ {2, 4, 8}, one row space of G·431 − 1 frames over the G
  clips (99.5 % useful at G = 8), whose seam frames are computed and not
  written.

The bound counts the useful work only, 2·2·B·(R − 1)·hop·2F bf16
operations.  The library yardstick is a composite of calls: x → bf16, two
bf16 ``torch.matmul``, re² + im², the rows, → bf16.

    python -m pcaudio_torch.probes featurize_blockc
"""
from __future__ import annotations

import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.ops.kernels.featurize_probes import (
    dft_mag2, dft_mag2_bound, dft_mag2_plain, dft_rows_per_block, select_frames)
from pcaudio_torch.probes.timing import Case, measure, tf32_off

SOURCE = "pcaudio_torch/csrc/probe_featurize.cu"
REPLACES = {False: "scripts/probe_featurize_blockc.py:78",
            True: "scripts/probe_featurize_blockc.py:93"}
B, L = 1024, 220672
N_FFT, HOP, NT = 1024, 512, 10
INSTRUCTION = ("wgmma.mma_async.m64n256k16.f32.bf16.bf16, A from registers (one f32 TMA "
               "box a stage for both halves; persistent blocks)")
F = N_FFT // 2
R = L // HOP
C = (1 + R) // NT
FORMS = [(1, False), (2, False), (4, False), (8, False), (2, True), (4, True), (8, True)]


def inputs(dev, gen, batch):
    """The scripts' inputs: waves 0.1·N(0, 1) f32 viewed as [B, R, hop]; w0
    and w1 N(0, 1) → bf16 [hop, 2F]."""
    x3 = (0.1 * torch.randn(batch, L, generator=gen, device=dev)).view(batch, R, HOP)
    w0, w1 = (torch.randn(HOP, 2 * F, generator=gen, device=dev).bfloat16()
              for _ in range(2))
    return x3, w0, w1


def library(x3, w0, w1, mode="direct", s0=None):
    """Composite yardstick of the same function through PyTorch calls."""
    def call():
        xb = x3.bfloat16()
        reim = torch.matmul(xb[:, :-1], w0) + torch.matmul(xb[:, 1:], w1)
        m2 = reim[..., :F].float().square() + reim[..., F:].float().square()
        return select_frames(m2, x3, C, NT, mode, s0).bfloat16().view(-1, C, NT, F)
    return call


def work(x3, w0, written=None):
    """(bf16 operations, bytes) of the useful work: the wave read once, W,
    and the output rows written (all of them unless ``written`` says)."""
    batch = x3.shape[0]
    ops = 4.0 * batch * (R - 1) * HOP * w0.shape[1]
    rows = batch * C * NT if written is None else int(written.sum())
    return {"bf16": ops}, 4.0 * x3.numel() + 4.0 * w0.numel() + 2.0 * rows * F


def case(name, kernel, plain, bound, replaces, x3, w0, written=None, library_call=None,
         check=None, args=()):
    """``args``: ``dft_mag2``'s (x3, w0, w1, C, Nt, mode, s0, G, stacked),
    for another design of the kernel."""
    ops, nbytes = work(x3, w0, written)
    return Case(name, kernel, plain, bound, dft_mag2, SOURCE, replaces, INSTRUCTION,
                ops=ops, nbytes=nbytes, library=library_call,
                library_note="x → bf16, 2 bf16 torch.matmul, re² + im², rows → bf16 "
                             "(a composite of calls)",
                iters=10, plain_iters=1, check=check, args=args)


def cases(dev, gen, batch=B):
    x3, w0, w1 = inputs(dev, gen, batch)
    plain = lambda: dft_mag2_plain(x3, w0, w1, C, NT)  # noqa: E731
    bound = lambda ref: dft_mag2_bound(x3, w0, w1, C, NT)  # noqa: E731
    lib = library(x3, w0, w1)
    return [case(f"G={G} {'stacked' if st else 'unrolled'}",
                 lambda G=G, st=st: dft_mag2(x3, w0, w1, C, NT, G=G, stacked=st),
                 plain, bound, REPLACES[st], x3, w0, library_call=lib,
                 args=(x3, w0, w1, C, NT, "direct", None, G, st))
            for G, st in FORMS]


def run(device="cuda", seed=0) -> dict:
    """Times and errors per form (see ``timing.measure``)."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        return {c.name: measure(c) for c in cases(dev, gen)}


def summary(res) -> list:
    lines = []
    for G, st in FORMS:
        r = res[f"G={G} {'stacked' if st else 'unrolled'}"]
        _, rows, useful = dft_rows_per_block(R, G, st)
        tflops = 4.0 * B * (R - 1) * HOP * 2 * F / (r["ms"] * 1e-3) / 1e12
        lines.append(f"G={G} {'stacked ' if st else 'unrolled'}: {r['ms']:.3f} ms = "
                     f"{r['ms'] * 1e3 / B:.2f} µs/clip, {tflops:.0f} useful TFLOP/s, "
                     f"{100.0 * useful / rows:.1f} % of the computed rows useful, "
                     f"bound {r['bound_ms']:.3f} ms, library {r['library_ms']:.3f} ms")
    return lines

