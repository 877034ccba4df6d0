"""The K3-family probe kernels (``csrc/probe_stream.cu``,
``csrc/probe_featurize.cu``): the H100 counterparts of the TPU timing probes
behind K3's design questions, each beside its plain PyTorch version.

  int16_gram       P6a ``scripts/probe_int16_load.py`` ``kern``: int16 rows
                   → f32 ·(1/32768), then x·xᵀ
  wave_block_sums  P6b ``probe_int16_load.py`` ``kern2``: one f32 sum per
                   [rows, L] block of int16 or f32 waves
  chunk_relayout   P7 ``scripts/probe_chunk_relayout.py`` ``k_pass`` and
                   ``k_reshape``: x + 1, written as frame rows or as chunk
                   lane blocks
  dft_mag2         P8 ``scripts/probe_featurize_blockc.py`` (``k_unroll``,
                   ``k_stack``) and P9 ``scripts/profile_featurize_variants.py``
                   (``k_matmul``, ``k_matmul_f``, ``k_scratch``, ``k_full``,
                   ``k_nozero``): the DFT of K3 as one bf16 product a clip,
                   |·|² in the epilogue, rows shifted per clip
                   (:func:`dft_plan` is the kernel's tiling in Python)

CPU tensors take the plain versions; CUDA tensors the kernels, never a
fallback.  The plain versions compute in f32 (the card's TF32 off).
:func:`dft_mag2_bound` is the elementwise bound on |kernel − plain| that
P8 and P9 are held to; the other probes are exact on their check inputs
(P6a is held to ``probes.matmul_bound``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.probes import U32, launch, sm_count

PCM_SCALE = 1.0 / 32768.0   # int16 PCM → [-1, 1): a power of two, exact
LANES = 128                 # P7's chunk lane block
DFT_BF = 128                # dft_mag2's frequencies a block (F a multiple)
DFT_BM = 128                # dft_mag2's frame rows a block
DFT_STAGE_K = 32            # samples of the hop a stage (hop a multiple of 2×)
BF16_U = 2.0 ** -8          # bf16 unit roundoff
# dft_mag2's row modes: the source frame of output row j of clip b is
# j + shift(b); "direct" has shift 0 (k_matmul, k_matmul_f, k_unroll,
# k_stack), "shift" s0 − 1 with the rows that have no source zeroed
# (k_full), "shift_nozero" the same rows and no zero fill (k_nozero),
# "aligned" 8·⌊(7 + s0)/8⌋ − 8 and no zero fill (k_scratch).  Rows
# without a source are left unwritten in the last two.
DFT_MODES = ("direct", "shift", "shift_nozero", "aligned")


def _cuda_contiguous(*ts):
    if not all(t.is_cuda and t.is_contiguous() for t in ts):
        raise ValueError("the kernel takes contiguous CUDA tensors")


# ---- P6a: int16 load, convert, x·xᵀ --------------------------------------

def _check_gram_shape(shape, dtype):
    if dtype != torch.int16 or len(shape) != 2:
        raise ValueError(f"x must be int16 [n, L], got {dtype} {tuple(shape)}")


@functools.lru_cache(maxsize=256)
def _gram_call(shape, dtype):
    """One call's checks, made once per shape: ``(n, L)``."""
    _check_gram_shape(shape, dtype)
    return int(shape[0]), int(shape[1])


def pcm_to_float(x):
    """int16 PCM → f32 in [-1, 1) (exact)."""
    return x.float() * PCM_SCALE


def int16_gram_plain(x):
    """Plain version of :func:`int16_gram`: one f32 product."""
    _check_gram_shape(x.shape, x.dtype)
    xf = pcm_to_float(x)
    return xf @ xf.t()


def int16_gram(x):
    """``x [n, L]`` int16 → ``[n, n]`` f32: ``(x/32768)·(x/32768)ᵀ``.  One
    tiled SIMT kernel (f32 FMAs; 8 × 8 outputs a block, each output's K
    split over 4 threads, K staged 512 at a time) on the card, any shape;
    CPU tensors take :func:`int16_gram_plain`."""
    if x.device.type == "cpu":
        return int16_gram_plain(x)
    _cuda_contiguous(x)
    n, L = _gram_call(x.shape, x.dtype)
    out = x.new_empty((n, n), dtype=torch.float32)
    launch("pcaudio_probe_int16_gram", x.data_ptr(), out.data_ptr(), n, L,
           _build.stream_of(x))
    int16_gram.launches += 1
    return out


int16_gram.launches = 0


# ---- P6b: one sum per wave block -----------------------------------------

def _check_sums(x):
    if x.dtype not in (torch.int16, torch.float32) or x.dim() != 3:
        raise ValueError(f"x must be int16 or float32 [n, rows, L], got {x.dtype} "
                         f"{tuple(x.shape)}")


def wave_block_sums_plain(x):
    """Plain version of :func:`wave_block_sums`."""
    _check_sums(x)
    out = torch.zeros((x.shape[0], 2), dtype=torch.float32, device=x.device)
    out[:, 0] = x.float().sum(dim=(1, 2))
    return out


def wave_block_sums(x):
    """``x [n, rows, L]`` int16 or f32 → ``[n, 2]`` f32: column 0 is the f32
    sum of block c, column 1 is 0 (the script's column 1 is never written).
    One block of 16-byte loads per wave on the card; CPU tensors take
    :func:`wave_block_sums_plain`.  Sums of integers below 2^24 are exact in
    any order."""
    if x.device.type == "cpu":
        return wave_block_sums_plain(x)
    _check_sums(x)
    _cuda_contiguous(x)
    n, rows, L = x.shape
    if (rows * L * x.element_size()) % 16:
        raise ValueError(f"a block of {rows}x{L} {x.dtype} is not whole 16-byte loads")
    out = torch.empty((n, 2), dtype=torch.float32, device=x.device)
    launch("pcaudio_probe_wave_sums", x.data_ptr(), out.data_ptr(), n,
           rows * L, int(x.dtype == torch.int16), _build.stream_of(x))
    wave_block_sums.launches += 1
    return out


wave_block_sums.launches = 0


# ---- P7: frame rows → chunk lane blocks -----------------------------------

def _check_relayout(x, C, Nt):
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[1] != C * Nt:
        raise ValueError(f"x must be float32 [B, C·Nt = {C * Nt}, F], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if (Nt * x.shape[2]) % LANES:
        raise ValueError(f"Nt·F = {Nt * x.shape[2]} is not a multiple of {LANES}")


def _relayout_shape(x, C, Nt, reshape):
    B, _, F = x.shape
    return (B, C, Nt * F // LANES, LANES) if reshape else tuple(x.shape)


def chunk_relayout_plain(x, C, Nt, reshape):
    """Plain version of :func:`chunk_relayout`."""
    _check_relayout(x, C, Nt)
    return (x + 1.0).reshape(_relayout_shape(x, C, Nt, reshape))


def chunk_relayout(x, C, Nt, reshape):
    """``x [B, C·Nt, F]`` f32 → ``x + 1``, as ``[B, C·Nt, F]`` (``k_pass``)
    or, with ``reshape``, as ``[B, C, Nt·F/128, 128]`` (``k_reshape``).
    The reshape kernel computes each source index from the output's
    [C, nb, 128] index (integer division by the runtime widths), so it
    measures the index arithmetic the relayout asks for.  CPU tensors take
    :func:`chunk_relayout_plain`."""
    if x.device.type == "cpu":
        return chunk_relayout_plain(x, C, Nt, reshape)
    _check_relayout(x, C, Nt)
    _cuda_contiguous(x)
    F = x.shape[2]
    if F % 4:
        raise ValueError(f"the kernel takes F a multiple of 4, got {F}")
    out = torch.empty(_relayout_shape(x, C, Nt, reshape), dtype=torch.float32,
                      device=x.device)
    launch("pcaudio_probe_relayout", x.data_ptr(), out.data_ptr(),
           x.shape[0], C, Nt, F, int(reshape), _build.stream_of(x))
    chunk_relayout.launches += 1
    return out


chunk_relayout.launches = 0


# ---- P8, P9: the DFT as a bf16 product, |·|² in the epilogue --------------

def _check_dft(x3, w0, w1, C, Nt, mode, s0):
    if mode not in DFT_MODES:
        raise ValueError(f"mode must be one of {DFT_MODES}, got {mode!r}")
    if x3.dtype != torch.float32 or x3.dim() != 3:
        raise ValueError(f"x3 must be float32 [B, R, hop], got {x3.dtype} "
                         f"{tuple(x3.shape)}")
    B, R, hop = x3.shape
    if (w0.dtype != torch.bfloat16 or w1.dtype != torch.bfloat16
            or w0.shape != w1.shape or w0.dim() != 2 or w0.shape[0] != hop
            or w0.shape[1] % 2):
        raise ValueError(f"w0, w1 must be bfloat16 [hop = {hop}, 2F], got "
                         f"{w0.dtype} {tuple(w0.shape)}, {w1.dtype} {tuple(w1.shape)}")
    if C * Nt < 1 or (mode == "direct" and C * Nt > R - 1):
        raise ValueError(f"C·Nt = {C * Nt} rows do not fit {R - 1} frames")
    if mode != "direct" and (s0 is None or s0.shape != (B,) or s0.dtype != torch.int32):
        raise ValueError(f"mode {mode!r} needs s0, int32 [B = {B}]")


def _source_frames(x3, C, Nt, mode, s0):
    """``[B, C·Nt]``: the source frame of each output row, ``j + shift``
    (a frame exists where it lies in ``[0, R − 2]``)."""
    j = torch.arange(C * Nt, device=x3.device)
    if mode == "direct":
        return j.expand(x3.shape[0], -1)
    s0 = s0.long()[:, None]
    return j + ((7 + s0) // 8 * 8 - 8 if mode == "aligned" else s0 - 1)


def dft_written(x3, C, Nt, mode="direct", s0=None):
    """``[B, C, Nt]`` bool: the output rows the kernel writes, every row
    but, in "shift_nozero" and "aligned", those without a source frame
    (which hold whatever the output held before).  The check compares
    these rows only."""
    if mode in ("direct", "shift"):
        return torch.ones(x3.shape[0], C, Nt, dtype=torch.bool, device=x3.device)
    src = _source_frames(x3, C, Nt, mode, s0)
    return ((src >= 0) & (src <= x3.shape[1] - 2)).reshape(-1, C, Nt)


def _dft_reim(x3, w0, w1):
    """re, im ``[B, R − 1, F]`` f32 of ``x[:R−1]·w0 + x[1:]·w1`` (x rounded
    to bf16, f32 sums), as the scripts' kernels compute them."""
    xb = x3.bfloat16().float()
    reim = xb[:, :-1] @ w0.float() + xb[:, 1:] @ w1.float()
    F = w0.shape[1] // 2
    return reim[..., :F], reim[..., F:]


def select_frames(m, x3, C, Nt, mode="direct", s0=None):
    """``m [B, R − 1, F]`` → ``[B, C·Nt, F]``, each output row its source
    frame's, 0 where it has none."""
    src = _source_frames(x3, C, Nt, mode, s0)
    ok = (src >= 0) & (src <= m.shape[1] - 1)
    rows = torch.gather(m, 1, src.clamp(0, m.shape[1] - 1)[..., None].expand(
        -1, -1, m.shape[2]))
    return torch.where(ok[..., None], rows, torch.zeros_like(rows))


def dft_mag2_plain(x3, w0, w1, C, Nt, mode="direct", s0=None):
    """Plain version of :func:`dft_mag2`: the whole ``[B, R − 1, 2F]``
    product in f32, then ``re² + im²``, the rows, bf16; rows without a
    source are 0 in every mode."""
    _check_dft(x3, w0, w1, C, Nt, mode, s0)
    if mode != "direct" and bool((s0 < 0).any()):
        raise ValueError("s0 must be ≥ 0")
    re, im = _dft_reim(x3, w0, w1)
    m2 = re * re + im * im
    out = select_frames(m2, x3, C, Nt, mode, s0).bfloat16()
    return out.reshape(x3.shape[0], C, Nt, -1)


def dft_mag2_bound(x3, w0, w1, C, Nt, mode="direct", s0=None):
    """|kernel − plain| bound, elementwise, ``[B, C, Nt, F]`` f32:

    - re and im are f32 sums of K = 2·hop exact bf16 products on both
      sides, in another order: each within 2(K + 1)·u·Σ|a||w| (u = 2^-24),
      δre and δim, as ``probes.matmul_bound``;
    - ``re² + im²`` carries that as 2(|re|δre + |im|δim) + δre² + δim² (the
      squares and the sum round alike on both sides: the kernel uses
      ``__fmul_rn``/``__fadd_rn``, no contraction);
    - each side rounds to bf16 once: 2·2^-8 of the value;

    all by (1 + 2^-6) for the bound's own f32 arithmetic.  Rows without a
    source have bound 0 (the plain version writes 0 there; the check
    compares the kernel's defined rows only)."""
    _check_dft(x3, w0, w1, C, Nt, mode, s0)
    K = 2 * x3.shape[2]
    re, im = _dft_reim(x3, w0, w1)
    xa = x3.bfloat16().float().abs()
    mag = xa[:, :-1] @ w0.float().abs() + xa[:, 1:] @ w1.float().abs()
    F = w0.shape[1] // 2
    d_re = 2 * (K + 1) * U32 * mag[..., :F]
    d_im = 2 * (K + 1) * U32 * mag[..., F:]
    del mag
    d_m2 = 2 * (re.abs() * d_re + im.abs() * d_im) + d_re * d_re + d_im * d_im
    tol = (1 + 2.0 ** -6) * (d_m2 * (1 + BF16_U) + 2 * BF16_U * (re * re + im * im))
    return select_frames(tol, x3, C, Nt, mode, s0).reshape(x3.shape[0], C, Nt, -1)


@dataclass(frozen=True)
class DftPlan:
    """``csrc/probe_featurize.cu``'s tiling of one call.  A unit is one
    (column block bx, row tile by, group bz of G clips), numbered u = (bz ·
    tiles + by) · cols + bx; persistent block b runs units b, b + blocks,
    ….  A unit runs ``passes`` segments one after another: each of its G
    clips, or, stacked, the G clips as one row space.  A segment's product
    row s is frame s mod R of clip s // R of the segment, computed from
    wave rows s and s + 1 of the segment (x3 viewed as [B·R, hop] rows),
    and written where it is a frame (s mod R < R − 1, s < ``seg_rows``)."""
    B: int
    R: int
    hop: int
    F: int
    G: int
    stacked: bool
    seg_rows: int   # product rows of a segment: G·R − 1 stacked, else R − 1
    tiles: int      # row tiles of DFT_BM a segment needs
    units: tuple    # (cols = F / DFT_BF, tiles, groups = B / G)
    blocks: int     # persistent blocks: one an SM, at most one a unit
    passes: int     # segments a unit runs one after another
    nk: int         # stages of DFT_STAGE_K samples a pass

    def block_units(self, b):
        """The units block ``b`` runs, in order, as (bx, by, bz)."""
        cols, tiles, groups = self.units
        return [(u % cols, u // cols % tiles, u // (cols * tiles))
                for u in range(b, cols * tiles * groups, self.blocks)]


def dft_plan(B, R, hop, F, G=1, stacked=False, mode="direct", sms=132):
    """The kernel's plan for ``x3 [B, R, hop]``, ``F`` frequencies, ``G``
    clips a unit, on ``sms`` SMs; raises ``ValueError`` naming the limit
    for what its tiles do not take."""
    if (F < DFT_BF or F % DFT_BF or hop < 2 * DFT_STAGE_K or hop % (2 * DFT_STAGE_K)
            or G < 1 or B % G or R < 2 or (stacked and mode != "direct")):
        raise ValueError(
            f"the kernel takes F a multiple of {DFT_BF} (got {F}), hop a multiple of "
            f"{2 * DFT_STAGE_K} (got {hop}), B = {B} a multiple of G = {G}, and "
            f"stacked rows in direct mode only")
    seg_rows = G * R - 1 if stacked else R - 1
    tiles = -(-seg_rows // DFT_BM)
    if B * R >= 2 ** 31:
        raise ValueError(f"the kernel takes B·R < 2^31 wave rows, got {B * R}")
    units = (F // DFT_BF, tiles, B // G)
    return DftPlan(B, R, hop, F, G, bool(stacked), seg_rows, tiles, units,
                   min(sms, units[0] * units[1] * units[2]), 1 if stacked else G,
                   hop // DFT_STAGE_K)


def dft_tile_rows(plan, by, bz, pass_=0):
    """What unit (·, ``by``, ``bz``) computes in pass ``pass_``: the flat
    wave row of its wave box's first row (the box holds rows row0 …
    row0 + DFT_BM, zeros past B·R), and, for each of its DFT_BM product
    rows, the clip, the frame and whether it is a frame the kernel writes
    (the epilogue's rule), as ``[DFT_BM]`` tensors."""
    seg = bz * plan.G + (0 if plan.stacked else pass_)   # the segment's first clip
    s = by * DFT_BM + torch.arange(DFT_BM)              # rows in the segment
    c = s // plan.R if plan.stacked else torch.zeros_like(s)
    r = s - c * plan.R
    frame = (s < plan.seg_rows) & (r < plan.R - 1)
    return seg * plan.R + by * DFT_BM, seg + c, r, frame


def dft_mag2(x3, w0, w1, C, Nt, mode="direct", s0=None, G=1, stacked=False):
    """K3's DFT core, as the TPU probes P8 and P9 run it: ``x3 [B, R, hop]``
    f32 waves (frame r is ``[x[r], x[r+1]]``), ``w0, w1 [hop, 2F]`` bf16 →
    ``[B, C, Nt, F]`` bf16 where output row j of clip b is
    ``|x[s]·w0 + x[s+1]·w1|²`` (re the first F columns, im the last) of the
    source frame ``s = j + shift`` (``mode``, :data:`DFT_MODES`; s0 ≥ 0,
    which only the plain version checks: a check on the card would wait for
    it, and the kernel bounds every row whatever s0 holds).

    On the card one persistent ``wgmma`` kernel (:func:`dft_plan`): a unit
    is 128 frame rows × 128 frequencies (re and im as one 256-column B
    tile, paired in registers, |·|² formed there), the wave by one TMA box
    a stage for both halves of the frame, rounded to bf16 in registers, w0
    and w1 by TMA as they lie.  ``G`` clips go to one unit: one after
    another (per-clip tiles), or with ``stacked`` as one row space over the
    G clips' frames (direct mode only), whose seam frames are computed and
    not written.  B must be a multiple of G, F of 128 and hop of 64.  CPU
    tensors take :func:`dft_mag2_plain` (G and stacked only change the
    kernel's blocking)."""
    if x3.device.type == "cpu":
        return dft_mag2_plain(x3, w0, w1, C, Nt, mode, s0)
    _check_dft(x3, w0, w1, C, Nt, mode, s0)
    B, R, hop = x3.shape
    F = w0.shape[1] // 2
    plan = dft_plan(B, R, hop, F, G, stacked, mode, sm_count(x3.get_device()))
    _cuda_contiguous(x3, w0, w1)
    if s0 is not None:
        _cuda_contiguous(s0)
    out = torch.empty((B, C, Nt, F), dtype=torch.bfloat16, device=x3.device)
    s0_ptr = s0.data_ptr() if s0 is not None else None
    launch("pcaudio_probe_dft_mag2", x3.data_ptr(), w0.data_ptr(), w1.data_ptr(),
           s0_ptr, out.data_ptr(), B, R, hop, F, C * Nt, G, int(stacked),
           DFT_MODES.index(mode), plan.blocks, _build.stream_of(x3))
    dft_mag2.launches += 1
    return out


dft_mag2.launches = 0


def dft_rows_per_block(R, G, stacked):
    """The frame rows one unit's tiles span: (tiles, rows computed, rows
    of useful frames), for the tile-waste account of P8."""
    rows = G * R - 1 if stacked else R - 1
    tiles = -(-rows // DFT_BM)
    useful = G * (R - 1)
    return tiles, tiles * DFT_BM * (1 if stacked else G), useful
