"""The whole ST forward in one kernel: K1 (``csrc/fused_st.cu``, the port of
``pcaudio/ops/kernels/fused_st.py::fused_st_forward``) and its plain
PyTorch version.

ISAB → ISAB → PMA(1 seed) → Linear, one thread block per cloud.  The
softmax is the exact max-subtract one with v4's mask semantics (a fully
masked cloud attends to nothing), so one kernel serves the mask-free call,
the masked one and the serving call, whose chunk mask masks a cloud's
points all or none and reaches the kernel as a flag a cloud: a cloud whose
flag is clear takes the logits of an empty cloud, packed with the
weights.  Precision is the JAX kernel's: bf16 operands and f32 sums,
rounding to bf16 the points, each MAB's projected K and V, the
probabilities before A·V (unnormalised, in an online softmax over 64-key
chunks; the PMA's stay f32), the input of every product and each ISAB's
output.  The f32 ``ST`` module stays the model (``use_fused_st=False``
and training); it sits about 5e-2 from this function (docs/ACCURACY.md).

Two forms of the kernel: clouds of at most :func:`max_points` points (1,280
at 64 inducing points) keep ISAB 1's output in shared memory, one block a
cloud (``launch_packed``); larger clouds, up to :data:`MAX_SCRATCH_POINTS`
(the full 5,120-point temporal grids), keep it in a scratch buffer in
device memory, one slab a resident block of a persistent grid
(``launch_scratch``).  Both compute the same function in the same order.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels import _build

# widths the kernel is compiled for (the shipped FST/3ST checkpoints)
DIM_HIDDEN = 64
NUM_HEADS = 8
MAX_INDS = 128
MAX_CLASSES = 256
_SMEM_LIMIT = 232448   # bytes of shared memory a block may take on the H100
_LD = 72               # bf16 row stride of the kernel's [rows, 64] buffers
MAX_SCRATCH_POINTS = 65536   # the scratch form's limit (fused_st_scratch.cu)
SCRATCH_BYTES = 256 << 20    # cap of the scratch form's buffer: its grid
                             # is at most this over one cloud's slab


def _warps(num_inds: int) -> int:
    return 4 if num_inds <= 64 else 8


def max_points(num_inds: int) -> int:
    """The most points a cloud may have on the card: the kernel keeps ISAB
    1's output ([K, 64] bf16) and five [16·warps, 64] buffers in one block's
    shared memory, with 4 warps for ``num_inds ≤ 64``, else 8.  Mirrors
    ``fused_st.cuh::smem_bytes``; 1,280 points at 64 inducing points."""
    if not 1 <= num_inds <= MAX_INDS:
        return 0
    warps = _warps(num_inds)
    kt = 16 * warps

    def smem(k):
        kp = -(-k // kt) * kt
        return (kp + 4 * kt) * _LD * 2 + (warps * 80 + 128) * 4 + kp

    k = 0
    while smem(k + kt) <= _SMEM_LIMIT:
        k += kt
    return k


def max_scratch_points(num_inds: int) -> int:
    """The most points a cloud may have in the scratch form (the kernel
    keeps one flag a point in shared memory); 0 outside 1 .. 128 inducing
    points.  Mirrors ``fused_st_scratch.cu::pcaudio_fused_st_scratch_max_points``."""
    return MAX_SCRATCH_POINTS if 1 <= num_inds <= MAX_INDS else 0


def slab_bytes(K: int, num_inds: int) -> int:
    """One cloud's X1 in the scratch form: K rounded up to the tile, × 64
    bf16."""
    kt = 16 * _warps(num_inds)
    return -(-K // kt) * kt * 64 * 2


def _check(model: ST, points: torch.Tensor, mask: Optional[torch.Tensor]):
    if model.num_outputs != 1:
        raise ValueError("fused ST forward needs num_outputs == 1")
    if points.dim() != 3:
        raise ValueError(f"points [N, K, din] expected, got "
                         f"{tuple(points.shape)}")
    if mask is not None and mask.shape != points.shape[:2]:
        raise ValueError(f"mask {tuple(mask.shape)} does not match points "
                         f"{tuple(points.shape)}")


def _check_kernel(model: ST, points: torch.Tensor) -> str:
    """What the kernel takes, checked before any launch; returns the form
    that takes it, ``"shared"`` or ``"scratch"``."""
    N, K, din = points.shape
    isab = model.enc[0]
    M, dv = isab.I.shape[1], isab.I.shape[2]
    ncls = model.dec[1].out_features
    if (dv, model.num_heads) != (DIM_HIDDEN, NUM_HEADS) or din not in (2, 3):
        raise ValueError(f"kernel built for dim_hidden={DIM_HIDDEN}, "
                         f"num_heads={NUM_HEADS}, din 2 or 3; got {dv}, "
                         f"{model.num_heads}, {din}")
    if not (1 <= M <= MAX_INDS and 1 <= ncls <= MAX_CLASSES):
        raise ValueError(f"num_inds={M}, classes={ncls} outside the kernel's "
                         f"limits {MAX_INDS}/{MAX_CLASSES}")
    if not 1 <= K <= max_scratch_points(M):
        raise ValueError(f"K={K} points outside the kernel's limit of "
                         f"{max_scratch_points(M)} at num_inds={M} (its "
                         f"scratch form; the shared-memory form takes "
                         f"{max_points(M)})")
    if points.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"points must be float32 or bfloat16, got "
                        f"{points.dtype}")
    return "shared" if K <= max_points(M) else "scratch"


def _r(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32."""
    return x.to(torch.bfloat16).float()


def _lin(x: torch.Tensor, layer: torch.nn.Linear) -> torch.Tensor:
    """A Linear as the kernel runs it: bf16 input and weight, f32 sums."""
    return _r(x) @ _r(layer.weight).T + layer.bias


CHUNK = 64   # keys a step of the kernel's online softmax


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
            valid: Optional[torch.Tensor], round_p: bool = True) -> torch.Tensor:
    """``q [N, Nq, dv]`` f32 (bf16 in the scores), ``k, v [N, Nk, dv]``
    bf16-valued, ``valid [N, Nk]`` or None → ``[N, Nq, dv]``: per head the
    max-subtract softmax, 0 where every key is masked, in the kernel's
    order: an online softmax over chunks of 64 keys, A·V summing the
    unnormalised probabilities (rounded to bf16 where ``round_p``) and
    dividing by their f32 sum at the end."""
    N, Nq, dv = q.shape
    split = lambda x: x.reshape(N, x.shape[1], heads, dv // heads).transpose(1, 2)
    qh, kh, vh = split(_r(q)), split(k), split(v)
    m = torch.full((N, heads, Nq, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(N, heads, Nq, dv // heads, device=q.device)
    for c0 in range(0, k.shape[1], CHUNK):
        s = (qh @ kh[:, :, c0:c0 + CHUNK].transpose(-1, -2)).div_(math.sqrt(dv))
        if valid is not None:
            s.masked_fill_(~valid[:, None, None, c0:c0 + CHUNK], float("-inf"))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        ms = torch.where(torch.isinf(mn), torch.zeros_like(mn), mn)
        alpha = torch.exp(m - ms)          # 0 while every key so far is masked
        s.sub_(ms).exp_()
        l = l * alpha + s.sum(-1, keepdim=True)
        o = o * alpha + (_r(s) if round_p else s) @ vh[:, :, c0:c0 + CHUNK]
        m = mn
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.transpose(1, 2).reshape(N, Nq, dv)


def _mab(mab, q: torch.Tensor, x: torch.Tensor,
         valid: Optional[torch.Tensor], round_p: bool = True) -> torch.Tensor:
    """The reference MAB on projected queries ``q`` (f32) and keys' input
    ``x``: K and V rounded to bf16, ``o = q + attend``, ``o + relu(o Wo)``."""
    k, v = _r(_lin(x, mab.fc_k)), _r(_lin(x, mab.fc_v))
    o = q + _attend(q, k, v, mab.num_heads, valid, round_p)
    return o + torch.relu(_lin(o, mab.fc_o))


def fused_st_forward_plain(model: ST, points: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the kernel's function step by step, f32 with the
    JAX kernel's bf16 roundings (``pcaudio/ops/kernels/fused_st.py::
    _make_kernel``) and the kernel's softmax order (:func:`_attend`): the
    probabilities are rounded unnormalised, relative to the running max of
    64-key chunks, as an online softmax must, where the JAX kernel rounds
    them normalised; and the PMA's stay f32.  With trained weights (the
    FST checkpoint) moving that rounding moves the logits far more than
    the summation order does, so the kernel is held to this order."""
    _check(model, points, mask)
    with torch.no_grad():
        N = points.shape[0]
        valid = None if mask is None else mask.to(points.device, torch.bool)
        x = _r(points.float())
        for isab in model.enc:
            iq = isab.mab0.fc_q(isab.I[0]).expand(N, -1, -1)   # f32, shared
            h = _mab(isab.mab0, iq, x, valid)
            x = _r(_mab(isab.mab1, _lin(x, isab.mab1.fc_q), h, None))
        pma = model.dec[0]
        sq = pma.mab.fc_q(pma.S[0]).expand(N, -1, -1)
        # the kernel's PMA sums A·V in f32 (one query: no tensor-core product)
        p = _mab(pma.mab, sq, x, valid, round_p=False)[:, 0]
        return _lin(p, model.dec[1]).float()


@functools.lru_cache(maxsize=None)
def _fragment_index(k_in: int, device: str) -> torch.Tensor:
    """Flat indices into a zero-padded ``[16·steps, 64]`` weight, in mma
    B-fragment order ``[steps, 8, 32, 4]``: for k16 step s, column tile j
    and lane (g = lane // 4, t = lane % 4) the rows 16s + 2t + (0, 1, 8, 9)
    of column 8j + g.  Made once per width and device."""
    steps = -(-k_in // 16)
    lane = torch.arange(32)[None, None, :, None]
    rows = (16 * torch.arange(steps)[:, None, None, None] + 2 * (lane % 4)
            + torch.tensor([0, 1, 8, 9]))
    cols = 8 * torch.arange(8)[None, :, None, None] + lane // 4
    return (rows * 64 + cols).to(device)


def _fragments(w_t: torch.Tensor) -> torch.Tensor:
    """A ``[k_in, 64]`` weight (``[in, out]``) in mma B-fragment order
    (:func:`_fragment_index`); rows past k_in are 0."""
    k_in = w_t.shape[0]
    wp = torch.nn.functional.pad(w_t, (0, 0, 0, -k_in % 16))
    return wp.reshape(-1)[_fragment_index(k_in, str(w_t.device))]


def _empty_logits(sq: torch.Tensor, fc_o: torch.nn.Linear,
                  dense: torch.nn.Linear) -> torch.Tensor:
    """The logits K1 gives a cloud with no valid point, from the PMA's
    projected seed query ``sq`` (f32): every MAB0 and the PMA attend to
    nothing, so the PMA's output is ``sq + 0``, then its rFF and the output
    Linear, each output a chain over the 64 inputs in order from its bias,
    as ``fused_st.cuh::st_forward`` computes them.  Each step adds the
    product of two bf16 values, exact in f32, so its one f32 rounding is
    the kernel's ``fmaf``'s: the same bits."""
    def chain(x, layer):   # bias + Σ_k bf16(x_k)·bf16(W[k]), k in order
        a, w = _r(x), _r(layer.weight.T.float())
        r = layer.bias.detach().float().clone()
        for k in range(a.numel()):
            r.addcmul_(a[k], w[k])   # fused or not: the product is exact
        return r
    v = sq.reshape(-1).float() + 0.0
    v = v + chain(v, fc_o).clamp_min(0.0)
    return chain(v, dense)


def _packed_weights(model: ST, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bf16 buffer, f32 buffer)`` of every weight, in the order
    K1 reads them (``fused_st.cuh``): per ISAB the projected inducing queries
    (bf16, then f32 in the second buffer), MAB0's K, V, O and MAB1's Q, K,
    V, O weights in B-fragment order (:func:`_fragments`) and their biases;
    then the PMA's seed query, its K and V weights as fragments, its O
    weight and the output Linear's as bf16 ``[in, out]``, and their biases;
    last the logits of a cloud with no valid point (:func:`_empty_logits`),
    which K1 copies for such a cloud.
    The batch-invariant queries are computed here in f32.  Cached on the
    module, keyed by each parameter's storage and version counter, so
    ``load_state_dict`` or an optimizer step repacks."""
    params = list(model.parameters())
    key = (str(device),) + tuple((p.data_ptr(), p._version) for p in params)
    cached = getattr(model, "_fused_st_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]

    frag = lambda layer: _fragments(layer.weight.T.float())
    with torch.no_grad():
        wb, wf = [], []
        for isab in model.enc:
            m0, m1 = isab.mab0, isab.mab1
            iq = m0.fc_q(isab.I[0]).float()
            wb += [iq] + [frag(lay) for lay in (m0.fc_k, m0.fc_v, m0.fc_o, m1.fc_q,
                                               m1.fc_k, m1.fc_v, m1.fc_o)]
            wf += [iq] + [lay.bias for lay in (m0.fc_k, m0.fc_v, m0.fc_o, m1.fc_q,
                                               m1.fc_k, m1.fc_v, m1.fc_o)]
        pma, dense = model.dec[0].mab, model.dec[1]
        sq = pma.fc_q(model.dec[0].S[0]).float()
        wb += [sq, frag(pma.fc_k), frag(pma.fc_v), pma.fc_o.weight.T, dense.weight.T]
        wf += [sq, pma.fc_k.bias, pma.fc_v.bias, pma.fc_o.bias, dense.bias,
               _empty_logits(sq, pma.fc_o, dense)]
        bufs = tuple(torch.cat([p.detach().float().reshape(-1) for p in parts])
                     .to(device=device, dtype=dt).contiguous()
                     for parts, dt in ((wb, torch.bfloat16), (wf, torch.float32)))
    model._fused_st_pack = (key, bufs)
    return bufs


def fused_st_forward(model: ST, points: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``points [N, K, din]`` (f32 or bf16), ``mask [N, K]`` bool or None →
    logits ``[N, ncls]`` f32.

    CPU tensors take :func:`fused_st_forward_plain`; CUDA tensors the
    kernel, which needs ``dim_hidden`` 64, 8 heads, ``din`` 2 or 3,
    ``num_inds ≤ 128``, at most 256 classes and ``K ≤
    max_scratch_points(num_inds)``; anything else raises before a launch.
    Up to ``max_points(num_inds)`` points (1,280 at 64 inducing points) the
    shared-memory form runs, above it the scratch form.

    The mask reaches the kernel in one of two forms.  A mask broadcast
    along K (stride 0 there, as ``extract_chunk_clouds`` builds it from the
    chunk mask) goes as its ``[N]`` column, a flag a cloud, with no copy
    when that column is contiguous; any other mask as ``[N, K]`` flags,
    which the kernel's passes read.  A cloud whose flag is clear takes the
    logits of an empty cloud from the packed weights (:func:`_empty_logits`)
    without a pass, the same bits as the passes give a dense all-false
    row; a cloud whose flag is set runs the mask-free forward.
    """
    if points.device.type == "cpu":
        return fused_st_forward_plain(model, points, mask)
    _check(model, points, mask)
    form = _check_kernel(model, points)
    if not (points.is_cuda and points.is_contiguous()):
        raise ValueError("points must be a contiguous CUDA tensor")
    if mask is not None:
        if mask.stride(1) == 0:   # one flag a cloud
            mask = mask[:, 0]
        mask = mask.to(device=points.device, dtype=torch.bool).contiguous()
    w = _packed_weights(model, points.device)
    out = torch.empty((points.shape[0], model.dec[1].out_features),
                      dtype=torch.float32, device=points.device)
    launch = launch_packed if form == "shared" else launch_scratch
    launch(points, mask, w, out, model.enc[0].I.shape[1])
    return out


def _mask_args(mask: Optional[torch.Tensor]) -> Tuple[Optional[int], Optional[int]]:
    """The kernel's two mask arguments, ``[N, K]`` flags (one a point) and
    ``[N]`` flags (one a cloud): the address of the form ``mask`` has, None
    for the other."""
    if mask is None:
        return None, None
    return (None, mask.data_ptr()) if mask.dim() == 1 else (mask.data_ptr(), None)


def launch_packed(points: torch.Tensor, mask: Optional[torch.Tensor],
                  w: Tuple[torch.Tensor, torch.Tensor], out: torch.Tensor,
                  num_inds: int, passes: int = 3) -> None:
    """One launch of K1 on checked operands: ``points [N, K, din]``
    contiguous on the card, ``mask`` contiguous bool, ``[N, K]`` (a flag a
    point), ``[N]`` (a flag a cloud) or None, ``w`` from
    :func:`_packed_weights`, ``out [N, ncls]`` f32.  ``passes`` < 3 stops
    the kernel after that many of its passes over the points (ISAB 1's
    MAB0; ISAB 1's MAB1 with ISAB 2's MAB0; the third is ISAB 2's MAB1,
    the PMA and the Linear), leaving ``out`` unwritten: the stage split's
    timing.  Counts as a launch of
    :func:`fused_st_forward`."""
    N, K, din = points.shape
    wb, wf = w
    _build.launch("pcaudio_fused_st", points.data_ptr(),
                  int(points.dtype == torch.bfloat16), *_mask_args(mask),
                  wb.data_ptr(), wb.numel(), wf.data_ptr(), wf.numel(),
                  out.data_ptr(), N, K, din, num_inds, out.shape[1], passes,
                  _build.stream_of(points))
    fused_st_forward.launches += 1


fused_st_forward.launches = 0


@functools.lru_cache(maxsize=None)
def resident_blocks(device_index: int, din: int, num_inds: int, K: int) -> int:
    """Blocks of the scratch form resident at once on the card (the
    occupancy query), per device and shape."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.launch("pcaudio_fused_st_scratch_blocks", din, num_inds, K,
                      ctypes.byref(n))
    if n.value < 1:
        raise RuntimeError(f"the scratch form of K1 cannot be resident at "
                           f"din={din}, num_inds={num_inds}, K={K}")
    return n.value


def scratch_grid(N: int, K: int, din: int, num_inds: int,
                 device_index: int) -> int:
    """The scratch form's grid: one block a cloud, at most as many as are
    resident and as :data:`SCRATCH_BYTES` holds slabs of."""
    cap = max(1, SCRATCH_BYTES // slab_bytes(K, num_inds))
    return min(N, resident_blocks(device_index, din, num_inds, K), cap)


def launch_scratch(points: torch.Tensor, mask: Optional[torch.Tensor],
                   w: Tuple[torch.Tensor, torch.Tensor], out: torch.Tensor,
                   num_inds: int) -> None:
    """One launch of K1's scratch form on checked operands (as
    :func:`launch_packed`): a persistent grid of :func:`scratch_grid`
    blocks, each with a slab of a scratch buffer allocated here for ISAB
    1's output.  Counts as a launch of the scratch form
    (``launch_scratch.launches``)."""
    N, K, din = points.shape
    grid = scratch_grid(N, K, din, num_inds, points.get_device())
    slab = slab_bytes(K, num_inds) // 2
    scratch = torch.empty(grid * slab, dtype=torch.bfloat16, device=points.device)
    wb, wf = w
    _build.launch("pcaudio_fused_st_scratch", points.data_ptr(),
                  int(points.dtype == torch.bfloat16), *_mask_args(mask),
                  wb.data_ptr(), wb.numel(), wf.data_ptr(), wf.numel(),
                  out.data_ptr(), N, K, din, num_inds, out.shape[1], grid,
                  scratch.data_ptr(), scratch.numel(), _build.stream_of(points))
    launch_scratch.launches += 1


launch_scratch.launches = 0
