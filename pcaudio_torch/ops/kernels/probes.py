"""The probe kernels (``csrc/probe_mma.cu``, ``csrc/probe_attend.cu``): the
H100 counterparts of the TPU timing probes behind K1's design questions,
each beside its plain PyTorch version.

  probe_matmul     P1 ``scripts/probe_batched_dot.py::kernel`` and P2
                   ``scripts/probe_int8_matmul.py`` (``kern``, ``make_big``,
                   ``make``): sums of windowed bf16 or int8 products
  probe_chain      P4a ``scripts/probe_lane_width.py::chain_kernel``:
                   x ← bf16(x·w), ``reps`` dependent products (wgmma)
  probe_exp_chain  P4b ``probe_lane_width.py``'s ``vpu_kernel``:
                   x ← exp(0.5·x), ``reps`` times
  probe_attend     P3 ``scripts/probe_int8_attend.py::make_kernel``: the v6
                   attend in bf16 or with in-kernel int8 quantisation

The TPU probes ran a grid of identical steps in order on one core; here a
``repeats`` argument runs that many copies in parallel and sums them, so
the output depends on every copy's work.  CPU tensors take the plain
versions; CUDA tensors the kernels, never a fallback.  The plain versions
compute in f32 (the card's TF32 off); the ``*_bound`` functions give the
elementwise bound on |kernel − plain| that each probe is held to, and the
chain is held exactly at a :func:`signed_permutation` w and on
:func:`rounding_chain_inputs`.

:func:`matmul_plan`, :func:`chain_plan` and :func:`attend_plan` are the
wgmma kernels' plans (their grids and how each block's run of work units
is cut), which the kernels follow and the CPU tests hold to covering every
product once.

The probe kernels of both families (these and ``featurize_probes``'s) make
a library of their own, :func:`library`, apart from the path's: built
through ``_build.build`` on a probe's first launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pcaudio_torch.ops.kernels import _build

WGMMA_BF16 = "wgmma.mma_async.m64n128k16.f32.bf16.bf16 (TMA ring, B resident)"
WGMMA_CHAIN = "wgmma m64n{64,128}k16 bf16, A from registers, w resident (TMA)"
WGMMA_S8 = "wgmma.mma_async.m64n128k32.s32.s8.s8 (TMA ring, B resident)"
WGMMA_ATTEND_BF16 = "wgmma m64n128k16 bf16, P from registers (bulk-copy ring)"
WGMMA_ATTEND_S8 = "wgmma m64n128k32 s8, P from registers (bulk-copy ring)"
EXP_SFU = "__expf (ex2.approx on the MUFU special-function units)"
TILE = 128        # probe_matmul's output tile; M and N are multiples
ATTEND_DV = 128   # probe_attend's widths (the v6 attend: dv2 and K)
ATTEND_KEYS = 128
ATTEND_ROWS = 256  # query rows a block (two warpgroups of 128)
CHAIN_ROWS = 64   # probe_chain's rows a chain (one warpgroup's wgmma tile)
# probe_chain's blocks (chains in flight) an SM, by d: csrc/probe_mma.cu's
# kChainBlocksPerSm128 and kChainBlocksPerSm64
CHAIN_BLOCKS_PER_SM = {128: 2, 64: 4}
U32 = 2.0 ** -24  # f32 unit roundoff
PLAIN_CHUNK = 512  # attends the plain attend batches at once (memory)
# probe_matmul's shared memory (csrc/hopper.cuh, csrc/probe_mma.cu)
SMEM_BYTES = 232448    # a block's dynamic shared memory (227 KB)
SWIZZLE_BYTES = 128    # a swizzled row: one ring stage's K
MAX_STAGES = 4
MIN_STAGES = 3
MAX_SLAB_ROWS = 256    # a TMA box's rows
MAX_GROUP = 8          # windows one slab serves

_P, _I = ctypes.c_void_p, ctypes.c_int
NAME = "pcaudio_probes"
SOURCES = dict.fromkeys((_build.ERROR_SOURCE, "probe_mma.cu", "probe_attend.cu",
                         "probe_stream.cu", "probe_featurize.cu"))
SIGNATURES = {
    **_build.ERROR_SIGNATURE,
    "pcaudio_probe_matmul": _build.entry(*[_P] * 5),
    "pcaudio_probe_chain": _build.entry(*[_P] * 5),
    "pcaudio_probe_exp_chain": _build.entry(_P, _P, *[_I] * 4, _P),
    "pcaudio_probe_attend": _build.entry(*[_P] * 5, *[_I] * 5, _P),
    "pcaudio_probe_int16_gram": _build.entry(_P, _P, _I, _I, _P),
    "pcaudio_probe_wave_sums": _build.entry(_P, _P, _I, _I, _I, _P),
    "pcaudio_probe_relayout": _build.entry(_P, _P, *[_I] * 5, _P),
    "pcaudio_probe_dft_mag2": _build.entry(*[_P] * 5, *[_I] * 9, _P),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The probe kernels, built and loaded once per process."""
    return _build.build(NAME, SOURCES, SIGNATURES)


def launch(name: str, *args) -> None:
    """Call the probe library's entry point ``name``; raise on an error."""
    _build.launch_in(library(), name, *args)


@functools.lru_cache(maxsize=None)
def sm_count(index: int = 0) -> int:
    """The card's streaming multiprocessors (cached: the query costs host
    time on every launch)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _per(repeats: int) -> int:
    """Repeats one block sums in registers before its atomic add."""
    return 8 if repeats % 8 == 0 else 1


# ---- P1, P2: sums of windowed products ----------------------------------

def _check_matmul(a, b, reps, shift, repeats):
    _check_matmul_shapes(a.shape, b.shape, a.dtype, b.dtype, reps, shift, repeats)


def _check_matmul_shapes(a_shape, b_shape, a_dtype, b_dtype, reps, shift, repeats):
    if a_dtype not in (torch.bfloat16, torch.int8) or b_dtype != a_dtype:
        raise TypeError(f"a and b must both be bfloat16 or int8, got {a_dtype}, "
                        f"{b_dtype}")
    if len(a_shape) not in (2, 3) or len(b_shape) != len(a_shape) or \
            a_shape[:-2] != b_shape[:-2]:
        raise ValueError(f"a [(B,) rows, K] and b [(B,) K, N] expected, got "
                         f"{tuple(a_shape)}, {tuple(b_shape)}")
    if a_shape[-1] != b_shape[-2]:
        raise ValueError(f"contraction mismatch: {tuple(a_shape)} · {tuple(b_shape)}")
    if reps < 1 or shift < 0 or repeats < 1 or a_shape[-2] - shift * (reps - 1) < 1:
        raise ValueError(f"reps={reps}, shift={shift}, repeats={repeats} do not fit "
                         f"{a_shape[-2]} rows")
    if repeats > 1 and len(a_shape) == 3 and a_shape[0] > 1:
        raise ValueError("repeats of a batched product are not supported")


def _window_sum(a, b, reps, shift):
    """Σ_{i<reps} a[..., i·shift : i·shift + M, :] · b in f32."""
    M = a.shape[-2] - shift * (reps - 1)
    w = torch.stack([a[..., i * shift: i * shift + M, :] for i in range(reps)])
    return (w.float() @ b.float()).sum(0)


def probe_matmul_plain(a, b, reps=1, shift=0, repeats=1):
    """Plain version of :func:`probe_matmul`: each repeat's windowed sum in
    f32, added up; int32 for int8 operands (exact while the sums stay below
    2^24, which the probes' operand ranges keep)."""
    _check_matmul(a, b, reps, shift, repeats)
    out = _window_sum(a, b, reps, shift)
    for _ in range(repeats - 1):
        out = out + _window_sum(a, b, reps, shift)
    return out.to(torch.int32) if a.dtype == torch.int8 else out


def matmul_bound(a, b, reps=1, shift=0, repeats=1):
    """|kernel − plain| bound for operands that are not small integers: each
    side sums reps·K products per repeat in f32, |error| ≤ reps·K·u·Σ|a||b|
    each (u = 2^-24), and the repeats' sum adds `repeats` terms."""
    mag = _window_sum(a.abs() if a.dtype != torch.int8 else a.float().abs(),
                      b.abs() if b.dtype != torch.int8 else b.float().abs(),
                      reps, shift) * repeats
    return 2 * (reps * a.shape[-1] + repeats) * U32 * mag


class MatmulPlan(NamedTuple):
    """``probe_matmul``'s grid: ``panels`` (batch × N/128 tile columns,
    each a B panel a block holds) × ``blocks`` runs of a panel's ``units``
    (m-tile, repeat, window group, in that order); a group is ``group``
    windows read from one slab of ``slab_rows`` rows through a ring of
    ``stages``; ``accumulate``: blocks add into a zeroed output (else each
    tile is one unit and is stored)."""

    panels: int
    blocks: int
    units: int
    group: int
    groups: int
    slab_rows: int
    stages: int
    k_padded: int
    accumulate: bool
    smem: int


def matmul_plan(batch, M, N, K, reps, shift, repeats, elem, sms) -> MatmulPlan:
    """The plan of ``csrc/probe_mma.cu``'s windowed GEMM; raises
    ``ValueError`` for shapes its tiles do not take (M or N not a multiple
    of 128, K not of 64 bytes, a B panel that leaves no room for a ring of
    3 slabs)."""
    if M < TILE or N < TILE or M % TILE or N % TILE or (K * elem) % 64:
        raise ValueError(f"M={M}, N={N} must be multiples of {TILE} and K={K} "
                         f"of {64 // elem}")
    ks = SWIZZLE_BYTES // elem
    kp = -(-K // ks) * ks
    b_bytes = kp * TILE * elem
    group = 1
    if shift % 8 == 0:  # a window i·shift rows down is whole swizzle atoms
        group = min(reps, MAX_GROUP)
        if shift:
            group = min(group, 1 + (MAX_SLAB_ROWS - TILE) // shift)
    while True:
        slab = TILE + (group - 1) * shift
        free = SMEM_BYTES - 1024 - b_bytes - (2 * MAX_STAGES + 1) * 8
        stages = min(MAX_STAGES, free // (slab * SWIZZLE_BYTES))
        if stages >= MIN_STAGES or group == 1:
            break
        group -= 1
    if stages < MIN_STAGES:
        raise ValueError(f"K={K}: a [{kp}, {TILE}] B panel leaves no room for "
                         f"{MIN_STAGES} ring stages in shared memory")
    groups = -(-reps // group)
    units = (M // TILE) * repeats * groups
    panels = batch * (N // TILE)
    blocks = min(units, max(1, sms // panels))
    smem = 1024 + b_bytes + stages * slab * SWIZZLE_BYTES + (2 * MAX_STAGES + 1) * 8
    return MatmulPlan(panels, blocks, units, group, groups, slab, stages, kp,
                      repeats * groups > 1, smem)


def matmul_units(plan: MatmulPlan, block: int, M: int, repeats: int, reps: int):
    """The (panel, m-tile, repeat, windows) of block ``block``'s run, as
    the kernel walks them."""
    panel, run = divmod(block, plan.blocks)
    for u in range(plan.units * run // plan.blocks,
                   plan.units * (run + 1) // plan.blocks):
        mt, rem = divmod(u, repeats * plan.groups)
        r, j = divmod(rem, plan.groups)
        yield panel, mt, r, range(j * plan.group, min(reps, (j + 1) * plan.group))


class _MatmulCall(NamedTuple):
    shape: tuple        # the output's
    dtype: torch.dtype
    zeroed: bool        # the kernel adds into it
    params: object      # the entry point's ints, a ctypes array kept alive
    params_ptr: int


@functools.lru_cache(maxsize=256)
def _matmul_call(a_shape, b_shape, dtype, b_dtype, reps, shift, repeats, device_index):
    """One call's checks, plan and the kernel's integer arguments, made
    once per shape: a call then passes five pointers to ctypes, not 16
    arguments (each costs host time)."""
    _check_matmul_shapes(a_shape, b_shape, dtype, b_dtype, reps, shift, repeats)
    rows, K = a_shape[-2:]
    N = b_shape[-1]
    M = rows - shift * (reps - 1)
    int8 = dtype == torch.int8
    batch = a_shape[0] if len(a_shape) == 3 else 1
    plan = matmul_plan(batch, M, N, K, reps, shift, repeats, 1 if int8 else 2,
                       sm_count(device_index))
    params = (ctypes.c_int * 12)(int(int8), batch, rows, M, N, K, reps, shift, repeats,
                                 plan.blocks, plan.group, plan.stages)
    return _MatmulCall((M, N) if repeats > 1 else tuple(a_shape[:-2]) + (M, N),
                       torch.int32 if int8 else torch.float32, plan.accumulate, params,
                       ctypes.addressof(params))


def probe_matmul(a, b, reps=1, shift=0, repeats=1):
    """``Σ_{r<repeats} Σ_{i<reps} a[..., i·shift : i·shift + M, :] · b`` with
    ``M = rows − (reps − 1)·shift``: ``a [(B,) rows, K]`` and ``b [(B,) K,
    N]`` both bf16 (→ f32) or both int8 (→ int32).

    One wgmma GEMM kernel (:func:`matmul_plan`): on the card M and N must
    be multiples of 128, K of 32 (bf16) or 64 (int8), and B's [K, 128]
    panel must leave room for the ring.  CPU tensors take
    :func:`probe_matmul_plain`.
    """
    if a.device.type == "cpu":
        return probe_matmul_plain(a, b, reps, shift, repeats)
    if not (a.is_cuda and b.is_cuda and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous CUDA tensors")
    call = _matmul_call(a.shape, b.shape, a.dtype, b.dtype, reps, shift, repeats,
                        a.get_device())
    out = (a.new_zeros if call.zeroed else a.new_empty)(call.shape, dtype=call.dtype)
    launch("pcaudio_probe_matmul", a.data_ptr(), b.data_ptr(), out.data_ptr(),
           call.params_ptr, _build.stream_of(a))
    probe_matmul.launches += 1
    return out


probe_matmul.launches = 0


# ---- P4a: the dependent bf16 product chain -------------------------------

def _check_chain_shapes(x_shape, w_shape, x_dtype, w_dtype):
    if x_dtype != torch.bfloat16 or w_dtype != torch.bfloat16:
        raise TypeError(f"x and w must be bfloat16, got {x_dtype}, {w_dtype}")
    if len(x_shape) != 2 or tuple(w_shape) != (x_shape[1], x_shape[1]):
        raise ValueError(f"x [n, d] and w [d, d] expected, got {tuple(x_shape)}, "
                         f"{tuple(w_shape)}")


def probe_chain_plain(x, w, reps=64, repeats=1):
    """Plain version of :func:`probe_chain`: the repeats as a batch, each
    step an f32 product rounded to bf16, the repeats' results summed in
    f32 (exact: `repeats` copies of one bf16 value)."""
    _check_chain_shapes(x.shape, w.shape, x.dtype, w.dtype)
    y = x.expand(repeats, *x.shape)
    wf = w.float()
    for _ in range(reps):
        y = (y.float() @ wf).bfloat16()
    return y.float().sum(0)


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def signed_permutation(d, generator=None, device=None):
    """A random ``[d, d]`` bf16 signed permutation: ``x·w`` moves x's
    columns and flips some signs, so every product is exact and x keeps its
    values through any number of steps.  At the probe's own w = N(0, 1)/d
    the chain decays to 0, where a wrong kernel could not be told from a
    right one; the chain is checked exactly at this w instead.

    Its cycles have the prime lengths 2, 3, 5, ... (on randomly chosen
    columns; the columns left over stay in place), so its order is their
    product (510,510 at d = 64): no two of its first 128 powers are equal,
    and a chain that runs a wrong number of steps gives another result."""
    order = torch.randperm(d, generator=generator, device=device).tolist()
    dest, start = list(range(d)), 0
    for p in _PRIMES:
        if start + p > d:
            break
        cycle = order[start: start + p]
        for i, r in enumerate(cycle):
            dest[r] = cycle[(i + 1) % p]
        start += p
    sign = 2.0 * torch.randint(0, 2, (d,), generator=generator, device=device) - 1
    w = torch.zeros(d, d, device=device)
    w[torch.arange(d, device=device), torch.tensor(dest, device=device)] = sign
    return w.bfloat16()


def rounding_chain_inputs(n, d, generator=None, device=None):
    """``[n, d]`` x and ``[d, d]`` w, bf16, on which every step of the
    chain rounds and every sum is still exact: |x| in [1, 2) and
    w = P + 2⁻⁹·Q, P a :func:`signed_permutation` and Q one with its
    nonzeros elsewhere (P's columns moved by a random offset, new signs).
    An element of x·w is then a + 2⁻⁹·b for two elements a, b of x; over
    64 steps |x| stays within [0.7, 2.3], so each sum spans at most 19
    bits (exact in f32 in any order) and its rounding to bf16 drops set
    bits: a pack that truncates or breaks ties otherwise than to even gives
    another result.  At a signed permutation alone every product is
    already a bf16 value, which no rounding changes."""
    sign = 2.0 * torch.randint(0, 2, (n, d), generator=generator, device=device) - 1
    mant = torch.randint(0, 128, (n, d), generator=generator, device=device)
    x = (sign * (1 + mant / 128)).bfloat16()
    p = signed_permutation(d, generator, device).float()
    shift = int(torch.randint(1, d, (1,), generator=generator, device=device))
    flip = 2.0 * torch.randint(0, 2, (d, 1), generator=generator, device=device) - 1
    q = torch.roll(p, shift, dims=1) * flip
    return x, (p + 2.0 ** -9 * q).bfloat16()


class ChainPlan(NamedTuple):
    """``probe_chain``'s grid: ``blocks`` blocks of one warpgroup, each
    walking one contiguous run of the ``units`` (64-row tile, repeat), in
    that order; runs differ by at most one unit."""

    blocks: int
    units: int


def chain_plan(n, d, repeats, sms) -> ChainPlan:
    """The plan of ``csrc/probe_mma.cu``'s chain: as many blocks as the SMs
    hold at once (``CHAIN_BLOCKS_PER_SM`` chains in flight on each), at
    most one a unit; raises ``ValueError`` for shapes its tiles do not
    take."""
    if d not in CHAIN_BLOCKS_PER_SM or n < CHAIN_ROWS or n % CHAIN_ROWS:
        raise ValueError(f"the kernel takes d 64 or 128 and n a multiple of {CHAIN_ROWS}, "
                         f"got n={n}, d={d}")
    if repeats < 1 or sms < 1:
        raise ValueError(f"repeats={repeats} and sms={sms} must be at least 1")
    units = (n // CHAIN_ROWS) * repeats
    return ChainPlan(min(units, sms * CHAIN_BLOCKS_PER_SM[d]), units)


def chain_units(plan: ChainPlan, block: int, repeats: int):
    """The (tile, repeat) units of block ``block``'s run, as the kernel
    walks them."""
    for u in range(plan.units * block // plan.blocks,
                   plan.units * (block + 1) // plan.blocks):
        yield divmod(u, repeats)


@functools.lru_cache(maxsize=256)
def _chain_call(x_shape, w_shape, x_dtype, w_dtype, reps, repeats, device_index):
    """One call's checks, plan and the kernel's integer arguments (one
    ctypes array), made once per shape."""
    _check_chain_shapes(x_shape, w_shape, x_dtype, w_dtype)
    n, d = x_shape
    if reps < 1:
        raise ValueError(f"reps={reps} must be at least 1")
    plan = chain_plan(n, d, repeats, sm_count(device_index))
    params = (ctypes.c_int * 5)(n, d, reps, repeats, plan.blocks)
    return params, ctypes.addressof(params)


def probe_chain(x, w, reps=64, repeats=1):
    """``x [n, d]`` bf16, ``w [d, d]`` bf16 → ``[n, d]`` f32: the sum over
    ``repeats`` copies of x after ``reps`` steps of ``x ← bf16(x·w)`` (f32
    accumulation).  On the card d is 64 or 128, n a multiple of 64 and w
    contiguous (read as it lies): one wgmma kernel, each warpgroup keeping
    a chain's 64 rows in registers (:func:`chain_plan`).  CPU tensors take
    :func:`probe_chain_plain`."""
    if x.device.type == "cpu":
        return probe_chain_plain(x, w, reps, repeats)
    if not (x.is_cuda and w.is_cuda and x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous CUDA tensors")
    _, ptr = _chain_call(x.shape, w.shape, x.dtype, w.dtype, reps, repeats, x.get_device())
    out = x.new_zeros(x.shape, dtype=torch.float32)
    launch("pcaudio_probe_chain", x.data_ptr(), w.data_ptr(), out.data_ptr(), ptr,
           _build.stream_of(x))
    probe_chain.launches += 1
    return out


probe_chain.launches = 0


# ---- P4b: the exp chain --------------------------------------------------

def probe_exp_chain_plain(x, reps=64, repeats=1):
    """Plain version of :func:`probe_exp_chain` (``torch.exp``)."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    y = x.expand(repeats, *x.shape)
    for _ in range(reps):
        y = torch.exp(y * 0.5)
    return y.sum(0)


def exp_chain_bound(ref):
    """|kernel − plain| bound: 1e-3 of the value, __expf's few ulps (plus
    the rounding of its argument's product by log2 e) amplified by 0.5·|x|
    a step.  N(0, 1) inputs stay finite for two steps only; after three
    the chain overflows to +inf, where the check would see nothing."""
    return 1e-3 * ref.abs()


def probe_exp_chain(x, reps=64, repeats=1):
    """``x`` f32 → f32 of its shape: the sum over ``repeats`` copies of x
    after ``reps`` steps of ``x ← exp(0.5·x)``.  A plain SIMT loop (one
    element a thread) on the card; CPU tensors take
    :func:`probe_exp_chain_plain`."""
    if x.device.type == "cpu":
        return probe_exp_chain_plain(x, reps, repeats)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not (x.is_cuda and x.is_contiguous()):
        raise ValueError("x must be a contiguous CUDA tensor")
    out = torch.zeros_like(x)
    launch("pcaudio_probe_exp_chain", x.data_ptr(), out.data_ptr(), x.numel(),
           reps, repeats, _per(repeats), _build.stream_of(x))
    probe_exp_chain.launches += 1
    return out


probe_exp_chain.launches = 0


# ---- P3: the v6 attend, bf16 or int8 -------------------------------------

_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def quant(x, dims=None):
    """The script's ``quant``: ``s = max|x|·(1/127) + 1e-30`` (over ``dims``,
    all by default), ``q = round_half_even(x·(1/s))`` as f32 integers."""
    m = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    s = m * _INV127.to(x.device) + 1e-30
    return torch.round(x * (1.0 / s)), s


def _attend(iq, kw, mode, iq8=None):
    """One attend per window ``kw [n, K, dv]`` against ``iq [R, dv]`` →
    ``(av [n, R, dv], a_used [n, R, K], |k_used| [n, K, dv])``: the
    probabilities and keys that enter A·V, scaled as in the product."""
    if mode == "int8":
        q8, s_q = iq8
        k8, s_k = quant(kw, dims=(-2, -1))
        lg = (q8 @ k8.transpose(-1, -2)) * (s_q * s_k * 0.125)
    else:
        kb = kw.bfloat16().float()
        lg = (iq.bfloat16().float() @ kb.transpose(-1, -2)) * 0.125
    pexp = torch.exp(torch.clamp(lg, -50.0, 50.0))
    a = pexp / pexp.sum(-1, keepdim=True)
    if mode == "int8":
        a8 = torch.round(a * 127.0)
        return (a8 @ k8) * (s_k / 127.0), a8, k8.abs() * (s_k / 127.0), a
    ab = a.bfloat16().float()
    return ab @ kb, ab, kb.abs(), a


def _windows(kmat, pairs, keys, steps):
    """The distinct windows ``[2·pairs − 1, keys, dv]`` and the window index
    of every (step, pair) in grid order."""
    if kmat.shape[0] < (2 * pairs - 1) * keys:
        raise ValueError(f"kmat has {kmat.shape[0]} rows; {pairs} pairs of {keys} "
                         f"keys need {(2 * pairs - 1) * keys}")
    win = kmat[: (2 * pairs - 1) * keys].reshape(2 * pairs - 1, keys, -1)
    idx = torch.tensor([(g % pairs) + p for g in range(steps) for p in range(pairs)],
                       device=kmat.device)
    return win, idx


def _check_attend(iq, kmat, mode):
    if mode not in ("bf16", "int8"):
        raise ValueError(f"mode must be 'bf16' or 'int8', got {mode!r}")
    if iq.dtype != torch.float32 or kmat.dtype != torch.float32:
        raise TypeError("iq and kmat must be float32")
    if iq.dim() != 2 or kmat.dim() != 2 or iq.shape[1] != kmat.shape[1]:
        raise ValueError(f"iq [rows, dv] and kmat [n, dv] expected, got "
                         f"{tuple(iq.shape)}, {tuple(kmat.shape)}")


def probe_attend_plain(iq, kmat, mode, pairs=8, keys=128, steps=1024):
    """Plain version of :func:`probe_attend`: every (step, pair)'s attend,
    ``PLAIN_CHUNK`` at a time as a batch, summed in f32."""
    _check_attend(iq, kmat, mode)
    win, idx = _windows(kmat, pairs, keys, steps)
    iq8 = quant(iq) if mode == "int8" else None
    out = torch.zeros(iq.shape, dtype=torch.float32, device=iq.device)
    for c in range(0, len(idx), PLAIN_CHUNK):
        out += _attend(iq, win[idx[c: c + PLAIN_CHUNK]], mode, iq8)[0].sum(0)
    return out


def _flip_bound(u, r, margin, half_gap, step):
    """Bound on |round(u') − r| over every u' within ``margin`` of ``u``,
    where ``r = round(u)``: 0 when no rounding midpoint lies within
    ``margin`` of u (``half_gap`` is the least distance from r to one),
    else ``margin + step``."""
    same = (half_gap - (u - r).abs()) > margin
    return torch.where(same, torch.zeros_like(margin), margin + step)


def _bf16_gaps(r):
    """(half_gap, step) of the bf16 grid around the bf16 values ``r`` (f64):
    the nearest midpoint is at least 2^(e-9) away (the spacing below a
    power of two is 2^(e-8)), and rounding moves a value by less than
    2^(e-6) in all (e = exponent, subnormals at −126)."""
    e = torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
    return 2.0 ** (e - 9), 2.0 ** (e - 6)


def attend_bound(iq, kmat, mode, pairs=8, keys=128, steps=1024):
    """|kernel − plain| bound, elementwise, from the plain arithmetic of each
    distinct window w, weighted by the number of (step, pair)s that use it:

    - f32 sums: both sides add steps·pairs + keys terms in some order, each
      within (steps·pairs + keys)·u of Σ|a||k| (u = 2^-24);
    - the probabilities a: the logits differ by at most 2·dv·u·0.125·
      Σ|q||k| (bf16; int8 logits are exact integers, scaled alike), exp by
      a few ulps, the row sum by its order: a's relative margin is that
      difference, its row maximum, 2^-20 and (keys + 2)·2^-23;
    - what enters A·V is bf16(a), or a8 = round(a·127): equal on both sides
      unless a rounding midpoint lies within the margin, and then off by at
      most the margin plus one step (:func:`_flip_bound`), each such step
      moving av by |k| (int8: |k8|·s_k/127).  Quantisation itself is
      bit-identical.
    """
    _check_attend(iq, kmat, mode)
    win, idx = _windows(kmat, pairs, keys, steps)
    mult = torch.bincount(idx, minlength=len(win)).to(torch.float32)
    iq8 = quant(iq) if mode == "int8" else None
    _, a_used, k_used, a = _attend(iq, win, mode, iq8)
    mag = torch.einsum("w,wrk,wkd->rd", mult, a_used, k_used).double()
    rel = 2.0 ** -20 + (keys + 2) * 2.0 ** -23
    a = a.double()
    if mode == "bf16":
        qb = iq.bfloat16().double().abs()
        kb = win.bfloat16().double().abs()
        dlg = 2 * iq.shape[1] * U32 * 0.125 * (qb @ kb.transpose(-1, -2))
        margin = a * (rel + dlg + dlg.amax(-1, keepdim=True))
        flips = _flip_bound(a, a_used.double(), margin, *_bf16_gaps(a_used.double()))
    else:
        flips = _flip_bound(127 * a, a_used.double(), 127 * a * rel, 0.5, 1.0)
    flip_mag = torch.einsum("w,wrk,wkd->rd", mult.double(), flips, k_used.double())
    return ((steps * pairs + keys) * U32 * mag + flip_mag).float()


class AttendPlan(NamedTuple):
    """``probe_attend``'s grid: ``blocks`` runs of the ``units`` (256-row
    block, attend), in that order, one a block."""

    blocks: int
    units: int


def attend_plan(rows, pairs, steps, sms) -> AttendPlan:
    units = (rows // ATTEND_ROWS) * steps * pairs
    return AttendPlan(min(sms, units), units)


def attend_units(plan: AttendPlan, block: int, attends: int):
    """The (row block, attend) units of block ``block``'s run, in order."""
    for u in range(plan.units * block // plan.blocks,
                   plan.units * (block + 1) // plan.blocks):
        yield divmod(u, attends)


def window_of(attend: int, pairs: int) -> int:
    """The window of attend ``g·pairs + p``: (g mod pairs) + p."""
    return (attend // pairs) % pairs + attend % pairs


def probe_attend(iq, kmat, mode, pairs=8, keys=128, steps=1024):
    """The v6 attend probe: ``iq [rows, 128]`` f32 against, for each of
    ``steps`` grid steps g and ``pairs`` p, the window ``kmat[((g mod
    pairs) + p)·128 : +128]`` (keys and values alike), in ``mode`` "bf16"
    or "int8" (in-kernel quantisation), summed into ``[rows, 128]`` f32.

    On the card rows is a multiple of 256 and keys and dv are 128
    (:func:`attend_plan`); CPU tensors take :func:`probe_attend_plain`.
    """
    if iq.device.type == "cpu":
        return probe_attend_plain(iq, kmat, mode, pairs, keys, steps)
    _check_attend(iq, kmat, mode)
    rows, dv = iq.shape
    if keys != ATTEND_KEYS or dv != ATTEND_DV or rows % ATTEND_ROWS or rows < 1:
        raise ValueError(f"the kernel takes keys={ATTEND_KEYS}, dv={ATTEND_DV} and "
                         f"rows a multiple of {ATTEND_ROWS}, got {keys}, {dv}, {rows}")
    _windows(kmat, pairs, keys, 1)
    if not (iq.is_cuda and kmat.is_cuda and iq.is_contiguous() and kmat.is_contiguous()):
        raise ValueError("iq and kmat must be contiguous CUDA tensors")
    plan = attend_plan(rows, pairs, steps, sm_count(iq.device.index or 0))
    out = torch.zeros((rows, dv), dtype=torch.float32, device=iq.device)
    int8 = mode == "int8"
    iq8 = torch.empty((rows, dv) if int8 else (16,), dtype=torch.int8, device=iq.device)
    sq = torch.empty(1, dtype=torch.float32, device=iq.device)
    launch("pcaudio_probe_attend", iq.data_ptr(), kmat.data_ptr(), iq8.data_ptr(),
           sq.data_ptr(), out.data_ptr(), int(int8), rows, pairs, steps,
           plan.blocks, _build.stream_of(iq))
    probe_attend.launches += 1
    return out


probe_attend.launches = 0
