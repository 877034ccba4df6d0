"""P6a's int16 gram kernel (``csrc/probe_stream.cu::int16_gram_kernel``),
redesigned as a tiled kernel, modelled on the CPU (no card, no nvcc) with
its constants and index expressions read from the source:

- the grid of 8 x 8 output tiles computes every output once, and each
  output's K is split over 4 threads (no thread walks a row alone);
- the staging loop lands every element of both row panels of a K chunk
  once, with 16-byte loads wherever 8 values lie in one row on a 16-byte
  boundary (all of them when L is a multiple of 8), and zeros past the
  row's end;
- the model's sums, taken in the kernel's order in f32, lie within
  ``matmul_bound`` of ``int16_gram_plain`` at the probe's shape and at
  ragged ones, K past one chunk included.
"""
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from pcaudio_torch.ops.kernels import featurize_probes as fp
from pcaudio_torch.ops.kernels.featurize_probes import int16_gram_plain
from pcaudio_torch.ops.kernels.probes import matmul_bound

SRC = (Path(fp.__file__).resolve().parents[2] / "csrc" / "probe_stream.cu").read_text()
GRAM = SRC[SRC.index("constexpr int kGramThreads"):SRC.index("constexpr int kSumThreads")]
K = {}
for _name in ("kGramThreads", "kGramTile", "kGramSplit", "kGramChunk", "kGramStride",
              "kGramVec"):
    _m = re.search(rf"constexpr int {_name} = ([^;]+);", GRAM)
    K[_name] = eval(_m.group(1), {}, dict(K))


def _has(*snippets):
    flat = " ".join(GRAM.split())
    for s in snippets:
        assert " ".join(s.split()) in flat, f"the source no longer holds {s!r}"


def test_source_is_what_the_model_runs():
    assert K["kGramThreads"] == K["kGramTile"] ** 2 * K["kGramSplit"]
    assert K["kGramChunk"] % 16 == 0 and K["kGramStride"] % 32 == 16  # float4 banks
    assert K["kGramVec"] * 2 == 16 and 4 * K["kGramSplit"] == 16
    _has("const int i0 = blockIdx.y * kGramTile, j0 = blockIdx.x * kGramTile;",
         "const int t = threadIdx.x, o = t / kGramSplit, s = t % kGramSplit;",
         "const int a = o / kGramTile, b = o % kGramTile;",
         "const int kr = (kc + 15) & ~15;",
         "for (int e = t * kGramVec; e < 2 * kGramTile * kr; e += kGramThreads * kGramVec) {",
         "const int rr = e / kr, k = e % kr;",
         "const int row = rr < kGramTile ? i0 + rr : j0 + rr - kGramTile;",
         "if (row < n && k + kGramVec <= kc && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {",
         "for (int k = 4 * s; k < kr; k += 4 * kGramSplit) {",
         "float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);",
         "v += __shfl_xor_sync(kFullMask, v, 1);",
         "v += __shfl_xor_sync(kFullMask, v, 2);",
         "if (s == 0 && i0 + a < n && j0 + b < n) out[(long long)(i0 + a) * n + j0 + b] = v;")
    assert "dim3(tiles, tiles), kGramThreads" in SRC


def stage(x, n, L, i0, j0, k0):
    """The staging loop of one block and chunk: the staged panel [16, kr],
    and how many elements came by 16-byte loads, one by one, or as zeros.
    ``x`` is taken to start on a 16-byte boundary (a fresh tensor)."""
    T, tile, vec = K["kGramThreads"], K["kGramTile"], K["kGramVec"]
    kc = min(K["kGramChunk"], L - k0)
    kr = (kc + 15) & ~15
    xs = np.full((2 * tile, kr), np.nan, np.float32)
    count = Counter()
    flat = x.reshape(-1)
    for t in range(T):
        for e in range(t * vec, 2 * tile * kr, T * vec):
            rr, k = divmod(e, kr)
            row = i0 + rr if rr < tile else j0 + rr - tile
            g = row * L + k0 + k
            assert np.isnan(xs[rr, k:k + vec]).all()  # each element once
            if row < n and k + vec <= kc and (2 * g) % 16 == 0:
                xs[rr, k:k + vec] = flat[g:g + vec] / 32768.0
                count["vector"] += vec
            else:
                for c in range(vec):
                    ok = row < n and k + c < kc
                    xs[rr, k + c] = flat[g + c] / 32768.0 if ok else 0.0
                    count["scalar" if ok else "zero"] += 1
    assert not np.isnan(xs).any()
    return xs, kr, count


def model_gram(x):
    """The kernel's sums in its order, in f32, and the staging counts."""
    n, L = x.shape
    tile, split = K["kGramTile"], K["kGramSplit"]
    tiles = -(-n // tile)
    out = np.full((n, n), np.nan, np.float32)
    counts = Counter()
    for by in range(tiles):
        for bx in range(tiles):
            i0, j0 = by * tile, bx * tile
            acc = np.zeros((tile, tile, split, 4), np.float32)  # [a, b, s, c]
            for k0 in range(0, L, K["kGramChunk"]):
                xs, kr, count = stage(x, n, L, i0, j0, k0)
                counts += count
                xa = xs[:tile].reshape(tile, kr // 16, split, 4)
                xb = xs[tile:].reshape(tile, kr // 16, split, 4)
                for step in range(kr // 16):  # acc[c] += x[a][k + c] * x[b][k + c]
                    acc = (acc + xa[:, None, step] * xb[None, :, step]).astype(np.float32)
            v = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
            v = (v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])  # the two shuffles
            for a in range(tile):
                for b in range(tile):
                    if i0 + a < n and j0 + b < n:
                        assert np.isnan(out[i0 + a, j0 + b])  # each output once
                        out[i0 + a, j0 + b] = v[a, b]
    return out, counts


@pytest.mark.parametrize("n,L", [(64, 512), (5, 37), (1, 1), (17, 600), (3, 1100), (9, 40)],
                         ids=str)
def test_model_within_matmul_bound_of_plain(n, L):
    g = torch.Generator().manual_seed(n * L)
    x = torch.randint(-32768, 32767, (n, L), generator=g, dtype=torch.int16)
    got, counts = model_gram(x.numpy())
    ref = int16_gram_plain(x)
    xf = x.float() / 32768
    assert bool((torch.from_numpy(got) - ref).abs().le(matmul_bound(xf, xf.t())).all())
    tiles = -(-n // K["kGramTile"])
    staged = counts["vector"] + counts["scalar"]
    # every block stages its two panels' valid rows once a chunk
    rows_i = [min(K["kGramTile"], n - K["kGramTile"] * t) for t in range(tiles)]
    assert staged == tiles * 2 * sum(rows_i) * L
    if L % K["kGramVec"] == 0:  # 16-byte loads only
        assert counts["scalar"] == 0

