"""Waves to point clouds, in plain PyTorch: librosa's 60 dB trim, the
centered STFT, the temporal chunks and their exact top K, and framewise
log-magnitude frames.

Conventions of the paper's code (``Code/settransformer.py:34-52``,
``Code/settransformertemp.py:35-59``, ``Code/dataset.py:169-202``) on
librosa 0.8: the trim's frames are 2,048 samples at hop 512, centered with
'reflect' padding, silent below ``top_db`` of the loudest frame; the STFT
is centered with single-bounce reflection at the trimmed clip's edges, a
periodic Hann window and ``rfft``; frame t of a clip is valid while
t < 1 + tlen // hop; the temporal cloud drops the Nyquist bin and cuts
10-frame chunks, a chunk valid when all its frames are.
"""
from __future__ import annotations

import math

import torch

LOG_FLOOR = 1.0e-8


def trim_bounds(waves, lengths, top_db: float = 60.0, frame: int = 2048,
                hop: int = 512, block: int = 64):
    """``(start, tlen)`` int64 of each ``waves[b, :lengths[b]]``."""
    B, L = waves.shape
    dev = waves.device
    n_all = lengths.to(device=dev, dtype=torch.int64).clamp(0, L)
    T = 1 + L // hop
    t = torch.arange(T, device=dev)
    pad = frame // 2
    q = torch.arange(L + frame, device=dev) - pad
    starts, tlens = [], []
    for i in range(0, B, block):
        n = n_all[i: i + block, None]
        idx = torch.where(q < 0, -q, q).expand(n.shape[0], -1)
        idx = torch.where(idx >= n, 2 * n - 2 - idx, idx)
        idx = torch.minimum(idx.clamp_min(0), (n - 1).clamp_min(0))
        y = torch.gather(waves[i: i + block].double(), 1, idx) * (n > 0)
        c = torch.nn.functional.pad(torch.cumsum(y * y, dim=1), (1, 0))
        mse = (c[:, t * hop + frame] - c[:, t * hop]) / frame
        valid = t[None, :] < 1 + n // hop
        ref = torch.where(valid, mse, 0.0).amax(-1, keepdim=True).clamp_min(1e-10)
        db = 10.0 * (torch.log10(mse.clamp_min(1e-10)) - torch.log10(ref))
        loud = (db > -top_db) & valid
        anyl = loud.any(-1)
        first = torch.where(loud, t, T).amin(-1)
        last = torch.where(loud, t, -1).amax(-1)
        start = torch.where(anyl, first * hop, 0)
        end = torch.where(anyl, torch.minimum(n[:, 0], (last + 1) * hop), 0)
        starts.append(start)
        tlens.append(end - start)
    return torch.cat(starts), torch.cat(tlens)


def hann(n_fft: int, device) -> torch.Tensor:
    k = torch.arange(n_fft, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)


def stft_mag2(waves, start, tlen, n_fft: int, hop: int, n_frames: int):
    """``|X|²`` f32 ``[B, n_frames, n_fft//2 + 1]`` of the centered frames
    of each trimmed clip ``waves[b, start : start + tlen]``."""
    dev = waves.device
    t = torch.arange(n_frames, device=dev)[:, None]
    j = torch.arange(n_fft, device=dev)[None, :]
    p = (t * hop - n_fft // 2 + j)[None]
    n = tlen.to(dev, torch.int64)[:, None, None]
    p = torch.where(p < 0, -p, p)
    p = torch.where(p >= n, 2 * n - 2 - p, p)
    p = torch.minimum(p.clamp_min(0), (n - 1).clamp_min(0)) + start.to(dev, torch.int64)[:, None, None]
    frames = torch.gather(waves.float(), 1, p.reshape(waves.shape[0], -1)).view(p.shape)
    frames = torch.where(n > 0, frames, 0.0) * hann(n_fft, dev)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def frame_logmag(waves, lengths, n_fft: int = 2048, top_db: float = 60.0):
    """Framewise ``log(1e-8 + |X| / n_fft)`` ``[B, T, n_fft//2 + 1]`` and the
    frames' validity ``[B, T]``, hop ``n_fft // 2``."""
    hop = n_fft // 2
    start, tlen = trim_bounds(waves, lengths, top_db)
    T = 1 + waves.shape[1] // hop
    mag2 = stft_mag2(waves, start, tlen, n_fft, hop, T)
    logmag = torch.log(LOG_FLOOR + torch.sqrt(mag2) / n_fft)
    valid = torch.arange(T, device=waves.device)[None, :] < 1 + tlen[:, None] // hop
    return logmag, valid


def freq_coords(num_bins: int, fs: int, device) -> torch.Tensor:
    return torch.linspace(0.0, fs / 2.0, num_bins, dtype=torch.float32, device=device) / fs


def serve_clouds(waves, lengths, pipe: dict, block: int = 128):
    """The 3ST serving clouds: ``(points [B·C, K, 3] bf16, chunk_valid
    [B, C])``.  The |X|² grid is rounded to bf16 (the configuration's
    serving precision), each chunk's K largest bins taken in flat order
    (t-major, frequency fastest; ties to the lower flat index), their
    log-magnitude ``0.5·log(max(v, (1e-8·n_fft)²)) − log(n_fft)`` and the
    affine coordinates ``f = (i mod F)·Δf``, ``t = (i div F)·Δt`` in bf16."""
    n_fft, hop, nt, k = pipe["n_fft"], pipe["n_fft"] // 2, pipe["num_frames"], pipe["top_k"]
    fs = pipe["fs"]
    B, L = waves.shape
    C = (1 + L // hop) // nt
    F = n_fft // 2
    dt = torch.bfloat16
    cf = float(torch.tensor(0.5 / (F - 1), dtype=dt))
    ct = float(torch.tensor((0.5 * n_fft / fs) * nt / (nt - 1), dtype=dt))
    floor = (LOG_FLOOR * n_fft) ** 2
    start, tlen = trim_bounds(waves, lengths, pipe["top_db"])
    pts, valid = [], []
    for i in range(0, B, block):
        s, n = start[i: i + block], tlen[i: i + block]
        m2 = stft_mag2(waves[i: i + block], s, n, n_fft, hop, C * nt)[..., :F]
        grid = m2.to(dt).reshape(-1, C, nt * F).reshape(-1, nt * F)
        idx = torch.sort(grid.float(), dim=-1, descending=True, stable=True).indices[:, :k]
        v2 = torch.gather(grid, 1, idx).float()
        vals = (0.5 * torch.log(v2.clamp_min(floor)) - math.log(n_fft)).to(dt)
        pts.append(torch.stack([(idx % F).to(dt) * cf, (idx // F).to(dt) * ct, vals], -1))
        c = torch.arange(C, device=waves.device)
        valid.append((c[None, :] + 1) * nt <= (1 + n // hop)[:, None])
    return torch.cat(pts), torch.cat(valid)


def clip_logits(chunk_logits: torch.Tensor, chunk_valid: torch.Tensor) -> torch.Tensor:
    """The mean of each clip's valid chunks' logits (zeros for a clip with
    none)."""
    B, C = chunk_valid.shape
    w = chunk_valid[..., None].float()
    return (chunk_logits.reshape(B, C, -1).float() * w).sum(1) / w.sum(1).clamp_min(1.0)
