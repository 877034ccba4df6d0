"""The Audio Spectrogram Transformer and its Kaldi log-mel front end in
plain PyTorch, for the tests: it imports nothing of ``pcaudio_torch`` and no
JAX, and computes the model in f32 (the front end in f64), in blocks of
clips.  ``pcbench/reference/ast.py`` is the benchmark's copy.

Published description (Gong, Chung, Glass, arXiv:2104.01778) with the
equations of ``transformers``' ``ASTForAudioClassification`` and the front
end of its ``ASTFeatureExtractor`` (numpy path):

* fbank: frames of 400 samples at hop 160 (``1 + (len − 400) // 160`` of
  them, none under 400 samples), each less its mean, pre-emphasised by 0.97
  (``y[0] = 0.03·x[0]``), times a symmetric Hann window, a 512-point power
  spectrum, 128 Kaldi-mel triangles (``1127·ln(1 + f/700)``, 20 Hz to
  fs/2, triangles in mel space), ``log(max(·, 1.1920929e-07))``; zero rows
  to ``max_length``, then ``(x − mean) / (2·std)``;
* the model: overlapping ``patch²`` patches of the ``[F, T]`` grid at
  strides ``(frequency_stride, time_stride)``, frequency-major, projected;
  cls and distillation tokens and learned positions; pre-LN blocks with
  erf GELU; final LN; the mean of the two special tokens; LN and the head.

Parameters come as a dict under the names of the port's ``AST``.  ``rnd``
rounds each matrix product's operands (identity for f32, or bf16 etc.), as
``pcbench/reference/precision.py`` does.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def exact(x):
    return x


def bf16(x):
    return x.to(torch.bfloat16).float()


def matmul(a, b, rnd=exact):
    return rnd(a) @ rnd(b)


@functools.lru_cache(maxsize=4)
def kaldi_mel(num_mel_bins: int, fs: int, n_fft: int = 512) -> torch.Tensor:
    """``[n_fft/2 + 1, num_mel_bins]`` f64 triangles, one bin and one filter
    at a time."""
    def mel(f):
        return 1127.0 * math.log(1.0 + f / 700.0)
    lo, hi = mel(20.0), mel(fs / 2.0)
    edge = [lo + (hi - lo) * i / (num_mel_bins + 1) for i in range(num_mel_bins + 2)]
    out = torch.zeros(n_fft // 2 + 1, num_mel_bins, dtype=torch.float64)
    for k in range(n_fft // 2 + 1):
        m = mel(k * fs / n_fft)
        for j in range(num_mel_bins):
            left, mid, right = edge[j], edge[j + 1], edge[j + 2]
            out[k, j] = max(0.0, min((m - left) / (mid - left), (right - m) / (right - mid)))
    return out


def fbank(waves, lengths, num_mel_bins: int = 128, max_length: int = 1024,
          mean: float = -4.2677393, std: float = 4.5689974, fs: int = 16000):
    """``waves [B, L]`` → normalised features ``[B, max_length,
    num_mel_bins]`` f32, one clip at a time in f64."""
    dev = waves.device
    B = waves.shape[0]
    win = torch.hann_window(400, periodic=False, dtype=torch.float64, device=dev)
    filt = kaldi_mel(num_mel_bins, fs).to(dev)
    out = torch.zeros(B, max_length, num_mel_bins, dtype=torch.float64, device=dev)
    for b in range(B):
        n = int(lengths[b])
        T = min(max_length, max(0, 1 + (n - 400) // 160))
        if T == 0:
            continue
        idx = torch.arange(T, device=dev)[:, None] * 160 + torch.arange(400, device=dev)[None]
        x = waves[b].double()[idx]
        x = x - x.mean(1, keepdim=True)
        y = torch.empty_like(x)
        y[:, 0] = 0.03 * x[:, 0]
        y[:, 1:] = x[:, 1:] - 0.97 * x[:, :-1]
        power = torch.fft.rfft(y * win, n=512).abs() ** 2
        out[b, :T] = torch.log(torch.clamp(power @ filt, min=1.1920929e-07))
    return ((out - mean) / (2.0 * std)).float()


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def _linear(x, p, name, rnd):
    return matmul(x, p[name + ".weight"].t(), rnd) + p[name + ".bias"]


def ast_forward(p, feats, cfg: dict, rnd=exact):
    """``feats [B, max_length, num_mel_bins]`` → logits ``[B, num_labels]``;
    ``cfg`` holds ``transformers``' ``ASTConfig`` names."""
    B = feats.shape[0]
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dh, eps, ps = D // H, cfg["layer_norm_eps"], cfg["patch_size"]
    cols = F.unfold(feats.float().transpose(1, 2)[:, None], ps,
                    stride=(cfg["frequency_stride"], cfg["time_stride"]))
    x = _linear(cols.transpose(1, 2), p, "patch", rnd)
    x = torch.cat([p["cls_token"].expand(B, -1, -1), p["dist_token"].expand(B, -1, -1), x], 1)
    x = x + p["pos"]
    N = x.shape[1]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{i}."
        qkv = _linear(_ln(x, p, pre + "ln1", eps), p, pre + "qkv", rnd)
        q, k, v = qkv.reshape(B, N, 3, H, dh).permute(2, 0, 3, 1, 4)
        a = torch.softmax(matmul(q, k.transpose(-1, -2), rnd) / math.sqrt(dh), dim=-1)
        o = matmul(a, v, rnd).transpose(1, 2).reshape(B, N, D)
        x = x + _linear(o, p, pre + "proj", rnd)
        h = F.gelu(_linear(_ln(x, p, pre + "ln2", eps), p, pre + "fc1", rnd))
        x = x + _linear(h, p, pre + "fc2", rnd)
    x = _ln(x, p, "norm", eps)
    return _linear(_ln((x[:, 0] + x[:, 1]) / 2, p, "head_norm", eps), p, "head", rnd)


def ast_forward_blocks(p, feats, cfg: dict, rnd=exact, block: int = 8):
    """:func:`ast_forward` over blocks of ``block`` clips, without autograd,
    with f32 products in f32 (TF32 off on the card)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return torch.cat([ast_forward(p, feats[i: i + block], cfg, rnd)
                              for i in range(0, feats.shape[0], block)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
