"""The Audio Spectrogram Transformer and its Kaldi log-mel front end in
plain PyTorch, f32 (the front end in f64), in blocks of clips, for the
comparison that decides ``correct``; with the seeded weights and the plain
windowed-sinc resampler the cell's traffic takes.  It imports nothing of
the port.  ``tests/ast_reference.py`` is the tests' copy of the front end
and the forward.

Published description (Gong, Chung, Glass, arXiv:2104.01778) with the
equations of ``transformers``' ``ASTForAudioClassification`` and the front
end of its ``ASTFeatureExtractor`` (numpy path):

* fbank: frames of 400 samples at hop 160 (``1 + (len − 400) // 160`` of
  them, none under 400 samples), each less its mean, pre-emphasised by 0.97
  (``y[0] = 0.03·x[0]``), times a symmetric Hann window, a 512-point power
  spectrum, Kaldi-mel triangles (``1127·ln(1 + f/700)``, 20 Hz to fs/2,
  triangles in mel space), ``log(max(·, 1.1920929e-07))``; zero rows to
  ``max_length``, then ``(x − mean) / (2·std)``;
* the model: overlapping ``patch²`` patches of the ``[F, T]`` grid at
  strides ``(frequency_stride, time_stride)``, frequency-major, projected;
  cls and distillation tokens and learned positions; pre-LN blocks with
  erf GELU; final LN; the mean of the two special tokens; LN and the head.

Parameters are a dict under the port's ``AST`` names; ``cfg`` holds
``transformers``' ``ASTConfig`` names.  ``rnd`` rounds each matrix
product's operands (``precision.py``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from pcbench.reference.precision import exact, matmul
from pcbench.weights import derived_seed

F = torch.nn.functional
_MEL: Dict[tuple, torch.Tensor] = {}


def kaldi_mel(num_mel_bins: int, fs: int, n_fft: int = 512) -> torch.Tensor:
    """``[n_fft/2 + 1, num_mel_bins]`` f64 triangles, one bin and one filter
    at a time."""
    key = (num_mel_bins, fs, n_fft)
    if key in _MEL:
        return _MEL[key]

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
    _MEL[key] = out
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
    """``feats [B, max_length, num_mel_bins]`` → logits ``[B, num_labels]``."""
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
    """:func:`ast_forward` over blocks of ``block`` clips, without autograd
    (the caller turns TF32 off: ``precision.tf32_off``)."""
    with torch.no_grad():
        return torch.cat([ast_forward(p, feats[i: i + block], cfg, rnd)
                          for i in range(0, feats.shape[0], block)])


def shapes(cfg: dict):
    """``(name, shape, kind)`` of every parameter of the port's ``AST`` at
    ``cfg``'s sizes; kind ``w`` (truncated normal), ``0`` or ``1``."""
    D, L, M = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"]
    ps = cfg["patch_size"]
    f_out = (cfg["num_mel_bins"] - ps) // cfg["frequency_stride"] + 1
    t_out = (cfg["max_length"] - ps) // cfg["time_stride"] + 1
    out = [("patch.weight", (D, ps * ps), "w"), ("patch.bias", (D,), "0"),
           ("cls_token", (1, 1, D), "w"), ("dist_token", (1, 1, D), "w"),
           ("pos", (1, f_out * t_out + 2, D), "w")]
    for i in range(L):
        pre = f"blocks.{i}."
        for name, o, n in (("qkv", 3 * D, D), ("proj", D, D), ("fc1", M, D), ("fc2", D, M)):
            out += [(pre + name + ".weight", (o, n), "w"), (pre + name + ".bias", (o,), "0")]
        for name in ("ln1", "ln2"):
            out += [(pre + name + ".weight", (D,), "1"), (pre + name + ".bias", (D,), "0")]
    for name in ("norm", "head_norm"):
        out += [(name + ".weight", (D,), "1"), (name + ".bias", (D,), "0")]
    out += [("head.weight", (cfg["num_labels"], D), "w"), ("head.bias", (cfg["num_labels"],), "0")]
    return out


def state_dict(seed: int, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """The AST's f32 parameters from ``seed``, as ``transformers``
    initialises its AST but for the tokens and positions: every matrix, the
    two tokens and the positions truncated normal with std
    ``initializer_range`` (one draw on ``device``, cut), biases 0, LayerNorm
    weights 1."""
    sh = shapes(cfg)
    total = sum(math.prod(s) for _, s, k in sh if k == "w")
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, 3))
    u = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(u, 0.0, cfg["initializer_range"], generator=g)
    out, at = {}, 0
    for name, shape, kind in sh:
        if kind == "w":
            n = math.prod(shape)
            out[name] = u[at: at + n].reshape(shape).clone()
            at += n
        else:
            out[name] = torch.full(shape, float(kind), device=device)
    return out


def resample(x: torch.Tensor, orig: int, target: int, zeros: int = 32,
             rolloff: float = 0.945, block: int = 4) -> torch.Tensor:
    """``x [B, L]`` at ``orig`` Hz → ``[B, L·target/orig]`` at ``target`` Hz
    by a windowed sinc: output ``n`` at input time ``t = n·orig/target`` is
    ``Σ_k x[k]·h(t − k)``, ``h`` the sinc of cutoff ``rolloff·min(orig,
    target)/2`` under a Hann window of ``zeros`` of its zero crossings a
    side; samples outside the clip are 0.  ``block`` clips at a time, f32."""
    B, L = x.shape
    n_out = L * target // orig
    dev = x.device
    fc = rolloff * min(orig, target) / 2.0 / orig       # cycles an input sample
    half = math.ceil(zeros / (2.0 * fc))                 # taps a side
    t = torch.arange(n_out, device=dev, dtype=torch.float64) * (orig / target)
    base = torch.floor(t).long()
    k = base[:, None] + torch.arange(-half, half + 1, device=dev)[None]   # [n_out, taps]
    d = t[:, None] - k.double()
    w = 2.0 * fc * torch.sinc(2.0 * fc * d) * torch.where(
        d.abs() < half, 0.5 + 0.5 * torch.cos(math.pi * d / half), torch.zeros_like(d))
    w = torch.where((k >= 0) & (k < L), w, torch.zeros_like(w)).float()
    kc = k.clamp(0, L - 1)
    out = []
    for i in range(0, B, block):
        xs = x[i: i + block].float()
        out.append((xs[:, kc] * w[None]).sum(-1))
    return torch.cat(out)
