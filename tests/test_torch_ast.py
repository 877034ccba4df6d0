"""The Audio Spectrogram Transformer in the port (``nn/ast.py``,
``dsp/fbank.py``, K5's plain twin, the spectrogram pipeline, the
``transformers`` name map) against the plain reference
(``tests/ast_reference.py``) and against ``transformers``' own AST, on the
CPU at a small size: width 128, 2 heads of 64, 2 layers, 32 mel bins, 64
frames.

Every comparison is a gap over a scale, each held to a tolerance with its
reason, and a deliberately wrong variant (the distillation token's vector
replaced by the cls token's, no pre-emphasis, the scale of the whole width,
patches cut one frame off) must fail the same tolerance, so that each one
can fail."""
import os

import numpy as np
import pytest
import torch

import ast_reference as ref
from pcaudio_torch.checkpoint import ast_state_dict_from_hf
from pcaudio_torch.dsp.fbank import fbank_batch, mel_filters, num_frames
from pcaudio_torch.eval.pipeline import (
    SpectrogramPipelineConfig, make_spectrogram_classifier)
from pcaudio_torch.nn import AST
from pcaudio_torch.ops.kernels.attn import attn_fwd, attn_fwd_plain
from pcaudio_torch.serve import AudioClassifier

CFG = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=256, patch_size=16, frequency_stride=10, time_stride=10,
           num_mel_bins=32, max_length=64, num_labels=10, layer_norm_eps=1e-12)
SMALL = dict(num_mel_bins=32, max_length=64, dim=128, depth=2, heads=2, mlp=256,
             num_labels=10)
FS = 16000
# buffer of 12,000 samples: 73 frames, cut to 64; 400 samples make one frame,
# 10,480 exactly 64, 300 none
LENGTHS = (12000, 400, 5000, 10480)
SHORT = 300

# f32 front end against f64 (the reference, and transformers' numpy path,
# whose spectrum passes through complex64): the normalised grid agrees to
# 2.2e-6 (a log of f32 sums; /9.14 by the normalisation); 2e-5 leaves room
FBANK_TOL = 2e-5
# the model in f32 against f32 (sums in another order over 2 layers): the
# widest logit gap is 1.6e-6 of the RMS of the logits' deviation from their
# batch mean (the scale the clips differ on); 1e-4 leaves room
F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(lengths=LENGTHS, L=12000, seed=0):
    rng = np.random.default_rng(seed)
    w = np.zeros((len(lengths), L), np.float32)
    t = np.arange(L) / FS
    for i, n in enumerate(lengths):
        w[i, :n] = (0.2 * np.sin(2 * np.pi * (300 + 200 * i) * t[:n])
                    + 0.05 * rng.standard_normal(n))
    return torch.from_numpy(w), torch.tensor(lengths, dtype=torch.int32)


def _params(seed=0):
    """Seeded f32 parameters under the port's names: every matrix, the
    tokens and positions N(0, 0.02), biases and LayerNorms near 0 and 1
    (perturbed, so that a name mapped wrongly shows)."""
    g = torch.Generator().manual_seed(seed)
    m = AST(**SMALL)
    out = {}
    for name, p in m.state_dict().items():
        r = torch.randn(p.shape, generator=g)
        if name.endswith(".weight") and p.dim() == 1:   # LayerNorm
            out[name] = 1.0 + 0.1 * r
        else:
            out[name] = 0.02 * r
    return out


def _model(params, **kw):
    m = AST(**SMALL, **kw).eval()
    m.load_state_dict(params)
    return m


def gap(got, want):
    """The widest gap over the RMS of the reference's deviation from its
    batch mean: with random weights much of each logit is the same for every
    clip, and an undivided scale would let an error hide there."""
    want = want.double()
    dev = want - want.mean(0)
    return float((got.double() - want).abs().max() / dev.pow(2).mean().sqrt())


def _transformers():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def _hf_features(waves, lengths):
    """``ASTFeatureExtractor`` on its numpy path (torchaudio absent or not)."""
    tr = _transformers()
    from transformers.models.audio_spectrogram_transformer import (
        feature_extraction_audio_spectrogram_transformer as fe)

    saved = fe.is_speech_available
    fe.is_speech_available = lambda: False
    try:
        fx = tr.ASTFeatureExtractor(num_mel_bins=CFG["num_mel_bins"],
                                    max_length=CFG["max_length"])
        clips = [waves[i, :int(n)].numpy() for i, n in enumerate(lengths)]
        return torch.from_numpy(np.stack(fx(clips, sampling_rate=FS)["input_values"]))
    finally:
        fe.is_speech_available = saved


def test_frames_count():
    lengths = torch.tensor([0, 300, 399, 400, 559, 560, 160000, 400 + 2000 * 160])
    assert num_frames(lengths, 1024).tolist() == [0, 0, 0, 1, 1, 2, 998, 1024]


def test_fbank_matches_reference_and_transformers():
    waves, lengths = _clips()
    got, frames = fbank_batch(waves, lengths, CFG["num_mel_bins"], CFG["max_length"])
    assert frames.tolist() == [64, 1, 29, 64]
    want = ref.fbank(waves, lengths, CFG["num_mel_bins"], CFG["max_length"])
    hf = _hf_features(waves, lengths)
    assert float((got - want).abs().max()) < FBANK_TOL
    assert float((got - hf).abs().max()) < FBANK_TOL
    # control: no pre-emphasis
    x = waves.clone()
    x[:, 1:] = waves[:, 1:] + 0.97 * waves[:, :-1]   # undoes it on the frames' insides
    wrong, _ = fbank_batch(x, lengths, CFG["num_mel_bins"], CFG["max_length"])
    assert float((wrong - hf).abs().max()) > FBANK_TOL


def test_fbank_short_clip_and_filters():
    waves, lengths = _clips(lengths=(SHORT, 5000))
    got, frames = fbank_batch(waves, lengths, CFG["num_mel_bins"], CFG["max_length"])
    want = ref.fbank(waves, lengths, CFG["num_mel_bins"], CFG["max_length"])
    assert frames.tolist() == [0, 29]
    assert float((got - want).abs().max()) < FBANK_TOL
    assert torch.all(got[0] == got[0, 0, 0])      # zeros, normalised
    torch.testing.assert_close(mel_filters(128, FS).double(), ref.kaldi_mel(128, FS),
                               rtol=0, atol=1e-6)


def test_ast_plain_matches_reference():
    p = _params()
    waves, lengths = _clips()
    feats = ref.fbank(waves, lengths, CFG["num_mel_bins"], CFG["max_length"])
    with torch.no_grad():
        got = _model(p)(feats)
    want = ref.ast_forward(p, feats, CFG)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert gap(got, want) < F32_TOL
    # controls: the distillation token's vector replaced by the cls token's;
    # patches cut one frame later
    q = dict(p)
    q["dist_token"] = p["cls_token"]
    with torch.no_grad():
        assert gap(_model(q)(feats), want) > F32_TOL
        assert gap(_model(p)(torch.roll(feats, 1, dims=1)), want) > F32_TOL


def test_ast_matches_transformers():
    tr = _transformers()
    torch.manual_seed(0)
    hf = tr.ASTForAudioClassification(
        tr.ASTConfig(**CFG, attn_implementation="eager")).eval()
    with torch.no_grad():   # the init zeroes tokens and biases: perturb them
        for name, t in hf.named_parameters():
            if "token" in name or "position" in name or "layernorm" in name \
                    or name.endswith("bias"):
                t.add_(0.02 * torch.randn_like(t))
    sd = ast_state_dict_from_hf(hf.state_dict())
    model = _model(sd)   # strict: every name mapped, none left over
    assert set(sd) == set(model.state_dict())
    waves, lengths = _clips()
    feats = _hf_features(waves, lengths)
    with torch.no_grad():
        want = hf(input_values=feats).logits
        assert gap(model(feats), want) < F32_TOL
        assert gap(torch.from_numpy(ref.ast_forward(sd, feats, CFG).numpy()), want) < F32_TOL
        sd["dist_token"] = sd["cls_token"]
        assert gap(_model(sd)(feats), want) > F32_TOL


def _attn_reference(qkv, heads, scale):
    B, N, _ = qkv.shape
    q, k, v = qkv.float().reshape(B, N, 3, heads, 64).permute(2, 0, 3, 1, 4)
    o = torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v
    return o.transpose(1, 2).reshape(B, N, heads * 64)


# K5's twin in bf16 against the f32 softmax of the same bf16 operands: P
# and the output are rounded to bf16 (2^-9 relative each); measured 3.3e-3
# of the reference output's largest value, so 1.2e-2; a wrong scale misses
# by 0.38 or more
K5_TOL = 1.2e-2


@pytest.mark.parametrize("N", [1, 63, 64, 70, 130])
def test_k5_plain_twin_matches_reference_attention(N):
    g = torch.Generator().manual_seed(N)
    heads = 2
    qkv = torch.randn(3, N, 3 * heads * 64, generator=g).to(torch.bfloat16)
    want = _attn_reference(qkv, heads, 0.125)
    got = attn_fwd_plain(qkv, heads, 0.125, block=2)
    assert got.dtype == torch.bfloat16 and got.shape == (3, N, heads * 64)
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) < K5_TOL * scale
    # the wrapper takes the twin for CPU tensors
    assert torch.equal(attn_fwd(qkv, heads, 0.125), got)
    if N > 1:
        wrong = attn_fwd_plain(qkv, heads, 0.125 / 2 ** 0.5)
        assert float((wrong.float() - want).abs().max()) > K5_TOL * scale


# the bf16 pipeline against the reference with each product's operands
# rounded to bf16 (f32 elsewhere): the program also rounds its activations,
# LayerNorm outputs and residual stream to bf16, which the reference does
# not; measured 0.099 here (4 clips, 2 layers; the clips' logits differ by
# a fifth of their size), so 0.25; the wrong variant reads 1.76
BF16_TOL = 0.25


def test_spectrogram_classifier_matches_reference():
    p = _params()
    waves, lengths = _clips()
    want = ref.ast_forward(p, ref.fbank(waves, lengths, CFG["num_mel_bins"],
                                        CFG["max_length"]), CFG, ref.bf16)
    model = _model(p)
    cfg = SpectrogramPipelineConfig(num_mel_bins=32, max_length=64)
    got = make_spectrogram_classifier(model, cfg, plain=True)(waves, lengths)
    assert got.dtype == torch.float32
    assert gap(got, want) < BF16_TOL
    # the model given is left in f32
    assert all(t.dtype == torch.float32 for t in model.parameters())
    q = dict(p)
    q["dist_token"] = p["cls_token"]
    wrong = make_spectrogram_classifier(_model(q), cfg, plain=True)(waves, lengths)
    assert gap(wrong, want) > BF16_TOL


def test_audio_classifier_serves_ast():
    p = _params()
    waves, lengths = _clips()
    clips = [waves[i, :int(n)].numpy() for i, n in enumerate(lengths)]
    clf = AudioClassifier(model=_model(p),
                          pipeline=SpectrogramPipelineConfig(num_mel_bins=32, max_length=64),
                          batch_size=3, buffer_len=12000, device="cpu", plain=True)
    got = torch.from_numpy(clf.logits(clips))
    want = ref.ast_forward(p, ref.fbank(waves, lengths, 32, 64), CFG, ref.bf16)
    assert got.shape == (4, 10)
    assert gap(got, want) < BF16_TOL
    labels, probs = clf.classify(clips)
    assert labels.tolist() == got.argmax(-1).tolist()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_spectrogram_classifier_refuses_other_grids():
    with pytest.raises(ValueError):
        make_spectrogram_classifier(AST(**SMALL), SpectrogramPipelineConfig())
    with pytest.raises(ValueError):
        AST(dim=96, heads=2)
