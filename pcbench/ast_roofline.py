"""Operations and bytes of the Audio Spectrogram Transformer: the yardstick
of ``mfu.ast`` and ``k5_roofline.ast``.  One multiply-add is 2 FLOPs
(``roofline.py``'s convention); LayerNorm, GELU, the softmax, biases and
residuals are left out.  The counts describe the work, not an
implementation."""
from __future__ import annotations

from pcbench.roofline import dense_flops


def patches(cfg: dict) -> int:
    """Patches of one clip's grid."""
    ps = cfg["patch_size"]
    return (((cfg["num_mel_bins"] - ps) // cfg["frequency_stride"] + 1)
            * ((cfg["max_length"] - ps) // cfg["time_stride"] + 1))


def tokens(cfg: dict) -> int:
    """Tokens of one clip: the patches, the cls and the distillation token."""
    return patches(cfg) + 2


def k5_flops(cfg: dict, n: int) -> int:
    """One clip's attention over all layers and heads at ``n`` tokens: QKᵀ
    and P·V, 2·n²·hidden each a layer."""
    return cfg["num_hidden_layers"] * 4 * n * n * cfg["hidden_size"]


def k5_bytes(cfg: dict, n: int) -> int:
    """One clip's bf16 Q, K and V read and O written once, all layers."""
    return cfg["num_hidden_layers"] * 4 * n * cfg["hidden_size"] * 2


def ast_flops(cfg: dict, n: int) -> int:
    """The whole forward of one clip at ``n`` tokens: the patch projection,
    per layer the fused QKV, attention, the out-projection and the two MLP
    products, and the head (261.1 GFLOP at the published sizes)."""
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    ps = cfg["patch_size"]
    layer = (dense_flops(n, d, 3 * d) + dense_flops(n, d, d) + dense_flops(n, d, m)
             + dense_flops(n, m, d))
    return (dense_flops(n - 2, ps * ps, d) + cfg["num_hidden_layers"] * layer
            + k5_flops(cfg, n) + dense_flops(1, d, cfg["num_labels"]))
