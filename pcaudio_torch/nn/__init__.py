from pcaudio_torch.nn.ast import AST
from pcaudio_torch.nn.attention import ISAB, MAB, PMA, SAB
from pcaudio_torch.nn.models import (
    ST, BaselineFF, CNNClassifier, DeepSet, Dropout, SetTransformer)
from pcaudio_torch.ops.kernels.mha import masked_softmax

__all__ = ["MAB", "SAB", "ISAB", "PMA", "ST", "AST", "BaselineFF", "CNNClassifier",
           "DeepSet", "SetTransformer", "Dropout", "masked_softmax"]
