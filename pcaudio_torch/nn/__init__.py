from pcaudio_torch.nn.attention import ISAB, MAB, PMA, SAB
from pcaudio_torch.nn.models import ST
from pcaudio_torch.ops.kernels.mha import masked_softmax

__all__ = ["MAB", "SAB", "ISAB", "PMA", "ST", "masked_softmax"]
