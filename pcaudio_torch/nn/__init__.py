from pcaudio_torch.nn.attention import ISAB, MAB, PMA, SAB, masked_softmax
from pcaudio_torch.nn.models import ST

__all__ = ["MAB", "SAB", "ISAB", "PMA", "ST", "masked_softmax"]
