from pcaudio_torch.dsp.featurize import chunk_mask, temporal_chunks
from pcaudio_torch.dsp.stft import stft_window, trimmed_stft_mag2
from pcaudio_torch.dsp.trim import frame_power, trim_bounds

__all__ = ["frame_power", "trim_bounds", "stft_window", "trimmed_stft_mag2",
           "temporal_chunks", "chunk_mask"]
