from pcaudio_torch.dsp.featurize import (
    FeaturizeConfig, batched_temporal_chunks, chunk_mask, featurize_batch,
    temporal_chunks)
from pcaudio_torch.dsp.stft import stft_logmag, stft_window, trimmed_stft_mag2
from pcaudio_torch.dsp.trim import frame_power, trim_bounds

__all__ = ["frame_power", "trim_bounds", "stft_window", "trimmed_stft_mag2",
           "stft_logmag", "FeaturizeConfig", "featurize_batch",
           "temporal_chunks", "batched_temporal_chunks", "chunk_mask"]
