from pcaudio_torch.dsp.fbank import fbank_batch, mel_filters
from pcaudio_torch.dsp.featurize import (
    FeaturizeConfig, batched_temporal_chunks, chunk_mask, featurize_batch,
    featurized_max_frames, temporal_chunks)
from pcaudio_torch.dsp.resample import (
    batched_resample, resample, resample_length)
from pcaudio_torch.dsp.stft import (
    frame_positions, stft_logmag, stft_window, trimmed_stft_mag2)
from pcaudio_torch.dsp.trim import frame_power, trim_bounds

__all__ = ["fbank_batch", "mel_filters", "frame_power", "trim_bounds",
           "stft_window", "frame_positions", "trimmed_stft_mag2", "stft_logmag",
           "FeaturizeConfig", "featurize_batch", "featurized_max_frames", "temporal_chunks",
           "batched_temporal_chunks", "chunk_mask", "resample",
           "batched_resample", "resample_length"]
