from pcaudio_torch.eval.pipeline import (
    TemporalPipelineConfig,
    extract_chunk_clouds,
    make_chunk_logits,
    make_temporal_classifier,
)

__all__ = ["TemporalPipelineConfig", "extract_chunk_clouds",
           "make_chunk_logits", "make_temporal_classifier"]
