from pcaudio_torch.eval.experiments import (
    default_list_Fs,
    default_list_K,
    default_list_N,
    framewise_expt1,
    framewise_expt2,
    make_3st_chunk_classifier,
    make_cloud_classifier,
    make_cnn_chunk_classifier,
    make_fb_frame_classifier,
    make_fst_frame_classifier,
    sweep_featurize_config,
    temporal_expt1,
    temporal_expt2,
)
from pcaudio_torch.eval.pipeline import (
    TemporalPipelineConfig,
    extract_chunk_clouds,
    make_chunk_logits,
    make_temporal_classifier,
)

__all__ = ["TemporalPipelineConfig", "extract_chunk_clouds",
           "make_chunk_logits", "make_temporal_classifier",
           "default_list_Fs", "default_list_K", "default_list_N",
           "sweep_featurize_config", "framewise_expt1", "framewise_expt2",
           "temporal_expt1", "temporal_expt2", "make_fst_frame_classifier",
           "make_3st_chunk_classifier", "make_cloud_classifier",
           "make_fb_frame_classifier", "make_cnn_chunk_classifier"]
