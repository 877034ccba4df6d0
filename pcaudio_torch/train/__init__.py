from pcaudio_torch.train.glue import dropout_apply, pointcloud_apply
from pcaudio_torch.train.loop import fit
from pcaudio_torch.train.recipes import (
    RECIPES,
    build_trainer,
    cnn_temp_config,
    fb_config,
    fst_config,
    prepare_data,
    prepare_framewise_data,
    prepare_temporal_data,
    st3_config,
)
from pcaudio_torch.train.step import TrainState, make_eval_step, make_train_step

__all__ = [
    "TrainState", "make_train_step", "make_eval_step", "pointcloud_apply",
    "dropout_apply", "fit", "RECIPES", "fst_config", "fb_config", "st3_config",
    "cnn_temp_config", "build_trainer", "prepare_framewise_data",
    "prepare_temporal_data", "prepare_data",
]
