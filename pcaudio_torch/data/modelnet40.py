"""ModelNet40 point-cloud data pipeline (the port's own copy of the numpy-only
``pcaudio/data/modelnet40.py``; no ``pcaudio`` import).

Behavioral re-implementation of the vendored loader
(``set_transformer-master/data_modelnet40.py``): h5 file with
``tr_cloud/tr_labels/test_cloud/test_labels``; a *fixed* down-sampling
permutation drawn once from the fetcher's generator; per-cloud
standardization with 100×mean-|x| outlier clipping; train-time
augmentation = z-rotation in ±0.1π plus per-axis uniform scale in
[0.8, 1.25]; generator batching that drops the final batch
(``while end < N``, even when N divides evenly) and test clouds
down-sampled with the off-by-one ``[1::down_sample]`` stride — quirks
preserved, so batches equal the JAX fetcher's exactly.

The h5 read is the only use of ``h5py``, imported where the file is read:
:meth:`ModelNet40Fetcher.from_arrays` builds a fetcher from arrays in
memory where ``h5py`` is missing.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def rotate_z(theta: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Rotate each cloud about the z axis; ``theta [B]``, ``x [B, N, 3]``."""
    c, s = np.cos(theta)[:, None], np.sin(theta)[:, None]
    out = np.empty_like(x)
    out[..., 0] = c * x[..., 0] - s * x[..., 1]
    out[..., 1] = s * x[..., 0] + c * x[..., 1]
    out[..., 2] = x[..., 2]
    return out


def augment(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random z-rotation (±0.1π) + per-axis scale ([0.8, 1.25])."""
    bs = x.shape[0]
    thetas = rng.uniform(-0.1, 0.1, bs) * np.pi
    rotated = rotate_z(thetas, x)
    scale = rng.uniform(0.8, 1.25, (bs, 1, 3))
    return rotated * scale


def standardize(x: np.ndarray) -> np.ndarray:
    """Per-cloud zero-mean/unit-std over all coords, after clipping outliers
    at ±100× the mean absolute value."""
    clipper = np.mean(np.abs(x), axis=(1, 2), keepdims=True)
    z = np.clip(x, -100 * clipper, 100 * clipper)
    mean = np.mean(z, axis=(1, 2), keepdims=True)
    std = np.std(z, axis=(1, 2), keepdims=True)
    return (z - mean) / std


class ModelNet40Fetcher:
    """Batched train/test iterators over the ModelNet40 h5 dump, or over
    the same four arrays in memory (:meth:`from_arrays`)."""

    def __init__(
        self,
        fname: str,
        batch_size: int,
        down_sample: int = 10,
        do_standardize: bool = True,
        do_augmentation: bool = False,
        seed: int = 0,
    ):
        import h5py

        with h5py.File(fname, "r") as f:
            arrays = (np.array(f["tr_cloud"], dtype=np.float32),
                      np.array(f["tr_labels"], dtype=np.int32),
                      np.array(f["test_cloud"], dtype=np.float32),
                      np.array(f["test_labels"], dtype=np.int32))
        self._setup(*arrays, batch_size, down_sample, do_standardize,
                    do_augmentation, seed)

    @classmethod
    def from_arrays(cls, train_clouds, train_labels, test_clouds, test_labels,
                    batch_size: int, down_sample: int = 10,
                    do_standardize: bool = True, do_augmentation: bool = False,
                    seed: int = 0) -> "ModelNet40Fetcher":
        """A fetcher over ``[N, P, 3]`` clouds and ``[N]`` labels in memory,
        as the h5 file's ``tr_cloud/tr_labels/test_cloud/test_labels``."""
        self = cls.__new__(cls)
        self._setup(train_clouds, train_labels, test_clouds, test_labels,
                    batch_size, down_sample, do_standardize, do_augmentation,
                    seed)
        return self

    def _setup(self, train_clouds, train_labels, test_clouds, test_labels,
               batch_size, down_sample, do_standardize, do_augmentation, seed):
        self.train_clouds = np.array(train_clouds, dtype=np.float32)
        self.train_labels = np.array(train_labels, dtype=np.int32)
        self.test_clouds = np.array(test_clouds, dtype=np.float32)
        self.test_labels = np.array(test_labels, dtype=np.int32)
        self.batch_size = batch_size
        self.down_sample = down_sample
        self.do_standardize = do_standardize
        self.do_augmentation = do_augmentation
        self.num_classes = int(self.train_labels.max()) + 1
        self.rng = np.random.default_rng(seed)
        # fixed subset of points chosen once, used for every train batch
        self.perm = self.rng.permutation(self.train_clouds.shape[1])[::down_sample]
        self.num_train_batches = len(self.train_clouds) // batch_size
        self.num_test_batches = len(self.test_clouds) // batch_size

    def _prep(self, x: np.ndarray, train: bool) -> np.ndarray:
        if self.do_standardize:
            x = standardize(x)
        if train and self.do_augmentation:
            x = augment(x, self.rng)
        return x

    def train_data(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Shuffled epoch of (clouds [B,K,3], cardinality [B], labels [B])."""
        order = self.rng.permutation(len(self.train_clouds))
        clouds, labels = self.train_clouds[order], self.train_labels[order]
        card = len(self.perm) * np.ones(self.batch_size, np.int32)
        n = len(clouds)
        start, end = 0, self.batch_size
        while end < n:  # the reference drops the final batch
            yield (self._prep(clouds[start:end, self.perm], train=True),
                   card, labels[start:end])
            start, end = end, end + self.batch_size

    def test_data(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(clouds, cardinality, labels) of the test set in order, every
        ``down_sample``-th point from point 1 on (the reference's stride)."""
        sub = self.test_clouds[:, 1:: self.down_sample]
        card = sub.shape[1] * np.ones(self.batch_size, np.int32)
        n = len(sub)
        start, end = 0, self.batch_size
        while end < n:
            yield (self._prep(sub[start:end], train=False),
                   card, self.test_labels[start:end])
            start, end = end, end + self.batch_size
