"""ESC-50 metadata loading and the seed-compatible train/test split (a copy
of ``pcaudio/data/esc.py``).

Reference: ``Code/data_processing.py``.  Behavior reproduced exactly:

  * ``load_esc`` reads ``esc50.csv``, filters to the 10 ESC-10 categories,
    remaps labels to 0-9 *in category-list order* (``data_processing.py:8-38``);
  * ``tt_split`` is a stratified file-level 80/20 split whose test-set
    membership depends on numpy's GLOBAL RNG: one
    ``np.random.permutation(N_k)`` per class k in label order
    (``data_processing.py:40-65``).  The eval harness re-seeds numpy from the
    saved config to regenerate the identical split (``Code/pceval.py:30-33``)
    — SURVEY.md §7 hard part 3 — so this stays host-side numpy, bit-for-bit.
"""
from __future__ import annotations

import csv
from typing import List, Sequence, Tuple

import numpy as np

ESC10_CATEGORIES = (
    "dog", "chainsaw", "crackling_fire", "helicopter", "rain",
    "crying_baby", "clock_tick", "sneezing", "rooster", "sea_waves",
)


def load_esc(
    loc: str,
    loc_audio: str,
    list_categories: Sequence[str] = ESC10_CATEGORIES,
) -> Tuple[np.ndarray, np.ndarray]:
    """Read the ESC-50 metadata CSV and return (audio_paths, labels) for the
    selected categories, labels remapped to ``range(len(list_categories))``
    in list order.  Rows keep CSV order (as the reference's pandas filter
    does)."""
    remap = {cat: i for i, cat in enumerate(list_categories)}
    paths: List[str] = []
    labels: List[int] = []
    with open(loc, newline="") as f:
        for row in csv.DictReader(f):
            cat = row["category"]
            if cat in remap:
                paths.append(loc_audio + row["filename"])
                labels.append(remap[cat])
    return np.array(paths), np.array(labels)


def tt_split(
    list_audio_locs: Sequence[str],
    l: np.ndarray,
    f: float = 0.8,
) -> Tuple[List[str], List[int], List[str], List[int]]:
    """Stratified file-level split, RNG-compatible with the reference.

    Consumes numpy's global RNG exactly as ``Code/data_processing.py:40-65``
    does — one ``np.random.permutation(len(class_k))`` per class, classes in
    label order 0..nclass-1, files within a class in input order — so seeding
    ``np.random.seed(s)`` first reproduces the reference split for seed ``s``.
    """
    l = np.asarray(l)
    nclass = int(l.max()) + 1
    by_class: List[List[str]] = [[] for _ in range(nclass)]
    for path, lab in zip(list_audio_locs, l):
        by_class[int(lab)].append(path)

    audio_train: List[str] = []
    l_train: List[int] = []
    audio_test: List[str] = []
    l_test: List[int] = []
    for k in range(nclass):
        files = by_class[k]
        n = len(files)
        inds = np.random.permutation(n)
        cut = int(f * n)
        for idx in inds[:cut]:
            audio_train.append(files[idx])
            l_train.append(k)
        for idx in inds[cut:]:
            audio_test.append(files[idx])
            l_test.append(k)
    return audio_train, l_train, audio_test, l_test


ESC50_BUFFER_LEN = 220672  # 5 s at 44.1 kHz, rounded up to a multiple of 1024


def load_esc_split_waves(
    csv_path: str,
    audio_dir: str,
    numpy_seed: int,
    buffer_len: int = ESC50_BUFFER_LEN,
    split: str = "test",
    f: float = 0.8,
):
    """Reproduce the reference's seeded split (``Code/pceval.py:30-33``: the
    eval scripts re-seed numpy's global RNG from the saved config so
    ``tt_split`` regenerates the identical held-out set) and decode that
    split's WAVs into a padded batch.

    Returns ``(waves [B, buffer_len] f32, lengths [B] i32, labels [B] i32)``.
    """
    from pcaudio_torch.data.audio_io import load_wav_batch

    paths, labels = load_esc(csv_path, audio_dir)
    np.random.seed(numpy_seed)
    tr, ltr, te, lte = tt_split(paths, labels, f=f)
    use_paths, use_labels = (tr, ltr) if split == "train" else (te, lte)
    waves, lengths = load_wav_batch(use_paths, buffer_len)
    return waves, lengths, np.asarray(use_labels, np.int32)
