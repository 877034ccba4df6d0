"""The ingest probe's host-side parts (``pcaudio_torch/probes/ingest.py``):
its corpus is ``scripts/bench_serving_ingest.py``'s clips, written once and
copied; its request loop takes requests in turn; and the idle share of a
trace counts overlapping copies and kernels once (``timing.busy_time``).
The timings themselves need the card (``chip_smoke.py`` phase 9)."""
import filecmp
import os

import numpy as np
import pytest

from pcaudio.data import synthetic as jax_synthetic
from pcaudio_torch.data.audio_io import load_wav
from pcaudio_torch.probes import ingest
from pcaudio_torch.probes.timing import busy_time


def test_corpus_is_the_jax_scripts_clips_copied(tmp_path):
    paths = ingest.write_corpus(str(tmp_path / "port"), 7, distinct=3)
    assert [os.path.basename(p) for p in paths] == [f"clip_{i:05d}.wav"
                                                    for i in range(7)]
    for i, p in enumerate(paths[:3]):  # the JAX script's clip i
        ref = str(tmp_path / f"jax_{i}.wav")
        jax_synthetic.write_wav_pcm16(
            ref, jax_synthetic.synth_clip(i % 10, i // 10, n=ingest.CLIP), 44100)
        assert filecmp.cmp(p, ref, shallow=False)
    for i in range(3, 7):
        assert filecmp.cmp(paths[i], paths[i % 3], shallow=False)
    clips = ingest.decoded_clips(paths, distinct=3)
    assert len(clips) == 7 and clips[5] is clips[2]
    np.testing.assert_array_equal(clips[1], load_wav(paths[1])[0])
    assert len(clips[0]) == ingest.CLIP
    assert ingest.read_only(paths, 3) > 0  # every byte of every file read


@pytest.mark.parametrize("size,n", [(1, 5), (8, 20), (64, 100)])
def test_latency_takes_requests_in_turn(size, n):
    seen = []
    ms = ingest.latency(seen.append, list(range(n)), size, requests=4)
    assert len(ms) == 4 and all(t >= 0 for t in ms)
    assert len(seen) == 6 and all(len(r) == size for r in seen)
    flat = [x for r in seen for x in r]
    assert flat == [i % n for i in range(6 * size)]


@pytest.mark.parametrize("spans,busy", [
    ([(0, 10)], 10),
    ([(0, 10), (5, 12)], 12),          # a copy overlapping a kernel
    ([(0, 10), (2, 3), (20, 25)], 15), # one inside another, then a gap
    ([(20, 25), (0, 4), (3, 8)], 13),  # out of order
])
def test_busy_time_is_the_union_of_intervals(spans, busy):
    assert busy_time(spans) == busy
