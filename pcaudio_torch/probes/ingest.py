"""The serving ingest on the card: ``AudioClassifier.classify_paths`` from WAV
files to logits, the counterpart of ``scripts/bench_serving_ingest.py`` at
its shape: 2,048 PCM16 files of 5 s at 44.1 kHz (64 distinct
``synth_clip``s, each copied into 32 files: decode cost is per file, and one
clip takes tens of ms to make), batch 512, top-K 128, exact extraction,
fused featurize, bf16, a seeded 3ST 64/64/8.

    python -m pcaudio_torch.probes.ingest [--nclips 2048] [--batch 512] [--dir DIR]

Prints one line each for the decode threads; decode-only clips/s into
pinned int16 and f32 slots, and into int16 slots at 1, 4, 8 and 16
threads beside the clips/s of reading the files alone; end-to-end clips/s
of ``classify_paths`` with f32 and int16 staging (after one warm-up
batch); the H2D ms of one batch's slot on a copy stream (CUDA events) and
in the traced serving run; the compute ms of one batch on the card; the
device's idle share over a traced ``classify_paths`` run
(``timing.profile_device``); and request latency p50 / p99 over 30
requests of 1, 8 and 64 files (a classifier whose bucket is the request
size) for both staging types, and of ``logits`` on the same clips in
memory.  Every line carries the card's name and power limit.  The
files are read from the page cache: the run writes them just before.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.data.audio_io import load_wav
from pcaudio_torch.data.synthetic import synth_clip, write_wav_pcm16
from pcaudio_torch.eval import TemporalPipelineConfig
from pcaudio_torch.native import PrefetchingLoader, decode_wav_batch
from pcaudio_torch.nn import ST
from pcaudio_torch.probes.clips import FS, L
from pcaudio_torch.probes.timing import card, cuda_ms, profile_device
from pcaudio_torch.serve import AudioClassifier

CLIP = 5 * FS          # samples a file
DISTINCT = 64          # distinct clips in the corpus
LATENCY_SIZES = (1, 8, 64)
LATENCY_REQUESTS = 30  # timed requests a size, after 2 untimed ones
CFG = TemporalPipelineConfig(fs=FS, n_fft=1024, num_frames=10, top_k=128,
                             extraction="exact", featurize="fused",
                             stft_precision="default", compute_dtype="bfloat16")
STAGING = ("float32", "int16")
THREAD_SWEEP = (1, 4, 8, 16)   # decode threads tried beside the default


def corpus_paths(directory: str, nclips: int) -> List[str]:
    """The files :func:`write_corpus` writes, in order."""
    return [os.path.join(directory, f"clip_{i:05d}.wav") for i in range(nclips)]


def write_corpus(directory: str, nclips: int, distinct: int = DISTINCT) -> List[str]:
    """``nclips`` 5 s PCM16 WAV files: ``distinct`` ``synth_clip``s, file i
    a copy of clip i mod ``distinct``."""
    os.makedirs(directory, exist_ok=True)
    paths = corpus_paths(directory, nclips)
    for i, p in enumerate(paths):
        if i < distinct:
            write_wav_pcm16(p, synth_clip(i % 10, i // 10, n=CLIP), FS)
        else:
            shutil.copyfile(paths[i % distinct], p)
    return paths


def decoded_clips(paths: Sequence[str], distinct: int = DISTINCT) -> List[np.ndarray]:
    """Each file's clip in memory (Python decoder), decoding each distinct
    file once."""
    first = [load_wav(p)[0] for p in paths[:distinct]]
    return [first[i % distinct] for i in range(len(paths))]


def seeded_model(seed: int, device="cuda") -> ST:
    """Full-width 3ST (64 hidden, 64 inducing points, 8 heads), weights
    U(±1/sqrt(fan_in)) from a numpy seed."""
    model = ST(dim_input=3, dim_output=10, num_inds=64, dim_hidden=64,
               num_heads=8)
    rng = np.random.default_rng(seed)
    model.load_state_dict({
        k: torch.from_numpy(rng.uniform(-1, 1, v.shape).astype(np.float32)
                            / np.sqrt(v.shape[-1]))
        for k, v in model.state_dict().items()})
    return model.to(device).eval()


def _groups(paths, batch):
    return [list(paths[i: i + batch]) for i in range(0, len(paths), batch)]


def decode_only(paths: Sequence[str], batch: int, dtype: str, num_threads=None):
    """Clips/s of the ring alone into pinned slots (3 of them), over all
    ``paths`` (after one untimed pass); returns ``(clips/s, threads)``."""
    groups = _groups(paths, batch)
    depth = 3
    with PrefetchingLoader(L, batch, depth=depth, num_threads=num_threads,
                           dtype=dtype, pin_memory=True) as pf:
        for _ in range(2):  # the first pass untimed
            t0 = time.perf_counter()
            total = 0
            for g in groups[:depth]:
                pf.submit(g)
            for i in range(len(groups)):
                total += pf.next()[2]
                if i + depth < len(groups):
                    pf.submit(groups[i + depth])
            pf.release()
            dt = time.perf_counter() - t0
        return total / dt, pf.num_threads


def read_only(paths: Sequence[str], threads: int) -> float:
    """Clips/s of reading the files' bytes alone (no decode, no slot) over
    ``threads`` threads, each taking every threads-th file as the decoder's
    pool does, after one untimed pass: what the reads cost the decoder."""
    from concurrent.futures import ThreadPoolExecutor

    size = os.path.getsize(paths[0])

    def read(t):
        buf, n = bytearray(size), 0
        for i in range(t, len(paths), threads):
            with open(paths[i], "rb", buffering=0) as f:
                n += f.readinto(buf)
        return n

    with ThreadPoolExecutor(threads) as pool:
        for _ in range(2):
            t0 = time.perf_counter()
            n = sum(pool.map(read, range(threads)))
            dt = time.perf_counter() - t0
    if n != size * len(paths):
        raise RuntimeError(f"read {n} bytes of {size * len(paths)}")
    return len(paths) / dt


def h2d_ms(batch: int, dtype: str) -> float:
    """Mean ms of one ``[batch, L]`` pinned slot's non-blocking copy to the
    card on a stream of its own (CUDA events, 10 copies after a warm-up)."""
    iters = 10
    tdt = getattr(torch, dtype)
    src = torch.zeros((batch, L), dtype=tdt, pin_memory=True)
    dst = torch.empty(src.shape, dtype=tdt, device="cuda")
    stream = torch.cuda.Stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)
        start.record()
        for _ in range(iters):
            dst.copy_(src, non_blocking=True)
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compute_ms(clf: AudioClassifier, paths: Sequence[str]) -> float:
    """ms of the pipeline on one batch already on the card, in the
    classifier's staging type (CUDA events, 5 calls)."""
    waves, lengths = decode_wav_batch(paths[:clf.batch_size], clf.buffer_len,
                                      dtype=np.dtype(clf.wave_dtype))
    dw = torch.from_numpy(waves).to(clf.device)
    dl = torch.from_numpy(np.maximum(lengths, 1)).to(clf.device)
    return cuda_ms(lambda: clf._fn(dw, dl), 5)


def end_to_end(clf: AudioClassifier, paths: Sequence[str]):
    """Clips/s of one ``classify_paths`` over ``paths`` (host clock, the
    logits on the host), after one warm-up batch; returns ``(clips/s,
    labels)``."""
    clf.classify_paths(paths[:clf.batch_size])
    t0 = time.perf_counter()
    labels, _ = clf.classify_paths(paths)
    return len(paths) / (time.perf_counter() - t0), labels


def traced(clf: AudioClassifier, paths: Sequence[str]) -> Dict[str, float]:
    """One ``classify_paths`` under ``torch.profiler``: device ms a batch of
    the host-to-device copies, of the device-to-host copies and of the
    rest, and the device's idle share over the run."""
    per, idle = profile_device(lambda: clf.classify_paths(paths), 1)
    nb = -(-len(paths) // clf.batch_size)
    h2d = sum(v for k, v in per.items() if "Memcpy HtoD" in k)
    d2h = sum(v for k, v in per.items() if "Memcpy DtoH" in k)
    return {"h2d_ms": h2d / nb, "d2h_ms": d2h / nb,
            "compute_ms": (sum(per.values()) - h2d - d2h) / nb, "idle": idle}


def _percentiles(ms: List[float]) -> str:
    p50, p99 = np.percentile(ms, [50, 99])
    return f"p50 {p50:.3f} ms, p99 {p99:.3f} ms"


def latency(call: Callable[[list], object], items: Sequence, size: int,
            requests: int = LATENCY_REQUESTS) -> List[float]:
    """Host ms of ``call`` on ``requests`` requests of ``size`` items each
    (taken in turn, wrapping around), after two untimed requests."""
    n = len(items)
    out = []
    for r in range(requests + 2):
        req = [items[(r * size + j) % n] for j in range(size)]
        t0 = time.perf_counter()
        call(req)
        if r >= 2:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def measure(model: ST, paths: Sequence[str], batch: int,
            log: Callable[[str], None]) -> Dict[str, object]:
    """All the probe's numbers on ``paths``, each logged as a line; returns
    them (and the labels of each staging type's end-to-end run)."""
    res: Dict[str, object] = {}
    for dtype in ("int16", "float32"):
        rate, threads = decode_only(paths, batch, dtype)
        res[f"decode_{dtype}"] = rate
        log(f"decode only, {dtype} pinned slots: {len(paths)} files of 5 s at "
            f"batch {batch}, {threads} threads: {rate:.1f} clips/s")
    log(f"decode threads: {threads} (of {os.cpu_count()} host cores)")
    for t in THREAD_SWEEP:
        rate = decode_only(paths, batch, "int16", num_threads=t)[0]
        res[f"decode_int16_threads_{t}"] = rate
        log(f"decode only, int16 pinned slots, {t} threads: {rate:.1f} clips/s; "
            f"reading the files alone over {t} threads: "
            f"{read_only(paths, t):.1f} clips/s")
    for dtype in STAGING:
        clf = AudioClassifier(model=model, pipeline=CFG, batch_size=batch,
                              buffer_len=L, wave_dtype=dtype)
        try:
            rate, labels = end_to_end(clf, paths)
            res[f"e2e_{dtype}"], res[f"labels_{dtype}"] = rate, labels
            copy = h2d_ms(batch, dtype)
            comp = compute_ms(clf, paths)
            tr = traced(clf, paths)
        finally:
            clf.close()
        res[f"h2d_{dtype}"], res[f"compute_{dtype}"] = copy, comp
        res[f"traced_{dtype}"] = tr
        nbytes = batch * L * (2 if dtype == "int16" else 4)
        log(f"end to end with ingest, {dtype} staging: {len(paths)} clips at batch "
            f"{batch}: {rate:.1f} clips/s ({len(paths) / rate * 1e3:.1f} ms)")
        log(f"H2D, {dtype} staging: one batch's pinned slot ({nbytes / 1e6:.1f} MB) "
            f"on a copy stream {copy:.3f} ms = {nbytes / copy / 1e6:.1f} GB/s "
            f"(CUDA events); in the traced run {tr['h2d_ms']:.3f} ms a batch")
        log(f"compute, {dtype} staging: one batch of {batch} on the card "
            f"{comp:.3f} ms (CUDA events); in the traced run {tr['compute_ms']:.3f} "
            f"ms a batch of device time, D2H {tr['d2h_ms']:.4f} ms")
        log(f"device idle share over a traced classify_paths run, {dtype} staging: "
            f"{tr['idle']:.4f}")
    clips = decoded_clips(paths)
    for size in LATENCY_SIZES:
        for dtype in STAGING:
            clf = AudioClassifier(model=model, pipeline=CFG, batch_size=size,
                                  buffer_len=L, wave_dtype=dtype)
            try:
                ms = latency(clf.classify_paths, paths, size)
            finally:
                clf.close()
            res[f"latency_paths_{dtype}_{size}"] = ms
            log(f"request latency, classify_paths, {dtype} staging, {size} files "
                f"(bucket {size}), {len(ms)} requests: {_percentiles(ms)}")
        clf = AudioClassifier(model=model, pipeline=CFG, batch_size=size,
                              buffer_len=L)
        ms = latency(clf.logits, clips, size)
        res[f"latency_logits_{size}"] = ms
        log(f"request latency, logits on clips in memory, {size} clips (bucket "
            f"{size}), {len(ms)} requests: {_percentiles(ms)}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nclips", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir", default=None,
                    help="write the corpus here and keep it (default: a "
                         "temporary directory, removed after)")
    args = ap.parse_args(argv)
    resolve_device("cuda", cuda_only=True)
    name = card()
    work = args.dir or tempfile.mkdtemp(prefix="pcaudio_ingest_")
    try:
        t0 = time.perf_counter()
        paths = write_corpus(work, args.nclips)
        print(f"[ingest] corpus: {len(paths)} files ({DISTINCT} distinct clips) "
              f"written in {time.perf_counter() - t0:.1f} s", flush=True)
        measure(seeded_model(args.seed), paths, args.batch,
                lambda line: print(f"[ingest] {line} ({name})", flush=True))
    finally:
        if args.dir is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
