"""Build the port's CUDA kernels and bind them with ctypes.

All kernels live in ``pcaudio_torch/csrc/*.cu`` behind a plain C interface
(no PyTorch headers, so ``nvcc`` takes seconds, not minutes).  The first
call compiles them for Hopper (``sm_90a``), one ``nvcc`` per source, all
started together, and links them into one shared library under
``build/pcaudio_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds.  The compiler's output,
register and shared-memory counts included, is kept in ``build.log`` there.
Nothing here falls back: without ``nvcc``, or when the build fails, the
caller gets a ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pcaudio_torch"
SOURCES = ("featurize.cu", "select.cu", "fused_st.cu", "mha.cu", "probe_mma.cu",
           "probe_attend.cu", "probe_stream.cu", "probe_featurize.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as void*, counts as int
_SIGNATURES = {
    "pcaudio_trim_bounds": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
    "pcaudio_chunk_mag2": [_P, _P, _P, _I, _I, _I, _I, _P],
    "pcaudio_topk_chunks": [_P, _I, _P, _P, _I, _I, _I, _P],
    "pcaudio_fused_st": [_P, _I, _P, _P, _L, _P, _L, _P,
                         _I, _I, _I, _I, _I, _I, _P],
    "pcaudio_fused_st_max_points": [_I],
    "pcaudio_mha_fwd": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
    "pcaudio_mha_bwd": [_P] * 13 + [_I] * 7 + [ctypes.c_float, _P],
    "pcaudio_probe_matmul": [_P] * 5,
    "pcaudio_probe_chain": [_P, _P, _P] + [_I] * 5 + [_P],
    "pcaudio_probe_exp_chain": [_P, _P] + [_I] * 4 + [_P],
    "pcaudio_probe_attend": [_P] * 5 + [_I] * 5 + [_P],
    "pcaudio_probe_int16_gram": [_P, _P, _I, _I, _P],
    "pcaudio_probe_wave_sums": [_P, _P, _I, _I, _I, _P],
    "pcaudio_probe_relayout": [_P, _P] + [_I] * 5 + [_P],
    "pcaudio_probe_dft_mag2": [_P] * 4 + [_I] * 8 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "pcaudio_torch CUDA kernels cannot be built here")


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    srcs = [CSRC / name for name in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):  # sources and headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libpcaudio_torch_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    failed = [(src.name, p.returncode) for src, p in zip(srcs, procs)
              if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode))
    (BUILD_DIR / "build.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        bad = "".join(log for src, p, log in zip(srcs, procs, logs) if p.returncode)
        raise RuntimeError(f"nvcc failed ({failed}):\n{(bad or logs[-1])[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pcaudio_error_string.argtypes = [ctypes.c_int]
    lib.pcaudio_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call the C entry point ``name``; raise if it reports an error (a
    refused launch never runs, and a later synchronize would not say so)."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        raise RuntimeError(
            f"{name}: {lib.pcaudio_error_string(code).decode()} ({code})")


def stream_of(t) -> int:
    """The current CUDA stream on ``t``'s device, as an int for ctypes.
    The raw query: building a ``torch.cuda.Stream`` (``current_stream``)
    costs several µs of host time on every launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
