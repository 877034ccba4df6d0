"""Build the port's CUDA libraries and bind them with ctypes.

Every kernel lives in ``pcaudio_torch/csrc/*.cu`` behind a plain C interface
(no PyTorch headers, so ``nvcc`` takes seconds, not minutes).  :func:`build`
is the one place that runs ``nvcc``: it compiles a library's sources for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, links
them into one shared library under ``build/pcaudio_torch/`` at the
repository root, named by the library's name and a hash of its flags, its
sources and ``csrc/*.cuh``, so an edited source rebuilds the libraries that
hold it and no other.  The compiler's output, register, shared-memory and
spill counts included, is kept in ``<name>.build.log`` there, ending with
each source's seconds.  Nothing here falls back: without ``nvcc``, or when
the build fails, the caller gets a ``RuntimeError``.

This module's own library, :func:`library`, holds the serving, sweep and
training path's kernels; :func:`launch` calls its entry points.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Mapping, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pcaudio_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a source's options beside NVCC_FLAGS, wherever it is built: K1's two
# forms, four instantiations of the whole ST each, are the longest
# compiles, so their kernels are compiled on as many threads as the host
# has (the same SASS)
SOURCE_FLAGS = {"fused_st.cu": ("--split-compile=0",),
                "fused_st_scratch.cu": ("--split-compile=0",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def entry(*argtypes):
    """The C prototype of an entry point that returns a CUDA error code:
    every pointer and the stream as void*, counts as int."""
    return ctypes.CFUNCTYPE(_I, *argtypes)


# csrc/error.cu, which every library that :func:`launch_in` calls into
# compiles: the text of a code an entry point returned
ERROR_SOURCE = "error.cu"
ERROR_SIGNATURE = {"pcaudio_error_string": ctypes.CFUNCTYPE(ctypes.c_char_p, _I)}

NAME = "pcaudio_torch"
SOURCES = dict.fromkeys((ERROR_SOURCE, "featurize.cu", "select.cu", "approx_select.cu",
                         "fused_st.cu", "fused_st_scratch.cu", "mha.cu", "attn.cu"))
SIGNATURES = {
    **ERROR_SIGNATURE,
    "pcaudio_trim_bounds": entry(_P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
    "pcaudio_chunk_mag2": entry(_P, _P, _P, _I, _I, _I, _I, _P),
    "pcaudio_topk_chunks": entry(_P, _I, _P, _P, _I, _I, _I, _P),
    "pcaudio_approx_topk": entry(_P, _I, _P, _P, _I, _I, _I, _I, _I, _P),
    "pcaudio_fused_st": entry(_P, _I, _P, _P, _P, _L, _P, _L, _P,
                              _I, _I, _I, _I, _I, _I, _P),
    "pcaudio_fused_st_max_points": entry(_I),
    "pcaudio_fused_st_scratch": entry(_P, _I, _P, _P, _P, _L, _P, _L, _P,
                                      _I, _I, _I, _I, _I, _I, _P, _L, _P),
    "pcaudio_fused_st_scratch_max_points": entry(_I),
    "pcaudio_fused_st_scratch_blocks": entry(_I, _I, _I, ctypes.POINTER(_I)),
    "pcaudio_mha_fwd": entry(*[_P] * 9, *[_I] * 8, ctypes.c_float, _P),
    "pcaudio_mha_bwd": entry(*[_P] * 13, *[_I] * 7, ctypes.c_float, _P),
    "pcaudio_attn_fwd": entry(_P, _P, _I, _I, _I, ctypes.c_float, _P),
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


def library_path(name: str, sources: Mapping[str, Optional[str]],
                 source_flags: Mapping[str, tuple] = SOURCE_FLAGS) -> Path:
    """Where :func:`build` puts the library ``name`` of ``sources``: named by
    a hash of the flags of its sources, its sources and ``csrc/*.cuh``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted((n, f) for n, f in source_flags.items() if n in sources)).encode())
    for n, text in sorted(sources.items()):
        h.update(f"\0{n}\0".encode())
        h.update((CSRC / n).read_bytes() if text is None else text.encode())
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(f"\0csrc/{p.name}\0".encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output of the last build of the library ``name``."""
    return BUILD_DIR / f"{name}.build.log"


def build(name: str, sources: Mapping[str, Optional[str]], signatures: Mapping,
          source_flags: Mapping[str, tuple] = SOURCE_FLAGS) -> ctypes.CDLL:
    """The library ``name`` of ``sources``, built unless this exact build
    exists, with each entry point of ``signatures`` ({name: ctypes
    prototype}) bound to its prototype.

    ``sources`` maps a file name to its text, or to None for the file of
    that name in ``csrc/``.  Its ``.cu`` files are compiled (with
    ``source_flags`` by file name); its other files are headers.  Files
    given as text are written to the library's own directory under
    ``build/`` and compiled there; the others compile in place.  Either
    way ``-I csrc`` finds a header not handed in, and a quoted
    ``#include`` looks first beside the file that includes it: a caller
    that edits a header also hands in every file that includes it."""
    lib = library_path(name, sources, source_flags)
    if not lib.is_file():
        _compile(name, sources, source_flags, lib)
    dll = ctypes.CDLL(str(lib))
    for fn, proto in signatures.items():
        setattr(dll, fn, proto((fn, dll)))
    return dll


def _compile(name, sources, source_flags, lib: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    written = {n: t for n, t in sources.items() if t is not None}
    here = BUILD_DIR / lib.stem[len("lib"):]
    if written:
        here.mkdir(exist_ok=True)
        for n, text in written.items():
            (here / n).write_text(text)
    srcs = [(here if n in written else CSRC) / n for n in sources if n.endswith(".cu")]
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *source_flags.get(src.name, ()),
                               "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]

    def finish(p):  # its output, and the seconds to its end
        return p.communicate()[0], time.perf_counter() - t0
    with ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(finish, procs))
    logs = [out for out, _ in done]
    logs.append("".join(f"[nvcc] {src.name}: {s:.1f} s\n"
                        for src, (_, s) in zip(srcs, done)))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    failed = [(src.name, p.returncode) for src, p in zip(srcs, procs)
              if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode))
    log_path(name).write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        bad = "".join(log for p, log in zip(procs, logs) if p.returncode)
        raise RuntimeError(f"nvcc failed for {name} ({failed}):\n"
                           f"{(bad or logs[-1])[-4000:]}")
    os.replace(tmp, lib)


def ptxas_lines(name: str, kernel: str = "") -> list:
    """ptxas' lines for every kernel of the library ``name`` whose mangled
    name holds ``kernel`` (such as ``12chain_kernel``, which
    ``exp_chain_kernel`` lacks), from its last build's log: ``entry
    <mangled name>``, then its registers, spills and C75xx notes."""
    lines, current = [], False
    for line in log_path(name).read_text().splitlines():
        if "Compiling entry function" in line:
            current = kernel in line
            if current:
                lines.append(f"entry {line.split(chr(39))[1][:100]}")
        elif current and ("registers" in line or "spill" in line or "C75" in line):
            lines.append(line.strip()[:160])
    return lines


@functools.cache
def library() -> ctypes.CDLL:
    """The path's kernels, built and loaded once per process."""
    return build(NAME, SOURCES, SIGNATURES)


def launch_in(lib: ctypes.CDLL, name: str, *args) -> None:
    """Call the C entry point ``name`` of ``lib``; raise if it reports an
    error (a refused launch never runs, and a later synchronize would not
    say so)."""
    code = getattr(lib, name)(*args)
    if code != 0:
        raise RuntimeError(
            f"{name}: {lib.pcaudio_error_string(code).decode()} ({code})")


def launch(name: str, *args) -> None:
    """Call the path library's entry point ``name``; raise on an error."""
    launch_in(library(), name, *args)


def stream_of(t) -> int:
    """The current CUDA stream on ``t``'s device, as an int for ctypes.
    The raw query: building a ``torch.cuda.Stream`` (``current_stream``)
    costs several µs of host time on every launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
