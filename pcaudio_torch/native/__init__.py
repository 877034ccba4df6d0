"""ctypes bindings of the port's native WAV loader (``wav_loader.cpp``), the
counterpart of ``pcaudio/native``.

The first call builds the library with g++ into ``build/pcaudio_torch/native/``
at the repository root, named by a hash of the compiler, its flags and the
source, so an edited source rebuilds; the compiler's output is kept in a
``.log`` beside it.  The library is written under a temporary name and moved
into place, so processes that build at once never load a half-written file.
A failed build raises ``RuntimeError`` with the compiler's message;
:func:`available` says whether the library builds.

  decode_wav_batch   threaded decode of many WAVs into one padded batch
  PrefetchingLoader  a ring of slot buffers (pinned on request) that a C++
                     thread pool fills ahead of consumption
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

SOURCE = Path(__file__).resolve().with_name("wav_loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pcaudio_torch" / "native"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {  # name: (argtypes, restype)
    "pcaudio_decode_wav": ([ctypes.c_char_p, _P, _L], _I),
    "pcaudio_decode_wav_batch": (
        [ctypes.POINTER(ctypes.c_char_p), _I, _P, _P, _L, _I], _I),
    "pcaudio_decode_wav_batch_i16": (
        [ctypes.POINTER(ctypes.c_char_p), _I, _P, _P, _L, _I], _I),
    "pcaudio_prefetch_create": (
        [_L, _I, _I, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_P)], _P),
    "pcaudio_prefetch_submit": ([_P, ctypes.POINTER(ctypes.c_char_p), _I], _I),
    "pcaudio_prefetch_acquire": ([_P, ctypes.POINTER(_I)], _I),
    "pcaudio_prefetch_release": ([_P], _I),
    "pcaudio_prefetch_destroy": ([_P], None),
}
# staging types: numpy / torch / name → (torch dtype, the ring's fmt code)
_STAGING = {"float32": (torch.float32, 0), "int16": (torch.int16, 1)}

_lock = threading.Lock()
_loaded: Dict[Path, Union[ctypes.CDLL, RuntimeError]] = {}


def _target() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return Path(BUILD_DIR) / f"libpcaudio_torch_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists; return its path.
    Raises ``RuntimeError`` when the compiler cannot run or fails."""
    lib = _target()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = lib.with_name(f"{lib.name}.{tag}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native WAV loader cannot be built: {CXX!r} "
                           f"did not run ({e})") from e
    log = lib.with_suffix(".log")
    log_tmp = log.with_name(f"{log.name}.{tag}.tmp")
    log_tmp.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(log_tmp, log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native WAV loader cannot be built: {CXX} "
                           f"failed ({proc.returncode}) on {SOURCE.name}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The built library, loaded once per build; raises ``RuntimeError``
    (the same one again on later calls) when it cannot be built."""
    with _lock:
        key = _target()
        if key not in _loaded:
            try:
                lib = ctypes.CDLL(str(build()))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                _loaded[key] = lib
            except OSError as e:
                _loaded[key] = RuntimeError(f"the native WAV loader does not "
                                            f"load: {e}")
            except RuntimeError as e:
                _loaded[key] = e
        got = _loaded[key]
    if isinstance(got, RuntimeError):
        raise got
    return got


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def _staging(dtype) -> Tuple[str, torch.dtype, int]:
    name = str(dtype).removeprefix("torch.")
    if isinstance(dtype, type) and issubclass(dtype, np.generic):
        name = np.dtype(dtype).name
    if name not in _STAGING:
        raise ValueError(f"staging dtype must be float32 or int16, not {dtype!r}")
    return (name, *_STAGING[name])


def _default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def _paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def decode_wav_batch(paths: Sequence[str], buffer_len: int,
                     num_threads: Optional[int] = None, dtype=np.float32,
                     out: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded decode of many WAVs into a zero-padded ``[n, buffer_len]``
    batch and ``[n]`` int32 lengths, as numpy arrays.  ``dtype=np.int16``
    stages raw PCM16 (bit-exact for 16-bit sources, round-clamped for wider
    or float ones); ``out`` reuses a C-contiguous ``[n, buffer_len]`` array
    of that type.  Raises ``RuntimeError`` on a decode failure (the first
    failing file's negative code, in path order) or when the library does
    not build."""
    lib = load_library()
    name, _, fmt = _staging(dtype)
    n = len(paths)
    if out is None:
        out = np.empty((n, buffer_len), name)
    elif (out.shape != (n, buffer_len) or out.dtype != np.dtype(name)
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous {name} array of shape "
                         f"{(n, buffer_len)}, not {out.dtype} {out.shape}")
    lengths = np.zeros((n,), np.int32)
    decode = (lib.pcaudio_decode_wav_batch_i16 if fmt
              else lib.pcaudio_decode_wav_batch)
    rc = decode(_paths(paths), n, out.ctypes.data, lengths.ctypes.data,
                buffer_len, num_threads or _default_threads())
    if rc != 0:
        raise RuntimeError(f"native WAV decode failed with code {rc}")
    return out, lengths


class PrefetchingLoader:
    """A C++ thread pool decodes submitted batches into a ring of ``depth``
    slots ahead of consumption, so host decode of upcoming batches overlaps
    the card's work.  The slots are CPU tensors that this object owns
    (``waves[i]`` ``[batch, buffer_len]`` of the staging type, ``lengths[i]``
    ``[batch]`` int32), page-locked with ``pin_memory=True`` so that a slot
    feeds a non-blocking host-to-device copy directly.  A slot's rows past
    the batch's file count are zero with length 0.

        with PrefetchingLoader(L, batch=64, depth=3) as pf:
            for group in groups[:3]:
                pf.submit(group)
            waves, lengths, n = pf.acquire()   # views of the slot
            ...                                 # consume them, then
            pf.release()                        # the oldest acquired slot

    A caller may hold up to ``depth`` slots at once and releases them in the
    order it acquired them; a released slot's views are overwritten by a
    later batch.  ``next()`` releases the slot it returned last and
    acquires the next.
    """

    def __init__(self, buffer_len: int, batch: int, depth: int = 3,
                 num_threads: Optional[int] = None, dtype=np.float32,
                 pin_memory: bool = False):
        lib = load_library()
        _, tdt, fmt = _staging(dtype)
        if buffer_len <= 0 or batch <= 0 or depth <= 0:
            raise ValueError("buffer_len, batch and depth must be positive")
        self.buffer_len, self.batch, self.depth = buffer_len, batch, depth
        self.dtype = tdt
        self.num_threads = num_threads or _default_threads()
        self.waves: List[torch.Tensor] = [
            torch.empty((batch, buffer_len), dtype=tdt, pin_memory=pin_memory)
            for _ in range(depth)]
        self.lengths: List[torch.Tensor] = [
            torch.empty((batch,), dtype=torch.int32, pin_memory=pin_memory)
            for _ in range(depth)]
        wp = (_P * depth)(*[w.data_ptr() for w in self.waves])
        lp = (_P * depth)(*[x.data_ptr() for x in self.lengths])
        self._lib = lib
        self._h = lib.pcaudio_prefetch_create(buffer_len, batch, depth,
                                              self.num_threads, fmt, wp, lp)
        if not self._h:
            raise RuntimeError("prefetcher creation failed")
        self._submitted = 0    # submitted, not yet acquired
        self._outstanding = 0  # acquired, not yet released

    def _handle(self):
        if not self._h:
            raise RuntimeError("the PrefetchingLoader is closed")
        return self._h

    def submit(self, paths: Sequence[str]) -> None:
        """Queue one batch of at most ``batch`` files."""
        if len(paths) > self.batch:
            raise ValueError(f"{len(paths)} paths exceed the batch of {self.batch}")
        rc = self._lib.pcaudio_prefetch_submit(self._handle(), _paths(paths),
                                               len(paths))
        if rc != 0:
            raise RuntimeError(f"prefetch submit failed: {rc}")
        self._submitted += 1

    def acquire(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Block until the oldest submitted batch is decoded; return
        ``(waves [batch, L], lengths [batch], n)``, views of its slot, which
        stays held until :meth:`release`.  A decode error releases the slot
        and raises ``RuntimeError``."""
        h = self._handle()
        if self._outstanding >= self.depth:
            raise RuntimeError(f"all {self.depth} slots are held: release one "
                               f"before acquiring")
        if not self._submitted:
            raise RuntimeError("acquire with no batch submitted")
        slot = ctypes.c_int(-1)
        rc = self._lib.pcaudio_prefetch_acquire(h, ctypes.byref(slot))
        self._submitted -= 1
        self._outstanding += 1
        if rc < 0:
            self.release()
            raise RuntimeError(f"prefetch decode failed: {rc}")
        return self.waves[slot.value], self.lengths[slot.value], rc

    def release(self) -> None:
        """Release the oldest acquired slot (its views die)."""
        if self._outstanding and self._h:
            self._lib.pcaudio_prefetch_release(self._h)
            self._outstanding -= 1

    def next(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Release the slot returned last, then :meth:`acquire`."""
        if self._outstanding:
            self.release()
        return self.acquire()

    def close(self) -> None:
        """Stop the pool; the slots are freed with this object.  Safe to
        call twice."""
        if self._h:
            self._lib.pcaudio_prefetch_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
