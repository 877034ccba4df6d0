"""The port's native WAV loader (``pcaudio_torch/native``) == the JAX
package's (``pcaudio.native``) and its Python decoder, exactly: the same
samples, lengths and error codes in f32 and int16 staging; and the ring
loader's contract (order, held slots, no stale samples in a reused slot,
errors) and the build's (a failed build raises and never falls back).

Tests that build a native library need g++ and skip without it; the Python
decoder's parity and the failed-build policy run everywhere."""
import ctypes
import os
import shutil
import struct
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from pcaudio import native as jax_native
from pcaudio.data import audio_io as jax_audio_io
from pcaudio_torch import native
from pcaudio_torch.data import audio_io

FS = 44100
# sample encoders: name → (WAVE format tag, bits, encode(x) -> bytes)
FORMATS = {
    "pcm8": (1, 8, lambda x: (x * 127 + 128).astype(np.uint8).tobytes()),
    "pcm16": (1, 16, lambda x: (x * 32767).astype("<i2").tobytes()),
    "pcm24": (1, 24, lambda x: _pcm24((x * 8388000).astype(np.int32))),
    "pcm32": (1, 32, lambda x: (x * 2147483000).astype("<i4").tobytes()),
    "float32": (3, 32, lambda x: x.astype("<f4").tobytes()),
}


def _pcm24(v):
    b = np.zeros((len(v), 3), np.uint8)
    b[:, 0], b[:, 1], b[:, 2] = v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF
    return b.tobytes()


def write_wav(path, x, fmt="pcm16", extra=(), fmt_tag=None, fmt_size=16):
    """A RIFF/WAVE file of ``x`` ([n] mono or [n, ch] interleaved), with
    ``extra`` (id, body) chunks before ``data`` (odd bodies padded)."""
    x = np.asarray(x, np.float32)
    x2 = x if x.ndim == 2 else x[:, None]
    tag, bits, enc = FORMATS[fmt]
    ch = x2.shape[1]
    block = ch * bits // 8
    fmt_body = struct.pack("<HHIIHH", fmt_tag or tag, ch, FS, FS * block,
                           block, bits) + b"\0" * (fmt_size - 16)
    body = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    for cid, data in extra:
        body += cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) % 2)
    pcm = enc(x2.reshape(-1))
    body += b"data" + struct.pack("<I", len(pcm)) + pcm
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    return str(path)


def _signal(n, ch, seed, peak=0.8):
    rng = np.random.default_rng(seed)
    x = (peak * rng.uniform(-1, 1, (n, ch))).astype(np.float32)
    return x if ch > 1 else x[:, 0]


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the native WAV loader cannot be built")


@pytest.fixture
def jax_lib(gxx):
    """The JAX package's library.  Its build writes the library in place,
    so a worker that loads it while another writes it sees a broken file
    once: retry after the writer is done."""
    for _ in range(5):
        if jax_native.load_library() is not None:
            return jax_native
        time.sleep(2.0)
        jax_native._tried = False
    pytest.fail("the JAX package's native library does not build")


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """The port's build pointed at a compiler that does not exist."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    return tmp_path / "build"


# ---- the Python decoder (no g++ needed) -------------------------------------

@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("fmt", ["pcm8", "pcm16", "pcm24", "pcm32"])
def test_python_decoder_matches_jax(tmp_path, fmt, ch):
    x = _signal(3001, ch, seed=len(fmt) + ch)
    path = write_wav(tmp_path / "a.wav", x, fmt)
    got, sr = audio_io.load_wav(path)
    ref, rsr = jax_audio_io.load_wav(path)
    assert sr == rsr == FS and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["auto", "never", "always"])
def test_load_wav_batch_policy_when_the_build_fails(tmp_path, broken_build, mode):
    """"auto" and "never" decode in Python (== the JAX package's Python
    path); "always" raises instead of falling back."""
    paths = [write_wav(tmp_path / f"c{i}.wav", _signal(900 + 700 * i, 1, i))
             for i in range(3)]
    if mode == "always":
        with pytest.raises(RuntimeError, match="native"):
            audio_io.load_wav_batch(paths, 2048, use_native=mode)
        return
    got = audio_io.load_wav_batch(paths, 2048, use_native=mode)
    ref = jax_audio_io.load_wav_batch(paths, 2048, use_native="never")
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_failed_build_raises_and_never_falls_back(tmp_path, broken_build):
    path = write_wav(tmp_path / "a.wav", _signal(100, 1, 0))
    assert not native.available()
    for _ in range(2):  # the failure is kept, not retried silently
        with pytest.raises(RuntimeError, match="cannot be built"):
            native.decode_wav_batch([path], 256)
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.PrefetchingLoader(256, batch=2, depth=2)
    assert not list(broken_build.glob("*.so"))


# ---- the native decoder against the JAX package's ------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_native_decoder_matches_jax(tmp_path, gxx, jax_lib, fmt, ch, dtype):
    """Every format, mono and stereo (channels averaged), f32 and int16
    staging: the same bits as the JAX decoder; in f32, PCM also equals the
    Python decoder."""
    x = _signal(2500, ch, seed=7 * ch + len(fmt))
    path = write_wav(tmp_path / "a.wav", x, fmt)
    got, glen = native.decode_wav_batch([path, path], 4096, dtype=dtype)
    ref, rlen = jax_native.decode_wav_batch([path, path], 4096, dtype=dtype)
    assert got.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(glen, rlen)
    np.testing.assert_array_equal(got, ref)
    assert glen[0] == 2500 and not got[:, 2500:].any()
    if dtype == np.float32 and fmt != "float32":
        np.testing.assert_array_equal(got[0, :2500], jax_audio_io.load_wav(path)[0])


@pytest.mark.parametrize("case", ["list_chunk", "odd_chunk", "extensible",
                                  "long_fmt", "longer_than_buffer",
                                  "shorter_than_buffer"])
def test_native_decoder_layouts_match_jax(tmp_path, gxx, jax_lib, case):
    """A LIST chunk before data, an odd-sized chunk (padded), the
    extensible format tag, an 18-byte fmt chunk; a clip longer than the
    buffer (truncated) and one shorter (zero tail)."""
    n = {"longer_than_buffer": 5000, "shorter_than_buffer": 10}.get(case, 3000)
    x = _signal(n, 2 if case == "extensible" else 1, seed=3)
    extra = {"list_chunk": [(b"LIST", b"INFOISFT" + struct.pack("<I", 6) + b"test\0\0")],
             "odd_chunk": [(b"junk", b"abc"), (b"fact", b"\x01\x02\x03\x04")]}
    path = write_wav(tmp_path / "a.wav", x, "pcm16", extra=extra.get(case, ()),
                     fmt_tag=0xFFFE if case == "extensible" else None,
                     fmt_size=18 if case == "long_fmt" else 16)
    for dtype in (np.float32, np.int16):
        got, glen = native.decode_wav_batch([path], 4096, dtype=dtype)
        ref, rlen = jax_native.decode_wav_batch([path], 4096, dtype=dtype)
        np.testing.assert_array_equal(glen, rlen)
        np.testing.assert_array_equal(got, ref)
        assert glen[0] == min(n, 4096) and not got[0, glen[0]:].any()
    if case != "extensible":  # the wave module refuses a bare 0xFFFE tag
        np.testing.assert_array_equal(
            native.decode_wav_batch([path], 4096)[0][0, :min(n, 4096)],
            jax_audio_io.load_wav(path)[0][:4096])


def test_int16_round_clamp_of_a_float_wav(tmp_path, gxx, jax_lib):
    """int16 staging of float samples: x·32768 rounded half away from zero
    and clamped to [-32768, 32767], as the JAX decoder does it."""
    x = np.array([0.0, 0.5 / 32768, -0.5 / 32768, 1.5 / 32768, 0.25, -0.25,
                  0.99999, 1.0, 1.3, -1.0, -1.3, 3e-5], np.float32)
    path = write_wav(tmp_path / "f.wav", x, "float32")
    got, _ = native.decode_wav_batch([path], 16, dtype=np.int16)
    ref, _ = jax_native.decode_wav_batch([path], 16, dtype=np.int16)
    np.testing.assert_array_equal(got, ref)
    v = x * np.float32(32768)
    want = np.clip(np.sign(v) * np.floor(np.abs(v) + 0.5), -32768, 32767)
    np.testing.assert_array_equal(got[0, :len(x)], want.astype(np.int16))


@pytest.mark.parametrize("case", ["missing", "not_riff", "data_before_fmt",
                                  "truncated_data", "bad_width"])
def test_error_codes_match_jax(tmp_path, gxx, jax_lib, case):
    path = str(tmp_path / "bad.wav")
    good = write_wav(tmp_path / "good.wav", _signal(300, 1, 1))
    raw = open(good, "rb").read()
    if case == "not_riff":
        open(path, "wb").write(b"RIFX" + raw[4:])
    elif case == "data_before_fmt":
        data = raw[36:]
        open(path, "wb").write(raw[:12] + data + raw[12:36])
    elif case == "truncated_data":
        open(path, "wb").write(raw[:-100])
    elif case == "bad_width":
        open(path, "wb").write(raw[:34] + struct.pack("<H", 12) + raw[36:])
    codes = []
    for mod in (native, jax_native):
        for dtype in (np.float32, np.int16):
            with pytest.raises(RuntimeError, match="code -") as e:
                mod.decode_wav_batch([good, path], 512, dtype=dtype)
            codes.append(str(e.value).split("code ")[-1])
    assert len(set(codes)) == 1, codes
    lib = native.load_library()
    buf = np.zeros(512, np.float32)
    rc = lib.pcaudio_decode_wav(path.encode(), buf.ctypes.data, 512)
    assert rc == jax_native.load_library().pcaudio_decode_wav(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 512)
    assert str(rc) == codes[0]


# ---- the ring loader --------------------------------------------------------

def _groups(tmp_path, sizes, seed=0):
    return [[write_wav(tmp_path / f"g{g}_{i}.wav", _signal(n, 1, seed + 10 * g + i))
             for i, n in enumerate(group)] for g, group in enumerate(sizes)]


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_ring_returns_batches_in_submission_order(tmp_path, gxx, dtype):
    groups = _groups(tmp_path, [[400 + 50 * g + 10 * i for i in range(3)]
                                for g in range(7)])
    with native.PrefetchingLoader(1024, batch=3, depth=2, num_threads=3,
                                  dtype=dtype) as pf:
        for g in groups[:2]:
            pf.submit(g)
        for g, paths in enumerate(groups):
            waves, lengths, n = pf.next()
            ref, rlen = native.decode_wav_batch(paths, 1024, dtype=dtype)
            assert n == 3 and waves.numpy().dtype == ref.dtype
            np.testing.assert_array_equal(lengths.numpy(), rlen)
            np.testing.assert_array_equal(waves.numpy(), ref)
            if g + 2 < len(groups):
                pf.submit(groups[g + 2])


def test_ring_holds_several_slots_and_releases_in_order(tmp_path, gxx):
    groups = _groups(tmp_path, [[300 + 100 * g] * 2 for g in range(6)], seed=5)
    with native.PrefetchingLoader(1024, batch=2, depth=3, num_threads=2) as pf:
        for g in groups[:3]:
            pf.submit(g)
        held = [pf.acquire() for _ in range(3)]
        with pytest.raises(RuntimeError, match="slots are held"):
            pf.acquire()
        ptrs = {w.data_ptr() for w, _, _ in held}
        assert len(ptrs) == 3  # three distinct slots
        for g, (waves, lengths, n) in enumerate(held):  # all still intact
            np.testing.assert_array_equal(
                waves.numpy(), native.decode_wav_batch(groups[g], 1024)[0])
        for k in range(3):
            pf.release()  # the oldest: group k's slot becomes free again
            pf.submit(groups[3 + k])
            waves, lengths, n = pf.acquire()
            assert waves.data_ptr() == held[k][0].data_ptr()
            np.testing.assert_array_equal(
                waves.numpy(), native.decode_wav_batch(groups[3 + k], 1024)[0])
        for _ in range(3):
            pf.release()
        with pytest.raises(RuntimeError, match="no batch submitted"):
            pf.acquire()


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_reused_slot_carries_nothing_of_the_batch_before(tmp_path, gxx, dtype):
    """A full batch of long clips, then, in the same slot, two short clips:
    zeros past each clip's length and in the rows past n, lengths 0 there."""
    long_ = _groups(tmp_path, [[2000] * 4], seed=1)[0]
    short = [write_wav(tmp_path / f"s{i}.wav", _signal(100 + 50 * i, 1, 9 + i))
             for i in range(2)]
    with native.PrefetchingLoader(2048, batch=4, depth=1, num_threads=2,
                                  dtype=dtype) as pf:
        pf.submit(long_)
        waves, lengths, n = pf.next()
        assert n == 4 and (lengths.numpy() == 2000).all() and waves[:, 1999].any()
        pf.submit(short)
        waves2, lengths2, n2 = pf.next()
        assert waves2.data_ptr() == waves.data_ptr() and n2 == 2
        np.testing.assert_array_equal(lengths2.numpy(), [100, 150, 0, 0])
        ref, _ = native.decode_wav_batch(short, 2048, dtype=dtype)
        np.testing.assert_array_equal(waves2[:2].numpy(), ref)
        assert not waves2[2:].any() and not waves2[0, 100:].any()


def test_ring_decode_error_raises_and_close_twice(tmp_path, gxx):
    good = _groups(tmp_path, [[500, 600]])[0]
    pf = native.PrefetchingLoader(1024, batch=2, depth=2, num_threads=2)
    pf.submit([good[0], str(tmp_path / "missing.wav")])
    pf.submit(good)
    with pytest.raises(RuntimeError, match="decode failed: -1"):
        pf.acquire()
    waves, lengths, n = pf.acquire()  # the failed slot was released
    assert n == 2 and lengths.tolist() == [500, 600]
    pf.release()
    pf.close()
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf.submit(good)


# ---- the build ---------------------------------------------------------------

def test_concurrent_builds_never_load_a_half_written_library(tmp_path, gxx):
    """Four processes build into one empty directory at once: each loads a
    whole library, and only the finished library and its log are left."""
    code = textwrap.dedent(f"""
        from pathlib import Path
        from pcaudio_torch import native
        native.BUILD_DIR = Path({str(tmp_path / "b")!r})
        lib = native.load_library()
        print(native.build(), bool(lib.pcaudio_decode_wav))
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    assert len({o.split()[0] for o, _ in outs}) == 1
    assert all(o.split()[1] == "True" for o, _ in outs)
    left = sorted(os.listdir(tmp_path / "b"))
    assert len(left) == 2 and left[0].endswith(".log") and left[1].endswith(".so"), left


def test_compiler_error_is_reported(tmp_path, monkeypatch, gxx):
    bad = tmp_path / "wav_loader.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="cannot be built") as e:
        native.build()
    assert "wav_loader.cpp" in str(e.value) and "error" in str(e.value)
    logs = list((tmp_path / "build").glob("*.log"))
    assert len(logs) == 1 and "error" in logs[0].read_text()
    assert not list((tmp_path / "build").glob("*.so*"))
