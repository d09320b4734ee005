"""The port's WAV decoder (seld_tpu_torch.data.audio, a RIFF chunk walk in
numpy) against the JAX package's native one (seld_tpu/native/seldio.cpp,
through seld_tpu.native.decode_wav) and its load_wav, bit for bit: PCM
8/16/24/32, IEEE float32/64, EXTENSIBLE wrapping PCM16/24 and float32,
unknown chunks of odd size before and after fmt; each file the native
decoder refuses raises in the port with the fault named; and the files
JAX's `wave` fallback decodes where the port raises (ROADMAP §3)."""

import logging
import struct

import numpy as np
import pytest

from seld_tpu import native
from seld_tpu.data.audio import load_wav as jax_load_wav
from seld_tpu_torch.data.audio import decode_wav, load_wav, write_wav

PCM, FLOAT = 1, 3
# the KSDATAFORMAT_SUBTYPE GUID's tail, after its first two bytes (the format)
GUID_TAIL = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"


def fmt_chunk(fmt, channels, sr, bits, extensible=False):
    width = (bits + 7) // 8
    body = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt, channels, sr,
                       sr * channels * width, channels * width, bits)
    if extensible:
        body += struct.pack("<HHIH", 22, bits, 0, fmt) + GUID_TAIL
    return chunk(b"fmt ", body)


def chunk(tag, body):
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def riff(*chunks):
    body = b"WAVE" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def samples(bits, fmt, n, channels, seed=0) -> bytes:
    """Interleaved sample bytes, the extremes of the type included."""
    rng = np.random.default_rng(seed)
    if fmt == FLOAT:
        dt = "<f4" if bits == 32 else "<f8"
        x = rng.standard_normal(n * channels).astype(dt)
        x[:3] = (-1.0, 1.0, 0.0)
        return x.tobytes()
    if bits == 24:
        b = rng.integers(0, 256, n * channels * 3, dtype=np.uint8)
        b[:6] = (0, 0, 0x80, 0xFF, 0xFF, 0x7F)  # -2^23, 2^23 - 1
        return b.tobytes()
    dt = {8: np.uint8, 16: np.dtype("<i2"), 32: np.dtype("<i4")}[bits]
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n * channels, dtype=dt, endpoint=True)
    x[:2] = (info.min, info.max)
    return x.tobytes()


FORMATS = {  # name: (format, bits, extensible)
    "pcm8": (PCM, 8, False), "pcm16": (PCM, 16, False), "pcm24": (PCM, 24, False),
    "pcm32": (PCM, 32, False), "float32": (FLOAT, 32, False), "float64": (FLOAT, 64, False),
    "ext_pcm16": (PCM, 16, True), "ext_pcm24": (PCM, 24, True), "ext_float32": (FLOAT, 32, True),
}


def _same_as_jax(path, channels):
    got, sr = decode_wav(path)
    want, want_sr = native.decode_wav(path)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    assert got.shape == want.shape and got.shape[0] == channels and sr == want_sr
    np.testing.assert_array_equal(got, want)
    jax_wave, jax_sr = jax_load_wav(path, expected_channels=channels)
    np.testing.assert_array_equal(load_wav(path, expected_channels=channels)[0], jax_wave)
    assert jax_sr == sr
    return got


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_each_format_bit_equal_to_the_native_decoder(tmp_path, name):
    fmt, bits, ext = FORMATS[name]
    data = samples(bits, fmt, 257, 4)
    path = tmp_path / f"{name}.wav"
    path.write_bytes(riff(fmt_chunk(fmt, 4, 24_000, bits, ext), chunk(b"data", data)))
    got = _same_as_jax(path, 4)
    assert got.shape == (4, 257) and np.abs(got).max() > 0.5
    if fmt == PCM:
        assert got.min() >= -1.0 and got.max() <= 1.0


def test_unknown_chunks_of_odd_size_are_skipped_word_aligned(tmp_path):
    """A LIST chunk of odd size before fmt, a 'fact' chunk between fmt and
    data, an odd-sized data chunk (3 channels of 8-bit samples), and a
    trailing partial frame dropped as seldio drops it."""
    data = samples(8, PCM, 33, 3) + b"\x01"  # 100 bytes: 33 frames and a partial one
    path = tmp_path / "chunks.wav"
    path.write_bytes(riff(chunk(b"LIST", b"INFOISFT\x05\x00\x00\x00abcde"),
                          fmt_chunk(PCM, 3, 48_000, 8), chunk(b"fact", b"\x21\x00\x00\x00\x07"),
                          chunk(b"data", data[:-1] + b"\x80"),
                          chunk(b"junk", b"xyz")))
    got = _same_as_jax(path, 3)
    assert got.shape == (3, 33)
    odd = tmp_path / "odd.wav"
    odd.write_bytes(riff(fmt_chunk(PCM, 1, 8_000, 8), chunk(b"data", data[:99])))
    assert _same_as_jax(odd, 1).shape == (1, 99)


def test_write_wav_round_trip_and_the_channel_warning(tmp_path, caplog):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 500)).astype(np.float32)
    write_wav(tmp_path / "w.wav", x, 16_000)
    with caplog.at_level(logging.WARNING, logger="seld_tpu_torch"):
        got, sr = load_wav(tmp_path / "w.wav")
    assert sr == 16_000 and np.abs(got - x).max() < 1e-4
    assert "Expected 4 channels but got 2 channels" in caplog.text
    _same_as_jax(tmp_path / "w.wav", 2)


GOOD_FMT = fmt_chunk(PCM, 2, 24_000, 16)
GOOD_DATA = chunk(b"data", samples(16, PCM, 8, 2))
REFUSED = {  # name: (file bytes, the port's words)
    "not riff": (b"RIFX" + riff(GOOD_FMT, GOOD_DATA)[4:], "not a RIFF file"),
    "not wave": (riff(GOOD_FMT, GOOD_DATA)[:8] + b"AVI " + riff(GOOD_FMT, GOOD_DATA)[12:],
                 "not a WAVE file"),
    "short fmt": (riff(chunk(b"fmt ", b"\x01\x00\x02\x00" + b"\0" * 10), GOOD_DATA),
                  "fmt chunk too small"),
    "data before fmt": (riff(GOOD_DATA, GOOD_FMT), "data chunk before fmt chunk"),
    "data past the end": (riff(GOOD_FMT, GOOD_DATA)[:-3], r"exceeds the file's .* \(truncated"),
    "no data": (riff(GOOD_FMT, chunk(b"LIST", b"abcd")), "missing fmt or data chunk"),
    "cut in fmt": (riff(GOOD_FMT)[:30], "missing fmt or data chunk"),
    "zero channels": (riff(fmt_chunk(PCM, 0, 24_000, 16), GOOD_DATA),
                      r"invalid fmt chunk \(0 channels"),
    "zero rate": (riff(fmt_chunk(PCM, 2, 0, 16), GOOD_DATA), "0 sample rate"),
    "adpcm": (riff(fmt_chunk(2, 2, 24_000, 4), GOOD_DATA), "unsupported format 0x2"),
    "float16": (riff(fmt_chunk(FLOAT, 2, 24_000, 16), GOOD_DATA), "unsupported format 0x3"),
    "extensible adpcm": (riff(fmt_chunk(2, 2, 24_000, 16, extensible=True), GOOD_DATA),
                         "unsupported format 0x2"),
    "empty": (b"", "not a RIFF file"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_files_the_native_decoder_refuses_raise(tmp_path, name):
    blob, words = REFUSED[name]
    path = tmp_path / "bad.wav"
    path.write_bytes(blob)
    with pytest.raises(RuntimeError):
        native.decode_wav(path)
    with pytest.raises(ValueError, match=words):
        load_wav(path)


def test_what_jax_s_wave_fallback_decodes_and_the_port_refuses(tmp_path):
    """seld_tpu's load_wav falls back to the stdlib `wave` where seldio
    refuses: a data chunk of no whole frame gives a (C, 0) waveform, and
    12-bit PCM decodes as its 16-bit containers. The port raises for all
    three. A truncated data chunk raises in both (in JAX, numpy's reshape
    of the short read)."""
    cases = {
        "empty data": (riff(GOOD_FMT, chunk(b"data", b"")), (2, 0), "data chunk is empty"),
        "under one frame": (riff(GOOD_FMT, chunk(b"data", b"\x01\x02")), (2, 0),
                            "smaller than one audio frame"),
        "12-bit": (riff(fmt_chunk(PCM, 2, 24_000, 12), GOOD_DATA), (2, 8), "12-bit samples"),
    }
    for name, (blob, shape, words) in cases.items():
        path = tmp_path / f"{name}.wav"
        path.write_bytes(blob)
        assert jax_load_wav(path, expected_channels=2)[0].shape == shape, name
        with pytest.raises(ValueError, match=words):
            load_wav(path)
    truncated = tmp_path / "truncated.wav"
    full = riff(GOOD_FMT, GOOD_DATA)
    for cut in range(1, len(full) - 44 + 1):  # every cut inside the data chunk's samples
        truncated.write_bytes(full[:-cut])
        with pytest.raises(ValueError):
            jax_load_wav(truncated, expected_channels=2)
        with pytest.raises(ValueError, match="truncated"):
            load_wav(truncated)
