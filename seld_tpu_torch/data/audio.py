"""WAV decoding and writing (counterpart: seld_tpu/data/audio.py, with the
RIFF decoder of seld_tpu/native/seldio.cpp).

`load_wav` walks the RIFF chunks in numpy: PCM with 8, 16, 24 or 32-bit
samples, IEEE float32 and float64, and WAVE_FORMAT_EXTENSIBLE wrapping
either (the format read from the first two bytes of the SubFormat GUID);
chunks other than fmt and data (LIST, fact, bext, ...) are skipped with
word alignment. Samples are scaled to [-1, 1] as seldio does: int16 /
2^15, int24 / 2^23, int32 / 2^31 (through float64), uint8 offset binary
(x - 128) / 128; floats as stored. A file it cannot decode raises
ValueError naming what is wrong; there is no second decoder to fall back
to.
"""

from __future__ import annotations

import logging
import wave
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _u16(buf: bytes, at: int) -> int:
    return int.from_bytes(buf[at:at + 2], "little")


def _u32(buf: bytes, at: int) -> int:
    return int.from_bytes(buf[at:at + 4], "little")


def _chunks(buf: bytes, path):
    """(fmt tag, channels, sample rate, bits, data bytes) of the RIFF/WAVE
    buffer: the chunk walk of seldio.cpp, fmt before data."""
    if buf[:4] != b"RIFF":
        raise ValueError(f"not a RIFF file: {path}")
    if buf[8:12] != b"WAVE":
        raise ValueError(f"not a WAVE file: {path}")
    fmt = channels = rate = bits = None
    pos, end = 12, len(buf)
    while pos + 8 <= end:
        tag, size = buf[pos:pos + 4], _u32(buf, pos + 4)
        body = pos + 8
        if tag == b"fmt ":
            if size < 16:
                raise ValueError(f"fmt chunk too small ({size} bytes): {path}")
            if body + 16 > end:
                break  # cut inside fmt
            fmt, channels, rate = _u16(buf, body), _u16(buf, body + 2), _u32(buf, body + 4)
            bits = _u16(buf, body + 14)
            if fmt == WAVE_FORMAT_EXTENSIBLE and size >= 26 and body + 26 <= end:
                fmt = _u16(buf, body + 24)  # the SubFormat GUID's first two bytes
        elif tag == b"data":
            if fmt is None:
                raise ValueError(f"data chunk before fmt chunk: {path}")
            if size > end - body:
                raise ValueError(f"data chunk of {size} bytes exceeds the file's "
                                 f"{end - body} (truncated?): {path}")
            return fmt, channels, rate, bits, buf[body:body + size]
        pos = body + size + (size & 1)
    raise ValueError(f"missing fmt or data chunk: {path}")


def decode_wav(path) -> tuple[np.ndarray, int]:
    """-> (float32 (channels, frames) in [-1, 1], sample rate)."""
    buf = Path(path).read_bytes()
    fmt, channels, rate, bits, data = _chunks(buf, path)
    if not data:
        raise ValueError(f"missing fmt or data chunk (the data chunk is empty): {path}")
    if channels == 0 or rate == 0:
        raise ValueError(f"invalid fmt chunk (0 channels or 0 sample rate): {path}")
    if not ((fmt == WAVE_FORMAT_PCM and bits in (8, 16, 24, 32))
            or (fmt == WAVE_FORMAT_IEEE_FLOAT and bits in (32, 64))):
        raise ValueError(f"unsupported format {fmt:#x} with {bits}-bit samples (not PCM "
                         f"8/16/24/32 or float 32/64): {path}")
    width = bits // 8
    frames = len(data) // (width * channels)
    if frames == 0:
        raise ValueError(f"data chunk smaller than one audio frame: {path}")
    raw = np.frombuffer(data, np.uint8, count=frames * channels * width)
    if fmt == WAVE_FORMAT_IEEE_FLOAT:
        x = raw.view("<f4" if bits == 32 else "<f8").astype(np.float32)
    elif bits == 16:
        x = raw.view("<i2").astype(np.float32) * np.float32(1 / 32768)
    elif bits == 24:
        b = raw.reshape(-1, 3).astype(np.int32)
        v = ((b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)) >> 8  # sign from the top byte
        x = v.astype(np.float32) * np.float32(1 / 8388608)
    elif bits == 32:
        x = (raw.view("<i4") * (1.0 / 2147483648.0)).astype(np.float32)
    else:
        x = (raw.astype(np.float32) - np.float32(128.0)) * np.float32(1 / 128)
    return np.ascontiguousarray(x.reshape(frames, channels).T), rate


def load_wav(path, expected_channels: int | None = 4):
    """Decode a PCM or float WAV file -> (float32 (C, N) in [-1, 1], sample
    rate)."""
    wave_cn, sr = decode_wav(path)
    if expected_channels is not None and wave_cn.shape[0] != expected_channels:
        logger.warning("Expected %d channels but got %d channels in %s",
                       expected_channels, wave_cn.shape[0], path)
    return wave_cn, sr


def write_wav(path, waveform: np.ndarray, sample_rate: int) -> None:
    """Write float32 (C, N) in [-1, 1] as 16-bit PCM."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(waveform * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(waveform.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())
