"""WAV and NIST SPHERE input, WAV output, on numpy, with no audio library.

Counterpart of ``convtasnet_tpu/data/audio_io.py``: RIFF/WAVE files (PCM
8/16/24/32 and IEEE float, WAVE_FORMAT_EXTENSIBLE), NIST SPHERE files with
PCM payloads or shorten-compressed ones (``.wv1``/``.wv2``, the WSJ0
distribution format, decoded by the port's ``data/shorten.py``; no
sph2pipe), and polyphase resampling. The JAX package's C++ shorten decoder
(``native/``) is not bound here: the numpy decoder gives the same samples.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str,
             sample_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a WAV or NIST SPHERE file -> (float32 mono signal in [-1, 1],
    sample_rate).

    Multi-channel audio is averaged to mono. If ``sample_rate`` is given and
    differs from the file's rate, the signal is resampled.
    """
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) == 12 and header[:4] == b"RIFF" \
                and header[8:12] == b"WAVE":
            data, sr = _read_riff(f)
        elif header[:8] == b"NIST_1A\n":
            data, sr = _read_sphere(f, header)
        else:
            raise ValueError(f"not a RIFF/WAVE or NIST SPHERE file: {path}")
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sample_rate is not None and sample_rate != sr:
        data = resample(data, sr, sample_rate)
        sr = sample_rate
    return np.ascontiguousarray(data, dtype=np.float32), sr


def _read_riff(f) -> Tuple[np.ndarray, int]:
    """Parse RIFF chunks (float and PCM formats beyond the stdlib wave)."""
    fmt = None
    fmt_payload = b""
    data_bytes = None
    while True:
        head = f.read(8)
        if len(head) < 8:
            break
        cid, size = struct.unpack("<4sI", head)
        payload = f.read(size)
        if size % 2:
            f.read(1)  # chunks are word-aligned
        if cid == b"fmt ":
            if len(payload) < 16:
                raise ValueError("fmt chunk too small")
            fmt = struct.unpack("<HHIIHH", payload[:16])
            fmt_payload = payload
        elif cid == b"data":
            data_bytes = payload
    if fmt is None or data_bytes is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, n_channels, sr, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the real format code opens the SubFormat GUID of the extension
        if len(fmt_payload) < 26:
            raise ValueError("malformed WAVE_FORMAT_EXTENSIBLE fmt chunk")
        audio_format = struct.unpack("<H", fmt_payload[24:26])[0]
        if audio_format not in (1, 3):
            raise ValueError(
                f"unsupported EXTENSIBLE subformat: {audio_format}")
    if audio_format == 3:  # IEEE float
        if bits == 32:
            dtype = np.dtype("<f4")
        elif bits == 64:
            dtype = np.dtype("<f8")
        else:
            raise ValueError(f"unsupported IEEE-float bit depth: {bits}")
        x = np.frombuffer(data_bytes, dtype=dtype).astype(np.float32)
    elif audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data_bytes, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data_bytes, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data_bytes, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data_bytes, dtype=np.uint8).reshape(-1, 3)
            x = ((raw[:, 0].astype(np.int32))
                 | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            x = (x ^ 0x800000) - 0x800000  # sign-extend
            x = x.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels)
    return x, sr


def _read_sphere(f, header12: bytes) -> Tuple[np.ndarray, int]:
    """Parse a NIST SPHERE file whose first 12 bytes were read: its 1024-byte
    ASCII header, then a PCM payload or a shorten-compressed one
    (``sample_coding`` ``pcm,embedded-shorten-v2``). A malformed header or
    a truncated shorten payload raises ``ValueError``."""
    rest = f.read(1024 - len(header12))
    head = (header12 + rest).decode("ascii", errors="replace")
    lines = head.split("\n")
    try:
        header_bytes = int(lines[1].strip())
    except (IndexError, ValueError):
        raise ValueError("malformed SPHERE header")
    fields = {}
    for line in lines[2:]:
        parts = line.split()
        if len(parts) >= 3 and parts[1].startswith("-"):
            fields[parts[0]] = parts[2]
        if line.strip() == "end_head":
            break
    coding = fields.get("sample_coding", "pcm")
    sr = int(fields.get("sample_rate", 16000))
    n_channels = int(fields.get("channel_count", 1))
    n_samples = int(fields["sample_count"])
    n_bytes = int(fields.get("sample_n_bytes", 2))
    byte_format = fields.get("sample_byte_format", "01")
    f.seek(header_bytes)
    if "shorten" in coding or "embedded" in coding:
        from convtasnet_tpu_torch.data.shorten import decode, samples_to_float

        try:
            samples, ftype, _ = decode(f.read(), max_samples=n_samples)
        except EOFError as e:
            raise ValueError(f"truncated shorten payload: {e}") from e
        x = samples_to_float(samples[:n_samples], ftype)
        if n_channels == 1 and x.shape[1] == 1:
            x = x[:, 0]
        return x, sr
    raw = f.read(n_samples * n_channels * n_bytes)
    if n_bytes == 2:
        dtype = "<i2" if byte_format == "01" else ">i2"
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32) / 32768.0
    elif n_bytes == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported SPHERE sample width: {n_bytes}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels)
    return x, sr


def write_wav(path: str, data: np.ndarray, sample_rate: int,
              subtype: str = "PCM_16") -> None:
    """Write a mono/multichannel float signal as PCM_16 (default) or FLOAT."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n_channels = data.shape[1]
    if subtype == "FLOAT":
        payload = data.astype("<f4").tobytes()
        audio_format, bits = 3, 32
    elif subtype == "PCM_16":
        clipped = np.clip(data, -1.0, 1.0 - 1.0 / 32768.0)
        payload = (clipped * 32768.0).astype("<i2").tobytes()
        audio_format, bits = 1, 16
    else:
        raise ValueError(f"unsupported subtype: {subtype}")
    byte_rate = sample_rate * n_channels * bits // 8
    block_align = n_channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, audio_format, n_channels,
                            sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling via scipy (kaiser-windowed FIR), float32."""
    if orig_sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(x.astype(np.float64), target_sr // g,
                         orig_sr // g).astype(np.float32)


def wav_duration_samples(path: str) -> int:
    """Sample count from the header, without decoding the payload."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a WAV file: {path}")
        fmt = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError("no fmt/data chunk found")
            cid, size = struct.unpack("<4sI", head)
            if cid == b"fmt ":
                if size < 16:
                    raise ValueError("fmt chunk too small")
                fmt = struct.unpack("<HHIIHH", f.read(16))
                f.read(size - 16)
                if size % 2:
                    f.read(1)
            elif cid == b"data":
                if fmt is None:
                    raise ValueError("data chunk before fmt")
                block_align = fmt[4]
                if block_align == 0:
                    raise ValueError("fmt chunk has zero block_align")
                return size // block_align
            else:
                f.seek(size + (size % 2), 1)


def wav_sample_rate(path: str) -> int:
    """The sample rate in a WAV file's fmt chunk."""
    with open(path, "rb") as f:
        f.read(12)
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"no fmt chunk in {path}")
            cid, size = struct.unpack("<4sI", head)
            if cid == b"fmt ":
                return struct.unpack("<HHIIHH", f.read(16))[2]
            f.seek(size + (size % 2), 1)
