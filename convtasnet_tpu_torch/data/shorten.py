"""Shorten (v2) audio decompression — subsumes the reference's sph2pipe build.

The port's own copy of ``convtasnet_tpu/data/shorten.py`` (pure numpy, the
same names and bitstream): ``tests/test_torch_shorten.py`` holds its
``decode`` and ``encode`` to the JAX module's bit for bit.

WSJ0 is distributed as shorten-compressed NIST SPHERE files (``.wv1``/
``.wv2``, ``sample_coding: pcm,embedded-shorten-v2``). The reference recipe
compiles the external sph2pipe C tool to convert them
(``tools/Makefile:9-11``, ``egs/wsj0/local/data_prepare.sh:13-37``); this
module implements the decoder natively so stage 0 runs with no external
binaries.

Implemented from the published Shorten format (T. Robinson, "SHORTEN:
simple lossless and near-lossless waveform compression", Cambridge tech
report 156, 1994) — NOT a translation of the sph2pipe/shorten sources:

- bitstream: MSB-first bits over big-endian 32-bit words,
- Rice-style codes: ``uvar(k)`` = unary(high bits) then k low bits;
  ``var(k)`` = uvar(k+1) with folded sign; ``ulong`` = uvar(2) bit-width
  followed by that many bits,
- per-block commands: DIFF0..3 / QLPC / ZERO residual blocks, BLOCKSIZE,
  BITSHIFT, VERBATIM (raw byte passthrough), QUIT,
- fixed-order polynomial predictors with cross-block wrap history, running
  channel means (``nmean``) with v2 rounded offsets, quantized-LPC blocks,
- channels round-robin per block, interleaved on output.

A matching encoder is provided for test fixtures and as a capability in its
own right (compressing prepared corpora); round-trip losslessness is tested
over every predictor/feature combination (``tests/test_torch_shorten.py``),
plus a hand-assembled golden bitstream pinned to the spec so encoder and
decoder cannot share a compensating bug.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = b"ajkg"

# Command codes (format constants fixed by the spec)
FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3 = 0, 1, 2, 3
FN_QUIT, FN_BLOCKSIZE, FN_BITSHIFT, FN_QLPC, FN_ZERO, FN_VERBATIM = (
    4, 5, 6, 7, 8, 9)

# Field widths (bits of the k-part of each uvar read)
FNSIZE = 2
ENERGYSIZE = 3
BITSHIFTSIZE = 2
ULONGSIZE = 2
LPCQSIZE = 2
LPCQUANT = 5
XBYTESIZE = 7
VERBATIM_CKSIZE_SIZE = 5
VERBATIM_BYTE_SIZE = 8
NWRAP = 3
LPCQOFFSET_V2 = 1 << (LPCQUANT - 1)
DEFAULT_BLOCKSIZE = 256

# File types (sample formats)
TYPE_AU1, TYPE_S8, TYPE_U8 = 0, 1, 2
TYPE_S16HL, TYPE_U16HL, TYPE_S16LH, TYPE_U16LH = 3, 4, 5, 6
TYPE_ULAW, TYPE_AU2, TYPE_AU3, TYPE_ALAW = 7, 8, 9, 10

_SIGNED_TYPES = {TYPE_S8, TYPE_S16HL, TYPE_S16LH}
_SUPPORTED_TYPES = {TYPE_S8, TYPE_U8, TYPE_S16HL, TYPE_U16HL,
                    TYPE_S16LH, TYPE_U16LH}


class _BitReader:
    """MSB-first bit reader over a big-endian 32-bit-word stream."""

    __slots__ = ("data", "pos", "word", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.word = 0
        self.nbits = 0

    def _fill(self) -> None:
        chunk = self.data[self.pos:self.pos + 4]
        if len(chunk) < 4:
            chunk = chunk + b"\x00" * (4 - len(chunk))
            if self.pos >= len(self.data):
                raise EOFError("shorten bitstream exhausted")
        self.pos += 4
        self.word = int.from_bytes(chunk, "big")
        self.nbits = 32

    def uvar(self, k: int) -> int:
        # unary prefix: count 0 bits until a 1
        result = 0
        word, nbits = self.word, self.nbits
        while True:
            if nbits == 0:
                self._fill()
                word, nbits = self.word, self.nbits
            # find highest set bit among the remaining nbits
            chunk = word & ((1 << nbits) - 1)
            if chunk == 0:
                result += nbits
                nbits = 0
                continue
            top = chunk.bit_length()
            result += nbits - top
            nbits = top - 1  # consume zeros and the terminating 1
            break
        # k-bit binary part
        value = 0
        need = k
        while need > 0:
            if nbits == 0:
                self._fill()
                word, nbits = self.word, self.nbits
            take = min(need, nbits)
            value = (value << take) | (
                (word >> (nbits - take)) & ((1 << take) - 1))
            nbits -= take
            need -= take
        self.word, self.nbits = word, nbits
        return (result << k) | value

    def var(self, k: int) -> int:
        u = self.uvar(k + 1)
        return -(u >> 1) - 1 if (u & 1) else (u >> 1)

    def ulong(self) -> int:
        return self.uvar(self.uvar(ULONGSIZE))


class _BitWriter:
    """MSB-first bit writer emitting big-endian 32-bit words."""

    def __init__(self):
        self.words: List[int] = []
        self.word = 0
        self.nbits = 0

    def _put(self, value: int, nbits: int) -> None:
        while nbits > 0:
            room = 32 - self.nbits
            take = min(nbits, room)
            self.word = (self.word << take) | (
                (value >> (nbits - take)) & ((1 << take) - 1))
            self.nbits += take
            nbits -= take
            if self.nbits == 32:
                self.words.append(self.word)
                self.word = 0
                self.nbits = 0

    def uvar(self, value: int, k: int) -> None:
        unary = value >> k
        while unary >= 32:  # emit long zero runs word-wise
            self._put(0, 32)
            unary -= 32
        self._put(1, unary + 1)  # `unary` zeros then the terminating 1
        if k:
            self._put(value & ((1 << k) - 1), k)

    def var(self, value: int, k: int) -> None:
        u = (value << 1) if value >= 0 else ((-value - 1) << 1) | 1
        self.uvar(u, k + 1)

    def ulong(self, value: int) -> None:
        nbit = max(value.bit_length(), 0)
        self.uvar(nbit, ULONGSIZE)
        self.uvar(value, nbit)

    def getvalue(self) -> bytes:
        words = list(self.words)
        if self.nbits:
            words.append(self.word << (32 - self.nbits))
        return b"".join(w.to_bytes(4, "big") for w in words)


def _rounded_shift_down(x: int, n: int) -> int:
    return x if n == 0 else ((x >> (n - 1)) + 1) >> 1


def decode(data: bytes, max_samples: Optional[int] = None
           ) -> Tuple[np.ndarray, int, bytes]:
    """Decode a Shorten v2 stream.

    Args:
        data: the full stream (starting at the ``ajkg`` magic).
        max_samples: optional cap on decoded frames (per channel).

    Returns:
        (samples [n, nchan] int32, file_type, verbatim_bytes) — verbatim
        bytes are the raw passthrough sections (for SPHERE-embedded streams,
        the original file's header material).
    """
    if data[:4] != MAGIC:
        raise ValueError("not a shorten stream (missing 'ajkg' magic)")
    version = data[4] - ord("0")
    if version != 2:
        raise ValueError(f"unsupported shorten version: {version}")
    br = _BitReader(data[5:])

    ftype = br.ulong()
    if ftype not in _SUPPORTED_TYPES:
        raise ValueError(f"unsupported shorten file type: {ftype}")
    nchan = br.ulong()
    blocksize = br.ulong()
    maxnlpc = br.ulong()
    nmean = br.ulong()
    nskip = br.ulong()
    # Header sanity (mirrors native/shorten.cpp): a corrupt stream must
    # raise the documented ValueError, not IndexError/ZeroDivisionError or
    # an attempted multi-GB allocation from garbage field values.
    if not 1 <= nchan <= 64:
        raise ValueError(f"implausible shorten channel count: {nchan}")
    if not 1 <= blocksize <= (1 << 20):
        raise ValueError(f"implausible shorten blocksize: {blocksize}")
    if maxnlpc > 1024:
        raise ValueError(f"implausible shorten maxnlpc: {maxnlpc}")
    if nmean > 65536:
        raise ValueError(f"implausible shorten nmean: {nmean}")
    if nskip > len(data):
        raise ValueError(f"implausible shorten nskip: {nskip}")
    skipped = bytes(br.uvar(XBYTESIZE) for _ in range(nskip))

    nwrap = max(NWRAP, maxnlpc)
    default_offset = 0 if ftype in _SIGNED_TYPES else (
        0x80 if ftype in (TYPE_U8,) else 0x8000)
    buf = [[0] * nwrap for _ in range(nchan)]  # wrap history per channel
    offsets = [[default_offset] * max(nmean, 1) for _ in range(nchan)]
    out: List[List[int]] = [[] for _ in range(nchan)]
    verbatim = bytearray(skipped)

    bitshift = 0
    chan = 0
    while True:
        cmd = br.uvar(FNSIZE)
        if cmd == FN_QUIT:
            break
        if cmd == FN_BLOCKSIZE:
            blocksize = br.ulong()
            if not 1 <= blocksize <= (1 << 20):
                raise ValueError(
                    f"implausible shorten blocksize: {blocksize}")
            continue
        if cmd == FN_BITSHIFT:
            bitshift = br.uvar(BITSHIFTSIZE)
            continue
        if cmd == FN_VERBATIM:
            n = br.uvar(VERBATIM_CKSIZE_SIZE)
            verbatim.extend(br.uvar(VERBATIM_BYTE_SIZE) & 0xFF
                            for _ in range(n))
            continue
        if cmd not in (FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3,
                       FN_QLPC, FN_ZERO):
            raise ValueError(f"unknown shorten command: {cmd}")

        # channel running offset (v2 rounding)
        if nmean == 0:
            coffset = offsets[chan][0]
        else:
            total = nmean // 2 + sum(offsets[chan])
            coffset = _rounded_shift_down(total // nmean, bitshift)

        hist = buf[chan]  # last nwrap samples (pre-bitshift domain)
        block: List[int] = []
        if cmd == FN_ZERO:
            block = [0] * blocksize
        elif cmd == FN_QLPC:
            energy = br.uvar(ENERGYSIZE)
            nlpc = br.uvar(LPCQSIZE)
            qlpc = [br.var(LPCQUANT) for _ in range(nlpc)]
            # predict in the offset-removed domain
            h = [hist[-(j + 1)] - coffset for j in range(nlpc)]  # h[0]=x[-1]
            for _ in range(blocksize):
                s = LPCQOFFSET_V2
                for j in range(nlpc):
                    s += qlpc[j] * h[j]
                v = br.var(energy) + (s >> LPCQUANT)
                block.append(v + coffset)
                if nlpc:
                    h = [v] + h[:-1]
        else:
            energy = br.uvar(ENERGYSIZE)
            p1 = hist[-1] if nwrap >= 1 else 0
            p2 = hist[-2] if nwrap >= 2 else 0
            p3 = hist[-3] if nwrap >= 3 else 0
            if cmd == FN_DIFF0:
                for _ in range(blocksize):
                    block.append(br.var(energy) + coffset)
            elif cmd == FN_DIFF1:
                for _ in range(blocksize):
                    p1 = br.var(energy) + p1
                    block.append(p1)
            elif cmd == FN_DIFF2:
                for _ in range(blocksize):
                    v = br.var(energy) + 2 * p1 - p2
                    block.append(v)
                    p2, p1 = p1, v
            else:  # FN_DIFF3
                for _ in range(blocksize):
                    v = br.var(energy) + 3 * (p1 - p2) + p3
                    block.append(v)
                    p3, p2, p1 = p2, p1, v

        # running mean update (stored in the pre-bitshift domain, scaled up)
        if nmean > 0:
            s = blocksize // 2 + sum(block)
            offsets[chan] = offsets[chan][1:] + [(s // blocksize) << bitshift]

        # wrap history keeps pre-bitshift values; output applies the shift
        buf[chan] = (hist + block)[-nwrap:] if nwrap else []
        out[chan].extend(v << bitshift for v in block)
        chan = (chan + 1) % nchan
        if max_samples is not None and chan == 0 and len(out[0]) >= max_samples:
            break

    n = min(len(c) for c in out) if nchan else 0
    if max_samples is not None:
        n = min(n, max_samples)
    samples = np.empty((n, nchan), np.int32)
    for c in range(nchan):
        samples[:, c] = out[c][:n]
    return samples, ftype, bytes(verbatim)


def encode(
    samples: np.ndarray,
    ftype: int = TYPE_S16HL,
    blocksize: int = DEFAULT_BLOCKSIZE,
    nmean: int = 0,
    bitshift: int = 0,
    verbatim: bytes = b"",
) -> bytes:
    """Encode int samples [n] or [n, nchan] as a Shorten v2 stream.

    Per block the cheapest of DIFF0..3 (by residual magnitude) is chosen,
    mirroring the published encoder's predictor search. ``bitshift`` encodes
    ``samples >> bitshift`` losslessly only if every sample has that many
    trailing zero bits (the encoder checks). Lossless: ``decode(encode(x))``
    returns ``x`` exactly.
    """
    if ftype not in _SUPPORTED_TYPES:
        raise ValueError(f"unsupported shorten file type: {ftype}")
    x = np.asarray(samples, np.int64)
    if x.ndim == 1:
        x = x[:, None]
    n, nchan = x.shape
    if bitshift:
        if np.any(x & ((1 << bitshift) - 1)):
            raise ValueError("bitshift would lose low bits")
        x = x >> bitshift

    bw = _BitWriter()
    bw.ulong(ftype)
    bw.ulong(nchan)
    bw.ulong(blocksize)
    bw.ulong(0)        # maxnlpc (polynomial predictors only)
    bw.ulong(nmean)
    bw.ulong(0)        # nskip
    if verbatim:
        bw.uvar(FN_VERBATIM, FNSIZE)
        bw.uvar(len(verbatim), VERBATIM_CKSIZE_SIZE)
        for b in verbatim:
            bw.uvar(b, VERBATIM_BYTE_SIZE)
    if bitshift:
        bw.uvar(FN_BITSHIFT, FNSIZE)
        bw.uvar(bitshift, BITSHIFTSIZE)

    default_offset = 0 if ftype in _SIGNED_TYPES else (
        0x80 if ftype == TYPE_U8 else 0x8000)
    hist = [[0] * NWRAP for _ in range(nchan)]
    offsets = [[default_offset] * max(nmean, 1) for _ in range(nchan)]

    pos = 0
    while pos < n:
        nblock = min(blocksize, n - pos)
        if nblock != blocksize:
            bw.uvar(FN_BLOCKSIZE, FNSIZE)
            bw.ulong(nblock)
            blocksize = nblock
        for c in range(nchan):
            block = x[pos:pos + nblock, c].tolist()
            if nmean == 0:
                coffset = offsets[c][0]
            else:
                total = nmean // 2 + sum(offsets[c])
                coffset = _rounded_shift_down(total // nmean, bitshift)
            p1, p2, p3 = hist[c][-1], hist[c][-2], hist[c][-3]
            res = {FN_DIFF0: [], FN_DIFF1: [], FN_DIFF2: [], FN_DIFF3: []}
            for v in block:
                res[FN_DIFF0].append(v - coffset)
                res[FN_DIFF1].append(v - p1)
                res[FN_DIFF2].append(v - (2 * p1 - p2))
                res[FN_DIFF3].append(v - (3 * (p1 - p2) + p3))
                p3, p2, p1 = p2, p1, v
            if all(v == 0 for v in block):
                bw.uvar(FN_ZERO, FNSIZE)
            else:
                cost = {c_: sum(abs(r) for r in rs) for c_, rs in res.items()}
                cmd = min(cost, key=cost.get)
                rs = res[cmd]
                # Rice parameter: bits for the mean magnitude (spec's
                # log2(mean(2|r|)) rule)
                mean_mag = max(1, (2 * sum(abs(r) for r in rs)) // len(rs))
                energy = min(mean_mag.bit_length() - 1, (1 << ENERGYSIZE) + 8)
                bw.uvar(cmd, FNSIZE)
                bw.uvar(energy, ENERGYSIZE)
                for r in rs:
                    bw.var(r, energy)
            if nmean > 0:
                s = nblock // 2 + sum(block)
                offsets[c] = offsets[c][1:] + [(s // nblock) << bitshift]
            hist[c] = (hist[c] + block)[-NWRAP:]
        pos += nblock

    bw.uvar(FN_QUIT, FNSIZE)
    return MAGIC + b"2" + bw.getvalue()


def samples_to_float(samples: np.ndarray, ftype: int) -> np.ndarray:
    """Decoded int samples -> float32 in [-1, 1) (channel layout kept)."""
    x = samples.astype(np.float32)
    if ftype == TYPE_S8:
        return x / 128.0
    if ftype == TYPE_U8:
        return (x - 128.0) / 128.0
    if ftype in (TYPE_S16HL, TYPE_S16LH):
        return x / 32768.0
    if ftype in (TYPE_U16HL, TYPE_U16LH):
        return (x - 32768.0) / 32768.0
    raise ValueError(f"unsupported shorten file type: {ftype}")
