"""The port's shorten codec (``convtasnet_tpu_torch/data/shorten.py``) and
SPHERE reading (``data/audio_io.read_wav``) against the JAX package's: the
cases of tests/test_shorten.py and the SPHERE cases of
tests/test_jobs_sphere.py.

The port's ``decode`` equals JAX's on streams from JAX's ``encode`` over
every predictor and feature, the port's ``encode`` gives JAX's bytes, the
golden hand-assembled bitstream decodes, bad streams and headers raise,
and ``read_wav`` of PCM and shorten SPHERE files equals JAX's sample for
sample.
"""

import numpy as np
import pytest

from convtasnet_tpu.data import shorten as jsh
from convtasnet_tpu.data.audio_io import read_wav as jax_read_wav
from convtasnet_tpu_torch.data import shorten as sh
from convtasnet_tpu_torch.data.audio_io import read_wav


def _signal(n=4000, seed=0, noise=50):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 3000 * np.sin(t / 30) + 800 * np.sin(t / 7.3)
    return (x + rng.integers(-noise, noise + 1, n)).astype(np.int32)


def _every_predictor():
    """Constant, linear, quadratic and noisy segments: ZERO and DIFF0..3."""
    return np.concatenate([
        np.zeros(512, np.int32), np.full(512, 1234, np.int32),
        (np.arange(512) * 7).astype(np.int32),
        (np.arange(512) ** 2 // 64).astype(np.int32),
        _signal(512, seed=3, noise=2000)])


STREAMS = {
    **{f"mono_nmean{m}_shift{b}": (
        lambda m=m, b=b: (_signal() & ~((1 << b) - 1),
                          dict(ftype=sh.TYPE_S16HL, nmean=m, bitshift=b)))
       for m in (0, 2, 4) for b in (0, 2)},
    "stereo_tail_block": lambda: (
        np.stack([_signal(seed=1), _signal(seed=2) // 3], axis=1)[:777],
        dict(ftype=sh.TYPE_S16LH, blocksize=256, nmean=4)),
    "every_predictor": lambda: (_every_predictor(), dict(blocksize=256)),
    "u8": lambda: ((_signal() // 16 + 128).clip(0, 255).astype(np.int32),
                   dict(ftype=sh.TYPE_U8)),
    "s8": lambda: ((_signal() // 256).astype(np.int32),
                   dict(ftype=sh.TYPE_S8)),
    "u16": lambda: ((_signal() + 32768).astype(np.int32),
                    dict(ftype=sh.TYPE_U16HL, nmean=2)),
    "verbatim": lambda: (_signal(300), dict(
        verbatim=b"NIST_1A\n   1024\nsample_count -i 300\n")),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_and_encode_match_jax(name):
    x, kw = STREAMS[name]()
    stream = jsh.encode(x, **kw)
    assert sh.encode(x, **kw) == stream
    got, ftype, verb = sh.decode(stream)
    want, jftype, jverb = jsh.decode(stream)
    assert got.dtype == want.dtype and ftype == jftype and verb == jverb
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x if x.ndim == 2 else x[:, None])
    np.testing.assert_array_equal(sh.samples_to_float(got, ftype),
                                  jsh.samples_to_float(want, jftype))
    # a cap on the decoded frames, as the SPHERE reader passes it
    cap = len(x) // 3
    np.testing.assert_array_equal(sh.decode(stream, max_samples=cap)[0],
                                  jsh.decode(stream, max_samples=cap)[0])


def test_golden_bitstream_hand_assembled():
    """The bitstream of tests/test_shorten.py, assembled bit by bit from the
    published format: header S16HL, one channel, blocksize 4; one DIFF1
    block of energy 0 with residuals [1, -1, 2, -2]; QUIT."""
    bits = "".join([
        "110111", "10111", "1111100", "1001", "1001", "1001",
        "101", "1000", "010", "11", "0010", "011", "0100"])
    bits = bits + "0" * (-len(bits) % 32)
    payload = int(bits, 2).to_bytes(len(bits) // 8, "big")
    dec, ftype, verb = sh.decode(b"ajkg2" + payload)
    assert ftype == sh.TYPE_S16HL and verb == b""
    np.testing.assert_array_equal(dec[:, 0], [1, 0, 2, 0])


def _header_stream(ftype=sh.TYPE_S16HL, nchan=1, blocksize=4, maxnlpc=0,
                   nmean=0, nskip=0):
    bw = sh._BitWriter()
    for v in (ftype, nchan, blocksize, maxnlpc, nmean, nskip):
        bw.ulong(v)
    bw.uvar(sh.FN_QUIT, sh.FNSIZE)
    return b"ajkg2" + bw.getvalue()


@pytest.mark.parametrize("stream, match", [
    (b"nope" + b"\x00" * 16, "magic"),
    (b"ajkg1" + b"\x00" * 16, "version"),
    (_header_stream(nchan=0), "channel count"),
    (_header_stream(nchan=1 << 20), "channel count"),
    (_header_stream(blocksize=0), "blocksize"),
    (_header_stream(blocksize=1 << 36), "blocksize"),
    (_header_stream(maxnlpc=1 << 24), "maxnlpc"),
    (_header_stream(nmean=1 << 30), "nmean"),
    (_header_stream(ftype=sh.TYPE_ULAW), "file type"),
])
def test_bad_streams_raise_as_jax(stream, match):
    with pytest.raises(ValueError, match=match):
        jsh.decode(stream)
    with pytest.raises(ValueError, match=match):
        sh.decode(stream)


def test_encode_refuses_lossy_bitshift_and_truncation_is_eof():
    with pytest.raises(ValueError, match="bitshift would lose"):
        sh.encode(np.array([1, 2, 3], np.int32), bitshift=1)
    stream = sh.encode(_signal(2000))
    with pytest.raises(EOFError):
        sh.decode(stream[:len(stream) // 2])


def _sphere(path, payload: bytes, n, sr=8000, coding="pcm", nbytes=2,
            byte_format="01", channels=1, header_bytes=1024):
    fields = (f"NIST_1A\n   {header_bytes}\n"
              f"sample_count -i {n}\n"
              f"sample_rate -i {sr}\n"
              f"channel_count -i {channels}\n"
              f"sample_n_bytes -i {nbytes}\n"
              f"sample_byte_format -s2 {byte_format}\n"
              f"sample_coding -s{len(coding)} {coding}\n"
              "end_head\n").encode()
    with open(path, "wb") as f:
        f.write(fields + b" " * (header_bytes - len(fields)))
        f.write(payload)
    return str(path)


def _pcm_files(tmp_path):
    x = (np.sin(np.linspace(0, 20, 8000)) * 16000).astype(np.int16)
    st = np.stack([x, (x // 3)], axis=1)
    return {
        "pcm16_le": _sphere(tmp_path / "a.sph", x.astype("<i2").tobytes(),
                            8000, sr=16000),
        "pcm16_be": _sphere(tmp_path / "b.sph", x.astype(">i2").tobytes(),
                            8000, byte_format="10"),
        "pcm8": _sphere(tmp_path / "c.sph",
                        (x // 256 + 128).astype(np.uint8).tobytes(), 8000,
                        nbytes=1),
        "pcm16_stereo": _sphere(tmp_path / "d.sph",
                                st.astype("<i2").tobytes(), 8000,
                                channels=2),
        "shorten": _sphere(tmp_path / "e.wv1", jsh.encode(_signal(8000)),
                           8000, byte_format="10",
                           coding="pcm,embedded-shorten-v2"),
        "shorten_stereo": _sphere(
            tmp_path / "f.wv1", jsh.encode(
                np.stack([_signal(3000, 4), _signal(3000, 5)], axis=1),
                nmean=4), 3000, channels=2,
            coding="pcm,embedded-shorten-v2.00"),
    }


@pytest.mark.parametrize("resample_to", [None, 8000])
def test_read_wav_sphere_equals_jax(tmp_path, resample_to):
    for name, path in _pcm_files(tmp_path).items():
        got, sr = read_wav(path, sample_rate=resample_to)
        want, jsr = jax_read_wav(path, sample_rate=resample_to)
        assert sr == jsr and got.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    y, _ = read_wav(str(tmp_path / "e.wv1"))
    np.testing.assert_array_equal(y, _signal(8000).astype(np.float32)
                                  / 32768.0)


def test_read_wav_rejects_bad_sphere(tmp_path):
    stream = jsh.encode(_signal(8000))
    paths = {
        "truncated shorten payload": _sphere(
            tmp_path / "t.wv1", stream[:len(stream) // 2], 8000,
            coding="pcm,embedded-shorten-v2"),
        "magic": _sphere(tmp_path / "g.wv1", b"\x00" * 200, 100,
                         coding="pcm,embedded-shorten-v2.00"),
        "sample width": _sphere(tmp_path / "w.sph", b"\x00" * 300, 100,
                                nbytes=3),
    }
    with open(tmp_path / "m.sph", "wb") as f:
        f.write(b"NIST_1A\n  notanumber\nend_head\n" + b" " * 990)
    paths["malformed SPHERE header"] = str(tmp_path / "m.sph")
    for match, path in paths.items():
        with pytest.raises(ValueError, match=match):
            jax_read_wav(path)
        with pytest.raises(ValueError, match=match):
            read_wav(path)
