"""Stage 0 of the port (``convtasnet_tpu_torch/tools/``, ``cli prepare``)
against the JAX package's: the cases of tests/test_tools.py.

The P.56 active level equals JAX's on seeded signals; ``create_mixtures``
(min and max, 8 and 16 kHz, three speakers), ``create_mixtures_multi`` and
``prepare_wsj0`` on a shorten-compressed disc tree write the files JAX
writes, byte for byte; a missing source fails clearly; ``cli prepare``
takes ``--pair-list``, ``--all-variants`` and ``--wsj0-root`` with JAX's
messages and exit codes.
"""

import os
import shutil

import numpy as np
import pytest

from convtasnet_tpu import cli as jcli
from convtasnet_tpu.data import shorten as jsh
from convtasnet_tpu.tools import activlev as jlev
from convtasnet_tpu.tools import mixture as jmix
from convtasnet_tpu.tools import wsj0 as jwsj0
from convtasnet_tpu_torch import cli
from convtasnet_tpu_torch.data.audio_io import write_wav
from convtasnet_tpu_torch.tools import activlev as plev
from convtasnet_tpu_torch.tools import mixture as pmix
from convtasnet_tpu_torch.tools import wsj0 as pwsj0


def _speechlike(duration, fs, active_frac=0.5, seed=0):
    rng = np.random.default_rng(seed)
    T = int(duration * fs)
    x = np.zeros(T)
    burst = int(0.25 * fs)
    for t in range(0, T - burst + 1, burst):
        if rng.uniform() < active_frac:
            x[t:t + burst] = rng.standard_normal(burst)
    return x


def _tone_bursts(fs, dur, duty, f0=300.0):
    t = np.arange(int(dur * fs)) / fs
    x = np.sqrt(2.0) * np.sin(2 * np.pi * f0 * t)
    x *= 1.0 + 0.3 * np.sin(2 * np.pi * 2.3 * t)
    period = 3 * fs
    return x * ((np.arange(len(t)) % period) < int(duty * period))


SIGNALS = {
    "speech_8k": (lambda: 0.1 * _speechlike(3.0, 8000, 0.6, 2), 8000),
    "speech_padded_8k": (lambda: np.concatenate(
        [_speechlike(2.0, 8000, 1.0), np.zeros(16000)]), 8000),
    "bursts_8k": (lambda: _tone_bursts(8000, 6.0, 0.5), 8000),
    "bursts_16k_band": (lambda: _tone_bursts(16000, 3.0, 0.5, 500.0)
                        + 2.0 * np.sin(2 * np.pi * 7000
                                       * np.arange(48000) / 16000), 16000),
    "tone_8k": (lambda: np.sin(np.arange(16000) / 3.0), 8000),
    "silence": (lambda: np.zeros(4000), 8000),
}


@pytest.mark.parametrize("name", list(SIGNALS))
@pytest.mark.parametrize("highpass", [True, False])
def test_p56_equals_jax(name, highpass):
    make, fs = SIGNALS[name]
    x = make()
    assert plev.active_level(x, fs, highpass) == \
        jlev.active_level(x, fs, highpass)
    y, lev = plev.normalize_active(x, fs, highpass)
    jy, jl = jlev.normalize_active(x, fs, highpass)
    assert lev == jl
    np.testing.assert_array_equal(y, jy)


def test_pair_lists_match_jax(tmp_path):
    files = {f"spk{i}": [f"/data/spk{i}/utt{j}.wav" for j in range(3)]
             for i in range(4)}
    rows = pmix.make_pair_list(files, 10, num_speakers=3, seed=4)
    jrows = jmix.make_pair_list(files, 10, num_speakers=3, seed=4)
    assert [(r.paths, r.snrs, r.name) for r in rows] == \
        [(r.paths, r.snrs, r.name) for r in jrows]
    p, jp = str(tmp_path / "p.txt"), str(tmp_path / "j.txt")
    pmix.write_pair_list(rows, p)
    jmix.write_pair_list(jrows, jp)
    assert open(p).read() == open(jp).read()
    back = pmix.read_pair_list(p)
    assert [(r.paths, r.snrs) for r in back] == \
        [(r.paths, r.snrs) for r in jmix.read_pair_list(p)]


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = path
    return out


def _same_trees(a, b):
    fa, fb = _tree_files(a), _tree_files(b)
    assert sorted(fa) == sorted(fb) and fa
    for rel in fa:
        if rel.endswith(".npz"):
            za, zb = np.load(fa[rel]), np.load(fb[rel])
            assert za.files == zb.files, rel
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
        else:
            assert open(fa[rel], "rb").read() == open(fb[rel], "rb").read(), \
                rel


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Three seeded speech-like sources of different lengths at 16 kHz and
    one at 8 kHz."""
    root = tmp_path_factory.mktemp("src")
    paths = []
    for i, (sec, fs) in enumerate(((3.0, 16000), (2.0, 16000), (2.5, 16000),
                                   (2.2, 8000))):
        p = str(root / f"u{i}.wav")
        write_wav(p, 0.2 * _speechlike(sec, fs, 1.0, seed=10 + i), fs)
        paths.append(p)
    return paths


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("rate", [8000, 16000])
def test_create_mixtures_writes_jax_files(tmp_path, sources, mode, rate):
    rows = [pmix.MixRow((sources[0], sources[1]), (1.5, -1.5)),
            pmix.MixRow((sources[3], sources[2]), (-0.4, 0.4))]
    jrows = [jmix.MixRow(r.paths, r.snrs) for r in rows]
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert pmix.create_mixtures(rows, a, rate, mode=mode) == \
        jmix.create_mixtures(jrows, b, rate, mode=mode)
    _same_trees(a, b)


def test_three_speakers_and_multi_variants(tmp_path, sources):
    rows = [pmix.MixRow(tuple(sources[:3]), (1.0, -1.0, 0.5))]
    jrows = [jmix.MixRow(r.paths, r.snrs) for r in rows]
    a, b = str(tmp_path / "p3"), str(tmp_path / "j3")
    pmix.create_mixtures(rows, a, 8000, mode="max")
    jmix.create_mixtures(jrows, b, 8000, mode="max")
    _same_trees(a, b)
    assert os.path.exists(os.path.join(a, "s3"))
    rows = [pmix.MixRow((sources[1], sources[3]), (0.7, -0.7))]
    jrows = [jmix.MixRow(r.paths, r.snrs) for r in rows]
    a, b = str(tmp_path / "pm"), str(tmp_path / "jm")
    pmix.create_mixtures_multi(rows, a, split="tr")
    jmix.create_mixtures_multi(jrows, b, split="tr")
    _same_trees(a, b)
    assert sorted(os.listdir(a)) == ["wav16k", "wav8k"]


def test_flac_to_wav_refuses_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg not found"):
        pmix.flac_to_wav(str(tmp_path), str(tmp_path / "out"))


def _write_wv1(path, x, sr=8000):
    payload = jsh.encode(x, ftype=jsh.TYPE_S16HL)
    header = ("NIST_1A\n   1024\n"
              f"sample_count -i {len(x)}\n"
              f"sample_rate -i {sr}\n"
              "channel_count -i 1\n"
              "sample_n_bytes -i 2\n"
              "sample_byte_format -s2 10\n"
              "sample_coding -s24 pcm,embedded-shorten-v2\n"
              "end_head\n").encode()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)) + payload)


def _fake_disc(root, sr=8000):
    """A shorten .wv1 tree in the WSJ0 disc layout, and MERL-style list
    entries for it."""
    rng = np.random.default_rng(3)
    utts = {}
    for set_, spk, utt in [("si_tr_s", "011", "011c0201"),
                           ("si_tr_s", "012", "012c0202"),
                           ("si_dt_05", "013", "013c0203"),
                           ("si_dt_05", "014", "014c0204"),
                           ("si_et_05", "015", "015c0205"),
                           ("si_et_05", "016", "016c0206")]:
        t = np.arange(int(rng.uniform(1.5, 2.5) * sr)) / sr
        x = (6000 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)
             + rng.normal(0, 150, t.size)).astype(np.int16)
        _write_wv1(os.path.join(root, "disc1", "wsj0", set_, spk,
                                utt + ".wv1"), x, sr)
        utts[(set_, spk)] = f"wsj0/{set_}/{spk}/{utt}.wv1"
    return utts


def _lists(root, utts):
    os.makedirs(root, exist_ok=True)
    for split, (a, b), snr in (("tr", ("011", "012"), 1.5),
                               ("cv", ("013", "014"), 0.7),
                               ("tt", ("015", "016"), 0.2)):
        set_ = {"tr": "si_tr_s", "cv": "si_dt_05", "tt": "si_et_05"}[split]
        with open(os.path.join(root, f"mix_2_spk_{split}.txt"), "w") as f:
            f.write(f"{utts[(set_, a)]} {snr} {utts[(set_, b)]} {-snr}\n")
    return root


def test_prepare_wsj0_writes_jax_files(tmp_path):
    disc = str(tmp_path / "discs")
    lists = _lists(str(tmp_path / "lists"), _fake_disc(disc))
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(sample_rates=(8000,), modes=("min", "max"), verbose=False)
    assert pwsj0.prepare_wsj0(disc, lists, a, **kw) == \
        jwsj0.prepare_wsj0(disc, lists, b, **kw) == \
        {"tr": 1, "cv": 1, "tt": 1}
    _same_trees(a, b)
    assert os.path.exists(os.path.join(a, "wsj0-wav", "si_tr_s", "011",
                                       "011c0201.wav"))


def test_prepare_wsj0_missing_source_fails_clearly(tmp_path):
    disc = str(tmp_path / "discs")
    _fake_disc(disc)
    lists = tmp_path / "lists"
    lists.mkdir()
    (lists / "mix_2_spk_tr.txt").write_text(
        "wsj0/si_tr_s/999/nonexistent.wv1 1.0 "
        "wsj0/si_tr_s/011/011c0201.wv1 -1.0\n")
    with pytest.raises(FileNotFoundError, match="not found"):
        pwsj0.prepare_wsj0(disc, str(lists), str(tmp_path / "o"),
                           sample_rates=(8000,), modes=("min",),
                           splits=("tr",), verbose=False)


def test_cli_prepare(tmp_path, sources, capsys, monkeypatch):
    """``cli prepare`` with a pair list (one variant and all four) and with
    a WSJ0 disc tree writes what the JAX CLI writes; missing arguments
    exit 2 with JAX's messages."""
    monkeypatch.setenv("CONVTASNET_COMPILE_CACHE", "0")   # the JAX CLI's
    pairs = str(tmp_path / "pairs.txt")
    with open(pairs, "w") as f:
        f.write(f"{os.path.basename(sources[0])} 1.2 "
                f"{os.path.basename(sources[1])} -1.2\n")
    root = os.path.dirname(sources[0])
    for extra in ([], ["--mode", "max", "--sample-rate", "16000"],
                  ["--all-variants", "1"]):
        args = ["prepare", "--pair-list", pairs, "--source-root", root,
                *extra]
        a, b = str(tmp_path / "pa"), str(tmp_path / "ja")
        assert cli.main(args + ["--out-dir", a]) == 0
        out = capsys.readouterr().out
        assert jcli.main(args + ["--out-dir", b]) == 0
        assert capsys.readouterr().out.replace(b, a) == out
        _same_trees(a, b)
        for d in (a, b):
            shutil.rmtree(d)
    disc = str(tmp_path / "discs")
    lists = _lists(str(tmp_path / "lists"), _fake_disc(disc))
    a = str(tmp_path / "wsj")
    assert cli.main(["prepare", "--wsj0-root", disc, "--lists-dir", lists,
                     "--out-dir", a]) == 0
    assert "wsj0 stage 0 complete: 3 mixtures (tr=1, cv=1, tt=1)" in \
        capsys.readouterr().out
    assert sorted(os.listdir(a)) == ["wav16k", "wav8k", "wsj0-wav"]
    assert cli.main(["prepare", "--wsj0-root", disc, "--out-dir", a]) == 2
    assert "--wsj0-root requires --lists-dir" in capsys.readouterr().err
    assert cli.main(["prepare", "--out-dir", a]) == 2
    assert "either --pair-list or --wsj0-root is required" in \
        capsys.readouterr().err
