"""The port's streaming separator against the JAX package's.

The JAX streaming test's causal config (``tests/test_streaming.py``) and
one set of weights, carried into the port by ``state_dict_from_jax``: the
port's ``stream_step`` against JAX's ``stream_step`` chunk by chunk, on
the output and on every leaf of the carried state, at that test's bars
(rtol 1e-4, atol 1e-5); the stream plus ``stream_flush`` against the
port's own offline causal forward on the left-padded input; then the
serving entry points (``stream_demo``, ``cli stream-demo``, ``cli
separate --streaming 1``) end to end on the CPU, whose wavs hold the
port's stream.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.models import streaming as jstream
from convtasnet_tpu.models.conv_tasnet import init_params as jax_init
from convtasnet_tpu_torch import cli
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.data.audio_io import read_wav, write_wav
from convtasnet_tpu_torch.infer.stream_demo import stream_demo
from convtasnet_tpu_torch.models import streaming as pstream
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.train.checkpoint import save_inference_package
from tests.test_torch_model import _jax_variables

CAUSAL = dict(n_filters=16, kernel_size=8, bottleneck=12, hidden=24,
              conv_kernel=3, num_blocks=3, num_repeats=2, num_speakers=2,
              causal=True)
LSB = 1.0 / 32768.0


def _setup(norm_type, seed=0):
    """(JAX config, port config, flax variables, port state_dict). cLN
    takes JAX's own init, as the JAX test does; BN takes seeded random
    leaves, so that its running statistics count."""
    jcfg = JaxConfig(**CAUSAL, norm_type=norm_type)
    if norm_type == "BN":
        variables = _jax_variables(jcfg, seed)
    else:
        variables = jax.device_get(
            jax_init(jcfg, jax.random.PRNGKey(seed), example_len=1600))
    pcfg = ConvTasNetConfig.from_dict(jcfg.to_dict())
    return jcfg, pcfg, variables, state_dict_from_jax(variables, pcfg)


def _offline(cfg, sd, x):
    """The port's offline causal forward (plain ops, f32) on ``x`` left-
    padded with L - hop zeros: the stream's alignment contract."""
    model = ConvTasNet(cfg, use_pallas=False)
    model.load_state_dict(sd)
    model.eval()
    pad = cfg.kernel_size - cfg.stride
    with torch.no_grad():
        return model(torch.nn.functional.pad(torch.from_numpy(x),
                                             (pad, 0))).numpy()


def _stream(cfg, sd, x, chunks):
    state = pstream.init_stream_state(cfg, x.shape[0])
    outs, off = [], 0
    for c in chunks:
        state, out = pstream.stream_step(
            cfg, sd, state, torch.from_numpy(x[:, off:off + c]))
        outs.append(out.numpy())
        off += c
    outs.append(pstream.stream_flush(cfg, state).numpy())
    return np.concatenate(outs, axis=-1)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("norm_type", ["cLN", "BN"])
@pytest.mark.parametrize("chunks", [[400, 400, 800], [80, 80, 80, 1360],
                                    [1600]])
def test_stream_step_matches_jax(chunks, norm_type):
    """Output and carried state after every step."""
    jcfg, pcfg, variables, sd = _setup(norm_type)
    x = np.random.default_rng(1).standard_normal((2, 1600)).astype(np.float32)
    jstep = jax.jit(functools.partial(jstream.stream_step, jcfg))
    jstate = jstream.init_stream_state(jcfg, batch_size=2)
    pstate = pstream.init_stream_state(pcfg, 2)
    off = 0
    for c in chunks:
        jstate, jout = jstep(variables, jstate, jnp.asarray(x[:, off:off + c]))
        pstate, pout = pstream.stream_step(pcfg, sd, pstate,
                                           torch.from_numpy(x[:, off:off + c]))
        off += c
        assert pout.shape == (2, 2, c) and pout.dtype == torch.float32
        _close(pout.numpy(), jout)
        for key in ("sample_carry", "ola_carry"):
            _close(pstate[key].numpy(), jstate[key])
        assert set(pstate["blocks"]) == set(jstate["blocks"])
        for name, buf in pstate["blocks"].items():
            assert buf.shape == jstate["blocks"][name].shape, name
            _close(buf.numpy(), jstate["blocks"][name])
    _close(pstream.stream_flush(pcfg, pstate).numpy(),
           jstream.stream_flush(jcfg, jstate))


@pytest.mark.parametrize("norm_type", ["cLN", "BN"])
def test_stream_matches_offline_causal_forward(norm_type):
    """The whole stream plus the flush against the port's offline causal
    forward on the left-padded input: the same math in f32, summed in
    another order, so to 1e-5."""
    _, cfg, _, sd = _setup(norm_type, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 1600)).astype(np.float32)
    got = _stream(cfg, sd, x, [400, 80, 1120])
    want = _offline(cfg, sd, x)
    assert got.shape == want.shape == (2, 2, 1600 + cfg.kernel_size
                                       - cfg.stride)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_chunk_independence():
    _, cfg, _, sd = _setup("cLN")
    x = np.random.default_rng(2).standard_normal((1, 800)).astype(np.float32)
    np.testing.assert_allclose(_stream(cfg, sd, x, [800]),
                               _stream(cfg, sd, x, [40] * 20),
                               rtol=1e-4, atol=1e-6)


def test_stream_scan_matches_stepping():
    _, cfg, _, sd = _setup("cLN")
    x = np.random.default_rng(5).standard_normal((2, 1600)).astype(np.float32)
    chunks = torch.from_numpy(x).reshape(2, 10, 160).transpose(0, 1)
    state = pstream.init_stream_state(cfg, 2)
    want = []
    for chunk in chunks:
        state, out = pstream.stream_step(cfg, sd, state, chunk)
        want.append(out)
    final, got = pstream.stream_scan(cfg, sd, chunks)
    assert got.shape == (10, 2, 2, 160)
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pstream.stream_flush(cfg, final),
                               pstream.stream_flush(cfg, state), rtol=1e-4,
                               atol=1e-5)


def test_separator_handle_and_latency():
    _, cfg, _, sd = _setup("cLN")
    sep = pstream.StreamingSeparator(cfg, sd, batch_size=1, device="cpu")
    assert sep.latency_samples == cfg.kernel_size
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((1, 400)).astype(np.float32))
    out = sep.process(x)
    assert out.shape == (1, 2, 400)
    assert sep.flush().shape == (1, 2, cfg.kernel_size - cfg.stride)
    sep.reset()
    torch.testing.assert_close(sep.process(x), out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="whole hops"):
        sep.process(x[:, :3])


@pytest.mark.parametrize("overrides", [
    dict(norm_type="gLN", causal=False), dict(norm_type="gLN", causal=True),
    dict(norm_type="cLN", causal=False),
    dict(separator="dpt", norm_type="cLN", causal=True)],
    ids=["gLN", "gLN-causal", "cLN-noncausal", "dpt"])
def test_refuses_what_cannot_stream(overrides):
    cfg = ConvTasNetConfig(**{**CAUSAL, **overrides})
    with pytest.raises(ValueError, match="streaming"):
        pstream.init_stream_state(cfg, 1)
    with pytest.raises(ValueError, match="streaming"):
        pstream.StreamingSeparator(cfg, {}, device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        pstream.stream_step(cfg, {}, {}, torch.zeros(1, 8))


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    """A causal cLN inference package and two mixtures of 6000 and 4400
    samples on disk, with the stream of each through the port."""
    root = tmp_path_factory.mktemp("stream")
    _, cfg, _, sd = _setup("cLN", seed=6)
    pkg = str(root / "causal.pt")
    save_inference_package(pkg, cfg, sd)
    mix_dir = root / "mix"
    os.makedirs(mix_dir)
    rng = np.random.default_rng(0)
    for name, T in (("a", 6000), ("b", 4400)):
        x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(T) / 8000)
             + 0.1 * rng.standard_normal(T)).astype(np.float32)
        write_wav(str(mix_dir / f"{name}.wav"), x, 8000)
    return dict(root=root, cfg=cfg, sd=sd, pkg=pkg, mix_dir=str(mix_dir))


def _held_stream(package, name, chunk):
    """The port's stream of one mixture as the file holds it, in chunks of
    ``chunk`` samples with the tail zero-padded, cut to its length."""
    x = read_wav(os.path.join(package["mix_dir"], f"{name}.wav"))[0]
    T = len(x)
    buf = np.zeros((1, -(-T // chunk) * chunk), np.float32)
    buf[0, :T] = x
    sep = pstream.StreamingSeparator(package["cfg"], package["sd"],
                                     device="cpu")
    outs = [sep.process(torch.from_numpy(buf[:, s:s + chunk]))
            for s in range(0, buf.shape[1], chunk)]
    outs.append(sep.flush())
    return torch.cat(outs, dim=-1)[0, :, :T].numpy()


def _assert_wavs_hold(out_dir, package, name, chunk):
    want = _held_stream(package, name, chunk)
    for c in range(2):
        y, sr = read_wav(os.path.join(out_dir, f"{name}_s{c + 1}.wav"))
        assert sr == 8000 and y.shape == want[c].shape
        assert np.abs(y).max() > 10 * LSB      # not silence
        # PCM-16 clipping and truncation: below one step
        np.testing.assert_allclose(y, np.clip(want[c], -1.0, 1.0 - LSB),
                                   rtol=0, atol=LSB * 1.001)


def test_stream_demo_end_to_end(package, tmp_path):
    out_dir = str(tmp_path / "sep")
    stats = stream_demo(package["pkg"],
                        os.path.join(package["mix_dir"], "a.wav"),
                        chunk_ms=20.0, out_dir=out_dir, device="cpu")
    assert set(stats) == {"chunk_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms",
                          "rtf", "deadline_met", "latency_ms"}
    assert stats["chunk_ms"] == 20.0        # 160 samples, whole hops
    assert stats["latency_ms"] == 21.0      # one window (8) + the chunk
    assert 0 < stats["p50_ms"] <= stats["p99_ms"] <= stats["max_ms"]
    _assert_wavs_hold(out_dir, package, "a", 160)


def test_cli_stream_demo(package, tmp_path, capsys):
    out_dir = str(tmp_path / "sep")
    assert cli.main(["stream-demo", "--model-path", package["pkg"],
                     "--wav", os.path.join(package["mix_dir"], "b.wav"),
                     "--chunk-ms", "8", "--out-dir", out_dir,
                     "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["chunk_ms"] == 8.0 and stats["rtf"] > 0
    _assert_wavs_hold(out_dir, package, "b", 64)


def test_cli_separate_streaming(package, tmp_path, capsys):
    out_dir = str(tmp_path / "sep")
    assert cli.main(["separate", "--model-path", package["pkg"],
                     "--mix-dir", package["mix_dir"], "--out-dir", out_dir,
                     "--streaming", "1", "--chunk-seconds", "0.1",
                     "--device", "cpu"]) == 0
    assert "separated 2 utterances" in capsys.readouterr().out
    assert sorted(os.listdir(out_dir)) == [
        "a.wav", "a_s1.wav", "a_s2.wav", "b.wav", "b_s1.wav", "b_s2.wav"]
    for name in ("a", "b"):
        _assert_wavs_hold(out_dir, package, name, 800)


def test_cli_stream_demo_device_cuda_raises_without_cuda(package):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["stream-demo", "--model-path", package["pkg"],
                  "--wav", os.path.join(package["mix_dir"], "a.wav")])
