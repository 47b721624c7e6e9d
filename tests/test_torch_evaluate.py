"""The port's ``evaluate``, ``separate`` and ``bss_eval`` against the JAX
package's, on the CPU.

A JAX-initialised tiny dual-path (DPT) model is saved both as a JAX
checkpoint and, through ``state_dict_from_jax``, as the port's inference
package; both packages then evaluate and separate the same seeded wavs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.infer import bss_eval as jax_bss
from convtasnet_tpu.infer.evaluate import _masked_sisnr_batch
from convtasnet_tpu.infer.evaluate import evaluate as jax_evaluate
from convtasnet_tpu.infer.separate import separate as jax_separate
from convtasnet_tpu.models.conv_tasnet import init_params as jax_init
from convtasnet_tpu.train.checkpoint import save_checkpoint
from convtasnet_tpu_torch import cli
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.data.audio_io import read_wav, write_wav
from convtasnet_tpu_torch.data.manifest import build_manifests
from convtasnet_tpu_torch.infer import bss_eval
from convtasnet_tpu_torch.infer.evaluate import evaluate, masked_sisnr_batch
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.train.checkpoint import save_inference_package

CFG = ConvTasNetConfig(n_filters=32, kernel_size=8, bottleneck=64,
                       separator="dpt", dpt_chunk=16, dpt_layers=1,
                       dpt_heads=2, dpt_ff=128)
LSB = 1.0 / 32768.0


@pytest.fixture(scope="module")
def dpt_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpt_eval")
    variables = jax.device_get(jax_init(JaxConfig(**CFG.to_dict()),
                                        jax.random.PRNGKey(0),
                                        example_len=800))
    jax_ckpt = str(root / "dpt.ckpt")
    save_checkpoint(jax_ckpt, {"params": variables["params"]},
                    JaxConfig(**CFG.to_dict()), epoch=1)
    pkg = str(root / "dpt.pt")
    save_inference_package(pkg, CFG, state_dict_from_jax(variables, CFG))
    rng = np.random.default_rng(0)
    for part in ("mix", "s1", "s2"):
        os.makedirs(root / "wav" / "tt" / part)
    for i, n in enumerate((2400, 3200, 4000)):
        t = np.arange(n) / 8000
        s1 = 0.3 * np.sin(2 * np.pi * (300 + 100 * i) * t)
        s2 = 0.1 * rng.standard_normal(n)
        for part, sig in (("mix", s1 + s2), ("s1", s1), ("s2", s2)):
            write_wav(str(root / "wav" / "tt" / part / f"u{i}.wav"),
                      sig.astype(np.float32), 8000)
    build_manifests(str(root / "wav"), str(root / "json"), 8000,
                    splits=("tt",))
    return dict(root=root, jax_ckpt=jax_ckpt, pkg=pkg,
                tt=str(root / "json" / "tt"),
                mix_dir=str(root / "wav" / "tt" / "mix"))


def test_evaluate_matches_jax(dpt_dirs):
    """SI-SNRi and SDRi of the DPT package, port against JAX, within
    1e-3 dB."""
    kw = dict(batch_size=2, cal_sdr=True, verbose=False)
    got = evaluate(dpt_dirs["pkg"], dpt_dirs["tt"], device="cpu", **kw)
    want = jax_evaluate(dpt_dirs["jax_ckpt"], dpt_dirs["tt"], **kw)
    assert set(got) == {"si_snri", "sdri"}
    for key in got:
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= 1e-3, (key, got, want)


def test_cli_evaluate_and_separate_dpt_package(dpt_dirs, capsys):
    """``cli evaluate`` prints the result as JSON; ``cli separate`` writes
    the DPT package's wavs, within 2 PCM-16 steps of the JAX package's."""
    assert cli.main(["evaluate", "--model-path", dpt_dirs["pkg"],
                     "--data-dir", dpt_dirs["tt"], "--batch-size", "3",
                     "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = evaluate(dpt_dirs["pkg"], dpt_dirs["tt"], batch_size=1,
                    device="cpu", verbose=False)
    assert abs(res["si_snri"] - want["si_snri"]) <= 1e-4
    out_port = str(dpt_dirs["root"] / "out_port")
    out_jax = str(dpt_dirs["root"] / "out_jax")
    assert cli.main(["separate", "--model-path", dpt_dirs["pkg"],
                     "--mix-dir", dpt_dirs["mix_dir"], "--out-dir", out_port,
                     "--batch-size", "2", "--device", "cpu"]) == 0
    assert jax_separate(dpt_dirs["jax_ckpt"], out_jax,
                        mix_dir=dpt_dirs["mix_dir"], batch_size=2) == 3
    names = sorted(os.listdir(out_jax))
    assert names == sorted(os.listdir(out_port)) and len(names) == 9
    for name in names:
        a = read_wav(os.path.join(out_port, name))[0]
        b = read_wav(os.path.join(out_jax, name))[0]
        assert a.shape == b.shape and np.abs(a).max() > 100 * LSB
        assert np.abs(a - b).max() <= 2 * LSB, name


def test_evaluate_device_cuda_raises_without_cuda(dpt_dirs):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate(dpt_dirs["pkg"], dpt_dirs["tt"], verbose=False)


def test_masked_sisnr_matches_jax():
    rng = np.random.default_rng(1)
    src = rng.standard_normal((3, 2, 500)).astype(np.float32)
    est = (src[:, ::-1] + 0.3 * rng.standard_normal((3, 2, 500))).astype(
        np.float32)
    mix = src.sum(1)
    lengths = np.array([500, 321, 77], np.int32)
    got = masked_sisnr_batch(*(torch.from_numpy(a) for a in
                               (est, src, mix, lengths)))
    want = _masked_sisnr_batch(*(jnp.asarray(a) for a in
                                 (est, src, mix, lengths)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("C", [2, 3])
def test_bss_eval_matches_jax_copy(C):
    rng = np.random.default_rng(C)
    refs = rng.standard_normal((C, 1500))
    ests = refs[::-1] + 0.5 * rng.standard_normal((C, 1500))
    for perm in (True, False):
        got = bss_eval.bss_eval_sources(refs, ests, compute_permutation=perm)
        want = jax_bss.bss_eval_sources(refs, ests, compute_permutation=perm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="shapes differ"):
        bss_eval.bss_eval_sources(refs, ests[:, :100])
