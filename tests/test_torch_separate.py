"""The port's serving slice end to end against the JAX package's.

A JAX-initialised small model is saved both as a JAX checkpoint and,
through ``state_dict_from_jax``, as the port's inference package. The
port's CLI (``python -m convtasnet_tpu_torch.cli separate --device cpu``, in
a subprocess) and the JAX ``separate`` then separate the same wavs, and the
written wavs agree to within 2 PCM-16 steps.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig
from convtasnet_tpu.data.audio_io import write_wav
from convtasnet_tpu.infer.separate import separate as jax_separate
from convtasnet_tpu.models.conv_tasnet import init_params as jax_init
from convtasnet_tpu.train.checkpoint import save_checkpoint
from convtasnet_tpu_torch import cli
from convtasnet_tpu_torch.data.audio_io import read_wav
from convtasnet_tpu_torch.infer.separate import separate
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.train.checkpoint import (
    load_params_for_inference,
    save_inference_package,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ConvTasNetConfig(n_filters=32, bottleneck=32, hidden=64, num_blocks=3,
                       num_repeats=2)
LSB = 1.0 / 32768.0


@pytest.fixture(scope="module")
def slice_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    variables = jax.device_get(
        jax_init(CFG, jax.random.PRNGKey(0), example_len=800))
    jax_ckpt = str(root / "model.ckpt")
    save_checkpoint(jax_ckpt, {"params": variables["params"]}, CFG, epoch=3)
    pkg = str(root / "model.pt")
    save_inference_package(pkg, CFG, state_dict_from_jax(variables, CFG),
                           epoch=3)
    mix_dir = root / "mix"
    os.makedirs(mix_dir)
    rng = np.random.default_rng(0)
    for name, n in (("a", 4000), ("b", 5600), ("c", 7200)):
        write_wav(str(mix_dir / f"{name}.wav"),
                  0.1 * rng.standard_normal(n).astype(np.float32), 8000)
    return dict(root=root, jax_ckpt=jax_ckpt, pkg=pkg, mix_dir=str(mix_dir))


def _pcm(path):
    return read_wav(path)[0]


def test_cli_separate_matches_jax_separate(slice_dirs):
    out_port = str(slice_dirs["root"] / "out_port")
    out_jax = str(slice_dirs["root"] / "out_jax")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "convtasnet_tpu_torch.cli", "separate",
         "--model-path", slice_dirs["pkg"], "--mix-dir", slice_dirs["mix_dir"],
         "--out-dir", out_port, "--batch-size", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "separated 3 utterances" in proc.stdout
    assert jax_separate(slice_dirs["jax_ckpt"], out_jax,
                        mix_dir=slice_dirs["mix_dir"], batch_size=2,
                        sample_rate=8000) == 3
    names = sorted(os.listdir(out_jax))
    assert names == sorted(os.listdir(out_port))
    assert len(names) == 9   # 3 mixtures + 3 x 2 speakers
    for name in names:
        a, b = _pcm(os.path.join(out_port, name)), _pcm(
            os.path.join(out_jax, name))
        assert a.shape == b.shape
        assert np.abs(a).max() > 100 * LSB, name   # not silence
        assert np.abs(a - b).max() <= 2 * LSB, name


def test_package_roundtrip_and_formats(slice_dirs, tmp_path):
    cfg, sd = load_params_for_inference(slice_dirs["pkg"])
    assert cfg.to_dict() == CFG.to_dict()
    assert sd["encoder.w"].shape == (CFG.kernel_size, CFG.n_filters)
    with pytest.raises(NotImplementedError, match="JAX"):
        load_params_for_inference(slice_dirs["jax_ckpt"])
    other = str(tmp_path / "other.pt")
    torch.save({"state_dict": {}}, other)
    with pytest.raises(ValueError, match="inference package"):
        load_params_for_inference(other)


def test_separate_refuses_what_is_not_ported(slice_dirs, tmp_path):
    """Sequence parallelism (ROADMAP A8d) raises; a dual-path package
    serves tensor-parallel, as a TCN package does (tests/test_torch_tp.py;
    parity with JAX: tests/test_torch_dpt_tp.py)."""
    from convtasnet_tpu_torch.config import ConvTasNetConfig as PortConfig
    from convtasnet_tpu_torch.models.conv_tasnet import init_params

    kw = dict(mix_dir=slice_dirs["mix_dir"], device="cpu")
    out = str(tmp_path / "out")
    dpt_cfg = PortConfig(separator="dpt", n_filters=16, kernel_size=8,
                         bottleneck=64, dpt_chunk=16, dpt_layers=1,
                         dpt_heads=2, dpt_ff=128)
    dpt_pkg = str(tmp_path / "dpt.pt")
    save_inference_package(dpt_pkg, dpt_cfg, init_params(
        dpt_cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(NotImplementedError, match="ROADMAP A8d"):
        separate(slice_dirs["pkg"], out, sequence_parallel=True, **kw)
    assert separate(dpt_pkg, out, tensor_parallel=2, **kw) == 3
    est = read_wav(os.path.join(out, sorted(
        f for f in os.listdir(out) if f.endswith("_s1.wav"))[0]))[0]
    assert np.isfinite(est).all() and np.abs(est).max() > 0
    with pytest.raises(ValueError, match="CUDA"):
        separate(slice_dirs["pkg"], out, use_pallas=True, **kw)


def test_cli_device_cuda_raises_without_cuda(slice_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["separate", "--model-path", slice_dirs["pkg"],
                  "--mix-dir", slice_dirs["mix_dir"],
                  "--out-dir", str(tmp_path / "out")])
