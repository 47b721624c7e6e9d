"""The port's ConvTasNet against the JAX model, on the same weights.

The weights are a flax variables tree; ``state_dict_from_jax`` carries them
into the port; both forward the same seeded numpy mixture in f32 on the
CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet, init_params
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax

SMALL = dict(n_filters=32, bottleneck=32, hidden=64, num_blocks=3,
             num_repeats=2)


def _jax_variables(cfg, seed=0):
    """A flax variables tree of ``cfg``'s model (structure from JAX's own
    init, traced abstractly) filled with seeded numpy weights: random norm
    affines, slopes and BN statistics make every leaf count."""
    tree = jax.eval_shape(
        lambda k: jmodel.init_params(cfg, k, example_len=400),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        r = rng.standard_normal(s.shape).astype(np.float32)
        if name in ("gamma", "var"):
            return (1.0 + 0.1 * np.abs(r)).astype(np.float32)
        if name in ("beta", "mean"):
            return 0.1 * r
        if not s.shape:                        # PReLU slope
            return np.float32(0.25) + 0.05 * r
        return r / np.float32(np.sqrt(s.shape[0]))

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(cfg, T, seed=0):
    variables = _jax_variables(cfg, seed)
    model = ConvTasNet(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    model.eval()
    mix = np.random.default_rng(seed + 1).standard_normal((2, T)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mix))
    return variables, got, mix


def _jax_forward(cfg, variables, mix):
    apply = jax.jit(functools.partial(jmodel.ConvTasNet(cfg).apply,
                                      train=False))
    return np.asarray(apply(variables, jnp.asarray(mix)))


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(norm_type="cLN", causal=True),
    dict(num_speakers=3, mask_nonlinear="softmax"),
], ids=["gLN", "causal-cLN", "C3-softmax"])
def test_small_model_matches_jax_pallas_path(overrides):
    """JAX with use_pallas=True runs every block through the Pallas kernel
    (interpret mode on the CPU); the port runs its plain ops on the CPU."""
    cfg = ConvTasNetConfig(**SMALL, **overrides)
    variables, got, mix = _pair(cfg, T=800)
    want = _jax_forward(dataclasses.replace(cfg, use_pallas=True), variables,
                        mix)
    assert got.dtype == torch.float32 and got.shape == (2, cfg.num_speakers,
                                                         800)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)


def test_paper_width_matches_jax():
    """Paper config (N=256 B=256 H=512 X=8 R=4) at the repo's parity bar
    (tests/test_torch_import.py, atol 5e-4)."""
    cfg = ConvTasNetConfig()
    variables, got, mix = _pair(cfg, T=1600, seed=3)
    np.testing.assert_allclose(got.numpy(), _jax_forward(cfg, variables, mix),
                               rtol=1e-3, atol=5e-4)


def test_bn_model_matches_jax():
    """BN running statistics travel as buffers through the bridge; in
    training mode the forward normalises with batch statistics and
    updates the running ones as ``apply(train=True,
    mutable=["batch_stats"])`` does."""
    cfg = ConvTasNetConfig(**SMALL, norm_type="BN")
    variables, got, mix = _pair(cfg, T=800)
    np.testing.assert_allclose(got.numpy(), _jax_forward(cfg, variables, mix),
                               rtol=1e-3, atol=2e-4)
    want, updates = jmodel.ConvTasNet(cfg).apply(
        variables, jnp.asarray(mix), train=True, mutable=["batch_stats"])
    model = ConvTasNet(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    model.train()
    with torch.no_grad():
        got_train = model(torch.from_numpy(mix))
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want),
                               rtol=1e-3, atol=2e-4)
    new_stats = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": updates["batch_stats"]},
        cfg)
    buffers = dict(model.named_buffers())
    assert buffers
    for name, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), new_stats[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("norm_type", ["gLN", "BN"])
def test_init_params_names_and_shapes_follow_jax(norm_type):
    cfg = ConvTasNetConfig(**SMALL, norm_type=norm_type)
    variables = jax.device_get(
        jmodel.init_params(cfg, jax.random.PRNGKey(0), example_len=800))
    want = state_dict_from_jax(variables, cfg)
    got = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert "separator.block_r1_x2.conv1x1" in got
    assert got["separator.block_r0_x0.prelu1"].item() == 0.25
    assert torch.equal(got["separator.block_r0_x0.norm1.gamma"],
                       torch.ones(64))
    assert torch.equal(got["separator.block_r0_x0.norm2.beta"],
                       torch.zeros(64))
    # Xavier-normal std of the 1x1 conv B->H
    std = got["separator.block_r0_x0.conv1x1"].std().item()
    assert abs(std - np.sqrt(2.0 / (32 + 64))) < 0.03
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_bridge_rejects_wrong_config():
    cfg = ConvTasNetConfig(**SMALL)
    variables = _jax_variables(cfg)
    with pytest.raises(KeyError):
        state_dict_from_jax(variables, dataclasses.replace(cfg, num_blocks=4))
    with pytest.raises(ValueError):
        state_dict_from_jax(variables, dataclasses.replace(cfg, hidden=32))


def test_dual_path_not_ported():
    """The DPT serving and training paths are ported
    (tests/test_torch_dpt_model.py, tests/test_torch_dpt_train.py): with
    the kernels forced, a DPT forward under gradients runs the
    differentiable kernels, which take CUDA tensors only, so on the CPU it
    raises the CUDA-tensor error and no ROADMAP refusal; with use_pallas
    unset the CPU takes the plain path, and a backward reaches every
    parameter."""
    cfg = ConvTasNetConfig(n_filters=16, kernel_size=8, bottleneck=64,
                           separator="dpt", dpt_chunk=16, dpt_layers=1,
                           dpt_ff=64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ConvTasNet(cfg, use_pallas=True)(torch.zeros(1, 400))
    model = ConvTasNet(cfg)
    mix = torch.randn(1, 400, generator=torch.Generator().manual_seed(0))
    model(mix).square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
