"""The port's dual-path (DPT) separator and model against the JAX model,
on the same weights: a flax variables tree carried over by
``state_dict_from_jax``, the same seeded numpy mixture, f32 on the CPU,
the JAX model on its XLA path (``use_pallas=False``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet, init_params
from convtasnet_tpu_torch.models.dual_path import DualPathLayer
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax

SMALL = dict(n_filters=32, kernel_size=8, bottleneck=64, separator="dpt",
             dpt_chunk=16, dpt_layers=2, dpt_heads=2, dpt_ff=128)


def _jax_variables(cfg, seed=0):
    """The JAX model's variables tree (its structure from an abstract
    init) filled with seeded numpy weights; random LN affines and biases
    make every leaf count."""
    tree = jax.eval_shape(
        lambda k: jmodel.init_params(JaxConfig(**cfg.to_dict()), k,
                                     example_len=400),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        r = rng.standard_normal(s.shape).astype(np.float32)
        if name == "gamma":
            return (1.0 + 0.1 * r).astype(np.float32)
        if name in ("beta", "bias"):
            return 0.1 * r
        return r / np.float32(np.sqrt(s.shape[0]))

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _forwards(cfg, T, seed=0):
    variables = _jax_variables(cfg, seed)
    model = ConvTasNet(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    model.eval()
    mix = np.random.default_rng(seed + 1).standard_normal((2, T)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mix)).numpy()
    apply = jax.jit(functools.partial(
        jmodel.ConvTasNet(JaxConfig(**cfg.to_dict())).apply, train=False))
    want = np.asarray(apply(variables, jnp.asarray(mix)))
    return got, want


@pytest.mark.parametrize("overrides,T", [
    (dict(), 800),
    (dict(num_speakers=3, mask_nonlinear="softmax", dpt_heads=0), 600),
], ids=["relu-K199", "C3-softmax-auto-heads"])
def test_dpt_model_matches_jax(overrides, T):
    """K = 199 (T=800) or 149 frames: neither a multiple of the chunk, so
    the padded tail and its key mask are on the path."""
    cfg = ConvTasNetConfig(**{**SMALL, **overrides})
    got, want = _forwards(cfg, T)
    assert got.shape == (2, cfg.num_speakers, T)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4)


def test_dpt_model_bf16_is_close_to_jax():
    cfg = ConvTasNetConfig(**SMALL, compute_dtype="bfloat16")
    got, want = _forwards(cfg, 800, seed=2)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert np.isfinite(got).all() and rel <= 4e-2


def test_bridge_and_init_cover_dpt_trees():
    """``state_dict_from_jax`` carries a JAX ``init_params`` tree of a DPT
    config; the port's own init has the same names and shapes, lecun-normal
    projections, xavier-normal mask head, LN 1/0 and zero biases."""
    cfg = ConvTasNetConfig(**SMALL)
    variables = jax.device_get(jmodel.init_params(
        JaxConfig(**cfg.to_dict()), jax.random.PRNGKey(0), example_len=400))
    want = state_dict_from_jax(variables, cfg)
    got = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for name in ("separator.layer_1.intra_att.qkv.kernel",
                 "separator.layer_0.inter_ffn.up.bias",
                 "separator.input_norm.gamma", "separator.mask_conv"):
        assert name in got
    assert torch.equal(got["separator.layer_0.intra_ffn.down.bias"],
                       torch.zeros(64))
    assert torch.equal(got["separator.output_norm.gamma"], torch.ones(64))
    qkv = got["separator.layer_0.inter_att.qkv.kernel"]
    assert abs(qkv.std().item() - 1 / np.sqrt(64)) < 0.01
    assert qkv.abs().max().item() <= 2 / np.sqrt(64) / 0.8796 + 1e-6
    mask = got["separator.mask_conv"]
    assert abs(mask.std().item() - np.sqrt(2 / (64 + 64))) < 0.01
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)
    with pytest.raises(KeyError):
        state_dict_from_jax(variables, dataclasses.replace(cfg, dpt_layers=3))


def test_dual_path_layers_ignore_pad_content():
    """Padded frames may hold anything: the valid outputs of a dual-path
    layer (all four sublayers) do not change with the pad content."""
    M, n, S, B = 2, 3, 16, 64
    layer = DualPathLayer(B, 2, 128, torch.Generator().manual_seed(0))
    K = n * S - 7
    valid = torch.arange(n * S).reshape(n, S) < K
    key_bias = torch.where(valid, 0.0, -1e9)
    x = torch.randn(M, n, S, B, generator=torch.Generator().manual_seed(1))
    x2 = x.clone()
    x2[:, ~valid] = 37.0
    with torch.no_grad():
        out1 = layer(x, key_bias, False)
        out2 = layer(x2, key_bias, False)
    torch.testing.assert_close(out1[:, valid], out2[:, valid], rtol=2e-5,
                               atol=2e-5)


def test_dpt_training_through_kernels_raises():
    """A DPT forward under gradients with the kernels forced runs the
    differentiable kernels (forward and backward), which take CUDA tensors
    only: on the CPU it raises the CUDA-tensor error, as a forward without
    gradients does; with use_pallas=False it trains through the plain
    ops."""
    cfg = ConvTasNetConfig(**SMALL)
    mix = torch.randn(1, 400, generator=torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ConvTasNet(cfg, use_pallas=True)(mix)
    model = ConvTasNet(cfg, use_pallas=False)
    model(mix).square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ConvTasNet(cfg, use_pallas=True)(mix)


def test_dpt_inference_package_roundtrip(tmp_path):
    """A DPT model's inference package rebuilds the same config (the dpt
    fields included) and the same outputs."""
    from convtasnet_tpu_torch.train.checkpoint import (
        load_params_for_inference,
        save_inference_package,
    )

    cfg = ConvTasNetConfig(**SMALL, compute_dtype="bfloat16")
    model = ConvTasNet(cfg, generator=torch.Generator().manual_seed(4)).eval()
    path = str(tmp_path / "dpt.pt")
    save_inference_package(path, cfg, model.state_dict(), epoch=2)
    cfg2, state_dict = load_params_for_inference(path)
    assert cfg2 == cfg and cfg2.dpt_num_heads == 2
    model2 = ConvTasNet(cfg2)
    model2.load_state_dict(state_dict)
    model2.eval()
    mix = torch.randn(1, 600, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        assert torch.equal(model(mix), model2(mix))
