"""The port's TCN tensor parallelism (``parallel/``) against the JAX
package's (``convtasnet_tpu/parallel/tensor_parallel.py``).

- ``tp_forward`` against JAX's jitted ``tp_forward`` on a (1 data x m
  model) mesh of virtual CPU devices with ``use_pallas=False`` (JAX's
  interpret-mode whole forward is a slow test there): gLN from one bridged
  JAX variables tree at m = 2 and 4, gLN with shards wider than 512
  channels (H = 1152 at m = 2), and the causal cLN model at m = 2, f32
  within 1e-5 relative L2.
- Against the port's own unsharded model (itself held against JAX): BN
  with running statistics, a softmax mask head over three speakers, and
  gLN in bf16 (4e-2); the per-norm decomposition of a gLN model against
  its stage-split one.
- One TP train step against JAX's ``make_tcn_tp_train_step`` on a 1 x 4
  mesh, gLN and cLN: loss within 1e-5, gradient norm within 1e-4, every
  parameter as ``tests/test_torch_train.py`` holds them (2e-5 absolute).
- ``cli train --n-model 2 --device cpu`` for one tiny epoch, then its
  package served by ``separate(..., tensor_parallel=2)``, against the
  unsharded ``separate`` within 2 PCM-16 steps.

JAX runs under ``jax.jit``, once per case (module-scoped fixtures).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig, SolverConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu.parallel import tensor_parallel as jtp
from convtasnet_tpu.parallel.mesh import make_mesh
from convtasnet_tpu.train import train_step as jts
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.parallel import tensor_parallel as ptp
from convtasnet_tpu_torch.parallel.mesh import describe_placement, shard_devices
from convtasnet_tpu_torch.train import train_step as pts

# tests/test_tcn_tp.py's TINY
TINY = ConvTasNetConfig(n_filters=16, kernel_size=8, bottleneck=12,
                        hidden=32, conv_kernel=3, num_blocks=3, num_repeats=2,
                        num_speakers=2)
T = 1600


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mixture(M=2, seed=1):
    return np.random.default_rng(seed).standard_normal((M, T)).astype(
        np.float32)


def _jax_forward(cfg, variables, mix, n_model):
    mesh = make_mesh(n_data=1, n_model=n_model)
    return np.asarray(jax.device_get(jax.jit(
        lambda v, x: jtp.tp_forward(cfg, v, x, mesh))(variables,
                                                      jnp.asarray(mix))))


@pytest.fixture(scope="module")
def gln_case():
    """A gLN JAX model's variables, bridged once, and JAX's tp_forward of
    a mixture over four shards."""
    variables = jax.device_get(jmodel.init_params(
        TINY, jax.random.PRNGKey(0), example_len=T))
    mix = _mixture()
    return dict(sd=state_dict_from_jax(variables, TINY), mix=mix,
                want=_jax_forward(TINY, variables, mix, 4))


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_forward_gln_matches_jax(gln_case, n_model):
    """One bridged tree serves JAX's output through the port's tp_forward
    at two and four shards."""
    got = ptp.tp_forward(TINY, gln_case["sd"],
                         torch.from_numpy(gln_case["mix"]),
                         shard_devices(n_model, "cpu"))
    assert got.dtype == torch.float32
    assert got.shape == gln_case["want"].shape
    assert _rel(got.numpy(), gln_case["want"]) <= 1e-5


def test_tp_forward_wide_shards_match_jax():
    """Shards wider than 512 channels (H = 1152 over two: Hs = 576, B6's
    wide route on the card; its twin here) serve JAX's output."""
    cfg = dataclasses.replace(TINY, hidden=1152, num_repeats=1)
    variables = jax.device_get(jmodel.init_params(
        cfg, jax.random.PRNGKey(5), example_len=T))
    mix = _mixture(seed=8)
    want = _jax_forward(cfg, variables, mix, 2)
    got = ptp.tp_forward(cfg, state_dict_from_jax(variables, cfg),
                         torch.from_numpy(mix), shard_devices(2, "cpu"))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


def test_tp_forward_causal_cln_matches_jax():
    cfg = dataclasses.replace(TINY, norm_type="cLN", causal=True)
    variables = jax.device_get(jmodel.init_params(
        cfg, jax.random.PRNGKey(3), example_len=T))
    mix = _mixture(seed=4)
    want = _jax_forward(cfg, variables, mix, 2)
    got = ptp.tp_forward(cfg, state_dict_from_jax(variables, cfg),
                         torch.from_numpy(mix), shard_devices(2, "cpu"))
    assert _rel(got.numpy(), want) <= 1e-5


def _unsharded(cfg, seed=0, randomise_bn=False):
    model = ConvTasNet(cfg, generator=torch.Generator().manual_seed(seed))
    model.eval()
    if randomise_bn:   # running statistics away from 0 / 1
        g = torch.Generator().manual_seed(seed + 1)
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + (
                0.5 if name.endswith("var") else -0.5))
    return model


@pytest.mark.parametrize("case", ["gLN", "BN", "softmax C=3", "bf16"])
def test_tp_forward_matches_the_unsharded_model(case):
    """gLN over two shards, BN (eval, random running statistics) over four,
    a softmax mask head over three speakers, f32 within 1e-5; the bf16
    gLN model within 4e-2."""
    cfg, n_model, bar = TINY, 2, 1e-5
    if case == "BN":
        cfg, n_model = dataclasses.replace(TINY, norm_type="BN"), 4
    elif case == "softmax C=3":
        cfg = dataclasses.replace(TINY, num_speakers=3,
                                  mask_nonlinear="softmax")
    elif case == "bf16":
        cfg, bar = dataclasses.replace(TINY, compute_dtype="bfloat16"), 4e-2
    model = _unsharded(cfg, randomise_bn=case == "BN")
    mix = torch.from_numpy(_mixture(M=3, seed=5))
    with torch.no_grad():
        want = model(mix)
        got = ptp.tp_forward(cfg, model.state_dict(), mix,
                             shard_devices(n_model, "cpu"))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want.numpy()) <= bar


def test_generic_path_agrees_with_the_stage_split():
    """The per-norm decomposition run on a gLN model (its _norm_tp gLN
    branch) equals the stage-split one."""
    model = _unsharded(TINY)
    mix = torch.from_numpy(_mixture(seed=6))
    devices = shard_devices(4, "cpu")
    sd = model.state_dict()
    with torch.no_grad():
        split = ptp.tp_forward(TINY, sd, mix, devices)
        generic = ptp._tp_forward_generic(
            TINY, sd, ptp.shard_variables(TINY, sd, devices), devices, mix)
    assert _rel(generic.numpy(), split.numpy()) <= 1e-5


def _batch(seed, M=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, T)).astype(np.float32),
            np.full((M,), T, np.int32),
            rng.standard_normal((M, 2, T)).astype(np.float32),
            np.ones((M,), np.float32))


@pytest.fixture(scope="module", params=["gLN", "cLN"])
def step_case(request):
    """One JAX TP train step on a 1 x 4 mesh from a fresh init, jitted
    once: the state before (bridged) and after, and its metrics."""
    cfg = dataclasses.replace(TINY, norm_type=request.param,
                              causal=request.param == "cLN")
    solver = SolverConfig(lr=1e-3, max_grad_norm=5.0, save_folder="")
    state, tx = jts.create_train_state(cfg, solver, jax.random.PRNGKey(0), T)
    sd = state_dict_from_jax(jax.device_get({"params": state.params}), cfg)
    step = jtp.make_tcn_tp_train_step(cfg, tx, make_mesh(n_data=1, n_model=4),
                                      donate=False)
    b = _batch(7)
    new, metrics = step(state, tuple(jnp.asarray(a) for a in b))
    after = state_dict_from_jax(jax.device_get({"params": new.params}), cfg)
    return dict(cfg=cfg, solver=solver, sd=sd, after=after, batch=b,
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


def test_tp_train_step_matches_jax(step_case):
    cfg = step_case["cfg"]
    ps = pts.create_train_state(cfg, step_case["solver"],
                                state_dict=step_case["sd"], use_pallas=False)
    step = ptp.make_tcn_tp_train_step(cfg, shard_devices(4, "cpu"))
    ps, m = step(ps, tuple(torch.from_numpy(a) for a in step_case["batch"]))
    np.testing.assert_allclose(float(m["loss"]), step_case["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), step_case["grad_norm"],
                               rtol=1e-4)
    assert step_case["grad_norm"] > step_case["solver"].max_grad_norm
    got = ps.model.state_dict()
    assert set(got) == set(step_case["after"]) and ps.step == 1
    for k, want in step_case["after"].items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)


def test_tp_train_step_multi_and_refusals():
    """``.multi`` runs its batches in turn; BN and the dual-path family
    are refused, as in JAX (the latter names its own step,
    ``make_dpt_tp_train_step``), and ``tp_forward`` serves a dual-path
    config through ``dpt_tp_forward``."""
    devices = shard_devices(2, "cpu")
    ps = pts.create_train_state(TINY, SolverConfig(), use_pallas=False)
    step = ptp.make_tcn_tp_train_step(TINY, devices)
    batches = [tuple(torch.from_numpy(a) for a in _batch(s, M=2))
               for s in (1, 2)]
    ps, m = step.multi(ps, batches)
    assert ps.step == 2 and m["loss"].shape == (2,)
    assert torch.isfinite(m["loss"]).all()
    with pytest.raises(ValueError, match="BN"):
        ptp.make_tcn_tp_train_step(
            dataclasses.replace(TINY, norm_type="BN"), devices)
    dpt = dataclasses.replace(TINY, separator="dpt", bottleneck=64,
                              dpt_chunk=16, dpt_layers=1, dpt_heads=2,
                              dpt_ff=128)
    with pytest.raises(ValueError, match="make_dpt_tp_train_step"):
        ptp.make_tcn_tp_train_step(dpt, devices)
    sd = ConvTasNet(dpt, generator=torch.Generator().manual_seed(0)
                    ).state_dict()
    with torch.no_grad():
        est = ptp.tp_forward(dpt, sd, torch.ones(1, T), devices)
    assert est.shape == (1, 2, T) and torch.isfinite(est).all()
    with pytest.raises(ValueError, match="does not split"):
        ptp.shard_variables(TINY, {}, shard_devices(3, "cpu"))


def test_shard_placement():
    assert shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert describe_placement(shard_devices(2, "cpu")) == (
        "tensor parallel over 2 shards: shard 0 on cpu, shard 1 on cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            shard_devices(2, "cuda")


def test_cli_train_n_model_then_separate_tensor_parallel(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``cli train --n-model 2 --device cpu``: one epoch of two steps and a
    cv pass, every forward through ``tp_forward`` over two shards; its
    package then serves through ``separate(..., tensor_parallel=2)``,
    within 2 PCM-16 steps of the unsharded ``separate``."""
    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav
    from convtasnet_tpu_torch.infer import separate as separate_mod
    from convtasnet_tpu_torch.infer.separate import separate
    from tests.test_data import _write_corpus

    calls = []
    real = ptp.tp_forward

    def counting(cfg, variables, mixture, devices, use_pallas=None):
        calls.append(len(devices))
        return real(cfg, variables, mixture, devices, use_pallas)

    monkeypatch.setattr(ptp, "tp_forward", counting)
    monkeypatch.setattr(separate_mod, "tp_forward", counting)
    monkeypatch.setenv("CONVTASNET_SEGMENT_CACHE", "0")
    root, json_dir = str(tmp_path / "wavs"), str(tmp_path / "json")
    _write_corpus(root, [8000] * 2, split="tr", seed=0)   # 4 segments
    _write_corpus(root, [4000], split="cv", seed=1)
    assert cli.main(["preprocess", "--data-dir", root, "--out-dir",
                     json_dir]) == 0
    out = str(tmp_path / "exp")
    assert cli.main([
        "train", "--train-dir", os.path.join(json_dir, "tr"),
        "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder", out,
        "--device", "cpu", "--n-model", "2", "--N", "16", "--L", "8",
        "--B", "12", "--H", "24", "--X", "2", "--R", "1", "--segment", "0.5",
        "--batch-size", "2", "--epochs", "1", "--print-freq", "1",
        "--num-workers", "1"]) == 0
    printed = capsys.readouterr().out
    assert ("tensor parallel over 2 shards: shard 0 on cpu, shard 1 on cpu"
            in printed)
    assert calls == [2, 2, 2]   # two train steps, one cv batch
    pkg = os.path.join(out, "final.ckpt")
    mix_dir = os.path.join(root, "cv", "mix")
    calls.clear()
    assert separate(pkg, str(tmp_path / "tp"), mix_dir=mix_dir,
                    tensor_parallel=2, device="cpu") == 1
    assert calls == [2]
    assert separate(pkg, str(tmp_path / "one"), mix_dir=mix_dir,
                    device="cpu") == 1
    for c in (1, 2):
        a = read_wav(str(tmp_path / "tp" / f"utt000_s{c}.wav"))[0]
        b = read_wav(str(tmp_path / "one" / f"utt000_s{c}.wav"))[0]
        assert a.shape == b.shape == (4000,)
        assert np.isfinite(a).all() and np.abs(a).max() > 0
        assert np.abs(a - b).max() <= 2.0 / 32768
