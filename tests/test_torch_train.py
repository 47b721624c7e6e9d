"""The port's train step against the JAX package's ``make_train_step``.

Both sides start from the same weights (a JAX init carried over by
``state_dict_from_jax``; both optimizers start from zero moments) and take
the same seeded numpy batches, in f32 on the CPU with the plain ops
(``use_pallas=False`` on both sides). Tolerances: losses and gradient
norms to 1e-5 relative, parameters to 2e-5 absolute (float32 rounding
over a few steps of the same math).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig, SolverConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu.train import train_step as jts
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.train import train_step as pts

TINY = ConvTasNetConfig(
    n_filters=16, kernel_size=8, bottleneck=12, hidden=24, conv_kernel=3,
    num_blocks=2, num_repeats=2, num_speakers=2, sample_rate=8000)
SOLVER = SolverConfig(lr=1e-3, max_grad_norm=5.0, save_folder="")


def _batch(seed, B=4, T=1600, weights=(1, 1, 1, 0)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)).astype(np.float32),
            np.full((B,), T, np.int32),
            rng.standard_normal((B, 2, T)).astype(np.float32),
            np.asarray(weights, np.float32))


def _jax(b):
    return tuple(jnp.asarray(a) for a in b)


def _torch(b):
    return tuple(torch.from_numpy(np.array(a)) for a in b)


def _pair(cfg=TINY, solver=SOLVER, seed=0):
    js, tx = jts.create_train_state(cfg, solver, jax.random.PRNGKey(seed),
                                    1600)
    sd = state_dict_from_jax(jax.device_get(
        {"params": js.params, "batch_stats": js.batch_stats}), cfg)
    ps = pts.create_train_state(cfg, solver, state_dict=sd,
                                use_pallas=False)
    return js, tx, ps


def _assert_params(cfg, js, ps, atol=2e-5):
    want = state_dict_from_jax(jax.device_get(
        {"params": js.params, "batch_stats": js.batch_stats}), cfg)
    got = ps.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=k)


def test_adam_steps_match_jax():
    """Three Adam steps with clipping engaged (the gradient norms of this
    model on noise batches are far above 5)."""
    js, tx, ps = _pair()
    jstep = jts.make_train_step(TINY, tx, donate=False)
    pstep = pts.make_train_step()
    clipped = 0
    for i in range(3):
        b = _batch(10 + i)
        js, jm = jstep(js, _jax(b))
        ps, pm = pstep(ps, _torch(b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        clipped += float(jm["grad_norm"]) > SOLVER.max_grad_norm
        _assert_params(TINY, js, ps)
    assert clipped >= 1
    assert ps.step == int(js.step) == 3


def _assert_grads_match(cfg, js, ps, b):
    """The port's gradient at the shared weights against ``jax.grad`` of
    the JAX step's loss, to 1e-5 relative L2: every multi-element leaf,
    and the scalar PReLU slopes as one vector (each slope's gradient is a
    sum of cancelling terms, 1e-5 from JAX's alone at these inputs)."""
    model = jmodel.ConvTasNet(cfg)
    jgrads = jax.jit(lambda p, s, bb: jts._loss_and_grads(
        model, p, s, bb, 0)[2])(js.params, js.batch_stats, _jax(b))
    want = state_dict_from_jax(jax.device_get(
        {"params": jgrads, "batch_stats": js.batch_stats}), cfg)
    pts._loss_and_grads(ps.model, _torch(b), 0)
    got = {k: p.grad.double() for k, p in ps.model.named_parameters()}
    assert set(got) <= set(want) and len(got) > 0
    slopes = [k for k in got if got[k].numel() == 1]
    leaves = {k: (got[k], want[k].double()) for k in got if k not in slopes}
    leaves["the PReLU slopes"] = (
        torch.stack([got[k].reshape(()) for k in slopes]),
        torch.stack([want[k].double().reshape(()) for k in slopes]))
    for k, (g, w) in leaves.items():
        err = float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w).clamp_min(1e-30))
        assert err <= 1e-5, f"{k}: relative L2 {err:.3g}"


def test_causal_cln_adam_steps_match_jax():
    """Three Adam steps of the causal cLN model (the streaming model),
    clipping engaged, at the gLN case's bars. Its clipped gradient has
    elements near Adam's eps, whose updates follow the f32 summation
    order: at lr 1e-3 the two frameworks' weights part after two steps
    enough that the third step's gradient norm moves by 1.8e-5, and that
    step's gradients disagree by 4e-5 even at shared weights (the noise
    ``tests/test_torch_dpt_train.py`` describes). So, as there, lr is 1e-4,
    each step starts the port from the JAX step's parameters, and the
    gradient is held against ``jax.grad`` at the shared weights first."""
    import dataclasses

    cfg = dataclasses.replace(TINY, norm_type="cLN", causal=True)
    js, tx, ps = _pair(cfg=cfg, solver=dataclasses.replace(SOLVER, lr=1e-4),
                       seed=8)
    jstep = jts.make_train_step(cfg, tx, donate=False)
    pstep = pts.make_train_step()
    clipped = 0
    for i in range(3):
        b = _batch(90 + i)
        _assert_grads_match(cfg, js, ps, b)
        js, jm = jstep(js, _jax(b))
        ps, pm = pstep(ps, _torch(b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        clipped += float(jm["grad_norm"]) > SOLVER.max_grad_norm
        _assert_params(cfg, js, ps)
        ps.model.load_state_dict(state_dict_from_jax(jax.device_get(
            {"params": js.params, "batch_stats": js.batch_stats}), cfg))
    assert clipped >= 1
    assert ps.step == int(js.step) == 3


def test_sgd_momentum_l2_matches_jax():
    solver = SolverConfig(optimizer="sgd", lr=1e-2, momentum=0.9, l2=1e-3,
                          max_grad_norm=5.0, save_folder="")
    js, tx, ps = _pair(solver=solver, seed=1)
    jstep = jts.make_train_step(TINY, tx, donate=False)
    pstep = pts.make_train_step()
    for i in range(2):
        b = _batch(20 + i)
        js, jm = jstep(js, _jax(b))
        ps, pm = pstep(ps, _torch(b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _assert_params(TINY, js, ps)


def test_set_lr_takes_effect():
    js, tx, ps = _pair(seed=2)
    jstep = jts.make_train_step(TINY, tx, donate=False)
    pstep = pts.make_train_step()
    assert pts.get_lr(ps) == pytest.approx(1e-3)
    b = _batch(30)
    js, _ = jstep(js, _jax(b))
    ps, _ = pstep(ps, _torch(b))
    js = jts.set_lr(js, 2.5e-4)
    pts.set_lr(ps, 2.5e-4)
    assert pts.get_lr(ps) == pytest.approx(jts.get_lr(js))
    b = _batch(31)
    js, _ = jstep(js, _jax(b))
    ps, _ = pstep(ps, _torch(b))
    _assert_params(TINY, js, ps)


def test_bn_train_step_matches_jax():
    """BN trains with batch statistics and updates its running statistics
    (momentum 0.1, unbiased variance) as the JAX step does."""
    cfg = ConvTasNetConfig(
        n_filters=16, kernel_size=8, bottleneck=12, hidden=24,
        conv_kernel=3, num_blocks=2, num_repeats=1, num_speakers=2,
        norm_type="BN")
    js, tx, ps = _pair(cfg=cfg, seed=3)
    jstep = jts.make_train_step(cfg, tx, donate=False)
    pstep = pts.make_train_step()
    for i in range(2):
        b = _batch(40 + i)
        js, jm = jstep(js, _jax(b))
        ps, pm = pstep(ps, _torch(b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _assert_params(cfg, js, ps)   # params and running mean/var
    assert ps.model.separator.block_r0_x0.norm1.var.ne(1).any()


def test_eval_step_matches_jax():
    js, tx, ps = _pair(seed=4)
    b = _batch(50)
    want = jts.make_eval_step(TINY)(js, _jax(b))
    got = pts.make_eval_step()(ps, _torch(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert ps.model.training    # the eval step restores the mode


def test_chunked_step_matches_unchunked():
    """train_batch_chunk accumulates over row slices: same loss, norm and
    parameters as the full batch, with a zero-weight row in the batch."""
    b = _torch(_batch(60))
    _, _, ps1 = _pair(seed=5)
    _, _, ps2 = _pair(seed=5)
    ps1, m1 = pts.make_train_step()(ps1, b)
    ps2, m2 = pts.make_train_step(batch_chunk=2)(ps2, b)
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-4,
                               atol=0)
    for (k, p1), p2 in zip(ps1.model.state_dict().items(),
                           ps2.model.state_dict().values()):
        torch.testing.assert_close(p2, p1, rtol=1e-4, atol=1e-6, msg=k)


def test_zero_weight_rows_change_nothing():
    mix, lengths, src, _ = _batch(70)
    w = np.array([1, 1, 0, 0], np.float32)
    mix2, src2 = mix.copy(), src.copy()
    mix2[2:] = 1000.0
    src2[2:] = -1000.0
    _, _, ps1 = _pair(seed=6)
    _, _, ps2 = _pair(seed=6)
    ps1, m1 = pts.make_train_step()(ps1, _torch((mix, lengths, src, w)))
    ps2, m2 = pts.make_train_step()(ps2, _torch((mix2, lengths, src2, w)))
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-5, atol=0)
    for p1, p2 in zip(ps1.model.parameters(), ps2.model.parameters()):
        torch.testing.assert_close(p2, p1, rtol=1e-4, atol=1e-6)


def test_multi_step_matches_sequential():
    batches = [_torch(_batch(80 + i)) for i in range(3)]
    _, _, ps1 = _pair(seed=7)
    _, _, ps2 = _pair(seed=7)
    step = pts.make_train_step()
    losses = []
    for b in batches:
        ps1, m = step(ps1, b)
        losses.append(m["loss"])
    ps2, m2 = pts.make_multi_train_step()(ps2, batches)
    assert m2["loss"].shape == (3,) and ps2.step == 3
    torch.testing.assert_close(m2["loss"], torch.stack(losses))
    for p1, p2 in zip(ps1.model.parameters(), ps2.model.parameters()):
        torch.testing.assert_close(p2, p1)


def test_clip_has_no_epsilon():
    """optax's clip: g * max_norm / norm exactly when norm >= max_norm
    (torch's clip_grad_norm_ divides by norm + 1e-6)."""
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor([3.0, 4.0])
    norm = pts._clip_by_global_norm([p], 1.0)
    assert float(norm) == 5.0
    torch.testing.assert_close(p.grad, torch.tensor([0.6, 0.8]), rtol=0,
                               atol=0)
    p.grad = torch.tensor([0.3, 0.4])
    pts._clip_by_global_norm([p], 1.0)
    torch.testing.assert_close(p.grad, torch.tensor([0.3, 0.4]), rtol=0,
                               atol=0)
