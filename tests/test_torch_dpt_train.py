"""Training the dual-path (DPT) separator with the port, against the JAX
package: three Adam steps of ``make_train_step`` on a tiny DPT model, and
``python -m convtasnet_tpu_torch.cli train --separator dpt --device cpu``
end to end, whose best-model package ``separate`` and ``evaluate`` load.

Both sides of the step comparison start from the same weights (a JAX init
carried over by ``state_dict_from_jax``) and take the same seeded numpy
batches, in f32 on the CPU with the plain ops (``use_pallas=False`` on
both sides), at the tolerances of ``tests/test_torch_train.py``: losses
and gradient norms to 1e-5 relative, parameters to 2e-5 absolute.

At random init a DPT model's clipped gradient has elements near Adam's
eps (1e-8), whose updates follow the f32 summation order of their tiny
values: at lr 1e-3 the two frameworks' parameters part by up to 4.5e-5
in one step, and the model's ill-conditioning turns that into 1e-4 on
later gradient norms, while at identical weights the two gradients agree
to 5e-7..2.2e-6. So each step starts the port from the JAX step's
parameters (each side keeps its own Adam moments), and lr is 1e-4, at
which a wrong gradient element still moves a parameter by 2e-4. Since
Adam's update is close to a sign step, every gradient leaf is also held
against ``jax.grad`` at the shared weights, to 1e-5 relative L2.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from convtasnet_tpu.config import ConvTasNetConfig, SolverConfig
from convtasnet_tpu.models.conv_tasnet import ConvTasNet as JaxConvTasNet
from convtasnet_tpu.train import train_step as jts
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.train import train_step as pts
from tests.test_data import _write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K = 399 frames at T = 1600: 25 chunks of 16, the last one part padding
TINY_DPT = ConvTasNetConfig(
    n_filters=16, kernel_size=8, bottleneck=64, num_speakers=2,
    separator="dpt", dpt_chunk=16, dpt_layers=2, dpt_heads=2, dpt_ff=128,
    use_pallas=False)
SOLVER = SolverConfig(lr=1e-4, max_grad_norm=5.0, save_folder="")


def _batch(seed, B=3, T=1600):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)).astype(np.float32),
            np.full((B,), T, np.int32),
            rng.standard_normal((B, 2, T)).astype(np.float32),
            np.asarray([1, 1, 0], np.float32))


def _params(js):
    return state_dict_from_jax(jax.device_get(
        {"params": js.params, "batch_stats": js.batch_stats}), TINY_DPT)


_MODEL = JaxConvTasNet(TINY_DPT)
_jax_grads = jax.jit(
    lambda p, s, b: jts._loss_and_grads(_MODEL, p, s, b, 0)[2])


def _assert_grads_match(js, ps, b):
    """Every gradient leaf of the port, at the shared weights, against
    ``jax.grad`` of the JAX step's loss: relative L2 <= 1e-5 per leaf, so
    the gradient is held directly, not only through Adam's normalised
    update."""
    jgrads = _jax_grads(js.params, js.batch_stats,
                        tuple(jnp.asarray(a) for a in b))
    want = state_dict_from_jax(
        jax.device_get({"params": jgrads, "batch_stats": js.batch_stats}),
        TINY_DPT)
    pts._loss_and_grads(ps.model, tuple(torch.from_numpy(np.array(a))
                                        for a in b), 0)
    got = {k: p.grad for k, p in ps.model.named_parameters()}
    assert set(got) <= set(want) and len(got) > 0
    for k, g in got.items():
        w = want[k].double()
        err = float(torch.linalg.vector_norm(g.double() - w)
                    / torch.linalg.vector_norm(w).clamp_min(1e-30))
        assert err <= 1e-5, f"{k}: relative L2 {err:.3g}"


def test_dpt_adam_steps_match_jax():
    """Three Adam steps with clipping engaged (gradient norms far above 5) and
    a zero-weight row in each batch; before each, every gradient leaf at the
    shared weights."""
    js, tx = jts.create_train_state(TINY_DPT, SOLVER, jax.random.PRNGKey(0),
                                    1600)
    ps = pts.create_train_state(TINY_DPT, SOLVER, state_dict=_params(js),
                                use_pallas=False)
    jstep = jts.make_train_step(TINY_DPT, tx, donate=False)
    pstep = pts.make_train_step()
    for i in range(3):
        b = _batch(60 + i)
        _assert_grads_match(js, ps, b)
        js, jm = jstep(js, tuple(jnp.asarray(a) for a in b))
        ps, pm = pstep(ps, tuple(torch.from_numpy(np.array(a)) for a in b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        want = _params(js)
        got = ps.model.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=2e-5, err_msg=k)
        ps.model.load_state_dict(want)
    assert float(jm["grad_norm"]) > SOLVER.max_grad_norm
    assert ps.step == int(js.step) == 3


def test_cli_train_dpt_then_separate_and_evaluate(tmp_path):
    """preprocess + ``train --separator dpt`` on the CPU in a subprocess
    (as a user runs it), then the best-model package separates the cv
    mixtures and evaluates the cv split."""
    from convtasnet_tpu_torch.infer.evaluate import evaluate
    from convtasnet_tpu_torch.infer.separate import separate
    from convtasnet_tpu_torch.train.checkpoint import (
        load_params_for_inference,
    )

    root = str(tmp_path / "wavs")
    _write_corpus(root, [8000] * 4, split="tr", seed=0)
    _write_corpus(root, [6000, 8000], split="cv", seed=1)
    env = dict(os.environ, PYTHONPATH=REPO,
               CONVTASNET_SEGMENT_CACHE=str(tmp_path / "cache"))
    cli = [sys.executable, "-m", "convtasnet_tpu_torch.cli"]
    json_dir = str(tmp_path / "json")
    subprocess.run(cli + ["preprocess", "--data-dir", root, "--out-dir",
                          json_dir], check=True, env=env, cwd=REPO,
                   timeout=120)
    out = str(tmp_path / "exp")
    proc = subprocess.run(
        cli + ["train", "--train-dir", os.path.join(json_dir, "tr"),
               "--valid-dir", os.path.join(json_dir, "cv"),
               "--save-folder", out, "--device", "cpu", "--separator", "dpt",
               "--N", "16", "--L", "8", "--B", "64", "--dpt-chunk", "16",
               "--dpt-layers", "1", "--dpt-heads", "2", "--dpt-ff", "128",
               "--segment", "0.5", "--batch-size", "2", "--epochs", "1",
               "--print-freq", "1", "--num-workers", "1"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "best cv loss" in proc.stdout
    assert "Iter 4" in proc.stdout          # 8 segments / batch 2
    pkg = os.path.join(out, "final.ckpt")
    n = separate(pkg, str(tmp_path / "sep"),
                 mix_dir=os.path.join(root, "cv", "mix"), device="cpu")
    assert n == 2
    assert sorted(os.listdir(tmp_path / "sep"))[:3] == [
        "utt000.wav", "utt000_s1.wav", "utt000_s2.wav"]
    res = evaluate(pkg, os.path.join(json_dir, "cv"), batch_size=2,
                   device="cpu", verbose=False)
    assert np.isfinite(res["si_snri"])
    cfg, _ = load_params_for_inference(pkg)
    assert cfg.separator == "dpt" and cfg.dpt_layers == 1
