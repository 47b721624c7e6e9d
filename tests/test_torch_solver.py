"""The port's Solver and ``cli train``, as tests/test_solver.py checks the
JAX solver: LR halving and early stopping on a scripted cv curve, the
best-model save, resume, checkpoint-and-stop on SIGTERM, then
``python -m convtasnet_tpu_torch.cli train --device cpu`` end to end on a
tiny wav corpus, whose package ``separate`` loads."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from convtasnet_tpu.config import (
    ConvTasNetConfig,
    DataConfig,
    SolverConfig,
    TrainConfig,
)
from convtasnet_tpu_torch.train import checkpoint as ckpt
from convtasnet_tpu_torch.train.solver import Solver
from convtasnet_tpu_torch.train.train_step import get_lr
from tests.test_data import _write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ConvTasNetConfig(
    n_filters=16, kernel_size=8, bottleneck=12, hidden=24, conv_kernel=3,
    num_blocks=2, num_repeats=1, num_speakers=2)


class FakeLoader:
    """A fixed list of seeded batches on the CPU."""

    def __init__(self, n_batches=2, B=2, T=800, seed=0):
        rng = np.random.default_rng(seed)
        self.batches = [
            (torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32)),
             torch.full((B,), T, dtype=torch.int32),
             torch.from_numpy(
                 rng.standard_normal((B, 2, T)).astype(np.float32)),
             torch.ones(B))
            for _ in range(n_batches)]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def _solver(tmp_path, epochs=10, cv_script=None, folder="exp", **solver_kw):
    cfg = TrainConfig(
        model=TINY, data=DataConfig(segment=0.1, batch_size=2),
        solver=SolverConfig(epochs=epochs, lr=1e-3, print_freq=1000,
                            save_folder=str(tmp_path / folder), **solver_kw))
    s = Solver(cfg, FakeLoader(), FakeLoader(n_batches=1))
    if cv_script is not None:
        script = list(cv_script)
        s._run_cv_epoch = lambda epoch: script[epoch]
    return s


def test_lr_halves_after_three_bad_epochs(tmp_path):
    # epoch 0 improves on inf; epochs 1..4 do not: the counter reaches the
    # patience of 3 at epoch 3 and the flag re-arms at epoch 4
    s = _solver(tmp_path, epochs=5, cv_script=[5.0] * 5, early_stop=False)
    s.train()
    assert get_lr(s.state) == pytest.approx(1e-3 / 4)


def test_improvement_keeps_the_lr(tmp_path):
    s = _solver(tmp_path, epochs=4, cv_script=[5.0, 4.0, 3.0, 2.0])
    s.train()
    assert get_lr(s.state) == pytest.approx(1e-3)


def test_early_stop_after_seven(tmp_path):
    s = _solver(tmp_path, epochs=20, cv_script=[1.0] + [2.0] * 19)
    assert len(s.train()["cv_loss"]) == 8


def test_best_model_saved_only_on_improvement(tmp_path):
    s = _solver(tmp_path, epochs=3, cv_script=[3.0, 4.0, 2.0],
                enable_checkpoint=True)
    s.train()
    best = tmp_path / "exp" / "final.ckpt"
    package, meta = ckpt.load_checkpoint(str(best))
    assert meta["epoch"] == 3 and meta["extra"]["best_val_loss"] == 2.0
    assert meta["cv_loss"] == [3.0, 4.0, 2.0]
    assert package["step"] == 6 and "optimizer" in package
    assert (tmp_path / "exp" / "checkpoint_models" / "epoch2.ckpt").exists()


def test_resume_continues_to_the_configured_epochs(tmp_path):
    s = _solver(tmp_path, epochs=2, cv_script=[3.0, 2.0])
    s.train()
    cfg2 = TrainConfig(
        model=TINY, data=DataConfig(segment=0.1, batch_size=2),
        solver=SolverConfig(
            epochs=3, lr=1e-3, print_freq=1000,
            save_folder=str(tmp_path / "exp2"),
            continue_from=str(tmp_path / "exp" / "final.ckpt")))
    s2 = Solver(cfg2, FakeLoader(), FakeLoader(n_batches=1))
    assert s2.start_epoch == 2 and s2.state.step == s.state.step == 4
    assert s2.best_val_loss == 2.0
    for p1, p2 in zip(s.state.model.parameters(),
                      s2.state.model.parameters()):
        torch.testing.assert_close(p2, p1, rtol=0, atol=0)
    result = s2.train()
    assert len(result["tr_loss"]) == 3 and s2.state.step == 6


def test_sigterm_checkpoints_and_stops(tmp_path):
    s = _solver(tmp_path, epochs=50)
    calls = {"n": 0}
    orig = s.train_step

    def step_and_interrupt(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(state, batch)

    s.train_step = step_and_interrupt
    s.train()
    assert calls["n"] <= 4
    path = tmp_path / "exp" / "preempted.ckpt"
    assert path.exists()
    cfg2 = TrainConfig(
        model=TINY, data=DataConfig(segment=0.1, batch_size=2),
        solver=SolverConfig(epochs=2, lr=1e-3, print_freq=1000,
                            save_folder=str(tmp_path / "exp2"),
                            continue_from=str(path)))
    s2 = Solver(cfg2, FakeLoader(), FakeLoader(n_batches=1))
    assert s2.state.step == s.state.step


def test_profile_dir_gets_a_trace(tmp_path):
    """--profile: a torch.profiler Chrome trace of steady-state steps of the
    first epoch lands in the profile directory."""
    prof = tmp_path / "trace"
    s = _solver(tmp_path, epochs=1, cv_script=[1.0], profile_dir=str(prof),
                profile_steps=1)
    s.train()
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_empty_loaders_fail_fast(tmp_path):
    cfg = TrainConfig(model=TINY, solver=SolverConfig(
        epochs=1, save_folder=str(tmp_path / "exp")))

    class Empty(FakeLoader):
        def __init__(self):
            self.batches = []

    with pytest.raises(ValueError, match="cv loader is empty"):
        Solver(cfg, FakeLoader(), Empty())
    with pytest.raises(ValueError, match="training loader is empty"):
        Solver(cfg, Empty(), FakeLoader())


def test_cli_train_then_separate(tmp_path):
    """preprocess + train on the CPU in a subprocess (as a user runs it),
    then the best-model package separates a mixture."""
    from convtasnet_tpu_torch.infer.separate import separate

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
               "--save-folder", out, "--device", "cpu", "--N", "16",
               "--L", "8", "--B", "12", "--H", "24", "--X", "2", "--R", "1",
               "--segment", "0.5", "--batch-size", "2", "--epochs", "2",
               "--print-freq", "1", "--num-workers", "1"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "best cv loss" in proc.stdout
    assert "Iter 4" in proc.stdout          # 8 segments / batch 2
    assert os.path.exists(os.path.join(out, "config.json"))
    assert os.path.exists(os.path.join(out, "history.jsonl"))
    pkg = os.path.join(out, "final.ckpt")
    n = separate(pkg, str(tmp_path / "sep"),
                 mix_dir=os.path.join(root, "cv", "mix"), device="cpu")
    assert n == 2
    assert sorted(os.listdir(tmp_path / "sep"))[:3] == [
        "utt000.wav", "utt000_s1.wav", "utt000_s2.wav"]


@pytest.mark.parametrize("flags,error,item", [
    (["--norm-type", "cLN", "--causal", "1", "--use-pallas", "1"],
     ValueError, "CUDA tensors"),
    (["--n-data", "2"], NotImplementedError, "ROADMAP A8c"),
])
def test_cli_train_refuses_what_is_not_ported(tmp_path, flags, error, item,
                                              monkeypatch):
    """Data parallelism is refused before any data is read (tensor
    parallelism trains: the TCN's in tests/test_torch_tp.py, the dual-path
    separator's below); a causal cLN model with the kernels insisted on
    trains through them, and on CPU tensors it is refused at the first step
    for want of CUDA tensors (no fallback to the plain ops)."""
    from convtasnet_tpu_torch import cli

    monkeypatch.setenv("CONVTASNET_SEGMENT_CACHE", str(tmp_path / "cache"))
    root, json_dir = str(tmp_path / "wavs"), str(tmp_path / "json")
    _write_corpus(root, [4000] * 2, split="tr", seed=0)
    _write_corpus(root, [4000], split="cv", seed=1)
    assert cli.main(["preprocess", "--data-dir", root, "--out-dir",
                     json_dir]) == 0
    with pytest.raises(error, match=item):
        cli.main(["train", "--train-dir", os.path.join(json_dir, "tr"),
                  "--valid-dir", os.path.join(json_dir, "cv"),
                  "--save-folder", str(tmp_path / "exp"), "--device", "cpu",
                  "--N", "16", "--L", "8", "--B", "12", "--H", "24", "--X",
                  "2", "--R", "1", "--segment", "0.5", "--batch-size", "2",
                  "--epochs", "1", "--num-workers", "0", *flags])


def test_cli_train_dpt_n_model_trains(tmp_path, monkeypatch):
    """``--separator dpt --n-model 2``, once refused, trains one tiny epoch
    on the CPU with the dual-path heads and FFN width split over two shards
    (parity with JAX: tests/test_torch_dpt_tp.py): finite losses, a
    best-model package."""
    import json

    from convtasnet_tpu_torch import cli

    monkeypatch.setenv("CONVTASNET_SEGMENT_CACHE", str(tmp_path / "cache"))
    root, json_dir = str(tmp_path / "wavs"), str(tmp_path / "json")
    _write_corpus(root, [4000] * 2, split="tr", seed=0)
    _write_corpus(root, [4000], split="cv", seed=1)
    assert cli.main(["preprocess", "--data-dir", root, "--out-dir",
                     json_dir]) == 0
    out = str(tmp_path / "exp")
    assert cli.main([
        "train", "--train-dir", os.path.join(json_dir, "tr"),
        "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder", out,
        "--device", "cpu", "--N", "16", "--L", "8", "--B", "64",
        "--dpt-chunk", "16", "--dpt-layers", "1", "--dpt-heads", "2",
        "--dpt-ff", "128", "--segment", "0.5", "--batch-size", "2",
        "--epochs", "1", "--num-workers", "0", "--separator", "dpt",
        "--n-model", "2"]) == 0
    with open(os.path.join(out, "history.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert losses and all(np.isfinite(losses))
    assert os.path.exists(os.path.join(out, "final.ckpt"))
