#!/usr/bin/env python3
"""Write the JAX fixtures that the PyTorch port reads: two JAX training
checkpoints and the JAX package's estimates on one mixture.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/make_jax_fixtures.py \\
        [--out-dir tests/fixtures]

It writes, with the JAX package on the CPU (f32, matmuls at "highest"
precision, as the tests run it):

- ``jax_tcn.ckpt``: a TCN (gLN, N=16, L=16, B=H=64, X=2, R=1);
- ``jax_dpt.ckpt``: a dual-path model (N=16, L=16, B=64, one layer pair,
  2 heads of width 32, chunks of 32 frames, FFN width 32);
- ``jax_fixtures.npz``: ``mixture`` (a seeded 1 s mixture, [1, 8000]) and
  ``tcn_est`` / ``dpt_est``, each model's plain-path estimates [1, 2, 8000].

Each checkpoint is the JAX ``save_checkpoint`` of a training state after
two Adam steps at lr 1e-3 on seeded noise batches (B=2 x 1 s), so its step,
Adam ``count``, ``mu`` and ``nu`` are non-zero; epoch 1 with a loss
history. The widths are small (about 1 MB in all) and the kernels of the
port take them: B and H multiples of 64, head width 32, S <= 256; the FFN
width runs padded to 128. ``tests/test_torch_jax_checkpoint.py`` holds the
files against the JAX package, so they cannot go stale.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SAMPLE_RATE = 8000
TCN = dict(n_filters=16, kernel_size=16, bottleneck=64, hidden=64,
           num_blocks=2, num_repeats=1)
DPT = dict(separator="dpt", n_filters=16, kernel_size=16, bottleneck=64,
           dpt_chunk=32, dpt_layers=1, dpt_heads=2, dpt_ff=32)


def mixture() -> np.ndarray:
    """The seeded 1 s mixture: two modulated tones and noise."""
    rng = np.random.default_rng(0)
    t = np.arange(SAMPLE_RATE) / SAMPLE_RATE
    s1 = 0.3 * np.sin(2 * np.pi * 310 * t) * (1 + 0.5 * np.sin(2 * np.pi * t))
    s2 = 0.1 * rng.standard_normal(t.size) * (1 + np.cos(3 * t))
    return (s1 + s2).astype(np.float32)[None]


def batch(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, SAMPLE_RATE)).astype(np.float32) * 0.3,
            np.full((2,), SAMPLE_RATE, np.int32),
            rng.standard_normal((2, 2, SAMPLE_RATE)).astype(np.float32) * 0.2,
            np.ones((2,), np.float32))


def train_and_save(kw: dict, path: str, seed: int):
    import jax
    import jax.numpy as jnp

    from convtasnet_tpu.config import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu.train import train_step as jts
    from convtasnet_tpu.train.checkpoint import save_checkpoint

    cfg = ConvTasNetConfig(**kw)
    solver = SolverConfig(lr=1e-3, save_folder="")
    state, tx = jts.create_train_state(cfg, solver, jax.random.PRNGKey(seed),
                                       SAMPLE_RATE)
    step = jts.make_train_step(cfg, tx, donate=False)
    losses = []
    for i in range(2):
        state, m = step(state, tuple(jnp.asarray(a)
                                     for a in batch(100 * seed + i)))
        losses.append(float(m["loss"]))
    save_checkpoint(path, jax.device_get(state), cfg, epoch=1,
                    tr_loss=[float(np.mean(losses))], cv_loss=[losses[-1]],
                    extra={"prev_val_loss": losses[-1],
                           "best_val_loss": losses[-1], "val_no_impv": 0,
                           "lr": solver.lr})
    est = ConvTasNet(cfg).apply({"params": state.params},
                                jnp.asarray(mixture()), train=False)
    return np.asarray(est, np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", default=os.path.join("tests", "fixtures"))
    a = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    os.makedirs(a.out_dir, exist_ok=True)
    tcn_est = train_and_save(TCN, os.path.join(a.out_dir, "jax_tcn.ckpt"), 1)
    dpt_est = train_and_save(DPT, os.path.join(a.out_dir, "jax_dpt.ckpt"), 2)
    np.savez(os.path.join(a.out_dir, "jax_fixtures.npz"), mixture=mixture(),
             tcn_est=tcn_est, dpt_est=dpt_est)
    total = sum(os.path.getsize(os.path.join(a.out_dir, f)) for f in (
        "jax_tcn.ckpt", "jax_dpt.ckpt", "jax_fixtures.npz"))
    print(f"wrote {a.out_dir}: jax_tcn.ckpt, jax_dpt.ckpt, jax_fixtures.npz "
          f"({total} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
