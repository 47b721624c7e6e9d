"""The port's dual-path tensor parallelism (``parallel/dpt_tp.py`` and the
``partial`` mode of the DPT sublayers) against the JAX package's
(``convtasnet_tpu/parallel/dpt_tp.py``), at the JAX test's tiny DPT config
(``tests/test_dpt_tp.py``: B=64, 4 heads, chunk 16, F=128).

- Each partial twin, forward and backward, against the Pallas partial
  kernel in interpret mode and against ``xla_*(partial=True)`` (the
  backward against ``jax.vjp`` of the partial XLA sublayer), on one
  shard's weights cut by JAX's own stacking, in f32 within 1e-5 relative
  L2; the partials of all shards plus the residual (and the down bias)
  against the full twin.
- ``dpt_tp_variables`` against JAX's ``dpt_tp_variables``, leaf by leaf.
- ``dpt_tp_forward`` (and ``tp_forward``, which routes to it) at m = 2 and
  4 against JAX's jitted ``dpt_tp_forward`` on a 1 x m mesh of virtual CPU
  devices with ``use_pallas=False``, f32 within 1e-5 relative L2.
- One TP train step against JAX's ``make_dpt_tp_train_step`` at the gates
  of ``tests/test_torch_dpt_train.py``: lr 1e-4, loss and gradient norm
  within 1e-5 relative, every parameter within 2e-5, and every gradient
  leaf against ``jax.grad`` at the shared weights within 1e-5 relative L2.
- ``cli train --separator dpt --n-model 2 --device cpu`` for one tiny
  epoch, then its package served by ``separate(tensor_parallel=2)``
  against the unsharded ``separate`` within 2 PCM-16 steps.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig, SolverConfig
from convtasnet_tpu.models.conv_tasnet import ConvTasNet as JaxConvTasNet
from convtasnet_tpu.models.conv_tasnet import init_params
from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu.ops.pallas import dpt_ffn as jax_ffn
from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu.parallel import dpt_tp as jdtp
from convtasnet_tpu.parallel.mesh import make_mesh
from convtasnet_tpu.train import train_step as jts
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_inter
from convtasnet_tpu_torch.ops.cuda import dpt_ffn as port_ffn
from convtasnet_tpu_torch.ops.cuda import dpt_intra as port_intra
from convtasnet_tpu_torch.parallel import dpt_tp as pdtp
from convtasnet_tpu_torch.parallel import tensor_parallel as ptp
from convtasnet_tpu_torch.parallel.mesh import shard_devices
from convtasnet_tpu_torch.train import train_step as pts

# tests/test_dpt_tp.py's DPT, with the plain XLA sublayers on the JAX side
TINY = ConvTasNetConfig(separator="dpt", n_filters=16, kernel_size=8,
                        bottleneck=64, dpt_chunk=16, dpt_layers=2,
                        dpt_ff=128, dpt_heads=4, num_speakers=2,
                        use_pallas=False)
T = 1600          # K = 399 frames: 25 chunks of 16, the last part padding
B, H, F = 64, 4, 128
TOL = 1e-5


def _rel(got, want) -> float:
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def shard_ops():
    """Seeded full-width sublayer operands, their shard weights cut by JAX's
    stacking at m = 2, and a cotangent zero on the padded rows."""
    rng = np.random.default_rng(0)
    M, n, S = 2, 3, 16
    valid = np.arange(n * S).reshape(n, S) < n * S - 11
    a = dict(x=rng.standard_normal((M, n, S, B)),
             g=rng.standard_normal((M, n, S, B)) * valid[None, :, :, None],
             gamma=1 + 0.1 * rng.standard_normal(B),
             beta=0.1 * rng.standard_normal(B),
             w_qkv=rng.standard_normal((B, 3 * B)) / np.sqrt(B),
             w_out=rng.standard_normal((B, B)) / np.sqrt(B),
             w_up=rng.standard_normal((B, F)) / np.sqrt(B),
             b_up=0.1 * rng.standard_normal(F),
             w_down=rng.standard_normal((F, B)) / np.sqrt(F),
             b_down=0.1 * rng.standard_normal(B),
             bias=np.where(valid, 0.0, -1e9))
    a = {k: np.asarray(v, np.float32) for k, v in a.items()}
    m = 2
    sh = dict(
        w_qkv=np.asarray(jdtp._stack_qkv(jnp.asarray(a["w_qkv"]), m)),
        w_out=np.asarray(jdtp._stack_rows(jnp.asarray(a["w_out"]), m)),
        w_up=np.asarray(jdtp._stack_cols(jnp.asarray(a["w_up"]), m)),
        b_up=np.stack(np.split(a["b_up"], m)),
        w_down=np.asarray(jdtp._stack_rows(jnp.asarray(a["w_down"]), m)))
    return dict(a=a, sh=sh, m=m, valid=valid)


ATTN = {"inter": (jax_inter.fused_inter_attention,
                  jax_inter.xla_inter_attention,
                  jax_inter.fused_inter_attention_bwd,
                  port_inter.fused_inter_attention,
                  port_inter.fused_inter_attention_bwd),
        "intra": (jax_intra.fused_intra_attention,
                  jax_intra.xla_intra_attention,
                  jax_intra.fused_intra_attention_bwd,
                  port_intra.fused_intra_attention,
                  port_intra.fused_intra_attention_bwd)}


def _attn_args(ops, s, lib):
    a, sh = ops["a"], ops["sh"]
    vals = (a["x"], a["gamma"], a["beta"], sh["w_qkv"][s], sh["w_out"][s],
            a["bias"])
    return [jnp.asarray(v) if lib == "jax" else _t(v) for v in vals]


def _ffn_args(ops, s, lib):
    a, sh = ops["a"], ops["sh"]
    vals = (a["x"].reshape(2, -1, B), a["gamma"], a["beta"], sh["w_up"][s],
            sh["b_up"][s], sh["w_down"][s], a["b_down"])
    return [jnp.asarray(v) if lib == "jax" else _t(v) for v in vals]


@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_partial_twins_match_pallas_interpret_and_xla(shard_ops, kind):
    """Shard 1's partial forward: the port's twin (what its wrapper runs on
    CPU tensors) against the Pallas partial kernel in interpret mode and
    the partial XLA sublayer; its rows are the projection alone."""
    hl = H // shard_ops["m"]
    if kind == "ffn":
        j, t = _ffn_args(shard_ops, 1, "jax"), _ffn_args(shard_ops, 1, "t")
        pallas = jax_ffn.fused_ffn(*j, interpret=True, partial=True)
        xla = jax_ffn.xla_ffn(*j, partial=True)
        got = port_ffn.fused_ffn(*t, partial=True)
        rows = np.ones(got.shape[1], bool)
    else:
        jf, jx, _, pf, _ = ATTN[kind]
        j, t = _attn_args(shard_ops, 1, "jax"), _attn_args(shard_ops, 1, "t")
        pallas = jf(*j, n_heads=hl, interpret=True, partial=True)
        xla = jx(*j, n_heads=hl, partial=True)
        got = pf(*t, n_heads=hl, partial=True)
        rows = shard_ops["valid"].reshape(-1)
    assert got.dtype == torch.float32
    g = got.numpy().reshape(2, -1, B)[:, rows]
    for want in (pallas, xla):
        assert _rel(g, np.asarray(want).reshape(2, -1, B)[:, rows]) <= TOL


@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_partial_bwd_twins_match_pallas_interpret_and_vjp(shard_ops, kind):
    """Shard 1's partial backward: the port's twin against the Pallas
    partial backward in interpret mode and ``jax.vjp`` of the partial XLA
    sublayer, every cotangent (dx on the valid rows); dx has no residual
    term and the FFN's db_down is zero."""
    hl = H // shard_ops["m"]
    a = shard_ops["a"]
    if kind == "ffn":
        j, t = _ffn_args(shard_ops, 1, "jax"), _ffn_args(shard_ops, 1, "t")
        g = a["g"].reshape(2, -1, B)
        pallas = jax_ffn.fused_ffn_bwd(j[0], jnp.asarray(g), *j[1:],
                                       interpret=True, partial=True)
        _, vjp = jax.vjp(lambda *p: jax_ffn.xla_ffn(*p, partial=True), *j)
        got = port_ffn.fused_ffn_bwd(t[0], _t(g), *t[1:], partial=True)
        rows = np.ones(g.shape[1], bool)
        assert not got[-1].any()
    else:
        _, jx, jb, _, pb = ATTN[kind]
        j, t = _attn_args(shard_ops, 1, "jax"), _attn_args(shard_ops, 1, "t")
        g = a["g"]
        pallas = jb(j[0], jnp.asarray(g), *j[1:], n_heads=hl, interpret=True,
                    partial=True)
        _, vjp = jax.vjp(lambda *p: jx(*p, j[5], n_heads=hl, partial=True),
                         *j[:5])
        got = pb(t[0], _t(g), *t[1:], n_heads=hl, partial=True)
        rows = shard_ops["valid"].reshape(-1)
    exact = vjp(jnp.asarray(g))
    for i, q in enumerate(got):
        q = q.numpy()
        for want in (pallas[i], exact[i]):
            w = np.asarray(want)
            if i == 0:
                q_, w = q.reshape(2, -1, B)[:, rows], w.reshape(2, -1, B)[:, rows]
            else:
                q_ = q
            if not np.any(w):       # the FFN's db_down
                assert not np.any(q_)
                continue
            assert _rel(q_, w) <= TOL, (kind, i)


def test_partials_sum_to_the_full_sublayer(shard_ops):
    """The Megatron identity on the port's twins: the m shards' partials
    summed, plus the residual (plus b_down for the FFN), equal the full
    sublayer."""
    a, m, hl = shard_ops["a"], shard_ops["m"], H // shard_ops["m"]
    for kind in ("inter", "intra"):
        pf = ATTN[kind][3]
        full = pf(_t(a["x"]), _t(a["gamma"]), _t(a["beta"]), _t(a["w_qkv"]),
                  _t(a["w_out"]), _t(a["bias"]), n_heads=H)
        acc = _t(a["x"]) + sum(pf(*_attn_args(shard_ops, s, "t"), n_heads=hl,
                                  partial=True) for s in range(m))
        rows = shard_ops["valid"].reshape(-1)
        assert _rel(acc.reshape(2, -1, B)[:, rows],
                    full.reshape(2, -1, B)[:, rows]) <= TOL, kind
    x3 = _t(a["x"].reshape(2, -1, B))
    full = port_ffn.fused_ffn(x3, *(_t(a[k]) for k in (
        "gamma", "beta", "w_up", "b_up", "w_down", "b_down")))
    acc = x3 + sum(port_ffn.fused_ffn(*_ffn_args(shard_ops, s, "t"),
                                      partial=True) for s in range(m))
    assert _rel(acc + _t(a["b_down"]), full) <= TOL


def test_partial_cuda_branches_raise_without_the_library(shard_ops,
                                                        monkeypatch):
    """The partial wrappers' CUDA branches, which a CUDA tensor takes, with
    the kernel library made to fail: each raises, none drops back to the
    twin, and no launch is counted (the card tests hold the same on CUDA
    tensors)."""
    from convtasnet_tpu_torch.ops.cuda import build

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    for mod in (build, port_inter, port_ffn):
        monkeypatch.setattr(mod, "load_library", broken_loader)
    wrappers = [port_inter.fused_inter_attention,
                port_intra.fused_intra_attention, port_ffn.fused_ffn,
                port_inter.fused_inter_attention_bwd,
                port_intra.fused_intra_attention_bwd, port_ffn.fused_ffn_bwd]
    before = [(w.launches, w.partial_launches) for w in wrappers]
    hl = H // shard_ops["m"]
    g = _t(shard_ops["a"]["g"])
    for kind in ("inter", "intra"):
        t = _attn_args(shard_ops, 0, "t")
        with pytest.raises(RuntimeError, match="unavailable"):
            port_inter.launch_attention(kind, *t, n_heads=hl, partial=True)
        with pytest.raises(RuntimeError, match="unavailable"):
            port_inter.launch_attention_bwd(kind, t[0], g, *t[1:],
                                            n_heads=hl, partial=True)
    t = _ffn_args(shard_ops, 0, "t")
    with pytest.raises(RuntimeError, match="unavailable"):
        port_ffn._launch_cuda(*t, partial=True)
    with pytest.raises(RuntimeError, match="unavailable"):
        port_ffn._launch_cuda_bwd(t[0], g.reshape(t[0].shape), *t[1:],
                                  partial=True)
    assert [(w.launches, w.partial_launches) for w in wrappers] == before


@pytest.fixture(scope="module")
def variables():
    return jax.device_get(init_params(TINY, jax.random.PRNGKey(0),
                                      example_len=T))


@pytest.mark.parametrize("n_model", [2, 4])
def test_dpt_tp_variables_match_jax(variables, n_model):
    """Shard s's leaves are JAX's stacked leaves [s]: q, k and v split by
    head group each; out and down by rows; up and its bias by columns;
    the norms and the down bias whole."""
    want = jax.device_get(jdtp.dpt_tp_variables(
        TINY, variables, n_model))["params"]["separator"]
    sd = state_dict_from_jax(variables, TINY)
    shards = pdtp.dpt_tp_variables(TINY, sd, shard_devices(n_model, "cpu"))
    stacked = {"qkv.kernel", "out.kernel", "up.kernel", "up.bias",
               "down.kernel"}
    n_leaves = 0
    for i in range(TINY.dpt_layers):
        for sub in pdtp.SUBLAYERS:
            pre = f"separator.layer_{i}.{sub}."
            for leaf in (("norm.gamma", "norm.beta", "qkv.kernel",
                          "out.kernel") if sub.endswith("att") else
                         ("norm.gamma", "norm.beta", "up.kernel", "up.bias",
                          "down.kernel", "down.bias")):
                w = want[f"layer_{i}"][sub]
                for part in leaf.split("."):
                    w = w[part]
                for s, sh in enumerate(shards):
                    got = sh[pre + leaf].numpy()
                    np.testing.assert_array_equal(
                        got, w[s] if leaf in stacked else w,
                        err_msg=f"{pre}{leaf} shard {s}")
                n_leaves += 1
    assert n_leaves == TINY.dpt_layers * 20   # 2 x (4 + 6) per layer
    assert all(set(sh) == set(shards[0]) for sh in shards)
    with pytest.raises(ValueError, match="must divide n_heads"):
        pdtp.dpt_tp_variables(TINY, sd, shard_devices(3, "cpu"))


@pytest.fixture(scope="module")
def forward_case(variables):
    mix = np.random.default_rng(1).standard_normal((2, T)).astype(np.float32)
    want = {}
    for m in (2, 4):
        mesh = make_mesh(n_data=1, n_model=m)
        want[m] = np.asarray(jax.device_get(jax.jit(
            lambda v, x, _mesh=mesh: jdtp.dpt_tp_forward(TINY, v, x, _mesh))(
                variables, jnp.asarray(mix))))
    return dict(sd=state_dict_from_jax(variables, TINY), mix=mix, want=want)


@pytest.mark.parametrize("n_model", [2, 4])
def test_dpt_tp_forward_matches_jax(forward_case, n_model):
    """One bridged tree serves JAX's dpt_tp_forward through the port's, at
    two and four shards; ``tp_forward`` routes a dual-path config there."""
    want = forward_case["want"][n_model]
    devices = shard_devices(n_model, "cpu")
    mix = torch.from_numpy(forward_case["mix"])
    with torch.no_grad():
        got = pdtp.dpt_tp_forward(TINY, forward_case["sd"], mix, devices)
        routed = ptp.tp_forward(TINY, forward_case["sd"], mix, devices)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= TOL
    assert torch.equal(routed, got)


SOLVER = SolverConfig(lr=1e-4, max_grad_norm=5.0, save_folder="")


def _batch(seed, M=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, T)).astype(np.float32),
            np.full((M,), T, np.int32),
            rng.standard_normal((M, 2, T)).astype(np.float32),
            np.asarray([1, 1, 0], np.float32))


def test_dpt_tp_train_step_matches_jax():
    """One TP Adam step over four shards (one head each) against JAX's
    make_dpt_tp_train_step on a 1 x 4 mesh, clipping engaged and a
    zero-weight row; before it, every gradient leaf at the shared weights
    against jax.grad of the unsharded loss."""
    js, tx = jts.create_train_state(TINY, SOLVER, jax.random.PRNGKey(0), T)
    sd = state_dict_from_jax(jax.device_get({"params": js.params}), TINY)
    ps = pts.create_train_state(TINY, SOLVER, state_dict=sd,
                                use_pallas=False)
    devices = shard_devices(4, "cpu")
    b = _batch(61)
    tb = tuple(torch.from_numpy(np.array(x)) for x in b)
    jb = tuple(jnp.asarray(x) for x in b)

    jgrads = jax.jit(lambda p, s, bb: jts._loss_and_grads(
        JaxConvTasNet(TINY), p, s, bb, 0)[2])(js.params, js.batch_stats, jb)
    want = state_dict_from_jax(jax.device_get({"params": jgrads}), TINY)
    ptp.tp_loss_and_grads(TINY, ps.model, tb, devices)
    got = {k: p.grad for k, p in ps.model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        assert _rel(g.numpy(), want[k].numpy()) <= TOL, k

    jstep = jdtp.make_dpt_tp_train_step(TINY, tx, make_mesh(n_data=1,
                                                            n_model=4),
                                        donate=False)
    js, jm = jstep(js, jb)
    ps, pm = pdtp.make_dpt_tp_train_step(TINY, devices)(ps, tb)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert float(jm["grad_norm"]) > SOLVER.max_grad_norm
    after = state_dict_from_jax(jax.device_get({"params": js.params}), TINY)
    now = ps.model.state_dict()
    assert set(now) == set(after) and ps.step == 1
    for k, w in after.items():
        np.testing.assert_allclose(now[k].numpy(), w.numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)
    with pytest.raises(ValueError, match="make_tcn_tp_train_step"):
        pdtp.make_dpt_tp_train_step(dataclasses.replace(
            TINY, separator="tcn"), devices)


def test_partial_kernels_refuse_shard_widths_they_do_not_take():
    """With the kernels insisted on, a shard count whose widths they do not
    take raises before any launch and names the counts that fit (B=64, 4
    heads: a shard count must divide the heads; a shard of 32 or 16
    channels runs padded with zero heads)."""
    mix = torch.zeros(1, T)
    with pytest.raises(ValueError,
                       match=r"shard counts that fit: \[1, 2, 4\]"):
        pdtp.dpt_tp_forward(TINY, {}, mix, shard_devices(3, "cpu"),
                            use_pallas=True)


def test_cli_train_dpt_n_model_then_separate_tensor_parallel(
        tmp_path, monkeypatch, capsys):
    """``cli train --separator dpt --n-model 2 --device cpu``: one epoch of
    two steps and a cv pass, every forward through ``tp_forward`` over two
    shards; its package then serves through ``separate(...,
    tensor_parallel=2)``, within 2 PCM-16 steps of the unsharded
    ``separate``."""
    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav
    from convtasnet_tpu_torch.infer import separate as separate_mod
    from convtasnet_tpu_torch.infer.separate import separate
    from tests.test_data import _write_corpus

    calls = []
    real = ptp.tp_forward

    def counting(cfg, variables, mixture, devices, use_pallas=None):
        calls.append((cfg.separator, len(devices)))
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
        "--device", "cpu", "--separator", "dpt", "--n-model", "2", "--N",
        "16", "--L", "8", "--B", "64", "--dpt-chunk", "16", "--dpt-layers",
        "1", "--dpt-heads", "2", "--dpt-ff", "128", "--segment", "0.5",
        "--batch-size", "2", "--epochs", "1", "--print-freq", "1",
        "--num-workers", "1"]) == 0
    printed = capsys.readouterr().out
    assert ("tensor parallel over 2 shards: shard 0 on cpu, shard 1 on cpu"
            in printed)
    assert calls == [("dpt", 2)] * 3   # two train steps, one cv batch
    pkg = os.path.join(out, "final.ckpt")
    mix_dir = os.path.join(root, "cv", "mix")
    calls.clear()
    assert separate(pkg, str(tmp_path / "tp"), mix_dir=mix_dir,
                    tensor_parallel=2, device="cpu") == 1
    assert calls == [("dpt", 2)]
    assert separate(pkg, str(tmp_path / "one"), mix_dir=mix_dir,
                    device="cpu") == 1
    for c in (1, 2):
        a = read_wav(str(tmp_path / "tp" / f"utt000_s{c}.wav"))[0]
        b = read_wav(str(tmp_path / "one" / f"utt000_s{c}.wav"))[0]
        assert a.shape == b.shape == (4000,)
        assert np.isfinite(a).all() and np.abs(a).max() > 0
        assert np.abs(a - b).max() <= 2.0 / 32768
