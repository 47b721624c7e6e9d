"""The port reads the JAX package's ``.ckpt`` files with its own msgpack
decoder (``convtasnet_tpu_torch/train/flax_msgpack.py``), without flax,
msgpack or jax.

JAX's ``save_checkpoint`` writes training checkpoints of a gLN, a BN (with
``batch_stats``), a cLN causal and a dual-path model, one with
``param_dtype=bfloat16``, one with Adam and L2 and one with SGD and
momentum, their optimizer states filled with seeded noise.
A subprocess with ``msgpack``, ``flax`` and ``jax`` blocked reads them with
the port: every leaf equals flax's reading bit for bit, and the port's
forward of each is within 5e-4 of the JAX model's. A resumed port step is
held against a JAX step from the same state (lr 1e-4 and the resync rule,
as tests/test_torch_train.py) and the step counts continue. Chunked
arrays decode; an orbax directory, a truncated file and an unknown ext
code raise. The committed fixtures (``scripts/make_jax_fixtures.py``)
still give the estimates stored beside them, and ``cli train
--continue-from`` resumes one.
"""

import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig, SolverConfig
from convtasnet_tpu.models.conv_tasnet import ConvTasNet as JaxConvTasNet
from convtasnet_tpu.train import checkpoint as jckpt
from convtasnet_tpu.train import train_step as jts
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.train import checkpoint as pckpt
from convtasnet_tpu_torch.train import train_step as pts
from convtasnet_tpu_torch.train.flax_msgpack import msgpack_restore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
T = 1600
TCN = dict(n_filters=16, kernel_size=8, bottleneck=12, hidden=24,
           num_blocks=2, num_repeats=1)
DPT = dict(separator="dpt", n_filters=16, kernel_size=8, bottleneck=64,
           dpt_chunk=16, dpt_layers=1, dpt_heads=2, dpt_ff=64)
# name -> (model fields, solver fields)
CASES = {
    "gln": (TCN, {}),
    "bn": ({**TCN, "norm_type": "BN"}, {}),
    "cln_causal": ({**TCN, "norm_type": "cLN", "causal": True}, {}),
    "dpt": (DPT, {}),
    "bf16_params": ({**TCN, "param_dtype": "bfloat16"}, {}),
    "adam_l2": (TCN, {"l2": 1e-3}),
    "sgd_momentum": (TCN, {"optimizer": "sgd", "momentum": 0.9}),
}


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)).astype(np.float32),
            np.full((B,), T, np.int32),
            rng.standard_normal((B, 2, T)).astype(np.float32),
            np.ones((B,), np.float32))


def _jax_state(name, lr=1e-3, steps=0, seed=0):
    """(config, solver config, JAX train step, state after ``steps`` steps;
    with no step, the optimizer's moments and counts are seeded noise)."""
    model, solver = CASES[name]
    cfg = ConvTasNetConfig(**model)
    scfg = SolverConfig(lr=lr, save_folder="", **solver)
    state, tx = jts.create_train_state(cfg, scfg, jax.random.PRNGKey(seed),
                                       T)
    step = jts.make_train_step(cfg, tx, donate=False)
    for i in range(steps):
        state, _ = step(state, tuple(jnp.asarray(a)
                                     for a in _batch(10 * seed + i)))
    if not steps:
        rng = np.random.default_rng(seed)

        def noise(a):
            a = np.asarray(a)
            if a.dtype.kind == "i":
                return np.asarray(rng.integers(1, 100), a.dtype)
            return np.abs(rng.standard_normal(a.shape)).astype(a.dtype)

        state = state.replace(opt_state=jax.tree_util.tree_map(
            noise, state.opt_state))
    return cfg, scfg, step, state


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _bits(leaf):
    """A leaf as raw bits: (dtype name, shape, bytes); bf16 read as uint16."""
    if isinstance(leaf, torch.Tensor):
        return ("bfloat16", tuple(leaf.shape),
                leaf.view(torch.int16).numpy().tobytes())
    a = np.asarray(leaf)
    name = a.dtype.name
    if name == "bfloat16":
        return (name, a.shape, a.view(np.uint16).tobytes())
    return (name, a.shape, a.tobytes())


READER = """
import json, sys
import numpy as np
sys.modules['jax'] = None
sys.modules['flax'] = None
sys.modules['msgpack'] = None
import torch
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.train.checkpoint import (
    load_checkpoint, load_params_for_inference)
root, names = sys.argv[1], sys.argv[2].split(',')
mix = torch.from_numpy(np.load(root + '/mix.npy'))
for name in names:
    path = f'{root}/{name}.ckpt'
    tree, meta = load_checkpoint(path)
    out = {}
    def walk(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f'{p}/{k}' if p else str(k))
        elif isinstance(t, torch.Tensor):
            out['bf16:' + p] = t.view(torch.int16).numpy()
        else:
            out[p] = np.asarray(t)
    walk(tree, '')
    cfg, sd = load_params_for_inference(path)
    model = ConvTasNet(cfg, use_pallas=False)
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        out['__estimate__'] = model(mix).numpy()
    np.savez(f'{root}/{name}.npz', **out)
    with open(f'{root}/{name}.json', 'w') as f:
        json.dump(meta, f)
print(sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'flax', 'msgpack', 'convtasnet_tpu') and sys.modules[m] is not None))
"""


@pytest.fixture(scope="module")
def read_back(tmp_path_factory):
    """Each case's JAX checkpoint, flax's reading of it, the JAX forward,
    and what the port read of it in a subprocess without jax, flax or
    msgpack."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    mix = np.random.default_rng(5).standard_normal((1, T)).astype(np.float32)
    np.save(root / "mix.npy", mix)
    want = {}
    for name in CASES:
        cfg, _, _, state = _jax_state(name)
        if cfg.param_dtype == "bfloat16":
            # the JAX model keeps f32 parameters whatever param_dtype says;
            # a bf16-parameter checkpoint holds bf16 leaves
            state = state.replace(params=jax.tree_util.tree_map(
                lambda a: a.astype(jnp.bfloat16), state.params))
        path = str(root / f"{name}.ckpt")
        jckpt.save_checkpoint(path, state, cfg, epoch=2, tr_loss=[1.0, 0.5],
                              cv_loss=[2.0, 1.5])
        tree, meta = jckpt.load_checkpoint(path)
        variables = {"params": tree["params"]}
        if tree.get("batch_stats"):
            variables["batch_stats"] = tree["batch_stats"]
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), variables)
        est = np.asarray(JaxConvTasNet(cfg).apply(variables,
                                                  jnp.asarray(mix)))
        want[name] = (tree, meta, est)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", READER, str(root), ",".join(CASES)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    got = {}
    for name in CASES:
        with np.load(root / f"{name}.npz") as z:
            leaves = {k: z[k] for k in z.files}
        with open(root / f"{name}.json") as f:
            got[name] = (leaves, json.load(f))
    return dict(root=root, want=want, got=got)


@pytest.mark.parametrize("name", list(CASES))
def test_every_leaf_bit_for_bit(read_back, name):
    tree, meta, _ = read_back["want"][name]
    leaves, got_meta = read_back["got"][name]
    assert got_meta == meta
    want = _flat(tree)
    seen = set()
    for path, leaf in want.items():
        w = _bits(leaf)
        if w[0] == "bfloat16":
            g = leaves["bf16:" + path]
            g = ("bfloat16", g.shape, g.tobytes())
        else:
            g = _bits(leaves[path])
        assert g == w, path
        seen.add(path)
    # and nothing the port read is missing from flax's reading
    assert {k.replace("bf16:", "") for k in leaves} - {"__estimate__"} \
        == seen
    if name == "bf16_params":
        assert any(k.startswith("bf16:params/") for k in leaves)
    if name == "bn":
        assert any(k.startswith("batch_stats/") for k in leaves)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_within_5e4_of_jax(read_back, name):
    est = read_back["want"][name][2]
    got = read_back["got"][name][0]["__estimate__"]
    assert got.shape == est.shape
    np.testing.assert_allclose(got, est, rtol=0, atol=5e-4)
    assert np.abs(est).max() > 1e-3


@pytest.mark.parametrize("name", ["gln", "bn", "adam_l2", "sgd_momentum"])
def test_resumed_step_matches_a_jax_step(tmp_path, name):
    """One port step from a JAX checkpoint against one JAX step from the
    same state, at lr 1e-4 (a JAX-halved 2e-4: the learning rate comes
    from the checkpoint's hyperparams), parameters to 2e-5 and the loss to
    1e-5; the step counts continue from the checkpoint's."""
    cfg, scfg, jstep, js = _jax_state(name, lr=2e-4, steps=2, seed=3)
    js = jts.set_lr(js, 1e-4)
    path = str(tmp_path / "resume.ckpt")
    jckpt.save_checkpoint(path, js, cfg, epoch=1)

    from convtasnet_tpu_torch.config import ConvTasNetConfig as PortConfig
    from convtasnet_tpu_torch.config import SolverConfig as PortSolver

    ps = pts.create_train_state(PortConfig.from_dict(cfg.to_dict()),
                                PortSolver(**{**scfg.to_dict(), "lr": 1.0}),
                                use_pallas=False)
    package, _ = pckpt.load_checkpoint(path)
    pckpt.restore_state(ps, package)
    assert ps.step == 2
    assert pts.get_lr(ps) == float(np.float32(1e-4))
    if scfg.optimizer == "adam":
        steps = {float(s["step"]) for s in ps.optimizer.state.values()}
        assert steps == {2.0}

    b = _batch(77)
    js, jm = jstep(js, tuple(jnp.asarray(a) for a in b))
    ps, pm = pts.make_train_step()(ps, tuple(torch.from_numpy(a) for a in b))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(
        {"params": js.params, "batch_stats": js.batch_stats}), ps.model.cfg)
    got = ps.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)
    assert ps.step == int(js.step) == 3
    if scfg.optimizer == "adam":
        steps = {float(s["step"]) for s in ps.optimizer.state.values()}
        assert steps == {3.0}


def test_optimizer_mismatch_names_both(tmp_path):
    cfg, scfg, _, js = _jax_state("gln")
    path = str(tmp_path / "adam.ckpt")
    jckpt.save_checkpoint(path, js, cfg, epoch=1)
    from convtasnet_tpu_torch.config import ConvTasNetConfig as PortConfig
    from convtasnet_tpu_torch.config import SolverConfig as PortSolver

    pcfg = PortConfig.from_dict(cfg.to_dict())
    package, _ = pckpt.load_checkpoint(path)
    for solver, want in ((PortSolver(optimizer="sgd", momentum=0.9),
                          "sgd with momentum"),
                         (PortSolver(l2=1e-3), "adam with l2")):
        ps = pts.create_train_state(pcfg, solver, use_pallas=False)
        with pytest.raises(ValueError, match=f"is adam;.*asks for {want}"):
            pckpt.restore_state(ps, package)
    # an inference checkpoint (params only) serves but does not resume
    inf = str(tmp_path / "params_only.ckpt")
    jckpt.save_checkpoint(inf, {"params": js.params}, cfg, epoch=1)
    package, _ = pckpt.load_checkpoint(inf)
    ps = pts.create_train_state(pcfg, PortSolver(), use_pallas=False)
    with pytest.raises(ValueError, match="no optimizer state"):
        pckpt.restore_state(ps, package)


def test_chunked_arrays_decode(monkeypatch):
    """flax splits arrays above MAX_CHUNK_SIZE bytes into chunk maps; with a
    64-byte limit every array here is chunked, also a bf16 one."""
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 9)).astype(np.float32),
            "b": {"c": np.arange(100, dtype=np.int32).reshape(4, 25),
                  "d": np.asarray(jnp.asarray(rng.standard_normal(50),
                                              jnp.bfloat16)),
                  "small": np.float32(3.5)}}
    payload = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in payload
    got = msgpack_restore(payload)
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"]["c"], tree["b"]["c"])
    assert got["b"]["small"] == np.float32(3.5)
    assert got["b"]["d"].dtype == torch.bfloat16
    assert (got["b"]["d"].view(torch.int16).numpy().tobytes()
            == tree["b"]["d"].view(np.uint16).tobytes())


def _jax_file(tmp_path, payload: bytes, meta=None) -> str:
    meta_bytes = json.dumps(meta or {"model": {}}).encode()
    path = str(tmp_path / "x.ckpt")
    with open(path, "wb") as f:
        f.write(pckpt.JAX_MAGIC + struct.pack("<Q", len(meta_bytes))
                + meta_bytes + payload)
    return path


def test_orbax_truncated_and_unknown_ext_raise(tmp_path):
    orbax = tmp_path / "orbax_ckpt"
    (orbax / "state").mkdir(parents=True)
    (orbax / "meta.json").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        pckpt.load_checkpoint(str(orbax))

    cfg, _, _, js = _jax_state("gln")
    good = str(tmp_path / "good.ckpt")
    jckpt.save_checkpoint(good, js, cfg, epoch=1)
    data = open(good, "rb").read()
    for cut in (12, 40, len(data) // 2, len(data) - 1):
        bad = str(tmp_path / f"cut{cut}.ckpt")
        with open(bad, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(ValueError, match="offset"):
            pckpt.load_checkpoint(bad)
    with pytest.raises(ValueError, match="trailing bytes at offset"):
        pckpt.load_checkpoint(_jax_file(tmp_path, b"\x80\x00"))
    # fixext 1 of code 5: flax writes ext codes 1-3 only
    with pytest.raises(ValueError, match="unknown msgpack ext code 5 at "
                                         "offset"):
        pckpt.load_checkpoint(_jax_file(tmp_path,
                                        b"\x81\xa6params\xd4\x05\x00"))
    with pytest.raises(ValueError, match="format byte 0xc1 at offset"):
        pckpt.load_checkpoint(_jax_file(tmp_path, b"\x81\xa1a\xc1"))
    # a length past the end of the stream
    with pytest.raises(ValueError, match="truncated at offset"):
        msgpack_restore(b"\xdb\x00\x00\x10\x00abc")


def test_committed_fixtures_reproduce_their_estimates():
    """The committed fixtures through the JAX package give the estimates
    stored beside them, and through the port's plain path (CPU) they are
    within 5e-4."""
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

    z = np.load(os.path.join(FIXTURES, "jax_fixtures.npz"))
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in (
        "jax_tcn.ckpt", "jax_dpt.ckpt", "jax_fixtures.npz"))
    assert total < 1_000_000
    for name, separator in (("tcn", "tcn"), ("dpt", "dpt")):
        path = os.path.join(FIXTURES, f"jax_{name}.ckpt")
        cfg, variables = jckpt.load_params_for_inference(path)
        assert cfg.separator == separator and cfg.use_pallas is False
        est = np.asarray(JaxConvTasNet(cfg).apply(
            variables, jnp.asarray(z["mixture"])))
        want = z[f"{name}_est"]
        assert est.shape == want.shape == (1, 2, z["mixture"].shape[1])
        err = np.linalg.norm(est - want) / np.linalg.norm(want)
        assert err <= 1e-5, (name, err)
        tree, meta = jckpt.load_checkpoint(path)
        assert int(tree["step"]) == 2 and meta["epoch"] == 1
        adam = tree["opt_state"]["inner_state"]["1"]["0"]
        assert int(adam["count"]) == 2
        assert all(np.abs(v).max() > 0 for v in _flat(adam["mu"]).values()
                   if np.size(v) > 1)
        pcfg, sd = pckpt.load_params_for_inference(path)
        model = ConvTasNet(pcfg, use_pallas=False)
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            got = model(torch.from_numpy(z["mixture"])).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_cli_train_continues_a_jax_checkpoint(tmp_path, monkeypatch):
    """``cli train --continue-from`` the committed TCN fixture on the CPU:
    the fixture is at epoch 1 of 2, so one epoch runs; its checkpoint
    holds the step count and the Adam step continued from the fixture's 2."""
    from convtasnet_tpu_torch import cli
    from tests.test_data import _write_corpus

    data = str(tmp_path / "wav")
    _write_corpus(data, [4000, 4800, 5600, 6400], split="tr", seed=1)
    _write_corpus(data, [4000], split="cv", seed=2)
    json_dir = str(tmp_path / "json")
    assert cli.main(["preprocess", "--data-dir", data, "--out-dir",
                     json_dir]) == 0
    tree, meta = jckpt.load_checkpoint(
        os.path.join(FIXTURES, "jax_tcn.ckpt"))
    m = meta["model"]
    out = str(tmp_path / "exp")
    monkeypatch.setenv("CONVTASNET_SEGMENT_CACHE", "0")
    rc = cli.main([
        "train", "--train-dir", os.path.join(json_dir, "tr"),
        "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder", out,
        "--device", "cpu", "--N", str(m["n_filters"]), "--L",
        str(m["kernel_size"]), "--B", str(m["bottleneck"]), "--H",
        str(m["hidden"]), "--X", str(m["num_blocks"]), "--R",
        str(m["num_repeats"]), "--segment", "0.5", "--batch-size", "2",
        "--epochs", "2", "--print-freq", "1", "--enable-checkpoint", "1",
        "--continue-from", os.path.join(FIXTURES, "jax_tcn.ckpt")])
    assert rc == 0
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    n_steps = sum(r["kind"] == "iter" for r in records)
    assert n_steps > 0
    assert {r["epoch"] for r in records if r["kind"] == "iter"} == {1}
    package, pmeta = pckpt.load_checkpoint(
        os.path.join(out, "checkpoint_models", "epoch2.ckpt"))
    assert package["step"] == int(tree["step"]) + n_steps
    steps = {float(s["step"]) for s in package["optimizer"]["state"].values()}
    assert steps == {float(int(tree["step"]) + n_steps)}
    assert pmeta["epoch"] == 2 and len(pmeta["tr_loss"]) == 2
