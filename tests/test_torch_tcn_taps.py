"""TCN blocks with more than 16 depthwise taps, against the JAX package.

The JAX package runs a TCN block with any number of taps P (any P causal,
any odd P otherwise: ``convtasnet_tpu/ops/conv.py``), in its XLA math and
in its Pallas kernels. The port's kernels B1-B6 take the same P on the
card: P <= 16 on their first routes and more taps in chunks of 16 beside
them (``csrc/tcn_block.cu``, ``csrc/tcn_block_bwd.cu``), every sum over the
taps in the order q = 0..P-1 as at P <= 16, so their plain twins, which
take any P, stay the reference. Here, at small widths (M = 2, K = 300,
B = 32, H = 64) on numpy inputs made from a seed:

- the rules: ``shape_refusal`` of B1-B5 and of B6 takes every P the JAX
  package runs and refuses an even P outside the causal mode in JAX's
  words, and ``shapes.refusals`` is empty for the paper config at P = 17;
- the twins of B1 (gLN, cLN causal, BN), B2 and B3 at P = 17 and 33
  (d = 16: at P = 33 the halo of 512 rows is longer than K) against JAX's
  ``_xla_block`` and ``jax.vjp`` of it, B1's against the Pallas kernel in
  interpret mode, and the differentiable block against JAX's
  ``fused_tcn_block_ad`` (whose Pallas backward takes at most 8 taps, so
  JAX trains such a block through its XLA backward), at the bars of
  ``tests/test_torch_tcn_block*.py``;
- the pair twins (B4, B5) and B6's twin at P = 17 against JAX's pair and
  TP kernels;
- a model at P = 17 through the kernels' twins against the JAX model:
  its forward (gLN, cLN causal), and one Adam step (gLN) from the same
  weights.

The kernels themselves are held against the twins on the card in
``tests/test_torch_cuda.py`` (``-k taps``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.config import SolverConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu.ops import conv as jax_conv
from convtasnet_tpu.ops.pallas import tcn_block as jax_tcn
from convtasnet_tpu.ops.pallas import tcn_block_pair as jax_pair
from convtasnet_tpu.ops.pallas import tcn_block_tp as jax_tp
from convtasnet_tpu.train import train_step as jts
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models import conv_tasnet as pmodel
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.ops.cuda import shapes
from convtasnet_tpu_torch.ops.cuda import tcn_block as port
from convtasnet_tpu_torch.ops.cuda import tcn_block_bwd as port_bwd
from convtasnet_tpu_torch.ops.cuda import tcn_block_pair as port_pair
from convtasnet_tpu_torch.ops.cuda import tcn_block_pair_bwd as port_pair_bwd
from convtasnet_tpu_torch.ops.cuda import tcn_block_tp as port_tp
from convtasnet_tpu_torch.train import train_step as pts

M, K, B, H = 2, 300, 32, 64   # K is not a multiple of any tile
ORDER = ("x", "w_in", "dw", "w_out", "a1", "a2", "g1", "b1", "g2", "b2")
NAMES = ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2",
         "dg1", "db1", "dg2", "db2")


# --------------------------------------------------------------------------
# The rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P,causal", [(17, True), (33, True), (64, True),
                                      (17, False), (65, False)])
def test_rules_take_every_p_the_jax_package_runs(P, causal):
    """B1-B5 and B6 take P past the old limit of 16, causal or odd."""
    assert port.shape_refusal(B, H, P, causal) is None
    assert port_pair.shape_refusal(B, H, P, causal) is None
    assert port_tp.shape_refusal(256, 256, P, causal) is None
    assert not hasattr(port, "MAX_TAPS") and not hasattr(port_tp, "MAX_TAPS")


def test_rules_refuse_an_even_p_outside_the_causal_mode_as_jax_does():
    """P = 4 without the causal mode has no SAME padding: every kernel's
    rule refuses it in the words JAX's depthwise conv raises."""
    with pytest.raises(ValueError) as err:
        jax_conv.depthwise_conv1d(jnp.zeros((1, 8, 2)), jnp.zeros((4, 2)), 1,
                                  False)
    for got in (port.shape_refusal(B, H, 4, False),
                port_pair.shape_refusal(B, H, 4, False),
                port_tp.shape_refusal(256, 256, 4, False)):
        assert got == f"{err.value}, got P=4"


@pytest.mark.parametrize("overrides,n_model,pairs", [
    (dict(conv_kernel=17), 1, False),
    (dict(conv_kernel=17), 1, True),
    (dict(conv_kernel=17), 2, False),
    (dict(conv_kernel=17, norm_type="cLN", causal=True), 1, True),
    (dict(conv_kernel=64, norm_type="cLN", causal=True), 1, False),
], ids=["P17", "P17-pairs", "P17-tp2", "P17-cLN-causal-pairs",
        "P64-cLN-causal"])
def test_paper_config_with_many_taps_runs_the_kernels(overrides, n_model,
                                                      pairs):
    """No kind of block refuses the paper config at P = 17 (pairs, two
    shards, cLN causal) or 64 causal: on the card it runs the kernels."""
    cfg = ConvTasNetConfig(**overrides)
    assert shapes.refusals(cfg, n_model, pairs) == {}
    assert shapes.use_kernels(cfg, None, torch.device("cuda"), n_model,
                              pairs)


# --------------------------------------------------------------------------
# The block twins (B1, B2, B3) against JAX
# --------------------------------------------------------------------------

def _inputs(P, norm_type="gLN", seed=0, a2=0.3):
    """Seeded f32 block operands (P taps of the scale three taps have in
    ``tests/test_torch_tcn_block.py``, spread over P) and a cotangent."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.standard_normal((M, K, B)),
        w_in=rng.standard_normal((B, H)) / np.sqrt(B),
        dw=rng.standard_normal((P, H)) * np.sqrt(3.0 / P),
        w_out=rng.standard_normal((H, B)) / np.sqrt(H),
        a1=np.array(0.25), a2=np.array(a2),
        g1=1.0 + 0.3 * rng.standard_normal(H), b1=rng.standard_normal(H),
        g2=1.0 + 0.3 * rng.standard_normal(H), b2=rng.standard_normal(H),
    )
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    bn = None
    if norm_type == "BN":
        bn = tuple((np.abs(rng.standard_normal(H)) + 0.5).astype(np.float32)
                   for _ in range(4))
    g = rng.standard_normal((M, K, B)).astype(np.float32)
    return arrs, bn, g


def _port_block(arrs, bn, norm_type, causal, d):
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    bn_t = None if bn is None else tuple(torch.from_numpy(s) for s in bn)
    return port.fused_tcn_block_reference(
        *args, dilation=d, causal=causal, norm_type=norm_type,
        bn_stats=bn_t).numpy()


def _xla_block(arrs, bn, norm_type, causal, d):
    stats = bn if bn is not None else (np.zeros(H, np.float32),
                                       np.ones(H, np.float32)) * 2
    block = jax.jit(functools.partial(jax_tcn._xla_block,
                                      (d, causal, norm_type)))
    return block(*[jnp.asarray(arrs[n]) for n in ORDER],
                 *[jnp.asarray(s) for s in stats])


# (norm, causal, P, dilation): gLN non-causal, cLN causal and BN at 17
# taps, and 33 taps at d = 16, whose halo (512 rows) is longer than K
BLOCK_CASES = [("gLN", False, 17, 16), ("cLN", True, 17, 16),
               ("BN", False, 17, 4), ("gLN", True, 33, 16),
               ("cLN", False, 33, 16)]


@pytest.mark.parametrize("norm_type,causal,P,dilation", BLOCK_CASES)
def test_block_twin_matches_jax_xla_block(norm_type, causal, P, dilation):
    """B1's twin against ``_xla_block`` at the bar of
    ``tests/test_torch_tcn_block.py`` (the same f32 math in another
    summation order)."""
    arrs, bn, _ = _inputs(P, norm_type, seed=P)
    got = _port_block(arrs, bn, norm_type, causal, dilation)
    want = _xla_block(arrs, bn, norm_type, causal, dilation)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("norm_type,causal,P,dilation", [
    ("gLN", False, 17, 16), ("cLN", True, 17, 16), ("BN", False, 17, 4),
    ("gLN", True, 33, 16)])
def test_block_twin_matches_pallas_interpret(norm_type, causal, P,
                                             dilation):
    """B1's twin against the Pallas ``_kernel`` in interpret mode at the
    bar of ``tests/test_torch_tcn_block.py`` (the kernel takes its
    statistics in one pass and folds gLN into the taps and W_out)."""
    arrs, bn, _ = _inputs(P, norm_type, seed=100 + P)
    got = _port_block(arrs, bn, norm_type, causal, dilation)
    want = jax_tcn.fused_tcn_block(
        *[jnp.asarray(arrs[n]) for n in ORDER], dilation=dilation,
        causal=causal, norm_type=norm_type,
        bn_stats=None if bn is None else tuple(jnp.asarray(s) for s in bn),
        tile=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2, atol=2e-2)


def _port_grads(arrs, g, causal, d, norm_type):
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    grads = port_bwd.fused_tcn_block_bwd(
        args[0], torch.from_numpy(g), *args[1:], dilation=d, causal=causal,
        norm_type=norm_type)
    return [t.numpy() for t in grads]


def _assert_cotangents(got, want, atol):
    """Each cotangent scaled by its largest entry, as
    ``tests/test_torch_tcn_block_bwd.py`` compares them."""
    assert len(got) == len(want) == 10
    for name, q, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert q.shape == w.shape, name
        scale = np.max(np.abs(w)) + 1e-9
        np.testing.assert_allclose(q / scale, w / scale, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("norm_type,causal,P,dilation", [
    ("gLN", False, 17, 16), ("cLN", True, 17, 16), ("gLN", True, 33, 16),
    ("cLN", False, 33, 16)])
def test_bwd_twin_matches_jax_vjp(norm_type, causal, P, dilation):
    """B2's and B3's twin, all ten cotangents, against ``jax.vjp`` of
    ``_xla_block`` at the bar of ``tests/test_torch_tcn_block_bwd.py``
    (f32 autodiff of the same math on both sides)."""
    arrs, _, g = _inputs(P, seed=200 + P, a2=-0.1)
    got = _port_grads(arrs, g, causal, dilation, norm_type)

    def block(*a):
        return jax_tcn._xla_block((dilation, causal, norm_type), *a,
                                  jnp.zeros(H), jnp.ones(H),
                                  jnp.zeros(H), jnp.ones(H))

    _, vjp = jax.vjp(jax.jit(block), *[jnp.asarray(arrs[n]) for n in ORDER])
    _assert_cotangents(got, vjp(jnp.asarray(g)), atol=2e-5)


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
def test_fused_block_ad_matches_jax(norm_type, causal):
    """Gradients of a scalar loss through the port's differentiable block
    at P = 17 (B1's and B2's or B3's twins), x and all nine weights,
    against JAX's ``fused_tcn_block_ad``: its Pallas forward in interpret
    mode and, since JAX's Pallas backward packs at most 8 taps' d_dw rows
    (``tcn_block_bwd.py``: ``assert P <= 8``), its default backward, the
    XLA block rematerialised and differentiated. The bar of
    ``tests/test_torch_tcn_block_bwd.py``'s test of the same pair."""
    arrs, _, w = _inputs(17, seed=300, a2=-0.1)

    def jax_loss(*a):
        out = jax_tcn.fused_tcn_block_ad(
            *a, dilation=16, causal=causal, norm_type=norm_type, tile=128,
            interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.jit(jax.grad(jax_loss, argnums=tuple(range(10))))(
        *[jnp.asarray(arrs[n]) for n in ORDER])
    prims = [torch.from_numpy(arrs[n]).requires_grad_(True) for n in ORDER]
    out = port.fused_tcn_block_ad(*prims, dilation=16, causal=causal,
                                  norm_type=norm_type)
    (out * torch.from_numpy(w)).sum().backward()
    _assert_cotangents([p.grad.numpy() for p in prims], want, atol=5e-5)


# --------------------------------------------------------------------------
# The pair twins (B4, B5) and B6's twin against JAX
# --------------------------------------------------------------------------

def _pair_inputs(P, seed):
    """x, two blocks' operands at P taps (block 2's second slope
    negative) and a cotangent, f32."""
    a, _, g = _inputs(P, seed=seed)
    b, _, _ = _inputs(P, seed=seed + 1, a2=-0.1)
    return (a["x"], [a[n] for n in ORDER[1:]], [b[n] for n in ORDER[1:]], g)


def test_pair_twin_matches_pallas_interpret():
    """B4's twin at P = 17 against the Pallas pair kernel in interpret
    mode, at the single block's interpret bar, and against two chained
    ``_xla_block`` calls at the single block's XLA bar."""
    x, pa, pb, _ = _pair_inputs(17, 400)
    kw = dict(d1=4, d2=8, causal=False, norm_type="gLN")
    got = port_pair.fused_tcn_block_pair_reference(
        torch.from_numpy(x), [torch.from_numpy(a) for a in pa],
        [torch.from_numpy(a) for a in pb], **kw).numpy()
    want = jax_pair.fused_tcn_block_pair(
        jnp.asarray(x), [jnp.asarray(a) for a in pa],
        [jnp.asarray(a) for a in pb], tile=128, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2, atol=2e-2)
    ones, zeros = jnp.ones(H), jnp.zeros(H)
    chain = x
    for p, d in ((pa, 4), (pb, 8)):
        chain = jax_tcn._xla_block((d, False, "gLN"), jnp.asarray(chain),
                                   *[jnp.asarray(a) for a in p], zeros, ones,
                                   zeros, ones)
    np.testing.assert_allclose(got, np.asarray(chain), rtol=1e-3, atol=2e-4)


def test_pair_bwd_twin_matches_jax_vjp():
    """B5's twin at P = 17, dx and both blocks' nine gradients, against
    ``jax.vjp`` of the two chained ``_xla_block`` calls, at the bar of
    ``tests/test_torch_tcn_block_bwd.py``."""
    x, pa, pb, g = _pair_inputs(17, 500)
    dx, ga, gb = port_pair_bwd.fused_tcn_block_pair_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(g),
        [torch.from_numpy(a) for a in pa], [torch.from_numpy(a) for a in pb],
        d1=1, d2=2, causal=False)

    def chain(xx, *p18):
        ones, zeros = jnp.ones(H), jnp.zeros(H)
        y = xx
        for p, d in ((p18[:9], 1), (p18[9:], 2)):
            y = jax_tcn._xla_block((d, False, "gLN"), y, *p, zeros, ones,
                                   zeros, ones)
        return y

    _, vjp = jax.vjp(jax.jit(chain),
                     *[jnp.asarray(a) for a in (x, *pa, *pb)])
    want = vjp(jnp.asarray(g))
    got = [dx, *ga, *gb]
    assert len(got) == len(want) == 19
    for i, (q, w) in enumerate(zip(got, want)):
        q, w = q.detach().numpy(), np.asarray(w)
        scale = np.max(np.abs(w)) + 1e-9
        np.testing.assert_allclose(q / scale, w / scale, atol=2e-5,
                                   err_msg=str(i))


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5),
                                       ("bfloat16", 4e-2)])
def test_tp_stage2_twin_matches_jax(dtype, bar):
    """B6's twin at P = 17 (d = 4, non-causal) against ``xla_tp_stage2``
    and the Pallas stage 2 in interpret mode, at the bars of
    ``tests/test_torch_tcn_tp.py``, and at the Pallas kernel's rounding
    points within its order bar (1e-5 f32, 1e-3 bf16)."""
    rng = np.random.default_rng(17)
    Hs, Bw, Kt, P = 8, 6, 37, 17
    arrs = [rng.standard_normal((M, Kt, Hs)),
            np.stack([rng.standard_normal(M) * 0.1,
                      1.0 + 0.2 * rng.random(M)], -1),
            rng.standard_normal((P, Hs)) / np.sqrt(P),
            rng.standard_normal((Hs, Bw)) / np.sqrt(Hs), np.array(0.25),
            rng.standard_normal(Hs) * 0.1 + 1.0,
            rng.standard_normal(Hs) * 0.1, rng.standard_normal(Hs) * 0.1 + 1.0]
    arrs = [a.astype(np.float32) for a in arrs]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt if i == 0 else jnp.float32)
             for i, a in enumerate(arrs)]
    targs = [torch.from_numpy(a).to(tdt if i == 0 else torch.float32)
             for i, a in enumerate(arrs)]
    kw = dict(dilation=4, causal=False)

    def rel(got, want):
        got = got.float().numpy() if isinstance(got, torch.Tensor) else got
        got = np.asarray(got, np.float64)
        want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    z, sums = port_tp.tp_stage2_reference(*targs, **kw)
    z_ord, s_ord = port_tp.tp_stage2_reference(*targs, **kw,
                                               rounding="pallas")
    xla = jax.jit(functools.partial(jax_tp.xla_tp_stage2, **kw))(*jargs)
    fused = jax.jit(functools.partial(jax_tp.fused_tp_stage2, tile=16,
                                      interpret=True, **kw))(*jargs)
    for z_want, s_want in (xla, fused):
        assert rel(z, z_want) <= bar and rel(sums, s_want) <= bar
    order = 1e-5 if dtype == "float32" else 1e-3
    assert rel(z_ord, fused[0]) <= order and rel(s_ord, fused[1]) <= order


# --------------------------------------------------------------------------
# The whole model at P = 17
# --------------------------------------------------------------------------

MODEL = dict(n_filters=16, kernel_size=8, bottleneck=B, hidden=H,
             conv_kernel=17, num_blocks=2, num_repeats=1)


@pytest.fixture
def kernels_in_use(monkeypatch):
    """The port's model with its kernels in use on CPU tensors, where every
    kernel wrapper runs its plain twin: B1 serving, B1 and B2 or B3 (their
    autograd Function) training."""
    monkeypatch.setattr(pmodel, "use_kernels", lambda *a, **k: True)


@pytest.mark.parametrize("overrides", [dict(),
                                       dict(norm_type="cLN", causal=True)],
                         ids=["gLN", "cLN-causal"])
def test_model_forward_matches_jax(kernels_in_use, overrides):
    """The forward at P = 17 through the twins of B1 against the JAX model
    on the same weights, at the bar of ``tests/test_torch_model.py``
    (its XLA path: the Pallas forward at P = 17 is held against B1's twin
    above)."""
    jcfg = JaxConfig(**MODEL, **overrides)
    rng = np.random.default_rng(3)

    def leaf(path, shape):   # seeded weights, every affine off its init
        r = rng.standard_normal(shape.shape).astype(np.float32)
        if path[-1].key == "gamma":
            return 1.0 + 0.1 * r
        if not shape.shape:   # a PReLU slope
            return np.float32(0.25) + 0.05 * r
        return r / np.float32(np.sqrt(shape.shape[0]))

    variables = jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(
        lambda k: jmodel.init_params(jcfg, k, example_len=400),
        jax.random.PRNGKey(0)))
    cfg = ConvTasNetConfig(**MODEL, **overrides)
    model = pmodel.ConvTasNet(cfg).eval()
    model.load_state_dict(state_dict_from_jax(jax.device_get(variables),
                                              cfg))
    mix = np.random.default_rng(4).standard_normal((2, 800)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mix)).numpy()
    want = jax.jit(functools.partial(jmodel.ConvTasNet(jcfg).apply,
                                     train=False))(variables, jnp.asarray(mix))
    assert got.shape == (2, 2, 800)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("overrides", [dict()], ids=["gLN"])
def test_model_adam_step_matches_jax(kernels_in_use, monkeypatch,
                                     overrides):
    """One Adam step at P = 17, the port through the twins of B1 and B2
    (the cLN block's B3 twin is held against jax.vjp above), from the JAX
    init carried across, against JAX's
    step: loss and gradient norm to 1e-5 relative and the parameters to
    2e-5, the bars of ``tests/test_torch_train.py``."""
    solver = SolverConfig(lr=1e-3, max_grad_norm=5.0, save_folder="")
    jcfg = JaxConfig(**MODEL, **overrides)
    js, tx = jts.create_train_state(jcfg, solver, jax.random.PRNGKey(0),
                                    1600)
    cfg = ConvTasNetConfig(**MODEL, **overrides)
    sd = state_dict_from_jax(jax.device_get(
        {"params": js.params, "batch_stats": js.batch_stats}), cfg)
    ps = pts.create_train_state(cfg, solver, state_dict=sd)
    rng = np.random.default_rng(10)
    batch = (rng.standard_normal((4, 1600)).astype(np.float32),
             np.full((4,), 1600, np.int32),
             rng.standard_normal((4, 2, 1600)).astype(np.float32),
             np.asarray((1, 1, 1, 0), np.float32))
    calls = {"ad": 0}
    real = pmodel.fused_tcn_block_ad

    def counted(*a, **k):
        calls["ad"] += 1
        return real(*a, **k)

    monkeypatch.setattr(pmodel, "fused_tcn_block_ad", counted)
    ps, pm = pts.make_train_step()(
        ps, tuple(torch.from_numpy(np.array(a)) for a in batch))
    assert calls["ad"] == cfg.num_blocks * cfg.num_repeats
    js, jm = jts.make_train_step(jcfg, tx, donate=False)(
        js, tuple(jnp.asarray(a) for a in batch))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(
        {"params": js.params, "batch_stats": js.batch_stats}), cfg)
    got = ps.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)

