"""The port's TCN block pair (B4, B5 and the separator's pair routing)
against the JAX package's.

``fused_tcn_block_pair_reference`` (the plain twin of kernel B4) is held
against the Pallas ``fused_tcn_block_pair`` in interpret mode and against
two chained ``_xla_block`` calls; ``fused_tcn_block_pair_bwd_reference``
(the twin of B5) against the Pallas ``fused_tcn_block_pair_bwd`` in
interpret mode and ``jax.vjp`` of the chained blocks, on all 19
cotangents, and each of them, the PReLU-slope gradients one by one,
against the pair evaluated in float64. The port's TCN with its kernels in use (on CPU tensors: the
twins) runs blocks (x, x+1) as pairs where the JAX model with
``use_pallas=True`` does, and matches it forward and in every gradient;
``CONVTASNET_PAIR_FUSION=0`` runs every block singly. The kernels
themselves are held against the twins on the card in
``tests/test_torch_cuda.py``.
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
from convtasnet_tpu.ops.pallas import tcn_block as jax_tcn
from convtasnet_tpu.ops.pallas import tcn_block_pair as jax_pair
from convtasnet_tpu.ops.pallas import tcn_block_pair_bwd as jax_pair_bwd
from convtasnet_tpu_torch.models import conv_tasnet as pmodel
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.ops.conv import depthwise_conv1d, prelu
from convtasnet_tpu_torch.ops.cuda import tcn_block_pair as port
from convtasnet_tpu_torch.ops.cuda import tcn_block_pair_bwd as port_bwd
from convtasnet_tpu_torch.ops.norm import global_layer_norm

M, K, B, H, P = 2, 300, 64, 128, 3   # K is not a multiple of any tile
NAMES = ("dW_in", "d_dw", "dW_out", "da1", "da2", "dg1", "db1", "dg2", "db2")
# the interpret-mode Pallas kernels are slow on the CPU: one dilation pair
# per mode, so that (1, 2) and (4, 8) each still appear
MODES = [("gLN", False, 4), ("gLN", True, 1), ("cLN", False, 1),
         ("cLN", True, 4)]


@pytest.fixture(autouse=True)
def pairs_on(monkeypatch):
    """Pair fusion on: the port's default is off and tests/conftest.py
    turns it off for JAX's model tests; both packages read the switch at
    call time."""
    monkeypatch.setenv("CONVTASNET_PAIR_FUSION", "1")


def _block_params(rng, a2):
    """One block's f32 operands; random norm affines make every term
    count."""
    return [rng.standard_normal((B, H)) / np.sqrt(B),
            rng.standard_normal((P, H)) * 0.5,
            rng.standard_normal((H, B)) / np.sqrt(H),
            np.array(0.25), np.array(a2),
            1.0 + 0.3 * rng.standard_normal(H), rng.standard_normal(H),
            1.0 + 0.3 * rng.standard_normal(H), rng.standard_normal(H)]


def _inputs(seed):
    """x, the two blocks' parameters and a cotangent; block 2's second
    slope is negative, the sign flip of PReLU'."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K, B))
    pa, pb = _block_params(rng, 0.3), _block_params(rng, -0.1)
    g = rng.standard_normal((M, K, B))
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return f32(x), [f32(v) for v in pa], [f32(v) for v in pb], f32(g)


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _xla_chain(x, pa, pb, d1, causal, norm_type):
    ones, zeros = jnp.ones(H), jnp.zeros(H)   # BN statistics, unused

    def block(y, p, d):
        return jax_tcn._xla_block((d, causal, norm_type), y, *p, zeros, ones,
                                  zeros, ones)

    return block(block(x, pa, d1), pb, 2 * d1)


@pytest.mark.parametrize("norm_type,causal", [
    ("gLN", False), ("gLN", True), ("cLN", False), ("cLN", True)])
@pytest.mark.parametrize("d1", [1, 4])
def test_twin_matches_jax_xla_chain(norm_type, causal, d1):
    x, pa, pb, _ = _inputs(seed=d1)
    got = port.fused_tcn_block_pair_reference(
        torch.from_numpy(x), _t(pa), _t(pb), d1=d1, d2=2 * d1, causal=causal,
        norm_type=norm_type).numpy()
    want = _xla_chain(jnp.asarray(x), _j(pa), _j(pb), d1, causal, norm_type)
    # the single-block bar (tests/test_torch_tcn_block.py): the same f32
    # math in another summation order, through two blocks
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("norm_type,causal,d1", MODES)
def test_twin_matches_pallas_interpret(norm_type, causal, d1):
    x, pa, pb, _ = _inputs(seed=10 + d1)
    got = port.fused_tcn_block_pair_reference(
        torch.from_numpy(x), _t(pa), _t(pb), d1=d1, d2=2 * d1, causal=causal,
        norm_type=norm_type).numpy()
    want = jax_pair.fused_tcn_block_pair(
        jnp.asarray(x), _j(pa), _j(pb), d1=d1, d2=2 * d1, causal=causal,
        norm_type=norm_type, tile=128, interpret=True)
    # the single-block interpret bar (tests/test_torch_tcn_block.py): the
    # Pallas kernel takes its statistics as E[h^2]-mean^2 in one pass and
    # folds gLN into the taps and W_out
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2, atol=2e-2)


def _assert_cotangents(got, want, atol):
    """dx and both blocks' nine gradients, each scaled by its largest
    entry, as tests/test_torch_tcn_block_bwd.py compares them; the four
    scalar PReLU-slope gradients as one vector, as tests/test_torch_train.py
    holds them: each is a sum of cancelling terms, and two f32 evaluations
    can sit on either side of its value (block 1's da2 at d1=4, seed 34:
    the port 2.5e-5 below the float64 value, JAX's Pallas and autodiff
    evaluations 4.6e-5 and 5.5e-5 above it, so the port and JAX part by
    7e-5). test_bwd_twin_each_slope_matches_f64 holds them one by one."""
    dx, ga, gb = got
    wdx, wa, wb = want
    assert len(ga) == len(gb) == 9
    slope = [i for i, n in enumerate(NAMES) if n in ("da1", "da2")]
    pairs = [("dx", dx, wdx)] + [
        (f"{blk} {n}", q, w) for blk, qs, ws in (("a", ga, wa), ("b", gb, wb))
        for i, (n, q, w) in enumerate(zip(NAMES, qs, ws)) if i not in slope]
    pairs.append(("the slopes",
                  torch.stack([qs[i].reshape(()) for qs in (ga, gb)
                               for i in slope]),
                  np.stack([np.asarray(ws[i]).reshape(()) for ws in (wa, wb)
                            for i in slope])))
    assert len(pairs) == 16
    for name, q, w in pairs:
        q, w = q.detach().numpy(), np.asarray(w)
        assert q.shape == w.shape, name
        scale = np.max(np.abs(w)) + 1e-9
        np.testing.assert_allclose(q / scale, w / scale, atol=atol,
                                   err_msg=name)


def _port_bwd(x, g, pa, pb, d1, causal):
    return port_bwd.fused_tcn_block_pair_bwd(
        torch.from_numpy(x), torch.from_numpy(g), _t(pa), _t(pb), d1=d1,
        d2=2 * d1, causal=causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d1", [1, 4])
def test_bwd_twin_matches_jax_vjp(causal, d1):
    # seed 120 + d1: at seed 24, causal, block 2's input pre-activation at
    # [1, 42, 115] is 4.3e-7 in float64 and the port's f32 rounds it to
    # -1.2e-8, the other PReLU branch (dx off by 2.7e-2 on three rows):
    # at seed 24 non-causal JAX's f32 autodiff flips one instead, and its
    # da1 reads 4e-4 from the float64 value where the port's reads 4e-6.
    # A kink of the function within f32 rounding, not a fault of either
    x, pa, pb, g = _inputs(seed=120 + d1)
    got = _port_bwd(x, g, pa, pb, d1, causal)

    def chain(xx, *p18):
        return _xla_chain(xx, p18[:9], p18[9:], d1, causal, "gLN")

    _, vjp = jax.vjp(chain, jnp.asarray(x), *_j(pa), *_j(pb))
    cots = vjp(jnp.asarray(g))
    # f32 autodiff of the same math on both sides: the bar is rounding
    # (tests/test_torch_tcn_block_bwd.py)
    _assert_cotangents(got, (cots[0], cots[1:10], cots[10:]), atol=2e-5)


@pytest.mark.parametrize("causal,d1", [(False, 4), (True, 1)])
def test_bwd_twin_matches_pallas_interpret(causal, d1):
    x, pa, pb, g = _inputs(seed=30 + d1)
    got = _port_bwd(x, g, pa, pb, d1, causal)
    want = jax_pair_bwd.fused_tcn_block_pair_bwd(
        jnp.asarray(x), jnp.asarray(g), _j(pa), _j(pb), d1=d1, d2=2 * d1,
        causal=causal, tile=128, interpret=True)
    # the bar of the single-block backward against the Pallas kernel
    # (tests/test_torch_tcn_block_bwd.py)
    _assert_cotangents(got, want, atol=5e-5)


def _f64_chain_cotangents(x, pa, pb, g, d1, causal):
    """All 19 cotangents of the gLN pair evaluated in float64 (torch
    autograd through the block's math, every product and statistic in
    f64): the witness that says which f32 evaluation sits nearer the
    value."""
    def block(y, p, d):
        w_in, dw, w_out, a1, a2, g1, b1, g2, b2 = p
        h = global_layer_norm(prelu(y @ w_in, a1), g1, b1)
        h = global_layer_norm(prelu(depthwise_conv1d(h, dw, d, causal), a2),
                              g2, b2)
        return y + h @ w_out

    prims = [torch.from_numpy(np.asarray(a, np.float64)).requires_grad_(True)
             for a in (x, *pa, *pb)]
    out = block(block(prims[0], prims[1:10], d1), prims[10:], 2 * d1)
    cots = torch.autograd.grad(out, prims,
                               torch.from_numpy(g.astype(np.float64)))
    return cots[0], cots[1:10], cots[10:]


@pytest.mark.parametrize("seed,d1,causal", [
    (34, 4, False), (31, 1, True), (121, 1, False), (124, 4, True)])
def test_bwd_twin_each_slope_matches_f64(seed, d1, causal):
    """Every one of the 19 cotangents of the twin, the four PReLU-slope
    gradients one by one, against the pair evaluated in float64, on the
    inputs of the two tests above. Against f64 the port's slope gradients
    read at most 2.5e-5 relative (block 1's da2, seed 34), where JAX's two
    f32 evaluations read 4.6e-5 (Pallas) and 5.5e-5 (autodiff) on either
    side of the value: so the slopes are held against JAX as one vector
    and here one by one."""
    x, pa, pb, g = _inputs(seed=seed)
    got = _port_bwd(x, g, pa, pb, d1, causal)
    want = _f64_chain_cotangents(x, pa, pb, g, d1, causal)
    flat = [("dx", got[0], want[0])] + [
        (f"{blk} {n}", q, w) for blk, qs, ws in (("a", got[1], want[1]),
                                                 ("b", got[2], want[2]))
        for n, q, w in zip(NAMES, qs, ws)]
    assert len(flat) == 19
    for name, q, w in flat:
        q, w = q.double().numpy(), w.detach().numpy()
        assert q.shape == w.shape, name
        scale = np.max(np.abs(w))
        # f32 rounding, each leaf scaled by its largest entry: the slopes
        # are sums of M*K*H cancelling terms (the bar of the Pallas
        # comparison in tests/test_torch_tcn_block_bwd.py), the rest at
        # the autodiff bar
        bar = 5e-5 if name.endswith(("da1", "da2")) else 2e-5
        np.testing.assert_allclose(q / scale, w / scale, atol=bar,
                                   err_msg=name)


def test_pair_ad_matches_jax_pair_ad():
    """Gradients of a scalar loss through the differentiable pair against
    JAX's fused_tcn_block_pair_ad (Pallas forward and backward in
    interpret mode)."""
    x, pa, pb, w = _inputs(seed=40)
    d1 = 2

    def jax_loss(xx, *p18):
        out = jax_pair.fused_tcn_block_pair_ad(
            xx, p18[:9], p18[9:], d1=d1, d2=2 * d1, causal=False,
            norm_type="gLN", tile=128, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jax_loss, argnums=tuple(range(19)))(
        jnp.asarray(x), *_j(pa), *_j(pb))
    prims = [t.requires_grad_(True) for t in _t([x, *pa, *pb])]
    out = port.fused_tcn_block_pair_ad(prims[0], prims[1:10], prims[10:],
                                       d1=d1, d2=2 * d1, causal=False)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.dtype == torch.float32 and out.shape == (M, K, B)
    got = [p.grad for p in prims]
    _assert_cotangents((got[0], got[1:10], got[10:]),
                       (want[0], want[1:10], want[10:]), atol=5e-5)


# ---- the separator's routing -------------------------------------------

SMALL = dict(n_filters=32, kernel_size=8, bottleneck=32, hidden=64,
             num_blocks=3, num_repeats=2)


def _jax_variables(cfg, seed=0):
    """A flax variables tree of cfg's model filled with seeded numpy
    weights (as tests/test_torch_model.py makes them)."""
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


def _kernel_route(model, mix):
    """The port's forward with its kernels in use, on CPU tensors (so the
    wrappers run their twins): ConvTasNet.forward with use_kernel=True."""
    mixture_w = model.encoder(mix)
    est = model.decoder(mixture_w, model.separator(mixture_w, True))
    return torch.nn.functional.pad(est, (0, mix.shape[-1] - est.shape[-1]))


@pytest.fixture
def calls(monkeypatch):
    """Counts the separator's calls of each block entry point."""
    counts = dict.fromkeys(("pair", "pair_ad", "block", "block_ad"), 0)
    for key, name in (("pair", "fused_tcn_block_pair"),
                      ("pair_ad", "fused_tcn_block_pair_ad"),
                      ("block", "fused_tcn_block"),
                      ("block_ad", "fused_tcn_block_ad")):
        real = getattr(pmodel, name)

        def counted(*a, _real=real, _key=key, **k):
            counts[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(pmodel, name, counted)
    return counts


def _models(cfg, seed=0, T=800):
    variables = _jax_variables(cfg, seed)
    model = ConvTasNet(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    model.eval()
    mix = np.random.default_rng(seed + 1).standard_normal((2, T)).astype(
        np.float32)
    return variables, model, mix


@pytest.mark.parametrize("overrides,pairs", [
    (dict(), 2), (dict(norm_type="cLN", causal=True), 2),
    (dict(num_blocks=4, num_repeats=1), 2), (dict(norm_type="BN"), 0)],
    ids=["gLN-X3", "causal-cLN-X3", "gLN-X4", "BN"])
def test_model_forward_matches_jax_pairs(calls, overrides, pairs):
    """Per repeat, blocks (0, 1) pair and an odd last block runs singly;
    BN takes no pair (JAX's pair_variant); the output matches the JAX
    model with use_pallas=True, which runs its pairs and blocks through
    the Pallas kernels in interpret mode."""
    cfg = ConvTasNetConfig(**{**SMALL, **overrides})
    variables, model, mix = _models(cfg)
    with torch.no_grad():
        got = _kernel_route(model, torch.from_numpy(mix))
    n_blocks = cfg.num_blocks * cfg.num_repeats
    assert calls["pair"] == pairs and calls["pair_ad"] == 0
    assert calls["block"] == n_blocks - 2 * pairs
    want = jmodel.ConvTasNet(dataclasses.replace(cfg, use_pallas=True)).apply(
        variables, jnp.asarray(mix), train=False)
    # tests/test_torch_model.py's bar against the JAX Pallas path
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-4)


@pytest.mark.parametrize("norm_type", ["gLN", "BN"])
def test_model_gradients_match_jax_pairs(calls, norm_type):
    """The gradient of a loss through the whole model, every leaf, against
    jax.grad of the JAX model with use_pallas=True in training: gLN trains
    blocks (0, 1) of each repeat through the pair (B4 + B5 twins; JAX's
    pair custom VJP) and block 2 singly; BN takes no pair and trains
    through the plain ops."""
    cfg = ConvTasNetConfig(**SMALL, norm_type=norm_type)
    variables, model, mix = _models(cfg, seed=3, T=400)
    w = np.random.default_rng(4).standard_normal((2, 2, 400)).astype(
        np.float32)
    model.train()
    (_kernel_route(model, torch.from_numpy(mix))
     * torch.from_numpy(w)).sum().backward()
    pairs = 2 if norm_type == "gLN" else 0
    assert calls["pair_ad"] == pairs and calls["pair"] == 0
    assert calls["block_ad"] == (2 if norm_type == "gLN" else 0)
    jcfg = dataclasses.replace(cfg, use_pallas=True)

    def loss(params):
        out, _ = jmodel.ConvTasNet(jcfg).apply(
            {**variables, "params": params}, jnp.asarray(mix), train=True,
            mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(w))

    grads = jax.grad(loss)(variables["params"])
    want = state_dict_from_jax(
        {**variables, "params": jax.device_get(grads)}, cfg)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got and set(got) <= set(want)
    for k, g in got.items():
        # relative L2 per leaf: f32 autodiff against the Pallas backwards,
        # which take their statistics in one pass, through six blocks (the
        # worst leaf reads 1.1e-5 here)
        err = float(torch.linalg.vector_norm(g - want[k])
                    / torch.linalg.vector_norm(want[k]).clamp_min(1e-30))
        assert err <= 2e-4, f"{k}: relative L2 {err:.3g}"


def test_pair_switch_off_runs_singles(calls, monkeypatch):
    """CONVTASNET_PAIR_FUSION=0: every block runs singly, forward and in
    training, with the same output and gradients as the pairs (on CPU
    tensors both compose the same twins)."""
    cfg = ConvTasNetConfig(**{**SMALL, "num_blocks": 4})
    _, model, mix = _models(cfg, seed=5)
    x = torch.from_numpy(mix)
    outs, grads = {}, {}
    for flag in ("1", "0"):
        monkeypatch.setenv("CONVTASNET_PAIR_FUSION", flag)
        for k in calls:
            calls[k] = 0
        with torch.no_grad():
            outs[flag] = _kernel_route(model, x)
        model.zero_grad()
        _kernel_route(model, x).square().mean().backward()
        grads[flag] = [p.grad.clone() for p in model.parameters()]
        if flag == "1":
            assert calls == {"pair": 4, "pair_ad": 4, "block": 0,
                             "block_ad": 0}
        else:
            assert calls == {"pair": 0, "pair_ad": 0, "block": 8,
                             "block_ad": 8}
    torch.testing.assert_close(outs["1"], outs["0"], rtol=0, atol=0)
    for a, b in zip(grads["1"], grads["0"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_pairs_are_off_by_default(calls, monkeypatch):
    """With CONVTASNET_PAIR_FUSION unset every block runs singly: the
    pairs are slower on the card and save only memory (PERF.md), so they
    are the switch's opt-in."""
    monkeypatch.delenv("CONVTASNET_PAIR_FUSION")
    assert not pmodel.pair_fusion_enabled()
    cfg = ConvTasNetConfig(**SMALL)
    _, model, mix = _models(cfg, seed=7)
    with torch.no_grad():
        _kernel_route(model, torch.from_numpy(mix))
    assert calls == {"pair": 0, "pair_ad": 0, "block": 6, "block_ad": 0}


def test_cln_trains_singly(calls):
    """cLN pairs serve but train as single blocks (B1 + B3), as JAX's pair
    train gate takes gLN only."""
    cfg = ConvTasNetConfig(**SMALL, norm_type="cLN", causal=True)
    _, model, mix = _models(cfg, seed=6)
    _kernel_route(model, torch.from_numpy(mix)).square().mean().backward()
    assert calls == {"pair": 0, "pair_ad": 0, "block": 0, "block_ad": 6}


def test_refusals():
    """The twins refuse what JAX's pair refuses: BN pairs, and cLN pair
    training (forward through the autograd path, and the backward)."""
    x, pa, pb, g = _inputs(seed=50)
    args = (torch.from_numpy(x), _t(pa), _t(pb))
    kw = dict(d1=1, d2=2, causal=False)
    with pytest.raises(ValueError, match="gLN and cLN"):
        port.fused_tcn_block_pair(*args, **kw, norm_type="BN")
    with pytest.raises(ValueError, match="gLN and cLN"):
        port.fused_tcn_block_pair_reference(*args, **kw, norm_type="BN")
    with pytest.raises(ValueError, match="gLN only"):
        port.fused_tcn_block_pair_ad(*args, **kw, norm_type="cLN")
    with pytest.raises(ValueError, match="gLN only"):
        port_bwd.fused_tcn_block_pair_bwd(args[0], torch.from_numpy(g),
                                          *args[1:], **kw, norm_type="cLN")


def test_wrappers_use_twins_on_cpu_tensors():
    x, pa, pb, g = _inputs(seed=60)
    args = (torch.from_numpy(x), _t(pa), _t(pb))
    kw = dict(d1=2, d2=4, causal=True)
    before = (port.fused_tcn_block_pair.launches,
              port_bwd.fused_tcn_block_pair_bwd.launches)
    got = port.fused_tcn_block_pair(*args, **kw, norm_type="gLN")
    want = port.fused_tcn_block_pair_reference(*args, **kw, norm_type="gLN")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    gx = port_bwd.fused_tcn_block_pair_bwd(args[0], torch.from_numpy(g),
                                           *args[1:], **kw)
    wx = port_bwd.fused_tcn_block_pair_bwd_reference(
        args[0], torch.from_numpy(g), *args[1:], **kw)
    for a, b in zip(jax.tree_util.tree_leaves(gx),
                    jax.tree_util.tree_leaves(wx)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (port.fused_tcn_block_pair.launches,
            port_bwd.fused_tcn_block_pair_bwd.launches) == before


def test_cuda_branches_have_no_fallback(monkeypatch):
    """With the kernel library unavailable both CUDA branches raise: they
    never drop back to the twins, and count no launch. The forward refuses
    autograd before it loads anything."""

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port, "load_library", broken_loader)
    monkeypatch.setattr(port_bwd, "load_library", broken_loader)
    x, pa, pb, g = _inputs(seed=70)
    args = (torch.from_numpy(x), _t(pa), _t(pb))
    kw = dict(d1=1, d2=2, causal=False)
    before = (port.fused_tcn_block_pair.launches,
              port_bwd.fused_tcn_block_pair_bwd.launches)
    with pytest.raises(RuntimeError, match="unavailable"):
        port._launch_cuda(*args, **kw, norm_type="gLN")
    with pytest.raises(RuntimeError, match="unavailable"):
        port_bwd._launch_cuda(args[0], torch.from_numpy(g), *args[1:], **kw)
    args[1][0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        port._launch_cuda(*args, **kw, norm_type="gLN")
    assert (port.fused_tcn_block_pair.launches,
            port_bwd.fused_tcn_block_pair_bwd.launches) == before
