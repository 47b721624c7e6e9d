"""The DPT sublayers at widths off the kernels' 64-column tile, on the CPU
against the unpadded twins and the JAX package, with inputs from numpy
seeds.

The CUDA kernels B7-B12 and their partial modes B7p-B12p run B and the
head-group width B / m at multiples of 64. Other widths are padded by the
wrappers (``dpt_attention.pad_attention``, ``dpt_ffn.pad_ffn``): zero
columns on x, gamma, beta and the weights' rows and columns that meet
them, whole zero heads inside each of q, k and v; and each LN takes its
statistics over the sublayer's own B (the kernels' ``Bn``, the twins'
``Bn``). The card holds the kernels against the twins
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here, the padded plain
path (pad, the twin at the padded widths with its LN over the real B,
slice back):

- against the unpadded twin, in f32 within 1e-6 (relative L2), the
  forward and every cotangent, and against JAX's ``xla_inter_attention``
  / ``xla_intra_attention`` / ``xla_ffn`` and ``jax.vjp`` of them within
  1e-5, each sublayer full (B = 32, 96, 160; the FFN also at 480) and on
  one shard (B = 192 over 2: 96 channels; 256 over 8: 32; 96 with 6 heads
  over 3: B and B / m both off 64, d = 16, F = 192);
- one planted fault: the LN over the padded width in place of the real
  one breaks the 1e-5 bar against JAX;
- a DPT at ``--B 96`` (3 heads of 32) whole, every sublayer through the
  padded plain path: its forward against the JAX model (the bars of
  ``tests/test_torch_dpt_model.py``) and one Adam step against JAX's
  (those of ``tests/test_torch_dpt_train.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.config import SolverConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu.ops.pallas import dpt_ffn as jax_ffn
from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu.train import train_step as jts
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models import dual_path
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra
from convtasnet_tpu_torch.ops.cuda import shapes
from convtasnet_tpu_torch.train import train_step as pts

TWIN_TOL = 1e-6    # the padded plain path against the unpadded twin
JAX_TOL = 1e-5     # either against JAX's XLA sublayers
M, N_CHUNKS, S = 1, 2, 16
VALID = np.arange(N_CHUNKS * S).reshape(N_CHUNKS, S) < N_CHUNKS * S - 11
FFN_ROWS = 16
TWINS = {"inter": (dpt_attention.inter_attention_reference,
                   dpt_attention.inter_attention_bwd_reference,
                   jax_inter.xla_inter_attention),
         "intra": (dpt_intra.intra_attention_reference,
                   dpt_intra.intra_attention_bwd_reference,
                   jax_intra.xla_intra_attention),
         "ffn": (dpt_ffn.ffn_reference, dpt_ffn.ffn_bwd_reference,
                 jax_ffn.xla_ffn)}
# (B, m, heads, F): full sublayers (m = 1, B / 32 heads, F = 128) and the
# last shard of m of a wider one
FULL = [(32, 1, 1, 128), (96, 1, 3, 128), (160, 1, 5, 128)]
SHARDED = [(192, 2, 6, 384), (256, 8, 8, 512), (96, 3, 6, 192)]
CASES = ([(kind, *c) for kind in ("inter", "intra", "ffn")
          for c in FULL + SHARDED] + [("ffn", 480, 1, 15, 128)])


def _rel(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30))


def _operands(kind, B, m, heads, F_, seed):
    """f32 numpy operands of one sublayer at width B in the wrappers'
    order after x and the cotangent g (zero on the masked rows), cut to
    the last shard of m as ``parallel/dpt_tp.py`` cuts them; -> (arrays,
    wrapper kwargs)."""
    rng = np.random.default_rng(seed)
    if kind == "ffn":
        arrs = [rng.standard_normal((M, FFN_ROWS, B)),
                rng.standard_normal((M, FFN_ROWS, B)),
                1 + 0.1 * rng.standard_normal(B), 0.1 * rng.standard_normal(B),
                rng.standard_normal((B, F_)) / np.sqrt(B),
                0.1 * rng.standard_normal(F_),
                rng.standard_normal((F_, B)) / np.sqrt(F_),
                0.1 * rng.standard_normal(B)]
        if m > 1:
            cut = slice(F_ - F_ // m, F_)
            arrs[4], arrs[5], arrs[6] = (arrs[4][:, cut], arrs[5][cut],
                                         arrs[6][cut])
        return [a.astype(np.float32) for a in arrs], dict(partial=m > 1)
    g = rng.standard_normal((M, N_CHUNKS, S, B)) * VALID[None, :, :, None]
    w_qkv = rng.standard_normal((B, 3 * B)) / np.sqrt(B)
    w_out = rng.standard_normal((B, B)) / np.sqrt(B)
    bq = B // m
    if m > 1:
        w_qkv = np.concatenate([w_qkv[:, i * B + B - bq:(i + 1) * B]
                                for i in range(3)], axis=1)
        w_out = w_out[B - bq:]
    arrs = [rng.standard_normal((M, N_CHUNKS, S, B)), g,
            1 + 0.1 * rng.standard_normal(B), 0.1 * rng.standard_normal(B),
            w_qkv, w_out, np.where(VALID, 0.0, -1e9)]
    return ([a.astype(np.float32) for a in arrs],
            dict(n_heads=heads // m, partial=m > 1))


def padded_forward(kind, x, *w, Bn=True, **kw):
    """The padded plain path of one sublayer's forward: its operands padded
    as the wrappers pad them, the twin at the padded widths with its LN
    over the real B (``Bn=False``: over the padded width, the planted
    fault), the output sliced back to B."""
    fwd = TWINS[kind][0]
    B = x.shape[-1]
    if kind == "ffn":
        gamma, beta, w_up, b_up, w_down, b_down = w
        xp, gp, bp, wu, wd, bd = dpt_ffn.pad_ffn(x, gamma, beta, w_up,
                                                 w_down, b_down)
        out = fwd(xp, gp, bp, wu, b_up, wd, bd, Bn=B if Bn else None, **kw)
        return out[..., :B]
    gamma, beta, w_qkv, w_out, bias = w
    xp, gp, bp, wq, wo, hp = dpt_attention.pad_attention(
        x, gamma, beta, w_qkv, w_out, kw.pop("n_heads"))
    out = fwd(xp, gp, bp, wq, wo, bias, n_heads=hp, Bn=B if Bn else None,
              **kw)
    return out[..., :B]


def padded_backward(kind, x, g, *w, **kw):
    """The padded plain path of one sublayer's backward: the twin's
    backward at the padded widths (the cotangent zero-padded too), every
    cotangent sliced back to the real columns, rows and heads."""
    bwd = TWINS[kind][1]
    B = x.shape[-1]
    gp = F.pad(g, (0, dpt_attention.padded(B) - B))
    if kind == "ffn":
        gamma, beta, w_up, b_up, w_down, b_down = w
        xp, gm, bt, wu, wd, bd = dpt_ffn.pad_ffn(x, gamma, beta, w_up,
                                                 w_down, b_down)
        return dpt_ffn.unpad_ffn_grads(
            bwd(xp, gp, gm, bt, wu, b_up, wd, bd, Bn=B, **kw), B)
    gamma, beta, w_qkv, w_out, bias = w
    heads = kw.pop("n_heads")
    xp, gm, bt, wq, wo, hp = dpt_attention.pad_attention(
        x, gamma, beta, w_qkv, w_out, heads)
    return dpt_attention.unpad_attention_grads(
        bwd(xp, gp, gm, bt, wq, wo, bias, n_heads=hp, Bn=B, **kw), B,
        w_qkv.shape[-1] // 3, heads)


def _check(kind, got, want, bar):
    """Every output by relative L2 within bar; an attention output or dx
    on the valid rows; a zero (db_down of a partial backward) exactly."""
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want)
    for i, (q, w) in enumerate(zip(got, want)):
        q = q.detach().numpy()
        w = np.asarray(w, np.float32)
        assert q.shape == w.shape, (i, q.shape, w.shape)
        if i == 0 and kind != "ffn":
            q, w = q[:, VALID], w[:, VALID]
        assert np.isfinite(q).all(), i
        if not w.any():
            assert not q.any(), i
            continue
        assert _rel(q, w) <= bar, (i, _rel(q, w))


def _jax_forward_and_vjp(kind, j, kw):
    """JAX's XLA sublayer and ``jax.vjp`` of it on the primals (x and the
    weights; the key bias held fixed), as ``tests/test_torch_dpt_wide.py``
    takes them."""
    jx, jg, *jw = j
    xla = TWINS[kind][2]
    if kind == "ffn":
        fn = functools.partial(xla, partial=kw["partial"])
        primals = jw
    else:
        fn = functools.partial(
            lambda bias, *a: xla(*a, bias, **kw), jw[4])
        primals = jw[:4]

    @jax.jit   # one compile of the whole function and its VJP
    def forward_and_vjp(x, g, *p):
        out, vjp = jax.vjp(fn, x, *p)
        return out, vjp(g)

    out, grads = forward_and_vjp(jx, jg, *primals)
    if kind == "ffn" and kw["partial"]:   # b_down is unused: its cotangent is 0
        grads = (*grads[:-1], jnp.zeros_like(jw[-1]))
    return out, grads


@pytest.mark.parametrize("kind,B,m,heads,F_", CASES)
def test_padded_sublayer_matches_twin_and_jax(kind, B, m, heads, F_):
    """The padded plain path at widths off 64 (full B = 32, 96, 160, the
    FFN also 480; shards of 96, 32 and 32 channels) against the unpadded
    twin within 1e-6 and JAX's XLA sublayer within 1e-5: the forward and
    every cotangent. The padded columns of the output are zero."""
    arrs, kw = _operands(kind, B, m, heads, F_, seed=B + m)
    x, g, *w = (torch.from_numpy(a) for a in arrs)
    fwd, bwd, _ = TWINS[kind]
    want = fwd(x, *w, **kw)
    got = padded_forward(kind, x, *w, **kw)
    _check(kind, got, want, TWIN_TOL)
    got_bwd = padded_backward(kind, x, g, *w, **kw)
    _check(kind, got_bwd, bwd(x, g, *w, **kw), TWIN_TOL)
    jwant, jwant_bwd = _jax_forward_and_vjp(
        kind, [jnp.asarray(a) for a in arrs], kw)
    _check(kind, got, jwant, JAX_TOL)
    _check(kind, got_bwd, jwant_bwd, JAX_TOL)
    # the padded columns carry nothing: y and every product are zero there
    if kind == "ffn":
        xp, *wp = dpt_ffn.pad_ffn(x, w[0], w[1], w[2], w[4], w[5])
        full = fwd(xp, wp[0], wp[1], wp[2], w[3], wp[3], wp[4], Bn=B, **kw)
    else:
        xp, gp, bp, wq, wo, hp = dpt_attention.pad_attention(
            x, w[0], w[1], w[2], w[3], kw["n_heads"])
        full = fwd(xp, gp, bp, wq, wo, w[4], **dict(kw, n_heads=hp), Bn=B)
    assert not full[..., B:].any()


@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_ln_over_the_padded_width_breaks_the_bar(kind):
    """A planted fault: with the LN's statistics taken over the padded
    width (the zero columns shift the mean and the variance) in place of
    the sublayer's own B = 96, the padded path leaves the 1e-5 bar
    against JAX by far, while the right one keeps it."""
    arrs, kw = _operands(kind, 96, 1, 3, 128, seed=5)
    x, _, *w = (torch.from_numpy(a) for a in arrs)
    jwant, _ = _jax_forward_and_vjp(kind, [jnp.asarray(a) for a in arrs], kw)
    valid = VALID if kind != "ffn" else slice(None)

    def err(out):
        return _rel(out.numpy()[:, valid], np.asarray(jwant)[:, valid])

    assert err(padded_forward(kind, x, *w, **kw)) <= JAX_TOL
    assert err(padded_forward(kind, x, *w, Bn=False, **kw)) > 100 * JAX_TOL


def test_padding_layout():
    """``pad_attention`` appends whole zero heads of the real width inside
    each of q, k and v (B = 96, 6 heads of 16 over 3 shards: a 32-channel
    shard of 2 heads becomes 64 channels of 4), zero rows and columns
    elsewhere, and ``unpad_attention_grads`` takes back exactly the real
    block; widths on the tile pass through untouched."""
    B, Bq, h = 96, 32, 2
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 3, B, generator=gen)
    gamma, beta = torch.randn(B, generator=gen), torch.randn(B, generator=gen)
    w_qkv = torch.randn(B, 3 * Bq, generator=gen)
    w_out = torch.randn(Bq, B, generator=gen)
    xp, gp, bp, wq, wo, hp = dpt_attention.pad_attention(x, gamma, beta,
                                                         w_qkv, w_out, h)
    assert xp.shape[-1] == 128 and wq.shape == (128, 192)
    assert wo.shape == (64, 128) and hp == 4
    for i in range(3):
        assert torch.equal(wq[:B, 64 * i:64 * i + Bq],
                           w_qkv[:, Bq * i:Bq * (i + 1)])
        assert not wq[:, 64 * i + Bq:64 * (i + 1)].any()
    assert not wq[B:].any() and not wo[Bq:].any() and not wo[:, B:].any()
    assert not (xp[..., B:].any() or gp[B:].any() or bp[B:].any())
    grads = (xp, gp, bp, wq, wo)
    back = dpt_attention.unpad_attention_grads(grads, B, Bq, h)
    for got, want in zip(back, (x, gamma, beta, w_qkv, w_out)):
        assert torch.equal(got, want)
    same = dpt_attention.pad_attention(xp, gp, bp, wq, wo, hp)
    assert all(a is b for a, b in zip(same, (xp, gp, bp, wq, wo, hp)))
    assert dpt_attention.unpad_attention_grads(grads, 128, 64, h) is grads


# ---- a DPT at --B 96 whole, every sublayer on the padded plain path ----

def _padded_sublayers(monkeypatch):
    """Routes every sublayer of the plain path (``dual_path``'s table)
    through ``padded_forward``, differentiable by autograd; returns the
    calls made per kind."""
    calls = dict.fromkeys(TWINS, 0)
    table = dict(dual_path._SUBLAYER_FNS)

    def route(kind):
        def run(*args, **kw):
            calls[kind] += 1
            return padded_forward(kind, *args, **kw)
        return run

    for kind, (_, fused, fused_ad) in table.items():
        table[kind] = (route(kind), fused, fused_ad)
    monkeypatch.setattr(dual_path, "_SUBLAYER_FNS", table)
    return calls


def _jax_variables(cfg, seed=0):
    """The JAX model's variables tree filled with seeded numpy weights,
    every LN affine and bias moved off its init."""
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


# two layers, 16-frame chunks, 3 heads of 32, F = 128, C = 2
B96 = ConvTasNetConfig(n_filters=32, kernel_size=8, bottleneck=96,
                       separator="dpt", dpt_chunk=16, dpt_layers=2,
                       dpt_ff=128)


def test_dpt_b96_forward_matches_jax(monkeypatch):
    """The DPT at ``--B 96`` (3 heads of 32), which the kernels now take
    (no refusal), every sublayer through the padded plain path: its
    forward against the JAX model on the same weights, K = 199 frames
    (a padded tail and its key mask on the path), within the bars of
    ``tests/test_torch_dpt_model.py`` (rtol 1e-3, atol 5e-4)."""
    assert B96.dpt_num_heads == 3 and shapes.refusals(B96) == {}
    calls = _padded_sublayers(monkeypatch)
    variables = _jax_variables(B96)
    model = ConvTasNet(B96).eval()
    model.load_state_dict(state_dict_from_jax(variables, B96))
    mix = np.random.default_rng(1).standard_normal((2, 800)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mix)).numpy()
    assert calls == {"inter": 2, "intra": 2, "ffn": 4}
    apply = jax.jit(functools.partial(
        jmodel.ConvTasNet(JaxConfig(**B96.to_dict())).apply, train=False))
    want = np.asarray(apply(variables, jnp.asarray(mix)))
    assert got.shape == want.shape == (2, 2, 800)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4)


def test_dpt_b96_adam_step_matches_jax(monkeypatch):
    """One Adam step of the DPT at ``--B 96`` (one layer) through the
    padded plain path against JAX's, from the same weights on the same seeded batch,
    clipping engaged, at the bars of ``tests/test_torch_dpt_train.py``:
    every gradient leaf against ``jax.grad`` within 1e-5 relative L2, the
    loss and gradient norm within 1e-5 relative, the parameters after the
    step within 2e-5."""
    cfg = dataclasses.replace(B96, n_filters=16, dpt_layers=1,
                              use_pallas=False)
    jcfg = JaxConfig(**cfg.to_dict())
    solver = SolverConfig(lr=1e-4, max_grad_norm=5.0, save_folder="")
    calls = _padded_sublayers(monkeypatch)
    js, tx = jts.create_train_state(jcfg, solver, jax.random.PRNGKey(0), 1600)

    def params(state):
        return state_dict_from_jax(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}), cfg)

    ps = pts.create_train_state(cfg, solver, state_dict=params(js),
                                use_pallas=False)
    rng = np.random.default_rng(60)
    b = (rng.standard_normal((3, 1600)).astype(np.float32),
         np.full((3,), 1600, np.int32),
         rng.standard_normal((3, 2, 1600)).astype(np.float32),
         np.asarray([1, 1, 0], np.float32))
    jb = tuple(jnp.asarray(a) for a in b)
    tb = tuple(torch.from_numpy(np.array(a)) for a in b)
    model = jmodel.ConvTasNet(jcfg)

    @jax.jit   # JAX's step (make_train_step's step_fn), its gradients out
    def jstep(state, batch):
        loss, _, grads = jts._loss_and_grads(model, state.params,
                                             state.batch_stats, batch, 0)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        return (loss, grads, optax.global_norm(grads),
                optax.apply_updates(state.params, updates))

    jloss, jgrads, jnorm, jparams = jstep(js, jb)
    want = state_dict_from_jax(jax.device_get(
        {"params": jgrads, "batch_stats": js.batch_stats}), cfg)
    pts._loss_and_grads(ps.model, tb, 0)
    assert calls["inter"] > 0 and calls["ffn"] > 0
    for k, p in ps.model.named_parameters():
        w = want[k].double()
        err = float(torch.linalg.vector_norm(p.grad.double() - w)
                    / torch.linalg.vector_norm(w).clamp_min(1e-30))
        assert err <= 1e-5, f"{k}: relative L2 {err:.3g}"
    ps, pm = pts.make_train_step()(ps, tb)
    np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jnorm),
                               rtol=1e-5)
    assert float(jnorm) > solver.max_grad_norm
    after = state_dict_from_jax(jax.device_get(
        {"params": jparams, "batch_stats": js.batch_stats}), cfg)
    now = ps.model.state_dict()
    assert set(now) == set(after)
    for k, w in after.items():
        np.testing.assert_allclose(now[k].numpy(), w.numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)
