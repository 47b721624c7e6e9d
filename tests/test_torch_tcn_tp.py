"""The port's TP stage pieces (``ops/cuda/tcn_block_tp.py``) against the
JAX package's (``convtasnet_tpu/ops/pallas/tcn_block_tp.py``).

``tp_stage1``, ``stats_from_sums`` and ``tp_epilogue``, and the stage-2
twin ``tp_stage2_reference``, are held against the JAX functions on the
same numpy inputs: stage 2 against ``xla_tp_stage2`` and against the
Pallas kernel ``fused_tp_stage2`` in interpret mode, in f32 within 1e-5
relative L2 (only the summation order differs) and in bf16 within 4e-2
(the Pallas kernel rounds neither the normalised input nor the conv
output; the twin rounds both, as ``xla_tp_stage2``). The autograd
Function ``tp_stage2_ad`` is held against ``jax.grad`` of JAX's
``tp_stage2_ad`` (fused interpret forward, XLA remat backward) at JAX's
own bars (rtol 2e-4, atol 2e-5). JAX runs under ``jax.jit``, once per
case (module-scoped fixtures). The twin at the Pallas kernel's own
rounding points (``rounding="pallas"``) is held against that kernel at
1e-3 in bf16. The kernel B6 is held against both twins on the card
(``tests/test_torch_cuda.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import tcn_block_tp as jtp
from convtasnet_tpu_torch.ops.cuda import tcn_block as port_block
from convtasnet_tpu_torch.ops.cuda import tcn_block_tp as port

M, Hs, B, P = 2, 8, 6, 3
# (dilation, causal, K): the cases of tests/test_tcn_tp.py's stage-2 test
CASES = [(1, False, 37), (2, False, 48), (4, True, 37)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-2)}
STAGE2_ARGS = ("h", "stats1", "dw", "w_out", "a2", "g1", "b1", "g2")
# the twin at the Pallas kernel's rounding points against that kernel
PALLAS_ORDER_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _stage2_inputs(K: int, seed: int = 1) -> dict:
    """Seeded stage-2 operands, as tests/test_tcn_tp.py makes them."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        h=rng.standard_normal((M, K, Hs)),
        stats1=np.stack([rng.standard_normal(M) * 0.1,
                         1.0 + 0.2 * rng.random(M)], -1),
        dw=rng.standard_normal((P, Hs)) / np.sqrt(P),
        w_out=rng.standard_normal((Hs, B)) / np.sqrt(Hs),
        a2=np.array(0.25),
        g1=rng.standard_normal(Hs) * 0.1 + 1.0,
        b1=rng.standard_normal(Hs) * 0.1,
        g2=rng.standard_normal(Hs) * 0.1 + 1.0,
    )
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _to_jax(arrs, jdt):
    return [jnp.asarray(arrs[n], jdt if n == "h" else jnp.float32)
            for n in STAGE2_ARGS]


def _to_port(arrs, tdt):
    return [torch.from_numpy(arrs[n]).to(tdt if n == "h" else torch.float32)
            for n in STAGE2_ARGS]


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"d{d}-causal{int(c)}-K{k}" for d, c, k in CASES])
def stage2_case(request):
    """One case's inputs and JAX's results, each computed once under
    jax.jit: xla_tp_stage2 and the interpret-mode Pallas stage 2 in both
    dtypes, and the cotangents of sum(z^2) + sum(sums) through JAX's
    tp_stage2_ad in f32."""
    d, causal, K = request.param
    arrs = _stage2_inputs(K)
    out = {"case": request.param, "arrs": arrs}
    for name, (jdt, _, _) in DTYPES.items():
        args = _to_jax(arrs, jdt)
        xla = jax.jit(functools.partial(jtp.xla_tp_stage2, dilation=d,
                                        causal=causal))
        fused = jax.jit(functools.partial(
            jtp.fused_tp_stage2, dilation=d, causal=causal, tile=16,
            interpret=True))
        out[name] = {"xla": jax.device_get(xla(*args)),
                     "pallas": jax.device_get(fused(*args))}

    def loss(*a):
        z, s = jtp.tp_stage2_ad((d, causal, "t16", True), *a)
        return jnp.sum(z * z) + jnp.sum(s)

    out["grads"] = jax.device_get(jax.jit(jax.grad(
        loss, argnums=tuple(range(8))))(*_to_jax(arrs, jnp.float32)))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_stage2_twin_matches_jax(stage2_case, dtype, ref):
    """The twin's z and gLN-2 sums against xla_tp_stage2 and the Pallas
    kernel in interpret mode, on the same inputs."""
    d, causal, _ = stage2_case["case"]
    _, tdt, bar = DTYPES[dtype]
    z, sums = port.tp_stage2_reference(
        *_to_port(stage2_case["arrs"], tdt), dilation=d, causal=causal)
    z_want, s_want = stage2_case[dtype][ref]
    assert z.dtype == tdt and sums.dtype == torch.float32
    assert tuple(z.shape) == tuple(z_want.shape)
    assert _rel(_f32(z), _f32(z_want)) <= bar
    assert _rel(_f32(sums), _f32(s_want)) <= bar


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pallas_rounding_twin_matches_the_pallas_kernel(stage2_case, dtype):
    """The twin at the Pallas kernel's rounding points (``rounding=
    "pallas"``: only y g2 and z rounded) against the Pallas kernel in
    interpret mode: in bf16 only summation order and the roundings it
    flips differ (<= 3.5e-4 at these tiny widths), so 1e-3, where a kernel
    that rounds otherwise (g2 folded into W_out: 3.6e-3 at the paper
    widths) is seen; f32 within 1e-5."""
    d, causal, _ = stage2_case["case"]
    _, tdt, _ = DTYPES[dtype]
    z, sums = port.tp_stage2_reference(
        *_to_port(stage2_case["arrs"], tdt), dilation=d, causal=causal,
        rounding="pallas")
    z_want, s_want = stage2_case[dtype]["pallas"]
    bar = PALLAS_ORDER_TOL[dtype]
    assert _rel(_f32(z), _f32(z_want)) <= bar
    assert _rel(_f32(sums), _f32(s_want)) <= bar


def test_fused_stage2_on_cpu_is_the_twin(stage2_case):
    """On CPU tensors the wrapper runs the twin (no launch counted), and
    its autograd Function's outputs equal the wrapper's."""
    d, causal, _ = stage2_case["case"]
    args = _to_port(stage2_case["arrs"], torch.float32)
    kw = dict(dilation=d, causal=causal)
    before = port.fused_tp_stage2.launches
    got = port.fused_tp_stage2(*args, **kw)
    want = port.tp_stage2_reference(*args, **kw)
    ad = port.tp_stage2_ad(*args, **kw)
    for g, w, a in zip(got, want, ad):
        assert torch.equal(g, w) and torch.equal(a, w)
    assert port.fused_tp_stage2.launches == before


def test_stage2_ad_grads_match_jax(stage2_case):
    """All eight cotangents of tp_stage2_ad (the twin differentiated at
    the saved inputs) against jax.grad of JAX's tp_stage2_ad."""
    d, causal, _ = stage2_case["case"]
    prims = [t.requires_grad_(True)
             for t in _to_port(stage2_case["arrs"], torch.float32)]
    z, s = port.tp_stage2_ad(*prims, dilation=d, causal=causal)
    ((z * z).sum() + s.sum()).backward()
    for name, p, want in zip(STAGE2_ARGS, prims, stage2_case["grads"]):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.fixture(scope="module")
def stage1_case():
    """Stage 1, the statistics and the epilogue of one shard in JAX, under
    jax.jit once, in both dtypes."""
    rng = np.random.default_rng(5)
    K, Bw = 41, 12
    arrs = dict(x=rng.standard_normal((M, K, Bw)),
                w_in=rng.standard_normal((Bw, Hs)) / np.sqrt(Bw),
                a1=np.array(0.25),
                z=rng.standard_normal((M, K, Bw)),
                sums2=np.stack([rng.standard_normal(M) * 40,
                                400 + 50 * rng.random(M)], -1),
                w1=rng.standard_normal(Bw), w0=rng.standard_normal(Bw))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    n = K * 4 * Hs   # the element count of the whole width, 4 shards

    def jax_side(x, w_in, a1, z, sums2, w1, w0):
        h, sums1 = jtp.tp_stage1(x, w_in, a1)
        stats1 = jtp.stats_from_sums(sums1, n)
        out = jtp.tp_epilogue(x, z, jtp.stats_from_sums(sums2, n), w1, w0)
        return h, sums1, stats1, out

    out = {"arrs": arrs, "n": n}
    for name, (jdt, _, _) in DTYPES.items():
        args = [jnp.asarray(arrs[k], jdt if k in ("x", "z") else jnp.float32)
                for k in ("x", "w_in", "a1", "z", "sums2", "w1", "w0")]
        out[name] = jax.device_get(jax.jit(jax_side)(*args))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stage1_stats_epilogue_match_jax(stage1_case, dtype):
    _, tdt, bar = DTYPES[dtype]
    a = {k: torch.from_numpy(v) for k, v in stage1_case["arrs"].items()}
    x, z = a["x"].to(tdt), a["z"].to(tdt)
    n = stage1_case["n"]
    h, sums1 = port.tp_stage1(x, a["w_in"], a["a1"])
    stats1 = port.stats_from_sums(sums1, n)
    out = port.tp_epilogue(x, z, port.stats_from_sums(a["sums2"], n),
                           a["w1"], a["w0"])
    want = stage1_case[dtype]
    assert h.dtype == tdt and out.dtype == tdt
    assert sums1.dtype == torch.float32 and stats1.dtype == torch.float32
    for got, ref in zip((h, sums1, stats1, out), want):
        assert tuple(got.shape) == tuple(ref.shape)
        assert _rel(_f32(got), _f32(ref)) <= bar


@pytest.mark.parametrize("dilation,causal", [(1, False), (4, True)])
def test_decomposition_is_the_block_on_one_shard(dilation, causal):
    """stage 1 -> statistics -> stage 2 -> epilogue over one shard (the
    whole width) equals the unsplit gLN block's twin
    (``fused_tcn_block_reference``) in f32, as JAX's own test holds its
    decomposition against ``_xla_block``."""
    rng = np.random.default_rng(0)
    K, Bw, H = 50, 12, 32
    x, w_in, dw, w_out = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((M, K, Bw), (Bw, H), (P, H), (H, Bw)))
    a1, a2 = torch.tensor(0.25), torch.tensor(0.1)
    g1, b1, g2, b2 = (torch.from_numpy(
        (rng.standard_normal(H) * 0.1 + off).astype(np.float32))
        for off in (1.0, 0.0, 1.0, 0.0))
    h, sums1 = port.tp_stage1(x, w_in, a1)
    z, sums2 = port.tp_stage2_reference(
        h, port.stats_from_sums(sums1, K * H), dw, w_out, a2, g1, b1, g2,
        dilation=dilation, causal=causal)
    got = port.tp_epilogue(x, z, port.stats_from_sums(sums2, K * H),
                           g2 @ w_out, b2 @ w_out)
    want = port_block.fused_tcn_block_reference(
        x, w_in, dw, w_out, a1, a2, g1, b1, g2, b2, dilation=dilation,
        causal=causal, norm_type="gLN")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_stage2_refuses_other_norms():
    args = _to_port(_stage2_inputs(16), torch.float32)
    for norm in ("cLN", "BN"):
        with pytest.raises(ValueError, match="gLN only"):
            port.fused_tp_stage2(*args, dilation=1, causal=False,
                                 norm_type=norm)


def test_cuda_branch_has_no_fallback(monkeypatch):
    """With the kernel library unavailable the CUDA branch raises: it never
    drops back to the twin, and counts no launch; under autograd it
    refuses before reaching the library."""

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port, "load_library", broken_loader)
    args = _to_port(_stage2_inputs(16), torch.float32)
    before = port.fused_tp_stage2.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        port._launch_cuda(*args, dilation=1, causal=False)
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="tp_stage2_ad"):
        port._launch_cuda(*args, dilation=1, causal=False)
    assert port.fused_tp_stage2.launches == before
