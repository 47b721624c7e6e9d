"""The CUDA kernels' shape rules, the padding that widens them, and the
configuration-level check built on them.

Each kernel's rule is one pure function beside its wrapper
(``shape_refusal``); ``ops/cuda/shapes.py`` applies the rules to a whole
configuration, and a model with its kernels in use raises on a refused
one before anything launches. Widths off a kernel's tile are not refused:
the wrappers zero-pad them (B and H of the TCN blocks, Hs and B of TP
stage 2, the DPT's B, its head groups' B / m with zero heads, and the
FFN's F) or pad the chunk with masked frames (the intra kernels' S); the
DPT's own padding is held in ``tests/test_torch_dpt_padded.py``. These tests hold each rule against the limits written out
here, the configuration-level check against the rules, the padding of
each family against the unpadded plain math on the CPU (the kernels run
the same math at the padded widths), and, at two configurations the
kernels take only padded (a TCN with H = 96, a DPT with 100-frame chunks),
the port's forward through its kernels' CPU twins against the JAX model's
on the same weights, in f32. Nothing here needs a card: the CUDA device
below is only a ``torch.device`` whose type the check reads.
"""

import dataclasses
import functools
import re
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.ops.cuda import (
    dpt_attention,
    dpt_ffn,
    dpt_intra,
    shapes,
    tcn_block,
    tcn_block_pair,
    tcn_block_tp,
)

CUDA = torch.device("cuda")   # read for its type only


def _tcn_ok(B, H, P, causal):
    return causal or P % 2


@pytest.mark.parametrize("B,H", [(64, 64), (256, 512), (96, 128), (128, 96),
                                 (576, 512), (640, 192), (500, 100)])
@pytest.mark.parametrize("P,causal", [(3, False), (4, False), (4, True),
                                      (17, True)])
def test_tcn_block_and_pair_rules(B, H, P, causal):
    """B1-B3 take any B and H (padded to multiples of 64) and any P, odd
    unless causal (the JAX package's rule); the pair (B4, B5), which runs
    each block through the single block's launchers, has the same rule at
    any B."""
    got = tcn_block.shape_refusal(B, H, P, causal)
    assert (got is None) == bool(_tcn_ok(B, H, P, causal)), got
    pair = tcn_block_pair.shape_refusal(B, H, P, causal)
    assert pair == got


@pytest.mark.parametrize("Hs", [64, 96, 192, 500, 512, 576, 1024, 1088])
@pytest.mark.parametrize("B", [64, 96, 256])
def test_tp_stage2_rule(Hs, B):
    """B6 takes every Hs = H / m and B (padded to multiples of 64; a padded
    Hs above 512 on its wide route) at any P ``taps_refusal`` takes."""
    for P, causal in ((3, False), (17, True), (4, True)):
        assert tcn_block_tp.shape_refusal(Hs, B, P, causal) is None
    assert (tcn_block_tp.shape_refusal(Hs, B, 4, False)
            == tcn_block.taps_refusal(4, False))


def _attention_ok(kind, B, S, Bq, heads):
    return B % Bq == 0 and Bq % heads == 0


@pytest.mark.parametrize("kind", ["inter", "intra"])
@pytest.mark.parametrize("B,Bq,heads", [
    (256, 256, 8), (256, 128, 4), (256, 32, 1), (256, 256, 16),
    (320, 320, 10), (96, 96, 3), (64, 64, 2), (512, 512, 16),
    (512, 256, 8), (448, 64, 2), (576, 576, 18), (640, 640, 20),
    (1024, 1024, 32), (1024, 512, 16), (2048, 2048, 64), (576, 96, 2)])
@pytest.mark.parametrize("S", [100, 128, 272])
def test_attention_rules(kind, B, Bq, heads, S):
    """B7-B10 (and partial modes) take any B, any head width (16, 32, 64
    and 128 on the cores, others widened with zero columns, above 128 on
    the route beside the cores) and a head group's width Bq dividing B, at
    any chunk length S (the intra kernels pad it to a multiple of 16); B =
    320 to 512 on their wide routes, B = 576, 640, 1024 and 2048 (and a
    shard of 512 of 1024) on the routes beside the resident tiles, B = 96
    and a shard of 32 channels zero-padded to the 64-column tile; a head
    width of 48 (96 channels in 2 heads) widened to 64."""
    got = dpt_attention.shape_refusal(kind, B, S, Bq, heads)
    assert (got is None) == _attention_ok(kind, B, S, Bq, heads), got
    if kind == "intra":
        assert dpt_intra.shape_refusal(B, S, Bq, heads) == got


CSRC = Path(dpt_attention.__file__).resolve().parents[2] / "csrc"


def _csrc_int(name, file):
    """The value of ``constexpr int name = ...;`` (or ``size_t``, a product
    of integers) in csrc/file."""
    found = re.search(rf"constexpr (?:int|size_t) {name} = ([\d *]+);",
                      (CSRC / file).read_text())
    assert found, (name, file)
    return functools.reduce(lambda a, b: a * b,
                            (int(v) for v in found.group(1).split("*")))


def _f32_inter_launchers_take(B, Bq, h):
    """What the f32 inter launchers (B7's ``launch`` in csrc/dpt_attention.cu,
    B8's ``launch_bwd`` in csrc/dpt_attention_bwd.cu, with their partial
    modes) check and ask for, written out, at the widths the wrappers hand
    them (B, Bq and h as ``dpt_attention.pad_attention`` pads them): Bq a
    multiple of 64 and at most B, a padded head width in core_head_width
    or, above 128, a multiple of 64 (the route beside the cores, whose
    products keep static shared memory alone), a core
    block of core_warps(h) warps (at most 8, each taking h / warps heads
    in turn) and the dynamic shared memory of ln_qkv_kernel
    (ln_qkv_smem<float>, up to B = kWideMax; above it launch 1 keeps no
    tile) and of the inter cores (inter_core_smem, core_bwd_smem: kInterKeys
    key chunks staged up to Bq = kWideMax, above it inter_wide_keys', the
    most from 16 down by halves within kInterWideStage) within an H100
    block's 232,448 bytes. No bound on B itself: the LN backward's rows
    past kLnBwdWidth and LQ's past kWideMax take routes of their own."""
    def align128(n):
        return (n + 127) // 128 * 128

    wide = _csrc_int("kWideMax", "dpt_bwd_common.cuh")
    d = Bq // h
    warps = min(h, 8)
    while h % warps:
        warps -= 1
    ln_qkv = (align128(64 * (B + 4) * 4) + align128(64 * 68 * 4)
              + 64 * (256 + 4) * 4) if B <= wide else 0
    keys = _csrc_int("kInterKeys", "dpt_common.cuh")
    if Bq > wide:
        keys = 16
        while keys > 1 and keys * 2 * Bq * 4 > _csrc_int(
                "kInterWideStage", "dpt_common.cuh"):
            keys //= 2
    core = align128(keys * 2 * Bq * 4) + keys * 4 if d <= 128 else 0
    return (Bq % 64 == 0 and Bq <= B and Bq % h == 0
            and (d in (16, 32, 64, 128) or d % 64 == 0)
            and warps <= 8 and h % warps == 0
            and max(ln_qkv, core) <= 232448)


def test_every_taken_f32_inter_shape_launches():
    """Every shape the attention rule takes in f32 at B up to 2048 with 10
    to 16 heads (a head-group shard of m of them too), padded as the
    wrappers pad it, is one the f32 inter launchers take: no launcher keeps
    a refusal the rule does not state (the one-warp-a-head limit above 8
    heads is gone from both, and so is every bound on B and on the head
    width), and the shapes the rule refuses are those whose heads do not
    split the channels evenly."""
    for name in ("dpt_attention.cu", "dpt_attention_bwd.cu"):
        assert not re.search(r"\bh > 8 &&", (CSRC / name).read_text()), name
    taken = 0
    for B in range(64, 2049, 32):
        for heads in range(10, 17):
            for m in range(1, heads + 1):
                if heads % m or B % m:
                    continue
                Bq, h = B // m, heads // m
                got = dpt_attention.shape_refusal("inter", B, 128, Bq, h,
                                                  "float32")
                if got is None:
                    taken += 1
                    x = torch.zeros(1, 1, 1, B)
                    w_qkv, w_out = torch.zeros(B, 3 * Bq), torch.zeros(Bq, B)
                    xp, _, _, wq, _, hp = dpt_attention.pad_attention(
                        x, x[0, 0, 0], x[0, 0, 0], w_qkv, w_out, h)
                    assert _f32_inter_launchers_take(
                        xp.shape[-1], wq.shape[1] // 3, hp), (B, Bq, h)
                else:
                    assert Bq % h and "split" in got, (B, Bq, h, got)
    assert taken >= 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [320, 384, 448, 512])
def test_wide_widths_take_every_head_width_and_shard(B, dtype):
    """At B = 320 to 512 the attention kernels (inter and intra) take every
    head width of their dtype, on the full sublayer and on every head-group
    shard (a width B / m off 64 zero-padded), and the FFN kernels take
    B; B + 64 past 512 (on the routes beside the resident tiles) and
    B - 32, off the tile, are taken too."""
    taken = 0
    for d in dpt_attention.HEAD_DIMS:
        heads = B // d
        if B % d:
            continue
        for m in range(1, heads + 1):
            if heads % m:
                continue
            for kind in ("inter", "intra"):
                assert dpt_attention.shape_refusal(
                    kind, B, 128, B // m, heads // m, dtype) is None
            assert dpt_intra.shape_refusal(B, 128, B // m, heads // m,
                                           dtype) is None
            taken += 1
    assert taken >= 4
    assert dpt_ffn.shape_refusal(B) is None
    assert dpt_ffn.shape_refusal(B - 32) is None
    assert dpt_attention.shape_refusal(
        "inter", B - 32, 128, B - 32, (B - 32) // 32, dtype) is None
    if B == 512:
        assert dpt_ffn.shape_refusal(B + 64) is None


@pytest.mark.parametrize("kind", ["inter", "intra"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("B,heads,m", [
    (256, 16, 1), (256, 2, 1), (128, 1, 1), (128, 8, 1), (256, 16, 2),
    (256, 2, 2), (256, 4, 4), (256, 32, 1), (256, 1, 1), (96, 2, 1),
    (64, 8, 1)])
def test_attention_head_widths_by_dtype(kind, dtype, B, heads, m):
    """The bf16 kernels (one tensor-core core, templated on the head width)
    and the f32 first designs (templated on it too) run d = 16, 32, 64 and
    128 on their cores: B = 256 with 16 heads (d = 16) or 2 (d = 128), B =
    128 with 1 head or 8, their head-group shards of m = 2 and 4; and they
    take every other width JAX runs: d = 8 (also B = 64 with 8 heads) and
    48 (B = 96 with 2 heads) widened with zero columns to the next core
    width, d = 256 on the route beside the cores, at a multiple of 64."""
    d = B // heads
    got = dpt_attention.shape_refusal(kind, B, 128, B // m, heads // m,
                                      dtype)
    dims = (16, 32, 64, 128)
    assert dpt_attention.HEAD_DIMS == dims
    assert got is None, got
    D = dpt_attention.core_head_width(d)
    if d in dims:
        assert D == d
    elif d < 128:
        assert D == min(w for w in dims if w > d)
    else:
        assert D % 64 == 0 and D - 64 < d <= D
    if kind == "intra":
        assert dpt_intra.shape_refusal(B, 128, B // m, heads // m,
                                       dtype) == got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("S", [100, 256, 320, 1024])
def test_intra_chunk_limit_is_f32_only(dtype, S):
    """No dtype limits the intra chunk length any more: the f32 B9 and B10
    run S above 256 on their row-statistics core (no [16, S] or [S, S]
    tile), and the bf16 ones keep no per-chunk tile either. The compute
    dtype comes as a name (a configuration's) or a torch dtype (a
    wrapper's)."""
    assert not hasattr(dpt_attention, "INTRA_MAX_S")
    assert dpt_intra.shape_refusal(256, S, 256, 8, dtype) is None
    assert dpt_attention.shape_refusal("inter", 256, S, 256, 8, dtype) is None


@pytest.mark.parametrize("heads", [2, 16])
def test_f32_dpt_head_widths_refuse_only_long_chunks(heads):
    """An f32 DPT at B = 256 with 2 heads (d = 128) or 16 (d = 16) passes
    every kernel's rule at the quality default's 128-frame chunks, and at
    272 frames too: the f32 intra kernels take chunks above 256 frames on
    their row-statistics core, so no kind is refused."""
    cfg = ConvTasNetConfig(separator="dpt", dpt_heads=heads)
    assert cfg.compute_dtype == "float32"
    assert shapes.refusals(cfg) == {}
    long = dataclasses.replace(cfg, dpt_chunk=272)
    assert shapes.refusals(long) == {}


@pytest.mark.parametrize("B", [64, 256, 320, 96, 448, 512, 576, 640, 1024,
                               2048])
def test_ffn_rule(B):
    """B11, B12 (and partial modes) take every B (320 and up on their wide
    routes, 576 to 2048 among them; B = 96 zero-padded to 128) and any F
    (F / m), padded to a multiple of 128: no width bound is left in
    either wrapper."""
    got = dpt_ffn.shape_refusal(B)
    assert got is None, got
    assert not hasattr(dpt_ffn, "MAX_WIDTH")
    assert not hasattr(dpt_attention, "MAX_WIDTH")


@pytest.mark.parametrize("overrides,n_model,pairs,want", [
    (dict(), 1, False, {}),
    (dict(hidden=96), 1, False, {}),
    (dict(hidden=96), 1, True, {}),
    (dict(bottleneck=576), 1, True, {}),
    (dict(bottleneck=576), 1, False, {}),
    (dict(conv_kernel=4), 1, False, {"block"}),
    (dict(conv_kernel=4, causal=True, norm_type="cLN"), 1, True, {}),
    (dict(conv_kernel=17), 1, True, {}),
    (dict(conv_kernel=17, causal=True, norm_type="cLN"), 1, True, {}),
    (dict(conv_kernel=33), 2, False, {}),
    (dict(conv_kernel=4), 2, False, {"stage2"}),
    (dict(hidden=192), 2, False, {}),
    (dict(hidden=192, norm_type="cLN"), 2, False, {}),
    (dict(separator="dpt"), 1, False, {}),
    (dict(separator="dpt", dpt_chunk=100), 1, False, {}),
    (dict(separator="dpt", bottleneck=320), 1, False, {}),
    (dict(separator="dpt", bottleneck=576), 1, False, {}),
    (dict(separator="dpt", bottleneck=512), 1, False, {}),
    (dict(separator="dpt", bottleneck=512), 2, False, {}),
    (dict(separator="dpt", bottleneck=448, compute_dtype="bfloat16"), 7,
     False, {}),
    (dict(separator="dpt", bottleneck=384), 4, False, {}),
    (dict(separator="dpt"), 8, False, {}),
    (dict(separator="dpt", dpt_ff=1280), 4, False, {}),
    (dict(hidden=1152), 2, False, {}),
    (dict(hidden=2048), 2, False, {}),
    (dict(separator="dpt", dpt_chunk=272), 1, False, {}),
    (dict(separator="dpt", dpt_chunk=320), 1, False, {}),
    (dict(separator="dpt", dpt_chunk=320, compute_dtype="bfloat16"), 1,
     False, {}),
    (dict(separator="dpt", dpt_chunk=320, compute_dtype="bfloat16"), 2,
     False, {}),
    (dict(separator="dpt", dpt_chunk=100, compute_dtype="bfloat16"), 1,
     False, {}),
    (dict(separator="dpt", dpt_heads=16), 1, False, {}),
    (dict(separator="dpt", dpt_heads=2), 1, False, {}),
    (dict(separator="dpt", dpt_heads=16), 2, False, {}),
    (dict(separator="dpt", dpt_heads=2), 2, False, {}),
    (dict(separator="dpt", dpt_heads=16), 4, False, {}),
    (dict(separator="dpt", dpt_heads=16, dpt_chunk=272), 1, False, {}),
    (dict(separator="dpt", dpt_heads=2, dpt_chunk=272), 1, False, {}),
    (dict(separator="dpt", dpt_heads=16, compute_dtype="bfloat16"), 1,
     False, {}),
    (dict(separator="dpt", dpt_heads=2, compute_dtype="bfloat16"), 1,
     False, {}),
    (dict(separator="dpt", dpt_heads=2, compute_dtype="bfloat16"), 2,
     False, {}),
    (dict(separator="dpt", bottleneck=128, dpt_heads=1,
          compute_dtype="bfloat16"), 1, False, {}),
    (dict(separator="dpt", bottleneck=96), 1, False, {}),
    (dict(separator="dpt", bottleneck=192), 2, False, {}),
    (dict(separator="dpt", bottleneck=96, dpt_heads=6, dpt_ff=192), 3,
     False, {}),
    (dict(separator="dpt", bottleneck=480, compute_dtype="bfloat16"), 1,
     False, {}),
    (dict(separator="dpt", bottleneck=96, dpt_heads=2), 1, False, {}),
    (dict(separator="dpt", bottleneck=64, dpt_heads=8), 1, False, {}),
    (dict(separator="dpt"), 3, False, {"intra", "inter"}),
    (dict(separator="dpt", bottleneck=640), 1, False, {}),
    (dict(separator="dpt", bottleneck=1024), 1, False, {}),
    (dict(separator="dpt", bottleneck=1024, compute_dtype="bfloat16"), 1,
     False, {}),
    (dict(separator="dpt", bottleneck=1024), 2, False, {}),
    (dict(separator="dpt", bottleneck=1024, compute_dtype="bfloat16"), 2,
     False, {}),
    (dict(separator="dpt", bottleneck=2048), 1, False, {}),
    (dict(separator="dpt", bottleneck=2048, compute_dtype="bfloat16"), 2,
     False, {}),
    (dict(separator="dpt", bottleneck=576, compute_dtype="bfloat16"), 2,
     False, {}),
    (dict(separator="dpt", bottleneck=1152, dpt_heads=24), 1, False, {}),
    (dict(separator="dpt", bottleneck=576, dpt_heads=72,
          compute_dtype="bfloat16"), 1, False, {}),
], ids=["paper", "H96", "H96-pairs", "B576-pairs", "B576", "P4", "P4-cLN",
        "P17-pairs", "P17-cLN-pairs", "tp-P33", "tp-P4",
        "tp-Hs96", "tp-cLN", "dpt", "dpt-S100", "dpt-B320", "dpt-B576",
        "dpt-B512", "dpt-tp2-B512", "dpt-tp7-B448-bf16", "dpt-tp4-B384",
        "dpt-tp8",
        "dpt-tp4-F320", "tp-Hs576", "tp-Hs1024", "dpt-S272", "dpt-S320",
        "dpt-S320-bf16",
        "dpt-tp2-S320-bf16", "dpt-S100-bf16", "dpt-d16", "dpt-d128",
        "dpt-tp2-d16", "dpt-tp2-d128", "dpt-tp4-d16", "dpt-d16-S272",
        "dpt-d128-S272", "dpt-d16-bf16", "dpt-d128-bf16", "dpt-tp2-d128-bf16",
        "dpt-B128-d128-bf16", "dpt-B96", "dpt-tp2-B192", "dpt-tp3-B96-d16",
        "dpt-B480-bf16", "dpt-B96-d48", "dpt-B64-d8", "dpt-tp3", "dpt-B640",
        "dpt-B1024", "dpt-B1024-bf16", "dpt-tp2-B1024", "dpt-tp2-B1024-bf16",
        "dpt-B2048", "dpt-tp2-B2048-bf16", "dpt-tp2-B576-bf16",
        "dpt-B1152-d48", "dpt-B576-d8-bf16"])
def test_configuration_refusals_follow_the_rules(overrides, n_model, pairs,
                                                 want):
    """The kinds a configuration's kernels refuse, each with its wrapper's
    own words; with the kernels in use (auto on a CUDA device, or
    use_pallas=True) a refused configuration raises naming every refused
    kind, and a taken one runs them; use_pallas=False runs none."""
    cfg = ConvTasNetConfig(**overrides)
    got = shapes.refusals(cfg, n_model, pairs)
    assert set(got) == set(want)
    B, H, P, causal = (cfg.bottleneck, cfg.hidden, cfg.conv_kernel,
                       cfg.causal)
    m = n_model

    def attention(kind):
        h = cfg.dpt_num_heads
        if h % m:
            return (f"the partial kernels need a shard count m that divides "
                    f"the {h} heads and B={B}, got m={m}; shard counts that "
                    f"fit: {dpt_attention.fitting_shards(B, h)}")
        if kind == "intra":
            return dpt_intra.shape_refusal(B, cfg.dpt_chunk, B // m, h // m,
                                           cfg.compute_dtype)
        return dpt_attention.shape_refusal("inter", B, cfg.dpt_chunk, B // m,
                                           h // m, cfg.compute_dtype)

    rules = {
        "block": lambda: tcn_block.shape_refusal(B, H, P, causal),
        "pair": lambda: tcn_block_pair.shape_refusal(B, H, P, causal),
        "stage2": lambda: tcn_block_tp.shape_refusal(H // m, B, P, causal),
        "intra": lambda: attention("intra"),
        "inter": lambda: attention("inter"),
        "ffn": lambda: dpt_ffn.shape_refusal(B)}
    for kind, reason in got.items():
        assert reason == rules[kind]()
    for use_pallas in (None, True):
        if want:
            with pytest.raises(ValueError) as err:
                shapes.use_kernels(cfg, use_pallas, CUDA, n_model, pairs)
            assert all(shapes.LABELS[k] in str(err.value) and
                       got[k] in str(err.value) for k in want)
        else:
            assert shapes.use_kernels(cfg, use_pallas, CUDA, n_model, pairs)
    assert not shapes.use_kernels(cfg, False, CUDA, n_model, pairs)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [576, 640, 1024, 2048])
def test_dpt_above_512_and_every_head_width_are_taken(B, dtype, m):
    """A DPT above 512 channels (B / 32 heads of 32, F = 1024) is taken by
    every kind's rule, full and over two shards, in either dtype; so is the
    same width split into heads of 48 or 8 (widened to 64 and 16) or into
    one head of B (the route beside the cores), since C8's repair."""
    cfg = ConvTasNetConfig(separator="dpt", bottleneck=B,
                           compute_dtype=dtype)
    assert cfg.dpt_num_heads == B // 32
    assert shapes.refusals(cfg, m) == {}
    for d in (48, 8, B // m):
        if B % (d * m):
            continue
        heads = B // d
        got = shapes.refusals(dataclasses.replace(cfg, dpt_heads=heads), m)
        assert got == {}, (d, got)


def test_model_refuses_before_launching_and_keeps_false():
    """A model whose kernels refuse its configuration (a TCN with an even
    P outside the causal mode, which the JAX package refuses too; every B,
    every head width and every odd P the JAX package runs is taken)
    raises under auto on a CUDA input as with use_pallas=True, naming the
    blocks and the rule, before it touches the input. A DPT with 2 heads of
    48 at B = 96 (C8, now taken) serves with use_pallas=False, or auto on a
    CPU input, through the plain ops without a warning; use_pallas=True
    refuses a CPU input."""
    refused = ConvTasNetConfig(n_filters=16, kernel_size=8, bottleneck=32,
                               hidden=64, num_blocks=2, num_repeats=1,
                               conv_kernel=4)
    cfg = ConvTasNetConfig(n_filters=16, kernel_size=8, bottleneck=96,
                           separator="dpt", dpt_layers=1, dpt_heads=2,
                           dpt_ff=256)
    assert shapes.refusals(cfg) == {}
    on_card = types.SimpleNamespace(device=CUDA)   # read for its device
    for use_pallas in (None, True):
        with pytest.raises(ValueError, match=r"TCN blocks \(B1-B3\): "
                           r"non-causal SAME padding requires odd kernel "
                           r"size"):
            ConvTasNet(refused, use_pallas=use_pallas)(on_card)
    mix = torch.randn(1, 80, generator=torch.Generator().manual_seed(0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for use_pallas in (None, False):
            with torch.no_grad():
                out = ConvTasNet(cfg, use_pallas=use_pallas)(mix)
            assert out.shape == (1, 2, 80) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ConvTasNet(cfg, use_pallas=True)(mix)
    taken = dataclasses.replace(cfg, bottleneck=576, dpt_heads=18)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ConvTasNet(taken, use_pallas=True)(mix)


def _jax_variables(cfg, seed=0):
    """Seeded numpy weights in the JAX model's variables tree, every norm
    affine, slope and bias moved off its init."""
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
        if not s.shape:                        # PReLU slope
            return np.float32(0.25) + 0.05 * r
        return r / np.float32(np.sqrt(s.shape[0]))

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("overrides,jax_pallas", [
    (dict(n_filters=32, kernel_size=8, bottleneck=64, hidden=96,
          num_blocks=3, num_repeats=1), True),
    (dict(n_filters=32, kernel_size=8, bottleneck=64, separator="dpt",
          dpt_chunk=100, dpt_layers=1, dpt_heads=2, dpt_ff=128), False),
    (dict(n_filters=32, kernel_size=8, bottleneck=64, separator="dpt",
          dpt_chunk=272, dpt_layers=1, dpt_heads=2, dpt_ff=128), False),
], ids=["tcn-H96", "dpt-S100", "dpt-S272"])
def test_padded_configuration_matches_jax(overrides, jax_pallas):
    """At a configuration the kernels take only padded, the port's
    forward through its kernels (their CPU twins here) matches the JAX
    model within 5e-4 in f32, on the same weights; and an f32 DPT with
    272-frame chunks, which the f32 intra kernels take on their
    row-statistics core (above 256 frames). JAX runs as its own CPU tests
    run each family: the TCN with its kernels on (interpret mode), the
    DPT on its XLA path."""
    cfg = ConvTasNetConfig(**overrides)
    assert shapes.refusals(cfg) == {}
    variables = _jax_variables(cfg)
    model = ConvTasNet(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    # 199 frames: two 100-frame chunks, the second padded; at 272-frame
    # chunks 299 frames, the second chunk padded
    T = 1200 if cfg.dpt_chunk > 256 else 800
    mix = np.random.default_rng(1).standard_normal((2, T)).astype(np.float32)
    with torch.no_grad():
        w = model.encoder(torch.from_numpy(mix))
        got = model.decoder(w, model.separator(w, True)).numpy()
    jcfg = dataclasses.replace(JaxConfig(**cfg.to_dict()),
                               use_pallas=jax_pallas)
    apply = jax.jit(functools.partial(jmodel.ConvTasNet(jcfg).apply,
                                      train=False))
    want = np.asarray(apply(variables, jnp.asarray(mix)))
    assert got.shape == want.shape == (2, 2, T)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def _close(got, want, atol=1e-5):
    for q, w in zip(got, want):
        assert q.shape == w.shape
        torch.testing.assert_close(q, w, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("S", [100, 37])
@pytest.mark.parametrize("partial", [False, True])
def test_intra_chunk_padding_is_exact(S, partial):
    """The intra kernels run a chunk of S frames padded to a multiple of
    16 with the new frames masked as keys (``pad_chunks``): the sublayer's
    math at the padded length, sliced back, is the unpadded sublayer's, in
    the forward and in every cotangent, in f32."""
    gen = torch.Generator().manual_seed(S)
    M, n, B, heads = 2, 3, 64, 2
    Bq = B // 2 if partial else B
    x = torch.randn(M, n, S, B, generator=gen)
    g = torch.randn(M, n, S, B, generator=gen)
    w = (1 + 0.1 * torch.randn(B, generator=gen),
         0.1 * torch.randn(B, generator=gen),
         torch.randn(B, 3 * Bq, generator=gen) / B ** 0.5,
         torch.randn(Bq, B, generator=gen) / Bq ** 0.5)
    key_bias = torch.where(torch.arange(n * S).reshape(n, S) < n * S - 13,
                           0.0, dpt_attention.NEG_INF)
    kw = dict(n_heads=heads // 2 if partial else heads, partial=partial)
    Sp = -(-S // dpt_attention.INTRA_ROWS) * dpt_attention.INTRA_ROWS
    xp, bp = dpt_attention.pad_chunks(x, key_bias, Sp)
    gp = torch.nn.functional.pad(g, (0, 0, 0, Sp - S))
    assert xp.shape[2] == bp.shape[1] == Sp and (bp[:, S:] < -1e8).all()
    got = dpt_intra.intra_attention_reference(xp, *w, bp, **kw)[:, :, :S]
    want = dpt_intra.intra_attention_reference(x, *w, key_bias, **kw)
    _close([got], [want])
    got = list(dpt_intra.intra_attention_bwd_reference(xp, gp, *w, bp, **kw))
    got[0] = got[0][:, :, :S]
    _close(got, dpt_intra.intra_attention_bwd_reference(x, g, *w, key_bias,
                                                        **kw))


@pytest.mark.parametrize("F", [192, 100])
@pytest.mark.parametrize("partial", [False, True])
def test_ffn_hidden_padding_is_exact(F, partial):
    """The FFN kernels run a hidden width off the 128-column tile padded
    with zero units (``pad_hidden``): the sublayer's math at the padded
    width is the unpadded one's, in the forward and in every cotangent
    (the padded units' own gradients dropped), in f32."""
    gen = torch.Generator().manual_seed(F)
    B = 64
    x = torch.randn(2, 50, B, generator=gen)
    g = torch.randn(2, 50, B, generator=gen)
    gamma = 1 + 0.1 * torch.randn(B, generator=gen)
    beta = 0.1 * torch.randn(B, generator=gen)
    w_up = torch.randn(B, F, generator=gen) / B ** 0.5
    b_up = 0.1 * torch.randn(F, generator=gen)
    w_down = torch.randn(F, B, generator=gen) / F ** 0.5
    b_down = 0.1 * torch.randn(B, generator=gen)
    pu, pb, pd = dpt_ffn.pad_hidden(w_up, b_up, w_down)
    assert pu.shape[1] % dpt_ffn.F_TILE == 0 and pd.shape[0] == pu.shape[1]
    _close([dpt_ffn.ffn_reference(x, gamma, beta, pu, pb, pd, b_down,
                                  partial=partial)],
           [dpt_ffn.ffn_reference(x, gamma, beta, w_up, b_up, w_down, b_down,
                                  partial=partial)])
    got = list(dpt_ffn.ffn_bwd_reference(x, g, gamma, beta, pu, pb, pd,
                                         b_down, partial=partial))
    got[3], got[4], got[5] = got[3][:, :F], got[4][:F], got[5][:F]
    _close(got, dpt_ffn.ffn_bwd_reference(x, g, gamma, beta, w_up, b_up,
                                          w_down, b_down, partial=partial))


@pytest.mark.parametrize("Hs,B", [(96, 64), (64, 96), (100, 40)])
def test_tp_stage2_padding_is_exact(Hs, B):
    """B6 runs a shard width or bottleneck off the 64-column tile padded
    with zero channels (``pad_shard``): stage 2's math at the padded
    widths gives the unpadded z and gLN-2 sums, in f32."""
    gen = torch.Generator().manual_seed(Hs + B)
    M, K, P = 2, 90, 3
    h = torch.nn.functional.leaky_relu(torch.randn(M, K, Hs, generator=gen),
                                       0.25)
    stats1 = torch.stack([0.3 + 0.05 * torch.randn(M, generator=gen),
                          1.2 + 0.1 * torch.randn(M, generator=gen)], -1)
    dw = torch.randn(P, Hs, generator=gen) / 3
    w_out = torch.randn(Hs, B, generator=gen) / Hs ** 0.5
    g1, b1, g2 = (1 + 0.1 * torch.randn(Hs, generator=gen),
                  0.1 * torch.randn(Hs, generator=gen),
                  1 + 0.1 * torch.randn(Hs, generator=gen))
    a2 = torch.tensor(0.25)
    hp, dwp, wp, g1p, b1p, g2p = tcn_block_tp.pad_shard(h, dw, w_out, g1, b1,
                                                        g2)
    assert wp.shape == (-(-Hs // 64) * 64, -(-B // 64) * 64)
    kw = dict(dilation=2, causal=False)
    z, sums = tcn_block_tp.tp_stage2_reference(hp, stats1, dwp, wp, a2, g1p,
                                               b1p, g2p, **kw)
    want = tcn_block_tp.tp_stage2_reference(h, stats1, dw, w_out, a2, g1, b1,
                                            g2, **kw)
    _close([z[..., :B], sums], want)


@pytest.mark.parametrize("B,H", [(32, 96), (96, 64), (100, 100)])
def test_block_padding_is_exact_per_channel(B, H):
    """``pad_block`` puts a block's weights in the top-left corner of the
    padded ones, zeros elsewhere. With BN (per-channel statistics, nothing
    summed over channels) the block's math at the padded widths, sliced
    back, is the unpadded block's; the gLN and cLN kernels divide their
    sums by the block's own H, which the card tests hold."""
    gen = torch.Generator().manual_seed(B + H)
    M, K, P = 2, 50, 3
    x = torch.randn(M, K, B, generator=gen)
    mats = (torch.randn(B, H, generator=gen) / B ** 0.5,
            torch.randn(P, H, generator=gen) / 3,
            torch.randn(H, B, generator=gen) / H ** 0.5)
    vecs = [1 + 0.1 * torch.randn(H, generator=gen),
            0.1 * torch.randn(H, generator=gen),
            1 + 0.1 * torch.randn(H, generator=gen),
            0.1 * torch.randn(H, generator=gen)]
    bn = [0.1 * torch.randn(H, generator=gen),
          1 + torch.rand(H, generator=gen),
          0.1 * torch.randn(H, generator=gen),
          1 + torch.rand(H, generator=gen)]
    (pw_in, pdw, pw_out), pv = tcn_block.pad_block(mats, vecs + bn)
    Bp, Hp = tcn_block.padded(B), tcn_block.padded(H)
    assert pw_in.shape == (Bp, Hp) and pdw.shape == (P, Hp)
    assert pw_out.shape == (Hp, Bp) and all(v.shape == (Hp,) for v in pv)
    assert torch.equal(pw_in[:B, :H], mats[0]) and not pw_in[B:].any()
    assert not pw_in[:, H:].any() and not pw_out[H:].any()
    assert not pw_out[:, B:].any() and not pdw[:, H:].any()
    a1, a2 = torch.tensor(0.25), torch.tensor(-0.1)
    kw = dict(dilation=2, causal=False, norm_type="BN")
    got = tcn_block.fused_tcn_block_reference(
        torch.nn.functional.pad(x, (0, Bp - B)), pw_in, pdw, pw_out, a1, a2,
        *pv[:4], **kw, bn_stats=tuple(pv[4:]))
    want = tcn_block.fused_tcn_block_reference(x, *mats, a1, a2, *vecs, **kw,
                                               bn_stats=tuple(bn))
    assert not got[..., B:].any()
    _close([got[..., :B]], [want])
