"""A numpy model of the f32 TCN stages' product arithmetic
(``csrc/hopper_gemm_tf32.cuh``): rounding to tf32 as the core splits an
operand, and the 3xTF32 product lo*hi + hi*lo + hi*hi, at the depths the
stages run at the paper widths (B = 256 and H = 512 for the row-tile
products, the 25,592 rows of [8, 3199] for the weight gradients W').

It documents the bar the card tests hold the f32 stages to: 3xTF32 within
1e-5 relative of the f64 product, where one TF32 product (10 bits of each
operand's mantissa) is outside it. The model sums in f64 (products of tf32
values are exact there), so it leaves out the tensor cores' own
accumulation, which the core keeps to one 32-deep slab at a time; the card
tests (``tests/test_torch_cuda.py``, ``-k tf32``) hold that part."""

import numpy as np
import pytest

BAR = 1e-5


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """v (f32) rounded to tf32 as the core rounds it: add half of the
    dropped 13 bits to the magnitude, then drop them (round to nearest,
    ties away from zero: cvt.rna.tf32.f32's bits)."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v: np.ndarray):
    """hi, lo of the 3xTF32 split: hi = rna(v), lo = rna(v - hi)."""
    v = np.asarray(v, np.float32)
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def operands(rows: int, depth: int, cols: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, depth)).astype(np.float32),
            rng.standard_normal((depth, cols)).astype(np.float32))


def three_tf32(a, b):
    """The core's product: the three tf32 products summed (in f64)."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = np.float64
    return (al.astype(f) @ bh.astype(f) + ah.astype(f) @ bl.astype(f)
            + ah.astype(f) @ bh.astype(f))


def one_tf32(a, b):
    return tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64)


def test_rounding_matches_round_half_away_on_the_mantissa():
    """tf32_rna keeps the sign, the exponent and the top 10 mantissa bits,
    rounded to the nearest with ties away from zero, and carries into the
    exponent where the mantissa overflows."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)   # tf32's unit at 1
    cases = [
        (one, one),
        (one + ulp / 2, one + ulp),              # a tie: away from zero
        (-(one + ulp / 2), -(one + ulp)),
        (one + ulp / 2 - np.float32(2 ** -23), one),   # just below the tie
        (one + np.float32(3) * ulp / 2, one + 2 * ulp),
        (np.float32(2) - ulp / 2, np.float32(2)),      # carries into 2
        (np.float32(0), np.float32(0)),
        (np.float32(-0.0), np.float32(-0.0)),
    ]
    for v, want in cases:
        got = tf32_rna(np.array([v], np.float32))[0]
        assert got == want and np.signbit(got) == np.signbit(want), v
    v = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi = tf32_rna(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any()       # 10 mantissa bits
    assert np.all(np.abs(v - hi) <= np.abs(hi) * 2.0 ** -11)


def test_split_is_exact_and_zero_splits_to_zeros():
    """v - hi is exact in f32 and lo keeps all but ~2^-22 of v; a zero
    (a padded depth column) splits into two zeros, so it adds exact
    zeros to every product."""
    v = np.random.default_rng(1).standard_normal(10000).astype(np.float32)
    hi, lo = split(v)
    rest = v.astype(np.float64) - hi.astype(np.float64)
    assert np.array_equal((v - hi).astype(np.float64), rest)
    assert np.all(np.abs(rest - lo) <= np.abs(v) * 2.0 ** -21)
    hi0, lo0 = split(np.zeros(4, np.float32))
    assert not hi0.any() and not lo0.any()


@pytest.mark.parametrize("rows,depth,cols", [
    (256, 256, 128),     # A' and G1': depth B = 256
    (256, 512, 128),     # C' and G2b': depth H = 512
    (64, 25592, 64),     # W': depth M K = 25,592 rows
])
def test_three_tf32_is_within_the_bar_and_one_is_not(rows, depth, cols):
    a, b = operands(rows, depth, cols, depth)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert rel(three_tf32(a, b), exact) <= BAR / 10
    assert rel(one_tf32(a, b), exact) > 10 * BAR


@pytest.mark.parametrize("depth", [256, 512])
def test_zero_depth_columns_add_exact_zeros(depth):
    """A block run padded (B or H off 64, zero-padded up to it) multiplies
    zero depth columns: the 3xTF32 product equals the unpadded one."""
    a, b = operands(32, depth - 32, 16, 7)
    ap = np.concatenate([a, np.zeros((32, 32), np.float32)], axis=1)
    bp = np.concatenate([b, np.zeros((32, 16), np.float32)], axis=0)
    assert np.array_equal(three_tf32(ap, bp), three_tf32(a, b))
