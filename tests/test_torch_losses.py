"""The port's uPIT SI-SNR loss against ``convtasnet_tpu.losses.pit``.

The same seeded numpy signals go through both; everything is float32, so
the bar is float32 rounding of the same sums (1e-4 relative on SI-SNR in
dB, exact on permutations and on the reordered estimates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.losses import pit as jpit
from convtasnet_tpu_torch.losses import pit as ppit


def _signals(seed, B, C, T, lengths=None):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, C, T)).astype(np.float32)
    # estimates: a permuted, noisy copy of the sources, so PIT has a
    # clear best permutation per row
    est = np.empty_like(src)
    perms = [rng.permutation(C) for _ in range(B)]
    for b, p in enumerate(perms):
        est[b] = src[b, p] + 0.3 * rng.standard_normal((C, T))
    if lengths is None:
        lengths = [T] * B
    lengths = np.asarray(lengths, np.int32)
    for b, n in enumerate(lengths):
        src[b, :, n:] = 0.0
    return src, est, lengths


@pytest.mark.parametrize("C,lengths", [(2, None), (2, [4000, 2500, 1000]),
                                       (3, [4000, 3100, 4000])])
def test_pit_si_snr_matches_jax(C, lengths):
    src, est, lens = _signals(C, 3, C, 4000, lengths)
    want_snr, want_perm = jpit.pit_si_snr(jnp.asarray(src), jnp.asarray(est),
                                          jnp.asarray(lens))
    got_snr, got_perm = ppit.pit_si_snr(torch.from_numpy(src),
                                        torch.from_numpy(est),
                                        torch.from_numpy(lens))
    assert got_snr.dtype == torch.float32
    np.testing.assert_allclose(got_snr.numpy(), np.asarray(want_snr),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))


def test_reorder_source_uses_the_inverse_permutation():
    """At C=3 a 3-cycle is not its own inverse: the reordered estimates
    must line up with the references."""
    src, _, lens = _signals(5, 2, 3, 2000)
    cycle = np.array([[1, 2, 0], [2, 0, 1]])
    est = np.stack([src[b, cycle[b]] for b in range(2)]).astype(np.float32)
    _, perm = ppit.pit_si_snr(torch.from_numpy(src), torch.from_numpy(est),
                              torch.from_numpy(lens))
    got = ppit.reorder_source(torch.from_numpy(est), perm).numpy()
    want = jpit.reorder_source(jnp.asarray(est), jnp.asarray(perm.numpy()))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, src)


def test_cal_loss_matches_jax():
    src, est, lens = _signals(7, 4, 2, 3000, [3000, 2000, 3000, 1500])
    want = jpit.cal_loss(jnp.asarray(src), jnp.asarray(est),
                         jnp.asarray(lens))
    got = ppit.cal_loss(torch.from_numpy(src), torch.from_numpy(est),
                        torch.from_numpy(lens))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_si_snr_single_matches_jax():
    src, est, _ = _signals(9, 3, 2, 2500)
    want = jpit.si_snr_single(jnp.asarray(src), jnp.asarray(est))
    got = ppit.si_snr_single(torch.from_numpy(src), torch.from_numpy(est))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_length_mask_and_f32_math_under_bf16():
    lens = np.array([3, 5], np.int32)
    np.testing.assert_array_equal(
        ppit.length_mask(torch.from_numpy(lens), 6).numpy(),
        np.asarray(jpit.length_mask(jnp.asarray(lens), 6)))
    src, est, lens = _signals(11, 2, 2, 2000)
    snr, _ = ppit.pit_si_snr(torch.from_numpy(src),
                             torch.from_numpy(est).bfloat16(),
                             torch.from_numpy(lens))
    assert snr.dtype == torch.float32
