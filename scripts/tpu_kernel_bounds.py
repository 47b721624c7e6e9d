#!/usr/bin/env python3
"""Least times on an H100 for the TPU kernels the port has not ported yet.

    python3 scripts/tpu_kernel_bounds.py

Prints, for B4 (``tcn_block_pair.py::_kernel_pair``), B5
(``tcn_block_pair_bwd.py::_pair_bwd_kernel``) and B6
(``tcn_block_tp.py::_tp2_kernel``, one shard of 4) at the paper shape
(M=8 rows of 4 s, K=3199 frames, B=256, H=512, P=3, bf16 operands, f32
norm vectors), the rule ``chip_smoke.py`` bounds a ported kernel by: the
larger of its operations at the bf16 tensor-core peak and its bytes at the
HBM rate, with each product counted at 2 FLOP per multiply-add, each input
read once and each output written once. Arithmetic on shapes only: it
needs neither a card nor JAX.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense, at its 700 W power limit
PEAK_BYTES_S = 3.35e12     # HBM3
M, K, B, H, P = 8, 3199, 256, 512, 3
BF16, F32 = 2, 4


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def block_weights(h: int) -> int:
    """W_in [B,h], dw [P,h], W_out [h,B] in bf16; a1, a2 and four norm
    vectors [h] in f32."""
    return (2 * B * h + P * h) * BF16 + (2 + 4 * h) * F32


def main() -> int:
    prod = 2 * M * K * B * H          # one [M*K, B] x [B, H] product
    conv = 2 * M * K * H * P          # one depthwise pass
    act = M * K * B * BF16            # one [M, K, B] activation
    rows = {
        # two blocks: two products and a depthwise pass each; x read, the
        # pair's output written
        "B4 tcn_block_pair.py:63": (4 * prod + 2 * conv,
                                    2 * act + 2 * block_weights(H)),
        # the pair backward's 13 products (tcn_block_pair_bwd.py:418) and
        # its six depthwise passes; x0 and g read, dx and both blocks'
        # weight cotangents written
        "B5 tcn_block_pair_bwd.py:63": (13 * prod + 6 * conv,
                                        3 * act + 4 * block_weights(H)),
    }
    # B6, one shard of 4 (Hs = H/4): reads h [M,K,Hs], dw [P,Hs], W_out
    # [Hs,B] (bf16), gamma1/beta1/gamma2 [Hs], the gLN-1 stats [M,2] and a2
    # (f32); writes z [M,K,B] (bf16) and the partial gLN-2 sums [M,2] (f32)
    hs = H // 4
    b6_bytes = ((M * K * hs + P * hs + hs * B) * BF16
                + (3 * hs + 2 * M + 1) * F32
                + M * K * B * BF16 + 2 * M * F32)
    rows["B6 tcn_block_tp.py:148 (per shard of 4)"] = (
        2 * M * K * hs * B + 2 * M * K * hs * P, b6_bytes)
    for name, (flops, nbytes) in rows.items():
        ms, by = bound(flops, nbytes)
        print(f"{name}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB -> "
              f"bound {ms:.4f} ms ({by})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
