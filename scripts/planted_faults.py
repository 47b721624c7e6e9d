#!/usr/bin/env python3
"""Plant known faults in copies of the TCN block forward (kernel B1) and
its gLN backward (B2) on the Hopper core, of the DPT sublayer kernels, of
the cLN block backward (B3), of the TCN block pair (B4 and B5, which run
each block through the single block's launches), of
the TCN's tensor parallelism (kernel B6 and the shard sum around it) and
of the dual-path tensor parallelism (the partial kernels B7p-B12p and
the shard sums around them), of the padding that runs widths off the
kernels' tiles, of the TCN kernels' routes past 16 depthwise taps, of
the DPT kernels' routes above 512 channels and of the DPT attention at
head widths off its cores, and report which checks see each one. Needs
one CUDA GPU and nvcc.

    python3 scripts/planted_faults.py [--log-dir DIR] [--only NAME ...] \\
        [--jobs N]

For each fault the script copies ``convtasnet_tpu_torch/`` (without its
build directory), ``chip_smoke.py``, ``pyproject.toml`` and
``tests/test_torch_cuda.py`` into a temporary directory, edits one line of
the copy (a kernel source, or a module around one), and runs there,
against the edited code, the
smoke phases of the kernel's kind (``PHASES``: for B1
``chip_smoke.phase_kernel_vs_twin`` gLN and cLN causal and
``phase_step_compare(torch, "tcn")``, for B2 ``phase_bwd_vs_twin(torch,
bwd)`` and ``phase_step_compare(torch, "tcn")``, for a DPT forward kernel
``chip_smoke.phase_dpt_kernels_vs_twin`` and ``phase_dpt_forward``, for a
DPT backward ``phase_dpt_bwd_vs_twin``, ``phase_ffn_bwd_tail_tiles``,
``phase_step_compare(torch, "dpt")`` and ``phase_dpt_head_widths``, for
B3 ``phase_bwd_vs_twin(torch, bwd, "cLN")`` and
``phase_step_compare(torch, "tcn", "cLN")``, for f32 B3 on the 3xTF32
stages ``phase_tcn_f32_stages``, for the block pair
``phase_pair_vs_twin``, ``phase_pair_bwd_vs_twin`` and
``phase_step_compare(torch, "tcn")``, for tensor parallelism
``phase_tp_stage2_vs_twin``, ``phase_tp_forward`` and
``phase_step_compare(torch, "tcn")``, for dual-path tensor parallelism
``phase_dpt_partial_vs_twin``, ``phase_dpt_tp_forward`` and
``phase_step_compare(torch, "dpt")``, for the padding
``phase_auto_padded``, for the routes past 16 depthwise taps
``phase_tcn_taps``, for the DPT routes above 512
``phase_dpt_wider_kernels``, for the head widths off the cores
``phase_dpt_head_width_kernels``), then the kind's ``cuda``-marked
tests. The repository itself is never edited. A fault is caught when either
run fails. ``--jobs N`` runs N faults at once on the one card. Each run's
full output goes to ``--log-dir`` (default: a new temporary directory),
one file per fault.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (kind, file, the line's text as it is, the planted text)
FAULTS = {
    "inter_bias_transposed": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_attention.cu",
        "p.bias[static_cast<size_t>(k0 + j) * S + s]",
        "p.bias[static_cast<size_t>(s) * n + k0 + j]"),
    "intra_mask_dropped": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_intra.cu",
        "b_s[k] = p.bias ? p.bias[static_cast<size_t>(chunk) * S + k] : 0.f;",
        "b_s[k] = 0.f;"),
    "ffn_gelu_erf": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_ffn.cu",
        "return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));",
        "return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)) + 0.f * k;"),
    "inter_no_rescale": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_attention.cu",
        "sum = sum * expf(mx - mn) + expf(sc - mn);",
        "sum = sum + expf(sc - mn);"),
    "ln_eps_1e-5": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_common.cuh",
        "constexpr float kLnEps = 1e-6f;",
        "constexpr float kLnEps = 1e-5f;"),
    # B11's and B9's bf16 Hopper forwards (and their partial modes): GELU
    # by erf for tanh, pre added to GELU unrounded, the h slab truncated
    # instead of rounded, the core's padded keys (past the chunk in its
    # last 16-key tile) left unmasked, the max pass (shared with the
    # backward core) one key tile short, the partial out product and the
    # partial FFN adding the residual
    "b11_gelu_erf": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_bwd_common.cuh",
        "  return x * (0.5f * (1.f + t));",
        "  return x * (0.5f * (1.f + erff(x * 0.70710678118654752f))) + "
        "0.f * t;"),
    "b11_pre_unrounded": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_ffn.cu",
        "      return gelu_tanh_fast(round_to<bf16>(round_to<bf16>(acc) +\n"
        "                                           round_to<bf16>(b)));",
        "      return gelu_tanh_fast(round_to<bf16>(acc) + "
        "round_to<bf16>(b));"),
    "b11_h_slab_truncated": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_ffn.cu",
        "__floats2bfloat162_rn(h_of(acc_u[i], bu.x),\n"
        "                                h_of(acc_u[i + 1], bu.y));",
        "__halves2bfloat162(__float2bfloat16_rz(h_of(acc_u[i], bu.x)),\n"
        "                    __float2bfloat16_rz(h_of(acc_u[i + 1], bu.y)));"),
    "b9_padded_keys_unmasked": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        "bias[i] = k < L ? G.key_bias(k) : -INFINITY;",
        "bias[i] = k < L ? G.key_bias(k) : 0.f;"),
    "core_max_pass_one_tile_short": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        "    for (int k0 = 0; k0 < rows; k0 += 16) {\n      float s[2][4];",
        "    for (int k0 = 0; k0 < rows - 16; k0 += 16) {\n      float s[2][4];"),
    # B7's bf16 design (the forward frame with the core's inter gather):
    # the key mask dropped, the key bias of the next position (in bounds;
    # B8 reads the same gather); and the core at d = 128 without its dk
    # walk (dk left as the workspace held it)
    "b7_key_mask_dropped": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_attention.cu",
        "return launch_attention_fwd_wg(p, stream, launch_fwd_core_d<true>);",
        "DptAttnParams q = p; q.bias = nullptr; "
        "return launch_attention_fwd_wg(q, stream, launch_fwd_core_d<true>);"),
    "b7_key_bias_of_next_position": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        "return kInter ? f.bias[static_cast<size_t>(k) * f.S + blockIdx.x]",
        "return kInter ? f.bias[static_cast<size_t>(k) * f.S + "
        "(blockIdx.x + 1) % f.S]"),
    "core_d128_dk_walk_dropped": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        "      key_pass(No{}, Yes{});",
        "      (void)0;"),
    "b9_partial_adds_residual": ("dpt_tp",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        "  q.res = f.partial ? nullptr : static_cast<const bf16*>(f.x);",
        "  q.res = static_cast<const bf16*>(f.x);"),
    "b11_partial_adds_residual": ("dpt_tp",
        "convtasnet_tpu_torch/csrc/dpt_ffn.cu",
        "  const bool residual = !p.partial;",
        "  const bool residual = true;"),
    # the backward kernels
    "intra_bwd_rowsum_dropped": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_intra_bwd.cu",
        "drow[k] = prow[k] * (drow[k] - rs) * scale;",
        "drow[k] = prow[k] * drow[k] * scale + 0.f * rs;"),
    "inter_bwd_bias_transposed": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_attention_bwd.cu",
        "p.bias[static_cast<size_t>(c) * S + s]",
        "p.bias[static_cast<size_t>(s) * n + c]"),
    "ffn_bwd_gelu_erf_derivative": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_ffn_bwd.cu",
        "*dy = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * "
        "(1.f + 3.f * a * x * x);",
        "*dy = 0.5f * (1.f + erff(x * 0.70710678118654752f)) + "
        "x * 0.3989422804014327f * expf(-0.5f * x * x) + 0.f * a;"),
    # B12's bf16 design: UG taking gelu' of the rounded h in place of
    # pre's, and DN dropping the last (partial) row tile's dgamma partials
    "b12_gelu_grad_of_h": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_ffn_bwd.cu",
        "gelu_and_grad_fast(pre, &hv, &dg);",
        "gelu_and_grad_fast(pre, &hv, &dg); float h_; "
        "gelu_and_grad_fast(round_to<bf16>(hv), &h_, &dg);"),
    "b12_dn_dgamma_dropped_for_tail_tile": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_bwd_common.cuh",
        "    q.part[static_cast<size_t>(blockIdx.x) * 2 * B + e] = sum;",
        "    q.part[static_cast<size_t>(blockIdx.x) * 2 * B + e] = "
        "(e < B && r0 + kWgRows > R) ? 0.f : sum;"),
    "inter_bwd_dk_unscaled": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_attention_bwd.cu",
        "round_to<T>(pj * (dot(dav, vv) - st[2]) * scale)",
        "round_to<T>(pj * (dot(dav, vv) - st[2]))"),
    # B8's and B10's bf16 design (dpt_attn_bwd_wg.cuh): the core's key side
    # reading the stats of the next query row, its rowsum taken from
    # round(p), its keys past the length of the last 16-row tile left
    # unmasked (bias 0 for -inf), LQ's LN (shared with B12's UG) without
    # its eps, and DN adding the residual in partial mode
    "attn_wg_key_side_stats_of_next_row": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        "const float* st = P.stats + (G.row(q) * h + hd) * kNumRowStats;",
        "const float* st = P.stats + (G.row((q + 1) % L) * h + hd) * "
        "kNumRowStats;"),
    "attn_wg_rowsum_of_rounded_p": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        "for (int e = 0; e < 4; ++e) rsum[e >> 1] += p[j][e] * dp[j][e];",
        "for (int e = 0; e < 4; ++e) rsum[e >> 1] += "
        "round_to<bf16>(p[j][e]) * dp[j][e];"),
    "attn_wg_padded_keys_unmasked": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        "s_vec[i] = k < L ? G.key_bias(k) : -INFINITY;",
        "s_vec[i] = k < L ? G.key_bias(k) : 0.f;"),
    "attn_wg_lq_ln_without_eps": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_bwd_common.cuh",
        "rs[u] = rsqrtf(warp_sum(rs[u]) / Bn + kLnEps);",
        "rs[u] = rsqrtf(warp_sum(rs[u]) / Bn);"),
    "attn_wg_dn_residual_in_partial": ("dpt_tp",
        "convtasnet_tpu_torch/csrc/dpt_attn_bwd_wg.cuh",
        ": launch_dy_ln_wg(q, !f.partial, stream));",
        ": launch_dy_ln_wg(q, true, stream));"),
    # the TCN block forward (B1) on the Hopper core: C' recomputing y with
    # its taps one row off (the halo shifted by one), and B' writing
    # sample m's norm2 partials into the next sample's slots
    "b1_c_halo_off_by_one": ("block_forward",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "static_cast<const bf16*>(p.dw), K, H, P, d, left, r0, cg, rg,",
        "static_cast<const bf16*>(p.dw), K, H, P, d, left + 1, r0, cg, rg,"),
    "b1_b_stats_of_next_sample": ("block_forward",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "    float* dst = p.part_b + 2 * (static_cast<size_t>(m) * gridDim.x + "
        "blockIdx.x);",
        "    float* dst = p.part_b + 2 * (static_cast<size_t>((m + 1) % "
        "gridDim.y) * gridDim.x + blockIdx.x);"),
    # B1's cLN path in C': the normalised row rounded without norm2's
    # shift b2 (the b2 @ W_out term of the fold it replaced, forgotten),
    # and the row's two warps at H = 512 not waiting for each other's half
    # of the row sums (a race)
    "b1_cln_shift_dropped": ("block_forward",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "yv[j] = k < K ? (yv[j] - mu) * rs * g2[j] + b2[j] : 0.f;",
        "yv[j] = k < K ? (yv[j] - mu) * rs * g2[j] : 0.f;"),
    "b1_cln_row_halves_unsynced": ("block_forward",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "if (n_seg > 1)",
        "if (n_seg < 1)"),
    # the gLN block backward (B2): G1' writing F3's partials (t1, t2) into
    # the next sample's slots, and the split-row weight gradients summing
    # the rows past the last one (read beyond the operands, not zeros)
    "b2_f3_stats_of_next_sample": ("block_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "      float* dst = p.part + 2 * (static_cast<size_t>(m) * gridDim.x + "
        "bx);",
        "      float* dst = p.part + 2 * (static_cast<size_t>((m + 1) % "
        "gridDim.y) * gridDim.x + bx);"),
    "b2_wgrad_rows_past_the_end": ("block_backward",
        "convtasnet_tpu_torch/csrc/hopper_gemm.cuh",
        "  const int r_end = min(rows, r0 + chunk);",
        "  const int r_end = r0 + chunk;"),
    # the cLN block backward (B3), in bf16 on the Hopper stages
    # (tcn_block_bwd_hopper.cuh: E2' as it runs at P = 3, e2_dc_kernel)
    # and, for the row finaliser both dtypes run, in
    # tcn_block_bwd_common.cuh
    "cln_bwd_tap_stats_of_output_row": ("cln_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "unpack4(hp_t[u][q], hv);\n            float mu = 0.f, rs = 1.f;\n"
        "            if (cln) {\n"
        "              const float* sk = stat_at(p, true, m, kh);",
        "unpack4(hp_t[u][q], hv);\n            float mu = 0.f, rs = 1.f;\n"
        "            if (cln) {\n"
        "              const float* sk = stat_at(p, true, m, j);"),
    "cln_bwd_g1_row_sum_half_twice": ("cln_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "            q2 = group_sum(q2, kSeg);",
        "            q2 = 2.f * group_sum(q2, kSeg / 2);"),
    "cln_bwd_e2_row_partial_shifted": ("cln_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "2 * ((static_cast<size_t>(m) * K + j) * gridDim.y + blockIdx.y);",
        "2 * ((static_cast<size_t>(m) * K + (j + 1) % K) * gridDim.y + "
        "blockIdx.y);"),
    "cln_bwd_row_mean_over_h_minus_1": ("cln_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_common.cuh",
        "st[slot + 1] = static_cast<float>(s2 / H);",
        "st[slot + 1] = static_cast<float>(s2 / (H - 1));"),
    # the block pair (B4, B5), which runs each block through the single
    # block's launches: B5 re-forming x1 on the first design's launches in
    # bf16 (another rounding than B4's x1; in f32 the same code), block 2
    # of B4 normalised with block 1's norm1 affine, run at block 1's
    # dilation, or reading the x1 rows of the neighbouring 128-row tile,
    # block 1's backward in B5 on g in place of dx1, and B5 keeping x1 in
    # the segment where block 2's backward writes dx1
    "pair_x1_rounded_otherwise": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair_bwd.cu",
        "  CTN_TRY(launch_block<T>(forward_params(",
        "  CTN_TRY(launch_block_first<T, kNormGLN>(forward_params("),
    "pair_block2_norm1_of_block1": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair.cu",
        "{w_in2, dw2, w_out2, a1b, a2b, g1b, b1b, g2b, b2b};",
        "{w_in2, dw2, w_out2, a1b, a2b, g1a, b1a, g2b, b2b};"),
    "pair_block2_dilation_of_block1": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair.cu",
        "part_b, M, K, B, H, Hn, P, d2, causal, norm);",
        "part_b, M, K, B, H, Hn, P, d1, causal, norm);"),
    "pair_block2_x1_of_neighbouring_tile": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair.cu",
        "  const Params p2 = block_params(wb, x1, out,",
        "  const Params p2 = block_params(wb, x1 + 128 * B, out,"),
    "pair_bwd_block1_cotangent_g": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair_bwd.cu",
        "BwdParams q1 = block_bwd_params(wa, x, dx1, dx,",
        "BwdParams q1 = block_bwd_params(wa, x, g, dx,"),
    "pair_bwd_x1_on_dx1": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair_bwd.cu",
        "  T* x1 = act + L.act[0];",
        "  T* x1 = act + L.act[1];"),
    # TCN tensor parallelism: B6 with the gLN-1 shift added for taps
    # outside [0, K) (the Pallas halo's trap; in the first design, which
    # bf16 runs at widths off the wgmma stage), B6 with g2 folded into W_out
    # in place of rounding y g2 (planted in its wrapper: W_eff in the
    # compute dtype and g2 = 1; in f32 the same numbers, so only bf16 can
    # see it), and the shard sum's epilogue without the g2 @ W_out term
    "tp2_shift_on_out_of_range_taps": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tp.cu",
        "if (kk < 0 || kk >= K) continue;  // zero padding after gLN-1",
        "if (kk < 0 || kk >= K) { acc = fmaf(to_f<T>(dw[q * Hs + c]), sh, "
        "acc); continue; }"),
    "tp2_g2_folded_into_w_out": ("tp",
        "convtasnet_tpu_torch/ops/cuda/tcn_block_tp.py",
        "    dw, w_out = (t.to(dt).contiguous() for t in (dw, w_out))",
        "    dw, w_out, gamma2 = (dw.to(dt).contiguous(), (w_out * gamma2[:, "
        "None]).to(dt).contiguous(), torch.ones_like(gamma2))"),
    # B6's wgmma stage (bf16): a tile's y partials written into the next
    # tile's slot (the sample's first slot never written, its last tile's
    # in the next sample's), and z stored one 64-column tile on
    "b6_wg_sums_in_next_tile_slot": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tp.cu",
        "float* dst = p.part + 2 * (static_cast<size_t>(m) * gridDim.x + "
        "blockIdx.x);",
        "float* dst = p.part + 2 * (static_cast<size_t>(m) * gridDim.x + "
        "blockIdx.x + 1);"),
    "b6_wg_z_one_column_tile_on": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tp.cu",
        "stage_store<kTpBN>(st, z, B, r0, K, (i / nk) * kTpBN, tid);",
        "stage_store<kTpBN>(st, z, B, r0, K, ((i / nk + 1) % n_tiles) * "
        "kTpBN, tid);"),
    # B6's wide route (shards past 512 channels): the channels past 512
    # dropped from the gLN-2 sums, and from the product (their round(y g2)
    # written as zeros)
    "b6_wide_sums_drop_channels_past_512": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tp.cu",
        "    t1 += v;\n    t2 += v * v;\n"
        "    y[static_cast<size_t>(k) * Hs + c]",
        "    if (c < 512) t1 += v;\n    if (c < 512) t2 += v * v;\n"
        "    y[static_cast<size_t>(k) * Hs + c]"),
    "b6_wide_product_drops_channels_past_512": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tp.cu",
        "y[static_cast<size_t>(k) * Hs + c] = from_f<T>(v * g2);",
        "y[static_cast<size_t>(k) * Hs + c] = from_f<T>(c < 512 ? v * g2 "
        ": 0.f);"),
    # B6's f32 route (every shard width on the 3xTF32 core): the weight's
    # lo terms dropped from the product (the prep's split writes lo as 0),
    # a tap outside [0, K) adding gLN-1's shift on dw_rows_f32 (the
    # depthwise stage at the dw_layout_ok widths), both in code B1's f32
    # stages share, which only the TP checks run here; and a tile's (sum y,
    # sum y^2) written into the next tile's slot
    "b6_f32_weight_lo_dropped": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tf32.cuh",
        "dst[hb + idx] = __uint_as_float(lo);",
        "dst[hb + idx] = 0.f * __uint_as_float(lo);"),
    "b6_f32_shift_on_out_of_range_taps": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tf32.cuh",
        "if (kk >= 0 && kk < K) tap(hv[u][q], kk, w[q], acc);",
        "if (kk >= 0 && kk < K) tap(hv[u][q], kk, w[q], acc); else for "
        "(int j = 0; j < 8; ++j) acc[j] = fmaf(w[q][j], sh[j], acc[j]);"),
    "b6_f32_sums_in_next_tile_slot": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tp.cu",
        "const size_t slot = static_cast<size_t>(m) * gridDim.x + blockIdx.x;",
        "const size_t slot = static_cast<size_t>(m) * gridDim.x + blockIdx.x "
        "+ 1;"),
    # the padding of widths off the tiles: B1's wgmma gLN-1 statistics
    # over the padded H in place of the block's own, the intra kernels'
    # appended frames left unmasked as keys, and the bf16 DPT LN's mean
    # over the padded B in place of the sublayer's own (ln_resident_tile:
    # LQ/F1, UG, B11)
    "tcn_gln_count_of_padded_h": ("padded",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "n_part_a,\n               static_cast<double>(K) * p.Hn, "
        "&s_st[0], &s_st[1]);",
        "n_part_a,\n               static_cast<double>(K) * H, "
        "&s_st[0], &s_st[1]);"),
    "intra_padded_frames_unmasked": ("padded",
        "convtasnet_tpu_torch/ops/cuda/dpt_attention.py",
        "torch.nn.functional.pad(key_bias, (0, Sp - S), value=NEG_INF))",
        "torch.nn.functional.pad(key_bias, (0, Sp - S), value=0.0))"),
    "dpt_ln_mean_over_padded_b": ("padded",
        "convtasnet_tpu_torch/csrc/dpt_bwd_common.cuh",
        "for (int u = 0; u < kLnRows; ++u) mean[u] = warp_sum(mean[u]) / Bn;",
        "for (int u = 0; u < kLnRows; ++u) mean[u] = warp_sum(mean[u]) / B;"),
    "tp_shard_sum_drops_w1": ("tp",
        "convtasnet_tpu_torch/parallel/tensor_parallel.py",
        "        y = tp_epilogue(y, z, stats_from_sums(sums2, n), w1, w0)",
        "        y = tp_epilogue(y, z, stats_from_sums(sums2, n), 0 * w1, w0)"),
    # dual-path tensor parallelism: the residual kept in a partial (f32)
    # attention forward, so the m shards' residuals are summed; the down
    # bias added once per shard; a contiguous column split of W_qkv in
    # place of the head-aligned one; g kept in a partial backward's dx
    "dpt_partial_keeps_residual": ("dpt_tp",
        "convtasnet_tpu_torch/csrc/dpt_common.cuh",
        "out[idx] = from_f<T>(p.partial ? proj : to_f<T>(x[idx]) + proj);",
        "out[idx] = from_f<T>(to_f<T>(x[idx]) + proj);"),
    "dpt_tp_b_down_per_shard": ("dpt_tp",
        "convtasnet_tpu_torch/parallel/dpt_tp.py",
        "    return (x3 + all_reduce(parts) + b_down.to(x.dtype))",
        "    return (x3 + all_reduce(parts) + len(parts) * b_down.to(x.dtype))"),
    "dpt_tp_qkv_contiguous_split": ("dpt_tp",
        "convtasnet_tpu_torch/parallel/dpt_tp.py",
        "[q[:, heads], k[:, heads], v[:, heads]], dim=1)",
        "[variables[pre + 'qkv.kernel'][:, 3 * heads.start:3 * heads.stop]],"
        " dim=1)"),
    "dpt_partial_bwd_keeps_g": ("dpt_tp",
        "convtasnet_tpu_torch/csrc/dpt_bwd_common.cuh",
        "P.dgb, !f.partial, stream);",
        "P.dgb, true, stream);"),
    # the routes past 16 taps (kind taps): E2' in bf16 (e2_wg_kernel's
    # kTapChunks) dropping d_dw of the taps past the sixteenth, and the
    # first design's cLN launch B (dwconv_cln_taps_kernel) taking a tap's
    # norm-1 statistics from the input row one dilation short of the row
    # it reads
    "taps_e2_wg_ddw_past_16_dropped": ("taps",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "        p.pch_e2[(tile * (P + 2) + q0 + u) * H + ch] = v;",
        "        p.pch_e2[(tile * (P + 2) + q0 + u) * H + ch] = q0 ? 0.f : v;"),
    # the f32 cLN block backward (B3) on the 3xTF32 stages
    # (tcn_block_bwd_tf32.cuh): E2' at P = 3 forming a tap's dc with the
    # reading row's statistics, G1' leaving t1 undivided by n, E2''s row
    # sums short of half their lanes, G2b' taking u2 for u1
    "f32_cln_bwd_e2_tap_stats_of_reading_row": ("cln_backward_f32",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_tf32.cuh",
        "dc4_row(c_o[q], e_o[q], s_st[(1 + q) * kWgRows + rl], dco,",
        "dc4_row(c_o[q], e_o[q], s_st[rl], dco,"),
    "f32_cln_bwd_g1_t1_undivided": ("cln_backward_f32",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_tf32.cuh",
        "sr[kT1] = static_cast<float>(static_cast<double>(q1) / p.Hn);",
        "sr[kT1] = q1;"),
    "f32_cln_bwd_e2_row_sum_half": ("cln_backward_f32",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_tf32.cuh",
        "      for (int o = 1; o < seg; o <<= 1) {",
        "      for (int o = 1; o < seg / 2; o <<= 1) {"),
    "f32_cln_bwd_g2b_u1_u2_swapped": ("cln_backward_f32",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_tf32.cuh",
        "s_rst[rl] = make_float4(sr[kMean1], sr[kRs1], sr[kU1], sr[kU2]);",
        "s_rst[rl] = make_float4(sr[kMean1], sr[kRs1], sr[kU2], sr[kU1]);"),
    "taps_cln_dwconv_stats_one_dilation_short": ("taps",
        "convtasnet_tpu_torch/csrc/tcn_block_common.cuh",
        "      const int q = q0 + t / kDwRows;\n"
        "      const int kk = r0 + (t % kDwRows) + q * d - p.left;\n"
        "      if (kk >= 0 && kk < K)\n"
        "        row_stats(p.part_a + 2 * (static_cast<size_t>(m) * K + kk)",
        "      const int q = q0 + t / kDwRows;\n"
        "      const int kk = r0 + (t % kDwRows) + q * d - p.left;\n"
        "      if (kk >= 0 && kk < K)\n"
        "        row_stats(p.part_a + 2 * (static_cast<size_t>(m) * K + "
        "(kk >= d ? kk - d : kk))"),
    # the DPT routes above 512 (kind wider): ln_bwd_wide_kernel's mean of
    # dy gamma over the padded B in place of the sublayer's own Bn, and
    # the f32 inter core (B7) dropping its last key tile where a pass
    # stages more than one (16 key chunks a load above Bq = 512)
    "wider_ln_bwd_mean_over_padded_b": ("wider",
        "convtasnet_tpu_torch/csrc/dpt_bwd_common.cuh",
        "      s2 += dxh * xh;\n    }\n"
        "    const float mean_d = warp_sum(s1) / Bn;",
        "      s2 += dxh * xh;\n    }\n"
        "    const float mean_d = warp_sum(s1) / B;"),
    # the DPT attention at head widths off the cores (kind head_widths):
    # the inter forward's softmax scale from the padded width D in place
    # of the heads' real d, and the route above 128 taking its padded keys
    # (score 0) into the softmax in place of NEG_INF
    "head_scale_from_padded_width": ("head_widths",
        "convtasnet_tpu_torch/csrc/dpt_attention.cu",
        "  const float scale = attn_scale(d);\n"
        "  auto core = [=](const DptAttnParams& q, cudaStream_t s) {",
        "  const float scale = attn_scale(p.Bq / p.h);\n"
        "  auto core = [=](const DptAttnParams& q, cudaStream_t s) {"),
    "wide_head_softmax_reads_padded_key": ("head_widths",
        "convtasnet_tpu_torch/csrc/dpt_attn_wide_head.cuh",
        "const float v = j < L ? s[j] * scale + rows.bias(bias, g, j) : "
        "-INFINITY;",
        "const float v = s[j] * scale + (j < L ? rows.bias(bias, g, j) : "
        "0.f);"),
    "wider_inter_core_last_key_tile_dropped": ("wider",
        "convtasnet_tpu_torch/csrc/dpt_attention.cu",
        "      float mx = -INFINITY, sum = 0.f;\n"
        "      for (int k0 = 0; k0 < n; k0 += key_tile) {",
        "      float mx = -INFINITY, sum = 0.f;\n"
        "      for (int k0 = 0; k0 == 0 || k0 + key_tile < n; "
        "k0 += key_tile) {"),
}
# The smoke phases a fault of each kind is run through; each phase runs
# whether or not an earlier one failed, and prints "PHASE <call>: passed"
# or "PHASE <call>: FAILED <reason>"; then the card tests that -k selects.
PHASES = {
    "block_forward": ["phase_kernel_vs_twin(torch, k['tcn'])",
                      "phase_kernel_vs_twin(torch, k['tcn'], 'cLN', True)",
                      "phase_step_compare(torch, 'tcn')"],
    "block_backward": ["phase_bwd_vs_twin(torch, bwd)",
                       "phase_step_compare(torch, 'tcn')"],
    "dpt_forward": ["phase_dpt_kernels_vs_twin(torch, dpt)",
                    "phase_dpt_forward(torch, dpt)"],
    "dpt_backward": ["phase_dpt_bwd_vs_twin(torch, dpt)",
                     "phase_ffn_bwd_tail_tiles(torch, dpt)",
                     "phase_step_compare(torch, 'dpt')",
                     "phase_dpt_head_widths(torch, dpt)"],
    "cln_backward": ["phase_bwd_vs_twin(torch, bwd, 'cLN')",
                     "phase_step_compare(torch, 'tcn', 'cLN')"],
    "cln_backward_f32": ["phase_tcn_f32_stages(torch, k)"],
    "pair": ["phase_pair_vs_twin(torch, k)",
             "phase_pair_bwd_vs_twin(torch, k)",
             "phase_step_compare(torch, 'tcn')"],
    "tp": ["phase_tp_stage2_vs_twin(torch, k)",
           "phase_tp_forward(torch, k)",
           "phase_step_compare(torch, 'tcn')"],
    "dpt_tp": ["phase_dpt_partial_vs_twin(torch, dpt)",
               "phase_dpt_tp_forward(torch, dpt)",
               "phase_step_compare(torch, 'dpt')"],
    "padded": ["phase_auto_padded(torch, k, dpt)"],
    "taps": ["phase_tcn_taps(torch, k)"],
    "wider": ["phase_dpt_wider_kernels(torch, dpt)"],
    "head_widths": ["phase_dpt_head_width_kernels(torch, dpt)"],
}
CARD_TESTS = {"block_forward": "kernel_matches_twin or model_kernel_path "
                               "or fused_block_ad or rounding_points",
              "block_backward": "bwd or fused_block_ad or train_grads or "
                                "wgmma",
              "dpt_forward": "dpt", "dpt_backward": "dpt or ffn_bwd",
              "cln_backward": "cln",
              "cln_backward_f32": "f32_stages_backward_cln",
              "pair": "pair", "tp": "tp_",
              "dpt_tp": "partial or dpt_tp",
              "padded": "untiled or check_shapes or auto_mode or padded",
              "taps": "taps", "wider": "wide",
              "head_widths": "head_width or zero_column_heads"}
RUNNER = """
import sys
import torch
import chip_smoke
from chip_smoke import *
from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra
from convtasnet_tpu_torch.ops.cuda import tcn_block_bwd as bwd
k = tcn_modules()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dpt = {'inter': dpt_attention, 'intra': dpt_intra, 'ffn': dpt_ffn}
failed = False
for call in sys.argv[1:]:
    try:
        eval(call)
        print(f"PHASE {call}: passed", flush=True)
    except AssertionError as e:
        failed = True
        print(f"PHASE {call}: FAILED {str(e)[:400]}", flush=True)
sys.exit(1 if failed else 0)
"""
COPIED = ("chip_smoke.py", "pyproject.toml", "tests/test_torch_cuda.py")


def plant(root: str, name: str) -> str:
    """A copy of the package and its checks with fault ``name`` planted."""
    _, path, old, new = FAULTS[name]
    d = os.path.join(root, name)
    shutil.copytree(os.path.join(REPO, "convtasnet_tpu_torch"),
                    os.path.join(d, "convtasnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    os.makedirs(os.path.join(d, "tests"))
    for f in COPIED:
        shutil.copy(os.path.join(REPO, f), os.path.join(d, f))
    with open(os.path.join(d, path)) as f:
        src = f.read()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the line to edit occurs {src.count(old)}"
                           f" times in {path}")
    with open(os.path.join(d, path), "w") as f:
        f.write(src.replace(old, new))
    return d


def run_fault(root: str, name: str, log_dir: str) -> list:
    """Plants fault ``name``, runs its kind's smoke phases and card tests
    against it, writes the full log and returns the lines to print."""
    d = plant(root, name)
    env = dict(os.environ, PYTHONPATH=d)
    kind = FAULTS[name][0]
    smoke = subprocess.run([sys.executable, "-c", RUNNER, *PHASES[kind]],
                           cwd=d, env=env, capture_output=True, text=True)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
         "tests/test_torch_cuda.py", "-q", "-k", CARD_TESTS[kind],
         "-p", "no:cacheprovider"], cwd=d, env=env,
        capture_output=True, text=True)
    with open(os.path.join(log_dir, f"{name}.log"), "w") as f:
        f.write(smoke.stdout + smoke.stderr + "\n=== card tests\n"
                + tests.stdout + tests.stderr)
    summary = (tests.stdout.strip().splitlines() or [""])[-1]
    caught = smoke.returncode != 0 or tests.returncode != 0
    lines = [f"== {name}: {'CAUGHT' if caught else 'not caught'}; "
             f"smoke phases rc={smoke.returncode}, card tests "
             f"rc={tests.returncode} ({summary})"]
    lines += ["    " + line for line in smoke.stdout.splitlines()
              if line.startswith("PHASE") or "dpt forward B" in line]
    lines += ["    " + line[:300] for line in smoke.stderr.splitlines()[-3:]]
    lines += ["    " + line[:200] for line in tests.stdout.splitlines()
              if line.startswith("FAILED")]
    shutil.rmtree(d, ignore_errors=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--only", nargs="*", choices=sorted(FAULTS))
    ap.add_argument("--jobs", type=int, default=1,
                    help="faults run at once on the one card (each builds "
                         "its own copy of the kernels)")
    a = ap.parse_args()
    log_dir = a.log_dir or tempfile.mkdtemp(prefix="faults_logs_")
    os.makedirs(log_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="faults_") as root, \
            concurrent.futures.ThreadPoolExecutor(a.jobs) as pool:
        runs = [pool.submit(run_fault, root, name, log_dir)
                for name in a.only or FAULTS]
        for run in runs:
            print("\n".join(run.result()), flush=True)
    print(f"logs in {log_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
