// Backward of one Conv-TasNet TCN block with gLN (kernel B2) or cLN (kernel
// B3), for Hopper (sm_90a), bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/tcn_block_bwd.py::_bwd_kernel (gLN) and
// ::_bwd_kernel_cln (cLN), both behind fused_tcn_block_bwd. From the block
// input x and the cotangent g of the block output it returns dx and every
// weight gradient, recomputing the forward's intermediates from x (only x is
// saved, as jax.checkpoint does):
//
//   hp = x @ W_in;  h1 = PReLU_a1(hp);  hn1 = norm1(h1)
//   c  = depthwise_dilated_conv(hn1);   h2 = PReLU_a2(c);  hn2 = norm2(h2)
//   out = x + hn2 @ W_out
//
// What bounds it on the card. At the paper shape (M=8, K=3199, B=256,
// H=512) the five products (x W_in, g W_out^T, hn2^T g, dh_pre W_in^T,
// x^T dh_pre) are ~33 GFLOP, and the [K,H] intermediates are ~26 MB each
// per pass in bf16. The Pallas kernels keep one sample's [K,H] activations
// in VMEM across their passes; an SM has 227 KB of shared memory, so here
// every intermediate lives in device memory and each norm statistic or
// backward reduction that spans a whole sample (gLN) or a whole row of H
// channels (cLN) ends a launch:
//
//   T   W_in^T and W_out^T in the compute dtype (the GEMM tile reads its B
//       operand row-major), once per call.
//   R1  hp = x @ W_in (pre-activation, kept: a slope may be <= 0, so
//       PReLU cannot be inverted), partials of norm1's sums.     | F1 stats
//   R2  c = dwconv(norm1(PReLU(hp))) (pre-activation), partials. | F2 stats
//       R1 and R2 are the forward's launches A and B
//       (tcn_block_common.cuh) with kPre set, so the statistics follow the
//       forward's rule.
//   G1  e = g @ W_out^T; hn2 = norm2(PReLU(c)) for dW_out; partials of
//       t1 = sum g2*e, t2 = sum g2*e*hhat2; per-channel dg2, db2. | F3
//   E1  dc = rs2*(g2*e - t1/n - hhat2*t2/n) * PReLU'(c) over e in place;
//       per-channel da2 partials of dh2*min(c,0).
//   E2  dhn1[j] = sum_p dw[p] * dc[j - p*d + left] (taps outside [0,K)
//       dropped); per-channel d_dw[p] = sum dc[k]*hn1[k + p*d - left],
//       dg1, db1; partials of u1 = sum g1*dhn1, u2 = sum g1*dhn1*hhat1. | F4
//   G2  dh_pre = rs1*(g1*dhn1 - u1/n - hhat1*u2/n) * PReLU'(hp) over dhn1
//       in place; per-channel da1 partials; then dx = g + dh_pre @ W_in^T.
//   W   dW_out = hn2^T @ g and dW_in = x^T @ dh_pre over all M*K rows:
//       each block sums one chunk of kChunkRows rows into an f32 partial
//       tile, and a second launch adds the chunks in a fixed order.
//   S   per-channel partials summed in a fixed order, then da1, da2.
//
// gLN and cLN differ only in what a statistic spans, so every launch is a
// template on the norm. gLN: the sums of F1-F4 run over a sample's K*H
// elements (n = K*H), one (mean, rs, t1, t2, u1, u2) per sample. cLN: they
// run over one row's H channels (n = H), one set per row. A block of the
// GEMM launches sees 64 channels of a row and one of the depthwise launches
// 256, so each writes per-row partials per column tile (warp sums, added
// across the block's warps in a fixed order), and a row-finalize launch
// (finalize_rows_kernel) adds a row's partials in a fixed order into
// [M*K, kNumStats] per-row statistics that the next launches read. F1 and
// F2 take B1's row rule (row_stats: E[h^2]-mean^2 in double over its
// partials, rsqrt in f32, eps 1e-8) on the very partials B1 writes, so B1
// and B3 share their cLN statistics bit for bit. The causal halo needs no
// fill: a tap outside [0,K) is skipped, as in B1's launch B, so no
// statistic of a row outside the sample is ever read.
//
// As in the forward, nothing is summed with atomics: every tile writes its
// partial and a later launch adds them in a fixed order (in double), so two
// runs give the same bits. The statistics are the forward's, taken over
// the f32 PReLU outputs before rounding; the later passes normalise the
// stored compute-dtype values with them, as the forward's launches B and C
// do. Rows at or beyond K add nothing to any sum. The products are the
// shared tile of tcn_block_common.cuh plus a transposed-A variant for the
// weight gradients; no cp.async/TMA or wgmma yet, which is where speed would
// come from.
//
// The launches and the stages that string them together live in
// tcn_block_bwd_common.cuh, which the gLN pair backward (B5,
// tcn_block_pair_bwd.cu) runs for each of its blocks; this file keeps the
// workspace layout and the C interface.

#include "tcn_block_bwd_common.cuh"

namespace {

// Workspace layout, shared by the size query and the launch. Every
// segment starts on a 256-byte boundary.
struct Layout {
  int kt, rt, ct, n_part, n_chunks;
  size_t act[7];   // w_in_t, w_out_t, hp, c, e, hn2, dh (elements)
  size_t f32[8];   // stats, part, part2, pch_g1, pch_e1, pch_e2, pch_g2,
                   // wpart
  size_t n_act, n_f32;
};

Layout make_layout(int M, int K, int B, int H, int P, size_t act_bytes,
                   int norm) {
  Layout L;
  L.kt = (K + kBM - 1) / kBM;
  L.rt = (K + kDwRows - 1) / kDwRows;
  L.ct = (H + kDwThreads - 1) / kDwThreads;
  const long long rows = static_cast<long long>(M) * K;
  // partials per sample (gLN: one per tile) or per row (cLN: one per
  // column tile); part holds R1's, G1's and E2's, part2 R2's
  const bool cln = norm == kNormCLN;
  const size_t n_r1 = cln ? H / kBN : static_cast<size_t>(L.kt) * (H / kBN);
  const size_t n_dw = cln ? L.ct : static_cast<size_t>(L.rt) * L.ct;
  const size_t n_rows = cln ? static_cast<size_t>(rows) : M;
  L.n_part = static_cast<int>(n_r1 > n_dw ? n_r1 : n_dw);
  L.n_chunks = static_cast<int>((rows + kChunkRows - 1) / kChunkRows);
  const size_t mkh = static_cast<size_t>(M) * K * H;
  const size_t act_sizes[7] = {static_cast<size_t>(H) * B,
                               static_cast<size_t>(B) * H, mkh, mkh, mkh, mkh,
                               mkh};
  const size_t a_al = 256 / act_bytes;
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    L.act[i] = off;
    off += align_up(act_sizes[i], a_al);
  }
  L.n_act = off;
  const size_t f32_sizes[8] = {
      n_rows * kNumStats,
      2 * n_rows * L.n_part,
      2 * n_rows * n_dw,
      2 * static_cast<size_t>(M) * L.kt * H,
      static_cast<size_t>(M) * L.rt * H,
      static_cast<size_t>(M) * L.rt * (P + 2) * H,
      static_cast<size_t>(M) * L.rt * H,
      static_cast<size_t>(L.n_chunks) * B * H};
  off = 0;
  for (int i = 0; i < 8; ++i) {
    L.f32[i] = off;
    off += align_up(f32_sizes[i], 64);
  }
  L.n_f32 = off;
  return L;
}

template <typename T, int kNorm>
int launch_bwd(BwdParams p, void* ws_act, float* ws_f32, int causal,
               cudaStream_t stream) {
  static_assert(kNorm == kNormGLN || kNorm == kNormCLN, "gLN or cLN");
  const Layout L = make_layout(p.M, p.K, p.B, p.H, p.P, sizeof(T), kNorm);
  T* act = static_cast<T*>(ws_act);
  p.w_in_t = act + L.act[0];
  p.w_out_t = act + L.act[1];
  p.hp = act + L.act[2];
  p.c = act + L.act[3];
  p.e = act + L.act[4];
  p.hn2 = act + L.act[5];
  p.dh = act + L.act[6];
  p.stats = ws_f32 + L.f32[0];
  p.part = ws_f32 + L.f32[1];
  p.part2 = ws_f32 + L.f32[2];
  p.pch_g1 = ws_f32 + L.f32[3];
  p.pch_e1 = ws_f32 + L.f32[4];
  p.pch_e2 = ws_f32 + L.f32[5];
  p.pch_g2 = ws_f32 + L.f32[6];
  p.wpart = ws_f32 + L.f32[7];
  p.left = causal ? (p.P - 1) * p.dilation : ((p.P - 1) * p.dilation) / 2;
  const int M = p.M, K = p.K, B = p.B, H = p.H;

  CTN_TRY(launch_transposes<T>(p, stream));
  CTN_TRY(recompute_block<T, kNorm>(p, stream));
  g1_kernel<T, kNorm><<<dim3(L.kt, H / kBN, M), kGemmThreads, 0, stream>>>(p);
  CTN_CHECK();
  CTN_TRY(block_bwd_middle<T, kNorm>(p, L.n_chunks, stream));
  g2b_kernel<T><<<dim3(L.kt, B / kBN, M), kGemmThreads, 0, stream>>>(p);
  CTN_CHECK();
  return block_bwd_tail<T>(p, L.n_chunks, stream);
}

BwdParams make_bwd_params(const void* x, const void* g, const void* w_in,
                          const void* dw, const void* w_out, const void* a1,
                          const void* a2, const void* g1, const void* b1,
                          const void* g2, const void* b2, void* dx,
                          void* dw_in, void* dw_out, void* aux, int M, int K,
                          int B, int H, int P, int dilation) {
  BwdParams p = {};
  p.x = x;
  p.g = g;
  p.w_in = w_in;
  p.dw = dw;
  p.w_out = w_out;
  p.a1 = static_cast<const float*>(a1);
  p.a2 = static_cast<const float*>(a2);
  p.g1 = static_cast<const float*>(g1);
  p.b1 = static_cast<const float*>(b1);
  p.g2 = static_cast<const float*>(g2);
  p.b2 = static_cast<const float*>(b2);
  p.dx = dx;
  p.dw_in = static_cast<float*>(dw_in);
  p.dw_out = static_cast<float*>(dw_out);
  p.aux = static_cast<float*>(aux);
  p.M = M;
  p.K = K;
  p.B = B;
  p.H = H;
  p.P = P;
  p.dilation = dilation;
  return p;
}

}  // namespace

#define CTN_BWD_ARGS                                                        \
  const void *x, const void *g, const void *w_in, const void *dw,          \
      const void *w_out, const void *a1, const void *a2, const void *g1,   \
      const void *b1, const void *g2, const void *b2, void *ws_act,        \
      void *ws_f32, void *dx, void *dw_in, void *dw_out, void *aux, int M, \
      int K, int B, int H, int P, int dilation, int causal, void *stream
#define CTN_BWD_CALL                                                       \
  make_bwd_params(x, g, w_in, dw, w_out, a1, a2, g1, b1, g2, b2, dx, dw_in, \
                  dw_out, aux, M, K, B, H, P, dilation),                  \
      ws_act, static_cast<float*>(ws_f32), causal,                        \
      static_cast<cudaStream_t>(stream)

extern "C" {

// Workspace the backward needs for norm (0 gLN, 1 cLN): n_act elements of
// the compute dtype (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats.
int ctn_tcn_block_bwd_workspace(int M, int K, int B, int H, int P,
                                int elem_bytes, int norm, long long* n_act,
                                long long* n_f32) {
  const Layout L = make_layout(M, K, B, H, P, elem_bytes, norm);
  *n_act = static_cast<long long>(L.n_act);
  *n_f32 = static_cast<long long>(L.n_f32);
  return 0;
}

// Backward of one gLN block (B2, ctn_tcn_block_bwd_*) or cLN block (B3,
// ctn_tcn_block_bwd_cln_*); every pointer is device memory, `stream` is a
// cudaStream_t. x, g, w_in, dw, w_out and dx are in the compute dtype; the
// slopes, norm affines and every other output are f32: dw_in [B,H],
// dw_out [H,B], and aux [(P+6)*H + 2] = d_dw [P,H], dg1, db1, dg2, db2,
// per-channel da1 and da2 parts [H] each, then da1 and da2. Returns
// cudaGetLastError() after the launches.
int ctn_tcn_block_bwd_f32(CTN_BWD_ARGS) {
  return launch_bwd<float, kNormGLN>(CTN_BWD_CALL);
}

int ctn_tcn_block_bwd_bf16(CTN_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16, kNormGLN>(CTN_BWD_CALL);
}

int ctn_tcn_block_bwd_cln_f32(CTN_BWD_ARGS) {
  return launch_bwd<float, kNormCLN>(CTN_BWD_CALL);
}

int ctn_tcn_block_bwd_cln_bf16(CTN_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16, kNormCLN>(CTN_BWD_CALL);
}

}  // extern "C"
