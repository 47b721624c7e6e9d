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
// x^T dh_pre) are 33.5 GFLOP (34 us at the bf16 tensor-core peak), and the
// [K,H] intermediates are 26 MB each per pass in bf16. The Pallas kernels
// keep one sample's [K,H] activations in VMEM across their passes; an SM
// has 227 KB of shared memory, so here every intermediate that a later
// launch reads lives in device memory, and each norm statistic or backward
// reduction that spans a whole sample (gLN) or a whole row of H channels
// (cLN) ends a launch.
//
// bf16, the speed path: 15 launches, the five products on the Hopper core
// (hopper_gemm.cuh; the weights read through wgmma's transpose bits, so no
// transpose launch), every depthwise or elementwise pass 16 bytes per
// thread over 128-row tiles:
//
//   R1  hp = x @ W_in (pre-activation, kept: a slope may be <= 0, so PReLU
//       cannot be inverted), partials of norm1's sums: the forward's
//       launch A' with kPre (tcn_block_hopper.cuh).            | F1 stats
//   R2' c = dwconv(norm1(PReLU(hp))) (pre-activation), partials, by the
//       forward's depthwise walk (dw_rows).                     | F2 stats
//   G1' e = g @ W_out^T, g resident, W_out read K-major; its epilogue
//       (staged in shared memory, 16-byte rows) stores e and hn2 =
//       norm2(PReLU(c)) for dW_out, partials of t1 = sum g2*e, t2 = sum
//       g2*e*hhat2, per-channel dg2, db2.                       | F3
//   W'  dW_out = hn2^T @ g on the core (both operands MN-major), split over
//       chunks of kChunkRows rows, the chunks added in a fixed order.
//   E2' the transposed dilated conv dhn1[j] = sum_p dw[p] * dc[j - p*d +
//       left] (taps outside [0,K) dropped), with E1 folded in: dc =
//       rs2*(g2*e - t1/n - hhat2*t2/n) * PReLU'(c) is formed, rounded as
//       E1 stored it, at each row it is read (three recomputes per row at
//       P=3, and no pass); per-channel d_dw[p] = sum dc[k]*hn1[k + p*d -
//       left], dg1, db1, da2; partials of u1 = sum g1*dhn1, u2 = sum
//       g1*dhn1*hhat1.                                          | F4
//   G2b' G2a folded in: its prologue forms dh_pre = rs1*(g1*dhn1 - u1/n -
//       hhat1*u2/n) * PReLU'(hp) as the resident left operand (and over
//       dhn1 in device memory, once, for dW_in), with per-channel da1; the
//       product reads W_in K-major; dx = g + dh_pre @ W_in^T.
//   W'  dW_in = x^T @ dh_pre as dW_out.
//   S   per-channel partials summed in a fixed order, then da1, da2.
//
// f32 at the same widths, gLN (B2) and cLN (B3), runs these stages
// rebuilt on the 3xTF32 product core (tcn_block_bwd_tf32.cuh,
// hopper_gemm_tf32.cuh: its wgmma for R1, G1' and G2b', mma.sync for W'),
// gLN 16 launches, cLN 14 (R1 writes each row's norm1 statistics and G1'
// its t1, t2, so their finalisers go): the weights written by a prep
// launch as K-major tf32 hi and lo copies (tf32 wgmma has no transpose
// bit), every operand streamed by TMA (no f32 tile of 128 rows fits beside
// the ring), dh_pre formed by G2b''s prologue into device memory.
// Registers are in that file's note.
//
// The first design's launches (tcn_block_bwd_common.cuh: a 64x64 FMA
// tile, transposes T, E1 and G2a passes of their own; gLN 19, cLN 20) run
// f32 at the other widths; bf16 runs them (on WMMA) at the widths the
// Hopper stages do not take (wg_widths_ok).
//
// Any number of taps P: E2 (e2_kernel) and E2' at P != 3 (e2_wg_kernel)
// hold d_dw (and E2' the taps' weights and rows) in per-thread arrays of
// kMaxTaps = 16 taps; at P > 16 they run beside that code
// (kTapChunks): one walk over the rows forms dhn1, dg1, db1, da2 and the
// norm1 sums over all P taps in order, and d_dw follows in chunks of 16
// taps, each a walk over the same rows in the same order, so every sum is
// formed in the order it is at P <= 16. The launches per call do not
// change.
//
// gLN and cLN differ only in what a statistic spans. gLN: the sums of F1-F4
// run over a sample's K*H elements (n = K*H), one (mean, rs, t1, t2, u1,
// u2) per sample. cLN: they run over one row's H channels (n = H), one set
// per row: each launch writes per-row partials (per column tile, or per
// segment of the lanes that share a row), and a row-finalize launch
// (finalize_rows_kernel) adds a row's partials in a fixed order into
// [M*K, kNumStats] per-row statistics that the next launches read, by the
// forward's row rule (row_stats). The causal halo needs no fill: a tap
// outside [0,K) is skipped, so no statistic of a row outside the sample is
// ever read.
//
// As in the forward, nothing is summed with atomics: every tile writes its
// partial and a later launch adds them in a fixed order (in double), so two
// runs give the same bits. The statistics are the forward's, taken over
// the f32 PReLU outputs before rounding; the later passes normalise the
// stored bf16 values with them. Rows at or beyond K add nothing to any sum.
//
// The first design's launches live in tcn_block_bwd_common.cuh; the bf16
// stages, the workspace layout (one for both designs) and launch_block_bwd,
// which picks the design, in tcn_block_bwd_hopper.cuh, because the gLN pair
// backward (B5, tcn_block_pair_bwd.cu) runs each of its blocks through it.
// This file keeps the C interface.

#include "tcn_block_bwd_hopper.cuh"

namespace {

template <typename T, int kNorm>
int launch_bwd(BwdParams p, void* ws_act, float* ws_f32, int causal,
               cudaStream_t stream) {
  static_assert(kNorm == kNormGLN || kNorm == kNormCLN, "gLN or cLN");
  bind_bwd_workspace<T>(&p, bwd_layout(p.M, p.K, p.B, p.H, p.P, sizeof(T),
                                       kNorm),
                        ws_act, ws_f32);
  p.left = causal ? (p.P - 1) * p.dilation : ((p.P - 1) * p.dilation) / 2;
  return launch_block_bwd<T, kNorm>(p, stream);
}

BwdParams make_bwd_params(const void* x, const void* g, const void* w_in,
                          const void* dw, const void* w_out, const void* a1,
                          const void* a2, const void* g1, const void* b1,
                          const void* g2, const void* b2, void* dx,
                          void* dw_in, void* dw_out, void* aux, int M, int K,
                          int B, int H, int Hn, int P, int dilation) {
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
  p.Hn = Hn;
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
      int K, int B, int H, int Hn, int P, int dilation, int causal,         \
      void *stream
#define CTN_BWD_CALL                                                       \
  make_bwd_params(x, g, w_in, dw, w_out, a1, a2, g1, b1, g2, b2, dx, dw_in, \
                  dw_out, aux, M, K, B, H, Hn, P, dilation),              \
      ws_act, static_cast<float*>(ws_f32), causal,                        \
      static_cast<cudaStream_t>(stream)

extern "C" {

// Workspace the backward needs for norm (0 gLN, 1 cLN): n_act elements of
// the compute dtype (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats.
int ctn_tcn_block_bwd_workspace(int M, int K, int B, int H, int P,
                                int elem_bytes, int norm, long long* n_act,
                                long long* n_f32) {
  const BwdLayout L = bwd_layout(M, K, B, H, P, elem_bytes, norm);
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
