// One Conv-TasNet TCN block forward for Hopper (sm_90a), bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/tcn_block.py::_kernel (wrapper
// fused_tcn_block). The block is
//
//   h   = PReLU_a1(x @ W_in)                       x [M,K,B], W_in [B,H]
//   hn  = norm1(h)                                 gLN / cLN / BN
//   y   = PReLU_a2(depthwise_dilated_conv(hn))     dw [P,H], SAME or causal
//   out = x + norm2(y) @ W_out                     W_out [H,B]
//
// What bounds it on the card. At the paper shape (M=8 rows of 4 s, K=3199
// frames, B=256, H=512) the two products are 13.5 GFLOP per block (13.6 us
// at the bf16 tensor-core peak) and x, h, y and out are 13, 26, 26 and 13
// MB in bf16. The Pallas kernel kept one sample's whole [K,H] activation in
// VMEM (3.3 MB in bf16); an SM has at most 227 KB of shared memory, so that
// design does not carry over. gLN needs a statistic over the whole sample
// before the normalised values can be used, twice per block, so the block
// is split at those two points.
//
// bf16, the speed path (tcn_block_hopper.cuh, on hopper_gemm.cuh's wgmma
// core): prep + A' + B' + C', and y never reaches device memory, as in the
// Pallas kernel's gLN "recompute" variant:
//
//   prep (gLN, BN) W_eff = diag(g2) W_out in bf16 and partials of the
//      column sums g2 @ W_out (of W_eff as rounded) and b2 @ W_out (for BN
//      the running statistics folded in), once per call, over the whole
//      card (out_weights_wg_kernel).
//   A' h = PReLU(x @ W_in) in bf16 and norm1's partial sums. A CTA holds
//      128 rows of x resident and streams W_in past them for all H columns,
//      so x is read once.
//   B' (gLN only) norm1 inside the dilated depthwise conv (a tap outside
//      [0,K) contributes zero after normalisation, as zero padding of the
//      normalised input does) + PReLU -> the partial sums of y and y^2
//      only; y is not stored.
//   C' per 128-row tile: y recomputed from h rows [r0 - left, r0 + 128 +
//      right) into shared memory, rounded to bf16 there where the Pallas
//      kernel rounds it. gLN and BN (its emit_raw, y.astype(w_out.dtype)):
//      y as it is, then the output product with norm2 folded in:
//        out = x + rs*((y*g) @ W_out - mu*(g @ W_out)) + b @ W_out.
//      cLN (its emit_tile): C' holds whole rows of y, so it takes each
//      row's statistics as it computes the row and rounds the normalised
//      row, out = x + norm2(y) @ W_out, with no fold and no W_eff.
//
// Bytes: x twice, h written once and read twice (C' reads its halo rows
// through the 50 MB L2, which holds the whole 26 MB h), out once: ~117 MB
// against ~330 MB for the launches below. cLN has no B' and no prep, BN no
// B' (its statistics are folded).
//
// f32 keeps exact f32 products on the first design (tcn_block_common.cuh):
// prep + A + B + C on a 64x64 tile (FMA in f32, WMMA in bf16), y through
// device memory. bf16 runs it too at the widths the Hopper stages do not
// take (wg_widths_ok).
//
// Statistics are reduced deterministically: every tile writes its own
// partial and the next launch sums them in a fixed order (in double), so no
// atomics are used and a rerun gives the same bits. Each launch masks the
// ragged row edge itself; x is not padded.

#include "tcn_block_common.cuh"
#include "tcn_block_hopper.cuh"

// The first design's launches (launch_block_first) and Params are in
// tcn_block_common.cuh, because the f32 backward reruns them; the bf16
// stages (launch_block_wg) and the choice between the two designs
// (launch_block) are in tcn_block_hopper.cuh, because the bf16 backward
// reruns A' and the block pair (B4, B5) runs each of its blocks through
// launch_block.

namespace {

Params make_params(const void* x, const void* w_in, const void* dw,
                   const void* w_out, const void* a1, const void* a2,
                   const void* g1, const void* b1, const void* g2,
                   const void* b2, const void* m1, const void* v1,
                   const void* m2, const void* v2, void* h, void* y,
                   void* w_eff, void* wsum, void* part_a, void* part_b,
                   void* out, int M, int K, int B,
                   int H, int P, int dilation, int causal, int norm) {
  Params p;
  p.x = x;
  p.w_in = w_in;
  p.dw = dw;
  p.w_out = w_out;
  p.a1 = static_cast<const float*>(a1);
  p.a2 = static_cast<const float*>(a2);
  p.g1 = static_cast<const float*>(g1);
  p.b1 = static_cast<const float*>(b1);
  p.g2 = static_cast<const float*>(g2);
  p.b2 = static_cast<const float*>(b2);
  p.m1 = static_cast<const float*>(m1);
  p.v1 = static_cast<const float*>(v1);
  p.m2 = static_cast<const float*>(m2);
  p.v2 = static_cast<const float*>(v2);
  p.h = h;
  p.y = y;
  p.w_eff = w_eff;
  p.wsum = static_cast<float*>(wsum);
  p.part_a = static_cast<float*>(part_a);
  p.part_b = static_cast<float*>(part_b);
  p.out = out;
  p.M = M;
  p.K = K;
  p.B = B;
  p.H = H;
  p.P = P;
  p.dilation = dilation;
  p.left = causal ? (P - 1) * dilation : ((P - 1) * dilation) / 2;
  p.norm = norm;
  return p;
}

}  // namespace

#define CTN_BLOCK_ARGS                                                      \
  const void *x, const void *w_in, const void *dw, const void *w_out,      \
      const void *a1, const void *a2, const void *g1, const void *b1,      \
      const void *g2, const void *b2, const void *m1, const void *v1,      \
      const void *m2, const void *v2, void *h, void *y, void *w_eff,      \
      void *wsum, void *part_a, void *part_b, void *out, int M, int K,     \
      int B, int H, int P, int dilation, int causal, int norm, void *stream
#define CTN_BLOCK_CALL                                                      \
  make_params(x, w_in, dw, w_out, a1, a2, g1, b1, g2, b2, m1, v1, m2, v2, \
              h, y, w_eff, wsum, part_a, part_b, out, M, K, B, H, P,      \
              dilation, causal, norm),                                    \
      static_cast<cudaStream_t>(stream)

extern "C" {

const char* ctn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of (sum, sum of squares) partials launch A and launch B write per
// sample (gLN) or per row (cLN); 0 for BN. The caller allocates
// 2 * M * n_a (gLN) or 2 * M * K * n_a (cLN) floats, and likewise for n_b.
int ctn_tcn_block_partials(int K, int H, int norm, long long* n_a,
                           long long* n_b) {
  return part_counts(K, H, norm, n_a, n_b);
}

// 1 if the forward of a block of these widths (is_bf16: 1 for bf16, 0 for
// f32) keeps y in device memory, in the caller's buffer of M * K * H
// elements (the first design); 0 if it recomputes y and never touches the
// buffer (the Hopper stages: bf16 at wg_widths_ok).
int ctn_tcn_block_stores_y(int B, int H, int is_bf16) {
  return is_bf16 && wg_widths_ok(B, H) ? 0 : 1;
}

// Forward of one block; every pointer is device memory, `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launches.
int ctn_tcn_block_f32(CTN_BLOCK_ARGS) {
  return launch_block<float>(CTN_BLOCK_CALL);
}

int ctn_tcn_block_bf16(CTN_BLOCK_ARGS) {
  return launch_block<__nv_bfloat16>(CTN_BLOCK_CALL);
}

}  // extern "C"
