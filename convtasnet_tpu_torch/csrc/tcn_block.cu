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
// frames, B=256, H=512) the two products are about 13 GFLOP per block, and
// the [K,H] intermediates h and y are about 26 MB each per round trip in bf16.
// The Pallas kernel kept one sample's whole [K,H] activation in VMEM (3.3 MB
// in bf16); an SM has at most 227 KB of shared memory, so that design does
// not carry over. gLN needs a statistic over the whole sample before the
// normalised values can be used, twice per block, so the block is split at
// those two points into three launches, each over a grid of
// (row tile, column tile, sample):
//
//   A  h = PReLU(x @ W_in) -> h in the compute dtype, plus per-tile partial
//      sums of h and h^2 in f32 (per tile for gLN, per row for cLN).
//   B  reduce A's partials to the statistics of norm1, apply norm1 inside the
//      dilated depthwise conv (a tap outside [0,K) contributes zero after
//      normalisation, as zero padding of the normalised input does), PReLU
//      -> y, plus partial sums of y and y^2.
//   C  reduce B's partials and fold norm2 into the output product:
//        out = x + rs*((y*g) @ W_out - mu*(g @ W_out)) + b @ W_out
//      with g, b the per-channel scale and shift of norm2 (for BN the running
//      statistics are folded into them and mu=0, rs=1). The sample-free part
//      of that fold, W_eff = diag(g) W_out in the compute dtype and the
//      column sums g @ W_out (of W_eff as rounded) and b @ W_out, is made
//      once per call by a small launch before A, so C's product reads W_eff
//      as it is.
//
// Statistics are reduced deterministically: every tile writes its own
// partial and the next launch sums them in a fixed order (in double), so no
// atomics are used and a rerun gives the same bits. Each launch masks the
// ragged row edge itself; x is not padded.
//
// The products are a plain tiled shared-memory GEMM (64x64 output tile,
// depth 32, 4 warps; tcn_block_common.cuh): WMMA bf16 tensor-core fragments
// with f32 accumulation for bf16, FMA for f32. It is written for correctness
// first: there is no cp.async/TMA pipelining and no wgmma yet, so the
// products run well below the card's tensor-core rate; A and C also re-read
// x (or y) once per column tile. Those are the next steps when this kernel
// is made fast.

#include "tcn_block_common.cuh"

// The prep launch and launches A, B and C (out_weights_kernel,
// in_proj_kernel, dwconv_kernel, out_proj_kernel) and Params are in the
// header, because the backward and the block pair (tcn_block_pair.cu) rerun
// them.

namespace {

template <typename T, int kNorm>
int launch_norm(const Params& p, cudaStream_t stream) {
  long long n_a = 0, n_b = 0;
  part_counts(p.K, p.H, kNorm, &n_a, &n_b);
  out_weights_kernel<T><<<(p.B + 31) / 32, dim3(32, kPrepRowGroups), 0,
                          stream>>>(p, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned kt = (p.K + kBM - 1) / kBM;
  in_proj_kernel<T, kNorm, false>
      <<<dim3(kt, p.H / kBN, p.M), kGemmThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned rt = (p.K + kDwRows - 1) / kDwRows;
  const unsigned ct = (p.H + kDwThreads - 1) / kDwThreads;
  dwconv_kernel<T, kNorm, false><<<dim3(rt, ct, p.M), kDwThreads, 0, stream>>>(
      p, static_cast<int>(n_a));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  out_proj_kernel<T><<<dim3(kt, p.B / kBN, p.M), kGemmThreads, 0, stream>>>(
      p, static_cast<int>(n_b));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  switch (p.norm) {
    case kNormGLN:
      return launch_norm<T, kNormGLN>(p, stream);
    case kNormCLN:
      return launch_norm<T, kNormCLN>(p, stream);
    case kNormBN:
      return launch_norm<T, kNormBN>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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

// Forward of one block; every pointer is device memory, `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launches.
int ctn_tcn_block_f32(CTN_BLOCK_ARGS) {
  return launch<float>(CTN_BLOCK_CALL);
}

int ctn_tcn_block_bf16(CTN_BLOCK_ARGS) {
  return launch<__nv_bfloat16>(CTN_BLOCK_CALL);
}

}  // extern "C"
