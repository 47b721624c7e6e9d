// Two consecutive Conv-TasNet TCN blocks (dilations d1, d2) forward for
// Hopper (sm_90a), bf16 or f32, gLN or cLN: kernel B4.
//
// Replaces convtasnet_tpu/ops/pallas/tcn_block_pair.py::_kernel_pair
// (wrapper fused_tcn_block_pair). Each block is the single block of
// tcn_block.cu (B1):
//
//   x1  = x0 + block_1(x0)          rounded to the compute dtype
//   out = x1 + block_2(x1)
//
// What bounds it on the card. At the paper shape (M=8, K=3199, B=256,
// H=512) a pair is four products and two depthwise convs, 27.0 GFLOP, and
// each [K, H] intermediate is ~26 MB per round trip in bf16; the bound is
// the products at the tensor-core rate (27 us). The Pallas kernel keeps
// one sample's x1 ([K, B], 1.6 MB in bf16) and its [K, H] activation in
// VMEM through both blocks; an SM has 227 KB of shared memory, so here, as
// in B1, every statistic that spans a sample (gLN) or a row (cLN) ends a
// launch, and the pair fuses what it can: the block boundary. Six launches,
// against two B1 calls' eight:
//
//   P     W_eff = diag(g2) W_out and its column sums, for both blocks at
//         once (out_weights_kernel, grid.y 2);
//   A1    h1 = PReLU(x0 @ W_in1), norm1 partials   (B1's launch A);
//   B1    y1 = PReLU(dwconv(norm1(h1))), partials (B1's launch B);
//   C1A2  one block per row tile of 64 rows and all B columns
//         (tcn_block_pair.cuh): x1 = x0 + the folded y1 @ W_eff1, rounded,
//         written once for block 2's residual and kept in shared memory,
//         then h2 = PReLU(x1 @ W_in2) and its norm1 partials from there.
//         Block 2's launch A never reads x1 back: one [M, K, B] read and
//         one launch fewer;
//   B2    y2 (B1's launch B);
//   C2    out = x1 + the folded y2 @ W_eff2 (B1's launch C).
//
// Every launch runs B1's own code on the same operands in the same order,
// and C1A2's partials land in launch A's slots, so a pair's output equals
// two chained B1 calls bit for bit; x1 is the first call's output rounded
// to the compute dtype, as the twin holds it. C1A2's grid is M*K/64 blocks
// (400 at the paper shape), each with the 64 x 256 x1 tile in dynamic
// shared memory (33 KB in bf16, 65 KB in f32) beside the GEMM tile; rows at
// or beyond K are zero there and add nothing to any partial. Taps outside
// [0, K) are skipped, as in B1's launch B, so d2 = 2 d1 = 256 needs no halo
// rows. Statistics are summed in a fixed order without atomics, so two
// calls give the same bits. The products are B1's 64x64 WMMA tile without
// cp.async/TMA or wgmma. On an H100 (700 W) a pair takes 1.00 ms against
// two B1 calls' 0.79 (PERF.md): C1A2's 400 blocks of 62 KB of shared memory
// (bf16) fit 3 per SM, one wave and a 4-block tail, where B1's launches run
// thousands of one-tile blocks; the model runs pairs only when asked.
//
// Workspace: h and y [M, K, H] shared by both blocks (each is consumed
// before the next block overwrites it), x1 [M, K, B], both W_eff in the
// compute dtype; wsum and the two partial sets in f32.

#include "tcn_block_pair.cuh"

namespace {

struct PairLayout {
  size_t act[4];   // h, y, x1, w_eff (2 blocks)
  size_t f32[3];   // wsum (2 blocks), part_a, part_b
  size_t n_act, n_f32;
};

PairLayout pair_layout(int M, int K, int B, int H, size_t act_bytes,
                       int norm) {
  long long n_a = 0, n_b = 0;
  part_counts(K, H, norm, &n_a, &n_b);
  const size_t rows = norm == kNormCLN ? static_cast<size_t>(M) * K : M;
  const size_t mkh = static_cast<size_t>(M) * K * H;
  const size_t act[4] = {mkh, mkh, static_cast<size_t>(M) * K * B,
                         2 * static_cast<size_t>(H) * B};
  const size_t f32[3] = {4 * static_cast<size_t>(B), 2 * rows * n_a,
                         2 * rows * n_b};
  PairLayout L;
  size_t off = 0;
  for (int i = 0; i < 4; ++i) {
    L.act[i] = off;
    off += align_up(act[i], 256 / act_bytes);
  }
  L.n_act = off;
  off = 0;
  for (int i = 0; i < 3; ++i) {
    L.f32[i] = off;
    off += align_up(f32[i], 64);
  }
  L.n_f32 = off;
  return L;
}

template <typename T, int kNorm>
int launch_pair(Params p1, Params p2, cudaStream_t stream) {
  long long n_a = 0, n_b = 0;
  part_counts(p1.K, p1.H, kNorm, &n_a, &n_b);
  out_weights_kernel<T><<<dim3((p1.B + 31) / 32, 2), dim3(32, kPrepRowGroups),
                          0, stream>>>(p1, p2);
  CTN_CHECK();
  const unsigned kt = (p1.K + kBM - 1) / kBM;
  const unsigned rt = (p1.K + kDwRows - 1) / kDwRows;
  const unsigned ct = (p1.H + kDwThreads - 1) / kDwThreads;
  in_proj_kernel<T, kNorm, false>
      <<<dim3(kt, p1.H / kBN, p1.M), kGemmThreads, 0, stream>>>(p1);
  CTN_CHECK();
  dwconv_kernel<T, kNorm, false><<<dim3(rt, ct, p1.M), kDwThreads, 0, stream>>>(
      p1, static_cast<int>(n_a));
  CTN_CHECK();
  const int err = launch_boundary<T, kNorm, false>(p1, p2,
                                                   static_cast<int>(n_b), stream);
  if (err != 0) return err;
  dwconv_kernel<T, kNorm, false><<<dim3(rt, ct, p2.M), kDwThreads, 0, stream>>>(
      p2, static_cast<int>(n_a));
  CTN_CHECK();
  out_proj_kernel<T><<<dim3(kt, p2.B / kBN, p2.M), kGemmThreads, 0, stream>>>(
      p2, static_cast<int>(n_b));
  CTN_CHECK();
  return 0;
}

// One block's Params: its weights (w[0..8] = w_in, dw, w_out, a1, a2, g1,
// b1, g2, b2), its input x and output out, and the shared workspace.
Params block_params(const void* const* w, const void* x, void* out, void* h,
                    void* y, void* w_eff, float* wsum, float* part_a,
                    float* part_b, int M, int K, int B, int H, int P,
                    int dilation, int causal, int norm) {
  Params p = {};
  p.x = x;
  p.w_in = w[0];
  p.dw = w[1];
  p.w_out = w[2];
  p.a1 = static_cast<const float*>(w[3]);
  p.a2 = static_cast<const float*>(w[4]);
  p.g1 = static_cast<const float*>(w[5]);
  p.b1 = static_cast<const float*>(w[6]);
  p.g2 = static_cast<const float*>(w[7]);
  p.b2 = static_cast<const float*>(w[8]);
  p.h = h;
  p.y = y;
  p.w_eff = w_eff;
  p.wsum = wsum;
  p.part_a = part_a;
  p.part_b = part_b;
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

template <typename T>
int launch(const void* x, const void* const* wa, const void* const* wb,
           void* ws_act, float* ws_f32, void* out, int M, int K, int B, int H,
           int P, int d1, int d2, int causal, int norm, cudaStream_t stream) {
  const PairLayout L = pair_layout(M, K, B, H, sizeof(T), norm);
  T* act = static_cast<T*>(ws_act);
  T* h = act + L.act[0];
  T* y = act + L.act[1];
  T* x1 = act + L.act[2];
  T* w_eff = act + L.act[3];
  float* wsum = ws_f32 + L.f32[0];
  float* part_a = ws_f32 + L.f32[1];
  float* part_b = ws_f32 + L.f32[2];
  const size_t hb = static_cast<size_t>(H) * B;
  const Params p1 = block_params(wa, x, x1, h, y, w_eff, wsum, part_a, part_b,
                                 M, K, B, H, P, d1, causal, norm);
  const Params p2 = block_params(wb, x1, out, h, y, w_eff + hb, wsum + 2 * B,
                                 part_a, part_b, M, K, B, H, P, d2, causal,
                                 norm);
  switch (norm) {
    case kNormGLN:
      return launch_pair<T, kNormGLN>(p1, p2, stream);
    case kNormCLN:
      return launch_pair<T, kNormCLN>(p1, p2, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define CTN_PAIR_ARGS                                                          \
  const void *x, const void *w_in1, const void *dw1, const void *w_out1,      \
      const void *a1a, const void *a2a, const void *g1a, const void *b1a,     \
      const void *g2a, const void *b2a, const void *w_in2, const void *dw2,   \
      const void *w_out2, const void *a1b, const void *a2b, const void *g1b,  \
      const void *b1b, const void *g2b, const void *b2b, void *ws_act,        \
      void *ws_f32, void *out, int M, int K, int B, int H, int P, int d1,     \
      int d2, int causal, int norm, void *stream
#define CTN_PAIR_CALL                                                          \
  const void* wa[9] = {w_in1, dw1, w_out1, a1a, a2a, g1a, b1a, g2a, b2a};     \
  const void* wb[9] = {w_in2, dw2, w_out2, a1b, a2b, g1b, b1b, g2b, b2b};

extern "C" {

// Workspace of the pair for norm (0 gLN, 1 cLN): n_act elements of the
// compute dtype (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats.
int ctn_tcn_block_pair_workspace(int M, int K, int B, int H, int elem_bytes,
                                 int norm, long long* n_act,
                                 long long* n_f32) {
  const PairLayout L = pair_layout(M, K, B, H, elem_bytes, norm);
  *n_act = static_cast<long long>(L.n_act);
  *n_f32 = static_cast<long long>(L.n_f32);
  return 0;
}

// Forward of a block pair; every pointer is device memory, `stream` is a
// cudaStream_t. x, the products' weights (w_in, dw, w_out) and out are in
// the compute dtype; the slopes and norm affines f32. Returns the first
// CUDA error of its launches.
int ctn_tcn_block_pair_f32(CTN_PAIR_ARGS) {
  CTN_PAIR_CALL
  return launch<float>(x, wa, wb, ws_act, static_cast<float*>(ws_f32), out, M,
                       K, B, H, P, d1, d2, causal, norm,
                       static_cast<cudaStream_t>(stream));
}

int ctn_tcn_block_pair_bf16(CTN_PAIR_ARGS) {
  CTN_PAIR_CALL
  return launch<__nv_bfloat16>(x, wa, wb, ws_act, static_cast<float*>(ws_f32),
                               out, M, K, B, H, P, d1, d2, causal, norm,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
