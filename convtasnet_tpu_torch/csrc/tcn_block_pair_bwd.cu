// Backward of two consecutive gLN TCN blocks (dilations d1, d2) for Hopper
// (sm_90a), bf16 or f32: kernel B5.
//
// Replaces convtasnet_tpu/ops/pallas/tcn_block_pair_bwd.py::_pair_bwd_kernel
// (wrapper fused_tcn_block_pair_bwd). From the pair input x0 alone (the only
// activation training saves per pair) and the cotangent g of the pair
// output it returns dx0 and both blocks' nine weight gradients:
//
//   x1 = x0 + block_1(x0);   out = x1 + block_2(x1)
//   dx1 = g + J_2(x1)^T g;   dx0 = dx1 + J_1(x0)^T dx1
//
// What bounds it on the card. At the paper shape (M=8, K=3199, B=256,
// H=512) the pair backward is 87.7 GFLOP: 13 products (block 1's input
// product twice, the x1 product, block 2's input product, five per block
// backward) and six depthwise passes, 89 us at the tensor-core rate. The
// Pallas kernel keeps x1, dx1 and four [K, H] activations of one sample in
// VMEM; an SM has 227 KB, so here, as in B2 (tcn_block_bwd.cu), every
// intermediate lives in device memory and every per-sample statistic or
// backward sum ends a launch. The passes:
//
//   T      W_in^T, W_out^T of both blocks;  P  W_eff1 (B1's prep launch).
//   A1 B1  block 1 forward as B1 runs it (post-activations): h1, y1.
//   C1A2   the pair forward's boundary launch (tcn_block_pair.cuh) with
//          kPre: x1 once to device memory, and block 2's pre-activation
//          x1 @ W_in2 with its norm1 partials. x1 is re-formed by the code
//          that formed it in the forward, on the same operands, so the
//          backward sees the forward's x1 bit for bit.
//   block 2's backward, B2's stages on (x1, g): R2 (its dwconv, kPre), F1,
//          F2, G1, F3, dW_out2, E1, E2, F4, G2a, dW_in2 = x1^T dh2, sums.
//   block 1 recomputed as B2 does (R1, R2 with kPre, F1, F2).
//   G2b2G1 one block per row tile of 64 rows and all B columns: dx1 = g +
//          dh2 @ W_in2^T, rounded, written once (block 1's cotangent and
//          residual) and kept in shared memory, then block 1's first
//          backward product e1 = dx1 @ W_out1^T and G1's epilogue from
//          there: dx1 is never read back for that product.
//   block 1's backward, B2's remaining stages on (x0, dx1): F3, dW_out1,
//          E1, E2, F4, G2a, G2b (dx0 = dx1 + dh1 @ W_in1^T), dW_in1, sums.
//
// Workspace. Block 1 is recomputed after block 2's backward rather than
// kept live beside it, so one set of B2's five [M, K, H] buffers (hp, c, e,
// hn2, dh) serves both blocks: 131 MB at the paper shape in bf16, plus x1
// and dx1 (13 MB each) and the f32 partials; the peak is B2's workspace
// plus 26 MB. The price is block 1's input product and dwconv run twice
// (once as the forward runs them, for x1; once keeping pre-activations,
// for its backward); that is the 13th product above.
//
// Every stage is B2's code on the same operands, the fused launch runs G2b's
// and G1's epilogues on the same GEMM tile, so dx0 and every gradient equal
// B1 + B2 + B2 chained bit for bit. Sums are taken in a fixed order in
// double without atomics; two calls give the same bits. P <= 16 (B2's tap
// limit), B and H multiples of 64. The products are B2's 64x64 WMMA tile,
// without cp.async/TMA or wgmma. On an H100 (700 W) a pair backward takes
// 3.03 ms against two B2 calls' 1.99 (PERF.md): block 1's forward runs once
// more than in chained B2 calls, and both fused launches run 400 blocks, 3
// per SM; pairs trade that time for the memory of one saved input per pair.

#include "tcn_block_bwd_common.cuh"
#include "tcn_block_pair.cuh"

namespace {

// dx1 = g + dh2 @ W_in2^T over a row tile, then block 1's G1 on it.
// Grid (ceil(K/kBM), 1, M).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    dx1_g1_kernel(BwdParams q2, BwdParams q1) {
  __shared__ GemmSmem<T> s;
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  T* dx1_s = reinterpret_cast<T*>(dyn_smem);
  const int ld = res_ld<T>(q2.B);
  const int m = blockIdx.z;
  const int bx = blockIdx.x;
  const int r0 = bx * kBM;
  const T* dh2 = static_cast<const T*>(q2.dh) + static_cast<size_t>(m) * q2.K * q2.H;
  for (int n0 = 0; n0 < q2.B; n0 += kBN) {
    gemm_tile<T>(dh2, static_cast<const T*>(q2.w_in_t), q2.K, q2.H, q2.B, r0,
                 n0, s);
    g2b_epilogue<T>(q2, s, m, r0, n0, dx1_s, ld);
    __syncthreads();   // s.c is read before the next product writes it
  }
  const int n_tiles = q1.H / kBN;
  for (int by = 0; by < n_tiles; ++by) {
    gemm_tile<T, true>(dx1_s, static_cast<const T*>(q1.w_out_t), 0, q1.B,
                       q1.H, 0, by * kBN, s, ld);
    g1_epilogue<T, kNormGLN>(q1, s, m, bx, by, gridDim.x, n_tiles);
  }
}

struct PairBwdLayout {
  int n_part, n_dw, n_chunks;
  size_t act[12];  // w_in_t, w_out_t (x2 blocks), w_eff1, hp, c, e, hn2,
                   // dh, x1, dx1
  size_t f32[9];   // stats, part, part2, pch_g1, pch_e1, pch_e2, pch_g2,
                   // wpart, wsum1
  size_t n_act, n_f32;
};

PairBwdLayout pair_bwd_layout(int M, int K, int B, int H, int P,
                              size_t act_bytes) {
  PairBwdLayout L;
  const size_t kt = row_tiles(K), rt = dw_row_tiles(K), ct = dw_col_tiles(H);
  const size_t n_r1 = kt * (H / kBN);
  L.n_dw = static_cast<int>(rt * ct);
  L.n_part = static_cast<int>(n_r1 > rt * ct ? n_r1 : rt * ct);
  const long long rows = static_cast<long long>(M) * K;
  L.n_chunks = static_cast<int>((rows + kChunkRows - 1) / kChunkRows);
  const size_t hb = static_cast<size_t>(H) * B;
  const size_t mkh = static_cast<size_t>(M) * K * H;
  const size_t mkb = static_cast<size_t>(M) * K * B;
  const size_t act[12] = {hb, hb, hb, hb, hb, mkh, mkh, mkh, mkh, mkh, mkb,
                          mkb};
  size_t off = 0;
  for (int i = 0; i < 12; ++i) {
    L.act[i] = off;
    off += align_up(act[i], 256 / act_bytes);
  }
  L.n_act = off;
  const size_t f32[9] = {
      static_cast<size_t>(M) * kNumStats,
      2 * static_cast<size_t>(M) * L.n_part,
      2 * static_cast<size_t>(M) * L.n_dw,
      2 * static_cast<size_t>(M) * kt * H,
      static_cast<size_t>(M) * rt * H,
      static_cast<size_t>(M) * rt * (P + 2) * H,
      static_cast<size_t>(M) * rt * H,
      static_cast<size_t>(L.n_chunks) * B * H,
      2 * static_cast<size_t>(B)};
  off = 0;
  for (int i = 0; i < 9; ++i) {
    L.f32[i] = off;
    off += align_up(f32[i], 64);
  }
  L.n_f32 = off;
  return L;
}

// One block's backward parameters on the pair's workspace: w[0..8] = w_in,
// dw, w_out, a1, a2, g1, b1, g2, b2 (compute dtype, then f32).
template <typename T>
BwdParams block_bwd_params(const void* const* w, const void* x, const void* g,
                           void* dx, void* dw_in, void* dw_out, void* aux,
                           void* w_in_t, void* w_out_t, T* act,
                           float* ws_f32, const PairBwdLayout& L, int M, int K,
                           int B, int H, int P, int dilation, int causal) {
  BwdParams p = {};
  p.x = x;
  p.g = g;
  p.w_in = w[0];
  p.dw = w[1];
  p.w_out = w[2];
  p.a1 = static_cast<const float*>(w[3]);
  p.a2 = static_cast<const float*>(w[4]);
  p.g1 = static_cast<const float*>(w[5]);
  p.b1 = static_cast<const float*>(w[6]);
  p.g2 = static_cast<const float*>(w[7]);
  p.b2 = static_cast<const float*>(w[8]);
  p.w_in_t = w_in_t;
  p.w_out_t = w_out_t;
  p.hp = act + L.act[5];
  p.c = act + L.act[6];
  p.e = act + L.act[7];
  p.hn2 = act + L.act[8];
  p.dh = act + L.act[9];
  p.stats = ws_f32 + L.f32[0];
  p.part = ws_f32 + L.f32[1];
  p.part2 = ws_f32 + L.f32[2];
  p.pch_g1 = ws_f32 + L.f32[3];
  p.pch_e1 = ws_f32 + L.f32[4];
  p.pch_e2 = ws_f32 + L.f32[5];
  p.pch_g2 = ws_f32 + L.f32[6];
  p.wpart = ws_f32 + L.f32[7];
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
  p.left = causal ? (P - 1) * dilation : ((P - 1) * dilation) / 2;
  return p;
}

// Forward Params of block 1 (A1, B1 and the boundary's first half) or of
// block 2 (the boundary's second half and its dwconv): launch A writes
// q.hp, launch B q.c, their partials go to q.part and q.part2.
Params forward_params(const BwdParams& q, const void* out, void* w_eff,
                      float* wsum) {
  Params p = {};
  p.x = q.x;
  p.w_in = q.w_in;
  p.dw = q.dw;
  p.w_out = q.w_out;
  p.a1 = q.a1;
  p.a2 = q.a2;
  p.g1 = q.g1;
  p.b1 = q.b1;
  p.g2 = q.g2;
  p.b2 = q.b2;
  p.h = q.hp;
  p.y = q.c;
  p.w_eff = w_eff;
  p.wsum = wsum;
  p.part_a = q.part;
  p.part_b = q.part2;
  p.out = const_cast<void*>(out);
  p.M = q.M;
  p.K = q.K;
  p.B = q.B;
  p.H = q.H;
  p.P = q.P;
  p.dilation = q.dilation;
  p.left = q.left;
  p.norm = kNormGLN;
  return p;
}

template <typename T>
int launch_pair_bwd(const void* x, const void* g, const void* const* wa,
                    const void* const* wb, void* ws_act, float* ws_f32,
                    void* dx, void* const* out_a, void* const* out_b, int M,
                    int K, int B, int H, int P, int d1, int d2, int causal,
                    cudaStream_t stream) {
  const PairBwdLayout L = pair_bwd_layout(M, K, B, H, P, sizeof(T));
  T* act = static_cast<T*>(ws_act);
  T* x1 = act + L.act[10];
  T* dx1 = act + L.act[11];
  // block 1: input x0, cotangent dx1, writes dx0; block 2: input x1,
  // cotangent g, writes dx1
  const BwdParams q1 = block_bwd_params<T>(
      wa, x, dx1, dx, out_a[0], out_a[1], out_a[2], act + L.act[0],
      act + L.act[1], act, ws_f32, L, M, K, B, H, P, d1, causal);
  const BwdParams q2 = block_bwd_params<T>(
      wb, x1, g, dx1, out_b[0], out_b[1], out_b[2], act + L.act[2],
      act + L.act[3], act, ws_f32, L, M, K, B, H, P, d2, causal);
  const Params p1 = forward_params(q1, x1, act + L.act[4], ws_f32 + L.f32[8]);
  const Params p2 = forward_params(q2, nullptr, nullptr, nullptr);
  const unsigned kt = row_tiles(K);
  const dim3 rows(dw_row_tiles(K), dw_col_tiles(H), M);
  const double count = static_cast<double>(K) * H;

  CTN_TRY(launch_transposes<T>(q1, stream));
  CTN_TRY(launch_transposes<T>(q2, stream));
  out_weights_kernel<T><<<(B + 31) / 32, dim3(32, kPrepRowGroups), 0,
                          stream>>>(p1, p1);
  CTN_CHECK();
  // block 1 as the forward runs it, then x1 and block 2's pre-activation
  in_proj_kernel<T, kNormGLN, false>
      <<<dim3(kt, H / kBN, M), kGemmThreads, 0, stream>>>(p1);
  CTN_CHECK();
  dwconv_kernel<T, kNormGLN, false><<<rows, kDwThreads, 0, stream>>>(
      p1, static_cast<int>(kt * (H / kBN)));
  CTN_CHECK();
  CTN_TRY(launch_boundary<T, kNormGLN, true>(p1, p2, L.n_dw, stream));
  // block 2's R2 and statistics (R1's partials came from the boundary)
  const int n_r1 = static_cast<int>(kt * (H / kBN));
  finalize_kernel<<<M, kDwThreads, 0, stream>>>(q2.part, n_r1, count,
                                                q2.stats, kMean1, 0);
  CTN_CHECK();
  dwconv_kernel<T, kNormGLN, true><<<rows, kDwThreads, 0, stream>>>(p2, n_r1);
  CTN_CHECK();
  finalize_kernel<<<M, kGemmThreads, 0, stream>>>(q2.part2, L.n_dw, count,
                                                  q2.stats, kMean2, 0);
  CTN_CHECK();
  // block 2's backward up to dh2; its weight gradients and sums
  g1_kernel<T, kNormGLN><<<dim3(kt, H / kBN, M), kGemmThreads, 0, stream>>>(q2);
  CTN_CHECK();
  CTN_TRY(block_bwd_middle<T, kNormGLN>(q2, L.n_chunks, stream));
  CTN_TRY(block_bwd_tail<T>(q2, L.n_chunks, stream));
  // block 1 recomputed for its backward; dx1 and block 1's G1 in one launch
  CTN_TRY(recompute_block<T, kNormGLN>(q1, stream));
  const size_t smem = boundary_smem<T>(B);
  cudaError_t err = cudaFuncSetAttribute(
      dx1_g1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dx1_g1_kernel<T><<<dim3(kt, 1, M), kGemmThreads, smem, stream>>>(q2, q1);
  CTN_CHECK();
  CTN_TRY(block_bwd_middle<T, kNormGLN>(q1, L.n_chunks, stream));
  g2b_kernel<T><<<dim3(kt, B / kBN, M), kGemmThreads, 0, stream>>>(q1);
  CTN_CHECK();
  return block_bwd_tail<T>(q1, L.n_chunks, stream);
}

}  // namespace

#define CTN_PAIR_BWD_ARGS                                                      \
  const void *x, const void *g, const void *w_in1, const void *dw1,           \
      const void *w_out1, const void *a1a, const void *a2a, const void *g1a,  \
      const void *b1a, const void *g2a, const void *b2a, const void *w_in2,   \
      const void *dw2, const void *w_out2, const void *a1b, const void *a2b,  \
      const void *g1b, const void *b1b, const void *g2b, const void *b2b,     \
      void *ws_act, void *ws_f32, void *dx, void *dw_in1, void *dw_out1,      \
      void *aux1, void *dw_in2, void *dw_out2, void *aux2, int M, int K,      \
      int B, int H, int P, int d1, int d2, int causal, void *stream
#define CTN_PAIR_BWD_CALL(T)                                                   \
  const void* wa[9] = {w_in1, dw1, w_out1, a1a, a2a, g1a, b1a, g2a, b2a};     \
  const void* wb[9] = {w_in2, dw2, w_out2, a1b, a2b, g1b, b1b, g2b, b2b};     \
  void* oa[3] = {dw_in1, dw_out1, aux1};                                      \
  void* ob[3] = {dw_in2, dw_out2, aux2};                                      \
  return launch_pair_bwd<T>(x, g, wa, wb, ws_act,                             \
                            static_cast<float*>(ws_f32), dx, oa, ob, M, K, B, \
                            H, P, d1, d2, causal,                             \
                            static_cast<cudaStream_t>(stream));

extern "C" {

// Workspace of the pair backward: n_act elements of the compute dtype
// (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats.
int ctn_tcn_block_pair_bwd_workspace(int M, int K, int B, int H, int P,
                                     int elem_bytes, long long* n_act,
                                     long long* n_f32) {
  const PairBwdLayout L = pair_bwd_layout(M, K, B, H, P, elem_bytes);
  *n_act = static_cast<long long>(L.n_act);
  *n_f32 = static_cast<long long>(L.n_f32);
  return 0;
}

// Backward of a gLN block pair; every pointer is device memory, `stream` is
// a cudaStream_t. x, g, the products' weights and dx are in the compute
// dtype; the slopes, norm affines and every gradient f32: per block dw_in
// [B,H], dw_out [H,B] and aux [(P+6)*H + 2] as B2's (tcn_block_bwd.cu).
// Returns the first CUDA error of its launches.
int ctn_tcn_block_pair_bwd_f32(CTN_PAIR_BWD_ARGS) {
  CTN_PAIR_BWD_CALL(float)
}

int ctn_tcn_block_pair_bwd_bf16(CTN_PAIR_BWD_ARGS) {
  CTN_PAIR_BWD_CALL(__nv_bfloat16)
}

}  // extern "C"
