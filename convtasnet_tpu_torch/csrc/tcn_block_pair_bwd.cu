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
// H=512) the pair backward is 87.7 GFLOP as the Pallas kernel's cost
// estimate counts it (13 products of 2 M K B H and six depthwise passes):
// 89 us at the tensor-core rate. The Pallas kernel keeps x1, dx1 and four
// [K, H] activations of one sample in VMEM; an SM has 227 KB, so here, as
// in B2 (tcn_block_bwd.cu), every intermediate lives in device memory and
// every per-sample statistic or backward sum ends a launch, and a pair
// backward costs what B1 + B2 + B2 cost, held by B2's E2', G2b', G1' and
// the forward's C' (PERF.md). The first design of this kernel (40
// launches on a 64x64 WMMA tile, block 1's input product run twice, two
// fused launches of 400 CTAs at 3 per SM) took 3.06 ms in bf16 on an H100
// (700 W), against 0.96 for B1 + 2 x B2.
//
// So the pair runs the chained single blocks' launches in their order, each
// in the design of its dtype and widths (bf16 at wg_widths_ok: B1's four
// and B2's 15 bf16 stages; f32 and the other bf16 widths: the first
// design's), on one workspace:
//
//   x1 = B1(x0)                       launch_block (tcn_block_hopper.cuh)
//   dx1, block 2's gradients = B2(x1, g)     launch_block_bwd
//   dx0, block 1's gradients = B2(x0, dx1)   (tcn_block_bwd_hopper.cuh)
//
// and equals them bit for bit in either dtype: 34 launches in bf16 (4 + 15
// + 15). Tried in bf16 and taken out, as not worth their code: A' of block
// 1's forward storing the pre-activation beside h, so that block 1's
// backward skips its R1 (33 launches, 0.94 ms against 0.96, for a 26 MB
// buffer live through block 2's backward, and saving memory is what pairs
// are for); C' of block 1 and R1 of block 2 in one launch (the same bits,
// 129 us against 79 + 45; PERF.md).
//
// Sums are taken in a fixed order in double without atomics; two calls
// give the same bits.
//
// Workspace: one block backward's (tcn_block_bwd_hopper.cuh, bwd_layout),
// which block 2's backward and then block 1's use, and whose hp and c the
// forward's h and y (the first design only) borrow first; x1 and dx1
// [M, K, B]; the forward's W_eff, column sums and partials.

#include "tcn_block_bwd_hopper.cuh"

namespace {

struct PairBwdLayout {
  BwdLayout bwd;   // at the start of both workspaces
  size_t act[3];   // x1, dx1, w_eff
  size_t f32[3];   // wsum, part_a, part_b of block 1's forward
  size_t n_act, n_f32;
};

PairBwdLayout pair_bwd_layout(int M, int K, int B, int H, int P,
                              size_t act_bytes) {
  PairBwdLayout L;
  L.bwd = bwd_layout(M, K, B, H, P, act_bytes, kNormGLN);
  long long n_a = 0, n_b = 0;
  part_counts(K, H, kNormGLN, &n_a, &n_b);
  const size_t mkb = static_cast<size_t>(M) * K * B;
  const size_t act[3] = {mkb, mkb, static_cast<size_t>(H) * B};
  const size_t f32[3] = {wsum_size(B, H, runs_wg(B, H, act_bytes)),
                         2 * static_cast<size_t>(M) * n_a,
                         2 * static_cast<size_t>(M) * n_b};
  size_t off = L.bwd.n_act;
  for (int i = 0; i < 3; ++i) {
    L.act[i] = off;
    off += align_up(act[i], 256 / act_bytes);
  }
  L.n_act = off;
  off = L.bwd.n_f32;
  for (int i = 0; i < 3; ++i) {
    L.f32[i] = off;
    off += align_up(f32[i], 64);
  }
  L.n_f32 = off;
  return L;
}

// One block's backward parameters: w[0..8] = w_in, dw, w_out, a1, a2, g1,
// b1, g2, b2 (compute dtype, then f32); its input x, cotangent g and
// outputs.
BwdParams block_bwd_params(const void* const* w, const void* x, const void* g,
                           void* dx, void* const* out, int M, int K, int B,
                           int H, int P, int dilation, int causal) {
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
  p.dx = dx;
  p.dw_in = static_cast<float*>(out[0]);
  p.dw_out = static_cast<float*>(out[1]);
  p.aux = static_cast<float*>(out[2]);
  p.M = M;
  p.K = K;
  p.B = B;
  p.H = H;
  p.P = P;
  p.dilation = dilation;
  p.left = causal ? (P - 1) * dilation : ((P - 1) * dilation) / 2;
  return p;
}

// Block 1's forward Params (gLN): x0 to x1, h and y in the backward's hp
// and c.
Params forward_params(const BwdParams& q, void* x1, void* w_eff, float* wsum,
                      float* part_a, float* part_b) {
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
  p.part_a = part_a;
  p.part_b = part_b;
  p.out = x1;
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
  T* x1 = act + L.act[0];
  T* dx1 = act + L.act[1];
  // block 1: input x0, cotangent dx1, writes dx0; block 2: input x1,
  // cotangent g, writes dx1
  BwdParams q1 = block_bwd_params(wa, x, dx1, dx, out_a, M, K, B, H, P, d1,
                                  causal);
  BwdParams q2 = block_bwd_params(wb, x1, g, dx1, out_b, M, K, B, H, P, d2,
                                  causal);
  bind_bwd_workspace<T>(&q1, L.bwd, ws_act, ws_f32);
  bind_bwd_workspace<T>(&q2, L.bwd, ws_act, ws_f32);
  CTN_TRY(launch_block<T>(forward_params(q1, x1, act + L.act[2],
                                         ws_f32 + L.f32[0], ws_f32 + L.f32[1],
                                         ws_f32 + L.f32[2]),
                          stream));
  CTN_TRY(launch_block_bwd<T, kNormGLN>(q2, stream));
  return launch_block_bwd<T, kNormGLN>(q1, stream);
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
