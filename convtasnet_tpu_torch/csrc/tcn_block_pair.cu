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
// H=512) a pair is four products and two depthwise convs, 27.0 GFLOP: 27
// us at the bf16 tensor-core rate. The Pallas kernel keeps one sample's x1
// ([K, B], 1.6 MB in bf16) and its [K, H] activation in VMEM through both
// blocks; an SM has 227 KB of shared memory, so here, as in B1, every
// statistic that spans a sample (gLN) or a row (cLN) ends a launch, and a
// pair costs what two single blocks cost, held by B1's output launch C'
// and its depthwise taps (PERF.md). The first design of this kernel (a
// 64x64 WMMA tile, a fused boundary launch of 400 CTAs at 3 per SM) took
// 1.02 ms in bf16 on an H100 (700 W), against 0.31 for two B1 calls.
//
// So the pair runs each block through launch_block (tcn_block_hopper.cuh),
// the launches a single block of its dtype and widths runs (bf16 at
// wg_widths_ok: prep, A', B', C' on the Hopper core; f32 and the other bf16
// widths: the first design's prep, A, B, C), block 1 writing x1 to the
// workspace as B1 writes its output and block 2 reading it. The pair
// equals two chained B1 calls bit for bit in either dtype, and makes their
// launches: 8 for bf16 gLN, 4 for cLN. Fusing the boundary was tried in
// bf16 and did not pay: one launch for C' of block 1 and A' of block 2
// (each CTA running A' on the x1 rows its C' half had just written, read
// back from L2) gave the same bits and took 130 us against 79 + 42 for the
// two launches, since both halves run 200 CTAs of one per SM in two waves
// either way, so no tail is saved; one prep launch for both blocks saved
// 3 us of 0.31 ms (PERF.md).
//
// Statistics are summed in a fixed order without atomics, so two calls
// give the same bits.
//
// Workspace: one block's h [M, K, H] and y [M, K, H] (the first design
// only), W_eff in the compute dtype, and its wsum and partials in f32, each
// block using them in turn, and x1 [M, K, B].

#include "tcn_block_hopper.cuh"

namespace {

struct PairLayout {
  size_t act[4];   // h, y, x1, w_eff
  size_t f32[3];   // wsum, part_a, part_b
  size_t n_act, n_f32;
};

PairLayout pair_layout(int M, int K, int B, int H, size_t act_bytes,
                       int norm) {
  long long n_a = 0, n_b = 0;
  part_counts(K, H, norm, &n_a, &n_b);
  const bool wg = runs_wg(B, H, act_bytes);
  const size_t rows = norm == kNormCLN ? static_cast<size_t>(M) * K : M;
  const size_t mkh = static_cast<size_t>(M) * K * H;
  // the bf16 stages recompute y in C' and keep no y buffer
  const size_t act[4] = {mkh, wg ? 0 : mkh, static_cast<size_t>(M) * K * B,
                         static_cast<size_t>(H) * B};
  const size_t f32[3] = {wsum_size(B, H, wg), 2 * rows * n_a, 2 * rows * n_b};
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
  if (norm != kNormGLN && norm != kNormCLN)
    return static_cast<int>(cudaErrorInvalidValue);
  const PairLayout L = pair_layout(M, K, B, H, sizeof(T), norm);
  T* act = static_cast<T*>(ws_act);
  T* h = act + L.act[0];
  T* y = act + L.act[1];
  T* x1 = act + L.act[2];
  T* w_eff = act + L.act[3];
  float* wsum = ws_f32 + L.f32[0];
  float* part_a = ws_f32 + L.f32[1];
  float* part_b = ws_f32 + L.f32[2];
  const Params p1 = block_params(wa, x, x1, h, y, w_eff, wsum, part_a, part_b,
                                 M, K, B, H, P, d1, causal, norm);
  const Params p2 = block_params(wb, x1, out, h, y, w_eff, wsum, part_a,
                                 part_b, M, K, B, H, P, d2, causal, norm);
  CTN_TRY(launch_block<T>(p1, stream));
  return launch_block<T>(p2, stream);
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
