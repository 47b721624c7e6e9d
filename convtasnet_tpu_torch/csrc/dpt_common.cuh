// Pieces shared by the first designs of the dual-path (DPT) sublayer
// forwards for Hopper (sm_90a), which f32 runs: the inter- and intra-chunk
// attention (dpt_attention.cu, dpt_intra.cu) and the FFN (dpt_ffn.cu). The
// bf16 forwards run on the wgmma core (dpt_bwd_common.cuh,
// dpt_attn_bwd_wg.cuh).
//
// - ln_rows_to_smem: the pre-LN of a 64-row tile (f32 statistics, eps
//   1e-6, E[(x - mean)^2]) written to shared memory in the compute dtype,
//   as the Pallas kernels normalise their VMEM block before the first
//   product. Its statistics span the sublayer's own width Bn, the first Bn
//   of the row's B columns (B is Bn zero-padded up to the 64-column tile by
//   the wrappers, with gamma and beta zero on the padded columns, so y is
//   zero there); at Bn == B every sum and every bit is as before.
// - block_gemm: the product of a 64-row tile whose left operand already
//   sits in shared memory with a weight matrix streamed from device
//   memory, 8 warps, by FMA into an f32 tile in shared memory, as the TCN
//   kernels compute f32.
// - warp_mm: one warp's 16-row product of two shared-memory operands (the
//   second one optionally transposed), for the f32 intra cores' scores and
//   mix.
// - The two attention sublayers' first designs share their first and last
//   launch: ln_qkv_kernel (pre-LN + QKV product, rounded once) and the out
//   product, rounded once, + residual (out_proj_residual_kernel, on the TCN
//   kernels' gemm_tile). Only the attention core between them differs.
//   Above B = 512 ln_qkv_kernel's y tile does not fit, and launch_attention
//   (dpt_bwd_common.cuh) runs launch 1 as two launches through device
//   memory instead (launch_qkv_rows there).
// - Both launches and both cores also run a tensor-parallel shard (the
//   Pallas kernels' partial=True, parallel/dpt_tp.py): the h heads of the
//   shard's head group, of local width Bq = h * d < B, with w_qkv
//   [B, 3Bq] and w_out [Bq, B]; the out launch then writes round(a @ W_out)
//   alone, with no residual (the caller sums the shards' partials and adds
//   x once). In the full sublayer Bq == B and every value, and every order
//   of summation, is as before the partial mode existed.

#pragma once

#include "tcn_block_common.cuh"

namespace {

constexpr int kRowTile = 64;        // rows of a block tile
constexpr int kDptThreads = 256;    // 8 warps
constexpr float kLnEps = 1e-6f;
constexpr int kQkvCols = 256;       // ln_qkv: output columns per step

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// Leading dimension of a shared [rows][cols] tile of T: 16 bytes of pad keep
// every WMMA fragment pointer 32-byte aligned (cols % 16 == 0) and move
// consecutive rows to other banks.
template <typename T>
__host__ __device__ constexpr int padded(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) & ~static_cast<size_t>(127);
}

// block_gemm (f32): weight rows staged per shared-memory copy, and the
// stage's bytes.
constexpr int kStageDepth = 64;
constexpr size_t kStageBytes =
    align128(static_cast<size_t>(kStageDepth) * padded<float>(64) * 4);

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The f32 inter cores (dpt_attention.cu, dpt_attention_bwd.cu): G lanes
// share a query (or key) chunk of a head of width D, each holding DL = D / G
// of its dimensions. Up to D = 64 one lane holds the whole row (the first
// design's arithmetic); at D = 128, whose rows would spill, two lanes of 64.
template <int D>
struct InterLanes {
  static constexpr int G = D > 64 ? D / 64 : 1;
  static constexpr int DL = D / G;
};

// A dot product whose G lanes (adjacent, G a power of two) each hold a
// partial sum: every lane gets the whole by a butterfly, in the same bits
// (each add's operands are the same two values in either order). G = 1
// returns v as it is.
template <int G>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The key chunks an f32 inter core (dpt_attention.cu, dpt_attention_bwd.cu)
// stages per shared-memory load: kInterKeys, 8 Bq bytes each, up to Bq =
// 512 (256 Bq bytes, 128 KB there; 32 chunks fit up to Bq = 896); above it
// (the cores' kKeys = 0 instantiations, chosen by Bq alone) the most, from
// 16 down by halves, whose staging fits in kInterWideStage: 16 up to Bq =
// 1024, 8 up to 2048, and so on, one chunk at the least. The chunks' sums
// run key by key in the same order at any staging, so the tile's size
// moves no bit.
constexpr int kInterKeys = 32;
constexpr size_t kInterWideStage = 128 * 1024;

template <typename T>
__host__ __device__ constexpr int inter_wide_keys(int Bq) {
  int keys = 16;
  while (keys > 1 &&
         static_cast<size_t>(keys) * 2 * Bq * sizeof(T) > kInterWideStage)
    keys /= 2;
  return keys;
}

// The key chunks a core instantiated with kKeys stages (kKeys = 0:
// inter_wide_keys).
template <typename T, int kKeys>
__host__ __device__ constexpr int inter_core_keys(int Bq) {
  return kKeys ? kKeys : inter_wide_keys<T>(Bq);
}

// Warps of an f32 inter core's block for h heads, a warp per head: h up to
// 8, else the most, at most 8, that divide h (16 heads of 16 at B = 256;
// 10 to 16 heads of 32 at B = 320 to 512), each warp taking h / warps heads
// in turn (every warp meets the block's barriers equally often).
inline int core_warps(int h) {
  int w = h < 8 ? h : 8;
  while (h % w) --w;
  return w;
}

// y_s[r][0:B] = LN(x[r0 + r]) * gamma + beta in T for the 64 rows of a tile
// (rows at or beyond `rows` are zero), the mean and the variance over the
// first Bn columns. One warp per row; called by the whole block, and the
// caller synchronises before reading y_s.
template <typename T>
__device__ void ln_rows_to_smem(const T* __restrict__ x, int r0, int rows,
                                int B, int Bn, const float* __restrict__ gamma,
                                const float* __restrict__ beta, T* y_s,
                                int ld) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < kRowTile; r += n_warps) {
    T* dst = y_s + r * ld;
    if (r0 + r >= rows) {
      for (int c = lane; c < B; c += 32) dst[c] = from_f<T>(0.f);
      continue;
    }
    const T* src = x + static_cast<size_t>(r0 + r) * B;
    float s = 0.f;
    for (int c = lane; c < Bn; c += 32) s += to_f<T>(src[c]);
    const float mean = warp_sum(s) / Bn;
    float v = 0.f;
    for (int c = lane; c < Bn; c += 32) {
      const float d = to_f<T>(src[c]) - mean;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / Bn + kLnEps);
    for (int c = lane; c < B; c += 32)
      dst[c] = from_f<T>((to_f<T>(src[c]) - mean) * rs * gamma[c] + beta[c]);
  }
}

// c_s[0:64, 0:NC] = (or, with kAcc, +=) a_s[0:64, 0:depth] @
// w[0:depth, n0:n0+NC] in f32 by FMA. a_s is row-major in shared memory
// (lda), w row-major in device memory (ldw); w_s holds kStageDepth x
// padded<float>(64) floats. NC % 64 == 0, ldw and n0 multiples of 4
// (checked by the wrappers). kDptThreads threads; ends synchronised.
template <bool kAcc>
__device__ void block_gemm(const float* a_s, int lda,
                           const float* __restrict__ w, int ldw, int depth,
                           int n0, int NC, float* w_s, float* c_s, int ldc) {
  constexpr int ldb = padded<float>(64);
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // 16 x 16 threads, each a 4 x 4 micro-tile
  const int ty = tid >> 4;
  for (int nc = 0; nc < NC; nc += 64) {
    float* c = c_s + nc;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = kAcc ? c[(ty * 4 + i) * ldc + tx * 4 + j] : 0.f;
    for (int k0 = 0; k0 < depth; k0 += kStageDepth) {
      const int kd = min(kStageDepth, depth - k0);
      __syncthreads();  // the previous stage's readers are done
      for (int v = tid; v < kd * 16; v += kDptThreads) {
        const int r = v / 16;
        const int col = (v % 16) * 4;
        *reinterpret_cast<float4*>(&w_s[r * ldb + col]) =
            *reinterpret_cast<const float4*>(
                w + static_cast<size_t>(k0 + r) * ldw + n0 + nc + col);
      }
      __syncthreads();
      for (int kk = 0; kk < kd; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[(ty * 4 + i) * lda + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w_s[kk * ldb + tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[(ty * 4 + i) * ldc + tx * 4 + j] = acc[i][j];
  }
  __syncthreads();
}

// One warp: c[0:16, 0:NC] (f32, ldc) = a[0:16, 0:depth] (lda) @ b, with b
// [depth][NC] row-major (ldb), or with kBT b^T stored as [NC][depth]
// row-major (ldb); with kAT the left operand is a^T, a stored as
// [depth][16] row-major (lda). All three in shared memory, f32 (the first
// designs' f32 intra kernels; their bf16 designs run on mma.sync). An odd
// ldb keeps the kBT reads off shared banks.
template <typename T, bool kBT, bool kAT = false>
__device__ void warp_mm(const T* a, int lda, const T* b, int ldb, int depth,
                        int NC, float* c, int ldc) {
  static_assert(!kIsBf16<T>, "warp_mm is the f32 cores' product");
  const int lane = threadIdx.x & 31;
  for (int n0 = 0; n0 < NC; n0 += 32) {
    const int col = n0 + lane;
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.f;
    if (col < NC) {
      for (int k = 0; k < depth; ++k) {
        const float bv = to_f<T>(kBT ? b[col * ldb + k] : b[k * ldb + col]);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc[r] = fmaf(to_f<T>(a[kAT ? k * lda + r : r * lda + k]), bv,
                        acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) c[r * ldc + col] = acc[r];
    }
  }
  __syncwarp();
}

// Operands of one attention sublayer (see the wrappers in
// ops/cuda/dpt_attention.py): x and out [M, n, S, B], w_qkv [B, 3Bq],
// w_out [Bq, B] in T; gamma, beta [B] and the additive key bias [n, S] (or
// null) in f32; the workspaces qkv [R, 3Bq] and a [R, Bq] in T, R = M*n*S.
// Bq = h * d is the width of the h heads (B in the full sublayer); partial:
// out = round(a @ W_out) without the residual (a tensor-parallel shard).
// Bn <= B is the LN's width, the sublayer's own B: the wrappers pad B off
// the 64-column tile with zero columns (and Bq with zero heads), and every
// LN statistic spans the first Bn columns alone. Bn sits in the padding
// before R, so every other field keeps its offset.
struct DptAttnParams {
  const void* x;
  const float* gamma;
  const float* beta;
  const void* w_qkv;
  const void* w_out;
  const float* bias;
  void* qkv;
  void* a;
  void* out;
  int M, n, S, B, h, Bq, partial, Bn;
  long long R;
};

// Launch 1: qkv = round(LN(x) @ W_qkv), one 64-row tile per block; qkv has
// 3Bq columns. f32 (the bf16 forwards and backwards run LQ's tiles).
// Shared memory: 256 (B + 4) + 83,968 bytes, 216 KB at B = 512; it runs B
// up to 512, and launch_qkv_rows (dpt_bwd_common.cuh) above.
template <typename T>
__host__ __device__ constexpr size_t ln_qkv_smem(int B) {
  return align128(static_cast<size_t>(kRowTile) * padded<T>(B) * sizeof(T)) +
         kStageBytes +
         static_cast<size_t>(kRowTile) * (kQkvCols + 4) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kDptThreads) ln_qkv_kernel(DptAttnParams p) {
  static_assert(!kIsBf16<T>, "ln_qkv_kernel is the f32 frame's");
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = p.B;
  const int rows = static_cast<int>(p.R);
  const int ldy = padded<T>(B);
  T* y_s = reinterpret_cast<T*>(smem);
  unsigned char* next =
      smem + align128(static_cast<size_t>(kRowTile) * ldy * sizeof(T));
  const int r0 = blockIdx.x * kRowTile;
  ln_rows_to_smem<T>(static_cast<const T*>(p.x), r0, rows, B, p.Bn, p.gamma,
                     p.beta, y_s, ldy);
  __syncthreads();
  T* qkv = static_cast<T*>(p.qkv);
  const T* w_qkv = static_cast<const T*>(p.w_qkv);
  const int W3 = 3 * p.Bq;   // qkv columns
  constexpr int ldc = kQkvCols + 4;
  float* w_s = reinterpret_cast<float*>(next);
  float* c_s = reinterpret_cast<float*>(next + kStageBytes);
  for (int n0 = 0; n0 < W3; n0 += kQkvCols) {
    const int nc = min(kQkvCols, W3 - n0);
    block_gemm<false>(y_s, ldy, w_qkv, W3, B, n0, nc, w_s, c_s, ldc);
    for (int e = threadIdx.x; e < kRowTile * nc; e += kDptThreads) {
      const int r = e / nc;
      const int c = e % nc;
      if (r0 + r < rows)
        qkv[static_cast<size_t>(r0 + r) * W3 + n0 + c] = c_s[r * ldc + c];
    }
    __syncthreads();  // c_s is rewritten by the next step
  }
}

// Launch 3: out = x + round(a @ W_out), a product of depth Bq into B
// columns; with partial, out = round(a @ W_out). The TCN kernels' 64x64
// gemm_tile.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    out_proj_residual_kernel(DptAttnParams p) {
  using S = GemmSmem<T>;
  __shared__ S s;
  const int rows = static_cast<int>(p.R);
  const int B = p.B;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  gemm_tile<T>(static_cast<const T*>(p.a), static_cast<const T*>(p.w_out),
               rows, p.Bq, B, r0, n0, s);
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN;
    const int c = e % kBN;
    if (r0 + r >= rows) continue;
    const size_t idx = static_cast<size_t>(r0 + r) * B + n0 + c;
    const float proj = round_to<T>(s.c[r * S::kLdC + c]);
    out[idx] = from_f<T>(p.partial ? proj : to_f<T>(x[idx]) + proj);
  }
}

// Launch 1 alone (the backward kernels recompute qkv with it).
template <typename T>
int launch_ln_qkv(const DptAttnParams& p, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((p.R + kRowTile - 1) / kRowTile);
  const size_t smem = ln_qkv_smem<T>(p.B);
  const cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_qkv_kernel<T><<<tiles, kDptThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

inline DptAttnParams make_attn_params(const void* x, const void* gamma,
                                      const void* beta, const void* w_qkv,
                                      const void* w_out, const void* bias,
                                      void* qkv, void* a, void* out, int M,
                                      int n, int S, int B, int Bn, int h,
                                      int Bq, int partial) {
  DptAttnParams p;
  p.x = x;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.w_qkv = w_qkv;
  p.w_out = w_out;
  p.bias = static_cast<const float*>(bias);
  p.qkv = qkv;
  p.a = a;
  p.out = out;
  p.M = M;
  p.n = n;
  p.S = S;
  p.B = B;
  p.Bn = Bn;
  p.h = h;
  p.Bq = Bq;
  p.partial = partial;
  p.R = static_cast<long long>(M) * n * S;
  return p;
}

}  // namespace

// The C interface of both attention forwards; Bn, Bq and partial as in
// DptAttnParams (Bn == Bq == B and partial 0 for the full sublayer at a
// width on the tile). Beside the struct: d, the heads' real width (the
// softmax scale is 1 / sqrt(d); the wrappers pad each head from d to the
// width D = Bq / h a core takes, d == D where no head is padded), and
// wide, the f32 workspace of the route above D = 128
// (dpt_attn_wide_head.cuh; ctn_dpt_attn_wide_workspace gives its size,
// null at D <= 128).
#define CTN_DPT_ATTN_ARGS                                                    \
  const void *x, const void *gamma, const void *beta, const void *w_qkv,    \
      const void *w_out, const void *bias, void *qkv, void *a, void *out,  \
      int M, int n, int S, int B, int Bn, int h, int Bq, int partial,      \
      int d, void *wide, void *stream
#define CTN_DPT_ATTN_PARAMS                                                   \
  make_attn_params(x, gamma, beta, w_qkv, w_out, bias, qkv, a, out, M, n, S, \
                   B, Bn, h, Bq, partial)
