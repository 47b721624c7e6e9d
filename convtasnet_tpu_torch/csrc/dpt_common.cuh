// Pieces shared by the first designs of the dual-path (DPT) sublayer
// forwards for Hopper (sm_90a): the inter-chunk attention
// (dpt_attention.cu, bf16 and f32), and in f32 the FFN (dpt_ffn.cu) and the
// intra-chunk attention (dpt_intra.cu), whose bf16 forwards run on the
// wgmma core (dpt_bwd_common.cuh, dpt_attn_bwd_wg.cuh).
//
// - ln_rows_to_smem: the pre-LN of a 64-row tile (f32 statistics, eps
//   1e-6, E[(x - mean)^2]) written to shared memory in the compute dtype,
//   as the Pallas kernels normalise their VMEM block before the first
//   product.
// - The products of a 64-row tile whose left operand already sits in shared
//   memory with a weight matrix streamed from device memory, 8 warps:
//   for bf16, tile_mma: WMMA tensor-core fragments with f32 accumulation
//   held in registers (TileAcc, a 64 x 64*WN tile, 2 x 4 warps of
//   32 x 16*WN), the weights streamed through two shared-memory stages by
//   cp.async so the next stage's copy overlaps this stage's products, and
//   tile_epilogue handing each output element to the caller; for f32,
//   block_gemm: FMA into an f32 tile in shared memory, as the TCN kernels
//   compute f32.
// - warp_mm: one warp's 16-row product of two shared-memory operands (the
//   second one optionally transposed), for the f32 intra cores' scores and
//   mix.
// - The two attention sublayers' first designs share their first and last
//   launch: ln_qkv_kernel (pre-LN + QKV product, rounded once) and the out
//   product, rounded once, + residual (out_proj_bf16_kernel on tile_mma; for f32
//   out_proj_residual_kernel, on the TCN kernels' gemm_tile). Only the
//   attention core between them differs.
// - Both launches and both cores also run a tensor-parallel shard (the
//   Pallas kernels' partial=True, parallel/dpt_tp.py): the h heads of the
//   shard's head group, of local width Bq = h * d < B, with w_qkv
//   [B, 3Bq] and w_out [Bq, B]; the out launch then writes round(a @ W_out)
//   alone, with no residual (the caller sums the shards' partials and adds
//   x once). In the full sublayer Bq == B and every value, and every order
//   of summation, is as before the partial mode existed.

#pragma once

#include <cuda_pipeline.h>

#include "tcn_block_common.cuh"

namespace {

constexpr int kRowTile = 64;        // rows of a block tile
constexpr int kDptThreads = 256;    // 8 warps
constexpr float kLnEps = 1e-6f;
constexpr int kQkvCols = 256;       // ln_qkv f32: output columns per step
constexpr int kQkvWN = 3;           // ln_qkv bf16: 192 columns per step
constexpr int kKStage = 32;         // tile_mma: weight rows per stage

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

// y_s[r][0:B] = LN(x[r0 + r]) * gamma + beta in T for the 64 rows of a tile
// (rows at or beyond `rows` are zero). One warp per row; called by the whole
// block, and the caller synchronises before reading y_s.
template <typename T>
__device__ void ln_rows_to_smem(const T* __restrict__ x, int r0, int rows,
                                int B, const float* __restrict__ gamma,
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
    for (int c = lane; c < B; c += 32) s += to_f<T>(src[c]);
    const float mean = warp_sum(s) / B;
    float v = 0.f;
    for (int c = lane; c < B; c += 32) {
      const float d = to_f<T>(src[c]) - mean;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / B + kLnEps);
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

// bf16: the f32 accumulators of a 64 x 64*WN output tile in registers;
// warp w holds rows 32*(w / 4) .. +32 and columns 16*WN*(w % 4) .. +16*WN.
template <int WN>
struct TileAcc {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[2][WN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j) nvcuda::wmma::fill_fragment(f[i][j], 0.f);
  }
};

// Bytes of one tile_mma weight stage (kKStage rows of 64*WN columns).
template <int WN>
__host__ __device__ constexpr size_t wstage_bytes() {
  return align128(static_cast<size_t>(kKStage) * padded<__nv_bfloat16>(64 * WN) *
                  sizeof(__nv_bfloat16));
}

// Bytes of tile_epilogue's scratch: one 16 x 16 f32 tile per warp.
constexpr size_t kEpilogueBytes = 8 * 16 * 16 * sizeof(float);

// acc += a_s[0:64, 0:depth] @ w[0:depth, n0 : n0 + 64*WN] on the tensor
// cores. a_s is row-major bf16 in shared memory (lda % 8 == 0), w row-major
// bf16 in device memory (ldw % 8 == 0, n0 % 8 == 0, 16-byte aligned);
// depth % kKStage == 0. w_s holds two stages of wstage_bytes<WN>(): stage
// s + 1 is copied by cp.async while stage s is multiplied. Called by all
// kDptThreads threads; ends synchronised.
template <int WN>
__device__ void tile_mma(TileAcc<WN>& acc, const __nv_bfloat16* a_s, int lda,
                         const __nv_bfloat16* __restrict__ w, int ldw,
                         int depth, int n0, __nv_bfloat16* w_s) {
  using namespace nvcuda;
  constexpr int NC = 64 * WN;
  constexpr int ldb = padded<__nv_bfloat16>(NC);
  constexpr int kStageElems =
      static_cast<int>(wstage_bytes<WN>() / sizeof(__nv_bfloat16));
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 2;
  const int wc = warp & 3;
  auto issue = [&](int k0, int buf) {
    __nv_bfloat16* dst = w_s + buf * kStageElems;
    for (int v = tid; v < kKStage * (NC / 8); v += kDptThreads) {
      const int r = v / (NC / 8);
      const int c = (v % (NC / 8)) * 8;
      __pipeline_memcpy_async(dst + r * ldb + c,
                              w + static_cast<size_t>(k0 + r) * ldw + n0 + c,
                              16);
    }
    __pipeline_commit();
  };
  const int steps = depth / kKStage;
  __syncthreads();  // w_s is free: its previous readers are done
  issue(0, 0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue((s + 1) * kKStage, (s + 1) & 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // stage s has landed for every thread
    const __nv_bfloat16* b = w_s + (s & 1) * kStageElems;
#pragma unroll
    for (int kk = 0; kk < kKStage; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i], a_s + (wr * 32 + i * 16) * lda + s * kKStage + kk, lda);
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b + kk * ldb + (wc * WN + j) * 16, ldb);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc.f[i][j], fa[i], fb, acc.f[i][j]);
      }
    }
    __syncthreads();  // stage s is read: it may be refilled
  }
}

// fn(row, col, v) for each run of 8 consecutive outputs of the tile, v[0:8]
// in f32, row in [0, 64), col in [0, 64*WN) a multiple of 8; through a
// 16 x 16 f32 scratch per warp (scratch holds kEpilogueBytes).
template <int WN, typename Fn>
__device__ void tile_epilogue(TileAcc<WN>& acc, float* scratch, Fn fn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* s = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      nvcuda::wmma::store_matrix_sync(s, acc.f[i][j], 16,
                                      nvcuda::wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1;
      const int c = (lane & 1) * 8;
      fn((warp >> 2) * 32 + i * 16 + r, ((warp & 3) * WN + j) * 16 + c,
         s + r * 16 + c);
      __syncwarp();
    }
  }
}

// Stores v[0:8] (f32) rounded to bf16 as one 16-byte write.
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float* v) {
  alignas(16) __nv_bfloat16 t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(t);
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
  int M, n, S, B, h, Bq, partial;
  long long R;
};

// Launch 1: qkv = round(LN(x) @ W_qkv), one 64-row tile per block; qkv has
// 3Bq columns (3Bq % 192 == 0 for bf16: Bq % 64 == 0).
template <typename T>
__host__ __device__ constexpr size_t ln_qkv_smem(int B) {
  return align128(static_cast<size_t>(kRowTile) * padded<T>(B) * sizeof(T)) +
         (kIsBf16<T>
              ? 2 * wstage_bytes<kQkvWN>() + kEpilogueBytes
              : kStageBytes + static_cast<size_t>(kRowTile) * (kQkvCols + 4) *
                                  sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(kDptThreads) ln_qkv_kernel(DptAttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = p.B;
  const int rows = static_cast<int>(p.R);
  const int ldy = padded<T>(B);
  T* y_s = reinterpret_cast<T*>(smem);
  unsigned char* next =
      smem + align128(static_cast<size_t>(kRowTile) * ldy * sizeof(T));
  const int r0 = blockIdx.x * kRowTile;
  ln_rows_to_smem<T>(static_cast<const T*>(p.x), r0, rows, B, p.gamma,
                     p.beta, y_s, ldy);
  __syncthreads();
  T* qkv = static_cast<T*>(p.qkv);
  const T* w_qkv = static_cast<const T*>(p.w_qkv);
  const int W3 = 3 * p.Bq;   // qkv columns
  if constexpr (kIsBf16<T>) {
    T* w_s = reinterpret_cast<T*>(next);
    float* scratch = reinterpret_cast<float*>(next + 2 * wstage_bytes<kQkvWN>());
    for (int n0 = 0; n0 < W3; n0 += 64 * kQkvWN) {
      TileAcc<kQkvWN> acc;
      acc.zero();
      tile_mma<kQkvWN>(acc, y_s, ldy, w_qkv, W3, B, n0, w_s);
      tile_epilogue<kQkvWN>(acc, scratch, [&](int r, int c, const float* v) {
        if (r0 + r < rows)
          store8_bf16(qkv + static_cast<size_t>(r0 + r) * W3 + n0 + c, v);
      });
    }
  } else {
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
}

// Launch 3: out = x + round(a @ W_out), a product of depth Bq into B
// columns; with partial, out = round(a @ W_out). f32: the TCN kernels' 64x64
// gemm_tile; bf16: tile_mma on a 64 x B output tile (WN = B / 64), the
// [64, Bq] rows of a copied to shared memory by cp.async.
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

template <int WN>
size_t out_proj_bf16_smem(int Bq) {
  return align128(static_cast<size_t>(kRowTile) * padded<__nv_bfloat16>(Bq) *
                  2) +
         2 * wstage_bytes<WN>() + kEpilogueBytes;
}

template <int WN>
__global__ void __launch_bounds__(kDptThreads)
    out_proj_bf16_kernel(DptAttnParams p) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int B = 64 * WN;
  const int Bq = p.Bq;
  const int lda = padded<T>(Bq);
  T* a_s = reinterpret_cast<T*>(smem);
  unsigned char* next =
      smem + align128(static_cast<size_t>(kRowTile) * lda * 2);
  T* w_s = reinterpret_cast<T*>(next);
  float* scratch = reinterpret_cast<float*>(next + 2 * wstage_bytes<WN>());
  const int rows = static_cast<int>(p.R);
  const int r0 = blockIdx.x * kRowTile;
  const T* a = static_cast<const T*>(p.a);
  for (int v = threadIdx.x; v < kRowTile * (Bq / 8); v += kDptThreads) {
    const int r = v / (Bq / 8);
    const int c = (v % (Bq / 8)) * 8;
    if (r0 + r < rows)
      __pipeline_memcpy_async(a_s + r * lda + c,
                              a + static_cast<size_t>(r0 + r) * Bq + c, 16);
    else
      *reinterpret_cast<uint4*>(a_s + r * lda + c) = make_uint4(0, 0, 0, 0);
  }
  __pipeline_commit();  // tile_mma's first wait covers this group too
  TileAcc<WN> acc;
  acc.zero();
  tile_mma<WN>(acc, a_s, lda, static_cast<const T*>(p.w_out), B, Bq, 0, w_s);
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  tile_epilogue<WN>(acc, scratch, [&](int r, int c, const float* v) {
    if (r0 + r >= rows) return;
    const size_t idx = static_cast<size_t>(r0 + r) * B + c;
    float o[8];
    if (p.partial) {
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = round_to<T>(v[e]);
    } else {
      alignas(16) T xv[8];
      *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(x + idx);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = to_f<T>(xv[e]) + round_to<T>(v[e]);
    }
    store8_bf16(out + idx, o);
  });
}

template <int WN>
int launch_out_proj_bf16(const DptAttnParams& p, cudaStream_t stream) {
  const size_t smem = out_proj_bf16_smem<WN>(p.Bq);
  const cudaError_t err = cudaFuncSetAttribute(
      out_proj_bf16_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((p.R + kRowTile - 1) / kRowTile);
  out_proj_bf16_kernel<WN><<<tiles, kDptThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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

// Launches 1 and 3 around an attention core (launch 2), on one stream;
// returns the first CUDA error.
template <typename T, typename Core>
int launch_attention(const DptAttnParams& p, cudaStream_t stream,
                     Core core) {
  const int ln_err = launch_ln_qkv<T>(p, stream);
  if (ln_err != 0) return ln_err;
  const int core_err = core(p, stream);
  if (core_err != 0) return core_err;
  if constexpr (kIsBf16<T>) {
    switch (p.B / 64) {
      case 1: return launch_out_proj_bf16<1>(p, stream);
      case 2: return launch_out_proj_bf16<2>(p, stream);
      case 3: return launch_out_proj_bf16<3>(p, stream);
      case 4: return launch_out_proj_bf16<4>(p, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const unsigned out_tiles = static_cast<unsigned>((p.R + kBM - 1) / kBM);
    out_proj_residual_kernel<T>
        <<<dim3(out_tiles, p.B / kBN), kGemmThreads, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

inline DptAttnParams make_attn_params(const void* x, const void* gamma,
                                      const void* beta, const void* w_qkv,
                                      const void* w_out, const void* bias,
                                      void* qkv, void* a, void* out, int M,
                                      int n, int S, int B, int h, int Bq,
                                      int partial) {
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
  p.h = h;
  p.Bq = Bq;
  p.partial = partial;
  p.R = static_cast<long long>(M) * n * S;
  return p;
}

}  // namespace

// The C interface of both attention forwards; Bq and partial as in
// DptAttnParams (Bq == B and partial 0 for the full sublayer).
#define CTN_DPT_ATTN_ARGS                                                    \
  const void *x, const void *gamma, const void *beta, const void *w_qkv,    \
      const void *w_out, const void *bias, void *qkv, void *a, void *out,  \
      int M, int n, int S, int B, int h, int Bq, int partial, void *stream
#define CTN_DPT_ATTN_PARAMS                                                   \
  make_attn_params(x, gamma, beta, w_qkv, w_out, bias, qkv, a, out, M, n, S, \
                   B, h, Bq, partial)
