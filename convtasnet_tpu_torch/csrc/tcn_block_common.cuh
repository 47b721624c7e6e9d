// Pieces shared by the TCN-block forward (tcn_block.cu) and backward
// (tcn_block_bwd.cu) kernels: dtype helpers, PReLU, deterministic block
// reductions, the per-sample gLN statistic, the tiled shared-memory GEMM
// (64x64 output tile, depth 32, 4 warps; WMMA bf16 tensor-core fragments
// with f32 accumulation for bf16, FMA for f32), and the forward's first two
// launches (A: input product, B: depthwise conv), which the backward reruns
// to recompute the block's intermediates, and the backward kernels' weight
// gradients (split-row a^T @ b with a fixed-order chunk sum, transposes). Their kPre flag stores the
// pre-activation values instead of the PReLU outputs, for the backward's
// PReLU derivatives; the norm statistics are the same either way. The norm
// is a template parameter too (p.norm must equal kNorm), so that a gLN or
// BN instantiation of launch B holds none of cLN's shared arrays and fits
// the registers of full occupancy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kEps = 1e-8f;     // gLN / cLN: eps added to the variance

// GEMM tiling.
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 128;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v as the compute dtype T holds it (rounded to bf16 for bf16).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : a * v;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum of (a, b) in a fixed order; the result is valid in thread 0.
template <typename V>
__device__ void block_sum2(V& a, V& b) {
  __shared__ V s[2][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // s may still be read by an earlier call
  if (lane == 0) {
    s[0][warp] = a;
    s[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0;
    b = 0;
    for (int w = 0; w < n_warps; ++w) {
      a += s[0][w];
      b += s[1][w];
    }
  }
}

// Mean and reciprocal std of one sample from n (sum, sum of squares)
// partials over `count` elements: rs = rsqrt(E[v^2] - mean^2 + eps).
// Called by the whole block; the result lands in *mu, *rs (shared).
__device__ void sample_stats(const float* part, int n, double count,
                             float* mu, float* rs) {
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s1 += part[2 * i];
    s2 += part[2 * i + 1];
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    const double mean = s1 / count;
    double var = s2 / count - mean * mean;
    var = var > 0.0 ? var : 0.0;
    *mu = static_cast<float>(mean);
    *rs = rsqrtf(static_cast<float>(var) + kEps);
  }
  __syncthreads();
}

template <typename T>
struct GemmSmem {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int kLdA = kBK + kVec;
  static constexpr int kLdB = kBN + kVec;
  static constexpr int kLdC = kBN + 4;
  alignas(32) T a[kBM * kLdA];
  alignas(32) T b[kBK * kLdB];
  alignas(32) float c[kBM * kLdC];
};

// Leading dimension of a resident [kBM, cols] left operand of gemm_tile
// (kResA): 16 bytes of pad per row.
template <typename T>
__host__ __device__ constexpr int res_ld(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}

// s.c[0:kBM, 0:kBN] = act[r0:r0+kBM, :] @ w[:, n0:n0+kBN], rows of act at
// or beyond `rows` read as zero. act is [rows, depth] row-major, w is
// [depth, cols] row-major; depth % kBK == 0 and cols % kBN == 0 (checked by
// the wrapper). With kResA, act is instead a [kBM, lda] tile already in
// shared memory (its ragged rows zeroed by the caller; r0 and rows unused),
// read in place: the same fragments in the same order, so the same bits as
// the tile copied from device memory. lda % 16 / sizeof(T) == 0.
template <typename T, bool kResA = false>
__device__ void gemm_tile(const T* __restrict__ act, const T* __restrict__ w,
                          int rows, int depth, int cols, int r0, int n0,
                          GemmSmem<T>& s, int lda = 0) {
  using S = GemmSmem<T>;
  constexpr int V = S::kVec;
  const int tid = threadIdx.x;
  if constexpr (!kResA) lda = S::kLdA;

  auto load_tiles = [&](int k0) {
    if constexpr (!kResA) {
      for (int v = tid; v < kBM * kBK / V; v += kGemmThreads) {
        const int r = v / (kBK / V);
        const int c = (v % (kBK / V)) * V;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < rows)
          val = *reinterpret_cast<const uint4*>(
              act + static_cast<size_t>(r0 + r) * depth + k0 + c);
        *reinterpret_cast<uint4*>(&s.a[r * S::kLdA + c]) = val;
      }
    }
    for (int v = tid; v < kBK * kBN / V; v += kGemmThreads) {
      const int r = v / (kBN / V);
      const int c = (v % (kBN / V)) * V;
      *reinterpret_cast<uint4*>(&s.b[r * S::kLdB + c]) =
          *reinterpret_cast<const uint4*>(
              w + static_cast<size_t>(k0 + r) * cols + n0 + c);
    }
  };

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    const int warp = tid >> 5;
    const int wr = warp >> 1;  // 2x2 warps, each a 32x32 sub-tile
    const int wc = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < depth; k0 += kBK) {
      load_tiles(k0);
      __syncthreads();
      const T* a_t = kResA ? act + k0 : s.a;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a_t + (wr * 32 + i * 16) * lda + kk,
                                 lda);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &s.b[kk * S::kLdB + wc * 32 + j * 16],
                                 S::kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            &s.c[(wr * 32 + i * 16) * S::kLdC + wc * 32 + j * 16], acc[i][j],
            S::kLdC, wmma::mem_row_major);
  } else {
    // 16 x 8 threads, each an 8-row x 4-column micro-tile.
    const int tx = tid & 15;
    const int ty = tid >> 4;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < depth; k0 += kBK) {
      load_tiles(k0);
      __syncthreads();
      const T* a_t = kResA ? act + k0 : s.a;
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f<T>(a_t[(ty * 8 + i) * lda + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = to_f<T>(s.b[kk * S::kLdB + tx * 4 + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s.c[(ty * 8 + i) * S::kLdC + tx * 4 + j] = acc[i][j];
  }
  __syncthreads();
}

constexpr int kNormGLN = 0;
constexpr int kNormCLN = 1;
constexpr int kNormBN = 2;
constexpr float kBnEps = 1e-5f;   // BatchNorm1d default

// Depthwise tiling (launch B): one channel per thread, kDwRows rows per block.
constexpr int kDwRows = 32;
constexpr int kDwThreads = 256;
constexpr int kMaxTaps = 16;

struct Params {
  const void* x;
  const void* w_in;
  const void* dw;
  const void* w_out;
  const float* a1;
  const float* a2;
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  const float* m1;
  const float* v1;
  const float* m2;
  const float* v2;
  void* h;
  void* y;
  void* w_eff;     // [H, B] compute dtype: diag(g) W_out
  float* wsum;     // [2, B]: g @ W_out (of W_eff as rounded), b @ W_out
  float* part_a;
  float* part_b;
  void* out;
  int M, K, B, H, P, dilation, left, norm;
};

// Mean and reciprocal std of one row of H channels from n per-row partials.
__device__ __forceinline__ void row_stats(const float* part, int n, int H,
                                          float* mu, float* rs) {
  double s1 = 0.0, s2 = 0.0;
  for (int j = 0; j < n; ++j) {
    s1 += part[2 * j];
    s2 += part[2 * j + 1];
  }
  const double mean = s1 / H;
  double var = s2 / H - mean * mean;
  var = var > 0.0 ? var : 0.0;
  *mu = static_cast<float>(mean);
  *rs = rsqrtf(static_cast<float>(var) + kEps);
}

// Launch A's epilogue for tile (bx, by) of sample m of a grid of n_bx row
// tiles by n_by column tiles, its product x @ W_in in s.c: h = PReLU (kPre:
// the pre-activation) to p.h, and norm1's partial sums, taken over the f32
// PReLU outputs before they are stored, to p.part_a.
template <typename T, int kNorm, bool kPre>
__device__ void in_proj_epilogue(const Params& p, GemmSmem<T>& s, int m,
                                 int bx, int by, int n_bx, int n_by) {
  using S = GemmSmem<T>;
  const int r0 = bx * kBM;
  const int n0 = by * kBN;
  const float a1 = *p.a1;
  T* h = static_cast<T*>(p.h) + static_cast<size_t>(m) * p.K * p.H;
  float s1 = 0.f, s2 = 0.f;
  for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN;
    const int c = e % kBN;
    float v = 0.f;
    if (r0 + r < p.K) {
      const float pre = s.c[r * S::kLdC + c];
      v = prelu(pre, a1);
      h[static_cast<size_t>(r0 + r) * p.H + n0 + c] = from_f<T>(kPre ? pre : v);
    }
    s1 += v;
    s2 += v * v;
    s.c[r * S::kLdC + c] = v;
  }
  if constexpr (kNorm == kNormGLN) {
    block_sum2(s1, s2);
    if (threadIdx.x == 0) {
      float* dst = p.part_a +
          2 * ((static_cast<size_t>(m) * n_bx + bx) * n_by + by);
      dst[0] = s1;
      dst[1] = s2;
    }
  } else if constexpr (kNorm == kNormCLN) {
    __syncthreads();
    const int r = threadIdx.x;
    if (r < kBM && r0 + r < p.K) {
      float t1 = 0.f, t2 = 0.f;
      for (int c = 0; c < kBN; ++c) {
        const float v = s.c[r * S::kLdC + c];
        t1 += v;
        t2 += v * v;
      }
      float* dst = p.part_a +
          2 * ((static_cast<size_t>(m) * p.K + r0 + r) * n_by + by);
      dst[0] = t1;
      dst[1] = t2;
    }
  }
}

// Launch A: h = PReLU(x @ W_in) (kPre: x @ W_in) and norm1's partial sums.
// Grid (ceil(K/kBM), H/kBN, M).
template <typename T, int kNorm, bool kPre>
__global__ void __launch_bounds__(kGemmThreads) in_proj_kernel(Params p) {
  __shared__ GemmSmem<T> s;
  const int m = blockIdx.z;
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(m) * p.K * p.B;
  gemm_tile<T>(x, static_cast<const T*>(p.w_in), p.K, p.B, p.H,
               blockIdx.x * kBM, blockIdx.y * kBN, s);
  in_proj_epilogue<T, kNorm, kPre>(p, s, m, blockIdx.x, blockIdx.y, gridDim.x,
                                   gridDim.y);
}

// Launch B: norm1 + dilated depthwise conv + PReLU, and norm2's partials
// over the f32 PReLU outputs. kPre: h holds launch A's pre-activations and
// y gets the conv output before PReLU. Grid (ceil(K/kDwRows),
// ceil(H/kDwThreads), M); n_part_a is the number of launch-A partials per
// sample (gLN) or per row (cLN). The launch is latency-bound: it runs best
// at full occupancy, 8 blocks per SM, which caps it at 32 registers.
template <typename T, int kNorm, bool kPre>
__global__ void __launch_bounds__(kDwThreads, 8)
    dwconv_kernel(Params p, int n_part_a) {
  __shared__ float s_mu[kMaxTaps * kDwRows];
  __shared__ float s_rs[kMaxTaps * kDwRows];
  __shared__ float s_row[2][kDwThreads / 32][kDwRows];
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kDwRows;
  const int c = blockIdx.y * kDwThreads + threadIdx.x;
  const int K = p.K, H = p.H, P = p.P, d = p.dilation;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if constexpr (kNorm == kNormGLN) {
    sample_stats(p.part_a + 2 * static_cast<size_t>(m) * n_part_a, n_part_a,
                 static_cast<double>(K) * H, &s_mu[0], &s_rs[0]);
  } else if constexpr (kNorm == kNormCLN) {
    // statistics of every input row a tap of this tile reads
    for (int t = threadIdx.x; t < P * kDwRows; t += kDwThreads) {
      const int q = t / kDwRows;
      const int kk = r0 + (t % kDwRows) + q * d - p.left;
      if (kk >= 0 && kk < K)
        row_stats(p.part_a + 2 * (static_cast<size_t>(m) * K + kk) * n_part_a,
                  n_part_a, H, &s_mu[t], &s_rs[t]);
    }
    __syncthreads();
  }

  const T* h = static_cast<const T*>(p.h) + static_cast<size_t>(m) * K * H;
  const T* dw = static_cast<const T*>(p.dw);
  T* y = static_cast<T*>(p.y) + static_cast<size_t>(m) * K * H;
  const float a1 = kPre ? *p.a1 : 0.f;
  const float a2 = *p.a2;
  const bool active = c < H;
  // per-channel scale/shift of norm1 (gLN, BN)
  float sc = 1.f, sh = 0.f, g = 1.f, b = 0.f;
  if (active) {
    g = p.g1[c];
    b = p.b1[c];
    if constexpr (kNorm == kNormGLN) {
      sc = s_rs[0] * g;
      sh = b - s_mu[0] * sc;
    } else if constexpr (kNorm == kNormBN) {
      sc = g * rsqrtf(p.v1[c] + kBnEps);
      sh = b - p.m1[c] * sc;
    }
  }
  float t1 = 0.f, t2 = 0.f;
  for (int i = 0; i < kDwRows; ++i) {
    const int k = r0 + i;
    float v = 0.f;
    if (active && k < K) {
      float acc = 0.f;
      for (int q = 0; q < P; ++q) {
        const int kk = k + q * d - p.left;
        if (kk < 0 || kk >= K) continue;  // zero padding after norm1
        float hv = to_f<T>(h[static_cast<size_t>(kk) * H + c]);
        if (kPre) hv = prelu(hv, a1);
        const float hn = kNorm == kNormCLN
            ? (hv - s_mu[q * kDwRows + i]) * s_rs[q * kDwRows + i] * g + b
            : hv * sc + sh;
        acc = fmaf(to_f<T>(dw[q * H + c]), hn, acc);
      }
      v = prelu(acc, a2);
      y[static_cast<size_t>(k) * H + c] = from_f<T>(kPre ? acc : v);
    }
    if constexpr (kNorm == kNormGLN) {
      t1 += v;
      t2 += v * v;
    } else if constexpr (kNorm == kNormCLN) {
      const float w1 = warp_sum(v);
      const float w2 = warp_sum(v * v);
      if (lane == 0) {
        s_row[0][warp][i] = w1;
        s_row[1][warp][i] = w2;
      }
    }
  }
  if constexpr (kNorm == kNormGLN) {
    block_sum2(t1, t2);
    if (threadIdx.x == 0) {
      float* dst = p.part_b +
          2 * ((static_cast<size_t>(m) * gridDim.x + blockIdx.x) * gridDim.y +
               blockIdx.y);
      dst[0] = t1;
      dst[1] = t2;
    }
  } else if constexpr (kNorm == kNormCLN) {
    __syncthreads();
    const int i = threadIdx.x;
    if (i < kDwRows && r0 + i < K) {
      float u1 = 0.f, u2 = 0.f;
      for (int w = 0; w < kDwThreads / 32; ++w) {
        u1 += s_row[0][w][i];
        u2 += s_row[1][w][i];
      }
      float* dst = p.part_b +
          2 * ((static_cast<size_t>(m) * K + r0 + i) * gridDim.y + blockIdx.y);
      dst[0] = u1;
      dst[1] = u2;
    }
  }
}

// The prep launch before launch A: W_eff = diag(g) W_out, with g the
// per-channel scale of norm2 (for BN the running statistics folded in), in
// the compute dtype, and the column sums g @ W_out (of W_eff as rounded) and
// b @ W_out, that launch C's folded product reads (tcn_block.cu's top note).
// Block (32 columns) x (kPrepRowGroups row groups); grid B/32.
constexpr int kPrepRowGroups = 16;

template <typename T>
__global__ void __launch_bounds__(32 * kPrepRowGroups)
    out_weights_kernel(Params p) {
  __shared__ float s_sum[2][kPrepRowGroups][32];
  const int n = blockIdx.x * 32 + threadIdx.x;
  const int rg = threadIdx.y;
  const int B = p.B, H = p.H;
  const bool bn = p.norm == kNormBN;
  const T* w_out = static_cast<const T*>(p.w_out);
  T* w_eff = static_cast<T*>(p.w_eff);
  float gw = 0.f, bw = 0.f;
  if (n < B) {
    for (int r = rg; r < H; r += kPrepRowGroups) {
      const size_t idx = static_cast<size_t>(r) * B + n;
      const float wv = to_f<T>(w_out[idx]);
      const float g = bn ? p.g2[r] * rsqrtf(p.v2[r] + kBnEps) : p.g2[r];
      const T we = from_f<T>(wv * g);
      w_eff[idx] = we;
      gw += to_f<T>(we);
      bw = fmaf(bn ? p.b2[r] - p.m2[r] * g : p.b2[r], wv, bw);
    }
  }
  s_sum[0][rg][threadIdx.x] = gw;
  s_sum[1][rg][threadIdx.x] = bw;
  __syncthreads();
  if (rg == 0 && n < B) {
    for (int g = 1; g < kPrepRowGroups; ++g) {
      gw += s_sum[0][g][threadIdx.x];
      bw += s_sum[1][g][threadIdx.x];
    }
    p.wsum[n] = gw;
    p.wsum[B + n] = bw;
  }
}

// Launch C's norm2 statistics for rows r0..r0+kBM of sample m, from launch
// B's n_part_b partials: mean and rs per row into s_mu, s_rs (the sample's
// for gLN, each row's for cLN, 0 and 1 for BN, whose statistics are folded
// into W_eff). Called by the whole block; ends with a barrier.
__device__ void out_proj_stats(const Params& p, int n_part_b, int m, int r0,
                               float* s_mu, float* s_rs) {
  const int K = p.K, H = p.H;
  if (p.norm == kNormGLN) {
    sample_stats(p.part_b + 2 * static_cast<size_t>(m) * n_part_b, n_part_b,
                 static_cast<double>(K) * H, &s_mu[0], &s_rs[0]);
    const float mu = s_mu[0], rs = s_rs[0];
    __syncthreads();
    for (int r = threadIdx.x; r < kBM; r += blockDim.x) {
      s_mu[r] = mu;
      s_rs[r] = rs;
    }
  } else if (p.norm == kNormCLN) {
    for (int r = threadIdx.x; r < kBM; r += blockDim.x) {
      if (r0 + r < K)
        row_stats(p.part_b + 2 * (static_cast<size_t>(m) * K + r0 + r) * n_part_b,
                  n_part_b, H, &s_mu[r], &s_rs[r]);
    }
  } else {
    for (int r = threadIdx.x; r < kBM; r += blockDim.x) {
      s_mu[r] = 0.f;
      s_rs[r] = 1.f;
    }
  }
  __syncthreads();
}

// Launch C's epilogue for the tile at rows r0, columns n0 of sample m, its
// product (y*g) @ W_out in s.c: out = x + rs*(c - mu*(g @ W_out)) + b @ W_out,
// rounded to the compute dtype.
template <typename T>
__device__ void out_proj_epilogue(const Params& p, const GemmSmem<T>& s,
                                  const float* s_mu, const float* s_rs, int m,
                                  int r0, int n0) {
  using S = GemmSmem<T>;
  const int K = p.K, B = p.B;
  const float* gw = p.wsum + n0;
  const float* bw = p.wsum + B + n0;
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(m) * K * B;
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(m) * K * B;
  for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN;
    const int c = e % kBN;
    if (r0 + r >= K) continue;
    const size_t idx = static_cast<size_t>(r0 + r) * B + n0 + c;
    const float o = s_rs[r] * (s.c[r * S::kLdC + c] - s_mu[r] * gw[c]) + bw[c];
    out[idx] = from_f<T>(to_f<T>(x[idx]) + o);
  }
}

// Launch C: out = x + rs*((y*g) @ W_out - mu*(g @ W_out)) + b @ W_out.
// Grid (ceil(K/kBM), B/kBN, M); n_part_b is the number of launch-B
// partials per sample (gLN) or per row (cLN).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads) out_proj_kernel(Params p,
                                                                int n_part_b) {
  __shared__ GemmSmem<T> s;
  __shared__ float s_mu[kBM];
  __shared__ float s_rs[kBM];
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  out_proj_stats(p, n_part_b, m, r0, s_mu, s_rs);
  const T* y = static_cast<const T*>(p.y) + static_cast<size_t>(m) * p.K * p.H;
  gemm_tile<T>(y, static_cast<const T*>(p.w_eff), p.K, p.H, p.B, r0, n0, s);
  out_proj_epilogue<T>(p, s, s_mu, s_rs, m, r0, n0);
}

// Number of (sum, sum of squares) partials launches A and B write per
// sample (gLN) or per row (cLN); 0 for BN.
inline int part_counts(int K, int H, int norm, long long* n_a,
                       long long* n_b) {
  const long long kt = (K + kBM - 1) / kBM;
  const long long nt = H / kBN;
  const long long rt = (K + kDwRows - 1) / kDwRows;
  const long long ct = (H + kDwThreads - 1) / kDwThreads;
  if (norm == kNormGLN) {
    *n_a = kt * nt;
    *n_b = rt * ct;
  } else if (norm == kNormCLN) {
    *n_a = nt;
    *n_b = ct;
  } else {
    *n_a = 0;
    *n_b = 0;
  }
  return 0;
}

// The weight gradients of the backward kernels (tcn_block_bwd.cu and the
// DPT backwards): a^T @ b over all rows, split into chunks of kChunkRows
// rows whose f32 partials are added in a fixed order, and the weight
// transpose that feeds the g @ W^T products.

// Rows per block of the weight-gradient GEMMs (a multiple of kBK).
constexpr int kChunkRows = 1024;

// Tiles of the weight-gradient product: two row-major [kBK, 64] slices.
template <typename T>
struct TnSmem {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLd = kBN + kVec;
  static constexpr int kLdC = kBN + 4;
  alignas(32) T a[kBK * kLd];
  alignas(32) T b[kBK * kLd];
  alignas(32) float c[kBM * kLdC];
};

// s.c[i][j] = sum over r in [r_begin, r_end) of a[r][na0 + i] * b[r][nb0 + j]
// (a^T @ b over a range of rows). a is [rows, ca], b is [rows, cb], both
// row-major; ca, cb are multiples of 64 and the range starts on a multiple
// of kBK. Rows at or beyond r_end read as zero.
template <typename T>
__device__ void gemm_tile_tn(const T* __restrict__ a, const T* __restrict__ b,
                             int ca, int cb, int r_begin, int r_end, int na0,
                             int nb0, TnSmem<T>& s) {
  using S = TnSmem<T>;
  constexpr int V = S::kVec;
  const int tid = threadIdx.x;

  auto load_tiles = [&](int r0) {
    for (int v = tid; v < kBK * kBM / V; v += kGemmThreads) {
      const int r = v / (kBM / V);
      const int col = (v % (kBM / V)) * V;
      uint4 va = make_uint4(0u, 0u, 0u, 0u);
      uint4 vb = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < r_end) {
        va = *reinterpret_cast<const uint4*>(
            a + static_cast<size_t>(r0 + r) * ca + na0 + col);
        vb = *reinterpret_cast<const uint4*>(
            b + static_cast<size_t>(r0 + r) * cb + nb0 + col);
      }
      *reinterpret_cast<uint4*>(&s.a[r * S::kLd + col]) = va;
      *reinterpret_cast<uint4*>(&s.b[r * S::kLd + col]) = vb;
    }
  };

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    const int warp = tid >> 5;
    const int wr = warp >> 1;
    const int wc = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
      load_tiles(r0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        // a's slice read column-major is the [64, kBK] slice of a^T
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &s.a[kk * S::kLd + wr * 32 + i * 16],
                                 S::kLd);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &s.b[kk * S::kLd + wc * 32 + j * 16],
                                 S::kLd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            &s.c[(wr * 32 + i * 16) * S::kLdC + wc * 32 + j * 16], acc[i][j],
            S::kLdC, wmma::mem_row_major);
  } else {
    const int tx = tid & 15;
    const int ty = tid >> 4;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
      load_tiles(r0);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f<T>(s.a[kk * S::kLd + ty * 8 + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f<T>(s.b[kk * S::kLd + tx * 4 + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s.c[(ty * 8 + i) * S::kLdC + tx * 4 + j] = acc[i][j];
  }
  __syncthreads();
}

// T: dst [cols, rows] = src [rows, cols]^T. Block (32, 8), grid
// (cols/32, rows/32); rows and cols are multiples of 32.
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ src,
                                 T* __restrict__ dst, int rows, int cols) {
  __shared__ T tile[32][33];
  const int c0 = blockIdx.x * 32;
  const int r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y)
    tile[i][threadIdx.x] =
        src[static_cast<size_t>(r0 + i) * cols + c0 + threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y)
    dst[static_cast<size_t>(c0 + i) * rows + r0 + threadIdx.x] =
        tile[threadIdx.x][i];
}

// Weight gradient, first pass: out_part[z] = a[rows of chunk z]^T @
// b[same rows].
// Grid (ca/kBM, cb/kBN, n_chunks).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b, int rows,
                 int ca, int cb, float* __restrict__ out_part) {
  using S = TnSmem<T>;
  __shared__ S s;
  const int na0 = blockIdx.x * kBM;
  const int nb0 = blockIdx.y * kBN;
  const int r_begin = blockIdx.z * kChunkRows;
  const int r_end = min(rows, r_begin + kChunkRows);
  gemm_tile_tn<T>(a, b, ca, cb, r_begin, r_end, na0, nb0, s);
  float* out = out_part + static_cast<size_t>(blockIdx.z) * ca * cb;
  for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
    const int i = e / kBN;
    const int j = e % kBN;
    out[static_cast<size_t>(na0 + i) * cb + nb0 + j] = s.c[i * S::kLdC + j];
  }
}

// Second pass: out[i] = sum over z of part[z][i], in order of z.
__global__ void reduce_chunks_kernel(const float* __restrict__ part,
                                     int n_chunks, int n,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double acc = 0.0;
  for (int z = 0; z < n_chunks; ++z) acc += part[static_cast<size_t>(z) * n + i];
  out[i] = static_cast<float>(acc);
}

// n rounded up to a multiple of a (workspace segments' alignment).
inline size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

// Returns the pending CUDA error, if any, from the enclosing launcher.
#define CTN_CHECK()                                   \
  do {                                                \
    cudaError_t err_ = cudaGetLastError();            \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

// Returns the error of a launcher call, if any, from the enclosing one.
#define CTN_TRY(...)                   \
  do {                                 \
    const int err_ = (__VA_ARGS__);    \
    if (err_ != 0) return err_;        \
  } while (0)

// The first design's block (tcn_block.cu's top note): prep, A, B, C.
template <typename T, int kNorm>
int launch_block_first(const Params& p, cudaStream_t stream) {
  long long n_a = 0, n_b = 0;
  part_counts(p.K, p.H, kNorm, &n_a, &n_b);
  out_weights_kernel<T><<<(p.B + 31) / 32, dim3(32, kPrepRowGroups), 0,
                          stream>>>(p);
  CTN_CHECK();
  const unsigned kt = (p.K + kBM - 1) / kBM;
  in_proj_kernel<T, kNorm, false>
      <<<dim3(kt, p.H / kBN, p.M), kGemmThreads, 0, stream>>>(p);
  CTN_CHECK();
  const unsigned rt = (p.K + kDwRows - 1) / kDwRows;
  const unsigned ct = (p.H + kDwThreads - 1) / kDwThreads;
  dwconv_kernel<T, kNorm, false><<<dim3(rt, ct, p.M), kDwThreads, 0, stream>>>(
      p, static_cast<int>(n_a));
  CTN_CHECK();
  out_proj_kernel<T><<<dim3(kt, p.B / kBN, p.M), kGemmThreads, 0, stream>>>(
      p, static_cast<int>(n_b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
