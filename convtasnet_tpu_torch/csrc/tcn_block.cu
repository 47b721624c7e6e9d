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
// depth 32, 4 warps): WMMA bf16 tensor-core fragments with f32 accumulation
// for bf16, FMA for f32. It is written for correctness first: there is no
// cp.async/TMA pipelining and no wgmma yet, so the products run well below
// the card's tensor-core rate; A and C also re-read x (or y) once per column
// tile. Those are the next steps when this kernel is made fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNormGLN = 0;
constexpr int kNormCLN = 1;
constexpr int kNormBN = 2;
constexpr float kEps = 1e-8f;     // gLN / cLN: eps added to the variance
constexpr float kBnEps = 1e-5f;   // BatchNorm1d default

// GEMM tiling (launches A and C).
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 128;
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

// s.c[0:kBM, 0:kBN] = act[r0:r0+kBM, :] @ w[:, n0:n0+kBN], rows of act at
// or beyond `rows` read as zero. act is [rows, depth] row-major, w is
// [depth, cols] row-major; depth % kBK == 0 and cols % kBN == 0 (checked by
// the wrapper).
template <typename T>
__device__ void gemm_tile(const T* __restrict__ act, const T* __restrict__ w,
                          int rows, int depth, int cols, int r0, int n0,
                          GemmSmem<T>& s) {
  using S = GemmSmem<T>;
  constexpr int V = S::kVec;
  const int tid = threadIdx.x;

  auto load_tiles = [&](int k0) {
    for (int v = tid; v < kBM * kBK / V; v += kGemmThreads) {
      const int r = v / (kBK / V);
      const int c = (v % (kBK / V)) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows)
        val = *reinterpret_cast<const uint4*>(
            act + static_cast<size_t>(r0 + r) * depth + k0 + c);
      *reinterpret_cast<uint4*>(&s.a[r * S::kLdA + c]) = val;
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
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &s.a[(wr * 32 + i * 16) * S::kLdA + kk],
                                 S::kLdA);
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
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f<T>(s.a[(ty * 8 + i) * S::kLdA + kk]);
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

// Launch A: h = PReLU(x @ W_in) and norm1's partial sums.
// Grid (ceil(K/kBM), H/kBN, M).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads) in_proj_kernel(Params p) {
  using S = GemmSmem<T>;
  __shared__ S s;
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(m) * p.K * p.B;
  gemm_tile<T>(x, static_cast<const T*>(p.w_in), p.K, p.B, p.H, r0, n0, s);
  const float a1 = *p.a1;
  T* h = static_cast<T*>(p.h) + static_cast<size_t>(m) * p.K * p.H;
  float s1 = 0.f, s2 = 0.f;
  for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN;
    const int c = e % kBN;
    float v = 0.f;
    if (r0 + r < p.K) {
      v = prelu(s.c[r * S::kLdC + c], a1);
      h[static_cast<size_t>(r0 + r) * p.H + n0 + c] = from_f<T>(v);
    }
    s1 += v;
    s2 += v * v;
    s.c[r * S::kLdC + c] = v;
  }
  if (p.norm == kNormGLN) {
    block_sum2(s1, s2);
    if (threadIdx.x == 0) {
      float* dst = p.part_a +
          2 * ((static_cast<size_t>(m) * gridDim.x + blockIdx.x) * gridDim.y +
               blockIdx.y);
      dst[0] = s1;
      dst[1] = s2;
    }
  } else if (p.norm == kNormCLN) {
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
          2 * ((static_cast<size_t>(m) * p.K + r0 + r) * gridDim.y + blockIdx.y);
      dst[0] = t1;
      dst[1] = t2;
    }
  }
}

// Launch B: norm1 + dilated depthwise conv + PReLU, and norm2's partials.
// Grid (ceil(K/kDwRows), ceil(H/kDwThreads), M); n_part_a is the number of
// launch-A partials per sample (gLN) or per row (cLN).
template <typename T>
__global__ void __launch_bounds__(kDwThreads) dwconv_kernel(Params p,
                                                            int n_part_a) {
  __shared__ float s_mu[kMaxTaps * kDwRows];
  __shared__ float s_rs[kMaxTaps * kDwRows];
  __shared__ float s_row[2][kDwThreads / 32][kDwRows];
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kDwRows;
  const int c = blockIdx.y * kDwThreads + threadIdx.x;
  const int K = p.K, H = p.H, P = p.P, d = p.dilation;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (p.norm == kNormGLN) {
    sample_stats(p.part_a + 2 * static_cast<size_t>(m) * n_part_a, n_part_a,
                 static_cast<double>(K) * H, &s_mu[0], &s_rs[0]);
  } else if (p.norm == kNormCLN) {
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
  const float a2 = *p.a2;
  const bool active = c < H;
  // per-channel scale/shift of norm1 (gLN, BN)
  float sc = 1.f, sh = 0.f, g = 1.f, b = 0.f;
  if (active) {
    g = p.g1[c];
    b = p.b1[c];
    if (p.norm == kNormGLN) {
      sc = s_rs[0] * g;
      sh = b - s_mu[0] * sc;
    } else if (p.norm == kNormBN) {
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
        const float hv = to_f<T>(h[static_cast<size_t>(kk) * H + c]);
        const float hn = p.norm == kNormCLN
            ? (hv - s_mu[q * kDwRows + i]) * s_rs[q * kDwRows + i] * g + b
            : hv * sc + sh;
        acc = fmaf(to_f<T>(dw[q * H + c]), hn, acc);
      }
      v = prelu(acc, a2);
      y[static_cast<size_t>(k) * H + c] = from_f<T>(v);
    }
    if (p.norm == kNormGLN) {
      t1 += v;
      t2 += v * v;
    } else if (p.norm == kNormCLN) {
      const float w1 = warp_sum(v);
      const float w2 = warp_sum(v * v);
      if (lane == 0) {
        s_row[0][warp][i] = w1;
        s_row[1][warp][i] = w2;
      }
    }
  }
  if (p.norm == kNormGLN) {
    block_sum2(t1, t2);
    if (threadIdx.x == 0) {
      float* dst = p.part_b +
          2 * ((static_cast<size_t>(m) * gridDim.x + blockIdx.x) * gridDim.y +
               blockIdx.y);
      dst[0] = t1;
      dst[1] = t2;
    }
  } else if (p.norm == kNormCLN) {
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

// Before launch A: W_eff = diag(g) W_out and its column sums (see the top
// note). Block (32 columns) x (kPrepRowGroups row groups); grid B/32.
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

// Launch C: out = x + rs*((y*g) @ W_out - mu*(g @ W_out)) + b @ W_out.
// Grid (ceil(K/kBM), B/kBN, M); n_part_b as n_part_a above, for launch B.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads) out_proj_kernel(Params p,
                                                                int n_part_b) {
  using S = GemmSmem<T>;
  __shared__ S s;
  __shared__ float s_mu[kBM];
  __shared__ float s_rs[kBM];
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = p.K, H = p.H, B = p.B;

  if (p.norm == kNormGLN) {
    sample_stats(p.part_b + 2 * static_cast<size_t>(m) * n_part_b, n_part_b,
                 static_cast<double>(K) * H, &s_mu[0], &s_rs[0]);
    const float mu = s_mu[0], rs = s_rs[0];
    __syncthreads();
    for (int r = threadIdx.x; r < kBM; r += kGemmThreads) {
      s_mu[r] = mu;
      s_rs[r] = rs;
    }
  } else if (p.norm == kNormCLN) {
    for (int r = threadIdx.x; r < kBM; r += kGemmThreads) {
      if (r0 + r < K)
        row_stats(p.part_b + 2 * (static_cast<size_t>(m) * K + r0 + r) * n_part_b,
                  n_part_b, H, &s_mu[r], &s_rs[r]);
    }
  } else {
    for (int r = threadIdx.x; r < kBM; r += kGemmThreads) {
      s_mu[r] = 0.f;
      s_rs[r] = 1.f;
    }
  }
  __syncthreads();

  const T* y = static_cast<const T*>(p.y) + static_cast<size_t>(m) * K * H;
  gemm_tile<T>(y, static_cast<const T*>(p.w_eff), K, H, B, r0, n0, s);
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

int part_counts(int K, int H, int norm, long long* n_a, long long* n_b) {
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

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  long long n_a = 0, n_b = 0;
  part_counts(p.K, p.H, p.norm, &n_a, &n_b);
  out_weights_kernel<T><<<(p.B + 31) / 32, dim3(32, kPrepRowGroups), 0,
                          stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned kt = (p.K + kBM - 1) / kBM;
  in_proj_kernel<T><<<dim3(kt, p.H / kBN, p.M), kGemmThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned rt = (p.K + kDwRows - 1) / kDwRows;
  const unsigned ct = (p.H + kDwThreads - 1) / kDwThreads;
  dwconv_kernel<T><<<dim3(rt, ct, p.M), kDwThreads, 0, stream>>>(
      p, static_cast<int>(n_a));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  out_proj_kernel<T><<<dim3(kt, p.B / kBN, p.M), kGemmThreads, 0, stream>>>(
      p, static_cast<int>(n_b));
  return static_cast<int>(cudaGetLastError());
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
