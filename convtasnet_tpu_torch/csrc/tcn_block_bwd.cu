// Backward of one Conv-TasNet TCN block with gLN (kernel B2) or cLN (kernel
// B3), for Hopper (sm_90a), bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/tcn_block_bwd.py::_bwd_kernel (gLN) and
// ::_bwd_kernel_cln (cLN), both behind fused_tcn_block_bwd. From the block
// input x and the cotangent g of the block output it returns dx and every
// weight gradient, recomputing the forward's intermediates from x (only x is
// saved, as jax.checkpoint does):
//
//   hp = x @ W_in;  h1 = PReLU_a1(hp);  hn1 = norm1(h1)
//   c  = depthwise_dilated_conv(hn1);   h2 = PReLU_a2(c);  hn2 = norm2(h2)
//   out = x + hn2 @ W_out
//
// What bounds it on the card. At the paper shape (M=8, K=3199, B=256,
// H=512) the five products (x W_in, g W_out^T, hn2^T g, dh_pre W_in^T,
// x^T dh_pre) are ~33 GFLOP, and the [K,H] intermediates are ~26 MB each
// per pass in bf16. The Pallas kernels keep one sample's [K,H] activations
// in VMEM across their passes; an SM has 227 KB of shared memory, so here
// every intermediate lives in device memory and each norm statistic or
// backward reduction that spans a whole sample (gLN) or a whole row of H
// channels (cLN) ends a launch:
//
//   T   W_in^T and W_out^T in the compute dtype (the GEMM tile reads its B
//       operand row-major), once per call.
//   R1  hp = x @ W_in (pre-activation, kept: a slope may be <= 0, so
//       PReLU cannot be inverted), partials of norm1's sums.     | F1 stats
//   R2  c = dwconv(norm1(PReLU(hp))) (pre-activation), partials. | F2 stats
//       R1 and R2 are the forward's launches A and B
//       (tcn_block_common.cuh) with kPre set, so the statistics follow the
//       forward's rule.
//   G1  e = g @ W_out^T; hn2 = norm2(PReLU(c)) for dW_out; partials of
//       t1 = sum g2*e, t2 = sum g2*e*hhat2; per-channel dg2, db2. | F3
//   E1  dc = rs2*(g2*e - t1/n - hhat2*t2/n) * PReLU'(c) over e in place;
//       per-channel da2 partials of dh2*min(c,0).
//   E2  dhn1[j] = sum_p dw[p] * dc[j - p*d + left] (taps outside [0,K)
//       dropped); per-channel d_dw[p] = sum dc[k]*hn1[k + p*d - left],
//       dg1, db1; partials of u1 = sum g1*dhn1, u2 = sum g1*dhn1*hhat1. | F4
//   G2  dh_pre = rs1*(g1*dhn1 - u1/n - hhat1*u2/n) * PReLU'(hp) over dhn1
//       in place; per-channel da1 partials; then dx = g + dh_pre @ W_in^T.
//   W   dW_out = hn2^T @ g and dW_in = x^T @ dh_pre over all M*K rows:
//       each block sums one chunk of kChunkRows rows into an f32 partial
//       tile, and a second launch adds the chunks in a fixed order.
//   S   per-channel partials summed in a fixed order, then da1, da2.
//
// gLN and cLN differ only in what a statistic spans, so every launch is a
// template on the norm. gLN: the sums of F1-F4 run over a sample's K*H
// elements (n = K*H), one (mean, rs, t1, t2, u1, u2) per sample. cLN: they
// run over one row's H channels (n = H), one set per row. A block of the
// GEMM launches sees 64 channels of a row and one of the depthwise launches
// 256, so each writes per-row partials per column tile (warp sums, added
// across the block's warps in a fixed order), and a row-finalize launch
// (finalize_rows_kernel) adds a row's partials in a fixed order into
// [M*K, kNumStats] per-row statistics that the next launches read. F1 and
// F2 take B1's row rule (row_stats: E[h^2]-mean^2 in double over its
// partials, rsqrt in f32, eps 1e-8) on the very partials B1 writes, so B1
// and B3 share their cLN statistics bit for bit. The causal halo needs no
// fill: a tap outside [0,K) is skipped, as in B1's launch B, so no
// statistic of a row outside the sample is ever read.
//
// As in the forward, nothing is summed with atomics: every tile writes its
// partial and a later launch adds them in a fixed order (in double), so two
// runs give the same bits. The statistics are the forward's, taken over
// the f32 PReLU outputs before rounding; the later passes normalise the
// stored compute-dtype values with them, as the forward's launches B and C
// do. Rows at or beyond K add nothing to any sum. The products are the
// shared tile of tcn_block_common.cuh plus a transposed-A variant for the
// weight gradients; no cp.async/TMA or wgmma yet, which is where speed would
// come from.

#include "tcn_block_common.cuh"

namespace {

// Elementwise and depthwise launches are tiled as the forward's launch B:
// one channel per thread, kDwRows rows per block, grid (ceil(K/kDwRows),
// ceil(H/kDwThreads), M).

// Statistics per sample (gLN) or per row (cLN), [M or M*K, kNumStats].
enum { kMean1, kRs1, kMean2, kRs2, kT1, kT2, kU1, kU2, kNumStats };

struct BwdParams {
  const void* x;       // [M, K, B]
  const void* g;       // [M, K, B]
  const void* w_in;    // [B, H]
  const void* dw;      // [P, H]
  const void* w_out;   // [H, B]
  const float* a1;
  const float* a2;
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  // compute-dtype workspace
  void* w_in_t;        // [H, B]
  void* w_out_t;       // [B, H]
  void* hp;            // [M, K, H] x @ W_in
  void* c;             // [M, K, H] dwconv output, pre-activation
  void* e;             // [M, K, H] g @ W_out^T, then dc
  void* hn2;           // [M, K, H] norm2 output
  void* dh;            // [M, K, H] dhn1, then dh_pre
  // f32 workspace
  float* stats;        // [M, kNumStats] (gLN) or [M * K, kNumStats] (cLN)
  float* part;         // (sum, sum) partials of one pass: [M, n_part, 2]
                       // (gLN) or [M * K, H / kBN, 2] (cLN)
  float* part2;        // R2's partials (R2 reads R1's in part)
  float* pch_g1;       // [M * kt, 2, H]: dg2, db2
  float* pch_e1;       // [M * rt, H]: da2
  float* pch_e2;       // [M * rt, P + 2, H]: d_dw[0..P-1], dg1, db1
  float* pch_g2;       // [M * rt, H]: da1
  float* wpart;        // [n_chunks, B * H]
  // outputs
  void* dx;            // [M, K, B] compute dtype
  float* dw_in;        // [B, H]
  float* dw_out;       // [H, B]
  float* aux;          // [P + 6, H] then 2: see the C interface below
  int M, K, B, H, P, dilation, left;
};

// The statistics row k of sample m reads.
template <int kNorm>
__device__ __forceinline__ const float* stat_row(const BwdParams& p, int m,
                                                 int k) {
  const size_t i = kNorm == kNormCLN ? static_cast<size_t>(m) * p.K + k
                                     : static_cast<size_t>(m);
  return p.stats + i * kNumStats;
}

// Where a block's (sum, sum) partial of a per-sample reduction goes (gLN).
__device__ __forceinline__ float* part_slot(float* part, int m) {
  const size_t n = static_cast<size_t>(gridDim.x) * gridDim.y;
  return part + 2 * (m * n + static_cast<size_t>(blockIdx.x) * gridDim.y +
                     blockIdx.y);
}

// Where row k's (sum, sum) partial of column tile blockIdx.y goes (cLN).
__device__ __forceinline__ float* row_slot(float* part, int K, int m, int k) {
  return part +
         2 * ((static_cast<size_t>(m) * K + k) * gridDim.y + blockIdx.y);
}

// F: per-sample scalars from one pass's partials (grid M). mode 0: the gLN
// mean and rs into slots (slot, slot + 1), by the forward's sample_stats
// (launched with the thread count of the forward launch that reads them,
// so the bits match); mode 1: the two sums divided by the element count.
__global__ void finalize_kernel(const float* __restrict__ part, int n_part,
                                double count, float* __restrict__ stats,
                                int slot, int mode) {
  __shared__ float s_st[2];
  const int m = blockIdx.x;
  const float* pm = part + 2 * static_cast<size_t>(m) * n_part;
  float* st = stats + static_cast<size_t>(m) * kNumStats;
  if (mode == 0) {
    sample_stats(pm, n_part, count, &s_st[0], &s_st[1]);
    if (threadIdx.x == 0) {
      st[slot] = s_st[0];
      st[slot + 1] = s_st[1];
    }
    return;
  }
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) {
    s1 += pm[2 * i];
    s2 += pm[2 * i + 1];
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    st[slot] = static_cast<float>(s1 / count);
    st[slot + 1] = static_cast<float>(s2 / count);
  }
}

// F, cLN: per-row scalars from n_part partials per row, one thread per row
// of the M*K. mode 0: the cLN mean and rs by the forward's row_stats;
// mode 1: the two sums divided by H.
__global__ void finalize_rows_kernel(const float* __restrict__ part,
                                     int n_part, int rows, int H,
                                     float* __restrict__ stats, int slot,
                                     int mode) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* pr = part + 2 * static_cast<size_t>(r) * n_part;
  float* st = stats + static_cast<size_t>(r) * kNumStats;
  if (mode == 0) {
    row_stats(pr, n_part, H, &st[slot], &st[slot + 1]);
    return;
  }
  double s1 = 0.0, s2 = 0.0;
  for (int j = 0; j < n_part; ++j) {
    s1 += pr[2 * j];
    s2 += pr[2 * j + 1];
  }
  st[slot] = static_cast<float>(s1 / H);
  st[slot + 1] = static_cast<float>(s2 / H);
}

// G1: e = g @ W_out^T, hn2, and the norm2 backward sums.
// Grid (ceil(K/kBM), H/kBN, M). Thread t owns column t % 64 of the tile and
// every other row from t / 64, so its per-channel sums need no shuffle; a
// row's (cLN) is the sum of two warps' shuffles.
template <typename T, int kNorm>
__global__ void __launch_bounds__(kGemmThreads) g1_kernel(BwdParams p) {
  using S = GemmSmem<T>;
  __shared__ S s;
  __shared__ float s_col[2][2][kBN];
  __shared__ float s_row[2][kGemmThreads / 32][kBM];
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = p.K, H = p.H;
  const T* g = static_cast<const T*>(p.g) + static_cast<size_t>(m) * K * p.B;
  gemm_tile<T>(g, static_cast<const T*>(p.w_out_t), K, p.B, H, r0, n0, s);
  const float a2 = *p.a2;
  const int col = threadIdx.x % kBN;
  const int half = threadIdx.x / kBN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = n0 + col;
  const float gam = p.g2[ch], bet = p.b2[ch];
  const T* c = static_cast<const T*>(p.c) + static_cast<size_t>(m) * K * H;
  T* e = static_cast<T*>(p.e) + static_cast<size_t>(m) * K * H;
  T* hn2 = static_cast<T*>(p.hn2) + static_cast<size_t>(m) * K * H;
  float t1 = 0.f, t2 = 0.f, dg = 0.f, db = 0.f;
  for (int r = half; r < kBM && r0 + r < K; r += 2) {
    const float* st = stat_row<kNorm>(p, m, r0 + r);
    const size_t idx = static_cast<size_t>(r0 + r) * H + ch;
    const float ev = round_to<T>(s.c[r * S::kLdC + col]);
    const float hh = (prelu(to_f<T>(c[idx]), a2) - st[kMean2]) * st[kRs2];
    e[idx] = from_f<T>(ev);
    hn2[idx] = from_f<T>(gam * hh + bet);
    dg += ev * hh;
    db += ev;
    if constexpr (kNorm == kNormCLN) {
      const float w1 = warp_sum(gam * ev);
      const float w2 = warp_sum(gam * ev * hh);
      if (lane == 0) {
        s_row[0][warp][r] = w1;
        s_row[1][warp][r] = w2;
      }
    } else {
      t1 += gam * ev;
      t2 += gam * ev * hh;
    }
  }
  s_col[0][half][col] = dg;
  s_col[1][half][col] = db;
  if constexpr (kNorm == kNormCLN) {
    __syncthreads();
    const int r = threadIdx.x;
    if (r < kBM && r0 + r < K) {
      const int w = 2 * (r & 1);   // the two warps of row r's half
      float* dst = row_slot(p.part, K, m, r0 + r);
      dst[0] = s_row[0][w][r] + s_row[0][w + 1][r];
      dst[1] = s_row[1][w][r] + s_row[1][w + 1][r];
    }
  } else {
    block_sum2(t1, t2);
    __syncthreads();
    if (threadIdx.x == 0) {
      float* dst = part_slot(p.part, m);
      dst[0] = t1;
      dst[1] = t2;
    }
  }
  if (threadIdx.x < kBN) {
    float* dst = p.pch_g1 +
        2 * (static_cast<size_t>(m) * gridDim.x + blockIdx.x) * H + n0 +
        threadIdx.x;
    dst[0] = s_col[0][0][threadIdx.x] + s_col[0][1][threadIdx.x];
    dst[H] = s_col[1][0][threadIdx.x] + s_col[1][1][threadIdx.x];
  }
}

// E1: dc = dh2 * PReLU'(c) over e in place, and per-channel da2 partials.
template <typename T, int kNorm>
__global__ void __launch_bounds__(kDwThreads) e1_kernel(BwdParams p) {
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kDwRows;
  const int ch = blockIdx.y * kDwThreads + threadIdx.x;
  const int K = p.K, H = p.H;
  if (ch >= H) return;
  const float a2 = *p.a2;
  const float gam = p.g2[ch];
  const T* c = static_cast<const T*>(p.c) + static_cast<size_t>(m) * K * H;
  T* e = static_cast<T*>(p.e) + static_cast<size_t>(m) * K * H;
  float da2 = 0.f;
  for (int i = 0; i < kDwRows && r0 + i < K; ++i) {
    const float* st = stat_row<kNorm>(p, m, r0 + i);
    const float rs2 = st[kRs2];
    const size_t idx = static_cast<size_t>(r0 + i) * H + ch;
    const float cv = to_f<T>(c[idx]);
    const float hh = (prelu(cv, a2) - st[kMean2]) * rs2;
    const float dh2 =
        rs2 * (gam * to_f<T>(e[idx]) - st[kT1] - hh * st[kT2]);
    da2 += dh2 * fminf(cv, 0.f);
    e[idx] = from_f<T>(cv >= 0.f ? dh2 : a2 * dh2);
  }
  p.pch_e1[(static_cast<size_t>(m) * gridDim.x + blockIdx.x) * H + ch] = da2;
}

// E2: the transposed dilated conv dhn1, d_dw, dg1/db1 and the norm1
// backward sums.
template <typename T, int kNorm>
__global__ void __launch_bounds__(kDwThreads) e2_kernel(BwdParams p) {
  __shared__ float s_row[2][kDwThreads / 32][kDwRows];
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kDwRows;
  const int ch = blockIdx.y * kDwThreads + threadIdx.x;
  const int K = p.K, H = p.H, P = p.P, d = p.dilation, left = p.left;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool active = ch < H;
  const float a1 = *p.a1;
  const T* hp = static_cast<const T*>(p.hp) + static_cast<size_t>(m) * K * H;
  const T* dc = static_cast<const T*>(p.e) + static_cast<size_t>(m) * K * H;
  const T* dw = static_cast<const T*>(p.dw);
  T* dhn1 = static_cast<T*>(p.dh) + static_cast<size_t>(m) * K * H;
  const float gam = active ? p.g1[ch] : 0.f;
  const float bet = active ? p.b1[ch] : 0.f;
  // gLN: hn1 = h1 * sc + sh for every row of the sample
  const float* st_m = stat_row<kNorm>(p, m, 0);
  const float sc = st_m[kRs1] * gam;
  const float sh = bet - st_m[kMean1] * sc;
  float ddw[kMaxTaps];
  for (int q = 0; q < P; ++q) ddw[q] = 0.f;
  float u1 = 0.f, u2 = 0.f, dg = 0.f, db = 0.f;
  for (int i = 0; i < kDwRows; ++i) {
    const int j = r0 + i;
    if (j >= K) break;
    float dn = 0.f, hh = 0.f;
    if (active) {
      const float dcj = to_f<T>(dc[static_cast<size_t>(j) * H + ch]);
      float acc = 0.f;
      for (int q = 0; q < P; ++q) {
        const int kk = j - q * d + left;   // output row that tap q of j fed
        if (kk >= 0 && kk < K)
          acc = fmaf(to_f<T>(dw[q * H + ch]),
                     to_f<T>(dc[static_cast<size_t>(kk) * H + ch]), acc);
        const int kh = j + q * d - left;   // input row tap q of j read
        if (kh >= 0 && kh < K) {
          const float h1 =
              prelu(to_f<T>(hp[static_cast<size_t>(kh) * H + ch]), a1);
          float hn;
          if constexpr (kNorm == kNormCLN) {
            const float* sk = stat_row<kNorm>(p, m, kh);
            hn = (h1 - sk[kMean1]) * sk[kRs1] * gam + bet;
          } else {
            hn = h1 * sc + sh;
          }
          ddw[q] = fmaf(dcj, hn, ddw[q]);
        }
      }
      dhn1[static_cast<size_t>(j) * H + ch] = from_f<T>(acc);
      dn = round_to<T>(acc);
      const float* sj = stat_row<kNorm>(p, m, j);
      hh = (prelu(to_f<T>(hp[static_cast<size_t>(j) * H + ch]), a1) -
            sj[kMean1]) * sj[kRs1];
      dg += dn * hh;
      db += dn;
    }
    if constexpr (kNorm == kNormCLN) {
      const float w1 = warp_sum(gam * dn);
      const float w2 = warp_sum(gam * dn * hh);
      if (lane == 0) {
        s_row[0][warp][i] = w1;
        s_row[1][warp][i] = w2;
      }
    } else {
      u1 += gam * dn;
      u2 += gam * dn * hh;
    }
  }
  if (active) {
    float* dst = p.pch_e2 +
        (static_cast<size_t>(m) * gridDim.x + blockIdx.x) * (P + 2) * H + ch;
    for (int q = 0; q < P; ++q) dst[static_cast<size_t>(q) * H] = ddw[q];
    dst[static_cast<size_t>(P) * H] = dg;
    dst[static_cast<size_t>(P + 1) * H] = db;
  }
  if constexpr (kNorm == kNormCLN) {
    __syncthreads();
    const int i = threadIdx.x;
    if (i < kDwRows && r0 + i < K) {
      float v1 = 0.f, v2 = 0.f;
      for (int w = 0; w < kDwThreads / 32; ++w) {
        v1 += s_row[0][w][i];
        v2 += s_row[1][w][i];
      }
      float* dst = row_slot(p.part, K, m, r0 + i);
      dst[0] = v1;
      dst[1] = v2;
    }
  } else {
    block_sum2(u1, u2);
    if (threadIdx.x == 0) {
      float* dst = part_slot(p.part, m);
      dst[0] = u1;
      dst[1] = u2;
    }
  }
}

// G2, first half: dh_pre = dh1 * PReLU'(hp) over dhn1 in place, and
// per-channel da1 partials.
template <typename T, int kNorm>
__global__ void __launch_bounds__(kDwThreads) g2a_kernel(BwdParams p) {
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kDwRows;
  const int ch = blockIdx.y * kDwThreads + threadIdx.x;
  const int K = p.K, H = p.H;
  if (ch >= H) return;
  const float a1 = *p.a1;
  const float gam = p.g1[ch];
  const T* hp = static_cast<const T*>(p.hp) + static_cast<size_t>(m) * K * H;
  T* dh = static_cast<T*>(p.dh) + static_cast<size_t>(m) * K * H;
  float da1 = 0.f;
  for (int i = 0; i < kDwRows && r0 + i < K; ++i) {
    const float* st = stat_row<kNorm>(p, m, r0 + i);
    const float rs1 = st[kRs1];
    const size_t idx = static_cast<size_t>(r0 + i) * H + ch;
    const float hv = to_f<T>(hp[idx]);
    const float hh = (prelu(hv, a1) - st[kMean1]) * rs1;
    const float dh1 =
        rs1 * (gam * to_f<T>(dh[idx]) - st[kU1] - hh * st[kU2]);
    da1 += dh1 * fminf(hv, 0.f);
    dh[idx] = from_f<T>(hv >= 0.f ? dh1 : a1 * dh1);
  }
  p.pch_g2[(static_cast<size_t>(m) * gridDim.x + blockIdx.x) * H + ch] = da1;
}

// G2, second half: dx = g + dh_pre @ W_in^T. Grid (ceil(K/kBM), B/kBN, M).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads) g2b_kernel(BwdParams p) {
  using S = GemmSmem<T>;
  __shared__ S s;
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = p.K, B = p.B;
  const T* dh = static_cast<const T*>(p.dh) + static_cast<size_t>(m) * K * p.H;
  gemm_tile<T>(dh, static_cast<const T*>(p.w_in_t), K, p.H, B, r0, n0, s);
  const T* g = static_cast<const T*>(p.g) + static_cast<size_t>(m) * K * B;
  T* dx = static_cast<T*>(p.dx) + static_cast<size_t>(m) * K * B;
  for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN;
    const int col = e % kBN;
    if (r0 + r >= K) continue;
    const size_t idx = static_cast<size_t>(r0 + r) * B + n0 + col;
    dx[idx] = from_f<T>(to_f<T>(g[idx]) + s.c[r * S::kLdC + col]);
  }
}

// S, first pass: per-channel sums of the partial rows, in a fixed order.
// aux rows: 0..P-1 d_dw, P dg1, P+1 db1, P+2 dg2, P+3 db2, P+4 da1 per
// channel, P+5 da2 per channel. Grid (ceil(H/32), P+6), block (32, 8): 32
// channels per block, and 8 row groups whose sums are added in order.
constexpr int kRedGroups = 8;

__global__ void __launch_bounds__(32 * kRedGroups)
    reduce_channels_kernel(BwdParams p, int kt, int rt) {
  __shared__ double s_sum[kRedGroups][32];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  const int q = blockIdx.y;
  const int H = p.H, P = p.P, M = p.M;
  // where row r of quantity q lives: src[r * stride + ch]
  const float* src;
  size_t stride;
  int rows;
  if (q < P + 2) {
    src = p.pch_e2 + static_cast<size_t>(q) * H;
    stride = static_cast<size_t>(P + 2) * H;
    rows = M * rt;
  } else if (q < P + 4) {
    src = p.pch_g1 + static_cast<size_t>(q - P - 2) * H;
    stride = 2 * static_cast<size_t>(H);
    rows = M * kt;
  } else {
    src = q == P + 4 ? p.pch_g2 : p.pch_e1;
    stride = H;
    rows = M * rt;
  }
  double acc = 0.0;
  if (ch < H)
    for (int r = threadIdx.y; r < rows; r += kRedGroups)
      acc += src[r * stride + ch];
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < H) {
    for (int y = 1; y < kRedGroups; ++y) acc += s_sum[y][threadIdx.x];
    p.aux[static_cast<size_t>(q) * H + ch] = static_cast<float>(acc);
  }
}

// S, second pass (one block): da1, da2 = sums over the channels.
__global__ void reduce_slopes_kernel(BwdParams p) {
  const int H = p.H, P = p.P;
  const float* row1 = p.aux + static_cast<size_t>(P + 4) * H;
  const float* row2 = p.aux + static_cast<size_t>(P + 5) * H;
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    s1 += row1[i];
    s2 += row2[i];
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    p.aux[static_cast<size_t>(P + 6) * H] = static_cast<float>(s1);
    p.aux[static_cast<size_t>(P + 6) * H + 1] = static_cast<float>(s2);
  }
}

// Workspace layout, shared by the size query and the launch. Every
// segment starts on a 256-byte boundary.
struct Layout {
  int kt, rt, ct, n_part, n_chunks;
  size_t act[7];   // w_in_t, w_out_t, hp, c, e, hn2, dh (elements)
  size_t f32[8];   // stats, part, part2, pch_g1, pch_e1, pch_e2, pch_g2,
                   // wpart
  size_t n_act, n_f32;
};

size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

Layout make_layout(int M, int K, int B, int H, int P, size_t act_bytes,
                   int norm) {
  Layout L;
  L.kt = (K + kBM - 1) / kBM;
  L.rt = (K + kDwRows - 1) / kDwRows;
  L.ct = (H + kDwThreads - 1) / kDwThreads;
  const long long rows = static_cast<long long>(M) * K;
  // partials per sample (gLN: one per tile) or per row (cLN: one per
  // column tile); part holds R1's, G1's and E2's, part2 R2's
  const bool cln = norm == kNormCLN;
  const size_t n_r1 = cln ? H / kBN : static_cast<size_t>(L.kt) * (H / kBN);
  const size_t n_dw = cln ? L.ct : static_cast<size_t>(L.rt) * L.ct;
  const size_t n_rows = cln ? static_cast<size_t>(rows) : M;
  L.n_part = static_cast<int>(n_r1 > n_dw ? n_r1 : n_dw);
  L.n_chunks = static_cast<int>((rows + kChunkRows - 1) / kChunkRows);
  const size_t mkh = static_cast<size_t>(M) * K * H;
  const size_t act_sizes[7] = {static_cast<size_t>(H) * B,
                               static_cast<size_t>(B) * H, mkh, mkh, mkh, mkh,
                               mkh};
  const size_t a_al = 256 / act_bytes;
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    L.act[i] = off;
    off += align_up(act_sizes[i], a_al);
  }
  L.n_act = off;
  const size_t f32_sizes[8] = {
      n_rows * kNumStats,
      2 * n_rows * L.n_part,
      2 * n_rows * n_dw,
      2 * static_cast<size_t>(M) * L.kt * H,
      static_cast<size_t>(M) * L.rt * H,
      static_cast<size_t>(M) * L.rt * (P + 2) * H,
      static_cast<size_t>(M) * L.rt * H,
      static_cast<size_t>(L.n_chunks) * B * H};
  off = 0;
  for (int i = 0; i < 8; ++i) {
    L.f32[i] = off;
    off += align_up(f32_sizes[i], 64);
  }
  L.n_f32 = off;
  return L;
}

template <typename T, int kNorm>
int launch_bwd(BwdParams p, void* ws_act, float* ws_f32, int causal,
               cudaStream_t stream) {
  static_assert(kNorm == kNormGLN || kNorm == kNormCLN, "gLN or cLN");
  constexpr bool kCln = kNorm == kNormCLN;
  const Layout L = make_layout(p.M, p.K, p.B, p.H, p.P, sizeof(T), kNorm);
  T* act = static_cast<T*>(ws_act);
  p.w_in_t = act + L.act[0];
  p.w_out_t = act + L.act[1];
  p.hp = act + L.act[2];
  p.c = act + L.act[3];
  p.e = act + L.act[4];
  p.hn2 = act + L.act[5];
  p.dh = act + L.act[6];
  p.stats = ws_f32 + L.f32[0];
  p.part = ws_f32 + L.f32[1];
  p.part2 = ws_f32 + L.f32[2];
  p.pch_g1 = ws_f32 + L.f32[3];
  p.pch_e1 = ws_f32 + L.f32[4];
  p.pch_e2 = ws_f32 + L.f32[5];
  p.pch_g2 = ws_f32 + L.f32[6];
  p.wpart = ws_f32 + L.f32[7];
  p.left = causal ? (p.P - 1) * p.dilation : ((p.P - 1) * p.dilation) / 2;
  const int M = p.M, K = p.K, B = p.B, H = p.H;
  const double count = static_cast<double>(K) * H;
  const dim3 gemm_h(L.kt, H / kBN, M);
  const dim3 gemm_b(L.kt, B / kBN, M);
  const dim3 rows(L.rt, L.ct, M);
  // cLN: the row finalisers, one thread per row of the M*K
  const int n_rows = M * K;
  const int fin_blocks = (n_rows + 255) / 256;

  transpose_kernel<T><<<dim3(H / 32, B / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(p.w_in), static_cast<T*>(p.w_in_t), B, H);
  CTN_CHECK();
  transpose_kernel<T><<<dim3(B / 32, H / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(p.w_out), static_cast<T*>(p.w_out_t), H, B);
  CTN_CHECK();
  // R1, R2: the forward's launches A and B, storing pre-activations
  Params fp = {};
  fp.x = p.x;
  fp.w_in = p.w_in;
  fp.dw = p.dw;
  fp.a1 = p.a1;
  fp.a2 = p.a2;
  fp.g1 = p.g1;
  fp.b1 = p.b1;
  fp.h = p.hp;
  fp.y = p.c;
  fp.part_a = p.part;
  fp.part_b = p.part2;
  fp.M = M;
  fp.K = K;
  fp.B = B;
  fp.H = H;
  fp.P = p.P;
  fp.dilation = p.dilation;
  fp.left = p.left;
  fp.norm = kNorm;
  // R1's partials per sample (gLN) or per row (cLN), as launch B reads them
  const int n_r1 = kCln ? gemm_h.y : gemm_h.x * gemm_h.y;
  in_proj_kernel<T, kNorm, true><<<gemm_h, kGemmThreads, 0, stream>>>(fp);
  CTN_CHECK();
  if constexpr (kCln) {
    dwconv_kernel<T, kNorm, true><<<rows, kDwThreads, 0, stream>>>(fp, n_r1);
    CTN_CHECK();
    // cLN1 as launch B reduces each row, cLN2 as launch C does
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part, n_r1, n_rows, H, p.stats, kMean1, 0);
    CTN_CHECK();
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part2, rows.y, n_rows, H, p.stats, kMean2, 0);
    CTN_CHECK();
  } else {
    // gLN1 as launch B reduces it (kDwThreads), gLN2 as launch C does
    finalize_kernel<<<M, kDwThreads, 0, stream>>>(p.part, n_r1, count,
                                                  p.stats, kMean1, 0);
    CTN_CHECK();
    dwconv_kernel<T, kNorm, true><<<rows, kDwThreads, 0, stream>>>(fp, n_r1);
    CTN_CHECK();
    finalize_kernel<<<M, kGemmThreads, 0, stream>>>(
        p.part2, rows.x * rows.y, count, p.stats, kMean2, 0);
    CTN_CHECK();
  }
  g1_kernel<T, kNorm><<<gemm_h, kGemmThreads, 0, stream>>>(p);
  CTN_CHECK();
  if constexpr (kCln)
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part, gemm_h.y, n_rows, H, p.stats, kT1, 1);
  else
    finalize_kernel<<<M, 256, 0, stream>>>(p.part, gemm_h.x * gemm_h.y,
                                           count, p.stats, kT1, 1);
  CTN_CHECK();
  // dW_out = hn2^T @ g needs only G1's output
  const int R = M * K;
  wgrad_kernel<T><<<dim3(H / kBM, B / kBN, L.n_chunks), kGemmThreads, 0,
                    stream>>>(static_cast<const T*>(p.hn2),
                              static_cast<const T*>(p.g), R, H, B, p.wpart);
  CTN_CHECK();
  reduce_chunks_kernel<<<(H * B + 255) / 256, 256, 0, stream>>>(
      p.wpart, L.n_chunks, H * B, p.dw_out);
  CTN_CHECK();
  e1_kernel<T, kNorm><<<rows, kDwThreads, 0, stream>>>(p);
  CTN_CHECK();
  e2_kernel<T, kNorm><<<rows, kDwThreads, 0, stream>>>(p);
  CTN_CHECK();
  if constexpr (kCln)
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part, rows.y, n_rows, H, p.stats, kU1, 1);
  else
    finalize_kernel<<<M, 256, 0, stream>>>(p.part, rows.x * rows.y, count,
                                           p.stats, kU1, 1);
  CTN_CHECK();
  g2a_kernel<T, kNorm><<<rows, kDwThreads, 0, stream>>>(p);
  CTN_CHECK();
  g2b_kernel<T><<<gemm_b, kGemmThreads, 0, stream>>>(p);
  CTN_CHECK();
  wgrad_kernel<T><<<dim3(B / kBM, H / kBN, L.n_chunks), kGemmThreads, 0,
                    stream>>>(static_cast<const T*>(p.x),
                              static_cast<const T*>(p.dh), R, B, H, p.wpart);
  CTN_CHECK();
  reduce_chunks_kernel<<<(H * B + 255) / 256, 256, 0, stream>>>(
      p.wpart, L.n_chunks, H * B, p.dw_in);
  CTN_CHECK();
  reduce_channels_kernel<<<dim3((H + 31) / 32, p.P + 6), dim3(32, kRedGroups),
                           0, stream>>>(p, L.kt, L.rt);
  CTN_CHECK();
  reduce_slopes_kernel<<<1, 256, 0, stream>>>(p);
  CTN_CHECK();
  return 0;
}

BwdParams make_bwd_params(const void* x, const void* g, const void* w_in,
                          const void* dw, const void* w_out, const void* a1,
                          const void* a2, const void* g1, const void* b1,
                          const void* g2, const void* b2, void* dx,
                          void* dw_in, void* dw_out, void* aux, int M, int K,
                          int B, int H, int P, int dilation) {
  BwdParams p = {};
  p.x = x;
  p.g = g;
  p.w_in = w_in;
  p.dw = dw;
  p.w_out = w_out;
  p.a1 = static_cast<const float*>(a1);
  p.a2 = static_cast<const float*>(a2);
  p.g1 = static_cast<const float*>(g1);
  p.b1 = static_cast<const float*>(b1);
  p.g2 = static_cast<const float*>(g2);
  p.b2 = static_cast<const float*>(b2);
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
  return p;
}

}  // namespace

#define CTN_BWD_ARGS                                                        \
  const void *x, const void *g, const void *w_in, const void *dw,          \
      const void *w_out, const void *a1, const void *a2, const void *g1,   \
      const void *b1, const void *g2, const void *b2, void *ws_act,        \
      void *ws_f32, void *dx, void *dw_in, void *dw_out, void *aux, int M, \
      int K, int B, int H, int P, int dilation, int causal, void *stream
#define CTN_BWD_CALL                                                       \
  make_bwd_params(x, g, w_in, dw, w_out, a1, a2, g1, b1, g2, b2, dx, dw_in, \
                  dw_out, aux, M, K, B, H, P, dilation),                  \
      ws_act, static_cast<float*>(ws_f32), causal,                        \
      static_cast<cudaStream_t>(stream)

extern "C" {

// Workspace the backward needs for norm (0 gLN, 1 cLN): n_act elements of
// the compute dtype (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats.
int ctn_tcn_block_bwd_workspace(int M, int K, int B, int H, int P,
                                int elem_bytes, int norm, long long* n_act,
                                long long* n_f32) {
  const Layout L = make_layout(M, K, B, H, P, elem_bytes, norm);
  *n_act = static_cast<long long>(L.n_act);
  *n_f32 = static_cast<long long>(L.n_f32);
  return 0;
}

// Backward of one gLN block (B2, ctn_tcn_block_bwd_*) or cLN block (B3,
// ctn_tcn_block_bwd_cln_*); every pointer is device memory, `stream` is a
// cudaStream_t. x, g, w_in, dw, w_out and dx are in the compute dtype; the
// slopes, norm affines and every other output are f32: dw_in [B,H],
// dw_out [H,B], and aux [(P+6)*H + 2] = d_dw [P,H], dg1, db1, dg2, db2,
// per-channel da1 and da2 parts [H] each, then da1 and da2. Returns
// cudaGetLastError() after the launches.
int ctn_tcn_block_bwd_f32(CTN_BWD_ARGS) {
  return launch_bwd<float, kNormGLN>(CTN_BWD_CALL);
}

int ctn_tcn_block_bwd_bf16(CTN_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16, kNormGLN>(CTN_BWD_CALL);
}

int ctn_tcn_block_bwd_cln_f32(CTN_BWD_ARGS) {
  return launch_bwd<float, kNormCLN>(CTN_BWD_CALL);
}

int ctn_tcn_block_bwd_cln_bf16(CTN_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16, kNormCLN>(CTN_BWD_CALL);
}

}  // extern "C"
