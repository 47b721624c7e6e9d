// The TCN block backward's first design (tcn_block_bwd.cu: B2 for gLN, B3
// for cLN; f32 and the bf16 widths the Hopper stages do not take): the
// parameters, the statistic finalisers and the launches T, R1, R2, G1, E1,
// E2, G2a, G2b and the channel reductions, each described in
// tcn_block_bwd.cu's top note. The bf16 stages (tcn_block_bwd_hopper.cuh)
// share the parameters, finalisers and reductions.

#pragma once

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

// G1's epilogue for tile (bx, by) of sample m of a grid of n_bx row tiles
// by n_by column tiles, its product e = g @ W_out^T in s.c: e, hn2, and the
// norm2 backward sums. Thread t owns column t % 64 of the tile and every
// other row from t / 64, so its per-channel sums need no shuffle; a row's
// (cLN) is the sum of two warps' shuffles.
template <typename T, int kNorm>
__device__ void g1_epilogue(const BwdParams& p, GemmSmem<T>& s, int m, int bx,
                            int by, int n_bx, int n_by) {
  using S = GemmSmem<T>;
  __shared__ float s_col[2][2][kBN];
  __shared__ float s_row[2][kGemmThreads / 32][kBM];
  const int r0 = bx * kBM;
  const int n0 = by * kBN;
  const int K = p.K, H = p.H;
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
      float* dst = p.part +
          2 * ((static_cast<size_t>(m) * K + r0 + r) * n_by + by);
      dst[0] = s_row[0][w][r] + s_row[0][w + 1][r];
      dst[1] = s_row[1][w][r] + s_row[1][w + 1][r];
    }
  } else {
    block_sum2(t1, t2);
    __syncthreads();
    if (threadIdx.x == 0) {
      float* dst = p.part +
          2 * ((static_cast<size_t>(m) * n_bx + bx) * n_by + by);
      dst[0] = t1;
      dst[1] = t2;
    }
  }
  if (threadIdx.x < kBN) {
    float* dst = p.pch_g1 + 2 * (static_cast<size_t>(m) * n_bx + bx) * H +
                 n0 + threadIdx.x;
    dst[0] = s_col[0][0][threadIdx.x] + s_col[0][1][threadIdx.x];
    dst[H] = s_col[1][0][threadIdx.x] + s_col[1][1][threadIdx.x];
  }
  __syncthreads();   // s_col, s_row and s.c are read; the next tile may reuse them
}

// G1: e = g @ W_out^T, hn2, and the norm2 backward sums.
// Grid (ceil(K/kBM), H/kBN, M).
template <typename T, int kNorm>
__global__ void __launch_bounds__(kGemmThreads) g1_kernel(BwdParams p) {
  __shared__ GemmSmem<T> s;
  const int m = blockIdx.z;
  const T* g = static_cast<const T*>(p.g) + static_cast<size_t>(m) * p.K * p.B;
  gemm_tile<T>(g, static_cast<const T*>(p.w_out_t), p.K, p.B, p.H,
               blockIdx.x * kBM, blockIdx.y * kBN, s);
  g1_epilogue<T, kNorm>(p, s, m, blockIdx.x, blockIdx.y, gridDim.x,
                        gridDim.y);
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

// G2b's epilogue for the tile at rows r0, columns n0 of sample m, its
// product dh_pre @ W_in^T in s.c: dx = g + that, rounded.
template <typename T>
__device__ void g2b_epilogue(const BwdParams& p, const GemmSmem<T>& s, int m,
                             int r0, int n0) {
  using S = GemmSmem<T>;
  const int K = p.K, B = p.B;
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

// G2, second half: dx = g + dh_pre @ W_in^T. Grid (ceil(K/kBM), B/kBN, M).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads) g2b_kernel(BwdParams p) {
  __shared__ GemmSmem<T> s;
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const T* dh = static_cast<const T*>(p.dh) + static_cast<size_t>(m) * p.K * p.H;
  gemm_tile<T>(dh, static_cast<const T*>(p.w_in_t), p.K, p.H, p.B, r0, n0, s);
  g2b_epilogue<T>(p, s, m, r0, n0);
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

// The stages of one block's backward, in tcn_block_bwd.cu's order, on the
// workspace p points at (p.left set).

inline int row_tiles(int K) { return (K + kBM - 1) / kBM; }
inline int dw_row_tiles(int K) { return (K + kDwRows - 1) / kDwRows; }
inline int dw_col_tiles(int H) { return (H + kDwThreads - 1) / kDwThreads; }

// T: W_in^T and W_out^T in the compute dtype.
template <typename T>
int launch_transposes(const BwdParams& p, cudaStream_t stream) {
  const int B = p.B, H = p.H;
  transpose_kernel<T><<<dim3(H / 32, B / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(p.w_in), static_cast<T*>(p.w_in_t), B, H);
  CTN_CHECK();
  transpose_kernel<T><<<dim3(B / 32, H / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(p.w_out), static_cast<T*>(p.w_out_t), H, B);
  CTN_CHECK();
  return 0;
}

// R1, R2 and their finalisers: hp, c and the norm statistics (F1, F2).
template <typename T, int kNorm>
int recompute_block(const BwdParams& p, cudaStream_t stream) {
  constexpr bool kCln = kNorm == kNormCLN;
  const int M = p.M, K = p.K, H = p.H;
  const double count = static_cast<double>(K) * H;
  const dim3 gemm_h(row_tiles(K), H / kBN, M);
  const dim3 rows(dw_row_tiles(K), dw_col_tiles(H), M);
  // cLN: the row finalisers, one thread per row of the M*K
  const int n_rows = M * K;
  const int fin_blocks = (n_rows + 255) / 256;
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
  fp.B = p.B;
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
  return 0;
}

// After G1: F3, dW_out = hn2^T @ g, E1, E2, F4, G2a.
template <typename T, int kNorm>
int block_bwd_middle(const BwdParams& p, int n_chunks, cudaStream_t stream) {
  constexpr bool kCln = kNorm == kNormCLN;
  const int M = p.M, K = p.K, B = p.B, H = p.H;
  const double count = static_cast<double>(K) * H;
  const dim3 gemm_h(row_tiles(K), H / kBN, M);
  const dim3 rows(dw_row_tiles(K), dw_col_tiles(H), M);
  const int n_rows = M * K;
  const int fin_blocks = (n_rows + 255) / 256;
  if constexpr (kCln)
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part, gemm_h.y, n_rows, H, p.stats, kT1, 1);
  else
    finalize_kernel<<<M, 256, 0, stream>>>(p.part, gemm_h.x * gemm_h.y,
                                           count, p.stats, kT1, 1);
  CTN_CHECK();
  // dW_out = hn2^T @ g needs only G1's output
  const int R = M * K;
  wgrad_kernel<T><<<dim3(H / kBM, B / kBN, n_chunks), kGemmThreads, 0,
                    stream>>>(static_cast<const T*>(p.hn2),
                              static_cast<const T*>(p.g), R, H, B, p.wpart);
  CTN_CHECK();
  reduce_chunks_kernel<<<(H * B + 255) / 256, 256, 0, stream>>>(
      p.wpart, n_chunks, H * B, p.dw_out);
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
  return 0;
}

// After G2a (before or after G2b, which it does not touch): dW_in = x^T @
// dh_pre, then the per-channel sums and the slopes into p.aux (S).
template <typename T>
int block_bwd_tail(const BwdParams& p, int n_chunks, cudaStream_t stream) {
  const int B = p.B, H = p.H;
  const int R = p.M * p.K;
  wgrad_kernel<T><<<dim3(B / kBM, H / kBN, n_chunks), kGemmThreads, 0,
                    stream>>>(static_cast<const T*>(p.x),
                              static_cast<const T*>(p.dh), R, B, H, p.wpart);
  CTN_CHECK();
  reduce_chunks_kernel<<<(H * B + 255) / 256, 256, 0, stream>>>(
      p.wpart, n_chunks, H * B, p.dw_in);
  CTN_CHECK();
  reduce_channels_kernel<<<dim3((H + 31) / 32, p.P + 6), dim3(32, kRedGroups),
                           0, stream>>>(p, row_tiles(p.K), dw_row_tiles(p.K));
  CTN_CHECK();
  reduce_slopes_kernel<<<1, 256, 0, stream>>>(p);
  CTN_CHECK();
  return 0;
}

}  // namespace
