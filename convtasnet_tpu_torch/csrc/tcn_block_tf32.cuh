// The f32 TCN block forward's launches on the 3xTF32 product core
// (hopper_gemm_tf32.cuh), which the f32 gLN backward (tcn_block_bwd_tf32.cuh)
// reruns: the prep launch, launch A' (the input product), launch B' (the
// depthwise conv, y stored) and launch C' (the output product), for f32
// blocks at wg_widths_ok; then launch_block, which picks a block's design by
// its dtype and widths. tcn_block.cu's top note says what they replace.
//
// The stages are the bf16 ones' (tcn_block_hopper.cuh) rebuilt for f32,
// and shared memory decides what changes. C''s bf16 design keeps a 128-row y
// tile resident as the left operand (128 KB at H = 512); in f32 that tile is
// 256 KB, past the 227 KB a CTA has, before any right operand. So here y is
// stored once by B' (52 MB at the paper shape, ~16 us at the card's memory
// rate) and every product streams both operands through one ring of 32-deep
// slabs (rows_tf32_run, TMA-fed): per slab a 16 KB left panel (128 rows)
// and the weight's hi and lo panels (2 x BN lines), 48 KB at BN = 128,
// four slabs 192 KB. Nothing else is resident: the column sums and norm
// statistics C' reads take 4.5 KB more.
//
//   prep  once per call, over the whole card: W_in^T and W_eff^T = (diag(g)
//         W_out)^T as K-major tf32 hi and lo copies (the right operands),
//         with g norm2's per-channel scale (for BN the running statistics
//         folded in), and per 64-row block partials of the column sums g @
//         W_out and b @ W_out (prep_tf32_kernel).
//   A'    h = PReLU(x @ W_in) in f32, and norm1's statistics: gLN a partial
//         sum per 128-row tile, cLN each row's (mean, rs) (the CTA walks all
//         H columns of its rows), none for BN.
//   B'    y = PReLU_a2(dwconv(norm1(h))) in f32 to device memory, on the
//         bf16 stages' depthwise walk (8 channels a thread) with 32-byte
//         loads, and norm2's partial sums: gLN one per 128-row tile, cLN one
//         per row and segment of 32 lanes. cLN's norm1 takes each tap
//         row's (mean, rs) from device memory as A' wrote them, one load a
//         tap, so any P and dilation fit (no halo in shared memory:
//         kHaloDev's way in the bf16 C').
//   C'    out = x + rs2 * (y @ W_eff - mu2 * (g @ W_out)) + b @ W_out: the
//         first design's fold for every norm (mu2, rs2 the sample's for gLN,
//         the row's for cLN, 0 and 1 for BN), y streamed from device memory.
//
// The two products take most of the block's time, held as
// hopper_gemm_tf32.cuh's note says; each launch's device time is in
// PERF.md. Registers (nvcc -Xptxas -v, sm_90a, scripts/ptxas_vs_parent.py):
// A' and C' 183 at BN = 128, 119-127 at 64; B' 222-228; the prep 32; no
// spills. Shared memory: A' 193 KB (the ring), C' 195 KB (with the column
// sums), one CTA an SM.

#pragma once

#include "hopper_gemm_tf32.cuh"
#include "tcn_block_hopper.cuh"

namespace {

// Whether a block of these widths in a compute dtype of elem_bytes runs
// the f32 stages of this file (f32 at wg_widths_ok).
inline bool runs_tf32(int B, int H, size_t elem_bytes) {
  return elem_bytes == 4 && wg_widths_ok(B, H);
}

// Elements of the compute dtype a forward's w_eff buffer holds: W_eff for
// the first design and the bf16 stages; for these W_in^T and W_eff^T, each
// as a tf32 hi and lo copy (prep_tf32_kernel).
inline size_t weights_elems(int B, int H, size_t elem_bytes) {
  return static_cast<size_t>(runs_tf32(B, H, elem_bytes) ? 4 : 1) * H * B;
}

constexpr int kTf32Stages = 4;   // every row-tile stage's ring depth

// 8 floats at p (32-byte aligned) through the read-only path, and back.
__device__ __forceinline__ void ldg8f(const float* p, float (&f)[8]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
}
__device__ __forceinline__ void st8f(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The weights the f32 stages read, each K-major [N, D] as a tf32 hi copy
// and a lo copy of N * D floats (split_tf32), written once per call. Block
// (32, 8) over 32 columns x 64 rows of B x H; grid (B / 32, H / 64, 2),
// blockIdx.z the job:
//   forward (bwd 0): z = 0: W_in^T [H, B] at ws;
//          z = 1: W_eff^T [B, H] at ws + 2 B H, W_eff = diag(g) W_out with g
//          norm2's per-channel scale (for BN the running statistics folded
//          in), and per 64-row block rb partials of the column sums g @
//          W_out, b @ W_out at wsum[(2 rb) B + n], wsum[(2 rb + 1) B + n]
//          (C' adds the H / 64 in order);
//   backward (bwd 1): z = 0: W_in^T [H, B] at ws and W_in [B, H] at
//          ws + 4 B H; z = 1: W_out [H, B] at ws + 2 B H.
// A 32 x 64 tile passes through shared memory, so that both the read of a
// weight and the write of its transpose run along rows.
__global__ void __launch_bounds__(256) prep_tf32_kernel(
    const float* __restrict__ w_in, const float* __restrict__ w_out,
    const float* __restrict__ g2, const float* __restrict__ b2,
    const float* __restrict__ m2, const float* __restrict__ v2, int norm,
    int B, int H, int bwd, float* __restrict__ ws, float* __restrict__ wsum) {
  __shared__ float tile[64][33];
  __shared__ float s_sum[2][8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b0 = blockIdx.x * 32, h0 = blockIdx.y * kSlabK;
  const size_t hb = static_cast<size_t>(H) * B;
  auto put = [&](float* dst, size_t idx, float v) {   // hi at idx, lo + hb
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    dst[idx] = __uint_as_float(hi);
    dst[hb + idx] = __uint_as_float(lo);
  };
  if (blockIdx.z == 0) {   // W_in [B, H]: rows b0.., columns h0..
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = ty + 8 * j, c = tx + 32 * u;
        const size_t idx = static_cast<size_t>(b0 + i) * H + h0 + c;
        tile[c][i] = w_in[idx];
        if (bwd) put(ws + 4 * hb, idx, tile[c][i]);
      }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = ty + 8 * j;
      put(ws, static_cast<size_t>(h0 + c) * B + b0 + tx, tile[c][tx]);
    }
    return;
  }
  // W_out [H, B]: rows h0.., columns b0..
  const bool bn = norm == kNormBN;
  float gw = 0.f, bw = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = h0 + ty + 8 * j;
    const size_t idx = static_cast<size_t>(r) * B + b0 + tx;
    const float wv = w_out[idx];
    if (bwd) {
      put(ws + 2 * hb, idx, wv);
      continue;
    }
    const float g = bn ? g2[r] * rsqrtf(v2[r] + kBnEps) : g2[r];
    const float we = wv * g;
    tile[ty + 8 * j][tx] = we;
    gw += we;
    bw = fmaf(bn ? b2[r] - m2[r] * g : b2[r], wv, bw);
  }
  if (bwd) return;
  s_sum[0][ty][tx] = gw;
  s_sum[1][ty][tx] = bw;
  __syncthreads();
  if (ty == 0) {
    for (int y = 1; y < 8; ++y) {
      gw += s_sum[0][y][tx];
      bw += s_sum[1][y][tx];
    }
    wsum[(2 * blockIdx.y) * B + b0 + tx] = gw;
    wsum[(2 * blockIdx.y + 1) * B + b0 + tx] = bw;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = ty + 8 * j, c = tx + 32 * u;
      put(ws + 2 * hb, static_cast<size_t>(b0 + i) * H + h0 + c, tile[c][i]);
    }
}

// The prep launch at ws (the forward's weights_elems floats, or the
// backward's 6 B H).
inline int launch_prep_tf32(const Params& p, float* ws, int bwd,
                            cudaStream_t stream) {
  prep_tf32_kernel<<<dim3(p.B / 32, p.H / kSlabK, 2), dim3(32, 8), 0,
                     stream>>>(
      static_cast<const float*>(p.w_in), static_cast<const float*>(p.w_out),
      p.g2, p.b2, p.m2, p.v2, p.norm, p.B, p.H, bwd, ws, p.wsum);
  return static_cast<int>(cudaGetLastError());
}

// Launch A': h = PReLU(x @ W_in) (kPre: x @ W_in) in f32 for rows [r0, r0 +
// 128) of sample blockIdx.y, all H columns (maps: x, W_in^T's split), and
// norm1's statistics over the f32 PReLU outputs: gLN one (sum, sum of
// squares) partial per CTA at part_a[m * gridDim.x + blockIdx.x]; cLN each row's (mean, rs) at part_a[m * K + row], by
// row_stats from its whole sums (its thread's over the column tiles in
// order, then the row's four lanes'); none for BN. The epilogue
// stores each thread's column pairs straight from the accumulators (8-byte
// stores, whole 32-byte sectors over a quad of lanes). Grid (ceil(K /
// 128), M), block 256.
template <int BN, bool kPre>
__global__ void __launch_bounds__(kWgCta)
    in_proj_tf32_kernel(const __grid_constant__ RowsMaps maps, Params p) {
  extern __shared__ uint8_t wg_smem[];
  const int K = p.K, B = p.B, H = p.H;
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  float* h = static_cast<float*>(p.h) + static_cast<size_t>(m) * K * H;
  const float a1 = *p.a1;
  float s1 = 0.f, s2 = 0.f;
  float rsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // cLN: the thread's rows
  rows_tf32_run<BN, kTf32Stages>(
      wg_smem, align_1024(wg_smem), maps, m, r0, B, H,
      [&](float (&acc)[BN / 2], int n0) {
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const int r = r0 + 64 * wg + acc_row(t, j);
          const bool ok = r < K;
          const float v0 = prelu(acc[j], a1), v1 = prelu(acc[j + 1], a1);
          if (ok)
            *reinterpret_cast<float2*>(
                &h[static_cast<size_t>(r) * H + n0 + acc_col(t, j)]) =
                kPre ? make_float2(acc[j], acc[j + 1]) : make_float2(v0, v1);
          const float q1 = ok ? v0 + v1 : 0.f;
          const float q2 = ok ? v0 * v0 + v1 * v1 : 0.f;
          s1 += q1;
          s2 += q2;
          rsum[(j >> 1) & 1][0] += q1;
          rsum[(j >> 1) & 1][1] += q2;
        }
      });
  if (p.norm == kNormGLN) {
    block_sum2(s1, s2);
    if (tid == 0) {
      float* dst = p.part_a + 2 * (static_cast<size_t>(m) * gridDim.x + blockIdx.x);
      dst[0] = s1;
      dst[1] = s2;
    }
  } else if (p.norm == kNormCLN) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float q[2] = {group_sum(rsum[u][0], 4), group_sum(rsum[u][1], 4)};
      const int r = r0 + 64 * wg + acc_row(t, 2 * u);
      if ((t & 3) == 0 && r < K) {
        float* dst = p.part_a + 2 * (static_cast<size_t>(m) * K + r);
        row_stats(q, 1, p.Hn, &dst[0], &dst[1]);
      }
    }
  }
}

// Launches a row-tile stage's kernel with its ring and extra bytes of
// dynamic shared memory on grid (ceil(K / 128), M).
template <class Kernel, class... Args>
int launch_rows_tf32(Kernel kernel, size_t smem, int K, int M,
                     cudaStream_t stream, Args... args) {
  if (smem > kMaxDynSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((K + kWgRows - 1) / kWgRows, M), kWgCta, smem, stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// Launch A' on p (p.norm set), W_in^T's split at w.
template <bool kPre>
int launch_in_proj_tf32(const Params& p, const float* w, cudaStream_t stream) {
  const int bn = staged_bn(p.H);
  RowsMaps maps;
  CTN_TRY(make_rows_maps(&maps, static_cast<const float*>(p.x), p.M, p.K,
                         p.B, w, p.H, bn));
  if (bn == 128)
    return launch_rows_tf32(in_proj_tf32_kernel<128, kPre>,
                            rows_tf32_smem<128, kTf32Stages>(), p.K, p.M,
                            stream, maps, p);
  return launch_rows_tf32(in_proj_tf32_kernel<64, kPre>,
                          rows_tf32_smem<64, kTf32Stages>(), p.K, p.M, stream,
                          maps, p);
}

// One thread's rows of the dilated depthwise conv in f32, as dw_rows walks
// them (tcn_block_hopper.cuh: channel group cg of 8 channels, rows rg +
// n_rg i of the 128-row tile at r0), norm1 applied inside the taps and a
// tap outside [0, K) skipped: emit(rl, k, acc) with acc[8] the conv output,
// zeros for k >= K. kPreH: h holds pre-activations, PReLU_a1 applied on
// load. cln: the tap row kk's (mean, rs) from rstat(kk, mean, rs). At P = 3
// the taps' weights stay in registers and four rows' loads are issued
// together; any other P reads its taps per row.
template <bool kPreH, class RowStat, class Emit>
__device__ __forceinline__ void dw_rows_f32(
    const float* h, const float* dw, int K, int H, int P, int d, int left,
    int r0, int cg, int rg, int n_rg, float a1, bool cln, const float (&g)[8],
    const float (&b)[8], const float (&sc)[8], const float (&sh)[8],
    RowStat rstat, Emit emit) {
  constexpr int kGroup = 4;
  const int c0 = 8 * cg, n_rows = kWgRows / n_rg;
  auto tap = [&](const float (&v)[8], int kk, const float (&w)[8],
                 float (&acc)[8]) {
    float mu = 0.f, rs = 1.f;
    if (cln) rstat(kk, mu, rs);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float hv = kPreH ? prelu(v[j], a1) : v[j];
      const float hn = cln ? (hv - mu) * rs * g[j] + b[j] : hv * sc[j] + sh[j];
      acc[j] = fmaf(w[j], hn, acc[j]);
    }
  };
  if (P == 3) {
    float w[3][8];
#pragma unroll
    for (int q = 0; q < 3; ++q) ldg8f(dw + static_cast<size_t>(q) * H + c0, w[q]);
#pragma unroll 1
    for (int i = 0; i < n_rows; i += kGroup) {
      float hv[kGroup][3][8];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = r0 + rg + n_rg * (i + u);
        const bool row = i + u < n_rows && k < K;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int kk = k + q * d - left;
          if (row && kk >= 0 && kk < K)
            ldg8f(h + static_cast<size_t>(kk) * H + c0, hv[u][q]);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (i + u >= n_rows) break;   // uniform: every thread has n_rows
        const int rl = rg + n_rg * (i + u), k = r0 + rl;
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (k < K) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int kk = k + q * d - left;
            if (kk >= 0 && kk < K) tap(hv[u][q], kk, w[q], acc);
          }
        }
        emit(rl, k, acc);
      }
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < n_rows; ++i) {
      const int rl = rg + n_rg * i, k = r0 + rl;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int q = 0; k < K && q < P; ++q) {
        const int kk = k + q * d - left;
        if (kk < 0 || kk >= K) continue;
        float w[8], v[8];
        ldg8f(dw + static_cast<size_t>(q) * H + c0, w);
        ldg8f(h + static_cast<size_t>(kk) * H + c0, v);
        tap(v, kk, w, acc);
      }
      emit(rl, k, acc);
    }
  }
}

// Launch B' (kPre: the backward's R2'): y = PReLU_a2(dwconv(norm1(h)))
// (kPre: h holds x @ W_in, PReLU_a1 applied on load, and y gets the conv
// output before PReLU_a2) in f32 for a 128-row tile, and norm2's partial
// sums over the f32 PReLU_a2 outputs: gLN one per tile at part_b[m *
// gridDim.x + blockIdx.x], cLN one per row and 32-lane segment at
// part_b[(m * K + row) * n_seg + s], none for BN. norm1's statistics come
// from A''s n_part_a partials per sample (gLN, sample_stats as C' and the
// backward's finaliser take them) or are A''s (mean, rs) of each tap row
// (cLN).
// Grid (ceil(K / 128), M), block 256.
template <bool kPre>
__global__ void __launch_bounds__(kWgCta) dw_tf32_kernel(Params p,
                                                         int n_part_a) {
  __shared__ float s_st[2];
  const int K = p.K, H = p.H, CG = H / 8;
  const int seg = CG < 32 ? CG : 32, n_seg = CG / seg;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG, lane = tid & 31;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows, c0 = 8 * cg;
  const int norm = p.norm;
  const bool cln = norm == kNormCLN;
  if (norm == kNormGLN)
    sample_stats(p.part_a + 2 * static_cast<size_t>(m) * n_part_a, n_part_a,
                 static_cast<double>(K) * p.Hn, &s_st[0], &s_st[1]);
  float g[8], b[8], sc[8], sh[8];
  norm1_channels(p, c0, norm == kNormGLN ? s_st[0] : 0.f,
                 norm == kNormGLN ? s_st[1] : 1.f, g, b, sc, sh);
  const float a1 = kPre ? *p.a1 : 0.f, a2 = *p.a2;
  float* y = static_cast<float*>(p.y) + static_cast<size_t>(m) * K * H;
  float s1 = 0.f, s2 = 0.f;
  dw_rows_f32<kPre>(
      static_cast<const float*>(p.h) + static_cast<size_t>(m) * K * H,
      static_cast<const float*>(p.dw), K, H, p.P, p.dilation, p.left, r0, cg,
      rg, kWgCta / CG, a1, cln, g, b, sc, sh,
      [&](int kk, float& mu, float& rs) {   // A''s (mean, rs) of row kk
        mu = p.part_a[2 * (static_cast<size_t>(m) * K + kk)];
        rs = p.part_a[2 * (static_cast<size_t>(m) * K + kk) + 1];
      },
      [&](int, int k, const float (&acc)[8]) {
        float yv[8];
        float q1 = 0.f, q2 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          yv[j] = prelu(acc[j], a2);
          q1 += yv[j];
          q2 += yv[j] * yv[j];
        }
        if (k < K) {
          if constexpr (kPre)
            st8f(y + static_cast<size_t>(k) * H + c0, acc);
          else
            st8f(y + static_cast<size_t>(k) * H + c0, yv);
        }
        if (cln) {   // the row's sums, one per segment of its lanes
          q1 = group_sum(q1, seg);
          q2 = group_sum(q2, seg);
          if ((lane & (seg - 1)) == 0 && k < K) {
            float* dst = p.part_b +
                2 * ((static_cast<size_t>(m) * K + k) * n_seg + cg / seg);
            dst[0] = q1;
            dst[1] = q2;
          }
        } else if (k < K) {
          s1 += q1;
          s2 += q2;
        }
      });
  if (norm == kNormGLN) {
    block_sum2(s1, s2);
    if (tid == 0) {
      float* dst = p.part_b + 2 * (static_cast<size_t>(m) * gridDim.x + blockIdx.x);
      dst[0] = s1;
      dst[1] = s2;
    }
  }
}

// Launch C': out = x + rs2 * (y @ W_eff - mu2 * (g @ W_out)) + b @ W_out
// for rows [r0, r0 + 128) of sample blockIdx.y, all B columns (maps: y from
// B', W_eff^T's split). Its prologue adds the prep's column-sum partials in
// order and takes norm2's statistics from B''s n_part_b partials per sample
// (gLN) or per row (cLN); BN's are folded into W_eff. The epilogue loads
// the tile's x (all of a thread's loads issued before any store, so that
// their latency is paid once a tile), adds it and stores out from the
// accumulators as A' stores h. Grid (ceil(K / 128), M), block 256.
template <int BN>
__global__ void __launch_bounds__(kWgCta)
    out_proj_tf32_kernel(const __grid_constant__ RowsMaps maps, Params p,
                         int n_part_b) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ float s_mu[kWgRows];
  __shared__ float s_rs[kWgRows];
  __shared__ float s_st[2];
  const int K = p.K, B = p.B, H = p.H, norm = p.norm;
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  const uint32_t ring = align_1024(wg_smem);
  float* s_gw = reinterpret_cast<float*>(
      smem_ptr(wg_smem, ring + rows_tf32_ring_bytes<BN, kTf32Stages>()));
  float* s_bw = s_gw + B;
  for (int c = tid; c < B; c += kWgCta) {   // the prep's partials, in order
    float gw = 0.f, bw = 0.f;
    for (int rb = 0; rb < H / kSlabK; ++rb) {
      gw += p.wsum[(2 * rb) * B + c];
      bw += p.wsum[(2 * rb + 1) * B + c];
    }
    s_gw[c] = gw;
    s_bw[c] = bw;
  }
  if (norm == kNormGLN)
    sample_stats(p.part_b + 2 * static_cast<size_t>(m) * n_part_b, n_part_b,
                 static_cast<double>(K) * p.Hn, &s_st[0], &s_st[1]);
  for (int rl = tid; rl < kWgRows; rl += kWgCta) {
    float mu = 0.f, rs = 1.f;
    if (norm == kNormGLN) {
      mu = s_st[0];
      rs = s_st[1];
    } else if (norm == kNormCLN && r0 + rl < K) {
      row_stats(p.part_b + 2 * (static_cast<size_t>(m) * K + r0 + rl) * n_part_b,
                n_part_b, p.Hn, &mu, &rs);
    }
    s_mu[rl] = mu;
    s_rs[rl] = rs;
  }
  __syncthreads();
  const float* x = static_cast<const float*>(p.x) + static_cast<size_t>(m) * K * B;
  float* out = static_cast<float*>(p.out) + static_cast<size_t>(m) * K * B;
  rows_tf32_run<BN, kTf32Stages>(
      wg_smem, ring, maps, m, r0, H, B,
      [&](float (&acc)[BN / 2], int n0) {
        float2 xv[BN / 4];   // every load of the tile's x first
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const int r = r0 + 64 * wg + acc_row(t, j);
          xv[j / 2] = r < K ? __ldg(reinterpret_cast<const float2*>(
                                  &x[static_cast<size_t>(r) * B + n0 +
                                     acc_col(t, j)]))
                            : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const int rl = 64 * wg + acc_row(t, j), r = r0 + rl;
          if (r >= K) continue;
          const int c = n0 + acc_col(t, j);
          const float mu = s_mu[rl], rs = s_rs[rl];
          *reinterpret_cast<float2*>(&out[static_cast<size_t>(r) * B + c]) =
              make_float2(
                  xv[j / 2].x + (rs * (acc[j] - mu * s_gw[c]) + s_bw[c]),
                  xv[j / 2].y +
                      (rs * (acc[j + 1] - mu * s_gw[c + 1]) + s_bw[c + 1]));
        }
      });
}

int launch_out_proj_tf32(const Params& p, const float* w, int n_part_b,
                         cudaStream_t stream) {
  const size_t sums = 2 * static_cast<size_t>(p.B) * sizeof(float);
  const int bn = staged_bn(p.B);
  RowsMaps maps;
  CTN_TRY(make_rows_maps(&maps, static_cast<const float*>(p.y), p.M, p.K,
                         p.H, w, p.B, bn));
  if (bn == 128)
    return launch_rows_tf32(out_proj_tf32_kernel<128>,
                            rows_tf32_smem<128, kTf32Stages>() + sums, p.K,
                            p.M, stream, maps, p, n_part_b);
  return launch_rows_tf32(out_proj_tf32_kernel<64>,
                          rows_tf32_smem<64, kTf32Stages>() + sums, p.K, p.M,
                          stream, maps, p, n_part_b);
}

// Partials B' writes per sample (gLN: one per 128-row tile) or per row
// (cLN: one per 32-lane segment of the row's H / 8 lanes).
inline int dw_tf32_parts(int K, int H, int norm) {
  if (norm == kNormGLN) return (K + kWgRows - 1) / kWgRows;
  const int cg = H / 8;
  return cg < 32 ? 1 : cg / 32;
}

// The f32 block on these stages (the top note): prep, A', B', C', on
// p.w_eff's weights_elems floats (W_in^T's hi and lo, then W_eff^T's).
inline int launch_block_tf32(const Params& p, cudaStream_t stream) {
  if (!dw_layout_ok(p.H)) return static_cast<int>(cudaErrorInvalidValue);
  float* ws = static_cast<float*>(p.w_eff);
  const size_t hb = static_cast<size_t>(p.H) * p.B;
  CTN_TRY(launch_prep_tf32(p, ws, 0, stream));
  CTN_TRY(launch_in_proj_tf32<false>(p, ws, stream));
  const int n_a = p.norm == kNormGLN ? (p.K + kWgRows - 1) / kWgRows
                  : p.norm == kNormCLN ? 1 : 0;
  dw_tf32_kernel<false><<<dim3((p.K + kWgRows - 1) / kWgRows, p.M), kWgCta, 0,
                          stream>>>(p, n_a);
  CTN_CHECK();
  return launch_out_proj_tf32(
      p, ws + 2 * hb, p.norm == kNormBN ? 0 : dw_tf32_parts(p.K, p.H, p.norm),
      stream);
}

// One block forward (B1) in the design of its dtype and widths: the bf16
// stages (tcn_block_hopper.cuh) for bf16 and these for f32 at wg_widths_ok,
// else the first design's launches. The block pair (B4, B5) runs each of
// its blocks through this.
template <typename T>
int launch_block(const Params& p, cudaStream_t stream) {
  if (p.norm < kNormGLN || p.norm > kNormBN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wg_widths_ok(p.B, p.H)) {
    if constexpr (std::is_same<T, bf16>::value) return launch_block_wg(p, stream);
    else return launch_block_tf32(p, stream);
  }
  switch (p.norm) {
    case kNormGLN:
      return launch_block_first<T, kNormGLN>(p, stream);
    case kNormCLN:
      return launch_block_first<T, kNormCLN>(p, stream);
  }
  return launch_block_first<T, kNormBN>(p, stream);
}

}  // namespace
