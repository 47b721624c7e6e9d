// The bf16 TCN block forward's launches on the Hopper product core
// (hopper_gemm.cuh), which the bf16 block backwards (tcn_block_bwd.cu: B2,
// B3) rerun or share: the prep launch, launch A' (the input product),
// launch B' (gLN: norm2's partial sums of y only) and launch C' (the
// depthwise conv recomputed into a resident left operand, then the output
// product); tcn_block.cu's top note says what they replace and why.
//
// Both products run on CTAs of two warpgroups (kWgRows = 128 rows of one
// sample) whose left operand is resident in shared memory, K-major, read
// once for every column tile of the product: A' copies its x rows there,
// C' computes its y rows there. The right operand (W_in in A'; W_eff in
// C', or W_out for cLN) streams through the ring in 64-deep MN-major
// slabs, column tile by column tile: 128 or 64 columns, the wider that
// divides the width (staged_bn). The depthwise stages (B', C''s prologue,
// the backward's R2) share one vectorised walk, dw_rows. The norm is a
// runtime branch (p.norm), uniform over the block. Widths (wg_widths_ok):
// H in {64, 128, 256, 512} (dw_layout_ok, and y's 128 KB at H = 512), B a
// multiple of 64 up to 512; at other widths the bf16 block and its
// backward run the first design's launches. f32 at these widths runs its
// own stages (tcn_block_tf32.cuh), which also hold launch_block.

#pragma once

#include "hopper_gemm.cuh"
#include "tcn_block_common.cuh"

namespace {

// ---- The depthwise walk shared by C', B' and the backward's R2 ----
//
// A 128-row tile of one sample is walked by 256 threads, 8 channels (16
// bytes) each: CG = H / 8 channel groups and n_rg = 256 / CG row groups;
// thread t takes channel group t % CG and rows t / CG + n_rg * i. CG must
// divide 256 (dw_layout_ok), so every thread walks the same number of
// rows and the CG threads of a row are consecutive lanes (a whole warp, or
// an aligned part of one).

inline bool dw_layout_ok(int H) {
  const int cg = H / 8;
  return H % 64 == 0 && cg <= kWgCta && kWgCta % cg == 0;
}

// The widths the bf16 stages take (the top note); the wrapper asks
// ctn_tcn_block_stores_y whether the forward needs a y buffer.
inline bool wg_widths_ok(int B, int H) {
  return dw_layout_ok(H) && H <= 512 && B % 64 == 0 && B <= 512;
}

// Whether a block of these widths in a compute dtype of elem_bytes runs
// these stages (bf16 at wg_widths_ok) or the first design.
inline bool runs_wg(int B, int H, size_t elem_bytes) {
  return elem_bytes == 2 && wg_widths_ok(B, H);
}

// One block's column-sum partials (floats): 2 x B for the first design's
// prep, 2 x B per 64-row block of W_out for these stages' (wsum).
inline size_t wsum_size(int B, int H, bool wg) {
  return 2 * static_cast<size_t>(B) * (wg ? H / kSlabK : 1);
}

// One thread's rows of the dilated depthwise conv, norm1 applied inside the
// taps and a tap outside [0, K) skipped (zero padding after the norm): for
// each of its rows rl (k = r0 + rl) it calls emit(rl, k, acc) with acc[8]
// the conv output of its 8 channels, zeros for k >= K; every thread of the
// block makes the same calls in the same order. kPreH: h holds
// pre-activations and PReLU_a1 is applied on load. cln: the tap row kk's
// (mean, rs) come from rstat(kk, mean, rs) and norm1 is (v - mean) * rs *
// g + b; otherwise v * sc + sh. At P = 3 the taps stay in registers and
// kGroup rows' loads are issued together (8 where the launch holds one CTA
// per SM and the registers are there, else 4); any other P reads its taps
// per row.
template <bool kPreH, int kGroup, class RowStat, class Emit>
__device__ __forceinline__ void dw_rows(
    const bf16* h, const bf16* dw, int K, int H, int P, int d, int left,
    int r0, int cg, int rg, int n_rg, float a1, bool cln, const float (&g)[8],
    const float (&b)[8], const float (&sc)[8], const float (&sh)[8],
    RowStat rstat, Emit emit) {
  const int c0 = 8 * cg, n_rows = kWgRows / n_rg;
  auto tap = [&](const uint4& raw, int kk, const float (&w)[8],
                 float (&acc)[8]) {
    float v[8];
    unpack8(raw, v);
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
    for (int q = 0; q < 3; ++q)
      unpack8(ldg16(dw + static_cast<size_t>(q) * H + c0), w[q]);
#pragma unroll 1
    for (int i = 0; i < n_rows; i += kGroup) {
      uint4 hv[kGroup][3];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = r0 + rg + n_rg * (i + u);
        const bool row = i + u < n_rows && k < K;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int kk = k + q * d - left;
          hv[u][q] = (row && kk >= 0 && kk < K)
                         ? ldg16(h + static_cast<size_t>(kk) * H + c0)
                         : make_uint4(0u, 0u, 0u, 0u);
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
        float w[8];
        unpack8(ldg16(dw + static_cast<size_t>(q) * H + c0), w);
        tap(ldg16(h + static_cast<size_t>(kk) * H + c0), kk, w, acc);
      }
      emit(rl, k, acc);
    }
  }
}

// The sum of v over aligned groups of n lanes (n a power of two <= 32),
// valid in every lane of the group.
__device__ __forceinline__ float group_sum(float v, int n) {
  for (int o = 1; o < n; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The column tile of the products: at most 128 wide, so that a resident
// left operand of up to 512 columns, a 4-slab ring and (for A' and the
// backward's G1') a staged output tile fit beside each other, and the
// accumulator takes 64 registers.
inline int staged_bn(int n) { return n % 128 == 0 ? 128 : 64; }

// Partials launch A' writes: per sample one per row tile (gLN), per row
// one per column tile (cLN), none for BN.
inline int in_proj_wg_parts(int K, int H, int norm) {
  if (norm == kNormGLN) return (K + kWgRows - 1) / kWgRows;
  if (norm == kNormCLN) return H / staged_bn(H);
  return 0;
}

// A' ring depth: 4 slabs, or 2 where the resident x leaves no room (B
// above 384).
inline size_t in_proj_wg_smem(int B, int H, int stages) {
  const int bn = staged_bn(H);
  return 1024 + static_cast<size_t>(B / kSlabK) * kWgRows * kLine +
         static_cast<size_t>(stages) * bn * kLine +
         static_cast<size_t>(kWgRows) * (bn + 8) * sizeof(bf16);
}

// Launch A': h = PReLU(x @ W_in) (kPre: x @ W_in) in bf16 for rows
// [r0, r0 + 128) of sample blockIdx.y, all H columns, and norm1's partial
// sums over the f32 PReLU outputs: gLN one (sum, sum of squares) per CTA at
// part_a[m * gridDim.x + blockIdx.x], cLN one per row and column tile at
// part_a[(m * K + row) * (H / BN) + tile], each in a fixed order. Each
// column tile of h is staged in shared memory and stored in 16-byte rows.
// Grid (ceil(K / 128), M), block 256.
template <int BN, bool kPre, int kStages>
__global__ void __launch_bounds__(kWgCta) in_proj_wg_kernel(Params p) {
  extern __shared__ uint8_t wg_smem[];
  const int K = p.K, B = p.B, H = p.H;
  const int nk = B / kSlabK, n_tiles = H / BN;
  const uint32_t xs = align_1024(wg_smem);
  const uint32_t ring = xs + nk * kWgRows * kLine;
  bf16* st = reinterpret_cast<bf16*>(smem_ptr(wg_smem, ring + kStages * BN * kLine));
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  const bf16* x = static_cast<const bf16*>(p.x) + static_cast<size_t>(m) * K * B;
  const bf16* w = static_cast<const bf16*>(p.w_in);
  bf16* h = static_cast<bf16*>(p.h) + static_cast<size_t>(m) * K * H;
  const float a1 = *p.a1;
  for (int s = 0; s < nk; ++s)
    load_k_panel(xs + s * kWgRows * kLine, x, B, r0, kWgRows, K, s * kSlabK,
                 tid, kWgCta);
  float acc[BN / 2];
  float s1 = 0.f, s2 = 0.f;
  ring_run<kStages>(
      n_tiles * nk, ring, BN * kLine,
      [&](int i, uint32_t slot) {
        load_mn_slab(slot, w, H, (i % nk) * kSlabK, B, (i / nk) * BN, BN, H,
                     tid, kWgCta);
      },
      [] {},
      [&](int i, uint32_t slot) {
        const int s = i % nk;
        mma_begin(acc);
        mma_slab<BN, false, true>(acc, xs + s * kWgRows * kLine + wg * 64 * kLine,
                                  slot, s > 0);
        mma_end(acc);
        if (s != nk - 1) return;
        const int tile = i / nk, n0 = tile * BN;
        float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // cLN: the thread's rows
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const bool ok = r0 + 64 * wg + acc_row(t, j) < K;
          const float v0 = prelu(acc[j], a1), v1 = prelu(acc[j + 1], a1);
          const float q1 = ok ? v0 + v1 : 0.f;
          const float q2 = ok ? v0 * v0 + v1 * v1 : 0.f;
          s1 += q1;
          s2 += q2;
          rs[(j >> 1) & 1][0] += q1;
          rs[(j >> 1) & 1][1] += q2;
          if (!kPre) {
            acc[j] = v0;
            acc[j + 1] = v1;
          }
        }
        stage_acc<BN>(st, wg, t, acc);
        if (p.norm == kNormCLN) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float q1 = group_sum(rs[u][0], 4);
            const float q2 = group_sum(rs[u][1], 4);
            const int r = r0 + 64 * wg + acc_row(t, 2 * u);
            if ((t & 3) == 0 && r < K) {
              float* dst = p.part_a +
                  2 * ((static_cast<size_t>(m) * K + r) * n_tiles + tile);
              dst[0] = q1;
              dst[1] = q2;
            }
          }
        }
        __syncthreads();
        stage_store<BN>(st, h, H, r0, K, n0, tid);
        // the ring's next barrier comes before the stage is written again
      });
  if (p.norm == kNormGLN) {
    block_sum2(s1, s2);
    if (tid == 0) {
      float* dst = p.part_a + 2 * (static_cast<size_t>(m) * gridDim.x + blockIdx.x);
      dst[0] = s1;
      dst[1] = s2;
    }
  }
}

template <int BN, bool kPre, int kStages>
int launch_in_proj_bn(const Params& p, cudaStream_t stream) {
  const size_t smem = in_proj_wg_smem(p.B, p.H, kStages);
  if (smem > kMaxDynSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = in_proj_wg_kernel<BN, kPre, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.K + kWgRows - 1) / kWgRows, p.M), kWgCta, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launch A' on p (p.norm set); kPre stores the pre-activation.
template <bool kPre>
int launch_in_proj_wg(const Params& p, cudaStream_t stream) {
  const bool deep = in_proj_wg_smem(p.B, p.H, 4) <= kMaxDynSmem - 1024;
  if (staged_bn(p.H) == 128)
    return deep ? launch_in_proj_bn<128, kPre, 4>(p, stream)
                : launch_in_proj_bn<128, kPre, 2>(p, stream);
  return deep ? launch_in_proj_bn<64, kPre, 4>(p, stream)
              : launch_in_proj_bn<64, kPre, 2>(p, stream);
}

// The prep launch: W_eff = diag(g) W_out in bf16, with g norm2's
// per-channel scale (for BN the running statistics folded in), and per
// 64-row block rb partials of the column sums g @ W_out (of W_eff as
// rounded) and b @ W_out at wsum[(2 rb) * B + n] and wsum[(2 rb + 1) * B +
// n]; C' adds the H / 64 partials in order. Block (32, 8), grid (B / 32,
// H / 64): 64 rows of 32 columns per block, so that the whole card reads
// W_out (the first design's prep ran 8 blocks and took 24 us per call).
__global__ void __launch_bounds__(256) out_weights_wg_kernel(Params p) {
  __shared__ float s_sum[2][8][32];
  const int n = blockIdx.x * 32 + threadIdx.x, rb = blockIdx.y;
  const int B = p.B;
  const bool bn = p.norm == kNormBN;
  const bf16* w_out = static_cast<const bf16*>(p.w_out);
  bf16* w_eff = static_cast<bf16*>(p.w_eff);
  float gw = 0.f, bw = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rb * kSlabK + threadIdx.y + 8 * i;
    const size_t idx = static_cast<size_t>(r) * B + n;
    const float wv = __bfloat162float(w_out[idx]);
    const float g = bn ? p.g2[r] * rsqrtf(p.v2[r] + kBnEps) : p.g2[r];
    const bf16 we = __float2bfloat16(wv * g);
    w_eff[idx] = we;
    gw += __bfloat162float(we);
    bw = fmaf(bn ? p.b2[r] - p.m2[r] * g : p.b2[r], wv, bw);
  }
  s_sum[0][threadIdx.y][threadIdx.x] = gw;
  s_sum[1][threadIdx.y][threadIdx.x] = bw;
  __syncthreads();
  if (threadIdx.y == 0) {
    for (int g = 1; g < 8; ++g) {
      gw += s_sum[0][g][threadIdx.x];
      bw += s_sum[1][g][threadIdx.x];
    }
    p.wsum[(2 * rb) * B + n] = gw;
    p.wsum[(2 * rb + 1) * B + n] = bw;
  }
}

// norm1's per-channel scale and shift of this thread's 8 channels from c0:
// gLN from the sample's (mean, rs), BN from the running statistics; cLN
// reads g and b only (its statistics are per row).
__device__ __forceinline__ void norm1_channels(const Params& p, int c0,
                                               float mean, float rs,
                                               float (&g)[8], float (&b)[8],
                                               float (&sc)[8], float (&sh)[8]) {
  load8(p.g1 + c0, g);
  load8(p.b1 + c0, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (p.norm == kNormBN) {
      sc[j] = g[j] * rsqrtf(p.v1[c0 + j] + kBnEps);
      sh[j] = b[j] - p.m1[c0 + j] * sc[j];
    } else {
      sc[j] = rs * g[j];
      sh[j] = b[j] - mean * sc[j];
    }
  }
}

// Launch B' (gLN): norm2's partial sums of y = PReLU_a2(dwconv(norm1(h)))
// and y^2 over the f32 values, one per 128-row tile at part_b[m *
// gridDim.x + blockIdx.x]; y itself is not stored (C' recomputes it).
// Grid (ceil(K / 128), M), block 256.
__global__ void __launch_bounds__(kWgCta, 2) dw_stats_kernel(Params p,
                                                             int n_part_a) {
  __shared__ float s_st[2];
  const int K = p.K, H = p.H, CG = H / 8;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  sample_stats(p.part_a + 2 * static_cast<size_t>(m) * n_part_a, n_part_a,
               static_cast<double>(K) * p.Hn, &s_st[0], &s_st[1]);
  float g[8], b[8], sc[8], sh[8];
  norm1_channels(p, 8 * cg, s_st[0], s_st[1], g, b, sc, sh);
  const float a2 = *p.a2;
  float s1 = 0.f, s2 = 0.f;
  dw_rows<false, 4>(
      static_cast<const bf16*>(p.h) + static_cast<size_t>(m) * K * H,
      static_cast<const bf16*>(p.dw), K, H, p.P, p.dilation, p.left, r0, cg,
      rg, kWgCta / CG, 0.f, false, g, b, sc, sh,
      [](int, float&, float&) {},
      [&](int, int k, const float (&acc)[8]) {
        if (k >= K) return;
        float q1 = 0.f, q2 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = prelu(acc[j], a2);
          q1 += v;
          q2 += v * v;
        }
        s1 += q1;
        s2 += q2;
      });
  block_sum2(s1, s2);
  if (tid == 0) {
    float* dst = p.part_b + 2 * (static_cast<size_t>(m) * gridDim.x + blockIdx.x);
    dst[0] = s1;
    dst[1] = s2;
  }
}

constexpr int kOutStages = 3;   // C' ring depth, of <= 128-wide slabs

// Rows of norm1 statistics C' keeps for cLN: the tile and its halo.
__host__ __device__ inline int out_proj_halo(int K, int P, int d) {
  const long long n = kWgRows + static_cast<long long>(P - 1) * d;
  return static_cast<int>(n < K ? n : K);
}

// C''s shared memory: y, the ring, the cLN row sums, the column sums, and
// the staged output tile, which the cLN halo's statistics share where
// halo_smem (they are read before the first epilogue).
inline size_t out_proj_wg_smem(int K, int B, int H, int P, int d,
                               bool halo_smem) {
  const int cg = H / 8, seg = cg < 32 ? cg : 32, bn = staged_bn(B);
  const size_t stage = static_cast<size_t>(kWgRows) * (bn + 8) * sizeof(bf16);
  const size_t halo = halo_smem
      ? 2 * static_cast<size_t>(out_proj_halo(K, P, d)) * sizeof(float) : 0;
  return 1024 + static_cast<size_t>(H / kSlabK) * kWgRows * kLine +
         static_cast<size_t>(kOutStages) * bn * kLine +
         static_cast<size_t>(kWgRows) * (cg / seg) * 2 * sizeof(float) +
         2 * static_cast<size_t>(B) * sizeof(float) +
         (halo > stage ? halo : stage);
}

// Launch C': for rows [r0, r0 + 128) of sample blockIdx.y,
//   y = PReLU_a2(dwconv(norm1(h))), recomputed from h rows [r0 - left,
//       r0 + 128 + right) by the depthwise walk (dw_rows), into the
//       resident K-major left operand in bf16 (rows at or beyond K as
//       zeros);
//   gLN, BN: y is rounded there as it is, and
//       out = x + rs2 * (y @ W_eff - mu2 * (g2 @ W_out)) + b2 @ W_out, with
//       W_eff from the prep launch and the column sums added up from its
//       partials (the Pallas kernel's emit_raw);
//   cLN: norm2's row statistics are taken from the f32 y as the walk
//       emits the row (row_stats' rule over the sums of the lanes that
//       share it; at H = 512 the row's two warps meet at a named barrier),
//       the normalised row (y - mu2) * rs2 * g2 + b2 is rounded there, and
//       out = x + yn @ W_out (the Pallas kernel's emit_tile: its cLN path
//       rounds the normalised y, not y, and folds nothing).
// n_part_a: A's partials per sample (gLN) or row (cLN); n_part_b: B''s per
// sample (gLN). kCln: p.norm is cLN (its own instantiation, so that the
// gLN and BN path carries none of the row normalisation). kHaloDev (cLN,
// where the halo's min(128 + (P - 1) d, K) rows of statistics do not fit
// in shared memory beside the resident operands): each tap takes its row's
// norm1 statistics by row_stats from A's partials in device memory, the
// values the shared halo would hold. Grid (ceil(K / 128), M), block 256.
template <int BN, bool kCln, bool kHaloDev = false>
__global__ void __launch_bounds__(kWgCta)
    out_proj_wg_kernel(Params p, int n_part_a, int n_part_b) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ float s_mu[kWgRows];
  __shared__ float s_rs[kWgRows];
  __shared__ float s_st[4];   // gLN: mu1, rs1, mu2, rs2
  const int K = p.K, B = p.B, H = p.H, P = p.P, d = p.dilation;
  const int left = p.left, norm = p.norm;
  const int nk = H / kSlabK, n_tiles = B / BN, CG = H / 8;
  const int seg = CG < 32 ? CG : 32, n_seg = CG / seg;
  const uint32_t ys = align_1024(wg_smem);
  const uint32_t ring = ys + nk * kWgRows * kLine;
  uint8_t* y_gen = smem_ptr(wg_smem, ys);
  float* s_part = reinterpret_cast<float*>(
      smem_ptr(wg_smem, ring + kOutStages * BN * kLine));  // [128][n_seg][2]
  float* s_gw = s_part + 2 * kWgRows * n_seg;  // g @ W_out, then b @ W_out
  float* s_bw = s_gw + B;
  bf16* st = reinterpret_cast<bf16*>(s_bw + B);  // the staged output tile
  float* s_halo = s_bw + B;   // cLN: (mean1, rs1) per row, before the stage
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int lane = tid & 31;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  const int lo = r0 - left > 0 ? r0 - left : 0;   // first halo row kept
  // cLN multiplies the normalised y by W_out itself
  const bf16* w_right = static_cast<const bf16*>(kCln ? p.w_out : p.w_eff);

  auto compute_y = [&] {
    for (int c = tid; c < B; c += kWgCta) {   // the prep's partials, in order
      float gw = 0.f, bw = 0.f;
      for (int rb = 0; !kCln && rb < nk; ++rb) {
        gw += p.wsum[(2 * rb) * B + c];
        bw += p.wsum[(2 * rb + 1) * B + c];
      }
      s_gw[c] = gw;
      s_bw[c] = bw;
    }
    if (!kCln && norm == kNormGLN) {
      sample_stats(p.part_a + 2 * static_cast<size_t>(m) * n_part_a, n_part_a,
                   static_cast<double>(K) * p.Hn, &s_st[0], &s_st[1]);
      sample_stats(p.part_b + 2 * static_cast<size_t>(m) * n_part_b, n_part_b,
                   static_cast<double>(K) * p.Hn, &s_st[2], &s_st[3]);
    } else if (kCln && !kHaloDev) {
      const int n_halo = min(out_proj_halo(K, P, d), K - lo);
      for (int i = tid; i < n_halo; i += kWgCta)
        row_stats(p.part_a + 2 * (static_cast<size_t>(m) * K + lo + i) * n_part_a,
                  n_part_a, p.Hn, &s_halo[2 * i], &s_halo[2 * i + 1]);
      __syncthreads();
    }
    const int cg = tid % CG, rg = tid / CG;
    float g[8], b[8], sc[8], sh[8], g2[8], b2[8];
    norm1_channels(p, 8 * cg, s_st[0], s_st[1], g, b, sc, sh);
    if (kCln) {
      load8(p.g2 + 8 * cg, g2);
      load8(p.b2 + 8 * cg, b2);
    }
    const float a2 = *p.a2;
    dw_rows<false, 8>(
        static_cast<const bf16*>(p.h) + static_cast<size_t>(m) * K * H,
        static_cast<const bf16*>(p.dw), K, H, P, d, left, r0, cg, rg,
        kWgCta / CG, 0.f, kCln, g, b, sc, sh,
        [&](int kk, float& mu, float& rs) {
          if constexpr (kHaloDev) {
            row_stats(
                p.part_a + 2 * (static_cast<size_t>(m) * K + kk) * n_part_a,
                n_part_a, p.Hn, &mu, &rs);
          } else {
            mu = s_halo[2 * (kk - lo)];
            rs = s_halo[2 * (kk - lo) + 1];
          }
        },
        [&](int rl, int k, const float (&acc)[8]) {
          float yv[8];
          float q1 = 0.f, q2 = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            yv[j] = prelu(acc[j], a2);   // 0 for rows at or beyond K
            q1 += yv[j];
            q2 += yv[j] * yv[j];
          }
          if (kCln) {   // the row's sums, one per segment
            q1 = group_sum(q1, seg);
            q2 = group_sum(q2, seg);
            if ((lane & (seg - 1)) == 0) {
              s_part[2 * (rl * n_seg + cg / seg)] = q1;
              s_part[2 * (rl * n_seg + cg / seg) + 1] = q2;
            }
            // the n_seg warps of row group rg: barrier 1 + rg (0 is
            // __syncthreads'), reached by each of them once per row
            if (n_seg > 1)
              asm volatile("bar.sync %0, %1;" ::"r"(1 + rg),
                           "r"(32 * n_seg) : "memory");
            else
              __syncwarp();
            float mu, rs;
            row_stats(s_part + 2 * rl * n_seg, n_seg, p.Hn, &mu, &rs);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              yv[j] = k < K ? (yv[j] - mu) * rs * g2[j] + b2[j] : 0.f;
          }
          *reinterpret_cast<uint4*>(y_gen + (cg >> 3) * kWgRows * kLine +
                                    swz(rl, cg & 7)) = pack8(yv);
        });
    __syncthreads();
    for (int rl = tid; rl < kWgRows; rl += kWgCta) {
      if (norm == kNormGLN) {
        s_mu[rl] = s_st[2];
        s_rs[rl] = s_st[3];
      } else {   // cLN: applied to y; BN: folded into W_eff and the sums
        s_mu[rl] = 0.f;
        s_rs[rl] = 1.f;
      }
    }
    // the ring's next barrier publishes y and the statistics
  };

  float acc[BN / 2];
  ring_run<kOutStages>(
      n_tiles * nk, ring, BN * kLine,
      [&](int i, uint32_t slot) {
        load_mn_slab(slot, w_right, B, (i % nk) * kSlabK, H, (i / nk) * BN,
                     BN, B, tid, kWgCta);
      },
      compute_y,
      [&](int i, uint32_t slot) {
        const int s = i % nk;
        mma_begin(acc);
        mma_slab<BN, false, true>(acc, ys + s * kWgRows * kLine + wg * 64 * kLine,
                                  slot, s > 0);
        mma_end(acc);
        if (s != nk - 1) return;
        const int n0 = (i / nk) * BN;
        const bf16* x = static_cast<const bf16*>(p.x) + static_cast<size_t>(m) * K * B;
        bf16* out = static_cast<bf16*>(p.out) + static_cast<size_t>(m) * K * B;
        // x's tile in through the stage, out = x + ... in place, out again
        stage_load<BN>(st, x, B, r0, K, n0, tid);
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const int rl = 64 * wg + acc_row(t, j);
          const int cl = acc_col(t, j), c = n0 + cl;
          __nv_bfloat162* sx =
              reinterpret_cast<__nv_bfloat162*>(&st[rl * stage_ld<BN>() + cl]);
          const float2 xv = __bfloat1622float2(*sx);
          const float mu = s_mu[rl], rs = s_rs[rl];
          const float o0 = rs * (acc[j] - mu * s_gw[c]) + s_bw[c];
          const float o1 = rs * (acc[j + 1] - mu * s_gw[c + 1]) + s_bw[c + 1];
          *sx = __floats2bfloat162_rn(xv.x + o0, xv.y + o1);
        }
        __syncthreads();
        stage_store<BN>(st, out, B, r0, K, n0, tid);
        // the ring's next barrier comes before the stage is loaded again
      });
}

template <int BN, bool kCln, bool kHaloDev = false>
int launch_out_proj_bn(const Params& p, int n_part_a, int n_part_b,
                       cudaStream_t stream) {
  const size_t smem = out_proj_wg_smem(p.K, p.B, p.H, p.P, p.dilation,
                                       kCln && !kHaloDev);
  if (smem > kMaxDynSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = out_proj_wg_kernel<BN, kCln, kHaloDev>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.K + kWgRows - 1) / kWgRows, p.M), kWgCta, smem, stream>>>(
      p, n_part_a, n_part_b);
  return static_cast<int>(cudaGetLastError());
}

int launch_out_proj_wg(const Params& p, int n_part_a, int n_part_b,
                       cudaStream_t stream) {
  const bool cln = p.norm == kNormCLN;
  // cLN with a halo past shared memory: its statistics from device memory
  if (cln && out_proj_wg_smem(p.K, p.B, p.H, p.P, p.dilation, true) >
                 kMaxDynSmem)
    return staged_bn(p.B) == 128
        ? launch_out_proj_bn<128, true, true>(p, n_part_a, n_part_b, stream)
        : launch_out_proj_bn<64, true, true>(p, n_part_a, n_part_b, stream);
  if (staged_bn(p.B) == 128)
    return cln ? launch_out_proj_bn<128, true>(p, n_part_a, n_part_b, stream)
               : launch_out_proj_bn<128, false>(p, n_part_a, n_part_b, stream);
  return cln ? launch_out_proj_bn<64, true>(p, n_part_a, n_part_b, stream)
             : launch_out_proj_bn<64, false>(p, n_part_a, n_part_b, stream);
}

// The bf16 block on these stages (tcn_block.cu's top note): prep (gLN,
// BN), A', B' (gLN), C'.
inline int launch_block_wg(const Params& p, cudaStream_t stream) {
  if (!dw_layout_ok(p.H)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.norm != kNormCLN) {
    out_weights_wg_kernel<<<dim3(p.B / 32, p.H / kSlabK), dim3(32, 8), 0,
                            stream>>>(p);
    CTN_CHECK();
  }
  const int err = launch_in_proj_wg<false>(p, stream);
  if (err != 0) return err;
  const int n_a = in_proj_wg_parts(p.K, p.H, p.norm);
  const int kt = (p.K + kWgRows - 1) / kWgRows;
  if (p.norm == kNormGLN) {
    dw_stats_kernel<<<dim3(kt, p.M), kWgCta, 0, stream>>>(p, n_a);
    CTN_CHECK();
  }
  return launch_out_proj_wg(p, n_a, kt, stream);
}

}  // namespace
