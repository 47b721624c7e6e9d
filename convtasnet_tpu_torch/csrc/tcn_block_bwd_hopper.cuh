// The bf16 stages of the TCN block backward on the Hopper product core
// (hopper_gemm.cuh): R2', G1', E2' (two kernels), G2b', W' and their launch
// sequence launch_bwd_wg; then one block's workspace layout and
// launch_block_bwd, which runs these stages or the first design's
// (tcn_block_bwd_common.cuh) as a block's dtype and widths ask, for the
// single-block backwards (tcn_block_bwd.cu: B2 gLN, B3 cLN) and each block
// of the gLN pair backward (tcn_block_pair_bwd.cu: B5). tcn_block_bwd.cu's
// top note says what each stage computes and why.

#pragma once

#include "tcn_block_bwd_common.cuh"
#include "tcn_block_hopper.cuh"

namespace {

// ---- The bf16 stages on the Hopper core (the top note's second list) ----

// The statistics row r of sample m reads (per sample for gLN).
__device__ __forceinline__ const float* stat_at(const BwdParams& p, bool cln,
                                                int m, int r) {
  return p.stats +
         (cln ? static_cast<size_t>(m) * p.K + r : static_cast<size_t>(m)) *
             kNumStats;
}

// R2': c = dwconv(norm1(PReLU_a1(hp))) (the pre-activation, which the later
// launches read) in bf16 for a 128-row tile, by the depthwise walk with
// norm1's statistics from F1, and norm2's partial sums over the f32
// PReLU_a2 outputs: gLN one per tile at part2[m * gridDim.x + blockIdx.x],
// cLN one per row and lane segment at part2[(m * K + row) * n_seg + s], the
// grouping C' sums y's rows in. Grid (ceil(K / 128), M), block 256.
__global__ void __launch_bounds__(kWgCta, 2) dw_recompute_kernel(BwdParams p,
                                                                 int cln) {
  const int K = p.K, H = p.H, CG = H / 8;
  const int seg = CG < 32 ? CG : 32, n_seg = CG / seg;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG, lane = tid & 31;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows, c0 = 8 * cg;
  const float* st_m = stat_at(p, false, m, 0);
  float g[8], b[8], sc[8], sh[8];
  load8(p.g1 + c0, g);
  load8(p.b1 + c0, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) {   // gLN's; cLN reads each row's
    sc[j] = cln ? 0.f : st_m[kRs1] * g[j];
    sh[j] = cln ? 0.f : b[j] - st_m[kMean1] * sc[j];
  }
  const float a2 = *p.a2;
  bf16* c = static_cast<bf16*>(p.c) + static_cast<size_t>(m) * K * H;
  float s1 = 0.f, s2 = 0.f;
  dw_rows<true, 4>(
      static_cast<const bf16*>(p.hp) + static_cast<size_t>(m) * K * H,
      static_cast<const bf16*>(p.dw), K, H, p.P, p.dilation, p.left, r0, cg,
      rg, kWgCta / CG, *p.a1, cln, g, b, sc, sh,
      [&](int kk, float& mu, float& rs) {
        const float* st = stat_at(p, true, m, kk);
        mu = st[kMean1];
        rs = st[kRs1];
      },
      [&](int, int k, const float (&acc)[8]) {
        float q1 = 0.f, q2 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = prelu(acc[j], a2);
          q1 += v;
          q2 += v * v;
        }
        if (k < K)
          *reinterpret_cast<uint4*>(c + static_cast<size_t>(k) * H + c0) =
              pack8(acc);
        if (cln) {
          q1 = group_sum(q1, seg);
          q2 = group_sum(q2, seg);
          if ((lane & (seg - 1)) == 0 && k < K) {
            float* dst = p.part2 +
                2 * ((static_cast<size_t>(m) * K + k) * n_seg + cg / seg);
            dst[0] = q1;
            dst[1] = q2;
          }
        } else if (k < K) {
          s1 += q1;
          s2 += q2;
        }
      });
  if (!cln) {
    block_sum2(s1, s2);
    if (tid == 0) {
      float* dst = p.part2 + 2 * (static_cast<size_t>(m) * gridDim.x + blockIdx.x);
      dst[0] = s1;
      dst[1] = s2;
    }
  }
}

// R1 (launch A' with kPre), F1, R2' and F2: hp, c and norm1's and norm2's
// statistics, as the forward takes them.
template <int kNorm>
int recompute_block_wg(const BwdParams& p, cudaStream_t stream) {
  constexpr bool kCln = kNorm == kNormCLN;
  const int M = p.M, K = p.K, H = p.H;
  const double count = static_cast<double>(K) * H;
  const int kt = (K + kWgRows - 1) / kWgRows;
  const int n_rows = M * K;
  const int fin_blocks = (n_rows + 255) / 256;
  Params fp = {};
  fp.x = p.x;
  fp.w_in = p.w_in;
  fp.a1 = p.a1;
  fp.h = p.hp;
  fp.part_a = p.part;
  fp.M = M;
  fp.K = K;
  fp.B = p.B;
  fp.H = H;
  fp.norm = kNorm;
  CTN_TRY(launch_in_proj_wg<true>(fp, stream));
  const int n_r1 = in_proj_wg_parts(K, H, kNorm);
  const int cg = H / 8, n_seg = cg < 32 ? 1 : cg / 32;
  if constexpr (kCln)
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part, n_r1, n_rows, H, p.stats, kMean1, 0);
  else
    finalize_kernel<<<M, kWgCta, 0, stream>>>(p.part, n_r1, count, p.stats,
                                              kMean1, 0);
  CTN_CHECK();
  dw_recompute_kernel<<<dim3(kt, M), kWgCta, 0, stream>>>(p, kCln);
  CTN_CHECK();
  if constexpr (kCln)
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part2, n_seg, n_rows, H, p.stats, kMean2, 0);
  else
    finalize_kernel<<<M, kWgCta, 0, stream>>>(p.part2, kt, count, p.stats,
                                              kMean2, 0);
  CTN_CHECK();
  return 0;
}


// G1's epilogue layout: threads of a row take its BN / 8 chunks, the
// others its next rows.
template <int BN>
__host__ __device__ constexpr int g1_row_groups() { return kWgCta / (BN / 8); }

// G1''s ring: 4 slabs, or 2 where the resident g leaves no room.
inline size_t g1_wg_smem(int B, int H, int stages) {
  const int bn = staged_bn(H);
  return 1024 + static_cast<size_t>(B / kSlabK) * kWgRows * kLine +
         static_cast<size_t>(stages) * bn * kLine +
         static_cast<size_t>(kWgRows) * (bn + 8) * sizeof(bf16) +
         static_cast<size_t>(kWgCta / (bn / 8)) * 2 * bn * sizeof(float);
}

// G1': e = g @ W_out^T for rows [r0, r0 + 128) of sample blockIdx.y, g's
// rows resident (K-major) and W_out's rows streaming K-major (W_out^T read
// through the descriptor, no transpose). Each column tile of e is rounded
// into a staged tile, and its epilogue walks that tile in 16-byte rows: e
// and hn2 = g2 * hhat2 + b2 (from c) to device memory; norm2's backward
// sums t1 = sum g2 e, t2 = sum g2 e hhat2 (gLN per CTA, cLN per row and
// column tile) and the per-channel dg2 = sum e hhat2, db2 = sum e of the
// tile's rows (pch_g1), each in a fixed order. Grid (ceil(K / 128), M),
// block 256.
template <int BN, int kStages>
__global__ void __launch_bounds__(kWgCta) g1_wg_kernel(BwdParams p, int cln) {
  extern __shared__ uint8_t wg_smem[];
  constexpr int kCpr = BN / 8, kRg = g1_row_groups<BN>();
  constexpr int kSeg = kCpr < 32 ? kCpr : 32, kSegs = kCpr / kSeg;
  const int K = p.K, B = p.B, H = p.H;
  const int nk = B / kSlabK, n_tiles = H / BN;
  const uint32_t gs = align_1024(wg_smem);
  const uint32_t ring = gs + nk * kWgRows * kLine;
  bf16* st = reinterpret_cast<bf16*>(smem_ptr(wg_smem, ring + kStages * BN * kLine));
  float* s_col = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(st) + stage_bytes<BN>());   // [kRg][2][BN]
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m = blockIdx.y, bx = blockIdx.x, r0 = bx * kWgRows;
  const int cc = tid % kCpr, rg = tid / kCpr;   // the epilogue's walk
  const bf16* g = static_cast<const bf16*>(p.g) + static_cast<size_t>(m) * K * B;
  const bf16* w_out = static_cast<const bf16*>(p.w_out);
  const bf16* c = static_cast<const bf16*>(p.c) + static_cast<size_t>(m) * K * H;
  bf16* e = static_cast<bf16*>(p.e) + static_cast<size_t>(m) * K * H;
  bf16* hn2 = static_cast<bf16*>(p.hn2) + static_cast<size_t>(m) * K * H;
  const float a2 = *p.a2;
  for (int s = 0; s < nk; ++s)
    load_k_panel(gs + s * kWgRows * kLine, g, B, r0, kWgRows, K, s * kSlabK,
                 tid, kWgCta);
  float acc[BN / 2];
  float t1 = 0.f, t2 = 0.f;
  ring_run<kStages>(
      n_tiles * nk, ring, BN * kLine,
      [&](int i, uint32_t slot) {
        load_k_panel(slot, w_out, B, (i / nk) * BN, BN, H, (i % nk) * kSlabK,
                     tid, kWgCta);
      },
      [] {},
      [&](int i, uint32_t slot) {
        const int s = i % nk;
        mma_begin(acc);
        mma_slab<BN, false, false>(acc, gs + s * kWgRows * kLine + wg * 64 * kLine,
                                   slot, s > 0);
        mma_end(acc);
        if (s != nk - 1) return;
        const int tile = i / nk, n0 = tile * BN, c0 = n0 + 8 * cc;
        stage_acc<BN>(st, wg, t, acc);
        __syncthreads();
        float gam[8], bet[8], dg[8], db[8];
        load8(p.g2 + c0, gam);
        load8(p.b2 + c0, bet);
#pragma unroll
        for (int j = 0; j < 8; ++j) dg[j] = db[j] = 0.f;
        constexpr int kRows = kWgRows / kRg;   // the thread's rows
        uint4 craw[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = r0 + rg + kRg * i;
          craw[i] = r < K ? ldg16(c + static_cast<size_t>(r) * H + c0)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int rl = rg + kRg * i, r = r0 + rl;
          float q1 = 0.f, q2 = 0.f;
          if (r < K) {
            const float* sr = stat_at(p, cln, m, r);
            const float mu2 = sr[kMean2], rs2 = sr[kRs2];
            const size_t idx = static_cast<size_t>(r) * H + c0;
            const uint4 eraw =
                *reinterpret_cast<const uint4*>(&st[rl * stage_ld<BN>() + 8 * cc]);
            float ev[8], cv[8], hv[8];
            unpack8(eraw, ev);
            unpack8(craw[i], cv);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float hh = (prelu(cv[j], a2) - mu2) * rs2;
              hv[j] = gam[j] * hh + bet[j];
              dg[j] += ev[j] * hh;
              db[j] += ev[j];
              q1 += gam[j] * ev[j];
              q2 += gam[j] * ev[j] * hh;
            }
            *reinterpret_cast<uint4*>(e + idx) = eraw;
            *reinterpret_cast<uint4*>(hn2 + idx) = pack8(hv);
          }
          if (cln) {   // the row's sums, one per segment of its lanes
            q1 = group_sum(q1, kSeg);
            q2 = group_sum(q2, kSeg);
            if (cc % kSeg == 0 && r < K) {
              float* dst = p.part +
                  2 * ((static_cast<size_t>(m) * K + r) * n_tiles * kSegs +
                       tile * kSegs + cc / kSeg);
              dst[0] = q1;
              dst[1] = q2;
            }
          } else {
            t1 += q1;
            t2 += q2;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s_col[(2 * rg) * BN + 8 * cc + j] = dg[j];
          s_col[(2 * rg + 1) * BN + 8 * cc + j] = db[j];
        }
        __syncthreads();
        for (int cl = tid; cl < BN; cl += kWgCta) {
          float sg = 0.f, sb = 0.f;
          for (int w = 0; w < kRg; ++w) {
            sg += s_col[(2 * w) * BN + cl];
            sb += s_col[(2 * w + 1) * BN + cl];
          }
          float* dst = p.pch_g1 +
              2 * (static_cast<size_t>(m) * gridDim.x + bx) * H + n0 + cl;
          dst[0] = sg;
          dst[H] = sb;
        }
        // the stage and s_col are read before the next tile's epilogue
        // writes them: the ring's barriers in between
      });
  if (!cln) {
    block_sum2(t1, t2);
    if (tid == 0) {
      float* dst = p.part + 2 * (static_cast<size_t>(m) * gridDim.x + bx);
      dst[0] = t1;
      dst[1] = t2;
    }
  }
}

// cLN partials G1' writes per row: one per column tile and row segment.
inline int g1_row_parts(int H) {
  const int bn = staged_bn(H), cpr = bn / 8;
  return (H / bn) * (cpr < 32 ? 1 : cpr / 32);
}

template <int BN, int kStages>
int launch_g1_bn(const BwdParams& p, int cln, cudaStream_t stream) {
  const size_t smem = g1_wg_smem(p.B, p.H, kStages);
  if (smem > kMaxDynSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = g1_wg_kernel<BN, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.K + kWgRows - 1) / kWgRows, p.M), kWgCta, smem, stream>>>(
      p, cln);
  return static_cast<int>(cudaGetLastError());
}

int launch_g1_wg(const BwdParams& p, int cln, cudaStream_t stream) {
  const bool deep = g1_wg_smem(p.B, p.H, 4) <= kMaxDynSmem - 1024;
  if (staged_bn(p.H) == 128)
    return deep ? launch_g1_bn<128, 4>(p, cln, stream)
                : launch_g1_bn<128, 2>(p, cln, stream);
  return deep ? launch_g1_bn<64, 4>(p, cln, stream)
              : launch_g1_bn<64, 2>(p, cln, stream);
}

// E2' (E1 folded in) for any P and dilation, on the depthwise walk's
// layout (8 channels per thread, 128-row tiles); at P = 3 where a tile's dc
// rows fit in shared memory, e2_dc_kernel below runs instead. For each of
// its rows j and channels it forms
//   dc(r) = round(rs2 (g2 e - t1/n - hhat2 t2/n) PReLU'(c)) at r = j and at
//           the rows j - q d + left that tap q of j fed (E1's value and
//           rounding point: P recomputes per row, no pass),
//   dhn1[j] = sum_q dw[q] dc(j - q d + left)   (to p.dh in bf16),
// and sums d_dw[q] += dc(j) hn1[j + q d - left], dg1 += dhn1 hhat1,
// db1 += dhn1, da2 += dh2(j) min(c[j], 0) per channel (its row groups
// added in order through s_red into pch_e2 and pch_e1 at tile m *
// gridDim.x + blockIdx.x) and u1 = sum g1 dhn1, u2 = sum g1 dhn1 hhat1
// (gLN per tile; cLN per row and lane segment). Grid (ceil(K / 128), M),
// block 256.
__global__ void __launch_bounds__(kWgCta) e2_wg_kernel(BwdParams p, int cln) {
  __shared__ float s_red[kWgCta * 8];   // [n_rg][H]
  constexpr int kTaps = kMaxTaps;
  const int K = p.K, H = p.H, P = p.P, d = p.dilation, left = p.left;
  const int CG = H / 8, n_rg = kWgCta / CG, seg = CG < 32 ? CG : 32;
  const int n_seg = CG / seg;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG, lane = tid & 31;
  const int c0 = 8 * cg;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  const float a1 = *p.a1, a2 = *p.a2;
  const size_t base = static_cast<size_t>(m) * K * H;
  const bf16* hp = static_cast<const bf16*>(p.hp) + base;
  const bf16* cc = static_cast<const bf16*>(p.c) + base;
  const bf16* e = static_cast<const bf16*>(p.e) + base;
  const bf16* dwp = static_cast<const bf16*>(p.dw);
  bf16* dhn1 = static_cast<bf16*>(p.dh) + base;
  float gam[8], bet[8], gam2[8];
  load8(p.g1 + c0, gam);
  load8(p.b1 + c0, bet);
  load8(p.g2 + c0, gam2);
  float w[kTaps][8];
  for (int q = 0; q < P; ++q)
    unpack8(ldg16(dwp + static_cast<size_t>(q) * H + c0), w[q]);
  const float* st_m = stat_at(p, false, m, 0);   // gLN's
  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = st_m[kRs1] * gam[j];
    sh[j] = bet[j] - st_m[kMean1] * sc[j];
  }
  float ddw[kTaps][8], dg[8], db[8], da2[8];
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) ddw[q][j] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) dg[j] = db[j] = da2[j] = 0.f;
  float u1 = 0.f, u2 = 0.f;
  // dc at row r from its raw c and e; da, when given, gets dh2 * min(c, 0)
  auto dc8 = [&](int r, const uint4& craw, const uint4& eraw, float (&dc)[8],
                 float* da) {
    const float* sr = stat_at(p, cln, m, r);
    float cv[8], ev[8];
    unpack8(craw, cv);
    unpack8(eraw, ev);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float hh = (prelu(cv[j], a2) - sr[kMean2]) * sr[kRs2];
      const float dh2 =
          sr[kRs2] * (gam2[j] * ev[j] - sr[kT1] - hh * sr[kT2]);
      if (da) da[j] += dh2 * fminf(cv[j], 0.f);
      dc[j] = round_to<bf16>(cv[j] >= 0.f ? dh2 : a2 * dh2);
    }
  };
  const int n_rows = kWgRows / n_rg;
#pragma unroll 1
  for (int i = 0; i < n_rows; ++i) {
    const int j = r0 + rg + n_rg * i;
    float q1 = 0.f, q2 = 0.f;
    if (j < K) {
      // every load of the row first
      const size_t idx = static_cast<size_t>(j) * H + c0;
      const uint4 c_j = ldg16(cc + idx), e_j = ldg16(e + idx);
      const uint4 hp_j = ldg16(hp + idx);
      uint4 c_o[kTaps], e_o[kTaps], hp_i[kTaps];
      for (int q = 0; q < P; ++q) {
        const int kk = j - q * d + left;   // output row that tap q of j fed
        const int kh = j + q * d - left;   // input row tap q of j read
        const bool ok_o = kk >= 0 && kk < K, ok_i = kh >= 0 && kh < K;
        const size_t io = static_cast<size_t>(ok_o ? kk : 0) * H + c0;
        const size_t ii = static_cast<size_t>(ok_i ? kh : 0) * H + c0;
        c_o[q] = ok_o ? ldg16(cc + io) : make_uint4(0u, 0u, 0u, 0u);
        e_o[q] = ok_o ? ldg16(e + io) : make_uint4(0u, 0u, 0u, 0u);
        hp_i[q] = ok_i ? ldg16(hp + ii) : make_uint4(0u, 0u, 0u, 0u);
      }
      float dcj[8], acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      dc8(j, c_j, e_j, dcj, da2);
      for (int q = 0; q < P; ++q) {
        const int kk = j - q * d + left;
        if (kk >= 0 && kk < K) {
          float dco[8];
          dc8(kk, c_o[q], e_o[q], dco, nullptr);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[jj] = fmaf(w[q][jj], dco[jj], acc[jj]);
        }
        const int kh = j + q * d - left;
        if (kh >= 0 && kh < K) {
          float hv[8];
          unpack8(hp_i[q], hv);
          float mu = 0.f, rs = 1.f;
          if (cln) {
            const float* sk = stat_at(p, true, m, kh);
            mu = sk[kMean1];
            rs = sk[kRs1];
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float h1 = prelu(hv[jj], a1);
            const float hn = cln ? (h1 - mu) * rs * gam[jj] + bet[jj]
                                 : h1 * sc[jj] + sh[jj];
            ddw[q][jj] = fmaf(dcj[jj], hn, ddw[q][jj]);
          }
        }
      }
      float dn[8], hv[8];
      unpack8(hp_j, hv);
      const float* sj = stat_at(p, cln, m, j);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) dn[jj] = round_to<bf16>(acc[jj]);
      *reinterpret_cast<uint4*>(dhn1 + idx) = pack8(acc);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float hh = (prelu(hv[jj], a1) - sj[kMean1]) * sj[kRs1];
        dg[jj] += dn[jj] * hh;
        db[jj] += dn[jj];
        q1 += gam[jj] * dn[jj];
        q2 += gam[jj] * dn[jj] * hh;
      }
    }
    if (cln) {
      q1 = group_sum(q1, seg);
      q2 = group_sum(q2, seg);
      if ((lane & (seg - 1)) == 0 && j < K) {
        float* dst = p.part + 2 * ((static_cast<size_t>(m) * K + j) * n_seg +
                                   cg / seg);
        dst[0] = q1;
        dst[1] = q2;
      }
    } else {
      u1 += q1;
      u2 += q2;
    }
  }
  // per-channel sums of the row groups, in order: d_dw[0..P-1], dg1, db1
  // to pch_e2, da2 to pch_e1
  const size_t tile = static_cast<size_t>(m) * gridDim.x + blockIdx.x;
  for (int q = 0; q < P + 3; ++q) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      s_red[rg * H + c0 + jj] = q < P ? ddw[q][jj]
                                : q == P ? dg[jj]
                                : q == P + 1 ? db[jj] : da2[jj];
    __syncthreads();
    for (int ch = tid; ch < H; ch += kWgCta) {
      float v = 0.f;
      for (int r = 0; r < n_rg; ++r) v += s_red[r * H + ch];
      if (q < P + 2)
        p.pch_e2[(tile * (P + 2) + q) * H + ch] = v;
      else
        p.pch_e1[tile * H + ch] = v;
    }
    __syncthreads();
  }
  if (!cln) {
    block_sum2(u1, u2);
    if (tid == 0) {
      float* dst = p.part + 2 * tile;
      dst[0] = u1;
      dst[1] = u2;
    }
  }
}

// E2' at P = 3 when the tile's dc rows fit in shared memory (the launcher
// checks): the same sums as e2_wg_kernel, with dc formed once per row
// instead of at every tap. A CTA takes 128 rows and 64 channels (grid
// (ceil(K / 128), H / 64, M)); its 256 threads are 16 channel groups of 4
// channels (8-byte accesses) by 16 row groups, which keeps a thread's sums
// within 128 registers and two CTAs on an SM. Phase 1 forms dc, rounded to
// bf16, for the rows its taps read, [r0 + left - 2 d, r0 + 128 + left)
// within [0, K), into shared memory (and da2 from its own rows); phase 2
// walks the own rows: dhn1 from the taps of dc there, d_dw from dc and hn1
// (hp read at the taps), dg1, db1 and u1, u2 from dhn1 and hp. Per-tile
// per-channel sums into pch_e2 / pch_e1 for its 64 channels; u1, u2 per
// CTA (gLN, at part[(m * gridDim.x + blockIdx.x) * gridDim.y +
// blockIdx.y]) or per row and channel slice (cLN, at part[(m * K + row) *
// gridDim.y + blockIdx.y]).
constexpr int kE2Cols = 64;
constexpr int kE2Cg = kE2Cols / 4;        // channel groups
constexpr int kE2Rg = kWgCta / kE2Cg;     // row groups

inline size_t e2_dc_smem(int K, int d) {
  const long long n = kWgRows + 2LL * d;
  return static_cast<size_t>(n < K ? n : K) * kE2Cols * sizeof(bf16);
}

__device__ __forceinline__ void unpack4(const uint2& u, float (&f)[4]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 v = __bfloat1622float2(h2[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ uint2 pack4(const float (&f)[4]) {
  uint2 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
  h2[0] = __floats2bfloat162_rn(f[0], f[1]);
  h2[1] = __floats2bfloat162_rn(f[2], f[3]);
  return u;
}
__device__ __forceinline__ uint2 ldg8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__global__ void __launch_bounds__(kWgCta, 2) e2_dc_kernel(BwdParams p,
                                                          int cln) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ float s_red[6][kE2Rg][kE2Cols];
  bf16* s_dc = reinterpret_cast<bf16*>(wg_smem);
  const int K = p.K, H = p.H, d = p.dilation, left = p.left;
  const int tid = threadIdx.x, cg = tid % kE2Cg, rg = tid / kE2Cg;
  const int c0 = blockIdx.y * kE2Cols + 4 * cg;
  const int m = blockIdx.z, r0 = blockIdx.x * kWgRows;
  const int lo = max(r0 + left - 2 * d, 0);
  const int hi = min(r0 + kWgRows + left, K);
  const int r_end = min(r0 + kWgRows, K);
  const float a1 = *p.a1, a2 = *p.a2;
  const size_t base = static_cast<size_t>(m) * K * H;
  const bf16* hp = static_cast<const bf16*>(p.hp) + base;
  const bf16* cc = static_cast<const bf16*>(p.c) + base;
  const bf16* e = static_cast<const bf16*>(p.e) + base;
  bf16* dhn1 = static_cast<bf16*>(p.dh) + base;
  float gam[4], bet[4], w[3][4], da2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    gam[j] = p.g1[c0 + j];
    bet[j] = p.b1[c0 + j];
    da2[j] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
    unpack4(ldg8(static_cast<const bf16*>(p.dw) + static_cast<size_t>(q) * H + c0),
            w[q]);

  // phase 1: dc for rows [lo, hi), four rows' loads at once
  {
    float gam2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) gam2[j] = p.g2[c0 + j];
    for (int r = lo + rg; r < hi; r += 4 * kE2Rg) {
      uint2 craw[4], eraw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ru = r + u * kE2Rg;
        const size_t idx = static_cast<size_t>(ru < hi ? ru : lo) * H + c0;
        craw[u] = ldg8(cc + idx);
        eraw[u] = ldg8(e + idx);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ru = r + u * kE2Rg;
        if (ru >= hi) break;
        const float* sr = stat_at(p, cln, m, ru);
        const float mu2 = sr[kMean2], rs2 = sr[kRs2], t1 = sr[kT1], t2 = sr[kT2];
        const bool own = ru >= r0 && ru < r_end;
        float cv[4], ev[4], dc[4];
        unpack4(craw[u], cv);
        unpack4(eraw[u], ev);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float hh = (prelu(cv[j], a2) - mu2) * rs2;
          const float dh2 = rs2 * (gam2[j] * ev[j] - t1 - hh * t2);
          if (own) da2[j] += dh2 * fminf(cv[j], 0.f);
          dc[j] = cv[j] >= 0.f ? dh2 : a2 * dh2;
        }
        *reinterpret_cast<uint2*>(&s_dc[(ru - lo) * kE2Cols + 4 * cg]) = pack4(dc);
      }
    }
  }
  __syncthreads();

  // phase 2: the own rows, four rows' hp loads at once
  const float* st_m = stat_at(p, false, m, 0);   // gLN's
  float sc[4], sh[4], ddw[3][4], dg[4], db[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = st_m[kRs1] * gam[j];
    sh[j] = bet[j] - st_m[kMean1] * sc[j];
    dg[j] = db[j] = 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q) ddw[q][j] = 0.f;
  }
  float u1 = 0.f, u2 = 0.f;
  constexpr int kRows = kWgRows / kE2Rg;   // the thread's rows
#pragma unroll 1
  for (int i0 = 0; i0 < kRows; i0 += 4) {
    uint2 hp_t[4][3], hp_o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = r0 + rg + (i0 + u) * kE2Rg;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int kh = j + q * d - left;   // input row tap q of j read
        hp_t[u][q] = j < K && kh >= 0 && kh < K
                         ? ldg8(hp + static_cast<size_t>(kh) * H + c0)
                         : make_uint2(0u, 0u);
      }
      hp_o[u] = j < K ? ldg8(hp + static_cast<size_t>(j) * H + c0)
                      : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = r0 + rg + (i0 + u) * kE2Rg;
      float q1 = 0.f, q2 = 0.f;
      if (j < K) {
        float dcj[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
        unpack4(*reinterpret_cast<const uint2*>(&s_dc[(j - lo) * kE2Cols + 4 * cg]),
                dcj);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int kk = j - q * d + left;   // output row that tap q of j fed
          if (kk >= 0 && kk < K) {
            float dco[4];
            unpack4(*reinterpret_cast<const uint2*>(
                        &s_dc[(kk - lo) * kE2Cols + 4 * cg]), dco);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[jj] = fmaf(w[q][jj], dco[jj], acc[jj]);
          }
          const int kh = j + q * d - left;
          if (kh >= 0 && kh < K) {
            float hv[4];
            unpack4(hp_t[u][q], hv);
            float mu = 0.f, rs = 1.f;
            if (cln) {
              const float* sk = stat_at(p, true, m, kh);
              mu = sk[kMean1];
              rs = sk[kRs1];
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float h1 = prelu(hv[jj], a1);
              const float hn = cln ? (h1 - mu) * rs * gam[jj] + bet[jj]
                                   : h1 * sc[jj] + sh[jj];
              ddw[q][jj] = fmaf(dcj[jj], hn, ddw[q][jj]);
            }
          }
        }
        float hv[4];
        unpack4(hp_o[u], hv);
        const float* sj = stat_at(p, cln, m, j);
        *reinterpret_cast<uint2*>(dhn1 + static_cast<size_t>(j) * H + c0) =
            pack4(acc);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float dn = round_to<bf16>(acc[jj]);
          const float hh = (prelu(hv[jj], a1) - sj[kMean1]) * sj[kRs1];
          dg[jj] += dn * hh;
          db[jj] += dn;
          q1 += gam[jj] * dn;
          q2 += gam[jj] * dn * hh;
        }
      }
      if (cln) {   // the row's kE2Cg lanes
        q1 = group_sum(q1, kE2Cg);
        q2 = group_sum(q2, kE2Cg);
        if (cg == 0 && j < K) {
          float* dst = p.part +
              2 * ((static_cast<size_t>(m) * K + j) * gridDim.y + blockIdx.y);
          dst[0] = q1;
          dst[1] = q2;
        }
      } else {
        u1 += q1;
        u2 += q2;
      }
    }
  }
  // per-channel sums of the row groups, in order: d_dw[0..2], dg1, db1 to
  // pch_e2, da2 to pch_e1
  const size_t tile = static_cast<size_t>(m) * gridDim.x + blockIdx.x;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int q = 0; q < 3; ++q) s_red[q][rg][4 * cg + jj] = ddw[q][jj];
    s_red[3][rg][4 * cg + jj] = dg[jj];
    s_red[4][rg][4 * cg + jj] = db[jj];
    s_red[5][rg][4 * cg + jj] = da2[jj];
  }
  __syncthreads();
  for (int v = tid; v < 6 * kE2Cols; v += kWgCta) {
    const int q = v / kE2Cols, cl = v % kE2Cols;
    float sum = 0.f;
    for (int r = 0; r < kE2Rg; ++r) sum += s_red[q][r][cl];
    const int ch = blockIdx.y * kE2Cols + cl;
    if (q < 5)
      p.pch_e2[(tile * 5 + q) * H + ch] = sum;
    else
      p.pch_e1[tile * H + ch] = sum;
  }
  if (!cln) {
    block_sum2(u1, u2);
    if (tid == 0) {
      float* dst = p.part + 2 * (tile * gridDim.y + blockIdx.y);
      dst[0] = u1;
      dst[1] = u2;
    }
  }
}

constexpr int kG2Stages = 3;

inline size_t g2b_wg_smem(int B, int H) {
  const int bn = staged_bn(B);
  return 1024 + static_cast<size_t>(H / kSlabK) * kWgRows * kLine +
         static_cast<size_t>(kG2Stages) * bn * kLine +
         static_cast<size_t>(kWgCta / (H / 8)) * H * sizeof(float) +
         static_cast<size_t>(kWgRows) * (bn + 8) * sizeof(bf16);
}

// G2b' (G2a folded in): for rows [r0, r0 + 128) of sample blockIdx.y its
// prologue forms dh_pre = rs1 * (g1 dhn1 - u1/n - hhat1 u2/n) * PReLU'(hp)
// from dhn1 and hp (the depthwise walk's layout, 8 rows' loads at
// once), rounds it to bf16 into the resident K-major left operand and over
// dhn1 in device memory (each element by the thread that read it; dW_in
// reads it there), with da1 = sum dh1 * min(hp, 0) per channel of the
// tile's rows (pch_g2). The product then reads W_in's rows K-major (W_in^T,
// no transpose) and its epilogue stores dx = g + dh_pre @ W_in^T. Grid
// (ceil(K / 128), M), block 256.
template <int BN>
__global__ void __launch_bounds__(kWgCta) g2b_wg_kernel(BwdParams p, int cln) {
  extern __shared__ uint8_t wg_smem[];
  const int K = p.K, B = p.B, H = p.H;
  const int nk = H / kSlabK, n_tiles = B / BN, CG = H / 8;
  const int n_rg = kWgCta / CG;
  const uint32_t as = align_1024(wg_smem);
  const uint32_t ring = as + nk * kWgRows * kLine;
  uint8_t* a_gen = smem_ptr(wg_smem, as);
  float* s_da = reinterpret_cast<float*>(
      smem_ptr(wg_smem, ring + kG2Stages * BN * kLine));   // [n_rg][H]
  bf16* st = reinterpret_cast<bf16*>(s_da + n_rg * H);     // staged dx tile
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m = blockIdx.y, bx = blockIdx.x, r0 = bx * kWgRows;
  const bf16* w_in = static_cast<const bf16*>(p.w_in);

  auto form_dh_pre = [&] {
    const int cg = tid % CG, rg = tid / CG, c0 = 8 * cg;
    const float a1 = *p.a1;
    const bf16* hp = static_cast<const bf16*>(p.hp) + static_cast<size_t>(m) * K * H;
    bf16* dh = static_cast<bf16*>(p.dh) + static_cast<size_t>(m) * K * H;
    float gam[8], da[8];
    load8(p.g1 + c0, gam);
#pragma unroll
    for (int j = 0; j < 8; ++j) da[j] = 0.f;
    const int n_rows = kWgRows / n_rg;
#pragma unroll 1
    for (int i = 0; i < n_rows; i += 8) {
      uint4 dn_raw[8], hp_raw[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = r0 + rg + n_rg * (i + u);
        const bool row = i + u < n_rows && k < K;
        const size_t idx = static_cast<size_t>(row ? k : 0) * H + c0;
        dn_raw[u] = row ? *reinterpret_cast<const uint4*>(dh + idx)
                        : make_uint4(0u, 0u, 0u, 0u);
        hp_raw[u] = row ? ldg16(hp + idx) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i + u >= n_rows) break;
        const int rl = rg + n_rg * (i + u), k = r0 + rl;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (k < K) {
          const float* st = stat_at(p, cln, m, k);
          const float mean1 = st[kMean1], rs1 = st[kRs1];
          const float u1 = st[kU1], u2 = st[kU2];
          float dn[8], hv[8];
          unpack8(dn_raw[u], dn);
          unpack8(hp_raw[u], hv);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float hh = (prelu(hv[j], a1) - mean1) * rs1;
            const float dh1 = rs1 * (gam[j] * dn[j] - u1 - hh * u2);
            da[j] += dh1 * fminf(hv[j], 0.f);
            v[j] = hv[j] >= 0.f ? dh1 : a1 * dh1;
          }
        }
        const uint4 packed = pack8(v);
        if (k < K)
          *reinterpret_cast<uint4*>(dh + static_cast<size_t>(k) * H + c0) = packed;
        *reinterpret_cast<uint4*>(a_gen + (cg >> 3) * kWgRows * kLine +
                                  swz(rl, cg & 7)) = packed;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) s_da[rg * H + c0 + j] = da[j];
  };

  float acc[BN / 2];
  ring_run<kG2Stages>(
      n_tiles * nk, ring, BN * kLine,
      [&](int i, uint32_t slot) {
        load_k_panel(slot, w_in, H, (i / nk) * BN, BN, B, (i % nk) * kSlabK,
                     tid, kWgCta);
      },
      form_dh_pre,
      [&](int i, uint32_t slot) {
        const int s = i % nk;
        mma_begin(acc);
        mma_slab<BN, false, false>(acc, as + s * kWgRows * kLine + wg * 64 * kLine,
                                   slot, s > 0);
        mma_end(acc);
        if (s != nk - 1) return;
        const int n0 = (i / nk) * BN;
        const bf16* g = static_cast<const bf16*>(p.g) + static_cast<size_t>(m) * K * B;
        bf16* dx = static_cast<bf16*>(p.dx) + static_cast<size_t>(m) * K * B;
        // g's tile in through the stage, dx = g + ... in place, dx out
        stage_load<BN>(st, g, B, r0, K, n0, tid);
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          __nv_bfloat162* sg = reinterpret_cast<__nv_bfloat162*>(
              &st[(64 * wg + acc_row(t, j)) * stage_ld<BN>() + acc_col(t, j)]);
          const float2 gv = __bfloat1622float2(*sg);
          *sg = __floats2bfloat162_rn(gv.x + acc[j], gv.y + acc[j + 1]);
        }
        __syncthreads();
        stage_store<BN>(st, dx, B, r0, K, n0, tid);
      });
  // s_da was written before the ring's first barrier
  for (int ch = tid; ch < H; ch += kWgCta) {
    float da = 0.f;
    for (int rg = 0; rg < n_rg; ++rg) da += s_da[rg * H + ch];
    p.pch_g2[(static_cast<size_t>(m) * gridDim.x + bx) * H + ch] = da;
  }
}

template <int BN>
int launch_g2b_bn(const BwdParams& p, int cln, cudaStream_t stream) {
  const size_t smem = g2b_wg_smem(p.B, p.H);
  if (smem > kMaxDynSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = g2b_wg_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.K + kWgRows - 1) / kWgRows, p.M), kWgCta, smem, stream>>>(
      p, cln);
  return static_cast<int>(cudaGetLastError());
}

int launch_g2b_wg(const BwdParams& p, int cln, cudaStream_t stream) {
  if (staged_bn(p.B) == 128) return launch_g2b_bn<128>(p, cln, stream);
  return launch_g2b_bn<64>(p, cln, stream);
}

constexpr int kWgradStages = 4;

template <int kWG, int BN>
int launch_wgrad_bn(const bf16* a, const bf16* b, int rows, int ca, int cb,
                    float* wpart, cudaStream_t stream) {
  constexpr size_t smem = wgrad_wg_smem<kWG, BN, kWgradStages>();
  auto kernel = wgrad_wg_kernel<kWG, BN, kWgradStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ca / (64 * kWG), cb / BN, (rows + kChunkRows - 1) / kChunkRows),
           kWG * kWgThreads, smem, stream>>>(a, b, rows, ca, cb, kChunkRows,
                                             wpart);
  return static_cast<int>(cudaGetLastError());
}

template <int kWG>
int launch_wgrad_wg_tile(const bf16* a, const bf16* b, int rows, int ca,
                         int cb, float* wpart, cudaStream_t stream) {
  switch (wg_bn(cb)) {
    case 256: return launch_wgrad_bn<kWG, 256>(a, b, rows, ca, cb, wpart, stream);
    case 128: return launch_wgrad_bn<kWG, 128>(a, b, rows, ca, cb, wpart, stream);
    default: return launch_wgrad_bn<kWG, 64>(a, b, rows, ca, cb, wpart, stream);
  }
}

// W': out [ca, cb] = a^T @ b over all rows, on the core: each CTA (two
// warpgroups, a 128-row output tile; one where ca is an odd multiple of
// 64) sums one chunk of kChunkRows rows into an f32 partial tile, and
// reduce_chunks_kernel adds the chunks in a fixed order.
int launch_wgrad_wg(const void* a, const void* b, int rows, int ca, int cb,
                    float* wpart, float* out, cudaStream_t stream) {
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  if (ca % 128 == 0)
    CTN_TRY(launch_wgrad_wg_tile<2>(pa, pb, rows, ca, cb, wpart, stream));
  else
    CTN_TRY(launch_wgrad_wg_tile<1>(pa, pb, rows, ca, cb, wpart, stream));
  const int n_chunks = (rows + kChunkRows - 1) / kChunkRows;
  reduce_chunks_kernel<<<(ca * cb + 255) / 256, 256, 0, stream>>>(
      wpart, n_chunks, ca * cb, out);
  CTN_CHECK();
  return 0;
}

// The bf16 backward: R1 F1 R2' F2, G1', F3, W' (dW_out), E2', F4, G2b',
// W' (dW_in), S. Every per-tile partial is per 128-row tile.
template <int kNorm>
int launch_bwd_wg(const BwdParams& p, cudaStream_t stream) {
  constexpr bool kCln = kNorm == kNormCLN;
  const int M = p.M, K = p.K, B = p.B, H = p.H;
  if (!dw_layout_ok(H)) return static_cast<int>(cudaErrorInvalidValue);
  const double count = static_cast<double>(K) * H;
  const int n_rows = M * K;
  const int fin_blocks = (n_rows + 255) / 256;
  const int kt = (K + kWgRows - 1) / kWgRows;
  const int cg = H / 8, n_seg = cg < 32 ? 1 : cg / 32;
  CTN_TRY(recompute_block_wg<kNorm>(p, stream));
  CTN_TRY(launch_g1_wg(p, kCln, stream));
  if constexpr (kCln)
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part, g1_row_parts(H), n_rows, H, p.stats, kT1, 1);
  else
    finalize_kernel<<<M, 256, 0, stream>>>(p.part, kt, count, p.stats, kT1, 1);
  CTN_CHECK();
  CTN_TRY(launch_wgrad_wg(p.hn2, p.g, M * K, H, B, p.wpart, p.dw_out, stream));
  // E2': dc once per row in shared memory where it fits, else per tap
  const size_t dc_smem = e2_dc_smem(K, p.dilation);
  const bool dc_tile = p.P == 3 && dc_smem <= kMaxDynSmem - 16384;
  int n_u = 1;   // E2''s partials per row tile (gLN) or per row (cLN)
  if (dc_tile) {
    CTN_TRY(static_cast<int>(cudaFuncSetAttribute(
        e2_dc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dc_smem))));
    e2_dc_kernel<<<dim3(kt, H / kE2Cols, M), kWgCta, dc_smem, stream>>>(p,
                                                                      kCln);
    n_u = H / kE2Cols;
  } else {
    e2_wg_kernel<<<dim3(kt, M), kWgCta, 0, stream>>>(p, kCln);
    n_u = kCln ? n_seg : 1;
  }
  CTN_CHECK();
  if constexpr (kCln)
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part, n_u, n_rows, H, p.stats, kU1, 1);
  else
    finalize_kernel<<<M, 256, 0, stream>>>(p.part, kt * n_u, count, p.stats,
                                           kU1, 1);
  CTN_CHECK();
  CTN_TRY(launch_g2b_wg(p, kCln, stream));
  CTN_TRY(launch_wgrad_wg(p.x, p.dh, M * K, B, H, p.wpart, p.dw_in, stream));
  reduce_channels_kernel<<<dim3((H + 31) / 32, p.P + 6), dim3(32, kRedGroups),
                           0, stream>>>(p, kt, kt);
  CTN_CHECK();
  reduce_slopes_kernel<<<1, 256, 0, stream>>>(p);
  CTN_CHECK();
  return 0;
}

// ---- One block's backward in the design of its dtype and widths ----

// Workspace layout of one block's backward, shared by the size query and
// the launch. Every segment starts on a 256-byte boundary.
struct BwdLayout {
  size_t act[7];   // w_in_t, w_out_t, hp, c, e, hn2, dh (elements)
  size_t f32[8];   // stats, part, part2, pch_g1, pch_e1, pch_e2, pch_g2,
                   // wpart
  size_t n_act, n_f32;
};

inline BwdLayout bwd_layout(int M, int K, int B, int H, int P,
                            size_t act_bytes, int norm) {
  BwdLayout L;
  const size_t kt = row_tiles(K), rt = dw_row_tiles(K), ct = dw_col_tiles(H);
  const long long rows = static_cast<long long>(M) * K;
  // partials per sample (gLN: one per tile) or per row (cLN: one per
  // column tile); part holds R1's, G1's and E2's, part2 R2's
  const bool cln = norm == kNormCLN;
  const size_t n_r1 = cln ? H / kBN : kt * (H / kBN);
  const size_t n_dw = cln ? ct : rt * ct;
  const size_t n_rows = cln ? static_cast<size_t>(rows) : M;
  const size_t n_part = n_r1 > n_dw ? n_r1 : n_dw;
  const size_t n_chunks = (rows + kChunkRows - 1) / kChunkRows;
  const size_t mkh = static_cast<size_t>(M) * K * H;
  const size_t act_sizes[7] = {static_cast<size_t>(H) * B,
                               static_cast<size_t>(B) * H, mkh, mkh, mkh, mkh,
                               mkh};
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    L.act[i] = off;
    off += align_up(act_sizes[i], 256 / act_bytes);
  }
  L.n_act = off;
  const size_t f32_sizes[8] = {
      n_rows * kNumStats,
      2 * n_rows * n_part,
      2 * n_rows * n_dw,
      2 * static_cast<size_t>(M) * kt * H,
      static_cast<size_t>(M) * rt * H,
      static_cast<size_t>(M) * rt * (P + 2) * H,
      static_cast<size_t>(M) * rt * H,
      n_chunks * B * H};
  off = 0;
  for (int i = 0; i < 8; ++i) {
    L.f32[i] = off;
    off += align_up(f32_sizes[i], 64);
  }
  L.n_f32 = off;
  return L;
}

// Points p's intermediates at a workspace of layout L: ws_act in the
// compute dtype T, ws_f32 in floats.
template <typename T>
void bind_bwd_workspace(BwdParams* p, const BwdLayout& L, void* ws_act,
                        float* ws_f32) {
  T* act = static_cast<T*>(ws_act);
  p->w_in_t = act + L.act[0];
  p->w_out_t = act + L.act[1];
  p->hp = act + L.act[2];
  p->c = act + L.act[3];
  p->e = act + L.act[4];
  p->hn2 = act + L.act[5];
  p->dh = act + L.act[6];
  p->stats = ws_f32 + L.f32[0];
  p->part = ws_f32 + L.f32[1];
  p->part2 = ws_f32 + L.f32[2];
  p->pch_g1 = ws_f32 + L.f32[3];
  p->pch_e1 = ws_f32 + L.f32[4];
  p->pch_e2 = ws_f32 + L.f32[5];
  p->pch_g2 = ws_f32 + L.f32[6];
  p->wpart = ws_f32 + L.f32[7];
}

// One block's backward (B2 gLN, B3 cLN) on a bound workspace (p.left
// set): these stages for bf16 at wg_widths_ok, else the first design's
// launches (tcn_block_bwd_common.cuh). The gLN block pair's backward (B5)
// runs each of its blocks through this.
template <typename T, int kNorm>
int launch_block_bwd(const BwdParams& p, cudaStream_t stream) {
  static_assert(kNorm == kNormGLN || kNorm == kNormCLN, "gLN or cLN");
  const int M = p.M, K = p.K, B = p.B, H = p.H;
  if constexpr (std::is_same<T, bf16>::value) {
    if (wg_widths_ok(B, H)) return launch_bwd_wg<kNorm>(p, stream);
  }
  const int kt = row_tiles(K);
  const int n_chunks = static_cast<int>(
      (static_cast<long long>(M) * K + kChunkRows - 1) / kChunkRows);
  CTN_TRY(launch_transposes<T>(p, stream));
  CTN_TRY(recompute_block<T, kNorm>(p, stream));
  g1_kernel<T, kNorm><<<dim3(kt, H / kBN, M), kGemmThreads, 0, stream>>>(p);
  CTN_CHECK();
  CTN_TRY(block_bwd_middle<T, kNorm>(p, n_chunks, stream));
  g2b_kernel<T><<<dim3(kt, B / kBN, M), kGemmThreads, 0, stream>>>(p);
  CTN_CHECK();
  return block_bwd_tail<T>(p, n_chunks, stream);
}

}  // namespace
