// The f32 stages of the TCN block backward, gLN (B2) and cLN (B3), on the
// 3xTF32 product core (hopper_gemm_tf32.cuh), for f32 blocks at
// wg_widths_ok: the bf16 stages' sequence (tcn_block_bwd_hopper.cuh)
// rebuilt for f32, E1 folded into E2' and G2a into G2b' as there, so the
// first design's transposes and its E1 and G2a passes are gone:
//
//   prep  W_in^T, W_out and W_in as K-major tf32 hi and lo copies, once
//         per call (prep_tf32_kernel, bwd 1; the workspace's w_in_t
//         segment, 6 B H floats).
//   R1    hp = x @ W_in: the forward's A' with kPre, then F1.
//   R2'   c = dwconv(norm1(PReLU(hp))): the forward's B' with kPre, then F2.
//   G1'   e = g @ W_out^T, streamed as A' streams x; its epilogue stores e
//         and hn2 = norm2(PReLU(c)) from the accumulators, sums t1, t2 per
//         CTA and dg2, db2 per channel (each column's lanes by shuffles, the
//         8 warps in order through shared memory). Then F3.
//   W'    dW_out = hn2^T g (wgrad_tf32_kernel: mma.sync, chunks of 1024
//         rows added in order).
//   E2'   dhn1, d_dw, dg1, db1, da2 and the sums u1, u2, dc formed at each
//         row it is read (E1 folded in), as the bf16 e2_wg_kernel; 4
//         channels a thread (16-byte loads), so that P = 3's taps, rows and
//         sums stay in registers (a port of the bf16 e2_dc_kernel, dc once
//         per row in shared memory, ran slower on an H100 at the paper
//         shape). Then F4.
//   G2b'  its prologue forms dh_pre = rs1 (g1 dhn1 - u1 - hhat1 u2)
//         PReLU'(hp) over dhn1 in device memory for its 128 rows (G2a
//         folded in; da1 per channel), then dx = g + dh_pre @ W_in^T streams
//         those rows back through the ring (from L2).
//   W'    dW_in = x^T dh_pre.
//   S     the per-channel partials summed in a fixed order, then da1, da2.
//
// gLN: 16 launches, each statistic one per sample (n = K Hn). cLN (kCln):
// each statistic spans one row's Hn channels (n = Hn), kept per row in
// stats [M K, kNumStats], and the sequence takes 14 launches:
//   R1    A' with kPre walks all H columns of its rows and writes each
//         row's (mean1, rs1) to part (as the forward writes them for B');
//   R2'   B' with kPre reads them there and writes norm2's partials per
//         row and 32-lane segment to part2; F1/F2 (cln_rows_tf32_kernel)
//         copies (mean1, rs1) into stats and takes (mean2, rs2) by
//         row_stats, as C' does;
//   G1'   a row's columns are one quad's accumulators, so each thread
//         keeps its two rows' t1, t2 over the column tiles in order, and
//         after the quad's shuffles writes t1 / n, t2 / n to the row's
//         statistics itself (no F3);
//   E2'   dc of each row read with that row's (mean2, rs2, t1, t2), hn1 of
//         a tap row with its (mean1, rs1); at P = 3 the 128-row tile's
//         statistics are staged in shared memory once (own rows, the rows
//         each tap feeds and reads: 12 KB; read per tap instead, E2' took
//         231 us against 131 on an H100 at the paper shape, 146 registers
//         against 126), past P = 3 read per tap from device memory; u1,
//         u2 per row and 32-lane segment (the segment's own shuffle
//         mask: at H = 64 a warp holds two rows), then F4
//         (finalize_rows_kernel, divided by Hn);
//   G2b'  the tile's rows' (mean1, rs1, u1, u2) staged once for its
//         prologue.
// Every partial is per 128-row tile, row or segment, and every sum is
// taken in a fixed order (in double where the first design's are), so two
// runs give the same bits. Registers (nvcc -Xptxas -v, sm_90a): G1' 191
// and G2b' 186 at BN = 128 (125-127 at 64), W' 242-247, E2' 128 at P = 3
// and 124 past 16 taps, no spills; E2' at other P <= 16 holds its 16-tap
// arrays in 255 registers and 820 bytes of spills (a route off the paper
// config). cLN: G1' 191 (124 at 64), G2b' 187 (121), E2' 126 at P = 3
// and 128 past 16 taps, no spills, 255 with 832 bytes of spill stores at
// other P <= 16; F1/F2 32. Shared memory: G1' 201 KB, G2b' 197 KB (cLN
// 2 KB more), W' 103 KB (two CTAs an SM), E2' 4 KB (cLN at P = 3: 16 KB).

#pragma once

#include "tcn_block_bwd_common.cuh"
#include "tcn_block_tf32.cuh"

namespace {

// G1': e = g @ W_out^T for rows [r0, r0 + 128) of sample blockIdx.y, all H
// columns (maps: g, W_out's split, [H, B] K-major as stored). Its epilogue
// loads the tile's c first (every load before any store, so that their
// latency is paid once a tile), then takes each column pair of the
// accumulators: e and hn2 = g2 hhat2 + b2
// (hhat2 from c and the sample's mean2, rs2) to device memory, t1 = sum g2
// e and t2 = sum g2 e hhat2 into the thread's sums (block_sum2 at the end:
// part[m * gridDim.x + blockIdx.x]), and dg2 = sum e hhat2, db2 = sum e
// per channel of the tile's rows: a column's 8 lanes of a warp by
// shuffles, then the CTA's 8 warps in order through s_col, to pch_g1[2 (m
// gridDim.x + blockIdx.x) H + channel] and [.. + H]. kCln: hhat2 from each
// row's mean2, rs2, and t1 / n, t2 / n of each row to its statistics (the
// top note). Grid (ceil(K / 128), M), block 256.
template <int BN, bool kCln = false>
__global__ void __launch_bounds__(kWgCta)
    g1_tf32_kernel(const __grid_constant__ RowsMaps maps, BwdParams p) {
  extern __shared__ uint8_t wg_smem[];
  const int K = p.K, B = p.B, H = p.H;
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int m = blockIdx.y, bx = blockIdx.x, r0 = bx * kWgRows;
  const uint32_t ring = align_1024(wg_smem);
  float* s_col = reinterpret_cast<float*>(
      smem_ptr(wg_smem, ring + rows_tf32_ring_bytes<BN, kTf32Stages>()));
  const float* st = p.stats + static_cast<size_t>(m) * kNumStats;
  const float mu2 = st[kMean2], rs2 = st[kRs2], a2 = *p.a2;
  const size_t base = static_cast<size_t>(m) * K * H;
  const float* c = static_cast<const float*>(p.c) + base;
  float* e = static_cast<float*>(p.e) + base;
  float* hn2 = static_cast<float*>(p.hn2) + base;
  float t1 = 0.f, t2 = 0.f;
  // cLN: the (mean2, rs2) of the thread's two rows, and their t1, t2 sums
  // over the column tiles in order
  float rmu[2] = {0.f, 0.f}, rrs[2] = {1.f, 1.f}, rt[2][2] = {};
  if constexpr (kCln) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 64 * wg + acc_row(t, 2 * u);
      if (r >= K) continue;
      const float* sr = p.stats + (static_cast<size_t>(m) * K + r) * kNumStats;
      rmu[u] = sr[kMean2];
      rrs[u] = sr[kRs2];
    }
  }
  rows_tf32_run<BN, kTf32Stages>(
      wg_smem, ring, maps, m, r0, B, H,
      [&](float (&acc)[BN / 2], int n0) {
        float2 cvs[BN / 4];   // every load of the tile's c first
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const int r = r0 + 64 * wg + acc_row(t, j);
          cvs[j / 2] = r < K ? __ldg(reinterpret_cast<const float2*>(
                                   &c[static_cast<size_t>(r) * H + n0 +
                                      acc_col(t, j)]))
                             : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < BN / 2; i += 4) {   // columns 8 (i / 4) + 2 (t % 4)
          const int cl = acc_col(t, i), ch = n0 + cl;
          const float2 gam = __ldg(reinterpret_cast<const float2*>(p.g2 + ch));
          const float2 bet = __ldg(reinterpret_cast<const float2*>(p.b2 + ch));
          float dg[2] = {0.f, 0.f}, db[2] = {0.f, 0.f};
#pragma unroll
          for (int u = 0; u < 2; ++u) {   // the thread's two rows
            const int r = r0 + 64 * wg + acc_row(t, i + 2 * u);
            if (r >= K) continue;
            const size_t idx = static_cast<size_t>(r) * H + ch;
            const float2 cv = cvs[i / 2 + u];
            const float e0 = acc[i + 2 * u], e1 = acc[i + 2 * u + 1];
            const float mu = kCln ? rmu[u] : mu2, rs = kCln ? rrs[u] : rs2;
            const float h0 = (prelu(cv.x, a2) - mu) * rs;
            const float h1 = (prelu(cv.y, a2) - mu) * rs;
            *reinterpret_cast<float2*>(&e[idx]) = make_float2(e0, e1);
            *reinterpret_cast<float2*>(&hn2[idx]) =
                make_float2(gam.x * h0 + bet.x, gam.y * h1 + bet.y);
            if constexpr (kCln) {
              rt[u][0] += gam.x * e0 + gam.y * e1;
              rt[u][1] += gam.x * e0 * h0 + gam.y * e1 * h1;
            } else {
              t1 += gam.x * e0 + gam.y * e1;
              t2 += gam.x * e0 * h0 + gam.y * e1 * h1;
            }
            dg[0] += e0 * h0;
            dg[1] += e1 * h1;
            db[0] += e0;
            db[1] += e1;
          }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              dg[v] += __shfl_xor_sync(0xffffffffu, dg[v], o);
              db[v] += __shfl_xor_sync(0xffffffffu, db[v], o);
            }
          if (lane < 4) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              s_col[(2 * warp) * BN + cl + v] = dg[v];
              s_col[(2 * warp + 1) * BN + cl + v] = db[v];
            }
          }
        }
        __syncthreads();
        for (int cl = tid; cl < BN; cl += kWgCta) {
          float sg = 0.f, sb = 0.f;
          for (int w8 = 0; w8 < kWgCta / 32; ++w8) {
            sg += s_col[(2 * w8) * BN + cl];
            sb += s_col[(2 * w8 + 1) * BN + cl];
          }
          float* dst = p.pch_g1 +
              2 * (static_cast<size_t>(m) * gridDim.x + bx) * H + n0 + cl;
          dst[0] = sg;
          dst[H] = sb;
        }
        // s_col is read before the next tile's epilogue writes it: the
        // ring's barriers in between
      });
  if constexpr (kCln) {
    // a row's columns are its quad's: t1 / n, t2 / n to its statistics
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float q1 = group_sum(rt[u][0], 4), q2 = group_sum(rt[u][1], 4);
      const int r = r0 + 64 * wg + acc_row(t, 2 * u);
      if ((t & 3) == 0 && r < K) {
        float* sr = p.stats + (static_cast<size_t>(m) * K + r) * kNumStats;
        sr[kT1] = static_cast<float>(static_cast<double>(q1) / p.Hn);
        sr[kT2] = static_cast<float>(static_cast<double>(q2) / p.Hn);
      }
    }
  } else {
    block_sum2(t1, t2);
    if (tid == 0) {
      float* dst = p.part + 2 * (static_cast<size_t>(m) * gridDim.x + bx);
      dst[0] = t1;
      dst[1] = t2;
    }
  }
}

template <bool kCln>
int launch_g1_tf32(const BwdParams& p, const float* w, cudaStream_t stream) {
  constexpr size_t kCol = 2 * (kWgCta / 32) * sizeof(float);   // per column
  const int bn = staged_bn(p.H);
  RowsMaps maps;
  CTN_TRY(make_rows_maps(&maps, static_cast<const float*>(p.g), p.M, p.K,
                         p.B, w, p.H, bn));
  if (bn == 128)
    return launch_rows_tf32(g1_tf32_kernel<128, kCln>,
                            rows_tf32_smem<128, kTf32Stages>() + 128 * kCol,
                            p.K, p.M, stream, maps, p);
  return launch_rows_tf32(g1_tf32_kernel<64, kCln>,
                          rows_tf32_smem<64, kTf32Stages>() + 64 * kCol, p.K,
                          p.M, stream, maps, p);
}

// E2' (E1 folded in) in f32 on 4 channels a thread: CG = H / 4 channel
// groups, n_rg = 256 / CG row groups, rows rg + n_rg i of the 128-row tile.
// For each of its rows j and channels it forms
//   dc(r) = rs2 (g2 e - t1 - hhat2 t2) PReLU'(c) at r = j and at the rows
//           j - q d + left that tap q of j fed (E1's value, no pass),
//   dhn1[j] = sum_q dw[q] dc(j - q d + left)   (to p.dh),
// and sums d_dw[q] += dc(j) hn1[j + q d - left], dg1 += dhn1 hhat1, db1 +=
// dhn1, da2 += dh2(j) min(c[j], 0) per channel (its row groups added in
// order through s_red into pch_e2 and pch_e1 at tile m gridDim.x +
// blockIdx.x), and u1 = sum g1 dhn1, u2 = sum g1 dhn1 hhat1 per tile (part).
// kTaps: 3 for P = 3 (every per-tap array in registers), else kMaxTaps
// (per-thread arrays of 16 taps, any P <= 16). kTapChunks (P > 16): the
// walk over the rows forms everything but d_dw, reading each tap as it
// reaches it, and d_dw follows in chunks of 16 taps, each a walk over the
// same rows in the same order, so every sum is formed in the order it is at
// P <= 16. kCln: every statistic the row's that it normalises (staged at
// P = 3), u1, u2 per row and segment (the top note). Grid (ceil(K / 128),
// M), block 256.
template <int kTaps, bool kTapChunks = false, bool kCln = false>
__global__ void __launch_bounds__(kWgCta) e2_tf32_kernel(BwdParams p) {
  __shared__ float s_red[kWgCta * 4];   // [n_rg][H]
  // cLN at P = 3: the statistics of the rows the tile reads, staged once
  constexpr bool kStage = kCln && kTaps == 3 && !kTapChunks;
  __shared__ float4 s_st[kStage ? 6 * kWgRows : 1];
  const int K = p.K, H = p.H, P = kTaps == 3 ? 3 : p.P, d = p.dilation;
  const int left = p.left;
  const int CG = H / 4, n_rg = kWgCta / CG;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG, c0 = 4 * cg;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  const float a1 = *p.a1, a2 = *p.a2;
  const size_t base = static_cast<size_t>(m) * K * H;
  const float* hp = static_cast<const float*>(p.hp) + base;
  const float* cc = static_cast<const float*>(p.c) + base;
  const float* e = static_cast<const float*>(p.e) + base;
  const float* dwp = static_cast<const float*>(p.dw);
  float* dhn1 = static_cast<float*>(p.dh) + base;
  const float* st = p.stats + static_cast<size_t>(m) * kNumStats;
  const float mean1 = st[kMean1], rs1 = st[kRs1], mean2 = st[kMean2];
  const float rs2 = st[kRs2], t1 = st[kT1], t2 = st[kT2];
  auto ld4 = [](const float* q) {
    return __ldg(reinterpret_cast<const float4*>(q));
  };
  auto arr = [](const float4& v, float (&f)[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  };
  float gam[4], bet[4], gam2[4], sc[4], sh[4];
  arr(*reinterpret_cast<const float4*>(p.g1 + c0), gam);
  arr(*reinterpret_cast<const float4*>(p.b1 + c0), bet);
  arr(*reinterpret_cast<const float4*>(p.g2 + c0), gam2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = rs1 * gam[j];
    sh[j] = bet[j] - mean1 * sc[j];
  }
  float w[kTaps][4], ddw[kTaps][4], dg[4], db[4], da2[4];
  if constexpr (!kTapChunks) {
#pragma unroll
    for (int q = 0; q < kTaps; ++q) {
      if (q >= P) break;
      arr(ld4(dwp + static_cast<size_t>(q) * H + c0), w[q]);
#pragma unroll
      for (int j = 0; j < 4; ++j) ddw[q][j] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) dg[j] = db[j] = da2[j] = 0.f;
  float u1 = 0.f, u2 = 0.f;
  // cLN: row r's (mean2, rs2, t1, t2) and (mean1, rs1), from device memory
  const float* st_rows = p.stats + static_cast<size_t>(m) * K * kNumStats;
  auto st2_at = [&](int r) {
    const float* sr = st_rows + static_cast<size_t>(r) * kNumStats;
    return make_float4(sr[kMean2], sr[kRs2], sr[kT1], sr[kT2]);
  };
  auto st1_at = [&](int r) {
    const float* sr = st_rows + static_cast<size_t>(r) * kNumStats;
    return make_float2(sr[kMean1], sr[kRs1]);
  };
  if constexpr (kStage) {
    // s_st: [0, 128) the own rows' st2, [128 (1 + q), ..) tap q's fed row
    // j - q d + left's st2, then as float2 pairs at 512: the own rows'
    // st1 and tap q's read row j + q d - left's st1; rows outside [0, K)
    // are never read
    float2* s_st1 = reinterpret_cast<float2*>(s_st + 4 * kWgRows);
    for (int v = tid; v < 8 * kWgRows; v += kWgCta) {
      const int kind = v / kWgRows, rl = v % kWgRows, q = kind % 4 - 1;
      const int r = r0 + rl + (kind % 4 == 0 ? 0
                               : kind < 4 ? left - q * d : q * d - left);
      if (r < 0 || r >= K) continue;
      if (kind < 4)
        s_st[v] = st2_at(r);
      else
        s_st1[v - 4 * kWgRows] = st1_at(r);
    }
    __syncthreads();
  }
  // dc at a row from its c and e; da, when given, gets dh2 * min(c, 0)
  auto dc4 = [&](const float4& c4, const float4& e4, float (&dc)[4],
                 float* da) {
    float cv[4], ev[4];
    arr(c4, cv);
    arr(e4, ev);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hh = (prelu(cv[j], a2) - mean2) * rs2;
      const float dh2 = rs2 * (gam2[j] * ev[j] - t1 - hh * t2);
      if (da) da[j] += dh2 * fminf(cv[j], 0.f);
      dc[j] = cv[j] >= 0.f ? dh2 : a2 * dh2;
    }
  };
  // hn1 of a tap row's raw hp into d_dw[q] with dc(j)
  auto dw_tap = [&](const float4& h4, const float (&dcj)[4], float (&dd)[4]) {
    float hv[4];
    arr(h4, hv);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      dd[jj] = fmaf(dcj[jj], prelu(hv[jj], a1) * sc[jj] + sh[jj], dd[jj]);
  };
  // cLN: dc4 with the row's s = (mean2, rs2, t1, t2), dw_tap with the tap
  // row's s1 = (mean1, rs1)
  auto dc4_row = [&](const float4& c4, const float4& e4, const float4& s,
                     float (&dc)[4], float* da) {
    float cv[4], ev[4];
    arr(c4, cv);
    arr(e4, ev);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hh = (prelu(cv[j], a2) - s.x) * s.y;
      const float dh2 = s.y * (gam2[j] * ev[j] - s.z - hh * s.w);
      if (da) da[j] += dh2 * fminf(cv[j], 0.f);
      dc[j] = cv[j] >= 0.f ? dh2 : a2 * dh2;
    }
  };
  auto dw_tap_row = [&](const float4& h4, const float2& s1,
                        const float (&dcj)[4], float (&dd)[4]) {
    float hv[4];
    arr(h4, hv);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      dd[jj] = fmaf(dcj[jj], (prelu(hv[jj], a1) - s1.x) * s1.y * gam[jj] +
                                 bet[jj], dd[jj]);
  };
  // cLN: a row's sums over its CG lanes, one partial per segment of seg
  // lanes (the segment's own mask: a warp may hold two rows)
  const int seg = CG < 32 ? CG : 32, n_seg = CG / seg, lane = tid & 31;
  const unsigned seg_mask =
      seg == 32 ? 0xffffffffu : ((1u << seg) - 1) << (lane & ~(seg - 1));
  const int n_rows = kWgRows / n_rg;
#pragma unroll 1
  for (int i = 0; i < n_rows; ++i) {
    const int j = r0 + rg + n_rg * i;
    if (j >= K) continue;
    const size_t idx = static_cast<size_t>(j) * H + c0;
    const float4 c_j = ld4(cc + idx), e_j = ld4(e + idx), hp_j = ld4(hp + idx);
    float dcj[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
    [[maybe_unused]] const int rl = j - r0;
    if constexpr (kTapChunks) {
      if constexpr (kCln) dc4_row(c_j, e_j, st2_at(j), dcj, da2);
      else dc4(c_j, e_j, dcj, da2);
      for (int q = 0; q < P; ++q) {
        const int kk = j - q * d + left;   // output row that tap q of j fed
        if (kk < 0 || kk >= K) continue;
        const size_t io = static_cast<size_t>(kk) * H + c0;
        float wq[4], dco[4];
        arr(ld4(dwp + static_cast<size_t>(q) * H + c0), wq);
        if constexpr (kCln)
          dc4_row(ld4(cc + io), ld4(e + io), st2_at(kk), dco, nullptr);
        else
          dc4(ld4(cc + io), ld4(e + io), dco, nullptr);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[jj] = fmaf(wq[jj], dco[jj], acc[jj]);
      }
    } else {
      float4 c_o[kTaps], e_o[kTaps], hp_i[kTaps];
#pragma unroll
      for (int q = 0; q < kTaps; ++q) {   // every load of the row first
        if (q >= P) break;
        const int kk = j - q * d + left, kh = j + q * d - left;
        const bool ok_o = kk >= 0 && kk < K, ok_i = kh >= 0 && kh < K;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        c_o[q] = ok_o ? ld4(cc + static_cast<size_t>(kk) * H + c0) : z;
        e_o[q] = ok_o ? ld4(e + static_cast<size_t>(kk) * H + c0) : z;
        hp_i[q] = ok_i ? ld4(hp + static_cast<size_t>(kh) * H + c0) : z;
      }
      if constexpr (kStage) dc4_row(c_j, e_j, s_st[rl], dcj, da2);
      else if constexpr (kCln) dc4_row(c_j, e_j, st2_at(j), dcj, da2);
      else dc4(c_j, e_j, dcj, da2);
#pragma unroll
      for (int q = 0; q < kTaps; ++q) {
        if (q >= P) break;
        const int kk = j - q * d + left, kh = j + q * d - left;
        if (kk >= 0 && kk < K) {
          float dco[4];
          if constexpr (kStage)
            dc4_row(c_o[q], e_o[q], s_st[(1 + q) * kWgRows + rl], dco,
                    nullptr);
          else if constexpr (kCln)
            dc4_row(c_o[q], e_o[q], st2_at(kk), dco, nullptr);
          else
            dc4(c_o[q], e_o[q], dco, nullptr);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[jj] = fmaf(w[q][jj], dco[jj], acc[jj]);
        }
        if (kh >= 0 && kh < K) {
          if constexpr (kStage)
            dw_tap_row(hp_i[q], reinterpret_cast<const float2*>(
                                    s_st + 4 * kWgRows)[(1 + q) * kWgRows + rl],
                       dcj, ddw[q]);
          else if constexpr (kCln)
            dw_tap_row(hp_i[q], st1_at(kh), dcj, ddw[q]);
          else
            dw_tap(hp_i[q], dcj, ddw[q]);
        }
      }
    }
    *reinterpret_cast<float4*>(dhn1 + idx) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    float hv[4];
    arr(hp_j, hv);
    float2 s1j = make_float2(mean1, rs1);   // cLN: the row's
    if constexpr (kStage)
      s1j = reinterpret_cast<const float2*>(s_st + 4 * kWgRows)[rl];
    else if constexpr (kCln)
      s1j = st1_at(j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float hh = (prelu(hv[jj], a1) - s1j.x) * s1j.y;
      dg[jj] += acc[jj] * hh;
      db[jj] += acc[jj];
      u1 += gam[jj] * acc[jj];
      u2 += gam[jj] * acc[jj] * hh;
    }
    if constexpr (kCln) {   // the row's u1, u2 partials, then the next row's
      for (int o = 1; o < seg; o <<= 1) {
        u1 += __shfl_xor_sync(seg_mask, u1, o);
        u2 += __shfl_xor_sync(seg_mask, u2, o);
      }
      if ((lane & (seg - 1)) == 0) {
        float* dst =
            p.part + 2 * ((static_cast<size_t>(m) * K + j) * n_seg + cg / seg);
        dst[0] = u1;
        dst[1] = u2;
      }
      u1 = u2 = 0.f;
    }
  }
  // per-channel sums of the row groups, in order: d_dw[0..P-1], dg1, db1
  // to pch_e2, da2 to pch_e1
  const size_t tile = static_cast<size_t>(m) * gridDim.x + blockIdx.x;
  auto put = [&](const float (&v)[4], int q) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s_red[rg * H + c0 + jj] = v[jj];
    __syncthreads();
    for (int ch = tid; ch < H; ch += kWgCta) {
      float s = 0.f;
      for (int r = 0; r < n_rg; ++r) s += s_red[r * H + ch];
      if (q < P + 2)
        p.pch_e2[(tile * (P + 2) + q) * H + ch] = s;
      else
        p.pch_e1[tile * H + ch] = s;
    }
    __syncthreads();
  };
  if constexpr (!kTapChunks) {
#pragma unroll
    for (int q = 0; q < kTaps; ++q) {
      if (q >= P) break;   // uniform over the block
      put(ddw[q], q);
    }
  }
  put(dg, P);
  put(db, P + 1);
  put(da2, P + 2);
  // kTapChunks: then d_dw chunk by chunk
  if constexpr (kTapChunks) for (int q0 = 0; q0 < P; q0 += kTaps) {
#pragma unroll
    for (int u = 0; u < kTaps; ++u)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ddw[u][jj] = 0.f;
#pragma unroll 1
    for (int i = 0; i < n_rows; ++i) {
      const int j = r0 + rg + n_rg * i;
      if (j >= K) continue;
      const size_t idx = static_cast<size_t>(j) * H + c0;
      float dcj[4];
      if constexpr (kCln)
        dc4_row(ld4(cc + idx), ld4(e + idx), st2_at(j), dcj, nullptr);
      else
        dc4(ld4(cc + idx), ld4(e + idx), dcj, nullptr);
#pragma unroll
      for (int u = 0; u < kTaps; ++u) {
        const int kh = j + (q0 + u) * d - left;
        if (q0 + u >= P || kh < 0 || kh >= K) continue;
        if constexpr (kCln)
          dw_tap_row(ld4(hp + static_cast<size_t>(kh) * H + c0), st1_at(kh),
                     dcj, ddw[u]);
        else
          dw_tap(ld4(hp + static_cast<size_t>(kh) * H + c0), dcj, ddw[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kTaps; ++u) {
      if (q0 + u >= P) break;   // uniform over the block
      put(ddw[u], q0 + u);
    }
  }
  if constexpr (!kCln) {
    block_sum2(u1, u2);
    if (tid == 0) {
      float* dst = p.part + 2 * tile;
      dst[0] = u1;
      dst[1] = u2;
    }
  }
}

// G2b' (G2a folded in): for rows [r0, r0 + 128) of sample blockIdx.y its
// prologue forms dh_pre = rs1 (g1 dhn1 - u1 - hhat1 u2) PReLU'(hp) from
// dhn1 and hp on 4 channels a thread, eight rows' loads at once, and writes
// it over dhn1 in device memory (each element by the thread that read it;
// dW_in reads it there too), with da1 = sum dh1 min(hp, 0) per channel of
// the tile's rows (pch_g2, its row groups in order). The product then
// streams those rows back through the ring (the CTA's own writes, from L2,
// after a barrier; maps: dh, W_in's split, [B, H] K-major as stored),
// and the epilogue loads the tile's g (all before any store) and stores
// dx = g + dh_pre @ W_in^T. kCln: each row's rs1, u1, u2 (staged). Grid
// (ceil(K / 128), M), block 256.
template <int BN, bool kCln = false>
__global__ void __launch_bounds__(kWgCta)
    g2b_tf32_kernel(const __grid_constant__ RowsMaps maps, BwdParams p) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ float s_da[kWgCta * 4];   // [n_rg][H]
  __shared__ float4 s_rst[kCln ? kWgRows : 1];   // cLN: (mean1, rs1, u1, u2)
  const int K = p.K, B = p.B, H = p.H;
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m = blockIdx.y, bx = blockIdx.x, r0 = bx * kWgRows;
  const size_t base = static_cast<size_t>(m) * K * H;
  float* dh = static_cast<float*>(p.dh) + base;
  {
    const int CG = H / 4, n_rg = kWgCta / CG;
    const int cg = tid % CG, rg = tid / CG, c0 = 4 * cg;
    const float* hp = static_cast<const float*>(p.hp) + base;
    const float* st = p.stats + static_cast<size_t>(m) * kNumStats;
    const float mean1 = st[kMean1], rs1 = st[kRs1], u1 = st[kU1];
    const float u2 = st[kU2], a1 = *p.a1;
    const float4 g4 = *reinterpret_cast<const float4*>(p.g1 + c0);
    const float gam[4] = {g4.x, g4.y, g4.z, g4.w};
    float da[4] = {0.f, 0.f, 0.f, 0.f};
    const int n_rows = kWgRows / n_rg;
    if constexpr (kCln) {   // the tile's rows' statistics, staged once
      for (int rl = tid; rl < kWgRows; rl += kWgCta) {
        if (r0 + rl >= K) continue;
        const float* sr =
            p.stats + (static_cast<size_t>(m) * K + r0 + rl) * kNumStats;
        s_rst[rl] = make_float4(sr[kMean1], sr[kRs1], sr[kU1], sr[kU2]);
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int i = 0; i < n_rows; i += 8) {
      float4 dn4[8], hp4[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = r0 + rg + n_rg * (i + u);
        const bool row = i + u < n_rows && k < K;
        const size_t idx = static_cast<size_t>(row ? k : 0) * H + c0;
        dn4[u] = row ? *reinterpret_cast<const float4*>(dh + idx)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        hp4[u] = row ? __ldg(reinterpret_cast<const float4*>(hp + idx))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = r0 + rg + n_rg * (i + u);
        if (i + u >= n_rows || k >= K) continue;
        const float dn[4] = {dn4[u].x, dn4[u].y, dn4[u].z, dn4[u].w};
        const float hv[4] = {hp4[u].x, hp4[u].y, hp4[u].z, hp4[u].w};
        const float4 sk =
            kCln ? s_rst[k - r0] : make_float4(mean1, rs1, u1, u2);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float hh = (prelu(hv[j], a1) - sk.x) * sk.y;
          const float dh1 = sk.y * (gam[j] * dn[j] - sk.z - hh * sk.w);
          da[j] += dh1 * fminf(hv[j], 0.f);
          v[j] = hv[j] >= 0.f ? dh1 : a1 * dh1;
        }
        *reinterpret_cast<float4*>(dh + static_cast<size_t>(k) * H + c0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s_da[rg * H + c0 + j] = da[j];
    // dh_pre's rows to the TMA copies that read them back
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    __syncthreads();
    for (int ch = tid; ch < H; ch += kWgCta) {
      float s = 0.f;
      for (int r = 0; r < n_rg; ++r) s += s_da[r * H + ch];
      p.pch_g2[(static_cast<size_t>(m) * gridDim.x + bx) * H + ch] = s;
    }
  }
  const float* g = static_cast<const float*>(p.g) + static_cast<size_t>(m) * K * B;
  float* dx = static_cast<float*>(p.dx) + static_cast<size_t>(m) * K * B;
  rows_tf32_run<BN, kTf32Stages>(
      wg_smem, align_1024(wg_smem), maps, m, r0, H, B,
      [&](float (&acc)[BN / 2], int n0) {
        float2 gv[BN / 4];   // every load of the tile's g first
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const int r = r0 + 64 * wg + acc_row(t, j);
          gv[j / 2] = r < K ? __ldg(reinterpret_cast<const float2*>(
                                  &g[static_cast<size_t>(r) * B + n0 +
                                     acc_col(t, j)]))
                            : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const int r = r0 + 64 * wg + acc_row(t, j);
          if (r >= K) continue;
          *reinterpret_cast<float2*>(
              &dx[static_cast<size_t>(r) * B + n0 + acc_col(t, j)]) =
              make_float2(gv[j / 2].x + acc[j], gv[j / 2].y + acc[j + 1]);
        }
      });
}

template <bool kCln>
int launch_g2b_tf32(const BwdParams& p, const float* w, cudaStream_t stream) {
  const int bn = staged_bn(p.B);
  RowsMaps maps;
  CTN_TRY(make_rows_maps(&maps, static_cast<const float*>(p.dh), p.M, p.K,
                         p.H, w, p.B, bn));
  if (bn == 128)
    return launch_rows_tf32(g2b_tf32_kernel<128, kCln>,
                            rows_tf32_smem<128, kTf32Stages>(), p.K, p.M,
                            stream, maps, p);
  return launch_rows_tf32(g2b_tf32_kernel<64, kCln>,
                          rows_tf32_smem<64, kTf32Stages>(), p.K, p.M, stream,
                          maps, p);
}

// W' in f32: out [ca, cb] = a^T @ b over all rows (wgrad_tf32_kernel, one
// CTA per 1024-row chunk and output tile of up to 128 x 128), then
// reduce_chunks_kernel adds the chunks in a fixed order.
int launch_wgrad_tf32(const void* a, const void* b, int rows, int ca, int cb,
                      float* wpart, float* out, cudaStream_t stream) {
  CTN_TRY(launch_wgrad_tf32_chunks(static_cast<const float*>(a),
                                   static_cast<const float*>(b), rows, ca,
                                   cb, kChunkRows, wpart, stream));
  const int n_chunks = (rows + kChunkRows - 1) / kChunkRows;
  reduce_chunks_kernel<<<(ca * cb + 255) / 256, 256, 0, stream>>>(
      wpart, n_chunks, ca * cb, out);
  CTN_CHECK();
  return 0;
}

// F1 and F2 of the cLN stages, one thread a row of the M K: norm1's (mean,
// rs) as R1 (launch A' with kPre) formed them, from part[row], and norm2's
// by row_stats from R2''s n_seg partials, as C' takes them.
__global__ void cln_rows_tf32_kernel(const float* __restrict__ part,
                                     const float* __restrict__ part2,
                                     int n_seg, int rows, int Hn,
                                     float* __restrict__ stats) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float* st = stats + static_cast<size_t>(r) * kNumStats;
  st[kMean1] = part[2 * static_cast<size_t>(r)];
  st[kRs1] = part[2 * static_cast<size_t>(r) + 1];
  row_stats(part2 + 2 * static_cast<size_t>(r) * n_seg, n_seg, Hn,
            &st[kMean2], &st[kRs2]);
}

// The f32 gLN or cLN backward on these stages (the top note), on a bound
// workspace whose w_in_t segment takes the 6 B H floats of the split
// weights.
template <int kNorm>
int launch_bwd_tf32(const BwdParams& p, cudaStream_t stream) {
  constexpr bool kCln = kNorm == kNormCLN;
  const int M = p.M, K = p.K, B = p.B, H = p.H;
  if (!dw_layout_ok(H)) return static_cast<int>(cudaErrorInvalidValue);
  const double count = static_cast<double>(K) * p.Hn;
  const int kt = (K + kWgRows - 1) / kWgRows;
  const int n_rows = M * K, fin_blocks = (n_rows + 255) / 256;
  const size_t hb = static_cast<size_t>(H) * B;
  float* ws = static_cast<float*>(p.w_in_t);
  Params fp = {};   // the forward's stages, storing pre-activations
  fp.x = p.x;
  fp.w_in = p.w_in;
  fp.dw = p.dw;
  fp.w_out = p.w_out;
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
  fp.Hn = p.Hn;
  fp.P = p.P;
  fp.dilation = p.dilation;
  fp.left = p.left;
  fp.norm = kNorm;
  CTN_TRY(launch_prep_tf32(fp, ws, 1, stream));
  CTN_TRY(launch_in_proj_tf32<true>(fp, ws, stream));          // R1
  if constexpr (kCln) {
    dw_tf32_kernel<true><<<dim3(kt, M), kWgCta, 0, stream>>>(fp, 1);  // R2'
    CTN_CHECK();
    cln_rows_tf32_kernel<<<fin_blocks, 256, 0, stream>>>(      // F1, F2
        p.part, p.part2, dw_tf32_parts(K, H, kNorm), n_rows, p.Hn, p.stats);
    CTN_CHECK();
  } else {
    finalize_kernel<<<M, kWgCta, 0, stream>>>(p.part, kt, count, p.stats,
                                              kMean1, 0);      // F1
    CTN_CHECK();
    dw_tf32_kernel<true><<<dim3(kt, M), kWgCta, 0, stream>>>(fp, kt);  // R2'
    CTN_CHECK();
    finalize_kernel<<<M, kWgCta, 0, stream>>>(p.part2, kt, count, p.stats,
                                              kMean2, 0);      // F2
    CTN_CHECK();
  }
  CTN_TRY(launch_g1_tf32<kCln>(p, ws + 2 * hb, stream));      // G1'
  if constexpr (!kCln) {   // cLN: G1' wrote each row's t1, t2
    finalize_kernel<<<M, 256, 0, stream>>>(p.part, kt, count, p.stats, kT1,
                                           1);                 // F3
    CTN_CHECK();
  }
  CTN_TRY(launch_wgrad_tf32(p.hn2, p.g, M * K, H, B, p.wpart, p.dw_out,
                            stream));                          // W' dW_out
  if (p.P > kMaxTaps)                                          // E2'
    e2_tf32_kernel<kMaxTaps, true, kCln>
        <<<dim3(kt, M), kWgCta, 0, stream>>>(p);
  else if (p.P == 3)
    e2_tf32_kernel<3, false, kCln><<<dim3(kt, M), kWgCta, 0, stream>>>(p);
  else
    e2_tf32_kernel<kMaxTaps, false, kCln>
        <<<dim3(kt, M), kWgCta, 0, stream>>>(p);
  CTN_CHECK();
  // F4 (cLN: E2''s partials, one per 32 of a row's H / 4 lanes)
  if constexpr (kCln)
    finalize_rows_kernel<<<fin_blocks, 256, 0, stream>>>(
        p.part, H < 128 ? 1 : H / 128, n_rows, p.Hn, p.stats, kU1, 1);
  else
    finalize_kernel<<<M, 256, 0, stream>>>(p.part, kt, count, p.stats, kU1,
                                           1);
  CTN_CHECK();
  CTN_TRY(launch_g2b_tf32<kCln>(p, ws + 4 * hb, stream));     // G2b'
  CTN_TRY(launch_wgrad_tf32(p.x, p.dh, M * K, B, H, p.wpart, p.dw_in,
                            stream));                          // W' dW_in
  reduce_channels_kernel<<<dim3((H + 31) / 32, p.P + 6), dim3(32, kRedGroups),
                           0, stream>>>(p, kt, kt);            // S
  CTN_CHECK();
  reduce_slopes_kernel<<<1, 256, 0, stream>>>(p);
  CTN_CHECK();
  return 0;
}

}  // namespace
