// The f32 intra-chunk attention core for chunks above 256 frames, forward
// (B9, B9p: dpt_intra.cu) and backward (B10, B10p: dpt_intra_bwd.cu), on
// Hopper (sm_90a). At S <= 256 both kernels keep their first designs; this
// core runs where those designs' per-chunk tiles (the forward's per-warp
// [16, S] rows, the backward's two [S, S] tiles) cannot be held.
//
// It takes the bf16 core's schedule (dpt_attn_bwd_wg.cuh) with f32 operands
// and FMA products: per-row statistics instead of any [S, S] or [16, S]
// tile, so shared memory does not grow with S.
//
//   grid     one CTA per (chunk, m, head), the intra gather (Gather<false>:
//            the S rows of one chunk, the key bias per (chunk, key)), four
//            warps; a warp owns 16 rows at a time, its own rows of two
//            operands in shared memory ([16, d] each, read as broadcasts).
//   staging  the other side's rows of two operands in blocks of
//            T = 4096 / d rows, [T, d + 1] f32 each (the odd stride keeps a
//            lane-per-row read off shared banks), with a vector per row
//            (the keys' bias, or the queries' statistics); rows beyond S
//            are zeros.
//   products a lane takes one key (or query) of a 32-row tile: its 16 dot
//            products over d with the warp's rows, in order of d, one FMA
//            each (rs_dots); the mixes (p v, ds k, p^T dA, ds^T q) go
//            through a per-warp [16, 32] tile of p or ds, each lane
//            summing its rows and columns of the [16, d] result over the
//            tile's rows in order, one FMA each (rs_mix).
//   query    pass 1: each lane's running max and denominator of each row
//   side     over its keys (every 32nd), online; then the 32 lanes' pairs
//            combined by a butterfly; pass 2: p = exp(s - max) / den, a =
//            sum p v and (backward) dp = dA v^T, rowsum = sum p dp (per
//            lane, then a butterfly); pass 3 (backward): ds = p (dp -
//            rowsum) scale, dq = sum ds k. The (max, denominator, rowsum)
//            of each query go to the stats segment of the attention
//            backward's f32 workspace (attn_bwd_layout).
//   key side (backward) after a block barrier a warp owns 16 key rows (k,
//            v) and walks the staged queries (q, dA and their statistics):
//            it rebuilds p and ds with the query side's arithmetic on the
//            same values (the same bits: an FMA's product is symmetric)
//            and sums dv = sum p^T dA and dk = sum ds^T q over the queries
//            in order; at d = 128 dv and dk in a walk each, as the bf16
//            core does.
//
// Keys beyond S take no part in the statistics and get p = 0 exactly;
// queries beyond S contribute 0 to dv and dk. A row whose keys are all
// padded (bias -1e9) gets a uniform softmax, as in the twin. No atomics:
// every sum is a loop in a fixed order, so two runs give the same bits.
// Products are f32 FMA, not tf32: the f32 DPT bar is 1e-5.
//
// What bounds it: the work is two products of S^2 d FMAs per (m, chunk,
// head) in the forward core (q k^T, p v) and six in the backward's (B9 at
// [8, 7, 512, 256], d = 32: 15.0 GFLOP of core products, 0.22 ms at the
// 67 TFLOP/s f32 FMA rate); this core computes q k^T twice in the forward, and in
// the backward q k^T four times (five at d = 128) and dA v^T three, on
// FMA units fed from shared memory (each dot product reads a float4
// broadcast per 4 FMAs of a row).

#pragma once

#include "dpt_attn_bwd_wg.cuh"

namespace {

constexpr int kRsWarps = 4;             // warps of a CTA
constexpr int kRsTile = 32;             // keys (or queries) of a tile: a lane each
constexpr int kFirstDesignMaxS = 256;   // S above this runs this core

template <int D>
struct RsShape {
  static constexpr int T = 4096 / D;          // staged rows of a block
  static constexpr int LD = D + 1;            // a staged row's stride
  static constexpr int CW = D < 32 ? D : 32;  // lanes along a row in a mix
  static constexpr int RPL = 16 * CW / 32;    // rows of the result per lane
  static constexpr int CPL = D / CW;          // columns of it per lane
  static constexpr int PLD = kRsTile + 4;     // the [16, 32] tile's stride
  // a warp's own rows of two operands, two [16, 32] tiles and its rows'
  // (max, denominator, rowsum, key bias)
  static constexpr int kWarpFloats = 2 * 16 * D + 2 * 16 * PLD + 16 * 4;
  static constexpr size_t kSmem =
      sizeof(float) *
      (2 * static_cast<size_t>(T) * LD + 3 * T + kRsWarps * kWarpFloats);
};
static_assert(RsShape<128>::kSmem <= kMaxDynSmem, "the core at d = 128");

// s[r] = sum over t of own[r][t] * row[t], in order of t, one FMA each:
// the warp's 16 rows ([16, D], read as float4 broadcasts) against one
// staged row. fmaf is symmetric in its product, so the query side's q . k
// and the key side's k . q are the same bits.
template <int D>
__device__ __forceinline__ void rs_dots(float (&s)[16], const float* own,
                                        const float* row) {
#pragma unroll
  for (int r = 0; r < 16; ++r) s[r] = 0.f;
#pragma unroll 2
  for (int t = 0; t < D; t += 4) {
    const float b0 = row[t], b1 = row[t + 1], b2 = row[t + 2],
                b3 = row[t + 3];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(own + r * D + t);
      s[r] = fmaf(a.x, b0, s[r]);
      s[r] = fmaf(a.y, b1, s[r]);
      s[r] = fmaf(a.z, b2, s[r]);
      s[r] = fmaf(a.w, b3, s[r]);
    }
  }
}

// The softmax probability of one (query, key) pair from the query's
// statistics, and ds; both sides of the backward call these on the same
// values.
__device__ __forceinline__ float rs_logit(float dot, float scale,
                                          float bias) {
  return fmaf(dot, scale, bias);
}
__device__ __forceinline__ float rs_prob(float dot, float scale, float bias,
                                         float mx, float den) {
  return expf(rs_logit(dot, scale, bias) - mx) / den;
}
__device__ __forceinline__ float rs_dscore(float p, float dp, float rowsum,
                                           float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, rowsum)), scale);
}

// One logit s into a lane's running (max, denominator) of a row: one
// exponential, exp(-|s - max|), scaling the denominator where s is the new
// max.
__device__ __forceinline__ void rs_online(float& mx, float& den, float s) {
  const float e = expf(-fabsf(s - mx));
  if (s > mx) {
    den = fmaf(den, e, 1.f);
    mx = s;
  } else {
    den += e;
  }
}

// The 32 lanes' (max, denominator) of a row combined by a butterfly; every
// lane ends with the same bits (each step's two products are the same in
// either lane, and their sum is commutative).
__device__ __forceinline__ void rs_combine(float& mx, float& den) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, mx, o);
    const float d2 = __shfl_xor_sync(0xffffffffu, den, o);
    const float mn = fmaxf(mx, m2);
    den = __fadd_rn(__fmul_rn(den, expf(mx - mn)),
                    __fmul_rn(d2, expf(m2 - mn)));
    mx = mn;
  }
}

__device__ __forceinline__ float rs_lane_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc (this lane's RPL rows x CPL columns of a [16, D] sum) += w[16][0:nk]
// @ rows[0:nk][0:D]: w a per-warp [16, 32] tile (stride PLD), rows staged
// (stride LD); each element summed over the nk rows in order, one FMA each.
// nk is a multiple of 4.
template <int D>
__device__ __forceinline__ void rs_mix(
    float (&acc)[RsShape<D>::RPL][RsShape<D>::CPL], const float* w,
    const float* rows, int nk, int lane) {
  using Sh = RsShape<D>;
  const int c0 = lane % Sh::CW, r0 = (lane / Sh::CW) * Sh::RPL;
  for (int kk = 0; kk < nk; kk += 4) {
    float x[4][Sh::CPL];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < Sh::CPL; ++j)
        x[q][j] = rows[(kk + q) * Sh::LD + c0 + j * Sh::CW];
#pragma unroll
    for (int i = 0; i < Sh::RPL; ++i) {
      const float4 p =
          *reinterpret_cast<const float4*>(w + (r0 + i) * Sh::PLD + kk);
#pragma unroll
      for (int j = 0; j < Sh::CPL; ++j) {
        acc[i][j] = fmaf(p.x, x[0][j], acc[i][j]);
        acc[i][j] = fmaf(p.y, x[1][j], acc[i][j]);
        acc[i][j] = fmaf(p.z, x[2][j], acc[i][j]);
        acc[i][j] = fmaf(p.w, x[3][j], acc[i][j]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void rs_zero(
    float (&acc)[RsShape<D>::RPL][RsShape<D>::CPL]) {
#pragma unroll
  for (int i = 0; i < RsShape<D>::RPL; ++i)
#pragma unroll
    for (int j = 0; j < RsShape<D>::CPL; ++j) acc[i][j] = 0.f;
}

// The lane's part of a [16, D] result for rows [r0, r0 + 16) of the chunk
// to columns [col, col + D) of dst (rows of ld).
template <int D>
__device__ __forceinline__ void rs_store(
    const Gather<false>& G, float* dst, int ld, int col, int r0,
    const float (&acc)[RsShape<D>::RPL][RsShape<D>::CPL], int lane) {
  using Sh = RsShape<D>;
  const int c0 = lane % Sh::CW, rr = (lane / Sh::CW) * Sh::RPL;
#pragma unroll
  for (int i = 0; i < Sh::RPL; ++i)
#pragma unroll
    for (int j = 0; j < Sh::CPL; ++j)
      dst[G.row(r0 + rr + i) * ld + col + c0 + j * Sh::CW] = acc[i][j];
}

// The core. Grid (n, M, h), 32 * kRsWarps threads; S % 16 == 0 and
// S > kRsTile * kRsWarps (the launcher's rule: S > kFirstDesignMaxS). The
// forward (kBwd false) writes a alone; the backward also dqkv = (dq | dk |
// dv) and the query statistics.
template <int D, bool kBwd>
__global__ void __launch_bounds__(kRsWarps * 32)
    rs_core_kernel(DptAttnParams f, const float* __restrict__ dA,
                   float* __restrict__ dqkv, float* __restrict__ stats,
                   float scale) {
  using Sh = RsShape<D>;
  constexpr int T = Sh::T, LD = Sh::LD, PLD = Sh::PLD, kC = D / 4;
  extern __shared__ __align__(16) float rs_smem[];
  const Gather<false> G{f};
  const int S = f.S, Bq = f.Bq, h = f.h, hd = blockIdx.z, W3 = 3 * Bq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* x1 = rs_smem;
  float* x2 = x1 + T * LD;
  float* vec = x2 + T * LD;
  float* own1 = vec + 3 * T + warp * Sh::kWarpFloats;
  float* own2 = own1 + 16 * D;
  float* w1 = own2 + 16 * D;
  float* w2 = w1 + 16 * PLD;
  float* rst = w2 + 16 * PLD;   // per row: max, denominator, rowsum, bias
  const float* qkv = static_cast<const float*>(f.qkv);
  const int cq = hd * D, ck = Bq + hd * D, cv = 2 * Bq + hd * D;
  const int n_tiles = S / 16, n_blocks = (S + T - 1) / T;

  // rows [r0, r0 + 16) of (s1, c1, ld1) into own1 and, unless s2 is null,
  // of (s2, c2, ld2) into own2; by the calling warp
  auto load_own = [&](int r0, const float* s1, int ld1, int c1,
                      const float* s2, int ld2, int c2) {
    __syncwarp();   // the previous rows' readers are done
    for (int e = lane; e < (s2 ? 2 : 1) * 16 * kC; e += 32) {
      const int two = e / (16 * kC), i = (e / kC) % 16, c = 4 * (e % kC);
      const float* src = two ? s2 + G.row(r0 + i) * ld2 + c2
                             : s1 + G.row(r0 + i) * ld1 + c1;
      *reinterpret_cast<float4*>((two ? own2 : own1) + i * D + c) =
          *reinterpret_cast<const float4*>(src + c);
    }
    __syncwarp();
  };
  // block b of T rows of (s1, c1, ld1) and (s2, c2, ld2) into x1 and x2,
  // zeros beyond S, and fill(i, position) for each of its rows; every
  // thread calls it, and it ends with the block published
  int staged = -1;   // the block in shared memory (uniform over the CTA)
  auto stage = [&](int b, const float* s1, int ld1, int c1, const float* s2,
                   int ld2, int c2, auto fill) {
    if (staged == b) return;
    __syncthreads();   // the previous block's readers are done
    const int r0 = b * T;
    for (int e = threadIdx.x; e < 2 * T * kC; e += blockDim.x) {
      const int two = e / (T * kC), i = (e / kC) % T, c = 4 * (e % kC);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + i < S)
        v = *reinterpret_cast<const float4*>(
            two ? s2 + G.row(r0 + i) * ld2 + c2 + c
                : s1 + G.row(r0 + i) * ld1 + c1 + c);
      float* d = (two ? x2 : x1) + i * LD + c;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    for (int i = threadIdx.x; i < T; i += blockDim.x) fill(i, r0 + i);
    __syncthreads();
    staged = b;
  };
  auto stage_keys = [&](int b) {
    stage(b, qkv, W3, ck, qkv, W3, cv,
          [&](int i, int k) { vec[i] = k < S ? G.key_bias(k) : 0.f; });
  };

  // ---- query side: a warp per 16 query rows ----
  for (int rnd = 0; rnd < n_tiles; rnd += n_warps) {
    const int q0 = (rnd + warp) * 16;
    const bool active = rnd + warp < n_tiles;
    if (active) load_own(q0, qkv, W3, cq, dA, Bq, hd * D);
    // pass 1: each lane's max and denominator over its keys, combined
    {
      float mx[16], den[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        mx[r] = -INFINITY;
        den[r] = 0.f;
      }
      for (int b = 0; b < n_blocks; ++b) {
        stage_keys(b);
        if (!active) continue;
        const int rows = min(T, S - b * T);
        for (int k0 = 0; k0 < rows; k0 += kRsTile) {
          const int k = k0 + lane;
          float s[16];
          rs_dots<D>(s, own1, x1 + k * LD);
          if (k < rows) {
            const float kb = vec[k];
#pragma unroll
            for (int r = 0; r < 16; ++r)
              rs_online(mx[r], den[r], rs_logit(s[r], scale, kb));
          }
        }
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          rs_combine(mx[r], den[r]);
          if (lane == 0) {
            rst[4 * r] = mx[r];
            rst[4 * r + 1] = den[r];
          }
        }
        __syncwarp();
      }
    }
    // pass 2: a = sum p v; the backward's rowsum = sum p dp
    {
      float acc[Sh::RPL][Sh::CPL], rsum[16];
      rs_zero<D>(acc);
#pragma unroll
      for (int r = 0; r < 16; ++r) rsum[r] = 0.f;
      for (int b = 0; b < n_blocks; ++b) {
        stage_keys(b);
        if (!active) continue;
        const int rows = min(T, S - b * T);
        for (int k0 = 0; k0 < rows; k0 += kRsTile) {
          const int k = k0 + lane;
          const bool ok = k < rows;
          float s[16], dp[16];
          rs_dots<D>(s, own1, x1 + k * LD);
          if constexpr (kBwd) rs_dots<D>(dp, own2, x2 + k * LD);
          const float kb = vec[k];
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float p =
                ok ? rs_prob(s[r], scale, kb, rst[4 * r], rst[4 * r + 1])
                   : 0.f;
            w1[r * PLD + lane] = p;
            if constexpr (kBwd) rsum[r] = fmaf(p, dp[r], rsum[r]);
          }
          __syncwarp();
          rs_mix<D>(acc, w1, x2 + k0 * LD, min(kRsTile, rows - k0), lane);
          __syncwarp();
        }
      }
      if (active) {
        rs_store<D>(G, static_cast<float*>(f.a), Bq, hd * D, q0, acc, lane);
        if constexpr (kBwd) {
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            rsum[r] = rs_lane_sum(rsum[r]);
            if (lane == 0) {
              rst[4 * r + 2] = rsum[r];
              float* st = stats + (G.row(q0 + r) * h + hd) * kNumRowStats;
              st[0] = rst[4 * r];
              st[1] = rst[4 * r + 1];
              st[2] = rsum[r];
            }
          }
          __syncwarp();
        }
      }
    }
    if constexpr (!kBwd) continue;
    // pass 3: ds = p (dp - rowsum) scale, dq = sum ds k
    float acc[Sh::RPL][Sh::CPL];
    rs_zero<D>(acc);
    for (int b = 0; b < n_blocks; ++b) {
      stage_keys(b);
      if (!active) continue;
      const int rows = min(T, S - b * T);
      for (int k0 = 0; k0 < rows; k0 += kRsTile) {
        const int k = k0 + lane;
        const bool ok = k < rows;
        float s[16], dp[16];
        rs_dots<D>(s, own1, x1 + k * LD);
        rs_dots<D>(dp, own2, x2 + k * LD);
        const float kb = vec[k];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          float ds = 0.f;
          if (ok) {
            const float p =
                rs_prob(s[r], scale, kb, rst[4 * r], rst[4 * r + 1]);
            ds = rs_dscore(p, dp[r], rst[4 * r + 2], scale);
          }
          w1[r * PLD + lane] = ds;
        }
        __syncwarp();
        rs_mix<D>(acc, w1, x1 + k0 * LD, min(kRsTile, rows - k0), lane);
        __syncwarp();
      }
    }
    if (active) rs_store<D>(G, dqkv, W3, cq, q0, acc, lane);
  }
  if constexpr (!kBwd) return;

  // ---- key side: a warp per 16 key rows ----
  staged = -1;   // the first staging barrier also publishes the stats above
  auto stage_queries = [&](int b) {
    stage(b, qkv, W3, cq, dA, Bq, hd * D, [&](int i, int q) {
      float m = 0.f, dn = 1.f, rs = 0.f;
      if (q < S) {
        const float* st = stats + (G.row(q) * h + hd) * kNumRowStats;
        m = st[0];
        dn = st[1];
        rs = st[2];
      }
      vec[3 * i] = m;
      vec[3 * i + 1] = dn;
      vec[3 * i + 2] = rs;
    });
  };
  for (int rnd = 0; rnd < n_tiles; rnd += n_warps) {
    const int k0 = (rnd + warp) * 16;
    const bool active = rnd + warp < n_tiles;
    // one walk over the queries summing dv (with_dv) and dk (with_dk)
    auto key_pass = [&](auto with_dv, auto with_dk) {
      constexpr bool kDv = decltype(with_dv)::value;
      constexpr bool kDk = decltype(with_dk)::value;
      if (active) {
        load_own(k0, qkv, W3, ck, qkv, W3, cv);
        if (lane < 16) rst[4 * lane + 3] = G.key_bias(k0 + lane);
        __syncwarp();
      }
      float dv[Sh::RPL][Sh::CPL], dk[Sh::RPL][Sh::CPL];
      rs_zero<D>(dv);
      rs_zero<D>(dk);
      for (int b = 0; b < n_blocks; ++b) {
        stage_queries(b);
        if (!active) continue;
        const int rows = min(T, S - b * T);
        for (int j0 = 0; j0 < rows; j0 += kRsTile) {
          const int q = j0 + lane;
          const bool ok = q < rows;
          float s[16], dp[16];
          rs_dots<D>(s, own1, x1 + q * LD);   // k . q
          if constexpr (kDk) rs_dots<D>(dp, own2, x2 + q * LD);   // v . dA
          const float m = vec[3 * q], dn = vec[3 * q + 1];
          const float rs = vec[3 * q + 2];
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float p =
                ok ? rs_prob(s[r], scale, rst[4 * r + 3], m, dn) : 0.f;
            if constexpr (kDv) w1[r * PLD + lane] = p;
            if constexpr (kDk)
              w2[r * PLD + lane] = ok ? rs_dscore(p, dp[r], rs, scale) : 0.f;
          }
          __syncwarp();
          const int nk = min(kRsTile, rows - j0);
          if constexpr (kDv) rs_mix<D>(dv, w1, x2 + j0 * LD, nk, lane);
          if constexpr (kDk) rs_mix<D>(dk, w2, x1 + j0 * LD, nk, lane);
          __syncwarp();
        }
      }
      if (active) {
        if constexpr (kDk) rs_store<D>(G, dqkv, W3, ck, k0, dk, lane);
        if constexpr (kDv) rs_store<D>(G, dqkv, W3, cv, k0, dv, lane);
      }
    };
    using Yes = std::true_type;
    using No = std::false_type;
    if constexpr (D == 128) {   // dv and dk in a walk each
      key_pass(Yes{}, No{});
      key_pass(No{}, Yes{});
    } else {
      key_pass(Yes{}, Yes{});
    }
  }
}

template <int D, bool kBwd>
int launch_rs_core(const DptAttnParams& f, const float* dA, float* dqkv,
                   float* stats, cudaStream_t stream, float scale) {
  constexpr size_t smem = RsShape<D>::kSmem;
  auto kernel = rs_core_kernel<D, kBwd>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(f.n, f.M, f.h), kRsWarps * 32, smem, stream>>>(
      f, dA, dqkv, stats, scale);
  return static_cast<int>(cudaGetLastError());
}

// The core at the heads' padded width D = Bq / h, with the real width's
// softmax scale: the forward (kBwd false; dA, dqkv and stats null) or the
// backward. S % 16 == 0, S > kFirstDesignMaxS.
template <bool kBwd>
int launch_rs_core_d(const DptAttnParams& f, const float* dA, float* dqkv,
                     float* stats, cudaStream_t stream, float scale) {
  if (f.S % 16 || f.S <= kFirstDesignMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (f.Bq / f.h) {
    case 16:
      return launch_rs_core<16, kBwd>(f, dA, dqkv, stats, stream, scale);
    case 32:
      return launch_rs_core<32, kBwd>(f, dA, dqkv, stats, stream, scale);
    case 64:
      return launch_rs_core<64, kBwd>(f, dA, dqkv, stats, stream, scale);
    case 128:
      return launch_rs_core<128, kBwd>(f, dA, dqkv, stats, stream, scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
