// The attention core of both attention sublayers (B7-B10 and their partial
// modes) at head widths above 128, bf16 or f32: a route beside the cores.
//
// The cores (dpt_attn_bwd_wg.cuh on mma.sync in bf16; the f32 first
// designs, dpt_attention.cu, dpt_attention_bwd.cu, dpt_intra.cu,
// dpt_intra_bwd.cu; the f32 row-statistics core, dpt_intra_rowstat.cuh)
// are templated on the head width D <= 128: a head's q fragments, or its q
// and acc rows, live in registers (the f32 cores already spill at 128). A
// JAX head can be as wide as B (2048 at one head), so a wider template
// would not end the limit. Above 128 (chosen by the padded D = Bq / h
// alone; the wrappers pad d to a multiple of 64 with zero columns, the
// real d's scale 1 / sqrt(d) handed in) the launchers run this route
// instead, whose only state per problem and head is an [Lp, Lp] f32 tile
// of logits in a device workspace, its first L rows used (L keys: n
// chunks for inter, S frames for intra; Lp = L rounded up to kWhKeys):
//
//   forward   s = q k^T (wh_mm_kernel, WhScores)
//             p = softmax(s scale + bias), p = 0 on the padded keys j >= L
//                 (wh_softmax_kernel, in place)
//             a = round(round(p) v) (wh_mm_kernel, WhMix)
//   backward  s, p as above; a as above (the weight gradient reads it);
//             dp = dA v^T (WhScores with dA on the query side)
//             ds = round(p (dp - rowsum(p dp)) scale) (wh_ds_kernel, in
//                  place of dp)
//             dq = round(ds k), dk = round(ds^T q), dv = round(round(p)^T
//             dA) (WhMix, the last two with the tile transposed)
//
// rounding where the twins round (ops/cuda/dpt_attention.py::
// attention_bwd_reference: p before the mix and before dv, then ds and
// dq, dk, dv; nothing rounds in f32). Every product is a hand-written FMA
// tile: a CTA per 64 x 64 output tile of one problem and head, 16 x 16
// threads of a 4 x 4 micro-tile each, the depth staged 16 at a time in
// shared memory, each sum in depth order (two runs give the same bits).
// The key bias reaches the softmax as the cores take it: bias[key chunk,
// s] for inter, bias[chunk, key] for intra (pad_chunks' masked frames
// included).
//
// What bounds it. The tile of logits is the route's price: Lp^2 f32 per
// (problem, head) written and read three times in the forward (scores,
// softmax, mix), seven in the backward; at the smoke's intra shape
// [8, 25, 128, 256] with one head of 256 that is 13.1 MB a pass. The
// products run on FMA at a fraction of the f32 rate (no tensor cores), so
// the route is slower than a core would be; it exists so that every head
// width JAX runs has a kernel. The problems run in passes of at most
// kWhWsBytes of logits (wide_head_groups), so a long input's inter tile
// (n^2 per position) is bounded: more launches, the same values.

#pragma once

#include "dpt_attn_bwd_wg.cuh"

namespace {

constexpr int kCoreMaxD = 128;        // the cores' widest head
constexpr int kWhTile = 64;           // wh_mm_kernel: output tile
constexpr int kWhDepth = 16;          // wh_mm_kernel: depth per stage
constexpr int kWhThreads = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWhKeys = 16;           // a logits row's keys pad to this
constexpr size_t kWhWsBytes = size_t(512) << 20;   // logits per pass

// The head widths the launchers take: a padded width D = Bq / h that a
// core takes (core_head_width) or, above kCoreMaxD, a multiple of 64 on
// this route; and the heads' real width d, 0 < d <= D, whose 1 / sqrt(d)
// is the softmax scale (the wrappers pad each head from d to D with zero
// columns of q, k and v).
inline bool attn_head_widths_ok(int Bq, int h, int d) {
  if (h <= 0 || Bq % h) return false;
  const int D = Bq / h;
  return (core_head_width(D) || (D > kCoreMaxD && D % 64 == 0)) && d >= 1 &&
         d <= D;
}

inline float attn_scale(int d) { return 1.f / sqrtf(static_cast<float>(d)); }

inline int wh_keys_padded(int L) { return (L + kWhKeys - 1) / kWhKeys * kWhKeys; }

// Where one problem's rows lie, as the cores gather them. inter: problem
// g = m S + s (a position of one sample), row i = chunk i, qkv row
// (m n + i) S + s, key bias [i, s]; intra: g = m n + c (a chunk), row i =
// frame i, qkv row g S + i, key bias [c, i].
template <bool kInter>
struct WhRows {
  int n, S;
  __host__ __device__ int length() const { return kInter ? n : S; }
  __device__ long long row(long long g, int i) const {
    if (kInter) return ((g / S) * n + i) * static_cast<long long>(S) + g % S;
    return g * S + i;
  }
  __device__ float bias(const float* b, long long g, int j) const {
    if (!b) return 0.f;
    return kInter ? b[static_cast<long long>(j) * S + g % S]
                  : b[(g % n) * static_cast<long long>(S) + j];
  }
};

// The problems of a sublayer: M S for inter, M n for intra.
template <bool kInter>
long long wh_problems(const DptAttnParams& f) {
  return static_cast<long long>(f.M) * (kInter ? f.S : f.n);
}

// Problems per pass: as many as keep `tiles` f32 tiles of logits of every
// head within kWhWsBytes, at least one.
inline long long wide_head_groups(long long problems, int h, int Lp,
                                  int tiles) {
  const size_t per = static_cast<size_t>(h) * Lp * Lp * tiles * sizeof(float);
  long long g = static_cast<long long>(kWhWsBytes / per);
  if (g < 1) g = 1;
  return g < problems ? g : problems;
}

// s[i][j] = sum_t x[i][t] y[j][t] over the D columns of head hd: x rows of
// qkv (q) or of dA, y rows of qkv (k or v), by the problem's gather; into
// the problem's [L, Lp] tile of logits (j >= L: 0).
template <typename T, bool kInter>
struct WhScores {
  WhRows<kInter> rows;
  const T* x;
  int ldx, xc;
  const T* y;
  int ldy, yc;
  float* out;
  int L, Lp, D, h;
  long long g0;
  __host__ __device__ int n_rows() const { return L; }
  __host__ __device__ int n_cols() const { return Lp; }
  __device__ int depth() const { return D; }
  __device__ float a(long long g, int hd, int r, int k) const {
    return to_f<T>(x[rows.row(g, r) * ldx + xc + hd * D + k]);
  }
  __device__ float b(long long g, int hd, int k, int c) const {
    return c < L ? to_f<T>(y[rows.row(g, c) * ldy + yc + hd * D + k]) : 0.f;
  }
  __device__ void store(long long g, int hd, int r, int c, float v) const {
    out[(((g - g0) * h + hd) * Lp + r) * static_cast<long long>(Lp) + c] = v;
  }
};

// o[i][t] = round(sum_j round(p[i][j]) y[j][t]) over the L keys, or with
// kTrans o[j][t] = round(sum_i round(p[i][j]) y[i][t]) over the L
// queries: p the problem's tile (probabilities, or ds already rounded),
// y rows of qkv or dA at column yc of head hd; o rows of a or dqkv at
// column oc of head hd, in T.
template <typename T, bool kInter, bool kTrans>
struct WhMix {
  WhRows<kInter> rows;
  const float* p;
  const T* y;
  int ldy, yc;
  T* o;
  int ldo, oc;
  int L, Lp, D, h;
  long long g0;
  __host__ __device__ int n_rows() const { return L; }
  __host__ __device__ int n_cols() const { return D; }
  __device__ int depth() const { return L; }
  __device__ float a(long long g, int hd, int r, int k) const {
    const float* t = p + ((g - g0) * h + hd) * static_cast<long long>(Lp) * Lp;
    return round_to<T>(kTrans ? t[static_cast<long long>(k) * Lp + r]
                              : t[static_cast<long long>(r) * Lp + k]);
  }
  __device__ float b(long long g, int hd, int k, int c) const {
    return to_f<T>(y[rows.row(g, k) * ldy + yc + hd * D + c]);
  }
  __device__ void store(long long g, int hd, int r, int c, float v) const {
    o[rows.row(g, r) * ldo + oc + hd * D + c] = from_f<T>(v);
  }
};

// One 64 x 64 tile of a product (Op: WhScores or WhMix) for one problem
// and head. Grid (problems of the pass, tiles, h); each output's sum runs
// over the depth in order.
template <class Op>
__global__ void __launch_bounds__(kWhThreads) wh_mm_kernel(Op op) {
  __shared__ float a_s[kWhDepth][kWhTile + 4];
  __shared__ float b_s[kWhDepth][kWhTile + 4];
  const long long g = op.g0 + blockIdx.x;
  const int hd = blockIdx.z;
  const int rows = op.n_rows(), cols = op.n_cols(), depth = op.depth();
  const int col_tiles = (cols + kWhTile - 1) / kWhTile;
  const int r0 = (blockIdx.y / col_tiles) * kWhTile;
  const int c0 = (blockIdx.y % col_tiles) * kWhTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += kWhDepth) {
    __syncthreads();   // the previous stage's readers are done
    for (int e = tid; e < kWhDepth * kWhTile; e += kWhThreads) {
      const int kk = e % kWhDepth, i = e / kWhDepth;
      const bool in_k = k0 + kk < depth;
      a_s[kk][i] = in_k && r0 + i < rows ? op.a(g, hd, r0 + i, k0 + kk) : 0.f;
      b_s[kk][i] = in_k && c0 + i < cols ? op.b(g, hd, k0 + kk, c0 + i) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWhDepth; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (r < rows && c < cols) op.store(g, hd, r, c, acc[i][j]);
    }
}

// p = softmax(s scale + bias) over the L keys of each row of the pass's
// tiles, in place; the padded keys L <= j < Lp get p = 0 (NEG_INF). A warp
// per row (problem, head, query); grid rows / 8 of 8 warps.
template <bool kInter>
__global__ void __launch_bounds__(256)
    wh_softmax_kernel(float* s_ws, const float* bias, WhRows<kInter> rows,
                      long long g0, long long n_rows, int L, int Lp, int h,
                      float scale) {
  const long long row = blockIdx.x * 8ll + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const long long g = g0 + row / (static_cast<long long>(h) * L);
  float* s = s_ws + (row / L) * static_cast<long long>(Lp) * Lp +
             (row % L) * static_cast<long long>(Lp);
  float mx = -INFINITY;
  for (int j = lane; j < Lp; j += 32) {
    const float v = j < L ? s[j] * scale + rows.bias(bias, g, j) : -INFINITY;
    s[j] = v;
    mx = fmaxf(mx, v);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < Lp; j += 32) {
    const float e = expf(s[j] - mx);
    s[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < Lp; j += 32) s[j] = s[j] / sum;
}

// ds = round(p (dp - sum_j p dp) scale) over the L keys of each row, in
// place of dp; a warp per row, as wh_softmax_kernel.
template <typename T>
__global__ void __launch_bounds__(256)
    wh_ds_kernel(const float* p_ws, float* dp_ws, long long n_rows, int L,
                 int Lp, float scale) {
  const long long row = blockIdx.x * 8ll + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const long long off = (row / L) * static_cast<long long>(Lp) * Lp +
                        (row % L) * static_cast<long long>(Lp);
  const float* p = p_ws + off;
  float* dp = dp_ws + off;
  float r = 0.f;
  for (int j = lane; j < L; j += 32) r += p[j] * dp[j];
  r = warp_sum(r);
  for (int j = lane; j < L; j += 32)
    dp[j] = round_to<T>(p[j] * (dp[j] - r) * scale);
}

template <typename T, bool kInter>
WhScores<T, kInter> wh_scores(const DptAttnParams& f, const T* x, int ldx,
                              int xc, int yc, float* out, long long g0) {
  const WhRows<kInter> rows{f.n, f.S};
  const int L = rows.length();
  return {rows, x, ldx, xc, static_cast<const T*>(f.qkv), 3 * f.Bq, yc,
          out, L, wh_keys_padded(L), f.Bq / f.h, f.h, g0};
}

template <typename T, bool kInter, bool kTrans>
WhMix<T, kInter, kTrans> wh_mix(const DptAttnParams& f, const float* p,
                                const T* y, int ldy, int yc, T* o, int ldo,
                                int oc, long long g0) {
  const WhRows<kInter> rows{f.n, f.S};
  const int L = rows.length();
  return {rows, p, y, ldy, yc, o, ldo, oc, L, wh_keys_padded(L),
          f.Bq / f.h, f.h, g0};
}

template <class Op>
int wh_mm(const Op& op, long long groups, cudaStream_t stream) {
  const int tiles = ((op.n_rows() + kWhTile - 1) / kWhTile) *
                    ((op.n_cols() + kWhTile - 1) / kWhTile);
  wh_mm_kernel<Op><<<dim3(static_cast<unsigned>(groups), tiles, op.h),
                     kWhThreads, 0, stream>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInter>
int wh_softmax(const DptAttnParams& f, float* s, long long g0,
               long long groups, float scale, cudaStream_t stream) {
  const WhRows<kInter> rows{f.n, f.S};
  const int L = rows.length();
  const long long n_rows = groups * f.h * L;
  wh_softmax_kernel<kInter><<<static_cast<unsigned>((n_rows + 7) / 8), 256,
                              0, stream>>>(s, f.bias, rows, g0, n_rows, L,
                                           wh_keys_padded(L), f.h, scale);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the route's workspace: one [L, Lp] tile per (problem, head) of
// a pass, two in the backward (p and dp); 0 at a head width a core takes.
template <bool kInter>
long long wide_head_ws(int M, int n, int S, int Bq, int h, bool bwd) {
  if (h <= 0 || Bq % h || Bq / h <= kCoreMaxD) return 0;
  const int L = kInter ? n : S, Lp = wh_keys_padded(L);
  const long long problems = static_cast<long long>(M) * (kInter ? S : n);
  const int tiles = bwd ? 2 : 1;
  return wide_head_groups(problems, h, Lp, tiles) * h * Lp *
         static_cast<long long>(Lp) * tiles;
}

// The forward's three launches for the problems g0 .. g0 + groups: p into
// the tiles at p (probabilities, unrounded), a = round(round(p) v) into
// f.a.
template <typename T, bool kInter>
int wh_attend(const DptAttnParams& f, float* p, long long g0,
              long long groups, float scale, cudaStream_t stream) {
  const int Bq = f.Bq;
  const T* qkv = static_cast<const T*>(f.qkv);
  CTN_RETURN_IF(wh_mm(wh_scores<T, kInter>(f, qkv, 3 * Bq, 0, Bq, p, g0),
                      groups, stream));
  CTN_RETURN_IF(wh_softmax<kInter>(f, p, g0, groups, scale, stream));
  return wh_mm(wh_mix<T, kInter, false>(f, p, qkv, 3 * Bq, 2 * Bq,
                                        static_cast<T*>(f.a), Bq, 0, g0),
               groups, stream);
}

// The forward core on this route: a = round(round(p) v) into f.a, in
// passes of wide_head_groups problems; ws as wide_head_ws gives it.
template <typename T, bool kInter>
int launch_wide_head_fwd(const DptAttnParams& f, float* ws, float scale,
                         cudaStream_t stream) {
  if (!ws) return static_cast<int>(cudaErrorInvalidValue);
  const int Lp = wh_keys_padded(kInter ? f.n : f.S);
  const long long problems = wh_problems<kInter>(f);
  const long long per = wide_head_groups(problems, f.h, Lp, 1);
  for (long long g0 = 0; g0 < problems; g0 += per) {
    const long long groups = per < problems - g0 ? per : problems - g0;
    const int err = wh_attend<T, kInter>(f, ws, g0, groups, scale, stream);
    if (err != 0) return err;
  }
  return 0;
}

// The backward core on this route: a into P.f.a and dqkv = (dq | dk | dv)
// into P.dqkv from qkv and dA, in passes; ws as wide_head_ws gives it
// (bwd).
template <typename T, bool kInter>
int launch_wide_head_bwd(const DptAttnBwdParams& P, float* ws, float scale,
                         cudaStream_t stream) {
  if (!ws) return static_cast<int>(cudaErrorInvalidValue);
  const DptAttnParams& f = P.f;
  const int L = kInter ? f.n : f.S, Lp = wh_keys_padded(L);
  const int Bq = f.Bq;
  const long long problems = wh_problems<kInter>(f);
  const long long per = wide_head_groups(problems, f.h, Lp, 2);
  const T* qkv = static_cast<const T*>(f.qkv);
  const T* dA = static_cast<const T*>(P.dA);
  T* dqkv = static_cast<T*>(P.dqkv);
  float* p = ws;
  float* ds = ws + per * f.h * Lp * static_cast<long long>(Lp);
  for (long long g0 = 0; g0 < problems; g0 += per) {
    const long long groups = per < problems - g0 ? per : problems - g0;
    const long long n_rows = groups * f.h * L;
    CTN_RETURN_IF((wh_attend<T, kInter>(f, p, g0, groups, scale, stream)));
    CTN_RETURN_IF(wh_mm(wh_scores<T, kInter>(f, dA, Bq, 0, 2 * Bq, ds, g0),
                        groups, stream));
    wh_ds_kernel<T><<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0,
                      stream>>>(p, ds, n_rows, L, Lp, scale);
    CTN_RETURN_IF(static_cast<int>(cudaGetLastError()));
    CTN_RETURN_IF(wh_mm(wh_mix<T, kInter, false>(f, ds, qkv, 3 * Bq, Bq,
                                                 dqkv, 3 * Bq, 0, g0),
                        groups, stream));
    CTN_RETURN_IF(wh_mm(wh_mix<T, kInter, true>(f, ds, qkv, 3 * Bq, 0, dqkv,
                                                3 * Bq, Bq, g0),
                        groups, stream));
    CTN_RETURN_IF(wh_mm(wh_mix<T, kInter, true>(f, p, dA, Bq, 0, dqkv,
                                                3 * Bq, 2 * Bq, g0),
                        groups, stream));
  }
  return 0;
}

}  // namespace
