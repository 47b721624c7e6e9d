// Pieces shared by the dual-path (DPT) sublayer backward kernels for Hopper
// (sm_90a): the FFN (dpt_ffn_bwd.cu), the intra-chunk attention
// (dpt_intra_bwd.cu) and the inter-chunk attention (dpt_attention_bwd.cu),
// bf16 or f32.
//
// The Pallas backwards keep one sample's working set in VMEM and carry the
// weight gradients across a sequential grid in f32 output blocks. A GPU grid
// runs in parallel and an SM has 227 KB, so here, as in tcn_block_bwd.cu,
// the intermediates live in device memory, a launch ends at each reduction
// that spans all rows, and every sum over rows is taken in fixed row chunks
// whose f32 partials are added in a fixed order (no atomics: two runs give
// the same bits). The pieces:
//
// - ln_rows_kernel: y = round(LN(x) * gamma + beta), the forward's pre-LN
//   (ln_rows_to_smem's arithmetic, so the same bits), for the weight
//   gradient of the first product.
// - gemm_rows_kernel: out = act @ w on the 64 x 64 tile of
//   tcn_block_common.cuh (WMMA bf16 / FMA f32, f32 accumulation), with an
//   epilogue functor per element; the g @ W^T products read W^T, transposed
//   once per call (transpose_kernel).
// - launch_wgrad: a^T @ b over all rows (wgrad_kernel per kChunkRows rows,
//   then reduce_chunks_kernel in chunk order).
// - colsum_kernel: per-column sums over row chunks (the bias gradients).
// - ln_bwd_kernel: the LN backward of one row in f32 and the residual,
//   dx = round(g + rs * (dy*gamma - mean(dy*gamma) - xhat *
//   mean(dy*gamma*xhat))), with per-tile partials of dgamma = sum dy*xhat
//   and dbeta = sum dy.
// - launch_attention_bwd: the launches both attention backwards share
//   around their cores (the recompute of qkv by the forward's launch 1, dA,
//   the weight gradients, dy = dqkv @ W_qkv^T, the LN backward).
//
// Each also runs the backward of a tensor-parallel shard (partial, the
// Pallas kernels' partial=True): the products take the shard's widths
// (Bq = h * d for the attention, dW_qkv [B, 3Bq] and dW_out [Bq, B]; F/m
// for the FFN), and since the partial forward added no residual, dx is
// round(dx_ln) with no g term (ln_bwd_kernel<T, false>).

#pragma once

#include "dpt_common.cuh"

namespace {

constexpr int kMaxWidth = 256;            // B at most this (checked by the wrappers)
constexpr int kColThreads = 256;          // colsum_kernel: columns per block
constexpr int kColRows = 128;             // colsum_kernel: rows per block
constexpr int kNumRowStats = 3;           // inter core: max, denominator, rowsum

// The pre-LN statistics of one row, by one warp, in ln_rows_to_smem's order.
template <typename T>
__device__ __forceinline__ void ln_row_stats(const T* src, int B, float* mean,
                                             float* rs) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < B; c += 32) s += to_f<T>(src[c]);
  const float mu = warp_sum(s) / B;
  float v = 0.f;
  for (int c = lane; c < B; c += 32) {
    const float d = to_f<T>(src[c]) - mu;
    v += d * d;
  }
  *mean = mu;
  *rs = rsqrtf(warp_sum(v) / B + kLnEps);
}

// y[r] = round(LN(x[r]) * gamma + beta), one warp per row, kRowTile rows per
// block.
template <typename T>
__global__ void __launch_bounds__(kDptThreads)
    ln_rows_kernel(const T* __restrict__ x, int rows, int B,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRowTile; r += kDptThreads / 32) {
    const int row = blockIdx.x * kRowTile + r;
    if (row >= rows) break;
    const T* src = x + static_cast<size_t>(row) * B;
    float mean, rs;
    ln_row_stats<T>(src, B, &mean, &rs);
    T* dst = y + static_cast<size_t>(row) * B;
    for (int c = lane; c < B; c += 32)
      dst[c] = from_f<T>((to_f<T>(src[c]) - mean) * rs * gamma[c] + beta[c]);
  }
}

// out = act[rows, depth] @ w[depth, cols], epi(flat index, column, f32
// value) for every output element. Grid (ceil(rows/kBM), cols/kBN); depth
// % kBK == 0 and cols % kBN == 0.
template <typename T, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_rows_kernel(const T* __restrict__ act, const T* __restrict__ w,
                     int rows, int depth, int cols, Epi epi) {
  using S = GemmSmem<T>;
  __shared__ S s;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  gemm_tile<T>(act, w, rows, depth, cols, r0, n0, s);
  for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN;
    const int c = e % kBN;
    if (r0 + r < rows)
      epi(static_cast<size_t>(r0 + r) * cols + n0 + c, n0 + c,
          s.c[r * S::kLdC + c]);
  }
}

template <typename T, typename Epi>
int launch_gemm_rows(const T* act, const T* w, int rows, int depth, int cols,
                     Epi epi, cudaStream_t stream) {
  const dim3 grid((rows + kBM - 1) / kBM, cols / kBN);
  gemm_rows_kernel<T, Epi><<<grid, kGemmThreads, 0, stream>>>(act, w, rows,
                                                              depth, cols, epi);
  return static_cast<int>(cudaGetLastError());
}

// Epilogues: the product rounded once to T, or kept in f32.
template <typename T>
struct StoreRounded {
  T* out;
  __device__ void operator()(size_t i, int, float v) const {
    out[i] = from_f<T>(v);
  }
};

struct StoreF32 {
  float* out;
  __device__ void operator()(size_t i, int, float v) const { out[i] = v; }
};

// dst [cols, rows] = src [rows, cols]^T.
template <typename T>
int launch_transpose(const void* src, void* dst, int rows, int cols,
                     cudaStream_t stream) {
  transpose_kernel<T><<<dim3(cols / 32, rows / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

int n_row_chunks(long long rows) {
  return static_cast<int>((rows + kChunkRows - 1) / kChunkRows);
}

// out[ca, cb] = a^T @ b over all rows; wpart holds n_row_chunks(rows) * ca
// * cb floats.
template <typename T>
int launch_wgrad(const void* a, const void* b, int rows, int ca, int cb,
                 float* wpart, float* out, cudaStream_t stream) {
  const int n_chunks = n_row_chunks(rows);
  wgrad_kernel<T><<<dim3(ca / kBM, cb / kBN, n_chunks), kGemmThreads, 0,
                    stream>>>(static_cast<const T*>(a),
                              static_cast<const T*>(b), rows, ca, cb, wpart);
  CTN_CHECK();
  reduce_chunks_kernel<<<(ca * cb + 255) / 256, 256, 0, stream>>>(
      wpart, n_chunks, ca * cb, out);
  return static_cast<int>(cudaGetLastError());
}

// part[z][c] = sum of src[r][c] over the kColRows rows r of chunk z. Grid
// (ceil(cols/kColThreads), ceil(rows/kColRows)).
template <typename T>
__global__ void __launch_bounds__(kColThreads)
    colsum_kernel(const T* __restrict__ src, int rows, int cols,
                  float* __restrict__ part) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= cols) return;
  const int r_end = min(rows, static_cast<int>(blockIdx.y + 1) * kColRows);
  float acc = 0.f;
  for (int r = blockIdx.y * kColRows; r < r_end; ++r)
    acc += to_f<T>(src[static_cast<size_t>(r) * cols + c]);
  part[static_cast<size_t>(blockIdx.y) * cols + c] = acc;
}

// out[c] = sum over all rows of src[r][c]; part holds ceil(rows/kColRows)
// * cols floats.
template <typename T>
int launch_colsum(const void* src, int rows, int cols, float* part,
                  float* out, cudaStream_t stream) {
  const int n_chunks = (rows + kColRows - 1) / kColRows;
  colsum_kernel<T><<<dim3((cols + kColThreads - 1) / kColThreads, n_chunks),
                     kColThreads, 0, stream>>>(static_cast<const T*>(src),
                                               rows, cols, part);
  CTN_CHECK();
  reduce_chunks_kernel<<<(cols + 255) / 256, 256, 0, stream>>>(part, n_chunks,
                                                               cols, out);
  return static_cast<int>(cudaGetLastError());
}

// The LN backward and the residual for kRowTile rows per block, one warp
// per row: dx = round(g + dx_ln) (kResidual; without it, the backward of a
// partial forward, dx = round(dx_ln)) and part[tile][0:B] = sum dy*xhat,
// part[tile][B:2B] = sum dy over the tile's rows (the warps' column sums
// added in warp order).
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kDptThreads)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const float* __restrict__ dy,
                  const float* __restrict__ gamma, int rows, int B,
                  T* __restrict__ dx, float* __restrict__ part) {
  constexpr int kWarps = kDptThreads / 32;
  constexpr int kPer = kMaxWidth / 32;    // columns per lane
  __shared__ float s_col[kWarps][2][kMaxWidth];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float cg[kPer], cb[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) cg[i] = cb[i] = 0.f;
  for (int r = warp; r < kRowTile; r += kWarps) {
    const int row = blockIdx.x * kRowTile + r;
    if (row >= rows) break;
    const size_t base = static_cast<size_t>(row) * B;
    float mean, rs;
    ln_row_stats<T>(x + base, B, &mean, &rs);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < B) {
        const float xh = (to_f<T>(x[base + c]) - mean) * rs;
        const float d = dy[base + c];
        const float dxh = d * gamma[c];
        s1 += dxh;
        s2 += dxh * xh;
        cg[i] += d * xh;
        cb[i] += d;
      }
    }
    const float mean_d = warp_sum(s1) / B;
    const float mean_xd = warp_sum(s2) / B;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < B) {
        const float xh = (to_f<T>(x[base + c]) - mean) * rs;
        const float dxh = dy[base + c] * gamma[c];
        if constexpr (kResidual)
          dx[base + c] = from_f<T>(to_f<T>(g[base + c]) +
                                   rs * (dxh - mean_d - xh * mean_xd));
        else
          dx[base + c] = from_f<T>(rs * (dxh - mean_d - xh * mean_xd));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < B) {
      s_col[warp][0][c] = cg[i];
      s_col[warp][1][c] = cb[i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * B; e += kDptThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += s_col[w][e / B][e % B];
    part[static_cast<size_t>(blockIdx.x) * 2 * B + e] = acc;
  }
}

int n_row_tiles(long long rows) {
  return static_cast<int>((rows + kRowTile - 1) / kRowTile);
}

// dx and dgb [2, B] = (dgamma, dbeta); part holds n_row_tiles(rows) * 2 * B
// floats. residual: dx carries the g term (false for a partial forward).
template <typename T>
int launch_ln_bwd(const void* x, const void* g, const float* dy,
                  const float* gamma, int rows, int B, void* dx, float* part,
                  float* dgb, bool residual, cudaStream_t stream) {
  const int tiles = n_row_tiles(rows);
  auto* kernel = residual ? ln_bwd_kernel<T, true> : ln_bwd_kernel<T, false>;
  kernel<<<tiles, kDptThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), dy, gamma, rows, B,
      static_cast<T*>(dx), part);
  CTN_CHECK();
  reduce_chunks_kernel<<<(2 * B + 255) / 256, 256, 0, stream>>>(part, tiles,
                                                                2 * B, dgb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln_rows(const void* x, int rows, int B, const float* gamma,
                   const float* beta, void* y, cudaStream_t stream) {
  ln_rows_kernel<T><<<n_row_tiles(rows), kDptThreads, 0, stream>>>(
      static_cast<const T*>(x), rows, B, gamma, beta, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// Operands of one attention sublayer backward (see the wrappers in
// ops/cuda/dpt_attention.py). f: the forward's operands, with its qkv and a
// workspaces (the recomputed qkv; the core writes a); g [R, B] in T. The
// workspace in T: y [R, B], dA [R, Bq], dqkv [R, 3Bq], w_qkv_t [3Bq, B],
// w_out_t [B, Bq]; in f32: dy [R, B], stats [R, h, kNumRowStats] (the inter
// core's per-query max, denominator and rowsum), wpart, lnpart. Outputs:
// dx [R, B] in T; dgb [2, B], dw_qkv [B, 3Bq], dw_out [Bq, B] in f32. Bq ==
// B for the full sublayer.
struct DptAttnBwdParams {
  DptAttnParams f;
  const void* g;
  void* y;
  void* dA;
  void* dqkv;
  void* w_qkv_t;
  void* w_out_t;
  float* dy;
  float* stats;
  float* wpart;
  float* lnpart;
  void* dx;
  float* dgb;
  float* dw_qkv;
  float* dw_out;
};

// Workspace of an attention backward: n_act elements of T and n_f32 floats,
// each segment on a 256-byte boundary; offsets in the order of the struct.
struct AttnBwdLayout {
  size_t act[7];   // qkv, a, y, dA, dqkv, w_qkv_t, w_out_t
  size_t f32[4];   // dy, stats, wpart, lnpart
  size_t n_act, n_f32;
};

inline size_t align_elems(size_t n, size_t a) { return (n + a - 1) / a * a; }

AttnBwdLayout attn_bwd_layout(long long R, int B, int h, int Bq,
                              size_t elem_bytes) {
  AttnBwdLayout L;
  const size_t rb = static_cast<size_t>(R) * B;
  const size_t rq = static_cast<size_t>(R) * Bq;
  const size_t bq = static_cast<size_t>(B) * Bq;
  const size_t act[7] = {3 * rq, rq, rb, rq, 3 * rq, 3 * bq, bq};
  const size_t f32[4] = {
      rb, static_cast<size_t>(R) * h * kNumRowStats,
      static_cast<size_t>(n_row_chunks(R)) * 3 * bq,
      static_cast<size_t>(n_row_tiles(R)) * 2 * B};
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    L.act[i] = off;
    off += align_elems(act[i], 256 / elem_bytes);
  }
  L.n_act = off;
  off = 0;
  for (int i = 0; i < 4; ++i) {
    L.f32[i] = off;
    off += align_elems(f32[i], 64);
  }
  L.n_f32 = off;
  return L;
}

// Points the workspaces of P at their segments of ws_act and ws_f32.
template <typename T>
void attn_bwd_carve(DptAttnBwdParams& P, void* ws_act, float* ws_f32) {
  const AttnBwdLayout L =
      attn_bwd_layout(P.f.R, P.f.B, P.f.h, P.f.Bq, sizeof(T));
  T* act = static_cast<T*>(ws_act);
  P.f.qkv = act + L.act[0];
  P.f.a = act + L.act[1];
  P.y = act + L.act[2];
  P.dA = act + L.act[3];
  P.dqkv = act + L.act[4];
  P.w_qkv_t = act + L.act[5];
  P.w_out_t = act + L.act[6];
  P.dy = ws_f32 + L.f32[0];
  P.stats = ws_f32 + L.f32[1];
  P.wpart = ws_f32 + L.f32[2];
  P.lnpart = ws_f32 + L.f32[3];
}

#define CTN_RETURN_IF(call)          \
  do {                               \
    const int err_ = (call);         \
    if (err_ != 0) return err_;      \
  } while (0)

// The attention backward around its core (launch C), on one stream:
//   T  W_qkv^T, W_out^T;  L  qkv = round(LN(x) @ W_qkv) (the forward's
//   launch 1) and y = round(LN(x));  A  dA = round(g @ W_out^T);
//   C  the core: a = round(round(p) v) and dqkv = (dq | dk | dv);
//   W  dW_qkv = y^T dqkv, dW_out = a^T g;  D  dy = dqkv @ W_qkv^T (f32);
//   N  the LN backward and the residual (none for a partial forward): dx,
//      dgamma, dbeta.
// Returns the first CUDA error.
template <typename T, typename Core>
int launch_attention_bwd(DptAttnBwdParams P, void* ws_act, float* ws_f32,
                         cudaStream_t stream, Core core) {
  attn_bwd_carve<T>(P, ws_act, ws_f32);
  const DptAttnParams& f = P.f;
  const int R = static_cast<int>(f.R);
  const int B = f.B;
  const int Bq = f.Bq;
  CTN_RETURN_IF(launch_transpose<T>(f.w_qkv, P.w_qkv_t, B, 3 * Bq, stream));
  CTN_RETURN_IF(launch_transpose<T>(f.w_out, P.w_out_t, Bq, B, stream));
  CTN_RETURN_IF(launch_ln_qkv<T>(f, stream));
  CTN_RETURN_IF(launch_ln_rows<T>(f.x, R, B, f.gamma, f.beta, P.y, stream));
  CTN_RETURN_IF(launch_gemm_rows<T>(
      static_cast<const T*>(P.g), static_cast<const T*>(P.w_out_t), R, B, Bq,
      StoreRounded<T>{static_cast<T*>(P.dA)}, stream));
  CTN_RETURN_IF(core(P, stream));
  CTN_RETURN_IF(launch_wgrad<T>(P.y, P.dqkv, R, B, 3 * Bq, P.wpart,
                                P.dw_qkv, stream));
  CTN_RETURN_IF(launch_wgrad<T>(f.a, P.g, R, Bq, B, P.wpart, P.dw_out,
                                stream));
  CTN_RETURN_IF(launch_gemm_rows<T>(
      static_cast<const T*>(P.dqkv), static_cast<const T*>(P.w_qkv_t), R,
      3 * Bq, B, StoreF32{P.dy}, stream));
  return launch_ln_bwd<T>(f.x, P.g, P.dy, f.gamma, R, B, P.dx, P.lnpart,
                          P.dgb, !f.partial, stream);
}

inline DptAttnBwdParams make_attn_bwd_params(
    const void* x, const void* g, const void* gamma, const void* beta,
    const void* w_qkv, const void* w_out, const void* bias, void* dx,
    void* dgb, void* dw_qkv, void* dw_out, int M, int n, int S, int B,
    int h, int Bq, int partial) {
  DptAttnBwdParams P = {};
  P.f = make_attn_params(x, gamma, beta, w_qkv, w_out, bias, nullptr, nullptr,
                         nullptr, M, n, S, B, h, Bq, partial);
  P.g = g;
  P.dx = dx;
  P.dgb = static_cast<float*>(dgb);
  P.dw_qkv = static_cast<float*>(dw_qkv);
  P.dw_out = static_cast<float*>(dw_out);
  return P;
}

}  // namespace

// The C interface of both attention backwards: every pointer is device
// memory; x, g, w_qkv, w_out, dx and ws_act in the compute dtype, the rest
// f32 (bias [n, S] or null); dgb [2, B] = dgamma, dbeta. Bq and partial as
// in DptAttnParams.
#define CTN_DPT_ATTN_BWD_ARGS                                                 \
  const void *x, const void *g, const void *gamma, const void *beta,         \
      const void *w_qkv, const void *w_out, const void *bias, void *ws_act,  \
      void *ws_f32, void *dx, void *dgb, void *dw_qkv, void *dw_out, int M,  \
      int n, int S, int B, int h, int Bq, int partial, void *stream
#define CTN_DPT_ATTN_BWD_CALL                                               \
  make_attn_bwd_params(x, g, gamma, beta, w_qkv, w_out, bias, dx, dgb,     \
                       dw_qkv, dw_out, M, n, S, B, h, Bq, partial),        \
      ws_act, static_cast<float*>(ws_f32), static_cast<cudaStream_t>(stream)
