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
//   and dbeta = sum dy; rows up to kMaxWidth = 256 wide, or kLnBwdWidth =
//   512 in its wide instantiation (the bf16 designs' DN above 256 runs it
//   too); rows wider than that on ln_bwd_wide_kernel, its arithmetic in
//   its order without per-lane state (launch_ln_bwd, launch_dy_ln_wide).
// - launch_attention: the f32 attention forwards' three launches around
//   their cores; launch_attention_bwd: the launches both attention
//   backwards share around their cores in f32 (the recompute of qkv by the
//   forward's launch 1, dA, the weight gradients, dy = dqkv @ W_qkv^T, the
//   LN backward); in bf16 they run the design of dpt_attn_bwd_wg.cuh on the
//   pieces below. Above B = kWideMax both take qkv by launch_qkv_rows.
//
// Every LN here (ln_row_stats, ln_rows_kernel, ln_bwd_kernel,
// ln_resident_tile, dy_ln_bwd_wg_kernel) takes the sublayer's own width Bn
// apart from the row's width B: the wrappers pad a B off the 64-column tile
// with zero columns (gamma and beta zero there too, and the weights' rows
// and columns that meet them), so the mean and the variance sweep the
// first Bn columns alone and every mean divides by Bn. The backward's row
// sums of dy gamma and dy gamma xhat still run over B: on a padded column
// dy and gamma are both zero, so each adds an exact zero. At Bn == B every
// sum and every bit is as before.
//
// Each also runs the backward of a tensor-parallel shard (partial, the
// Pallas kernels' partial=True): the products take the shard's widths
// (Bq = h * d for the attention, dW_qkv [B, 3Bq] and dW_out [Bq, B]; F/m
// for the FFN), and since the partial forward added no residual, dx is
// round(dx_ln) with no g term (ln_bwd_kernel<T, false>).

#pragma once

#include "dpt_common.cuh"
#include "hopper_gemm.cuh"

namespace {

#define CTN_RETURN_IF(call)          \
  do {                               \
    const int err_ = (call);         \
    if (err_ != 0) return err_;      \
  } while (0)

// The widest B of the bf16 designs' one-tile pieces (DN's tile as wide as
// the row, LQ's and UG's two resident 128-row tiles, B11's one launch);
// above it, up to kWideMax, they run the wide routes (dpt_attn_bwd_wg.cuh,
// dpt_ffn.cu, dpt_ffn_bwd.cu), chosen by B alone. kWideMax is the capacity
// of the routes whose state is sized by the row (LQ's and F1's one
// resident tile, ln_qkv_kernel's y tile, ln_bwd_kernel's columns); above
// it, again chosen by B alone, routes beside them stream the row through
// device memory, so every B runs.
constexpr int kMaxWidth = 256;
constexpr int kWideMax = 512;             // the resident routes' widest row
constexpr int kLnBwdWidth = 512;          // ln_bwd_kernel's widest row
constexpr int kColThreads = 256;          // colsum_kernel: columns per block
constexpr int kColRows = 128;             // colsum_kernel: rows per block
constexpr int kNumRowStats = 3;           // attention cores: max, denominator, rowsum

// The pre-LN statistics of one row over its first Bn columns, by one warp,
// in ln_rows_to_smem's order.
template <typename T>
__device__ __forceinline__ void ln_row_stats(const T* src, int Bn, float* mean,
                                             float* rs) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < Bn; c += 32) s += to_f<T>(src[c]);
  const float mu = warp_sum(s) / Bn;
  float v = 0.f;
  for (int c = lane; c < Bn; c += 32) {
    const float d = to_f<T>(src[c]) - mu;
    v += d * d;
  }
  *mean = mu;
  *rs = rsqrtf(warp_sum(v) / Bn + kLnEps);
}

// y[r] = round(LN(x[r]) * gamma + beta), the statistics over the first Bn
// of the row's B columns, one warp per row, kRowTile rows per block.
template <typename T>
__global__ void __launch_bounds__(kDptThreads)
    ln_rows_kernel(const T* __restrict__ x, int rows, int B, int Bn,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRowTile; r += kDptThreads / 32) {
    const int row = blockIdx.x * kRowTile + r;
    if (row >= rows) break;
    const T* src = x + static_cast<size_t>(row) * B;
    float mean, rs;
    ln_row_stats<T>(src, Bn, &mean, &rs);
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
// added in warp order). Lane l holds columns l, l + 32, ... below B, and
// each row's sums run over them in that order, then over the lanes by
// warp_sum's butterfly: B <= kWidth; the loops stop at c < B, so a row sums
// in the same order at either instantiation. The 512-wide one (rows above
// 256) holds twice the registers and a 32 KB s_col, and runs 1.5x as long
// at B = 256 (PERF.md §6, PR 19), so rows up to 256 keep the 256-wide one.
// The statistics and both means are over the row's first Bn columns (top
// note).
template <typename T, bool kResidual, int kWidth>
__global__ void __launch_bounds__(kDptThreads)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const float* __restrict__ dy,
                  const float* __restrict__ gamma, int rows, int B, int Bn,
                  T* __restrict__ dx, float* __restrict__ part) {
  constexpr int kWarps = kDptThreads / 32;
  constexpr int kPer = kWidth / 32;    // columns per lane
  __shared__ float s_col[kWarps][2][kWidth];
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
    ln_row_stats<T>(x + base, Bn, &mean, &rs);
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
    const float mean_d = warp_sum(s1) / Bn;
    const float mean_xd = warp_sum(s2) / Bn;
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

// ln_bwd_kernel's arithmetic for rows of any width (above kLnBwdWidth,
// whose per-lane columns and s_col would not fit), with no per-lane state,
// kRowTile rows per block. Phase 1, one warp per row: the statistics
// (ln_row_stats), a lane-strided pass over the row for the sums of dy
// gamma and dy gamma xhat (lane l over columns l, l + 32, ..., then
// warp_sum's butterfly), a second one for dx, and the row's (mean, rs) to
// shared memory. Phase 2, each thread owns columns and loops over the
// tile's rows: a column's (dgamma, dbeta) partial over the rows warp w
// took (w, w + 8, ...) in order, then over the 8 warps in order. Every sum
// runs in ln_bwd_kernel's order, so at a width both take every output has
// its bits (and B = 576 with 64 zero columns has those of B = 512). The
// statistics and both means are over the row's first Bn columns.
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kDptThreads)
    ln_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ dy,
                       const float* __restrict__ gamma, int rows, int B,
                       int Bn, T* __restrict__ dx, float* __restrict__ part) {
  constexpr int kWarps = kDptThreads / 32;
  __shared__ float s_stat[kRowTile][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowTile;
  for (int r = warp; r < kRowTile; r += kWarps) {
    const int row = row0 + r;
    if (row >= rows) break;
    const size_t base = static_cast<size_t>(row) * B;
    float mean, rs;
    ln_row_stats<T>(x + base, Bn, &mean, &rs);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < B; c += 32) {
      const float xh = (to_f<T>(x[base + c]) - mean) * rs;
      const float d = dy[base + c];
      const float dxh = d * gamma[c];
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float mean_d = warp_sum(s1) / Bn;
    const float mean_xd = warp_sum(s2) / Bn;
    for (int c = lane; c < B; c += 32) {
      const float xh = (to_f<T>(x[base + c]) - mean) * rs;
      const float dxh = dy[base + c] * gamma[c];
      if constexpr (kResidual)
        dx[base + c] = from_f<T>(to_f<T>(g[base + c]) +
                                 rs * (dxh - mean_d - xh * mean_xd));
      else
        dx[base + c] = from_f<T>(rs * (dxh - mean_d - xh * mean_xd));
    }
    if (lane == 0) {
      s_stat[r][0] = mean;
      s_stat[r][1] = rs;
    }
  }
  __syncthreads();
  const int n = min(kRowTile, rows - row0);
  for (int c = threadIdx.x; c < B; c += kDptThreads) {
    float pg = 0.f, pb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      float cg = 0.f, cb = 0.f;
      for (int r = w; r < n; r += kWarps) {
        const size_t i = static_cast<size_t>(row0 + r) * B + c;
        const float xh = (to_f<T>(x[i]) - s_stat[r][0]) * s_stat[r][1];
        const float d = dy[i];
        cg += d * xh;
        cb += d;
      }
      pg += cg;
      pb += cb;
    }
    part[static_cast<size_t>(blockIdx.x) * 2 * B + c] = pg;
    part[static_cast<size_t>(blockIdx.x) * 2 * B + B + c] = pb;
  }
}

int n_row_tiles(long long rows) {
  return static_cast<int>((rows + kRowTile - 1) / kRowTile);
}

// The LN backward's kernel for rows of width B: ln_bwd_kernel at 256 up to
// kMaxWidth, at kLnBwdWidth up to it, ln_bwd_wide_kernel above (chosen by B
// alone). residual: dx carries the g term.
template <typename T>
auto ln_bwd_fn(int B, bool residual) {
  if (B > kLnBwdWidth)
    return residual ? ln_bwd_wide_kernel<T, true>
                    : ln_bwd_wide_kernel<T, false>;
  return B > kMaxWidth
      ? (residual ? ln_bwd_kernel<T, true, kLnBwdWidth>
                  : ln_bwd_kernel<T, false, kLnBwdWidth>)
      : (residual ? ln_bwd_kernel<T, true, kMaxWidth>
                  : ln_bwd_kernel<T, false, kMaxWidth>);
}

// dx and dgb [2, B] = (dgamma, dbeta); part holds n_row_tiles(rows) * 2 * B
// floats. residual: dx carries the g term (false for a partial forward);
// Bn the LN's width.
template <typename T>
int launch_ln_bwd(const void* x, const void* g, const float* dy,
                  const float* gamma, int rows, int B, int Bn, void* dx,
                  float* part, float* dgb, bool residual,
                  cudaStream_t stream) {
  const int tiles = n_row_tiles(rows);
  auto* kernel = ln_bwd_fn<T>(B, residual);
  kernel<<<tiles, kDptThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), dy, gamma, rows, B,
      Bn, static_cast<T*>(dx), part);
  CTN_CHECK();
  reduce_chunks_kernel<<<(2 * B + 255) / 256, 256, 0, stream>>>(part, tiles,
                                                                2 * B, dgb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln_rows(const void* x, int rows, int B, int Bn, const float* gamma,
                   const float* beta, void* y, cudaStream_t stream) {
  ln_rows_kernel<T><<<n_row_tiles(rows), kDptThreads, 0, stream>>>(
      static_cast<const T*>(x), rows, B, Bn, gamma, beta, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// The f32 attention frames' launch 1 above kWideMax, where ln_qkv_kernel's
// y tile does not fit: y [R, B] = round(LN(x) gamma + beta) by
// ln_rows_kernel (ln_rows_to_smem's bits) unless y_ready, then qkv =
// round(y @ W_qkv) on gemm_rows_kernel's 64 x 64 FMA tile, each sum over
// the depth in ln_qkv_kernel's order (one FMA chain from column 0), so the
// same bits. Two launches (one with y_ready).
template <typename T>
int launch_qkv_rows(const DptAttnParams& p, void* y, bool y_ready,
                    cudaStream_t stream) {
  const int R = static_cast<int>(p.R);
  if (!y_ready)
    CTN_RETURN_IF(
        launch_ln_rows<T>(p.x, R, p.B, p.Bn, p.gamma, p.beta, y, stream));
  return launch_gemm_rows<T>(static_cast<const T*>(y),
                             static_cast<const T*>(p.w_qkv), R, p.B, 3 * p.Bq,
                             StoreRounded<T>{static_cast<T*>(p.qkv)}, stream);
}

// The f32 attention forward: launches 1 and 3 around an attention core
// (launch 2), on one stream; above kWideMax launch 1 is launch_qkv_rows
// with y in the output buffer, which the out launch overwrites once the
// core is done (no workspace). Returns the first CUDA error.
template <typename T, typename Core>
int launch_attention(const DptAttnParams& p, cudaStream_t stream,
                     Core core) {
  if (p.B > kWideMax)
    CTN_RETURN_IF(launch_qkv_rows<T>(p, p.out, false, stream));
  else
    CTN_RETURN_IF(launch_ln_qkv<T>(p, stream));
  const int core_err = core(p, stream);
  if (core_err != 0) return core_err;
  const unsigned out_tiles = static_cast<unsigned>((p.R + kBM - 1) / kBM);
  out_proj_residual_kernel<T>
      <<<dim3(out_tiles, p.B / kBN), kGemmThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- Pieces on the wgmma core (hopper_gemm.cuh), bf16 ----
//
// The bf16 designs of the FFN backward (dpt_ffn_bwd.cu) and of both
// attention backwards (dpt_attn_bwd_wg.cuh) run on these, and so do the
// bf16 FFN forward (dpt_ffn.cu) and intra attention forward (dpt_intra.cu);
// they sit beside the first design's pieces above, which the f32 kernels
// keep. What bounds them: the products run on wgmma, DN's tile as wide as
// the row up to B = 256 (kMaxWidth; above it the wide routes' pieces
// below), and one CTA of two warpgroups per SM where a 128-row tile of x
// or g stays resident (LQ, UG, DN: 179-214 KB at B = 256).
//
// - gelu_and_grad_fast, gelu_tanh_fast: the tanh-GELU (and its
//   derivative) on the fast exponential (B12's UG, B11's forward);
// - ln_resident_tile: the LN of a resident K-major tile in place, in
//   ln_rows_kernel's order (LQ's and UG's y, B11's);
// - launch_wgrad_parts_wg: the chunk partials of a^T @ b on
//   wgrad_wg_kernel (both operands MN-major, as they are stored), in
//   chunks of rows small enough that the grid fills the card;
// - reduce_jobs_kernel: up to kMaxReduceJobs sums of chunk or tile
//   partials in one launch, each in a fixed order in double;
// - warp_col_sums: a CTA's column sums of a value in the accumulator
//   layout, over its 128 rows, in a fixed order;
// - dy_ln_bwd_wg_kernel: dy = a @ w^T on the core with a column tile as
//   wide as the row (B <= 256), and the LN backward and the residual in its
//   epilogue, so dy never reaches device memory (above 256:
//   launch_dy_ln_wide, below).

constexpr int kWgradStagesDpt = 4;
// The SM count the chunking below is tuned for: an H100 SXM's 132. It is
// a constant, not the device's count, so that the chunks, and with them
// the order of the sums and the bits, are the same on every card; on a
// card with another SM count (an H100 PCIe has 114) the grid fills
// another share of a wave, and only the speed moves.
constexpr int kSmCount = 132;

// Rows per chunk of a^T @ b ([rows, ca], [rows, cb]) on the core: the
// most, up to 8192, that still gives three quarters of a wave of CTAs (one
// CTA per SM) on kSmCount SMs: a wave's time goes as the chunk, so fewer,
// longer chunks cost the product nothing and halve the partials written
// and summed.
inline int wg_wgrad_chunk(long long rows, int ca, int cb) {
  const long long per_chunk =
      static_cast<long long>(ca / (ca % 128 == 0 ? 128 : 64)) * (cb / wg_bn(cb));
  int chunk = 8192;
  while (chunk > 256 &&
         4 * per_chunk * ((rows + chunk - 1) / chunk) < 3 * kSmCount)
    chunk /= 2;
  return chunk;
}

inline int wg_wgrad_chunks(long long rows, int ca, int cb) {
  const int chunk = wg_wgrad_chunk(rows, ca, cb);
  return static_cast<int>((rows + chunk - 1) / chunk);
}

template <int kWG, int BN>
int launch_wgrad_parts_bn(const bf16* a, const bf16* b, int rows, int ca,
                          int cb, int chunk, float* part,
                          cudaStream_t stream) {
  constexpr size_t smem = wgrad_wg_smem<kWG, BN, kWgradStagesDpt>();
  auto kernel = wgrad_wg_kernel<kWG, BN, kWgradStagesDpt>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ca / (64 * kWG), cb / BN, (rows + chunk - 1) / chunk),
           kWG * kWgThreads, smem, stream>>>(a, b, rows, ca, cb, chunk, part);
  return static_cast<int>(cudaGetLastError());
}

template <int kWG>
int launch_wgrad_parts_tile(const bf16* a, const bf16* b, int rows, int ca,
                            int cb, int chunk, float* part,
                            cudaStream_t stream) {
  switch (wg_bn(cb)) {
    case 256:
      return launch_wgrad_parts_bn<kWG, 256>(a, b, rows, ca, cb, chunk, part, stream);
    case 128:
      return launch_wgrad_parts_bn<kWG, 128>(a, b, rows, ca, cb, chunk, part, stream);
    default:
      return launch_wgrad_parts_bn<kWG, 64>(a, b, rows, ca, cb, chunk, part, stream);
  }
}

// part [wg_wgrad_chunks(rows, ca, cb), ca, cb] = the chunk partials of
// a^T @ b over all rows (a [rows, ca], b [rows, cb], bf16, ca and cb
// multiples of 64), in f32; a reduce job adds them in chunk order.
inline int launch_wgrad_parts_wg(const void* a, const void* b, int rows,
                                 int ca, int cb, float* part,
                                 cudaStream_t stream) {
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  const int chunk = wg_wgrad_chunk(rows, ca, cb);
  if (ca % 128 == 0)
    return launch_wgrad_parts_tile<2>(pa, pb, rows, ca, cb, chunk, part, stream);
  return launch_wgrad_parts_tile<1>(pa, pb, rows, ca, cb, chunk, part, stream);
}

// out[i] = the n_parts partials part[z * n + i] added in order of z, in
// double, for i < n; n_parts == 0 writes zeros.
struct ReduceJob {
  const float* part;
  int n_parts;
  int n;
  float* out;
};
constexpr int kMaxReduceJobs = 6;
struct ReduceJobs {
  ReduceJob job[kMaxReduceJobs];
};

// Grid (ceil(largest n / 256), jobs), block 256: job blockIdx.y.
__global__ void __launch_bounds__(256) reduce_jobs_kernel(ReduceJobs jobs) {
  const ReduceJob J = jobs.job[blockIdx.y];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= J.n) return;
  double acc = 0.0;
  int z = 0;
  for (; z + 8 <= J.n_parts; z += 8) {   // 8 loads in flight, added in order
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = J.part[static_cast<size_t>(z + u) * J.n + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; z < J.n_parts; ++z) acc += J.part[static_cast<size_t>(z) * J.n + i];
  J.out[i] = static_cast<float>(acc);
}

inline int launch_reduce_jobs(const ReduceJob* jobs, int count,
                              cudaStream_t stream) {
  if (count < 1 || count > kMaxReduceJobs)
    return static_cast<int>(cudaErrorInvalidValue);
  ReduceJobs js = {};
  int max_n = 0;
  for (int i = 0; i < count; ++i) {
    js.job[i] = jobs[i];
    if (jobs[i].n > max_n) max_n = jobs[i].n;
  }
  reduce_jobs_kernel<<<dim3((max_n + 255) / 256, count), 256, 0, stream>>>(js);
  return static_cast<int>(cudaGetLastError());
}

// The column sums, over this thread's two rows and then the 8 row groups
// of its warp (shuffles over lane bits 2-4), of v in the accumulator layout
// of a BN-wide tile: lanes 0-3 of warp w write s_col[w * BN + column]. A
// CTA's sum is then the 8 warps' entries added in order, after a barrier.
template <int BN>
__device__ __forceinline__ void warp_col_sums(const float (&v)[BN / 2],
                                              float* s_col, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[4 * q + e] + v[4 * q + 2 + e];   // rows r and r + 8
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) s_col[warp * BN + 8 * q + 2 * lane + e] = s;
    }
  }
}

// tanh-GELU and its derivative in f32 on the fast exponential, for the
// bf16 designs: tanh(u) as 1 - 2 / (exp(2u) + 1), within a few f32 ulps of
// tanhf in absolute terms (the f32 designs keep tanhf), far under the bf16
// rounding of h (and dpre) that follows; a quarter of tanhf's
// instructions.
__device__ __forceinline__ void gelu_and_grad_fast(float x, float* y,
                                                   float* dy) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float a = 0.044715f;
  const float t = 1.f - __fdividef(2.f, __expf(2.f * c * (x + a * x * x * x))
                                             + 1.f);
  const float half = 0.5f * (1.f + t);
  *y = x * half;
  *dy = half + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * a * x * x);
}

// The value alone, in the same arithmetic.
__device__ __forceinline__ float gelu_tanh_fast(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float a = 0.044715f;
  const float t = 1.f - __fdividef(2.f, __expf(2.f * c * (x + a * x * x * x))
                                             + 1.f);
  return x * (0.5f * (1.f + t));
}

// y = round(LN(x) gamma + beta) over a CTA's resident K-major tile of 128
// rows (B / 64 panels at y_gen) in place, one warp per row, kLnRows rows of
// a warp at once, each in ln_row_stats' order over the first Bn columns
// (so y has ln_rows_kernel's bits); also to y_out [R, B], and each row's
// (mean, rs) to lnstat [R, 2], where those are not null (a forward needs
// neither); rows at or beyond R stay zero. The caller's barrier (and, for
// wgmma, the async-proxy fence before it) publishes the tile.
__device__ __forceinline__ void ln_resident_tile(uint8_t* y_gen,
                                                 const float* gamma,
                                                 const float* beta, int r0,
                                                 int R, int B, int Bn,
                                                 bf16* y_out, float* lnstat) {
  constexpr int kWarps = kWgCta / 32, kLnRows = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kWgRows; r += kWarps * kLnRows) {
    auto at = [&](int u, int c) {
      return reinterpret_cast<bf16*>(y_gen + (c >> 6) * kWgRows * kLine +
                                     swz(r + kWarps * u, (c & 63) >> 3) +
                                     2 * (c & 7));
    };
    float mean[kLnRows], rs[kLnRows];
#pragma unroll
    for (int u = 0; u < kLnRows; ++u) mean[u] = rs[u] = 0.f;
    for (int c = lane; c < Bn; c += 32) {
#pragma unroll
      for (int u = 0; u < kLnRows; ++u) mean[u] += __bfloat162float(*at(u, c));
    }
#pragma unroll
    for (int u = 0; u < kLnRows; ++u) mean[u] = warp_sum(mean[u]) / Bn;
    for (int c = lane; c < Bn; c += 32) {
#pragma unroll
      for (int u = 0; u < kLnRows; ++u) {
        const float d = __bfloat162float(*at(u, c)) - mean[u];
        rs[u] += d * d;
      }
    }
#pragma unroll
    for (int u = 0; u < kLnRows; ++u) {
      rs[u] = rsqrtf(warp_sum(rs[u]) / Bn + kLnEps);
      const int row = r0 + r + kWarps * u;
      if (lnstat && lane == 0 && row < R) {
        lnstat[2 * row] = mean[u];
        lnstat[2 * row + 1] = rs[u];
      }
    }
    for (int c = lane; c < B; c += 32) {
      const float gm = gamma[c], bt = beta[c];
#pragma unroll
      for (int u = 0; u < kLnRows; ++u) {
        const int row = r0 + r + kWarps * u;
        if (row >= R) continue;
        bf16* e = at(u, c);
        const bf16 v = from_f<bf16>((__bfloat162float(*e) - mean[u]) *
                                    rs[u] * gm + bt);
        *e = v;
        if (y_out) y_out[static_cast<size_t>(row) * B + c] = v;
      }
    }
  }
}

// dy = a @ w^T and the LN backward with the residual, for 128-row tiles.
struct DyLnParams {
  const bf16* a;        // [R, depth] the last product's input cotangent
  const bf16* w;        // [B, depth] its weight, read K-major: dy = a @ w^T
  const bf16* x;        // [R, B] the sublayer input
  const bf16* g;        // [R, B] the output cotangent (the residual's)
  const float* gamma;   // [B]
  const float* lnstat;  // [R, 2] each row's LN mean and rs
  bf16* dx;             // [R, B]
  float* part;          // [ceil(R / 128), 2B]: dgamma, dbeta per tile
  int R, B, depth;
  int Bn;               // the LN's width (top note): the means divide by it
};

constexpr int kDyStages = 4;

template <int BN>
constexpr size_t dy_ln_smem() {
  return 1024 + static_cast<size_t>(kDyStages) * (kWgRows + BN) * kLine +
         2 * 8 * static_cast<size_t>(BN) * sizeof(float);
}
// x's and g's tiles, copied over the ring after the product, fit in it
static_assert(2 * kWgRows * (64 + 8) * sizeof(bf16) <=
                  kDyStages * (kWgRows + 64) * kLine &&
              2 * kWgRows * (256 + 8) * sizeof(bf16) <=
                  kDyStages * (kWgRows + 256) * kLine,
              "dy_ln_bwd_wg_kernel's staged tiles");

// For rows [r0, r0 + 128): dy (f32, in registers) = a @ w^T over depth in
// 64-deep slabs through the ring, both operands K-major, a BN-wide tile
// (BN >= B; columns at or beyond B read w as zeros); then x's tile (and
// g's, kResidual) is copied over the ring in 16-byte rows, and per row,
// over the quad of threads that holds it, ln_bwd_kernel's arithmetic:
// dx = round(g + rs (dy gamma - mean(dy gamma) - xhat mean(dy gamma
// xhat))) (kResidual; without it round(dx_ln)), and the tile's column sums
// of dy xhat and dy into part. Grid (ceil(R / 128)), block 256.
template <int BN, bool kResidual>
__global__ void __launch_bounds__(kWgCta, 1) dy_ln_bwd_wg_kernel(DyLnParams q) {
  extern __shared__ uint8_t wg_smem[];
  constexpr uint32_t kA = kWgRows * kLine, kSlot = kA + BN * kLine;
  const uint32_t ring = align_1024(wg_smem);
  float* s_col = reinterpret_cast<float*>(
      smem_ptr(wg_smem, ring + kDyStages * kSlot));   // [2][8][BN]
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int r0 = blockIdx.x * kWgRows, R = q.R, B = q.B;
  float acc[BN / 2];
  ring_run<kDyStages>(
      q.depth / kSlabK, ring, kSlot,
      [&](int s, uint32_t slot) {
        load_k_panel(slot, q.a, q.depth, r0, kWgRows, R, s * kSlabK, tid,
                     kWgCta);
        load_k_panel(slot + kA, q.w, q.depth, 0, BN, B, s * kSlabK, tid,
                     kWgCta);
      },
      [] {},
      [&](int s, uint32_t slot) {
        mma_begin(acc);
        mma_slab<BN, false, false>(acc, slot + wg * 64 * kLine, slot + kA,
                                   s > 0);
        mma_end(acc);
      });
  // x's (and g's) tile over the ring, once every warpgroup is done with it;
  // rows at or beyond R as zeros
  constexpr int kLdX = BN + 8;   // 16 bytes of pad: conflict-free pairs
  const bf16* xs = reinterpret_cast<const bf16*>(smem_ptr(wg_smem, ring));
  const bf16* gs = xs + kWgRows * kLdX;
  __syncthreads();
  for (int v = tid; v < kWgRows * (B / 8); v += kWgCta) {
    const int rl = v / (B / 8), c = 8 * (v % (B / 8));
    const bool ok = r0 + rl < R;
    const size_t src = ok ? static_cast<size_t>(r0 + rl) * B + c : 0;
    cp_async16(smem_u32(xs + rl * kLdX + c), q.x + src, ok);
    if (kResidual) cp_async16(smem_u32(gs + rl * kLdX + c), q.g + src, ok);
  }
  cp_async_commit();
  // dbeta's partials: dy as it is (zero on rows at or beyond R)
  warp_col_sums<BN>(acc, s_col + 8 * BN, tid);
  cp_async_wait<0>();
  __syncthreads();
  const int c_lane = 2 * (t & 3);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int rl = 64 * wg + acc_row(t, 2 * u), row = r0 + rl;
    const bool ok = row < R;
    const float mean = ok ? q.lnstat[2 * row] : 0.f;
    const float rs = ok ? q.lnstat[2 * row + 1] : 0.f;
    const size_t base = static_cast<size_t>(ok ? row : 0) * B;
    const bf16* xr = xs + rl * kLdX;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + c_lane;
      if (c >= B) continue;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xr + c));
      const float xh0 = (xv.x - mean) * rs, xh1 = (xv.y - mean) * rs;
      const float d0 = acc[4 * j + 2 * u] * q.gamma[c];
      const float d1 = acc[4 * j + 2 * u + 1] * q.gamma[c + 1];
      s1 += d0 + d1;
      s2 += d0 * xh0 + d1 * xh1;
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    const float mean_d = s1 / q.Bn, mean_xd = s2 / q.Bn;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + c_lane;
      const int i0 = 4 * j + 2 * u;
      if (c >= B || !ok) {
        acc[i0] = acc[i0 + 1] = 0.f;
        continue;
      }
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xr + c));
      const float xh0 = (xv.x - mean) * rs, xh1 = (xv.y - mean) * rs;
      float o0 = rs * (acc[i0] * q.gamma[c] - mean_d - xh0 * mean_xd);
      float o1 = rs * (acc[i0 + 1] * q.gamma[c + 1] - mean_d - xh1 * mean_xd);
      if constexpr (kResidual) {
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(gs + rl * kLdX + c));
        o0 += gv.x;
        o1 += gv.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(q.dx + base + c) =
          __floats2bfloat162_rn(o0, o1);
      acc[i0] *= xh0;   // dgamma's term from here on
      acc[i0 + 1] *= xh1;
    }
  }
  warp_col_sums<BN>(acc, s_col, tid);
  __syncthreads();
  for (int e = tid; e < 2 * B; e += kWgCta) {
    const int which = e / B, c = e % B;
    float sum = 0.f;
    for (int w = 0; w < 8; ++w) sum += s_col[(which * 8 + w) * BN + c];
    q.part[static_cast<size_t>(blockIdx.x) * 2 * B + e] = sum;
  }
}

template <int BN, bool kResidual>
int launch_dy_ln_bn(const DyLnParams& q, cudaStream_t stream) {
  constexpr size_t smem = dy_ln_smem<BN>();
  static_assert(smem <= kMaxDynSmem, "dy_ln_bwd_wg_kernel's shared memory");
  auto kernel = dy_ln_bwd_wg_kernel<BN, kResidual>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(q.R + kWgRows - 1) / kWgRows, kWgCta, smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// dx and the tiles' (dgamma, dbeta) partials (q.part) from a @ w^T, B a
// multiple of 64 up to 256 (the tile's width: 64, 128, or 256 with the
// columns beyond B zero), depth a multiple of 64. residual: dx carries the
// g term (false for a partial forward).
template <bool kResidual>
int launch_dy_ln_res(const DyLnParams& q, cudaStream_t stream) {
  if (q.B <= 64) return launch_dy_ln_bn<64, kResidual>(q, stream);
  if (q.B <= 128) return launch_dy_ln_bn<128, kResidual>(q, stream);
  return launch_dy_ln_bn<256, kResidual>(q, stream);
}

inline int launch_dy_ln_wg(const DyLnParams& q, bool residual,
                           cudaStream_t stream) {
  if (q.B % 64 || q.B > kMaxWidth || q.depth % kSlabK)
    return static_cast<int>(cudaErrorInvalidValue);
  return residual ? launch_dy_ln_res<true>(q, stream)
                  : launch_dy_ln_res<false>(q, stream);
}

// ---- The wide routes' pieces (B above kMaxWidth), bf16 ----
//
// - launch_dy_wide: above 256 DN's tile as wide as the row does not fit
//   (its ring and staged x and g tiles would take 300 KB at B = 512), and
//   the LN backward needs sums over the whole row; so dy = a @ w^T goes to
//   device memory in f32 on wg_matmul_kernel (hopper_gemm.cuh: 128-row x
//   BN-column tiles over the row's columns, BN = wg_bn(B)), and
//   ln_bwd_kernel above, the f32 designs' LN backward, reads it back: it
//   finishes each row (its sums of dy gamma and dy gamma xhat over the
//   row, lane by lane, then warp_sum's butterfly; dx with the residual)
//   and writes its 64-row tiles' (dgamma, dbeta) partials; above
//   kLnBwdWidth ln_bwd_wide_kernel does, in the same order. dy's round
//   trip is 4 R B bytes each way.
// - rows_wg_kernel: out = epi(a @ w) over 128-row x BN-column tiles (BN
//   as wide as the row up to 256, then 256-column tiles), a's K-major
//   panels and w's MN-major slabs through a ring, a residual tile staged
//   over the ring after the product: the attention forwards' out launch
//   at every width, B11's two products above 256, and above kWideMax the
//   attention's qkv and dA products (dpt_attn_bwd_wg.cuh's streamed LQ).

// dy [R, B] (f32) = a [R, depth] @ w [B, depth]^T, both K-major.
template <int BN>
int launch_dy_wide_bn(const bf16* a, const bf16* w, float* dy, int R, int B,
                      int depth, cudaStream_t stream) {
  constexpr size_t smem = 1024 + 4 * static_cast<size_t>(kWgRows + BN) * kLine;
  static_assert(smem <= kMaxDynSmem, "wg_matmul_kernel's shared memory");
  auto kernel = wg_matmul_kernel<BN, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((R + kWgRows - 1) / kWgRows, B / BN), kWgCta, smem,
           stream>>>(a, w, dy, R, B, depth);
  return static_cast<int>(cudaGetLastError());
}

// DN above 256 (top of this section): dy = a @ w^T to q.dy, then dx and
// the tiles' (dgamma, dbeta) partials by ln_bwd_kernel (ln_bwd_wide_kernel
// above kLnBwdWidth) into q.part (n_row_tiles(R) 64-row tiles), which the
// caller sums in tile order. residual: dx carries the g term (false for a
// partial forward).
inline int launch_dy_ln_wide(const DyLnParams& q, float* dy, bool residual,
                             cudaStream_t stream) {
  if (q.B % 64 || q.depth % kSlabK)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (wg_bn(q.B)) {
    case 256: err = launch_dy_wide_bn<256>(q.a, q.w, dy, q.R, q.B, q.depth, stream); break;
    case 128: err = launch_dy_wide_bn<128>(q.a, q.w, dy, q.R, q.B, q.depth, stream); break;
    default: err = launch_dy_wide_bn<64>(q.a, q.w, dy, q.R, q.B, q.depth, stream);
  }
  if (err != 0) return err;
  auto* kernel = ln_bwd_fn<bf16>(q.B, residual);
  kernel<<<n_row_tiles(q.R), kDptThreads, 0, stream>>>(
      q.x, q.g, dy, q.gamma, q.R, q.B, q.Bn, q.dx, q.part);
  return static_cast<int>(cudaGetLastError());
}

// Operands of rows_wg_kernel: out [R, N] = epi(a [R, depth] @ w [depth,
// N]), with res [R, N] (or null) handed to epi.
struct RowsWgParams {
  const bf16* a;
  const bf16* w;
  const bf16* res;
  bf16* out;
  int R, N, depth;
};

constexpr int kRowsStages = 4;   // rows_wg_kernel's ring depth

// The ring of (a's panel, w's slab); the staged output tile fits in it.
template <int BN>
constexpr size_t rows_wg_smem() {
  return 1024 + static_cast<size_t>(kRowsStages) * (kWgRows + BN) * kLine;
}
static_assert(kWgRows * (64 + 8) * sizeof(bf16) <=
                  kRowsStages * (kWgRows + 64) * kLine &&
              kWgRows * (256 + 8) * sizeof(bf16) <=
                  kRowsStages * (kWgRows + 256) * kLine,
              "rows_wg_kernel's staged tile");

// Rows [r0, r0 + 128) x columns [n0, n0 + BN) of out (grid (ceil(R / 128),
// ceil(N / BN)), block 256): a's 64-deep panels (rows at or beyond R as
// zeros) and w's [64, BN] slabs (columns at or beyond N as zeros) through
// the ring into a BN-wide accumulator; then res's tile over the ring
// (where res is not null), out = epi(acc, column, res, has_res) per
// element in place over it, and 16-byte rows of the tile's columns below
// N out. N a multiple of 8, depth of 64.
template <int BN, class Epi>
__global__ void __launch_bounds__(kWgCta, 1)
    rows_wg_kernel(RowsWgParams q, Epi epi) {
  extern __shared__ uint8_t wg_smem[];
  constexpr uint32_t kA = kWgRows * kLine, kSlot = kA + BN * kLine;
  constexpr int kLd = BN + 8;   // 16 bytes of pad: conflict-free pairs
  const uint32_t ring = align_1024(wg_smem);
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int r0 = blockIdx.x * kWgRows, n0 = blockIdx.y * BN;
  const int R = q.R, N = q.N;
  const int nb = min(BN, N - n0);   // the tile's columns below N
  float acc[BN / 2];
  ring_run<kRowsStages>(
      q.depth / kSlabK, ring, kSlot,
      [&](int s, uint32_t slot) {
        load_k_panel(slot, q.a, q.depth, r0, kWgRows, R, s * kSlabK, tid,
                     kWgCta);
        load_mn_slab(slot + kA, q.w, N, s * kSlabK, q.depth, n0, BN, N, tid,
                     kWgCta);
      },
      [] {},
      [&](int s, uint32_t slot) {
        mma_begin(acc);
        mma_slab<BN, false, true>(acc, slot + wg * 64 * kLine, slot + kA,
                                  s > 0);
        mma_end(acc);
      });
  bf16* st = reinterpret_cast<bf16*>(smem_ptr(wg_smem, ring));
  const bool has_res = q.res != nullptr;
  __syncthreads();   // every warpgroup is done with the ring
  if (has_res) {
    for (int v = tid; v < kWgRows * (nb / 8); v += kWgCta) {
      const int rl = v / (nb / 8), c = 8 * (v % (nb / 8));
      const bool ok = r0 + rl < R;
      cp_async16(smem_u32(st + rl * kLd + c),
                 q.res + (ok ? static_cast<size_t>(r0 + rl) * N + n0 + c : 0),
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    const int c = acc_col(t, j);
    if (c >= nb) continue;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
        st + (64 * wg + acc_row(t, j)) * kLd + c);
    const float2 rv = has_res ? __bfloat1622float2(*e) : make_float2(0.f, 0.f);
    *e = __floats2bfloat162_rn(epi(acc[j], n0 + c, rv.x, has_res),
                               epi(acc[j + 1], n0 + c + 1, rv.y, has_res));
  }
  __syncthreads();
  for (int v = tid; v < kWgRows * (nb / 8); v += kWgCta) {
    const int rl = v / (nb / 8), c = 8 * (v % (nb / 8));
    if (r0 + rl < R)
      *reinterpret_cast<uint4*>(&q.out[static_cast<size_t>(r0 + rl) * N + n0 + c]) =
          *reinterpret_cast<const uint4*>(&st[rl * kLd + c]);
  }
}

template <int BN, class Epi>
int launch_rows_bn(const RowsWgParams& q, Epi epi, cudaStream_t stream) {
  constexpr size_t smem = rows_wg_smem<BN>();
  static_assert(smem <= kMaxDynSmem, "rows_wg_kernel's shared memory");
  auto kernel = rows_wg_kernel<BN, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((q.R + kWgRows - 1) / kWgRows, (q.N + BN - 1) / BN), kWgCta,
           smem, stream>>>(q, epi);
  return static_cast<int>(cudaGetLastError());
}

// out = epi(a @ w) (RowsWgParams) in one column tile as wide as the row
// up to N = 256 (64, 128, or 256 with the columns past N zero), in
// 256-column tiles above.
template <class Epi>
int launch_rows_wg(const RowsWgParams& q, Epi epi, cudaStream_t stream) {
  if (q.N % 8 || q.N <= 0 || q.depth % kSlabK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q.N <= 64) return launch_rows_bn<64>(q, epi, stream);
  if (q.N <= 128) return launch_rows_bn<128>(q, epi, stream);
  return launch_rows_bn<256>(q, epi, stream);
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

// The attention backward around its core (launch C), on one stream:
//   T  W_qkv^T, W_out^T;  L  qkv = round(LN(x) @ W_qkv) (the forward's
//   launch 1) and y = round(LN(x)) (above kWideMax y first, then qkv from
//   it: launch_qkv_rows);  A  dA = round(g @ W_out^T);
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
  if (B > kWideMax) {
    CTN_RETURN_IF(launch_ln_rows<T>(f.x, R, B, f.Bn, f.gamma, f.beta, P.y,
                                    stream));
    CTN_RETURN_IF(launch_qkv_rows<T>(f, P.y, true, stream));
  } else {
    CTN_RETURN_IF(launch_ln_qkv<T>(f, stream));
    CTN_RETURN_IF(launch_ln_rows<T>(f.x, R, B, f.Bn, f.gamma, f.beta, P.y,
                                    stream));
  }
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
  return launch_ln_bwd<T>(f.x, P.g, P.dy, f.gamma, R, B, f.Bn, P.dx,
                          P.lnpart, P.dgb, !f.partial, stream);
}

inline DptAttnBwdParams make_attn_bwd_params(
    const void* x, const void* g, const void* gamma, const void* beta,
    const void* w_qkv, const void* w_out, const void* bias, void* dx,
    void* dgb, void* dw_qkv, void* dw_out, int M, int n, int S, int B,
    int Bn, int h, int Bq, int partial) {
  DptAttnBwdParams P = {};
  P.f = make_attn_params(x, gamma, beta, w_qkv, w_out, bias, nullptr, nullptr,
                         nullptr, M, n, S, B, Bn, h, Bq, partial);
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
// f32 (bias [n, S] or null); dgb [2, B] = dgamma, dbeta. Bn, Bq and
// partial as in DptAttnParams; d and wide as in CTN_DPT_ATTN_ARGS (wide
// sized for the backward).
#define CTN_DPT_ATTN_BWD_ARGS                                                 \
  const void *x, const void *g, const void *gamma, const void *beta,         \
      const void *w_qkv, const void *w_out, const void *bias, void *ws_act,  \
      void *ws_f32, void *dx, void *dgb, void *dw_qkv, void *dw_out, int M,  \
      int n, int S, int B, int Bn, int h, int Bq, int partial, int d,        \
      void *wide, void *stream
#define CTN_DPT_ATTN_BWD_CALL                                               \
  make_attn_bwd_params(x, g, gamma, beta, w_qkv, w_out, bias, dx, dgb,     \
                       dw_qkv, dw_out, M, n, S, B, Bn, h, Bq, partial),    \
      ws_act, static_cast<float*>(ws_f32), static_cast<cudaStream_t>(stream), \
      d, static_cast<float*>(wide)
