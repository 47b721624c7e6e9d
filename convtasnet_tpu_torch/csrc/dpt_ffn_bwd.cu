// The dual-path FFN sublayer backward for Hopper (sm_90a), bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/dpt_ffn.py::_ffn_bwd_kernel (wrapper
// fused_ffn_bwd). From the rows x [R, B] and the cotangent g of the output
// it returns dx, dgamma, dbeta, dW_up, db_up, dW_down and db_down,
// recomputing the forward from x (only the primals are saved, as the JAX
// rule _fused_ffn_fwd does), with the Pallas body's rounding points:
//
//   y    = round(LN(x) * gamma + beta)             f32 statistics
//   pre  = round(round(y W_up) + round(b_up))
//   h    = round(gelu(pre)), gelu'(pre)           tanh-GELU in f32
//   dh   = g W_down^T                              f32
//   dpre = round(dh * gelu'(pre))
//   dW_down = h^T g, db_down = sum g, dW_up = y^T dpre, db_up = sum dpre
//   dy   = dpre W_up^T (f32), then the LN backward and the residual.
//
// What bounds it on the card. At the DPT quality default (B=256, F=1024)
// and B=8 x 4 s (R = 25,600 rows) the five products of 2 R B F (pre
// recomputed, dh, dy, dW_up, dW_down) are 67.1 GFLOP: 68 us at 989 TFLOP/s,
// against 39 MB of x, g and dx (12 us at 3.35 TB/s): compute-bound. The
// Pallas kernel kept a [kt, F] hidden tile in VMEM and summed the weight
// gradients across its sequential grid; an SM holds 227 KB, so here the
// [R, F] intermediates h and dpre pass through device memory once, and
// every sum over rows is taken in fixed chunks or tiles whose f32 partials
// are added in a fixed order (no atomics: two runs give the same bits).
//
// bf16: five launches on the wgmma core (hopper_gemm.cuh; the generic
// pieces in dpt_bwd_common.cuh):
//   UG  per 128-row tile: the LN of x in ln_rows_kernel's order into a
//       resident K-major y tile (y and each row's mean and rs also to
//       device memory, for W and DN), g's tile resident beside it; the
//       columns of F stream through a cp.async ring, W_up as an MN-major
//       right operand and W_down read K-major as W_down^T (no transpose),
//       into two accumulators, pre and dh of the same (row, column); the
//       epilogue writes h and dpre (never pre) and the tile's column sums
//       of dpre and of g (db_up, db_down);
//   DN  dy = dpre W_up^T on the core with a tile as wide as the row, the
//       LN backward and the residual in its epilogue, with the tile's
//       dgamma and dbeta partials: dy never reaches device memory;
//   W   dW_down = h^T g and dW_up = y^T dpre on wgrad_wg_kernel, in chunks
//       of rows (two launches);
//   S   one launch adds every set of partials in order, in double.
// What remains over the bound: h and dpre, 52 MB each, written by UG and
// read by DN and W, and W's chunk partials.
//   Above B = 256 (at any width) UG's y and g tiles (256 KB at B = 512) and
// DN's tile as wide as the row do not fit: y comes from ln_rows_kernel
// (ln_resident_tile's bits), UG streams y's and g's 64-deep panels through
// its ring beside the weights' slabs (kStream: a slot of 48 KB, three of
// them), the tiles' column sums of g come from colsum_kernel (over the same
// 128-row tiles, in the same row order), and DN takes the wide route
// (launch_dy_ln_wide: dy through device memory, ln_bwd_kernel; above 512
// ln_bwd_wide_kernel): seven launches. UG's slots are 64 deep whatever B
// is, so this route takes every B.
//
// f32: the first design, 16 launches (dpt_bwd_common.cuh's first pieces):
//   T  W_up^T, W_down^T;  L  y;
//   U  pre, from the 64 x 64 tile's epilogue;
//   G  dh = g W_down^T on the same tile, whose epilogue turns pre into h in
//      place and writes dpre;
//   W  dW_down, dW_up over fixed row chunks, db_up, db_down by column sums;
//   D  dy = dpre W_up^T (f32);  N  the LN backward: dx, dgamma, dbeta
//      (ln_bwd_kernel; above B = 512 ln_bwd_wide_kernel, in its order).
//
// Under tensor parallelism (partial, the backward of the Pallas kernel's
// partial=True) the weights are one shard's hidden slice (F is F/m here),
// the forward added neither b_down nor the residual, so db_down is zero
// and dx = round(dx_ln) has no g term.

#include "dpt_bwd_common.cuh"

namespace {

// tanh-GELU and its derivative in f32 (_gelu_and_grad of the Pallas
// backward, jax.nn.gelu's approximate=True).
__device__ __forceinline__ void gelu_and_grad(float x, float* y, float* dy) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float a = 0.044715f;
  const float x3 = x * x * x;
  const float t = tanhf(c * (x + a * x3));
  *y = 0.5f * x * (1.f + t);
  *dy = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * a * x * x);
}

// U: pre = round(round(y W_up) + round(b_up)).
template <typename T>
struct UpBias {
  T* pre;
  const float* b_up;
  __device__ void operator()(size_t i, int col, float v) const {
    pre[i] = from_f<T>(round_to<T>(v) + round_to<T>(b_up[col]));
  }
};

// G: dh = v; h over pre in place, dpre = round(dh * gelu'(pre)).
template <typename T>
struct GeluBwd {
  T* pre_h;
  T* dpre;
  __device__ void operator()(size_t i, int, float v) const {
    float h, dg;
    gelu_and_grad(to_f<T>(pre_h[i]), &h, &dg);
    pre_h[i] = from_f<T>(h);
    dpre[i] = from_f<T>(v * dg);
  }
};

struct FfnBwdParams {
  const void* x;
  const void* g;
  const float* gamma;
  const float* beta;
  const void* w_up;
  const float* b_up;
  const void* w_down;
  void* dx;
  float* dgb;       // [2, B]: dgamma, dbeta
  float* dw_up;     // [B, F]
  float* db_up;     // [F]
  float* dw_down;   // [F, B]
  float* db_down;   // [B]
  int R, B, F, partial;
  int Bn;           // the LN's width (dpt_bwd_common.cuh's top note)
};

// Workspace: n_act elements of T (w_up_t [F, B], w_down_t [B, F], y [R, B],
// h [R, F], dpre [R, F]) and n_f32 floats (dy [R, B], the chunk partials of
// the weight and bias gradients, the LN partials), each segment on a
// 256-byte boundary.
struct FfnBwdLayout {
  size_t act[5];
  size_t f32[3];
  size_t n_act, n_f32;
};

FfnBwdLayout ffn_bwd_layout(int R, int B, int F, size_t elem_bytes) {
  FfnBwdLayout L;
  const size_t rb = static_cast<size_t>(R) * B;
  const size_t rf = static_cast<size_t>(R) * F;
  const size_t bf = static_cast<size_t>(B) * F;
  const size_t act[5] = {bf, bf, rb, rf, rf};
  const size_t f32[3] = {rb, static_cast<size_t>(n_row_chunks(R)) * bf,
                         static_cast<size_t>(n_row_tiles(R)) * 2 * B};
  size_t off = 0;
  for (int i = 0; i < 5; ++i) {
    L.act[i] = off;
    off += align_elems(act[i], 256 / elem_bytes);
  }
  L.n_act = off;
  off = 0;
  for (int i = 0; i < 3; ++i) {
    L.f32[i] = off;
    off += align_elems(f32[i], 64);
  }
  L.n_f32 = off;
  return L;
}

template <typename T>
int launch_bwd(const FfnBwdParams& p, void* ws_act, float* ws_f32,
               cudaStream_t stream) {
  const FfnBwdLayout L = ffn_bwd_layout(p.R, p.B, p.F, sizeof(T));
  T* act = static_cast<T*>(ws_act);
  T* w_up_t = act + L.act[0];
  T* w_down_t = act + L.act[1];
  T* y = act + L.act[2];
  T* h = act + L.act[3];
  T* dpre = act + L.act[4];
  float* dy = ws_f32 + L.f32[0];
  float* wpart = ws_f32 + L.f32[1];
  float* lnpart = ws_f32 + L.f32[2];
  const int R = p.R, B = p.B, F = p.F;
  const T* g = static_cast<const T*>(p.g);
  CTN_RETURN_IF(launch_transpose<T>(p.w_up, w_up_t, B, F, stream));
  CTN_RETURN_IF(launch_transpose<T>(p.w_down, w_down_t, F, B, stream));
  CTN_RETURN_IF(
      launch_ln_rows<T>(p.x, R, B, p.Bn, p.gamma, p.beta, y, stream));
  CTN_RETURN_IF(launch_gemm_rows<T>(y, static_cast<const T*>(p.w_up), R, B, F,
                                    UpBias<T>{h, p.b_up}, stream));
  CTN_RETURN_IF(launch_gemm_rows<T>(g, w_down_t, R, B, F,
                                    GeluBwd<T>{h, dpre}, stream));
  CTN_RETURN_IF(launch_wgrad<T>(h, g, R, F, B, wpart, p.dw_down, stream));
  CTN_RETURN_IF(launch_wgrad<T>(y, dpre, R, B, F, wpart, p.dw_up, stream));
  // the column sums' partials (ceil(R/kColRows) * F floats) fit in wpart
  CTN_RETURN_IF(launch_colsum<T>(dpre, R, F, wpart, p.db_up, stream));
  if (p.partial)   // the partial forward added no down bias
    CTN_RETURN_IF(static_cast<int>(cudaMemsetAsync(
        p.db_down, 0, static_cast<size_t>(B) * sizeof(float), stream)));
  else
    CTN_RETURN_IF(launch_colsum<T>(g, R, B, wpart, p.db_down, stream));
  CTN_RETURN_IF(launch_gemm_rows<T>(dpre, w_up_t, R, F, B, StoreF32{dy},
                                    stream));
  return launch_ln_bwd<T>(p.x, g, dy, p.gamma, R, B, p.Bn, p.dx, lnpart, p.dgb,
                          !p.partial, stream);
}

// ---- bf16: the design on the wgmma core (top note) ----

constexpr int kUgBN = 64;       // UG's column tile of F
constexpr int kUgStages = 3;    // UG's ring depth (slots of W_up and W_down)

// UG's ring slot: W_up's and W_down's slabs, and with kStream y's and g's
// 64-deep panels of the tile's rows.
template <bool kStream>
__host__ __device__ constexpr uint32_t ug_slot() {
  return 2 * kUgBN * kLine + (kStream ? 2 * kWgRows * kLine : 0);
}

// UG's shared memory: the y and g tiles (resident unless kStream), the
// ring, the stage tiles of h and dpre and the warps' column sums.
template <bool kStream>
size_t ug_smem(int B) {
  return 1024 +
         (kStream ? 0 : 2 * static_cast<size_t>(B / kSlabK) * kWgRows * kLine) +
         static_cast<size_t>(kUgStages) * ug_slot<kStream>() +
         2 * stage_bytes<kUgBN>() + 8 * kUgBN * sizeof(float);
}

// The bf16 workspace: y [R, B], h [R, F], dpre [R, F] in bf16; in f32 each
// row's (mean, rs), the two weight gradients' chunk partials, the UG
// tiles' column sums of dpre [tiles, F] and of g [tiles, B], and the DN
// tiles' (dgamma, dbeta) [ln_tiles, 2B] (128-row tiles; above B = 256
// ln_bwd_kernel's 64-row ones) and, above 256 only, dy [R, B]; each
// segment on a 256-byte boundary.
struct FfnWgLayout {
  size_t act[3];
  size_t f32[7];
  size_t n_act, n_f32;
  int chunks_down, chunks_up, tiles, ln_tiles;
};

FfnWgLayout ffn_wg_layout(int R, int B, int F) {
  FfnWgLayout L;
  const bool wide = B > kMaxWidth;
  const size_t bf = static_cast<size_t>(B) * F;
  L.chunks_down = wg_wgrad_chunks(R, F, B);
  L.chunks_up = wg_wgrad_chunks(R, B, F);
  L.tiles = (R + kWgRows - 1) / kWgRows;
  L.ln_tiles = wide ? n_row_tiles(R) : L.tiles;
  const size_t act[3] = {static_cast<size_t>(R) * B, static_cast<size_t>(R) * F,
                         static_cast<size_t>(R) * F};
  const size_t f32[7] = {2 * static_cast<size_t>(R), L.chunks_down * bf,
                         L.chunks_up * bf, static_cast<size_t>(L.tiles) * F,
                         static_cast<size_t>(L.tiles) * B,
                         static_cast<size_t>(L.ln_tiles) * 2 * B,
                         wide ? static_cast<size_t>(R) * B : 0};
  size_t off = 0;
  for (int i = 0; i < 3; ++i) {
    L.act[i] = off;
    off += align_elems(act[i], 128);
  }
  L.n_act = off;
  off = 0;
  for (int i = 0; i < 7; ++i) {
    L.f32[i] = off;
    off += align_elems(f32[i], 64);
  }
  L.n_f32 = off;
  return L;
}

// The workspace segments UG writes.
struct UgOut {
  bf16* y;
  bf16* h;
  bf16* dpre;
  float* lnstat;     // [R, 2]
  float* col_up;     // [tiles, F]: sum of dpre over the tile's rows
  float* col_down;   // [tiles, B]: sum of g (full mode)
};

// Launch UG (top note) for rows [r0, r0 + 128), grid (ceil(R / 128)),
// block 256: x's and g's tiles copied in (K-major, B / 64 panels each) with
// the ring's first slab, y computed over x's in place; the ring over
// (column tile of F, depth slab of B), acc_p = y W_up and acc_d = g W_down^T
// for the same 64 columns; after the last slab of a column tile,
// pre = round(round(acc_p) + round(b_up)), h = round(gelu(pre)) and
// dpre = round(acc_d gelu'(pre)) leave through two stage tiles after one
// barrier, and the tile's column sums of dpre go to col_up. Rows at or
// beyond R read x and g as zeros, so their dpre is zero; h and dpre are not
// stored there. kStream (above B = 256): y [R, B] is in device memory
// already (o.y), and each slot also carries y's and g's panels of the
// slab's depth, so no tile is resident and nothing computes y or g's
// column sums here.
template <bool kStream>
__global__ void __launch_bounds__(kWgCta, 1) ffn_ug_kernel(FfnBwdParams p,
                                                           UgOut o) {
  extern __shared__ uint8_t wg_smem[];
  constexpr uint32_t kHalf = kUgBN * kLine;   // one operand's slab
  constexpr uint32_t kSlot = ug_slot<kStream>();
  constexpr uint32_t kPanel = kWgRows * kLine;   // kStream: y's, g's panel
  const int R = p.R, B = p.B, F = p.F;
  const int nk = B / kSlabK, n_tiles = F / kUgBN;
  const uint32_t ys = align_1024(wg_smem);
  const uint32_t gs = ys + (kStream ? 0 : nk * kWgRows * kLine);
  const uint32_t ring = gs + (kStream ? 0 : nk * kWgRows * kLine);
  uint8_t* y_gen = smem_ptr(wg_smem, ys);
  bf16* st_h = reinterpret_cast<bf16*>(
      smem_ptr(wg_smem, ring + kUgStages * kSlot));
  bf16* st_d = st_h + kWgRows * stage_ld<kUgBN>();
  float* s_col = reinterpret_cast<float*>(st_d + kWgRows * stage_ld<kUgBN>());
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int r0 = blockIdx.x * kWgRows;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w_up = static_cast<const bf16*>(p.w_up);
  const bf16* w_down = static_cast<const bf16*>(p.w_down);
  if constexpr (!kStream) {
    for (int s = 0; s < nk; ++s) {   // in the ring's first copy group
      load_k_panel(gs + s * kWgRows * kLine, static_cast<const bf16*>(p.g), B,
                   r0, kWgRows, R, s * kSlabK, tid, kWgCta);
      load_k_panel(ys + s * kWgRows * kLine, x, B, r0, kWgRows, R, s * kSlabK,
                   tid, kWgCta);
    }
  }

  // y over x's tile in place (ln_resident_tile), also to device memory
  // with each row's (mean, rs)
  auto ln_tile = [&] {
    if constexpr (!kStream) {
      cp_async_wait<kUgStages - 2>();   // the first copy group has landed
      __syncthreads();
      ln_resident_tile(y_gen, p.gamma, p.beta, r0, R, B, p.Bn, o.y,
                       o.lnstat);
      // the ring's next barrier publishes the tile
    }
  };

  float acc_p[kUgBN / 2], acc_d[kUgBN / 2];
  ring_run<kUgStages>(
      n_tiles * nk, ring, kSlot,
      [&](int i, uint32_t slot) {
        const int s = i % nk, n0 = (i / nk) * kUgBN;
        load_mn_slab(slot, w_up, F, s * kSlabK, B, n0, kUgBN, F, tid, kWgCta);
        load_k_panel(slot + kHalf, w_down, B, n0, kUgBN, F, s * kSlabK, tid,
                     kWgCta);
        if constexpr (kStream) {
          load_k_panel(slot + 2 * kHalf, o.y, B, r0, kWgRows, R, s * kSlabK,
                       tid, kWgCta);
          load_k_panel(slot + 2 * kHalf + kPanel,
                       static_cast<const bf16*>(p.g), B, r0, kWgRows, R,
                       s * kSlabK, tid, kWgCta);
        }
      },
      ln_tile,
      [&](int i, uint32_t slot) {
        const int s = i % nk;
        const uint32_t y0 = kStream ? slot + 2 * kHalf
                                    : ys + s * kWgRows * kLine;
        const uint32_t g0 = kStream ? slot + 2 * kHalf + kPanel
                                    : gs + s * kWgRows * kLine;
        fence_acc(acc_p);
        fence_acc(acc_d);
        wgmma_fence();
        mma_slab<kUgBN, false, true>(acc_p, y0 + wg * 64 * kLine, slot,
                                     s > 0);
        mma_slab<kUgBN, false, false>(acc_d, g0 + wg * 64 * kLine,
                                      slot + kHalf, s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc_p);
        fence_acc(acc_d);
        if (s != nk - 1) return;
        const int n0 = (i / nk) * kUgBN;
#pragma unroll
        for (int j = 0; j < kUgBN / 2; j += 2) {
          const float2 bu =
              *reinterpret_cast<const float2*>(p.b_up + n0 + acc_col(t, j));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre = round_to<bf16>(round_to<bf16>(acc_p[j + e]) +
                                             round_to<bf16>(e ? bu.y : bu.x));
            float hv, dg;
            gelu_and_grad_fast(pre, &hv, &dg);
            acc_p[j + e] = hv;
            acc_d[j + e] = round_to<bf16>(acc_d[j + e] * dg);
          }
        }
        stage_acc<kUgBN>(st_h, wg, t, acc_p);
        stage_acc<kUgBN>(st_d, wg, t, acc_d);
        warp_col_sums<kUgBN>(acc_d, s_col, tid);
        __syncthreads();
        stage_store<kUgBN>(st_h, o.h, F, r0, R, n0, tid);
        stage_store<kUgBN>(st_d, o.dpre, F, r0, R, n0, tid);
        if (tid < kUgBN) {
          float sum = 0.f;
          for (int w = 0; w < kWgCta / 32; ++w) sum += s_col[w * kUgBN + tid];
          o.col_up[static_cast<size_t>(blockIdx.x) * F + n0 + tid] = sum;
        }
        // the ring's next barrier comes before the stages and s_col are
        // written again
      });
  if (kStream || p.partial) return;   // colsum_kernel's, or zero
  // the tile's column sums of g, from its resident copy (zeros past R)
  const uint8_t* g_gen = smem_ptr(wg_smem, gs);
  for (int c = tid; c < B; c += kWgCta) {
    const uint8_t* col = g_gen + (c >> 6) * kWgRows * kLine + 2 * (c & 7);
    float sum = 0.f;
    for (int rl = 0; rl < kWgRows; ++rl)
      sum += __bfloat162float(
          *reinterpret_cast<const bf16*>(col + swz(rl, (c & 63) >> 3)));
    o.col_down[static_cast<size_t>(blockIdx.x) * B + c] = sum;
  }
}

template <bool kStream>
int launch_ug(const FfnBwdParams& p, const UgOut& o, int tiles,
              cudaStream_t stream) {
  const size_t smem = ug_smem<kStream>(p.B);
  CTN_RETURN_IF(static_cast<int>(cudaFuncSetAttribute(
      ffn_ug_kernel<kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem))));
  ffn_ug_kernel<kStream><<<tiles, kWgCta, smem, stream>>>(p, o);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward (top note): UG, DN, W (two launches), S; above B = 256
// y by ln_rows_kernel, UG streaming y and g, g's column sums by
// colsum_kernel and DN's wide route.
int launch_bwd_wg(const FfnBwdParams& p, void* ws_act, float* ws_f32,
                  cudaStream_t stream) {
  const int R = p.R, B = p.B, F = p.F;
  const bool wide = B > kMaxWidth;
  if (B % kSlabK || F % kUgBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const FfnWgLayout L = ffn_wg_layout(R, B, F);
  bf16* act = static_cast<bf16*>(ws_act);
  UgOut o;
  o.y = act + L.act[0];
  o.h = act + L.act[1];
  o.dpre = act + L.act[2];
  o.lnstat = ws_f32 + L.f32[0];
  float* part_down = ws_f32 + L.f32[1];
  float* part_up = ws_f32 + L.f32[2];
  o.col_up = ws_f32 + L.f32[3];
  o.col_down = ws_f32 + L.f32[4];
  float* lnpart = ws_f32 + L.f32[5];
  const bf16* g = static_cast<const bf16*>(p.g);
  if (wide) {
    CTN_RETURN_IF(launch_ln_rows<bf16>(p.x, R, B, p.Bn, p.gamma, p.beta,
                                       o.y, stream));
    CTN_RETURN_IF(launch_ug<true>(p, o, L.tiles, stream));
    if (!p.partial)   // [tiles, B]: colsum_kernel's chunks are UG's tiles
      colsum_kernel<bf16><<<dim3((B + kColThreads - 1) / kColThreads,
                                 L.tiles), kColThreads, 0, stream>>>(
          g, R, B, o.col_down);
  } else {
    CTN_RETURN_IF(launch_ug<false>(p, o, L.tiles, stream));
  }
  CTN_CHECK();
  DyLnParams q;
  q.a = o.dpre;
  q.w = static_cast<const bf16*>(p.w_up);
  q.x = static_cast<const bf16*>(p.x);
  q.g = static_cast<const bf16*>(p.g);
  q.gamma = p.gamma;
  q.lnstat = o.lnstat;
  q.dx = static_cast<bf16*>(p.dx);
  q.part = lnpart;
  q.R = R;
  q.B = B;
  q.Bn = p.Bn;
  q.depth = F;
  CTN_RETURN_IF(wide ? launch_dy_ln_wide(q, ws_f32 + L.f32[6], !p.partial,
                                         stream)
                     : launch_dy_ln_wg(q, !p.partial, stream));
  CTN_RETURN_IF(launch_wgrad_parts_wg(o.h, p.g, R, F, B, part_down, stream));
  CTN_RETURN_IF(launch_wgrad_parts_wg(o.y, o.dpre, R, B, F, part_up, stream));
  const ReduceJob jobs[5] = {
      {part_down, L.chunks_down, B * F, p.dw_down},
      {part_up, L.chunks_up, B * F, p.dw_up},
      {o.col_up, L.tiles, F, p.db_up},
      {o.col_down, p.partial ? 0 : L.tiles, B, p.db_down},
      {lnpart, L.ln_tiles, 2 * B, p.dgb}};
  return launch_reduce_jobs(jobs, 5, stream);
}

FfnBwdParams make_params(const void* x, const void* g, const void* gamma,
                         const void* beta, const void* w_up, const void* b_up,
                         const void* w_down, void* dx, void* dgb, void* dw_up,
                         void* db_up, void* dw_down, void* db_down, int R,
                         int B, int Bn, int F, int partial) {
  FfnBwdParams p;
  p.x = x;
  p.g = g;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.w_up = w_up;
  p.b_up = static_cast<const float*>(b_up);
  p.w_down = w_down;
  p.dx = dx;
  p.dgb = static_cast<float*>(dgb);
  p.dw_up = static_cast<float*>(dw_up);
  p.db_up = static_cast<float*>(db_up);
  p.dw_down = static_cast<float*>(dw_down);
  p.db_down = static_cast<float*>(db_down);
  p.R = R;
  p.B = B;
  p.Bn = Bn;
  p.F = F;
  p.partial = partial;
  return p;
}

}  // namespace

#define CTN_FFN_BWD_ARGS                                                     \
  const void *x, const void *g, const void *gamma, const void *beta,        \
      const void *w_up, const void *b_up, const void *w_down, void *ws_act, \
      void *ws_f32, void *dx, void *dgb, void *dw_up, void *db_up,          \
      void *dw_down, void *db_down, int R, int B, int Bn, int F,          \
      int partial, void *stream
#define CTN_FFN_BWD_CALL                                                    \
  make_params(x, g, gamma, beta, w_up, b_up, w_down, dx, dgb, dw_up, db_up, \
              dw_down, db_down, R, B, Bn, F, partial),                      \
      ws_act, static_cast<float*>(ws_f32), static_cast<cudaStream_t>(stream)

extern "C" {

// Workspace of the FFN backward: n_act elements of the compute dtype
// (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats.
int ctn_dpt_ffn_bwd_workspace(int R, int B, int F, int elem_bytes,
                              long long* n_act, long long* n_f32) {
  if (elem_bytes == 2) {   // bf16: the design on the wgmma core
    const FfnWgLayout L = ffn_wg_layout(R, B, F);
    *n_act = static_cast<long long>(L.n_act);
    *n_f32 = static_cast<long long>(L.n_f32);
    return 0;
  }
  const FfnBwdLayout L = ffn_bwd_layout(R, B, F, elem_bytes);
  *n_act = static_cast<long long>(L.n_act);
  *n_f32 = static_cast<long long>(L.n_f32);
  return 0;
}

// One FFN sublayer backward; every pointer is device memory: x, g, w_up,
// w_down, dx and ws_act in the compute dtype, the rest f32; dgb [2, B] =
// dgamma, dbeta; partial: the backward of a shard's partial forward; Bn <=
// B the LN's width, as in the forward. Returns the first CUDA error of its
// launches.
int ctn_dpt_ffn_bwd_f32(CTN_FFN_BWD_ARGS) {
  if (Bn < 1 || Bn > B) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<float>(CTN_FFN_BWD_CALL);
}

int ctn_dpt_ffn_bwd_bf16(CTN_FFN_BWD_ARGS) {
  if (Bn < 1 || Bn > B) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_wg(CTN_FFN_BWD_CALL);
}

}  // extern "C"
