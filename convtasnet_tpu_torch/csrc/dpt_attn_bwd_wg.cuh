// The bf16 design of both attention sublayer backwards for Hopper (sm_90a):
// the intra-chunk one (B10, dpt_intra_bwd.cu) and the inter-chunk one (B8,
// dpt_attention_bwd.cu), each also in partial mode (B10p, B8p); and the
// forward frame built from its pieces, which both forwards run: the
// intra-chunk one (B9, B9p, dpt_intra.cu) and the inter-chunk one (B7,
// B7p, dpt_attention.cu), each with its row gather. Head widths d = 16,
// 32, 64 and 128 (core_head_width). f32 keeps the first designs
// (launch_attention_bwd in dpt_bwd_common.cuh, launch_attention in
// dpt_common.cuh) at d = 32 and 64.
//
// The forward (launch_attention_fwd_wg), three launches:
//   F1   attn_lq_kernel<BN, false>: LQ below without g's tile, dA, y or the
//        LN statistics: qkv = round(LN(x) @ W_qkv);
//   C    attn_fwd_core_kernel: the core's query side, passes 1 and 2 alone
//        (core_row_stats and core_probs_pass, the device functions the
//        backward's query side also calls): a = round(round(p) v) on
//        mma.sync, the keys past L masked with -inf;
//   out  rows_wg_kernel (dpt_bwd_common.cuh) with AttnOutEpi:
//        x + round(a @ W_out) (partial: the product alone) per 128-row
//        tile, a's panels and W_out's MN-major slabs through a ring, x's
//        tile and the output staged over the ring; one column tile as wide
//        as the row up to B = 256, 256-column tiles above.
//
// The backward, six launches, on one stream:
//   LQ  one launch, per 128-row tile on the wgmma core (hopper_gemm.cuh):
//       x's and g's tiles resident K-major, the LN of x in ln_rows_kernel's
//       order over x's tile in place (so y has its bits; y and each row's
//       mean and rs also to device memory, for W and DN); then one ring per
//       product, in 128-column tiles where Bq is a multiple of 128 (else
//       64): qkv = round(y @ W_qkv) with W_qkv an MN-major right operand,
//       and dA = round(g @ W_out^T) with W_out read K-major as W_out^T (no
//       transpose launch). The two products share no operand, so two
//       rings keep each ring's slabs of one layout (a branch between the
//       layouts inside one ring serialises the wgmmas);
//   C   the attention core (below): a and dqkv = (dq | dk | dv);
//   W   dW_qkv = y^T dqkv and dW_out = a^T g on wgrad_wg_kernel, in chunks
//       of rows (two launches);
//   DN  dy = dqkv @ W_qkv^T on the core with the LN backward and the
//       residual (none in partial mode) in its epilogue, from LQ's (mean,
//       rs): dy never reaches device memory;
//   S   one launch adds the chunk and tile partials of dW_qkv, dW_out and
//       (dgamma, dbeta), each in a fixed order in double.
//
// Above B = 256 (up to 512; every launch path is chosen by B alone, so a
// width up to 256 runs as before): LQ and F1 keep one resident 128-row
// tile (the backward copies g's over y's between its two products), and
// DN, whose tile as wide as the row would not fit, writes dy to device
// memory on the core and finishes each row in ln_bwd_kernel
// (launch_dy_ln_wide, dpt_bwd_common.cuh): seven launches. The core works
// per head and takes any head count (10 to 16 heads of 32 at B = 320 to
// 512, a CTA each).
//
// Above B = 512 (kWideMax, chosen by B alone) one resident tile of x no
// longer fits (128 KB at 512, LQ's 216 KB there), so LQ and F1 stream the
// row instead (launch_qkv_streamed): y = round(LN(x) gamma + beta) by
// ln_rows_kernel into device memory (ln_resident_tile's bits; the
// backward's y segment, the forward's output buffer until out overwrites
// it), then qkv = round(y @ W_qkv) on rows_wg_kernel, y's 64-deep panels
// and W_qkv's MN-major slabs through its ring; the backward then
// transposes W_out once (w_out_t, a segment of its workspace only above
// 512) and runs dA = round(g @ W_out^T) the same way: F1 two launches, LQ
// four. DN finishes each row in ln_bwd_wide_kernel (launch_dy_ln_wide).
// Every other launch is as at 512.
//
// The core (attn_bwd_core_kernel) is one kernel for both kinds, templated
// on the row gather: a CTA takes one problem, the L rows that attend to
// each other for one head (intra: the S rows of one chunk, contiguous, the
// key bias per (chunk, key); inter: the n rows of the chunks at one
// position s, strided by S rows, the key bias per (key chunk, s)), and
// computes on mma.sync.m16n8k16 (bf16 operands through ldmatrix, .trans
// for the transposed products, f32 accumulators in registers). It
// recomputes instead of keeping an [L, L] tile, so it takes any L in the
// same shared memory:
//   query side  a warp owns 16 query rows (its q and dA fragments in
//               registers) and walks the keys in tiles of 16, the keys'
//               k and v rows staged in shared memory in blocks of up to
//               kCoreBlock rows: pass 1 the row max and denominator
//               (online), pass 2 p, a = round(round(p) v), dp = dA v^T and
//               rowsum = sum p dp in f32, pass 3 ds = round(p (dp - rowsum)
//               scale) and dq = round(ds k); (max, denominator, rowsum) to
//               the f32 stats workspace;
//   key side    after a block barrier a warp owns 16 key rows (k and v
//               fragments in registers) and walks the queries in tiles of
//               16, their q and dA rows and stats staged likewise; it
//               rebuilds p and ds with the same arithmetic and accumulates
//               dv = round(round(p)^T dA) and dk = round(ds^T q) (at d =
//               128 in a walk each: the fragments and both accumulators
//               would not fit in 255 registers).
// Keys beyond L read as zero rows with bias -inf (p exactly 0), queries
// beyond L as zero rows with stats (max +inf, 1 / denominator 0): they
// contribute exactly 0 and are not stored. With L = 1 every row has one
// key and p = 1, as in the reference. No atomics: every sum over rows is
// a loop in a fixed order, so two runs give the same bits.
//
// What bounds it. At the DPT quality default (B=256, 8 heads of 32, S=128)
// and B=8 x 4 s (R = 25,600 rows) the 11 projection products are 36.9
// GFLOP; the intra core with its recompute (q k^T four times, dA v^T three
// times, p v, ds k, p^T dA, ds^T q) about 18.5 GFLOP, the inter one (n = 25)
// 3.6: compute-bound (x, g and dx are 39 MB, 12 us at 3.35 TB/s). The core
// runs on mma.sync at a fraction of wgmma's rate, with its exponentials and
// the softmax backward on the FMA units. What remains over the bound: the
// qkv, dA, a, dqkv and y round trips through device memory (about 300 MB
// written and read at the default), W's chunk partials, and the core's
// recompute. The forward's bounds are in dpt_intra.cu's note.

#pragma once

#include "dpt_bwd_common.cuh"

namespace {

// ---- LQ (and the forward's F1) ----

// A rows_wg_kernel epilogue: round(a @ W_out), plus x where the launch
// stages it (the attention forward's out: the full sublayer; partial, or
// with no residual tile, the product alone, rounded once: also the
// streamed LQ's products above kWideMax).
struct AttnOutEpi {
  __device__ float operator()(float acc, int, float x, bool residual) const {
    float o = round_to<bf16>(acc);
    if (residual) o += x;
    return o;
  }
};

// F1 above kWideMax (top note): y = round(LN(x) gamma + beta) to y [R, B]
// by ln_rows_kernel, then qkv = round(y @ W_qkv) into f.qkv on
// rows_wg_kernel: two launches.
inline int launch_qkv_streamed(const DptAttnParams& f, bf16* y,
                               cudaStream_t stream) {
  const int R = static_cast<int>(f.R);
  CTN_RETURN_IF(
      launch_ln_rows<bf16>(f.x, R, f.B, f.Bn, f.gamma, f.beta, y, stream));
  RowsWgParams q;
  q.a = y;
  q.w = static_cast<const bf16*>(f.w_qkv);
  q.res = nullptr;
  q.out = static_cast<bf16*>(f.qkv);
  q.R = R;
  q.N = 3 * f.Bq;
  q.depth = f.B;
  return launch_rows_wg(q, AttnOutEpi{}, stream);
}

// LQ's column tile: 128 where Bq (and so 3Bq) is a multiple of 128, else
// 64; its ring depth: the backward's 128-wide slots and stage tile beside
// x's and g's tiles leave room for 3 (64-wide: 4); the forward (no g tile)
// takes 4 at 128 wide (164 KB, one CTA per SM) and 3 at 64 wide, where
// that leaves 108 KB, so that two CTAs share an SM and its 200 tiles run
// in one wave (its LN and x's load are as long as at 128 wide, its
// product a quarter).
//   Above B = 256 (kWide) one 128-row tile of x is 16 KB a 64-column panel,
// 128 KB at B = 512, so x's and g's tiles no longer fit side by side: the
// backward copies g's tile over y's once the qkv product is done (y is in
// device memory by then), and both the forward and the backward keep one
// resident tile and a ring of 3 slots at 128 wide (216 KB at B = 512), 4
// at 64 wide (183 KB). The products, and every bit they give, are those
// of the narrow layout.
template <int BN, bool kBwd, bool kWide>
__host__ __device__ constexpr int lq_stages() {
  return kWide ? (BN == 128 ? 3 : 4)
               : kBwd ? (BN == 128 ? 3 : 4) : (BN == 128 ? 4 : 3);
}

// The resident tiles: x's (y's), and g's beside it in the narrow backward.
template <bool kBwd, bool kWide>
__host__ __device__ constexpr int lq_tiles() { return kBwd && !kWide ? 2 : 1; }

template <int BN, bool kBwd, bool kWide>
constexpr size_t lq_smem(int B) {
  return 1024 +
         lq_tiles<kBwd, kWide>() * static_cast<size_t>(B / kSlabK) * kWgRows *
             kLine +
         static_cast<size_t>(lq_stages<BN, kBwd, kWide>()) * BN * kLine +
         stage_bytes<BN>();
}
static_assert(lq_smem<128, true, false>(kMaxWidth) <= kMaxDynSmem,
              "LQ's shared memory");
static_assert(lq_smem<128, true, true>(kWideMax) <= kMaxDynSmem &&
                  lq_smem<64, true, true>(kWideMax) <= kMaxDynSmem,
              "LQ's shared memory above 256");
static_assert(2 * lq_smem<64, false, false>(256) <= 233472 - 2048,
              "two forward LQ CTAs at 64 wide share an SM");

// The workspace segments LQ writes (the forward: qkv alone, the rest null).
struct LqOut {
  bf16* qkv;       // [R, 3Bq]
  bf16* dA;        // [R, Bq]
  bf16* y;         // [R, B]
  float* lnstat;   // [R, 2]
};

// One of LQ's two products for the CTA's 128 rows: out [R, cols] =
// round(a @ w'), a the resident K-major tile at a_tile (B / 64 panels), in
// BN-column tiles over a ring of 64-deep slabs of w' (kTB: w [B, cols]
// read MN-major; else w [cols, B] read K-major as w^T); after a tile's
// last slab it leaves through the stage tile. pre() runs once with the
// ring's first copies in flight.
template <int BN, int kStages, bool kTB, class Pre>
__device__ __forceinline__ void lq_product(float (&acc)[BN / 2], int cols,
                                           int B, uint32_t a_tile,
                                           const bf16* w, bf16* out,
                                           uint32_t ring, bf16* st, int r0,
                                           int R, Pre pre) {
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int nk = B / kSlabK;
  ring_run<kStages>(
      (cols / BN) * nk, ring, BN * kLine,
      [&](int i, uint32_t slot) {
        const int n0 = (i / nk) * BN, k0 = (i % nk) * kSlabK;
        if constexpr (kTB)
          load_mn_slab(slot, w, cols, k0, B, n0, BN, cols, tid, kWgCta);
        else
          load_k_panel(slot, w, B, n0, BN, cols, k0, tid, kWgCta);
      },
      pre,
      [&](int i, uint32_t slot) {
        const int s = i % nk;
        mma_begin(acc);
        mma_slab<BN, false, kTB>(
            acc, a_tile + s * kWgRows * kLine + wg * 64 * kLine, slot, s > 0);
        mma_end(acc);
        if (s != nk - 1) return;
        stage_acc<BN>(st, wg, t, acc);
        __syncthreads();
        stage_store<BN>(st, out, cols, r0, R, (i / nk) * BN, tid);
        // the ring's next barrier comes before the stage is written again
      });
}

// Launch LQ (top note; kBwd) or the forward's F1 for rows [r0, r0 + 128),
// grid (ceil(R / 128)), block 256: x's tile (and g's, kBwd) copied in with
// the first ring's first slab, y over x's tile in place; then qkv =
// round(y @ W_qkv), and with kBwd dA = round(g @ W_out^T), one ring each
// (kWide: g's tile copied over y's with the second ring's first slab).
// The forward writes neither y nor the LN statistics (o.y, o.lnstat null)
// and reads no g. Rows at or beyond R read x and g as zeros and are not
// stored.
template <int BN, bool kBwd, bool kWide>
__global__ void __launch_bounds__(kWgCta, 1)
    attn_lq_kernel(DptAttnParams f, const bf16* __restrict__ g, LqOut o) {
  extern __shared__ uint8_t wg_smem[];
  constexpr int kStages = lq_stages<BN, kBwd, kWide>();
  const int R = static_cast<int>(f.R), B = f.B, Bq = f.Bq;
  const int nk = B / kSlabK;
  const uint32_t ys = align_1024(wg_smem);
  // g's tile: beside y's (the narrow backward), or over it (kWide)
  const uint32_t gs = ys + (kWide ? 0 : nk * kWgRows * kLine);
  const uint32_t ring = ys + lq_tiles<kBwd, kWide>() * nk * kWgRows * kLine;
  bf16* st = reinterpret_cast<bf16*>(
      smem_ptr(wg_smem, ring + kStages * BN * kLine));
  const int tid = threadIdx.x, r0 = blockIdx.x * kWgRows;
  auto load_g = [&] {
    for (int s = 0; s < nk; ++s)
      load_k_panel(gs + s * kWgRows * kLine, g, B, r0, kWgRows, R,
                   s * kSlabK, tid, kWgCta);
  };
  for (int s = 0; s < nk; ++s)   // in the first ring's first copy group
    load_k_panel(ys + s * kWgRows * kLine, static_cast<const bf16*>(f.x), B,
                 r0, kWgRows, R, s * kSlabK, tid, kWgCta);
  if constexpr (kBwd && !kWide) load_g();
  float acc[BN / 2];
  lq_product<BN, kStages, true>(
      acc, 3 * Bq, B, ys, static_cast<const bf16*>(f.w_qkv), o.qkv, ring, st,
      r0, R, [&] {
        cp_async_wait<kStages - 2>();   // the first group has landed
        __syncthreads();
        ln_resident_tile(smem_ptr(wg_smem, ys), f.gamma, f.beta, r0, R, B,
                         f.Bn, o.y, o.lnstat);
        // the ring's next barrier publishes the tile
      });
  if constexpr (kBwd) {
    __syncthreads();   // the first ring's slots, the stage (and y's tile) are free
    if constexpr (kWide) load_g();   // in the second ring's first copy group
    lq_product<BN, kStages, false>(acc, Bq, B, gs,
                                   static_cast<const bf16*>(f.w_out), o.dA,
                                   ring, st, r0, R, [] {});
  }
}

template <int BN, bool kBwd, bool kWide>
int launch_lq_bn(const DptAttnParams& f, const bf16* g, const LqOut& o,
                 int tiles, cudaStream_t stream) {
  const size_t smem = lq_smem<BN, kBwd, kWide>(f.B);
  auto kernel = attn_lq_kernel<BN, kBwd, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles, kWgCta, smem, stream>>>(f, g, o);
  return static_cast<int>(cudaGetLastError());
}

// LQ (kBwd) or F1 at its column tile (128 where Bq is a multiple of 128,
// else 64) and its layout (kWide above B = 256).
template <bool kBwd>
int launch_lq(const DptAttnParams& f, const bf16* g, const LqOut& o,
              int tiles, cudaStream_t stream) {
  const bool wide = f.B > kMaxWidth;
  if (f.Bq % 128)
    return wide ? launch_lq_bn<64, kBwd, true>(f, g, o, tiles, stream)
                : launch_lq_bn<64, kBwd, false>(f, g, o, tiles, stream);
  return wide ? launch_lq_bn<128, kBwd, true>(f, g, o, tiles, stream)
              : launch_lq_bn<128, kBwd, false>(f, g, o, tiles, stream);
}

// ---- The core on mma.sync ----

constexpr int kCoreWarpsWg = 4;       // warps of a core CTA, at most
constexpr int kCoreBlock = 256;       // rows of a staged block, at most

// The head widths d the core takes: one 16-deep A fragment step (16) up
// to eight (128). At 16 a row is 32 bytes, two cp.async chunks, and
// core_ld<16>() = 24 keeps each ldmatrix row 16-byte aligned and the 8
// rows of a matrix in distinct banks.
inline bool core_head_width(int d) {
  return d == 16 || d == 32 || d == 64 || d == 128;
}

// One m16n8k16 product, bf16 in, f32 accumulated in c.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. .trans: each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats as the bf16 pair of one fragment register (lo in the low
// half: the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The operand tiles in shared memory are row-major [rows][D + 8] bf16: 16
// bytes of pad put the 8 rows of an ldmatrix in distinct banks.
template <int D>
__host__ __device__ constexpr int core_ld() { return D + 8; }

// The A fragment (16 rows x 16 of depth) at row r0, depth k0 of a tile.
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int k0, int lane) {
  ldsm_x4(a, smem_u32(tile + (r0 + (lane & 15)) * core_ld<D>() + k0 +
                      8 * (lane >> 4)));
}

// B fragments of two 8-column tiles (b[0], b[1] the first, b[2], b[3] the
// second) over depth [k0, k0 + 16): kT false, the tile holds B^T (row =
// column n0 + j, the depth along the row: k, v, q, dA as the right
// operand of a product over d); kT true, it holds B (row = depth, the
// columns n0 .. n0 + 15 along it: v, k, dA, q over keys or queries).
template <int D, bool kT>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int k0, int lane) {
  if constexpr (kT)
    ldsm_x4_t(b, smem_u32(tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                     core_ld<D>() + n0 + 8 * (lane >> 4)));
  else
    ldsm_x4(b, smem_u32(tile + (n0 + (lane & 7) + 8 * (lane >> 4)) *
                                   core_ld<D>() + k0 + 8 * ((lane >> 3) & 1)));
}

// c[j] (16 x 8, j = 0, 1) = own (16 x D, A fragments) @ tile rows
// [r0, r0 + 16)^T: the 16 x 16 products over d (scores, dp and their
// transposes).
template <int D>
__device__ __forceinline__ void mm_rows_t(float (&c)[2][4],
                                          const uint32_t (&own)[D / 16][4],
                                          const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    frag_b<D, false>(b, tile, r0, 16 * kk, lane);
    mma16816(c[0], own[kk], b[0], b[1]);
    mma16816(c[1], own[kk], b[2], b[3]);
  }
}

// acc (16 x D) += w (16 x 16, an A fragment) @ tile rows [r0, r0 + 16)
// (16 x D): the products over keys or queries (a, dq, dv, dk).
template <int D>
__device__ __forceinline__ void mm_acc(float (&acc)[D / 8][4],
                                       const uint32_t (&w)[4],
                                       const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int nn = 0; nn < D / 16; ++nn) {
    uint32_t b[4];
    frag_b<D, true>(b, tile, 16 * nn, r0, lane);
    mma16816(acc[2 * nn], w, b[0], b[1]);
    mma16816(acc[2 * nn + 1], w, b[2], b[3]);
  }
}

// The A fragment of a 16 x 16 accumulator pair c[0], c[1], rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// The row gather of a core CTA's problem (blockIdx.x, blockIdx.y = m):
// intra, the S rows of chunk blockIdx.x; inter, the n chunks' rows at
// position s = blockIdx.x.
template <bool kInter>
struct Gather {
  const DptAttnParams& f;
  __device__ int length() const { return kInter ? f.n : f.S; }
  // the global row of position i of the problem
  __device__ size_t row(int i) const {
    return kInter ? (static_cast<size_t>(blockIdx.y) * f.n + i) * f.S +
                        blockIdx.x
                  : (static_cast<size_t>(blockIdx.y) * f.n + blockIdx.x) *
                            f.S + i;
  }
  __device__ float key_bias(int k) const {
    if (!f.bias) return 0.f;
    return kInter ? f.bias[static_cast<size_t>(k) * f.S + blockIdx.x]
                  : f.bias[static_cast<size_t>(blockIdx.x) * f.S + k];
  }
};

// ---- The core's pieces, shared by the forward core and the backward's ----

// Rows [r0, r0 + rows) of the problem, columns [c1, c1 + D) of s1 (rows of
// ld1) into d1 ([rows][D + 8]), and likewise (s2, c2, ld2) into d2 unless
// d2 is null, by cp.async, by the nt threads from t0; positions at or
// beyond the length as zeros; one commit group.
template <int D, bool kInter>
__device__ __forceinline__ void core_copy_rows(
    const Gather<kInter>& G, bf16* d1, const bf16* s1, int ld1, int c1,
    bf16* d2, const bf16* s2, int ld2, int c2, int r0, int rows, int t0,
    int nt) {
  constexpr int LD = core_ld<D>(), kC = D / 8;   // 16-byte chunks of a row
  const int L = G.length();
  for (int e = t0; e < (d2 ? 2 : 1) * rows * kC; e += nt) {
    const int two = e / (rows * kC), i = (e / kC) % rows, c = 8 * (e % kC);
    const bool ok = r0 + i < L;
    const size_t row = G.row(ok ? r0 + i : 0);
    const bf16* src = two ? s2 + row * ld2 + c2 + c : s1 + row * ld1 + c1 + c;
    cp_async16(smem_u32((two ? d2 : d1) + i * LD + c), src, ok);
  }
  cp_async_commit();
}

// Block b of T rows of the problem (of Lp, the length padded to the 16-row
// tile) of (s1, c1, ld1) and (s2, c2, ld2) into x1, x2, and fill(i,
// position) for each of its rows; every thread calls it, and it ends with
// the block published.
template <int D, bool kInter, class Fill>
__device__ __forceinline__ void core_stage_block(
    const Gather<kInter>& G, int Lp, int T, int b, bf16* x1, const bf16* s1,
    int ld1, int c1, bf16* x2, const bf16* s2, int ld2, int c2, Fill fill) {
  __syncthreads();   // the previous block's readers are done
  const int r0 = b * T, rows = min(T, Lp - r0);
  core_copy_rows<D>(G, x1, s1, ld1, c1, x2, s2, ld2, c2, r0, rows,
                    threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) fill(i, r0 + i);
  cp_async_wait<0>();
  __syncthreads();
}

// The calling warp's accumulated 16 x D rows [r0, r0 + 16), rounded once,
// to columns [col, col + D) of dst (rows of ld); positions beyond the
// length dropped.
template <int D, bool kInter>
__device__ __forceinline__ void core_store_rows(const Gather<kInter>& G,
                                                bf16* dst, int ld, int col,
                                                int r0,
                                                const float (&acc)[D / 8][4],
                                                int lane) {
  const int L = G.length(), g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + g + 8 * half;
    if (i >= L) continue;
    bf16* d = dst + G.row(i) * ld + col + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(d + 8 * nt) =
          pack_bf16(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// The logits of the warp's 16 query rows (A fragments qa) against key tile
// k0 of the staged block (keys, their bias in bias): rows g, g + 8 of the
// tile, key 8 j + 2 t4 + (e & 1) in s[j][e].
template <int D>
__device__ __forceinline__ void core_logits(float (&s)[2][4],
                                            const uint32_t (&qa)[D / 16][4],
                                            const bf16* keys,
                                            const float* bias, int k0,
                                            float scale, int lane) {
  const int t4 = lane & 3;
  mm_rows_t<D>(s, qa, keys, k0, lane);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = s[j][e] * scale + bias[k0 + 8 * j + 2 * t4 + (e & 1)];
}

// Pass 1 of the query side: the row max and denominator of the warp's 16
// query rows, online over the key tiles of every staged block (stage(b)
// stages block b, and every thread of the CTA calls it; an inactive warp
// only stages). On return den and inv hold the whole quad's sums.
template <int D, class Stage>
__device__ __forceinline__ void core_row_stats(
    const uint32_t (&qa)[D / 16][4], bool active, int Lp, int T,
    const bf16* keys, const float* bias, float scale, int lane, Stage stage,
    float (&mx)[2], float (&den)[2], float (&inv)[2]) {
  const int n_blocks = (Lp + T - 1) / T;
  mx[0] = mx[1] = -INFINITY;
  den[0] = den[1] = 0.f;
  for (int b = 0; b < n_blocks; ++b) {
    stage(b);
    if (!active) continue;
    const int rows = min(T, Lp - b * T);
    for (int k0 = 0; k0 < rows; k0 += 16) {
      float s[2][4];
      core_logits<D>(s, qa, keys, bias, k0, scale, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float tm = fmaxf(fmaxf(s[0][2 * half], s[0][2 * half + 1]),
                         fmaxf(s[1][2 * half], s[1][2 * half + 1]));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        const float mn = fmaxf(mx[half], tm);
        float sum = den[half] * __expf(mx[half] - mn);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sum += __expf(s[j][2 * half] - mn) + __expf(s[j][2 * half + 1] - mn);
        den[half] = sum;
        mx[half] = mn;
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    den[half] += __shfl_xor_sync(0xffffffffu, den[half], 1);
    den[half] += __shfl_xor_sync(0xffffffffu, den[half], 2);
    inv[half] = 1.f / den[half];
  }
}

// A pass of the query side over the key tiles of every staged block with
// the rows' stats: p = exp(s - max) / den in f32 for each key tile k0 of
// the staged block, handed to tile(p, k0) (pass 2 of both cores, pass 3 of
// the backward's).
template <int D, class Stage, class Tile>
__device__ __forceinline__ void core_probs_pass(
    const uint32_t (&qa)[D / 16][4], bool active, int Lp, int T,
    const bf16* keys, const float* bias, float scale, int lane, Stage stage,
    const float (&mx)[2], const float (&inv)[2], Tile tile) {
  const int n_blocks = (Lp + T - 1) / T;
  for (int b = 0; b < n_blocks; ++b) {
    stage(b);
    if (!active) continue;
    const int rows = min(T, Lp - b * T);
    for (int k0 = 0; k0 < rows; k0 += 16) {
      float p[2][4];
      core_logits<D>(p, qa, keys, bias, k0, scale, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = __expf(p[j][e] - mx[e >> 1]) * inv[e >> 1];
      tile(p, k0);
    }
  }
}

// Shared memory of a backward core CTA: two staged [T, D + 8] tiles, T * 3
// floats (the keys' bias, or the queries' stats) and each warp's two
// [16, D + 8] tiles of its own rows.
template <int D>
__host__ __device__ constexpr size_t core_wg_smem(int T, int warps) {
  return (2 * static_cast<size_t>(T) + 2 * 16 * warps) * core_ld<D>() *
             sizeof(bf16) +
         static_cast<size_t>(T) * 3 * sizeof(float);
}
static_assert(core_wg_smem<128>(kCoreBlock, kCoreWarpsWg) <= kMaxDynSmem,
              "the backward core's shared memory at d = 128");

// Grid (intra: n, inter: S; M; h), 32 * warps threads; T the staged
// block's rows (a multiple of 16, at most kCoreBlock). Top note.
template <int D, bool kInter>
__global__ void __launch_bounds__(kCoreWarpsWg * 32)
    attn_bwd_core_kernel(DptAttnBwdParams P, float scale, int T) {
  extern __shared__ __align__(128) uint8_t core_smem[];
  constexpr int LD = core_ld<D>();
  const DptAttnParams& f = P.f;
  const Gather<kInter> G{f};
  const int L = G.length(), Lp = (L + 15) & ~15;
  const int Bq = f.Bq, h = f.h, hd = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5, g = lane >> 2, t4 = lane & 3;
  bf16* x1 = reinterpret_cast<bf16*>(core_smem);
  bf16* x2 = x1 + T * LD;
  bf16* own = x2 + T * LD + warp * 2 * 16 * LD;
  float* s_vec = reinterpret_cast<float*>(x1 + (2 * T + 2 * 16 * n_warps) * LD);
  const bf16* qkv = static_cast<const bf16*>(f.qkv);
  const bf16* dA = static_cast<const bf16*>(P.dA);
  bf16* dqkv = static_cast<bf16*>(P.dqkv);
  const int W3 = 3 * Bq, cq = hd * D, ck = Bq + hd * D, cv = 2 * Bq + hd * D;

  // the A fragments of this warp's rows [r0, r0 + 16) of (s1, c1, ld1) and
  // (s2, c2, ld2)
  auto own_frags = [&](uint32_t (&a1)[D / 16][4], uint32_t (&a2)[D / 16][4],
                       const bf16* s1, int ld1, int c1, const bf16* s2,
                       int ld2, int c2, int r0) {
    __syncwarp();   // the previous tile's fragments are read
    core_copy_rows<D>(G, own, s1, ld1, c1, own + 16 * LD, s2, ld2, c2, r0,
                      16, lane, 32);
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      frag_a<D>(a1[kk], own, 0, 16 * kk, lane);
      frag_a<D>(a2[kk], own + 16 * LD, 0, 16 * kk, lane);
    }
  };
  const int n_tiles = Lp / 16, n_blocks = (Lp + T - 1) / T;
  int staged = -1;   // the block in shared memory (uniform over the CTA)
  // the keys' bias, -inf beyond L
  auto key_fill = [&](int i, int k) {
    s_vec[i] = k < L ? G.key_bias(k) : -INFINITY;
  };
  auto stage_keys = [&](int b) {
    if (staged == b) return;
    core_stage_block<D>(G, Lp, T, b, x1, qkv, W3, ck, x2, qkv, W3, cv,
                        key_fill);
    staged = b;
  };

  // ---- query side: a warp per 16 query rows ----
  for (int rnd = 0; rnd < n_tiles; rnd += n_warps) {
    const int q0 = (rnd + warp) * 16;
    const bool active = rnd + warp < n_tiles;
    uint32_t qa[D / 16][4], da[D / 16][4];
    if (active) own_frags(qa, da, qkv, W3, cq, dA, Bq, hd * D, q0);
    // pass 1: the row max and denominator
    float mx[2], den[2], inv[2];
    core_row_stats<D>(qa, active, Lp, T, x1, s_vec, scale, lane, stage_keys,
                      mx, den, inv);
    // pass 2: a = round(round(p) v), rowsum = sum p dp
    float acc[D / 8][4], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    core_probs_pass<D>(qa, active, Lp, T, x1, s_vec, scale, lane, stage_keys,
                       mx, inv, [&](float (&p)[2][4], int k0) {
      float dp[2][4];
      uint32_t pa[4];
      acc_to_a(pa, p);
      mm_acc<D>(acc, pa, x2, k0, lane);
      mm_rows_t<D>(dp, da, x2, k0, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rsum[e >> 1] += p[j][e] * dp[j][e];
    });
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rsum[half] += __shfl_xor_sync(0xffffffffu, rsum[half], 1);
      rsum[half] += __shfl_xor_sync(0xffffffffu, rsum[half], 2);
    }
    if (active) {
      core_store_rows<D>(G, static_cast<bf16*>(f.a), Bq, hd * D, q0, acc,
                         lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = q0 + g + 8 * half;
        if (t4 != 0 || i >= L) continue;
        float* st = P.stats + (G.row(i) * h + hd) * kNumRowStats;
        st[0] = mx[half];
        st[1] = den[half];
        st[2] = rsum[half];
      }
    }
    // pass 3: ds = round(p (dp - rowsum) scale), dq = round(ds k)
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    core_probs_pass<D>(qa, active, Lp, T, x1, s_vec, scale, lane, stage_keys,
                       mx, inv, [&](float (&p)[2][4], int k0) {
      float dp[2][4];
      mm_rows_t<D>(dp, da, x2, k0, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = p[j][e] * (dp[j][e] - rsum[e >> 1]) * scale;
      uint32_t dsa[4];
      acc_to_a(dsa, p);
      mm_acc<D>(acc, dsa, x1, k0, lane);
    });
    if (active) core_store_rows<D>(G, dqkv, W3, cq, q0, acc, lane);
  }

  // ---- key side: a warp per 16 key rows ----
  staged = -1;   // the first staging barrier also publishes the stats above
  // the queries' (max, 1 / denominator, rowsum); +inf, 0, 0 beyond L
  auto stat_fill = [&](int i, int q) {
    float m = INFINITY, iv = 0.f, rs = 0.f;
    if (q < L) {
      const float* st = P.stats + (G.row(q) * h + hd) * kNumRowStats;
      m = st[0];
      iv = 1.f / st[1];
      rs = st[2];
    }
    s_vec[3 * i] = m;
    s_vec[3 * i + 1] = iv;
    s_vec[3 * i + 2] = rs;
  };
  auto stage_queries = [&](int b) {
    if (staged == b) return;
    core_stage_block<D>(G, Lp, T, b, x1, qkv, W3, cq, x2, dA, Bq, hd * D,
                        stat_fill);
    staged = b;
  };
  for (int rnd = 0; rnd < n_tiles; rnd += n_warps) {
    const int k0 = (rnd + warp) * 16;
    const bool active = rnd + warp < n_tiles;
    // one walk over the queries accumulating dv (with_dv) and dk (with_dk)
    auto key_pass = [&](auto with_dv, auto with_dk) {
      constexpr bool kDv = decltype(with_dv)::value;
      constexpr bool kDk = decltype(with_dk)::value;
      uint32_t ka[D / 16][4], va[D / 16][4];
      float kb[2] = {0.f, 0.f};
      if (active) {
        own_frags(ka, va, qkv, W3, ck, qkv, W3, cv, k0);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = k0 + g + 8 * half;
          kb[half] = k < L ? G.key_bias(k) : 0.f;
        }
      }
      float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
      for (int b = 0; b < n_blocks; ++b) {
        stage_queries(b);
        if (!active) continue;
        const int rows = min(T, Lp - b * T);
        for (int q0 = 0; q0 < rows; q0 += 16) {
          float p[2][4], dp[2][4];
          mm_rows_t<D>(p, ka, x1, q0, lane);    // s^T: keys x queries
          if constexpr (kDk) mm_rows_t<D>(dp, va, x2, q0, lane);   // dp^T
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float* st = s_vec + 3 * (q0 + 8 * j + 2 * t4 + (e & 1));
              const float pv =
                  __expf(p[j][e] * scale + kb[e >> 1] - st[0]) * st[1];
              p[j][e] = pv;
              if constexpr (kDk) dp[j][e] = pv * (dp[j][e] - st[2]) * scale;
            }
          if constexpr (kDv) {
            uint32_t pa[4];
            acc_to_a(pa, p);
            mm_acc<D>(dv, pa, x2, q0, lane);
          }
          if constexpr (kDk) {
            uint32_t dsa[4];
            acc_to_a(dsa, dp);
            mm_acc<D>(dk, dsa, x1, q0, lane);
          }
        }
      }
      if (active) {
        if constexpr (kDk) core_store_rows<D>(G, dqkv, W3, ck, k0, dk, lane);
        if constexpr (kDv) core_store_rows<D>(G, dqkv, W3, cv, k0, dv, lane);
      }
    };
    using Yes = std::true_type;
    using No = std::false_type;
    if constexpr (D == 128) {
      // the k and v fragments and both 16 x 128 accumulators spill (ptxas,
      // sm_90a): dv and dk in a walk each, p rebuilt in both, the same
      // arithmetic in the same order
      key_pass(Yes{}, No{});
      key_pass(No{}, Yes{});
    } else {
      key_pass(Yes{}, Yes{});
    }
  }
}

// The staged block's rows and the CTA's warps for a problem of length L:
// the length padded to the 16-row tile, at most kCoreBlock; one warp per
// 16-row tile, at most kCoreWarpsWg.
inline void core_shape(int L, int* T, int* warps) {
  const int Lp = (L + 15) & ~15;
  *T = Lp < kCoreBlock ? Lp : kCoreBlock;
  *warps = Lp / 16 < kCoreWarpsWg ? Lp / 16 : kCoreWarpsWg;
}

template <int D, bool kInter>
int launch_core_wg(const DptAttnBwdParams& P, cudaStream_t stream,
                   float scale) {
  int T, warps;
  core_shape(kInter ? P.f.n : P.f.S, &T, &warps);
  const size_t smem = core_wg_smem<D>(T, warps);
  auto kernel = attn_bwd_core_kernel<D, kInter>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(kInter ? P.f.S : P.f.n, P.f.M, P.f.h), 32 * warps, smem,
           stream>>>(P, scale, T);
  return static_cast<int>(cudaGetLastError());
}

// ---- The forward core: the query side's passes 1 and 2 alone ----

// Shared memory of a forward core CTA: the staged keys' k and v [T, D + 8],
// each warp's [16, D + 8] tile of its q rows, and the keys' bias.
template <int D>
__host__ __device__ constexpr size_t core_fwd_smem(int T, int warps) {
  return (2 * static_cast<size_t>(T) + 16 * warps) * core_ld<D>() *
             sizeof(bf16) +
         static_cast<size_t>(T) * sizeof(float);
}
static_assert(core_fwd_smem<128>(kCoreBlock, kCoreWarpsWg) <= kMaxDynSmem,
              "the forward core's shared memory at d = 128");

// a = round(round(softmax(q k^T scale + bias)) v) for one problem (grid
// (intra: n, inter: S; M; h), 32 * warps threads): a warp per 16 query
// rows, its q fragments in registers; pass 1 the row max and denominator
// (online), pass 2 p = exp(s - max) / den, rounded, and a in f32 on
// mma.sync, over key tiles of 16 of blocks of up to T keys staged in
// shared memory (keys beyond L: zero rows with bias -inf, p exactly 0).
template <int D, bool kInter>
__global__ void __launch_bounds__(kCoreWarpsWg * 32)
    attn_fwd_core_kernel(DptAttnParams f, float scale, int T) {
  extern __shared__ __align__(128) uint8_t core_smem[];
  constexpr int LD = core_ld<D>();
  const Gather<kInter> G{f};
  const int L = G.length(), Lp = (L + 15) & ~15;
  const int Bq = f.Bq, hd = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  bf16* ks = reinterpret_cast<bf16*>(core_smem);
  bf16* vs = ks + T * LD;
  bf16* own = vs + T * LD + warp * 16 * LD;
  float* bias = reinterpret_cast<float*>(ks + (2 * T + 16 * n_warps) * LD);
  const bf16* qkv = static_cast<const bf16*>(f.qkv);
  const int W3 = 3 * Bq;
  const int n_tiles = Lp / 16;
  int staged = -1;   // the block in shared memory (uniform over the CTA)
  auto stage_keys = [&](int b) {
    if (staged == b) return;
    core_stage_block<D>(G, Lp, T, b, ks, qkv, W3, Bq + hd * D, vs, qkv, W3,
                        2 * Bq + hd * D, [&](int i, int k) {
                          bias[i] = k < L ? G.key_bias(k) : -INFINITY;
                        });
    staged = b;
  };
  for (int rnd = 0; rnd < n_tiles; rnd += n_warps) {
    const int q0 = (rnd + warp) * 16;
    const bool active = rnd + warp < n_tiles;
    uint32_t qa[D / 16][4];
    if (active) {
      __syncwarp();   // the previous tile's fragments are read
      core_copy_rows<D>(G, own, qkv, W3, hd * D, nullptr, nullptr, 0, 0, q0,
                        16, lane, 32);
      cp_async_wait<0>();
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) frag_a<D>(qa[kk], own, 0, 16 * kk, lane);
    }
    float mx[2], den[2], inv[2];
    core_row_stats<D>(qa, active, Lp, T, ks, bias, scale, lane, stage_keys,
                      mx, den, inv);
    float acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    core_probs_pass<D>(qa, active, Lp, T, ks, bias, scale, lane, stage_keys,
                       mx, inv, [&](float (&p)[2][4], int k0) {
      uint32_t pa[4];
      acc_to_a(pa, p);
      mm_acc<D>(acc, pa, vs, k0, lane);
    });
    if (active)
      core_store_rows<D>(G, static_cast<bf16*>(f.a), Bq, hd * D, q0, acc,
                         lane);
  }
}

template <int D, bool kInter>
int launch_fwd_core(const DptAttnParams& f, cudaStream_t stream,
                    float scale) {
  int T, warps;
  core_shape(kInter ? f.n : f.S, &T, &warps);
  const size_t smem = core_fwd_smem<D>(T, warps);
  auto kernel = attn_fwd_core_kernel<D, kInter>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(kInter ? f.S : f.n, f.M, f.h), 32 * warps, smem, stream>>>(
      f, scale, T);
  return static_cast<int>(cudaGetLastError());
}

// ---- The frame ----

// The bf16 workspace: qkv [R, 3Bq], a [R, Bq], y [R, B], dA [R, Bq], dqkv
// [R, 3Bq] and, above kWideMax only, W_out^T [B, Bq] in bf16; in f32 each
// row's (mean, rs), the core's stats [R, h, kNumRowStats], the chunk
// partials of dW_qkv and dW_out, DN's tile partials of (dgamma, dbeta)
// (128-row tiles; above B = 256 ln_bwd_kernel's 64-row ones, ln_tiles of
// them) and, above 256 only, dy [R, B]; each segment on a 256-byte
// boundary.
struct AttnWgLayout {
  size_t act[6];
  size_t f32[6];
  size_t n_act, n_f32;
  int chunks_qkv, chunks_out, tiles, ln_tiles;
};

AttnWgLayout attn_wg_layout(long long R, int B, int h, int Bq) {
  AttnWgLayout L;
  const bool wide = B > kMaxWidth;
  L.chunks_qkv = wg_wgrad_chunks(R, B, 3 * Bq);
  L.chunks_out = wg_wgrad_chunks(R, Bq, B);
  L.tiles = static_cast<int>((R + kWgRows - 1) / kWgRows);
  L.ln_tiles = wide ? n_row_tiles(R) : L.tiles;
  const size_t rq = static_cast<size_t>(R) * Bq;
  const size_t bq = static_cast<size_t>(B) * Bq;
  const size_t act[6] = {3 * rq, rq, static_cast<size_t>(R) * B, rq, 3 * rq,
                         B > kWideMax ? bq : 0};
  const size_t f32[6] = {2 * static_cast<size_t>(R),
                         static_cast<size_t>(R) * h * kNumRowStats,
                         L.chunks_qkv * 3 * bq, L.chunks_out * bq,
                         static_cast<size_t>(L.ln_tiles) * 2 * B,
                         wide ? static_cast<size_t>(R) * B : 0};
  size_t off = 0;
  for (int i = 0; i < 6; ++i) {
    L.act[i] = off;
    off += align_elems(act[i], 128);
  }
  L.n_act = off;
  off = 0;
  for (int i = 0; i < 6; ++i) {
    L.f32[i] = off;
    off += align_elems(f32[i], 64);
  }
  L.n_f32 = off;
  return L;
}

// The bf16 attention backward (top note): LQ, C (core(P, stream)), W (two
// launches), DN, S; above B = 256 LQ's wide layout and DN's wide route
// (launch_dy_ln_wide: dy through device memory, ln_bwd_kernel), the rest
// as at 256; above kWideMax LQ streamed (four launches) and DN's rows on
// ln_bwd_wide_kernel. Returns the first CUDA error.
template <typename Core>
int launch_attention_bwd_wg(DptAttnBwdParams P, void* ws_act, float* ws_f32,
                            cudaStream_t stream, Core core) {
  DptAttnParams& f = P.f;
  const int R = static_cast<int>(f.R), B = f.B, Bq = f.Bq;
  if (B % kSlabK || Bq % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttnWgLayout L = attn_wg_layout(f.R, B, f.h, Bq);
  bf16* act = static_cast<bf16*>(ws_act);
  LqOut o;
  o.qkv = act + L.act[0];
  o.dA = act + L.act[3];
  o.y = act + L.act[2];
  o.lnstat = ws_f32 + L.f32[0];
  f.qkv = o.qkv;
  f.a = act + L.act[1];
  P.dA = o.dA;
  P.dqkv = act + L.act[4];
  P.stats = ws_f32 + L.f32[1];
  float* part_qkv = ws_f32 + L.f32[2];
  float* part_out = ws_f32 + L.f32[3];
  float* lnpart = ws_f32 + L.f32[4];
  const bf16* g = static_cast<const bf16*>(P.g);
  if (B > kWideMax) {   // LQ streamed: y, qkv, W_out^T, dA
    bf16* w_out_t = act + L.act[5];
    CTN_RETURN_IF(launch_qkv_streamed(f, o.y, stream));
    CTN_RETURN_IF(launch_transpose<bf16>(f.w_out, w_out_t, Bq, B, stream));
    RowsWgParams q;
    q.a = g;
    q.w = w_out_t;
    q.res = nullptr;
    q.out = o.dA;
    q.R = R;
    q.N = Bq;
    q.depth = B;
    CTN_RETURN_IF(launch_rows_wg(q, AttnOutEpi{}, stream));
  } else {
    CTN_RETURN_IF(launch_lq<true>(f, g, o, L.tiles, stream));
  }
  CTN_RETURN_IF(core(P, stream));
  CTN_RETURN_IF(launch_wgrad_parts_wg(o.y, P.dqkv, R, B, 3 * Bq, part_qkv,
                                      stream));
  CTN_RETURN_IF(launch_wgrad_parts_wg(f.a, g, R, Bq, B, part_out, stream));
  DyLnParams q;
  q.a = static_cast<const bf16*>(P.dqkv);
  q.w = static_cast<const bf16*>(f.w_qkv);
  q.x = static_cast<const bf16*>(f.x);
  q.g = g;
  q.gamma = f.gamma;
  q.lnstat = o.lnstat;
  q.dx = static_cast<bf16*>(P.dx);
  q.part = lnpart;
  q.R = R;
  q.B = B;
  q.Bn = f.Bn;
  q.depth = 3 * Bq;
  CTN_RETURN_IF(B > kMaxWidth
                    ? launch_dy_ln_wide(q, ws_f32 + L.f32[5], !f.partial, stream)
                    : launch_dy_ln_wg(q, !f.partial, stream));
  const ReduceJob jobs[3] = {
      {part_qkv, L.chunks_qkv, 3 * B * Bq, P.dw_qkv},
      {part_out, L.chunks_out, B * Bq, P.dw_out},
      {lnpart, L.ln_tiles, 2 * B, P.dgb}};
  return launch_reduce_jobs(jobs, 3, stream);
}

// The core for the padded head width D = Bq / h (core_head_width), with
// the real width's softmax scale.
template <bool kInter>
int launch_core_wg_d(const DptAttnBwdParams& P, cudaStream_t stream,
                     float scale) {
  switch (P.f.Bq / P.f.h) {
    case 16: return launch_core_wg<16, kInter>(P, stream, scale);
    case 32: return launch_core_wg<32, kInter>(P, stream, scale);
    case 64: return launch_core_wg<64, kInter>(P, stream, scale);
    case 128: return launch_core_wg<128, kInter>(P, stream, scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- The forward's frame (F1, the core, out) ----

// The bf16 attention forward: F1 (LQ without its dA product, y and
// statistics: qkv = round(LN(x) @ W_qkv) into f.qkv), the core
// (core(f, stream): a into f.a) and out (x + round(a @ W_out), or the
// product alone in partial mode, on rows_wg_kernel with AttnOutEpi: one
// column tile as wide as the row up to B = 256, 256 at B = 192; 256-column
// tiles above). Above kWideMax F1 is streamed (launch_qkv_streamed), its y
// in f.out, which out overwrites. B and Bq multiples of 64. Returns the
// first CUDA error.
template <typename Core>
int launch_attention_fwd_wg(const DptAttnParams& f, cudaStream_t stream,
                            Core core) {
  const int B = f.B, Bq = f.Bq;
  if (B % kSlabK || Bq % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > kWideMax) {
    CTN_RETURN_IF(launch_qkv_streamed(f, static_cast<bf16*>(f.out), stream));
  } else {
    const int tiles = static_cast<int>((f.R + kWgRows - 1) / kWgRows);
    LqOut o = {static_cast<bf16*>(f.qkv), nullptr, nullptr, nullptr};
    CTN_RETURN_IF(launch_lq<false>(f, nullptr, o, tiles, stream));
  }
  CTN_RETURN_IF(core(f, stream));
  RowsWgParams q;
  q.a = static_cast<const bf16*>(f.a);
  q.w = static_cast<const bf16*>(f.w_out);
  q.res = f.partial ? nullptr : static_cast<const bf16*>(f.x);
  q.out = static_cast<bf16*>(f.out);
  q.R = static_cast<int>(f.R);
  q.N = B;
  q.depth = Bq;
  return launch_rows_wg(q, AttnOutEpi{}, stream);
}

// The forward core for the padded head width D = Bq / h
// (core_head_width), with the real width's softmax scale.
template <bool kInter>
int launch_fwd_core_d(const DptAttnParams& f, cudaStream_t stream,
                      float scale) {
  switch (f.Bq / f.h) {
    case 16: return launch_fwd_core<16, kInter>(f, stream, scale);
    case 32: return launch_fwd_core<32, kInter>(f, stream, scale);
    case 64: return launch_fwd_core<64, kInter>(f, stream, scale);
    case 128: return launch_fwd_core<128, kInter>(f, stream, scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
