// Stage 2 of a TCN block under tensor (channel) parallelism, one shard of
// the hidden width, for Hopper (sm_90a), bf16 or f32, gLN: kernel B6.
//
// Replaces convtasnet_tpu/ops/pallas/tcn_block_tp.py::_tp2_kernel (wrapper
// fused_tp_stage2). A shard holds Hs = H / m of the block's hidden
// channels. Stage 1 (plain ops in the caller) gave h = PReLU(x @ W_in_s)
// and the caller summed the gLN-1 partials over the shards into the
// sample's statistics (mean1, rs1). Stage 2 is the rest of the shard's
// block:
//
//   hn  = (h - mean1) rs1 g1 + b1                       f32, not rounded
//   y   = PReLU_a2(dilated depthwise conv of hn)        f32, dw [P, Hs]
//   sums = (sum y, sum y^2) per sample                  f32 partials
//   z   = round(round(y g2) @ W_out_s)                  [M, K, B]
//
// gLN-2 is linear in y given its statistics, so the shard's partial out
// product needs none: the caller sums z, the sums and g2 @ W_out, b2 @ W_out
// over the shards and folds the statistics in afterwards
// (ops/cuda/tcn_block_tp.py::tp_epilogue). As in the Pallas kernel, a tap
// outside [0, K) contributes nothing, its share of the b1 shift included:
// zero padding of the normalised input (the Pallas kernel's halo of
// c = -b/s). As in JAX, y g2 is rounded to the compute dtype before the
// product; g2 is not folded into W_out as B1's W_eff is.
//
// What bounds it on the card. At the paper shape (M=8, K=3199, B=256) with
// two shards (Hs=256) a call reads h (13.1 MB in bf16) and writes z (13.1
// MB): 7.8 us at 3.35 TB/s, where the product is 3.35 GFLOP (3.4 us at 989
// TFLOP/s): bytes-bound in bf16. In f32 h and z are 52.4 MB (15.6 us) and
// the product at the 3xTF32 rate (165 TFLOP/s) 20.3 us: operations-bound.
// Four shards (Hs=128) read half of h. The Pallas kernel keeps a sample's
// whole [K, Hs] h in VMEM; here each design builds y from h in device
// memory, a tile at a time. Its partial sums land in one slot per tile; a
// last launch (tp_sums_kernel) sums them in a fixed order in double, so
// there are no atomics and a rerun gives the same bits.
//
// f32, at every shard width: four launches on the f32 stages' 3xTF32 core
// (hopper_gemm_tf32.cuh, tcn_block_tf32.cuh), one design for every padded
// Hs, so that a shard padded with zero channels gives the narrow shard's z
// bit for bit (a zero depth column adds exact zeros to a 3xTF32 product):
//   1. prep_tf32_kernel (the f32 stages' prep, its job 0 alone): W_out_s
//      [Hs, B] as the K-major right operand W_out_s^T [B, Hs], a tf32 hi
//      and a lo copy (split_tf32);
//   2. the depthwise stage: y = PReLU_a2(dwconv(gLN-1(h))) in f32, gLN-1's
//      scale and shift applied per element inside the taps, the taps in the
//      order q = 0..P-1, a tap outside [0, K) adding nothing (its share of
//      the b1 shift included); y g2 in f32 to a workspace [M, K, Hs] and each
//      tile's f32 (sum y, sum y^2) into its slot of `part`. Where
//      dw_layout_ok(Hs) (Hs / 8 divides 256) it is tp_dw_tf32_kernel, on
//      the f32 stages' vectorised walk (dw_rows_f32: 8 channels a thread,
//      one CTA per 128-row tile); at the other padded widths (192, 320, 448,
//      576, 768, ...) tp_wide_dw_kernel, one channel per thread over a
//      (64-row, 64-channel) tile. Both evaluate each element by the same
//      expressions in the same order, so y g2 has the same bits on either;
//   3. tp_out_tf32_kernel: z = (y g2) @ W_out_s on rows_tf32_run, the TMA
//      ring of B1's launch C' (32-deep slabs of y g2 and of the split
//      weight), 64 columns a tile and 3 slabs deep, so that two CTAs share
//      an SM, with a plain epilogue: z = acc, rows at or beyond K not
//      stored;
//   4. tp_sums_kernel, in its fixed order.
// y g2 makes a round trip through device memory (26 MB each way at the
// paper shape, Hs 256): the f32 tile a resident design would keep is 128
// KB at Hs 256 and 256 KB at Hs 512, past a CTA's 227 KB once a ring sits
// beside it, and the core's TF32 left operand comes through TMA from
// device memory anyway, as C' streams y.
//
// bf16 at the Hopper widths (wg_widths_ok: Hs in {64, 128, 256, 512}, B a
// multiple of 64 up to 512): one launch of B1's stage C' with a plainer
// epilogue (tp_stage2_wg_kernel). A CTA of two warpgroups takes 128 rows
// of one sample; the depthwise walk of tcn_block_hopper.cuh (dw_rows:
// 16-byte loads of h rows [r0 - left, r0 + 128 + right), gLN-1's scale and
// shift applied per element inside the taps, a tap outside [0, K) skipped)
// gives y, whose f32 sums it takes in the same pass and whose round(y g2)
// it writes into the resident K-major operand; W_out_s [Hs, B] streams
// MN-major through the cp.async ring (ring_run) into wgmma, 64 columns at a
// time, and z = round(acc) leaves through the stage tile in 16-byte rows:
// no residual, no W_eff and no gLN-2 fold. At Hs <= 256 the shared memory
// (y 64 KB at Hs 256, a 3-slab ring of 24 KB, the 18 KB stage) lets two
// CTAs share an SM, so the paper shape's 200 tiles run in one wave.
//
// bf16 at other widths up to 512: the first design, one CTA per (64-row
// tile, sample) that builds its [64, Hs] tile of y one channel per thread
// (gemm_tile's resident operand, 32 KB at Hs=256) and runs B1's 64x64 WMMA
// tile over W_out_s without cp.async or wgmma; 400 CTAs at the paper shape.
//
// bf16 shards wider than 512 (the padded Hs alone chooses it): the wide
// route, beside the resident tiles, which no longer fit. It sends y through
// device memory in three launches:
//   1. tp_wide_dw_kernel (f32's depthwise stage at widths off
//      dw_layout_ok), writing round(y g2) [M, K, Hs] to a workspace;
//   2. tp_wide_out_kernel: z = round(round(y g2) @ W_out_s), gemm_tile
//      streaming the workspace from device memory over the whole depth
//      (WMMA), one CTA per 64x64 tile of z;
//   3. tp_sums_kernel, in its fixed order.
// The elements of y g2 are computed by the same expressions as the first
// design's, and gemm_tile reads a tile from device memory into the same
// fragments in the same order as a resident one, so where both routes see
// the same y g2 they give the same z bits: a shard padded with zero
// channels (no taps, no gLN-1 affine) gives the z of the narrower shard.
// Bytes at [8, 3199, 1024], B = 256: h 52.4 MB read, the workspace 52.4 MB
// written and read back, z 13.1 MB written; the bound (h and z once) is
// 0.0197 ms, from bytes.

#include "tcn_block_common.cuh"
#include "tcn_block_tf32.cuh"

namespace {

struct TpParams {
  const void* h;        // [M, K, Hs] compute dtype
  const float* stats1;  // [M, 2]: mean1, rs1 of the whole hidden width
  const void* dw;       // [P, Hs] compute dtype
  const void* w_out;    // [Hs, B] compute dtype
  const float* a2;      // the second PReLU slope
  const float* g1;      // [Hs] gLN-1 scale and shift, gLN-2 scale
  const float* b1;
  const float* g2;
  void* z;              // [M, K, B] compute dtype
  float* part;          // [M, n_tiles, 2] per-tile (sum y, sum y^2)
  float* sums;          // [M, 2]
  int M, K, Hs, B, P, dilation, left;
};

template <typename T>
constexpr size_t tp_smem(int Hs) {
  return static_cast<size_t>(kBM) * res_ld<T>(Hs) * sizeof(T);
}

// The first design (top note), bf16 at widths off wg_widths_ok up to 512.
// Grid (ceil(K/kBM), M), kGemmThreads threads; Hs % kBN == 0, B % kBN == 0.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads) tp_stage2_kernel(TpParams p) {
  using S = GemmSmem<T>;
  __shared__ S s;
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  T* yg = reinterpret_cast<T*>(dyn_smem);   // round(y g2), [kBM, ld]
  const int ld = res_ld<T>(p.Hs);
  const int m = blockIdx.y;
  const int r0 = blockIdx.x * kBM;
  const int K = p.K, Hs = p.Hs, P = p.P, d = p.dilation;
  const T* h = static_cast<const T*>(p.h) + static_cast<size_t>(m) * K * Hs;
  const T* dw = static_cast<const T*>(p.dw);
  const float mean1 = p.stats1[2 * m];
  const float rs1 = p.stats1[2 * m + 1];
  const float a2 = *p.a2;

  // y for this tile's rows, one channel per thread at a time; rows at or
  // beyond K are zeros here and add nothing to the sums
  float t1 = 0.f, t2 = 0.f;
  for (int c = threadIdx.x; c < Hs; c += kGemmThreads) {
    const float sc = rs1 * p.g1[c];
    const float sh = p.b1[c] - mean1 * sc;
    const float g2 = p.g2[c];
    for (int i = 0; i < kBM; ++i) {
      const int k = r0 + i;
      float v = 0.f;
      if (k < K) {
        float acc = 0.f;
        for (int q = 0; q < P; ++q) {
          const int kk = k + q * d - p.left;
          if (kk < 0 || kk >= K) continue;  // zero padding after gLN-1
          const float hv = to_f<T>(h[static_cast<size_t>(kk) * Hs + c]);
          acc = fmaf(to_f<T>(dw[q * Hs + c]), hv * sc + sh, acc);
        }
        v = prelu(acc, a2);
      }
      t1 += v;
      t2 += v * v;
      yg[i * ld + c] = from_f<T>(v * g2);
    }
  }
  block_sum2(t1, t2);   // its barriers also complete yg
  if (threadIdx.x == 0) {
    float* dst =
        p.part + 2 * (static_cast<size_t>(m) * gridDim.x + blockIdx.x);
    dst[0] = t1;
    dst[1] = t2;
  }
  __syncthreads();

  T* z = static_cast<T*>(p.z) + static_cast<size_t>(m) * K * p.B;
  for (int n0 = 0; n0 < p.B; n0 += kBN) {
    gemm_tile<T, true>(yg, static_cast<const T*>(p.w_out), 0, Hs, p.B, 0, n0,
                       s, ld);
    for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
      const int r = e / kBN;
      const int c = e % kBN;
      if (r0 + r < K)
        z[static_cast<size_t>(r0 + r) * p.B + n0 + c] =
            from_f<T>(s.c[r * S::kLdC + c]);
    }
    __syncthreads();   // s.c is read before the next product writes it
  }
}

// sums[m] = the sample's n_tiles partials added in order of tile, in
// double. Grid (M), 256 threads.
__global__ void tp_sums_kernel(const float* __restrict__ part, int n_tiles,
                               float* __restrict__ sums) {
  const int m = blockIdx.x;
  const float* pm = part + 2 * static_cast<size_t>(m) * n_tiles;
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    s1 += pm[2 * i];
    s2 += pm[2 * i + 1];
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    sums[2 * m] = static_cast<float>(s1);
    sums[2 * m + 1] = static_cast<float>(s2);
  }
}

constexpr int kTpStages = 3;   // the wgmma stage's ring depth
constexpr int kTpBN = 64;      // its column tile

// The wgmma stage's shared memory: y, the ring and the stage tile.
inline size_t tp_wg_smem(int Hs) {
  return 1024 + static_cast<size_t>(Hs / kSlabK) * kWgRows * kLine +
         static_cast<size_t>(kTpStages) * kTpBN * kLine + stage_bytes<kTpBN>();
}

// bf16 stage 2 on the wgmma core (top note): for rows [r0, r0 + 128) of
// sample blockIdx.y, y = PReLU_a2(dwconv(gLN-1(h))) by the depthwise walk,
// its f32 (sum, sum of squares) into part[m * gridDim.x + blockIdx.x], and
// round(y g2) into the resident K-major operand (rows at or beyond K as
// zeros); then z = round(round(y g2) @ W_out_s). Grid (ceil(K / 128), M),
// block 256; wg_widths_ok(B, Hs).
__global__ void __launch_bounds__(kWgCta, 2) tp_stage2_wg_kernel(TpParams p) {
  extern __shared__ uint8_t wg_smem[];
  const int K = p.K, Hs = p.Hs, B = p.B, CG = Hs / 8;
  const int nk = Hs / kSlabK, n_tiles = B / kTpBN;
  const uint32_t ys = align_1024(wg_smem);
  const uint32_t ring = ys + nk * kWgRows * kLine;
  uint8_t* y_gen = smem_ptr(wg_smem, ys);
  bf16* st = reinterpret_cast<bf16*>(
      smem_ptr(wg_smem, ring + kTpStages * kTpBN * kLine));
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  const bf16* w_out = static_cast<const bf16*>(p.w_out);
  bf16* z = static_cast<bf16*>(p.z) + static_cast<size_t>(m) * K * B;
  float s1 = 0.f, s2 = 0.f;

  auto compute_y = [&] {
    const int cg = tid % CG, rg = tid / CG, c0 = 8 * cg;
    const float mean1 = p.stats1[2 * m], rs1 = p.stats1[2 * m + 1];
    float g[8], b[8], sc[8], sh[8], g2[8];
    load8(p.g1 + c0, g);
    load8(p.b1 + c0, b);
    load8(p.g2 + c0, g2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = rs1 * g[j];
      sh[j] = b[j] - mean1 * sc[j];
    }
    const float a2 = *p.a2;
    dw_rows<false, 4>(
        static_cast<const bf16*>(p.h) + static_cast<size_t>(m) * K * Hs,
        static_cast<const bf16*>(p.dw), K, Hs, p.P, p.dilation, p.left, r0,
        cg, rg, kWgCta / CG, 0.f, false, g, b, sc, sh,
        [](int, float&, float&) {},
        [&](int rl, int, const float (&acc)[8]) {
          float yg[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float v = prelu(acc[j], a2);   // 0 for rows at or beyond K
            s1 += v;
            s2 += v * v;
            yg[j] = v * g2[j];
          }
          *reinterpret_cast<uint4*>(y_gen + (cg >> 3) * kWgRows * kLine +
                                    swz(rl, cg & 7)) = pack8(yg);
        });
    // the ring's next barrier publishes the operand
  };

  float acc[kTpBN / 2];
  ring_run<kTpStages>(
      n_tiles * nk, ring, kTpBN * kLine,
      [&](int i, uint32_t slot) {
        load_mn_slab(slot, w_out, B, (i % nk) * kSlabK, Hs, (i / nk) * kTpBN,
                     kTpBN, B, tid, kWgCta);
      },
      compute_y,
      [&](int i, uint32_t slot) {
        const int s = i % nk;
        mma_begin(acc);
        mma_slab<kTpBN, false, true>(
            acc, ys + s * kWgRows * kLine + wg * 64 * kLine, slot, s > 0);
        mma_end(acc);
        if (s != nk - 1) return;
        stage_acc<kTpBN>(st, wg, t, acc);
        __syncthreads();
        stage_store<kTpBN>(st, z, B, r0, K, (i / nk) * kTpBN, tid);
        // the ring's next barrier comes before the stage is written again
      });
  block_sum2(s1, s2);
  if (tid == 0) {
    float* dst = p.part + 2 * (static_cast<size_t>(m) * gridDim.x + blockIdx.x);
    dst[0] = s1;
    dst[1] = s2;
  }
}

// The bf16 wide route (top note): Hs above this runs through device memory.
constexpr int kTpResidentWidth = 512;
constexpr int kTpWideThreads = 256;   // 64 channels x 4 groups of 16 rows
constexpr int kTpWideRows = kBM / (kTpWideThreads / kBN);

// Launch 1 of the bf16 wide route and the f32 depthwise stage at widths off
// dw_layout_ok: for rows [r0, r0 + 64) and channels [c0, c0 + 64) of sample
// blockIdx.z, y = PReLU_a2(dwconv(gLN-1(h))) as the first design computes
// it, round(y g2) into yw [M, K, Hs] (rows < K only) and the tile's f32 (sum
// y, sum y^2) into part[(m * gridDim.x + blockIdx.x) * gridDim.y +
// blockIdx.y]. Grid (ceil(K / 64), Hs / 64, M), kTpWideThreads.
template <typename T>
__global__ void __launch_bounds__(kTpWideThreads)
    tp_wide_dw_kernel(TpParams p, T* __restrict__ yw) {
  const int m = blockIdx.z;
  const int c = blockIdx.y * kBN + threadIdx.x % kBN;
  const int i0 = blockIdx.x * kBM + (threadIdx.x / kBN) * kTpWideRows;
  const int K = p.K, Hs = p.Hs, P = p.P, d = p.dilation;
  const T* h = static_cast<const T*>(p.h) + static_cast<size_t>(m) * K * Hs;
  const T* dw = static_cast<const T*>(p.dw);
  T* y = yw + static_cast<size_t>(m) * K * Hs;
  const float mean1 = p.stats1[2 * m];
  const float rs1 = p.stats1[2 * m + 1];
  const float a2 = *p.a2;
  const float sc = rs1 * p.g1[c];
  const float sh = p.b1[c] - mean1 * sc;
  const float g2 = p.g2[c];

  float t1 = 0.f, t2 = 0.f;
  for (int k = i0; k < i0 + kTpWideRows && k < K; ++k) {
    float acc = 0.f;
    for (int q = 0; q < P; ++q) {
      const int kk = k + q * d - p.left;
      if (kk < 0 || kk >= K) continue;  // a tap outside [0, K) adds nothing
      const float hv = to_f<T>(h[static_cast<size_t>(kk) * Hs + c]);
      acc = fmaf(to_f<T>(dw[q * Hs + c]), hv * sc + sh, acc);
    }
    const float v = prelu(acc, a2);
    t1 += v;
    t2 += v * v;
    y[static_cast<size_t>(k) * Hs + c] = from_f<T>(v * g2);
  }
  block_sum2(t1, t2);
  if (threadIdx.x == 0) {
    float* dst = p.part + 2 * ((static_cast<size_t>(m) * gridDim.x +
                                blockIdx.x) * gridDim.y + blockIdx.y);
    dst[0] = t1;
    dst[1] = t2;
  }
}

// Launch 2 of the bf16 wide route: z[m, r0:r0+64, n0:n0+64] = round(yw[m] @
// W_out_s), yw streamed from device memory over the whole depth Hs.
// Grid (ceil(K / 64), B / 64, M), kGemmThreads.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    tp_wide_out_kernel(TpParams p, const T* __restrict__ yw) {
  using S = GemmSmem<T>;
  __shared__ S s;
  const int m = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  gemm_tile<T>(yw + static_cast<size_t>(m) * p.K * p.Hs,
               static_cast<const T*>(p.w_out), p.K, p.Hs, p.B, r0, n0, s);
  T* z = static_cast<T*>(p.z) + static_cast<size_t>(m) * p.K * p.B;
  for (int e = threadIdx.x; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN;
    const int c = e % kBN;
    if (r0 + r < p.K)
      z[static_cast<size_t>(r0 + r) * p.B + n0 + c] =
          from_f<T>(s.c[r * S::kLdC + c]);
  }
}

// The wide route's three launches; yw holds M * K * Hs elements and p.part
// 2 * M * ceil(K / 64) * (Hs / 64) floats.
template <typename T>
int launch_tp_wide(const TpParams& p, T* yw, cudaStream_t stream) {
  const unsigned kt = (p.K + kBM - 1) / kBM;
  tp_wide_dw_kernel<T><<<dim3(kt, p.Hs / kBN, p.M), kTpWideThreads, 0,
                         stream>>>(p, yw);
  CTN_CHECK();
  tp_wide_out_kernel<T><<<dim3(kt, p.B / kBN, p.M), kGemmThreads, 0,
                          stream>>>(p, yw);
  CTN_CHECK();
  tp_sums_kernel<<<p.M, 256, 0, stream>>>(
      p.part, static_cast<int>(kt) * (p.Hs / kBN), p.sums);
  CTN_CHECK();
  return 0;
}

// bf16 stage 2 in the design its widths take (top note).
template <typename T>
int launch_tp(const TpParams& p, void* yw, cudaStream_t stream) {
  if (p.Hs > kTpResidentWidth)
    return launch_tp_wide<T>(p, static_cast<T*>(yw), stream);
  unsigned kt;
  if (runs_wg(p.B, p.Hs, sizeof(T))) {   // at wg_widths_ok
    const size_t smem = tp_wg_smem(p.Hs);
    cudaError_t err = cudaFuncSetAttribute(
        tp_stage2_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    // all of the SM's 228 KB as shared memory, so that two CTAs fit
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tp_stage2_wg_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return static_cast<int>(err);
    kt = (p.K + kWgRows - 1) / kWgRows;
    tp_stage2_wg_kernel<<<dim3(kt, p.M), kWgCta, smem, stream>>>(p);
  } else {
    const size_t smem = tp_smem<T>(p.Hs);
    cudaError_t err = cudaFuncSetAttribute(
        tp_stage2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kt = (p.K + kBM - 1) / kBM;
    tp_stage2_kernel<T><<<dim3(kt, p.M), kGemmThreads, smem, stream>>>(p);
  }
  CTN_CHECK();
  tp_sums_kernel<<<p.M, 256, 0, stream>>>(p.part, static_cast<int>(kt),
                                          p.sums);
  CTN_CHECK();
  return 0;
}

// ---- The f32 route (top note): split, depthwise stage, product, sums ----

// Launch 2 where dw_layout_ok(Hs): for rows [r0, r0 + 128) of sample
// blockIdx.y, y = PReLU_a2(dwconv(gLN-1(h))) on dw_rows_f32 (gLN-1's scale
// and shift from stats1, per element inside the taps, as tp_wide_dw_kernel
// applies them), y g2 into yg [M, K, Hs] (rows < K only) and the tile's f32
// (sum y, sum y^2) into part[m * gridDim.x + blockIdx.x]. Grid (ceil(K /
// 128), M), block 256.
__global__ void __launch_bounds__(kWgCta)
    tp_dw_tf32_kernel(TpParams p, float* __restrict__ yg) {
  const int K = p.K, Hs = p.Hs, CG = Hs / 8;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG, c0 = 8 * cg;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  const float mean1 = p.stats1[2 * m], rs1 = p.stats1[2 * m + 1];
  float g[8], b[8], sc[8], sh[8], g2[8];
  load8(p.g1 + c0, g);
  load8(p.b1 + c0, b);
  load8(p.g2 + c0, g2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = rs1 * g[j];
    sh[j] = b[j] - mean1 * sc[j];
  }
  const float a2 = *p.a2;
  const size_t base = static_cast<size_t>(m) * K * Hs;
  float* y = yg + base;
  float s1 = 0.f, s2 = 0.f;
  dw_rows_f32<false>(
      static_cast<const float*>(p.h) + base, static_cast<const float*>(p.dw),
      K, Hs, p.P, p.dilation, p.left, r0, cg, rg, kWgCta / CG, 0.f, false, g,
      b, sc, sh, [](int, float&, float&) {},
      [&](int, int k, const float (&acc)[8]) {
        if (k >= K) return;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float u = prelu(acc[j], a2);
          s1 += u;
          s2 += u * u;
          v[j] = u * g2[j];
        }
        st8f(y + static_cast<size_t>(k) * Hs + c0, v);
      });
  block_sum2(s1, s2);
  if (tid == 0) {
    const size_t slot = static_cast<size_t>(m) * gridDim.x + blockIdx.x;
    p.part[2 * slot] = s1;
    p.part[2 * slot + 1] = s2;
  }
}

// The product's column tile and ring depth: a 3-slab ring of 32 KB slots
// (97 KB) lets two CTAs share an SM, so the paper shape's 200 row tiles
// run in one wave (at BN = 128 with 4 slabs, 1.5 waves: 3-5% slower at Hs
// 128 and 256, 2-3% faster at 576-1024 on an H100).
constexpr int kTpOutBN = 64;
constexpr int kTpOutStages = 3;

// Launch 3: z = (y g2) @ W_out_s for rows [r0, r0 + 128) of sample
// blockIdx.y, all B columns, on the 3xTF32 core (maps: y g2 of launch 2,
// depth Hs; W_out_s^T's split of launch 1), stored from the accumulators as
// C' stores out (8-byte stores), rows at or beyond K skipped. Grid (ceil(K
// / 128), M), block 256.
__global__ void __launch_bounds__(kWgCta, 2)
    tp_out_tf32_kernel(const __grid_constant__ RowsMaps maps, TpParams p) {
  extern __shared__ uint8_t wg_smem[];
  const int K = p.K, B = p.B;
  const int t = threadIdx.x % kWgThreads, wg = threadIdx.x / kWgThreads;
  const int m = blockIdx.y, r0 = blockIdx.x * kWgRows;
  float* z = static_cast<float*>(p.z) + static_cast<size_t>(m) * K * B;
  rows_tf32_run<kTpOutBN, kTpOutStages>(
      wg_smem, align_1024(wg_smem), maps, m, r0, p.Hs, B,
      [&](float (&acc)[kTpOutBN / 2], int n0) {
#pragma unroll
        for (int j = 0; j < kTpOutBN / 2; j += 2) {
          const int r = r0 + 64 * wg + acc_row(t, j);
          if (r < K)
            *reinterpret_cast<float2*>(
                &z[static_cast<size_t>(r) * B + n0 + acc_col(t, j)]) =
                make_float2(acc[j], acc[j + 1]);
        }
      });
}

// Partials per sample the f32 depthwise stage writes: one per 128-row tile
// on dw_rows_f32, one per (64-row, 64-channel) tile on tp_wide_dw_kernel.
inline int tp_tf32_parts(int K, int Hs) {
  return dw_layout_ok(Hs) ? (K + kWgRows - 1) / kWgRows
                          : (K + kBM - 1) / kBM * (Hs / kBN);
}

// f32 stage 2 (top note), at ws: W_out_s^T's split (2 B Hs floats), then y
// g2 (M K Hs floats).
int launch_tp_tf32(const TpParams& p, void* ws, cudaStream_t stream) {
  float* w = static_cast<float*>(ws);
  float* yg = w + 2 * static_cast<size_t>(p.B) * p.Hs;
  // launch 1: the f32 stages' prep, its job 0 alone (W_out_s in W_in's
  // place: [Hs, B] -> [B, Hs], hi at w, lo at w + B Hs)
  prep_tf32_kernel<<<dim3(p.Hs / 32, p.B / kSlabK, 1), dim3(32, 8), 0,
                     stream>>>(static_cast<const float*>(p.w_out), nullptr,
                               nullptr, nullptr, nullptr, nullptr, 0, p.Hs,
                               p.B, 0, w, nullptr);
  CTN_CHECK();
  if (dw_layout_ok(p.Hs))
    tp_dw_tf32_kernel<<<dim3((p.K + kWgRows - 1) / kWgRows, p.M), kWgCta, 0,
                        stream>>>(p, yg);
  else
    tp_wide_dw_kernel<float><<<dim3((p.K + kBM - 1) / kBM, p.Hs / kBN, p.M),
                               kTpWideThreads, 0, stream>>>(p, yg);
  CTN_CHECK();
  RowsMaps maps;
  CTN_TRY(make_rows_maps(&maps, yg, p.M, p.K, p.Hs, w, p.B, kTpOutBN));
  // all of the SM's 228 KB as shared memory, so that two CTAs fit
  CTN_TRY(static_cast<int>(cudaFuncSetAttribute(
      tp_out_tf32_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      100)));
  CTN_TRY(launch_rows_tf32(tp_out_tf32_kernel,
                           rows_tf32_smem<kTpOutBN, kTpOutStages>(), p.K, p.M,
                           stream, maps, p));
  tp_sums_kernel<<<p.M, 256, 0, stream>>>(p.part, tp_tf32_parts(p.K, p.Hs),
                                          p.sums);
  CTN_CHECK();
  return 0;
}

TpParams make_tp_params(const void* h, const void* stats1, const void* dw,
                        const void* w_out, const void* a2, const void* g1,
                        const void* b1, const void* g2, void* z, void* part,
                        void* sums, int M, int K, int Hs, int B, int P,
                        int dilation, int causal) {
  TpParams p;
  p.h = h;
  p.stats1 = static_cast<const float*>(stats1);
  p.dw = dw;
  p.w_out = w_out;
  p.a2 = static_cast<const float*>(a2);
  p.g1 = static_cast<const float*>(g1);
  p.b1 = static_cast<const float*>(b1);
  p.g2 = static_cast<const float*>(g2);
  p.z = z;
  p.part = static_cast<float*>(part);
  p.sums = static_cast<float*>(sums);
  p.M = M;
  p.K = K;
  p.Hs = Hs;
  p.B = B;
  p.P = P;
  p.dilation = dilation;
  p.left = causal ? (P - 1) * dilation : ((P - 1) * dilation) / 2;
  return p;
}

}  // namespace

#define CTN_TP_ARGS                                                          \
  const void *h, const void *stats1, const void *dw, const void *w_out,     \
      const void *a2, const void *g1, const void *b1, const void *g2,       \
      void *z, void *part, void *sums, void *yw, int M, int K, int Hs,      \
      int B, int P, int dilation, int causal, void *stream
#define CTN_TP_CALL                                                          \
  make_tp_params(h, stats1, dw, w_out, a2, g1, b1, g2, z, part, sums, M, K, \
                 Hs, B, P, dilation, causal),                               \
      yw, static_cast<cudaStream_t>(stream)

extern "C" {

// The workspace of a call at these widths in a compute dtype of elem_bytes:
// *n_part floats of per-tile partials and *n_y elements of the compute
// dtype. f32 (every width): 2 * M * tp_tf32_parts(K, Hs) partials, and
// W_out_s^T's split and y g2 (2 * B * Hs + M * K * Hs floats). bf16: 2 * M
// * ceil(K / 64) partials (enough for either resident design's tiles; times
// Hs / 64 on the wide route), and the wide route's round(y g2) (M * K * Hs;
// 0 at Hs <= 512).
int ctn_tcn_block_tp2_workspace(int M, int K, int Hs, int B, int elem_bytes,
                                long long* n_part, long long* n_y) {
  if (elem_bytes == 4) {
    *n_part = 2LL * M * tp_tf32_parts(K, Hs);
    *n_y = 2LL * B * Hs + static_cast<long long>(M) * K * Hs;
    return 0;
  }
  const bool wide = Hs > kTpResidentWidth;
  *n_part = 2LL * M * ((K + kBM - 1) / kBM) * (wide ? Hs / kBN : 1);
  *n_y = wide ? static_cast<long long>(M) * K * Hs : 0;
  return 0;
}

// Stage 2 of one shard's block; every pointer is device memory, `part` and
// `yw` the workspace of ctn_tcn_block_tp2_workspace (`yw` may be null
// where it is 0), `stream` is a cudaStream_t. Returns the first CUDA error
// of its launches.
int ctn_tcn_block_tp2_f32(CTN_TP_ARGS) {
  return launch_tp_tf32(CTN_TP_CALL);
}

int ctn_tcn_block_tp2_bf16(CTN_TP_ARGS) {
  return launch_tp<__nv_bfloat16>(CTN_TP_CALL);
}

}  // extern "C"
