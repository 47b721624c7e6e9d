// The dual-path FFN sublayer forward for Hopper (sm_90a), bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/dpt_ffn.py::_ffn_kernel (wrapper
// fused_ffn). On rows x [R, B] (R = M * positions):
//
//   y   = LN(x) * gamma + beta                     f32 statistics, eps 1e-6
//   h   = gelu_tanh(round(y @ W_up) + b_up)        W_up [B, F]
//   out = x + (round(h @ W_down) + b_down)         W_down [F, B]
//
// rounded to the compute dtype after each f32-accumulated product and after
// each add, as the XLA sublayer (xla_ffn) rounds; the biases are added in
// the compute dtype.
//
// What bounds it on the card. At the DPT quality default (B=256, F=1024) and
// B=8 x 4 s (R = 25,600 rows) the two products are 26.8 GFLOP: 27 us at the
// bf16 tensor-core peak of 989 TFLOP/s, against 26.2 MB of x in and out
// (7.8 us at 3.35 TB/s): compute-bound. The [R, F] hidden is 52 MB in bf16,
// which the Pallas kernel kept in VMEM ([kt, F] per grid step); this kernel
// keeps it on chip too, one launch per sublayer.
//
// bf16 (ffn_wg_kernel, on the wgmma core of hopper_gemm.cuh, with B12's UG
// pieces from dpt_bwd_common.cuh): a CTA of two warpgroups takes 128 rows.
// x's tile goes resident K-major and ln_resident_tile normalises it in
// place (ln_rows_kernel's order). F then streams in slabs of 64 hidden
// columns: pre = round(round(y @ W_up[:, slab]) + round(b_up)) on wgmma
// (W_up an MN-major right operand), h = round(gelu_tanh(pre)) written from
// the accumulator registers straight into a swizzled K-major h slab in
// shared memory, and out += h_slab @ W_down[slab, :] on wgmma (W_down
// MN-major), a [64, B] accumulator per warpgroup in registers across all
// slabs. The epilogue stages x's tile over the ring and writes x +
// round(round(out) + round(b_down)) (partial: round(out) alone) in 16-byte
// rows. GELU is tanh through the fast exponential (gelu_tanh_fast, the
// value half of B12's gelu_and_grad_fast), held at the kernel's rounding
// points by the card tests.
//   Registers: the down accumulator is BN / 2 floats a thread (128 at
// B = 256), the up accumulator 32 (a 64-column slab) beside it; one CTA of
// 256 threads per SM, so up to 255 registers a thread.
//   Shared memory at B = 256: x's tile 64 KB, two h slabs (16 KB each) and
// a ring of four 32 KB slots, each one operand's slab (W_up's [B, 64] or
// W_down's [64, B]): 225 KB, one CTA per SM.
//   The schedule of slab j: after one barrier (the slabs of W_up(j) and
// W_down(j - 1) have landed, h(j - 1) is published, the slots read by the
// previous slab's products are free) the copies of W_down(j) and W_up(j +
// 1) are issued (one slab ahead), then the up product of slab j and the
// down product of slab j - 1 are committed in that order; the warpgroup
// waits for the up product only, and its GELU of slab j runs on the FMA
// and SFU pipes while the down product of slab j - 1 runs on the tensor
// cores; h(j) goes to the other h slab, and the down product is waited
// for before the next barrier.
//   Waves: 200 tiles at one CTA per SM are 1.52 waves on 132 SMs, as B12's
// UG; per tile the products are 134 MFLOP, 18 us at an SM's share of the
// peak. Two CTAs per SM would need half the registers (the down
// accumulator alone is 128) and half the shared memory (x's tile alone is
// 64 KB), so the second wave holds 68 tiles; what this design does better
// than UG is that the h never leaves the SM and the down product is as
// wide as the row. On an NVIDIA H100 80GB HBM3 at 700 W a tile takes
// 73-78 us whether 33 or 264 tiles run at once: each CTA's own slab
// pipeline, not the weights' L2 traffic (1 MB a tile), holds the kernel.
//
// f32 (ffn_kernel): the first design, FMA products (block_gemm) into f32
// tiles in shared memory, one block per 64 rows, slabs of 64; about 185 KB
// at B = 256 (512 (B + 4) + 52,224 bytes: it fits up to B = 348).
//
// Above B = 256 (at any width), in either dtype, the one-launch designs do
// not fit: the bf16 one's down accumulator (BN / 2 floats a thread) and ring
// slot grow with the row, and x's resident tile alone is 128 KB at B =
// 512; the f32 one's y and output tiles are 264 KB there. So the sublayer
// runs three launches through a workspace (ctn_dpt_ffn_workspace: y [R, B]
// and h [R, F] in the compute dtype): y = round(LN(x) gamma + beta)
// (ln_rows_kernel, the bits of ln_resident_tile and ln_rows_to_smem); h =
// round(gelu(pre)) (bf16: rows_wg_kernel, the same epilogue arithmetic as
// the one launch; f32: the 64 x 64 FMA tile of gemm_rows_kernel); and out
// = x + round(round(h @ W_down) + round(b_down)) (partial: round(h @
// W_down)) in 256-column tiles (bf16) or 64-column ones (f32). h's round
// trip is 2 R F elements more than the one launch moves. None of the three
// holds state sized by the row (ln_rows_kernel's warps stride over it, the
// products stream their depth), so this route takes every B.
//
// Under tensor parallelism (partial, the Pallas kernel's partial=True) the
// weights are one shard's slice of the hidden width, W_up [B, F/m] and
// W_down [F/m, B], and both epilogues write round(h @ W_down) alone: no
// down bias and no residual, which the caller adds once after summing the
// shards' partials (parallel/dpt_tp.py). F is free here (F % 128 == 0), so
// the kernel is the same; at the quality default's m = 2 (F/m 512) it is
// 13.4 GFLOP, 13.6 us at 989 TFLOP/s against 7.8 us of x in and out.

#include "dpt_bwd_common.cuh"

namespace {

constexpr int kSlab = 64;   // f32: hidden columns per step

struct FfnParams {
  const void* x;
  const float* gamma;
  const float* beta;
  const void* w_up;
  const float* b_up;
  const void* w_down;
  const float* b_down;
  void* out;
  int R, B, F, partial;
  int Bn;   // the LN's width: B off the 64-column tile, zero-padded to B
};

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu's default (approximate=True)
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

constexpr size_t ffn_f32_smem(int B) {
  return align128(static_cast<size_t>(kRowTile) * padded<float>(B) * 4) +
         kStageBytes +
         align128(static_cast<size_t>(kRowTile) * (kSlab + 4) * 4) +
         align128(static_cast<size_t>(kRowTile) * padded<float>(kSlab) * 4) +
         static_cast<size_t>(kRowTile) * (B + 4) * 4;
}

__global__ void __launch_bounds__(kDptThreads) ffn_kernel(FfnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = p.B, F = p.F, R = p.R;
  const int ldy = padded<float>(B);
  constexpr int ldu = kSlab + 4;
  constexpr int ldh = padded<float>(kSlab);
  const int ldo = B + 4;
  unsigned char* at = smem;
  float* y_s = reinterpret_cast<float*>(at);
  at += align128(static_cast<size_t>(kRowTile) * ldy * 4);
  float* w_s = reinterpret_cast<float*>(at);
  at += kStageBytes;
  float* u_s = reinterpret_cast<float*>(at);
  at += align128(static_cast<size_t>(kRowTile) * ldu * 4);
  float* h_s = reinterpret_cast<float*>(at);
  at += align128(static_cast<size_t>(kRowTile) * ldh * 4);
  float* o_s = reinterpret_cast<float*>(at);

  const int r0 = blockIdx.x * kRowTile;
  const float* x = static_cast<const float*>(p.x);
  ln_rows_to_smem<float>(x, r0, R, B, p.Bn, p.gamma, p.beta, y_s, ldy);
  for (int e = threadIdx.x; e < kRowTile * B; e += kDptThreads)
    o_s[(e / B) * ldo + e % B] = 0.f;
  __syncthreads();

  const float* w_up = static_cast<const float*>(p.w_up);
  const float* w_down = static_cast<const float*>(p.w_down);
  for (int f0 = 0; f0 < F; f0 += kSlab) {
    block_gemm<false>(y_s, ldy, w_up, F, B, f0, kSlab, w_s, u_s, ldu);
    for (int e = threadIdx.x; e < kRowTile * kSlab; e += kDptThreads) {
      const int r = e / kSlab;
      const int c = e % kSlab;
      h_s[r * ldh + c] = gelu_tanh(u_s[r * ldu + c] + p.b_up[f0 + c]);
    }
    __syncthreads();
    block_gemm<true>(h_s, ldh, w_down + static_cast<size_t>(f0) * B, B,
                     kSlab, 0, B, w_s, o_s, ldo);
  }

  float* out = static_cast<float*>(p.out);
  for (int e = threadIdx.x; e < kRowTile * B; e += kDptThreads) {
    const int r = e / B;
    const int c = e % B;
    if (r0 + r >= R) continue;
    const size_t idx = static_cast<size_t>(r0 + r) * B + c;
    out[idx] = p.partial ? o_s[r * ldo + c]
                         : x[idx] + (o_s[r * ldo + c] + p.b_down[c]);
  }
}

// ---- bf16: the design on the wgmma core (top note) ----

constexpr int kFfnSlab = 64;     // hidden columns per slab
constexpr int kFfnStages = 4;    // ring slots, one operand's slab each

// The down product's width for B = 64 NK: the core's tile that holds B
// (256 at B = 192, the columns past B zero).
template <int NK>
__host__ __device__ constexpr int ffn_bn() { return NK == 3 ? 256 : 64 * NK; }

// Shared memory: x's tile (NK panels), two h slabs, the ring, whose slot
// holds W_up's [B, 64] slab or W_down's [64, BN].
template <int NK>
constexpr size_t ffn_wg_smem() {
  return 1024 + static_cast<size_t>(NK) * kWgRows * kLine +
         2 * static_cast<size_t>(kWgRows) * kLine +
         static_cast<size_t>(kFfnStages) * ffn_bn<NK>() * kLine;
}
static_assert(ffn_wg_smem<4>() <= kMaxDynSmem, "the FFN's shared memory");
// the epilogue's staged [128, BN + 8] tile fits in the ring
static_assert(kWgRows * (64 + 8) * sizeof(bf16) <= kFfnStages * 64 * kLine &&
                  kWgRows * (256 + 8) * sizeof(bf16) <=
                      kFfnStages * 256 * kLine,
              "the FFN's staged tile");

// Rows [r0, r0 + 128), grid (ceil(R / 128)), block 256, B = 64 NK (top
// note). The ring's item i is W_up's slab i / 2 (i even) or W_down's (i
// odd), in slot i % kFfnStages. Slab 0's up product and slab n - 1's down
// product are peeled off the loop, so that each commit group in it is one
// product with no branch between its wgmmas. Rows at or beyond R read x
// as zeros and are not stored.
template <int NK>
__global__ void __launch_bounds__(kWgCta, 1) ffn_wg_kernel(FfnParams p) {
  extern __shared__ uint8_t wg_smem[];
  constexpr int BN = ffn_bn<NK>(), B = 64 * NK;
  constexpr uint32_t kSlot = BN * kLine, kH = kWgRows * kLine;
  constexpr int kLd = BN + 8;   // the staged tile's row: conflict-free pairs
  const int R = p.R, F = p.F, n = F / kFfnSlab;
  const uint32_t xs = align_1024(wg_smem);
  const uint32_t hs = xs + NK * kWgRows * kLine;
  const uint32_t ring = hs + 2 * kH;
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int r0 = blockIdx.x * kWgRows;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w_up = static_cast<const bf16*>(p.w_up);
  const bf16* w_down = static_cast<const bf16*>(p.w_down);
  const bool residual = !p.partial;
  auto issue = [&](int i) {   // one commit group
    if (i < 2 * n) {
      const uint32_t slot = ring + (i % kFfnStages) * kSlot;
      const int f0 = (i / 2) * kFfnSlab;
      if (i % 2 == 0) {
#pragma unroll
        for (int s = 0; s < NK; ++s)
          load_mn_slab(slot + s * kMnPanel, w_up, F, s * kSlabK, B, f0,
                       kFfnSlab, F, tid, kWgCta);
      } else {
        load_mn_slab(slot, w_down, B, f0, F, 0, BN, B, tid, kWgCta);
      }
    }
    cp_async_commit();
  };
  float acc_o[BN / 2], acc_u[kFfnSlab / 2];
  // the top of slab j's step: W_up(j) and W_down(j - 1), issued a step
  // ago, have landed; this thread's copies, and the LN or h(j - 1), are
  // published to wgmma; every product of the previous steps is done, so
  // W_down(j) and W_up(j + 1) go into the slots of W_down(j - 2) and
  // W_up(j - 1)
  auto top = [&](int j) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(2 * j + 1);
    issue(2 * j + 2);
    fence_acc(acc_u);
    fence_acc(acc_o);
    wgmma_fence();
  };
  auto up = [&](int j) {   // acc_u = y @ W_up(j), one commit group
    const uint32_t slot = ring + ((2 * j) % kFfnStages) * kSlot;
#pragma unroll
    for (int s = 0; s < NK; ++s)
      mma_slab<kFfnSlab, false, true>(
          acc_u, xs + s * kWgRows * kLine + wg * 64 * kLine,
          slot + s * kMnPanel, s > 0);
    wgmma_commit();
  };
  auto down = [&](int j) {   // acc_o += h(j) @ W_down(j), one commit group
    mma_slab<BN, false, true>(acc_o, hs + (j & 1) * kH + wg * 64 * kLine,
                              ring + ((2 * j + 1) % kFfnStages) * kSlot,
                              j > 0);
    wgmma_commit();
  };
  // h(j) = round(gelu(pre)), pre = round(round(acc_u) + round(b_up)), into
  // this warpgroup's rows of h slab j % 2
  auto gelu = [&](int j) {
    fence_acc(acc_u);
    uint8_t* h_gen = smem_ptr(wg_smem, hs + (j & 1) * kH);
    const float* b_up = p.b_up + j * kFfnSlab;
    auto h_of = [](float acc, float b) {
      return gelu_tanh_fast(round_to<bf16>(round_to<bf16>(acc) +
                                           round_to<bf16>(b)));
    };
#pragma unroll
    for (int i = 0; i < kFfnSlab / 2; i += 2) {
      const int c = acc_col(t, i), l = 64 * wg + acc_row(t, i);
      const float2 bu = *reinterpret_cast<const float2*>(b_up + c);
      *reinterpret_cast<__nv_bfloat162*>(h_gen + swz(l, c >> 3) +
                                         2 * (c & 7)) =
          __floats2bfloat162_rn(h_of(acc_u[i], bu.x),
                                h_of(acc_u[i + 1], bu.y));
    }
  };

#pragma unroll
  for (int s = 0; s < NK; ++s)   // x's tile, in the first group
    load_k_panel(xs + s * kWgRows * kLine, x, B, r0, kWgRows, R, s * kSlabK,
                 tid, kWgCta);
  issue(0);
  cp_async_wait<0>();
  __syncthreads();
  // B is a constant here: at Bn == B the LN's loops keep their constant
  // bounds, unrolled as before Bn existed (a runtime bound made the launch
  // 7-11% slower on an H100, PERF.md §6); only a padded row takes Bn
  if (p.Bn == B)
    ln_resident_tile(smem_ptr(wg_smem, xs), p.gamma, p.beta, r0, R, B, B,
                     nullptr, nullptr);
  else
    ln_resident_tile(smem_ptr(wg_smem, xs), p.gamma, p.beta, r0, R, B, p.Bn,
                     nullptr, nullptr);
  top(0);
  up(0);
  wgmma_wait<0>();
  gelu(0);
#pragma unroll 1
  for (int j = 1; j < n; ++j) {
    top(j);
    up(j);
    down(j - 1);
    wgmma_wait<1>();   // the up product; the down one may still run
    gelu(j);
    wgmma_wait<0>();
    fence_acc(acc_o);
  }
  top(n);
  down(n - 1);
  wgmma_wait<0>();
  fence_acc(acc_o);

  // the epilogue over the ring (every copy has landed: the last groups
  // were empty)
  bf16* st = reinterpret_cast<bf16*>(smem_ptr(wg_smem, ring));
  bf16* out = static_cast<bf16*>(p.out);
  __syncthreads();   // every warpgroup is done with the ring
  if (residual) {
    for (int v = tid; v < kWgRows * (B / 8); v += kWgCta) {
      const int rl = v / (B / 8), c = 8 * (v % (B / 8));
      const bool ok = r0 + rl < R;
      cp_async16(smem_u32(st + rl * kLd + c),
                 x + (ok ? static_cast<size_t>(r0 + rl) * B + c : 0), ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int c = acc_col(t, i);
    if (c >= B) continue;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
        st + (64 * wg + acc_row(t, i)) * kLd + c);
    float o0 = acc_o[i], o1 = acc_o[i + 1];
    if (residual) {
      const float2 bd = *reinterpret_cast<const float2*>(p.b_down + c);
      const float2 xv = __bfloat1622float2(*e);
      o0 = xv.x + round_to<bf16>(round_to<bf16>(o0) + round_to<bf16>(bd.x));
      o1 = xv.y + round_to<bf16>(round_to<bf16>(o1) + round_to<bf16>(bd.y));
    }
    *e = __floats2bfloat162_rn(o0, o1);
  }
  __syncthreads();
  for (int v = tid; v < kWgRows * (B / 8); v += kWgCta) {
    const int rl = v / (B / 8), c = 8 * (v % (B / 8));
    if (r0 + rl < R)
      *reinterpret_cast<uint4*>(&out[static_cast<size_t>(r0 + rl) * B + c]) =
          *reinterpret_cast<const uint4*>(&st[rl * kLd + c]);
  }
}

template <int NK>
int run_wg(const FfnParams& p, cudaStream_t stream) {
  constexpr size_t smem = ffn_wg_smem<NK>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_wg_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_wg_kernel<NK><<<(p.R + kWgRows - 1) / kWgRows, kWgCta, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int run(K kernel, size_t smem, const FfnParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((p.R + kRowTile - 1) / kRowTile);
  kernel<<<tiles, kDptThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- Above B = 256: three launches through a workspace (top note) ----

// The workspace above 256: y [R, B], then h [R, F] on a 256-byte boundary,
// in elements of the compute dtype; none at B <= 256.
inline size_t ffn_ws_h(int R, int B) {
  return align_up(static_cast<size_t>(R) * B, 128);
}
inline size_t ffn_ws_elems(int R, int B, int F) {
  return B > kMaxWidth ? ffn_ws_h(R, B) + static_cast<size_t>(R) * F : 0;
}

// bf16: h = round(gelu_tanh_fast(round(round(y W_up) + round(b_up)))), as
// ffn_wg_kernel's gelu step rounds.
struct UpGeluEpi {
  const float* b_up;
  __device__ float operator()(float acc, int col, float, bool) const {
    return gelu_tanh_fast(round_to<bf16>(round_to<bf16>(acc) +
                                         round_to<bf16>(b_up[col])));
  }
};

// bf16: out = x + round(round(h W_down) + round(b_down)); partial:
// round(h W_down), as ffn_wg_kernel's epilogue rounds.
struct DownResEpi {
  const float* b_down;
  __device__ float operator()(float acc, int col, float x,
                              bool residual) const {
    if (!residual) return acc;
    return x + round_to<bf16>(round_to<bf16>(acc) + round_to<bf16>(b_down[col]));
  }
};

// f32: h = gelu_tanh(y W_up + b_up), as ffn_kernel.
struct UpGeluF32 {
  float* h;
  const float* b_up;
  __device__ void operator()(size_t i, int col, float v) const {
    h[i] = gelu_tanh(v + b_up[col]);
  }
};

// f32: out = x + (h W_down + b_down); partial: h W_down, as ffn_kernel.
struct DownResF32 {
  float* out;
  const float* x;
  const float* b_down;
  int partial;
  __device__ void operator()(size_t i, int col, float v) const {
    out[i] = partial ? v : x[i] + (v + b_down[col]);
  }
};

template <typename T>
int launch_wide(const FfnParams& p, void* ws, cudaStream_t stream) {
  if (p.B % 64 || p.F % (2 * kFfnSlab))
    return static_cast<int>(cudaErrorInvalidValue);
  T* y = static_cast<T*>(ws);
  T* h = y + ffn_ws_h(p.R, p.B);
  CTN_RETURN_IF(
      launch_ln_rows<T>(p.x, p.R, p.B, p.Bn, p.gamma, p.beta, y, stream));
  if constexpr (kIsBf16<T>) {
    RowsWgParams q;
    q.a = y;
    q.w = static_cast<const bf16*>(p.w_up);
    q.res = nullptr;
    q.out = h;
    q.R = p.R;
    q.N = p.F;
    q.depth = p.B;
    CTN_RETURN_IF(launch_rows_wg(q, UpGeluEpi{p.b_up}, stream));
    q.a = h;
    q.w = static_cast<const bf16*>(p.w_down);
    q.res = p.partial ? nullptr : static_cast<const bf16*>(p.x);
    q.out = static_cast<bf16*>(p.out);
    q.N = p.B;
    q.depth = p.F;
    return launch_rows_wg(q, DownResEpi{p.b_down}, stream);
  } else {
    CTN_RETURN_IF(launch_gemm_rows<float>(
        y, static_cast<const float*>(p.w_up), p.R, p.B, p.F,
        UpGeluF32{h, p.b_up}, stream));
    return launch_gemm_rows<float>(
        h, static_cast<const float*>(p.w_down), p.R, p.F, p.B,
        DownResF32{static_cast<float*>(p.out),
                   static_cast<const float*>(p.x), p.b_down, p.partial},
        stream);
  }
}

template <typename T>
int launch(const FfnParams& p, void* ws, cudaStream_t stream) {
  if (p.Bn < 1 || p.Bn > p.B) return static_cast<int>(cudaErrorInvalidValue);
  if (p.B > kMaxWidth) return launch_wide<T>(p, ws, stream);
  if constexpr (kIsBf16<T>) {
    if (p.F % kFfnSlab) return static_cast<int>(cudaErrorInvalidValue);
    switch (p.B) {
      case 64: return run_wg<1>(p, stream);
      case 128: return run_wg<2>(p, stream);
      case 192: return run_wg<3>(p, stream);
      case 256: return run_wg<4>(p, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return run(ffn_kernel, ffn_f32_smem(p.B), p, stream);
  }
}

FfnParams make_params(const void* x, const void* gamma, const void* beta,
                      const void* w_up, const void* b_up, const void* w_down,
                      const void* b_down, void* out, int R, int B, int Bn,
                      int F, int partial) {
  FfnParams p;
  p.x = x;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.w_up = w_up;
  p.b_up = static_cast<const float*>(b_up);
  p.w_down = w_down;
  p.b_down = static_cast<const float*>(b_down);
  p.out = out;
  p.R = R;
  p.B = B;
  p.Bn = Bn;
  p.F = F;
  p.partial = partial;
  return p;
}

}  // namespace

#define CTN_FFN_ARGS                                                        \
  const void *x, const void *gamma, const void *beta, const void *w_up,    \
      const void *b_up, const void *w_down, const void *b_down, void *out, \
      void *ws, int R, int B, int Bn, int F, int partial, void *stream

extern "C" {

// Elements of the compute dtype the FFN forward's workspace holds: 0 at
// B <= 256 (one launch), y [R, B] and h [R, F] above.
int ctn_dpt_ffn_workspace(int R, int B, int F, long long* n) {
  *n = static_cast<long long>(ffn_ws_elems(R, B, F));
  return 0;
}

// One FFN sublayer; every pointer is device memory (gamma, beta, b_up and
// b_down f32, the rest in the compute dtype; ws as ctn_dpt_ffn_workspace
// sizes it), `stream` a cudaStream_t; partial: a shard's down projection
// alone (b_down is not read); Bn <= B the LN's width (B == Bn unless the
// wrapper padded B up to the 64-column tile). Returns the first CUDA error
// of its launches.
int ctn_dpt_ffn_f32(CTN_FFN_ARGS) {
  return launch<float>(
      make_params(x, gamma, beta, w_up, b_up, w_down, b_down, out, R, B, Bn,
                  F, partial),
      ws, static_cast<cudaStream_t>(stream));
}

int ctn_dpt_ffn_bf16(CTN_FFN_ARGS) {
  return launch<__nv_bfloat16>(
      make_params(x, gamma, beta, w_up, b_up, w_down, b_down, out, R, B, Bn,
                  F, partial),
      ws, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
