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
// keeps it on chip too. One block takes 64 rows: the LN over B is also the
// up product's contraction, so the block normalises its whole [64, B] tile
// into shared memory once (f32 statistics), then streams F in slabs:
// h_slab = gelu(round(y @ W_up[:, slab]) + b_up) into shared memory, and the
// down product accumulates out += h_slab @ W_down[slab, :] in f32. x and
// out each cross device memory once; the weights are re-read per block from
// L2.
//
// bf16 (ffn_kernel_bf16, templated on B / 64): the products are tile_mma
// (dpt_common.cuh), WMMA fragments with the weights streamed through two
// cp.async stages; slabs of 128 hidden columns; the [64, B] output
// accumulates in registers across the slabs; about 93 KB of shared memory.
// f32 (ffn_kernel): FMA products (block_gemm) into f32 tiles in shared
// memory, slabs of 64; about 185 KB. Neither uses wgmma or TMA yet.
//
// Under tensor parallelism (partial, the Pallas kernel's partial=True) the
// weights are one shard's slice of the hidden width, W_up [B, F/m] and
// W_down [F/m, B], and both epilogues write round(h @ W_down) alone: no
// down bias and no residual, which the caller adds once after summing the
// shards' partials (parallel/dpt_tp.py). F is free here (F % 128 == 0), so
// the kernel is the same; at the quality default's m = 2 (F/m 512) it is
// 13.4 GFLOP, 13.6 us at 989 TFLOP/s against 7.8 us of x in and out.

#include "dpt_common.cuh"

namespace {

constexpr int kSlab = 64;   // f32: hidden columns per step
constexpr int kUpWN = 2;    // bf16: 128 hidden columns per step

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
  ln_rows_to_smem<float>(x, r0, R, B, p.gamma, p.beta, y_s, ldy);
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

template <int WN>
constexpr size_t ffn_bf16_smem() {
  constexpr int B = 64 * WN;
  constexpr size_t stage = wstage_bytes<WN>() > wstage_bytes<kUpWN>()
                               ? wstage_bytes<WN>()
                               : wstage_bytes<kUpWN>();
  return align128(static_cast<size_t>(kRowTile) *
                  padded<__nv_bfloat16>(B) * 2) +
         align128(static_cast<size_t>(kRowTile) *
                  padded<__nv_bfloat16>(64 * kUpWN) * 2) +
         2 * stage + kEpilogueBytes;
}

// At most 128 registers, so two blocks share an SM.
template <int WN>
__global__ void __launch_bounds__(kDptThreads, 2)
    ffn_kernel_bf16(FfnParams p) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int B = 64 * WN;
  constexpr int kUp = 64 * kUpWN;
  constexpr int ldy = padded<T>(B);
  constexpr int ldh = padded<T>(kUp);
  constexpr size_t stage = wstage_bytes<WN>() > wstage_bytes<kUpWN>()
                               ? wstage_bytes<WN>()
                               : wstage_bytes<kUpWN>();
  const int F = p.F, R = p.R;
  unsigned char* at = smem;
  T* y_s = reinterpret_cast<T*>(at);
  at += align128(static_cast<size_t>(kRowTile) * ldy * 2);
  T* h_s = reinterpret_cast<T*>(at);
  at += align128(static_cast<size_t>(kRowTile) * ldh * 2);
  T* w_s = reinterpret_cast<T*>(at);
  at += 2 * stage;
  float* scratch = reinterpret_cast<float*>(at);

  const int r0 = blockIdx.x * kRowTile;
  const T* x = static_cast<const T*>(p.x);
  ln_rows_to_smem<T>(x, r0, R, B, p.gamma, p.beta, y_s, ldy);
  const T* w_up = static_cast<const T*>(p.w_up);
  const T* w_down = static_cast<const T*>(p.w_down);
  TileAcc<WN> acc;
  acc.zero();
  for (int f0 = 0; f0 < F; f0 += kUp) {
    TileAcc<kUpWN> up;
    up.zero();
    tile_mma<kUpWN>(up, y_s, ldy, w_up, F, B, f0, w_s);
    tile_epilogue<kUpWN>(up, scratch, [&](int r, int c, const float* v) {
      float h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = gelu_tanh(round_to<T>(round_to<T>(v[e]) +
                                     round_to<T>(p.b_up[f0 + c + e])));
      store8_bf16(h_s + r * ldh + c, h);
    });
    tile_mma<WN>(acc, h_s, ldh, w_down + static_cast<size_t>(f0) * B, B, kUp,
                 0, w_s);
  }
  T* out = static_cast<T*>(p.out);
  tile_epilogue<WN>(acc, scratch, [&](int r, int c, const float* v) {
    if (r0 + r >= R) return;
    const size_t idx = static_cast<size_t>(r0 + r) * B + c;
    float o[8];
    if (p.partial) {
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = round_to<T>(v[e]);
    } else {
      alignas(16) T xv[8];
      *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(x + idx);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = to_f<T>(xv[e]) +
               round_to<T>(round_to<T>(v[e]) + round_to<T>(p.b_down[c + e]));
    }
    store8_bf16(out + idx, o);
  });
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

template <typename T>
int launch(const FfnParams& p, cudaStream_t stream) {
  if constexpr (kIsBf16<T>) {
    switch (p.B / 64) {
      case 1: return run(ffn_kernel_bf16<1>, ffn_bf16_smem<1>(), p, stream);
      case 2: return run(ffn_kernel_bf16<2>, ffn_bf16_smem<2>(), p, stream);
      case 3: return run(ffn_kernel_bf16<3>, ffn_bf16_smem<3>(), p, stream);
      case 4: return run(ffn_kernel_bf16<4>, ffn_bf16_smem<4>(), p, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return run(ffn_kernel, ffn_f32_smem(p.B), p, stream);
  }
}

FfnParams make_params(const void* x, const void* gamma, const void* beta,
                      const void* w_up, const void* b_up, const void* w_down,
                      const void* b_down, void* out, int R, int B, int F,
                      int partial) {
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
  p.F = F;
  p.partial = partial;
  return p;
}

}  // namespace

#define CTN_FFN_ARGS                                                        \
  const void *x, const void *gamma, const void *beta, const void *w_up,    \
      const void *b_up, const void *w_down, const void *b_down, void *out, \
      int R, int B, int F, int partial, void *stream

extern "C" {

// One FFN sublayer; every pointer is device memory (gamma, beta, b_up and
// b_down f32, the rest in the compute dtype), `stream` a cudaStream_t;
// partial: a shard's down projection alone (b_down is not read). Returns
// the first CUDA error of the launch.
int ctn_dpt_ffn_f32(CTN_FFN_ARGS) {
  return launch<float>(
      make_params(x, gamma, beta, w_up, b_up, w_down, b_down, out, R, B, F,
                  partial),
      static_cast<cudaStream_t>(stream));
}

int ctn_dpt_ffn_bf16(CTN_FFN_ARGS) {
  return launch<__nv_bfloat16>(
      make_params(x, gamma, beta, w_up, b_up, w_down, b_down, out, R, B, F,
                  partial),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
