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
// TFLOP/s): bytes-bound. Four shards (Hs=128) read half of h. The Pallas
// kernel keeps a sample's whole [K, Hs] h in VMEM; here one block per
// (64-row tile, sample) builds its [64, Hs] tile of y from h in device
// memory (B1's launch B: gLN-1 applied per element inside the taps), keeps
// round(y g2) in shared memory (32 KB at Hs=256 in bf16, 64 KB in f32) as
// the resident left operand of the B/64 products with W_out_s
// (gemm_tile with kResA), and writes z once. Its partial sums
// land in one slot per tile; a second launch sums them in a fixed order in
// double, so there are no atomics and a rerun gives the same bits. The
// grid is M*K/64 blocks (400 at the paper shape); the products are B1's
// 64x64 WMMA tile (FMA in f32) without cp.async/TMA or wgmma.

#include "tcn_block_common.cuh"

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

template <typename T>
int launch_tp(const TpParams& p, cudaStream_t stream) {
  const size_t smem = tp_smem<T>(p.Hs);
  cudaError_t err = cudaFuncSetAttribute(
      tp_stage2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned kt = (p.K + kBM - 1) / kBM;
  tp_stage2_kernel<T><<<dim3(kt, p.M), kGemmThreads, smem, stream>>>(p);
  CTN_CHECK();
  tp_sums_kernel<<<p.M, 256, 0, stream>>>(p.part, static_cast<int>(kt),
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
      void *z, void *part, void *sums, int M, int K, int Hs, int B, int P,  \
      int dilation, int causal, void *stream
#define CTN_TP_CALL                                                          \
  make_tp_params(h, stats1, dw, w_out, a2, g1, b1, g2, z, part, sums, M, K, \
                 Hs, B, P, dilation, causal),                               \
      static_cast<cudaStream_t>(stream)

extern "C" {

// Stage 2 of one shard's block; every pointer is device memory, `part`
// holds 2 * M * ceil(K / 64) floats of workspace, `stream` is a
// cudaStream_t. Returns the first CUDA error of its two launches.
int ctn_tcn_block_tp2_f32(CTN_TP_ARGS) {
  return launch_tp<float>(CTN_TP_CALL);
}

int ctn_tcn_block_tp2_bf16(CTN_TP_ARGS) {
  return launch_tp<__nv_bfloat16>(CTN_TP_CALL);
}

}  // extern "C"
