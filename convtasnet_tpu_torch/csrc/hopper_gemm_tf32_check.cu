// Entry points that run the f32 3xTF32 product core (hopper_gemm_tf32.cuh)
// alone, so that a card test can hold it against an f64 product at the TCN
// block's shapes: the wgmma row-tile product (both operands streamed by
// TMA, the right one split into hi and lo copies first) and the weight
// gradients' mma.sync
// split-row product. A wrong fragment layout, swizzle or descriptor shows
// here as a wrong product, and a single TF32 product as one ~100x further
// from f64 than 3xTF32's; the split's integer rounding is held against the
// conversion instruction's bits. These entries serve the card tests only: no
// kernel or wrapper calls them.

#include "hopper_gemm_tf32.cuh"

namespace {

// ws[i] = hi(b[i]), ws[n + i] = lo(b[i]); and where rna is given, rna[i]
// = cvt.rna.tf32.f32(b[i]), the conversion instruction's own bits.
__global__ void split_check_kernel(const float* __restrict__ b, int n,
                                   float* __restrict__ ws,
                                   float* __restrict__ rna) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t hi, lo;
  split_tf32(b[i], hi, lo);
  ws[i] = __uint_as_float(hi);
  ws[n + i] = __uint_as_float(lo);
  if (rna) rna[i] = __uint_as_float(tf32_cvt_rna(b[i]));
}

// c [M, N] = a [M, D] @ w^T (maps: a as [1, M, D], w's split [N, D]);
// grid (ceil(M / 128)).
template <int BN>
__global__ void __launch_bounds__(kWgCta)
    tf32_matmul_kernel(const __grid_constant__ RowsMaps maps,
                       float* __restrict__ c, int M, int N, int D) {
  extern __shared__ uint8_t wg_smem[];
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int r0 = blockIdx.x * kWgRows;
  rows_tf32_run<BN, 4>(
      wg_smem, align_1024(wg_smem), maps, 0, r0, D, N,
      [&](float (&acc)[BN / 2], int n0) {
#pragma unroll
        for (int j = 0; j < BN / 2; j += 2) {
          const int r = r0 + 64 * wg + acc_row(t, j);
          if (r < M)
            *reinterpret_cast<float2*>(
                &c[static_cast<size_t>(r) * N + n0 + acc_col(t, j)]) =
                make_float2(acc[j], acc[j + 1]);
        }
      });
}

template <int BN>
int launch_matmul(const float* a, const float* ws, float* c, int M, int N,
                  int D, cudaStream_t stream) {
  RowsMaps maps;
  const int maps_err = make_rows_maps(&maps, a, 1, M, D, ws, N, BN);
  if (maps_err != 0) return maps_err;
  constexpr size_t smem = rows_tf32_smem<BN, 4>();
  auto kernel = tf32_matmul_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(M + kWgRows - 1) / kWgRows, kWgCta, smem, stream>>>(maps, c, M,
                                                                N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c [M, N] f32 = a [M, D] @ b^T, b stored [N, D] (K-major, as the stages'
// weights), on the wgmma core in 3xTF32; ws takes 3 N D floats: b's split
// (hi, lo) as the stages' prep writes it and the core reads it, then
// cvt.rna.tf32.f32 of b, which the caller holds against hi bit for bit. D % 32 == 0, N % 64 == 0 (the
// column tile 128 where N % 128 == 0).
int ctn_tf32_matmul_check(const void* a, const void* b, void* ws, void* c,
                          int M, int N, int D, void* stream) {
  if (D % 32 || N % 64 || M <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = N * D;
  split_check_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(b), n, static_cast<float*>(ws),
      static_cast<float*>(ws) + 2 * static_cast<size_t>(n));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* pa = static_cast<const float*>(a);
  const float* pw = static_cast<const float*>(ws);
  float* pc = static_cast<float*>(c);
  return N % 128 == 0 ? launch_matmul<128>(pa, pw, pc, M, N, D, s)
                      : launch_matmul<64>(pa, pw, pc, M, N, D, s);
}

// out_part [n_chunks, ca, cb] f32: chunk z's a[rows]^T @ b[rows] in
// 3xTF32 on mma.sync (wgrad_tf32_kernel), a [rows, ca], b [rows, cb] f32;
// ca % 64 == 0, cb % 64 == 0, chunk % 32 == 0.
int ctn_tf32_wgrad_check(const void* a, const void* b, int rows, int ca,
                         int cb, int chunk, void* out_part, void* stream) {
  if (ca % 64 || cb % 64 || chunk % 32 || chunk <= 0 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_wgrad_tf32_chunks(static_cast<const float*>(a),
                                  static_cast<const float*>(b), rows, ca, cb,
                                  chunk, static_cast<float*>(out_part), s);
}

}  // extern "C"
