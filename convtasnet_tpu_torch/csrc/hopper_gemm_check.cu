// Entry points that run the Hopper product core (hopper_gemm.cuh) alone,
// so that a card test can hold it against torch.matmul at the TCN block's
// shapes and in each operand layout: a wrong swizzle or descriptor shows
// here as a wrong product, before any block kernel reads it. These two
// entries serve the card tests only: no kernel or wrapper calls them. The
// unit builds into the one library beside the others, compiled in
// parallel with them, so it lengthens the first-use build only when it is
// the slowest unit.

#include "hopper_gemm.cuh"

namespace {

template <bool kTA, bool kTB>
int launch_check(const void* a, const void* b, void* c, int M, int N, int K,
                 cudaStream_t stream) {
  constexpr int BN = 256;
  const size_t smem = 4 * (128 + BN) * kLine + 1024;
  auto kernel = wg_matmul_kernel<BN, kTA, kTB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((M + 127) / 128, N / BN), 2 * kWgThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c [M, N] f32 = A @ B, bf16 operands: A stored [M, K] (ta 0) or [K, M]
// (ta 1), B stored [N, K] (tb 0) or [K, N] (tb 1). M % 8 == 0,
// N % 256 == 0, K % 64 == 0.
int ctn_wg_matmul_check(const void* a, const void* b, void* c, int M, int N,
                        int K, int ta, int tb, void* stream) {
  if (M % 8 || N % 256 || K % 64 || M <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * (ta != 0) + (tb != 0)) {
    case 0: return launch_check<false, false>(a, b, c, M, N, K, s);
    case 1: return launch_check<false, true>(a, b, c, M, N, K, s);
    case 2: return launch_check<true, false>(a, b, c, M, N, K, s);
    default: return launch_check<true, true>(a, b, c, M, N, K, s);
  }
}

// out_part [n_chunks, ca, cb] f32: chunk z's a[rows]^T @ b[rows] (the
// weight gradients' split-row product, wgrad_wg_kernel) with chunk rows
// per chunk; a [rows, ca], b [rows, cb] bf16, ca % 128 == 0,
// cb % 256 == 0, chunk % 64 == 0.
int ctn_wg_wgrad_check(const void* a, const void* b, int rows, int ca,
                       int cb, int chunk, void* out_part, void* stream) {
  if (ca % 128 || cb % 256 || chunk % 64 || chunk <= 0 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = wgrad_wg_smem<2, 256, 4>();
  auto kernel = wgrad_wg_kernel<2, 256, 4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ca / 128, cb / 256, (rows + chunk - 1) / chunk),
           2 * kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), rows, ca, cb, chunk,
      static_cast<float*>(out_part));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
