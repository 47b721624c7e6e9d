// The block boundary of a TCN block pair (tcn_block_pair.cu, B4), which the
// pair backward (tcn_block_pair_bwd.cu, B5) reruns to re-form x1 and the
// second block's pre-activation bit for bit as the forward made them.
//
// boundary_kernel is block 1's launch C fused with block 2's launch A. One
// block of the grid (ceil(K/kBM), 1, M) owns a row tile of kBM rows over
// all B columns:
//
//   x1[rows, :] = x0 + norm2_1 folded into (y1 @ W_eff1)   B/kBN products,
//                 rounded, to device memory (block 2's residual) and to a
//                 [kBM, B] shared tile (rows at or beyond K as zeros);
//   h2[rows, :] = PReLU(x1 tile @ W_in2)                  H/kBN products
//                 from the shared tile, with norm1_2's partials.
//
// The two halves are launch C's and launch A's epilogues
// (tcn_block_common.cuh) on the same GEMM tile, the second reading its
// left operand in place from shared memory, and the partials land in the
// slots launch A would have written; so a pair computes what two chained
// single blocks compute, to the bit.

#pragma once

#include "tcn_block_common.cuh"

namespace {

// Leading dimension of the shared x1 tile: 16 bytes of pad per row.
template <typename T>
__host__ __device__ constexpr int res_ld(int B) {
  return B + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
constexpr size_t boundary_smem(int B) {
  return static_cast<size_t>(kBM) * res_ld<T>(B) * sizeof(T);
}

// p1: block 1 (x = x0, y = y1, w_eff, wsum, part_b of launch B, out = x1);
// p2: block 2 (w_in, a1, h, part_a, K, H). n_part_b: launch-B partials of
// block 1 per sample (gLN) or per row (cLN). kPre: h2 holds x1 @ W_in2
// before PReLU (the backward's recompute), as launch A's kPre.
template <typename T, int kNorm, bool kPre>
__global__ void __launch_bounds__(kGemmThreads)
    boundary_kernel(Params p1, Params p2, int n_part_b) {
  __shared__ GemmSmem<T> s;
  __shared__ float s_mu[kBM];
  __shared__ float s_rs[kBM];
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  T* x1_s = reinterpret_cast<T*>(dyn_smem);
  const int ld = res_ld<T>(p1.B);
  const int m = blockIdx.z;
  const int bx = blockIdx.x;
  const int r0 = bx * kBM;
  out_proj_stats(p1, n_part_b, m, r0, s_mu, s_rs);
  const T* y1 = static_cast<const T*>(p1.y) + static_cast<size_t>(m) * p1.K * p1.H;
  for (int n0 = 0; n0 < p1.B; n0 += kBN) {
    gemm_tile<T>(y1, static_cast<const T*>(p1.w_eff), p1.K, p1.H, p1.B, r0, n0,
                 s);
    out_proj_epilogue<T>(p1, s, s_mu, s_rs, m, r0, n0, x1_s, ld);
    __syncthreads();   // s.c is read before the next product writes it
  }
  const int n_tiles = p2.H / kBN;
  for (int by = 0; by < n_tiles; ++by) {
    gemm_tile<T, true>(x1_s, static_cast<const T*>(p2.w_in), 0, p1.B, p2.H, 0,
                       by * kBN, s, ld);
    in_proj_epilogue<T, kNorm, kPre>(p2, s, m, bx, by, gridDim.x, n_tiles);
    __syncthreads();
  }
}

template <typename T, int kNorm, bool kPre>
int launch_boundary(const Params& p1, const Params& p2, int n_part_b,
                    cudaStream_t stream) {
  const size_t smem = boundary_smem<T>(p1.B);
  cudaError_t err = cudaFuncSetAttribute(
      boundary_kernel<T, kNorm, kPre>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned kt = (p1.K + kBM - 1) / kBM;
  boundary_kernel<T, kNorm, kPre><<<dim3(kt, 1, p1.M), kGemmThreads, smem,
                                    stream>>>(p1, p2, n_part_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
