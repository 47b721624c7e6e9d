// The dual-path inter-chunk attention sublayer forward for Hopper (sm_90a),
// bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/dpt_attention.py::_inter_kernel
// (wrapper fused_inter_attention). On x [M, n, S, B], with h heads of width
// d = B / h, attention runs across the n chunks at each in-chunk position s:
//
//   qkv = round(LN(x) @ W_qkv)                         f32 LN statistics
//   per (m, s, head): p = softmax(q k^T / sqrt(d) + bias[key chunk, s])
//                     a = round(round(p) @ v)          softmax in f32
//   out = x + round(a @ W_out)
//
// The bias is the additive key mask (0 valid, -1e9 padded frame) in f32,
// indexed [key chunk, position]: with n=1 and K < S every key at s >= K is
// masked, and the row's softmax is uniform, as in the reference.
//
// What bounds it on the card. At the DPT quality default (B=256, h=8, d=32,
// S=128) and B=8 x 4 s (n=25) the sublayer is 14.1 GFLOP (QKV 10.1, out
// 3.4, scores and mix 0.7): 14 us at 989 TFLOP/s, against 26.2 MB of x in
// and out (7.8 us at 3.35 TB/s): compute-bound. Launches 1 and 3 are the
// intra sublayer's (dpt_common.cuh); the core between them is tiny
// (25 x 25 per (m, s, head)) and strided by S*3B in memory, and n varies
// with the input (15 s gives n=94). So one block per (m, s) stages the k and
// v rows of all heads for up to 32 key chunks at a time in shared memory,
// and each warp takes one head with one query chunk per lane: pass 1 runs
// the key tiles for the row's max and softmax denominator (online), pass 2
// recomputes each score, rounds p = exp(score - max) / sum to the compute
// dtype and accumulates p v in f32. Two passes keep the reference's
// rounding of the normalised p and take any n >= 1; with n <= 32 the key
// tile is loaded once. The qkv round trip (78.6 MB in bf16) is the design's
// cost over the bound.
//
// Under tensor parallelism (partial, the Pallas kernel's partial=True) the
// block runs the h heads of one shard's head group, of width Bq = h * d:
// qkv and a are [R, 3Bq] and [R, Bq], and the last launch writes
// round(a @ W_out[Bq, B]) with no residual. At the quality default's m = 2
// shards (Bq 128, 4 heads) that is 7.0 GFLOP, under the 7.8 us of x in and
// out: bytes-bound.

#include "dpt_common.cuh"

namespace {

constexpr int kKeyTile = 32;   // key chunks staged per shared-memory load

template <typename T>
size_t core_smem(int Bq) {
  return align128(static_cast<size_t>(kKeyTile) * 2 * Bq * sizeof(T)) +
         kKeyTile * sizeof(float);
}

// Grid (S, M); 32 * h threads, warp = head. B below is the heads' width
// Bq: the rows of qkv hold 3Bq values, those of a Bq.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    inter_core_kernel(DptAttnParams p, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  const int n = p.n, S = p.S, B = p.Bq;
  T* kv_s = reinterpret_cast<T*>(smem);
  float* b_s = reinterpret_cast<float*>(
      smem + align128(static_cast<size_t>(kKeyTile) * 2 * B * sizeof(T)));
  const int s = blockIdx.x, m = blockIdx.y;
  const int lane = threadIdx.x & 31, hd = threadIdx.x >> 5;
  const size_t stride = static_cast<size_t>(S) * 3 * B;  // chunk to chunk
  const T* base = static_cast<const T*>(p.qkv) +
                  (static_cast<size_t>(m) * n * S + s) * 3 * B;
  const bool one_tile = n <= kKeyTile;

  // k and v (columns B..3B) of key chunks k0..k0+kt, and their biases
  auto load_tile = [&](int k0, int kt) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < kt * (2 * B / V); e += blockDim.x) {
      const int j = e / (2 * B / V);
      const int col = (e % (2 * B / V)) * V;
      *reinterpret_cast<uint4*>(&kv_s[j * 2 * B + col]) =
          *reinterpret_cast<const uint4*>(base + (k0 + j) * stride + B + col);
    }
    for (int j = threadIdx.x; j < kt; j += blockDim.x)
      b_s[j] = p.bias ? p.bias[static_cast<size_t>(k0 + j) * S + s] : 0.f;
    __syncthreads();
  };
  // D values of T from 16-byte loads into f32
  auto load_row = [](const T* src, float* dst) {
#pragma unroll
    for (int t = 0; t < D; t += V) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + t);
      const T* vals = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < V; ++e) dst[t + e] = to_f<T>(vals[e]);
    }
  };
  auto score = [&](const float* q, int j) {
    float k[D];
    load_row(kv_s + j * 2 * B + hd * D, k);
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < D; ++t) dot = fmaf(q[t], k[t], dot);
    return dot * scale + b_s[j];
  };

  for (int q0 = 0; q0 < n; q0 += 32) {
    const int qc = q0 + lane;
    const bool valid = qc < n;
    float q[D];
    load_row(base + static_cast<size_t>(valid ? qc : 0) * stride + hd * D, q);

    float mx = -INFINITY, sum = 0.f;
    for (int k0 = 0; k0 < n; k0 += kKeyTile) {
      const int kt = min(kKeyTile, n - k0);
      load_tile(k0, kt);
      for (int j = 0; j < kt; ++j) {
        const float sc = score(q, j);
        const float mn = fmaxf(mx, sc);
        sum = sum * expf(mx - mn) + expf(sc - mn);
        mx = mn;
      }
    }

    float acc[D];
#pragma unroll
    for (int t = 0; t < D; ++t) acc[t] = 0.f;
    for (int k0 = 0; k0 < n; k0 += kKeyTile) {
      const int kt = min(kKeyTile, n - k0);
      if (!one_tile) load_tile(k0, kt);
      for (int j = 0; j < kt; ++j) {
        const float w = round_to<T>(expf(score(q, j) - mx) / sum);
        float v[D];
        load_row(kv_s + j * 2 * B + B + hd * D, v);
#pragma unroll
        for (int t = 0; t < D; ++t) acc[t] = fmaf(w, v[t], acc[t]);
      }
    }
    if (valid) {
      T* dst = static_cast<T*>(p.a) +
               ((static_cast<size_t>(m) * n + qc) * S + s) * B + hd * D;
#pragma unroll
      for (int t = 0; t < D; t += V) {
        alignas(16) T vals[V];
#pragma unroll
        for (int e = 0; e < V; ++e) vals[e] = from_f<T>(acc[t + e]);
        *reinterpret_cast<uint4*>(dst + t) =
            *reinterpret_cast<const uint4*>(vals);
      }
    }
  }
}

template <typename T, int D>
int launch_core(const DptAttnParams& p, cudaStream_t stream) {
  const size_t smem = core_smem<T>(p.Bq);
  cudaError_t err = cudaFuncSetAttribute(
      inter_core_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  inter_core_kernel<T, D><<<dim3(p.S, p.M), 32 * p.h, smem, stream>>>(p,
                                                                     scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const DptAttnParams& p, cudaStream_t stream) {
  const int d = p.Bq / p.h;
  if ((d != 32 && d != 64) || p.h > 8 || p.Bq % 64 || p.Bq > p.B)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention<T>(p, stream, [d](const DptAttnParams& q,
                                            cudaStream_t s) {
    return d == 32 ? launch_core<T, 32>(q, s) : launch_core<T, 64>(q, s);
  });
}

}  // namespace

extern "C" {

// One inter-chunk attention sublayer (operands: DptAttnParams in
// dpt_common.cuh); returns the first CUDA error of its three launches.
int ctn_dpt_inter_f32(CTN_DPT_ATTN_ARGS) {
  return launch<float>(CTN_DPT_ATTN_PARAMS, static_cast<cudaStream_t>(stream));
}

int ctn_dpt_inter_bf16(CTN_DPT_ATTN_ARGS) {
  return launch<__nv_bfloat16>(CTN_DPT_ATTN_PARAMS,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
