// The dual-path intra-chunk attention sublayer forward for Hopper (sm_90a),
// bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/dpt_intra.py::_intra_kernel (wrapper
// fused_intra_attention). On x [M, n, S, B] (n chunks of S frames), with h
// heads of width d = B / h:
//
//   qkv = round(LN(x) @ W_qkv)                         f32 LN statistics
//   per (m, chunk, head): p = softmax(q k^T / sqrt(d) + bias[chunk, key])
//                         a = round(round(p) @ v)      softmax in f32
//   out = x + round(a @ W_out)
//
// The bias is the additive key mask (0 valid, -1e9 padded frame) in f32,
// added after the scale: a padded key gets ~0 weight, and a row whose keys
// are all padded gets a uniform softmax, as in the reference.
//
// What bounds it on the card. At the DPT quality default (B=256, h=8, d=32,
// S=128) and B=8 x 4 s (n=25 chunks) the sublayer is 16.8 GFLOP (QKV 10.1,
// scores and mix 3.4, out 3.4): 17 us at 989 TFLOP/s, against 26.2 MB of x
// in and out (7.8 us at 3.35 TB/s): compute-bound. The Pallas kernel kept a
// chunk tile's [ct*S, 3B] qkv in VMEM; an SM has 227 KB, so the sublayer is
// three launches:
//   1. ln_qkv_kernel (dpt_common.cuh): LN + the QKV product per 64-row tile,
//      qkv [M*n*S, 3B] to device memory;
//   2. intra_core_kernel (here): one block per (m, chunk, head) loads that
//      head's q, k, v [S, d] into shared memory; each warp takes 16 query
//      rows: scores [16, S] in f32 (WMMA for bf16), the masked softmax in
//      f32 (two lanes per row), p rounded to the compute dtype, then p @ v;
//   3. out_proj_residual_kernel (dpt_common.cuh): the out product + x.
// The qkv round trip (78.6 MB in bf16, ~23 us) and a's (26.2 MB) are the
// design's cost over the bound. Fusing 2 and 3, pipelined loads and wgmma
// are the next steps when this kernel is made fast.
//
// Under tensor parallelism (partial, the Pallas kernel's partial=True) the
// sublayer runs the h heads of one shard's head group, of width
// Bq = h * d: qkv and a are [R, 3Bq] and [R, Bq], and launch 3 writes
// round(a @ W_out[Bq, B]) with no residual (dpt_common.cuh). At the quality
// default's m = 2 shards (Bq 128, 4 heads) that is 8.4 GFLOP, 8.5 us at
// 989 TFLOP/s, against 7.8 us of x in and out.
//
// Where the three [S, d] tiles do not fit in shared memory beside the
// per-warp scratch (f32 with a head width of 64 above S=176: 200 KB of
// them alone at S=256), they go to a device workspace after the `a`
// workspace instead, one set per (m, chunk, head) block in the same
// layout (ctn_dpt_intra_workspace gives its size); every value and every
// order of summation is as in shared memory.

#include "dpt_common.cuh"

namespace {

constexpr int kCoreWarps = 4;

// Leading dimensions of the per-head q, k, v tiles: the WMMA pad for bf16;
// for f32 an odd stride, so the transposed k reads of warp_mm hit distinct
// banks.
template <typename T, int D>
__host__ __device__ constexpr int head_ld() {
  return kIsBf16<T> ? padded<T>(D) : D + 1;
}

// Bytes of one of the q, k, v [S, d] tiles.
template <typename T, int D>
__host__ __device__ constexpr size_t head_bytes(int S) {
  return align128(static_cast<size_t>(S) * head_ld<T, D>() * sizeof(T));
}

// Shared memory of the core; with `spill` the q, k, v tiles live in the
// device workspace instead.
template <typename T, int D>
constexpr size_t core_smem(int S, bool spill) {
  const int w = (S > D ? S : D) + 4;
  return (spill ? 0 : 3 * head_bytes<T, D>(S)) +
         align128(static_cast<size_t>(S) * sizeof(float)) +
         kCoreWarps *
             (align128(static_cast<size_t>(16) * w * sizeof(float)) +
              align128(static_cast<size_t>(16) * padded<T>(S) * sizeof(T)));
}

constexpr size_t kMaxCoreSmem = 232448;   // an H100 block's opt-in limit

// Grid (n, M, h); kCoreWarps warps. S % 16 == 0. spill: null, or the
// device workspace of the q, k, v tiles, 3 head_bytes per block.
template <typename T, int D>
__global__ void __launch_bounds__(kCoreWarps * 32)
    intra_core_kernel(DptAttnParams p, float scale, unsigned char* spill) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  constexpr int ldq = head_ld<T, D>();
  const int S = p.S, B = p.Bq;   // the heads' width: qkv rows hold 3Bq
  const int ldc = (S > D ? S : D) + 4;
  const int ldp = padded<T>(S);
  const int chunk = blockIdx.x, m = blockIdx.y, hd = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const size_t tile = head_bytes<T, D>(S);
  unsigned char* heads = smem;
  unsigned char* rest = smem + 3 * tile;
  if (spill) {
    heads = spill +
            ((static_cast<size_t>(m) * gridDim.x + chunk) * gridDim.z + hd) *
                3 * tile;
    rest = smem;
  }
  T* q_s = reinterpret_cast<T*>(heads);
  T* k_s = reinterpret_cast<T*>(heads + tile);
  T* v_s = reinterpret_cast<T*>(heads + 2 * tile);
  float* b_s = reinterpret_cast<float*>(rest);
  unsigned char* scratch =
      rest + align128(static_cast<size_t>(S) * sizeof(float));
  const size_t c_bytes = align128(static_cast<size_t>(16) * ldc * sizeof(float));
  const size_t p_bytes = align128(static_cast<size_t>(16) * ldp * sizeof(T));
  float* c_s = reinterpret_cast<float*>(scratch + warp * (c_bytes + p_bytes));
  T* p_s = reinterpret_cast<T*>(scratch + warp * (c_bytes + p_bytes) + c_bytes);

  const size_t row0 = (static_cast<size_t>(m) * p.n + chunk) * S;
  const T* qkv = static_cast<const T*>(p.qkv);
  // this head's q, k, v rows of the chunk, 16 bytes per load
  for (int e = threadIdx.x; e < 3 * S * (D / V); e += blockDim.x) {
    const int part = e / (S * (D / V));
    const int i = (e / (D / V)) % S;
    const int j = (e % (D / V)) * V;
    const uint4 val = *reinterpret_cast<const uint4*>(
        qkv + (row0 + i) * 3 * B + part * B + hd * D + j);
    const T* vals = reinterpret_cast<const T*>(&val);
    T* dst = (part == 0 ? q_s : part == 1 ? k_s : v_s) + i * ldq + j;
#pragma unroll
    for (int t = 0; t < V; ++t) dst[t] = vals[t];
  }
  for (int k = threadIdx.x; k < S; k += blockDim.x)
    b_s[k] = p.bias ? p.bias[static_cast<size_t>(chunk) * S + k] : 0.f;
  __syncthreads();

  T* a = static_cast<T*>(p.a);
  for (int g = warp; g < S / 16; g += kCoreWarps) {
    warp_mm<T, true>(q_s + g * 16 * ldq, ldq, k_s, ldq, D, S, c_s, ldc);
    {  // the 16 rows' softmax at once: two lanes per row, every other key
      const int r = lane >> 1;
      float* row = c_s + r * ldc;
      float mx = -INFINITY;
      for (int k = lane & 1; k < S; k += 2) {
        const float s = row[k] * scale + b_s[k];
        row[k] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      float sum = 0.f;
      for (int k = lane & 1; k < S; k += 2) {
        const float e = expf(row[k] - mx);
        row[k] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      for (int k = lane & 1; k < S; k += 2)
        p_s[r * ldp + k] = from_f<T>(row[k] / sum);
    }
    __syncwarp();
    warp_mm<T, false>(p_s, ldp, v_s, ldq, S, D, c_s, ldc);
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = e / D;
      const int j = e % D;
      a[(row0 + g * 16 + r) * B + hd * D + j] = from_f<T>(c_s[r * ldc + j]);
    }
    __syncwarp();
  }
}

// Elements of T the spilled q, k, v tiles take after the `a` workspace's
// R * Bq (0 where they fit in shared memory); -1 where nothing fits.
template <typename T, int D>
long long spill_elems(int M, int n, int S, int h) {
  if (core_smem<T, D>(S, false) <= kMaxCoreSmem) return 0;
  if (core_smem<T, D>(S, true) > kMaxCoreSmem) return -1;
  return static_cast<long long>(M) * n * h * 3 * head_bytes<T, D>(S) /
         sizeof(T);
}

template <typename T, int D>
int launch_core(const DptAttnParams& p, cudaStream_t stream) {
  const bool spill = core_smem<T, D>(p.S, false) > kMaxCoreSmem;
  const size_t smem = core_smem<T, D>(p.S, spill);
  if (smem > kMaxCoreSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      intra_core_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  unsigned char* ws = reinterpret_cast<unsigned char*>(
      static_cast<T*>(p.a) + p.R * p.Bq);
  intra_core_kernel<T, D><<<dim3(p.n, p.M, p.h), kCoreWarps * 32, smem,
                            stream>>>(p, scale, spill ? ws : nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const DptAttnParams& p, cudaStream_t stream) {
  const int d = p.Bq / p.h;
  if ((d != 32 && d != 64) || p.Bq % 64 || p.Bq > p.B)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention<T>(p, stream, [d](const DptAttnParams& q,
                                            cudaStream_t s) {
    return d == 32 ? launch_core<T, 32>(q, s) : launch_core<T, 64>(q, s);
  });
}

}  // namespace

extern "C" {

// Elements of the compute dtype (elem_bytes 2 for bf16, 4 for f32) the
// intra forward needs after the R * Bq of its `a` workspace for its spilled
// q, k, v tiles: 0 where they fit in shared memory, -1 where the core fits
// no way. B here is the heads' width Bq = h * d.
int ctn_dpt_intra_workspace(int M, int n, int S, int B, int h, int elem_bytes,
                            long long* n_spill) {
  if (h <= 0 || B % h) return static_cast<int>(cudaErrorInvalidValue);
  const int d = B / h;
  if (d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 2)
    *n_spill = d == 32 ? spill_elems<__nv_bfloat16, 32>(M, n, S, h)
                       : spill_elems<__nv_bfloat16, 64>(M, n, S, h);
  else
    *n_spill = d == 32 ? spill_elems<float, 32>(M, n, S, h)
                       : spill_elems<float, 64>(M, n, S, h);
  return 0;
}

// One intra-chunk attention sublayer (operands: DptAttnParams in
// dpt_common.cuh; the `a` workspace holds R * Bq elements plus what
// ctn_dpt_intra_workspace gives); returns the first CUDA error of its three
// launches.
int ctn_dpt_intra_f32(CTN_DPT_ATTN_ARGS) {
  return launch<float>(CTN_DPT_ATTN_PARAMS, static_cast<cudaStream_t>(stream));
}

int ctn_dpt_intra_bf16(CTN_DPT_ATTN_ARGS) {
  return launch<__nv_bfloat16>(CTN_DPT_ATTN_PARAMS,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
