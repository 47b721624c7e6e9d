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
// three launches, with qkv (78.6 MB in bf16) and a (26.2 MB) through device
// memory between them.
//
// bf16: the forward frame of dpt_attn_bwd_wg.cuh (launch_attention_fwd_wg),
// with this kernel's gather (the S rows of one chunk, the key bias per
// (chunk, key)):
//   F1  LQ's template without its dA product and its y and statistics
//       writes: per 128-row tile, x resident K-major, the LN in place,
//       qkv = round(y @ W_qkv) on wgmma in 128-column tiles (64 where Bq is
//       not a multiple of 128), W_qkv MN-major through a ring: 164 KB and
//       one CTA per SM at 128 wide, 108 KB and two at 64 wide (200 tiles);
//   C   the query side of the attention core (passes 1 and 2, shared with
//       the backward's attn_bwd_core_kernel): a CTA per (m, chunk, head)
//       of up to four warps, a warp per 16 query rows with its q fragments
//       in registers, k and v staged in blocks of up to 256 keys; pass 1
//       the row max and denominator, pass 2 p, round(p) and a on
//       mma.sync. No [S, S] or [16, S] tile exists, so any S runs in the
//       same shared memory (26 KB at S = 128, d = 32);
//   out x + round(a @ W_out) on wgmma per 128-row tile (rows_wg_kernel),
//       a's panels and W_out's MN-major slabs through a ring, x's tile and
//       the output staged over the ring after the product.
// Above B = 256 (to 512) F1 keeps one resident tile with a ring of 3 (4 at
// 64 wide) and out runs 256-column tiles (dpt_attn_bwd_wg.cuh's note);
// the core is per head and unchanged.
// Registers (ptxas, sm_90a): F1 146 (88 at 64 wide), the core 47, 56, 96
// and 128 at d = 16, 32, 64 and 128, out 182 at a 256-wide tile; no
// spills. Waves: F1 and out
// 200 tiles of 128 rows (F1 at 64 wide two per SM, one wave), the core
// 1600 CTAs of four warps, several per SM.
// The core and out are not fused: a's round trip is 26 MB written and read
// (~8 us at 3.35 TB/s), and a fused CTA would hold one chunk's rows for
// all heads. What stands over the bound: F1 and out at one CTA per SM in
// 1.52 waves, the core on mma.sync (its scores twice, 52 M exponentials)
// and the qkv and a round trips.
//
// f32: the first design, three launches: ln_qkv_kernel (dpt_common.cuh,
// FMA products); intra_core_kernel (here): one block per (m, chunk, head)
// loads that head's q, k, v [S, d] into shared memory, each warp takes 16
// query rows, scores [16, S] in f32 by FMA (warp_mm), the masked softmax
// (two lanes per row), p, then p @ v; out_proj_residual_kernel
// (dpt_common.cuh). Head widths 16, 32, 64 and 128 (warp_mm at 16 runs
// half a warp's lanes). Where the three [S, d] tiles do not fit in shared
// memory beside the per-warp scratch (a head width of 64 above S=176:
// 200 KB of them alone at S=256; 128 from S=112 up, 198 KB of them at
// S=128), they go to a device workspace after the `a` workspace instead,
// one set per (m, chunk, head) block in the same layout
// (ctn_dpt_intra_workspace gives its size); every value and every order of
// summation is as in shared memory. The first design runs S <= 256.
//
// f32 above 256 frames: the per-warp [16, S] rows and the [S, d] tiles
// would not fit, so the core launch takes the row-statistics core of
// dpt_intra_rowstat.cuh instead (ln_qkv_kernel and out_proj_residual_kernel
// around it as above): one CTA of four warps per (m, chunk, head), the
// keys' k and v staged as f32 in blocks of 4096 / d rows, a warp per 16
// query rows, pass 1 the online row max and denominator (per lane, then a
// butterfly), pass 2 p and a by FMA; no [16, S] or [S, S] tile, so its
// shared memory is fixed by d (65-118 KB), and it needs no workspace past
// `a`. Registers (ptxas, sm_90a): 96, 96, 95 and 145 at d = 16, 32, 64
// and 128, no spills. Waves at [8, 7, 512, 256], d = 32: 448 CTAs of 71
// KB, three per SM by shared memory, 1.13 waves. What stands over the
// bound: q k^T computed twice, the dot products and the mix fed from
// shared memory (a float4 broadcast per four FMAs of a row), and S / 16
// query tiles on four warps re-walking every staged key block.
//
// Under tensor parallelism (partial, the Pallas kernel's partial=True) the
// sublayer runs the h heads of one shard's head group, of width
// Bq = h * d: qkv and a are [R, 3Bq] and [R, Bq], and the out launch
// writes round(a @ W_out[Bq, B]) with no residual. At the quality
// default's m = 2 shards (Bq 128, 4 heads) that is 8.4 GFLOP, 8.5 us at
// 989 TFLOP/s, against 7.8 us of x in and out.

#include "dpt_attn_wide_head.cuh"
#include "dpt_intra_rowstat.cuh"

namespace {

constexpr int kCoreWarps = 4;

// Leading dimension of the per-head q, k, v tiles: an odd stride, so the
// transposed k reads of warp_mm hit distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int head_ld() {
  return D + 1;
}

// Bytes of one of the q, k, v [S, d] tiles.
template <typename T, int D>
__host__ __device__ constexpr size_t head_bytes(int S) {
  return align128(static_cast<size_t>(S) * head_ld<T, D>() * sizeof(T));
}

// Shared memory of the core; with `spill` the q, k, v tiles live in the
// device workspace instead.
template <typename T, int D>
constexpr size_t intra_core_smem(int S, bool spill) {
  const int w = (S > D ? S : D) + 4;
  return (spill ? 0 : 3 * head_bytes<T, D>(S)) +
         align128(static_cast<size_t>(S) * sizeof(float)) +
         kCoreWarps *
             (align128(static_cast<size_t>(16) * w * sizeof(float)) +
              align128(static_cast<size_t>(16) * padded<T>(S) * sizeof(T)));
}

constexpr size_t kMaxCoreSmem = 232448;   // an H100 block's opt-in limit

// The f32 core (the first design). Grid (n, M, h); kCoreWarps warps.
// S % 16 == 0. spill: null, or the device workspace of the q, k, v tiles,
// 3 head_bytes per block.
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
  if (intra_core_smem<T, D>(S, false) <= kMaxCoreSmem) return 0;
  if (intra_core_smem<T, D>(S, true) > kMaxCoreSmem) return -1;
  return static_cast<long long>(M) * n * h * 3 * head_bytes<T, D>(S) /
         sizeof(T);
}

template <typename T, int D>
int launch_core(const DptAttnParams& p, cudaStream_t stream, float scale) {
  const bool spill = intra_core_smem<T, D>(p.S, false) > kMaxCoreSmem;
  const size_t smem = intra_core_smem<T, D>(p.S, spill);
  if (smem > kMaxCoreSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      intra_core_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned char* ws = reinterpret_cast<unsigned char*>(
      static_cast<T*>(p.a) + p.R * p.Bq);
  intra_core_kernel<T, D><<<dim3(p.n, p.M, p.h), kCoreWarps * 32, smem,
                            stream>>>(p, scale, spill ? ws : nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The f32 core for the padded head width D = Bq / h (core_head_width),
// with the real width's softmax scale: the first design at S <= 256, the
// row-statistics core above.
template <typename T>
int launch_core_d(const DptAttnParams& p, cudaStream_t stream, float scale) {
  if (p.S > kFirstDesignMaxS)
    return launch_rs_core_d<false>(p, nullptr, nullptr, nullptr, stream,
                                   scale);
  switch (p.Bq / p.h) {
    case 16: return launch_core<T, 16>(p, stream, scale);
    case 32: return launch_core<T, 32>(p, stream, scale);
    case 64: return launch_core<T, 64>(p, stream, scale);
    case 128: return launch_core<T, 128>(p, stream, scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// d: the heads' real width (its scale); above a padded width of 128 the
// core is the route of dpt_attn_wide_head.cuh, in `wide`, at any S.
template <typename T>
int launch(const DptAttnParams& p, cudaStream_t stream, int d, float* wide) {
  if (p.Bq % 64 || p.Bq > p.B || !attn_head_widths_ok(p.Bq, p.h, d) ||
      p.Bn < 1 || p.Bn > p.B)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = attn_scale(d);
  auto core = [=](const DptAttnParams& q, cudaStream_t s) {
    if (q.Bq / q.h > kCoreMaxD)
      return launch_wide_head_fwd<T, false>(q, wide, scale, s);
    if constexpr (kIsBf16<T>)
      return launch_fwd_core_d<false>(q, s, scale);
    else
      return launch_core_d<T>(q, s, scale);
  };
  if constexpr (kIsBf16<T>)
    return launch_attention_fwd_wg(p, stream, core);
  else
    return launch_attention<T>(p, stream, core);
}

}  // namespace

extern "C" {

// Elements of the compute dtype (elem_bytes 2 for bf16, 4 for f32) the
// intra forward needs after the R * Bq of its `a` workspace for its spilled
// q, k, v tiles: 0 where they fit in shared memory (always in bf16, whose
// core keeps no per-head tile, and in f32 above S = 256, whose
// row-statistics core keeps none either, and above a head width of 128,
// whose route keeps its logits in `wide`), -1 where the f32 core fits no
// way. B here is the heads' padded width Bq = h * D.
int ctn_dpt_intra_workspace(int M, int n, int S, int B, int h, int elem_bytes,
                            long long* n_spill) {
  if (h <= 0 || B % h) return static_cast<int>(cudaErrorInvalidValue);
  const int d = B / h;
  if (d > kCoreMaxD) {   // the route beside the cores: its own workspace
    if (d % 64) return static_cast<int>(cudaErrorInvalidValue);
    *n_spill = 0;
    return 0;
  }
  if (elem_bytes == 2) {
    if (!core_head_width(d)) return static_cast<int>(cudaErrorInvalidValue);
    *n_spill = 0;
    return 0;
  }
  if (S > kFirstDesignMaxS) {   // the row-statistics core keeps no tile
    if (!core_head_width(d)) return static_cast<int>(cudaErrorInvalidValue);
    *n_spill = 0;
    return 0;
  }
  switch (d) {
    case 16: *n_spill = spill_elems<float, 16>(M, n, S, h); return 0;
    case 32: *n_spill = spill_elems<float, 32>(M, n, S, h); return 0;
    case 64: *n_spill = spill_elems<float, 64>(M, n, S, h); return 0;
    case 128: *n_spill = spill_elems<float, 128>(M, n, S, h); return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One intra-chunk attention sublayer (operands: DptAttnParams in
// dpt_common.cuh; the `a` workspace holds R * Bq elements plus what
// ctn_dpt_intra_workspace gives); returns the first CUDA error of its three
// launches. Either dtype takes any S (f32 a multiple of 16: the wrapper
// pads), f32 above 256 on the row-statistics core; d and wide as in
// CTN_DPT_ATTN_ARGS.
int ctn_dpt_intra_f32(CTN_DPT_ATTN_ARGS) {
  return launch<float>(CTN_DPT_ATTN_PARAMS, static_cast<cudaStream_t>(stream),
                       d, static_cast<float*>(wide));
}

int ctn_dpt_intra_bf16(CTN_DPT_ATTN_ARGS) {
  return launch<__nv_bfloat16>(CTN_DPT_ATTN_PARAMS,
                               static_cast<cudaStream_t>(stream), d,
                               static_cast<float*>(wide));
}

}  // extern "C"
