// The dual-path intra-chunk attention sublayer backward for Hopper
// (sm_90a), bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/dpt_intra.py::_intra_bwd_kernel
// (wrapper fused_intra_attention_bwd). From the sublayer input x and the
// cotangent g of its output it returns dx, dgamma, dbeta, dW_qkv and dW_out,
// recomputing the forward from x (only the primals are saved, as the JAX
// rule _fused_intra_fwd does). Per (m, chunk, head), with d = B / h and
// scale = 1 / sqrt(d):
//
//   p  = softmax(q k^T * scale + bias[chunk, key])      f32
//   a  = round(round(p) v)                              for dW_out
//   dA = round(g W_out^T);  dp = dA v^T                 f32
//   dv = round(round(p)^T dA)
//   ds = round(p * (dp - rowsum(p * dp)) * scale)
//   dq = round(ds k);  dk = round(ds^T q)
//
// then dW_qkv = y^T dqkv, dW_out = a^T g, dy = dqkv W_qkv^T in f32 and the
// LN backward with the residual (dpt_bwd_common.cuh). The key bias applies
// to keys only: a padded query row is computed like any other and carries
// no meaning.
//
// What bounds it on the card. At the DPT quality default (B=256, h=8, d=32,
// S=128) and B=8 x 4 s (n=25, R = 25,600 rows) the backward is 47.0 GFLOP
// (11 projection products of 2 R B^2, QKV recomputed, and 6 core products
// of 2 R S B): 47 us at 989 TFLOP/s, against 39 MB of x, g and dx (12 us
// at 3.35 TB/s): compute-bound. The Pallas kernel kept a chunk's [S, S] probabilities and
// its dqkv in VMEM. Here the core (intra_bwd_core_kernel) takes one block
// per (m, chunk, head): q, k, v and dA [S, d] in shared memory, then each
// warp takes 16 query rows: the scores by WMMA (FMA for f32), the softmax
// in f32 in the forward's order, round(p) and ds into two [S, S] shared
// tiles, a and dq out; after a block barrier each warp takes 16 key rows:
// dv and dk from the transposed tiles (warp_mm with kAT). About 175 KB of
// shared memory in bf16 and 208 KB in f32 at S=128, so one block per SM.
// Where the two [S, S] tiles do not fit beside the rest (S > 128 in bf16:
// 270 KB of them alone at S=256), they go to a device workspace instead,
// one pair of tiles per (m, chunk, head) block, 270 KB each at S=256 in
// bf16 (225 MB at B=8 x 4 s), and the block runs with as many warps (4, 2
// or 1) as its per-warp scratch rows leave room for; every value and every
// order of summation is as in shared memory. Where even that does not fit
// (f32 with a head width of 64 above S=208: its four [S, d] tiles alone
// take 266 KB at S=256), the q, k, v and dA tiles go to the workspace too,
// after the block's two [S, S] tiles and in the same layout, and the block
// runs with four warps. The round trips of qkv, dA, a, dqkv and dy through
// device memory are the design's cost over the bound.
//
// Under tensor parallelism (partial, the backward of the Pallas kernel's
// partial=True) the core runs one shard's h heads of width Bq = h * d
// (qkv, dqkv [R, 3Bq], dA and a [R, Bq]), the products take Bq
// (dpt_bwd_common.cuh) and dx has no g term.

#include "dpt_bwd_common.cuh"

namespace {

constexpr int kCoreWarps = 4;

template <typename T, int D>
__host__ __device__ constexpr int head_ld() {
  return kIsBf16<T> ? padded<T>(D) : D + 1;
}

// Leading dimension of the [S, S] probability and score-cotangent tiles.
template <typename T>
__host__ __device__ constexpr int pmat_ld(int S) {
  return kIsBf16<T> ? padded<T>(S) : S + 4;
}

// Leading dimension of a warp's f32 scratch rows.
__host__ __device__ constexpr int scratch_ld(int S, int D) {
  return (S > D ? S : D) + 4;
}

// Per-warp scratch: bf16 keeps the f32 p and dp of its 16 rows here; f32
// keeps them in the [S, S] tiles themselves and needs only an output tile.
template <typename T, int D>
__host__ __device__ constexpr size_t warp_scratch(int S) {
  return kIsBf16<T>
             ? 2 * align128(static_cast<size_t>(16) * scratch_ld(S, D) * 4)
             : align128(static_cast<size_t>(16) * (D + 4) * 4);
}

// Bytes of one of the q, k, v, dA [S, d] tiles.
template <typename T, int D>
__host__ __device__ constexpr size_t head_bytes(int S) {
  return align128(static_cast<size_t>(S) * head_ld<T, D>() * sizeof(T));
}

// Bytes of one [S, S] tile of round(p) or ds.
template <typename T>
__host__ __device__ constexpr size_t pmat_bytes(int S) {
  return align128(static_cast<size_t>(S) * pmat_ld<T>(S) * sizeof(T));
}

// Shared memory of the core with `warps` warps; with `spill` the two
// [S, S] tiles live in the device workspace instead, with `heads` the four
// [S, d] tiles too.
template <typename T, int D>
__host__ __device__ constexpr size_t core_bwd_smem(int S, bool spill,
                                                   int warps,
                                                   bool heads = false) {
  return (heads ? 0 : 4 * head_bytes<T, D>(S)) +
         align128(static_cast<size_t>(S) * sizeof(float)) +
         (spill ? 0 : 2 * pmat_bytes<T>(S)) + warps * warp_scratch<T, D>(S);
}

constexpr size_t kMaxCoreSmem = 232448;   // an H100 block's opt-in limit

// How the core runs at chunk length S: the [S, S] tiles in shared memory
// with kCoreWarps warps where they fit, else spilled with the most warps
// that fit, else the [S, d] tiles spilled too with kCoreWarps warps; warps
// 0 if nothing fits.
struct CoreCfg {
  bool spill;
  bool heads;
  int warps;
  size_t smem;
};

template <typename T, int D>
CoreCfg core_cfg(int S) {
  if (core_bwd_smem<T, D>(S, false, kCoreWarps) <= kMaxCoreSmem)
    return {false, false, kCoreWarps,
            core_bwd_smem<T, D>(S, false, kCoreWarps)};
  for (int w = kCoreWarps; w >= 1; w /= 2)
    if (core_bwd_smem<T, D>(S, true, w) <= kMaxCoreSmem)
      return {true, false, w, core_bwd_smem<T, D>(S, true, w)};
  if (core_bwd_smem<T, D>(S, true, kCoreWarps, true) <= kMaxCoreSmem)
    return {true, true, kCoreWarps,
            core_bwd_smem<T, D>(S, true, kCoreWarps, true)};
  return {true, false, 0, 0};
}

// Workspace bytes of one block's spilled tiles under c.
template <typename T, int D>
size_t spill_block_bytes(const CoreCfg& c, int S) {
  return 2 * pmat_bytes<T>(S) + (c.heads ? 4 * head_bytes<T, D>(S) : 0);
}

// Grid (n, M, h); blockDim.x / 32 warps. S % 16 == 0. spill: null, or the
// device workspace of the [S, S] tiles, 2 pmat_bytes per block, followed
// with `heads` by the block's four [S, d] tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kCoreWarps * 32)
    intra_bwd_core_kernel(DptAttnBwdParams P, float scale,
                          unsigned char* spill, bool heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  constexpr int ldq = head_ld<T, D>();
  const DptAttnParams& p = P.f;
  const int S = p.S, B = p.Bq;   // the heads' width: qkv rows hold 3Bq
  const int ldp = pmat_ld<T>(S);
  const int lds = scratch_ld(S, D);
  const int chunk = blockIdx.x, m = blockIdx.y, hd = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  const size_t head = head_bytes<T, D>(S);
  const size_t pm = pmat_bytes<T>(S);
  unsigned char* hbase = smem;              // the four [S, d] tiles
  unsigned char* tail = smem + 4 * head;    // the bias row, then the rest
  unsigned char* at = nullptr;              // the two [S, S] tiles
  if (spill) {
    const size_t blk =
        (static_cast<size_t>(m) * gridDim.x + chunk) * gridDim.z + hd;
    at = spill + blk * (2 * pm + (heads ? 4 * head : 0));
    if (heads) {
      hbase = at + 2 * pm;
      tail = smem;
    }
  }
  T* q_s = reinterpret_cast<T*>(hbase);
  T* k_s = reinterpret_cast<T*>(hbase + head);
  T* v_s = reinterpret_cast<T*>(hbase + 2 * head);
  T* da_s = reinterpret_cast<T*>(hbase + 3 * head);
  float* b_s = reinterpret_cast<float*>(tail);
  tail += align128(static_cast<size_t>(S) * sizeof(float));
  if (!spill) {
    at = tail;
    tail += 2 * pm;
  }
  T* p_s = reinterpret_cast<T*>(at);         // round(p), then [S, S] of p
  T* ds_s = reinterpret_cast<T*>(at + pm);   // ds (f32: dp first)
  unsigned char* ws = tail + warp * warp_scratch<T, D>(S);
  float* w0 = reinterpret_cast<float*>(ws);
  float* w1 = reinterpret_cast<float*>(
      ws + align128(static_cast<size_t>(16) * lds * 4));

  const size_t row0 = (static_cast<size_t>(m) * p.n + chunk) * S;
  const T* qkv = static_cast<const T*>(p.qkv);
  const T* dA = static_cast<const T*>(P.dA);
  // this head's q, k, v and dA rows of the chunk, 16 bytes per load
  for (int e = threadIdx.x; e < 4 * S * (D / V); e += blockDim.x) {
    const int part = e / (S * (D / V));
    const int i = (e / (D / V)) % S;
    const int j = (e % (D / V)) * V;
    const T* src = part < 3 ? qkv + (row0 + i) * 3 * B + part * B + hd * D + j
                            : dA + (row0 + i) * B + hd * D + j;
    const uint4 val = *reinterpret_cast<const uint4*>(src);
    const T* vals = reinterpret_cast<const T*>(&val);
    T* dst = (part == 0 ? q_s : part == 1 ? k_s : part == 2 ? v_s : da_s) +
             i * ldq + j;
#pragma unroll
    for (int t = 0; t < V; ++t) dst[t] = vals[t];
  }
  for (int k = threadIdx.x; k < S; k += blockDim.x)
    b_s[k] = p.bias ? p.bias[static_cast<size_t>(chunk) * S + k] : 0.f;
  __syncthreads();

  T* a_out = static_cast<T*>(p.a);
  T* dqkv = static_cast<T*>(P.dqkv);
  // f32 results of a warp's 16 x D products, before rounding
  float* o = kIsBf16<T> ? w1 : w0;
  const int ldo = kIsBf16<T> ? lds : D + 4;
  auto store_rows = [&](T* dst, size_t ld, int r_first) {
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = e / D;
      const int j = e % D;
      dst[(row0 + r_first + r) * ld + hd * D + j] = from_f<T>(o[r * ldo + j]);
    }
    __syncwarp();
  };

  // query rows: p, a, dp, ds, dq
  for (int g = warp; g < S / 16; g += n_warps) {
    float* c;   // f32 scores, then p, of the 16 rows
    float* dd;  // f32 dp of the 16 rows
    int ldc;
    if constexpr (kIsBf16<T>) {
      c = w0;
      dd = w1;
      ldc = lds;
    } else {
      c = reinterpret_cast<float*>(p_s) + g * 16 * ldp;
      dd = reinterpret_cast<float*>(ds_s) + g * 16 * ldp;
      ldc = ldp;
    }
    T* pc = p_s + g * 16 * ldp;
    T* dsr = ds_s + g * 16 * ldp;
    warp_mm<T, true>(q_s + g * 16 * ldq, ldq, k_s, ldq, D, S, c, ldc);
    {  // the forward's softmax: two lanes per row, every other key
      const int r = lane >> 1;
      float* row = c + r * ldc;
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
      for (int k = lane & 1; k < S; k += 2) {
        const float pk = row[k] / sum;
        row[k] = pk;
        pc[r * ldp + k] = from_f<T>(pk);   // (f32: the same word)
      }
    }
    __syncwarp();
    warp_mm<T, false>(pc, ldp, v_s, ldq, S, D, o, ldo);
    store_rows(a_out, B, g * 16);
    warp_mm<T, true>(da_s + g * 16 * ldq, ldq, v_s, ldq, D, S, dd, ldc);
    {  // ds = round(p (dp - rowsum) scale), two lanes per row
      const int r = lane >> 1;
      const float* prow = c + r * ldc;
      const float* drow = dd + r * ldc;
      float rs = 0.f;
      for (int k = lane & 1; k < S; k += 2) rs += prow[k] * drow[k];
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      for (int k = lane & 1; k < S; k += 2)
        dsr[r * ldp + k] = from_f<T>(prow[k] * (drow[k] - rs) * scale);
    }
    __syncwarp();
    warp_mm<T, false>(dsr, ldp, k_s, ldq, S, D, o, ldo);
    store_rows(dqkv, 3 * B, g * 16);
  }
  __syncthreads();   // every row of round(p) and ds is in place

  // key rows: dv = round(p)^T dA, dk = ds^T q
  for (int g = warp; g < S / 16; g += n_warps) {
    warp_mm<T, false, true>(p_s + g * 16, ldp, da_s, ldq, S, D, o, ldo);
    store_rows(dqkv + 2 * B, 3 * B, g * 16);
    warp_mm<T, false, true>(ds_s + g * 16, ldp, q_s, ldq, S, D, o, ldo);
    store_rows(dqkv + B, 3 * B, g * 16);
  }
}

// Elements of T the spilled [S, S] tiles take after the attention
// workspace (0 where they fit in shared memory); -1 where nothing fits.
template <typename T, int D>
long long spill_elems(int M, int n, int S, int h) {
  const CoreCfg c = core_cfg<T, D>(S);
  if (c.warps == 0) return -1;
  if (!c.spill) return 0;
  return static_cast<long long>(M) * n * h * spill_block_bytes<T, D>(c, S) /
         sizeof(T);
}

template <typename T>
long long spill_elems_for(int M, int n, int S, int B, int h) {
  const int d = B / h;
  return d == 32 ? spill_elems<T, 32>(M, n, S, h)
                 : spill_elems<T, 64>(M, n, S, h);
}

template <typename T, int D>
int launch_core(const DptAttnBwdParams& P, unsigned char* spill,
                cudaStream_t stream) {
  const CoreCfg c = core_cfg<T, D>(P.f.S);
  if (c.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      intra_bwd_core_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(c.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  intra_bwd_core_kernel<T, D><<<dim3(P.f.n, P.f.M, P.f.h), c.warps * 32,
                                c.smem, stream>>>(
      P, scale, c.spill ? spill : nullptr, c.heads);
  return static_cast<int>(cudaGetLastError());
}

// ws_act holds the attention workspace (attn_bwd_layout) and, after it,
// the spilled tiles where the core needs them.
template <typename T>
int launch_bwd(const DptAttnBwdParams& P, void* ws_act, float* ws_f32,
               cudaStream_t stream) {
  const int d = P.f.Bq / P.f.h;
  if ((d != 32 && d != 64) || P.f.Bq % 64 || P.f.Bq > P.f.B)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttnBwdLayout L =
      attn_bwd_layout(P.f.R, P.f.B, P.f.h, P.f.Bq, sizeof(T));
  unsigned char* spill =
      reinterpret_cast<unsigned char*>(static_cast<T*>(ws_act) + L.n_act);
  return launch_attention_bwd<T>(
      P, ws_act, ws_f32, stream,
      [d, spill](const DptAttnBwdParams& q, cudaStream_t s) {
        return d == 32 ? launch_core<T, 32>(q, spill, s)
                       : launch_core<T, 64>(q, spill, s);
      });
}

}  // namespace

extern "C" {

// Elements of the compute dtype (elem_bytes 2 for bf16, 4 for f32) the
// intra backward needs after ctn_dpt_attn_bwd_workspace's n_act for its
// spilled [S, S] (and, where needed, [S, d]) tiles: 0 where they fit in
// shared memory, -1 where the core fits no way. B here is the heads' width
// Bq = h * d.
int ctn_dpt_intra_bwd_spill(int M, int n, int S, int B, int h, int elem_bytes,
                            long long* n_spill) {
  if (h <= 0 || B % h) return static_cast<int>(cudaErrorInvalidValue);
  *n_spill = elem_bytes == 2
                 ? spill_elems_for<__nv_bfloat16>(M, n, S, B, h)
                 : spill_elems_for<float>(M, n, S, B, h);
  return 0;
}

// One intra-chunk attention sublayer backward (CTN_DPT_ATTN_BWD_ARGS in
// dpt_bwd_common.cuh; workspace sizes from ctn_dpt_attn_bwd_workspace plus
// ctn_dpt_intra_bwd_spill);
// returns the first CUDA error of its launches.
int ctn_dpt_intra_bwd_f32(CTN_DPT_ATTN_BWD_ARGS) {
  return launch_bwd<float>(CTN_DPT_ATTN_BWD_CALL);
}

int ctn_dpt_intra_bwd_bf16(CTN_DPT_ATTN_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16>(CTN_DPT_ATTN_BWD_CALL);
}

}  // extern "C"
