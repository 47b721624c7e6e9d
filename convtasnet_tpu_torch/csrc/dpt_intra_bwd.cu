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
// at 3.35 TB/s): compute-bound. The Pallas kernel kept a chunk's [S, S]
// probabilities and its dqkv in VMEM.
//
// bf16: the design of dpt_attn_bwd_wg.cuh, six launches (LQ, the core, two
// weight gradients, DN, the sums) on the wgmma core, the core on
// mma.sync with this kernel's gather (the S rows of one chunk, the key
// bias per (chunk, key)). Its core recomputes p from per-row statistics
// instead of keeping [S, S] tiles, so every S runs in the same shared
// memory (at most 95 KB at S = 256 and d = 64), with no device workspace
// for tiles; it recomputes q k^T four times and dA v^T three
// (18.5 GFLOP of core products at the default, on mma.sync at a fraction
// of wgmma's rate): the core and the qkv, dA, a and dqkv round trips
// through device memory are what stand over the bound.
//
// f32: the first design, 13 launches (launch_attention_bwd in
// dpt_bwd_common.cuh around intra_bwd_core_kernel). The core takes one block
// per (m, chunk, head): q, k, v and dA [S, d] in shared memory, then each
// warp takes 16 query rows: the scores by FMA, the softmax in the
// forward's order, p and ds into two [S, S] shared tiles, a and dq out;
// after a block barrier each warp takes 16 key rows: dv and dk from the
// transposed tiles (warp_mm with kAT). About 208 KB of shared memory at
// S=128, so one block per SM. Where the two [S, S] tiles do not fit beside
// the rest, they go to a device workspace instead, one pair of tiles per
// (m, chunk, head) block, and the block runs with as many warps (4, 2 or
// 1) as its per-warp scratch rows leave room for; every value and every
// order of summation is as in shared memory. Where even that does not fit
// (a head width of 64 above S=208: its four [S, d] tiles alone take 266 KB
// at S=256), the q, k, v and dA tiles go to the workspace too, after the
// block's two [S, S] tiles and in the same layout, and the block runs with
// four warps (a head width of 128 from S=112 up: its four [S, d] tiles
// take 264 KB at S=128). Head widths 16, 32, 64 and 128. The round
// trips of qkv, dA, a, dqkv and dy through device memory are the design's
// cost over the bound. The first design runs S <= 256.
//
// f32 above 256 frames: the two [S, S] tiles (2.1 MB a block at S = 512)
// give way to the row-statistics core of dpt_intra_rowstat.cuh, in the
// same 13 launches: one CTA of four warps per (m, chunk, head), a warp per
// 16 query rows (passes 1-3 over the keys staged in blocks of 4096 / d
// rows: the online max and denominator, then p, a, dp and rowsum, then ds
// and dq, by FMA), the (max, denominator, rowsum) of each query to the
// stats segment of the workspace; after a block barrier a warp per 16 key
// rows rebuilds p and ds from those statistics over the staged queries
// and sums dv and dk (at d = 128 in a walk each). Shared memory is fixed
// by d (65-118 KB) and no tile goes to the workspace. Registers (ptxas,
// sm_90a): 128, 166, 168 and 236 at d = 16, 32, 64 and 128 (48 and 24
// bytes of spill stores at 16 and 64); at d = 32 three CTAs per SM, by
// registers and by shared memory alike. What stands over the bound: q k^T four
// times (five at d = 128) and dA v^T three (with p v, ds k, p^T dA and
// ds^T q, 11 S^2 d FMA products per head against the bound's 6), fed from
// shared memory, and
// the staged blocks re-walked per round of four query or key tiles.
//
// Under tensor parallelism (partial, the backward of the Pallas kernel's
// partial=True) the core runs one shard's h heads of width Bq = h * d
// (qkv, dqkv [R, 3Bq], dA and a [R, Bq]), the products take Bq
// (dpt_bwd_common.cuh) and dx has no g term.

#include "dpt_attn_wide_head.cuh"
#include "dpt_intra_rowstat.cuh"

namespace {

constexpr int kCoreWarps = 4;

// Leading dimensions of the [S, d] tiles (odd: warp_mm's transposed reads
// stay off shared banks) and of the [S, S] p and dp-then-ds tiles.
template <int D>
__host__ __device__ constexpr int head_ld() { return D + 1; }
__host__ __device__ constexpr int pmat_ld(int S) { return S + 4; }

// Per-warp scratch: the f32 output tile of its 16 x D products.
template <int D>
__host__ __device__ constexpr size_t warp_scratch() {
  return align128(static_cast<size_t>(16) * (D + 4) * 4);
}

// Bytes of one of the q, k, v, dA [S, d] tiles.
template <int D>
__host__ __device__ constexpr size_t head_bytes(int S) {
  return align128(static_cast<size_t>(S) * head_ld<D>() * sizeof(float));
}

// Bytes of one [S, S] tile.
__host__ __device__ constexpr size_t pmat_bytes(int S) {
  return align128(static_cast<size_t>(S) * pmat_ld(S) * sizeof(float));
}

// Shared memory of the core with `warps` warps; with `spill` the two
// [S, S] tiles live in the device workspace instead, with `heads` the four
// [S, d] tiles too.
template <int D>
__host__ __device__ constexpr size_t core_bwd_smem(int S, bool spill,
                                                   int warps,
                                                   bool heads = false) {
  return (heads ? 0 : 4 * head_bytes<D>(S)) +
         align128(static_cast<size_t>(S) * sizeof(float)) +
         (spill ? 0 : 2 * pmat_bytes(S)) + warps * warp_scratch<D>();
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

template <int D>
CoreCfg core_cfg(int S) {
  if (core_bwd_smem<D>(S, false, kCoreWarps) <= kMaxCoreSmem)
    return {false, false, kCoreWarps, core_bwd_smem<D>(S, false, kCoreWarps)};
  for (int w = kCoreWarps; w >= 1; w /= 2)
    if (core_bwd_smem<D>(S, true, w) <= kMaxCoreSmem)
      return {true, false, w, core_bwd_smem<D>(S, true, w)};
  if (core_bwd_smem<D>(S, true, kCoreWarps, true) <= kMaxCoreSmem)
    return {true, true, kCoreWarps,
            core_bwd_smem<D>(S, true, kCoreWarps, true)};
  return {true, false, 0, 0};
}

// Workspace bytes of one block's spilled tiles under c.
template <int D>
size_t spill_block_bytes(const CoreCfg& c, int S) {
  return 2 * pmat_bytes(S) + (c.heads ? 4 * head_bytes<D>(S) : 0);
}

// The f32 core. Grid (n, M, h); blockDim.x / 32 warps. S % 16 == 0.
// spill: null, or the device workspace of the [S, S] tiles, 2 pmat_bytes
// per block, followed with `heads` by the block's four [S, d] tiles.
template <int D>
__global__ void __launch_bounds__(kCoreWarps * 32)
    intra_bwd_core_kernel(DptAttnBwdParams P, float scale,
                          unsigned char* spill, bool heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 4;   // floats per 16-byte load
  constexpr int ldq = head_ld<D>();
  constexpr int ldo = D + 4;
  const DptAttnParams& p = P.f;
  const int S = p.S, B = p.Bq;   // the heads' width: qkv rows hold 3Bq
  const int ldp = pmat_ld(S);
  const int chunk = blockIdx.x, m = blockIdx.y, hd = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  const size_t head = head_bytes<D>(S);
  const size_t pm = pmat_bytes(S);
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
  float* q_s = reinterpret_cast<float*>(hbase);
  float* k_s = reinterpret_cast<float*>(hbase + head);
  float* v_s = reinterpret_cast<float*>(hbase + 2 * head);
  float* da_s = reinterpret_cast<float*>(hbase + 3 * head);
  float* b_s = reinterpret_cast<float*>(tail);
  tail += align128(static_cast<size_t>(S) * sizeof(float));
  if (!spill) {
    at = tail;
    tail += 2 * pm;
  }
  float* p_s = reinterpret_cast<float*>(at);         // scores, then p
  float* ds_s = reinterpret_cast<float*>(at + pm);   // dp, then ds
  // f32 results of a warp's 16 x D products
  float* o = reinterpret_cast<float*>(tail + warp * warp_scratch<D>());

  const size_t row0 = (static_cast<size_t>(m) * p.n + chunk) * S;
  const float* qkv = static_cast<const float*>(p.qkv);
  const float* dA = static_cast<const float*>(P.dA);
  // this head's q, k, v and dA rows of the chunk, 16 bytes per load
  for (int e = threadIdx.x; e < 4 * S * (D / V); e += blockDim.x) {
    const int part = e / (S * (D / V));
    const int i = (e / (D / V)) % S;
    const int j = (e % (D / V)) * V;
    const float* src = part < 3
                           ? qkv + (row0 + i) * 3 * B + part * B + hd * D + j
                           : dA + (row0 + i) * B + hd * D + j;
    const float4 val = *reinterpret_cast<const float4*>(src);
    float* dst =
        (part == 0 ? q_s : part == 1 ? k_s : part == 2 ? v_s : da_s) +
        i * ldq + j;
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  }
  for (int k = threadIdx.x; k < S; k += blockDim.x)
    b_s[k] = p.bias ? p.bias[static_cast<size_t>(chunk) * S + k] : 0.f;
  __syncthreads();

  float* a_out = static_cast<float*>(p.a);
  float* dqkv = static_cast<float*>(P.dqkv);
  auto store_rows = [&](float* dst, size_t ld, int r_first) {
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = e / D;
      const int j = e % D;
      dst[(row0 + r_first + r) * ld + hd * D + j] = o[r * ldo + j];
    }
    __syncwarp();
  };

  // query rows: p, a, dp, ds, dq
  for (int g = warp; g < S / 16; g += n_warps) {
    float* c = p_s + g * 16 * ldp;    // scores, then p, of the 16 rows
    float* dd = ds_s + g * 16 * ldp;  // dp, then ds, of the 16 rows
    warp_mm<float, true>(q_s + g * 16 * ldq, ldq, k_s, ldq, D, S, c, ldp);
    {  // the forward's softmax: two lanes per row, every other key
      const int r = lane >> 1;
      float* row = c + r * ldp;
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
      for (int k = lane & 1; k < S; k += 2) row[k] = row[k] / sum;
    }
    __syncwarp();
    warp_mm<float, false>(c, ldp, v_s, ldq, S, D, o, ldo);
    store_rows(a_out, B, g * 16);
    warp_mm<float, true>(da_s + g * 16 * ldq, ldq, v_s, ldq, D, S, dd, ldp);
    {  // ds = p (dp - rowsum) scale over dp in place, two lanes per row
      const int r = lane >> 1;
      const float* prow = c + r * ldp;
      float* drow = dd + r * ldp;
      float rs = 0.f;
      for (int k = lane & 1; k < S; k += 2) rs += prow[k] * drow[k];
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      for (int k = lane & 1; k < S; k += 2)
        drow[k] = prow[k] * (drow[k] - rs) * scale;
    }
    __syncwarp();
    warp_mm<float, false>(dd, ldp, k_s, ldq, S, D, o, ldo);
    store_rows(dqkv, 3 * B, g * 16);
  }
  __syncthreads();   // every row of p and ds is in place

  // key rows: dv = p^T dA, dk = ds^T q
  for (int g = warp; g < S / 16; g += n_warps) {
    warp_mm<float, false, true>(p_s + g * 16, ldp, da_s, ldq, S, D, o, ldo);
    store_rows(dqkv + 2 * B, 3 * B, g * 16);
    warp_mm<float, false, true>(ds_s + g * 16, ldp, q_s, ldq, S, D, o, ldo);
    store_rows(dqkv + B, 3 * B, g * 16);
  }
}

// Floats the spilled tiles take after the attention workspace (0 where they
// fit in shared memory); -1 where nothing fits.
template <int D>
long long spill_elems(int M, int n, int S, int h) {
  const CoreCfg c = core_cfg<D>(S);
  if (c.warps == 0) return -1;
  if (!c.spill) return 0;
  return static_cast<long long>(M) * n * h * spill_block_bytes<D>(c, S) /
         sizeof(float);
}

template <int D>
int launch_core(const DptAttnBwdParams& P, unsigned char* spill,
                cudaStream_t stream, float scale) {
  const CoreCfg c = core_cfg<D>(P.f.S);
  if (c.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      intra_bwd_core_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(c.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  intra_bwd_core_kernel<D><<<dim3(P.f.n, P.f.M, P.f.h), c.warps * 32, c.smem,
                             stream>>>(P, scale, c.spill ? spill : nullptr,
                                       c.heads);
  return static_cast<int>(cudaGetLastError());
}

// f32: ws_act holds the attention workspace (attn_bwd_layout) and, after
// it, the spilled tiles where the core needs them. d: the heads' real
// width (its scale); above a padded width of 128 the core is the route of
// dpt_attn_wide_head.cuh, in `wide`, at any S.
int launch_bwd(const DptAttnBwdParams& P, void* ws_act, float* ws_f32,
               cudaStream_t stream, int d, float* wide) {
  if (!attn_head_widths_ok(P.f.Bq, P.f.h, d) || P.f.Bq % 64 ||
      P.f.Bq > P.f.B || P.f.Bn < 1 || P.f.Bn > P.f.B)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttnBwdLayout L =
      attn_bwd_layout(P.f.R, P.f.B, P.f.h, P.f.Bq, sizeof(float));
  unsigned char* spill =
      reinterpret_cast<unsigned char*>(static_cast<float*>(ws_act) + L.n_act);
  const float scale = attn_scale(d);
  return launch_attention_bwd<float>(
      P, ws_act, ws_f32, stream,
      [spill, scale, wide](const DptAttnBwdParams& q, cudaStream_t s) {
        if (q.f.Bq / q.f.h > kCoreMaxD)
          return launch_wide_head_bwd<float, false>(q, wide, scale, s);
        if (q.f.S > kFirstDesignMaxS)   // the row-statistics core
          return launch_rs_core_d<true>(
              q.f, static_cast<const float*>(q.dA),
              static_cast<float*>(q.dqkv), q.stats, s, scale);
        switch (q.f.Bq / q.f.h) {
          case 16: return launch_core<16>(q, spill, s, scale);
          case 32: return launch_core<32>(q, spill, s, scale);
          case 64: return launch_core<64>(q, spill, s, scale);
          case 128: return launch_core<128>(q, spill, s, scale);
        }
        return static_cast<int>(cudaErrorInvalidValue);
      });
}

// bf16: the design in dpt_attn_bwd_wg.cuh, with the core's intra gather;
// d and wide as in launch_bwd.
int launch_bwd_wg(const DptAttnBwdParams& P, void* ws_act, float* ws_f32,
                  cudaStream_t stream, int d, float* wide) {
  if (!attn_head_widths_ok(P.f.Bq, P.f.h, d) || P.f.Bq % 64 ||
      P.f.Bq > P.f.B || P.f.Bn < 1 || P.f.Bn > P.f.B || P.f.S % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = attn_scale(d);
  return launch_attention_bwd_wg(
      P, ws_act, ws_f32, stream,
      [scale, wide](const DptAttnBwdParams& q, cudaStream_t s) {
        if (q.f.Bq / q.f.h > kCoreMaxD)
          return launch_wide_head_bwd<__nv_bfloat16, false>(q, wide, scale,
                                                            s);
        return launch_core_wg_d<false>(q, s, scale);
      });
}

}  // namespace

extern "C" {

// Elements of the compute dtype (elem_bytes 2 for bf16, 4 for f32) the
// intra backward needs after ctn_dpt_attn_bwd_workspace's n_act for its
// spilled [S, S] (and, where needed, [S, d]) tiles: 0 where they fit in
// shared memory, and in f32 above S = 256 (the row-statistics core keeps
// no tile; its statistics have their segment in attn_bwd_layout), -1
// where the core fits no way. B here is the heads' width Bq = h * d.
int ctn_dpt_intra_bwd_spill(int M, int n, int S, int B, int h, int elem_bytes,
                            long long* n_spill) {
  if (h <= 0 || B % h) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 2) {   // bf16: the core on mma.sync
    *n_spill = 0;          // (dpt_attn_bwd_wg.cuh) keeps no [S, S] tile
    return 0;
  }
  if (B / h > kCoreMaxD) {   // the route beside the cores: its own
    // workspace (ctn_dpt_attn_wide_workspace)
    if ((B / h) % 64) return static_cast<int>(cudaErrorInvalidValue);
    *n_spill = 0;
    return 0;
  }
  if (S > kFirstDesignMaxS) {   // the row-statistics core: no tiles; its
    // statistics have their segment in attn_bwd_layout (stats)
    if (!core_head_width(B / h))
      return static_cast<int>(cudaErrorInvalidValue);
    *n_spill = 0;
    return 0;
  }
  switch (B / h) {
    case 16: *n_spill = spill_elems<16>(M, n, S, h); return 0;
    case 32: *n_spill = spill_elems<32>(M, n, S, h); return 0;
    case 64: *n_spill = spill_elems<64>(M, n, S, h); return 0;
    case 128: *n_spill = spill_elems<128>(M, n, S, h); return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One intra-chunk attention sublayer backward (CTN_DPT_ATTN_BWD_ARGS in
// dpt_bwd_common.cuh; workspace sizes from ctn_dpt_attn_bwd_workspace plus
// ctn_dpt_intra_bwd_spill);
// returns the first CUDA error of its launches.
int ctn_dpt_intra_bwd_f32(CTN_DPT_ATTN_BWD_ARGS) {
  return launch_bwd(CTN_DPT_ATTN_BWD_CALL);
}

int ctn_dpt_intra_bwd_bf16(CTN_DPT_ATTN_BWD_ARGS) {
  return launch_bwd_wg(CTN_DPT_ATTN_BWD_CALL);
}

}  // extern "C"
