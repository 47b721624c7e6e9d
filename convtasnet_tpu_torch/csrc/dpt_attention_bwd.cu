// The dual-path inter-chunk attention sublayer backward for Hopper
// (sm_90a), bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/dpt_attention.py::_inter_bwd_kernel
// (wrapper fused_inter_attention_bwd). From the sublayer input x and the
// cotangent g of its output it returns dx, dgamma, dbeta, dW_qkv and dW_out,
// recomputing the forward from x (only the primals are saved, as the JAX
// rule _fused_inter_fwd does). Attention runs across the n chunks at each
// in-chunk position s; per (m, s, head), with scale = 1 / sqrt(d):
//
//   p  = softmax(q k^T * scale + bias[key chunk, s])   f32
//   a  = round(round(p) v)                             for dW_out
//   dA = round(g W_out^T);  dp = dA v^T                f32
//   dv = round(round(p)^T dA)
//   ds = round(p * (dp - rowsum(p * dp)) * scale)
//   dq = round(ds k);  dk = round(ds^T q)
//
// then the launches both attention backwards share.
//
// What bounds it on the card. At the DPT quality default (B=256, h=8, d=32,
// S=128) and B=8 x 4 s (n=25) the backward is 38.9 GFLOP (11 projection
// products of 2 R B^2, QKV recomputed, and 6 core products of 2 R n B): 39
// us at 989 TFLOP/s, against 39 MB of x, g and dx (12 us at 3.35 TB/s):
// compute-bound, the projections 37 of the 39 GFLOP.
//
// bf16: the design of dpt_attn_bwd_wg.cuh, six launches (LQ, the core, two
// weight gradients, DN, the sums) on the wgmma core, the core on
// mma.sync with this kernel's gather (the n rows of the chunks at one
// position s, strided by S rows; the key bias per (key chunk, s)): one CTA
// per (m, s, head) of ceil(n / 16) 16-row tiles (two warps at n = 25), the
// keys staged in blocks of up to 256 rows, so any n runs; what stands over
// the bound is the frame's round trips through device memory and the
// core's small tiles (n = 25 fills two of its 16-row tiles 78%).
//
// f32: the first design, 13 launches (launch_attention_bwd in
// dpt_bwd_common.cuh around inter_bwd_core_kernel). The core is tiny per
// (m, s, head) (n x n, n=25 at 4 s, 94 at 15 s) and strided by S*3B in
// memory, so, as in the forward (dpt_attention.cu), one block per (m, s)
// stages rows of up to 32 chunks at a time in shared memory and each warp
// takes one head. The backward needs each query's whole p row for its
// rowsum, so (inter_bwd_core_kernel):
//   query side, one query chunk per lane: pass 1 the max and denominator
//     (online, the forward's pass 1), pass 2 a and rowsum = sum p * dp,
//     pass 3 dq; the three per-query statistics go to a small f32
//     workspace;
//   key side, after a block barrier, one key chunk per lane: p and ds
//     rebuilt from the statistics with the same arithmetic, dv and dk
//     summed over the query chunks.
// Any n >= 1; with n <= 32 each side loads its tile once. When n = 1
// every row has one key and p = 1, masked or not, as in the reference.
// Head widths 16, 32, 64 and 128, as in the forward: with more than 8
// heads (d = 16 at B = 256, d = 32 from B = 320) each warp takes its heads
// in turn (core_warps), both
// sides of one head before the next, and at d = 128 two lanes share a
// query (key) chunk, 64 dimensions each, their dot products summed by one
// shuffle (InterLanes, dpt_common.cuh); at d <= 64 every value and order
// is as before. The key side's four rows (k, v, dk, dv) spill at 64
// dimensions a lane, at d = 64 as before and at d = 128; four lanes of 32
// at d = 128 spill nothing but ran 1.12x slower (PERF.md §6).
// Above Bq = 512 the core stages fewer chunks per load (kKeys = 0,
// inter_wide_keys: 32 chunks of q and dA, or k and v, for all heads pass
// the block's shared memory at Bq = 960), as the forward's does, every sum
// in the same order; above B = 512 the frame's qkv recompute runs from y
// (launch_qkv_rows) and its LN backward on ln_bwd_wide_kernel
// (dpt_bwd_common.cuh).
//
// Under tensor parallelism (partial, the backward of the Pallas kernel's
// partial=True) the core runs one shard's h heads of width Bq = h * d
// (qkv, dqkv [R, 3Bq], dA and a [R, Bq]), the products take Bq
// (dpt_bwd_common.cuh) and dx has no g term.

#include "dpt_attn_wide_head.cuh"

namespace {

constexpr int kTile = kInterKeys;   // chunks staged per shared-memory load

// The core's shared memory with kKeys (inter_core_keys).
template <typename T, int kKeys = kTile>
size_t core_bwd_smem(int Bq) {
  const int keys = inter_core_keys<T, kKeys>(Bq);
  return align128(static_cast<size_t>(keys) * 2 * Bq * sizeof(T)) +
         keys * sizeof(float);
}

// Grid (S, M); 32 * core_warps(h) threads, warp = head (kTurns: heads
// warp, warp + warps, ... in turn), G lanes per chunk, kKeys chunks staged
// per load (0: as many as inter_wide_keys gives, above Bq = 512). B below
// is the heads' width Bq: the rows of qkv and dqkv hold 3Bq values, those
// of dA and a Bq.
template <typename T, int D, bool kTurns, int kKeys = kTile>
__global__ void __launch_bounds__(256)
    inter_bwd_core_kernel(DptAttnBwdParams P, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  constexpr int G = InterLanes<D>::G;
  constexpr int DL = InterLanes<D>::DL;
  const DptAttnParams& p = P.f;
  const int n = p.n, S = p.S, B = p.Bq, h = p.h;
  const int key_tile = inter_core_keys<T, kKeys>(B);
  T* tile_s = reinterpret_cast<T*>(smem);   // [key_tile][2B]
  float* b_s = reinterpret_cast<float*>(
      smem + align128(static_cast<size_t>(key_tile) * 2 * B * sizeof(T)));
  const int s = blockIdx.x, m = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % G;   // which DL dimensions of the head
  const T* qkv = static_cast<const T*>(p.qkv);
  const T* dA = static_cast<const T*>(P.dA);
  const bool one_tile = n <= key_tile;
  // the row of chunk c at position s
  auto row_of = [&](int c) {
    return (static_cast<size_t>(m) * n + c) * S + s;
  };
  auto key_bias = [&](int c) {
    return p.bias ? p.bias[static_cast<size_t>(c) * S + s] : 0.f;
  };
  // tile_s[j] = (lo | hi) of chunk c0 + j: lo = B values of `lo` at row
  // stride ld_lo, hi = B values of `hi` at ld_hi; b_s[j] its key bias
  auto load_tile = [&](const T* lo, int ld_lo, const T* hi, int ld_hi,
                       int c0, int ct) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < ct * (2 * B / V); e += blockDim.x) {
      const int j = e / (2 * B / V);
      const int col = (e % (2 * B / V)) * V;
      const T* src = col < B ? lo + row_of(c0 + j) * ld_lo + col
                             : hi + row_of(c0 + j) * ld_hi + col - B;
      *reinterpret_cast<uint4*>(&tile_s[j * 2 * B + col]) =
          *reinterpret_cast<const uint4*>(src);
    }
    for (int j = threadIdx.x; j < ct; j += blockDim.x)
      b_s[j] = key_bias(c0 + j);
    __syncthreads();
  };
  // DL values of T from 16-byte loads into f32
  auto load_row = [](const T* src, float* dst) {
#pragma unroll
    for (int t = 0; t < DL; t += V) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + t);
      const T* vals = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < V; ++e) dst[t + e] = to_f<T>(vals[e]);
    }
  };
  // the whole head's dot product of two rows, DL values in each lane
  auto dot = [](const float* a, const float* b) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc = fmaf(a[t], b[t], acc);
    return lanes_sum<G>(acc);
  };
  auto store_row = [](T* dst, const float* v) {
#pragma unroll
    for (int t = 0; t < DL; t += V) {
      alignas(16) T vals[V];
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = from_f<T>(v[t + e]);
      *reinterpret_cast<uint4*>(dst + t) =
          *reinterpret_cast<const uint4*>(vals);
    }
  };
  T* dqkv = static_cast<T*>(P.dqkv);

  // one head: warp = head, or with more than 8 heads heads warp,
  // warp + warps, ... in turn
  auto run_head = [&](const int hd) {
    const int col0 = hd * D + sub * DL;   // this lane's columns of the head
    // query side: lanes are query chunks; the staged tiles hold (k | v)
    for (int q0 = 0; q0 < n; q0 += 32 / G) {
      const int qc = q0 + lane / G;
      const bool valid = qc < n;
      const size_t qrow = row_of(valid ? qc : 0);
      float q[DL], da[DL], acc[DL];
      load_row(qkv + qrow * 3 * B + col0, q);
      load_row(dA + qrow * B + col0, da);
      auto score = [&](int j) {
        float k[DL];
        load_row(tile_s + j * 2 * B + col0, k);
        return dot(q, k) * scale + b_s[j];
      };
      auto dp_of = [&](int j) {
        float v[DL];
        load_row(tile_s + j * 2 * B + B + col0, v);
        return dot(da, v);
      };

      float mx = -INFINITY, sum = 0.f;
      for (int k0 = 0; k0 < n; k0 += key_tile) {
        const int kt = min(key_tile, n - k0);
        load_tile(qkv + B, 3 * B, qkv + 2 * B, 3 * B, k0, kt);
        for (int j = 0; j < kt; ++j) {
          const float sc = score(j);
          const float mn = fmaxf(mx, sc);
          sum = sum * expf(mx - mn) + expf(sc - mn);
          mx = mn;
        }
      }

#pragma unroll
      for (int t = 0; t < DL; ++t) acc[t] = 0.f;
      float rowsum = 0.f;
      for (int k0 = 0; k0 < n; k0 += key_tile) {
        const int kt = min(key_tile, n - k0);
        if (!one_tile) load_tile(qkv + B, 3 * B, qkv + 2 * B, 3 * B, k0, kt);
        for (int j = 0; j < kt; ++j) {
          const float pj = expf(score(j) - mx) / sum;
          const float w = round_to<T>(pj);
          float v[DL];
          load_row(tile_s + j * 2 * B + B + col0, v);
#pragma unroll
          for (int t = 0; t < DL; ++t) acc[t] = fmaf(w, v[t], acc[t]);
          rowsum = fmaf(pj, dot(da, v), rowsum);
        }
      }
      if (valid) store_row(static_cast<T*>(p.a) + qrow * B + col0, acc);

#pragma unroll
      for (int t = 0; t < DL; ++t) acc[t] = 0.f;
      for (int k0 = 0; k0 < n; k0 += key_tile) {
        const int kt = min(key_tile, n - k0);
        if (!one_tile) load_tile(qkv + B, 3 * B, qkv + 2 * B, 3 * B, k0, kt);
        for (int j = 0; j < kt; ++j) {
          const float pj = expf(score(j) - mx) / sum;
          const float ds = round_to<T>(pj * (dp_of(j) - rowsum) * scale);
          float k[DL];
          load_row(tile_s + j * 2 * B + col0, k);
#pragma unroll
          for (int t = 0; t < DL; ++t) acc[t] = fmaf(ds, k[t], acc[t]);
        }
      }
      if (valid) {
        store_row(dqkv + qrow * 3 * B + col0, acc);
        if (sub == 0) {
          float* st = P.stats + (qrow * h + hd) * kNumRowStats;
          st[0] = mx;
          st[1] = sum;
          st[2] = rowsum;
        }
      }
    }

    // key side: lanes are key chunks; the staged tiles hold (q | dA). The
    // statistics written above are read after load_tile's barrier.
    for (int k0 = 0; k0 < n; k0 += 32 / G) {
      const int kc = k0 + lane / G;
      const bool valid = kc < n;
      const size_t krow = row_of(valid ? kc : 0);
      const float kb = key_bias(valid ? kc : 0);
      float kk[DL], vv[DL], dk[DL], dv[DL];
      load_row(qkv + krow * 3 * B + B + col0, kk);
      load_row(qkv + krow * 3 * B + 2 * B + col0, vv);
#pragma unroll
      for (int t = 0; t < DL; ++t) dk[t] = dv[t] = 0.f;
      for (int c0 = 0; c0 < n; c0 += key_tile) {
        const int ct = min(key_tile, n - c0);
        load_tile(qkv, 3 * B, dA, B, c0, ct);
        for (int i = 0; i < ct; ++i) {
          const float* st =
              P.stats + (row_of(c0 + i) * h + hd) * kNumRowStats;
          float qv[DL], dav[DL];
          load_row(tile_s + i * 2 * B + col0, qv);
          load_row(tile_s + i * 2 * B + B + col0, dav);
          const float pj = expf(dot(qv, kk) * scale + kb - st[0]) / st[1];
          const float ds =
              round_to<T>(pj * (dot(dav, vv) - st[2]) * scale);
          const float w = round_to<T>(pj);
#pragma unroll
          for (int t = 0; t < DL; ++t) {
            dv[t] = fmaf(w, dav[t], dv[t]);
            dk[t] = fmaf(ds, qv[t], dk[t]);
          }
        }
      }
      if (valid) {
        store_row(dqkv + krow * 3 * B + B + col0, dk);
        store_row(dqkv + krow * 3 * B + 2 * B + col0, dv);
      }
    }
  };
  if constexpr (kTurns) {
    for (int hd = warp; hd < h; hd += blockDim.x >> 5) run_head(hd);
  } else {
    run_head(warp);
  }
}

template <typename T, int D, bool kTurns, int kKeys = kTile>
int launch_core_turns(const DptAttnBwdParams& P, cudaStream_t stream,
                      float scale) {
  const size_t smem = core_bwd_smem<T, kKeys>(P.f.Bq);
  auto kernel = inter_bwd_core_kernel<T, D, kTurns, kKeys>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(P.f.S, P.f.M), 32 * core_warps(P.f.h), smem, stream>>>(
      P, scale);
  return static_cast<int>(cudaGetLastError());
}

// A warp a head (kTurns false) up to 8 heads at d >= 32; each warp its
// heads in turn otherwise (core_warps), as at d = 16 at every head count.
// Above Bq = 512 (chosen by Bq alone) fewer chunks a load (kKeys 0), each
// warp its heads in turn (one each at up to 8 heads).
template <typename T, int D>
int launch_core(const DptAttnBwdParams& P, cudaStream_t stream, float scale) {
  if (P.f.Bq > kWideMax)
    return launch_core_turns<T, D, true, 0>(P, stream, scale);
  return D == 16 || P.f.h > 8
             ? launch_core_turns<T, D, true>(P, stream, scale)
             : launch_core_turns<T, D, false>(P, stream, scale);
}

// The core for the padded head width D = Bq / h (core_head_width), with
// the real width's softmax scale.
template <typename T>
int launch_core_d(const DptAttnBwdParams& P, cudaStream_t stream,
                  float scale) {
  switch (P.f.Bq / P.f.h) {
    case 16: return launch_core<T, 16>(P, stream, scale);
    case 32: return launch_core<T, 32>(P, stream, scale);
    case 64: return launch_core<T, 64>(P, stream, scale);
    case 128: return launch_core<T, 128>(P, stream, scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32: the first design; bf16: the design in dpt_attn_bwd_wg.cuh, with the
// core's inter gather. d: the heads' real width (its scale); above a
// padded width of 128 the core is the route of dpt_attn_wide_head.cuh, in
// `wide`.
template <typename T>
int launch_bwd(const DptAttnBwdParams& P, void* ws_act, float* ws_f32,
               cudaStream_t stream, int d, float* wide) {
  if (!attn_head_widths_ok(P.f.Bq, P.f.h, d) || P.f.Bq % 64 ||
      P.f.Bq > P.f.B || P.f.Bn < 1 || P.f.Bn > P.f.B)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = attn_scale(d);
  auto core = [=](const DptAttnBwdParams& q, cudaStream_t s) {
    if (q.f.Bq / q.f.h > kCoreMaxD)
      return launch_wide_head_bwd<T, true>(q, wide, scale, s);
    if constexpr (kIsBf16<T>)
      return launch_core_wg_d<true>(q, s, scale);
    else
      return launch_core_d<T>(q, s, scale);
  };
  if constexpr (kIsBf16<T>)
    return launch_attention_bwd_wg(P, ws_act, ws_f32, stream, core);
  else
    return launch_attention_bwd<T>(P, ws_act, ws_f32, stream, core);
}

}  // namespace

extern "C" {

// Workspace of either attention backward: n_act elements of the compute
// dtype (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats; Bq the heads'
// width (B for the full sublayer).
int ctn_dpt_attn_bwd_workspace(int M, int n, int S, int B, int h, int Bq,
                               int elem_bytes, long long* n_act,
                               long long* n_f32) {
  if (elem_bytes == 2) {   // bf16: the design in dpt_attn_bwd_wg.cuh
    const AttnWgLayout L =
        attn_wg_layout(static_cast<long long>(M) * n * S, B, h, Bq);
    *n_act = static_cast<long long>(L.n_act);
    *n_f32 = static_cast<long long>(L.n_f32);
    return 0;
  }
  const AttnBwdLayout L = attn_bwd_layout(static_cast<long long>(M) * n * S,
                                          B, h, Bq, elem_bytes);
  *n_act = static_cast<long long>(L.n_act);
  *n_f32 = static_cast<long long>(L.n_f32);
  return 0;
}

// One inter-chunk attention sublayer backward (CTN_DPT_ATTN_BWD_ARGS in
// dpt_bwd_common.cuh); returns the first CUDA error of its launches.
int ctn_dpt_inter_bwd_f32(CTN_DPT_ATTN_BWD_ARGS) {
  return launch_bwd<float>(CTN_DPT_ATTN_BWD_CALL);
}

int ctn_dpt_inter_bwd_bf16(CTN_DPT_ATTN_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16>(CTN_DPT_ATTN_BWD_CALL);
}

}  // extern "C"
