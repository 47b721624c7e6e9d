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
// then the launches both attention backwards share (dpt_bwd_common.cuh).
//
// What bounds it on the card. At the DPT quality default (B=256, h=8, d=32,
// S=128) and B=8 x 4 s (n=25) the backward is 38.9 GFLOP (11 projection
// products of 2 R B^2, QKV recomputed, and 6 core products of 2 R n B): 39
// us at 989 TFLOP/s, against 39 MB of x, g and dx (12 us at 3.35 TB/s):
// compute-bound. The core is tiny per
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
//
// Under tensor parallelism (partial, the backward of the Pallas kernel's
// partial=True) the core runs one shard's h heads of width Bq = h * d
// (qkv, dqkv [R, 3Bq], dA and a [R, Bq]), the products take Bq
// (dpt_bwd_common.cuh) and dx has no g term.

#include "dpt_bwd_common.cuh"

namespace {

constexpr int kTile = 32;   // chunks staged per shared-memory load

template <typename T>
size_t core_bwd_smem(int Bq) {
  return align128(static_cast<size_t>(kTile) * 2 * Bq * sizeof(T)) +
         kTile * sizeof(float);
}

// Grid (S, M); 32 * h threads, warp = head. B below is the heads' width Bq:
// the rows of qkv and dqkv hold 3Bq values, those of dA and a Bq.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    inter_bwd_core_kernel(DptAttnBwdParams P, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  const DptAttnParams& p = P.f;
  const int n = p.n, S = p.S, B = p.Bq, h = p.h;
  T* tile_s = reinterpret_cast<T*>(smem);   // [kTile][2B]
  float* b_s = reinterpret_cast<float*>(
      smem + align128(static_cast<size_t>(kTile) * 2 * B * sizeof(T)));
  const int s = blockIdx.x, m = blockIdx.y;
  const int lane = threadIdx.x & 31, hd = threadIdx.x >> 5;
  const T* qkv = static_cast<const T*>(p.qkv);
  const T* dA = static_cast<const T*>(P.dA);
  const bool one_tile = n <= kTile;
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
  auto dot = [](const float* a, const float* b) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < D; ++t) acc = fmaf(a[t], b[t], acc);
    return acc;
  };
  auto store_row = [](T* dst, const float* v) {
#pragma unroll
    for (int t = 0; t < D; t += V) {
      alignas(16) T vals[V];
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = from_f<T>(v[t + e]);
      *reinterpret_cast<uint4*>(dst + t) =
          *reinterpret_cast<const uint4*>(vals);
    }
  };
  T* dqkv = static_cast<T*>(P.dqkv);

  // query side: lanes are query chunks; the staged tiles hold (k | v)
  for (int q0 = 0; q0 < n; q0 += 32) {
    const int qc = q0 + lane;
    const bool valid = qc < n;
    const size_t qrow = row_of(valid ? qc : 0);
    float q[D], da[D], acc[D];
    load_row(qkv + qrow * 3 * B + hd * D, q);
    load_row(dA + qrow * B + hd * D, da);
    auto score = [&](int j) {
      float k[D];
      load_row(tile_s + j * 2 * B + hd * D, k);
      return dot(q, k) * scale + b_s[j];
    };
    auto dp_of = [&](int j) {
      float v[D];
      load_row(tile_s + j * 2 * B + B + hd * D, v);
      return dot(da, v);
    };

    float mx = -INFINITY, sum = 0.f;
    for (int k0 = 0; k0 < n; k0 += kTile) {
      const int kt = min(kTile, n - k0);
      load_tile(qkv + B, 3 * B, qkv + 2 * B, 3 * B, k0, kt);
      for (int j = 0; j < kt; ++j) {
        const float sc = score(j);
        const float mn = fmaxf(mx, sc);
        sum = sum * expf(mx - mn) + expf(sc - mn);
        mx = mn;
      }
    }

#pragma unroll
    for (int t = 0; t < D; ++t) acc[t] = 0.f;
    float rowsum = 0.f;
    for (int k0 = 0; k0 < n; k0 += kTile) {
      const int kt = min(kTile, n - k0);
      if (!one_tile) load_tile(qkv + B, 3 * B, qkv + 2 * B, 3 * B, k0, kt);
      for (int j = 0; j < kt; ++j) {
        const float pj = expf(score(j) - mx) / sum;
        const float w = round_to<T>(pj);
        float v[D];
        load_row(tile_s + j * 2 * B + B + hd * D, v);
#pragma unroll
        for (int t = 0; t < D; ++t) acc[t] = fmaf(w, v[t], acc[t]);
        rowsum = fmaf(pj, dot(da, v), rowsum);
      }
    }
    if (valid) store_row(static_cast<T*>(p.a) + qrow * B + hd * D, acc);

#pragma unroll
    for (int t = 0; t < D; ++t) acc[t] = 0.f;
    for (int k0 = 0; k0 < n; k0 += kTile) {
      const int kt = min(kTile, n - k0);
      if (!one_tile) load_tile(qkv + B, 3 * B, qkv + 2 * B, 3 * B, k0, kt);
      for (int j = 0; j < kt; ++j) {
        const float pj = expf(score(j) - mx) / sum;
        const float ds = round_to<T>(pj * (dp_of(j) - rowsum) * scale);
        float k[D];
        load_row(tile_s + j * 2 * B + hd * D, k);
#pragma unroll
        for (int t = 0; t < D; ++t) acc[t] = fmaf(ds, k[t], acc[t]);
      }
    }
    if (valid) {
      store_row(dqkv + qrow * 3 * B + hd * D, acc);
      float* st = P.stats + (qrow * h + hd) * kNumRowStats;
      st[0] = mx;
      st[1] = sum;
      st[2] = rowsum;
    }
  }

  // key side: lanes are key chunks; the staged tiles hold (q | dA). The
  // statistics written above are read after load_tile's barrier.
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int kc = k0 + lane;
    const bool valid = kc < n;
    const size_t krow = row_of(valid ? kc : 0);
    const float kb = key_bias(valid ? kc : 0);
    float kk[D], vv[D], dk[D], dv[D];
    load_row(qkv + krow * 3 * B + B + hd * D, kk);
    load_row(qkv + krow * 3 * B + 2 * B + hd * D, vv);
#pragma unroll
    for (int t = 0; t < D; ++t) dk[t] = dv[t] = 0.f;
    for (int c0 = 0; c0 < n; c0 += kTile) {
      const int ct = min(kTile, n - c0);
      load_tile(qkv, 3 * B, dA, B, c0, ct);
      for (int i = 0; i < ct; ++i) {
        const float* st = P.stats + (row_of(c0 + i) * h + hd) * kNumRowStats;
        float qv[D], dav[D];
        load_row(tile_s + i * 2 * B + hd * D, qv);
        load_row(tile_s + i * 2 * B + B + hd * D, dav);
        const float pj = expf(dot(qv, kk) * scale + kb - st[0]) / st[1];
        const float ds =
            round_to<T>(pj * (dot(dav, vv) - st[2]) * scale);
        const float w = round_to<T>(pj);
#pragma unroll
        for (int t = 0; t < D; ++t) {
          dv[t] = fmaf(w, dav[t], dv[t]);
          dk[t] = fmaf(ds, qv[t], dk[t]);
        }
      }
    }
    if (valid) {
      store_row(dqkv + krow * 3 * B + B + hd * D, dk);
      store_row(dqkv + krow * 3 * B + 2 * B + hd * D, dv);
    }
  }
}

template <typename T, int D>
int launch_core(const DptAttnBwdParams& P, cudaStream_t stream) {
  const size_t smem = core_bwd_smem<T>(P.f.Bq);
  cudaError_t err = cudaFuncSetAttribute(
      inter_bwd_core_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  inter_bwd_core_kernel<T, D><<<dim3(P.f.S, P.f.M), 32 * P.f.h, smem,
                                stream>>>(P, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const DptAttnBwdParams& P, void* ws_act, float* ws_f32,
               cudaStream_t stream) {
  const int d = P.f.Bq / P.f.h;
  if ((d != 32 && d != 64) || P.f.h > 8 || P.f.Bq % 64 || P.f.Bq > P.f.B)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention_bwd<T>(
      P, ws_act, ws_f32, stream,
      [d](const DptAttnBwdParams& q, cudaStream_t st) {
        return d == 32 ? launch_core<T, 32>(q, st) : launch_core<T, 64>(q, st);
      });
}

}  // namespace

extern "C" {

// Workspace of either attention backward: n_act elements of the compute
// dtype (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats; Bq the heads'
// width (B for the full sublayer).
int ctn_dpt_attn_bwd_workspace(int M, int n, int S, int B, int h, int Bq,
                               int elem_bytes, long long* n_act,
                               long long* n_f32) {
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
