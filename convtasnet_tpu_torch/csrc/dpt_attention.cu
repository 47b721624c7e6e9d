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
// and out (7.8 us at 3.35 TB/s): compute-bound. The core between the two
// products is tiny (25 x 25 per (m, s, head)), its rows strided by S rows
// in memory, and n varies with the input (15 s gives n=94).
//
// bf16: the forward frame of dpt_attn_bwd_wg.cuh (launch_attention_fwd_wg),
// as the intra forward B9 runs it, with the core's inter gather (the row of
// each of the n chunks at position s, S rows apart; the key bias per (key
// chunk, s)):
//   F1  per 128-row tile, x resident K-major and normalised in place,
//       qkv = round(y @ W_qkv) on wgmma in 128-column tiles (64 where Bq
//       is not a multiple of 128), W_qkv MN-major through a ring;
//   C   a CTA per (m, s, head), a warp per 16 query chunks with its q
//       fragments in registers, the n chunks' k and v rows of its head
//       staged by cp.async in blocks of up to 256 (at n = 25 one block of
//       32 rows, 2 warps): pass 1 the row max and denominator, pass 2 p,
//       round(p) and a on mma.sync; keys past n in the last 16-key tile
//       masked with -inf, so any n >= 1 runs (n = 1: p = 1);
//   out x + round(a @ W_out) on wgmma per 128-row tile (partial: the
//       product alone; rows_wg_kernel).
// Above B = 256 (to 512) F1 keeps one resident tile and out runs
// 256-column tiles, as B9 does (dpt_attn_bwd_wg.cuh's note); above 512 F1
// streams y through device memory (launch_qkv_streamed there).
// At the default the core's 8,192 CTAs read qkv once (39.3 MB, each CTA a
// 64-byte head slice of 25 rows 196 KB apart) and write a (13.1 MB), a
// floor of ~16 us; it reads ~30 us (PERF.md), under the ~35 us at which a
// CTA per (m, s) over all heads, staging each row's 3Bq columns
// contiguously, would be worth its shared memory. What stands over the
// bound: F1 and out (their LN, x's tile and one CTA per SM, as B9's) and
// the qkv and a round trips (~105 MB).
//
// f32: the first design, three launches: ln_qkv_kernel (dpt_common.cuh,
// FMA products); inter_core_kernel (here): one block per (m, s) stages the
// k and v rows of all heads for up to 32 key chunks at a time in shared
// memory, and each warp takes one head with one query chunk per lane: pass
// 1 the row's max and softmax denominator (online), pass 2 recomputes each
// score, rounds p = exp(score - max) / sum and accumulates p v in f32; and
// out_proj_residual_kernel (dpt_common.cuh). Head widths 16, 32, 64 and
// 128. A block has at most 8 warps: with more heads than that (16 heads of
// 16 at B = 256, 10 to 16 heads of 32 at B = 320 to 512) each warp takes
// the heads warp, warp + warps, ... in turn (core_warps); with 8 heads or
// fewer that is one head a warp, as before. At d = 128 a lane's q, acc and
// k or v rows would not fit
// in registers, so two lanes share a query chunk (InterLanes: G = 2), each
// holding 64 of its dimensions, and each dot product is the two halves'
// sums added by one shuffle; 16 query chunks per warp pass. At d <= 64
// (G = 1) every value and every order of summation is as before.
// Above Bq = 512 (the heads' width; chosen by Bq alone) 32 key chunks of
// k and v for all heads, 256 Bq bytes, pass the block's shared memory at
// Bq = 960, so the core stages fewer per load (kKeys = 0:
// inter_wide_keys in dpt_common.cuh, 16 chunks up to Bq = 1024, 8 up to
// 2048), each warp taking its heads in turn; the online max and
// denominator and every sum still run key by key in order, so the values
// are those a 32-chunk staging would give. Above B = 512 launch 1 runs as
// ln_rows_kernel + gemm_rows_kernel through the output buffer
// (launch_qkv_rows, dpt_bwd_common.cuh).
//
// Under tensor parallelism (partial, the Pallas kernel's partial=True) the
// sublayer runs the h heads of one shard's head group, of width Bq = h * d:
// qkv and a are [R, 3Bq] and [R, Bq], and the last launch writes
// round(a @ W_out[Bq, B]) with no residual. At the quality default's m = 2
// shards (Bq 128, 4 heads) that is 7.0 GFLOP, under the 7.8 us of x in and
// out: bytes-bound.

#include "dpt_attn_wide_head.cuh"

namespace {

constexpr int kKeyTile = kInterKeys;   // key chunks staged per load

// The core's shared memory with kKeys (inter_core_keys).
template <typename T, int kKeys = kKeyTile>
size_t inter_core_smem(int Bq) {
  const int keys = inter_core_keys<T, kKeys>(Bq);
  return align128(static_cast<size_t>(keys) * 2 * Bq * sizeof(T)) +
         keys * sizeof(float);
}

// f32's core (the first design, top note). Grid (S, M); 32 * core_warps(h)
// threads, warp = head (kTurns: heads warp, warp + warps, ... in turn), G
// lanes per query chunk; kKeys key chunks staged per load (0: as many as
// inter_wide_keys gives, above Bq = 512). B below is the heads' width Bq:
// the rows of qkv hold 3Bq values, those of a Bq.
template <typename T, int D, bool kTurns, int kKeys = kKeyTile>
__global__ void __launch_bounds__(256)
    inter_core_kernel(DptAttnParams p, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  constexpr int G = InterLanes<D>::G;
  constexpr int DL = InterLanes<D>::DL;
  const int n = p.n, S = p.S, B = p.Bq;
  const int key_tile = inter_core_keys<T, kKeys>(B);
  T* kv_s = reinterpret_cast<T*>(smem);
  float* b_s = reinterpret_cast<float*>(
      smem + align128(static_cast<size_t>(key_tile) * 2 * B * sizeof(T)));
  const int s = blockIdx.x, m = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % G;   // which DL dimensions of the head
  const size_t stride = static_cast<size_t>(S) * 3 * B;  // chunk to chunk
  const T* base = static_cast<const T*>(p.qkv) +
                  (static_cast<size_t>(m) * n * S + s) * 3 * B;
  const bool one_tile = n <= key_tile;

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

  // one head: warp = head, or with more than 8 heads heads warp,
  // warp + warps, ... in turn
  auto run_head = [&](const int hd) {
    const int col0 = hd * D + sub * DL;   // this lane's columns of the head
    auto score = [&](const float* q, int j) {
      float k[DL];
      load_row(kv_s + j * 2 * B + col0, k);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < DL; ++t) dot = fmaf(q[t], k[t], dot);
      return lanes_sum<G>(dot) * scale + b_s[j];
    };

    for (int q0 = 0; q0 < n; q0 += 32 / G) {
      const int qc = q0 + lane / G;
      const bool valid = qc < n;
      float q[DL];
      load_row(base + static_cast<size_t>(valid ? qc : 0) * stride + col0, q);

      float mx = -INFINITY, sum = 0.f;
      for (int k0 = 0; k0 < n; k0 += key_tile) {
        const int kt = min(key_tile, n - k0);
        load_tile(k0, kt);
        for (int j = 0; j < kt; ++j) {
          const float sc = score(q, j);
          const float mn = fmaxf(mx, sc);
          sum = sum * expf(mx - mn) + expf(sc - mn);
          mx = mn;
        }
      }

      float acc[DL];
#pragma unroll
      for (int t = 0; t < DL; ++t) acc[t] = 0.f;
      for (int k0 = 0; k0 < n; k0 += key_tile) {
        const int kt = min(key_tile, n - k0);
        if (!one_tile) load_tile(k0, kt);
        for (int j = 0; j < kt; ++j) {
          const float w = round_to<T>(expf(score(q, j) - mx) / sum);
          float v[DL];
          load_row(kv_s + j * 2 * B + B + col0, v);
#pragma unroll
          for (int t = 0; t < DL; ++t) acc[t] = fmaf(w, v[t], acc[t]);
        }
      }
      if (valid) {
        T* dst = static_cast<T*>(p.a) +
                 ((static_cast<size_t>(m) * n + qc) * S + s) * B + col0;
#pragma unroll
        for (int t = 0; t < DL; t += V) {
          alignas(16) T vals[V];
#pragma unroll
          for (int e = 0; e < V; ++e) vals[e] = from_f<T>(acc[t + e]);
          *reinterpret_cast<uint4*>(dst + t) =
              *reinterpret_cast<const uint4*>(vals);
        }
      }
    }
  };
  if constexpr (kTurns) {
    for (int hd = warp; hd < p.h; hd += blockDim.x >> 5) run_head(hd);
  } else {
    run_head(warp);
  }
}

template <typename T, int D, bool kTurns, int kKeys = kKeyTile>
int launch_core_turns(const DptAttnParams& p, cudaStream_t stream,
                      float scale) {
  const size_t smem = inter_core_smem<T, kKeys>(p.Bq);
  auto kernel = inter_core_kernel<T, D, kTurns, kKeys>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.S, p.M), 32 * core_warps(p.h), smem, stream>>>(p, scale);
  return static_cast<int>(cudaGetLastError());
}

// A warp a head (kTurns false) up to 8 heads at d >= 32; each warp its
// heads in turn otherwise (core_warps), as at d = 16 at every head count.
// Above Bq = 512 (chosen by Bq alone) fewer key chunks a load (kKeys 0),
// each warp its heads in turn (one each at up to 8 heads).
template <typename T, int D>
int launch_core(const DptAttnParams& p, cudaStream_t stream, float scale) {
  if (p.Bq > kWideMax)
    return launch_core_turns<T, D, true, 0>(p, stream, scale);
  return D == 16 || p.h > 8
             ? launch_core_turns<T, D, true>(p, stream, scale)
             : launch_core_turns<T, D, false>(p, stream, scale);
}

// f32's core for the padded head width D = Bq / h (core_head_width), with
// the real width's softmax scale.
template <typename T>
int launch_core_d(const DptAttnParams& p, cudaStream_t stream, float scale) {
  switch (p.Bq / p.h) {
    case 16: return launch_core<T, 16>(p, stream, scale);
    case 32: return launch_core<T, 32>(p, stream, scale);
    case 64: return launch_core<T, 64>(p, stream, scale);
    case 128: return launch_core<T, 128>(p, stream, scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16: the forward frame of dpt_attn_bwd_wg.cuh with the core's inter
// gather; f32: the first design. d: the heads' real width (its scale);
// above a padded width of 128 the core is the route of
// dpt_attn_wide_head.cuh, in `wide`.
template <typename T>
int launch(const DptAttnParams& p, cudaStream_t stream, int d, float* wide) {
  if (p.Bq % 64 || p.Bq > p.B || !attn_head_widths_ok(p.Bq, p.h, d) ||
      p.Bn < 1 || p.Bn > p.B)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = attn_scale(d);
  auto core = [=](const DptAttnParams& q, cudaStream_t s) {
    if (q.Bq / q.h > kCoreMaxD)
      return launch_wide_head_fwd<T, true>(q, wide, scale, s);
    if constexpr (kIsBf16<T>)
      return launch_fwd_core_d<true>(q, s, scale);
    else
      return launch_core_d<T>(q, s, scale);
  };
  if constexpr (kIsBf16<T>) {
    return launch_attention_fwd_wg(p, stream, core);
  } else {
    return launch_attention<T>(p, stream, core);
  }
}

}  // namespace

extern "C" {

// Floats of the f32 workspace `wide` that the attention kernels of either
// kind (inter != 0: B7, B8; else B9, B10) take beside their arguments at
// padded head width D = Bq / h: the logits of the route above D = 128
// (dpt_attn_wide_head.cuh), for the backward (bwd != 0) or the forward;
// 0 at D <= 128.
int ctn_dpt_attn_wide_workspace(int inter, int M, int n, int S, int Bq, int h,
                                int bwd, long long* n_floats) {
  if (h <= 0 || Bq % h) return static_cast<int>(cudaErrorInvalidValue);
  *n_floats = inter ? wide_head_ws<true>(M, n, S, Bq, h, bwd != 0)
                    : wide_head_ws<false>(M, n, S, Bq, h, bwd != 0);
  return 0;
}

// One inter-chunk attention sublayer (operands: DptAttnParams in
// dpt_common.cuh, d and wide beside them); returns the first CUDA error of
// its launches.
int ctn_dpt_inter_f32(CTN_DPT_ATTN_ARGS) {
  return launch<float>(CTN_DPT_ATTN_PARAMS, static_cast<cudaStream_t>(stream),
                       d, static_cast<float*>(wide));
}

int ctn_dpt_inter_bf16(CTN_DPT_ATTN_ARGS) {
  return launch<__nv_bfloat16>(CTN_DPT_ATTN_PARAMS,
                               static_cast<cudaStream_t>(stream), d,
                               static_cast<float*>(wide));
}

}  // extern "C"
