// The dual-path FFN sublayer backward for Hopper (sm_90a), bf16 or f32.
//
// Replaces convtasnet_tpu/ops/pallas/dpt_ffn.py::_ffn_bwd_kernel (wrapper
// fused_ffn_bwd). From the rows x [R, B] and the cotangent g of the output
// it returns dx, dgamma, dbeta, dW_up, db_up, dW_down and db_down,
// recomputing the forward from x (only the primals are saved, as the JAX
// rule _fused_ffn_fwd does), with the Pallas body's rounding points:
//
//   y    = round(LN(x) * gamma + beta)             f32 statistics
//   pre  = round(round(y W_up) + round(b_up))
//   h    = round(gelu(pre)), gelu'(pre)           tanh-GELU in f32
//   dh   = g W_down^T                              f32
//   dpre = round(dh * gelu'(pre))
//   dW_down = h^T g, db_down = sum g, dW_up = y^T dpre, db_up = sum dpre
//   dy   = dpre W_up^T (f32), then the LN backward and the residual.
//
// What bounds it on the card. At the DPT quality default (B=256, F=1024)
// and B=8 x 4 s (R = 25,600 rows) the five products of 2 R B F (pre
// recomputed, dh, dy, dW_up, dW_down) are 67.1 GFLOP: 68 us at 989 TFLOP/s,
// against 39 MB of x, g and dx (12 us at 3.35 TB/s): compute-bound. The Pallas kernel kept a [kt, F]
// hidden tile in VMEM and summed the weight gradients across its sequential
// grid. Here (dpt_bwd_common.cuh for the shared launches):
//   T  W_up^T, W_down^T;  L  y;
//   U  pre, from the 64 x 64 tile's epilogue;
//   G  dh = g W_down^T on the same tile, whose epilogue turns pre into h in
//      place and writes dpre: h and dpre [R, F] (52 MB each in bf16) go
//      through device memory once;
//   W  dW_down, dW_up over fixed row chunks, db_up, db_down by column sums;
//   D  dy = dpre W_up^T (f32);  N  the LN backward: dx, dgamma, dbeta.
// The [R, F] round trips (~210 MB in bf16, ~63 us) and the 64 x 64 tiles'
// rate are the design's cost over the bound.
//
// Under tensor parallelism (partial, the backward of the Pallas kernel's
// partial=True) the weights are one shard's hidden slice (F is F/m here),
// the forward added neither b_down nor the residual, so db_down is zero
// and dx = round(dx_ln) has no g term.

#include "dpt_bwd_common.cuh"

namespace {

// tanh-GELU and its derivative in f32 (_gelu_and_grad of the Pallas
// backward, jax.nn.gelu's approximate=True).
__device__ __forceinline__ void gelu_and_grad(float x, float* y, float* dy) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float a = 0.044715f;
  const float x3 = x * x * x;
  const float t = tanhf(c * (x + a * x3));
  *y = 0.5f * x * (1.f + t);
  *dy = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * a * x * x);
}

// U: pre = round(round(y W_up) + round(b_up)).
template <typename T>
struct UpBias {
  T* pre;
  const float* b_up;
  __device__ void operator()(size_t i, int col, float v) const {
    pre[i] = from_f<T>(round_to<T>(v) + round_to<T>(b_up[col]));
  }
};

// G: dh = v; h over pre in place, dpre = round(dh * gelu'(pre)).
template <typename T>
struct GeluBwd {
  T* pre_h;
  T* dpre;
  __device__ void operator()(size_t i, int, float v) const {
    float h, dg;
    gelu_and_grad(to_f<T>(pre_h[i]), &h, &dg);
    pre_h[i] = from_f<T>(h);
    dpre[i] = from_f<T>(v * dg);
  }
};

struct FfnBwdParams {
  const void* x;
  const void* g;
  const float* gamma;
  const float* beta;
  const void* w_up;
  const float* b_up;
  const void* w_down;
  void* dx;
  float* dgb;       // [2, B]: dgamma, dbeta
  float* dw_up;     // [B, F]
  float* db_up;     // [F]
  float* dw_down;   // [F, B]
  float* db_down;   // [B]
  int R, B, F, partial;
};

// Workspace: n_act elements of T (w_up_t [F, B], w_down_t [B, F], y [R, B],
// h [R, F], dpre [R, F]) and n_f32 floats (dy [R, B], the chunk partials of
// the weight and bias gradients, the LN partials), each segment on a
// 256-byte boundary.
struct FfnBwdLayout {
  size_t act[5];
  size_t f32[3];
  size_t n_act, n_f32;
};

FfnBwdLayout ffn_bwd_layout(int R, int B, int F, size_t elem_bytes) {
  FfnBwdLayout L;
  const size_t rb = static_cast<size_t>(R) * B;
  const size_t rf = static_cast<size_t>(R) * F;
  const size_t bf = static_cast<size_t>(B) * F;
  const size_t act[5] = {bf, bf, rb, rf, rf};
  const size_t f32[3] = {rb, static_cast<size_t>(n_row_chunks(R)) * bf,
                         static_cast<size_t>(n_row_tiles(R)) * 2 * B};
  size_t off = 0;
  for (int i = 0; i < 5; ++i) {
    L.act[i] = off;
    off += align_elems(act[i], 256 / elem_bytes);
  }
  L.n_act = off;
  off = 0;
  for (int i = 0; i < 3; ++i) {
    L.f32[i] = off;
    off += align_elems(f32[i], 64);
  }
  L.n_f32 = off;
  return L;
}

template <typename T>
int launch_bwd(const FfnBwdParams& p, void* ws_act, float* ws_f32,
               cudaStream_t stream) {
  const FfnBwdLayout L = ffn_bwd_layout(p.R, p.B, p.F, sizeof(T));
  T* act = static_cast<T*>(ws_act);
  T* w_up_t = act + L.act[0];
  T* w_down_t = act + L.act[1];
  T* y = act + L.act[2];
  T* h = act + L.act[3];
  T* dpre = act + L.act[4];
  float* dy = ws_f32 + L.f32[0];
  float* wpart = ws_f32 + L.f32[1];
  float* lnpart = ws_f32 + L.f32[2];
  const int R = p.R, B = p.B, F = p.F;
  const T* g = static_cast<const T*>(p.g);
  CTN_RETURN_IF(launch_transpose<T>(p.w_up, w_up_t, B, F, stream));
  CTN_RETURN_IF(launch_transpose<T>(p.w_down, w_down_t, F, B, stream));
  CTN_RETURN_IF(launch_ln_rows<T>(p.x, R, B, p.gamma, p.beta, y, stream));
  CTN_RETURN_IF(launch_gemm_rows<T>(y, static_cast<const T*>(p.w_up), R, B, F,
                                    UpBias<T>{h, p.b_up}, stream));
  CTN_RETURN_IF(launch_gemm_rows<T>(g, w_down_t, R, B, F,
                                    GeluBwd<T>{h, dpre}, stream));
  CTN_RETURN_IF(launch_wgrad<T>(h, g, R, F, B, wpart, p.dw_down, stream));
  CTN_RETURN_IF(launch_wgrad<T>(y, dpre, R, B, F, wpart, p.dw_up, stream));
  // the column sums' partials (ceil(R/kColRows) * F floats) fit in wpart
  CTN_RETURN_IF(launch_colsum<T>(dpre, R, F, wpart, p.db_up, stream));
  if (p.partial)   // the partial forward added no down bias
    CTN_RETURN_IF(static_cast<int>(cudaMemsetAsync(
        p.db_down, 0, static_cast<size_t>(B) * sizeof(float), stream)));
  else
    CTN_RETURN_IF(launch_colsum<T>(g, R, B, wpart, p.db_down, stream));
  CTN_RETURN_IF(launch_gemm_rows<T>(dpre, w_up_t, R, F, B, StoreF32{dy},
                                    stream));
  return launch_ln_bwd<T>(p.x, g, dy, p.gamma, R, B, p.dx, lnpart, p.dgb,
                          !p.partial, stream);
}

FfnBwdParams make_params(const void* x, const void* g, const void* gamma,
                         const void* beta, const void* w_up, const void* b_up,
                         const void* w_down, void* dx, void* dgb, void* dw_up,
                         void* db_up, void* dw_down, void* db_down, int R,
                         int B, int F, int partial) {
  FfnBwdParams p;
  p.x = x;
  p.g = g;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.w_up = w_up;
  p.b_up = static_cast<const float*>(b_up);
  p.w_down = w_down;
  p.dx = dx;
  p.dgb = static_cast<float*>(dgb);
  p.dw_up = static_cast<float*>(dw_up);
  p.db_up = static_cast<float*>(db_up);
  p.dw_down = static_cast<float*>(dw_down);
  p.db_down = static_cast<float*>(db_down);
  p.R = R;
  p.B = B;
  p.F = F;
  p.partial = partial;
  return p;
}

}  // namespace

#define CTN_FFN_BWD_ARGS                                                     \
  const void *x, const void *g, const void *gamma, const void *beta,        \
      const void *w_up, const void *b_up, const void *w_down, void *ws_act, \
      void *ws_f32, void *dx, void *dgb, void *dw_up, void *db_up,          \
      void *dw_down, void *db_down, int R, int B, int F, int partial,     \
      void *stream
#define CTN_FFN_BWD_CALL                                                    \
  make_params(x, g, gamma, beta, w_up, b_up, w_down, dx, dgb, dw_up, db_up, \
              dw_down, db_down, R, B, F, partial),                          \
      ws_act, static_cast<float*>(ws_f32), static_cast<cudaStream_t>(stream)

extern "C" {

// Workspace of the FFN backward: n_act elements of the compute dtype
// (elem_bytes 2 for bf16, 4 for f32) and n_f32 floats.
int ctn_dpt_ffn_bwd_workspace(int R, int B, int F, int elem_bytes,
                              long long* n_act, long long* n_f32) {
  const FfnBwdLayout L = ffn_bwd_layout(R, B, F, elem_bytes);
  *n_act = static_cast<long long>(L.n_act);
  *n_f32 = static_cast<long long>(L.n_f32);
  return 0;
}

// One FFN sublayer backward; every pointer is device memory: x, g, w_up,
// w_down, dx and ws_act in the compute dtype, the rest f32; dgb [2, B] =
// dgamma, dbeta; partial: the backward of a shard's partial forward.
// Returns the first CUDA error of its launches.
int ctn_dpt_ffn_bwd_f32(CTN_FFN_BWD_ARGS) {
  return launch_bwd<float>(CTN_FFN_BWD_CALL);
}

int ctn_dpt_ffn_bwd_bf16(CTN_FFN_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16>(CTN_FFN_BWD_CALL);
}

}  // extern "C"
