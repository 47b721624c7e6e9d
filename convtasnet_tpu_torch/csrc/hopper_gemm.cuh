// The Hopper product core of the TCN block kernels (B1, B2, B3): bf16
// wgmma.mma_async products with f32 accumulation, fed from shared memory
// through a ring of cp.async slabs. Everything here is inline PTX, so the
// build needs no header beyond the CUDA runtime's.
//
// Shared-memory operands use the 128-byte swizzle. A "panel" is a run of
// 128-byte lines whose base is 1024-byte aligned; 16-byte chunk c of line l
// sits at l * 128 + ((c ^ (l % 8)) * 16), the layout that wgmma's
// descriptor (layout type 1) reads. Two kinds of operand:
//
//   K-major  (the depth contiguous in memory: x, y, g, dh_pre as left
//            operands; W_out [H,B] and W_in [B,H] read as W_out^T and
//            W_in^T): one panel per 64 of depth, one line per row. A
//            descriptor walks the depth of a panel in 32-byte steps; rows
//            go in groups of 8 lines (SBO 1024 bytes).
//   MN-major (the rows of the product contiguous: W_in [B,H] and W_eff
//            [H,B] as right operands; hn2^T, x^T as the left operands of
//            the weight gradients): one panel per 64 columns of a 64-deep
//            slab, one line per depth row. The descriptor steps 2048 bytes
//            (16 depth rows) per k16, groups of 8 depth rows are 1024 bytes
//            apart (SBO) and panels 8192 (LBO). wgmma's transpose bit
//            reads them, so no weight or activation is ever transposed.
//
// A warpgroup (128 threads) owns 64 rows of a CTA's output tile and a
// BN-wide accumulator of BN / 2 floats per thread: accumulator i of
// thread t holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (t % 4) + i % 2 (acc_row / acc_col below).
//
// The ring (ring_run): kStages slots; slab i is copied by every thread with
// cp.async into slot i % kStages, kStages - 1 slabs ahead of the one being
// multiplied; a slab's copies are one commit group, so waiting for all but
// the newest kStages - 2 groups means slab i has landed. Each thread then
// fences its copies to the async proxy (wgmma reads through it) and the
// block barrier both publishes them and tells the copier of slot
// (i - 1) % kStages that every warpgroup is done with it (each waits for
// its own wgmma before the next barrier). Rows or depth rows beyond the
// operand's end are zero-filled by the copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWgThreads = 128;            // one warpgroup
constexpr int kSlabK = 64;                 // depth of one slab (one line)
constexpr uint32_t kLine = 128;            // bytes per swizzled line
constexpr uint32_t kMnPanel = kSlabK * kLine;  // one MN-major panel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned shared address at or after p's.
__device__ __forceinline__ uint32_t align_1024(const void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

// Byte offset of 16-byte chunk c of line l in a swizzled panel.
__device__ __forceinline__ uint32_t swz(int l, int c) {
  return static_cast<uint32_t>(l) * kLine +
         (static_cast<uint32_t>(c ^ (l & 7)) << 4);
}

// 16-byte global -> shared copy; zero-filled when !valid (src unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes (plain or cp.async) visible to
// the async proxy that wgmma reads through; a barrier must follow.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (1ull << 62);  // 128-byte swizzle
}
// K-major operand at addr (a panel's line 0 plus a 32-byte depth step).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}
// MN-major operand at addr: panels kMnPanel apart (LBO), groups of 8
// depth rows 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return make_desc(addr, kMnPanel, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = A (64 x 16) @ B (16 x N) + (scale_d ? d : 0), bf16
// operands from shared memory; kTA / kTB set: the operand is MN-major.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int BN, int kTA, int kTB>
__device__ __forceinline__ void wg_mma(float (&d)[BN / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma width");
  if constexpr (BN == 64) wgmma_n64<kTA, kTB>(d, da, db, scale_d);
  if constexpr (BN == 128) wgmma_n128<kTA, kTB>(d, da, db, scale_d);
  if constexpr (BN == 256) wgmma_n256<kTA, kTB>(d, da, db, scale_d);
}

// Row and column, in the warpgroup's 64 x BN tile, of accumulator i of the
// calling thread (t = its index in the warpgroup).
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// One 64-deep slab of this warpgroup's product: four k16 steps. a0, b0:
// the operands' addresses at depth 0 of the slab (for A, this warpgroup's
// 64 rows). accumulate false: the first step overwrites d.
template <int BN, bool kTA, bool kTB>
__device__ __forceinline__ void mma_slab(float (&d)[BN / 2], uint32_t a0,
                                         uint32_t b0, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = kTA ? desc_mn(a0 + kk * 2048) : desc_k(a0 + kk * 32);
    const uint64_t db = kTB ? desc_mn(b0 + kk * 2048) : desc_k(b0 + kk * 32);
    wg_mma<BN, kTA ? 1 : 0, kTB ? 1 : 0>(d, da, db,
                                         (accumulate || kk > 0) ? 1 : 0);
  }
}

// The calls around one slab's wgmmas: mma_begin before them, mma_end
// after (it waits for them).
template <int R>
__device__ __forceinline__ void mma_begin(float (&d)[R]) {
  fence_acc(d);
  wgmma_fence();
}
template <int R>
__device__ __forceinline__ void mma_end(float (&d)[R]) {
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
}

// Copies rows [row0, row0 + rows) x depth [col0, col0 + 64) of a row-major
// [*, ld] bf16 matrix into one K-major panel at dst (rows lines); rows at
// or beyond row_end are zero-filled. Called by all n_threads threads.
__device__ __forceinline__ void load_k_panel(uint32_t dst,
                                             const __nv_bfloat16* src, int ld,
                                             int row0, int rows, int row_end,
                                             int col0, int tid, int n_threads) {
  for (int v = tid; v < rows * 8; v += n_threads) {
    const int l = v >> 3, c = v & 7;
    const bool ok = row0 + l < row_end;
    const __nv_bfloat16* s =
        src + static_cast<size_t>(ok ? row0 + l : 0) * ld + col0 + 8 * c;
    cp_async16(dst + swz(l, c), s, ok);
  }
}

// Copies depth rows [k0, k0 + 64) x columns [col0, col0 + cols) of a
// row-major [*, ld] bf16 matrix into cols / 64 MN-major panels at dst;
// depth rows at or beyond k_end and columns at or beyond col_end (in whole
// chunks of 8) are zero-filled.
__device__ __forceinline__ void load_mn_slab(uint32_t dst,
                                             const __nv_bfloat16* src, int ld,
                                             int k0, int k_end, int col0,
                                             int cols, int col_end, int tid,
                                             int n_threads) {
  const int cpl = cols / 8;  // chunks per depth row
  for (int v = tid; v < kSlabK * cpl; v += n_threads) {
    const int l = v / cpl, nc = v % cpl;
    const bool ok = k0 + l < k_end && col0 + 8 * nc < col_end;
    const __nv_bfloat16* s =
        src + (ok ? static_cast<size_t>(k0 + l) * ld + col0 + 8 * nc : 0);
    cp_async16(dst + (nc >> 3) * kMnPanel + swz(l, nc & 7), s, ok);
  }
}

// The ring over n slabs (top note): issue(i, slot) copies slab i into
// slot; pre() runs once after the first copies are in flight (a resident
// operand's prologue); consume(i, slot) multiplies slab i (its wgmmas
// waited for before it returns) and runs any epilogue. All threads of the
// block call it; issue, pre and consume see every thread.
template <int kStages, class Issue, class Pre, class Consume>
__device__ __forceinline__ void ring_run(int n, uint32_t ring,
                                         uint32_t slot_bytes, Issue issue,
                                         Pre pre, Consume consume) {
  static_assert(kStages >= 2, "ring depth");
#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i, ring + i * slot_bytes);
    cp_async_commit();
  }
  pre();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    const int j = i + kStages - 1;
    if (j < n) issue(j, ring + (j % kStages) * slot_bytes);
    cp_async_commit();
    consume(i, ring + (i % kStages) * slot_bytes);
  }
  cp_async_wait<0>();
}

// out[z] = a[rows of chunk z]^T @ b[same rows] in f32, both operands
// row-major over the rows ([rows, ca] and [rows, cb]), so both MN-major:
// the weight gradients' split-row product. CTA: kWG warpgroups, a
// (64 kWG) x BN tile of the output; chunk z covers rows [z * chunk, (z + 1)
// * chunk) (chunk a multiple of 64); rows at or beyond `rows` read as zero.
// Grid (ca / (64 kWG), cb / BN, n_chunks).
template <int kWG, int BN, int kStages>
__global__ void __launch_bounds__(kWG * kWgThreads)
    wgrad_wg_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b, int rows, int ca,
                    int cb, int chunk, float* __restrict__ out_part) {
  extern __shared__ uint8_t wg_smem[];
  constexpr int BM = 64 * kWG;
  constexpr uint32_t kA = BM * kLine, kSlot = kA + BN * kLine;
  const uint32_t ring = align_1024(wg_smem);
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r0 = blockIdx.z * chunk;
  const int r_end = min(rows, r0 + chunk);
  const int n_slabs = (r_end - r0 + kSlabK - 1) / kSlabK;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  ring_run<kStages>(
      n_slabs, ring, kSlot,
      [&](int s, uint32_t slot) {
        load_mn_slab(slot, a, ca, r0 + s * kSlabK, r_end, m0, BM, ca, tid,
                     kWG * kWgThreads);
        load_mn_slab(slot + kA, b, cb, r0 + s * kSlabK, r_end, n0, BN, cb,
                     tid, kWG * kWgThreads);
      },
      [] {},
      [&](int, uint32_t slot) {
        mma_begin(acc);
        mma_slab<BN, true, true>(acc, slot + wg * kMnPanel, slot + kA, true);
        mma_end(acc);
      });
  float* o = out_part + static_cast<size_t>(blockIdx.z) * ca * cb;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = m0 + 64 * wg + acc_row(t, i);
    const int c = n0 + acc_col(t, i);
    *reinterpret_cast<float2*>(&o[static_cast<size_t>(r) * cb + c]) =
        make_float2(acc[i], acc[i + 1]);
  }
}

// Shared memory a wgrad_wg_kernel launch needs (the ring plus alignment).
template <int kWG, int BN, int kStages>
constexpr size_t wgrad_wg_smem() {
  return static_cast<size_t>(kStages) * (64 * kWG + BN) * kLine + 1024;
}

// The core alone, for its check against torch.matmul: c [M, N] (f32) =
// A @ B with A stored [M, K] (kTA false) or [K, M] (true) and B stored
// [N, K] (kTB false) or [K, N] (true). M % 8 == 0, N % BN == 0,
// K % 64 == 0. CTA: two warpgroups, a 128 x BN tile.
template <int BN, bool kTA, bool kTB>
__global__ void __launch_bounds__(2 * kWgThreads)
    wg_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b, float* __restrict__ c,
                     int M, int N, int K) {
  extern __shared__ uint8_t wg_smem[];
  constexpr int BM = 128, kStages = 4, kThreads = 2 * kWgThreads;
  constexpr uint32_t kA = BM * kLine, kSlot = kA + BN * kLine;
  const uint32_t ring = align_1024(wg_smem);
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  ring_run<kStages>(
      K / kSlabK, ring, kSlot,
      [&](int s, uint32_t slot) {
        if constexpr (kTA)
          load_mn_slab(slot, a, M, s * kSlabK, K, m0, BM, M, tid, kThreads);
        else
          load_k_panel(slot, a, K, m0, BM, M, s * kSlabK, tid, kThreads);
        if constexpr (kTB)
          load_mn_slab(slot + kA, b, N, s * kSlabK, K, n0, BN, N, tid,
                       kThreads);
        else
          load_k_panel(slot + kA, b, K, n0, BN, N, s * kSlabK, tid, kThreads);
      },
      [] {},
      [&](int, uint32_t slot) {
        const uint32_t a0 = slot + (kTA ? wg * kMnPanel : wg * 64 * kLine);
        mma_begin(acc);
        mma_slab<BN, kTA, kTB>(acc, a0, slot + kA, true);
        mma_end(acc);
      });
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = m0 + 64 * wg + acc_row(t, i);
    if (r < M)
      *reinterpret_cast<float2*>(
          &c[static_cast<size_t>(r) * N + n0 + acc_col(t, i)]) =
          make_float2(acc[i], acc[i + 1]);
  }
}

}  // namespace
