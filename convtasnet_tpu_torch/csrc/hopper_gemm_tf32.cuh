// The f32 product core of the TCN block kernels redesigned for Hopper in
// f32 (B1 under every norm, the gLN backward B2, and the pairs B4, B5
// through them): 3xTF32 products on the tensor cores with f32
// accumulation. Beside hopper_gemm.cuh (the bf16 core), whose ring,
// descriptors, swizzle and fences it reuses as they are.
//
// Why 3xTF32. One TF32 product keeps 10 bits of each operand's mantissa
// (~3e-4 relative at the block's depths), and the f32 kernels are held to
// f32 (2e-3 forward, 4e-3 backward of the twin, which runs its products in
// full f32). Each operand v is split into hi = rna(v) and lo = rna(v - hi)
// (tf32_rna: the rounding of cvt.rna.tf32.f32; v - hi is exact in f32),
// and a product is summed as lo*hi + hi*lo + hi*hi: the dropped lo*lo and
// the rounding of lo leave ~2^-21 of each term, f32-grade (a numpy model,
// tests/test_torch_tf32_split.py, reads 7e-8 against 2.9e-4 for one TF32
// product; on the card see slab_issue). The tensor cores run TF32 at 495
// TFLOP/s, so three products a product is 165 TFLOP/s, 2.5x the card's 67
// TFLOP/s f32 FMA rate that bounded the first design.
//
// wgmma (the row-tile stages: A' and R1, C', G1', G2b'). TF32 wgmma reads its
// shared-memory operands K-major only (no transpose bit, unlike bf16), and
// takes its left operand A from registers. So:
//   - the left operand (x, y, g, dh_pre: activations, the depth contiguous
//     in memory) lands raw in K-major 128-byte swizzled panels (a line is
//     one row's 32 depth values), and each thread loads its m64k8
//     fragments from there (a0 (r, k), a1 (r + 8, k), a2 (r, k + 4), a3
//     (r + 8, k + 4), r = 16 warp + lane / 4, k = lane % 4: CUTLASS's
//     ALayout_64x8 of the SM90 F32TF32TF32_RS atoms; the swizzle puts the
//     32 lanes' words in 32 banks) and splits them in registers: no hi/lo
//     copy of an activation is ever stored;
//   - the right operand is a weight, written once per call by the prep
//     launch as K-major tf32 hi and lo copies ([N, D]: W_in^T and W_eff^T
//     transposed there, W_out and W_in as stored), which land as two
//     panels.
// A CTA is two warpgroups over 128 rows of one sample (kWgRows), as in the
// bf16 stages, and walks every column tile of its product, BN = 128 or 64
// wide; a 32-deep slab is a 16 KB left panel plus 2 x BN x 128 bytes of
// right panels: 48 KB at BN = 128, a 4-slab ring 192 KB of the 227 KB. The
// left operand is re-read from L2 for each column tile instead of staying
// resident: 128 rows of f32 at H = 512 are 256 KB, past shared memory. Per
// slab each thread loads 16 words, splits them, and issues 12 wgmmas
// (three a k8 step) into a fresh accumulator, which f32 adds join to the
// tile's (slab_issue says why).
//
// The ring (rows_tf32_run) is fed by TMA: thread 0 copies a slab's three
// panels with three tensor-map copies that complete on the slot's
// mbarrier, and the warpgroups release a slot on another, so they wait on
// no block barrier a slab and one may run ahead of the other. On an H100
// a first design of this core, a cp.async ring with a barrier a slab, ran
// slower: its copies (16-byte cp.async from every thread, two slabs in
// flight) and the lock-step of its two warpgroups each took about twice
// the tensor work. The core's time beside its bound is in PERF.md.
//
// mma.sync (W', the weight gradients dW_out = hn2^T g and dW_in = x^T
// dh_pre). Their depth is the rows: both operands are MN-major in memory,
// which TF32 wgmma cannot read from shared memory without a transpose.
// mma.sync.m16n8k8's fragments are loaded by ld.shared from any layout, so
// here both slabs stay row-major as copied and each fragment is gathered
// transposed, with no staging pass: a0 (m = g, k = q), a1 (g + 8, q), a2
// (g, q + 4), a3 (g + 8, q + 4); b0 (k = q, n = g), b1 (q + 4, g); g = lane
// / 4, q = lane % 4. The slabs' rows are padded by 8 floats, so the 32
// lanes' words fall in 32 banks.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kSlabF = 32;   // depth of one f32 slab: one 128-byte line

// hi and lo of v's 3xTF32 split, as the tf32 bit patterns wgmma and
// mma.sync read: the bits of cvt.rna.tf32.f32 (round to nearest, ties away
// from zero, on the magnitude) by an integer add and mask, which a finite v
// rounds exactly as the conversion does (the card test holds the two bit
// for bit) at full integer rate: on an H100 the conversion instruction
// made the weight-gradient product 10% slower and the row-tile product 4%.
// v - hi is exact in f32.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}
// The conversion instruction itself, for the card test of tf32_rna.
__device__ __forceinline__ uint32_t tf32_cvt_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d (64 x N, f32) += A (64 x 8, tf32 in registers) @ B (8 x N, tf32, K-major
// in shared memory at descriptor db); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wg_tf32(float (&d)[BN / 2],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  static_assert(BN == 64 || BN == 128, "tf32 wgmma width");
  if constexpr (BN == 64) wgmma_tf32_n64(d, a, db, scale_d);
  if constexpr (BN == 128) wgmma_tf32_n128(d, a, db, scale_d);
}

// Keeps registers that an asynchronous wgmma reads (its A fragments) alive
// and unmoved until after the wait that follows it.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// One 32-deep slab of this warpgroup's 3xTF32 product, in two calls:
// slab_issue loads the warpgroup's A fragments from the left panel (a_gen:
// the generic address of its first line), splits them and issues the
// slab's 12 wgmmas (three a k8 step, b_hi and b_lo the shared addresses of
// the right operand's two panels) into a fresh accumulator part, without
// waiting; slab_finish waits for them and adds part to d with f32 adds.
// Between the two the caller may issue the ring's next copies. The
// tensor cores' own accumulation truncates: on an H100 a 256-deep product
// that summed every slab into d read several times further from f64 than
// torch.matmul in f32; a chain of 12 of them per slab, the slabs joined by
// rounded adds, keeps that bias to one slab's, and the core then reads
// about as far as torch.matmul (chip_smoke.py's f32 stages phase prints
// both).
template <int BN>
__device__ __forceinline__ void slab_issue(float (&part)[BN / 2],
                                           uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4],
                                           const uint8_t* a_gen,
                                           uint32_t b_hi, uint32_t b_lo) {
  const int t = threadIdx.x % kWgThreads;
  const int r = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = *reinterpret_cast<const float*>(
          a_gen + swz(r + 8 * (j & 1), 2 * kk + (j >> 1)) + 4 * q);
      split_tf32(v, ah[kk][j], al[kk][j]);
    }
  mma_begin(part);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wg_tf32<BN>(part, al[kk], desc_k(b_hi + 32 * kk), kk > 0 ? 1 : 0);
    wg_tf32<BN>(part, ah[kk], desc_k(b_lo + 32 * kk), 1);
    wg_tf32<BN>(part, ah[kk], desc_k(b_hi + 32 * kk), 1);
  }
  wgmma_commit();
}
template <int BN>
__device__ __forceinline__ void slab_finish(float (&d)[BN / 2],
                                            float (&part)[BN / 2],
                                            uint32_t (&ah)[4][4],
                                            uint32_t (&al)[4][4]) {
  wgmma_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(ah[kk]);
    fence_regs(al[kk]);
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] += part[i];
}

// ---- The ring of the row-tile stages: TMA copies and mbarriers ----

// An mbarrier in shared memory at bar.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for the phase of bar with this parity to complete. A wait that
// outlasts ~2^24 polls traps: a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1 << 24)) __trap();
  }
}

// One box of a 3-D tensor map into shared memory at dst, its bytes
// counted on bar.
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The tensor maps of one row-tile product (a kernel parameter, read by
// the TMA unit where it lies), each 3-D: the left operand [M, K, D] in
// boxes of 32 x 128 x 1 (rows at or beyond K read as zeros), and the right
// operand's hi and lo copies [1, N, D] in boxes of 32 x BN x 1; all with
// the 128-byte swizzle, the layout the panels' readers take.
struct RowsMaps {
  CUtensorMap a, w_hi, w_lo;
};

// Bytes of a rows_tf32_run ring of kStages slabs and its mbarriers (two a
// slot), and the shared memory a stage needs for it (plus alignment).
template <int BN, int kStages>
__host__ __device__ constexpr uint32_t rows_tf32_ring_bytes() {
  return kStages * (kWgRows + 2 * BN) * kLine + 2 * kStages * 8;
}
template <int BN, int kStages>
constexpr size_t rows_tf32_smem() {
  return 1024 + rows_tf32_ring_bytes<BN, kStages>();
}

// The row-tile product of the wgmma stages: rows [r0, r0 + 128) of sample
// m of the left operand (maps.a; depth D) times the K-major right operand
// [N, D] (maps.w_hi, maps.w_lo), column tile by column tile of BN. After
// each tile's last slab, epi(acc, n0) sees this thread's accumulators of
// its warpgroup's 64 rows (acc_row / acc_col), and may hold a barrier of
// the whole block. Called by every thread of a 256-thread CTA, ring at the
// 1024-byte aligned shared address ring of the dynamic shared memory at
// smem; it begins with a barrier, so a left operand the block wrote just
// before must be fenced to the async proxy first (fence.proxy.async).
//
// The ring: kStages slots, each a slab's left panel and right hi and lo
// panels, filled by three TMA copies that thread 0 issues kStages - 1 slabs
// ahead and that complete on the slot's full barrier; every thread
// arrives on the slot's empty barrier when its warpgroup's wgmmas on it
// are done, and thread 0 waits for that before it copies into the slot
// again. The two warpgroups so wait on no barrier of each other's but
// those, and one may run a slab ahead.
template <int BN, int kStages, class Epi>
__device__ __forceinline__ void rows_tf32_run(uint8_t* smem, uint32_t ring,
                                              const RowsMaps& maps, int m,
                                              int r0, int D, int N,
                                              Epi epi) {
  static_assert(kStages >= 2, "ring depth");
  constexpr uint32_t kA = kWgRows * kLine, kB = BN * kLine;
  constexpr uint32_t kSlot = kA + 2 * kB;
  const uint32_t bars = ring + kStages * kSlot;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int nk = D / kSlabF, n = (N / BN) * nk;
  const int tid = threadIdx.x, wg = tid / kWgThreads;
  auto issue = [&](int i) {
    const int s = i % kStages;
    const uint32_t slot = ring + s * kSlot;
    const int k0 = (i % nk) * kSlabF, n0 = (i / nk) * BN;
    mbar_expect_tx(full(s), kSlot);
    tma_3d(slot, &maps.a, full(s), k0, r0, m);
    tma_3d(slot + kA, &maps.w_hi, full(s), k0, n0, 0);
    tma_3d(slot + kA + kB, &maps.w_lo, full(s), k0, n0, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgCta);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages - 1 && i < n; ++i) issue(i);
  }
  __syncthreads();
  float acc[BN / 2], part[BN / 2];
  uint32_t ah[4][4], al[4][4];   // [k8 step][fragment register]
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int j = i + kStages - 1;   // into the slot slab i - 1 held
    if (tid == 0 && j < n) {
      if (j >= kStages) mbar_wait(empty(j % kStages), (j / kStages - 1) & 1);
      issue(j);
    }
    __syncwarp();   // warp 0 whole again before the warpgroup's wgmmas
    mbar_wait(full(s), (i / kStages) & 1);
    const uint32_t slot = ring + s * kSlot;
    slab_issue<BN>(part, ah, al, smem_ptr(smem, slot) + wg * 64 * kLine,
                   slot + kA, slot + kA + kB);
    slab_finish<BN>(acc, part, ah, al);
    mbar_arrive(empty(s));
    if (i % nk == nk - 1) {   // the tile's sums to the epilogue, the next from 0
      epi(acc, (i / nk) * BN);
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
    }
  }
}

// Host side: cuTensorMapEncodeTiled, looked up once through the runtime's
// entry-point query (no link against libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A row-major f32 tensor [outer, rows, D] (outer 1 for a matrix) as a
// tensor map of boxes 32 x box_rows x 1 with the 128-byte swizzle; the
// region past its edges reads as zeros. Returns a CUDA error code.
inline int make_rows_map(CUtensorMap* map, const float* p, int D, int rows,
                         int outer, int box_rows) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * sizeof(float),
                                 static_cast<cuuint64_t>(D) * rows *
                                     sizeof(float)};
  const cuuint32_t box[3] = {kSlabF, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The maps of a product of rows of a [M, K, D] left operand a with a right
// operand [N, D] split into hi and lo copies of N D floats at w (hi, then
// lo), in column tiles of BN.
inline int make_rows_maps(RowsMaps* maps, const float* a, int M, int K,
                          int D, const float* w, int N, int BN) {
  int err = make_rows_map(&maps->a, a, D, K, M, kWgRows);
  if (err == 0) err = make_rows_map(&maps->w_hi, w, D, N, 1, BN);
  if (err == 0)
    err = make_rows_map(&maps->w_lo, w + static_cast<size_t>(N) * D, D, N,
                        1, BN);
  return err;
}

// ---- W': the weight gradients on mma.sync (the top note) ----

// d (16 x 8) += a (16 x 8) @ b (8 x 8), tf32 fragments, f32 accumulation.
__device__ __forceinline__ void mma_tf32_16x8x8(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kWgradTf32Stages = 3;

template <int BM, int BN>
__host__ __device__ constexpr int wgrad_tf32_threads() {
  return (BM / 64) * (BN / 64) * 32;
}
template <int BM, int BN>
constexpr size_t wgrad_tf32_smem() {
  return 1024 + static_cast<size_t>(kWgradTf32Stages) * kSlabF *
                    ((BM + 8) + (BN + 8)) * sizeof(float);
}

// out_part[z] [ca, cb] = a[rows of chunk z]^T @ b[same rows] in 3xTF32, a
// [rows, ca] and b [rows, cb] row-major f32; chunk z covers rows
// [z chunk, (z + 1) chunk) (chunk a multiple of 32), rows at or beyond
// `rows` read as zero. CTA: a BM x BN output tile (each 64 or 128), one
// warp per 64 x 64 of it (4 x 8 mma tiles, 128 accumulators a thread:
// twice the work a fragment load feeds of a 64 x 32 warp tile, measured
// 16% faster on an H100); the chunk's rows in 32-row slabs through a
// 3-deep cp.async ring (ring_run). Grid (ca / BM, cb / BN, n_chunks).
template <int BM, int BN>
__global__ void __launch_bounds__(wgrad_tf32_threads<BM, BN>())
    wgrad_tf32_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, int rows, int ca, int cb,
                      int chunk, float* __restrict__ out_part) {
  extern __shared__ uint8_t wg_smem[];
  constexpr int kThreads = wgrad_tf32_threads<BM, BN>();
  constexpr int kLda = BM + 8, kLdb = BN + 8;
  constexpr uint32_t kSa = kSlabF * kLda * sizeof(float);
  constexpr uint32_t kSlot = kSa + kSlabF * kLdb * sizeof(float);
  const uint32_t ring = align_1024(wg_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = 64 * (warp / (BN / 64)), wn = 64 * (warp % (BN / 64));
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r0 = blockIdx.z * chunk;
  const int r_end = min(rows, r0 + chunk);
  const int n_slabs = (r_end - r0 + kSlabF - 1) / kSlabF;
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  ring_run<kWgradTf32Stages>(
      n_slabs, ring, kSlot,
      [&](int s, uint32_t slot) {
        const int rb = r0 + s * kSlabF;
        for (int v = tid; v < kSlabF * (BM / 4); v += kThreads) {
          const int l = v / (BM / 4), c = v % (BM / 4);
          const bool ok = rb + l < r_end;
          cp_async16(slot + (l * kLda + 4 * c) * sizeof(float),
                     a + (ok ? static_cast<size_t>(rb + l) * ca + m0 + 4 * c : 0),
                     ok);
        }
        for (int v = tid; v < kSlabF * (BN / 4); v += kThreads) {
          const int l = v / (BN / 4), c = v % (BN / 4);
          const bool ok = rb + l < r_end;
          cp_async16(slot + kSa + (l * kLdb + 4 * c) * sizeof(float),
                     b + (ok ? static_cast<size_t>(rb + l) * cb + n0 + 4 * c : 0),
                     ok);
        }
      },
      [] {},
      [&](int, uint32_t slot) {
        const float* as = reinterpret_cast<const float*>(smem_ptr(wg_smem, slot));
        const float* bs = as + kSlabF * kLda;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* ar = as + (8 * kk + q) * kLda + wm + g;
          const float* br = bs + (8 * kk + q) * kLdb + wn + g;
          uint32_t ah[4][4], al[4][4], bh[8][2], bl[8][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(ar[16 * i], ah[i][0], al[i][0]);
            split_tf32(ar[16 * i + 8], ah[i][1], al[i][1]);
            split_tf32(ar[4 * kLda + 16 * i], ah[i][2], al[i][2]);
            split_tf32(ar[4 * kLda + 16 * i + 8], ah[i][3], al[i][3]);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            split_tf32(br[8 * j], bh[j][0], bl[j][0]);
            split_tf32(br[4 * kLdb + 8 * j], bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              mma_tf32_16x8x8(acc[i][j], al[i], bh[j]);
              mma_tf32_16x8x8(acc[i][j], ah[i], bl[j]);
              mma_tf32_16x8x8(acc[i][j], ah[i], bh[j]);
            }
        }
      });
  float* o = out_part + static_cast<size_t>(blockIdx.z) * ca * cb;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = m0 + wm + 16 * i + g, c = n0 + wn + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(&o[static_cast<size_t>(r) * cb + c]) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(&o[static_cast<size_t>(r + 8) * cb + c]) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

template <int BM, int BN>
int launch_wgrad_tf32_tile(const float* a, const float* b, int rows, int ca,
                           int cb, int chunk, float* out_part,
                           cudaStream_t stream) {
  constexpr size_t smem = wgrad_tf32_smem<BM, BN>();
  auto kernel = wgrad_tf32_kernel<BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ca / BM, cb / BN, (rows + chunk - 1) / chunk),
           wgrad_tf32_threads<BM, BN>(), smem, stream>>>(a, b, rows, ca, cb,
                                                         chunk, out_part);
  return static_cast<int>(cudaGetLastError());
}

// W''s chunk products on the widest tiles that divide ca and cb (each a
// multiple of 64).
inline int launch_wgrad_tf32_chunks(const float* a, const float* b, int rows,
                                    int ca, int cb, int chunk,
                                    float* out_part, cudaStream_t stream) {
  if (ca % 128 == 0)
    return cb % 128 == 0
        ? launch_wgrad_tf32_tile<128, 128>(a, b, rows, ca, cb, chunk,
                                           out_part, stream)
        : launch_wgrad_tf32_tile<128, 64>(a, b, rows, ca, cb, chunk,
                                          out_part, stream);
  return cb % 128 == 0
      ? launch_wgrad_tf32_tile<64, 128>(a, b, rows, ca, cb, chunk, out_part,
                                        stream)
      : launch_wgrad_tf32_tile<64, 64>(a, b, rows, ca, cb, chunk, out_part,
                                       stream);
}

}  // namespace
