// Gram matrix and right-hand side (J'J, J'y) of a dense 2-D J in one pass,
// on Hopper's tensor cores (sm_90a).
//
// Replaces leastsquaresoptim_jl_tpu/ops/gram.py::_xtx_pallas (the Pallas
// row-block X'X kernel) and the work its wrapper _gram_pallas adds around
// it: the row tail and the separate J'y gemv. It computes what they compute,
// not their block structure: every row of J is read once per column panel,
// and J'y comes from the same staged tiles.
//
// What bounds it on an H100 SXM (3.35 TB/s; 495 TFLOP/s in TF32, 989 in
// bf16, on the tensor cores). The least traffic is one read of J and y:
// 1 GiB at (2^20, 256) in float32, >= 0.32 ms. The least arithmetic is the
// m n (n + 1) FLOPs of the upper triangle and diagonal. By that bound
// every width the kernel takes is bound by the read of J except config
// #3's (8192, 1024) float32, which is bound by the TF32 rate. In practice
// the float32 route does three TF32 products for each float32 one (the
// split below) and feeds the tensor cores from shared memory: at n >= 128
// shared-memory bandwidth (the wgmma operands, the TMA writes and the
// split) is what it runs into, and at n = 32 and 64 the per-stage work of
// the SM (split, J'y, barriers) beside the read of J.
//
// Design:
// - One block computes one TN x TN tile on or above the diagonal over one
//   chunk of rows (blockIdx.x walks the upper tiles, blockIdx.y the row
//   chunks); a diagonal tile reads one column panel, others two. TN is 128
//   for n >= 128 (two consumer warpgroups of 64 rows each), 64 at n = 64,
//   and at n = 32 the tile is 32 wide in float32 (a 64-row wgmma, see
//   below) and 64 wide in bf16 (TMA fills the columns past n with zeros).
// - Loads in flight while the tensor cores work: a ring of kStages stages
//   of BK rows in dynamic shared memory, each filled by TMA
//   (cp.async.bulk.tensor on a tensor map over J, in 128-byte swizzled
//   boxes, and over y) and signalled by one mbarrier per stage. Thread 0
//   refills the stage of step s - 1 as soon as every thread is past it, so
//   kStages - 1 stages are in flight while one is consumed. TMA fills rows
//   past m with zeros: no masked tail. The wgmmas of step s run while the
//   block waits for and prepares stage s + 1.
// - bf16: the staged tile goes to wgmma (m64nTNk16) as it arrives, both
//   operands MN-major with the transpose bits set. Products of bf16 values
//   are exact in float32.
// - float32 (3xTF32): each element is split into big = tf32(x) (rounded
//   to nearest, ties away, as cvt.rna) and small = tf32(x - big) (x - big
//   is exact); small.big + big.small + big.big, small products first, go
//   into one float32 accumulator (m64nTNk8). Only small.small (about
//   2^-21 relative) is dropped, so the result keeps float32 accuracy; a
//   single TF32 product does not. wgmma reads tf32 only K-major from
//   shared memory and J'J needs both operands MN-major, so one pass per
//   stage writes B's split K-major (Splitter). Off the diagonal A comes
//   from registers, read from the staged tile; on a diagonal tile A is B,
//   and B'S = (S'B)' saves a product: D = (2 S)'B + B'B, G = (D + D') / 2,
//   and at n = 32 the 64-row A stacks big over 2 small, so one wgmma does
//   both.
// - Accumulator precision: wgmma's accumulator drifts over a long sum (in
//   float32 from 2.4e-5 to 2.2e-4 of the Cauchy-Schwarz scale over the
//   row chunks of thousands of rows of chip_smoke.py phase 6, against 1e-5
//   allowed, with one accumulator for a whole row chunk). So each stage
//   starts a fresh accumulator
//   (scale-d = 0) and adds it into a float32 register sum.
// - J'y stays exact float32: diagonal-tile blocks sum it with fmaf from the
//   staged tile, never through TF32.
// - Each block writes its tile and the tile's mirror into its chunk's slice
//   of a float32 scratch (chunks, n, n) (a diagonal tile writes its upper
//   half and mirrors it), and its part of a (chunks, n) scratch for J'y; the
//   caller sums over the chunk axis. No atomics: the result is the same
//   from run to run, and G equals G' bit for bit.
//
// The tensor map is encoded on the host with cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPoint, so the library needs no -lcuda. The
// input is float32 or bfloat16; accumulation is float32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// Rows per stage (BK), stages in the ring and blocks per SM (what fits in
// shared memory), by input type and tile width. ops/gram.py reads them
// through lso_gram_config: its row chunks are whole stages, and it sizes
// the grid for one wave of kBlocks blocks per SM.
template <typename T, int TN> struct Cfg;
template <> struct Cfg<float, 32> { static constexpr int kBK = 64, kStages = 6, kBlocks = 2; };
template <> struct Cfg<float, 64> { static constexpr int kBK = 32, kStages = 6, kBlocks = 2; };
template <> struct Cfg<float, 128> { static constexpr int kBK = 32, kStages = 4, kBlocks = 1; };
template <> struct Cfg<bf16, 64> { static constexpr int kBK = 128, kStages = 4, kBlocks = 3; };
template <> struct Cfg<bf16, 128> { static constexpr int kBK = 64, kStages = 6, kBlocks = 1; };

// Shared-memory layout, in bytes from a 1024-byte aligned base: the ring of
// staged tiles, two buffers of the float32 split of B (Splitter), y's
// stages, the J'y partials and the stage barriers.
template <typename T, int TN>
struct Layout {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr int kBK = Cfg<T, TN>::kBK;
  static constexpr int kStages = Cfg<T, TN>::kStages;
  static constexpr int kBlocks = Cfg<T, TN>::kBlocks;
  static constexpr int kWG = TN == 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kPanels = TN == 128 ? 2 : 1;  // n <= 64: one tile
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(T));
  static constexpr int kBoxBytes = kBK * 128;
  static constexpr int kBoxes = (TN + kBoxCols - 1) / kBoxCols;
  static constexpr int kPanelBytes = kBoxes * kBoxBytes;
  static constexpr int kStageBytes = kPanels * kPanelBytes;
  static constexpr int kDiagRows = TN == 32 ? 64 : TN;  // rows of the product
  static constexpr int kSplitBytes = kSplit ? TN * kBK * 4 : 0;  // big or small
  static constexpr int kSplitBufBytes = 2 * kSplitBytes;  // B's split
  static constexpr int kYBytes = ((kBK * static_cast<int>(sizeof(T)) + 127) / 128) * 128;
  static constexpr int kRaw = 0;
  static constexpr int kSplitOff = kRaw + kStages * kStageBytes;
  static constexpr int kYOff = kSplitOff + 2 * kSplitBufBytes;
  static constexpr int kJyOff = kYOff + kStages * kYBytes;
  static constexpr int kBarOff = kJyOff + kThreads * 4;
  static constexpr int kBytes = kBarOff + kStages * 8;
  static constexpr int kSmemBytes = kBytes + 1024;  // room to align the base
  static_assert(kSmemBytes <= 232448, "shared memory per block");
  static_assert(kBlocks * (kSmemBytes + 1024) <= 233472, "shared memory per SM");
  static_assert(kBK % 16 == 0, "stage rows");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, int c0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and layout (0: no swizzle, 1: 128-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// float32 -> tf32 bits (low 13 bits zero), rounded to nearest with ties
// away from zero as cvt.rna.tf32.f32 rounds, in integer operations (the
// conversion instruction issues at a quarter of their rate). A NaN becomes
// the canonical NaN, whose top mantissa bits survive the tf32 read; the
// addition would carry it into the sign or round it to inf.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  const uint32_t r = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  return x != x ? 0x7FFFFFFFu : r;
}

// The same for the small half x - big, without the NaN case: where it is
// NaN, x was NaN or infinite, big is NaN or infinite, and the products with
// big carry that into the sum.
__device__ __forceinline__ uint32_t tf32_small_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Byte offset of element (k, c) of a staged panel: boxes of 128-byte rows
// (kBoxCols columns) one after another, each swizzled by TMA's 128-byte
// pattern (16-byte chunk index XOR row % 8).
template <typename T, int BK>
__device__ __forceinline__ uint32_t raw_off(int k, int c) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int BC = 8 * E;
  return (c / BC) * (BK * 128) + k * 128 + ((((c % BC) / E) ^ (k % 8)) * 16) +
         (c % E) * static_cast<int>(sizeof(T));
}

// Upper-triangle tile t (row-major over ti <= tj) of an nt x nt tile grid.
__device__ __forceinline__ void tile_of(int t, int nt, int* ti, int* tj) {
  int i = 0;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  *ti = i;
  *tj = i + t;
}

// D (64 x 32) (+)= A (64 x 8) * B (8 x 32) in tf32, both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// D (64 x 64) (+)= A (64 x 8) * B (8 x 64) in tf32, both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// D (64 x 128) (+)= A (64 x 8) * B (8 x 128) in tf32, both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// D (64 x 128) (+)= A (64 x 8) * B (8 x 128) in tf32: A from registers, B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// D (64 x 64) (+)= A (64 x 16) * B (16 x 64) in bf16, both MN-major in
// shared memory (transposed).
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// D (64 x 128) (+)= A (64 x 16) * B (16 x 128) in bf16, both MN-major in
// shared memory (transposed).
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  if constexpr (N == 32) wgmma_tf32_n32(d, desc_a, desc_b, scale_d);
  else if constexpr (N == 64) wgmma_tf32_n64(d, desc_a, desc_b, scale_d);
  else wgmma_tf32_n128(d, desc_a, desc_b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) wgmma_bf16_n64(d, desc_a, desc_b, scale_d);
  else wgmma_bf16_n128(d, desc_a, desc_b, scale_d);
}

// The float32 split of one staged panel (BK rows x TN columns, swizzled
// boxes) into big and f * small halves, K-major for wgmma without swizzle.
// k-slice ks takes 2 TN x 32 bytes: its big half, then its small half, each
// TN x 32 bytes in 8-column groups of 256 bytes, each group two 128-byte
// core matrices (K halves h = 0, 1) of 8 rows x 16 bytes. (At TN = 32 a
// 64-row A read from a slice's big half thus stacks big over f * small.)
// Within slice ks, K position 4 h + q holds staged row 8 ks + 2 q + h (the
// same permutation for both operands, so the sum is unchanged), so that a
// warp reads whole 128-byte rows of the staged tile and writes whole core
// matrices, without bank conflicts. Each thread keeps one column j and one
// half h and walks the slices; its offsets are computed once per block.
template <int BK, int TN, int NT>
struct Splitter {
  static constexpr int kSlicesPerPass = NT / TN / 2;
  static constexpr int kPasses = (BK / 8) / kSlicesPerPass;
  static_assert(NT % (2 * TN) == 0 && (BK / 8) % kSlicesPerPass == 0, "split units");
  int src[4];  // staged byte offsets of rows 2 q + h of the thread's first slice
  int dst;     // split byte offset of the thread's 16 bytes in that slice

  __device__ __forceinline__ explicit Splitter(int tid) {
    const int j = tid % TN;
    const int h = (tid / TN) % 2;
    const int ks = tid / TN / 2;
#pragma unroll
    for (int q = 0; q < 4; ++q) src[q] = raw_off<float, BK>(8 * ks + 2 * q + h, j);
    dst = ks * TN * 64 + (j / 8) * 256 + h * 128 + (j % 8) * 16;
  }

  // f is 2 on a diagonal tile (see gram_kernel), else 1; doubling a tf32
  // value is exact.
  __device__ __forceinline__ void operator()(const uint8_t* raw, uint8_t* big,
                                             float f) const {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      uint32_t vb[4], vs[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = *reinterpret_cast<const float*>(raw + src[q] + p * kSlicesPerPass * 1024);
        vb[q] = tf32_bits(x);
        vs[q] = __float_as_uint(f * __uint_as_float(tf32_small_bits(x - __uint_as_float(vb[q]))));
      }
      uint8_t* d = big + dst + p * kSlicesPerPass * TN * 64;
      *reinterpret_cast<uint4*>(d) = make_uint4(vb[0], vb[1], vb[2], vb[3]);
      *reinterpret_cast<uint4*>(d + TN * 32) = make_uint4(vs[0], vs[1], vs[2], vs[3]);
    }
  }
};

template <typename T, int TN>
__global__ void __launch_bounds__(Layout<T, TN>::kThreads, Layout<T, TN>::kBlocks)
    gram_kernel(const __grid_constant__ CUtensorMap jmap,
                const __grid_constant__ CUtensorMap ymap, int64_t m, int n,
                int64_t rows_per_chunk, float* __restrict__ gp,
                float* __restrict__ bp) {
  using L = Layout<T, TN>;
  constexpr int BK = L::kBK;
  constexpr int S = L::kStages;
  constexpr int NT = L::kThreads;
  constexpr int RG = NT / TN;  // row groups of the J'y sum
  constexpr int KR = BK / RG;  // rows of a stage in each group
  static_assert(KR % 8 == 0, "J'y row groups");
  extern __shared__ __align__(1024) uint8_t smem_dyn[];
  const uint32_t dyn = smem_u32(smem_dyn);
  const uint32_t pad = ((dyn + 1023) & ~1023u) - dyn;
  uint8_t* sm = smem_dyn + pad;  // 1024-byte aligned base (generic pointer)
  const uint32_t sa = dyn + pad;  // the same base as a shared-window address

  const int nt = (n + TN - 1) / TN;
  int ti, tj;
  tile_of(blockIdx.x, nt, &ti, &tj);
  const bool diag = ti == tj;
  const int col_a = ti * TN;
  const int col_b = tj * TN;
  const int nvalid = n < TN ? n : TN;
  const int64_t chunk = blockIdx.y;
  const int64_t row0 = chunk * rows_per_chunk;
  const int64_t row1 = row0 + rows_per_chunk < m ? row0 + rows_per_chunk : m;
  const int nsteps = static_cast<int>((row1 - row0 + BK - 1) / BK);

  const int tid = threadIdx.x;
  const int wg = tid / 128;

  auto bar = [&](int s) { return sa + L::kBarOff + 8 * s; };
  auto raw = [&](int s, int p) {
    return static_cast<uint32_t>(L::kRaw + s * L::kStageBytes + p * L::kPanelBytes);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t stage_tx =
      diag ? L::kPanelBytes + BK * static_cast<uint32_t>(sizeof(T)) : 2 * L::kPanelBytes;
  const CUtensorMap* jm = &jmap;  // kernel parameters, read by TMA in place
  const CUtensorMap* ym = &ymap;
  auto issue = [&](int step) {
    const int s = step % S;
    const int r = static_cast<int>(row0) + step * BK;
    mbar_expect_tx(bar(s), stage_tx);
    for (int b = 0; b < L::kBoxes; ++b)
      tma_load_2d(sa + raw(s, 0) + b * L::kBoxBytes, jm, col_a + b * L::kBoxCols, r, bar(s));
    if (diag) {
      tma_load_1d(sa + L::kYOff + s * L::kYBytes, ym, r, bar(s));
    } else {
      for (int b = 0; b < L::kBoxes; ++b)
        tma_load_2d(sa + raw(s, 1) + b * L::kBoxBytes, jm, col_b + b * L::kBoxCols, r,
                    bar(s));
    }
  };
  if (tid == 0)
    for (int s = 0; s < S && s < nsteps; ++s) issue(s);

  float sum[TN / 2], acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) sum[i] = acc[i] = 0.0f;

  // J'y: thread (jr, jc) sums column jc over rows jr KR .. jr KR + KR - 1 of
  // each stage; row i of its block has swizzle phase i % 8.
  float jy = 0.0f;
  const int jc = tid % TN;
  const int jr = tid / TN;
  int yoff[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) yoff[r] = raw_off<T, BK>(jr * KR + r, jc);
  const Splitter<BK, TN, NT> split_of(tid);
  // Off the diagonal (TN = 128 only) A comes from registers, read from the
  // staged panel: a[0..3] are A rows i0, i0 + 8 at K positions t and t + 4,
  // which hold staged rows 2 t and 2 t + 1 of each slice (the split's
  // permutation). These reads are free of bank conflicts in the swizzled
  // tile. aoff holds their offsets in the first slice.
  int aoff[4];
  {
    const int i0 = 64 * wg + 16 * ((tid % 128) / 32) + (tid % 32) / 4;
    const int k0 = 2 * (tid % 4);
#pragma unroll
    for (int r = 0; r < 4; ++r) aoff[r] = raw_off<float, BK>(k0 + r / 2, i0 + 8 * (r % 2));
  }

  // Step s: wait for stage s, sum J'y and (float32) split it, while the
  // tensor cores run step s - 1's wgmmas; then wait for those, add their
  // accumulator into the register sum, and start step s's wgmmas with a
  // fresh accumulator.
  for (int step = 0; step < nsteps; ++step) {
    const int s = step % S;
    mbar_wait(bar(s), (step / S) & 1);
    const uint8_t* pa = sm + raw(s, 0);
    if (diag) {
      const T* ys = reinterpret_cast<const T*>(sm + L::kYOff + s * L::kYBytes) + jr * KR;
#pragma unroll
      for (int i = 0; i < KR; ++i)
        jy = fmaf(to_f32(*reinterpret_cast<const T*>(pa + yoff[i % 8] + (i / 8) * 1024)),
                  to_f32(ys[i]), jy);
    }
    const uint32_t split = L::kSplitOff + (step & 1) * L::kSplitBufBytes;
    if constexpr (L::kSplit) {
      // B's split (panel a on the diagonal, where it is also A, else panel
      // b). The buffer written here was last read by step s - 2's wgmmas,
      // which every warpgroup finished before step s - 1's barrier.
      split_of(diag ? pa : sm + raw(s, 1), sm + split, diag ? 2.0f : 1.0f);
    }
    wgmma_wait_all();
    if (step > 0) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) sum[i] += acc[i];
    }
    // Off the diagonal: A's fragments, now that step s - 1's wgmmas, which
    // read the previous ones, are done.
    uint32_t fb[BK / 8][4], fs[BK / 8][4];
    if constexpr (L::kSplit && TN == 128) {
      if (!diag) {
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x = *reinterpret_cast<const float*>(pa + aoff[r] + ks * 1024);
            fb[ks][r] = tf32_bits(x);
            fs[ks][r] = tf32_small_bits(x - __uint_as_float(fb[ks][r]));
          }
        }
      }
    }
    // The split was written by threads and is read by wgmma through the
    // async proxy. (Placed here, after the accumulator sum: right after the
    // split stores it crashes ptxas of CUDA 12.8.)
    if constexpr (L::kSplit) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // Every warpgroup is done with step s - 1 (its reads and its wgmmas):
    // refill that stage.
    if (tid == 0 && step >= 1 && step - 1 + S < nsteps) issue(step - 1 + S);

    wgmma_fence();
    if constexpr (L::kSplit) {
      // Off the diagonal G takes small'big + big'small + big'big, small
      // products first, A from registers. On a diagonal tile B'S = (S'B)',
      // so D = (2 S)'B + B'B, with this warpgroup's 64 rows of A read from
      // the split too, and the epilogue takes G = (D + D') / 2: two
      // products, and at TN = 32 one, whose 64 rows of A stack big over
      // 2 small (P = B'B above 2 S'B).
      const uint32_t a_big = sa + split + wg * 2048;
      const uint32_t b_big = sa + split;
      if (diag) {
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
          const uint32_t off = ks * TN * 64;
          const uint64_t db_big = make_desc(b_big + off, 128, 256, 0);
          if constexpr (TN == 32) {
            wgmma_tf32<TN>(acc, make_desc(a_big + off, 128, 256, 0), db_big, ks > 0);
          } else {
            wgmma_tf32<TN>(acc, make_desc(a_big + TN * 32 + off, 128, 256, 0), db_big,
                           ks > 0);
            wgmma_tf32<TN>(acc, make_desc(a_big + off, 128, 256, 0), db_big, 1);
          }
        }
      } else if constexpr (TN == 128) {
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
          const uint32_t off = ks * TN * 64;
          const uint64_t db_big = make_desc(b_big + off, 128, 256, 0);
          const uint64_t db_small = make_desc(b_big + TN * 32 + off, 128, 256, 0);
          wgmma_tf32_rs_n128(acc, fs[ks], db_big, ks > 0);
          wgmma_tf32_rs_n128(acc, fb[ks], db_small, 1);
          wgmma_tf32_rs_n128(acc, fb[ks], db_big, 1);
        }
      }
    } else {
      const uint32_t a0 = sa + raw(s, 0) + wg * L::kBoxBytes;
      const uint32_t b0 = sa + (diag ? raw(s, 0) : raw(s, 1));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_bf16<TN>(acc, make_desc(a0 + kk * 2048, L::kBoxBytes, 1024, 1),
                       make_desc(b0 + kk * 2048, L::kBoxBytes, 1024, 1), kk > 0);
      }
    }
    wgmma_commit();
  }
  wgmma_wait_all();
  if (nsteps > 0) {
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) sum[i] += acc[i];
  }

  // Accumulator fragment: d[4 c + r] is row g + 8 (r / 2), column
  // 8 c + 2 t + r % 2 of the warp's 16 rows (g = lane / 4, t = lane % 4).
  float* out = gp + chunk * static_cast<int64_t>(n) * n;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  if (diag) {
    // G = (D + D') / 2 through a padded (kRows, TN + 1) tile over the
    // staged ring, which every warpgroup is done with after the barrier. At
    // TN = 32, D is rows 0-31 plus rows 32-63 of the 64-row product.
    constexpr int LD = TN + 1;
    float* tile = reinterpret_cast<float*>(sm);
    static_assert(L::kDiagRows * LD * 4 <= L::kSplitOff, "epilogue tile");
    __syncthreads();
#pragma unroll
    for (int c = 0; c < TN / 8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        tile[(64 * wg + 16 * warp + g + 8 * (r / 2)) * LD + 8 * c + 2 * t + r % 2] =
            sum[4 * c + r];
    __syncthreads();
    auto d = [&](int i, int j) {
      float v = tile[i * LD + j];
      if constexpr (TN == 32) v += tile[(i + 32) * LD + j];
      return v;
    };
#pragma unroll
    for (int c = 0; c < TN / 8; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 64 * wg + 16 * warp + g + 8 * (r / 2);
        const int j = 8 * c + 2 * t + r % 2;
        if (i >= nvalid || j >= nvalid || i > j) continue;
        const float v = 0.5f * (d(i, j) + d(j, i));
        out[static_cast<int64_t>(col_a + i) * n + col_a + j] = v;
        out[static_cast<int64_t>(col_a + j) * n + col_a + i] = v;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < TN / 8; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 64 * wg + 16 * warp + g + 8 * (r / 2);
        const int j = 8 * c + 2 * t + r % 2;
        const float v = sum[4 * c + r];
        out[static_cast<int64_t>(col_a + i) * n + col_b + j] = v;
        out[static_cast<int64_t>(col_b + j) * n + col_a + i] = v;
      }
    }
  }
  if (diag) {
    float* part = reinterpret_cast<float*>(sm + L::kJyOff);
    part[tid] = jy;
    __syncthreads();
    if (tid < nvalid) {
      float b = part[tid];
      for (int r = 1; r < RG; ++r) b += part[r * TN + tid];
      bp[chunk * n + col_a + tid] = b;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Error codes beyond cudaError_t's range.
constexpr int kNoEncoder = 9000;       // libcuda has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 10000;   // plus the CUresult of the encoding

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                           12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T, int TN>
int launch_tile(const void* J, const void* y, int64_t m, int n, int64_t rows_per_chunk,
                int chunks, void* gp, void* bp, void* stream) {
  using L = Layout<T, TN>;
  // A chunk of whole stages: no TMA box crosses into the next chunk.
  if (rows_per_chunk <= 0 || rows_per_chunk % L::kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t ones[2] = {1, 1};
  CUtensorMap jmap, ymap;
  const cuuint64_t jdim[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(m)};
  const cuuint64_t jstride[1] = {static_cast<cuuint64_t>(n) * sizeof(T)};
  const cuuint32_t jbox[2] = {static_cast<cuuint32_t>(L::kBoxCols),
                              static_cast<cuuint32_t>(L::kBK)};
  CUresult r = encode(&jmap, type, 2, const_cast<void*>(J), jdim, jstride, jbox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  const cuuint64_t ydim[1] = {static_cast<cuuint64_t>(m)};
  const cuuint32_t ybox[1] = {static_cast<cuuint32_t>(L::kBK)};
  r = encode(&ymap, type, 1, const_cast<void*>(y), ydim, jstride, ybox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);

  auto kernel = gram_kernel<T, TN>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (n + TN - 1) / TN;
  dim3 grid(nt * (nt + 1) / 2, chunks);
  kernel<<<grid, L::kThreads, L::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      jmap, ymap, m, n, rows_per_chunk, static_cast<float*>(gp), static_cast<float*>(bp));
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, TN>) for the tile width of J (m, n) in T:
// 128 for n a multiple of 128, else n in float32 and 64 in bf16.
template <typename T, typename F>
int with_tile(int n, F&& f) {
  if (n > 0 && n % 128 == 0) return f(std::integral_constant<int, 128>{});
  if constexpr (std::is_same<T, float>::value) {
    if (n == 64) return f(std::integral_constant<int, 64>{});
    if (n == 32) return f(std::integral_constant<int, 32>{});
  } else {
    if (n == 32 || n == 64) return f(std::integral_constant<int, 64>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* J, const void* y, int64_t m, int n, int64_t rows_per_chunk,
           int chunks, void* gp, void* bp, void* stream) {
  return with_tile<T>(n, [&](auto tn) {
    return launch_tile<T, decltype(tn)::value>(J, y, m, n, rows_per_chunk, chunks, gp, bp,
                                               stream);
  });
}

template <typename T>
int config(int n, int* out) {
  return with_tile<T>(n, [&](auto tn) {
    using L = Layout<T, decltype(tn)::value>;
    out[0] = decltype(tn)::value;
    out[1] = L::kBK;
    out[2] = L::kBlocks;
    return 0;
  });
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// lso_gram_config: the kernel's settings for J (m, n) in float32
// (bf16_input = 0) or bfloat16 (bf16_input = 1): out[0] the tile width, out[1] the rows per stage,
// out[2] the blocks that fit on one SM. Returns 0, or cudaErrorInvalidValue
// for a width the kernel does not take.
//
// lso_gram_f32 and lso_gram_bf16: J (m, n) and y (m,) are contiguous and
// 16-byte aligned, m < 2^31; gp is a float32 (chunks, n, n) scratch and bp
// a float32 (chunks, n) scratch; chunk c covers rows
// [c * rows_per_chunk, (c + 1) * rows_per_chunk) of J, and rows_per_chunk
// is a multiple of the rows per stage. Each returns 0 when the launch was
// enqueued, a cudaError_t, or 9000 (no tensor-map encoder in libcuda) or
// 10000 plus a CUresult (the tensor map was refused).
extern "C" int lso_gram_config(int bf16_input, int n, int* out) {
  return bf16_input ? config<bf16>(n, out) : config<float>(n, out);
}

extern "C" int lso_gram_f32(const void* J, const void* y, int64_t m, int n,
                            int64_t rows_per_chunk, int chunks, void* gp,
                            void* bp, void* stream) {
  return launch<float>(J, y, m, n, rows_per_chunk, chunks, gp, bp, stream);
}

extern "C" int lso_gram_bf16(const void* J, const void* y, int64_t m, int n,
                             int64_t rows_per_chunk, int chunks, void* gp,
                             void* bp, void* stream) {
  return launch<bf16>(J, y, m, n, rows_per_chunk, chunks, gp, bp, stream);
}
