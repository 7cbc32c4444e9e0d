// Hopper (sm_90a) building blocks as inline PTX: mbarriers, named barriers,
// programmatic dependent launch, TMA loads, the async-proxy fence, the wgmma
// shared-memory descriptors, the bf16 m64nNk16 wgmma products (N = 56, 64, 96,
// 128; both operands in shared memory, K-major or MN-major, or A from registers),
// the tf32 m64n64k8 ones (A from shared memory or registers) and m64n128k8
// one (A from registers), the f32 -> tf32 rounding and 3xTF32's splits, and
// host helpers that
// encode TMA descriptors through the driver entry point (so nothing links
// against libcuda).
//
// Tiles are [64 rows][64 bf16] (or 32 f32) = 128-byte rows, written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B at a 1024-byte aligned address: 8-row atoms of
// 1024 bytes whose 16-byte chunks are XOR-swizzled by the row. One descriptor
// describes such a tile both as a K-major operand (the reduction runs along the
// row: a k-step of 16 advances the start by 32 bytes) and as an MN-major one
// (the reduction runs down the rows, transposed by the instruction's tnsp bit:
// a k-step of 16 advances the start by 16 rows, 2048 bytes); the 8-row atoms
// are 1024 bytes apart (stride byte offset), and a 64-wide operand is one atom
// wide, so the leading byte offset is not read.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers --------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and expect `bytes` of asynchronous copies on this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// expect `bytes` more of asynchronous copies on this phase, without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the phase of parity `parity` has completed (the loop inside the asm: no divergence for the compiler to
// reconverge before a warpgroup-wide wgmma)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n@done bra DONE;\n"
      "bra WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// named barrier `id` (1-15; 0 is __syncthreads') over `count` threads, a multiple of 32
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// programmatic dependent launch: wait until the grid this one depends on has completed and its writes are
// visible (a no-op when launched without the attribute); let the grid that depends on this one start launching
// once every block of this one has said so
__device__ __forceinline__ void grid_dependency_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// -- TMA --------------------------------------------------------------------------

// the box of `map` at coordinates (c0, c1, c2), innermost first, into dst; completes on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// `bytes` (a multiple of 16) from src into dst, both 16-byte aligned; completes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later async-proxy reads of it (wgmma, TMA
// stores); the readers still wait at a barrier behind every writer's fence.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// -- wgmma --------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at p (see the note at the top); add 2 per 32 bytes of start offset
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}
// The same for an MN-major operand wider than one 64-value atom: the atoms (tiles of 64 rows x 128 bytes) lie
// `atom_bytes` apart, the leading byte offset of an MN-major swizzled layout (a width of 96 reads the first half of
// the second atom)
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p, uint32_t atom_bytes) {
  return (desc_sw128(p) & ~(uint64_t(0x3FFF) << 16)) | (static_cast<uint64_t>(atom_bytes >> 4) << 16);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x rounded to tf32 (10 stored mantissa bits; to nearest, ties away from zero), as f32 bits whose low 13 are 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// 3xTF32's halves of four values: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ float4 tf32_hi(float4 x) {
  return make_float4(__uint_as_float(tf32_rna(x.x)), __uint_as_float(tf32_rna(x.y)), __uint_as_float(tf32_rna(x.z)),
                     __uint_as_float(tf32_rna(x.w)));
}
__device__ __forceinline__ float4 tf32_lo(float4 x, float4 hi) {
  return tf32_hi(make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w));
}

// A 64 x 64 f32 accumulator (the layout of wgmma_tf32_ss's d) as the A operand of eight tf32 k-steps, split into
// TF32 halves: k-step j's a[r] is column 8 j + 2 t + (r >> 1) of row g + 8 (r & 1), so the B operand's k-step j
// must hold those columns at positions t + 4 (r >> 1) of its group of 8 (columns permuted 0, 2, 4, 6, 1, 3, 5, 7)
__device__ __forceinline__ void split_fragments(const float (&d)[32], uint32_t (&hi)[8][4], uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = d[4 * j + 2 * (r & 1) + (r >> 1)];
      hi[j][r] = tf32_rna(x);
      lo[j][r] = tf32_rna(x - __uint_as_float(hi[j][r]));
    }
}

// descriptor offset of tf32 k-step kk (8 values) of a 64-wide reduction held as two 128-byte-wide boxes of 64 rows
// (8 KB each, the second right after the first): box kk >> 2 (512 in 16-byte units), 32 bytes (2) a step inside it
__device__ __forceinline__ uint64_t kstep(int kk) { return static_cast<uint64_t>(512 * (kk >> 2) + 2 * (kk & 3)); }

#define MER_WGMMA_D32                                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MER_WGMMA_D32_OPERANDS(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),  \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),   \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory; accumulate = 0 overwrites d.
// d[4 j + 2 h + c] of thread (warp w, lane 4 g + t) is row 16 w + g + 8 h, column 8 j + 2 t + c.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MER_WGMMA_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MER_WGMMA_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The m64n128k16 form of wgmma_ss (d[64]): the same operands and fragment layout, the column groups j running
// to 15.
#define MER_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MER_F16(d, i) MER_F4(d, i), MER_F4(d, i + 4), MER_F4(d, i + 8), MER_F4(d, i + 12)
#define MER_F64(d, i) MER_F16(d, i), MER_F16(d, i + 16), MER_F16(d, i + 32), MER_F16(d, i + 48)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MER_F64(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// d[64 x 128] += A[64 x 8] B[128 x 8]^T in tf32 (f32 accumulation), A from registers as tf32 bits (a[0..3]: rows
// g, g + 8 at column t, then at column t + 4, for warp w's rows 16 w ..; the layout of mma.m16n8k8's tf32 A), B
// K-major in shared memory (tf32 takes no transpose); d's layout as wgmma_ss's; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : MER_F64(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
#undef MER_F4
#undef MER_F16
#undef MER_F64

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (a[0..3]: rows g, g + 8 at columns 2t, 2t + 1, then at
// 2t + 8, 2t + 9, as bf16 pairs: the layout of d's columns 16 k .. 16 k + 15), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MER_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MER_WGMMA_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T in tf32 (f32 accumulation), A and B K-major in shared memory as tf32
// values (f32 patterns whose low 13 bits are 0; tf32 takes no transpose), d's layout as wgmma_ss's; accumulate =
// 0 overwrites d. A k-step of 8 advances a descriptor by 32 bytes (2), as a k-step of 16 in bf16.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MER_WGMMA_D32 ", %32, %33, p, 1, 1;\n}\n"
      : MER_WGMMA_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// The same with A from registers as tf32 bits in the layout of the m64n128k8 form's a[0..3].
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MER_WGMMA_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : MER_WGMMA_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d[64 x N] (+)= A[64 x 16] B[16 x N] in bf16 with both operands in shared memory, each K-major (0) or MN-major
// (1, the instruction's transpose bits kTransA, kTransB); N = 64 (d[32]) or 96 (d[48]), d's layout as wgmma_ss's
// with the column groups j running to N / 8 - 1; accumulate = 0 overwrites d. An MN-major B of N = 96 takes its
// descriptor from desc_sw128_mn.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MER_WGMMA_D32 ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : MER_WGMMA_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}
#define MER_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MER_F16(d, i) MER_F4(d, i), MER_F4(d, i + 4), MER_F4(d, i + 8), MER_F4(d, i + 12)
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : MER_F16(d, 0), MER_F16(d, 16), MER_F16(d, 32)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}
// The m64n56k16 form (d[28]: column groups j to 6), for a head dim of 50 held in a zero-filled 64-column tile
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[28], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
      "}, %28, %29, p, 1, 1, %31, %32;\n}\n"
      : MER_F16(d, 0), MER_F4(d, 16), MER_F4(d, 20), MER_F4(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], A from registers (the layout of wgmma_rs_mn's a), B MN-major in shared memory
// (an N = 96 B takes its descriptor from desc_sw128_mn); N = 96 (d[48]) or 56 (d[28]); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : MER_F16(d, 0), MER_F16(d, 16), MER_F16(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[28], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, 1;\n}\n"
      : MER_F16(d, 0), MER_F4(d, 16), MER_F4(d, 20), MER_F4(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
#undef MER_F4
#undef MER_F16

#undef MER_WGMMA_D32
#undef MER_WGMMA_D32_OPERANDS

// -- host: TMA descriptors ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, or null
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 3-D tensor of `type` (dims innermost first; strides in bytes of dims 1 and 2, multiples of 16) as boxes of
// `box` values, 128-byte swizzled (box[0] values make one 128-byte row: 64 bf16 or 32 f32); a box's elements
// outside the dims read as zeros, and nothing outside them is read. false if the driver refuses it.
inline bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base, const cuuint64_t (&dims)[3],
                      const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor [n_slices][rows][64] as 64 x 64 boxes; rows past `rows` of a slice read as zeros.
inline bool encode_rows64(CUtensorMap* map, const void* base, int rows, int n_slices) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
                   {64, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(n_slices)},
                   {64 * 2, static_cast<cuuint64_t>(rows) * 64 * 2}, {64, 64, 1});
}

// An f32 tensor [n_slices][rows][cols] (cols a multiple of 4) as boxes of 64 rows x 32 values (one 128-byte row
// each); rows past `rows` of a slice and columns past `cols` read as zeros.
inline bool encode_f32_rows(CUtensorMap* map, const void* base, int cols, int rows, int n_slices) {
  const cuuint64_t c = static_cast<cuuint64_t>(cols), r = static_cast<cuuint64_t>(rows);
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, {c, r, static_cast<cuuint64_t>(n_slices)},
                   {c * 4, r * c * 4}, {32, 64, 1});
}

}  // namespace sm90
}  // namespace
