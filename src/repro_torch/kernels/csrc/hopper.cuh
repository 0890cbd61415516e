// Hopper (sm_90a) building blocks shared by the hand-written kernels of this
// directory: mbarriers, TMA tile loads, bulk and cp.async copies that
// complete on an mbarrier, wgmma shared-memory descriptors and the wgmma
// instructions themselves, as inline PTX (no CUTLASS); and, on the host, the
// encoding of TMA tensor maps without linking the driver library.
//
// Shared-memory tiles of the flash kernel are the ones TMA writes under
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 64 bf16 (128 bytes), the 16-byte chunks
// of row r XOR-ed with r % 8, in 1024-byte atoms of 8 rows, each tile
// 1024-byte aligned. In general a swizzle of 16 * 2^B bytes XORs the 16-byte
// chunk index of a row with address bits [7, 7 + B) (``swizzle_chunk``).
#pragma once

#include <cuda.h>   // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also tells the barrier to expect ``bytes`` from TMA
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity ``parity`` has completed. A wait
// that never ends is a fault of the kernel, not of the data: after 2^26 failed
// tries (far beyond any load) it traps, so a bug becomes a launch error and
// not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// -- TMA -------------------------------------------------------------------------
// A box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first, into
// shared memory at ``dst``; completion is counted in bytes on ``bar``. Out-of-
// bounds elements arrive as zeros and count all the same.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One contiguous run of ``bytes`` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory; completion counted on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// -- cp.async ------------------------------------------------------------------
// 4-byte global -> shared copy that does not wait for the data; with
// valid = false it writes 0 and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16-byte global -> shared copy (both addresses 16-byte aligned) that does
// not wait for the data and bypasses L1; it reads ``src_bytes`` (0-16) and
// fills the rest of the 16 bytes with zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Close this thread's group of cp.async copies issued so far.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One arrival on ``bar`` once every cp.async this thread issued before has
// landed. The barrier's expected count includes it (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// The physical 16-byte chunk of logical chunk ``chunk`` in row ``row`` of a
// tile whose rows are 16 * 2^b bytes long, written by TMA under the swizzle
// of the same width, the tile 1024-byte aligned (b = 1, 2, 3: 32-, 64-,
// 128-byte swizzle).
__device__ __forceinline__ int swizzle_chunk(int chunk, int row, int b) {
  return chunk ^ ((row >> (3 - b)) & ((1 << b) - 1));
}

// -- warp reduce-scatter -----------------------------------------------------
// One step of a warp's reduce-scatter of p[0 : 2 HALF]: the lanes whose bit
// ``o`` is set keep the upper half, the others the lower, each adding its
// partner's copy of the half it keeps into p[0 : HALF]. The halves are
// picked with bit masks on values in registers: a select of array elements
// becomes a select of addresses, which puts the array in local memory.
// Steps o = 16, 8, 4, 2, 1 on 64 values leave lane l with values 2 l and
// 2 l + 1 summed over the warp, in the same order on every run.
template <int HALF, int N>
__device__ __forceinline__ void halve(float (&p)[N], int lane, int o) {
  const unsigned up = (lane & o) ? ~0u : 0u;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const unsigned lo = __float_as_uint(p[i]);
    const unsigned hi = __float_as_uint(p[i + HALF]);
    const float send = __uint_as_float((lo & up) | (hi & ~up));
    const float keep = __uint_as_float((hi & up) | (lo & ~up));
    p[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// -- ordered sums -----------------------------------------------------------------
// out[e] = (src[e] + src[stride + e] + ... + src[(count - 1) stride + e]) /
// div for e < n, summed from 0 in this order (the same bits on every run),
// by all threads of the block. A thread takes G elements (float4 groups
// where n, stride and both pointers allow) and loads each term of all of
// them before adding, so the block keeps many loads in flight instead of
// one dependent load at a time. Reads bypass L1: the terms were written by
// other blocks of the same launch.
template <int G>
__device__ __forceinline__ void ordered_sum(const float* src, size_t stride,
                                            int count, int n, float* out,
                                            float div) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool vec = n % 4 == 0 && stride % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* o4 = reinterpret_cast<float4*>(out);
    const int n4 = n / 4;
    const size_t st4 = stride / 4;
    for (int e0 = tid; e0 < n4; e0 += nt * G) {
      float4 t[G];
#pragma unroll
      for (int g = 0; g < G; ++g) t[g] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < count; ++i) {
        float4 w[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int e = e0 + g * nt;
          w[g] = e < n4 ? __ldcg(s4 + i * st4 + e)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          t[g].x += w[g].x;
          t[g].y += w[g].y;
          t[g].z += w[g].z;
          t[g].w += w[g].w;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int e = e0 + g * nt;
        if (e < n4)
          o4[e] = make_float4(t[g].x / div, t[g].y / div, t[g].z / div,
                              t[g].w / div);
      }
    }
    return;
  }
  for (int e0 = tid; e0 < n; e0 += nt * G) {
    float t[G];
#pragma unroll
    for (int g = 0; g < G; ++g) t[g] = 0.f;
#pragma unroll 4
    for (int i = 0; i < count; ++i) {
      float w[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int e = e0 + g * nt;
        w[g] = e < n ? __ldcg(src + i * stride + e) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) t[g] += w[g];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int e = e0 + g * nt;
      if (e < n) out[e] = t[g] / div;
    }
  }
}

// The end of a work item of a kernel whose units (a node, a block of rows)
// are split over several blocks: this block has written item ``it``'s
// partial sum (``n`` floats, slot ``items[6 it + 4]``, ``stride`` floats
// apart in ``partial``). Items are (unit, first tile, end tile, tile step,
// slot, group); a unit's items are cut into groups of consecutive slots,
// ``groups[3 g : 3 g + 3]`` = (first slot, slots, slot of the group's sum,
// -1 for a unit's sole group), ``unit_groups[u]`` the unit's first group.
// Each group's last block (a ticket: an atomic counter, never an atomic
// sum) sums the group's partials in slot order, and the unit's last group
// sums the group sums in order, into out[0 : n] / div. The last blocks
// reset their tickets, so the tickets stay zero between launches. The same
// bits on every run. All threads of the block call it; ``flag`` is a
// shared int.
__device__ __forceinline__ void fold_partials(
    const int* items, const int* groups, const int* unit_groups,
    int* tickets, int n_groups, float* partial, size_t stride, int n,
    float* out, float div, int it, int* flag) {
  const int unit = items[6 * it], g = items[6 * it + 5];
  const int* grp = groups + 3 * g;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(tickets + g, 1) == grp[1] - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const bool sole = grp[2] < 0;
  ordered_sum<8>(partial + (size_t)grp[0] * stride, stride, grp[1], n,
                 sole ? out : partial + (size_t)grp[2] * stride,
                 sole ? div : 1.f);
  if (threadIdx.x == 0) tickets[g] = 0;
  if (sole) return;
  __threadfence();
  __syncthreads();
  const int g0 = unit_groups[unit], g1 = unit_groups[unit + 1];
  if (threadIdx.x == 0)
    *flag = atomicAdd(tickets + n_groups + unit, 1) == g1 - g0 - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  ordered_sum<8>(partial + (size_t)groups[3 * g0 + 2] * stride, stride,
                 g1 - g0, n, out, div);
  if (threadIdx.x == 0) tickets[n_groups + unit] = 0;
}

// -- wgmma -----------------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (K-major: unused; MN-major: the stride between
// 64-element blocks along M or N), stride byte offset 1024 (the stride between
// 8-row groups), layout type 1 (128-byte swizzle). ``addr`` may sit 32, 64 or
// 96 bytes into a row: that is how a K-major operand steps through k16 slices.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats rounded to bf16 in one 32-bit register, lo in the low half: the
// element order of a wgmma register A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// D (64 x N, f32) = A (64 x 16) B (16 x N) + (accumulate ? D : 0), A and B
// K-major bf16 in shared memory. Thread t of the warpgroup holds D[4j + 2i + c]
// = D(16 (t / 32) + (t % 32) / 4 + 8 i, 8 j + 2 (t % 4) + c).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

// D (64 x N, f32) += A (64 x 16) B (16 x N): A bf16 in registers (the layout
// of D above, two elements a register), B MN-major (N contiguous) bf16 in
// shared memory, read through wgmma's transpose bit.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<256>(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- host: tensor maps -------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a CUDA driver API call) through the CUDA runtime's
// entry-point lookup, so a library needs no -lcuda and keeps its plain C
// interface.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a row-major (d2, d1, d0) f32 array (d0 innermost, its
// rows 16-byte aligned) with boxes of (box0, box1, 1), zeros out of bounds
// and L2 promotion of 256 bytes. Encoding costs host time on every call of
// a wrapper, so maps are cached by all of their arguments (a map holds
// nothing else: a new tensor at a freed tensor's address and shape gets the
// same, valid, map). Returns false if the driver refuses the map.
inline bool f32_map_3d(CUtensorMap* out, const void* base, uint64_t d0,
                       uint64_t d1, uint64_t d2, uint32_t box0, uint32_t box1,
                       CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* base;
    uint64_t d0, d1, d2;
    uint32_t box0, box1;
    int swizzle;
    CUtensorMap map;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.d0 == d0 && e.d1 == d1 && e.d2 == d2 &&
        e.box0 == box0 && e.box1 == box1 && e.swizzle == (int)swizzle) {
      memcpy(out, &e.map, sizeof(CUtensorMap));
      return true;
    }
  }
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 4, d0 * 4 * d1};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  Entry e{base, d0, d1, d2, box0, box1, (int)swizzle, {}};
  if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = e;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  memcpy(out, &e.map, sizeof(CUtensorMap));
  return true;
}

}  // namespace hopper
