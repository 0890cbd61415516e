// Hopper (sm_90a) ELL sparse gossip round:
//   out[i, :] = diag[i] * z_own[i, :] + sum_l val[i, l] * z_src[idx[i, l], :]
//
// Replaces: repro/kernels/ell_spmm.py  ell_spmm_pallas.
//
// What bounds it on the H100: bytes. Each output element costs 2*(L+1)
// flops against at least (4 own + src bytes) read and 4 written, well below
// one flop per byte. The least time is reading the payload and the gather
// source once and writing the output once; the L-fold re-reads of z_src
// rows (each row is a neighbour of about L other rows) are what the card's
// 50 MB L2 has to absorb.
//
// What the design does about it:
//  * A block owns one row i and a tile of kThreads*VEC columns of K; each
//    thread owns VEC consecutive columns and reads them with 16-byte loads
//    (float4 for an f32 source, 8 bf16 values for a bf16 source), so a warp
//    reads 512 contiguous bytes of each gathered row.
//  * The row's L slot indices and weights are the same for every thread of
//    the block and come through the read-only cache.
//  * Unlike the TPU kernel, the whole payload is not kept resident (at
//    N = 4096 and K = 3920 it is 64 MB, beyond shared memory): rows are
//    gathered from device memory and L2. Rows are launched in index order,
//    so the neighbours of nearby rows in a ring-like overlay stay in L2.
//  * Accumulation is f32; the diagonal term reads z_own in f32. The source
//    type is a template parameter (float or __nv_bfloat16, converted with
//    __bfloat162float). Padded slots self-point with weight 0, so the FMA
//    chain needs no mask.
//  * K not a multiple of VEC, or a misaligned base pointer, takes the
//    VEC = 1 instantiation (scalar loads).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename Src, int VEC>
struct Loader;

template <>
struct Loader<float, 1> {
  __device__ static void load(const float* p, float* out) { out[0] = __ldg(p); }
};

template <>
struct Loader<float, 4> {
  __device__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    out[0] = __bfloat162float(p[0]);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int v = 0; v < 8; ++v) out[v] = __bfloat162float(h[v]);
  }
};

template <typename Src, int VEC>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                const float* __restrict__ diag, const float* __restrict__ z_own,
                const Src* __restrict__ z_src, float* __restrict__ out, int k,
                int ell_width) {
  const int row = blockIdx.y;
  const int k0 = (blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (k0 >= k) return;

  float acc[VEC];
  const float dg = __ldg(diag + row);
  const float* own = z_own + (size_t)row * k + k0;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int v = 0; v < VEC; v += 4) Loader<float, 4>::load(own + v, acc + v);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __ldg(own + v);
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] *= dg;

  const int* ri = idx + (size_t)row * ell_width;
  const float* rv = val + (size_t)row * ell_width;
  for (int l = 0; l < ell_width; ++l) {
    const int src = __ldg(ri + l);
    const float w = __ldg(rv + l);
    float msg[VEC];
    Loader<Src, VEC>::load(z_src + (size_t)src * k + k0, msg);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = fmaf(w, msg[v], acc[v]);
  }

  float* o = out + (size_t)row * k + k0;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int v = 0; v < VEC; v += 4)
      *reinterpret_cast<float4*>(o + v) =
          make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) o[v] = acc[v];
  }
}

template <typename Src, int VEC>
cudaError_t launch(const int* idx, const float* val, const float* diag,
                   const float* z_own, const Src* z_src, float* out, int n,
                   int k, int ell_width, cudaStream_t stream) {
  const int per_block = kThreads * VEC;
  const dim3 grid((k + per_block - 1) / per_block, n);
  ell_spmm_kernel<Src, VEC><<<grid, kThreads, 0, stream>>>(
      idx, val, diag, z_own, z_src, out, k, ell_width);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// idx: (n, ell_width) int32, val: (n, ell_width) f32, diag: (n,) f32,
// z_own: (n, k) f32, z_src: (n_src, k) f32 (src_is_bf16 = 0) or bf16 (= 1),
// out: (n, k) f32. Returns the CUDA error code of the launch (0 on success).
int ell_spmm_launch(const int* idx, const float* val, const float* diag,
                    const float* z_own, const void* z_src, float* out, int n,
                    int k, int ell_width, int src_is_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec_ok = aligned16(z_own) && aligned16(z_src) && aligned16(out);
  cudaError_t err;
  if (src_is_bf16) {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(z_src);
    if (vec_ok && k % 8 == 0)
      err = launch<__nv_bfloat16, 8>(idx, val, diag, z_own, src, out, n, k,
                                     ell_width, stream);
    else
      err = launch<__nv_bfloat16, 1>(idx, val, diag, z_own, src, out, n, k,
                                     ell_width, stream);
  } else {
    const float* src = static_cast<const float*>(z_src);
    if (vec_ok && k % 4 == 0)
      err = launch<float, 4>(idx, val, diag, z_own, src, out, n, k, ell_width,
                             stream);
    else
      err = launch<float, 1>(idx, val, diag, z_own, src, out, n, k, ell_width,
                             stream);
  }
  return (int)err;
}

}  // extern "C"
