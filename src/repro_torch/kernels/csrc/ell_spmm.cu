// Hopper (sm_90a) ELL sparse gossip round:
//   out[i, :] = diag[i] z[i, :] + sum_l val[i, l] q(z[idx[i, l], :])
// q = identity, or round to bf16 and back (a bf16 payload's messages).
//
// Replaces: repro/kernels/ell_spmm.py  ell_spmm_pallas (and its jax.vmap
// over a stacked SparseW, repro/core/bdot.py's batched gossip stages).
//
// What bounds it on the H100: bytes. Each output element costs 2 (L + 1)
// flops against 4 bytes of z read and 4 written, well below one flop per
// byte: the least time reads z (f32) once and writes out once, 128 MB a
// round at N = 4096, K = 3920 (0.038 ms at 3.35 TB/s). A gather of every
// slot from device memory instead moves L + 1 times z through L2 (578 MB a
// round at L = 9), which is what held the one-row-a-block kernel this
// replaces at 0.072 ms.
//
// What the design does about it:
//  * Overlay graphs are local: in watts_strogatz(4096, 6, 0.1) 90% of the
//    real slots point within a few rows of their own row, and the padded
//    slots point at the row itself. A block owns a band of ``band_rows``
//    consecutive rows and a column tile of up to 256 columns, and stages
//    the band's rows of z plus ``halo`` rows on either side (clipped at 0
//    and N - 1) in shared memory once, with the band's slot indices,
//    weights and diagonal: 16-byte cp.async copies, all issued before one
//    wait. A slot whose source lies in the window reads shared memory; any
//    other slot reads device memory (L2). The band and halo are planned once
//    per SparseW from its host indices (ell_spmm.py ``window_plan``): a
//    graph without locality gets no halo, and its window is the band.
//  * A graph whose band's slots do not fit beside the window (a hub with
//    thousands of neighbours: star(4096) has 4095 slots a row) stages the
//    window alone and reads each slot's index and weight from device memory
//    as its row is summed (STAGED = false): the same slot order, so the
//    same bits.
//  * A block takes ~40 KB of shared memory, so several blocks share an SM:
//    while some stage their windows, others sum.
//  * Once the slots land, each slot's index is turned in place into the
//    place of its message: an offset into the window, or -1 - its row of z.
//    Warp w takes rows w, w + 8, ... of the band; lane l owns 8 columns of
//    the tile (two float4 on the 16-byte route), and the warp takes the
//    slots 2 at a time: their loads are issued before their FMAs. The
//    instructions a slot costs beside its loads and FMAs are what the
//    time of a round is made of, so a lane carries as many columns as the
//    registers allow.
//  * Blocks are numbered band-fastest: blocks running side by side work on
//    neighbouring bands of one column tile, so a halo is an L2 hit and the
//    gathers of the rows in flight touch a few tiles' columns of z, which
//    L2 holds. The output is written with streaming stores, so it does not
//    push z out of L2.
//  * The sum is the same FMA chain in slot order for every row, whichever
//    route a slot's message took: out = diag * own, then fma(val, msg, out)
//    slot by slot over the first 32 slots, the bits of the kernel this
//    replaces. A wider row (an Erdos-Renyi graph of 600 neighbours, a hub)
//    sums each further 32 slots from 0 and adds that partial once, so its
//    f32 rounding grows with 32 + L / 32 terms instead of L: a chain of 608
//    read up to 1.76x the 1e-6 limit against a float64 sum on some
//    payloads (tools/ell_error_sweep.py). The own term reads
//    z in f32 (from device memory for a bf16 payload); for a bf16 payload
//    each staged value is rounded once in shared memory with
//    __float2bfloat16_rn and widened back (a message read from device
//    memory is rounded as it is read), the bits of z.to(torch.bfloat16), so
//    the round is one launch (no cast launch). A row's own term in f32
//    reads the window.
//  * K not a multiple of 4, or a base pointer not 16-byte aligned, takes
//    the 4-byte route (W = 1): 4-byte copies and loads, the same layout.
//  * A batch of B matrices (B-DOT's stacked sub-networks, each (n, width)
//    over its own (n, k) payload) is one launch of B times the blocks:
//    block b sums member b / (bands * tiles) with the block numbering of a
//    launch of that member alone, under the one window planned for the
//    whole batch. The window moves only which route a message takes, so
//    each member's bits are those of its own launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 256;   // widest column tile: 32 lanes x 8 columns
constexpr int kSlots = 2;        // messages a warp loads before their FMAs
constexpr int kChunk = 32;       // slots a partial sum takes (a multiple of
                                 // kSlots)
constexpr int kMaxSmem = 200 * 1024;   // dynamic shared memory a block

struct EllArgs {
  const int* idx;                // (n, width)
  const float* val;              // (n, width)
  const float* diag;             // (n,)
  const float* z;                // (n, k)
  float* out;                    // (n, k)
  int n, k, width;
  int band_rows, halo, tile_cols, bands, tiles;
};

template <bool QUANT>
__device__ __forceinline__ float message(float x) {
  if constexpr (QUANT) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void ldg_vec(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = __ldg(p);
  }
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_u32(dst)), "l"(src) : "memory");
}

// One lane's part of a row: NV vectors of W columns at col[j] (ok[j]: in
// the tile), their sums in acc.
template <int W, bool QUANT, int NV>
struct Lane {
  int col[NV];
  bool ok[NV];

  // message at ``off`` (>= 0: the window; else -1 - its row of z), as it
  // lies there: one read from device memory is rounded by ``round`` once
  // every load of the slots in flight is issued
  __device__ __forceinline__ void load(const float* win, const float* z,
                                       int k, int c0, int off,
                                       float (&m)[NV][W]) const {
    if (off >= 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (ok[j]) load_vec<W>(win + off + col[j], m[j]);
    } else {
      const float* p = z + (size_t)(-1 - off) * k + c0;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (ok[j]) ldg_vec<W>(p + col[j], m[j]);
    }
  }

  __device__ __forceinline__ void round(int off, float (&m)[NV][W]) const {
    if (QUANT && off < 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int v = 0; v < W; ++v) m[j][v] = message<QUANT>(m[j][v]);
    }
  }
};

// A row's slots: from shared memory (STAGED: each index already turned into
// its message's place), or read from device memory as they are summed.
template <bool STAGED>
struct Slots {
  const int* idx;
  const float* val;
  int w0, w1, tile_cols;

  __device__ __forceinline__ int place(int l) const {
    if constexpr (STAGED) return idx[l];
    const int src = __ldg(idx + l);
    return src >= w0 && src < w1 ? (src - w0) * tile_cols : -1 - src;
  }
  __device__ __forceinline__ float weight(int l) const {
    if constexpr (STAGED) return val[l];
    return __ldg(val + l);
  }
};

// W: floats a copy and a load (4: 16 bytes, 1: 4 bytes). STAGED: the band's
// slots and diagonal in shared memory.
template <int W, bool QUANT, bool STAGED>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(EllArgs args) {
  constexpr int NV = kTileCols / (32 * W);   // vectors a lane
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's member of the batch: its own slots, diagonal and payload
  const int per_member = args.bands * args.tiles;
  const size_t member = blockIdx.x / per_member;
  const int b = blockIdx.x - (int)member * per_member;
  EllArgs a = args;
  a.idx += member * a.n * a.width;
  a.val += member * a.n * a.width;
  a.diag += member * a.n;
  a.z += member * a.n * a.k;
  a.out += member * a.n * a.k;
  const int band = b % a.bands, tile = b / a.bands;
  const int r0 = band * a.band_rows, r1 = min(a.n, r0 + a.band_rows);
  const int w0 = max(0, r0 - a.halo), w1 = min(a.n, r1 + a.halo);
  const int c0 = tile * a.tile_cols, cols = min(a.tile_cols, a.k - c0);
  const int slots = (r1 - r0) * a.width;
  float* win = reinterpret_cast<float*>(smem);
  int* soff = reinterpret_cast<int*>(
      win + (size_t)(a.band_rows + 2 * a.halo) * a.tile_cols);
  float* sval = reinterpret_cast<float*>(soff + a.band_rows * a.width);
  float* sdiag = sval + a.band_rows * a.width;

  // -- stage the window, the band's slots and diagonal; wait once ----------
  {
    const int per_row = cols / W;
    for (int u = threadIdx.x; u < (w1 - w0) * per_row; u += kThreads) {
      const int i = u / per_row, c = (u - i * per_row) * W;
      const float* src = a.z + (size_t)(w0 + i) * a.k + c0 + c;
      float* d = win + i * a.tile_cols + c;
      if constexpr (W == 4)
        hopper::cp_async_16(hopper::smem_u32(d), src, 16);
      else
        cp_async_4(d, src);
    }
    if constexpr (STAGED) {
      const int* gi = a.idx + (size_t)r0 * a.width;
      const float* gv = a.val + (size_t)r0 * a.width;
      for (int s = threadIdx.x; s < slots; s += kThreads) {
        cp_async_4(soff + s, gi + s);
        cp_async_4(sval + s, gv + s);
      }
      for (int i = threadIdx.x; i < r1 - r0; i += kThreads)
        cp_async_4(sdiag + i, a.diag + r0 + i);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
  }
  // each staged slot's index becomes its message's place
  if constexpr (STAGED) {
    for (int s = threadIdx.x; s < slots; s += kThreads) {
      const int src = soff[s];
      soff[s] = src >= w0 && src < w1 ? (src - w0) * a.tile_cols : -1 - src;
    }
  }
  if constexpr (QUANT) {               // each staged message once
    for (int i = threadIdx.x; i < (w1 - w0) * a.tile_cols; i += kThreads)
      win[i] = message<true>(win[i]);
  }
  __syncthreads();

  // -- sum each row in slot order -------------------------------------------
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Lane<W, QUANT, NV> me;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    me.col[j] = (j * 32 + lane) * W;
    me.ok[j] = me.col[j] < cols;
  }
  for (int row = r0 + warp; row < r1; row += kWarps) {
    Slots<STAGED> ro;
    if constexpr (STAGED) {
      ro = {soff + (row - r0) * a.width, sval + (row - r0) * a.width};
    } else {
      ro = {a.idx + (size_t)row * a.width, a.val + (size_t)row * a.width,
            w0, w1, a.tile_cols};
    }
    const float dg = STAGED ? sdiag[row - r0] : __ldg(a.diag + row);
    float acc[NV][W];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float own[W] = {};
      if (me.ok[j]) {              // f32 from the window, never a rounded one
        if constexpr (!QUANT)
          load_vec<W>(win + (row - w0) * a.tile_cols + me.col[j], own);
        else
          ldg_vec<W>(a.z + (size_t)row * a.k + c0 + me.col[j], own);
      }
#pragma unroll
      for (int v = 0; v < W; ++v) acc[j][v] = own[v] * dg;
    }
    // slots [l, end) in order onto the sums s, kSlots loads in flight
    auto sum_slots = [&](float (&s)[NV][W], int l, const int end) {
      for (; l + kSlots <= end; l += kSlots) {
        float m[kSlots][NV][W];
        int off[kSlots];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          off[u] = ro.place(l + u);
          me.load(win, a.z, a.k, c0, off[u], m[u]);
        }
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          me.round(off[u], m[u]);
          const float w = ro.weight(l + u);
#pragma unroll
          for (int j = 0; j < NV; ++j)
#pragma unroll
            for (int v = 0; v < W; ++v)
              s[j][v] = fmaf(w, m[u][j][v], s[j][v]);
        }
      }
      for (; l < end; ++l) {
        float m[NV][W];
        const int off = ro.place(l);
        me.load(win, a.z, a.k, c0, off, m);
        me.round(off, m);
        const float w = ro.weight(l);
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int v = 0; v < W; ++v) s[j][v] = fmaf(w, m[j][v], s[j][v]);
      }
    };
    // the first kChunk slots run on from the own term; each later chunk is
    // summed from 0 and added once
    sum_slots(acc, 0, min(a.width, kChunk));
    for (int s0 = kChunk; s0 < a.width; s0 += kChunk) {
      float part[NV][W];
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int v = 0; v < W; ++v) part[j][v] = 0.0f;
      sum_slots(part, s0, min(a.width, s0 + kChunk));
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int v = 0; v < W; ++v) acc[j][v] += part[j][v];
    }
    float* o = a.out + (size_t)row * a.k + c0;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!me.ok[j]) continue;
      if constexpr (W == 4)
        __stcs(reinterpret_cast<float4*>(o + me.col[j]),
               make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
      else
        __stcs(o + me.col[j], acc[j][0]);
    }
  }
}

template <int W, bool QUANT, bool STAGED>
cudaError_t launch(const EllArgs& a, int blocks, int smem, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        ell_spmm_kernel<W, QUANT, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  ell_spmm_kernel<W, QUANT, STAGED><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int W, bool QUANT>
cudaError_t launch(const EllArgs& a, int staged, int blocks, int smem,
                   cudaStream_t s) {
  return staged ? launch<W, QUANT, true>(a, blocks, smem, s)
                : launch<W, QUANT, false>(a, blocks, smem, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// idx: (batch, n, width) int32, val: (batch, n, width) f32, diag:
// (batch, n) f32, z and out: (batch, n, k) f32, each member contiguous
// after the last. params (on the host, in this order): n, k, width,
// quantise (round each gathered value to bf16), and the plan
// (ell_spmm.py): band_rows, halo (rows either side of a band), tile_cols
// (a multiple of 4 where vec), vec (the 16-byte route), staged (the band's
// slots in shared memory), smem (bytes of shared memory, at most 200 KB),
// batch (members, >= 1). Returns the CUDA error code of the launch (0 on
// success).
int ell_spmm_launch(const int* idx, const float* val, const float* diag,
                    const float* z, float* out, const int* params,
                    void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const int n = params[0], k = params[1], width = params[2],
            quantise = params[3], band_rows = params[4], halo = params[5],
            tile_cols = params[6], vec = params[7], staged = params[8],
            smem = params[9], batch = params[10];
  const long long need =
      4LL * ((band_rows + 2LL * halo) * tile_cols +
             (staged ? band_rows * (2LL * width + 1) : 0));
  if (n < 1 || k < 1 || width < 0 || band_rows < 1 || halo < 0 ||
      batch < 1 ||
      tile_cols < 1 || tile_cols > kTileCols || smem < need ||
      smem > kMaxSmem ||
      (vec && (tile_cols % 4 || k % 4 || !aligned16(z) || !aligned16(out))))
    return (int)cudaErrorInvalidValue;
  const int bands = (n + band_rows - 1) / band_rows;
  const int tiles = (k + tile_cols - 1) / tile_cols;
  const long long all_blocks = (long long)batch * bands * tiles;
  if (all_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  EllArgs a{idx, val, diag, z, out, n, k, width, band_rows, halo, tile_cols,
            bands, tiles};
  const int blocks = (int)all_blocks;
  if (vec)
    return (int)(quantise ? launch<4, true>(a, staged, blocks, smem, s)
                          : launch<4, false>(a, staged, blocks, smem, s));
  return (int)(quantise ? launch<1, true>(a, staged, blocks, smem, s)
                        : launch<1, false>(a, staged, blocks, smem, s));
}

}  // extern "C"
