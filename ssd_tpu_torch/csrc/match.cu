// Anchor matching for Hopper (sm_90a): the IoU of every anchor with every
// gt of its image, reduced both ways.
//
// Replaces ssd_tpu/ops/matching_pallas.py::_match_kernel (launched from
// _match_core, wrapped by match_anchors_pallas). It computes the same
// function; it is not carried over block by block.
//
// Inputs: anchors (A, 4) f32, gts (N, M, 4) f32 padded, num_boxes (N,) i32.
// Outputs, per image:
//   best_gt (N, A) i32 and best_iou (N, A) f32: each anchor's best gt and
//     that IoU, the first of equal maxima; padded gts score -1, so an image
//     with no gts yields best_gt 0 and best_iou -1;
//   best_anchor (N, M) i32: each valid gt's best anchor, the lowest index
//     among equal maxima; 0 for a padded gt.
//
// What bounds it on this card: operations, if every (gt, anchor) pair is
// computed. At the flagship training shape (N = 64, A = 76 725, M = 100,
// about 55 gts an image) that is about 270 M IoUs of 13 f32 ops each (about
// 0.05 ms at 67 TFLOP/s), against under 2 MB read and 39 MB written (about
// 0.012 ms at 3.35 TB/s). Most pairs need no arithmetic at all: an anchor
// and a gt that do not overlap have IoU +0.
//
// The design:
// - A block takes 1024 consecutive anchors of one image, 8 warps of 128;
//   lane l of a warp holds its anchors base + 32p + l, p = 0..3, in
//   registers (coalesced loads and stores). The image's valid gts and their
//   areas sit in shared memory.
// - Exact culling. Each warp bounds its 128 anchors with one box (min of
//   ymin/xmin, max of ymax/xmax, by shuffles) and lists, in gt order, the
//   gts whose overlap with that box is positive on both axes. For a gt not
//   listed, min(y1) - max(y0) <= 0 for every anchor of the warp on some
//   axis; a rounded subtraction keeps that sign, so h or w is 0, inter is
//   0, and the IoU is +0. The warp's loop runs over its list only.
//   Anchors are consecutive in (level, row, col, scale x aspect) order, so
//   128 of them span a strip of a few cells; per warp the cull keeps fewer
//   pairs than per block of 1024 anchors. The entry point ssd_match_listed
//   runs the same kernel and also sums, over warps, the listed gts times
//   the warp's anchors: the pairs the cull leaves (`chip_smoke.py`'s match
//   phase prints the share it removes).
// - Per anchor: best = +0, best_j = 0 when the image has a gt (-1 and 0
//   when it has none), replaced only by a strictly greater IoU; a culled gt
//   (IoU +0) can never replace it, so the result is still the first
//   occurrence of the maximum.
// - Per gt: the maximum of a packed 64-bit key, (float bits of the IoU) <<
//   32 | (0xFFFFFFFF - anchor): for IoU >= 0 the bit order is the value
//   order, and among equal IoUs the lower anchor has the larger key. The
//   caller fills every key with 0x00000000FFFFFFFF, "IoU +0 at anchor 0":
//   anchor 0's true key is at least that, and every other zero-IoU key is
//   below it, so only pairs with IoU > 0 need reporting. A lane first takes
//   the maximum over its four anchors in registers; the warp then reduces
//   with two 32-bit redux.sync (__reduce_max_sync): the IoU bits, then
//   0xFFFFFFFF - anchor among the lanes that hold that maximum. One lane
//   folds a nonzero result into the block's key in shared memory, and at
//   the end each gt's block key goes to device memory with one atomicMax.
//   A second, tiny kernel unpacks the keys into anchor indices.
//
// Exactness: the IoU is spelled in the plain version's op order (the JAX
// package's box_utils.iou): inter / max(a_area + g_area - inter, 1e-8),
// every op rounded to nearest with the _rn intrinsics so that no FMA
// contraction moves a keep or ignore decision at exactly 0.4 or 0.5; the
// build also passes -fmad=false. When inter is 0 the division is skipped
// and the IoU is +0, which is what the division and a + 0 give.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPerLane = 4;
constexpr int kWarpAnchors = 32 * kPerLane;
constexpr int kBlockAnchors = kWarps * kWarpAnchors;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// The IoU of anchor `an` and gt `g`, >= +0 (never -0).
__device__ __forceinline__ float iou(float4 an, float an_area, float4 g,
                                     float g_area) {
  const float h = fmaxf(__fsub_rn(fminf(an.z, g.z), fmaxf(an.x, g.x)), 0.0f);
  const float w = fmaxf(__fsub_rn(fminf(an.w, g.w), fmaxf(an.y, g.y)), 0.0f);
  const float inter = __fmul_rn(h, w);
  if (inter == 0.0f) return 0.0f;
  const float uni = __fsub_rn(__fadd_rn(an_area, g_area), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-8f));
}

// kCount: also add the pairs this warp computes to *listed.
template <bool kCount>
__global__ void __launch_bounds__(kWarps * 32)
match_kernel(const float4* __restrict__ anchors,  // (A,)
             const float4* __restrict__ gts,      // (N, M)
             const int* __restrict__ num_boxes,   // (N,)
             int a, int m,
             int* __restrict__ best_gt,           // (N, A)
             float* __restrict__ best_iou,        // (N, A)
             unsigned long long* __restrict__ keys,     // (N, M)
             unsigned long long* __restrict__ listed) {  // ()
  extern __shared__ float4 smem[];
  float4* g = smem;                                          // (M,)
  unsigned long long* block_key =
      reinterpret_cast<unsigned long long*>(g + m);          // (M,)
  float* g_area = reinterpret_cast<float*>(block_key + m);   // (M,)
  unsigned short* lists =
      reinterpret_cast<unsigned short*>(g_area + m);         // (kWarps, M)

  const int image = blockIdx.y;
  const int nb = min(max(num_boxes[image], 0), m);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kBlockAnchors + warp * kWarpAnchors;

  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    const float4 b = gts[static_cast<long>(image) * m + j];
    g[j] = b;
    g_area[j] = box_area(b);
    block_key[j] = 0ull;
  }

  // This lane's anchors. Past A, an empty box at infinity: it leaves the
  // warp's bound as it is and overlaps nothing.
  float4 an[kPerLane];
  float an_area[kPerLane];
  float y0 = CUDART_INF_F, x0 = CUDART_INF_F;
  float y1 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
  for (int p = 0; p < kPerLane; ++p) {
    const int idx = base + p * 32 + lane;
    an[p] = idx < a ? anchors[idx]
                    : make_float4(CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F,
                                  -CUDART_INF_F);
    an_area[p] = box_area(an[p]);
    y0 = fminf(y0, an[p].x);
    x0 = fminf(x0, an[p].y);
    y1 = fmaxf(y1, an[p].z);
    x1 = fmaxf(x1, an[p].w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    y0 = fminf(y0, __shfl_xor_sync(kFull, y0, off));
    x0 = fminf(x0, __shfl_xor_sync(kFull, x0, off));
    y1 = fmaxf(y1, __shfl_xor_sync(kFull, y1, off));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, off));
  }
  __syncthreads();  // the gts are in shared memory

  // The gts that can overlap an anchor of this warp, in gt order.
  unsigned short* list = lists + warp * m;
  int count = 0;
  for (int j0 = 0; j0 < nb; j0 += 32) {
    const int j = j0 + lane;
    bool hit = false;
    if (j < nb) {
      const float4 b = g[j];
      hit = fminf(y1, b.z) > fmaxf(y0, b.x) && fminf(x1, b.w) > fmaxf(x0, b.y);
    }
    const unsigned mask = __ballot_sync(kFull, hit);
    if (hit) list[count + __popc(mask & ((1u << lane) - 1u))] = j;
    count += __popc(mask);
  }
  __syncwarp();
  if (kCount && lane == 0 && count > 0)
    atomicAdd(listed, static_cast<unsigned long long>(count) *
                          static_cast<unsigned>(min(max(a - base, 0),
                                                    kWarpAnchors)));

  float best[kPerLane];
  int best_j[kPerLane];
#pragma unroll
  for (int p = 0; p < kPerLane; ++p) {
    best[p] = nb > 0 ? 0.0f : -1.0f;
    best_j[p] = 0;
  }
  // count is the same in every lane, so every lane runs each iteration and
  // the full-mask reductions are legal.
  for (int t = 0; t < count; ++t) {
    const int j = list[t];
    const float4 b = g[j];
    const float b_area = g_area[j];
    float top = 0.0f;  // this lane's largest IoU with gt j, at its first p
    int top_p = 0;
#pragma unroll
    for (int p = 0; p < kPerLane; ++p) {
      const float v = iou(an[p], an_area[p], b, b_area);
      if (v > best[p]) {
        best[p] = v;
        best_j[p] = j;
      }
      if (v > top) {
        top = v;
        top_p = p;
      }
    }
    const unsigned bits = __float_as_uint(top);
    const unsigned warp_bits = __reduce_max_sync(kFull, bits);
    if (warp_bits == 0u) continue;  // no anchor of this warp overlaps gt j
    const unsigned low = 0xFFFFFFFFu -
                         static_cast<unsigned>(base + top_p * 32 + lane);
    const unsigned warp_low =
        __reduce_max_sync(kFull, bits == warp_bits ? low : 0u);
    if (lane == 0)
      atomicMax(&block_key[j],
                (static_cast<unsigned long long>(warp_bits) << 32) | warp_low);
  }

#pragma unroll
  for (int p = 0; p < kPerLane; ++p) {
    const int idx = base + p * 32 + lane;
    if (idx < a) {
      const long o = static_cast<long>(image) * a + idx;
      best_gt[o] = best_j[p];
      best_iou[o] = best[p];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nb; j += blockDim.x)
    if (block_key[j] != 0ull)
      atomicMax(&keys[static_cast<long>(image) * m + j], block_key[j]);
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              const int* __restrict__ num_boxes, int n, int m,
                              int* __restrict__ best_anchor) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long>(n) * m) return;
  const int image = static_cast<int>(i / m);
  const int j = static_cast<int>(i % m);
  int out = 0;
  if (j < min(max(num_boxes[image], 0), m))
    out = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(keys[i]));
  best_anchor[i] = out;
}

// Per gt: its box (float4), its block key (uint64), its area (f32) and one
// list slot (uint16) for each warp.
size_t smem_bytes(int m) {
  return static_cast<size_t>(m) *
         (sizeof(float4) + sizeof(unsigned long long) + sizeof(float) +
          kWarps * sizeof(unsigned short));
}

template <bool kCount>
int launch(const void* anchors, const void* gts, const void* num_boxes, int n,
           int a, int m, void* best_gt, void* best_iou, void* keys,
           void* best_anchor, void* listed, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(m);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(match_kernel<kCount>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && a > 0) {
    const dim3 grid((a + kBlockAnchors - 1) / kBlockAnchors, n);
    match_kernel<kCount><<<grid, kWarps * 32, smem, s>>>(
        static_cast<const float4*>(anchors), static_cast<const float4*>(gts),
        static_cast<const int*>(num_boxes), a, m, static_cast<int*>(best_gt),
        static_cast<float*>(best_iou),
        static_cast<unsigned long long*>(keys),
        static_cast<unsigned long long*>(listed));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long total = static_cast<long>(n) * m;
  if (total > 0) {
    unpack_kernel<<<static_cast<unsigned int>((total + 255) / 256), 256, 0,
                    s>>>(static_cast<const unsigned long long*>(keys),
                         static_cast<const int*>(num_boxes), n, m,
                         static_cast<int*>(best_anchor));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest M whose gts fit one block's shared memory on `device`.
int ssd_match_max_gts(int device, int* m) {
  int limit = 0;
  const int rc = static_cast<int>(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *m = static_cast<int>(limit / smem_bytes(1));
  return rc;
}

// Launches both kernels on `stream` of `device`. `keys` is (N, M) uint64
// scratch that the caller has filled with 0x00000000FFFFFFFF. Returns
// cudaGetLastError() after the launches (0 on success). This library links
// its own CUDA runtime, whose current device is set here rather than
// inherited from PyTorch's.
int ssd_match(const void* anchors, const void* gts, const void* num_boxes,
              int n, int a, int m, void* best_gt, void* best_iou,
              void* keys, void* best_anchor, int device, void* stream) {
  return launch<false>(anchors, gts, num_boxes, n, a, m, best_gt, best_iou,
                       keys, best_anchor, nullptr, device, stream);
}

// ssd_match, and adds to `listed` (one uint64 on the card) the (gt, anchor)
// pairs whose IoUs the kernel computes after its cull.
int ssd_match_listed(const void* anchors, const void* gts,
                     const void* num_boxes, int n, int a, int m,
                     void* best_gt, void* best_iou, void* keys,
                     void* best_anchor, void* listed, int device,
                     void* stream) {
  return launch<true>(anchors, gts, num_boxes, n, a, m, best_gt, best_iou,
                      keys, best_anchor, listed, device, stream);
}

}  // extern "C"
