// Anchor matching for Hopper (sm_90a): the IoU of every anchor with every
// gt of its image, computed once and reduced both ways.
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
// What bounds it on this card: operations. At the flagship training shape
// (N = 64, A = 76 725, M = 100, about 55 gts an image) it reads under 2 MB
// and writes 39 MB (about 0.012 ms at 3.35 TB/s), and computes about 270 M
// IoUs of 13 f32 ops each (about 0.05 ms at 67 TFLOP/s). Each IoU also
// feeds two running maxima.
//
// What the simple design does about it: one thread per (image, anchor),
// 256 to a block, with the image's gts and their areas in shared memory;
// the thread loops over the image's valid gts only, so padding costs
// nothing. The per-anchor maximum stays in registers (a strict > keeps the
// first occurrence). The per-gt maximum across anchors is a max over a
// packed 64-bit key, (float bits of the IoU) << 32 | (0xFFFFFFFF - anchor):
// for IoU >= 0 the bit order is the value order, and among equal IoUs the
// lower anchor has the larger key. Each warp reduces the key with shuffles,
// one lane folds it into the block's shared key with atomicMax, and at the
// end each gt's block key goes to device memory with one atomicMax. A
// second, tiny kernel unpacks the keys into anchor indices.
//
// Exactness: the IoU is spelled in the plain version's op order (the
// JAX package's box_utils.iou): inter / max(a_area + g_area - inter, 1e-8),
// every op rounded to nearest with the _rn intrinsics so that no FMA
// contraction moves a keep or ignore decision at exactly 0.4 or 0.5; the
// build also passes -fmad=false. A zero IoU is made +0 before it is packed:
// fmaxf(-0, 0) may return -0, whose sign bit would outrank every key.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float box_area(float y0, float x0, float y1,
                                          float x1) {
  return __fmul_rn(fmaxf(__fsub_rn(y1, y0), 0.0f),
                   fmaxf(__fsub_rn(x1, x0), 0.0f));
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void match_kernel(const float4* __restrict__ anchors,  // (A,)
                             const float4* __restrict__ gts,      // (N, M)
                             const int* __restrict__ num_boxes,   // (N,)
                             int a, int m,
                             int* __restrict__ best_gt,           // (N, A)
                             float* __restrict__ best_iou,        // (N, A)
                             unsigned long long* __restrict__ keys) {  // (N, M)
  extern __shared__ float4 smem[];
  float4* g = smem;                                          // (M,)
  unsigned long long* block_key =
      reinterpret_cast<unsigned long long*>(g + m);          // (M,)
  float* g_area = reinterpret_cast<float*>(block_key + m);   // (M,)

  const int image = blockIdx.y;
  const int nb = min(max(num_boxes[image], 0), m);
  const int anchor = blockIdx.x * kThreads + threadIdx.x;
  const bool live = anchor < a;

  for (int j = threadIdx.x; j < nb; j += kThreads) {
    const float4 b = gts[static_cast<long>(image) * m + j];
    g[j] = b;
    g_area[j] = box_area(b.x, b.y, b.z, b.w);
    block_key[j] = 0ull;
  }
  __syncthreads();

  float4 an = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) an = anchors[anchor];
  const float a_area = box_area(an.x, an.y, an.z, an.w);
  const unsigned int low = 0xFFFFFFFFu - static_cast<unsigned int>(anchor);

  float best = -1.0f;
  int best_j = 0;
  // nb is the same for every thread of the block, so every lane of every
  // warp runs each iteration and the full-mask shuffles are legal.
  for (int j = 0; j < nb; ++j) {
    const float4 b = g[j];
    const float h = fmaxf(__fsub_rn(fminf(an.z, b.z), fmaxf(an.x, b.x)), 0.0f);
    const float w = fmaxf(__fsub_rn(fminf(an.w, b.w), fmaxf(an.y, b.y)), 0.0f);
    const float inter = __fmul_rn(h, w);
    const float uni = __fsub_rn(__fadd_rn(a_area, g_area[j]), inter);
    const float iou = __fadd_rn(__fdiv_rn(inter, fmaxf(uni, 1e-8f)), 0.0f);
    if (iou > best) {
      best = iou;
      best_j = j;
    }
    unsigned long long key = 0ull;
    if (live)
      key = (static_cast<unsigned long long>(__float_as_uint(iou)) << 32) | low;
    key = warp_max(key);
    if ((threadIdx.x & 31) == 0) atomicMax(&block_key[j], key);
  }
  if (live) {
    const long o = static_cast<long>(image) * a + anchor;
    best_gt[o] = best_j;
    best_iou[o] = best;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nb; j += kThreads)
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

size_t smem_bytes(int m) {
  return static_cast<size_t>(m) * (sizeof(unsigned long long) +
                                   sizeof(float4) + sizeof(float));
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may use on `device`, in bytes.
int ssd_match_smem_limit(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Launches both kernels on `stream` of `device`. `keys` is (N, M) uint64
// scratch that the caller has zeroed. Returns cudaGetLastError() after the
// launches (0 on success). This library links its own CUDA runtime, whose
// current device is set here rather than inherited from PyTorch's.
int ssd_match(const void* anchors, const void* gts, const void* num_boxes,
              int n, int a, int m, void* best_gt, void* best_iou,
              void* keys, void* best_anchor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(m);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && a > 0) {
    const dim3 grid((a + kThreads - 1) / kThreads, n);
    match_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float4*>(anchors), static_cast<const float4*>(gts),
        static_cast<const int*>(num_boxes), a, m, static_cast<int*>(best_gt),
        static_cast<float*>(best_iou),
        static_cast<unsigned long long*>(keys));
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

}  // extern "C"
