// Class-wise greedy hard NMS for Hopper (sm_90a).
//
// Replaces ssd_tpu/ops/nms_pallas.py::_nms_kernel (launched from
// _suppress_pallas, wrapped by batched_nms_pallas). It computes the same
// function; it is not carried over block by block.
//
// Input: G = N * C independent (image, class) problems. Problem g holds K
// candidates, sorted by descending score (invalid slots score -1), given as
// indices into its image's Q shared candidate boxes. Output: each
// candidate's score if greedy NMS keeps it, else -1. Step i of the scan
// drops every j > i whose IoU with i exceeds the threshold, if i is still
// kept.
//
// What bounds it on this card: neither bytes nor arithmetic. At the serving
// shape (G = 2560, K = 128, Q = 1024) the kernel reads and writes ~4.5 MB
// (about 1.3 us at 3.35 TB/s) and computes at most G*K*(K-1)/2 ~ 21 M IoUs
// (about 4 us of f32 at 67 TFLOP/s). The scan itself is the limit: K
// dependent steps per problem, each ending in a block-wide barrier, so the
// time is K steps of barrier latency times the number of waves of blocks.
//
// What the simple design does about it: one block per problem, with every
// problem's boxes, areas and keep flags in shared memory, so each step is
// one barrier and at most ceil(K / threads) IoUs per thread, with no trip
// to device memory. Many small blocks (128 threads) keep many problems in
// flight on each SM, so the barriers of different problems overlap. A
// problem whose best score is <= 0 writes -1s and exits at once (the TPU
// kernel's empty-block exit, per problem). A kept pivot skips the IoU for
// candidates already dropped.
//
// Exactness: the IoU is computed op for op as the plain version computes it
// (area_i + area_j - inter, then inter / max(union, 1e-8)), every op rounded
// to nearest with the _rn intrinsics so that no FMA contraction changes a
// rounding; division stays IEEE. The threshold arrives as a float32. The
// build also passes -fmad=false.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float box_area(float y0, float x0, float y1,
                                          float x1) {
  return __fmul_rn(fmaxf(__fsub_rn(y1, y0), 0.0f),
                   fmaxf(__fsub_rn(x1, x0), 0.0f));
}

__global__ void nms_kernel(const float* __restrict__ boxes,   // (N, Q, 4)
                           const int* __restrict__ idx,       // (G, K)
                           const float* __restrict__ scores,  // (G, K)
                           float* __restrict__ out,           // (G, K)
                           int num_classes, int q, int k,
                           float iou_threshold) {
  extern __shared__ float smem[];
  float* ymin = smem;
  float* xmin = ymin + k;
  float* ymax = xmin + k;
  float* xmax = ymax + k;
  float* area = xmax + k;
  int* keep = reinterpret_cast<int*>(area + k);

  const long g = blockIdx.x;
  const int image = static_cast<int>(g / num_classes);
  const int* my_idx = idx + g * k;
  const float* my_scores = scores + g * k;
  float* my_out = out + g * k;

  if (!(my_scores[0] > 0.0f)) {  // sorted: slot 0 holds the problem's max
    for (int j = threadIdx.x; j < k; j += blockDim.x) my_out[j] = -1.0f;
    return;
  }

  const float4* image_boxes =
      reinterpret_cast<const float4*>(boxes) + static_cast<long>(image) * q;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 b = image_boxes[my_idx[j]];
    ymin[j] = b.x;
    xmin[j] = b.y;
    ymax[j] = b.z;
    xmax[j] = b.w;
    area[j] = box_area(b.x, b.y, b.z, b.w);
    keep[j] = my_scores[j] > 0.0f;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (keep[i]) {  // the same value in every thread: nothing writes keep[i]
      const float py0 = ymin[i], px0 = xmin[i], py1 = ymax[i], px1 = xmax[i];
      const float pa = area[i];
      for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
        if (!keep[j]) continue;
        const float h = fmaxf(__fsub_rn(fminf(py1, ymax[j]), fmaxf(py0, ymin[j])),
                              0.0f);
        const float w = fmaxf(__fsub_rn(fminf(px1, xmax[j]), fmaxf(px0, xmin[j])),
                              0.0f);
        const float inter = __fmul_rn(h, w);
        const float uni = __fsub_rn(__fadd_rn(pa, area[j]), inter);
        const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-8f));
        if (iou > iou_threshold) keep[j] = 0;
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x)
    my_out[j] = keep[j] ? my_scores[j] : -1.0f;
}

constexpr int kThreads = 128;

size_t smem_bytes(int k) { return static_cast<size_t>(k) * 6 * sizeof(float); }

}  // namespace

extern "C" {

// Largest dynamic shared memory one block of the kernel may use on
// `device`, in bytes.
int ssd_nms_smem_limit(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Launches the kernel on `stream` of `device`; returns cudaGetLastError()
// after the launch (0 on success). The caller checks shapes and the
// shared-memory limit first. This library links its own CUDA runtime, whose
// current device is set here rather than inherited from PyTorch's.
int ssd_nms_suppress(const void* boxes, const void* idx, const void* scores,
                     void* out, int num_problems, int num_classes, int q,
                     int k, float iou_threshold, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_problems > 0) {
    nms_kernel<<<num_problems, kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const int*>(idx),
        static_cast<const float*>(scores), static_cast<float*>(out),
        num_classes, q, k, iou_threshold);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
