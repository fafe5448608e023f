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
// kept; so j goes exactly when some kept i < j overlaps it past the
// threshold.
//
// What bounds it on this card: neither bytes nor arithmetic. At the serving
// shape (G = 2560, K = 128, Q = 1024) the kernel reads and writes ~4.5 MB
// (about 1.3 us at 3.35 TB/s) and greedy NMS needs about 10 M IoUs (about
// 2 us of f32 at 67 TFLOP/s). What it costs is the scan's dependent steps
// and the instructions the SMs issue for its IoU tests. A block-wide
// barrier per step (PR 1's one block per problem) made the time K barrier
// latencies times the waves of blocks.
//
// The design: one warp per problem, several problems to a block, and no
// block barrier anywhere.
// - The warp gathers its K boxes by index into its own slice of shared
//   memory (boxes as float4, areas as f32, candidate-major, so lane l reads
//   candidate 32c + l without bank conflicts) and keeps one 32-bit word of
//   keep flags per chunk of 32 candidates (bit l of word c is candidate
//   32c + l), built with __ballot_sync.
// - The scan walks the chunks in order. When it reaches chunk c, every kept
//   candidate of the earlier chunks has been applied to c's word, so only
//   c's own pivots are left. The IoU is symmetric bit for bit, so 16
//   rounds test every pair of the chunk once (lane l against candidate
//   l + d mod 32, a ballot showing each lane its partner's result); each
//   lane gathers the later candidates its own would drop, and 32 shuffles
//   resolve the chunk's pivots in order.
// - Then c's word is final. Its kept pivots are packed, in order, into its
//   own slots and tested against the later chunks, two chunks and four
//   pivots a round (eight independent IoUs); one ballot per later chunk
//   clears its word. __syncwarp() orders these writes before the next
//   chunk's reads; nothing waits on another warp.
// - The test "IoU > t" decides most pairs without the division (see
//   `test`); the few within about 2^-20 of t are divided.
// - When a chunk is final its scores are written at once, one coalesced
//   store a lane.
// - A problem whose best score is <= 0 writes -1s and exits at once (the
//   TPU kernel's empty-block exit, per problem).
// - The host picks the problems a block from K: up to kMaxWarps, as many as
//   the card's shared memory holds, so K = 512 and the largest K that fits
//   one warp's slice in a block still launch.
//
// Exactness: the IoU is computed op for op as the plain version computes it
// (area_i + area_j - inter, then inter / max(union, 1e-8)), every op rounded
// to nearest with the _rn intrinsics so that no FMA contraction changes a
// rounding; division stays IEEE. Where the division is skipped the
// comparison with the threshold is decided with a margin of 2^-20, wider
// than any rounding of the products it compares. The threshold arrives as
// a float32. The build also passes -fmad=false.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>

namespace {

constexpr int kMaxWarps = 4;
// Pivots a round in the tests against later chunks (independent IoUs).
constexpr int kRound = 4;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory per chunk of 32 candidates: the boxes (float4), the areas
// (f32) and one keep word.
constexpr int kChunkBytes = 32 * (16 + 4) + 4;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// The threshold t, and t scaled down and up by 2^-20 for the test below
// (-inf and +inf where t is not in [2^-20, 2^20], which turns it off).
struct Threshold {
  float t, lo, hi;
};

// The IoU of pivot p (area pa) and candidate b (area ba) is RN(inter / u):
// the plain version's ops, pivot first.
struct Parts {
  float inter, u;
};

__device__ __forceinline__ Parts iou_parts(float4 p, float pa, float4 b,
                                           float ba) {
  const float h = fmaxf(__fsub_rn(fminf(p.z, b.z), fmaxf(p.x, b.x)), 0.0f);
  const float w = fmaxf(__fsub_rn(fminf(p.w, b.w), fmaxf(p.y, b.y)), 0.0f);
  const float inter = __fmul_rn(h, w);
  return {inter, fmaxf(__fsub_rn(__fadd_rn(pa, ba), inter), 1e-8f)};
}

// Whether RN(inter / u) > t, decided without the division where inter lies
// outside [RN(lo * u), RN(hi * u)]: those two products are within 2^-24 of
// their real values and 2^-20 from t * u, so there the rounded quotient
// lies at least an ulp from t on the same side. That covers inter = 0 at
// any t > 0. ORs "over" into `hit` and "the division decides" (a quotient
// within about 2^-20 of t, or lo * u overflowed) into `maybe`; no branch.
__device__ __forceinline__ void test(float4 p, float pa, float4 b, float ba,
                                     Threshold th, bool& hit, bool& maybe) {
  const Parts x = iou_parts(p, pa, b, ba);
  const float lo = __fmul_rn(th.lo, x.u);
  const bool yes = x.inter > __fmul_rn(th.hi, x.u);
  const bool no = x.inter < lo && lo != CUDART_INF_F;
  hit |= yes;
  maybe |= !yes && !no;
}

// Whether pivot 32c + i drops candidate b, by the division.
__device__ __forceinline__ bool over_exact(int c, int i, float4 b, float ba,
                                           const float4* box,
                                           const float* area, float t) {
  const Parts x = iou_parts(box[c * 32 + i], area[c * 32 + i], b, ba);
  return __fdiv_rn(x.inter, x.u) > t;
}

// The kept pivots of a chunk, packed into the chunk's first `np` slots
// (`piv`, `piv_area`) and padded with copies of the first up to a multiple
// of kRound, against the candidates of the G chunks from c on, lane l
// holding candidate l of each: kRound pivots a round, so kRound * G
// independent IoUs overlap; the rare pairs the test leaves open are
// divided afterwards. One ballot per chunk clears its word.
template <int G>
__device__ __forceinline__ void drop_later(const float4* piv,
                                           const float* piv_area, int np,
                                           int c, int lane, const float4* box,
                                           const float* area, unsigned* keep,
                                           Threshold th) {
  float4 bj[G];
  float aj[G];
  unsigned word[G];
  bool hit[G], maybe[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    word[r] = keep[c + r];
    bj[r] = box[(c + r) * 32 + lane];
    aj[r] = area[(c + r) * 32 + lane];
    hit[r] = maybe[r] = false;
  }
  for (int p0 = 0; p0 < np; p0 += kRound) {
#pragma unroll
    for (int q = 0; q < kRound; ++q) {
      const float4 p = piv[p0 + q];
      const float pa = piv_area[p0 + q];
#pragma unroll
      for (int r = 0; r < G; ++r) test(p, pa, bj[r], aj[r], th, hit[r], maybe[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < G; ++r) {
    bool d = hit[r];
    for (int i = 0; i < np && maybe[r] && !d; ++i) {
      const Parts x = iou_parts(piv[i], piv_area[i], bj[r], aj[r]);
      d = __fdiv_rn(x.inter, x.u) > th.t;
    }
    const unsigned gone = __ballot_sync(kFull, d && ((word[r] >> lane) & 1u));
    if (gone != 0u && lane == 0) keep[c + r] = word[r] & ~gone;
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
nms_kernel(const float* __restrict__ boxes,   // (N, Q, 4)
           const int* __restrict__ idx,       // (G, K)
           const float* __restrict__ scores,  // (G, K)
           float* __restrict__ out,           // (G, K)
           int num_problems, int num_classes, int q, int k,
           Threshold th) {
  // The block's shared memory: every warp's boxes, then every warp's
  // areas, then every warp's keep words (the float4s stay 16-byte aligned).
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long g = static_cast<long>(blockIdx.x) * warps + warp;
  if (g >= num_problems) return;
  const int chunks = (k + 31) >> 5;
  const long kr = chunks * 32L;
  float4* box = smem + warp * kr;
  float* area = reinterpret_cast<float*>(smem + warps * kr) + warp * kr;
  unsigned* keep = reinterpret_cast<unsigned*>(
      reinterpret_cast<float*>(smem + warps * kr) + warps * kr) +
      warp * chunks;

  const int* my_idx = idx + g * k;
  const float* my_scores = scores + g * k;
  float* my_out = out + g * k;

  if (!(my_scores[0] > 0.0f)) {  // sorted: slot 0 holds the problem's max
    for (int j = lane; j < k; j += 32) my_out[j] = -1.0f;
    return;
  }

  const float4* image_boxes = reinterpret_cast<const float4*>(boxes) +
                              static_cast<long>(g / num_classes) * q;
#pragma unroll 4
  for (int c = 0; c < chunks; ++c) {
    const int j = c * 32 + lane;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // padding: never kept
    bool valid = false;
    if (j < k) {
      b = image_boxes[my_idx[j]];
      valid = my_scores[j] > 0.0f;
    }
    box[j] = b;
    area[j] = box_area(b);
    const unsigned word = __ballot_sync(kFull, valid);
    if (lane == 0) keep[c] = word;
  }
  __syncwarp();

  for (int c0 = 0; c0 < chunks; ++c0) {
    // The same value in every lane, so every branch on it is uniform.
    unsigned cur = keep[c0];
    const int j0 = c0 * 32 + lane;
    if (cur != 0u) {
      // This chunk's own pivots. The IoU is symmetric bit for bit (min,
      // max, and area_i + area_j all commute), so 16 rounds test every
      // pair once: in round d lane l tests candidate (l + d) mod 32, and a
      // ballot shows each lane the pair its partner (l - d) mod 32 tested.
      // `row` gathers the later candidates of the chunk that lane l's
      // candidate drops if it is kept.
      const float4 mine = box[j0];
      const float my_area = area[j0];
      unsigned row = 0u;
#pragma unroll 4
      for (int d = 1; d <= 16; ++d) {
        const int m = (lane + d) & 31;
        bool h = false, open = false;
        test(box[c0 * 32 + m], area[c0 * 32 + m], mine, my_area, th, h,
             open);
        if (open) h = over_exact(c0, m, mine, my_area, box, area, th.t);
        const unsigned seen = __ballot_sync(kFull, h);
        const int y = (lane - d) & 31;
        if (m > lane) row |= static_cast<unsigned>(h) << m;
        if (y > lane) row |= seen & (1u << y);
      }
      // Greedy in order: a kept candidate drops its row.
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const unsigned rb = __shfl_sync(kFull, row, b);
        if ((cur >> b) & 1u) cur &= ~rb;
      }
      const unsigned earlier = (1u << lane) - 1u;
      // cur is final: its kept pivots drop what they overlap further on,
      // two chunks at a time. They are packed first, in order, into the
      // chunk's own slots, which nothing reads any more but this.
      if (c0 + 1 < chunks) {
        const int np = __popc(cur);
        const int padded = (np + kRound - 1) / kRound * kRound;
        const int first = __ffs(cur) - 1;
        const float4 p0 = make_float4(__shfl_sync(kFull, mine.x, first),
                                      __shfl_sync(kFull, mine.y, first),
                                      __shfl_sync(kFull, mine.z, first),
                                      __shfl_sync(kFull, mine.w, first));
        const float a0 = __shfl_sync(kFull, my_area, first);
        __syncwarp();  // every test of this chunk has read its slots
        if ((cur >> lane) & 1u) {
          box[c0 * 32 + __popc(cur & earlier)] = mine;
          area[c0 * 32 + __popc(cur & earlier)] = my_area;
        }
        if (lane >= np && lane < padded) {
          box[c0 * 32 + lane] = p0;
          area[c0 * 32 + lane] = a0;
        }
        __syncwarp();
        int c = c0 + 1;
        for (; c + 2 <= chunks; c += 2)
          drop_later<2>(box + c0 * 32, area + c0 * 32, np, c, lane, box,
                        area, keep, th);
        if (c < chunks)
          drop_later<1>(box + c0 * 32, area + c0 * 32, np, c, lane, box,
                        area, keep, th);
      }
      __syncwarp();
    }
    if (j0 < k) my_out[j0] = ((cur >> lane) & 1u) ? my_scores[j0] : -1.0f;
  }
}

size_t slice_bytes(int k) {
  return static_cast<size_t>((k + 31) / 32) * kChunkBytes;
}

// The largest dynamic shared memory one block may use on `device`.
int smem_limit(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

}  // namespace

extern "C" {

// Largest K whose candidates fit one warp's slice of one block's shared
// memory on `device` (the kernel then runs one problem a block).
int ssd_nms_max_k(int device, int* k) {
  int limit = 0;
  const int rc = smem_limit(device, &limit);
  *k = 32 * (limit / kChunkBytes);
  return rc;
}

// Launches the kernel on `stream` of `device`; returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue when one
// problem's K candidates do not fit one block's shared memory. The caller
// checks shapes first. This library links its own CUDA runtime, whose
// current device is set here rather than inherited from PyTorch's.
int ssd_nms_suppress(const void* boxes, const void* idx, const void* scores,
                     void* out, int num_problems, int num_classes, int q,
                     int k, float iou_threshold, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int limit = 0;
  const int rc = smem_limit(device, &limit);
  if (rc != 0) return rc;
  const size_t slice = slice_bytes(k);
  if (k < 1 || slice > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = static_cast<int>(limit / slice);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t smem = warps * slice;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Threshold th = {iou_threshold, -INFINITY, INFINITY};
  if (iou_threshold >= 0x1p-20f && iou_threshold <= 0x1p20f) {
    th.lo = iou_threshold - iou_threshold * 0x1p-20f;
    th.hi = iou_threshold + iou_threshold * 0x1p-20f;
  }
  if (num_problems > 0) {
    const int blocks = (num_problems + warps - 1) / warps;
    nms_kernel<<<blocks, warps * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const int*>(idx),
        static_cast<const float*>(scores), static_cast<float*>(out),
        num_problems, num_classes, q, k, th);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
