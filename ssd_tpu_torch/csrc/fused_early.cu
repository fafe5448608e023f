// ds1 + ds2 of the reference MobileNet-v1 schedule in one pass, for Hopper
// (sm_90a), with batch norm folded into the convs.
//
// Replaces ssd_tpu/ops/fused_early.py::_kernel (launched from
// fused_ds1_ds2). It computes the same function; it is not carried over
// block by block: none of the TPU's channel-packed lane layout, W-tiled tap
// vectors or block-diagonal pointwise matrices is kept, and only the kept
// (even) positions of the stride-2 conv are computed.
//
// Input x (N, H, W, C1) bf16 (a channels_last (N, C1, H, W) tensor), H and
// W even. Output (N, H/2, W/2, C3) bf16. Folded f32 operands: dw1_k
// (C1, 3, 3), dw1_b (C1), pw1_k (C1, C2), pw1_b (C2), dw2_k (C2, 3, 3),
// dw2_b (C2), pw2_k (C2, C3), pw2_b (C3). In f32 from the widened input:
//   dw1 3x3 s1 (SAME, 1 on every side) + bias, relu6;
//   pw1 C1 -> C2 + bias, relu6; zero at ds1's padded row H and column W;
//   dw2 3x3 s2 (SAME on an even input: 0 before, 1 after) + bias, relu6;
//   pw2 C2 -> C3 + bias, relu6; rounded to bf16 once.
//
// What bounds it on this card: operations. At x1.0, 640 px, batch 32
// ((32, 320, 320, 32) -> (32, 160, 160, 128)) it reads and writes 2 x 210 MB
// of bf16 (about 0.13 ms at 3.35 TB/s) and does 14.8 G multiply-adds (about
// 0.44 ms at 67 TFLOP/s of f32, counting a multiply-add as two operations).
//
// What the simple design does about it: the intermediates never leave the
// SM. One block of 256 threads computes a tile of 4 x 8 ds2 output pixels
// of one image, through four stages in shared memory, all f32:
//   in   (C1, 11 x 19): the tile's input with its halo, zero outside;
//   dw1  (C1,  9 x 17): dw1 over the 9 x 17 ds1 pixels the tile's dw2
//                       reads (one row and column beyond the tile's 8 x 16);
//   mid  (C2,  9 x 17): pw1 of those, zero where the row is >= H or the
//                       column is >= W (dw2's SAME padding);
//   dw2  (C2,  4 x  8): dw2 at the kept positions only (aliases `in`).
// pw2 goes from `dw2` straight to device memory. At C1 = 32 and C2 = 64 that
// is 85.5 KB of shared memory a block, so two blocks share an SM. The ds1
// rows and columns a tile shares with its neighbours are computed again by
// each (153 ds1 pixels a tile for 128 of its own, 20% more pw1 work).
// Each pointwise stage is a small matrix product in registers: a thread
// holds a (positions x channels) tile of sums, reads activations from
// shared memory and weights through the read-only cache. No tensor cores,
// TMA or wgmma yet.
//
// Exactness: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn; the build also passes -fmad=false), in the plain version's
// order (ops/fused_early.py): the depthwise taps in (dy, dx) order from the
// first product, the pointwise products in input-channel order from the
// first, then the bias. So the kernel equals the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 4;                   // ds2 output rows a block
constexpr int kTileCols = 8;                   // ds2 output columns a block
constexpr int kOut = kTileRows * kTileCols;    // 32
constexpr int kMidRows = 2 * kTileRows + 1;    // 9 ds1 rows
constexpr int kMidCols = 2 * kTileCols + 1;    // 17 ds1 columns
constexpr int kMid = kMidRows * kMidCols;      // 153
constexpr int kInRows = kMidRows + 2;          // 11 input rows
constexpr int kInCols = kMidCols + 2;          // 19 input columns
constexpr int kIn = kInRows * kInCols;         // 209

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

// Depthwise 3x3 over planes of `src` (channel-major, row pitch `pitch`,
// plane size `src_plane`) into `dst` (channel-major, `rows` x `cols`), at
// `stride`: dst[c][r][q] taps src[c][stride*r + dy][stride*q + dx].
__device__ __forceinline__ void depthwise(const float* src, int src_plane,
                                          int pitch, float* dst, int rows,
                                          int cols, int stride, int channels,
                                          const float* __restrict__ k,
                                          const float* __restrict__ b) {
  const int plane = rows * cols;
  for (int i = threadIdx.x; i < channels * plane; i += kThreads) {
    const int c = i / plane;
    const int p = i - c * plane;
    const int r = p / cols;
    const int q = p - r * cols;
    const float* s = src + c * src_plane + stride * r * pitch + stride * q;
    const float* kc = k + c * 9;
    float acc = __fmul_rn(s[0], __ldg(kc));
#pragma unroll
    for (int t = 1; t < 9; ++t)
      acc = __fadd_rn(acc, __fmul_rn(s[(t / 3) * pitch + t % 3], __ldg(kc + t)));
    dst[c * plane + p] = relu6(__fadd_rn(acc, __ldg(b + c)));
  }
}

// 1x1 conv from `src` (channel-major, `np` positions a plane) to `cout`
// channels, + bias, relu6, each value handed to `store(p, o, v)`. A thread
// owns kPT positions (p = tp + kTP * i) by kCT channels (o = tc + kTC * j)
// of each (position, channel) chunk.
template <int kTP, int kPT, int kCT, typename Store>
__device__ __forceinline__ void pointwise(const float* src, int np, int cin,
                                          const float* __restrict__ w,
                                          const float* __restrict__ b,
                                          int cout, Store store) {
  constexpr int kTC = kThreads / kTP;
  const int tp = threadIdx.x % kTP;
  const int tc = threadIdx.x / kTP;
  for (int p0 = 0; p0 < np; p0 += kTP * kPT) {
    for (int o0 = 0; o0 < cout; o0 += kTC * kCT) {
      float acc[kPT][kCT], a[kPT], wv[kCT];
      auto load = [&](int c) {
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const int p = p0 + tp + kTP * i;
          a[i] = p < np ? src[c * np + p] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
          const int o = o0 + tc + kTC * j;
          wv[j] = o < cout ? __ldg(w + c * cout + o) : 0.0f;
        }
      };
      load(0);
#pragma unroll
      for (int i = 0; i < kPT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) acc[i][j] = __fmul_rn(a[i], wv[j]);
      for (int c = 1; c < cin; ++c) {
        load(c);
#pragma unroll
        for (int i = 0; i < kPT; ++i)
#pragma unroll
          for (int j = 0; j < kCT; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], wv[j]));
      }
#pragma unroll
      for (int i = 0; i < kPT; ++i) {
        const int p = p0 + tp + kTP * i;
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
          const int o = o0 + tc + kTC * j;
          if (p < np && o < cout)
            store(p, o, relu6(__fadd_rn(acc[i][j], __ldg(b + o))));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_early_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dw1_k,
                   const float* __restrict__ dw1_b,
                   const float* __restrict__ pw1_k,
                   const float* __restrict__ pw1_b,
                   const float* __restrict__ dw2_k,
                   const float* __restrict__ dw2_b,
                   const float* __restrict__ pw2_k,
                   const float* __restrict__ pw2_b,
                   __nv_bfloat16* __restrict__ out, int h, int w, int c1,
                   int c2, int c3) {
  extern __shared__ float smem[];
  const int region = max(kIn * c1, kOut * c2);
  float* s_in = smem;               // (C1, kIn); later s_dw2 (C2, kOut)
  float* s_dw1 = smem + region;     // (C1, kMid)
  float* s_mid = s_dw1 + kMid * c1; // (C2, kMid)
  float* s_dw2 = s_in;

  const int ho = h / 2, wo = w / 2;
  const int tiles_x = (wo + kTileCols - 1) / kTileCols;
  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kTileRows;
  const int ox0 = (blockIdx.x % tiles_x) * kTileCols;
  const int my0 = 2 * oy0, mx0 = 2 * ox0;  // the tile's first ds1 pixel

  // ---- the input tile with its halo; zero outside the image
  const __nv_bfloat16* xn = x + static_cast<long>(n) * h * w * c1;
  for (int i = threadIdx.x; i < kIn * c1; i += kThreads) {
    const int pos = i / c1;
    const int c = i - pos * c1;
    const int gy = my0 - 1 + pos / kInCols;
    const int gx = mx0 - 1 + pos % kInCols;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = __bfloat162float(xn[(static_cast<long>(gy) * w + gx) * c1 + c]);
    s_in[c * kIn + pos] = v;
  }
  __syncthreads();

  // ---- ds1: dw1, then pw1 with dw2's zero padding
  depthwise(s_in, kIn, kInCols, s_dw1, kMidRows, kMidCols, 1, c1, dw1_k,
            dw1_b);
  __syncthreads();
  pointwise<32, (kMid + 31) / 32, 8>(
      s_dw1, kMid, c1, pw1_k, pw1_b, c2, [&](int p, int o, float v) {
        const int r = p / kMidCols;
        const bool inside = my0 + r < h && mx0 + (p - r * kMidCols) < w;
        s_mid[o * kMid + p] = inside ? v : 0.0f;
      });
  __syncthreads();

  // ---- ds2: dw2 at the kept positions, then pw2 to device memory
  depthwise(s_mid, kMid, kMidCols, s_dw2, kTileRows, kTileCols, 2, c2, dw2_k,
            dw2_b);
  __syncthreads();
  __nv_bfloat16* on = out + static_cast<long>(n) * ho * wo * c3;
  pointwise<8, kOut / 8, 4>(
      s_dw2, kOut, c2, pw2_k, pw2_b, c3, [&](int p, int o, float v) {
        const int oy = oy0 + p / kTileCols;
        const int ox = ox0 + p % kTileCols;
        if (oy < ho && ox < wo)
          on[(static_cast<long>(oy) * wo + ox) * c3 + o] =
              __float2bfloat16_rn(v);
      });
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at these widths, in bytes.
long ssd_fused_early_smem_bytes(int c1, int c2) {
  const long region = kIn * c1 > kOut * c2 ? kIn * c1 : kOut * c2;
  return (region + static_cast<long>(kMid) * (c1 + c2)) *
         static_cast<long>(sizeof(float));
}

// Largest dynamic shared memory one block may use on `device`, in bytes.
int ssd_fused_early_smem_limit(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Launches the kernel on `stream` of `device`. Returns cudaGetLastError()
// after the launch (0 on success). This library links its own CUDA
// runtime, whose current device is set here rather than inherited from
// PyTorch's.
int ssd_fused_early(const void* x, const void* dw1_k, const void* dw1_b,
                    const void* pw1_k, const void* pw1_b, const void* dw2_k,
                    const void* dw2_b, const void* pw2_k, const void* pw2_b,
                    void* out, int n, int h, int w, int c1, int c2, int c3,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(ssd_fused_early_smem_bytes(c1, c2));
  err = cudaFuncSetAttribute(fused_early_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((h / 2 + kTileRows - 1) / kTileRows) *
                    ((w / 2 + kTileCols - 1) / kTileCols);
  if (n > 0 && tiles > 0) {
    fused_early_kernel<<<dim3(tiles, n), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(dw1_k), static_cast<const float*>(dw1_b),
        static_cast<const float*>(pw1_k), static_cast<const float*>(pw1_b),
        static_cast<const float*>(dw2_k), static_cast<const float*>(dw2_b),
        static_cast<const float*>(pw2_k), static_cast<const float*>(pw2_b),
        static_cast<__nv_bfloat16*>(out), h, w, c1, c2, c3);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
