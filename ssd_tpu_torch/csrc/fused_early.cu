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
// W even, 16-byte aligned. Output (N, H/2, W/2, C3) bf16. Folded f32
// operands: dw1_k (C1, 3, 3), dw1_b (C1), pw1_k (C1, C2), pw1_b (C2),
// dw2_k (C2, 3, 3), dw2_b (C2), pw2_k (C2, C3), pw2_b (C3). C1, C2 and C3
// are multiples of 8. The function, with its rounding points
// (ops/fused_early.py says why each weight is two bf16 terms, not one):
//   x widened to f32;
//   dw1 3x3 s1 (SAME, 1 on every side) + bias, relu6, in f32; rounded to
//     bf16: pw1's A operand;
//   pw1: A times pw1_k as hi = bf16(k) plus lo = bf16(k - hi), exact
//     products, f32 sums, + bias, relu6; the result stays f32, and is zero
//     at ds1's padded row H and column W;
//   dw2 3x3 s2 (SAME on an even input: 0 before, 1 after) + bias, relu6, in
//     f32; rounded to bf16: pw2's A operand;
//   pw2: A times pw2_k as hi + lo, f32 sums, + bias, relu6; rounded to
//     bf16.
//
// What bounds it on this card: bytes. At x1.0, 640 px, batch 32
// ((32, 320, 320, 32) -> (32, 160, 160, 128)) it reads and writes 419 MB
// (0.125 ms at 3.35 TB/s); its 1.42 G depthwise multiply-adds take
// 0.042 ms at 67 TFLOP/s of f32 and its 13.4 G pointwise ones, two bf16
// products each, 0.054 ms at 989 TFLOP/s of bf16 on the tensor cores.
//
// The design (times on an H100 80GB HBM3 at 700 W, PERF.md):
// - Persistent blocks of 512 threads, as many as fit on the card at once
//   (one an SM at x1.0), each walking tiles of 8 x 8 ds2 output pixels of
//   one image in raster order, so the blocks in flight work on
//   neighbouring tiles and their input halos meet in L2. One block an SM
//   leaves each phase's latency to its own warps: 16 warps did the work in
//   0.90 ms where 8 took 1.03. Weights, biases and taps are staged into
//   shared memory once per block; the pointwise weights are split into
//   their two bf16 terms there, each as (C_out, K) rows (B "col" operands).
// - The next tile's input halo (19 x 19 pixels) is in flight by cp.async
//   (16 bytes, 8 channels a copy) while the current tile computes, in two
//   buffers. A pixel outside the image is a copy of 0 source bytes, which
//   fills zeros: SAME padding for free.
// - A tile recomputes the ds1 pixels it shares with its neighbours: 17 x 17
//   of them for 16 x 16 of its own (13% more; a 4 x 8 tile would be 20%).
// - Depthwise stages on the CUDA cores in f32: a thread owns a channel pair
//   (bf16x2 or float2 loads) and a run of outputs along one row (6 for
//   dw1: 816 runs fill 512 threads better than 544 runs of 9; 8 for dw2),
//   sliding its 3 x 3 window, so each value is read once into registers;
//   the taps are read as float2 from a (9, C) table. Each product and sum
//   is rounded on its own (__fmul_rn, __fadd_rn; -fmad=false), in the plain
//   version's (dy, dx) order, so the depthwise outputs equal the plain
//   version's. Their outputs are written to shared memory as bf16 in the
//   A-operand layout: (pixel, K) rows, K padded with zeros to a multiple
//   of 16.
// - Pointwise products on the tensor cores:
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, operands by ldmatrix.
//   pw1: M = the tile's 289 ds1 pixels (padded to 304), K = C1, N = C2;
//   pw2: M = its 64 ds2 pixels, K = C2, N = C3. A warp owns a 16 x 32 tile
//   of the product and adds A * hi and A * lo into one f32 sum. At K = 32
//   and 64 the tensor cores need about 0.05 ms whichever instruction issues
//   them, so wgmma's 64-row tiles and descriptors would buy little here.
//   Every A and B row is padded by 16 bytes: a row pitch of an odd number
//   of 16-byte units puts ldmatrix's 8 row addresses on 8 distinct bank
//   groups.
// - Epilogues in registers: pw1's bias and relu6, written as f32 rows of
//   `mid` (pitch C2 + 8 floats: a warp's float2 stores take the fewest
//   wavefronts); then, on a tile at the image's bottom or right edge only,
//   mid is zeroed from ds1's row H and column W on (masking every element
//   in the epilogue cost a quarter of pw1's time). pw2's bias, relu6 and
//   rounding, staged in shared memory over `mid` (read by dw2 before) and
//   stored as 16-byte vectors (a tile row's 8 pixels of C3 channels are
//   8 x 2 C3 contiguous bytes).
// - Work items are divided by multiply-high (Divisor), not by integer
//   division, which takes about 20 instructions.
// - Shared memory at C1 = 32, C2 = 64, C3 = 128: 210 KB (input 2 x 23 KB,
//   dw1 out 24 KB, mid and the output stage 83 KB, dw2 out 9 KB, weights
//   2 x 23 KB, taps and biases 5 KB). The attribute that admits it is set
//   once per device (ssd_fused_early_smem_limit), not per launch, so a
//   launch during CUDA-graph capture issues only the kernel.
// - What holds it now: the schedulers' use inside each barrier-separated
//   phase (dw1 and pw1 take about 4 700 and 4 100 of a tile's 15 600
//   cycles, at 40-50% issue), not bytes or the tensor cores.
//
// Exactness: the depthwise stages and every rounding equal the plain
// version's (ops/fused_early.py); the tensor cores add the same exact
// products in their own order, so the f32 pointwise sums may differ from
// the plain version's channel-order sums in the last bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;                       // ds2 outputs a tile side
constexpr int kOut = kTile * kTile;            // 64 ds2 pixels
constexpr int kMidSide = 2 * kTile + 1;        // 17 ds1 pixels a side
constexpr int kMid = kMidSide * kMidSide;      // 289
constexpr int kMidRows = (kMid + 15) / 16 * 16;  // 304: pw1's M
constexpr int kInSide = kMidSide + 2;          // 19 input pixels a side
constexpr int kIn = kInSide * kInSide;         // 361
constexpr int kRun = 6;                        // dw1 outputs a thread's run
constexpr int kRuns = (kMidSide + kRun - 1) / kRun;  // runs a ds1 row
constexpr int kCols = 32;                      // output channels a warp's tile
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr int larger(int a, int b) { return a > b ? a : b; }

// `n` bytes at offset `o`, which moves past them to the next 16 bytes.
__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += round_up(n, 16);
  return at;
}

// Shared-memory layout for widths (c1, c2, c3); offsets in bytes, each a
// multiple of 16.
struct Layout {
  int k1, k2;            // pw1's and pw2's K, padded to 16
  int a1_pitch, a2_pitch;  // bf16 elements a row of the A operands
  int b1_rows, b2_rows;  // B rows (output channels), padded to kCols
  int mid_pitch;         // f32 elements a row of mid
  int out_pitch;         // bf16 elements a row of the output stage
  int in, a1, mid, a2, b1, b1lo, b2, b2lo, k1tab, bias1, k2tab, bias2,
      pb1, pb2, bytes;

  __host__ __device__ Layout(int c1, int c2, int c3) {
    k1 = round_up(c1, 16);
    k2 = round_up(c2, 16);
    a1_pitch = k1 + 8;
    a2_pitch = k2 + 8;
    b1_rows = round_up(c2, kCols);
    b2_rows = round_up(c3, kCols);
    mid_pitch = c2 + 8;
    out_pitch = c3 + 8;
    int o = 0;
    in = take(o, 2 * kIn * c1 * 2);
    a1 = take(o, kMidRows * a1_pitch * 2);
    // the output stage lies over mid
    mid = take(o, larger(kMid * mid_pitch * 4, kOut * out_pitch * 2));
    a2 = take(o, kOut * a2_pitch * 2);
    b1 = take(o, b1_rows * a1_pitch * 2);
    b1lo = take(o, b1_rows * a1_pitch * 2);
    b2 = take(o, b2_rows * a2_pitch * 2);
    b2lo = take(o, b2_rows * a2_pitch * 2);
    k1tab = take(o, 9 * c1 * 4);
    bias1 = take(o, c1 * 4);
    k2tab = take(o, 9 * c2 * 4);
    bias2 = take(o, c2 * 4);
    pb1 = take(o, c2 * 4);
    pb2 = take(o, c3 * 4);
    bytes = o;
  }
};

// Division by a divisor fixed for the whole kernel, by a multiply: with m =
// ceil(2^32 / d), umulhi(n, m) = n / d for every n < 2^32 / d. Used for a
// tile's work items (fewer than 2^16, and divisors of at most the channel
// count, which shared memory bounds far below 2^16); the tile index is
// divided the usual way, once a tile. d = 1 (C1 = 8 gives one copy a
// pixel; C2 <= 32 one column group) has no 32-bit m and divides by
// itself.
struct Divisor {
  unsigned d, m;
  __device__ explicit Divisor(int divisor)
      : d(static_cast<unsigned>(divisor)),
        m(divisor > 1 ? 0xffffffffu / static_cast<unsigned>(divisor) + 1u
                      : 0u) {}
  // n / d and n % d
  __device__ __forceinline__ int div(int n) const {
    return d == 1u ? n
                   : static_cast<int>(__umulhi(static_cast<unsigned>(n), m));
  }
  __device__ __forceinline__ int mod(int n, int q) const {
    return n - q * static_cast<int>(d);
  }
};

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (dy, dx) order from the first product, each op rounded on its own.
__device__ __forceinline__ float2 tap9(const float2 (&v)[3][3],
                                       const float2 (&k)[9]) {
  float2 acc = make_float2(__fmul_rn(v[0][0].x, k[0].x),
                           __fmul_rn(v[0][0].y, k[0].y));
#pragma unroll
  for (int t = 1; t < 9; ++t) {
    const float2 s = v[t / 3][t % 3];
    acc.x = __fadd_rn(acc.x, __fmul_rn(s.x, k[t].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(s.y, k[t].y));
  }
  return acc;
}

__device__ __forceinline__ __nv_bfloat162 bias_relu6_bf16(float2 acc,
                                                         float2 b) {
  return __floats2bfloat162_rn(relu6(__fadd_rn(acc.x, b.x)),
                               relu6(__fadd_rn(acc.y, b.y)));
}

// One warp's 16 x kCols tile of a pointwise product: rows m0.., output
// channels n0.., summed over K (a multiple of 16) and over the weights'
// two terms. A is (rows, K) at pitch `ap`, B's hi and lo terms are
// (channels, K) at the same pitch, all bf16.
__device__ __forceinline__ void mma_tile(float (&acc)[kCols / 8][4],
                                         const __nv_bfloat16* a, int m0,
                                         const __nv_bfloat16* b,
                                         const __nv_bfloat16* b_lo, int n0,
                                         int k, int ap) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  const __nv_bfloat16* arow = a + (m0 + (lane & 15)) * ap + (lane >> 4) * 8;
  const int boff =
      (n0 + (lane & 7) + ((lane >> 4) << 3)) * ap + ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t af[4], bf[4];
    ldmatrix_x4(af, arow + k0);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int pair = 0; pair < kCols / 16; ++pair) {
        ldmatrix_x4(bf, (part ? b_lo : b) + boff + pair * 16 * ap + k0);
        mma_bf16(acc[2 * pair], af, bf[0], bf[1]);
        mma_bf16(acc[2 * pair + 1], af, bf[2], bf[3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_early_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dw1_k,
                   const float* __restrict__ dw1_b,
                   const float* __restrict__ pw1_k,
                   const float* __restrict__ pw1_b,
                   const float* __restrict__ dw2_k,
                   const float* __restrict__ dw2_b,
                   const float* __restrict__ pw2_k,
                   const float* __restrict__ pw2_b,
                   __nv_bfloat16* __restrict__ out, int n_img, int h, int w,
                   int c1, int c2, int c3) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(c1, c2, c3);
  // two input buffers, the second right after the first
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem + L.in);
  __nv_bfloat16* s_a1 = reinterpret_cast<__nv_bfloat16*>(smem + L.a1);
  float* s_mid = reinterpret_cast<float*>(smem + L.mid);
  __nv_bfloat16* s_a2 = reinterpret_cast<__nv_bfloat16*>(smem + L.a2);
  __nv_bfloat16* s_b1 = reinterpret_cast<__nv_bfloat16*>(smem + L.b1);
  __nv_bfloat16* s_b1lo = reinterpret_cast<__nv_bfloat16*>(smem + L.b1lo);
  __nv_bfloat16* s_b2 = reinterpret_cast<__nv_bfloat16*>(smem + L.b2);
  __nv_bfloat16* s_b2lo = reinterpret_cast<__nv_bfloat16*>(smem + L.b2lo);
  // the output stage, over mid: written by pw2 after dw2 has read mid
  __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(smem + L.mid);
  float* s_k1 = reinterpret_cast<float*>(smem + L.k1tab);   // (9, C1)
  float* s_bias1 = reinterpret_cast<float*>(smem + L.bias1);
  float* s_k2 = reinterpret_cast<float*>(smem + L.k2tab);   // (9, C2)
  float* s_bias2 = reinterpret_cast<float*>(smem + L.bias2);
  float* s_pb1 = reinterpret_cast<float*>(smem + L.pb1);
  float* s_pb2 = reinterpret_cast<float*>(smem + L.pb2);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ho = h / 2, wo = w / 2;
  const int tiles_x = (wo + kTile - 1) / kTile;
  const int tiles_img = tiles_x * ((ho + kTile - 1) / kTile);
  const int tiles = n_img * tiles_img;
  const int chunks = c1 / 8;  // 16-byte copies an input pixel
  const int c1p = c1 / 2, c2p = c2 / 2;   // channel pairs
  const int ng1 = L.b1_rows / kCols, ng2 = L.b2_rows / kCols;  // column groups
  const Divisor by_chunks(chunks), by_c1p(c1p), by_c2p(c2p), by_ng1(ng1),
      by_ng2(ng2), by_c3c(c3 / 8);

  // ---- the next tile's input halo, by cp.async; zeros outside the image
  auto load_tile = [&](int tile, __nv_bfloat16* dst) {
    const int n = tile / tiles_img;
    const int t = tile - n * tiles_img;
    const int iy0 = 2 * (t / tiles_x) * kTile - 1;  // ds1's first row - 1
    const int ix0 = 2 * (t % tiles_x) * kTile - 1;
    const __nv_bfloat16* xn = x + static_cast<long>(n) * h * w * c1;
    for (int i = tid; i < kIn * chunks; i += kThreads) {
      const int pix = by_chunks.div(i);
      const int ch = by_chunks.mod(i, pix);
      const int ry = pix / kInSide;
      const int gy = iy0 + ry;
      const int gx = ix0 + (pix - ry * kInSide);
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const __nv_bfloat16* src =
          inside ? xn + (static_cast<long>(gy) * w + gx) * c1 + ch * 8 : x;
      cp_async16(dst + pix * c1 + ch * 8, src, inside ? 16 : 0);
    }
  };

  const int first = blockIdx.x;
  if (first < tiles) load_tile(first, s_in);
  asm volatile("cp.async.commit_group;\n" ::);

  // ---- once per block: weights (two bf16 terms, (C_out, K) rows,
  // zero-padded), taps as (9, C) tables, biases; the A operands' padding
  // zeroed
  for (int i = tid; i < L.b1_rows * L.k1; i += kThreads) {
    const int o = i / L.k1, c = i - o * L.k1;
    const float v = (o < c2 && c < c1) ? __ldg(pw1_k + c * c2 + o) : 0.0f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    s_b1[o * L.a1_pitch + c] = hi;
    s_b1lo[o * L.a1_pitch + c] =
        __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  }
  for (int i = tid; i < L.b2_rows * L.k2; i += kThreads) {
    const int o = i / L.k2, c = i - o * L.k2;
    const float v = (o < c3 && c < c2) ? __ldg(pw2_k + c * c3 + o) : 0.0f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    s_b2[o * L.a2_pitch + c] = hi;
    s_b2lo[o * L.a2_pitch + c] =
        __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  }
  for (int i = tid; i < 9 * c1; i += kThreads) {
    const int t = i / c1, c = i - t * c1;
    s_k1[i] = __ldg(dw1_k + c * 9 + t);
  }
  for (int i = tid; i < 9 * c2; i += kThreads) {
    const int t = i / c2, c = i - t * c2;
    s_k2[i] = __ldg(dw2_k + c * 9 + t);
  }
  for (int i = tid; i < c1; i += kThreads) s_bias1[i] = __ldg(dw1_b + i);
  for (int i = tid; i < c2; i += kThreads) {
    s_bias2[i] = __ldg(dw2_b + i);
    s_pb1[i] = __ldg(pw1_b + i);
  }
  for (int i = tid; i < c3; i += kThreads) s_pb2[i] = __ldg(pw2_b + i);
  // A1: rows past kMid and channels past C1; A2: channels past C2
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = tid; i < kMidRows * L.a1_pitch; i += kThreads)
    s_a1[i] = zero;
  for (int i = tid; i < kOut * L.a2_pitch; i += kThreads) s_a2[i] = zero;

  int buf = 0;
  for (int tile = first; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles) load_tile(next, s_in + (buf ^ 1) * kIn * c1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    const int n = tile / tiles_img;
    const int t = tile - n * tiles_img;
    const int oy0 = (t / tiles_x) * kTile, ox0 = (t % tiles_x) * kTile;
    const int my0 = 2 * oy0, mx0 = 2 * ox0;  // the tile's first ds1 pixel

    // ---- dw1 over the 17 x 17 ds1 pixels -> A1 (bf16)
    {
      const __nv_bfloat16* in = s_in + buf * kIn * c1;
      for (int i = tid; i < c1p * kMidSide * kRuns; i += kThreads) {
        // rows fastest: at C1 = 32 a warp's two items are then a row
        // apart in the input (19 pixels, 16 banks), so its loads do not
        // conflict
        const int rest = by_c1p.div(i);
        const int cp = by_c1p.mod(i, rest);
        const int run = rest / kMidSide;
        const int r = rest - run * kMidSide;
        const int q0 = run * kRun;
        const int len = min(kRun, kMidSide - q0);
        float2 k[9];
#pragma unroll
        for (int tp = 0; tp < 9; ++tp)
          k[tp] = *reinterpret_cast<const float2*>(s_k1 + tp * c1 + 2 * cp);
        const float2 b = *reinterpret_cast<const float2*>(s_bias1 + 2 * cp);
        const __nv_bfloat16* src = in + (r * kInSide + q0) * c1 + 2 * cp;
        auto ld = [&](int dy, int col) {
          return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              src + (dy * kInSide + col) * c1));
        };
        float2 v[3][3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          v[dy][0] = ld(dy, 0);
          v[dy][1] = ld(dy, 1);
        }
        __nv_bfloat16* dst = s_a1 + (r * kMidSide + q0) * L.a1_pitch + 2 * cp;
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          if (q < len) {
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) v[dy][2] = ld(dy, q + 2);
            *reinterpret_cast<__nv_bfloat162*>(dst + q * L.a1_pitch) =
                bias_relu6_bf16(tap9(v, k), b);
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              v[dy][0] = v[dy][1];
              v[dy][1] = v[dy][2];
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- pw1 on the tensor cores -> mid (f32)
    for (int u = warp; u < (kMidRows / 16) * ng1; u += kWarps) {
      const int mt = by_ng1.div(u), ng = by_ng1.mod(u, mt);
      float acc[kCols / 8][4];
      mma_tile(acc, s_a1, mt * 16, s_b1, s_b1lo, ng * kCols, L.k1, L.a1_pitch);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int o = ng * kCols + j * 8 + 2 * (lane & 3);
        if (o >= c2) continue;
        const float2 b = *reinterpret_cast<const float2*>(s_pb1 + o);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = mt * 16 + (lane >> 2) + 8 * hh;
          if (p < kMid)
            *reinterpret_cast<float2*>(s_mid + p * L.mid_pitch + o) =
                make_float2(relu6(__fadd_rn(acc[j][2 * hh], b.x)),
                            relu6(__fadd_rn(acc[j][2 * hh + 1], b.y)));
        }
      }
    }
    __syncthreads();
    // a tile at the bottom or right edge: mid is zero from ds1's row H and
    // column W on (dw2's SAME padding)
    if (my0 + kMidSide > h || mx0 + kMidSide > w) {
      const int rows_in = h - my0, cols_in = w - mx0;
      for (int i = tid; i < kMid * c2p; i += kThreads) {
        const int p = by_c2p.div(i);
        const int cp = by_c2p.mod(i, p);
        const int r = p / kMidSide;
        if (r >= rows_in || p - r * kMidSide >= cols_in)
          *reinterpret_cast<float2*>(s_mid + p * L.mid_pitch + 2 * cp) =
              make_float2(0.0f, 0.0f);
      }
      __syncthreads();
    }

    // ---- dw2 at the 8 x 8 kept positions -> A2 (bf16)
    for (int i = tid; i < c2p * kTile; i += kThreads) {
      const int a = by_c2p.div(i);  // the output row
      const int cp = by_c2p.mod(i, a);
      float2 k[9];
#pragma unroll
      for (int tp = 0; tp < 9; ++tp)
        k[tp] = *reinterpret_cast<const float2*>(s_k2 + tp * c2 + 2 * cp);
      const float2 b = *reinterpret_cast<const float2*>(s_bias2 + 2 * cp);
      const float* src = s_mid + 2 * a * kMidSide * L.mid_pitch + 2 * cp;
      auto ld = [&](int dy, int col) {
        return *reinterpret_cast<const float2*>(
            src + (dy * kMidSide + col) * L.mid_pitch);
      };
      float2 v[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) v[dy][2] = ld(dy, 0);
      __nv_bfloat16* dst = s_a2 + a * kTile * L.a2_pitch + 2 * cp;
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          v[dy][0] = v[dy][2];
          v[dy][1] = ld(dy, 2 * q + 1);
          v[dy][2] = ld(dy, 2 * q + 2);
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + q * L.a2_pitch) =
            bias_relu6_bf16(tap9(v, k), b);
      }
    }
    __syncthreads();

    // ---- pw2 on the tensor cores -> the output stage (bf16)
    for (int u = warp; u < (kOut / 16) * ng2; u += kWarps) {
      const int mt = by_ng2.div(u), ng = by_ng2.mod(u, mt);
      float acc[kCols / 8][4];
      mma_tile(acc, s_a2, mt * 16, s_b2, s_b2lo, ng * kCols, L.k2, L.a2_pitch);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int o = ng * kCols + j * 8 + 2 * (lane & 3);
        if (o >= c3) continue;
        const float2 b = *reinterpret_cast<const float2*>(s_pb2 + o);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = mt * 16 + (lane >> 2) + 8 * hh;
          *reinterpret_cast<__nv_bfloat162*>(s_out + p * L.out_pitch + o) =
              bias_relu6_bf16(make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]),
                              b);
        }
      }
    }
    __syncthreads();

    // ---- the tile to device memory, 16 bytes a thread
    {
      const int c3c = c3 / 8;
      __nv_bfloat16* on = out + static_cast<long>(n) * ho * wo * c3;
      for (int i = tid; i < kOut * c3c; i += kThreads) {
        const int p = by_c3c.div(i);
        const int ch = by_c3c.mod(i, p);
        const int oy = oy0 + p / kTile, ox = ox0 + p % kTile;
        if (oy < ho && ox < wo)
          *reinterpret_cast<uint4*>(on + (static_cast<long>(oy) * wo + ox) *
                                             c3 + ch * 8) =
              *reinterpret_cast<const uint4*>(s_out + p * L.out_pitch +
                                              ch * 8);
      }
    }
    // the next iteration's first barrier orders these reads of s_out (mid),
    // and this tile's reads of its input buffer, before they are written
    // again
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Per device: SMs (set with the limit), and blocks an SM at the last
// launch's shared memory.
int g_sm_count[kMaxDevices];
int g_per_sm_smem[kMaxDevices];
int g_per_sm[kMaxDevices];

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at these widths, in bytes.
long ssd_fused_early_smem_bytes(int c1, int c2, int c3) {
  return Layout(c1, c2, c3).bytes;
}

// Largest dynamic shared memory one block may use on `device`, in bytes.
// Also admits that much for the kernel on `device`, once: the launch does
// not set the attribute again.
int ssd_fused_early_smem_limit(int device, int* bytes) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&g_sm_count[device],
                               cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      fused_early_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      *bytes));
}

// Launches the kernel on `stream` of `device`, whose limit must have been
// asked for first (ssd_fused_early_smem_limit). Returns cudaGetLastError()
// after the launch (0 on success). This library links its own CUDA
// runtime, whose current device is set here rather than inherited from
// PyTorch's.
int ssd_fused_early(const void* x, const void* dw1_k, const void* dw1_b,
                    const void* pw1_k, const void* pw1_b, const void* dw2_k,
                    const void* dw2_b, const void* pw2_k, const void* pw2_b,
                    void* out, int n, int h, int w, int c1, int c2, int c3,
                    int device, void* stream) {
  if (device < 0 || device >= kMaxDevices || g_sm_count[device] == 0)
    return static_cast<int>(cudaErrorInitializationError);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = Layout(c1, c2, c3).bytes;
  if (g_per_sm_smem[device] != smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_early_kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    g_per_sm[device] = per_sm;
    g_per_sm_smem[device] = smem;
  }
  const long resident = static_cast<long>(g_per_sm[device]) *
                        g_sm_count[device];
  const long tiles = static_cast<long>(n) * ((h / 2 + kTile - 1) / kTile) *
                     ((w / 2 + kTile - 1) / kTile);
  const long blocks = tiles < resident ? tiles : resident;
  if (blocks > 0) {
    fused_early_kernel<<<static_cast<int>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(dw1_k), static_cast<const float*>(dw1_b),
        static_cast<const float*>(pw1_k), static_cast<const float*>(pw1_b),
        static_cast<const float*>(dw2_k), static_cast<const float*>(dw2_b),
        static_cast<const float*>(pw2_k), static_cast<const float*>(pw2_b),
        static_cast<__nv_bfloat16*>(out), n, h, w, c1, c2, c3);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
