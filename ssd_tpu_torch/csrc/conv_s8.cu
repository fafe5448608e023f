// K4: the int8 dense SAME conv, s8 x s8 -> s32 on the tensor cores, as one
// implicit GEMM for Hopper (sm_90a), with the activation quantize in its
// loads and the dequantize and bias in its epilogue.
//
// Replaces no TPU kernel: the JAX package leaves its int8 convs to XLA's
// lax.conv (ssd_tpu/models/layers.py _quantized_conv). It replaces the
// port's eager composition (models/layers.py: quantize_activation, im2col,
// int_mm, dequantize: about 25 launches a conv, im2col's s8 copy 9x the
// input at 3x3, the s32 product gone through four times in f32), which
// stays as the plain version and runs on the CPU.
//
// The function. Input x, an NCHW view with any strides, either bf16 (then
// x_q = clip(rint(__fdiv_rn(f32(x), a)), -127, 127) with a =
// fmaxf(*scale, 1e-8), or __fmul_rn(f32(x), *recip) for the static
// scale) or s8 (taken as it is). Weights k_q prepared once per weight
// version into the layout below. Padding explicit (top, left; everything
// outside the rows and columns of x reads 0), output height and width
// given, so a height strip passes its halo'd rows with the whole map's
// padding. Output (N, Ho, Wo, O) contiguous: bf16
// __float2bfloat16_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc),
// __fmul_rn(a, k_scale[o])), bias[o])) (no add without bias), or the raw
// s32 sums when k_scale is null. Integer sums are exact in any order and
// every f32 op is the plain version's, so the output equals it bit for bit.
//
// Prepared weights: (O_pad, J, KB * 64) s8, K-major. The input channels
// are cut into J chunks of CK bytes (CK = 16, 32 or 64: the least that
// holds C, up to 64); within chunk j, byte t * CK + cc holds k_q[o, j * CK
// + cc, dy, dx] for tap t = dy * kw + dx; zero past C, past the taps
// (rounded up to KB K-blocks of 64 bytes) and past O (rounded up to the
// tile width BN). ops/conv_s8_cuda.py packs and unpacks it.
//
// What bounds it on this card: at the flagship's b32 head shapes (P3:
// M = 204 800, K = 2 304, N = 256 and 720) the products, 0.12 and 0.34 ms
// at 1 979 TOP/s; at the pointwise and stem shapes the bytes (input read
// once, weights, bf16 output written once) at 3.35 TB/s. PERF.md gives each
// shape's time beside its bound.
//
// The design (of the two routes for int8 on Hopper, this is the cp.async
// ring with ldmatrix + mma.sync.m16n8k32 s8; wgmma would need each tap's A
// rows as one canonical strided tile, which the tap-shifted reads of one
// shared patch below are not):
// - A block computes an output tile of 128 pixels (TH x TW, TW a power of
//   two from 8 to 128) times BN output channels (BN = 32, 64 or 128 by O),
//   256 threads, 8 warps, each a (128 / WARPS_M) x (BN / WARPS_N) tile of
//   m16n8k32 products with s32 sums in registers; two blocks an SM (three
//   at BN = 32, whose blocks are short: the stem's).
// - No im2col: for each channel chunk the block builds, in shared memory,
//   the s8 input patch its tile reads, ((TH - 1) * s + kh) x ((TW - 1) * s
//   + kw) pixels of CK bytes, zeros outside the map and past C. Every tap's
//   A rows come from that one patch: ldmatrix takes a row address a lane,
//   so a row is its output pixel's patch pixel plus the tap's offset (a
//   table of each 16-byte piece's offset). Each input element is quantized
//   once a patch (about 1.4x at 3x3 stride 1, not 9x). A pixel takes CK
//   bytes padded to an odd number of 16-byte units, so an ldmatrix's 8
//   rows fall on 8 bank groups.
// - Where the channels are contiguous and 16-byte aligned, the next
//   chunk's raw patch is staged by cp.async while this chunk's products
//   run, and quantized (bf16: x * RN(1/a), exact as the comment on
//   Quantizer says) into the next patch region by slices between the last
//   K-blocks' products; elsewhere (3 channels, NCHW memory) it is read and
//   quantized element by element.
// - The GEMM's K runs chunk by chunk, tap-major inside a chunk, in K-blocks
//   of 64 bytes; the weights' K-blocks stream through a 3-stage cp.async
//   ring (rows of 80 bytes, odd 16-byte units again).
// - With several N-tiles and output tiles enough to fill two blocks an SM,
//   a block keeps every chunk's patch and runs every N-tile in turn
//   ("resident"): the patch is made once for all output channels (720 at
//   the class head: six N-tiles). Elsewhere each block runs one N-tile and
//   two patch regions alternate.
// - Tile shapes follow the observable shape (one algorithm, other
//   parameters; ops/conv_s8_cuda.plan): BN by O (36 -> 64, 720 -> 128 x 6);
//   TH x TW the least padded tiling of Ho x Wo whose patch fits; a 1x1
//   stride-1 conv is one row of N * H * W pixels where the strides allow,
//   tiled 1 x 128.
// - Epilogue in registers: the dequantize scale a * k_scale[o] and the bias
//   per column, one bf16 rounding, pairs of channels stored at once.
// - What holds it (PERF.md): on the P3 head the products' loop alone, with
//   no load and no quantize, takes about 60% of the whole kernel's time,
//   the patch's loads and quantize most of the rest. Tried and dropped,
//   each timed in turns with this one: a warp-specialized version
//   (products, weights and patch in their own warps, named barriers), 1.4x
//   to 3x slower; four warps a block of 64 x 64 tiles, 5-35% slower but on
//   the stem and the first pointwise conv; 128-byte K-blocks, more weight
//   stages, a deeper staging ring and 16-byte output stores, no gain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 128;         // output pixels a block
constexpr int kBK = 64;          // bytes of K a weight stage
constexpr int kStages = 3;       // weight stages in flight
constexpr int kBPitch = kBK + 16;  // bytes a weight row in shared memory
constexpr int kMaxPieces = 256;  // 16-byte pieces of a chunk's K (<= 196)
constexpr int kMaxDevices = 64;
constexpr int kTwoBlocks = 113 * 1024;  // shared memory for two blocks an SM
constexpr float kFloor = 1e-8f;  // the scales' floor (layers.SCALE_FLOOR)
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: v + kMagic rounds v

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Bytes a patch pixel takes in shared memory: its chunk, padded to an odd
// number of 16-byte units, so that 8 consecutive pixels (an ldmatrix's
// rows) fall on 8 distinct bank groups.
__host__ __device__ constexpr int pixel_pitch(int ck) {
  return ck >= 32 ? ck + 16 : ck;
}

struct ConvArgs {
  const void* x;              // bf16 or s8, NCHW view
  long long sn, sc, sh, sw;   // its strides in elements
  int c, h, w;                // its channels, rows, columns
  const int8_t* wq;           // prepared weights (O_pad, J * KB * 64)
  long long w_pitch;          // bytes a prepared weight row
  int o;                      // output channels
  int kh, kw, stride, pad_top, pad_left, ho, wo;
  int ck, chunks, kblocks;    // CK bytes a chunk, J chunks, KB K-blocks
  int th, tw_log2, ph, pw;    // the tile (TH x 2^tw_log2) and its patch
  int tiles_x, tiles_img, ntiles_n;
  int vec;       // channels contiguous and 16-byte aligned: 16-byte copies
  int stage;     // the next chunk's patch staged raw by cp.async
  int resident;  // every chunk's patch kept: one block, every N-tile
  const float* scale;         // 0-dim activation scale, floored here
  const float* recip;         // 0-dim reciprocal of the static scale, or null
  const float* k_scale;       // (O) f32, or null: raw s32 output
  const float* bias;          // (O) f32, or null
  void* out;                  // (N, Ho, Wo, O) bf16 or s32
};

// Shared memory: the s8 patch regions (every chunk's when resident, else
// two: chunk j's and chunk j + 1's), the raw staging (when staged), the
// weight ring, the piece table; offsets multiples of 16.
struct Smem {
  int region, staging, ring, pieces, bytes;
  __host__ __device__ Smem(int ph, int pw, int ck, int esize, int bn,
                           bool stage, int regions) {
    region = round_up(ph * pw * pixel_pitch(ck), 16);
    staging = regions * region;
    ring = staging + (stage ? round_up(ph * pw * ck * esize, 16) : 0);
    pieces = ring + kStages * bn * kBPitch;
    bytes = pieces + kMaxPieces * 4;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes by cp.async; `src_bytes` of them read, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
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

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The activation quantize of one value, as layers.quantize_activation:
// round half to even of x / a (or x * recip), clipped to [-127, 127] (the
// clip and the rounding commute: the bounds are integers). Rounding adds
// 1.5 * 2^23, whose sum's low byte is then the integer as s8. For x / a:
// below 256, q = RN(x * RN(1/a)) lies within 2^-15 of RN(x / a), and the
// clip moves neither further, so both round to the same integer unless the
// clipped q lies within 2^-13 of a half; there (about one value in 4 000)
// the quotient is __fdiv_rn's. Past 256 both clip to the same bound.
struct Quantizer {
  float a, r, recip;
  bool mul;
  template <bool kMul>
  __device__ __forceinline__ uint32_t one(float v) const {
    const float q =
        fminf(fmaxf(__fmul_rn(v, kMul ? recip : r), -127.0f), 127.0f);
    float m = __fadd_rn(q, kMagic);
    if (!kMul) {
      const float d = fabsf(__fsub_rn(q, __fsub_rn(m, kMagic)));
      if (fabsf(__fsub_rn(d, 0.5f)) < 0x1p-13f)
        m = __fadd_rn(fminf(fmaxf(__fdiv_rn(v, a), -127.0f), 127.0f),
                      kMagic);
    }
    return __float_as_uint(m);
  }
  __device__ __forceinline__ uint32_t operator()(float v) const {
    return mul ? one<true>(v) : one<false>(v);
  }
  // 8 bf16 values (16 bytes) -> 8 s8
  template <bool kMul>
  __device__ __forceinline__ uint2 eight(const uint4& v) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[2 * i] = one<kMul>(__uint_as_float(w[i] << 16));
      b[2 * i + 1] = one<kMul>(__uint_as_float(w[i] & 0xffff0000u));
    }
    return make_uint2(
        __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                    __byte_perm(b[2], b[3], 0x0040), 0x5410),
        __byte_perm(__byte_perm(b[4], b[5], 0x0040),
                    __byte_perm(b[6], b[7], 0x0040), 0x5410));
  }
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename In, int kBN, int kWarpsM>
__global__ void __launch_bounds__(kThreads, kBN == 32 ? 3 : 2)
conv_s8_kernel(const ConvArgs p) {
  constexpr int kWarpsN = kWarps / kWarpsM;
  constexpr int kMF = kBM / (16 * kWarpsM);  // m16 fragments a warp
  constexpr int kNF = kBN / (8 * kWarpsN);   // n8 fragments a warp
  constexpr bool kS8 = sizeof(In) == 1;
  static_assert(kMF >= 1 && kNF % 2 == 0, "warp tile");

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(p.ph, p.pw, p.ck, sizeof(In), kBN, p.stage != 0,
               p.resident ? p.chunks : 2);
  const int patch_px = p.ph * p.pw;
  const int pitch = pixel_pitch(p.ck);
  unsigned char* s_stage = smem + L.staging;
  unsigned char* s_b = smem + L.ring;
  int* s_piece = reinterpret_cast<int*>(smem + L.pieces);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nt_first = p.resident ? 0 : blockIdx.x % p.ntiles_n;
  const int nt_count = p.resident ? p.ntiles_n : 1;
  const int mt = p.resident ? blockIdx.x : blockIdx.x / p.ntiles_n;
  const int img = mt / p.tiles_img;
  const int t_img = mt - img * p.tiles_img;
  const int tw = 1 << p.tw_log2;
  const int oy0 = (t_img / p.tiles_x) * p.th;
  const int ox0 = (t_img % p.tiles_x) * tw;
  const int iy0 = oy0 * p.stride - p.pad_top;
  const int ix0 = ox0 * p.stride - p.pad_left;

  // 16-byte units a chunk (1, 2 or 4); piece q of a chunk's tap-major K is
  // unit q & (nu - 1) of tap q >> nu_log2, at s_piece[q] bytes from a
  // row's tap-0 pixel (0 past the taps: the weights are zero there)
  const int nu = p.ck >> 4;
  const int nu_log2 = nu == 4 ? 2 : (nu == 2 ? 1 : 0);
  const int ck_log2 = 4 + nu_log2;
  const int taps = p.kh * p.kw;
  for (int q = tid; q < kMaxPieces; q += kThreads) {
    const int t = q >> nu_log2;
    s_piece[q] = t < taps ? ((t / p.kw) * p.pw + t % p.kw) * pitch +
                                (q & (nu - 1)) * 16
                          : 0;
  }

  Quantizer quant;
  quant.a = p.scale != nullptr ? fmaxf(__ldg(p.scale), kFloor) : 1.0f;
  quant.r = __frcp_rn(quant.a);
  quant.mul = p.recip != nullptr;
  quant.recip = p.recip != nullptr ? __ldg(p.recip) : 0.5f;

  const In* x = static_cast<const In*>(p.x) + img * p.sn;

  // the input element of patch pixel px, channel c, or null outside
  auto source = [&](int px, int c) -> const In* {
    const int py = px / p.pw;
    const int iy = iy0 + py, ix = ix0 + px - py * p.pw;
    if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w || c >= p.c)
      return nullptr;
    return x + iy * p.sh + ix * p.sw + c * p.sc;
  };

  // ---- chunk j's raw patch into s_stage by cp.async (16-byte units of
  // contiguous channels; zeros outside the map and past C)
  constexpr int kPerUnit = 16 / sizeof(In);  // channels a 16-byte unit
  const int su_log2 = ck_log2 - (kS8 ? 4 : 3);  // staged units a pixel
  const int staged_units = patch_px << su_log2;
  auto stage_patch = [&](int j) {
    for (int i = tid; i < staged_units; i += kThreads) {
      const int px = i >> su_log2;
      const int c = j * p.ck + (i & ((1 << su_log2) - 1)) * kPerUnit;
      const In* src = source(px, c);
      const int bytes =
          src == nullptr ? 0 : min(p.c - c, kPerUnit) * int(sizeof(In));
      cp_async16(s_stage + (i << 4), src == nullptr ? x : src, bytes);
    }
  };
  // ---- staged units [lo, hi) quantized into the patch region dst (the
  // scale's kind chosen once, outside the loop)
  auto quantize_units = [&](auto mul, unsigned char* dst, int lo, int hi) {
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int px = i >> su_log2;
      const uint4 v = *reinterpret_cast<const uint4*>(s_stage + (i << 4));
      if (kS8) {
        *reinterpret_cast<uint4*>(
            dst + px * pitch + ((i & ((1 << su_log2) - 1)) << 4)) = v;
      } else {
        *reinterpret_cast<uint2*>(
            dst + px * pitch + ((i & ((1 << su_log2) - 1)) << 3)) =
            quant.template eight<decltype(mul)::value>(v);
      }
    }
  };
  auto quantize_stage = [&](unsigned char* dst, int lo, int hi) {
    if (quant.mul)
      quantize_units(std::true_type(), dst, lo, hi);
    else
      quantize_units(std::false_type(), dst, lo, hi);
  };
  // ---- chunk j's patch read and quantized directly, 16 channels an item
  // (channels strided or not 16-byte aligned)
  auto load_patch = [&](unsigned char* dst, int j) {
    const int total = patch_px << nu_log2;
    for (int i = tid; i < total; i += kThreads) {
      const int px = i >> nu_log2, u = i & (nu - 1);
      const int c0 = j * p.ck + u * 16;
      const In* src = source(px, c0);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (src != nullptr) {
        const int n = min(p.c - c0, 16);
        for (int cc = 0; cc < n; ++cc) {
          const float v = to_float(src[cc * p.sc]);
          const uint32_t b = kS8 ? static_cast<uint32_t>(static_cast<int>(v))
                                 : quant(v);
          w[cc >> 2] |= (b & 0xffu) << ((cc & 3) * 8);
        }
      }
      *reinterpret_cast<uint4*>(dst + px * pitch + u * 16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  };

  // ---- weight K-block g (of this block's N-tiles in turn) into its stage
  const int per_nt = p.chunks * p.kblocks;
  const int total_kb = nt_count * per_nt;
  auto load_b = [&](int g) {
    if (g < total_kb) {
      const int nti = g / per_nt;
      const int8_t* src =
          p.wq + static_cast<long long>((nt_first + nti) * kBN) * p.w_pitch +
          static_cast<long long>(g - nti * per_nt) * kBK;
      unsigned char* dst = s_b + (g % kStages) * kBN * kBPitch;
      for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
        const int row = i >> 2, piece = i & 3;
        cp_async16(dst + row * kBPitch + piece * 16,
                   src + row * p.w_pitch + piece * 16);
      }
    }
  };
  auto commit = []() { asm volatile("cp.async.commit_group;\n" ::); };

  // each lane's A row of each m16 fragment: its tap-0 pixel's byte offset
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  int a_off[kMF];
#pragma unroll
  for (int f = 0; f < kMF; ++f) {
    const int r = warp_m * kMF * 16 + f * 16 + (lane & 15);
    a_off[f] = ((r >> p.tw_log2) * p.stride * p.pw +
                (r & (tw - 1)) * p.stride) * pitch;
  }
  const int half = lane >> 4;  // lanes 16-31 address the k32's upper 16 bytes
  const int b_off = (warp_n * kNF * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                        kBPitch + ((lane >> 3) & 1) * 16;

  int acc[kMF][kNF][4];
#pragma unroll
  for (int f = 0; f < kMF; ++f)
#pragma unroll
    for (int g = 0; g < kNF; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][g][i] = 0;

  const bool raw = p.k_scale == nullptr;
  const bool pairs = (p.o & 1) == 0;

  // Commit group g holds weight K-block g; chunk j + 1's staging joins the
  // group of chunk j's first K-block + kStages - 1 (chunk 0's, group 0), so
  // it has arrived once K-block j * KB + kStages - 1 was waited for. Chunk
  // j's products read its patch region; from K-block kq0 on, each thread
  // quantizes a slice of chunk j + 1's staging into the next region
  // between its products. Where a chunk has no K-block past kq0, all is
  // waited for and the staging quantized at the chunk's end. Without
  // staging, chunk j's patch is read directly into its region (not
  // resident: region j & 1, last read in chunk j - 2). The patch is made
  // while the block's first N-tile runs; a resident patch then serves its
  // other N-tiles as it is.
  const int kq0 = max(kStages - 1, p.kblocks / 3);
  const int slices = p.kblocks - kq0;
  auto region = [&](int j) {
    return smem + (p.resident ? j : (j & 1)) * L.region;
  };
  if (p.stage) stage_patch(0);
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    load_b(g);
    commit();
  }
  if (p.stage) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // chunk 0's staging arrived
    quantize_stage(region(0), 0, staged_units);
  }
  int g = 0;
  for (int nti = 0; nti < nt_count; ++nti) {
    const bool making = nti == 0;
    for (int j = 0; j < p.chunks; ++j) {
      const unsigned char* patch = region(j);
      const bool more = making && j + 1 < p.chunks;
      if (making && !p.stage) load_patch(region(j), j);
      for (int kk = 0; kk < p.kblocks; ++kk, ++g) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
        __syncthreads();  // stage g and the patch visible; stage g - 1 free
        load_b(g + kStages - 1);
        if (kk == 0 && p.stage && more) stage_patch(j + 1);
        commit();
        if (p.stage && more && kk >= kq0) {
          const int sl = kk - kq0;
          quantize_stage(region(j + 1), staged_units * sl / slices,
                         staged_units * (sl + 1) / slices);
        }
        const unsigned char* sb = s_b + (g % kStages) * kBN * kBPitch;
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {
          // this lane's 16-byte piece of the chunk's tap-major K
          const unsigned char* pa =
              patch + s_piece[kk * (kBK / 16) + ks * 2 + half];
          uint32_t af[kMF][4];
          uint32_t bf[kNF / 2][4];
#pragma unroll
          for (int f = 0; f < kMF; ++f) ldmatrix_x4(af[f], pa + a_off[f]);
#pragma unroll
          for (int pr = 0; pr < kNF / 2; ++pr)
            ldmatrix_x4(bf[pr], sb + b_off + pr * 16 * kBPitch + ks * 32);
#pragma unroll
          for (int f = 0; f < kMF; ++f)
#pragma unroll
            for (int g2 = 0; g2 < kNF; ++g2)
              mma_s8(acc[f][g2], af[f], bf[g2 >> 1][(g2 & 1) * 2],
                     bf[g2 >> 1][(g2 & 1) * 2 + 1]);
        }
      }
      if (p.stage && more && slices <= 0) {
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();  // chunk j + 1's staging arrived
        quantize_stage(region(j + 1), 0, staged_units);
      }
    }

    // ---- epilogue of N-tile nti: raw s32, or dequantize + bias + one
    // bf16 rounding; the sums then start again for the next N-tile
    const int n0 = (nt_first + nti) * kBN;
    float dq[kNF][2], bs[kNF][2];
#pragma unroll
    for (int gg = 0; gg < kNF; ++gg)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + warp_n * kNF * 8 + gg * 8 + 2 * (lane & 3) + e;
        dq[gg][e] = (!raw && col < p.o)
                        ? __fmul_rn(quant.a, __ldg(p.k_scale + col))
                        : 0.0f;
        bs[gg][e] =
            (p.bias != nullptr && col < p.o) ? __ldg(p.bias + col) : 0.0f;
      }
#pragma unroll
    for (int f = 0; f < kMF; ++f)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp_m * kMF * 16 + f * 16 + (lane >> 2) + 8 * hh;
        const int oy = oy0 + (r >> p.tw_log2), ox = ox0 + (r & (tw - 1));
        if (oy >= p.ho || ox >= p.wo) continue;
        const long long base =
            ((static_cast<long long>(img) * p.ho + oy) * p.wo + ox) * p.o;
#pragma unroll
        for (int gg = 0; gg < kNF; ++gg) {
          const int col = n0 + warp_n * kNF * 8 + gg * 8 + 2 * (lane & 3);
          if (col >= p.o) continue;
          const int v0 = acc[f][gg][2 * hh], v1 = acc[f][gg][2 * hh + 1];
          if (raw) {
            int* o = static_cast<int*>(p.out) + base + col;
            if (pairs) {
              *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
            } else {
              o[0] = v0;
              if (col + 1 < p.o) o[1] = v1;
            }
          } else {
            float y0 = __fmul_rn(__int2float_rn(v0), dq[gg][0]);
            float y1 = __fmul_rn(__int2float_rn(v1), dq[gg][1]);
            if (p.bias != nullptr) {
              y0 = __fadd_rn(y0, bs[gg][0]);
              y1 = __fadd_rn(y1, bs[gg][1]);
            }
            __nv_bfloat16* o =
                static_cast<__nv_bfloat16*>(p.out) + base + col;
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __halves2bfloat162(__float2bfloat16_rn(y0),
                                     __float2bfloat16_rn(y1));
            } else {
              o[0] = __float2bfloat16_rn(y0);
              if (col + 1 < p.o) o[1] = __float2bfloat16_rn(y1);
            }
          }
        }
      }
#pragma unroll
    for (int f = 0; f < kMF; ++f)
#pragma unroll
      for (int gg = 0; gg < kNF; ++gg)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][gg][i] = 0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

using KernelFn = void (*)(const ConvArgs);

// The instantiations: input type by `s8`, tile width by `bn`.
KernelFn kernel_for(bool s8, int bn) {
  if (s8) {
    if (bn == 32) return conv_s8_kernel<int8_t, 32, 4>;
    if (bn == 64) return conv_s8_kernel<int8_t, 64, 4>;
    if (bn == 128) return conv_s8_kernel<int8_t, 128, 2>;
  } else {
    if (bn == 32) return conv_s8_kernel<__nv_bfloat16, 32, 4>;
    if (bn == 64) return conv_s8_kernel<__nv_bfloat16, 64, 4>;
    if (bn == 128) return conv_s8_kernel<__nv_bfloat16, 128, 2>;
  }
  return nullptr;
}

int g_smem_limit[kMaxDevices];
int g_sm_count[kMaxDevices];

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at least for a patch of ph x pw
// pixels of ck bytes and a tile of bn output channels (without staging),
// in bytes.
int ssd_conv_s8_smem_bytes(int ph, int pw, int ck, int bn) {
  return Smem(ph, pw, ck, 1, bn, false, 2).bytes;
}

// Largest dynamic shared memory one block may use on `device`, in bytes.
// Also admits that much for every instantiation on `device`, once: the
// launch does not set the attribute again.
int ssd_conv_s8_smem_limit(int device, int* bytes) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int s8 = 0; s8 < 2; ++s8)
    for (int bn = 32; bn <= 128; bn *= 2) {
      err = cudaFuncSetAttribute(kernel_for(s8 != 0, bn),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 *bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  err = cudaDeviceGetAttribute(&g_sm_count[device],
                               cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  g_smem_limit[device] = *bytes;
  return 0;
}

// Launches K4 on `stream` of `device`, whose limit must have been asked for
// first (ssd_conv_s8_smem_limit). `x` is s8 when `s8` is set, else bf16;
// `k_scale` null asks for the raw s32 output; `recip` null divides by the
// floored scale. Returns cudaGetLastError() after the launch (0 on
// success; nothing is launched for an empty output). This library links
// its own CUDA runtime, whose current device is set here.
int ssd_conv_s8(const void* x, int s8, long long sn, long long sc,
                long long sh, long long sw, int n, int c, int h, int w,
                const void* wq, long long w_pitch, int o, int bn, int kh,
                int kw, int stride, int pad_top, int pad_left, int ho, int wo,
                int ck, int chunks, int kblocks, int th, int tw_log2, int vec,
                const void* scale, const void* recip, const void* k_scale,
                const void* bias, void* out, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices || g_smem_limit[device] == 0)
    return static_cast<int>(cudaErrorInitializationError);
  KernelFn fn = kernel_for(s8 != 0, bn);
  if (fn == nullptr || (1 << tw_log2) * th != kBM ||
      kblocks * (kBK / 16) > kMaxPieces)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ConvArgs p;
  p.x = x;
  p.sn = sn;
  p.sc = sc;
  p.sh = sh;
  p.sw = sw;
  p.c = c;
  p.h = h;
  p.w = w;
  p.wq = static_cast<const int8_t*>(wq);
  p.w_pitch = w_pitch;
  p.o = o;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.ho = ho;
  p.wo = wo;
  p.ck = ck;
  p.chunks = chunks;
  p.kblocks = kblocks;
  p.th = th;
  p.tw_log2 = tw_log2;
  p.ph = (th - 1) * stride + kh;
  p.pw = ((1 << tw_log2) - 1) * stride + kw;
  p.tiles_x = (wo + (1 << tw_log2) - 1) >> tw_log2;
  p.tiles_img = p.tiles_x * ((ho + th - 1) / th);
  p.ntiles_n = (o + bn - 1) / bn;
  p.vec = vec;
  p.scale = static_cast<const float*>(scale);
  p.recip = static_cast<const float*>(recip);
  p.k_scale = static_cast<const float*>(k_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  // staged where the 16-byte copies apply and it fits; every chunk's patch
  // kept, the block running every N-tile, where there are several, the
  // output tiles alone fill two blocks an SM and two still fit
  const int esize = s8 ? 1 : 2;
  const int limit = g_smem_limit[device];
  p.stage = vec && Smem(p.ph, p.pw, ck, esize, bn, true, 2).bytes <= limit;
  p.resident = p.ntiles_n > 1 &&
               static_cast<long long>(n) * p.tiles_img >=
                   2ll * g_sm_count[device] &&
               Smem(p.ph, p.pw, ck, esize, bn, p.stage != 0, chunks).bytes <=
                   kTwoBlocks;
  const int smem = Smem(p.ph, p.pw, ck, esize, bn, p.stage != 0,
                        p.resident ? chunks : 2).bytes;
  if (smem > limit) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = static_cast<long long>(n) * p.tiles_img *
                           (p.resident ? 1 : p.ntiles_n);
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0)
    fn<<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
