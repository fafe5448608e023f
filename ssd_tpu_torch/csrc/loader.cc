// Host ingest: JPEG decode with a fused resize, bilinear resize, the
// space-to-depth(4) pack of the dense4 feed, and the tfrecord shard index
// with its crc32c.
//
// The port's own copy of the JAX package's native/loader.cc, with the same
// arithmetic, so the two libraries give the
// same bytes when built with the same compiler and flags. Exposed as a C ABI
// for ctypes (ssd_tpu_torch/data/native.py), whose foreign calls release the
// GIL: the batch decoder's and the pack's std::thread pools, and decodes in
// several request threads at once, run in parallel.
//
// The JPEG half is compiled only with -DSSD_WITH_JPEG (and linked with
// -ljpeg); without it the library still exports resize, pack, crc32c and
// the tfrecord index, and
// ssd_jpeg_available() returns 0. ssd_tpu_torch/_build.py builds it with the
// host compiler at first use.

#include <cstddef>
#include <cstdio>

#ifdef SSD_WITH_JPEG
#include <jpeglib.h>
#endif

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

namespace {

// Bilinear resize HWC uint8 RGB: half-pixel source coordinates, clamped
// neighbours, f32 arithmetic and a +0.5 truncating round.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const float ys = static_cast<float>(sh) / dh;
  const float xs = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    int y0 = std::max(0, static_cast<int>(fy));
    int y1 = std::min(sh - 1, y0 + 1);
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * xs - 0.5f;
      int x0 = std::max(0, static_cast<int>(fx));
      int x1 = std::min(sw - 1, x0 + 1);
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float top = row0[x0 * 3 + c] * (1 - wx) + row0[x1 * 3 + c] * wx;
        float bot = row1[x0 * 3 + c] * (1 - wx) + row1[x1 * 3 + c] * wx;
        out[x * 3 + c] =
            static_cast<uint8_t>(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

#ifdef SSD_WITH_JPEG
struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG to RGB; 0 on success. If out_h/out_w differ from the
// native size, decodes at the largest libjpeg DCT-domain scale (1/1..1/8)
// that stays at or above the target, then resizes bilinearly the rest of
// the way.
int decode_one(const uint8_t* data, size_t len, uint8_t* out, int out_h,
               int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (out_h > 0 && out_w > 0) {
    int full_h = cinfo.image_height, full_w = cinfo.image_width;
    int denom = 1;
    while (denom < 8 && full_h / (denom * 2) >= out_h &&
           full_w / (denom * 2) >= out_w) {
      denom *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }

  jpeg_start_decompress(&cinfo);
  const int sh = cinfo.output_height, sw = cinfo.output_width;
  const int stride = sw * cinfo.output_components;

  std::vector<uint8_t> tmp;
  uint8_t* target;
  bool direct = (out_h <= 0 || (sh == out_h && sw == out_w));
  if (direct) {
    target = out;
  } else {
    tmp.resize(static_cast<size_t>(sh) * stride);
    target = tmp.data();
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = target + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (cinfo.output_components != 3) {
    // grayscale: expand to RGB in place
    if (cinfo.output_components == 1) {
      std::vector<uint8_t> gray(target, target + static_cast<size_t>(sh) * sw);
      for (int i = sh * sw - 1; i >= 0; --i) {
        target[i * 3 + 0] = gray[i];
        target[i * 3 + 1] = gray[i];
        target[i * 3 + 2] = gray[i];
      }
    } else {
      return 2;
    }
  }
  if (!direct) resize_bilinear(target, sh, sw, out, out_h, out_w);
  return 0;
}
#endif  // SSD_WITH_JPEG

}  // namespace

extern "C" {

// 1 if the JPEG half was compiled in (libjpeg found at build time).
int ssd_jpeg_available() {
#ifdef SSD_WITH_JPEG
  return 1;
#else
  return 0;
#endif
}

// libjpeg's JPEG_LIB_VERSION (62 for the 6b API, 80, 90) and, for
// libjpeg-turbo, LIBJPEG_TURBO_VERSION_NUMBER (for example 2001005); 0 where
// absent.
int ssd_jpeg_lib_version(int* api, int* turbo) {
  *api = 0;
  *turbo = 0;
#ifdef SSD_WITH_JPEG
  *api = JPEG_LIB_VERSION;
#ifdef LIBJPEG_TURBO_VERSION_NUMBER
  *turbo = LIBJPEG_TURBO_VERSION_NUMBER;
#endif
#endif
  return 0;
}

#ifdef SSD_WITH_JPEG
// Native JPEG dimensions without a full decode.
int ssd_jpeg_dims(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + resize one image into out (out_h*out_w*3 bytes). 0 on success.
int ssd_decode_jpeg(const uint8_t* data, size_t len, uint8_t* out, int out_h,
                    int out_w) {
  return decode_one(data, len, out, out_h, out_w);
}

// Batch-parallel decode: a concatenated blob with offsets and lengths; image
// i is written to out + i*out_h*out_w*3 (zeroed if it fails). Returns the
// number of failed decodes.
int ssd_decode_batch(const uint8_t* blob, const uint64_t* offsets,
                     const uint64_t* lens, int n, uint8_t* out, int out_h,
                     int out_w, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * 3;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (decode_one(blob + offsets[i], lens[i], out + img_bytes * i, out_h,
                     out_w) != 0) {
        failures.fetch_add(1);
        std::memset(out + img_bytes * i, 0, img_bytes);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < std::min(n_threads, n); ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}
#endif  // SSD_WITH_JPEG

// Bilinear resize of one uint8 RGB HWC image. 0 on success.
int ssd_resize(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
               int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0) return 1;
  resize_bilinear(src, sh, sw, dst, dh, dw);
  return 0;
}

// The dense4 feed: (N, H, W, 3) uint8 -> (N, H/4, W/4, 48) int8,
// space-to-depth(4) with the exact -128 shift (u8 XOR 0x80 read as s8).
// Channel (4*dy + dx)*3 + c holds pixel (dy, dx) channel c of each 4x4
// block. Parallel over output block-rows; for each dy the inner copy moves
// 12 contiguous source bytes per output cell, which the compiler vectorizes.
int ssd_pack_s2d(const uint8_t* src, int n, int h, int w, int8_t* dst,
                 int n_threads) {
  if (h % 4 || w % 4 || n < 0) return 1;
  const int ph = h / 4, pw = w / 4;
  const size_t src_img = static_cast<size_t>(h) * w * 3;
  const size_t dst_img = static_cast<size_t>(ph) * pw * 48;
  const int64_t total_rows = static_cast<int64_t>(n) * ph;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t r = next.fetch_add(1);
      if (r >= total_rows) return;
      const int img = static_cast<int>(r / ph), i = static_cast<int>(r % ph);
      const uint8_t* s_img = src + src_img * img;
      int8_t* d_row = dst + dst_img * img + static_cast<size_t>(i) * pw * 48;
      for (int dy = 0; dy < 4; ++dy) {
        const uint8_t* s_row =
            s_img + (static_cast<size_t>(4 * i + dy) * w) * 3;
        int8_t* d = d_row + dy * 12;
        for (int j = 0; j < pw; ++j) {
          const uint8_t* s = s_row + j * 12;  // 4 px * 3 ch of this block
          for (int k = 0; k < 12; ++k)
            d[j * 48 + k] = static_cast<int8_t>(s[k] ^ 0x80u);
        }
      }
    }
  };
  std::vector<std::thread> threads;
  const int nt = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(total_rows, 1)));
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}


// The tfrecord half, as in the JAX package's native/loader.cc.
//
// crc32c (Castagnoli), slice-by-8 table — tfrecord verification hot path.
static uint32_t kCrcTable[8][256];
static bool crc_init = []() {
  const uint32_t poly = 0x82F63B78u;
  for (int i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    kCrcTable[0][i] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (int i = 0; i < 256; ++i)
      kCrcTable[t][i] =
          (kCrcTable[t - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[t - 1][i] & 0xFF];
  return true;
}();

// TFRecord shard indexing: walk the framing sequentially, verify every
// header CRC (rejects non-tfrecord files swept in by broad globs), and
// emit (payload offset, payload length) pairs for random access. Stops
// cleanly at a truncated tail, matching the Python walker
// (ssd_tpu_torch/data/tfrecord.py record_offsets). GIL-free via ctypes.
//
// Returns the record count (>= 0); -1 on header-CRC mismatch with
// *bad_pos = file offset of the bad record; -2 when the file cannot be
// opened; -3 when `cap` is too small (never happens for cap >= size/16+1,
// the minimum record footprint being 16 bytes).
uint32_t ssd_crc32c(const uint8_t* data, uint64_t len);  // defined below

int64_t ssd_tfrecord_index(const char* path, uint64_t* offsets,
                           uint64_t* lengths, int64_t cap,
                           uint64_t* bad_pos) {
  FILE* f = fopen(path, "rb");
  if (!f) return -2;
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -2; }
  const uint64_t size = static_cast<uint64_t>(ftell(f));
  rewind(f);

  int64_t n = 0;
  uint64_t pos = 0;
  uint8_t hdr[12];
  while (pos + 12 <= size) {
    if (fread(hdr, 1, 12, f) != 12) break;  // truncated tail
    uint64_t len = 0;
    for (int i = 7; i >= 0; --i) len = (len << 8) | hdr[i];
    uint32_t stored = static_cast<uint32_t>(hdr[8]) | (hdr[9] << 8) |
                      (hdr[10] << 16) |
                      (static_cast<uint32_t>(hdr[11]) << 24);
    uint32_t crc = ssd_crc32c(hdr, 8);
    uint32_t masked =
        (((crc >> 15) | (crc << 17)) + 0xA282EAD8u) & 0xFFFFFFFFu;
    if (masked != stored) {
      if (bad_pos) *bad_pos = pos;
      fclose(f);
      return -1;
    }
    if (pos + 12 + len + 4 > size) break;  // truncated tail
    if (n >= cap) { fclose(f); return -3; }
    offsets[n] = pos + 12;
    lengths[n] = len;
    ++n;
    pos += 12 + len + 4;
    if (fseek(f, static_cast<long>(pos), SEEK_SET) != 0) break;
  }
  fclose(f);
  return n;
}

uint32_t ssd_crc32c(const uint8_t* data, uint64_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    crc ^= static_cast<uint32_t>(data[0]) | (data[1] << 8) | (data[2] << 16) |
           (static_cast<uint32_t>(data[3]) << 24);
    uint32_t hi = static_cast<uint32_t>(data[4]) | (data[5] << 8) |
                  (data[6] << 16) | (static_cast<uint32_t>(data[7]) << 24);
    crc = kCrcTable[7][crc & 0xFF] ^ kCrcTable[6][(crc >> 8) & 0xFF] ^
          kCrcTable[5][(crc >> 16) & 0xFF] ^ kCrcTable[4][crc >> 24] ^
          kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
          kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
