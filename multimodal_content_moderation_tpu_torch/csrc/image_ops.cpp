// Host-side image ops of the input pipeline: JPEG decode fused with the
// eval geometry (shortest-edge resize to `out`, centre crop to out x out).
//
// The port's own copy of the JAX package's native/image_ops.cpp, with two
// changes:
// - The resize is PIL's own fixed-point arithmetic for Image.BILINEAR
//   (Pillow's Resample.c: double coefficients normalised to 22-bit integers,
//   a horizontal pass into a uint8 image, then a vertical pass), so a crop
//   is bit-identical to the PIL pipeline's, not within 2 levels of it as a
//   float resize is.
// - Besides libjpeg (MMCM_HAVE_JPEG), the decode can use the CUDA toolkit's
//   nvJPEG (MMCM_HAVE_NVJPEG) on a machine that has no libjpeg: the same
//   function, with the entropy decode on the host and the IDCT on the card,
//   through a pool of decoder states. The card returns the Y, Cb and Cr planes
//   as coded, and the host upsamples and converts them as libjpeg does, so
//   only the IDCT's rounding separates the crop from PIL's. nvJPEG has no
//   DCT-domain scaling, so `scale_mode` decodes at full size there.
//
// Exported C ABI (every call is plain C, so ctypes releases the GIL):
//   resize_bilinear_u8(src, h, w, c, dst, oh, ow)
//   resize_shortest_edge_center_crop_u8(src, h, w, c, dst, out)
//   gather_patches_u8(src, rows, B, H, W, C, p, dst, threads)
//   ycc_to_rgb_u8(y, cb, cr, w, h, cw, ch, dst)
//   decode_jpeg_resize_crop_u8(data, len, dst, out, scale_mode)  -> a code:
//     0 decoded; 1-3 the bytes are not a JPEG this decoder takes (corrupt,
//     truncated, unsupported); 4 and up a fault of the machine, not of the
//     bytes: 4 out of device or pinned memory, 5 a copy or stream sync
//     failed, 6 nvJPEG could not be set up, 7 no decoder is compiled in,
//     100 + s nvJPEG failed with status s
//   has_jpeg()        1 when a JPEG decoder is compiled in
//   jpeg_decoder()    "libjpeg", "nvjpeg" or "none"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <new>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

struct Coeffs {
  std::vector<int> bounds;  // (first source index, taps) per output index
  std::vector<int> k;       // ksize fixed-point taps per output index
  int ksize = 0;
};

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Pillow's precompute_coeffs (box = the whole image) + normalize_coeffs_8bpc.
Coeffs precompute(int in_size, int out_size) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(static_cast<size_t>(out_size) * 2);
  c.k.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> pre(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      pre[x] = w;
      ww += w;
    }
    int* k = &c.k[static_cast<size_t>(xx) * c.ksize];
    for (int x = 0; x < xmax; ++x) {
      const double v = ww != 0.0 ? pre[x] / ww : pre[x];
      k[x] = v < 0 ? static_cast<int>(-0.5 + v * (1 << kPrecisionBits))
                   : static_cast<int>(0.5 + v * (1 << kPrecisionBits));
    }
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(int v) {
  const int s = v >> kPrecisionBits;
  return s < 0 ? 0 : (s > 255 ? 255 : static_cast<uint8_t>(s));
}

inline uint8_t clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : static_cast<uint8_t>(v)); }

// One output row of a chroma plane upsampled 2x in both directions, as
// libjpeg-turbo's jdsample.c does with its default fancy upsampling: the h2v2
// triangle filter with its alternating rounding biases, plain replication
// where the plane is 2 or fewer samples wide. `near` is the plane row the
// output row lies in, `far` the neighbouring row (the edge row repeated at the
// top and bottom, as jdmainct's context rows are).
void upsample_h2v2_row(const uint8_t* near, const uint8_t* far, int cw, uint8_t* out) {
  if (cw <= 2) {  // libjpeg takes the box upsampler here
    for (int i = 0; i < cw; ++i) out[2 * i] = out[2 * i + 1] = near[i];
    return;
  }
  // column sums 3 * near + far, then the same 3:1 filter across columns
  auto col = [&](int i) { return near[i] * 3 + far[i]; };
  out[0] = static_cast<uint8_t>((col(0) * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((col(0) * 3 + col(1) + 7) >> 4);
  for (int i = 1; i < cw - 1; ++i) {
    out[2 * i] = static_cast<uint8_t>((col(i) * 3 + col(i - 1) + 8) >> 4);
    out[2 * i + 1] = static_cast<uint8_t>((col(i) * 3 + col(i + 1) + 7) >> 4);
  }
  out[2 * cw - 2] = static_cast<uint8_t>((col(cw - 1) * 3 + col(cw - 2) + 8) >> 4);
  out[2 * cw - 1] = static_cast<uint8_t>((col(cw - 1) * 4 + 7) >> 4);
}

// jdcolor.c's fixed-point YCbCr -> RGB tables (16 fractional bits).
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + kHalf);
    }
  }
};

// One band of p image rows -> its (W / p) patch rows of C * p * p bytes,
// channel-major ([C, p, p] a patch, the order of the folded embed GEMM).
// The band is read once, row by row, and each pixel's channels are split
// into their planes.
void band_to_patches(const uint8_t* __restrict band, int w, int p, int c,
                     uint8_t* __restrict dst) {
  const size_t pp = static_cast<size_t>(p) * p, k = pp * c;
  const size_t stride = static_cast<size_t>(w) * c;
  const int nw = w / p;
  for (int r = 0; r < p; ++r) {
    const uint8_t* row = band + r * stride;
    for (int j = 0; j < nw; ++j) {
      const uint8_t* px = row + static_cast<size_t>(j) * p * c;
      uint8_t* out = dst + j * k + static_cast<size_t>(r) * p;
      for (int ci = 0; ci < c; ++ci)
        for (int x = 0; x < p; ++x) out[ci * pp + x] = px[x * c + ci];
    }
  }
}

using BandFn = void (*)(const uint8_t*, int, int, int, uint8_t*);

#if defined(__x86_64__) || defined(__i386__)
// The same for RGB and p = 16 or 32, 16 pixels (48 bytes, three loads) at a
// time: each plane is three byte shuffles ORed together. Built for SSSE3 and
// taken only where the CPU has it (pick_band_fn).
struct PlaneShuffles {
  uint8_t m[3][3][16];  // [plane][load][lane]: the lane's byte of that load, or 0x80 (zero)
  PlaneShuffles() {
    for (int plane = 0; plane < 3; ++plane)
      for (int load = 0; load < 3; ++load)
        for (int i = 0; i < 16; ++i) {
          const int k = 3 * i + plane - 16 * load;
          m[plane][load][i] = k >= 0 && k < 16 ? static_cast<uint8_t>(k) : 0x80;
        }
  }
};

template <int P>
__attribute__((target("ssse3"))) void band_to_patches_rgb16(const uint8_t* __restrict band,
                                                            int w, int, int,
                                                            uint8_t* __restrict dst) {
  static const PlaneShuffles sh;
  constexpr size_t pp = static_cast<size_t>(P) * P, k = pp * 3;
  const size_t stride = static_cast<size_t>(w) * 3;
  const int nw = w / P;
  auto mask = [](const uint8_t* m) { return _mm_loadu_si128(reinterpret_cast<const __m128i*>(m)); };
  for (int r = 0; r < P; ++r) {
    for (int j = 0; j < nw; ++j) {
      const uint8_t* px = band + r * stride + static_cast<size_t>(j) * P * 3;
      uint8_t* out = dst + j * k + static_cast<size_t>(r) * P;
      for (int x = 0; x < P; x += 16, px += 48) {
        const __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(px));
        const __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(px + 16));
        const __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(px + 32));
        for (int plane = 0; plane < 3; ++plane) {
          const __m128i v = _mm_or_si128(
              _mm_or_si128(_mm_shuffle_epi8(a, mask(sh.m[plane][0])),
                           _mm_shuffle_epi8(b, mask(sh.m[plane][1]))),
              _mm_shuffle_epi8(c, mask(sh.m[plane][2])));
          _mm_storeu_si128(reinterpret_cast<__m128i*>(out + plane * pp + x), v);
        }
      }
    }
  }
}
#endif

// The routine for a (p, C): the shuffles for RGB at p = 16 or 32 where the
// CPU has SSSE3, else the general loop.
BandFn pick_band_fn(int p, int c) {
#if defined(__x86_64__) || defined(__i386__)
  if (c == 3 && __builtin_cpu_supports("ssse3")) {
    if (p == 16) return band_to_patches_rgb16<16>;
    if (p == 32) return band_to_patches_rgb16<32>;
  }
#endif
  return band_to_patches;
}

// Bands [first, last) of the batch: band i is image i / nh's patch row i % nh.
void gather_bands(const uint8_t* src, const int64_t* rows, int h, int w, int c, int p,
                  uint8_t* dst, size_t first, size_t last, BandFn fn) {
  const int nh = h / p;
  const size_t image = static_cast<size_t>(h) * w * c;
  const size_t band = static_cast<size_t>(p) * w * c;  // bytes in and out
  for (size_t i = first; i < last; ++i) {
    const int64_t row = rows[i / nh];
    uint8_t* out = dst + i * band;
    if (row < 0) {
      std::memset(out, 0, band);
      continue;
    }
    fn(src + static_cast<size_t>(row) * image + (i % nh) * band, w, p, c, out);
  }
}

// A thread a batch's kBytesPerThread: a smaller share costs more to start
// than it saves, and the threads share the host with the launching thread.
constexpr size_t kBytesPerThread = size_t{8} << 20;

}  // namespace

extern "C" {

// Planar YCbCr as coded (Y w x h; Cb and Cr cw x ch: 4:4:4, or 4:2:0 with
// cw = ceil(w / 2) and ch = ceil(h / 2)) -> HWC RGB w x h, the way
// libjpeg-turbo turns them into the pixels PIL returns.
void ycc_to_rgb_u8(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int w, int h,
                   int cw, int ch, uint8_t* dst) {
  static const YccTables t;
  const bool sub = cw != w || ch != h;
  std::vector<uint8_t> cb_row(static_cast<size_t>(cw) * 2), cr_row(cb_row.size());
  for (int r = 0; r < h; ++r) {
    const uint8_t* cbr = cb + static_cast<size_t>(r) * cw;
    const uint8_t* crr = cr + static_cast<size_t>(r) * cw;
    if (sub) {
      const int cy = r / 2;
      const int fy = (r & 1) ? std::min(cy + 1, ch - 1) : std::max(cy - 1, 0);
      const size_t near = static_cast<size_t>(cy) * cw, far = static_cast<size_t>(fy) * cw;
      upsample_h2v2_row(cb + near, cb + far, cw, cb_row.data());
      upsample_h2v2_row(cr + near, cr + far, cw, cr_row.data());
      cbr = cb_row.data();
      crr = cr_row.data();
    }
    const uint8_t* yr = y + static_cast<size_t>(r) * w;
    uint8_t* o = dst + static_cast<size_t>(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = yr[x], b = cbr[x], c = crr[x];
      o[3 * x] = clamp255(yy + t.cr_r[c]);
      o[3 * x + 1] = clamp255(yy + ((t.cb_g[b] + t.cr_g[c]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[b]);
    }
  }
}

// HWC uint8 -> HWC uint8, Pillow's Image.resize(..., BILINEAR) bit for bit.
void resize_bilinear_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                        int oh, int ow) {
  const bool need_h = ow != w, need_v = oh != h;
  if (!need_h && !need_v) {
    std::memcpy(dst, src, static_cast<size_t>(h) * w * c);
    return;
  }
  Coeffs cv = precompute(h, oh);
  const uint8_t* vin = src;
  int vin_w = w;
  std::vector<uint8_t> tmp;
  if (need_h) {
    const Coeffs ch = precompute(w, ow);
    // only the source rows the vertical pass reads
    const int y0 = need_v ? cv.bounds[0] : 0;
    const int y1 = need_v ? cv.bounds[oh * 2 - 2] + cv.bounds[oh * 2 - 1] : h;
    uint8_t* out = dst;
    if (need_v) {
      tmp.resize(static_cast<size_t>(y1 - y0) * ow * c);
      out = tmp.data();
      for (int i = 0; i < oh; ++i) cv.bounds[i * 2] -= y0;
    }
    for (int y = y0; y < y1; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * w * c;
      uint8_t* orow = out + static_cast<size_t>(y - y0) * ow * c;
      for (int x = 0; x < ow; ++x) {
        const int* k = &ch.k[static_cast<size_t>(x) * ch.ksize];
        const int x0 = ch.bounds[x * 2], n = ch.bounds[x * 2 + 1];
        for (int ci = 0; ci < c; ++ci) {
          int ss = 1 << (kPrecisionBits - 1);
          for (int i = 0; i < n; ++i) ss += row[(x0 + i) * c + ci] * k[i];
          orow[x * c + ci] = clip8(ss);
        }
      }
    }
    if (!need_v) return;
    vin = tmp.data();
    vin_w = ow;
  }
  const int row_elems = vin_w * c;
  std::vector<int> acc(row_elems);
  for (int y = 0; y < oh; ++y) {
    const int* k = &cv.k[static_cast<size_t>(y) * cv.ksize];
    const int y0 = cv.bounds[y * 2], n = cv.bounds[y * 2 + 1];
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (int i = 0; i < n; ++i) {
      const uint8_t* srow = vin + static_cast<size_t>(y0 + i) * row_elems;
      const int kv = k[i];
      for (int e = 0; e < row_elems; ++e) acc[e] += srow[e] * kv;
    }
    uint8_t* orow = dst + static_cast<size_t>(y) * row_elems;
    for (int e = 0; e < row_elems; ++e) orow[e] = clip8(acc[e]);
  }
}

// Shortest-edge resize to `out` (the long edge truncated, as torchvision and
// the PIL path do) then centre crop to (out, out), zero-padding where the
// resized image is smaller.
void resize_shortest_edge_center_crop_u8(const uint8_t* src, int h, int w,
                                         int c, uint8_t* dst, int out) {
  int nw, nh;
  if (w < h) {
    nw = out;
    nh = static_cast<int>(static_cast<int64_t>(out) * h / w);
  } else {
    nh = out;
    nw = static_cast<int>(static_cast<int64_t>(out) * w / h);
  }
  std::vector<uint8_t> resized(static_cast<size_t>(nh) * nw * c);
  resize_bilinear_u8(src, h, w, c, resized.data(), nh, nw);

  std::memset(dst, 0, static_cast<size_t>(out) * out * c);
  const int top = (nh - out) / 2;
  const int left = (nw - out) / 2;
  for (int y = 0; y < out; ++y) {
    const int sy = top + y;
    if (sy < 0 || sy >= nh) continue;
    const int sx0 = std::max(left, 0);
    const int dx0 = sx0 - left;
    const int span = std::min(nw, left + out) - sx0;
    if (span <= 0) continue;
    std::memcpy(dst + (static_cast<size_t>(y) * out + dx0) * c,
                resized.data() + (static_cast<size_t>(sy) * nw + sx0) * c,
                static_cast<size_t>(span) * c);
  }
}

// [n, H, W, C] uint8 crops, rows `rows[0..B)` of them (a negative row is a
// pad: zeros) -> [B, (H / p) * (W / p), C * p * p] channel-major patch rows,
// the bytes of ops/cuda_image.extract_patches_plain. p must divide H and W;
// the caller checks the shapes and that every row is below n. The bands are
// split over at most `threads` threads (and the machine's cores), one for
// each kBytesPerThread of the batch; the calling thread is one of them and
// runs whatever a thread that could not start would have.
void gather_patches_u8(const uint8_t* src, const int64_t* rows, int B, int h, int w, int c,
                      int p, uint8_t* dst, int threads) {
  const BandFn fn = pick_band_fn(p, c);
  const size_t bands = static_cast<size_t>(B) * (h / p);
  const size_t bytes = static_cast<size_t>(B) * h * w * c;
  size_t n = std::max<size_t>(1, bytes / kBytesPerThread);
  n = std::min({n, bands, static_cast<size_t>(std::max(threads, 1)),
                static_cast<size_t>(std::max(1u, std::thread::hardware_concurrency()))});
  std::vector<std::thread> pool;
  size_t mine = bands;  // the calling thread runs bands [0, mine)
  try {
    pool.reserve(n);
    for (size_t t = n; t-- > 1;) {
      const size_t first = bands * t / n;
      pool.emplace_back(gather_bands, src, rows, h, w, c, p, dst, first, mine, fn);
      mine = first;
    }
  } catch (const std::exception&) {
    // no more threads: the calling thread takes the bands left unassigned
  }
  gather_bands(src, rows, h, w, c, p, dst, 0, mine, fn);
  for (auto& t : pool) t.join();
}

}  // extern "C"

#if defined(MMCM_HAVE_JPEG)
// ---------------------------------------------------------------------------
// libjpeg: the decoder PIL wraps, so a full-size decode is bit-identical to
// PIL's. scale_mode=1 asks libjpeg for the smallest M/8 IDCT scale whose
// shortest edge still covers `out` (less IDCT work; near-exact).
// ---------------------------------------------------------------------------
#include <csetjmp>
#include <cstdio>  // jpeglib.h needs FILE

#include <jpeglib.h>
#include <jerror.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(e->jb, 1);
}

// libjpeg's default prints each warning to stderr; a server decoding
// untrusted bytes stays quiet (a failed decode returns non-zero instead)
void jpeg_quiet(j_common_ptr) {}

}  // namespace

extern "C" {

int has_jpeg() { return 1; }
const char* jpeg_decoder() { return "libjpeg"; }

// Returns a code of the header comment: libjpeg's own out-of-memory error
// and a failed allocation here are 4, any other decode failure (corrupt
// data, a colour space other than grey or YCbCr/RGB) 1-3. The pixel buffer
// lives outside the setjmp region so a longjmp cannot leak it.
int decode_jpeg_resize_crop_u8(const uint8_t* data, int len, uint8_t* dst,
                               int out, int scale_mode) {
  std::vector<uint8_t> pixels;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.output_message = jpeg_quiet;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return jerr.mgr.msg_code == JERR_OUT_OF_MEMORY ? 4 : 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;  // grey sources are expanded by jdcolor
  if (scale_mode) {
    const int short_edge = static_cast<int>(
        std::min(cinfo.image_width, cinfo.image_height));
    int m = 8;
    while (m > 1 && (short_edge * (m - 1) + 7) / 8 >= out) --m;
    cinfo.scale_num = static_cast<unsigned>(m);
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  if (cinfo.output_components != 3 || w <= 0 || h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  try {
    pixels.resize(static_cast<size_t>(h) * w * 3);
  } catch (const std::bad_alloc&) {
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  try {
    resize_shortest_edge_center_crop_u8(pixels.data(), h, w, 3, dst, out);
  } catch (const std::bad_alloc&) {
    return 4;
  }
  return 0;
}

}  // extern "C"

#elif defined(MMCM_HAVE_NVJPEG)
// ---------------------------------------------------------------------------
// nvJPEG (CUDA toolkit): entropy decode on the host, IDCT on the card, into a
// device buffer that is copied back. A grey image comes back as its Y plane,
// and 4:4:4 and 4:2:0 images as their Y, Cb and Cr planes, which the host
// upsamples and converts with libjpeg's arithmetic (ycc_to_rgb_u8); other
// subsamplings (4:2:2, 4:4:0, 4:1:1) take nvJPEG's own RGB. One library
// handle per process; a decoder context (nvJPEG state, a non-blocking stream,
// a growing device buffer and a pinned host buffer) is taken from a pool for
// each call, so concurrent callers never share a state and steady-state calls
// allocate nothing on the card. Contexts live until the process ends.
// ---------------------------------------------------------------------------
#include <cuda_runtime_api.h>
#include <nvjpeg.h>

#include <mutex>

namespace {

struct Ctx {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dbuf = nullptr;
  unsigned char* hbuf = nullptr;
  size_t cap = 0;
  std::vector<uint8_t> rgb;
};

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;
std::vector<Ctx*> g_free;

// A context, or nullptr when nvJPEG cannot be set up (tried again on the
// next call).
Ctx* acquire() {
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_handle == nullptr && nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS) {
    g_handle = nullptr;
    return nullptr;
  }
  if (!g_free.empty()) {
    Ctx* c = g_free.back();
    g_free.pop_back();
    return c;
  }
  Ctx* c = new Ctx();
  if (nvjpegJpegStateCreate(g_handle, &c->state) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking) != cudaSuccess) {
    if (c->state) nvjpegJpegStateDestroy(c->state);
    delete c;
    return nullptr;
  }
  return c;
}

void release(Ctx* c) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_free.push_back(c);
}

bool reserve(Ctx* c, size_t bytes) {
  if (bytes <= c->cap) return true;
  if (c->dbuf) cudaFree(c->dbuf);
  if (c->hbuf) cudaFreeHost(c->hbuf);
  c->dbuf = nullptr;
  c->hbuf = nullptr;
  c->cap = 0;
  if (cudaMalloc(reinterpret_cast<void**>(&c->dbuf), bytes) != cudaSuccess) return false;
  if (cudaMallocHost(reinterpret_cast<void**>(&c->hbuf), bytes) != cudaSuccess)
    return false;
  c->cap = bytes;
  return true;
}

// A status that blames the bytes (1) rather than the machine (100 + status).
int status_code(nvjpegStatus_t s) {
  switch (s) {
    case NVJPEG_STATUS_INVALID_PARAMETER:
    case NVJPEG_STATUS_BAD_JPEG:
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM:
      return 1;
    default:
      return 100 + static_cast<int>(s);
  }
}

// Decode into c->rgb as h x w x 3 RGB; returns a code of
// decode_jpeg_resize_crop_u8.
int nv_decode(Ctx* c, const uint8_t* data, int len, int* w_out, int* h_out) {
  int ncomp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegStatus_t s = nvjpegGetImageInfo(g_handle, data, static_cast<size_t>(len), &ncomp,
                                        &sub, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return status_code(s) == 1 ? 2 : status_code(s);
  const int w = widths[0], h = heights[0];
  if (w <= 0 || h <= 0 || (ncomp != 1 && ncomp != 3)) return 3;
  const int f = sub == NVJPEG_CSS_444 ? 1 : 2;
  const bool planar = ncomp == 3 && (sub == NVJPEG_CSS_444 || sub == NVJPEG_CSS_420) &&
                      widths[1] == (w + f - 1) / f && heights[1] == (h + f - 1) / f &&
                      widths[2] == widths[1] && heights[2] == heights[1];
  const size_t plane = static_cast<size_t>(w) * h;
  const size_t cplane = planar ? static_cast<size_t>(widths[1]) * heights[1] : 0;
  const size_t bytes = ncomp == 1 ? plane : (planar ? plane + 2 * cplane : plane * 3);
  if (!reserve(c, bytes)) return 4;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = c->dbuf;
  nvjpegOutputFormat_t fmt = NVJPEG_OUTPUT_Y;
  img.pitch[0] = static_cast<unsigned int>(w);
  if (planar) {
    fmt = NVJPEG_OUTPUT_YUV;
    img.channel[1] = c->dbuf + plane;
    img.channel[2] = c->dbuf + plane + cplane;
    img.pitch[1] = img.pitch[2] = static_cast<unsigned int>(widths[1]);
  } else if (ncomp == 3) {
    fmt = NVJPEG_OUTPUT_RGBI;
    img.pitch[0] = static_cast<unsigned int>(w * 3);
  }
  s = nvjpegDecode(g_handle, c->state, data, static_cast<size_t>(len), fmt, &img, c->stream);
  if (s != NVJPEG_STATUS_SUCCESS) return status_code(s);
  if (cudaMemcpyAsync(c->hbuf, c->dbuf, bytes, cudaMemcpyDeviceToHost, c->stream) !=
          cudaSuccess ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return 5;
  c->rgb.resize(plane * 3);
  if (planar) {
    ycc_to_rgb_u8(c->hbuf, c->hbuf + plane, c->hbuf + plane + cplane, w, h, widths[1],
                  heights[1], c->rgb.data());
  } else if (ncomp == 1) {  // grey to RGB, as libjpeg's jdcolor
    for (size_t i = 0; i < plane; ++i)
      c->rgb[i * 3] = c->rgb[i * 3 + 1] = c->rgb[i * 3 + 2] = c->hbuf[i];
  } else {
    std::memcpy(c->rgb.data(), c->hbuf, plane * 3);
  }
  *w_out = w;
  *h_out = h;
  return 0;
}

}  // namespace

extern "C" {

int has_jpeg() { return 1; }
const char* jpeg_decoder() { return "nvjpeg"; }

int decode_jpeg_resize_crop_u8(const uint8_t* data, int len, uint8_t* dst,
                               int out, int scale_mode) {
  (void)scale_mode;  // nvJPEG decodes at full size
  Ctx* c = nullptr;
  try {
    c = acquire();
  } catch (const std::bad_alloc&) {
    return 4;
  }
  if (c == nullptr) return 6;
  int rc = 4;
  try {
    int w = 0, h = 0;
    rc = nv_decode(c, data, len, &w, &h);
    if (rc == 0) resize_shortest_edge_center_crop_u8(c->rgb.data(), h, w, 3, dst, out);
  } catch (const std::bad_alloc&) {
    rc = 4;
  }
  release(c);
  return rc;
}

}  // extern "C"

#else  // no JPEG decoder

extern "C" {
int has_jpeg() { return 0; }
const char* jpeg_decoder() { return "none"; }
int decode_jpeg_resize_crop_u8(const uint8_t*, int, uint8_t*, int, int) { return 7; }
}

#endif
