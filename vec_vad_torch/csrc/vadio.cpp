// vadio: the port's native frame decoder and prefetcher, a copy of the JAX
// package's native/vadio.cpp with two entry points added: a header probe
// (height, width, channels, bit depth) and a PNG decode that keeps the
// file's channels and bit depth (cv2.imread's IMREAD_UNCHANGED for PNGs).
//
// It replaces the reference's per-frame cv2.imread on the hot path
// (vad_datasets.py:18-25,356-402) with:
//
//   * decode-to-preallocated-buffer JPEG/PNG/TIFF decoding (BGR uint8,
//     cv2.imread's channel convention; TIFF covers UCSDped2's .tif frames),
//   * a std::thread pool that decodes a batch of files in parallel into one
//     contiguous (N, H, W, 3) buffer, and
//   * a background prefetcher that pipelines chunk N+1's disk+decode work
//     under chunk N's device compute.
//
// Plain C ABI for ctypes. Built at first use by
// vec_vad_torch/runtime/native_loader.py:
//   g++ -O3 -std=c++17 -fPIC -Wall -shared vadio.cpp -ljpeg -lpng -ltiff -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <tiffio.h>
#include <csetjmp>

namespace {

// libtiff reports recoverable oddities (unknown tags etc.) to stderr by
// default — spam on threaded batch decode; errors still surface as rc
const bool tiff_quiet = [] {
  TIFFSetWarningHandler(nullptr);
  return true;
}();

// ---------------------------------------------------------------------------
// Decoders: file -> BGR uint8 into caller buffer (h*w*3). Returns 0 on
// success, negative error codes otherwise. If (h, w) mismatch the file,
// returns -2 so callers can detect inconsistent datasets.
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

int decode_jpeg_file(const char* path, uint8_t* out, int h, int w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale sources expand to RGB
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_height != h || (int)cinfo.output_width != w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  std::vector<uint8_t> row(w * 3);
  uint8_t* rp = row.data();
  for (int y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    uint8_t* dst = out + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {  // RGB -> BGR (cv2 convention)
      dst[x * 3 + 0] = rp[x * 3 + 2];
      dst[x * 3 + 1] = rp[x * 3 + 1];
      dst[x * 3 + 2] = rp[x * 3 + 0];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

int decode_png_file(const char* path, uint8_t* out, int h, int w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(f);
    return -5;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(f);
    return -5;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return -3;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  int width = png_get_image_width(png, info);
  int height = png_get_image_height(png, info);
  if (height != h || width != w) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return -2;
  }
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_set_bgr(png);  // emit BGR directly
  png_read_update_info(png, info);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = out + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return 0;
}

int decode_tiff_file(const char* path, uint8_t* out, int h, int w) {
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return -1;
  uint32_t width = 0, height = 0;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &width);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &height);
  if ((int)height != h || (int)width != w) {
    TIFFClose(tif);
    return -2;
  }
  // RGBA raster path: libtiff normalizes every photometric layout
  // (grayscale expands to R=G=B, like cv2.imread's IMREAD_COLOR on the
  // UCSDped2 .tif frames); TOPLEFT orientation = top-down rows
  std::vector<uint32_t> raster((size_t)w * h);
  if (!TIFFReadRGBAImageOriented(tif, width, height, raster.data(),
                                 ORIENTATION_TOPLEFT, 0)) {
    TIFFClose(tif);
    return -3;
  }
  TIFFClose(tif);
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = out + (size_t)y * w * 3;
    const uint32_t* src = raster.data() + (size_t)y * w;
    for (int x = 0; x < w; ++x) {  // ABGR word -> BGR bytes (cv2 convention)
      uint32_t px = src[x];
      dst[x * 3 + 0] = TIFFGetB(px);
      dst[x * 3 + 1] = TIFFGetG(px);
      dst[x * 3 + 2] = TIFFGetR(px);
    }
  }
  return 0;
}

int decode_file(const char* path, uint8_t* out, int h, int w) {
  const char* dot = strrchr(path, '.');
  if (!dot) return -4;
  std::string ext(dot + 1);
  for (auto& c : ext) c = tolower(c);
  if (ext == "jpg" || ext == "jpeg") return decode_jpeg_file(path, out, h, w);
  if (ext == "png") return decode_png_file(path, out, h, w);
  if (ext == "tif" || ext == "tiff") return decode_tiff_file(path, out, h, w);
  return -4;  // unsupported extension: the caller reads it another way
}

// ---------------------------------------------------------------------------
// Header probe: info = {height, width, channels, bit depth} as the file
// stores them, without decoding pixels. PNG channels are those cv2.imread's
// IMREAD_UNCHANGED returns: 1 for gray, 3 for RGB or palette, 4 with alpha
// (a tRNS chunk on RGB or palette, gray+alpha, RGBA).
// ---------------------------------------------------------------------------

int probe_jpeg(const char* path, int* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  info[0] = (int)cinfo.image_height;
  info[1] = (int)cinfo.image_width;
  info[2] = cinfo.num_components;
  info[3] = cinfo.data_precision;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Opens a PNG and reads its header; on success the caller owns png/info/f.
int open_png(const char* path, FILE** f, png_structp* png, png_infop* info) {
  *f = fopen(path, "rb");
  if (!*f) return -1;
  *png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                                nullptr);
  *info = *png ? png_create_info_struct(*png) : nullptr;
  if (!*info) {
    png_destroy_read_struct(png, nullptr, nullptr);
    fclose(*f);
    return -5;
  }
  if (setjmp(png_jmpbuf(*png))) {
    png_destroy_read_struct(png, info, nullptr);
    fclose(*f);
    return -3;
  }
  png_init_io(*png, *f);
  png_read_info(*png, *info);
  return 0;
}

int png_channels(png_structp png, png_infop info) {
  png_byte color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_PALETTE)
    return png_get_valid(png, info, PNG_INFO_tRNS) ? 4 : 3;
  if (color == PNG_COLOR_TYPE_GRAY_ALPHA || color == PNG_COLOR_TYPE_RGB_ALPHA)
    return 4;
  return 1;
}

int probe_png(const char* path, int* info_out) {
  FILE* f;
  png_structp png;
  png_infop info;
  int rc = open_png(path, &f, &png, &info);
  if (rc) return rc;
  info_out[0] = (int)png_get_image_height(png, info);
  info_out[1] = (int)png_get_image_width(png, info);
  info_out[2] = png_channels(png, info);
  info_out[3] = png_get_bit_depth(png, info) == 16 ? 16 : 8;
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return 0;
}

int probe_tiff(const char* path, int* info) {
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return -1;
  uint32_t width = 0, height = 0;
  uint16_t spp = 1, bps = 1;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &width);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &height);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFClose(tif);
  info[0] = (int)height;
  info[1] = (int)width;
  info[2] = spp;
  info[3] = bps;
  return 0;
}

int probe_file(const char* path, int* info) {
  const char* dot = strrchr(path, '.');
  if (!dot) return -4;
  std::string ext(dot + 1);
  for (auto& c : ext) c = tolower(c);
  if (ext == "jpg" || ext == "jpeg") return probe_jpeg(path, info);
  if (ext == "png") return probe_png(path, info);
  if (ext == "tif" || ext == "tiff") return probe_tiff(path, info);
  return -4;
}

// ---------------------------------------------------------------------------
// PNG as stored: (h, w, c) with c from probe_png (1 gray, 3 BGR, 4 BGRA),
// 8-bit into uint8 or 16-bit into native-endian uint16, as cv2.imread's
// IMREAD_UNCHANGED reads it. -2 when (h, w, c, depth) differ from the file.
// ---------------------------------------------------------------------------

int decode_png_unchanged(const char* path, void* out, int h, int w, int c,
                         int depth) {
  FILE* f;
  png_structp png;
  png_infop info;
  int rc = open_png(path, &f, &png, &info);
  if (rc) return rc;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return -3;
  }
  png_byte color = png_get_color_type(png, info);
  png_byte bits = png_get_bit_depth(png, info);
  if ((int)png_get_image_height(png, info) != h ||
      (int)png_get_image_width(png, info) != w ||
      png_channels(png, info) != c || (bits == 16 ? 16 : 8) != depth) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return -2;
  }
  if (bits == 16) {
    const uint16_t one = 1;
    if (*reinterpret_cast<const uint8_t*>(&one) == 1) png_set_swap(png);
  }
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bits < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (c == 4 && png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_tRNS_to_alpha(png);
  if (c < 4) png_set_strip_alpha(png);
  if (c > 1 && (color & PNG_COLOR_MASK_COLOR)) png_set_bgr(png);
  if (c > 1 && !(color & PNG_COLOR_MASK_COLOR)) png_set_gray_to_rgb(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  size_t row_bytes = (size_t)w * c * (depth / 8);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y)
    rows[y] = static_cast<uint8_t*>(out) + (size_t)y * row_bytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Thread-pool batch decode
// ---------------------------------------------------------------------------

struct Pool {
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  // current batch (generation-stamped so sleeping workers never miss or
  // double-join a batch)
  const char* const* paths = nullptr;
  uint8_t* out = nullptr;
  int n = 0, h = 0, w = 0;
  uint64_t gen = 0;
  bool batch_done = true;
  std::atomic<int> next{0};
  std::atomic<int> done{0};
  std::atomic<int> errors{0};
  std::atomic<int> in_flight{0};  // workers still inside a batch's loop
  bool stop = false;

  explicit Pool(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      threads.emplace_back([this] { worker(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : threads) t.join();
  }

  void worker() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || gen != seen; });
        if (stop) return;
        seen = gen;
        in_flight.fetch_add(1);
      }
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n) break;
        int rc = decode_file(paths[i], out + (size_t)i * h * w * 3, h, w);
        if (rc != 0) errors.fetch_add(1);
        if (done.fetch_add(1) + 1 == n) {
          std::lock_guard<std::mutex> lk(mu);
          batch_done = true;
          // don't notify yet: run() also waits for stragglers to leave
        }
      }
      {
        // a worker may reach here AFTER batch_done (its fetch_add lost the
        // race for the final item); run() must not reset batch state until
        // every worker has left this loop, or the straggler's fetch_add
        // would index the NEXT batch's arrays
        std::lock_guard<std::mutex> lk(mu);
        in_flight.fetch_sub(1);
        cv_done.notify_all();
      }
    }
  }

  int run(const char* const* p, int count, uint8_t* o, int hh, int ww) {
    if (count == 0) return 0;
    {
      std::unique_lock<std::mutex> lk(mu);
      // wait out stragglers from the previous batch before mutating state
      cv_done.wait(lk, [this] { return in_flight.load() == 0; });
      paths = p;
      out = o;
      n = count;
      h = hh;
      w = ww;
      next = 0;
      done = 0;
      errors = 0;
      batch_done = false;
      ++gen;
    }
    cv_work.notify_all();
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_done.wait(lk, [this] {
        return batch_done && in_flight.load() == 0;
      });
    }
    return errors.load();
  }
};

}  // namespace

extern "C" {

// Single-file decode (BGR uint8 into out, which must hold h*w*3 bytes).
int vadio_decode(const char* path, uint8_t* out, int h, int w) {
  return decode_file(path, out, h, w);
}

// Header probe of a .jpg/.jpeg/.png/.tif/.tiff: info = {height, width,
// channels, bit depth}. Returns 0, or a negative code.
int vadio_probe(const char* path, int* info) { return probe_file(path, info); }

// A PNG as stored (see decode_png_unchanged); out holds h*w*c*depth/8 bytes.
int vadio_decode_png(const char* path, void* out, int h, int w, int c,
                     int depth) {
  return decode_png_unchanged(path, out, h, w, c, depth);
}

void* vadio_pool_create(int n_threads) { return new Pool(n_threads); }
void vadio_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Decode n files in parallel into out (n*h*w*3 bytes). Returns the number
// of files that failed to decode (0 == all good).
int vadio_pool_decode_batch(void* pool, const char* const* paths, int n,
                            uint8_t* out, int h, int w) {
  return static_cast<Pool*>(pool)->run(paths, n, out, h, w);
}

// ---------------------------------------------------------------------------
// Background prefetcher: double-buffered chunk pipeline over a file list.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  Pool pool;
  int chunk, h, w;
  size_t pos = 0;
  std::vector<uint8_t> buf_next;
  std::thread th;
  bool pending = false;
  int pending_count = 0;
  std::atomic<int> pending_errors{0};

  Prefetcher(const char* const* p, int n, int chunk_, int h_, int w_,
             int threads)
      : pool(threads), chunk(chunk_), h(h_), w(w_) {
    paths.reserve(n);
    for (int i = 0; i < n; ++i) paths.emplace_back(p[i]);
    buf_next.resize((size_t)chunk * h * w * 3);
    kick();
  }
  ~Prefetcher() {
    if (th.joinable()) th.join();
  }

  void kick() {
    int count = (int)std::min((size_t)chunk, paths.size() - pos);
    pending_count = count;
    if (count == 0) {
      pending = false;
      return;
    }
    pending = true;
    std::vector<const char*> ptrs(count);
    for (int i = 0; i < count; ++i) ptrs[i] = paths[pos + i].c_str();
    pos += count;
    th = std::thread([this, ptrs = std::move(ptrs), count]() mutable {
      pending_errors.store(
          pool.run(ptrs.data(), count, buf_next.data(), h, w));
    });
  }

  // Wait for the in-flight chunk, copy into out, start the next one.
  // Returns the chunk size, 0 at end of stream, or -errors when any frame
  // in the chunk failed to decode (buffer contents are then unreliable).
  int next(uint8_t* out) {
    if (!pending) return 0;
    th.join();
    int count = pending_count;
    int errs = pending_errors.load();
    memcpy(out, buf_next.data(), (size_t)count * h * w * 3);
    kick();
    return errs > 0 ? -errs : count;
  }
};

void* vadio_prefetcher_create(const char* const* paths, int n, int chunk,
                              int h, int w, int threads) {
  return new Prefetcher(paths, n, chunk, h, w, threads);
}
void vadio_prefetcher_destroy(void* pf) { delete static_cast<Prefetcher*>(pf); }
int vadio_prefetcher_next(void* pf, uint8_t* out) {
  return static_cast<Prefetcher*>(pf)->next(out);
}

}  // extern "C"
