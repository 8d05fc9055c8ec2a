// Native SRN view loader: a threaded PNG decode, then the mask, the crop
// and the /255 normalisation into caller-owned float32 buffers (the port's
// counterpart of the JAX package's native/srn_loader.cc, bound by ctypes
// from data/native.py).
//
// The decode is written on zlib's inflate, with the five PNG row filters
// undone here, so the loader needs zlib and nothing else (no libpng).  It
// reads exactly what data/png.py::read_png reads: non-interlaced, 8 bits
// per sample, greyscale, RGB or RGBA; every chunk's CRC is checked, and
// any other format, a bad CRC or a short or corrupt stream is a failure.
//
// Each view becomes, as data/srn.py::SRNDataset.__getitem__ computes it:
//   mask  = 1 where every channel != 255 (reference dataset.py:72);
//   color = the 8-bit value / 255 in float32 (a division, so the value is
//           bit-identical to numpy's float32 `rgb / 255.0`);
// over the crop window rows [row0, row0 + rows), columns [col0, col0 +
// cols) that the caller computes (reference dataset.py:76-78).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC srn_loader.cc -lz (ops/_build.py).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> data;  // height * width * channels
  int width = 0;
  int height = 0;
  int channels = 0;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  bool ok = std::fseek(fp, 0, SEEK_END) == 0;
  long size = ok ? std::ftell(fp) : -1;
  ok = ok && size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    out->resize(static_cast<size_t>(size));
    ok = std::fread(out->data(), 1, out->size(), fp) == out->size();
  }
  std::fclose(fp);
  return ok;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int channels_of(int colour_type) {
  switch (colour_type) {
    case 0: return 1;  // greyscale
    case 2: return 3;  // RGB
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

// Walk the chunks: IHDR into `img`'s geometry, the IDAT bodies
// concatenated into `idat`.  Stops after IEND; false on any fault, or
// with `header_only` once IHDR is read.
bool parse_chunks(const std::vector<uint8_t>& file, Image* img,
                  std::vector<uint8_t>* idat, bool header_only) {
  static const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G',
                                        '\r', '\n', 0x1a, '\n'};
  if (file.size() < 8 || std::memcmp(file.data(), kSignature, 8) != 0)
    return false;
  bool have_header = false;
  size_t pos = 8;
  while (pos + 8 <= file.size()) {
    const uint32_t length = be32(&file[pos]);
    const uint8_t* kind = &file[pos + 4];
    if (length > file.size() || pos + 12 + length > file.size()) return false;
    const uint8_t* body = &file[pos + 8];
    const uint32_t crc = be32(body + length);
    if (uint32_t(crc32(crc32(0L, kind, 4), body, length)) != crc) return false;
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (length != 13) return false;
      const uint32_t width = be32(body), height = be32(body + 4);
      const int depth = body[8], colour = body[9];
      const int compression = body[10], filter = body[11],
                interlace = body[12];
      img->channels = channels_of(colour);
      if (depth != 8 || img->channels == 0 || compression != 0 ||
          filter != 0 || interlace != 0 || width == 0 || height == 0 ||
          width > (1u << 15) || height > (1u << 15))
        return false;
      img->width = static_cast<int>(width);
      img->height = static_cast<int>(height);
      have_header = true;
      if (header_only) return true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      idat->insert(idat->end(), body, body + length);
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      return have_header;
    }
    pos += 12 + length;
  }
  return false;  // no IEND
}

uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undo each row's filter (PNG spec section 9) from `raw` (height rows of
// 1 + stride bytes) into `out` (height rows of stride bytes).
bool unfilter(const uint8_t* raw, int height, int stride, int bpp,
              uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw + static_cast<size_t>(y) * (stride + 1);
    const int kind = src[0];
    ++src;
    uint8_t* row = out + static_cast<size_t>(y) * stride;
    const uint8_t* up = y > 0 ? row - stride : nullptr;
    switch (kind) {
      case 0:
        std::memcpy(row, src, stride);
        break;
      case 1:
        for (int x = 0; x < stride; ++x)
          row[x] = src[x] + (x >= bpp ? row[x - bpp] : 0);
        break;
      case 2:
        for (int x = 0; x < stride; ++x) row[x] = src[x] + (up ? up[x] : 0);
        break;
      case 3:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          row[x] = src[x] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          row[x] = src[x] + paeth(a, b, c);
        }
        break;
      default:
        return false;
    }
  }
  return true;
}

bool decode_png(const char* path, Image* img) {
  std::vector<uint8_t> file, idat;
  if (!read_file(path, &file) || !parse_chunks(file, img, &idat, false))
    return false;
  const int stride = img->width * img->channels;
  const size_t raw_size = static_cast<size_t>(img->height) * (stride + 1);
  std::vector<uint8_t> raw(raw_size + 1);  // one spare byte: no overlong data
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  const int rc = inflate(&zs, Z_FINISH);
  const size_t produced = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || produced != raw_size) return false;
  img->data.resize(static_cast<size_t>(img->height) * stride);
  return unfilter(raw.data(), img->height, stride, img->channels,
                  img->data.data());
}

// Decode one view and write its cropped colour and mask.
bool load_view(const char* path, int height, int width, int channels,
               int row0, int rows, int col0, int cols, float* color_out,
               float* mask_out) {
  Image img;
  if (!decode_png(path, &img)) return false;
  if (img.height != height || img.width != width || img.channels != channels)
    return false;
  const int C = channels;
  for (int y = 0; y < rows; ++y) {
    const uint8_t* src =
        img.data.data() + (static_cast<size_t>(y + row0) * width + col0) * C;
    float* dst = color_out + static_cast<size_t>(y) * cols * C;
    float* mdst = mask_out + static_cast<size_t>(y) * cols;
    for (int x = 0; x < cols; ++x) {
      bool no_white = true;
      for (int c = 0; c < C; ++c) {
        const uint8_t v = src[x * C + c];
        dst[x * C + c] = static_cast<float>(v) / 255.0f;
        no_white = no_white && v != 255;
      }
      mdst[x] = no_white ? 1.0f : 0.0f;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// (height, width, channels) of the PNG at `path` from its IHDR chunk.
// Returns 0 on success.
int srn_probe(const char* path, int* height, int* width, int* channels) {
  std::vector<uint8_t> file, idat;
  Image img;
  if (!read_file(path, &file) || !parse_chunks(file, &img, &idat, true))
    return 1;
  *height = img.height;
  *width = img.width;
  *channels = img.channels;
  return 0;
}

// Load n views on `num_threads` threads.  Every file must decode to
// height x width x channels; the crop window is rows [row0, row0 + rows)
// and columns [col0, col0 + cols), inside the image.
//   colors_out: [n, rows, cols, channels] float32
//   masks_out:  [n, rows, cols, 1] float32
// Returns the number of views that failed (0 = success), or -1 for a bad
// argument.
int srn_load_batch(const char** paths, int n, int height, int width,
                   int channels, int row0, int rows, int col0, int cols,
                   int num_threads, float* colors_out, float* masks_out) {
  if (n < 0 || row0 < 0 || col0 < 0 || rows < 0 || cols < 0 ||
      row0 + rows > height || col0 + cols > width || channels < 1 ||
      channels > 4)
    return -1;
  const size_t color_stride = static_cast<size_t>(rows) * cols * channels;
  const size_t mask_stride = static_cast<size_t>(rows) * cols;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      if (!load_view(paths[i], height, width, channels, row0, rows, col0,
                     cols, colors_out + i * color_stride,
                     masks_out + i * mask_stride))
        failures.fetch_add(1);
    }
  };
  int nt = num_threads > 0 ? num_threads : 1;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
