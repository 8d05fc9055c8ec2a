// Baseline JPEG decoder for the LLFF loader (data/jpeg.py binds it with
// ctypes): the pixels of imageio.v2.imread, whose Pillow decodes with
// libjpeg-turbo's defaults, bit for bit.
//
// It decodes baseline sequential DCT files (SOF0, and SOF1 with 8-bit
// samples): Huffman tables from DHT (optimised tables too), 8- and 16-bit
// quantisation tables, restart intervals (DRI, RST0-7), one scan of 1 or 3
// components, luma sampling 1x1, 2x1 or 2x2 over 1x1 chroma, any size.
// Each step is computed as libjpeg-turbo's C code computes it, which its
// SIMD code matches bit for bit:
//   - the integer "islow" IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2,
//     its FIX() constants, its zero-AC shortcuts and its range-limit
//     table, jdmaster.c::prepare_range_limit_table);
//   - "fancy" triangular chroma upsampling, jdsample.c: h2v1 with the
//     +1/+2 biases, h2v2 with +8/+7 and its context rows across MCU-row
//     boundaries, the first and last chroma rows replicated
//     (jdmainct.c), edge columns special-cased; plain replication when
//     the chroma width is 2 or less, as jinit_upsampler chooses;
//   - YCbCr -> RGB through jdcolor.c's fixed-point tables (SCALEBITS 16).
// The colour space is chosen as jdapimin.c::default_decompress_parms
// chooses it; APPn segments (EXIF orientation included) are otherwise
// skipped, as imageio skips them.
//
// It refuses, with a message naming the feature: progressive (SOF2),
// lossless (SOF3), hierarchical (SOF5-7) and arithmetic-coded (SOF9-15,
// DAC) files, precision other than 8 bits, 2 or 4 components (CMYK, YCCK),
// RGB-coded files (Adobe transform 0, component ids 'R' 'G' 'B'), other
// sampling factors, several scans, and a truncated or corrupt stream
// (where libjpeg would warn and pad, this is an error).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC jpeg_decoder.cc (ops/_build.py);
// no library beyond the C++ standard library.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Fault : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Fault(what); }

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

std::vector<uint8_t> read_file(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) fail("cannot be opened");
  std::vector<uint8_t> out;
  bool ok = std::fseek(fp, 0, SEEK_END) == 0;
  long size = ok ? std::ftell(fp) : -1;
  ok = ok && size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    out.resize(static_cast<size_t>(size));
    ok = std::fread(out.data(), 1, out.size(), fp) == out.size();
  }
  std::fclose(fp);
  if (!ok) fail("cannot be read");
  return out;
}

// ---------------------------------------------------------------- tables

struct Huffman {
  bool defined = false;
  int maxcode[18];      // largest code of each length, -1 if none
  int valoffset[17];    // symbol index = code + valoffset[length]
  uint8_t values[256];
  uint8_t fast_len[512];  // 9-bit lookahead: code length (0 = longer)
  uint8_t fast_sym[512];
};

// jdhuff.c::jpeg_make_d_derived_tbl, with its checks.
void build_huffman(Huffman* t, const uint8_t* counts, const uint8_t* values,
                   int total, bool dc) {
  uint8_t size[257];
  int code[256];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) size[p++] = static_cast<uint8_t>(l);
  size[p] = 0;
  int c = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1 << si)) fail("corrupt Huffman table (DHT)");
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t->valoffset[l] = p - code[p];
      p += counts[l - 1];
      t->maxcode[l] = code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0x7fffffff;
  std::memcpy(t->values, values, total);
  std::memset(t->fast_len, 0, sizeof(t->fast_len));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      const int first = code[p] << (9 - l);
      for (int j = 0; j < (1 << (9 - l)); ++j) {
        t->fast_len[first + j] = static_cast<uint8_t>(l);
        t->fast_sym[first + j] = values[p];
      }
    }
  }
  if (dc)
    for (int i = 0; i < total; ++i)
      if (values[i] > 15) fail("corrupt Huffman table (DHT): DC symbol > 15");
  t->defined = true;
}

// jdmaster.c::prepare_range_limit_table, the part the IDCT indexes: the
// descaled value masked to 10 bits, offset by CENTERJSAMPLE.
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int k = 0; k < 1024; ++k) {
      if (k < 128) idct[k] = static_cast<uint8_t>(k + 128);
      else if (k < 512) idct[k] = 255;
      else if (k < 896) idct[k] = 0;
      else idct[k] = static_cast<uint8_t>(k - 896);
    }
  }
};

// jdcolor.c::build_ycc_rgb_table.
struct ColourTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColourTables() {
    const int64_t half = int64_t(1) << 15;
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << 16) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const RangeLimit& range_limit() {
  static const RangeLimit table;
  return table;
}

const ColourTables& colour_tables() {
  static const ColourTables table;
  return table;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ------------------------------------------------------------------ IDCT

// jidctint.c::jpeg_idct_islow: coef and quant in natural order; writes an
// 8x8 block at out with row stride `stride`.
void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out,
                int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                    F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                    F1961 = 16069, F2053 = 16819, F2562 = 20995,
                    F3072 = 25172;
  auto descale = [](int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
  };
  const uint8_t* limit = range_limit().idct;
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* in = coef + col;
    const int16_t* q = quant + col;
    int* w = ws + col;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      const int dc = (int(in[0]) * int(q[0])) * (1 << kPass1);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int(in[16]) * int(q[16]), z3 = int(in[48]) * int(q[48]);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int(in[0]) * int(q[0]);
    z3 = int(in[32]) * int(q[32]);
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConst);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int(in[56]) * int(q[56]);
    tmp1 = int(in[40]) * int(q[40]);
    tmp2 = int(in[24]) * int(q[24]);
    tmp3 = int(in[8]) * int(q[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConst - kPass1;
    w[0] = int(descale(tmp10 + tmp3, n));
    w[56] = int(descale(tmp10 - tmp3, n));
    w[8] = int(descale(tmp11 + tmp2, n));
    w[48] = int(descale(tmp11 - tmp2, n));
    w[16] = int(descale(tmp12 + tmp1, n));
    w[40] = int(descale(tmp12 - tmp1, n));
    w[24] = int(descale(tmp13 + tmp0, n));
    w[32] = int(descale(tmp13 - tmp0, n));
  }
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + static_cast<size_t>(row) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      const uint8_t dc = limit[descale(w[0], kPass1 + 3) & 1023];
      std::memset(o, dc, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConst);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConst + kPass1 + 3;
    o[0] = limit[descale(tmp10 + tmp3, n) & 1023];
    o[7] = limit[descale(tmp10 - tmp3, n) & 1023];
    o[1] = limit[descale(tmp11 + tmp2, n) & 1023];
    o[6] = limit[descale(tmp11 - tmp2, n) & 1023];
    o[2] = limit[descale(tmp12 + tmp1, n) & 1023];
    o[5] = limit[descale(tmp12 - tmp1, n) & 1023];
    o[3] = limit[descale(tmp13 + tmp0, n) & 1023];
    o[4] = limit[descale(tmp13 - tmp0, n) & 1023];
  }
}

// ------------------------------------------------------------ bit reader

// The entropy-coded bytes from `p`: 0xFF00 is a stuffed 0xFF, any other
// 0xFF pair is a marker, where the reader stops and feeds zero bits.
// Taking a zero bit fed past the data is a fault (a truncated or corrupt
// stream); peeking at them is not.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;  // valid bits, the newest at the bottom of buf
  int pad = 0;   // of which zero bits fed past the data
  bool stopped = false;

  BitReader(const uint8_t* begin, const uint8_t* finish)
      : p(begin), end(finish) {}

  void refill() {
    while (bits <= 56) {
      int byte = 0;
      if (!stopped) {
        if (p >= end) {
          stopped = true;
        } else if (*p != 0xFF) {
          byte = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0x00) {
            byte = 0xFF;
            p = q + 1;
          } else {
            p = q - 1;  // at the marker's last 0xFF
            stopped = true;
          }
        }
      }
      if (stopped) pad += 8;
      buf = (buf << 8) | static_cast<uint64_t>(byte);
      bits += 8;
    }
  }

  inline uint32_t peek(int n) {
    if (bits < n) refill();
    return static_cast<uint32_t>(buf >> (bits - n)) & ((1u << n) - 1);
  }

  inline void skip(int n) {
    bits -= n;
    if (bits < pad) fail("truncated or corrupt entropy-coded data");
  }

  inline int take(int n) {
    const int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }

  // Only the byte-alignment padding of the MCUs read so far may precede
  // the next marker; `where` names the place in a fault's message.
  void to_marker(const char* where) {
    if (bits - pad >= 8) fail(std::string("corrupt data ") + where);
    if (!stopped) {
      buf = 0;
      bits = pad = 0;
      refill();
      if (bits != pad) fail(std::string("corrupt data ") + where);
    }
  }

  // Expect the marker RST<n> and start reading after it.
  void restart(int n) {
    to_marker("before a restart marker");
    if (!(p + 1 < end && p[0] == 0xFF && p[1] == 0xD0 + n))
      fail("restart marker RST" + std::to_string(n) + " missing");
    p += 2;
    buf = 0;
    bits = pad = 0;
    stopped = false;
  }

  // After the scan: the position of the marker that follows it.
  const uint8_t* finish() {
    to_marker("at the end of the scan");
    if (p >= end) fail("truncated file: no EOI marker after the scan");
    return p;
  }
};

inline int decode_symbol(BitReader* br, const Huffman& t) {
  if (br->bits < 16) br->refill();
  const uint32_t look = br->peek(16);
  const int fast = t.fast_len[look >> 7];
  if (fast) {
    br->skip(fast);
    return t.fast_sym[look >> 7];
  }
  for (int l = 10; l <= 16; ++l) {
    const int code = static_cast<int>(look >> (16 - l));
    if (code <= t.maxcode[l]) {
      br->skip(l);
      return t.values[code + t.valoffset[l]];
    }
  }
  fail("corrupt entropy-coded data: no Huffman code matches");
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ----------------------------------------------------------------- frame

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_table = 0, ac_table = 0;
  int bw = 0, bh = 0;         // blocks across and down in the plane
  int width = 0, height = 0;  // downsampled size (jdinput.c)
  std::vector<uint8_t> plane;  // bw * 8 x bh * 8 samples
  int dc_pred = 0;
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool have_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  Component comp[3];
  int16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  int scans = 0;
};

int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

std::string hex(int marker) {
  char buf[8];
  std::snprintf(buf, sizeof(buf), "0x%02X", marker);
  return buf;
}

void refuse_frame(int m) {
  if (m == 0xC2)
    fail("progressive JPEG (SOF2) is not supported: baseline sequential "
         "only");
  if (m == 0xC3) fail("lossless JPEG (SOF3) is not supported");
  if (m >= 0xC5 && m <= 0xC7)
    fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
         ") is not supported");
  if (m >= 0xC9 && m <= 0xCF)
    fail("arithmetic coding (SOF" + std::to_string(m - 0xC0) +
         ") is not supported");
}

void parse_frame(Jpeg* j, const uint8_t* s, int len) {
  if (j->have_frame) fail("corrupt file: two SOF markers");
  if (len < 6) fail("corrupt SOF segment");
  const int precision = s[0];
  if (precision != 8)
    fail(std::to_string(precision) + "-bit precision is not supported: "
         "8-bit samples only");
  j->height = be16(s + 1);
  j->width = be16(s + 3);
  j->ncomp = s[5];
  if (j->height == 0)
    fail("a height given by a DNL marker is not supported");
  if (j->width == 0) fail("corrupt SOF segment: width 0");
  if (j->ncomp == 2 || j->ncomp == 4)
    fail(std::to_string(j->ncomp) + " components" +
         (j->ncomp == 4 ? " (CMYK or YCCK)" : "") +
         " are not supported: greyscale or YCbCr only");
  if (j->ncomp != 1 && j->ncomp != 3)
    fail(std::to_string(j->ncomp) + " components are not supported");
  if (len < 6 + 3 * j->ncomp) fail("corrupt SOF segment");
  for (int c = 0; c < j->ncomp; ++c) {
    Component& k = j->comp[c];
    k.id = s[6 + 3 * c];
    k.h = s[7 + 3 * c] >> 4;
    k.v = s[7 + 3 * c] & 15;
    k.tq = s[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
      fail("corrupt SOF segment: sampling factors or table index");
  }
  if (j->ncomp == 1) {
    // one component: its factors do not matter (jdinput.c gives it the
    // full size), so its MCU is one block
    j->comp[0].h = j->comp[0].v = 1;
  }
  for (int c = 0; c < j->ncomp; ++c) {
    j->hmax = std::max(j->hmax, j->comp[c].h);
    j->vmax = std::max(j->vmax, j->comp[c].v);
  }
  if (j->ncomp == 3) {
    const Component &y = j->comp[0], &cb = j->comp[1], &cr = j->comp[2];
    const bool ok = y.h == j->hmax && y.v == j->vmax && cb.h == cr.h &&
                    cb.v == cr.v && j->hmax % cb.h == 0 &&
                    j->vmax % cb.v == 0;
    const int hr = ok ? j->hmax / cb.h : 0, vr = ok ? j->vmax / cb.v : 0;
    if (!ok || !((hr == 1 && vr == 1) || (hr == 2 && vr == 1) ||
                 (hr == 2 && vr == 2)))
      fail("sampling factors " + std::to_string(y.h) + "x" +
           std::to_string(y.v) + ", " + std::to_string(cb.h) + "x" +
           std::to_string(cb.v) + ", " + std::to_string(cr.h) + "x" +
           std::to_string(cr.v) +
           " are not supported: 4:4:4, 4:2:2 or 4:2:0 only");
  }
  const int mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  const int mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int c = 0; c < j->ncomp; ++c) {
    Component& k = j->comp[c];
    k.width = (j->width * k.h + j->hmax - 1) / j->hmax;
    k.height = (j->height * k.v + j->vmax - 1) / j->vmax;
    k.bw = mcux * k.h;
    k.bh = mcuy * k.v;
  }
  j->have_frame = true;
}

void check_colour_space(const Jpeg& j) {
  if (j.ncomp != 3) return;
  // jdapimin.c::default_decompress_parms
  if (j.saw_jfif) return;
  if (j.saw_adobe) {
    if (j.adobe_transform == 0)
      fail("RGB-coded JPEG (Adobe transform 0) is not supported: YCbCr "
           "only");
    return;
  }
  if (j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B')
    fail("RGB-coded JPEG (component ids R, G, B) is not supported: YCbCr "
         "only");
}

void parse_huffman(Jpeg* j, const uint8_t* s, int len) {
  int pos = 0;
  while (pos < len) {
    if (pos + 17 > len) fail("corrupt DHT segment");
    const int tc = s[pos] >> 4, th = s[pos] & 15;
    if (tc > 1 || th > 3) fail("corrupt DHT segment: table class or index");
    int total = 0;
    for (int i = 0; i < 16; ++i) total += s[pos + 1 + i];
    if (total > 256 || pos + 17 + total > len) fail("corrupt DHT segment");
    build_huffman(tc == 0 ? &j->dc[th] : &j->ac[th], s + pos + 1,
                  s + pos + 17, total, tc == 0);
    pos += 17 + total;
  }
}

void parse_quant(Jpeg* j, const uint8_t* s, int len) {
  int pos = 0;
  while (pos < len) {
    const int pq = s[pos] >> 4, tq = s[pos] & 15;
    if (pq > 1 || tq > 3) fail("corrupt DQT segment");
    const int size = pq ? 128 : 64;
    if (pos + 1 + size > len) fail("corrupt DQT segment");
    for (int i = 0; i < 64; ++i) {
      const int v = pq ? be16(s + pos + 1 + 2 * i) : s[pos + 1 + i];
      // ISLOW_MULT_TYPE is a short
      j->quant[tq][kNatural[i]] = static_cast<int16_t>(v);
    }
    j->quant_defined[tq] = true;
    pos += 1 + size;
  }
}

void decode_block(BitReader* br, Component* k, const Jpeg& j, int bx,
                  int by) {
  const Huffman& dct = j.dc[k->dc_table];
  const Huffman& act = j.ac[k->ac_table];
  int16_t coef[64] = {0};
  const int s = decode_symbol(br, dct);
  int diff = 0;
  if (s) diff = extend(br->take(s), s);
  k->dc_pred += diff;
  coef[0] = static_cast<int16_t>(k->dc_pred);
  for (int i = 1; i < 64; ++i) {
    const int rs = decode_symbol(br, act);
    const int r = rs >> 4, size = rs & 15;
    if (size) {
      i += r;
      if (i > 63) fail("corrupt entropy-coded data: coefficient past 63");
      coef[kNatural[i]] = static_cast<int16_t>(extend(br->take(size), size));
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
  const size_t stride = static_cast<size_t>(k->bw) * 8;
  idct_islow(coef, j.quant[k->tq],
             k->plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8,
             static_cast<int>(stride));
}

// Decode the scan whose header is s[0..len) and whose data starts at
// `data`; returns the position of the marker after it.
const uint8_t* decode_scan(Jpeg* j, const uint8_t* s, int len,
                           const uint8_t* data, const uint8_t* end) {
  if (!j->have_frame) fail("corrupt file: SOS before SOF");
  if (len < 1) fail("corrupt SOS segment");
  const int ns = s[0];
  if (len < 4 + 2 * ns) fail("corrupt SOS segment");
  if (ns != j->ncomp)
    fail("a baseline file with several scans is not supported (this scan "
         "holds " + std::to_string(ns) + " of " + std::to_string(j->ncomp) +
         " components)");
  Component* order[3];
  for (int i = 0; i < ns; ++i) {
    const int id = s[1 + 2 * i];
    Component* k = nullptr;
    for (int c = 0; c < j->ncomp; ++c)
      if (j->comp[c].id == id) k = &j->comp[c];
    if (!k) fail("corrupt SOS segment: unknown component");
    for (int p = 0; p < i; ++p)
      if (order[p] == k) fail("corrupt SOS segment: repeated component");
    k->dc_table = s[2 + 2 * i] >> 4;
    k->ac_table = s[2 + 2 * i] & 15;
    if (k->dc_table > 3 || k->ac_table > 3 || !j->dc[k->dc_table].defined ||
        !j->ac[k->ac_table].defined)
      fail("corrupt file: a scan uses an undefined Huffman table");
    if (!j->quant_defined[k->tq])
      fail("corrupt file: a component uses an undefined quantisation "
           "table");
    order[i] = k;
  }
  const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], a = s[3 + 2 * ns];
  if (ss != 0 || se != 63 || a != 0)
    fail("corrupt SOS segment: a sequential scan must cover coefficients "
         "0-63");
  check_colour_space(*j);
  for (int c = 0; c < j->ncomp; ++c) {
    Component& k = j->comp[c];
    if (j->ncomp == 1) {
      // a non-interleaved scan covers only the blocks that hold samples
      k.bw = (k.width + 7) / 8;
      k.bh = (k.height + 7) / 8;
    }
    k.plane.assign(static_cast<size_t>(k.bw) * 8 * k.bh * 8, 0);
    k.dc_pred = 0;
  }
  BitReader br(data, end);
  const int mcux = j->ncomp == 1 ? j->comp[0].bw : j->comp[0].bw / j->comp[0].h;
  const int mcuy = j->ncomp == 1 ? j->comp[0].bh : j->comp[0].bh / j->comp[0].v;
  const long total = static_cast<long>(mcux) * mcuy;
  int restarts = 0;
  for (long m = 0; m < total; ++m) {
    if (j->restart_interval && m > 0 && m % j->restart_interval == 0) {
      br.restart(restarts & 7);
      ++restarts;
      for (int c = 0; c < j->ncomp; ++c) j->comp[c].dc_pred = 0;
    }
    const int mx = static_cast<int>(m % mcux), my = static_cast<int>(m / mcux);
    for (int i = 0; i < ns; ++i) {
      Component* k = order[i];
      for (int v = 0; v < k->v; ++v)
        for (int h = 0; h < k->h; ++h)
          decode_block(&br, k, *j, mx * k->h + h, my * k->v + v);
    }
  }
  ++j->scans;
  return br.finish();
}

// Parse the markers from SOI; with `decode`, decode the scan and stop at
// EOI, else stop after SOF (the probe).
void parse(const std::vector<uint8_t>& file, Jpeg* j, bool decode) {
  const uint8_t* p = file.data();
  const uint8_t* end = p + file.size();
  if (file.size() < 2 || p[0] != 0xFF || p[1] != 0xD8)
    fail("not a JPEG file (no SOI marker)");
  p += 2;
  for (;;) {
    if (p >= end) fail("truncated file: no EOI marker");
    if (*p != 0xFF) fail("corrupt file: a marker expected at offset " +
                         std::to_string(p - file.data()));
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) fail("truncated file: no EOI marker");
    const int m = *p++;
    if (m == 0xD9) {  // EOI
      if (!j->scans) fail("corrupt file: no image data before EOI");
      return;
    }
    if (m == 0xD8) fail("corrupt file: a second SOI marker");
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn
    if (p + 2 > end) fail("truncated file inside a marker segment");
    const int len = be16(p) - 2;
    if (len < 0 || p + 2 + len > end)
      fail("truncated file inside a marker segment (" + hex(m) + ")");
    const uint8_t* s = p + 2;
    p = s + len;
    if (m == 0xC0 || m == 0xC1) {
      parse_frame(j, s, len);
      if (!decode) {
        check_colour_space(*j);
        return;
      }
    } else if ((m >= 0xC2 && m <= 0xC3) || (m >= 0xC5 && m <= 0xC7) ||
               (m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF)) {
      refuse_frame(m);
    } else if (m == 0xCC) {
      fail("arithmetic coding (DAC) is not supported");
    } else if (m == 0xC4) {
      parse_huffman(j, s, len);
    } else if (m == 0xDB) {
      parse_quant(j, s, len);
    } else if (m == 0xDD) {
      if (len < 2) fail("corrupt DRI segment");
      j->restart_interval = be16(s);
    } else if (m == 0xDA) {
      if (j->scans)
        fail("a baseline file with several scans is not supported");
      p = decode_scan(j, s, len, p, end);
    } else if (m == 0xE0) {
      if (len >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) j->saw_jfif = true;
    } else if (m == 0xEE) {
      if (len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        j->saw_adobe = true;
        j->adobe_transform = s[11];
      }
    } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
      // other APPn, COM and DNL: skipped
    } else {
      fail("corrupt file: unknown marker " + hex(m));
    }
  }
}

// The decoded planes into out: [H, W] for greyscale, [H, W, 3] RGB.
void to_pixels(const Jpeg& j, uint8_t* out) {
  const int W = j.width, H = j.height;
  const Component& y = j.comp[0];
  const size_t ys = static_cast<size_t>(y.bw) * 8;
  if (j.ncomp == 1) {
    for (int r = 0; r < H; ++r)
      std::memcpy(out + static_cast<size_t>(r) * W,
                  y.plane.data() + r * ys, W);
    return;
  }
  const Component &cb = j.comp[1], &cr = j.comp[2];
  const size_t cs = static_cast<size_t>(cb.bw) * 8;
  const int hr = j.hmax / cb.h, vr = j.vmax / cb.v;
  const int cw = cb.width, ch = cb.height;
  // jinit_upsampler: fancy only where the chroma row is wider than 2
  const bool fancy = cw > 2;
  const ColourTables& t = colour_tables();
  std::vector<uint8_t> ub(static_cast<size_t>(2) * cw + 2),
      ur(static_cast<size_t>(2) * cw + 2);
  std::vector<int> sum_b(cw), sum_r(cw);
  for (int r = 0; r < H; ++r) {
    const uint8_t* yrow = y.plane.data() + r * ys;
    const uint8_t *brow, *rrow;
    if (hr == 1) {  // 4:4:4
      brow = cb.plane.data() + r * cs;
      rrow = cr.plane.data() + r * cs;
    } else if (vr == 1) {  // 4:2:2, jdsample.c::h2v1_fancy_upsample
      const uint8_t* in[2] = {cb.plane.data() + r * cs,
                              cr.plane.data() + r * cs};
      uint8_t* o[2] = {ub.data(), ur.data()};
      for (int c = 0; c < 2; ++c) {
        const uint8_t* a = in[c];
        uint8_t* b = o[c];
        if (!fancy) {
          for (int i = 0; i < cw; ++i) b[2 * i] = b[2 * i + 1] = a[i];
          continue;
        }
        b[0] = a[0];
        b[1] = static_cast<uint8_t>((a[0] * 3 + a[1] + 2) >> 2);
        for (int i = 1; i < cw - 1; ++i) {
          const int v = a[i] * 3;
          b[2 * i] = static_cast<uint8_t>((v + a[i - 1] + 1) >> 2);
          b[2 * i + 1] = static_cast<uint8_t>((v + a[i + 1] + 2) >> 2);
        }
        b[2 * cw - 2] = static_cast<uint8_t>((a[cw - 1] * 3 + a[cw - 2] + 1)
                                             >> 2);
        b[2 * cw - 1] = a[cw - 1];
      }
      brow = ub.data();
      rrow = ur.data();
    } else {  // 4:2:0, jdsample.c::h2v2_fancy_upsample
      const int near = r / 2;
      int far = (r & 1) ? near + 1 : near - 1;
      far = std::min(std::max(far, 0), ch - 1);  // jdmainct.c's context
      const uint8_t* in[2][2] = {
          {cb.plane.data() + near * cs, cb.plane.data() + far * cs},
          {cr.plane.data() + near * cs, cr.plane.data() + far * cs}};
      uint8_t* o[2] = {ub.data(), ur.data()};
      int* sums[2] = {sum_b.data(), sum_r.data()};
      for (int c = 0; c < 2; ++c) {
        uint8_t* b = o[c];
        if (!fancy) {  // jdsample.c::h2v2_upsample
          for (int i = 0; i < cw; ++i)
            b[2 * i] = b[2 * i + 1] = in[c][0][i];
          continue;
        }
        int* sum = sums[c];
        for (int i = 0; i < cw; ++i) sum[i] = in[c][0][i] * 3 + in[c][1][i];
        b[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
        b[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
        for (int i = 1; i < cw - 1; ++i) {
          const int v = sum[i] * 3;
          b[2 * i] = static_cast<uint8_t>((v + sum[i - 1] + 8) >> 4);
          b[2 * i + 1] = static_cast<uint8_t>((v + sum[i + 1] + 7) >> 4);
        }
        b[2 * cw - 2] = static_cast<uint8_t>((sum[cw - 1] * 3 + sum[cw - 2]
                                              + 8) >> 4);
        b[2 * cw - 1] = static_cast<uint8_t>((sum[cw - 1] * 4 + 7) >> 4);
      }
      brow = ub.data();
      rrow = ur.data();
    }
    // jdcolor.c::ycc_rgb_convert
    uint8_t* o = out + static_cast<size_t>(r) * W * 3;
    for (int x = 0; x < W; ++x) {
      const int Y = yrow[x], B = brow[x], R = rrow[x];
      o[3 * x] = clamp255(Y + t.cr_r[R]);
      o[3 * x + 1] = clamp255(
          Y + static_cast<int>((t.cb_g[B] + t.cr_g[R]) >> 16));
      o[3 * x + 2] = clamp255(Y + t.cb_b[B]);
    }
  }
}

void copy_error(const std::string& what, char* err, int errlen) {
  if (!err || errlen <= 0) return;
  const size_t n = std::min(what.size(), static_cast<size_t>(errlen - 1));
  std::memcpy(err, what.data(), n);
  err[n] = '\0';
}

int decode_file(const char* path, uint8_t* out, int height, int width,
                int channels, char* err, int errlen) {
  try {
    const std::vector<uint8_t> file = read_file(path);
    Jpeg j;
    parse(file, &j, true);
    const int c = j.ncomp == 1 ? 1 : 3;
    if (j.height != height || j.width != width || c != channels)
      fail("decodes to " + std::to_string(j.height) + "x" +
           std::to_string(j.width) + "x" + std::to_string(c) +
           ", not the probed shape");
    to_pixels(j, out);
    return 0;
  } catch (const Fault& e) {
    copy_error(e.what(), err, errlen);
  } catch (const std::exception& e) {
    copy_error(std::string("decoder error: ") + e.what(), err, errlen);
  }
  return 1;
}

}  // namespace

extern "C" {

// (height, width, channels) of the JPEG at `path` from its headers, where
// channels is 1 (greyscale) or 3 (YCbCr, decoded to RGB).  Returns 0, or 1
// with a message in err for a file the decoder cannot read.
int jpeg_probe(const char* path, int* height, int* width, int* channels,
               char* err, int errlen) {
  try {
    const std::vector<uint8_t> file = read_file(path);
    Jpeg j;
    parse(file, &j, false);
    if (!j.have_frame) fail("corrupt file: no SOF marker");
    *height = j.height;
    *width = j.width;
    *channels = j.ncomp == 1 ? 1 : 3;
    return 0;
  } catch (const Fault& e) {
    copy_error(e.what(), err, errlen);
  } catch (const std::exception& e) {
    copy_error(std::string("decoder error: ") + e.what(), err, errlen);
  }
  return 1;
}

// Decode n files on `num_threads` threads, each file whole on one thread:
// file i into outs[i], shape shapes[3i..3i+2] (height, width, channels as
// jpeg_probe gives them; [H, W] for 1 channel, [H, W, 3] else).  A failed
// file's message goes to errs + i * errlen.  Returns the number of files
// that failed, or -1 for a bad argument.
int jpeg_decode_batch(const char** paths, int n, uint8_t** outs,
                      const int* shapes, int num_threads, char* errs,
                      int errlen) {
  if (n < 0 || errlen < 0) return -1;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      if (decode_file(paths[i], outs[i], shapes[3 * i], shapes[3 * i + 1],
                      shapes[3 * i + 2],
                      errs ? errs + static_cast<size_t>(i) * errlen : nullptr,
                      errlen))
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
