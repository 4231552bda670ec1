// Host-side image decode for the port's data path, for hosts without
// OpenCV: the PNG row unfilter and a baseline JPEG decoder.
//
// PNG: the caller inflates the IDAT stream (zlib releases the GIL) and this
// file undoes the five row filters (None, Sub, Up, Average, Paeth) in one
// pass, writing RGB (an alpha channel is dropped, as cv2.imread drops it).
//
// JPEG: baseline and extended sequential Huffman coding, 8-bit samples, 1 or
// 3 components, any scans (interleaved or not), restart intervals, chroma
// sampled at 4:4:4, 4:2:2, 4:2:0 or 4:4:0. The arithmetic is libjpeg's
// defaults, which cv2.imread uses: the integer "islow" IDCT (jidctint.c),
// "fancy" triangular chroma upsampling (jdsample.c, with its box fallback
// for components two samples wide or less) and the fixed-point YCbCr->RGB
// tables (jdcolor.c), so the output equals cv2.imread's bit for bit.
// Progressive, lossless, hierarchical and arithmetic-coded files, other
// precisions and component counts raise; so does a file that ends before
// its last scan's data or its EOI marker. EXIF orientation is not applied.
//
// Built with g++ into dgod_tpu_torch/_build at first use and bound with
// ctypes (dgod_tpu_torch/data/native.py), which releases the GIL for the
// loader's worker threads.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- PNG ----

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// One row: `cur` = the filtered bytes `in` plus their predictor, where
// `prev` is the previous row undone (zeros above the first row).
bool unfilter_row(int kind, const uint8_t* in, uint8_t* cur,
                  const uint8_t* prev, int64_t n, int bpp) {
  switch (kind) {
    case 0:
      std::memcpy(cur, in, static_cast<size_t>(n));
      return true;
    case 1:
      for (int64_t i = 0; i < bpp; ++i) cur[i] = in[i];
      for (int64_t i = bpp; i < n; ++i)
        cur[i] = static_cast<uint8_t>(in[i] + cur[i - bpp]);
      return true;
    case 2:
      for (int64_t i = 0; i < n; ++i)
        cur[i] = static_cast<uint8_t>(in[i] + prev[i]);
      return true;
    case 3:
      for (int64_t i = 0; i < bpp; ++i)
        cur[i] = static_cast<uint8_t>(in[i] + (prev[i] >> 1));
      for (int64_t i = bpp; i < n; ++i)
        cur[i] = static_cast<uint8_t>(in[i] + ((cur[i - bpp] + prev[i]) >> 1));
      return true;
    case 4:
      for (int64_t i = 0; i < bpp; ++i)  // a = c = 0: the predictor is b
        cur[i] = static_cast<uint8_t>(in[i] + prev[i]);
      for (int64_t i = bpp; i < n; ++i)
        cur[i] = static_cast<uint8_t>(
            in[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
      return true;
    default:
      return false;
  }
}

// ---------------------------------------------------------------- JPEG ---

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run length past 63 lands here (libjpeg's guard entries)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // canonical decode (jdhuff.c jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t values[256];
  // 9-bit lookahead: (length << 8) | value, length 0 when the code is longer
  uint16_t look[1 << 9];

  void build(const uint8_t bits[17], const uint8_t* vals, int count) {
    std::memcpy(values, vals, count);
    uint16_t codes[256];
    uint8_t lens[256];
    int p = 0;
    uint32_t code = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = p - static_cast<int32_t>(code);
      for (int i = 0; i < bits[l]; ++i) {
        codes[p] = static_cast<uint16_t>(code);
        lens[p++] = static_cast<uint8_t>(l);
        ++code;
      }
      if (code > (1u << l)) throw Error("bad Huffman table");
      maxcode[l] = bits[l] ? static_cast<int32_t>(code) - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // sentinel: ends the slow search
    std::memset(look, 0, sizeof(look));
    for (int i = 0; i < p; ++i) {
      if (lens[i] > 9) continue;
      const int shift = 9 - lens[i];
      for (int j = 0; j < (1 << shift); ++j)
        look[(codes[i] << shift) | j] =
            static_cast<uint16_t>((lens[i] << 8) | values[i]);
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;  // the current scan's tables
  int dw = 0, dh = 0;  // downsampled size (libjpeg's downsampled_width/height)
  int bw = 0, bh = 0;  // blocks allocated in the plane
  int stride = 0;
  std::vector<uint8_t> plane;
  int pred = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t pos)
      : data_(data), size_(size), pos_(pos) {}

  size_t pos() const { return pos_; }

  // the bits of a restart boundary or the scan's end: drop the padding
  void reset(size_t pos) {
    pos_ = pos;
    buf_ = 0;
    count_ = 0;
    injected_ = 0;
    marker_ = false;
  }

  inline void fill() {
    while (count_ <= 56) {
      uint32_t byte = 0;
      if (!marker_ && pos_ < size_) {
        byte = data_[pos_];
        if (byte == 0xFF) {
          size_t q = pos_ + 1;
          while (q < size_ && data_[q] == 0xFF) ++q;  // fill bytes
          if (q < size_ && data_[q] == 0x00) {
            pos_ = q + 1;  // a stuffed 0xFF
          } else {
            marker_ = true;  // a marker (or the end): zeros from here on
            pos_ = q - 1;  // at the marker's last 0xFF
            byte = 0;
            injected_ += 8;
          }
        } else {
          ++pos_;
        }
      } else {
        if (pos_ >= size_) marker_ = true;
        injected_ += 8;
      }
      buf_ |= static_cast<uint64_t>(byte) << (56 - count_);
      count_ += 8;
    }
  }

  inline uint32_t peek(int n) {
    if (count_ < n) fill();
    return static_cast<uint32_t>(buf_ >> (64 - n));
  }
  inline void skip(int n) {
    if (n > count_ - injected_) overrun_ = true;
    buf_ <<= n;
    count_ -= n;
    if (injected_ > count_) injected_ = count_;
  }
  inline int get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }

  // the coded data ran out before the decode did
  bool overrun() const { return overrun_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_;
  uint64_t buf_ = 0;
  int count_ = 0;
  int injected_ = 0;  // zero bits at the buffer's end that are not data
  bool marker_ = false;
  bool overrun_ = false;
};

inline int decode_huffman(BitReader& br, const Huffman& t) {
  const uint32_t look = t.look[br.peek(9)];
  if (look) {
    br.skip(look >> 8);
    return look & 0xFF;
  }
  const uint32_t code16 = br.peek(16);
  int l = 10;
  while (l <= 16 && static_cast<int32_t>(code16 >> (16 - l)) > t.maxcode[l])
    ++l;
  if (l > 16) throw Error("corrupt JPEG data: bad Huffman code");
  br.skip(l);
  return t.values[static_cast<int32_t>(code16 >> (16 - l)) + t.valoffset[l]];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// libjpeg's range_limit for the IDCT's output: x & 1023 indexes a table that
// clamps [-512, 511] + 128 into [0, 255] (jdmaster.c prepare_range_limit_table)
struct IdctLimit {
  uint8_t t[1024];
  IdctLimit() {
    for (int i = 0; i < 1024; ++i) {
      const int x = i < 512 ? i : i - 1024;
      const int y = x + 128;
      t[i] = static_cast<uint8_t>(y < 0 ? 0 : (y > 255 ? 255 : y));
    }
  }
};
const IdctLimit kIdctLimit;

// jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F_0_298631336 = 2446, F_0_390180644 = 3196,
                  F_0_541196100 = 4433, F_0_765366865 = 6270,
                  F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137,
                  F_1_961570560 = 16069, F_2_053119869 = 16819,
                  F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int dc = (in[0] * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * q[16], z3 = in[48] * q[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = in[0] * q[0];
    z3 = in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = in[56] * q[56];
    tmp1 = in[40] * q[40];
    tmp2 = in[24] * q[24];
    tmp3 = in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    constexpr int n = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  const uint8_t* lim = kIdctLimit.t;
  constexpr int n2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t dc = lim[descale(w[0], kPass1Bits + 3) & 1023];
      std::memset(o, dc, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (int64_t{w[0]} + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t{w[0]} - w[4]) * (1 << kConstBits);
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
    const int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    o[0] = lim[descale(tmp10 + tmp3, n2) & 1023];
    o[7] = lim[descale(tmp10 - tmp3, n2) & 1023];
    o[1] = lim[descale(tmp11 + tmp2, n2) & 1023];
    o[6] = lim[descale(tmp11 - tmp2, n2) & 1023];
    o[2] = lim[descale(tmp12 + tmp1, n2) & 1023];
    o[5] = lim[descale(tmp12 - tmp1, n2) & 1023];
    o[3] = lim[descale(tmp13 + tmp0, n2) & 1023];
    o[4] = lim[descale(tmp13 - tmp0, n2) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table: SCALEBITS 16
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kBits = 16;
    constexpr int32_t kHalf = 1 << (kBits - 1);
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1 << kBits) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kBits;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kBits;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, eoi = false;
  int adobe_transform = -1;
  std::vector<Component> comps;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) throw Error("truncated JPEG file");
    return data[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // markers may be preceded by any number of 0xFF fill bytes
    if (u8() != 0xFF) throw Error("corrupt JPEG data: expected a marker");
    int m;
    do {
      m = u8();
    } while (m == 0xFF);
    return m;
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pq = u8();
      const int tq = pq & 15, prec = pq >> 4;
      if (tq > 3 || prec > 1) throw Error("bad quantization table");
      for (int i = 0; i < 64; ++i)
        quant[tq][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : u8());
      quant_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      const int tc = u8();
      const int cls = tc >> 4, th = tc & 15;
      if (cls > 1 || th > 3) throw Error("bad Huffman table");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = static_cast<uint8_t>(u8());
      if (count > 256) throw Error("bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(u8());
      (cls ? ac[th] : dc[th]).build(bits, vals, count);
    }
  }

  void read_sof(int marker) {
    if (frame) throw Error("JPEG with more than one frame");
    const int precision = u8();
    height = u16();
    width = u16();
    const int n = u8();
    if (marker != 0xC0 && marker != 0xC1) {
      const char* what = marker == 0xC2 ? "progressive"
                         : (marker == 0xC3 || marker == 0xC7 ||
                            marker == 0xCB || marker == 0xCF)
                             ? "lossless"
                         : marker >= 0xC9 ? "arithmetic-coded"
                                          : "hierarchical";
      throw Error(std::string("unsupported JPEG: ") + what +
                  " (SOF" + std::to_string(marker - 0xC0) + ")");
    }
    if (precision != 8)
      throw Error("unsupported JPEG: " + std::to_string(precision) +
                  "-bit samples");
    if (n != 1 && n != 3)
      throw Error("unsupported JPEG: " + std::to_string(n) + " components");
    if (width <= 0 || height <= 0)
      throw Error("unsupported JPEG: no image size in the frame header");
    if (int64_t{width} * height > (int64_t{1} << 30))  // cv2.imread's limit
      throw Error("JPEG of " + std::to_string(width) + "x" +
                  std::to_string(height) + " pixels: over 2^30");
    comps.resize(n);
    for (auto& c : comps) {
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Error("bad JPEG frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        throw Error("unsupported JPEG: non-integral sampling factors");
      c.dw = static_cast<int>((int64_t{width} * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((int64_t{height} * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.stride = c.bw * 8;
      c.plane.assign(static_cast<size_t>(c.stride) * c.bh * 8, 0);
    }
    frame = true;
  }

  void decode_block(BitReader& br, Component& c, uint8_t* out) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    const int s = decode_huffman(br, hd);
    if (s > 15) throw Error("corrupt JPEG data: bad DC magnitude");
    if (s) c.pred += extend(br.get(s), s);
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = decode_huffman(br, ha);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) throw Error("corrupt JPEG data: bad AC run");
        coef[kNatural[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, quant[c.tq], out, c.stride);
  }

  void read_sos() {
    if (!frame) throw Error("JPEG scan before its frame header");
    const int ns = u8();
    if (ns < 1 || ns > static_cast<int>(comps.size()))
      throw Error("bad JPEG scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) throw Error("JPEG scan names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
          !ac[found->ta].defined)
        throw Error("JPEG scan uses an undefined Huffman table");
      if (!quant_defined[found->tq])
        throw Error("JPEG component uses an undefined quantization table");
      sc.push_back(found);
    }
    const int ss = u8(), se = u8(), a = u8();
    if (ss != 0 || se != 63 || a != 0)
      throw Error("unsupported JPEG: a scan of a spectral band "
                  "(progressive)");
    for (auto* c : sc) c->pred = 0;

    // an interleaved scan walks MCUs; a one-component scan walks the
    // component's own blocks, one per MCU
    const bool single = ns == 1;
    const int nx = single ? (sc[0]->dw + 7) / 8 : mcux;
    const int ny = single ? (sc[0]->dh + 7) / 8 : mcuy;
    BitReader br(data, size, pos);
    int left = restart;
    int next_rst = 0;
    const int64_t total = int64_t{nx} * ny;
    for (int64_t m = 0; m < total; ++m) {
      if (restart && left == 0) {
        // byte-aligned: the next bytes must be the expected RSTn marker
        size_t p = br.pos();
        while (p < size && data[p] != 0xFF) ++p;
        while (p + 1 < size && data[p + 1] == 0xFF) ++p;
        if (p + 1 >= size) throw Error("truncated JPEG file");
        if (data[p + 1] != 0xD0 + next_rst)
          throw Error("corrupt JPEG data: missing restart marker");
        br.reset(p + 2);
        next_rst = (next_rst + 1) & 7;
        left = restart;
        for (auto* c : sc) c->pred = 0;
      }
      const int my = static_cast<int>(m / nx), mx = static_cast<int>(m % nx);
      if (single) {
        Component& c = *sc[0];
        decode_block(br, c,
                     c.plane.data() + static_cast<size_t>(my) * 8 * c.stride +
                         mx * 8);
      } else {
        for (auto* c : sc)
          for (int by = 0; by < c->v; ++by)
            for (int bx = 0; bx < c->h; ++bx)
              decode_block(
                  br, *c,
                  c->plane.data() +
                      static_cast<size_t>(my * c->v + by) * 8 * c->stride +
                      (mx * c->h + bx) * 8);
      }
      if (br.overrun()) throw Error("truncated JPEG file (scan data ends early)");
      --left;
    }
    // past the scan's data to the next marker
    size_t p = br.pos();
    while (p + 1 < size && !(data[p] == 0xFF && data[p + 1] != 0x00 &&
                             data[p + 1] != 0xFF &&
                             !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
      ++p;
    if (p + 1 >= size) throw Error("truncated JPEG file (no EOI marker)");
    pos = p;
  }

  void parse(bool header_only) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8)
      throw Error("not a JPEG file");
    pos = 2;
    while (true) {
      const int m = next_marker();
      if (m == 0xD9) {
        eoi = true;
        break;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray restart marker
      const size_t start = pos;
      const int len = u16();
      if (len < 2 || start + len > size) throw Error("truncated JPEG file");
      const size_t end = start + len;
      if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m == 0xCC) {
        throw Error("unsupported JPEG: arithmetic coding (DAC)");
      } else if (m >= 0xC0 && m <= 0xCF) {
        read_sof(m);
        if (header_only) return;
      } else if (m == 0xDA) {
        read_sos();
        continue;  // read_sos leaves pos at the next marker
      } else if (m == 0xDC) {
        throw Error("unsupported JPEG: a DNL marker");
      } else if (m == 0xEE && len >= 14 &&
                 std::memcmp(data + start + 2, "Adobe", 5) == 0) {
        adobe_transform = data[start + 13];
      }
      pos = end;
    }
    if (!frame) throw Error("JPEG without a frame header");
  }

  // the component's samples at full resolution, [height, width]
  void upsample(const Component& c, uint8_t* out) const {
    const int rh = vmax / c.v, rw = hmax / c.h;
    const uint8_t* p = c.plane.data();
    const int s = c.stride, dw = c.dw, dh = c.dh;
    auto row = [&](int y) {  // context rows replicate the edge rows
      return p + static_cast<size_t>(y < 0 ? 0 : (y >= dh ? dh - 1 : y)) * s;
    };
    std::vector<uint8_t> wide(static_cast<size_t>(2 * dw + 2));
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out + static_cast<size_t>(y) * width;
      if (rh == 1 && rw == 1) {
        std::memcpy(o, row(y), width);
      } else if (rh == 1 && rw == 2) {
        const uint8_t* in = row(y);
        if (dw > 2) {  // h2v1_fancy_upsample
          uint8_t* w = wide.data();
          w[0] = in[0];
          w[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
          for (int x = 1; x < dw - 1; ++x) {
            const int v = in[x] * 3;
            w[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
            w[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
          }
          w[2 * dw - 2] =
              static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          w[2 * dw - 1] = in[dw - 1];
          std::memcpy(o, w, width);
        } else {
          for (int x = 0; x < width; ++x) o[x] = in[x >> 1];
        }
      } else if (rh == 2 && rw == 2) {
        const int iy = y >> 1;
        const uint8_t* in0 = row(iy);
        if (dw > 2) {  // h2v2_fancy_upsample
          const uint8_t* in1 = row(y & 1 ? iy + 1 : iy - 1);
          uint8_t* w = wide.data();
          int this_sum = in0[0] * 3 + in1[0];
          int next_sum = in0[1] * 3 + in1[1];
          w[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
          w[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          int last_sum = this_sum;
          this_sum = next_sum;
          for (int x = 1; x < dw - 1; ++x) {
            next_sum = in0[x + 1] * 3 + in1[x + 1];
            w[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
            w[2 * x + 1] =
                static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
          }
          w[2 * dw - 2] =
              static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          w[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
          std::memcpy(o, w, width);
        } else {
          for (int x = 0; x < width; ++x) o[x] = in0[x >> 1];
        }
      } else if (rh == 2 && rw == 1) {  // h1v2_fancy_upsample
        const int iy = y >> 1;
        const uint8_t* in0 = row(iy);
        const uint8_t* in1 = row(y & 1 ? iy + 1 : iy - 1);
        const int bias = y & 1 ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else {
        throw Error("unsupported JPEG: chroma sampled " + std::to_string(rw) +
                    "x" + std::to_string(rh) +
                    " (takes 4:4:4, 4:2:2, 4:2:0, 4:4:0)");
      }
    }
  }

  void to_rgb(uint8_t* out) const {
    const size_t n = static_cast<size_t>(width) * height;
    if (comps.size() == 1) {
      const Component& c = comps[0];
      for (int y = 0; y < height; ++y) {
        const uint8_t* in = c.plane.data() + static_cast<size_t>(y) * c.stride;
        uint8_t* o = out + static_cast<size_t>(y) * width * 3;
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
      }
      return;
    }
    std::vector<uint8_t> full(3 * n);
    for (int i = 0; i < 3; ++i) upsample(comps[i], full.data() + i * n);
    const uint8_t *p0 = full.data(), *p1 = p0 + n, *p2 = p1 + n;
    // libjpeg's colour space guess (jdapimin.c default_decompress_parms):
    // an Adobe marker's transform 0, or component ids 'R' 'G' 'B', mean RGB
    const bool rgb =
        adobe_transform == 0 ||
        (adobe_transform < 0 && comps[0].id == 'R' && comps[1].id == 'G' &&
         comps[2].id == 'B');
    for (size_t i = 0; i < n; ++i) {
      uint8_t* o = out + 3 * i;
      if (rgb) {
        o[0] = p0[i];
        o[1] = p1[i];
        o[2] = p2[i];
        continue;
      }
      const int yv = p0[i], cb = p1[i], cr = p2[i];
      o[0] = clamp255(yv + kYcc.cr_r[cr]);
      o[1] = clamp255(yv + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[2] = clamp255(yv + kYcc.cb_b[cb]);
    }
  }
};

void set_error(char* err, int err_len, const char* msg) {
  if (err && err_len > 0) std::snprintf(err, err_len, "%s", msg);
}

}  // namespace

extern "C" {

// Undo the filters of `height` rows of `1 + width * bpp` bytes (filter type
// first) of `raw`, and write their RGB bytes to `out_rgb` [height, width, 3].
// bpp is 3 (RGB) or 4 (RGBA). -> 0, or 1 + the index of the first row whose
// filter type is unknown.
int64_t dgod_png_unfilter(const uint8_t* raw, int64_t height, int64_t width,
                          int bpp, uint8_t* out_rgb) {
  const int64_t n = width * bpp;
  // RGB rows are undone straight into the output; RGBA rows into two
  // scratch rows, whose RGB bytes are then copied out
  std::vector<uint8_t> rows(static_cast<size_t>(bpp == 3 ? n : 3 * n), 0);
  const uint8_t* prev = rows.data();  // zeros
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = raw + y * (n + 1);
    uint8_t* o = out_rgb + y * width * 3;
    uint8_t* cur = bpp == 3 ? o : rows.data() + (1 + (y & 1)) * n;
    if (!unfilter_row(in[0], in + 1, cur, prev, n, bpp)) return y + 1;
    prev = cur;
    if (bpp != 3) {
      for (int64_t x = 0; x < width; ++x) {
        o[3 * x] = cur[4 * x];
        o[3 * x + 1] = cur[4 * x + 1];
        o[3 * x + 2] = cur[4 * x + 2];
      }
    }
  }
  return 0;
}

// The frame size of a JPEG: -> 0 and (height, width), or -1 and a message.
int dgod_jpeg_size(const uint8_t* data, int64_t size, int* height, int* width,
                   char* err, int err_len) {
  try {
    Jpeg j(data, static_cast<size_t>(size));
    j.parse(true);
    *height = j.height;
    *width = j.width;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
    return -1;
  }
}

// Decode a JPEG into `out_rgb` [height, width, 3], the size dgod_jpeg_size
// gave. -> 0, or -1 and a message.
int dgod_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out_rgb,
                     int height, int width, char* err, int err_len) {
  try {
    Jpeg j(data, static_cast<size_t>(size));
    j.parse(false);
    if (!j.eoi) throw Error("truncated JPEG file (no EOI marker)");
    if (j.height != height || j.width != width)
      throw Error("JPEG size differs from the size given");
    j.to_rgb(out_rgb);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
    return -1;
  }
}

}  // extern "C"
