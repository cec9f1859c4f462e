// JPEG decoder (host), for the readers' JPEG captures.
//
// Scope: 8-bit DCT frames with Huffman coding, sequential (SOF0, SOF1) or
// progressive (SOF2, spectral selection and successive approximation);
// 1 or 3 components (YCbCr, or RGB where libjpeg-turbo reads RGB: an Adobe
// marker with transform 0, or no JFIF / Adobe marker and component ids
// 'R', 'G', 'B'), sampling factors 1-4 with integral ratios; interleaved
// and non-interleaved scans; any number of DQT (8- or 16-bit) and DHT
// tables, redefined between scans (a component keeps the quantization
// table of its first scan); DRI restart intervals; partial MCUs at the
// right and bottom edges. Anything else (arithmetic coding, 12-bit
// samples, lossless, hierarchical, CMYK / YCCK, fractional sampling
// ratios) is refused with status 1 and a message naming the marker.
//
// The output equals libjpeg-turbo's with its defaults (what PIL's
// Image.open(p).convert("RGB") and cv2.imread give), pixel for pixel:
//   - the ISLOW integer IDCT of jidctint.c, with its range-limit table;
//   - a progressive frame's coefficients gathered over its scans (the
//     four decoders of jdphuff.c), then, where any of coefficients 1-9 of
//     a component is still incomplete after the last scan, the block
//     smoothing of jdcoefct.c (decompress_smooth_data, libjpeg-turbo
//     2.1+: AC estimates from the 5x5 neighbourhood's DC values, and DC
//     interpolation when no AC data came at all) before the IDCT;
//   - the upsampler jdsample.c picks: "fancy" (triangular) h2v1, h1v2
//     and h2v2, box replication for h2 components 2 samples wide or less,
//     the first and last sample rows replicated at the edges; any other
//     integral ratio by replication (int_upsample);
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c.
//
// Exposed via ctypes (data/jpeg.py): jpeg_header reads the frame's size,
// jpeg_decode the pixels. Both return 0, 1 (unsupported) or 2 (malformed)
// and write a message to err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries absorb a run past the end, as libjpeg's table does
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  int code;
  std::string msg;
};

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint16_t lut[1 << 9];  // (length << 8) | value, 0 when longer than 9 bits

  void build(const uint8_t* bits, const uint8_t* v, int nvals) {
    std::memcpy(vals, v, nvals);
    std::memset(lut, 0, sizeof(lut));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < bits[len]; ++i, ++k, ++code) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j)
            lut[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
        }
      }
      maxcode[len] = bits[len] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int pw = 0, ph = 0;          // MCU-padded plane size
  int dw = 0, dh = 0;          // downsampled size (libjpeg's)
  int bw = 0, bh = 0;          // its own blocks (width_in_blocks, height_)
  int pred = 0;
  bool latched = false;
  uint16_t qt[64] = {};        // the quant table of its first scan
  // progressive: each coefficient's Al of its last scan (-1: none yet,
  // zigzag order), and the coefficients of the MCU-padded block grid,
  // [ph / 8][pw / 8][64] in natural order
  int coef_bits[64];
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;

  int16_t* block(int row, int col) {
    return coef.data() + ((size_t)row * (pw / 8) + col) * 64;
  }
};

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint32_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 24) {
      uint32_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t next = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {  // a marker: feed zeros, as libjpeg does
            at_marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= b << (24 - cnt);
      cnt += 8;
    }
  }
  int bits(int s) {
    if (s == 0) return 0;
    fill();
    int v = (int)(buf >> (32 - s));
    buf <<= s;
    cnt -= s;
    return v;
  }
  int decode(const Huffman& t) {
    fill();
    uint16_t e = t.lut[buf >> (32 - 9)];
    if (e) {
      int len = e >> 8;
      buf <<= len;
      cnt -= len;
      return e & 0xFF;
    }
    for (int len = 10; len <= 16; ++len) {
      int32_t code = (int32_t)(buf >> (32 - len));
      if (code <= t.maxcode[len]) {
        buf <<= len;
        cnt -= len;
        return t.vals[t.valptr[len] + code - t.mincode[len]];
      }
    }
    throw Error{2, "corrupt Huffman data (no code of 16 bits or less)"};
  }
  void reset() {
    buf = 0;
    cnt = 0;
    at_marker = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((~0u) << s) + 1 : v;
}

// jidctint.c's range limit: clamp(x + 128) over x in [-512, 511], wrapped
uint8_t kLimit[1024];
struct LimitInit {
  LimitInit() {
    for (int j = 0; j < 1024; ++j)
      kLimit[j] = j < 128 ? (uint8_t)(j + 128)
                  : j < 512 ? 255
                  : j < 896 ? 0
                            : (uint8_t)(j - 896);
  }
} limit_init;

#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

// jpeg_idct_islow: coef in natural order, q the quant table in natural
// order; 8x8 samples to out with the given stride
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  const int CB = 13, P1 = 2;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int)in[0] * qt[0] * (1 << P1);
      for (int k = 0; k < 8; ++k) w[8 * k] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = (int)DESCALE(tmp10 + tmp3, CB - P1);
    w[56] = (int)DESCALE(tmp10 - tmp3, CB - P1);
    w[8] = (int)DESCALE(tmp11 + tmp2, CB - P1);
    w[48] = (int)DESCALE(tmp11 - tmp2, CB - P1);
    w[16] = (int)DESCALE(tmp12 + tmp1, CB - P1);
    w[40] = (int)DESCALE(tmp12 - tmp1, CB - P1);
    w[24] = (int)DESCALE(tmp13 + tmp0, CB - P1);
    w[32] = (int)DESCALE(tmp13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = kLimit[(int)DESCALE((int64_t)w[0], P1 + 3) & 1023];
      for (int k = 0; k < 8; ++k) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CB);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int S = CB + P1 + 3;
    o[0] = kLimit[(int)DESCALE(tmp10 + tmp3, S) & 1023];
    o[7] = kLimit[(int)DESCALE(tmp10 - tmp3, S) & 1023];
    o[1] = kLimit[(int)DESCALE(tmp11 + tmp2, S) & 1023];
    o[6] = kLimit[(int)DESCALE(tmp11 - tmp2, S) & 1023];
    o[2] = kLimit[(int)DESCALE(tmp12 + tmp1, S) & 1023];
    o[5] = kLimit[(int)DESCALE(tmp12 - tmp1, S) & 1023];
    o[3] = kLimit[(int)DESCALE(tmp13 + tmp0, S) & 1023];
    o[4] = kLimit[(int)DESCALE(tmp13 - tmp0, S) & 1023];
  }
}

// jdcolor.c's tables
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int SB = 16;
    const int64_t half = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
} kColor;

inline uint8_t clamp255(int x) {
  return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  // Reads markers up to the frame header (header_only) or to EOI.
  void run(bool header_only) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
      throw Error{2, "not a JPEG file (no SOI marker)"};
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RST
      if (m == 0xD8 || m == 0x01) continue;
      size_t len = seg_len();
      const uint8_t* s = d_ + pos_ + 2;
      size_t body = len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          frame(s, body, m);
          if (header_only) return;
          break;
        case 0xC3:
          throw Error{1, "lossless JPEG (SOF3 marker) is not supported"};
        case 0xC5: case 0xC6: case 0xC7:
          throw Error{1, "hierarchical JPEG (SOF5-7 markers) is not "
                         "supported"};
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
          throw Error{1, "arithmetic-coded JPEG (SOF9-15 / DAC markers) is "
                         "not supported"};
        case 0xC4: dht(s, body); break;
        case 0xDB: dqt(s, body); break;
        case 0xDD:
          if (body < 2) throw Error{2, "short DRI segment"};
          restart_ = (s[0] << 8) | s[1];
          break;
        case 0xDC:
          throw Error{1, "DNL marker is not supported"};
        case 0xEE:
          if (body >= 12 && std::memcmp(s, "Adobe", 5) == 0) adobe_ = s[11];
          break;
        case 0xE0:
          if (body >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        case 0xDA:
          if (comps_.empty()) throw Error{2, "SOS before SOF"};
          pos_ += len;
          scan(s, body);
          continue;
        default:
          break;  // APPn, COM and the rest carry nothing we need
      }
      pos_ += len;
    }
    if (!header_only && !scanned_) throw Error{2, "no scan in the file"};
    if (header_only && comps_.empty()) throw Error{2, "no frame header"};
    if (progressive_) {
      bool smooth = smoothing_ok();
      for (auto& c : comps_) idct_coefficients(c, smooth);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return (int)comps_.size() == 1 ? 1 : 3; }

  void output(uint8_t* out) {
    const int W = width_, H = height_;
    if (comps_.size() == 1) {
      const Component& c = comps_[0];
      for (int y = 0; y < H; ++y)
        std::memcpy(out + (size_t)y * W, c.plane.data() + (size_t)y * c.pw,
                    W);
      return;
    }
    std::vector<uint8_t> full[3];
    for (int k = 0; k < 3; ++k) full[k] = upsample(comps_[k]);
    if (rgb_) {
      for (size_t i = 0, n = (size_t)W * H; i < n; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
      return;
    }
    for (size_t i = 0, n = (size_t)W * H; i < n; ++i) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i + 0] = clamp255(y + kColor.cr_r[cr]);
      out[3 * i + 1] = clamp255(
          y + (int)((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + kColor.cb_b[cb]);
    }
  }

 private:
  int next_marker() {
    while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;  // garbage: skip
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;  // fill bytes
    if (pos_ >= n_) throw Error{2, "unexpected end of file (no EOI)"};
    return d_[pos_++];
  }
  size_t seg_len() {
    if (pos_ + 2 > n_) throw Error{2, "truncated marker segment"};
    size_t len = (d_[pos_] << 8) | d_[pos_ + 1];
    if (len < 2 || pos_ + len > n_) throw Error{2, "truncated marker segment"};
    return len;
  }

  void frame(const uint8_t* s, size_t body, int marker) {
    if (!comps_.empty()) throw Error{2, "a second frame header"};
    if (body < 6) throw Error{2, "short SOF segment"};
    if (s[0] != 8) {
      char msg[96];
      std::snprintf(msg, sizeof msg, "%d-bit JPEG (SOF%d marker) is not "
                    "supported", s[0], marker - 0xC0);
      throw Error{1, msg};
    }
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height_ == 0) throw Error{1, "a height set by DNL is not supported"};
    if (width_ == 0) throw Error{2, "zero image width"};
    if (nc != 1 && nc != 3) {
      char msg[96];
      std::snprintf(msg, sizeof msg, "%s (%d components, SOF%d marker) is "
                    "not supported", nc == 4 ? "CMYK / YCCK JPEG" : "JPEG",
                    nc, marker - 0xC0);
      throw Error{1, msg};
    }
    if (body < 6 + 3 * (size_t)nc) throw Error{2, "short SOF segment"};
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Error{2, "bad sampling factors (1-4)"};
      if (c.tq > 3) throw Error{2, "bad quantization table id"};
      for (int& b : c.coef_bits) b = -1;
      comps_.push_back(c);
    }
    hmax_ = vmax_ = 1;
    for (auto& c : comps_) {
      hmax_ = c.h > hmax_ ? c.h : hmax_;
      vmax_ = c.v > vmax_ ? c.v : vmax_;
    }
    for (auto& c : comps_)
      if (hmax_ % c.h || vmax_ % c.v)
        throw Error{1, "fractional sampling ratios (SOF sampling factors) "
                       "are not supported"};
    progressive_ = marker == 0xC2;
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.pw = mcux_ * c.h * 8;
      c.ph = mcuy_ * c.v * 8;
      c.dw = (width_ * c.h + hmax_ - 1) / hmax_;
      c.dh = (height_ * c.v + vmax_ - 1) / vmax_;
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.plane.assign((size_t)c.pw * c.ph, 0);
      if (progressive_) c.coef.assign((size_t)c.pw * c.ph, 0);
    }
  }

  // jdapimin.c's default_decompress_parms, at the first scan: three
  // components are RGB under an Adobe marker with transform 0 (a JFIF
  // marker wins), or with neither marker and ids 'R', 'G', 'B'
  void color_space() {
    if (comps_.size() != 3 || jfif_) return;
    if (adobe_ >= 0)
      rgb_ = adobe_ == 0;
    else
      rgb_ = comps_[0].id == 'R' && comps_[1].id == 'G' &&
             comps_[2].id == 'B';
  }

  void dqt(const uint8_t* s, size_t body) {
    size_t i = 0;
    while (i < body) {
      int pq = s[i] >> 4, tq = s[i] & 15;
      if (tq > 3 || pq > 1) throw Error{2, "bad DQT segment"};
      ++i;
      if (i + (pq ? 128 : 64) > body) throw Error{2, "short DQT segment"};
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (s[i + 2 * k] << 8) | s[i + 2 * k + 1] : s[i + k];
        quant_[tq][kZigzag[k]] = (uint16_t)v;
      }
      qdefined_[tq] = true;
      i += pq ? 128 : 64;
    }
  }

  void dht(const uint8_t* s, size_t body) {
    size_t i = 0;
    while (i < body) {
      if (i + 17 > body) throw Error{2, "short DHT segment"};
      int tc = s[i] >> 4, th = s[i] & 15;
      if (tc > 1 || th > 3) throw Error{2, "bad DHT segment"};
      uint8_t bits[17] = {0};
      int total = 0;
      for (int k = 1; k <= 16; ++k) total += bits[k] = s[i + k];
      if (total > 256 || i + 17 + total > body)
        throw Error{2, "bad DHT segment"};
      (tc ? ac_[th] : dc_[th]).build(bits, s + i + 17, total);
      i += 17 + total;
    }
  }

  void scan(const uint8_t* s, size_t body) {
    int ns = body ? s[0] : 0;
    if (ns < 1 || ns > 4 || body < 4 + 2 * (size_t)ns)
      throw Error{2, "bad SOS segment"};
    if (!scanned_) color_space();
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    bool dc = ss == 0;
    if (!progressive_) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        throw Error{2, "bad spectral selection for a sequential scan"};
    } else {
      // jdphuff.c's start_pass_phuff_decoder: a DC scan codes coefficient
      // 0 alone and may interleave; an AC scan has one component; a
      // refinement codes the bit below the last
      bool bad = dc ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) {
        char msg[96];
        std::snprintf(msg, sizeof msg, "bad progression (Ss %d, Se %d, Ah "
                      "%d, Al %d)", ss, se, ah, al);
        throw Error{2, msg};
      }
    }
    std::vector<Component*> sc;
    int mcu_blocks = 0;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Component* c = nullptr;
      for (auto& k : comps_)
        if (k.id == id) c = &k;
      if (!c) throw Error{2, "SOS names an unknown component"};
      c->td = s[2 + 2 * i] >> 4;
      c->ta = s[2 + 2 * i] & 15;
      // the tables this scan decodes with: both in a sequential scan, the
      // DC table in a first DC scan, none in a DC refinement, the AC
      // table in an AC scan
      bool need_dc = !progressive_ || (dc && ah == 0);
      bool need_ac = !progressive_ || !dc;
      if (c->td > 3 || c->ta > 3 || (need_dc && !dc_[c->td].defined) ||
          (need_ac && !ac_[c->ta].defined))
        throw Error{2, "SOS uses an undefined Huffman table"};
      // jdinput.c's latch_quant_tables: a component keeps the table as
      // its first scan starts
      if (!c->latched) {
        if (!qdefined_[c->tq])
          throw Error{2, "a component uses an undefined quantization table"};
        std::memcpy(c->qt, quant_[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      if (progressive_)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      c->pred = 0;
      mcu_blocks += c->h * c->v;
      sc.push_back(c);
    }
    if (ns > 1 && mcu_blocks > 10)
      throw Error{2, "too many blocks in an MCU (more than 10)"};

    BitReader br{d_, n_, pos_};
    int mx, my, units;
    if (ns == 1) {
      Component* c = sc[0];
      mx = c->bw;
      my = c->bh;
    } else {
      mx = mcux_;
      my = mcuy_;
    }
    units = mx * my;
    eobrun_ = 0;
    int16_t coef[64];
    for (int u = 0; u < units; ++u) {
      if (restart_ && u > 0 && u % restart_ == 0) restart(br, sc);
      int ux = u % mx, uy = u / mx;
      for (Component* c : sc) {
        int bh = ns == 1 ? 1 : c->h, bv = ns == 1 ? 1 : c->v;
        for (int by = 0; by < bv; ++by)
          for (int bx = 0; bx < bh; ++bx) {
            int col = ux * bh + bx, row = uy * bv + by;
            if (!progressive_) {
              block(br, *c, coef);
              idct_islow(coef, c->qt, c->plane.data() +
                         (size_t)row * 8 * c->pw + col * 8, c->pw);
              continue;
            }
            int16_t* b = c->block(row, col);
            if (dc && ah == 0)
              dc_first(br, *c, b, al);
            else if (dc)
              b[0] = (int16_t)(b[0] | (br.bits(1) << al));
            else if (ah == 0)
              ac_first(br, *c, b, ss, se, al);
            else
              ac_refine(br, *c, b, ss, se, al);
          }
      }
    }
    pos_ = br.pos;
    scanned_ = true;
  }

  void restart(BitReader& br, std::vector<Component*>& sc) {
    size_t p = br.pos;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] >= 0xD0 &&
                           d_[p + 1] <= 0xD7))
      ++p;
    if (p + 1 >= n_) throw Error{2, "missing restart marker"};
    br.pos = p + 2;
    br.reset();
    for (Component* c : sc) c->pred = 0;
    eobrun_ = 0;
  }

  // jdphuff.c's decode_mcu_DC_first: the DC difference of the value
  // shifted right by al
  void dc_first(BitReader& br, Component& c, int16_t* b, int al) {
    int t = br.decode(dc_[c.td]);
    if (t > 15) throw Error{2, "corrupt DC difference"};
    c.pred += t ? extend(br.bits(t), t) : 0;
    b[0] = (int16_t)((unsigned)c.pred << al);
  }

  // decode_mcu_AC_first: run/size codes of band ss..se, ZRL, and EOB runs
  // (EOBn: 2^n blocks plus n appended bits) that skip whole blocks
  void ac_first(BitReader& br, Component& c, int16_t* b, int ss, int se,
                int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ac_[c.ta]);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        b[kZigzag[k]] = (int16_t)((unsigned)extend(br.bits(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = (1 << r) + br.bits(r) - 1;
        break;
      }
    }
  }

  // decode_mcu_AC_refine: newly nonzero coefficients (+-1 << al, after
  // their run of zero-history coefficients) and a correction bit for
  // every coefficient already nonzero that the decoder passes over,
  // within the block's codes and, for the rest of the band, in an EOB run
  void ac_refine(BitReader& br, Component& c, int16_t* b, int ss, int se,
                 int al) {
    const int p1 = 1 << al, m1 = -p1;
    auto correct = [&](int16_t* x) {
      if (br.bits(1) && (*x & p1) == 0)
        *x = (int16_t)(*x + (*x >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(ac_[c.ta]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = (1 << r) + br.bits(r);
          break;
        }
        do {
          int16_t* x = b + kZigzag[k];
          if (*x != 0)
            correct(x);
          else if (--r < 0)
            break;
          ++k;
        } while (k <= se);
        if (s) b[kZigzag[k]] = (int16_t)s;
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t* x = b + kZigzag[k];
        if (*x != 0) correct(x);
      }
      --eobrun_;
    }
  }

  // jdcoefct.c's smoothing_ok: every component has its quant table and
  // some DC data, the quantizers of coefficients 0-9 are nonzero, and one
  // of coefficients 1-9 of some component is still incomplete
  bool smoothing_ok() const {
    bool useful = false;
    for (const auto& c : comps_) {
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.qt[kZigzag[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // A progressive component's blocks -> its plane: jdcoefct.c's
  // decompress_data, or decompress_smooth_data with ``smooth``
  void idct_coefficients(Component& c, bool smooth) {
    if (!smooth) {
      for (int r = 0; r < c.bh; ++r)
        for (int col = 0; col < c.bw; ++col)
          idct_islow(c.block(r, col), c.qt, c.plane.data() +
                     (size_t)r * 8 * c.pw + col * 8, c.pw);
      return;
    }
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc &= bits[k] == -1;
    const int64_t Q00 = c.qt[0], Q01 = c.qt[1], Q10 = c.qt[8],
                  Q20 = c.qt[16], Q11 = c.qt[9], Q02 = c.qt[2],
                  Q03 = c.qt[3], Q12 = c.qt[10], Q21 = c.qt[17],
                  Q30 = c.qt[24];
    // a coefficient's estimate num / (Q << 8), rounded, clamped below
    // 2^Al where Al > 0
    auto est = [](int64_t num, int64_t q, int al) {
      int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      return num >= 0 ? pred : -pred;
    };
    const int T = mcuy_, last_col = c.bw - 1;
    int16_t ws[64];
    for (int im = 0; im < T; ++im) {
      // the rows above and below as decompress_smooth_data picks them:
      // the last iMCU row counts only its own block rows, and the row two
      // below a block can be a padding row of the MCU grid
      int block_rows = im < T - 1 ? c.v : (c.bh % c.v ? c.bh % c.v : c.v);
      int image_rows = block_rows * T;
      for (int br = 0; br < block_rows; ++br) {
        int r = im * c.v + br, ir = im * block_rows + br;
        int16_t* cur = c.block(r, 0);
        int16_t* prev = ir > 0 ? c.block(r - 1, 0) : cur;
        int16_t* pprev = ir > 1 ? c.block(r - 2, 0) : prev;
        int16_t* next = ir < image_rows - 1 ? c.block(r + 1, 0) : cur;
        int16_t* nnext = ir < image_rows - 2 ? c.block(r + 2, 0) : next;
        // the 5x5 DC window, rows pprev..nnext, columns -2..+2, slid
        // along the row; columns past either end replicate the edge (at
        // the first column both right neighbours start as column 1)
        int dc[5][5];
        int16_t* rows[5] = {pprev, prev, cur, next, nnext};
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) dc[i][j] = rows[i][0];
        for (int col = 0; col <= last_col; ++col) {
          std::memcpy(ws, c.block(r, col), sizeof ws);
          if (col == 0 && col < last_col)
            for (int i = 0; i < 5; ++i) dc[i][3] = dc[i][4] = rows[i][64];
          if (col + 1 < last_col)
            for (int i = 0; i < 5; ++i)
              dc[i][4] = rows[i][(size_t)(col + 2) * 64];
#define DC(i, j) ((int64_t)dc[(i) - 1][(j) - 1])
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0) {
            int64_t num = change_dc ?
                -DC(1, 1) - DC(1, 2) + DC(1, 4) + DC(1, 5) - 3 * DC(2, 1) +
                13 * DC(2, 2) - 13 * DC(2, 4) + 3 * DC(2, 5) - 3 * DC(3, 1) +
                38 * DC(3, 2) - 38 * DC(3, 4) + 3 * DC(3, 5) - 3 * DC(4, 1) +
                13 * DC(4, 2) - 13 * DC(4, 4) + 3 * DC(4, 5) - DC(5, 1) -
                DC(5, 2) + DC(5, 4) + DC(5, 5) :
                -7 * DC(3, 1) + 50 * DC(3, 2) - 50 * DC(3, 4) + 7 * DC(3, 5);
            ws[1] = (int16_t)est(Q00 * num, Q01, al);
          }
          if ((al = bits[2]) != 0 && ws[8] == 0) {
            int64_t num = change_dc ?
                -DC(1, 1) - 3 * DC(1, 2) - 3 * DC(1, 3) - 3 * DC(1, 4) -
                DC(1, 5) - DC(2, 1) + 13 * DC(2, 2) + 38 * DC(2, 3) +
                13 * DC(2, 4) - DC(2, 5) + DC(4, 1) - 13 * DC(4, 2) -
                38 * DC(4, 3) - 13 * DC(4, 4) + DC(4, 5) + DC(5, 1) +
                3 * DC(5, 2) + 3 * DC(5, 3) + 3 * DC(5, 4) + DC(5, 5) :
                -7 * DC(1, 3) + 50 * DC(2, 3) - 50 * DC(4, 3) + 7 * DC(5, 3);
            ws[8] = (int16_t)est(Q00 * num, Q10, al);
          }
          if ((al = bits[3]) != 0 && ws[16] == 0) {
            int64_t num = change_dc ?
                DC(1, 3) + 2 * DC(2, 2) + 7 * DC(2, 3) + 2 * DC(2, 4) -
                5 * DC(3, 2) - 14 * DC(3, 3) - 5 * DC(3, 4) + 2 * DC(4, 2) +
                7 * DC(4, 3) + 2 * DC(4, 4) + DC(5, 3) :
                -DC(1, 3) + 13 * DC(2, 3) - 24 * DC(3, 3) + 13 * DC(4, 3) -
                DC(5, 3);
            ws[16] = (int16_t)est(Q00 * num, Q20, al);
          }
          if ((al = bits[4]) != 0 && ws[9] == 0) {
            int64_t num = change_dc ?
                -DC(1, 1) + DC(1, 5) + 9 * DC(2, 2) - 9 * DC(2, 4) -
                9 * DC(4, 2) + 9 * DC(4, 4) + DC(5, 1) - DC(5, 5) :
                DC(2, 5) + DC(4, 1) - 10 * DC(4, 2) + 10 * DC(4, 4) -
                DC(1, 2) - DC(4, 5) + DC(5, 2) - DC(5, 4) + DC(1, 4) -
                DC(2, 1) + 10 * DC(2, 2) - 10 * DC(2, 4);
            ws[9] = (int16_t)est(Q00 * num, Q11, al);
          }
          if ((al = bits[5]) != 0 && ws[2] == 0) {
            int64_t num = change_dc ?
                2 * DC(2, 2) - 5 * DC(2, 3) + 2 * DC(2, 4) + DC(3, 1) +
                7 * DC(3, 2) - 14 * DC(3, 3) + 7 * DC(3, 4) + DC(3, 5) +
                2 * DC(4, 2) - 5 * DC(4, 3) + 2 * DC(4, 4) :
                -DC(3, 1) + 13 * DC(3, 2) - 24 * DC(3, 3) + 13 * DC(3, 4) -
                DC(3, 5);
            ws[2] = (int16_t)est(Q00 * num, Q02, al);
          }
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)
              ws[3] = (int16_t)est(Q00 * (DC(2, 2) - DC(2, 4) + 2 * DC(3, 2) -
                                          2 * DC(3, 4) + DC(4, 2) - DC(4, 4)),
                                   Q03, al);
            if ((al = bits[7]) != 0 && ws[10] == 0)
              ws[10] = (int16_t)est(Q00 * (DC(2, 2) - 3 * DC(2, 3) + DC(2, 4) -
                                           DC(4, 2) + 3 * DC(4, 3) - DC(4, 4)),
                                    Q12, al);
            if ((al = bits[8]) != 0 && ws[17] == 0)
              ws[17] = (int16_t)est(Q00 * (DC(2, 2) - DC(2, 4) - 3 * DC(3, 2) +
                                           3 * DC(3, 4) + DC(4, 2) - DC(4, 4)),
                                    Q21, al);
            if ((al = bits[9]) != 0 && ws[24] == 0)
              ws[24] = (int16_t)est(Q00 * (DC(2, 2) + 2 * DC(2, 3) + DC(2, 4) -
                                           DC(4, 2) - 2 * DC(4, 3) - DC(4, 4)),
                                    Q30, al);
            int64_t num = 0;
            static const int kW[5][5] = {{-2, -6, -8, -6, -2},
                                         {-6, 6, 42, 6, -6},
                                         {-8, 42, 152, 42, -8},
                                         {-6, 6, 42, 6, -6},
                                         {-2, -6, -8, -6, -2}};
            for (int i = 0; i < 5; ++i)
              for (int j = 0; j < 5; ++j) num += kW[i][j] * (int64_t)dc[i][j];
            ws[0] = (int16_t)est(Q00 * num, Q00, 0);
          }
#undef DC
          idct_islow(ws, c.qt, c.plane.data() + (size_t)r * 8 * c.pw +
                     col * 8, c.pw);
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 4; ++j) dc[i][j] = dc[i][j + 1];
        }
      }
    }
  }

  void block(BitReader& br, Component& c, int16_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    int t = br.decode(dc_[c.td]);
    if (t > 11) throw Error{2, "corrupt DC difference"};
    int diff = t ? extend(br.bits(t), t) : 0;
    c.pred += diff;
    coef[0] = (int16_t)c.pred;
    for (int k = 1; k < 64;) {
      int rs = br.decode(ac_[c.ta]);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kZigzag[k]] = (int16_t)extend(br.bits(s), s);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // the component at full size, W x H, as jdsample.c upsamples it: the
  // fancy h2v1, h1v2 and h2v2 upsamplers, int_upsample for other ratios
  std::vector<uint8_t> upsample(const Component& c) {
    const int W = width_, H = height_;
    std::vector<uint8_t> out((size_t)W * H);
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const uint8_t* p = c.plane.data();
    const int pw = c.pw, dw = c.dw, dh = c.dh;
    std::vector<uint8_t> row(2 * (size_t)pw + 2);
    auto src = [&](int r) {
      return p + (size_t)(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * pw;
    };
    const bool fancy = (rh == 2 && rv == 1) || (rh == 1 && rv == 2) ||
                       (rh == 2 && rv == 2);
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out.data() + (size_t)y * W;
      if (rh == 1 && rv == 1) {
        std::memcpy(o, src(y), W);
        continue;
      }
      if (!fancy) {  // int_upsample: replication by integral ratios
        const uint8_t* in = src(y / rv);
        for (int i = 0; i < W; ++i) o[i] = in[i / rh];
        continue;
      }
      if (rv == 1) {  // h2v1
        const uint8_t* in = src(y);
        if (dw > 2) {
          row[0] = in[0];
          row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
          for (int i = 1; i < dw - 1; ++i) {
            int v = in[i] * 3;
            row[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
            row[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
          }
          row[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          row[2 * dw - 1] = in[dw - 1];
        } else {
          for (int i = 0; i < dw; ++i) row[2 * i] = row[2 * i + 1] = in[i];
        }
        std::memcpy(o, row.data(), W);
        continue;
      }
      // vertical factor 2: output row y from input row y / 2 and its
      // neighbour above (even y) or below (odd y)
      int r = y / 2, odd = y & 1;
      const uint8_t* in0 = src(r);
      const uint8_t* in1 = src(odd ? r + 1 : r - 1);
      if (rh == 1) {  // h1v2
        int bias = odd ? 2 : 1;
        for (int i = 0; i < W; ++i)
          o[i] = (uint8_t)((in0[i] * 3 + in1[i] + bias) >> 2);
        continue;
      }
      if (dw > 2) {  // h2v2 fancy
        int last, cur = in0[0] * 3 + in1[0], next = in0[1] * 3 + in1[1];
        row[0] = (uint8_t)((cur * 4 + 8) >> 4);
        row[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
        for (int i = 1; i < dw - 1; ++i) {
          next = in0[i + 1] * 3 + in1[i + 1];
          row[2 * i] = (uint8_t)((cur * 3 + last + 8) >> 4);
          row[2 * i + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
          last = cur;
          cur = next;
        }
        row[2 * dw - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
        row[2 * dw - 1] = (uint8_t)((cur * 4 + 7) >> 4);
      } else {  // h2v2 box
        for (int i = 0; i < dw; ++i) row[2 * i] = row[2 * i + 1] = in0[i];
      }
      std::memcpy(o, row.data(), W);
    }
    return out;
  }

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0, adobe_ = -1;
  int eobrun_ = 0;
  bool jfif_ = false, scanned_ = false, progressive_ = false, rgb_ = false;
  bool qdefined_[4] = {false, false, false, false};
  uint16_t quant_[4][64];
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;
};

int fail(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// The frame's width, height and channels (1 or 3).
int jpeg_header(const uint8_t* data, int64_t n, int32_t* w, int32_t* h,
                int32_t* channels, char* err, int32_t errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.run(true);
    *w = dec.width();
    *h = dec.height();
    *channels = dec.channels();
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::exception& e) {
    return fail(Error{2, e.what()}, err, errlen);
  }
}

// The pixels, [h, w, channels] uint8, into out (sized by jpeg_header).
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err,
                int32_t errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.run(false);
    dec.output(out);
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::exception& e) {
    return fail(Error{2, e.what()}, err, errlen);
  }
}

}  // extern "C"
