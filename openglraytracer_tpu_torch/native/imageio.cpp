// Native image codec of openglraytracer_tpu_torch, built from this source at
// first use by utils/native_imageio.py (the host C++ compiler, -O3 -fPIC
// -shared -std=c++17, linked with zlib) and called through ctypes:
//
//   oglrt_tonemap_u8          float RGB [0,1], row 0 bottom -> uint8 top-first
//   oglrt_encode_png          uint8 RGB -> PNG (filter 0, deflate level 6)
//   oglrt_encode_jpeg_yuv420  Y + half-resolution Cb, Cr planes -> JPEG
//   oglrt_encode_jpeg_rgb     uint8 RGB -> JPEG (4:2:0)
//   oglrt_encode_gif          n uint8 RGB frames -> looping animated GIF89a
//   oglrt_free                frees what an encoder returned
//
// The JPEG encoders are baseline sequential JPEG as libjpeg writes it with
// jpeg_set_quality(q, TRUE), 2x2 luma sampling and the standard Huffman
// tables (what PIL's JPEG save does): a JFIF 1.01 APP0 marker, the Annex K
// quantization tables scaled by libjpeg's quality rule and clamped to
// 1..255, the integer ("islow") forward DCT of jfdctint.c, the quantizer of
// jcdctmgr.c (a reciprocal multiply that rounds half away from zero), the
// Annex K Huffman tables, and libjpeg's edge handling: samples replicated
// to whole blocks of each component, blocks past a component's edge within
// the last MCU written as "dummy" blocks (zero AC, the DC of the block
// before). The RGB entry converts with jccolor.c's fixed-point tables and
// downsamples chroma with jcsample.c's h2v2 filter (2x2 sum plus a bias that
// alternates 1, 2 along the row, shifted right by 2).
//
// The GIF encoder writes a NETSCAPE2.0 loop extension and, per frame, a
// graphic control extension with the delay, a local palette from a median
// cut of the frame's colours (each pixel mapped to its nearest entry) and
// variable-width LZW with a clear code when the table is full.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

inline uint32_t be32(uint32_t v) {
  return ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) | ((v >> 8) & 0xFF00) |
         (v >> 24);
}

struct Buf {
  uint8_t* data;
  size_t size;
  size_t cap;
  void put(const void* p, size_t n) {
    if (size + n > cap) {
      cap = (size + n) * 2;
      data = static_cast<uint8_t*>(realloc(data, cap));
    }
    memcpy(data + size, p, n);
    size += n;
  }
  void byte(uint8_t b) { put(&b, 1); }
  void be16(unsigned v) {
    byte(static_cast<uint8_t>(v >> 8));
    byte(static_cast<uint8_t>(v));
  }
  void le16(unsigned v) {
    byte(static_cast<uint8_t>(v));
    byte(static_cast<uint8_t>(v >> 8));
  }
};

Buf new_buf(size_t cap) {
  return Buf{static_cast<uint8_t*>(malloc(cap)), 0, cap};
}

void put_chunk(Buf* b, const char tag[4], const uint8_t* data, size_t n) {
  uint32_t len = be32(static_cast<uint32_t>(n));
  b->put(&len, 4);
  size_t crc_start = b->size;
  b->put(tag, 4);
  if (n) b->put(data, n);
  uint32_t crc = crc32(0L, b->data + crc_start, static_cast<uInt>(n + 4));
  crc = be32(crc);
  b->put(&crc, 4);
}

// ---------------------------------------------------------------- JPEG

const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 Huffman tables: code counts by length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// zigzag position k -> row-major index in the 8x8 block
struct ZigZag {
  int at[64];
  ZigZag() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      int lo = s < 8 ? 0 : s - 7, hi = s < 8 ? s : 7;
      for (int i = 0; i < hi - lo + 1; ++i) {
        int row = (s & 1) ? lo + i : hi - i;  // odd diagonals run down
        at[k++] = row * 8 + (s - row);
      }
    }
  }
};
const ZigZag kZigZag;

struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
};

// the canonical codes of a table given by its counts and symbols
// (jchuff.c jpeg_make_c_derived_tbl)
HuffTable make_huff(const uint8_t* bits, const uint8_t* vals) {
  HuffTable t;
  memset(t.size, 0, sizeof t.size);
  memset(t.code, 0, sizeof t.code);
  t.bits = bits;
  t.vals = vals;
  unsigned code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      t.code[vals[k]] = static_cast<uint16_t>(code++);
      t.size[vals[k]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
  t.nvals = k;
  return t;
}

// libjpeg's quality rule (jcparam.c jpeg_quality_scaling and
// jpeg_add_quant_table with force_baseline)
void scale_quant(const int* base, int quality, int* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = (base[i] * scale + 50L) / 100L;
    if (v <= 0) v = 1;
    if (v > 255) v = 255;
    out[i] = static_cast<int>(v);
  }
}

// The quantizer of jcdctmgr.c for 16-bit DCT elements: the divisor is the
// table value times 8 (the islow DCT's output scale); |x| is divided by a
// reciprocal multiply with a rounding correction, and the sign restored.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor compute_reciprocal(unsigned divisor) {
  int b = 31 - __builtin_clz(divisor);  // floor(log2(divisor))
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return Divisor{fq & 0xFFFF, c & 0xFFFF, r};
}

inline int quantize(int x, const Divisor& d) {
  if (x < 0) {
    uint32_t p = (static_cast<uint32_t>(-x) + d.corr) * d.recip;
    return -static_cast<int>(p >> d.shift);
  }
  uint32_t p = (static_cast<uint32_t>(x) + d.corr) * d.recip;
  return static_cast<int>(p >> d.shift);
}

// jfdctint.c jpeg_fdct_islow: in-place on 64 level-shifted samples; the
// output is the DCT scaled by 8
void fdct_islow(int32_t* data) {
  const int CONST_BITS = 13, PASS1_BITS = 2;
  const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
  auto descale = [](int32_t x, int n) {
    return (x + (int32_t(1) << (n - 1))) >> n;
  };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;    // along a row, then a column
    const int next = pass == 0 ? 8 : 1;
    const int even_shift = pass == 0 ? -PASS1_BITS : PASS1_BITS;
    const int odd_bits = pass == 0 ? CONST_BITS - PASS1_BITS
                                   : CONST_BITS + PASS1_BITS;
    int32_t* p = data;
    for (int ctr = 0; ctr < 8; ++ctr, p += next) {
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step];
      int32_t tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step];
      int32_t tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (even_shift < 0) {
        p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
        p[4 * step] = (tmp10 - tmp11) * (1 << PASS1_BITS);
      } else {
        p[0] = descale(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = descale(tmp10 - tmp11, PASS1_BITS);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, odd_bits);
      p[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065, odd_bits);

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, odd_bits);
      p[5 * step] = descale(tmp5 + z2 + z4, odd_bits);
      p[3 * step] = descale(tmp6 + z2 + z3, odd_bits);
      p[step] = descale(tmp7 + z1 + z4, odd_bits);
    }
  }
}

// MSB-first bit writer of the entropy-coded segment, 0xFF stuffed with 0x00
struct BitWriter {
  Buf* out;
  uint32_t acc = 0;
  int n = 0;
  void emit_byte(uint8_t b) {
    out->byte(b);
    if (b == 0xFF) out->byte(0);
  }
  void put(uint32_t bits, int size) {
    acc = (acc << size) | (bits & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      n -= 8;
      emit_byte(static_cast<uint8_t>(acc >> n));
    }
    acc &= (1u << n) - 1;
  }
  void flush() {  // pad the last byte with 1 bits
    if (n) put(0x7F, 8 - n);
  }
};

// One component's samples, padded to whole MCUs: rows beyond the data
// repeat the last row, columns beyond it the last column.
struct Plane {
  std::vector<uint8_t> px;
  int stride = 0, rows = 0;
  int blocks_w = 0, blocks_h = 0;  // blocks holding image data
};

struct Component {
  const Plane* plane;
  int h, v;  // sampling factors
  int quant;  // table 0 (luma) or 1 (chroma)
  const HuffTable* dc;
  const HuffTable* ac;
  int last_dc = 0;
};

// Copy a (rows, cols) plane into a padded one with edge replication.
void pad_plane(const uint8_t* src, int rows, int cols, int src_stride,
               Plane* p) {
  p->px.resize(static_cast<size_t>(p->stride) * p->rows);
  for (int y = 0; y < p->rows; ++y) {
    const uint8_t* in = src + static_cast<size_t>(std::min(y, rows - 1))
                                  * src_stride;
    uint8_t* o = p->px.data() + static_cast<size_t>(y) * p->stride;
    memcpy(o, in, cols);
    memset(o + cols, in[cols - 1], p->stride - cols);
  }
}

void encode_block(BitWriter* bw, Component* c, const int32_t* coef) {
  int diff = coef[0] - c->last_dc;
  c->last_dc = coef[0];
  int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff;
  int nbits = 0;
  while (t) {
    nbits++;
    t >>= 1;
  }
  bw->put(c->dc->code[nbits], c->dc->size[nbits]);
  if (nbits) bw->put(static_cast<uint32_t>(t2), nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kZigZag.at[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw->put(c->ac->code[0xF0], c->ac->size[0xF0]);
      run -= 16;
    }
    t = v < 0 ? -v : v;
    t2 = v < 0 ? v - 1 : v;
    nbits = 1;
    while (t >>= 1) nbits++;
    int sym = (run << 4) + nbits;
    bw->put(c->ac->code[sym], c->ac->size[sym]);
    bw->put(static_cast<uint32_t>(t2), nbits);
    run = 0;
  }
  if (run > 0) bw->put(c->ac->code[0], c->ac->size[0]);
}

void put_dqt(Buf* b, int id, const int* q) {
  b->be16(0xFFDB);
  b->be16(67);
  b->byte(static_cast<uint8_t>(id));
  for (int k = 0; k < 64; ++k) b->byte(static_cast<uint8_t>(q[kZigZag.at[k]]));
}

void put_dht(Buf* b, int cls_id, const HuffTable& t) {
  b->be16(0xFFC4);
  b->be16(2 + 1 + 16 + t.nvals);
  b->byte(static_cast<uint8_t>(cls_id));
  b->put(t.bits, 16);
  b->put(t.vals, t.nvals);
}

// Write the JPEG of a Y plane (h, w) and Cb, Cr planes already padded to
// the MCU grid (4:2:0). Returns the byte count, -1 on failure.
long write_jpeg(const Plane& y, const Plane& cb, const Plane& cr, int h,
                int w, int quality, uint8_t** out) {
  static const HuffTable dc_luma = make_huff(kDcLumaBits, kDcVals);
  static const HuffTable dc_chroma = make_huff(kDcChromaBits, kDcVals);
  static const HuffTable ac_luma = make_huff(kAcLumaBits, kAcLumaVals);
  static const HuffTable ac_chroma = make_huff(kAcChromaBits, kAcChromaVals);
  int q[2][64];
  scale_quant(kLumaQuant, quality, q[0]);
  scale_quant(kChromaQuant, quality, q[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i)
      div[t][i] = compute_reciprocal(static_cast<unsigned>(q[t][i]) << 3);

  Buf b = new_buf(static_cast<size_t>(w) * h / 2 + 4096);
  if (!b.data) return -1;
  b.be16(0xFFD8);
  static const uint8_t app0[16] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,
                                   1,    1,    0, 0,  1,   0,   1};
  b.put(app0, 16);
  b.byte(0);
  b.byte(0);  // no thumbnail
  put_dqt(&b, 0, q[0]);
  put_dqt(&b, 1, q[1]);
  b.be16(0xFFC0);  // SOF0: baseline, 8-bit, three components
  b.be16(17);
  b.byte(8);
  b.be16(h);
  b.be16(w);
  b.byte(3);
  static const uint8_t sof_comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  b.put(sof_comps, 9);
  put_dht(&b, 0x00, dc_luma);
  put_dht(&b, 0x10, ac_luma);
  put_dht(&b, 0x01, dc_chroma);
  put_dht(&b, 0x11, ac_chroma);
  b.be16(0xFFDA);  // SOS: every component in one interleaved scan
  b.be16(12);
  b.byte(3);
  static const uint8_t sos[9] = {1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  b.put(sos, 9);

  Component comps[3] = {{&y, 2, 2, 0, &dc_luma, &ac_luma},
                        {&cb, 1, 1, 1, &dc_chroma, &ac_chroma},
                        {&cr, 1, 1, 1, &dc_chroma, &ac_chroma}};
  BitWriter bw{&b};
  const int mcu_cols = (w + 15) / 16, mcu_rows = (h + 15) / 16;
  int32_t blk[64], coef[64];
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      for (Component& c : comps) {
        const Plane& p = *c.plane;
        int prev_dc = c.last_dc;  // the DC a dummy block repeats
        for (int by = 0; by < c.v; ++by) {
          for (int bx = 0; bx < c.h; ++bx) {
            int row = my * c.v + by, col = mx * c.h + bx;
            if (row < p.blocks_h && col < p.blocks_w) {
              const uint8_t* src = p.px.data()
                                   + static_cast<size_t>(row) * 8 * p.stride
                                   + col * 8;
              for (int i = 0; i < 8; ++i)
                for (int j = 0; j < 8; ++j)
                  blk[i * 8 + j] = src[i * p.stride + j] - 128;
              fdct_islow(blk);
              for (int i = 0; i < 64; ++i)
                coef[i] = quantize(blk[i], div[c.quant][i]);
            } else {
              memset(coef, 0, sizeof coef);
              coef[0] = prev_dc;
            }
            prev_dc = coef[0];
            encode_block(&bw, &c, coef);
          }
        }
      }
    }
  }
  bw.flush();
  b.be16(0xFFD9);
  *out = b.data;
  return static_cast<long>(b.size);
}

void init_plane(Plane* p, int rows, int cols, int h_samp, int v_samp,
                int mcu_rows, int mcu_cols) {
  p->blocks_w = (cols + 7) / 8;
  p->blocks_h = (rows + 7) / 8;
  p->stride = mcu_cols * 8 * h_samp;
  p->rows = mcu_rows * 8 * v_samp;
}

// ---------------------------------------------------------------- GIF

struct Box {
  int lo, hi;  // range in the colour list
  long count;  // pixels
  int axis, range;
};

void measure(Box* box, const std::vector<uint32_t>& col,
             const std::vector<uint32_t>& cnt) {
  int mn[3] = {255, 255, 255}, mx[3] = {0, 0, 0};
  box->count = 0;
  for (int i = box->lo; i < box->hi; ++i) {
    for (int a = 0; a < 3; ++a) {
      int v = (col[i] >> (16 - 8 * a)) & 0xFF;
      mn[a] = std::min(mn[a], v);
      mx[a] = std::max(mx[a], v);
    }
    box->count += cnt[i];
  }
  box->axis = 0;
  for (int a = 1; a < 3; ++a)
    if (mx[a] - mn[a] > mx[box->axis] - mn[box->axis]) box->axis = a;
  box->range = mx[box->axis] - mn[box->axis];
}

// Median cut over the frame's colour histogram: the box with the most
// pixels times its widest side is split at its pixel median along that
// side, until there are `colors` boxes or none can split; each entry is
// its box's pixel-weighted mean. Returns the palette size.
int median_cut(const uint8_t* rgb, size_t npx, int colors, uint8_t* pal) {
  std::vector<uint32_t> keys(npx), col, cnt;
  for (size_t i = 0; i < npx; ++i) {
    const uint8_t* p = rgb + 3 * i;
    keys[i] = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
  }
  std::sort(keys.begin(), keys.end());
  for (size_t i = 0; i < npx; ++i) {
    if (i == 0 || keys[i] != keys[i - 1]) {
      col.push_back(keys[i]);
      cnt.push_back(0);
    }
    cnt.back()++;
  }
  std::vector<Box> boxes(1);
  boxes[0].lo = 0;
  boxes[0].hi = static_cast<int>(col.size());
  measure(&boxes[0], col, cnt);
  std::vector<std::pair<uint32_t, uint32_t>> seg;
  while (static_cast<int>(boxes.size()) < colors) {
    int best = -1;
    double score = 0.0;
    for (size_t i = 0; i < boxes.size(); ++i) {
      const Box& bx = boxes[i];
      double s = double(bx.count) * bx.range;
      if (bx.hi - bx.lo > 1 && bx.range > 0 && s > score) {
        score = s;
        best = static_cast<int>(i);
      }
    }
    if (best < 0) break;
    Box bx = boxes[best];
    int shift = 16 - 8 * bx.axis;
    seg.clear();
    for (int i = bx.lo; i < bx.hi; ++i) seg.emplace_back(col[i], cnt[i]);
    std::stable_sort(seg.begin(), seg.end(), [shift](auto& a, auto& b) {
      return ((a.first >> shift) & 0xFF) < ((b.first >> shift) & 0xFF);
    });
    for (int i = bx.lo; i < bx.hi; ++i) {
      col[i] = seg[i - bx.lo].first;
      cnt[i] = seg[i - bx.lo].second;
    }
    long half = 0;
    int cut = bx.lo;
    while (cut < bx.hi - 1 && half + cnt[cut] <= bx.count / 2)
      half += cnt[cut++];
    if (cut == bx.lo) cut++;  // each side keeps a colour
    Box a = bx, c = bx;
    a.hi = cut;
    c.lo = cut;
    measure(&a, col, cnt);
    measure(&c, col, cnt);
    boxes[best] = a;
    boxes.push_back(c);
  }
  for (size_t i = 0; i < boxes.size(); ++i) {
    double sum[3] = {0, 0, 0};
    for (int k = boxes[i].lo; k < boxes[i].hi; ++k)
      for (int a = 0; a < 3; ++a)
        sum[a] += double(cnt[k]) * ((col[k] >> (16 - 8 * a)) & 0xFF);
    for (int a = 0; a < 3; ++a)
      pal[3 * i + a] =
          static_cast<uint8_t>(sum[a] / double(boxes[i].count) + 0.5);
  }
  return static_cast<int>(boxes.size());
}

// Index of each pixel: its nearest palette entry by squared RGB distance,
// the lowest index on a tie. The colour cube is cut into 8x8x8 cells; a
// cell's candidates, found at its first pixel, are the entries whose least
// distance to the cell is within the least largest distance of any entry,
// which holds every colour of the cell's nearest entry.
void map_pixels(const uint8_t* rgb, size_t npx, const uint8_t* pal, int n,
                uint8_t* idx) {
  std::vector<int> first(32 * 32 * 32 + 1, -1);
  std::vector<uint8_t> cand;
  std::vector<int> start, count;
  for (size_t i = 0; i < npx; ++i) {
    const uint8_t* p = rgb + 3 * i;
    int cell = ((p[0] >> 3) << 10) | ((p[1] >> 3) << 5) | (p[2] >> 3);
    if (first[cell] < 0) {
      int lo[3] = {p[0] & ~7, p[1] & ~7, p[2] & ~7};
      std::vector<int> mind(n);
      int bound = 1 << 30;
      for (int e = 0; e < n; ++e) {
        int dmin = 0, dmax = 0;
        for (int a = 0; a < 3; ++a) {
          int v = pal[3 * e + a];
          int below = lo[a] - v, above = v - (lo[a] + 7);
          int d = below > 0 ? below : (above > 0 ? above : 0);
          int far = std::max(std::abs(v - lo[a]), std::abs(v - lo[a] - 7));
          dmin += d * d;
          dmax += far * far;
        }
        mind[e] = dmin;
        bound = std::min(bound, dmax);
      }
      first[cell] = static_cast<int>(start.size());
      start.push_back(static_cast<int>(cand.size()));
      for (int e = 0; e < n; ++e)
        if (mind[e] <= bound) cand.push_back(static_cast<uint8_t>(e));
      count.push_back(static_cast<int>(cand.size()) - start.back());
    }
    const int c = first[cell];
    const uint8_t* list = cand.data() + start[c];
    int best = list[0], bd = 1 << 30;
    for (int k = 0; k < count[c]; ++k) {
      const uint8_t* q = pal + 3 * list[k];
      int dr = p[0] - q[0], dg = p[1] - q[1], db = p[2] - q[2];
      int d = dr * dr + dg * dg + db * db;
      if (d < bd) {
        bd = d;
        best = list[k];
      }
    }
    idx[i] = static_cast<uint8_t>(best);
  }
}

// LSB-first code packer into 255-byte GIF data sub-blocks
struct SubBlocks {
  Buf* out;
  uint8_t block[255];
  int fill = 0;
  uint32_t acc = 0;
  int n = 0;
  void byte(uint8_t b) {
    block[fill++] = b;
    if (fill == 255) flush_block();
  }
  void flush_block() {
    if (!fill) return;
    out->byte(static_cast<uint8_t>(fill));
    out->put(block, fill);
    fill = 0;
  }
  void code(unsigned c, int size) {
    acc |= uint32_t(c) << n;
    n += size;
    while (n >= 8) {
      byte(static_cast<uint8_t>(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void finish() {
    if (n) byte(static_cast<uint8_t>(acc));
    flush_block();
    out->byte(0);  // block terminator
  }
};

// GIF LZW of npx indices below 1 << min_size. The decoder adds an entry
// after every code but the first after a clear, and widens its codes when
// its next entry reaches 1 << width; the encoder adds one entry ahead of
// it, so it widens when the entry it adds is 1 << width. The table is
// cleared rather than let grow to its 4096th entry.
void lzw(const uint8_t* idx, size_t npx, int min_size, Buf* out) {
  const int clear = 1 << min_size, eoi = clear + 1;
  // child[code * 256 + symbol]: the code of string(code) + symbol, or 0
  std::vector<uint16_t> child(4096 * 256, 0);
  SubBlocks sb{out, {}};
  out->byte(static_cast<uint8_t>(min_size));
  int width = min_size + 1, next = eoi + 1;
  sb.code(clear, width);
  unsigned cur = idx[0];
  for (size_t i = 1; i < npx; ++i) {
    unsigned sym = idx[i];
    uint16_t c = child[cur * 256 + sym];
    if (c) {
      cur = c;
      continue;
    }
    sb.code(cur, width);
    if (next == 4095) {
      sb.code(clear, width);
      std::fill(child.begin(), child.end(), 0);
      width = min_size + 1;
      next = eoi + 1;
    } else {
      if (next == (1 << width)) width++;
      child[cur * 256 + sym] = static_cast<uint16_t>(next++);
    }
    cur = sym;
  }
  sb.code(cur, width);
  if (next < 4095 && next == (1 << width) && width < 12) width++;
  sb.code(eoi, width);
  sb.finish();
}

}  // namespace

extern "C" {

// float RGB (h, w, 3) in [0,1], row 0 = bottom -> uint8 (h, w, 3) row 0 = top
void oglrt_tonemap_u8(const float* src, uint8_t* dst, int h, int w) {
  for (int y = 0; y < h; ++y) {
    const float* in = src + static_cast<size_t>(h - 1 - y) * w * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * w * 3;
    for (int i = 0; i < w * 3; ++i) {
      float v = in[i];
      v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
      out[i] = static_cast<uint8_t>(v * 255.0f + 0.5f);
    }
  }
}

// Encode (h, w, 3) uint8 top-first rows to PNG. Returns malloc'd buffer in
// *out (caller frees with oglrt_free); returns byte size, or -1 on error.
long oglrt_encode_png(const uint8_t* rgb, int h, int w, uint8_t** out) {
  // Filter-0 scanlines
  size_t stride = static_cast<size_t>(w) * 3;
  size_t raw_size = (stride + 1) * h;
  uint8_t* raw = static_cast<uint8_t*>(malloc(raw_size));
  if (!raw) return -1;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw + static_cast<size_t>(y) * (stride + 1);
    row[0] = 0;
    memcpy(row + 1, rgb + static_cast<size_t>(y) * stride, stride);
  }

  uLongf comp_cap = compressBound(static_cast<uLong>(raw_size));
  uint8_t* comp = static_cast<uint8_t*>(malloc(comp_cap));
  if (!comp) {
    free(raw);
    return -1;
  }
  if (compress2(comp, &comp_cap, raw, static_cast<uLong>(raw_size), 6) !=
      Z_OK) {
    free(raw);
    free(comp);
    return -1;
  }
  free(raw);

  Buf b{static_cast<uint8_t*>(malloc(1 << 16)), 0, 1 << 16};
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  b.put(sig, 8);

  uint8_t ihdr[13];
  uint32_t wbe = be32(w), hbe = be32(h);
  memcpy(ihdr, &wbe, 4);
  memcpy(ihdr + 4, &hbe, 4);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(&b, "IHDR", ihdr, 13);
  put_chunk(&b, "IDAT", comp, comp_cap);
  put_chunk(&b, "IEND", nullptr, 0);
  free(comp);

  *out = b.data;
  return static_cast<long>(b.size);
}

// JPEG of 4:2:0 planes, rows top-first: y (h, w), cb and cr (h/2, w/2);
// h and w even. The same file as libjpeg's of the YCbCr image whose chroma
// is each plane repeated 2x2 (its 2x2 average gives the planes back).
long oglrt_encode_jpeg_yuv420(const uint8_t* y, const uint8_t* cb,
                              const uint8_t* cr, int h, int w, int quality,
                              uint8_t** out) {
  if (h <= 0 || w <= 0 || (h & 1) || (w & 1) || h > 65535 || w > 65535)
    return -1;
  const int mcu_rows = (h + 15) / 16, mcu_cols = (w + 15) / 16;
  Plane py, pcb, pcr;
  init_plane(&py, h, w, 2, 2, mcu_rows, mcu_cols);
  init_plane(&pcb, h / 2, w / 2, 1, 1, mcu_rows, mcu_cols);
  init_plane(&pcr, h / 2, w / 2, 1, 1, mcu_rows, mcu_cols);
  pad_plane(y, h, w, w, &py);
  pad_plane(cb, h / 2, w / 2, w / 2, &pcb);
  pad_plane(cr, h / 2, w / 2, w / 2, &pcr);
  return write_jpeg(py, pcb, pcr, h, w, quality, out);
}

// JPEG (4:2:0) of (h, w, 3) uint8 RGB, rows top-first, converted and
// downsampled as libjpeg does.
long oglrt_encode_jpeg_rgb(const uint8_t* rgb, int h, int w, int quality,
                           uint8_t** out) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) return -1;
  // jccolor.c rgb_ycc_start: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
  const int32_t one_half = 1 << 15, cbcr_offset = 128 << 16;
  const int32_t fy_r = 19595, fy_g = 38470, fy_b = 7471;
  const int32_t fcb_r = 11059, fcb_g = 21709, f_half = 32768;
  const int32_t fcr_g = 27439, fcr_b = 5329;
  const int mcu_rows = (h + 15) / 16, mcu_cols = (w + 15) / 16;
  const int full_w = mcu_cols * 16;     // columns the downsampler reads
  const int full_h = (h + 1) / 2 * 2;   // rows padded to a row pair
  std::vector<uint8_t> yy(static_cast<size_t>(h) * w);
  std::vector<uint8_t> cc[2];
  cc[0].resize(static_cast<size_t>(full_h) * full_w);
  cc[1].resize(static_cast<size_t>(full_h) * full_w);
  for (int r = 0; r < h; ++r) {
    const uint8_t* in = rgb + static_cast<size_t>(r) * w * 3;
    uint8_t* oy = yy.data() + static_cast<size_t>(r) * w;
    uint8_t* ob = cc[0].data() + static_cast<size_t>(r) * full_w;
    uint8_t* orr = cc[1].data() + static_cast<size_t>(r) * full_w;
    for (int x = 0; x < w; ++x) {
      int32_t R = in[3 * x], G = in[3 * x + 1], B = in[3 * x + 2];
      oy[x] = static_cast<uint8_t>(
          (fy_r * R + fy_g * G + fy_b * B + one_half) >> 16);
      ob[x] = static_cast<uint8_t>(
          (-fcb_r * R - fcb_g * G + f_half * B + cbcr_offset + one_half - 1)
          >> 16);
      orr[x] = static_cast<uint8_t>(
          (f_half * R - fcr_g * G - fcr_b * B + cbcr_offset + one_half - 1)
          >> 16);
    }
    memset(ob + w, ob[w - 1], full_w - w);
    memset(orr + w, orr[w - 1], full_w - w);
  }
  for (int k = 0; k < 2; ++k)
    if (full_h > h)
      memcpy(cc[k].data() + static_cast<size_t>(h) * full_w,
             cc[k].data() + static_cast<size_t>(h - 1) * full_w, full_w);
  const int ch = full_h / 2, cw = full_w / 2;
  std::vector<uint8_t> half[2];
  for (int k = 0; k < 2; ++k) {
    half[k].resize(static_cast<size_t>(ch) * cw);
    for (int r = 0; r < ch; ++r) {
      const uint8_t* i0 = cc[k].data() + static_cast<size_t>(2 * r) * full_w;
      const uint8_t* i1 = i0 + full_w;
      uint8_t* o = half[k].data() + static_cast<size_t>(r) * cw;
      int bias = 1;  // jcsample.c h2v2_downsample: 1, 2, 1, 2, ...
      for (int x = 0; x < cw; ++x) {
        o[x] = static_cast<uint8_t>(
            (i0[2 * x] + i0[2 * x + 1] + i1[2 * x] + i1[2 * x + 1] + bias)
            >> 2);
        bias ^= 3;
      }
    }
  }
  Plane py, pcb, pcr;
  init_plane(&py, h, w, 2, 2, mcu_rows, mcu_cols);
  init_plane(&pcb, ch, (w + 1) / 2, 1, 1, mcu_rows, mcu_cols);
  init_plane(&pcr, ch, (w + 1) / 2, 1, 1, mcu_rows, mcu_cols);
  pad_plane(yy.data(), h, w, w, &py);
  pad_plane(half[0].data(), ch, cw, cw, &pcb);
  pad_plane(half[1].data(), ch, cw, cw, &pcr);
  return write_jpeg(py, pcb, pcr, h, w, quality, out);
}

// Animated GIF89a of n frames (n, h, w, 3) uint8 RGB, rows top-first, each
// shown delay_cs hundredths of a second, looping `loop` times (0: forever).
long oglrt_encode_gif(const uint8_t* frames, int n, int h, int w,
                      int delay_cs, int loop, uint8_t** out) {
  if (n <= 0 || h <= 0 || w <= 0 || h > 65535 || w > 65535) return -1;
  const size_t npx = static_cast<size_t>(h) * w;
  Buf b = new_buf(npx * n / 2 + 1024);
  if (!b.data) return -1;
  b.put("GIF89a", 6);
  b.le16(w);
  b.le16(h);
  b.byte(0x70);  // no global palette, 8-bit colour resolution
  b.byte(0);     // background index
  b.byte(0);     // square pixels
  b.put("\x21\xFF\x0BNETSCAPE2.0\x03\x01", 16);
  b.le16(loop);
  b.byte(0);
  std::vector<uint8_t> idx(npx);
  uint8_t pal[256 * 3];
  for (int f = 0; f < n; ++f) {
    const uint8_t* rgb = frames + npx * 3 * f;
    int colors = median_cut(rgb, npx, 256, pal);
    map_pixels(rgb, npx, pal, colors, idx.data());
    int bits = 1;
    while ((1 << bits) < colors) bits++;
    b.put("\x21\xF9\x04", 3);  // graphic control: delay, no transparency
    b.byte(0);
    b.le16(delay_cs);
    b.byte(0);
    b.byte(0);
    b.byte(0x2C);  // image descriptor with a local palette
    b.le16(0);
    b.le16(0);
    b.le16(w);
    b.le16(h);
    b.byte(static_cast<uint8_t>(0x80 | (bits - 1)));
    memset(pal + 3 * colors, 0, 3 * ((1 << bits) - colors));
    b.put(pal, 3 * (1 << bits));
    lzw(idx.data(), npx, bits < 2 ? 2 : bits, &b);
  }
  b.byte(0x3B);
  *out = b.data;
  return static_cast<long>(b.size);
}

void oglrt_free(uint8_t* p) { free(p); }

}  // extern "C"
