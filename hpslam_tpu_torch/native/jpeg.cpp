// Baseline JPEG codec for the port's RGB-D readers (host code, no GPU).
//
// The reference reads the colour frames of the Replica, ScanNet and Azure
// trees with cv2.imread (hpslam_tpu/utils/datasets.py); the card's machine
// has no cv2, so the port decodes JPEG itself.  Huffman decoding is a
// sequential bit loop (a 1296x968 ScanNet frame holds ~29,000 blocks), so
// it is C++, built at first use by the port's native loader
// (hpslam_tpu_torch/native/__init__.py) and bound with ctypes.
//
// Decoder scope: baseline and extended sequential Huffman JPEG (SOF0 /
// SOF1) with 8-bit samples, one or three components, sampling factors 1 or
// 2 in each direction, standard or custom Huffman and quantisation tables,
// restart markers, interleaved or single-component scans.  Anything else
// (progressive, lossless, arithmetic coding, 12-bit, four components) is
// refused with the marker found.
//
// It computes what cv2.imread returns (OpenCV on libjpeg-turbo with its
// defaults), in RGB order: the accurate integer IDCT ("islow", jidctint.c:
// 13-bit constants, two passes, the post-IDCT range-limit table),
// "fancy" upsampling of subsampled components (jdsample.c: the triangle
// filter h2v1 / h1v2 / h2v2 with its rounding biases and edge rules, box
// replication where a component is 2 or fewer samples wide) and the
// fixed-point YCbCr -> RGB tables (jdcolor.c, 16 fraction bits).  The
// arithmetic is integer throughout, so the result is cv2's bit for bit.
//
// Encoder: baseline JPEG with the standard (Annex K) quantisation tables
// scaled to a quality as libjpeg scales them, the standard Huffman tables,
// 4:4:4 or 4:2:0 (grey: one component), a float DCT; used to write test
// and smoke trees where no cv2 is installed.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// natural (row-major) index of the k-th coefficient in zigzag order
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

std::string hex2(int m) {
  char b[8];
  std::snprintf(b, sizeof(b), "0x%02X", m & 0xFF);
  return b;
}

std::string sof_name(int m) {
  switch (m) {
    case 0xC2: return "SOF2 (progressive DCT, Huffman)";
    case 0xC3: return "SOF3 (lossless, Huffman)";
    case 0xC5: return "SOF5 (differential sequential, Huffman)";
    case 0xC6: return "SOF6 (differential progressive, Huffman)";
    case 0xC7: return "SOF7 (differential lossless, Huffman)";
    case 0xC9: return "SOF9 (sequential, arithmetic)";
    case 0xCA: return "SOF10 (progressive, arithmetic)";
    case 0xCB: return "SOF11 (lossless, arithmetic)";
    case 0xCD: return "SOF13 (differential sequential, arithmetic)";
    case 0xCE: return "SOF14 (differential progressive, arithmetic)";
    case 0xCF: return "SOF15 (differential lossless, arithmetic)";
    default: return "marker " + hex2(m);
  }
}

// ---------------------------------------------------------------------------
// Decoder

struct Huff {
  bool defined = false;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  uint8_t look_len[512];   // code length for a 9-bit lookahead, 0: longer
  uint8_t look_sym[512];
};

void build_huff(Huff& h, const uint8_t bits[17], const uint8_t* vals,
                int nvals) {
  int code = 0, k = 0;
  std::memset(h.look_len, 0, sizeof(h.look_len));
  for (int l = 1; l <= 16; ++l) {
    h.valptr[l] = k;
    h.mincode[l] = code;
    for (int i = 0; i < bits[l]; ++i, ++code, ++k) {
      if (l <= 9) {
        const int pad = 9 - l;
        for (int s = 0; s < (1 << pad); ++s) {
          h.look_len[(code << pad) | s] = (uint8_t)l;
          h.look_sym[(code << pad) | s] = vals[k];
        }
      }
    }
    h.maxcode[l] = bits[l] ? code - 1 : -1;
    if (code > (1 << l)) throw JpegError("bad Huffman table");
    code <<= 1;
  }
  h.maxcode[17] = 0x7FFFFFFF;
  std::memcpy(h.vals, vals, nvals);
  h.defined = true;
}

// Entropy-coded data: bits MSB first, 0xFF00 unstuffed; at a marker the
// reader feeds zeros (as libjpeg does) and leaves the marker in place.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;   // left-aligned
  int n = 0;
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            b = 0xFF;
            p += 2;
          } else {
            at_marker = true;
          }
        } else {
          b = *p++;
        }
      }
      acc |= b << (56 - n);
      n += 8;
    }
  }
  int peek(int k) {
    if (n < k) fill();
    return (int)(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    n -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    const int v = peek(k);
    skip(k);
    return v;
  }
  void reset() {
    acc = 0;
    n = 0;
  }
};

int decode_sym(Bits& b, const Huff& h) {
  const int look = b.peek(16) >> 7;
  const int l = h.look_len[look];
  if (l) {
    b.skip(l);
    return h.look_sym[look];
  }
  int code = b.peek(16);
  for (int len = 10; len <= 16; ++len) {
    const int c = code >> (16 - len);
    if (c <= h.maxcode[len]) {
      b.skip(len);
      return h.vals[h.valptr[len] + c - h.mincode[len]];
    }
  }
  throw JpegError("corrupt data: bad Huffman code");
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;        // blocks allocated (the MCU-padded grid)
  int dw = 0, dh = 0;        // downsampled size in samples
  int td = 0, ta = 0, pred = 0;
  bool latched = false;
  int16_t q[64];             // natural order, as libjpeg's 16-bit
                             // ISLOW_MULT_TYPE holds it
  std::vector<int16_t> coef; // bw * bh * 64, natural order
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
};

struct Decoder {
  const uint8_t* buf;
  const uint8_t* end;
  const uint8_t* p;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Comp> comps;
  int W = 0, H = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int scans = 0;

  int u8() {
    if (p >= end) throw JpegError("truncated file");
    return *p++;
  }
  int u16() {
    const int a = u8();
    return (a << 8) | u8();
  }

  void read_dqt(const uint8_t* seg_end) {
    while (p < seg_end) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw JpegError("bad DQT");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = (uint16_t)(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
  }

  void read_dht(const uint8_t* seg_end) {
    while (p < seg_end) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw JpegError("bad DHT");
      uint8_t bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = (uint8_t)u8();
        total += bits[l];
      }
      if (total > 256) throw JpegError("bad DHT");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)u8();
      build_huff(tc ? ac[th] : dc[th], bits, vals, total);
    }
  }

  void read_sof(int marker) {
    if (frame) throw JpegError("more than one frame");
    const int prec = u8();
    if (prec != 8)
      throw JpegError(std::to_string(prec) + "-bit samples (only 8-bit)");
    H = u16();
    W = u16();
    const int nc = u8();
    if (H <= 0 || W <= 0) throw JpegError("bad image size");
    if (nc != 1 && nc != 3)
      throw JpegError(std::to_string(nc) + " components (only 1 or 3)");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        throw JpegError("sampling factors " + std::to_string(c.h) + "x" +
                        std::to_string(c.v) + " (only 1 or 2)");
      if (c.tq > 3) throw JpegError("bad SOF");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    (void)marker;
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (W * c.h + hmax - 1) / hmax;
      c.dh = (H * c.v + vmax - 1) / vmax;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
  }

  void decode_block(Bits& b, Comp& c, int by, int bx) {
    int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
    const int t = decode_sym(b, dc[c.td]);
    if (t > 15) throw JpegError("corrupt data: bad DC size");
    c.pred += t ? extend(b.get(t), t) : 0;
    blk[0] = (int16_t)c.pred;
    const Huff& h = ac[c.ta];
    for (int k = 1; k < 64;) {
      const int rs = decode_sym(b, h);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw JpegError("corrupt data: bad AC run");
        blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // After a restart interval: the RSTn marker, then fresh predictions.
  void do_restart(Bits& b, int& expect) {
    b.reset();
    const uint8_t* q = b.p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] >= 0xD0 && q[1] <= 0xD7))
      ++q;
    if (q + 1 >= end) throw JpegError("missing restart marker");
    if ((q[1] & 7) != expect)
      throw JpegError("restart marker out of order");
    expect = (expect + 1) & 7;
    b.p = q + 2;
    b.at_marker = false;
    for (auto& c : comps) c.pred = 0;
  }

  void read_sos() {
    if (!frame) throw JpegError("SOS before SOF");
    const int ns = u8();
    if (ns < 1 || ns > (int)comps.size()) throw JpegError("bad SOS");
    std::vector<Comp*> sc;
    for (int i = 0; i < ns; ++i) {
      const int cid = u8(), tdta = u8();
      Comp* c = nullptr;
      for (auto& cc : comps)
        if (cc.id == cid) c = &cc;
      if (!c) throw JpegError("SOS names an unknown component");
      c->td = tdta >> 4;
      c->ta = tdta & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined)
        throw JpegError("SOS uses an undefined Huffman table");
      if (!c->latched) {
        if (!qt_defined[c->tq])
          throw JpegError("component uses an undefined quantisation table");
        for (int k = 0; k < 64; ++k) c->q[k] = (int16_t)qt[c->tq][k];
        c->latched = true;
      }
      c->pred = 0;
      sc.push_back(c);
    }
    const int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      throw JpegError("spectral selection or approximation in a "
                      "sequential scan");
    Bits b;
    b.p = p;
    b.end = end;
    int expect = 0, left = restart;
    auto tick = [&]() {
      if (!restart) return;
      if (--left == 0) {
        do_restart(b, expect);
        left = restart;
      }
    };
    if (ns == 1) {
      Comp& c = *sc[0];
      const int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          decode_block(b, c, by, bx);
          if (by != nby - 1 || bx != nbx - 1) tick();
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          for (Comp* c : sc)
            for (int y = 0; y < c->v; ++y)
              for (int x = 0; x < c->h; ++x)
                decode_block(b, *c, my * c->v + y, mx * c->h + x);
          if (my != mcuy - 1 || mx != mcux - 1) tick();
        }
    }
    // continue at the next marker
    const uint8_t* q = b.p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0x00 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7)))
      ++q;
    p = q;
    ++scans;
  }

  void parse() {
    p = buf;
    if (u16() != 0xFFD8) throw JpegError("not a JPEG file (no SOI)");
    for (;;) {
      int m = u8();
      if (m != 0xFF) throw JpegError("expected a marker");
      while ((m = u8()) == 0xFF) {
      }
      if (m == 0xD9) break;                  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
      if (m == 0x01) continue;               // TEM
      const int len = u16();
      if (len < 2 || p + len - 2 > end) throw JpegError("truncated segment");
      const uint8_t* seg_end = p + len - 2;
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
      } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                 m != 0xCC) {
        throw JpegError("unsupported " + sof_name(m) +
                        "; only baseline / extended sequential Huffman");
      } else if (m == 0xCC) {
        throw JpegError("unsupported DAC (arithmetic coding tables)");
      } else if (m == 0xC4) {
        read_dht(seg_end);
      } else if (m == 0xDB) {
        read_dqt(seg_end);
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m == 0xDA) {
        read_sos();
        continue;
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(p, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = p[11];
        }
      }
      p = seg_end;
    }
    if (!frame || !scans) throw JpegError("no image data");
  }

  // ------------------------------------------------------------------
  // jidctint.c's jpeg_idct_islow, 8-bit samples
  static uint8_t idct_limit[1024];

  static void init_limit() {
    for (int t = 0; t < 1024; ++t) {
      int v;
      if (t < 128) v = t + 128;
      else if (t < 512) v = 255;
      else if (t < 896) v = 0;
      else v = t - 896;
      idct_limit[t] = (uint8_t)v;
    }
  }

  static void idct_block(const int16_t* in, const int16_t* q, uint8_t* out,
                         int stride) {
    const int CB = 13, P1 = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299,
                  F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    auto descale = [](int64_t x, int n) {
      return (x + ((int64_t)1 << (n - 1))) >> n;
    };
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const int16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        const int dc = (ip[0] * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
                    t12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
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
      wp[0] = (int)descale(t10 + tmp3, CB - P1);
      wp[56] = (int)descale(t10 - tmp3, CB - P1);
      wp[8] = (int)descale(t11 + tmp2, CB - P1);
      wp[48] = (int)descale(t11 - tmp2, CB - P1);
      wp[16] = (int)descale(t12 + tmp1, CB - P1);
      wp[40] = (int)descale(t12 - tmp1, CB - P1);
      wp[24] = (int)descale(t13 + tmp0, CB - P1);
      wp[32] = (int)descale(t13 - tmp0, CB - P1);
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
          !wp[7]) {
        const uint8_t v =
            idct_limit[(int)descale(wp[0], P1 + 3) & 1023];
        for (int c = 0; c < 8; ++c) op[c] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
                    t12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
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
      const int sh = CB + P1 + 3;
      op[0] = idct_limit[(int)descale(t10 + tmp3, sh) & 1023];
      op[7] = idct_limit[(int)descale(t10 - tmp3, sh) & 1023];
      op[1] = idct_limit[(int)descale(t11 + tmp2, sh) & 1023];
      op[6] = idct_limit[(int)descale(t11 - tmp2, sh) & 1023];
      op[2] = idct_limit[(int)descale(t12 + tmp1, sh) & 1023];
      op[5] = idct_limit[(int)descale(t12 - tmp1, sh) & 1023];
      op[3] = idct_limit[(int)descale(t13 + tmp0, sh) & 1023];
      op[4] = idct_limit[(int)descale(t13 - tmp0, sh) & 1023];
    }
  }

  void idct_all() {
    for (auto& c : comps) {
      const int stride = c.bw * 8;
      c.plane.assign((size_t)stride * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_block(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                     &c.plane[(size_t)by * 8 * stride + bx * 8], stride);
    }
  }

  // jdsample.c: the component at full size (W x H), from its dw x dh
  // samples; rows outside [0, dh) repeat the edge rows (jdmainct.c's
  // context rows).
  std::vector<uint8_t> upsample(const Comp& c) const {
    const int rh = vmax / c.v, rw = hmax / c.h;
    const int stride = c.bw * 8;
    std::vector<uint8_t> out((size_t)W * H);
    std::vector<uint8_t> row((size_t)2 * c.dw + 2);
    std::vector<int> colsum(c.dw);
    auto in = [&](int y) {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);
      return &c.plane[(size_t)y * stride];
    };
    const bool fancy_h = rw == 2 && c.dw > 2;
    for (int y = 0; y < H; ++y) {
      const uint8_t* src;
      if (rh == 1) {
        src = in(y);
      } else {
        const int iy = y >> 1, odd = y & 1;
        const uint8_t* i0 = in(iy);
        const uint8_t* i1 = in(odd ? iy + 1 : iy - 1);
        if (rw == 1) {           // h1v2 fancy
          const int bias = odd ? 2 : 1;
          for (int x = 0; x < c.dw; ++x)
            row[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
          src = row.data();
        } else if (fancy_h) {    // h2v2 fancy
          for (int x = 0; x < c.dw; ++x) colsum[x] = i0[x] * 3 + i1[x];
          const int n = c.dw;
          row[0] = (uint8_t)((colsum[0] * 4 + 8) >> 4);
          row[1] = (uint8_t)((colsum[0] * 3 + colsum[1] + 7) >> 4);
          for (int x = 1; x < n - 1; ++x) {
            row[2 * x] = (uint8_t)((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
            row[2 * x + 1] =
                (uint8_t)((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
          }
          row[2 * n - 2] =
              (uint8_t)((colsum[n - 1] * 3 + colsum[n - 2] + 8) >> 4);
          row[2 * n - 1] = (uint8_t)((colsum[n - 1] * 4 + 7) >> 4);
          std::memcpy(&out[(size_t)y * W], row.data(), W);
          continue;
        } else {                 // h2v2 box
          src = i0;
        }
      }
      uint8_t* o = &out[(size_t)y * W];
      if (rw == 1) {
        std::memcpy(o, src, W);
      } else if (fancy_h) {      // h2v1 fancy
        const int n = c.dw;
        row[0] = src[0];
        row[1] = (uint8_t)((src[0] * 3 + src[1] + 2) >> 2);
        for (int x = 1; x < n - 1; ++x) {
          const int v = src[x] * 3;
          row[2 * x] = (uint8_t)((v + src[x - 1] + 1) >> 2);
          row[2 * x + 1] = (uint8_t)((v + src[x + 1] + 2) >> 2);
        }
        row[2 * n - 2] = (uint8_t)((src[n - 1] * 3 + src[n - 2] + 1) >> 2);
        row[2 * n - 1] = src[n - 1];
        std::memcpy(o, row.data(), W);
      } else {                   // h2 box
        for (int x = 0; x < W; ++x) o[x] = src[x >> 1];
      }
    }
    return out;
  }

  void to_rgb(uint8_t* rgb) {
    idct_all();
    if (comps.size() == 1) {
      const Comp& c = comps[0];
      const int stride = c.bw * 8;
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
          const uint8_t v = c.plane[(size_t)y * stride + x];
          uint8_t* o = rgb + ((size_t)y * W + x) * 3;
          o[0] = o[1] = o[2] = v;
        }
      return;
    }
    std::vector<uint8_t> pl[3];
    for (int i = 0; i < 3; ++i) pl[i] = upsample(comps[i]);
    bool ycc = true;
    if (!jfif) {
      if (adobe) {
        ycc = adobe_transform != 0;
      } else if (comps[0].id == 'R' && comps[1].id == 'G' &&
                 comps[2].id == 'B') {
        ycc = false;
      }
    }
    const size_t n = (size_t)W * H;
    if (!ycc) {
      for (size_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) rgb[3 * i + k] = pl[k][i];
      return;
    }
    // jdcolor.c build_ycc_rgb_table, 16 fraction bits
    const int64_t ONE_HALF = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    int crr[256], cbb[256];
    int64_t crg[256], cbg[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      crr[i] = (int)((fix(1.40200) * x + ONE_HALF) >> 16);
      cbb[i] = (int)((fix(1.77200) * x + ONE_HALF) >> 16);
      crg[i] = -fix(0.71414) * x;
      cbg[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t i = 0; i < n; ++i) {
      const int y = pl[0][i], cb = pl[1][i], cr = pl[2][i];
      rgb[3 * i] = clamp(y + crr[cr]);
      rgb[3 * i + 1] = clamp(y + (int)((cbg[cb] + crg[cr]) >> 16));
      rgb[3 * i + 2] = clamp(y + cbb[cb]);
    }
  }
};

uint8_t Decoder::idct_limit[1024];

// ---------------------------------------------------------------------------
// Encoder

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 tables: code counts per length 1..16, then the symbols
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0,    0, 2, 1, 3, 3, 2, 4, 3,
                                 5,    5, 4, 4, 0, 0, 1, 0x7d};
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
const uint8_t kAcChromaBits[17] = {0,    0, 2, 1, 2, 4, 4, 3, 4,
                                   7,    5, 4, 4, 0, 1, 2, 0x77};
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

struct ECode {
  uint16_t code[256];
  uint8_t size[256];
};

ECode make_ecode(const uint8_t bits[17], const uint8_t* vals) {
  ECode e;
  std::memset(e.size, 0, sizeof(e.size));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
      e.code[vals[k]] = (uint16_t)code;
      e.size[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
  return e;
}

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int n = 0;

  void byte(int b) { out.push_back((uint8_t)b); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void bits(uint32_t v, int k) {
    for (int i = k - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++n == 8) {
        byte((int)acc);
        if (acc == 0xFF) byte(0);
        acc = 0;
        n = 0;
      }
    }
  }
  void flush() {
    while (n) bits(1, 1);
  }
  void sym(const ECode& e, int s) {
    if (!e.size[s]) throw JpegError("encoder: symbol without a code");
    bits(e.code[s], e.size[s]);
  }
};

int nbits(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(Writer& w, const float* px, int stride, const uint16_t* q,
                  int& pred, const ECode& dc, const ECode& ac) {
  struct Cos {
    float v[8][8];
    Cos() {
      const double kPi = 3.14159265358979323846;
      for (int x = 0; x < 8; ++x)
        for (int u = 0; u < 8; ++u)
          v[x][u] = (float)std::cos((2 * x + 1) * u * kPi / 16.0);
    }
  };
  static const Cos cos_table;  // initialised once, thread-safe
  const auto& cosv = cos_table.v;
  int coef[64];
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      double s = 0.0;
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x)
          s += (px[y * stride + x] - 128.0) * cosv[x][u] * cosv[y][v];
      const double r2 = 0.70710678118654752440;
      const double cu = u ? 1.0 : r2, cv = v ? 1.0 : r2;
      const double f = 0.25 * cu * cv * s;
      coef[v * 8 + u] = (int)std::lround(f / q[v * 8 + u]);
    }
  const int diff = coef[0] - pred;
  pred = coef[0];
  const int s = nbits(diff);
  w.sym(dc, s);
  if (s) w.bits((uint32_t)(diff < 0 ? diff + (1 << s) - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int c = coef[kNatural[k]];
    if (!c) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.sym(ac, 0xF0);
      run -= 16;
    }
    const int sz = nbits(c);
    w.sym(ac, (run << 4) | sz);
    w.bits((uint32_t)(c < 0 ? c + (1 << sz) - 1 : c), sz);
    run = 0;
  }
  if (run) w.sym(ac, 0x00);
}

std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int nc,
                            int quality, int sub420) {
  if (H <= 0 || W <= 0 || H > 65535 || W > 65535)
    throw JpegError("encoder: bad image size");
  if (nc != 1 && nc != 3) throw JpegError("encoder: 1 or 3 channels");
  if (quality < 1 || quality > 100)
    throw JpegError("encoder: quality 1-100");
  const int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  uint16_t qt[2][64];
  for (int i = 0; i < 64; ++i) {
    const int a = (kStdLuma[i] * scale + 50) / 100;
    const int b = (kStdChroma[i] * scale + 50) / 100;
    qt[0][i] = (uint16_t)(a < 1 ? 1 : (a > 255 ? 255 : a));
    qt[1][i] = (uint16_t)(b < 1 ? 1 : (b > 255 ? 255 : b));
  }
  const int hs = (nc == 3 && sub420) ? 2 : 1;
  const int mw = 8 * hs, mh = 8 * hs;
  const int mcux = (W + mw - 1) / mw, mcuy = (H + mh - 1) / mh;
  const int PW = mcux * mw, PH = mcuy * mh;
  // planes at full size, edges replicated to the MCU grid
  std::vector<float> pl[3];
  for (int k = 0; k < nc; ++k) pl[k].resize((size_t)PW * PH);
  for (int y = 0; y < PH; ++y)
    for (int x = 0; x < PW; ++x) {
      const uint8_t* s =
          img + ((size_t)std::min(y, H - 1) * W + std::min(x, W - 1)) * nc;
      const size_t i = (size_t)y * PW + x;
      if (nc == 1) {
        pl[0][i] = s[0];
        continue;
      }
      const double r = s[0], g = s[1], b = s[2];
      auto rnd = [](double v) {
        return (float)std::min(255.0, std::max(0.0, std::floor(v + 0.5)));
      };
      pl[0][i] = rnd(0.299 * r + 0.587 * g + 0.114 * b);
      pl[1][i] = rnd(-0.168736 * r - 0.331264 * g + 0.5 * b + 128.0);
      pl[2][i] = rnd(0.5 * r - 0.418688 * g - 0.081312 * b + 128.0);
    }
  const int CW = PW / hs, CH = PH / hs;
  std::vector<float> ch[2];
  for (int k = 1; k < nc; ++k) {
    ch[k - 1].resize((size_t)CW * CH);
    for (int y = 0; y < CH; ++y)
      for (int x = 0; x < CW; ++x) {
        float s = 0.0f;
        for (int dy = 0; dy < hs; ++dy)
          for (int dx = 0; dx < hs; ++dx)
            s += pl[k][(size_t)(hs * y + dy) * PW + hs * x + dx];
        ch[k - 1][(size_t)y * CW + x] =
            std::floor(s / (hs * hs) + 0.5f);
      }
  }
  const ECode dcl = make_ecode(kDcLumaBits, kDcVals),
              acl = make_ecode(kAcLumaBits, kAcLumaVals),
              dcc = make_ecode(kDcChromaBits, kDcVals),
              acc = make_ecode(kAcChromaBits, kAcChromaVals);
  Writer w;
  w.u16(0xFFD8);
  w.u16(0xFFE0);  // JFIF 1.01, no thumbnail
  w.u16(16);
  for (char c : std::string("JFIF", 5)) w.byte(c);
  w.byte(1);
  w.byte(1);
  w.byte(0);
  w.u16(1);
  w.u16(1);
  w.byte(0);
  w.byte(0);
  const int nq = nc == 3 ? 2 : 1;
  for (int t = 0; t < nq; ++t) {
    w.u16(0xFFDB);
    w.u16(67);
    w.byte(t);
    for (int k = 0; k < 64; ++k) w.byte(qt[t][kNatural[k]]);
  }
  w.u16(0xFFC0);
  w.u16(8 + 3 * nc);
  w.byte(8);
  w.u16(H);
  w.u16(W);
  w.byte(nc);
  for (int k = 0; k < nc; ++k) {
    w.byte(k + 1);
    w.byte(k == 0 ? (hs << 4) | hs : 0x11);
    w.byte(k == 0 ? 0 : 1);
  }
  auto dht = [&](int tc_th, const uint8_t bits[17], const uint8_t* vals) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l];
    w.u16(0xFFC4);
    w.u16(3 + 16 + total);
    w.byte(tc_th);
    for (int l = 1; l <= 16; ++l) w.byte(bits[l]);
    for (int i = 0; i < total; ++i) w.byte(vals[i]);
  };
  dht(0x00, kDcLumaBits, kDcVals);
  dht(0x10, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    dht(0x01, kDcChromaBits, kDcVals);
    dht(0x11, kAcChromaBits, kAcChromaVals);
  }
  w.u16(0xFFDA);
  w.u16(6 + 2 * nc);
  w.byte(nc);
  for (int k = 0; k < nc; ++k) {
    w.byte(k + 1);
    w.byte(k == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);
  int pred[3] = {0, 0, 0};
  uint16_t qn[2][64];
  for (int t = 0; t < 2; ++t) std::memcpy(qn[t], qt[t], sizeof(qn[t]));
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      for (int by = 0; by < hs; ++by)
        for (int bx = 0; bx < hs; ++bx)
          encode_block(w,
                       &pl[0][(size_t)(my * mh + by * 8) * PW + mx * mw +
                              bx * 8],
                       PW, qn[0], pred[0], dcl, acl);
      for (int k = 1; k < nc; ++k)
        encode_block(w, &ch[k - 1][(size_t)(my * 8) * CW + mx * 8], CW,
                     qn[1], pred[k], dcc, acc);
    }
  w.flush();
  w.u16(0xFFD9);
  return w.out;
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decode a JPEG file's bytes to RGB (cv2.imread's pixels, channels in RGB
// order).  On success returns 0, *out a malloc'd H*W*3 buffer (free it
// with hp_jpeg_free) and *h / *w the size; on failure returns 1 with the
// reason in err.
int hp_jpeg_decode(const uint8_t* buf, int64_t n, uint8_t** out, int* h,
                   int* w, char* err, int errlen) {
  *out = nullptr;
  try {
    static const bool init = (Decoder::init_limit(), true);  // thread-safe
    (void)init;
    Decoder d;
    d.buf = buf;
    d.end = buf + n;
    d.parse();
    uint8_t* rgb = (uint8_t*)std::malloc((size_t)d.W * d.H * 3);
    if (!rgb) throw JpegError("out of memory");
    d.to_rgb(rgb);
    *out = rgb;
    *h = d.H;
    *w = d.W;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

// Encode an (h, w, nc) uint8 image (nc 1: grey, 3: RGB) as baseline JPEG at
// quality 1-100, chroma 4:2:0 (sub420) or 4:4:4.  Returns the byte count
// and *out a malloc'd buffer (hp_jpeg_free), or -1 with the reason in err.
int64_t hp_jpeg_encode(const uint8_t* img, int h, int w, int nc,
                       int quality, int sub420, uint8_t** out, char* err,
                       int errlen) {
  *out = nullptr;
  try {
    std::vector<uint8_t> v = encode(img, h, w, nc, quality, sub420);
    uint8_t* b = (uint8_t*)std::malloc(v.size());
    if (!b) throw JpegError("out of memory");
    std::memcpy(b, v.data(), v.size());
    *out = b;
    return (int64_t)v.size();
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

void hp_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
