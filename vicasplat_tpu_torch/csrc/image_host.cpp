// The port's host image library: a baseline JPEG codec and PIL's 8-bit
// resize, in plain C++ with no image library, for the data path on a
// machine that has neither PIL nor libjpeg.
//
// Decode: baseline and extended sequential DCT, 8-bit, Huffman-coded (SOF0
// and SOF1): DQT, DHT, SOF, SOS, DRI and restart markers, grey and 3
// components (YCbCr, or RGB after an Adobe marker with transform 0), any
// integral sampling factors, sizes that are not multiples of the MCU. The
// arithmetic is libjpeg's (the libjpeg-turbo that PIL carries) step for
// step, so the pixels equal PIL's byte for byte: the integer "islow" IDCT
// (jidctint.c) with its range-limit table, the fancy (triangle) upsampling
// of h2v1, h2v2 and h1v2 chroma (jdsample.c; box replication for other
// ratios and for chroma 2 samples wide or less), and the fixed-point
// YCbCr -> RGB tables (jdcolor.c). Progressive, lossless, hierarchical,
// arithmetic-coded, 12-bit, 4-component and corrupt streams are refused, and
// so are frames above PIL's pixel limit or too large for their stream's length
// (before any plane is allocated).
//
// Encode: baseline 4:2:0 at a libjpeg quality (PIL's default save): the standard
// tables scaled as jpeg_set_quality does, RGB -> YCbCr (jccolor.c), edge
// replication and the 1,2,1,2 bias of h2v2 downsampling (jcprep.c,
// jcsample.c), the islow FDCT (jfdctint.c) with rounded division by
// 8 x the quantizer, the dummy blocks of jccoefct.c and the standard
// Huffman tables. The headers are the ones libjpeg writes through PIL's
// default save, so the whole file equals PIL's.
//
// Resize: Pillow's separable 8-bit passes in fixed point (Resample.c), for
// any filter: the caller computes each axis's first index and 22-bit weights
// (utils/image_io.py's _resample_coeffs); this file sums them.
//
// Every batch entry point spreads its frames over std::threads; ctypes
// releases the GIL for the whole call. Build:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread image_host.cpp -o libimage_host.so

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// the most pixels a frame may have: twice PIL's MAX_IMAGE_PIXELS, where PIL
// raises DecompressionBombError
constexpr uint64_t kMaxPixels = 2 * uint64_t(89478485);

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// Runs fn(i) for i in [0, n) on up to n_threads threads (0: one a core);
// returns the first failing index and its message, or -1.
template <class Fn>
int parallel_frames(int n, int n_threads, Fn fn, std::string* err) {
  std::atomic<int> next(0), failed(-1);
  std::string first_err;
  std::atomic<bool> have_err(false);
  auto work = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      try {
        fn(i);
      } catch (const JpegError& e) {
        bool expected = false;
        if (have_err.compare_exchange_strong(expected, true)) {
          first_err = e.msg;
          failed.store(i);
        }
      } catch (const std::bad_alloc&) {
        bool expected = false;
        if (have_err.compare_exchange_strong(expected, true)) {
          first_err = "out of memory";
          failed.store(i);
        }
      }
    }
  };
  int k = n_threads > 0 ? n_threads
                        : static_cast<int>(std::thread::hardware_concurrency());
  k = std::max(1, std::min(k, n));
  if (k == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < k; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  if (failed.load() >= 0 && err) *err = first_err;
  return failed.load();
}

void copy_err(const std::string& msg, char* buf, int len) {
  if (!buf || len <= 0) return;
  int n = std::min<int>(static_cast<int>(msg.size()), len - 1);
  std::memcpy(buf, msg.data(), n);
  buf[n] = 0;
}

// ---------------------------------------------------------------- decode

struct Huffman {
  bool present = false;
  int maxcode[18];
  int mincode[17];
  int valptr[17];
  uint8_t vals[256];
  int16_t fast[512];  // first 9 bits -> (length << 8) | value, or -1
};

void build_huffman(Huffman& t, const uint8_t* bits, const uint8_t* vals,
                   int nvals) {
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    t.valptr[l] = k;
    t.mincode[l] = code;
    code += bits[l - 1];
    k += bits[l - 1];
    if (code > (1 << l) || (code == (1 << l) && k < nvals))
      fail("bad Huffman table");
    t.maxcode[l] = bits[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = INT_MAX;
  std::memcpy(t.vals, vals, nvals);
  std::fill(t.fast, t.fast + 512, int16_t(-1));
  code = 0;
  k = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++code, ++k) {
      int lo = code << (9 - l), hi = (code + 1) << (9 - l);
      for (int j = lo; j < hi; ++j) t.fast[j] = int16_t((l << 8) | vals[k]);
    }
    code <<= 1;
  }
  t.present = true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;    // bits in acc
  int pad = 0;  // of which zero bits past a marker or the end, at the tail
  bool marker = false;

  void fill() {
    while (n <= 56) {
      uint64_t byte = 0;
      if (!marker && p < end && !(p[0] == 0xFF && (p + 1 >= end || p[1] != 0))) {
        byte = *p;
        p += (*p == 0xFF) ? 2 : 1;
      } else {
        marker = true;
        pad += 8;
      }
      acc |= byte << (56 - n);
      n += 8;
    }
  }
  void consume(int k) {
    acc <<= k;
    n -= k;
    if (n < pad) fail("entropy-coded data ends early (truncated or corrupt)");
  }
  int get(int k) {  // 1 <= k <= 16
    if (n < k) fill();
    int v = static_cast<int>(acc >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huffman& t) {
    if (n < 16) fill();
    int f = t.fast[acc >> 55];
    if (f >= 0) {
      consume(f >> 8);
      return f & 0xFF;
    }
    int code = static_cast<int>(acc >> 63);
    for (int l = 1; l <= 16; ++l) {
      if (l > 1) code = (code << 1) | static_cast<int>((acc >> (64 - l)) & 1);
      if (code <= t.maxcode[l]) {
        consume(l);
        return t.vals[t.valptr[l] + code - t.mincode[l]];
      }
    }
    fail("bad Huffman code");
  }
  int receive_extend(int s) {
    if (s == 0) return 0;
    int v = get(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
};

// jidctint.c's islow IDCT, constants at 13 bits
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                  F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// the post-IDCT range limit: (x & 1023) read as a signed 10-bit value + 128,
// clamped (jdmaster.c prepare_range_limit_table)
inline uint8_t idct_limit(int64_t x) {
  int i = static_cast<int>(x & 1023);
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  const int CB = 13, P1 = 2;
  for (int c = 0; c < 8; ++c) {
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    auto in = [&](int r) { return int64_t(coef[r * 8 + c]) * q[r * 8 + c]; };
    z2 = in(2);
    z3 = in(6);
    z1 = (z2 + z3) * F0_541;
    t2 = z1 + z3 * -F1_847;
    t3 = z1 + z2 * F0_765;
    z2 = in(0);
    z3 = in(4);
    t0 = (z2 + z3) * (int64_t(1) << CB);
    t1 = (z2 - z3) * (int64_t(1) << CB);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = in(7);
    t1 = in(5);
    t2 = in(3);
    t3 = in(1);
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F1_175;
    t0 *= F0_298;
    t1 *= F2_053;
    t2 *= F3_072;
    t3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    ws[0 * 8 + c] = static_cast<int>(descale(t10 + t3, CB - P1));
    ws[7 * 8 + c] = static_cast<int>(descale(t10 - t3, CB - P1));
    ws[1 * 8 + c] = static_cast<int>(descale(t11 + t2, CB - P1));
    ws[6 * 8 + c] = static_cast<int>(descale(t11 - t2, CB - P1));
    ws[2 * 8 + c] = static_cast<int>(descale(t12 + t1, CB - P1));
    ws[5 * 8 + c] = static_cast<int>(descale(t12 - t1, CB - P1));
    ws[3 * 8 + c] = static_cast<int>(descale(t13 + t0, CB - P1));
    ws[4 * 8 + c] = static_cast<int>(descale(t13 - t0, CB - P1));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * F0_541;
    t2 = z1 + z3 * -F1_847;
    t3 = z1 + z2 * F0_765;
    t0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CB);
    t1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CB);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = w[7];
    t1 = w[5];
    t2 = w[3];
    t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F1_175;
    t0 *= F0_298;
    t1 *= F2_053;
    t2 *= F3_072;
    t3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    uint8_t* o = out + r * stride;
    const int S = CB + P1 + 3;
    o[0] = idct_limit(descale(t10 + t3, S));
    o[7] = idct_limit(descale(t10 - t3, S));
    o[1] = idct_limit(descale(t11 + t2, S));
    o[6] = idct_limit(descale(t11 - t2, S));
    o[2] = idct_limit(descale(t12 + t1, S));
    o[5] = idct_limit(descale(t12 - t1, S));
    o[3] = idct_limit(descale(t13 + t0, S));
    o[4] = idct_limit(descale(t13 - t0, S));
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;    // samples (downsampled size)
  int bw = 0, bh = 0;           // blocks allocated (whole MCUs)
  int td = 0, ta = 0, pred = 0;
  bool decoded = false;
  std::vector<uint8_t> plane;   // bh*8 rows of bw*8 samples
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}

  int u16(size_t at) const {
    if (at + 2 > len) fail("truncated marker segment");
    return (data[at] << 8) | data[at + 1];
  }

  // the next marker code at pos (fill bytes skipped); pos moves past it
  int next_marker() {
    for (;;) {
      while (pos < len && data[pos] != 0xFF) ++pos;  // extraneous bytes
      while (pos < len && data[pos] == 0xFF) ++pos;
      if (pos >= len) fail("no EOI marker (truncated stream)");
      if (data[pos] != 0x00) return data[pos++];
      ++pos;  // a stuffed 0xFF00 of entropy-coded data, not a marker
    }
  }

  void parse_sof(size_t seg, int seglen, int marker) {
    if (frame) fail("more than one frame header");
    if (seglen < 8) fail("short SOF segment");
    int precision = data[seg];
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples are not supported (8-bit only)");
    height = u16(seg + 1);
    width = u16(seg + 3);
    int nc = data[seg + 5];
    if (width == 0 || height == 0) fail("zero image size");
    if (nc != 1 && nc != 3)
      fail(std::to_string(nc) + " components (CMYK or other) are not supported");
    if (seglen < 6 + 3 * nc) fail("short SOF segment");
    (void)marker;
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = data[seg + 6 + 3 * i];
      c.h = data[seg + 7 + 3 * i] >> 4;
      c.v = data[seg + 7 + 3 * i] & 15;
      c.tq = data[seg + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
      comps.push_back(c);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    // refuse a frame before allocating its planes when it is larger than
    // PIL's decompression-bomb limit, or when the stream is too short to
    // hold it: each block's DC and EOB codes take 1 bit at least
    if (uint64_t(width) * height > kMaxPixels)
      fail("image of " + std::to_string(width) + "x" + std::to_string(height) +
           " pixels is larger than the limit of " + std::to_string(kMaxPixels) + " pixels");
    uint64_t blocks = 0;
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) fail("non-integral sampling ratio");
      c.width = (width * c.h + hmax - 1) / hmax;
      c.height = (height * c.v + vmax - 1) / vmax;
      blocks += uint64_t((c.width + 7) / 8) * ((c.height + 7) / 8);
    }
    if (2 * blocks > 8 * uint64_t(len))
      fail("a stream of " + std::to_string(len) + " bytes cannot hold a frame of " +
           std::to_string(width) + "x" + std::to_string(height) + " (truncated or corrupt)");
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
    }
    frame = true;
  }

  void parse_dqt(size_t seg, int seglen) {
    size_t at = seg, stop = seg + seglen;
    while (at < stop) {
      int pq = data[at] >> 4, tq = data[at] & 15;
      if (tq > 3 || pq > 1) fail("bad DQT segment");
      ++at;
      if (at + 64 * (pq + 1) > stop) fail("short DQT segment");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? u16(at + 2 * k) : data[at + k];
        qt[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      at += 64 * (pq + 1);
      qt_present[tq] = true;
    }
  }

  void parse_dht(size_t seg, int seglen) {
    size_t at = seg, stop = seg + seglen;
    while (at < stop) {
      if (at + 17 > stop) fail("short DHT segment");
      int tc = data[at] >> 4, th = data[at] & 15;
      if (tc > 1 || th > 3) fail("bad DHT segment");
      const uint8_t* bits = data + at + 1;
      int n = 0;
      for (int i = 0; i < 16; ++i) n += bits[i];
      if (n > 256 || at + 17 + n > stop) fail("bad DHT segment");
      build_huffman(tc ? ac[th] : dc[th], bits, data + at + 17, n);
      at += 17 + n;
    }
  }

  void restart(BitReader& br, int& expected) {
    if (br.n - br.pad >= 8) fail("missing restart marker");
    br.acc = 0;
    br.n = br.pad = 0;
    br.marker = false;
    const uint8_t* p = br.p;
    while (p < br.end && *p == 0xFF && p + 1 < br.end && p[1] == 0xFF) ++p;
    if (p + 1 >= br.end || p[0] != 0xFF || p[1] != 0xD0 + expected)
      fail("missing restart marker");
    br.p = p + 2;
    expected = (expected + 1) & 7;
    for (auto& c : comps) c.pred = 0;
  }

  void decode_block(BitReader& br, Component& c, uint8_t* out, int stride) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huffman& dct = dc[c.td];
    const Huffman& act = ac[c.ta];
    int s = br.decode(dct);
    if (s > 11) fail("bad DC coefficient size");
    c.pred += br.receive_extend(s);
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("AC coefficient index past 63");
        coef[kNatural[k]] = static_cast<int16_t>(br.receive_extend(s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    idct_islow(coef, qt[c.tq], out, stride);
  }

  void parse_sos(size_t seg, int seglen) {
    if (!frame) fail("scan before the frame header");
    int ns = data[seg];
    if (ns < 1 || ns > 4 || seglen < 1 + 2 * ns + 3) fail("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int cid = data[seg + 1 + 2 * i], tables = data[seg + 2 + 2 * i];
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == cid) found = &c;
      if (!found || found->decoded) fail("bad scan component");
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].present ||
          !ac[found->ta].present)
        fail("scan names a missing Huffman table");
      if (!qt_present[found->tq]) fail("scan names a missing quantization table");
      sc.push_back(found);
    }
    int ss = data[seg + 1 + 2 * ns], se = data[seg + 2 + 2 * ns],
        ahl = data[seg + 3 + 2 * ns];
    if (ss != 0 || se != 63 || ahl != 0) fail("not a sequential scan");
    BitReader br{data + seg + seglen, data + len};
    int expected_rst = 0, left = restart_interval;
    for (auto* c : sc) c->pred = 0;
    if (ns == 1) {
      Component& c = *sc[0];
      int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8, stride = c.bw * 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          if (restart_interval) {
            if (left == 0) {
              restart(br, expected_rst);
              left = restart_interval;
            }
            --left;
          }
          decode_block(br, c, c.plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval) {
            if (left == 0) {
              restart(br, expected_rst);
              left = restart_interval;
            }
            --left;
          }
          for (auto* cp : sc) {
            Component& c = *cp;
            int stride = c.bw * 8;
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                size_t row = size_t(my * c.v + y) * 8, col = size_t(mx * c.h + x) * 8;
                decode_block(br, c, c.plane.data() + row * stride + col, stride);
              }
          }
        }
    }
    for (auto* c : sc) c->decoded = true;
    pos = static_cast<size_t>(br.p - data);
  }

  void parse_app(size_t seg, int seglen, int marker) {
    if (marker == 0xE0 && seglen >= 5 && std::memcmp(data + seg, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && seglen >= 12 && std::memcmp(data + seg, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[seg + 11];
    }
  }

  void parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG stream (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      size_t seg = pos + 2;
      int seglen = u16(pos) - 2;
      if (seglen < 0 || seg + seglen > len) fail("truncated marker segment");
      if (m == 0xC0 || m == 0xC1) {
        parse_sof(seg, seglen, m);
      } else if (m == 0xC2 || m == 0xC6) {
        fail("progressive JPEG is not supported (baseline only)");
      } else if (m == 0xC3 || m == 0xC5 || m == 0xC7) {
        fail("lossless or hierarchical JPEG is not supported (baseline only)");
      } else if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD || m == 0xCE ||
                 m == 0xCF || m == 0xCC) {
        fail("arithmetic-coded JPEG is not supported (Huffman only)");
      } else if (m == 0xC4) {
        parse_dht(seg, seglen);
      } else if (m == 0xDB) {
        parse_dqt(seg, seglen);
      } else if (m == 0xDD) {
        if (seglen < 2) fail("bad DRI segment");
        restart_interval = u16(seg);
      } else if (m == 0xDA) {
        parse_sos(seg, seglen);
        continue;
      } else if (m >= 0xE0 && m <= 0xEF) {
        parse_app(seg, seglen, m);
      }
      pos = seg + seglen;
    }
    if (!frame) fail("no frame header");
    for (auto& c : comps)
      if (!c.decoded) fail("a component has no scan");
  }

  // header only: size and the refusals that SOF can show
  void parse_header() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG stream (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9 || m == 0xDA) fail("no frame header before the scan");
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      size_t seg = pos + 2;
      int seglen = u16(pos) - 2;
      if (seglen < 0 || seg + seglen > len) fail("truncated marker segment");
      if (m == 0xC0 || m == 0xC1) {
        parse_sof(seg, seglen, m);
        return;
      }
      if (m == 0xC2 || m == 0xC6) fail("progressive JPEG is not supported (baseline only)");
      if (m == 0xC3 || m == 0xC5 || m == 0xC7)
        fail("lossless or hierarchical JPEG is not supported (baseline only)");
      if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD || m == 0xCE || m == 0xCF)
        fail("arithmetic-coded JPEG is not supported (Huffman only)");
      pos = seg + seglen;
    }
  }

  bool is_rgb() const {  // jdapimin.c default_decompress_parms
    if (comps.size() != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }

  // one component's samples upsampled to the full width for row y
  void upsample_row(const Component& c, int y, int* out) const {
    const int rh = vmax / c.v, rw = hmax / c.h, stride = c.bw * 8;
    const uint8_t* pl = c.plane.data();
    auto at = [&](int r, int x) { return static_cast<int>(pl[size_t(r) * stride + x]); };
    const bool fancy_h2 = rw == 2 && c.width > 2;
    if (rw == 1 && rh == 1) {
      for (int x = 0; x < width; ++x) out[x] = at(y, x);
    } else if (rw == 2 && rh == 1 && fancy_h2) {  // h2v1_fancy_upsample
      for (int x = 0; x < width; ++x) {
        int i = x >> 1, s = at(y, i) * 3;
        out[x] = (x & 1) ? (s + at(y, std::min(i + 1, c.width - 1)) + 2) >> 2
                         : (s + at(y, std::max(i - 1, 0)) + 1) >> 2;
      }
    } else if (rw == 2 && rh == 2 && fancy_h2) {  // h2v2_fancy_upsample
      int r = y >> 1;
      int far = (y & 1) ? std::min(r + 1, c.height - 1) : std::max(r - 1, 0);
      auto colsum = [&](int i) { return at(r, i) * 3 + at(far, i); };
      for (int x = 0; x < width; ++x) {
        int i = x >> 1, s = colsum(i) * 3;
        out[x] = (x & 1) ? (s + colsum(std::min(i + 1, c.width - 1)) + 7) >> 4
                         : (s + colsum(std::max(i - 1, 0)) + 8) >> 4;
      }
    } else if (rw == 1 && rh == 2) {  // h1v2_fancy_upsample
      int r = y >> 1;
      int far = (y & 1) ? std::min(r + 1, c.height - 1) : std::max(r - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x) out[x] = (at(r, x) * 3 + at(far, x) + bias) >> 2;
    } else {  // int_upsample: box replication
      int r = y / rh;
      for (int x = 0; x < width; ++x) out[x] = at(r, x / rw);
    }
  }

  void to_rgb(uint8_t* out) const {
    if (comps.size() == 1) {
      const Component& c = comps[0];
      std::vector<int> row(width);
      for (int y = 0; y < height; ++y) {
        upsample_row(c, y, row.data());
        uint8_t* o = out + size_t(y) * width * 3;
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = uint8_t(row[x]);
      }
      return;
    }
    std::vector<int> r0(width), r1(width), r2(width);
    const bool rgb = is_rgb();
    for (int y = 0; y < height; ++y) {
      upsample_row(comps[0], y, r0.data());
      upsample_row(comps[1], y, r1.data());
      upsample_row(comps[2], y, r2.data());
      uint8_t* o = out + size_t(y) * width * 3;
      for (int x = 0; x < width; ++x) {
        if (rgb) {
          o[3 * x] = uint8_t(r0[x]);
          o[3 * x + 1] = uint8_t(r1[x]);
          o[3 * x + 2] = uint8_t(r2[x]);
          continue;
        }
        // jdcolor.c ycc_rgb_convert with its tables, SCALEBITS 16
        const int64_t half = int64_t(1) << 15;
        int cb = r1[x] - 128, cr = r2[x] - 128, yy = r0[x];
        int cr_r = static_cast<int>((91881 * int64_t(cr) + half) >> 16);
        int cb_b = static_cast<int>((116130 * int64_t(cb) + half) >> 16);
        int g = static_cast<int>((-46802 * int64_t(cr) + -22554 * int64_t(cb) + half) >> 16);
        o[3 * x] = uint8_t(std::clamp(yy + cr_r, 0, 255));
        o[3 * x + 1] = uint8_t(std::clamp(yy + g, 0, 255));
        o[3 * x + 2] = uint8_t(std::clamp(yy + cb_b, 0, 255));
      }
    }
  }
};

// ---------------------------------------------------------------- encode

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

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];
};

HuffCode make_codes(const uint8_t* bits, const uint8_t* vals) {
  HuffCode h;
  std::memset(&h, 0, sizeof(h));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      h.code[vals[k]] = static_cast<uint16_t>(code);
      h.size[vals[k]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
  return h;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {  // size <= 16
    acc = (acc << size) | (code & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
    acc &= (1u << n) - 1;
  }
  void flush() {  // jchuff.c flush_bits: pad with one-bits
    put(0x7F, 7);
    acc = 0;
    n = 0;
  }
};

// jfdctint.c's islow FDCT, in place; the result is 8 x the true DCT
void fdct_islow(int* d) {
  const int CB = 13, P1 = 2;
  for (int r = 0; r < 8; ++r) {
    int* p = d + r * 8;
    int64_t t0 = p[0] + p[7], t7 = p[0] - p[7], t1 = p[1] + p[6], t6 = p[1] - p[6];
    int64_t t2 = p[2] + p[5], t5 = p[2] - p[5], t3 = p[3] + p[4], t4 = p[3] - p[4];
    int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    p[0] = static_cast<int>((t10 + t11) * (1 << P1));
    p[4] = static_cast<int>((t10 - t11) * (1 << P1));
    int64_t z1 = (t12 + t13) * F0_541;
    p[2] = static_cast<int>(descale(z1 + t13 * F0_765, CB - P1));
    p[6] = static_cast<int>(descale(z1 + t12 * -F1_847, CB - P1));
    z1 = t4 + t7;
    int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    int64_t z5 = (z3 + z4) * F1_175;
    t4 *= F0_298;
    t5 *= F2_053;
    t6 *= F3_072;
    t7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(descale(t4 + z1 + z3, CB - P1));
    p[5] = static_cast<int>(descale(t5 + z2 + z4, CB - P1));
    p[3] = static_cast<int>(descale(t6 + z2 + z3, CB - P1));
    p[1] = static_cast<int>(descale(t7 + z1 + z4, CB - P1));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int64_t t0 = p[0] + p[56], t7 = p[0] - p[56], t1 = p[8] + p[48], t6 = p[8] - p[48];
    int64_t t2 = p[16] + p[40], t5 = p[16] - p[40], t3 = p[24] + p[32], t4 = p[24] - p[32];
    int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    p[0] = static_cast<int>(descale(t10 + t11, P1));
    p[32] = static_cast<int>(descale(t10 - t11, P1));
    int64_t z1 = (t12 + t13) * F0_541;
    p[16] = static_cast<int>(descale(z1 + t13 * F0_765, CB + P1));
    p[48] = static_cast<int>(descale(z1 + t12 * -F1_847, CB + P1));
    z1 = t4 + t7;
    int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    int64_t z5 = (z3 + z4) * F1_175;
    t4 *= F0_298;
    t5 *= F2_053;
    t6 *= F3_072;
    t7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(descale(t4 + z1 + z3, CB + P1));
    p[40] = static_cast<int>(descale(t5 + z2 + z4, CB + P1));
    p[24] = static_cast<int>(descale(t6 + z2 + z3, CB + P1));
    p[8] = static_cast<int>(descale(t7 + z1 + z4, CB + P1));
  }
}

void scale_table(const uint8_t* base, int quality, uint8_t* out) {  // jcparam.c
  quality = std::clamp(quality, 1, 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (long(base[i]) * scale + 50L) / 100L;
    out[i] = static_cast<uint8_t>(std::clamp(t, 1L, 255L));
  }
}

struct Plane {
  int w, h;  // allocated samples
  std::vector<uint8_t> s;
  uint8_t at(int y, int x) const { return s[size_t(y) * w + x]; }
};

void encode_one(const uint8_t* rgb, int width, int height, int quality,
                std::vector<uint8_t>& out) {
  const int hmax = 2, vmax = 2;  // 4:2:0
  const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  // colour conversion (jccolor.c rgb_ycc_convert) over an edge-replicated
  // canvas of whole MCUs: right edge first, then the bottom rows
  const int cw = mcux * 8 * hmax, ch = mcuy * 8 * vmax;
  Plane yp{cw, ch, std::vector<uint8_t>(size_t(cw) * ch)};
  Plane cbf = yp, crf = yp;
  const int64_t half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = rgb + size_t(y) * width * 3;
    for (int x = 0; x < width; ++x) {
      int64_t r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
      size_t i = size_t(y) * cw + x;
      yp.s[i] = uint8_t((19595 * r + 38470 * g + 7471 * b + half) >> 16);
      cbf.s[i] = uint8_t((-11059 * r + -21709 * g + 32768 * b + cbcr_off + half - 1) >> 16);
      crf.s[i] = uint8_t((32768 * r + -27439 * g + -5329 * b + cbcr_off + half - 1) >> 16);
    }
  }
  for (Plane* p : {&yp, &cbf, &crf}) {
    for (int y = 0; y < height; ++y) {
      uint8_t* row = p->s.data() + size_t(y) * cw;
      std::fill(row + width, row + cw, row[width - 1]);
    }
    for (int y = height; y < ch; ++y)
      std::memcpy(p->s.data() + size_t(y) * cw, p->s.data() + size_t(height - 1) * cw, cw);
  }
  // chroma: h2v2 downsampling with the 1,2,1,2 bias over rows of pairs
  // (jcsample.c), then the last real row repeated to the MCU's bottom
  const int cwd = (width + hmax - 1) / hmax, chd = (height + vmax - 1) / vmax;
  const int cwb = (cwd + 7) / 8;  // chroma blocks a row: width_in_blocks
  auto downsample = [&](const Plane& full) {
    Plane d{mcux * 8, mcuy * 8, std::vector<uint8_t>(size_t(mcux) * 8 * mcuy * 8)};
    for (int r = 0; r < chd; ++r) {
      int bias = 1;
      for (int c = 0; c < cwb * 8; ++c) {
        int s = full.at(2 * r, 2 * c) + full.at(2 * r, 2 * c + 1) + full.at(2 * r + 1, 2 * c) +
                full.at(2 * r + 1, 2 * c + 1);
        d.s[size_t(r) * d.w + c] = uint8_t((s + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int r = chd; r < d.h; ++r)
      std::memcpy(d.s.data() + size_t(r) * d.w, d.s.data() + size_t(chd - 1) * d.w, d.w);
    return d;
  };
  Plane cbp = downsample(cbf), crp = downsample(crf);

  uint8_t q[2][64];
  scale_table(kStdLuma, quality, q[0]);
  scale_table(kStdChroma, quality, q[1]);

  // headers, as libjpeg writes them (jcmarker.c)
  auto put16 = [&](int v) {
    out.push_back(uint8_t(v >> 8));
    out.push_back(uint8_t(v & 0xFF));
  };
  out.insert(out.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01,
                         0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00});
  for (int t = 0; t < 2; ++t) {
    out.insert(out.end(), {0xFF, 0xDB, 0x00, 0x43, uint8_t(t)});
    for (int k = 0; k < 64; ++k) out.push_back(q[t][kNatural[k]]);
  }
  out.insert(out.end(), {0xFF, 0xC0, 0x00, 0x11, 0x08});
  put16(height);
  put16(width);
  out.insert(out.end(), {0x03, 0x01, uint8_t((hmax << 4) | vmax), 0x00, 0x02, 0x11, 0x01,
                         0x03, 0x11, 0x01});
  auto put_dht = [&](int tc_th, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int i = 0; i < 16; ++i) n += bits[i];
    out.insert(out.end(), {0xFF, 0xC4});
    put16(2 + 1 + 16 + n);
    out.push_back(uint8_t(tc_th));
    out.insert(out.end(), bits, bits + 16);
    out.insert(out.end(), vals, vals + n);
  };
  put_dht(0x00, kDcLumaBits, kDcVals);
  put_dht(0x10, kAcLumaBits, kAcLumaVals);
  put_dht(0x01, kDcChromaBits, kDcVals);
  put_dht(0x11, kAcChromaBits, kAcChromaVals);
  out.insert(out.end(), {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02, 0x11, 0x03, 0x11,
                         0x00, 0x3F, 0x00});

  const HuffCode dcc[2] = {make_codes(kDcLumaBits, kDcVals), make_codes(kDcChromaBits, kDcVals)};
  const HuffCode acc[2] = {make_codes(kAcLumaBits, kAcLumaVals),
                           make_codes(kAcChromaBits, kAcChromaVals)};
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};

  auto quantize = [&](const Plane& p, int by, int bx, int t, int* qcoef) {
    int d[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) d[r * 8 + c] = int(p.at(by * 8 + r, bx * 8 + c)) - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {  // jcdctmgr.c: rounded division by 8 q
      int qv = int(q[t][i]) << 3, v = d[i];
      qcoef[i] = v < 0 ? -((-v + (qv >> 1)) / qv) : (v + (qv >> 1)) / qv;
    }
  };
  auto emit = [&](const int* qcoef, int ci, int t) {
    int diff = qcoef[0] - last_dc[ci];
    last_dc[ci] = qcoef[0];
    int a = diff < 0 ? -diff : diff, nb = 0;
    while (a) {
      ++nb;
      a >>= 1;
    }
    bw.put(dcc[t].code[nb], dcc[t].size[nb]);
    if (nb) bw.put(uint32_t(diff < 0 ? diff - 1 : diff), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = qcoef[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(acc[t].code[0xF0], acc[t].size[0xF0]);
        run -= 16;
      }
      a = v < 0 ? -v : v;
      nb = 0;
      while (a) {
        ++nb;
        a >>= 1;
      }
      int sym = (run << 4) | nb;
      bw.put(acc[t].code[sym], acc[t].size[sym]);
      bw.put(uint32_t(v < 0 ? v - 1 : v), nb);
      run = 0;
    }
    if (run > 0) bw.put(acc[t].code[0], acc[t].size[0]);
  };

  // jccoefct.c: blocks past the image's last block column or row are dummy
  // blocks, AC zero and DC copied from the block before them in the MCU
  const Plane* planes[3] = {&yp, &cbp, &crp};
  const int hs[3] = {hmax, 1, 1}, vs[3] = {vmax, 1, 1};
  const int wib[3] = {(width + 7) / 8, cwb, cwb};
  const int hib[3] = {(height + 7) / 8, (chd + 7) / 8, (chd + 7) / 8};
  std::vector<int> blk(64 * 4);
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx)
      for (int ci = 0; ci < 3; ++ci) {
        int t = ci ? 1 : 0, nblk = hs[ci] * vs[ci];
        blk.assign(64 * nblk, 0);
        for (int y = 0; y < vs[ci]; ++y)
          for (int x = 0; x < hs[ci]; ++x) {
            int by = my * vs[ci] + y, bx = mx * hs[ci] + x, b = y * hs[ci] + x;
            int* cur = blk.data() + 64 * b;
            if (by >= hib[ci]) {
              cur[0] = blk[64 * (y * hs[ci] - 1)];
            } else if (bx >= wib[ci]) {
              cur[0] = blk[64 * (b - 1)];
            } else {
              quantize(*planes[ci], by, bx, t, cur);
            }
          }
        for (int b = 0; b < nblk; ++b) emit(blk.data() + 64 * b, ci, t);
      }
  bw.flush();
  out.insert(out.end(), {0xFF, 0xD9});
}

}  // namespace

extern "C" {

// width, height and components of a JPEG stream from its headers; 0 on
// success, else 1 with the reason in err
int vs_jpeg_info(const uint8_t* data, size_t len, int* w, int* h, int* ncomp, char* err,
                 int errlen) {
  try {
    Decoder d(data, len);
    d.parse_header();
    *w = d.width;
    *h = d.height;
    *ncomp = static_cast<int>(d.comps.size());
    return 0;
  } catch (const JpegError& e) {
    copy_err(e.msg, err, errlen);
    return 1;
  }
}

// n streams of one size (w, h) -> out (n, h, w, 3) RGB u8. Returns -1 on
// success, else the index of a failing frame with its reason in err.
int vs_jpeg_decode_batch(const uint8_t** datas, const size_t* lens, int n, uint8_t* out,
                         int w, int h, int n_threads, char* err, int errlen) {
  std::string msg;
  int bad = parallel_frames(
      n, n_threads,
      [&](int i) {
        Decoder d(datas[i], lens[i]);
        d.parse();
        if (d.width != w || d.height != h)
          fail("size " + std::to_string(d.width) + "x" + std::to_string(d.height) +
               " differs from the batch's " + std::to_string(w) + "x" + std::to_string(h));
        d.to_rgb(out + size_t(i) * w * h * 3);
      },
      &msg);
  if (bad >= 0) copy_err(msg, err, errlen);
  return bad;
}

// n RGB u8 frames (n, h, w, 3) -> baseline 4:2:0 JPEG files at `quality`.
// Frame i's length goes to lens[i], and the
// file to out + i * cap when it fits (the caller encodes a longer one again
// with a larger cap). Returns -1, or the index of a frame that failed.
int vs_jpeg_encode_batch(const uint8_t* rgb, int n, int w, int h, int quality, uint8_t* out,
                         size_t cap, size_t* lens, int n_threads, char* err, int errlen) {
  std::string msg;
  int bad = parallel_frames(
      n, n_threads,
      [&](int i) {
        std::vector<uint8_t> buf;
        buf.reserve(size_t(w) * h + 1024);
        encode_one(rgb + size_t(i) * w * h * 3, w, h, quality, buf);
        lens[i] = buf.size();
        if (buf.size() <= cap) std::memcpy(out + size_t(i) * cap, buf.data(), buf.size());
      },
      &msg);
  if (bad >= 0) copy_err(msg, err, errlen);
  return bad;
}

// Pillow's 8-bit resampling, both passes: src (n, h, w, c) u8 -> dst (n, oh,
// ow, c). Horizontal first (skipped when ow == w), then vertical (skipped
// when oh == h); each pass's first source index (out,) and fixed-point
// weights (out, ks) with 22 fraction bits, sums clipped to 0..255.
void vs_resample_batch(const uint8_t* src, int n, int h, int w, int c, uint8_t* dst, int oh,
                       int ow, const int64_t* xmin_w, const int64_t* k_w, int ks_w,
                       const int64_t* xmin_h, const int64_t* k_h, int ks_h, int n_threads) {
  const int64_t round = int64_t(1) << 21;
  auto clip = [](int64_t v) { return uint8_t(std::clamp<int64_t>(v >> 22, 0, 255)); };
  parallel_frames(
      n, n_threads,
      [&](int i) {
        const uint8_t* s = src + size_t(i) * h * w * c;
        uint8_t* d = dst + size_t(i) * oh * ow * c;
        std::vector<uint8_t> mid;
        const uint8_t* cur = s;
        int cw = w;
        if (ow != w) {
          uint8_t* m = (oh != h) ? (mid.resize(size_t(h) * ow * c), mid.data()) : d;
          for (int y = 0; y < h; ++y)
            for (int x = 0; x < ow; ++x)
              for (int ch = 0; ch < c; ++ch) {
                int64_t acc = round;
                for (int k = 0; k < ks_w; ++k) {
                  int sx = std::min<int64_t>(xmin_w[x] + k, w - 1);
                  acc += k_w[size_t(x) * ks_w + k] * s[(size_t(y) * w + sx) * c + ch];
                }
                m[(size_t(y) * ow + x) * c + ch] = clip(acc);
              }
          cur = m;
          cw = ow;
        }
        if (oh != h) {
          for (int y = 0; y < oh; ++y)
            for (int x = 0; x < cw; ++x)
              for (int ch = 0; ch < c; ++ch) {
                int64_t acc = round;
                for (int k = 0; k < ks_h; ++k) {
                  int sy = std::min<int64_t>(xmin_h[y] + k, h - 1);
                  acc += k_h[size_t(y) * ks_h + k] * cur[(size_t(sy) * cw + x) * c + ch];
                }
                d[(size_t(y) * cw + x) * c + ch] = clip(acc);
              }
        } else if (ow == w) {
          std::memcpy(d, s, size_t(h) * w * c);
        }
      },
      nullptr);
}

}  // extern "C"
