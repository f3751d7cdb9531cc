// LASzip (.laz) point codec of the port's data layer — C++, ctypes-bound by
// flowcompare_tpu_torch/data/laz.py.
//
// The port's own copy of flowcompare_tpu/native/laz_codec.cpp: the LASzip
// "pointwise chunked" format (compressor 2) — the FastAC-style adaptive
// arithmetic coder, the integer corrector compressor, and the version-2
// item codecs POINT10 / GPSTIME11 / RGB12 / BYTE, for both decompression
// and compression. The bitstream is the JAX package's, byte for byte
// (tests/test_torch_port_laz.py). One change: laz_encode tells a bad item
// layout (LAZ_ERR_LAYOUT) from a destination buffer that is too small
// (LAZ_ERR_CAPACITY), so the writer retries only the latter.
//
// The algorithms follow the published LASzip format description (Isenburg,
// "LASzip: lossless compression of LiDAR data", PE&RS 2013, and the LAZ
// specification). Encode and decode are exact inverses by construction;
// conformance against the reference LASzip implementation is targeted, not
// certified, so data/laz.py checks every decoded point against the header's
// bounding box.
//
// Exposed via ctypes:
//   laz_decode            chunks of compressed points -> raw records
//   laz_encode            raw records -> compressed chunk stream
//   laz_decode_chunk_table / laz_encode_chunk_table
//
// Built with g++ at first use (flowcompare_tpu_torch/native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Adaptive arithmetic coder (FastAC lineage: Amir Said's range coder with
// adaptive bit/symbol models, as used by LASzip).
// ---------------------------------------------------------------------------

constexpr uint32_t AC_MinLength = 0x01000000u;
constexpr uint32_t AC_MaxLength = 0xFFFFFFFFu;
constexpr uint32_t BM_LengthShift = 13;
constexpr uint32_t BM_MaxCount = 1u << BM_LengthShift;
constexpr uint32_t DM_LengthShift = 15;
constexpr uint32_t DM_MaxCount = 1u << DM_LengthShift;

struct BitModel {
  uint32_t bit0prob = 0, bit0count = 0, bitcount = 0;
  uint32_t update_cycle = 0, bits_until_update = 0;
  void init() {
    bit0count = 1;
    bitcount = 2;
    bit0prob = 1u << (BM_LengthShift - 1);
    update_cycle = bits_until_update = 4;
  }
  void update() {
    bitcount += update_cycle;
    if (bitcount > BM_MaxCount) {
      bitcount = (bitcount + 1) >> 1;
      bit0count = (bit0count + 1) >> 1;
      if (bit0count == bitcount) ++bitcount;
    }
    bit0prob = (bit0count << BM_LengthShift) / bitcount;
    update_cycle = (5 * update_cycle) >> 2;
    if (update_cycle > 64) update_cycle = 64;
    bits_until_update = update_cycle;
  }
};

struct SymModel {
  uint32_t symbols = 0;
  std::vector<uint32_t> distribution, symbol_count;
  uint32_t total_count = 0, update_cycle = 0, symbols_until_update = 0;
  // decode-side lookup table for models with many symbols (pure speedup:
  // the coded bitstream depends only on `distribution`, never on this)
  uint32_t table_size = 0, table_shift = 0;
  std::vector<uint32_t> decoder_table;
  void init(uint32_t n, bool with_table = false) {
    symbols = n;
    distribution.assign(n, 0);
    symbol_count.assign(n, 1);
    if (with_table && n > 16) {
      uint32_t table_bits = 3;
      while (n > (1u << (table_bits + 2))) ++table_bits;
      table_size = 1u << table_bits;
      table_shift = DM_LengthShift - table_bits;
      decoder_table.assign(table_size + 2, 0);
    }
    total_count = 0;
    update_cycle = n;
    update();
    symbols_until_update = update_cycle = (n + 6) >> 1;
  }
  void update() {
    if ((total_count += update_cycle) > DM_MaxCount) {
      total_count = 0;
      for (auto& c : symbol_count) {
        c = (c + 1) >> 1;
        total_count += c;
      }
    }
    uint32_t sum = 0;
    uint32_t scale = 0x80000000u / total_count;
    if (table_size) {
      uint32_t s = 0;
      for (uint32_t k = 0; k < symbols; k++) {
        distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
        sum += symbol_count[k];
        uint32_t w = distribution[k] >> table_shift;
        while (s < w) decoder_table[++s] = k - 1;
      }
      decoder_table[0] = 0;
      while (s <= table_size) decoder_table[++s] = symbols - 1;
    } else {
      for (uint32_t k = 0; k < symbols; k++) {
        distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
        sum += symbol_count[k];
      }
    }
    update_cycle = (5 * update_cycle) >> 2;
    uint32_t max_cycle = (symbols + 6) << 3;
    if (update_cycle > max_cycle) update_cycle = max_cycle;
    symbols_until_update = update_cycle;
  }
};

struct ArEnc {
  std::vector<uint8_t> buf;
  uint32_t base = 0, length = AC_MaxLength;

  void propagate_carry() {
    // carry ripples backwards through already-emitted bytes
    size_t p = buf.size();
    while (p > 0) {
      --p;
      if (buf[p] == 0xFFu) {
        buf[p] = 0;
      } else {
        ++buf[p];
        return;
      }
    }
  }
  void renorm() {
    do {
      buf.push_back(static_cast<uint8_t>(base >> 24));
      base <<= 8;
    } while ((length <<= 8) < AC_MinLength);
  }
  void encodeBit(BitModel& m, uint32_t bit) {
    uint32_t x = m.bit0prob * (length >> BM_LengthShift);
    if (!bit) {
      length = x;
      ++m.bit0count;
    } else {
      uint32_t ib = base;
      base += x;
      length -= x;
      if (ib > base) propagate_carry();
    }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
  }
  void encodeSymbol(SymModel& m, uint32_t sym) {
    uint32_t x, ib = base;
    if (sym == m.symbols - 1) {
      x = m.distribution[sym] * (length >> DM_LengthShift);
      base += x;
      length -= x;
    } else {
      x = m.distribution[sym] * (length >>= DM_LengthShift);
      base += x;
      length = m.distribution[sym + 1] * length - x;
    }
    if (ib > base) propagate_carry();
    if (length < AC_MinLength) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
  }
  void writeShort(uint32_t sym) {
    uint32_t ib = base;
    base += sym * (length >>= 16);
    if (ib > base) propagate_carry();
    if (length < AC_MinLength) renorm();
  }
  void writeBits(uint32_t bits, uint32_t sym) {
    if (bits > 19) {
      writeShort(sym & 0xFFFFu);
      sym >>= 16;
      bits -= 16;
    }
    uint32_t ib = base;
    base += sym * (length >>= bits);
    if (ib > base) propagate_carry();
    if (length < AC_MinLength) renorm();
  }
  void writeInt(uint32_t v) {
    writeShort(v & 0xFFFFu);
    writeShort(v >> 16);
  }
  void done() {
    uint32_t ib = base;
    if (length > 2 * AC_MinLength) {
      base += AC_MinLength;
      length = AC_MinLength >> 1;
    } else {
      base += AC_MinLength >> 1;
      length = AC_MinLength >> 9;
    }
    if (ib > base) propagate_carry();
    renorm();
  }
};

struct ArDec {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t value = 0, length = 0;

  ArDec(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}
  // reads past the decoder's own chunk spill into the next chunk's bytes
  // (LASzip semantics: the stream is the whole file; chunk boundaries come
  // from the chunk table, and up to 4 look-ahead bytes are never consumed
  // logically). Past the FILE end we feed zeros.
  uint8_t getByte() { return p < end ? *p++ : 0; }
  void init() {
    value = (uint32_t(getByte()) << 24) | (uint32_t(getByte()) << 16) |
            (uint32_t(getByte()) << 8) | uint32_t(getByte());
    length = AC_MaxLength;
  }
  void renorm() {
    do {
      value = (value << 8) | getByte();
    } while ((length <<= 8) < AC_MinLength);
  }
  uint32_t decodeBit(BitModel& m) {
    uint32_t x = m.bit0prob * (length >> BM_LengthShift);
    uint32_t sym = (value >= x);
    if (!sym) {
      length = x;
      ++m.bit0count;
    } else {
      value -= x;
      length -= x;
    }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
    return sym;
  }
  uint32_t decodeSymbol(SymModel& m) {
    uint32_t sym, n, x, y = length;
    if (m.table_size) {
      uint32_t dv = value / (length >>= DM_LengthShift);
      uint32_t t = dv >> m.table_shift;
      sym = m.decoder_table[t];
      n = m.decoder_table[t + 1] + 1;
      while (n > sym + 1) {
        uint32_t k = (sym + n) >> 1;
        if (m.distribution[k] > dv)
          n = k;
        else
          sym = k;
      }
      x = m.distribution[sym] * length;
      if (sym + 1 < m.symbols) y = m.distribution[sym + 1] * length;
    } else {
      sym = 0;
      n = m.symbols;
      x = 0;
      length >>= DM_LengthShift;
      uint32_t k = n >> 1;
      // binary search: largest sym with distribution[sym]*length <= value
      do {
        uint32_t z = length * m.distribution[k];
        if (z > value) {
          n = k;
          y = z;
        } else {
          sym = k;
          x = z;
        }
      } while ((k = (sym + n) >> 1) != sym);
    }
    value -= x;
    length = y - x;
    if (length < AC_MinLength) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
    return sym;
  }
  uint32_t readShort() {
    uint32_t sym = value / (length >>= 16);
    value -= sym * length;
    if (length < AC_MinLength) renorm();
    return sym;
  }
  uint32_t readBits(uint32_t bits) {
    if (bits > 19) {
      uint32_t lo = readShort();
      uint32_t hi = readBits(bits - 16) << 16;
      return hi | lo;
    }
    uint32_t sym = value / (length >>= bits);
    value -= sym * length;
    if (length < AC_MinLength) renorm();
    return sym;
  }
  uint32_t readInt() {
    uint32_t lo = readShort();
    uint32_t hi = readShort();
    return (hi << 16) | lo;
  }
};

// ---------------------------------------------------------------------------
// Integer corrector compressor: codes (real - pred) as a bucket index k
// (adaptive per-context model over corr_bits+1 symbols) + in-bucket bits
// (adaptive for the high 8, raw below). Bucket k>=1 holds
// [-(2^k - 1), -2^(k-1)] u [2^(k-1)+1, 2^k]; bucket 0 holds {0, 1}.
// ---------------------------------------------------------------------------

constexpr uint32_t IC_BITS_HIGH = 8;

struct IntComp {
  uint32_t bits = 0, corr_bits = 0, corr_range = 0;
  int32_t corr_min = 0, corr_max = 0;
  uint32_t k = 0;  // last bucket index (POINT10 reuses it as context)
  std::vector<SymModel> mBits;       // one per context, corr_bits+1 symbols
  BitModel mCorrector0;
  std::vector<SymModel> mCorrector;  // [1..corr_bits] -> index i-1

  void init(uint32_t bits_, uint32_t contexts, bool tab = false) {
    bits = bits_;
    if (bits && bits < 32) {
      corr_bits = bits;
      corr_range = 1u << bits;
      corr_min = -static_cast<int32_t>(corr_range >> 1);
      corr_max = corr_min + static_cast<int32_t>(corr_range) - 1;
    } else {
      corr_bits = 32;
      corr_range = 0;  // 2^32: wrap is the natural int32 overflow
      corr_min = INT32_MIN;
      corr_max = INT32_MAX;
    }
    k = 0;
    mBits.resize(contexts);
    for (auto& m : mBits) m.init(corr_bits + 1, tab);
    mCorrector0.init();
    mCorrector.resize(corr_bits);
    for (uint32_t i = 1; i <= corr_bits; i++)
      mCorrector[i - 1].init(i <= IC_BITS_HIGH ? (1u << i) : (1u << IC_BITS_HIGH),
                             tab);
  }

  int32_t decompress(ArDec& dec, int32_t pred, uint32_t context) {
    int32_t real = pred + readCorrector(dec, mBits[context]);
    if (corr_range) {
      if (real < 0)
        real += static_cast<int32_t>(corr_range);
      else if (static_cast<uint32_t>(real) >= corr_range)
        real -= static_cast<int32_t>(corr_range);
    }
    return real;
  }
  int32_t readCorrector(ArDec& dec, SymModel& m) {
    int32_t c;
    k = dec.decodeSymbol(m);
    if (k) {
      if (k < 32) {
        uint32_t craw;
        if (k <= IC_BITS_HIGH) {
          craw = dec.decodeSymbol(mCorrector[k - 1]);
        } else {
          uint32_t k1 = k - IC_BITS_HIGH;
          craw = dec.decodeSymbol(mCorrector[k - 1]);
          uint32_t c1 = dec.readBits(k1);
          craw = (craw << k1) | c1;
        }
        if (craw >= (1u << (k - 1)))
          c = static_cast<int32_t>(craw) + 1;
        else
          c = static_cast<int32_t>(craw) - static_cast<int32_t>((1u << k) - 1);
      } else {
        c = corr_min;
      }
    } else {
      c = static_cast<int32_t>(dec.decodeBit(mCorrector0));
    }
    return c;
  }

  void compress(ArEnc& enc, int32_t pred, int32_t real, uint32_t context) {
    // int64 so the 32-bit config's wraparound stays well-defined
    int64_t corr = static_cast<int64_t>(real) - static_cast<int64_t>(pred);
    if (corr_range) {
      if (corr < corr_min)
        corr += corr_range;
      else if (corr > corr_max)
        corr -= corr_range;
    } else {
      corr = static_cast<int32_t>(static_cast<uint32_t>(real) -
                                  static_cast<uint32_t>(pred));
    }
    writeCorrector(enc, static_cast<int32_t>(corr), mBits[context]);
  }
  void writeCorrector(ArEnc& enc, int32_t c, SymModel& m) {
    k = 0;
    // |c| adjusted so c == 2^k lands in bucket k (c-1 for positives)
    uint32_t c1 = (c <= 0) ? static_cast<uint32_t>(-static_cast<int64_t>(c))
                           : static_cast<uint32_t>(c) - 1;
    while (c1) {
      c1 >>= 1;
      ++k;
    }
    enc.encodeSymbol(m, k);
    if (k) {
      if (k < 32) {
        uint32_t craw =
            (c >= 0) ? static_cast<uint32_t>(c) - 1
                     : static_cast<uint32_t>(c + static_cast<int32_t>((1u << k) - 1));
        if (k <= IC_BITS_HIGH) {
          enc.encodeSymbol(mCorrector[k - 1], craw);
        } else {
          uint32_t k1 = k - IC_BITS_HIGH;
          enc.encodeSymbol(mCorrector[k - 1], craw >> k1);
          enc.writeBits(k1, craw & ((1u << k1) - 1));
        }
      }
      // k == 32: c must be corr_min; the bucket index alone encodes it
    } else {
      enc.encodeBit(mCorrector0, static_cast<uint32_t>(c));
    }
  }
};

// ---------------------------------------------------------------------------
// POINT10 v2 item codec (20-byte LAS point: x y z i32, intensity u16,
// flags u8, classification u8, scan_angle i8, user_data u8, psid u16)
// ---------------------------------------------------------------------------

struct StreamingMedian5 {
  int32_t values[5];
  bool high;
  void init() {
    values[0] = values[1] = values[2] = values[3] = values[4] = 0;
    high = true;
  }
  void add(int32_t v) {
    if (high) {
      if (v < values[2]) {
        values[4] = values[3];
        values[3] = values[2];
        if (v < values[0]) {
          values[2] = values[1];
          values[1] = values[0];
          values[0] = v;
        } else if (v < values[1]) {
          values[2] = values[1];
          values[1] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (v < values[3]) {
          values[4] = values[3];
          values[3] = v;
        } else {
          values[4] = v;
        }
        high = false;
      }
    } else {
      if (values[2] < v) {
        values[0] = values[1];
        values[1] = values[2];
        if (values[4] < v) {
          values[2] = values[3];
          values[3] = values[4];
          values[4] = v;
        } else if (values[3] < v) {
          values[2] = values[3];
          values[3] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (values[1] < v) {
          values[0] = values[1];
          values[1] = v;
        } else {
          values[0] = v;
        }
        high = true;
      }
    }
  }
  int32_t get() const { return values[2]; }
};

const uint8_t number_return_map[8][8] = {
    {15, 14, 13, 12, 11, 10, 9, 8}, {14, 0, 1, 3, 6, 10, 10, 9},
    {13, 1, 2, 4, 7, 11, 11, 10},   {12, 3, 4, 5, 8, 12, 12, 11},
    {11, 6, 7, 8, 9, 13, 13, 12},   {10, 10, 11, 12, 13, 14, 14, 13},
    {9, 10, 11, 12, 13, 14, 15, 14}, {8, 9, 10, 11, 12, 13, 14, 15}};

const uint8_t number_return_level[8][8] = {
    {0, 1, 2, 3, 4, 5, 6, 7}, {1, 0, 1, 2, 3, 4, 5, 6},
    {2, 1, 0, 1, 2, 3, 4, 5}, {3, 2, 1, 0, 1, 2, 3, 4},
    {4, 3, 2, 1, 0, 1, 2, 3}, {5, 4, 3, 2, 1, 0, 1, 2},
    {6, 5, 4, 3, 2, 1, 0, 1}, {7, 6, 5, 4, 3, 2, 1, 0}};

inline uint16_t rd16(const uint8_t* p) {
  return uint16_t(p[0]) | (uint16_t(p[1]) << 8);
}
inline void wr16(uint8_t* p, uint16_t v) {
  p[0] = uint8_t(v);
  p[1] = uint8_t(v >> 8);
}
inline int32_t rd32(const uint8_t* p) {
  return int32_t(uint32_t(p[0]) | (uint32_t(p[1]) << 8) |
                 (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24));
}
inline void wr32(uint8_t* p, int32_t v) {
  uint32_t u = uint32_t(v);
  p[0] = uint8_t(u);
  p[1] = uint8_t(u >> 8);
  p[2] = uint8_t(u >> 16);
  p[3] = uint8_t(u >> 24);
}
inline uint8_t u8_clamp(int32_t x) {
  return x < 0 ? 0 : (x > 255 ? 255 : uint8_t(x));
}

struct Point10v2 {
  uint8_t last[20];
  uint16_t last_intensity[16];
  StreamingMedian5 xm[16], ym[16];
  int32_t last_height[8];
  SymModel m_changed;
  SymModel m_sar[2];
  std::vector<SymModel> m_bitbyte, m_class, m_ud;  // lazily initialised
  std::vector<uint8_t> has_bitbyte, has_class, has_ud;
  IntComp ic_intensity, ic_psid, ic_dx, ic_dy, ic_z;
  bool tab = false;

  void init(const uint8_t* first, bool tab_ = false) {
    tab = tab_;
    for (int i = 0; i < 16; i++) {
      xm[i].init();
      ym[i].init();
      last_intensity[i] = 0;
    }
    for (int i = 0; i < 8; i++) last_height[i] = 0;
    m_changed.init(64, tab);
    m_sar[0].init(256, tab);
    m_sar[1].init(256, tab);
    m_bitbyte.assign(256, SymModel());
    m_class.assign(256, SymModel());
    m_ud.assign(256, SymModel());
    has_bitbyte.assign(256, 0);
    has_class.assign(256, 0);
    has_ud.assign(256, 0);
    ic_intensity.init(16, 4, tab);
    ic_psid.init(16, 1, tab);
    ic_dx.init(32, 2, tab);
    ic_dy.init(32, 22, tab);
    ic_z.init(32, 20, tab);
    std::memcpy(last, first, 20);
    // LASzip quirk: the first point's intensity is zeroed in the
    // last-item state (last_intensity[] drives intensity prediction)
    last[12] = 0;
    last[13] = 0;
  }

  SymModel& lazy(std::vector<SymModel>& pool, std::vector<uint8_t>& flag,
                 uint32_t ctx) {
    if (!flag[ctx]) {
      pool[ctx].init(256, tab);
      flag[ctx] = 1;
    }
    return pool[ctx];
  }

  void read(ArDec& dec, uint8_t* item) {
    uint32_t r, n, m, l;
    uint32_t changed = dec.decodeSymbol(m_changed);
    if (changed) {
      if (changed & 32) {
        SymModel& bm = lazy(m_bitbyte, has_bitbyte, last[14]);
        last[14] = uint8_t(dec.decodeSymbol(bm));
      }
      r = last[14] & 7;
      n = (last[14] >> 3) & 7;
      m = number_return_map[n][r];
      l = number_return_level[n][r];
      if (changed & 16) {
        last_intensity[m] = uint16_t(
            ic_intensity.decompress(dec, last_intensity[m], m < 3 ? m : 3));
      }
      wr16(last + 12, last_intensity[m]);
      if (changed & 8) {
        SymModel& cm = lazy(m_class, has_class, last[15]);
        last[15] = uint8_t(dec.decodeSymbol(cm));
      }
      if (changed & 4) {
        uint32_t f = (last[14] >> 6) & 1;
        last[16] = uint8_t(dec.decodeSymbol(m_sar[f]) + last[16]);
      }
      if (changed & 2) {
        SymModel& um = lazy(m_ud, has_ud, last[17]);
        last[17] = uint8_t(dec.decodeSymbol(um));
      }
      if (changed & 1) {
        wr16(last + 18, uint16_t(ic_psid.decompress(dec, rd16(last + 18), 0)));
      }
    } else {
      r = last[14] & 7;
      n = (last[14] >> 3) & 7;
      m = number_return_map[n][r];
      l = number_return_level[n][r];
      wr16(last + 12, last_intensity[m]);
    }
    // x
    int32_t median = xm[m].get();
    int32_t diff = ic_dx.decompress(dec, median, n == 1);
    wr32(last + 0, rd32(last + 0) + diff);
    xm[m].add(diff);
    // y (context folds in how many bits the x corrector needed)
    median = ym[m].get();
    uint32_t kb = ic_dx.k;
    diff = ic_dy.decompress(dec, median,
                            (n == 1) + (kb < 20 ? (kb & ~1u) : 20));
    wr32(last + 4, rd32(last + 4) + diff);
    ym[m].add(diff);
    // z predicted from the last height at this return level
    kb = (ic_dx.k + ic_dy.k) / 2;
    int32_t z = ic_z.decompress(dec, last_height[l],
                                (n == 1) + (kb < 18 ? (kb & ~1u) : 18));
    wr32(last + 8, z);
    last_height[l] = z;
    std::memcpy(item, last, 20);
  }

  void write(ArEnc& enc, const uint8_t* item) {
    uint32_t r = item[14] & 7;
    uint32_t n = (item[14] >> 3) & 7;
    uint32_t m = number_return_map[n][r];
    uint32_t l = number_return_level[n][r];
    uint16_t intensity = rd16(item + 12);
    uint32_t changed = (uint32_t(last[14] != item[14]) << 5) |
                       (uint32_t(last_intensity[m] != intensity) << 4) |
                       (uint32_t(last[15] != item[15]) << 3) |
                       (uint32_t(last[16] != item[16]) << 2) |
                       (uint32_t(last[17] != item[17]) << 1) |
                       uint32_t(rd16(last + 18) != rd16(item + 18));
    enc.encodeSymbol(m_changed, changed);
    if (changed) {
      if (changed & 32) {
        SymModel& bm = lazy(m_bitbyte, has_bitbyte, last[14]);
        enc.encodeSymbol(bm, item[14]);
      }
      if (changed & 16) {
        ic_intensity.compress(enc, last_intensity[m], intensity,
                              m < 3 ? m : 3);
        last_intensity[m] = intensity;
      }
      if (changed & 8) {
        SymModel& cm = lazy(m_class, has_class, last[15]);
        enc.encodeSymbol(cm, item[15]);
      }
      if (changed & 4) {
        uint32_t f = (item[14] >> 6) & 1;
        enc.encodeSymbol(m_sar[f], uint8_t(item[16] - last[16]));
      }
      if (changed & 2) {
        SymModel& um = lazy(m_ud, has_ud, last[17]);
        enc.encodeSymbol(um, item[17]);
      }
      if (changed & 1) {
        ic_psid.compress(enc, rd16(last + 18), rd16(item + 18), 0);
      }
    }
    // x/y code the successive DELTA against its streaming median; z codes
    // the absolute value against the last height at this return level
    int32_t median = xm[m].get();
    int32_t dx = rd32(item + 0) - rd32(last + 0);
    ic_dx.compress(enc, median, dx, n == 1);
    xm[m].add(dx);
    median = ym[m].get();
    uint32_t kb = ic_dx.k;
    int32_t dy = rd32(item + 4) - rd32(last + 4);
    ic_dy.compress(enc, median, dy, (n == 1) + (kb < 20 ? (kb & ~1u) : 20));
    ym[m].add(dy);
    kb = (ic_dx.k + ic_dy.k) / 2;
    ic_z.compress(enc, last_height[l], rd32(item + 8),
                  (n == 1) + (kb < 18 ? (kb & ~1u) : 18));
    last_height[l] = rd32(item + 8);
    std::memcpy(last, item, 20);
  }
};

// ---------------------------------------------------------------------------
// GPSTIME11 v2
// ---------------------------------------------------------------------------

constexpr int32_t GPS_MULTI = 500;
constexpr int32_t GPS_MULTI_MINUS = -10;
constexpr uint32_t GPS_MULTI_UNCHANGED = GPS_MULTI - GPS_MULTI_MINUS + 1;   // 511
constexpr uint32_t GPS_MULTI_CODE_FULL = GPS_MULTI - GPS_MULTI_MINUS + 2;   // 512
constexpr uint32_t GPS_MULTI_TOTAL = GPS_MULTI - GPS_MULTI_MINUS + 6;       // 516

inline int32_t i32_quantize(float f) {
  return f >= 0 ? int32_t(f + 0.5f) : int32_t(f - 0.5f);
}

struct GpsTime11v2 {
  uint32_t last_idx, next_idx;
  int64_t last_gpstime[4];
  int32_t last_gpstime_diff[4];
  int32_t multi_extreme_counter[4];
  SymModel m_multi, m_0diff;
  IntComp ic_gpstime;

  void init(const uint8_t* first, bool tab = false) {
    last_idx = next_idx = 0;
    for (int i = 0; i < 4; i++) {
      last_gpstime[i] = 0;
      last_gpstime_diff[i] = 0;
      multi_extreme_counter[i] = 0;
    }
    m_multi.init(GPS_MULTI_TOTAL, tab);
    m_0diff.init(6);
    ic_gpstime.init(32, 9, tab);
    std::memcpy(&last_gpstime[0], first, 8);
  }

  void read(ArDec& dec, uint8_t* item) {
    // sequence-switch symbols re-enter the read logic with a different
    // active sequence; loop instead of recursing so a corrupt stream
    // full of switch symbols cannot grow the stack. A VALID stream emits
    // at most one switch per point (the encoder switches once then codes
    // the value); bound the restarts so corrupt data that keeps decoding
    // switch symbols terminates with the current sequence value instead
    // of spinning forever.
    int restarts = 0;
  restart:
    if (restarts++ > 8) {
      std::memcpy(item, &last_gpstime[last_idx], 8);
      return;
    }
    if (last_gpstime_diff[last_idx] == 0) {
      uint32_t multi = dec.decodeSymbol(m_0diff);
      if (multi == 1) {  // difference fits 32 bits
        last_gpstime_diff[last_idx] = ic_gpstime.decompress(dec, 0, 0);
        last_gpstime[last_idx] += last_gpstime_diff[last_idx];
        multi_extreme_counter[last_idx] = 0;
      } else if (multi == 2) {  // difference is huge: new sequence, full 64
        next_idx = (next_idx + 1) & 3;
        uint64_t hi = uint64_t(uint32_t(ic_gpstime.decompress(
            dec, int32_t(uint64_t(last_gpstime[last_idx]) >> 32), 8)));
        uint64_t v = (hi << 32) | dec.readInt();
        last_gpstime[next_idx] = int64_t(v);
        last_idx = next_idx;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      } else if (multi > 2) {  // switch to another sequence
        last_idx = (last_idx + multi - 2) & 3;
        goto restart;
      }
      // multi == 0: time stays the same
    } else {
      uint32_t multi = dec.decodeSymbol(m_multi);
      if (multi == 1) {
        last_gpstime[last_idx] +=
            ic_gpstime.decompress(dec, last_gpstime_diff[last_idx], 1);
        multi_extreme_counter[last_idx] = 0;
      } else if (multi < GPS_MULTI_UNCHANGED) {
        int32_t gpstime_diff;
        if (multi == 0) {
          gpstime_diff = ic_gpstime.decompress(dec, 0, 7);
          if (++multi_extreme_counter[last_idx] > 3) {
            last_gpstime_diff[last_idx] = gpstime_diff;
            multi_extreme_counter[last_idx] = 0;
          }
        } else if (multi < uint32_t(GPS_MULTI)) {
          gpstime_diff = ic_gpstime.decompress(
              dec, int32_t(multi) * last_gpstime_diff[last_idx],
              multi < 10 ? 2 : 3);
        } else if (multi == uint32_t(GPS_MULTI)) {
          gpstime_diff = ic_gpstime.decompress(
              dec, GPS_MULTI * last_gpstime_diff[last_idx], 4);
          if (++multi_extreme_counter[last_idx] > 3) {
            last_gpstime_diff[last_idx] = gpstime_diff;
            multi_extreme_counter[last_idx] = 0;
          }
        } else {
          int32_t neg = GPS_MULTI - int32_t(multi);  // -1 .. -10
          if (neg > GPS_MULTI_MINUS) {
            gpstime_diff = ic_gpstime.decompress(
                dec, neg * last_gpstime_diff[last_idx], 5);
          } else {
            gpstime_diff = ic_gpstime.decompress(
                dec, GPS_MULTI_MINUS * last_gpstime_diff[last_idx], 6);
            if (++multi_extreme_counter[last_idx] > 3) {
              last_gpstime_diff[last_idx] = gpstime_diff;
              multi_extreme_counter[last_idx] = 0;
            }
          }
        }
        last_gpstime[last_idx] += gpstime_diff;
      } else if (multi == GPS_MULTI_CODE_FULL) {
        next_idx = (next_idx + 1) & 3;
        uint64_t hi = uint64_t(uint32_t(ic_gpstime.decompress(
            dec, int32_t(uint64_t(last_gpstime[last_idx]) >> 32), 8)));
        uint64_t v = (hi << 32) | dec.readInt();
        last_gpstime[next_idx] = int64_t(v);
        last_idx = next_idx;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      } else if (multi > GPS_MULTI_CODE_FULL) {
        last_idx = (last_idx + multi - GPS_MULTI_CODE_FULL) & 3;
        goto restart;
      }
      // multi == GPS_MULTI_UNCHANGED: time stays the same
    }
    std::memcpy(item, &last_gpstime[last_idx], 8);
  }

  void write(ArEnc& enc, const uint8_t* item) {
    int64_t gps;
    std::memcpy(&gps, item, 8);
    if (last_gpstime_diff[last_idx] == 0) {
      if (gps == last_gpstime[last_idx]) {
        enc.encodeSymbol(m_0diff, 0);
        return;
      }
      int64_t diff64 = gps - last_gpstime[last_idx];
      int32_t diff = int32_t(diff64);
      if (int64_t(diff) == diff64) {
        enc.encodeSymbol(m_0diff, 1);
        ic_gpstime.compress(enc, 0, diff, 0);
        last_gpstime_diff[last_idx] = diff;
        multi_extreme_counter[last_idx] = 0;
        last_gpstime[last_idx] = gps;
      } else {
        for (uint32_t i = 1; i < 4; i++) {
          int64_t od = gps - last_gpstime[(last_idx + i) & 3];
          if (int64_t(int32_t(od)) == od) {
            enc.encodeSymbol(m_0diff, i + 2);
            last_idx = (last_idx + i) & 3;
            write(enc, item);
            return;
          }
        }
        enc.encodeSymbol(m_0diff, 2);
        ic_gpstime.compress(enc, int32_t(uint64_t(last_gpstime[last_idx]) >> 32),
                            int32_t(uint64_t(gps) >> 32), 8);
        enc.writeInt(uint32_t(uint64_t(gps)));
        next_idx = (next_idx + 1) & 3;
        last_idx = next_idx;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
        last_gpstime[last_idx] = gps;
      }
    } else {
      if (gps == last_gpstime[last_idx]) {
        enc.encodeSymbol(m_multi, GPS_MULTI_UNCHANGED);
        return;
      }
      int64_t diff64 = gps - last_gpstime[last_idx];
      int32_t diff = int32_t(diff64);
      if (int64_t(diff) == diff64) {
        int32_t multi = i32_quantize(float(diff) /
                                     float(last_gpstime_diff[last_idx]));
        if (multi == 1) {
          enc.encodeSymbol(m_multi, 1);
          ic_gpstime.compress(enc, last_gpstime_diff[last_idx], diff, 1);
          multi_extreme_counter[last_idx] = 0;
        } else if (multi > 0) {
          if (multi < GPS_MULTI) {
            enc.encodeSymbol(m_multi, uint32_t(multi));
            ic_gpstime.compress(enc, multi * last_gpstime_diff[last_idx],
                                diff, multi < 10 ? 2 : 3);
          } else {
            enc.encodeSymbol(m_multi, uint32_t(GPS_MULTI));
            ic_gpstime.compress(enc, GPS_MULTI * last_gpstime_diff[last_idx],
                                diff, 4);
            if (++multi_extreme_counter[last_idx] > 3) {
              last_gpstime_diff[last_idx] = diff;
              multi_extreme_counter[last_idx] = 0;
            }
          }
        } else if (multi < 0) {
          if (multi > GPS_MULTI_MINUS) {
            enc.encodeSymbol(m_multi, uint32_t(GPS_MULTI - multi));
            ic_gpstime.compress(enc, multi * last_gpstime_diff[last_idx],
                                diff, 5);
          } else {
            enc.encodeSymbol(m_multi, uint32_t(GPS_MULTI - GPS_MULTI_MINUS));
            ic_gpstime.compress(
                enc, GPS_MULTI_MINUS * last_gpstime_diff[last_idx], diff, 6);
            if (++multi_extreme_counter[last_idx] > 3) {
              last_gpstime_diff[last_idx] = diff;
              multi_extreme_counter[last_idx] = 0;
            }
          }
        } else {  // multi == 0
          enc.encodeSymbol(m_multi, 0);
          ic_gpstime.compress(enc, 0, diff, 7);
          if (++multi_extreme_counter[last_idx] > 3) {
            last_gpstime_diff[last_idx] = diff;
            multi_extreme_counter[last_idx] = 0;
          }
        }
        last_gpstime[last_idx] = gps;
      } else {
        for (uint32_t i = 1; i < 4; i++) {
          int64_t od = gps - last_gpstime[(last_idx + i) & 3];
          if (int64_t(int32_t(od)) == od) {
            enc.encodeSymbol(m_multi, GPS_MULTI_CODE_FULL + i);
            last_idx = (last_idx + i) & 3;
            write(enc, item);
            return;
          }
        }
        enc.encodeSymbol(m_multi, GPS_MULTI_CODE_FULL);
        ic_gpstime.compress(enc, int32_t(uint64_t(last_gpstime[last_idx]) >> 32),
                            int32_t(uint64_t(gps) >> 32), 8);
        enc.writeInt(uint32_t(uint64_t(gps)));
        next_idx = (next_idx + 1) & 3;
        last_idx = next_idx;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
        last_gpstime[last_idx] = gps;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// RGB12 v2 (6 bytes: r g b u16)
// ---------------------------------------------------------------------------

struct Rgb12v2 {
  uint16_t last[3];
  SymModel m_byte_used;
  SymModel m_diff[6];

  void init(const uint8_t* first, bool tab = false) {
    m_byte_used.init(128, tab);
    for (auto& m : m_diff) m.init(256, tab);
    last[0] = rd16(first);
    last[1] = rd16(first + 2);
    last[2] = rd16(first + 4);
  }

  void read(ArDec& dec, uint8_t* item) {
    uint32_t sym = dec.decodeSymbol(m_byte_used);
    uint16_t r, g, b;
    int32_t diff;
    if (sym & 1)
      r = uint8_t(dec.decodeSymbol(m_diff[0]) + (last[0] & 0xFF));
    else
      r = last[0] & 0xFF;
    if (sym & 2)
      r |= uint16_t(uint8_t(dec.decodeSymbol(m_diff[1]) + (last[0] >> 8))) << 8;
    else
      r |= last[0] & 0xFF00;
    if (sym & 64) {
      diff = (r & 0xFF) - (last[0] & 0xFF);
      if (sym & 4)
        g = uint8_t(dec.decodeSymbol(m_diff[2]) +
                    u8_clamp(diff + (last[1] & 0xFF)));
      else
        g = last[1] & 0xFF;
      if (sym & 16) {
        diff = (diff + (g & 0xFF) - (last[1] & 0xFF)) / 2;
        b = uint8_t(dec.decodeSymbol(m_diff[4]) +
                    u8_clamp(diff + (last[2] & 0xFF)));
      } else {
        b = last[2] & 0xFF;
      }
      diff = (r >> 8) - (last[0] >> 8);
      if (sym & 8)
        g |= uint16_t(uint8_t(dec.decodeSymbol(m_diff[3]) +
                              u8_clamp(diff + (last[1] >> 8)))) << 8;
      else
        g |= last[1] & 0xFF00;
      if (sym & 32) {
        diff = (diff + (g >> 8) - (last[1] >> 8)) / 2;
        b |= uint16_t(uint8_t(dec.decodeSymbol(m_diff[5]) +
                              u8_clamp(diff + (last[2] >> 8)))) << 8;
      } else {
        b |= last[2] & 0xFF00;
      }
    } else {
      g = r;
      b = r;
    }
    last[0] = r;
    last[1] = g;
    last[2] = b;
    wr16(item, r);
    wr16(item + 2, g);
    wr16(item + 4, b);
  }

  void write(ArEnc& enc, const uint8_t* item) {
    uint16_t r = rd16(item), g = rd16(item + 2), b = rd16(item + 4);
    int32_t diff;
    uint32_t sym = (uint32_t((last[0] & 0x00FF) != (r & 0x00FF)) << 0) |
                   (uint32_t((last[0] & 0xFF00) != (r & 0xFF00)) << 1) |
                   (uint32_t((last[1] & 0x00FF) != (g & 0x00FF)) << 2) |
                   (uint32_t((last[1] & 0xFF00) != (g & 0xFF00)) << 3) |
                   (uint32_t((last[2] & 0x00FF) != (b & 0x00FF)) << 4) |
                   (uint32_t((last[2] & 0xFF00) != (b & 0xFF00)) << 5) |
                   (uint32_t(((r & 0x00FF) != (g & 0x00FF)) ||
                             ((r & 0x00FF) != (b & 0x00FF)) ||
                             ((r & 0xFF00) != (g & 0xFF00)) ||
                             ((r & 0xFF00) != (b & 0xFF00))) << 6);
    enc.encodeSymbol(m_byte_used, sym);
    if (sym & 1)
      enc.encodeSymbol(m_diff[0], uint8_t((r & 0xFF) - (last[0] & 0xFF)));
    if (sym & 2)
      enc.encodeSymbol(m_diff[1], uint8_t((r >> 8) - (last[0] >> 8)));
    if (sym & 64) {
      diff = (r & 0xFF) - (last[0] & 0xFF);
      if (sym & 4)
        enc.encodeSymbol(m_diff[2],
                         uint8_t((g & 0xFF) - u8_clamp(diff + (last[1] & 0xFF))));
      if (sym & 16) {
        diff = (diff + (g & 0xFF) - (last[1] & 0xFF)) / 2;
        enc.encodeSymbol(m_diff[4],
                         uint8_t((b & 0xFF) - u8_clamp(diff + (last[2] & 0xFF))));
      }
      diff = (r >> 8) - (last[0] >> 8);
      if (sym & 8)
        enc.encodeSymbol(m_diff[3],
                         uint8_t((g >> 8) - u8_clamp(diff + (last[1] >> 8))));
      if (sym & 32) {
        diff = (diff + (g >> 8) - (last[1] >> 8)) / 2;
        enc.encodeSymbol(m_diff[5],
                         uint8_t((b >> 8) - u8_clamp(diff + (last[2] >> 8))));
      }
    }
    last[0] = r;
    last[1] = g;
    last[2] = b;
  }
};

// ---------------------------------------------------------------------------
// BYTE v2 (extra bytes: one 256-symbol diff model per byte)
// ---------------------------------------------------------------------------

struct Byte2 {
  uint32_t count;
  std::vector<uint8_t> last;
  std::vector<SymModel> m_byte;

  void init(const uint8_t* first, uint32_t n, bool tab = false) {
    count = n;
    last.assign(first, first + n);
    m_byte.assign(n, SymModel());
    for (auto& m : m_byte) m.init(256, tab);
  }
  void read(ArDec& dec, uint8_t* item) {
    for (uint32_t i = 0; i < count; i++) {
      last[i] = uint8_t(dec.decodeSymbol(m_byte[i]) + last[i]);
      item[i] = last[i];
    }
  }
  void write(ArEnc& enc, const uint8_t* item) {
    for (uint32_t i = 0; i < count; i++) {
      enc.encodeSymbol(m_byte[i], uint8_t(item[i] - last[i]));
      last[i] = item[i];
    }
  }
};

// ---------------------------------------------------------------------------
// Chunk-level drivers
// ---------------------------------------------------------------------------

// LASzip item type ids (laszip.hpp)
constexpr uint16_t ITEM_BYTE = 0;
constexpr uint16_t ITEM_POINT10 = 6;
constexpr uint16_t ITEM_GPSTIME11 = 7;
constexpr uint16_t ITEM_RGB12 = 8;

struct ItemLayout {
  bool has_point10 = false, has_gps = false, has_rgb = false;
  uint32_t off_point10 = 0, off_gps = 0, off_rgb = 0, off_byte = 0;
  uint32_t n_extra = 0;
  uint32_t point_size = 0;
  bool ok = true;
  ItemLayout(const uint16_t* types, int32_t n_items, int32_t extra) {
    uint32_t off = 0;
    for (int32_t i = 0; i < n_items; i++) {
      switch (types[i]) {
        case ITEM_POINT10:
          has_point10 = true;
          off_point10 = off;
          off += 20;
          break;
        case ITEM_GPSTIME11:
          has_gps = true;
          off_gps = off;
          off += 8;
          break;
        case ITEM_RGB12:
          has_rgb = true;
          off_rgb = off;
          off += 6;
          break;
        case ITEM_BYTE:
          off_byte = off;
          n_extra = uint32_t(extra);
          off += n_extra;
          break;
        default:
          ok = false;
      }
    }
    point_size = off;
  }
};


// FLOWCOMPARE_LAZ_THREADS overrides the worker count (tests force the
// threaded path on single-core boxes; 1 forces serial)
int64_t laz_thread_count(int64_t n_chunks) {
  int64_t nt;
  if (const char* e = std::getenv("FLOWCOMPARE_LAZ_THREADS")) {
    nt = std::max<int64_t>(1, std::atoll(e));
  } else {
    unsigned hw = std::thread::hardware_concurrency();
    nt = hw ? hw : 4;
  }
  return std::min<int64_t>(n_chunks, nt);
}

}  // namespace

extern "C" {

// laz_encode's error codes (mirrored in data/laz.py)
const int64_t LAZ_ERR_LAYOUT = -1;
const int64_t LAZ_ERR_CAPACITY = -2;

// Decode all chunks. chunk_starts are byte offsets into src (each the
// position of a chunk's raw first point); chunk_counts the point count per
// chunk. dst receives n_total x point_size raw little-endian records.
// Returns 0 on success, negative error codes otherwise.
int64_t laz_decode(const uint8_t* src, int64_t src_len,
                   const int64_t* chunk_starts, const int64_t* chunk_counts,
                   int64_t n_chunks, const uint16_t* item_types,
                   int32_t n_items, int32_t extra_bytes, uint8_t* dst) {
  ItemLayout lay(item_types, n_items, extra_bytes);
  if (!lay.ok) return -1;
  // chunk output offsets (records are fixed-size, chunks are independent
  // arithmetic streams -> embarrassingly parallel)
  std::vector<int64_t> out_off(n_chunks, 0);
  int64_t acc = 0;
  for (int64_t c = 0; c < n_chunks; c++) {
    out_off[c] = acc;
    acc += (chunk_counts[c] > 0 ? chunk_counts[c] : 0) * lay.point_size;
  }
  std::atomic<int64_t> next(0), err(0);
  auto worker = [&]() {
    for (;;) {
      int64_t c = next.fetch_add(1);
      if (c >= n_chunks || err.load()) return;
      int64_t start = chunk_starts[c];
      int64_t count = chunk_counts[c];
      if (count <= 0) continue;
      if (start < 0 || start + int64_t(lay.point_size) > src_len) {
        err.store(-2);
        return;
      }
      uint8_t* out = dst + out_off[c];
      std::memcpy(out, src + start, lay.point_size);
      Point10v2 p10;
      GpsTime11v2 gps;
      Rgb12v2 rgb;
      Byte2 xb;
      if (lay.has_point10) p10.init(out + lay.off_point10, true);
      if (lay.has_gps) gps.init(out + lay.off_gps, true);
      if (lay.has_rgb) rgb.init(out + lay.off_rgb, true);
      if (lay.n_extra) xb.init(out + lay.off_byte, lay.n_extra, true);
      out += lay.point_size;
      ArDec dec(src + start + lay.point_size, src + src_len);
      dec.init();
      for (int64_t i = 1; i < count; i++) {
        if (lay.has_point10) p10.read(dec, out + lay.off_point10);
        if (lay.has_gps) gps.read(dec, out + lay.off_gps);
        if (lay.has_rgb) rgb.read(dec, out + lay.off_rgb);
        if (lay.n_extra) xb.read(dec, out + lay.off_byte);
        out += lay.point_size;
      }
    }
  };
  int64_t nt = laz_thread_count(n_chunks);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < nt; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

// Encode n_points raw records into chunks of chunk_size points. Writes the
// concatenated chunk streams to dst (capacity dst_cap) and each chunk's
// byte size to chunk_bytes_out (capacity ceil(n_points/chunk_size)).
// Returns total bytes written, LAZ_ERR_LAYOUT when the items do not make up
// point_size, or LAZ_ERR_CAPACITY when dst_cap is too small.
int64_t laz_encode(const uint8_t* src, int64_t n_points, int64_t point_size,
                   const uint16_t* item_types, int32_t n_items,
                   int32_t extra_bytes, int64_t chunk_size, uint8_t* dst,
                   int64_t dst_cap, int64_t* chunk_bytes_out) {
  ItemLayout lay(item_types, n_items, extra_bytes);
  if (!lay.ok || int64_t(lay.point_size) != point_size) return LAZ_ERR_LAYOUT;
  int64_t n_chunks = (n_points + chunk_size - 1) / chunk_size;
  std::vector<std::vector<uint8_t>> bufs(n_chunks);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t c = next.fetch_add(1);
      if (c >= n_chunks) return;
      int64_t p0 = c * chunk_size;
      int64_t count =
          n_points - p0 < chunk_size ? n_points - p0 : chunk_size;
      const uint8_t* rec = src + p0 * point_size;
      Point10v2 p10;
      GpsTime11v2 gps;
      Rgb12v2 rgb;
      Byte2 xb;
      if (lay.has_point10) p10.init(rec + lay.off_point10);
      if (lay.has_gps) gps.init(rec + lay.off_gps);
      if (lay.has_rgb) rgb.init(rec + lay.off_rgb);
      if (lay.n_extra) xb.init(rec + lay.off_byte, lay.n_extra);
      ArEnc enc;
      enc.buf.reserve(size_t(count) * point_size / 2 + 64);
      for (int64_t i = 1; i < count; i++) {
        const uint8_t* r = rec + i * point_size;
        if (lay.has_point10) p10.write(enc, r + lay.off_point10);
        if (lay.has_gps) gps.write(enc, r + lay.off_gps);
        if (lay.has_rgb) rgb.write(enc, r + lay.off_rgb);
        if (lay.n_extra) xb.write(enc, r + lay.off_byte);
      }
      enc.done();
      // raw first point + the chunk's arithmetic stream
      bufs[c].resize(point_size + enc.buf.size());
      std::memcpy(bufs[c].data(), rec, point_size);
      std::memcpy(bufs[c].data() + point_size, enc.buf.data(),
                  enc.buf.size());
    }
  };
  int64_t nt = laz_thread_count(n_chunks);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < nt; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  int64_t total = 0;
  for (int64_t c = 0; c < n_chunks; c++) {
    int64_t nbytes = int64_t(bufs[c].size());
    if (total + nbytes > dst_cap) return LAZ_ERR_CAPACITY;
    std::memcpy(dst + total, bufs[c].data(), nbytes);
    chunk_bytes_out[c] = nbytes;
    total += nbytes;
  }
  return total;
}

// Chunk table payload (after the u32 version / u32 number_chunks header):
// chunk byte-sizes coded with a 32-bit 2-context integer compressor,
// each predicted by the previous (context 1; context 0 is the
// variable-chunk point-count stream, unused for fixed-size chunks).
int64_t laz_decode_chunk_table(const uint8_t* src, int64_t src_len,
                               int64_t n_chunks, int64_t* chunk_bytes_out) {
  ArDec dec(src, src + src_len);
  dec.init();
  IntComp ic;
  ic.init(32, 2, true);
  int32_t prev = 0;
  for (int64_t i = 0; i < n_chunks; i++) {
    int32_t v = ic.decompress(dec, prev, 1);
    chunk_bytes_out[i] = v;
    prev = v;
  }
  return 0;
}

int64_t laz_encode_chunk_table(const int64_t* chunk_bytes, int64_t n_chunks,
                               uint8_t* dst, int64_t dst_cap) {
  ArEnc enc;
  IntComp ic;
  ic.init(32, 2);
  int32_t prev = 0;
  for (int64_t i = 0; i < n_chunks; i++) {
    ic.compress(enc, prev, int32_t(chunk_bytes[i]), 1);
    prev = int32_t(chunk_bytes[i]);
  }
  enc.done();
  if (int64_t(enc.buf.size()) > dst_cap) return -1;
  std::memcpy(dst, enc.buf.data(), enc.buf.size());
  return int64_t(enc.buf.size());
}

}  // extern "C"
