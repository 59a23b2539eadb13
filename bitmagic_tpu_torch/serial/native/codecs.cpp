// Native codec hot loops: Elias gamma + Binary Interpolative Coding.
//
// The serialization codecs are inherently sequential bitstreams; the
// reference implements them as scalar C++ (src/encoding.h — no SIMD BIC in
// bmsse4/bmavx2 either).  This translation unit provides the same
// minimal-binary/BIC/gamma codes as bitmagic_tpu/serial/encoding.py,
// bit-for-bit: MSB-first streams, byte-aligned payload starts.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

namespace {

struct BitW {
    uint8_t* buf;
    size_t byte = 0;
    uint64_t acc = 0;
    int nbits = 0;

    inline void put(uint64_t v, int n) {
        if (n > 32) {           // split: keeps nbits + n within 64 bits
            put(v >> 32, n - 32);
            put(v & 0xFFFFFFFFull, 32);
            return;
        }
        acc = (acc << n) | (v & ((n >= 64) ? ~0ull : ((1ull << n) - 1)));
        nbits += n;
        while (nbits >= 8) {
            nbits -= 8;
            buf[byte++] = static_cast<uint8_t>(acc >> nbits);
        }
    }
    inline uint64_t bit_length() const { return byte * 8 + nbits; }
    inline void flush() {
        if (nbits) {
            buf[byte++] = static_cast<uint8_t>(acc << (8 - nbits));
            nbits = 0;
            acc = 0;
        }
    }
};

// MSB-first reader.  CONTRACT: callers must guarantee 8 readable bytes
// past the last meaningful byte (the Python wrappers pad every buffer) —
// the fast path does one unaligned big-endian 64-bit load per read.
struct BitR {
    const uint8_t* buf;
    uint64_t bitpos;

    inline uint64_t get(int n) {
        if (n <= 0) return 0;
        if (n <= 57) {
            uint64_t w;
            std::memcpy(&w, buf + (bitpos >> 3), 8);
            w = __builtin_bswap64(w);
            int off = static_cast<int>(bitpos & 7);
            bitpos += n;
            return (w << off) >> (64 - n);
        }
        uint64_t hi = get(n - 32);
        return (hi << 32) | get(32);
    }
    inline int get_bit() {
        uint64_t bi = bitpos >> 3;
        int off = static_cast<int>(bitpos & 7);
        ++bitpos;
        return (buf[bi] >> (7 - off)) & 1;
    }
};

inline int bit_length_u64(uint64_t v) {
    return v ? 64 - __builtin_clzll(v) : 0;
}

// minimal binary code of x in [lo, hi] — must match encoding._mb_encode
inline void mb_encode(BitW& w, int64_t x, int64_t lo, int64_t hi) {
    int64_t r = hi - lo + 1;
    if (r <= 1) return;
    int b = bit_length_u64(static_cast<uint64_t>(r - 1));
    int64_t extra = (1ll << b) - r;
    int64_t c = x - lo;
    if (c < extra)
        w.put(static_cast<uint64_t>(c), b - 1);
    else
        w.put(static_cast<uint64_t>(c + extra), b);
}

inline int64_t mb_decode(BitR& rd, int64_t lo, int64_t hi) {
    int64_t r = hi - lo + 1;
    if (r <= 1) return lo;
    int b = bit_length_u64(static_cast<uint64_t>(r - 1));
    int64_t extra = (1ll << b) - r;
    // peek the full b-bit window once (b <= 49 for 48-bit id spaces),
    // then advance by b-1 or b — one load instead of two reads
    uint64_t w;
    std::memcpy(&w, rd.buf + (rd.bitpos >> 3), 8);
    w = __builtin_bswap64(w);
    uint64_t bits = (w << (rd.bitpos & 7)) >> (64 - b);
    int64_t v = static_cast<int64_t>(bits >> 1);
    if (v < extra) {
        rd.bitpos += b - 1;
        return lo + v;
    }
    rd.bitpos += b;
    return lo + static_cast<int64_t>(bits) - extra;
}

struct Frame { int64_t i0, i1, lo, hi; };

}  // namespace

extern "C" {

// BIC-encode a strictly increasing int64 array with values in [lo, hi].
// out must have capacity >= n * 8 + 16 bytes.  Returns total bits written.
uint64_t bm_bic_encode(const int64_t* arr, int64_t n, int64_t lo, int64_t hi,
                       uint8_t* out) {
    BitW w{out};
    // explicit stack identical in traversal order to the Python encoder
    // (push right, then left; pop = left first).  DFS depth is bounded by
    // ~2*log2(n): empty subranges are never pushed.
    Frame stack[192];
    int64_t sp = 0;
    stack[sp++] = {0, n, lo, hi};
    while (sp) {
        Frame f = stack[--sp];
        int64_t cnt = f.i1 - f.i0;
        if (cnt == 0) continue;
        int64_t mid = (f.i0 + f.i1) >> 1;
        int64_t x = arr[mid];
        int64_t nleft = mid - f.i0;
        int64_t nright = f.i1 - mid - 1;
        mb_encode(w, x, f.lo + nleft, f.hi - nright);
        if (mid + 1 < f.i1) stack[sp++] = {mid + 1, f.i1, x + 1, f.hi};
        if (f.i0 < mid) stack[sp++] = {f.i0, mid, f.lo, x - 1};
    }
    uint64_t bits = w.bit_length();
    w.flush();
    return bits;
}

// Inverse; reads from data starting at bit_offset.  Returns new bit offset.
uint64_t bm_bic_decode(const uint8_t* data, uint64_t bit_offset, int64_t n,
                       int64_t lo, int64_t hi, int64_t* out) {
    BitR rd{data, bit_offset};
    Frame stack[192];
    int64_t sp = 0;
    stack[sp++] = {0, n, lo, hi};
    while (sp) {
        Frame f = stack[--sp];
        int64_t cnt = f.i1 - f.i0;
        if (cnt == 0) continue;
        int64_t mid = (f.i0 + f.i1) >> 1;
        int64_t nleft = mid - f.i0;
        int64_t nright = f.i1 - mid - 1;
        int64_t x = mb_decode(rd, f.lo + nleft, f.hi - nright);
        out[mid] = x;
        if (mid + 1 < f.i1) stack[sp++] = {mid + 1, f.i1, x + 1, f.hi};
        if (f.i0 < mid) stack[sp++] = {f.i0, mid, f.lo, x - 1};
    }
    return rd.bitpos;
}

// Elias gamma array encode (values >= 1).  Returns total bits.
uint64_t bm_gamma_encode(const uint64_t* arr, int64_t n, uint8_t* out) {
    BitW w{out};
    for (int64_t i = 0; i < n; ++i) {
        int nb = bit_length_u64(arr[i]);
        w.put(arr[i], 2 * nb - 1);
    }
    uint64_t bits = w.bit_length();
    w.flush();
    return bits;
}

// max_bits bounds every read: a truncated stream returns -1 instead of
// walking past the allocation (the zero padding let the unary-prefix
// loop spin into unmapped heap on adversarial payloads — round-5 fix).
int64_t bm_gamma_decode(const uint8_t* data, uint64_t bit_offset,
                        uint64_t max_bits, int64_t n, uint64_t* out) {
    BitR rd{data, bit_offset};
    for (int64_t i = 0; i < n; ++i) {
        int nz = 0;
        while (rd.bitpos < max_bits && rd.get_bit() == 0) ++nz;
        if (nz > 63 || rd.bitpos + (uint64_t)nz > max_bits) return -1;
        uint64_t rest = nz ? rd.get(nz) : 0;
        out[i] = nz ? ((1ull << nz) | rest) : 1ull;
    }
    return (int64_t)rd.bitpos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// REFERENCE-format bitstreams: LSB-first bits in little-endian 32-bit words
// (bm::bit_in/bit_out, src/encoding.h) with the centered-minimal BIC codes
// (bic_*_cm).  State (byte pos, accumulator, bit count) is passed in/out so
// Python's _BitIn/_BitOut (serial/refcodec.py) can hand the hot inner loops
// to these functions mid-stream and keep going.
// ---------------------------------------------------------------------------

namespace {

struct RBitR {
    const uint8_t* buf;
    int64_t len;
    int64_t pos;     // byte position of the next 32-bit word
    uint64_t acc;    // unread bits, LSB-first
    int nbits;
    int ok = 1;

    inline void pull() {
        if (pos + 4 > len) { ok = 0; nbits += 32; return; }
        uint32_t w;
        memcpy(&w, buf + pos, 4);
        pos += 4;
        acc |= static_cast<uint64_t>(w) << nbits;
        nbits += 32;
    }
    inline uint32_t get_bits(int n) {
        while (nbits < n) pull();
        uint32_t v = static_cast<uint32_t>(
            acc & ((n >= 32) ? 0xFFFFFFFFull : ((1ull << n) - 1)));
        acc >>= n;
        nbits -= n;
        return v;
    }
    inline int get_bit() { return static_cast<int>(get_bits(1)); }
    inline uint32_t gamma() {
        int zeros = 0;
        while (!get_bit()) {
            if (!ok) return 0;
            ++zeros;
        }
        if (zeros > 31) { ok = 0; return 0; }  // u32 gamma bound: an
        // adversarial prefix would hit shift-by->=32 UB and decode
        // silent garbage with ok still set (round-5 fix)
        if (!zeros) return 1;
        return get_bits(zeros) | (1u << zeros);
    }
};

struct RBitW {
    uint8_t* buf;
    int64_t cap;
    int64_t pos = 0;
    uint64_t acc = 0;
    int nbits = 0;
    int ok = 1;

    inline void put_bits(uint64_t v, int n) {
        acc |= (v & ((n >= 64) ? ~0ull : ((1ull << n) - 1)))
               << nbits;
        nbits += n;
        while (nbits >= 32) {
            if (pos + 4 > cap) { ok = 0; return; }
            uint32_t w = static_cast<uint32_t>(acc & 0xFFFFFFFFull);
            memcpy(buf + pos, &w, 4);
            pos += 4;
            acc >>= 32;
            nbits -= 32;
        }
    }
    inline void gamma(uint32_t value) {
        int logv = 31 - __builtin_clz(value);
        put_bits(1ull << logv, logv + 1);     // logv zeros then the 1 bit
        if (logv)
            put_bits(value & ((1u << logv) - 1), logv);
    }
};

struct RFrame { int64_t base, sz, lo, hi; };

// one centered-minimal value read (bit_in::bic_decode_u16_cm inner step)
inline int64_t cm_read(RBitR& r, int64_t range) {
    if (!range) return 0;
    int logv = bit_length_u64(static_cast<uint64_t>(range + 1)) - 1;
    int64_t n_short = (1ll << (logv + 1)) - range - 1;
    int64_t half_short = n_short >> 1;
    int64_t half_rng = range >> 1;
    int64_t flank_lo = half_rng - half_short - ((range + 1) & 1);
    int64_t flank_hi = half_rng + half_short + 1;
    int64_t v = r.get_bits(logv);
    if (v <= flank_lo || v >= flank_hi)
        v += static_cast<int64_t>(r.get_bit()) << logv;
    return v;
}

inline void cm_write(RBitW& w, int64_t value, int64_t range) {
    if (!range) return;
    int64_t n = range + 1;
    int logv = bit_length_u64(static_cast<uint64_t>(n)) - 1;
    int64_t n_short = (1ll << (logv + 1)) - n;
    int64_t half_short = n_short >> 1;
    int64_t half_rng = range >> 1;
    int64_t flank_lo = half_rng - half_short - (n & 1);
    int64_t flank_hi = half_rng + half_short;
    // branchless flank widening: the compare outcome is data-dependent
    // and mispredicts dominate the per-value cost otherwise
    logv += (int)((value <= flank_lo) | (value > flank_hi));
    w.put_bits(static_cast<uint64_t>(value), logv);
}

}  // namespace

extern "C" {

// Decode sz centered-minimal BIC values in (lo..hi) into out (int64).
// State (pos/acc/nbits) is read and written back.  Returns 0, or -1 on
// buffer overrun.
int bmref_bic_decode_cm(const uint8_t* buf, int64_t len, int64_t* pos,
                        uint64_t* acc, int32_t* nbits,
                        int64_t sz, int64_t lo, int64_t hi, int64_t* out) {
    // root range must admit sz strictly-increasing values: sz > hi-lo+1
    // drives the interpolative split into shift-by-64 UB (round-5 fix;
    // attacker-chosen counts reach here via blob record headers)
    if (sz < 0 || hi < lo || sz > hi - lo + 1) return -1;
    // bitstream state in registers (the struct-member version costs ~2x)
    int64_t p = *pos;
    uint64_t a = *acc;
    int nb = *nbits;
    int ok = 1;
    auto refill_to = [&](int n) {
        while (nb < n) {
            if (p + 4 > len) { ok = 0; nb += 32; continue; }
            uint32_t w;
            memcpy(&w, buf + p, 4);
            p += 4;
            a |= static_cast<uint64_t>(w) << nb;
            nb += 32;
        }
    };
    RFrame stack[88];                  // depth <= log2(sz)+1 per side
    int sp = 0;
    stack[sp++] = {0, sz, lo, hi};
    while (sp) {
        RFrame f = stack[--sp];
        while (f.sz) {
            int64_t range = f.hi - f.lo - f.sz + 1;
            int64_t val = range;
            if (range) {
                int logv = bit_length_u64((uint64_t)(range + 1)) - 1;
                int64_t n_short = (1ll << (logv + 1)) - range - 1;
                int64_t half_short = n_short >> 1;
                int64_t half_rng = range >> 1;
                int64_t flank_lo = half_rng - half_short - ((range + 1) & 1);
                int64_t flank_hi = half_rng + half_short + 1;
                // peek value + continuation bit from one accumulator state
                // (logv <= 32 in every stream we parse: u16/u24/u32 ranges;
                // a pull only happens with nb <= 32, so the 64-bit
                // accumulator cannot overflow).  The continuation refill is
                // lazy: demanding it eagerly would overrun streams that end
                // exactly on the value's last bit.
                refill_to(logv);
                val = (int64_t)(a & ((1ull << logv) - 1));
                if (nb > logv) {
                    // branchless continuation (bit already buffered)
                    int64_t need = (int64_t)(val <= flank_lo)
                                 | (int64_t)(val >= flank_hi);
                    val += ((int64_t)((a >> logv) & 1) << logv) & (-need);
                    int sh = logv + (int)need;
                    a >>= sh;
                    nb -= sh;
                } else if (val <= flank_lo || val >= flank_hi) {
                    if (nb < logv + 1)
                        refill_to(logv + 1);
                    val += (int64_t)((a >> logv) & 1) << logv;
                    a >>= logv + 1;
                    nb -= logv + 1;
                } else {
                    a >>= logv;
                    nb -= logv;
                }
            }
            int64_t mid = f.sz >> 1;
            val += f.lo + mid;
            out[f.base + mid] = val;
            if (f.sz <= 1) break;
            // iterate left; push right for later
            stack[sp++] = {f.base + mid + 1, f.sz - mid - 1, val + 1, f.hi};
            f = {f.base, mid, f.lo, val - 1};
        }
        if (!ok) return -1;
    }
    *pos = p; *acc = a; *nbits = nb;
    return 0;
}

// Encode sz strictly-increasing values (int64, within (lo..hi)) as
// centered-minimal BIC.  Whole 32-bit words are written to out; leftover
// bits stay in acc/nbits for the caller to continue the stream.
int bmref_bic_encode_cm(const int64_t* arr, int64_t sz, int64_t lo,
                        int64_t hi, uint64_t* acc, int32_t* nbits,
                        uint8_t* out, int64_t cap, int64_t* written) {
    RBitW w{out, cap};
    w.acc = *acc; w.nbits = *nbits;
    RFrame* stack = new RFrame[2 * 40 + 4];
    int sp = 0;
    stack[sp++] = {0, sz, lo, hi};
    while (sp) {
        RFrame f = stack[--sp];
        while (f.sz) {
            int64_t mid = f.sz >> 1;
            int64_t val = arr[f.base + mid];
            int64_t range = f.hi - f.lo - f.sz + 1;
            cm_write(w, val - f.lo - mid, range);
            if (f.sz <= 1) break;
            stack[sp++] = {f.base + mid + 1, f.sz - mid - 1, val + 1, f.hi};
            f = {f.base, mid, f.lo, val - 1};
        }
        if (!w.ok) { delete[] stack; return -1; }
    }
    *acc = w.acc; *nbits = w.nbits; *written = w.pos;
    delete[] stack;
    return 0;
}

// Set-bit (or clear-bit) positions of a 2048-word block -> u16 list.
// Returns the count.  (Replaces numpy unpackbits+flatnonzero in the
// serializer hot loops.)
int64_t bm_block_positions(const uint32_t* words, int inverted,
                           uint16_t* out) {
    // 64-bit strides with a popcount-driven inner loop: the extraction
    // count is known before the loop, so the only mispredicted branch is
    // the per-word loop exit (vs one mispredict per extracted bit in the
    // naive while(w) form — ~3x on random data)
    int64_t n = 0;
    const uint64_t inv = inverted ? ~0ull : 0ull;
    for (unsigned k = 0; k < 2048; k += 2) {
        uint64_t w;
        memcpy(&w, words + k, 8);
        w ^= inv;
        unsigned base = k << 5;
        for (int i = __builtin_popcountll(w); i; --i) {
            out[n++] = static_cast<uint16_t>(base + __builtin_ctzll(w));
            w &= w - 1;
        }
    }
    return n;
}

// D-GAP boundaries of a block: positions i where bit i != bit i+1, plus the
// final 65535.  *start gets bit 0.  Returns the boundary count.
int64_t bm_block_gap_boundaries(const uint32_t* words, uint16_t* out,
                                int32_t* start) {
    *start = static_cast<int32_t>(words[0] & 1u);
    int64_t n = 0;
    uint64_t prev_top = words[0] & 1u;   // so bit -1 == bit 0 (no change)
    for (unsigned k = 0; k < 2048; k += 2) {
        uint64_t w;
        memcpy(&w, words + k, 8);
        uint64_t x = w ^ ((w << 1) | prev_top);
        prev_top = w >> 63;
        unsigned base = k << 5;
        for (int i = __builtin_popcountll(x); i; --i) {
            // change at bit (base+j) means boundary at (base+j-1)
            out[n++] = static_cast<uint16_t>(base + __builtin_ctzll(x) - 1);
            x &= x - 1;
        }
    }
    out[n++] = 65535;
    return n;
}

// Popcount of a 2048-word block (64-bit strides).
int64_t bm_block_popcount(const uint32_t* words) {
    uint64_t w8[4];
    int64_t n = 0;
    for (unsigned k = 0; k < 2048; k += 8) {
        memcpy(w8, words + k, 32);
        n += __builtin_popcountll(w8[0]) + __builtin_popcountll(w8[1]) +
             __builtin_popcountll(w8[2]) + __builtin_popcountll(w8[3]);
    }
    return n;
}

// Whole-pool set-bit extraction: for each 2048-word row, emit
// bases[row] + in-block offset for every set bit (the enumerator decode
// hot loop; replaces numpy unpackbits over the full pool).
int64_t bm_pool_positions(const uint32_t* pool, int64_t n_rows,
                          const int64_t* bases, int64_t* out) {
    int64_t n = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
        const uint32_t* words = pool + r * 2048;
        int64_t base = bases[r];
        for (unsigned k = 0; k < 2048; ++k) {
            uint32_t w = words[k];
            int64_t wbase = base + (k << 5);
            while (w) {
                out[n++] = wbase + __builtin_ctz(w);
                w &= w - 1;
            }
        }
    }
    return n;
}

// ---------------------------------------------------------------------------
// Whole-BLOB BMT1 decoder: parse every record and materialize dense
// 2048-word rows in one call (replaces the per-block Python decode loop).
// Record: nb u48 LE | code u8 | payload_len u32 LE | payload.
// ---------------------------------------------------------------------------

extern "C" int bmref_bic_decode_cm(const uint8_t*, int64_t, int64_t*,
                                   uint64_t*, int32_t*, int64_t, int64_t,
                                   int64_t, int64_t*);
extern "C" int bmref_bic_encode_cm(const int64_t*, int64_t, int64_t,
                                   int64_t, uint64_t*, int32_t*, uint8_t*,
                                   int64_t, int64_t*);
extern "C" int64_t bm_block_popcount(const uint32_t*);
extern "C" int64_t bm_block_positions(const uint32_t*, int, uint16_t*);
extern "C" int64_t bm_block_gap_boundaries(const uint32_t*, uint16_t*,
                                           int32_t*);

namespace {

inline uint64_t rd48(const uint8_t* p) {
    uint64_t v = 0;
    for (int i = 0; i < 6; ++i) v |= (uint64_t)p[i] << (8 * i);
    return v;
}
inline uint32_t rd32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

enum {
    BMT1_END = 0, BMT1_FULL = 1, BMT1_RAW = 2,
    BMT1_ARR16 = 3, BMT1_ARR16_INV = 4,
    BMT1_ARR_BIC = 5, BMT1_ARR_BIC_INV = 6,
    BMT1_GAP_GAMMA = 7, BMT1_GAP_BIC = 8,
    // N consecutive FULL blocks as ONE record: payload = varint(N).
    // After a run record, prev_nb advances to the run's LAST block, so the
    // next record's delta stays >= 1 (reference multi-scale one-run codes,
    // src/bmserial.h:1183-1199; zero runs are implicit in BMT1 because
    // record block-ids are explicit).
    BMT1_FULL_RUN = 10,   // 9 = group-level XOR_REF (xor_group.py)
};
const uint64_t BMT1_END_NB = (1ull << 48) - 1;
const uint8_t BMT1_FLAG_COMPACT = 2;   // varint record headers

// Returns UINT64_MAX on a malformed varint (>=10 continuation bytes would
// shift past 63 bits — undefined behavior on untrusted blob input).
const uint64_t LEB_BAD = ~0ull;

inline uint64_t rd_leb(const uint8_t* p, int64_t* pos) {
    uint64_t v = 0;
    int sh = 0;
    for (;;) {
        uint8_t b = p[(*pos)++];
        v |= (uint64_t)(b & 0x7F) << sh;
        if (!(b & 0x80)) return v;
        sh += 7;
        if (sh > 63) return LEB_BAD;
    }
}

inline void wr_leb(uint8_t* out, int64_t* pos, uint64_t v) {
    while (v >= 0x80) {
        out[(*pos)++] = (uint8_t)((v & 0x7F) | 0x80);
        v >>= 7;
    }
    out[(*pos)++] = (uint8_t)v;
}

// One record header.  Returns 0 on a normal record, 1 at END, -1 on
// overrun.  Compact form: varint(nb - prev_nb) (>= 1; 0 == END) | code u8
// | varint plen.  Classic form: nb u48 | code u8 | plen u32.
inline int bmt1_read_rec(const uint8_t* blob, int64_t len, int compact,
                         int64_t* pos, int64_t* prev_nb,
                         uint64_t* nb, uint8_t* code, uint32_t* plen) {
    if (compact) {
        if (*pos >= len) return -1;
        uint64_t delta = rd_leb(blob, pos);
        // overrun check BEFORE the END return: a blob truncated on a
        // continuation byte must be an error, not a clean end-of-stream
        if (delta == LEB_BAD || *pos > len) return -1;
        if (delta == 0) return 1;
        // block ids live in [0, 2^48): reject deltas that would wrap or
        // escape the address space (signed-overflow UB + silent
        // row/record misparing downstream — round-5 fix)
        if (delta > (uint64_t)BMT1_END_NB ||
            (uint64_t)*prev_nb + delta >= (uint64_t)BMT1_END_NB)
            return -1;
        *nb = (uint64_t)*prev_nb + delta;
        if (*pos >= len) return -1;
        *code = blob[(*pos)++];
        uint64_t pl = rd_leb(blob, pos);
        if (pl == LEB_BAD || pl > 0xFFFFFFFFull) return -1;
        *plen = (uint32_t)pl;
        if (*pos > len) return -1;
        *prev_nb = (int64_t)*nb;
        return 0;
    }
    if (*pos + 11 > len) return -1;
    *nb = rd48(blob + *pos);
    *code = blob[*pos + 6];
    *plen = rd32(blob + *pos + 7);
    *pos += 11;
    if (*code == BMT1_END && *nb == BMT1_END_NB) return 1;
    // records must be strictly ascending (writers emit sorted ids);
    // accepting disorder would pair decoders' rows with wrong records
    if ((int64_t)*nb <= *prev_nb || *nb >= (uint64_t)BMT1_END_NB)
        return -1;
    *prev_nb = (int64_t)*nb;
    return 0;
}

inline int bmt1_is_compact(const uint8_t* blob, int64_t len) {
    return len > 4 && (blob[4] & BMT1_FLAG_COMPACT);
}

// Parse a FULL_RUN payload (varint span >= 1) and advance *prev_nb to the
// run's LAST block (the delta base of the following record).  Returns the
// span, or 0 on malformed input.
inline uint64_t bmt1_run_span(const uint8_t* blob, int64_t pos, int64_t len,
                              uint32_t plen, uint64_t nb, int64_t* prev_nb) {
    if (plen < 1 || pos + (int64_t)plen > len) return 0;
    int64_t p = pos;
    uint64_t span = rd_leb(blob, &p);
    if (span == LEB_BAD || span == 0 || p > pos + (int64_t)plen) return 0;
    if (span > (uint64_t)BMT1_END_NB - nb) return 0;   // no u64 wrap
    *prev_nb = (int64_t)(nb + span - 1);
    return span;
}

inline void set_bit_blk(uint32_t* w, uint32_t pos) {
    w[pos >> 5] |= 1u << (pos & 31);
}

inline void fill_runs(uint32_t* w, int first_val, const int64_t* bounds,
                      int64_t n_bounds) {
    // run i covers (prev, bounds[i]] with value first_val ^ (i & 1)
    int64_t prev = -1;
    int val = first_val;
    for (int64_t i = 0; i < n_bounds; ++i) {
        if (val) {
            for (int64_t b = prev + 1; b <= bounds[i]; ++b)
                set_bit_blk(w, (uint32_t)b);
        }
        prev = bounds[i];
        val ^= 1;
    }
}

// decode one BMT1 payload into a zeroed 2048-word row; returns 0/-1

// Fused variant of bmref_bic_decode_cm: sets decoded values directly as
// bits of a 2048-word block (bic_decode_u16_bitset analog, src/encoding.h)
// — skips the intermediate int64 position array on the BMT1 hot path.
static int bic_decode_cm_bitset(const uint8_t* buf, int64_t len,
                                int64_t sz, int64_t lo, int64_t hi,
                                uint32_t* w) {
    int64_t p = 0;
    uint64_t a = 0;
    int nb = 0;
    int ok = 1;
    auto refill_to = [&](int n) {
        while (nb < n) {
            if (p + 4 > len) { ok = 0; nb += 32; continue; }
            uint32_t x;
            memcpy(&x, buf + p, 4);
            p += 4;
            a |= static_cast<uint64_t>(x) << nb;
            nb += 32;
        }
    };
    RFrame stack[88];
    int sp = 0;
    stack[sp++] = {0, sz, lo, hi};
    while (sp) {
        RFrame f = stack[--sp];
        while (f.sz) {
            int64_t range = f.hi - f.lo - f.sz + 1;
            int64_t val = range;
            if (range) {
                int logv = bit_length_u64((uint64_t)(range + 1)) - 1;
                int64_t n_short = (1ll << (logv + 1)) - range - 1;
                int64_t half_short = n_short >> 1;
                int64_t half_rng = range >> 1;
                int64_t flank_lo = half_rng - half_short - ((range + 1) & 1);
                int64_t flank_hi = half_rng + half_short + 1;
                refill_to(logv);
                val = (int64_t)(a & ((1ull << logv) - 1));
                if (nb > logv) {
                    // branchless continuation-bit path: the extra bit is
                    // already in the accumulator, so the (data-dependent,
                    // poorly predicted) range test costs no branch
                    int64_t need = (int64_t)(val <= flank_lo) | (int64_t)(val >= flank_hi);
                    val += ((int64_t)((a >> logv) & 1) << logv) & (-need);
                    int sh = logv + (int)need;
                    a >>= sh;
                    nb -= sh;
                } else if (val <= flank_lo || val >= flank_hi) {
                    if (nb < logv + 1)
                        refill_to(logv + 1);
                    val += (int64_t)((a >> logv) & 1) << logv;
                    a >>= logv + 1;
                    nb -= logv + 1;
                } else {
                    a >>= logv;
                    nb -= logv;
                }
            }
            int64_t mid = f.sz >> 1;
            val += f.lo + mid;
            w[(uint32_t)val >> 5] |= 1u << (val & 31);
            if (f.sz <= 1) break;
            stack[sp++] = {f.base + mid + 1, f.sz - mid - 1, val + 1, f.hi};
            f = {f.base, mid, f.lo, val - 1};
        }
        if (!ok) return -1;
    }
    return 0;
}

// Leading gamma of a GAP_GAMMA payload = run count; shared by the dense
// decoder, the GAP-direct decoder, and the gap-aware scan so the three
// untrusted-input parsers cannot drift (round-5 dedup).  Returns the run
// count (1..65536) and leaves *rd positioned after the header, or -1.
inline int64_t bmt1_gamma_runcount(BitR* rd, uint64_t max_bits) {
    int nz = 0;
    while (rd->bitpos < max_bits && rd->get_bit() == 0) ++nz;
    if (nz > 17 || rd->bitpos + (uint64_t)nz > max_bits) return -1;
    uint64_t n_runs = nz ? ((1ull << nz) | rd->get(nz)) : 1;
    if (n_runs > 65536) return -1;
    return (int64_t)n_runs;
}

int bmt1_payload(int code, const uint8_t* p, int64_t plen, uint32_t* w,
                 int64_t* scratch) {
    switch (code) {
    case BMT1_RAW:
        if (plen < 8192) return -1;
        memcpy(w, p, 8192);
        return 0;
    case BMT1_ARR16:
    case BMT1_ARR16_INV: {
        if (plen < 4) return -1;
        uint32_t n = rd32(p);
        if (n > 65536 || 4 + 2ull * n > (uint64_t)plen) return -1;
        const uint8_t* q = p + 4;
        for (uint32_t i = 0; i < n; ++i) {
            uint16_t pos;
            memcpy(&pos, q + 2 * i, 2);
            set_bit_blk(w, pos);
        }
        if (code == BMT1_ARR16_INV)
            for (int k = 0; k < 2048; ++k) w[k] = ~w[k];
        return 0;
    }
    case BMT1_ARR_BIC:
    case BMT1_ARR_BIC_INV: {
        if (plen < 4) return -1;
        uint32_t n = rd32(p);
        if (n > 65536) return -1;
        if (n && bic_decode_cm_bitset(p + 4, plen - 4, n, 0, 65535, w))
            return -1;
        if (code == BMT1_ARR_BIC_INV)
            for (int k = 0; k < 2048; ++k) w[k] = ~w[k];
        return 0;
    }
    case BMT1_GAP_GAMMA: {
        if (plen < 1) return -1;
        if (p[0] > 1) return -1;
        int first = p[0];
        // MSB-first gamma stream: first value = run count, then run lens.
        // All reads and run ends are bounds-checked: corrupted payloads
        // must fail, not write past the block or read past the payload.
        BitR rd{p + 1, 0};
        const uint64_t max_bits = (uint64_t)(plen - 1) * 8;
        int64_t n_runs = bmt1_gamma_runcount(&rd, max_bits);
        if (n_runs < 0) return -1;
        int64_t prev = -1;
        int val = first;
        for (int64_t i = 0; i < n_runs; ++i) {
            int z = 0;
            while (rd.bitpos < max_bits && rd.get_bit() == 0) ++z;
            if (z > 17 || rd.bitpos + z > max_bits) return -1;
            uint64_t run = z ? ((1ull << z) | rd.get(z)) : 1;
            int64_t end = prev + (int64_t)run;
            if (end > 65535) return -1;
            if (val)
                for (int64_t b = prev + 1; b <= end; ++b)
                    set_bit_blk(w, (uint32_t)b);
            prev = end;
            val ^= 1;
        }
        if (prev != 65535) return -1;   // runs must cover the block —
        // same rule as bmt1_gap_ends, so the dense and GAP-direct
        // decoders agree on which records are valid
        return 0;
    }
    case BMT1_GAP_BIC: {
        if (plen < 5) return -1;
        if (p[0] > 1) return -1;
        int first = p[0];
        uint32_t n = rd32(p + 1);
        if (n > 65535) return -1;
        int64_t pos = 0; uint64_t acc = 0; int32_t nb = 0;
        if (n) {
            int rc = bmref_bic_decode_cm(p + 5, plen - 5, &pos, &acc, &nb,
                                         n, 0, 65534, scratch);
            if (rc) return -1;
        }
        scratch[n] = 65535;
        fill_runs(w, first, scratch, n + 1);
        return 0;
    }
    default:
        return -1;
    }
}

// Decode a GAP record's run ENDS into scratch (ascending, last = 65535)
// WITHOUT expanding to a dense block.  Returns the number of ends, or -1
// on a malformed payload.  *first gets the value of the first run.
int64_t bmt1_gap_ends(int code, const uint8_t* p, int64_t plen,
                      int64_t* scratch, int* first) {
    if (code == BMT1_GAP_BIC) {
        if (plen < 5) return -1;
        if (p[0] > 1) return -1;          // first-run value must be 0/1
        *first = p[0];
        uint32_t n = rd32(p + 1);
        if (n > 65535) return -1;
        int64_t pos = 0; uint64_t acc = 0; int32_t nb = 0;
        if (n && bmref_bic_decode_cm(p + 5, plen - 5, &pos, &acc, &nb,
                                     n, 0, 65534, scratch))
            return -1;
        scratch[n] = 65535;
        return (int64_t)n + 1;
    }
    if (code != BMT1_GAP_GAMMA || plen < 1) return -1;
    if (p[0] > 1) return -1;              // first-run value must be 0/1
    *first = p[0];
    BitR rd{p + 1, 0};
    const uint64_t max_bits = (uint64_t)(plen - 1) * 8;
    int64_t n_runs = bmt1_gamma_runcount(&rd, max_bits);
    if (n_runs < 0) return -1;
    int64_t prev = -1;
    for (int64_t i = 0; i < n_runs; ++i) {
        int z = 0;
        while (rd.bitpos < max_bits && rd.get_bit() == 0) ++z;
        if (z > 17 || rd.bitpos + z > max_bits) return -1;
        uint64_t run = z ? ((1ull << z) | rd.get(z)) : 1;
        int64_t end = prev + (int64_t)run;
        if (end > 65535) return -1;
        scratch[i] = end;
        prev = end;
    }
    if (prev != 65535) return -1;         // D-GAP runs must cover the block
    return (int64_t)n_runs;
}

// Masked popcount of target bits [a, b] within one 2048-word block row.
int64_t count_bits_range(const uint32_t* w, int32_t a, int32_t b) {
    int32_t wa = a >> 5, wb = b >> 5;
    uint32_t ma = ~0u << (a & 31);
    uint32_t mb = ((b & 31) == 31) ? ~0u : ((1u << ((b & 31) + 1)) - 1);
    if (wa == wb)
        return __builtin_popcount(w[wa] & ma & mb);
    int64_t c = __builtin_popcount(w[wa] & ma)
              + __builtin_popcount(w[wb] & mb);
    for (int32_t k = wa + 1; k < wb; ++k)
        c += __builtin_popcount(w[k]);
    return c;
}

// Fused single-pass block analysis for the encoder: D-GAP boundaries +
// popcount + the exact Elias-gamma cost of the run-length list (sans the
// length header), all from ONE 8 KB read — the encoder previously paid
// three full-block scans (popcount, boundaries, positions) per block.
int64_t block_scan_fused(const uint32_t* words, uint16_t* out,
                         int32_t* start, int64_t* popcnt,
                         int64_t* gamma_bits) {
    *start = static_cast<int32_t>(words[0] & 1u);
    int64_t n = 0, bc = 0, gbits = 0;
    int32_t prev = -1;
    uint64_t prev_top = words[0] & 1u;   // so bit -1 == bit 0 (no change)
    for (unsigned k = 0; k < 2048; k += 2) {
        uint64_t w;
        memcpy(&w, words + k, 8);
        bc += __builtin_popcountll(w);
        uint64_t x = w ^ ((w << 1) | prev_top);
        prev_top = w >> 63;
        unsigned base = k << 5;
        for (int i = __builtin_popcountll(x); i; --i) {
            // change at bit (base+j) means boundary at (base+j-1)
            int32_t b = static_cast<int32_t>(base + __builtin_ctzll(x)) - 1;
            x &= x - 1;
            out[n++] = static_cast<uint16_t>(b);
            gbits += 2 * bit_length_u64(static_cast<uint64_t>(b - prev)) - 1;
            prev = b;
        }
    }
    out[n++] = 65535;
    gbits += 2 * bit_length_u64(static_cast<uint64_t>(65535 - prev)) - 1;
    *popcnt = bc;
    *gamma_bits = gbits;
    return n;
}

// Set-bit (want=1) or clear-bit (want=0) positions reconstructed from the
// run boundaries — O(runs + emitted) with no second block read.
int64_t positions_from_runs(const uint16_t* bnd, int64_t L, int32_t start,
                            int want, uint16_t* out) {
    int64_t n = 0;
    int32_t prev = -1;
    for (int64_t i = 0; i < L; ++i) {
        int32_t hi = bnd[i];
        if ((start ^ static_cast<int32_t>(i & 1)) == want)
            for (int32_t p = prev + 1; p <= hi; ++p)
                out[n++] = static_cast<uint16_t>(p);
        prev = hi;
    }
    return n;
}

}  // namespace

extern "C" {

static int64_t gap_ones(const int32_t* ends, int64_t n, int first);
static void gap_expand_dense(const int32_t* ends, int64_t n, int first,
                             uint32_t* out);

// Whole-BLOB BMT1 encoder: mirror of serializer.Serializer._encode_block
// (size-estimate chooser + payload emitters).  words holds the CLS_BIT rows
// in nb order; cls uses the package codes (1=FULL, 2=BIT, 3=GAP).
// spans[rec] > 1 (FULL entries only) emits ONE FULL_RUN record covering
// that many blocks.  cls==3 records encode STRAIGHT from the succinct
// D-GAP store layout (g_ends/g_offs/g_first, same convention as
// bm_bmt1_stream_op targets): boundaries, popcount and gamma cost derive
// from the run list, so a GAP-resident vector serializes with O(1-block)
// dense scratch (the reference's gamma_gap_block encodes the gap buffer
// directly, src/bmserial.h:1960).  Bytes are identical to the dense path.
// prev_nb_in / emit_end let the Python driver stitch segments (it may
// interleave its own records); pass -1 / 1 for a whole blob.  Returns bytes
// written, or -1 on overflow.  code_counts[11] accumulates the per-code
// histogram for compression_stat.
int64_t bm_bmt1_encode(const uint32_t* words, const int64_t* nbs,
                       const uint8_t* cls, const int64_t* spans,
                       const int32_t* g_ends, const int64_t* g_offs,
                       const uint8_t* g_first,
                       int64_t n_rec, int level,
                       int64_t prev_nb_in, int emit_end,
                       uint8_t* out, int64_t cap, int64_t* code_counts) {
    int64_t pos = 0;
    int64_t row = 0;
    int64_t grec = 0;                     // index among cls==3 records
    int64_t prev_nb = prev_nb_in;         // compact records delta-code nb
    const int64_t PCAP = 1 << 18;         // payload scratch (BIC worst case)
    uint16_t* pos_buf = new uint16_t[65536];
    uint16_t* bnd_buf = new uint16_t[65537];
    int64_t* arr64 = new int64_t[65537];
    uint32_t* gam = new uint32_t[65537];
    uint8_t* pbuf = new uint8_t[PCAP];
    uint32_t* gexp = new uint32_t[2048];  // GAP->dense scratch (RAW only)

    // payload writers target the scratch buffer: the compact header's
    // varint length precedes the payload, so it must be known first
    int64_t wpos = 0;
    auto pput8 = [&](uint8_t v) { pbuf[wpos++] = v; };
    auto pput32 = [&](uint32_t v) { memcpy(pbuf + wpos, &v, 4); wpos += 4; };
    auto fail = [&]() {
        delete[] pos_buf; delete[] bnd_buf; delete[] arr64; delete[] gam;
        delete[] pbuf; delete[] gexp;
        return (int64_t)-1;
    };
    auto emit = [&](uint64_t nb, uint8_t code) {
        // header: varint(delta) | code | varint(plen), then the payload
        wr_leb(out, &pos, nb - (uint64_t)prev_nb);
        out[pos++] = code;
        wr_leb(out, &pos, (uint64_t)wpos);
        memcpy(out + pos, pbuf, wpos);
        pos += wpos;
        prev_nb = (int64_t)nb;
        wpos = 0;
    };

    for (int64_t rec = 0; rec < n_rec; ++rec) {
        if (pos + 16 + 8192 + 64 > cap) return fail();
        if (cls[rec] == 1) {                       // FULL
            int64_t span = spans ? spans[rec] : 1;
            if (span > 1) {
                wr_leb(pbuf, &wpos, (uint64_t)span);
                emit((uint64_t)nbs[rec], BMT1_FULL_RUN);
                prev_nb = nbs[rec] + span - 1;     // delta base = run end
                ++code_counts[BMT1_FULL_RUN];
            } else {
                emit((uint64_t)nbs[rec], BMT1_FULL);
                ++code_counts[BMT1_FULL];
            }
            continue;
        }
        const uint32_t* w = nullptr;
        int32_t start = 0;
        int64_t bc = 0, run_gamma_bits = 0, L = 0;
        if (cls[rec] == 3) {                       // GAP: straight from runs
            int64_t k = grec++;
            const int32_t* ge = g_ends + g_offs[k];
            int64_t n = g_offs[k + 1] - g_offs[k];
            start = g_first[k];
            int64_t prevb = -1;
            for (int64_t i = 0; i < n; ++i) {
                bnd_buf[i] = (uint16_t)ge[i];
                run_gamma_bits +=
                    2 * bit_length_u64((uint64_t)(ge[i] - prevb)) - 1;
                prevb = ge[i];
            }
            L = n;
            bc = gap_ones(ge, n, start);
        } else {
            w = words + (row++) * 2048;
            L = block_scan_fused(w, bnd_buf, &start, &bc,
                                 &run_gamma_bits);  // incl. final 65535
        }
        if (bc == 0)
            continue;                              // zero: implicit
        if (bc == 65536) {
            emit((uint64_t)nbs[rec], BMT1_FULL);
            ++code_counts[BMT1_FULL];
            continue;
        }
        int64_t ibc = 65536 - bc;

        // size-estimate chooser (same model as the Python serializer)
        int best_code = BMT1_RAW;
        int64_t best = 1 + 4 * 2048;
        auto consider = [&](int64_t est, int code) {
            if (est < best) { best = est; best_code = code; }
        };
        if (level >= 1) {
            if (bc < 65536) consider(3 + 2 * bc, BMT1_ARR16);
            if (ibc < 65536) consider(3 + 2 * ibc, BMT1_ARR16_INV);
        }
        if (level >= 4 && L < 16384) {
            // exact gamma cost: per-run bits from the fused scan + the
            // gamma-coded length header
            int64_t gamma_bits =
                run_gamma_bits + 2 * bit_length_u64((uint64_t)L) - 1;
            consider(2 + (gamma_bits + 7) / 8, BMT1_GAP_GAMMA);
        }
        if (level >= 5) {
            if (bc > 0 && bc <= 16384)
                consider((bc * 30) / 64 + 5, BMT1_ARR_BIC);
            if (ibc > 0 && ibc <= 16384)
                consider((ibc * 30) / 64 + 5, BMT1_ARR_BIC_INV);
            if (L < 16384)
                consider((L * 30) / 64 + 6, BMT1_GAP_BIC);
        }
        if (level >= 6) {
            // L6 admits denser arrays at the reference's 2.2 bits/int
            // BIC coefficient (src/bmserial.h:546); integer math keeps the
            // chooser byte-identical with the Python serializer
            if (bc > 16384 && bc <= 29789)
                consider((bc * 22) / 80 + 5, BMT1_ARR_BIC);
            if (ibc > 16384 && ibc <= 29789)
                consider((ibc * 22) / 80 + 5, BMT1_ARR_BIC_INV);
        }

        ++code_counts[best_code];

        switch (best_code) {
        case BMT1_RAW:
            if (!w) {                              // GAP record chose RAW
                int64_t k = grec - 1;
                gap_expand_dense(g_ends + g_offs[k],
                                 g_offs[k + 1] - g_offs[k],
                                 (int)g_first[k], gexp);
                w = gexp;
            }
            memcpy(pbuf + wpos, w, 8192); wpos += 8192;
            break;
        case BMT1_ARR16:
        case BMT1_ARR16_INV: {
            int inv = best_code == BMT1_ARR16_INV;
            int64_t n = positions_from_runs(bnd_buf, L, start, !inv,
                                            pos_buf);
            pput32((uint32_t)n);
            memcpy(pbuf + wpos, pos_buf, 2 * n); wpos += 2 * n;
            break;
        }
        case BMT1_ARR_BIC:
        case BMT1_ARR_BIC_INV: {
            int inv = best_code == BMT1_ARR_BIC_INV;
            int64_t n = positions_from_runs(bnd_buf, L, start, !inv,
                                            pos_buf);
            pput32((uint32_t)n);
            for (int64_t i = 0; i < n; ++i) arr64[i] = pos_buf[i];
            uint64_t acc = 0; int32_t nb2 = 0; int64_t written = 0;
            if (bmref_bic_encode_cm(arr64, n, 0, 65535, &acc, &nb2,
                                    pbuf + wpos, PCAP - wpos, &written))
                return fail();
            wpos += written;
            if (nb2) {                              // flush leftover bits
                uint32_t tail = (uint32_t)acc;
                memcpy(pbuf + wpos, &tail, 4); wpos += 4;
            }
            break;
        }
        case BMT1_GAP_GAMMA: {
            pput8((uint8_t)start);
            BitW bw{pbuf + wpos};
            uint32_t v = (uint32_t)L;
            bw.put(v, 2 * bit_length_u64(v) - 1);
            int64_t prev = -1;
            for (int64_t i = 0; i < L; ++i) {
                uint32_t run = (uint32_t)(bnd_buf[i] - prev);
                prev = bnd_buf[i];
                bw.put(run, 2 * bit_length_u64(run) - 1);
            }
            bw.flush();
            wpos += (int64_t)bw.byte;
            break;
        }
        case BMT1_GAP_BIC: {
            pput8((uint8_t)start);
            int64_t n = L - 1;                      // final 65535 implied
            pput32((uint32_t)n);
            for (int64_t i = 0; i < n; ++i) arr64[i] = bnd_buf[i];
            uint64_t acc = 0; int32_t nb2 = 0; int64_t written = 0;
            if (bmref_bic_encode_cm(arr64, n, 0, 65534, &acc, &nb2,
                                    pbuf + wpos, PCAP - wpos, &written))
                return fail();
            wpos += written;
            if (nb2) {
                uint32_t tail = (uint32_t)acc;
                memcpy(pbuf + wpos, &tail, 4); wpos += 4;
            }
            break;
        }
        }
        if (pos + 16 + wpos > cap) return fail();
        emit((uint64_t)nbs[rec], (uint8_t)best_code);
    }
    // END trailer: a single zero delta byte (suppressed for segment calls)
    if (emit_end)
        out[pos++] = 0;
    delete[] pos_buf; delete[] bnd_buf; delete[] arr64; delete[] gam;
    delete[] pbuf; delete[] gexp;
    return pos;
}

// Pass 1: count records and BIT rows.  Returns 0, or -1 on malformed input.
int bm_bmt1_scan(const uint8_t* blob, int64_t len, int64_t rec_offset,
                 int64_t* n_records, int64_t* n_rows) {
    int64_t pos = rec_offset, recs = 0, rows = 0, prev = -1;
    int compact = bmt1_is_compact(blob, len);
    for (;;) {
        uint64_t nb;
        uint8_t code;
        uint32_t plen;
        int r = bmt1_read_rec(blob, len, compact, &pos, &prev,
                              &nb, &code, &plen);
        if (r < 0) return -1;
        if (r == 1) {
            *n_records = recs;
            *n_rows = rows;
            return 0;
        }
        if (code == BMT1_FULL_RUN) {
            if (!bmt1_run_span(blob, pos, len, plen, nb, &prev)) return -1;
        }
        pos += plen;
        if (pos > len) return -1;
        ++recs;
        if (code != BMT1_FULL && code != BMT1_FULL_RUN) ++rows;
    }
}

// Pass 2: decode every record.  nbs[n_records], cls[n_records],
// spans[n_records] (1 for plain records, run length for FULL_RUN),
// words[n_rows][2048] (rows in record order for non-FULL records).
int bm_bmt1_decode(const uint8_t* blob, int64_t len, int64_t rec_offset,
                   int64_t* nbs, uint8_t* cls, int64_t* spans,
                   uint32_t* words) {
    int64_t pos = rec_offset, rec = 0, row = 0, prev = -1;
    int compact = bmt1_is_compact(blob, len);
    int64_t* scratch = new int64_t[65537];
    for (;;) {
        uint64_t nb;
        uint8_t code;
        uint32_t plen;
        int r = bmt1_read_rec(blob, len, compact, &pos, &prev,
                              &nb, &code, &plen);
        if (r < 0) { delete[] scratch; return -1; }
        if (r == 1) {
            delete[] scratch;
            return 0;
        }
        if (pos + plen > len) { delete[] scratch; return -1; }
        nbs[rec] = (int64_t)nb;
        spans[rec] = 1;
        if (code == BMT1_FULL_RUN) {
            uint64_t span = bmt1_run_span(blob, pos, len, plen, nb, &prev);
            if (!span) { delete[] scratch; return -1; }
            cls[rec] = 1;                       // CLS_FULL (span-coded)
            spans[rec] = (int64_t)span;
        } else if (code == BMT1_FULL) {
            cls[rec] = 1;                       // CLS_FULL
        } else {
            cls[rec] = 2;                       // CLS_BIT
            uint32_t* w = words + row * 2048;
            memset(w, 0, 8192);
            if (bmt1_payload(code, blob + pos, plen, w, scratch)) {
                delete[] scratch;
                return -1;
            }
            ++row;
        }
        pos += plen;
        ++rec;
    }
}

// GAP-aware scan: like bm_bmt1_scan, but D-GAP records are sized
// separately (they decode to run lists, not dense rows).  n_rows counts
// only dense payload rows; n_gap_ends sums run counts (read from the
// record headers — one u32 for BIC, the leading gamma for GAMMA — no
// payload decode).
int bm_bmt1_scan_gap(const uint8_t* blob, int64_t len, int64_t rec_offset,
                     int64_t* n_records, int64_t* n_rows,
                     int64_t* n_gap_records, int64_t* n_gap_ends) {
    int64_t pos = rec_offset, recs = 0, rows = 0, gr = 0, ge = 0, prev = -1;
    int compact = bmt1_is_compact(blob, len);
    for (;;) {
        uint64_t nb;
        uint8_t code;
        uint32_t plen;
        int r = bmt1_read_rec(blob, len, compact, &pos, &prev,
                              &nb, &code, &plen);
        if (r < 0) return -1;
        if (r == 1) {
            *n_records = recs;
            *n_rows = rows;
            *n_gap_records = gr;
            *n_gap_ends = ge;
            return 0;
        }
        if (code == BMT1_FULL_RUN) {
            if (!bmt1_run_span(blob, pos, len, plen, nb, &prev)) return -1;
        }
        if (pos + plen > len) return -1;
        if (code == BMT1_GAP_BIC) {
            if (plen < 5) return -1;
            uint32_t n = rd32(blob + pos + 1);
            if (n > 65535) return -1;
            ++gr;
            ge += (int64_t)n + 1;
        } else if (code == BMT1_GAP_GAMMA) {
            if (plen < 1) return -1;
            BitR rd{blob + pos + 1, 0};
            int64_t n_runs = bmt1_gamma_runcount(
                &rd, (uint64_t)(plen - 1) * 8);
            if (n_runs < 0) return -1;
            ++gr;
            ge += n_runs;
        } else if (code != BMT1_FULL && code != BMT1_FULL_RUN) {
            ++rows;
        }
        pos += plen;
        ++recs;
    }
}

// GAP-direct decode: D-GAP records KEEP their run form — cls 3, run ends
// appended to g_ends (block-local inclusive int32, last = 65535) with
// g_offs prefix offsets (n_gap_records + 1 entries) and g_first value
// bits — the decode-side analog of the GAP-direct serializer: a
// GAP-heavy corpus deserializes straight into succinct residency with
// ZERO dense expansion (the reference likewise deserializes gap blocks
// as gap blocks, src/bmserial.h read_gap_block).
int bm_bmt1_decode_gap(const uint8_t* blob, int64_t len, int64_t rec_offset,
                       int64_t* nbs, uint8_t* cls, int64_t* spans,
                       uint32_t* words, int32_t* g_ends, int64_t* g_offs,
                       uint8_t* g_first) {
    int64_t pos = rec_offset, rec = 0, row = 0, prev = -1, gr = 0, ge = 0;
    int compact = bmt1_is_compact(blob, len);
    int64_t* scratch = new int64_t[65537];
    g_offs[0] = 0;
    for (;;) {
        uint64_t nb;
        uint8_t code;
        uint32_t plen;
        int r = bmt1_read_rec(blob, len, compact, &pos, &prev,
                              &nb, &code, &plen);
        if (r < 0) { delete[] scratch; return -1; }
        if (r == 1) {
            delete[] scratch;
            return 0;
        }
        if (pos + plen > len) { delete[] scratch; return -1; }
        nbs[rec] = (int64_t)nb;
        spans[rec] = 1;
        if (code == BMT1_FULL_RUN) {
            uint64_t span = bmt1_run_span(blob, pos, len, plen, nb, &prev);
            if (!span) { delete[] scratch; return -1; }
            cls[rec] = 1;                       // CLS_FULL (span-coded)
            spans[rec] = (int64_t)span;
        } else if (code == BMT1_FULL) {
            cls[rec] = 1;                       // CLS_FULL
        } else if (code == BMT1_GAP_GAMMA || code == BMT1_GAP_BIC) {
            int first = 0;
            int64_t n = bmt1_gap_ends(code, blob + pos, plen, scratch,
                                      &first);
            if (n < 0) { delete[] scratch; return -1; }
            for (int64_t i = 0; i < n; ++i)
                g_ends[ge + i] = (int32_t)scratch[i];
            ge += n;
            g_first[gr] = (uint8_t)first;
            g_offs[++gr] = ge;
            cls[rec] = 3;                       // CLS_GAP
        } else {
            cls[rec] = 2;                       // CLS_BIT
            uint32_t* w = words + row * 2048;
            memset(w, 0, 8192);
            if (bmt1_payload(code, blob + pos, plen, w, scratch)) {
                delete[] scratch;
                return -1;
            }
            ++row;
        }
        pos += plen;
        ++rec;
    }
}

}  // extern "C"

// Decode n Elias-gamma values (reference LSB-first stream) into out.
int bmref_gamma_decode(const uint8_t* buf, int64_t len, int64_t* pos,
                       uint64_t* acc, int32_t* nbits,
                       int64_t n, uint32_t* out) {
    RBitR r{buf, len, *pos, *acc, *nbits};
    for (int64_t i = 0; i < n; ++i) {
        out[i] = r.gamma();
        if (!r.ok) return -1;
    }
    *pos = r.pos; *acc = r.acc; *nbits = r.nbits;
    return 0;
}

// Encode n Elias-gamma values (each >= 1).
int bmref_gamma_encode(const uint32_t* arr, int64_t n,
                       uint64_t* acc, int32_t* nbits,
                       uint8_t* out, int64_t cap, int64_t* written) {
    RBitW w{out, cap};
    w.acc = *acc; w.nbits = *nbits;
    for (int64_t i = 0; i < n; ++i) {
        w.gamma(arr[i]);
        if (!w.ok) return -1;
    }
    *acc = w.acc; *nbits = w.nbits; *written = w.pos;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GAP-store expansion + streamed BLOB set-ops (operation_deserializer core).
// ---------------------------------------------------------------------------

namespace {

// set bits [a, b] inclusive within a 2048-word block (word-level fill)
inline void fill_span_blk(uint32_t* w, int64_t a, int64_t b) {
    int64_t wa = a >> 5, wb = b >> 5;
    uint32_t ma = ~0u << (a & 31);
    uint32_t mb = ((b & 31) == 31) ? ~0u : ((1u << ((b & 31) + 1)) - 1u);
    if (wa == wb) { w[wa] |= ma & mb; return; }
    w[wa] |= ma;
    w[wb] |= mb;
    if (wb > wa + 1) memset(w + wa + 1, 0xFF, (size_t)(wb - wa - 1) * 4);
}

}  // namespace

extern "C" {

// Expand m D-GAP blocks (concatenated run-end layout of core/gapstore.py)
// into dense 2048-word rows.  ends: inclusive run ends per block (ascending,
// final 65535); offs[m+1]; first[m] = value of run 0.  out must be zeroed
// (m * 2048 words).  Returns 0.
int bm_gaps_to_dense(const int64_t* ends, const int64_t* offs,
                     const uint8_t* first, int64_t m, uint32_t* out) {
    for (int64_t k = 0; k < m; ++k) {
        uint32_t* w = out + k * 2048;
        int64_t prev = -1;
        int val = first[k];
        for (int64_t r = offs[k]; r < offs[k + 1]; ++r) {
            int64_t e = ends[r];
            if (val && e >= prev + 1)
                fill_span_blk(w, prev + 1, e);
            prev = e;
            val ^= 1;
        }
    }
    return 0;
}

// Streamed set-op between a target bvector snapshot and a BMT1 BLOB —
// bm::operation_deserializer core (src/bmserial.h:1006): block records are
// processed one at a time with O(1 block) scratch; payloads that cannot
// affect the result are skipped without decoding (record lengths play the
// reference's bookmark role).
//
// op: 0 AND, 1 OR, 2 XOR, 3 SUB_AB (t & ~blob), 4 SUB_BA (blob & ~t).
// count_mode: 1 -> only *count_out is produced (sum of per-block result
// popcounts over blob records), no rows are written.
// Target snapshot: t_nbs sorted; t_cls 1=FULL 2=row 3=D-GAP runs; t_slot is
// a row index into t_words for cls==2, a block index into
// t_gap_offs/t_gap_first for cls==3 (run ends in t_gap_ends[offs[k]..offs[k+1])).
// Run-coded targets fold in the run domain for COUNT_* shortcuts and expand
// into O(1-block) scratch only for record shapes that need a dense combine.
// Result (count_mode=0): per-record outputs in blob order; out_cls 1=FULL,
// 2=row (row appended to out_words).  Blocks of the target that the BLOB
// does not mention are NOT emitted here — the caller merges them per op.
// Returns 0, or -1 on malformed input.
// Per-record header index: out_nbs/out_offs sized >= the record count from
// bm_bmt1_scan.  Returns the record count, or -1 on a malformed stream.
int64_t bm_bmt1_record_index(const uint8_t* blob, int64_t len,
                             int64_t rec_offset,
                             int64_t* out_nbs, int64_t* out_offs) {
    int64_t pos = rec_offset, recs = 0, prev = -1;
    int compact = bmt1_is_compact(blob, len);
    for (;;) {
        uint64_t nb;
        uint8_t code;
        uint32_t plen;
        int64_t rec_at = pos;
        int r = bmt1_read_rec(blob, len, compact, &pos, &prev,
                              &nb, &code, &plen);
        if (r < 0) return -1;
        if (r == 1) return recs;
        if (code == BMT1_FULL_RUN) {
            if (!bmt1_run_span(blob, pos, len, plen, nb, &prev)) return -1;
        }
        out_nbs[recs] = (int64_t)nb;
        out_offs[recs] = rec_at;
        pos += plen;
        if (pos > len) return -1;
        ++recs;
    }
}

// --- run-coded (D-GAP) target-block helpers ------------------------------
// A target block may arrive as alternating-run ends (block-local, last end
// 65535, first run's value in `first`) instead of a dense row, so succinct
// targets never expand outside O(1-block) scratch (reference keeps GAP
// blocks compressed through operation_deserializer too, src/bmserial.h:1006).

static int64_t gap_ones(const int32_t* ends, int64_t n, int first) {
    int64_t c = 0, prev = -1;
    int val = first;
    for (int64_t i = 0; i < n; ++i) {
        if (val) c += ends[i] - prev;
        prev = ends[i]; val ^= 1;
    }
    return c;
}

// AND-popcount of two run-coded blocks (record runs int64, target int32)
static int64_t gap_run_overlap(const int64_t* ae, int64_t an, int af,
                               const int32_t* be, int64_t bn, int bf) {
    int64_t c = 0, i = 0, j = 0, at = 0;
    int av = af, bv = bf;
    while (i < an && j < bn) {
        int64_t ea = ae[i], eb = (int64_t)be[j];
        int64_t e = ea < eb ? ea : eb;
        if (av & bv) c += e - at + 1;
        at = e + 1;
        if (ea == e) { ++i; av ^= 1; }
        if (eb == e) { ++j; bv ^= 1; }
    }
    return c;
}

// expand one run-coded block into a dense row (word-level span fills)
static void gap_expand_dense(const int32_t* ends, int64_t n, int first,
                             uint32_t* out) {
    memset(out, 0, 8192);
    int64_t prev = -1;
    int val = first;
    for (int64_t i = 0; i < n; ++i) {
        if (val) {
            int64_t lo = prev + 1, hi = ends[i];
            int64_t wl = lo >> 5, wh = hi >> 5;
            uint32_t ml = ~0u << (lo & 31);
            uint32_t mh = ~0u >> (31 - (hi & 31));
            if (wl == wh) out[wl] |= ml & mh;
            else {
                out[wl] |= ml;
                for (int64_t w = wl + 1; w < wh; ++w) out[w] = ~0u;
                out[wh] |= mh;
            }
        }
        prev = ends[i]; val ^= 1;
    }
}

int bm_bmt1_stream_op(const uint8_t* blob, int64_t len, int64_t off,
                      int64_t max_rec, int64_t nb_prev,
                      int op, int count_mode,
                      const int64_t* t_nbs, const uint8_t* t_cls,
                      const int64_t* t_slot, const uint32_t* t_words,
                      const int32_t* t_gap_ends, const int64_t* t_gap_offs,
                      const uint8_t* t_gap_first,
                      int64_t nt,
                      int64_t* out_nbs, uint8_t* out_cls,
                      uint32_t* out_words,
                      int64_t* out_nrec, int64_t* out_nrows,
                      int64_t* count_out) {
    int64_t pos = off, nrec = 0, nrows = 0;
    int64_t count = 0;
    int64_t prev = nb_prev;   // nb of the record before the window (-1 at
                              // stream start; compact nbs are delta-coded)
    int compact = bmt1_is_compact(blob, len);
    int64_t* scratch = new int64_t[65537];
    uint32_t* bw = new uint32_t[2048];
    uint32_t* bw2 = new uint32_t[2048];   // run-coded target expansion row
    // max_rec > 0: stop (successfully) after that many records — the
    // chunked driver in opdeser.py restricts the target view to each
    // chunk's blocks so host high-water stays O(chunk), not O(target)
    while (max_rec <= 0 || nrec < max_rec) {
        uint64_t nb;
        uint8_t code;
        uint32_t plen;
        int r = bmt1_read_rec(blob, len, compact, &pos, &prev,
                              &nb, &code, &plen);
        if (r < 0) break;
        if (r == 1) {
            delete[] scratch; delete[] bw; delete[] bw2;
            if (out_nrec) *out_nrec = nrec;
            if (out_nrows) *out_nrows = nrows;
            if (count_out) *count_out = count;
            return 0;
        }
        if (pos + plen > len) { delete[] scratch; delete[] bw; delete[] bw2; return -1; }
        if (code == BMT1_FULL_RUN) {
            // run-coded blobs route to decode-then-apply: runs decode to
            // O(1) interval metadata, set-mode outputs here are per-record
            // arrays, and the count-mode pass-through accounting upstream
            // assumes single-block mentions — signal the driver
            delete[] scratch; delete[] bw; delete[] bw2;
            return -2;
        }
        // locate target block state: 0 absent, 1 FULL, 2 row, 3 runs
        int tstate = 0;
        const uint32_t* tw = nullptr;
        const int32_t* g_ends = nullptr;
        int64_t g_n = 0;
        int g_first = 0;
        {
            int64_t lo = 0, hi = nt;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if ((uint64_t)t_nbs[mid] < nb) lo = mid + 1; else hi = mid;
            }
            if (lo < nt && (uint64_t)t_nbs[lo] == nb) {
                tstate = t_cls[lo];
                if (tstate == 2) tw = t_words + t_slot[lo] * 2048;
                else if (tstate == 3) {
                    int64_t k = t_slot[lo];
                    g_ends = t_gap_ends + t_gap_offs[k];
                    g_n = t_gap_offs[k + 1] - t_gap_offs[k];
                    g_first = t_gap_first[k];
                }
            }
        }
        int rec_full = (code == BMT1_FULL);
        // payload-skip fast paths (no decode, no output / symbolic output)
        bool skip = false;
        int emit_full = 0;            // 1 -> emit FULL (or count 65536)
        switch (op) {
        case 0:  // AND
            if (tstate == 0) skip = true;
            else if (tstate == 1 && rec_full) emit_full = 1;
            break;
        case 1:  // OR
            if (tstate == 1 || rec_full) emit_full = 1;
            break;
        case 2:  // XOR
            if (rec_full && tstate == 0) emit_full = 1;
            else if (rec_full && tstate == 1) skip = true;   // -> zero
            break;
        case 3:  // SUB_AB: t & ~blob
            if (tstate == 0 || rec_full) skip = true;        // -> zero/absent
            break;
        case 4:  // SUB_BA: blob & ~t
            if (tstate == 1) skip = true;                    // -> zero
            else if (rec_full && tstate == 0) emit_full = 1;
            break;
        }
        if (skip) { pos += plen; ++nrec; continue; }
        if (emit_full) {
            if (count_mode) count += 65536;
            else {
                out_nbs[nrec] = (int64_t)nb;
                out_cls[nrec] = 1;
            }
            pos += plen; ++nrec; continue;
        }
        // count-mode shortcut for array records: every COUNT_* answer is
        // an arithmetic function of (n, target popcount, overlap c at the
        // decoded positions) — no 8 KB dense expansion, no combine pass.
        // Symbolic targets resolve without decoding positions at all.
        if (count_mode && !rec_full &&
            (code == BMT1_ARR16 || code == BMT1_ARR_BIC) && plen >= 4) {
            uint32_t n = rd32(blob + pos);
            if (n <= 65536) {
                if (tstate == 0 || tstate == 1) {
                    // symbolic target: FULL (ops 0/2/3 reach here) or
                    // absent (ops 1/2/4) — OR+absent emits the record's
                    // own bits: count += n, same as XOR+absent
                    if (tstate == 1)
                        count += (op == 0) ? n : 65536 - n;  // AND / XOR,SUB_AB
                    else
                        count += n;                           // OR, XOR, SUB_BA
                    pos += plen; ++nrec; continue;
                }
                int decoded = 0;
                if (code == BMT1_ARR16) {
                    if (4 + 2ull * n <= (uint64_t)plen) {
                        const uint8_t* q = blob + pos + 4;
                        for (uint32_t i = 0; i < n; ++i) {
                            uint16_t pp;
                            memcpy(&pp, q + 2 * i, 2);
                            scratch[i] = pp;
                        }
                        decoded = 1;
                    }
                } else {
                    int64_t bpos = 0; uint64_t acc = 0; int32_t nb2 = 0;
                    decoded = (n == 0) ||
                        !bmref_bic_decode_cm(blob + pos + 4, plen - 4,
                                             &bpos, &acc, &nb2, n,
                                             0, 65535, scratch);
                }
                if (decoded) {
                    if (tstate == 3) {
                        // run-coded target: one O(1-block) scratch
                        // expansion, then the same branchless bit tests
                        // (a position-vs-runs merge walk measured slower:
                        // data-dependent branches per run)
                        gap_expand_dense(g_ends, g_n, g_first, bw2);
                        tw = bw2;
                    }
                    int64_t c = 0;
                    for (uint32_t i = 0; i < n; ++i) {
                        uint32_t pp = (uint32_t)scratch[i];
                        c += (tw[pp >> 5] >> (pp & 31)) & 1u;
                    }
                    int64_t pc_t = !(op == 1 || op == 2 || op == 3) ? 0
                                   : (tstate == 3
                                      ? gap_ones(g_ends, g_n, g_first)
                                      : bm_block_popcount(tw));
                    switch (op) {
                    case 0: count += c; break;                  // AND
                    case 1: count += pc_t + n - c; break;       // OR
                    case 2: count += pc_t + n - 2 * c; break;   // XOR
                    case 3: count += pc_t - c; break;           // SUB_AB
                    default: count += (int64_t)n - c; break;    // SUB_BA
                    }
                    pos += plen; ++nrec; continue;
                }
                // malformed payload: fall through to the dense path,
                // which reports the error
            }
        }
        // same shortcut for GAP records: decode run ENDS only, then count
        // in the run domain (masked range popcounts over the target row)
        if (count_mode && !rec_full &&
            (code == BMT1_GAP_GAMMA || code == BMT1_GAP_BIC)) {
            int first = 0;
            int64_t n_ends = bmt1_gap_ends(code, blob + pos, plen,
                                           scratch, &first);
            if (n_ends > 0) {
                int64_t nset = 0, c = 0;
                int64_t prev = -1;
                int val = first;
                for (int64_t i = 0; i < n_ends; ++i) {
                    int64_t e = scratch[i];
                    if (val) {
                        nset += e - prev;
                        if (tstate == 2)
                            c += count_bits_range(tw, (int32_t)(prev + 1),
                                                  (int32_t)e);
                    }
                    prev = e;
                    val ^= 1;
                }
                if (tstate == 3)         // run-vs-run overlap popcount
                    c = gap_run_overlap(scratch, n_ends, first,
                                        g_ends, g_n, g_first);
                if (tstate == 0 || tstate == 1) {
                    count += (tstate == 1)
                             ? ((op == 0) ? nset : 65536 - nset)
                             : nset;
                } else {
                    int64_t pc_t = !(op == 1 || op == 2 || op == 3) ? 0
                                   : (tstate == 3
                                      ? gap_ones(g_ends, g_n, g_first)
                                      : bm_block_popcount(tw));
                    switch (op) {
                    case 0: count += c; break;
                    case 1: count += pc_t + nset - c; break;
                    case 2: count += pc_t + nset - 2 * c; break;
                    case 3: count += pc_t - c; break;
                    default: count += nset - c; break;
                    }
                }
                pos += plen; ++nrec; continue;
            }
        }
        // count-mode shortcut for FULL records: only AND/XOR/SUB_BA reach
        // here with rec_full (the skip/emit_full table resolves the rest),
        // and each is pure arithmetic on the target popcount — no dense
        // expansion needed for either dense or run-coded targets
        if (count_mode && rec_full && (tstate == 2 || tstate == 3)) {
            int64_t pc_t = (tstate == 3) ? gap_ones(g_ends, g_n, g_first)
                                         : bm_block_popcount(tw);
            switch (op) {
            case 0: count += pc_t; break;            // AND: t & FULL
            case 2: count += 65536 - pc_t; break;    // XOR: ~t
            default: count += 65536 - pc_t; break;   // SUB_BA: FULL & ~t
            }
            pos += plen; ++nrec; continue;
        }
        // remaining shapes combine densely: expand a run-coded target
        // block into the O(1-block) scratch row first
        if (tstate == 3) {
            gap_expand_dense(g_ends, g_n, g_first, bw2);
            tw = bw2;
            tstate = 2;
        }
        // decode the record payload (dense) unless the record is FULL
        const uint32_t* bp;
        if (rec_full) {
            bp = nullptr;             // virtual all-ones
        } else {
            memset(bw, 0, 8192);
            if (bmt1_payload(code, blob + pos, plen, bw, scratch)) {
                delete[] scratch; delete[] bw; delete[] bw2; return -1;
            }
            bp = bw;
        }
        // combine into the output row (or popcount); 64-bit strides with
        // the op switch hoisted out of the word loop
        uint32_t* ow = count_mode ? bw : out_words + nrows * 2048;
        uint64_t pc = 0;
        {
            uint64_t tb[2], bb[2];
            const uint64_t ones2[2] = {~0ull, ~0ull};
            const uint64_t zero2[2] = {0, 0};
            for (int k = 0; k < 2048; k += 4) {
                if (bp) memcpy(bb, bp + k, 16); else memcpy(bb, ones2, 16);
                if (tstate == 2) memcpy(tb, tw + k, 16);
                else memcpy(tb, tstate == 1 ? ones2 : zero2, 16);
                uint64_t r0, r1;
                switch (op) {
                case 0: r0 = tb[0] & bb[0]; r1 = tb[1] & bb[1]; break;
                case 1: r0 = tb[0] | bb[0]; r1 = tb[1] | bb[1]; break;
                case 2: r0 = tb[0] ^ bb[0]; r1 = tb[1] ^ bb[1]; break;
                case 3: r0 = tb[0] & ~bb[0]; r1 = tb[1] & ~bb[1]; break;
                default: r0 = bb[0] & ~tb[0]; r1 = bb[1] & ~tb[1]; break;
                }
                if (count_mode) {
                    pc += __builtin_popcountll(r0) + __builtin_popcountll(r1);
                } else {
                    memcpy(ow + k, &r0, 8);
                    memcpy(ow + k + 2, &r1, 8);
                }
            }
        }
        if (count_mode) count += (int64_t)pc;
        else {
            out_nbs[nrec] = (int64_t)nb;
            out_cls[nrec] = 2;
            ++nrows;
        }
        pos += plen;
        ++nrec;
    }
    delete[] scratch; delete[] bw; delete[] bw2;
    if (max_rec > 0 && nrec >= max_rec) {   // chunk boundary: success
        if (out_nrec) *out_nrec = nrec;
        if (out_nrows) *out_nrows = nrows;
        if (count_out) *count_out = count;
        return 0;
    }
    return -1;
}

}  // extern "C"
