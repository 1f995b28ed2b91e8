// Zstandard frame decoder (RFC 8878) for supercompressed KTX2 levels.
//
// Every KTX2 texture of the reference's data directory is
// Zstandard-supercompressed (supercompressionScheme 2). The port reads them
// with this decoder, so it needs no zstd package on any machine.
//
// Built on demand by tpurast_torch/assets/zstd.py into tpurast_torch/_build/:
//   g++ -O3 -shared -fPIC -std=c++17 -o libtpurast_torch_zstd_<hash>.so zstd.cpp
//
// Decodes: frame headers (window descriptor, single-segment flag, content
// size fields; a dictionary id other than 0 is refused), raw / RLE /
// compressed blocks of at most 128 KiB, literals sections (raw, RLE,
// Huffman with 1 or 4 streams, treeless reuse of the previous table;
// weights FSE-compressed or direct), sequences sections (predefined, RLE,
// FSE and repeat modes; the three repeat offsets), the XXH64 content
// checksum, concatenated frames and skippable frames. A frame without a
// content size decodes into the caller's capacity.
//
// Every read of the input and every write of the output is bounds-checked:
// truncated, corrupt or oversized input returns a negative error code
// (zstd_error_name gives its name), never reads or writes out of bounds.

#include <cstdint>
#include <cstring>
#include <new>

// A failed check returns its error code from the enclosing function: every
// function that can fail returns int64_t, negative on failure, and TRY
// passes a failure up. (No C++ exceptions: Python calls the library through
// ctypes.)
#define NEED(ok, code)                         \
    do {                                       \
        if (!(ok)) return int64_t(code);       \
    } while (0)
#define TRY(expr)                              \
    do {                                       \
        const int64_t tr_status_ = (expr);     \
        if (tr_status_ < 0) return tr_status_; \
    } while (0)

namespace {

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "the bit readers load little-endian words");

enum : int64_t {
    kErrTruncated = -1,
    kErrMagic = -2,
    kErrReserved = -3,
    kErrDictionary = -4,
    kErrWindow = -5,
    kErrBlockSize = -6,
    kErrDstTooSmall = -7,
    kErrLiterals = -8,
    kErrHuffman = -9,
    kErrFse = -10,
    kErrSequences = -11,
    kErrOffset = -12,
    kErrChecksum = -13,
    kErrContentSize = -14,
    kErrNoTable = -15,
    kErrMemory = -16,
};

const char* error_name(int64_t code) {
    switch (code) {
        case kErrTruncated: return "truncated input";
        case kErrMagic: return "not a zstd frame (bad magic number)";
        case kErrReserved: return "reserved bit or block type set";
        case kErrDictionary: return "frame needs a dictionary";
        case kErrWindow: return "window size out of range";
        case kErrBlockSize: return "block larger than 128 KiB";
        case kErrDstTooSmall: return "output larger than the capacity";
        case kErrLiterals: return "corrupt literals section";
        case kErrHuffman: return "corrupt Huffman table or stream";
        case kErrFse: return "corrupt FSE table";
        case kErrSequences: return "corrupt sequences section";
        case kErrOffset: return "match offset before the frame's start";
        case kErrChecksum: return "content checksum mismatch";
        case kErrContentSize: return "decoded size differs from the frame content size";
        case kErrNoTable: return "repeat mode without a previous table";
        case kErrMemory: return "out of memory";
        default: return "unknown error";
    }
}

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

inline uint64_t read_le(const uint8_t* p, int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
    return v;
}

// Bits [start, start + n) of a little-endian bit string of size bytes,
// start + n <= 8 * size, n <= 32.
inline uint32_t bits_at(const uint8_t* s, size_t size, int64_t start, int n) {
    size_t byte = size_t(start >> 3);
    size_t avail = size - byte;
    uint64_t w = 0;
    std::memcpy(&w, s + byte, avail < 8 ? avail : 8);
    return uint32_t((w >> (start & 7)) & ((uint64_t(1) << n) - 1));
}

// Forward bit reader (FSE table descriptions): bits are taken from the
// least significant end of each byte, reads past the end give zeros and
// the caller checks consumed() against the size.
struct FwdBits {
    const uint8_t* s;
    size_t size;
    int64_t pos = 0;
    uint32_t peek(int n) const {
        int64_t total = int64_t(size) * 8;
        if (pos >= total) return 0;
        int take = pos + n <= total ? n : int(total - pos);
        return bits_at(s, size, pos, take);
    }
    uint32_t read(int n) {
        uint32_t v = peek(n);
        pos += n;
        return v;
    }
    size_t consumed() const { return size_t((pos + 7) >> 3); }
};

// Backward bit reader (Huffman streams, FSE streams): the stream ends with
// a padding bit (the highest set bit of its last byte); reading starts
// just below it and moves toward the first byte, each read taking the
// highest unread bits. pos is the count of unread bits; past the start it
// goes negative and the bits read there are zeros.
struct BackBits {
    const uint8_t* s = nullptr;
    size_t size = 0;
    int64_t pos = 0;
    int64_t init(const uint8_t* src, size_t n, int64_t code) {
        NEED(n > 0 && src[n - 1] != 0, code);
        s = src;
        size = n;
        pos = int64_t(n - 1) * 8 + highbit(src[n - 1]);
        return 0;
    }
    uint32_t peek(int n) const {
        if (n == 0 || pos <= 0) return 0;
        if (pos >= n) return bits_at(s, size, pos - n, n);
        return bits_at(s, size, 0, int(pos)) << (n - pos);
    }
    uint32_t read(int n) {
        uint32_t v = peek(n);
        pos -= n;
        return v;
    }
};

// ---------------------------------------------------------------- FSE

constexpr int kFseMaxLog = 9;

struct FseEntry {
    uint16_t symbol;
    uint8_t nbits;
    uint16_t base;
};

struct FseTable {
    int log = 0;
    bool valid = false;
    FseEntry t[1 << kFseMaxLog];
};

// Normalized counts of an FSE table description (RFC 8878 4.1.1).
// Returns the bytes read; norm[0..*nsym) hold the counts (-1: "less
// than one").
int64_t read_ncount(const uint8_t* src, size_t n, int max_symbol, int max_log, int16_t* norm, int* nsym,
                   int* log) {
    FwdBits b{src, n};
    int table_log = int(b.read(4)) + 5;
    NEED(table_log <= max_log, kErrFse);
    std::memset(norm, 0, sizeof(int16_t) * (max_symbol + 1));
    int remaining = (1 << table_log) + 1;
    int threshold = 1 << table_log;
    int nbits = table_log + 1;
    int symbol = 0;
    bool previous0 = false;
    while (remaining > 1 && symbol <= max_symbol) {
        if (previous0) {
            for (;;) {
                uint32_t repeat = b.read(2);
                symbol += int(repeat);
                if (repeat != 3) break;
            }
            if (symbol > max_symbol) break;
        }
        int max = (2 * threshold - 1) - remaining;
        int count;
        uint32_t v = b.peek(nbits);
        if (int(v & uint32_t(threshold - 1)) < max) {
            count = int(v & uint32_t(threshold - 1));
            b.pos += nbits - 1;
        } else {
            count = int(v & uint32_t(2 * threshold - 1));
            if (count >= threshold) count -= max;
            b.pos += nbits;
        }
        count -= 1;
        remaining -= count < 0 ? -count : count;
        norm[symbol++] = int16_t(count);
        previous0 = count == 0;
        while (remaining < threshold) {
            nbits -= 1;
            threshold >>= 1;
        }
    }
    NEED(remaining == 1 && symbol <= max_symbol + 1 && symbol > 0, kErrFse);
    size_t used = b.consumed();
    NEED(used <= n, kErrTruncated);
    *nsym = symbol;
    *log = table_log;
    return int64_t(used);
}

int64_t build_fse(const int16_t* norm, int nsym, int log, FseTable& f) {
    const int size = 1 << log;
    int high = size - 1;
    uint16_t next[256];
    for (int s = 0; s < nsym; ++s) {
        if (norm[s] == -1) {
            NEED(high >= 0, kErrFse);
            f.t[high--].symbol = uint16_t(s);
            next[s] = 1;
        } else {
            next[s] = uint16_t(norm[s]);
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3;
    const int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            f.t[pos].symbol = uint16_t(s);
            do {
                pos = (pos + step) & mask;
            } while (pos > high);
        }
    }
    NEED(pos == 0, kErrFse);
    for (int u = 0; u < size; ++u) {
        int s = f.t[u].symbol;
        uint32_t x = next[s]++;
        int nb = log - highbit(x);
        f.t[u].nbits = uint8_t(nb);
        f.t[u].base = uint16_t((x << nb) - uint32_t(size));
    }
    f.log = log;
    f.valid = true;
    return 0;
}

void rle_fse(int symbol, FseTable& f) {
    f.t[0] = FseEntry{uint16_t(symbol), 0, 0};
    f.log = 0;
    f.valid = true;
}

struct FseState {
    const FseTable* f;
    uint32_t state;
    void init(BackBits& b) { state = b.read(f->log); }
    int symbol() const { return f->t[state].symbol; }
    void update(BackBits& b) {
        const FseEntry& e = f->t[state];
        state = e.base + b.read(e.nbits);
    }
};

// ---------------------------------------------------------------- Huffman

constexpr int kHufMaxBits = 11;

struct HufTable {
    int max_bits = 0;
    bool valid = false;
    uint8_t symbol[1 << kHufMaxBits];
    uint8_t nbits[1 << kHufMaxBits];
};

// Huffman tree description (RFC 8878 4.2.1); returns the bytes read.
int64_t read_huffman(const uint8_t* src, size_t n, HufTable& h) {
    NEED(n >= 1, kErrTruncated);
    uint8_t weight[256];
    int nw = 0;
    size_t used;
    const int header = src[0];
    if (header >= 128) {
        nw = header - 127;
        used = 1 + size_t((nw + 1) / 2);
        NEED(used <= n, kErrTruncated);
        for (int i = 0; i < nw; ++i) {
            uint8_t byte = src[1 + i / 2];
            weight[i] = (i & 1) ? (byte & 15) : (byte >> 4);
        }
    } else {
        NEED(header > 0, kErrHuffman);
        used = 1 + size_t(header);
        NEED(used <= n, kErrTruncated);
        int16_t norm[256];
        int nsym, log;
        static thread_local FseTable table;
        const int64_t head = read_ncount(src + 1, header, 255, 6, norm, &nsym, &log);
        TRY(head);
        TRY(build_fse(norm, nsym, log, table));
        BackBits b;
        TRY(b.init(src + 1 + head, header - size_t(head), kErrHuffman));
        FseState s1{&table, 0}, s2{&table, 0};
        s1.init(b);
        s2.init(b);
        // Two interleaved states; when an update reads past the stream's
        // start, the other state gives the last weight.
        for (;;) {
            NEED(nw < 254, kErrHuffman);
            weight[nw++] = uint8_t(s1.symbol());
            s1.update(b);
            if (b.pos < 0) {
                weight[nw++] = uint8_t(s2.symbol());
                break;
            }
            weight[nw++] = uint8_t(s2.symbol());
            s2.update(b);
            if (b.pos < 0) {
                weight[nw++] = uint8_t(s1.symbol());
                break;
            }
        }
    }
    uint32_t total = 0;
    int rank[kHufMaxBits + 2] = {0};
    for (int i = 0; i < nw; ++i) {
        NEED(weight[i] <= kHufMaxBits, kErrHuffman);
        if (weight[i]) total += 1u << (weight[i] - 1);
        rank[weight[i]]++;
    }
    NEED(total > 0, kErrHuffman);
    const int max_bits = highbit(total) + 1;
    NEED(max_bits <= kHufMaxBits, kErrHuffman);
    const uint32_t rest = (1u << max_bits) - total;
    NEED((rest & (rest - 1)) == 0, kErrHuffman);
    const int last = highbit(rest) + 1;
    NEED(nw < 256, kErrHuffman);
    weight[nw++] = uint8_t(last);
    rank[last]++;
    NEED(rank[1] >= 2 && !(rank[1] & 1), kErrHuffman);
    // Codes run from the lowest weight (the longest codes) up, symbols in
    // order within a weight; each takes 2^(weight-1) table entries.
    uint32_t pos = 0;
    for (int w = 1; w <= max_bits; ++w) {
        for (int s = 0; s < nw; ++s) {
            if (weight[s] != w) continue;
            uint32_t len = 1u << (w - 1);
            std::memset(h.symbol + pos, s, len);
            std::memset(h.nbits + pos, max_bits + 1 - w, len);
            pos += len;
        }
    }
    NEED(pos == (1u << max_bits), kErrHuffman);
    h.max_bits = max_bits;
    h.valid = true;
    return int64_t(used);
}

int64_t decode_huffman_stream(const HufTable& h, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
    BackBits b;
    TRY(b.init(src, n, kErrHuffman));
    for (size_t i = 0; i < count; ++i) {
        uint32_t v = b.peek(h.max_bits);
        out[i] = h.symbol[v];
        b.pos -= h.nbits[v];
        NEED(b.pos >= 0, kErrHuffman);
    }
    NEED(b.pos == 0, kErrHuffman);
    return 0;
}

// ---------------------------------------------------------------- sequences

enum { LL = 0, OF = 1, ML = 2 };

constexpr int kMaxSymbol[3] = {35, 31, 52};
constexpr int kMaxLog[3] = {9, 8, 9};
constexpr int kPredefinedLog[3] = {6, 5, 6};
constexpr int16_t kPredefinedLL[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kPredefinedOF[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
constexpr int16_t kPredefinedML[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};

constexpr uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,   12,   13,   14,   15,   16,    18,
                                  20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,   17,   18,    19,    20,
                                  21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,   35,   37,    39,    41,
                                  43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  0, 0,
                                 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// Decoding state that lives for one frame: the tables a later block may
// repeat, the repeat offsets and the literals buffer.
struct Frame {
    FseTable fse[3];
    FseTable predefined[3];
    HufTable huf;
    uint32_t rep[3];
    uint8_t literals[kBlockMax];

    Frame() {
        const int16_t* norm[3] = {kPredefinedLL, kPredefinedOF, kPredefinedML};
        const int nsym[3] = {36, 29, 53};
        for (int k = 0; k < 3; ++k) build_fse(norm[k], nsym[k], kPredefinedLog[k], predefined[k]);  // valid tables
    }
    void reset() {
        for (auto& f : fse) f.valid = false;
        huf.valid = false;
        rep[0] = 1;
        rep[1] = 4;
        rep[2] = 8;
    }
};

struct Out {
    uint8_t* dst;
    size_t cap;
    size_t pos;
    size_t frame_start;
};

// Literals section (RFC 8878 3.1.1.3.1); returns its size in bytes.
int64_t decode_literals(const uint8_t* src, size_t n, Frame& fr, const uint8_t** lit, size_t* lit_size) {
    NEED(n >= 1, kErrTruncated);
    const int type = src[0] & 3;
    const int format = (src[0] >> 2) & 3;
    if (type <= 1) {  // raw or RLE
        size_t head, regen;
        if ((format & 1) == 0) {
            head = 1;
            regen = src[0] >> 3;
        } else if (format == 1) {
            head = 2;
            NEED(n >= 2, kErrTruncated);
            regen = (src[0] >> 4) + (size_t(src[1]) << 4);
        } else {
            head = 3;
            NEED(n >= 3, kErrTruncated);
            regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
        }
        NEED(regen <= kBlockMax, kErrLiterals);
        *lit_size = regen;
        if (type == 0) {
            NEED(head + regen <= n, kErrTruncated);
            *lit = src + head;
            return int64_t(head + regen);
        }
        NEED(head + 1 <= n, kErrTruncated);
        std::memset(fr.literals, src[head], regen);
        *lit = fr.literals;
        return int64_t(head + 1);
    }
    // Huffman-compressed (2) or treeless (3).
    static const int kHead[4] = {3, 3, 4, 5};
    static const int kBits[4] = {10, 10, 14, 18};
    const size_t head = size_t(kHead[format]);
    const int bits = kBits[format];
    NEED(n >= head, kErrTruncated);
    const uint64_t h = read_le(src, int(head));
    const uint64_t mask = (uint64_t(1) << bits) - 1;
    const size_t regen = size_t((h >> 4) & mask);
    const size_t csize = size_t((h >> (4 + bits)) & mask);
    NEED(regen <= kBlockMax, kErrLiterals);
    NEED(head + csize <= n, kErrTruncated);
    const uint8_t* p = src + head;
    size_t rest = csize;
    if (type == 2) {
        const int64_t used = read_huffman(p, rest, fr.huf);
        TRY(used);
        p += used;
        rest -= size_t(used);
    } else {
        NEED(fr.huf.valid, kErrNoTable);
    }
    if (format == 0) {
        TRY(decode_huffman_stream(fr.huf, p, rest, fr.literals, regen));
    } else {
        NEED(rest >= 10 && regen >= 6, kErrLiterals);
        size_t sizes[4];
        size_t sum = 0;
        for (int i = 0; i < 3; ++i) {
            sizes[i] = size_t(read_le(p + 2 * i, 2));
            sum += sizes[i];
        }
        NEED(6 + sum < rest, kErrLiterals);
        sizes[3] = rest - 6 - sum;
        const size_t seg = (regen + 3) / 4;
        const uint8_t* s = p + 6;
        for (int i = 0; i < 4; ++i) {
            size_t count = i < 3 ? seg : regen - 3 * seg;
            TRY(decode_huffman_stream(fr.huf, s, sizes[i], fr.literals + i * seg, count));
            s += sizes[i];
        }
    }
    *lit = fr.literals;
    *lit_size = regen;
    return int64_t(head + csize);
}

int64_t copy_literals(Out& o, const uint8_t* lit, size_t n) {
    NEED(n <= o.cap - o.pos, kErrDstTooSmall);
    std::memcpy(o.dst + o.pos, lit, n);
    o.pos += n;
    return 0;
}

// Sequences section (RFC 8878 3.1.1.3.2) and its execution.
int64_t decode_sequences(const uint8_t* src, size_t n, Frame& fr, const uint8_t* lit, size_t lit_size, Out& o) {
    NEED(n >= 1, kErrTruncated);
    size_t p = 1;
    size_t nseq = src[0];
    if (nseq == 0) {
        NEED(n == 1, kErrSequences);
        return copy_literals(o, lit, lit_size);
    }
    if (nseq >= 128 && nseq < 255) {
        NEED(n >= 2, kErrTruncated);
        nseq = ((nseq - 128) << 8) + src[1];
        p = 2;
    } else if (nseq == 255) {
        NEED(n >= 3, kErrTruncated);
        nseq = src[1] + (size_t(src[2]) << 8) + 0x7F00;
        p = 3;
    }
    NEED(p < n, kErrTruncated);
    const int modes = src[p++];
    NEED((modes & 3) == 0, kErrReserved);
    const FseTable* table[3];
    for (int k = 0; k < 3; ++k) {
        const int mode = (modes >> (6 - 2 * k)) & 3;
        FseTable& f = fr.fse[k];
        if (mode == 0) {
            f = fr.predefined[k];
        } else if (mode == 1) {
            NEED(p < n, kErrTruncated);
            NEED(src[p] <= kMaxSymbol[k], kErrSequences);
            rle_fse(src[p++], f);
        } else if (mode == 2) {
            int16_t norm[64];
            int nsym, log;
            const int64_t used = read_ncount(src + p, n - p, kMaxSymbol[k], kMaxLog[k], norm, &nsym, &log);
            TRY(used);
            p += size_t(used);
            TRY(build_fse(norm, nsym, log, f));
        } else {
            NEED(f.valid, kErrNoTable);
        }
        table[k] = &f;
    }
    BackBits b;
    TRY(b.init(src + p, n - p, kErrSequences));
    FseState ll{table[LL], 0}, of{table[OF], 0}, ml{table[ML], 0};
    ll.init(b);
    of.init(b);
    ml.init(b);
    size_t lit_pos = 0;
    for (size_t i = 0; i < nseq; ++i) {
        const int ofc = of.symbol(), mlc = ml.symbol(), llc = ll.symbol();
        const uint32_t of_value = (1u << ofc) + b.read(ofc);
        const size_t mlen = kMLBase[mlc] + b.read(kMLBits[mlc]);
        const size_t llen = kLLBase[llc] + b.read(kLLBits[llc]);
        uint32_t offset;
        if (of_value > 3) {
            offset = of_value - 3;
            fr.rep[2] = fr.rep[1];
            fr.rep[1] = fr.rep[0];
            fr.rep[0] = offset;
        } else {
            // Repeat offsets; with no literals the codes shift by one, and
            // the last one means rep[0] - 1.
            const uint32_t idx = of_value - 1 + (llen == 0 ? 1 : 0);
            if (idx == 0) {
                offset = fr.rep[0];
            } else {
                offset = idx == 3 ? fr.rep[0] - 1 : fr.rep[idx];
                NEED(offset != 0, kErrOffset);
                if (idx != 1) fr.rep[2] = fr.rep[1];
                fr.rep[1] = fr.rep[0];
                fr.rep[0] = offset;
            }
        }
        if (i + 1 < nseq) {
            ll.update(b);
            ml.update(b);
            of.update(b);
        }
        NEED(b.pos >= 0, kErrSequences);
        NEED(llen <= lit_size - lit_pos, kErrSequences);
        TRY(copy_literals(o, lit + lit_pos, llen));
        lit_pos += llen;
        NEED(offset <= o.pos - o.frame_start, kErrOffset);
        NEED(mlen <= o.cap - o.pos, kErrDstTooSmall);
        uint8_t* d = o.dst + o.pos;
        if (offset >= mlen) {
            std::memcpy(d, d - offset, mlen);
        } else {
            for (size_t k = 0; k < mlen; ++k) d[k] = d[k - offset];
        }
        o.pos += mlen;
    }
    NEED(b.pos == 0, kErrSequences);
    return copy_literals(o, lit + lit_pos, lit_size - lit_pos);
}

// ---------------------------------------------------------------- XXH64

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull, kP2 = 0xC2B2AE3D27D4EB4Full, kP3 = 0x165667B19E3779F9ull,
                   kP4 = 0x85EBCA77C2B2AE63ull, kP5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) { return rotl(acc + in * kP2, 31) * kP1; }
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * kP1 + kP4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
        for (; end - p >= 32; p += 32) {
            v1 = xxh_round(v1, read_le(p, 8));
            v2 = xxh_round(v2, read_le(p + 8, 8));
            v3 = xxh_round(v3, read_le(p + 16, 8));
            v4 = xxh_round(v4, read_le(p + 24, 8));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
    } else {
        h = kP5;
    }
    h += n;
    for (; end - p >= 8; p += 8) h = rotl(h ^ xxh_round(0, read_le(p, 8)), 27) * kP1 + kP4;
    if (end - p >= 4) {
        h = rotl(h ^ (read_le(p, 4) * kP1), 23) * kP2 + kP3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ (*p * kP5), 11) * kP1;
    h ^= h >> 33;
    h *= kP2;
    h ^= h >> 29;
    h *= kP3;
    h ^= h >> 32;
    return h;
}

// ---------------------------------------------------------------- frames

// One Zstandard frame at src[ip..n); returns the index after it.
int64_t decode_frame(const uint8_t* src, size_t n, size_t ip, Frame& fr, Out& o) {
    ip += 4;  // magic
    NEED(ip < n, kErrTruncated);
    const int fhd = src[ip++];
    const int fcs_flag = fhd >> 6;
    const bool single = (fhd >> 5) & 1;
    NEED(!((fhd >> 3) & 1), kErrReserved);
    const bool checksum = (fhd >> 2) & 1;
    if (!single) {
        NEED(ip < n, kErrTruncated);
        NEED(10 + (src[ip] >> 3) <= 31, kErrWindow);
        ++ip;
    }
    static const int kDictBytes[4] = {0, 1, 2, 4};
    const int dict_bytes = kDictBytes[fhd & 3];
    NEED(ip + dict_bytes <= n, kErrTruncated);
    NEED(read_le(src + ip, dict_bytes) == 0, kErrDictionary);
    ip += dict_bytes;
    const int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    NEED(ip + fcs_bytes <= n, kErrTruncated);
    uint64_t fcs = read_le(src + ip, fcs_bytes) + (fcs_bytes == 2 ? 256 : 0);
    ip += fcs_bytes;
    if (fcs_bytes) NEED(fcs <= o.cap - o.pos, kErrDstTooSmall);

    fr.reset();
    o.frame_start = o.pos;
    for (bool last = false; !last;) {
        NEED(ip + 3 <= n, kErrTruncated);
        const uint32_t bh = uint32_t(read_le(src + ip, 3));
        ip += 3;
        last = bh & 1;
        const int type = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        NEED(size <= kBlockMax, kErrBlockSize);
        if (type == 0) {
            NEED(ip + size <= n, kErrTruncated);
            TRY(copy_literals(o, src + ip, size));
            ip += size;
        } else if (type == 1) {
            NEED(ip + 1 <= n, kErrTruncated);
            NEED(size <= o.cap - o.pos, kErrDstTooSmall);
            std::memset(o.dst + o.pos, src[ip], size);
            o.pos += size;
            ip += 1;
        } else if (type == 2) {
            NEED(ip + size <= n, kErrTruncated);
            const size_t before = o.pos;
            const uint8_t* lit;
            size_t lit_size;
            const int64_t head = decode_literals(src + ip, size, fr, &lit, &lit_size);
            TRY(head);
            TRY(decode_sequences(src + ip + head, size - size_t(head), fr, lit, lit_size, o));
            NEED(o.pos - before <= kBlockMax, kErrBlockSize);
            ip += size;
        } else {
            return kErrReserved;
        }
    }
    if (fcs_bytes) NEED(o.pos - o.frame_start == fcs, kErrContentSize);
    if (checksum) {
        NEED(ip + 4 <= n, kErrTruncated);
        const uint32_t want = uint32_t(read_le(src + ip, 4));
        NEED(uint32_t(xxh64(o.dst + o.frame_start, o.pos - o.frame_start)) == want, kErrChecksum);
        ip += 4;
    }
    return int64_t(ip);
}

int64_t decode_frames(const uint8_t* src, size_t n, Frame& fr, Out& o) {
    NEED(n > 0, kErrTruncated);
    size_t ip = 0;
    while (ip < n) {
        NEED(n - ip >= 4, kErrTruncated);
        const uint32_t magic = uint32_t(read_le(src + ip, 4));
        if ((magic & kSkippableMask) == kSkippableMagic) {
            NEED(n - ip >= 8, kErrTruncated);
            const uint64_t size = read_le(src + ip + 4, 4);
            NEED(size <= n - ip - 8, kErrTruncated);
            ip += 8 + size;
            continue;
        }
        NEED(magic == kMagic, kErrMagic);
        const int64_t next = decode_frame(src, n, ip, fr, o);
        TRY(next);
        ip = size_t(next);
    }
    return int64_t(o.pos);
}

}  // namespace

extern "C" {

// Decodes every frame of src[0..n) into dst[0..cap): the decoded size, or
// a negative error code.
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    if (n < 0 || cap < 0) return kErrTruncated;
    Frame* fr = new (std::nothrow) Frame();
    if (fr == nullptr) return kErrMemory;
    Out o{dst, size_t(cap), 0, 0};
    const int64_t result = decode_frames(src, size_t(n), *fr, o);
    delete fr;
    return result;
}

const char* zstd_error_name(int64_t code) { return error_name(code); }

}  // extern "C"
