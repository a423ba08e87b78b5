// Chunked FASTQ decoder: parses records and 2-bit-encodes bases into
// fixed-shape batches (the host half of the read pipeline; replaces the
// jellyfish stream parser the reference uses,
// reference src/SailfishQuantify.cpp:62-64, 893-899).
//
// A copy of native/fastq_decode.cpp, built by _ext.py with g++ and zlib.
// Supports plain and gzip files (zlib).  One handle = one sequential
// reader; batches are filled directly into caller-provided numpy
// buffers (codes uint8[batch, maxlen] and lens int32[batch]).
//
// C ABI:
//   int64_t sf_fastq_open(const char* path);
//   int64_t sf_fastq_next_batch(int64_t h, uint8_t* codes, int32_t* lens,
//                               int64_t batch, int64_t maxlen);
//   void    sf_fastq_close(int64_t h);

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

namespace {

constexpr size_t kBuf = 8 << 20;  // 8 MiB read chunks

struct Reader {
    gzFile f = nullptr;
    std::vector<char> buf;
    size_t pos = 0;   // cursor within buf
    size_t len = 0;   // valid bytes in buf
    bool eof = false;

    bool fill() {
        // move remaining bytes to front, refill
        if (pos > 0) {
            std::memmove(buf.data(), buf.data() + pos, len - pos);
            len -= pos;
            pos = 0;
        }
        if (eof) return len > 0;
        int got = gzread(f, buf.data() + len, int(buf.size() - len));
        if (got <= 0) {
            eof = true;
        } else {
            len += size_t(got);
        }
        return len > 0;
    }

    // next line [start, end) within buf; returns false at EOF.
    // The line stays valid until the next fill().
    bool line(const char** s, size_t* n) {
        for (;;) {
            const char* nl = static_cast<const char*>(
                memchr(buf.data() + pos, '\n', len - pos));
            if (nl) {
                *s = buf.data() + pos;
                *n = size_t(nl - (buf.data() + pos));
                pos = size_t(nl - buf.data()) + 1;
                if (*n && (*s)[*n - 1] == '\r') --*n;  // CRLF input
                return true;
            }
            if (eof) {
                if (pos < len) {  // last line without newline
                    *s = buf.data() + pos;
                    *n = len - pos;
                    pos = len;
                    if (*n && (*s)[*n - 1] == '\r') --*n;
                    return true;
                }
                return false;
            }
            size_t before = len - pos;
            fill();
            if (len - pos == before && eof && before == 0) return false;
        }
    }
};

uint8_t g_lut[256];
struct LutInit {
    LutInit() {
        std::memset(g_lut, 4, sizeof(g_lut));
        g_lut['A'] = g_lut['a'] = 0;
        g_lut['C'] = g_lut['c'] = 1;
        g_lut['G'] = g_lut['g'] = 2;
        g_lut['T'] = g_lut['t'] = 3;
        g_lut['U'] = g_lut['u'] = 3;
    }
} g_lut_init;

std::mutex g_mu;
std::map<int64_t, Reader*> g_readers;
int64_t g_next = 1;

}  // namespace

extern "C" {

int64_t sf_fastq_open(const char* path) {
    gzFile f = gzopen(path, "rb");
    if (!f) return -1;
    gzbuffer(f, 1 << 20);
    auto* r = new Reader();
    r->f = f;
    r->buf.resize(kBuf);
    std::lock_guard<std::mutex> lk(g_mu);
    int64_t h = g_next++;
    g_readers[h] = r;
    return h;
}

int64_t sf_fastq_next_batch(int64_t h, uint8_t* codes, int32_t* lens,
                            int64_t batch, int64_t maxlen) {
    Reader* r;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_readers.find(h);
        if (it == g_readers.end()) return -1;
        r = it->second;
    }
    int64_t n = 0;
    const char* s;
    size_t sl;
    while (n < batch) {
        if (!r->line(&s, &sl)) break;      // header (or EOF)
        if (sl == 0) continue;             // tolerate blank lines
        if (s[0] != '@') return -2;        // malformed
        if (!r->line(&s, &sl)) return -2;  // sequence
        uint8_t* row = codes + n * maxlen;
        int64_t L = int64_t(sl) < maxlen ? int64_t(sl) : maxlen;
        for (int64_t i = 0; i < L; ++i) row[i] = g_lut[uint8_t(s[i])];
        if (L < maxlen) std::memset(row + L, 4, size_t(maxlen - L));
        // true (unclipped) length so the caller can detect reads longer
        // than the static batch width and re-pad instead of truncating
        lens[n] = int32_t(sl);
        if (!r->line(&s, &sl)) return -2;  // '+'
        if (!r->line(&s, &sl)) return -2;  // quals
        ++n;
    }
    return n;
}

// Skip `count` FASTQ records (same record grammar as next_batch).
// Returns the number actually skipped, or -1/-2 on bad handle/malformed.
int64_t sf_fastq_skip(int64_t h, int64_t count) {
    Reader* r;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_readers.find(h);
        if (it == g_readers.end()) return -1;
        r = it->second;
    }
    int64_t n = 0;
    const char* s;
    size_t sl;
    while (n < count) {
        if (!r->line(&s, &sl)) break;      // header (or EOF)
        if (sl == 0) continue;
        if (s[0] != '@') return -2;
        if (!r->line(&s, &sl)) return -2;  // sequence
        if (!r->line(&s, &sl)) return -2;  // '+'
        if (!r->line(&s, &sl)) return -2;  // quals
        ++n;
    }
    return n;
}

void sf_fastq_close(int64_t h) {
    Reader* r = nullptr;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_readers.find(h);
        if (it != g_readers.end()) {
            r = it->second;
            g_readers.erase(it);
        }
    }
    if (r) {
        gzclose(r->f);
        delete r;
    }
}

}  // extern "C"
