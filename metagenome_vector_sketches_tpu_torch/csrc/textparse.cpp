// Strict parsers of the two text files that the port's entries read on
// every call: a db folder's vector_norms.txt ("<name> <norm> ..." a line)
// and a search request's query file ("<name>: h1 h2 ..." a line). Host
// code, built with the system's C++ compiler by io/textparse.py; one read
// of the file and one pass over it, on the caller's thread.
//
// Each parser accepts only input on which it gives exactly what the Python
// parsers of io/dbfolder.py (DbFolder.names_and_norms) and io/hashes.py
// (parse_query_hashes_file) give, read in text mode: ASCII bytes only;
// '\n' and '\r' end a line (universal newlines); space, '\t', '\v', '\f'
// and 0x1c-0x1f separate tokens (str.split()). Anything else -- a byte
// above 0x7f, a norm that is not a plain decimal, a hash with a sign, a
// non-digit or above 2^64 - 1, a query line without exactly one ':' --
// returns kNotExact, and the caller runs the Python parser, which returns
// or raises what it always did. So does any error: no exception leaves
// an entry point.
//
// C ABI (ctypes), every output malloc'd, freed with textparse_free:
//   textparse_norms(path, &norms, &names, &names_len) -> lines kept
//   textparse_queries(path, &hashes, &offsets, &names, &names_len) -> lines
// names: the names joined by '\n' (no name holds '\n'); offsets: lines + 1
// prefix sums into hashes, each line's hashes sorted and unique. A negative
// return is an error (kNotExact, or the file could not be read).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kOpen = -1;
constexpr int64_t kRead = -2;
constexpr int64_t kMemory = -3;
constexpr int64_t kNotExact = -4;

// byte classes: 0 token byte, 1 separator, 2 line end
struct Classes {
    unsigned char of[256] = {};
    constexpr Classes() {
        for (int c : {0x20, 0x09, 0x0b, 0x0c, 0x1c, 0x1d, 0x1e, 0x1f})
            of[c] = 1;
        of[(int)'\n'] = of[(int)'\r'] = 2;
    }
};
constexpr Classes kClasses;

inline unsigned char cls(char c) { return kClasses.of[(unsigned char)c]; }

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

using Buffer = std::unique_ptr<char, decltype(&std::free)>;

// The whole of a regular file of ASCII bytes, with one '\n' after its last
// byte. -> its size, or an error code: a pipe or another special file, and
// a file that changes size while it is read, go to the Python parsers,
// which read to the end whatever it holds.
int64_t read_file(const char* path, Buffer* out) {
    int fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return kOpen;
    struct stat st;
    if (::fstat(fd, &st) != 0 || !S_ISREG(st.st_mode) || st.st_size < 0) {
        ::close(fd);
        return kRead;
    }
    size_t n = (size_t)st.st_size;
    Buffer data((char*)std::malloc(n + 1), &std::free);
    if (!data) {
        ::close(fd);
        return kMemory;
    }
    size_t got = 0;
    while (true) {
        // one byte past the stat size shows a file that grew
        ssize_t r = ::read(fd, data.get() + got, n + 1 - got);
        if (r < 0 && errno == EINTR) continue;
        if (r <= 0) break;
        got += (size_t)r;
        if (got > n) break;
    }
    ::close(fd);
    if (got != n) return kRead;
    unsigned char high = 0;
    for (size_t i = 0; i < n; i++) high |= (unsigned char)data.get()[i];
    if (high >= 0x80) return kNotExact;
    data.get()[n] = '\n';
    *out = std::move(data);
    return (int64_t)n;
}

// float() of the token [p, e), for the grammar
// [+-]? (digits (. digits*)? | . digits) ([eE] [+-]? digits)?; false for
// any other token, and for one whose value under- or overflows. strtod
// rounds correctly (glibc), as float() does; it stops at the separator or
// line end after the token, and short of it where the locale's decimal
// point is not '.'.
bool parse_double(const char* p, const char* e, double* out) {
    const char* s = p;
    if (*s == '+' || *s == '-') s++;
    const char* d = s;
    while (is_digit(*s)) s++;
    size_t ndig = (size_t)(s - d);
    if (*s == '.') {
        d = ++s;
        while (is_digit(*s)) s++;
        ndig += (size_t)(s - d);
    }
    if (ndig == 0) return false;
    if (*s == 'e' || *s == 'E') {
        s++;
        if (*s == '+' || *s == '-') s++;
        if (!is_digit(*s)) return false;
        while (is_digit(*s)) s++;
    }
    if (s != e) return false;
    char* end = nullptr;
    errno = 0;
    *out = std::strtod(p, &end);
    return errno != ERANGE && end == e;
}

// The output of a pass: the names written over the file's own bytes, from
// its start (a name and its '\n' never pass the bytes read by then).
struct Names {
    char* base;
    char* w;
    void add(const char* b, const char* e) {
        std::memmove(w, b, (size_t)(e - b));
        w += e - b;
        *w++ = '\n';
    }
    int64_t bytes() const { return w == base ? 0 : (int64_t)(w - base) - 1; }
};

}  // namespace

extern "C" {

// vector_norms.txt: every line of two tokens or more gives its first token
// as a name and float(second token) as a norm; lines of fewer are skipped.
int64_t textparse_norms(const char* path, double** norms_out,
                        char** names_out, int64_t* names_len_out) try {
    *norms_out = nullptr;
    *names_out = nullptr;
    *names_len_out = 0;
    Buffer data(nullptr, &std::free);
    int64_t n = read_file(path, &data);
    if (n < 0) return n;
    // a kept line takes a name, a separator and a digit
    std::unique_ptr<double, decltype(&std::free)> norms(
        (double*)std::malloc(sizeof(double) * ((size_t)n / 3 + 1)),
        &std::free);
    if (!norms) return kMemory;
    Names names{data.get(), data.get()};
    int64_t kept = 0;
    // the sentinel '\n' after the file's last byte ends its last line
    for (const char* p = data.get(); p < data.get() + n;) {
        const char* tok[2][2];
        int ntok = 0;
        while (true) {
            while (cls(*p) == 1) p++;
            if (cls(*p) == 2) break;
            const char* t = p;
            while (cls(*p) == 0) p++;
            if (ntok < 2) {
                tok[ntok][0] = t;
                tok[ntok][1] = p;
            }
            ntok++;
        }
        p++;  // past the line end
        if (ntok < 2) continue;
        if (!parse_double(tok[1][0], tok[1][1], norms.get() + kept))
            return kNotExact;
        kept++;
        names.add(tok[0][0], tok[0][1]);
    }
    *names_len_out = names.bytes();
    *norms_out = norms.release();
    *names_out = data.release();
    return kept;
} catch (...) {
    return kMemory;
}

// query file: every line that is not blank holds exactly one ':'; the name
// is what lies before it, stripped; the hashes after it, sorted and unique.
int64_t textparse_queries(const char* path, uint64_t** hashes_out,
                          int64_t** offsets_out, char** names_out,
                          int64_t* names_len_out) try {
    *hashes_out = nullptr;
    *offsets_out = nullptr;
    *names_out = nullptr;
    *names_len_out = 0;
    Buffer data(nullptr, &std::free);
    int64_t n = read_file(path, &data);
    if (n < 0) return n;
    // a stored hash takes a digit and a byte after it
    std::unique_ptr<uint64_t, decltype(&std::free)> hashes(
        (uint64_t*)std::malloc(sizeof(uint64_t) * ((size_t)n / 2 + 1)),
        &std::free);
    if (!hashes) return kMemory;
    uint64_t* h = hashes.get();
    std::vector<int64_t> offsets{0};
    Names names{data.get(), data.get()};
    for (const char* p = data.get(); p < data.get() + n;) {
        const char* lb = p;
        while (cls(*p) != 2) p++;
        const char* le = p++;
        while (lb < le && cls(*lb) == 1) lb++;
        while (le > lb && cls(le[-1]) == 1) le--;
        if (lb == le) continue;  // blank line
        const char* colon =
            (const char*)std::memchr(lb, ':', (size_t)(le - lb));
        if (!colon || std::memchr(colon + 1, ':', (size_t)(le - colon - 1)))
            return kNotExact;  // the Python parser raises its ValueError
        const char* ne = colon;
        while (ne > lb && cls(ne[-1]) == 1) ne--;
        names.add(lb, ne);
        int64_t first = offsets.back();
        int64_t nh = first;
        for (const char* q = colon + 1; q < le;) {
            if (cls(*q) == 1) {
                q++;
                continue;
            }
            uint64_t v = 0;
            const char* t = q;
            for (; is_digit(*q); q++)
                if (__builtin_mul_overflow(v, 10, &v) ||
                    __builtin_add_overflow(v, (uint64_t)(*q - '0'), &v))
                    return kNotExact;  // above 2^64 - 1
            if (q == t || cls(*q) == 0)
                return kNotExact;  // a sign or another non-digit
            h[nh++] = v;
        }
        std::sort(h + first, h + nh);
        offsets.push_back(std::unique(h + first, h + nh) - h);
    }
    size_t lines = offsets.size() - 1;
    int64_t* off = (int64_t*)std::malloc(sizeof(int64_t) * (lines + 1));
    if (!off) return kMemory;
    std::memcpy(off, offsets.data(), sizeof(int64_t) * (lines + 1));
    *names_len_out = names.bytes();
    *hashes_out = hashes.release();
    *offsets_out = off;
    *names_out = data.release();
    return (int64_t)lines;
} catch (...) {
    return kMemory;
}

void textparse_free(void* p) { std::free(p); }

}  // extern "C"
