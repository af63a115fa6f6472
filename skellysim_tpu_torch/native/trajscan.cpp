// Native trajectory frame scanner.
//
// The port's own copy of the JAX package's `native/trajscan.cpp` (the
// reference's index builder is `trajectory_reader.cpp:78-124`): streams
// through a msgpack trajectory without decoding payloads, recording the byte
// offset and `time` value of every top-level frame map. Called from
// `skellysim_tpu_torch.io.trajectory.build_index` through ctypes; the Python
// scan decodes every frame, which the native scan skips over.
//
// Built at first use by `skellysim_tpu_torch/native/build.py`
// (g++ -O3 -shared -fPIC -std=c++17) into skellysim_tpu_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Cursor {
    const uint8_t *p;
    const uint8_t *end;
    bool ok = true;

    bool need(size_t n) {
        if ((size_t)(end - p) < n) {
            ok = false;
            return false;
        }
        return true;
    }
    uint8_t u8() { return *p++; }
    uint64_t be(int n) {
        uint64_t v = 0;
        for (int i = 0; i < n; ++i)
            v = (v << 8) | *p++;
        return v;
    }
};

// Skip one msgpack object. Returns false on truncated/invalid input.
bool skip_obj(Cursor &c);

bool skip_n(Cursor &c, uint64_t n) {
    for (uint64_t i = 0; i < n; ++i)
        if (!skip_obj(c))
            return false;
    return true;
}

bool skip_obj(Cursor &c) {
    if (!c.need(1))
        return false;
    uint8_t b = c.u8();
    if (b <= 0x7f || b >= 0xe0 || b == 0xc0 || b == 0xc2 || b == 0xc3)
        return true;                                  // fixint / nil / bool
    if (b >= 0x80 && b <= 0x8f)
        return skip_n(c, 2ull * (b & 0x0f));          // fixmap
    if (b >= 0x90 && b <= 0x9f)
        return skip_n(c, b & 0x0f);                   // fixarray
    if (b >= 0xa0 && b <= 0xbf) {                     // fixstr
        uint64_t n = b & 0x1f;
        if (!c.need(n)) return false;
        c.p += n;
        return true;
    }
    switch (b) {
    case 0xc4: case 0xd9: {                           // bin8 / str8
        if (!c.need(1)) return false;
        uint64_t n = c.be(1);
        if (!c.need(n)) return false;
        c.p += n;
        return true;
    }
    case 0xc5: case 0xda: {                           // bin16 / str16
        if (!c.need(2)) return false;
        uint64_t n = c.be(2);
        if (!c.need(n)) return false;
        c.p += n;
        return true;
    }
    case 0xc6: case 0xdb: {                           // bin32 / str32
        if (!c.need(4)) return false;
        uint64_t n = c.be(4);
        if (!c.need(n)) return false;
        c.p += n;
        return true;
    }
    case 0xc7: case 0xc8: case 0xc9: {                // ext8/16/32
        int ls = b == 0xc7 ? 1 : b == 0xc8 ? 2 : 4;
        if (!c.need(ls)) return false;
        uint64_t n = c.be(ls);
        if (!c.need(n + 1)) return false;
        c.p += n + 1;
        return true;
    }
    case 0xca: if (!c.need(4)) return false; c.p += 4; return true;  // f32
    case 0xcb: if (!c.need(8)) return false; c.p += 8; return true;  // f64
    case 0xcc: case 0xd0: if (!c.need(1)) return false; c.p += 1; return true;
    case 0xcd: case 0xd1: if (!c.need(2)) return false; c.p += 2; return true;
    case 0xce: case 0xd2: if (!c.need(4)) return false; c.p += 4; return true;
    case 0xcf: case 0xd3: if (!c.need(8)) return false; c.p += 8; return true;
    case 0xd4: case 0xd5: case 0xd6: case 0xd7: case 0xd8: {         // fixext
        uint64_t n = 1ull << (b - 0xd4);
        if (!c.need(n + 1)) return false;
        c.p += n + 1;
        return true;
    }
    case 0xdc: {                                       // array16
        if (!c.need(2)) return false;
        return skip_n(c, c.be(2));
    }
    case 0xdd: {                                       // array32
        if (!c.need(4)) return false;
        return skip_n(c, c.be(4));
    }
    case 0xde: {                                       // map16
        if (!c.need(2)) return false;
        return skip_n(c, 2 * c.be(2));
    }
    case 0xdf: {                                       // map32
        if (!c.need(4)) return false;
        return skip_n(c, 2 * c.be(4));
    }
    default:
        return false;                                  // 0xc1 never used
    }
}

// Parse a number-valued object into *out (only forms the writer emits for time).
bool read_number(Cursor &c, double *out) {
    if (!c.need(1))
        return false;
    uint8_t b = c.u8();
    if (b <= 0x7f) { *out = b; return true; }
    if (b >= 0xe0) { *out = (int8_t)b; return true; }
    switch (b) {
    case 0xca: {
        if (!c.need(4)) return false;
        uint32_t v = (uint32_t)c.be(4);
        float f;
        memcpy(&f, &v, 4);
        *out = f;
        return true;
    }
    case 0xcb: {
        if (!c.need(8)) return false;
        uint64_t v = c.be(8);
        double d;
        memcpy(&d, &v, 8);
        *out = d;
        return true;
    }
    case 0xcc: if (!c.need(1)) return false; *out = (double)c.be(1); return true;
    case 0xcd: if (!c.need(2)) return false; *out = (double)c.be(2); return true;
    case 0xce: if (!c.need(4)) return false; *out = (double)c.be(4); return true;
    case 0xcf: if (!c.need(8)) return false; *out = (double)c.be(8); return true;
    case 0xd0: if (!c.need(1)) return false; *out = (int8_t)c.be(1); return true;
    case 0xd1: if (!c.need(2)) return false; *out = (int16_t)c.be(2); return true;
    case 0xd2: if (!c.need(4)) return false; *out = (int32_t)c.be(4); return true;
    case 0xd3: if (!c.need(8)) return false; *out = (int64_t)c.be(8); return true;
    default:
        return false;
    }
}

// Read a map header; returns pair count or -1 if the object is not a map.
int64_t map_header(Cursor &c) {
    if (!c.need(1))
        return -1;
    uint8_t b = c.u8();
    if (b >= 0x80 && b <= 0x8f)
        return b & 0x0f;
    if (b == 0xde) {
        if (!c.need(2)) return -1;
        return (int64_t)c.be(2);
    }
    if (b == 0xdf) {
        if (!c.need(4)) return -1;
        return (int64_t)c.be(4);
    }
    return -1;
}

// Match a fixstr/str8 key against "time" without allocating.
bool key_is_time(Cursor &c, bool *matched) {
    if (!c.need(1))
        return false;
    uint8_t b = c.u8();
    uint64_t n;
    if (b >= 0xa0 && b <= 0xbf)
        n = b & 0x1f;
    else if (b == 0xd9) {
        if (!c.need(1)) return false;
        n = c.be(1);
    } else {
        c.p--;  // not a string key: skip generically
        *matched = false;
        return skip_obj(c);
    }
    if (!c.need(n))
        return false;
    *matched = (n == 4 && memcmp(c.p, "time", 4) == 0);
    c.p += n;
    return true;
}

} // namespace

extern "C" {

// Scan `buf[0:len)` for top-level maps carrying a "time" key. Fills
// freshly-malloc'd arrays of frame byte offsets and times; returns the frame
// count, or -1 on malformed input. A trailing partial frame is ignored,
// matching the reference index builder's OutOfData handling.
int64_t trajscan_buffer(const uint8_t *buf, uint64_t len, uint64_t **offsets_out,
                        double **times_out) {
    Cursor c{buf, buf + len};
    std::vector<uint64_t> offsets;
    std::vector<double> times;

    while (c.p < c.end) {
        const uint8_t *start = c.p;
        Cursor probe = c;
        int64_t pairs = map_header(probe);
        bool has_time = false;
        double t = 0.0;
        if (pairs >= 0) {
            bool good = true;
            for (int64_t i = 0; i < pairs && good; ++i) {
                bool is_time = false;
                good = key_is_time(probe, &is_time);
                if (!good)
                    break;
                if (is_time) {
                    good = read_number(probe, &t);
                    has_time = good;
                } else {
                    good = skip_obj(probe);
                }
            }
            if (!good)
                break;  // truncated trailing frame
            c.p = probe.p;
        } else {
            if (!skip_obj(c))
                break;
        }
        if (has_time) {
            offsets.push_back((uint64_t)(start - buf));
            times.push_back(t);
        }
    }

    uint64_t n = offsets.size();
    *offsets_out = (uint64_t *)malloc(sizeof(uint64_t) * (n ? n : 1));
    *times_out = (double *)malloc(sizeof(double) * (n ? n : 1));
    if (n) {
        memcpy(*offsets_out, offsets.data(), sizeof(uint64_t) * n);
        memcpy(*times_out, times.data(), sizeof(double) * n);
    }
    return (int64_t)n;
}

void trajscan_free(void *p) { free(p); }

} // extern "C"
