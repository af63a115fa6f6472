// Native trajectory fiber-frame encoder.
//
// The port's own copy of the JAX package's `native/frameenc.cpp` (the
// reference packs its per-rank msgpack fiber maps in C++, `system.cpp:100-177`):
// emits the msgpack bytes of the active-fiber map array, byte-identical to
// the numpy encoder of `skellysim_tpu_torch.io.trajectory` (itself
// wire-identical to packing the object frame). Called from
// `io.trajectory._fiber_array_bytes_native` through ctypes.
//
// Wire contract per fiber (trajectory v1, `include/io_maps.hpp:30-38` /
// `fiber_finite_difference.hpp:160-161` field set): a 12-entry map
//   n_nodes_ (uint), radius_/length_/length_prev_/bending_rigidity_/
//   penalty_param_/force_scale_/beta_tstep_ (float64),
//   binding_site_ ([int, int]), tension_ (__eigen__ n x 1),
//   x_ (__eigen__ 3 x n, row-major [n,3] ravel), minus_clamped_ (bool).
//
// Built at first use by `skellysim_tpu_torch/native/build.py`
// (g++ -O3 -shared -fPIC -std=c++17) into skellysim_tpu_torch/_build/.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Buf {
    std::vector<uint8_t> b;

    void u8(uint8_t v) { b.push_back(v); }
    void raw(const void *p, size_t n) {
        const uint8_t *q = (const uint8_t *)p;
        b.insert(b.end(), q, q + n);
    }
    void be16(uint16_t v) {
        u8(v >> 8);
        u8(v & 0xff);
    }
    void be32(uint32_t v) {
        u8(v >> 24);
        u8((v >> 16) & 0xff);
        u8((v >> 8) & 0xff);
        u8(v & 0xff);
    }

    // fixstr only (every key/tag here is < 32 chars)
    void str(const char *s) {
        size_t n = strlen(s);
        u8(0xa0 | (uint8_t)n);
        raw(s, n);
    }

    // matches msgpack-python's minimal int encoding
    void sint(int64_t v) {
        if (v >= 0) {
            if (v < 128) u8((uint8_t)v);
            else if (v < 256) { u8(0xcc); u8((uint8_t)v); }
            else if (v < 65536) { u8(0xcd); be16((uint16_t)v); }
            else { u8(0xce); be32((uint32_t)v); }
        } else {
            if (v >= -32) u8((uint8_t)(int8_t)v);
            else if (v >= -128) { u8(0xd0); u8((uint8_t)(int8_t)v); }
            else if (v >= -32768) { u8(0xd1); be16((uint16_t)(int16_t)v); }
            else { u8(0xd2); be32((uint32_t)(int32_t)v); }
        }
    }

    void f64(double v) {
        u8(0xcb);
        uint64_t bits;
        memcpy(&bits, &v, 8);
        for (int i = 7; i >= 0; --i)
            u8((bits >> (8 * i)) & 0xff);
    }

    void arr_hdr(uint64_t n) {
        if (n < 16) u8(0x90 | (uint8_t)n);
        else if (n < 65536) { u8(0xdc); be16((uint16_t)n); }
        else { u8(0xdd); be32((uint32_t)n); }
    }

    void map_hdr(uint64_t n) {
        if (n < 16) u8(0x80 | (uint8_t)n);
        else if (n < 65536) { u8(0xde); be16((uint16_t)n); }
        else { u8(0xdf); be32((uint32_t)n); }
    }

    void eigen(const double *data, int64_t rows, int64_t cols, int64_t count) {
        arr_hdr(3 + count);
        str("__eigen__");
        sint(rows);
        sint(cols);
        for (int64_t i = 0; i < count; ++i)
            f64(data[i]);
    }
};

} // namespace

extern "C" {

// Encode the active-fiber map array. Scalar fields are [nf] doubles; x is
// [nf, n, 3] and tension [nf, n], both row-major contiguous; binding is
// [nf, 2] int32; active/minus_clamped are [nf] uint8. The returned buffer is
// malloc'd; free with frameenc_free.
int64_t frameenc_fibers(const double *x, const double *tension,
                        const double *radius, const double *length,
                        const double *length_prev, const double *bending,
                        const double *penalty, const double *force_scale,
                        const double *beta, const int32_t *binding,
                        const uint8_t *active, const uint8_t *minus_clamped,
                        int64_t nf, int64_t n, uint8_t **out,
                        uint64_t *out_len) {
    if (nf < 0 || n <= 0 || !out || !out_len)
        return -1;
    int64_t n_active = 0;
    for (int64_t i = 0; i < nf; ++i)
        n_active += active[i] ? 1 : 0;

    Buf buf;
    // ~9 bytes per double + map overhead; reserve once
    buf.b.reserve(64 + (size_t)n_active * (200 + 9 * (size_t)(4 * n)));
    buf.arr_hdr(n_active);
    for (int64_t i = 0; i < nf; ++i) {
        if (!active[i])
            continue;
        buf.map_hdr(12);
        buf.str("n_nodes_");
        buf.sint(n);
        buf.str("radius_");
        buf.f64(radius[i]);
        buf.str("length_");
        buf.f64(length[i]);
        buf.str("length_prev_");
        buf.f64(length_prev[i]);
        buf.str("bending_rigidity_");
        buf.f64(bending[i]);
        buf.str("penalty_param_");
        buf.f64(penalty[i]);
        buf.str("force_scale_");
        buf.f64(force_scale[i]);
        buf.str("beta_tstep_");
        buf.f64(beta[i]);
        buf.str("binding_site_");
        buf.arr_hdr(2);
        buf.sint(binding[2 * i]);
        buf.sint(binding[2 * i + 1]);
        buf.str("tension_");
        buf.eigen(tension + i * n, n, 1, n);
        buf.str("x_");
        buf.eigen(x + i * 3 * n, 3, n, 3 * n);
        buf.str("minus_clamped_");
        buf.u8(minus_clamped[i] ? 0xc3 : 0xc2);
    }

    uint8_t *mem = (uint8_t *)malloc(buf.b.size());
    if (!mem)
        return -1;
    memcpy(mem, buf.b.data(), buf.b.size());
    *out = mem;
    *out_len = buf.b.size();
    return n_active;
}

void frameenc_free(uint8_t *p) { free(p); }

} // extern "C"
