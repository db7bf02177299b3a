// Native host half of the event data path.
//
// The reference delegates its per-item host work to torch's C++ DataLoader
// machinery (reference datasets/event2img.py runs inside worker processes);
// the TPU rebuild keeps items in threads (data/loader.py PrefetchLoader), so
// the per-item transform must release the GIL and touch each event once.
// This translation unit fuses the whole per-item stream pipeline —
// center_events -> tflip -> shift(+drop) -> hflip (data/host_ops.py, the
// behavioral contracts of reference datasets/utils.py:4-57) — into a single
// pass, and packs selected windows straight to the int16 wire layout
// (host_ops.gather_event_windows) without numpy temporaries.
//
// Bit parity with the numpy path is a hard contract (tests/test_native.py):
// every elementwise op below is float32 in the same order numpy applies it,
// so outputs are bit-identical, and the RNG draws stay in Python
// (data/host_ops.py draw_augment) so generator streams cannot diverge.
//
// Build: scripts/build_native.py (plain g++ -O3 -shared; no deps).

#include <cstdint>

extern "C" {

// Fused center/augment over an [n, 4] float32 (x, y, t, p) stream.
//
//   do_center: t -= t.min(); x/y -= floor32((max+min+1-extent)/2)
//              (reference datasets/utils.py:38-57 arithmetic)
//   do_tflip:  reverse order, t' = t_last - t, p' = -p   (utils.py:26-35)
//   do_shift:  x += dx, y += dy, drop out-of-frame       (utils.py:4-15)
//   do_hflip:  x = W-1-x                                 (utils.py:18-23)
//
// Writes surviving events to out[m, 4] (may alias nothing; out != ev) and
// returns m. n == 0 returns 0 immediately.
int64_t ec_transform(const float* ev, int64_t n, int H, int W,
                     int do_center, int do_tflip, int do_shift,
                     int dx, int dy, int do_hflip, float* out) {
    if (n <= 0) return 0;

    float sx = 0.0f, sy = 0.0f, tmin = 0.0f;
    if (do_center) {
        float xmin = ev[0], xmax = ev[0];
        float ymin = ev[1], ymax = ev[1];
        tmin = ev[2];
        for (int64_t i = 1; i < n; ++i) {
            const float x = ev[4 * i], y = ev[4 * i + 1], t = ev[4 * i + 2];
            if (x < xmin) xmin = x;
            if (x > xmax) xmax = x;
            if (y < ymin) ymin = y;
            if (y > ymax) ymax = y;
            if (t < tmin) tmin = t;
        }
        // numpy: ((max + min + 1.) - extent) // 2. — all float32 under
        // NEP 50 (python scalars are weak); // = floor(a / b)
        auto floordiv2 = [](float a) {
            float q = a / 2.0f;
            float f = (float)(int64_t)q;
            if (f > q) f -= 1.0f;  // floor for negatives
            return f;
        };
        sx = floordiv2((xmax + xmin + 1.0f) - (float)W);
        sy = floordiv2((ymax + ymin + 1.0f) - (float)H);
    }

    // tflip base: last event's (centered) timestamp, float32 op order
    // matching numpy (center writes t-tmin, tflip reads it back)
    const float tlast = ev[4 * (n - 1) + 2] - tmin;

    const float fdx = (float)dx, fdy = (float)dy;
    const float w1 = (float)(W - 1);
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t j = do_tflip ? (n - 1 - i) : i;
        float x = ev[4 * j] - sx;
        float y = ev[4 * j + 1] - sy;
        float t = ev[4 * j + 2] - tmin;
        float p = ev[4 * j + 3];
        if (do_tflip) {
            t = tlast - t;
            p = -p;
        }
        if (do_shift) {
            x += fdx;
            y += fdy;
            if (!(x >= 0.0f && x < (float)W && y >= 0.0f && y < (float)H))
                continue;
        }
        if (do_hflip) x = w1 - x;
        out[4 * m] = x;
        out[4 * m + 1] = y;
        out[4 * m + 2] = t;
        out[4 * m + 3] = p;
        ++m;
    }
    return m;
}

// Gather window spans of an [n, 4] float32 stream into the packed int16
// wire layout [k, window, 3] (x, y, p; timestamps dropped — the on-device
// rasterizer never reads them, host_ops.gather_event_windows). `out` must
// be zero-initialised by the caller (short windows keep p == 0 padding).
// Casts are C truncation, matching numpy .astype(int16) on integral values.
void ec_pack_spans(const float* ev, const int64_t* spans, int64_t k,
                   int64_t window, int16_t* out) {
    for (int64_t s = 0; s < k; ++s) {
        const int64_t a = spans[2 * s], b = spans[2 * s + 1];
        int16_t* row = out + s * window * 3;
        for (int64_t i = a; i < b; ++i) {
            row[0] = (int16_t)ev[4 * i];
            row[1] = (int16_t)ev[4 * i + 1];
            row[2] = (int16_t)ev[4 * i + 3];
            row += 3;
        }
    }
}

// Same gather in the unpacked float32 [k, window, 4] layout (the
// keep-timestamps path used for visualization / packed=False).
void ec_pack_spans_f32(const float* ev, const int64_t* spans, int64_t k,
                       int64_t window, float* out) {
    for (int64_t s = 0; s < k; ++s) {
        const int64_t a = spans[2 * s], b = spans[2 * s + 1];
        float* row = out + s * window * 4;
        for (int64_t i = a; i < b; ++i) {
            row[0] = ev[4 * i];
            row[1] = ev[4 * i + 1];
            row[2] = ev[4 * i + 2];
            row[3] = ev[4 * i + 3];
            row += 4;
        }
    }
}

// N-ImageNet structured-record decode (data/datasets.py::load_event_npz):
// one pass over the raw record buffer of np.load(...)["event_data"] into
// the [n, 4] float32 (x, y, t, p) layout. Per-element semantics mirror the
// reference chain exactly (imagenet.py:8-27): x/y via the float64
// intermediate, t = (double)raw / 1e6 then float32, p through numpy's
// astype(uint8) truncation (an int8 -1 becomes 255, reference-identical)
// followed by the 0/1 -> -1/+1 remap (after the uint8 cast p >= 0 always,
// so the reference's min() guard is unconditionally true).
//
// Field type codes (set by the Python wrapper from the numpy dtype):
// 0=u1/bool 1=i1 2=u2 3=i2 4=u4 5=i4 6=u8 7=i8 8=f4 9=f8

static inline double ec_read(const uint8_t* p, int code) {
    switch (code) {
        case 0: { uint8_t v; __builtin_memcpy(&v, p, 1); return v; }
        case 1: { int8_t v; __builtin_memcpy(&v, p, 1); return v; }
        case 2: { uint16_t v; __builtin_memcpy(&v, p, 2); return v; }
        case 3: { int16_t v; __builtin_memcpy(&v, p, 2); return v; }
        case 4: { uint32_t v; __builtin_memcpy(&v, p, 4); return v; }
        case 5: { int32_t v; __builtin_memcpy(&v, p, 4); return v; }
        case 6: { uint64_t v; __builtin_memcpy(&v, p, 8); return (double)v; }
        case 7: { int64_t v; __builtin_memcpy(&v, p, 8); return (double)v; }
        case 8: { float v; __builtin_memcpy(&v, p, 4); return v; }
        case 9: { double v; __builtin_memcpy(&v, p, 8); return v; }
    }
    return 0.0;
}

extern "C" void ec_decode_struct(
    const uint8_t* base, int64_t n, int64_t stride,
    int64_t xo, int xc, int64_t yo, int yc,
    int64_t to, int tc, int64_t po, int pc, float* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* rec = base + i * stride;
        out[4 * i] = (float)ec_read(rec + xo, xc);
        out[4 * i + 1] = (float)ec_read(rec + yo, yc);
        out[4 * i + 2] = (float)(ec_read(rec + to, tc) / 1e6);
        const uint8_t pu = (uint8_t)(int64_t)ec_read(rec + po, pc);
        out[4 * i + 3] = pu == 0 ? -1.0f : (float)pu;
    }
}

}  // extern "C"
