// Native stream framing + sample conversion for the MSK144 decoder.
//
// Equivalent of the reference's C++ host data path
// (/root/reference/src/main.cu:261-386): the stdin working loop maintains a
// 5184-sample window advanced by 50% per iteration, RMS-normalizes int16
// audio (thrust::reduce + transform, main.cu:301-323) or scales int8 IQ by
// 1/128 (main.cu:365-371). Here that is a reusable ring-buffer framer with a
// C ABI, loaded from Python via ctypes (no pybind11 in this image).
//
// Build: make -C native  (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kWindowLen = 5184;   // samples per analysis window (common.h:15)
constexpr int kHopLen = kWindowLen / 2;  // 50% overlap advance

struct Framer {
    int read_mode;        // 1 = int16 audio, 2 = int8 IQ pairs
    int items_per_window; // 5184 (mode 1) or 10368 (mode 2)
    int item_size;        // bytes per item
    std::vector<uint8_t> window;   // current window backing store
    std::vector<uint8_t> pending;  // bytes not yet framed
    bool primed = false;           // first full window delivered?
    long long windows_emitted = 0;
};

} // namespace

extern "C" {

Framer* msk144_framer_create(int read_mode) {
    if (read_mode != 1 && read_mode != 2) return nullptr;
    Framer* f = new Framer();
    f->read_mode = read_mode;
    f->items_per_window = read_mode == 2 ? kWindowLen * 2 : kWindowLen;
    f->item_size = read_mode == 2 ? 1 : 2;
    f->window.resize((size_t)f->items_per_window * f->item_size);
    return f;
}

void msk144_framer_destroy(Framer* f) { delete f; }

// Append raw stream bytes. Returns the number of complete windows now
// available to pop (0 or more).
int msk144_framer_push(Framer* f, const uint8_t* data, size_t nbytes) {
    f->pending.insert(f->pending.end(), data, data + nbytes);
    size_t window_bytes = f->window.size();
    size_t hop_bytes = window_bytes / 2;
    size_t need = f->primed ? hop_bytes : window_bytes;
    size_t avail = f->pending.size();
    if (avail < need) return 0;
    if (!f->primed) return 1 + (int)((avail - need) / hop_bytes);
    return (int)(avail / hop_bytes);
}

// Pop the next window into out (items_per_window items of the input dtype).
// Returns 1 on success, 0 if no complete window is buffered.
int msk144_framer_pop(Framer* f, uint8_t* out) {
    size_t window_bytes = f->window.size();
    size_t hop_bytes = window_bytes / 2;
    size_t need = f->primed ? hop_bytes : window_bytes;
    if (f->pending.size() < need) return 0;

    if (!f->primed) {
        std::memcpy(f->window.data(), f->pending.data(), window_bytes);
        f->pending.erase(f->pending.begin(), f->pending.begin() + window_bytes);
        f->primed = true;
    } else {
        // slide: second half to front, new hop to back (main.cu:283-287)
        std::memmove(f->window.data(), f->window.data() + hop_bytes, hop_bytes);
        std::memcpy(f->window.data() + hop_bytes, f->pending.data(), hop_bytes);
        f->pending.erase(f->pending.begin(), f->pending.begin() + hop_bytes);
    }
    std::memcpy(out, f->window.data(), window_bytes);
    f->windows_emitted++;
    return 1;
}

long long msk144_framer_windows_emitted(const Framer* f) {
    return f->windows_emitted;
}

// Bytes buffered but not yet framed into a window (for EOF reporting).
long long msk144_framer_pending_bytes(const Framer* f) {
    return (long long)f->pending.size();
}

// int16 audio window -> float32, scaled by 1/rms (main.cu:301-323).
// Returns the rms. n is the sample count.
float msk144_convert_int16_rms(const int16_t* in, float* out, int n) {
    double acc = 0.0;
    for (int i = 0; i < n; i++) {
        double v = (double)in[i];
        acc += v * v;
    }
    float rms = (float)std::sqrt(acc / (double)n);
    float fac = rms > 0.0f ? 1.0f / rms : 0.0f;
    for (int i = 0; i < n; i++) out[i] = (float)in[i] * fac;
    return rms;
}

// int8 IQ pairs -> interleaved float32 I/Q scaled by 1/128 (main.cu:365-371).
void msk144_convert_iq8(const int8_t* in, float* out, int n_items) {
    constexpr float kScale = 1.0f / 128.0f;
    for (int i = 0; i < n_items; i++) out[i] = (float)in[i] * kScale;
}

} // extern "C"
