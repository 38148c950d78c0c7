// Host-side native kernels for the sspv_tpu runtime.
//
// The reference is pure Python (SURVEY.md §2: "Native components: NONE"), so
// there is no parity obligation here; this library accelerates the only
// host-side hot path the device design leaves: preparing raw int16 capture
// buffers as float32 frame blocks for device upload (the engine's framing
// step, sspv_tpu/runtime/engine.py::_take_frames). NumPy does this with a
// fancy-index gather (two passes + an intermediate int16 matrix); here it is
// one fused pass: gather + int16→float32 convert (+ optional window).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>

extern "C" {

// Slice `n` int16 samples into `num_frames` overlapping frames of
// `frame_size` with `hop` step, converting to float32. `out` must hold
// num_frames*frame_size floats. Returns the number of frames written.
int64_t sspv_frame_i16_to_f32(const int16_t* in, int64_t n,
                              int32_t frame_size, int32_t hop,
                              float* out) {
  if (frame_size <= 0 || hop <= 0 || n < frame_size) return 0;
  const int64_t num_frames = 1 + (n - frame_size) / hop;
  for (int64_t f = 0; f < num_frames; ++f) {
    const int16_t* src = in + f * hop;
    float* dst = out + f * frame_size;
    for (int32_t i = 0; i < frame_size; ++i) dst[i] = (float)src[i];
  }
  return num_frames;
}

// Same, but fused with a window multiply (for consumers that want
// pre-windowed frames host-side).
int64_t sspv_frame_i16_to_f32_windowed(const int16_t* in, int64_t n,
                                       int32_t frame_size, int32_t hop,
                                       const float* window, float* out) {
  if (frame_size <= 0 || hop <= 0 || n < frame_size) return 0;
  const int64_t num_frames = 1 + (n - frame_size) / hop;
  for (int64_t f = 0; f < num_frames; ++f) {
    const int16_t* src = in + f * hop;
    float* dst = out + f * frame_size;
    for (int32_t i = 0; i < frame_size; ++i)
      dst[i] = (float)src[i] * window[i];
  }
  return num_frames;
}

}  // extern "C"
