// Host-side image prep for the port's data path (its own copy of the fused
// resize + flip + pad of native/dgod_native.cpp).
//
// One pass per image: bilinear resize -> optional horizontal flip ->
// placement on the static canvas, uint8 RGB throughout (normalisation runs
// on the device). Replaces the reference's OpenCV resize and albumentations
// chain (DrivingDataset.py:35-36, train_driving_dg.py:125-142) where cv2 is
// not installed. Built with g++ into dgod_tpu_torch/_build at first use and
// bound with ctypes (dgod_tpu_torch/data/native.py); it releases the GIL
// for the loader's worker threads, as ctypes calls do.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Separable fixed-point bilinear resize, uint8 RGB (OpenCV INTER_LINEAR
// semantics: half-pixel centres, edge clamp; 11-bit weights per pass like
// cv2's INTER_RESIZE_COEF_BITS, so results match cv2 to +/-1 LSB).
//
// The horizontal pass gathers each source row into an int32 row buffer,
// cached across consecutive output rows that share it; the vertical pass is
// a branch-free blend. The flip is folded into the x coefficient table, and
// the result lands in the (ch, cw) canvas with zeroed padding.
constexpr int kCoefBits = 11;
constexpr int kCoefOne = 1 << kCoefBits;  // 2048

struct HCoef {
  int x0, x1;
  int32_t w0, w1;
};

void hresize_row(const uint8_t* src_row, const HCoef* cx, int dw,
                 int32_t* out) {
  for (int x = 0; x < dw; ++x) {
    const uint8_t* p0 = src_row + cx[x].x0 * 3;
    const uint8_t* p1 = src_row + cx[x].x1 * 3;
    const int32_t w0 = cx[x].w0, w1 = cx[x].w1;
    out[x * 3 + 0] = p0[0] * w0 + p1[0] * w1;
    out[x * 3 + 1] = p0[1] * w0 + p1[1] * w1;
    out[x * 3 + 2] = p0[2] * w0 + p1[2] * w1;
  }
}

void resize_into_canvas(const uint8_t* src, int sh, int sw, uint8_t* canvas,
                        int cw, int rh, int rw, bool flip) {
  const double scale_y = static_cast<double>(sh) / rh;
  const double scale_x = static_cast<double>(sw) / rw;

  std::vector<HCoef> cx(rw);
  for (int x = 0; x < rw; ++x) {
    const int xx = flip ? rw - 1 - x : x;
    double fx = (xx + 0.5) * scale_x - 0.5;
    int x0 = static_cast<int>(std::floor(fx));
    double wx = fx - x0;
    if (x0 < 0) { x0 = 0; wx = 0.0; }
    int x1 = std::min(x0 + 1, sw - 1);
    x0 = std::min(x0, sw - 1);
    int32_t w1 = static_cast<int32_t>(wx * kCoefOne + 0.5);
    cx[x] = {x0, x1, kCoefOne - w1, w1};
  }

  const size_t row_elems = static_cast<size_t>(rw) * 3;
  std::vector<int32_t> buf0(row_elems), buf1(row_elems);
  int32_t* bufs[2] = {buf0.data(), buf1.data()};
  int cached[2] = {-1, -1};

  auto hrow = [&](int sy) -> const int32_t* {
    if (cached[0] == sy) return bufs[0];
    if (cached[1] == sy) return bufs[1];
    // evict the older (smaller) row: rows arrive in increasing order
    const int slot = (cached[0] <= cached[1]) ? 0 : 1;
    hresize_row(src + static_cast<size_t>(sy) * sw * 3, cx.data(), rw,
                bufs[slot]);
    cached[slot] = sy;
    return bufs[slot];
  };

  const int pad_bytes = (cw - rw) * 3;
  for (int y = 0; y < rh; ++y) {
    double fy = (y + 0.5) * scale_y - 0.5;
    int y0 = static_cast<int>(std::floor(fy));
    double wy = fy - y0;
    if (y0 < 0) { y0 = 0; wy = 0.0; }
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::min(y0, sh - 1);
    const int32_t wy1 = static_cast<int32_t>(wy * kCoefOne + 0.5);
    const int32_t wy0 = kCoefOne - wy1;

    const int32_t* r0 = hrow(y0);
    const int32_t* r1 = (y1 == y0) ? r0 : hrow(y1);
    uint8_t* out = canvas + static_cast<size_t>(y) * cw * 3;
    constexpr int32_t kRound = 1 << (2 * kCoefBits - 1);
    for (size_t i = 0; i < row_elems; ++i) {
      // max: 255*2048*2048 < 2^31
      int32_t v = (r0[i] * wy0 + r1[i] * wy1 + kRound) >> (2 * kCoefBits);
      out[i] = static_cast<uint8_t>(v > 255 ? 255 : v);
    }
    if (pad_bytes > 0) std::memset(out + row_elems, 0, pad_bytes);
  }
}

}  // namespace

extern "C" {

// Resize (sh, sw) -> (rh, rw), optional horizontal flip, written into a
// zeroed (ch, cw) canvas at the top-left. All uint8 HWC RGB; the caller
// guarantees 1 <= rh <= ch and 1 <= rw <= cw.
void dgod_prepare_image(const uint8_t* src, int sh, int sw, uint8_t* canvas,
                        int ch, int cw, int rh, int rw, int flip) {
  resize_into_canvas(src, sh, sw, canvas, cw, rh, rw, flip != 0);
  if (rh < ch) {
    std::memset(canvas + static_cast<size_t>(rh) * cw * 3, 0,
                static_cast<size_t>(ch - rh) * cw * 3);
  }
}

}  // extern "C"
