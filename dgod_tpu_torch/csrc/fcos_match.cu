// K4: the FCOS centre-sampling matcher over a batch.
//
// Replaces dgod_tpu/ops/pallas_matchers.py::_fcos_match_kernel (via
// fcos_match_tpu). anchors [R,4] f32 (all levels, the first `n_first` of the
// first level, the last `n_last` of the last), gt [B,G,4] f32, valid [B,G]
// bool -> matched [B,R] int32 in [-1, G), equal to matchers.fcos_match.
//
// Each thread first derives its anchor's planes as fcos_match_tpu and
// matchers.fcos_match do: centre 0.5 * (x1 + x2), 0.5 * (y1 + y2);
// size x2 - x1; radius * size; lower 4 * size (0 on the first level);
// upper 8 * size (infinity on the last level). An anchor matches a valid gt
// when its centre lies within the radius of the gt centre (Chebyshev),
// strictly inside the gt, and its largest distance to the gt's edges inside
// (lower, upper); the smallest area wins (argmax of 1e8 - area, first index
// among equal maxima), and a best below 1e-5 means no match.
//
// Bound on the H100: operations. The inputs and output are under a MB, but
// every (image, valid gt, anchor) pair needs up to ~25 f32 compares and
// subtractions: 8 x 128 x 15,402 pairs at train shapes, a few microseconds
// of the card's f32 rate. At that size the launch itself dominates.
//
// One block per (anchor chunk, image), one thread per anchor. The image's
// gt, their centres, validity and (1e8 - area) qualities are staged once in
// shared memory; every thread of a warp then reads the same gt (broadcast).
// Each thread keeps the running best quality and the first index attaining
// it (strict >, jnp.argmax's order) and never materialises the [G,R] plane;
// a pair stops at the first test it fails.
//
// Rounding: 1e8 - area has an ulp of 8 in f32, so the area must be rounded
// to f32 before the subtraction, as the plain version and XLA round it. nvcc
// would contract (x2-x1)*(y2-y1) and 1e8 - ... into one FMA, so every
// product, sum and difference here is an explicitly rounded intrinsic.
// Build without --use_fast_math. NaN or infinite coordinates are outside
// the contract.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_G = 1024;  // shared memory bound on the gt per image

__global__ void __launch_bounds__(THREADS)
fcos_match_kernel(const float4* __restrict__ gt,
                  const uint8_t* __restrict__ valid,
                  const float4* __restrict__ anchors, int* __restrict__ out,
                  int G, int R, int n_first, int n_last, float radius,
                  int exact_area) {
  __shared__ float4 sgt[MAX_G];
  __shared__ float sctr_x[MAX_G];
  __shared__ float sctr_y[MAX_G];
  __shared__ float squal[MAX_G];
  __shared__ uint8_t svalid[MAX_G];
  const int b = blockIdx.y;
  const long long gbase = static_cast<long long>(b) * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float4 q = gt[gbase + g];
    sgt[g] = q;
    svalid[g] = valid[gbase + g];
    sctr_x[g] = __fmul_rn(0.5f, __fadd_rn(q.x, q.z));
    sctr_y[g] = __fmul_rn(0.5f, __fadd_rn(q.y, q.w));
    // exact_area: the reference's (y1 - x1) * (y2 - y1), verbatim
    const float w = exact_area ? __fsub_rn(q.y, q.x) : __fsub_rn(q.z, q.x);
    const float area = __fmul_rn(w, __fsub_rn(q.w, q.y));
    squal[g] = __fsub_rn(1e8f, area);
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float4 a = anchors[r];
  const float cx = __fmul_rn(0.5f, __fadd_rn(a.x, a.z));
  const float cy = __fmul_rn(0.5f, __fadd_rn(a.y, a.w));
  const float size = __fsub_rn(a.z, a.x);
  const float rad = __fmul_rn(radius, size);
  const float lower = r < n_first ? 0.0f : __fmul_rn(size, 4.0f);
  const float upper = r >= R - n_last ? CUDART_INF_F : __fmul_rn(size, 8.0f);
  // quality is mask * (1e8 - area): an unmatched gt scores 0, which never
  // beats a running best that starts at 0
  float best = 0.0f;
  int arg = 0;
  for (int g = 0; g < G; ++g) {
    if (!svalid[g]) continue;
    const float dx = fabsf(__fsub_rn(cx, sctr_x[g]));
    const float dy = fabsf(__fsub_rn(cy, sctr_y[g]));
    if (!(fmaxf(dx, dy) < rad)) continue;
    const float4 q = sgt[g];
    const float d1 = __fsub_rn(cx, q.x);
    const float d2 = __fsub_rn(cy, q.y);
    const float d3 = __fsub_rn(q.z, cx);
    const float d4 = __fsub_rn(q.w, cy);
    if (!(fminf(fminf(d1, d2), fminf(d3, d4)) > 0.0f)) continue;
    const float max_d = fmaxf(fmaxf(d1, d2), fmaxf(d3, d4));
    if (!(max_d > lower && max_d < upper)) continue;
    const float quality = squal[g];
    if (quality > best) {  // strict: the first index wins among equal maxima
      best = quality;
      arg = g;
    }
  }
  out[static_cast<long long>(b) * R + r] = best < 1e-5f ? -1 : arg;
}

}  // namespace

extern "C" int fcos_match(const void* gt, const void* valid,
                          const void* anchors, void* out, int B, int G, int R,
                          int n_first, int n_last, float radius,
                          int exact_area, void* stream) {
  if (G > MAX_G || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((R + THREADS - 1) / THREADS, B);
  fcos_match_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float4*>(gt), static_cast<const uint8_t*>(valid),
      static_cast<const float4*>(anchors), static_cast<int*>(out), G, R,
      n_first, n_last, radius, exact_area);
  return static_cast<int>(cudaGetLastError());
}
