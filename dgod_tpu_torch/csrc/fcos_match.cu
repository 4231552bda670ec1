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
// Bound on the H100 (chip_smoke.py counts it from the run's data): the
// bytes of the anchors, the gt and the codes, or ~25 f32 compares and
// subtractions for each (image, valid gt, anchor) pair whose anchor centre
// lies within the gt's centre window (the pairs that need every test; an
// index by position could skip the rest), whichever takes longer.
//
// One block per (chunk of 256 anchors, image), one thread per anchor. The
// block compacts its image's valid gt into shared memory in ascending
// index (ballots and a scan), with their centres and (1e8 - area)
// qualities; the first 256 load before the anchors, so the loads overlap.
// Each thread then walks that list, keeping the running best quality and
// the first index attaining it (strict >, jnp.argmax's order), and never
// materialises the [G,R] plane; a pair stops at the first test it fails.
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
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 1024;  // shared memory bound on the gt per image
constexpr unsigned FULL = 0xffffffffu;

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
  __shared__ int sidx[MAX_G];
  __shared__ int swarp[WARPS];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = blockIdx.x * THREADS + tid;
  const long long gbase = static_cast<long long>(b) * G;

  // the first THREADS gt, loaded before the anchor so the loads overlap
  const bool valid0 = tid < G && valid[gbase + tid];
  const float4 gt0 =
      valid0 ? gt[gbase + tid] : make_float4(0.f, 0.f, 0.f, 0.f);

  // the anchor's planes
  const float4 a = r < R ? anchors[r] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float cx = __fmul_rn(0.5f, __fadd_rn(a.x, a.z));
  const float cy = __fmul_rn(0.5f, __fadd_rn(a.y, a.w));
  const float size = __fsub_rn(a.z, a.x);
  const float rad = __fmul_rn(radius, size);
  const float lower = r < n_first ? 0.0f : __fmul_rn(size, 4.0f);
  const float upper = r >= R - n_last ? CUDART_INF_F : __fmul_rn(size, 8.0f);

  // the image's valid gt, compacted in ascending index
  int n = 0;
  for (int g0 = 0; g0 < G; g0 += THREADS) {
    const int g = g0 + tid;
    const bool keep = g0 == 0 ? valid0 : g < G && valid[gbase + g];
    float4 q = gt0;
    if (g0 > 0) q = keep ? gt[gbase + g] : make_float4(0.f, 0.f, 0.f, 0.f);
    const unsigned ball = __ballot_sync(FULL, keep);
    if (lane == 0) swarp[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? swarp[w] : 0;
      total += swarp[w];
    }
    if (keep) {
      const int at = n + before + __popc(ball & ((1u << lane) - 1u));
      sgt[at] = q;
      sctr_x[at] = __fmul_rn(0.5f, __fadd_rn(q.x, q.z));
      sctr_y[at] = __fmul_rn(0.5f, __fadd_rn(q.y, q.w));
      // exact_area: the reference's (y1 - x1) * (y2 - y1), verbatim
      const float w = exact_area ? __fsub_rn(q.y, q.x) : __fsub_rn(q.z, q.x);
      squal[at] = __fsub_rn(1e8f, __fmul_rn(w, __fsub_rn(q.w, q.y)));
      sidx[at] = g;
    }
    n += total;
    __syncthreads();  // swarp is read before the next chunk writes it
  }
  if (r >= R) return;

  // quality is mask * (1e8 - area): an unmatched gt scores 0, which never
  // beats a running best that starts at 0
  float best = 0.0f;
  int arg = 0;
  for (int j = 0; j < n; ++j) {
    const float dx = fabsf(__fsub_rn(cx, sctr_x[j]));
    const float dy = fabsf(__fsub_rn(cy, sctr_y[j]));
    if (!(fmaxf(dx, dy) < rad)) continue;
    const float4 q = sgt[j];
    const float d1 = __fsub_rn(cx, q.x);
    const float d2 = __fsub_rn(cy, q.y);
    const float d3 = __fsub_rn(q.z, cx);
    const float d4 = __fsub_rn(q.w, cy);
    if (!(fminf(fminf(d1, d2), fminf(d3, d4)) > 0.0f)) continue;
    const float max_d = fmaxf(fmaxf(d1, d2), fmaxf(d3, d4));
    if (!(max_d > lower && max_d < upper)) continue;
    const float quality = squal[j];
    if (quality > best) {  // strict: the first index wins among equal maxima
      best = quality;
      arg = sidx[j];
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
