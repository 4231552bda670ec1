// K5: RPN proposal decode + clip + small-box mask + exact greedy NMS, every
// (image, level) of one generate_proposals in one call.
//
// Replaces dgod_tpu/ops/pallas_proposals.py::_kernel (via fused_decode_nms).
// deltas, anchors [B,K,4] f32 and sizes [B,2] (h, w) f32 -> boxes [B,K,4]
// f32, keep [B,K] uint8, equal to ops/proposals.py::decode_nms_plain. K is
// the per-level top-k outputs concatenated; within a level the entries are
// in rank order (descending score, ties lower index first), so rank order
// is the greedy order and the scores themselves are not read. Each (image,
// level) is its own greedy NMS: no mask word ever crosses a level offset.
//
// Three launches on the caller's stream, no host sync:
//   1. decode: one thread per entry. Decode with the log(1000/16) clamp on
//      dw/dh, clip to (w, h), valid = both sides >= min_size.
//   2. mask: one 256-thread block per (64-row tile, 4 column tiles) of the
//      upper triangle of each (image, level), and no block outside it; row
//      i's bit j is set when j > i and IoU(i, j) > thr. Invalid rows are
//      skipped (never written; the scan never uses them), and a pair that
//      does not intersect is decided without the division.
//   3. scan: one 256-thread block per (image, level) decides 64 rows per
//      step over a removed set in shared memory that starts as the invalid
//      rows. Step t: warp 0 resolves the rows of tile t in order from the
//      set's word t and the tile's 64 diagonal words (row i's word t),
//      in registers and shared memory only; then every warp ORs the kept
//      rows' words for later tiles into the set, 8 independent loads per
//      lane in flight. The diagonal words of tile t+1 are loaded while
//      tile t is decided, so the scan pays about two global round trips
//      per 64 rows, not one per kept row.
//
// Bound on the H100: operations, ~14 f32 ops per IoU of a kept box with a
// later valid box of its level (a few us at the main path's shapes); bytes
// are ~50 per entry. The greedy dependency keeps the scan serial within an
// (image, level), and the bound ignores it (as K6's does); the 40 (image,
// level) scans of a batch of 8 run in parallel, one block each.
//
// Exactness: every result equals the plain version's, operation for
// operation. The decode follows box_ops.delta_decode (dx*w then + cx, no
// FMA; expf, not __expf); the IoU follows box_ops.box_iou with IEEE
// division, as the plain version does (the TPU kernel tests
// inter > thr*union, division-free, which can differ on a pair whose IoU
// rounds onto the threshold). Every operation that could contract into an
// FMA is an explicitly rounded intrinsic; build without --use_fast_math.
// NaN inputs are outside the contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int TILE = 64;
constexpr int GROUP = 4;       // column tiles per mask block
constexpr int SCAN_WARPS = 8;  // warps per scan block
constexpr float LOG_CLIP = 4.135166556742356f;  // log(1000 / 16)

struct Levels {
  int n;                               // number of levels
  int start[MAX_LEVELS + 1];           // entry offsets, start[n] == K
  long long off[MAX_LEVELS + 1];       // mask word offsets in one image
};

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// box_ops.box_iou(a, b) > thr, in the plain version's order of operations
__device__ __forceinline__ bool over(float4 a, float area_a, float4 b,
                                     float area_b, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f) return 0.0f > thr;  // the IoU is exactly 0
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thr;
}

__global__ void decode_kernel(const float4* __restrict__ deltas,
                              const float4* __restrict__ anchors,
                              const float2* __restrict__ sizes, int K,
                              long long total, float min_size,
                              float4* __restrict__ boxes,
                              uint8_t* __restrict__ valid) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= total) return;
  const float4 d = deltas[t];
  const float4 a = anchors[t];
  const float2 hw = sizes[t / K];
  const float w = __fsub_rn(a.z, a.x);
  const float h = __fsub_rn(a.w, a.y);
  const float cx = __fadd_rn(a.x, __fmul_rn(0.5f, w));
  const float cy = __fadd_rn(a.y, __fmul_rn(0.5f, h));
  const float dw = fminf(d.z, LOG_CLIP);
  const float dh = fminf(d.w, LOG_CLIP);
  const float pcx = __fadd_rn(__fmul_rn(d.x, w), cx);
  const float pcy = __fadd_rn(__fmul_rn(d.y, h), cy);
  const float pw = __fmul_rn(expf(dw), w);
  const float ph = __fmul_rn(expf(dh), h);
  const float hpw = __fmul_rn(0.5f, pw);
  const float hph = __fmul_rn(0.5f, ph);
  // clip_boxes: clamp(min=0), then minimum with the image side
  const float x1 = fminf(fmaxf(__fsub_rn(pcx, hpw), 0.0f), hw.y);
  const float y1 = fminf(fmaxf(__fsub_rn(pcy, hph), 0.0f), hw.x);
  const float x2 = fminf(fmaxf(__fadd_rn(pcx, hpw), 0.0f), hw.y);
  const float y2 = fminf(fmaxf(__fadd_rn(pcy, hph), 0.0f), hw.x);
  boxes[t] = make_float4(x1, y1, x2, y2);
  valid[t] = (__fsub_rn(x2, x1) >= min_size) & (__fsub_rn(y2, y1) >= min_size);
}

// Mask blocks of row tile rt in a level of `words` tiles: column tiles
// rt + GROUP * g + q for q < GROUP.
__device__ __forceinline__ int groups_of(int words, int rt) {
  return (words - rt + GROUP - 1) / GROUP;
}

// grid (mask block of the level's triangle, image * levels), TILE * GROUP
// threads: thread (q, r) computes the bits of row (rt * TILE + r) against
// column tile ct0 + q.
__global__ void __launch_bounds__(TILE * GROUP)
mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
            int K, Levels lv, long long img_words, float thr,
            unsigned long long* __restrict__ mask) {
  const int b = blockIdx.y / lv.n;
  const int l = blockIdx.y % lv.n;
  const int s = lv.start[l];
  const int n = lv.start[l + 1] - s;
  const int words = (n + TILE - 1) / TILE;
  int idx = blockIdx.x, rt = 0;
  while (rt < words && idx >= groups_of(words, rt)) idx -= groups_of(words, rt++);
  if (rt >= words) return;  // past this level's triangle (uniform)
  const int ct0 = rt + idx * GROUP;

  __shared__ float4 cbox[TILE * GROUP];
  __shared__ float carea[TILE * GROUP];
  const long long base = static_cast<long long>(b) * K + s;
  const int c0 = ct0 * TILE;
  if (threadIdx.x < n - c0) {
    const float4 q = boxes[base + c0 + threadIdx.x];
    cbox[threadIdx.x] = q;
    carea[threadIdx.x] = area(q);
  }
  __syncthreads();

  const int q = threadIdx.x / TILE;
  const int ct = ct0 + q;
  const int i = rt * TILE + threadIdx.x % TILE;
  // an invalid row's words are left unwritten: the scan never uses them
  if (ct >= words || i >= n || !valid[base + i]) return;
  const float4 p = boxes[base + i];
  const float pa = area(p);
  const int ncol = min(TILE, n - ct * TILE);
  unsigned long long bits = 0;
  for (int c = 0; c < ncol; ++c) {
    const int k = q * TILE + c;
    if (ct * TILE + c > i && over(p, pa, cbox[k], carea[k], thr)) bits |= 1ull << c;
  }
  mask[static_cast<long long>(b) * img_words + lv.off[l] +
       static_cast<long long>(i) * words + ct] = bits;
}

// one block of SCAN_WARPS warps per (image, level); dynamic shared memory:
// the level's removed bits (max words over the levels)
__global__ void __launch_bounds__(SCAN_WARPS * 32)
scan_kernel(const uint8_t* __restrict__ valid,
            const unsigned long long* __restrict__ mask, int K, Levels lv,
            long long img_words, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diag[TILE];
  __shared__ unsigned long long tile_kept;
  const int b = blockIdx.x / lv.n;
  const int l = blockIdx.x % lv.n;
  const int s = lv.start[l];
  const int n = lv.start[l + 1] - s;
  const int words = (n + TILE - 1) / TILE;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long base = static_cast<long long>(b) * K + s;
  const unsigned long long* m =
      mask + static_cast<long long>(b) * img_words + lv.off[l];
  // an invalid row (and a row past n) starts removed: it neither keeps nor
  // suppresses
  for (int w = warp; w < words; w += SCAN_WARPS) {
    const int i = w * TILE + lane;
    const unsigned lo = __ballot_sync(~0u, i >= n || !valid[base + i]);
    const unsigned hi =
        __ballot_sync(~0u, i + 32 >= n || !valid[base + i + 32]);
    if (lane == 0) removed[w] = (static_cast<unsigned long long>(hi) << 32) | lo;
  }
  __syncthreads();

  // warp 0: lane holds the diagonal words of rows lane and lane + 32 of
  // the next tile. An invalid row's words were never written: they are
  // loaded but never used, since the row starts removed and only a kept
  // row's words are ORed into the set.
  unsigned long long d_lo = 0, d_hi = 0;
  auto load_diag = [&](int t) {
    const int row = t * TILE + lane;
    d_lo = row < n ? m[static_cast<long long>(row) * words + t] : 0ull;
    d_hi = row + 32 < n ? m[static_cast<long long>(row + 32) * words + t]
                        : 0ull;
  };
  if (warp == 0 && words > 0) load_diag(0);
  for (int t = 0; t < words; ++t) {
    if (warp == 0) {
      diag[lane] = d_lo;
      diag[lane + 32] = d_hi;
      if (t + 1 < words) load_diag(t + 1);  // in flight while t is decided
      __syncwarp();
      // the tile's rows in rank order; every lane computes the same
      unsigned long long r = removed[t], kept = 0;
#pragma unroll
      for (int j = 0; j < TILE; ++j) {
        if (!((r >> j) & 1ull)) {
          kept |= 1ull << j;
          r |= diag[j];
        }
      }
      const int i = t * TILE + lane;
      if (i < n) keep[base + i] = (kept >> lane) & 1ull;
      if (i + 32 < n) keep[base + i + 32] = (kept >> (lane + 32)) & 1ull;
      if (lane == 0) tile_kept = kept;
    }
    __syncthreads();
    const unsigned long long kept = tile_kept;
    // warp k ORs kept rows k, k + SCAN_WARPS, ... of the tile into the
    // later words; lane over words
    for (int w = t + 1 + lane; w < words; w += 32) {
      unsigned long long acc = 0;
#pragma unroll
      for (int q = 0; q < TILE / SCAN_WARPS; ++q) {
        const int j = warp + q * SCAN_WARPS;
        if ((kept >> j) & 1ull) {
          acc |= m[(static_cast<long long>(t) * TILE + j) * words + w];
        }
      }
      if (acc) atomicOr(&removed[w], acc);
    }
    __syncthreads();
  }
}

}  // namespace

// level_start: n_levels + 1 entry offsets (level_start[n_levels] == K).
// valid [B,K] uint8 and mask (B * mask_words(level_start) words) are scratch
// the caller allocates. Returns a cudaError_t (0 on success).
extern "C" int decode_nms(const void* deltas, const void* anchors,
                          const void* sizes, int B, int K,
                          const int* level_start, int n_levels, float thr,
                          float min_size, void* boxes, void* keep,
                          void* valid, void* mask, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || level_start[0] != 0 ||
      level_start[n_levels] != K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || K == 0) return 0;
  Levels lv;
  lv.n = n_levels;
  int max_words = 0, max_groups = 0;
  long long off = 0;
  for (int l = 0; l <= n_levels; ++l) {
    lv.start[l] = level_start[l];
    lv.off[l] = off;
    if (l == n_levels) break;
    const int n = level_start[l + 1] - level_start[l];
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int words = (n + TILE - 1) / TILE;
    max_words = words > max_words ? words : max_words;
    int groups = 0;  // mask blocks of the level's upper triangle
    for (int rt = 0; rt < words; ++rt) groups += (words - rt + GROUP - 1) / GROUP;
    max_groups = groups > max_groups ? groups : max_groups;
    off += static_cast<long long>(n) * words;
  }
  const long long img_words = off;
  const size_t scan_smem = static_cast<size_t>(max_words) * 8;
  if (scan_smem > 48 * 1024 || B * n_levels > 65535)
    return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(B) * K;
  const int threads = 256;
  decode_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                  threads, 0, st>>>(
      static_cast<const float4*>(deltas), static_cast<const float4*>(anchors),
      static_cast<const float2*>(sizes), K, total, min_size,
      static_cast<float4*>(boxes), static_cast<uint8_t*>(valid));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_words == 0) return 0;
  mask_kernel<<<dim3(max_groups, B * n_levels), TILE * GROUP, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      K, lv, img_words, thr, static_cast<unsigned long long*>(mask));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<B * n_levels, SCAN_WARPS * 32, scan_smem, st>>>(
      static_cast<const uint8_t*>(valid),
      static_cast<const unsigned long long*>(mask), K, lv, img_words,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
