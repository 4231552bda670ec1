// K1 / K2: multi-scale RoIAlign forward and backward over P2..P5.
//
// Replaces dgod_tpu/ops/pallas_roi_align.py: K1 = _fwd_kernel and
// _fwd_kernel_deep (via _roi_align_fwd), K2 = _bwd_kernel and
// _bwd_kernel_deep (via _roi_align_bwd). Semantics are those of
// dgod_tpu/ops/roi_align.py (torchvision MultiScaleRoIAlign, 7x7,
// sampling_ratio 2, aligned=False): the FPN level is
// floor(4 + log2(sqrt(area)/224 + 1e-6)) clamped to the 4 levels; sample
// points outside [-1, size] count 0; coordinates clamp at 0; the high
// corner clamps at size-1 with its weight forced to 0 at the edge.
//
// Layouts: features are NHWC [B, H_l, W_l, C] (bf16 or f32), rois [B,N,4]
// f32 xyxy in image pixels, pooled [B,N,7,7,C] f32, level grads [B,H_l,W_l,C]
// in the feature dtype, the four levels back to back in one buffer.
//
// Both are bound by bytes on the H100. Each RoI's level and its 14 sample
// coordinates per axis (lo/hi cell and weight, the out-of-range mask folded
// into the weights) are computed exactly as the plain version's geometry,
// with explicitly rounded intrinsics so no FMA contraction moves a sample
// across a cell boundary.
//
// The forward writes B*N*49*C f32 (205 MB at B=8, N=512, C=256) and reads
// each RoI's window of cells. A warp covers a whole NHWC cell with 16-byte
// loads (8 bf16 or 4 f32 channels per lane: 512 bytes of a 256-channel
// bf16 cell in one load instruction) and pools one bin row of a RoI: for
// each of its 7 bins it issues the bin's 16 corner loads (2x2 samples x 4
// corners) before their multiply-adds, and writes the bin's f32 channels
// with 16-byte streaming stores (the output is 4x the 50 MB L2). Every
// corner is loaded: its cell is clamped into the level, and a corner of
// weight 0 (a sample out of range, a clamped edge) adds 0, as in the plain
// version; a predicated load would cost a zero-fill per corner. A block
// of 8 warps takes 2 consecutive RoIs: warps 0-6 pool the current RoI's 7
// bin rows while warp 7 computes the next RoI's geometry into the other
// half of a double buffer, so one barrier per RoI follows the pooling and
// no warp waits for a geometry in front of its work. Each bin is summed in
// one fixed order: samples (sy, sx) row-major, per sample the corners
// (y lo, x lo), (y lo, x hi), (y hi, x lo), (y hi, x hi), each added to an
// f32 sum that starts at 0 as one fused multiply-add of its weight wy*wx
// (rounded) and the cell's value; the sum is then scaled by 1/4. (The
// kernel folds the 1/4 into wy: scaling by a power of two commutes with
// every rounding here, so the bits are the same.)
//
// The backward must read the pooled gradient (205 MB f32) and write the
// level grads once (251 MB in bf16 at B=8). It is output-stationary, in
// two launches, with no accumulator in device memory and no atomics:
//   1. geometry: one warp per RoI stores its level, its sample geometry
//      and, per axis, a 64-bit mask of the output tiles whose rows
//      (columns) a sample corner of non-zero weight touches. The cells a
//      RoI touches are the product of its touched rows and touched
//      columns, so a tile receives gradient from a RoI exactly when both
//      masks have its bit: a sliver that spans the level marks only the
//      tiles under its samples, not its bounding window.
//   2. gather: one 128-thread block per (image, level, 8x8-cell tile) and
//      256 channels keeps the tile's f32 sums in shared memory (64 KB;
//      each thread owns two channels of every cell, so the adds need no
//      synchronisation). It filters its image's RoIs 512 at a time (four
//      independent mask loads per thread) and keeps those whose masks hit
//      the tile, in ascending index. A bin's gradient g is shared by its
//      2x2 samples, so the bin adds g/4 * Wy[y] * Wx[x] to cell (y, x),
//      Wy summing the weights of its y samples' corners per row and Wx per
//      column: warp 0 stages, per bin row and column, the at most 4 cells
//      of the tile they reach with those sums, and the block adds them for
//      the bins that reach the tile, loading their gradient 8 bins at a
//      time. It then writes the whole tile once in the feature dtype with
//      16-byte stores, the zeros of untouched cells included.
// On the card the gather is held back by its shared-memory adds and by the
// latency of each (RoI, tile) pair (the RoI's geometry, then its
// gradient), not by device memory. The factorised adds are about half the
// per-corner ones, warp 0 loads the next RoI's geometry while the block
// adds the current one, and the coarsest level's tiles, which gather the
// most RoIs each, are dispatched first, so that none of them starts last.
// Each cell's sum is taken in one fixed order (RoI index, then bin, then
// row and column entry), so two calls on the same inputs give the same
// bits. With more than 64 tiles along an axis, a mask bit stands for a run
// of tiles: the filter then lets through RoIs that add nothing, and the
// result is the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 7;        // output bins per axis
constexpr int S = 2;        // sampling ratio
constexpr int PS = P * S;   // sample points per axis
constexpr int LEVELS = 4;   // P2..P5
constexpr int FWD_WARPS = P + 1;  // K1: a warp per bin row, a geometry warp
constexpr int FWD_THREADS = 32 * FWD_WARPS;
constexpr int FWD_ROIS = 2;       // K1: consecutive RoIs per block
constexpr int CORNERS = 4 * S * S;  // K1: a bin's corner loads
constexpr int TH = 8;       // K2 tile rows (cells)
constexpr int TW = 8;       // K2 tile columns
constexpr int CS = 256;     // K2 channels per block
constexpr int THREADS = CS / 2;  // K2 threads per block, two channels each
constexpr int MASK_BITS = 64;

struct Levels {
  const void* feat[LEVELS];
  void* grad[LEVELS];
  int h[LEVELS];
  int w[LEVELS];
  float scale[LEVELS];  // 1 / stride
  // K2's tiles: per image, level l's tiles are [tile0[l], tile0[l + 1])
  int tiles_x[LEVELS];
  int tile0[LEVELS + 1];
  int per_y[LEVELS];    // tiles per mask bit, rows / columns
  int per_x[LEVELS];
};

struct Geometry {
  int lvl;
  int lo[2][PS];     // [axis y=0 / x=1][sample]
  int hi[2][PS];
  float wlo[2][PS];  // 0 where the sample is out of range
  float whi[2][PS];
};

struct TileMask {    // K2: the tiles of its level a RoI adds into
  unsigned long long rows;
  unsigned long long cols;
  int lvl;
};

// Fills g (shared) for the RoI `box`: thread t < 2 * PS computes sample
// t % PS of axis t / PS, thread 0 stores the level. No sync.
__device__ __forceinline__ void sample_geometry(const Levels& L, float4 box,
                                                int t, Geometry& g) {
  const float rx1 = box.x;
  const float ry1 = box.y;
  const float rx2 = box.z;
  const float ry2 = box.w;
  const float area =
      fmaxf(__fmul_rn(__fsub_rn(rx2, rx1), __fsub_rn(ry2, ry1)), 0.0f);
  const float k = floorf(__fadd_rn(
      4.0f, log2f(__fadd_rn(__fdiv_rn(sqrtf(area), 224.0f), 1e-6f))));
  const int lvl = static_cast<int>(fminf(fmaxf(k - 2.0f, 0.0f), 3.0f));
  const float scale = L.scale[lvl];
  if (t == 0) g.lvl = lvl;
  if (t < 2 * PS) {
    const int axis = t / PS;  // 0: y, 1: x
    const int i = t % PS;
    const float c1 = __fmul_rn(axis ? rx1 : ry1, scale);
    const float c2 = __fmul_rn(axis ? rx2 : ry2, scale);
    const int size = axis ? L.w[lvl] : L.h[lvl];
    const float bin = __fdiv_rn(fmaxf(__fsub_rn(c2, c1), 1.0f),
                                static_cast<float>(P));
    const float step = static_cast<float>(i / S) + (i % S + 0.5f) / S;
    const float coord = __fadd_rn(c1, __fmul_rn(step, bin));
    const bool ok = !(coord < -1.0f || coord > static_cast<float>(size));
    const float c = fmaxf(coord, 0.0f);
    int lo = static_cast<int>(floorf(c));
    const bool at_edge = lo >= size - 1;
    lo = min(lo, size - 1);
    const int hi = min(lo + 1, size - 1);
    const float frac = at_edge ? 0.0f : __fsub_rn(c, static_cast<float>(lo));
    g.lo[axis][i] = lo;
    g.hi[axis][i] = hi;
    g.wlo[axis][i] = ok ? __fsub_rn(1.0f, frac) : 0.0f;
    g.whi[axis][i] = ok ? frac : 0.0f;
  }
}

// Fills g (shared) for RoI `roi`; all threads call it, then sync.
__device__ void roi_geometry(const Levels& L, const float* __restrict__ rois,
                             int roi, Geometry& g) {
  sample_geometry(L,
                  make_float4(rois[roi * 4 + 0], rois[roi * 4 + 1],
                              rois[roi * 4 + 2], rois[roi * 4 + 3]),
                  threadIdx.x, g);
  __syncthreads();
}

// K1: 16 bytes of features (VEC channels) as floats
__device__ __forceinline__ void widen(const uint4& v, float* x, float) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4& v, float* x,
                                      __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address is the low half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// K1: one warp pools bin row py of a RoI at its level's features f (image
// base, W cells per row) into o (the RoI's [7, 7, C] f32 output). Lane l
// takes the 16-byte channel vectors l, l + 32, ... of every cell.
template <typename T>
__device__ __forceinline__ void pool_row(const Geometry& g,
                                         const T* __restrict__ f, int W,
                                         float* __restrict__ o, int C, int py,
                                         int lane) {
  constexpr int VEC = 16 / sizeof(T);
  // the row's corners: [sample sy][lo, hi] -> index 2 * sy + a
  const T* rows[2 * S];
  float wy[2 * S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int iy = py * S + s;
    rows[2 * s] = f + static_cast<size_t>(g.lo[0][iy]) * W * C;
    rows[2 * s + 1] = f + static_cast<size_t>(g.hi[0][iy]) * W * C;
    wy[2 * s] = g.wlo[0][iy] * (1.0f / (S * S));  // the bin mean's 1/4
    wy[2 * s + 1] = g.whi[0][iy] * (1.0f / (S * S));
  }
  const int n_vec = C / VEC;
  for (int px = 0; px < P; ++px) {
    int cols[2 * S];
    float wx[2 * S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int ix = px * S + s;
      cols[2 * s] = g.lo[1][ix] * C;
      cols[2 * s + 1] = g.hi[1][ix] * C;
      wx[2 * s] = g.wlo[1][ix];
      wx[2 * s + 1] = g.whi[1][ix];
    }
    // corner k = ((sy * S + sx) * 2 + a) * 2 + b: row 2 * sy + a, column
    // 2 * sx + b, the bin's fixed summation order
    float w[CORNERS];
    int ry[CORNERS], cx[CORNERS];
#pragma unroll
    for (int k = 0; k < CORNERS; ++k) {
      const int sy = k / 8, sx = (k / 4) % 2, a = (k / 2) % 2, b = k % 2;
      ry[k] = 2 * sy + a;
      cx[k] = 2 * sx + b;
      w[k] = __fmul_rn(wy[ry[k]], wx[cx[k]]);
    }
    float* dst = o + (py * P + px) * C;
    for (int v = lane; v < n_vec; v += 32) {
      uint4 raw[CORNERS];
#pragma unroll
      for (int k = 0; k < CORNERS; ++k) {
        raw[k] = __ldg(reinterpret_cast<const uint4*>(rows[ry[k]] +
                                                      cols[cx[k]] + v * VEC));
      }
      float acc[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int k = 0; k < CORNERS; ++k) {
        float x[VEC];
        widen(raw[k], x, T());
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] = fmaf(w[k], x[c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < VEC; c += 4) {
        __stcs(reinterpret_cast<float4*>(dst + v * VEC + c),
               make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]));
      }
    }
  }
}

// K1: grid ceil(B*N / FWD_ROIS), FWD_THREADS threads. rois 16-byte
// aligned; C a multiple of 16 / sizeof(T); every level 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
fwd_kernel(Levels L, const float4* __restrict__ rois, float* __restrict__ out,
           int n_rois, int N, int C) {
  __shared__ Geometry geo[2];  // the current RoI's and the next one's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = blockIdx.x * FWD_ROIS;
  const int count = min(FWD_ROIS, n_rois - first);
  float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (warp == P) {
    sample_geometry(L, rois[first], lane, geo[0]);
    if (count > 1) next = rois[first + 1];
  }
  __syncthreads();
  for (int k = 0; k < count; ++k) {
    if (warp == P) {
      // the next RoI's geometry while warps 0..6 pool this one
      if (k + 1 < count) {
        sample_geometry(L, next, lane, geo[(k + 1) & 1]);
        if (k + 2 < count) next = rois[first + k + 2];
      }
    } else {
      const Geometry& g = geo[k & 1];
      const int roi = first + k;
      const int lvl = g.lvl;
      const int H = L.h[lvl], W = L.w[lvl];
      const T* f = static_cast<const T*>(L.feat[lvl]) +
                   static_cast<size_t>(roi / N) * H * W * C;
      pool_row<T>(g, f, W, out + static_cast<size_t>(roi) * P * P * C, C,
                  warp, lane);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned hi = __reduce_or_sync(~0u, static_cast<unsigned>(v >> 32));
  const unsigned lo = __reduce_or_sync(~0u, static_cast<unsigned>(v));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// K2 pass 1: one warp per RoI -> its geometry and tile masks.
__global__ void __launch_bounds__(32)
bwd_geometry_kernel(Levels L, const float* __restrict__ rois,
                    Geometry* __restrict__ geo, TileMask* __restrict__ masks) {
  __shared__ Geometry g;
  const int roi = blockIdx.x;
  roi_geometry(L, rois, roi, g);
  const int t = threadIdx.x;
  const int lvl = g.lvl;
  unsigned long long bits = 0;
  if (t < 2 * PS) {
    const int axis = t / PS;
    const int i = t % PS;
    const int tile = axis ? TW : TH;
    const int per = axis ? L.per_x[lvl] : L.per_y[lvl];
    if (g.wlo[axis][i] != 0.0f) bits |= 1ull << (g.lo[axis][i] / tile / per);
    if (g.whi[axis][i] != 0.0f) bits |= 1ull << (g.hi[axis][i] / tile / per);
  }
  const unsigned long long rows = warp_or(t < PS ? bits : 0ull);
  const unsigned long long cols = warp_or(t < PS ? 0ull : bits);
  if (t == 0) masks[roi] = TileMask{rows, cols, lvl};
  const int* src = reinterpret_cast<const int*>(&g);
  int* dst = reinterpret_cast<int*>(geo + roi);
  for (int k = t; k < static_cast<int>(sizeof(Geometry) / 4); k += 32) {
    dst[k] = src[k];
  }
}

// 16-byte stores of the tile's sums in the output dtype
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
      pack_bf16(b.z, b.w));
}
__device__ __forceinline__ void store_one(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// K2: what one RoI adds to one tile. A bin's gradient g is shared by its
// S x S samples, so the bin adds g/4 * Wy[y] * Wx[x] to cell (y, x), where
// Wy[y] sums the weights of the bin's y samples' corners at row y (Wx the
// same for columns): per bin row and column at most 4 cells of the tile.
struct __align__(16) Corners {
  int cell[2][P][4];   // [axis y=0 / x=1][bin row / column][entry]
  float w[2][P][4];    // summed sample weights of those cells
  int bins[P * P];     // reached bins, ascending: bin | ny << 8 | nx << 12
  int n_bins;
};

struct Samples {       // one bin row's (column's) two samples
  int lo[S], hi[S];
  float wlo[S], whi[S];
};

// warp 0: lane axis * P + p < 2 * P starts loading the samples of bin row
// (axis 0) or column (axis 1) p of a RoI's geometry
__device__ __forceinline__ Samples fetch(const Geometry* __restrict__ geo,
                                         size_t roi, int lane) {
  Samples s{};
  if (lane < 2 * P) {
    const int axis = lane / P, p = lane % P;
    const Geometry& g = geo[roi];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s.lo[k] = g.lo[axis][p * S + k];
      s.hi[k] = g.hi[axis][p * S + k];
      s.wlo[k] = g.wlo[axis][p * S + k];
      s.whi[k] = g.whi[axis][p * S + k];
    }
  }
  return s;
}

// warp 0: the fetched samples' corners in tile coordinates, equal cells
// merged in a fixed order (sample 0 lo, hi, sample 1 lo, hi), corners of
// zero weight or outside the tile dropped; then the bins whose row and
// column both reach the tile
__device__ __forceinline__ void stage(Corners& c, const Samples& s, int lane,
                                      int oy, int ox) {
  int n = 0;
  if (lane < 2 * P) {
    const int axis = lane / P, p = lane % P;
    const int origin = axis ? ox : oy, extent = axis ? TW : TH;
    int cells[4] = {0, 0, 0, 0};
    float ws[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 2 * S; ++k) {
      const int cell = (k % 2 ? s.hi[k / 2] : s.lo[k / 2]) - origin;
      const float w = k % 2 ? s.whi[k / 2] : s.wlo[k / 2];
      if (w == 0.0f || cell < 0 || cell >= extent) continue;
      bool merged = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < n && cells[e] == cell) {
          ws[e] += w;
          merged = true;
        }
      }
      if (merged) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e == n) {
          cells[e] = cell;
          ws[e] = w;
        }
      }
      ++n;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c.cell[axis][p][e] = cells[e];
      c.w[axis][p][e] = ws[e];
    }
  }
  int count = 0;
  for (int bin = lane; bin < 64; bin += 32) {
    const int ny = __shfl_sync(~0u, n, min(bin / P, P - 1));
    const int nx = __shfl_sync(~0u, n, P + bin % P);
    const bool reach = bin < P * P && ny > 0 && nx > 0;
    const unsigned v = __ballot_sync(~0u, reach);
    if (reach) {
      c.bins[count + __popc(v & ((1u << lane) - 1))] = bin | ny << 8 | nx << 12;
    }
    count += __popc(v);
  }
  if (lane == 0) c.n_bins = count;
}

// one thread's two channels: what the RoI adds to each cell of the tile,
// bin by bin, the gradient of GATHER bins loaded at once. go: the RoI's
// gradient at the thread's first channel; `even`: C is even, so the pair
// is one 8-byte load (else the second channel is loaded alone, or is 0 past
// C).
constexpr int GATHER = 8;

__device__ __forceinline__ void accumulate(float2* mine, const Corners& c,
                                           const float* go, int C, bool even,
                                           bool second) {
  for (int k0 = 0; k0 < c.n_bins; k0 += GATHER) {
    float2 gq[GATHER];
#pragma unroll
    for (int q = 0; q < GATHER; ++q) {
      float2 v = make_float2(0.0f, 0.0f);
      if (k0 + q < c.n_bins) {
        const float* p = go + (c.bins[k0 + q] & 63) * C;
        v = even ? *reinterpret_cast<const float2*>(p)
                 : make_float2(p[0], second ? p[1] : 0.0f);
      }
      gq[q] = make_float2(v.x * (1.0f / (S * S)), v.y * (1.0f / (S * S)));
    }
#pragma unroll
    for (int q = 0; q < GATHER; ++q) {
      if (k0 + q >= c.n_bins) break;
      const int packed = c.bins[k0 + q];
      const int py = (packed & 63) / P, px = (packed & 63) % P;
      const int ny = (packed >> 8) & 15, nx = packed >> 12;
      const int4 yc = *reinterpret_cast<const int4*>(c.cell[0][py]);
      const float4 yw = *reinterpret_cast<const float4*>(c.w[0][py]);
      const int4 xc = *reinterpret_cast<const int4*>(c.cell[1][px]);
      const float4 xw = *reinterpret_cast<const float4*>(c.w[1][px]);
      const int ycs[4] = {yc.x, yc.y, yc.z, yc.w};
      const float yws[4] = {yw.x, yw.y, yw.z, yw.w};
      const int xcs[4] = {xc.x, xc.y, xc.z, xc.w};
      const float xws[4] = {xw.x, xw.y, xw.z, xw.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (a >= ny) break;
        const float2 wg = make_float2(yws[a] * gq[q].x, yws[a] * gq[q].y);
        float2* row = mine + ycs[a] * TW * THREADS;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e >= nx) break;
          float2& m = row[xcs[e] * THREADS];
          m.x += wg.x * xws[e];
          m.y += wg.y * xws[e];
        }
      }
    }
  }
}

constexpr int FILTER = 4;  // RoIs each thread filters per pass

constexpr int ACC_BYTES = TH * TW * CS * 4;  // the tile's f32 sums

// K2 pass 2: grid (every tile of every image, slices of CS channels),
// THREADS threads, ACC_BYTES of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
bwd_gather_kernel(Levels L, const Geometry* __restrict__ geo,
                  const TileMask* __restrict__ masks,
                  const float* __restrict__ grad_out, int N, int C) {
  extern __shared__ float4 dynamic[];
  float* acc = reinterpret_cast<float*>(dynamic);  // [cell][channel]
  __shared__ int list[FILTER * THREADS];
  __shared__ int warp_hits[FILTER][THREADS / 32];
  __shared__ Corners corners[2];  // the current RoI's and the next one's

  // the coarsest level's tiles first, of every image: they gather the most
  // RoIs each, and started last they would leave the card idle behind them
  const int B = gridDim.x / L.tile0[LEVELS];
  int lvl = LEVELS - 1, idx = blockIdx.x;
  while (lvl > 0 && idx >= B * (L.tile0[lvl + 1] - L.tile0[lvl])) {
    idx -= B * (L.tile0[lvl + 1] - L.tile0[lvl]);
    --lvl;
  }
  const int b = idx / (L.tile0[lvl + 1] - L.tile0[lvl]);
  const int tile = idx % (L.tile0[lvl + 1] - L.tile0[lvl]);
  const int ty = tile / L.tiles_x[lvl];
  const int tx = tile % L.tiles_x[lvl];
  const int H = L.h[lvl], W = L.w[lvl];
  const int oy = ty * TH, ox = tx * TW;
  const unsigned long long ybit = 1ull << (ty / L.per_y[lvl]);
  const unsigned long long xbit = 1ull << (tx / L.per_x[lvl]);
  const int c0 = blockIdx.y * CS;
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const bool live = c0 + 2 * t < C;
  const bool even = C % 2 == 0, second = c0 + 2 * t + 1 < C;
  const size_t roi0 = static_cast<size_t>(b) * N;

  // this thread's two channels of every cell
  float2* mine = reinterpret_cast<float2*>(acc) + t;
  for (int cell = 0; cell < TH * TW; ++cell) {
    mine[cell * THREADS] = make_float2(0.0f, 0.0f);
  }

  for (int first = 0; first < N; first += FILTER * THREADS) {
    // the RoIs of this pass whose masks hit the tile, in ascending index
    bool hit[FILTER];
#pragma unroll
    for (int q = 0; q < FILTER; ++q) {
      const int r = first + q * THREADS + t;
      hit[q] = false;
      if (r < N) {
        const TileMask m = masks[roi0 + r];
        hit[q] = m.lvl == lvl && (m.rows & ybit) && (m.cols & xbit);
      }
    }
    unsigned ballot[FILTER];
#pragma unroll
    for (int q = 0; q < FILTER; ++q) {
      ballot[q] = __ballot_sync(~0u, hit[q]);
      if (lane == 0) warp_hits[q][warp] = __popc(ballot[q]);
    }
    __syncthreads();
    int count = 0;
#pragma unroll
    for (int q = 0; q < FILTER; ++q) {
      for (int w = 0; w < THREADS / 32; ++w) {
        if (w == warp && hit[q]) {
          list[count + __popc(ballot[q] & ((1u << lane) - 1))] =
              first + q * THREADS + t;
        }
        count += warp_hits[q][w];
      }
    }
    __syncthreads();
    if (count == 0) continue;
    if (warp == 0) stage(corners[0], fetch(geo, roi0 + list[0], lane), lane, oy, ox);
    __syncthreads();
    for (int k = 0; k < count; ++k) {
      // warp 0 loads the next RoI's geometry while the block adds this one
      const bool more = k + 1 < count;
      Samples next{};
      if (warp == 0 && more) next = fetch(geo, roi0 + list[k + 1], lane);
      if (live) {
        accumulate(mine, corners[k & 1],
                   grad_out + (roi0 + list[k]) * P * P * C + c0 + 2 * t, C,
                   even, second);
      }
      if (warp == 0 && more) stage(corners[(k + 1) & 1], next, lane, oy, ox);
      __syncthreads();
    }
  }

  // the whole tile once, in the feature dtype
  __syncthreads();
  T* dst = static_cast<T*>(L.grad[lvl]) + static_cast<size_t>(b) * H * W * C;
  const int rows = min(TH, H - oy), cols = min(TW, W - ox);
  const int width = min(CS, C - c0);
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC == 0 && width % VEC == 0) {
    const int per_cell = width / VEC;
    for (int e = t; e < TH * TW * per_cell; e += THREADS) {
      const int cell = e / per_cell, v = (e % per_cell) * VEC;
      const int y = cell / TW, x = cell % TW;
      if (y >= rows || x >= cols) continue;
      store_vec(dst + (static_cast<size_t>(oy + y) * W + ox + x) * C + c0 + v,
                acc + cell * CS + v);
    }
  } else {
    for (int e = t; e < TH * TW * width; e += THREADS) {
      const int cell = e / width, v = e % width;
      const int y = cell / TW, x = cell % TW;
      if (y >= rows || x >= cols) continue;
      store_one(dst + (static_cast<size_t>(oy + y) * W + ox + x) * C + c0 + v,
                acc[cell * CS + v]);
    }
  }
}

// grad: the level grads back to back (level l at the sum of the earlier
// levels' B*h*w*C elements of `elem` bytes), or null.
Levels make_levels(const void* const* feat, void* grad, size_t elem, int B,
                   int C, const int* h, const int* w, const float* scale) {
  Levels L;
  size_t offset = 0;
  L.tile0[0] = 0;
  for (int l = 0; l < LEVELS; ++l) {
    L.feat[l] = feat ? feat[l] : nullptr;
    L.grad[l] = grad ? static_cast<char*>(grad) + offset * elem : nullptr;
    offset += static_cast<size_t>(B) * h[l] * w[l] * C;
    L.h[l] = h[l];
    L.w[l] = w[l];
    L.scale[l] = scale[l];
    const int ty = (h[l] + TH - 1) / TH, tx = (w[l] + TW - 1) / TW;
    L.tiles_x[l] = tx;
    L.tile0[l + 1] = L.tile0[l] + ty * tx;
    L.per_y[l] = (ty + MASK_BITS - 1) / MASK_BITS;
    L.per_x[l] = (tx + MASK_BITS - 1) / MASK_BITS;
  }
  return L;
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

}  // namespace

// feats: 4 level pointers; dims: h0,w0,h1,w1,h2,w2,h3,w3; scales: 4 floats.
// The levels and rois are 16-byte aligned and C * (2 with is_bf16, else 4)
// is a multiple of 16 (the wrapper checks).
extern "C" int roi_align_fwd(const void* f0, const void* f1, const void* f2,
                             const void* f3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, float s0,
                             float s1, float s2, float s3, const void* rois,
                             void* out, int B, int N, int C, int is_bf16,
                             void* stream) {
  const void* feat[LEVELS] = {f0, f1, f2, f3};
  const int h[LEVELS] = {h0, h1, h2, h3};
  const int w[LEVELS] = {w0, w1, w2, w3};
  const float sc[LEVELS] = {s0, s1, s2, s3};
  Levels L = make_levels(feat, nullptr, 0, B, C, h, w, sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rois = B * N;
  if (n_rois == 0) return 0;
  const int blocks = (n_rois + FWD_ROIS - 1) / FWD_ROIS;
  const auto kernel = is_bf16 ? fwd_kernel<__nv_bfloat16> : fwd_kernel<float>;
  kernel<<<blocks, FWD_THREADS, 0, s>>>(L, static_cast<const float4*>(rois),
                                        static_cast<float*>(out), n_rois, N,
                                        C);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch roi_align_bwd needs for n_rois RoIs.
extern "C" long long roi_align_bwd_scratch(int n_rois) {
  return static_cast<long long>(align16(sizeof(TileMask) * n_rois) +
                                sizeof(Geometry) * n_rois);
}

// out: the four level grads back to back, in the feature dtype (bf16 with
// is_bf16, else f32); every element is written. scratch: at least
// roi_align_bwd_scratch(B * N) bytes, 16-byte aligned.
extern "C" int roi_align_bwd(const void* grad_out, void* scratch, void* out,
                             int h0, int w0, int h1, int w1, int h2, int w2,
                             int h3, int w3, float s0, float s1, float s2,
                             float s3, const void* rois, int B, int N, int C,
                             int is_bf16, void* stream) {
  const int h[LEVELS] = {h0, h1, h2, h3};
  const int w[LEVELS] = {w0, w1, w2, w3};
  const float sc[LEVELS] = {s0, s1, s2, s3};
  Levels L = make_levels(nullptr, out, is_bf16 ? 2 : 4, B, C, h, w, sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rois = B * N;
  TileMask* masks = static_cast<TileMask*>(scratch);
  Geometry* geo = reinterpret_cast<Geometry*>(
      static_cast<char*>(scratch) + align16(sizeof(TileMask) * n_rois));
  if (n_rois > 0) {
    bwd_geometry_kernel<<<n_rois, 32, 0, s>>>(
        L, static_cast<const float*>(rois), geo, masks);
  }
  const dim3 grid(B * L.tile0[LEVELS], (C + CS - 1) / CS);
  if (grid.x == 0 || grid.y == 0) return static_cast<int>(cudaGetLastError());
  const float* g = static_cast<const float*>(grad_out);
  const auto kernel = is_bf16 ? bwd_gather_kernel<__nv_bfloat16>
                              : bwd_gather_kernel<float>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ACC_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, ACC_BYTES, s>>>(L, geo, masks, g, N, C);
  return static_cast<int>(cudaGetLastError());
}
