// K3: fused box IoU + torchvision Matcher over a batch (RPN anchors).
//
// Replaces dgod_tpu/ops/pallas_matchers.py::_iou_match_kernel (via
// iou_match_tpu). gt [B,G,4] f32, valid [B,G] bool, anchors [R,4] f32
// -> matches [B,R] int32: gt index, BELOW_LOW (-1) or BETWEEN (-2).
//
// Bound on the H100: operations, not bytes. The inputs and outputs are a
// few MB, but the function needs an intersection test (~8 f32 ops) per
// (image, valid gt, anchor) pair and the rest of an IoU (~12 more and one
// IEEE division) per pair that intersects. Like the TPU kernel, it never
// materialises the [B,G,R] IoU planes.
//
// Anchors are on the thread axis in both passes, four per thread, and each
// block compacts its image's valid gt into shared memory in index order,
// so no loop walks the padding (G = 128). The layout is chosen for the
// training path's 2-8 valid gt per image, where a pass is a few waves of
// short blocks and their latency, not the IoUs, sets the time: four
// anchors per thread make a quarter of the blocks. One per thread would
// spread an image with ~100 gt over more SMs and suit it better. Most pairs
// do not intersect (97% at chip_smoke's check) and cannot change a code:
// the IoU of such a pair is exactly +0 and is decided without the
// division, and a block or warp skips every gt that misses the box around
// its anchors (the anchors are in level, row, column order, so a block's
// are a strip of the canvas). The test is exact: an anchor inside the box
// intersects a gt only if the box does, and the rounded subtractions are
// monotone.
//   best[B,G] starts at 0 (a memset): every IoU is +0 or positive.
//   pass 1 (best_kernel): one block per (1024-anchor chunk, image), the
//     images' blocks interleaved and the last chunks first: their anchors
//     are the coarsest level's, the largest, and meet the most gt, so
//     started last they would leave the card idle behind them (and an
//     image with many gt would too). A warp takes 128 consecutive anchors,
//     lane l those at l + 32 q. The block compacts the valid gt that meet
//     the chunk's box; a warp skips those that miss its own. Each lane
//     keeps each of its anchors' max IoU and the first index that reaches
//     it (jnp.argmax's order; -1 while the
//     max is 0, which stands for the first valid gt) and stores both in
//     scratch [B,R]. Per gt, the block's max (a warp max on the float's
//     int bits, valid for IoUs >= +0, then a shared-memory max) goes into
//     best[b,g] with one atomicMax per (block, gt) where it is positive.
//   pass 2 (match_kernel): 1024 consecutive anchors per block, thread t
//     those at t + 256 q, the last blocks first: the 0.7/0.3 code
//     from its stored max, then the low-quality rescue by float equality
//     with best[b,g] (ties included), then the empty-gt override. Every
//     iou(a, g) <= mv(a), the anchor's max, so where best[g] > mv(a)
//     equality is impossible: the block tests only the valid gt with
//     best <= its anchors' largest max that meet its box. A valid gt with
//     best 0 overlaps no anchor of its image, so every IoU with it is 0
//     and ties: it rescues every anchor, as in the plain version.
//
// A block's first loads (its anchors, and each thread's gt slot and flag)
// are issued together, so that a block whose work is small (2-8 gt) waits
// for one load latency, not a chain of them.
//
// Both passes call the same iou() with explicitly rounded intrinsics, so no
// FMA contraction can make pass 2's IoU differ from pass 1's in the last
// bit: the rescue's equality test depends on that. Build without
// --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BELOW_LOW = -1;
constexpr int BETWEEN = -2;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_LANE = 4;                     // pass-1 anchors per lane
constexpr int WARP_ANCHORS = 32 * PER_LANE;     // pass-1 anchors per warp
constexpr int CHUNK = WARPS * WARP_ANCHORS;     // pass-1 anchors per block
constexpr int PER_THREAD = 4;                   // pass-2 anchors per thread
constexpr int BLOCK2 = THREADS * PER_THREAD;    // pass-2 anchors per block
constexpr int MAX_G = 1024;                     // shared memory bound
constexpr int NONE = 0x7fffffff;                // no valid gt

// Holds no point: the identity of the box around anchors, and the box of a
// lane past the last anchor (it meets no gt).
__device__ __forceinline__ float4 empty_box() {
  return make_float4(CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F,
                     -CUDART_INF_F);
}

__device__ __forceinline__ float4 cover(const float4& u, const float4& a) {
  return make_float4(fminf(u.x, a.x), fminf(u.y, a.y), fmaxf(u.z, a.z),
                     fmaxf(u.w, a.w));
}

// Whether boxes g and a intersect (iw > 0 and ih > 0), as iou() decides.
__device__ __forceinline__ bool meets(const float4& g, const float4& a) {
  return __fsub_rn(fminf(g.z, a.z), fmaxf(g.x, a.x)) > 0.0f &&
         __fsub_rn(fminf(g.w, a.w), fmaxf(g.y, a.y)) > 0.0f;
}

// IoU written as pallas_matchers._iou_tile / boxes.box_iou write it:
// iw = max(min(x2) - max(x1), 0); inter = iw*ih; union = ga + aa - inter.
// A pair with iw <= 0 or ih <= 0 has inter = 0 and so IoU 0: +0 without
// the division (the clamped formula may give -0, which compares equal).
__device__ __forceinline__ float iou(const float4& g, const float4& a) {
  const float iw = __fsub_rn(fminf(g.z, a.z), fmaxf(g.x, a.x));
  const float ih = __fsub_rn(fminf(g.w, a.w), fmaxf(g.y, a.y));
  if (!(iw > 0.0f && ih > 0.0f)) return 0.0f;
  const float inter = __fmul_rn(iw, ih);
  const float ga = __fmul_rn(__fsub_rn(g.z, g.x), __fsub_rn(g.w, g.y));
  const float aa = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float uni = __fsub_rn(__fadd_rn(ga, aa), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__device__ __forceinline__ float4 warp_cover(float4 u) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    u = cover(u, make_float4(__shfl_xor_sync(~0u, u.x, o),
                             __shfl_xor_sync(~0u, u.y, o),
                             __shfl_xor_sync(~0u, u.z, o),
                             __shfl_xor_sync(~0u, u.w, o)));
  }
  return u;
}

// Thread t's gt of one compaction step, its flag and (with best) its best,
// loaded without waiting on one another.
struct Slot {
  float4 box;
  bool valid;
  float best;
};

__device__ __forceinline__ Slot load_slot(const float4* __restrict__ gt,
                                          const uint8_t* __restrict__ valid,
                                          const int* __restrict__ best, int b,
                                          int G, int g) {
  Slot s{empty_box(), false, 0.0f};
  if (g < G) {
    s.valid = valid[b * G + g];
    s.box = gt[b * G + g];
    if (best) s.best = __int_as_float(best[b * G + g]);
  }
  return s;
}

// One step of a block-wide compaction: the threads with `keep` take
// consecutive slots after n, in thread order. Returns this thread's slot
// (-1 without keep) and adds the block's count to n. All threads call it.
__device__ __forceinline__ int take_slot(bool keep, int& n) {
  __shared__ int warp_count[WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned ballot = __ballot_sync(~0u, keep);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int pos = n;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) pos += warp_count[w];
    n += warp_count[w];
  }
  __syncthreads();
  return keep ? pos + __popc(ballot & ((1u << lane) - 1)) : -1;
}

__global__ void __launch_bounds__(THREADS)
best_kernel(const float4* __restrict__ gt, const uint8_t* __restrict__ valid,
            const float4* __restrict__ anchors, int* __restrict__ best,
            int2* __restrict__ top, int G, int R) {
  __shared__ float4 sgt[MAX_G];
  __shared__ int sidx[MAX_G];
  __shared__ int sbest[MAX_G];  // the block's max per listed gt, int bits
  __shared__ float4 sbox[WARPS];
  const int chunks = (R + CHUNK - 1) / CHUNK;
  const int B = gridDim.x / chunks;
  const int b = blockIdx.x % B, chunk = chunks - 1 - blockIdx.x / B;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  // this lane's anchors: first + q * 32, q < PER_LANE
  const int first = chunk * CHUNK + warp * WARP_ANCHORS + lane;
  float4 a[PER_LANE];
#pragma unroll
  for (int q = 0; q < PER_LANE; ++q) {
    const int r = first + q * 32;
    a[q] = r < R ? anchors[r] : empty_box();
  }
  Slot slot = load_slot(gt, valid, nullptr, b, G, t);
  float4 box = empty_box();
#pragma unroll
  for (int q = 0; q < PER_LANE; ++q) box = cover(box, a[q]);
  box = warp_cover(box);  // the warp's anchors
  if (lane == 0) sbox[warp] = box;
  __syncthreads();
  float4 chunk_box = empty_box();
  for (int w = 0; w < WARPS; ++w) chunk_box = cover(chunk_box, sbox[w]);
  // the valid gt that meet the chunk, in index order
  int n = 0;
  for (int g0 = 0; g0 < G; g0 += THREADS) {
    if (g0 > 0) slot = load_slot(gt, valid, nullptr, b, G, g0 + t);
    const int p = take_slot(slot.valid && meets(slot.box, chunk_box), n);
    if (p >= 0) {
      sgt[p] = slot.box;
      sidx[p] = g0 + t;
      sbest[p] = 0;
    }
  }
  __syncthreads();
  float mv[PER_LANE];
  int arg[PER_LANE];
#pragma unroll
  for (int q = 0; q < PER_LANE; ++q) {
    mv[q] = 0.0f;
    arg[q] = -1;  // the first valid gt, while the max is 0
  }
  for (int j = 0; j < n; ++j) {
    const float4 g = sgt[j];
    if (!meets(g, box)) continue;  // every IoU of the warp's anchors is 0
    float m = 0.0f;
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const float v = iou(g, a[q]);
      if (v > mv[q]) {  // strict: the first index wins among equal maxima
        mv[q] = v;
        arg[q] = sidx[j];
      }
      m = fmaxf(m, v);
    }
    // m is +0 or positive: its int bits order like the floats
    const int bits = __reduce_max_sync(~0u, __float_as_int(m));
    if (lane == 0 && bits > 0) atomicMax(&sbest[j], bits);
  }
#pragma unroll
  for (int q = 0; q < PER_LANE; ++q) {
    const int r = first + q * 32;
    if (r < R) {
      top[static_cast<size_t>(b) * R + r] =
          make_int2(__float_as_int(mv[q]), arg[q]);
    }
  }
  __syncthreads();
  for (int j = t; j < n; j += THREADS) {
    if (sbest[j] > 0) atomicMax(&best[b * G + sidx[j]], sbest[j]);
  }
}

__global__ void __launch_bounds__(THREADS)
match_kernel(const float4* __restrict__ gt, const uint8_t* __restrict__ valid,
             const float4* __restrict__ anchors, const int* __restrict__ best,
             const int2* __restrict__ top, int* __restrict__ out, int G, int R,
             float high, float low, int allow) {
  __shared__ float4 sgt[MAX_G];  // the gt that can tie, and their best
  __shared__ float sbest[MAX_G];
  __shared__ float4 sbox[WARPS];
  __shared__ int smax[WARPS];
  __shared__ int first_valid, any_zero;
  const int b = blockIdx.y;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  // this thread's anchors: first + q * THREADS, q < PER_THREAD
  const int first = (gridDim.x - 1 - blockIdx.x) * BLOCK2 + t;
  float4 a[PER_THREAD];
  int2 s[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int r = first + q * THREADS;
    a[q] = empty_box();
    s[q] = make_int2(0, -1);
    if (r < R) {
      a[q] = anchors[r];
      s[q] = top[static_cast<size_t>(b) * R + r];
    }
  }
  Slot slot = load_slot(gt, valid, best, b, G, t);
  float4 box = empty_box();
  int most = 0;  // the largest max, int bits (mv >= +0: int order)
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    box = cover(box, a[q]);
    most = max(most, s[q].x);
  }
  const float4 wbox = warp_cover(box);
  const int wmax = __reduce_max_sync(~0u, most);
  if (lane == 0) {
    sbox[warp] = wbox;
    smax[warp] = wmax;
  }
  if (t == 0) {
    first_valid = NONE;
    any_zero = 0;
  }
  __syncthreads();
  float4 block_box = empty_box();
  float block_max = 0.0f;
  for (int w = 0; w < WARPS; ++w) {
    block_box = cover(block_box, sbox[w]);
    block_max = fmaxf(block_max, __int_as_float(smax[w]));
  }
  // the valid gt whose best can equal an IoU of this block's anchors
  int n = 0;
  for (int g0 = 0; g0 < G; g0 += THREADS) {
    if (g0 > 0) slot = load_slot(gt, valid, best, b, G, g0 + t);
    const unsigned vb = __ballot_sync(~0u, slot.valid);
    if (lane == 0 && vb) atomicMin(&first_valid, g0 + warp * 32 + __ffs(vb) - 1);
    if (slot.valid && slot.best == 0.0f) any_zero = 1;  // every writer writes 1
    const int p = take_slot(slot.valid && slot.best > 0.0f &&
                                slot.best <= block_max &&
                                meets(slot.box, block_box),
                            n);
    if (p >= 0) {
      sgt[p] = slot.box;
      sbest[p] = slot.best;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int r = first + q * THREADS;
    if (r >= R) break;
    int code = BELOW_LOW;
    if (first_valid != NONE) {
      const float mv = __int_as_float(s[q].x);
      const int arg = s[q].y < 0 ? first_valid : s[q].y;
      if (mv < low) code = BELOW_LOW;
      else if (mv < high) code = BETWEEN;
      else code = arg;
      if (allow && code != arg) {
        bool rescued = any_zero;
        for (int j = 0; j < n && !rescued; ++j) {
          rescued = sbest[j] <= mv && iou(sgt[j], a[q]) == sbest[j];
        }
        if (rescued) code = arg;
      }
    }
    out[static_cast<size_t>(b) * R + r] = code;
  }
}

}  // namespace

// best: [B,G] int32 scratch; top: [B,R] int2 scratch. gt and anchors are
// 16-byte aligned (the wrapper checks).
extern "C" int iou_match(const void* gt, const void* valid,
                         const void* anchors, void* best, void* top, void* out,
                         int B, int G, int R, float high, float low, int allow,
                         void* stream) {
  if (G > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G > 0) {
    const cudaError_t err = cudaMemsetAsync(best, 0, sizeof(int) * B * G, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* g = static_cast<const float4*>(gt);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* a = static_cast<const float4*>(anchors);
  best_kernel<<<B * ((R + CHUNK - 1) / CHUNK), THREADS, 0, s>>>(
      g, v, a, static_cast<int*>(best), static_cast<int2*>(top), G, R);
  match_kernel<<<dim3((R + BLOCK2 - 1) / BLOCK2, B), THREADS, 0, s>>>(
      g, v, a, static_cast<const int*>(best), static_cast<const int2*>(top),
      static_cast<int*>(out), G, R, high, low, allow);
  return static_cast<int>(cudaGetLastError());
}
