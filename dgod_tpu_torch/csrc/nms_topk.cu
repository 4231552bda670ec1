// K6: greedy NMS cut after the first k picks, batched over images.
//
// Replaces dgod_tpu/ops/pallas_nms.py::_nms_kernel (via nms_topk_pallas).
// boxes [B,K,4] f32 (class-offset already), scores [B,K] f32, valid [B,K]
// bool -> idx [B,k] int64, ok [B,k] bool, equal to ops/nms.py::nms_topk_plain:
// round i takes the largest live score (smallest index among equal maxima),
// then kills it and every live box whose IoU with it exceeds the threshold.
// A round that finds no live score gives (0, false), and so do all after it.
//
// Rank order gives the rounds' picks. An entry is live when it is valid and
// its score is above -inf. Its rank key orders the live entries by score,
// descending, and by index, ascending, among equal scores; the keys are
// unique. Round r picks the live entry of smallest key that no pick of
// rounds 0..r-1 suppressed. By induction on r, the picks come in ascending
// key order, and an entry e is picked iff no picked entry of smaller key
// suppresses it: once every entry of smaller key is decided, e is still
// live iff none of their picks killed it, and then its key is the smallest
// live one. So a walk over the entries in key order that keeps each entry
// no kept box suppresses, and stops at k kept, gives the rounds' picks in
// the rounds' order. An entry that a kept box suppresses is never picked,
// whatever its rank, so the walk may drop it before its turn.
//
// One 1024-thread block per image walks its entries in key order, a tile
// at a time:
//   1. compact: the image's live keys, (~order(score + 0.0f) << ib) | index
//      with `order` the order-preserving map of a float's bits to an
//      unsigned and ib the bits of an index, go into the pool in shared
//      memory (in any order: a key carries its index), and the histogram
//      counts the 13 bits below the top 4 of the keys whose top 4 bits are
//      those of a score in [2^-31, 2). -0.0 + 0.0 is +0.0: the two zeros
//      tie and the lower index wins, as in argmax. An image with nothing
//      live writes k x (0, false) and ends.
//   2. select: the next tile is the keys in [floor, bound), the fewest at
//      a digit boundary that number at least TILE_MIN (128), at most TILE
//      (1024), or all that are left when fewer. `bound` comes from an MSD
//      radix select over 13-bit digits (a histogram, and a block scan that
//      finds the digit). Where no live score is 2 or more and more than a
//      tile's lie in [2^-31, 2), the compaction's counts are its first
//      pass, which for spread scores is the only one. The pool is never
//      moved: `floor` rises to `bound`, and a dropped key is overwritten
//      with NONE. No library sort: the ordering is this kernel's.
//   3. sort the tile: each key's rank is the count of the tile's keys below
//      it; its box, loaded meanwhile, goes to that rank.
//   4. decide: drop the candidates that a box kept since the last filter
//      (step 5) suppresses, compact the rest in rank order and decide the
//      first ROWS (64) of them with a 64x64 upper-triangular IoU bitmask
//      (ballots) and one warp's serial scan, as K5 does
//      (csrc/proposals.cu); test the rest against the boxes just kept, and
//      repeat until the tile is spent or k are kept.
//   5. filter: when at most FILTER_MAX boxes were kept since the pool last
//      met the kept list, drop the pool's keys they suppress before the
//      next selection, so a row whose first picks suppress everything ends
//      after one tile, not after one selection per 1024 entries.
// Boxes are not staged: a box is read by its index (the image's boxes stay
// in L2). The time follows the picks: the check's rows pick 100 within
// their first ~100 ranks and end after one tile and two scan steps.
//
// Bound on the H100 (chip_smoke.py counts it from the run's data): the
// score and valid bytes of every entry, the boxes of the entries that must
// be ranked (all live ones where fewer than k are picked, else those ranked
// up to the last pick), and ~20 f32 ops for each IoU test such an entry
// needs against the picks ranked above it until one suppresses it. Neither
// limits this kernel: its steps are serial and separated by barriers, on
// one SM per image (8 of 132 at batch 8).
//
// Exactness: the IoU is the plain version's, operation for operation and
// with no contraction: inter = max(min(x2) - max(x1), 0) * (same in y),
// union = area(kept) + area(box) - inter, iou = union > 0 ? inter / union
// (IEEE division) : 0, suppress when iou > thr; where inter is 0 the IoU is
// 0 whatever the union. The class offsets push coordinates to ~1e4, where
// one ulp moves pairs across the threshold, so every operation is an
// explicitly rounded intrinsic. Build without --use_fast_math. The
// division itself is replaced by an exact comparison (`over`). NaN scores or
// coordinates are outside the contract.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>
#include <cstring>

namespace {

using u64 = unsigned long long;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;       // most candidates per tile, one a thread
constexpr int TILE_MIN = 128;       // a selection may stop once it has these
constexpr int ROWS = 64;            // candidates decided per scan step
constexpr int FILTER_MAX = 16;      // most kept boxes a pool filter tests
constexpr int RADIX = 13;           // bits per select digit
constexpr int LEAD = 4;             // top key bits the compaction tests
constexpr unsigned TOP = 4;         // their value for scores in [2^-31, 2)
constexpr int BINS = 1 << RADIX;
constexpr int LOADS = 8;            // entries a thread loads at once
constexpr int TESTS = 4;            // pool keys a thread filters at once
constexpr u64 NONE = ~0ull;         // sorts after every key; a dropped key
constexpr unsigned FULL = 0xffffffffu;

// The block's counters; they only grow
struct Shared {
  int live;      // the image's live keys
  int gathered;  // keys gathered into tiles
  int dropped;   // keys the filters dropped
  int sel[3];    // a select pass's digit, keys before it, keys of it
  int top_lt, top_eq;  // live keys whose top LEAD bits are below, at TOP
};

struct Smem {
  u64 xchg[TILE];            // the gathered tile
  float4 box[TILE];          // the tile's boxes by rank, then compacted
  int idx[TILE];             // and their indices
  unsigned diag[ROWS][2];    // row i: columns 0-31, 32-63 it suppresses
  int warp_sum[2][WARPS];    // block_scan's scratch, alternating
  int misc;                  // a scan step's picks
  Shared sh;
};

// The threshold test without the division. fl(x) > thr, for x = inter /
// union and fl its rounding to f32, holds iff x lies above the midpoint m
// of thr and the next float up, or on it when that float is even (a tie
// rounds to even). m has at most 25 significant bits and union 24, so
// m * union is exact in double, and inter > m * union decides x > m
// exactly: the same answer as __fdiv_rn(inter, union) > thr, for every
// pair.
struct Thr {
  float thr;
  double mid;   // (thr + nextafterf(thr, inf)) / 2
  int up_even;  // nextafterf(thr, inf) has an even significand
};

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(p, q) > thr with p the kept (earlier) box, as the plain version rounds
__device__ __forceinline__ bool over(float4 p, float pa, float4 q, float qa,
                                     const Thr& t) {
  const float iw = fmaxf(__fsub_rn(fminf(p.z, q.z), fmaxf(p.x, q.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(p.w, q.w), fmaxf(p.y, q.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(pa, qa), inter);
  // iou is 0 where inter is 0 (0 / union) or union is not positive
  if (!(inter > 0.0f && uni > 0.0f)) return 0.0f > t.thr;
  const double lhs = static_cast<double>(inter);
  const double rhs = __dmul_rn(t.mid, static_cast<double>(uni));
  return lhs > rhs || (lhs == rhs && t.up_even);
}

// q suppressed by one of the kept boxes [lo, hi)
__device__ __forceinline__ bool killed(const float4* kbox, const float* karea,
                                       int lo, int hi, float4 q, float qa,
                                       const Thr& thr) {
  for (int j = lo; j < hi; ++j)
    if (over(kbox[j], karea[j], q, qa, thr)) return true;
  return false;
}

// Unique key, ascending in the greedy order (see the header)
__device__ __forceinline__ u64 rank_key(float score, int i, int ib) {
  unsigned u = __float_as_uint(__fadd_rn(score, 0.0f));  // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);       // ascending in s
  return (static_cast<u64>(~u) << ib) | static_cast<unsigned>(i);
}

// Exclusive prefix sum of v over the block in thread order, and the
// block's sum in *total. Two barriers; the scratch alternates between
// calls, so the next call may write it without a third.
__device__ __forceinline__ int block_scan(int v, Smem& s, int& parity,
                                          int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  int* ws = s.warp_sum[parity];
  parity ^= 1;
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += t;
    }
    if (lane < WARPS) ws[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  *total = ws[WARPS - 1];
  return (warp ? ws[warp - 1] : 0) + inc - v;
}

// The first digit v of the histogram at which the keys taken
// reach TILE_MIN, given `taken` keys below the current prefix; -> into
// s.sh.sel: v, the keys of the digits before it, the keys of v. The prefix
// holds more keys than are still to take, so one thread's bins cross.
__device__ void find_digit(const unsigned* hist, int taken, Smem& s,
                           int& parity) {
  constexpr int PER = BINS / THREADS;  // bins per thread
  int c[PER];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = static_cast<int>(hist[threadIdx.x * PER + j]);
    sum += c[j];
  }
  int total;
  int acc = block_scan(sum, s, parity, &total);
  const int target = TILE_MIN - taken;
  if (acc < target && target <= acc + sum) {
    int j = 0;
    while (acc + c[j] < target) acc += c[j++];
    s.sh.sel[0] = threadIdx.x * PER + j;
    s.sh.sel[1] = acc;
    s.sh.sel[2] = c[j];
  }
}

// Sort the tile's t keys, s.xchg[0, t): s.box[r] and s.idx[r] <- the box
// and index of the key of rank r. Each thread counts the keys below its own
// (the keys are unique), its box load in flight meanwhile: one broadcast
// read per key and thread, and one barrier.
__device__ void sort_tile(int t, const float4* gbox, u64 idx_mask, Smem& s) {
  if (threadIdx.x < t) {
    const u64 key = s.xchg[threadIdx.x];
    const int i = static_cast<int>(key & idx_mask);
    const float4 q = gbox[i];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < t; ++j) rank += s.xchg[j] < key;
    s.box[rank] = q;
    s.idx[rank] = i;
  }
  __syncthreads();
}

// Decide the sorted tile of t candidates (s.box, s.idx by rank)
// against the kept boxes, appending its picks. -> the picks so far.
__device__ int decide_tile(int t, int nk, int filt, int k, float4* kbox,
                           float* karea, int* kidx, const Thr& thr, Smem& s,
                           int& parity) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  bool alive = tid < t;  // thread tid holds the candidate of rank tid
  float4 q = alive ? s.box[tid] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int ci = alive ? s.idx[tid] : 0;
  float qa = area(q);
  int total = t;  // candidates left, in s.box and s.idx; -1: not compacted
  if (nk > filt) {  // the pools have not met every kept box
    alive = alive && !killed(kbox, karea, filt, nk, q, qa, thr);
    total = -1;
  }
  while (true) {
    if (total < 0) {  // compact the candidates left, in rank order
      const int off = block_scan(alive ? 1 : 0, s, parity, &total);
      if (total == 0) break;
      if (alive) {
        s.box[off] = q;
        s.idx[off] = ci;
      }
      __syncthreads();
      alive = tid < total;
      if (alive) {
        q = s.box[tid];
        ci = s.idx[tid];
        qa = area(q);
      }
    }
    const int rows = min(ROWS, total);
    for (int pr = warp; pr < 2 * ROWS; pr += WARPS) {
      const int row = pr >> 1;
      const int col = (pr & 1) * 32 + lane;
      bool bit = false;
      if (row < rows && col < rows && col > row) {
        const float4 p4 = s.box[row];
        const float4 c4 = s.box[col];
        bit = over(p4, area(p4), c4, area(c4), thr);
      }
      const unsigned bal = __ballot_sync(FULL, bit);
      if (lane == 0) s.diag[row][pr & 1] = bal;
    }
    __syncthreads();
    if (warp == 0) {  // the rows in rank order; every lane the same
      u64 removed = 0, kept = 0;
      int c = 0;
      for (int j = 0; j < rows && nk + c < k; ++j) {
        if (!((removed >> j) & 1ull)) {
          kept |= 1ull << j;
          ++c;
          removed |= static_cast<u64>(s.diag[j][0]) |
                     (static_cast<u64>(s.diag[j][1]) << 32);
        }
      }
      for (int j = lane; j < rows; j += 32) {
        if ((kept >> j) & 1ull) {
          const int slot = nk + __popcll(kept & ((1ull << j) - 1ull));
          const float4 p4 = s.box[j];
          kbox[slot] = p4;
          karea[slot] = area(p4);
          kidx[slot] = s.idx[j];
        }
      }
      if (lane == 0) s.misc = c;
    }
    __syncthreads();
    const int first = nk;
    nk += s.misc;
    if (nk >= k) break;
    alive = alive && tid >= rows &&
            !killed(kbox, karea, first, nk, q, qa, thr);
    total = -1;
  }
  return nk;
}

__global__ void __launch_bounds__(THREADS, 1)
nms_topk_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int K, int k, Thr thr,
                int ib, long long* __restrict__ idx_out,
                uint8_t* __restrict__ ok_out) {
  __shared__ Smem s;
  extern __shared__ float4 dyn[];
  float4* kbox = dyn;                                        // [k] kept boxes
  u64* pool = reinterpret_cast<u64*>(kbox + k);              // [K] live keys
  unsigned* hist = reinterpret_cast<unsigned*>(pool + K);    // [BINS]
  float* karea = reinterpret_cast<float*>(hist + BINS);      // [k]
  int* kidx = reinterpret_cast<int*>(karea + k);             // [k]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long base = static_cast<long long>(b) * K;
  const float4* gbox = boxes + base;
  const u64 idx_mask = (1ull << ib) - 1ull;
  const int bits = 32 + ib;  // a key's significant bits
  int parity = 0;

  for (int i = tid; i < BINS; i += THREADS) hist[i] = 0;
  if (tid == 0) s.sh = Shared{};
  __syncthreads();

  // 1. the live keys, and the counts of the digit below the top LEAD bits
  // of those whose top bits are TOP (probability scores: the sign and the
  // top of the exponent)
  int lt = 0, eq = 0;
  for (int i0 = 0; i0 < K; i0 += LOADS * THREADS) {
    float score[LOADS];
    bool live[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {  // the loads first, all in flight
      const int i = i0 + u * THREADS + tid;
      score[u] = i < K ? scores[base + i] : 0.0f;
      live[u] = i < K && valid[base + i];
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const bool in = live[u] && score[u] > -CUDART_INF_F;
      const u64 key = rank_key(score[u], i0 + u * THREADS + tid, ib);
      const unsigned m = __ballot_sync(FULL, in);
      int slot = 0;
      if (lane == 0 && m) slot = atomicAdd(&s.sh.live, __popc(m));
      slot = __shfl_sync(FULL, slot, 0);
      if (in) {
        pool[slot + __popc(m & ((1u << lane) - 1u))] = key;
        const unsigned top = static_cast<unsigned>(key >> (bits - LEAD));
        lt += top < TOP;
        if (top == TOP) {
          ++eq;
          atomicAdd(&hist[static_cast<unsigned>(key >> (bits - LEAD - RADIX)) &
                          (BINS - 1)], 1u);
        }
      }
    }
  }
  lt = __reduce_add_sync(FULL, lt);
  eq = __reduce_add_sync(FULL, eq);
  if (lane == 0 && (lt || eq)) {
    atomicAdd(&s.sh.top_lt, lt);
    atomicAdd(&s.sh.top_eq, eq);
  }
  __syncthreads();
  const int n = s.sh.live;  // the pool
  int left = n;             // its keys in [floor, NONE), not dropped
  int nk = 0;               // picks so far
  int filt = 0;             // the pool has met the kept boxes [0, filt)
  u64 floor = 0;            // every key below it has had its tile
  int gathered = 0;         // s.sh.gathered, as last read
  int dropped = 0;          // s.sh.dropped, as last read
  bool counted = true;      // the histogram holds the compaction's counts

  while (nk < k && left > 0) {
    // 5. filter the pool by a few new kept boxes, marking dropped keys
    if (nk > filt && nk - filt <= FILTER_MAX) {
      int drops = 0;
      for (int i0 = 0; i0 < n; i0 += TESTS * THREADS) {
        u64 key[TESTS];
        float4 q[TESTS];
#pragma unroll
        for (int u = 0; u < TESTS; ++u) {
          const int i = i0 + u * THREADS + tid;
          key[u] = i < n ? pool[i] : NONE;
          q[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (key[u] >= floor && key[u] != NONE) q[u] = gbox[key[u] & idx_mask];
        }
#pragma unroll
        for (int u = 0; u < TESTS; ++u) {
          if (key[u] < floor || key[u] == NONE) continue;
          if (killed(kbox, karea, filt, nk, q[u], area(q[u]), thr)) {
            pool[i0 + u * THREADS + tid] = NONE;
            ++drops;
          }
        }
      }
      drops = __reduce_add_sync(FULL, drops);
      if (lane == 0 && drops) atomicAdd(&s.sh.dropped, drops);
      __syncthreads();
      left -= s.sh.dropped - dropped;
      dropped = s.sh.dropped;
      filt = nk;
      continue;
    }
    // 2. the next tile: the pool's keys in [floor, bound)
    u64 bound = NONE;
    if (left > TILE) {
      u64 prefix = 0;
      int taken = 0;
      int width = bits;
      if (counted) {  // the first tile: the compaction's counts, if usable
        if (s.sh.top_lt == 0 && s.sh.top_eq > TILE) {  // the first keys
          prefix = TOP;
          width = bits - LEAD;
        } else {  // count anew from the top
          counted = false;
          for (int i = tid; i < BINS; i += THREADS) hist[i] = 0;
          __syncthreads();
        }
      }
      while (true) {
        const int d = min(RADIX, width);
        const int shift = width - d;
        if (!counted) {  // the histogram is zero
          for (int i = tid; i < n; i += THREADS) {
            const u64 key = pool[i];
            if (key >= floor && key != NONE && (key >> width) == prefix)
              atomicAdd(&hist[static_cast<unsigned>(key >> shift) &
                              ((1u << d) - 1u)], 1u);
          }
          __syncthreads();
        }
        counted = false;
        find_digit(hist, taken, s, parity);
        __syncthreads();  // the histogram is read; zero it for the next
        for (int i = tid; i < BINS; i += THREADS) hist[i] = 0;
        __syncthreads();
        const u64 next = (prefix << d) | static_cast<u64>(s.sh.sel[0]);
        const int before = s.sh.sel[1], of_v = s.sh.sel[2];
        // the last digit is the key itself: one key a bin, it fits
        if (taken + before + of_v <= TILE || shift == 0) {
          bound = (next + 1) << shift;
          break;
        }
        taken += before;  // descend into v
        prefix = next;
        width = shift;
      }
    }
    for (int i0 = 0; i0 < n; i0 += THREADS) {
      const int i = i0 + tid;
      const u64 key = i < n ? pool[i] : NONE;
      const bool in = key >= floor && key < bound;
      const unsigned m = __ballot_sync(FULL, in);
      int slot = 0;
      if (lane == 0 && m) slot = atomicAdd(&s.sh.gathered, __popc(m));
      slot = __shfl_sync(FULL, slot, 0) - gathered +
             __popc(m & ((1u << lane) - 1u));
      if (in) s.xchg[slot] = key;
    }
    __syncthreads();
    const int t = s.sh.gathered - gathered;
    gathered = s.sh.gathered;
    left = t > 0 ? left - t : 0;  // a tile is never empty
    floor = bound;
    // 3-4. sort and decide the tile (every thread returns the same count)
    sort_tile(t, gbox, idx_mask, s);
    nk = decide_tile(t, nk, filt, k, kbox, karea, kidx, thr, s, parity);
  }
  for (int r = tid; r < k; r += THREADS) {
    idx_out[static_cast<long long>(b) * k + r] = r < nk ? kidx[r] : 0;
    ok_out[static_cast<long long>(b) * k + r] = r < nk ? 1 : 0;
  }
}

// Shared memory a block needs beside the static Smem: the image's live
// keys (8 bytes per entry), the select histogram and k kept boxes, areas
// and indices
size_t dynamic_smem(int K, int k) {
  return static_cast<size_t>(K) * sizeof(u64) + BINS * sizeof(unsigned) +
         static_cast<size_t>(k) * (sizeof(float4) + sizeof(float) +
                                   sizeof(int));
}

int max_smem() {
  int dev = 0;
  int bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

}  // namespace

// The most entries per image a launch at this k takes on the current
// device: its shared memory holds 8 bytes per entry.
extern "C" int nms_topk_max_entries(int k) {
  const long long room = static_cast<long long>(max_smem()) -
                         static_cast<long long>(sizeof(Smem)) -
                         static_cast<long long>(dynamic_smem(0, k));
  return room > 0 ? static_cast<int>(room / sizeof(u64)) : 0;
}

// Returns cudaErrorInvalidValue where K exceeds nms_topk_max_entries(k).
extern "C" int nms_topk(const void* boxes, const void* scores,
                        const void* valid, int B, int K, int k, float thr,
                        void* idx_out, void* ok_out, void* stream) {
  if (B == 0 || k == 0) return 0;
  if (K < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  int ib = 1;
  while (ib < 31 && (1 << ib) < K) ++ib;  // K - 1 < 2^ib
  Thr t;
  t.thr = thr;
  const float up = std::nextafter(thr, INFINITY);
  t.mid = (static_cast<double>(thr) + static_cast<double>(up)) / 2.0;
  uint32_t up_bits;
  std::memcpy(&up_bits, &up, sizeof(up_bits));
  t.up_even = (up_bits & 1u) == 0;
  const size_t smem = dynamic_smem(K, k);
  if (smem + sizeof(Smem) > static_cast<size_t>(max_smem()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      nms_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_topk_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), K, k, t, ib,
      static_cast<long long*>(idx_out), static_cast<uint8_t*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}
