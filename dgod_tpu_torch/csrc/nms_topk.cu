// K6: greedy NMS cut after the first k picks, batched over images.
//
// Replaces dgod_tpu/ops/pallas_nms.py::_nms_kernel (via nms_topk_pallas).
// boxes [B,K,4] f32 (class-offset already), scores [B,K] f32, valid [B,K]
// bool -> idx [B,k] int64, ok [B,k] bool, equal to ops/nms.py::nms_topk_plain:
// round i takes the largest live score (smallest index among equal maxima),
// then kills it and every live box whose IoU with it exceeds the threshold.
// A round that finds no live score gives (0, false), and so do all after it.
//
// Bound on the H100: neither bytes (~1.5 MB at K 9,000) nor operations
// (~20 f32 ops per live box per round), but the serial dependency of the k
// rounds: each round is a block-wide argmax then a suppression pass, and the
// next round cannot start before both end. One block per image keeps every
// round inside the block: the image's live scores (and its boxes, where
// they fit) sit in shared memory for the whole loop, a round costs two
// barriers and a warp-shuffle reduction, and the loop stops at the first
// round with nothing live. Suppressed entries are never read again.
//
// Exactness: the IoU is the plain version's, operation for operation and
// with no contraction: inter = max(min(x2) - max(x1), 0) * (same in y),
// union = area(pick) + area(box) - inter, iou = union > 0 ? inter / union
// (IEEE division) : 0, suppress when iou > thr. The class offsets push
// coordinates to ~1e4, where one ulp moves pairs across the threshold, so
// every operation is an explicitly rounded intrinsic. Build without
// --use_fast_math. NaN scores or coordinates are outside the contract.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// true when (v, i) beats (bv, bi): larger score, or equal and lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
nms_topk_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int K, int k, float thr,
                int stage_boxes, long long* __restrict__ idx_out,
                uint8_t* __restrict__ ok_out) {
  extern __shared__ float4 smem[];
  // [K] boxes (when staged) then [K] live scores
  float4* sbox = smem;
  float* live = reinterpret_cast<float*>(stage_boxes ? smem + K : smem);
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* gbox = boxes + static_cast<long long>(b) * K;
  for (int i = tid; i < K; i += blockDim.x) {
    const long long j = static_cast<long long>(b) * K + i;
    live[i] = valid[j] ? scores[j] : -CUDART_INF_F;
    if (stage_boxes) sbox[i] = gbox[i];
  }
  __syncthreads();
  const float4* bx = stage_boxes ? sbox : gbox;  // generic addressing

  int round = 0;
  for (; round < k; ++round) {
    // 1. argmax over the live scores
    float bv = -CUDART_INF_F;
    int bi = K;
    for (int i = tid; i < K; i += blockDim.x) {
      const float v = live[i];
      if (v > bv) {  // i rises: the first index wins within a thread
        bv = v;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < WARPS ? red_v[lane] : -CUDART_INF_F;
      bi = lane < WARPS ? red_i[lane] : K;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      // bv == -inf: nothing live is left
      if (lane == 0) s_pick = bv > -CUDART_INF_F ? bi : -1;
    }
    __syncthreads();
    const int pick = s_pick;
    if (pick < 0) break;  // the same value in every thread
    if (tid == 0) {
      idx_out[static_cast<long long>(b) * k + round] = pick;
      ok_out[static_cast<long long>(b) * k + round] = 1;
    }

    // 2. suppression by the pick, and the pick itself
    const float4 p = bx[pick];
    const float parea = area(p);
    for (int i = tid; i < K; i += blockDim.x) {
      if (live[i] == -CUDART_INF_F) continue;
      if (i == pick) {
        live[i] = -CUDART_INF_F;
        continue;
      }
      const float4 q = bx[i];
      const float iw = fmaxf(__fsub_rn(fminf(p.z, q.z), fmaxf(p.x, q.x)), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(p.w, q.w), fmaxf(p.y, q.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(parea, area(q)), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      if (iou > thr) live[i] = -CUDART_INF_F;
    }
    __syncthreads();  // live is read by the next round's argmax
  }
  for (int r = round + tid; r < k; r += blockDim.x) {
    idx_out[static_cast<long long>(b) * k + r] = 0;
    ok_out[static_cast<long long>(b) * k + r] = 0;
  }
}

}  // namespace

// Shared memory each image needs: its live scores, plus its boxes where
// `stage_boxes`. Returns cudaErrorInvalidValue if even the scores alone do
// not fit in what a block may use.
extern "C" int nms_topk(const void* boxes, const void* scores,
                        const void* valid, int B, int K, int k, float thr,
                        void* idx_out, void* ok_out, void* stream) {
  if (B == 0 || k == 0) return 0;
  int dev = 0;
  int max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t score_bytes = static_cast<size_t>(K) * sizeof(float);
  const size_t box_bytes = static_cast<size_t>(K) * sizeof(float4);
  // the static reduction scratch takes ~260 bytes of the same budget
  const size_t budget = static_cast<size_t>(max_smem) - 512;
  const int stage_boxes = score_bytes + box_bytes <= budget ? 1 : 0;
  const size_t smem = score_bytes + (stage_boxes ? box_bytes : 0);
  if (K < 1 || smem > budget) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      nms_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_topk_kernel<<<B, THREADS, smem, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), K, k, thr, stage_boxes,
      static_cast<long long*>(idx_out), static_cast<uint8_t*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}
