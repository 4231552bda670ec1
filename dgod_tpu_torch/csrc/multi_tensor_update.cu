// K9: the optimizer's masked update, SGD or Adam, of every active leaf of
// one call, in one pass over each element.
//
// Replaces no Pallas kernel: it is what XLA makes of the masked update of
// dgod_tpu/train/optim.py, fused into each jitted mode step. Its plain twin
// is dgod_tpu_torch/train/optim.py::update_plain, a loop of ATen operations
// over the leaves (18 launches a leaf for Adam, 5 for SGD), which the CPU
// runs.
//
// Bound on the H100: HBM bytes. Adam reads p, m, v and g and writes p, m
// and v, 28 bytes an element; SGD reads p and g and writes p, 12 bytes.
// Each element is touched once, so the least time is the active elements
// times 28 (or 12) bytes over 3.35 TB/s; its ~15 float operations an
// element are far below the float32 peak.
//
// The leaves of a launch come in its parameters, by value (K9Leaves): their
// pointers, counts, gradient sizes and strides and bias corrections, up to
// MAX_LEAVES of them in the 32,764 bytes that CUDA >= 12.1 allows a
// kernel's parameters on sm_90 (4,096 before). Nothing is copied to the
// card and nothing outlives the launch. The leaves' elements lie end to end
// on one line, each leaf rounded up to a multiple of 4 (`start`). Block b
// takes elements [b * CHUNK, (b + 1) * CHUNK) of that line, finds its first
// leaf by a binary search over `start` (the same index in every thread, so
// the constant cache broadcasts it) and walks on through the leaves its
// range overlaps. A leaf whose p, m, v and gradient are 16-byte aligned and
// whose gradient is contiguous is read and written as float4; any other
// element by element: a gradient that is a view at a 4-byte offset of one
// all-reduce buffer, or a channels_last gradient of a contiguous weight,
// read in place through its own sizes and strides. A null gradient pointer
// reads as zeros (an active leaf the loss does not reach still takes
// weight decay).
//
// Rounding: bit for bit the twin's ATen operations on the card. Each ATen
// operation rounds its result to float32, after rounding a Python scalar
// to float32 (the wrapper so rounds lr, wd, b1, 1 - b1, b2, 1 - b2 and
// eps). ATen divides a CUDA tensor by a Python float as a multiply by the
// float's reciprocal, taken in double and rounded to float32, so each
// leaf's bias corrections come as 1 / (1 - b^c) so rounded. nvcc would
// contract a product and a sum into one FMA, so every operation here is an
// explicitly rounded intrinsic, in the twin's order. Build without
// --use_fast_math.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = THREADS * 16;  // elements a block: 4 float4 a thread
#if CUDART_VERSION >= 12010
constexpr int MAX_LEAVES = 384;
constexpr int PARAM_BYTES = 32764;
#else
constexpr int MAX_LEAVES = 48;
constexpr int PARAM_BYTES = 4096;
#endif
constexpr unsigned VEC = 1;      // p, m, v, g 16-byte aligned, g contiguous
constexpr unsigned STRIDED = 2;  // g read through gsize and gstride

struct K9Leaves {
  long long start[MAX_LEAVES + 1];  // offsets on the line; start[n] its end
  float* p[MAX_LEAVES];
  float* m[MAX_LEAVES];  // Adam's moments (unused by SGD)
  float* v[MAX_LEAVES];
  const float* g[MAX_LEAVES];  // null: a zero gradient
  int numel[MAX_LEAVES];
  int gsize[MAX_LEAVES][3];  // g as 4-D (leading 1s): sizes of dims 1-3
  int gstride[MAX_LEAVES][4];  // and its strides, in elements
  float rc1[MAX_LEAVES];  // 1 / (1 - b1^c) in double, rounded
  float rc2[MAX_LEAVES];  // 1 / (1 - b2^c)
  unsigned char flags[MAX_LEAVES];
  int n;
};

struct K9Scalars {
  float lr, wd, b1, omb1, b2, omb2, eps;  // omb: 1 - b, rounded after
};

static_assert(sizeof(K9Leaves) + sizeof(K9Scalars) <= PARAM_BYTES,
              "K9's leaves exceed a kernel's parameter space");

// p - lr * (g + wd * p)
__device__ __forceinline__ float sgd_step(float p, float g,
                                          const K9Scalars& s) {
  return __fsub_rn(p, __fmul_rn(s.lr, __fadd_rn(g, __fmul_rn(s.wd, p))));
}

// g += wd * p; m = b1 * m + (1 - b1) * g; v = b2 * v + (1 - b2) * (g * g);
// p -= lr * (m * rc1) / (sqrt(v * rc2) + eps)
__device__ __forceinline__ void adam_step(float& p, float& m, float& v,
                                          float g, float rc1, float rc2,
                                          const K9Scalars& s) {
  g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, rc2)), s.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, __fmul_rn(m, rc1)), den));
}

template <bool ADAM>
__device__ __forceinline__ void update_leaf(const K9Leaves& t, int l, int a,
                                            int b, const K9Scalars& s) {
  float* p = t.p[l];
  float* m = t.m[l];
  float* v = t.v[l];
  const float* g = t.g[l];
  const unsigned flags = t.flags[l];
  const float rc1 = t.rc1[l], rc2 = t.rc2[l];
  int rest = a;
  if (flags & VEC) {  // a is a multiple of 4; b too but at the leaf's end
    const int b4 = a + ((b - a) & ~3);
    for (int j = a + 4 * threadIdx.x; j < b4; j += 4 * THREADS) {
      float4 P = *reinterpret_cast<const float4*>(p + j);
      const float4 G = g ? *reinterpret_cast<const float4*>(g + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      if (ADAM) {
        float4 M = *reinterpret_cast<const float4*>(m + j);
        float4 V = *reinterpret_cast<const float4*>(v + j);
        adam_step(P.x, M.x, V.x, G.x, rc1, rc2, s);
        adam_step(P.y, M.y, V.y, G.y, rc1, rc2, s);
        adam_step(P.z, M.z, V.z, G.z, rc1, rc2, s);
        adam_step(P.w, M.w, V.w, G.w, rc1, rc2, s);
        *reinterpret_cast<float4*>(m + j) = M;
        *reinterpret_cast<float4*>(v + j) = V;
      } else {
        P.x = sgd_step(P.x, G.x, s);
        P.y = sgd_step(P.y, G.y, s);
        P.z = sgd_step(P.z, G.z, s);
        P.w = sgd_step(P.w, G.w, s);
      }
      *reinterpret_cast<float4*>(p + j) = P;
    }
    rest = b4;
  }
  const int s1 = t.gsize[l][0], s2 = t.gsize[l][1], s3 = t.gsize[l][2];
  const long long t0 = t.gstride[l][0], t1 = t.gstride[l][1],
                  t2 = t.gstride[l][2], t3 = t.gstride[l][3];
  for (int j = rest + threadIdx.x; j < b; j += THREADS) {
    float gj = 0.f;
    if (g) {
      long long off = j;
      if (flags & STRIDED) {
        int k = j;
        const int i3 = k % s3;
        k /= s3;
        const int i2 = k % s2;
        k /= s2;
        const int i1 = k % s1;
        off = (k / s1) * t0 + i1 * t1 + i2 * t2 + i3 * t3;
      }
      gj = g[off];
    }
    if (ADAM) {
      float pj = p[j], mj = m[j], vj = v[j];
      adam_step(pj, mj, vj, gj, rc1, rc2, s);
      p[j] = pj;
      m[j] = mj;
      v[j] = vj;
    } else {
      p[j] = sgd_step(p[j], gj, s);
    }
  }
}

template <bool ADAM>
__device__ __forceinline__ void update_chunk(const K9Leaves& t,
                                             const K9Scalars& s) {
  const long long cs = static_cast<long long>(blockIdx.x) * CHUNK;
  const long long ce = cs + CHUNK;
  int lo = 0, hi = t.n;  // start[lo] <= cs < start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.start[mid] <= cs) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  for (int l = lo; l < t.n && t.start[l] < ce; ++l) {
    const long long base = t.start[l];
    const int a = static_cast<int>((cs > base ? cs : base) - base);
    const long long end = ce - base;
    const int b = end < t.numel[l] ? static_cast<int>(end) : t.numel[l];
    if (a < b) update_leaf<ADAM>(t, l, a, b, s);
  }
}

__global__ void __launch_bounds__(THREADS)
k9_multi_tensor_adam(const __grid_constant__ K9Leaves t,
                     const __grid_constant__ K9Scalars s) {
  update_chunk<true>(t, s);
}

__global__ void __launch_bounds__(THREADS)
k9_multi_tensor_sgd(const __grid_constant__ K9Leaves t,
                    const __grid_constant__ K9Scalars s) {
  update_chunk<false>(t, s);
}

}  // namespace

// The most leaves one launch takes (the wrapper splits a call by it).
extern "C" int k9_capacity() { return MAX_LEAVES; }

// One launch over n leaves: start [n + 1] int64 (the line's offsets, each a
// multiple of 4, start[0] = 0), ptrs [n, 4] (p, m, v, g; g 0 for none),
// numel [n], gsize [n, 3], gstride [n, 4] int32, rc [n, 2] float32
// (1 / (1 - b1^c), 1 / (1 - b2^c)), flags [n] (VEC, STRIDED), scalars
// [7] float32 (lr, wd, b1, 1 - b1, b2, 1 - b2, eps); all on the host.
extern "C" int k9_multi_tensor_update(int adam, int n, const long long* start,
                                      const uint64_t* ptrs, const int* numel,
                                      const int* gsize, const int* gstride,
                                      const float* rc,
                                      const unsigned char* flags,
                                      const float* scalars, void* stream) {
  if (n < 1 || n > MAX_LEAVES || start[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K9Leaves t;
  t.n = n;
  for (int l = 0; l <= n; ++l) t.start[l] = start[l];
  for (int l = 0; l < n; ++l) {
    t.p[l] = reinterpret_cast<float*>(ptrs[4 * l]);
    t.m[l] = reinterpret_cast<float*>(ptrs[4 * l + 1]);
    t.v[l] = reinterpret_cast<float*>(ptrs[4 * l + 2]);
    t.g[l] = reinterpret_cast<const float*>(ptrs[4 * l + 3]);
    t.numel[l] = numel[l];
    for (int d = 0; d < 3; ++d) t.gsize[l][d] = gsize[3 * l + d];
    for (int d = 0; d < 4; ++d) t.gstride[l][d] = gstride[4 * l + d];
    t.rc1[l] = rc[2 * l];
    t.rc2[l] = rc[2 * l + 1];
    t.flags[l] = flags[l];
  }
  const K9Scalars s{scalars[0], scalars[1], scalars[2], scalars[3],
                    scalars[4], scalars[5], scalars[6]};
  const long long blocks = (start[n] + CHUNK - 1) / CHUNK;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (adam) {
    k9_multi_tensor_adam<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        t, s);
  } else {
    k9_multi_tensor_sgd<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        t, s);
  }
  return static_cast<int>(cudaGetLastError());
}
