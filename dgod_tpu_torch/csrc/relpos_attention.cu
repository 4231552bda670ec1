// K7 and K8: ViTDet's attention with decomposed relative positions, fused
// (detectron2/modeling/backbone/utils.py::add_decomposed_rel_pos under
// vit.py's Attention):
//
//     out = softmax(scale * q k^T + rel_h (+) rel_w) v
//
// They replace no TPU kernel: the JAX package has no transformer. The
// wrappers, their checks and launch counters are ops/cuda_attention.py, the
// plain version ops/attention.py.
//
// Layouts: qkv [B, N, 3, heads, 64] bf16, the qkv projection's output as it
// lies; q R_h [B, heads, N, KH] and q R_w [B, heads, N, KW] float32, where
// the N = KH x KW tokens lie row-major on the grid, so the logit of query m
// and key n gains rel_h[m, n / KW] + rel_w[m, n % KW]; out [B, N, heads, 64]
// bf16; the log-sum-exp of each row [B, heads, N] float32, in base 2.
//
// Bound on the H100 by the tensor cores: 4 N^2 D flops a head forward and
// 10 backward (14 with the backward's second pass over the logits) against
// a few bytes a token. Every product is mma.sync m16n8k16 in bf16 with
// float32 accumulation; a warp owns 16 rows of a product, the fragments of
// the other operand come from shared memory (ldmatrix .trans where the
// operand lies transposed), and the [B, heads, N, N] logits never leave the
// registers.
//
// The design follows the bias. Keys are taken in chunks of R whole rows of
// the grid, each row padded to KWP, the least multiple of 16 >= KW (76 ->
// 80 at the 608x1216 canvas's global grid, 14 -> 16 in a 14x14 window, R =
// 7 there so that a window is two chunks). Over a grid row the bias of
// query m is rel_h[m, kh], one value, plus rel_w[m, :], the same KWP values
// for every row: a thread keeps its queries' q R_w values for its columns
// for the whole walk and reads one q R_h value a row, so no bias element is
// gathered, and the padding costs the products 5% (global) or 12.5%
// (windows), where key blocks of a power of two cost 41% at the global
// grid.
//
// K7 (relpos_attn_fwd_kernel): a block of `warps` x 16 queries of one
// (image, head) walks the key chunks with an online softmax (flash
// attention), K and V of the next chunk copied into shared memory
// (cp.async) while it works on this one, p rounded to bf16 against v.
//
// K8 (one call of relpos_attn_bwd_delta_kernel, then _dkdv_kernel and
// _dq_kernel): delta = rowsum(dO * O), from the bf16 output as flash
// attention takes it; a block of four warps per 64 keys of the padded key
// sequence walks the queries 64 at a time for dK and dV, each step's q,
// dO, log-sum-exps and deltas and its q R_w and q R_h values copied into
// shared memory a step ahead; a block per query block walks the key chunks
// as K7 does for dQ and for the bias gradients, exact sums in float32:
// d rel_h[m, kh] is the row sum of dS over grid row kh (a quad shuffle,
// one store each), d rel_w[m, kw] its sum over the rows, kept in
// registers and stored once. Every output element is written once: no
// atomics, the same bits every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;           // head width
constexpr int LDS = D + 8;      // shared row stride (bf16): 144 bytes
constexpr int MQ = 32;          // queries of a dK/dV step
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the rows of
// matrix i
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the B fragments of the four k-steps of a 64-deep product against 8 rows
// of a [row][LDS] shared tile: b[kk] = {b0, b1} of k-step kk, from two
// ldmatrix.x4 (lane l gives row l % 8 of matrix l / 8)
__device__ __forceinline__ void ldsm_b64(uint32_t (*b)[2],
                                         const __nv_bfloat16* rows8,
                                         int lane) {
  const __nv_bfloat16* p = rows8 + (lane % 8) * LDS + lane / 8 * 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const unsigned a =
        static_cast<unsigned>(__cvta_generic_to_shared(p + half * 32));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(b[2 * half][0]), "=r"(b[2 * half][1]),
          "=r"(b[2 * half + 1][0]), "=r"(b[2 * half + 1][1])
        : "r"(a));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 2^x on the special function unit (ex2.approx, relative error 2^-22;
// 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The A fragments [4][4] of 16 rows x 64 of a [token][part][heads][64]
// tensor (row stride `stride` elements), rows >= n zero.
__device__ __forceinline__ void load_a_rows(uint32_t (*a)[4],
                                            const __nv_bfloat16* base,
                                            long stride, int row0, int n,
                                            int g, int t) {
  const bool ok0 = row0 + g < n, ok1 = row0 + g + 8 < n;
  const __nv_bfloat16* r0 = base + (long)(row0 + g) * stride;
  const __nv_bfloat16* r1 = base + (long)(row0 + g + 8) * stride;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = ok0 ? lds32(r0 + c) : 0u;
    a[kk][1] = ok1 ? lds32(r1 + c) : 0u;
    a[kk][2] = ok0 ? lds32(r0 + c + 8) : 0u;
    a[kk][3] = ok1 ? lds32(r1 + c + 8) : 0u;
  }
}

// Asynchronous copies to shared memory (cp.async): `ok` false fills the
// destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group (the one just issued) is in flight
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start copying a key chunk (R grid rows of KWP, padding and rows past KH
// zero) of k and v into shared [R * KWP][LDS] each, 16 bytes a copy.
__device__ __forceinline__ void load_chunk(__nv_bfloat16* ks,
                                           __nv_bfloat16* vs,
                                           const __nv_bfloat16* qkv_b,
                                           long s_n, int heads, int h,
                                           int kh0, int R, int KWP, int KH,
                                           int KW) {
  const int vecs = R * KWP * (D / 8);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const int row = i / (D / 8), c8 = (i % (D / 8)) * 8;
    const int kh = kh0 + row / KWP, kw = row % KWP;
    const bool ok = kh < KH && kw < KW;
    const __nv_bfloat16* src =
        qkv_b + (ok ? (long)(kh * KW + kw) * s_n : 0L) + (heads + h) * D + c8;
    cp_async16(ks + row * LDS + c8, src, ok);
    cp_async16(vs + row * LDS + c8, src + heads * D, ok);
  }
}

// The q R_h values, in base 2, of grid rows kh0 .. kh0 + R - 1 for this
// thread's two query rows: -inf past KH, 0 for a query past N.
template <int R>
__device__ __forceinline__ void load_rh(float (*rh)[2], const float* rh_bh,
                                        const int* rows, const bool* row_ok,
                                        int kh0, int KH) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      rh[r][i] = kh0 + r >= KH ? -INFINITY
          : row_ok[i] ? rh_bh[(long)rows[i] * KH + kh0 + r] * LOG2E : 0.f;
}

// ---------------------------------------------------------------- K7 ----

template <int KWP, int R>
__global__ void __launch_bounds__(256)
relpos_attn_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const float* __restrict__ rel_h,
                       const float* __restrict__ rel_w,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int N, int heads, int KH,
                       int KW, float scale_log2) {
  constexpr int NC = R * KWP;   // keys of a chunk
  constexpr int NT = NC / 8;    // n8 tiles of a chunk
  constexpr int WT = KWP / 8;   // n8 tiles of a grid row
  // two stages of the k and v chunks: the next is copied in while the
  // block works on this one
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int warps = blockDim.x / 32;
  const int q0 = (blockIdx.x * warps + warp) * 16;
  const long s_n = 3L * heads * D;
  const __nv_bfloat16* qkv_b = qkv + (long)b * N * s_n;
  const int rows[2] = {q0 + g, q0 + g + 8};
  const bool row_ok[2] = {rows[0] < N, rows[1] < N};

  load_chunk(stage, stage + NC * LDS, qkv_b, s_n, heads, h, 0, R, KWP, KH,
             KW);
  cp_commit();
  uint32_t qa[4][4];
  load_a_rows(qa, qkv_b + h * D, s_n, q0, N, g, t);

  // this thread's q R_w over its columns of a grid row, in base 2; -inf on
  // the padding (0 for a query past N, whose row is discarded)
  float rw[WT][2][2];
#pragma unroll
  for (int c = 0; c < WT; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kw = c * 8 + 2 * t + e;
        rw[c][r][e] = !row_ok[r] ? 0.f
            : kw < KW ? rel_w[((long)bh * N + rows[r]) * KW + kw] * LOG2E
                      : -INFINITY;
      }

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const float* rh_bh = rel_h + (long)bh * N * KH;
  float rh_next[R][2];
  load_rh<R>(rh_next, rh_bh, rows, row_ok, 0, KH);
  for (int kh0 = 0; kh0 < KH; kh0 += R) {
    const int at = kh0 / R % 2;
    const __nv_bfloat16* Ks = stage + at * 2 * NC * LDS;
    const __nv_bfloat16* Vs = Ks + NC * LDS;
    if (kh0 + R < KH) {
      __nv_bfloat16* next = stage + (1 - at) * 2 * NC * LDS;
      load_chunk(next, next + NC * LDS, qkv_b, s_n, heads, h, kh0 + R, R,
                 KWP, KH, KW);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();

    // this chunk's q R_h values (loaded a chunk ahead), then the next's
    float rh[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) rh[r][i] = rh_next[r][i];
    load_rh<R>(rh_next, rh_bh, rows, row_ok, kh0 + R, KH);

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      uint32_t kb[4][2];
      ldsm_b64(kb, Ks + j * 8 * LDS, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma16816(s[j], qa[kk], kb[kk][0], kb[kk][1]);
      const int r = j / WT, c = j % WT;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * scale_log2 + rh[r][e / 2] + rw[c][e / 2][e % 2];
    }

    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = quad_max(mx);
      alpha[i] = fast_exp2(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - m[e / 2]);
        l[e / 2] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e / 2];

    // o += p v: p from the registers, v's fragments transposed from shared
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr =
          Vs + (kk * 16 + (lane / 8 % 2) * 8 + lane % 8) * LDS + lane / 16 * 8;
#pragma unroll
      for (int dn = 0; dn < 8; dn += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vr + dn * 8);
        mma16816(o[dn], pa, vb[0], vb[1]);
        mma16816(o[dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  __nv_bfloat16* out_b = out + (long)b * N * heads * D + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const float inv = 1.f / l[i];
    __nv_bfloat16* orow = out_b + (long)rows[i] * heads * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_bf16(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
    if (t == 0) lse[(long)bh * N + rows[i]] = m[i] + log2f(l[i]);
  }
}

// ---------------------------------------------------------------- K8 ----

// delta[b, h, m] = sum_d dO * O over the 64 of a row; 8 threads a row
__global__ void relpos_attn_bwd_delta_kernel(
    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ delta, int B, int N, int heads) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  const long rows = (long)B * N * heads;
  float acc = 0.f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(out + row * D + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(d2[i]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && part == 0) {
    const int h = row % heads;
    const long bn = row / heads;
    const long b = bn / N, n = bn % N;
    delta[(b * heads + h) * N + n] = acc;
  }
}

// dK, dV: a block of four warps per 64 keys of the padded key sequence
// (grid row kh, column kw at kh * KWP + kw; a warp's 16 keys lie in one
// grid row), walking the queries MQ at a time. Each step's queries, their
// gradients, log-sum-exps and deltas, and their q R_w and q R_h values for
// the block's grid rows are copied into shared memory a step ahead.
constexpr int KV_WARPS = 4;
constexpr int KV_ROWS = 64 / 16 + 1;  // grid rows 64 padded keys can touch

struct KvStage {
  __nv_bfloat16 q[MQ * LDS];
  __nv_bfloat16 dout[MQ * LDS];
  float lse[MQ];
  float delta[MQ];
  float rh[MQ * KV_ROWS];
  float rw[1];  // [MQ][KWP + 4], the rest of the stage
};

__host__ __device__ inline int kv_stage_bytes(int KWP) {
  const int bytes = static_cast<int>(sizeof(KvStage)) - 4 + MQ * (KWP + 4) * 4;
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ void load_kv_step(
    KvStage* st, const __nv_bfloat16* qkv_b, const __nv_bfloat16* do_b,
    const float* lse_b, const float* delta_b, const float* rh_b,
    const float* rw_b, long s_n, long s_o, int h, int m0, int N, int kh_lo,
    int KH, int KW, int KWP) {
  const int RWS = KWP + 4;
  for (int i = threadIdx.x; i < MQ * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8, m = m0 + r;
    const bool ok = m < N;
    const long mm = ok ? m : 0;
    cp_async16(st->q + r * LDS + c8, qkv_b + mm * s_n + h * D + c8, ok);
    cp_async16(st->dout + r * LDS + c8, do_b + mm * s_o + c8, ok);
  }
  for (int i = threadIdx.x; i < MQ; i += blockDim.x) {
    const bool ok = m0 + i < N;
    cp_async4(st->lse + i, lse_b + (ok ? m0 + i : 0), ok);
    cp_async4(st->delta + i, delta_b + (ok ? m0 + i : 0), ok);
  }
  for (int i = threadIdx.x; i < MQ * KV_ROWS; i += blockDim.x) {
    const int r = i / KV_ROWS, kh = kh_lo + i % KV_ROWS, m = m0 + r;
    const bool ok = m < N && kh < KH;
    cp_async4(st->rh + i, rh_b + (ok ? (long)m * KH + kh : 0), ok);
  }
  if (KW % 4 == 0) {
    const int vecs = KW / 4;
    for (int i = threadIdx.x; i < MQ * vecs; i += blockDim.x) {
      const int r = i / vecs, c = (i % vecs) * 4, m = m0 + r;
      const bool ok = m < N;
      cp_async16(st->rw + r * RWS + c, rw_b + (ok ? (long)m * KW + c : 0),
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < MQ * KW; i += blockDim.x) {
      const int r = i / KW, c = i % KW, m = m0 + r;
      const bool ok = m < N;
      cp_async4(st->rw + r * RWS + c, rw_b + (ok ? (long)m * KW + c : 0), ok);
    }
  }
}

__global__ void __launch_bounds__(KV_WARPS * 32)
relpos_attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ rel_h,
                            const float* __restrict__ rel_w,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dqkv, int N,
                            int heads, int KH, int KW, int KWP, float scale,
                            float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stage_bytes = kv_stage_bytes(KWP);
  const int RWS = KWP + 4;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pk0 = blockIdx.x * 64;          // the block's first padded key
  const int kh_lo = pk0 / KWP;              // its first grid row
  const int pk = pk0 + warp * 16;           // the warp's
  const int kh = pk / KWP, kw0 = pk % KWP;
  const long s_n = 3L * heads * D;
  const long s_o = (long)heads * D;
  const __nv_bfloat16* qkv_b = qkv + (long)b * N * s_n;
  const __nv_bfloat16* do_b = dout + (long)b * N * s_o + h * D;
  const float* lse_b = lse + (long)bh * N;
  const float* delta_b = delta + (long)bh * N;
  const float* rh_b = rel_h + (long)bh * N * KH;
  const float* rw_b = rel_w + (long)bh * N * KW;
  const bool key_ok[2] = {kh < KH && kw0 + g < KW,
                          kh < KH && kw0 + g + 8 < KW};
  const int keys[2] = {kh * KW + kw0 + g, kh * KW + kw0 + g + 8};
  const int rh_at = kh - kh_lo;

  load_kv_step(reinterpret_cast<KvStage*>(smem_raw), qkv_b, do_b, lse_b,
               delta_b, rh_b, rw_b, s_n, s_o, h, 0, N, kh_lo, KH, KW, KWP);
  cp_commit();

  // this warp's 16 keys and values as A fragments, padding zero
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* kr = qkv_b + (long)keys[i] * s_n + (heads + h) * D;
      const __nv_bfloat16* vr = kr + (long)heads * D;
      ka[kk][i] = key_ok[i] ? lds32(kr + c) : 0u;
      ka[kk][2 + i] = key_ok[i] ? lds32(kr + c + 8) : 0u;
      va[kk][i] = key_ok[i] ? lds32(vr + c) : 0u;
      va[kk][2 + i] = key_ok[i] ? lds32(vr + c + 8) : 0u;
    }
  }

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int m0 = 0; m0 < N; m0 += MQ) {
    const int at = m0 / MQ % 2;
    const KvStage* st =
        reinterpret_cast<const KvStage*>(smem_raw + at * stage_bytes);
    if (m0 + MQ < N)
      load_kv_step(reinterpret_cast<KvStage*>(smem_raw +
                                              (1 - at) * stage_bytes),
                   qkv_b, do_b, lse_b, delta_b, rh_b, rw_b, s_n, s_o, h,
                   m0 + MQ, N, kh_lo, KH, KW, KWP);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const __nv_bfloat16* Qs = st->q;
    const __nv_bfloat16* dOs = st->dout;

    // p^T [16 keys][MQ queries]
    float p[MQ / 8][4];
#pragma unroll
    for (int j = 0; j < MQ / 8; ++j) {
      p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
      uint32_t qb[4][2];
      ldsm_b64(qb, Qs + j * 8 * LDS, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma16816(p[j], ka[kk], qb[kk][0], qb[kk][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + 2 * t + e % 2, i = e / 2;
        const bool ok = key_ok[i] && m0 + r < N;
        const float bias = st->rh[r * KV_ROWS + rh_at]
            + st->rw[r * RWS + kw0 + g + 8 * i];
        p[j][e] = ok ? fast_exp2(p[j][e] * scale_log2 + bias * LOG2E - st->lse[r])
                     : 0.f;
      }
    }
    // dv += p^T dO
#pragma unroll
    for (int kk = 0; kk < MQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const __nv_bfloat16* dr =
          dOs + (kk * 16 + (lane / 8 % 2) * 8 + lane % 8) * LDS + lane / 16 * 8;
#pragma unroll
      for (int dn = 0; dn < 8; dn += 2) {
        uint32_t ob[4];
        ldsm_x4_t(ob, dr + dn * 8);
        mma16816(dv[dn], pa, ob[0], ob[1]);
        mma16816(dv[dn + 1], pa, ob[2], ob[3]);
      }
    }
    // dS^T = p^T (v dO^T - delta)
#pragma unroll
    for (int j = 0; j < MQ / 8; ++j) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t ob[4][2];
      ldsm_b64(ob, dOs + j * 8 * LDS, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma16816(dp, va[kk], ob[kk][0], ob[kk][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] *= dp[e] - st->delta[j * 8 + 2 * t + e % 2];
    }
    // dk += dS^T q
#pragma unroll
    for (int kk = 0; kk < MQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const __nv_bfloat16* qr =
          Qs + (kk * 16 + (lane / 8 % 2) * 8 + lane % 8) * LDS + lane / 16 * 8;
#pragma unroll
      for (int dn = 0; dn < 8; dn += 2) {
        uint32_t qb[4];
        ldsm_x4_t(qb, qr + dn * 8);
        mma16816(dk[dn], pa, qb[0], qb[1]);
        mma16816(dk[dn + 1], pa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is refilled next
  }

  __nv_bfloat16* dq_b = dqkv + (long)b * N * s_n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!key_ok[i]) continue;
    __nv_bfloat16* kr = dq_b + (long)keys[i] * s_n + (heads + h) * D + 2 * t;
    __nv_bfloat16* vr = kr + (long)heads * D;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      *reinterpret_cast<uint32_t*>(kr + dn * 8) =
          pack_bf16(dk[dn][2 * i] * scale, dk[dn][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(vr + dn * 8) =
          pack_bf16(dv[dn][2 * i], dv[dn][2 * i + 1]);
    }
  }
}

// dQ and the bias gradients: a block of `warps` x 16 queries walking the
// key chunks as K7 does.
template <int KWP, int R>
__global__ void __launch_bounds__(256)
relpos_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ rel_h,
                          const float* __restrict__ rel_w,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dqkv,
                          float* __restrict__ drh, float* __restrict__ drw,
                          int N, int heads, int KH, int KW, float scale,
                          float scale_log2) {
  constexpr int NC = R * KWP;
  constexpr int NT = NC / 8;
  constexpr int WT = KWP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int warps = blockDim.x / 32;
  const int q0 = (blockIdx.x * warps + warp) * 16;
  const long s_n = 3L * heads * D;
  const long s_o = (long)heads * D;
  const __nv_bfloat16* qkv_b = qkv + (long)b * N * s_n;
  const int rows[2] = {q0 + g, q0 + g + 8};
  const bool row_ok[2] = {rows[0] < N, rows[1] < N};

  load_chunk(stage, stage + NC * LDS, qkv_b, s_n, heads, h, 0, R, KWP, KH,
             KW);
  cp_commit();

  uint32_t qa[4][4], da[4][4];
  load_a_rows(qa, qkv_b + h * D, s_n, q0, N, g, t);
  load_a_rows(da, dout + (long)b * N * s_o + h * D, s_o, q0, N, g, t);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = row_ok[i] ? lse[(long)bh * N + rows[i]] : 0.f;
    delta_r[i] = row_ok[i] ? delta[(long)bh * N + rows[i]] : 0.f;
  }

  float rw[WT][2][2], grw[WT][2][2];
#pragma unroll
  for (int c = 0; c < WT; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kw = c * 8 + 2 * t + e;
        rw[c][r][e] = !row_ok[r] ? 0.f
            : kw < KW ? rel_w[((long)bh * N + rows[r]) * KW + kw] * LOG2E
                      : -INFINITY;
        grw[c][r][e] = 0.f;
      }

  float dq[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const float* rh_bh = rel_h + (long)bh * N * KH;
  float rh_next[R][2];
  load_rh<R>(rh_next, rh_bh, rows, row_ok, 0, KH);
  for (int kh0 = 0; kh0 < KH; kh0 += R) {
    const int at = kh0 / R % 2;
    const __nv_bfloat16* Ks = stage + at * 2 * NC * LDS;
    const __nv_bfloat16* Vs = Ks + NC * LDS;
    if (kh0 + R < KH) {
      __nv_bfloat16* next = stage + (1 - at) * 2 * NC * LDS;
      load_chunk(next, next + NC * LDS, qkv_b, s_n, heads, h, kh0 + R, R,
                 KWP, KH, KW);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();

    // this chunk's q R_h values (loaded a chunk ahead), then the next's
    float rh[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) rh[r][i] = rh_next[r][i];
    load_rh<R>(rh_next, rh_bh, rows, row_ok, kh0 + R, KH);

    // p, then dS = p (dO v^T - delta), tile by tile
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LDS + 2 * t;
      const __nv_bfloat16* vr = Vs + (j * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma16816(s[j], qa[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
        mma16816(dp, da[kk], lds32(vr + kk * 16), lds32(vr + kk * 16 + 8));
      }
      const int r = j / WT, c = j % WT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float x = s[j][e] * scale_log2 + rh[r][i] + rw[c][i][e % 2];
        const float pv = row_ok[i] ? fast_exp2(x - lse_r[i]) : 0.f;
        s[j][e] = pv * (dp[e] - delta_r[i]);
        grw[c][i][e % 2] += s[j][e];
      }
    }
    // d rel_h: the row sum of dS over each grid row of the chunk
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < WT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e / 2] += s[r * WT + c][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i] = quad_sum(acc[i]);
        if (t == 0 && row_ok[i] && kh0 + r < KH)
          drh[((long)bh * N + rows[i]) * KH + kh0 + r] = acc[i];
      }
    }
    // dq += dS k, k's fragments transposed from shared
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* kr =
          Ks + (kk * 16 + (lane / 8 % 2) * 8 + lane % 8) * LDS + lane / 16 * 8;
#pragma unroll
      for (int dn = 0; dn < 8; dn += 2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, kr + dn * 8);
        mma16816(dq[dn], pa, kb[0], kb[1]);
        mma16816(dq[dn + 1], pa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage is refilled next
  }

  __nv_bfloat16* dq_b = dqkv + (long)b * N * s_n + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    __nv_bfloat16* qr = dq_b + (long)rows[i] * s_n + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<uint32_t*>(qr + dn * 8) =
          pack_bf16(dq[dn][2 * i] * scale, dq[dn][2 * i + 1] * scale);
    float* gr = drw + ((long)bh * N + rows[i]) * KW;
#pragma unroll
    for (int c = 0; c < WT; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kw = c * 8 + 2 * t + e;
        if (kw < KW) gr[kw] = grw[c][i][e];
      }
  }
}

// --------------------------------------------------------- launches ----

int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int Q_WARPS = 4;  // the warps of a K7 or dQ block, 16 queries each

template <int KWP, int R>
int fwd(const void* qkv, const void* rel_h, const void* rel_w, void* out,
        void* lse, int B, int N, int heads, int KH, int KW, float scale,
        cudaStream_t s) {
  const int warps = Q_WARPS;
  const int smem = 2 * 2 * R * KWP * LDS * 2;  // two stages of k and v
  auto k = relpos_attn_fwd_kernel<KWP, R>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<dim3(cdiv(N, warps * 16), B * heads), warps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), N, heads, KH, KW, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int KWP, int R>
int bwd_dq(const void* qkv, const void* rel_h, const void* rel_w,
           const void* dout, const void* lse, const void* delta, void* dqkv,
           void* drh, void* drw, int B, int N, int heads, int KH, int KW,
           float scale, cudaStream_t s) {
  const int warps = Q_WARPS;
  const int smem = 2 * 2 * R * KWP * LDS * 2;
  auto k = relpos_attn_bwd_dq_kernel<KWP, R>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<dim3(cdiv(N, warps * 16), B * heads), warps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(drh),
      static_cast<float*>(drw), N, heads, KH, KW, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// grid rows a chunk: a 14-row window in two chunks of 7; one row of a
// wider grid
int chunk_rows(int KWP, int KH) {
  return KWP == 16 ? (KH % 7 == 0 ? 7 : 4) : 1;
}

}  // namespace

// The widths taken: KW <= 128 (a grid 2,048 pixels wide at stride 16).
#define RELPOS_DISPATCH(FN, ...)                               \
  switch (KWP * 16 + R) {                                      \
    case 16 * 16 + 7: return FN<16, 7>(__VA_ARGS__);           \
    case 16 * 16 + 4: return FN<16, 4>(__VA_ARGS__);           \
    case 32 * 16 + 1: return FN<32, 1>(__VA_ARGS__);           \
    case 48 * 16 + 1: return FN<48, 1>(__VA_ARGS__);           \
    case 64 * 16 + 1: return FN<64, 1>(__VA_ARGS__);           \
    case 80 * 16 + 1: return FN<80, 1>(__VA_ARGS__);           \
    case 96 * 16 + 1: return FN<96, 1>(__VA_ARGS__);           \
    case 112 * 16 + 1: return FN<112, 1>(__VA_ARGS__);         \
    case 128 * 16 + 1: return FN<128, 1>(__VA_ARGS__);         \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

extern "C" int relpos_attn_fwd(const void* qkv, const void* rel_h,
                               const void* rel_w, void* out, void* lse, int B,
                               int N, int heads, int KH, int KW, float scale,
                               void* stream) {
  if (B == 0 || N == 0 || KH * KW != N) return B == 0 ? 0 : 1;
  const int KWP = cdiv(KW, 16) * 16, R = chunk_rows(KWP, KH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RELPOS_DISPATCH(fwd, qkv, rel_h, rel_w, out, lse, B, N, heads, KH, KW,
                  scale, s)
}

extern "C" int relpos_attn_bwd(const void* qkv, const void* rel_h,
                               const void* rel_w, const void* out,
                               const void* dout, const void* lse, void* delta,
                               void* dqkv, void* drh, void* drw, int B, int N,
                               int heads, int KH, int KW, float scale,
                               void* stream) {
  if (B == 0 || N == 0 || KH * KW != N) return B == 0 ? 0 : 1;
  const int KWP = cdiv(KW, 16) * 16, R = chunk_rows(KWP, KH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long rows = (long)B * N * heads;
  relpos_attn_bwd_delta_kernel<<<static_cast<int>((rows * 8 + 255) / 256),
                                 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta), B,
      N, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem = 2 * kv_stage_bytes(KWP);  // two stages
  err = cudaFuncSetAttribute(relpos_attn_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_attn_bwd_dkdv_kernel<<<dim3(cdiv(KH * KWP, 64), B * heads),
                                KV_WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dqkv), N, heads, KH, KW, KWP, scale,
      scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  RELPOS_DISPATCH(bwd_dq, qkv, rel_h, rel_w, dout, lse, delta, dqkv, drh, drw,
                  B, N, heads, KH, KW, scale, s)
}
