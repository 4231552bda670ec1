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
// a few bytes a token. Every product is Hopper's warpgroup product (wgmma
// m64nNk16, bf16 operands, float32 sums): four warps form 64 rows at once
// with the B operand read from shared memory once for all of them, where
// the first design (mma.sync, each warp's 16 rows re-reading whole tiles
// through ldmatrix) was held by shared memory's bandwidth to 10-15% of the
// bound. A block is two warpgroups of 64 rows each. The bf16 tiles reach
// shared memory by TMA (a 128-byte swizzle, the layout wgmma's descriptors
// read) into a ring of STAGES stages: a stage's `full` mbarrier completes
// when its bytes have landed, its `empty` one when every warp has released
// it. The [B, heads, N, N] logits never leave the registers, and each
// warpgroup's softmax overlaps the other's products.
//
// Registers decide the rest. ptxas gives a block of 384 threads 168 a
// thread whatever setmaxnreg asks later, and dQ's consumers need ~230, so
// K7's and dQ's blocks are the two warpgroups alone (256 threads, 255
// registers) and one of their threads feeds the ring, never waiting to
// start a copy; dK/dV's staging is a warpgroup's work, so its block keeps a
// producer warpgroup and its consumers (k and v tiles in shared memory,
// one step at a time) fit in 168.
//
// The design follows the bias. Keys are taken in chunks of R whole rows of
// the grid, each row padded to KWP, the least multiple of 16 >= KW (76 ->
// 80 at the 608x1216 canvas's global grid, 14 -> 16 in a 14x14 window, R =
// 7 there so that a window is two chunks). TMA's box is that shape: a 5-d
// map (d, part x head, kw, kh, image) zero-fills kw >= KW and kh >= KH. Over
// a grid row the bias of query m is rel_h[m, kh], one value, plus
// rel_w[m, :], the same KWP values for every row: a thread keeps its
// queries' q R_w values for its columns for the whole walk and reads one
// q R_h value a row, so no bias element is gathered.
//
// K7 (relpos_attn_fwd_kernel): 64 queries of one (image, head) a
// warpgroup; S = q K^T with q's A fragments in registers, the bias and an
// online softmax (in exp2) in the accumulator's registers, O += P V with p
// rounded to bf16 as the A fragments and V's descriptor transposed.
//
// K8 (one call of relpos_attn_bwd_delta_kernel, then _dkdv_kernel and
// _dq_kernel): delta = rowsum(dO * O), from the bf16 output as flash
// attention takes it. dK, dV: 64 padded keys a warpgroup (grid row kh,
// column kw at kh * KWP + kw), its k and v tiles in shared memory, walking
// the queries 64 at a time: S^T = K Q^T and dP^T = V dO^T, then dV += P^T
// dO and dK += dS^T Q with P^T and dS^T as A fragments and the same q and
// dO tiles read transposed; the producer warpgroup copies each step's
// log-sum-exps, deltas and q R_h, q R_w values (cp.async) into the stage
// beside the tiles. dQ: 64 queries a warpgroup walking the key chunks as K7
// does, q and dO tiles in shared memory: S and dP = dO V^T, dQ += dS K (the
// next chunk's S and dP in flight behind it), and the bias gradients exact
// in float32: d rel_h[m, kh] is the row sum of dS over grid row kh (a quad
// shuffle, one store each), d rel_w[m, kw] its sum over the rows, kept in
// registers and stored once. Every output element is written once: no
// atomics, the same bits every call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;             // head width
constexpr int ROW = D * 2;        // bytes of a tile's row: one swizzle row
constexpr int QT = 64 * ROW;      // bytes of a warpgroup's 64-row tile
constexpr int CONSUMERS = 2;      // consumer warpgroups a block
constexpr int THREADS = CONSUMERS * 128;
constexpr int STAGES = 3;         // tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p: TMA's 128-byte swizzle and
// wgmma's descriptors agree on tiles placed there
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
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

// --------------------------------------------------- mbarriers, copies ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more from TMA in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the phase of parity `parity` to complete; a phase that never
// completes is a fault, and traps (a launch error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// one arrival on `bar` once this thread's cp.async copies so far are done
// (counted in the barrier's arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Asynchronous copies to shared memory (cp.async): `ok` false fills the
// destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}

// TMA: a box of `map` at the coordinates (innermost first) into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma4(void* dst, const CUtensorMap& map,
                                     uint64_t* bar, int c0, int c1, int c2,
                                     int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(&map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma5(void* dst, const CUtensorMap& map,
                                     uint64_t* bar, int c0, int c1, int c2,
                                     int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(&map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// ------------------------------------------------------------- wgmma ----

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until every committed group is done
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}


// Hold the compiler's reads and writes of registers that an asynchronous
// product writes or reads on their side of its start or its wait.
template <int K>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int K>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// The descriptor of a tile of 128-byte rows in shared memory, 128-byte
// swizzled as TMA wrote it: 8-row groups 1024 bytes apart (the stride
// along K of a transposed operand, along M or N of one in K order, the one
// that matters either way), a 1024-byte-aligned base. Adding 2 steps K by
// 16 elements within a row; adding 128 steps 16 rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFFu) >> 4) |
         (64ull << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, bf16 in, float32 sums d[N / 2] (this thread's
// share: d[4i .. 4i + 3] are rows g, g, g + 8, g + 8 of the warp's 16 and
// columns 8i + 2t, + 1, as mma.sync's), scaled in (acc != 0) or not. rs: A
// from registers (a[4], the m16n8k16 A fragment of the warp's 16 rows), B
// from shared memory, transposed if TB; ss: both from shared memory, in K
// order.
#define R8_0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define R8_1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define R8_2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define R8_3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define R8_4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define R8_5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define R8_6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define R8_7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        R8_0 R8_1
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : D8(0), D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        R8_0 R8_1
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : D8(0), D8(8)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<48> {
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : D8(0), D8(8), D8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : D8(0), D8(8), D8(16)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : D8(0), D8(8), D8(16), D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : D8(0), D8(8), D8(16), D8(24)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<80> {
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        R8_4
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : D8(0), D8(8), D8(16), D8(24),
        D8(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        R8_4
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : D8(0), D8(8), D8(16), D8(24),
        D8(32)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<96> {
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        R8_4 R8_5
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : D8(0), D8(8), D8(16), D8(24),
        D8(32), D8(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        R8_4 R8_5
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : D8(0), D8(8), D8(16), D8(24),
        D8(32), D8(40)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<112> {
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        R8_4 R8_5 R8_6
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
        : D8(0), D8(8), D8(16), D8(24),
        D8(32), D8(40), D8(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        R8_4 R8_5 R8_6
        "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
        : D8(0), D8(8), D8(16), D8(24),
        D8(32), D8(40), D8(48)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        R8_4 R8_5 R8_6 R8_7
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : D8(0), D8(8), D8(16), D8(24),
        D8(32), D8(40), D8(48), D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        R8_0 R8_1 R8_2 R8_3
        R8_4 R8_5 R8_6 R8_7
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : D8(0), D8(8), D8(16), D8(24),
        D8(32), D8(40), D8(48), D8(56)
        : "l"(a), "l"(b), "r"(acc));
  }
};


#undef R8_0
#undef R8_1
#undef R8_2
#undef R8_3
#undef R8_4
#undef R8_5
#undef R8_6
#undef R8_7
#undef D8

// d [64 x N] = A B^T: A the warpgroup's 64 rows x 64 as A fragments a[4]
// (one per 16 of the depth), B [N rows][64] in K order at `b`
template <int N>
__device__ __forceinline__ void mma_rk(float* d, const uint32_t (*a)[4],
                                       const unsigned char* b) {
  const uint64_t desc = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<N>::template rs<0>(d, a[kk], desc + 2 * kk, kk);
}

// d [64 x N] = A B^T, A [64 rows][64] and B [N rows][64] in K order
template <int N>
__device__ __forceinline__ void mma_sk(float* d, const unsigned char* a,
                                       const unsigned char* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Wgmma<N>::ss(d, da + 2 * kk, db + 2 * kk, kk);
}

// d [64 x 64] += A B: A [64 x K] as A fragments a[K / 16], B [K rows][64]
// at `b`, read transposed
template <int K>
__device__ __forceinline__ void mma_rt(float* d, const uint32_t (*a)[4],
                                       const unsigned char* b) {
  const uint64_t desc = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    Wgmma<64>::template rs<1>(d, a[kk], desc + 128 * kk, 1);
}

// the A fragments, in bf16, of the 64 x (8 NT) values s[NT][4] in the
// accumulator's layout: a[kk] holds columns 16 kk .. 16 kk + 15
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (*a)[4], const float (*s)[4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
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
    a[kk][0] = ok0 ? ld32(r0 + c) : 0u;
    a[kk][1] = ok1 ? ld32(r1 + c) : 0u;
    a[kk][2] = ok0 ? ld32(r0 + c + 8) : 0u;
    a[kk][3] = ok1 ? ld32(r1 + c + 8) : 0u;
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

// This thread's q R_w values over its columns of a grid row, in base 2;
// -inf on the padding (0 for a query past N, whose row is discarded).
template <int WT>
__device__ __forceinline__ void load_rw(float (*rw)[2][2], const float* rw_bh,
                                        const int* rows, const bool* row_ok,
                                        int t, int KW) {
#pragma unroll
  for (int c = 0; c < WT; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kw = c * 8 + 2 * t + e;
        rw[c][r][e] = !row_ok[r] ? 0.f
            : kw < KW ? rw_bh[(long)rows[r] * KW + kw] * LOG2E : -INFINITY;
      }
}

// The k and v chunks of K7's and dQ's walk, put into the ring by one
// consumer thread (the feeder, the block's first) as stages come free: it
// never waits to start a copy, so it goes on with its warpgroup's work, and
// pumps again while it waits for a chunk to land. A stage is refilled once
// every consumer warp has released it.
struct ChunkFeed {
  const CUtensorMap* map;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int tile, chunks, R, heads, h, b;
  int sent = 0;

  __device__ void pump() {
    for (; sent < chunks; ++sent) {
      const int s = sent % STAGES;
      if (!mbar_test(&empty[s], (sent / STAGES & 1) ^ 1)) return;
      mbar_expect_tx(&full[s], 2 * tile);
      unsigned char* kv = ring + s * 2 * tile;
      tma5(kv, *map, &full[s], 0, heads + h, 0, sent * R, b);
      tma5(kv + tile, *map, &full[s], 0, 2 * heads + h, 0, sent * R, b);
    }
  }

  // wait for chunk c to land (a phase that never completes traps)
  __device__ void wait(int c, bool feeder) {
    const int s = c % STAGES, parity = c / STAGES & 1;
    for (uint32_t tries = 0; !mbar_test(&full[s], parity); ++tries) {
      if (feeder) pump();
      if (tries == (1u << 24)) __trap();
    }
  }
};

// the barriers of a ring: `full` completes when a stage has landed,
// `empty` when every consumer warp has released it
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int full_arrivals) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&full[s], full_arrivals);
    mbar_init(&empty[s], CONSUMERS * 4);
  }
}

// a consumer warp's release of a stage it has finished reading
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ---------------------------------------------------------------- K7 ----

template <int KWP, int R>
__global__ void __launch_bounds__(THREADS, 1)
relpos_attn_fwd_kernel(const __grid_constant__ CUtensorMap kv_map,
                       const __nv_bfloat16* __restrict__ qkv,
                       const float* __restrict__ rel_h,
                       const float* __restrict__ rel_w,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int N, int heads, int KH,
                       int KW, float scale_log2) {
  constexpr int NC = R * KWP;     // keys of a chunk
  constexpr int NT = NC / 8;      // n8 tiles of a chunk
  constexpr int WT = KWP / 8;     // n8 tiles of a grid row
  constexpr int TILE = NC * ROW;  // bytes of a chunk of k (or of v)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // [STAGES][k, v]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TILE);
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int chunks = (KH + R - 1) / R;
  if (threadIdx.x == 0) {
    init_ring(full, empty, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const bool feeder = threadIdx.x == 0;
  ChunkFeed feed{&kv_map, ring, full, empty, TILE, chunks, R, heads, h, b};
  if (feeder) feed.pump();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = (blockIdx.x * CONSUMERS + wg) * 64 + warp * 16;
  const long s_n = 3L * heads * D;
  const __nv_bfloat16* qkv_b = qkv + (long)b * N * s_n;
  const int rows[2] = {q0 + g, q0 + g + 8};
  const bool row_ok[2] = {rows[0] < N, rows[1] < N};

  uint32_t qa[4][4];
  load_a_rows(qa, qkv_b + h * D, s_n, q0, N, g, t);
  float rw[WT][2][2];
  load_rw<WT>(rw, rel_w + (long)bh * N * KW, rows, row_ok, t, KW);

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  pin<32>(&o[0][0]);  // set before any product is in flight
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const float* rh_bh = rel_h + (long)bh * N * KH;
  float rh_next[R][2];
  load_rh<R>(rh_next, rh_bh, rows, row_ok, 0, KH);
  for (int c = 0; c < chunks; ++c) {
    const int kh0 = c * R, st = c % STAGES;
    const unsigned char* ks = ring + st * 2 * TILE;

    float s[NT][4];
    feed.wait(c, feeder);
    wg_fence();
    mma_rk<NC>(&s[0][0], qa, ks);
    wg_commit();

    // this chunk's q R_h values (loaded a chunk ahead), then the next's
    float rh[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) rh[r][i] = rh_next[r][i];
    load_rh<R>(rh_next, rh_bh, rows, row_ok, kh0 + R, KH);

    wg_wait();
    pin<NT * 4>(&s[0][0]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = j / WT, cc = j % WT;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * scale_log2 + rh[r][e / 2] + rw[cc][e / 2][e % 2];
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

    // o += p v: p from the registers, v transposed from the stage
    uint32_t pa[NC / 16][4];
    to_a<NT>(pa, s);
    wg_fence();
    mma_rt<NC>(&o[0][0], pa, ks + TILE);
    wg_commit();
    wg_wait();
    pin<32>(&o[0][0]);
    pin<NC / 4>(&pa[0][0]);
    release(&empty[st], lane);
    if (feeder) feed.pump();
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

// dK, dV: a block holds KV_KEYS padded keys (grid row kh, column kw at
// kh * KWP + kw; a warp's 16 keys lie in one grid row), a warpgroup 64 of
// them, and walks the queries 64 at a time. A stage holds a step's q and
// dO tiles (TMA) and its log-sum-exps, deltas, and q R_h values for the
// block's grid rows and q R_w values (cp.async by the producer warp).
constexpr int KV_KEYS = CONSUMERS * 64;
constexpr int KV_THREADS = THREADS + 128;  // and the producer warpgroup
constexpr int KV_ROWS = 9;  // grid rows KV_KEYS padded keys can touch
// byte offsets in a stage: the q and dO tiles; [64][2] log-sum-exp and
// delta of each query; q R_h [KV_ROWS][64] and q R_w [64][KWP + 4], laid
// out so that a thread reads its two neighbouring queries' values of one
// grid row in one load, and the warp's q R_w loads meet no bank twice
constexpr int ST_LD = 2 * QT;
constexpr int ST_RH = ST_LD + 64 * 2 * 4;
constexpr int ST_RW = ST_RH + KV_ROWS * 64 * 4;

// The entries pt, pt + 128, ... of a [64][cols] table, as (row r, column
// c), without a division a step: the producer warpgroup's share of a copy.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int pt, int cols_)
      : r(pt / cols_), c(pt % cols_), dr(128 / cols_), dc(128 % cols_),
        cols(cols_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

__host__ __device__ inline int kv_stage_bytes(int KWP) {
  return (ST_RW + 64 * (KWP + 4) * 4 + 1023) / 1024 * 1024;
}

__global__ void __launch_bounds__(KV_THREADS, 1)
relpos_attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ rel_h,
                            const float* __restrict__ rel_w,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dqkv, int N,
                            int heads, int KH, int KW, int KWP, float scale,
                            float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const int stage_bytes = kv_stage_bytes(KWP);
  const int RWS = KWP + 4;
  unsigned char* ring = align1024(smem_raw);
  unsigned char* kv_tiles = ring + STAGES * stage_bytes;  // [CONSUMERS][k, v]
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_tiles + CONSUMERS * 2 * QT);
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int pk0 = blockIdx.x * KV_KEYS;  // the block's first padded key
  const int kh_lo = pk0 / KWP;           // its first grid row
  const int steps = (N + 63) / 64;
  const long s_n = 3L * heads * D;
  if (threadIdx.x == 0) {
    init_ring(full, empty, 1 + 128);  // the TMA's thread, 128 cp.async's
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    const int pt = threadIdx.x - CONSUMERS * 128;
    const float* lse_b = lse + (long)bh * N;
    const float* delta_b = delta + (long)bh * N;
    const float* rh_b = rel_h + (long)bh * N * KH;
    const float* rw_b = rel_w + (long)bh * N * KW;
    // q R_h: [64][rows_kv] values a step; q R_w: [64][KW / 4] vectors of
    // 16 bytes, or [64][KW] values where rows are not 16-byte aligned
    const int rows_kv = (pk0 + KV_KEYS - 1) / KWP - kh_lo + 1;
    const int rw_vec = KW % 4 == 0 ? 4 : 1, rw_cols = KW / rw_vec;
    const Walk rh_walk(pt, rows_kv), rw_walk(pt, rw_cols);
    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES, m0 = i * 64;
      unsigned char* st = ring + s * stage_bytes;
      mbar_wait(&empty[s], (i / STAGES & 1) ^ 1);
      if (pt == 0) {
        mbar_expect_tx(&full[s], 2 * QT);
        tma4(st, q_map, &full[s], 0, h, m0, b);
        tma4(st + QT, do_map, &full[s], 0, h, m0, b);
      }
      if (pt < 64) {
        const bool ok = m0 + pt < N;
        const long mm = ok ? m0 + pt : 0;
        cp_async4(st + ST_LD + 8 * pt, lse_b + mm, ok);
        cp_async4(st + ST_LD + 8 * pt + 4, delta_b + mm, ok);
      }
      float* srh = reinterpret_cast<float*>(st + ST_RH);
      for (Walk w = rh_walk; w.r < 64; w.next()) {
        const int kh = kh_lo + w.c;
        const bool ok = m0 + w.r < N && kh < KH;
        cp_async4(srh + w.c * 64 + w.r,
                  rh_b + (ok ? (long)(m0 + w.r) * KH + kh : 0), ok);
      }
      float* srw = reinterpret_cast<float*>(st + ST_RW);
      for (Walk w = rw_walk; w.r < 64; w.next()) {
        const bool ok = m0 + w.r < N;
        const int c = w.c * rw_vec;
        const float* src = rw_b + (ok ? (long)(m0 + w.r) * KW + c : 0);
        if (rw_vec == 4)
          cp_async16(srw + w.r * RWS + c, src, ok);
        else
          cp_async4(srw + w.r * RWS + c, src, ok);
      }
      cp_async_arrive(&full[s]);
    }
  } else {
    const int lane = threadIdx.x % 32;
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int g = lane / 4, t = lane % 4;
    const int pk = pk0 + wg * 64 + warp * 16;  // the warp's first key
    const int kh = pk / KWP, kw0 = pk % KWP;
    const __nv_bfloat16* qkv_b = qkv + (long)b * N * s_n;
    const bool key_ok[2] = {kh < KH && kw0 + g < KW,
                            kh < KH && kw0 + g + 8 < KW};
    const int keys[2] = {kh * KW + kw0 + g, kh * KW + kw0 + g + 8};
    const int rh_at = kh - kh_lo;

    // this warpgroup's 64 keys and values, padding zero, into tiles laid
    // out as TMA lays them (16-byte chunk c of row r at c ^ (r % 8)); then
    // visible to wgmma (the async proxy) and to the whole warpgroup
    unsigned char* k_tile = kv_tiles + wg * 2 * QT;
    unsigned char* v_tile = k_tile + QT;
    for (int i = threadIdx.x % 128; i < 64 * 8; i += 128) {
      const int r = i / 8, c = i % 8;
      const int pkr = pk0 + wg * 64 + r, khr = pkr / KWP, kwr = pkr % KWP;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (khr < KH && kwr < KW) {
        const __nv_bfloat16* kr =
            qkv_b + (long)(khr * KW + kwr) * s_n + (heads + h) * D + c * 8;
        kv = *reinterpret_cast<const uint4*>(kr);
        vv = *reinterpret_cast<const uint4*>(kr + heads * D);
      }
      const int at = r * ROW + (c ^ (r % 8)) * 16;
      *reinterpret_cast<uint4*>(k_tile + at) = kv;
      *reinterpret_cast<uint4*>(v_tile + at) = vv;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

    float dk[8][4], dv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
    pin<32>(&dk[0][0]);  // set before any product is in flight
    pin<32>(&dv[0][0]);
    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES, m0 = i * 64;
      const unsigned char* st = ring + s * stage_bytes;
      const float* sld = reinterpret_cast<const float*>(st + ST_LD);
      const float* srh =
          reinterpret_cast<const float*>(st + ST_RH) + rh_at * 64;
      const float* srw = reinterpret_cast<const float*>(st + ST_RW);

      // p^T and dP^T [64 keys][64 queries]
      float p[8][4], dp[8][4];
      mbar_wait(&full[s], i / STAGES & 1);
      wg_fence();
      mma_sk<64>(&p[0][0], k_tile, st);
      mma_sk<64>(&dp[0][0], v_tile, st + QT);
      wg_commit();
      wg_wait();
      pin<32>(&p[0][0]);
      pin<32>(&dp[0][0]);

      // p = 2^(logit - lse) and dS^T = p^T (dP^T - delta), query by query
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r0 = j * 8 + 2 * t;
        const float4 ld = *reinterpret_cast<const float4*>(sld + 2 * r0);
        const float2 rh = *reinterpret_cast<const float2*>(srh + r0);
        const float base2[2] = {rh.x * LOG2E - ld.x, rh.y * LOG2E - ld.z};
        const float dl2[2] = {ld.y, ld.w};
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int r = r0 + e2;
          const float base = base2[e2], dl = dl2[e2];
          const bool q_ok = m0 + r < N;
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int e = 2 * i2 + e2;
            const float x = p[j][e] * scale_log2 +
                            srw[r * RWS + kw0 + g + 8 * i2] * LOG2E + base;
            const float pv = key_ok[i2] && q_ok ? fast_exp2(x) : 0.f;
            p[j][e] = pv;
            dp[j][e] = pv * (dp[j][e] - dl);
          }
        }
      }
      // dv += p^T dO, dk += dS^T q: the stage's tiles read transposed
      uint32_t pa[4][4], da[4][4];
      to_a<8>(pa, p);
      to_a<8>(da, dp);
      wg_fence();
      mma_rt<64>(&dv[0][0], pa, st + QT);
      mma_rt<64>(&dk[0][0], da, st);
      wg_commit();
      wg_wait();
      pin<32>(&dv[0][0]);
      pin<32>(&dk[0][0]);
      pin<16>(&pa[0][0]);
      pin<16>(&da[0][0]);
      release(&empty[s], lane);
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
}

// dQ and the bias gradients: 64 queries a warpgroup walking the key chunks
// as K7 does, the q and dO tiles in shared memory (TMA, once).
template <int KWP, int R>
__global__ void __launch_bounds__(THREADS, 1)
relpos_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap kv_map,
                          const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ rel_h,
                          const float* __restrict__ rel_w,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dqkv,
                          float* __restrict__ drh, float* __restrict__ drw,
                          int N, int heads, int KH, int KW, float scale,
                          float scale_log2) {
  constexpr int NC = R * KWP;
  constexpr int NT = NC / 8;
  constexpr int WT = KWP / 8;
  constexpr int TILE = NC * ROW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // [STAGES][k, v]
  unsigned char* q_tiles = ring + STAGES * 2 * TILE;  // [CONSUMERS]
  unsigned char* do_tiles = q_tiles + CONSUMERS * QT;   // [CONSUMERS]
  uint64_t* full = reinterpret_cast<uint64_t*>(do_tiles + CONSUMERS * QT);
  uint64_t* empty = full + STAGES;
  uint64_t* tiles_in = empty + STAGES;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int chunks = (KH + R - 1) / R;
  const int m_blk = blockIdx.x * CONSUMERS * 64;
  if (threadIdx.x == 0) {
    init_ring(full, empty, 1);
    mbar_init(tiles_in, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const bool feeder = threadIdx.x == 0;
  ChunkFeed feed{&kv_map, ring, full, empty, TILE, chunks, R, heads, h, b};
  if (feeder) {
    mbar_expect_tx(tiles_in, 2 * CONSUMERS * QT);
    for (int w = 0; w < CONSUMERS; ++w) {
      tma4(q_tiles + w * QT, q_map, tiles_in, 0, h, m_blk + 64 * w, b);
      tma4(do_tiles + w * QT, do_map, tiles_in, 0, h, m_blk + 64 * w, b);
    }
    feed.pump();
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = m_blk + wg * 64 + warp * 16;
  const int rows[2] = {q0 + g, q0 + g + 8};
  const bool row_ok[2] = {rows[0] < N, rows[1] < N};
  const unsigned char* q_tile = q_tiles + wg * QT;
  const unsigned char* do_tile = do_tiles + wg * QT;

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = row_ok[i] ? lse[(long)bh * N + rows[i]] : 0.f;
    delta_r[i] = row_ok[i] ? delta[(long)bh * N + rows[i]] : 0.f;
  }
  float rw[WT][2][2], grw[WT][2][2];
  load_rw<WT>(rw, rel_w + (long)bh * N * KW, rows, row_ok, t, KW);
#pragma unroll
  for (int c = 0; c < WT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) grw[c][e / 2][e % 2] = 0.f;

  float dq[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  pin<32>(&dq[0][0]);  // set before any product is in flight

  const float* rh_bh = rel_h + (long)bh * N * KH;
  float rh_next[R][2];
  load_rh<R>(rh_next, rh_bh, rows, row_ok, 0, KH);
  // s, dp: a chunk's logits and dP = dO v^T, the next chunk's formed
  // behind this one's dQ
  float s[NT][4], dp[NT][4];
  uint32_t da[NC / 16][4];
  mbar_wait(tiles_in, 0);
  feed.wait(0, feeder);
  wg_fence();
  mma_sk<NC>(&s[0][0], q_tile, ring);
  mma_sk<NC>(&dp[0][0], do_tile, ring + TILE);
  wg_commit();
  for (int c = 0; c < chunks; ++c) {
    const int kh0 = c * R, st = c % STAGES;

    // this chunk's q R_h values (loaded a chunk ahead), then the next's
    float rh[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) rh[r][i] = rh_next[r][i];
    load_rh<R>(rh_next, rh_bh, rows, row_ok, kh0 + R, KH);

    wg_wait();  // this chunk's products, and the last one's dQ
    pin<NT * 4>(&s[0][0]);
    pin<NT * 4>(&dp[0][0]);
    pin<32>(&dq[0][0]);
    pin<NC / 4>(&da[0][0]);
    if (c > 0) {
      release(&empty[(c - 1) % STAGES], lane);
      if (feeder) feed.pump();
    }
    // dS = p (dP - delta), p = 2^(logit - lse)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = j / WT, cc = j % WT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float x = s[j][e] * scale_log2 + rh[r][i] + rw[cc][i][e % 2];
        const float pv = row_ok[i] ? fast_exp2(x - lse_r[i]) : 0.f;
        s[j][e] = pv * (dp[j][e] - delta_r[i]);
        grw[cc][i][e % 2] += s[j][e];
      }
    }
    // d rel_h: the row sum of dS over each grid row of the chunk
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int cc = 0; cc < WT; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e / 2] += s[r * WT + cc][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i] = quad_sum(acc[i]);
        if (t == 0 && row_ok[i] && kh0 + r < KH)
          drh[((long)bh * N + rows[i]) * KH + kh0 + r] = acc[i];
      }
    }
    // dq += dS k, k transposed from the stage
    to_a<NT>(da, s);
    wg_fence();
    mma_rt<NC>(&dq[0][0], da, ring + st * 2 * TILE);
    wg_commit();
    if (c + 1 < chunks) {
      const int sn = (c + 1) % STAGES;
      const unsigned char* ks = ring + sn * 2 * TILE;
      feed.wait(c + 1, feeder);
      wg_fence();
      mma_sk<NC>(&s[0][0], q_tile, ks);
      mma_sk<NC>(&dp[0][0], do_tile, ks + TILE);
      wg_commit();
    }
  }
  wg_wait();
  pin<32>(&dq[0][0]);
  release(&empty[(chunks - 1) % STAGES], lane);

  __nv_bfloat16* dq_b = dqkv + (long)b * N * 3L * heads * D + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    __nv_bfloat16* qr = dq_b + (long)rows[i] * 3L * heads * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<uint32_t*>(qr + dn * 8) =
          pack_bf16(dq[dn][2 * i] * scale, dq[dn][2 * i + 1] * scale);
    float* gr = drw + ((long)bh * N + rows[i]) * KW;
#pragma unroll
    for (int cc = 0; cc < WT; ++cc)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kw = cc * 8 + 2 * t + e;
        if (kw < KW) gr[kw] = grw[cc][i][e];
      }
  }
}

// --------------------------------------------------------- launches ----

int cdiv(int a, int b) { return (a + b - 1) / b; }

// cuTensorMapEncodeTiled, looked up in the CUDA library the runtime has
// loaded
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a bf16 tensor of `rank` dims (innermost first; `strides` in
// bytes, of dims 1 ..) read in boxes `box` with the 128-byte swizzle,
// zeros outside. -> 0, or 10000 + the driver's error.
int bf16_map(CUtensorMap* map, const void* base, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// k and v of qkv as (d, part x head, kw, kh, image), a box R grid rows of
// KWP keys
int kv_map(CUtensorMap* map, const void* qkv, int B, int N, int heads,
           int KH, int KW, int KWP, int R) {
  const cuuint64_t tok = 3ull * heads * ROW;
  const cuuint64_t dims[5] = {D, 3ull * heads, (cuuint64_t)KW, (cuuint64_t)KH,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {ROW, tok, tok * KW, tok * N};
  const cuuint32_t box[5] = {D, 1, (cuuint32_t)KWP, (cuuint32_t)R, 1};
  return bf16_map(map, qkv, 5, dims, strides, box);
}

// a tensor of `parts` rows of 64 a token as (d, part, token, image), a box
// 64 tokens of one part
int token_map(CUtensorMap* map, const void* base, int B, int N, int parts) {
  const cuuint64_t tok = (cuuint64_t)parts * ROW;
  const cuuint64_t dims[4] = {D, (cuuint64_t)parts, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {ROW, tok, tok * N};
  const cuuint32_t box[4] = {D, 1, 64, 1};
  return bf16_map(map, base, 4, dims, strides, box);
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int KWP, int R>
int fwd(const void* qkv, const void* rel_h, const void* rel_w, void* out,
        void* lse, int B, int N, int heads, int KH, int KW, float scale,
        cudaStream_t s) {
  CUtensorMap kv;
  int err = kv_map(&kv, qkv, B, N, heads, KH, KW, KWP, R);
  if (err != 0) return err;
  const int smem = 1024 + STAGES * 2 * R * KWP * ROW + 2 * STAGES * 8;
  auto k = relpos_attn_fwd_kernel<KWP, R>;
  if ((err = allow_smem(k, smem)) != 0) return err;
  k<<<dim3(cdiv(N, CONSUMERS * 64), B * heads), THREADS, smem, s>>>(
      kv, static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), N, heads,
      KH, KW, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int KWP, int R>
int bwd_dq(const CUtensorMap& q, const CUtensorMap& dout, const void* qkv,
           const void* rel_h, const void* rel_w, const void* lse,
           const void* delta, void* dqkv, void* drh, void* drw, int B, int N,
           int heads, int KH, int KW, float scale, cudaStream_t s) {
  CUtensorMap kv;
  int err = kv_map(&kv, qkv, B, N, heads, KH, KW, KWP, R);
  if (err != 0) return err;
  const int smem = 1024 + STAGES * 2 * R * KWP * ROW + 2 * CONSUMERS * QT +
                   (2 * STAGES + 1) * 8;
  auto k = relpos_attn_bwd_dq_kernel<KWP, R>;
  if ((err = allow_smem(k, smem)) != 0) return err;
  k<<<dim3(cdiv(N, CONSUMERS * 64), B * heads), THREADS, smem, s>>>(
      kv, q, dout, static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dqkv),
      static_cast<float*>(drh), static_cast<float*>(drw), N, heads, KH, KW,
      scale, scale * LOG2E);
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
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  CUtensorMap q, dmap;
  if ((err = token_map(&q, qkv, B, N, 3 * heads)) != 0) return err;
  if ((err = token_map(&dmap, dout, B, N, heads)) != 0) return err;
  const int smem = 1024 + STAGES * kv_stage_bytes(KWP) + CONSUMERS * 2 * QT +
                   2 * STAGES * 8;
  if ((err = allow_smem(relpos_attn_bwd_dkdv_kernel, smem)) != 0) return err;
  relpos_attn_bwd_dkdv_kernel<<<dim3(cdiv(KH * KWP, KV_KEYS), B * heads),
                                KV_THREADS, smem, s>>>(
      q, dmap, static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dqkv), N, heads, KH, KW, KWP, scale,
      scale * LOG2E);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

  RELPOS_DISPATCH(bwd_dq, q, dmap, qkv, rel_h, rel_w, lse, delta, dqkv, drh,
                  drw, B, N, heads, KH, KW, scale, s)
}
