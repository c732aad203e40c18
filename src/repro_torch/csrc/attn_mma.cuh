// Fence-free tensor-core building blocks of the port's attention kernels
// (sm_90a): ws_attention.cu's flash tiles and flash_fwd.cu's bf16 body; the
// expert tiles of ws_expert_mma.cuh and decode_attention.cu's ring use them
// too.
//
// Only warp-synchronous instructions and asynchronous copies with their own
// wait: `ldmatrix`, `mma.sync.m16n8k16` (bf16 in, fp32 accumulate) and
// `cp.async` with `commit_group` / `wait_group`.  No wgmma (its
// `wgmma.fence` is a PTX fence), no TMA (`fence.proxy.async`, mbarrier
// inits): the kernels' audit counts every PTX `fence.` and SASS FENCE /
// MEMBAR / ATOM / RED, and these blocks add none.  Copies become visible
// to the other threads of a CTA through `__syncthreads()` after the wait.
//
// Fragments of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A 16x16 (row-major): a[0] (g, 2t..2t+1), a[1] (g+8, 2t..), a[2] (g,
//     8+2t..), a[3] (g+8, 8+2t..), two bf16 a register, lower column low.
//   B 16x8 ("col"): b[0] (k 2t..2t+1, n g), b[1] (k 8+2t.., n g).
//   C/D 16x8 fp32: c[0], c[1] (g, 2t..2t+1), c[2], c[3] (g+8, 2t..2t+1).
// So a thread holds two rows of every tile, g and g + 8, and the four
// threads of a quad (same g) hold a row between them: a row's max and sum
// are quad shuffles.  Two adjacent 8-key C tiles of scores are, once
// exponentiated and packed, the A fragment of the 16-key product P V.
//
// Softmax weights in two bf16 parts.  P V with P rounded once to bf16 errs
// by up to 2^-9 |v| on a row that sees few keys, ten times the 1e-4 the
// kernels are held to.  P = hi + lo with hi = bf16(P), lo = bf16(P - hi)
// leaves |P - hi - lo| <= 2^-18 |P|; two products (hi V, lo V) replace
// one, on the same V fragments.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dtype_io.cuh"  // NEG_INF

namespace amma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; `full` false zero-fills the 16
// bytes and reads nothing (a row past the end, a padding column).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// The same, each matrix transposed (a k-major tile read as the B operand).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// d += a b over one 16 x 8 x 16 step.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16 pair, lo = bf16 pair of the remainders.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A fragments (hi and lo parts) of the 16 x 16 weights held in two
// adjacent 8-key C tiles p0 (keys 0-7) and p1 (keys 8-15).
__device__ __forceinline__ void weights_a(const float (&p0)[4], const float (&p1)[4],
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(p0[0], p0[1], hi[0], lo[0]);
  split2(p0[2], p0[3], hi[1], lo[1]);
  split2(p1[0], p1[1], hi[2], lo[2]);
  split2(p1[2], p1[3], hi[3], lo[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax step on NTILE C tiles of scores (8 keys each) for the
// thread's two rows r = 0 (g) and r = 1 (g + 8): the rows' running max m
// (quad-uniform), the thread's share l of the running sums (its own keys'
// weights; quad_sum them at the end), and corr, the factor the rows'
// accumulators must be scaled by.  The scores become the weights
// exp(s - m).  m starts at NEG_INF, so a masked score (NEG_INF) weighs 1
// until a live key raises the max, and an absent key (-inf) weighs 0.
template <int NTILE>
__device__ __forceinline__ void softmax_step(float (&s)[NTILE][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NTILE; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));
    corr[r] = expf(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NTILE; ++n) {
      s[n][2 * r] = expf(s[n][2 * r] - m_new);
      s[n][2 * r + 1] = expf(s[n][2 * r + 1] - m_new);
      sum += s[n][2 * r] + s[n][2 * r + 1];
    }
    l[r] = l[r] * corr[r] + sum;
    m[r] = m_new;
  }
}

}  // namespace amma
