// The first expert tile of the work-stealing MoE kernels: rows of one
// expert's gated FFN, now used by csrc/ws_unified.cu alone (the unified
// engine step's OP_EXPERT_TILE; csrc/ws_expert.cu runs ws_expert_mma.cuh).
//
// Replaces the tile body `_expert_execute` of repro/moe_ws/expert_kernel.py
// (and its unified form, `expert_ffn` in repro/models/unified.py).  For
// `rows` routed rows starting at `tok` / `out`:
//   gather   xt = x[tok[0 : rows]]                           [rows, d] fp32
//   FFN      y  = (silu(xt wg) * (xt wu)) wd                 [rows, d] fp32
//   mask     rows at or past `live` are zero
//   write    out[0 : rows] = y (store) or += y (accumulate)
// with wg/wu [d, f] and wd [f, d] the expert's weights (bf16 or fp32) and
// fp32 accumulation.
//
// What bounds it on this card.  A decode-time tile has a handful of live
// rows, so it reads 3 d f weights for ~6 rows d f flops: bytes.  At full
// width (d 7168, f 2048) the x tile [bt, d] fp32 does not fit beside the
// hidden tile, so x is staged through shared memory in chunks of DC columns
// and only the hidden tile h [RB, f] stays there.  In the first product each
// thread owns CPT consecutive f columns and in the second CPT consecutive d
// columns, so each weight row is read once per RB rows by one 16-byte load
// per thread (CPT 8 bf16, or CPT 4 fp32; CPT 8 fp32 is two), coalesced
// across the warp, and reused for RB rows from registers.  Shared memory:
// expert_tile_smem().  RB x CPT x 2 accumulators a thread: 128 at RB 8 and
// CPT 8 (a 256-thread CTA), 64 at CPT 4 (a 512-thread CTA, 128 registers a
// thread).  Simple, not fast: fp32 FMAs on CUDA cores, plain loads, one
// tile per CTA.

#pragma once

#include <cuda_runtime.h>

#include "ws_load8.cuh"

#define EXPERT_DC 1024  // x columns staged in shared memory per chunk

// CPT consecutive weights from p as fp32 (p 16-byte aligned).
template <int CPT>
__device__ __forceinline__ void load_cols(const float* p, float* v) {
  static_assert(CPT == 4 || CPT == 8, "CPT is 4 or 8");
  if (CPT == 8) {
    load8(p, v);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}

template <int CPT>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float* v) {
  static_assert(CPT == 8, "a 16-byte bf16 load is 8 columns");
  load8(p, v);
}

// Dynamic shared memory of one tile: the hidden tile, the x chunk, the tokens.
template <int RB>
static size_t expert_tile_smem(int f) {
  return (size_t)(RB * f + RB * EXPERT_DC) * sizeof(float) + RB * sizeof(int);
}

// All threads of the CTA; ends with __syncthreads().  d and f are multiples
// of CPT.  x and tok are read with plain loads: the unified step writes them
// earlier in the same launch.
template <typename T, int RB, int CPT>
__device__ void expert_rows(const float* x, const int* tok, const T* wg,
                            const T* wu, const T* wd, float* out, int d, int f, int rows,
                            int live, bool store, float* smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* sh = smem;                        // [RB, f] hidden tile
  float* sx = sh + RB * f;                 // [RB, DC] x chunk
  int* stok = (int*)(sx + RB * EXPERT_DC);  // [RB] token of each row

  for (int r0 = 0; r0 < rows; r0 += RB) {
    const int nr = min(RB, rows - r0);
    if (tid < RB) stok[tid] = tid < nr ? tok[r0 + tid] : 0;
    __syncthreads();

    // h = silu(xt wg) * (xt wu): this thread's columns [c0, c0 + CPT) of f
    for (int cb = 0; cb < f; cb += nt * CPT) {
      const int c0 = cb + tid * CPT;
      const bool act = c0 < f;
      float ag[RB][CPT], au[RB][CPT];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) ag[r][c] = au[r][c] = 0.f;
      for (int k0 = 0; k0 < d; k0 += EXPERT_DC) {
        const int kc = min(EXPERT_DC, d - k0);
        __syncthreads();  // the previous chunk's readers are done
        for (int i = tid; i < RB * kc; i += nt) {
          const int r = i / kc, k = i % kc;
          sx[r * EXPERT_DC + k] = r < nr ? x[(long long)stok[r] * d + k0 + k] : 0.f;
        }
        __syncthreads();
        if (act) {
          const T* pg = wg + (long long)k0 * f + c0;
          const T* pu = wu + (long long)k0 * f + c0;
#pragma unroll 2
          for (int k = 0; k < kc; ++k) {
            float g[CPT], u[CPT];
            load_cols<CPT>(pg + (long long)k * f, g);
            load_cols<CPT>(pu + (long long)k * f, u);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float xv = sx[r * EXPERT_DC + k];
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                ag[r][c] = fmaf(xv, g[c], ag[r][c]);
                au[r][c] = fmaf(xv, u[c], au[r][c]);
              }
            }
          }
        }
      }
      if (act) {
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float a = ag[r][c];
            sh[r * f + c0 + c] = a / (1.f + expf(-a)) * au[r][c];
          }
      }
    }
    __syncthreads();

    // y = h wd: this thread's columns [c0, c0 + CPT) of d
    for (int cb = 0; cb < d; cb += nt * CPT) {
      const int c0 = cb + tid * CPT;
      if (c0 >= d) continue;
      float acc[RB][CPT];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
      const T* pd = wd + c0;
#pragma unroll 2
      for (int j = 0; j < f; ++j) {
        float w[CPT];
        load_cols<CPT>(pd + (long long)j * d, w);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hv = sh[r * f + j];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(hv, w[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nr) break;
        const bool row_live = r0 + r < live;
        float* o = out + (long long)(r0 + r) * d + c0;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float t = row_live ? acc[r][c] : 0.f;
          if (store) {
            o[c] = t;   // free: idempotent plain store of the whole tile
          } else {
            o[c] += t;  // lockstep: one CTA, accumulate tile x mult
          }
        }
      }
    }
    __syncthreads();
  }
}
