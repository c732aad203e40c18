// Fence-free work-stealing expert megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/moe_ws/expert_kernel.py: the tile body
// `_expert_execute`, run by the scheduler shell `_generic_ws_kernel` of
// repro/pallas_ws/kernel.py (`launch_ws_grid`, reached through
// `run_moe_schedule`).  The shell is ws_sched.cuh, shared with the attention
// and backward kernels (its queues dense or shared-pool); this file holds the
// expert tile and the C entry point.
//
// What it computes.  Per claimed record (e, rs, rl) of the dropless MoE
// dispatch, where rows [rs, rs + bt) of the expert-grouped routed arrays
// belong to this tile alone:
//   gather   xt = x[tok_idx[rs : rs + bt]]                   [bt, d] fp32
//   FFN      y  = (silu(xt wg[e]) * (xt wu[e])) wd[e]        [bt, d] fp32
//   mask     rows at or past rl are zero
// with bf16 or fp32 weights wg/wu [E, d, f], wd [E, f, d] and fp32
// accumulation.  Lockstep mode accumulates out[rs : rs + bt] += y (tile x
// mult over the launch); free mode stores the whole tile, so a free-mode
// `out` is already normalised.
//
// What bounds it on this card.  A decode-time tile has a handful of live
// rows, so it reads 3 d f weights of its expert for ~6 bt d f flops: it is
// bound by bytes (HBM at 3.35 TB/s).  At full width (d 7168, f 2048) the x
// tile [bt, d] fp32 is 229 KB, over the 227 KB a CTA can have, so this
// kernel stages x through shared memory in chunks of DC columns and keeps
// only the hidden tile h [RB, f] (64 KB at f 2048) there.  In the first
// product each thread owns CPT consecutive f columns and in the second CPT
// consecutive d columns, so every weight row is read once per tile by one
// 16-byte load per thread, coalesced across the warp, and reused for RB
// rows from registers.  This first version is simple, not fast: fp32 FMAs on
// CUDA cores, plain loads, one tile per CTA at a time, at most P CTAs busy.
// wgmma and TMA staging, and splitting an expert's columns over CTAs, are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ws_load8.cuh"
#include "ws_sched.cuh"

#define F_E 1
#define F_RS 2
#define F_RL 3
#define NTHREADS 256
#define RB 8     // rows held in registers per pass over the weights
#define CPT 8    // consecutive columns per thread (one 16-byte bf16 load)
#define DC 1024  // x columns staged in shared memory per chunk

struct ExpertArgs {
  const float* x;        // [T, d] contiguous fp32
  const int* tok_idx;    // [n_rows]
  const void* wg;        // [E, d, f] contiguous
  const void* wu;        // [E, d, f]
  const void* wd;        // [E, f, d]
  float* out;            // [n_rows, d] contiguous fp32
  int d, f, bt;
};

// ---------------------------------------------------------------------------
// expert tile (all threads)

template <typename T>
__device__ void expert_tile(const ExpertArgs& A, float* smem, const int* rec,
                            bool store) {
  const int e = rec[F_E], rs = rec[F_RS], rl = rec[F_RL];
  const int d = A.d, f = A.f, bt = A.bt;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* sh = smem;                      // [RB, f] hidden tile
  float* sx = sh + RB * f;               // [RB, DC] x chunk
  int* stok = (int*)(sx + RB * DC);      // [RB] token of each row
  const T* wg = (const T*)A.wg + (long long)e * d * f;
  const T* wu = (const T*)A.wu + (long long)e * d * f;
  const T* wd = (const T*)A.wd + (long long)e * f * d;

  for (int r0 = 0; r0 < bt; r0 += RB) {
    const int nr = min(RB, bt - r0);
    if (tid < RB) stok[tid] = tid < nr ? A.tok_idx[rs + r0 + tid] : 0;
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
      for (int k0 = 0; k0 < d; k0 += DC) {
        const int kc = min(DC, d - k0);
        __syncthreads();  // the previous chunk's readers are done
        for (int i = tid; i < RB * kc; i += nt) {
          int r = i / kc, k = i % kc;
          sx[r * DC + k] = r < nr ? A.x[(long long)stok[r] * d + k0 + k] : 0.f;
        }
        __syncthreads();
        if (act) {
          const T* pg = wg + (long long)k0 * f + c0;
          const T* pu = wu + (long long)k0 * f + c0;
#pragma unroll 2
          for (int k = 0; k < kc; ++k) {
            float g[CPT], u[CPT];
            load8(pg + (long long)k * f, g);
            load8(pu + (long long)k * f, u);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float xv = sx[r * DC + k];
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
        load8(pd + (long long)j * d, w);
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
        const bool live = r0 + r < rl;
        float* o = A.out + (long long)(rs + r0 + r) * d + c0;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float t = live ? acc[r][c] : 0.f;
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

template <typename T>
struct ExpertTile {
  const ExpertArgs& A;
  float* smem;
  __device__ void operator()(const int* rec, bool store) const {
    expert_tile<T>(A, smem, rec, store);
  }
};

// ---------------------------------------------------------------------------
// kernels

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ws_expert_lockstep_kernel(WSQueues Q, ExpertArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_lockstep(Q, sh, ExpertTile<T>{A, smem});
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ws_expert_free_kernel(WSQueues Q, ExpertArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_free(Q, sh, ExpertTile<T>{A, smem});
}

template <typename T>
static int launch(const WSQueues& Q, const ExpertArgs& A, int mode, size_t smem,
                  cudaStream_t stream) {
  void (*kern)(WSQueues, ExpertArgs) =
      mode == 0 ? ws_expert_lockstep_kernel<T> : ws_expert_free_kernel<T>;
  return ws_launch(kern, mode, Q, A, NTHREADS, smem, stream);
}

extern "C" int ws_expert_launch(
    int mode, int dtype,
    const int* tasks, const int* pool_off, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const float* x, const int* tok_idx, const void* wg, const void* wu,
    const void* wd, float* out,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int compress,
    int d, int f, int bt, void* stream) {
  WSQueues Q = ws_queues(tasks, pool_off, tail, head, local_head, taken, remaining, clock, work,
                         steals, scanned, mult, n_queues, capacity, n_programs,
                         n_tasks, rounds, steal, policy, compress);
  ExpertArgs A;
  A.x = x;
  A.tok_idx = tok_idx;
  A.wg = wg;
  A.wu = wu;
  A.wd = wd;
  A.out = out;
  A.d = d;
  A.f = f;
  A.bt = bt;
  // the hidden tile, the x chunk, the tokens (over 227 KB the launch fails)
  size_t smem = (size_t)(RB * f + RB * DC) * sizeof(float) + RB * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(Q, A, mode, smem, s);
  return launch<float>(Q, A, mode, smem, s);
}
