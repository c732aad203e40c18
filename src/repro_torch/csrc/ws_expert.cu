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
// What bounds it on this card: bytes (a decode-time tile reads 3 d f weights
// of its expert for a handful of rows); the tile, shared with the unified
// step's expert tiles, is ws_expert_tile.cuh, which says how it stages x and
// keeps the hidden tile in shared memory.  Here it runs at RB 8 rows and CPT
// 8 columns a thread in a 256-thread CTA, one tile per CTA, at most P CTAs
// busy.  wgmma and TMA staging, and splitting an expert's columns over CTAs,
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ws_expert_tile.cuh"
#include "ws_sched.cuh"

#define F_E 1
#define F_RS 2
#define F_RL 3
#define NTHREADS 256
#define RB 8     // rows held in registers per pass over the weights
#define CPT 8    // consecutive columns per thread (one 16-byte bf16 load)

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
// expert tile (all threads): record (e, rs, rl) -> rows [rs, rs + bt)

template <typename T>
__device__ void expert_tile(const ExpertArgs& A, float* smem, const int* rec, bool store) {
  const int e = rec[F_E], rs = rec[F_RS], rl = rec[F_RL];
  const long long w = (long long)e * A.d * A.f;
  expert_rows<T, RB, CPT>(A.x, A.tok_idx + rs, (const T*)A.wg + w, (const T*)A.wu + w,
                          (const T*)A.wd + w, A.out + (long long)rs * A.d, A.d, A.f, A.bt, rl,
                          store, smem);
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

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_expert_lockstep_kernel(WSQueues Q, ExpertArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE>(Q, sh, ExpertTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_expert_free_kernel(WSQueues Q, ExpertArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_free<TRACE>(Q, sh, ExpertTile<T>{A, smem});
}

// The half-run walks (steal_run_cap > 1).
template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_expert_lockstep_run_kernel(WSQueues Q,
                                                                          ExpertArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE, true>(Q, sh, ExpertTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_expert_free_run_kernel(WSQueues Q, ExpertArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_free<TRACE, true>(Q, sh, ExpertTile<T>{A, smem});
}

template <typename T>
static int launch(const WSQueues& Q, const ExpertArgs& A, int mode, size_t smem,
                  cudaStream_t stream) {
  static void (*const kerns[8])(WSQueues, ExpertArgs) = {
      ws_expert_lockstep_kernel<T, false>, ws_expert_free_kernel<T, false>,
      ws_expert_lockstep_kernel<T, true>, ws_expert_free_kernel<T, true>,
      ws_expert_lockstep_run_kernel<T, false>, ws_expert_free_run_kernel<T, false>,
      ws_expert_lockstep_run_kernel<T, true>, ws_expert_free_run_kernel<T, true>};
  return ws_launch(kerns, mode, Q, A, NTHREADS, smem, stream);
}

extern "C" int ws_expert_launch(
    int mode, int dtype,
    const int* tasks, const int* pool_off, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const float* x, const int* tok_idx, const void* wg, const void* wu,
    const void* wd, float* out,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int compress, int run_cap,
    int d, int f, int bt, int* ev, int* ev_cursor, const int* ev_mult0, int ev_cap,
    int steal_kind, int stall_ns, void* stream) {
  WSQueues Q = ws_queues(tasks, pool_off, tail, head, local_head, taken, remaining, clock, work,
                         steals, scanned, mult, n_queues, capacity, n_programs,
                         n_tasks, rounds, steal, policy, compress);
  Q.run_cap = run_cap;
  ws_set_ring(Q, ev, ev_cursor, ev_mult0, ev_cap, steal_kind, stall_ns);
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
  size_t smem = expert_tile_smem<RB>(f);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(Q, A, mode, smem, s);
  return launch<float>(Q, A, mode, smem, s);
}
