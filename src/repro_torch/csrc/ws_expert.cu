// Fence-free work-stealing expert megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/moe_ws/expert_kernel.py: the tile body
// `_expert_execute`, run by the scheduler shell `_generic_ws_kernel` of
// repro/pallas_ws/kernel.py (`launch_ws_grid`, reached through
// `run_moe_schedule`).  The shell is ws_sched.cuh, shared with the attention
// and backward kernels (its queues dense or shared-pool); this file holds the
// C entry point over the expert tile of ws_expert_mma.cuh.
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
// of its expert for a handful of rows).  The design (ws_expert_mma.cuh): a
// program is one 256-thread CTA whose warps each stream strips of the
// expert's weights through their own 3- or 4-stage cp.async ring onto
// mma.sync.m16n8k16, the fp32 activations in three bf16 parts; h [8, f]
// stays in shared memory between the two products.  The free walks break
// the cost policy's victim ties in each program's rotation (ws_sched.cuh,
// ROT), so thieves that read equal advisories stop claiming the same tile.
// What stays: at most P SMs busy (a program of a cluster's CTAs needs a
// hand-off of h between them; barrier.cluster's release compiles to
// MEMBAR.ALL.GPU, and the mbarrier hand-off of csrc/probes/cluster_barrier.cu
// is not tried in a tile yet), and the strict maximum still draws every
// idle program to the same victim when one queue has more rows than the
// rest.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ws_expert_mma.cuh"
#include "ws_sched.cuh"

#define F_E 1
#define F_RS 2
#define F_RL 3

struct ExpertArgs {
  const float* x;        // [T, d] contiguous fp32
  const int* tok_idx;    // [n_rows]
  const void* wg;        // [E, d, f] contiguous
  const void* wu;        // [E, d, f]
  const void* wd;        // [E, f, d]
  float* out;            // [n_rows, d] contiguous fp32
  int d, f, bt;
  int ring_w;            // bytes of each warp's cp.async ring (xmma::tile_smem)
};

// ---------------------------------------------------------------------------
// expert tile (all threads): record (e, rs, rl) -> rows [rs, rs + bt)

template <typename T>
struct ExpertTile {
  const ExpertArgs& A;
  char* smem;
  __device__ void operator()(const int* rec, bool store) const {
    const int e = rec[F_E], rs = rec[F_RS], rl = rec[F_RL];
    const long long w = (long long)e * A.d * A.f;
    xmma::forward_tile<T>(A.x, A.tok_idx + rs, (const T*)A.wg + w, (const T*)A.wu + w,
                          (const T*)A.wd + w, A.out + (long long)rs * A.d, A.d, A.f, A.bt, rl,
                          store, smem, A.ring_w);
  }
};

// ---------------------------------------------------------------------------
// kernels

template <typename T, bool TRACE>
__global__ void __launch_bounds__(xmma::NT, 1) ws_expert_lockstep_kernel(WSQueues Q,
                                                                         ExpertArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE>(Q, sh, ExpertTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(xmma::NT, 1) ws_expert_free_kernel(WSQueues Q, ExpertArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WSShared sh;
  ws_free<TRACE, false, true>(Q, sh, ExpertTile<T>{A, smem});
}

// The half-run walks (steal_run_cap > 1).
template <typename T, bool TRACE>
__global__ void __launch_bounds__(xmma::NT, 1) ws_expert_lockstep_run_kernel(WSQueues Q,
                                                                             ExpertArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE, true>(Q, sh, ExpertTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(xmma::NT, 1) ws_expert_free_run_kernel(WSQueues Q,
                                                                         ExpertArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WSShared sh;
  ws_free<TRACE, true, true>(Q, sh, ExpertTile<T>{A, smem});
}

template <typename T>
static int launch(const WSQueues& Q, const ExpertArgs& A, int mode, int smem,
                  cudaStream_t stream) {
  static void (*const kerns[8])(WSQueues, ExpertArgs) = {
      ws_expert_lockstep_kernel<T, false>, ws_expert_free_kernel<T, false>,
      ws_expert_lockstep_kernel<T, true>, ws_expert_free_kernel<T, true>,
      ws_expert_lockstep_run_kernel<T, false>, ws_expert_free_run_kernel<T, false>,
      ws_expert_lockstep_run_kernel<T, true>, ws_expert_free_run_kernel<T, true>};
  return ws_launch(kerns, mode, Q, A, xmma::NT, (size_t)smem, stream);
}

// CTAs of the untraced free kernel the card holds at once (occupancy x
// SMs), or a negative CUDA error.
template <typename T>
static int resident(int f) {
  int per_sm = 0, sms = 0;
  int ring_w;
  const int smem = xmma::tile_smem(f, false, &ring_w);
  if (smem == 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ws_expert_free_kernel<T, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ws_expert_free_kernel<T, false>,
                                                        xmma::NT, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// Programs (CTAs of the free kernel) the card holds at once at hidden width f.
extern "C" int ws_expert_resident(int dtype, int f) {
  return dtype == 1 ? resident<__nv_bfloat16>(f) : resident<float>(f);
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
  // the header, the hidden tile and the warps' rings: refused where they do not fit
  const int smem = xmma::tile_smem(f, false, &A.ring_w);
  if (smem == 0 || d % 16 || f % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(Q, A, mode, smem, s);
  return launch<float>(Q, A, mode, smem, s);
}
