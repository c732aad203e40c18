// Fence-free work-stealing expert backward megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/moe_ws/expert_kernel.py: the transpose
// tile body `_expert_grad_execute`, run by the scheduler shell
// `_generic_ws_kernel` of repro/pallas_ws/kernel.py (`launch_ws_grid`,
// reached through `run_moe_grad_schedule` from the custom VJP's
// `grad_dispatch="ws"` backward).  The shell is ws_sched.cuh, shared with
// the attention and forward expert kernels; this file holds the C entry
// point over the backward tile of ws_expert_mma.cuh.
//
// What it computes.  Per claimed record (e, rs, rl), rows [rs, rs + bt) of
// the expert-grouped routed arrays, fp32 throughout:
//   gather   xt = x[tok[rs:rs+bt]], ct = gy[tok[rs:rs+bt]]   [bt, d]
//            gr = gate_rows[rs:rs+bt]                           [bt]
//   replay   u = xt wg[e], v = xt wu[e], s = silu(u), h = s v  [bt, f]
//   VJP      dgate = sum_c ct * (h wd[e])                       [bt]
//            dh = (gr ct) wd[e]^T, dv = dh s,
//            du = dh v sig (1 + u (1 - sig))                    [bt, f]
//            dx = du wg[e]^T + dv wu[e]^T                       [bt, d]
//   emit     out[rs:rs+bt] = [dx | du | dv | h | dgate]         [bt, d+3f+1]
// with rows at or past rl zero.  Lockstep mode accumulates the block (tile x
// mult); free mode stores it whole, which is idempotent because the block of
// a tile is disjoint from every other tile's, so a free-mode `out` is
// already normalised, as in the forward kernel.
//
// What bounds it on this card: bytes.  A training tile holds a handful of
// rows of one expert and reads that expert's weights (47 MB a matrix set
// in bf16 at deepseek-v2's d 5120, f 1536).  The design
// (ws_expert_mma.cuh's backward_tile): one 256-thread CTA a program whose
// warps each stream strips of the weights through their own cp.async ring
// onto mma.sync.m16n8k16 in three products, t = ct wd^T, then u and v with
// the elementwise VJP, then dx, keeping t (then du) and u (then dv) [8, f]
// in shared memory.  dgate is sum_j h t, the reference's sum_c ct (h wd)
// reordered and summed in fp64, so wd is read once; wg and wu are still
// read twice (u, v, then dx): 5 d f weights a tile, the first version 6.
// The free walks break victim ties in each program's rotation
// (ws_sched.cuh, ROT).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ws_expert_mma.cuh"
#include "ws_sched.cuh"

#define F_E 1
#define F_RS 2
#define F_RL 3

struct GradArgs {
  const float* x;          // [T, d] contiguous fp32
  const float* gy;         // [T, d] contiguous fp32 cotangent of the combine
  const int* tok_idx;      // [n_rows]
  const float* gate_rows;  // [n_rows]
  const void* wg;          // [E, d, f] contiguous
  const void* wu;          // [E, d, f]
  const void* wd;          // [E, f, d]
  float* out;              // [n_rows, d + 3 f + 1] contiguous fp32
  int d, f, bt;
  int ring_w;            // bytes of each warp's cp.async ring (xmma::tile_smem)
};

// ---------------------------------------------------------------------------
// grad tile (all threads)

template <typename T>
struct GradTile {
  const GradArgs& A;
  char* smem;
  __device__ void operator()(const int* rec, bool store) const {
    const int e = rec[F_E], rs = rec[F_RS], rl = rec[F_RL];
    const long long w = (long long)e * A.d * A.f;
    xmma::backward_tile<T>(A.x, A.gy, A.tok_idx + rs, A.gate_rows + rs, (const T*)A.wg + w,
                           (const T*)A.wu + w, (const T*)A.wd + w,
                           A.out + (long long)rs * (A.d + 3LL * A.f + 1), A.d, A.f, A.bt, rl,
                           store, smem, A.ring_w);
  }
};

// ---------------------------------------------------------------------------
// kernels

template <typename T, bool TRACE>
__global__ void __launch_bounds__(xmma::NT, 1) ws_expert_grad_lockstep_kernel(WSQueues Q,
                                                                              GradArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE>(Q, sh, GradTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(xmma::NT, 1) ws_expert_grad_free_kernel(WSQueues Q,
                                                                          GradArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WSShared sh;
  ws_free<TRACE, false, true>(Q, sh, GradTile<T>{A, smem});
}

// The half-run walks (steal_run_cap > 1).
template <typename T, bool TRACE>
__global__ void __launch_bounds__(xmma::NT, 1) ws_expert_grad_lockstep_run_kernel(WSQueues Q,
                                                                                  GradArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE, true>(Q, sh, GradTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(xmma::NT, 1) ws_expert_grad_free_run_kernel(WSQueues Q,
                                                                              GradArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ WSShared sh;
  ws_free<TRACE, true, true>(Q, sh, GradTile<T>{A, smem});
}

template <typename T>
static int launch(const WSQueues& Q, const GradArgs& A, int mode, int smem,
                  cudaStream_t stream) {
  static void (*const kerns[8])(WSQueues, GradArgs) = {
      ws_expert_grad_lockstep_kernel<T, false>, ws_expert_grad_free_kernel<T, false>,
      ws_expert_grad_lockstep_kernel<T, true>, ws_expert_grad_free_kernel<T, true>,
      ws_expert_grad_lockstep_run_kernel<T, false>, ws_expert_grad_free_run_kernel<T, false>,
      ws_expert_grad_lockstep_run_kernel<T, true>, ws_expert_grad_free_run_kernel<T, true>};
  return ws_launch(kerns, mode, Q, A, xmma::NT, (size_t)smem, stream);
}

// CTAs of the untraced free kernel the card holds at once (occupancy x
// SMs), or a negative CUDA error.
template <typename T>
static int resident(int f) {
  int per_sm = 0, sms = 0;
  int ring_w;
  const int smem = xmma::tile_smem(f, true, &ring_w);
  if (smem == 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ws_expert_grad_free_kernel<T, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ws_expert_grad_free_kernel<T, false>, xmma::NT, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// Programs (CTAs of the free kernel) the card holds at once at hidden width f.
extern "C" int ws_expert_grad_resident(int dtype, int f) {
  return dtype == 1 ? resident<__nv_bfloat16>(f) : resident<float>(f);
}

extern "C" int ws_expert_grad_launch(
    int mode, int dtype,
    const int* tasks, const int* pool_off, const int* tail, int* head, int* local_head,
    int* taken, int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const float* x, const float* gy, const int* tok_idx, const float* gate_rows,
    const void* wg, const void* wu, const void* wd, float* out,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int compress, int run_cap,
    int d, int f, int bt, int* ev, int* ev_cursor, const int* ev_mult0, int ev_cap,
    int steal_kind, int stall_ns, void* stream) {
  WSQueues Q = ws_queues(tasks, pool_off, tail, head, local_head, taken, remaining, clock,
                         work, steals, scanned, mult, n_queues, capacity, n_programs,
                         n_tasks, rounds, steal, policy, compress);
  Q.run_cap = run_cap;
  ws_set_ring(Q, ev, ev_cursor, ev_mult0, ev_cap, steal_kind, stall_ns);
  GradArgs A;
  A.x = x;
  A.gy = gy;
  A.tok_idx = tok_idx;
  A.gate_rows = gate_rows;
  A.wg = wg;
  A.wu = wu;
  A.wd = wd;
  A.out = out;
  A.d = d;
  A.f = f;
  A.bt = bt;
  // the header, t/du, u/dv and the warps' rings: refused where they do not fit
  const int smem = xmma::tile_smem(f, true, &A.ring_w);
  if (smem == 0 || d % 16 || f % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(Q, A, mode, smem, s);
  return launch<float>(Q, A, mode, smem, s);
}
