// Fence-free work-stealing attention megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/pallas_ws/kernel.py: the scheduler shell
// `_generic_ws_kernel` (with `ws_try_extract`, `_probe_slot`, `ws_account`),
// launched by `launch_ws_grid`, around the attention tile body
// `_attention_execute` (reached through `run_ws_schedule`).  The scheduler
// and its two walks (lockstep, free) live in ws_sched.cuh, shared with the
// other kernels, and the tile in ws_attn_tile.cuh, shared with the unified
// step; this file holds the kernels and the C entry point.
//
// What it computes.  WS-WMULT extraction (paper Fig. 7) over HBM-resident
// queue arrays, then a flash/decode attention tile of `bq` query rows of head
// `h` against GQA kv head `h / g`: an online softmax over `cost` kv blocks of
// `bk`, masks `kpos < kv_end` (and `kpos <= qpos` for causal tiles), rows at
// or past `q_len` zeroed, fp32 arithmetic over fp32 or bf16 inputs.  Lockstep
// mode accumulates `out += tile` (tile x mult over the launch); free mode
// stores the whole normalised tile, so a free-mode `out` is already
// normalised and must not be divided by mult again.
//
// What bounds it on this card.  Decode attention reads each live K/V row
// once and does ~4 flops per element: it is bound by bytes (HBM at
// 3.35 TB/s).  This first version is simple, not fast: one tile per CTA at a
// time, K/V staged through shared memory by plain loads, fp32 dot products
// on CUDA cores, no sharing of a K/V block between the g query heads of one
// kv head, and at most P CTAs busy.  cp.async/TMA staging, several tiles per
// CTA and GQA sharing are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ws_attn_tile.cuh"

#define NTHREADS 128

template <typename T>
struct AttentionTile {
  const AttnArgs& A;
  float* smem;
  __device__ void operator()(const int* rec, bool store) const {
    execute_tile<T>(A, smem, rec, store);
  }
};

// ---------------------------------------------------------------------------
// kernels

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_lockstep_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE>(Q, sh, AttentionTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_free_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_free<TRACE>(Q, sh, AttentionTile<T>{A, smem});
}

// The half-run walks (steal_run_cap > 1).
template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_lockstep_run_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE, true>(Q, sh, AttentionTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_free_run_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_free<TRACE, true>(Q, sh, AttentionTile<T>{A, smem});
}

template <typename T>
static int launch(const WSQueues& Q, const AttnArgs& A, int mode, size_t smem,
                  cudaStream_t stream) {
  static void (*const kerns[8])(WSQueues, AttnArgs) = {
      ws_lockstep_kernel<T, false>, ws_free_kernel<T, false>,
      ws_lockstep_kernel<T, true>, ws_free_kernel<T, true>,
      ws_lockstep_run_kernel<T, false>, ws_free_run_kernel<T, false>,
      ws_lockstep_run_kernel<T, true>, ws_free_run_kernel<T, true>};
  return ws_launch(kerns, mode, Q, A, NTHREADS, smem, stream);
}

extern "C" int ws_attention_launch(
    int mode, int dtype,
    const int* tasks, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const int* stage_open, const void* q, const void* k, const void* v, float* out,
    const long long* strides,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int compress, int run_cap, int causal,
    int H, int Sq, int Sq_out, int Sk, int hd, int g, int bq, int bk,
    float scale, int* ev, int* ev_cursor, const int* ev_mult0, int ev_cap, int steal_kind,
    int stall_ns, void* stream) {
  WSQueues Q = ws_queues(tasks, nullptr, tail, head, local_head, taken, remaining, clock, work,
                         steals, scanned, mult, n_queues, capacity, n_programs,
                         n_tasks, rounds, steal, policy, compress);
  Q.stage_open = stage_open;
  Q.run_cap = run_cap;
  ws_set_ring(Q, ev, ev_cursor, ev_mult0, ev_cap, steal_kind, stall_ns);
  AttnArgs A;
  A.q = q;
  A.k = k;
  A.v = v;
  A.out = out;
  A.q_sb = strides[0]; A.q_sh = strides[1]; A.q_ss = strides[2]; A.q_sd = strides[3];
  A.k_sb = strides[4]; A.k_sh = strides[5]; A.k_ss = strides[6]; A.k_sd = strides[7];
  A.v_sb = strides[8]; A.v_sh = strides[9]; A.v_ss = strides[10]; A.v_sd = strides[11];
  A.causal = causal;
  A.H = H;
  A.Sq = Sq;
  A.Sq_out = Sq_out;
  A.Sk = Sk;
  A.hd = hd;
  A.g = g;
  A.bq = bq;
  A.bk = bk;
  A.scale = scale;
  size_t smem = (size_t)(2 * bq * hd + bk * hd + bq * bk + 3 * bq) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(Q, A, mode, smem, s);
  return launch<float>(Q, A, mode, smem, s);
}
