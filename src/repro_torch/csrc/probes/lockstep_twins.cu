// The two per-slot lockstep walks of ws_sched.cuh side by side: ws_lockstep's
// own loop over the volatile view (WSQueues: the walk of ws_attention and the
// expert kernels) and owned_lockstep over WSQueuesOwned (the walk of
// ws_unified's walker, which passes the cells that claim nothing on thread 0
// alone).  Not a kernel of the port: tests/test_torch_unified_redesign.py
// builds this file and launches each walk on fresh copies of one stage-gated
// step's queues, with a tile body that does nothing, and holds every array
// and ring of the one to the other's.

#include <cuda_runtime.h>

#include "../ws_sched.cuh"

struct NoBody {
  __device__ void operator()(const int*, bool) const {}
};

template <bool TRACE, bool OWNED>
__global__ void __launch_bounds__(256, 1) lockstep_twin(WSQueues Q) {
  __shared__ WSShared sh;
  if constexpr (OWNED) {
    ws_lockstep<TRACE>(owned(Q), sh, NoBody{});
  } else {
    ws_lockstep<TRACE>(Q, sh, NoBody{});
  }
}

// One CTA walks the queues in lockstep: owned_view 0 through ws_lockstep's
// loop, 1 through owned_lockstep.  The arguments are ws_unified_launch's
// queue and ring halves (null ev: untraced).  Returns the launch's CUDA error.
extern "C" int lockstep_twin_launch(
    int owned_view, const int* tasks, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const int* stage_open, int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int* ev, int* ev_cursor, const int* ev_mult0, int ev_cap,
    int steal_kind, int stall_ns, void* stream) {
  WSQueues Q = ws_queues(tasks, nullptr, tail, head, local_head, taken, remaining, clock, work,
                         steals, scanned, mult, n_queues, capacity, n_programs, n_tasks, rounds,
                         steal, policy, 0);
  Q.stage_open = stage_open;
  ws_set_ring(Q, ev, ev_cursor, ev_mult0, ev_cap, steal_kind, stall_ns);
  static void (*const kerns[4])(WSQueues) = {lockstep_twin<false, false>,
                                             lockstep_twin<false, true>,
                                             lockstep_twin<true, false>,
                                             lockstep_twin<true, true>};
  kerns[(ev ? 2 : 0) + (owned_view ? 1 : 0)]<<<1, 256, 0, (cudaStream_t)stream>>>(Q);
  return (int)cudaGetLastError();
}
