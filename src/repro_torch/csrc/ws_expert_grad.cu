// Fence-free work-stealing expert backward megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/moe_ws/expert_kernel.py: the transpose
// tile body `_expert_grad_execute`, run by the scheduler shell
// `_generic_ws_kernel` of repro/pallas_ws/kernel.py (`launch_ws_grid`,
// reached through `run_moe_grad_schedule` from the custom VJP's
// `grad_dispatch="ws"` backward).  The shell is ws_sched.cuh, shared with
// the attention and forward expert kernels; this file holds the grad tile
// and the C entry point.
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
// What bounds it on this card.  A training tile holds a handful of rows of
// one expert and reads that expert's 3 d f weights (47 MB in bf16 at
// deepseek-v2's d 5120, f 1536) for ~16 bt d f flops: it is bound by bytes.
// Shared memory is the tight resource: the block of 8 rows is 311 KB at
// d 5120 and the row vectors yhat [8, d] 160 KB, over the 227 KB a CTA can
// have.  So nothing d-wide is kept: yhat is reduced into dgate on the fly,
// dx is produced one d column at a time and written straight to `out`, and
// x and dy pass through shared memory in chunks of DC columns.  Shared
// memory holds the three [RB, f] tiles h, dh (then du) and dv: 144 KB at
// f 1536, 192 KB at kimi-k2's f 2048.  The four products are ordered so
// each needs only what is already there:
//   1. dh = dy wd^T     warp per wd row, lanes over d (coalesced), dy staged
//   2. u, v, then h, du, dv   thread per CPT f columns, x staged, as forward
//   3. dgate = sum ct (h wd)  thread per CPT d columns, as forward's 2nd
//   4. dx = du wg^T + dv wu^T  warp per wg/wu row, lanes over f
// A warp's 8 row sums are reduced across its lanes with 9 shuffles (a
// transposed butterfly), so no atomic is needed anywhere.  wd is read twice
// (steps 1 and 3), wg and wu twice (2 and 4): this first version is simple,
// not fast.  fp32 FMAs on CUDA cores, one tile per CTA at a time; splitting
// an expert's columns over CTAs, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ws_load8.cuh"
#include "ws_sched.cuh"

#define F_E 1
#define F_RS 2
#define F_RL 3
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define RB 8    // rows per pass over the weights (the warp reduction assumes 8)
#define CPT 8   // consecutive columns per thread (one 16-byte bf16 load)
#define DC 512  // x / dy columns staged in shared memory per chunk

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
};

// Sum a[0..8) over the 32 lanes of a warp.  Afterwards lanes with
// lane % 4 == 0 hold the total of row (lane >> 2): three halving exchanges
// (4 + 2 + 1 shuffles) leave each lane one row, then two full ones finish.
__device__ __forceinline__ float warp_sum_rows(float* a, int lane) {
  const unsigned full = 0xffffffffu;
  bool up = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float send = up ? a[i] : a[i + 4];
    float keep = up ? a[i + 4] : a[i];
    a[i] = keep + __shfl_xor_sync(full, send, 16);
  }
  up = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float send = up ? a[i] : a[i + 2];
    float keep = up ? a[i + 2] : a[i];
    a[i] = keep + __shfl_xor_sync(full, send, 8);
  }
  up = lane & 4;
  float send = up ? a[0] : a[1];
  float t = (up ? a[1] : a[0]) + __shfl_xor_sync(full, send, 4);
  t += __shfl_xor_sync(full, t, 2);
  t += __shfl_xor_sync(full, t, 1);
  return t;
}

__device__ __forceinline__ void lds8(const float* p, float* v) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Write one element of the block: a plain store in free mode, an
// accumulation in lockstep mode.
__device__ __forceinline__ void emit(float* o, float v, bool store) {
  if (store) {
    *o = v;
  } else {
    *o += v;
  }
}

// ---------------------------------------------------------------------------
// grad tile (all threads)

template <typename T>
__device__ void grad_tile(const GradArgs& A, float* smem, const int* rec, bool store) {
  const int e = rec[F_E], rs = rec[F_RS], rl = rec[F_RL];
  const int d = A.d, f = A.f, bt = A.bt;
  const long long W = (long long)d + 3 * f + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* sH = smem;                    // [RB, f] h
  float* sDU = sH + RB * f;            // [RB, f] dh, then du
  float* sDV = sDU + RB * f;           // [RB, f] dv
  float* sX = sDV + RB * f;            // [RB, DC] x or dy chunk
  float* sred = sX + RB * DC;          // [NWARPS, RB] dgate partial sums
  float* sgr = sred + NWARPS * RB;     // [RB] gate of each row
  int* stok = (int*)(sgr + RB);        // [RB] token of each row
  const T* wg = (const T*)A.wg + (long long)e * d * f;
  const T* wu = (const T*)A.wu + (long long)e * d * f;
  const T* wd = (const T*)A.wd + (long long)e * f * d;

  for (int r0 = 0; r0 < bt; r0 += RB) {
    const int nr = min(RB, bt - r0);
    float* orow = A.out + (long long)(rs + r0) * W;  // row r of the block: orow + r W
    if (tid < RB) {
      stok[tid] = tid < nr ? A.tok_idx[rs + r0 + tid] : 0;
      sgr[tid] = tid < nr ? A.gate_rows[rs + r0 + tid] : 0.f;
    }
    __syncthreads();

    // 1. dh[r, j] = sum_c dy[r, c] wd[j, c], dy = gr ct: a warp per wd row j
    for (int k0 = 0; k0 < d; k0 += DC) {
      const int kc = min(DC, d - k0);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < RB * kc; i += nt) {
        int r = i / kc, k = i % kc;
        sX[r * DC + k] = r < nr ? sgr[r] * A.gy[(long long)stok[r] * d + k0 + k] : 0.f;
      }
      __syncthreads();
      for (int j = warp; j < f; j += NWARPS) {
        float a[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) a[r] = 0.f;
        const T* pw = wd + (long long)j * d + k0;
        for (int k = lane * CPT; k < kc; k += 32 * CPT) {
          float w[CPT];
          load8(pw + k, w);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float xv[CPT];
            lds8(sX + r * DC + k, xv);
#pragma unroll
            for (int c = 0; c < CPT; ++c) a[r] = fmaf(xv[c], w[c], a[r]);
          }
        }
        const float t = warp_sum_rows(a, lane);
        if ((lane & 3) == 0) {
          float* p = sDU + (lane >> 2) * f + j;
          *p = k0 == 0 ? t : *p + t;
        }
      }
    }
    __syncthreads();

    // 2. u = xt wg, v = xt wu over this thread's CPT f columns, then the
    //    elementwise VJP: h, du (over dh in place), dv, and their columns of out
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
        __syncthreads();
        for (int i = tid; i < RB * kc; i += nt) {
          int r = i / kc, k = i % kc;
          sX[r * DC + k] = r < nr ? A.x[(long long)stok[r] * d + k0 + k] : 0.f;
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
              const float xv = sX[r * DC + k];
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
        for (int r = 0; r < RB; ++r) {
          const bool live = r < nr && r0 + r < rl;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float u = ag[r][c], v = au[r][c];
            const float sig = 1.f / (1.f + expf(-u));
            const float s = u * sig;
            const float h = s * v;
            const int i = r * f + c0 + c;
            const float dh = sDU[i];
            const float dv = dh * s;
            const float du = dh * v * (sig * (1.f + u * (1.f - sig)));
            sH[i] = h;
            sDU[i] = du;
            sDV[i] = dv;
            if (r < nr) {
              float* o = orow + r * W + d + c0 + c;
              emit(o, live ? du : 0.f, store);
              emit(o + f, live ? dv : 0.f, store);
              emit(o + 2 * f, live ? h : 0.f, store);
            }
          }
        }
      }
    }
    __syncthreads();

    // 3. dgate[r] = sum_c ct[r, c] (h wd)[r, c]: this thread's CPT d columns
    //    of yhat, reduced on the fly (yhat itself is never stored)
    float pd[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) pd[r] = 0.f;
    for (int cb = 0; cb < d; cb += nt * CPT) {
      const int c0 = cb + tid * CPT;
      if (c0 >= d) continue;
      float acc[RB][CPT];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
      const T* pd_w = wd + c0;
#pragma unroll 2
      for (int j = 0; j < f; ++j) {
        float w[CPT];
        load8(pd_w + (long long)j * d, w);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hv = sH[r * f + j];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(hv, w[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nr) break;
        float ct[CPT];
        load8(A.gy + (long long)stok[r] * d + c0, ct);
#pragma unroll
        for (int c = 0; c < CPT; ++c) pd[r] = fmaf(ct[c], acc[r][c], pd[r]);
      }
    }
    {
      const float t = warp_sum_rows(pd, lane);
      if ((lane & 3) == 0) sred[warp * RB + (lane >> 2)] = t;
    }
    __syncthreads();
    if (tid < nr) {
      float t = 0.f;
      for (int w = 0; w < NWARPS; ++w) t += sred[w * RB + tid];
      emit(orow + tid * W + d + 3 * f, r0 + tid < rl ? t : 0.f, store);
    }

    // 4. dx[r, c] = sum_j du[r, j] wg[c, j] + dv[r, j] wu[c, j]: a warp per
    //    d column c (a row of wg and wu), lanes over f
    for (int c = warp; c < d; c += NWARPS) {
      float a[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) a[r] = 0.f;
      const T* pg = wg + (long long)c * f;
      const T* pu = wu + (long long)c * f;
      for (int j = lane * CPT; j < f; j += 32 * CPT) {
        float g[CPT], u[CPT];
        load8(pg + j, g);
        load8(pu + j, u);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float du[CPT], dv[CPT];
          lds8(sDU + r * f + j, du);
          lds8(sDV + r * f + j, dv);
#pragma unroll
          for (int k = 0; k < CPT; ++k) a[r] = fmaf(du[k], g[k], fmaf(dv[k], u[k], a[r]));
        }
      }
      const float t = warp_sum_rows(a, lane);
      const int r = lane >> 2;
      if ((lane & 3) == 0 && r < nr) emit(orow + r * W + c, r0 + r < rl ? t : 0.f, store);
    }
    __syncthreads();
  }
}

template <typename T>
struct GradTile {
  const GradArgs& A;
  float* smem;
  __device__ void operator()(const int* rec, bool store) const {
    grad_tile<T>(A, smem, rec, store);
  }
};

// ---------------------------------------------------------------------------
// kernels

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_expert_grad_lockstep_kernel(WSQueues Q, GradArgs A) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE>(Q, sh, GradTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_expert_grad_free_kernel(WSQueues Q, GradArgs A) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  ws_free<TRACE>(Q, sh, GradTile<T>{A, smem});
}

// The half-run walks (steal_run_cap > 1).
template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_expert_grad_lockstep_run_kernel(WSQueues Q,
                                                                               GradArgs A) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE, true>(Q, sh, GradTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_expert_grad_free_run_kernel(WSQueues Q,
                                                                           GradArgs A) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  ws_free<TRACE, true>(Q, sh, GradTile<T>{A, smem});
}

template <typename T>
static int launch(const WSQueues& Q, const GradArgs& A, int mode, size_t smem,
                  cudaStream_t stream) {
  static void (*const kerns[8])(WSQueues, GradArgs) = {
      ws_expert_grad_lockstep_kernel<T, false>, ws_expert_grad_free_kernel<T, false>,
      ws_expert_grad_lockstep_kernel<T, true>, ws_expert_grad_free_kernel<T, true>,
      ws_expert_grad_lockstep_run_kernel<T, false>, ws_expert_grad_free_run_kernel<T, false>,
      ws_expert_grad_lockstep_run_kernel<T, true>, ws_expert_grad_free_run_kernel<T, true>};
  return ws_launch(kerns, mode, Q, A, NTHREADS, smem, stream);
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
  // h, dh/du, dv; the x/dy chunk; dgate partials, gates, tokens
  // (over 227 KB the launch fails)
  size_t smem = (size_t)(3 * RB * f + RB * DC + NWARPS * RB + RB) * sizeof(float) +
                RB * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(Q, A, mode, smem, s);
  return launch<float>(Q, A, mode, smem, s);
}
