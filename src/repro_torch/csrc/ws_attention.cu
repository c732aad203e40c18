// Fence-free work-stealing attention megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/pallas_ws/kernel.py: the scheduler shell
// `_generic_ws_kernel` (with `ws_try_extract`, `_probe_slot`, `ws_account`),
// launched by `launch_ws_grid`, around the attention tile body
// `_attention_execute` (reached through `run_ws_schedule`).  The scheduler
// and its two walks (lockstep, free) live in ws_sched.cuh, shared with the
// expert kernel; this file holds the attention tile and the C entry point.
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

#include "ws_sched.cuh"

#define F_B 1
#define F_H 2
#define F_QS 3
#define F_QL 4
#define F_KV 5
#define NEG_INF (-1e30f)
#define NTHREADS 128

struct AttnArgs {
  const void* q;             // [B, H, Sq, hd] by strides
  const void* k;             // [B, Hkv, Sk, hd] by strides
  const void* v;
  float* out;                // [B, H, Sq_out, hd] contiguous fp32
  long long q_sb, q_sh, q_ss, q_sd;
  long long k_sb, k_sh, k_ss, k_sd;
  long long v_sb, v_sh, v_ss, v_sd;
  int causal;
  int H, Sq, Sq_out, Sk, hd, g, bq, bk;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// attention tile (all threads)

template <typename T>
__device__ void execute_tile(const AttnArgs& A, float* smem, const int* rec,
                             bool store) {
  const int b = rec[F_B], h = rec[F_H], qs = rec[F_QS], ql = rec[F_QL];
  const int kv_end = rec[F_KV], cost = rec[F_COST];
  const int kh = h / A.g;
  const int hd = A.hd, bq = A.bq, bk = A.bk;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* sq = smem;              // [bq, hd]
  float* sacc = sq + bq * hd;    // [bq, hd]
  float* skv = sacc + bq * hd;   // [bk, hd]  K block, then V block
  float* ss = skv + bk * hd;     // [bq, bk]  scores, then probabilities
  float* sm = ss + bq * bk;      // [bq] running max
  float* sl = sm + bq;           // [bq] running sum
  float* scorr = sl + bq;        // [bq] rescale of this block
  const T* qp = (const T*)A.q + (long long)b * A.q_sb + (long long)h * A.q_sh;
  const T* kp = (const T*)A.k + (long long)b * A.k_sb + (long long)kh * A.k_sh;
  const T* vp = (const T*)A.v + (long long)b * A.v_sb + (long long)kh * A.v_sh;

  for (int e = tid; e < bq * hd; e += nt) {
    int i = e / hd, d = e % hd;
    int qpos = qs + i;
    sq[e] = qpos < A.Sq ? to_f(qp[(long long)qpos * A.q_ss + (long long)d * A.q_sd]) : 0.f;
    sacc[e] = 0.f;
  }
  for (int i = tid; i < bq; i += nt) {
    sm[i] = NEG_INF;
    sl[i] = 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;
  for (int ki = 0; ki < cost; ++ki) {
    const int k0 = ki * bk;
    for (int e = tid; e < bk * hd; e += nt) {
      int j = e / hd, d = e % hd;
      int kpos = k0 + j;
      skv[e] = kpos < A.Sk ? to_f(kp[(long long)kpos * A.k_ss + (long long)d * A.k_sd]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < bq * bk; e += nt) {
      int i = e / bk, j = e % bk;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc += sq[i * hd + d] * skv[j * hd + d];
      float s = acc * A.scale;
      int kpos = k0 + j;
      bool valid = kpos < kv_end;
      if (A.causal) valid = valid && (kpos <= qs + i);
      ss[e] = valid ? s : NEG_INF;
    }
    __syncthreads();
    for (int i = warp; i < bq; i += nwarps) {
      float rowmax = -INFINITY;
      for (int j = lane; j < bk; j += 32) rowmax = fmaxf(rowmax, ss[i * bk + j]);
      for (int o = 16; o > 0; o >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, o));
      float m_old = sm[i];
      float m_new = fmaxf(m_old, rowmax);
      float sum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        float pe = expf(ss[i * bk + j] - m_new);
        ss[i * bk + j] = pe;
        sum += pe;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        float corr = expf(m_old - m_new);
        sl[i] = sl[i] * corr + sum;
        sm[i] = m_new;
        scorr[i] = corr;
      }
    }
    __syncthreads();
    for (int e = tid; e < bk * hd; e += nt) {
      int j = e / hd, d = e % hd;
      int kpos = k0 + j;
      skv[e] = kpos < A.Sk ? to_f(vp[(long long)kpos * A.v_ss + (long long)d * A.v_sd]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < bq * hd; e += nt) {
      int i = e / hd, d = e % hd;
      float a = 0.f;
      for (int j = 0; j < bk; ++j) a += ss[i * bk + j] * skv[j * hd + d];
      sacc[e] = sacc[e] * scorr[i] + a;
    }
    __syncthreads();
  }

  for (int e = tid; e < bq * hd; e += nt) {
    int i = e / hd, d = e % hd;
    float t = sacc[e] / fmaxf(sl[i], 1e-30f);
    if (i >= ql) t = 0.f;
    long long o = (((long long)b * A.H + h) * A.Sq_out + qs + i) * hd + d;
    if (store) {
      A.out[o] = t;   // free: idempotent plain store of the whole tile
    } else {
      A.out[o] += t;  // lockstep: one CTA, accumulate tile x mult
    }
  }
  __syncthreads();
}

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

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ws_lockstep_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_lockstep(Q, sh, AttentionTile<T>{A, smem});
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ws_free_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_free(Q, sh, AttentionTile<T>{A, smem});
}

template <typename T>
static int launch(const WSQueues& Q, const AttnArgs& A, int mode, size_t smem,
                  cudaStream_t stream) {
  void (*kern)(WSQueues, AttnArgs) = mode == 0 ? ws_lockstep_kernel<T> : ws_free_kernel<T>;
  return ws_launch(kern, mode, Q, A, NTHREADS, smem, stream);
}

extern "C" int ws_attention_launch(
    int mode, int dtype,
    const int* tasks, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const void* q, const void* k, const void* v, float* out,
    const long long* strides,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int compress, int causal,
    int H, int Sq, int Sq_out, int Sk, int hd, int g, int bq, int bk,
    float scale, void* stream) {
  WSQueues Q = ws_queues(tasks, nullptr, tail, head, local_head, taken, remaining, clock, work,
                         steals, scanned, mult, n_queues, capacity, n_programs,
                         n_tasks, rounds, steal, policy, compress);
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
