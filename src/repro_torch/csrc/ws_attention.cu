// Fence-free work-stealing attention megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/pallas_ws/kernel.py: the scheduler shell
// `_generic_ws_kernel` (with `ws_try_extract`, `_probe_slot`, `ws_account`),
// launched by `launch_ws_grid`, around the attention tile body
// `_attention_execute` (reached through `run_ws_schedule`).  The scheduler
// and its two walks (lockstep, free) live in ws_sched.cuh, shared with the
// other kernels; the tensor-core building blocks in attn_mma.cuh, shared
// with flash_fwd.cu; this file holds the tile bodies, the kernels and the C
// entry point; the CUDA-core bodies (a) and (c) in ws_attn_body.cuh, shared
// with ws_unified.cu.
//
// What it computes.  WS-WMULT extraction (paper Fig. 7) over HBM-resident
// queue arrays, then a flash/decode attention tile of `bq` query rows of head
// `h` against GQA kv head `h / g`: an online softmax over the keys
// [0, cost * bk), masks `kpos < kv_end` (and `kpos <= qpos` for causal
// tiles) with the reference's finite NEG_INF, rows at or past `q_len`
// zeroed, fp32 arithmetic over fp32 or bf16 inputs, K/V rows past Sk read
// as zeros.  Lockstep mode accumulates `out += tile` (tile x mult over the
// launch); free mode stores the whole normalised tile, so a free-mode `out`
// is already normalised and must not be divided by mult again.  A tile's
// bits depend only on its record and the inputs (fixed thread layout,
// fixed merge order, no atomics), so duplicate runs store the same bits.
//
// What bounds it on this card.  Decode reads each live K/V row once per
// query head and does ~4 flops an element: bytes.  P = 8 CTAs run at once,
// so the bytes in flight per SM set its speed.  Flash tiles do ~4 hd flops
// a (q, k) pair: operations, on the tensor cores.
//
// Three tile bodies, chosen on the host from (dtype, bq, hd, layouts) by
// `attention_branch` (repro_torch/pallas_ws/kernel.py) and passed in:
//  (a) decode, bq = 1: a GEMV on CUDA cores.  The 8 warps split the keys
//      in chunks; a lane group of G lanes (8 elements each, G a power of
//      two >= hd / 8) holds one key, so a warp steps 32 / G keys at a time,
//      U steps in flight (8 bf16 or 4 fp32: 256 B of K and V a lane); q
//      and the accumulator stay in registers, a score is a shuffle sum
//      within the group.  Lane groups, then warps (in shared memory), merge
//      in a fixed order.  Needs 16-byte rows of K and V (unit inner stride,
//      aligned base and strides) and hd % 8 == 0.
//  (b) flash tiles, bf16, bq % 16 == 0 (<= 128), hd % 16 == 0 (<= 128):
//      warps as (bq / 16 row groups) x (kv splits); each warp runs S = Q Kᵀ
//      and O += P V with mma.sync.m16n8k16 and fp32 accumulators on its 16
//      keys of every stage, P in two bf16 parts (attn_mma.cuh).  K and V
//      stream through a double-buffered cp.async ring (rows padded by 16
//      bytes: ldmatrix is conflict-free).  The splits merge in shared
//      memory in a fixed order.  Needs 16-byte rows of q, K and V.
//  (c) everything else (fp32 with bq > 1, other shapes and layouts): the
//      first tile body, fp32 on CUDA cores through shared memory, its K/V
//      rows padded to hd + 1 floats so the score loop's column reads hit
//      32 banks.
// Keys past the last one any row may see weigh exactly 0 once a row has a
// live key, so (a) and (b) stop there; a tile with no live key (kv_end <= 0)
// sweeps all cost * bk keys, each at NEG_INF, as the reference does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ws_sched.cuh"
#include "attn_mma.cuh"
#include "ws_attn_body.cuh"

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)

#define BRANCH_DECODE 0
#define BRANCH_MMA 1
#define BRANCH_GENERIC 2

#define MMA_HD 128   // widest head dim of branch (b): its fragments live in registers
#define KW 16        // keys a kv split of branch (b) takes from each stage

// ---------------------------------------------------------------------------
// (b) flash tiles on the tensor cores (bf16)

__device__ void mma_tile(const AttnArgs& A, float* smem, const int* rec, bool store) {
  using bf16 = __nv_bfloat16;
  const int b = rec[F_B], h = rec[F_H], qs = rec[F_QS], ql = rec[F_QL];
  const int kv_end = rec[F_KV];
  const int hd = A.hd, bq = A.bq, kh = h / A.g, ld = hd + 8, vpr = hd / 8;
  const int RG = bq / 16, KS = NWARPS / RG, KC = KW * KS;
  const int n_keys = live_keys(kv_end, rec[F_COST] * A.bk,
                               A.causal ? min(kv_end, qs + bq) : kv_end);
  const int n_st = (n_keys + KC - 1) / KC;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp / KS, ks = warp % KS, g = lane / 4, t = lane % 4;
  const bool busy = rg < RG;
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [2][KC][ld]
  bf16* sV = sK + 2 * KC * ld;               // [2][KC][ld]
  bf16* sQ = sV + 2 * KC * ld;               // [bq][ld]
  const bf16* qp = (const bf16*)A.q + (long long)b * A.q_sb + (long long)h * A.q_sh;
  const bf16* kp = (const bf16*)A.k + (long long)b * A.k_sb + (long long)kh * A.k_sh;
  const bf16* vp = (const bf16*)A.v + (long long)b * A.v_sb + (long long)kh * A.v_sh;

  for (int e = tid; e < bq * vpr; e += NTHREADS) {
    const int i = e / vpr, c = (e - i * vpr) * 8, qpos = qs + i;
    const bool ok = qpos < A.Sq;
    amma::cp_async16(sQ + i * ld + c, qp + (ok ? (long long)qpos * A.q_ss + c : 0), ok);
  }
  auto load_stage = [&](int st) {
    const int k0 = st * KC, buf = (st & 1) * KC;
    for (int e = tid; e < KC * vpr; e += NTHREADS) {
      const int j = e / vpr, c = (e - j * vpr) * 8, kpos = k0 + j;
      const bool ok = kpos < n_keys && kpos < A.Sk;
      amma::cp_async16(sK + (buf + j) * ld + c, kp + (ok ? (long long)kpos * A.k_ss + c : 0), ok);
      amma::cp_async16(sV + (buf + j) * ld + c, vp + (ok ? (long long)kpos * A.v_ss + c : 0), ok);
    }
  };
  if (n_st > 0) load_stage(0);
  amma::cp_async_commit();

  uint32_t qf[MMA_HD / 16][4];
  float o[MMA_HD / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < MMA_HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // ldmatrix row / column of this lane: A and K tiles (x4 = 2 x 2 8x8 blocks)
  const int arow = (lane % 8) + ((lane / 8) % 2) * 8, acol = (lane / 16) * 8;
  const int krow = (lane % 8) + (lane / 16) * 8, kcol = ((lane / 8) % 2) * 8;

  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st) load_stage(st + 1);
    amma::cp_async_commit();
    amma::cp_async_wait<1>();
    __syncthreads();
    if (st == 0 && busy) {
#pragma unroll
      for (int kk = 0; kk < MMA_HD / 16; ++kk)
        if (kk * 16 < hd) amma::ldsm_x4(qf[kk], sQ + (rg * 16 + arow) * ld + kk * 16 + acol);
    }
    const int kb = st * KC + ks * KW;  // this warp's first key
    if (busy && kb < n_keys) {
      const bf16* Kw = sK + ((st & 1) * KC + ks * KW) * ld;
      const bf16* Vw = sV + ((st & 1) * KC + ks * KW) * ld;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < MMA_HD / 16; ++kk) {
        if (kk * 16 < hd) {
          uint32_t kf[4];
          amma::ldsm_x4(kf, Kw + krow * ld + kk * 16 + kcol);
          amma::mma(s[0], qf[kk], kf[0], kf[1]);
          amma::mma(s[1], qf[kk], kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = masked(s[n][e] * A.scale, kb + n * 8 + 2 * t + (e & 1),
                           qs + rg * 16 + g + (e / 2) * 8, kv_end, A.causal, n_keys);
      float corr[2];
      amma::softmax_step<2>(s, m, l, corr);
      uint32_t phi[4], plo[4];
      amma::weights_a(s[0], s[1], phi, plo);
#pragma unroll
      for (int np = 0; np < MMA_HD / 16; ++np) {
        if (np * 16 < hd) {
          uint32_t vf[4];
          amma::ldsm_x4_t(vf, Vw + arow * ld + np * 16 + acol);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float (&acc)[4] = o[2 * np + half];
            acc[0] *= corr[0];
            acc[1] *= corr[0];
            acc[2] *= corr[1];
            acc[3] *= corr[1];
            amma::mma(acc, phi, vf[2 * half], vf[2 * half + 1]);
            amma::mma(acc, plo, vf[2 * half], vf[2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();
  }

  // the kv splits' partials, merged in a fixed order
  amma::cp_async_wait<0>();
  __syncthreads();
  float* racc = smem;                   // [NWARPS * 16][hd]
  float* rm = racc + NWARPS * 16 * hd;  // [NWARPS * 16]
  float* rl = rm + NWARPS * 16;         // [NWARPS * 16]
  if (busy) {
    l[0] = amma::quad_sum(l[0]);
    l[1] = amma::quad_sum(l[1]);
#pragma unroll
    for (int n = 0; n < MMA_HD / 8; ++n) {
      if (n * 8 < hd) {
        float* r0 = racc + (warp * 16 + g) * hd + n * 8 + 2 * t;
        r0[0] = o[n][0];
        r0[1] = o[n][1];
        r0[8 * hd] = o[n][2];
        r0[8 * hd + 1] = o[n][3];
      }
    }
    if (t == 0) {
      rm[warp * 16 + g] = m[0];
      rm[warp * 16 + g + 8] = m[1];
      rl[warp * 16 + g] = l[0];
      rl[warp * 16 + g + 8] = l[1];
    }
  }
  __syncthreads();
  for (int e = tid; e < bq * hd; e += NTHREADS) {
    const int i = e / hd, d = e - i * hd;
    const int w0 = (i / 16) * KS * 16 + i % 16;  // row i in split 0; split s at + 16 s
    float mf = NEG_INF;
    for (int s = 0; s < KS; ++s) mf = fmaxf(mf, rm[w0 + 16 * s]);
    float lf = 0.f, a = 0.f;
    for (int s = 0; s < KS; ++s) {
      const float c = expf(rm[w0 + 16 * s] - mf);
      lf += rl[w0 + 16 * s] * c;
      a += racc[(w0 + 16 * s) * hd + d] * c;
    }
    emit(A, b, h, qs, i, d, i < ql ? a / fmaxf(lf, 1e-30f) : 0.f, store);
  }
  __syncthreads();
}

template <typename T>
struct AttentionTile {
  const AttnArgs& A;
  float* smem;
  __device__ void operator()(const int* rec, bool store) const {
    if (A.branch == BRANCH_DECODE) {
      decode_tile<T, NWARPS>(A, smem, rec, store);
    } else if (A.branch == BRANCH_MMA) {
      if constexpr (sizeof(T) == 2) mma_tile(A, smem, rec, store);
    } else {
      generic_tile<T>(A, smem, rec, store);
    }
  }
};

// ---------------------------------------------------------------------------
// kernels

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_lockstep_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE>(Q, sh, AttentionTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_free_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  ws_free<TRACE>(Q, sh, AttentionTile<T>{A, smem});
}

// The half-run walks (steal_run_cap > 1).
template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_lockstep_run_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE, true>(Q, sh, AttentionTile<T>{A, smem});
}

template <typename T, bool TRACE>
__global__ void __launch_bounds__(NTHREADS) ws_free_run_kernel(WSQueues Q, AttnArgs A) {
  extern __shared__ __align__(16) float smem[];
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

// Dynamic shared memory of a tile body (repro_torch/pallas_ws/kernel.py::smem_bytes).
static size_t tile_smem(int branch, int bq, int bk, int hd) {
  if (branch == BRANCH_DECODE) return (size_t)NWARPS * (hd + 2) * sizeof(float);
  if (branch == BRANCH_MMA) {
    const size_t kc = KW * (NWARPS / (bq / 16)), ld = hd + 8;
    const size_t ring = (4 * kc + bq) * ld * sizeof(__nv_bfloat16);
    const size_t merge = (size_t)NWARPS * 16 * (hd + 2) * sizeof(float);
    return ring > merge ? ring : merge;
  }
  return (size_t)(2 * bq * hd + bk * (hd + 1) + bq * bk + 3 * bq) * sizeof(float);
}

// The shapes each branch takes (the host also checks the layouts).
static bool branch_fits(int branch, int dtype, int bq, int hd) {
  if (branch == BRANCH_DECODE) return bq == 1 && hd % 8 == 0 && hd <= 256;
  if (branch == BRANCH_MMA)
    return dtype == 1 && bq % 16 == 0 && bq >= 16 && bq <= 16 * NWARPS && hd % 16 == 0 &&
           hd <= MMA_HD;
  return branch == BRANCH_GENERIC;
}

extern "C" int ws_attention_launch(
    int mode, int dtype,
    const int* tasks, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const int* stage_open, const void* q, const void* k, const void* v, float* out,
    const long long* strides,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int compress, int run_cap, int causal,
    int H, int Sq, int Sq_out, int Sk, int hd, int g, int bq, int bk, int branch,
    float scale, int* ev, int* ev_cursor, const int* ev_mult0, int ev_cap, int steal_kind,
    int stall_ns, void* stream) {
  if (!branch_fits(branch, dtype, bq, hd)) return (int)cudaErrorInvalidValue;
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
  A.branch = branch;
  const size_t smem = tile_smem(branch, bq, bk, hd);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(Q, A, mode, smem, s);
  return launch<float>(Q, A, mode, smem, s);
}
