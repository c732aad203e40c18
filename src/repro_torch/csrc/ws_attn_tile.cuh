// The attention tile body of the port's megakernels (sm_90a): a flash/decode
// tile of `bq` query rows of head `h` against GQA kv head `h / g`, an online
// softmax over `cost` kv blocks of `bk` (replaces `_attention_execute` of
// repro/pallas_ws/kernel.py).  Its one user is ws_unified.cu, which runs it
// beside the step-glue phases of the unified engine step (ws_attention.cu
// carries its own tile bodies).
//
// q, k and v are read through element strides, so a [B, S, Hkv, hd] cache is
// read in place as [B, Hkv, S, hd].  Masks: `kpos < kv_end` (and `kpos <=
// qpos` for causal tiles); rows at or past `q_len` are zeroed; fp32
// arithmetic over fp32 or bf16 inputs.  `store` (free mode) writes the whole
// normalised tile; otherwise (lockstep) the tile is added to `out`.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ws_sched.cuh"

#define F_B 1
#define F_H 2
#define F_QS 3
#define F_QL 4
#define F_KV 5
#define NEG_INF (-1e30f)

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

// All threads of the CTA run the tile; it ends with __syncthreads().
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
