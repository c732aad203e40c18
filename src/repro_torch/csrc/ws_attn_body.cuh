// The CUDA-core attention tile bodies of the port's megakernels (sm_90a),
// shared by ws_attention.cu (its branches (a) and (c)) and ws_unified.cu
// (the unified step's decode and flash tiles).  Each replaces the tile body
// `_attention_execute` of repro/pallas_ws/kernel.py; ws_attention.cu's
// header says what a tile computes, and which shapes and layouts each body
// takes.
//  (a) decode_tile<T, NW, NC>: bq = 1, a GEMV over NW warps (8 in
//      ws_attention's 256-thread CTA, 16 in ws_unified's 512).  NC reads K
//      and V through the non-coherent path (__ldg): ws_attention's inputs
//      are read-only for the launch, while the unified step writes each
//      slot's new cache row earlier in the same launch and CTA, so it reads
//      them with plain loads.
//  (c) generic_tile<T>: any bq, fp32 on CUDA cores through shared memory
//      over every thread of the CTA, its K/V rows padded to hd + 1 floats.
// Both end with __syncthreads().

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "dtype_io.cuh"
#include "ws_sched.cuh"

#define F_B 1
#define F_H 2
#define F_QS 3
#define F_QL 4
#define F_KV 5

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
  int branch;
};

// Keys a tile sweeps (module comment): `end` is the first key no row sees.
__device__ __forceinline__ int live_keys(int kv_end, int kv_lim, int end) {
  return kv_end >= 1 ? min(kv_lim, end) : kv_lim;
}

__device__ __forceinline__ float masked(float s, int kpos, int qpos, int kv_end, int causal,
                                        int n_keys) {
  if (kpos >= n_keys) return -INFINITY;  // past the sweep: weighs 0
  return (kpos < kv_end && (!causal || kpos <= qpos)) ? s : NEG_INF;
}

// One normalised output row element of a tile: store (free) or add (lockstep).
__device__ __forceinline__ void emit(const AttnArgs& A, int b, int h, int qs, int i, int d,
                                     float t, bool store) {
  const long long o = (((long long)b * A.H + h) * A.Sq_out + qs + i) * A.hd + d;
  if (store) {
    A.out[o] = t;
  } else {
    A.out[o] += t;
  }
}

// ---------------------------------------------------------------------------
// (a) decode

// 8 elements of a lane from its 16-byte words (one bf16 word, two fp32 words).
__device__ __forceinline__ void unpack8(const uint4* w, float (&x)[8], __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack8(const uint4* w, float (&x)[8], float) {
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __uint_as_float((&w[e / 4].x)[e % 4]);
}

template <typename T, int NW = 8, bool NC = true>
__device__ void decode_tile(const AttnArgs& A, float* smem, const int* rec, bool store) {
  constexpr int U = sizeof(T) == 2 ? 8 : 4;   // keys in flight a lane group
  constexpr int W = 8 * sizeof(T) / 16;       // 16-byte words a lane a row
  const int b = rec[F_B], h = rec[F_H], qs = rec[F_QS], ql = rec[F_QL];
  const int kv_end = rec[F_KV];
  const int hd = A.hd, kh = h / A.g;
  const int n_keys = live_keys(kv_end, rec[F_COST] * A.bk, A.causal ? min(kv_end, qs + 1) : kv_end);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int G = 1;
  while (G * 8 < hd) G *= 2;
  const int kps = 32 / G, lg = lane / G, li = lane % G;
  const bool act = li * 8 < hd;

  float qv[8];
  const T* qp = (const T*)A.q + (long long)b * A.q_sb + (long long)h * A.q_sh +
                (long long)qs * A.q_ss;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    qv[e] = (act && qs < A.Sq) ? to_f(qp[(long long)(li * 8 + e) * A.q_sd]) : 0.f;
  const T* kb = (const T*)A.k + (long long)b * A.k_sb + (long long)kh * A.k_sh + li * 8;
  const T* vb = (const T*)A.v + (long long)b * A.v_sb + (long long)kh * A.v_sh + li * 8;

  float m = NEG_INF, l = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  const int step = U * kps;  // keys a warp takes at once
  for (int c0 = warp * step; c0 < n_keys; c0 += NW * step) {
    uint4 kw[U][W], vw[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = c0 + u * kps + lg;
      const bool ok = act && key < n_keys && key < A.Sk;
      const uint4* kr = reinterpret_cast<const uint4*>(kb + (ok ? (long long)key * A.k_ss : 0));
      const uint4* vr = reinterpret_cast<const uint4*>(vb + (ok ? (long long)key * A.v_ss : 0));
#pragma unroll
      for (int w = 0; w < W; ++w) {
        kw[u][w] = ok ? (NC ? __ldg(kr + w) : kr[w]) : make_uint4(0, 0, 0, 0);
        vw[u][w] = ok ? (NC ? __ldg(vr + w) : vr[w]) : make_uint4(0, 0, 0, 0);
      }
    }
    float s[U], mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[8];
      unpack8(kw[u], x, T());
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot += qv[e] * x[e];
      for (int o = G / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u] = masked(dot * A.scale, c0 + u * kps + lg, qs, kv_end, A.causal, n_keys);
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx), corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - m_new);
      float x[8];
      unpack8(vw[u], x, T());
      l += p;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += p * x[e];
    }
    m = m_new;
  }

  // lane groups of the warp, then the warps, each in a fixed order
  for (int o = G; o < 32; o *= 2) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, mo), c1 = expf(m - mn), c2 = expf(mo - mn);
    l = l * c1 + lo * c2;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = acc[e] * c1 + __shfl_xor_sync(0xffffffffu, acc[e], o) * c2;
    m = mn;
  }
  float* racc = smem;          // [NW][hd]
  float* rm = racc + NW * hd;  // [NW]
  float* rl = rm + NW;         // [NW]
  if (lg == 0 && act) {
#pragma unroll
    for (int e = 0; e < 8; ++e) racc[warp * hd + li * 8 + e] = acc[e];
  }
  if (lane == 0) {
    rm[warp] = m;
    rl[warp] = l;
  }
  __syncthreads();
  for (int d = tid; d < hd; d += NW * 32) {
    float mf = NEG_INF;
    for (int w = 0; w < NW; ++w) mf = fmaxf(mf, rm[w]);
    float lf = 0.f, a = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float c = expf(rm[w] - mf);
      lf += rl[w] * c;
      a += racc[w * hd + d] * c;
    }
    emit(A, b, h, qs, 0, d, ql > 0 ? a / fmaxf(lf, 1e-30f) : 0.f, store);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// (c) the first tile body, K/V rows padded

template <typename T>
__device__ void generic_tile(const AttnArgs& A, float* smem, const int* rec, bool store) {
  const int b = rec[F_B], h = rec[F_H], qs = rec[F_QS], ql = rec[F_QL];
  const int kv_end = rec[F_KV], cost = rec[F_COST];
  const int kh = h / A.g;
  const int hd = A.hd, bq = A.bq, bk = A.bk, ld = hd + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* sq = smem;              // [bq, hd]
  float* sacc = sq + bq * hd;    // [bq, hd]
  float* skv = sacc + bq * hd;   // [bk, hd + 1]  K block, then V block
  float* ss = skv + bk * ld;     // [bq, bk]  scores, then probabilities
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
      skv[j * ld + d] =
          kpos < A.Sk ? to_f(kp[(long long)kpos * A.k_ss + (long long)d * A.k_sd]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < bq * bk; e += nt) {
      int i = e / bk, j = e % bk;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc += sq[i * hd + d] * skv[j * ld + d];
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
      skv[j * ld + d] =
          kpos < A.Sk ? to_f(vp[(long long)kpos * A.v_ss + (long long)d * A.v_sd]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < bq * hd; e += nt) {
      int i = e / hd, d = e % hd;
      float a = 0.f;
      for (int j = 0; j < bk; ++j) a += ss[i * bk + j] * skv[j * ld + d];
      sacc[e] = sacc[e] * scorr[i] + a;
    }
    __syncthreads();
  }

  for (int e = tid; e < bq * hd; e += nt) {
    int i = e / hd, d = e % hd;
    float t = sacc[e] / fmaxf(sl[i], 1e-30f);
    emit(A, b, h, qs, i, d, i < ql ? t : 0.f, store);
  }
  __syncthreads();
}
