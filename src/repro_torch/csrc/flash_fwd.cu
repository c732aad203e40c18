// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/flash_attention/kernel.py:
// `_fwd_kernel`, launched by `flash_attention_fwd` over the grid
// (B, H, nq, nk) with the k sweep sequential and the online-softmax state in
// VMEM scratch.
//
// What it computes.  q [B, H, S, hd], k and v [B, Hkv, S, hd] (contiguous,
// fp32 or bf16), query head h reading kv head h / (H / Hkv): causal and/or
// sliding-window attention (key visible when kpos <= qpos if causal, and
// qpos - kpos < window if window > 0) with an online softmax in fp32.  It
// writes out [B, H, S, hd] in q's type and lse = m + log(l) [B, H, S] in
// fp32, with the reference's finite NEG_INF = -1e30 for masked scores and
// its floor of 1e-30 on l.
//
// How.  One CTA of 256 threads per (b, h, q-tile of BQ = 64 rows); its loop
// over the k-tiles of BK = 32 keys takes the place of the sequential grid
// dimension, and a k-tile that causal or window masking hides from the whole
// q-tile is never visited.  Q, K and V tiles are staged in shared memory as
// fp32 (rows padded by one float, so threads reading down a column hit
// different banks); four threads share a query row: each computes 8 of the
// tile's 32 scores and owns hd / 4 columns of the row's accumulator in
// registers (up to 64 at hd 256).  The row's max and sum are reduced among
// the four with shuffles.  Shared memory: (2 * 64 + 64) * (hd + 1) * 4 +
// 64 * 33 * 4 bytes, 140 KB at hd 256.
//
// Masking.  A masked score is NEG_INF, not -inf: in a row whose first live
// tile hides every key from it, exp(NEG_INF - NEG_INF) = 1 adds a finite
// term that the next live tile's correction exp(NEG_INF - m) = 0 wipes, as
// in the reference, where -inf would give exp(-inf + inf) = NaN.  Keys past
// S (a ragged last tile) score -inf and weigh exactly 0, since the running
// max never drops below NEG_INF.
//
// What bounds it on this card.  Causal attention at S 4096 does
// ~4 * hd * S^2 / 2 flops per head against (3 + 1) * S * hd elements
// moved: far above the 295 flops a byte where H100 bf16 tensor cores stop
// waiting on HBM, so the bound is operations (989 TFLOP/s bf16).  This
// first version is simple, not fast: fp32 products on CUDA cores from
// shared memory (one shared load per multiply-add), no wgmma, no TMA, no
// overlap of the next tile's loads with this tile's math.  wgmma on bf16
// tiles with a TMA-fed ring of K/V stages is later work.

#include <cuda_runtime.h>

#include "dtype_io.cuh"

#define NT 256
#define BQ 64
#define BK 32
#define TPR 4                 // threads per query row
#define SPT (BK / TPR)        // scores per thread
#define MAXJ (256 / TPR)      // accumulator columns per thread at hd 256

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int H, Hkv, S, hd, causal, window;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ld = hd + 1, S = a.S;
  float* sQ = smem;               // [BQ][ld]
  float* sK = sQ + BQ * ld;       // [BK][ld]
  float* sV = sK + BK * ld;       // [BK][ld]
  float* sP = sV + BK * ld;       // [BQ][BK + 1]
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + (size_t)(b * a.H + h) * S * hd;
  const T* k = (const T*)a.k + (size_t)(b * a.Hkv + kvh) * S * hd;
  const T* v = (const T*)a.v + (size_t)(b * a.Hkv + kvh) * S * hd;
  const int tid = threadIdx.x, r = tid / TPR, cg = tid % TPR;
  const int qpos = q0 + r;

  for (int i = tid; i < BQ * hd; i += NT) {
    const int rr = i / hd, d = i - rr * hd;
    sQ[rr * ld + d] = q0 + rr < S ? to_f(q[(size_t)(q0 + rr) * hd + d]) : 0.f;
  }
  float acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  // live k-tiles: causal hides keys past the q-tile's newest row, the
  // window keys older than its oldest row can see
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_hi = (S + BK - 1) / BK - 1;
  if (a.causal) kt_hi = min(kt_hi, q_last / BK);
  const int kt_lo = a.window > 0 ? max(0, q0 - a.window + 1) / BK : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * hd; i += NT) {
      const int c = i / hd, d = i - c * hd;
      const bool in = k0 + c < S;
      sK[c * ld + d] = in ? to_f(k[(size_t)(k0 + c) * hd + d]) : 0.f;
      sV[c * ld + d] = in ? to_f(v[(size_t)(k0 + c) * hd + d]) : 0.f;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) s[i] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qd = sQ[r * ld + d];
#pragma unroll
      for (int i = 0; i < SPT; ++i) s[i] += qd * sK[(cg + TPR * i) * ld + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int kpos = k0 + cg + TPR * i;
      bool ok = true;
      if (a.causal) ok = ok && qpos >= kpos;
      if (a.window > 0) ok = ok && qpos - kpos < a.window;
      float x = ok ? s[i] * a.scale : NEG_INF;
      if (kpos >= S) x = -INFINITY;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const float p = expf(s[i] - m_new);
      sP[r * (BK + 1) + cg + TPR * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // the row's p, written by its 4 threads of this warp
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[j] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = sP[r * (BK + 1) + c];
      const float* vr = sV + c * ld + cg;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j)
        if (cg + TPR * j < hd) acc[j] += p * vr[TPR * j];
    }
  }

  if (qpos < S) {
    const float lf = fmaxf(l, 1e-30f);
    T* o = (T*)a.out + ((size_t)(b * a.H + h) * S + qpos) * hd;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (cg + TPR * j < hd) o[cg + TPR * j] = from_f<T>(acc[j] / lf);
    if (cg == 0) a.lse[(size_t)(b * a.H + h) * S + qpos] = m + logf(lf);
  }
}

template <typename T>
static int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)((BQ + 2 * BK) * (a.hd + 1) + BQ * (BK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<T><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int H, int Hkv, int S, int hd,
                                int causal, int window, float scale, void* stream) {
  if (hd <= 0 || hd > TPR * MAXJ || Hkv <= 0 || H % Hkv != 0 || S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, out, lse, H, Hkv, S, hd, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, s);
  return launch<float>(a, B, s);
}
