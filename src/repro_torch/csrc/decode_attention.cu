// Single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/decode_attention/kernel.py:
// `_decode_kernel`, launched by `decode_attention` over the grid (B, H, nk)
// with the kv-block dimension sequential (the reference's "split-K" is that
// sequential grid: on the TPU the grid order is the merge).
//
// What it computes.  q [B, H, hd] against the cache k, v [B, Hkv, S, hd]
// (contiguous, fp32 or bf16), query head h reading kv head h / (H / Hkv):
// attention over the slots kpos <= pos (and pos - kpos < window when
// window > 0), where pos is one int32 on the device, read by the kernel as
// the reference reads its SMEM scalar: the host never learns it.  Online
// softmax over blocks of bk keys in fp32; a block past pos or wholly outside
// the window is skipped, keys inside a live block are masked one by one with
// the reference's finite NEG_INF, and l is floored at 1e-30.  out [B, H, hd]
// is written in q's type.
//
// How.  One CTA of 256 threads per (b, h) loops over the live kv blocks.
// Scores: each warp takes every 8th key of the block and its lanes split the
// dot product over hd (shuffle reduction); scores go to shared memory.  The
// block's max and sum are reduced across the CTA; then thread t owns column
// t % hd of the accumulator and sums p * v over every (256 / hd)-th key of
// the block, and the partial sums are added in shared memory.  A split of the
// kv sweep across CTAs with a merge pass (flash-decoding) is a later redesign.
//
// What bounds it on this card.  Each live K/V row is read once for ~4 flops
// per element: bytes (HBM at 3.35 TB/s).  This first version reaches only a
// fraction of it: B * H CTAs (64 at gemma3-12b's decode shape, fewer than the
// 132 SMs), 2-byte loads per lane in the score loop, no cp.async/TMA, and each
// of the G query heads of a kv head reads that head's K/V again (from L2).

#include <cuda_runtime.h>

#include "dtype_io.cuh"

#define NT 256
#define NWARP (NT / 32)

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  int H, Hkv, S, hd, window, bk;
  float scale;
};

// max (or sum) of x over the CTA, returned to every thread
template <bool MAX>
__device__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red is reused by the next reduction
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[NWARP];
  const int hd = a.hd, bk = a.bk, S = a.S;
  float* sq = smem;         // [hd]
  float* ss = sq + hd;      // [bk]: scores, then p
  float* spart = ss + bk;   // [NT]: partial p.v sums, [groups][hd]
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (a.H / a.Hkv);
  const int pos = *a.pos;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = (const T*)a.q + (size_t)(b * a.H + h) * hd;
  const T* k = (const T*)a.k + (size_t)(b * a.Hkv + kvh) * S * hd;
  const T* v = (const T*)a.v + (size_t)(b * a.Hkv + kvh) * S * hd;
  for (int d = tid; d < hd; d += NT) sq[d] = to_f(q[d]);
  const int groups = NT / hd, g = tid / hd, dcol = tid - g * hd;
  float acc = 0.f, m = NEG_INF, l = 0.f;
  __syncthreads();

  const int kb_hi = pos < 0 ? -1 : min(S / bk - 1, pos / bk);
  for (int kb = 0; kb <= kb_hi; ++kb) {
    const int k0 = kb * bk;
    if (a.window > 0 && pos - (k0 + bk - 1) >= a.window) continue;  // uniform
    for (int c = warp; c < bk; c += NWARP) {
      const T* kr = k + (size_t)(k0 + c) * hd;
      float x = 0.f;
      for (int d = lane; d < hd; d += 32) x += sq[d] * to_f(kr[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) {
        const int kpos = k0 + c;
        bool ok = kpos <= pos;
        if (a.window > 0) ok = ok && pos - kpos < a.window;
        ss[c] = ok ? x * a.scale : NEG_INF;
      }
    }
    __syncthreads();
    float mx = NEG_INF;
    for (int c = tid; c < bk; c += NT) mx = fmaxf(mx, ss[c]);
    const float m_new = fmaxf(m, block_reduce<true>(mx, red));
    float sum = 0.f;
    for (int c = tid; c < bk; c += NT) {
      const float p = expf(ss[c] - m_new);
      ss[c] = p;
      sum += p;
    }
    sum = block_reduce<false>(sum, red);  // its barrier publishes ss
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    float part = 0.f;
    if (g < groups)
      for (int c = g; c < bk; c += groups) part += ss[c] * to_f(v[(size_t)(k0 + c) * hd + dcol]);
    spart[tid] = part;
    __syncthreads();
    if (tid < hd) {
      float t = 0.f;
      for (int gg = 0; gg < groups; ++gg) t += spart[gg * hd + tid];
      acc = acc * corr + t;
    }
    __syncthreads();  // ss and spart are rewritten by the next block
  }
  if (tid < hd)
    ((T*)a.out)[(size_t)(b * a.H + h) * hd + tid] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T>
static int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(a.hd + a.bk + NT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, B);
  decode_kernel<T><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                       const int* pos, void* out, int B, int H, int Hkv, int S,
                                       int hd, int window, int bk, float scale, void* stream) {
  if (hd <= 0 || hd > NT || Hkv <= 0 || H % Hkv != 0 || bk <= 0 || S % bk != 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, pos, out, H, Hkv, S, hd, window, bk, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, s);
  return launch<float>(a, B, s);
}
