// fp32 / bf16 loads and stores of every kernel of the port: each computes in
// fp32 whatever type its inputs come in (the standalone kernels, flash_fwd.cu,
// decode_attention.cu and ssd_scan.cu, store their outputs in that type),
// and the one definition of NEG_INF (attn_mma.cuh and ws_attn_body.cuh
// include this header).

#pragma once

#include <cuda_bf16.h>

// the reference's finite score of a masked key (a row's running max starts
// there, so exp(NEG_INF - NEG_INF) = 1 where -inf would give NaN)
#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
