// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/ssd_scan/kernel.py: `_ssd_kernel`,
// launched by `ssd_scan` over the grid (b, H, n_chunks) with the chunks
// sequential and the [P, N] fp32 state in VMEM scratch.
//
// What it computes.  x [b, S, H, P], dt [b, S, H], B and C [b, S, N] (one
// group shared by every head; contiguous, fp32 or bf16) and A [H] fp32.  Per
// (b, h) and chunk of Q steps, with cs = cumsum(dt * A) over the chunk:
//   y[i]  = sum_{j <= i} exp(cs_i - cs_j) (C_i . B_j) x_j dt_j + exp(cs_i) (C_i . S)
//   S    <- exp(cs_last) S + sum_q exp(cs_last - cs_q) x_q dt_q (outer) B_q
// with S the state entering the chunk.  It writes y [b, S, H, P] in x's type
// and the final state [b, H, P, N] in fp32.
//
// How.  One CTA of 256 threads per (b, h) walks the chunks in order with the
// state in shared memory (rows padded by one float).  Per chunk it stages
// dt, x * dt (fp32) and B, C (in the input type, rows padded so that threads
// reading down a column hit different banks), takes the cumulative sum with
// one warp's shuffle scan, and forms C B^T o L G_ROWS = 32 rows at a time, so
// the [Q, Q] matrix never has to fit at once.  exp(cs_i - cs_j) is taken only
// where i >= j: above the diagonal cs_i - cs_j is positive and may overflow,
// and inf * 0 would be NaN where the reference selects 0 after its exp.
// Shared memory at Q 128, P 64, N 128: 84 KB of fp32 buffers plus B and C
// (65 KB in bf16, 129 KB in fp32); the wrapper refuses shapes past 227 KB.
//
// What bounds it on this card.  Each input is read once and y written once
// for ~2 * (Q / 2 * (N + P) + 2 * P * N) flops a step and head: at mamba2's
// widths that is ~2.7 flops a byte in bf16, so the bound is bytes (HBM at
// 3.35 TB/s).  This first version is far from it: fp32 products on CUDA cores
// from shared memory, b * H CTAs (160 at mamba2-2.7b, 1 per SM), each chunk's
// loads not overlapped with the previous chunk's math, and B, C read again
// by every head.  Tensor-core products and a pipelined chunk loop are later
// work.

#include <cuda_runtime.h>

#include "dtype_io.cuh"

#define NT 256
#define G_ROWS 32

struct SSDArgs {
  const void* x;
  const void* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* fin;
  int S, H, P, N, Q;
};

template <typename T>
__host__ __device__ constexpr int row_pad() { return sizeof(T) == 2 ? 2 : 1; }

template <typename T>
__global__ void __launch_bounds__(NT) ssd_kernel(SSDArgs a) {
  extern __shared__ float smem[];
  const int S = a.S, H = a.H, P = a.P, N = a.N, Q = a.Q;
  const int lds = N + 1, ldb = N + row_pad<T>();
  float* sS = smem;                 // [P][lds]   state
  float* sX = sS + P * lds;         // [Q][P]     x * dt
  float* sG = sX + Q * P;           // [G_ROWS][Q] rows of C B^T o L
  float* sDT = sG + G_ROWS * Q;     // [Q] dt
  float* sCS = sDT + Q;             // [Q] cumsum(dt * A)
  float* sE = sCS + Q;              // [Q] exp(cs)
  float* sDec = sE + Q;             // [Q] exp(cs_last - cs)
  T* sB = (T*)(sDec + Q);           // [Q][ldb]
  T* sC = sB + Q * ldb;             // [Q][ldb]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const float A = a.A[h];
  const T* x = (const T*)a.x;
  const T* dt = (const T*)a.dt;
  const T* Bg = (const T*)a.B;
  const T* Cg = (const T*)a.C;
  T* y = (T*)a.y;

  for (int e = tid; e < P * lds; e += NT) sS[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const size_t row0 = (size_t)b * S + s0;  // first (b, s) row of the chunk
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Q; i += NT) sDT[i] = to_f(dt[(row0 + i) * H + h]);
    for (int e = tid; e < Q * N; e += NT) {
      const int i = e / N, n = e - i * N;
      sB[i * ldb + n] = Bg[(row0 + i) * N + n];
      sC[i * ldb + n] = Cg[(row0 + i) * N + n];
    }
    __syncthreads();
    if (tid < 32) {  // inclusive scan of dt * A, 32 steps at a time
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? sDT[i] * A : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (i < Q) sCS[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    for (int e = tid; e < Q * P; e += NT) {
      const int i = e / P, p = e - i * P;
      sX[e] = to_f(x[((row0 + i) * H + h) * P + p]) * sDT[i];
    }
    __syncthreads();
    const float cs_last = sCS[Q - 1];
    for (int i = tid; i < Q; i += NT) {
      sE[i] = expf(sCS[i]);
      sDec[i] = expf(cs_last - sCS[i]);
    }

    // y, G_ROWS rows at a time; y_off reads the state entering the chunk
    for (int i0 = 0; i0 < Q; i0 += G_ROWS) {
      const int rows = min(G_ROWS, Q - i0);
      for (int e = tid; e < rows * Q; e += NT) {
        const int ii = e / Q, j = e - ii * Q, i = i0 + ii;
        float g = 0.f;
        if (j <= i) {
          const T* ci = sC + i * ldb;
          const T* bj = sB + j * ldb;
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot += to_f(ci[n]) * to_f(bj[n]);
          g = dot * expf(sCS[i] - sCS[j]);
        }
        sG[ii * Q + j] = g;
      }
      __syncthreads();  // sG (and, at i0 = 0, sE) ready
      for (int e = tid; e < rows * P; e += NT) {
        const int ii = e / P, p = e - ii * P, i = i0 + ii;
        float yd = 0.f;
        for (int j = 0; j <= i; ++j) yd += sG[ii * Q + j] * sX[j * P + p];
        const T* ci = sC + i * ldb;
        const float* sp = sS + p * lds;
        float yo = 0.f;
        for (int n = 0; n < N; ++n) yo += to_f(ci[n]) * sp[n];
        y[((row0 + i) * H + h) * P + p] = from_f<T>(yd + yo * sE[i]);
      }
      __syncthreads();  // sG is rewritten; the state is updated below
    }

    const float decay_all = expf(cs_last);
    for (int e = tid; e < P * N; e += NT) {
      const int p = e / N, n = e - p * N;
      float u = 0.f;
      for (int q = 0; q < Q; ++q) u += (sX[q * P + p] * sDec[q]) * to_f(sB[q * ldb + n]);
      sS[p * lds + n] = decay_all * sS[p * lds + n] + u;
    }
  }
  __syncthreads();
  float* fin = a.fin + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += NT) {
    const int p = e / N, n = e - p * N;
    fin[e] = sS[p * lds + n];
  }
}

template <typename T>
static size_t smem_bytes(int Q, int P, int N) {
  return (size_t)(P * (N + 1) + Q * P + G_ROWS * Q + 4 * Q) * sizeof(float) +
         (size_t)2 * Q * (N + row_pad<T>()) * sizeof(T);
}

template <typename T>
static int launch(const SSDArgs& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.Q, a.P, a.N);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, b);
  ssd_kernel<T><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt, const float* A,
                               const void* B, const void* C, void* y, float* fin, int b, int S,
                               int H, int P, int N, int Q, void* stream) {
  if (b <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  SSDArgs a{x, dt, A, B, C, y, fin, S, H, P, N, Q};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, s);
  return launch<float>(a, b, s);
}
