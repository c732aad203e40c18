// Single-token decode attention for Hopper (sm_90a): split-KV flash-decoding.
//
// Replaces the TPU kernel of repro/kernels/decode_attention/kernel.py:
// `_decode_kernel`, launched by `decode_attention` over the grid (B, H, nk)
// with the kv-block dimension sequential (on the TPU the grid order is the
// merge of the blocks' softmax states).
//
// What it computes.  q [B, H, hd] against the cache k, v [B, Hkv, S, hd]
// (contiguous, fp32 or bf16), query head h reading kv head h / (H / Hkv):
// softmax attention over the visible slots, kpos <= pos (and pos - kpos <
// window when window > 0), where pos is one int32 on the device, read by the
// kernel as the reference reads its SMEM scalar: the host never learns it.
// A slot that is not visible has weight 0, as a masked key of a live block
// has in the reference (its exp(NEG_INF - m) is 0 once the block's max is a
// visible score); with no visible slot the output is 0, as the reference's
// when it skips every block.  out [B, H, hd] is written in q's type.
//
// How.  Two kernels on one stream, launched by decode_attention_launch.
// * A split kernel: one CTA per (split, kv head [, group of at most 8 query
//   heads], batch row).  The visible keys run from `base` (0, or pos -
//   window + 1 with a window) to last = min(pos, S - 1); split i takes keys
//   [base + i c, base + (i + 1) c) of them, c = ceil((last - base + 1) /
//   n_split), all computed on the device from pos.  The host sizes the grid
//   (n_split) from S, the window, B, Hkv and the SM count, never from pos,
//   and every split is live however few keys pos leaves visible, unless
//   there are fewer visible keys than splits.  A CTA with no visible key
//   writes a dead partial (l = 0) and returns.  A live CTA reads each
//   visible K and V row of its split once, for all the query heads of its
//   kv head, through a cp.async ring of 16-byte copies in shared memory
//   (one __syncthreads a stage); rows past its last visible key are
//   zero-filled, never read.  Each warp
//   keeps its own online softmax (m, l, acc) in fp32 registers; at the end
//   the warps merge in shared memory in a fixed order and the CTA writes
//   its partial (m, l, acc[hd]) per head to scratch [B, H, n_split, hd + 2]
//   fp32.  A key is taken by a group of L lanes (L = the 16-byte vectors
//   of a row, rounded up to a power of two, at most 32), each lane holding
//   q for its vectors in registers, a warp 4 rows per lane group of every
//   stage; fp32 FMAs with shuffle reductions.  Rows whose 16 bytes do not
//   divide a row, or a cache not aligned to 16 bytes, fill the ring by
//   element loads instead of cp.async, each row padded with zeros.
// * decode_merge_kernel: one warp per (b, h) reads that head's partials in
//   ascending split order, skips the dead ones and writes
//   out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30),
//   M the largest live m_i.
// No atomics and no fences: the merge is a second launch, not a last-CTA
// counter, and the two kernels order through the stream.
//
// What bounds it on this card.  About 2 G flops per 2-byte K/V element, far
// below the H100's ridge (~295 operations a byte in bf16): bytes (HBM at
// 3.35 TB/s).  The design reads every visible K/V row once with 16-byte
// copies, a stage in flight in each of several CTAs an SM (a 2-stage ring
// of 16 KB stages at hd 256 bf16: 5 CTAs an SM, by registers), and gives a
// long cache about three CTAs an SM (the split count); the partials add
// n_split * (hd + 2) * 4 bytes a head, written once and read once.  A
// tensor-core body (S^T = K Q^T on mma.sync with the query heads as the
// tile's 8 columns) ran no faster on the H100: the stream, not the
// arithmetic, sets the time.
//
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "dtype_io.cuh"

#define NT 128              // threads a CTA
#define NWARP (NT / 32)
#define NSTAGE 2            // depth of the cp.async ring
#define ROWS 4              // rows a lane group takes from each stage

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  float* part;  // [B, H, n_split, hd + 2]: m, l, acc
  int H, Hkv, S, hd, window, n_split;
  float scale;
};

// A split CTA's place: its batch row, kv head and first query head, how
// many query heads it serves, and its visible keys [k_lo, k_lo + nkeys)
// (nkeys <= 0: none).
struct Place {
  int b, kvh, h0, ng, k_lo, nkeys;
};

__device__ __forceinline__ Place place(const DecodeArgs& a, int gt) {
  Place p;
  const int G = a.H / a.Hkv, n_hg = (G + gt - 1) / gt;
  p.b = blockIdx.z;
  p.kvh = blockIdx.y / n_hg;
  p.h0 = p.kvh * G + (blockIdx.y - p.kvh * n_hg) * gt;
  p.ng = min(gt, p.kvh * G + G - p.h0);
  // the visible keys [base, last], cut into n_split splits of c keys
  const int pos = *a.pos;
  const long long base = a.window > 0 ? max(0LL, (long long)pos - a.window + 1) : 0LL;
  const long long last = min((long long)pos, (long long)a.S - 1);
  const long long c = last >= base ? (last - base + a.n_split) / a.n_split : 0;
  const long long lo = base + (long long)blockIdx.x * c;
  const long long hi = min(lo + c - 1, last);
  p.k_lo = lo > hi ? 0 : (int)lo;
  p.nkeys = lo > hi ? 0 : (int)(hi - lo) + 1;
  return p;
}

// The partial row of query head h0 + g of this CTA's split.
__device__ __forceinline__ float* partial(const DecodeArgs& a, const Place& p, int g) {
  return a.part + ((size_t)(p.b * a.H + p.h0 + g) * a.n_split + blockIdx.x) * (a.hd + 2);
}

// A split with no visible key: l = 0 marks it dead for the merge.
__device__ __forceinline__ void dead_partial(const DecodeArgs& a, const Place& p) {
  if ((int)threadIdx.x < p.ng) {
    float* pg = partial(a, p, threadIdx.x);
    pg[0] = NEG_INF;
    pg[1] = 0.f;
  }
}

// The warps' states (wm, wl [nwarp][gt], wacc [nwarp][gt][rs]) merged in
// ascending warp order into the CTA's partial of each of its query heads.
__device__ __forceinline__ void write_partials(const DecodeArgs& a, const Place& p, int nwarp,
                                               int gt, int rs, const float* wm, const float* wl,
                                               const float* wacc) {
  const int hd = a.hd;
  for (int i = threadIdx.x; i < p.ng * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float M = NEG_INF;
    for (int w = 0; w < nwarp; ++w) M = fmaxf(M, wm[w * gt + g]);
    float A = 0.f, Ls = 0.f;
    for (int w = 0; w < nwarp; ++w) {
      const float e = expf(wm[w * gt + g] - M);  // 0 for a warp that saw no visible key
      A = fmaf(e, wacc[(w * gt + g) * rs + d], A);
      Ls = fmaf(e, wl[w * gt + g], Ls);
    }
    float* pg = partial(a, p, g);
    pg[2 + d] = A;
    if (d == 0) {
      pg[0] = M;
      pg[1] = Ls;
    }
  }
}

// ---------------------------------------------------------------------------
// the split kernel

// How a head dim of type T is cut: nvec 16-byte vectors of VE elements (the
// last padded in shared memory: rs elements a row), L lanes a key, tk rows a
// stage.  The host mirrors it in kernels/decode_attention/kernel.py.
struct Geom {
  int nvec, L, tk, rs;
};

template <typename T>
__host__ __device__ inline Geom geom(int hd) {
  constexpr int VE = 16 / (int)sizeof(T);
  Geom g;
  g.nvec = (hd + VE - 1) / VE;
  g.L = 1;
  while (g.L < g.nvec && g.L < 32) g.L <<= 1;
  g.tk = ROWS * NWARP * (32 / g.L);
  g.rs = g.nvec * VE;
  return g;
}

__device__ __forceinline__ void ld16(const float* p, float (&f)[4]) {
  const float4 t = *(const float4*)p;
  f[0] = t.x, f[1] = t.y, f[2] = t.z, f[3] = t.w;
}

__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 t = *(const uint4*)p;
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*(const __nv_bfloat162*)&w[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}

template <typename T, int GT>
__global__ void __launch_bounds__(NT) decode_split_kernel(DecodeArgs a, int vec) {
  constexpr int VE = 16 / (int)sizeof(T);
  constexpr int VPL = 8 / VE;  // vectors a lane holds of a row: 1 (bf16) or 2 (fp32)
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom gm = geom<T>(a.hd);
  const int hd = a.hd, nvec = gm.nvec, L = gm.L, TK = gm.tk, RS = gm.rs;
  const Place p = place(a, GT);
  if (p.nkeys <= 0) {  // uniform over the CTA
    dead_partial(a, p);
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = p.ng, nkeys = p.nkeys, n_st = (nkeys + TK - 1) / TK;
  const size_t kv_off = ((size_t)p.b * a.Hkv + p.kvh) * a.S * hd + (size_t)p.k_lo * hd;
  const T* kb = (const T*)a.k + kv_off;
  const T* vb = (const T*)a.v + kv_off;
  T* ring = (T*)smem;  // NSTAGE x {K [TK][RS], V [TK][RS]}

  auto load = [&](int st) {
    if (st < n_st) {
      T* dk = ring + (st % NSTAGE) * 2 * TK * RS;
      T* dv = dk + TK * RS;
      const int r0 = st * TK;
      if (vec) {
        for (int i = tid; i < TK * nvec; i += NT) {
          const int r = i / nvec, c = i - r * nvec;
          const bool ok = r0 + r < nkeys;
          const int src = (ok ? (r0 + r) * hd : 0) + c * VE;
          amma::cp_async16(dk + r * RS + c * VE, kb + src, ok);
          amma::cp_async16(dv + r * RS + c * VE, vb + src, ok);
        }
      } else {
        for (int i = tid; i < TK * RS; i += NT) {
          const int r = i / RS, c = i - r * RS;
          const bool ok = r0 + r < nkeys && c < hd;
          dk[i] = ok ? kb[(r0 + r) * hd + c] : from_f<T>(0.f);
          dv[i] = ok ? vb[(r0 + r) * hd + c] : from_f<T>(0.f);
        }
      }
    }
    amma::cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  // q of this CTA's heads, the lane's vectors of each row, in registers
  const int slot = lane / L, c0 = lane - slot * L, kpw = 32 / L;
  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const T* qh = (const T*)a.q + (size_t)(p.b * a.H + p.h0 + g) * hd;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const int d = (c0 + i * L) * VE + e;
        qr[g][i * VE + e] = g < ng && c0 + i * L < nvec && d < hd ? to_f(qh[d]) : 0.f;
      }
  }
  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) load(st);
  const int rbase = warp * ROWS * kpw;  // this warp's rows of a stage: rbase + r * kpw + slot
  for (int st = 0; st < n_st; ++st) {
    amma::cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage st has landed; every warp is done with stage st - 1
    load(st + NSTAGE - 1);  // into the slot of stage st - 1
    const int n_valid = nkeys - st * TK;  // rows < n_valid of this stage are visible keys
    if (rbase >= n_valid) continue;       // warp-uniform: nothing visible for this warp
    const T* sk = ring + (st % NSTAGE) * 2 * TK * RS;
    const T* sv = sk + TK * RS;
    float x[ROWS][GT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = rbase + r * kpw + slot;
#pragma unroll
      for (int g = 0; g < GT; ++g) x[r][g] = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        if (c0 + i * L >= nvec) continue;
        float kf[VE];
        ld16(sk + row * RS + (c0 + i * L) * VE, kf);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e) x[r][g] = fmaf(qr[g][i * VE + e], kf[e], x[r][g]);
      }
    }
    for (int o = L >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int g = 0; g < GT; ++g) x[r][g] += __shfl_xor_sync(0xffffffffu, x[r][g], o);
    float mb[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      mb[g] = NEG_INF;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        x[r][g] = rbase + r * kpw + slot < n_valid ? x[r][g] * a.scale : NEG_INF;
        mb[g] = fmaxf(mb[g], x[r][g]);
      }
    }
    for (int o = L; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GT; ++g) mb[g] = fmaxf(mb[g], __shfl_xor_sync(0xffffffffu, mb[g], o));
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m_new = fmaxf(m[g], mb[g]);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {  // p = 0 for a row that is not a visible key
        x[r][g] = rbase + r * kpw + slot < n_valid ? expf(x[r][g] - m_new) : 0.f;
        l[g] += x[r][g];
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = rbase + r * kpw + slot;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        if (c0 + i * L >= nvec) continue;
        float vf[VE];
        ld16(sv + row * RS + (c0 + i * L) * VE, vf);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            acc[g][i * VE + e] = fmaf(x[r][g], vf[e], acc[g][i * VE + e]);
      }
    }
  }
  amma::cp_async_wait<0>();

  // lane groups of a warp share m: add their l and acc
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
    }
  __syncthreads();  // the ring is done with: it becomes the warps' merge area
  float* wm = (float*)smem;        // [NWARP][GT]
  float* wl = wm + NWARP * GT;     // [NWARP][GT]
  float* wacc = wl + NWARP * GT;   // [NWARP][GT][RS]
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      wm[warp * GT + g] = m[g];
      wl[warp * GT + g] = l[g];
    }
  if (slot == 0)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (c0 + i * L < nvec)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            wacc[(warp * GT + g) * RS + (c0 + i * L) * VE + e] = acc[g][i * VE + e];
  __syncthreads();
  write_partials(a, p, NWARP, GT, RS, wm, wl, wacc);
}

// ---------------------------------------------------------------------------
// the merge

template <typename T>
__global__ void __launch_bounds__(128) decode_merge_kernel(DecodeArgs a, int rows) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);  // b * H + h
  if (row >= rows) return;
  const int lane = threadIdx.x & 31, hd = a.hd, w = hd + 2;
  const float* p = a.part + (size_t)row * a.n_split * w;
  float M = NEG_INF;
  for (int i = 0; i < a.n_split; ++i)
    if (p[i * w + 1] > 0.f) M = fmaxf(M, p[i * w]);
  float A[8], Ls = 0.f;  // columns lane + 32 j
#pragma unroll
  for (int j = 0; j < 8; ++j) A[j] = 0.f;
  for (int i = 0; i < a.n_split; ++i) {  // ascending split order
    const float li = p[i * w + 1];
    if (!(li > 0.f)) continue;  // a dead split
    const float e = expf(p[i * w] - M);
    Ls = fmaf(e, li, Ls);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (lane + 32 * j < hd) A[j] = fmaf(e, p[i * w + 2 + lane + 32 * j], A[j]);
  }
  Ls = fmaxf(Ls, 1e-30f);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (lane + 32 * j < hd) ((T*)a.out)[(size_t)row * hd + lane + 32 * j] = from_f<T>(A[j] / Ls);
}

// ---------------------------------------------------------------------------
// host

static int set_smem(const void* fn, size_t smem) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int GT>
static int launch_split(const DecodeArgs& a, int B, int vec, cudaStream_t stream) {
  const Geom gm = geom<T>(a.hd);
  const size_t ring = (size_t)NSTAGE * 2 * gm.tk * gm.rs * sizeof(T);
  const size_t merge = (size_t)NWARP * GT * (2 + gm.rs) * sizeof(float);
  const size_t smem = ring > merge ? ring : merge;
  const int err = set_smem((const void*)decode_split_kernel<T, GT>, smem);
  if (err != 0) return err;
  const int G = a.H / a.Hkv;
  dim3 grid(a.n_split, a.Hkv * ((G + GT - 1) / GT), B);
  decode_split_kernel<T, GT><<<grid, NT, smem, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

// the split kernel, then the merge
template <typename T>
static int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const int vec = (a.hd * (int)sizeof(T)) % 16 == 0 && (uintptr_t)a.k % 16 == 0 &&
                  (uintptr_t)a.v % 16 == 0;
  const int err = G <= 1   ? launch_split<T, 1>(a, B, vec, stream)
                  : G <= 2 ? launch_split<T, 2>(a, B, vec, stream)
                  : G <= 4 ? launch_split<T, 4>(a, B, vec, stream)
                           : launch_split<T, 8>(a, B, vec, stream);
  if (err != 0) return err;
  const int rows = B * a.H;
  decode_merge_kernel<T><<<(rows + 3) / 4, 128, 0, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

extern "C" int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                       const int* pos, void* out, float* part, int B, int H,
                                       int Hkv, int S, int hd, int window, int n_split,
                                       float scale, void* stream) {
  if (hd <= 0 || hd > 256 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || B <= 0 || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, pos, out, part, H, Hkv, S, hd, window, n_split, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, s);
  return launch<float>(a, B, s);
}
