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
// Two bodies, chosen on the host from (dtype, hd) by flash_branch
// (kernels/flash_attention/kernel.py) and passed in as `body`:
//
// bf16 with hd % 8 == 0: FlashAttention-2's shape on mma.sync
// (attn_mma.cuh).  A CTA of 4 warps owns 64 query rows, 16 a warp; its loop
// over the live k-tiles (BK = 64 keys, 32 at hd 256 where the accumulator
// takes 128 registers) takes the place of the sequential grid dimension.
// K and V tiles come through a double-buffered cp.async ring in shared
// memory (rows padded by 16 bytes, so ldmatrix is conflict-free); each
// warp runs S = Q Kᵀ and O += P V with m16n8k16 products in fp32, P taken
// from the score registers in two bf16 parts (hi + lo, attn_mma.cuh), so
// the weights keep ~17 bits.  Q fragments stay in registers up to hd 128
// and are read from shared memory per k-step at hd 256.  hd is a template
// over the padded widths 64, 128 and 256; columns past hd are zero-filled
// and never stored, so hd 128 issues no wasted column.  A k-tile that
// causal or window masking hides from a whole q-tile is never loaded, one
// hidden from a warp's 16 rows is not computed, and the grid runs the
// q-tiles with the most causal work first.  Shared memory: (64 + 4 BK) x
// (HD + 8) x 2 bytes, 99 KB at hd 256.
//
// fp32 (and bf16 with hd % 8 != 0): the first version, on CUDA cores.  One
// CTA of 256 threads per (b, h, q-tile of 64 rows) over k-tiles of 32 keys;
// Q, K and V tiles staged in shared memory as fp32 (rows padded by one
// float, so threads reading down a column hit different banks); four
// threads share a query row: each computes 8 of the tile's 32 scores and
// owns hd / 4 columns of the row's accumulator in registers (up to 64 at
// hd 256).  The row's max and sum are reduced among the four with
// shuffles.  Shared memory: (2 * 64 + 64) * (hd + 1) * 4 + 64 * 33 * 4
// bytes, 140 KB at hd 256.
//
// Masking.  A masked score is NEG_INF, not -inf: in a row whose first live
// tile hides every key from it, exp(NEG_INF - NEG_INF) = 1 adds a finite
// term that the next live tile's correction exp(NEG_INF - m) = 0 wipes, as
// in the reference, where -inf would give exp(-inf + inf) = NaN.  Keys past
// S (a ragged last tile) score -inf and weigh exactly 0, since the running
// max never drops below NEG_INF.  Every row sees its own key, so skipping
// a tile its rows cannot see changes no result.
//
// What bounds it on this card.  Causal attention at S 4096 does
// ~4 * hd * S^2 / 2 flops per head against (3 + 1) * S * hd elements
// moved: far above the 295 flops a byte where H100 bf16 tensor cores stop
// waiting on HBM, so the bound is operations (989 TFLOP/s bf16).  mma.sync
// reaches a fraction of wgmma's rate, and the two-part P adds half again
// to the products; wgmma and TMA would need fences the port's audit
// forbids (attn_mma.cuh).

#include <cuda_runtime.h>

#include "dtype_io.cuh"
#include "attn_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

#define TC_WARPS 4
#define TC_BQ (16 * TC_WARPS)  // query rows a CTA, 16 a warp

// The tile of a padded head dim HD: keys a stage, padded row, shared memory.
template <int HD>
struct Tc {
  static constexpr int BKV = HD == 256 ? 32 : 64;
  static constexpr int LD = HD + 8;
  static constexpr bool QREG = HD <= 128;  // Q fragments in registers
  static constexpr size_t SMEM = (size_t)(TC_BQ + 4 * BKV) * LD * 2;
};

template <int HD>
__global__ void __launch_bounds__(32 * TC_WARPS) flash_fwd_mma(FlashArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BKV = Tc<HD>::BKV, LD = Tc<HD>::LD, NTH = 32 * TC_WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [TC_BQ][LD]
  bf16* sK = sQ + TC_BQ * LD;                    // [2][BKV][LD]
  bf16* sV = sK + 2 * BKV * LD;                   // [2][BKV][LD]
  const int hd = a.hd, S = a.S, vpr = (hd + 15) / 16 * 2;  // 16-byte words a row
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;      // most causal work first
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const bf16* q = (const bf16*)a.q + (size_t)(b * a.H + h) * S * hd;
  const bf16* k = (const bf16*)a.k + (size_t)(b * a.Hkv + kvh) * S * hd;
  const bf16* v = (const bf16*)a.v + (size_t)(b * a.Hkv + kvh) * S * hd;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int qw = q0 + 16 * warp;  // this warp's first row

  const int q_last = min(q0 + TC_BQ, S) - 1;
  int kt_hi = (S + BKV - 1) / BKV - 1;
  if (a.causal) kt_hi = min(kt_hi, q_last / BKV);
  const int kt_lo = a.window > 0 ? max(0, q0 - a.window + 1) / BKV : 0;

  // rows past S and columns past hd (up to the next 16) are zero-filled
  for (int e = tid; e < TC_BQ * vpr; e += NTH) {
    const int r = e / vpr, c = (e - r * vpr) * 8;
    const bool ok = q0 + r < S && c < hd;
    amma::cp_async16(sQ + r * LD + c, q + (ok ? (size_t)(q0 + r) * hd + c : 0), ok);
  }
  auto load = [&](int kt, int buf) {
    const int k0 = kt * BKV;
    for (int e = tid; e < BKV * vpr; e += NTH) {
      const int r = e / vpr, c = (e - r * vpr) * 8;
      const bool ok = k0 + r < S && c < hd;
      const size_t off = ok ? (size_t)(k0 + r) * hd + c : 0;
      amma::cp_async16(sK + (buf * BKV + r) * LD + c, k + off, ok);
      amma::cp_async16(sV + (buf * BKV + r) * LD + c, v + off, ok);
    }
  };
  if (kt_lo <= kt_hi) load(kt_lo, 0);
  amma::cp_async_commit();

  uint32_t qf[Tc<HD>::QREG ? HD / 16 : 1][4];
  float o[HD / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // ldmatrix row / column of this lane: A and V tiles, and K tiles
  const int arow = (lane % 8) + ((lane / 8) % 2) * 8, acol = (lane / 16) * 8;
  const int krow = (lane % 8) + (lane / 16) * 8, kcol = ((lane / 8) % 2) * 8;
  const bf16* qa = sQ + (16 * warp + arow) * LD + acol;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1, k0 = kt * BKV;
    if (kt < kt_hi) load(kt + 1, buf ^ 1);
    amma::cp_async_commit();
    amma::cp_async_wait<1>();
    __syncthreads();
    if constexpr (Tc<HD>::QREG) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          if (kk * 16 < hd) amma::ldsm_x4(qf[kk], qa + kk * 16);
      }
    }
    // a tile hidden from all 16 rows of the warp: causal (every key newer
    // than its newest row) or window (every key too old for its oldest)
    const bool live = qw < S && !(a.causal && k0 > qw + 15) &&
                      !(a.window > 0 && qw - (k0 + BKV - 1) >= a.window);
    if (live) {
      const bf16* Kt = sK + buf * BKV * LD;
      const bf16* Vt = sV + buf * BKV * LD;
      float s[BKV / 8][4];
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if (kk * 16 < hd) {
          uint32_t af[4];
          if constexpr (Tc<HD>::QREG) {
#pragma unroll
            for (int j = 0; j < 4; ++j) af[j] = qf[kk][j];
          } else {
            amma::ldsm_x4(af, qa + kk * 16);
          }
#pragma unroll
          for (int np = 0; np < BKV / 16; ++np) {
            uint32_t kf[4];
            amma::ldsm_x4(kf, Kt + (np * 16 + krow) * LD + kk * 16 + kcol);
            amma::mma(s[2 * np], af, kf[0], kf[1]);
            amma::mma(s[2 * np + 1], af, kf[2], kf[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * n + 2 * t + (e & 1), qpos = qw + g + 8 * (e / 2);
          bool ok = true;
          if (a.causal) ok = ok && qpos >= kpos;
          if (a.window > 0) ok = ok && qpos - kpos < a.window;
          float x = ok ? s[n][e] * a.scale : NEG_INF;
          if (kpos >= S) x = -INFINITY;
          s[n][e] = x;
        }
      }
      float corr[2];
      amma::softmax_step<BKV / 8>(s, m, l, corr);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        if (n * 8 < hd) {
          o[n][0] *= corr[0];
          o[n][1] *= corr[0];
          o[n][2] *= corr[1];
          o[n][3] *= corr[1];
        }
      }
#pragma unroll
      for (int kp = 0; kp < BKV / 16; ++kp) {
        uint32_t phi[4], plo[4];
        amma::weights_a(s[2 * kp], s[2 * kp + 1], phi, plo);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          if (np * 16 < hd) {
            uint32_t vf[4];
            amma::ldsm_x4_t(vf, Vt + (kp * 16 + arow) * LD + np * 16 + acol);
            amma::mma(o[2 * np], phi, vf[0], vf[1]);
            amma::mma(o[2 * np], plo, vf[0], vf[1]);
            amma::mma(o[2 * np + 1], phi, vf[2], vf[3]);
            amma::mma(o[2 * np + 1], plo, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  amma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + 8 * r;
    const float lf = fmaxf(amma::quad_sum(l[r]), 1e-30f);
    if (qpos < S) {
      bf16* orow = (bf16*)a.out + ((size_t)(b * a.H + h) * S + qpos) * hd;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        if (n * 8 < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
              __floats2bfloat162_rn(o[n][2 * r] / lf, o[n][2 * r + 1] / lf);
      }
      if (t == 0) a.lse[(size_t)(b * a.H + h) * S + qpos] = m[r] + logf(lf);
    }
  }
}

template <int HD>
static int launch_mma(const FlashArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tc<HD>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.H, (a.S + TC_BQ - 1) / TC_BQ);
  flash_fwd_mma<HD><<<grid, 32 * TC_WARPS, Tc<HD>::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// entry point

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

// body: 0 the CUDA-core body, 1 the tensor-core body (bf16, hd % 8 == 0).
extern "C" int flash_fwd_launch(int dtype, int body, const void* q, const void* k,
                                const void* v, void* out, float* lse, int B, int H, int Hkv,
                                int S, int hd, int causal, int window, float scale,
                                void* stream) {
  if (hd <= 0 || hd > TPR * MAXJ || Hkv <= 0 || H % Hkv != 0 || S <= 0 || B <= 0 ||
      (body == 1 && (dtype != 1 || hd % 8 != 0)) || body < 0 || body > 1)
    return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, out, lse, H, Hkv, S, hd, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    if (hd <= 64) return launch_mma<64>(a, B, s);
    if (hd <= 128) return launch_mma<128>(a, B, s);
    return launch_mma<256>(a, B, s);
  }
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, s);
  return launch<float>(a, B, s);
}
