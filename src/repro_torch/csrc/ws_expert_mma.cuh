// The expert tiles of csrc/ws_expert.cu (forward) and csrc/ws_expert_grad.cu
// (backward) on Hopper's tensor cores, one CTA a program.
//
// Replaces the tile bodies `_expert_execute` and `_expert_grad_execute` of
// repro/moe_ws/expert_kernel.py.  What they compute is unchanged; each
// kernel's header says what.  ws_unified.cu runs its expert tiles as two
// of its own weight products instead.
//
// What bounds a tile: bytes.  bt = 8 rows of one expert (1-2 live at
// decode) read its 3 d f weights: 88 MB at kimi-k2's d 7168, f 2048, on one
// SM, so the SM must keep ~100 KB of loads in flight.  Each warp streams
// its own strips of the weights through its own 2- to 4-stage cp.async
// ring in shared memory (commit_group / wait_group and __syncwarp: no
// barrier of the CTA inside a product, where one barrier a stage left the
// whole CTA waiting on its slowest load) and multiplies them on mma.sync.m16n8k16
// (bf16 in, fp32 accumulate): the weights are the M x K operand (ldmatrix,
// .trans where they are stored K-major), the tile's 8 rows are N = 8.
//  * K-major weights W[k][m] (xt wg, xt wu, h wd): a strip is 64 columns
//    (4 m-tiles), a stage ks rows of it (128 bytes each).
//  * M-major weights W[m][k] (ct wd^T, du wg^T + dv wu^T): a strip is 32
//    rows (2 m-tiles), a stage ks k of each row.
// Stage rows are XOR-swizzled by 16-byte piece, so ldmatrix is
// conflict-free without padding.  Activations from device memory (x, ct)
// stream through the ring in the same stages as their weights; those in
// shared memory (h, du, dv) are read there.  The forward streams wg and wu
// together (one x for both).  Every output element is summed inside one
// warp over the whole of K in a fixed order, the tensor cores' sums added
// into an fp32 total every FLUSH_K.
//
// fp32 activations in three bf16 parts.  x = hi + mid + lo with hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) leaves |x - hi - mid
// - lo| <= 2^-27 |x|; each part is its own product on the same weight
// fragments, hi summed apart from mid + lo.  Two parts (the softmax trick of attn_mma.cuh) miss the 1e-5
// the kernels' card tests hold them to: the forward by ~1e-5, dgate (a sum
// of f products of O(1)) by 4-7e-5 (tests/test_torch_expert_redesign.py
// models both).  The float-weight instantiation takes the same products
// with fp32 FMAs on CUDA cores (`fma_cols`, `fma_rows`).
//
// One CTA a program.  Splitting a program over a thread-block cluster,
// whose CTAs exchange the hidden tile through distributed shared memory,
// needs something that orders those writes before a peer reads them.  The
// cluster barrier does it by the arrive's release semantics, which compile
// to MEMBAR.ALL.GPU (the relaxed arrive leaves none but orders nothing;
// csrc/probes/cluster_barrier.cu, built by chip_smoke.py's audit), and the
// fence audit forbids that.  Writes into a peer's shared memory that
// complete on the peer's mbarrier (st.async with complete_tx), waited on
// locally, leave no forbidden SASS in that probe, but the peers may signal
// an mbarrier only after fence.mbarrier_init makes its initialisation
// visible, and the PTX audit forbids fence.  No tile uses them yet.
//
// Only cp.async with its own waits, ldmatrix, mma.sync and shuffles (the
// blocks of attn_mma.cuh): no atomic, no fence.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace xmma {

constexpr int NT = 256;                // threads a CTA
constexpr int NW = NT / 32;            // warps
constexpr int RB = 8;                  // rows a pass over the weights: the mma's N
constexpr int NP = 3;                  // bf16 parts of an fp32 activation
constexpr int RING_W_MAX = 20480;      // bytes of a warp's ring, where they fit
constexpr int FLUSH_K = 256;           // k summed on the tensor cores before an fp32 add
constexpr int HDR = 1024;              // bytes: tokens, gates, per-warp dgate sums
constexpr int SMEM_LIMIT = 232448;     // a CTA's shared memory on the H100
constexpr int STATIC_SMEM = 256;       // kept for the kernels' static shared memory

typedef __nv_bfloat16 bf16;

// Row stride (floats) of the [RB, f] fp32 tiles in shared memory: 8 mod 32
// words, so a half-warp's 8-byte reads of 4 rows are conflict-free.
__host__ __device__ inline int ld_tile(int f) { return f + 8; }

// ---------------------------------------------------------------------------
// Products on the tensor cores.  K-major (TRANS): D_w[m][n] = sum_k W_w[k][m]
// B[n][k] for NWM matrices W_w [K, ldw] (bf16) over one B, both matrices'
// slabs in each stage.  M-major: D[m][n] = sum_w sum_k W_w[m][k] B_w[n][k]
// over nseg segments W_w [M, ldw] taken one after the other, each with its
// own B.  B rows: device memory rows stok[n] of bsrc_w (BG: streamed
// through the ring with the weights), else shared memory rows n of bsrc_w;
// stride ldb.  Each warp takes strips of MT m-tiles of the outputs round
// robin and streams their weights through its NST-stage ring of KS-k
// stages (wring).  For each output element: epi(m, n, D_0[, D_1]).  M and K
// are multiples of 16.  Warp-level: no barrier of the CTA; the ring is
// drained when it returns.

// Bytes of a stage of ks k: the weights (K-major NWM slabs of ks rows of 64
// columns, or M-major 16 MT rows of ks), then with BG the rows' B [RB, ks]
// fp32.
template <bool TRANS, bool BG, int NWM, int MT>
__host__ __device__ constexpr int stage_bytes(int ks) {
  return (TRANS ? NWM * ks * 128 : 16 * MT * 2 * ks) + (BG ? RB * ks * 4 : 0);
}

// (x0, x1) -> NP bf16 pairs: hi, mid, lo (the last part needs no remainder).
__device__ __forceinline__ void split_parts(float x0, float x1, uint32_t (&p)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    p[i] = amma::bits(h);
    if (i + 1 < NP) {
      const float2 hf = __bfloat1622float2(h);
      x0 -= hf.x;
      x1 -= hf.y;
    }
  }
}

template <bool TRANS, bool BG, int NWM, int MT, int KS, int NST, class Epi>
__device__ void warp_mma(const bf16* W0, const bf16* W1, int nseg, int ldw, int M, int K,
                         const float* bsrc0, const float* bsrc1, int ldb, const int* stok,
                         char* wring, const Epi& epi) {
  static_assert(!TRANS || MT == 4, "a K-major strip is 64 columns: rows of 128 bytes");
  static_assert(TRANS || NWM == 1, "M-major products take their matrices as segments");
  constexpr int US = 16 * MT;              // outputs a strip
  constexpr int NB = KS / 16;              // k16 blocks a stage
  constexpr int SB = stage_bytes<TRANS, BG, NWM, MT>(KS);
  constexpr int WS = stage_bytes<TRANS, false, 1, MT>(KS);  // a weight slab of a stage
  constexpr int WB = NWM * WS;             // the weights of a stage
  constexpr int XC = KS / 4;               // 16-byte chunks of a B row of a stage
  constexpr int CPR = TRANS ? 8 : KS / 8;  // 16-byte pieces a stage row
  constexpr int LC = CPR == 8 ? 3 : CPR == 4 ? 2 : 1;  // log2(CPR)
  constexpr int SWZ = 3 - LC;              // rows sharing a 128-byte line: log2(8 / CPR)
  constexpr int RPI = 32 / CPR;            // stage rows a warp-wide copy covers
  constexpr int NCP = TRANS ? KS / RPI : US / RPI;  // copies a lane a slab
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nks = (K + KS - 1) / KS;
  const int nunit = (M + US - 1) / US;
  const int total = (warp < nunit ? (nunit - warp + NW - 1) / NW : 0) * nseg * nks;
  // A stage row r's piece q sits at r CPR 16 + ((q ^ ((r >> SWZ) & (CPR - 1))) 16):
  // lane copies rows lane / CPR + RPI i, piece lane % CPR
  const int cq = lane & (CPR - 1), cr = lane >> LC;
  int cdst[NCP];
#pragma unroll
  for (int i = 0; i < NCP; ++i) {
    const int r = cr + RPI * i;
    cdst[i] = r * CPR * 16 + ((cq ^ ((r >> SWZ) & (CPR - 1))) << 4);
  }
  // ldmatrix rows of this lane: K-major row 16b + (lane & 7) + 8 (lane >> 4)
  // at piece 2j + ((lane >> 3) & 1); M-major row 16j + (lane & 7) + 8
  // ((lane >> 3) & 1) at piece 2b + (lane >> 4)
  int adst[TRANS ? MT : NB];
  {
    const int lr = (lane & 7) + (TRANS ? (lane >> 4) << 3 : ((lane >> 3) & 1) << 3);
#pragma unroll
    for (int i = 0; i < (TRANS ? MT : NB); ++i) {
      const int q = TRANS ? 2 * i + ((lane >> 3) & 1) : 2 * i + (lane >> 4);
      adst[i] = lr * CPR * 16 + ((q ^ ((lr >> SWZ) & (CPR - 1))) << 4);
    }
  }
  // B rows of a stage (BG): row r's chunk c at r XC + (c ^ sw(r)), sw(r) = 2r
  // mod XC, so a half-warp's 8-byte reads of 4 rows are conflict-free
  auto xsw = [](int r) { return (2 * r) & (XC - 1); };
  // the issue and compute positions: strip u (this warp's), segment, k block
  int iu = 0, iseg = 0, ikq = 0;
  auto issue = [&](int slot) {
    if (iu * NW + warp < nunit) {
      const int m0 = (warp + iu * NW) * US, mc = min(US, M - m0), k0 = ikq * KS;
      const int kk = min(KS, K - k0);
      char* st = wring + slot * SB;
#pragma unroll
      for (int w = 0; w < NWM; ++w) {
        const bf16* W = (w || iseg) ? W1 : W0;
#pragma unroll
        for (int i = 0; i < NCP; ++i) {
          const int r = cr + RPI * i;
          if constexpr (TRANS) {
            if (r < kk && 8 * cq < mc)
              amma::cp_async16(st + w * WS + cdst[i],
                               W + (long long)(k0 + r) * ldw + m0 + 8 * cq, true);
          } else {
            if (r < mc && 8 * cq < kk)
              amma::cp_async16(st + cdst[i], W + (long long)(m0 + r) * ldw + k0 + 8 * cq, true);
          }
        }
      }
      if constexpr (BG) {
        float* sx = reinterpret_cast<float*>(st + WB);
        const float* b = iseg ? bsrc1 : bsrc0;
        for (int i = lane; i < RB * XC; i += 32) {
          const int r = i / XC, c = i % XC;
          if (4 * c < kk)
            amma::cp_async16(sx + r * KS + 4 * (c ^ xsw(r)),
                             b + (long long)stok[r] * ldb + k0 + 4 * c, true);
        }
      }
      if (++ikq == nks) {
        ikq = 0;
        if (++iseg == nseg) iseg = 0, ++iu;
      }
    }
    amma::cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  // the hi part of B sums on its own and the mid and lo parts together: the
  // tensor cores' fp32 sums drop the low bits of a small addend to a large
  // sum (dgate moved by ~1e-5 with one sum for all three)
  float acc[NWM][MT][2][4], tot[NWM][MT][4];
#pragma unroll
  for (int w = 0; w < NWM; ++w)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[w][j][0][i] = acc[w][j][1][i] = tot[w][j][i] = 0.f;
#pragma unroll
  for (int q = 0; q < NST - 1; ++q) issue(q);
  int u = 0, seg = 0, kq = 0, slot = 0;
  for (int s = 0; s < total; ++s) {
    amma::cp_async_wait<NST - 2>();
    __syncwarp();  // stage s landed for every lane; stage s - 1 is read
    issue(slot == 0 ? NST - 1 : slot - 1);
    const int m0 = (warp + u * NW) * US, mc = min(US, M - m0), kk = min(KS, K - kq * KS);
    const char* st = wring + slot * SB;
    // this lane's B row: row g at k0 + 16 b + 2t + {0, 1, 8, 9}
    const float* br = (seg ? bsrc1 : bsrc0) + g * ldb + kq * KS + 2 * t;
    const float* sx = reinterpret_cast<const float*>(st + WB) + g * KS + 2 * (t & 1);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (16 * b < kk) {
        float2 v0, v1;
        if constexpr (BG) {
          const int c = 4 * b + (t >> 1);  // k 16b + 2t in chunk c, 16b + 2t + 8 in c + 2
          v0 = *reinterpret_cast<const float2*>(sx + 4 * (c ^ xsw(g)));
          v1 = *reinterpret_cast<const float2*>(sx + 4 * ((c + 2) ^ xsw(g)));
        } else {
          v0 = *reinterpret_cast<const float2*>(br + 16 * b);
          v1 = *reinterpret_cast<const float2*>(br + 16 * b + 8);
        }
        uint32_t p0[NP], p1[NP];
        split_parts(v0.x, v0.y, p0);
        split_parts(v1.x, v1.y, p1);
        uint32_t a[NWM][MT][4];
#pragma unroll
        for (int w = 0; w < NWM; ++w)
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            if (16 * j < mc) {
              if constexpr (TRANS) {
                amma::ldsm_x4_t(a[w][j], st + w * WS + 16 * b * 128 + adst[j]);
              } else {
                amma::ldsm_x4(a[w][j], st + 16 * j * CPR * 16 + adst[b]);
              }
            }
          }
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int w = 0; w < NWM; ++w)
#pragma unroll
            for (int j = 0; j < MT; ++j)
              if (16 * j < mc) amma::mma(acc[w][j][p ? 1 : 0], a[w][j], p0[p], p1[p]);
      }
    }
    const bool last = kq == nks - 1 && seg == nseg - 1;
    if (last || (kq * KS + KS) % FLUSH_K == 0) {
#pragma unroll
      for (int w = 0; w < NWM; ++w)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            tot[w][j][i] += acc[w][j][0][i] + acc[w][j][1][i];
            acc[w][j][0][i] = acc[w][j][1][i] = 0.f;
          }
    }
    if (last) {  // the strip's sums are whole
#pragma unroll
      for (int j = 0; j < MT; ++j)
        if (16 * j < mc) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = m0 + 16 * j + g + 8 * (i >> 1), n = 2 * t + (i & 1);
            if constexpr (NWM == 2) {
              epi(m, n, tot[0][j][i], tot[1][j][i]);
            } else {
              epi(m, n, tot[0][j][i]);
            }
#pragma unroll
            for (int w = 0; w < NWM; ++w) tot[w][j][i] = 0.f;
          }
        }
    }
    if (++kq == nks) {
      kq = 0;
      if (++seg == nseg) seg = 0, ++u;
    }
    slot = slot + 1 == NST ? 0 : slot + 1;
  }
  amma::cp_async_wait<0>();
  __syncwarp();
}

// The products' shapes: (K-major?, B from device memory?, matrices a stage,
// m-tiles a strip), then a (KS, stages) ring.  The backward's products name
// a second, shallower ring, taken where a warp's ring cannot hold the
// first: the backward's two [8, f] tiles leave kimi-k2's f 2048 12,448
// bytes a warp.  The forward's one tile leaves every f up to 2608 the
// first.
#define XMMA_UV true, true, 2, 4, 16, 4             // xt wg and xt wu (forward)
#define XMMA_HWD true, false, 1, 4, 32, 4           // h wd
#define XMMA_UV_B true, true, 2, 4, 16, 3, 16, 2    // xt wg and xt wu (backward)
#define XMMA_CT false, true, 1, 4, 32, 3, 16, 4     // ct wd^T
#define XMMA_DX false, false, 1, 2, 64, 4, 32, 4    // du wg^T + dv wu^T

// The smallest ring a warp needs: the forward's rings, the backward's
// second rings.
constexpr int MIN_RING_FWD = 4 * stage_bytes<true, true, 2, 4>(16);
constexpr int MIN_RING_BWD = 4 * stage_bytes<false, true, 1, 4>(16);

// Dynamic shared memory of a tile: the header, the [RB, f] tiles (forward:
// h; backward: t then du, and dv) and a ring a warp of up to RING_W_MAX
// bytes (*ring_w), beside STATIC_SMEM (the scheduler's 48-byte hand-off).
// 0 when a warp's ring cannot hold MIN_RING_FWD or MIN_RING_BWD.
__host__ __device__ inline int tile_smem(int f, bool grad, int* ring_w) {
  const int fixed = HDR + (grad ? 2 : 1) * RB * ld_tile(f) * 4;
  int r = (SMEM_LIMIT - STATIC_SMEM - fixed) / NW;
  r = (r < RING_W_MAX ? r : RING_W_MAX) & ~15;
  *ring_w = r;
  return r >= (grad ? MIN_RING_BWD : MIN_RING_FWD) ? fixed + NW * r : 0;
}

// ---------------------------------------------------------------------------
// fp32 weights on CUDA cores, the same products and epilogues; B(n, k) of
// the rows is bval(n, k) (bval(w, n, k) for M-major weights' segment w).
// K-major: a thread per 4 columns; M-major: a warp per row, lanes over k,
// the 8 row sums reduced across the warp.

template <int NWM, class BV, class Epi>
__device__ void fma_cols(const float* W0, const float* W1, int ldw, int M, int K, const BV& bval,
                         const Epi& epi) {
  for (int m = 4 * threadIdx.x; m < M; m += 4 * NT) {
    float acc[NWM][RB][4];
#pragma unroll
    for (int w = 0; w < NWM; ++w)
#pragma unroll
      for (int n = 0; n < RB; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[w][n][c] = 0.f;
    for (int k = 0; k < K; ++k) {
      float4 wv[NWM];
#pragma unroll
      for (int w = 0; w < NWM; ++w)
        wv[w] = __ldg(reinterpret_cast<const float4*>((w ? W1 : W0) + (long long)k * ldw + m));
#pragma unroll
      for (int n = 0; n < RB; ++n) {
        const float bv = bval(n, k);
#pragma unroll
        for (int w = 0; w < NWM; ++w) {
          acc[w][n][0] = fmaf(wv[w].x, bv, acc[w][n][0]);
          acc[w][n][1] = fmaf(wv[w].y, bv, acc[w][n][1]);
          acc[w][n][2] = fmaf(wv[w].z, bv, acc[w][n][2]);
          acc[w][n][3] = fmaf(wv[w].w, bv, acc[w][n][3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < RB; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (NWM == 2) {
          epi(m + c, n, acc[0][n][c], acc[1][n][c]);
        } else {
          epi(m + c, n, acc[0][n][c]);
        }
      }
  }
}

template <class BV, class Epi>
__device__ void fma_rows(const float* W0, const float* W1, int nseg, int ldw, int M, int K,
                         const BV& bval, const Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < M; m += NW) {
    float acc[RB];
#pragma unroll
    for (int n = 0; n < RB; ++n) acc[n] = 0.f;
    for (int w = 0; w < nseg; ++w)
      for (int k = 4 * lane; k < K; k += 128) {
        const float4 wv =
            __ldg(reinterpret_cast<const float4*>((w ? W1 : W0) + (long long)m * ldw + k));
#pragma unroll
        for (int n = 0; n < RB; ++n) {
          acc[n] = fmaf(wv.x, bval(w, n, k), acc[n]);
          acc[n] = fmaf(wv.y, bval(w, n, k + 1), acc[n]);
          acc[n] = fmaf(wv.z, bval(w, n, k + 2), acc[n]);
          acc[n] = fmaf(wv.w, bval(w, n, k + 3), acc[n]);
        }
      }
#pragma unroll
    for (int n = 0; n < RB; ++n)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], o);
    float v = acc[0];
#pragma unroll
    for (int n = 1; n < RB; ++n) v = lane == n ? acc[n] : v;
    if (lane < RB) epi(m, lane, v);
  }
}

// The tiles' products whichever the weights' type: K-major (TRANS) or
// M-major over nseg segments, the rows' B in device memory (BG: rows stok[n]
// of b_w, stride ld) or shared memory (rows n of b_w, stride ld).  A
// product that names no second ring runs its first.
template <bool TRANS, bool BG, int NWM, int MT, int KS1, int NST1, int KS2 = KS1,
          int NST2 = NST1, typename T, class Epi>
__device__ __forceinline__ void product(const T* W0, const T* W1, int nseg, int ldw, int M, int K,
                                        const float* b0, const float* b1, int ld,
                                        const int* stok, char* ring, int ring_w, const Epi& epi) {
  if constexpr (sizeof(T) == 2) {
    char* wring = ring + (threadIdx.x >> 5) * ring_w;
    constexpr bool one_ring = KS1 == KS2 && NST1 == NST2;
    if (one_ring || NST1 * stage_bytes<TRANS, BG, NWM, MT>(KS1) <= ring_w) {
      warp_mma<TRANS, BG, NWM, MT, KS1, NST1>(W0, W1, nseg, ldw, M, K, b0, b1, ld, stok, wring,
                                              epi);
    } else {
      warp_mma<TRANS, BG, NWM, MT, KS2, NST2>(W0, W1, nseg, ldw, M, K, b0, b1, ld, stok, wring,
                                              epi);
    }
  } else if constexpr (TRANS) {
    fma_cols<NWM>(W0, W1, ldw, M, K, [&](int n, int k) {
      return BG ? __ldg(b0 + (long long)stok[n] * ld + k) : b0[n * ld + k];
    }, epi);
  } else {
    fma_rows(W0, W1, nseg, ldw, M, K, [&](int w, int n, int k) {
      const float* b = w ? b1 : b0;
      return BG ? __ldg(b + (long long)stok[n] * ld + k) : b[n * ld + k];
    }, epi);
  }
}

// Write one element: a plain store in free mode, an accumulation in lockstep.
__device__ __forceinline__ void emit(float* o, float v, bool store) {
  if (store) {
    *o = v;
  } else {
    *o += v;
  }
}

// ---------------------------------------------------------------------------
// forward tile: rows [0, rows) at tok / out of one expert's wg, wu [d, f],
// wd [f, d]:  h = silu(xt wg) * (xt wu) (wg and wu streamed together; h
// kept in shared memory), y = h wd; rows at or past `live` are zero.  All
// threads; ends with __syncthreads().

template <typename T>
__device__ void forward_tile(const float* x, const int* tok, const T* wg, const T* wu,
                             const T* wd, float* out, int d, int f, int rows, int live,
                             bool store, char* smem, int ring_w) {
  int* stok = reinterpret_cast<int*>(smem);
  const int ldh = ld_tile(f);
  float* sH = reinterpret_cast<float*>(smem + HDR);  // [RB, ldh] h
  char* ring = smem + HDR + RB * ldh * 4;
  const int tid = threadIdx.x;
  for (int r0 = 0; r0 < rows; r0 += RB) {
    const int nr = min(RB, rows - r0);
    // rows past the tile read its first row's token: finite, never written
    if (tid < RB) stok[tid] = tok[tid < nr ? r0 + tid : 0];
    __syncthreads();
    product<XMMA_UV>(wg, wu, 1, f, f, d, x, x, d, stok, ring, ring_w,
                     [&](int m, int n, float u, float v) {
                       sH[n * ldh + m] = u / (1.f + expf(-u)) * v;
                     });
    __syncthreads();
    product<XMMA_HWD>(wd, wd, 1, d, d, f, sH, sH, ldh, stok, ring, ring_w,
                         [&](int m, int n, float y) {
                           if (n < nr)
                             emit(out + (long long)(r0 + n) * d + m, r0 + n < live ? y : 0.f, store);
                         });
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// backward tile: rows [0, rows) of one expert, row n's block of W = d + 3 f
// + 1 columns at out + n W:  [dx | du | dv | h | dgate].  x, gy [T, d]; gr
// the rows' gates.  All threads; ends with __syncthreads().
//   1. t = ct wd^T                      (wd read once)
//   2. u = xt wg and v = xt wu; s, h; dh = gr t, dv = dh s,
//      du = dh v dsilu; dgate = sum_j h t (= sum_c ct (h wd), reordered: no
//      second wd read), summed in fp64
//   3. dx = du wg^T + dv wu^T           (wg and wu read a second time)
// So a tile reads 5 d f weights (the first version read 6).

template <typename T>
__device__ void backward_tile(const float* x, const float* gy, const int* tok, const float* gr,
                              const T* wg, const T* wu, const T* wd, float* out, int d, int f,
                              int rows, int live, bool store, char* smem, int ring_w) {
  const long long W = (long long)d + 3 * f + 1;
  int* stok = reinterpret_cast<int*>(smem);
  float* sgr = reinterpret_cast<float*>(smem + 32);
  double* sred = reinterpret_cast<double*>(smem + 64);  // [NW, RB] dgate sums
  const int ldh = ld_tile(f);
  float* sT = reinterpret_cast<float*>(smem + HDR);     // [RB, ldh] t, then du
  float* sV = sT + RB * ldh;                            // [RB, ldh] dv
  char* ring = reinterpret_cast<char*>(sV + RB * ldh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r0 = 0; r0 < rows; r0 += RB) {
    const int nr = min(RB, rows - r0);
    float* orow = out + (long long)r0 * W;
    if (tid < RB) {
      stok[tid] = tok[tid < nr ? r0 + tid : 0];
      sgr[tid] = tid < nr ? gr[r0 + tid] : 0.f;
    }
    __syncthreads();
    // 1. t[n, j] = sum_c ct[n, c] wd[j, c]
    product<XMMA_CT>(wd, wd, 1, d, f, d, gy, gy, d, stok, ring, ring_w,
                         [&](int m, int n, float tt) { sT[n * ldh + m] = tt; });
    __syncthreads();
    // 2. u and v (wg and wu streamed together) and the elementwise VJP
    double pdg[RB];  // this thread's dgate sums by row
#pragma unroll
    for (int n = 0; n < RB; ++n) pdg[n] = 0.0;
    product<XMMA_UV_B>(wg, wu, 1, f, f, d, x, x, d, stok, ring, ring_w,
                       [&](int m, int n, float u, float v) {
      const float tt = sT[n * ldh + m];
      const float sig = 1.f / (1.f + expf(-u));
      const float s = u * sig;
      const float h = s * v;
      const float dh = sgr[n] * tt;
      const float dv = dh * s;
      const float du = dh * v * (sig * (1.f + u * (1.f - sig)));
      sT[n * ldh + m] = du;
      sV[n * ldh + m] = dv;
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (q == n) pdg[q] = fma((double)h, (double)tt, pdg[q]);
      if (n < nr) {
        const bool ok = r0 + n < live;
        float* o = orow + n * W + d + m;
        emit(o, ok ? du : 0.f, store);
        emit(o + f, ok ? dv : 0.f, store);
        emit(o + 2 * f, ok ? h : 0.f, store);
      }
    });
    // dgate: each warp's sums over its lanes, then the warps in order
#pragma unroll
    for (int n = 0; n < RB; ++n) {
      double v = pdg[n];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) sred[warp * RB + n] = v;
    }
    __syncthreads();
    if (tid < nr) {
      double s = 0.0;
      for (int w = 0; w < NW; ++w) s += sred[w * RB + tid];
      emit(orow + tid * W + d + 3 * f, r0 + tid < live ? (float)s : 0.f, store);
    }
    // 3. dx[n, c] = sum_j du[n, j] wg[c, j] + dv[n, j] wu[c, j]
    product<XMMA_DX>(wg, wu, 2, f, d, f, sT, sV, ldh, stok, ring, ring_w,
                          [&](int m, int n, float v) {
                            if (n < nr) emit(orow + n * W + m, r0 + n < live ? v : 0.f, store);
                          });
    __syncthreads();
  }
}

}  // namespace xmma
