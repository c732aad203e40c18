// The unified engine step on Hopper (sm_90a): one fence-free work-stealing
// launch that runs a whole decode step (and optionally one folded prompt's
// prefill) of a GQA decoder, dense or MoE, in fp32.
//
// Replaces the TPU kernel of repro/models/unified.py: the `execute` closure
// of `decode_step_unified` (launched through `launch_ws_grid`, whose
// `pallas_call` is repro/pallas_ws/kernel.py:805).  The scheduler and its
// walks are ws_sched.cuh with the stage gate; the attention tile is
// ws_attn_tile.cuh and the expert tile ws_expert_tile.cuh.
//
// What it computes.  Each claimed record dispatches on F_OP:
//  * OP_DECODE_TILE: one (b, h) query row against the layer's KV cache, read
//    in place from [L, B, cap, Hkv, hd] through strides (bq 1, bk_d, not
//    causal), into att[l] [B, H, hd];
//  * OP_FLASH_TILE: a causal (h, q-block) tile of the folded prompt against
//    its k/v rows in kp/vp [L, 1, cap, Hkv, hd], into attp[l];
//  * OP_EXPERT_TILE (layer, seg, j): pool tile j of a segment (decode batch
//    or prompt) of layer l, with expert e[j] and rl[j] live rows from the
//    routing buffers GLUE_POST wrote: rows [j bt, j bt + rl) of xf gathered
//    through tok, the expert's SwiGLU, into yr[l].  A tile with rl == 0
//    returns at once (the reference's computes expert 0 and adds zeros);
//  * OP_STEP_GLUE, by phase:
//      GLUE_EMBED   embedding rows -> h[0] [R, d] (R = B decode rows, then
//                   the prompt's Lp rows);
//      GLUE_PRE     rms_norm(h[l % 2]); q, k, v against wq, wk, wv; RoPE at
//                   each row's position; the new k/v row of every slot
//                   spliced into kc/vc[l], the prompt's into kp/vp[l]; q into
//                   qd (decode) and qp [H, Lp_pad, hd] (prompt);
//      GLUE_POST    the attention rows divided by their tiles' mult (lockstep
//                   only: free-mode tiles store whole tiles), wo, residual,
//                   rms_norm; then the SwiGLU MLP and residual -> h[(l + 1)
//                   % 2] (dense), or (MoE) the residual kept in sh2, the
//                   norm in xf, the router (softmax, top-k with equal
//                   probabilities taken lower expert first, gates over
//                   max(sum, 1e-9)) and the shared-pool Put of each segment;
//      GLUE_COMB    (MoE) per (token, column) the gather of its k routed rows
//                   (divided by their tiles' mult in lockstep) weighted by
//                   their gates, in ascending row order, plus the shared
//                   experts, onto sh2 -> h[(l + 1) % 2];
//      GLUE_LOGITS  final rms_norm of the decode rows and the prompt's last
//                   row, unembed -> logits [B + 1, Vp], pad vocab -1e30.
// Every product is computed here by hand (fp32 FMAs on CUDA cores); no
// library call is made.
//
// Lockstep (mode 0) is one launch of one CTA walking the (rounds, P) grid
// with the stage gate: the whole engine step.  Free mode (mode 1) runs P
// CTAs over one stage's queues; the wrapper launches once per stage, since
// free CTAs have no rounds to gate by and a device-side wait would need
// acquire/release ordering.  Several CTAs can then run one glue task at once,
// so no glue phase updates a buffer in place: each reads what earlier stages
// wrote (the residual stream ping-pongs between h[0] and h[1]) and writes
// buffers that only this phase writes, with a single content each, so a
// duplicate writes the bits the first execution wrote.
//
// No atomics and no fences: reductions are warp shuffles and shared-memory
// sums, ordering inside the CTA is __syncthreads(), ordering between stages
// is the rounds (lockstep) or the kernel boundaries (free).  The Put is a
// counting sort in one CTA: per-expert counts and ranks by owner threads,
// a prefix sum in shared memory, every output written by one thread; the
// combine gathers through the Put's inverse instead of scattering.
//
// What bounds it on this card.  A decode step reads every weight once
// (11.28 GB of layer weights and 1.58 GB of unembedding for llama3.2-3b in
// fp32) plus the live K/V rows: bytes.  In lockstep all of it streams
// through ONE SM, so the step is bound by what one SM can pull, far below
// the card's 3.35 TB/s.  The products are GEMVs over 16-byte weight loads
// with many in flight per thread; a folded prompt is a GEMM of 8 rows per
// weight read, near one SM's fp32 FMA rate.  A MoE step reads the weights
// of the experts its tokens chose once per tile (kimi-k2: 176 MB an expert
// in fp32), the same way.  Spreading glue work over the card is later work.

#include <cuda_runtime.h>

#include "ws_attn_tile.cuh"
#include "ws_expert_tile.cuh"

#define OP_FLASH_TILE 0
#define OP_DECODE_TILE 1
#define OP_EXPERT_TILE 2
#define OP_STEP_GLUE 3
#define F_PHASE 1
#define F_LAYER 2
#define F_E 1   // an expert tile's layer
#define F_RS 2  // its segment
#define F_RL 3  // its pool tile
#define GLUE_EMBED 0
#define GLUE_PRE 1
#define GLUE_POST 2
#define GLUE_COMB 3
#define GLUE_LOGITS 4
#define UTHREADS 512
#define EXPERT_RB 8   // expert rows a pass
#define EXPERT_CPT 4  // expert columns a thread (one 16-byte fp32 load)

struct UArgs {
  // inputs
  const int* tok;           // [B]
  const int* pos;           // [B] position of each slot's new token
  const int* ptok;          // [Lp] folded prompt (null when Lp == 0)
  const float* embed;       // [V, d]
  const float* final_norm;  // [d]
  const float* unembed;     // [d, Vp]
  const float* attn_norm;   // [L, d]
  const float* wq;          // [L, d, H * hd]
  const float* wk;          // [L, d, Hkv * hd]
  const float* wv;          // [L, d, Hkv * hd]
  const float* wo;          // [L, H * hd, d]
  const float* mlp_norm;    // [L, d]
  const float* wg;          // [L, d, f]: the dense MLP, or the shared experts
  const float* wu;          // [L, d, f]  (null on a MoE model without them)
  const float* wd;          // [L, f, d]
  const float* router;      // [L, d, E] (MoE; null on a dense model)
  const float* we_g;        // [L, E, d, fe]
  const float* we_u;        // [L, E, d, fe]
  const float* we_d;        // [L, E, fe, d]
  // outputs
  float* kc;                // [L, B, cap, Hkv, hd] (updated in place)
  float* vc;
  float* kp;                // [L, 1, cap, Hkv, hd]
  float* vp;
  float* h;                 // [2, R, d] residual stream, ping-pong
  float* qd;                // [B, H, hd]
  float* qp;                // [H, Lp_pad, hd]
  float* att;               // [L, B, H, hd]
  float* attp;              // [L, H, Lp_pad, hd]
  float* logits;            // [B + 1, Vp]: the decode rows, then the prompt's
  // MoE routing, each the decode segment's then the prompt's
  float* xf;                // [R, d] the MoE input
  int* rtok;                // [n_rows] segment-local token of each pool row
  float* gate;              // [n_rows]
  int* e;                   // [pool_dec + pool_pre] expert of each pool tile
  int* rl;                  // [pool_dec + pool_pre] its live rows
  float* yr;                // [L, n_rows, d] the expert tiles' rows
  // scratch, one content each per phase
  float* xn;                // [R, d]
  float* sq;                // [R, H * hd]
  float* sk;                // [R, Hkv * hd]
  float* sv;                // [R, Hkv * hd]
  float* sa;                // [R, d]
  float* sh2;               // [R, d]
  float* sg;                // [R, f]
  float* su;                // [R, f]
  float* shm;               // [R, f]
  float* sm;                // [R, d]
  float* sr;                // [R, E] router logits
  int* sidx;                // [R, k] chosen experts
  float* sgv;               // [R, k] their gates
  int* prow;                // [R, k] pool rows of each token's pairs, ascending
  int B, Lp, L, d, H, Hkv, hd, f, V, Vp, cap;
  int bk_d, bq_p, bk_p, nq_p, Lp_pad, n_flash_l, dec_att_base, pre_att_base;
  int E, k, fe, bt, pool_dec, pool_pre, exp_dec_base, exp_pre_base;  // 0 on a dense model
  float eps, theta, res_scale, scale;
};

// ---------------------------------------------------------------------------
// glue building blocks (all threads; each ends with __syncthreads())

// Y[r, n] = sum_k X[r, k] W[k, n] for r < R, n < N.  W is row-major with
// row stride ldw, its rows 16-byte aligned and N % 4 == 0.  A thread owns 4
// adjacent columns and 1/KS of the k range; the KS partial sums meet in
// shared memory.  X is staged in chunks of KC columns, RB rows at a time,
// so each weight load feeds RB rows; UNROLL loads stay in flight a thread.
template <int RB>
__device__ void gemm(const float* X, int ldx, int R, const float* __restrict__ W, long long ldw,
                     int K, int N, float* Y, int ldy, float* smem) {
  constexpr int KS = RB <= 4 ? 4 : 2;
  constexpr int KC = RB <= 4 ? 1024 : 512;
  constexpr int UNROLL = RB <= 4 ? 8 : 4;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int TW = nt / KS;
  const int c = tid % TW, s = tid / TW;
  float* xs = smem;             // [KC][RB]
  float* red = xs + KC * RB;    // [KS - 1][RB][TW * 4]
  for (int r0 = 0; r0 < R; r0 += RB) {
    const int nr = min(RB, R - r0);
    for (int n0 = 0; n0 < N; n0 += TW * 4) {
      const int n = n0 + c * 4;
      const bool live = n < N;
      float acc[RB][4];
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KC) {
        const int kc = min(KC, K - k0);
        __syncthreads();
        for (int e = tid; e < kc * RB; e += nt) {
          const int i = e / kc, kk = e % kc;
          xs[kk * RB + i] = i < nr ? X[(long long)(r0 + i) * ldx + k0 + kk] : 0.f;
        }
        __syncthreads();
        if (live) {
          const float* wp = W + (long long)k0 * ldw + n;
#pragma unroll UNROLL
          for (int kk = s; kk < kc; kk += KS) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(wp + (long long)kk * ldw));
            const float4* xr = reinterpret_cast<const float4*>(xs + kk * RB);
#pragma unroll
            for (int i4 = 0; i4 < RB / 4; ++i4) {
              const float4 a = xr[i4];
              const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float* o = acc[i4 * 4 + j];
                o[0] = fmaf(av[j], w.x, o[0]);
                o[1] = fmaf(av[j], w.y, o[1]);
                o[2] = fmaf(av[j], w.z, o[2]);
                o[3] = fmaf(av[j], w.w, o[3]);
              }
            }
          }
        }
      }
      if (live && s > 0) {
#pragma unroll
        for (int i = 0; i < RB; ++i)
          *reinterpret_cast<float4*>(red + ((long long)(s - 1) * RB + i) * TW * 4 + c * 4) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();
      if (live && s == 0) {
        for (int t = 1; t < KS; ++t) {
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const float4 p = *reinterpret_cast<const float4*>(
                red + ((long long)(t - 1) * RB + i) * TW * 4 + c * 4);
            acc[i][0] += p.x;
            acc[i][1] += p.y;
            acc[i][2] += p.z;
            acc[i][3] += p.w;
          }
        }
        for (int i = 0; i < nr; ++i) {
          float* y = Y + (long long)(r0 + i) * ldy + n;
          y[0] = acc[i][0];
          y[1] = acc[i][1];
          y[2] = acc[i][2];
          y[3] = acc[i][3];
        }
      }
    }
  }
  __syncthreads();
}

// gemm in row blocks of 4 (decode batches up to 4) or 8.  A 16-row block
// would halve a folded prompt's weight reads, but its 64 accumulators spill
// at the 128 registers a thread of a 512-thread CTA has.
__device__ void gemm_rows(const float* X, int ldx, int R, const float* W, long long ldw, int K,
                          int N, float* Y, int ldy, float* smem) {
  if (R <= 4)
    gemm<4>(X, ldx, R, W, ldw, K, N, Y, ldy, smem);
  else
    gemm<8>(X, ldx, R, W, ldw, K, N, Y, ldy, smem);
}

// Y[r] = X[r] / sqrt(mean(X[r]^2) + eps) * (1 + w), one warp a row.
__device__ void rms_rows(const float* X, float* Y, int n, int d, const float* __restrict__ w,
                         float eps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  for (int r = warp; r < n; r += nw) {
    const float* x = X + (long long)r * d;
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) ss += x[k] * x[k];
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = 1.f / sqrtf(ss / (float)d + eps);
    float* y = Y + (long long)r * d;
    for (int k = lane; k < d; k += 32) y[k] = (x[k] * inv) * (1.f + __ldg(w + k));
  }
  __syncthreads();
}

// y = a + s * b over n elements.
__device__ void axpy(const float* a, const float* b, float s, float* y, long long n) {
  for (long long e = threadIdx.x; e < n; e += blockDim.x) y[e] = a[e] + s * b[e];
  __syncthreads();
}

// RoPE of row r's head vector x [hd] at `pos` into y: the halves rotate as
// pairs (x1, x2) by angle pos / theta^(2i / hd).
__device__ __forceinline__ void rope_pair(const float* x, float* y, int i, int hd, int pos,
                                          float theta) {
  const int half = hd / 2;
  const float fr = 1.f / powf(theta, (float)(2 * i) / (float)hd);
  const float ang = (float)pos * fr;
  const float c = cosf(ang), s = sinf(ang);
  const float x1 = x[i], x2 = x[i + half];
  y[i] = x1 * c - x2 * s;
  y[i + half] = x1 * s + x2 * c;
}

// The layer's SwiGLU of X [R, d] into sm [R, d]: the dense MLP, or a MoE
// layer's shared experts (wg/wu/wd, width f).
__device__ void swiglu_rows(const UArgs& A, int l, const float* X, float* smem) {
  const int R = A.B + A.Lp, d = A.d, f = A.f;
  gemm_rows(X, d, R, A.wg + (long long)l * d * f, f, d, f, A.sg, f, smem);
  gemm_rows(X, d, R, A.wu + (long long)l * d * f, f, d, f, A.su, f, smem);
  for (long long e = threadIdx.x; e < (long long)R * f; e += blockDim.x) {
    const float g = A.sg[e];
    A.shm[e] = g / (1.f + expf(-g)) * A.su[e];
  }
  __syncthreads();
  gemm_rows(A.shm, f, R, A.wd + (long long)l * f * d, d, f, d, A.sm, d, smem);
}

// The router of R rows, one warp a row: softmax of the logits sr[r] in the
// warp's shared slice, then k rounds of an argmax that takes equal
// probabilities lower expert first (the chosen one marked -1), and the
// chosen probabilities over max(sum, 1e-9) -> sidx[r], sgv[r].  sr is only
// read: a duplicate in free mode sees the same logits.
__device__ void route_rows(const UArgs& A, int R, float* smem) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  const int E = A.E, k = A.k;
  float* p = smem + (long long)warp * (E + k);  // [E] probabilities, then [k] chosen
  float* q = p + E;
  for (int r = warp; r < R; r += nw) {
    const float* lg = A.sr + (long long)r * E;
    float m = __int_as_float(0xff800000);  // -inf
    for (int e = lane; e < E; e += 32) m = fmaxf(m, lg[e]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float v = expf(lg[e] - m);
      p[e] = v;
      s += v;
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int e = lane; e < E; e += 32) p[e] = p[e] / s;
    __syncwarp();
    for (int j = 0; j < k; ++j) {
      float best = -1.f;
      int bi = E;
      for (int e = lane; e < E; e += 32) {
        const float v = p[e];
        if (v > best) {  // a lane's experts ascend: ties keep the lower
          best = v;
          bi = e;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      bi = min(bi, E - 1);  // only a NaN row finds nothing above -1
      if (lane == 0) {
        q[j] = best;
        p[bi] = -1.f;
        A.sidx[r * k + j] = bi;
      }
      __syncwarp();
    }
    float tot = 0.f;
    for (int j = 0; j < k; ++j) tot += q[j];
    const float den = fmaxf(tot, 1e-9f);
    for (int j = lane; j < k; j += 32) A.sgv[r * k + j] = q[j] / den;
    __syncwarp();
  }
  __syncthreads();
}

// The shared-pool Put of one segment (tokens [r0, r0 + T) of the step's
// rows, its pool tiles from tile0, its rows from row0): the reference's
// route_to_tasks_pool_jax as a counting sort in one CTA with no atomics.
// Expert e's pairs, in (token, choice) order, fill pool rows [toff[e] bt,
// toff[e] bt + loads[e]) with toff the prefix sum of ceil(loads / bt); pool
// tile j past toff[E] is dead (expert 0, 0 rows; its rows token 0, gate 0).
// Owner threads count and rank their expert's pairs; every output element
// has one writer.
__device__ void pool_put(const UArgs& A, int r0, int T, int pool, int tile0, int row0,
                         float* smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int E = A.E, k = A.k, bt = A.bt, Tk = T * k;
  int* pe = (int*)smem;       // [Tk] expert of each pair
  int* order = pe + Tk;       // [Tk] the pairs grouped by expert
  int* rnk = order + Tk;      // [Tk] a pair's place among its expert's
  int* loads = rnk + Tk;      // [E]
  int* start = loads + E;     // [E] exclusive prefix of loads
  int* toff = start + E;      // [E + 1] exclusive prefix of the tiles
  int* eof = toff + E + 1;    // [pool] expert of each live tile
  const int* sidx = A.sidx + (long long)r0 * k;
  const float* sgv = A.sgv + (long long)r0 * k;
  for (int i = tid; i < Tk; i += nt) pe[i] = sidx[i];
  __syncthreads();
  for (int e = tid; e < E; e += nt) {
    int c = 0;
    for (int i = 0; i < Tk; ++i) c += pe[i] == e;
    loads[e] = c;
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0, t = 0;
    for (int e = 0; e < E; ++e) {
      start[e] = s;
      toff[e] = t;
      s += loads[e];
      t += (loads[e] + bt - 1) / bt;
    }
    toff[E] = t;
  }
  __syncthreads();
  for (int e = tid; e < E; e += nt) {
    int c = 0;
    for (int i = 0; i < Tk; ++i)
      if (pe[i] == e) {
        order[start[e] + c] = i;
        rnk[i] = c++;
      }
    for (int j = toff[e]; j < toff[e + 1]; ++j) eof[j] = e;
  }
  __syncthreads();
  const int live_tiles = toff[E];
  for (int r = tid; r < pool * bt; r += nt) {
    const int j = r / bt;
    const int e = j < live_tiles ? eof[j] : 0;
    const int jr = r - toff[e] * bt;
    const bool live = j < live_tiles && jr < loads[e];
    const int pair = live ? order[start[e] + jr] : 0;
    A.rtok[row0 + r] = live ? pair / k : 0;
    A.gate[row0 + r] = live ? sgv[pair] : 0.f;
  }
  for (int j = tid; j < pool; j += nt) {
    const bool live = j < live_tiles;
    const int e = live ? eof[j] : 0;
    A.e[tile0 + j] = e;
    A.rl[tile0 + j] = live ? min(max(loads[e] - (j - toff[e]) * bt, 0), bt) : 0;
  }
  // the inverse for the combine: each token's k pool rows in ascending
  // order, i.e. its pairs ordered by (expert, choice)
  for (int i = tid; i < Tk; i += nt) {
    const int t = i / k, c = i % k, e = pe[i];
    int pos = 0;
    for (int c2 = 0; c2 < k; ++c2) {
      const int e2 = pe[t * k + c2];
      pos += e2 < e || (e2 == e && c2 < c);
    }
    A.prow[(long long)(r0 + t) * k + pos] = toff[e] * bt + rnk[i];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// glue phases

__device__ void glue_embed(const UArgs& A) {
  const int R = A.B + A.Lp;
  for (long long e = threadIdx.x; e < (long long)R * A.d; e += blockDim.x) {
    const int r = (int)(e / A.d), k = (int)(e % A.d);
    const int t = r < A.B ? A.tok[r] : A.ptok[r - A.B];
    A.h[e] = __ldg(A.embed + (long long)t * A.d + k);
  }
  __syncthreads();
}

__device__ void glue_pre(const UArgs& A, int l, float* smem) {
  const int R = A.B + A.Lp, d = A.d, hd = A.hd, H = A.H, Hkv = A.Hkv;
  const int nq = H * hd, nkv = Hkv * hd;
  const float* h = A.h + (long long)(l % 2) * R * d;
  rms_rows(h, A.xn, R, d, A.attn_norm + (long long)l * d, A.eps);
  gemm_rows(A.xn, d, R, A.wq + (long long)l * d * nq, nq, d, nq, A.sq, nq, smem);
  gemm_rows(A.xn, d, R, A.wk + (long long)l * d * nkv, nkv, d, nkv, A.sk, nkv, smem);
  gemm_rows(A.xn, d, R, A.wv + (long long)l * d * nkv, nkv, d, nkv, A.sv, nkv, smem);
  const int half = hd / 2;
  const long long cache_l = (long long)l * A.B * A.cap * nkv;
  const long long pre_l = (long long)l * A.cap * nkv;
  // q rows: RoPE into qd (decode) or qp (prompt, [H, Lp_pad, hd])
  for (int e = threadIdx.x; e < R * H * half; e += blockDim.x) {
    const int r = e / (H * half), hh = (e / half) % H, i = e % half;
    const int p = r < A.B ? A.pos[r] : r - A.B;
    float* y = r < A.B ? A.qd + ((long long)r * H + hh) * hd
                       : A.qp + ((long long)hh * A.Lp_pad + (r - A.B)) * hd;
    rope_pair(A.sq + (long long)r * nq + hh * hd, y, i, hd, p, A.theta);
  }
  // k rows: RoPE into the cache row of the slot (decode) or of the prompt
  for (int e = threadIdx.x; e < R * Hkv * half; e += blockDim.x) {
    const int r = e / (Hkv * half), hh = (e / half) % Hkv, i = e % half;
    const bool dec = r < A.B;
    const int p = dec ? A.pos[r] : r - A.B;
    float* y = dec ? A.kc + cache_l + ((long long)r * A.cap + p) * nkv + hh * hd
                   : A.kp + pre_l + (long long)p * nkv + hh * hd;
    rope_pair(A.sk + (long long)r * nkv + hh * hd, y, i, hd, p, A.theta);
  }
  // v rows: copied into the cache row
  for (int e = threadIdx.x; e < R * nkv; e += blockDim.x) {
    const int r = e / nkv, j = e % nkv;
    const bool dec = r < A.B;
    float* y = dec ? A.vc + cache_l + ((long long)r * A.cap + A.pos[r]) * nkv
                   : A.vp + pre_l + (long long)(r - A.B) * nkv;
    y[j] = A.sv[(long long)r * nkv + j];
  }
  __syncthreads();
}

__device__ void glue_post(const UArgs& A, int l, const int* mult, bool divide, float* smem) {
  const int R = A.B + A.Lp, d = A.d, hd = A.hd, H = A.H;
  const int nq = H * hd;
  const float* h = A.h + (long long)(l % 2) * R * d;
  float* h_out = A.h + (long long)((l + 1) % 2) * R * d;
  // the attention rows, multiplicity-normalised (lockstep accumulates)
  for (int e = threadIdx.x; e < R * nq; e += blockDim.x) {
    const int r = e / nq, hh = (e % nq) / hd, k = e % hd;
    float v, div = 1.f;
    if (r < A.B) {
      const int t = A.dec_att_base + (l * A.B + r) * H + hh;
      v = A.att[(((long long)l * A.B + r) * H + hh) * hd + k];
      if (divide) div = (float)max(mult[t], 1);
    } else {
      const int i = r - A.B;
      const int t = A.pre_att_base + l * A.n_flash_l + hh * A.nq_p + i / A.bq_p;
      v = A.attp[(((long long)l * H + hh) * A.Lp_pad + i) * hd + k];
      if (divide) div = (float)max(mult[t], 1);
    }
    A.sq[e] = v / div;
  }
  __syncthreads();
  gemm_rows(A.sq, nq, R, A.wo + (long long)l * nq * d, d, nq, d, A.sa, d, smem);
  axpy(h, A.sa, A.res_scale, A.sh2, (long long)R * d);
  if (A.E) {
    // MoE: the residual waits in sh2 for GLUE_COMB; route each segment
    rms_rows(A.sh2, A.xf, R, d, A.mlp_norm + (long long)l * d, A.eps);
    gemm_rows(A.xf, d, R, A.router + (long long)l * d * A.E, A.E, d, A.E, A.sr, A.E, smem);
    route_rows(A, R, smem);
    pool_put(A, 0, A.B, A.pool_dec, 0, 0, smem);
    if (A.Lp) pool_put(A, A.B, A.Lp, A.pool_pre, A.pool_dec, A.pool_dec * A.bt, smem);
    return;
  }
  rms_rows(A.sh2, A.xn, R, d, A.mlp_norm + (long long)l * d, A.eps);
  swiglu_rows(A, l, A.xn, smem);
  axpy(A.sh2, A.sm, A.res_scale, h_out, (long long)R * d);
}

// The expert combine of both segments, the shared experts and the residual:
// h[(l + 1) % 2] = sh2 + s * (sum over the token's pairs, in ascending pool
// row, of gate * yr[row] / mult(row's tile) + shared(xf)).
__device__ void glue_comb(const UArgs& A, int l, const int* mult, bool divide, float* smem) {
  const int R = A.B + A.Lp, d = A.d, k = A.k;
  const long long n_rows = (long long)(A.pool_dec + A.pool_pre) * A.bt;
  const float* yr = A.yr + (long long)l * n_rows * d;
  float* h_out = A.h + (long long)((l + 1) % 2) * R * d;
  if (A.f) swiglu_rows(A, l, A.xf, smem);
  for (long long i = threadIdx.x; i < (long long)R * d; i += blockDim.x) {
    const int r = (int)(i / d), c = (int)(i % d);
    const bool dec = r < A.B;
    const long long row0 = dec ? 0 : (long long)A.pool_dec * A.bt;
    const int tbase = dec ? A.exp_dec_base + l * A.pool_dec : A.exp_pre_base + l * A.pool_pre;
    float y = 0.f;
    for (int j = 0; j < k; ++j) {
      const int row = A.prow[r * k + j];
      float v = yr[(row0 + row) * d + c];
      if (divide) v = __fdiv_rn(v, (float)max(mult[tbase + row / A.bt], 1));
      y = __fadd_rn(y, __fmul_rn(A.gate[row0 + row], v));
    }
    if (A.f) y = __fadd_rn(y, A.sm[i]);
    h_out[i] = A.sh2[i] + A.res_scale * y;
  }
  __syncthreads();
}

__device__ void glue_logits(const UArgs& A, float* smem) {
  const int R = A.B + A.Lp, d = A.d;
  const float* h = A.h + (long long)(A.L % 2) * R * d;
  rms_rows(h, A.xn, A.B, d, A.final_norm, A.eps);
  const int n = A.B + (A.Lp ? 1 : 0);
  if (A.Lp) rms_rows(h + (long long)(R - 1) * d, A.xn + (long long)A.B * d, 1, d, A.final_norm,
                     A.eps);
  gemm_rows(A.xn, d, n, A.unembed, A.Vp, d, A.Vp, A.logits, A.Vp, smem);
  const int pad = A.Vp - A.V;
  for (int e = threadIdx.x; e < n * pad; e += blockDim.x)
    A.logits[(long long)(e / pad) * A.Vp + A.V + e % pad] = -1e30f;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the tile body: dispatch on F_OP

struct UnifiedTile {
  const UArgs& A;
  const int* mult;  // lockstep: the live [n_tasks] counts
  float* smem;

  __device__ void operator()(const int* rec, bool store) const {
    const int op = rec[F_OP];
    if (op == OP_DECODE_TILE || op == OP_FLASH_TILE) {
      const bool dec = op == OP_DECODE_TILE;
      const long long nkv = (long long)A.Hkv * A.hd;
      AttnArgs a;
      a.causal = dec ? 0 : 1;
      a.H = A.H;
      a.hd = A.hd;
      a.g = A.H / A.Hkv;
      a.scale = A.scale;
      a.q_sd = a.k_sd = a.v_sd = 1;
      a.k_sh = a.v_sh = A.hd;
      a.k_ss = a.v_ss = nkv;
      a.k_sb = a.v_sb = (long long)A.cap * nkv;
      if (dec) {
        const int l = (rec[F_TID] - A.dec_att_base) / (A.B * A.H);
        const long long off = (long long)l * A.B * A.cap * nkv;
        a.q = A.qd;
        a.q_sb = (long long)A.H * A.hd;
        a.q_sh = A.hd;
        a.q_ss = A.hd;
        a.k = A.kc + off;
        a.v = A.vc + off;
        a.out = A.att + (long long)l * A.B * A.H * A.hd;
        a.Sq = 1;
        a.Sq_out = 1;
        a.Sk = A.cap;
        a.bq = 1;
        a.bk = A.bk_d;
      } else {
        const int l = (rec[F_TID] - A.pre_att_base) / A.n_flash_l;
        const long long off = (long long)l * A.cap * nkv;
        a.q = A.qp;
        a.q_sb = 0;
        a.q_sh = (long long)A.Lp_pad * A.hd;
        a.q_ss = A.hd;
        a.k = A.kp + off;
        a.v = A.vp + off;
        a.out = A.attp + (long long)l * A.H * A.Lp_pad * A.hd;
        a.Sq = A.Lp_pad;
        a.Sq_out = A.Lp_pad;
        a.Sk = A.Lp;
        a.bq = A.bq_p;
        a.bk = A.bk_p;
      }
      execute_tile<float>(a, smem, rec, store);
      return;
    }
    if (op == OP_EXPERT_TILE) {
      const int l = rec[F_E], dec = rec[F_RS] == 0, j = rec[F_RL];
      const int tile = (dec ? 0 : A.pool_dec) + j;
      const int rl = A.rl[tile];
      if (rl == 0) return;  // dead pool tile: nothing to add
      const long long row = (long long)(dec ? 0 : A.pool_dec) * A.bt + (long long)j * A.bt;
      const long long n_rows = (long long)(A.pool_dec + A.pool_pre) * A.bt;
      const long long w = ((long long)l * A.E + A.e[tile]) * A.d * A.fe;
      expert_rows<float, EXPERT_RB, EXPERT_CPT>(
          A.xf + (long long)(dec ? 0 : A.B) * A.d, A.rtok + row, A.we_g + w, A.we_u + w,
          A.we_d + w, A.yr + ((long long)l * n_rows + row) * A.d, A.d, A.fe, rl, rl, store,
          smem);
      return;
    }
    // OP_STEP_GLUE
    const int phase = rec[F_PHASE], l = rec[F_LAYER];
    if (phase == GLUE_EMBED) {
      glue_embed(A);
    } else if (phase == GLUE_PRE) {
      glue_pre(A, l, smem);
    } else if (phase == GLUE_POST) {
      glue_post(A, l, mult, !store, smem);
    } else if (phase == GLUE_COMB) {
      glue_comb(A, l, mult, !store, smem);
    } else {
      glue_logits(A, smem);
    }
  }
};

// ---------------------------------------------------------------------------
// kernels

template <bool TRACE>
__global__ void __launch_bounds__(UTHREADS, 1) ws_unified_lockstep(WSQueues Q, UArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_lockstep<TRACE>(Q, sh, UnifiedTile{A, Q.mult, smem});
}

template <bool TRACE>
__global__ void __launch_bounds__(UTHREADS, 1) ws_unified_free(WSQueues Q, UArgs A) {
  extern __shared__ float smem[];
  __shared__ WSShared sh;
  ws_free<TRACE>(Q, sh, UnifiedTile{A, Q.mult, smem});
}

// Dynamic shared memory of the largest body: a gemm row block or a tile.
static size_t unified_smem(const UArgs& A) {
  size_t gemm;
  const int nt = UTHREADS;
  const size_t g4 = 1024 * 4 + 3 * 4 * (nt / 4) * 4;
  const size_t g8 = 512 * 8 + 1 * 8 * (nt / 2) * 4;
  gemm = g4 > g8 ? g4 : g8;
  const size_t dec = 2 * A.hd + (size_t)A.bk_d * A.hd + A.bk_d + 3;
  const size_t fl = A.Lp ? 2 * (size_t)A.bq_p * A.hd + (size_t)A.bk_p * A.hd +
                               (size_t)A.bq_p * A.bk_p + 3 * A.bq_p
                         : 0;
  size_t m = gemm > dec ? gemm : dec;
  m = m > fl ? m : fl;
  if (A.E) {
    const size_t tk = (size_t)(A.B > A.Lp ? A.B : A.Lp) * A.k;
    const size_t pool = A.pool_dec > A.pool_pre ? A.pool_dec : A.pool_pre;
    const size_t put = 3 * tk + 3 * (size_t)A.E + 1 + pool;
    const size_t route = (size_t)(nt / 32) * (A.E + A.k);
    const size_t tile = expert_tile_smem<EXPERT_RB>(A.fe) / sizeof(float) + 1;
    m = m > put ? m : put;
    m = m > route ? m : route;
    m = m > tile ? m : tile;
  }
  return m * sizeof(float);
}

// ptrs: the 49 pointers of UArgs in declaration order; dims: its 27 ints;
// fdims: eps, theta, res_scale, scale; then the ring (null ev: untraced).
extern "C" int ws_unified_launch(
    int mode,
    const int* tasks, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const int* stage_open, void* const* ptrs, const int* dims, const float* fdims,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int* ev, int* ev_cursor, const int* ev_mult0, int ev_cap,
    int steal_kind, int stall_ns, void* stream) {
  WSQueues Q = ws_queues(tasks, nullptr, tail, head, local_head, taken, remaining, clock, work,
                         steals, scanned, mult, n_queues, capacity, n_programs, n_tasks, rounds,
                         steal, policy, 0);
  Q.stage_open = stage_open;
  ws_set_ring(Q, ev, ev_cursor, ev_mult0, ev_cap, steal_kind, stall_ns);
  UArgs A;
  int i = 0;
  A.tok = (const int*)ptrs[i++];
  A.pos = (const int*)ptrs[i++];
  A.ptok = (const int*)ptrs[i++];
  A.embed = (const float*)ptrs[i++];
  A.final_norm = (const float*)ptrs[i++];
  A.unembed = (const float*)ptrs[i++];
  A.attn_norm = (const float*)ptrs[i++];
  A.wq = (const float*)ptrs[i++];
  A.wk = (const float*)ptrs[i++];
  A.wv = (const float*)ptrs[i++];
  A.wo = (const float*)ptrs[i++];
  A.mlp_norm = (const float*)ptrs[i++];
  A.wg = (const float*)ptrs[i++];
  A.wu = (const float*)ptrs[i++];
  A.wd = (const float*)ptrs[i++];
  A.router = (const float*)ptrs[i++];
  A.we_g = (const float*)ptrs[i++];
  A.we_u = (const float*)ptrs[i++];
  A.we_d = (const float*)ptrs[i++];
  A.kc = (float*)ptrs[i++];
  A.vc = (float*)ptrs[i++];
  A.kp = (float*)ptrs[i++];
  A.vp = (float*)ptrs[i++];
  A.h = (float*)ptrs[i++];
  A.qd = (float*)ptrs[i++];
  A.qp = (float*)ptrs[i++];
  A.att = (float*)ptrs[i++];
  A.attp = (float*)ptrs[i++];
  A.logits = (float*)ptrs[i++];
  A.xf = (float*)ptrs[i++];
  A.rtok = (int*)ptrs[i++];
  A.gate = (float*)ptrs[i++];
  A.e = (int*)ptrs[i++];
  A.rl = (int*)ptrs[i++];
  A.yr = (float*)ptrs[i++];
  A.xn = (float*)ptrs[i++];
  A.sq = (float*)ptrs[i++];
  A.sk = (float*)ptrs[i++];
  A.sv = (float*)ptrs[i++];
  A.sa = (float*)ptrs[i++];
  A.sh2 = (float*)ptrs[i++];
  A.sg = (float*)ptrs[i++];
  A.su = (float*)ptrs[i++];
  A.shm = (float*)ptrs[i++];
  A.sm = (float*)ptrs[i++];
  A.sr = (float*)ptrs[i++];
  A.sidx = (int*)ptrs[i++];
  A.sgv = (float*)ptrs[i++];
  A.prow = (int*)ptrs[i++];
  int j = 0;
  A.B = dims[j++];
  A.Lp = dims[j++];
  A.L = dims[j++];
  A.d = dims[j++];
  A.H = dims[j++];
  A.Hkv = dims[j++];
  A.hd = dims[j++];
  A.f = dims[j++];
  A.V = dims[j++];
  A.Vp = dims[j++];
  A.cap = dims[j++];
  A.bk_d = dims[j++];
  A.bq_p = dims[j++];
  A.bk_p = dims[j++];
  A.nq_p = dims[j++];
  A.Lp_pad = dims[j++];
  A.n_flash_l = dims[j++];
  A.dec_att_base = dims[j++];
  A.pre_att_base = dims[j++];
  A.E = dims[j++];
  A.k = dims[j++];
  A.fe = dims[j++];
  A.bt = dims[j++];
  A.pool_dec = dims[j++];
  A.pool_pre = dims[j++];
  A.exp_dec_base = dims[j++];
  A.exp_pre_base = dims[j++];
  A.eps = fdims[0];
  A.theta = fdims[1];
  A.res_scale = fdims[2];
  A.scale = fdims[3];
  static void (*const kerns[4])(WSQueues, UArgs) = {
      ws_unified_lockstep<false>, ws_unified_free<false>, ws_unified_lockstep<true>,
      ws_unified_free<true>};
  return ws_launch(kerns, mode, Q, A, UTHREADS, unified_smem(A), (cudaStream_t)stream);
}
