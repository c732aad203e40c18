// The unified engine step on Hopper (sm_90a): one fence-free work-stealing
// launch that runs a whole decode step (and optionally one folded prompt's
// prefill) of a GQA decoder, dense or MoE, in fp32.
//
// Replaces the TPU kernel of repro/models/unified.py: the `execute` closure
// of `decode_step_unified` (launched through `launch_ws_grid`, whose
// `pallas_call` is repro/pallas_ws/kernel.py:805).  The scheduler and its
// walks are ws_sched.cuh with the stage gate; the attention tiles are
// ws_attn_body.cuh's bodies (a) and (c), shared with ws_attention.cu.
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
//                   row, unembed -> logits [B + 1, Vp], pad vocab -1e30 (the
//                   product writes the padding too: each word one writer).
//
// One product primitive.  Every weight product of the step, Y[R, N] =
// X[R, K] W[K, N] (q|k|v, wo, gate|up, down, the router, the unembedding,
// and each expert tile's [wg|wu] and wd), runs as column strips of SW = 32
// columns, each computed by one CTA of 512 threads in a fixed order: a
// thread holds 4 adjacent columns of 8 rows and every KS-th row of K (KS =
// 64 / (row blocks of 8), 64 at decode), streaming the weights with 16-byte
// __ldg loads, U in flight a thread; the KS partial sums then meet in shared
// memory and one thread adds them in ascending k-slice order.  The order
// depends on R alone, never on which CTA runs a strip or how many CTAs
// share the strips, so the logits are bit-equal at any number of helpers.
// Free mode takes a wide form instead (`wide`: passes of 512 columns or
// more, 4 or 2 k-slices), which one CTA streams about twice as fast as the
// strips; it has its own fixed order, so a free-mode duplicate writes the
// same bits, and lockstep, whose bits must not depend on H, never takes it.
// fp32 FMAs on CUDA cores; no library call.
//
// Lockstep (mode 0): a walker and H helpers.  CTA 0, the walker, runs
// ws_lockstep unchanged (claims, rings, fault hooks; through plain loads
// and stores, WSQueuesOwned, since no other CTA touches the queue arrays)
// and everything that is not a weight product: norms, RoPE, the cache splice, the multiplicity
// division, residuals, the router's top-k, the counting-sort Put, the
// combine and the attention tiles.  CTAs 1..H, the helpers, run the
// products: the walker posts a request (kind, rows, layer, expert) to a
// command word, helper h computes strips h - 1, h - 1 + H, ... of it, and
// the walker gathers Y and runs the epilogue itself.  H = 0 keeps one CTA,
// which runs every strip itself (the local form).  The host launches the
// 1 + H CTAs cooperatively (all resident at once, refused before the launch
// when they cannot be) and picks H from the SM count.
//
// The hand-off: tagged words, no fences.  Every word that crosses CTAs
// inside the launch carries its own validity: one aligned 64-bit word, a
// 32-bit value (the float's bits, or the request) under the 32-bit tag of
// the request that wrote it, stored with st.relaxed.gpu.b64 and read with
// ld.relaxed.gpu.b64 until the tag is the one expected.  That needs only
// coherence of one location and single-copy atomicity of an aligned 64-bit
// access: no ordering between different words, so no release, acquire,
// fence, membar or atomic (csrc/probes/tagged_handoff.cu holds the same
// hand-off to a stress test).  Tags are unique across launches: the host
// passes each launch its first tag and advances it past the most requests a
// launch can make.  The walker writes X (double-buffered by the tag's
// parity) and the command, the helpers read them and write Y (or, for the
// unembedding, the logits with plain stores, which only the host reads
// after the launch, and one tagged done word a strip).  A helper reads X of
// a request only while the walker waits on its Y, so a tagged buffer is
// never overwritten under a reader.  Tagged buffers are read with relaxed
// loads only (no __ldg, no cp.async, no plain load); weights with __ldg.
// Every spin backs off with __nanosleep and has a %globaltimer deadline
// (the launch's deadline_ns); past it, or on a tag newer than the one
// expected, the CTA writes a fault code to host memory and traps, so the
// launch fails and nothing waits forever or quietly falls back.
//
// Free mode (mode 1) runs P CTAs over one stage's queues; the wrapper
// launches once per stage, since free CTAs have no rounds to gate by.  Every
// product takes the wide form in the claiming CTA.  Several CTAs can run
// one glue task at once, so no glue phase updates a buffer in place: each
// reads what earlier stages wrote (the residual stream ping-pongs between
// h[0] and h[1]) and writes buffers that only this phase writes, with a
// single content each, so a duplicate writes the bits the first execution
// wrote; an expert tile's rows go through its own CTA's scratch.
//
// No atomics and no fences: reductions are warp shuffles and shared-memory
// sums, ordering inside the CTA is __syncthreads(), ordering between stages
// is the rounds (lockstep) or the kernel boundaries (free), and between the
// walker and its helpers the tags.  Each output word has one writer in a
// launch (the logits' vocabulary padding included: the strip or pass that
// owns a padding column writes its -1e30).  The Put is a counting sort in one CTA:
// per-expert counts and ranks by owner threads, a prefix sum in shared
// memory, every output written by one thread; the combine gathers through
// the Put's inverse instead of scattering.
//
// What bounds it on this card.  A decode step reads every weight once
// (11.28 GB of layer weights and 1.58 GB of unembedding for llama3.2-3b in
// fp32) plus the live K/V rows: bytes, now spread over the helpers' SMs.
// The walker's attention tiles stay on one SM, and each product costs a
// request and its answer across SMs.  A folded prompt's products do 2 R
// flops a weight: fp32 operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ws_attn_body.cuh"
#include "ws_sched.cuh"

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
#define UNW (UTHREADS / 32)  // warps of a CTA: the decode body's NW

// products (the request's kind)
#define K_QKV 0
#define K_WO 1
#define K_GATEUP 2
#define K_DOWN 3
#define K_ROUTER 4
#define K_LOGITS 5
#define K_EXP_GU 6
#define K_EXP_D 7
#define K_EXIT 15
#define SW 32                    // columns a strip
#define NQ (SW / 4)              // column quads of a strip
#define NG (UTHREADS / NQ)       // thread groups: row blocks x k-slices
#define RB 8                     // rows a thread
#define WU 8                     // weight loads in flight a thread
#define TB 8                     // tagged loads in flight a thread
#define PASS_ROWS (NG * RB)      // rows of one pass over a strip
#define XS_FLOATS 24576          // a resident X in shared memory (96 KB)
#define RED_FLOATS (NG * RB * SW)  // the partial sums (64 KB), an X chunk's too when not resident
#define MAX_SMEM (226 * 1024)    // the most dynamic shared memory a CTA takes
#define N_MIRRORED 10            // queue arrays the walker keeps in shared memory
#define N_WRITTEN 8              // the first of them, which the walk writes

// the walker's counts (Hand::stats): requests posted, ns from posting a
// request to its last word of Y, ns of the whole walk, and the ns spent in
// the attention, expert and glue bodies (the glue's and experts' waits on
// requests included); the rest of the walk is the scheduler's.  Helper 1
// adds the ns it spent on its strips (staging X included).
#define STAT_REQUESTS 0
#define STAT_WAIT_NS 1
#define STAT_WALK_NS 2
#define STAT_ATTN_NS 3
#define STAT_EXPERT_NS 4
#define STAT_GLUE_NS 5
#define STAT_HELPER_NS 6
#define N_STATS 7

// fault codes (Hand::fault[0])
#define FAULT_DEADLINE 1
#define FAULT_NEWER_TAG 2
#define FAULT_SPAN 3

typedef unsigned long long u64;

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
  // an expert tile's rows, one slot a CTA (free CTAs run tiles at once)
  float* ex;                // [slots, bt, d] its gathered inputs
  float* eg;                // [slots, bt, fe] x wg, then the hidden rows
  float* eu;                // [slots, bt, fe] x wu
  float* ey;                // [slots, bt, d] its output rows
  int B, Lp, L, d, H, Hkv, hd, f, V, Vp, cap;
  int bk_d, bq_p, bk_p, nq_p, Lp_pad, n_flash_l, dec_att_base, pre_att_base;
  int E, k, fe, bt, pool_dec, pool_pre, exp_dec_base, exp_pre_base;  // 0 on a dense model
  int dec_branch;           // the decode tiles' body: BRANCH_DECODE (a) or (c)
  float eps, theta, res_scale, scale;
};

#define BRANCH_DECODE 0

// The hand-off between the walker and its helpers (lockstep).
struct Hand {
  u64* cmd;                 // [1] the request word
  u64* x;                   // [2, x_words] X of a request, by its tag's parity
  u64* y;                   // [R * N] Y of a request
  u64* done;                // [strips] a strip of the unembedding written
  long long* stats;         // [N_STATS] the walker's counts (STAT_*)
  int* fault;               // host memory [4]: code, CTA, tag seen, tag expected
  long long x_words;
  u64 deadline_ns;
  unsigned base;            // the first request's tag in this launch
  unsigned span;            // tags this launch may use
  int H;                    // helpers (CTAs 1..H); 0: every product local
  int mute;                 // drill: the helpers return at once
  int mirror_at;            // the walker's queue mirror in dynamic shared memory (floats); -1: none
};

// ---------------------------------------------------------------------------
// tagged words

__device__ __forceinline__ u64 ld_tagged(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_tagged(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ u64 tagged(float v, unsigned tag) {
  return ((u64)tag << 32) | __float_as_uint(v);
}

__device__ __forceinline__ unsigned tag_of(u64 w) { return (unsigned)(w >> 32); }

__device__ __forceinline__ float value_of(u64 w) { return __uint_as_float((unsigned)w); }

// A spin gave up: the fault code to host memory, time for the stores to
// land there, then the launch stops.
__device__ __noinline__ void fault(const Hand& W, int code, unsigned seen, unsigned want) {
  if (W.fault) {
    volatile int* f = W.fault;
    f[1] = (int)blockIdx.x;
    f[2] = (int)seen;
    f[3] = (int)want;
    f[0] = code;
  }
  for (int i = 0; i < 32; ++i) __nanosleep(1000000);
  __trap();
}

// The word at p once it carries `tag` (newer: a fault).
__device__ __noinline__ u64 wait_slow(const Hand& W, const u64* p, unsigned tag) {
  const u64 t0 = now_ns();
  unsigned ns = 64;
  while (true) {
    const u64 w = ld_tagged(p);
    const unsigned t = tag_of(w);
    if (t == tag) return w;
    if (t > tag) fault(W, FAULT_NEWER_TAG, t, tag);
    if (now_ns() - t0 > W.deadline_ns) fault(W, FAULT_DEADLINE, t, tag);
    __nanosleep(ns);
    ns = ns < 512 ? 2 * ns : ns;
  }
}

// A helper's next request: the command word once its tag is past `last`.
__device__ u64 wait_request(const Hand& W, unsigned last) {
  const u64 t0 = now_ns();
  unsigned ns = 32;
  while (true) {
    const u64 w = ld_tagged(W.cmd);
    if (tag_of(w) > last) return w;
    if (now_ns() - t0 > W.deadline_ns) fault(W, FAULT_DEADLINE, tag_of(w), last + 1);
    __nanosleep(ns);
    ns = ns < 256 ? 2 * ns : ns;
  }
}

// request word: kind 4 bits | rows 11 | layer 8 | expert 9, under the tag
__device__ __forceinline__ u64 request(unsigned tag, int kind, int rows, int l, int e) {
  return ((u64)tag << 32) | (unsigned)kind | ((unsigned)rows << 4) | ((unsigned)l << 15) |
         ((unsigned)e << 23);
}

// ---------------------------------------------------------------------------
// the product primitive

// One product: its weights as up to 3 row-major segments [K, n[j]] along N,
// and the plain destination [R, n[j]] of each.  Columns at or past `live`
// (the unembedding's vocabulary padding) are written -1e30, not computed
// values.
struct Prod {
  int R, K, N, nseg, live;
  const float* w[3];
  int n[3];
  float* y[3];
};

__device__ Prod make_prod(const UArgs& A, int kind, int rows, int l, int e, int slot) {
  Prod P;
  P.R = rows;
  const int d = A.d, nq = A.H * A.hd, nkv = A.Hkv * A.hd, f = A.f, fe = A.fe;
  const long long w = ((long long)l * A.E + e) * d * fe;  // an expert's [d, fe]
  const long long s = (long long)slot * A.bt;
  if (kind == K_QKV) {
    P.K = d;
    P.nseg = 3;
    P.w[0] = A.wq + (long long)l * d * nq, P.n[0] = nq, P.y[0] = A.sq;
    P.w[1] = A.wk + (long long)l * d * nkv, P.n[1] = nkv, P.y[1] = A.sk;
    P.w[2] = A.wv + (long long)l * d * nkv, P.n[2] = nkv, P.y[2] = A.sv;
  } else if (kind == K_WO) {
    P.K = nq;
    P.nseg = 1;
    P.w[0] = A.wo + (long long)l * nq * d, P.n[0] = d, P.y[0] = A.sa;
  } else if (kind == K_GATEUP) {
    P.K = d;
    P.nseg = 2;
    P.w[0] = A.wg + (long long)l * d * f, P.n[0] = f, P.y[0] = A.sg;
    P.w[1] = A.wu + (long long)l * d * f, P.n[1] = f, P.y[1] = A.su;
  } else if (kind == K_DOWN) {
    P.K = f;
    P.nseg = 1;
    P.w[0] = A.wd + (long long)l * f * d, P.n[0] = d, P.y[0] = A.sm;
  } else if (kind == K_ROUTER) {
    P.K = d;
    P.nseg = 1;
    P.w[0] = A.router + (long long)l * d * A.E, P.n[0] = A.E, P.y[0] = A.sr;
  } else if (kind == K_LOGITS) {
    P.K = d;
    P.nseg = 1;
    P.w[0] = A.unembed, P.n[0] = A.Vp, P.y[0] = A.logits;
  } else if (kind == K_EXP_GU) {
    P.K = d;
    P.nseg = 2;
    P.w[0] = A.we_g + w, P.n[0] = fe, P.y[0] = A.eg + s * fe;
    P.w[1] = A.we_u + w, P.n[1] = fe, P.y[1] = A.eu + s * fe;
  } else {  // K_EXP_D
    P.K = fe;
    P.nseg = 1;
    P.w[0] = A.we_d + w, P.n[0] = d, P.y[0] = A.ey + s * d;
  }
  P.N = 0;
  for (int j = 0; j < P.nseg; ++j) P.N += P.n[j];
  P.live = kind == K_LOGITS ? A.V : P.N;
  return P;
}

// The segment of column c (c becomes its column in the segment).
__device__ __forceinline__ int seg_of(const Prod& P, int& c) {
  int j = 0;
  while (j + 1 < P.nseg && c >= P.n[j]) c -= P.n[j++];
  return j;
}

// X columns a chunk of cap floats holds at Rpad rows (a multiple of 64, or
// all of K).
__device__ __forceinline__ int chunk_of(int K, int Rpad, int cap) {
  const int kc = cap / Rpad / 64 * 64;
  return K < kc ? K : kc;
}

// The n words at(i), i < n, under `tag`, each handed to put(i, value): TB
// relaxed loads in flight a thread, then a spin on any that is not there yet.
template <class At, class Put>
__device__ __forceinline__ void read_tagged(const Hand& W, long long n, unsigned tag, const At& at,
                                            const Put& put) {
  for (long long i0 = threadIdx.x; i0 < n; i0 += TB * UTHREADS) {
    u64 w[TB];
#pragma unroll
    for (int u = 0; u < TB; ++u) {
      const long long i = i0 + u * UTHREADS;
      w[u] = i < n ? ld_tagged(at(i)) : 0;
    }
#pragma unroll
    for (int u = 0; u < TB; ++u) {
      const long long i = i0 + u * UTHREADS;
      if (i < n) put(i, value_of(tag_of(w[u]) == tag ? w[u] : wait_slow(W, at(i), tag)));
    }
  }
}

// Rows [r0, r0 + PR) and columns [k0, k0 + kc) of X into xs [kc][Rpad]
// (rows past PR zero): from a plain X (ld rows of ldx) or from the tagged
// X [R, K] of request `tag`.
template <bool XT>
__device__ void stage_x(const Hand& W, const float* x, int ldx, const u64* xt, unsigned tag,
                        int K, int r0, int PR, int k0, int kc, int Rpad, float* xs) {
  if constexpr (XT) {
    const int pad = Rpad - PR;
    for (int e = threadIdx.x; e < kc * pad; e += UTHREADS)
      xs[(e / pad) * Rpad + PR + e % pad] = 0.f;
    const u64* base = xt + (long long)r0 * K + k0;
    read_tagged(
        W, (long long)PR * kc, tag,
        [&](long long e) {
          const long long i = e / kc;
          return base + i * K + (e - i * kc);
        },
        [&](long long e, float v) {
          const long long i = e / kc;
          xs[(e - i * kc) * Rpad + i] = v;
        });
  } else {
    for (int e = threadIdx.x; e < kc * Rpad; e += UTHREADS) {
      const int i = e / kc, kk = e - i * kc;
      xs[kk * Rpad + i] = i < PR ? x[(long long)(r0 + i) * ldx + k0 + kk] : 0.f;
    }
  }
}

// acc[i] += sum over k = ks, ks + KS, ... < kc, ascending, of xr[k Rpad + i]
// times the 4 weights at wk + k ldw (i < RB): WU 16-byte weight loads in
// flight a thread.
__device__ __forceinline__ void accumulate(float (&acc)[RB][4], const float* wk, long long ldw,
                                           int kc, int ks, int KS, const float* xr, int Rpad) {
  for (int kk = ks; kk < kc; kk += KS * WU) {
    float4 w[WU];
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int k = kk + u * KS;
      w[u] = k < kc ? __ldg(reinterpret_cast<const float4*>(wk + k * ldw))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int k = kk + u * KS;
      if (k < kc) {
        float xv[RB];
#pragma unroll
        for (int i4 = 0; i4 < RB / 4; ++i4) {
          const float4 xa = *reinterpret_cast<const float4*>(xr + k * Rpad + 4 * i4);
          xv[4 * i4] = xa.x;
          xv[4 * i4 + 1] = xa.y;
          xv[4 * i4 + 2] = xa.z;
          xv[4 * i4 + 3] = xa.w;
        }
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          acc[i][0] = fmaf(xv[i], w[u].x, acc[i][0]);
          acc[i][1] = fmaf(xv[i], w[u].y, acc[i][1]);
          acc[i][2] = fmaf(xv[i], w[u].z, acc[i][2]);
          acc[i][3] = fmaf(xv[i], w[u].w, acc[i][3]);
        }
      }
    }
  }
}

// One pass of a strip, rows [r0, r0 + PR): each thread's partial sums over
// its k-slice, RB rows of its column quad wp (a thread of row block rb and
// slice ks; act false: none), into red [NG][RB][SW].  X is staged a chunk at
// a time unless resident.  All threads; the partials are in red after the
// last __syncthreads().
template <bool XT>
__device__ __forceinline__ void pass_partials(const Hand& W, const Prod& P, const float* x,
                                              int ldx, const u64* xt, unsigned tag,
                                              bool resident, int r0, int PR, int Rpad, int KS,
                                              int rb, int ks, bool act, const float* wp,
                                              long long ldw, float* xs, float* red) {
  float acc[RB][4];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // a chunk staged for this pass alone may reach over the partials' floats:
  // they are written after its last chunk is read
  const int KC = chunk_of(P.K, Rpad, resident ? XS_FLOATS : XS_FLOATS + RED_FLOATS);
  for (int k0 = 0; k0 < P.K; k0 += KC) {
    const int kc = P.K - k0 < KC ? P.K - k0 : KC;
    if (!resident) {
      __syncthreads();  // the chunk before is read
      stage_x<XT>(W, x, ldx, xt, tag, P.K, r0, PR, k0, kc, Rpad, xs);
      __syncthreads();
    }
    if (act) accumulate(acc, wp + k0 * ldw, ldw, kc, ks, KS, xs + rb * RB, Rpad);
  }
  __syncthreads();  // the strip before has read its partials
  if (act) {
    const int grp = threadIdx.x / NQ, q = threadIdx.x % NQ;
#pragma unroll
    for (int i = 0; i < RB; ++i)
      *reinterpret_cast<float4*>(red + (grp * RB + i) * SW + q * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
}

// Strips s0, s0 + ds, ... of product P into plain destinations (YT false:
// the local form, and the helpers' logits) or into the tagged Y [R, N] of
// request `tag` (YT).  With `done`, each strip is then marked in done[s].
// All threads of the CTA; ends with __syncthreads().
template <bool XT, bool YT>
__device__ void strips(const Hand& W, const Prod& P, const float* x, int ldx, const u64* xt,
                       u64* yt, u64* done, unsigned tag, int s0, int ds, float* smem) {
  const int tid = threadIdx.x, q = tid % NQ, grp = tid / NQ;
  const int n_strips = (P.N + SW - 1) / SW;
  float* xs = smem;               // [kc][Rpad]
  float* red = smem + XS_FLOATS;  // [NG][RB][SW]
  const int npass = (P.R + PASS_ROWS - 1) / PASS_ROWS;
  const int R0 = P.R < PASS_ROWS ? P.R : PASS_ROWS;
  const int Rpad0 = (R0 + RB - 1) / RB * RB;
  const bool resident = npass == 1 && chunk_of(P.K, Rpad0, XS_FLOATS) == P.K;
  if (resident && s0 < n_strips) {
    stage_x<XT>(W, x, ldx, xt, tag, P.K, 0, P.R, 0, P.K, Rpad0, xs);
    __syncthreads();
  }
  for (int s = s0; s < n_strips; s += ds) {
    int c = s * SW + q * 4;
    const bool col_live = c < P.N;
    const int j = seg_of(P, c);
    const float* wp = P.w[j] + c;
    const long long ldw = P.n[j];
    for (int r0 = 0; r0 < P.R; r0 += PASS_ROWS) {
      const int PR = P.R - r0 < PASS_ROWS ? P.R - r0 : PASS_ROWS;
      const int nrb = (PR + RB - 1) / RB, Rpad = nrb * RB;
      int KS = 1;
      while (2 * KS * nrb <= NG) KS *= 2;
      const int rb = grp / KS, ks = grp - rb * KS;
      const bool act = col_live && rb < nrb;
      pass_partials<XT>(W, P, x, ldx, xt, tag, resident, r0, PR, Rpad, KS, rb, ks, act, wp, ldw,
                        xs, red);
      for (int o = tid; o < Rpad * SW; o += UTHREADS) {
        const int row = o / SW, col = o - row * SW;
        const int r = r0 + row;
        int n = s * SW + col;
        if (row >= PR || n >= P.N) continue;
        const int b = row / RB, i = row - b * RB;
        const float* pt = red + ((b * KS) * RB + i) * SW + col;
        float v = 0.f;
#pragma unroll 16
        for (int t = 0; t < KS; ++t) v += pt[t * RB * SW];
        if (n >= P.live) v = -1e30f;
        if constexpr (YT) {
          st_tagged(yt + (long long)r * P.N + n, tagged(v, tag));
        } else {
          const int jj = seg_of(P, n);
          P.y[jj][(long long)r * P.n[jj] + n] = v;
        }
      }
    }
    if (done) {
      __syncthreads();
      if (tid == 0) st_tagged(done + s, tagged(0.f, tag));
    }
  }
  __syncthreads();
}

// The wide form (free mode): passes of TW = UTHREADS / KS column quads
// over blocks of RB rows (RB 4: 512 columns, 4 k-slices, X in chunks of
// 1024; RB 8: 1024 columns, 2 k-slices, chunks of 512), each thread summing
// every KS-th k of its quad in ascending order, slice 0's thread then
// adding the KS partial sums in ascending slice order.  X (plain, row stride
// ldx) is staged a chunk at a time.  All threads; ends with __syncthreads().
template <int RB_>
__device__ void wide(const Prod& P, const float* X, int ldx, float* smem) {
  constexpr int KS = RB_ <= 4 ? 4 : 2;
  constexpr int KC = RB_ <= 4 ? 1024 : 512;
  constexpr int UNROLL = RB_ <= 4 ? 8 : 4;
  constexpr int TW = UTHREADS / KS;
  const int tid = threadIdx.x, c = tid % TW, s = tid / TW;
  float* xs = smem;            // [KC][RB_]
  float* red = xs + KC * RB_;  // [KS - 1][RB_][TW * 4]
  int off = 0;                 // the segment's first column in the product
  for (int j = 0; j < P.nseg; off += P.n[j++]) {
    const int N = P.n[j];
    const float* W = P.w[j];
    float* Y = P.y[j];
    for (int r0 = 0; r0 < P.R; r0 += RB_) {
      const int nr = min(RB_, P.R - r0);
      for (int n0 = 0; n0 < N; n0 += TW * 4) {
        const int n = n0 + c * 4;
        const bool live = n < N;
        float acc[RB_][4];
#pragma unroll
        for (int i = 0; i < RB_; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        for (int k0 = 0; k0 < P.K; k0 += KC) {
          const int kc = min(KC, P.K - k0);
          __syncthreads();
          for (int e = tid; e < kc * RB_; e += UTHREADS) {
            const int i = e / kc, kk = e % kc;
            xs[kk * RB_ + i] = i < nr ? X[(long long)(r0 + i) * ldx + k0 + kk] : 0.f;
          }
          __syncthreads();
          if (live) {
            const float* wp = W + (long long)k0 * N + n;
#pragma unroll UNROLL
            for (int kk = s; kk < kc; kk += KS) {
              const float4 w = __ldg(reinterpret_cast<const float4*>(wp + (long long)kk * N));
              const float4* xr = reinterpret_cast<const float4*>(xs + kk * RB_);
#pragma unroll
              for (int i4 = 0; i4 < RB_ / 4; ++i4) {
                const float4 a = xr[i4];
                const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  float* o = acc[i4 * 4 + q];
                  o[0] = fmaf(av[q], w.x, o[0]);
                  o[1] = fmaf(av[q], w.y, o[1]);
                  o[2] = fmaf(av[q], w.z, o[2]);
                  o[3] = fmaf(av[q], w.w, o[3]);
                }
              }
            }
          }
        }
        if (live && s > 0) {
#pragma unroll
          for (int i = 0; i < RB_; ++i)
            *reinterpret_cast<float4*>(red + ((long long)(s - 1) * RB_ + i) * TW * 4 + c * 4) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
        __syncthreads();
        if (live && s == 0) {
          for (int t = 1; t < KS; ++t) {
#pragma unroll
            for (int i = 0; i < RB_; ++i) {
              const float4 p = *reinterpret_cast<const float4*>(
                  red + ((long long)(t - 1) * RB_ + i) * TW * 4 + c * 4);
              acc[i][0] += p.x;
              acc[i][1] += p.y;
              acc[i][2] += p.z;
              acc[i][3] += p.w;
            }
          }
          for (int i = 0; i < nr; ++i) {
            float* y = Y + (long long)(r0 + i) * N + n;
#pragma unroll
            for (int q = 0; q < 4; ++q) y[q] = off + n + q < P.live ? acc[i][q] : -1e30f;
          }
        }
      }
    }
  }
  __syncthreads();
}

// What a tile body needs beside the record: the arguments, the hand-off,
// whether products are delegated (the walker with helpers), and whether
// the local form is the wide one (free mode).
struct UCtx {
  const UArgs& A;
  const Hand& W;
  bool delegate;
  bool wide;
  unsigned* seq;            // shared: the walker's last tag
  long long* stat;          // shared [N_STATS]: the walker's counts (thread 0)
  float* smem;
  int slot;                 // this CTA's expert scratch
};

// Y = X W for product `kind` of `rows` rows (X [rows, K] plain, row stride
// ldx) into its plain destinations: the local form computes every column
// here (free mode in wide passes, a lockstep walker without helpers in
// strips); the delegated one publishes X, posts the request and gathers Y
// (the logits: waits for every strip's done word).  All threads; ends with
// __syncthreads().
__device__ void product(const UCtx& C, int kind, int rows, int l, int e, const float* x,
                        int ldx) {
  const Prod P = make_prod(C.A, kind, rows, l, e, C.slot);
  if (C.wide) {
    if (rows <= 4) {
      wide<4>(P, x, ldx, C.smem);
    } else {
      wide<8>(P, x, ldx, C.smem);
    }
    return;
  }
  if (!C.delegate) {
    strips<false, false>(C.W, P, x, ldx, nullptr, nullptr, nullptr, 0, 0, 1, C.smem);
    return;
  }
  const Hand& W = C.W;
  const int tid = threadIdx.x;
  const unsigned tag = *C.seq + 1;
  if (tag - W.base >= W.span) fault(W, FAULT_SPAN, tag, W.base + W.span);
  u64* xt = W.x + (tag & 1) * W.x_words;
  const long long nx = (long long)rows * P.K;
  for (long long i = tid; i < nx; i += UTHREADS) {
    const long long r = i / P.K;
    st_tagged(xt + i, tagged(x[r * ldx + (i - r * P.K)], tag));
  }
  long long t_post = 0;
  if (tid == 0) {
    t_post = clock64();
    st_tagged(W.cmd, request(tag, kind, rows, l, e));
  }
  if (kind == K_LOGITS) {
    read_tagged(
        W, (P.N + SW - 1) / SW, tag, [&](long long s) { return W.done + s; },
        [](long long, float) {});
  } else {
    read_tagged(
        W, (long long)rows * P.N, tag, [&](long long i) { return W.y + i; },
        [&](long long i, float v) {
          const long long r = i / P.N;
          int n = (int)(i - r * P.N);
          const int j = seg_of(P, n);
          P.y[j][r * P.n[j] + n] = v;
        });
  }
  __syncthreads();
  if (tid == 0) {
    *C.seq = tag;
    C.stat[STAT_REQUESTS] += 1;
    C.stat[STAT_WAIT_NS] += clock64() - t_post;  // cycles until the walk's end
  }
  __syncthreads();
}

// A helper (CTA h of 1..H): requests until the exit, strips h - 1, h - 1 +
// H, ... of each.
__device__ void helper(const UArgs& A, const Hand& W, float* smem) {
  __shared__ u64 s_req;
  if (W.mute) return;
  unsigned last = W.base - 1;
  long long busy = 0;  // thread 0: cycles on strips
  const u64 h0 = now_ns();
  const long long c0 = clock64();
  while (true) {
    if (threadIdx.x == 0) s_req = wait_request(W, last);
    __syncthreads();
    const u64 req = s_req;
    __syncthreads();
    const unsigned tag = tag_of(req), p = (unsigned)req;
    const int kind = p & 15, rows = (p >> 4) & 2047, l = (p >> 15) & 255, e = p >> 23;
    if (kind == K_EXIT) {
      if (threadIdx.x == 0 && blockIdx.x == 1 && W.stats)
        W.stats[STAT_HELPER_NS] = (long long)((double)busy * (double)(now_ns() - h0) /
                                              (double)(clock64() - c0));
      return;
    }
    last = tag;
    const Prod P = make_prod(A, kind, rows, l, e, 0);
    const u64* xt = W.x + (tag & 1) * W.x_words;
    const long long t0 = threadIdx.x == 0 ? clock64() : 0;
    if (kind == K_LOGITS) {
      strips<true, false>(W, P, nullptr, 0, xt, nullptr, W.done, tag, blockIdx.x - 1, W.H,
                          smem);
    } else {
      strips<true, true>(W, P, nullptr, 0, xt, W.y, nullptr, tag, blockIdx.x - 1, W.H, smem);
    }
    if (threadIdx.x == 0) busy += clock64() - t0;
  }
}

// ---------------------------------------------------------------------------
// glue building blocks (all threads; each ends with __syncthreads())

// Y[r] = X[r] / sqrt(mean(X[r]^2) + eps) * (1 + w), rows of d floats.  A
// row's sum of squares is taken by wpr warps at once (as many as the rows
// leave; each lane's elements in ascending order, the lanes by shuffle, the
// warps ascending in shared memory), then every thread normalises.
__device__ void rms_rows(const float* X, float* Y, int n, int d, const float* __restrict__ w,
                         float eps, float* smem) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, nw = blockDim.x / 32;
  int wpr = 1;
  while (2 * wpr * n <= nw) wpr *= 2;
  const int at_once = nw / wpr;
  float* part = smem;     // [nw] a warp's sum
  float* inv = smem + nw;  // [n] each row's scale
  for (int r0 = 0; r0 < n; r0 += at_once) {
    const int r = r0 + warp / wpr, wi = warp % wpr;
    float ss = 0.f;
    if (r < n) {
      const float* x = X + (long long)r * d;
      for (int k = lane + 32 * wi; k < d; k += 32 * wpr) ss += x[k] * x[k];
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    if (tid < at_once && r0 + tid < n) {
      float t = 0.f;
      for (int i = 0; i < wpr; ++i) t += part[tid * wpr + i];
      inv[r0 + tid] = 1.f / sqrtf(t / (float)d + eps);
    }
    __syncthreads();
  }
  for (long long e = tid; e < (long long)n * d; e += blockDim.x) {
    const int r = (int)(e / d), k = (int)(e - (long long)r * d);
    Y[e] = (X[e] * inv[r]) * (1.f + __ldg(w + k));
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


// The layer's SwiGLU of X [R, d] into sm [R, d]: the dense MLP, or a MoE
// layer's shared experts (wg/wu/wd, width f).
__device__ void swiglu_rows(const UCtx& C, int l, const float* X) {
  const UArgs& A = C.A;
  const int R = A.B + A.Lp, f = A.f;
  product(C, K_GATEUP, R, l, 0, X, A.d);
  for (long long e = threadIdx.x; e < (long long)R * f; e += blockDim.x) {
    const float g = A.sg[e];
    A.shm[e] = g / (1.f + expf(-g)) * A.su[e];
  }
  __syncthreads();
  product(C, K_DOWN, R, l, 0, A.shm, f);
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

__device__ void glue_pre(const UCtx& C, int l) {
  const UArgs& A = C.A;
  const int R = A.B + A.Lp, d = A.d, hd = A.hd, H = A.H, Hkv = A.Hkv;
  const int nq = H * hd, nkv = Hkv * hd;
  const float* h = A.h + (long long)(l % 2) * R * d;
  rms_rows(h, A.xn, R, d, A.attn_norm + (long long)l * d, A.eps, C.smem);
  product(C, K_QKV, R, l, 0, A.xn, d);
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

__device__ void glue_post(const UCtx& C, int l, const int* mult, bool divide) {
  const UArgs& A = C.A;
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
  product(C, K_WO, R, l, 0, A.sq, nq);
  axpy(h, A.sa, A.res_scale, A.sh2, (long long)R * d);
  if (A.E) {
    // MoE: the residual waits in sh2 for GLUE_COMB; route each segment
    rms_rows(A.sh2, A.xf, R, d, A.mlp_norm + (long long)l * d, A.eps, C.smem);
    product(C, K_ROUTER, R, l, 0, A.xf, d);
    route_rows(A, R, C.smem);
    pool_put(A, 0, A.B, A.pool_dec, 0, 0, C.smem);
    if (A.Lp) pool_put(A, A.B, A.Lp, A.pool_pre, A.pool_dec, A.pool_dec * A.bt, C.smem);
    return;
  }
  rms_rows(A.sh2, A.xn, R, d, A.mlp_norm + (long long)l * d, A.eps, C.smem);
  swiglu_rows(C, l, A.xn);
  axpy(A.sh2, A.sm, A.res_scale, h_out, (long long)R * d);
}

// The expert combine of both segments, the shared experts and the residual:
// h[(l + 1) % 2] = sh2 + s * (sum over the token's pairs, in ascending pool
// row, of gate * yr[row] / mult(row's tile) + shared(xf)).
__device__ void glue_comb(const UCtx& C, int l, const int* mult, bool divide) {
  const UArgs& A = C.A;
  const int R = A.B + A.Lp, d = A.d, k = A.k;
  const long long n_rows = (long long)(A.pool_dec + A.pool_pre) * A.bt;
  const float* yr = A.yr + (long long)l * n_rows * d;
  float* h_out = A.h + (long long)((l + 1) % 2) * R * d;
  if (A.f) swiglu_rows(C, l, A.xf);
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

__device__ void glue_logits(const UCtx& C) {
  const UArgs& A = C.A;
  const int R = A.B + A.Lp, d = A.d;
  const float* h = A.h + (long long)(A.L % 2) * R * d;
  rms_rows(h, A.xn, A.B, d, A.final_norm, A.eps, C.smem);
  const int n = A.B + (A.Lp ? 1 : 0);
  if (A.Lp)
    rms_rows(h + (long long)(R - 1) * d, A.xn + (long long)A.B * d, 1, d, A.final_norm, A.eps,
             C.smem);
  product(C, K_LOGITS, n, 0, 0, A.xn, d);  // the padding columns too
}

// Pool tile j of a segment: its rl live rows of xf gathered through tok,
// then two products, x [wg | wu] and silu(g) u wd, into yr (stored in free
// mode, added in lockstep).
__device__ void expert_tile(const UCtx& C, const int* rec, bool store) {
  const UArgs& A = C.A;
  const int l = rec[F_E], dec = rec[F_RS] == 0, j = rec[F_RL];
  const int tile = (dec ? 0 : A.pool_dec) + j;
  const int rl = A.rl[tile];
  if (rl == 0) return;  // dead pool tile: nothing to add
  const int d = A.d, fe = A.fe, e = A.e[tile];
  const long long row = (long long)(dec ? 0 : A.pool_dec) * A.bt + (long long)j * A.bt;
  const long long n_rows = (long long)(A.pool_dec + A.pool_pre) * A.bt;
  const long long s = (long long)C.slot * A.bt;
  float* ex = A.ex + s * d;
  float* eg = A.eg + s * fe;
  const float* eu = A.eu + s * fe;
  const float* ey = A.ey + s * d;
  const float* x = A.xf + (long long)(dec ? 0 : A.B) * d;
  for (int i = threadIdx.x; i < rl * d; i += blockDim.x) {
    const int r = i / d;
    ex[i] = x[(long long)A.rtok[row + r] * d + (i - r * d)];
  }
  __syncthreads();
  product(C, K_EXP_GU, rl, l, e, ex, d);
  for (int i = threadIdx.x; i < rl * fe; i += blockDim.x) {
    const float g = eg[i];
    eg[i] = g / (1.f + expf(-g)) * eu[i];
  }
  __syncthreads();
  product(C, K_EXP_D, rl, l, e, eg, fe);
  float* out = A.yr + ((long long)l * n_rows + row) * d;
  for (int i = threadIdx.x; i < rl * d; i += blockDim.x) {
    if (store) {
      out[i] = ey[i];   // free: idempotent plain store of the whole tile
    } else {
      out[i] += ey[i];  // lockstep: one walker, accumulate tile x mult
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the tile body: dispatch on F_OP

struct UnifiedTile {
  const UCtx& C;
  const int* mult;  // lockstep: the live [n_tasks] counts

  __device__ void operator()(const int* rec, bool store) const {
    if (!C.stat) {
      run(rec, store);
      return;
    }
    const long long t0 = threadIdx.x == 0 ? clock64() : 0;  // cycles: the walk's end scales them
    run(rec, store);  // ends with __syncthreads()
    if (threadIdx.x == 0) {
      const int op = rec[F_OP];
      C.stat[op == OP_STEP_GLUE ? STAT_GLUE_NS : op == OP_EXPERT_TILE ? STAT_EXPERT_NS
                                                                       : STAT_ATTN_NS] +=
          clock64() - t0;
    }
  }

  // out of line: the walk's loop keeps its registers
  __device__ __noinline__ void run(const int* rec, bool store) const {
    const UArgs& A = C.A;
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
      a.branch = dec ? A.dec_branch : 2;
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
      // the cache rows this step spliced in were written by this CTA: plain loads
      if (a.branch == BRANCH_DECODE) {
        decode_tile<float, UNW, false>(a, C.smem, rec, store);
      } else {
        generic_tile<float>(a, C.smem, rec, store);
      }
      return;
    }
    if (op == OP_EXPERT_TILE) {
      expert_tile(C, rec, store);
      return;
    }
    // OP_STEP_GLUE
    const int phase = rec[F_PHASE], l = rec[F_LAYER];
    if (phase == GLUE_EMBED) {
      glue_embed(A);
    } else if (phase == GLUE_PRE) {
      glue_pre(C, l);
    } else if (phase == GLUE_POST) {
      glue_post(C, l, mult, !store);
    } else if (phase == GLUE_COMB) {
      glue_comb(C, l, mult, !store);
    } else {
      glue_logits(C);
    }
  }
};

// ---------------------------------------------------------------------------
// kernels

// Lockstep: CTA 0 walks the step, CTAs 1..H serve its products.
template <bool TRACE>
__global__ void __launch_bounds__(UTHREADS, 1) ws_unified_lockstep(WSQueues Q, UArgs A, Hand W) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  __shared__ unsigned seq;
  __shared__ long long stat[N_STATS];
  if (blockIdx.x > 0) {
    helper(A, W, smem);
    return;
  }
  u64 t0 = 0;
  long long c0 = 0;
  if (threadIdx.x == 0) {
    t0 = now_ns();
    c0 = clock64();
    seq = W.base - 1;
    for (int i = 0; i < N_STATS; ++i) stat[i] = 0;
  }
  // CTA 0 alone walks the queues (the owned view), and the arrays thread 0
  // reads at every cell and claim live in shared memory for the walk when
  // they fit (mirror_at): copied in before it, and the ones it writes out
  // after it (the first N_WRITTEN)
  WSQueuesOwned O = owned(Q);
  const int P = Q.n_programs, nq = Q.n_queues;
  int* const arrays[N_MIRRORED] = {Q.clock, Q.scanned, Q.work, Q.steals, (int*)Q.head,
                                   (int*)Q.remaining, (int*)Q.local_head, Q.mult,
                                   (int*)Q.tail, (int*)Q.stage_open};
  const int sizes[N_MIRRORED] = {P, P, P, P, nq, nq, P * nq, Q.n_tasks, nq, nq};
  int* mirror[N_MIRRORED];
  if (W.mirror_at >= 0) {
    int* m = (int*)(smem + W.mirror_at);
    for (int a = 0; a < N_MIRRORED; ++a) {
      mirror[a] = m;
      for (int i = threadIdx.x; i < sizes[a]; i += blockDim.x) m[i] = arrays[a][i];
      m += sizes[a];
    }
    O.clock = mirror[0], O.scanned = mirror[1], O.work = mirror[2], O.steals = mirror[3];
    O.head = mirror[4], O.remaining = mirror[5], O.local_head = mirror[6], O.mult = mirror[7];
    O.tail = mirror[8], O.stage_open = mirror[9];
  }
  __syncthreads();
  const UCtx C{A, W, W.H > 0, false, &seq, stat, smem, 0};
  ws_lockstep<TRACE>(O, sh, UnifiedTile{C, O.mult});  // ends with __syncthreads()
  if (W.mirror_at >= 0) {
    for (int a = 0; a < N_WRITTEN; ++a)
      for (int i = threadIdx.x; i < sizes[a]; i += blockDim.x) arrays[a][i] = mirror[a][i];
  }
  if (threadIdx.x == 0) {
    if (W.H) st_tagged(W.cmd, request(seq + 1, K_EXIT, 0, 0, 0));
    if (W.stats) {
      // the body and wait spans were taken in SM cycles (cheaper to read
      // than %globaltimer at every claim): ns at the walk's mean rate
      const long long walk = (long long)(now_ns() - t0);
      const double ns_per_cycle = (double)walk / (double)(clock64() - c0);
      stat[STAT_WALK_NS] = walk;
      for (int i = STAT_WAIT_NS; i <= STAT_GLUE_NS; ++i)
        if (i != STAT_WALK_NS) stat[i] = (long long)((double)stat[i] * ns_per_cycle);
      for (int i = 0; i < STAT_HELPER_NS; ++i) W.stats[i] = stat[i];
    }
  }
}

// Free: P CTAs over one stage's queues, every product local.
template <bool TRACE>
__global__ void __launch_bounds__(UTHREADS, 1) ws_unified_free(WSQueues Q, UArgs A, Hand W) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WSShared sh;
  const UCtx C{A, W, false, true, nullptr, nullptr, smem, (int)blockIdx.x};
  ws_free<TRACE>(Q, sh, UnifiedTile{C, Q.mult});
}

// Dynamic shared memory of the tile bodies: the product's X chunk and
// partial sums, or a larger tile body, Put or router.
static size_t unified_smem(const UArgs& A) {
  size_t m = XS_FLOATS + RED_FLOATS;
  const size_t dec = A.dec_branch == BRANCH_DECODE
                         ? (size_t)UNW * (A.hd + 2)
                         : 2 * A.hd + (size_t)A.bk_d * (A.hd + 1) + A.bk_d + 3;
  const size_t fl = A.Lp ? 2 * (size_t)A.bq_p * A.hd + (size_t)A.bk_p * (A.hd + 1) +
                               (size_t)A.bq_p * A.bk_p + 3 * A.bq_p
                         : 0;
  m = m > dec ? m : dec;
  m = m > fl ? m : fl;
  if (A.E) {
    const size_t tk = (size_t)(A.B > A.Lp ? A.B : A.Lp) * A.k;
    const size_t pool = A.pool_dec > A.pool_pre ? A.pool_dec : A.pool_pre;
    const size_t put = 3 * tk + 3 * (size_t)A.E + 1 + pool;
    const size_t route = (size_t)(UTHREADS / 32) * (A.E + A.k);
    m = m > put ? m : put;
    m = m > route ? m : route;
  }
  return m * sizeof(float);
}

// ptrs: the 53 pointers of UArgs in declaration order; dims: its 28 ints;
// fdims: eps, theta, res_scale, scale; hand: the hand-off's words (cmd, then
// 2 x_words of X, y_words of Y, the done words, N_STATS stats) and fault (host
// memory, 4 ints); hdims: base, span, H, x_words, y_words, deadline_ns,
// mute; then the ring (null ev: untraced).  Lockstep with H > 0 launches
// 1 + H CTAs cooperatively, after checking that they fit on the card at
// once (cudaErrorCooperativeLaunchTooLarge when not, before any launch).
extern "C" int ws_unified_launch(
    int mode,
    const int* tasks, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const int* stage_open, void* const* ptrs, const int* dims, const float* fdims,
    void* hand, int* fault_word, const long long* hdims,
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
  A.ex = (float*)ptrs[i++];
  A.eg = (float*)ptrs[i++];
  A.eu = (float*)ptrs[i++];
  A.ey = (float*)ptrs[i++];
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
  A.dec_branch = dims[j++];
  A.eps = fdims[0];
  A.theta = fdims[1];
  A.res_scale = fdims[2];
  A.scale = fdims[3];
  Hand W;
  const long long x_words = hdims[3], y_words = hdims[4];
  W.base = (unsigned)hdims[0];
  W.span = (unsigned)hdims[1];
  W.H = mode == 0 ? (int)hdims[2] : 0;
  W.x_words = x_words;
  W.deadline_ns = (u64)hdims[5];
  W.mute = (int)hdims[6];
  W.fault = fault_word;
  W.cmd = (u64*)hand;
  W.x = W.cmd + 1;
  W.y = W.x + 2 * x_words;
  const int vocab_strips = (A.Vp + SW - 1) / SW;
  W.done = W.y + y_words;
  W.stats = (long long*)(W.done + vocab_strips);
  if (!hand) W.cmd = W.x = W.y = W.done = nullptr, W.stats = nullptr;
  if (W.H && !hand) return (int)cudaErrorInvalidValue;

  static void (*const kerns[4])(WSQueues, UArgs, Hand) = {
      ws_unified_lockstep<false>, ws_unified_free<false>, ws_unified_lockstep<true>,
      ws_unified_free<true>};
  void (*kern)(WSQueues, UArgs, Hand) = kerns[(Q.ev ? 2 : 0) + (mode == 0 ? 0 : 1)];
  // the walker's mirror after the bodies' floats: clock, scanned, work,
  // steals [P], head, remaining [n_queues], local_head [P, n_queues], mult
  // [n_tasks], tail and stage_open [n_queues]
  size_t smem = unified_smem(A);
  const size_t mirror =
      ((size_t)4 * Q.n_programs + 4 * Q.n_queues + (size_t)Q.n_programs * Q.n_queues + Q.n_tasks) *
      sizeof(int);
  W.mirror_at = -1;
  if (mode == 0 && stage_open && smem + mirror <= MAX_SMEM) {
    W.mirror_at = (int)(smem / sizeof(float));
    smem += mirror;
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mode == 0 ? 1 + W.H : Q.n_programs);
  cfg.blockDim = dim3(UTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  if (W.H) {
    int dev = 0, sms = 0, per = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, UTHREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if ((long long)per * sms < 1 + W.H) return (int)cudaErrorCooperativeLaunchTooLarge;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kern, Q, A, W);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
