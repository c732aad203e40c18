// Fence-free work-stealing attention megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/pallas_ws/kernel.py: the scheduler shell
// `_generic_ws_kernel` (with `ws_try_extract`, `_probe_slot`, `ws_account`),
// launched by `launch_ws_grid`, around the attention tile body
// `_attention_execute` (reached through `run_ws_schedule`).
//
// What it computes.  WS-WMULT extraction (paper Fig. 7) over HBM-resident
// queue arrays, then a flash/decode attention tile of `bq` query rows of head
// `h` against GQA kv head `h / g`: an online softmax over `cost` kv blocks of
// `bk`, masks `kpos < kv_end` (and `kpos <= qpos` for causal tiles), rows at
// or past `q_len` zeroed, fp32 arithmetic over fp32 or bf16 inputs.
//
// Two modes.
//  * lockstep (mode 0): the reference's semantics, the order of Pallas
//    interpret mode.  ONE CTA walks the (rounds, P) grid serially, program
//    index innermost; its threads share the tile math.  Every integer array
//    (head, local_head, taken, remaining, clock, work, steals, scanned, mult)
//    ends bit-equal to the reference; `out` accumulates tile x mult.
//  * free (mode 1): the paper's setting.  P persistent CTAs run concurrently;
//    each loops Take/Steal by the same policy until an extraction fails,
//    which happens exactly when its view max(local_head[p,v], head[v]) >=
//    tail[v] holds for every queue it may probe (a slot below tail always
//    holds a live record).  Two writes of the reference would lose updates
//    between concurrent CTAs, so they change form: every execution does a
//    plain store of its whole normalised tile (idempotent: duplicates write
//    the same bits), and multiplicity goes into per-program rows
//    mult[P, n_tasks] that the wrapper sums.  A free-mode `out` is already
//    normalised and must not be divided by mult again.  clock[p] is the sum
//    of the costs program p executed.
//
// Fence-free.  head, local_head, taken and remaining are touched only by
// volatile global loads and stores.  There is no atomic, no fence, no
// membar: thread 0 of a CTA runs the scheduler and hands its decision to the
// other threads through shared memory and __syncthreads().
//
// What bounds it on this card.  Decode attention reads each live K/V row
// once and does ~4 flops per element: it is bound by bytes (HBM at
// 3.35 TB/s).  This first version is simple, not fast: one tile per CTA at a
// time, K/V staged through shared memory by plain loads, fp32 dot products
// on CUDA cores, no sharing of a K/V block between the g query heads of one
// kv head, and at most P CTAs busy.  cp.async/TMA staging, several tiles per
// CTA and GQA sharing are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define BOTTOM (-1)
#define TASK_WIDTH 8
#define F_OP 0
#define F_B 1
#define F_H 2
#define F_QS 3
#define F_QL 4
#define F_KV 5
#define F_TID 6
#define F_COST 7
#define NEG_INF (-1e30f)
#define NTHREADS 128

struct Params {
  const int* tasks;          // [n_queues, capacity, TASK_WIDTH]
  const int* tail;           // [n_queues]
  volatile int* head;        // [n_queues]
  volatile int* local_head;  // [n_programs, n_queues]
  volatile int* taken;       // [n_queues, capacity]
  volatile int* remaining;   // [n_queues]
  int* clock;                // [n_programs]
  int* work;
  int* steals;
  int* scanned;
  int* mult;                 // lockstep [n_tasks]; free [n_programs, n_tasks]
  const void* q;             // [B, H, Sq, hd] by strides
  const void* k;             // [B, Hkv, Sk, hd] by strides
  const void* v;
  float* out;                // [B, H, Sq_out, hd] contiguous fp32
  long long q_sb, q_sh, q_ss, q_sd;
  long long k_sb, k_sh, k_ss, k_sd;
  long long v_sb, v_sh, v_ss, v_sd;
  int n_queues, capacity, n_programs, n_tasks, rounds;
  int steal, policy, compress, causal;
  int H, Sq, Sq_out, Sk, hd, g, bq, bk;
  float scale;
};

struct Claim {
  int found, fq, fs, nread;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// scheduler (thread 0 only)

__device__ __forceinline__ int rmax_read(const Params& P, int p, int v) {
  int lh = P.local_head[p * P.n_queues + v];
  int hv = P.head[v];
  return lh > hv ? lh : hv;
}

// Guarded ⊥-probe: the op field is loaded only when wanted and h < capacity.
__device__ __forceinline__ int probe(const Params& P, int v, int h, bool want,
                                     int* issued) {
  bool issue = want && (h < P.capacity);
  *issued = issue ? 1 : 0;
  return issue ? P.tasks[((long long)v * P.capacity + h) * TASK_WIDTH + F_OP]
               : BOTTOM;
}

__device__ __forceinline__ void claim_writes(const Params& P, int p, int v, int h) {
  P.head[v] = h + 1;                        // plain write, no CAS
  P.local_head[p * P.n_queues + v] = h + 1; // persistent local bound
}

// "scan" policy: p-relative sequential scan over every queue.
__device__ Claim scan_extract(const Params& P, int p) {
  Claim c = {0, 0, 0, 0};
  int n_scan = P.steal ? P.n_queues : 1;
  for (int j = 0; j < n_scan; ++j) {
    int v = (p + j) % P.n_queues;
    int h = rmax_read(P, p, v);
    int issued;
    int op = probe(P, v, h, !c.found, &issued);
    bool live = op != BOTTOM;
    if (!c.found && live) {
      claim_writes(P, p, v, h);
      c.fq = v;
      c.fs = h;
    }
    c.found = c.found || live;
    c.nread += issued;
  }
  return c;
}

// "cost" policy: own-queue probe, then the first-index argmax of
// max(remaining, 1) over queues whose head view is below their tail.
__device__ Claim cost_extract(const Params& P, int p) {
  int own = p % P.n_queues;
  int h0 = rmax_read(P, p, own);
  int issued0;
  int op0 = probe(P, own, h0, true, &issued0);
  bool own_live = op0 != BOTTOM;
  if (own_live) claim_writes(P, p, own, h0);
  if (!P.steal) {
    Claim c = {own_live ? 1 : 0, own, h0, issued0};
    return c;
  }
  int best_v = 0, best = 0, best_h = 0;
  for (int v = 0; v < P.n_queues; ++v) {
    int h = rmax_read(P, p, v);
    int rem = P.remaining[v];
    int score = (h < P.tail[v]) ? (rem > 1 ? rem : 1) : 0;
    if (v == 0 || score > best) {
      best = score;
      best_v = v;
      best_h = h;
    }
  }
  bool can = !own_live && best > 0;
  int issued;
  int op = probe(P, best_v, best_h, can, &issued);
  bool live = can && op != BOTTOM;
  if (live) claim_writes(P, p, best_v, best_h);
  Claim c;
  c.found = (own_live || live) ? 1 : 0;
  c.fq = own_live ? own : best_v;
  c.fs = own_live ? h0 : best_h;
  c.nread = issued0 + issued;
  return c;
}

__device__ __forceinline__ Claim extract(const Params& P, int p) {
  return P.policy == 1 ? scan_extract(P, p) : cost_extract(P, p);
}

// Bookkeeping after an execution (ws_account).  Returns the task's cost.
__device__ int account(const Params& P, int r, int p, int fq, int fs,
                       bool advisory, bool free_mode) {
  const int* rec = P.tasks + ((long long)fq * P.capacity + fs) * TASK_WIDTH;
  int tid = rec[F_TID];
  int cost = rec[F_COST];
  if (free_mode) {
    P.mult[(long long)p * P.n_tasks + tid] += 1;  // this program's row only
  } else {
    P.mult[tid] += 1;
  }
  P.taken[(long long)fq * P.capacity + fs] = p;
  if (advisory) {
    int rem = P.remaining[fq] - cost;            // plain read + plain write
    P.remaining[fq] = rem > 0 ? rem : 0;
  }
  P.work[p] += cost;
  P.steals[p] += (fq != p % P.n_queues) ? 1 : 0;
  if (free_mode) {
    P.clock[p] += cost;
  } else {
    int c = P.clock[p];
    P.clock[p] = (c > r ? c : r) + cost;
  }
  return cost;
}

// ---------------------------------------------------------------------------
// attention tile (all threads)

template <typename T>
__device__ void execute_tile(const Params& P, float* smem, const int* rec,
                             bool store) {
  const int b = rec[F_B], h = rec[F_H], qs = rec[F_QS], ql = rec[F_QL];
  const int kv_end = rec[F_KV], cost = rec[F_COST];
  const int kh = h / P.g;
  const int hd = P.hd, bq = P.bq, bk = P.bk;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* sq = smem;              // [bq, hd]
  float* sacc = sq + bq * hd;    // [bq, hd]
  float* skv = sacc + bq * hd;   // [bk, hd]  K block, then V block
  float* ss = skv + bk * hd;     // [bq, bk]  scores, then probabilities
  float* sm = ss + bq * bk;      // [bq] running max
  float* sl = sm + bq;           // [bq] running sum
  float* scorr = sl + bq;        // [bq] rescale of this block
  const T* qp = (const T*)P.q + (long long)b * P.q_sb + (long long)h * P.q_sh;
  const T* kp = (const T*)P.k + (long long)b * P.k_sb + (long long)kh * P.k_sh;
  const T* vp = (const T*)P.v + (long long)b * P.v_sb + (long long)kh * P.v_sh;

  for (int e = tid; e < bq * hd; e += nt) {
    int i = e / hd, d = e % hd;
    int qpos = qs + i;
    sq[e] = qpos < P.Sq ? to_f(qp[(long long)qpos * P.q_ss + (long long)d * P.q_sd]) : 0.f;
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
      skv[e] = kpos < P.Sk ? to_f(kp[(long long)kpos * P.k_ss + (long long)d * P.k_sd]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < bq * bk; e += nt) {
      int i = e / bk, j = e % bk;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc += sq[i * hd + d] * skv[j * hd + d];
      float s = acc * P.scale;
      int kpos = k0 + j;
      bool valid = kpos < kv_end;
      if (P.causal) valid = valid && (kpos <= qs + i);
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
      skv[e] = kpos < P.Sk ? to_f(vp[(long long)kpos * P.v_ss + (long long)d * P.v_sd]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < bq * hd; e += nt) {
      int i = e / hd, d = e % hd;
      float a = 0.f;
      for (int j = 0; j < bk; ++j) a += ss[i * bk + j] * skv[j * hd + d];
      sacc[e] = sacc[e] * scorr[i] + a;
    }
    __syncthreads();
  }

  for (int e = tid; e < bq * hd; e += nt) {
    int i = e / hd, d = e % hd;
    float t = sacc[e] / fmaxf(sl[i], 1e-30f);
    if (i >= ql) t = 0.f;
    long long o = (((long long)b * P.H + h) * P.Sq_out + qs + i) * hd + d;
    if (store) {
      P.out[o] = t;   // free: idempotent plain store of the whole tile
    } else {
      P.out[o] += t;  // lockstep: one CTA, accumulate tile x mult
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void load_record(const Params& P, int fq, int fs, int* s_rec) {
  const int* rec = P.tasks + ((long long)fq * P.capacity + fs) * TASK_WIDTH;
  for (int f = 0; f < TASK_WIDTH; ++f) s_rec[f] = rec[f];
}

// ---------------------------------------------------------------------------
// kernels

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ws_lockstep_kernel(Params P) {
  extern __shared__ float smem[];
  __shared__ int s_found, s_fq, s_fs, s_rec[TASK_WIDTH];
  const bool t0 = threadIdx.x == 0;
  for (int r = 0; r < P.rounds; ++r) {
    for (int p = 0; p < P.n_programs; ++p) {
      if (P.compress) {
        // Round compression (no thieves): an idle owner drains its whole
        // queue inside this cell, with one coalesced advisory write.
        const int own = p % P.n_queues;
        bool idle = false;
        int total = 0;
        if (t0) {
          idle = P.clock[p] <= r;
          s_found = 0;
          if (idle) {
            int h = rmax_read(P, p, own);
            int issued;
            int op = probe(P, own, h, true, &issued);
            P.scanned[p] += issued;
            s_found = op != BOTTOM;
            s_fq = own;
            s_fs = h;
            if (s_found) load_record(P, own, h, s_rec);
          }
        }
        __syncthreads();
        while (s_found) {
          if (t0) claim_writes(P, p, own, s_fs);
          execute_tile<T>(P, smem, s_rec, false);
          if (t0) {
            total += account(P, r, p, own, s_fs, false, false);
            int h = rmax_read(P, p, own);
            int issued;
            int op = probe(P, own, h, true, &issued);
            P.scanned[p] += issued;
            s_found = op != BOTTOM;
            s_fs = h;
            if (s_found) load_record(P, own, h, s_rec);
          }
          __syncthreads();
        }
        if (t0 && idle && total > 0) {
          int rem = P.remaining[own] - total;
          P.remaining[own] = rem > 0 ? rem : 0;
        }
        __syncthreads();
      } else {
        if (t0) {
          Claim c = {0, 0, 0, 0};
          if (P.clock[p] <= r) c = extract(P, p);
          P.scanned[p] += c.nread;
          s_found = c.found;
          s_fq = c.fq;
          s_fs = c.fs;
          if (c.found) load_record(P, c.fq, c.fs, s_rec);
        }
        __syncthreads();
        if (s_found) {
          execute_tile<T>(P, smem, s_rec, false);
          if (t0) account(P, r, p, s_fq, s_fs, true, false);
        }
        __syncthreads();
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ws_free_kernel(Params P) {
  extern __shared__ float smem[];
  __shared__ int s_found, s_fq, s_fs, s_rec[TASK_WIDTH];
  const int p = blockIdx.x;
  const bool t0 = threadIdx.x == 0;
  while (true) {
    if (t0) {
      Claim c = extract(P, p);
      P.scanned[p] += c.nread;
      s_found = c.found;
      s_fq = c.fq;
      s_fs = c.fs;
      if (c.found) load_record(P, c.fq, c.fs, s_rec);
    }
    __syncthreads();
    if (!s_found) break;  // this program's view: every queue drained
    execute_tile<T>(P, smem, s_rec, true);
    if (t0) account(P, 0, p, s_fq, s_fs, true, true);
    __syncthreads();
  }
}

template <typename T>
static int launch(const Params& P, int mode, size_t smem, cudaStream_t stream) {
  void (*kern)(Params) = mode == 0 ? ws_lockstep_kernel<T> : ws_free_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(mode == 0 ? 1 : P.n_programs);
  kern<<<grid, NTHREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int ws_attention_launch(
    int mode, int dtype,
    const int* tasks, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    const void* q, const void* k, const void* v, float* out,
    const long long* strides,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int compress, int causal,
    int H, int Sq, int Sq_out, int Sk, int hd, int g, int bq, int bk,
    float scale, void* stream) {
  Params P;
  P.tasks = tasks;
  P.tail = tail;
  P.head = head;
  P.local_head = local_head;
  P.taken = taken;
  P.remaining = remaining;
  P.clock = clock;
  P.work = work;
  P.steals = steals;
  P.scanned = scanned;
  P.mult = mult;
  P.q = q;
  P.k = k;
  P.v = v;
  P.out = out;
  P.q_sb = strides[0]; P.q_sh = strides[1]; P.q_ss = strides[2]; P.q_sd = strides[3];
  P.k_sb = strides[4]; P.k_sh = strides[5]; P.k_ss = strides[6]; P.k_sd = strides[7];
  P.v_sb = strides[8]; P.v_sh = strides[9]; P.v_ss = strides[10]; P.v_sd = strides[11];
  P.n_queues = n_queues;
  P.capacity = capacity;
  P.n_programs = n_programs;
  P.n_tasks = n_tasks;
  P.rounds = rounds;
  P.steal = steal;
  P.policy = policy;
  P.compress = compress;
  P.causal = causal;
  P.H = H;
  P.Sq = Sq;
  P.Sq_out = Sq_out;
  P.Sk = Sk;
  P.hd = hd;
  P.g = g;
  P.bq = bq;
  P.bk = bk;
  P.scale = scale;
  size_t smem = (size_t)(2 * bq * hd + bk * hd + bq * bk + 3 * bq) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(P, mode, smem, s);
  return launch<float>(P, mode, smem, s);
}
