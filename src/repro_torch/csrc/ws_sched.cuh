// Fence-free WS-WMULT scheduler shared by the port's megakernels (sm_90a).
//
// Replaces the scheduler shell of repro/pallas_ws/kernel.py:
// `_generic_ws_kernel` with `ws_try_extract`, `_probe_slot` and `ws_account`
// (the `pallas_call` of `launch_ws_grid`).  A kernel supplies the tile body;
// both walks below are templates over it, so every kernel runs the same
// scheduler code.
//
// Two walks.
//  * lockstep (mode 0): the reference's semantics, the order of Pallas
//    interpret mode.  ONE CTA walks the (rounds, P) grid serially, program
//    index innermost; its threads share the tile math.  Every integer array
//    (head, local_head, taken, remaining, clock, work, steals, scanned, mult)
//    ends bit-equal to the reference; the tile body accumulates.
//  * free (mode 1): the paper's setting.  P persistent CTAs run concurrently;
//    each loops Take/Steal by the same policy until an extraction fails,
//    which happens exactly when its view max(local_head[p,v], head[v]) >=
//    tail[v] holds for every queue it may probe (a slot below tail always
//    holds a live record).  Two writes of the reference would lose updates
//    between concurrent CTAs, so they change form: the tile body makes a
//    plain store of its whole tile (idempotent: duplicates write the same
//    bits), and multiplicity goes into per-program rows mult[P, n_tasks]
//    that the wrapper sums.  clock[p] is the sum of the costs program p ran.
//
// Two queue layouts (the reference's `_slot_field`/`_probe_slot`).  Dense:
// slot (q, s) is tasks[q, s] and taken[q, s], and a probe issues only while
// s < capacity.  Shared pool (pool_off != null): queue q owns the contiguous
// pool segment [pool_off[q], pool_off[q] + tail[q]), slot (q, s) is
// tasks[pool_off[q] + s] and taken[pool_off[q] + s], and a probe issues only
// while s < tail[q]: a read past tail would land in the next queue's
// segment, a wrong task and not a fault, so it must never issue.
//
// Stage gate (stage_open != null, lockstep only): queue v is invisible to
// every probe and to the victim scan until round stage_open[v], the
// reference's `stage_ref[v] <= r` (the unified engine step's Graham stage
// windows).  stage_open is nondecreasing (stage-major queues).
//
// Victim window (lockstep).  The cost policy's victim scan covers [lo, hi):
// the single walker's heads only grow, so a queue with head >= tail is
// drained for every view and stays so (lo skips past it), and queues from
// hi on are not open yet.  Neither can score, so the first-index argmax and
// every count are those of the full scan; a step of the unified walk then
// scans one stage's queues, not all 2 + 3L stages'.
//
// Fence-free.  head, local_head, taken and remaining are touched only by
// volatile global loads and stores (plain ones in a lockstep walk that owns
// them: WSQueuesOwned below).  There is no atomic, no fence, no membar:
// thread 0 of a CTA runs the scheduler and hands its decision to the other
// threads through shared memory and __syncthreads().
//
// A tile body is a callable `body(const int* rec, bool store)` run by every
// thread of the CTA with the claimed record in shared memory; `store` is
// true in free mode.  It must end with __syncthreads() before it returns.
//
// Event rings (the reference's `trace_append`).  Both walks and `account`
// take a compile-time TRACE flag; every kernel instantiates both and its
// entry point picks one by whether the rings are given.  TRACE = false is
// the untraced code and never reads the ring fields of WSQueues.  TRACE =
// true: after `account`, thread 0 of the claiming CTA writes one 11-field
// record (wstrace/ring.py) to row [p, cursor] of its ring with volatile
// stores, guarded by cursor < ev_cap, then bumps the cursor with a plain
// store, so it keeps counting past capacity and the host knows the drops.
// Each program writes its own row only; there is no atomic and no fence.
//  * lockstep: EV_ROUND = max(clock[p], r) before the bump, EV_MULT =
//    mult[tid] after it, as the reference; compressed drains trace every
//    claim of the run.
//  * free (no rounds): EV_ROUND = clock[p] before the bump, the tile-slots
//    the program ran so far plus its stall, so [round, round + cost) is its
//    busy interval on its own clock; EV_MULT = the carried ev_mult0[tid]
//    plus this program's row (the other rows cannot be read without a
//    race).  The traced free walk also models the fault plans: a CTA whose
//    initial clock is a stall of k tile-slots sleeps k * stall_ns before its
//    first probe, and a positive `rounds` is a budget: a CTA stops once its
//    clock reaches it (the kill segments of chaos/inject.py).
//
// Rotated ties (ROT, the expert kernels' free walks only).  The cost
// policy's victim argmax visits the queues from v0 = p * n_queues / P on,
// wrapping, and a later queue replaces the best only with a strictly larger
// score: the first index in p's rotation wins a tie.  With the reference's
// first-index order every idle program reads the same advisories and picks
// the same victim and slot (decode-time expert queues hold one tile each,
// so every score is 1); rotated, equal scores send thieves to different
// queues.  ROT = false (every lockstep walk, every other kernel) is the
// reference's order and its code.
//
// Half-run Steal (the reference's `steal_run_cap > 1`, `_execute_run`).  Both
// walks and the cost policy's claim take a compile-time HALFRUN flag; the
// three kernels whose reference entry points admit the cap instantiate both,
// and the entry point picks by run_cap > 1 (ws_unified never instantiates
// the half-run walk: the reference refuses it with stage_open).  HALFRUN =
// false is the per-slot code and never reads run_cap.  HALFRUN = true: when
// the own-queue probe misses and the argmax victim v at view h is live, the
// thief claims take = clip((tail[v] - h + 1) / 2, 1, run_cap) contiguous
// slots [h, h + take) with one plain store to each bound (head[v] and
// local_head[p, v] = h + take).  The single probe of slot h certifies the
// whole run: every slot below tail[v] holds a live record.  The claiming CTA
// then runs the run's slots back to back, each accounted on its own
// (mult, taken, work, clock, steals and its own ring record, EV_RUN = take)
// with no advisory write, and after the run makes one clamped write
// remaining[fq] = max(remaining[fq] - total, 0).  Takes keep run = 1.  In free
// mode a traced budget is checked per extraction, so a run may overshoot it
// by run_cap - 1 slots.  A stale head now re-arms up to run_cap slots per
// collision; each program still claims a slot at most once per launch (its
// local_head row only grows, now by take).

#pragma once

#include <type_traits>

#include <cuda_runtime.h>

#define BOTTOM (-1)
#define TASK_WIDTH 8
#define F_OP 0
#define F_TID 6
#define F_COST 7

// wstrace/ring.py
#define EVENT_WIDTH 11
#define KIND_TAKE 0
#define KIND_STEAL_REMOTE 3

struct WSQueues {
  const int* tasks;          // dense [n_queues, capacity, TASK_WIDTH]; pool [capacity, TASK_WIDTH]
  const int* pool_off;       // pool [n_queues + 1] segment offsets; dense null
  const int* stage_open;     // [n_queues] open round of each queue; null when ungated
  const int* tail;           // [n_queues]
  volatile int* head;        // [n_queues]
  volatile int* local_head;  // [n_programs, n_queues]
  volatile int* taken;       // dense [n_queues, capacity]; pool [capacity]
  volatile int* remaining;   // [n_queues]
  int* clock;                // [n_programs]
  int* work;
  int* steals;
  int* scanned;
  int* mult;                 // lockstep [n_tasks]; free [n_programs, n_tasks]
  int n_queues, capacity, n_programs, n_tasks, rounds;
  int steal, policy, compress;
  // event rings (read by the traced instantiation only)
  volatile int* ev;          // [n_programs, ev_cap, EVENT_WIDTH]
  volatile int* ev_cursor;   // [n_programs] appends attempted
  const int* ev_mult0;       // free mode: the carried mult [n_tasks]; else null
  int ev_cap, steal_kind, stall_ns;
  int run_cap;               // half-run cap (read by the HALFRUN instantiation only)
};

// The same arrays as a lockstep walker that alone touches them sees them:
// head, local_head, taken and remaining through plain pointers, which may
// point at copies in its shared memory.  In lockstep one thread of one CTA
// reads and writes every queue array, in program order, so plain accesses
// see what volatile ones would; ws_unified's walker takes this view (its
// helpers read none of these arrays).  Every scheduler function below is a
// template over the view, WSQueues or WSQueuesOwned.
struct WSQueuesOwned {
  const int* tasks;
  const int* pool_off;
  const int* stage_open;
  const int* tail;
  int* head;
  int* local_head;
  int* taken;
  int* remaining;
  int* clock;
  int* work;
  int* steals;
  int* scanned;
  int* mult;
  int n_queues, capacity, n_programs, n_tasks, rounds;
  int steal, policy, compress;
  volatile int* ev;
  volatile int* ev_cursor;
  const int* ev_mult0;
  int ev_cap, steal_kind, stall_ns;
  int run_cap;
};

__device__ __forceinline__ WSQueuesOwned owned(const WSQueues& Q) {
  return {Q.tasks, Q.pool_off, Q.stage_open, Q.tail, (int*)Q.head, (int*)Q.local_head,
          (int*)Q.taken, (int*)Q.remaining, Q.clock, Q.work, Q.steals, Q.scanned, Q.mult,
          Q.n_queues, Q.capacity, Q.n_programs, Q.n_tasks, Q.rounds, Q.steal, Q.policy,
          Q.compress, Q.ev, Q.ev_cursor, Q.ev_mult0, Q.ev_cap, Q.steal_kind, Q.stall_ns,
          Q.run_cap};
}

// The scheduler's hand-off to the CTA's threads (one per CTA, in shared memory).
struct WSShared {
  int found, fq, fs;
  int rec[TASK_WIDTH];
  int run;                   // slots of the claimed run (HALFRUN walks)
};

struct Claim {
  int found, fq, fs, nread;
};

// The HALFRUN walks' claim: the run's length too (1 for Takes).  A type of
// its own, so the per-slot walks keep their Claim: a fifth field in Claim
// alone moved a per-slot kernel's SASS (ws_lockstep_kernel<bf16>, 8 fewer
// instructions), even in a file without the half-run kernels.
struct RunClaim : Claim {
  int run;
};

template <bool HALFRUN>
using ClaimT = typename std::conditional<HALFRUN, RunClaim, Claim>::type;

// ---------------------------------------------------------------------------
// scheduler (thread 0 only)

template <class QT>
__device__ __forceinline__ int rmax_read(const QT& Q, int p, int v) {
  int lh = Q.local_head[p * Q.n_queues + v];
  int hv = Q.head[v];
  return lh > hv ? lh : hv;
}

// Flat index of slot (v, s) in tasks (records) and taken, in either layout.
template <class QT>
__device__ __forceinline__ long long slot_index(const QT& Q, int v, int s) {
  return Q.pool_off ? (long long)Q.pool_off[v] + s : (long long)v * Q.capacity + s;
}

// Guarded ⊥-probe: the op field is loaded only when wanted and the slot is
// meaningful: h < capacity (dense) or h < tail[v] (pool).
template <class QT>
__device__ __forceinline__ int probe(const QT& Q, int v, int h, bool want, int* probed) {
  bool fire = want && (Q.pool_off ? h < Q.tail[v] : h < Q.capacity);
  *probed = fire ? 1 : 0;
  return fire ? Q.tasks[slot_index(Q, v, h) * TASK_WIDTH + F_OP] : BOTTOM;
}

template <class QT>
__device__ __forceinline__ void claim_writes(const QT& Q, int p, int v, int h, int take = 1) {
  Q.head[v] = h + take;                        // plain write, no CAS
  Q.local_head[p * Q.n_queues + v] = h + take; // persistent local bound
}

template <class QT>
__device__ __forceinline__ bool is_open(const QT& Q, int v, int r) {
  return Q.stage_open == nullptr || Q.stage_open[v] <= r;
}

// "scan" policy: p-relative sequential scan over every queue.
template <class QT>
__device__ Claim scan_extract(const QT& Q, int p, int r) {
  Claim c = {0, 0, 0, 0};
  int n_scan = Q.steal ? Q.n_queues : 1;
  for (int j = 0; j < n_scan; ++j) {
    int v = (p + j) % Q.n_queues;
    int h = rmax_read(Q, p, v);
    int probed;
    int op = probe(Q, v, h, !c.found && is_open(Q, v, r), &probed);
    bool live = op != BOTTOM;
    if (!c.found && live) {
      claim_writes(Q, p, v, h);
      c.fq = v;
      c.fs = h;
    }
    c.found = c.found || live;
    c.nread += probed;
  }
  return c;
}

// "cost" policy: own-queue probe, then the first-index argmax of
// max(remaining, 1) over open queues of [lo, hi) whose head view is below
// their tail.  HALFRUN: a steal claims the half-run of the victim.  ROT:
// the argmax visits every queue in p's rotation; ROT walks are free walks,
// whose [lo, hi) is every queue and which have no stage gate (launch_grid
// refuses stage_open in free mode), so it reads no stage_open.
template <bool HALFRUN, bool ROT = false, class QT>
__device__ ClaimT<HALFRUN> cost_extract(const QT& Q, int p, int r, int lo, int hi) {
  int own = p % Q.n_queues;
  int h0 = rmax_read(Q, p, own);
  int probed0;
  int op0 = probe(Q, own, h0, is_open(Q, own, r), &probed0);
  bool own_live = op0 != BOTTOM;
  if (own_live) claim_writes(Q, p, own, h0);
  if (!Q.steal) {
    ClaimT<HALFRUN> c{};
    c.found = own_live ? 1 : 0;
    c.fq = own;
    c.fs = h0;
    c.nread = probed0;
    if constexpr (HALFRUN) c.run = 1;
    return c;
  }
  int best_v = 0, best = 0, best_h = 0;
  if constexpr (ROT) {
    const int n = Q.n_queues;
    int v = (int)((long long)p * n / Q.n_programs);
    for (int j = 0; j < n; ++j, v = v + 1 == n ? 0 : v + 1) {
      int h = rmax_read(Q, p, v);
      int rem = Q.remaining[v];
      int score = h < Q.tail[v] ? (rem > 1 ? rem : 1) : 0;
      if (j == 0 || score > best) {
        best = score;
        best_v = v;
        best_h = h;
      }
    }
  } else {
    for (int v = lo; v < hi; ++v) {
      int h = rmax_read(Q, p, v);
      int rem = Q.remaining[v];
      int score = (h < Q.tail[v] && is_open(Q, v, r)) ? (rem > 1 ? rem : 1) : 0;
      if (v == lo || score > best) {
        best = score;
        best_v = v;
        best_h = h;
      }
    }
  }
  bool can = !own_live && best > 0;
  int probed;
  int op = probe(Q, best_v, best_h, can, &probed);
  bool live = can && op != BOTTOM;
  int take = 1;
  if constexpr (HALFRUN) {
    if (live) {
      // rem >= 1: the victim passed the view < tail test
      const int half = (Q.tail[best_v] - best_h + 1) / 2;
      take = half < 1 ? 1 : (half > Q.run_cap ? Q.run_cap : half);
    }
  }
  if (live) claim_writes(Q, p, best_v, best_h, take);
  ClaimT<HALFRUN> c;
  c.found = (own_live || live) ? 1 : 0;
  c.fq = own_live ? own : best_v;
  c.fs = own_live ? h0 : best_h;
  c.nread = probed0 + probed;
  if constexpr (HALFRUN) c.run = live ? take : 1;
  return c;
}

// The half-run walks take the cost policy only (ws_launch refuses the rest).
template <bool HALFRUN, bool ROT = false, class QT>
__device__ __forceinline__ ClaimT<HALFRUN> extract(const QT& Q, int p, int r, int lo, int hi) {
  if constexpr (HALFRUN) {
    return cost_extract<true, ROT>(Q, p, r, lo, hi);
  } else {
    return Q.policy == 1 ? scan_extract(Q, p, r) : cost_extract<false, ROT>(Q, p, r, lo, hi);
  }
}

// One record into program p's ring row (trace_append).
template <class QT>
__device__ __forceinline__ void trace_append(const QT& Q, int p, int fq, int fs, const int* rec,
                                             int t0, int m, int run) {
  const bool is_steal = fq != p % Q.n_queues;
  const int kind = Q.steal_kind == KIND_STEAL_REMOTE ? KIND_STEAL_REMOTE
                   : (is_steal ? Q.steal_kind : KIND_TAKE);
  const int c = Q.ev_cursor[p];
  if (c < Q.ev_cap) {
    volatile int* e = Q.ev + ((long long)p * Q.ev_cap + c) * EVENT_WIDTH;
    e[0] = t0;                                             // EV_ROUND
    e[1] = p;                                              // EV_PROG
    e[2] = fq;                                             // EV_QUEUE
    e[3] = fs;                                             // EV_SLOT
    e[4] = rec[F_TID];                                     // EV_TID
    e[5] = rec[F_COST];                                    // EV_COST
    e[6] = kind;                                           // EV_KIND
    e[7] = (is_steal && fq < Q.n_programs) ? fq : -1;      // EV_VICTIM
    e[8] = m;                                              // EV_MULT
    e[9] = rec[F_OP];                                      // EV_OP
    e[10] = run;                                           // EV_RUN
  }
  Q.ev_cursor[p] = c + 1;
}

// Bookkeeping after an execution (ws_account).  Returns the task's cost.
template <class QT>
__device__ int ws_account(const QT& Q, int r, int p, int fq, int fs, bool advisory,
                          bool free_mode) {
  const long long slot = slot_index(Q, fq, fs);
  const int* rec = Q.tasks + slot * TASK_WIDTH;
  int tid = rec[F_TID];
  int cost = rec[F_COST];
  if (free_mode) {
    Q.mult[(long long)p * Q.n_tasks + tid] += 1;  // this program's row only
  } else {
    Q.mult[tid] += 1;
  }
  Q.taken[slot] = p;
  if (advisory) {
    int rem = Q.remaining[fq] - cost;            // plain read + plain write
    Q.remaining[fq] = rem > 0 ? rem : 0;
  }
  Q.work[p] += cost;
  Q.steals[p] += (fq != p % Q.n_queues) ? 1 : 0;
  if (free_mode) {
    Q.clock[p] += cost;
  } else {
    int c = Q.clock[p];
    Q.clock[p] = (c > r ? c : r) + cost;
  }
  return cost;
}

// ws_account, then the ring append when TRACE (the reference's account);
// `run` is the claimed run's length, the record's EV_RUN.  The untraced
// instantiation is the call to ws_account alone.
template <bool TRACE, class QT>
__device__ __forceinline__ int account(const QT& Q, int r, int p, int fq, int fs, bool advisory,
                                       bool free_mode, int run = 1) {
  if constexpr (!TRACE) {
    return ws_account(Q, r, p, fq, fs, advisory, free_mode);
  } else {
    const int c = Q.clock[p];
    const int t0 = free_mode ? c : (c > r ? c : r);  // the start, before the bump
    const int cost = ws_account(Q, r, p, fq, fs, advisory, free_mode);
    const int* rec = Q.tasks + slot_index(Q, fq, fs) * TASK_WIDTH;
    const int tid = rec[F_TID];
    const int m = free_mode ? (Q.ev_mult0 ? Q.ev_mult0[tid] : 0) +
                                  Q.mult[(long long)p * Q.n_tasks + tid]
                            : Q.mult[tid];
    trace_append(Q, p, fq, fs, rec, t0, m, run);
    return cost;
  }
}

template <class QT>
__device__ __forceinline__ void load_record(const QT& Q, int fq, int fs, int* s_rec) {
  const int* rec = Q.tasks + slot_index(Q, fq, fs) * TASK_WIDTH;
  for (int f = 0; f < TASK_WIDTH; ++f) s_rec[f] = rec[f];
}

// ---------------------------------------------------------------------------
// walks (all threads)

// The claimed run's slots (sh.fq, sh.fs + i), i < sh.run, back to back in this
// CTA (the reference's `_execute_run`): each accounted on its own without the
// advisory write, then one clamped advisory write for the run.  Entered with
// the first slot's record in sh.rec; every thread reads sh.run, which no one
// writes during the run.
template <bool TRACE, class QT, class Body>
__device__ __forceinline__ void run_slots(const QT& Q, WSShared& sh, const Body& body, int r,
                                          int p, bool free_mode) {
  const bool t0 = threadIdx.x == 0;
  int total = 0;
  for (int i = 0; i < sh.run; ++i) {
    if (i > 0) {
      if (t0) load_record(Q, sh.fq, sh.fs + i, sh.rec);
      __syncthreads();
    }
    body(sh.rec, free_mode);
    if (t0) total += account<TRACE>(Q, r, p, sh.fq, sh.fs + i, false, free_mode, sh.run);
  }
  if (t0) {
    int rem = Q.remaining[sh.fq] - total;  // plain read + plain write
    Q.remaining[sh.fq] = rem > 0 ? rem : 0;
  }
}

// The per-slot lockstep walk of a walker that owns its queue arrays
// (WSQueuesOwned): thread 0 runs every cell's scheduler code in
// ws_lockstep's order, with the same loads and stores (a busy program's
// cell adds 0 to scanned, which it leaves out), but passes the cells that
// claim nothing alone, and wakes the CTA only for a claim (the tile body,
// then its account).  Every array and ring ends as the loop below leaves
// them; the CTA's barriers go from two a cell to two a claim.
template <bool TRACE, class Body>
__device__ void owned_lockstep(const WSQueuesOwned& Q, WSShared& sh, const Body& body) {
  const bool t0 = threadIdx.x == 0;
  int lo = 0, hi = Q.stage_open ? 0 : Q.n_queues;  // thread 0's victim window
  int r = 0, p = 0;                                // thread 0's next cell
  int cr = 0, cp = 0;                              // thread 0's claiming cell
  const int P = Q.n_programs, rounds = Q.rounds;
  const int* const clock = Q.clock;
  while (true) {
    if (t0) {
      sh.found = 0;
      while (!sh.found && r < rounds) {
        if (p == 0) {
          while (hi < Q.n_queues && Q.stage_open[hi] <= r) ++hi;
        }
        if (clock[p] > r) {  // busy: the cell reads and writes nothing else
          if (++p == P) {
            p = 0;
            ++r;
          }
          continue;
        }
        while (lo < hi && Q.head[lo] >= Q.tail[lo]) ++lo;
        const Claim c = extract<false>(Q, p, r, lo, hi);
        Q.scanned[p] += c.nread;
        if (c.found) {
          sh.found = 1;
          sh.fq = c.fq;
          sh.fs = c.fs;
          load_record(Q, c.fq, c.fs, sh.rec);
          cr = r;
          cp = p;
        }
        if (++p == P) {
          p = 0;
          ++r;
        }
      }
    }
    __syncthreads();
    if (!sh.found) return;
    body(sh.rec, false);
    if (t0) account<TRACE>(Q, cr, cp, sh.fq, sh.fs, true, false);
    __syncthreads();
  }
}

template <bool TRACE, bool HALFRUN = false, class QT, class Body>
__device__ void ws_lockstep(const QT& Q, WSShared& sh, const Body& body) {
  if constexpr (std::is_same<QT, WSQueuesOwned>::value && !HALFRUN) {
    if (!Q.compress) {
      owned_lockstep<TRACE>(Q, sh, body);
      return;
    }
  }
  const bool t0 = threadIdx.x == 0;
  int lo = 0, hi = Q.stage_open ? 0 : Q.n_queues;  // thread 0's victim window
  for (int r = 0; r < Q.rounds; ++r) {
    if (t0) {
      while (hi < Q.n_queues && Q.stage_open[hi] <= r) ++hi;
    }
    for (int p = 0; p < Q.n_programs; ++p) {
      if (Q.compress) {
        // Round compression (no thieves): an idle owner drains its whole
        // queue inside this cell, with one coalesced advisory write.
        const int own = p % Q.n_queues;
        bool idle = false;
        int total = 0;
        if (t0) {
          idle = Q.clock[p] <= r;
          sh.found = 0;
          if (idle) {
            int h = rmax_read(Q, p, own);
            int probed;
            int op = probe(Q, own, h, true, &probed);
            Q.scanned[p] += probed;
            sh.found = op != BOTTOM;
            sh.fq = own;
            sh.fs = h;
            if (sh.found) load_record(Q, own, h, sh.rec);
          }
        }
        __syncthreads();
        while (sh.found) {
          if (t0) claim_writes(Q, p, own, sh.fs);
          body(sh.rec, false);
          if (t0) {
            total += account<TRACE>(Q, r, p, own, sh.fs, false, false);
            int h = rmax_read(Q, p, own);
            int probed;
            int op = probe(Q, own, h, true, &probed);
            Q.scanned[p] += probed;
            sh.found = op != BOTTOM;
            sh.fs = h;
            if (sh.found) load_record(Q, own, h, sh.rec);
          }
          __syncthreads();
        }
        if (t0 && idle && total > 0) {
          int rem = Q.remaining[own] - total;
          Q.remaining[own] = rem > 0 ? rem : 0;
        }
        __syncthreads();
      } else {
        if (t0) {
          ClaimT<HALFRUN> c{};
          if constexpr (HALFRUN) c.run = 1;
          if (Q.clock[p] <= r) {
            // a run claim moves head[v] at most to tail[v], so this window
            // holds as it does for per-slot claims
            while (lo < hi && Q.head[lo] >= Q.tail[lo]) ++lo;
            c = extract<HALFRUN>(Q, p, r, lo, hi);
          }
          Q.scanned[p] += c.nread;
          sh.found = c.found;
          sh.fq = c.fq;
          sh.fs = c.fs;
          if constexpr (HALFRUN) sh.run = c.run;
          if (c.found) load_record(Q, c.fq, c.fs, sh.rec);
        }
        __syncthreads();
        if (sh.found) {
          if constexpr (HALFRUN) {
            run_slots<TRACE>(Q, sh, body, r, p, false);
          } else {
            body(sh.rec, false);
            if (t0) account<TRACE>(Q, r, p, sh.fq, sh.fs, true, false);
          }
        }
        __syncthreads();
      }
    }
  }
}

template <bool TRACE, bool HALFRUN = false, bool ROT = false, class QT, class Body>
__device__ void ws_free(const QT& Q, WSShared& sh, const Body& body) {
  const int p = blockIdx.x;
  const bool t0 = threadIdx.x == 0;
  if constexpr (TRACE) {
    // a stalled program: hold this CTA back before its first probe
    if (t0) {
      for (long long ns = (long long)Q.clock[p] * Q.stall_ns; ns > 0; ns -= 1000000) {
        __nanosleep(ns < 1000000 ? (unsigned)ns : 1000000u);
      }
    }
  }
  while (true) {
    if (t0) {
      ClaimT<HALFRUN> c;
      if constexpr (TRACE) {
        // a positive rounds is this program's budget in tile-slots
        // (checked per extraction: a run may overshoot it by run_cap - 1)
        ClaimT<HALFRUN> none{};
        if constexpr (HALFRUN) none.run = 1;
        c = (Q.rounds <= 0 || Q.clock[p] < Q.rounds)
                ? extract<HALFRUN, ROT>(Q, p, 0, 0, Q.n_queues)
                : none;
      } else {
        c = extract<HALFRUN, ROT>(Q, p, 0, 0, Q.n_queues);
      }
      Q.scanned[p] += c.nread;
      sh.found = c.found;
      sh.fq = c.fq;
      sh.fs = c.fs;
      if constexpr (HALFRUN) sh.run = c.run;
      if (c.found) load_record(Q, c.fq, c.fs, sh.rec);
    }
    __syncthreads();
    if (!sh.found) break;  // this program's view: every queue drained
    if constexpr (HALFRUN) {
      run_slots<TRACE>(Q, sh, body, 0, p, true);
    } else {
      body(sh.rec, true);
      if (t0) account<TRACE>(Q, 0, p, sh.fq, sh.fs, true, true);
    }
    __syncthreads();
  }
}

// The queue half of every C entry point's arguments.
// ``pool_off`` is null for the dense layout.
static inline WSQueues ws_queues(
    const int* tasks, const int* pool_off, const int* tail, int* head, int* local_head, int* taken,
    int* remaining, int* clock, int* work, int* steals, int* scanned, int* mult,
    int n_queues, int capacity, int n_programs, int n_tasks, int rounds,
    int steal, int policy, int compress) {
  WSQueues Q;
  Q.tasks = tasks;
  Q.pool_off = pool_off;
  Q.stage_open = nullptr;
  Q.tail = tail;
  Q.head = head;
  Q.local_head = local_head;
  Q.taken = taken;
  Q.remaining = remaining;
  Q.clock = clock;
  Q.work = work;
  Q.steals = steals;
  Q.scanned = scanned;
  Q.mult = mult;
  Q.n_queues = n_queues;
  Q.capacity = capacity;
  Q.n_programs = n_programs;
  Q.n_tasks = n_tasks;
  Q.rounds = rounds;
  Q.steal = steal;
  Q.policy = policy;
  Q.compress = compress;
  Q.ev = nullptr;
  Q.ev_cursor = nullptr;
  Q.ev_mult0 = nullptr;
  Q.ev_cap = 0;
  Q.steal_kind = 0;
  Q.stall_ns = 0;
  Q.run_cap = 1;
  return Q;
}

// The ring half of every C entry point's arguments (null ev: untraced).
static inline void ws_set_ring(WSQueues& Q, int* ev, int* ev_cursor, const int* ev_mult0,
                               int ev_cap, int steal_kind, int stall_ns) {
  Q.ev = ev;
  Q.ev_cursor = ev_cursor;
  Q.ev_mult0 = ev_mult0;
  Q.ev_cap = ev_cap;
  Q.steal_kind = steal_kind;
  Q.stall_ns = stall_ns;
}

// Launch a scheduler kernel `kern(Q, tile_args)`: one CTA in lockstep mode,
// P CTAs in free mode.  `kerns` holds the untraced lockstep, untraced free,
// traced lockstep and traced free instantiations, then (N = 8) the same four
// of the HALFRUN walks; the rings pick the pair and run_cap > 1 the half.
// Returns the CUDA error of the launch (0 on success).
template <class TileArgs, int N>
static int ws_launch(void (*const (&kerns)[N])(WSQueues, TileArgs), int mode, const WSQueues& Q,
                     const TileArgs& a, int threads, size_t smem, cudaStream_t stream) {
  static_assert(N == 4 || N == 8, "4 per-slot instantiations, then 4 HALFRUN ones");
  const int half = Q.run_cap > 1 ? 4 : 0;
  // the reference's refusals: half-runs amortise cost-policy steals and
  // break stage_open's per-slot Graham windows; ws_unified has no half-run
  if (half && (half >= N || !Q.steal || Q.policy != 0 || Q.stage_open || Q.compress))
    return (int)cudaErrorInvalidValue;
  void (*kern)(WSQueues, TileArgs) = kerns[half + (Q.ev ? 2 : 0) + (mode == 0 ? 0 : 1)];
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(mode == 0 ? 1 : Q.n_programs);
  kern<<<grid, threads, smem, stream>>>(Q, a);
  return (int)cudaGetLastError();
}
