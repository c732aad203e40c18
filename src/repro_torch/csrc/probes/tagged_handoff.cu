// Whether CTAs of one launch can hand each other data with no fence on
// sm_90a: every word that crosses CTAs carries its own validity.  Not a
// kernel of the port; chip_smoke.py's audit builds this file, counts the
// forbidden opcodes of each function and runs the three checks below
// (ws_unified.cu's walker and helpers use the same hand-off).
//
// A tagged word is one aligned 64-bit scalar: a 32-bit value in the low half
// and the 32-bit tag of the request that wrote it in the high half.  The
// producer writes it with st.relaxed.gpu.b64, the consumer reads it with
// ld.relaxed.gpu.b64 until the tag is the one it expects.  This needs no
// ordering between different words, only coherence of one location and
// single-copy atomicity of an aligned 64-bit access, so neither side issues
// a fence, a membar or an atomic.
//  * tagged_stress: CTA 0 posts n_req requests over n_words tagged words
//    (value a hash of request and word), with random __nanosleep between
//    stores; each consumer CTA reads every word of every request until its
//    tag matches, checks the value written under it, and acks the request
//    with a tagged word of its own; CTA 0 posts the next request once every
//    ack is in.  out[c] counts consumer c's wrong values, tags newer than the
//    one expected, and spins past the deadline.
//  * tagged_roundtrip: CTA 0 posts a request word, the consumers answer it
//    each in its own tagged word, CTA 0 reads every answer; n times.  out
//    holds the mean ns of a round trip.
//  * tagged_coresident: every CTA of a cooperative launch announces itself
//    with its SM id, CTA 0 waits for all of them (past the deadline it gives
//    up) and only then lets them go.  Without co-residency CTA 0 would
//    wait for CTAs that cannot start.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

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

__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ u64 pack(unsigned v, unsigned tag) {
  return ((u64)tag << 32) | v;
}

__device__ __forceinline__ unsigned tag_of(u64 w) { return (unsigned)(w >> 32); }

__device__ __forceinline__ unsigned value_of(unsigned s, unsigned i) {
  return (s * 2654435761u) ^ (i * 40503u + 0x9e3779b9u);
}

__device__ __forceinline__ unsigned xorshift(unsigned& x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x;
}

// Spin until *p carries `tag`; returns the word, or 0 past the deadline.
// A newer tag is counted in *newer and returned at once.
__device__ u64 wait_tag(const u64* p, unsigned tag, u64 deadline_ns, long long* newer,
                        long long* late, unsigned& rng) {
  const u64 t0 = now_ns();
  unsigned ns = 32;
  while (true) {
    const u64 w = ld_tagged(p);
    const unsigned t = tag_of(w);
    if (t == tag) return w;
    if (t > tag) {
      ++*newer;
      return w;
    }
    if (now_ns() - t0 > deadline_ns) {
      ++*late;
      return 0;
    }
    __nanosleep(ns + (xorshift(rng) & 31));
    ns = ns < 1024 ? 2 * ns : ns;
  }
}

// words [n_words], acks [C]; out [C + 1][3]
extern "C" __global__ void tagged_stress(u64* words, u64* acks, int n_words, int n_req,
                                         u64 deadline_ns, unsigned seed, long long* out) {
  const int c = blockIdx.x, C = gridDim.x - 1, tid = threadIdx.x;
  unsigned rng = seed ^ (c * 747796405u + tid * 2891336453u + 1u);
  long long bad = 0, newer = 0, late = 0;
  for (unsigned s = 1; s <= (unsigned)n_req; ++s) {
    if (c == 0) {
      for (int i = tid; i < n_words; i += blockDim.x) {
        if ((xorshift(rng) & 7) == 0) __nanosleep(xorshift(rng) & 511);
        st_tagged(words + i, pack(value_of(s, i), s));
      }
      for (int k = tid; k < C; k += blockDim.x)
        wait_tag(acks + k, s, deadline_ns, &newer, &late, rng);
    } else {
      if ((xorshift(rng) & 3) == 0) __nanosleep(xorshift(rng) & 1023);
      for (int i = tid; i < n_words; i += blockDim.x) {
        const u64 w = wait_tag(words + i, s, deadline_ns, &newer, &late, rng);
        bad += tag_of(w) == s && (unsigned)w != value_of(s, i);
      }
      __syncthreads();  // every word of request s read before the ack
      if (tid == 0) st_tagged(acks + (c - 1), pack(0u, s));
    }
    __syncthreads();
    if (late) deadline_ns = 0;  // past one deadline: poll once and move on
  }
  // per-thread counts summed in shared memory, no atomics
  __shared__ long long red[3][1024];
  red[0][tid] = bad;
  red[1][tid] = newer;
  red[2][tid] = late;
  __syncthreads();
  if (tid == 0) {
    long long a = 0, b = 0, d = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) {
      a += red[0][t];
      b += red[1][t];
      d += red[2][t];
    }
    out[c * 3 + 0] = a;
    out[c * 3 + 1] = b;
    out[c * 3 + 2] = d;
  }
}

// req [1], ans [C]; out [2]: mean ns a round trip, spins past the deadline
extern "C" __global__ void tagged_roundtrip(u64* req, u64* ans, int n, u64 deadline_ns,
                                            long long* out) {
  const int c = blockIdx.x, C = gridDim.x - 1, tid = threadIdx.x;
  unsigned rng = 12345u + c;
  long long newer = 0, late = 0;
  u64 t_start = 0;
  for (unsigned s = 1; s <= (unsigned)n; ++s) {
    if (c == 0) {
      if (s == 1 && tid == 0) t_start = now_ns();
      if (tid == 0) st_tagged(req, pack(s, s));
      for (int k = tid; k < C; k += blockDim.x)
        wait_tag(ans + k, s, deadline_ns, &newer, &late, rng);
      __syncthreads();
    } else if (tid == 0) {
      const u64 w = wait_tag(req, s, deadline_ns, &newer, &late, rng);
      st_tagged(ans + (c - 1), pack((unsigned)w + 1u, s));
    }
    if (late) deadline_ns = 0;
  }
  if (c == 0 && tid == 0) {
    out[0] = (long long)((now_ns() - t_start) / (u64)n);
    out[1] = late + newer;
  }
}

// arrive [n_ctas], go [1]; out [3]: CTAs that arrived, distinct SMs, late
extern "C" __global__ void tagged_coresident(u64* arrive, u64* go, u64 deadline_ns,
                                             long long* out) {
  extern __shared__ unsigned char pad[];  // the kernel's shared memory, held
  const int c = blockIdx.x, n = gridDim.x, tid = threadIdx.x;
  unsigned rng = 777u + c;
  long long newer = 0, late = 0;
  if (tid == 0) {
    pad[0] = 0;
    st_tagged(arrive + c, pack(smid(), 1u));
  }
  if (c == 0) {
    __shared__ unsigned seen[8];
    if (tid < 8) seen[tid] = 0;
    __syncthreads();
    if (tid == 0) {
      long long got = 0, sms = 0;
      for (int k = 0; k < n; ++k) {
        const u64 w = wait_tag(arrive + k, 1u, deadline_ns, &newer, &late, rng);
        if (tag_of(w) != 1u) continue;
        ++got;
        const unsigned sm = (unsigned)w & 255u;
        if (!(seen[sm / 32] >> (sm % 32) & 1u)) {
          seen[sm / 32] |= 1u << (sm % 32);
          ++sms;
        }
      }
      out[0] = got;
      out[1] = sms;
      out[2] = late + newer;
      st_tagged(go, pack(0u, 1u));
    }
  } else if (tid == 0) {
    wait_tag(go, 1u, deadline_ns, &newer, &late, rng);
  }
  __syncthreads();
}

// C entry points: each zeroes its words, launches, and returns the CUDA
// error (0 on success).  ws holds the tagged words, out the counts.
extern "C" int tagged_stress_run(int n_consumers, int threads, int n_words, int n_req,
                                 u64 deadline_ns, unsigned seed, void* ws, long long* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  u64* words = (u64*)ws;
  u64* acks = words + n_words;
  cudaError_t e = cudaMemsetAsync(ws, 0, sizeof(u64) * (n_words + n_consumers), s);
  if (e != cudaSuccess) return (int)e;
  tagged_stress<<<1 + n_consumers, threads, 0, s>>>(words, acks, n_words, n_req, deadline_ns,
                                                    seed, out);
  return (int)cudaGetLastError();
}

extern "C" int tagged_roundtrip_run(int n_consumers, int n, u64 deadline_ns, void* ws,
                                    long long* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  u64* req = (u64*)ws;
  cudaError_t e = cudaMemsetAsync(ws, 0, sizeof(u64) * (1 + n_consumers), s);
  if (e != cudaSuccess) return (int)e;
  tagged_roundtrip<<<1 + n_consumers, 128, 0, s>>>(req, req + 1, n, deadline_ns, out);
  return (int)cudaGetLastError();
}

// A cooperative launch of n_ctas CTAs of `threads` threads and `smem`
// bytes of dynamic shared memory; occ gets the CTAs an SM holds at that size
// and the SM count.
extern "C" int tagged_coresident_run(int n_ctas, int threads, int smem, u64 deadline_ns,
                                     void* ws, long long* out, int* occ, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  u64* arrive = (u64*)ws;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&occ[1], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tagged_coresident, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[0], tagged_coresident, threads, smem);
  if (e == cudaSuccess) e = cudaMemsetAsync(ws, 0, sizeof(u64) * (n_ctas + 1), s);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tagged_coresident, arrive, arrive + n_ctas, deadline_ns, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
