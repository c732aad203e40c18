// Why the expert kernels run one CTA a program: the SASS of the ways a
// thread-block cluster's CTAs can hand each other data on sm_90a.  Not a
// kernel of the port and never launched; chip_smoke.py's audit builds this
// file and counts the forbidden opcodes of each function.
//
// Each kernel publishes a word to the next CTA's view and reads its own,
// the exchange a cluster-wide expert tile needs for its hidden tile.
//  * cluster_exchange_release: a store to its own shared memory, then
//    barrier.cluster.arrive (release, the default) + wait (acquire), then a
//    read of the peer's word through distributed shared memory.  The release
//    is what orders the store before the peer's read; it compiles to
//    MEMBAR.ALL.GPU.
//  * cluster_exchange_relaxed: the same with barrier.cluster.arrive.relaxed.
//    No MEMBAR, and no ordering of the store: the peer may read a stale word.
//  * cluster_exchange_async: st.async of the word into the peer's shared
//    memory, completing on the peer's mbarrier (complete_tx), and a wait on
//    its own mbarrier: the write is ordered by the mbarrier, with no release
//    barrier.  The peers may signal an mbarrier only once its
//    initialisation is visible to the cluster, which PTX orders with
//    fence.mbarrier_init.release.cluster before a cluster barrier.
// The audit forbids MEMBAR and FENCE in SASS and fence. in PTX.  The first
// fails in SASS, the second orders nothing, and the third needs its PTX
// fence.mbarrier_init, so a program stays one CTA.

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned cta_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cta_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// The next CTA's word at `p` (a shared-memory address of this CTA).
__device__ __forceinline__ int peer_word(const int* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"((cta_rank() + 1) % cta_count()));
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(r) : "memory");
  return v;
}

extern "C" __global__ void __cluster_dims__(2, 1, 1) cluster_exchange_release(int* out) {
  __shared__ int word;
  if (threadIdx.x == 0) word = (int)blockIdx.x;
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int v = peer_word(&word);
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

extern "C" __global__ void __cluster_dims__(2, 1, 1) cluster_exchange_relaxed(int* out) {
  __shared__ int word;
  if (threadIdx.x == 0) word = (int)blockIdx.x;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int v = peer_word(&word);
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// The peer's address of a shared-memory address `p` of this CTA.
__device__ __forceinline__ unsigned peer_addr(const void* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"((cta_rank() + 1) % cta_count()));
  return r;
}

extern "C" __global__ void __cluster_dims__(2, 1, 1) cluster_exchange_async(int* out) {
  __shared__ __align__(8) unsigned long long bar;
  __shared__ int word;
  const unsigned b = (unsigned)__cvta_generic_to_shared(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) {
    unsigned long long state;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], 4;\n"
                 : "=l"(state) : "r"(b) : "memory");
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n"
                 ::"r"(peer_addr(&word)), "r"((int)blockIdx.x), "r"(peer_addr(&bar))
                 : "memory");
  }
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(b) : "memory");
  if (threadIdx.x == 0) out[blockIdx.x] = word;
}
