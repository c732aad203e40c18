// Mamba-2 SSD chunked scan for Hopper (sm_90a), on tensor cores.
//
// Replaces the TPU kernel of repro/kernels/ssd_scan/kernel.py: `_ssd_kernel`,
// launched by `ssd_scan` over the grid (b, H, n_chunks) with the chunks
// sequential and the [P, N] fp32 state in VMEM scratch.
//
// What it computes.  x [b, S, H, P], dt [b, S, H], B and C [b, S, N] (one
// group shared by every head; contiguous, fp32 or bf16) and A [H] fp32.  Per
// (b, h) and chunk of Q steps, with cs = cumsum(dt * A) over the chunk, in
// the reference's chunked form (repro/models/ssm.py `ssd_chunked`):
//   y      = (C B^T o L)(x dt) + exp(cs) o (C S^T),  L[i, j] = exp(cs_i - cs_j), i >= j
//   S     <- exp(cs_last) S + ((x dt) o exp(cs_last - cs))^T B
// with S the state entering the chunk.  It writes y [b, S, H, P] in x's type
// and the final state [b, H, P, N] in fp32.
//
// How.  Rows of the state are independent (S[p, :] depends on x[:, p]
// alone), so one CTA of 4 warps owns a slice of PS = 32 columns of P of one
// (b, h): the grid is (ceil(P / PS) * H, b), 320 CTAs at mamba2-2.7b's
// widths, all resident at once (3 an SM).  The CTA walks the chunks in order
// with its [PS, N] fp32 state in registers, as mma accumulators.  Per chunk
// it stages B ([Q, N]) and its slice of x ([Q, PS]) with cp.async and, while
// they are in flight, writes the state entering the chunk in bf16 parts,
// and warp 0 loads dt and takes the cumulative sum (a run of steps a lane,
// then a shuffle scan); the next chunk's rows are prefetched into L2.
// Every product is mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix
// fragments (C's from global memory, below), dt folded into the fp32
// operand so that x stays an input:
//   scores = C B^T on the 16 x 16 blocks of the lower triangle; each warp owns
//     the 16-row blocks w and 2 * 4 - 1 - w of every 8 (zigzag), so the
//     triangle splits evenly, and takes two blocks of columns at a time;
//   y_diag = (scores o L o dt) x, the weights taken from the scores'
//     accumulators as A fragments (no shared-memory round trip);
//   y_off  = C S^T from the state's parts, scaled by exp(cs) row by row;
//   the state update (x o dt exp(cs_last - cs))^T B into the accumulators,
//     each warp one 16-row half of the slice and every other 16 columns of N.
// C's fragments come straight from global memory into registers (bf16, N
// 32, 64 or 128; the first row block's during the staging), so no C tile
// takes shared memory; otherwise C is staged like B.  exp(cs_i - cs_j) is
// taken only where i >= j: above the diagonal it is positive and may
// overflow, and inf * 0 would be NaN where the reference selects 0 after
// its exp.  Rows
// past Q, columns past N and past P are zeros in shared memory (never sent
// to another path) and never stored.
//
// Every shape.  Where the caller's chunk does not fit shared memory the host
// passes a shorter one (the scan is the same; the last chunk may be short,
// its rows past S zeros), and N past NMAX is walked in tiles of NMAX columns
// (the state's columns are independent; y's sum over the tiles is kept in
// an fp32 buffer, each thread reading back only what it wrote).
//
// fp32 on bf16 tensor cores.  bf16 inputs (x, B, C) are exact in one bf16
// part; every fp32 quantity (scores o L o dt, x dt exp(cs_last - cs), the
// state) is split into K parts, hi = bf16(v), then bf16 of each remainder,
// and a product sums the part products (i, j) with i + j < K, smallest
// first.  bf16 inputs take K = 2 (each fp32 operand within 2^-17 of itself);
// fp32 inputs take K = 3 parts of every operand, their own included
// (within 2^-24).
//
// What bounds it on this card.  Each input read once and y written once is
// 91.9 MB at mamba2-2.7b's widths (0.0274 ms at 3.35 TB/s); the products
// are 18.9 GFLOP of fp32 work, 39.6 GFLOP of bf16 tensor-core work in parts
// with the scores recomputed by each slice (0.040 ms at 989 TFLOP/s), and
// every CTA reads B and C of every chunk through L2 (335.5 MB).  Neither
// sets the time: all CTAs run at once, so the kernel takes one CTA's walk
// of the chunks, and its 4 warps are bound by chains of dependent
// instructions.  No atomics, no fence: data crosses CTAs only at the launch
// boundary.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"  // ldmatrix, mma.sync, cp.async (and dtype_io.cuh)

#define NW 4            // warps a CTA
#define NT (NW * 32)
#define PS 32           // columns of P a CTA owns
#define XLD (PS + 8)    // elements of a row of x's parts (80 B in bf16: ldmatrix conflict-free)
#define NMAX 256        // widest tile of N: 16 k-steps of 16

#define VEC_BC 1  // B and C rows copy as 16-byte vectors
#define VEC_X 2   // so does the slice of x

typedef __nv_bfloat16 bf16;

// Parts of each input type: IN for the inputs x, B and C, K for every fp32
// quantity; PAD elements (16 B) after each row of a B or C tile.
template <typename T> struct Parts;
template <> struct Parts<bf16> { static constexpr int IN = 1, K = 2, PAD = 8; };
template <> struct Parts<float> { static constexpr int IN = 3, K = 3, PAD = 4; };

// Integral constant for the blocks of columns taken at once.
template <int V> struct Int { static constexpr int v = V; };

// Fragments of m16n8k16 (attn_mma.cuh's layout) in K parts: r[slot][part].
template <int K> struct Af { uint32_t r[4][K]; };
template <int K> struct Bf { uint32_t r[2][K]; };

__host__ __device__ constexpr int rup16(int v) { return (v + 15) & ~15; }

// (x0, x1) -> K bf16x2 parts: hi, then bf16 of each remainder.
template <int K>
__device__ __forceinline__ void split(float x0, float x1, uint32_t (&p)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 f = __bfloat1622float2(h);
    p[k] = amma::bits(h);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// 2^x (the decay weights are taken in base 2: cs is kept times log2(e)).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The decay weights' exponential: base 2 (ex2.approx, cs kept times
// log2(e)) for bf16 inputs; expf of cs as it is for fp32 inputs, whose
// limits are tighter.
template <typename T> struct Decay;
template <> struct Decay<bf16> {
  static constexpr float SCALE = 1.4426950408889634f;
  static __device__ __forceinline__ float exp(float x) { return ex2(x); }
};
template <> struct Decay<float> {
  static constexpr float SCALE = 1.f;
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
};

// Pull one line of global memory into L2 ahead of its cp.async.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// d += a b over the part products (i, j) with i + j < KM, smallest first.
template <int KA, int KB, int KM>
__device__ __forceinline__ void mma_parts(float (&d)[4], const Af<KA>& a, const Bf<KB>& b) {
#pragma unroll
  for (int s = KM - 1; s >= 0; --s) {
#pragma unroll
    for (int i = 0; i < KA; ++i) {
      const int j = s - i;
      if (j >= 0 && j < KB) {
        const uint32_t ar[4] = {a.r[0][i], a.r[1][i], a.r[2][i], a.r[3][i]};
        amma::mma(d, ar, b.r[0][j], b.r[1][j]);
      }
    }
  }
}

// ---- fragments of the input tiles (row-major, ld elements a row) ----------

// A 16 x 16 at (r0, k0) of a tile stored [row][k].
template <typename T>
__device__ __forceinline__ Af<Parts<T>::IN> load_a_rm(const T* M, int ld, int r0, int k0);

template <>
__device__ __forceinline__ Af<1> load_a_rm<bf16>(const bf16* M, int ld, int r0, int k0) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  amma::ldsm_x4(r, M + (r0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
  Af<1> a;
#pragma unroll
  for (int s = 0; s < 4; ++s) a.r[s][0] = r[s];
  return a;
}

template <>
__device__ __forceinline__ Af<3> load_a_rm<float>(const float* M, int ld, int r0, int k0) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  Af<3> a;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float2 v = *reinterpret_cast<const float2*>(
        M + (r0 + g + (s & 1) * 8) * ld + k0 + (s >> 1) * 8 + 2 * t);
    split<3>(v.x, v.y, a.r[s]);
  }
  return a;
}

// B fragments of two n8 tiles (n0..n0+15) x k0..k0+15 of a tile stored
// [n][k] (k contiguous): the scores' B^T.
template <typename T>
__device__ __forceinline__ void load_b_nk2(const T* M, int ld, int n0, int k0,
                                           Bf<Parts<T>::IN> (&b)[2]);

template <>
__device__ __forceinline__ void load_b_nk2<bf16>(const bf16* M, int ld, int n0, int k0,
                                                 Bf<1> (&b)[2]) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  amma::ldsm_x4(r, M + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8);
  b[0].r[0][0] = r[0];
  b[0].r[1][0] = r[1];
  b[1].r[0][0] = r[2];
  b[1].r[1][0] = r[3];
}

template <>
__device__ __forceinline__ void load_b_nk2<float>(const float* M, int ld, int n0, int k0,
                                                  Bf<3> (&b)[2]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float2 v =
          *reinterpret_cast<const float2*>(M + (n0 + 8 * h + g) * ld + k0 + 8 * s + 2 * t);
      split<3>(v.x, v.y, b[h].r[s]);
    }
  }
}

// B fragments of two n8 tiles of a tile stored [k][n] (n contiguous): the
// state update's B.
template <typename T>
__device__ __forceinline__ void load_b_kn2(const T* M, int ld, int k0, int n0,
                                           Bf<Parts<T>::IN> (&b)[2]);

template <>
__device__ __forceinline__ void load_b_kn2<bf16>(const bf16* M, int ld, int k0, int n0,
                                                 Bf<1> (&b)[2]) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  amma::ldsm_x4_t(r, M + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
  b[0].r[0][0] = r[0];
  b[0].r[1][0] = r[1];
  b[1].r[0][0] = r[2];
  b[1].r[1][0] = r[3];
}

template <>
__device__ __forceinline__ void load_b_kn2<float>(const float* M, int ld, int k0, int n0,
                                                  Bf<3> (&b)[2]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* p = M + (k0 + 8 * s + 2 * t) * ld + n0 + 8 * h + g;
      split<3>(p[0], p[ld], b[h].r[s]);
    }
  }
}

// ---- fragments of bf16 part arrays (K arrays, pst elements apart) ---------

// B of two n8 tiles from parts stored [k][n]: y_diag's x.
template <int K>
__device__ __forceinline__ void load_b_kn2_parts(const bf16* M, int ld, int pst, int k0,
                                                 int n0, Bf<K> (&b)[2]) {
  const int l = threadIdx.x & 31;
  const bf16* p = M + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t r[4];
    amma::ldsm_x4_t(r, p + k * pst);
    b[0].r[0][k] = r[0];
    b[0].r[1][k] = r[1];
    b[1].r[0][k] = r[2];
    b[1].r[1][k] = r[3];
  }
}

// B of two n8 tiles from parts stored [n][k]: y_off's state.
template <int K>
__device__ __forceinline__ void load_b_nk2_parts(const bf16* M, int ld, int pst, int n0,
                                                 int k0, Bf<K> (&b)[2]) {
  const int l = threadIdx.x & 31;
  const bf16* p = M + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t r[4];
    amma::ldsm_x4(r, p + k * pst);
    b[0].r[0][k] = r[0];
    b[0].r[1][k] = r[1];
    b[1].r[0][k] = r[2];
    b[1].r[1][k] = r[3];
  }
}

// A (16 rows m0.., k0..k0+15) in K parts from KX parts stored [k][m]: the
// state update's x^T, each value summed from its parts, times w[k] and
// split again.
template <int KX, int K>
__device__ __forceinline__ Af<K> load_a_km_scaled(const bf16* M, int ld, int pst, int m0,
                                                  int k0, const float* w) {
  const int l = threadIdx.x & 31, t = l & 3;
  const bf16* p = M + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8;
  float v[4][2] = {};
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    uint32_t r[4];
    amma::ldsm_x4_t(r, p + k * pst);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float2 f = unpack(r[s]);
      v[s][0] += f.x;
      v[s][1] += f.y;
    }
  }
  const float2 w0 = *reinterpret_cast<const float2*>(w + k0 + 2 * t);
  const float2 w1 = *reinterpret_cast<const float2*>(w + k0 + 8 + 2 * t);
  Af<K> a;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float2 d = s < 2 ? w0 : w1;  // slots 0, 1: k 2t..; 2, 3: k 8 + 2t..
    split<K>(v[s][0] * d.x, v[s][1] * d.y, a.r[s]);
  }
  return a;
}

// ---- C straight from global memory ----------------------------------------

// The A fragments of C's rows i0..i0+15 of a chunk of Q rows with N = 16 NK
// columns (C 4-byte aligned): one 32-bit load a pair, zeros past Q.
template <int NK>
__device__ __forceinline__ void load_c_rows(Af<1> (&cf)[NK], const bf16* C, int Q, int i0) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + g + 8 * h;
    const bool live = i < Q;
    const unsigned int* row =
        reinterpret_cast<const unsigned int*>(C + (size_t)(live ? i : 0) * (16 * NK)) + t;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const unsigned int v0 = __ldg(row + 8 * kk), v1 = __ldg(row + 8 * kk + 4);
      cf[kk].r[h][0] = live ? v0 : 0u;      // (row g + 8h, cols 16 kk + 2t..)
      cf[kk].r[2 + h][0] = live ? v1 : 0u;  // (row g + 8h, cols 16 kk + 8 + 2t..)
    }
  }
}

// ---- staging ---------------------------------------------------------------

// rows x cols of src (row stride `stride`) into dst[rows_p][ld], zeros past
// rows and cols up to rows_p x cols_p; 16-byte cp.async where `vec`.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src, size_t stride,
                                           int rows, int cols, int rows_p, int cols_p,
                                           bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = cols_p / V;
    if (NT % vpr == 0) {  // each thread one column of vectors, every NT / vpr rows
      const int c = (threadIdx.x % vpr) * V, step = NT / vpr;
      const bool cin = c < cols;
      int r = threadIdx.x / vpr;
      T* d = dst + r * ld + c;
      const T* sr = src + r * stride + c;
      for (; r < rows_p; r += step, d += step * ld, sr += step * stride) {
        const bool full = cin && r < rows;
        amma::cp_async16(d, full ? sr : src, full);
      }
    } else {
      for (int e = threadIdx.x; e < rows_p * vpr; e += NT) {
        const int r = e / vpr, c = (e - r * vpr) * V;
        const bool full = r < rows && c < cols;
        amma::cp_async16(dst + r * ld + c, full ? src + r * stride + c : src, full);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows_p * cols_p; e += NT) {
      const int r = e / cols_p, c = e - r * cols_p;
      dst[r * ld + c] = (r < rows && c < cols) ? src[r * stride + c] : from_f<T>(0.f);
    }
  }
}

struct SSDArgs {
  const void* x;
  const void* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* fin;
  float* ys;  // [b, S, H, P] fp32: y's sum over the tiles of N (null: one tile)
  int S, H, P, N, Q;
  int Nt;   // columns of N a walk takes: N, or tiles of Nt (a multiple of 16)
  int vec;  // VEC_BC | VEC_X
};

// Shared memory.  tile: a B or C tile [Qp][Np + PAD] in the input type;
// xparts: x's IN parts [IN][Qp][XLD] in bf16; region: fp32 inputs' raw x
// [Qp][PS] until split, then the state's parts [K][PS][Np + 8] in bf16;
// vectors: dt, cs (times Decay's SCALE), dt exp(cs_last - cs) [Qp] in fp32.
template <typename T>
__host__ __device__ constexpr size_t tile_bytes(int Q, int N) {
  return (size_t)rup16(Q) * (rup16(N) + Parts<T>::PAD) * sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t xparts_bytes(int Q) {
  return (size_t)Parts<T>::IN * rup16(Q) * XLD * 2;
}

template <typename T>
__host__ __device__ constexpr size_t region_bytes(int Q, int N) {
  const size_t raw = Parts<T>::IN > 1 ? (size_t)rup16(Q) * PS * sizeof(T) : 0;
  const size_t st = (size_t)Parts<T>::K * PS * (rup16(N) + 8) * 2;
  return raw > st ? raw : st;
}

template <typename T, bool CREG>
static size_t smem_bytes(int Q, int N) {
  return (CREG ? 1 : 2) * tile_bytes<T>(Q, N) + xparts_bytes<T>(Q) +
         region_bytes<T>(Q, N) + (size_t)3 * rup16(Q) * sizeof(float);
}

// NKM: k-steps of 16 over N the registers are sized for (nk <= NKM).  CREG:
// C's fragments come from global memory into registers, with no C tile
// (bf16, N = 16 NKM exactly: 32, 64 or 128; C 4-byte aligned); those CTAs
// fit 3 an SM.
template <typename T, bool CREG, int NKM>
__global__ void __launch_bounds__(NT, (CREG ? 3 : 2)) ssd_kernel(SSDArgs a) {
  constexpr int IN = Parts<T>::IN, K = Parts<T>::K;
  static_assert(!CREG || (IN == 1 && NKM <= 8), "C in registers: bf16, N up to 128");
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, H = a.H, P = a.P, N = a.N, Q = a.Q;
  // C in registers: N is 16 NKM exactly (one tile), so the widths and strides fold
  const int Qp = rup16(Q), Np = CREG ? 16 * NKM : rup16(a.Nt), nk = Np / 16, nb = Qp / 16;
  const int ldt = Np + Parts<T>::PAD, lds = Np + 8;
  T* Bs = reinterpret_cast<T*>(smem);                         // [Qp][ldt]
  T* Cs = Bs + Qp * ldt;                                      // [Qp][ldt] (not CREG)
  bf16* Xp = reinterpret_cast<bf16*>(smem + (CREG ? 1 : 2) * tile_bytes<T>(Q, a.Nt));
  unsigned char* region = reinterpret_cast<unsigned char*>(Xp) + xparts_bytes<T>(Q);
  T* Xr = reinterpret_cast<T*>(region);                       // [Qp][PS] raw x (fp32), then
  bf16* Sp = reinterpret_cast<bf16*>(region);                 // [K][PS][lds] state entering
  float* sdt = reinterpret_cast<float*>(region + region_bytes<T>(Q, a.Nt));  // [Qp] dt
  float* scs = sdt + Qp;  // [Qp] cs (times Decay's SCALE); past Q (zero dt) it stays cs_last
  float* sdd = scs + Qp;  // [Qp] dt exp(cs_last - cs), 0 past Q

  // the warp index broadcast from lane 0, so that the compiler knows it is
  // the same across the warp (no divergence handling around mma.sync)
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int nps = (P + PS - 1) / PS;  // slices of P a head
  const int p0 = (blockIdx.x % nps) * PS, h = blockIdx.x / nps, b = blockIdx.y;
  const float Ah = a.A[h] * Decay<T>::SCALE;
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* Bg = static_cast<const T*>(a.B);
  const T* Cg = static_cast<const T*>(a.C);
  T* y = static_cast<T*>(a.y);
  const size_t xstride = (size_t)H * P;

  // the state slice's accumulators: rows 16 sp.. of the slice, 16-column
  // blocks 2 m + sh of N
  const int sp = warp & 1, sh = warp >> 1;
  float st[NKM / 2][2][4];
  Af<IN> cf[CREG ? NKM : 1];  // C's fragments of the warp's current row block

  // one walk of the chunks a tile of Nt columns of N (the state's columns are
  // independent; y sums over them, in ys between tiles)
  for (int n0 = 0; n0 < N; n0 += a.Nt) {
    const int ncols = min(a.Nt, N - n0);
    const bool last_tile = n0 + a.Nt >= N;
#pragma unroll
    for (int m = 0; m < NKM / 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) st[m][n][0] = st[m][n][1] = st[m][n][2] = st[m][n][3] = 0.f;

    for (int s0 = 0; s0 < S; s0 += Q) {
      const int qn = min(Q, S - s0);           // live steps of the chunk (the last may be short)
      const size_t row0 = (size_t)b * S + s0;  // first (b, s) row of the chunk
      const T* xc = x + row0 * xstride + (size_t)h * P + p0;  // the slice's first row
      stage_tile<T>(Bs, ldt, Bg + row0 * N + n0, N, qn, ncols, Qp, Np, a.vec & VEC_BC);
      if constexpr (!CREG)
        stage_tile<T>(Cs, ldt, Cg + row0 * N + n0, N, qn, ncols, Qp, Np, a.vec & VEC_BC);
      if constexpr (IN == 1) {  // bf16 x is its own part: straight into Xp
        stage_tile<T>(reinterpret_cast<T*>(Xp), XLD, xc, xstride, qn, P - p0, Qp, PS,
                      a.vec & VEC_X);
      } else {
        stage_tile<T>(Xr, PS, xc, xstride, qn, P - p0, Qp, PS, a.vec & VEC_X);
      }
      amma::cp_async_commit();
      if constexpr (CREG)  // the first row block's C, in flight during the staging
        load_c_rows<NKM>(cf, reinterpret_cast<const bf16*>(Cg) + row0 * Np, qn, 16 * warp);
      // the state entering the chunk in K parts: for bf16 inputs now, while the
      // copies are in flight (for fp32 inputs the region still holds raw x)
      auto write_state_parts = [&]() {
#pragma unroll
        for (int m = 0; m < NKM / 2; ++m) {
          if (2 * m + sh < nk) {
#pragma unroll
            for (int n = 0; n < 2; ++n) {
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                uint32_t pr[K];
                split<K>(st[m][n][2 * hr], st[m][n][2 * hr + 1], pr);
                const int row = 16 * sp + g + 8 * hr, col = 16 * (2 * m + sh) + 8 * n + 2 * t;
#pragma unroll
                for (int k = 0; k < K; ++k)
                  *reinterpret_cast<uint32_t*>(Sp + (k * PS + row) * lds + col) = pr[k];
              }
            }
          }
        }
      };
      if constexpr (IN == 1) write_state_parts();
      if (warp == 0) {  // dt and cs: a run of steps a lane, then across lanes, while
                        // the copies are in flight
        const int run = (Qp + 31) / 32, i0 = lane * run, i1 = min(i0 + run, Qp);
#pragma unroll 4
        for (int i = i0; i < i1; ++i) sdt[i] = i < qn ? to_f(dt[(row0 + i) * H + h]) : 0.f;
        float acc = 0.f;
        for (int i = i0; i < i1; ++i) scs[i] = acc += sdt[i] * Ah;
        float incl = acc;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += u;
        }
        const float last = __shfl_sync(0xffffffffu, incl, 31), off = incl - acc;
        for (int i = i0; i < i1; ++i) {
          const float c = scs[i] + off;
          scs[i] = c;
          sdd[i] = i < qn ? sdt[i] * Decay<T>::exp(last - c) : 0.f;
        }
      }
      amma::cp_async_wait<0>();
      __syncthreads();
      if constexpr (IN > 1) {  // fp32 x in IN parts, 8 values a thread
        for (int e = tid; e < Qp * PS / 8; e += NT) {
          const int q = e / (PS / 8), p = (e - q * (PS / 8)) * 8;
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = to_f(Xr[q * PS + p + j]);
#pragma unroll
          for (int k = 0; k < IN; ++k) {
            uint4 o;
            uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const __nv_bfloat162 hv = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
              const float2 f = __bfloat1622float2(hv);
              w[j] = amma::bits(hv);
              v[2 * j] -= f.x;
              v[2 * j + 1] -= f.y;
            }
            *reinterpret_cast<uint4*>(Xp + (k * Qp + q) * XLD + p) = o;
          }
        }
        __syncthreads();  // the raw x is split: the region takes the state's parts
        write_state_parts();
        __syncthreads();
      }
      if (s0 + Q < S) {  // the next chunk's x slice and B rows into L2
        const size_t next = row0 + Q;
        for (int i = tid; i < min(Q, S - s0 - Q); i += NT) {
          prefetch_l2(x + (next + i) * xstride + (size_t)h * P + p0);
          prefetch_l2(Bg + (next + i) * N + n0);
        }
      }

      // the state: S <- exp(cs_last) S + (x o dt exp(cs_last - cs))^T B, one
      // 16-step block of q a call; the steps are independent of y, so the y
      // loop below takes one after each pair of score blocks
      const float dall = Decay<T>::exp(scs[Qp - 1]);
#pragma unroll
      for (int m = 0; m < NKM / 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[m][n][e] *= dall;
      int qs = 0;  // the next state step
      auto state_step = [&]() {
        const Af<K> xa = load_a_km_scaled<IN, K>(Xp, XLD, Qp * XLD, 16 * sp, 16 * qs, sdd);
#pragma unroll
        for (int m = 0; m < NKM / 2; ++m) {
          if (2 * m + sh < nk) {
            Bf<IN> bb[2];
            load_b_kn2<T>(Bs, ldt, 16 * qs, 16 * (2 * m + sh), bb);
            mma_parts<K, IN, K>(st[m][0], xa, bb[0]);
            mma_parts<K, IN, K>(st[m][1], xa, bb[1]);
          }
        }
        ++qs;
      };

      // y, one 16-row block at a time: blocks warp and 2 NW - 1 - warp of
      // every 2 NW
      for (int r = 0;; ++r) {
        const int ib = r * NW + ((r & 1) ? NW - 1 - warp : warp);
        if (ib >= nb) break;
        const int i0 = 16 * ib;
        if constexpr (CREG) {
          if (r > 0)
            load_c_rows<NKM>(cf, reinterpret_cast<const bf16*>(Cg) + row0 * Np, qn, i0);
        }
        auto cfrag = [&](int kk) -> Af<IN> {
          if constexpr (CREG) return cf[kk];
          else return load_a_rm<T>(Cs, ldt, i0, 16 * kk);
        };
        float acc[PS / 8][4];
#pragma unroll
        for (int n = 0; n < PS / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        // y_off = exp(cs) o (C S^T)
#pragma unroll
        for (int kk = 0; kk < NKM; ++kk) {
          if (kk < nk) {
            const Af<IN> c = cfrag(kk);
#pragma unroll
            for (int ph = 0; ph < PS / 16; ++ph) {
              Bf<K> sb[2];
              load_b_nk2_parts<K>(Sp, lds, PS * lds, 16 * ph, 16 * kk, sb);
              mma_parts<IN, K, K>(acc[2 * ph], c, sb[0]);
              mma_parts<IN, K, K>(acc[2 * ph + 1], c, sb[1]);
            }
          }
        }
        const float e0 = Decay<T>::exp(scs[i0 + g]), e1 = Decay<T>::exp(scs[i0 + g + 8]);
#pragma unroll
        for (int n = 0; n < PS / 8; ++n) {
          acc[n][0] *= e0;
          acc[n][1] *= e0;
          acc[n][2] *= e1;
          acc[n][3] *= e1;
        }
        // y_diag = (C B^T o L o dt) x over the blocks jb <= ib, NJ at a time
        const float c0 = scs[i0 + g], c1 = scs[i0 + g + 8];
        auto diag = [&](auto nj, int jb) {
          constexpr int NJ = decltype(nj)::v;
          float s[NJ][2][4] = {};
#pragma unroll
          for (int kk = 0; kk < NKM; ++kk) {
            if (kk < nk) {
              const Af<IN> c = cfrag(kk);
#pragma unroll
              for (int u = 0; u < NJ; ++u) {
                Bf<IN> bb[2];
                load_b_nk2<T>(Bs, ldt, 16 * (jb + u), 16 * kk, bb);
                mma_parts<IN, IN, K>(s[u][0], c, bb[0]);
                mma_parts<IN, IN, K>(s[u][1], c, bb[1]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < NJ; ++u) {
            const int j0 = 16 * (jb + u);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const float2 cj = *reinterpret_cast<const float2*>(scs + j0 + 8 * n + 2 * t);
              const float2 dj = *reinterpret_cast<const float2*>(sdt + j0 + 8 * n + 2 * t);
              if (jb + u < ib) {  // below the diagonal: every i > j
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  s[u][n][e] *= Decay<T>::exp((e < 2 ? c0 : c1) - ((e & 1) ? cj.y : cj.x)) *
                                ((e & 1) ? dj.y : dj.x);
              } else {  // the diagonal block: exp(cs_i - cs_j) only where i >= j (the
                        // argument 0 above the diagonal, the product not selected)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int i = g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
                  const float d = (e < 2 ? c0 : c1) - ((e & 1) ? cj.y : cj.x);
                  const float v = s[u][n][e] * Decay<T>::exp(j <= i ? d : 0.f) *
                                  ((e & 1) ? dj.y : dj.x);
                  s[u][n][e] = j <= i ? v : 0.f;
                }
              }
            }
            Af<K> ga;
            split<K>(s[u][0][0], s[u][0][1], ga.r[0]);
            split<K>(s[u][0][2], s[u][0][3], ga.r[1]);
            split<K>(s[u][1][0], s[u][1][1], ga.r[2]);
            split<K>(s[u][1][2], s[u][1][3], ga.r[3]);
#pragma unroll
            for (int ph = 0; ph < PS / 16; ++ph) {
              Bf<IN> xb[2];
              load_b_kn2_parts<IN>(Xp, XLD, Qp * XLD, j0, 16 * ph, xb);
              mma_parts<K, IN, K>(acc[2 * ph], ga, xb[0]);
              mma_parts<K, IN, K>(acc[2 * ph + 1], ga, xb[1]);
            }
          }
        };
        int jb = 0;
        for (; jb < ib; jb += 2) {
          diag(Int<2>{}, jb);
          if (qs < nb) state_step();
        }
        if (jb == ib) diag(Int<1>{}, jb);
#pragma unroll
        for (int n = 0; n < PS / 8; ++n) {
          const int col = p0 + 8 * n + 2 * t;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = i0 + g + 8 * hr;
            if (i >= qn) continue;
            const size_t yo = ((row0 + i) * H + h) * P;
            float v0 = acc[n][2 * hr], v1 = acc[n][2 * hr + 1];
            if (a.ys) {  // N in tiles: the running sum in fp32, in this thread's own words
              float* yw = a.ys + yo;
              if (n0 > 0) {
                if (col < P) v0 += yw[col];
                if (col + 1 < P) v1 += yw[col + 1];
              }
              if (!last_tile) {
                if (col < P) yw[col] = v0;
                if (col + 1 < P) yw[col + 1] = v1;
                continue;
              }
            }
            T* yr = y + yo;
            if (col + 1 < P && !(P & 1)) {
              if constexpr (sizeof(T) == 2) {
                *reinterpret_cast<__nv_bfloat162*>(yr + col) = __floats2bfloat162_rn(v0, v1);
              } else {
                *reinterpret_cast<float2*>(yr + col) = make_float2(v0, v1);
              }
            } else {
              if (col < P) yr[col] = from_f<T>(v0);
              if (col + 1 < P) yr[col + 1] = from_f<T>(v1);
            }
          }
        }
      }

      while (qs < nb) state_step();  // the state steps the y loop left
      __syncthreads();  // every read of the chunk's tiles is done
    }

    float* fin = a.fin + ((size_t)b * H + h) * P * N + n0;
#pragma unroll
    for (int m = 0; m < NKM / 2; ++m) {
      if (2 * m + sh >= nk) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * (2 * m + sh) + 8 * n + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int p = p0 + 16 * sp + g + 8 * hr;
          if (p >= P) continue;
          if (col < ncols) fin[(size_t)p * N + col] = st[m][n][2 * hr];
          if (col + 1 < ncols) fin[(size_t)p * N + col + 1] = st[m][n][2 * hr + 1];
        }
      }
    }
  }
}

// One launch of the instantiation, or (occ) only the CTAs of it an SM holds
// at once, by cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers,
// shared memory and the carveout as the launch sets them.
template <typename T, bool CREG, int NKM>
static int launch(const SSDArgs& a, int b, cudaStream_t stream, int* occ) {
  const size_t smem = smem_bytes<T, CREG>(a.Q, a.Nt);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, CREG, NKM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_kernel<T, CREG, NKM>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (occ)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, ssd_kernel<T, CREG, NKM>, NT,
                                                              smem);
  dim3 grid((a.P + PS - 1) / PS * a.H, b);
  ssd_kernel<T, CREG, NKM><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// C in registers where it can be (bf16, N 32, 64 or 128 in one tile, C
// 4-byte aligned): the wrapper's c_in_regs.
static bool c_in_regs(int dtype, int N, int Nt, const void* C) {
  return dtype == 1 && Nt == N && (N == 32 || N == 64 || N == 128) && (uintptr_t)C % 4 == 0;
}

template <typename T>
static int launch_n(const SSDArgs& a, int b, bool creg, cudaStream_t stream, int* occ) {
  const int nk = (a.Nt + 15) / 16;
  if constexpr (sizeof(T) == 2) {
    if (creg) {
      if (nk == 2) return launch<T, true, 2>(a, b, stream, occ);
      if (nk == 4) return launch<T, true, 4>(a, b, stream, occ);
      return launch<T, true, 8>(a, b, stream, occ);
    }
  }
  if (nk <= 2) return launch<T, false, 2>(a, b, stream, occ);
  if (nk <= 4) return launch<T, false, 4>(a, b, stream, occ);
  if (nk <= 8) return launch<T, false, 8>(a, b, stream, occ);
  return launch<T, false, 16>(a, b, stream, occ);
}

static int dispatch(int dtype, const SSDArgs& a, int b, cudaStream_t stream, int* occ) {
  const bool creg = c_in_regs(dtype, a.N, a.Nt, a.C);
  if (dtype == 1) return launch_n<bf16>(a, b, creg, stream, occ);
  return launch_n<float>(a, b, creg, stream, occ);
}

// Q: the chunk the kernel walks (the caller's, or a shorter one where the
// caller's tiles do not fit shared memory: the last chunk may be short).
// Nt: N, or the width of the tiles of N (a multiple of 16 up to NMAX), each
// walked apart with y's sum in ys ([b, S, H, P] fp32; null for one tile).
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt, const float* A,
                               const void* B, const void* C, void* y, float* fin, float* ys,
                               int b, int S, int H, int P, int N, int Q, int Nt, void* stream) {
  if (b <= 0 || b > 65535 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || Nt <= 0 ||
      Nt > NMAX || (Nt < N && (Nt % 16 != 0 || ys == nullptr)) || Nt > N)
    return (int)cudaErrorInvalidValue;
  const size_t es = dtype == 1 ? 2 : 4;
  const int vec = ((N * es) % 16 == 0 && (uintptr_t)B % 16 == 0 && (uintptr_t)C % 16 == 0
                       ? VEC_BC : 0) |
                  ((P * es) % 16 == 0 && (uintptr_t)x % 16 == 0 ? VEC_X : 0);
  SSDArgs a{x, dt, A, B, C, y, fin, Nt < N ? ys : nullptr, S, H, P, N, Q, Nt, vec};
  return dispatch(dtype, a, b, (cudaStream_t)stream, nullptr);
}

// The CTAs of the instantiation ssd_scan_launch would pick an SM holds at
// once (into *blocks); no launch.
extern "C" int ssd_scan_occupancy(int dtype, const void* C, int N, int Q, int Nt, int* blocks) {
  if (N <= 0 || Q <= 0 || Nt <= 0 || Nt > NMAX || Nt > N) return (int)cudaErrorInvalidValue;
  SSDArgs a{nullptr, nullptr, nullptr, nullptr, C, nullptr, nullptr, nullptr, 1, 1, 1, N, Q, Nt,
            0};
  return dispatch(dtype, a, 1, nullptr, blocks);
}
