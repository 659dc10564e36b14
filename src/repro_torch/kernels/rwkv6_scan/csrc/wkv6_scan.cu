// RWKV6 (Finch) WKV scan with a data-dependent per-channel decay, and its
// gradient, for Hopper (sm_90a); the backward and its two routes are
// described where it begins. Forward: r, k (B, S, H, K), v and y (B, S, H, V) of one type (f32
// or bf16); the decay w (B, S, H, K), the bonus u (H, K) and the
// final state (B, H, K, V) in f32; all contiguous. The state and every sum
// are f32; y is rounded to the input type once.
//
// Replaces the TPU kernel in src/repro/kernels/rwkv6_scan/kernel.py
// (wkv6_scan_pallas and its body _kernel).
//
// Semantics, per (b, h), from a zero state:
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T                 (K, V)
// The TPU kernel's chunked form rebuilds the within-chunk part from the
// masked decay exp(cum_excl[t] - cum[u]) in a (chunk, chunk, K) f32 tile:
// 256 KiB at chunk 32 and K 64, more than the 227 KB a block can hold here.
//
// What bounds it on this card: bytes. At the rwkv6-7b prefill shape (B 4,
// S 1024, H 64, K = V = 64) the function reads r, k, v (bf16) and w (f32)
// and writes y and the state once, about 206 MB, 0.061 ms at 3.35 TB/s.
//
// Two routes, chosen by the input type alone:
//
// f32: the first design, token by token on CUDA cores, w_t multiplying the
// state directly (exact for any decay in (0, 1), no exponent, no clamp). One
// block of 256 threads per (head, batch row), the (K, V) state in registers
// (4 threads share column j, 16 entries each), 32 tokens staged per pass as
// f32. What held it back, as the bf16 route (0.61 ms at the path shape on an
// H100 SXM): every token costs each thread 16 state FMAs, 16 multiplies, a
// 16-long dependent FMA chain and two shuffles (1.1 G element updates at
// that shape, on CUDA cores) while the tensor cores sit idle. Each pass's
// loads are scalar reads behind a barrier, with nothing in flight while its
// tokens compute, but the token loop set the time: a variant that staged
// once and reused the tile ran nearly as long. It stays for f32, whose 2e-4
// tolerance bf16 products cannot meet.
//
// bf16: a chunked scan on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate) that never builds the (chunk, chunk, K) tile, takes no
// exp or log and clamps nothing. 32-token chunks, one block of 8 warps per
// (head, batch row), 112,896 bytes of shared memory (two blocks an SM: the
// path's 256 blocks run in one wave). Per chunk:
//  * loads: r, k, v (bf16) and w (f32) in 16-byte cp.async copies into a
//    two-stage ring; the next chunk's copies are issued before this one
//    computes. bf16 tiles have 64 columns with 16-byte units XOR-swizzled
//    by row; padded rows and columns are zeros, a padded token decays by 1;
//  * decays: one thread per (column, 8 tokens) forms running products of w
//    (the FMA pipe): r times the product since the chunk's start (y's
//    inter-chunk operand), k times the product to its end (the state's);
//  * scores A[t][u], u < t: the pair is taken at the level l (16, 8, 4, 2,
//    1) where t falls in the upper and u in the lower half of an aligned
//    2l-token block, as (r_t prod_{m <= i < t} w_i) . (k_u prod_{u < i < m}
//    w_i), m the block's middle: both factors are decays in (0, 1), so
//    nothing overflows and a factor that underflows to 0 stands for a
//    product smaller still. Each level is one 16 x 16 x 64 product on the
//    tensor cores (each token a query or a key at each level), masked to
//    its pairs, one level a warp; the bonus u makes the diagonal (sum_k
//    r u k, reduced with shuffles in the decay pass). Exact 16 x 16
//    diagonal blocks on CUDA cores, a 15-step product chain a row, set the
//    critical path of a chunk in an earlier version of this route;
//  * y = (r decayed) S + A v; state: S <- diag(prod w) S + (k decayed)^T
//    v, S the f32 accumulator in registers;
//  * every operand that is not a bf16 input (the decayed r and k, each
//    level's operands, A, the state as y reads it) is split into bf16 hi =
//    bf16(f) and lo = bf16(f - hi): two products where the other operand
//    is exact (v, the raw r and k), three (hi hi, hi lo, lo hi) where
//    neither is, in separate accumulators. One bf16 rounding errs by about
//    2^-9 of each term, and y is a sum of terms far larger than itself:
//    in an earlier version that reached 1.5e-1 at the path shape against
//    the 2e-2 tolerance (tests/test_torch_scan_design.py models it);
//  * each warp forms one level of A, then its 16 x 16 tile of y, then its
//    16 x 32 tile of the state; five barriers a chunk, and 128 registers a
//    thread (two blocks of 256 threads an SM); the final state leaves the
//    registers once.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerCol = 4;                    // threads sharing column j
constexpr int kMaxV = kThreads / kLanesPerCol;     // 64
constexpr int kMaxK = 64;
constexpr int kPerThread = kMaxK / kLanesPerCol;   // 16 state entries
constexpr int kTokens = 32;                        // tokens staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, T* __restrict__ y,
                     float* __restrict__ state, int S, int H, int K, int V) {
  __shared__ __align__(16) float rs[kTokens][kMaxK];
  __shared__ __align__(16) float ks[kTokens][kMaxK];
  __shared__ __align__(16) float ws[kTokens][kMaxK];
  __shared__ __align__(16) float vs[kTokens][kMaxV];
  __shared__ __align__(16) float ys[kTokens][kMaxV];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = tid / kLanesPerCol;
  const int q = tid % kLanesPerCol;
  const int groups = K / 16;   // float4 groups of this thread's column share

  float s[kPerThread];
  float uu[kPerThread];
#pragma unroll
  for (int g = 0; g < kPerThread / 4; ++g) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[4 * g + c] = 0.f;
      uu[4 * g + c] = g < groups ? u[static_cast<size_t>(h) * K + 4 * (q + kLanesPerCol * g) + c]
                                 : 0.f;
    }
  }

  for (int t0 = 0; t0 < S; t0 += kTokens) {
    const int nt = min(kTokens, S - t0);
    for (int i = tid; i < nt * K; i += kThreads) {
      const int t = i / K;
      const int c = i % K;
      const size_t at = ((static_cast<size_t>(b) * S + t0 + t) * H + h) * K + c;
      rs[t][c] = to_f32(r[at]);
      ks[t][c] = to_f32(k[at]);
      ws[t][c] = w[at];
    }
    for (int i = tid; i < nt * V; i += kThreads) {
      const int t = i / V;
      const int c = i % V;
      vs[t][c] = to_f32(v[((static_cast<size_t>(b) * S + t0 + t) * H + h) * V + c]);
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float vj = j < V ? vs[t][j] : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int g = 0; g < kPerThread / 4; ++g) {
        if (g < groups) {
          const int k0 = 4 * (q + kLanesPerCol * g);
          const float4 rv = *reinterpret_cast<const float4*>(&rs[t][k0]);
          const float4 kv = *reinterpret_cast<const float4*>(&ks[t][k0]);
          const float4 wv = *reinterpret_cast<const float4*>(&ws[t][k0]);
          const float r4[4] = {rv.x, rv.y, rv.z, rv.w};
          const float k4[4] = {kv.x, kv.y, kv.z, kv.w};
          const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = 4 * g + c;
            const float kvj = k4[c] * vj;
            acc = fmaf(r4[c], fmaf(uu[e], kvj, s[e]), acc);
            s[e] = fmaf(w4[c], s[e], kvj);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0 && j < V) ys[t][j] = acc;
    }
    __syncthreads();

    for (int i = tid; i < nt * V; i += kThreads) {
      const int t = i / V;
      const int c = i % V;
      y[((static_cast<size_t>(b) * S + t0 + t) * H + h) * V + c] = from_f32<T>(ys[t][c]);
    }
    // the next pass writes rs / ks / ws / vs only after every thread has
    // left the token loop (the barrier above), and ys only after the
    // barrier that follows its staging
  }

  if (j < V) {
    float* out = state + static_cast<size_t>(b * H + h) * K * V + j;
#pragma unroll
    for (int g = 0; g < kPerThread / 4; ++g) {
      if (g < groups) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          out[static_cast<size_t>(4 * (q + kLanesPerCol * g) + c) * V] = s[4 * g + c];
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 route

constexpr int kTcThreads = 256;                 // 8 warps
constexpr int kTcChunk = 32;                    // tokens per chunk
constexpr int kSub = 16;                        // sub-chunk: the bf16 mma depth
constexpr int kTcCols = 64;                     // K and V, padded in shared memory
constexpr int kTile = kTcChunk * kTcCols * 2;   // one bf16 chunk tile, bytes
constexpr int kStageBytes = 3 * kTile + kTcChunk * kTcCols * 4;  // r, k, v; w in f32
constexpr int kQuarter = 2 * kStageBytes;      // 8-token products of w, f32 [4][64]
constexpr int kBonusPart = kQuarter + 4 * kTcCols * 4;   // sum_k r u k per half of k, f32 [2][32]
// below, each f32 operand is kept as two bf16 chunk tiles, hi then lo
constexpr int kRdec = kBonusPart + 2 * kTcChunk * 4;   // r times w's product since the chunk's start
constexpr int kKt = kRdec + 2 * kTile;         // k times w's product to the chunk's end
constexpr int kL16 = kKt + 2 * kTile;          // level 16, 8, 4, 2 operands (see the kernel)
constexpr int kL8 = kL16 + 2 * kTile;
constexpr int kL4 = kL8 + 2 * kTile;
constexpr int kL2 = kL4 + 2 * kTile;
constexpr int kA = kL2 + 2 * kTile;            // the chunk's scores A, f32 [32][kAStride]
constexpr int kAStride = 40;
constexpr int kState = kA + kTcChunk * kAStride * 4;   // the state, rows k, cols v
constexpr int kTcSmemBytes = kState + 2 * kTcCols * kTcCols * 2;   // 112,896

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int swz(int row, int col) {
  return row * kTcCols + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__low2float(h), __high2float(h));
}

// (a, b) as bf16 pairs hi = bf16(f) and lo = bf16(f - hi): a product with
// hi and one with lo recover f to about 2^-16
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(a - __low2float(h), b - __high2float(h));
}

// f32 (a, b) at element e of the hi tile, and its remainder at e of lo
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int e, float a, float b) {
  uint32_t h, l;
  split2(a, b, h, l);
  *reinterpret_cast<uint32_t*>(hi + e) = h;
  *reinterpret_cast<uint32_t*>(lo + e) = l;
}

// ldmatrix lane addresses for a 16 x 16 block at (r0, c0), as in ssd_scan.cu:
// A from a tile of rows m, cols k; A from a tile stored k x m (.trans); B
// (two n8 tiles) from a tile of rows n, cols k; B from a tile stored k x n
// (.trans)
__device__ __forceinline__ int a_off(int r0, int c0, int l) {
  return swz(r0 + (l & 15), c0 + ((l >> 4) << 3));
}
__device__ __forceinline__ int at_off(int r0, int c0, int l) {
  return swz(r0 + (l & 7) + ((l >> 4) << 3), c0 + (((l >> 3) & 1) << 3));
}
__device__ __forceinline__ int b_off(int r0, int c0, int l) {
  return swz(r0 + (l & 7) + ((l >> 4) << 3), c0 + (((l >> 3) & 1) << 3));
}
__device__ __forceinline__ int bt_off(int r0, int c0, int l) {
  return swz(r0 + (l & 7) + (((l >> 3) & 1) << 3), c0 + ((l >> 4) << 3));
}

// a chunk's rows of a (rows, cols) bf16 source into a swizzled tile, row t
// at src + t * stride; rows at or past nt and columns past cols (already
// zero) stay zeros. kVec: 16-byte cp.async copies; otherwise element-wise.
template <bool kVec>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t stride,
                                          int cols, int nt, int tid) {
  if (kVec) {
    const int units = cols >> 3;
    for (int i = tid; i < kTcChunk * 8; i += kTcThreads) {
      const int t = i >> 3;
      const int j = i & 7;
      if (j < units)
        cp_async16(tile + swz(t, j << 3), t < nt ? src + t * stride + (j << 3) : src, t < nt);
    }
  } else {
    for (int i = tid; i < kTcChunk * cols; i += kTcThreads) {
      const int t = i / cols;
      const int c = i % cols;
      tile[swz(t, c)] = t < nt ? src[t * stride + c] : __float2bfloat16(0.f);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const bf16* r, const bf16* k,
                                           const bf16* v, const float* w, int b, int h, int t0,
                                           int S, int H, int K, int V, int tid) {
  const int nt = min(kTcChunk, S - t0);
  const size_t row0 = static_cast<size_t>(b) * S + t0;
  const size_t kst = static_cast<size_t>(H) * K;
  const size_t koff = (row0 * H + h) * K;
  load_tile<kVec>(reinterpret_cast<bf16*>(stage), r + koff, kst, K, nt, tid);
  load_tile<kVec>(reinterpret_cast<bf16*>(stage + kTile), k + koff, kst, K, nt, tid);
  load_tile<kVec>(reinterpret_cast<bf16*>(stage + 2 * kTile), v + (row0 * H + h) * V,
                  static_cast<size_t>(H) * V, V, nt, tid);
  float* ws = reinterpret_cast<float*>(stage + 3 * kTile);   // [32][64], not swizzled
  if (kVec) {
    const int units = K >> 2;
    for (int i = tid; i < kTcChunk * 16; i += kTcThreads) {
      const int t = i >> 4;
      const int j = i & 15;
      if (j < units)
        cp_async16(ws + t * kTcCols + 4 * j, t < nt ? w + koff + t * kst + 4 * j : w, t < nt);
    }
  } else {
    for (int i = tid; i < kTcChunk * K; i += kTcThreads) {
      const int t = i / K;
      const int c = i % K;
      ws[t * kTcCols + c] = t < nt ? w[koff + t * kst + c] : 0.f;
    }
  }
  cp_async_commit();
}

// f32 value f as bf16 hi at element e of a tile and its remainder at e + lo
__device__ __forceinline__ void store_split1(bf16* tile, int lo, int e, float f) {
  const bf16 hi = __float2bfloat16(f);
  tile[e] = hi;
  tile[lo + e] = __float2bfloat16(f - __bfloat162float(hi));
}

// d_hh + d_hl + d_lh += a b over 16 x 64 by 16 (two n8 tiles) x 64: a and
// b each as hi + lo tiles (lo at +lo elements), a's rows at a0, b's rows
// (n) at b0; three accumulator sets, so the three products do not wait on
// one another
__device__ __forceinline__ void mma_x3(float (&d)[3][2][4], const bf16* a, int a0,
                                       const bf16* b, int b0, int lo, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ah[4], al[4], bh[4], bl[4];
    ldsm_x4(ah, a + a_off(a0, 16 * kk, lane));
    ldsm_x4(al, a + lo + a_off(a0, 16 * kk, lane));
    ldsm_x4(bh, b + b_off(b0, 16 * kk, lane));
    ldsm_x4(bl, b + lo + b_off(b0, 16 * kk, lane));
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mma(d[0][n], ah, bh[2 * n], bh[2 * n + 1]);
      mma(d[1][n], ah, bl[2 * n], bl[2 * n + 1]);
      mma(d[2][n], al, bh[2 * n], bh[2 * n + 1]);
    }
  }
}

// kStates: the backward's state sweep. It computes no y, no scores and no
// final state; before each chunk it writes the state it enters with, as
// bf16 hi and lo planes (64 x 64, row-major), to `states` (B, H, chunks, 2,
// 64, 64).
template <bool kVec, bool kStates>
__global__ void __launch_bounds__(kTcThreads, 2)
    wkv6_scan_tc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ w,
                        const float* __restrict__ u, bf16* __restrict__ y,
                        float* __restrict__ state, bf16* __restrict__ states, int S, int H,
                        int K, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int wp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;        // fragment row
  const int c2 = (lane & 3) * 2;  // fragment column pair
  float* qtot = reinterpret_cast<float*>(smem + kQuarter);
  float* bpart = reinterpret_cast<float*>(smem + kBonusPart);
  // hi tiles; each lo tile follows its hi tile, kLo elements on
  bf16* rdec = reinterpret_cast<bf16*>(smem + kRdec);
  bf16* kt = reinterpret_cast<bf16*>(smem + kKt);
  bf16* l16 = reinterpret_cast<bf16*>(smem + kL16);
  bf16* l8 = reinterpret_cast<bf16*>(smem + kL8);
  bf16* l4 = reinterpret_cast<bf16*>(smem + kL4);
  bf16* l2 = reinterpret_cast<bf16*>(smem + kL2);
  float* A = reinterpret_cast<float*>(smem + kA);
  bf16* st = reinterpret_cast<bf16*>(smem + kState);
  constexpr int kLo = kTile / 2;
  constexpr int kStateLo = kTcCols * kTcCols;

  // zeros everywhere once: padding columns, A's entries no level writes,
  // and the state
  for (int i = tid; i < kTcSmemBytes / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int n_chunks = (S + kTcChunk - 1) / kTcChunk;
  load_chunk<kVec>(smem, r, k, v, w, b, h, 0, S, H, K, V, tid);

  // the state's tile of this warp: rows k = kr + g (+8), cols v = vc + 8j + c2 (+1)
  const int kr = 16 * (wp & 3);
  const int vc = 32 * (wp >> 2);
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

  // the products' thread: column kc, tokens 8q .. 8q + 7
  const int kc = tid & 63;
  const int q = tid >> 6;
  const float ub = kc < K ? u[static_cast<size_t>(h) * K + kc] : 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kTcChunk;
    const int nt = min(kTcChunk, S - t0);
    unsigned char* stage = smem + (ci & 1) * kStageBytes;
    const bf16* rs = reinterpret_cast<const bf16*>(stage);
    const bf16* ks = reinterpret_cast<const bf16*>(stage + kTile);
    const bf16* vs = reinterpret_cast<const bf16*>(stage + 2 * kTile);
    const float* ws = reinterpret_cast<const float*>(stage + 3 * kTile);
    cp_async_wait_all();
    __syncthreads();   // this chunk has landed; the previous one is done with
    if (ci + 1 < n_chunks)
      load_chunk<kVec>(smem + ((ci + 1) & 1) * kStageBytes, r, k, v, w, b, h,
                       t0 + kTcChunk, S, H, K, V, tid);
    if constexpr (kStates) {
      // the state this chunk enters with (its planes in st since the last
      // chunk's end), out in 16-byte units
      bf16* out = states + ((static_cast<size_t>(b) * H + h) * n_chunks + ci) * 2 * kStateLo;
      for (int i = tid; i < 2 * kTcCols * 8; i += kTcThreads) {
        const int plane = i >> 9;
        const int row = (i >> 3) & 63;
        const int j = i & 7;
        *reinterpret_cast<uint4*>(out + plane * kStateLo + row * kTcCols + 8 * j) =
            *reinterpret_cast<const uint4*>(st + plane * kStateLo + swz(row, 8 * j));
      }
    }

    // Decays as running products of w along the column (the FMA pipe, no
    // exp, no log, no clamp): pre[i] = prod of w over this 8-token quarter
    // before token i, suf[i] after it. A padded token decays by 1.
    float wv[8], rr[8], kv[8], pre[8], suf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * q + i;
      wv[i] = t < nt ? ws[t * kTcCols + kc] : 1.f;
      rr[i] = __bfloat162float(rs[swz(t, kc)]);
      kv[i] = __bfloat162float(ks[swz(t, kc)]);
    }
    pre[0] = 1.f;
#pragma unroll
    for (int i = 1; i < 8; ++i) pre[i] = pre[i - 1] * wv[i - 1];
    suf[7] = 1.f;
#pragma unroll
    for (int i = 6; i >= 0; --i) suf[i] = suf[i + 1] * wv[i + 1];
    qtot[q * kTcCols + kc] = pre[7] * wv[7];

    if constexpr (!kStates) {
    // The scores A[t][u] (u < t) of a chunk are split by the level at which
    // t and u first fall into different halves of an aligned block: level
    // l (16, 8, 4, 2, 1) pairs a query t in the upper half of a 2l-token
    // block with a key u in its lower half, m the block's middle, as
    //   (r_t prod_{m <= i < t} w_i) . (k_u prod_{u < i < m} w_i)
    // so each factor is a product of decays in (0, 1): nothing overflows,
    // and a factor that underflows to 0 stands for a product smaller still.
    // Each token is a query or a key at each level; the level-l tile holds
    // its operand. Levels 8, 4, 2 lie inside a quarter.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = swz(8 * q + i, kc);
      store_split1(l8, kLo, e, (q & 1) ? rr[i] * pre[i] : kv[i] * suf[i]);
      float p4 = 1.f;   // the product inside the 8-token block, from or to its middle
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (i >= 4 && j >= 4 && j < i) p4 *= wv[j];
        if (i < 4 && j > i && j < 4) p4 *= wv[j];
      }
      store_split1(l4, kLo, e, i >= 4 ? rr[i] * p4 : kv[i] * p4);
      const float p2 = (i & 3) == 3 ? wv[i - 1] : (i & 3) == 0 ? wv[i + 1] : 1.f;
      store_split1(l2, kLo, e, (i & 2) ? rr[i] * p2 : kv[i] * p2);
    }
    // the bonus u on the diagonal: sum_k r_t u k_t over the warp's 32
    // columns, the 8 tokens' sums reduce-scattered over the lanes (9
    // shuffles), then over the two halves of k when A is formed
    {
      float bs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) bs[i] = rr[i] * ub * kv[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // lanes with bit 16 keep tokens 4..7
        const bool up = lane & 16;
        const float recv = __shfl_xor_sync(0xffffffffu, up ? bs[j] : bs[j + 4], 16);
        bs[j] = (up ? bs[j + 4] : bs[j]) + recv;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {   // bit 8: the upper pair of those four
        const bool up = lane & 8;
        const float recv = __shfl_xor_sync(0xffffffffu, up ? bs[j] : bs[j + 2], 8);
        bs[j] = (up ? bs[j + 2] : bs[j]) + recv;
      }
      {                               // bit 4: the upper one of those two
        const bool up = lane & 4;
        const float recv = __shfl_xor_sync(0xffffffffu, up ? bs[0] : bs[1], 4);
        bs[0] = (up ? bs[1] : bs[0]) + recv;
      }
      bs[0] += __shfl_xor_sync(0xffffffffu, bs[0], 2);
      bs[0] += __shfl_xor_sync(0xffffffffu, bs[0], 1);
      if ((lane & 3) == 0)
        bpart[(kc >> 5) * kTcChunk + 8 * q + ((lane >> 2) & 7)] = bs[0];
    }
    }   // !kStates
    __syncthreads();   // the quarters' products
    {
      float before = 1.f, after = 1.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float Q = qtot[qq * kTcCols + kc];
        if (qq < q) before *= Q;
        if (qq > q) after *= Q;
      }
      // level 16 (the chunk's halves): queries in quarters 2, 3, keys in 0, 1
      const float m16 = q == 3 ? qtot[2 * kTcCols + kc] : q == 0 ? qtot[kTcCols + kc] : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = swz(8 * q + i, kc);
        store_split1(kt, kLo, e, kv[i] * (suf[i] * after));
        if constexpr (!kStates) {
          store_split1(rdec, kLo, e, rr[i] * (before * pre[i]));
          store_split1(l16, kLo, e, q >= 2 ? rr[i] * (pre[i] * m16) : kv[i] * (suf[i] * m16));
        }
      }
    }
    __syncthreads();   // every level's operands are complete

    if constexpr (!kStates) {

    // A, one level of one 16-token sub-chunk per warp: warp (sb, lv) takes
    // level 8 >> lv of sub-chunk sb; warp (0, 3) also level 16, warp (sb, 3)
    // level 1 (the raw r and k) and the bonus. Each entry of A below the
    // diagonal belongs to one level, so the warps' stores never overlap.
    {
      const int sb = wp >> 2;
      const int lv = wp & 3;
      const int b0 = kSub * sb;
      float d[3][2][4] = {};
      if (lv < 3) {
        const bf16* L = lv == 0 ? l8 : lv == 1 ? l4 : l2;
        mma_x3(d, L, b0, L, b0, kLo, lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4], bf[4];
          ldsm_x4(af, rs + a_off(b0, 16 * kk, lane));
          ldsm_x4(bf, ks + b_off(b0, 16 * kk, lane));
          mma(d[0][0], af, bf[0], bf[1]);
          mma(d[0][1], af, bf[2], bf[3]);
        }
      }
      const int lvl = 8 >> lv;   // a query's half bit at this level
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = g + 8 * (e >> 1);
          const int ul = 8 * n + c2 + (e & 1);
          const bool ok = (tl / (2 * lvl)) == (ul / (2 * lvl)) && (tl & lvl) && !(ul & lvl);
          if (ok) A[(b0 + tl) * kAStride + b0 + ul] = d[0][n][e] + d[1][n][e] + d[2][n][e];
        }
      }
      if (lv == 3) {
        if (lane < kSub)
          A[(b0 + lane) * kAStride + b0 + lane] =
              bpart[b0 + lane] + bpart[kTcChunk + b0 + lane];
        if (sb == 0) {   // level 16: queries 16..31 against keys 0..15, all below
          float e16[3][2][4] = {};
          mma_x3(e16, l16, kSub, l16, 0, kLo, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              A[(kSub + g + 8 * (e >> 1)) * kAStride + 8 * n + c2 + (e & 1)] =
                  e16[0][n][e] + e16[1][n][e] + e16[2][n][e];
          }
        }
      }
    }
    __syncthreads();   // A is complete

    // y: warp (mt, nq) owns rows 16 mt.. and value columns nq..
    {
      const int mt = wp >> 2;
      const int nq = 16 * (wp & 3);
      // inter-chunk: rdec S, hi hi + hi lo + lo hi in separate sums
      float yi[3][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        ldsm_x4(ah, rdec + a_off(kSub * mt, 16 * kk, lane));
        ldsm_x4(al, rdec + kLo + a_off(kSub * mt, 16 * kk, lane));
        ldsm_x4_t(bh, st + bt_off(16 * kk, nq, lane));
        ldsm_x4_t(bl, st + kStateLo + bt_off(16 * kk, nq, lane));
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma(yi[0][n], ah, bh[2 * n], bh[2 * n + 1]);
          mma(yi[1][n], ah, bl[2 * n], bl[2 * n + 1]);
          mma(yi[2][n], al, bh[2 * n], bh[2 * n + 1]);
        }
      }
      // intra-chunk: A v, A (f32 in shared memory) as hi + lo fragments
      float ya[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk <= mt) {
          uint32_t ah[4], al[4], bf[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = kSub * mt + g + 8 * (i & 1);
            const int col = 16 * kk + c2 + 8 * (i >> 1);
            const float2 a2 = *reinterpret_cast<const float2*>(A + row * kAStride + col);
            split2(a2.x, a2.y, ah[i], al[i]);
          }
          ldsm_x4_t(bf, vs + bt_off(16 * kk, nq, lane));
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma(ya[0][n], ah, bf[2 * n], bf[2 * n + 1]);
            mma(ya[1][n], al, bf[2 * n], bf[2 * n + 1]);
          }
        }
      }
      const size_t row0 = static_cast<size_t>(b) * S + t0;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = nq + 8 * n + c2;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = kSub * mt + g + 8 * hh;
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 2 * hh + e;
            o[e] = yi[0][n][x] + yi[1][n][x] + yi[2][n][x] + ya[0][n][x] + ya[1][n][x];
          }
          if (t < nt && c < V) {
            bf16* out = y + ((row0 + t) * H + h) * V + c;
            if (kVec) {
              *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(o[0], o[1]);
            } else {
              out[0] = __float2bfloat16(o[0]);
              if (c + 1 < V) out[1] = __float2bfloat16(o[1]);
            }
          }
        }
      }
    }
    }   // !kStates

    // state: S <- diag(prod w) S + kt^T v, this warp's tile
    {
      float da = 1.f, db = 1.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        da *= qtot[qq * kTcCols + kr + g];
        db *= qtot[qq * kTcCols + kr + g + 8];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][0] *= da;
        s[j][1] *= da;
        s[j][2] *= db;
        s[j][3] *= db;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, kt + at_off(16 * kk, kr, lane));
        ldsm_x4_t(al, kt + kLo + at_off(16 * kk, kr, lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, vs + bt_off(16 * kk, vc + 16 * jp, lane));
          mma(s[2 * jp], ah, bf[0], bf[1]);
          mma(s[2 * jp], al, bf[0], bf[1]);
          mma(s[2 * jp + 1], ah, bf[2], bf[3]);
          mma(s[2 * jp + 1], al, bf[2], bf[3]);
        }
      }
    }

    __syncthreads();   // every warp is done reading the state's copies
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store_split(st, st + kStateLo, swz(kr + g, vc + 8 * j + c2), s[j][0], s[j][1]);
      store_split(st, st + kStateLo, swz(kr + g + 8, vc + 8 * j + c2), s[j][2], s[j][3]);
    }
  }

  if constexpr (kStates) return;
  // the final state, rows k < K, columns v < V
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = vc + 8 * j + c2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = kr + g + 8 * hh;
      if (row >= K) continue;
      float* out = state + (static_cast<size_t>(b) * H + h) * K * V + static_cast<size_t>(row) * V + c;
      if (c < V) out[0] = s[j][2 * hh];
      if (c + 1 < V) out[1] = s[j][2 * hh + 1];
    }
  }
}

cudaError_t launch_f32(const void* r, const void* k, const void* v, const void* w,
                       const void* u, void* y, void* state, int B, int S, int H, int K, int V,
                       cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_scan_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(state), S, H, K, V);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t launch_bf16(const void* r, const void* k, const void* v, const void* w,
                        const void* u, void* y, void* state, int B, int S, int H, int K,
                        int V, cudaStream_t stream) {
  const bool vec = V % 8 == 0 && aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(w) && aligned16(y);
  auto kernel = vec ? wkv6_scan_tc_kernel<true, false> : wkv6_scan_tc_kernel<false, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<bf16*>(y),
      static_cast<float*>(state), nullptr, S, H, K, V);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the backward
//
// Given dy (B, S, H, V) in the input type and optionally the gradient of
// the final state dF (B, H, K, V) f32: dr, dk, dv (input type), dw (B, S,
// H, K) f32, and through a last, summing launch du (H, K) f32.
//
// Replaces what the reference trains through: jax.grad of wkv6_chunked
// (src/repro/kernels/rwkv6_scan/ref.py), which XLA differentiates (no
// Pallas kernel of the reference defines a VJP).
//
// Per (b, h), with the adjoint of the state after token t, dS_{t-1} =
// diag(w_t) dS_t + r_t dy_t^T (dS_T = dF), and p_t = v_t . dy_t:
//     dr_t = S_{t-1} dy_t + u k_t p_t       dk_t = dS_t v_t + u r_t p_t
//     dv_t = dS_t^T k_t + (r_t . u k_t) dy_t
//     dw_t = rowsum(dS_t o S_{t-1})         du = sum r_t k_t p_t
// dw comes straight from the state and its adjoint at the same token: the
// form d(log w) / w, a cumulative sum of cancelling terms divided by w,
// loses every digit where w is near 1e-30. du sums over batch rows
// afterwards, from f32 partials in a fixed order (no atomics: the result
// is the same bitwise from call to call).
//
// What bounds it on this card: bytes, as the forward. At the rwkv6-7b
// training shape (B 4, S 1024, H 64, K = V = 64; r, k, v bf16, w f32) it
// must read r, k, v, w, dy and write dr, dk, dv, dw once, about 369 MB,
// 0.110 ms at 3.35 TB/s.
//
// Two routes, chosen by the input type alone:
//
// f32: the first design, token by token on CUDA cores (1.91 ms at the path
// shape on an NVIDIA H100 80GB HBM3 at 700 W, 17 times the bound: every
// token costs each thread about 70 state FMAs and a sum over the 64 rows
// of the state, one dependent chain a token, while the tensor cores sit
// idle). It stays for f32, whose inputs bf16 products cannot take exactly.
// One block of 256 threads per (head, batch row); thread (i, q) holds 16
// entries of row i of the state and of its adjoint in registers (columns
// 4 (q + 4 g) + e, padded to 64 with zeros), so the sums over V (dr, dk,
// dw) take two shuffles and only dv sums over rows. A first sweep runs the
// recurrence and saves the state before every 16-token chunk to a scratch
// buffer (B, H, ceil(S / 16), K, 64). The reverse sweep takes the chunks
// last to first: it stages the chunk's inputs in shared memory, steps the
// saved state 8 tokens on to a second copy, and for each token t (last to
// first) recomputes S_{t-1} from the nearer of the two in at most 7 steps.
// dv sums over the 64 rows by a reduce-scatter within the warp (14
// shuffles for 16 columns) into per-warp rows of shared memory, summed
// over the 8 warps once the chunk is done.
//
// bf16: the chunked form on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate), 32-token chunks, three launches:
//  1. the state sweep: the forward's bf16 kernel with kStates, which
//     writes the state entering each chunk as bf16 hi and lo planes to the
//     scratch (B, H, chunks, 2, 64, 64: 134 MB at the path shape against
//     the f32 route's 268 MB) and computes no y. The forward saves nothing
//     (under remat every layer would keep its states).
//  2. the reverse sweep, wkv6_scan_bwd_tc_kernel: one block of 8 warps per
//     (head, batch row) takes the chunks last to first, carrying dS_end
//     (the adjoint of the state the chunk ends with) in f32 registers as
//     the forward carries S. With a_t = prod_{i<t} w_i (since the chunk's
//     start), g_t = prod_{t<i<c} w_i (to its end), and each pair u < t of
//     the chunk taken at the forward's level (16, 8, 4, 2, 1), where t is
//     in the upper and u in the lower half of an aligned block with middle
//     m, its decay split into an upper factor prod_{m<=i<t} w_i and a
//     lower one prod_{u<i<m} w_i (the level's operand tile holds r times
//     the one, k times the other), per chunk:
//       A, the forward's levelled scores with the bonus on its diagonal;
//       M = dY V^T (exact), Z its strict lower part made symmetric;
//       PQ_l = (Z at level l) Lop_l: the level's dr product for its upper
//       tokens, its dk product for its lower ones, before their factors;
//       E = dY S_in^T, F = V dS_end^T;
//       dr = a o E + sum_l [upper] fac_l o PQ_l + u o k p
//       dk = g o F + sum_l [lower] fac_l o PQ_l + u o r p
//       dv = A^T dY + (k o g) dS_end
//       dS entering the chunk = diag(prod w) dS_end + (r o a)^T dY
//       dw = (a g) o rowsum(S_in o dS_end) + a o R + g o L + sum_l fac_l o S_l
//     with R a reverse scan of r o E over the chunk, L a forward scan of
//     k o F, and S_l a reverse scan of r o PQ_l over an upper half or a
//     forward scan of k o PQ_l over a lower one (the pairs u < t < tau
//     split at their level's middle). Every factor is a product of decays
//     in (0, 1], so nothing overflows and an underflow to 0 stands for a
//     smaller product; dw needs no product beyond those dr and dk take.
//     The products run on the tensor cores, each warp on its 8 channels
//     of E, F and PQ_l; 1 KB of scratch a warp turns each into a lane
//     layout (a channel, 8 tokens a lane) where the factors, the scans (in
//     the lane, then across the quarters' lanes by shuffles) and the
//     bonus are f32 FMAs. Rounding: dw and du are f32 outputs held to 1e-3
//     of (1 + |ref|), and dw is a sum of terms tens of times larger than
//     itself at some tokens: every operand that is not a bf16 input is
//     split into bf16 hi + lo, Z into three parts (hi, mid, lo: with two,
//     dw over 8 heads of the path length reads 5.5e-4 in the CPU model,
//     tests/test_torch_wkv_backward_design.py, which models the route; one
//     rounding of any operand misses a tolerance). Loads: one stage of r,
//     k, v, dy, w and the saved state's planes, issued once the chunk
//     before is done with them; w's region then holds the bonus sums, Z
//     and p. 111,616 bytes of shared memory and 128 registers a thread: 2
//     blocks an SM, so the path's 256 blocks run in one wave.
//  3. sum_mid_kernel sums the per-row partials of du in a fixed order.

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdChunk = 16;                  // tokens between saved states
constexpr int kBwdHalf = kBwdChunk / 2;        // the second copy's token
constexpr int kCols = 64;                      // state columns, zero-padded
constexpr int kBwdRow = kBwdChunk * kCols;     // one staged (token, column) tile
// the backward's dynamic shared memory, in floats: r, k, v, w, dy staged
// as f32 tiles, the three sums over V per (token, row), the per-token
// v . dy and r . u k, and the per-warp partial sums of dv
constexpr int kBwdR = 0;
constexpr int kBwdK = kBwdR + kBwdRow;
constexpr int kBwdV = kBwdK + kBwdRow;
constexpr int kBwdW = kBwdV + kBwdRow;
constexpr int kBwdDy = kBwdW + kBwdRow;
constexpr int kBwdSy = kBwdDy + kBwdRow;       // S_{t-1} dy_t
constexpr int kBwdSv = kBwdSy + kBwdRow;       // dS_t v_t
constexpr int kBwdSs = kBwdSv + kBwdRow;       // rowsum(dS_t o S_{t-1})
constexpr int kBwdScal = kBwdSs + kBwdRow;     // (v . dy, r . u k) per token
constexpr int kBwdRed = kBwdScal + 2 * kBwdChunk;
constexpr int kBwdSmemBytes = (kBwdRed + kBwdChunk * kBwdWarps * kCols) * 4;   // 65,664

// dst[t][c] = src[base + t * stride + c] as f32 for t < nt and c < width,
// zero elsewhere in the (kBwdChunk, kCols) tile
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, size_t base, size_t stride,
                                           int nt, int width) {
  for (int i = threadIdx.x; i < kBwdRow; i += kBwdThreads) {
    const int t = i / kCols;
    const int c = i % kCols;
    dst[i] = t < nt && c < width ? to_f32(src[base + t * stride + c]) : 0.f;
  }
}

// v summed over the 8 rows of the warp (lanes that differ in bits 2..4) by
// a reduce-scatter: the lane keeps the sums of v[i0] and v[i0 + 1], i0 = 8
// bit4 + 4 bit3 + 2 bit2, which are columns n0, n0 + 1 of its row's layout
// (returned through n0)
__device__ __forceinline__ float2 rows_sum16(const float (&v)[16], int lane, int& n0) {
  const bool h1 = lane & 16, h2 = lane & 8, h3 = lane & 4;
  float a[8], b[4], c[2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (h1 ? v[8 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, h1 ? v[i] : v[8 + i], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (h2 ? a[4 + i] : a[i]) + __shfl_xor_sync(0xffffffffu, h2 ? a[i] : a[4 + i], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h3 ? b[2 + i] : b[i]) + __shfl_xor_sync(0xffffffffu, h3 ? b[i] : b[2 + i], 4);
  const int g = 2 * h1 + h2;
  n0 = 4 * ((lane & 3) + 4 * g) + 2 * h3;
  return make_float2(c[0], c[1]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// one token of the recurrence on this thread's 16 entries of row i
__device__ __forceinline__ void wkv_step(float (&s)[16], const float* sm, int t, int i, int q) {
  const float wt = sm[kBwdW + t * kCols + i];
  const float kt = sm[kBwdK + t * kCols + i];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 vv = *reinterpret_cast<const float4*>(sm + kBwdV + t * kCols + 4 * (q + 4 * g));
    s[4 * g] = fmaf(wt, s[4 * g], kt * vv.x);
    s[4 * g + 1] = fmaf(wt, s[4 * g + 1], kt * vv.y);
    s[4 * g + 2] = fmaf(wt, s[4 * g + 2], kt * vv.z);
    s[4 * g + 3] = fmaf(wt, s[4 * g + 3], kt * vv.w);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    wkv6_scan_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ w,
                         const float* __restrict__ u, const T* __restrict__ dy,
                         const float* __restrict__ dfinal, T* __restrict__ dr,
                         T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw,
                         float* __restrict__ ck, float* __restrict__ du_part, int S, int H,
                         int K, int V) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wp = tid >> 5;
  const int i = tid / 4;   // the state row (key channel) this thread holds
  const int q = tid % 4;
  const float* uh = u + static_cast<size_t>(h) * K;
  const int nck = (S + kBwdChunk - 1) / kBwdChunk;
  float* ck_bh = ck + (static_cast<size_t>(b) * H + h) * nck * kCols * kCols;
  const size_t tok_k = static_cast<size_t>(H) * K;   // r / k / w stride per token
  const size_t tok_v = static_cast<size_t>(H) * V;   // v / dy stride per token

  // sweep 1: the state before every chunk
  float s[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] = 0.f;
  for (int c = 0; c < nck; ++c) {
    const int t0 = c * kBwdChunk;
    const int nt = min(kBwdChunk, S - t0);
    float* out = ck_bh + (static_cast<size_t>(c) * kCols + i) * kCols;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      *reinterpret_cast<float4*>(out + 4 * (q + 4 * g)) =
          make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    stage_tile(sm + kBwdK, k, (row0 * H + h) * K, tok_k, nt, K);
    stage_tile(sm + kBwdV, v, (row0 * H + h) * V, tok_v, nt, V);
    stage_tile(sm + kBwdW, w, (row0 * H + h) * K, tok_k, nt, K);
    __syncthreads();
    for (int t = 0; t < nt; ++t) wkv_step(s, sm, t, i, q);
    __syncthreads();
  }

  // sweep 2, chunks last to first
  float ds[16];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * (q + 4 * g) + e;
      ds[4 * g + e] = dfinal != nullptr && i < K && n < V
                          ? dfinal[((static_cast<size_t>(b) * H + h) * K + i) * V + n]
                          : 0.f;
    }
  }
  float du_acc = 0.f;   // thread i < K: du[h][i] over this row's tokens
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kBwdChunk;
    const int nt = min(kBwdChunk, S - t0);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    stage_tile(sm + kBwdR, r, (row0 * H + h) * K, tok_k, nt, K);
    stage_tile(sm + kBwdK, k, (row0 * H + h) * K, tok_k, nt, K);
    stage_tile(sm + kBwdV, v, (row0 * H + h) * V, tok_v, nt, V);
    stage_tile(sm + kBwdW, w, (row0 * H + h) * K, tok_k, nt, K);
    stage_tile(sm + kBwdDy, dy, (row0 * H + h) * V, tok_v, nt, V);
    float s0[16], s8[16];
    const float* in = ck_bh + (static_cast<size_t>(c) * kCols + i) * kCols;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 x4 = *reinterpret_cast<const float4*>(in + 4 * (q + 4 * g));
      s0[4 * g] = x4.x;
      s0[4 * g + 1] = x4.y;
      s0[4 * g + 2] = x4.z;
      s0[4 * g + 3] = x4.w;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 16; ++e) s8[e] = s0[e];
    for (int t = 0; t < min(kBwdHalf, nt); ++t) wkv_step(s8, sm, t, i, q);

    for (int t = nt - 1; t >= 0; --t) {
      // S_{t-1}: the nearer saved copy stepped on to token t - 1
      const bool late = t >= kBwdHalf;
      float sp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) sp[e] = late ? s8[e] : s0[e];
      for (int j = late ? kBwdHalf : 0; j < t; ++j) wkv_step(sp, sm, j, i, q);

      const float rt = sm[kBwdR + t * kCols + i];
      const float kt = sm[kBwdK + t * kCols + i];
      const float wt = sm[kBwdW + t * kCols + i];
      float sy = 0.f, sv = 0.f, ss = 0.f, dyv[16], x[16];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int n0 = 4 * (q + 4 * g);
        const float4 yv = *reinterpret_cast<const float4*>(sm + kBwdDy + t * kCols + n0);
        const float4 vv = *reinterpret_cast<const float4*>(sm + kBwdV + t * kCols + n0);
        const float yy[4] = {yv.x, yv.y, yv.z, yv.w};
        const float vals[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * g + e;
          dyv[j] = yy[e];
          sy = fmaf(sp[j], yy[e], sy);
          sv = fmaf(ds[j], vals[e], sv);
          ss = fmaf(ds[j], sp[j], ss);
          x[j] = ds[j] * kt;                                // dS_t^T k_t, this row
        }
      }
      sy = quad_sum(sy);
      sv = quad_sum(sv);
      ss = quad_sum(ss);
      if (q == 0) {
        sm[kBwdSy + t * kCols + i] = sy;
        sm[kBwdSv + t * kCols + i] = sv;
        sm[kBwdSs + t * kCols + i] = ss;
      }
      int n0;
      const float2 red = rows_sum16(x, lane, n0);
      *reinterpret_cast<float2*>(sm + kBwdRed + (t * kBwdWarps + wp) * kCols + n0) = red;
#pragma unroll
      for (int j = 0; j < 16; ++j) ds[j] = fmaf(wt, ds[j], rt * dyv[j]);   // dS_{t-1}
    }
    __syncthreads();

    for (int t = wp; t < nt; t += kBwdWarps) {
      const float* vr = sm + kBwdV + t * kCols;
      const float* yr = sm + kBwdDy + t * kCols;
      const float* rr = sm + kBwdR + t * kCols;
      const float* kr = sm + kBwdK + t * kCols;
      const float u0 = lane < K ? uh[lane] : 0.f;
      const float u1 = lane + 32 < K ? uh[lane + 32] : 0.f;
      const float vdy = warp_sum(vr[lane] * yr[lane] + vr[lane + 32] * yr[lane + 32]);
      const float ruk = warp_sum(rr[lane] * u0 * kr[lane] + rr[lane + 32] * u1 * kr[lane + 32]);
      if (lane == 0) {
        sm[kBwdScal + 2 * t] = vdy;
        sm[kBwdScal + 2 * t + 1] = ruk;
      }
    }
    __syncthreads();

    for (int e = tid; e < nt * kCols; e += kBwdThreads) {
      const int t = e / kCols;
      const int n = e % kCols;
      const float vdy = sm[kBwdScal + 2 * t];
      if (n < K) {
        const size_t at = ((row0 + t) * H + h) * K + n;
        const float uk = uh[n] * vdy;
        dr[at] = from_f32<T>(fmaf(uk, sm[kBwdK + t * kCols + n], sm[kBwdSy + t * kCols + n]));
        dk[at] = from_f32<T>(fmaf(uk, sm[kBwdR + t * kCols + n], sm[kBwdSv + t * kCols + n]));
        dw[at] = sm[kBwdSs + t * kCols + n];
      }
      if (n < V) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kBwdWarps; ++j) acc += sm[kBwdRed + (t * kBwdWarps + j) * kCols + n];
        dv[((row0 + t) * H + h) * V + n] =
            from_f32<T>(fmaf(sm[kBwdScal + 2 * t + 1], sm[kBwdDy + t * kCols + n], acc));
      }
    }
    if (tid < K)
      for (int t = nt - 1; t >= 0; --t)
        du_acc = fmaf(sm[kBwdR + t * kCols + tid] * sm[kBwdK + t * kCols + tid],
                      sm[kBwdScal + 2 * t], du_acc);
    __syncthreads();   // the next chunk restages every tile
  }
  if (tid < K) du_part[(static_cast<size_t>(b) * H + h) * K + tid] = du_acc;
}

// out[o][n] = sum over m of in[o][m][n], m in order (the partials' fixed
// order, so the sum is the same bitwise from call to call)
__global__ void sum_mid_kernel(const float* __restrict__ in, float* __restrict__ out, int outer,
                               int mid, int inner) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(outer) * inner) return;
  const size_t o = e / inner;
  const float* src = in + o * mid * inner + e % inner;
  float acc = 0.f;
  for (int m = 0; m < mid; ++m) acc += src[static_cast<size_t>(m) * inner];
  out[e] = acc;
}

// ------------------------------------------------ the backward's bf16 route

constexpr int kBwdTcThreads = 256;                 // 8 warps
constexpr int kPlane = kTcCols * kTcCols;          // a 64 x 64 bf16 plane, elements
constexpr int kSq = kTcChunk * kTcChunk;           // a 32 x 32 bf16 plane, elements
// the reverse sweep's dynamic shared memory, bytes: r, k, v, dy as bf16
// chunk tiles and w as f32 (one stage: the next chunk's copies start once
// this one is done with them); w's region then holds each warp's bonus
// sums, Z as bf16 hi, mid and lo planes and v . dy per token
constexpr int kBtR = 0;
constexpr int kBtK = kBtR + kTile;
constexpr int kBtV = kBtK + kTile;
constexpr int kBtDy = kBtV + kTile;
constexpr int kBtW = kBtDy + kTile;
constexpr int kBtBonus = kBtW;                     // f32 [8 warps][32]
constexpr int kBtZ = kBtBonus + 8 * kTcChunk * 4;  // bf16 [3][32][32]
constexpr int kBtP = kBtZ + 3 * kSq * 2;           // f32 [32]
// the level 16, 8, 4, 2 operands, r a (then each warp's scratch) and k g,
// each as bf16 hi and lo chunk tiles
constexpr int kBtL16 = kBtW + kTcChunk * kTcCols * 4;
constexpr int kBtL8 = kBtL16 + 2 * kTile;
constexpr int kBtL4 = kBtL8 + 2 * kTile;
constexpr int kBtL2 = kBtL4 + 2 * kTile;
constexpr int kBtRdec = kBtL2 + 2 * kTile;
constexpr int kBtKt = kBtRdec + 2 * kTile;
constexpr int kBtSin = kBtKt + 2 * kTile;          // S_in, bf16 hi and lo planes
constexpr int kBtDs = kBtSin + 2 * kPlane * 2;     // dS_end, bf16 hi and lo planes
constexpr int kBtAt = kBtDs + 2 * kPlane * 2;      // A^T, bf16 hi and lo [2][32][32]
constexpr int kBtQtot = kBtAt + 2 * kSq * 2;       // the quarters' products of w, f32 [4][64]
constexpr int kBwdTcSmemBytes = kBtQtot + 4 * kTcCols * 4;   // 111,616
static_assert(kBtP + kTcChunk * 4 <= kBtL16, "w's region holds the bonus sums, Z and v . dy");
static_assert(kBwdTcThreads == kTcThreads, "load_tile strides by kTcThreads");

// w's tile: element (t, c) with c's 8-column groups XOR-swizzled by the
// token's quarter, so the 4 quarters of a column sit in different banks
__device__ __forceinline__ int wsw(int t, int c) {
  return t * kTcCols + (c ^ (((t >> 3) & 3) << 3));
}

// element offset of (row, col) in a 32 x 32 bf16 plane whose 16-byte units
// are XOR-swizzled by row pairs (ldmatrix reads it free of bank conflicts)
__device__ __forceinline__ int swz32(int row, int col) {
  return row * kTcChunk + ((((col >> 3) ^ (row >> 1)) & 3) << 3) + (col & 7);
}
__device__ __forceinline__ int a32_off(int r0, int c0, int l) {
  return swz32(r0 + (l & 15), c0 + ((l >> 4) << 3));
}
// B operand of one n8 tile over two k16 steps, from a tile of rows n, cols
// k: registers 0, 1 the first step, 2, 3 the second
__device__ __forceinline__ int b2_off(int n0, int k0, int l) {
  return swz(n0 + (l & 7), k0 + ((l >> 3) << 3));
}
// B operand of one n8 tile from a tile stored k x n (.trans); lanes 16..31
// address a second plane (registers 2, 3)
__device__ __forceinline__ int bt1_off(int k0, int n0, int l) {
  return swz(k0 + (l & 7) + (((l >> 3) & 1) << 3), n0);
}

__device__ __forceinline__ void split3(float f, bf16& hi, bf16& mid, bf16& lo) {
  hi = __float2bfloat16(f);
  const float r1 = f - __bfloat162float(hi);
  mid = __float2bfloat16(r1);
  lo = __float2bfloat16(r1 - __bfloat162float(mid));
}

// one chunk's r, k, v, dy, w and the state it enters with (from the state
// sweep's planes) into the reverse sweep's tiles
template <bool kVec>
__device__ __forceinline__ void load_bwd_chunk(unsigned char* smem, const bf16* r, const bf16* k,
                                               const bf16* v, const float* w, const bf16* dy,
                                               const bf16* planes, int b, int h, int ci, int S,
                                               int H, int K, int V, int tid) {
  const int t0 = ci * kTcChunk;
  const int nt = min(kTcChunk, S - t0);
  const size_t row0 = static_cast<size_t>(b) * S + t0;
  const size_t kst = static_cast<size_t>(H) * K;
  const size_t vst = static_cast<size_t>(H) * V;
  const size_t koff = (row0 * H + h) * K;
  const size_t voff = (row0 * H + h) * V;
  load_tile<kVec>(reinterpret_cast<bf16*>(smem + kBtR), r + koff, kst, K, nt, tid);
  load_tile<kVec>(reinterpret_cast<bf16*>(smem + kBtK), k + koff, kst, K, nt, tid);
  load_tile<kVec>(reinterpret_cast<bf16*>(smem + kBtV), v + voff, vst, V, nt, tid);
  load_tile<kVec>(reinterpret_cast<bf16*>(smem + kBtDy), dy + voff, vst, V, nt, tid);
  float* ws = reinterpret_cast<float*>(smem + kBtW);
  if (kVec) {
    const int units = K >> 2;
    for (int i = tid; i < kTcChunk * 16; i += kBwdTcThreads) {
      const int t = i >> 4;
      const int j = i & 15;
      if (j < units)
        cp_async16(ws + wsw(t, 4 * j), t < nt ? w + koff + t * kst + 4 * j : w, t < nt);
    }
  } else {
    for (int i = tid; i < kTcChunk * K; i += kBwdTcThreads) {
      const int t = i / K;
      const int c = i % K;
      ws[wsw(t, c)] = t < nt ? w[koff + t * kst + c] : 0.f;
    }
  }
  const bf16* src = planes + static_cast<size_t>(ci) * 2 * kPlane;
  bf16* sp = reinterpret_cast<bf16*>(smem + kBtSin);
  for (int i = tid; i < 2 * kTcCols * 8; i += kBwdTcThreads) {
    const int plane = i >> 9;
    const int row = (i >> 3) & 63;
    const int j = i & 7;
    cp_async16(sp + plane * kPlane + swz(row, 8 * j), src + plane * kPlane + row * kTcCols + 8 * j,
               true);
  }
  cp_async_commit();
}

// a warp's product (32 tokens x its 8 channels, two m16 tiles in
// accumulator layout) through its scratch into the lane layout: lane l
// gets channel l & 7 of tokens 8 (l >> 3) .. + 7. The scratch puts 4
// tokens in a 32-word row, each in the slot (t + t / 8) mod 4, so both the
// accumulator's float2 stores and the lane layout's loads are free of bank
// conflicts.
__device__ __forceinline__ int scr_at(int t, int c) {
  return (t >> 2) * 32 + (((t + (t >> 3)) & 3) << 3) + c;
}
__device__ __forceinline__ void to_lanes(float* scr, const float (&acc)[2][4], float (&x)[8],
                                         int lane) {
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(scr + scr_at(16 * mt + g + 8 * hh, c2)) =
          make_float2(acc[mt][2 * hh], acc[mt][2 * hh + 1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = scr[scr_at(8 * (lane >> 3) + i, lane & 7)];
  __syncwarp();
}

// A fragment bits of the pairs (t, s) of a 16-token sub-chunk taken at
// level lvl (the highest bit of t ^ s): register i holds rows g (+8 for
// odd i), columns c2 (+8 for i >= 2), each as (low, high) halves
__device__ __forceinline__ void level_mask(uint32_t (&m)[4], int lvl, int lane) {
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i & 1);
    const int col = c2 + 8 * (i >> 1);
    const int x0 = row ^ col;
    const int x1 = row ^ (col + 1);
    m[i] = (x0 >= lvl && x0 < 2 * lvl ? 0x0000ffffu : 0u) |
           (x1 >= lvl && x1 < 2 * lvl ? 0xffff0000u : 0u);
  }
}

// One level's share of dr, dk and dw on the lane layout (this lane's
// channel, tokens i = 0..7 of its quarter), given x, the level's product
// before its factors. L is the half-block length: tokens in the upper
// half of an aligned 2L block take x into dr with the factor prod_{m <= j
// < i} w_j and into dw with it times a reverse scan of r x over the rest
// of their half; lower ones into dk with prod_{i < j < m} w_j and a
// forward scan of k x. L 2 and 4 lie inside a quarter; L 8 is the
// quarter (up_q says whether it is an upper one); L 16 the chunk's half,
// whose scans carry across the two quarters of a half (the lanes 8
// apart) and whose factors take the other quarter's product qo.
template <int L>
__device__ __forceinline__ void level_part(const float (&x)[8], const float (&wv)[8],
                                           const float (&rr)[8], const float (&kv)[8], int q,
                                           float qo, float (&drv)[8], float (&dkv)[8],
                                           float (&dwv)[8]) {
  constexpr int kSeg = L < 8 ? L : 8;
  const bool up_q = L == 16 ? q >= 2 : (q & 1);
  float fu[8], fl[8], su[8], sl[8];
  float run = 0.f, prod = 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // upper factors, lower scans
    if (i % kSeg == 0) run = 0.f, prod = 1.f;
    fu[i] = prod;
    prod *= wv[i];
    sl[i] = run;
    run = fmaf(wv[i], run, kv[i] * x[i]);
  }
  const float tail = run;
  run = 0.f;
  prod = 1.f;
#pragma unroll
  for (int i = 7; i >= 0; --i) {  // lower factors, upper scans
    if (i % kSeg == kSeg - 1) run = 0.f, prod = 1.f;
    fl[i] = prod;
    prod *= wv[i];
    su[i] = run;
    run = fmaf(wv[i], run, rr[i] * x[i]);
  }
  if (L == 16) {
    // quarter 2's reverse scan continues quarter 3's head; quarter 1's
    // forward scan quarter 0's tail
    const float mine = up_q ? run : tail;
    const float other = __shfl_xor_sync(0xffffffffu, mine, 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (q == 2) su[i] = fmaf(fl[i], other, su[i]);
      if (q == 1) sl[i] = fmaf(fu[i], other, sl[i]);
      if (q == 3) fu[i] *= qo;
      if (q == 0) fl[i] *= qo;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool up = L < 8 ? ((i / L) & 1) : up_q;
    if (up) {
      drv[i] = fmaf(fu[i], x[i], drv[i]);
      dwv[i] = fmaf(fu[i], su[i], dwv[i]);
    } else {
      dkv[i] = fmaf(fl[i], x[i], dkv[i]);
      dwv[i] = fmaf(fl[i], sl[i], dwv[i]);
    }
  }
}

// The chunk-wide terms on the lane layout: kUpper (E = dY S_in^T): dr +=
// a e, dw += a R with R a reverse scan of r e over the chunk; else (F = V
// dS_end^T): dk += g f, dw += g L with L a forward scan of k f. The
// quarters' scans meet through their ends (4 shuffles) and the quarters'
// products Q.
template <bool kUpper>
__device__ __forceinline__ void chunk_part(const float (&x)[8], const float (&wv)[8],
                                           const float (&rk)[8], const float (&pre)[8],
                                           const float (&suf)[8], const float (&Q)[4], int q,
                                           int lane, float (&out)[8], float (&dwv)[8]) {
  float sc[8];
  float run = 0.f;
  if (kUpper) {
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      sc[i] = run;
      run = fmaf(wv[i], run, rk[i] * x[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i] = run;
      run = fmaf(wv[i], run, rk[i] * x[i]);
    }
  }
  float ends[4];
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) ends[qq] = __shfl_sync(0xffffffffu, run, (lane & 7) + 8 * qq);
  // the carry into this quarter and the factor from (to) the chunk's start (end)
  float carry = 0.f, outer = 1.f;
  if (kUpper) {
#pragma unroll
    for (int qq = 3; qq >= 1; --qq)
      if (qq > q) carry = fmaf(Q[qq], carry, ends[qq]);
#pragma unroll
    for (int qq = 0; qq < 3; ++qq)
      if (qq < q) outer *= Q[qq];
  } else {
#pragma unroll
    for (int qq = 0; qq < 3; ++qq)
      if (qq < q) carry = fmaf(Q[qq], carry, ends[qq]);
#pragma unroll
    for (int qq = 1; qq < 4; ++qq)
      if (qq > q) outer *= Q[qq];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float f = kUpper ? outer * pre[i] : suf[i] * outer;
    sc[i] = fmaf(kUpper ? suf[i] : pre[i], carry, sc[i]);
    out[i] = fmaf(f, x[i], out[i]);
    dwv[i] = fmaf(f, sc[i], dwv[i]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kBwdTcThreads, 2)
    wkv6_scan_bwd_tc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ w,
                            const float* __restrict__ u, const bf16* __restrict__ dy,
                            const float* __restrict__ dfinal, const bf16* __restrict__ states,
                            bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
                            float* __restrict__ dw, float* __restrict__ du_part, int S, int H,
                            int K, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int wp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  // the lane layout: channel ch, tokens 8q .. 8q + 7 of the chunk
  const int ch = 8 * wp + (lane & 7);
  const int q = lane >> 3;
  const bf16* rs = reinterpret_cast<const bf16*>(smem + kBtR);
  const bf16* ks = reinterpret_cast<const bf16*>(smem + kBtK);
  const bf16* vs = reinterpret_cast<const bf16*>(smem + kBtV);
  const bf16* dys = reinterpret_cast<const bf16*>(smem + kBtDy);
  const float* ws = reinterpret_cast<const float*>(smem + kBtW);
  float* bpart = reinterpret_cast<float*>(smem + kBtBonus);
  bf16* zt = reinterpret_cast<bf16*>(smem + kBtZ);
  float* pdiag = reinterpret_cast<float*>(smem + kBtP);
  bf16* l16 = reinterpret_cast<bf16*>(smem + kBtL16);
  bf16* l8 = reinterpret_cast<bf16*>(smem + kBtL8);
  bf16* l4 = reinterpret_cast<bf16*>(smem + kBtL4);
  bf16* l2 = reinterpret_cast<bf16*>(smem + kBtL2);
  bf16* rdec = reinterpret_cast<bf16*>(smem + kBtRdec);
  bf16* kt = reinterpret_cast<bf16*>(smem + kBtKt);
  const bf16* sinp = reinterpret_cast<const bf16*>(smem + kBtSin);
  bf16* dsp = reinterpret_cast<bf16*>(smem + kBtDs);
  bf16* at = reinterpret_cast<bf16*>(smem + kBtAt);
  float* qtot = reinterpret_cast<float*>(smem + kBtQtot);
  float* scr = reinterpret_cast<float*>(smem + kBtRdec) + wp * kTcChunk * 8;
  constexpr int kLo = kTile / 2;   // elements from a hi chunk tile to its lo tile

  // zeros everywhere once: the tiles' padding columns stay zero for good,
  // and A^T's entries above its diagonal
  for (int i = tid; i < kBwdTcSmemBytes / 16; i += kBwdTcThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int n_chunks = (S + kTcChunk - 1) / kTcChunk;
  const bf16* planes = states + (static_cast<size_t>(b) * H + h) * n_chunks * 2 * kPlane;
  load_bwd_chunk<kVec>(smem, r, k, v, w, dy, planes, b, h, n_chunks - 1, S, H, K, V, tid);

  // dS, the adjoint of the state the chunk ends with, in f32 registers as
  // the forward's state: rows k = kr + g (+8), cols v = vc + 8j + c2 (+1);
  // its bf16 hi and lo planes feed the products
  const int kr = 16 * (wp & 3);
  const int vc = 32 * (wp >> 2);
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = kr + g + 8 * hh;
      const int col = vc + 8 * j + c2;
      const float* f = dfinal + ((static_cast<size_t>(b) * H + h) * K + row) * V + col;
      const bool ok = dfinal != nullptr && row < K;
      s[j][2 * hh] = ok && col < V ? f[0] : 0.f;
      s[j][2 * hh + 1] = ok && col + 1 < V ? f[1] : 0.f;
    }
    store_split(dsp, dsp + kPlane, swz(kr + g, vc + 8 * j + c2), s[j][0], s[j][1]);
    store_split(dsp, dsp + kPlane, swz(kr + g + 8, vc + 8 * j + c2), s[j][2], s[j][3]);
  }
  const float uc = ch < K ? u[static_cast<size_t>(h) * K + ch] : 0.f;
  float du_acc = 0.f;

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * kTcChunk;
    const int nt = min(kTcChunk, S - t0);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    cp_async_wait_all();
    __syncthreads();   // this chunk, its S_in and dS_end have landed

    // ---- the decays (the lane layout), as the forward forms them: running
    // products of w within the quarter, a padded token decaying by 1
    float wv[8];
    {
      float rr[8], kv[8], pre[8], suf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * q + i;
        wv[i] = ch < K ? (t < nt ? ws[wsw(t, ch)] : 1.f) : 0.f;
        rr[i] = __bfloat162float(rs[swz(t, ch)]);
        kv[i] = __bfloat162float(ks[swz(t, ch)]);
      }
      pre[0] = 1.f;
#pragma unroll
      for (int i = 1; i < 8; ++i) pre[i] = pre[i - 1] * wv[i - 1];
      suf[7] = 1.f;
#pragma unroll
      for (int i = 6; i >= 0; --i) suf[i] = suf[i + 1] * wv[i + 1];
      qtot[q * kTcCols + ch] = pre[7] * wv[7];
      // the level 8, 4, 2 operands: r times the upper factor, k times the lower
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = swz(8 * q + i, ch);
        store_split1(l8, kLo, e, (q & 1) ? rr[i] * pre[i] : kv[i] * suf[i]);
        float p4 = 1.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (i >= 4 && j >= 4 && j < i) p4 *= wv[j];
          if (i < 4 && j > i && j < 4) p4 *= wv[j];
        }
        store_split1(l4, kLo, e, i >= 4 ? rr[i] * p4 : kv[i] * p4);
        const float p2 = (i & 3) == 3 ? wv[i - 1] : (i & 3) == 0 ? wv[i + 1] : 1.f;
        store_split1(l2, kLo, e, (i & 2) ? rr[i] * p2 : kv[i] * p2);
      }
      __syncthreads();   // the quarters' products; every thread has read its w
      float before = 1.f, after = 1.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float Qv = qtot[qq * kTcCols + ch];
        if (qq < q) before *= Qv;
        if (qq > q) after *= Qv;
      }
      const float m16 = q == 3 ? qtot[2 * kTcCols + ch] : q == 0 ? qtot[kTcCols + ch] : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = swz(8 * q + i, ch);
        store_split1(rdec, kLo, e, rr[i] * (before * pre[i]));
        store_split1(kt, kLo, e, kv[i] * (suf[i] * after));
        store_split1(l16, kLo, e, q >= 2 ? rr[i] * (pre[i] * m16) : kv[i] * (suf[i] * m16));
      }
      // the bonus sum_k r u k per token over this warp's 8 channels,
      // reduce-scattered over the lanes of a quarter: the lane keeps token
      // 8q + (lane & 7)
      float bs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) bs[i] = rr[i] * uc * kv[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool up = lane & 4;
        const float recv = __shfl_xor_sync(0xffffffffu, up ? bs[j] : bs[j + 4], 4);
        bs[j] = (up ? bs[j + 4] : bs[j]) + recv;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool up = lane & 2;
        const float recv = __shfl_xor_sync(0xffffffffu, up ? bs[j] : bs[j + 2], 2);
        bs[j] = (up ? bs[j + 2] : bs[j]) + recv;
      }
      {
        const bool up = lane & 1;
        const float recv = __shfl_xor_sync(0xffffffffu, up ? bs[0] : bs[1], 1);
        bs[0] = (up ? bs[1] : bs[0]) + recv;
      }
      bpart[wp * kTcChunk + 8 * q + (lane & 7)] = bs[0];
    }
    __syncthreads();   // every operand is complete

    // ---- A^T (the forward's levelled scores, the bonus on the diagonal),
    // Z (dY V^T's strict lower part made symmetric, as hi, mid, lo), v . dy,
    // and the adjoint's update
    {
      // A: warp (sb, lv) takes level 8 >> lv of sub-chunk sb, as the forward
      const int sb = wp >> 2;
      const int lv = wp & 3;
      const int b0 = kSub * sb;
      float d[3][2][4] = {};
      if (lv < 3) {
        const bf16* Lt = lv == 0 ? l8 : lv == 1 ? l4 : l2;
        mma_x3(d, Lt, b0, Lt, b0, kLo, lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4], bf[4];
          ldsm_x4(af, rs + a_off(b0, 16 * kk, lane));
          ldsm_x4(bf, ks + b_off(b0, 16 * kk, lane));
          mma(d[0][0], af, bf[0], bf[1]);
          mma(d[0][1], af, bf[2], bf[3]);
        }
      }
      const int lvl = 8 >> lv;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = g + 8 * (e >> 1);
          const int ul = 8 * n + c2 + (e & 1);
          const bool ok = (tl / (2 * lvl)) == (ul / (2 * lvl)) && (tl & lvl) && !(ul & lvl);
          if (ok) store_split1(at, kSq, swz32(b0 + ul, b0 + tl),
                               d[0][n][e] + d[1][n][e] + d[2][n][e]);
        }
      }
      if (lv == 3) {
        if (lane < kSub) {
          const int t = b0 + lane;
          float bsum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) bsum += bpart[j * kTcChunk + t];
          store_split1(at, kSq, swz32(t, t), bsum);
        }
        if (sb == 0) {   // level 16: queries 16..31 against keys 0..15
          float e16[3][2][4] = {};
          mma_x3(e16, l16, kSub, l16, 0, kLo, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              store_split1(at, kSq, swz32(8 * n + c2 + (e & 1), kSub + g + 8 * (e >> 1)),
                           e16[0][n][e] + e16[1][n][e] + e16[2][n][e]);
          }
        }
      }
    }
    {
      // M = dY V^T, warp (mt, n8) its rows 16 mt.., columns 8 n8..; exact
      const int mt = wp >> 2;
      const int n8 = wp & 3;
      float m4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {
        uint32_t bf[4];
        ldsm_x4(bf, vs + b2_off(8 * n8, 32 * kk2, lane));
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          uint32_t af[4];
          ldsm_x4(af, dys + a_off(16 * mt, 32 * kk2 + 16 * st, lane));
          mma(m4, af, bf[2 * st], bf[2 * st + 1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mt + g + 8 * (e >> 1);
        const int sc = 8 * n8 + c2 + (e & 1);
        if (sc < t) {
          bf16 p0, p1, p2;
          split3(m4[e], p0, p1, p2);
          zt[swz32(t, sc)] = p0;
          zt[kSq + swz32(t, sc)] = p1;
          zt[2 * kSq + swz32(t, sc)] = p2;
          zt[swz32(sc, t)] = p0;
          zt[kSq + swz32(sc, t)] = p1;
          zt[2 * kSq + swz32(sc, t)] = p2;
        } else if (sc == t) {
          pdiag[t] = m4[e];
          const bf16 zero = __float2bfloat16(0.f);
          zt[swz32(t, t)] = zero;
          zt[kSq + swz32(t, t)] = zero;
          zt[2 * kSq + swz32(t, t)] = zero;
        }
      }
    }
    {
      // dS entering the chunk = diag(prod w) dS_end + (r a)^T dY, this
      // warp's tile; its planes keep dS_end for the products below
      float da = 1.f, db = 1.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        da *= qtot[qq * kTcCols + kr + g];
        db *= qtot[qq * kTcCols + kr + g + 8];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][0] *= da;
        s[j][1] *= da;
        s[j][2] *= db;
        s[j][3] *= db;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, rdec + at_off(16 * kk, kr, lane));
        ldsm_x4_t(al, rdec + kLo + at_off(16 * kk, kr, lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, dys + bt_off(16 * kk, vc + 16 * jp, lane));
          mma(s[2 * jp], ah, bf[0], bf[1]);
          mma(s[2 * jp], al, bf[0], bf[1]);
          mma(s[2 * jp + 1], ah, bf[2], bf[3]);
          mma(s[2 * jp + 1], al, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // A^T, Z and v . dy are complete; r a is done with

    // ---- dv = A^T dY + (k g) dS_end, warp (mt, nq) its rows 16 mt..,
    // columns nq..; rounded once
    {
      const int mt = wp >> 2;
      const int nq = 16 * (wp & 3);
      float o[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk < mt) continue;   // A^T[u][t] is zero for t < u
        uint32_t ah[4], al[4], bf[4];
        ldsm_x4(ah, at + a32_off(16 * mt, 16 * kk, lane));
        ldsm_x4(al, at + kSq + a32_off(16 * mt, 16 * kk, lane));
        ldsm_x4_t(bf, dys + bt_off(16 * kk, nq, lane));
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma(o[n], ah, bf[2 * n], bf[2 * n + 1]);
          mma(o[n], al, bf[2 * n], bf[2 * n + 1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        ldsm_x4(ah, kt + a_off(16 * mt, 16 * kk, lane));
        ldsm_x4(al, kt + kLo + a_off(16 * mt, 16 * kk, lane));
        ldsm_x4_t(bh, dsp + bt_off(16 * kk, nq, lane));
        ldsm_x4_t(bl, dsp + kPlane + bt_off(16 * kk, nq, lane));
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma(o[n], ah, bh[2 * n], bh[2 * n + 1]);
          mma(o[n], ah, bl[2 * n], bl[2 * n + 1]);
          mma(o[n], al, bh[2 * n], bh[2 * n + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = nq + 8 * n + c2;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = kSub * mt + g + 8 * hh;
          if (t < nt && c < V) {
            bf16* out = dv + ((row0 + t) * H + h) * V + c;
            if (kVec) {
              *reinterpret_cast<__nv_bfloat162*>(out) =
                  __floats2bfloat162_rn(o[n][2 * hh], o[n][2 * hh + 1]);
            } else {
              out[0] = __float2bfloat16(o[n][2 * hh]);
              if (c + 1 < V) out[1] = __float2bfloat16(o[n][2 * hh + 1]);
            }
          }
        }
      }
    }

    // ---- dr, dk, dw on the lane layout, one product at a time: each warp
    // forms its 8 channels' products on the tensor cores and turns them
    // into the lane layout through its scratch
    {
      float rr[8], kv[8], pre[8], suf[8], Q[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        rr[i] = __bfloat162float(rs[swz(8 * q + i, ch)]);
        kv[i] = __bfloat162float(ks[swz(8 * q + i, ch)]);
      }
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) Q[qq] = qtot[qq * kTcCols + ch];
      pre[0] = 1.f;
#pragma unroll
      for (int i = 1; i < 8; ++i) pre[i] = pre[i - 1] * wv[i - 1];
      suf[7] = 1.f;
#pragma unroll
      for (int i = 6; i >= 0; --i) suf[i] = suf[i + 1] * wv[i + 1];
      // rowsum(S_in o dS_end) of this channel, this lane's 16 columns, then
      // over the quarter lanes
      float s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = swz(ch, 16 * q + 8 * j);
        const uint4 sh = *reinterpret_cast<const uint4*>(sinp + e);
        const uint4 sl = *reinterpret_cast<const uint4*>(sinp + kPlane + e);
        const uint4 dh = *reinterpret_cast<const uint4*>(dsp + e);
        const uint4 dl = *reinterpret_cast<const uint4*>(dsp + kPlane + e);
        const uint32_t a4[4] = {sh.x, sh.y, sh.z, sh.w}, b4[4] = {sl.x, sl.y, sl.z, sl.w};
        const uint32_t c4[4] = {dh.x, dh.y, dh.z, dh.w}, d4[4] = {dl.x, dl.y, dl.z, dl.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 sa = unpack(a4[m]), sb = unpack(b4[m]);
          const float2 da = unpack(c4[m]), db = unpack(d4[m]);
          s1 = fmaf(sa.x + sb.x, da.x + db.x, s1);
          s1 = fmaf(sa.y + sb.y, da.y + db.y, s1);
        }
      }
      s1 += __shfl_xor_sync(0xffffffffu, s1, 8);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
      float drv[8], dkv[8], dwv[8];
      {
        float before = 1.f, after = 1.f;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          if (qq < q) before *= Q[qq];
          if (qq > q) after *= Q[qq];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {   // (prod_{j != t} w_j) rowsum(S_in o dS_end)
          drv[i] = dkv[i] = 0.f;
          dwv[i] = (before * pre[i]) * (suf[i] * after) * s1;
        }
      }
      float x[8];
      {   // E = dY S_in^T and F = V dS_end^T, S_in and dS_end as hi + lo
        float acc[2][2][4] = {};
#pragma unroll
        for (int kk2 = 0; kk2 < 2; ++kk2) {
          uint32_t se[2][4], df[2][4];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            ldsm_x4(se[p], sinp + p * kPlane + b2_off(8 * wp, 32 * kk2, lane));
            ldsm_x4(df[p], dsp + p * kPlane + b2_off(8 * wp, 32 * kk2, lane));
          }
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            const int kk = 2 * kk2 + st;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              uint32_t ya[4], va[4];
              ldsm_x4(ya, dys + a_off(16 * mt, 16 * kk, lane));
              ldsm_x4(va, vs + a_off(16 * mt, 16 * kk, lane));
#pragma unroll
              for (int p = 0; p < 2; ++p) {
                mma(acc[0][mt], ya, se[p][2 * st], se[p][2 * st + 1]);
                mma(acc[1][mt], va, df[p][2 * st], df[p][2 * st + 1]);
              }
            }
          }
        }
        to_lanes(scr, acc[0], x, lane);
        chunk_part<true>(x, wv, rr, pre, suf, Q, q, lane, drv, dwv);
        to_lanes(scr, acc[1], x, lane);
        chunk_part<false>(x, wv, kv, pre, suf, Q, q, lane, dkv, dwv);
      }
      {   // level 16: Z (hi, mid, lo) against the other half's operands
        float acc[2][4] = {};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int s0 = kSub * (1 - mt);
          uint32_t zf[3][4], lf[4];
#pragma unroll
          for (int p = 0; p < 3; ++p) ldsm_x4(zf[p], zt + p * kSq + a32_off(kSub * mt, s0, lane));
          ldsm_x4_t(lf, l16 + (lane >> 4) * kLo + bt1_off(s0, 8 * wp, lane));
          mma(acc[mt], zf[0], lf[0], lf[1]);
          mma(acc[mt], zf[0], lf[2], lf[3]);
          mma(acc[mt], zf[1], lf[0], lf[1]);
          mma(acc[mt], zf[1], lf[2], lf[3]);
          mma(acc[mt], zf[2], lf[0], lf[1]);
        }
        to_lanes(scr, acc, x, lane);
        level_part<16>(x, wv, rr, kv, q, q == 3 ? Q[2] : Q[1], drv, dkv, dwv);
      }
#pragma unroll
      for (int lv = 0; lv < 4; ++lv) {   // levels 8, 4, 2, 1 inside each sub-chunk
        const int lvl = 8 >> lv;
        uint32_t msk[4];
        level_mask(msk, lvl, lane);
        float acc[2][4] = {};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int s0 = kSub * mt;
          uint32_t zf[3][4], lf[4];
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            ldsm_x4(zf[p], zt + p * kSq + a32_off(s0, s0, lane));
#pragma unroll
            for (int i = 0; i < 4; ++i) zf[p][i] &= msk[i];
          }
          if (lv < 3) {
            const bf16* Lt = lv == 0 ? l8 : lv == 1 ? l4 : l2;
            ldsm_x4_t(lf, Lt + (lane >> 4) * kLo + bt1_off(s0, 8 * wp, lane));
            mma(acc[mt], zf[0], lf[0], lf[1]);
            mma(acc[mt], zf[0], lf[2], lf[3]);
            mma(acc[mt], zf[1], lf[0], lf[1]);
            mma(acc[mt], zf[1], lf[2], lf[3]);
            mma(acc[mt], zf[2], lf[0], lf[1]);
          } else {
            // level 1's operand: r for an odd (upper) token, k for an even one,
            // the high and low halves of each register
            ldsm_x4_t(lf, (lane >> 4 ? ks : rs) + bt1_off(s0, 8 * wp, lane));
            const uint32_t b0 = (lf[0] & 0xffff0000u) | (lf[2] & 0x0000ffffu);
            const uint32_t b1 = (lf[1] & 0xffff0000u) | (lf[3] & 0x0000ffffu);
            mma(acc[mt], zf[0], b0, b1);
            mma(acc[mt], zf[1], b0, b1);
            mma(acc[mt], zf[2], b0, b1);
          }
        }
        to_lanes(scr, acc, x, lane);
        if (lv == 0) level_part<8>(x, wv, rr, kv, q, 1.f, drv, dkv, dwv);
        if (lv == 1) level_part<4>(x, wv, rr, kv, q, 1.f, drv, dkv, dwv);
        if (lv == 2) level_part<2>(x, wv, rr, kv, q, 1.f, drv, dkv, dwv);
        if (lv == 3) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i & 1)
              drv[i] += x[i];
            else
              dkv[i] += x[i];
          }
        }
      }
      // the bonus, du, and out
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * q + i;
        const float p = pdiag[t];
        drv[i] = fmaf(uc * kv[i], p, drv[i]);
        dkv[i] = fmaf(uc * rr[i], p, dkv[i]);
        du_acc = fmaf(rr[i] * kv[i], p, du_acc);
        if (t < nt && ch < K) {
          const size_t o = ((row0 + t) * H + h) * K + ch;
          dr[o] = __float2bfloat16(drv[i]);
          dk[o] = __float2bfloat16(dkv[i]);
          dw[o] = dwv[i];
        }
      }
    }
    __syncthreads();   // every warp is done with this chunk's tiles and dS_end

    // dS_end of the chunk before this one, and its inputs
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store_split(dsp, dsp + kPlane, swz(kr + g, vc + 8 * j + c2), s[j][0], s[j][1]);
      store_split(dsp, dsp + kPlane, swz(kr + g + 8, vc + 8 * j + c2), s[j][2], s[j][3]);
    }
    if (ci > 0)
      load_bwd_chunk<kVec>(smem, r, k, v, w, dy, planes, b, h, ci - 1, S, H, K, V, tid);
  }

  // du of this (b, h): each lane's tokens, then over the quarter lanes
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 8);
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 16);
  if (q == 0 && ch < K) du_part[(static_cast<size_t>(b) * H + h) * K + ch] = du_acc;
}

// floats of the backward's scratch: the saved states, then the per-row
// partials of du (B, H, K). The f32 route saves the f32 (64, 64) state
// every 16 tokens, the bf16 route its bf16 hi and lo planes every 32
size_t backward_work_floats(int B, int S, int H, int K, int dtype) {
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t states = dtype == 0
                            ? bh * ((S + kBwdChunk - 1) / kBwdChunk) * kCols * kCols
                            : bh * ((S + kTcChunk - 1) / kTcChunk) * 2 * kPlane / 2;
  return states + bh * K;
}

// the f32 route: the per-token kernel, then the sum over batch rows
cudaError_t launch_backward(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* dy, const void* dfinal, void* dr,
                            void* dk, void* dv, void* dw, void* du, void* work, int B, int S,
                            int H, int K, int V, cudaStream_t stream) {
  const size_t nck = (S + kBwdChunk - 1) / kBwdChunk;
  float* ck = static_cast<float*>(work);
  float* du_part = ck + static_cast<size_t>(B) * H * nck * kCols * kCols;
  auto kernel = wkv6_scan_bwd_kernel<float>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kBwdThreads, kBwdSmemBytes, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<const float*>(dfinal), static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw), ck, du_part, S, H, K, V);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = H * K;
  sum_mid_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, static_cast<float*>(du), 1, B, n);
  return cudaGetLastError();
}

// the bf16 route: the state sweep, the reverse sweep, the sum over batch rows
cudaError_t launch_backward_tc(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* dy, const void* dfinal, void* dr,
                               void* dk, void* dv, void* dw, void* du, void* work, int B, int S,
                               int H, int K, int V, cudaStream_t stream) {
  const size_t nck = (S + kTcChunk - 1) / kTcChunk;
  bf16* states = static_cast<bf16*>(work);
  float* du_part = static_cast<float*>(work) + static_cast<size_t>(B) * H * nck * kPlane;
  const bool vec = V % 8 == 0 && aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(w) && aligned16(dy) && aligned16(dv);
  auto sweep = vec ? wkv6_scan_tc_kernel<true, true> : wkv6_scan_tc_kernel<false, true>;
  auto reverse = vec ? wkv6_scan_bwd_tc_kernel<true> : wkv6_scan_bwd_tc_kernel<false>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kTcSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(sweep, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(reverse, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBwdTcSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(reverse, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  const bf16* rb = static_cast<const bf16*>(r);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  sweep<<<dim3(H, B), kTcThreads, kTcSmemBytes, stream>>>(rb, kb, vb, wf, uf, nullptr, nullptr,
                                                          states, S, H, K, V);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reverse<<<dim3(H, B), kBwdTcThreads, kBwdTcSmemBytes, stream>>>(
      rb, kb, vb, wf, uf, static_cast<const bf16*>(dy), static_cast<const float*>(dfinal), states,
      static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dw), du_part, S, H, K, V);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = H * K;
  sum_mid_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, static_cast<float*>(du), 1, B, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees: f32 route
// {kThreads, kLanesPerCol, kMaxK, kMaxV, kTokens}, then bf16 route
// {kTcThreads, kTcChunk, kTcSmemBytes}, then the backward's f32 route
// {kBwdThreads, kBwdChunk, kBwdSmemBytes} and bf16 route {kBwdTcThreads,
// kBwdTcSmemBytes}.
void wkv6_scan_config(int* cfg) {
  cfg[0] = kThreads;
  cfg[1] = kLanesPerCol;
  cfg[2] = kMaxK;
  cfg[3] = kMaxV;
  cfg[4] = kTokens;
  cfg[5] = kTcThreads;
  cfg[6] = kTcChunk;
  cfg[7] = kTcSmemBytes;
  cfg[8] = kBwdThreads;
  cfg[9] = kBwdChunk;
  cfg[10] = kBwdSmemBytes;
  cfg[11] = kBwdTcThreads;
  cfg[12] = kBwdTcSmemBytes;
}

// The bf16 backward's reverse sweep as built and launched: out = {registers
// a thread, local (spilled) bytes a thread, blocks an SM at its shared
// memory}. Returns the first failing runtime call's error, or 0.
int wkv6_scan_backward_occupancy(int* out) {
  const auto kernel = wkv6_scan_bwd_tc_kernel<true>;
  cudaFuncAttributes attr;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBwdTcSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kBwdTcThreads,
                                                           kBwdTcSmemBytes)) != cudaSuccess)
    return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

const char* wkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k (B, S, H, K), v and y (B, S, H, V) of one type: dtype 0 = float32
// (the per-token route), 1 = bfloat16 (the tensor-core route); w (B, S, H,
// K), u (H, K) and state (B, H, K, V) float32; all contiguous on the card.
// K a multiple of 16 up to 64, 1 <= V <= 64. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int wkv6_scan_forward(const void* r, const void* k, const void* v, const void* w,
                      const void* u, void* y, void* state, int B, int S, int H, int K,
                      int V, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 16 || K > kMaxK || K % 16 != 0 || V < 1 ||
      V > kMaxV)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_f32(r, k, v, w, u, y, state, B, S, H, K, V, st));
  if (dtype == 1)
    return static_cast<int>(launch_bf16(r, k, v, w, u, y, state, B, S, H, K, V, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Floats of the scratch buffer wkv6_scan_backward takes as `work` for the
// route of `dtype` (0 = float32, 1 = bfloat16).
size_t wkv6_scan_backward_work(int B, int S, int H, int K, int dtype) {
  return backward_work_floats(B, S, H, K, dtype);
}

// The gradient: r, k, v, dy and dr, dk, dv of one type (dtype 0 = float32,
// 1 = bfloat16); w, u, dw (B, S, H, K), du (H, K) and dfinal (B, H, K, V;
// null for none) float32; work a float32 buffer of wkv6_scan_backward_work
// floats for this dtype; all contiguous on the card, work 16-byte aligned.
// Shapes as wkv6_scan_forward takes them. Launches the backward (f32: one
// kernel; bf16: the state sweep and the reverse sweep) and the sum over
// batch rows on `stream`, returns cudaGetLastError() (0 on success); does
// not synchronise.
int wkv6_scan_backward(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* dy, const void* dfinal, void* dr, void* dk,
                       void* dv, void* dw, void* du, void* work, int B, int S, int H, int K,
                       int V, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 16 || K > kMaxK || K % 16 != 0 || V < 1 ||
      V > kMaxV)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_backward(r, k, v, w, u, dy, dfinal, dr, dk, dv, dw, du, work,
                                            B, S, H, K, V, st));
  if (dtype == 1)
    return static_cast<int>(launch_backward_tc(r, k, v, w, u, dy, dfinal, dr, dk, dv, dw, du,
                                               work, B, S, H, K, V, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
