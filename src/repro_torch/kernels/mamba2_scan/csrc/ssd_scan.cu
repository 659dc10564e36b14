// Mamba2 SSD scan (selective state-space recurrence) and its gradient, for
// Hopper (sm_90a); the backward is described where it begins. Forward:
// x (B, S, H, P), Bm / Cm (B, S, 1, N) and y (B, S, H, P) of one type (f32
// or bf16); dt (B, S, H), A (H,), D (H,) and the final state (B, H, P, N)
// in f32; all contiguous. The state and every sum are
// f32; y is rounded to the input type once.
//
// Replaces the TPU kernel in src/repro/kernels/mamba2_scan/kernel.py
// (ssd_scan_pallas and its body _kernel).
//
// Semantics, per (b, h), from a zero state:
//     S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T      (P, N)
//     y_t = S_t C_t + D_h x_t
//
// What bounds it on this card: bytes. At the zamba2-2.7b prefill shape
// (B 4, S 1024, H 80, P = N = 64) the function reads x, dt, B, C and
// writes y and the state once, about 91 MB, 0.027 ms at 3.35 TB/s; the
// chunked form's 10.7 GFLOP take 0.011 ms on the tensor cores.
//
// Two routes, chosen by the input type alone:
//
// f32: the first design, token by token on CUDA cores. One block of 256
// threads per (head, batch row), the (P, N) state in registers (4 threads
// share row p, 16 entries each), 32 tokens staged per pass as f32 in shared
// memory. What held it back, as the bf16 route (0.63 ms at the path shape on
// an H100 SXM): every token costs each thread 16 state FMAs, 16 multiplies,
// a 16-long dependent FMA chain and two shuffles (1.3 G element updates at
// that shape, all on CUDA cores) while the tensor cores sit idle. Each
// pass's loads are scalar 2-byte reads behind a barrier, with nothing in
// flight while its 32 tokens compute, but the token loop set the time: a
// variant that staged once and reused the tile ran nearly as long. It stays
// for f32, whose 3e-5 tolerance bf16 products cannot meet.
//
// bf16: the TPU kernel's chunked form on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate), 64-token chunks, one block of 4
// warps per (head, batch row), 68,096 bytes of shared memory so that 3
// blocks share an SM and the path's 320 blocks run in one wave. Per chunk,
// warp w owns query rows t (and state rows p) 16w..16w+15:
//  * loads: x, B, C in 16-byte cp.async copies (dt in 4-byte ones) into a
//    two-stage ring; the next chunk's copies are issued before this one
//    computes, so they stay in flight under its products. Tiles are bf16,
//    64 columns, 16-byte units XOR-swizzled by row (ldmatrix reads them
//    free of bank conflicts); rows past the sequence and columns past P /
//    N are zeros, and a zero dt makes a padded token a no-op;
//  * decay: cum = cumsum(dt A) by a warp scan (each warp its own copy);
//  * G = C B^T (c x c, depth N) on the causal tiles only, exact in f32;
//    the weight M[t,u] = G[t,u] exp(cum_t - cum_u) dt_u (u <= t, exponent
//    <= 0) is formed in f32 in the accumulators, so x enters M x exact;
//  * y = exp(cum_t) (C S^T)[t] + M x + D x: exp(cum_t) scales the f32 rows
//    after C S^T, so C enters exact;
//  * state: S <- exp(total) S + sum_u (w_u x_u)^T B_u, w_u = dt_u
//    exp(total - cum_u), the f32 accumulator in registers; its A fragments
//    come from x by a transposed ldmatrix and are scaled in registers;
//  * every operand that is not a bf16 input (M, w x, and the state as C
//    S^T reads it) is split into bf16 hi = bf16(f) and lo = bf16(f - hi),
//    and both go through the product: one bf16 rounding errs by about
//    2^-9 of each term, and y is a sum of terms larger than itself: in an
//    earlier version y reached 1.8e-2 of the 2e-2 tolerance at the path
//    shape, and the final state misses its 3e-5
//    (tests/test_torch_scan_design.py models both);
//  * two barriers a chunk; the final state leaves the registers once.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 4;                    // threads sharing row p
constexpr int kMaxP = kThreads / kLanesPerRow;     // 64
constexpr int kMaxN = 64;
constexpr int kPerThread = kMaxN / kLanesPerRow;   // 16 state entries
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
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ D,
                    T* __restrict__ y, float* __restrict__ state, int S, int H,
                    int P, int N) {
  __shared__ __align__(16) float xs[kTokens][kMaxP];
  __shared__ __align__(16) float bs[kTokens][kMaxN];
  __shared__ __align__(16) float cs[kTokens][kMaxN];
  __shared__ __align__(16) float ys[kTokens][kMaxP];
  __shared__ float dts[kTokens];
  __shared__ float decay[kTokens];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int p = tid / kLanesPerRow;
  const int q = tid % kLanesPerRow;
  const int groups = N / 16;   // float4 groups of this thread's row share
  const float a_h = A[h];
  const float d_h = D[h];

  float s[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) s[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kTokens) {
    const int nt = min(kTokens, S - t0);
    for (int i = tid; i < nt * P; i += kThreads) {
      const int t = i / P;
      const int c = i % P;
      xs[t][c] = to_f32(x[((static_cast<size_t>(b) * S + t0 + t) * H + h) * P + c]);
    }
    for (int i = tid; i < nt * N; i += kThreads) {
      const int t = i / N;
      const int c = i % N;
      const size_t at = (static_cast<size_t>(b) * S + t0 + t) * N + c;
      bs[t][c] = to_f32(Bm[at]);
      cs[t][c] = to_f32(Cm[at]);
    }
    if (tid < nt) {
      const float d = dt[(static_cast<size_t>(b) * S + t0 + tid) * H + h];
      dts[tid] = d;
      decay[tid] = expf(d * a_h);
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float xv = p < P ? xs[t][p] : 0.f;
      const float dtx = dts[t] * xv;
      const float a = decay[t];
      float acc = 0.f;
#pragma unroll
      for (int g = 0; g < kPerThread / 4; ++g) {
        if (g < groups) {
          const int n0 = 4 * (q + kLanesPerRow * g);
          const float4 bv = *reinterpret_cast<const float4*>(&bs[t][n0]);
          const float4 cv = *reinterpret_cast<const float4*>(&cs[t][n0]);
          s[4 * g] = fmaf(a, s[4 * g], dtx * bv.x);
          s[4 * g + 1] = fmaf(a, s[4 * g + 1], dtx * bv.y);
          s[4 * g + 2] = fmaf(a, s[4 * g + 2], dtx * bv.z);
          s[4 * g + 3] = fmaf(a, s[4 * g + 3], dtx * bv.w);
          acc = fmaf(s[4 * g], cv.x, acc);
          acc = fmaf(s[4 * g + 1], cv.y, acc);
          acc = fmaf(s[4 * g + 2], cv.z, acc);
          acc = fmaf(s[4 * g + 3], cv.w, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0 && p < P) ys[t][p] = fmaf(d_h, xv, acc);
    }
    __syncthreads();

    for (int i = tid; i < nt * P; i += kThreads) {
      const int t = i / P;
      const int c = i % P;
      y[((static_cast<size_t>(b) * S + t0 + t) * H + h) * P + c] = from_f32<T>(ys[t][c]);
    }
    // the next pass writes xs / bs / cs / dts / decay only after every
    // thread has left the token loop (the barrier above), and ys only
    // after the barrier that follows its staging
  }

  if (p < P) {
    float* out = state + ((static_cast<size_t>(b) * H + h) * P + p) * N;
#pragma unroll
    for (int g = 0; g < kPerThread / 4; ++g) {
      if (g < groups) {
        const int n0 = 4 * (q + kLanesPerRow * g);
        *reinterpret_cast<float4*>(out + n0) =
            make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 route

constexpr int kTcThreads = 128;                // 4 warps
constexpr int kTcChunk = 64;                   // tokens per chunk
constexpr int kTcCols = 64;                    // P and N, padded in shared memory
constexpr int kTile = kTcChunk * kTcCols * 2;  // one bf16 tile, bytes
constexpr int kStageBytes = 3 * kTile + kTcChunk * 4;           // x, B, C, dt
constexpr int kStateHi = 2 * kStageBytes;      // the state as bf16 hi, rows p, cols n
constexpr int kStateLo = kStateHi + kTile;     //                   lo
constexpr int kCum = kStateLo + kTile;         // each warp's cum, f32 [4][64]
constexpr int kWts = kCum + 4 * kTcChunk * 4;  // each warp's w_u, f32 [4][64]
constexpr int kTcSmemBytes = kWts + 4 * kTcChunk * 4;            // 68,096

typedef __nv_bfloat16 bf16;

// element offset of (row, col) in a 64-column bf16 tile whose 16-byte
// units are XOR-swizzled by row
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
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

// (a, b) as bf16 pairs hi = bf16(f) and lo = bf16(f - hi): a product with
// hi and one with lo recover f to about 2^-16
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(a - __low2float(h), b - __high2float(h));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__low2float(h), __high2float(h));
}

// ldmatrix lane addresses (lane l, matrix l >> 3, row l & 7) for a 16 x 16
// block at (r0, c0) of a tile:
//  A operand, tile rows = m, cols = k:       rows r0 + (l & 15), cols c0 + (l >> 4) 8
//  A operand from a tile stored k x m (.trans): rows r0 + (l & 7) + (l >> 4) 8,
//                                              cols c0 + ((l >> 3) & 1) 8
//  B operands of two n8 tiles, tile rows = n, cols = k:
//                                              rows r0 + (l & 7) + (l >> 4) 8,
//                                              cols c0 + ((l >> 3) & 1) 8
//  B operands from a tile stored k x n (.trans): rows r0 + (l & 7) + ((l >> 3) & 1) 8,
//                                              cols c0 + (l >> 4) 8
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

// one chunk's rows of a (rows, cols) bf16 source into a swizzled tile:
// row t at src + t * stride; rows at or past nt and columns past cols
// (already zero) are left as zeros. kVec: 16-byte cp.async copies (cols a
// multiple of 8, 16-byte aligned rows); otherwise element by element.
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
__device__ __forceinline__ void load_chunk(unsigned char* stage, const bf16* x, const float* dt,
                                           const bf16* Bm, const bf16* Cm, int b, int h,
                                           int t0, int S, int H, int P, int N, int tid) {
  const int nt = min(kTcChunk, S - t0);
  const size_t row0 = static_cast<size_t>(b) * S + t0;
  load_tile<kVec>(reinterpret_cast<bf16*>(stage), x + (row0 * H + h) * P,
                  static_cast<size_t>(H) * P, P, nt, tid);
  load_tile<kVec>(reinterpret_cast<bf16*>(stage + kTile), Bm + row0 * N, N, N, nt, tid);
  load_tile<kVec>(reinterpret_cast<bf16*>(stage + 2 * kTile), Cm + row0 * N, N, N, nt, tid);
  float* dts = reinterpret_cast<float*>(stage + 3 * kTile);
  if (tid < kTcChunk) cp_async4(dts + tid, dt + (row0 + (tid < nt ? tid : 0)) * H + h, tid < nt);
  cp_async_commit();
}

template <bool kVec>
__global__ void __launch_bounds__(kTcThreads, 3)
    ssd_scan_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm, const float* __restrict__ D,
                       bf16* __restrict__ y, float* __restrict__ state, int S, int H, int P,
                       int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;       // fragment row
  const int c2 = (lane & 3) * 2; // fragment column pair
  const float a_h = A[h];
  const float d_h = D[h];
  bf16* s_hi = reinterpret_cast<bf16*>(smem + kStateHi);
  bf16* s_lo = reinterpret_cast<bf16*>(smem + kStateLo);
  float* cum = reinterpret_cast<float*>(smem + kCum) + w * kTcChunk;
  float* wts = reinterpret_cast<float*>(smem + kWts) + w * kTcChunk;

  // zeros everywhere once: the padding columns stay zero for good, and the
  // state starts at zero
  for (int i = tid; i < kWts / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int n_chunks = (S + kTcChunk - 1) / kTcChunk;
  load_chunk<kVec>(smem, x, dt, Bm, Cm, b, h, 0, S, H, P, N, tid);

  float s[8][4];   // state rows p = 16w + g (+8), cols n = 8j + c2 (+1)
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kTcChunk;
    const int nt = min(kTcChunk, S - t0);
    unsigned char* stage = smem + (ci & 1) * kStageBytes;
    const bf16* xs = reinterpret_cast<const bf16*>(stage);
    const bf16* bs = reinterpret_cast<const bf16*>(stage + kTile);
    const bf16* cs = reinterpret_cast<const bf16*>(stage + 2 * kTile);
    const float* dts = reinterpret_cast<const float*>(stage + 3 * kTile);
    cp_async_wait_all();
    __syncthreads();   // this chunk has landed; the previous one is done with
    if (ci + 1 < n_chunks)
      load_chunk<kVec>(smem + ((ci + 1) & 1) * kStageBytes, x, dt, Bm, Cm, b, h, t0 + kTcChunk,
                       S, H, P, N, tid);

    // cum = cumsum(dt A), each warp its own copy: lane l holds tokens 2l, 2l+1
    {
      const float a0 = dts[2 * lane] * a_h;
      const float a1 = dts[2 * lane + 1] * a_h;
      float incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      const float c0 = incl - a1;
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = incl;
      wts[2 * lane] = dts[2 * lane] * __expf(total - c0);
      wts[2 * lane + 1] = dts[2 * lane + 1] * __expf(total - incl);
    }
    __syncwarp();

    const int ta = 16 * w + g;   // this thread's two query rows
    const int tb = ta + 8;

    // C fragments of this warp's rows, k over n
    uint32_t cf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4(cf[kk], cs + a_off(16 * w, 16 * kk, lane));

    // G = C B^T on the causal tiles (u <= 16w + 15)
    float gm[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) gm[j][0] = gm[j][1] = gm[j][2] = gm[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp <= w) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t bf[4];
          ldsm_x4(bf, bs + b_off(16 * jp, 16 * kk, lane));
          mma(gm[2 * jp], cf[kk], bf[0], bf[1]);
          mma(gm[2 * jp + 1], cf[kk], bf[2], bf[3]);
        }
      }
    }

    // y = exp(cum_t) (C S^T)[t], S as hi + lo
    float yv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) yv[j][0] = yv[j][1] = yv[j][2] = yv[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, s_hi + b_off(16 * jp, 16 * kk, lane));
        ldsm_x4(bl, s_lo + b_off(16 * jp, 16 * kk, lane));
        mma(yv[2 * jp], cf[kk], bh[0], bh[1]);
        mma(yv[2 * jp], cf[kk], bl[0], bl[1]);
        mma(yv[2 * jp + 1], cf[kk], bh[2], bh[3]);
        mma(yv[2 * jp + 1], cf[kk], bl[2], bl[3]);
      }
    }
    const float cum_a = cum[ta];
    const float cum_b = cum[tb];
    {
      const float ea = __expf(cum_a);
      const float eb = __expf(cum_b);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        yv[j][0] *= ea;
        yv[j][1] *= ea;
        yv[j][2] *= eb;
        yv[j][3] *= eb;
      }
    }

    // y += M x, M[t,u] = G[t,u] exp(cum_t - cum_u) dt_u for u <= t, as hi + lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk <= w) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
          const int u0 = 8 * j + c2;
          const float cu0 = cum[u0], cu1 = cum[u0 + 1];
          const float du0 = dts[u0], du1 = dts[u0 + 1];
          const float m0 = u0 <= ta ? gm[j][0] * __expf(cum_a - cu0) * du0 : 0.f;
          const float m1 = u0 + 1 <= ta ? gm[j][1] * __expf(cum_a - cu1) * du1 : 0.f;
          const float m2 = u0 <= tb ? gm[j][2] * __expf(cum_b - cu0) * du0 : 0.f;
          const float m3 = u0 + 1 <= tb ? gm[j][3] * __expf(cum_b - cu1) * du1 : 0.f;
          split2(m0, m1, ah[2 * half], al[2 * half]);
          split2(m2, m3, ah[2 * half + 1], al[2 * half + 1]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, xs + bt_off(16 * kk, 16 * jp, lane));
          mma(yv[2 * jp], ah, bf[0], bf[1]);
          mma(yv[2 * jp], al, bf[0], bf[1]);
          mma(yv[2 * jp + 1], ah, bf[2], bf[3]);
          mma(yv[2 * jp + 1], al, bf[2], bf[3]);
        }
      }
    }

    // + D x, one rounding, stored for the rows inside the sequence
    {
      const size_t row0 = static_cast<size_t>(b) * S + t0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + c2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = half ? tb : ta;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(xs + swz(t, p));
          const float v0 = fmaf(d_h, __low2float(xv), yv[j][2 * half]);
          const float v1 = fmaf(d_h, __high2float(xv), yv[j][2 * half + 1]);
          if (t < nt && p < P) {
            bf16* out = y + ((row0 + t) * H + h) * P + p;
            if (kVec) {
              *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
            } else {
              out[0] = __float2bfloat16(v0);
              if (p + 1 < P) out[1] = __float2bfloat16(v1);
            }
          }
        }
      }
    }

    // S <- exp(total) S + (w x)^T B, this warp's rows p = 16w..16w+15;
    // the A fragments (w_u x_u)^T come from x by a transposed ldmatrix,
    // scaled in f32 and split into hi + lo in registers
    {
      const float decay = __expf(cum[kTcChunk - 1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] *= decay;
        s[j][1] *= decay;
        s[j][2] *= decay;
        s[j][3] *= decay;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t xa[4], ah[4], al[4];
        ldsm_x4_t(xa, xs + at_off(16 * kk, 16 * w, lane));
        // registers 0, 1 hold u = 16kk + c2 (+1), registers 2, 3 u + 8 (+1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = 16 * kk + c2 + (i >> 1) * 8;
          const float2 xv = unpack(xa[i]);
          split2(xv.x * wts[u], xv.y * wts[u + 1], ah[i], al[i]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, bs + bt_off(16 * kk, 16 * jp, lane));
          mma(s[2 * jp], ah, bf[0], bf[1]);
          mma(s[2 * jp], al, bf[0], bf[1]);
          mma(s[2 * jp + 1], ah, bf[2], bf[3]);
          mma(s[2 * jp + 1], al, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // every warp is done reading the state's copies
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hi, lo;
      split2(s[j][0], s[j][1], hi, lo);
      *reinterpret_cast<uint32_t*>(s_hi + swz(ta, 8 * j + c2)) = hi;
      *reinterpret_cast<uint32_t*>(s_lo + swz(ta, 8 * j + c2)) = lo;
      split2(s[j][2], s[j][3], hi, lo);
      *reinterpret_cast<uint32_t*>(s_hi + swz(tb, 8 * j + c2)) = hi;
      *reinterpret_cast<uint32_t*>(s_lo + swz(tb, 8 * j + c2)) = lo;
    }
  }

  // the final state, rows p < P, columns n < N
  const int pa = 16 * w + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + c2;
    if (n >= N) continue;
    if (pa < P)
      *reinterpret_cast<float2*>(state + ((static_cast<size_t>(b) * H + h) * P + pa) * N + n) =
          make_float2(s[j][0], s[j][1]);
    if (pa + 8 < P)
      *reinterpret_cast<float2*>(state + ((static_cast<size_t>(b) * H + h) * P + pa + 8) * N +
                                 n) = make_float2(s[j][2], s[j][3]);
  }
}

cudaError_t launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* D, void* y, void* state, int B, int S,
                       int H, int P, int N, cudaStream_t stream) {
  const dim3 grid(H, B);
  ssd_scan_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(D), static_cast<float*>(y),
      static_cast<float*>(state), S, H, P, N);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, const void* D, void* y, void* state, int B, int S,
                        int H, int P, int N, cudaStream_t stream) {
  const bool vec = P % 8 == 0 && aligned16(x) && aligned16(Bm) && aligned16(Cm) && aligned16(y);
  auto kernel = vec ? ssd_scan_tc_kernel<true> : ssd_scan_tc_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const float*>(D),
      static_cast<bf16*>(y), static_cast<float*>(state), S, H, P, N);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the backward
//
// Given dy (B, S, H, P) in the input type and optionally the gradient of
// the final state dF (B, H, P, N) f32: dx (input type), ddt (B, S, H) f32,
// and through a second, summing launch dA, dD (H,) f32 and dBm, dCm
// (B, S, 1, N) in the input type. One route for both types: the per-token
// recurrence on CUDA cores, every sum in f32.
//
// Replaces what the reference trains through: jax.grad of ssd_chunked
// (src/repro/kernels/mamba2_scan/ref.py), which XLA differentiates (no
// Pallas kernel of the reference defines a VJP).
//
// Per (b, h), with the adjoint dS_t = dy_t C_t^T + a_{t+1} dS_{t+1}
// (dS_T adds dF), g_t = dS_t B_t:
//     dx_t = dt_t g_t + D dy_t          ddt_t = x_t . g_t + A a_t <dS_t, S_{t-1}>
//     dB_t = dt_t dS_t^T x_t            dC_t = S_t^T dy_t
//     dA = sum dt_t a_t <dS_t, S_{t-1}> dD = sum dy_t . x_t
// dB and dC sum over heads and dA, dD over batch rows afterwards, from f32
// partials in a fixed order (no atomics: the result is the same bitwise
// from call to call).
//
// What bounds it on this card: bytes, as the forward. At the zamba2-2.7b
// training shape (B 4, S 1024, H 80, P = N = 64, bf16) it must read x, dt,
// B, C, dy and write dx, ddt, dB, dC once, about 131 MB, 0.039 ms at
// 3.35 TB/s. This first design is far from that (3.26 ms on an NVIDIA
// H100 80GB HBM3 at 700 W, 84 times the bound): every token costs each
// thread about 70 state FMAs on CUDA cores (1.3 G state elements a sweep)
// and two sums over the 64 rows of the state, with 2 blocks of 8 warps an
// SM (128 registers a thread). A chunked tensor-core design, like the
// forward's bf16 route, is the way to the bound.
//
// Design: one block of 256 threads per (head, batch row); thread (p, q)
// holds 16 entries of row p of the state and of its adjoint in registers
// (columns 4 (q + 4 g) + e, padded to 64 with zeros). A first sweep runs
// the recurrence and saves the state before every 16-token chunk to a
// scratch buffer (B, H, ceil(S / 16), P, 64). The reverse sweep takes the
// chunks last to first: it stages the chunk's inputs in shared memory,
// steps the saved state 8 tokens on to a second copy, and for each token t
// (last to first) recomputes S_{t-1} from the nearer of the two in at most
// 7 steps, so the state and its adjoint meet at the same token without a
// decay divided out or a cumulative sum of cancelling terms. g sums over
// the 4 threads of a row, <dS, S_{t-1}> over the warp, and dB, dC over the
// 64 rows: a reduce-scatter within the warp (14 shuffles for 16 columns)
// into per-warp rows of shared memory, summed over the 8 warps once the
// chunk is done, when dx, ddt and the per-warp dA, dD sums are written.

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdChunk = 16;                  // tokens between saved states
constexpr int kBwdHalf = kBwdChunk / 2;        // the second copy's token
constexpr int kCols = 64;                      // state columns, zero-padded
constexpr int kBwdRow = kBwdChunk * kCols;     // one staged (token, column) tile
// the backward's dynamic shared memory, in floats: x, dy, B, C staged as
// f32 tiles, dt and the decays, g, the per-warp <dS, S_{t-1}>, and the
// per-warp partial sums of dC and dB
constexpr int kBwdX = 0;
constexpr int kBwdDy = kBwdX + kBwdRow;
constexpr int kBwdB = kBwdDy + kBwdRow;
constexpr int kBwdC = kBwdB + kBwdRow;
constexpr int kBwdDt = kBwdC + kBwdRow;
constexpr int kBwdDecay = kBwdDt + kBwdChunk;
constexpr int kBwdG = kBwdDecay + kBwdChunk;
constexpr int kBwdDl = kBwdG + kBwdRow;
constexpr int kBwdRedC = kBwdDl + kBwdChunk * kBwdWarps;
constexpr int kBwdRedB = kBwdRedC + kBwdChunk * kBwdWarps * kCols;
constexpr int kBwdSmemBytes = (kBwdRedB + kBwdChunk * kBwdWarps * kCols) * 4;   // 86,656

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

// one token of the recurrence on this thread's 16 entries of row p
__device__ __forceinline__ void ssd_step(float (&s)[16], const float* sm, int t, int p, int q) {
  const float a = sm[kBwdDecay + t];
  const float dtx = sm[kBwdDt + t] * sm[kBwdX + t * kCols + p];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 bv = *reinterpret_cast<const float4*>(sm + kBwdB + t * kCols + 4 * (q + 4 * g));
    s[4 * g] = fmaf(a, s[4 * g], dtx * bv.x);
    s[4 * g + 1] = fmaf(a, s[4 * g + 1], dtx * bv.y);
    s[4 * g + 2] = fmaf(a, s[4 * g + 2], dtx * bv.z);
    s[4 * g + 3] = fmaf(a, s[4 * g + 3], dtx * bv.w);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const float* __restrict__ D,
                        const T* __restrict__ dy, const float* __restrict__ dfinal,
                        T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ ck,
                        float* __restrict__ db_part, float* __restrict__ dc_part,
                        float* __restrict__ da_part, float* __restrict__ dd_part, int S, int H,
                        int P, int N) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float warp_acc[2][kBwdWarps];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int p = tid / 4;
  const int q = tid % 4;
  const float a_h = A[h];
  const float d_h = D[h];
  const int nck = (S + kBwdChunk - 1) / kBwdChunk;
  float* ck_bh = ck + (static_cast<size_t>(b) * H + h) * nck * kCols * kCols;
  const size_t tok = static_cast<size_t>(H) * P;   // x / dy stride per token

  // sweep 1: the state before every chunk
  float s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  for (int c = 0; c < nck; ++c) {
    const int t0 = c * kBwdChunk;
    const int nt = min(kBwdChunk, S - t0);
    float* out = ck_bh + (static_cast<size_t>(c) * kCols + p) * kCols;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      *reinterpret_cast<float4*>(out + 4 * (q + 4 * g)) =
          make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    stage_tile(sm + kBwdX, x, (row0 * H + h) * P, tok, nt, P);
    stage_tile(sm + kBwdB, Bm, row0 * N, N, nt, N);
    if (tid < kBwdChunk) {
      const float d = tid < nt ? dt[(row0 + tid) * H + h] : 0.f;
      sm[kBwdDt + tid] = d;
      sm[kBwdDecay + tid] = expf(d * a_h);
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) ssd_step(s, sm, t, p, q);
    __syncthreads();
  }

  // sweep 2, chunks last to first
  float ds[16];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int n0 = 4 * (q + 4 * g);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (dfinal != nullptr && p < P && n0 < N)
      v = *reinterpret_cast<const float4*>(dfinal + ((static_cast<size_t>(b) * H + h) * P + p) * N +
                                           n0);
    ds[4 * g] = v.x;
    ds[4 * g + 1] = v.y;
    ds[4 * g + 2] = v.z;
    ds[4 * g + 3] = v.w;
  }
  float da_acc = 0.f, dd_acc = 0.f;   // lane 0 of each warp: its tokens' sums
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kBwdChunk;
    const int nt = min(kBwdChunk, S - t0);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    stage_tile(sm + kBwdX, x, (row0 * H + h) * P, tok, nt, P);
    stage_tile(sm + kBwdDy, dy, (row0 * H + h) * P, tok, nt, P);
    stage_tile(sm + kBwdB, Bm, row0 * N, N, nt, N);
    stage_tile(sm + kBwdC, Cm, row0 * N, N, nt, N);
    if (tid < kBwdChunk) {
      const float d = tid < nt ? dt[(row0 + tid) * H + h] : 0.f;
      sm[kBwdDt + tid] = d;
      sm[kBwdDecay + tid] = expf(d * a_h);
    }
    float s0[16], s8[16];
    const float* in = ck_bh + (static_cast<size_t>(c) * kCols + p) * kCols;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(in + 4 * (q + 4 * g));
      s0[4 * g] = v.x;
      s0[4 * g + 1] = v.y;
      s0[4 * g + 2] = v.z;
      s0[4 * g + 3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) s8[i] = s0[i];
    for (int t = 0; t < min(kBwdHalf, nt); ++t) ssd_step(s8, sm, t, p, q);

    for (int t = nt - 1; t >= 0; --t) {
      // S_{t-1}: the nearer saved copy stepped on to token t - 1
      const bool late = t >= kBwdHalf;
      float sp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sp[i] = late ? s8[i] : s0[i];
      for (int j = late ? kBwdHalf : 0; j < t; ++j) ssd_step(sp, sm, j, p, q);

      const float dyp = sm[kBwdDy + t * kCols + p];
      const float xp = sm[kBwdX + t * kCols + p];
      const float at = sm[kBwdDecay + t];
      const float dtx = sm[kBwdDt + t] * xp;
      float gsum = 0.f, dl = 0.f, v[16];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int n0 = 4 * (q + 4 * g);
        const float4 bv = *reinterpret_cast<const float4*>(sm + kBwdB + t * kCols + n0);
        const float4 cv = *reinterpret_cast<const float4*>(sm + kBwdC + t * kCols + n0);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * g + e;
          ds[i] = fmaf(dyp, cc[e], ds[i]);                 // dS_t
          dl = fmaf(ds[i], sp[i], dl);
          gsum = fmaf(ds[i], bb[e], gsum);
          v[i] = fmaf(at, sp[i], dtx * bb[e]) * dyp;       // S_t dy_t
        }
      }
      gsum += __shfl_xor_sync(0xffffffffu, gsum, 1);
      gsum += __shfl_xor_sync(0xffffffffu, gsum, 2);
      if (q == 0) sm[kBwdG + t * kCols + p] = gsum;
      dl = warp_sum(dl);
      if (lane == 0) sm[kBwdDl + t * kBwdWarps + w] = at * dl;
      int n0;
      float2 r = rows_sum16(v, lane, n0);
      *reinterpret_cast<float2*>(sm + kBwdRedC + (t * kBwdWarps + w) * kCols + n0) = r;
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = ds[i] * xp;        // dS_t x_t
      r = rows_sum16(v, lane, n0);
      *reinterpret_cast<float2*>(sm + kBwdRedB + (t * kBwdWarps + w) * kCols + n0) = r;
#pragma unroll
      for (int i = 0; i < 16; ++i) ds[i] *= at;              // a_t dS_t
    }
    __syncthreads();

    for (int i = tid; i < nt * kCols; i += kBwdThreads) {
      const int t = i / kCols;
      const int n = i % kCols;
      if (n < N) {
        float sc = 0.f, sb = 0.f;
#pragma unroll
        for (int j = 0; j < kBwdWarps; ++j) {
          sc += sm[kBwdRedC + (t * kBwdWarps + j) * kCols + n];
          sb += sm[kBwdRedB + (t * kBwdWarps + j) * kCols + n];
        }
        const size_t at = ((row0 + t) * H + h) * N + n;
        dc_part[at] = sc;
        db_part[at] = sm[kBwdDt + t] * sb;
      }
      if (n < P)
        dx[((row0 + t) * H + h) * P + n] = from_f32<T>(
            fmaf(sm[kBwdDt + t], sm[kBwdG + t * kCols + n], d_h * sm[kBwdDy + t * kCols + n]));
    }
    for (int t = w; t < nt; t += kBwdWarps) {
      const float* xr = sm + kBwdX + t * kCols;
      const float xg = warp_sum(xr[lane] * sm[kBwdG + t * kCols + lane] +
                                xr[lane + 32] * sm[kBwdG + t * kCols + lane + 32]);
      const float xdy = warp_sum(xr[lane] * sm[kBwdDy + t * kCols + lane] +
                                 xr[lane + 32] * sm[kBwdDy + t * kCols + lane + 32]);
      if (lane == 0) {
        float dla = 0.f;
#pragma unroll
        for (int j = 0; j < kBwdWarps; ++j) dla += sm[kBwdDl + t * kBwdWarps + j];
        ddt[(row0 + t) * H + h] = fmaf(a_h, dla, xg);
        da_acc = fmaf(sm[kBwdDt + t], dla, da_acc);
        dd_acc += xdy;
      }
    }
    __syncthreads();   // the next chunk restages every tile
  }
  if (lane == 0) {
    warp_acc[0][w] = da_acc;
    warp_acc[1][w] = dd_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float da = 0.f, dd = 0.f;
    for (int j = 0; j < kBwdWarps; ++j) {
      da += warp_acc[0][j];
      dd += warp_acc[1][j];
    }
    da_part[static_cast<size_t>(b) * H + h] = da;
    dd_part[static_cast<size_t>(b) * H + h] = dd;
  }
}

// out[o][n] = sum over m of in[o][m][n], m in order (the partials' fixed
// order, so the sum is the same bitwise from call to call)
template <typename T>
__global__ void sum_mid_kernel(const float* __restrict__ in, T* __restrict__ out, int outer,
                               int mid, int inner) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(outer) * inner) return;
  const size_t o = i / inner;
  const float* src = in + o * mid * inner + i % inner;
  float acc = 0.f;
  for (int m = 0; m < mid; ++m) acc += src[static_cast<size_t>(m) * inner];
  out[i] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch_sum(const float* in, void* out, int outer, int mid, int inner,
                       cudaStream_t stream) {
  const size_t n = static_cast<size_t>(outer) * inner;
  sum_mid_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      in, static_cast<T*>(out), outer, mid, inner);
  return cudaGetLastError();
}

// floats of the backward's scratch: the saved states (B, H, chunks, 64,
// 64), the per-head partials of dB and dC (B, S, H, N) and the per-row
// partials of dA and dD (B, H)
size_t backward_work_floats(int B, int S, int H, int N) {
  const size_t nck = (S + kBwdChunk - 1) / kBwdChunk;
  return static_cast<size_t>(B) * H * nck * kCols * kCols +
         2 * static_cast<size_t>(B) * S * H * N + 2 * static_cast<size_t>(B) * H;
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* dy, const void* dfinal,
                            void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* dD,
                            void* work, int B, int S, int H, int P, int N, cudaStream_t stream) {
  const size_t nck = (S + kBwdChunk - 1) / kBwdChunk;
  float* ck = static_cast<float*>(work);
  float* db_part = ck + static_cast<size_t>(B) * H * nck * kCols * kCols;
  float* dc_part = db_part + static_cast<size_t>(B) * S * H * N;
  float* da_part = dc_part + static_cast<size_t>(B) * S * H * N;
  float* dd_part = da_part + static_cast<size_t>(B) * H;
  auto kernel = ssd_scan_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kBwdThreads, kBwdSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const T*>(dy), static_cast<const float*>(dfinal), static_cast<T*>(dx),
      static_cast<float*>(ddt), ck, db_part, dc_part, da_part, dd_part, S, H, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_sum<T>(db_part, dBm, B * S, H, N, stream)) != cudaSuccess) return err;
  if ((err = launch_sum<T>(dc_part, dCm, B * S, H, N, stream)) != cudaSuccess) return err;
  if ((err = launch_sum<float>(da_part, dA, 1, B, H, stream)) != cudaSuccess) return err;
  return launch_sum<float>(dd_part, dD, 1, B, H, stream);
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees: f32 route
// {kThreads, kLanesPerRow, kMaxP, kMaxN, kTokens}, then bf16 route
// {kTcThreads, kTcChunk, kTcSmemBytes}, then the backward {kBwdThreads,
// kBwdChunk, kBwdSmemBytes}.
void ssd_scan_config(int* cfg) {
  cfg[0] = kThreads;
  cfg[1] = kLanesPerRow;
  cfg[2] = kMaxP;
  cfg[3] = kMaxN;
  cfg[4] = kTokens;
  cfg[5] = kTcThreads;
  cfg[6] = kTcChunk;
  cfg[7] = kTcSmemBytes;
  cfg[8] = kBwdThreads;
  cfg[9] = kBwdChunk;
  cfg[10] = kBwdSmemBytes;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, S, H, P), Bm / Cm (B, S, 1, N), y (B, S, H, P) of one type:
// dtype 0 = float32 (the per-token route), 1 = bfloat16 (the tensor-core
// route); dt (B, S, H), A (H,), D (H,) and state (B, H, P, N) float32;
// all contiguous on the card, state 16-byte aligned. 1 <= P <= 64, N a
// multiple of 16 up to 64. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int ssd_scan_forward(const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, const void* D, void* y, void* state, int B, int S,
                     int H, int P, int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 16 || N > kMaxN ||
      N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_f32(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, N, st));
  if (dtype == 1)
    return static_cast<int>(launch_bf16(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, N, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Floats of the scratch buffer ssd_scan_backward takes as `work`.
size_t ssd_scan_backward_work(int B, int S, int H, int N) {
  return backward_work_floats(B, S, H, N);
}

// The gradient: x, Bm, Cm, dy and dx, dBm, dCm (B, S, 1, N) of one type
// (dtype 0 = float32, 1 = bfloat16); dt, A, D, ddt (B, S, H), dA, dD (H,)
// and dfinal (B, H, P, N; null for none) float32; work a float32 buffer of
// ssd_scan_backward_work floats; all contiguous on the card, 16-byte
// aligned. Shapes as ssd_scan_forward takes them. Launches the backward
// and the four sums on `stream`, returns cudaGetLastError() (0 on
// success); does not synchronise.
int ssd_scan_backward(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, const void* D, const void* dy, const void* dfinal,
                      void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* dD, void* work,
                      int B, int S, int H, int P, int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 16 || N > kMaxN ||
      N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_backward<float>(x, dt, A, Bm, Cm, D, dy, dfinal, dx, ddt, dA,
                                                   dBm, dCm, dD, work, B, S, H, P, N, st));
  if (dtype == 1)
    return static_cast<int>(launch_backward<bf16>(x, dt, A, Bm, Cm, D, dy, dfinal, dx, ddt, dA,
                                                  dBm, dCm, dD, work, B, S, H, P, N, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
