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

// (a, b) as bf16 pairs hi, mid = bf16(f - hi) and lo = bf16(f - hi - mid):
// three products recover f to about 2^-24
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float ra = a - __low2float(h);
  const float rb = b - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack(ra - __low2float(m), rb - __high2float(m));
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

// one chunk's x, B, C (C only with kC) and dt into a stage of the ring
template <bool kVec, bool kC>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const bf16* x, const float* dt,
                                           const bf16* Bm, const bf16* Cm, int b, int h,
                                           int t0, int S, int H, int P, int N, int tid) {
  const int nt = min(kTcChunk, S - t0);
  const size_t row0 = static_cast<size_t>(b) * S + t0;
  load_tile<kVec>(reinterpret_cast<bf16*>(stage), x + (row0 * H + h) * P,
                  static_cast<size_t>(H) * P, P, nt, tid);
  load_tile<kVec>(reinterpret_cast<bf16*>(stage + kTile), Bm + row0 * N, N, N, nt, tid);
  if (kC)
    load_tile<kVec>(reinterpret_cast<bf16*>(stage + 2 * kTile), Cm + row0 * N, N, N, nt, tid);
  float* dts = reinterpret_cast<float*>(stage + 3 * kTile);
  if (tid < kTcChunk) cp_async4(dts + tid, dt + (row0 + (tid < nt ? tid : 0)) * H + h, tid < nt);
  cp_async_commit();
}

// kStates: the backward's state sweep. It computes no y and no final
// state; before each chunk it writes the state it enters with, as bf16 hi,
// mid and lo planes (64 x 64, row-major) to `states` (B, H, chunks, 3, 64,
// 64), and its state update takes (w x)^T in three parts: the backward's
// decay gradient needs the state to about 2^-24, the forward's outputs to
// 2^-17.
template <bool kVec, bool kStates>
__global__ void __launch_bounds__(kTcThreads, 3)
    ssd_scan_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm, const float* __restrict__ D,
                       bf16* __restrict__ y, float* __restrict__ state,
                       bf16* __restrict__ states, int S, int H, int P, int N) {
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
  load_chunk<kVec, !kStates>(smem, x, dt, Bm, Cm, b, h, 0, S, H, P, N, tid);

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
      load_chunk<kVec, !kStates>(smem + ((ci + 1) & 1) * kStageBytes, x, dt, Bm, Cm, b, h,
                                 t0 + kTcChunk, S, H, P, N, tid);

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

    const int ta = 16 * w + g;   // this thread's two query rows (and state rows)
    const int tb = ta + 8;

    if constexpr (kStates) {
      // the state before this chunk, rows p = ta, tb, as hi, mid, lo planes:
      // swizzled into s_hi, s_lo and stage 0's C tile (none of them used
      // here), then out in 16-byte units, row-major
      bf16* plane[3] = {s_hi, s_lo, reinterpret_cast<bf16*>(smem + 2 * kTile)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t v[3];
        split3(s[j][0], s[j][1], v[0], v[1], v[2]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          *reinterpret_cast<uint32_t*>(plane[i] + swz(ta, 8 * j + c2)) = v[i];
        split3(s[j][2], s[j][3], v[0], v[1], v[2]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          *reinterpret_cast<uint32_t*>(plane[i] + swz(tb, 8 * j + c2)) = v[i];
      }
      __syncthreads();
      constexpr int kPlane = kTcChunk * kTcCols;
      bf16* out = states + ((static_cast<size_t>(b) * H + h) * n_chunks + ci) * 3 * kPlane;
      for (int u = tid; u < 3 * kTcChunk * 8; u += kTcThreads) {
        const int i = u / (kTcChunk * 8);
        const int row = (u >> 3) % kTcChunk;
        const int col = (u & 7) << 3;
        *reinterpret_cast<uint4*>(out + i * kPlane + row * kTcCols + col) =
            *reinterpret_cast<const uint4*>(plane[i] + swz(row, col));
      }
    } else {
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
    }   // !kStates

    // S <- exp(total) S + (w x)^T B, this warp's rows p = 16w..16w+15;
    // the A fragments (w_u x_u)^T come from x by a transposed ldmatrix,
    // scaled in f32 and split into hi + lo (with kStates hi, mid, lo) in
    // registers
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
      constexpr int kParts = kStates ? 3 : 2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t xa[4], af[kParts][4];
        ldsm_x4_t(xa, xs + at_off(16 * kk, 16 * w, lane));
        // registers 0, 1 hold u = 16kk + c2 (+1), registers 2, 3 u + 8 (+1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = 16 * kk + c2 + (i >> 1) * 8;
          const float2 xv = unpack(xa[i]);
          if constexpr (kStates)
            split3(xv.x * wts[u], xv.y * wts[u + 1], af[0][i], af[1][i], af[2][i]);
          else
            split2(xv.x * wts[u], xv.y * wts[u + 1], af[0][i], af[1][i]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, bs + bt_off(16 * kk, 16 * jp, lane));
#pragma unroll
          for (int part = 0; part < kParts; ++part) {
            mma(s[2 * jp], af[part], bf[0], bf[1]);
            mma(s[2 * jp + 1], af[part], bf[2], bf[3]);
          }
        }
      }
    }
    if constexpr (!kStates) {
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
  }
  if constexpr (kStates) return;

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
  auto kernel = vec ? ssd_scan_tc_kernel<true, false> : ssd_scan_tc_kernel<false, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const float*>(D),
      static_cast<bf16*>(y), static_cast<float*>(state), nullptr, S, H, P, N);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the backward
//
// Given dy (B, S, H, P) in the input type and optionally the gradient of
// the final state dF (B, H, P, N) f32: dx (input type), ddt (B, S, H) f32,
// and through summing launches dA, dD (H,) f32 and dBm, dCm (B, S, 1, N)
// in the input type. Every sum in f32.
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
// 3.35 TB/s; the bf16 route's own products (about 58 GFLOP, counting
// its bf16 parts and both sweeps) would take 0.059 ms at the bf16
// tensor-core rate.
//
// Two routes, chosen by the input type alone:
//
// f32: the first design, token by token on CUDA cores (3.3 ms at the path
// shape on an NVIDIA H100 80GB HBM3 at 700 W, 85 times the bound above:
// every token costs each thread about 70 state FMAs, 1.3 G state elements
// a sweep, and two sums over the 64 rows of the state, with 2 blocks of 8
// warps an SM). It stays for f32, whose inputs bf16 products cannot take
// exactly. One block of
// 256 threads per (head, batch row); thread (p, q) holds 16 entries of row
// p of the state and of its adjoint in registers (columns 4 (q + 4 g) + e,
// padded to 64 with zeros). A first sweep runs the recurrence and saves
// the state before every 16-token chunk to a scratch buffer (B, H,
// ceil(S / 16), P, 64). The reverse sweep takes the chunks last to first:
// it stages the chunk's inputs in shared memory, steps the saved state 8
// tokens on to a second copy, and for each token t (last to first)
// recomputes S_{t-1} from the nearer of the two in at most 7 steps, so the
// state and its adjoint meet at the same token without a decay divided
// out or a cumulative sum of cancelling terms. g sums over the 4 threads
// of a row, <dS, S_{t-1}> over the warp, and dB, dC over the 64 rows: a
// reduce-scatter within the warp (14 shuffles for 16 columns) into
// per-warp rows of shared memory, summed over the 8 warps once the chunk
// is done, when dx, ddt and the per-warp dA, dD sums are written.
//
// bf16: the chunked form on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate), 64-token chunks, three launches and the sums:
//  1. the state sweep: the forward's bf16 kernel with kStates, which
//     writes the state entering each chunk as bf16 hi, mid and lo planes
//     to the scratch (B, H, chunks, 3, 64, 64: 126 MB at the path shape
//     against the f32 route's 335 MB); it computes no y. The forward saves
//     nothing (under remat every layer would keep its states).
//  2. the reverse sweep, ssd_scan_bwd_tc_kernel: blocks of 4 warps take
//     the chunks last to first, carrying the adjoint dS_end (the gradient
//     of the state the chunk ends with) as the forward carries S. Per
//     chunk, with cum = cumsum(dt A), L[t,u] = exp(cum_t - cum_u) for u <=
//     t, w_u = dt_u exp(total - cum_u) and S_prev the saved state, warp w
//     owns rows 16w..16w+15 of u, t and p alike:
//       G^T = B C^T, (dY X^T)^T = X dY^T on its u rows (tiles t >= u) and
//       G = C B^T, Dyx = dY X^T on its t rows (tiles u <= t), exact in f32,
//       so every sum of the chunk's weights is a row sum inside the warp;
//       M^T = G^T L dt_u, W^T, W = Dyx L dt_u formed in the accumulators;
//       dX = w_u (B dS_end^T) + M^T dY + D dY        (rows u)
//       dB = w_u (X dS_end) + W^T C                   (rows u, per head)
//       dC = exp(cum_t) (dY S_prev) + W B             (rows t, per head)
//       dS entering the chunk = exp(total) dS_end + (exp(cum) dY)^T C
//     and the log-decay gradient of token v, dseg_v = a_v <dS_v, S_{v-1}>,
//     as a sum of terms that cancel in no order:
//       dseg_v = exp(total) <dS_end, S_prev> + sum_{u<v} q_u
//                + sum_{t>=v} (k_t + rs_t - cs_t),
//       q_u = dt_u exp(total - cum_u) (X dS_end)_u . B_u,
//       k_t = exp(cum_t) (dY S_prev)_t . C_t,
//       rs_t = sum_{u<t} R[t,u], cs_u = sum_{t>u} R[t,u],
//       R = G o Dyx o L dt_u (the diagonal, which cancels, left out),
//     then ddt_v = sum_{t>=v} (G o Dyx o L)[t,v] + q_v / dt_v + A dseg_v
//     (the q term formed without the division) and dA = sum dt_v dseg_v;
//     one warp takes the prefix and suffix sums by shuffles.
//     Rounding: ddt and dA are f32 outputs held to 1e-3 of (1 + |ref|),
//     and ddt is a difference of terms some thousand times larger than
//     itself at some tokens (dA, a sum over tokens, likewise at some
//     heads). So cum is summed in f64 (at strong decay the exponents are
//     differences of cumulative sums of hundreds: in f32 they err by
//     1e-5); rs and cs, whose suffix sums telescope (each R with both ends
//     past v enters once with each sign), are summed in f64 with the scan;
//     and the operands that are not bf16 inputs and reach ddt or dA (the
//     state in the sweep's update and as S_prev, dS_end in X dS_end,
//     exp(cum) dY in the update) are split into three bf16 parts (hi, mid
//     = bf16(f - hi), lo), the others (M, W, dS_end in B dS_end^T) into
//     hi + lo as in the forward. One rounding of any of them misses a
//     tolerance (tests/test_torch_scan_backward_design.py models the
//     route); with two parts for all, ddt read 1.4e-3 to 2.3e-3 at the
//     path shape on the card, and with two for the state dA reached 9.9e-4
//     there. Between chunks dS lives in its three planes (exact to about
//     2^-24), not in registers. Loads: x, B, C and dt in a two-stage
//     cp.async ring (the next chunk's copies in flight under this one's
//     products), dy in one tile loaded once the chunk is done with it, the
//     saved state in its own planes; 114,464 bytes of shared memory, 2
//     blocks an SM. Two blocks per (head, batch row): part 1 takes the
//     later half of the chunks, part 0 the earlier half after carrying
//     the adjoint alone through the later half (the update's product, a
//     quarter of a chunk's time). One block per (head, batch row) left
//     the path's 320 blocks in 1.2 waves, the last 56 alone on their SMs
//     for 40 % of the time; 640 blocks of half the work end nearly
//     together (0.540 -> 0.481 ms on an NVIDIA H100 80GB HBM3, 700 W).
//  3. sum_mid_kernel sums the per-head partials of dB and dC and the
//     per-part and per-row ones of dA and dD in a fixed order.

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

template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
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

// ------------------------------------------------ the backward's bf16 route

constexpr int kBwdTcThreads = 128;                            // 4 warps
constexpr int kBwdTcStage = 3 * kTile + kTcChunk * 4;          // x, B, C, dt
constexpr int kBwdTcDy = 2 * kBwdTcStage;                      // dy, one stage
constexpr int kBwdTcSp = kBwdTcDy + kTile;                     // S_prev hi, mid, lo
constexpr int kBwdTcDs = kBwdTcSp + 3 * kTile;                 // dS_end hi, mid, lo
constexpr int kBwdTcCum = kBwdTcDs + 3 * kTile;                // each warp's cum, f64
constexpr int kBwdTcEcum = kBwdTcCum + 4 * kTcChunk * 8;       // each warp's exp(cum)
constexpr int kBwdTcErev = kBwdTcEcum + 4 * kTcChunk * 4;      // each warp's exp(total - cum)
constexpr int kBwdTcDin = kBwdTcErev + 4 * kTcChunk * 4;       // each warp's decay within a
                                                               // 16-token tile
constexpr int kBwdTcDto = kBwdTcDin + 4 * kTcChunk * 4;        // each warp's decay to its tile
constexpr int kBwdTcTok = kBwdTcDto + 4 * kTcChunk * 4;        // per token e, q (f64), direct
constexpr int kBwdTcRed = kBwdTcTok + 2 * kTcChunk * 8 + kTcChunk * 4;   // per warp, f64
constexpr int kBwdTcSmemBytes = kBwdTcRed + 4 * 8;             // 114,464
static_assert(kBwdTcThreads == kTcThreads, "load_tile strides by kTcThreads");

// one chunk's x, B, C and dt into a stage of the backward's ring
template <bool kVec>
__device__ __forceinline__ void load_bwd_chunk(unsigned char* stage, const bf16* x,
                                               const float* dt, const bf16* Bm, const bf16* Cm,
                                               int b, int h, int t0, int S, int H, int P, int N,
                                               int tid) {
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

// one chunk's dy into its tile
template <bool kVec>
__device__ __forceinline__ void load_bwd_dy(bf16* tile, const bf16* dy, int b, int h, int t0,
                                            int S, int H, int P, int tid) {
  const size_t row0 = static_cast<size_t>(b) * S + t0;
  load_tile<kVec>(tile, dy + (row0 * H + h) * P, static_cast<size_t>(H) * P, P,
                  min(kTcChunk, S - t0), tid);
  cp_async_commit();
}

template <typename F>
__device__ __forceinline__ F quad_sum(F v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc (16 x 64, this warp's rows r0..) += A B: A from a_tile (rows m, k over
// its 64 columns, exact), B a (k, n) f32 operand as kParts bf16 planes (hi,
// then the remainders) kPlane apart from `parts`, each stored rows k
// (kTrans) or rows n (!kTrans)
template <bool kTrans, int kParts>
__device__ __forceinline__ void mma_rows_split(float (&acc)[8][4], const bf16* a_tile, int r0,
                                               const bf16* parts, int lane) {
  constexpr int kPlane = kTcChunk * kTcCols;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_tile + a_off(r0, 16 * kk, lane));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
      for (int i = 0; i < kParts; ++i) {
        uint32_t bf[4];
        if (kTrans)
          ldsm_x4_t(bf, parts + i * kPlane + bt_off(16 * kk, 16 * jp, lane));
        else
          ldsm_x4(bf, parts + i * kPlane + b_off(16 * jp, 16 * kk, lane));
        mma(acc[2 * jp], af, bf[0], bf[1]);
        mma(acc[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc += Wt B over the k tiles kk with lo_kk <= kk <= hi_kk: Wt (this warp's
// rows, k over the chunk's tokens) f32 in accumulator layout, split into hi
// + lo A fragments; B exact from a tile stored rows k
__device__ __forceinline__ void mma_weights(float (&acc)[8][4], const float (&wt)[8][4],
                                            int lo_kk, int hi_kk, const bf16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < lo_kk || kk > hi_kk) continue;
    uint32_t ah[4], al[4];
    split2(wt[2 * kk][0], wt[2 * kk][1], ah[0], al[0]);
    split2(wt[2 * kk][2], wt[2 * kk][3], ah[1], al[1]);
    split2(wt[2 * kk + 1][0], wt[2 * kk + 1][1], ah[2], al[2]);
    split2(wt[2 * kk + 1][2], wt[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b_tile + bt_off(16 * kk, 16 * jp, lane));
      mma(acc[2 * jp], ah, bf[0], bf[1]);
      mma(acc[2 * jp], al, bf[0], bf[1]);
      mma(acc[2 * jp + 1], ah, bf[2], bf[3]);
      mma(acc[2 * jp + 1], al, bf[2], bf[3]);
    }
  }
}

// e = A_rows B_rows^T and f = C_rows D_rows^T (16 x 64 each: this warp's
// rows r0.. of a_tile (c_tile) against the rows of b_tile (d_tile), k over
// 64 columns), exact in f32, on the 16-column tiles jp with lo_jp <= jp <=
// hi_jp, zeros elsewhere; the two products interleaved
__device__ __forceinline__ void mma_rows_rows2(float (&e)[8][4], const bf16* a_tile,
                                               const bf16* b_tile, float (&f)[8][4],
                                               const bf16* c_tile, const bf16* d_tile, int r0,
                                               int lo_jp, int hi_jp, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    e[j][0] = e[j][1] = e[j][2] = e[j][3] = 0.f;
    f[j][0] = f[j][1] = f[j][2] = f[j][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4], cf[4];
    ldsm_x4(af, a_tile + a_off(r0, 16 * kk, lane));
    ldsm_x4(cf, c_tile + a_off(r0, 16 * kk, lane));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp < lo_jp || jp > hi_jp) continue;
      uint32_t bf[4], df[4];
      ldsm_x4(bf, b_tile + b_off(16 * jp, 16 * kk, lane));
      ldsm_x4(df, d_tile + b_off(16 * jp, 16 * kk, lane));
      mma(e[2 * jp], af, bf[0], bf[1]);
      mma(f[2 * jp], cf, df[0], df[1]);
      mma(e[2 * jp + 1], af, bf[2], bf[3]);
      mma(f[2 * jp + 1], cf, df[2], df[3]);
    }
  }
}

__device__ __forceinline__ void zero_rows(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc rows (ra, rb) times (sa, sb)
__device__ __forceinline__ void scale_rows(float (&acc)[8][4], float sa, float sb) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] *= sa;
    acc[j][1] *= sa;
    acc[j][2] *= sb;
    acc[j][3] *= sb;
  }
}

// the f32 pair at (row, col) of a tile held as kParts bf16 planes
template <int kParts>
__device__ __forceinline__ float2 planes_at(const bf16* parts, int row, int col) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = kParts - 1; i >= 0; --i) {   // the small parts first
    const float2 p =
        unpack(*reinterpret_cast<const uint32_t*>(parts + i * kTcChunk * kTcCols + swz(row, col)));
    v.x += p.x;
    v.y += p.y;
  }
  return v;
}

// rows (ra, rb) of acc dotted with the same rows of a bf16 tile, summed
// over the quad: each of the quad's lanes gets both sums
__device__ __forceinline__ float2 rows_dot(const float (&acc)[8][4], const bf16* tile, int ra,
                                           int rb, int c2) {
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 va = planes_at<1>(tile, ra, 8 * j + c2);
    const float2 vb = planes_at<1>(tile, rb, 8 * j + c2);
    da = fmaf(acc[j][0], va.x, fmaf(acc[j][1], va.y, da));
    db = fmaf(acc[j][2], vb.x, fmaf(acc[j][3], vb.y, db));
  }
  return make_float2(quad_sum(da), quad_sum(db));
}

// f32 rows (ra, rb) of acc to out[(row0 + r) * H + h][n] for rows r < nt,
// columns n < N (the per-head partials of dB and dC)
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[8][4], size_t row0,
                                           int h, int H, int N, int nt, int ra, int rb, int c2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + c2;
    if (n >= N) continue;
    if (ra < nt)
      *reinterpret_cast<float2*>(out + ((row0 + ra) * H + h) * N + n) =
          make_float2(acc[j][0], acc[j][1]);
    if (rb < nt)
      *reinterpret_cast<float2*>(out + ((row0 + rb) * H + h) * N + n) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kBwdTcThreads, 2)
    ssd_scan_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const bf16* __restrict__ Bm,
                           const bf16* __restrict__ Cm, const float* __restrict__ D,
                           const bf16* __restrict__ dy, const float* __restrict__ dfinal,
                           const bf16* __restrict__ states, bf16* __restrict__ dx,
                           float* __restrict__ ddt, float* __restrict__ db_part,
                           float* __restrict__ dc_part, float* __restrict__ da_part,
                           float* __restrict__ dd_part, int S, int H, int P, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int part = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int ra = 16 * w + g;   // this thread's two rows (of u, t and p alike)
  const int rb = ra + 8;
  const float a_h = A[h];
  const float d_h = D[h];
  constexpr int kPlane = kTcChunk * kTcCols;
  // the sequence's chunks in two parts, each a block: part 1 the later
  // ones [mid, n), part 0 the earlier ones [0, mid) after the adjoint
  // alone through the later ones (one product a chunk); so 2 B H blocks
  // of about half the work keep 2 blocks an SM busy to the end
  const int n_chunks = (S + kTcChunk - 1) / kTcChunk;
  const int mid_chunk = n_chunks / 2;
  const int lo_chunk = part ? mid_chunk : 0;     // the last chunk this block takes
  const int full_end = part ? n_chunks : mid_chunk;   // chunks below it: every gradient
  const size_t part_bh = (static_cast<size_t>(part) * gridDim.y + b) * H + h;
  if (full_end == 0) {   // one chunk: part 1 takes it
    if (tid == 0) da_part[part_bh] = dd_part[part_bh] = 0.f;
    return;
  }
  bf16* dys = reinterpret_cast<bf16*>(smem + kBwdTcDy);
  bf16* sp = reinterpret_cast<bf16*>(smem + kBwdTcSp);   // S_prev: hi, mid, lo
  bf16* ds = reinterpret_cast<bf16*>(smem + kBwdTcDs);   // dS_end: hi, mid, lo
  double* cum = reinterpret_cast<double*>(smem + kBwdTcCum) + w * kTcChunk;
  float* ecum = reinterpret_cast<float*>(smem + kBwdTcEcum) + w * kTcChunk;
  float* erev = reinterpret_cast<float*>(smem + kBwdTcErev) + w * kTcChunk;
  float* din = reinterpret_cast<float*>(smem + kBwdTcDin) + w * kTcChunk;
  float* dto = reinterpret_cast<float*>(smem + kBwdTcDto) + w * kTcChunk;
  double* tok_e = reinterpret_cast<double*>(smem + kBwdTcTok);
  double* tok_q = tok_e + kTcChunk;
  float* tok_dir = reinterpret_cast<float*>(tok_q + kTcChunk);
  double* red = reinterpret_cast<double*>(smem + kBwdTcRed);

  // zeros in the ring and dy's tile once: their padding columns stay zero
  for (int i = tid; i < kBwdTcSp / 16; i += kBwdTcThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const bf16* planes = states + (static_cast<size_t>(b) * H + h) * n_chunks * 3 * kPlane;
  load_bwd_chunk<kVec>(smem + ((n_chunks - 1) & 1) * kBwdTcStage, x, dt, Bm, Cm, b, h,
                       (n_chunks - 1) * kTcChunk, S, H, P, N, tid);
  load_bwd_dy<kVec>(dys, dy, b, h, (n_chunks - 1) * kTcChunk, S, H, P, tid);

  // dS_end of the last chunk: the final state's gradient (or zero), rows
  // p = ra, rb, columns n = 8j + c2 (+1); between chunks it lives in the
  // three planes, exact to about 2^-24
  {
    float d[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + c2;
      float2 va = make_float2(0.f, 0.f), vb = va;
      if (dfinal != nullptr && n < N) {
        const float* f = dfinal + (static_cast<size_t>(b) * H + h) * P * N + n;
        if (ra < P) va = *reinterpret_cast<const float2*>(f + static_cast<size_t>(ra) * N);
        if (rb < P) vb = *reinterpret_cast<const float2*>(f + static_cast<size_t>(rb) * N);
      }
      d[j][0] = va.x;
      d[j][1] = va.y;
      d[j][2] = vb.x;
      d[j][3] = vb.y;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hi, mid, lo;
      split3(d[j][0], d[j][1], hi, mid, lo);
      *reinterpret_cast<uint32_t*>(ds + swz(ra, 8 * j + c2)) = hi;
      *reinterpret_cast<uint32_t*>(ds + kPlane + swz(ra, 8 * j + c2)) = mid;
      *reinterpret_cast<uint32_t*>(ds + 2 * kPlane + swz(ra, 8 * j + c2)) = lo;
      split3(d[j][2], d[j][3], hi, mid, lo);
      *reinterpret_cast<uint32_t*>(ds + swz(rb, 8 * j + c2)) = hi;
      *reinterpret_cast<uint32_t*>(ds + kPlane + swz(rb, 8 * j + c2)) = mid;
      *reinterpret_cast<uint32_t*>(ds + 2 * kPlane + swz(rb, 8 * j + c2)) = lo;
    }
  }
  double da_acc = 0.0;
  float dd_acc = 0.f;

  for (int ci = n_chunks - 1; ci >= lo_chunk; --ci) {
    const bool full = ci < full_end;   // else the adjoint alone
    const int t0 = ci * kTcChunk;
    const int nt = min(kTcChunk, S - t0);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    unsigned char* stage = smem + (ci & 1) * kBwdTcStage;
    const bf16* xs = reinterpret_cast<const bf16*>(stage);
    const bf16* bs = reinterpret_cast<const bf16*>(stage + kTile);
    const bf16* cs = reinterpret_cast<const bf16*>(stage + 2 * kTile);
    const float* dts = reinterpret_cast<const float*>(stage + 3 * kTile);
    cp_async_wait_all();
    __syncthreads();   // this chunk and dS_end have landed; the chunk after it is done with
    // S_prev, then the chunk before this one (empty groups where none)
    if (full) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        load_tile<true>(sp + i * kPlane, planes + (static_cast<size_t>(ci) * 3 + i) * kPlane,
                        kTcCols, kTcCols, kTcChunk, tid);
    }
    cp_async_commit();
    if (ci > lo_chunk)
      load_bwd_chunk<kVec>(smem + ((ci - 1) & 1) * kBwdTcStage, x, dt, Bm, Cm, b, h,
                           t0 - kTcChunk, S, H, P, N, tid);
    else
      cp_async_commit();

    // cum = cumsum(dt A) in f64 (the exponents are differences of it, to
    // 1e-7 however strong the decay), exp(cum), exp(total - cum), the decay
    // within a 16-token tile din_t = exp(cum_t - cum_{16 tile(t)}) and to
    // this warp's tile dto_u = exp(cum_{16w} - cum_u) (u < 16w): L[t,u]
    // across tiles is din_t exp(cum_{16 tile(t)} - cum_u), a product of two
    // factors <= 1, one exp for a tile's row instead of one per entry.
    // Each warp its own copy
    {
      const double a0 = static_cast<double>(dts[2 * lane]) * a_h;
      const double a1 = static_cast<double>(dts[2 * lane + 1]) * a_h;
      double incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const double total = __shfl_sync(0xffffffffu, incl, 31);
      const double c0 = incl - a1;
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = incl;
      ecum[2 * lane] = __expf(static_cast<float>(c0));
      ecum[2 * lane + 1] = __expf(static_cast<float>(incl));
      erev[2 * lane] = __expf(static_cast<float>(total - c0));
      erev[2 * lane + 1] = __expf(static_cast<float>(total - incl));
      const double tile0 = __shfl_sync(0xffffffffu, c0, lane & ~7);   // token 16 (lane / 8)
      const double mine = __shfl_sync(0xffffffffu, c0, 8 * w);       // token 16w
      din[2 * lane] = __expf(static_cast<float>(c0 - tile0));
      din[2 * lane + 1] = __expf(static_cast<float>(incl - tile0));
      dto[2 * lane] = 2 * lane < 16 * w ? __expf(static_cast<float>(mine - c0)) : 0.f;
      dto[2 * lane + 1] = 2 * lane + 1 < 16 * w ? __expf(static_cast<float>(mine - incl)) : 0.f;
    }
    __syncwarp();

    if (full) {
      const double cum_a = cum[ra], cum_b = cum[rb];
      const float dt_a = dts[ra], dt_b = dts[rb];
      const float w_a = dt_a * erev[ra], w_b = dt_b * erev[rb];

      // ---- rows u: G^T = B C^T and Y^T = X dY^T on the tiles t >= u
      float gt[8][4], yt[8][4];
      mma_rows_rows2(gt, bs, cs, yt, xs, dys, 16 * w, w, 3, lane);
      // direct_u = sum_{t>=u} T[t,u], cs_u = sum_{t>u} T[t,u] dt_u (f64: the
      // suffix sums below telescope it against rs) with T = G o Dyx o L; then
      // gt <- M^T = G^T L dt_u and yt <- W^T = Y^T L dt_u
      float dir_a = 0.f, dir_b = 0.f;
      double cs_a = 0.0, cs_b = 0.0;
      float to_a[4], to_b[4];   // exp(cum_{16jp} - cum_u) for the tiles jp past this warp's
#pragma unroll
      for (int jp = 1; jp < 4; ++jp) {
        to_a[jp] = jp > w ? __expf(static_cast<float>(cum[16 * jp] - cum_a)) : 0.f;
        to_b[jp] = jp > w ? __expf(static_cast<float>(cum[16 * jp] - cum_b)) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 2 * w) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb;
          const int t = 8 * j + c2 + (e & 1);
          const float L =
              j >= 2 * w + 2 ? din[t] * (e < 2 ? to_a[j / 2] : to_b[j / 2])
              : t >= row     ? __expf(static_cast<float>(cum[t] - (e < 2 ? cum_a : cum_b)))
                             : 0.f;
          const float tv = gt[j][e] * yt[j][e] * L;
          const float du = e < 2 ? dt_a : dt_b;
          if (e < 2) {
            dir_a += tv;
            if (t > row) cs_a += tv * du;
          } else {
            dir_b += tv;
            if (t > row) cs_b += tv * du;
          }
          gt[j][e] *= L * du;
          yt[j][e] *= L * du;
        }
      }
      dir_a = quad_sum(dir_a);
      dir_b = quad_sum(dir_b);
      cs_a = quad_sum(cs_a);
      cs_b = quad_sum(cs_b);

      // dX = w_u (B dS_end^T) + M^T dY + D dY, rounded once
      {
        float acc[8][4];
        zero_rows(acc);
        mma_rows_split<false, 2>(acc, bs, 16 * w, ds, lane);
        scale_rows(acc, w_a, w_b);
        mma_weights(acc, gt, w, 3, dys, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + c2;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int u = half ? rb : ra;
            const float2 yv = planes_at<1>(dys, u, p);
            const float v0 = fmaf(d_h, yv.x, acc[j][2 * half]);
            const float v1 = fmaf(d_h, yv.y, acc[j][2 * half + 1]);
            if (u < nt && p < P) {
              bf16* out = dx + ((row0 + u) * H + h) * P + p;
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

      // dB = w_u Z + W^T C with Z = X dS_end (dS_end in three parts: Z feeds
      // ddt); q'_u = exp(total - cum_u) Z_u . B_u
      float qp_a, qp_b;
      {
        float acc[8][4];
        zero_rows(acc);
        mma_rows_split<true, 3>(acc, xs, 16 * w, ds, lane);
        const float2 zb = rows_dot(acc, bs, ra, rb, c2);
        qp_a = erev[ra] * zb.x;
        qp_b = erev[rb] * zb.y;
        scale_rows(acc, w_a, w_b);
        mma_weights(acc, yt, w, 3, cs, lane);
        store_rows(db_part, acc, row0, h, H, N, nt, ra, rb, c2);
      }

      // ---- rows t: G = C B^T and Dyx = dY X^T on the tiles u <= t
      float gm[8][4], ym[8][4];
      mma_rows_rows2(gm, cs, bs, ym, dys, xs, 16 * w, 0, w, lane);
      // rs_t = sum_{u<t} G Dyx L dt_u (f64); dD gets the diagonal of Dyx;
      // ym <- W = Dyx L dt_u
      double rs_a = 0.0, rs_b = 0.0;
      const float din_a = din[ra], din_b = din[rb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j > 2 * w + 1) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb;
          const int u = 8 * j + c2 + (e & 1);
          const float L =
              j < 2 * w  ? (e < 2 ? din_a : din_b) * dto[u]
              : u <= row ? __expf(static_cast<float>((e < 2 ? cum_a : cum_b) - cum[u]))
                         : 0.f;
          const float wu = L * dts[u];
          if (u < row) {
            if (e < 2)
              rs_a += gm[j][e] * ym[j][e] * wu;
            else
              rs_b += gm[j][e] * ym[j][e] * wu;
          }
          if (u == row) dd_acc += ym[j][e];
          ym[j][e] *= wu;
        }
      }
      rs_a = quad_sum(rs_a);
      rs_b = quad_sum(rs_b);

      // S_prev has landed (the chunk before this one may still be in flight)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      __syncthreads();

      // dC = exp(cum_t) V + W B with V = dY S_prev; k_t = exp(cum_t) V_t . C_t
      float k_a, k_b;
      {
        float acc[8][4];
        zero_rows(acc);
        mma_rows_split<true, 3>(acc, dys, 16 * w, sp, lane);
        const float ea = ecum[ra], eb = ecum[rb];
        const float2 vc = rows_dot(acc, cs, ra, rb, c2);
        k_a = ea * vc.x;
        k_b = eb * vc.y;
        scale_rows(acc, ea, eb);
        mma_weights(acc, ym, 0, w, bs, lane);
        store_rows(dc_part, acc, row0, h, H, N, nt, ra, rb, c2);
      }
      if ((lane & 3) == 0) {
        tok_e[ra] = (k_a + rs_a) - cs_a;
        tok_e[rb] = (k_b + rs_b) - cs_b;
        tok_q[ra] = dt_a * qp_a;
        tok_q[rb] = dt_b * qp_b;
        tok_dir[ra] = dir_a + qp_a;
        tok_dir[rb] = dir_b + qp_b;
      }
    }

    // dS entering this chunk = exp(total) dS_end + (exp(cum) dY)^T C, this
    // warp's rows p: dS_end back from its planes, <dS_end, S_prev> on the
    // way; the A fragments come from dY by a transposed ldmatrix, scaled in
    // f32 and split into three parts in registers (this feeds ddt)
    float d[8][4];
    {
      const float decay = __expf(static_cast<float>(cum[kTcChunk - 1]));
      float s0 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + c2;
        const float2 va = planes_at<3>(ds, ra, n);
        const float2 vb = planes_at<3>(ds, rb, n);
        if (full) {
          const float2 sa = planes_at<3>(sp, ra, n);
          const float2 sb = planes_at<3>(sp, rb, n);
          s0 = fmaf(va.x, sa.x, fmaf(va.y, sa.y, fmaf(vb.x, sb.x, fmaf(vb.y, sb.y, s0))));
        }
        d[j][0] = decay * va.x;
        d[j][1] = decay * va.y;
        d[j][2] = decay * vb.x;
        d[j][3] = decay * vb.y;
      }
      s0 = warp_sum(s0);
      if (lane == 0) red[w] = s0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ya[4], ah[4], am[4], al[4];
        ldsm_x4_t(ya, dys + at_off(16 * kk, 16 * w, lane));
        // registers 0, 1 hold t = 16kk + c2 (+1), registers 2, 3 t + 8 (+1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 16 * kk + c2 + (i >> 1) * 8;
          const float2 yv = unpack(ya[i]);
          split3(yv.x * ecum[t], yv.y * ecum[t + 1], ah[i], am[i], al[i]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, cs + bt_off(16 * kk, 16 * jp, lane));
          mma(d[2 * jp], ah, bf[0], bf[1]);
          mma(d[2 * jp], am, bf[0], bf[1]);
          mma(d[2 * jp], al, bf[0], bf[1]);
          mma(d[2 * jp + 1], ah, bf[2], bf[3]);
          mma(d[2 * jp + 1], am, bf[2], bf[3]);
          mma(d[2 * jp + 1], al, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with dy, dS_end's and S_prev's planes and
                       // has written its e, q, direct and <dS_end, S_prev>
    if (ci > lo_chunk) load_bwd_dy<kVec>(dys, dy, b, h, t0 - kTcChunk, S, H, P, tid);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hi, mid, lo;
      split3(d[j][0], d[j][1], hi, mid, lo);
      *reinterpret_cast<uint32_t*>(ds + swz(ra, 8 * j + c2)) = hi;
      *reinterpret_cast<uint32_t*>(ds + kPlane + swz(ra, 8 * j + c2)) = mid;
      *reinterpret_cast<uint32_t*>(ds + 2 * kPlane + swz(ra, 8 * j + c2)) = lo;
      split3(d[j][2], d[j][3], hi, mid, lo);
      *reinterpret_cast<uint32_t*>(ds + swz(rb, 8 * j + c2)) = hi;
      *reinterpret_cast<uint32_t*>(ds + kPlane + swz(rb, 8 * j + c2)) = mid;
      *reinterpret_cast<uint32_t*>(ds + 2 * kPlane + swz(rb, 8 * j + c2)) = lo;
    }

    // ddt and dA: warp 0, lane l the tokens 2l, 2l + 1, in f64: dseg_v =
    // exp(total) <dS_end, S_prev> + sum_{u<v} q_u + sum_{t>=v} e_t
    if (full && w == 0) {
      const double s0 = static_cast<double>(__expf(static_cast<float>(cum[kTcChunk - 1]))) *
                        (red[0] + red[1] + red[2] + red[3]);
      const double e0 = tok_e[2 * lane], e1 = tok_e[2 * lane + 1];
      const double q0 = tok_q[2 * lane], q1 = tok_q[2 * lane + 1];
      double suf = e0 + e1, pre = q0 + q1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double vs = __shfl_down_sync(0xffffffffu, suf, o);
        const double vp = __shfl_up_sync(0xffffffffu, pre, o);
        if (lane + o < 32) suf += vs;
        if (lane >= o) pre += vp;
      }
      double after = __shfl_down_sync(0xffffffffu, suf, 1);
      double before = __shfl_up_sync(0xffffffffu, pre, 1);
      if (lane == 31) after = 0.0;
      if (lane == 0) before = 0.0;
      const double suf1 = e1 + after;
      const double dseg[2] = {s0 + before + (e0 + suf1), s0 + (before + q0) + suf1};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 2 * lane + i;
        if (t < nt) {
          ddt[(row0 + t) * H + h] = static_cast<float>(tok_dir[t] + a_h * dseg[i]);
          da_acc += dts[t] * dseg[i];
        }
      }
    }
  }

  // dA and dD of this (b, h): warp 0's and every warp's sums, in order
  const double da = warp_sum(da_acc);
  const float dd = warp_sum(dd_acc);
  __syncthreads();   // warp 0 is done with red
  if (lane == 0) red[w] = dd;
  __syncthreads();
  if (tid == 0) {
    da_part[part_bh] = static_cast<float>(da);
    dd_part[part_bh] = static_cast<float>(red[0] + red[1] + red[2] + red[3]);
  }
}

// floats of the backward's saved states: the f32 route saves a (64, 64)
// f32 state every 16 tokens, the bf16 route a (3, 64, 64) bf16 one every
// 64; the scratch holds the larger
size_t backward_states_floats(int B, int S, int H) {
  const size_t f32 = static_cast<size_t>((S + kBwdChunk - 1) / kBwdChunk) * kCols * kCols;
  const size_t bf16 = static_cast<size_t>((S + kTcChunk - 1) / kTcChunk) * 3 * kCols * kCols / 2;
  return static_cast<size_t>(B) * H * (f32 > bf16 ? f32 : bf16);
}

// floats of the backward's scratch: the saved states, then the per-head
// partials of dB and dC (B, S, H, N) and the partials of dA and dD (f32
// route: per row, (B, H); bf16: per part and row, (2, B, H))
size_t backward_work_floats(int B, int S, int H, int N) {
  return backward_states_floats(B, S, H) + 2 * static_cast<size_t>(B) * S * H * N +
         4 * static_cast<size_t>(B) * H;
}

// the partials' sums, one launch each (fixed order, no atomics): dB and
// dC over heads, dA and dD over `rows` partials a head
template <typename T>
cudaError_t launch_sums(const float* db_part, const float* dc_part, const float* da_part,
                        const float* dd_part, void* dBm, void* dCm, void* dA, void* dD, int B,
                        int S, int H, int N, int rows, cudaStream_t stream) {
  cudaError_t err;
  if ((err = launch_sum<T>(db_part, dBm, B * S, H, N, stream)) != cudaSuccess) return err;
  if ((err = launch_sum<T>(dc_part, dCm, B * S, H, N, stream)) != cudaSuccess) return err;
  if ((err = launch_sum<float>(da_part, dA, 1, rows, H, stream)) != cudaSuccess) return err;
  return launch_sum<float>(dd_part, dD, 1, rows, H, stream);
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* dy, const void* dfinal,
                            void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* dD,
                            void* work, int B, int S, int H, int P, int N, cudaStream_t stream) {
  float* ck = static_cast<float*>(work);
  float* db_part = ck + backward_states_floats(B, S, H);
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
  return launch_sums<T>(db_part, dc_part, da_part, dd_part, dBm, dCm, dA, dD, B, S, H, N, B,
                        stream);
}

// the bf16 route: the state sweep, the reverse sweep, the sums
cudaError_t launch_backward_tc(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* D, const void* dy,
                               const void* dfinal, void* dx, void* ddt, void* dA, void* dBm,
                               void* dCm, void* dD, void* work, int B, int S, int H, int P,
                               int N, cudaStream_t stream) {
  bf16* states = static_cast<bf16*>(work);
  float* db_part = static_cast<float*>(work) + backward_states_floats(B, S, H);
  float* dc_part = db_part + static_cast<size_t>(B) * S * H * N;
  float* da_part = dc_part + static_cast<size_t>(B) * S * H * N;
  float* dd_part = da_part + 2 * static_cast<size_t>(B) * H;
  const bool vec = P % 8 == 0 && aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                   aligned16(dy) && aligned16(dx);
  auto sweep = vec ? ssd_scan_tc_kernel<true, true> : ssd_scan_tc_kernel<false, true>;
  auto reverse = vec ? ssd_scan_bwd_tc_kernel<true> : ssd_scan_bwd_tc_kernel<false>;
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
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bm);
  const bf16* cb = static_cast<const bf16*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* df = static_cast<const float*>(D);
  sweep<<<dim3(H, B), kTcThreads, kTcSmemBytes, stream>>>(xb, dtf, af, bb, cb, df, nullptr,
                                                          nullptr, states, S, H, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reverse<<<dim3(H, B, 2), kBwdTcThreads, kBwdTcSmemBytes, stream>>>(
      xb, dtf, af, bb, cb, df, static_cast<const bf16*>(dy), static_cast<const float*>(dfinal),
      states, static_cast<bf16*>(dx), static_cast<float*>(ddt), db_part, dc_part, da_part,
      dd_part, S, H, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sums<bf16>(db_part, dc_part, da_part, dd_part, dBm, dCm, dA, dD, B, S, H, N,
                           2 * B, stream);
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees: f32 route
// {kThreads, kLanesPerRow, kMaxP, kMaxN, kTokens}, then bf16 route
// {kTcThreads, kTcChunk, kTcSmemBytes}, then the backward's f32 route
// {kBwdThreads, kBwdChunk, kBwdSmemBytes} and bf16 route {kBwdTcThreads,
// kBwdTcSmemBytes}.
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
  cfg[11] = kBwdTcThreads;
  cfg[12] = kBwdTcSmemBytes;
}

// The bf16 backward's reverse sweep as built and launched: out = {registers
// a thread, local (spilled) bytes a thread, blocks an SM at its shared
// memory}. Returns the first failing runtime call's error, or 0.
int ssd_scan_backward_occupancy(int* out) {
  const auto kernel = ssd_scan_bwd_tc_kernel<true>;
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
// (f32: one kernel; bf16: the state sweep and the reverse sweep) and the
// four sums on `stream`, returns cudaGetLastError() (0 on success); does
// not synchronise.
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
    return static_cast<int>(launch_backward_tc(x, dt, A, Bm, Cm, D, dy, dfinal, dx, ddt, dA,
                                               dBm, dCm, dD, work, B, S, H, P, N, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
