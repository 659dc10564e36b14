// Blocked GQA attention with an online softmax, forward only, for Hopper
// (sm_90a). q (B, Sq, H, D), k/v (B, Skv, KV, D), out (B, Sq, H, D), all
// contiguous and of one type (f32 or bf16); scores, softmax and the output
// sum in f32, rounded to the input type once at the end.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas and its body _kernel).
//
// Semantics (both routes): query head h reads KV head h / G (G = H / KV),
// the grouping of q.reshape(B, S, KV, G, D). With `causal`, key u is
// visible to query t when u <= t + (Skv - Sq): the mask is aligned
// bottom-right. Tiles wholly above the diagonal are never loaded; the q
// tiles with the most keys are launched first. Ragged Sq / Skv are masked;
// D is any multiple of 8 up to 128.
//
// What bounds it on this card: operations. At the prefill shape (Sq = Skv
// = 1024, D = 128) every K/V byte feeds 2 * 128 multiply-adds per q tile,
// far above the ridge point; the bound is the tensor cores' bf16 rate.
//
// Two routes, chosen by dtype:
//
// bf16 (the model path): tensor cores, fed by TMA.
//  * one block per (128 q rows, query head, batch row): two consumer
//    warpgroups of 64 q rows each and one producer warp (288 threads);
//  * the producer loads the q tile once and streams 128-key K/V tiles by
//    TMA (cp.async.bulk.tensor, 128-byte swizzle, completion on an
//    mbarrier) into a ring of kStages stages, kept ahead of the consumers;
//  * S = Q K^T by wgmma m64n128k16, both operands K-major in shared memory
//    (D is contiguous in q and k, so nothing is transposed);
//  * the online softmax runs on the f32 accumulator fragments: each row's
//    max reduces over the 4 lanes that share it, p = 2^(s * scale * log2 e
//    - max) on the special-function unit (ex2.approx), the row sums stay
//    per lane until the end and are taken from the unrounded f32 p;
//  * P is rounded to bf16 in registers and is wgmma's A operand from
//    registers for O += P V (m64n64k16 per 64 columns of D); V is the B
//    operand from shared memory with D contiguous (the transposed-B
//    layout); O stays f32 in registers and is rounded once, then leaves
//    through shared memory in 16-byte coalesced stores;
//  * the two warpgroups take turns to issue their products (named
//    barriers), so one's softmax overlaps the other's tensor-core work.
//    A warpgroup does not also overlap its own next QK^T with its softmax
//    (as FlashAttention-3 does): that keeps S, P and O live together, and
//    at the 168 registers a thread that ptxas allots this block (with or
//    without setmaxnreg) it spilled, serialised its wgmma and ran slower;
//  * D is laid out in 64-wide swizzle atoms (one TMA box each): D <= 64
//    takes one, 64 < D <= 128 two. TMA zero-fills the columns past D and
//    the rows past Sq / Skv. For D = 80 the PV product runs at N = 128 in
//    two n64 pieces, so 48 of 128 output columns (37.5 % of the PV
//    products, 19 % of all) are zeros that are never stored.
//
// f32: CUDA cores. tests/test_kernels.py holds f32 attention to 2e-5,
// which TF32 tensor cores (about 3 digits) cannot meet, so f32 keeps a
// CUDA-core kernel: one block per (64-row q tile, query head, batch row),
// q (pre-scaled), k (transposed) and v staged as f32 in shared memory,
// each thread owning a 4 x 4 patch of the score tile and 4 rows of the
// output; f32 FMAs throughout. No model path runs attention in f32 on the
// card.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block can have
constexpr int kRows = kBlockQ / 16;    // score rows per thread
constexpr int kCols = kBlockK / 16;    // score columns per thread
constexpr int kOutCols = kMaxHeadDim / 16;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Skv, int H, int KV, int D, int causal,
                           float scale) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  const int ldk = kBlockK + 1;
  const int ldp = kBlockK + 1;
  float* Qs = smem;                 // [kBlockQ][ldq], q * scale
  float* Kt = Qs + kBlockQ * ldq;   // [D][ldk], k transposed
  float* Vs = Kt + D * ldk;         // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;     // [kBlockQ][ldp], probabilities

  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Skv - Sq;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int chunks = D / 8;

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * D;

  for (int i = tid; i < kBlockQ * chunks; i += kThreads) {
    const int r = i / chunks;
    const int d8 = (i % chunks) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) load8(qb + static_cast<size_t>(q0 + r) * q_stride + d8, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) Qs[r * ldq + d8 + j] = x[j] * scale;
  }

  float m[kRows], l[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.f;
  }

  // keys past the last visible one of this tile's last row are never loaded
  const int kv_end = causal ? min(Skv, q0 + kBlockQ + q_offset) : Skv;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's Kt / Vs / Ps are no longer read
    for (int i = tid; i < kBlockK * chunks; i += kThreads) {
      const int c = i / chunks;
      const int d8 = (i % chunks) * 8;
      float kx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Skv) {
        load8(kb + static_cast<size_t>(k0 + c) * kv_stride + d8, kx);
        load8(vb + static_cast<size_t>(k0 + c) * kv_stride + d8, vx);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Kt[(d8 + j) * ldk + c] = kx[j];
        Vs[c * D + d8 + j] = vx[j];
      }
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = Kt[d * ldk + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool visible = col < Skv && (!causal || col <= row + q_offset);
        if (!visible) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - base);
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int oc = 0; oc < kOutCols; ++oc) {
        const int d = tx + 16 * oc;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][oc] = fmaf(p[i], vv, acc[i][oc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* ob = out + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int oc = 0; oc < kOutCols; ++oc) {
      const int d = tx + 16 * oc;
      if (d < D) ob[d] = from_f32<T>(acc[i][oc] * inv);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) *
         (static_cast<size_t>(kBlockQ) * (D + 1) + static_cast<size_t>(D) * (kBlockK + 1) +
          static_cast<size_t>(kBlockK) * D + static_cast<size_t>(kBlockQ) * (kBlockK + 1));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int Sq, int Skv, int H, int KV, int D, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KV, D, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma on tensor cores, K/V tiles by TMA into an mbarrier ring.

constexpr int kWgBlockQ = 128;                  // q rows per block
constexpr int kWgBlockK = 128;                  // keys per K/V tile
constexpr int kWgThreads = 288;                 // 2 consumer warpgroups + 1 producer warp
constexpr int kStages = 3;                      // K/V ring depth
constexpr int kQAtomBytes = 64 * 64 * 2;        // q box: 64 rows x 64 bf16 columns
constexpr int kKvAtomBytes = kWgBlockK * 64 * 2;  // k / v box: 128 rows x 64 columns
constexpr int kConsumerThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed. A wait
// that outlasts ~2^34 cycles (seconds) traps: a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D bf16 tensor (D, heads, seq, batch) into shared
// memory, completing `bar`'s transaction count; out-of-range elements are 0.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d0, int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(head), "r"(row),
      "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (rows of 128
// bytes, 1024-byte aligned atoms of 8 rows): start address, both byte
// offsets 1024 (the step from one 8-row group to the next, the only stride
// an m64n64k16 operand of this layout takes) and layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of `r` across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128): A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64):
// B in shared memory with its N (64) axis contiguous, the transposed layout.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Named barrier `id` over `threads` threads: wait for all of them, or
// arrive without waiting.
__device__ __forceinline__ void named_sync(int id, int threads = kConsumerThreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads = kConsumerThreads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One block per (128 q rows, query head, batch row). Warps 0-3 and 4-7 are
// the consumer warpgroups (q rows q0 .. q0 + 63 and q0 + 64 .. q0 + 127),
// warp 8 the producer. NA is the number of 64-wide D atoms (1 for D <= 64,
// 2 up to 128). Each consumer thread holds rows r0 and r0 + 8 of its
// warpgroup's fragments (r0 = 16 * warp + lane / 4); element i of a
// fragment lies at row r0 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
// 2 * (lane % 4) + i % 2.
template <int NA>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int KV,
                                int D, int causal, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles sit on 1024-byte boundaries of the shared window
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;                              // [2 warpgroups][NA] atoms
  unsigned char* Ks = Qs + 2 * NA * kQAtomBytes;         // [kStages][NA] atoms
  unsigned char* Vs = Ks + kStages * NA * kKvAtomBytes;  // [kStages][NA] atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * NA * kKvAtomBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int nq = (Sq + kWgBlockQ - 1) / kWgBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kWgBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Skv - Sq;
  // keys past the last visible one of the block's last row are never loaded
  const int kv_end = causal ? min(Skv, q0 + kWgBlockQ + off) : Skv;
  const int n_tiles = (kv_end + kWgBlockK - 1) / kWgBlockK;
  // the warp index through a shuffle, so that the compiler can treat it,
  // and the warpgroup's loop bounds drawn from it, as warp-uniform around
  // the wgmma issue (without it the kernel ran measurably slower)
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: q once, then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * NA * kQAtomBytes);
      for (int w = 0; w < 2; ++w)
        for (int a = 0; a < NA; ++a)
          tma_load(Qs + (w * NA + a) * kQAtomBytes, &tm_q, qbar, 64 * a, h, q0 + 64 * w, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * NA * kKvAtomBytes);
        for (int a = 0; a < NA; ++a) {
          tma_load(Ks + (s * NA + a) * kKvAtomBytes, &tm_k, &full[s], 64 * a, kvh, t * kWgBlockK, b);
          tma_load(Vs + (s * NA + a) * kKvAtomBytes, &tm_v, &full[s], 64 * a, kvh, t * kWgBlockK, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int qw0 = q0 + 64 * wg;                  // this warpgroup's first row
  const int r0 = qw0 + 16 * (warp % 4) + lane / 4;
  const int kv_end_w = causal ? min(Skv, qw0 + 64 + off) : Skv;
  const int n_tiles_w = (kv_end_w + kWgBlockK - 1) / kWgBlockK;
  const int ksteps = (D + 15) / 16;              // zero-filled columns add nothing
  const uint32_t q_addr = smem_u32(Qs + wg * NA * kQAtomBytes);

  float o[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum
  float sc[64];             // one tile's scores, then its probabilities
  uint32_t pa[8][4];        // the probabilities as bf16 A fragments
  float alpha[2];           // each row's rescale factor for the tile

  // S = Q K^T of tile t into sc: issued and committed, not waited for
  auto issue_scores = [&](int t) {
    const uint32_t k_addr = smem_u32(Ks + (t % kStages) * NA * kKvAtomBytes);
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      if (kk < ksteps) {  // 16 columns of D: atom kk / 4, 32 bytes into its rows
        wgmma_ss(sc, sw128_desc(q_addr + (kk / 4) * kQAtomBytes + (kk % 4) * 32),
                 sw128_desc(k_addr + (kk / 4) * kKvAtomBytes + (kk % 4) * 32));
      }
    }
    wg_commit();
  };
  // O += P V of tile t (P in pa): issued and committed, not waited for
  auto issue_pv = [&](int t) {
    const uint32_t v_addr = smem_u32(Vs + (t % kStages) * NA * kKvAtomBytes);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)  // 16 keys: 16 rows of 128 bytes into the atom
        wgmma_rs(o[a], pa[kk], sw128_desc(v_addr + a * kKvAtomBytes + kk * 2048));
    wg_commit();
  };
  // online softmax of tile t's scores (complete in sc): masks, the running
  // max and sum, sc becomes the probabilities and alpha the rescale factor
  auto softmax = [&](int t) {
    const int k0 = t * kWgBlockK;
    const bool edge = k0 + kWgBlockK > Skv || (causal && k0 + kWgBlockK - 1 > qw0 + off);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = r0 + 8 * ((i / 2) % 2);
        if (col >= Skv || (causal && col > row + off)) sc[i] = -INFINITY;
      }
    }
    // each row's max and sum in four independent chains (i / 4 % 4)
    float mx4[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx4[r][c] = m[r];
#pragma unroll
    for (int i = 0; i < 64; ++i) mx4[(i / 2) % 2][(i / 4) % 4] = fmaxf(mx4[(i / 2) % 2][(i / 4) % 4], sc[i]);
    float mx[2], base_[2];  // the running max; base_ in log2 units (scores are raw)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base_[r] = (mx[r] == -INFINITY ? 0.f : mx[r]) * scale_log2;
      alpha[r] = exp2_approx(m[r] * scale_log2 - base_[r]);
      m[r] = mx[r];
    }
    float l4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -base_[(i / 2) % 2]));
      l4[(i / 2) % 2][(i / 4) % 4] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], (l4[r][0] + l4[r][1]) + (l4[r][2] + l4[r][3]));
  };
  // O *= alpha, then P as bf16 A fragments: keys 16 kk .. 16 kk + 15 of
  // the tile are accumulator elements 8 kk .. 8 kk + 7
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
  };

  // The two warpgroups take turns to issue their products
  // (named barriers 1 and 2): QK of warpgroup 0, QK of 1, PV of 0, PV of
  // 1, ..., so one's softmax runs while the other's products are on the
  // tensor cores. Each takes 2 turns per tile of the block (empty ones for
  // the tiles it skips); the first and the last wait are left out so the
  // barriers balance.
  const int n_turns = 2 * n_tiles;
  int turn = 0;
  auto turn_begin = [&]() {
    if (!(wg == 0 && turn == 0)) named_sync(1 + wg);
  };
  auto turn_end = [&]() {
    if (!(wg == 1 && turn == n_turns - 1)) named_arrive(2 - wg);
    ++turn;
  };

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles_w; ++t) {
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    turn_begin();
    issue_scores(t);
    turn_end();
    wg_wait_all();
    fence_regs(sc);
    softmax(t);
    rescale_and_pack();
    turn_begin();
    wg_fence();
    issue_pv(t);
    turn_end();
    wg_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
    mbar_arrive(&empty[t % kStages]);
  }
  // tiles this warpgroup's rows cannot see: released unread, in order
  for (int t = n_tiles_w; t < n_tiles; ++t) {
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    mbar_arrive(&empty[t % kStages]);
    turn_begin();
    turn_end();
    turn_begin();
    turn_end();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  // O goes out through this warpgroup's q tile (no longer read) in the
  // same 128-byte-swizzled atoms, so that the global stores are 16-byte
  // and coalesced: element (row, col) at atom col / 64, row * 128 + 16 *
  // ((col % 64 / 8) ^ (row % 8)) + 2 * (col % 8) bytes
  unsigned char* Os = Qs + wg * NA * kQAtomBytes;
  const int lrow = 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lrow + 8 * r;
        *reinterpret_cast<__nv_bfloat162*>(Os + a * kQAtomBytes + row * 128 +
                                           16 * (j ^ (row % 8)) + 4 * (lane % 4)) =
            __floats2bfloat162_rn(o[a][4 * j + 2 * r] * inv[r], o[a][4 * j + 2 * r + 1] * inv[r]);
      }
  named_sync(3 + wg, 128);  // this warpgroup's tile is complete
  const size_t row_stride = static_cast<size_t>(H) * D;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * D;
  const int chunks = D / 8;
  for (int i = threadIdx.x % 128; i < 64 * chunks; i += 128) {
    const int row = i / chunks;
    const int c = i % chunks;
    if (qw0 + row < Sq)
      *reinterpret_cast<uint4*>(ob + (qw0 + row) * row_stride + 8 * c) =
          *reinterpret_cast<const uint4*>(Os + (c / 8) * kQAtomBytes + row * 128 +
                                          16 * ((c % 8) ^ (row % 8)));
  }
}

size_t sm90_smem_bytes(int D) {
  const size_t atoms = D <= 64 ? 1 : 2;
  // 1024 of alignment slack, q, the K/V ring, 2 * kStages + 1 mbarriers
  return 1024 + atoms * (2 * kQAtomBytes + 2 * kStages * kKvAtomBytes) +
         (2 * kStages + 1) * sizeof(uint64_t);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A contiguous bf16 (batch, seq, heads, D) tensor as 4-D (D, heads, seq,
// batch), cut in boxes of 64 D columns of one head by `rows` positions,
// 128-byte swizzled; out-of-range elements read as zeros. The map holds
// the tensor's address, so it is encoded on every call.
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D, int heads, int seq,
                int batch, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Skv, int H, int KV, int D, int causal, float scale,
                        cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_map(enc, &tq, q, D, H, Sq, B, 64) ||
      !encode_map(enc, &tk, k, D, KV, Skv, B, kWgBlockK) ||
      !encode_map(enc, &tv, v, D, KV, Skv, B, kWgBlockK))
    return cudaErrorInvalidValue;
  const size_t smem = sm90_smem_bytes(D);
  auto kernel = D <= 64 ? flash_attention_sm90_kernel<1> : flash_attention_sm90_kernel<2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kWgBlockQ - 1) / kWgBlockQ, H, B);
  kernel<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Skv,
                                             H, KV, D, causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees: the f32 route's
// {kBlockQ, kBlockK, kThreads}, the bf16 route's {kWgBlockQ, kWgBlockK,
// kWgThreads, kStages}, then {kMaxHeadDim, kMaxSmemBytes}.
void flash_attention_config(int* cfg) {
  cfg[0] = kBlockQ;
  cfg[1] = kBlockK;
  cfg[2] = kThreads;
  cfg[3] = kWgBlockQ;
  cfg[4] = kWgBlockK;
  cfg[5] = kWgThreads;
  cfg[6] = kStages;
  cfg[7] = kMaxHeadDim;
  cfg[8] = kMaxSmemBytes;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Sq, H, D); k, v (B, Skv, KV, D); out (B, Sq, H, D); all contiguous,
// 16-byte aligned, of one type: dtype 0 = float32 (CUDA cores), 1 =
// bfloat16 (wgmma + TMA). Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorNotSupported if the driver
// has no cuTensorMapEncodeTiled); does not synchronise.
int flash_attention_forward(const void* q, const void* k, const void* v, void* out,
                            int B, int Sq, int Skv, int H, int KV, int D, int causal,
                            float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || D < 8 || D % 8 != 0 ||
      D > kMaxHeadDim || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && smem_bytes(D) <= static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(launch<float>(q, k, v, out, B, Sq, Skv, H, KV, D, causal, scale, st));
  if (dtype == 1 && sm90_smem_bytes(D) <= static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(launch_sm90(q, k, v, out, B, Sq, Skv, H, KV, D, causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
