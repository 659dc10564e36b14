// Blocked GQA attention with an online softmax for Hopper (sm_90a): the
// forward and, for training, its backward. q (B, Sq, H, D), k/v (B, Skv,
// KV, D), out (B, Sq, H, D), all contiguous and of one type (f32 or bf16);
// scores, softmax and the output sum in f32, rounded to the input type once
// at the end. On request the forward also writes each row's log-sum-exp of
// the scaled scores, lse (B, H, Sq) in f32, which the backward reads.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas and its body _kernel); the backward replaces
// what jax.grad compiles from src/repro/kernels/flash_attention/xla.py
// (attention_xla), as the Pallas kernel defines no VJP.
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
// Backward (training), three launches a call: delta = rowsum(dO o O), then
// dK/dV (one block per key tile and KV head, summing over the group's
// query heads) and dQ (one block per q tile and head); no atomics, so the
// gradients are bitwise deterministic. bf16 (the training path): wgmma fed
// by TMA, one producer and two consumer warpgroups rebalanced by
// setmaxnreg (24 / 240 registers), 128-key x 64-row tiles in dK/dV and
// the forward's 128-row x 128-key tiles in dQ. Bound by operations: five
// S^2 D products (2.5x the forward's), of which this design does seven
// (dQ recomputes S and dP), so its own floor is 7/5 of the bound. f32:
// CUDA cores, the f32 forward's 64 x 64 tiles. Details above each route.
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

// eight bf16 values (16 bytes) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
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
                           float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                           int D, int causal, float scale) {
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
    // a row with no visible key gets +inf, so the backward's p is 0
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
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
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int Sq, int Skv, int H, int KV, int D, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Skv, H, KV, D, causal, scale);
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
constexpr float kLn2 = 0.6931471805599453f;

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
// that outlasts ~2^34 cycles (seconds) stores through a null pointer: the
// launch fails (an illegal address) rather than hang the card. Not
// __trap(): with a trap in their code, ptxas holds the backward's consumer
// warpgroups to the block's 168 registers whatever setmaxnreg raises them
// to, and they spill.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1ll << 34))
      *reinterpret_cast<volatile int*>(0) = 1;
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

// The two consumer warpgroups take turns to start their products (named
// barriers 1 and 2): warpgroup 0's first, then 1's, and so on, so that
// one's softmax or exponentials run while the other's products are on the
// tensor cores. Each takes `n_turns` turns (empty ones for the tiles it
// skips); the first wait and the last arrival are left out so that the
// barriers balance.
struct Turns {
  int wg, n_turns, turn = 0;
  __device__ __forceinline__ void begin() {
    if (!(wg == 0 && turn == 0)) named_sync(1 + wg);
  }
  __device__ __forceinline__ void end() {
    if (!(wg == 1 && turn == n_turns - 1)) named_arrive(2 - wg);
    ++turn;
  }
  __device__ __forceinline__ void skip() {  // a tile this warpgroup does not compute
    begin(); end(); begin(); end();
  }
};

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
                                __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                                int Skv, int H, int KV, int D, int causal, float scale_log2) {
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

  // the warpgroups' turns: QK of warpgroup 0, QK of 1, PV of 0, PV of 1,
  // ..., two for every tile of the block
  Turns turns{wg, 2 * n_tiles};
  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles_w; ++t) {
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    turns.begin();
    issue_scores(t);
    turns.end();
    wg_wait_all();
    fence_regs(sc);
    softmax(t);
    rescale_and_pack();
    turns.begin();
    wg_fence();
    issue_pv(t);
    turns.end();
    wg_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
    mbar_arrive(&empty[t % kStages]);
  }
  // tiles this warpgroup's rows cannot see: released unread, in order
  for (int t = n_tiles_w; t < n_tiles; ++t) {
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    mbar_arrive(&empty[t % kStages]);
    turns.skip();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    // log-sum-exp of the scaled scores: the running max is a raw score
    const int row = r0 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && row < Sq)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
          l[r] > 0.f ? (m[r] * scale_log2 + log2f(l[r])) * kLn2 : INFINITY;
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

cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int Sq, int Skv, int H, int KV, int D, int causal, float scale,
                        cudaStream_t stream) {
  // the runtime call first: it makes the card's primary context current on
  // this thread, which cuTensorMapEncodeTiled below needs (a thread that has
  // made no runtime call has none; autograd runs the backward on its own)
  const size_t smem = sm90_smem_bytes(D);
  auto kernel = D <= 64 ? flash_attention_sm90_kernel<1> : flash_attention_sm90_kernel<2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_map(enc, &tq, q, D, H, Sq, B, 64) ||
      !encode_map(enc, &tk, k, D, KV, Skv, B, kWgBlockK) ||
      !encode_map(enc, &tv, v, D, KV, Skv, B, kWgBlockK))
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + kWgBlockQ - 1) / kWgBlockQ, H, B);
  kernel<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, Sq,
                                             Skv, H, KV, D, causal, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, f32 route: CUDA-core f32 FMAs on tiles staged as f32 in shared
// memory, the f32 forward's 64 x 64 tiles and 256 threads (each thread a
// 4 x 4 patch of a score tile and 4 rows x 8 columns of an output tile).
// (The bf16 route, below, runs the same passes with wgmma and TMA.)
//
// With P = exp(scale * Q K^T - lse) (masked entries 0) and dO the output's
// gradient:
//   delta = rowsum(dO o O)                     (preprocess, per query row)
//   dV    = P^T dO                              (dK/dV kernel)
//   dS    = P o (dO V^T - delta)
//   dK    = scale * dS^T Q                      (dK/dV kernel)
//   dQ    = scale * dS K                        (dQ kernel)
// dK and dV sum over the G query heads of their KV head inside one block,
// and dQ over the key tiles inside another: every output element is summed
// by one thread in a fixed order, so the gradients are deterministic (no
// atomics). P is recomputed from q, k and lse in both kernels.
//
// What bounds it on this card: operations. Its products are 2.5x the
// forward's (five S^2 D products against two; the recomputed Q K^T and
// dO V^T make seven). The f32 route does them in f32 FMAs at a fraction
// of the CUDA cores' rate (shared-memory loads: 16 for every 32 FMAs): f32
// is held to 2e-5, which the tensor cores' TF32 cannot meet, and no model
// path trains attention in f32 on the card. The bf16 route (the training
// path, at the end of this file) runs them on the tensor cores by wgmma.

constexpr int kBwdLd = kBlockQ + 1;  // row stride of a transposed tile (keys or q rows)
static_assert(kBlockQ == kBlockK, "the backward stages q and key tiles alike");

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], one half-warp per
// row (b, h, t), t < rows_pad (16 lanes of 8 columns cover D <= 128);
// rows past Sq get 0. With lse2 also lse2[b, h, t] = lse[b, h, t] * log2 e,
// +inf past Sq: the bf16 route pads both to a multiple of kRowPad rows, so
// that its producer copies whole tiles of them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                const float* __restrict__ lse, float* __restrict__ delta,
                                float* __restrict__ lse2, int B, int Sq, int rows_pad, int H,
                                int D) {
  const long long rows = static_cast<long long>(B) * H * rows_pad;
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 16) + threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  const int t = static_cast<int>(r % rows_pad);
  const long long bh = r / rows_pad;
  float acc = 0.f;
  if (r < rows && t < Sq && 8 * lane < D) {
    const size_t b = static_cast<size_t>(bh / H);
    const size_t at = ((b * Sq + t) * H + bh % H) * D + 8 * lane;  // rows of o are (b, t, h)
    float a[8], g[8];
    load8(o + at, a);
    load8(dout + at, g);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(a[j], g[j], acc);
  }
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (r < rows && lane == 0) {
    delta[r] = acc;
    if (lse2 != nullptr) lse2[r] = t < Sq ? lse[bh * Sq + t] * kLog2e : INFINITY;
  }
}

template <typename T>
cudaError_t launch_preprocess(const void* o, const void* dout, const float* lse, float* delta,
                              float* lse2, int B, int Sq, int rows_pad, int H, int D,
                              cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * rows_pad;
  const int per_block = kThreads / 16;
  flash_bwd_preprocess_kernel<T><<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                                   kThreads, 0, stream>>>(static_cast<const T*>(o),
                                                          static_cast<const T*>(dout), lse,
                                                          delta, lse2, B, Sq, rows_pad, H, D);
  return cudaGetLastError();
}

// `rows` rows of a (seq, heads, D) slab from row r0 into shared memory,
// zero past `limit`: row-major [row][D + 1], or transposed [d][kBwdLd]
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, size_t row_stride, int r0,
                                           int limit, int D) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < kBlockQ * chunks; i += kThreads) {
    const int r = i / chunks;
    const int d8 = (i % chunks) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < limit) load8(src + static_cast<size_t>(r0 + r) * row_stride + d8, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kTransposed)
        dst[(d8 + j) * kBwdLd + r] = x[j];
      else
        dst[r * (D + 1) + d8 + j] = x[j];
    }
  }
}

// One block per (64-key tile, KV head, batch row): dK and dV of the tile,
// summed over the G query heads of the KV head and the q tiles that the
// causal mask lets see the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                          int D, int causal, float scale) {
  extern __shared__ float smem[];
  const int ldr = D + 1;
  float* Ks = smem;                  // [kBlockK][ldr]
  float* Vs = Ks + kBlockK * ldr;    // [kBlockK][ldr]
  float* Qt = Vs + kBlockK * ldr;    // [D][kBwdLd], q rows as columns
  float* dOt = Qt + D * kBwdLd;      // [D][kBwdLd]
  float* Ps = dOt + D * kBwdLd;      // [kBlockK][kBwdLd], P^T of the pair of tiles
  float* dSs = Ps + kBlockK * kBwdLd;  // [kBlockK][kBwdLd], dS^T
  float* lse_s = dSs + kBlockK * kBwdLd;  // [kBlockQ]
  float* delta_s = lse_s + kBlockQ;       // [kBlockQ]

  const int k0 = blockIdx.x * kBlockK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // q columns tx + 16 j; output columns tx + 16 c
  const int ty = tid / 16;  // keys ty + 16 i
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;

  stage_tile<T, false>(Ks, k + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * D,
                       kv_stride, k0, Skv, D);
  stage_tile<T, false>(Vs, v + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * D,
                       kv_stride, k0, Skv, D);

  float dk_acc[kRows][kOutCols], dv_acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the first q tile with a row that sees key k0: row t sees k0 when t >= k0 - off
  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  const int first = causal && k0 - off > 0 ? (k0 - off) / kBlockQ : 0;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t head = static_cast<size_t>(h) * D;
    const T* qb = q + static_cast<size_t>(b) * Sq * q_stride + head;
    const T* gb = dout + static_cast<size_t>(b) * Sq * q_stride + head;
    const float* lse_b = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* delta_b = delta + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous pair's tiles are no longer read
      stage_tile<T, true>(Qt, qb, q_stride, q0, Sq, D);
      stage_tile<T, true>(dOt, gb, q_stride, q0, Sq, D);
      for (int i = tid; i < kBlockQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        lse_s[i] = in ? lse_b[q0 + i] : INFINITY;  // rows past Sq: p = 0
        delta_s[i] = in ? delta_b[q0 + i] : 0.f;
      }
      __syncthreads();

      float s[kRows][kRows], dp[kRows][kRows];  // [key][q row]
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kk[kRows], vv[kRows], qq[kRows], gg[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kk[i] = Ks[(ty + 16 * i) * ldr + d];
          vv[i] = Vs[(ty + 16 * i) * ldr + d];
          qq[i] = Qt[d * kBwdLd + tx + 16 * i];  // q row tx + 16 i
          gg[i] = dOt[d * kBwdLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int qi = tx + 16 * j;
          const bool visible = key < Skv && (!causal || key <= q0 + qi + off);
          const float p = visible ? expf(fmaf(s[i][j], scale, -lse_s[qi])) : 0.f;
          Ps[(ty + 16 * i) * kBwdLd + qi] = p;
          dSs[(ty + 16 * i) * kBwdLd + qi] = p * (dp[i][j] - delta_s[qi]);
        }
      }
      __syncthreads();

      for (int t = 0; t < kBlockQ; ++t) {
        float p[kRows], ds[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          p[i] = Ps[(ty + 16 * i) * kBwdLd + t];
          ds[i] = dSs[(ty + 16 * i) * kBwdLd + t];
        }
#pragma unroll
        for (int c = 0; c < kOutCols; ++c) {
          const int d = tx + 16 * c;
          if (d < D) {
            const float go = dOt[d * kBwdLd + t];
            const float qv = Qt[d * kBwdLd + t];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              dv_acc[i][c] = fmaf(p[i], go, dv_acc[i][c]);
              dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Skv) continue;
    const size_t at = (static_cast<size_t>(b) * Skv + key) * kv_stride + static_cast<size_t>(kvh) * D;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[at + d] = from_f32<T>(dk_acc[i][c] * scale);
        dv[at + d] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// One block per (64-row q tile, query head, batch row): dQ of the tile,
// summed over the key tiles its rows see. The q tiles with the most keys
// are launched first, as in the forward.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int Sq, int Skv, int H, int KV, int D, int causal,
                        float scale) {
  extern __shared__ float smem[];
  const int ldr = D + 1;
  float* Qs = smem;                  // [kBlockQ][ldr]
  float* dOs = Qs + kBlockQ * ldr;   // [kBlockQ][ldr]
  float* Kt = dOs + kBlockQ * ldr;   // [D][kBwdLd], keys as columns
  float* Vt = Kt + D * kBwdLd;       // [D][kBwdLd]
  float* dSs = Vt + D * kBwdLd;      // [kBlockQ][kBwdLd]

  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // keys tx + 16 j; output columns tx + 16 c
  const int ty = tid / 16;  // q rows ty + 16 i
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t qoff = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * D;

  stage_tile<T, false>(Qs, q + qoff, q_stride, q0, Sq, D);
  stage_tile<T, false>(dOs, dout + qoff, q_stride, q0, Sq, D);
  float lse_r[kRows], delta_r[kRows], dq_acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : INFINITY;  // rows past Sq: p = 0
    delta_r[i] = row < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) dq_acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + kBlockQ + off) : Skv;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's Kt / Vt / dSs are no longer read
    stage_tile<T, true>(Kt, kb, kv_stride, k0, Skv, D);
    stage_tile<T, true>(Vt, vb, kv_stride, k0, Skv, D);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qq[kRows], gg[kRows], kk[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qq[i] = Qs[(ty + 16 * i) * ldr + d];
        gg[i] = dOs[(ty + 16 * i) * ldr + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kk[j] = Kt[d * kBwdLd + tx + 16 * j];
        vv[j] = Vt[d * kBwdLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool visible = key < Skv && (!causal || key <= row + off);
        const float p = visible ? expf(fmaf(s[i][j], scale, -lse_r[i])) : 0.f;
        dSs[(ty + 16 * i) * kBwdLd + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < kBlockK; ++c0) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) ds[i] = dSs[(ty + 16 * i) * kBwdLd + c0];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float kv = Kt[d * kBwdLd + c0];
#pragma unroll
          for (int i = 0; i < kRows; ++i) dq_acc[i][c] = fmaf(ds[i], kv, dq_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = dq + qoff + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[d] = from_f32<T>(dq_acc[i][c] * scale);
    }
  }
}

size_t bwd_dkdv_smem_bytes(int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kBlockK) * (D + 1) +
                          2 * static_cast<size_t>(D) * kBwdLd +
                          2 * static_cast<size_t>(kBlockK) * kBwdLd + 2 * kBlockQ);
}

size_t bwd_dq_smem_bytes(int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kBlockQ) * (D + 1) +
                          2 * static_cast<size_t>(D) * kBwdLd +
                          static_cast<size_t>(kBlockQ) * kBwdLd);
}

template <typename T>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq, void* dk,
                            void* dv, int B, int Sq, int Skv, int H, int KV, int D, int causal,
                            float scale, cudaStream_t stream) {
  const size_t smem_kv = bwd_dkdv_smem_bytes(D);
  const size_t smem_q = bwd_dq_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  err = launch_preprocess<T>(o, dout, nullptr, delta, nullptr, B, Sq, Sq, H, D, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Skv + kBlockK - 1) / kBlockK, KV, B);
  flash_bwd_dkdv_kernel<T><<<grid_kv, kThreads, smem_kv, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KV, D,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_bwd_dq_kernel<T><<<grid_q, kThreads, smem_q, stream>>>(qp, kp, vp, gp, lse, delta,
                                                               static_cast<T*>(dq), Sq, Skv, H, KV,
                                                               D, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, bf16 route: wgmma fed by TMA, warp-specialised. The same three
// passes as the f32 route (preprocess, dK/dV, dQ), each block three
// warpgroups: warpgroup 2 the producer (one thread starts every TMA copy;
// setmaxnreg lowers the warpgroup to kProducerRegs registers a thread),
// warpgroups 0 and 1 the consumers (raised to kConsumerRegs: a dK/dV
// thread holds dK and dV, 128 f32, beside S^T and dP^T, 64; a dQ thread
// S, dP and dQ, 192). ptxas allots 168 registers a thread at entry, all
// that 384 threads of one block per SM may have, and builds the consumer
// code against 240: no spill at one or two atoms of D (chip_smoke.py
// prints -Xptxas -v; at 168 both kernels spilled and serialised their
// wgmma). The consumers' raise takes exactly what the producer gives
// back, so the launch refuses a build that allots fewer (the raise would
// wait forever). The two consumer warpgroups take turns to start their
// products (Turns, as the forward), so one's exponentials overlap the other's
// tensor-core work.
//
// dK/dV: one block per (128-key tile, KV head, batch row). K and V of the
// tile arrive once by TMA and stay; the producer streams the 64-row q and
// dO tiles of the G query heads, with their lse * log2 e and delta, into
// a ring of kBwdKvStages stages. Consumer warpgroup w owns keys 64 w ..
// 64 w + 63 of the tile; per q tile:
//   S^T = K Q^T, dP^T = V dO^T        wgmma m64n64k16, both operands K-major
//   P^T = 2^(S^T scale log2 e - lse log2 e)      (ex2.approx, f32)
//   dS^T = P^T o (dP^T - delta)                  (f32, from the unrounded P)
//   dV += P^T dO, dK += dS^T Q        wgmma m64n64k16 per 64 columns of D,
//                                     A (P^T, dS^T as bf16) from registers,
//                                     B with D contiguous (the forward's PV
//                                     layout)
// q tiles wholly above the diagonal are neither loaded nor computed; the
// mask runs only on the tiles the diagonal crosses.
//
// dQ: one block per (128 q rows, query head, batch row), the forward's
// geometry and order (the q tiles with the most keys first). q and dO
// arrive once; the producer streams 128-key K and V tiles through a ring
// of kBwdQStages stages. Consumer warpgroup w owns q rows 64 w .. 64 w +
// 63; per key tile: S = Q K^T and dP = dO V^T (wgmma m64n128k16, the
// forward's QK^T), dS = P o (dP - delta) as above, dQ += dS K (m64n64k16
// per 64 columns of D, K as the transposed B).
//
// Roundings: P and dS are rounded to bf16 once each, as the A operands;
// both kernels form dS from the unrounded f32 P, so dK and dQ read the
// same bf16 dS. Scores, exponentials and the sums stay f32; the gradients
// are rounded once on the way out (through shared memory, 16-byte
// coalesced stores). Rows past Sq and keys past Skv arrive as zeros (TMA
// fills them), their lse as +inf and delta as 0, so they add nothing.
//
// Products: seven S^2 D products where the bound counts five: the dQ
// kernel recomputes S and dP, which the dK/dV kernel has formed. Fusing
// dQ into the dK/dV kernel needs a sum across blocks: f32 atomics would
// make the gradients differ run to run, and blocks that wait on each
// other can hang (blocks run in no order). So the floor of this design is
// 7/5 of the operations bound. No atomics: every gradient element is
// summed in one block in a fixed order, so the results are bitwise
// deterministic.

constexpr int kBwdThreads = 384;      // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kBwdKeyTile = 128;      // keys of a dK/dV block
constexpr int kBwdQTile = 64;         // q rows of a streamed q / dO tile
constexpr int kBwdKvStages = 3;       // the dK/dV kernel's q / dO ring
constexpr int kBwdQStages = 2;        // the dQ kernel's K / V ring
constexpr int kRowPad = 64;           // lse * log2 e and delta rows padded to this
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing `bar`'s transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64): A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// 64 rows of NA 64-column accumulators (element i of atom a at row r0 +
// 8 ((i / 2) % 2), column 64 a + 8 (i / 4) + 2 (lane % 4) + i % 2, r0 =
// 16 * (warp % 4) + lane / 4), times `scale`, as bf16 into a warpgroup's
// 128-byte-swizzled rows (atom a at tile + a * atom_bytes; row r at byte
// r * 128), then from there to global rows row0 .. row0 + 63 below `limit`
// (row stride `row_stride` elements) in 16-byte coalesced stores. `bar` is
// a named barrier over the warpgroup's 128 threads.
template <int NA>
__device__ __forceinline__ void store_rows(const float (&acc)[NA][32], float scale,
                                           unsigned char* tile, int atom_bytes,
                                           __nv_bfloat16* out, size_t row_stride, int row0,
                                           int limit, int D, int bar) {
  const int lane = threadIdx.x % 32;
  const int lrow = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lrow + 8 * r;
        *reinterpret_cast<__nv_bfloat162*>(tile + a * atom_bytes + row * 128 +
                                           16 * (j ^ (row % 8)) + 4 * (lane % 4)) =
            __floats2bfloat162_rn(acc[a][4 * j + 2 * r] * scale, acc[a][4 * j + 2 * r + 1] * scale);
      }
  named_sync(bar, 128);
  const int chunks = D / 8;
  for (int i = threadIdx.x % 128; i < 64 * chunks; i += 128) {
    const int row = i / chunks;
    const int c = i % chunks;
    if (row0 + row < limit)
      *reinterpret_cast<uint4*>(out + (row0 + row) * row_stride + 8 * c) =
          *reinterpret_cast<const uint4*>(tile + (c / 8) * atom_bytes + row * 128 +
                                          16 * ((c % 8) ^ (row % 8)));
  }
}

// 32 f32 accumulators as bf16 A fragments of four k16 steps: columns 16 kk
// .. 16 kk + 15 are elements 8 kk .. 8 kk + 7
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// One block per (128-key tile, KV head, batch row); the key tiles with the
// most q rows first (blockIdx.z = 0 is keys 0 .. 127). NA as in the
// forward.
template <int NA>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse2, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               int Sq, int Skv, int H, int KV, int D, int causal, float scale,
                               float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = base;                                  // [NA] 128-row atoms
  unsigned char* Vs = Ks + NA * kKvAtomBytes;                // [NA]
  unsigned char* Qs = Vs + NA * kKvAtomBytes;                // [kBwdKvStages][NA] 64-row atoms
  unsigned char* Gs = Qs + kBwdKvStages * NA * kQAtomBytes;  // dO, the same
  float* Ls = reinterpret_cast<float*>(Gs + kBwdKvStages * NA * kQAtomBytes);  // [stage][64]
  float* Ds = Ls + kBwdKvStages * kBwdQTile;                                   // [stage][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ds + kBwdKvStages * kBwdQTile);
  uint64_t* empty = full + kBwdKvStages;
  uint64_t* kvbar = empty + kBwdKvStages;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBwdKeyTile;
  const int G = H / KV;
  const int off = Skv - Sq;
  const int rows_pad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  const int nq = (Sq + kBwdQTile - 1) / kBwdQTile;
  // the first q tile with a row that sees key k0 (row t sees k0 when t >= k0 - off)
  const int first = causal && k0 - off > 0 ? (k0 - off) / kBwdQTile : 0;
  const int per_head = nq - first;
  const int n_tiles = G * per_head;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdKvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // producer: K and V once, then the q / dO ring
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kvbar, 2 * NA * kKvAtomBytes);
      for (int a = 0; a < NA; ++a) {
        tma_load(Ks + a * kKvAtomBytes, &tm_k, kvbar, 64 * a, kvh, k0, b);
        tma_load(Vs + a * kKvAtomBytes, &tm_v, kvbar, 64 * a, kvh, k0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwdKvStages;
        const int h = kvh * G + t / per_head;
        const int q0 = (first + t % per_head) * kBwdQTile;
        if (t >= kBwdKvStages) mbar_wait(&empty[s], ((t / kBwdKvStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * NA * kQAtomBytes + 2 * kBwdQTile * 4);
        for (int a = 0; a < NA; ++a) {
          tma_load(Qs + (s * NA + a) * kQAtomBytes, &tm_q, &full[s], 64 * a, h, q0, b);
          tma_load(Gs + (s * NA + a) * kQAtomBytes, &tm_do, &full[s], 64 * a, h, q0, b);
        }
        const size_t row = (static_cast<size_t>(b) * H + h) * rows_pad + q0;
        bulk_load(Ls + s * kBwdQTile, lse2 + row, kBwdQTile * 4, &full[s]);
        bulk_load(Ds + s * kBwdQTile, delta + row, kBwdQTile * 4, &full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int kw0 = k0 + 64 * wg;                      // this warpgroup's first key
  const int first_w = causal && kw0 - off > 0 ? (kw0 - off) / kBwdQTile : 0;
  const int key0 = kw0 + 16 * (warp % 4) + lane / 4;  // this thread's keys: key0, key0 + 8
  const int c0 = 2 * (lane % 4);                     // its q columns: 8 j + c0, + 1
  const int ksteps = (D + 15) / 16;                   // zero-filled columns add nothing
  const uint32_t k_addr = smem_u32(Ks) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(Vs) + wg * 64 * 128;

  float dk_acc[NA][32], dv_acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[a][i] = dv_acc[a][i] = 0.f;
  float st[32], dpt[32];  // S^T, then P^T; dP^T, then dS^T
  uint32_t pa[4][4], da[4][4];

  Turns turns{wg, 2 * n_tiles};
  mbar_wait(kvbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kBwdKvStages;
    const int qt = first + t % per_head;
    mbar_wait(&full[s], (t / kBwdKvStages) & 1);
    if (qt < first_w) {  // every row of the tile is above this warpgroup's keys
      mbar_arrive(&empty[s]);
      turns.skip();
      continue;
    }
    const uint32_t q_addr = smem_u32(Qs + s * NA * kQAtomBytes);
    const uint32_t g_addr = smem_u32(Gs + s * NA * kQAtomBytes);
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    turns.begin();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      if (kk < ksteps) {  // 16 columns of D: atom kk / 4, 32 bytes into its rows
        const uint32_t at = (kk / 4) * kKvAtomBytes + (kk % 4) * 32;
        const uint32_t aq = (kk / 4) * kQAtomBytes + (kk % 4) * 32;
        wgmma_ss64(st, sw128_desc(k_addr + at), sw128_desc(q_addr + aq));
        wgmma_ss64(dpt, sw128_desc(v_addr + at), sw128_desc(g_addr + aq));
      }
    }
    wg_commit();
    turns.end();
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const int q0 = qt * kBwdQTile;
    // keys past Skv are zeros and their rows are never stored; they are
    // masked all the same, so that no non-finite value is formed
    const bool edge = (causal && kw0 + 63 > q0 + off) || kw0 + 64 > Skv;
    const float* ls = Ls + s * kBwdQTile;
    const float* dl = Ds + s * kBwdQTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + c0);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = exp2_approx(fmaf(st[i], scale_log2, -(e % 2 ? l2.y : l2.x)));
        if (edge) {
          const int key = key0 + 8 * (e / 2);
          const int row = q0 + 8 * j + c0 + e % 2;
          if (key >= Skv || (causal && key > row + off)) p = 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - (e % 2 ? d2.y : d2.x));
      }
    }
    pack_a(pa, st);
    pack_a(da, dpt);
    turns.begin();
    wg_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 q rows: 16 rows of 128 bytes into the atom
        wgmma_rs(dv_acc[a], pa[kk], sw128_desc(g_addr + a * kQAtomBytes + kk * 2048));
        wgmma_rs(dk_acc[a], da[kk], sw128_desc(q_addr + a * kQAtomBytes + kk * 2048));
      }
    wg_commit();
    turns.end();
    wg_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      fence_regs(dk_acc[a]);
      fence_regs(dv_acc[a]);
    }
    mbar_arrive(&empty[s]);
  }

  // out through this warpgroup's rows of the K and V tiles (no longer read)
  const size_t row_stride = static_cast<size_t>(KV) * D;
  const size_t at = static_cast<size_t>(b) * Skv * row_stride + static_cast<size_t>(kvh) * D;
  store_rows<NA>(dk_acc, scale, Ks + wg * 64 * 128, kKvAtomBytes, dk + at, row_stride, kw0, Skv,
                 D, 3 + wg);
  store_rows<NA>(dv_acc, 1.f, Vs + wg * 64 * 128, kKvAtomBytes, dv + at, row_stride, kw0, Skv, D,
                 3 + wg);
}

// One block per (128 q rows, query head, batch row): dQ of the rows. The
// q tiles with the most keys first (blockIdx.z = 0 is the last tile).
template <int NA>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse2, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KV, int D,
                             int causal, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;                                  // [2 warpgroups][NA] 64-row atoms
  unsigned char* Gs = Qs + 2 * NA * kQAtomBytes;             // dO, the same
  unsigned char* Ks = Gs + 2 * NA * kQAtomBytes;             // [kBwdQStages][NA] 128-row atoms
  unsigned char* Vs = Ks + kBwdQStages * NA * kKvAtomBytes;  // the same
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kBwdQStages * NA * kKvAtomBytes);
  uint64_t* empty = full + kBwdQStages;
  uint64_t* qbar = empty + kBwdQStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = (Sq + kWgBlockQ - 1) / kWgBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * kWgBlockQ;
  const int kvh = h / (H / KV);
  const int off = Skv - Sq;
  const int rows_pad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  // keys past the last visible one of the block's last row are never loaded
  const int kv_end = causal ? min(Skv, q0 + kWgBlockQ + off) : Skv;
  const int n_tiles = (kv_end + kWgBlockK - 1) / kWgBlockK;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdQStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // producer: q and dO once, then the K/V ring
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(qbar, 4 * NA * kQAtomBytes);
      for (int w = 0; w < 2; ++w)
        for (int a = 0; a < NA; ++a) {
          tma_load(Qs + (w * NA + a) * kQAtomBytes, &tm_q, qbar, 64 * a, h, q0 + 64 * w, b);
          tma_load(Gs + (w * NA + a) * kQAtomBytes, &tm_do, qbar, 64 * a, h, q0 + 64 * w, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwdQStages;
        if (t >= kBwdQStages) mbar_wait(&empty[s], ((t / kBwdQStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * NA * kKvAtomBytes);
        for (int a = 0; a < NA; ++a) {
          tma_load(Ks + (s * NA + a) * kKvAtomBytes, &tm_k, &full[s], 64 * a, kvh, t * kWgBlockK, b);
          tma_load(Vs + (s * NA + a) * kKvAtomBytes, &tm_v, &full[s], 64 * a, kvh, t * kWgBlockK, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int qw0 = q0 + 64 * wg;                  // this warpgroup's first row
  const int r0 = qw0 + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  // a warpgroup whose rows all lie past Sq has nothing to sum
  const int kv_end_w = qw0 >= Sq ? 0 : causal ? min(Skv, qw0 + 64 + off) : Skv;
  const int n_tiles_w = (kv_end_w + kWgBlockK - 1) / kWgBlockK;
  const int ksteps = (D + 15) / 16;
  const uint32_t q_addr = smem_u32(Qs + wg * NA * kQAtomBytes);
  const uint32_t g_addr = smem_u32(Gs + wg * NA * kQAtomBytes);

  float l2[2], dl[2];  // rows r0 and r0 + 8: lse * log2 e and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const size_t at = (static_cast<size_t>(b) * H + h) * rows_pad + row;
    l2[r] = row < Sq ? lse2[at] : INFINITY;
    dl[r] = row < Sq ? delta[at] : 0.f;
  }
  float dq_acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[a][i] = 0.f;
  float sc[64], dp[64];  // S, then P; dP, then dS
  uint32_t da[8][4];

  Turns turns{wg, 2 * n_tiles};
  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles_w; ++t) {
    const int s = t % kBwdQStages;
    mbar_wait(&full[s], (t / kBwdQStages) & 1);
    const uint32_t k_addr = smem_u32(Ks + s * NA * kKvAtomBytes);
    const uint32_t v_addr = smem_u32(Vs + s * NA * kKvAtomBytes);
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = dp[i] = 0.f;
    turns.begin();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      if (kk < ksteps) {
        const uint32_t aq = (kk / 4) * kQAtomBytes + (kk % 4) * 32;
        const uint32_t at = (kk / 4) * kKvAtomBytes + (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(q_addr + aq), sw128_desc(k_addr + at));
        wgmma_ss(dp, sw128_desc(g_addr + aq), sw128_desc(v_addr + at));
      }
    }
    wg_commit();
    turns.end();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = t * kWgBlockK;
    const bool edge = k0 + kWgBlockK > Skv || (causal && k0 + kWgBlockK - 1 > qw0 + off);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i / 2) % 2;
      float p = exp2_approx(fmaf(sc[i], scale_log2, -l2[r]));
      if (edge) {
        const int key = k0 + 8 * (i / 4) + c0 + i % 2;
        if (key >= Skv || (causal && key > r0 + 8 * r + off)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dl[r]);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) da[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
    turns.begin();
    wg_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)  // 16 keys: 16 rows of 128 bytes into the atom
        wgmma_rs(dq_acc[a], da[kk], sw128_desc(k_addr + a * kKvAtomBytes + kk * 2048));
    wg_commit();
    turns.end();
    wg_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(dq_acc[a]);
    mbar_arrive(&empty[s]);
  }
  // tiles this warpgroup's rows cannot see: released unread, in order
  for (int t = n_tiles_w; t < n_tiles; ++t) {
    mbar_wait(&full[t % kBwdQStages], (t / kBwdQStages) & 1);
    mbar_arrive(&empty[t % kBwdQStages]);
    turns.skip();
  }

  // out through this warpgroup's q tile (no longer read)
  const size_t row_stride = static_cast<size_t>(H) * D;
  store_rows<NA>(dq_acc, scale, Qs + wg * NA * kQAtomBytes, kQAtomBytes,
                 dq + static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * D,
                 row_stride, qw0, Sq, D, 3 + wg);
}

size_t bwd_dkdv_sm90_smem_bytes(int NA) {
  // alignment slack, K and V, the ring's q, dO, lse and delta, the mbarriers
  return 1024 + NA * 2 * kKvAtomBytes +
         kBwdKvStages * (NA * 2 * kQAtomBytes + 2 * kBwdQTile * sizeof(float)) +
         (2 * kBwdKvStages + 1) * sizeof(uint64_t);
}

size_t bwd_dq_sm90_smem_bytes(int NA) {
  // alignment slack, q and dO of both warpgroups, the K/V ring, the mbarriers
  return 1024 + NA * 4 * kQAtomBytes + kBwdQStages * NA * 2 * kKvAtomBytes +
         (2 * kBwdQStages + 1) * sizeof(uint64_t);
}

// The larger of the two backward blocks' shared memory at head dim D
size_t bwd_sm90_smem_bytes(int D) {
  const int NA = D <= 64 ? 1 : 2;
  const size_t a = bwd_dkdv_sm90_smem_bytes(NA);
  const size_t c = bwd_dq_sm90_smem_bytes(NA);
  return a > c ? a : c;
}

// Set a backward kernel's shared memory, and refuse (before any launch) a
// build whose register allotment leaves the consumers' setmaxnreg.inc
// short of what the producer's setmaxnreg.dec gives back
template <typename Kernel>
cudaError_t prepare_bwd(Kernel kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (kBwdThreads * attr.numRegs < 128 * kProducerRegs + (kBwdThreads - 128) * kConsumerRegs)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t launch_backward_sm90(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse, float* scratch, void* dq,
                                 void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
                                 int causal, float scale, cudaStream_t stream) {
  // the runtime calls first: cuTensorMapEncodeTiled needs the context they
  // make current on this thread (autograd calls from a thread of its own)
  const int NA = D <= 64 ? 1 : 2;
  auto dkdv = NA == 1 ? flash_bwd_dkdv_sm90_kernel<1> : flash_bwd_dkdv_sm90_kernel<2>;
  auto dqk = NA == 1 ? flash_bwd_dq_sm90_kernel<1> : flash_bwd_dq_sm90_kernel<2>;
  const size_t smem_kv = bwd_dkdv_sm90_smem_bytes(NA);
  const size_t smem_q = bwd_dq_sm90_smem_bytes(NA);
  cudaError_t err = prepare_bwd(dkdv, smem_kv);
  if (err != cudaSuccess) return err;
  err = prepare_bwd(dqk, smem_q);
  if (err != cudaSuccess) return err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tg, tk, tv;
  if (!encode_map(enc, &tq, q, D, H, Sq, B, kBwdQTile) ||
      !encode_map(enc, &tg, dout, D, H, Sq, B, kBwdQTile) ||
      !encode_map(enc, &tk, k, D, KV, Skv, B, kBwdKeyTile) ||
      !encode_map(enc, &tv, v, D, KV, Skv, B, kBwdKeyTile))
    return cudaErrorInvalidValue;

  using bf16 = __nv_bfloat16;
  const int rows_pad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  float* delta = scratch;
  float* lse2 = scratch + static_cast<size_t>(B) * H * rows_pad;
  err = launch_preprocess<bf16>(o, dout, lse, delta, lse2, B, Sq, rows_pad, H, D, stream);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  dkdv<<<dim3(KV, B, (Skv + kBwdKeyTile - 1) / kBwdKeyTile), kBwdThreads, smem_kv, stream>>>(
      tq, tk, tv, tg, lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, H, KV,
      D, causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3(H, B, (Sq + kWgBlockQ - 1) / kWgBlockQ), kBwdThreads, smem_q, stream>>>(
      tq, tk, tv, tg, lse2, delta, static_cast<bf16*>(dq), Sq, Skv, H, KV, D, causal, scale,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees: the f32 route's
// {kBlockQ, kBlockK, kThreads}, the bf16 route's {kWgBlockQ, kWgBlockK,
// kWgThreads, kStages}, then {kMaxHeadDim, kMaxSmemBytes}, then the bf16
// backward's {kBwdThreads, kProducerRegs, kConsumerRegs, kBwdKvStages,
// kBwdQStages} and its shared memory at kMaxHeadDim.
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
  cfg[9] = kBwdThreads;
  cfg[10] = kProducerRegs;
  cfg[11] = kConsumerRegs;
  cfg[12] = kBwdKvStages;
  cfg[13] = kBwdQStages;
  cfg[14] = static_cast<int>(bwd_sm90_smem_bytes(kMaxHeadDim));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Sq, H, D); k, v (B, Skv, KV, D); out (B, Sq, H, D); all contiguous,
// 16-byte aligned, of one type: dtype 0 = float32 (CUDA cores), 1 =
// bfloat16 (wgmma + TMA). lse (B, H, Sq) f32 receives each row's
// log-sum-exp of the scaled scores, or is null. Launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorNotSupported if the
// driver has no cuTensorMapEncodeTiled); does not synchronise.
int flash_attention_forward(const void* q, const void* k, const void* v, void* out, float* lse,
                            int B, int Sq, int Skv, int H, int KV, int D, int causal,
                            float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || D < 8 || D % 8 != 0 ||
      D > kMaxHeadDim || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && smem_bytes(D) <= static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(launch<float>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, causal, scale, st));
  if (dtype == 1 && sm90_smem_bytes(D) <= static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(launch_sm90(q, k, v, out, lse, B, Sq, Skv, H, KV, D, causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradients of the forward above: q, k, v, out as there, dout (B, Sq,
// H, D) the output's gradient, lse (B, H, Sq) the forward's; scratch is f32
// of 2 B H ceil(Sq / 64) * 64 elements (delta, and for bf16 lse * log2 e,
// padded); dq (B, Sq, H, D), dk and dv (B, Skv, KV, D) receive the
// gradients in the inputs' type. Three launches on `stream` (preprocess,
// dK/dV, dQ); returns the first non-zero CUDA error (bf16:
// cudaErrorInvalidConfiguration, and no launch, where the build's register
// allotment cannot feed the consumers' setmaxnreg); does not synchronise.
int flash_attention_backward(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const float* lse, float* scratch, void* dq,
                             void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
                             int causal, float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || D < 8 || D % 8 != 0 ||
      D > kMaxHeadDim || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto fits = [](size_t bytes) { return bytes <= static_cast<size_t>(kMaxSmemBytes); };
  if (dtype == 0 && fits(bwd_dkdv_smem_bytes(D)) && fits(bwd_dq_smem_bytes(D)))
    return static_cast<int>(launch_backward<float>(q, k, v, out, dout, lse, scratch, dq, dk, dv,
                                                   B, Sq, Skv, H, KV, D, causal, scale, st));
  if (dtype == 1 && fits(bwd_sm90_smem_bytes(D)))
    return static_cast<int>(launch_backward_sm90(q, k, v, out, dout, lse, scratch, dq, dk, dv, B,
                                                 Sq, Skv, H, KV, D, causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
