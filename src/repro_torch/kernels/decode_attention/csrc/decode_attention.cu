// Single-token GQA decode attention against a KV cache, for Hopper
// (sm_90a). q (B, H, D), caches (B, S, KV, D), lengths (B,) int32, out
// (B, H, D); q, caches and out contiguous and of one type (f32 or bf16);
// scores, softmax and the output sum in f32, rounded to the input type once
// at the end.
//
// Replaces the TPU kernel in src/repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas and its body _kernel).
//
// What bounds it on this card: bytes. Each valid cache entry is read once
// and feeds G = H / KV multiply-adds per element, far below the ridge
// point, so the least time is the valid K/V bytes over the memory rate.
//
// What the design does:
//  * one block per (KV head, batch row): it serves all G query heads of the
//    group from one pass over the cache, so each K/V byte is read once;
//  * the TPU grid's sequential cache axis becomes a loop over 64-slot tiles
//    inside the block; tiles from lengths[b] onward are never loaded, and
//    slots past lengths[b] inside the last tile are masked to -inf;
//  * K and V tiles are staged in shared memory as f32 with 16-byte global
//    loads (K rows padded so the per-slot dot products are free of bank
//    conflicts); the running max, sum and rescale factor of each query head
//    live in shared memory, its output sum in registers;
//  * a length above S counts as S; a row of length 0 writes zeros.
//
// Known underfill: at the serving shape (8 slots x 8 KV heads) the grid is
// 64 blocks on 132 SMs. Splitting the cache over more blocks (split-KV
// flash-decoding) is the later fix.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGroup = 16;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block can have
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = kMaxGroup * kMaxHeadDim / kThreads;  // outputs per thread

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc, const int* __restrict__ lengths,
                            T* __restrict__ out, int S, int H, int KV, int D,
                            float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int ldk = D + 1;
  float* Qs = smem;                  // [G][D]
  float* Ks = Qs + G * D;            // [kBlockK][ldk]
  float* Vs = Ks + kBlockK * ldk;    // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;      // [G][kBlockK], scores then probabilities
  float* Ms = Ps + G * kBlockK;      // [G] running max
  float* Ls = Ms + G;                // [G] running sum
  float* As = Ls + G;                // [G] this tile's rescale factor

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int chunks = D / 8;
  const int len = min(max(lengths[b], 0), S);

  const size_t row_stride = static_cast<size_t>(KV) * D;
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * D;
  const T* kb = kc + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * D;
  const T* vb = vc + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * D;

  for (int i = tid; i < G * chunks; i += kThreads) {
    float x[8];
    load8(qb + static_cast<size_t>(i) * 8, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) Qs[i * 8 + j] = x[j];
  }
  if (tid < G) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  __syncthreads();

  const int n_tiles = (len + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    for (int i = tid; i < kBlockK * chunks; i += kThreads) {
      const int c = i / chunks;
      const int d8 = (i % chunks) * 8;
      float kx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + c < len) {
        load8(kb + static_cast<size_t>(k0 + c) * row_stride + d8, kx);
        load8(vb + static_cast<size_t>(k0 + c) * row_stride + d8, vx);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Ks[c * ldk + d8 + j] = kx[j];
        Vs[c * D + d8 + j] = vx[j];
      }
    }
    __syncthreads();

    for (int e = tid; e < G * kBlockK; e += kThreads) {
      const int g = e / kBlockK;
      const int c = e % kBlockK;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[g * D + d], Ks[c * ldk + d], s);
      Ps[e] = k0 + c < len ? s * scale : -INFINITY;
    }
    __syncthreads();

    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int g = warp; g < G; g += kWarps) {
      const float x0 = Ps[g * kBlockK + lane];
      const float x1 = Ps[g * kBlockK + lane + 32];
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(x0 - base);
      const float p1 = expf(x1 - base);
      Ps[g * kBlockK + lane] = p0;
      Ps[g * kBlockK + lane + 32] = p1;
      const float rs = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - base);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + rs;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int e = tid + a * kThreads;
      if (e < G * D) {
        const int g = e / D;
        const int d = e % D;
        float o = acc[a] * As[g];
        for (int c = 0; c < kBlockK; ++c) o = fmaf(Ps[g * kBlockK + c], Vs[c * D + d], o);
        acc[a] = o;
      }
    }
    __syncthreads();  // Ks / Vs / Ps are rewritten by the next tile
  }

  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * D;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int e = tid + a * kThreads;
    if (e < G * D) {
      const float l = Ls[e / D];
      ob[e] = from_f32<T>(l > 0.f ? acc[a] / l : 0.f);
    }
  }
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * (static_cast<size_t>(G) * D + static_cast<size_t>(kBlockK) * (D + 1) +
                          static_cast<size_t>(kBlockK) * D + static_cast<size_t>(G) * kBlockK +
                          3 * static_cast<size_t>(G));
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* lengths,
                   void* out, int B, int S, int H, int KV, int D, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, D);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, H, KV, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees:
// {kBlockK, kThreads, kMaxHeadDim, kMaxGroup, kMaxSmemBytes}.
void decode_attention_config(int* cfg) {
  cfg[0] = kBlockK;
  cfg[1] = kThreads;
  cfg[2] = kMaxHeadDim;
  cfg[3] = kMaxGroup;
  cfg[4] = kMaxSmemBytes;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, H, D); k_cache, v_cache (B, S, KV, D); lengths (B,) int32 on the
// card; out (B, H, D); all contiguous, 16-byte aligned, q / caches / out of
// one type: dtype 0 = float32, 1 = bfloat16. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int decode_attention_forward(const void* q, const void* kc, const void* vc,
                             const void* lengths, void* out, int B, int S, int H, int KV,
                             int D, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxGroup || D < 8 ||
      D % 8 != 0 || D > kMaxHeadDim ||
      smem_bytes(H / KV, D) > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, kc, vc, lengths, out, B, S, H, KV, D, scale, st));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(q, kc, vc, lengths, out, B, S, H, KV, D, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
