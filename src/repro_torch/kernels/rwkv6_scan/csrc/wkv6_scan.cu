// RWKV6 (Finch) WKV scan with a data-dependent per-channel decay, forward
// only, for Hopper (sm_90a). r, k (B, S, H, K), v and y (B, S, H, V) of one
// type (f32 or bf16); the decay w (B, S, H, K), the bonus u (H, K) and the
// final state (B, H, K, V) in f32; all contiguous. The state and every sum
// are f32; y is rounded to the input type once.
//
// Replaces the TPU kernel in src/repro/kernels/rwkv6_scan/kernel.py
// (wkv6_scan_pallas and its body _kernel).
//
// Semantics, per (b, h), from a zero state:
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T                 (K, V)
// the same function as the TPU kernel's chunked form, which rebuilds the
// within-chunk part from the masked decay exp(cum_excl[t] - cum[u]) in a
// (chunk, chunk, K) f32 tile: 256 KiB at chunk 32 and K 64, more than the
// 227 KB a block can hold here. This kernel takes the recurrence token by
// token instead and multiplies by w_t directly: exact for any decay in
// (0, 1), with no exponent, no logarithm and no clamp.
//
// What bounds it on this card: bytes. At the rwkv6-7b prefill shape (B 4,
// S 1024, H 64, K = V = 64) the function reads r, k, v (bf16) and w (f32)
// and writes y and the state once, about 206 MB, 0.061 ms at 3.35 TB/s.
// This first version spends a few CUDA-core instructions on every state
// element and token (1.1 G element updates at that shape), so instruction
// throughput, not memory, sets its time; a chunked tensor-core form is later
// work.
//
// What the design does:
//  * one block per (head, batch row); the TPU grid's sequential chunk axis
//    becomes a loop over the sequence inside the block, with the (K, V)
//    state in registers: 4 threads share value column j, each holding 16
//    of its K entries (k = 4 (q + 4 i) + c) and the matching 16 entries of
//    u, so V <= 64 columns fill 256 threads;
//  * kTokens tokens of r, k, w and v are staged in shared memory as f32 per
//    pass, read back as float4 broadcasts free of bank conflicts; y_t's sum
//    over K reduces over the column's 4 lanes with shuffles, and the pass's
//    y tile is stored from shared memory in rows of V contiguous values;
//  * the final state leaves the registers once, at the end.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* y, void* state, int B, int S, int H, int K, int V,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(state), S, H, K, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees:
// {kThreads, kLanesPerCol, kMaxK, kMaxV, kTokens}.
void wkv6_scan_config(int* cfg) {
  cfg[0] = kThreads;
  cfg[1] = kLanesPerCol;
  cfg[2] = kMaxK;
  cfg[3] = kMaxV;
  cfg[4] = kTokens;
}

const char* wkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k (B, S, H, K), v and y (B, S, H, V) of one type: dtype 0 = float32,
// 1 = bfloat16; w (B, S, H, K), u (H, K) and state (B, H, K, V) float32;
// all contiguous on the card. K a multiple of 16 up to 64, 1 <= V <= 64.
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
int wkv6_scan_forward(const void* r, const void* k, const void* v, const void* w,
                      const void* u, void* y, void* state, int B, int S, int H, int K,
                      int V, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 16 || K > kMaxK || K % 16 != 0 || V < 1 ||
      V > kMaxV)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(r, k, v, w, u, y, state, B, S, H, K, V, st));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(r, k, v, w, u, y, state, B, S, H, K, V, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
