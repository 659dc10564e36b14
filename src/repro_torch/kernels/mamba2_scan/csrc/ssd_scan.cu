// Mamba2 SSD scan (selective state-space recurrence), forward only, for
// Hopper (sm_90a). x (B, S, H, P), Bm / Cm (B, S, 1, N) and y (B, S, H, P)
// of one type (f32 or bf16); dt (B, S, H), A (H,), D (H,) and the final
// state (B, H, P, N) in f32; all contiguous. The state and every sum are
// f32; y is rounded to the input type once.
//
// Replaces the TPU kernel in src/repro/kernels/mamba2_scan/kernel.py
// (ssd_scan_pallas and its body _kernel).
//
// Semantics, per (b, h), from a zero state:
//     S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T      (P, N)
//     y_t = S_t C_t + D_h x_t
// the same function as the TPU kernel's chunked form (which carries the
// state across chunks and rebuilds the within-chunk part from the decay
// L[t,u] = exp(cum_t - cum_u)); this kernel takes the recurrence token by
// token instead, so it needs no exponent of a difference at all.
//
// What bounds it on this card: bytes. At the zamba2-2.7b prefill shape
// (B 4, S 1024, H 80, P = N = 64) the function reads x, dt, B, C and
// writes y and the state once, about 91 MB, 0.027 ms at 3.35 TB/s; the
// chunked form's 10.7 GFLOP take 0.011 ms on the tensor cores. This first
// version spends a few CUDA-core instructions on every state element and
// token (1.3 G element updates at that shape), so instruction throughput,
// not memory, sets its time; the chunked tensor-core form is later work.
//
// What the design does:
//  * one block per (head, batch row); the TPU grid's sequential chunk axis
//    becomes a loop over the sequence inside the block, with the (P, N)
//    state in registers: 4 threads share row p, each holding 16 of its N
//    entries (n = 4 (q + 4 i) + c), so P <= 64 rows fill 256 threads;
//  * kTokens tokens of x, dt, exp(dt A), B and C are staged in shared
//    memory as f32 per pass, read back as float4 broadcasts free of bank
//    conflicts; y_t's sum over N reduces over the row's 4 lanes with
//    shuffles, and the pass's y tile is stored from shared memory in rows
//    of P contiguous values;
//  * the final state leaves the registers once, at the end.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* D, void* y, void* state, int B, int S,
                   int H, int P, int N, cudaStream_t stream) {
  const dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(D), static_cast<T*>(y), static_cast<float*>(state), S, H,
      P, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees:
// {kThreads, kLanesPerRow, kMaxP, kMaxN, kTokens}.
void ssd_scan_config(int* cfg) {
  cfg[0] = kThreads;
  cfg[1] = kLanesPerRow;
  cfg[2] = kMaxP;
  cfg[3] = kMaxN;
  cfg[4] = kTokens;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, S, H, P), Bm / Cm (B, S, 1, N), y (B, S, H, P) of one type:
// dtype 0 = float32, 1 = bfloat16; dt (B, S, H), A (H,), D (H,) and state
// (B, H, P, N) float32; all contiguous on the card, state 16-byte aligned.
// 1 <= P <= 64, N a multiple of 16 up to 64. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int ssd_scan_forward(const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, const void* D, void* y, void* state, int B, int S,
                     int H, int P, int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 16 || N > kMaxN ||
      N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, N, st));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, N, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
