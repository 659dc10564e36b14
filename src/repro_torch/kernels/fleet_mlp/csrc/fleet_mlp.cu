// Fleet-batched MLP forward for Hopper (sm_90a): N independent MLPs, each
// with its own weights, in one launch. ReLU between layers, linear last
// layer, f32 accumulation, output rounded to the input type at the end.
//
// Replaces the TPU kernel in src/repro/kernels/fleet_mlp/kernel.py
// (fleet_mlp_pallas and its body _kernel).
//
// What bounds it on this card: weight bytes. On the scoring path b = 1, so
// each weight feeds one multiply-add: 2 FLOP per 4 bytes in f32, far below
// the card's ridge point. The launch can be no faster than streaming every
// instance's sum_i F_i * F_{i+1} weights from device memory once.
//
// What the design does about it:
//  * one block per instance (grid = N), so a ragged N needs no padding;
//  * each weight is read from device memory once per launch (once per
//    block of kRowBlock rows when b > kRowBlock);
//  * the activations never leave shared memory: two f32 buffers of
//    b x (widest layer) ping-pong between layers;
//  * threads own output columns and walk the rows of W_i, stored
//    (N, F_in, F_out) row-major, so neighbouring threads read neighbouring
//    addresses;
//  * a layer narrower than half the block (the width-1 output layer above
//    all) splits each dot product over S (a power of two) groups of threads
//    and sums the partials with a tree in shared memory.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxDepth = 8;
constexpr int kThreads = 256;
constexpr int kRowBlock = 4;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block can have

struct FleetMlpLayers {
  const void* w[kMaxDepth];
  const void* b[kMaxDepth];
  int width[kMaxDepth + 1];
  int depth;
  int ld;  // row stride of the activation buffers: the widest layer
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fleet_mlp_kernel(const T* __restrict__ x, FleetMlpLayers L, int rows,
                     T* __restrict__ out) {
  extern __shared__ float smem[];
  const int ld = L.ld;
  float* cur = smem;
  float* nxt = smem + rows * ld;
  float* red = smem + 2 * rows * ld;  // kRowBlock * kThreads partial sums
  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;

  const int f0 = L.width[0];
  const T* xn = x + n * rows * f0;
  for (int i = tid; i < rows * f0; i += kThreads)
    cur[(i / f0) * ld + i % f0] = to_f32(xn[i]);
  __syncthreads();

  for (int l = 0; l < L.depth; ++l) {
    const int fin = L.width[l];
    const int fout = L.width[l + 1];
    const bool last = l == L.depth - 1;
    const T* __restrict__ W =
        static_cast<const T*>(L.w[l]) + n * static_cast<size_t>(fin) * fout;
    const T* __restrict__ B = static_cast<const T*>(L.b[l]) + n * fout;
    // S groups of fout threads share each column's dot product; every
    // quantity below is the same for the whole block, so the barriers
    // inside the loops are reached by every thread.
    int S = 1;
    while (2 * S * fout <= kThreads) S *= 2;
    const int span = S == 1 ? kThreads : fout;  // columns per pass
    const int s = tid / span;
    const int col = tid % span;
    for (int c0 = 0; c0 < fout; c0 += span) {
      const int c = c0 + col;
      const bool active = s < S && c < fout;
      for (int r0 = 0; r0 < rows; r0 += kRowBlock) {
        float acc[kRowBlock];
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r) acc[r] = 0.f;
        if (active) {
          const T* wc = W + c;
#pragma unroll 4
          for (int k = s; k < fin; k += S) {
            const float w = to_f32(wc[static_cast<size_t>(k) * fout]);
#pragma unroll
            for (int r = 0; r < kRowBlock; ++r)
              if (r0 + r < rows)
                acc[r] = fmaf(cur[(r0 + r) * ld + k], w, acc[r]);
          }
        }
        if (S > 1) {
          if (active) {
#pragma unroll
            for (int r = 0; r < kRowBlock; ++r)
              red[(r * S + s) * fout + c] = acc[r];
          }
          __syncthreads();
          for (int st = S / 2; st > 0; st /= 2) {
            if (active && s < st) {
#pragma unroll
              for (int r = 0; r < kRowBlock; ++r)
                red[(r * S + s) * fout + c] += red[(r * S + s + st) * fout + c];
            }
            __syncthreads();
          }
          if (active && s == 0) {
#pragma unroll
            for (int r = 0; r < kRowBlock; ++r) acc[r] = red[r * S * fout + c];
          }
        }
        if (active && s == 0) {
          const float bias = to_f32(B[c]);
#pragma unroll
          for (int r = 0; r < kRowBlock; ++r) {
            if (r0 + r < rows) {
              const float v = acc[r] + bias;
              if (last)
                out[(n * rows + r0 + r) * fout + c] = from_f32<T>(v);
              else
                nxt[(r0 + r) * ld + c] = v < 0.f ? 0.f : v;  // NaN passes
            }
          }
        }
        if (S > 1) __syncthreads();  // the next row block rewrites red
      }
    }
    __syncthreads();  // nxt is complete before the next layer reads it
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename T>
cudaError_t launch(const void* x, const FleetMlpLayers& L, int n, int rows,
                   void* out, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fleet_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fleet_mlp_kernel<T><<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(x), L, rows, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch geometry, so the Python wrapper can check it agrees.
void fleet_mlp_config(int* cfg) {
  cfg[0] = kMaxDepth;
  cfg[1] = kThreads;
  cfg[2] = kRowBlock;
  cfg[3] = kMaxSmemBytes;
}

const char* fleet_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, rows, widths[0]); w[i] (n, widths[i], widths[i+1]); b[i]
// (n, widths[i+1]); out (n, rows, widths[depth]); all contiguous, all of
// one type: dtype 0 = float32, 1 = bfloat16. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int fleet_mlp_forward(const void* x, const void* const* w,
                      const void* const* b, const int* widths, int depth,
                      int n, int rows, int dtype, void* out, void* stream) {
  if (depth < 1 || depth > kMaxDepth || n < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FleetMlpLayers L{};
  L.depth = depth;
  L.ld = 0;
  for (int i = 0; i <= depth; ++i) {
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    L.width[i] = widths[i];
    if (widths[i] > L.ld) L.ld = widths[i];
  }
  for (int i = 0; i < depth; ++i) {
    L.w[i] = w[i];
    L.b[i] = b[i];
  }
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(rows) * L.ld +
                       static_cast<size_t>(kRowBlock) * kThreads);
  if (smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, L, n, rows, out, smem, st));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, L, n, rows, out, smem, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
