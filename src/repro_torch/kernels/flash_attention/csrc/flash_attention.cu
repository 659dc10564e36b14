// Blocked GQA attention with an online softmax, forward only, for Hopper
// (sm_90a). q (B, Sq, H, D), k/v (B, Skv, KV, D), out (B, Sq, H, D), all
// contiguous and of one type (f32 or bf16); scores, softmax and the output
// sum in f32, rounded to the input type once at the end.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas and its body _kernel).
//
// Semantics: query head h reads KV head h / G (G = H / KV), the grouping
// of q.reshape(B, S, KV, G, D). With `causal`, key u is visible to query t
// when u <= t + (Skv - Sq): the mask is aligned bottom-right.
//
// What bounds it on this card: operations. At the prefill shape (Sq = Skv
// = 1024, D = 128) every K/V byte feeds 2 * 64 multiply-adds per q tile,
// far above the ridge point; the bound is the tensor cores' bf16 rate.
// This first version does its products as f32 FMAs on CUDA cores instead
// (exact for f32 inputs, one code path for both types), so it runs well
// below that bound; mma/wgmma tiles are later work.
//
// What the design does:
//  * one block per (64-row q tile, query head, batch row); the TPU grid's
//    sequential k axis becomes a loop over 64-key tiles inside the block,
//    with the running max, sum and output kept in registers;
//  * causal: the loop stops at the last tile that holds a visible key, so
//    tiles wholly above the diagonal are never loaded; the q tiles with the
//    most keys are launched first;
//  * q (pre-scaled), k (transposed) and v tiles are staged in shared memory
//    as f32 with 16-byte global loads; padded rows keep the reads free of
//    bank conflicts;
//  * each thread owns a 4 x 4 patch of the score tile (rows ty + 16 i,
//    columns tx + 16 j) and 4 rows x up to 8 columns of the output; row
//    max and sum reduce over the 16 lanes that share a row with shuffles;
//  * ragged Sq / Skv are masked (rows past Sq are not stored, keys past Skv
//    are -inf), D is any multiple of 8 up to 128.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

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

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees:
// {kBlockQ, kBlockK, kThreads, kMaxHeadDim, kMaxSmemBytes}.
void flash_attention_config(int* cfg) {
  cfg[0] = kBlockQ;
  cfg[1] = kBlockK;
  cfg[2] = kThreads;
  cfg[3] = kMaxHeadDim;
  cfg[4] = kMaxSmemBytes;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Sq, H, D); k, v (B, Skv, KV, D); out (B, Sq, H, D); all contiguous,
// 16-byte aligned, of one type: dtype 0 = float32, 1 = bfloat16. Launches
// on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int flash_attention_forward(const void* q, const void* k, const void* v, void* out,
                            int B, int Sq, int Skv, int H, int KV, int D, int causal,
                            float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || D < 8 || D % 8 != 0 ||
      D > kMaxHeadDim || (causal && Sq > Skv) || smem_bytes(D) > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, out, B, Sq, Skv, H, KV, D, causal, scale, st));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, D, causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
