// Single-token GQA decode attention against a KV cache, split over the
// cache (flash-decoding), for Hopper (sm_90a). q (B, H, D), caches
// (B, S, KV, D), lengths (B,) int32, out (B, H, D); q, caches and out
// contiguous and of one type (f32 or bf16); scores, softmax and the output
// sum in f32, rounded to the input type once at the end.
//
// Replaces the TPU kernel in src/repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas and its body _kernel).
//
// What bounds it on this card: bytes. Each valid cache entry is read once
// and feeds G = H / KV multiply-adds per element, far below the ridge
// point, so the least time is the valid K/V bytes over the memory rate.
// CUDA cores suffice, and f32 and bf16 share one template.
//
// What the design does: two launches per call.
//  * partial pass, one block per (split, KV head, batch row): the cache
//    axis is cut into n_split ranges of split_len slots, chosen on the host
//    from S and B * KV alone (never from lengths, which stay on the card),
//    so that even 8 rows x 8 KV heads fill the 132 SMs. A block whose
//    range starts at or past lengths[b] writes m = -inf, l = 0 and exits
//    without loading anything;
//  * inside a block, 64-slot K and V tiles stream through a kStages-deep
//    cp.async ring (16-byte copies, kept in the cache's type in shared
//    memory); slots at and past lengths[b] are zero-filled, never read;
//  * q . k: 16 lanes per slot, each on 8 contiguous D elements, reduced
//    with shuffles; each half-warp takes 4 slots at once (independent
//    sums, so the shuffles overlap); all G query heads of the group are
//    served from each tile, so every K/V byte is read once. The online
//    softmax keeps each head's running max and sum in shared memory, its
//    output sum in registers (p v in four independent sums);
//  * the block writes its unnormalised (m, l, o) in f32 to a workspace the
//    wrapper allocates;
//  * combine pass, one block per (KV head, batch row): merges the splits
//    with the usual rescale by exp(m_split - m_max) and rounds once;
//  * a length above S counts as S; a row of length 0 writes zeros.
//
// The stats route (decode_attention_partial_forward) runs the same partial
// pass, then a combine that keeps the statistics a sequence shard needs to
// be merged with the others (src/repro/kernels/decode_attention/
// distributed.py, _partial): in f32 the unnormalised output sum_s w_s o_s
// (B, H, D), the max m (B, H) and the denominator l (B, H), with
// w_s = exp(m_s - m) over the kernel's own splits. A row with no valid slot
// in the cache writes m = -1e30, l = 0 and o = 0, never -inf: the shards'
// combine takes exp(m - max m), which is NaN where every shard of a row is
// -inf and 0 or 1 (with o = l = 0) where they are -1e30.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlockK = 64;   // slots per tile
constexpr int kThreads = 256;
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGroup = 16;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block can have
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = kMaxGroup * kMaxHeadDim / kThreads;  // outputs per thread
constexpr float kEmptyMax = -1e30f;  // the stats route's m of a row with no valid slot

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

// 8 contiguous elements of shared memory as f32
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

// 16 bytes global -> shared, asynchronously; zeros (and no read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// Slots k0 .. k0 + 63 of one (batch row, KV head) into a ring stage; slots
// at and past `end` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* kd, T* vd, const T* kb, const T* vb, int k0, int end,
                                          size_t row_stride, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = D / kVec;
  for (int i = threadIdx.x; i < kBlockK * chunks; i += kThreads) {
    const int c = i / chunks;
    const int e = (i % chunks) * kVec;
    const bool valid = k0 + c < end;
    const size_t src = static_cast<size_t>(valid ? k0 + c : 0) * row_stride + e;
    cp_async16(kd + c * D + e, kb + src, valid);
    cp_async16(vd + c * D + e, vb + src, valid);
  }
}

// Workspace of one call: ml (B, KV, n_split, 2, G) holds each split's
// running max and sum per query head, o (B, KV, n_split, G, D) its
// unnormalised output sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc, const int* __restrict__ lengths,
                          float* __restrict__ ws_ml, float* __restrict__ ws_o, int S, int H,
                          int KV, int D, int split_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  T* Ks = reinterpret_cast<T*>(smem_raw);                             // [kStages][kBlockK][D]
  T* Vs = Ks + kStages * kBlockK * D;                                  // [kStages][kBlockK][D]
  float* Qs = reinterpret_cast<float*>(Vs + kStages * kBlockK * D);   // [G][D]
  float* Ps = Qs + G * D;        // [G][kBlockK], scores then probabilities
  float* Ms = Ps + G * kBlockK;  // [G] running max
  float* Ls = Ms + G;            // [G] running sum
  float* As = Ls + G;            // [G] this tile's rescale factor

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int len = min(max(lengths[b], 0), S);
  const int c0 = split * split_len;
  const int c1 = min(len, c0 + split_len);
  const size_t part = (static_cast<size_t>(b) * KV + kvh) * gridDim.x + split;
  float* ml = ws_ml + part * 2 * G;
  float* po = ws_o + part * G * D;
  if (c0 >= c1) {  // no valid slot of this row in this split
    if (tid < G) {
      ml[tid] = -INFINITY;
      ml[G + tid] = 0.f;
    }
    return;
  }

  const size_t row_stride = static_cast<size_t>(KV) * D;
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * D;
  const T* kb = kc + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * D;
  const T* vb = vc + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * D;
  const int n_tiles = (c1 - c0 + kBlockK - 1) / kBlockK;
  const int tile_elems = kBlockK * D;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      load_tile(Ks + t * tile_elems, Vs + t * tile_elems, kb, vb, c0 + t * kBlockK, c1,
                row_stride, D);
    cp_async_commit();
  }
  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_f32(qb[i]);
  if (tid < G) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d0 = 8 * (tid % 16);  // this lane's 8 elements of D
  for (int t = 0; t < n_tiles; ++t) {
    const int next = t + kStages - 1;
    if (next < n_tiles)
      load_tile(Ks + (next % kStages) * tile_elems, Vs + (next % kStages) * tile_elems, kb, vb,
                c0 + next * kBlockK, c1, row_stride, D);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t has landed (for this thread)
    __syncthreads();               // ... and for every thread

    const T* kt = Ks + (t % kStages) * tile_elems;
    const T* vt = Vs + (t % kStages) * tile_elems;
    const int n = min(kBlockK, c1 - (c0 + t * kBlockK));  // valid slots in the tile

    // scores: half-warp hw takes slots hw, hw + 16, hw + 32 and hw + 48,
    // four independent dot products, each lane on 8 elements of D
    {
      const int hw = tid / 16;
      float kx[4][8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) kx[j][i] = 0.f;
        if (d0 < D) load8(kt + (hw + 16 * j) * D + d0, kx[j]);
      }
      for (int g = 0; g < G; ++g) {
        float qx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (d0 < D) load8(Qs + g * D + d0, qx);
        float s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) s[j] = fmaf(qx[i], kx[j][i], s[j]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
        if (lane % 16 == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = hw + 16 * j;
            Ps[g * kBlockK + c] = c < n ? s[j] * scale : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

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

    // o += p v over the tile's 64 slots, in four independent sums; slots
    // past the valid range have p = 0 and v = 0 (zero-filled)
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int e = tid + a * kThreads;
      if (e < G * D) {
        const int g = e / D;
        const int d = e % D;
        const float* p = Ps + g * kBlockK;
        float o4[4] = {acc[a] * As[g], 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int c = 0; c < kBlockK; c += 4)
#pragma unroll
          for (int j = 0; j < 4; ++j) o4[j] = fmaf(p[c + j], to_f32(vt[(c + j) * D + d]), o4[j]);
        acc[a] = (o4[0] + o4[1]) + (o4[2] + o4[3]);
      }
    }
    __syncthreads();  // the stage is refilled and Ps / As rewritten next
  }

#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int e = tid + a * kThreads;
    if (e < G * D) po[e] = acc[a];
  }
  if (tid < G) {
    ml[tid] = Ms[tid];
    ml[G + tid] = Ls[tid];
  }
}

// kStats false: out (B, H, D) of type T gets o / l. kStats true: out is
// f32, the unnormalised o, and out_m, out_l (B, H) f32 get m and l.
template <typename T, bool kStats>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ ws_ml, const float* __restrict__ ws_o,
                          void* __restrict__ out, float* __restrict__ out_m,
                          float* __restrict__ out_l, int H, int KV, int D, int n_split) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const size_t part0 = (static_cast<size_t>(b) * KV + kvh) * n_split;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D;
    float m_max = -INFINITY;
    for (int s = 0; s < n_split; ++s) m_max = fmaxf(m_max, ws_ml[(part0 + s) * 2 * G + g]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < n_split && m_max != -INFINITY; ++s) {
      const float m = ws_ml[(part0 + s) * 2 * G + g];
      if (m == -INFINITY) continue;  // the split held no valid slot; its o was never written
      const float w = expf(m - m_max);
      l = fmaf(w, ws_ml[(part0 + s) * 2 * G + G + g], l);
      o = fmaf(w, ws_o[(part0 + s) * G * D + e], o);
    }
    if constexpr (kStats) {
      static_cast<float*>(out)[head0 * D + e] = o;  // 0 where no split held a slot
      if (e % D == 0) {
        out_m[head0 + g] = m_max == -INFINITY ? kEmptyMax : m_max;
        out_l[head0 + g] = l;
      }
    } else {
      static_cast<T*>(out)[head0 * D + e] = from_f32<T>(l > 0.f ? o / l : 0.f);
    }
  }
}

size_t smem_bytes(int G, int D, size_t elem) {
  return elem * 2 * kStages * kBlockK * static_cast<size_t>(D) +
         sizeof(float) * (static_cast<size_t>(G) * D + static_cast<size_t>(G) * kBlockK + 3 * G);
}

// The partial pass, then the combine: o / l in T into out, or with stats
// the f32 o, m and l into out, out_m and out_l.
template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* lengths, void* ws,
                   void* out, float* out_m, float* out_l, bool stats, int B, int S, int H, int KV,
                   int D, int n_split, int split_len, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = smem_bytes(G, D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* ws_ml = static_cast<float*>(ws);
  float* ws_o = ws_ml + static_cast<size_t>(B) * KV * n_split * 2 * G;
  decode_partial_kernel<T><<<dim3(n_split, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const int*>(lengths), ws_ml, ws_o, S, H, KV, D, split_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (stats)
    decode_combine_kernel<T, true><<<dim3(KV, B), kThreads, 0, stream>>>(
        ws_ml, ws_o, out, out_m, out_l, H, KV, D, n_split);
  else
    decode_combine_kernel<T, false><<<dim3(KV, B), kThreads, 0, stream>>>(
        ws_ml, ws_o, out, nullptr, nullptr, H, KV, D, n_split);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KV, int D, int n_split, int split_len, int dtype) {
  return B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxGroup || D < 8 ||
         D % 8 != 0 || D > kMaxHeadDim || n_split < 1 || split_len < 1 ||
         static_cast<long long>(n_split) * split_len < S ||
         smem_bytes(H / KV, D, dtype == 0 ? 4 : 2) > static_cast<size_t>(kMaxSmemBytes);
}

int dispatch(const void* q, const void* kc, const void* vc, const void* lengths, void* ws,
             void* out, float* out_m, float* out_l, bool stats, int B, int S, int H, int KV,
             int D, int n_split, int split_len, float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, D, n_split, split_len, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, kc, vc, lengths, ws, out, out_m, out_l, stats, B, S,
                                          H, KV, D, n_split, split_len, scale, st));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, kc, vc, lengths, ws, out, out_m, out_l,
                                                   stats, B, S, H, KV, D, n_split, split_len,
                                                   scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch geometry, read by the wrapper to check it agrees:
// {kBlockK, kThreads, kStages, kMaxHeadDim, kMaxGroup, kMaxSmemBytes}.
void decode_attention_config(int* cfg) {
  cfg[0] = kBlockK;
  cfg[1] = kThreads;
  cfg[2] = kStages;
  cfg[3] = kMaxHeadDim;
  cfg[4] = kMaxGroup;
  cfg[5] = kMaxSmemBytes;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, H, D); k_cache, v_cache (B, S, KV, D); lengths (B,) int32 on the
// card; ws f32 of B * KV * n_split * G * (D + 2) elements; out (B, H, D);
// all contiguous, 16-byte aligned, q / caches / out of one type: dtype 0 =
// float32, 1 = bfloat16. The cache is cut into n_split ranges of split_len
// slots (n_split * split_len >= S). Launches the partial and the combine
// pass on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int decode_attention_forward(const void* q, const void* kc, const void* vc,
                             const void* lengths, void* ws, void* out, int B, int S, int H,
                             int KV, int D, int n_split, int split_len, float scale, int dtype,
                             void* stream) {
  return dispatch(q, kc, vc, lengths, ws, out, nullptr, nullptr, false, B, S, H, KV, D, n_split,
                  split_len, scale, dtype, stream);
}

// The stats route: as decode_attention_forward, but out_o (B, H, D), out_m
// and out_l (B, H) are f32 and receive the unnormalised output, the max and
// the denominator (m = -1e30, l = 0, o = 0 for a row with no valid slot).
int decode_attention_partial_forward(const void* q, const void* kc, const void* vc,
                                     const void* lengths, void* ws, void* out_o, void* out_m,
                                     void* out_l, int B, int S, int H, int KV, int D,
                                     int n_split, int split_len, float scale, int dtype,
                                     void* stream) {
  return dispatch(q, kc, vc, lengths, ws, out_o, static_cast<float*>(out_m),
                  static_cast<float*>(out_l), true, B, S, H, KV, D, n_split, split_len, scale,
                  dtype, stream);
}

}  // extern "C"
