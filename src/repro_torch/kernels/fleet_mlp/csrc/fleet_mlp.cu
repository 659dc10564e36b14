// Fleet-batched MLP forward for Hopper (sm_90a): N independent MLPs, each
// with its own weights, in one launch. ReLU between layers, linear last
// layer, f32 accumulation, output rounded to the input type at the end.
//
// Replaces the TPU kernel in src/repro/kernels/fleet_mlp/kernel.py
// (fleet_mlp_pallas and its body _kernel).
//
// What bounds it on this card. At the scoring width (512, b = 1) weight
// bytes: each weight feeds one multiply-add, 2 FLOP per 4 bytes in f32,
// far below the card's ridge point, so a launch can be no faster than
// streaming every instance's sum_i F_i * F_{i+1} weights (1.67 GB) from
// device memory once. At the widths deployments use (64, 32, 16) the
// weights are a few to a few tens of MB and there are only a few hundred
// instances, a warp or so on each scheduler: what bounds a launch there is
// the latency of one instance's chain of dependent steps (fetch, five
// layers, store), not bandwidth.
//
// What the design does about it. Each instance's weights are one stream of
// chunks (whole rows of W_0, then of W_1, ... W_{depth-1}), copied by bulk
// copies (cp.async.bulk, completion counted on an mbarrier) into a ring of
// shared-memory stages. The weights do not depend on the activations, so
// the stream runs ahead of the arithmetic across layer boundaries, and a
// layer's end never stops the loads. Two routes, picked from the widths by
// fleet_mlp_plan (mirrored by kernel.py's plan_launch):
//
//  * wide (a layer wider than kNarrowMaxWidth; the scoring shape): a
//    persistent block of one producer warp and kWideConsumerWarps consumer
//    warps walks instances n = blockIdx.x, n + gridDim.x, ... The producer
//    keeps kWideStages chunks of kWideChunkBytes in flight (fewer, or
//    smaller, where b x width leaves less room), from one layer
//    into the next and one instance into the next, and takes a stage back
//    when every consumer warp has released it (an "empty" mbarrier).
//    Consumer threads own output columns and fold each chunk's rows into
//    their columns' sums, reading the activations from shared memory; at a
//    layer's end only the consumers meet, on a named barrier, while the
//    producer fills the next layer's stages.
//  * narrow (no layer wider than kNarrowMaxWidth; the widths deployments
//    use): one warp an instance, kNarrowWarps instances a block, no
//    block-wide barrier. Each warp streams its own instance through its
//    own ring, whose stages are as large as the largest chunk the layers
//    need (up to kNarrowChunkBytes) and which holds every chunk of an
//    instance where it can (up to kNarrowMaxStages): lane i issues chunk i
//    at the start, the refill of a stage follows its use. The warp is
//    alone on its scheduler, so its chain is kept short: the layers'
//    parameters are read once into a table in shared memory, the inputs
//    and biases are fetched with every load in flight before the first
//    store, and the folds issue a few rows' loads before their
//    multiply-adds and keep two sums a column.
//
// In both, a layer narrower than a warp (the width-1 output layer above
// all) is folded by one warp whose lanes split the rows and sum by
// __shfl_xor_sync: no shared-memory tree and no block barrier. Sums over
// chunks stay in the next layer's activation buffer, owned by one thread
// each, so any b that shared memory holds takes the same code.
//
// Alignment: a bulk copy moves 16-byte-aligned bytes, but an instance's
// slice of a layer starts at n * F_in * F_out elements, off 16 bytes
// whenever F_in * F_out is not a multiple of 16 / sizeof(T), and a chunk of
// whole rows starts wherever its first row does. A stage holds the chunk's
// enclosing 16-byte window (kSlack bytes beyond the chunk); the bytes of the
// slice's own head and tail that fall outside its aligned interior are
// loaded by the producing lanes with plain loads. Nothing outside the
// slice is read, and no shape is refused for its alignment.
//
// Plain C interface, loaded with ctypes (see ../kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxDepth = 8;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block can have
constexpr int kSmSmemBytes = 233472;   // 228 KB an SM, 1 KB of it per block
constexpr int kRowBlock = 4;           // rows of x folded together (b > 1)
constexpr int kSlack = 32;             // a stage's bytes beyond its chunk
constexpr int kBarBytes = 1024;  // mbarriers and layer tables, ahead of the rings

constexpr int kWideConsumerWarps = 8;
constexpr int kWideConsumers = kWideConsumerWarps * 32;
constexpr int kWideThreads = kWideConsumers + 32;  // + the producer warp
constexpr int kWideStages = 4;
constexpr int kWideChunkBytes = 16384;
constexpr int kWideBlocksPerSm = 2;

constexpr int kNarrowMaxWidth = 64;
constexpr int kNarrowWarps = 4;  // instances a block
constexpr int kNarrowMaxStages = 6;
constexpr int kNarrowChunkBytes = 8192;  // the most; less for small layers

constexpr int kNarrow = 0;
constexpr int kWide = 1;

struct FleetMlpLayers {
  const void* w[kMaxDepth];
  const void* b[kMaxDepth];
  int width[kMaxDepth + 1];
  int rpc[kMaxDepth];   // rows of W_i in one chunk
  int boff[kMaxDepth];  // offset of b_i in the bias buffer
  int depth;
  int ld;    // row stride of the activation buffers: the widest layer
  int bsum;  // floats of the bias buffer: sum of widths[1..depth]
  int stages, stage_bytes;  // the ring: stages of a chunk + kSlack bytes
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Whether the phase of parity `parity` of the mbarrier at `addr` has
// completed: test_wait answers at once, try_wait may first suspend the
// thread for a while.
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ bool mbar_test_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of `bar` has completed. A wait
// that outlasts ~2^34 cycles (seconds) stores through a null pointer: the
// launch fails (an illegal address) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_test_wait(addr, parity)) return;  // the chunk is there already
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > (1ll << 34))
      *reinterpret_cast<volatile int*>(0) = 1;
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing `bar`'s transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the wide route's consumer warps, without the producer
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWideConsumers) : "memory");
}

__device__ __forceinline__ uintptr_t down16(uintptr_t p) {
  return p & ~static_cast<uintptr_t>(15);
}
__device__ __forceinline__ uintptr_t up16(uintptr_t p) {
  return down16(p + 15);
}

// What walking one instance's chunks of W_l takes: the instance's slice
// of W_l, the layer's geometry, rows a chunk, and its bias's offset in the
// bias buffer.
struct LayerRef {
  uintptr_t slice;
  int fin, fout, rpc, boff;
};

// Layer l's reference for instance n, read from the launch parameters.
template <typename T>
__device__ __forceinline__ LayerRef layer_ref(const FleetMlpLayers& L, int l,
                                              size_t n) {
  LayerRef r;
  r.fin = L.width[l];
  r.fout = L.width[l + 1];
  r.rpc = L.rpc[l];
  r.boff = L.boff[l];
  r.slice = reinterpret_cast<uintptr_t>(static_cast<const T*>(L.w[l]) +
                                        n * static_cast<size_t>(r.fin) * r.fout);
  return r;
}

// The next chunk of an instance's weight stream: rows [k0, k0 + rpc) of
// W_l; l == depth when the stream has ended. `src(l)` gives layer l's
// reference, read once a layer.
template <typename T>
struct Cursor {
  int l = 0, k0 = 0;
  LayerRef r;

  template <typename Src>
  __device__ __forceinline__ explicit Cursor(const Src& src) : r(src(0)) {}
  template <typename Src>
  __device__ __forceinline__ void next(const Src& src, int depth) {
    k0 += r.rpc;
    if (k0 >= r.fin) {
      k0 = 0;
      if (++l < depth) r = src(l);
    }
  }
  __device__ __forceinline__ int rows() const { return min(r.fin - k0, r.rpc); }
  // the chunk's first byte
  __device__ __forceinline__ uintptr_t start() const {
    return r.slice + static_cast<uintptr_t>(k0) * r.fout * sizeof(T);
  }
};

// Fill `stage` with chunk `c`, completing `full`'s phase (one arrival and
// the bulk bytes). Called by `parts` lanes together, lane `part` of them:
// all 32 of a warp, or one lane alone. The chunk's bytes [s, e) land at
// stage + (p - down16(s)); the part inside the slice's 16-byte-aligned
// interior comes by one bulk copy, the rest (at most 15 bytes at each
// end) by the lanes' plain loads, which a warp's lanes fence and gather by
// __syncwarp before part 0 arrives.
template <typename T>
__device__ __forceinline__ void issue_chunk(const Cursor<T>& c,
                                            unsigned char* stage,
                                            uint64_t* full, int part,
                                            int parts) {
  const uintptr_t a = c.r.slice, s = c.start();
  const uintptr_t e =
      s + static_cast<uintptr_t>(c.rows()) * c.r.fout * sizeof(T);
  const uintptr_t a_end =
      a + static_cast<uintptr_t>(c.r.fin) * c.r.fout * sizeof(T);
  const uintptr_t ws = down16(s);
  uintptr_t lo = up16(a) > ws ? up16(a) : ws;
  uintptr_t hi = down16(a_end) < up16(e) ? down16(a_end) : up16(e);
  if (hi <= lo) lo = hi = s;  // a slice under 32 bytes: all plain
  const int head = lo > s ? static_cast<int>((lo - s) / sizeof(T)) : 0;
  const int tail = e > hi ? static_cast<int>((e - hi) / sizeof(T)) : 0;
  for (int i = part; i < head + tail; i += parts) {
    const uintptr_t p = i < head ? s + i * sizeof(T)
                                 : hi + (i - head) * sizeof(T);
    *reinterpret_cast<T*>(stage + (p - ws)) = *reinterpret_cast<const T*>(p);
  }
  if (parts > 1 && head + tail > 0) {  // the same for every lane
    __threadfence_block();
    __syncwarp();
  }
  if (part != 0) return;
  if (hi > lo) {
    mbar_expect_tx(full, static_cast<uint32_t>(hi - lo));
    bulk_load(stage + (lo - ws), reinterpret_cast<const void*>(lo),
              static_cast<uint32_t>(hi - lo), full);
  } else {
    mbar_arrive(full);
  }
}

// One column sum (or, finishing, its output) of row r: into the next
// layer's buffer as a partial sum, as that layer's ReLU'd input, or, on
// the last layer, to `out` rounded to T.
template <typename T>
__device__ __forceinline__ void store_sum(float v, int r, int c, int fout,
                                          int ld, float* nxt, const float* bias,
                                          bool finish, bool last, T* out) {
  if (!finish) {
    nxt[r * ld + c] = v;
    return;
  }
  v += bias[c];
  if (last)
    out[r * fout + c] = from_f32<T>(v);
  else
    nxt[r * ld + c] = v < 0.f ? 0.f : v;  // NaN passes
}

// What a chunk's consumers share: its rows [k0, k0 + nk) of a layer, held
// at ws with row stride fout, and where their sums go.
template <typename T>
struct Fold {
  const T* ws;
  int k0, nk, fin, fout, rows, ld;
  const float* cur;   // the layer's input, rows x ld
  float* nxt;         // its partial sums, then its output
  const float* bias;  // the layer's bias
  bool first, finish, last;
  T* out;  // the instance's output rows (last layer)
};

// Rows of a chunk folded together: their loads are all issued before
// their multiply-adds (a narrow warp is alone on its scheduler and hides
// no load latency behind other warps).
constexpr int kFoldRows = 4;

// Column-owner fold: thread t of nt owns the columns c0 + j nt (j < C)
// for c0 = t, t + C nt, ...; even and odd rows go to separate sums, so
// 2 C chains of multiply-adds run side by side.
template <typename T, int RB, int C>
__device__ __forceinline__ void fold_columns(const Fold<T>& f, int t, int nt) {
  for (int c0 = t; c0 < f.fout; c0 += C * nt) {
    bool on[C];
#pragma unroll
    for (int j = 0; j < C; ++j) on[j] = c0 + j * nt < f.fout;
    for (int r0 = 0; r0 < f.rows; r0 += RB) {
      float acc[2][C][RB];
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[0][j][r] = f.first || !on[j] || r0 + r >= f.rows
                             ? 0.f
                             : f.nxt[(r0 + r) * f.ld + c0 + j * nt];
          acc[1][j][r] = 0.f;
        }
      const T* wc = f.ws + c0;
      const float* xk = f.cur + r0 * f.ld + f.k0;
      int k = 0;
#pragma unroll 2
      for (; k + kFoldRows <= f.nk; k += kFoldRows) {
        float w[kFoldRows][C], xv[kFoldRows][RB];
#pragma unroll
        for (int q = 0; q < kFoldRows; ++q) {
#pragma unroll
          for (int j = 0; j < C; ++j)
            w[q][j] = on[j] ? to_f32(wc[(k + q) * f.fout + j * nt]) : 0.f;
#pragma unroll
          for (int r = 0; r < RB; ++r)
            xv[q][r] = r0 + r < f.rows ? xk[r * f.ld + k + q] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kFoldRows; ++q)
#pragma unroll
          for (int j = 0; j < C; ++j)
#pragma unroll
            for (int r = 0; r < RB; ++r)
              acc[q & 1][j][r] = fmaf(xv[q][r], w[q][j], acc[q & 1][j][r]);
      }
      for (; k < f.nk; ++k) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float w = on[j] ? to_f32(wc[k * f.fout + j * nt]) : 0.f;
#pragma unroll
          for (int r = 0; r < RB; ++r)
            if (r0 + r < f.rows)
              acc[0][j][r] = fmaf(xk[r * f.ld + k], w, acc[0][j][r]);
        }
      }
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (on[j] && r0 + r < f.rows)
            store_sum(acc[0][j][r] + acc[1][j][r], r0 + r, c0 + j * nt, f.fout,
                      f.ld, f.nxt, f.bias, f.finish, f.last, f.out);
    }
  }
}

// Lane-group fold of a layer narrower than a warp, by one warp: lanes in
// groups of cpad (fout rounded up to a power of two) own the columns, the
// 32 / cpad groups split the rows (kFoldRows at a time, in two sums), and
// __shfl_xor_sync sums the groups.
template <typename T, int RB>
__device__ __forceinline__ void fold_lanes(const Fold<T>& f, int lane) {
  const int shift = f.fout > 1 ? 32 - __clz(f.fout - 1) : 0;
  const int cpad = 1 << shift, groups = 32 >> shift;
  const int g = lane >> shift, c = lane & (cpad - 1);
  const bool on = c < f.fout;
  for (int r0 = 0; r0 < f.rows; r0 += RB) {
    float acc[2][RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[0][r] = acc[1][r] = 0.f;
    if (on) {
      const T* wc = f.ws + c;
      const float* xk = f.cur + r0 * f.ld + f.k0;
      const int step = kFoldRows * groups;
      int k = g;
      for (; k + (kFoldRows - 1) * groups < f.nk; k += step) {
        float w[kFoldRows], xv[kFoldRows][RB];
#pragma unroll
        for (int q = 0; q < kFoldRows; ++q) {
          w[q] = to_f32(wc[(k + q * groups) * f.fout]);
#pragma unroll
          for (int r = 0; r < RB; ++r)
            xv[q][r] = r0 + r < f.rows ? xk[r * f.ld + k + q * groups] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kFoldRows; ++q)
#pragma unroll
          for (int r = 0; r < RB; ++r)
            acc[q & 1][r] = fmaf(xv[q][r], w[q], acc[q & 1][r]);
      }
      for (; k < f.nk; k += groups) {
        const float w = to_f32(wc[k * f.fout]);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r0 + r < f.rows) acc[0][r] = fmaf(xk[r * f.ld + k], w, acc[0][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      acc[0][r] += acc[1][r];
      for (int o = cpad; o < 32; o <<= 1)
        acc[0][r] += __shfl_xor_sync(0xffffffffu, acc[0][r], o);
    }
    if (on && g == 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r0 + r < f.rows) {
          const float prev = f.first ? 0.f : f.nxt[(r0 + r) * f.ld + c];
          store_sum(acc[0][r] + prev, r0 + r, c, f.fout, f.ld, f.nxt, f.bias,
                    f.finish, f.last, f.out);
        }
    }
  }
}

// The chunk's fold as the route shares it out: a layer at least a warp
// wide by columns over the nt consumer threads, a narrower one by the
// lane groups of the first consumer warp alone.
template <typename T>
__device__ __forceinline__ void fold(const Fold<T>& f, int t, int nt) {
  if (f.fout > nt) {
    if (f.rows == 1)
      fold_columns<T, 1, 2>(f, t, nt);
    else
      fold_columns<T, kRowBlock, 2>(f, t, nt);
  } else if (f.fout >= 32) {
    if (f.rows == 1)
      fold_columns<T, 1, 1>(f, t, nt);
    else
      fold_columns<T, kRowBlock, 1>(f, t, nt);
  } else if (t < 32) {
    if (f.rows == 1)
      fold_lanes<T, 1>(f, t);
    else
      fold_lanes<T, kRowBlock>(f, t);
  }
}

// Instance n's input rows (to f32) and every layer's bias into shared
// memory: x's rows at act[r * ld + f], the biases after the two
// activation buffers. Thread t of nt fetches elements i = first + j * nt
// (j < kLoadBatch, i < total) of x and the concatenated biases into
// registers, all loads in flight before any store (the compiler would
// otherwise keep each load in order with the stores before it: a round
// trip to memory each).
constexpr int kLoadBatch = 8;

struct Fetched {
  float v[kLoadBatch];
  int dst[kLoadBatch];  // offset from act, or -1
};

template <typename T>
__device__ __forceinline__ Fetched fetch_instance(const FleetMlpLayers& L,
                                                  const T* x, size_t n,
                                                  int rows, int first, int nt,
                                                  int total) {
  const int f0 = L.width[0], nx = rows * f0;
  Fetched got;
#pragma unroll
  for (int j = 0; j < kLoadBatch; ++j) {
    const int i = first + j * nt;
    got.v[j] = 0.f;
    got.dst[j] = -1;
    if (i < nx) {
      got.v[j] = to_f32(x[n * nx + i]);
      got.dst[j] = rows == 1 ? i : (i / f0) * L.ld + i % f0;
    } else if (i < total) {
      int l = 0;
      const int k = i - nx;  // element k of the concatenated biases
      while (l + 1 < L.depth && k >= L.boff[l + 1]) ++l;
      got.v[j] = to_f32(static_cast<const T*>(
          L.b[l])[n * L.width[l + 1] + k - L.boff[l]]);
      got.dst[j] = 2 * rows * L.ld + k;
    }
  }
  return got;
}

__device__ __forceinline__ void store_fetched(float* act, const Fetched& got) {
#pragma unroll
  for (int j = 0; j < kLoadBatch; ++j)
    if (got.dst[j] >= 0) act[got.dst[j]] = got.v[j];
}

// Instance n's fetches from element `first` to `total`, batch by batch.
template <typename T>
__device__ __forceinline__ void load_instance(const FleetMlpLayers& L,
                                              const T* x, size_t n, int rows,
                                              float* act, int first, int nt,
                                              int total) {
  for (int i0 = first; i0 < total; i0 += kLoadBatch * nt)
    store_fetched(act, fetch_instance(L, x, n, rows, i0, nt, total));
}

// The narrow route's biases (no layer wider than kNarrowMaxWidth): each
// lane's elements lane + 32 j of every layer's, loaded with the layer
// known at compile time (no indexed read of the parameters) and all in
// flight together.
struct NarrowBias {
  float v[kMaxDepth][kNarrowMaxWidth / 32];
};

template <typename T>
__device__ __forceinline__ NarrowBias fetch_narrow_bias(
    const FleetMlpLayers& L, size_t n, int lane) {
  NarrowBias got;
#pragma unroll
  for (int l = 0; l < kMaxDepth; ++l)
#pragma unroll
    for (int j = 0; j < kNarrowMaxWidth / 32; ++j) {
      const int i = lane + 32 * j, fout = L.width[l + 1];
      got.v[l][j] = l < L.depth && i < fout
                        ? to_f32(static_cast<const T*>(L.b[l])[n * fout + i])
                        : 0.f;
    }
  return got;
}

__device__ __forceinline__ void store_narrow_bias(const FleetMlpLayers& L,
                                                  float* bias,
                                                  const NarrowBias& got,
                                                  int lane) {
#pragma unroll
  for (int l = 0; l < kMaxDepth; ++l)
#pragma unroll
    for (int j = 0; j < kNarrowMaxWidth / 32; ++j) {
      const int i = lane + 32 * j;
      if (l < L.depth && i < L.width[l + 1]) bias[L.boff[l] + i] = got.v[l][j];
    }
}

// The consumers' view of chunk `c`, landed in `stage`; `out` is the
// instance's output rows.
template <typename T>
__device__ __forceinline__ Fold<T> chunk_fold(const FleetMlpLayers& L,
                                              const Cursor<T>& c,
                                              const unsigned char* stage,
                                              int rows, const float* cur,
                                              float* nxt, const float* bias,
                                              T* out) {
  Fold<T> f;
  f.fin = c.r.fin;
  f.fout = c.r.fout;
  f.ws = reinterpret_cast<const T*>(stage + (c.start() & 15));
  f.k0 = c.k0;
  f.nk = c.rows();
  f.rows = rows;
  f.ld = L.ld;
  f.cur = cur;
  f.nxt = nxt;
  f.bias = bias + c.r.boff;
  f.first = c.k0 == 0;
  f.finish = c.k0 + f.nk >= f.fin;
  f.last = c.l == L.depth - 1;
  f.out = out;
  return f;
}

// Wide route. Shared memory: L.stages (up to kWideStages) full and empty
// mbarriers, the ring, two rows x ld f32 activation buffers, the biases.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, kWideBlocksPerSm)
    fleet_mlp_wide_kernel(const T* __restrict__ x, FleetMlpLayers L, int n_inst,
                          int rows, T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kWideStages;
  unsigned char* ring = smem + kBarBytes;
  float* act = reinterpret_cast<float*>(ring + L.stages * L.stage_bytes);
  float* bias = act + 2 * rows * L.ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWideConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWideConsumerWarps) {  // the producer
    int stage = 0;
    uint32_t phase = 0;
    for (int n = blockIdx.x; n < n_inst; n += gridDim.x) {
      const auto src = [&](int l) { return layer_ref<T>(L, l, n); };
      for (Cursor<T> c(src); c.l < L.depth; c.next(src, L.depth)) {
        mbar_wait(&empty[stage], phase ^ 1);
        issue_chunk<T>(c, ring + stage * L.stage_bytes, &full[stage], lane,
                       32);
        if (++stage == L.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int t = threadIdx.x;  // consumer thread, 0..kWideConsumers-1
  const int o_width = L.width[L.depth];
  int stage = 0;
  uint32_t phase = 0;
  for (int n = blockIdx.x; n < n_inst; n += gridDim.x) {
    load_instance(L, x, n, rows, act, t, kWideConsumers,
                  rows * L.width[0] + L.bsum);
    consumer_sync();
    float* cur = act;
    float* nxt = act + rows * L.ld;
    T* out_n = out + static_cast<size_t>(n) * rows * o_width;
    const auto src = [&](int l) { return layer_ref<T>(L, l, n); };
    for (Cursor<T> c(src); c.l < L.depth;) {
      const int l = c.l;
      mbar_wait(&full[stage], phase);
      fold(chunk_fold<T>(L, c, ring + stage * L.stage_bytes, rows, cur, nxt,
                         bias, out_n),
           t, kWideConsumers);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == L.stages) {
        stage = 0;
        phase ^= 1;
      }
      c.next(src, L.depth);
      if (c.l != l) {  // the layer is done: its output is the next's input
        consumer_sync();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
  }
}

static_assert(kNarrowWarps * (kNarrowMaxStages * 8 +
                              kMaxDepth * sizeof(LayerRef)) <= kBarBytes &&
                  2 * kWideStages * 8 <= kBarBytes,
              "the mbarriers and layer tables overrun their bytes");

// Narrow route. Shared memory: kNarrowMaxStages full mbarriers a warp,
// each warp's table of layer references, the warps' rings of L.stages
// stages, then each warp's two activation buffers and bias buffer.
template <typename T>
__global__ void __launch_bounds__(kNarrowWarps * 32)
    fleet_mlp_narrow_kernel(const T* __restrict__ x, FleetMlpLayers L,
                            int n_inst, int rows, T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kNarrowWarps + warp;
  if (n >= n_inst) return;  // no barrier below spans the block
  const int ring_bytes = L.stages * L.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + warp * kNarrowMaxStages;
  LayerRef* tab = reinterpret_cast<LayerRef*>(
                      smem + kNarrowWarps * kNarrowMaxStages * 8) +
                  warp * kMaxDepth;
  unsigned char* ring = smem + kBarBytes + warp * ring_bytes;
  float* act = reinterpret_cast<float*>(smem + kBarBytes +
                                        kNarrowWarps * ring_bytes) +
               warp * (2 * rows * L.ld + L.bsum);
  float* bias = act + 2 * rows * L.ld;
  if (lane == 0) {
    for (int i = 0; i < L.stages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every layer's reference, lane l filling layer l's (the parameters read
  // at indices known at compile time); the biases and the first inputs in
  // flight
#pragma unroll
  for (int l = 0; l < kMaxDepth; ++l)
    if (lane == l && l < L.depth) tab[l] = layer_ref<T>(L, l, n);
  const int nx = rows * L.width[0];
  const NarrowBias biases = fetch_narrow_bias<T>(L, n, lane);
  const Fetched first = fetch_instance(L, x, n, rows, lane, 32, nx);
  __syncwarp();

  // the first L.stages chunks of the stream, lane i issuing chunk i
  const auto src = [&](int l) { return tab[l]; };
  Cursor<T> fill(src);  // the next chunk to copy
  {
    Cursor<T> mine = fill;
    bool have = false;
    for (int i = 0; i < L.stages && fill.l < L.depth;
         ++i, fill.next(src, L.depth)) {
      if (lane == i) {
        mine = fill;
        have = true;
      }
    }
    if (have)
      issue_chunk<T>(mine, ring + lane * L.stage_bytes, &full[lane], 0, 1);
  }
  store_fetched(act, first);
  store_narrow_bias(L, bias, biases, lane);
  load_instance(L, x, n, rows, act, lane + kLoadBatch * 32, 32, nx);
  __syncwarp();

  float* cur = act;
  float* nxt = act + rows * L.ld;
  int stage = 0;
  uint32_t phase = 0;
  T* out_n = out + static_cast<size_t>(n) * rows * L.width[L.depth];
  for (Cursor<T> c(src); c.l < L.depth;) {
    const int l = c.l;
    mbar_wait(&full[stage], phase);
    fold(chunk_fold<T>(L, c, ring + stage * L.stage_bytes, rows, cur, nxt, bias,
                       out_n),
         lane, 32);
    __syncwarp();  // the stage is read, the sums are written
    if (fill.l < L.depth) {
      issue_chunk<T>(fill, ring + stage * L.stage_bytes, &full[stage], lane,
                     32);
      fill.next(src, L.depth);
    }
    if (++stage == L.stages) {
      stage = 0;
      phase ^= 1;
    }
    c.next(src, L.depth);
    if (c.l != l) {
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

// The route, threads, dynamic shared memory, grid and ring of a launch,
// or route -1 when neither route holds the shape. The ring is sized at
// f32 width, so the plan does not depend on the type: bf16 rows take half
// the bytes, and a chunk holds twice as many.
struct Plan {
  int route, threads, smem, grid, stages, stage_bytes;
};

int round16(long long v) { return static_cast<int>((v + 15) / 16 * 16); }

Plan plan(const int* widths, int depth, int rows, int n, int sms) {
  Plan p{-1, 0, 0, 0, 0, 0};
  if (depth < 1 || depth > kMaxDepth || rows < 1 || n < 1) return p;
  int ld = 0, bsum = 0, widest_out = 0;
  for (int i = 0; i <= depth; ++i) {
    if (widths[i] < 1) return p;
    ld = widths[i] > ld ? widths[i] : ld;
    if (i > 0) {
      bsum += widths[i];
      widest_out = widths[i] > widest_out ? widths[i] : widest_out;
    }
  }
  const long long own = 4ll * (2ll * rows * ld + bsum);  // f32 buffers
  if (widest_out <= kNarrowMaxWidth) {
    // a stage holds the largest chunk the layers need, up to
    // kNarrowChunkBytes; a ring holds every chunk of an instance, up to
    // kNarrowMaxStages, or as many (two at least) as shared memory allows
    int chunks = 0, biggest = 0;
    for (int i = 0; i < depth; ++i) {
      const int row = 4 * widths[i + 1];
      const int rpc = kNarrowChunkBytes / row < widths[i]
                          ? kNarrowChunkBytes / row : widths[i];
      chunks += (widths[i] + rpc - 1) / rpc;
      biggest = rpc * row > biggest ? rpc * row : biggest;
    }
    const int stage_bytes = round16(biggest) + kSlack;
    const long long room =
        ((kMaxSmemBytes - kBarBytes) / kNarrowWarps - own) / stage_bytes;
    int stages = chunks < kNarrowMaxStages ? chunks : kNarrowMaxStages;
    stages = room < stages ? static_cast<int>(room) : stages;
    if (stages >= 2 || (stages == 1 && chunks == 1))
      return Plan{kNarrow, kNarrowWarps * 32,
                  static_cast<int>(kBarBytes + kNarrowWarps *
                                   (static_cast<long long>(stages) *
                                    stage_bytes + own)),
                  (n + kNarrowWarps - 1) / kNarrowWarps, stages, stage_bytes};
  }
  // a row of W (at f32 width) must fit a chunk. The ring takes up to
  // kWideStages stages of kWideChunkBytes; where b x width leaves less
  // room, fewer (two at least), then two smaller ones (a row at least)
  if (4ll * widest_out > kWideChunkBytes) return p;
  const long long room = kMaxSmemBytes - kBarBytes - own;
  long long stages = room / (kWideChunkBytes + kSlack);
  stages = stages < kWideStages ? stages : kWideStages;
  long long stage_bytes = kWideChunkBytes + kSlack;
  if (stages < 2) {
    stages = 2;
    stage_bytes = room / 2 / 16 * 16;
    if (stage_bytes - kSlack < round16(4ll * widest_out)) return p;
  }
  const long long smem = kBarBytes + stages * stage_bytes + own;
  long long per_sm = kSmSmemBytes / (smem + 1024);
  per_sm = per_sm < kWideBlocksPerSm ? per_sm : kWideBlocksPerSm;
  const long long blocks = static_cast<long long>(sms) * per_sm;
  return Plan{kWide, kWideThreads, static_cast<int>(smem),
              static_cast<int>(n < blocks ? n : blocks),
              static_cast<int>(stages), static_cast<int>(stage_bytes)};
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = sms;
  return sms;
}

template <typename T>
cudaError_t launch(const void* x, const FleetMlpLayers& L, const Plan& p,
                   int n, int rows, void* out, cudaStream_t stream) {
  auto kernel = p.route == kWide ? fleet_mlp_wide_kernel<T>
                                 : fleet_mlp_narrow_kernel<T>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), L, n, rows, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch geometry, so the Python wrapper can check it agrees.
void fleet_mlp_config(int* cfg) {
  const int v[] = {kMaxDepth,        kMaxSmemBytes,    kSmSmemBytes,
                   kRowBlock,        kSlack,           kBarBytes,
                   kWideThreads,     kWideStages,      kWideChunkBytes,
                   kWideBlocksPerSm, kNarrowMaxWidth,  kNarrowWarps,
                   kNarrowMaxStages, kNarrowChunkBytes};
  for (int i = 0; i < static_cast<int>(sizeof(v) / sizeof(v[0])); ++i)
    cfg[i] = v[i];
}

// The plan of a launch of n instances on a card of `sms` SMs: out[0] the
// route (0 narrow, 1 wide, -1 none), out[1] threads a block, out[2]
// dynamic shared memory, out[3] blocks, out[4] ring stages, out[5] bytes
// a stage.
void fleet_mlp_plan(const int* widths, int depth, int rows, int n, int sms,
                    int* out) {
  const Plan p = plan(widths, depth, rows, n, sms);
  const int v[] = {p.route, p.threads, p.smem, p.grid, p.stages,
                   p.stage_bytes};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
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
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan p = plan(widths, depth, rows, n, sms);
  if (p.route < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  const int payload = p.stage_bytes - kSlack;
  FleetMlpLayers L{};
  L.depth = depth;
  L.stages = p.stages;
  L.stage_bytes = p.stage_bytes;
  for (int i = 0; i <= depth; ++i) {
    L.width[i] = widths[i];
    if (widths[i] > L.ld) L.ld = widths[i];
  }
  for (int i = 0; i < depth; ++i) {
    L.w[i] = w[i];
    L.b[i] = b[i];
    const int rpc = payload / (widths[i + 1] * es);
    L.rpc[i] = rpc < widths[i] ? rpc : widths[i];
    L.boff[i] = L.bsum;
    L.bsum += widths[i + 1];
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, L, p, n, rows, out, st));
  return static_cast<int>(launch<__nv_bfloat16>(x, L, p, n, rows, out, st));
}

}  // extern "C"
