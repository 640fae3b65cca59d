// Train-mode BatchNorm kernels for Hopper (sm_90a), the CUDA counterparts of
// the four Pallas kernels in fullbatchtraining_tpu/ops/pallas_bn.py.
//
// Every kernel works on the row-major [M, C] view of a channels-last
// activation: row r is one (n, h, w) position, column c one channel. A block
// of THREADS threads takes one contiguous range of rows (blockIdx.x), so a
// thread keeps its channels (and their per-channel coefficients or sums) in
// registers for its whole range. A thread owns VEC neighbouring channels and
// moves them as one access: 16 bytes (VEC = 8 in bf16 and f16, 4 in f32, 2 in f64)
// where C is a multiple of VEC and every [M, C] pointer is 16-byte aligned,
// else VEC = 1 (the wrapper picks, the entry point checks). C / VEC threads
// share a row, so a block covers THREADS / (C / VEC) whole rows per pass (32
// rows at C = 64 in bf16) and a warp reads one contiguous run of memory;
// blockIdx.y picks a tile of THREADS groups only where a row has more (C >
// 2048 in bf16). The row loop runs whole groups of U rows with no bounds
// check, U accesses per input in flight, then the ragged tail one row at a
// time: with a check on every access ptxas kept more values live and spilled.
//
// Two templates cover the four kernels, each with one or two [M, C] inputs:
// reduce_rows (stats: x; bwd_reduce: dy, x) and affine_rows (apply: x;
// bwd_apply: dy, x). bwd_apply has two roundings, each with its entry point:
// the Pallas kernel's one rounding of dx, and SPLIT, the two of the JAX
// model's BatchNorm (see bwd_apply_kernel).
//
// Types: T is float, __nv_bfloat16, __half or double; every sum and
// coefficient is in A = promote(T, float), i.e. float for float, bf16 and f16
// and double for double. Outputs round to nearest; a float16 output beyond
// 65504 rounds to inf, as the Pallas kernels' does (nothing clamps it).
//
// Bound: all four are memory-bound (a few flops per element against 2 to 8
// bytes moved), so the least time is the bytes below over the card's memory
// rate; the 16-byte accesses and the bytes kept in flight are what approach
// it. The reductions are two-stage and deterministic: each block writes
// fp32/fp64 per-channel partials to a [G, 2, C] workspace and a finalize
// kernel sums the G partials in a fixed order. No atomics, so a step is
// bitwise repeatable on one card.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a width it cannot take);
// the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int TX = 32;         // channels per block of the finalize kernel
constexpr int FY = 32;         // partial lanes per channel in the finalize kernel
constexpr int THREADS = 256;   // threads per block of the four kernels
// Resident blocks per SM that the wrapper's G counts on: 3 x 256 threads leave
// 85 registers a thread. bwd_apply<bf16, 8> takes 80 (24 fp32 coefficients
// and 4 16-byte accesses of two inputs), stats and bwd_reduce 72, more than
// the 64 of 4 blocks.
constexpr int MIN_BLOCKS = 3;
constexpr int IN_FLIGHT = 8;   // 16-byte accesses in flight per thread in the reductions
constexpr int VUNROLL = 4;     // accesses in flight per input and thread in apply, bwd_apply

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T, typename A> __device__ __forceinline__ T from_acc(A v);
template <> __device__ __forceinline__ float from_acc<float, float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_acc<__half, float>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ double from_acc<double, double>(double v) { return v; }

// T(T(u) + T(v)): u and v each rounded to T, their sum in T (round to nearest
// even; __hadd of two halves or bfloat16s rounds their exact sum once).
template <typename T, typename A> __device__ __forceinline__ T sum_rounded(A u, A v) {
  if constexpr (std::is_same_v<T, A>) {
    return u + v;
  } else {
    return __hadd(from_acc<T, A>(u), from_acc<T, A>(v));
  }
}

// VEC neighbouring values of T moved as one access (16 bytes at the wide
// width); the alignment makes the compiler emit one vector load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// One access of a Pack; at 16 bytes, spelled as a uint4 so that it is one
// 128-bit load or store whatever T is.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  Pack<T, VEC> r;
  if constexpr (sizeof(r) == 16)
    *reinterpret_cast<uint4*>(&r) = *reinterpret_cast<const uint4*>(p);
  else
    r = *reinterpret_cast<const Pack<T, VEC>*>(p);
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  if constexpr (sizeof(v) == 16)
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&v);
  else
    *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// Where a thread of a THREADS-thread block sits for a row of C = groups * VEC
// channels: it owns channel group `group` (channels group*VEC ...) of row lane
// `lane`. per_row threads share a row and `rows` rows are covered per pass;
// threads past the last whole row, or past C in the last channel tile, are
// idle.
struct Lanes {
  int per_row, rows, group, lane;
  bool active;
  __device__ __forceinline__ explicit Lanes(int groups) {
    per_row = groups < THREADS ? groups : THREADS;
    rows = THREADS / per_row;
    group = blockIdx.y * per_row + threadIdx.x % per_row;
    lane = threadIdx.x / per_row;
    active = lane < rows && group < groups;
  }
};

// The contiguous row range [r0, r1) of this block: ceil(M / gridDim.x) rows,
// the last blocks possibly short or empty (the ragged tail is masked, so any
// M works).
__device__ __forceinline__ void row_range(int64_t m, int64_t& r0, int64_t& r1) {
  const int64_t per = (m + gridDim.x - 1) / gridDim.x;
  r0 = static_cast<int64_t>(blockIdx.x) * per;
  r1 = r0 + per < m ? r0 + per : m;
}

// s += a, q += a*b for the VEC channels of one access of each input.
template <typename T, int VEC, typename A>
__device__ __forceinline__ void accumulate(A (&s)[VEC], A (&q)[VEC], const Pack<T, VEC>& a,
                                           const Pack<T, VEC>& b) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const A ak = to_acc(a.v[k]);
    s[k] += ak;
    q[k] += ak * to_acc(b.v[k]);
  }
}

// Stage one of the reductions: per-channel (sum a, sum a*b) of this block's
// rows, with b = a where NIN = 1. Each thread sums its VEC channels over its
// rows in row order, then the block sums its row lanes in lane order through
// shared memory and writes its partials to ws[blockIdx.x, 0:2, :] for the
// channels of its tile. U = IN_FLIGHT / NIN accesses per input in flight:
// 128 bytes a thread at 16-byte width, whether it reads one input or two.
template <typename T, int VEC, int NIN>
__device__ __forceinline__ void reduce_rows(const T* __restrict__ a, const T* __restrict__ b,
                                            typename Acc<T>::type* __restrict__ ws, int64_t m,
                                            int C) {
  using A = typename Acc<T>::type;
  constexpr int U = IN_FLIGHT / NIN;
  const Lanes l(C / VEC);
  int64_t r0, r1;
  row_range(m, r0, r1);
  A s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = A(0);
  if (l.active) {
    const int64_t stride = static_cast<int64_t>(l.rows) * C;  // elements per pass
    int64_t r = r0 + l.lane;
    const T* ap = a + r * C + l.group * VEC;
    const T* bp = b + r * C + l.group * VEC;
    for (; r + (U - 1) * l.rows < r1; r += l.rows * U) {
      Pack<T, VEC> g[U], v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        g[u] = load_pack<T, VEC>(ap + u * stride);
        if constexpr (NIN == 2) v[u] = load_pack<T, VEC>(bp + u * stride);
      }
      ap += U * stride;
      bp += U * stride;
#pragma unroll
      for (int u = 0; u < U; ++u) accumulate<T, VEC, A>(s, q, g[u], NIN == 2 ? v[u] : g[u]);
    }
    for (; r < r1; r += l.rows, ap += stride, bp += stride) {
      const Pack<T, VEC> g = load_pack<T, VEC>(ap);
      accumulate<T, VEC, A>(s, q, g, NIN == 2 ? load_pack<T, VEC>(bp) : g);
    }
  }
  __shared__ A sh[2][THREADS * VEC];  // [sum][row lane * width + channel in tile]
  const int width = l.per_row * VEC;
  if (l.active) {
    const int j = l.lane * width + (threadIdx.x % l.per_row) * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sh[0][j + k] = s[k];
      sh[1][j + k] = q[k];
    }
  }
  __syncthreads();
  const int c0 = blockIdx.y * width;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int j = threadIdx.x; j < width && c0 + j < C; j += THREADS) {
    A S = 0, Q = 0;
    for (int k = 0; k < l.rows; ++k) {
      S += sh[0][k * width + j];
      Q += sh[1][k * width + j];
    }
    ws[base + c0 + j] = S;
    ws[base + C + c0 + j] = Q;
  }
}

// Replaces pallas_bn.py:_stats_kernel (per-channel sum and sum of squares,
// accumulated over the sequential Pallas grid). Bound: reads x once,
// M*C*sizeof(T) bytes. Stage one of two.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
stats_partial(const T* __restrict__ x, typename Acc<T>::type* __restrict__ ws, int64_t m, int C) {
  reduce_rows<T, VEC, 1>(x, x, ws, m, C);
}

// Replaces pallas_bn.py:_bwd_reduce_kernel (s1 = sum dy, s2 = sum dy*x).
// Bound: reads dy and x once, 2*M*C*sizeof(T) bytes. Stage one of two.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bwd_reduce_partial(const T* __restrict__ dy, const T* __restrict__ x,
                   typename Acc<T>::type* __restrict__ ws, int64_t m, int C) {
  reduce_rows<T, VEC, 2>(dy, x, ws, m, C);
}

// Stage two of stats and bwd_reduce: out[k, c] = sum over g of ws[g, k, c],
// summed by FY lanes in a fixed stride and then in lane order, so the result
// depends only on (M, C, G) and never on scheduling. Bound: reads the
// 2*G*C partials once (a few hundred KB).
template <typename A>
__global__ void __launch_bounds__(TX * FY)
finalize_partials(const A* __restrict__ ws, A* __restrict__ out, int G, int C) {
  __shared__ A sh[2][FY][TX];
  const int c = blockIdx.x * TX + threadIdx.x;
  A s = 0, q = 0;
  if (c < C) {
    for (int g = threadIdx.y; g < G; g += FY) {
      const int64_t base = static_cast<int64_t>(g) * 2 * C;
      s += ws[base + c];
      q += ws[base + C + c];
    }
  }
  sh[0][threadIdx.y][threadIdx.x] = s;
  sh[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    A S = 0, Q = 0;
    for (int k = 0; k < FY; ++k) {
      S += sh[0][k][threadIdx.x];
      Q += sh[1][k][threadIdx.x];
    }
    out[c] = S;
    out[C + c] = Q;
  }
}

// out = k0*a + k1 (NIN = 1) or k0*a + k1 + k2*b (NIN = 2), per channel, with
// k = coef[0:NIN+1, :] held in registers: VUNROLL accesses per input in
// flight, each rewritten in place and stored. SPLIT (NIN = 2) rounds k0*a and
// k1 + k2*b to T apart and adds the two in T.
template <typename T, int VEC, int NIN, bool SPLIT = false>
__device__ __forceinline__ void affine_rows(const T* __restrict__ a, const T* __restrict__ b,
                                            const typename Acc<T>::type* __restrict__ coef,
                                            T* __restrict__ out, int64_t m, int C) {
  using A = typename Acc<T>::type;
  const Lanes l(C / VEC);
  if (!l.active) return;
  int64_t r0, r1;
  row_range(m, r0, r1);
  const int c = l.group * VEC;
  A k[NIN + 1][VEC];
#pragma unroll
  for (int j = 0; j <= NIN; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) k[j][i] = coef[j * C + c + i];
  auto map = [&](Pack<T, VEC>& g, const Pack<T, VEC>& v) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (SPLIT) {
        g.v[i] = sum_rounded<T, A>(k[0][i] * to_acc(g.v[i]), k[1][i] + k[2][i] * to_acc(v.v[i]));
      } else {
        A y = k[0][i] * to_acc(g.v[i]) + k[1][i];
        if constexpr (NIN == 2) y += k[2][i] * to_acc(v.v[i]);
        g.v[i] = from_acc<T, A>(y);
      }
    }
  };
  const int64_t stride = static_cast<int64_t>(l.rows) * C;  // elements per pass
  int64_t r = r0 + l.lane;
  const T* ap = a + r * C + c;
  const T* bp = b + r * C + c;
  T* op = out + r * C + c;
  for (; r + (VUNROLL - 1) * l.rows < r1; r += l.rows * VUNROLL) {
    Pack<T, VEC> g[VUNROLL], v[VUNROLL];
#pragma unroll
    for (int u = 0; u < VUNROLL; ++u) {
      g[u] = load_pack<T, VEC>(ap + u * stride);
      if constexpr (NIN == 2) v[u] = load_pack<T, VEC>(bp + u * stride);
    }
#pragma unroll
    for (int u = 0; u < VUNROLL; ++u) {
      map(g[u], v[u]);
      store_pack<T, VEC>(op + u * stride, g[u]);
    }
    ap += VUNROLL * stride;
    bp += VUNROLL * stride;
    op += VUNROLL * stride;
  }
  for (; r < r1; r += l.rows, ap += stride, bp += stride, op += stride) {
    Pack<T, VEC> g = load_pack<T, VEC>(ap);
    map(g, NIN == 2 ? load_pack<T, VEC>(bp) : g);
    store_pack<T, VEC>(op, g);
  }
}

// Replaces pallas_bn.py:_apply_kernel: y = a*x + b with per-channel a = ab[0],
// b = ab[1]. Bound: reads x and writes y once, 2*M*C*sizeof(T) bytes.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
apply_kernel(const T* __restrict__ x, const typename Acc<T>::type* __restrict__ ab,
             T* __restrict__ y, int64_t m, int C) {
  affine_rows<T, VEC, 1>(x, x, ab, y, m, C);
}

// Replaces pallas_bn.py:_bwd_apply_kernel: dx = a*dy + c1 + c2*x with
// per-channel coef = [a, c1, c2], rounded once to T. With SPLIT, dx =
// T(a*dy) + T(c1 + c2*x): the dy path and the statistics' path rounded apart,
// then added in T. That is the dx autodiff gives the JAX model's BatchNorm
// (_TorchBatchNorm, models/layers.py), which casts x to float32 twice, once
// for the statistics and once to normalise; the model's BatchNorm2d takes it.
// For float and double the casts are no-ops. Bound (either): reads dy and x
// and writes dx once, 3*M*C*sizeof(T) bytes.
template <typename T, int VEC, bool SPLIT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                 const typename Acc<T>::type* __restrict__ coef, T* __restrict__ dx,
                 int64_t m, int C) {
  affine_rows<T, VEC, 2, SPLIT>(dy, x, coef, dx, m, C);
}

inline dim3 vec_grid(int G, int C, int vec) {
  const int groups = C / vec;
  return dim3(G, (groups + THREADS - 1) / THREADS);
}

// Calls launch(std::integral_constant<int, width>) for the width an entry
// point launches for `vec`: wide (16 bytes a thread) when asked and C and
// every pointer allow it, 1 when asked. Any other width is refused with
// cudaErrorInvalidValue before anything launches: a 16-byte access at an
// address that is not 16-byte aligned faults the context.
template <typename T, typename Launch>
int at_width(int vec, int C, std::initializer_list<const void*> ptrs, Launch launch) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec != 1) {
    bool ok = vec == WIDE && C % WIDE == 0;
    for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == WIDE)
    launch(std::integral_constant<int, WIDE>{});
  else
    launch(std::integral_constant<int, 1>{});
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
void finalize(const void* ws, void* out, int G, int C, cudaStream_t s) {
  finalize_partials<A><<<(C + TX - 1) / TX, dim3(TX, FY), 0, s>>>(
      static_cast<const A*>(ws), static_cast<A*>(out), G, C);
}

template <typename T>
int run_stats(const void* x, void* ws, void* out, int64_t m, int C, int G, int vec,
              cudaStream_t s) {
  using A = typename Acc<T>::type;
  return at_width<T>(vec, C, {x}, [&](auto w) {
    constexpr int V = decltype(w)::value;
    stats_partial<T, V><<<vec_grid(G, C, V), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<A*>(ws), m, C);
    finalize<A>(ws, out, G, C, s);
  });
}

template <typename T>
int run_bwd_reduce(const void* dy, const void* x, void* ws, void* out, int64_t m, int C, int G,
                   int vec, cudaStream_t s) {
  using A = typename Acc<T>::type;
  return at_width<T>(vec, C, {dy, x}, [&](auto w) {
    constexpr int V = decltype(w)::value;
    bwd_reduce_partial<T, V><<<vec_grid(G, C, V), THREADS, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<A*>(ws), m, C);
    finalize<A>(ws, out, G, C, s);
  });
}

template <typename T>
int run_apply(const void* x, const void* ab, void* y, int64_t m, int C, int G, int vec,
              cudaStream_t s) {
  using A = typename Acc<T>::type;
  return at_width<T>(vec, C, {x, y}, [&](auto w) {
    constexpr int V = decltype(w)::value;
    apply_kernel<T, V><<<vec_grid(G, C, V), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const A*>(ab), static_cast<T*>(y), m, C);
  });
}

template <typename T, bool SPLIT>
int run_bwd_apply(const void* dy, const void* x, const void* coef, void* dx, int64_t m, int C,
                  int G, int vec, cudaStream_t s) {
  using A = typename Acc<T>::type;
  return at_width<T>(vec, C, {dy, x, dx}, [&](auto w) {
    constexpr int V = decltype(w)::value;
    bwd_apply_kernel<T, V, SPLIT><<<vec_grid(G, C, V), THREADS, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const A*>(coef),
        static_cast<T*>(dx), m, C);
  });
}

}  // namespace

// Plain C entry points, one per kernel (bwd_apply_split: bwd_apply with SPLIT)
// and input type (f32, bf16, f16, f64), bound with ctypes by ops/bn.py. G is
// the number of row ranges (blockIdx.x); vec the channels a thread moves in
// one access: 1, or 16 / sizeof(T) where C and the [M, C] pointers allow it.
#define FBT_BN_ENTRY_POINTS(SUFFIX, T)                                                         \
  extern "C" int fbt_bn_stats_##SUFFIX(const void* x, void* ws, void* out, int64_t m, int C,   \
                                       int G, int vec, void* stream) {                         \
    return run_stats<T>(x, ws, out, m, C, G, vec, static_cast<cudaStream_t>(stream));          \
  }                                                                                            \
  extern "C" int fbt_bn_apply_##SUFFIX(const void* x, const void* ab, void* y, int64_t m,      \
                                       int C, int G, int vec, void* stream) {                  \
    return run_apply<T>(x, ab, y, m, C, G, vec, static_cast<cudaStream_t>(stream));            \
  }                                                                                            \
  extern "C" int fbt_bn_bwd_reduce_##SUFFIX(const void* dy, const void* x, void* ws,           \
                                            void* out, int64_t m, int C, int G, int vec,       \
                                            void* stream) {                                    \
    return run_bwd_reduce<T>(dy, x, ws, out, m, C, G, vec, static_cast<cudaStream_t>(stream)); \
  }                                                                                            \
  extern "C" int fbt_bn_bwd_apply_##SUFFIX(const void* dy, const void* x, const void* coef,    \
                                           void* dx, int64_t m, int C, int G, int vec,         \
                                           void* stream) {                                     \
    return run_bwd_apply<T, false>(dy, x, coef, dx, m, C, G, vec,                              \
                                   static_cast<cudaStream_t>(stream));                         \
  }                                                                                            \
  extern "C" int fbt_bn_bwd_apply_split_##SUFFIX(const void* dy, const void* x,                \
                                                 const void* coef, void* dx, int64_t m, int C, \
                                                 int G, int vec, void* stream) {               \
    return run_bwd_apply<T, true>(dy, x, coef, dx, m, C, G, vec,                               \
                                  static_cast<cudaStream_t>(stream));                          \
  }

FBT_BN_ENTRY_POINTS(f32, float)
FBT_BN_ENTRY_POINTS(bf16, __nv_bfloat16)
FBT_BN_ENTRY_POINTS(f16, __half)
FBT_BN_ENTRY_POINTS(f64, double)
