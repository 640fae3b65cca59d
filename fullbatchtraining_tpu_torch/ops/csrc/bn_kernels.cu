// Train-mode BatchNorm kernels for Hopper (sm_90a), the CUDA counterparts of
// the four Pallas kernels in fullbatchtraining_tpu/ops/pallas_bn.py.
//
// Every kernel works on the row-major [M, C] view of a channels-last
// activation: row r is one (n, h, w) position, column c one channel. Each
// block takes one contiguous range of rows (blockIdx.x), so a thread keeps
// its channels (and their per-channel coefficients or sums) in registers for
// its whole range. Two layouts:
//
// * stats and bwd_apply: blocks of 32 x 8 threads. threadIdx.x walks 32
//   neighbouring channels of a row, threadIdx.y walks rows, blockIdx.y picks
//   the 32-channel tile. One scalar access per element, 4 rows in flight.
// * apply and bwd_reduce: blocks of THREADS threads in a line. A thread owns
//   VEC neighbouring channels and moves them as one access: 16 bytes (VEC = 8
//   in bf16, 4 in f32, 2 in f64) where C is a multiple of VEC and the base
//   pointers are 16-byte aligned, else VEC = 1 (the wrapper picks, the entry
//   point checks). C / VEC threads share a row, so a block covers
//   THREADS / (C / VEC) whole rows per pass (32 rows at C = 64 in bf16) and a
//   warp reads one contiguous run of memory; blockIdx.y picks a tile of
//   THREADS groups only where a row has more (C > 2048 in bf16). Each thread
//   keeps VUNROLL accesses per input in flight: 64 bytes at 16-byte width.
//   The row loop runs whole groups of VUNROLL rows with no bounds check and
//   then the ragged tail one row at a time: with a check on every access
//   ptxas kept more values live and bwd_reduce spilled in bf16.
//
// Types: T is float, __nv_bfloat16 or double; every sum and coefficient is
// in A = promote(T, float), i.e. float for float/bf16 and double for double.
//
// Bound: all four are memory-bound (a few flops per element against 2 to 8
// bytes moved), so the least time is the bytes below over the card's memory
// rate. With one scalar access per element a bf16 kernel keeps 2 bytes a
// thread per row in flight, too few to cover HBM's latency; the 16-byte
// layout is the answer for apply and bwd_reduce. The reductions (stats,
// bwd_reduce) are two-stage and deterministic: each block writes fp32/fp64
// per-channel partials to a [G, 2, C] workspace and a finalize kernel sums
// the G partials in a fixed order. No atomics, so a step is bitwise
// repeatable on one card.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a width it cannot take);
// the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int TX = 32;      // channels per block
constexpr int TY = 8;       // row lanes per block
constexpr int UNROLL = 4;   // rows in flight per thread
constexpr int FY = 32;      // partial lanes per channel in the finalize kernel
constexpr int THREADS = 256;   // threads per block of apply and bwd_reduce
constexpr int VUNROLL = 4;     // accesses in flight per input and thread (apply, bwd_reduce)
// Resident blocks per SM that the wrapper's G counts on: 3 x 256 threads leave
// 85 registers a thread. bwd_reduce<bf16, 8> takes 72 (VUNROLL 16-byte
// accesses of two inputs and 16 fp32 sums), more than the 64 of 4 blocks.
constexpr int MIN_BLOCKS = 3;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T, typename A> __device__ __forceinline__ T from_acc(A v);
template <> __device__ __forceinline__ float from_acc<float, float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ double from_acc<double, double>(double v) { return v; }

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

// Sums the TY row lanes of a block in a fixed order and writes the block's
// two partials for channel c to ws[blockIdx.x, 0:2, c].
template <typename A>
__device__ __forceinline__ void write_partials(A s, A q, A* __restrict__ ws, int c, int C) {
  __shared__ A sh[2][TY][TX];
  sh[0][threadIdx.y][threadIdx.x] = s;
  sh[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    A S = 0, Q = 0;
    for (int k = 0; k < TY; ++k) {
      S += sh[0][k][threadIdx.x];
      Q += sh[1][k][threadIdx.x];
    }
    const int64_t base = static_cast<int64_t>(blockIdx.x) * 2 * C;
    ws[base + c] = S;
    ws[base + C + c] = Q;
  }
}

// Replaces pallas_bn.py:_stats_kernel (per-channel sum and sum of squares,
// accumulated over the sequential Pallas grid). Bound: reads x once,
// M*C*sizeof(T) bytes. Stage one of two: block partials of (sum x, sum x^2).
template <typename T>
__global__ void __launch_bounds__(TX * TY)
stats_partial(const T* __restrict__ x, typename Acc<T>::type* __restrict__ ws, int64_t m, int C) {
  using A = typename Acc<T>::type;
  const int c = blockIdx.y * TX + threadIdx.x;
  int64_t r0, r1;
  row_range(m, r0, r1);
  A s = 0, q = 0;
  if (c < C) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += TY * UNROLL) {
      A v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t rr = r + u * TY;
        v[u] = rr < r1 ? to_acc(x[rr * C + c]) : A(0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s += v[u];
        q += v[u] * v[u];
      }
    }
  }
  write_partials<A>(s, q, ws, c, C);
}

// Replaces pallas_bn.py:_bwd_reduce_kernel (s1 = sum dy, s2 = sum dy*x).
// Bound: reads dy and x once, 2*M*C*sizeof(T) bytes. Stage one of two: each
// thread sums its VEC channels over its rows, then the block sums its row
// lanes in lane order through shared memory and writes its partials to
// ws[blockIdx.x, 0:2, :] for the channels of its tile.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bwd_reduce_partial(const T* __restrict__ dy, const T* __restrict__ x,
                   typename Acc<T>::type* __restrict__ ws, int64_t m, int C) {
  using A = typename Acc<T>::type;
  const Lanes l(C / VEC);
  int64_t r0, r1;
  row_range(m, r0, r1);
  A s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = A(0);
  if (l.active) {
    const int64_t stride = static_cast<int64_t>(l.rows) * C;  // elements per pass
    int64_t r = r0 + l.lane;
    const T* dp = dy + r * C + l.group * VEC;
    const T* xp = x + r * C + l.group * VEC;
    for (; r + (VUNROLL - 1) * l.rows < r1; r += l.rows * VUNROLL) {
      Pack<T, VEC> g[VUNROLL], v[VUNROLL];
#pragma unroll
      for (int u = 0; u < VUNROLL; ++u) {
        g[u] = load_pack<T, VEC>(dp + u * stride);
        v[u] = load_pack<T, VEC>(xp + u * stride);
      }
      dp += VUNROLL * stride;
      xp += VUNROLL * stride;
#pragma unroll
      for (int u = 0; u < VUNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const A gk = to_acc(g[u].v[k]);
          s[k] += gk;
          q[k] += gk * to_acc(v[u].v[k]);
        }
      }
    }
    for (; r < r1; r += l.rows, dp += stride, xp += stride) {
      const Pack<T, VEC> g = load_pack<T, VEC>(dp), v = load_pack<T, VEC>(xp);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const A gk = to_acc(g.v[k]);
        s[k] += gk;
        q[k] += gk * to_acc(v.v[k]);
      }
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

// Replaces pallas_bn.py:_apply_kernel: y = a*x + b with per-channel a = ab[0],
// b = ab[1]. Bound: reads x and writes y once, 2*M*C*sizeof(T) bytes.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
apply_kernel(const T* __restrict__ x, const typename Acc<T>::type* __restrict__ ab,
             T* __restrict__ y, int64_t m, int C) {
  using A = typename Acc<T>::type;
  const Lanes l(C / VEC);
  if (!l.active) return;
  int64_t r0, r1;
  row_range(m, r0, r1);
  const int c = l.group * VEC;
  A a[VEC], b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a[k] = ab[c + k];
    b[k] = ab[C + c + k];
  }
  const int64_t stride = static_cast<int64_t>(l.rows) * C;  // elements per pass
  int64_t r = r0 + l.lane;
  const T* xp = x + r * C + c;
  T* yp = y + r * C + c;
  for (; r + (VUNROLL - 1) * l.rows < r1; r += l.rows * VUNROLL) {
    Pack<T, VEC> v[VUNROLL];
#pragma unroll
    for (int u = 0; u < VUNROLL; ++u) v[u] = load_pack<T, VEC>(xp + u * stride);
#pragma unroll
    for (int u = 0; u < VUNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[u].v[k] = from_acc<T, A>(a[k] * to_acc(v[u].v[k]) + b[k]);
      store_pack<T, VEC>(yp + u * stride, v[u]);
    }
    xp += VUNROLL * stride;
    yp += VUNROLL * stride;
  }
  for (; r < r1; r += l.rows, xp += stride, yp += stride) {
    Pack<T, VEC> v = load_pack<T, VEC>(xp);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v.v[k] = from_acc<T, A>(a[k] * to_acc(v.v[k]) + b[k]);
    store_pack<T, VEC>(yp, v);
  }
}

// Replaces pallas_bn.py:_bwd_apply_kernel: dx = a*dy + c1 + c2*x with
// per-channel coef = [a, c1, c2]. Bound: reads dy and x and writes dx once,
// 3*M*C*sizeof(T) bytes.
template <typename T>
__global__ void __launch_bounds__(TX * TY)
bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                 const typename Acc<T>::type* __restrict__ coef, T* __restrict__ dx,
                 int64_t m, int C) {
  using A = typename Acc<T>::type;
  const int c = blockIdx.y * TX + threadIdx.x;
  if (c >= C) return;
  int64_t r0, r1;
  row_range(m, r0, r1);
  const A a = coef[c];
  const A c1 = coef[C + c];
  const A c2 = coef[2 * C + c];
  for (int64_t r = r0 + threadIdx.y; r < r1; r += TY * UNROLL) {
    A g[UNROLL], v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = r + u * TY;
      const bool in = rr < r1;
      g[u] = in ? to_acc(dy[rr * C + c]) : A(0);
      v[u] = in ? to_acc(x[rr * C + c]) : A(0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = r + u * TY;
      if (rr < r1) dx[rr * C + c] = from_acc<T, A>(a * g[u] + c1 + c2 * v[u]);
    }
  }
}

inline dim3 row_grid(int G, int C) { return dim3(G, (C + TX - 1) / TX); }

template <typename T>
int run_stats(const void* x, void* ws, void* out, int64_t m, int C, int G, void* stream) {
  using A = typename Acc<T>::type;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_partial<T><<<row_grid(G, C), dim3(TX, TY), 0, s>>>(
      static_cast<const T*>(x), static_cast<A*>(ws), m, C);
  finalize_partials<A><<<(C + TX - 1) / TX, dim3(TX, FY), 0, s>>>(
      static_cast<const A*>(ws), static_cast<A*>(out), G, C);
  return static_cast<int>(cudaGetLastError());
}

// The width an entry point launches for `vec`: wide (16 bytes a thread) when
// asked and C and every pointer allow it, 1 when asked; 0 for anything else.
template <typename T>
int checked_width(int vec, int C, std::initializer_list<const void*> ptrs) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == 1) return 1;
  if (vec != WIDE || C % WIDE != 0) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  return WIDE;
}

inline dim3 vec_grid(int G, int C, int vec) {
  const int groups = C / vec;
  return dim3(G, (groups + THREADS - 1) / THREADS);
}

template <typename T>
int run_bwd_reduce(const void* dy, const void* x, void* ws, void* out, int64_t m, int C, int G,
                   int vec, void* stream) {
  using A = typename Acc<T>::type;
  constexpr int WIDE = 16 / sizeof(T);
  const int width = checked_width<T>(vec, C, {dy, x});
  if (width == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(dy);
  const T* v = static_cast<const T*>(x);
  A* w = static_cast<A*>(ws);
  if (width == WIDE)
    bwd_reduce_partial<T, WIDE><<<vec_grid(G, C, WIDE), THREADS, 0, s>>>(d, v, w, m, C);
  else
    bwd_reduce_partial<T, 1><<<vec_grid(G, C, 1), THREADS, 0, s>>>(d, v, w, m, C);
  finalize_partials<A><<<(C + TX - 1) / TX, dim3(TX, FY), 0, s>>>(w, static_cast<A*>(out), G, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_apply(const void* x, const void* ab, void* y, int64_t m, int C, int G, int vec,
              void* stream) {
  using A = typename Acc<T>::type;
  constexpr int WIDE = 16 / sizeof(T);
  const int width = checked_width<T>(vec, C, {x, y});
  if (width == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(x);
  const A* k = static_cast<const A*>(ab);
  T* o = static_cast<T*>(y);
  if (width == WIDE)
    apply_kernel<T, WIDE><<<vec_grid(G, C, WIDE), THREADS, 0, s>>>(v, k, o, m, C);
  else
    apply_kernel<T, 1><<<vec_grid(G, C, 1), THREADS, 0, s>>>(v, k, o, m, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_bwd_apply(const void* dy, const void* x, const void* coef, void* dx, int64_t m, int C,
                  int G, void* stream) {
  using A = typename Acc<T>::type;
  bwd_apply_kernel<T><<<row_grid(G, C), dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const A*>(coef),
      static_cast<T*>(dx), m, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, one per kernel and input type (f32, bf16, f64), bound
// with ctypes by ops/bn.py. G is the number of row ranges (blockIdx.x); vec,
// for apply and bwd_reduce, the channels a thread moves in one access: 1, or
// 16 / sizeof(T) where C and the pointers allow it.
#define FBT_BN_ENTRY_POINTS(SUFFIX, T)                                                        \
  extern "C" int fbt_bn_stats_##SUFFIX(const void* x, void* ws, void* out, int64_t m, int C,  \
                                       int G, void* stream) {                                 \
    return run_stats<T>(x, ws, out, m, C, G, stream);                                         \
  }                                                                                           \
  extern "C" int fbt_bn_apply_##SUFFIX(const void* x, const void* ab, void* y, int64_t m,     \
                                       int C, int G, int vec, void* stream) {                 \
    return run_apply<T>(x, ab, y, m, C, G, vec, stream);                                      \
  }                                                                                           \
  extern "C" int fbt_bn_bwd_reduce_##SUFFIX(const void* dy, const void* x, void* ws,          \
                                            void* out, int64_t m, int C, int G, int vec,      \
                                            void* stream) {                                   \
    return run_bwd_reduce<T>(dy, x, ws, out, m, C, G, vec, stream);                           \
  }                                                                                           \
  extern "C" int fbt_bn_bwd_apply_##SUFFIX(const void* dy, const void* x, const void* coef,   \
                                           void* dx, int64_t m, int C, int G, void* stream) { \
    return run_bwd_apply<T>(dy, x, coef, dx, m, C, G, stream);                                \
  }

FBT_BN_ENTRY_POINTS(f32, float)
FBT_BN_ENTRY_POINTS(bf16, __nv_bfloat16)
FBT_BN_ENTRY_POINTS(f64, double)
