// Train-mode BatchNorm kernels for Hopper (sm_90a), the CUDA counterparts of
// the four Pallas kernels in fullbatchtraining_tpu/ops/pallas_bn.py.
//
// Every kernel works on the row-major [M, C] view of a channels-last
// activation: row r is one (n, h, w) position, column c one channel. Blocks
// are 32 x 8 threads. threadIdx.x walks 32 neighbouring channels of a row, so
// a warp reads one contiguous run of a row (coalesced for the C = 64 ... 512
// of ResNet-18); threadIdx.y walks rows. blockIdx.y picks the 32-channel
// tile and blockIdx.x one contiguous range of rows, so a thread keeps its
// channel (and its per-channel coefficients) in registers for its whole
// range. The row loop is unrolled by 4 to keep several loads in flight.
//
// Types: T is float, __nv_bfloat16 or double; every sum and coefficient is
// in A = promote(T, float), i.e. float for float/bf16 and double for double.
//
// Bound: all four are memory-bound (a few flops per element against 2 to 8
// bytes moved), so the least time is the bytes below over the card's memory
// rate. The reductions (stats, bwd_reduce) are two-stage and deterministic:
// each block writes fp32/fp64 per-channel partials to a [G, 2, C] workspace
// and a finalize kernel sums the G partials in a fixed order. No atomics, so
// a step is bitwise repeatable on one card.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int TX = 32;      // channels per block
constexpr int TY = 8;       // row lanes per block
constexpr int UNROLL = 4;   // rows in flight per thread
constexpr int FY = 32;      // partial lanes per channel in the finalize kernel

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
// Bound: reads dy and x once, 2*M*C*sizeof(T) bytes. Stage one of two.
template <typename T>
__global__ void __launch_bounds__(TX * TY)
bwd_reduce_partial(const T* __restrict__ dy, const T* __restrict__ x,
                   typename Acc<T>::type* __restrict__ ws, int64_t m, int C) {
  using A = typename Acc<T>::type;
  const int c = blockIdx.y * TX + threadIdx.x;
  int64_t r0, r1;
  row_range(m, r0, r1);
  A s = 0, q = 0;
  if (c < C) {
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
        s += g[u];
        q += g[u] * v[u];
      }
    }
  }
  write_partials<A>(s, q, ws, c, C);
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
template <typename T>
__global__ void __launch_bounds__(TX * TY)
apply_kernel(const T* __restrict__ x, const typename Acc<T>::type* __restrict__ ab,
             T* __restrict__ y, int64_t m, int C) {
  using A = typename Acc<T>::type;
  const int c = blockIdx.y * TX + threadIdx.x;
  if (c >= C) return;
  int64_t r0, r1;
  row_range(m, r0, r1);
  const A a = ab[c];
  const A b = ab[C + c];
  for (int64_t r = r0 + threadIdx.y; r < r1; r += TY * UNROLL) {
    A v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = r + u * TY;
      v[u] = rr < r1 ? to_acc(x[rr * C + c]) : A(0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = r + u * TY;
      if (rr < r1) y[rr * C + c] = from_acc<T, A>(a * v[u] + b);
    }
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

template <typename T>
int run_bwd_reduce(const void* dy, const void* x, void* ws, void* out, int64_t m, int C, int G,
                   void* stream) {
  using A = typename Acc<T>::type;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_reduce_partial<T><<<row_grid(G, C), dim3(TX, TY), 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<A*>(ws), m, C);
  finalize_partials<A><<<(C + TX - 1) / TX, dim3(TX, FY), 0, s>>>(
      static_cast<const A*>(ws), static_cast<A*>(out), G, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_apply(const void* x, const void* ab, void* y, int64_t m, int C, int G, void* stream) {
  using A = typename Acc<T>::type;
  apply_kernel<T><<<row_grid(G, C), dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const A*>(ab), static_cast<T*>(y), m, C);
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
// with ctypes by ops/bn.py. G is the number of row ranges (blockIdx.x).
#define FBT_BN_ENTRY_POINTS(SUFFIX, T)                                                        \
  extern "C" int fbt_bn_stats_##SUFFIX(const void* x, void* ws, void* out, int64_t m, int C,  \
                                       int G, void* stream) {                                 \
    return run_stats<T>(x, ws, out, m, C, G, stream);                                         \
  }                                                                                           \
  extern "C" int fbt_bn_apply_##SUFFIX(const void* x, const void* ab, void* y, int64_t m,     \
                                       int C, int G, void* stream) {                          \
    return run_apply<T>(x, ab, y, m, C, G, stream);                                           \
  }                                                                                           \
  extern "C" int fbt_bn_bwd_reduce_##SUFFIX(const void* dy, const void* x, void* ws,          \
                                            void* out, int64_t m, int C, int G,               \
                                            void* stream) {                                   \
    return run_bwd_reduce<T>(dy, x, ws, out, m, C, G, stream);                                \
  }                                                                                           \
  extern "C" int fbt_bn_bwd_apply_##SUFFIX(const void* dy, const void* x, const void* coef,   \
                                           void* dx, int64_t m, int C, int G, void* stream) { \
    return run_bwd_apply<T>(dy, x, coef, dx, m, C, G, stream);                                \
  }

FBT_BN_ENTRY_POINTS(f32, float)
FBT_BN_ENTRY_POINTS(bf16, __nv_bfloat16)
FBT_BN_ENTRY_POINTS(f64, double)
