// Average pool over disjoint k x k windows (window == stride == k, no
// padding) of a channels-last activation, forward and backward, for Hopper
// (sm_90a): the pool of ResNet's downsample-C shortcut, of DenseNet's
// transitions and of PyramidNet's shortcuts (models/layers.py avg_pool).
//
// No TPU kernel stands behind these: the JAX package leaves the pool to XLA,
// which fuses it. They replace ATen's NHWC avg_pool2d kernels, which move one
// element a thread and divide 64-bit indices per element, and ran ResNet-18's
// pools at 4% (backward) and 12% (forward) of an H100's memory rate.
//
// Layout: x is [N, H, W, C] in memory (an NCHW tensor in channels_last), H and
// W multiples of k; y is [N, H/k, W/k, C]. A thread owns VEC neighbouring
// channels of one output pixel and moves them as one access: 16 bytes (VEC = 8
// in bf16 and f16, 4 in f32, 2 in f64) where C is a multiple of VEC and both
// pointers are 16-byte aligned, else VEC = 1 (the wrapper picks, the entry
// point checks). Consecutive threads take consecutive channel groups, then
// consecutive output columns, so a warp's accesses cover whole runs of a row.
//
// Arithmetic: ATen's, so the results are bitwise those of F.avg_pool2d and its
// gradient. Forward: s = 0, then s += x over the window's rows and, within a
// row, its columns, in A = promote(T, float); y = T(s / (k*k)). Backward: each
// input position lies in exactly one window, so dx = T(A(0) + A(T(A(dy) /
// (k*k)))): ATen divides the gradient in T's own arithmetic (for bf16 and f16,
// a float quotient rounded to T) and adds it to a zero in A. The zero is kept:
// 0 + (-0) is +0.
//
// Bound: memory. The forward reads the input once and writes a quarter of it
// (k = 2), the backward the reverse, so each moves 1.25 times the input's
// bytes; a thread keeps its k*k 16-byte accesses in flight at k = 2.
//
// Both kernels walk the outputs (the grad-output vectors) with a grid-stride
// loop. Offsets are 64-bit (an ImageNet chunk passes 2^31 elements); the
// index is 32-bit, which makes its two divisions cheap, and an entry point
// refuses a launch whose loop would pass 2^32 (ops/pool.py routes such a
// size to F.avg_pool2d). Every entry point launches on the caller's stream
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a width or a
// size it cannot take; the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;

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

// VEC neighbouring values of T, moved as one access (one 128-bit load or
// store at 16 bytes, whatever T is).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

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

// Where item i (an output vector, in [rows, Wo, C / VEC] order) reads or
// writes: `out` is its offset in the pooled tensor, `in` the offset of the
// window's first pixel in the full one (row q * k, column wo * k).
struct Item {
  int64_t out, in;
  __device__ __forceinline__ Item(uint32_t i, uint32_t groups, uint32_t wo_count, int VEC,
                                  int k, int64_t W, int64_t C) {
    const uint32_t p = i / groups;
    const uint32_t cg = i - p * groups;
    const uint32_t q = p / wo_count;
    const uint32_t wo = p - q * wo_count;
    out = static_cast<int64_t>(i) * VEC;
    in = (static_cast<int64_t>(q) * k * W + static_cast<int64_t>(wo) * k) * C +
         static_cast<int64_t>(cg) * VEC;
  }
};

}  // namespace

// Forward: y = mean of each k x k window. K is k where it is known when
// compiling (2: every window of the port's models), so a thread's k*k loads
// are all in flight before its sums; 0 takes k at run time.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(THREADS)
avg_pool_nhwc_fwd(const T* __restrict__ x, T* __restrict__ y, uint32_t items, uint32_t groups,
                  uint32_t wo_count, int k_run, int64_t W, int64_t C) {
  using A = typename Acc<T>::type;
  const int k = K ? K : k_run;
  const A div = static_cast<A>(k * k);
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < items; i += gridDim.x * THREADS) {
    const Item at(i, groups, wo_count, VEC, k, W, C);
    A s[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = A(0);
    if constexpr (K > 0) {
      Pack<T, VEC> v[K * K];
#pragma unroll
      for (int dh = 0; dh < K; ++dh)
#pragma unroll
        for (int dw = 0; dw < K; ++dw)
          v[dh * K + dw] = load_pack<T, VEC>(x + at.in + (dh * W + dw) * C);
#pragma unroll
      for (int j = 0; j < K * K; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[e] += to_acc(v[j].v[e]);
    } else {
      for (int dh = 0; dh < k; ++dh)
        for (int dw = 0; dw < k; ++dw) {
          const Pack<T, VEC> v = load_pack<T, VEC>(x + at.in + (dh * W + dw) * C);
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[e] += to_acc(v.v[e]);
        }
    }
    Pack<T, VEC> out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = from_acc<T, A>(s[e] / div);
    store_pack<T, VEC>(y + at.out, out);
  }
}

// Backward: dx = dy / (k*k) at each of its window's k*k positions.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(THREADS)
avg_pool_nhwc_bwd(const T* __restrict__ dy, T* __restrict__ dx, uint32_t items,
                  uint32_t groups, uint32_t wo_count, int k_run, int64_t W, int64_t C) {
  using A = typename Acc<T>::type;
  const int k = K ? K : k_run;
  const A div = static_cast<A>(k * k);
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < items; i += gridDim.x * THREADS) {
    const Item at(i, groups, wo_count, VEC, k, W, C);
    const Pack<T, VEC> g = load_pack<T, VEC>(dy + at.out);
    Pack<T, VEC> v;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v.v[e] = from_acc<T, A>(A(0) + to_acc(from_acc<T, A>(to_acc(g.v[e]) / div)));
    if constexpr (K > 0) {
#pragma unroll
      for (int dh = 0; dh < K; ++dh)
#pragma unroll
        for (int dw = 0; dw < K; ++dw) store_pack<T, VEC>(dx + at.in + (dh * W + dw) * C, v);
    } else {
      for (int dh = 0; dh < k; ++dh)
        for (int dw = 0; dw < k; ++dw) store_pack<T, VEC>(dx + at.in + (dh * W + dw) * C, v);
    }
  }
}

namespace {

// Launches kernel<T, VEC, K> over rows * wo_count * (C / VEC) items: the
// width `vec` asks for (1, or 16 bytes where C and both pointers allow it;
// anything else is refused with cudaErrorInvalidValue before a launch, since
// a 16-byte access at an unaligned address faults the context), K = 2 or run
// time. A launch whose 32-bit index would wrap is refused the same way.
template <typename T, bool FWD>
int run(const void* src, void* dst, int64_t rows, int64_t wo_count, int64_t C, int k, int grid,
        int vec, cudaStream_t s) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec != 1 && (vec != WIDE || C % WIDE != 0 || reinterpret_cast<uintptr_t>(src) % 16 ||
                   reinterpret_cast<uintptr_t>(dst) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = rows * wo_count * (C / vec);
  if (items == 0) return static_cast<int>(cudaSuccess);
  if (items + static_cast<int64_t>(grid) * THREADS > (int64_t(1) << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t W = wo_count * k;
  auto launch = [&](auto width, auto kc) {
    constexpr int V = decltype(width)::value;
    constexpr int KC = decltype(kc)::value;
    const T* a = static_cast<const T*>(src);
    T* b = static_cast<T*>(dst);
    const auto n = static_cast<uint32_t>(items), groups = static_cast<uint32_t>(C / V),
               wo = static_cast<uint32_t>(wo_count);
    if constexpr (FWD)
      avg_pool_nhwc_fwd<T, V, KC><<<grid, THREADS, 0, s>>>(a, b, n, groups, wo, k, W, C);
    else
      avg_pool_nhwc_bwd<T, V, KC><<<grid, THREADS, 0, s>>>(a, b, n, groups, wo, k, W, C);
  };
  auto at_k = [&](auto width) {
    if (k == 2)
      launch(width, std::integral_constant<int, 2>{});
    else
      launch(width, std::integral_constant<int, 0>{});
  };
  if (vec == WIDE)
    at_k(std::integral_constant<int, WIDE>{});
  else
    at_k(std::integral_constant<int, 1>{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes by ops/pool.py: fwd pools src
// [rows * k, wo_count * k, C] into dst [rows, wo_count, C]; bwd spreads the
// gradient src [rows, wo_count, C] over dst [rows * k, wo_count * k, C]
// (rows = N * H / k). grid is the number of blocks; vec the channels a thread
// moves in one access: 1, or 16 / sizeof(T) where C and both pointers allow.
#define FBT_POOL_ENTRY_POINTS(SUFFIX, T)                                                     \
  extern "C" int fbt_pool_fwd_##SUFFIX(const void* x, void* y, int64_t rows, int64_t wo,     \
                                       int64_t C, int k, int grid, int vec, void* stream) {  \
    return run<T, true>(x, y, rows, wo, C, k, grid, vec, static_cast<cudaStream_t>(stream)); \
  }                                                                                          \
  extern "C" int fbt_pool_bwd_##SUFFIX(const void* dy, void* dx, int64_t rows, int64_t wo,   \
                                       int64_t C, int k, int grid, int vec, void* stream) {  \
    return run<T, false>(dy, dx, rows, wo, C, k, grid, vec,                                  \
                         static_cast<cudaStream_t>(stream));                                 \
  }

FBT_POOL_ENTRY_POINTS(f32, float)
FBT_POOL_ENTRY_POINTS(bf16, __nv_bfloat16)
FBT_POOL_ENTRY_POINTS(f16, __half)
FBT_POOL_ENTRY_POINTS(f64, double)
