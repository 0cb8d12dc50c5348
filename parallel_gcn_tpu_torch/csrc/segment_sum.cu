// Ordered segment sums over the CSR of an index vector, for sm_90a.
//
// No Pallas kernel: the JAX package sums its COO residual with XLA's
// jax.ops.segment_sum over sorted ids (parallel_gcn_tpu/ops/graphsum.py:45-66),
// which is deterministic on the TPU. PyTorch's index_add_ on the card adds in
// the order its atomics land, so two runs of one training differ in the last
// bits. These kernels add every segment's items in item order, with no
// atomics, so a run is reproducible bit for bit:
//
//   pgcn_gather_sum  (a): out[i, c] = Σ_{k ∈ [ptr[i], ptr[i+1])} v_e · x[src[e], c],
//                         e = perm[k] (or k), v_e = val[e] rounded to x's type;
//                         the GCN's hybrid residual without its [E, F] product;
//   pgcn_segment_sum (b): out[i, c] += Σ_{k ∈ [ptr[i], ptr[i+1])} values[e, c],
//                         in place (out's rows ldo elements apart, so a column
//                         slice of a kernel's output takes the sums); the GAT
//                         residual's per-edge terms, the halo's cotangent.
//
// Both accumulate in float32 and store each output once, in the output's
// type. In float32 every add is one rounding in item order (no FMA): the
// result equals PyTorch's index_add_ on the CPU, which adds in item order,
// bit for bit. In bf16, (a) multiplies exactly in f32 and rounds once at the
// store, where index_add_ rounds the product and every partial sum to bf16.
//
// What bounds it on an H100: memory. The index (ptr, perm, src, val) is read
// once per output chunk and the gathered rows of x once per item; (a)
// writes its output once (the caller zeroes it, the kernel writes the rows
// that have items), (b) reads and writes only those rows. Design: a group
// of G threads owns one (segment, 2G-column chunk) and walks the segment's
// items in order, each thread keeping two columns' sums in registers; G is
// the smallest power of two that covers half the row (1 for the GAT's
// [E, 2] denominators, 32 for rows of 64 columns or more), so narrow rows
// pack many segments into a warp. The groups walk only the live segments
// (the Segments' list of those with items: a residual of 115K edges over
// 233K rows leaves most rows empty). A group's threads read neighbouring
// columns of one gathered row, and start the loads of kUnroll items before
// adding them in order. A segment's items are summed by one group in
// turn: a hub segment is as long as its items.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // items whose loads a thread has in flight together

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// this thread's (segment, first column): groups walk the live segments (those
// with items) in order; false past the last group
template <int G>
__device__ __forceinline__ bool group_of(const int32_t* live, int n_live, int n_chunks,
                                         int* seg, int* c0) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t group = tid / G;
  if (group >= (int64_t)n_live * n_chunks) return false;
  *seg = live[group / n_chunks];
  *c0 = (int)(group % n_chunks) * 2 * G + (int)(tid % G);
  return true;
}

// item k's value (or gathered row) at the thread's two columns; the loads of
// kUnroll items are started before their adds, which stay in item order
template <typename T>
struct Gather {
  const int32_t* perm;
  const int64_t* src;
  const float* val;
  const T* x;
  int F;
  __device__ __forceinline__ void load(int k, int c0, int c1, bool has0, bool has1,
                                       float* v, float* a0, float* a1) const {
    const int e = perm ? perm[k] : k;
    *v = to_f32<T>(from_f32<T>(val[e]));  // val as x's type, as JAX casts it
    const T* row = x + src[e] * (int64_t)F;
    *a0 = has0 ? to_f32<T>(row[c0]) : 0.f;
    *a1 = has1 ? to_f32<T>(row[c1]) : 0.f;
  }
  // one rounding for the product, one for the sum (no FMA)
  __device__ __forceinline__ static float add(float acc, float v, float a) {
    return __fadd_rn(acc, __fmul_rn(v, a));
  }
};

template <typename T>
struct Terms {
  const int32_t* perm;
  const T* values;
  int W;
  __device__ __forceinline__ void load(int k, int c0, int c1, bool has0, bool has1,
                                       float* v, float* a0, float* a1) const {
    const int e = perm ? perm[k] : k;
    const T* row = values + (int64_t)e * W;
    *v = 1.f;
    *a0 = has0 ? to_f32<T>(row[c0]) : 0.f;
    *a1 = has1 ? to_f32<T>(row[c1]) : 0.f;
  }
  __device__ __forceinline__ static float add(float acc, float, float a) {
    return __fadd_rn(acc, a);
  }
};

// acc += the items [begin, end) in order, kUnroll items' loads in flight
template <typename Items>
__device__ __forceinline__ void sum_items(const Items& items, int begin, int end, int c0,
                                          int c1, bool has0, bool has1, float* acc0,
                                          float* acc1) {
  int k = begin;
  for (; k + kUnroll <= end; k += kUnroll) {
    float v[kUnroll], a0[kUnroll], a1[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      items.load(k + j, c0, c1, has0, has1, &v[j], &a0[j], &a1[j]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      *acc0 = Items::add(*acc0, v[j], a0[j]);
      *acc1 = Items::add(*acc1, v[j], a1[j]);
    }
  }
  for (; k < end; ++k) {
    float v, a0, a1;
    items.load(k, c0, c1, has0, has1, &v, &a0, &a1);
    *acc0 = Items::add(*acc0, v, a0);
    *acc1 = Items::add(*acc1, v, a1);
  }
}

// (a): the live rows of out (zeroed by the caller) get their gather-sums
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const int32_t* __restrict__ ptr, const int32_t* __restrict__ live,
                  int n_live, Gather<T> items, T* __restrict__ out, int n_chunks) {
  int seg, c0;
  if (!group_of<G>(live, n_live, n_chunks, &seg, &c0)) return;
  const int F = items.F, c1 = c0 + G;
  const bool has0 = c0 < F, has1 = c1 < F;
  float acc0 = 0.f, acc1 = 0.f;
  sum_items(items, ptr[seg], ptr[seg + 1], c0, c1, has0, has1, &acc0, &acc1);
  T* o = out + (int64_t)seg * F;
  if (has0) o[c0] = from_f32<T>(acc0);
  if (has1) o[c1] = from_f32<T>(acc1);
}

// (b): the live rows of out take their sums in place; the others stay as they are
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ ptr, const int32_t* __restrict__ live,
                   int n_live, Terms<T> items, T* __restrict__ out, int64_t ldo,
                   int n_chunks) {
  int seg, c0;
  if (!group_of<G>(live, n_live, n_chunks, &seg, &c0)) return;
  const int W = items.W, c1 = c0 + G;
  const bool has0 = c0 < W, has1 = c1 < W;
  T* o = out + (int64_t)seg * ldo;
  float acc0 = has0 ? to_f32<T>(o[c0]) : 0.f;
  float acc1 = has1 ? to_f32<T>(o[c1]) : 0.f;
  sum_items(items, ptr[seg], ptr[seg + 1], c0, c1, has0, has1, &acc0, &acc1);
  if (has0) o[c0] = from_f32<T>(acc0);
  if (has1) o[c1] = from_f32<T>(acc1);
}

// the group width for rows of `width` columns: the smallest power of two
// >= ceil(width / 2), at most 32 (ops/cuda_segment.py:group_layout)
int group_width(int width) {
  int g = 1;
  while (g < 32 && 2 * g < width) g *= 2;
  return g;
}

template <int G>
int64_t grid_of(int n_live, int width) {
  const int n_chunks = (width + 2 * G - 1) / (2 * G);
  return ((int64_t)n_live * n_chunks * G + kThreads - 1) / kThreads;
}

template <typename T, int G>
int launch_gather(const int32_t* ptr, const int32_t* live, int n_live, Gather<T> items,
                  void* out, cudaStream_t s) {
  const int64_t blocks = grid_of<G>(n_live, items.F);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  gather_sum_kernel<T, G><<<(unsigned)blocks, kThreads, 0, s>>>(
      ptr, live, n_live, items, static_cast<T*>(out), (items.F + 2 * G - 1) / (2 * G));
  return 0;
}

template <typename T, int G>
int launch_segment(const int32_t* ptr, const int32_t* live, int n_live, Terms<T> items,
                   void* out, int64_t ldo, cudaStream_t s) {
  const int64_t blocks = grid_of<G>(n_live, items.W);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<T, G><<<(unsigned)blocks, kThreads, 0, s>>>(
      ptr, live, n_live, items, static_cast<T*>(out), ldo, (items.W + 2 * G - 1) / (2 * G));
  return 0;
}

template <typename T>
int dispatch_gather(const int32_t* ptr, const int32_t* live, int n_live, Gather<T> items,
                    void* out, cudaStream_t s) {
  switch (group_width(items.F)) {
    case 1: return launch_gather<T, 1>(ptr, live, n_live, items, out, s);
    case 2: return launch_gather<T, 2>(ptr, live, n_live, items, out, s);
    case 4: return launch_gather<T, 4>(ptr, live, n_live, items, out, s);
    case 8: return launch_gather<T, 8>(ptr, live, n_live, items, out, s);
    case 16: return launch_gather<T, 16>(ptr, live, n_live, items, out, s);
    default: return launch_gather<T, 32>(ptr, live, n_live, items, out, s);
  }
}

template <typename T>
int dispatch_segment(const int32_t* ptr, const int32_t* live, int n_live, Terms<T> items,
                     void* out, int64_t ldo, cudaStream_t s) {
  switch (group_width(items.W)) {
    case 1: return launch_segment<T, 1>(ptr, live, n_live, items, out, ldo, s);
    case 2: return launch_segment<T, 2>(ptr, live, n_live, items, out, ldo, s);
    case 4: return launch_segment<T, 4>(ptr, live, n_live, items, out, ldo, s);
    case 8: return launch_segment<T, 8>(ptr, live, n_live, items, out, ldo, s);
    case 16: return launch_segment<T, 16>(ptr, live, n_live, items, out, ldo, s);
    default: return launch_segment<T, 32>(ptr, live, n_live, items, out, ldo, s);
  }
}

}  // namespace

// (a): out [n, F] (x's type, zeroed) = the ordered gather-sum over the live
// segments; perm may be null
extern "C" int pgcn_gather_sum(const int32_t* ptr, const int32_t* perm, const int32_t* live,
                               int n_live, const int64_t* src, const float* val,
                               const void* x, int dtype, void* out, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_live <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0) {
    rc = dispatch_gather<float>(ptr, live, n_live,
                                Gather<float>{perm, src, val, static_cast<const float*>(x), F},
                                out, s);
  } else if (dtype == 1) {
    rc = dispatch_gather<__nv_bfloat16>(
        ptr, live, n_live,
        Gather<__nv_bfloat16>{perm, src, val, static_cast<const __nv_bfloat16*>(x), F}, out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// (b): out [n, W] (rows ldo apart) += the ordered sums of values [E, W] (one
// type) over the live segments; perm may be null
extern "C" int pgcn_segment_sum(const int32_t* ptr, const int32_t* perm, const int32_t* live,
                                int n_live, const void* values, int dtype, void* out,
                                int64_t ldo, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_live <= 0 || W <= 0 || ldo < W) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0) {
    rc = dispatch_segment<float>(
        ptr, live, n_live, Terms<float>{perm, static_cast<const float*>(values), W}, out, ldo,
        s);
  } else if (dtype == 1) {
    rc = dispatch_segment<__nv_bfloat16>(
        ptr, live, n_live,
        Terms<__nv_bfloat16>{perm, static_cast<const __nv_bfloat16*>(values), W}, out, ldo, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
