// Inverted dropout, optionally fused with a preceding ReLU, for sm_90a.
//
// Replaces the Pallas kernels of parallel_gcn_tpu/ops/pallas_dropout.py:
//   relu = false: _dropout_kernel (K1), behind dropout_pallas
//   relu = true:  _relu_dropout_kernel (K2), behind relu_dropout_pallas
//
// Mask contract (the TPU's hardware PRNG bits cannot be reproduced):
// Philox4x32-10 keyed by the 64-bit seed (key = {lo32, hi32}); element i of
// the flattened tensor, at the element offset o the caller gives (0 for a
// whole tensor; a slice of a longer masked tensor passes its first
// element's index there), uses counter {lo32(c), hi32(c), 0, 0} with
// c = (i + o) >> 2, and output word (i + o) & 3. The kernel takes o as the
// counter offset o >> 2 and needs o % 4 == 0, so that its vectors stay on
// whole counters. It is kept iff that word < thr, with
// thr = min(round(keep * 2^32), 2^32 - 1) as in pallas_dropout.py:61, and
// written as x * inv_keep in x's dtype (inv_keep rounded to x's dtype by the
// wrapper, as pallas_dropout.py:37 does). The mask depends on (seed, i)
// only, so it is independent of the launch geometry: the backward of K1 is
// K1 on the cotangent with the same seed, and K2 == K1(relu(x)) bit for bit.
// The plain PyTorch version in ops/cuda_dropout.py computes the same bits.
// The seed is read from device memory (one uint64 that the caller writes
// before the launch), so that a launch captured in a CUDA graph draws a
// new mask each replay.
//
// What bounds it on an H100: memory. Layer 1 of synth-reddit is a
// [233472, 600] bf16 activation: 280 MB read and 280 MB written, about
// 0.17 ms at 3.35 TB/s. Philox costs 10 rounds of two 32×32→64-bit
// multiplies per 4 elements, about 0.1 ms of integer issue at that size:
// below the memory time, but only if the two overlap.
// Design: a stream of 16-byte vectors (8 bf16 elements, two Philox
// counters; or 4 f32, one counter). Each thread first issues kUnroll
// vectors' loads, then runs their Philox rounds while the loads are in
// flight, and stores 16 bytes a vector. The grid is sized from the device:
// kWaves times the blocks the card holds at once (the SM count times the
// blocks an SM holds, from the occupancy calculator), each block walking
// the same number of grid-stride steps. A single wave of persistent blocks
// measured 14% slower at [233472, 600] (kernel_variants.py dropout),
// likely because its warps stay in step, so that their load and Philox
// phases coincide, where blocks that start at different times overlap one
// block's Philox rounds with another's loads. A tensor whose data or output
// is not 16-byte aligned (a view with a storage offset), and the
// n % (16 / sizeof(T)) elements after the last whole vector, take a scalar
// path in the same kernel: one counter a thread, the same bits. The mask is
// never stored (the K1 backward regenerates it, the K2 backward reads the
// saved output).
//
// Seed lanes (dropout_lanes_kernel, for a batch of S training runs that
// share one graph, parallel_gcn_tpu_torch/seeds.py). The batch keeps its
// activations row-major as [rows, S*F], lane s in columns s*F .. s*F+F-1,
// and lane s's mask is the mask of a solo run with lane s's seed on its own
// [rows, F] tensor: element (r, c) of lane s uses lane s's seed and the
// element index r*F + c (plus the offset), so a lane equals its solo run
// bit for bit. One launch covers all lanes, a 16-byte vector a step where F
// is a whole number of vectors (each vector then lies in one lane's row and
// on whole Philox counters: its solo index r*F + c is a multiple of the
// vector width), else one counter of one lane a step (4 elements, each
// placed by its own row and column). The bound is the unlaned kernel's byte
// bound at [rows, S*F]; the row and lane of a vector cost two 64-bit
// divisions, below its two Philox counters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors whose loads a thread has in flight together
constexpr int kWaves = 8;   // the grid's blocks, in waves of the card's resident blocks
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint4 philox4x32_10(uint64_t ctr, uint32_t k0, uint32_t k1) {
  uint4 c = make_uint4((uint32_t)ctr, (uint32_t)(ctr >> 32), 0u, 0u);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// One element under the mask: the kept value x·inv_keep, or 0.
template <bool kRelu>
__device__ __forceinline__ float drop1(float v, uint32_t word, uint32_t thr, float inv_keep) {
  bool keep = word < thr;
  if (kRelu) keep = keep && (v > 0.0f);
  return keep ? v * inv_keep : 0.0f;
}

// 16 bytes of T as kVec floats, and back (bf16 rounded to nearest even).
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void get(uint4 u, float (&x)[4]) {
    x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 put(const float (&x)[4]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void get(uint4 u, float (&x)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  static __device__ __forceinline__ uint4 put(const float (&x)[8]) {
    return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
                      pack2(x[6], x[7]));
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, int64_t n_vec,
               const unsigned long long* __restrict__ seed, uint64_t ctr0, uint32_t thr,
               float inv_keep) {
  const unsigned long long key = __ldg(seed);
  const uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
  constexpr int kVec = Vec<T>::kVec;  // elements per 16-byte vector
  constexpr int kCtr = kVec / 4;      // Philox counters per vector
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t v0 = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x; v0 < n_vec;
       v0 += step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + (int64_t)u * kThreads;
      if (v < n_vec) raw[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + (int64_t)u * kThreads;
      if (v < n_vec) {
        uint32_t word[kVec];
#pragma unroll
        for (int c = 0; c < kCtr; ++c) {
          const uint4 b = philox4x32_10(ctr0 + (uint64_t)v * kCtr + c, k0, k1);
          word[4 * c] = b.x; word[4 * c + 1] = b.y;
          word[4 * c + 2] = b.z; word[4 * c + 3] = b.w;
        }
        float f[kVec];
        Vec<T>::get(raw[u], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) f[e] = drop1<kRelu>(f[e], word[e], thr, inv_keep);
        ov[v] = Vec<T>::put(f);
      }
    }
  }
  // the scalar path: the elements from n_vec·kVec on (all of them when x or
  // out is not 16-byte aligned), one Philox counter of 4 elements a thread
  const int64_t n_ctr = (n + 3) >> 2;
  for (int64_t ctr = n_vec * kCtr + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       ctr < n_ctr; ctr += (int64_t)gridDim.x * kThreads) {
    const uint4 b = philox4x32_10(ctr0 + (uint64_t)ctr, k0, k1);
    const uint32_t word[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = (ctr << 2) + j;
      if (i < n) Vec<T>::store1(out + i, drop1<kRelu>(Vec<T>::load1(x + i), word[j], thr,
                                                     inv_keep));
    }
  }
}

// The most blocks a launch takes: kWaves times the blocks of the kernel
// that the card holds at once, per device.
template <typename T, bool kRelu>
int grid_cap(int* blocks) {
  static int cached[kMaxDevices];  // 0: not yet asked
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dropout_kernel<T, kRelu>,
                                                       kThreads, 0);
  if (rc != cudaSuccess) return (int)rc;
  *blocks = kWaves * sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return 0;
}

template <typename T, bool kRelu>
int launch(const void* x, void* out, int64_t n, const unsigned long long* seed,
           uint64_t ctr0, uint32_t thr, float inv_keep, cudaStream_t stream) {
  constexpr int kVec = Vec<T>::kVec;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
                        15u) == 0;
  const int64_t n_vec = aligned ? n / kVec : 0;
  // thread steps the work needs: whole vectors kUnroll at a time, or the
  // scalar path's counters
  const int64_t steps = n_vec > 0 ? (n_vec + kUnroll - 1) / kUnroll
                                  : (((n + 3) >> 2) - n_vec * (kVec / 4));
  const int64_t need = (steps + kThreads - 1) / kThreads;
  int cap = 0;
  const int rc = grid_cap<T, kRelu>(&cap);
  if (rc) return rc;
  // as many grid-stride rounds as the cap needs, spread over equal blocks
  const int64_t rounds = (need + cap - 1) / cap;
  const int64_t blocks = need > 0 ? (need + rounds - 1) / rounds : 1;
  dropout_kernel<T, kRelu><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, n_vec, seed, ctr0, thr, inv_keep);
  return 0;
}


// The lanes kernel: x and out are [rows, lanes * width] row-major; seeds
// holds one uint64 a lane. n_vec is the tensor's number of 16-byte vectors
// when width is a whole number of them and x and out are aligned, else 0
// (every element through the counter path).
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
dropout_lanes_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows,
                     int64_t lanes, int64_t width, int64_t n_vec,
                     const unsigned long long* __restrict__ seeds, uint64_t ctr0, uint32_t thr,
                     float inv_keep) {
  constexpr int kVec = Vec<T>::kVec;
  constexpr int kCtr = kVec / 4;
  const int64_t row_len = lanes * width;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const int64_t stride = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t w0 = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x; w0 < n_vec;
       w0 += stride) {
    uint4 in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = w0 + (int64_t)u * kThreads;
      if (w < n_vec) in[u] = __ldg(xv + w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = w0 + (int64_t)u * kThreads;
      if (w < n_vec) {
        const int64_t e = w * kVec;  // the vector's first element
        const int64_t r = e / row_len;
        const int64_t col = e - r * row_len;
        const int64_t lane = col / width;
        const int64_t j = r * width + (col - lane * width);  // its index in the lane
        const unsigned long long key = __ldg(seeds + lane);
        uint32_t bits[kVec];
#pragma unroll
        for (int c = 0; c < kCtr; ++c) {
          const uint4 b = philox4x32_10(ctr0 + (uint64_t)(j >> 2) + c, (uint32_t)key,
                                        (uint32_t)(key >> 32));
          bits[4 * c] = b.x; bits[4 * c + 1] = b.y;
          bits[4 * c + 2] = b.z; bits[4 * c + 3] = b.w;
        }
        float f[kVec];
        Vec<T>::get(in[u], f);
#pragma unroll
        for (int k = 0; k < kVec; ++k) f[k] = drop1<kRelu>(f[k], bits[k], thr, inv_keep);
        ov[w] = Vec<T>::put(f);
      }
    }
  }
  if (n_vec > 0) return;
  // the counter path: one Philox counter (4 elements) of one lane a thread;
  // lane-major, so that neighbouring threads hold neighbouring elements
  const int64_t n_lane = rows * width;
  const int64_t ctr_lane = (n_lane + 3) >> 2;
  for (int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x; p < lanes * ctr_lane;
       p += (int64_t)gridDim.x * kThreads) {
    const int64_t lane = p / ctr_lane;
    const int64_t q = p - lane * ctr_lane;
    const unsigned long long key = __ldg(seeds + lane);
    const uint4 b = philox4x32_10(ctr0 + (uint64_t)q, (uint32_t)key, (uint32_t)(key >> 32));
    const uint32_t bits[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = (q << 2) + k;
      if (j < n_lane) {
        const int64_t r = j / width;
        const int64_t i = r * row_len + lane * width + (j - r * width);
        Vec<T>::store1(out + i, drop1<kRelu>(Vec<T>::load1(x + i), bits[k], thr, inv_keep));
      }
    }
  }
}

template <typename T, bool kRelu>
int launch_lanes(const void* x, void* out, int64_t rows, int64_t lanes, int64_t width,
                 const unsigned long long* seeds, uint64_t ctr0, uint32_t thr, float inv_keep,
                 cudaStream_t stream) {
  constexpr int kVec = Vec<T>::kVec;
  const bool whole = width % kVec == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
                      15u) == 0;
  const int64_t n_vec = whole ? rows * lanes * width / kVec : 0;
  const int64_t work = whole ? (n_vec + kUnroll - 1) / kUnroll
                             : lanes * ((rows * width + 3) >> 2);
  const int64_t want = (work + kThreads - 1) / kThreads;
  static int cached[kMaxDevices];  // the grid's cap a device, 0: not yet asked
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dropout_lanes_kernel<T, kRelu>, kThreads, 0);
    if (rc != cudaSuccess) return (int)rc;
    cached[dev] = kWaves * sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t cap = cached[dev];
  const int64_t rounds = (want + cap - 1) / cap;
  const int64_t grid = want > 0 ? (want + rounds - 1) / rounds : 1;
  dropout_lanes_kernel<T, kRelu><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, lanes, width, n_vec, seeds, ctr0,
      thr, inv_keep);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Any alignment of x and out. seed points
// to the uint64 seed in device memory; ctr0 is the counter offset (the
// element offset / 4). Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int pgcn_dropout(const void* x, void* out, int64_t n, int dtype,
                            int relu, const unsigned long long* seed, uint64_t ctr0,
                            uint32_t thr, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0) {
    rc = relu ? launch<float, true>(x, out, n, seed, ctr0, thr, inv_keep, s)
              : launch<float, false>(x, out, n, seed, ctr0, thr, inv_keep, s);
  } else if (dtype == 1) {
    rc = relu ? launch<__nv_bfloat16, true>(x, out, n, seed, ctr0, thr, inv_keep, s)
              : launch<__nv_bfloat16, false>(x, out, n, seed, ctr0, thr, inv_keep, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// K1 / K2 over S seed lanes: x and out are [rows, lanes * width] row-major,
// seeds points to lanes uint64 seeds in device memory. Otherwise as
// pgcn_dropout.
extern "C" int pgcn_dropout_lanes(const void* x, void* out, int64_t rows, int64_t lanes,
                                  int64_t width, int dtype, int relu,
                                  const unsigned long long* seeds, uint64_t ctr0, uint32_t thr,
                                  float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || lanes <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0) {
    rc = relu ? launch_lanes<float, true>(x, out, rows, lanes, width, seeds, ctr0, thr,
                                          inv_keep, s)
              : launch_lanes<float, false>(x, out, rows, lanes, width, seeds, ctr0, thr,
                                           inv_keep, s);
  } else if (dtype == 1) {
    rc = relu ? launch_lanes<__nv_bfloat16, true>(x, out, rows, lanes, width, seeds, ctr0,
                                                  thr, inv_keep, s)
              : launch_lanes<__nv_bfloat16, false>(x, out, rows, lanes, width, seeds, ctr0,
                                                   thr, inv_keep, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
