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
