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
// Seed lanes (dropout_lanes_kernel, dropout_lanes_bwd_kernel; a batch of S
// training runs over one graph, parallel_gcn_tpu_torch/seeds.py). Lane s's
// mask is the mask of a solo run with lane s's seed on its own [rows, F]
// tensor: element (r, c) of lane s draws lane s's seed at its solo index
// j = r*F + c (plus the offset), so a lane equals its solo run bit for bit.
// Each operand (input, output, and the backward's saved output) is given
// lane by lane as a pointer and a row stride (LaneRefs): a joined [rows,
// S*F] tensor (lane s at column s*F, rows S*F apart), or S lane-contiguous
// [rows, F] tensors (rows F apart; S times the same tensor for an input that
// every lane reads), any layout in with any layout out. So one launch also
// makes the lanes' split (joined in, lanes out) or their join, both ways,
// with no copy of its own.
// Design: a block is one lane's (blockIdx.x % S, so the lanes' blocks of a
// row range run side by side); its threads walk the lane's own index space
// j in 16-byte vectors of whole Philox counters, as the unlaned kernel walks
// its tensor, whatever F is. A lane-contiguous operand is read or written
// at j, a vector at a time when its base is aligned. A
// joined operand is reached through (r, c) = (j / F, j % F): r is the high
// word of j times a reciprocal of F computed on the host (floor((2^64 - 1)
// / F) + 1, exact while rows*F*F < 2^64), no division; the vector is one
// 16-byte access when F and the row stride are whole vectors, else a walk of
// its elements that carries (r, c) across row ends. The bound is the
// unlaned kernel's: each byte read and written once.
// The backward of K2 over lanes (dropout_lanes_bwd_kernel) reads the
// cotangent and the saved output in the output's layout and writes
// where(out > 0, g * inv_keep, 0) in the input's layout, the rounding of
// PyTorch's where(out > 0, g * s, 0.0) with s the host scalar inv_keep.

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
  // one element's bits, and a vector as its elements' bits
  union Pack {
    uint4 u;
    uint32_t h[4];
  };
  static __device__ __forceinline__ uint32_t bits1(const float* p) {
    return __float_as_uint(*p);
  }
  static __device__ __forceinline__ void put_bits1(float* p, uint32_t b) {
    *p = __uint_as_float(b);
  }
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
  union Pack {
    uint4 u;
    uint16_t h[8];
  };
  static __device__ __forceinline__ uint16_t bits1(const __nv_bfloat16* p) {
    return __bfloat16_as_ushort(*p);
  }
  static __device__ __forceinline__ void put_bits1(__nv_bfloat16* p, uint16_t b) {
    *p = __ushort_as_bfloat16(b);
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


constexpr int kMaxLanes = 64;  // lanes a launch (pgcn_dropout_lanes launches in parts)

// One operand of S lanes: lane s's element (r, c) at p[s] + r*ld + c.
struct LaneRefs {
  const void* p[kMaxLanes];
  int64_t ld;  // elements between rows: F for a lane-contiguous operand
  int vec;     // 1: every lane's vectors can move 16 bytes at a time
};

struct LaneShape {
  int lanes;
  int64_t width;   // F
  int64_t n;       // rows*F, a lane's elements
  uint64_t magic;  // floor((2^64 - 1) / F) + 1 (F > 1): j / F = umulhi(j, magic)
};

__device__ __forceinline__ int64_t lane_row(int64_t j, const LaneShape& sh) {
  return sh.width == 1 ? j : (int64_t)__umul64hi((unsigned long long)j, sh.magic);
}

// Vector v of a lane (its elements j = v*kVec ..) of operand `o` as 16
// bytes: zeros past the lane's n elements.
template <typename T>
__device__ __forceinline__ uint4 lane_load(const T* __restrict__ p, int64_t ld, int vec,
                                           int64_t v, const LaneShape& sh) {
  using V = Vec<T>;
  const int64_t j = v * V::kVec;
  const bool contig = ld == sh.width;
  int64_t r = 0, c = 0;
  if (!contig) {
    r = lane_row(j, sh);
    c = j - r * sh.width;
  }
  if (vec && j + V::kVec <= sh.n)
    return __ldg(reinterpret_cast<const uint4*>(p + (contig ? j : r * ld + c)));
  typename V::Pack out;
  out.u = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int e = 0; e < V::kVec; ++e) {
    if (j + e < sh.n) out.h[e] = V::bits1(p + (contig ? j + e : r * ld + c));
    if (++c == sh.width) {
      c = 0;
      ++r;
    }
  }
  return out.u;
}

template <typename T>
__device__ __forceinline__ void lane_store(T* __restrict__ p, int64_t ld, int vec, int64_t v,
                                           const LaneShape& sh, uint4 val) {
  using V = Vec<T>;
  const int64_t j = v * V::kVec;
  const bool contig = ld == sh.width;
  int64_t r = 0, c = 0;
  if (!contig) {
    r = lane_row(j, sh);
    c = j - r * sh.width;
  }
  if (vec && j + V::kVec <= sh.n) {
    *reinterpret_cast<uint4*>(p + (contig ? j : r * ld + c)) = val;
    return;
  }
  typename V::Pack in;
  in.u = val;
#pragma unroll
  for (int e = 0; e < V::kVec; ++e) {
    if (j + e < sh.n) V::put_bits1(p + (contig ? j + e : r * ld + c), in.h[e]);
    if (++c == sh.width) {
      c = 0;
      ++r;
    }
  }
}

// kMode 0: dropout (K1), 1: relu -> dropout (K2), 2: K2's backward from the
// cotangent x and the saved output o. The lane is blockIdx.x % lanes (the
// lanes' blocks of one row range run together, so a joined operand's rows
// are read or written whole), the block's place in its lane blockIdx.x /
// lanes; its operands' pointers come from the kernel's parameters
// (__grid_constant__: read in place, no copy a thread).
template <typename T, int kMode>
__device__ __forceinline__ void lanes_body(const T* __restrict__ x, int64_t x_ld, int x_vec,
                                           const T* __restrict__ o, int64_t o_ld, int o_vec,
                                           T* __restrict__ y, int64_t y_ld, int y_vec,
                                           const LaneShape& sh, int lane,
                                           const unsigned long long* __restrict__ seeds,
                                           uint64_t ctr0, uint32_t thr, float inv_keep) {
  using V = Vec<T>;
  constexpr int kVec = V::kVec;
  constexpr int kCtr = kVec / 4;
  uint32_t k0 = 0, k1 = 0;
  if (kMode < 2) {
    const unsigned long long key = __ldg(seeds + lane);
    k0 = (uint32_t)key;
    k1 = (uint32_t)(key >> 32);
  }
  const int64_t n_vec = (sh.n + kVec - 1) / kVec;
  const int64_t step = (int64_t)(gridDim.x / sh.lanes) * kThreads * kUnroll;
  for (int64_t v0 = (int64_t)(blockIdx.x / sh.lanes) * kThreads * kUnroll + threadIdx.x;
       v0 < n_vec; v0 += step) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + (int64_t)u * kThreads;
      if (v < n_vec) {
        a[u] = lane_load(x, x_ld, x_vec, v, sh);
        if (kMode == 2) b[u] = lane_load(o, o_ld, o_vec, v, sh);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + (int64_t)u * kThreads;
      if (v < n_vec) {
        float f[kVec];
        V::get(a[u], f);
        if (kMode == 2) {
          float saved[kVec];
          V::get(b[u], saved);
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] = saved[e] > 0.0f ? f[e] * inv_keep : 0.0f;
        } else {
          uint32_t word[kVec];
#pragma unroll
          for (int c = 0; c < kCtr; ++c) {
            const uint4 w = philox4x32_10(ctr0 + (uint64_t)v * kCtr + c, k0, k1);
            word[4 * c] = w.x; word[4 * c + 1] = w.y;
            word[4 * c + 2] = w.z; word[4 * c + 3] = w.w;
          }
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] = drop1<kMode == 1>(f[e], word[e], thr, inv_keep);
        }
        lane_store(y, y_ld, y_vec, v, sh, V::put(f));
      }
    }
  }
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
dropout_lanes_kernel(const __grid_constant__ LaneRefs in, const __grid_constant__ LaneRefs out,
                     const LaneShape sh, const unsigned long long* __restrict__ seeds,
                     uint64_t ctr0, uint32_t thr, float inv_keep) {
  const int lane = blockIdx.x % sh.lanes;
  const T* x = static_cast<const T*>(in.p[lane]);
  lanes_body<T, kRelu ? 1 : 0>(x, in.ld, in.vec, x, in.ld, in.vec,
                               static_cast<T*>(const_cast<void*>(out.p[lane])), out.ld, out.vec,
                               sh, lane, seeds, ctr0, thr, inv_keep);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_lanes_bwd_kernel(const __grid_constant__ LaneRefs g,
                         const __grid_constant__ LaneRefs saved,
                         const __grid_constant__ LaneRefs out, const LaneShape sh,
                         float inv_keep) {
  const int lane = blockIdx.x % sh.lanes;
  lanes_body<T, 2>(static_cast<const T*>(g.p[lane]), g.ld, g.vec,
                   static_cast<const T*>(saved.p[lane]), saved.ld, saved.vec,
                   static_cast<T*>(const_cast<void*>(out.p[lane])), out.ld, out.vec, sh, lane,
                   nullptr, 0, 0, inv_keep);
}

// The most blocks a lane's row of the grid takes: kWaves times the card's
// resident blocks of `kernel`, shared by the lanes.
template <typename K>
int lanes_grid(K kernel, int64_t n_vec, int lanes, unsigned* blocks) {
  static int cached[kMaxDevices];  // per instantiation and device; 0: not yet asked
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (rc != cudaSuccess) return (int)rc;
    cached[dev] = kWaves * sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t cap = cached[dev] / lanes > 0 ? cached[dev] / lanes : 1;
  const int64_t want = ((n_vec + kUnroll - 1) / kUnroll + kThreads - 1) / kThreads;
  const int64_t rounds = (want + cap - 1) / cap;
  *blocks = (unsigned)(want > 0 ? (want + rounds - 1) / rounds : 1);
  return 0;
}

int fill_refs(LaneRefs* r, const void* const* p, int64_t ld, int lanes, int64_t width,
              int vec_elems) {
  if (ld < width) return (int)cudaErrorInvalidValue;
  r->ld = ld;
  // a lane-contiguous operand moves whole vectors from an aligned base; a
  // joined one needs whole vectors a row too
  int vec = ld == width || (width % vec_elems == 0 && ld % vec_elems == 0);
  for (int s = 0; s < kMaxLanes; ++s) {
    r->p[s] = s < lanes ? p[s] : nullptr;
    if (s < lanes) {
      if (p[s] == nullptr) return (int)cudaErrorInvalidValue;
      vec = vec && (reinterpret_cast<uintptr_t>(p[s]) & 15u) == 0;
    }
  }
  r->vec = vec;
  return 0;
}

template <typename T>
int launch_lanes(const void* const* in, int64_t in_ld, const void* const* aux, int64_t aux_ld,
                 const void* const* out, int64_t out_ld, int64_t rows, int lanes,
                 int64_t width, int mode, const unsigned long long* seeds, uint64_t ctr0,
                 uint32_t thr, float inv_keep, cudaStream_t stream) {
  constexpr int kVec = Vec<T>::kVec;
  LaneRefs ri, ra, ro;
  int rc = fill_refs(&ri, in, in_ld, lanes, width, kVec);
  if (!rc) rc = fill_refs(&ro, out, out_ld, lanes, width, kVec);
  if (!rc && mode == 2) rc = fill_refs(&ra, aux, aux_ld, lanes, width, kVec);
  if (rc) return rc;
  LaneShape sh;
  sh.lanes = lanes;
  sh.width = width;
  sh.n = rows * width;
  sh.magic = width > 1 ? UINT64_MAX / (uint64_t)width + 1 : 0;
  const int64_t n_vec = (sh.n + kVec - 1) / kVec;
  unsigned blocks = 0;
  const dim3 block(kThreads);
  if (mode == 2) {
    rc = lanes_grid(dropout_lanes_bwd_kernel<T>, n_vec, lanes, &blocks);
    if (rc) return rc;
    dropout_lanes_bwd_kernel<T><<<blocks * lanes, block, 0, stream>>>(ri, ra, ro, sh,
                                                                          inv_keep);
  } else if (mode == 1) {
    rc = lanes_grid(dropout_lanes_kernel<T, true>, n_vec, lanes, &blocks);
    if (rc) return rc;
    dropout_lanes_kernel<T, true><<<blocks * lanes, block, 0, stream>>>(
        ri, ro, sh, seeds, ctr0, thr, inv_keep);
  } else {
    rc = lanes_grid(dropout_lanes_kernel<T, false>, n_vec, lanes, &blocks);
    if (rc) return rc;
    dropout_lanes_kernel<T, false><<<blocks * lanes, block, 0, stream>>>(
        ri, ro, sh, seeds, ctr0, thr, inv_keep);
  }
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

// K1 / K2 over S seed lanes, and K2's backward (mode 0: K1, 1: K2, 2: K2's
// backward from the cotangent `in` and the saved output `aux`). Each operand
// is `lanes` pointers in host memory (lane s's element (0, 0)) and a row
// stride in elements: width for lane-contiguous [rows, width] tensors,
// lanes*width for a joined [rows, lanes*width] one (lane s at column
// s*width). seeds points to lanes uint64 seeds in device memory (unread in
// mode 2); ctr0 is the element offset / 4. Otherwise as pgcn_dropout. Any
// number of lanes: a launch takes up to kMaxLanes of them (the pointers are
// kernel parameters), the next launch the next lanes with their seeds.
extern "C" int pgcn_dropout_lanes(const void* const* in, int64_t in_ld, const void* const* aux,
                                  int64_t aux_ld, const void* const* out, int64_t out_ld,
                                  int64_t rows, int lanes, int64_t width, int dtype, int mode,
                                  const unsigned long long* seeds, uint64_t ctr0, uint32_t thr,
                                  float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || lanes <= 0 || width <= 0 || mode < 0 || mode > 2 ||
      (mode < 2 && seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  // a lane's index j fits int64, and the reciprocal's row is exact while
  // j < 2^64 / width
  if ((uint64_t)rows > (uint64_t)INT64_MAX / (uint64_t)width ||
      (uint64_t)rows > UINT64_MAX / (uint64_t)width / (uint64_t)width)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  for (int s0 = 0; s0 < lanes; s0 += kMaxLanes) {
    const int part = lanes - s0 < kMaxLanes ? lanes - s0 : kMaxLanes;
    const unsigned long long* sd = mode < 2 ? seeds + s0 : nullptr;
    const void* const* ax = mode == 2 ? aux + s0 : aux;
    const int rc =
        dtype == 0 ? launch_lanes<float>(in + s0, in_ld, ax, aux_ld, out + s0, out_ld, rows,
                                         part, width, mode, sd, ctr0, thr, inv_keep, s)
                   : launch_lanes<__nv_bfloat16>(in + s0, in_ld, ax, aux_ld, out + s0, out_ld,
                                                 rows, part, width, mode, sd, ctr0, thr,
                                                 inv_keep, s);
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}
