// Shared pieces of the GAT tile-attention kernels (tile_attention.cu: K5,
// K6; tile_attention_rect.cu: K7): the walk of a pack's live-column index
// (one warp per unit, the Team lane layout of the row gathers), the segment
// schedule, the attention-dropout hash, the ordered merge of split
// tile-rows and the padded row copies. See tile_attention.cu for the design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e9f;          // masked-logit fill, as _NEG
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxH = 8;               // heads
constexpr int kMaxHD = 256;            // heads · features
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: every lane ends with the same, order-fixed sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.0f ? x : slope * x;
}

__device__ __forceinline__ float leaky_grad(float x, float slope) {
  return x >= 0.0f ? 1.0f : slope;
}

// 8 consecutive values held as loaded (16-byte aligned), so that several
// rows' loads can be in flight before any is converted.
template <typename VT> struct Raw8;

template <> struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

// x[h] = p[h] for h < H (p: one row of an [n, H] f32 array), in one vector
// load where H allows it.
template <int kH>
__device__ __forceinline__ void load_heads(const float* p, int H, float (&x)[kH]) {
  if (H == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = a.x;
    x[1] = a.y;
  } else if (H % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kH / 4; ++i) {
      if (4 * i < H) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
        x[4 * i] = a.x; x[4 * i + 1] = a.y; x[4 * i + 2] = a.z; x[4 * i + 3] = a.w;
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < kH; ++h) x[h] = h < H ? __ldg(p + h) : 0.0f;
  }
}

// How a warp spreads the rows it gathers over its lanes (K5, K6, K7). A row
// is H heads of P features (D rounded up to 8), read as Q = P/8 groups a head
// of 16 bytes (bf16) or 32 (f32); the H·Q lanes of one edge form a slot, and
// a warp step gathers E = 32 / (H·Q) edges (at least one). Lane pair
// p = lane + 32k (k < kG; kG = 2 only when H·Q > 32) is slot p / (H·Q), head
// (p / Q) % H, group p % Q; pairs past the warp's slots are off.
template <int kG>
struct Team {
  int Q, HQ, E;
  int slot[kG], h[kG], q[kG];
  bool on[kG];

  __device__ __forceinline__ Team(int lane, int H, int P) {
    Q = P / 8;
    HQ = H * Q;
    E = HQ < 32 ? 32 / HQ : 1;
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const int p = lane + 32 * k;
      slot[k] = p / HQ;
      h[k] = (p / Q) % H;
      q[k] = p % Q;
      on[k] = slot[k] < E;
    }
  }

  // offset of pair k's group in a padded row
  __device__ __forceinline__ int offset(int k, int P) const { return h[k] * P + 8 * q[k]; }
};

// Lane pairs per lane of the Team layout (0: more than the kernels hold).
inline int team_pairs(int H, int P) {
  const int hq = H * (P / 8);
  return hq <= 32 ? 1 : hq <= 64 ? 2 : 0;
}

// Sum the Team slots' partial row sums into slot 0, in slot order.
template <int kG>
__device__ __forceinline__ void sum_slots(const Team<kG>& tm, float (&x)[kG][8]) {
  float own[kG][8];
#pragma unroll
  for (int k = 0; k < kG; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) own[k][e] = x[k][e];
  for (int sl = 1; sl < tm.E; ++sl) {
#pragma unroll
    for (int k = 0; k < kG; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) x[k][e] += __shfl_down_sync(kFull, own[k][e], sl * tm.HQ);
  }
}

// Slot 0 writes its groups of a row of H·D features (unpadded).
template <int kG>
__device__ __forceinline__ void store_row(const Team<kG>& tm, const float (&x)[kG][8],
                                          float* dst, int D) {
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    if (tm.on[k] && tm.slot[k] == 0) {
      const int d0 = 8 * tm.q[k];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (d0 + e < D) dst[tm.h[k] * D + d0 + e] = x[k][e];
    }
  }
}

// Per head, the dot product of the lanes' groups with a padded row's own
// groups (gp or vp at row `row`), summed over the warp: every lane ends with
// the same value for each head h < H.
template <int kH, int kG, typename RT>
__device__ __forceinline__ void row_dots(const Team<kG>& tm, const RT* rows, size_t row,
                                         int S, int P, int H, const float (&x)[kG][8],
                                         float (&dot)[kH]) {
  float part[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    Raw8<RT> a;
    if (tm.on[k]) a.load(rows + row * S + tm.offset(k, P));
    else a.zero();
    float y[8];
    a.get(y);
    part[k] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) part[k] = fmaf(y[e], x[k][e], part[k]);
  }
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    float xs = 0.0f;
#pragma unroll
    for (int k = 0; k < kG; ++k)
      if (tm.h[k] == h) xs += part[k];
    dot[h] = h < H ? warp_sum(xs) : 0.0f;
  }
}

// The attention-dropout mask: ops/tile_attention.hash_keep.
__device__ __forceinline__ bool hash_keep(uint32_t dest, uint32_t src, int h,
                                          uint32_t seed, uint32_t thr) {
  uint32_t k = dest * 0x9E3779B1u + src * 0x85EBCA6Bu +
               (uint32_t)h * 0xC2B2AE35u + seed;
  k ^= k >> 16;
  k *= 0x7FEB352Du;
  k ^= k >> 15;
  k *= 0x846CA68Bu;
  k ^= k >> 16;
  return k < thr;
}

// The segment schedule (ops/cuda_bcsr.tile_schedule): segment s covers
// tile-row seg_row[s] and writes the output (seg_slot[s] < 0) or a
// workspace slot; multi_row lists the tile-rows of several segments, whose
// slots multi_slot_ptr ranges.
struct Sched {
  const int* seg_row;
  const int* seg_slot;
  int n_seg;
  const int* multi_row;
  const int* multi_slot_ptr;
  int n_multi;
  int tile_r;
};

// The attention dropout as the entry points take it: the int32 seed lives
// in device memory, written by the caller before the launch, so that a
// launch captured in a CUDA graph draws a new mask each replay.
struct DropArgs {
  int on;
  const int* seed;
  uint32_t thr;
  float inv_keep;
};

// ... and as the kernels use it, the seed read once per thread.
struct Drop {
  int on;
  uint32_t seed, thr;
  float inv_keep;
};

__device__ __forceinline__ Drop load_drop(const DropArgs& a) {
  return Drop{a.on, a.on ? (uint32_t)__ldg(a.seed) : 0u, a.thr, a.inv_keep};
}

// Where segment `seg` writes its row r0: the output or its workspace slot.
__device__ __forceinline__ float* segment_dst(const Sched& sc, float* out,
                                              float* ws, int seg, int r0,
                                              int width) {
  const int slot = sc.seg_slot[seg];
  if (slot < 0) return out + ((size_t)sc.seg_row[seg] * sc.tile_r + r0) * width;
  return ws + ((size_t)slot * sc.tile_r + r0) * width;
}

// The unit this warp walks: its index range, global row and output row.
struct Unit {
  int seg, grow, p0, p1;
  float* dst;
};

__device__ __forceinline__ Unit unit_of(const Sched& sc, const int* ptr, float* out,
                                        float* ws, int width) {
  const int u = blockIdx.x * kWarps + threadIdx.x / 32;
  const int seg = u / sc.tile_r;
  const int r = u % sc.tile_r;
  return Unit{seg, sc.seg_row[seg] * sc.tile_r + r, ptr[u], ptr[u + 1],
              segment_dst(sc, out, ws, seg, r, width)};
}

// ---------------------------------------------------------------------------
// Merge the workspace slots of each split tile-row, in segment order: rows of
// `width` floats. kFlash (K5): rows are acc [H·D] | m [H] | den [H], rescaled
// to the row's overall max; otherwise plain sums.
template <bool kFlash>
__global__ void merge_segments_kernel(const float* __restrict__ ws,
                                      const int* __restrict__ multi_row,
                                      const int* __restrict__ multi_slot_ptr,
                                      float* __restrict__ out, int tile_r, int width,
                                      int H, int D) {
  const int HD = H * D;
  const size_t n = (size_t)tile_r * width;
  const int mr = blockIdx.y;
  const int s0 = multi_slot_ptr[mr];
  const int s1 = multi_slot_ptr[mr + 1];
  float* dst = out + (size_t)multi_row[mr] * n;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    if (!kFlash) {
      float acc = 0.0f;
      for (int s = s0; s < s1; ++s) acc += ws[(size_t)s * n + e];
      dst[e] = acc;
      continue;
    }
    const size_t row = e / width;
    const int col = (int)(e % width);
    const int h = col < HD ? col / D : (col < HD + H ? col - HD : col - HD - H);
    const size_t m_off = row * width + HD + h;
    float m = kNeg;
    for (int s = s0; s < s1; ++s) m = fmaxf(m, ws[(size_t)s * n + m_off]);
    if (col >= HD && col < HD + H) {
      dst[e] = m;
      continue;
    }
    float acc = 0.0f;
    for (int s = s0; s < s1; ++s)
      acc += ws[(size_t)s * n + e] * expf(ws[(size_t)s * n + m_off] - m);
    dst[e] = acc;
  }
}

template <bool kFlash>
void merge(const Sched& sc, const float* ws, float* out, int width, int H, int D,
           cudaStream_t stream) {
  if (sc.n_multi <= 0) return;
  const size_t n = (size_t)sc.tile_r * width;
  const unsigned bx = (unsigned)((n + 255) / 256 < 64 ? (n + 255) / 256 : 64);
  merge_segments_kernel<kFlash><<<dim3(bx, (unsigned)sc.n_multi), 256, 0, stream>>>(
      ws, sc.multi_row, sc.multi_slot_ptr, out, sc.tile_r, width, H, D);
}

// ---------------------------------------------------------------------------
// The padded rows the walks read: x [n, H·D] -> xp [n, S], head h's features
// at [h·P, h·P + D), zeros elsewhere; one thread per 8-value group of xp.
template <typename T>
__global__ void pad_heads_kernel(const T* __restrict__ x, T* __restrict__ xp, int n,
                                 int H, int D, int P, int S) {
  const int groups = S / 8;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * groups) return;
  const size_t row = i / groups;
  const int f0 = (int)(i % groups) * 8;
  const int h = f0 / P;
  const int d0 = f0 - h * P;
  __align__(16) T y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    y[e] = h < H && d0 + e < D ? x[row * (size_t)(H * D) + h * D + d0 + e] : T{};
#pragma unroll
  for (int c = 0; c < (int)sizeof(y) / 16; ++c)
    reinterpret_cast<uint4*>(xp + row * S + f0)[c] = reinterpret_cast<const uint4*>(y)[c];
}

template <typename T>
void pad_heads(const void* x, void* xp, int n, int H, int D, int P, int S,
               cudaStream_t stream) {
  const size_t threads = (size_t)n * (S / 8);
  if (threads == 0) return;
  pad_heads_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xp), n, H, D, P, S);
}

// The walks' limits: heads, the padded layout, whole warps per tile row.
bool valid_walk(const Sched& sc, int H, int D, int P, int S) {
  return sc.n_seg > 0 && H >= 1 && H <= kMaxH && D >= 1 && H * D <= kMaxHD &&
         P % 8 == 0 && P >= D && P < D + 8 && S % 8 == 0 && S >= H * P &&
         team_pairs(H, P) > 0 && sc.tile_r % kWarps == 0;
}

// f(kH, kG, VT*) with the kernels' compile-time heads and Team pairs for H
// and P, and v's element type for v_dtype (0 = float32, 1 = bfloat16).
template <typename F>
int by_shape(int H, int P, int v_dtype, F&& f) {
  auto with_vt = [&](auto kh, auto kg) -> int {
    if (v_dtype == 0) f(kh, kg, (float*)nullptr);
    else if (v_dtype == 1) f(kh, kg, (__nv_bfloat16*)nullptr);
    else return (int)cudaErrorInvalidValue;
    return 0;
  };
  using I2 = std::integral_constant<int, 2>;
  using I8 = std::integral_constant<int, 8>;
  using G1 = std::integral_constant<int, 1>;
  using G2 = std::integral_constant<int, 2>;
  if (H <= 2) return with_vt(I2{}, G1{});  // H·P/8 <= 32 when H <= 2 and H·D <= 256
  return team_pairs(H, P) == 1 ? with_vt(I8{}, G1{}) : with_vt(I8{}, G2{});
}

// One warp per unit (segment, row) of the walk.
dim3 walk_grid(const Sched& sc) {
  return dim3((unsigned)(sc.n_seg * (sc.tile_r / kWarps)));
}

}  // namespace
