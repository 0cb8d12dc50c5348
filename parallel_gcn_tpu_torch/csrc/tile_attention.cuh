// Shared pieces of the GAT tile-attention kernels (tile_attention.cu: K5,
// K6; tile_attention_rect.cu: K7): the per-warp walk over a tile row's live
// entries (K7), the lane layout of the live-column index walk (K5, K6), the
// segment schedule, the attention-dropout hash and the ordered merge of split
// tile-rows. See tile_attention.cu for the design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e9f;          // masked-logit fill, as _NEG
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;              // rows per CTA
constexpr int kMaxH = 8;               // heads
constexpr int kMaxK = 8;               // features per lane: H·D <= 256
constexpr int kMaxHD = 32 * kMaxK;
constexpr int kMaxHP = kMaxHD + 8 * (kMaxH - 1) + 8;  // H·P <= H·D + 7H, plus slack
constexpr int kListCap = 512 + 32;     // one 512-column step plus a partial batch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// 8 consecutive values as floats; p is 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    x[2 * i] = __low2float(b);
    x[2 * i + 1] = __high2float(b);
  }
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

// How a warp spreads the rows it gathers over its lanes (K5, K6). A row is H
// heads of P features (D rounded up to 8), read as Q = P/8 groups a head of
// 16 bytes (bf16) or 32 (f32); the H·Q lanes of one edge form a slot, and a
// warp step gathers E = 32 / (H·Q) edges (at least one). Lane pair
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

// Bit e set when element e of 16 loaded bytes is nonzero (-0.0 counts as 0).
template <typename TT> __device__ __forceinline__ uint32_t live_bits(uint4 u);

template <> __device__ __forceinline__ uint32_t live_bits<int8_t>(uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if ((w[i] >> (8 * b)) & 0xffu) bits |= 1u << (4 * i + b);
  return bits;
}

template <> __device__ __forceinline__ uint32_t live_bits<__nv_bfloat16>(uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (w[i] & 0x7fffu) bits |= 1u << (2 * i);
    if (w[i] & 0x7fff0000u) bits |= 1u << (2 * i + 1);
  }
  return bits;
}

template <> __device__ __forceinline__ uint32_t live_bits<float>(uint4 u) {
  return (u.x & 0x7fffffffu ? 1u : 0u) | (u.y & 0x7fffffffu ? 2u : 0u) |
         (u.z & 0x7fffffffu ? 4u : 0u) | (u.w & 0x7fffffffu ? 8u : 0u);
}

struct Sched {
  const void* tiles;
  const int* seg_tile_ptr;
  const int* seg_row;
  const int* seg_slot;
  int n_seg;
  const int* multi_row;
  const int* multi_slot_ptr;
  int n_multi;
  const int* tile_cols;
  int tile_r, tile_c;
};

struct Drop {
  int on;
  uint32_t seed, thr;
  float inv_keep;
};

// Where segment `seg` writes its row r0: the output or its workspace slot.
__device__ __forceinline__ float* segment_dst(const Sched& sc, float* out,
                                              float* ws, int seg, int r0,
                                              int width) {
  const int slot = sc.seg_slot[seg];
  if (slot < 0) return out + ((size_t)sc.seg_row[seg] * sc.tile_r + r0) * width;
  return ws + ((size_t)slot * sc.tile_r + r0) * width;
}

// Walk row `row` of the segment's tiles [t0, t1): append the global ids of
// its live columns to the warp's `list` in column order and hand every full
// batch of 32 to batch(base, 32). Returns the size of the partial batch left
// at the front of the list.
template <typename TT, typename Batch>
__device__ __forceinline__ int scan_row(const Sched& sc, int t0, int t1, int row,
                                        int* list, int lane, Batch&& batch) {
  constexpr int kEl = 16 / sizeof(TT);
  constexpr int kStep = 32 * kEl;
  const TT* tiles = static_cast<const TT*>(sc.tiles);
  int count = 0;
  for (int t = t0; t < t1; ++t) {
    const TT* rp = tiles + ((size_t)t * sc.tile_r + row) * sc.tile_c;
    const int col_base = sc.tile_cols[t] * sc.tile_c;
    for (int c0 = 0; c0 < sc.tile_c; c0 += kStep) {
      const int c = c0 + lane * kEl;
      uint32_t bits = 0;
      if (c < sc.tile_c) bits = live_bits<TT>(*reinterpret_cast<const uint4*>(rp + c));
      const int cnt = __popc(bits);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      int pos = count + incl - cnt;
      while (bits) {
        list[pos++] = col_base + c + __ffs(bits) - 1;
        bits &= bits - 1;
      }
      count += __shfl_sync(kFull, incl, 31);
      __syncwarp();
      int base = 0;
      for (; count - base >= 32; base += 32) batch(base, 32);
      if (base > 0) {  // move the partial batch to the front
        const int rem = count - base;
        const int x = lane < rem ? list[base + lane] : 0;
        __syncwarp();
        if (lane < rem) list[lane] = x;
        __syncwarp();
        count = rem;
      }
    }
  }
  return count;
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

bool valid(const Sched& sc, int H, int D) {
  return sc.n_seg > 0 && H >= 1 && H <= kMaxH && D >= 1 && H * D <= kMaxHD &&
         sc.tile_r % kRows == 0 && sc.tile_c % 128 == 0;
}

// The padded layout of gp and vp: P = D rounded up to 8, S >= H·P, S % 8 == 0.
bool valid_padding(int H, int D, int P, int S) {
  return P % 8 == 0 && P >= D && P < D + 8 && S % 8 == 0 && S >= H * P &&
         H * P <= kMaxHP;
}

dim3 grid_of(const Sched& sc) {
  return dim3((unsigned)(sc.n_seg * (sc.tile_r / kRows)));
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (tiles only).
template <typename VT, typename F>
int by_tile_dtype(int tile_dtype, F&& f) {
  if (tile_dtype == 0) f((float*)nullptr, (VT*)nullptr);
  else if (tile_dtype == 1) f((__nv_bfloat16*)nullptr, (VT*)nullptr);
  else if (tile_dtype == 2) f((int8_t*)nullptr, (VT*)nullptr);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename F>
int by_dtypes(int tile_dtype, int v_dtype, F&& f) {
  if (v_dtype == 0) return by_tile_dtype<float>(tile_dtype, f);
  if (v_dtype == 1) return by_tile_dtype<__nv_bfloat16>(tile_dtype, f);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
