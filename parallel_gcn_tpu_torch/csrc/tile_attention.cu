// GAT block-sparse tile attention, K5 (forward) and K6 (backward), for sm_90a.
//
// Replaces the Pallas kernels of parallel_gcn_tpu/ops/tile_attention.py:
//   gat_fwd_kernel: _fwd_kernel (K5). Per destination row i of the pack,
//     over its live entries j: logits e = LeakyReLU(s_i + t_j), online
//     softmax statistics (m_i, den_i) and the rescaled numerator
//     acc_i = Σ_j w̃_ij·v_j, w = exp(e − m), w̃ = w·keep_ij/(1 − rate).
//   gat_bwd_kernel: _bwd_kernel (K6). From the saved (m, den, ρ = Σ g·out):
//     the forward orientation of entry (i, j) gives
//       ds_i += α_ij·(keep·⟨g_i, v_j⟩/(1−rate) − ρ_i)·leaky'(s_i + t_j),
//     the mirrored orientation (the edge j → i, present because the edge set
//     is symmetric) gives dt_i and dv_i:
//       dt_i += α_ji·(keep'·⟨v_i, g_j⟩/(1−rate) − ρ_j)·leaky'(s_j + t_i),
//       dv_i += α_ji·keep'/(1−rate)·g_j,
//     with keep' the hash of the mirror edge's own ids (dest j, src i).
// The ops/tile_attention.py wrappers hold the plain PyTorch versions.
//
// Inputs: tiles [T, tile_r, tile_c] (int8, bf16 or f32; read only as != 0),
// sorted by tile-row, tile t at block column tile_cols[t]; per node st
// [n, 2H] = s | t (forward) or node [n, 5H] = s | t | m | max(den, 1e-16) | ρ
// (backward), f32; v [n, H·D] f32 or bf16 (forward); g [n, H·D] f32, and
// for the backward's dot products gp (f32) and vp (v's dtype) [n, S]: g and
// v with head h at [h·P, h·P + D) and zeros elsewhere, P = D rounded up to
// 8, S = H·P or H·P + 8. Output rows are [n, H·D + 2H] f32: acc | m | den
// (forward), dv | ds | dt (backward).
//
// Hopper design. The TPU kernel walks every tile densely on one sequential
// grid: each tile is a [512, 512] block of logits on the MXU. The synth-reddit
// pack is 99% zeros (11.7M live entries in 2,596 tiles of 512×1024), so here
// the work follows the live entries instead:
//   * a CTA owns one segment of a tile-row (ops/cuda_bcsr.tile_schedule: at
//     most 8 tiles, so the hub tile-rows of 228 and 207 tiles are split) and
//     64 rows; each of its 8 warps walks whole rows, one at a time;
//   * a warp streams its row of each tile in 16-byte loads per lane (512
//     int8 columns per step), compacts the live columns into a list in
//     shared memory (ballot-free: popcount and a warp prefix sum), and
//     processes them in batches of 32, one edge per lane: per-edge scalars
//     (logits, α, the hash mask, and in K6 the two D-long dot products) are
//     lane-parallel, and the row's D-wide vector sums (acc, dv) walk the
//     batch serially with the row's features spread over the lanes;
//   * in K6 each lane reads its edge's v_j and g_j rows for the dot products
//     in 16-byte vectors from the padded copies vp and gp: per head 8
//     features a step, and a row stride (S) that is an odd multiple of 16
//     bytes, so the 32 rows a warp load touches do not share cache sets as
//     power-of-two strides (D = 32) would;
//   * the row's state (m, den, acc; or partial ds, dt, dv) lives in
//     registers and is written once per segment: straight to the output when
//     the segment is its tile-row's only one, else to a workspace slot that
//     a second kernel merges in segment order (flash rescale for K5, plain
//     sums for K6). No atomics: repeated runs are bit-identical.
// What bounds it on an H100: streaming the pack (1.36 GB per pass, ~0.4 ms at
// 3.35 TB/s) and, per live entry, the gathers of t_j (K5) or of the node
// statistics, v_j and g_j (K6, ~0.5 KB per entry at H·D = 82, mostly from
// L2). No TMA, no copy pipeline and no tensor cores in this first version.

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
// K5: forward sweep -> acc | m | den per row
template <typename TT, typename VT>
__global__ void __launch_bounds__(kThreads, 2)
gat_fwd_kernel(Sched sc, const float* __restrict__ st, const VT* __restrict__ v,
               float* __restrict__ out, float* __restrict__ ws, int H, int D,
               float slope, Drop dr) {
  __shared__ int list_s[kWarps][kListCap];
  __shared__ float coef_s[kWarps][kMaxH][33];
  __shared__ float scale_s[kWarps][kMaxH];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int subs = sc.tile_r / kRows;
  const int seg = blockIdx.x / subs;
  const int r0 = (blockIdx.x % subs) * kRows;
  const int HD = H * D;
  const int width = HD + 2 * H;
  const int t0 = sc.seg_tile_ptr[seg];
  const int t1 = sc.seg_tile_ptr[seg + 1];
  int* list = list_s[warp];
  float* dst0 = segment_dst(sc, out, ws, seg, r0, width);
  int hk[kMaxK];  // head of the lane's k-th feature (lane + 32k)
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) hk[k] = lane + 32 * k < HD ? (lane + 32 * k) / D : 0;

  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int grow = sc.seg_row[seg] * sc.tile_r + r0 + rr;
    float s_i[kMaxH], m[kMaxH], den[kMaxH], acc[kMaxK];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      s_i[h] = h < H ? st[(size_t)grow * 2 * H + h] : 0.0f;
      m[h] = kNeg;
      den[h] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.0f;

    auto batch = [&](int base, int nb) {
      const bool live = lane < nb;
      const int col = live ? list[base + lane] : 0;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        if (h < H) {
          const float e =
              live ? leaky(s_i[h] + st[(size_t)col * 2 * H + H + h], slope) : kNeg;
          const float m_new = fmaxf(m[h], warp_max(e));
          const float scale = expf(m[h] - m_new);
          const float w = live ? expf(e - m_new) : 0.0f;
          den[h] = den[h] * scale + warp_sum(w);
          m[h] = m_new;
          float wn = w;
          if (dr.on)
            wn = live && hash_keep((uint32_t)grow, (uint32_t)col, h, dr.seed, dr.thr)
                     ? w * dr.inv_keep : 0.0f;
          coef_s[warp][h][lane] = wn;
          if (lane == 0) scale_s[warp][h] = scale;
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (lane + 32 * k < HD) acc[k] *= scale_s[warp][hk[k]];
      for (int j = 0; j < nb; ++j) {
        const VT* vr = v + (size_t)list[base + j] * HD;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          const int f = lane + 32 * k;
          if (f < HD) acc[k] = fmaf(coef_s[warp][hk[k]][j], to_float(vr[f]), acc[k]);
        }
      }
      __syncwarp();
    };
    const int rem = scan_row<TT>(sc, t0, t1, r0 + rr, list, lane, batch);
    if (rem) batch(0, rem);

    float* dst = dst0 + (size_t)rr * width;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (lane + 32 * k < HD) dst[lane + 32 * k] = acc[k];
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        if (h < H) {
          dst[HD + h] = m[h];
          dst[HD + H + h] = den[h];
        }
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K6: backward sweep -> dv | ds | dt per row
template <typename TT, typename VT>
__global__ void __launch_bounds__(kThreads, 2)
gat_bwd_kernel(Sched sc, const float* __restrict__ node, const float* __restrict__ g,
               const float* __restrict__ gp, const VT* __restrict__ vp, int P, int S,
               float* __restrict__ out, float* __restrict__ ws, int H, int D,
               float slope, Drop dr) {
  __shared__ int list_s[kWarps][kListCap];
  __shared__ float coef_s[kWarps][kMaxH][33];
  __shared__ __align__(16) float row_s[kWarps][2 * kMaxHP + 5 * kMaxH];  // g_i | v_i | node_i

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int subs = sc.tile_r / kRows;
  const int seg = blockIdx.x / subs;
  const int r0 = (blockIdx.x % subs) * kRows;
  const int HD = H * D;
  const int width = HD + 2 * H;
  const int t0 = sc.seg_tile_ptr[seg];
  const int t1 = sc.seg_tile_ptr[seg + 1];
  int* list = list_s[warp];
  float* g_i = row_s[warp];  // padded per head, as gp
  float* v_i = g_i + H * P;
  float* n_i = g_i + 2 * kMaxHP;  // s_i | t_i | m_i | den_i | ρ_i
  float* dst0 = segment_dst(sc, out, ws, seg, r0, width);
  int hk[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) hk[k] = lane + 32 * k < HD ? (lane + 32 * k) / D : 0;

  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int grow = sc.seg_row[seg] * sc.tile_r + r0 + rr;
    for (int i = lane; i < H * P; i += 32) {
      g_i[i] = gp[(size_t)grow * S + i];
      v_i[i] = to_float(vp[(size_t)grow * S + i]);
    }
    for (int i = lane; i < 5 * H; i += 32) n_i[i] = node[(size_t)grow * 5 * H + i];
    __syncwarp();
    float ds_p[kMaxH], dt_p[kMaxH], dv[kMaxK];  // per-lane partial sums
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) ds_p[h] = dt_p[h] = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) dv[k] = 0.0f;

    auto batch = [&](int base, int nb) {
      if (lane < nb) {
        const int col = list[base + lane];
        const float* n_j = node + (size_t)col * 5 * H;
        const VT* v_j = vp + (size_t)col * S;
        const float* g_j = gp + (size_t)col * S;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          if (h < H) {
            float dot_a = 0.0f, dot_b = 0.0f;
            for (int d = h * P; d < (h + 1) * P; d += 8) {
              float vj[8], gj[8];
              load8(v_j + d, vj);
              load8(g_j + d, gj);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                dot_a = fmaf(g_i[d + e], vj[e], dot_a);
                dot_b = fmaf(v_i[d + e], gj[e], dot_b);
              }
            }
            // forward orientation: dest i, src j
            const float pre = n_i[h] + n_j[H + h];
            const float a = expf(leaky(pre, slope) - n_i[2 * H + h]) / n_i[3 * H + h];
            if (dr.on)
              dot_a = hash_keep((uint32_t)grow, (uint32_t)col, h, dr.seed, dr.thr)
                          ? dot_a * dr.inv_keep : 0.0f;
            ds_p[h] += a * (dot_a - n_i[4 * H + h]) * leaky_grad(pre, slope);
            // mirrored orientation: dest j, src i
            const float pre_m = n_i[H + h] + n_j[h];
            const float a_m = expf(leaky(pre_m, slope) - n_j[2 * H + h]) / n_j[3 * H + h];
            float a_mn = a_m;
            if (dr.on) {
              const bool keep_m =
                  hash_keep((uint32_t)col, (uint32_t)grow, h, dr.seed, dr.thr);
              dot_b = keep_m ? dot_b * dr.inv_keep : 0.0f;
              a_mn = keep_m ? a_m * dr.inv_keep : 0.0f;
            }
            dt_p[h] += a_m * (dot_b - n_j[4 * H + h]) * leaky_grad(pre_m, slope);
            coef_s[warp][h][lane] = a_mn;
          }
        }
      }
      __syncwarp();
      for (int j = 0; j < nb; ++j) {
        const float* gr = g + (size_t)list[base + j] * HD;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          const int f = lane + 32 * k;
          if (f < HD) dv[k] = fmaf(coef_s[warp][hk[k]][j], gr[f], dv[k]);
        }
      }
      __syncwarp();
    };
    const int rem = scan_row<TT>(sc, t0, t1, r0 + rr, list, lane, batch);
    if (rem) batch(0, rem);

    float* dst = dst0 + (size_t)rr * width;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (lane + 32 * k < HD) dst[lane + 32 * k] = dv[k];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      if (h < H) {
        const float ds = warp_sum(ds_p[h]);
        const float dt = warp_sum(dt_p[h]);
        if (lane == 0) {
          dst[HD + h] = ds;
          dst[HD + H + h] = dt;
        }
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Merge the workspace slots of each split tile-row, in segment order.
// K5: flash rescale to the row's overall max; K6: plain sums.
template <bool kFlash>
__global__ void merge_segments_kernel(const float* __restrict__ ws,
                                      const int* __restrict__ multi_row,
                                      const int* __restrict__ multi_slot_ptr,
                                      float* __restrict__ out, int tile_r, int H,
                                      int D) {
  const int HD = H * D;
  const int width = HD + 2 * H;
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
void merge(const Sched& sc, const float* ws, float* out, int H, int D,
           cudaStream_t stream) {
  if (sc.n_multi <= 0) return;
  const size_t n = (size_t)sc.tile_r * (H * D + 2 * H);
  const unsigned bx = (unsigned)((n + 255) / 256 < 64 ? (n + 255) / 256 : 64);
  merge_segments_kernel<kFlash><<<dim3(bx, (unsigned)sc.n_multi), 256, 0, stream>>>(
      ws, sc.multi_row, sc.multi_slot_ptr, out, sc.tile_r, H, D);
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

template <typename TT, typename VT>
void launch_fwd(const Sched& sc, const float* st, const void* v, float* out,
                float* ws, int H, int D, float slope, Drop dr, cudaStream_t stream) {
  gat_fwd_kernel<TT, VT><<<grid_of(sc), kThreads, 0, stream>>>(
      sc, st, static_cast<const VT*>(v), out, ws, H, D, slope, dr);
}

template <typename TT, typename VT>
void launch_bwd(const Sched& sc, const float* node, const float* g, const float* gp,
                const void* vp, int P, int S, float* out, float* ws, int H, int D,
                float slope, Drop dr, cudaStream_t stream) {
  gat_bwd_kernel<TT, VT><<<grid_of(sc), kThreads, 0, stream>>>(
      sc, node, g, gp, static_cast<const VT*>(vp), P, S, out, ws, H, D, slope, dr);
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

// Segment schedule as in csrc/bcsr_spmm.cu (ops/cuda_bcsr.tile_schedule);
// ws holds [n_slots, tile_r, H·D + 2H] floats. drop != 0 applies the
// attention-dropout hash mask with (seed, thr) and multiplies kept terms by
// inv_keep. Needs 1 <= H <= 8, H·D <= 256, tile_r % 64 == 0,
// tile_c % 128 == 0 and 16-byte aligned tiles; the backward's gp and vp
// padded as described at the top, 16-byte aligned. Return
// cudaGetLastError() after the launches (0 on success).
extern "C" int pgcn_gat_fwd(const void* tiles, int tile_dtype,
                            const int* seg_tile_ptr, const int* seg_row,
                            const int* seg_slot, int n_seg, const int* multi_row,
                            const int* multi_slot_ptr, int n_multi,
                            const int* tile_cols, int tile_r, int tile_c,
                            const float* st, const void* v, int v_dtype,
                            float* out, float* ws, int H, int D, float slope,
                            int drop, uint32_t seed, uint32_t thr,
                            float inv_keep, void* stream) {
  const Sched sc{tiles, seg_tile_ptr, seg_row, seg_slot, n_seg, multi_row,
                 multi_slot_ptr, n_multi, tile_cols, tile_r, tile_c};
  if (!valid(sc, H, D)) return (int)cudaErrorInvalidValue;
  const Drop dr{drop, seed, thr, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = by_dtypes(tile_dtype, v_dtype, [&](auto* tt, auto* vt) {
    using TT = std::remove_pointer_t<decltype(tt)>;
    using VT = std::remove_pointer_t<decltype(vt)>;
    launch_fwd<TT, VT>(sc, st, v, out, ws, H, D, slope, dr, s);
  });
  if (rc) return rc;
  merge<true>(sc, ws, out, H, D, s);
  return (int)cudaGetLastError();
}

extern "C" int pgcn_gat_bwd(const void* tiles, int tile_dtype,
                            const int* seg_tile_ptr, const int* seg_row,
                            const int* seg_slot, int n_seg, const int* multi_row,
                            const int* multi_slot_ptr, int n_multi,
                            const int* tile_cols, int tile_r, int tile_c,
                            const float* node, const float* g, const float* gp,
                            const void* vp, int v_dtype, int P, int S, float* out,
                            float* ws, int H, int D, float slope, int drop,
                            uint32_t seed, uint32_t thr, float inv_keep,
                            void* stream) {
  const Sched sc{tiles, seg_tile_ptr, seg_row, seg_slot, n_seg, multi_row,
                 multi_slot_ptr, n_multi, tile_cols, tile_r, tile_c};
  if (!valid(sc, H, D) || !valid_padding(H, D, P, S)) return (int)cudaErrorInvalidValue;
  const Drop dr{drop, seed, thr, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = by_dtypes(tile_dtype, v_dtype, [&](auto* tt, auto* vt) {
    using TT = std::remove_pointer_t<decltype(tt)>;
    using VT = std::remove_pointer_t<decltype(vt)>;
    launch_bwd<TT, VT>(sc, node, g, gp, vp, P, S, out, ws, H, D, slope, dr, s);
  });
  if (rc) return rc;
  merge<false>(sc, ws, out, H, D, s);
  return (int)cudaGetLastError();
}
