// Ordered segment sums over the CSR of an index vector, for sm_90a: the
// kernels' templates. csrc/segment_sum.cu holds the C entry points and the
// float32 instantiations, csrc/segment_sum_bf16.cu the bf16 ones, so that
// nvcc builds the two halves in parallel.
//
// No Pallas kernel: the JAX package sums its COO residual with XLA's
// jax.ops.segment_sum over sorted ids (parallel_gcn_tpu/ops/graphsum.py:45-66),
// which is deterministic on the TPU. PyTorch's index_add_ on the card adds in
// the order its atomics land, so two runs of one training differ in the last
// bits. These kernels add every segment's items in item order, with no
// atomics, so a run is reproducible bit for bit:
//
//   (a) gather-sum: out[i, c] = Σ_{k ∈ [ptr[i], ptr[i+1])} v_k · x[src_k, c],
//       over the items packed in segment order at set-up ({src, val} in 8
//       bytes), v_k = val rounded to x's type; every row of out is written
//       (rows without items get 0);
//   (b) segment sum: out[i, c] += Σ_{k ∈ [ptr[i], ptr[i+1])} values[e_k, c],
//       e_k = perm[k] (or k), in place; out's rows ld elements apart, rows
//       without items untouched.
//
// Both accumulate in float32 with one rounding a product and one a sum
// (__fmul_rn / __fadd_rn: no FMA), in item order, and store each output
// once in the output's type: in float32 the result equals PyTorch's
// index_add_ on the CPU bit for bit.
//
// What bounds them on an H100: memory for rows of average length, and a
// long segment's walk (one team goes through its items in order). The
// packed index is read once a segment (a team's warps read it through L1),
// the gathered rows once an item. Design:
// - the work list (set-up, ops/cuda_segment.py): every segment as {seg,
//   begin, end}: the hubs (the longest segments) longest first, then the
//   other live segments in segment order (neighbouring rows gather nearby
//   rows), then the empty ones;
// - two kernels a call: the hub kernel on a side stream of the highest
//   priority, forked from and joined to the caller's (the two overlap, and
//   the graph capture records the fork), gives each hub a team of warps
//   that split the columns one vector a lane, with a deep ring; the walk
//   kernel launches one unit a live segment (a group of 16 or 32 lanes, or
//   a team of warps for wide rows), with a shallow ring, so it keeps many
//   warps resident for the short rows, and ((a)) ends with blocks that
//   write 0 to the rows without items;
// - columns (rows wider than 8 elements): a unit's lanes own the segment
//   across all its columns, one vector of up to 16 bytes a lane and pass;
//   they load the index S items at a time, coalesced, three batches deep,
//   and broadcast each item's source and scale with __shfl_sync, a chunk's
//   broadcasts back to back; a ring of D items' vectors is in flight in
//   registers, refilled D items ahead as each item is added;
// - items (rows of at most 8 elements): a group of 8 lanes (a warp for a
//   hub) loads 8 (32) consecutive items' rows at a time, R steps ahead, and
//   every lane adds them in item order through shuffles; lane 0 stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pgcn_seg {

constexpr int kWarps = 8;          // warps a block (teams of 3, 5, 6, 7 warps: fewer)
constexpr int kRingRegs = 8;       // registers of a lane's ring of items in flight
constexpr int kMinRing = 4;        // items a lane's ring holds at least
constexpr int kHubRingRegs = 64;   // the same for a hub team's lanes (one vector each)
constexpr int kItemSteps = 4;      // steps of items a group of the item walker has in flight
constexpr int kMaxItemWidth = 8;   // the item walker's widest row
constexpr int kItemGroup = 8;      // lanes of the item walker's groups (hubs: 32)
constexpr int kMinBlocks = 1;      // blocks an SM at least (__launch_bounds__)

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

// a vector of VB bytes, as it is loaded and stored
template <int VB>
struct RawOf;
template <>
struct RawOf<2> { using type = unsigned short; };
template <>
struct RawOf<4> { using type = unsigned int; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<16> { using type = uint4; };

__device__ __forceinline__ uint32_t word(unsigned short r, int) { return r; }
__device__ __forceinline__ uint32_t word(unsigned int r, int) { return r; }
__device__ __forceinline__ uint32_t word(const uint2& r, int i) { return i == 0 ? r.x : r.y; }
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// V = VB / sizeof(T) elements of T in a raw vector: element i as f32, and
// V floats rounded to T and packed
template <typename T, int VB>
struct Vec {
  using R = typename RawOf<VB>::type;
  static constexpr int V = VB / (int)sizeof(T);
  static_assert(V >= 1, "a vector holds at least one element");

  __device__ __forceinline__ static float get(const R& r, int i) {
    if (sizeof(T) == 4) return __uint_as_float(word(r, i));
    const uint32_t w = word(r, i / 2);
    return __uint_as_float((i & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
  __device__ __forceinline__ static R put(const float* f) {
    uint32_t w[VB < 4 ? 1 : VB / 4];
#pragma unroll
    for (int j = 0; j < (VB < 4 ? 1 : VB / 4); ++j) {
      if (sizeof(T) == 4) {
        w[j] = bits(from_f32<T>(f[j]));
      } else {
        const uint32_t lo = bits(from_f32<T>(f[2 * j]));
        w[j] = (2 * j + 1 < V) ? lo | (bits(from_f32<T>(f[2 * j + 1])) << 16) : lo;
      }
    }
    return pack(w);
  }

 private:
  __device__ __forceinline__ static R pack(const uint32_t* w) {
    if constexpr (VB == 2) {
      return (unsigned short)w[0];
    } else if constexpr (VB == 4) {
      return w[0];
    } else if constexpr (VB == 8) {
      return make_uint2(w[0], w[1]);
    } else {
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// (a): item k is {src, val's bits} (packed in segment order); its row is
// row src of x (ldx elements apart); its scale val rounded to x's type, as
// JAX casts it
template <typename T>
struct Gather {
  const int2* items;
  const T* x;
  int64_t ldx;
  static constexpr bool kScale = true;
  __device__ __forceinline__ int2 index(int k) const {
    int2 it = __ldg(items + k);
    it.y = __float_as_int(round_to<T>(__int_as_float(it.y)));
    return it;
  }
  __device__ __forceinline__ const T* row(int src) const { return x + (int64_t)src * ldx; }
};

// (b): item k is row e = perm[k] (or k) of values (ldv elements apart)
template <typename T>
struct Terms {
  const int32_t* perm;
  const T* values;
  int64_t ldv;
  static constexpr bool kScale = false;
  __device__ __forceinline__ int2 index(int k) const {
    return make_int2(perm ? __ldg(perm + k) : k, 0);
  }
  __device__ __forceinline__ const T* row(int e) const { return values + (int64_t)e * ldv; }
};

// one rounding for the product, one for the sum (no FMA)
template <bool kScale>
__device__ __forceinline__ float add(float acc, float s, float a) {
  return kScale ? __fadd_rn(acc, __fmul_rn(s, a)) : __fadd_rn(acc, a);
}

struct Plan {
  int n_hub;    // the work list's first n_hub entries are hubs
  int n_live;   // its first n_live entries have items
  int n_work;   // entries to write: n_live ((b)), every row ((a): the rest get 0)
  int hub_tw;   // warps of a hub team (columns: one vector a lane)
  int tw;       // warps of a team for the rest (1: groups of G lanes)
  int nvec;     // vectors of a row (columns) or elements (items)
  int hub_nvec; // vectors of a row in the hub kernel (its vectors may be narrower)
  int64_t ld;   // out's row stride, elements
  int walk_blocks;  // the walk kernel's blocks of units (the rest: zero blocks)
};

// a power of two <= cap, at least 2, at most s
__host__ __device__ constexpr int ring_depth(int cap, int s) {
  int d = 2;
  while (d * 2 <= cap && d * 2 <= s) d *= 2;
  return d;
}

// the vectors of one item's row that a lane holds: v = t + p·tl < nvec
template <typename T, int VB, int P, class Op>
__device__ __forceinline__ void load_row(const Op& op, int src, typename RawOf<VB>::type* r,
                                         const bool* has, int t, int tl) {
  using R = typename RawOf<VB>::type;
  constexpr int V = Vec<T, VB>::V;
  const T* row = op.row(src);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (has[p]) r[p] = __ldg(reinterpret_cast<const R*>(row + (int64_t)(t + p * tl) * V));
  }
}

template <typename T, int VB, int P, bool kScale>
__device__ __forceinline__ void add_row(float (&acc)[P][Vec<T, VB>::V], float s,
                                        const typename RawOf<VB>::type* r, const bool* has) {
  using VT = Vec<T, VB>;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (has[p]) {
#pragma unroll
      for (int i = 0; i < VT::V; ++i) acc[p][i] = add<kScale>(acc[p][i], s, VT::get(r[p], i));
    }
  }
}

// A group (or team) of tl lanes sums one segment, items [begin, begin + n),
// over all its columns: lane t holds vectors t + p·tl (p < P) of the row's
// nvec, in float32 from 0 (init_out false) or from out's row. The index
// comes S items at a time: lane sl of the S-lane shuffle domain `mask`
// holds one item of each of three batches (cur, nxt, fut). A ring of D
// items' vectors is in flight; item k sits in slot k % D and is refilled
// with item k + D as soon as it is added, so the adds stay in item order.
// Whole chunks of D items run without a test per item, their shuffles
// first; the last, partial chunk is already in the ring.
template <typename T, int VB, int P, int D, int S, class Op>
__device__ __forceinline__ void walk_cols(const Op& op, T* __restrict__ out_row, bool init_out,
                                          int begin, int n, int t, int tl, int nvec, int sl,
                                          unsigned mask) {
  using VT = Vec<T, VB>;
  using R = typename VT::R;
  constexpr int V = VT::V;
  static_assert(S % D == 0, "the ring's depth divides the index batch");
  bool has[P];
  float acc[P][V];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    has[p] = t + p * tl < nvec;
    R o{};
    if (init_out && has[p]) o = *reinterpret_cast<const R*>(out_row + (t + p * tl) * V);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[p][i] = init_out ? VT::get(o, i) : 0.f;
  }
  if (n > 0) {
    const int2 none = make_int2(0, 0);
    int2 cur = sl < n ? op.index(begin + sl) : none;
    int2 nxt = S + sl < n ? op.index(begin + S + sl) : none;
    int2 fut = 2 * S + sl < n ? op.index(begin + 2 * S + sl) : none;
    R ring[D][P];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int src = __shfl_sync(mask, cur.x, j, S);
      if (j < n) load_row<T, VB, P>(op, src, ring[j], has, t, tl);
    }
    int k = 0;
    for (; k + D <= n; k += D) {
      const int q0 = k & (S - 1);  // item k's place in its index batch
      if (q0 == 0 && k > 0) {
        cur = nxt;
        nxt = fut;
        fut = k + 2 * S + sl < n ? op.index(begin + k + 2 * S + sl) : none;
      }
      // the chunk's broadcasts first, back to back: the scales of items
      // k.. k + D - 1 and the sources of the refills, items k + D.. k + 2D - 1
      // (a shuffle's latency is then paid once a chunk, not once an item)
      float sv[D];
      int sr[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        sv[j] = Op::kScale ? __int_as_float(__shfl_sync(mask, cur.y, q0 + j, S)) : 1.f;
        const int qn = q0 + j + D;
        sr[j] = __shfl_sync(mask, qn < S ? cur.x : nxt.x, qn & (S - 1), S);
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        add_row<T, VB, P, Op::kScale>(acc, sv[j], ring[j], has);
        if (k + j + D < n) load_row<T, VB, P>(op, sr[j], ring[j], has, t, tl);  // refill
      }
    }
    if (k < n) {  // the last n - k < D items, in the ring already
      const int q0 = k & (S - 1);
      if (q0 == 0 && k > 0) cur = nxt;
#pragma unroll
      for (int j = 0; j < D - 1; ++j) {
        const float s = Op::kScale ? __int_as_float(__shfl_sync(mask, cur.y, q0 + j, S)) : 1.f;
        if (k + j < n) add_row<T, VB, P, Op::kScale>(acc, s, ring[j], has);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (has[p]) *reinterpret_cast<R*>(out_row + (t + p * tl) * V) = VT::put(acc[p]);
  }
}

// item k's terms at the row's w <= W elements (zeros past n)
template <typename T, int W, class Op>
__device__ __forceinline__ void load_terms(const Op& op, int begin, int k, int n, int w,
                                           float* terms) {
  const int2 it = k < n ? op.index(begin + k) : make_int2(0, 0);
  const T* row = op.row(it.x);
  const float s = __int_as_float(it.y);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const float a = (k < n && c < w) ? to_f32<T>(row[c]) : 0.f;
    terms[c] = Op::kScale ? __fmul_rn(s, a) : a;
  }
}

// A group of S lanes sums one narrow segment (w <= W elements a row): lane
// sl loads item k + sl's row, kItemSteps steps of S items ahead; every lane
// adds the step's items in order, each through a shuffle from the lane that
// loaded it (the same chain in every lane; columns past w are never
// stored); lane 0 stores.
template <typename T, int S, int W, class Op>
__device__ __forceinline__ void walk_items(const Op& op, T* __restrict__ out_row,
                                           bool init_out, int begin, int n, int w, int sl,
                                           unsigned mask) {
  constexpr int R = kItemSteps;
  static_assert(S % 8 == 0, "the items' shuffles go 8 at a time");
  float acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = (init_out && c < w) ? to_f32<T>(out_row[c]) : 0.f;
  float buf[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) load_terms<T, W>(op, begin, r * S + sl, n, w, buf[r]);
  int k = 0;
  for (; k + R * S <= n; k += R * S) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j0 = 0; j0 < S; j0 += 8) {  // 8 items' shuffles back to back, then their adds
        float term[8][W];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < W; ++c) term[j][c] = __shfl_sync(mask, buf[r][c], j0 + j, S);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < W; ++c) acc[c] = __fadd_rn(acc[c], term[j][c]);
        }
      }
      load_terms<T, W>(op, begin, k + (r + R) * S + sl, n, w, buf[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {  // the last steps, in the buffer already
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (k + r * S + j < n) {
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] = __fadd_rn(acc[c], __shfl_sync(mask, buf[r][c], j, S));
      }
    }
  }
  if (sl == 0) {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < w) out_row[c] = from_f32<T>(acc[c]);
    }
  }
}

// a hub block's team: its work entry (>= n_hub: none) and lane t of 32·hub_tw
__device__ __forceinline__ int hub_entry(const Plan& pl, int* t) {
  const int warp = threadIdx.x >> 5, per_block = (blockDim.x >> 5) / pl.hub_tw;
  *t = (warp % pl.hub_tw) * 32 + (threadIdx.x & 31);
  if (warp >= per_block * pl.hub_tw) return pl.n_hub;
  return blockIdx.x * per_block + warp / pl.hub_tw;
}

// a walk block's unit: its work entry (>= n_live: none), lane t of tl, lane
// sl of the S-lane shuffle domain and its mask
template <int S>
__device__ __forceinline__ int walk_entry(const Plan& pl, int* t, int* tl, int* sl,
                                          unsigned* mask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  const int b = blockIdx.x;
  if (pl.tw == 1) {
    *t = *sl = lane % S;
    *tl = S;
    *mask = S == 32 ? 0xFFFFFFFFu : ((1u << S) - 1u) << (lane / S * S);
    return pl.n_hub + (b * wpb + warp) * (32 / S) + lane / S;
  }
  const int per_block = wpb / pl.tw;
  *t = (warp % pl.tw) * 32 + lane;
  *tl = 32 * pl.tw;
  *sl = lane;
  *mask = 0xFFFFFFFFu;
  if (warp >= per_block * pl.tw) return pl.n_live;
  return pl.n_hub + b * per_block + warp / pl.tw;
}

// (a)'s rows without items (entries n_live.. n_work of the work list) get
// 0 from the walk kernel's blocks past its walk blocks: a warp takes 32
// entries, its lanes load their rows' ids at once and then write each row's
// vectors (vec_bytes at a time, one element when 0)
template <typename T, int VB>
__device__ __forceinline__ void zero_rows(const Plan& pl, const int4* __restrict__ work,
                                          T* __restrict__ out) {
  using R = typename RawOf<VB>::type;
  constexpr int V = Vec<T, VB>::V;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int stride = (gridDim.x - pl.walk_blocks) * warps * 32;
  for (int w0 = pl.n_live + ((blockIdx.x - pl.walk_blocks) * warps + (threadIdx.x >> 5)) * 32;
       w0 < pl.n_work; w0 += stride) {
    const int seg = w0 + lane < pl.n_work ? __ldg(&work[w0 + lane].x) : 0;
    const int rows = pl.n_work - w0 < 32 ? pl.n_work - w0 : 32;
    for (int j = 0; j < rows; ++j) {
      T* row = out + __shfl_sync(0xFFFFFFFFu, seg, j) * pl.ld;
      for (int v = lane; v < pl.nvec; v += 32) *reinterpret_cast<R*>(row + v * V) = R{};
    }
  }
}

// Two kernels a call. The hub kernel (on a side stream of high priority,
// forked from and joined to the caller's, so the two overlap) gives each of
// the work list's first n_hub segments a team of hub_tw warps, one vector a
// lane, a ring of kHubRingRegs registers; it has few blocks, so its deep
// ring costs no occupancy. The walk kernel gives each other live segment a
// unit (a group of G lanes, or a team of tw warps) with a ring of
// kRingRegs, longest first, then ((a)) writes 0 to the rows without items.

// columns: the hubs
template <typename T, int VB, class Op>
__global__ void __launch_bounds__(kWarps * 32)
cols_hub_kernel(Op op, T* __restrict__ out, bool init_out, const int4* __restrict__ work,
                Plan pl) {
  constexpr int kRegs = VB < 4 ? 1 : VB / 4;  // registers of a vector
  constexpr int DH = ring_depth(kHubRingRegs / kRegs, 32);
  int t;
  const int w = hub_entry(pl, &t);
  if (w >= pl.n_hub) return;
  const int4 e = __ldg(work + w);
  walk_cols<T, VB, 1, DH, 32>(op, out + e.x * pl.ld, init_out, e.y, e.z - e.y, t,
                              32 * pl.hub_tw, pl.hub_nvec, threadIdx.x & 31, 0xFFFFFFFFu);
}

// columns: the other live segments, then (a)'s rows without items
template <typename T, int VB, int G, int P, class Op>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
cols_walk_kernel(Op op, T* __restrict__ out, bool init_out, const int4* __restrict__ work,
                 Plan pl) {
  constexpr int S = G < 32 ? G : 32;
  constexpr int kRegs = VB < 4 ? 1 : VB / 4;
  constexpr int D =
      ring_depth(kRingRegs / (P * kRegs) > kMinRing ? kRingRegs / (P * kRegs) : kMinRing, S);
  if ((int)blockIdx.x >= pl.walk_blocks) return zero_rows<T, VB>(pl, work, out);
  int t, tl, sl;
  unsigned mask;
  const int w = walk_entry<S>(pl, &t, &tl, &sl, &mask);
  if (w >= pl.n_live) return;
  const int4 e = __ldg(work + w);
  walk_cols<T, VB, P, D, S>(op, out + e.x * pl.ld, init_out, e.y, e.z - e.y, t, tl, pl.nvec,
                            sl, mask);
}

// items (rows of at most W <= kMaxItemWidth elements): a warp a hub
template <typename T, int W, class Op>
__global__ void __launch_bounds__(kWarps * 32)
items_hub_kernel(Op op, T* __restrict__ out, bool init_out, const int4* __restrict__ work,
                 Plan pl) {
  int t;
  const int w = hub_entry(pl, &t);
  if (w >= pl.n_hub) return;
  const int4 e = __ldg(work + w);
  walk_items<T, 32, W>(op, out + e.x * pl.ld, init_out, e.y, e.z - e.y, pl.nvec, t,
                       0xFFFFFFFFu);
}

// items: a group of kItemGroup lanes a segment, then (a)'s rows without items
template <typename T, int W, class Op>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
items_walk_kernel(Op op, T* __restrict__ out, bool init_out, const int4* __restrict__ work,
                  Plan pl) {
  if ((int)blockIdx.x >= pl.walk_blocks) return zero_rows<T, sizeof(T)>(pl, work, out);
  int t, tl, sl;
  unsigned mask;
  const int w = walk_entry<kItemGroup>(pl, &t, &tl, &sl, &mask);
  if (w >= pl.n_live) return;
  const int4 e = __ldg(work + w);
  walk_items<T, kItemGroup, W>(op, out + e.x * pl.ld, init_out, e.y, e.z - e.y, pl.nvec, sl,
                               mask);
}

constexpr int kMaxDevices = 16;

// the calling thread's side stream (the highest priority) and fork and join
// events on the current device, made at first use
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

inline int side_of(Side** out) {
  thread_local Side sides[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  if (!sd.stream) {
    int least = 0, greatest = 0;
    rc = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (rc == cudaSuccess)
      rc = cudaStreamCreateWithPriority(&sd.stream, cudaStreamNonBlocking, greatest);
    if (rc == cudaSuccess) rc = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    if (rc == cudaSuccess) rc = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
    if (rc != cudaSuccess) return (int)rc;
  }
  *out = &sd;
  return 0;
}

// The launches of one instantiation: the hub kernel (when there are hubs)
// on the side stream, the walk kernel on s: blocks of kWarps warps (of the
// largest number of whole tw-warp teams that fit), one unit a live
// segment, and for (a) zero blocks, at most 8 a multiprocessor's worth
template <class HubKernel, class WalkKernel, class Op, typename T>
int launch(HubKernel hub_kernel, WalkKernel walk_kernel, const Op& op, T* out, bool init_out,
           const int4* work, Plan pl, int units_per_warp, cudaStream_t s) {
  const int warps = pl.tw > 1 ? pl.tw * (kWarps / pl.tw) : kWarps;
  const int hub_teams = kWarps / pl.hub_tw;
  const int64_t units = pl.tw > 1 ? warps / pl.tw : (int64_t)warps * units_per_warp;
  const int64_t hub = pl.n_hub > 0 ? (pl.n_hub + hub_teams - 1) / hub_teams : 0;
  const int64_t walk = (pl.n_live - pl.n_hub + units - 1) / units;
  int64_t zero = (pl.n_work - pl.n_live + 32 * warps - 1) / (32 * warps);  // 32 rows a warp
  if (zero > 1056) zero = 1056;
  if (hub > 0x7FFFFFFF || walk + zero > 0x7FFFFFFF || hub_teams < 1)
    return (int)cudaErrorInvalidValue;
  pl.walk_blocks = (int)walk;
  Side* sd = nullptr;
  if (hub > 0) {
    int rc = side_of(&sd);
    if (!rc) rc = (int)cudaEventRecord(sd->fork, s);
    if (!rc) rc = (int)cudaStreamWaitEvent(sd->stream, sd->fork, 0);
    if (rc) return rc;
    hub_kernel<<<(unsigned)hub, kWarps * 32, 0, sd->stream>>>(op, out, init_out, work, pl);
    rc = (int)cudaGetLastError();
    if (!rc) rc = (int)cudaEventRecord(sd->join, sd->stream);
    if (rc) return rc;
  }
  if (walk + zero > 0)
    walk_kernel<<<(unsigned)(walk + zero), warps * 32, 0, s>>>(op, out, init_out, work, pl);
  if (sd) {
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
    return (int)cudaStreamWaitEvent(s, sd->join, 0);
  }
  return 0;
}

// kernels of one type and op: the walk kernel by the layout's (vector
// bytes, group lanes, passes), the hub kernel by its vector bytes; vec_bytes
// 0 is the item walker
template <typename T, class Op>
using KernelOf = void (*)(Op, T*, bool, const int4*, Plan);

template <typename T, class Op>
KernelOf<T, Op> hub_kernel_of(int vb) {
  if constexpr (sizeof(T) == 2) {
    if (vb == 2) return cols_hub_kernel<T, 2, Op>;
  }
  if (vb == 4) return cols_hub_kernel<T, 4, Op>;
  if (vb == 8) return cols_hub_kernel<T, 8, Op>;
  if (vb == 16) return cols_hub_kernel<T, 16, Op>;
  return nullptr;
}

template <typename T, class Op, int VB>
KernelOf<T, Op> walk_kernel_of(int group, int passes) {
  if (group == 16) {
    if (passes == 1) return cols_walk_kernel<T, VB, 16, 1, Op>;
    if (passes == 2) return cols_walk_kernel<T, VB, 16, 2, Op>;
    if (passes == 4) return cols_walk_kernel<T, VB, 16, 4, Op>;
  } else if (group == 32) {
    if (passes == 1) return cols_walk_kernel<T, VB, 32, 1, Op>;
    if (passes == 2) return cols_walk_kernel<T, VB, 32, 2, Op>;
    if (passes == 4) return cols_walk_kernel<T, VB, 32, 4, Op>;
  }
  return nullptr;
}

template <typename T, class Op>
int dispatch(const Op& op, T* out, bool init_out, const int4* work, Plan pl, int vec_bytes,
             int group, int passes, int hub_vec_bytes, cudaStream_t s) {
  if (vec_bytes == 0) {
    constexpr int kPerWarp = 32 / kItemGroup;
    if (pl.nvec <= 2)
      return launch(items_hub_kernel<T, 2, Op>, items_walk_kernel<T, 2, Op>, op, out, init_out,
                    work, pl, kPerWarp, s);
    if (pl.nvec <= 4)
      return launch(items_hub_kernel<T, 4, Op>, items_walk_kernel<T, 4, Op>, op, out, init_out,
                    work, pl, kPerWarp, s);
    return launch(items_hub_kernel<T, kMaxItemWidth, Op>,
                  items_walk_kernel<T, kMaxItemWidth, Op>, op, out, init_out, work, pl,
                  kPerWarp, s);
  }
  KernelOf<T, Op> walk = nullptr;
  if constexpr (sizeof(T) == 2) {
    if (vec_bytes == 2) walk = walk_kernel_of<T, Op, 2>(group, passes);
  }
  if (vec_bytes == 4) walk = walk_kernel_of<T, Op, 4>(group, passes);
  if (vec_bytes == 8) walk = walk_kernel_of<T, Op, 8>(group, passes);
  if (vec_bytes == 16) walk = walk_kernel_of<T, Op, 16>(group, passes);
  const KernelOf<T, Op> hub = hub_kernel_of<T, Op>(hub_vec_bytes);
  if (!walk || !hub) return (int)cudaErrorInvalidValue;
  return launch(hub, walk, op, out, init_out, work, pl, 32 / (group < 32 ? group : 32), s);
}

// the launches of one type, for the entry points
template <typename T>
int gather_sum(const int4* work, Plan pl, const int2* items, const void* x, int64_t ldx,
               void* out, int vec_bytes, int group, int passes, int hub_vec_bytes,
               cudaStream_t s) {
  return dispatch(Gather<T>{items, static_cast<const T*>(x), ldx}, static_cast<T*>(out), false,
                  work, pl, vec_bytes, group, passes, hub_vec_bytes, s);
}

template <typename T>
int segment_sum(const int4* work, Plan pl, const int32_t* perm, const void* values,
                int64_t ldv, void* out, int vec_bytes, int group, int passes, int hub_vec_bytes,
                cudaStream_t s) {
  return dispatch(Terms<T>{perm, static_cast<const T*>(values), ldv}, static_cast<T*>(out),
                  true, work, pl, vec_bytes, group, passes, hub_vec_bytes, s);
}

}  // namespace pgcn_seg
