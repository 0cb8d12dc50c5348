// GAT tile attention on a mesh slab, the backward K7, for sm_90a.
//
// Replaces the Pallas kernels of parallel_gcn_tpu/ops/tile_attention.py:
//   gat_bwd_rect_row_kernel: _bwd_rect_row_kernel (K7 row sweep). Per local
//     destination row i of the row-sorted slab, over its live entries j of
//     the source buffer:
//       ds_i += α_ij·(keep·⟨g_i, v_j⟩/(1−rate) − ρ_i)·leaky'(s_i + t_j),
//     α_ij = exp(LeakyReLU(s_i + t_j) − m_i)/den_i from the forward's saved
//     statistics (K6's forward half, without the mirror).
//   gat_bwd_rect_col_kernel: _bwd_rect_col_kernel (K7 column sweep). Per
//     buffer row j, over the destination rows i whose entries (i, j) are
//     live: the same jacobian term summed on the source side,
//       dt_j += α_ij·(keep·⟨g_i, v_j⟩/(1−rate) − ρ_i)·leaky'(s_i + t_j),
//       dv_j += α_ij·keep/(1−rate)·g_i,
//     with the statistics (m, den, ρ) of the destination row i, as the TPU
//     kernel takes them from the tile's row block.
// keep is the hash of the entry's own (local dest i, buffer src j) ids in
// both sweeps. The ops/tile_attention.py wrappers hold the plain versions.
//
// Inputs: the live-column index (ops/cuda_bcsr.AttnIndex) and segment
// schedule of the row-sorted slab (row sweep: units are local rows, listed
// columns buffer rows) or of its transposed column-sorted copy (column
// sweep: units are buffer rows, listed columns local rows); nd [n_rows, 4H]
// f32, per destination row and head h the 16-byte record s | m |
// max(den, 1e-16) | ρ at [4h, 4h + 4); t [n_buf, H] f32 per buffer row; gp
// [n_rows, S] f32 and vp [n_buf, S] (v's dtype): g and v with head h at
// [h·P, h·P + D) and zeros elsewhere (as K6; pgcn_pad_heads writes them).
// Outputs: ds [n_rows, H] (row sweep), dv | dt [n_buf, H·D + H] (column
// sweep), f32.
//
// Hopper design. The slab is not symmetric, so K6's mirror trick does not
// apply, and the TPU runs two sweeps over two sort orders of the same tiles.
// Here both sweeps are K6's walk over a live-column index, listed once per
// pack instead of rescanned from the 99%-zero int8 tiles on every call (the
// row slab's index is the one K5 walks; the column copy's is built at its
// first backward). One warp owns one unit and takes its entries 32 a batch,
// one per lane; the D-wide rows are gathered in 16-byte groups in the Team
// layout (tile_attention.cuh), several warp steps in flight:
//   * row sweep: per entry the lane loads t_j and forms A = α·leaky'(pre)
//     and the hash mask; the Team sums Σ A·keep·v_j over the gathered v_j
//     rows, and once per unit ds_i = ⟨g_i, Σ A·keep·v_j⟩ − ρ_i·Σ A: one dot
//     product per row, not per entry (K6's reassociation);
//   * column sweep: per entry the lane loads destination i's 16-byte head
//     records and forms an = α·keep/(1−rate), C = an·leaky'(pre) and
//     B = α·ρ_i·leaky'(pre); the Team reads each g_i group once, from the
//     padded f32 rows, into two weighted row sums dv_j = Σ an·g_i and
//     w_j = Σ C·g_i, and once per unit dt_j = ⟨v_j, w_j⟩ − Σ B;
//   * a segment's rows write the output, or a workspace slot that the
//     ordered merge of split tile-rows sums (no atomics: repeated runs are
//     bit-identical); the column copy's zero tiles are dropped on the
//     device, and a buffer block with no tile keeps one empty segment whose
//     units write zeros.
// What bounds it on an H100: per live entry the gathers of t_j and v_j (row
// sweep, 200 bytes at H = 2, D = 41 bf16) or of i's records and g_i (column
// sweep, 416 bytes), which reach L2 or HBM, and the issue of the per-step
// instructions; the slab's tiles are no longer read. No tensor cores: each
// warp's product is a weighted sum of gathered rows.

#include "tile_attention.cuh"

namespace {

constexpr int kRowBlocks = 4;  // __launch_bounds__ min blocks per SM (registers)
constexpr int kColBlocks = 3;
constexpr int kRowUnroll = 4;  // warp steps whose row loads are in flight together
constexpr int kColUnroll = 2;

// A destination row's records (nd: s | m | den | ρ per head, 16 bytes each).
template <int kH>
__device__ __forceinline__ void load_records(const float* p, int H, float (&s)[kH],
                                             float (&m)[kH], float (&den)[kH],
                                             float (&rho)[kH]) {
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    float4 r = make_float4(0.f, kNeg, 1.f, 0.f);
    if (h < H) r = __ldg(reinterpret_cast<const float4*>(p) + h);
    s[h] = r.x;
    m[h] = r.y;
    den[h] = r.z;
    rho[h] = r.w;
  }
}

// ---------------------------------------------------------------------------
// K7 row sweep -> ds per local destination row. Per head, with
// A = α·leaky'(pre) of each entry: ds_i = ⟨g_i, Σ_j A·keep·v_j⟩ − ρ_i·Σ_j A.
template <int kH, int kG, typename VT>
__global__ void __launch_bounds__(kThreads, kRowBlocks)
gat_bwd_rect_row_kernel(Sched sc, const int* __restrict__ ptr, const int* __restrict__ icol,
                        const float* __restrict__ nd, const float* __restrict__ t,
                        const float* __restrict__ gp, const VT* __restrict__ vp, int P,
                        int S, float* __restrict__ out, float* __restrict__ ws, int H,
                        float slope, DropArgs da) {
  const Drop dr = load_drop(da);
  __shared__ float c_s[kWarps][kH][32];  // A·keep per edge of the batch and head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Unit un = unit_of(sc, ptr, out, ws, H);
  const Team<kG> tm(lane, H, P);

  float s_i[kH], m_i[kH], den_i[kH], rho_i[kH];
  load_records<kH>(nd + (size_t)un.grow * 4 * H, H, s_i, m_i, den_i, rho_i);
  float sum_a[kH];  // this lane's edges
#pragma unroll
  for (int h = 0; h < kH; ++h) sum_a[h] = 0.0f;
  float sv[kG][8];  // this lane's groups of Σ A·keep·v_j
#pragma unroll
  for (int k = 0; k < kG; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) sv[k][e] = 0.0f;

  for (int base = un.p0; base < un.p1; base += 32) {
    const int nb = min(32, un.p1 - base);
    const bool live = lane < nb;
    const int col = live ? icol[base + lane] : 0;  // buffer row j
    float t_j[kH];
    load_heads<kH>(t + (size_t)col * H, H, t_j);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      if (h < H) {
        const float pre = s_i[h] + t_j[h];
        const float a = expf(leaky(pre, slope) - m_i[h]) / den_i[h];
        const float A = a * leaky_grad(pre, slope);
        float ka = 1.0f;
        if (dr.on)
          ka = hash_keep((uint32_t)un.grow, (uint32_t)col, h, dr.seed, dr.thr) ? dr.inv_keep
                                                                                 : 0.0f;
        if (live) sum_a[h] += A;
        c_s[warp][h][lane] = A * ka;
      }
    }
    __syncwarp();
    for (int j0 = 0; j0 < nb; j0 += kRowUnroll * tm.E) {
      Raw8<VT> xv[kRowUnroll][kG];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int j = j0 + u * tm.E + tm.slot[k];
          const int c = __shfl_sync(kFull, col, j & 31);
          if (tm.on[k] && j < nb) xv[u][k].load(vp + (size_t)c * S + tm.offset(k, P));
          else xv[u][k].zero();
        }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int j = j0 + u * tm.E + tm.slot[k];
          if (tm.on[k] && j < nb) {
            const float ca = c_s[warp][tm.h[k]][j];
            float v_j[8];
            xv[u][k].get(v_j);
#pragma unroll
            for (int e = 0; e < 8; ++e) sv[k][e] = fmaf(ca, v_j[e], sv[k][e]);
          }
        }
    }
    __syncwarp();
  }

  float xs[kH];
  row_dots<kH>(tm, gp, un.grow, S, P, H, sv, xs);
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if (h < H) {
      const float sa = warp_sum(sum_a[h]);
      if (lane == 0) un.dst[h] = xs[h] - rho_i[h] * sa;
    }
  }
}

// ---------------------------------------------------------------------------
// K7 column sweep over the transposed copy -> dv | dt per buffer row j. Per
// head, with an = α·keep/(1−rate), C = an·leaky'(pre) and
// B = α·ρ_i·leaky'(pre) of each entry (i, j):
//   dv_j = Σ_i an·g_i,   dt_j = ⟨v_j, Σ_i C·g_i⟩ − Σ_i B.
template <int kH, int kG, typename VT>
__global__ void __launch_bounds__(kThreads, kColBlocks)
gat_bwd_rect_col_kernel(Sched sc, const int* __restrict__ ptr, const int* __restrict__ icol,
                        const float* __restrict__ nd, const float* __restrict__ t,
                        const float* __restrict__ gp, const VT* __restrict__ vp, int P,
                        int S, float* __restrict__ out, float* __restrict__ ws, int H, int D,
                        float slope, DropArgs da) {
  const Drop dr = load_drop(da);
  __shared__ float e_s[kWarps][2][kH][32];  // an and C per edge of the batch and head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int HD = H * D;
  const Unit un = unit_of(sc, ptr, out, ws, HD + H);
  const Team<kG> tm(lane, H, P);

  float t_j[kH];
  load_heads<kH>(t + (size_t)un.grow * H, H, t_j);
  float sum_b[kH];  // this lane's edges
#pragma unroll
  for (int h = 0; h < kH; ++h) sum_b[h] = 0.0f;
  float dv[kG][8], w[kG][8];  // this lane's groups of Σ an·g_i and Σ C·g_i
#pragma unroll
  for (int k = 0; k < kG; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) dv[k][e] = w[k][e] = 0.0f;

  for (int base = un.p0; base < un.p1; base += 32) {
    const int nb = min(32, un.p1 - base);
    const bool live = lane < nb;
    const int col = live ? icol[base + lane] : 0;  // destination row i
    float s_i[kH], m_i[kH], den_i[kH], rho_i[kH];
    load_records<kH>(nd + (size_t)col * 4 * H, H, s_i, m_i, den_i, rho_i);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      if (h < H) {
        const float pre = s_i[h] + t_j[h];
        const float a = expf(leaky(pre, slope) - m_i[h]) / den_i[h];
        const float lg = leaky_grad(pre, slope);
        float an = a;
        if (dr.on)
          an = hash_keep((uint32_t)col, (uint32_t)un.grow, h, dr.seed, dr.thr)
                   ? a * dr.inv_keep : 0.0f;
        if (live) sum_b[h] += a * rho_i[h] * lg;
        e_s[warp][0][h][lane] = an;
        e_s[warp][1][h][lane] = an * lg;
      }
    }
    __syncwarp();
    for (int j0 = 0; j0 < nb; j0 += kColUnroll * tm.E) {
      Raw8<float> xg[kColUnroll][kG];
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int j = j0 + u * tm.E + tm.slot[k];
          const int c = __shfl_sync(kFull, col, j & 31);
          if (tm.on[k] && j < nb) xg[u][k].load(gp + (size_t)c * S + tm.offset(k, P));
          else xg[u][k].zero();
        }
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int j = j0 + u * tm.E + tm.slot[k];
          if (tm.on[k] && j < nb) {
            const float an = e_s[warp][0][tm.h[k]][j], c = e_s[warp][1][tm.h[k]][j];
            float g_i[8];
            xg[u][k].get(g_i);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              dv[k][e] = fmaf(an, g_i[e], dv[k][e]);
              w[k][e] = fmaf(c, g_i[e], w[k][e]);
            }
          }
        }
    }
    __syncwarp();
  }

  float xt[kH];
  row_dots<kH>(tm, vp, un.grow, S, P, H, w, xt);
  sum_slots(tm, dv);
  store_row(tm, dv, un.dst, D);
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if (h < H) {
      const float sb = warp_sum(sum_b[h]);
      if (lane == 0) un.dst[HD + h] = xt[h] - sb;
    }
  }
}

template <bool kCol>
int launch_rect(const int* idx_ptr, const int* idx_col, const Sched& sc, const float* nd,
                const float* t, const float* gp, const void* vp, int v_dtype, int P, int S,
                float* out, float* ws, int H, int D, float slope, const DropArgs& dr,
                cudaStream_t strm) {
  if (!valid_walk(sc, H, D, P, S)) return (int)cudaErrorInvalidValue;
  const int rc = by_shape(H, P, v_dtype, [&](auto kh, auto kg, auto* vt) {
    using VT = std::remove_pointer_t<decltype(vt)>;
    constexpr int kH = decltype(kh)::value, kG = decltype(kg)::value;
    const VT* v = static_cast<const VT*>(vp);
    if constexpr (kCol)
      gat_bwd_rect_col_kernel<kH, kG, VT><<<walk_grid(sc), kThreads, 0, strm>>>(
          sc, idx_ptr, idx_col, nd, t, gp, v, P, S, out, ws, H, D, slope, dr);
    else
      gat_bwd_rect_row_kernel<kH, kG, VT><<<walk_grid(sc), kThreads, 0, strm>>>(
          sc, idx_ptr, idx_col, nd, t, gp, v, P, S, out, ws, H, slope, dr);
  });
  if (rc) return rc;
  const int width = kCol ? H * D + H : H;
  merge<false>(sc, ws, out, width, H, D, strm);
  return (int)cudaGetLastError();
}

}  // namespace

// The padded rows K7 reads: x [n, H·D] (dtype 0 = float32, 1 = bfloat16) ->
// xp [n, S], head h at [h·P, h·P + D), zeros elsewhere (16-byte aligned).
extern "C" int pgcn_pad_heads(const void* x, void* xp, int dtype, int n, int H, int D,
                              int P, int S, void* stream) {
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0) pad_heads<float>(x, xp, n, H, D, P, S, strm);
  else if (dtype == 1) pad_heads<__nv_bfloat16>(x, xp, n, H, D, P, S, strm);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The walk's AttnIndex (idx_ptr, idx_col) and schedule segments of the
// row-sorted slab (row sweep) or of its transposed column-sorted copy
// (column sweep); ws holds [n_slots, tile_r, width] floats, width = H (row)
// or H·D + H (column). drop != 0 applies the attention-dropout hash mask
// with (*seed, thr), seed pointing to an int32 in device memory, and
// multiplies kept terms by inv_keep. Needs 1 <= H <= 8,
// H·D <= 256, H·P <= 512, tile_r % 8 == 0 and nd, gp, vp as described at the
// top, 16-byte aligned. Return cudaGetLastError() after the launches (0 on
// success).
extern "C" int pgcn_gat_bwd_rect_row(const int* idx_ptr, const int* idx_col,
                                     const int* seg_row, const int* seg_slot, int n_seg,
                                     const int* multi_row, const int* multi_slot_ptr,
                                     int n_multi, int tile_r, const float* nd,
                                     const float* t, const float* gp, const void* vp,
                                     int v_dtype, int P, int S, float* out, float* ws,
                                     int H, int D, float slope, int drop, const int* seed,
                                     uint32_t thr, float inv_keep, void* stream) {
  const Sched sc{seg_row, seg_slot, n_seg, multi_row, multi_slot_ptr, n_multi, tile_r};
  return launch_rect<false>(idx_ptr, idx_col, sc, nd, t, gp, vp, v_dtype, P, S, out, ws,
                            H, D, slope, DropArgs{drop, seed, thr, inv_keep},
                            static_cast<cudaStream_t>(stream));
}

extern "C" int pgcn_gat_bwd_rect_col(const int* idx_ptr, const int* idx_col,
                                     const int* seg_row, const int* seg_slot, int n_seg,
                                     const int* multi_row, const int* multi_slot_ptr,
                                     int n_multi, int tile_r, const float* nd,
                                     const float* t, const float* gp, const void* vp,
                                     int v_dtype, int P, int S, float* out, float* ws,
                                     int H, int D, float slope, int drop, const int* seed,
                                     uint32_t thr, float inv_keep, void* stream) {
  const Sched sc{seg_row, seg_slot, n_seg, multi_row, multi_slot_ptr, n_multi, tile_r};
  return launch_rect<true>(idx_ptr, idx_col, sc, nd, t, gp, vp, v_dtype, P, S, out, ws,
                           H, D, slope, DropArgs{drop, seed, thr, inv_keep},
                           static_cast<cudaStream_t>(stream));
}
