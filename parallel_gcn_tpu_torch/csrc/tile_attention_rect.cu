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
// Inputs: the slab's tiles read only as != 0 (int8, bf16 or f32), with the
// segment schedule of ops/cuda_bcsr.tile_schedule; nd [n_rows, 4H] = s | m |
// max(den, 1e-16) | ρ per destination row and t [n_cols, H] per buffer row,
// f32; gp [n_rows, S] f32 and vp [n_cols, S] (v's dtype): g and v with head
// h at [h·P, h·P + D) and zeros elsewhere (as K6), and for the column
// sweep's dv loop g [n_rows, H·D] f32. Outputs: ds [n_rows, H] (row sweep),
// dv | dt [n_cols, H·D + H] (column sweep), f32.
//
// Hopper design. The slab is not symmetric, so K6's mirror trick does not
// apply, and the TPU runs two sweeps over two sort orders of the same tiles
// so that each output block is revisited on consecutive grid steps. Here
// both sweeps are K6's walk (tile_attention.cuh: a CTA per segment of a
// tile-row and 64 rows, a warp per row, the row's live entries listed 512
// columns a step and taken 32 at a time, one per lane):
//   * the row sweep walks the row-sorted slab as K6 walks its forward
//     orientation: the row's g_i and statistics sit in shared memory, each
//     lane gathers its entry's t_j and v_j (16-byte vectors of vp);
//   * the column sweep walks the column-sorted copy stored TRANSPOSED
//     (ops/tile_attention.RectAttention builds it once on the device), so
//     that a warp owns a buffer row j and reads its entries as a contiguous
//     row: v_j and t_j sit in shared memory, each lane gathers its entry's
//     destination statistics and g_i, and dv_j sums the batch serially with
//     the features over the lanes (K6's dv loop, from g's unpadded rows: a
//     variant reading the padded rows again ran slower);
//   * the column copy's coverage and padding tiles, all zero, are dropped on
//     the device; a buffer block with no tile keeps one empty segment, whose
//     CTA writes zeros. Every output row is written by exactly one CTA or by
//     the ordered merge of its segments: no atomics, no zero-fill pass, and
//     repeated runs are bit-identical.
// What bounds it on an H100: streaming both copies of the slab (twice K6's
// one pack) and, per live entry, the gathers of t_j, v_j (row sweep) and of
// the destination statistics and g_i twice (column sweep). No TMA, no copy
// pipeline and no tensor cores in this first version.

#include "tile_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// K7 row sweep -> ds per destination row
template <typename TT, typename VT>
__global__ void __launch_bounds__(kThreads, 2)
gat_bwd_rect_row_kernel(Sched sc, const float* __restrict__ nd,
                        const float* __restrict__ t, const float* __restrict__ gp,
                        const VT* __restrict__ vp, int P, int S,
                        float* __restrict__ out, float* __restrict__ ws, int H,
                        float slope, Drop dr) {
  __shared__ int list_s[kWarps][kListCap];
  __shared__ __align__(16) float row_s[kWarps][kMaxHP + 4 * kMaxH];  // g_i | nd_i

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int subs = sc.tile_r / kRows;
  const int seg = blockIdx.x / subs;
  const int r0 = (blockIdx.x % subs) * kRows;
  const int t0 = sc.seg_tile_ptr[seg];
  const int t1 = sc.seg_tile_ptr[seg + 1];
  int* list = list_s[warp];
  float* g_i = row_s[warp];       // padded per head, as gp
  float* n_i = g_i + kMaxHP;      // s_i | m_i | den_i | ρ_i
  float* dst0 = segment_dst(sc, out, ws, seg, r0, H);

  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int grow = sc.seg_row[seg] * sc.tile_r + r0 + rr;
    for (int i = lane; i < H * P; i += 32) g_i[i] = gp[(size_t)grow * S + i];
    for (int i = lane; i < 4 * H; i += 32) n_i[i] = nd[(size_t)grow * 4 * H + i];
    __syncwarp();
    float ds_p[kMaxH];  // per-lane partial sums
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) ds_p[h] = 0.0f;

    auto batch = [&](int base, int nb) {
      if (lane < nb) {
        const int col = list[base + lane];
        const VT* v_j = vp + (size_t)col * S;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          if (h < H) {
            float dot = 0.0f;
            for (int d = h * P; d < (h + 1) * P; d += 8) {
              float vj[8];
              load8(v_j + d, vj);
#pragma unroll
              for (int e = 0; e < 8; ++e) dot = fmaf(g_i[d + e], vj[e], dot);
            }
            const float pre = n_i[h] + t[(size_t)col * H + h];
            const float a = expf(leaky(pre, slope) - n_i[H + h]) / n_i[2 * H + h];
            if (dr.on)
              dot = hash_keep((uint32_t)grow, (uint32_t)col, h, dr.seed, dr.thr)
                        ? dot * dr.inv_keep : 0.0f;
            ds_p[h] += a * (dot - n_i[3 * H + h]) * leaky_grad(pre, slope);
          }
        }
      }
      __syncwarp();
    };
    const int rem = scan_row<TT>(sc, t0, t1, r0 + rr, list, lane, batch);
    if (rem) batch(0, rem);

    float* dst = dst0 + (size_t)rr * H;
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      if (h < H) {
        const float ds = warp_sum(ds_p[h]);
        if (lane == 0) dst[h] = ds;
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K7 column sweep over the transposed copy -> dv | dt per buffer row
template <typename TT, typename VT>
__global__ void __launch_bounds__(kThreads, 2)
gat_bwd_rect_col_kernel(Sched sc, const float* __restrict__ nd,
                        const float* __restrict__ t, const float* __restrict__ g,
                        const float* __restrict__ gp, const VT* __restrict__ vp,
                        int P, int S, float* __restrict__ out, float* __restrict__ ws,
                        int H, int D, float slope, Drop dr) {
  __shared__ int list_s[kWarps][kListCap];
  __shared__ float coef_s[kWarps][kMaxH][33];
  __shared__ __align__(16) float row_s[kWarps][kMaxHP + kMaxH];  // v_j | t_j

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int subs = sc.tile_r / kRows;
  const int seg = blockIdx.x / subs;
  const int r0 = (blockIdx.x % subs) * kRows;
  const int HD = H * D;
  const int width = HD + H;
  const int t0 = sc.seg_tile_ptr[seg];
  const int t1 = sc.seg_tile_ptr[seg + 1];
  int* list = list_s[warp];
  float* v_j = row_s[warp];      // padded per head, as vp
  float* t_j = v_j + kMaxHP;
  float* dst0 = segment_dst(sc, out, ws, seg, r0, width);
  int hk[kMaxK];  // head of the lane's k-th feature (lane + 32k)
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) hk[k] = lane + 32 * k < HD ? (lane + 32 * k) / D : 0;

  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int j = sc.seg_row[seg] * sc.tile_r + r0 + rr;  // buffer row
    for (int i = lane; i < H * P; i += 32) v_j[i] = to_float(vp[(size_t)j * S + i]);
    for (int i = lane; i < H; i += 32) t_j[i] = t[(size_t)j * H + i];
    __syncwarp();
    float dt_p[kMaxH], dv[kMaxK];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) dt_p[h] = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) dv[k] = 0.0f;

    auto batch = [&](int base, int nb) {
      if (lane < nb) {
        const int i = list[base + lane];  // destination row
        const float* n_i = nd + (size_t)i * 4 * H;
        const float* g_i = gp + (size_t)i * S;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          if (h < H) {
            float dot = 0.0f;
            for (int d = h * P; d < (h + 1) * P; d += 8) {
              float gi[8];
              load8(g_i + d, gi);
#pragma unroll
              for (int e = 0; e < 8; ++e) dot = fmaf(gi[e], v_j[d + e], dot);
            }
            const float pre = n_i[h] + t_j[h];
            const float a = expf(leaky(pre, slope) - n_i[H + h]) / n_i[2 * H + h];
            float an = a;
            if (dr.on) {
              const bool keep = hash_keep((uint32_t)i, (uint32_t)j, h, dr.seed, dr.thr);
              dot = keep ? dot * dr.inv_keep : 0.0f;
              an = keep ? a * dr.inv_keep : 0.0f;
            }
            dt_p[h] += a * (dot - n_i[3 * H + h]) * leaky_grad(pre, slope);
            coef_s[warp][h][lane] = an;
          }
        }
      }
      __syncwarp();
      for (int jj = 0; jj < nb; ++jj) {
        const float* gr = g + (size_t)list[base + jj] * HD;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          const int f = lane + 32 * k;
          if (f < HD) dv[k] = fmaf(coef_s[warp][hk[k]][jj], gr[f], dv[k]);
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
        const float dt = warp_sum(dt_p[h]);
        if (lane == 0) dst[HD + h] = dt;
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Segment schedule as in csrc/bcsr_spmm.cu (ops/cuda_bcsr.tile_schedule),
// over the row-sorted slab (row sweep) or its transposed column-sorted copy
// (column sweep, tile_cols = destination blocks); ws holds [n_slots, tile_r,
// width] floats, width = H (row) or H·D + H (column). drop != 0 applies the
// attention-dropout hash mask with (seed, thr) and multiplies kept terms by
// inv_keep. Needs 1 <= H <= 8, H·D <= 256, tile_r % 64 == 0,
// tile_c % 128 == 0, 16-byte aligned tiles, gp and vp padded as described
// at the top. Return cudaGetLastError() after the launches (0 on success).
extern "C" int pgcn_gat_bwd_rect_row(const void* tiles, int tile_dtype,
                                     const int* seg_tile_ptr, const int* seg_row,
                                     const int* seg_slot, int n_seg,
                                     const int* multi_row, const int* multi_slot_ptr,
                                     int n_multi, const int* tile_cols, int tile_r,
                                     int tile_c, const float* nd, const float* t,
                                     const float* gp, const void* vp, int v_dtype,
                                     int P, int S, float* out, float* ws, int H,
                                     int D, float slope, int drop, uint32_t seed,
                                     uint32_t thr, float inv_keep, void* stream) {
  const Sched sc{tiles, seg_tile_ptr, seg_row, seg_slot, n_seg, multi_row,
                 multi_slot_ptr, n_multi, tile_cols, tile_r, tile_c};
  if (!valid(sc, H, D) || !valid_padding(H, D, P, S)) return (int)cudaErrorInvalidValue;
  const Drop dr{drop, seed, thr, inv_keep};
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int rc = by_dtypes(tile_dtype, v_dtype, [&](auto* tt, auto* vt) {
    using TT = std::remove_pointer_t<decltype(tt)>;
    using VT = std::remove_pointer_t<decltype(vt)>;
    gat_bwd_rect_row_kernel<TT, VT><<<grid_of(sc), kThreads, 0, strm>>>(
        sc, nd, t, gp, static_cast<const VT*>(vp), P, S, out, ws, H, slope, dr);
  });
  if (rc) return rc;
  merge<false>(sc, ws, out, H, H, D, strm);
  return (int)cudaGetLastError();
}

extern "C" int pgcn_gat_bwd_rect_col(const void* tiles, int tile_dtype,
                                     const int* seg_tile_ptr, const int* seg_row,
                                     const int* seg_slot, int n_seg,
                                     const int* multi_row, const int* multi_slot_ptr,
                                     int n_multi, const int* tile_cols, int tile_r,
                                     int tile_c, const float* nd, const float* t,
                                     const float* g, const float* gp, const void* vp,
                                     int v_dtype, int P, int S, float* out, float* ws,
                                     int H, int D, float slope, int drop, uint32_t seed,
                                     uint32_t thr, float inv_keep, void* stream) {
  const Sched sc{tiles, seg_tile_ptr, seg_row, seg_slot, n_seg, multi_row,
                 multi_slot_ptr, n_multi, tile_cols, tile_r, tile_c};
  if (!valid(sc, H, D) || !valid_padding(H, D, P, S)) return (int)cudaErrorInvalidValue;
  const Drop dr{drop, seed, thr, inv_keep};
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int rc = by_dtypes(tile_dtype, v_dtype, [&](auto* tt, auto* vt) {
    using TT = std::remove_pointer_t<decltype(tt)>;
    using VT = std::remove_pointer_t<decltype(vt)>;
    gat_bwd_rect_col_kernel<TT, VT><<<grid_of(sc), kThreads, 0, strm>>>(
        sc, nd, t, g, gp, static_cast<const VT*>(vp), P, S, out, ws, H, D, slope, dr);
  });
  if (rc) return rc;
  merge<false>(sc, ws, out, H * D + H, H, D, strm);
  return (int)cudaGetLastError();
}
