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
// sorted by tile-row, tile t at block column tile_cols[t]; s [n_rows, H] by
// destination row and t [n_cols, H] by source column (forward; the same n
// for a square pack, the local rows and the source buffer for a mesh slab)
// or node [n, 5H] = s | t | m | max(den, 1e-16) | ρ (backward, square
// only), f32; v [n_cols, H·D] f32 or bf16 (forward); g [n, H·D] f32, and
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

#include "tile_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// K5: forward sweep -> acc | m | den per row
template <typename TT, typename VT>
__global__ void __launch_bounds__(kThreads, 2)
gat_fwd_kernel(Sched sc, const float* __restrict__ s, const float* __restrict__ t,
               const VT* __restrict__ v,
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
      s_i[h] = h < H ? s[(size_t)grow * H + h] : 0.0f;
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
              live ? leaky(s_i[h] + t[(size_t)col * H + h], slope) : kNeg;
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

template <typename TT, typename VT>
void launch_fwd(const Sched& sc, const float* s, const float* t, const void* v,
                float* out, float* ws, int H, int D, float slope, Drop dr,
                cudaStream_t stream) {
  gat_fwd_kernel<TT, VT><<<grid_of(sc), kThreads, 0, stream>>>(
      sc, s, t, static_cast<const VT*>(v), out, ws, H, D, slope, dr);
}

template <typename TT, typename VT>
void launch_bwd(const Sched& sc, const float* node, const float* g, const float* gp,
                const void* vp, int P, int S, float* out, float* ws, int H, int D,
                float slope, Drop dr, cudaStream_t stream) {
  gat_bwd_kernel<TT, VT><<<grid_of(sc), kThreads, 0, stream>>>(
      sc, node, g, gp, static_cast<const VT*>(vp), P, S, out, ws, H, D, slope, dr);
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
                            const float* s, const float* t, const void* v,
                            int v_dtype,
                            float* out, float* ws, int H, int D, float slope,
                            int drop, uint32_t seed, uint32_t thr,
                            float inv_keep, void* stream) {
  const Sched sc{tiles, seg_tile_ptr, seg_row, seg_slot, n_seg, multi_row,
                 multi_slot_ptr, n_multi, tile_cols, tile_r, tile_c};
  if (!valid(sc, H, D)) return (int)cudaErrorInvalidValue;
  const Drop dr{drop, seed, thr, inv_keep};
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int rc = by_dtypes(tile_dtype, v_dtype, [&](auto* tt, auto* vt) {
    using TT = std::remove_pointer_t<decltype(tt)>;
    using VT = std::remove_pointer_t<decltype(vt)>;
    launch_fwd<TT, VT>(sc, s, t, v, out, ws, H, D, slope, dr, strm);
  });
  if (rc) return rc;
  merge<true>(sc, ws, out, H * D + 2 * H, H, D, strm);
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
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int rc = by_dtypes(tile_dtype, v_dtype, [&](auto* tt, auto* vt) {
    using TT = std::remove_pointer_t<decltype(tt)>;
    using VT = std::remove_pointer_t<decltype(vt)>;
    launch_bwd<TT, VT>(sc, node, g, gp, vp, P, S, out, ws, H, D, slope, dr, strm);
  });
  if (rc) return rc;
  merge<false>(sc, ws, out, H * D + 2 * H, H, D, strm);
  return (int)cudaGetLastError();
}
