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
// Inputs: the pack's live-column index (ops/cuda_bcsr.AttnIndex: for unit
// u = seg·tile_r + r, row r of segment seg of the pack's schedule, the global
// column ids col[ptr[u] : ptr[u+1]] in tile and column order) and the
// schedule; s [n_rows, H] by destination row and t [n_cols, H] by source
// column (forward; the same n for a square pack, the local rows and the
// source buffer for a mesh slab) or node [n, R] (backward, square only):
// per head h the record s | t | m | max(den, 1e-16) | ρ at [5h, 5h + 5),
// R = 5H rounded up to 4, all f32; v [n_cols, H·D] f32 or bf16 and, in the
// backward, g [n, H·D] f32, which the entries first copy into padded rows
// vp and gp [rows, S]: head h's D features at [h·P, h·P + D), zeros to
// h·P + P, P = D rounded up to 8, S ≥ H·P a multiple of 8. Output rows are
// [n, H·D + 2H] f32: acc | m | den (forward), dv | ds | dt (backward).
//
// Hopper design. The TPU kernel walks every tile densely on one sequential
// grid: each tile is a [512, 512] block of logits on the MXU. The synth-reddit
// pack is 99% zeros (11.7M live entries in 2,596 tiles of 512×1024), so here
// the work follows the live entries, listed once per pack (the index, 4 bytes
// an entry) instead of rescanned from the 1.36 GB of tiles on every call:
//   * one warp owns one unit (a row of a segment: at most 8 tiles, so the
//     hub tile-rows of 228 and 207 tiles are split) and reads its columns 32
//     at a time straight from the index, one per lane; no shared list, so
//     registers set the occupancy (__launch_bounds__ min blocks kFwdBlocks,
//     kBwdBlocks: 64 and 80 registers, 4 and 3 blocks of 8 warps an SM);
//   * per batch, lane-parallel over its edge: the logits from one vector
//     load of t_j and the online-softmax step (K5), or both orientations'
//     scalars from node_j's 16-byte records (K6: α, α', the hash masks),
//     kept in shared memory;
//   * the D-wide rows v_j and g_j are gathered in 16-byte vectors with the
//     Team layout (tile_attention.cuh): a warp step loads one 8-feature group
//     per lane for E = 32 / (H·P/8) edges at once (2 at H = 2, D = 41; 4 at
//     D = 32), several steps' loads in flight (kFwdUnroll, kBwdUnroll);
//   * K6 reads each g_j group once, from one padded array, and adds it into
//     two weighted row sums (dv_i and Σ B·keep'·g_j) while v_j goes into a
//     third (Σ A·keep·v_j); the dot products with g_i and v_i that give ds_i
//     and dt_i are taken once per row, not once per entry;
//   * the row's state (m, den, acc; or partial ds, dt, dv) lives in
//     registers and is written once per unit: straight to the output when
//     the segment is its tile-row's only one, else to a workspace slot that
//     a second kernel merges in segment order (flash rescale for K5, plain
//     sums for K6). No atomics: repeated runs are bit-identical.
// What bounds it on an H100: per live entry the gathers of v_j (K5) and of
// node_j, v_j and g_j (K6, 0.6 KB an entry at H = 2, D = 41), which reach
// L2 or HBM (the backward's rows are 150 MB, above the 50 MB L2), and the
// issue of the per-step instructions; the index and the tiles' former
// 1.36 GB stream are no longer on the path. No tensor cores: each warp's
// product is a weighted sum of gathered rows.

#include "tile_attention.cuh"

namespace {

constexpr int kFwdBlocks = 2;  // __launch_bounds__ min blocks per SM (registers)
constexpr int kBwdBlocks = 3;
constexpr int kFwdUnroll = 4;  // warp steps whose row loads are in flight together
constexpr int kBwdUnroll = 2;
constexpr int kEdgeTerms = 3;  // K6's per-edge, per-head scalars in shared memory

// ---------------------------------------------------------------------------
// K5: forward walk -> acc | m | den per row
template <int kH, int kG, typename VT>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
gat_fwd_kernel(Sched sc, const int* __restrict__ ptr, const int* __restrict__ icol,
               const float* __restrict__ s, const float* __restrict__ t,
               const VT* __restrict__ v, int P, int S, float* __restrict__ out,
               float* __restrict__ ws, int H, int D, float slope, DropArgs da) {
  const Drop dr = load_drop(da);
  __shared__ float coef_s[kWarps][kH][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int HD = H * D;
  const Unit un = unit_of(sc, ptr, out, ws, HD + 2 * H);
  const Team<kG> tm(lane, H, P);

  float s_i[kH], m[kH], den[kH];  // den: this lane's partial sum
  load_heads<kH>(s + (size_t)un.grow * H, H, s_i);
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    m[h] = kNeg;
    den[h] = 0.0f;
  }
  float acc[kG][8];
#pragma unroll
  for (int k = 0; k < kG; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.0f;

  for (int base = un.p0; base < un.p1; base += 32) {
    const int nb = min(32, un.p1 - base);
    const bool live = lane < nb;
    const int col = live ? icol[base + lane] : 0;
    float t_j[kH];
    load_heads<kH>(t + (size_t)col * H, H, t_j);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      if (h < H) {
        const float e = live ? leaky(s_i[h] + t_j[h], slope) : kNeg;
        const float m_new = fmaxf(m[h], warp_max(e));
        const float scale = expf(m[h] - m_new);
        den[h] *= scale;
#pragma unroll
        for (int k = 0; k < kG; ++k)
          if (tm.h[k] == h)
#pragma unroll
            for (int f = 0; f < 8; ++f) acc[k][f] *= scale;
        m[h] = m_new;
        const float w = live ? expf(e - m_new) : 0.0f;
        den[h] += w;
        float wn = w;
        if (dr.on)
          wn = live && hash_keep((uint32_t)un.grow, (uint32_t)col, h, dr.seed, dr.thr)
                   ? w * dr.inv_keep : 0.0f;
        coef_s[warp][h][lane] = wn;
      }
    }
    __syncwarp();
    for (int j0 = 0; j0 < nb; j0 += kFwdUnroll * tm.E) {
      Raw8<VT> x[kFwdUnroll][kG];
#pragma unroll
      for (int u = 0; u < kFwdUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int j = j0 + u * tm.E + tm.slot[k];
          const int c = __shfl_sync(kFull, col, j & 31);
          if (tm.on[k] && j < nb) x[u][k].load(v + (size_t)c * S + tm.offset(k, P));
          else x[u][k].zero();
        }
#pragma unroll
      for (int u = 0; u < kFwdUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int j = j0 + u * tm.E + tm.slot[k];
          if (tm.on[k] && j < nb) {
            const float w = coef_s[warp][tm.h[k]][j];
            float f[8];
            x[u][k].get(f);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[k][e] = fmaf(w, f[e], acc[k][e]);
          }
        }
    }
    __syncwarp();
  }

  sum_slots(tm, acc);
  store_row(tm, acc, un.dst, D);
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if (h < H) {
      const float d = warp_sum(den[h]);
      if (lane == 0) {
        un.dst[HD + h] = m[h];
        un.dst[HD + H + h] = d;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: backward walk -> dv | ds | dt per row. Per head, with A = α·leaky'(pre)
// and B = α'·leaky'(pre') of each entry,
//   ds_i = ⟨g_i, Σ_j A·keep·v_j⟩ − ρ_i·Σ_j A,
//   dt_i = ⟨v_i, Σ_j B·keep'·g_j⟩ − Σ_j B·ρ_j,   dv_i = Σ_j α'·keep'·g_j,
// so a lane sums its groups' weighted rows and the dot products are taken
// once per row, not once per entry.
template <int kH, int kG, typename VT>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
gat_bwd_kernel(Sched sc, const int* __restrict__ ptr, const int* __restrict__ icol,
               const float* __restrict__ node, const float* __restrict__ gp,
               const VT* __restrict__ vp, int P, int S, float* __restrict__ out,
               float* __restrict__ ws, int H, int D, float slope, DropArgs da) {
  const Drop dr = load_drop(da);
  // per edge of the batch and head: A·keep, B·keep', α'·keep'
  __shared__ float e_s[kWarps][kEdgeTerms][kH][32];
  constexpr int kRec = (5 * kH + 3) / 4 * 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int HD = H * D;
  const int R = (5 * H + 3) / 4 * 4;
  const Unit un = unit_of(sc, ptr, out, ws, HD + 2 * H);
  const Team<kG> tm(lane, H, P);

  // row i's node record
  float s_i[kH], t_i[kH], m_i[kH], den_i[kH];
  const float* n_i = node + (size_t)un.grow * R;
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    s_i[h] = h < H ? n_i[5 * h] : 0.0f;
    t_i[h] = h < H ? n_i[5 * h + 1] : 0.0f;
    m_i[h] = h < H ? n_i[5 * h + 2] : 0.0f;
    den_i[h] = h < H ? n_i[5 * h + 3] : 1.0f;
  }
  // this lane's edges: Σ A and Σ B·ρ_j per head; its groups' weighted rows
  float sum_a[kH], sum_brho[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) sum_a[h] = sum_brho[h] = 0.0f;
  float sv[kG][8], sg[kG][8], dv[kG][8];
#pragma unroll
  for (int k = 0; k < kG; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) sv[k][e] = sg[k][e] = dv[k][e] = 0.0f;

  for (int base = un.p0; base < un.p1; base += 32) {
    const int nb = min(32, un.p1 - base);
    const bool live = lane < nb;
    const int col = live ? icol[base + lane] : 0;
    float rec[kRec];
    const float4* n_j = reinterpret_cast<const float4*>(node + (size_t)col * R);
#pragma unroll
    for (int i = 0; i < kRec / 4; ++i) {
      if (4 * i < R) {
        const float4 a = __ldg(n_j + i);
        rec[4 * i] = a.x; rec[4 * i + 1] = a.y; rec[4 * i + 2] = a.z; rec[4 * i + 3] = a.w;
      } else {
        rec[4 * i] = rec[4 * i + 1] = rec[4 * i + 2] = rec[4 * i + 3] = 1.0f;
      }
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      if (h < H) {
        // forward orientation: dest i, src j
        const float pre = s_i[h] + rec[5 * h + 1];
        const float a = expf(leaky(pre, slope) - m_i[h]) / den_i[h];
        // mirrored orientation: dest j, src i
        const float pre_m = rec[5 * h] + t_i[h];
        const float a_m = expf(leaky(pre_m, slope) - rec[5 * h + 2]) / rec[5 * h + 3];
        float ka = 1.0f, kb = 1.0f;
        if (dr.on) {
          ka = hash_keep((uint32_t)un.grow, (uint32_t)col, h, dr.seed, dr.thr) ? dr.inv_keep
                                                                                 : 0.0f;
          kb = hash_keep((uint32_t)col, (uint32_t)un.grow, h, dr.seed, dr.thr) ? dr.inv_keep
                                                                                 : 0.0f;
        }
        const float A = a * leaky_grad(pre, slope);
        const float B = a_m * leaky_grad(pre_m, slope);
        if (live) {
          sum_a[h] += A;
          sum_brho[h] += B * rec[5 * h + 4];
        }
        e_s[warp][0][h][lane] = A * ka;
        e_s[warp][1][h][lane] = B * kb;
        e_s[warp][2][h][lane] = a_m * kb;
      }
    }
    __syncwarp();
    for (int j0 = 0; j0 < nb; j0 += kBwdUnroll * tm.E) {
      Raw8<VT> xv[kBwdUnroll][kG];
      Raw8<float> xg[kBwdUnroll][kG];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int j = j0 + u * tm.E + tm.slot[k];
          const int c = __shfl_sync(kFull, col, j & 31);
          if (tm.on[k] && j < nb) {
            xv[u][k].load(vp + (size_t)c * S + tm.offset(k, P));
            xg[u][k].load(gp + (size_t)c * S + tm.offset(k, P));
          } else {
            xv[u][k].zero();
            xg[u][k].zero();
          }
        }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int j = j0 + u * tm.E + tm.slot[k];
          if (tm.on[k] && j < nb) {
            const int h = tm.h[k];
            const float ca = e_s[warp][0][h][j], cb = e_s[warp][1][h][j];
            const float cv = e_s[warp][2][h][j];
            float v_j[8], g_j[8];
            xv[u][k].get(v_j);
            xg[u][k].get(g_j);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sv[k][e] = fmaf(ca, v_j[e], sv[k][e]);
              sg[k][e] = fmaf(cb, g_j[e], sg[k][e]);
              dv[k][e] = fmaf(cv, g_j[e], dv[k][e]);
            }
          }
        }
    }
    __syncwarp();
  }

  // the dot products with the row's own g_i and v_i groups, per head
  float xs[kH], xt[kH];
  row_dots<kH>(tm, gp, un.grow, S, P, H, sv, xs);
  row_dots<kH>(tm, vp, un.grow, S, P, H, sg, xt);
  sum_slots(tm, dv);
  store_row(tm, dv, un.dst, D);
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if (h < H) {
      const float sa = warp_sum(sum_a[h]);
      const float sb = warp_sum(sum_brho[h]);
      if (lane == 0) {
        un.dst[HD + h] = xs[h] - n_i[5 * h + 4] * sa;
        un.dst[HD + H + h] = xt[h] - sb;
      }
    }
  }
}

}  // namespace

// The schedule's segments (ops/cuda_bcsr.tile_schedule) and the pack's
// AttnIndex (idx_ptr, idx_col); v [n_cols, H·D] and (backward) g [n, H·D]
// f32 as given, which the entries first copy into the padded workspaces vp
// and gp ([rows, S], described at the top, 16-byte aligned); ws holds
// [n_slots, tile_r, H·D + 2H] floats. drop != 0 applies the
// attention-dropout hash mask with (*seed, thr), seed pointing to an int32
// in device memory, and multiplies kept terms by inv_keep. Needs 1 <= H <= 8,
// H·D <= 256, H·P <= 512 and tile_r % 8 == 0.
// Return cudaGetLastError() after the launches (0 on success).
extern "C" int pgcn_gat_fwd(const int* idx_ptr, const int* idx_col, const int* seg_row,
                            const int* seg_slot, int n_seg, const int* multi_row,
                            const int* multi_slot_ptr, int n_multi, int tile_r,
                            const float* s, const float* t, const void* v, int n_cols,
                            int v_dtype, void* vp, int P, int S, float* out, float* ws,
                            int H, int D, float slope, int drop, const int* seed,
                            uint32_t thr, float inv_keep, void* stream) {
  const Sched sc{seg_row, seg_slot, n_seg, multi_row, multi_slot_ptr, n_multi, tile_r};
  if (!valid_walk(sc, H, D, P, S)) return (int)cudaErrorInvalidValue;
  const DropArgs dr{drop, seed, thr, inv_keep};
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int rc = by_shape(H, P, v_dtype, [&](auto kh, auto kg, auto* vt) {
    using VT = std::remove_pointer_t<decltype(vt)>;
    pad_heads<VT>(v, vp, n_cols, H, D, P, S, strm);
    gat_fwd_kernel<decltype(kh)::value, decltype(kg)::value, VT>
        <<<walk_grid(sc), kThreads, 0, strm>>>(sc, idx_ptr, idx_col, s, t,
                                               static_cast<const VT*>(vp), P, S, out, ws,
                                               H, D, slope, dr);
  });
  if (rc) return rc;
  merge<true>(sc, ws, out, H * D + 2 * H, H, D, strm);
  return (int)cudaGetLastError();
}

extern "C" int pgcn_gat_bwd(const int* idx_ptr, const int* idx_col, const int* seg_row,
                            const int* seg_slot, int n_seg, const int* multi_row,
                            const int* multi_slot_ptr, int n_multi, int tile_r,
                            const float* node, const float* g, const void* v, int n,
                            int v_dtype, float* gp, void* vp, int P, int S, float* out,
                            float* ws, int H, int D, float slope, int drop, const int* seed,
                            uint32_t thr, float inv_keep, void* stream) {
  const Sched sc{seg_row, seg_slot, n_seg, multi_row, multi_slot_ptr, n_multi, tile_r};
  if (!valid_walk(sc, H, D, P, S)) return (int)cudaErrorInvalidValue;
  const DropArgs dr{drop, seed, thr, inv_keep};
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int rc = by_shape(H, P, v_dtype, [&](auto kh, auto kg, auto* vt) {
    using VT = std::remove_pointer_t<decltype(vt)>;
    pad_heads<float>(g, gp, n, H, D, P, S, strm);
    pad_heads<VT>(v, vp, n, H, D, P, S, strm);
    gat_bwd_kernel<decltype(kh)::value, decltype(kg)::value, VT>
        <<<walk_grid(sc), kThreads, 0, strm>>>(sc, idx_ptr, idx_col, node, gp,
                                               static_cast<const VT*>(vp), P, S, out, ws,
                                               H, D, slope, dr);
  });
  if (rc) return rc;
  merge<false>(sc, ws, out, H * D + 2 * H, H, D, strm);
  return (int)cudaGetLastError();
}
