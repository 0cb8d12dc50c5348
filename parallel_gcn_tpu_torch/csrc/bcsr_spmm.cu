// Block-sparse (BCSR) tile SpMM, out = A · x, for sm_90a.
//
// Replaces the Pallas kernels of parallel_gcn_tpu/ops/pallas_bcsr.py:
//   kScaled = false: _bcsr_kernel (K3), value tiles f32/bf16 or int8
//   kScaled = true:  _bcsr_kernel_scaled (K4), int8 pattern tiles B with the
//                    symmetric normalization rebuilt per tile:
//                    ((d_r ⊙ B ⊙ d_c) rounded to x's dtype) @ x
// Tiles are [T, tile_r, tile_c], sorted by tile-row; tile t sits at block
// column tile_cols[t]. out is [n_tile_rows·tile_r, F] float32 with float32
// accumulation.
//
// Operand rounding follows the Pallas kernels exactly: an int8 tile is
// converted to x's dtype (exact); otherwise x is converted to the tile's
// dtype (so bf16 tiles round f32 x to bf16); the scaled form multiplies
// (B · d_c) · d_r in f32 and rounds the product to x's dtype. The products
// of the rounded operands are exact in f32, so only the summation order
// differs from the plain PyTorch version in ops/cuda_bcsr.py.
//
// Hopper design. The TPU kernel walks the tiles on one sequential grid and
// keeps the output block resident, zeroing it at a tile-row's first tile.
// Here blocks run in parallel in no order. The host cuts each tile-row's
// tiles into segments of at most a few tiles (ops/cuda_bcsr.tile_schedule):
// synth-reddit's community order leaves two hub tile-rows with over 200 of
// the 2,596 tiles, and one CTA walking all of them would take the whole
// kernel's time. Each CTA owns one (segment, row block, feature block),
// accumulates in registers and writes its rows once: straight into out when
// the segment is its tile-row's only one, else into a workspace slot that a
// second kernel sums in segment order. No atomics, a deterministic sum, and
// zeros for a tile-row with no tiles.
//
// Compute dtype bf16 (int8 tiles with bf16 x, bf16 tiles): spmm_pipe_kernel.
//   * x arrives as one contiguous bf16 buffer with F padded to a multiple of
//     16 (the wrapper's copy), so every x row is 16-byte aligned.
//   * A CTA covers 256 rows of a tile (8 warps × 32 rows) and 64 features,
//     two CTAs per SM, so each x chunk is staged twice per 512-row tile, not
//     8 times; wider F takes one 64-feature block after another, the grid's
//     fastest index, so the CTAs of one segment run together and read the
//     tile bytes from L2 after the first.
//   * A 4-stage cp.async.cg ring in shared memory holds, per 64-byte column
//     chunk of the tile rows (64 int8 or 32 bf16 columns), the tile chunk,
//     the matching x rows and, for K4, d of those columns: 16-byte copies in
//     flight while the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate) run the chunk before. Each copy asks L2 for the 256 bytes
//     around it, so a tile row leaves memory in 256-byte runs.
//   * A fragments come straight from the staged tile bytes, converted in
//     registers, no second shared-memory pass: an int8 byte k → bf16 as
//     (128 + k) − 128 in bf16x2 (K3), or → f32 2^23 + k by a byte permute and
//     fma((2^23 + k)·d_c − 2^23·d_c) = k·d_c rounded once, × d_r, → bf16
//     (K4); a pack with negative bytes takes the general signed sequence.
//     Inside a k16 step the k order is permuted (fragment k 2q+j ↔ column
//     4q+j, k 8+2q+j ↔ column 4q+2+j) so a thread reads its 4 columns of a
//     row as one word; B fragments come from ldmatrix.trans with the same
//     permutation. Both shared layouts are XOR-swizzled by row, so neither
//     read has bank conflicts.
//   * The instruction is mma.sync: at F ≤ 64 the kernel is bound by the
//     tile stream and the conversion, not the tensor cores. Wide F takes the
//     wide body below.
// K4 at wide F (int8 pattern tiles with d, F >= ops/cuda_bcsr.SPMM_WIDE_F:
// SAGE's and GIN's 600 and 602 columns and their seed lanes'):
// spmm_pipe_kernel_wgmma.
//   * What bounds it: at 64 features a CTA the pipe body reads the 1.36 GB
//     pack through L2 and converts every byte once a feature block, 10
//     times at F=600, and runs mma.sync far below the tensor cores' rate.
//     The products are 1.7e12 FLOP at 608 columns (1.7 ms at the bf16
//     peak); the pack, x and out once are 0.66 ms of memory.
//   * A CTA covers 128 rows of a tile and 208 features (three feature blocks
//     at F=600): two consumer warpgroups of 64 rows, each issuing
//     wgmma.m64n208k16 with A from registers (the pipe body's a_frag
//     conversion, rounding k·d_c once, × d_r, → bf16) and B, the staged x
//     chunk, read by the tensor cores from shared memory (MN-major, 128-byte
//     swizzle). Each tile byte is read and converted 3 times a call at 600
//     columns, not 10. A fragment takes the wgmma's natural k order: a thread
//     reads its columns 2q, 2q+1 and 8+2q, 9+2q of a row as two byte pairs.
//   * A producer warp fills a 5-stage ring by TMA: per 64-column chunk, x's
//     64 rows at the CTA's features (boxes of 64 features), the CTA's 128
//     tile rows (64-byte swizzle) and d of the chunk's columns, each stage
//     completing on an mbarrier. The CTAs of two row blocks of a tile form a
//     cluster and share x: each loads half of the boxes and multicasts them
//     (66 clusters fill the 132 SMs; clusters of 4, which halve x's reads
//     again, fit on 120). The consumers convert chunk c + 1 while chunk c's
//     products run (one commit group a chunk) and hand a stage back to the
//     cluster's producers once its products are done.
//   * x is read in place where its rows are whole 16-byte pieces (600
//     columns); TMA reads the features past F as zeros. 602 takes the
//     wrapper's padded copy. Sums per column in (segment, tile, chunk, k16
//     step) order, as the pipe body: the two bodies give the same bits, and
//     a column's sum depends neither on F nor on its place among the columns.
// Compute dtype f32, int8 pattern tiles or f32 value tiles of a graph's
// pack (the set-up pre-aggregation Â·X at 602 columns, every aggregation of
// an f32 hybrid run at 41, products' Â·X at 100, the mesh's set-up K3):
// spmm_walk_kernel, over the pack's live entries only.
//   * What bounds it: on synth-reddit's pack 0.86% of the tile entries are
//     live (11.7M of 1.36e9). Multiplying every entry on CUDA cores, as the
//     first f32 kernel did, costs 1.64e12 FLOP at F=602: >= 24.5 ms at the
//     FP32 peak. The live entries' products are 14.1 GFLOP (0.21 ms), so the
//     bound is the bytes: the index, x and out, each once (0.4 ms at 602).
//   * The index (ops/cuda_bcsr.spmm_index, built once a pack on its device):
//     the live entries in (tile, 128-column chunk, row, column) order as
//     {value, row << 16 | column in the chunk}, the value already scaled,
//     fl(fl(k·d_c)·d_r), the Pallas kernel's rounding; an offset per (tile,
//     chunk, row), the rows in an order that deals rows 16 apart to a warp
//     (a block of dense rows would otherwise hold one warp, and the chunk's
//     barrier, to its entries). A warp owns 16 or 32 row positions, so its
//     entries of a chunk are one contiguous run.
//   * A lane holds 2 or 4 features of every row of its warp (the rows an
//     unrolled loop, the accumulators in registers). The warp reads its run
//     from a window of 128 entries in shared memory, filled by cp.async
//     during the chunk before (a longer run loads its later windows itself):
//     an entry is one broadcast load, one vector load of x's row and 2 or 4
//     FMAs, and a row's entries are a short loop, so the unrolled rows keep
//     the code small. Each row is summed in (tile, column) order, the same
//     every run: no atomics, bit-identical runs.
//   * x is served from shared memory: a 3-stage cp.async ring holds, per
//     chunk, its 128 x rows at the CTA's 64 or 128 features (16-byte copies;
//     the wrapper pads x's rows to a multiple of 4 floats), copied under the
//     walk of the chunk before; each staged row serves the entries of its
//     column in the CTA's rows (synth-reddit's pack: 4.4 a column), where
//     gathering every entry's row would move 28 GB at F=602.
//   * Two shapes (ops/cuda_bcsr.SPMM_WALK_WIDE): 16 warps × 32 rows × 64
//     features (a 512-row tile staged once a feature block), or 16 warps ×
//     16 rows × 128 features (half the instructions an entry), chosen by F.
// Dense f32 value tiles (K8's backward on its cotangent tiles):
// spmm_fma_kernel, 64×32 chunks and 4×4 FMA register blocks per thread.
//
// What bounds the pipe body on an H100, per synth-reddit epoch: 3 passes
// (forward, backward, eval) over 2,596 int8 tiles of 512×1024 (1.36 GB each
// pass, ~0.4 ms at 3.35 TB/s; the ring alone, without compute, streams it
// in ~0.64 ms); the int8 → bf16 conversion (~0.15 ms of K4) and the
// products on top. Variants in kernel_variants.py, numbers in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // output rows per CTA (f32 path)
constexpr int kFeat = 64;  // output features per CTA (f32 path)

// Where a CTA of segment `seg` writes its row block starting at row r0 of
// the tile-row: out itself, or its workspace slot.
__device__ __forceinline__ float* segment_dst(float* out, float* ws,
                                              const int* seg_row,
                                              const int* seg_slot, int seg,
                                              int tile_r, int r0, int n_feat) {
  const int slot = seg_slot[seg];
  if (slot < 0) return out + ((size_t)seg_row[seg] * tile_r + r0) * n_feat;
  return ws + ((size_t)slot * tile_r + r0) * n_feat;
}

// ---------------------------------------------------------------------------
// Dense f32 value tiles with f32 x (K8's backward on its cotangent tiles):
// CUDA-core FMAs over every tile entry.
constexpr int kFmaChunk = 32;
constexpr int kFmaThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kFmaThreads)
spmm_fma_kernel(const float* __restrict__ tiles, const int* __restrict__ seg_tile_ptr,
                const int* __restrict__ seg_row, const int* __restrict__ seg_slot,
                const int* __restrict__ tile_cols, const float* __restrict__ x,
                float* __restrict__ out, float* __restrict__ ws, int tile_r, int tile_c,
                int n_feat) {
  __shared__ float a_s[kRows][kFmaChunk + 1];
  __shared__ float x_s[kFmaChunk][kFeat];

  const int subs = tile_r / kRows;
  const int seg = blockIdx.x / subs;
  const int r0 = (blockIdx.x % subs) * kRows;
  const int f0 = blockIdx.y * kFeat;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int t_end = seg_tile_ptr[seg + 1];
  for (int t = seg_tile_ptr[seg]; t < t_end; ++t) {
    const float* tile = tiles + (size_t)t * tile_r * tile_c + (size_t)r0 * tile_c;
    const int col_base = tile_cols[t] * tile_c;
    for (int k0 = 0; k0 < tile_c; k0 += kFmaChunk) {
      for (int e = tid; e < kRows * kFmaChunk; e += kFmaThreads) {
        const int r = e / kFmaChunk;
        const int k = e % kFmaChunk;
        a_s[r][k] = tile[(size_t)r * tile_c + k0 + k];
      }
      for (int e = tid; e < kFmaChunk * kFeat; e += kFmaThreads) {
        const int k = e / kFeat;
        const int f = e % kFeat;
        x_s[k][f] = f0 + f < n_feat ? x[(size_t)(col_base + k0 + k) * n_feat + f0 + f] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kFmaChunk; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[ty * 4 + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = x_s[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* dst = segment_dst(out, ws, seg_row, seg_slot, seg, tile_r, r0, n_feat);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)(ty * 4 + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < n_feat) dst[row * n_feat + f] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 compute: a cp.async ring under mma.sync.m16n8k16 (bf16 x bf16 -> f32).
constexpr int kStages = 4;       // ring depth
constexpr int kChunkBytes = 64;  // bytes of each tile row per chunk

// Chunk geometry by tile dtype: columns per 64-byte chunk row, and the row
// swizzle of the 16-byte pieces of a staged tile row that keeps the
// fragment reads conflict-free (int8: a word per lane, bf16: 8 bytes).
template <typename TT> struct Chunk;
template <> struct Chunk<int8_t> {
  static constexpr int kCols = 64;
  __device__ static int swz(int r) { return (r >> 1) & 3; }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int kCols = 32;
  __device__ static int swz(int r) { return ((r >> 1) & 1) << 1; }
};

// The CTA shape: m16 tiles per warp, features per CTA (a feature block),
// warps per CTA (at most) and CTAs per SM (the register budget: 64K /
// (32·warps·CTAs)). Measured on the H100 (PERF.md): warps of 2 m16
// tiles (32 rows), 8 warps, 256 rows and 64 features a CTA, two CTAs per
// SM, for every F (wide F takes one feature block after another).
template <int kMT, int kFB, int kW, int kPerSM> struct Shape {
  static constexpr int kMTiles = kMT;
  static constexpr int kFeatBlock = kFB;
  static constexpr int kWarpRows = 16 * kMT;
  static constexpr int kWarps = kW;
  static constexpr int kCtasPerSM = kPerSM;
};
using CtaShape = Shape<2, 64, 8, 2>;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes global → shared, around them 256 bytes fetched into L2: the
// next chunks of a tile row (64 bytes a chunk) then come from L2, and the
// tile stream reaches the memory as 256-byte runs.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Signed byte b of w as f32, exactly: u = w ^ 0x80808080 holds b + 128 as an
// unsigned byte; placed in the mantissa of 2^23 it reads 2^23 + b + 128.
__device__ __forceinline__ float byte_to_float(uint32_t u, int b) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.0f;
}

// The staged x row k holds its 16-byte feature pieces p at p ^ x_swz(k): the
// 8 k rows that one ldmatrix reads under the step's k permutation then sit
// in 8 distinct bank groups.
__device__ __forceinline__ int x_swz(int k) { return (((k >> 2) & 3) << 1) | (k & 1); }

// The raw fragment bytes of one row for k16 step s of a staged chunk row
// (see the k permutation in the header): columns 4q..4q+3 of the step's 16,
// one word of int8 or two words of bf16.
template <typename TT> struct Raw;
template <> struct Raw<int8_t> {
  uint32_t w;
  __device__ void load(const uint8_t* row, int swz, int s, int q) {
    w = *reinterpret_cast<const uint32_t*>(row + ((s ^ swz) << 4) + 4 * q);
  }
};
template <> struct Raw<__nv_bfloat16> {
  uint2 w;
  __device__ void load(const uint8_t* row, int swz, int s, int q) {
    w = *reinterpret_cast<const uint2*>(row + (((2 * s + (q >> 1)) ^ swz) << 4) + 8 * (q & 1));
  }
};

__device__ __forceinline__ uint32_t bf16x2_minus_128(uint32_t v) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&v);
  x = __hsub2(x, __floats2bfloat162_rn(128.0f, 128.0f));
  return *reinterpret_cast<uint32_t*>(&x);
}

// Fragment registers {lo | hi} = {a0 | a2} (row g) or {a1 | a3} (row g + 8)
// from a row's raw bytes: lo holds columns 4q, 4q+1 and hi 4q+2, 4q+3;
// dc: d of the 4 columns, ndc = -2^23·dc (exact), dr: d of the row.
// kNonneg: every byte is in 0..127 (a multiplicity pattern), which allows
// shorter exact sequences than a signed byte needs.
template <bool kScaled, bool kNonneg>
__device__ __forceinline__ void a_frag(const Raw<int8_t>& raw, const float4& dc,
                                       const float4& ndc, float dr, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t w = raw.w;
  if constexpr (kNonneg && !kScaled) {
    // bf16 128 + k (exponent byte 0x43, k in the mantissa) minus 128
    lo = bf16x2_minus_128(__byte_perm(w, 0x43434343u, 0x4140));
    hi = bf16x2_minus_128(__byte_perm(w, 0x43434343u, 0x4342));
  } else if constexpr (kNonneg) {
    // f32 2^23 + k; fma((2^23 + k)·dc − 2^23·dc) rounds k·dc once, as k·dc
    const float v0 = fmaf(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7540)), dc.x, ndc.x);
    const float v1 = fmaf(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7541)), dc.y, ndc.y);
    const float v2 = fmaf(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7542)), dc.z, ndc.z);
    const float v3 = fmaf(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7543)), dc.w, ndc.w);
    lo = pack_bf16(v0 * dr, v1 * dr);
    hi = pack_bf16(v2 * dr, v3 * dr);
  } else {
    const uint32_t u = w ^ 0x80808080u;
    float v0 = byte_to_float(u, 0), v1 = byte_to_float(u, 1);
    float v2 = byte_to_float(u, 2), v3 = byte_to_float(u, 3);
    if constexpr (kScaled) {
      v0 = v0 * dc.x * dr;
      v1 = v1 * dc.y * dr;
      v2 = v2 * dc.z * dr;
      v3 = v3 * dc.w * dr;
    }
    lo = pack_bf16(v0, v1);
    hi = pack_bf16(v2, v3);
  }
}

template <bool kScaled, bool kNonneg>
__device__ __forceinline__ void a_frag(const Raw<__nv_bfloat16>& raw, const float4&,
                                       const float4&, float, uint32_t& lo, uint32_t& hi) {
  lo = raw.w.x;
  hi = raw.w.y;
}

template <typename TT, bool kScaled, bool kNonneg, typename S>
__global__ void __launch_bounds__(S::kWarps * 32, S::kCtasPerSM)
spmm_pipe_kernel(const TT* __restrict__ tiles, const int* __restrict__ seg_tile_ptr,
                 const int* __restrict__ seg_row, const int* __restrict__ seg_slot,
                 const int* __restrict__ tile_cols, const float* __restrict__ d,
                 const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ ws, int tile_r, int tile_c, int n_feat,
                 int f_pad, int n_fb) {
  constexpr int kCols = Chunk<TT>::kCols;
  constexpr int kSteps = kCols / 16;  // k16 steps per chunk
  constexpr int kMT = S::kMTiles;
  constexpr int kFB = S::kFeatBlock;
  constexpr int kNT = kFB / 8;
  extern __shared__ __align__(128) uint8_t smem[];

  const int n_threads = blockDim.x;
  const int rows_cta = (n_threads / 32) * S::kWarpRows;
  const int tile_bytes = rows_cta * kChunkBytes;
  const int x_bytes = kCols * kFB * 2;
  const int stage_bytes = tile_bytes + x_bytes + (kScaled ? kCols * 4 : 0);

  const int fb = blockIdx.x % n_fb;
  const int unit = blockIdx.x / n_fb;
  const int blocks = tile_r / rows_cta;
  const int seg = unit / blocks;
  const int r0 = (unit % blocks) * rows_cta;
  const int f0 = fb * kFB;
  const int fbw = min(kFB, f_pad - f0);  // a multiple of 16
  const int pieces = fbw / 8;            // 16-byte x pieces per row
  const int n_pairs = fbw / 16;          // warp-uniform

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int row_base = seg_row[seg] * tile_r + r0;
  const int t0 = seg_tile_ptr[seg];
  const int cpt = tile_c / kCols;  // chunks per tile
  const int n_chunks = (seg_tile_ptr[seg + 1] - t0) * cpt;
  const size_t tile_row_bytes = (size_t)tile_c * sizeof(TT);

  auto issue = [&](int c) {
    if (c < n_chunks) {
      uint8_t* st = smem + (c % kStages) * stage_bytes;
      const int t = t0 + c / cpt;
      const int kc = c % cpt;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(tiles) +
                           ((size_t)t * tile_r + r0) * tile_row_bytes + kc * kChunkBytes;
      for (int e = tid; e < rows_cta * 4; e += n_threads) {
        const int r = e >> 2;
        const int p = e & 3;
        cp_async16(st + r * kChunkBytes + ((p ^ Chunk<TT>::swz(r)) << 4),
                   src + r * tile_row_bytes + p * 16);
      }
      const int node0 = tile_cols[t] * tile_c + kc * kCols;
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + tile_bytes);
      for (int e = tid; e < kCols * pieces; e += n_threads) {
        const int k = e / pieces;
        const int p = e % pieces;
        cp_async16(xs + k * kFB + ((p ^ x_swz(k)) << 3),
                   x + (size_t)(node0 + k) * f_pad + f0 + p * 8);
      }
      if constexpr (kScaled) {
        float* ds = reinterpret_cast<float*>(st + tile_bytes + x_bytes);
        for (int e = tid; e < kCols / 4; e += n_threads) cp_async16(ds + 4 * e, d + node0 + 4 * e);
      }
    }
    cp_async_commit();
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;

  // this thread's fragment rows (lo: g, hi: g + 8 of each m16 tile) and d_r
  float dr[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int r = warp * S::kWarpRows + m * 16 + g;
    dr[m][0] = kScaled ? d[row_base + r] : 1.0f;
    dr[m][1] = kScaled ? d[row_base + r + 8] : 1.0f;
  }

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(c + kStages - 1);
    const uint8_t* st = smem + (c % kStages) * stage_bytes;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + tile_bytes);
    const float* ds = reinterpret_cast<const float*>(st + tile_bytes + x_bytes);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      float4 dc = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      if constexpr (kScaled) dc = *reinterpret_cast<const float4*>(ds + 16 * s + 4 * q);
      const float4 ndc = make_float4(-8388608.0f * dc.x, -8388608.0f * dc.y,
                                     -8388608.0f * dc.z, -8388608.0f * dc.w);
      uint32_t a[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int r = warp * S::kWarpRows + m * 16 + g;
        Raw<TT> rlo, rhi;
        rlo.load(st + r * kChunkBytes, Chunk<TT>::swz(r), s, q);
        rhi.load(st + (r + 8) * kChunkBytes, Chunk<TT>::swz(r + 8), s, q);
        a_frag<kScaled, kNonneg>(rlo, dc, ndc, dr[m][0], a[m][0], a[m][2]);
        a_frag<kScaled, kNonneg>(rhi, dc, ndc, dr[m][1], a[m][1], a[m][3]);
      }
      // ldmatrix rows: lanes 8j..8j+7 address matrix j (j&1: the step's
      // second k half, j>>1: the pair's second n tile)
      const int mj = lane >> 3;
      const int mr = lane & 7;
      const int k = 16 * s + 4 * (mr >> 1) + (mr & 1) + ((mj & 1) << 1);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        if (p < n_pairs) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, xs + k * kFB + (((2 * p + (mj >> 1)) ^ x_swz(k)) << 3));
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            mma_bf16(acc[m][2 * p], a[m][0], a[m][1], a[m][2], a[m][3], b[0], b[1]);
            mma_bf16(acc[m][2 * p + 1], a[m][0], a[m][1], a[m][2], a[m][3], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dst = segment_dst(out, ws, seg_row, seg_slot, seg, tile_r, r0, n_feat);
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const size_t ra = (size_t)(warp * S::kWarpRows + m * 16 + g);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = f0 + n * 8 + q * 2 + j;
        if (f < n_feat) {
          dst[ra * n_feat + f] = acc[m][n][j];
          dst[(ra + 8) * n_feat + f] = acc[m][n][2 + j];
        }
      }
    }
  }
}

// Sum the workspace slots of each split tile-row, in segment order.
__global__ void reduce_segments_kernel(const float* __restrict__ ws,
                                       const int* __restrict__ multi_row,
                                       const int* __restrict__ multi_slot_ptr,
                                       float* __restrict__ out, int tile_r,
                                       int n_feat) {
  const int m = blockIdx.y;
  const size_t n = (size_t)tile_r * n_feat;
  const int s0 = multi_slot_ptr[m];
  const int s1 = multi_slot_ptr[m + 1];
  float* dst = out + (size_t)multi_row[m] * n;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int s = s0; s < s1; ++s) acc += ws[(size_t)s * n + e];
    dst[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// The wide bf16 body (K4 at wide F, spmm_pipe_kernel_wgmma; see the header):
// a producer warp fills a ring of stages by TMA, two consumer warpgroups
// convert the tile bytes to A fragments and run wgmma on them.
constexpr int kWideN = 208;        // features a CTA (a feature block): the wgmma's N
constexpr int kWideStages = 5;     // ring depth
constexpr int kWideCluster = 2;    // CTAs of one tile's row blocks that share x, at most
constexpr int kWideRows = 128;     // rows a CTA: two consumer warpgroups of 64
constexpr int kWideThreads = 288;  // 8 consumer warps, then the producer warp
constexpr int kXBox = 64;          // features of a TMA box of x: one 128-byte row
constexpr int kXBoxes = (kWideN + kXBox - 1) / kXBox;
constexpr int kXBoxBytes = 64 * kXBox * 2;  // the chunk's 64 k rows of a box
constexpr int kWideTileBytes = kWideRows * kChunkBytes;
constexpr int kWideStageTx = kXBoxes * kXBoxBytes + kWideTileBytes + 64 * 4;
constexpr int kWideStageBytes = (kWideStageTx + 1023) / 1024 * 1024;
constexpr int kWideSmem = kWideStages * kWideStageBytes + 2 * kWideStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A wait of
// more than 2^34 cycles (about 10 s) traps: a fault in the barriers' protocol
// ends the kernel with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 r;\nmapa.shared::cluster.u32 r, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [r];\n}\n" ::"r"(bar), "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (a CTA barrier for a cluster of one).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// TMA: box (c0, c1) of the tensor map into shared memory at dst, completing
// on the barrier bar (of every CTA in mask, at the same offsets, when
// multicast).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// bytes (a multiple of 16, 16-byte aligned) global → shared, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator across a wgmma.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// The wgmma descriptor of a staged x chunk's k rows from `addr` on: B is
// MN-major (features contiguous) in 128-byte swizzled rows, 64 features a
// box; the leading offset steps from one box to the next, the stride offset
// from 8 k rows to the next.
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kXBoxBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t lds_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// acc += A · B over one k16 step, m64nNk16: A (bf16, each warp's 16 rows in
// the mma.sync A fragment's layout) from registers, B (bf16, MN-major,
// 128-byte swizzle) from shared memory by its descriptor, f32 accumulators.
template <int N> struct Wgmma;
template <> struct Wgmma<208> {
  __device__ __forceinline__ static void mma(float (&d)[104], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
        "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103"
        "}, {%104, %105, %106, %107}, %108, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// A thread's accumulators of a wgmma's N columns (the m64nN layout) into
// rows da (row g) and db (row g + 8), its first column f.
template <int N, int M>
__device__ __forceinline__ void store_rows(const float (&acc)[M], float* da, float* db, int f,
                                           int n_feat) {
  const bool pairs = (n_feat & 1) == 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j, f += 8) {
    if (pairs && f + 1 < n_feat) {
      *reinterpret_cast<float2*>(da + f) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(db + f) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      if (f < n_feat) da[f] = acc[4 * j], db[f] = acc[4 * j + 2];
      if (f + 1 < n_feat) da[f + 1] = acc[4 * j + 1], db[f + 1] = acc[4 * j + 3];
    }
  }
}

// One chunk of a consumer warpgroup: its rows' A fragments for the chunk's 4
// k16 steps from the staged tile bytes and d (a thread's rows ra, ra + 8),
// then the 4 products on the staged x, committed as one group.
template <bool kNonneg>
__device__ __forceinline__ void wide_chunk(float (&acc)[kWideN / 2], uint32_t (&af)[4][4],
                                           const uint8_t* stage, uint32_t stage_addr, int ra,
                                           int q, int swz, float dra, float drb) {
  const uint8_t* tb = stage + kXBoxes * kXBoxBytes + ra * kChunkBytes + 2 * q;
  const float* ds = reinterpret_cast<const float*>(stage + kXBoxes * kXBoxBytes + kWideTileBytes);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // the wgmma's natural k order: fragment k 2q, 2q+1 (lo) and 8+2q, 9+2q
    // (hi) are the step's columns of the same numbers, a byte pair each
    const uint8_t* p = tb + ((s ^ swz) << 4);
    Raw<int8_t> rlo, rhi;
    rlo.w = __byte_perm(lds_u16(p), lds_u16(p + 8), 0x5410);
    rhi.w = __byte_perm(lds_u16(p + 8 * kChunkBytes), lds_u16(p + 8 * kChunkBytes + 8), 0x5410);
    const float2 d0 = *reinterpret_cast<const float2*>(ds + 16 * s + 2 * q);
    const float2 d1 = *reinterpret_cast<const float2*>(ds + 16 * s + 8 + 2 * q);
    const float4 dc = make_float4(d0.x, d0.y, d1.x, d1.y);
    const float4 ndc = make_float4(-8388608.0f * dc.x, -8388608.0f * dc.y, -8388608.0f * dc.z,
                                   -8388608.0f * dc.w);
    a_frag<true, kNonneg>(rlo, dc, ndc, dra, af[s][0], af[s][2]);
    a_frag<true, kNonneg>(rhi, dc, ndc, drb, af[s][1], af[s][3]);
  }
  wgmma_fence();
  const uint64_t desc = x_desc(stage_addr);
#pragma unroll
  for (int s = 0; s < 4; ++s) Wgmma<kWideN>::mma(acc, af[s], desc + ((16 * s * 128) >> 4));
  wgmma_commit();
}

// The CTA's work: blockIdx.x = (seg · n_fb + fb) · n_rb + rb, the row blocks
// of one (segment, feature block) side by side, a cluster of them sharing
// each x chunk. Warps 0-7 (two warpgroups of 64 rows) consume, warp 8's lane
// 0 produces. A stage holds, for one
// 64-column chunk of the segment's tiles: x's 64 rows at the CTA's features
// (kXBoxes boxes of 64 features, 128-byte swizzle, the boxes dealt out to
// the CTAs of the cluster, each multicast to all), the CTA's 128 tile rows
// (64 bytes each, 64-byte swizzle) and d of the chunk's columns. full[s]
// completes when a stage's bytes have landed; empty[s] when the consumer
// warps of every CTA of the cluster are done with it.
template <bool kNonneg>
__global__ void __launch_bounds__(kWideThreads, 1)
spmm_pipe_kernel_wgmma(const __grid_constant__ CUtensorMap tmap_x,
                       const __grid_constant__ CUtensorMap tmap_t,
                       const int* __restrict__ seg_tile_ptr, const int* __restrict__ seg_row,
                       const int* __restrict__ seg_slot, const int* __restrict__ tile_cols,
                       const float* __restrict__ d, float* __restrict__ out,
                       float* __restrict__ ws, int tile_r, int tile_c, int n_feat, int n_fb) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms: 1024-byte aligned
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kWideStages * kWideStageBytes;
  const uint32_t empty0 = full0 + kWideStages * 8;

  const int n_rb = tile_r / kWideRows;
  const int rb = blockIdx.x % n_rb;
  const int fb = (blockIdx.x / n_rb) % n_fb;
  const int seg = blockIdx.x / (n_rb * n_fb);
  const int r0 = rb * kWideRows;
  const int f0 = fb * kWideN;
  const uint32_t csize = cluster_size();
  const int t0 = seg_tile_ptr[seg];
  const int cpt = tile_c / 64;  // chunks per tile
  const int n_chunks = (seg_tile_ptr[seg + 1] - t0) * cpt;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8 * csize);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (warp == 8) {
    if (lane == 0) {
      const uint32_t crank = cluster_rank();
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      for (int c = 0; c < n_chunks; ++c) {
        const int st = c % kWideStages;
        if (c >= kWideStages) mbar_wait(empty0 + 8 * st, ((c / kWideStages) + 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t stage = base + st * kWideStageBytes;
        mbar_expect_tx(full, kWideStageTx);
        const int t = t0 + c / cpt;
        const int kc = c % cpt;
        const int node0 = tile_cols[t] * tile_c + kc * 64;
        for (int b = crank; b < kXBoxes; b += csize) {
          if (csize > 1)
            tma_load_multicast(stage + b * kXBoxBytes, &tmap_x, full, f0 + b * kXBox, node0, mask);
          else
            tma_load(stage + b * kXBoxBytes, &tmap_x, full, f0 + b * kXBox, node0);
        }
        tma_load(stage + kXBoxes * kXBoxBytes, &tmap_t, full, kc * 64, t * tile_r + r0);
        bulk_load(stage + kXBoxes * kXBoxBytes + kWideTileBytes, d + node0, 64 * 4, full);
      }
    }
    __syncwarp();
    cluster_sync();  // no CTA leaves while a peer may still arrive on its barriers
  } else {
    // this thread's fragment rows: ra (a0, a2) and ra + 8 (a1, a3)
    const int g = lane >> 2;
    const int q = lane & 3;
    const int ra = (warp / 4) * 64 + (warp % 4) * 16 + g;
    const int row_base = seg_row[seg] * tile_r + r0;
    const float dra = d[row_base + ra];
    const float drb = d[row_base + ra + 8];
    const int swz = Chunk<int8_t>::swz(ra);  // the same for ra + 8

    float acc[kWideN / 2];
#pragma unroll
    for (int j = 0; j < kWideN / 2; ++j) acc[j] = 0.0f;
    // the A fragments of a chunk's 4 k16 steps, two chunks' worth: one
    // chunk's products read theirs while the next chunk's are converted
    uint32_t a0[4][4], a1[4][4];

    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % kWideStages;
      mbar_wait(full0 + 8 * st, (c / kWideStages) & 1);
      const uint8_t* stage = smem + st * kWideStageBytes;
      const uint32_t stage_addr = base + st * kWideStageBytes;
      if (c & 1)
        wide_chunk<kNonneg>(acc, a1, stage, stage_addr, ra, q, swz, dra, drb);
      else
        wide_chunk<kNonneg>(acc, a0, stage, stage_addr, ra, q, swz, dra, drb);
      // chunk c's products may run on; chunk c - 1's are done, so its
      // fragments are free and its stage goes back to the cluster's producers
      wgmma_wait<1>();
      if (c > 0) {
        __syncwarp();
        const uint32_t empty = empty0 + 8 * ((c - 1) % kWideStages);
        if (csize == 1) {
          if (lane == 0) mbar_arrive(empty);
        } else if (lane < csize) {
          mbar_arrive_cluster(empty, lane);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kWideN / 2; ++j) fence_operand(acc[j]);

    float* dst = segment_dst(out, ws, seg_row, seg_slot, seg, tile_r, r0, n_feat);
    float* da = dst + (size_t)ra * n_feat;
    store_rows<kWideN>(acc, da, da + (size_t)8 * n_feat, f0 + 2 * q, n_feat);
    cluster_sync();
  }
}

// ---------------------------------------------------------------------------
// f32 compute over the live-entry index (see the header).
constexpr int kWalkChunk = 128;  // tile columns a staged chunk (cuda_bcsr.SPMM_CHUNK)
constexpr int kWalkGroup = 16;   // a warp holds 16·GPW rows (GPW 1 or 2)
constexpr int kWalkWarps = 16;
constexpr int kWalkStages = 3;
constexpr int kWalkWin = 128;  // entries of a warp's window on its run of a chunk

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async16_x(float* dst, const float* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}

// Stage x rows node0.. node0 + 127, features f0.. f0 + fw (4 floats a copy;
// 4 divides ldx and f0, x 16-byte aligned) as st[k][f], kFB floats a row.
// Features past fw rounded up to 4 are not written: only lanes whose outputs
// are dropped read them.
template <int kFB>
__device__ __forceinline__ void stage_x(float* st, const float* __restrict__ x, size_t node0,
                                        int f0, int fw, int ldx, int tid, int n_threads) {
  constexpr int P = kFB / 4;  // copies a row
  const float* src = x + node0 * ldx + f0;
  for (int e = tid; e < kWalkChunk * P; e += n_threads) {
    const int k = e / P;
    const int f = (e % P) * 4;
    if (f < fw) cp_async16_x(st + k * kFB + f, src + (size_t)k * ldx + f);
  }
}

template <int VEC> struct FVec;
template <> struct FVec<2> {
  using T = float2;
  __device__ __forceinline__ static void fma(float* acc, float v, T x) {
    acc[0] = fmaf(v, x.x, acc[0]);
    acc[1] = fmaf(v, x.y, acc[1]);
  }
};
template <> struct FVec<4> {
  using T = float4;
  __device__ __forceinline__ static void fma(float* acc, float v, T x) {
    acc[0] = fmaf(v, x.x, acc[0]);
    acc[1] = fmaf(v, x.y, acc[1]);
    acc[2] = fmaf(v, x.z, acc[2]);
    acc[3] = fmaf(v, x.w, acc[3]);
  }
};

// A CTA owns (segment, feature block of 32·VEC, block of warps·16·GPW row
// positions); blockIdx.x = (seg · n_fb + fb) · n_rb + rb, so the row blocks
// of one feature block, which stage the same x, run side by side. ent[e] =
// {value bits, row << 16 | column in the chunk}; rptr[(t · nch + chunk) ·
// tile_r + q] is the first entry of position q in a tile's chunk. Position
// q is tile row (q % G)·16 + q / G (G = tile_r / 16), so a warp's rows lie
// 16 apart and a block of dense rows spreads over the warps. A warp holds its rows'
// offsets one a lane and reads its run of entries from a window in shared
// memory, the first kWalkWin entries of the next chunk's run copied there
// (cp.async) during this chunk's walk; an entry is one broadcast load, one
// load of x's row and VEC FMAs, and the row loop's body is a short loop, so
// the unrolled rows keep the code small.
template <int VEC, int GPW>
__global__ void __launch_bounds__(kWalkWarps * 32, 1)
spmm_walk_kernel(const int2* __restrict__ ent, const int* __restrict__ rptr,
                 const int* __restrict__ seg_tile_ptr, const int* __restrict__ seg_row,
                 const int* __restrict__ seg_slot, const int* __restrict__ tile_cols,
                 const float* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ ws, int tile_r, int tile_c, int n_feat, int ldx,
                 int n_fb, int n_rb) {
  constexpr int kFB = 32 * VEC;
  constexpr int kRW = kWalkGroup * GPW;  // rows a warp (at most 32)
  constexpr int kChunkFloats = kWalkChunk * kFB;
  extern __shared__ __align__(16) float xs[];
  // the warp's two windows of its runs' entries (this chunk's, the next's),
  // after the staged chunks
  int2* wins = reinterpret_cast<int2*>(xs + kWalkStages * kChunkFloats) +
               (threadIdx.x / 32) * 2 * kWalkWin;

  const int n_threads = blockDim.x;
  const int rows_cta = (n_threads / 32) * kRW;
  const int rb = blockIdx.x % n_rb;
  const int fb = (blockIdx.x / n_rb) % n_fb;
  const int seg = blockIdx.x / (n_rb * n_fb);
  const int r0 = rb * rows_cta;
  const int f0 = fb * kFB;
  const int fw = min(kFB, n_feat - f0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wrow0 = r0 + warp * kRW;  // the warp's first row position in the tile
  const int nch = tile_c / kWalkChunk;
  const int t0 = seg_tile_ptr[seg];
  const int n_steps = (seg_tile_ptr[seg + 1] - t0) * nch;
  // step s = the chunk s % nch of tile t0 + s / nch; its rows' offsets
  const int* rp = rptr + (size_t)t0 * nch * tile_r + wrow0;

  auto node0 = [&](int s) {
    return (size_t)tile_cols[t0 + s / nch] * tile_c + (size_t)(s % nch) * kWalkChunk;
  };
  // the x chunk of step s into its ring stage
  auto issue = [&](int s) {
    if (s < n_steps)
      stage_x<kFB>(xs + (s % kWalkStages) * kChunkFloats, x, node0(s), f0, fw, ldx, tid,
                   n_threads);
    cp_async_commit();
  };
  // lane l < kRW: the start of row l; `end`: the end of the warp's run
  auto rows = [&](int s, int& p, int& end) {
    p = end = 0;
    if (s < n_steps) {
      const int* q = rp + (size_t)s * tile_r;
      p = lane < kRW ? __ldg(q + lane) : 0;
      end = __ldg(q + kRW);
    }
  };
  // the first window of step s's run, entries lo.., into its window
  auto fetch = [&](int s, int lo, int end) {
    if (s < n_steps) {
      int2* d = wins + (s & 1) * kWalkWin;
      const int n = min(kWalkWin, end - lo);
      for (int j = lane; j < n; j += 32) cp_async8(d + j, ent + lo + j);
    }
    cp_async_commit();
  };

  float acc[kRW][VEC];
#pragma unroll
  for (int i = 0; i < kRW; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.0f;

  // commit groups in order: the entries of step 0, x of steps 0 and 1, then
  // each step s the entries of s + 1 and x of s + 2; waiting for all but the
  // newest group at step s leaves both of its own complete
  int p, end, p_n, end_n;
  rows(0, p, end);
  rows(1, p_n, end_n);
  fetch(0, __shfl_sync(0xffffffffu, p, 0), end);
#pragma unroll
  for (int s = 0; s < kWalkStages - 1; ++s) issue(s);

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    int p_nn, end_nn;
    rows(s + 2, p_nn, end_nn);
    fetch(s + 1, __shfl_sync(0xffffffffu, p_n, 0), end_n);
    issue(s + kWalkStages - 1);
    const float* st = xs + (s % kWalkStages) * kChunkFloats;
    int2* wv = wins + (s & 1) * kWalkWin;
    const int lo = __shfl_sync(0xffffffffu, p, 0);  // the run: entries lo..end
    // the run in windows of kWalkWin entries (a later one loaded here); each
    // row takes the entries of its range that lie in the window
    for (int wb = lo; wb < end; wb += kWalkWin) {
      if (wb != lo) {
        __syncwarp();
        for (int j = lane; j < min(kWalkWin, end - wb); j += 32) wv[j] = __ldg(ent + wb + j);
        __syncwarp();
      }
      // lane i < kRW: row i's entries in the window, [a, b) as a << 16 | b;
      // the rows with any, one bit each (most rows of a chunk have none)
      const int nx = __shfl_down_sync(0xffffffffu, p, 1);
      const int ra = min(max(p - wb, 0), kWalkWin);
      const int rb_ = min(max((lane == kRW - 1 ? end : nx) - wb, 0), kWalkWin);
      const unsigned live = __ballot_sync(0xffffffffu, lane < kRW && rb_ > ra);
      const int ab = ra << 16 | rb_;
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        if (!(live >> i & 1u)) continue;
        const int d = __shfl_sync(0xffffffffu, ab, i);
        const int b = d & 0xffff;
#pragma unroll 4
        for (int j = d >> 16; j < b; ++j) {
          const int2 en = wv[j];
          const auto xv = *reinterpret_cast<const typename FVec<VEC>::T*>(
              st + (en.y & (kWalkChunk - 1)) * kFB + lane * VEC);
          FVec<VEC>::fma(acc[i], __int_as_float(en.x), xv);
        }
      }
    }
    __syncwarp();  // this window is refilled two steps on
    p = p_n;
    end = end_n;
    p_n = p_nn;
    end_n = end_nn;
  }
  cp_async_wait<0>();

  // position q holds tile row (q % G)·16 + q / G (ops/cuda_bcsr.spmm_row)
  float* dst = segment_dst(out, ws, seg_row, seg_slot, seg, tile_r, 0, n_feat) + f0;
  const int G = tile_r / 16;
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int q = wrow0 + i;
    float* row = dst + (size_t)((q % G) * 16 + q / G) * n_feat;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (lane * VEC + j < fw) row[lane * VEC + j] = acc[i][j];
  }
}

struct WalkArgs {
  const int2* ent;
  const int* rptr;
  const int* seg_tile_ptr;
  const int* seg_row;
  const int* seg_slot;
  int n_seg;
  const int* tile_cols;
  const float* x;
  float* out;
  float* ws;
  int tile_r, tile_c, n_feat, ldx;
  cudaStream_t stream;
};

template <int VEC, int GPW>
int launch_walk(const WalkArgs& a) {
  int warps = kWalkWarps;
  while (warps > 1 && a.tile_r % (warps * kWalkGroup * GPW)) warps /= 2;
  const int rows_cta = warps * kWalkGroup * GPW;
  if (a.tile_r % rows_cta || a.tile_c % kWalkChunk) return (int)cudaErrorInvalidValue;
  const int smem = kWalkStages * kWalkChunk * 32 * VEC * (int)sizeof(float) +
                   warps * 2 * kWalkWin * (int)sizeof(int2);
  auto kernel = spmm_walk_kernel<VEC, GPW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_fb = (a.n_feat + 32 * VEC - 1) / (32 * VEC);
  const int n_rb = a.tile_r / rows_cta;
  const size_t blocks = (size_t)a.n_seg * n_fb * n_rb;
  kernel<<<(unsigned)blocks, warps * 32, smem, a.stream>>>(
      a.ent, a.rptr, a.seg_tile_ptr, a.seg_row, a.seg_slot, a.tile_cols, a.x, a.out, a.ws,
      a.tile_r, a.tile_c, a.n_feat, a.ldx, n_fb, n_rb);
  return 0;
}

struct Args {
  const void* tiles;
  const int* seg_tile_ptr;
  const int* seg_row;
  const int* seg_slot;
  int n_seg;
  const int* tile_cols;
  const float* d;
  const void* x;
  float* out;
  float* ws;
  int tile_r, tile_c, n_feat, f_pad;
  bool nonneg;  // int8 tiles known to hold only 0..127
  cudaStream_t stream;
};

int launch_fma(const Args& a) {
  const dim3 grid((unsigned)(a.n_seg * (a.tile_r / kRows)),
                  (unsigned)((a.n_feat + kFeat - 1) / kFeat));
  spmm_fma_kernel<<<grid, kFmaThreads, 0, a.stream>>>(
      static_cast<const float*>(a.tiles), a.seg_tile_ptr, a.seg_row, a.seg_slot,
      a.tile_cols, static_cast<const float*>(a.x), a.out, a.ws, a.tile_r, a.tile_c,
      a.n_feat);
  return 0;
}

template <typename TT, bool kScaled, bool kNonneg>
int launch_pipe(const Args& a) {
  using S = CtaShape;
  // warps: as many of the shape's as fit the tile rows
  int warps = S::kWarps;
  while (warps > 1 && a.tile_r % (warps * S::kWarpRows)) warps /= 2;
  const int rows_cta = warps * S::kWarpRows;
  if (a.tile_r % rows_cta) return (int)cudaErrorInvalidValue;
  constexpr int kCols = Chunk<TT>::kCols;
  const int stage = rows_cta * kChunkBytes + kCols * S::kFeatBlock * 2 + (kScaled ? kCols * 4 : 0);
  const int smem = kStages * stage;
  auto kernel = spmm_pipe_kernel<TT, kScaled, kNonneg, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_fb = (a.f_pad + S::kFeatBlock - 1) / S::kFeatBlock;
  const size_t blocks = (size_t)a.n_seg * (a.tile_r / rows_cta) * n_fb;
  kernel<<<(unsigned)blocks, warps * 32, smem, a.stream>>>(
      static_cast<const TT*>(a.tiles), a.seg_tile_ptr, a.seg_row, a.seg_slot, a.tile_cols,
      a.d, static_cast<const __nv_bfloat16*>(a.x), a.out, a.ws, a.tile_r, a.tile_c,
      a.n_feat, a.f_pad, n_fb);
  return 0;
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 2-D tensor map: rows of `cols` elements `ld` apart, boxes of
// box_c × box_r; columns past `cols` read as zeros.
bool tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                   uint64_t cols, uint64_t rows, uint64_t ld, uint32_t box_c, uint32_t box_r,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * elem_bytes};
  const cuuint32_t box[2] = {box_c, box_r};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wide body: x bf16 [n_nodes, ldx] (ldx a multiple of 8, 16-byte
// aligned; columns n_feat.. read but dropped).
int launch_wide(const Args& a, int n_tiles, int n_nodes) {
  CUtensorMap tmap_x, tmap_t;
  if (!tensor_map_2d(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.f_pad, n_nodes, a.f_pad,
                     kXBox, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&tmap_t, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.tiles, a.tile_c,
                     (uint64_t)n_tiles * a.tile_r, a.tile_c, kChunkBytes, kWideRows,
                     CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const int n_rb = a.tile_r / kWideRows;
  int cluster = kWideCluster;
  while (n_rb % cluster) cluster /= 2;
  const int n_fb = (a.n_feat + kWideN - 1) / kWideN;
  auto kernel = a.nonneg ? spmm_pipe_kernel_wgmma<true> : spmm_pipe_kernel_wgmma<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((size_t)a.n_seg * n_fb * n_rb));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = kWideSmem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, tmap_x, tmap_t, a.seg_tile_ptr, a.seg_row,
                                 a.seg_slot, a.tile_cols, a.d, a.out, a.ws, a.tile_r, a.tile_c,
                                 a.n_feat, n_fb);
}

template <bool kScaled>
int launch_pipe_int8(const Args& a) {
  if (a.nonneg) return launch_pipe<int8_t, kScaled, true>(a);
  return launch_pipe<int8_t, kScaled, false>(a);
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8. The compute dtype is
// x's for int8 tiles and the tile's otherwise; a bf16 compute dtype takes
// the pipelined tensor-core kernel, whose x is bf16 with padded rows. At
// f32 this entry takes only dense f32 value tiles with f32 x (the FMA
// kernel); a pack's live entries go through pgcn_bcsr_spmm_walk.
int dispatch(const Args& a, int tile_dtype, int x_dtype, bool scaled) {
  if (scaled) {
    if (tile_dtype != 2 || x_dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_pipe_int8<true>(a);
  }
  if (tile_dtype == 0 && x_dtype == 0) return launch_fma(a);
  if (tile_dtype == 1 && x_dtype == 1) return launch_pipe<__nv_bfloat16, false, false>(a);
  if (tile_dtype == 2 && x_dtype == 1) return launch_pipe_int8<false>(a);
  return (int)cudaErrorInvalidValue;
}

// Sum the split tile-rows' workspace slots into out (after a body's launch).
void reduce_segments(const float* ws, const int* multi_row, const int* multi_slot_ptr,
                     int n_multi, float* out, int tile_r, int n_feat, cudaStream_t stream) {
  if (n_multi <= 0) return;
  const size_t n = (size_t)tile_r * n_feat;
  const unsigned bx = (unsigned)((n + 255) / 256 < 64 ? (n + 255) / 256 : 64);
  reduce_segments_kernel<<<dim3(bx, (unsigned)n_multi), 256, 0, stream>>>(
      ws, multi_row, multi_slot_ptr, out, tile_r, n_feat);
}

}  // namespace

// Segment schedule (see ops/cuda_bcsr.tile_schedule): segment s covers
// tiles seg_tile_ptr[s]..seg_tile_ptr[s+1] of tile-row seg_row[s] and writes
// workspace slot seg_slot[s] (-1: straight into out). Split tile-rows
// multi_row[m] sum slots multi_slot_ptr[m]..multi_slot_ptr[m+1]. ws holds
// [n_slots, tile_r, F] floats. d != nullptr selects the scaled form (int8
// tiles only). x is [n, f_pad]: for a bf16 compute dtype bf16 with f_pad a
// multiple of 16 and 16-byte aligned rows (columns F.. zero), else x's own
// dtype with f_pad = F. nonneg != 0 promises int8 tiles in 0..127 (shorter
// exact conversions). tile_r
// must be a multiple of 64 and tile_c of 64. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int pgcn_bcsr_spmm(const void* tiles, int tile_dtype,
                              const int* seg_tile_ptr, const int* seg_row,
                              const int* seg_slot, int n_seg,
                              const int* multi_row, const int* multi_slot_ptr,
                              int n_multi, const int* tile_cols, const float* d,
                              const void* x, int x_dtype, float* out, float* ws,
                              int tile_r, int tile_c, int n_feat, int f_pad,
                              int nonneg, void* stream) {
  if (n_seg <= 0 || n_feat <= 0 || tile_r % kRows || tile_c % 64 || f_pad < n_feat)
    return (int)cudaErrorInvalidValue;
  Args a{tiles, seg_tile_ptr, seg_row, seg_slot, n_seg, tile_cols, d, x, out, ws,
         tile_r, tile_c, n_feat, f_pad, nonneg != 0,
         static_cast<cudaStream_t>(stream)};
  const int rc = dispatch(a, tile_dtype, x_dtype, d != nullptr);
  if (rc) return rc;
  reduce_segments(ws, multi_row, multi_slot_ptr, n_multi, out, tile_r, n_feat, a.stream);
  return (int)cudaGetLastError();
}

// The wide bf16 body of K4 (spmm_pipe_kernel_wgmma): int8 pattern tiles
// [n_tiles, tile_r, tile_c] with d, x bf16 [n_nodes, ldx] (ldx >= n_feat a
// multiple of 8, x 16-byte aligned, columns n_feat.. read and dropped); the
// schedule, workspace and out as for pgcn_bcsr_spmm. tile_r must be a
// multiple of 128 and tile_c of 64. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int pgcn_bcsr_spmm_wide(const void* tiles, int n_tiles, const int* seg_tile_ptr,
                                   const int* seg_row, const int* seg_slot, int n_seg,
                                   const int* multi_row, const int* multi_slot_ptr,
                                   int n_multi, const int* tile_cols, const float* d,
                                   const void* x, int n_nodes, int ldx, float* out, float* ws,
                                   int tile_r, int tile_c, int n_feat, int nonneg,
                                   void* stream) {
  if (n_seg <= 0 || n_feat <= 0 || d == nullptr || tile_r % kWideRows || tile_c % 64 ||
      ldx < n_feat || ldx % 8 || (uintptr_t)x % 16 || (uintptr_t)tiles % 16 ||
      (uintptr_t)d % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{tiles, seg_tile_ptr, seg_row, seg_slot, n_seg, tile_cols, d, x, out, ws,
               tile_r, tile_c, n_feat, ldx, nonneg != 0, static_cast<cudaStream_t>(stream)};
  const int rc = launch_wide(a, n_tiles, n_nodes);
  if (rc) return rc;
  reduce_segments(ws, multi_row, multi_slot_ptr, n_multi, out, tile_r, n_feat, a.stream);
  return (int)cudaGetLastError();
}

// The f32 body over a pack's live-entry index (ops/cuda_bcsr.spmm_index):
// ent int32 [E, 2], rptr int32 [T · tile_c/128 · tile_r + 1]; the segment
// schedule, workspace and out as for pgcn_bcsr_spmm; x f32 [n, ldx] (its
// first F columns read; ldx a multiple of 4 and x 16-byte aligned). wide != 0
// takes 16 rows × 128 features a warp, else 32 rows × 64 features. tile_r
// must be a multiple of 32 (16 for wide), tile_c of 128. Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int pgcn_bcsr_spmm_walk(const void* ent, const int* rptr, const int* seg_tile_ptr,
                                   const int* seg_row, const int* seg_slot, int n_seg,
                                   const int* multi_row, const int* multi_slot_ptr,
                                   int n_multi, const int* tile_cols, const float* x,
                                   float* out, float* ws, int tile_r, int tile_c, int n_feat,
                                   int ldx, int wide, void* stream) {
  if (n_seg <= 0 || n_feat <= 0 || ldx < n_feat || ldx % 4 || (uintptr_t)x % 16 ||
      tile_r % kWalkGroup || tile_c % kWalkChunk)
    return (int)cudaErrorInvalidValue;
  const WalkArgs a{static_cast<const int2*>(ent), rptr, seg_tile_ptr, seg_row, seg_slot,
                   n_seg, tile_cols, x, out, ws, tile_r, tile_c, n_feat, ldx,
                   static_cast<cudaStream_t>(stream)};
  const int rc = wide ? launch_walk<4, 1>(a) : launch_walk<2, 2>(a);
  if (rc) return rc;
  reduce_segments(ws, multi_row, multi_slot_ptr, n_multi, out, tile_r, n_feat, a.stream);
  return (int)cudaGetLastError();
}
