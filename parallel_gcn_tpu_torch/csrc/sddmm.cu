// Sampled dense-dense product on a BCSR tile pack (SDDMM), for sm_90a:
// out[t] = a[rows_t·R : (rows_t+1)·R] · b[cols_t·C : (cols_t+1)·C]ᵀ for every
// tile position t of the pack, as f32 [T, R, C] in pack order; a, b are
// [n, K] f32 or bf16, accumulated in f32.
//
// Replaces the Pallas kernel _sddmm_kernel of
// parallel_gcn_tpu/ops/pallas_sddmm.py (one grid step per tile, one MXU dot
// of the row block with the column block).
//
// Hopper design: one CTA per (tile, 64-row block). It stages its 64 rows of
// a in shared memory once (K ≤ 64; wider K restages a per 64-wide K chunk)
// and walks the tile's 64-column blocks, staging 64 rows of b each, K
// zero-padded, and multiplying:
//   * bf16: 4 warps of mma.sync m16n8k16 (bf16 in, f32 accumulate), the
//     products exact in f32;
//   * f32: 4×4 register blocks of f32 FMAs per thread, exact f32 products
//     (no TF32), as the JAX op at matmul precision "highest".
// Each block is written with coalesced 16-byte streaming stores (the bf16
// path through a shared-memory staging block).
//
// What bounds it on an H100: at synth-reddit's square 512×512 pack with
// K = 41 the inputs are ~40 MB and the output T·R·C·4 bytes (4.2 GB, 1.26
// ms at 3.35 TB/s); in f32 the FMAs (2·T·R·C·K FLOP) take as long at the
// CUDA-core peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 64;  // output block edge
constexpr int kKc = 64;   // K chunk staged at a time

// The CTA's tile and 64-row block, from the grid's flat index.
struct BlockPos {
  int t, r0;
  size_t a_row, b_row0;  // first row of a, and of b for column block 0
};

__device__ __forceinline__ BlockPos block_pos(const int* tile_rows, const int* tile_cols,
                                              int tile_r, int tile_c) {
  const int nbi = tile_r / kBlk;
  BlockPos p;
  p.t = blockIdx.x / nbi;
  p.r0 = (blockIdx.x % nbi) * kBlk;
  p.a_row = (size_t)tile_rows[p.t] * tile_r + p.r0;
  p.b_row0 = (size_t)tile_cols[p.t] * tile_c;
  return p;
}

// Stage rows [row, row + 64) × columns [k0, k0 + 64) of src ([n, k_dim]) as
// dst[k][r] (kT) or dst[r][k], zero past k_dim; reads go along the rows.
template <bool kT, typename T, int kStride>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, size_t row, int k0,
                                      int k_dim, int tid, int n_threads) {
  const int kn = min(kKc, k_dim - k0);
  for (int e = tid; e < kBlk * kKc; e += n_threads) {
    const int r = e / kKc;
    const int k = e % kKc;
    const T v = k < kn ? src[(row + r) * k_dim + k0 + k] : T(0.0f);
    if (kT) dst[k * kStride + r] = v;
    else dst[r * kStride + k] = v;
  }
}

// ---------------------------------------------------------------------------
// f32: 256 threads, 4×4 outputs each; a and b staged transposed ([k][row]).
constexpr int kFmaThreads = 256;

__global__ void __launch_bounds__(kFmaThreads)
sddmm_fma_kernel(const int* __restrict__ tile_rows, const int* __restrict__ tile_cols,
                 const float* __restrict__ a, const float* __restrict__ b, int k_dim,
                 float* __restrict__ out, int tile_r, int tile_c) {
  constexpr int kS = kBlk + 4;
  __shared__ __align__(16) float a_s[kKc * kS];  // [k][row]
  __shared__ __align__(16) float b_s[kKc * kS];  // [k][col]
  const BlockPos p = block_pos(tile_rows, tile_cols, tile_r, tile_c);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const bool a_resident = k_dim <= kKc;
  if (a_resident) stage<true, float, kS>(a_s, a, p.a_row, 0, k_dim, tid, kFmaThreads);

  for (int c0 = 0; c0 < tile_c; c0 += kBlk) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < k_dim; k0 += kKc) {
      __syncthreads();  // the previous block's reads of b_s (and a_s) are done
      if (!a_resident) stage<true, float, kS>(a_s, a, p.a_row, k0, k_dim, tid, kFmaThreads);
      stage<true, float, kS>(b_s, b, p.b_row0 + c0, k0, k_dim, tid, kFmaThreads);
      __syncthreads();
      const int kn = min(kKc, k_dim - k0);
      for (int k = 0; k < kn; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[k * kS + ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&b_s[k * kS + tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    float* dst = out + ((size_t)p.t * tile_r + p.r0) * tile_c + c0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      __stcs(reinterpret_cast<float4*>(dst + (size_t)(ty * 4 + i) * tile_c + tx * 4),
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// ---------------------------------------------------------------------------
// bf16: 4 warps × 16 rows × 64 columns of mma.sync m16n8k16.
constexpr int kMmaThreads = 128;
constexpr int kPad = kKc + 8;  // 144-byte rows: conflict-free fragment reads

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kMmaThreads)
sddmm_mma_kernel(const int* __restrict__ tile_rows, const int* __restrict__ tile_cols,
                 const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                 int k_dim, float* __restrict__ out, int tile_r, int tile_c) {
  __shared__ __align__(16) __nv_bfloat16 a_s[kBlk * kPad];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 b_s[kBlk * kPad];  // [col][k]
  __shared__ __align__(16) float o_s[kBlk][kBlk + 4];
  const BlockPos p = block_pos(tile_rows, tile_cols, tile_r, tile_c);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int ar = warp * 16 + g;
  const bool a_resident = k_dim <= kKc;
  if (a_resident) stage<false, __nv_bfloat16, kPad>(a_s, a, p.a_row, 0, k_dim, tid, kMmaThreads);

  for (int c0 = 0; c0 < tile_c; c0 += kBlk) {
    float acc[kBlk / 8][4];
#pragma unroll
    for (int n = 0; n < kBlk / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;
    for (int k0 = 0; k0 < k_dim; k0 += kKc) {
      __syncthreads();  // the previous block's reads of b_s, o_s (and a_s) are done
      if (!a_resident)
        stage<false, __nv_bfloat16, kPad>(a_s, a, p.a_row, k0, k_dim, tid, kMmaThreads);
      stage<false, __nv_bfloat16, kPad>(b_s, b, p.b_row0 + c0, k0, k_dim, tid, kMmaThreads);
      __syncthreads();
      const int steps = (min(kKc, k_dim - k0) + 15) / 16;
      for (int s = 0; s < steps; ++s) {
        const int kk = 16 * s;
        const uint32_t a0 = lds32(&a_s[ar * kPad + kk + q * 2]);
        const uint32_t a1 = lds32(&a_s[(ar + 8) * kPad + kk + q * 2]);
        const uint32_t a2 = lds32(&a_s[ar * kPad + kk + 8 + q * 2]);
        const uint32_t a3 = lds32(&a_s[(ar + 8) * kPad + kk + 8 + q * 2]);
#pragma unroll
        for (int n = 0; n < kBlk / 8; ++n) {
          const uint32_t b0 = lds32(&b_s[(n * 8 + g) * kPad + kk + q * 2]);
          const uint32_t b1 = lds32(&b_s[(n * 8 + g) * kPad + kk + 8 + q * 2]);
          mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kBlk / 8; ++n) {
      o_s[ar][n * 8 + q * 2] = acc[n][0];
      o_s[ar][n * 8 + q * 2 + 1] = acc[n][1];
      o_s[ar + 8][n * 8 + q * 2] = acc[n][2];
      o_s[ar + 8][n * 8 + q * 2 + 1] = acc[n][3];
    }
    __syncthreads();
    float* dst = out + ((size_t)p.t * tile_r + p.r0) * tile_c + c0;
    for (int e = tid; e < kBlk * kBlk / 4; e += kMmaThreads) {
      const int r = e / (kBlk / 4);
      const int c = (e % (kBlk / 4)) * 4;
      __stcs(reinterpret_cast<float4*>(dst + (size_t)r * tile_c + c),
             *reinterpret_cast<const float4*>(&o_s[r][c]));
    }
  }
}

}  // namespace

// tile_rows/tile_cols: int32 [n_tiles]; a, b: [n, k_dim] row-major, dtype 0 =
// float32, 1 = bfloat16; out: f32 [n_tiles, tile_r, tile_c], 16-byte aligned.
// tile_r and tile_c must be multiples of 64. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int pgcn_sddmm(const int* tile_rows, const int* tile_cols, int n_tiles,
                          const void* a, const void* b, int dtype, int k_dim, float* out,
                          int tile_r, int tile_c, void* stream) {
  if (n_tiles <= 0 || k_dim <= 0 || tile_r % kBlk || tile_c % kBlk)
    return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)n_tiles * (tile_r / kBlk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sddmm_fma_kernel<<<(unsigned)blocks, kFmaThreads, 0, s>>>(
        tile_rows, tile_cols, static_cast<const float*>(a), static_cast<const float*>(b),
        k_dim, out, tile_r, tile_c);
  else if (dtype == 1)
    sddmm_mma_kernel<<<(unsigned)blocks, kMmaThreads, 0, s>>>(
        tile_rows, tile_cols, static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), k_dim, out, tile_r, tile_c);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
