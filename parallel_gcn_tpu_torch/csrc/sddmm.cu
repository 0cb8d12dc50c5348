// Sampled dense-dense product on a BCSR tile pack (SDDMM), for sm_90a:
// out[t] = a[rows_t·R : (rows_t+1)·R] · b[cols_t·C : (cols_t+1)·C]ᵀ for every
// tile position t of the pack, as f32 [T, R, C] in pack order; a, b are
// [n, K] f32 or bf16, accumulated in f32.
//
// Replaces the Pallas kernel _sddmm_kernel of
// parallel_gcn_tpu/ops/pallas_sddmm.py (one grid step per tile, one MXU dot
// of the row block with the column block).
//
// What bounds it on an H100: at synth-reddit's square 512×512 pack with
// K = 41 the inputs are ~40 MB and the output T·R·C·4 bytes (4.2 GB, 1.26
// ms at 3.35 TB/s). In f32 the FMAs (2·T·R·C·K = 86 GFLOP) take 1.29 ms at
// the CUDA-core peak, so both the FP32 pipe and the store stream must run
// near their rates at once; in bf16 the tensor cores' work is ~0.09 ms and
// the kernel is a 4.2 GB write stream.
//
// Hopper design. A unit of work is (tile, 128-row block); a persistent grid
// of two 256-thread CTAs an SM walks units blockIdx.x, + gridDim.x, ... For
// each unit a CTA walks the tile's 128-column blocks (and K in chunks): a
// step stages the column block of b (and, at a unit's first step, its rows
// of a) with cp.async into the other half of a double buffer while the
// current step computes, so the copies, the products and the stores of
// consecutive steps and units overlap. No CTA barrier stands between a
// block's products and its streaming stores:
//   * f32: 16 × 16 threads, an 8 × 8 output block each (rows ty·4 + i and
//     64 + ty·4 + i, columns likewise), stored from registers as float4.
//     a and b are staged transposed ([k][row]) by 4-byte copies (a row of
//     K = 41 floats is not 16-byte aligned) that walk each block k fastest,
//     so a warp reads consecutive words, into rows 132 floats apart (writes
//     at most 4 ways conflicting). A k step is 4 float4 shared loads for 64
//     FMAs. Exact f32 FMAs in k order from 0, as the plain version's cuBLAS
//     product at this shape: the outputs are bit-equal.
//   * bf16: a and b padded by the wrapper to a multiple of 16 columns
//     (zeros), staged as [row][k] with 16-byte copies, rows 144 bytes apart
//     (conflict-free fragment reads); 8 warps of 16 rows × 128 columns of
//     mma.sync m16n8k16 (bf16 in, f32 accumulate). Each warp passes its
//     outputs through its own shared-memory block (a warp barrier only), so
//     each store instruction writes two whole 256-byte rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 128;  // rows of a unit, columns of a step
constexpr int kThreads = 256;
constexpr int kKcF = 48;   // K chunk, f32
constexpr int kSF = kBlk + 4;  // f32 staged row pitch ([k][row]): writes 4-way conflicting
// f32: columns a step; 128 gives a thread 8 × 8 outputs and two CTAs an SM,
// 64 gives it 8 × 4 and three
constexpr int kNCF = 128;
constexpr int kSFB = kNCF + 4;
constexpr int kFmaCtas = kNCF == 128 ? 2 : 3;
constexpr int kKcB = 64;   // K chunk, bf16 (K padded to 16)
constexpr int kPadB = kKcB + 8;
constexpr int kOutP = 64 + 4;  // bf16 epilogue: a warp's 16 × 64 staged outputs, row pitch
// bf16: stage each warp's outputs in shared memory and store whole rows (512
// bytes an instruction); false stores the mma fragments straight (8 bytes)
constexpr bool kStoreViaSmem = true;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The CTA's steps: units blockIdx.x, + gridDim.x, ..., each ncb column
// blocks × nkc K chunks, walked in that order by a cursor (a division a
// unit, none a step).
struct Step {
  int i, u, t, rb, cb, kc;  // the unit's ordinal, the unit, its tile and row block
};
struct Steps {
  int ncb, nkc, nrb, n_steps;
  __device__ Steps(int n_tiles, int tile_r, int tile_c, int nkc_, int cols = kBlk)
      : nkc(nkc_) {
    ncb = tile_c / cols;
    nrb = tile_r / kBlk;
    const int n_units = n_tiles * nrb;
    const int mine = n_units > (int)blockIdx.x
                         ? (n_units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
                         : 0;
    n_steps = mine * ncb * nkc;
  }
  __device__ Step first() const {
    const int u = blockIdx.x;
    return Step{0, u, u / nrb, u % nrb, 0, 0};
  }
  __device__ void next(Step& p) const {
    if (++p.kc < nkc) return;
    p.kc = 0;
    if (++p.cb < ncb) return;
    p.cb = 0;
    ++p.i;
    p.u += gridDim.x;
    p.t = p.u / nrb;
    p.rb = p.u % nrb;
  }
};

// The f32 staging's walk of a 128 × kn block, k fastest: thread tid starts
// at (r, k) = divmod(tid, kn) and steps kThreads elements, (q, rem) a step.
struct BlockWalk {
  int kn, q, rem, r, k;
  __device__ BlockWalk(int kn_, int tid)
      : kn(kn_), q(kThreads / kn_), rem(kThreads % kn_), r(tid / kn_), k(tid % kn_) {}
};

// ---------------------------------------------------------------------------
// f32
__global__ void __launch_bounds__(kThreads, kFmaCtas)
sddmm_fma_kernel(const int* __restrict__ tile_rows, const int* __restrict__ tile_cols,
                 int n_tiles, const float* __restrict__ a, const float* __restrict__ b,
                 int k_dim, float* __restrict__ out, int tile_r, int tile_c) {
  extern __shared__ __align__(16) float smf[];
  const int kc = min(k_dim, kKcF);   // staged k rows a buffer
  float* a_s = smf;                  // [2][kc][kSF]
  float* b_s = smf + 2 * kc * kSF;   // [2][kc][kSFB]
  const int nkc = (k_dim + kKcF - 1) / kKcF;
  const bool a_res = nkc == 1;  // a stays staged over the unit's column blocks
  const Steps steps(n_tiles, tile_r, tile_c, nkc, kNCF);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  // 128 rows × kn columns of src (rows k_dim apart) into dst[k][row]: the
  // threads walk the block k fastest, so a warp reads consecutive words of
  // a row (one or two 128-byte lines) and writes them 4 ways conflicting
  const BlockWalk w_full(min(kKcF, k_dim), tid);
  const BlockWalk w_last(k_dim - (nkc - 1) * kKcF, tid);
  auto copy_block = [&](float* dst, const float* src, const BlockWalk& w, int rows,
                        int pitch) {
    int r = w.r, k = w.k;
    for (; r < rows; r += w.q, k += w.rem) {
      if (k >= w.kn) k -= w.kn, ++r;
      if (r < rows) cp_async4(dst + k * pitch + r, src + (size_t)r * k_dim + k);
    }
  };
  auto stage = [&](const Step& p, int s) {
    if (s < steps.n_steps) {
      const int k0 = p.kc * kKcF;
      const BlockWalk& w = p.kc == nkc - 1 ? w_last : w_full;
      if (!a_res || p.cb == 0)
        copy_block(a_s + (a_res ? (p.i & 1) : (s & 1)) * (kc * kSF),
                   a + ((size_t)tile_rows[p.t] * tile_r + p.rb * kBlk) * k_dim + k0, w, kBlk,
                   kSF);
      copy_block(b_s + (s & 1) * (kc * kSFB),
                 b + ((size_t)tile_cols[p.t] * tile_c + p.cb * kNCF) * k_dim + k0, w, kNCF,
                 kSFB);
    }
    cp_async_commit();
  };

  constexpr int kCJ = kNCF / 16;  // a thread's columns
  float acc[8][kCJ];
  Step p = steps.first(), nx = p;
  steps.next(nx);
  stage(p, 0);
  for (int s = 0; s < steps.n_steps; ++s, p = nx, steps.next(nx)) {
    __syncthreads();  // every thread is done with step s - 1's buffers
    stage(nx, s + 1);
    cp_async_wait1();
    __syncthreads();  // step s's copies are visible
    const float* as = a_s + (a_res ? (p.i & 1) : (s & 1)) * (kc * kSF);
    const float* bs = b_s + (s & 1) * (kc * kSFB);
    if (p.kc == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) acc[i][j] = 0.0f;
    }
    const int kn = p.kc == nkc - 1 ? w_last.kn : w_full.kn;
#pragma unroll 2
    for (int k = 0; k < kn; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kSF + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kSF + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kSFB + tx * 4);
      const float4 b1 =
          kCJ == 8 ? *reinterpret_cast<const float4*>(bs + k * kSFB + 64 + tx * 4) : b0;
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (p.kc == nkc - 1) {
      float* dst = out + ((size_t)p.t * tile_r + p.rb * kBlk) * tile_c + p.cb * kNCF;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* row = dst + (size_t)((i < 4 ? 0 : 64) + ty * 4 + (i & 3)) * tile_c;
        __stcs(reinterpret_cast<float4*>(row + tx * 4),
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        if constexpr (kCJ == 8)
          __stcs(reinterpret_cast<float4*>(row + 64 + tx * 4),
                 make_float4(acc[i][kCJ - 4], acc[i][kCJ - 3], acc[i][kCJ - 2],
                             acc[i][kCJ - 1]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16
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

// k_dim: the padded K (a multiple of 16), the rows' length in a and b.
__global__ void __launch_bounds__(kThreads, 2)
sddmm_mma_kernel(const int* __restrict__ tile_rows, const int* __restrict__ tile_cols,
                 int n_tiles, const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, int k_dim, float* __restrict__ out,
                 int tile_r, int tile_c) {
  extern __shared__ __align__(16) __nv_bfloat16 smb[];
  __nv_bfloat16* a_s = smb;                     // [2][kBlk][kPadB]
  __nv_bfloat16* b_s = smb + 2 * kBlk * kPadB;  // [2][kBlk][kPadB]
  // each warp's [16][kOutP] outputs, for its whole-row stores
  float* o_w =
      reinterpret_cast<float*>(smb + 4 * kBlk * kPadB) + (threadIdx.x / 32) * 16 * kOutP;
  const int nkc = (k_dim + kKcB - 1) / kKcB;
  const bool a_res = nkc == 1;
  const Steps steps(n_tiles, tile_r, tile_c, nkc);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int ar = warp * 16 + g;

  auto stage = [&](const Step& p, int s) {
    if (s < steps.n_steps) {
      const int k0 = p.kc * kKcB;
      const int pieces = min(kKcB, k_dim - k0) / 8;  // 16-byte pieces a row
      if (!a_res || p.cb == 0) {
        __nv_bfloat16* as = a_s + (a_res ? (p.i & 1) : (s & 1)) * (kBlk * kPadB);
        const __nv_bfloat16* src =
            a + ((size_t)tile_rows[p.t] * tile_r + p.rb * kBlk) * k_dim + k0;
        for (int e = tid; e < kBlk * 8; e += kThreads)
          if (e % 8 < pieces)
            cp_async16(as + (e / 8) * kPadB + (e % 8) * 8,
                       src + (size_t)(e / 8) * k_dim + (e % 8) * 8);
      }
      __nv_bfloat16* bs = b_s + (s & 1) * (kBlk * kPadB);
      const __nv_bfloat16* src =
          b + ((size_t)tile_cols[p.t] * tile_c + p.cb * kBlk) * k_dim + k0;
      for (int e = tid; e < kBlk * 8; e += kThreads)
        if (e % 8 < pieces)
          cp_async16(bs + (e / 8) * kPadB + (e % 8) * 8,
                     src + (size_t)(e / 8) * k_dim + (e % 8) * 8);
    }
    cp_async_commit();
  };

  float acc[kBlk / 8][4];
  Step p = steps.first(), nx = p;
  steps.next(nx);
  stage(p, 0);
  for (int s = 0; s < steps.n_steps; ++s, p = nx, steps.next(nx)) {
    __syncthreads();
    stage(nx, s + 1);
    cp_async_wait1();
    __syncthreads();
    const __nv_bfloat16* as = a_s + (a_res ? (p.i & 1) : (s & 1)) * (kBlk * kPadB);
    const __nv_bfloat16* bs = b_s + (s & 1) * (kBlk * kPadB);
    if (p.kc == 0) {
#pragma unroll
      for (int n = 0; n < kBlk / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;
    }
    const int ksteps = min(kKcB, k_dim - p.kc * kKcB) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int kk = 16 * ks + q * 2;
      const uint32_t a0 = lds32(as + ar * kPadB + kk);
      const uint32_t a1 = lds32(as + (ar + 8) * kPadB + kk);
      const uint32_t a2 = lds32(as + ar * kPadB + kk + 8);
      const uint32_t a3 = lds32(as + (ar + 8) * kPadB + kk + 8);
#pragma unroll
      for (int n = 0; n < kBlk / 8; ++n) {
        const __nv_bfloat16* br = bs + (n * 8 + g) * kPadB + kk;
        mma_bf16(acc[n], a0, a1, a2, a3, lds32(br), lds32(br + 8));
      }
    }
    if (p.kc == nkc - 1) {
      if constexpr (kStoreViaSmem) {
        // two halves of 64 columns: fragments → o_w, then each instruction
        // stores two whole 256-byte row halves
        float* dst = out + ((size_t)p.t * tile_r + p.rb * kBlk + warp * 16) * tile_c +
                     p.cb * kBlk;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            *reinterpret_cast<float2*>(o_w + g * kOutP + n * 8 + q * 2) =
                make_float2(acc[8 * h + n][0], acc[8 * h + n][1]);
            *reinterpret_cast<float2*>(o_w + (g + 8) * kOutP + n * 8 + q * 2) =
                make_float2(acc[8 * h + n][2], acc[8 * h + n][3]);
          }
          __syncwarp();
#pragma unroll
          for (int r2 = 0; r2 < 16; r2 += 2) {
            const int r = r2 + lane / 16;
            const int c = (lane % 16) * 4;
            __stcs(reinterpret_cast<float4*>(dst + (size_t)r * tile_c + 64 * h + c),
                   *reinterpret_cast<const float4*>(o_w + r * kOutP + c));
          }
          __syncwarp();
        }
      } else {
        float* dst = out + ((size_t)p.t * tile_r + p.rb * kBlk + ar) * tile_c + p.cb * kBlk;
#pragma unroll
        for (int n = 0; n < kBlk / 8; ++n) {
          __stcs(reinterpret_cast<float2*>(dst + n * 8 + q * 2),
                 make_float2(acc[n][0], acc[n][1]));
          __stcs(reinterpret_cast<float2*>(dst + (size_t)8 * tile_c + n * 8 + q * 2),
                 make_float2(acc[n][2], acc[n][3]));
        }
      }
    }
  }
}

template <typename T>
int launch(void (*kernel)(const int*, const int*, int, const T*, const T*, int, float*, int,
                          int),
           int smem, int n_units, cudaStream_t s, const int* tile_rows, const int* tile_cols,
           int n_tiles, const void* a, const void* b, int k_dim, float* out, int tile_r,
           int tile_c) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  const int blocks = min(n_units, sms * (per_sm > 0 ? per_sm : 1));
  kernel<<<blocks, kThreads, smem, s>>>(tile_rows, tile_cols, n_tiles,
                                        static_cast<const T*>(a), static_cast<const T*>(b),
                                        k_dim, out, tile_r, tile_c);
  return 0;
}

}  // namespace

// tile_rows/tile_cols: int32 [n_tiles]; a, b: [n, k_dim] row-major, dtype 0 =
// float32 (any k_dim), 1 = bfloat16 (k_dim a multiple of 16, rows 16-byte
// aligned: the wrapper pads); out: f32 [n_tiles, tile_r, tile_c], 16-byte
// aligned. tile_r and tile_c must be multiples of 128. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pgcn_sddmm(const int* tile_rows, const int* tile_cols, int n_tiles,
                          const void* a, const void* b, int dtype, int k_dim, float* out,
                          int tile_r, int tile_c, void* stream) {
  if (n_tiles <= 0 || k_dim <= 0 || tile_r % kBlk || tile_c % kBlk ||
      (dtype == 1 && k_dim % 16))
    return (int)cudaErrorInvalidValue;
  const int n_units = n_tiles * (tile_r / kBlk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int smem = 2 * min(k_dim, kKcF) * (kSF + kSFB) * (int)sizeof(float);
    const int rc = launch<float>(sddmm_fma_kernel, smem, n_units, s, tile_rows, tile_cols,
                                 n_tiles, a, b, k_dim, out, tile_r, tile_c);
    if (rc) return rc;
  } else if (dtype == 1) {
    const int smem = 4 * kBlk * kPadB * (int)sizeof(__nv_bfloat16) +
                     (kThreads / 32) * 16 * kOutP * (int)sizeof(float);
    const int rc = launch<__nv_bfloat16>(sddmm_mma_kernel, smem, n_units, s, tile_rows,
                                         tile_cols, n_tiles, a, b, k_dim, out, tile_r, tile_c);
    if (rc) return rc;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
