// Fused inverted dropout and matmul, Y = (mask ⊙ X)·W / keep, with its two
// gradients, for sm_90a.
//
// Replaces the Pallas kernels of parallel_gcn_tpu/ops/pallas_fused.py (K10):
//   fwd_*_kernel: _fwd_kernel  Y  = xm · W,  xm = where(mask, x·inv_keep, 0)
//   dw_*_kernel:  _dw_kernel   dW = xmᵀ · g   (g rounded to x's dtype)
//   dx_kernel:    _dx_kernel   dX = where(mask, (g · Wᵀ)·(1/keep), 0)
// X is [n, k] contiguous, W [k, m], Y and g [n, m] float32. The mask is
// regenerated in every kernel and never stored.
//
// Mask contract: the port's dropout mask (csrc/dropout.cu, K1). Element
// (r, c) has flat index i = r·k + c and is kept iff word i & 3 of
// Philox4x32-10(key = seed, counter = i >> 2) is below thr. So for one
// seed the fused kernels drop exactly the elements K1/K2 drop, and the
// fused and unfused paths give the same trajectory up to matmul rounding
// (the JAX package keeps the same invariant between its own kernels,
// pallas_fused.py:106-116). A counter covers 4 flat elements, which can
// straddle a row end when k % 4 != 0: a group of 4 columns then draws two
// counters.
//
// Rounding points, as pallas_fused.py:49-104 and 226-238: xm in x's dtype
// with inv_keep rounded to x's dtype (the wrapper rounds it); f32
// accumulation; the forward returns f32; dW contracts xm with g rounded to
// x's dtype and is returned in W's dtype (= x's dtype here) after the split
// sum; dX computes g·Wᵀ in f32 with the f32 1/keep, then rounds to x's
// dtype. bf16 products run on the tensor cores (mma.sync m16n8k16, f32
// accumulate); f32 products on CUDA-core FMAs, never TF32.
//
// Hopper design. The TPU kernels walk (row block, column block) grids in
// order and accumulate into a resident output block. Here:
//   * forward: a block owns 64 rows of X and 48 output columns, walks the
//     contraction in chunks, and applies the mask while it stages X in
//     shared memory (one Philox call per 4 elements);
//   * dW contracts over all n rows into a [k, m] result: a block owns a
//     64 x 48 slab of dW and one of `splits` row ranges, and writes an f32
//     partial; a second kernel sums the partials in split order (no
//     atomics, so runs are bit-identical, as K4's split rows);
//   * dX: a block owns 64 rows, keeps their g in shared memory and walks
//     the k columns in tiles of 64, masking in the epilogue.
// Ragged n, k and m are masked in the kernels; the host pads nothing.
//
// What bounds it on an H100, at synth-reddit's layer 1 (X [233472, 600]
// bf16, W [600, 41]): the forward reads X (280.2 MB) and writes Y (38.3 MB),
// ~0.095 ms at 3.35 TB/s; dW reads X and g, about the same; dX reads g and
// writes 280.2 MB, ~0.095 ms. Each pass is 11.5 GFLOP: ~0.012 ms on the
// bf16 tensor cores, ~0.17 ms on f32 CUDA cores (dX's product is f32).
// This first version stages through shared memory without a copy pipeline
// and wastes 7 of 48 output columns at m = 41; it sits above those bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

struct Mask {
  uint32_t k0, k1, thr;

  __device__ __forceinline__ unsigned keep_bits(uint64_t ctr) const {
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)ctr, (uint32_t)(ctr >> 32), 0u, 0u), k0, k1);
    return (unsigned)(w.x < thr) | (unsigned)(w.y < thr) << 1 |
           (unsigned)(w.z < thr) << 2 | (unsigned)(w.w < thr) << 3;
  }

  // Keep bits (bit q for flat element b + q) of the 4 elements b .. b+3.
  __device__ __forceinline__ unsigned keep4(int64_t b) const {
    const uint64_t ctr = (uint64_t)b >> 2;
    const int s = (int)(b & 3);
    unsigned bits = keep_bits(ctr);
    if (s) bits |= keep_bits(ctr + 1) << 4;
    return (bits >> s) & 0xFu;
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__device__ __forceinline__ bool aligned4(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T))) == 0;
}

// The masked, scaled x of row `row`, columns col .. col+3 (zeros past n
// rows or k columns), each rounded to T: where(keep, x·inv_keep, 0).
template <typename T>
__device__ __forceinline__ void masked4(const T* __restrict__ x, int64_t n, int k,
                                        int64_t row, int col, const Mask& mk,
                                        float inv_keep, float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.0f;
  if (row >= n || col >= k) return;
  const int64_t b = row * k + col;
  const unsigned keep = mk.keep4(b);
  if (!keep) return;
  const int len = min(4, k - col);
  float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (len == 4 && aligned4(x + b)) {
    load4(x + b, xv);
  } else {
    for (int q = 0; q < len; ++q) xv[q] = to_float(x[b + q]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < len && ((keep >> q) & 1u)) v[q] = round_to<T>(xv[q] * inv_keep);
}

// ---------------------------------------------------------------------------
// CUDA-core FMA blocks: 64 x TN outputs, 16 x (TN/4) threads, 4 x 4 each.
// acc[i][j] += Σ_{kk < klen} a_s[ty·4+i][kk] · b_s[kk][tx·4+j]
template <int AS, int TN>
__device__ __forceinline__ void fma_block(float (*a_s)[AS], float (*b_s)[TN],
                                          float (&acc)[4][4], int ty, int tx, int klen) {
#pragma unroll 8
  for (int kk = 0; kk < klen; ++kk) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_s[ty * 4 + i][kk];
    const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
      acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
      acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
    }
  }
}

constexpr int kRows = 64;                      // rows (fwd, dx) or dW rows per block
constexpr int kTN = 48;                        // output columns per block (fwd, dW)
constexpr int kFmaChunk = 32;                  // contraction chunk, f32 fwd and dW
constexpr int kFmaThreads = 16 * (kTN / 4);    // 192

// f32 forward: out[r0.., n0..] = xm · W
__global__ void __launch_bounds__(kFmaThreads)
fwd_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int64_t n, int k, int m, Mask mk,
               float inv_keep) {
  __shared__ float a_s[kRows][kFmaChunk + 1];              // xm [row][kcol]
  __shared__ __align__(16) float b_s[kFmaChunk][kTN];      // W [kcol][out col]
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int n0 = blockIdx.y * kTN;
  const int tid = threadIdx.x;
  const int ty = tid / (kTN / 4);
  const int tx = tid % (kTN / 4);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kFmaChunk) {
    for (int e = tid; e < kRows * kFmaChunk / 4; e += kFmaThreads) {
      const int r = e / (kFmaChunk / 4);
      const int c = (e % (kFmaChunk / 4)) * 4;
      float v[4];
      masked4(x, n, k, r0 + r, k0 + c, mk, inv_keep, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) a_s[r][c + q] = v[q];
    }
    for (int e = tid; e < kFmaChunk * kTN; e += kFmaThreads) {
      const int kk = e / kTN;
      const int j = e % kTN;
      b_s[kk][j] = (k0 + kk < k && n0 + j < m) ? w[(int64_t)(k0 + kk) * m + n0 + j] : 0.0f;
    }
    __syncthreads();
    fma_block<kFmaChunk + 1, kTN>(a_s, b_s, acc, ty, tx, kFmaChunk);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = r0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (row < n && col < m) out[row * m + col] = acc[i][j];
    }
  }
}

// f32 dW partial of row range [rs0, rs0 + rows_per_split):
// ws[split][kc0.., n0..] = xmᵀ · g
__global__ void __launch_bounds__(kFmaThreads)
dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ ws, int64_t n, int k, int m,
              int64_t rows_per_split, Mask mk, float inv_keep) {
  __shared__ float a_s[kRows][kFmaChunk + 1];              // xm [kcol][row]
  __shared__ __align__(16) float b_s[kFmaChunk][kTN];      // g [row][out col]
  const int kc0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kTN;
  const int64_t rs0 = (int64_t)blockIdx.z * rows_per_split;
  const int64_t rs1 = rs0 + rows_per_split < n ? rs0 + rows_per_split : n;
  const int tid = threadIdx.x;
  const int ty = tid / (kTN / 4);
  const int tx = tid % (kTN / 4);
  float acc[4][4] = {};
  for (int64_t r0 = rs0; r0 < rs1; r0 += kFmaChunk) {
    for (int e = tid; e < kFmaChunk * kRows / 4; e += kFmaThreads) {
      const int r = e / (kRows / 4);
      const int c = (e % (kRows / 4)) * 4;
      float v[4];
      masked4(x, n, k, r0 + r, kc0 + c, mk, inv_keep, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) a_s[c + q][r] = v[q];
    }
    for (int e = tid; e < kFmaChunk * kTN; e += kFmaThreads) {
      const int r = e / kTN;
      const int j = e % kTN;
      b_s[r][j] = (r0 + r < n && n0 + j < m) ? g[(r0 + r) * m + n0 + j] : 0.0f;
    }
    __syncthreads();
    fma_block<kFmaChunk + 1, kTN>(a_s, b_s, acc, ty, tx, kFmaChunk);
    __syncthreads();
  }
  float* dst = ws + (int64_t)blockIdx.z * k * m;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = kc0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (kc < k && col < m) dst[(int64_t)kc * m + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync.m16n8k16 (bf16 x bf16 -> f32), 4 warps x 16
// rows of output, kTN / 8 = 6 n-tiles of 8 columns.
constexpr int kMmaK = 64;              // contraction chunk
constexpr int kPad = kMmaK + 8;        // smem row stride (bf16) of [.][k] operands
constexpr int kGPad = kTN + 8;         // smem row stride (bf16) of dW's g
constexpr int kMmaThreads = 128;

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

// two bf16 in one register, `lo` in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// bf16 forward: out[r0.., n0..] = xm · W
__global__ void __launch_bounds__(kMmaThreads)
fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               float* __restrict__ out, int64_t n, int k, int m, Mask mk,
               float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 a_s[kRows][kPad];  // xm [row][kcol]
  __shared__ __align__(16) __nv_bfloat16 b_s[kTN][kPad];    // W  [out col][kcol]
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int n0 = blockIdx.y * kTN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane >> 2;  // mma groupID
  const int q = lane & 3;    // mma threadID_in_group
  const int n_active = min(kTN / 8, (m - n0 + 7) / 8);  // block-uniform
  float acc[kTN / 8][4] = {};
  for (int k0 = 0; k0 < k; k0 += kMmaK) {
    for (int e = tid; e < kRows * kMmaK / 4; e += kMmaThreads) {
      const int r = e / (kMmaK / 4);
      const int c = (e % (kMmaK / 4)) * 4;
      float v[4];
      masked4(x, n, k, r0 + r, k0 + c, mk, inv_keep, v);
      store4(&a_s[r][c], v);  // exact: v is already bf16
    }
    for (int e = tid; e < kTN * kMmaK; e += kMmaThreads) {  // W rows read coalesced
      const int c = e / kTN;
      const int j = e % kTN;
      b_s[j][c] = (k0 + c < k && n0 + j < m) ? w[(int64_t)(k0 + c) * m + n0 + j]
                                             : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      const int ar = warp * 16 + gq;
      const uint32_t a0 = lds32(&a_s[ar][kk + q * 2]);
      const uint32_t a1 = lds32(&a_s[ar + 8][kk + q * 2]);
      const uint32_t a2 = lds32(&a_s[ar][kk + 8 + q * 2]);
      const uint32_t a3 = lds32(&a_s[ar + 8][kk + 8 + q * 2]);
#pragma unroll
      for (int nt = 0; nt < kTN / 8; ++nt) {
        if (nt < n_active) {
          const uint32_t b0 = lds32(&b_s[nt * 8 + gq][kk + q * 2]);
          const uint32_t b1 = lds32(&b_s[nt * 8 + gq][kk + 8 + q * 2]);
          mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < kTN / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + warp * 16 + gq + h * 8;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = n0 + nt * 8 + q * 2 + jj;
        if (row < n && col < m) out[row * m + col] = acc[nt][h * 2 + jj];
      }
    }
  }
}

// bf16 dW partial of row range [rs0, rs0 + rows_per_split):
// ws[split][kc0.., n0..] = xmᵀ · bf16(g). The contraction runs over rows,
// so the mma fragments pair two rows of the [row][.] tiles.
__global__ void __launch_bounds__(kMmaThreads)
dw_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ ws, int64_t n, int k, int m,
              int64_t rows_per_split, Mask mk, float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 x_s[kMmaK][kPad];   // xm [row][kcol]
  __shared__ __align__(16) __nv_bfloat16 g_s[kMmaK][kGPad];  // g  [row][out col]
  const int kc0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kTN;
  const int64_t rs0 = (int64_t)blockIdx.z * rows_per_split;
  const int64_t rs1 = rs0 + rows_per_split < n ? rs0 + rows_per_split : n;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const int n_active = min(kTN / 8, (m - n0 + 7) / 8);
  float acc[kTN / 8][4] = {};
  for (int64_t r0 = rs0; r0 < rs1; r0 += kMmaK) {
    for (int e = tid; e < kMmaK * kRows / 4; e += kMmaThreads) {
      const int r = e / (kRows / 4);
      const int c = (e % (kRows / 4)) * 4;
      float v[4];
      masked4(x, n, k, r0 + r, kc0 + c, mk, inv_keep, v);
      store4(&x_s[r][c], v);
    }
    for (int e = tid; e < kMmaK * kTN; e += kMmaThreads) {
      const int r = e / kTN;
      const int j = e % kTN;
      g_s[r][j] = __float2bfloat16_rn(
          (r0 + r < n && n0 + j < m) ? g[(r0 + r) * m + n0 + j] : 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      const int ac = warp * 16 + gq;  // dW row (x column) of fragment row gq
      const int ka = kk + q * 2;      // contraction rows ka, ka + 1 (+ 8)
      const uint32_t a0 = pack2(x_s[ka][ac], x_s[ka + 1][ac]);
      const uint32_t a1 = pack2(x_s[ka][ac + 8], x_s[ka + 1][ac + 8]);
      const uint32_t a2 = pack2(x_s[ka + 8][ac], x_s[ka + 9][ac]);
      const uint32_t a3 = pack2(x_s[ka + 8][ac + 8], x_s[ka + 9][ac + 8]);
#pragma unroll
      for (int nt = 0; nt < kTN / 8; ++nt) {
        if (nt < n_active) {
          const int bc = nt * 8 + gq;
          const uint32_t b0 = pack2(g_s[ka][bc], g_s[ka + 1][bc]);
          const uint32_t b1 = pack2(g_s[ka + 8][bc], g_s[ka + 9][bc]);
          mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
        }
      }
    }
    __syncthreads();
  }
  float* dst = ws + (int64_t)blockIdx.z * k * m;
#pragma unroll
  for (int nt = 0; nt < kTN / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kc = kc0 + warp * 16 + gq + h * 8;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = n0 + nt * 8 + q * 2 + jj;
        if (kc < k && col < m) dst[(int64_t)kc * m + col] = acc[nt][h * 2 + jj];
      }
    }
  }
}

// dW = Σ_split ws[split], in split order, rounded to T.
template <typename T>
__global__ void reduce_splits_kernel(const float* __restrict__ ws, int splits,
                                     int64_t km, T* __restrict__ dw) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < km;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int i = 0; i < splits; ++i) s += ws[(int64_t)i * km + e];
    dw[e] = from_float<T>(s);
  }
}

// ---------------------------------------------------------------------------
// dX: f32 CUDA-core FMAs over the m contraction (g is f32, W is read as
// f32), then where(keep, ·/keep, 0) rounded to T.
constexpr int kDxTN = 64;                      // k columns per tile
constexpr int kDxChunk = 64;                   // m contraction chunk
constexpr int kDxThreads = 16 * (kDxTN / 4);   // 256

template <typename T>
__global__ void __launch_bounds__(kDxThreads)
dx_kernel(const float* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx,
          int64_t n, int k, int m, Mask mk, float inv_keep) {
  __shared__ float a_s[kRows][kDxChunk + 1];            // g [row][m]
  __shared__ __align__(16) float b_s[kDxChunk][kDxTN];  // W [m][kcol]
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int ty = tid / (kDxTN / 4);
  const int tx = tid % (kDxTN / 4);
  for (int k0 = 0; k0 < k; k0 += kDxTN) {
    float acc[4][4] = {};
    for (int m0 = 0; m0 < m; m0 += kDxChunk) {
      const int mlen = min(kDxChunk, m - m0);
      if (m > kDxChunk || k0 == 0) {  // g stays staged across tiles when m fits
        for (int e = tid; e < kRows * kDxChunk; e += kDxThreads) {
          const int r = e / kDxChunk;
          const int j = e % kDxChunk;
          a_s[r][j] = (r0 + r < n && j < mlen) ? g[(r0 + r) * m + m0 + j] : 0.0f;
        }
      }
      for (int e = tid; e < kDxChunk * kDxTN; e += kDxThreads) {
        const int j = e / kDxTN;
        const int c = e % kDxTN;
        b_s[j][c] = (j < mlen && k0 + c < k) ? to_float(w[(int64_t)(k0 + c) * m + m0 + j])
                                             : 0.0f;
      }
      __syncthreads();
      fma_block<kDxChunk + 1, kDxTN>(a_s, b_s, acc, ty, tx, mlen);
      __syncthreads();
    }
    const int col = k0 + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = r0 + ty * 4 + i;
      if (row >= n || col >= k) continue;
      const int64_t b = row * k + col;
      const unsigned keep = mk.keep4(b);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ((keep >> j) & 1u) ? acc[i][j] * inv_keep : 0.0f;
      const int len = min(4, k - col);
      if (len == 4 && aligned4(dx + b)) {
        store4(dx + b, v);
      } else {
        for (int j = 0; j < len; ++j) dx[b + j] = from_float<T>(v[j]);
      }
    }
  }
}

Mask make_mask(uint64_t seed, uint32_t thr) {
  return Mask{(uint32_t)seed, (uint32_t)(seed >> 32), thr};
}

unsigned cdiv(int64_t a, int64_t b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x and w alike. x: [n, k], w: [k, m],
// out: [n, m] f32, all contiguous. inv_keep is 1/keep rounded to x's dtype.
// Each entry point returns cudaGetLastError() after its launches.
extern "C" int pgcn_dropout_matmul_fwd(const void* x, const void* w, float* out,
                                       int dtype, int64_t n, int k, int m,
                                       uint64_t seed, uint32_t thr, float inv_keep,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(n, kRows), cdiv(m, kTN));
  const Mask mk = make_mask(seed, thr);
  if (dtype == 0)
    fwd_fma_kernel<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(x),
                                                static_cast<const float*>(w), out, n,
                                                k, m, mk, inv_keep);
  else if (dtype == 1)
    fwd_mma_kernel<<<grid, kMmaThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<const __nv_bfloat16*>(w),
                                                out, n, k, m, mk, inv_keep);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// g: [n, m] f32; ws: [splits, k, m] f32 scratch; dw: [k, m] in x's dtype.
// Split i covers rows [i·rows_per_split, (i+1)·rows_per_split); rows_per_split
// is a multiple of 64 and splits the least count that covers n.
extern "C" int pgcn_dropout_matmul_dw(const void* x, const float* g, float* ws,
                                      void* dw, int dtype, int64_t n, int k, int m,
                                      int splits, int64_t rows_per_split,
                                      uint64_t seed, uint32_t thr, float inv_keep,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0 || splits <= 0 || rows_per_split <= 0 ||
      rows_per_split % kMmaK || (int64_t)splits != (n + rows_per_split - 1) / rows_per_split)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(k, kRows), cdiv(m, kTN), (unsigned)splits);
  const Mask mk = make_mask(seed, thr);
  const int64_t km = (int64_t)k * m;
  const unsigned rblocks = cdiv(km, 256) < 1024u ? cdiv(km, 256) : 1024u;
  if (dtype == 0) {
    dw_fma_kernel<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(x), g, ws, n, k,
                                               m, rows_per_split, mk, inv_keep);
    reduce_splits_kernel<float><<<rblocks, 256, 0, s>>>(ws, splits, km,
                                                       static_cast<float*>(dw));
  } else if (dtype == 1) {
    dw_mma_kernel<<<grid, kMmaThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), g,
                                               ws, n, k, m, rows_per_split, mk, inv_keep);
    reduce_splits_kernel<__nv_bfloat16><<<rblocks, 256, 0, s>>>(
        ws, splits, km, static_cast<__nv_bfloat16*>(dw));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g: [n, m] f32; w: [k, m] in x's dtype; dx: [n, k] in x's dtype.
// inv_keep here is the f32 1/keep (not rounded to x's dtype).
extern "C" int pgcn_dropout_matmul_dx(const float* g, const void* w, void* dx, int dtype,
                                      int64_t n, int k, int m, uint64_t seed,
                                      uint32_t thr, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const Mask mk = make_mask(seed, thr);
  if (dtype == 0)
    dx_kernel<float><<<cdiv(n, kRows), kDxThreads, 0, s>>>(
        g, static_cast<const float*>(w), static_cast<float*>(dx), n, k, m, mk, inv_keep);
  else if (dtype == 1)
    dx_kernel<__nv_bfloat16><<<cdiv(n, kRows), kDxThreads, 0, s>>>(
        g, static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(dx), n, k,
        m, mk, inv_keep);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
