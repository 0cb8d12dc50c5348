// Fused inverted dropout and matmul, Y = (mask ⊙ X)·W / keep, with its two
// gradients, for sm_90a.
//
// Replaces the Pallas kernels of parallel_gcn_tpu/ops/pallas_fused.py (K10):
//   fwd_*_kernel: _fwd_kernel  Y  = xm · W,  xm = where(mask, x·inv_keep, 0)
//   dw_*_kernel:  _dw_kernel   dW = xmᵀ · g   (g rounded to x's dtype)
//   dx_*kernel:   _dx_kernel   dX = where(mask, (g · Wᵀ)·(1/keep), 0)
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
// counters (the kernels' kAl4 = false instantiations).
//
// Rounding points, as pallas_fused.py:49-104 and 226-238: xm in x's dtype
// with inv_keep rounded to x's dtype (the wrapper rounds it); f32
// accumulation; the forward returns f32; dW contracts xm with g rounded to
// x's dtype and is returned in W's dtype (= x's dtype here) after the split
// sum; dX computes g·Wᵀ in f32 with the f32 1/keep, then rounds to x's
// dtype. f32 products run on CUDA-core FMAs, never TF32 (cora's f32 layer
// 0; fwd_fma_kernel, dw_fma_kernel, dx_kernel, unchanged since their first
// version).
//
// What bounds the bf16 kernels on an H100, at synth-reddit's layer 1 (X
// [233472, 600] bf16, W [600, 41], rate 0.1): each moves X once (280.2 MB)
// and g or Y once (38.3 MB): ~0.095 ms at 3.35 TB/s. Each draws one Philox
// counter per 4 elements of X, 35M counters of 10 rounds (~0.1 ms of
// integer issue, which has to hide under the stream, as in K2). The
// products, 11.5 GFLOP (dX: three times that, below), are ~0.012 ms at the
// bf16 tensor-core peak; on f32 CUDA cores dX's product would be ~0.17 ms.
// The design (each kernel's section below says more):
//   * forward: a persistent grid sized from the device; a block stages W
//     once in mma fragment order and walks 128-row tiles of X through a
//     3-stage cp.async ring; the mask is applied in registers on the A
//     fragments, whose k order is permuted so that a thread holds 4
//     consecutive columns of a row: one Philox call per 4 elements;
//   * dW: a block owns a slab of up to 320 x columns and one row split
//     (split counts from the device); a 4-stage ring of x and g, one
//     in-place 16-byte masking pass, fragments by ldmatrix.trans; the f32
//     partials are summed in split order by reduce_splits_kernel;
//   * dX: the product on the tensor cores at f32 accuracy (g split into
//     three exact bf16 terms), W staged once, output columns permuted so a
//     thread writes 4 consecutive columns under one Philox counter.
// Ragged n, k and m are masked in the kernels; the host pads nothing.
//
// Seed lanes (*_lanes_kernel, the pgcn_dropout_matmul_*_lanes entry points):
// one launch runs a layer of S training runs, as JAX's vmap of the Pallas
// kernels adds a batch grid axis, lane s with its own seed at its solo mask
// index and each output summed in the unlaned kernel's order, so a lane is
// the unlaned launch bit for bit (the comment above LaneArgs). The joined g
// is read in place. The f32 forward over a shared x takes a row tile × a
// tile of the lanes' columns, reading x's piece once for the block's lanes;
// the bf16 dX takes a row tile for every lane and writes whole joined rows;
// the rest run the unlaned body once a lane (blockIdx.y or z), each lane
// reading a shared x itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

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

// The mask as the entry points take it: the uint64 seed lives in device
// memory, written by the caller before the launch, so that a launch
// captured in a CUDA graph draws a new mask each replay. Each kernel reads
// it once per thread into its Mask.
struct MaskArgs {
  const unsigned long long* seed;
  uint32_t thr;

  __device__ __forceinline__ Mask load() const {
    const unsigned long long key = __ldg(seed);
    return Mask{(uint32_t)key, (uint32_t)(key >> 32), thr};
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
// rows or k columns), each rounded to T: where(keep, x·inv_keep, 0). The
// mask index is row·k + col (x as its own [n, k]); x's rows lie ldx apart.
template <typename T>
__device__ __forceinline__ void masked4(const T* __restrict__ x, int64_t n, int k,
                                        int64_t ldx, int64_t row, int col, const Mask& mk,
                                        float inv_keep, float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.0f;
  if (row >= n || col >= k) return;
  const unsigned keep = mk.keep4(row * k + col);
  if (!keep) return;
  const T* p = x + row * ldx + col;
  const int len = min(4, k - col);
  float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (len == 4 && aligned4(p)) {
    load4(p, xv);
  } else {
    for (int q = 0; q < len; ++q) xv[q] = to_float(p[q]);
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

// f32 forward: out[r0.., n0..] = xm · W (x's rows ldx apart, out's ldo)
__device__ __forceinline__ void fwd_fma_body(const float* __restrict__ x,
                                             const float* __restrict__ w,
                                             float* __restrict__ out, int64_t n, int k, int m,
                                             int64_t ldx, int64_t ldo, MaskArgs ma,
                                             float inv_keep) {
  const Mask mk = ma.load();
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
      masked4(x, n, k, ldx, r0 + r, k0 + c, mk, inv_keep, v);
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
      if (row < n && col < m) out[row * ldo + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kFmaThreads)
fwd_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int64_t n, int k, int m, MaskArgs ma,
               float inv_keep) {
  fwd_fma_body(x, w, out, n, k, m, k, m, ma, inv_keep);
}

// f32 dW partial of row range [rs0, rs0 + rows_per_split) of split
// `split`: ws[split][kc0.., n0..] = xmᵀ · g (g's rows ldg apart)
__device__ __forceinline__ void dw_fma_body(const float* __restrict__ x,
                                            const float* __restrict__ g,
                                            float* __restrict__ ws, int64_t n, int k, int m,
                                            int64_t ldx, int64_t ldg, int64_t rows_per_split,
                                            int split,
                                            MaskArgs ma, float inv_keep) {
  const Mask mk = ma.load();
  __shared__ float a_s[kRows][kFmaChunk + 1];              // xm [kcol][row]
  __shared__ __align__(16) float b_s[kFmaChunk][kTN];      // g [row][out col]
  const int kc0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kTN;
  const int64_t rs0 = (int64_t)split * rows_per_split;
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
      masked4(x, n, k, ldx, r0 + r, kc0 + c, mk, inv_keep, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) a_s[c + q][r] = v[q];
    }
    for (int e = tid; e < kFmaChunk * kTN; e += kFmaThreads) {
      const int r = e / kTN;
      const int j = e % kTN;
      b_s[r][j] = (r0 + r < n && n0 + j < m) ? g[(r0 + r) * ldg + n0 + j] : 0.0f;
    }
    __syncthreads();
    fma_block<kFmaChunk + 1, kTN>(a_s, b_s, acc, ty, tx, kFmaChunk);
    __syncthreads();
  }
  float* dst = ws + (int64_t)split * k * m;
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

__global__ void __launch_bounds__(kFmaThreads)
dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ ws, int64_t n, int k, int m,
              int64_t rows_per_split, MaskArgs ma, float inv_keep) {
  dw_fma_body(x, g, ws, n, k, m, k, m, rows_per_split, blockIdx.z, ma, inv_keep);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync.m16n8k16 (bf16 x bf16 -> f32), fed by
// cp.async rings of 16-byte copies.

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

// 16 bytes global → shared, of which the first src_bytes are read and the
// rest zero-filled (0: a zero piece past the data); around them 256 bytes
// are fetched into L2, so a strided stream reaches memory in 256-byte runs.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global → shared, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return (uint32_t)__bfloat16_as_ushort(*p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Keep bits of the 4 flat elements b .. b+3 (bit q for b + q): one Philox
// counter when b is a multiple of 4 (kAl4: k % 4 == 0 and the column a
// multiple of 4), else the two counters the group straddles.
template <bool kAl4>
__device__ __forceinline__ unsigned keep4(const Mask& mk, int64_t b) {
  return kAl4 ? mk.keep_bits((uint64_t)b >> 2) : mk.keep4(b);
}

// 0xFFFF over each 16-bit half (bf16 element) that is kept: the AND masks
// of the 2 words holding the 4 bf16 of flat elements b .. b+3. With kAl4
// the 4 Philox words are compared straight (no bit packing).
template <bool kAl4>
__device__ __forceinline__ uint2 keep_masks(const Mask& mk, int64_t b) {
  if (kAl4) {
    const uint64_t ctr = (uint64_t)b >> 2;
    const uint4 w = philox4x32_10(make_uint4((uint32_t)ctr, (uint32_t)(ctr >> 32), 0u, 0u),
                                  mk.k0, mk.k1);
    return make_uint2((w.x < mk.thr ? 0x0000FFFFu : 0u) | (w.y < mk.thr ? 0xFFFF0000u : 0u),
                      (w.z < mk.thr ? 0x0000FFFFu : 0u) | (w.w < mk.thr ? 0xFFFF0000u : 0u));
  }
  const unsigned bits = mk.keep4(b);
  return make_uint2((bits & 1u ? 0x0000FFFFu : 0u) | (bits & 2u ? 0xFFFF0000u : 0u),
                    (bits & 4u ? 0x0000FFFFu : 0u) | (bits & 8u ? 0xFFFF0000u : 0u));
}

// The 4 staged bf16 (2 words) of flat elements b .. b+3 times inv_keep
// (bf16x2 ik2), each rounded once to bf16, under their keep masks.
__device__ __forceinline__ uint2 mask4(uint2 v, uint2 keep, uint32_t ik2) {
  uint32_t p0, p1;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p0) : "r"(v.x), "r"(ik2));
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p1) : "r"(v.y), "r"(ik2));
  return make_uint2(p0 & keep.x, p1 & keep.y);
}

// ---- forward ---------------------------------------------------------------
// A persistent grid of one 16-warp block per SM (from the occupancy
// calculator). W is staged once per block in mma fragment order (a lane's
// B registers of two n-tiles are one 16-byte read). Each warp then streams
// 16-row tiles of X on its own, tiles gw, gw + W, ... (gw the warp's index
// in the grid, W the grid's warps, so the warps read one band of rows at a
// time), through a 4-stage ring of its own of [16 rows × 64 columns]
// pieces (cp.async, 16 bytes a copy, row-swizzled so the fragment reads
// are conflict-free), synchronised by __syncwarp only: warps drift apart,
// and one warp's Philox rounds overlap another's loads (a block-wide ring
// kept the warps in step and measured the Philox rounds on top of the
// stream). Inside a k16 step the k order is permuted (fragment k 2q+j ↔
// column 4q+j, k 8+2q+j ↔ column 4q+2+j), so a thread's A registers of a
// row are its columns 4q..4q+3: one 8-byte read and, when k % 4 == 0, one
// Philox counter, masked in registers. W larger than kWBytes (or m > kNB)
// is taken in chunks of columns of X (or of W); a later k chunk adds into
// out, which the same thread wrote for the earlier chunk (the tile→warp
// map is fixed).
constexpr int kFwdWarps = 16;
constexpr int kKC = 64;                         // X columns a ring stage
constexpr int kFwdStages = 4;                   // ring stages a warp
constexpr int kFwdStageBytes = 16 * kKC * 2;    // 2 KB: 16 rows × 64 columns
constexpr int kNB = 64;                         // output columns a W chunk
constexpr int kWBytes = 64 * 1024;              // shared bytes of a W chunk

// the 16-byte piece p of staged row r sits at p ^ xswz(r)
__device__ __forceinline__ int xswz(int r) { return (r & 3) << 1; }

// Lane `lane` of a warp copies its share of the [16 rows × 64 columns]
// bf16 block of x at (row0, col0) into a ring stage (rows of 128 bytes,
// piece p of row r at p ^ xswz(r)): 16-byte cp.async copies when vec (k % 8
// == 0 and x 16-byte aligned), else element by element. Zeros past row n or
// column k.
__device__ __forceinline__ void stage_x(uint8_t* st, const __nv_bfloat16* __restrict__ x,
                                        int64_t row0, int64_t n, int col0, int k, int64_t ldx,
                                        bool vec, int lane) {
#pragma unroll
  for (int e = lane; e < 16 * (kKC / 8); e += 32) {
    const int r = e / (kKC / 8);
    const int p = e % (kKC / 8);
    const int64_t row = row0 + r;
    const int col = col0 + 8 * p;
    uint8_t* dst = st + r * (kKC * 2) + ((p ^ xswz(r)) << 4);
    const bool ok = row < n && col < k;
    if (vec) {
      cp_async16(dst, ok ? x + row * ldx + col : x, ok ? 16 : 0);
    } else {
      uint32_t h[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        h[t] = (row < n && col + t < k) ? bf16_bits(x + row * ldx + col + t) : 0u;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
    }
  }
}

template <bool kAl4>
__device__ __forceinline__ void fwd_mma_body(const __nv_bfloat16* __restrict__ x,
                                             const __nv_bfloat16* __restrict__ w,
                                             float* __restrict__ out, int64_t n, int k, int m,
                                             int64_t ldx, int64_t ldo, int kw_max, int vec,
                                             MaskArgs ma, uint32_t ik2) {
  const Mask mk = ma.load();
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  uint8_t* ring = smem + warp * kFwdStages * kFwdStageBytes;
  const uint4* wf = reinterpret_cast<const uint4*>(smem + kFwdWarps * kFwdStages * kFwdStageBytes);
  uint32_t* wf32 = reinterpret_cast<uint32_t*>(smem + kFwdWarps * kFwdStages * kFwdStageBytes);
  const int64_t n_tiles = (n + 15) / 16;
  const int64_t gw = (int64_t)blockIdx.x * kFwdWarps + warp;
  const int64_t n_warps = (int64_t)gridDim.x * kFwdWarps;
  const int my_tiles = gw < n_tiles ? (int)((n_tiles - 1 - gw) / n_warps + 1) : 0;
  // this thread's A reads of step s: rows g and g + 8 of a stage
  int a_off[kKC / 16];
#pragma unroll
  for (int s = 0; s < kKC / 16; ++s)
    a_off[s] = g * (kKC * 2) + (((2 * s + (q >> 1)) ^ xswz(g)) << 4) + 8 * (q & 1);

  for (int n0 = 0; n0 < m; n0 += kNB) {
    const int np = (min(kNB, m - n0) + 15) / 16;  // pairs of n-tiles (block-uniform)
    for (int k0w = 0; k0w < k; k0w += kw_max) {
      const int kcs = min(kw_max, k - k0w + kKC - 1) / kKC;  // ring stages a tile
      const int n_items = my_tiles * kcs;
      // the next stage to fill: item i_next = (tile it_tile, chunk it_kc)
      int i_next = 0, it_kc = 0;
      int64_t it_tile = gw;
      auto issue = [&]() {
        if (i_next < n_items) {
          stage_x(ring + (i_next % kFwdStages) * kFwdStageBytes, x, it_tile * 16, n,
                  k0w + it_kc * kKC, k, ldx, vec, lane);
          if (++it_kc == kcs) {
            it_kc = 0;
            it_tile += n_warps;
          }
        }
        ++i_next;
        cp_async_commit();
      };
      cp_async_wait<0>();
      __syncthreads();  // the W chunk before is free
      // W's rows k0w .. k0w + kcs·64 first land in the (still idle) ring as
      // one flat run of 16-byte copies, when they fit and are aligned, so
      // the fragment build below reads shared memory, not 2-byte global
      // loads one L2 trip after another
      const int w_rows = min(kcs * kKC, k - k0w);
      const int w_len = w_rows * m;  // bf16
      const bool w_ring = w_len <= kFwdWarps * kFwdStages * kFwdStageBytes / 2 &&
                          ((reinterpret_cast<uintptr_t>(w + (int64_t)k0w * m)) & 15u) == 0;
      const __nv_bfloat16* w_src = w + (int64_t)k0w * m;  // row kk at (kk - k0w)·m
      if (w_ring) {
        const __nv_bfloat16* wg = w_src;
        w_src = reinterpret_cast<const __nv_bfloat16*>(smem);
        for (int e = tid; e < (w_len + 7) / 8; e += blockDim.x) {
          const int left = w_len - 8 * e;
          cp_async16(smem + 16 * e, wg + 8 * e, left >= 8 ? 16 : 2 * left);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      // W in fragment order: word e = ((s·np + pp)·32 + lane)·4 + reg holds
      // b0, b1 of n-tile 2pp (reg 0, 1) and of 2pp+1 (reg 2, 3) of k16 step s
      const int words = kcs * (kKC / 16) * np * 128;
#pragma unroll 4
      for (int e = tid; e < words; e += blockDim.x) {
        const int reg = e & 3;
        const int ln = (e >> 2) & 31;
        const int sp = e >> 7;
        const int kr = 16 * (sp / np) + 4 * (ln & 3) + 2 * (reg & 1);  // row - k0w
        const int nn = n0 + (2 * (sp % np) + (reg >> 1)) * 8 + (ln >> 2);
        uint32_t v = 0;
        if (nn < m) {
          if (kr < w_rows) v = bf16_bits(w_src + kr * m + nn);
          if (kr + 1 < w_rows) v |= bf16_bits(w_src + (kr + 1) * m + nn) << 16;
        }
        wf32[e] = v;
      }
      __syncthreads();  // the ring is free again
#pragma unroll
      for (int c = 0; c < kFwdStages - 1; ++c) issue();
      __syncthreads();  // W staged

      float acc[kNB / 8][4];
#pragma unroll
      for (int t = 0; t < kNB / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
      int64_t tile = gw;
      int kc = 0;
      for (int i = 0; i < n_items; ++i) {
        cp_async_wait<kFwdStages - 2>();
        __syncwarp();
        issue();
        const uint8_t* st = ring + (i % kFwdStages) * kFwdStageBytes;
        const int64_t row = tile * 16 + g;
        const int col0 = k0w + kc * kKC + 4 * q;
        // flat index of (row, col0); all 16 rows and 64 columns inside X?
        const int64_t b0 = row * k + col0;
        const bool full = (tile + 1) * 16 <= n && k0w + (kc + 1) * kKC <= k;
#pragma unroll
        for (int s = 0; s < kKC / 16; ++s) {
          uint2 lo = *reinterpret_cast<const uint2*>(st + a_off[s]);
          uint2 hi = *reinterpret_cast<const uint2*>(st + a_off[s] + 8 * (kKC * 2));
          if (full) {
            lo = mask4(lo, keep_masks<kAl4>(mk, b0 + 16 * s), ik2);
            hi = mask4(hi, keep_masks<kAl4>(mk, b0 + 8 * (int64_t)k + 16 * s), ik2);
          } else if (col0 + 16 * s < k) {
            if (row < n) lo = mask4(lo, keep_masks<kAl4>(mk, b0 + 16 * s), ik2);
            if (row + 8 < n) hi = mask4(hi, keep_masks<kAl4>(mk, b0 + 8 * (int64_t)k + 16 * s), ik2);
          }
          // lo.x: row g, fragment k 2q, 2q+1 (a0); hi.x: row g+8 (a1); .y: k+8 (a2, a3)
          const uint4* wfs = wf + ((kc * (kKC / 16) + s) * np) * 32 + lane;
#pragma unroll
          for (int pp = 0; pp < kNB / 16; ++pp) {
            if (pp < np) {
              const uint4 b = wfs[pp * 32];
              mma_bf16(acc[2 * pp], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
              mma_bf16(acc[2 * pp + 1], lo.x, hi.x, lo.y, hi.y, b.z, b.w);
            }
          }
        }
        if (kc + 1 == kcs) {  // the tile's last stage: write its rows
#pragma unroll
          for (int t = 0; t < kNB / 8; ++t) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int64_t orow = row + 8 * h;
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int col = n0 + t * 8 + 2 * q + jj;
                if (t < 2 * np && orow < n && col < m) {
                  float* o = out + orow * ldo + col;
                  *o = k0w > 0 ? *o + acc[t][2 * h + jj] : acc[t][2 * h + jj];
                }
              }
              acc[t][2 * h] = acc[t][2 * h + 1] = 0.0f;
            }
          }
        }
        if (++kc == kcs) {
          kc = 0;
          tile += n_warps;
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <bool kAl4>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               float* __restrict__ out, int64_t n, int k, int m, int kw_max, int vec,
               MaskArgs ma, uint32_t ik2) {
  fwd_mma_body<kAl4>(x, w, out, n, k, m, k, m, kw_max, vec, ma, ik2);
}

// ---- dW --------------------------------------------------------------------
// Block (slab, n-block, split) contracts rows [rs0, rs1) of xm's columns
// [cs0, cs0 + slab) with g's columns [n0, n0 + 48) into an f32 partial
// ws[split][cs0.., n0..]; reduce_splits_kernel sums the partials in split
// order (no atomics, bit-identical runs). A slab is up to 320 columns (2
// m16 tiles a warp), so g is read and rounded once per slab: twice at
// k = 600, not ten times. A 4-stage ring brings 32 rows of x (16-byte
// pieces, swizzled by row) and of g (4-byte copies) per stage; one pass
// over the staged x applies the mask, 8 elements (two Philox counters) a
// thread, in place, and rounds g to bf16 beside it; then A fragments (xmᵀ)
// and B fragments (g) come from ldmatrix.trans.
constexpr int kDwRows = 64;      // rows (the contraction) a ring stage
constexpr int kDwStages = 2;     // 64-row stages, 2 blocks an SM (32-row stages ×4: 3% slower)
constexpr int kDwNB = 48;        // g columns a block
constexpr int kDwMaxSlab = 320;  // x columns a block at most (10 warps)
constexpr int kGbStride = 56;    // bf16 row stride of the rounded g (conflict-free ldmatrix)

__host__ __device__ constexpr int dw_stage_bytes(int slab) {
  return kDwRows * slab * 2 + kDwRows * kDwNB * 4;
}

__host__ __device__ constexpr int dw_smem_bytes(int slab) {
  return kDwStages * dw_stage_bytes(slab) + kDwRows * kGbStride * 2;
}

template <bool kAl4>
__device__ __forceinline__ void dw_mma_body(const __nv_bfloat16* __restrict__ x,
                                            const float* __restrict__ g,
                                            float* __restrict__ ws, int64_t n, int k, int m,
                                            int64_t ldx, int64_t ldg, int slab,
                                            int64_t rows_per_split, int split, int vec,
                                            int gflat, MaskArgs ma, uint32_t ik2) {
  const Mask mk = ma.load();
  extern __shared__ __align__(128) uint8_t smem[];
  const int stage_bytes = dw_stage_bytes(slab);
  const int x_bytes = kDwRows * slab * 2;
  __nv_bfloat16* gb = reinterpret_cast<__nv_bfloat16*>(smem + kDwStages * stage_bytes);
  const int cs0 = blockIdx.x * slab;
  const int n0 = blockIdx.y * kDwNB;
  const int64_t rs0 = (int64_t)split * rows_per_split;
  const int64_t rs1 = rs0 + rows_per_split < n ? rs0 + rows_per_split : n;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int q = lane & 3;
  const int pieces = slab / 8;  // 16-byte pieces of a staged x row
  const int np = (min(kDwNB, m - n0) + 15) / 16;
  const int n_chunks = (int)((rs1 - rs0 + kDwRows - 1) / kDwRows);
  // this thread's x pieces of a stage: piece xp of rows xr + 8i, i < 4
  // (blockDim.x = slab = 8·pieces), at xoff + i·16·slab bytes
  const int xp = tid % pieces;
  const int xr = tid / pieces;
  const int xoff = xr * slab * 2 + ((xp ^ xr) << 4);
  const int xcol = cs0 + 8 * xp;
  const int64_t gend = rs1 * m;  // g's flat end of this split

  auto issue = [&](int c) {
    if (c < n_chunks) {
      uint8_t* st = smem + (c % kDwStages) * stage_bytes;
      const int64_t r0 = rs0 + (int64_t)c * kDwRows;
#pragma unroll
      for (int i = 0; i < kDwRows / 8; ++i) {
        const int64_t row = r0 + xr + 8 * i;
        uint8_t* dst = st + xoff + i * 16 * slab;
        const bool ok = row < rs1 && xcol < k;
        if (vec) {
          cp_async16(dst, ok ? x + row * ldx + xcol : x, ok ? 16 : 0);
        } else {
          uint32_t h[8];
#pragma unroll
          for (int t = 0; t < 8; ++t)
            h[t] = (row < rs1 && xcol + t < k) ? bf16_bits(x + row * ldx + xcol + t) : 0u;
          *reinterpret_cast<uint4*>(dst) = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                                                      h[4] | h[5] << 16, h[6] | h[7] << 16);
        }
      }
      float* gr = reinterpret_cast<float*>(st + x_bytes);
      if (gflat) {  // the chunk's rows of g as one flat run of 32·m floats
        const int64_t e0 = r0 * m;
        for (int e = tid; e < kDwRows * m / 4; e += blockDim.x) {
          const int64_t left = gend - (e0 + 4 * e);
          const int bytes = left >= 4 ? 16 : (left > 0 ? (int)left * 4 : 0);
          cp_async16(gr + 4 * e, bytes ? g + e0 + 4 * e : g, bytes);
        }
      } else {
        for (int e = tid; e < kDwRows * kDwNB; e += blockDim.x) {
          const int64_t row = r0 + e / kDwNB;
          const int col = n0 + e % kDwNB;
          const bool ok = row < rs1 && col < m;
          cp_async4(gr + e, ok ? g + row * ldg + col : g, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float acc[2][kDwNB / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < kDwNB / 8; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.0f;

#pragma unroll
  for (int c = 0; c < kDwStages - 1; ++c) issue(c);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    issue(c + kDwStages - 1);
    uint8_t* st = smem + (c % kDwStages) * stage_bytes;
    const int64_t r0 = rs0 + (int64_t)c * kDwRows;
    // mask the staged x in place: 8 elements (two Philox counters) a piece
    if (xcol < k) {
#pragma unroll
      for (int i = 0; i < kDwRows / 8; ++i) {
        const int64_t row = r0 + xr + 8 * i;
        if (row < rs1) {
          uint4* ptr = reinterpret_cast<uint4*>(st + xoff + i * 16 * slab);
          const uint4 v = *ptr;
          const int64_t b = row * k + xcol;
          const uint2 a = mask4(make_uint2(v.x, v.y), keep_masks<kAl4>(mk, b), ik2);
          const uint2 z = mask4(make_uint2(v.z, v.w), keep_masks<kAl4>(mk, b + 4), ik2);
          *ptr = make_uint4(a.x, a.y, z.x, z.y);
        }
      }
    }
    // g rounded to bf16 (x's dtype), [row][col] at stride kGbStride, zero
    // past column m
    const float* gr = reinterpret_cast<const float*>(st + x_bytes);
    for (int e = tid; e < kDwRows * kDwNB / 2; e += blockDim.x) {
      const int r = e / (kDwNB / 2);
      const int j = 2 * (e % (kDwNB / 2));
      float v0, v1;
      if (gflat) {
        v0 = j < m ? gr[r * m + j] : 0.0f;
        v1 = j + 1 < m ? gr[r * m + j + 1] : 0.0f;
      } else {
        v0 = gr[r * kDwNB + j];
        v1 = gr[r * kDwNB + j + 1];
      }
      *reinterpret_cast<uint32_t*>(gb + r * kGbStride + j) = pack_bf16(v0, v1);
    }
    __syncthreads();
    const int mj = lane >> 3;
    const int mr = lane & 7;
#pragma unroll
    for (int s = 0; s < kDwRows / 16; ++s) {
      // A (xmᵀ, rows = x columns): matrices (rows 16s.., cols cm..), (16s.., cm+8..),
      // (16s+8.., cm..), (16s+8.., cm+8..)
      const int ra = 16 * s + mr + 8 * (mj >> 1);
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int pa = (warp * 32 + mt * 16) / 8 + (mj & 1);
        ldmatrix_x4_trans(a[mt], st + ra * slab * 2 + ((pa ^ (ra & 7)) << 4));
      }
      const int rb = 16 * s + mr + 8 * (mj & 1);
#pragma unroll
      for (int pp = 0; pp < kDwNB / 16; ++pp) {
        if (pp < np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, gb + rb * kGbStride + (2 * pp + (mj >> 1)) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * pp], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);
            mma_bf16(acc[mt][2 * pp + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  float* dst = ws + (int64_t)split * k * m;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int t = 0; t < kDwNB / 8; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kc = cs0 + warp * 32 + mt * 16 + g8 + 8 * h;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = n0 + t * 8 + 2 * q + jj;
          if (t < 2 * np && kc < k && col < m) dst[(int64_t)kc * m + col] = acc[mt][t][2 * h + jj];
        }
      }
    }
  }
}

template <bool kAl4>
__global__ void __launch_bounds__(kDwMaxSlab, 2)
dw_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ ws, int64_t n, int k, int m, int slab,
              int64_t rows_per_split, int vec, int gflat, MaskArgs ma, uint32_t ik2) {
  dw_mma_body<kAl4>(x, g, ws, n, k, m, k, m, slab, rows_per_split, blockIdx.z, vec, gflat, ma,
                    ik2);
}

// ---- dX --------------------------------------------------------------------
// dX = where(keep, (g·Wᵀ)·(1/keep), 0) on the tensor cores at f32 accuracy:
// g (f32) splits exactly into three bf16 terms hi + mid + lo (8 + 8 + 8
// mantissa bits) and W is bf16, so three mma passes with f32 accumulation
// give the f32 product up to summation order. A persistent grid walks
// 64-row tiles; 8 warps = 4 row groups of 16 rows × 2 column halves. W is
// staged once per block in fragment order, g's tile comes through a
// 2-stage ring of flat 16-byte copies (the tile's rows are contiguous).
// The B columns of an n-tile pair are permuted (tile A: columns
// 4(g'>>1) + (g'&1), tile B: that + 2) so a thread's outputs are columns
// 4q..4q+3 of its rows: one Philox counter (k % 4 == 0) and one 8-byte
// streaming (evict-first) store each. The store stream is what bounds the
// kernel (the stores alone take longer than the whole kernel); evict-first
// stores measured 9% faster than plain ones, and staging a 32-row tile's
// rows in shared memory to write them out 16 bytes a lane measured slower
// (kernel_variants.py, PERF.md). The pair loop is unrolled by 2, so two
// pairs' mma chains are in flight (5% faster).
// m ≤ 64 (kKS k16 steps held in registers); wider m and f32 take
// dx_kernel.
constexpr int kDxWarps = 8;
constexpr int kDxLaneWarps = 16;  // the laned dX: 4 row groups × 4 column quarters
constexpr int kDxRows = 64;

template <int kKS, bool kAl4>
__device__ __forceinline__ void dx_mma_body(const float* __restrict__ g,
                                            const __nv_bfloat16* __restrict__ w,
                                            __nv_bfloat16* __restrict__ dx, int64_t n, int k,
                                            int m, int64_t ldx, int cw_max, MaskArgs ma,
                                            float inv_keep) {
  const Mask mk = ma.load();
  extern __shared__ __align__(128) uint8_t smem[];
  float* gring = reinterpret_cast<float*>(smem);  // [2][kDxRows·m]
  const int gstage = kDxRows * m;                 // floats, a multiple of 4
  const uint4* wf = reinterpret_cast<const uint4*>(smem + 2 * gstage * 4);
  uint32_t* wf32 = reinterpret_cast<uint32_t*>(smem + 2 * gstage * 4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int q = lane & 3;
  const int64_t n_tiles = (n + kDxRows - 1) / kDxRows;
  if ((int64_t)blockIdx.x >= n_tiles) return;
  const int my_tiles = (int)((n_tiles - 1 - blockIdx.x) / gridDim.x + 1);
  const int lr = (warp & 3) * 16 + g8;  // fragment rows lr, lr + 8 of the tile
  const int half = warp >> 2;           // this warp's column pairs: half, half + 2, ...
  const int64_t nm = n * m;

  auto issue = [&](int j) {
    if (j < my_tiles) {
      const int64_t e0 = (blockIdx.x + (int64_t)j * gridDim.x) * gstage;
      float* dst = gring + (j & 1) * gstage;
      for (int e = tid; e < gstage / 4; e += blockDim.x) {
        const int64_t left = nm - (e0 + 4 * e);
        const int bytes = left >= 4 ? 16 : (left > 0 ? (int)left * 4 : 0);
        cp_async16(dst + 4 * e, bytes ? g + e0 + 4 * e : g, bytes);
      }
    }
    cp_async_commit();
  };

  for (int c0w = 0; c0w < k; c0w += cw_max) {
    const int pairs = (min(cw_max, k - c0w) + 15) / 16;
    cp_async_wait<0>();
    __syncthreads();  // W and the g ring of the chunk before are free
    issue(0);
    // W in fragment order: word ((pair·kKS + s)·32 + lane)·4 + reg, reg 0, 1:
    // b0, b1 of n-tile A, 2, 3: of n-tile B
    const int words = pairs * kKS * 128;
#pragma unroll 4
    for (int e = tid; e < words; e += blockDim.x) {
      const int reg = e & 3;
      const int ln = (e >> 2) & 31;
      const int ps = e >> 7;
      const int gg = ln >> 2;
      const int col = c0w + 16 * (ps / kKS) + 4 * (gg >> 1) + (gg & 1) + 2 * (reg >> 1);
      const int j = 16 * (ps % kKS) + 8 * (reg & 1) + 2 * (ln & 3);
      uint32_t v = 0;
      if (col < k) {
        if (j < m) v = bf16_bits(w + (int64_t)col * m + j);
        if (j + 1 < m) v |= bf16_bits(w + (int64_t)col * m + j + 1) << 16;
      }
      wf32[e] = v;
    }
    for (int jt = 0; jt < my_tiles; ++jt) {
      __syncthreads();  // every warp has read its fragments of the tile before
      issue(jt + 1);
      cp_async_wait<1>();
      __syncthreads();
      const float* gs = gring + (jt & 1) * gstage;
      const int64_t row = (blockIdx.x + (int64_t)jt * gridDim.x) * kDxRows + lr;
      // A = g split into three bf16 terms: a[term][s][reg], term 0 = lo
      uint32_t a[3][kKS][4];
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          const int r = lr + 8 * (reg & 1);
          const int j = 16 * s + 2 * q + 8 * (reg >> 1);
          const float v0 = j < m ? gs[r * m + j] : 0.0f;
          const float v1 = j + 1 < m ? gs[r * m + j + 1] : 0.0f;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
          const float r0 = v0 - __low2float(hi);
          const float r1 = v1 - __high2float(hi);
          const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
          a[2][s][reg] = *reinterpret_cast<const uint32_t*>(&hi);
          a[1][s][reg] = *reinterpret_cast<const uint32_t*>(&mid);
          a[0][s][reg] = pack_bf16(r0 - __low2float(mid), r1 - __high2float(mid));
        }
      }
#pragma unroll 2  // two pairs' mma chains in flight
      for (int pr = half; pr < pairs; pr += 2) {
        float ca[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint4 b[kKS];
#pragma unroll
        for (int s = 0; s < kKS; ++s) b[s] = wf[(pr * kKS + s) * 32 + lane];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
#pragma unroll
          for (int s = 0; s < kKS; ++s) {
            mma_bf16(ca, a[t][s][0], a[t][s][1], a[t][s][2], a[t][s][3], b[s].x, b[s].y);
            mma_bf16(cb, a[t][s][0], a[t][s][1], a[t][s][2], a[t][s][3], b[s].z, b[s].w);
          }
        }
        const int col = c0w + 16 * pr + 4 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t orow = row + 8 * h;
          if (orow < n && col < k) {
            const int64_t bidx = orow * k + col;
            __nv_bfloat16* dst = dx + orow * ldx + col;
            const unsigned bits = keep4<kAl4>(mk, bidx);
            const float v[4] = {(bits & 1u) ? ca[2 * h] * inv_keep : 0.0f,
                                (bits & 2u) ? ca[2 * h + 1] * inv_keep : 0.0f,
                                (bits & 4u) ? cb[2 * h] * inv_keep : 0.0f,
                                (bits & 8u) ? cb[2 * h + 1] * inv_keep : 0.0f};
            if (kAl4) {
              __stcs(reinterpret_cast<uint2*>(dst),
                     make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t)
                if (col + t < k) dst[t] = __float2bfloat16_rn(v[t]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int kKS, bool kAl4>
__global__ void __launch_bounds__(kDxWarps * 32, 2)
dx_mma_kernel(const float* __restrict__ g, const __nv_bfloat16* __restrict__ w,
              __nv_bfloat16* __restrict__ dx, int64_t n, int k, int m, int cw_max,
              MaskArgs ma, float inv_keep) {
  dx_mma_body<kKS, kAl4>(g, w, dx, n, k, m, k, cw_max, ma, inv_keep);
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

// The same over seed lanes: ws [lanes, splits, k, m], dw [lanes, k, m].
template <typename T>
__global__ void reduce_splits_lanes_kernel(const float* __restrict__ ws, int splits,
                                           int64_t km, int lanes, T* __restrict__ dw) {
  const int64_t total = km * lanes;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t lane = e / km;
    const float* src = ws + lane * splits * km + (e - lane * km);
    float s = 0.0f;
    for (int i = 0; i < splits; ++i) s += src[(int64_t)i * km];
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
__device__ __forceinline__ void dx_body(const float* __restrict__ g, const T* __restrict__ w,
                                        T* __restrict__ dx, int64_t n, int k, int m,
                                        int64_t ldg, int64_t ldx, MaskArgs ma, float inv_keep) {
  const Mask mk = ma.load();
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
          a_s[r][j] = (r0 + r < n && j < mlen) ? g[(r0 + r) * ldg + m0 + j] : 0.0f;
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
      const unsigned keep = mk.keep4(row * k + col);
      T* dst = dx + row * ldx + col;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ((keep >> j) & 1u) ? acc[i][j] * inv_keep : 0.0f;
      const int len = min(4, k - col);
      if (len == 4 && aligned4(dst)) {
        store4(dst, v);
      } else {
        for (int j = 0; j < len; ++j) dst[j] = from_float<T>(v[j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kDxThreads)
dx_kernel(const float* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx,
          int64_t n, int k, int m, MaskArgs ma, float inv_keep) {
  dx_body<T>(g, w, dx, n, k, m, m, k, ma, inv_keep);
}

// ---------------------------------------------------------------------------
// Seed lanes: one launch runs a layer of S training runs (seeds.fit_seeds,
// the JAX harnesses' vmap of the Pallas kernels, which adds a batch grid
// axis). x is joined [n, S·k] (lane s at column s·k: x_lane = k, ldx = S·k)
// or shared [n, k] (every lane's input: x_lane = 0, ldx = k); W is [S, k, m];
// g is joined [n, S·m] f32 and read in place (lane s's columns s·m.., rows
// S·m apart); out is [n, S·m], dX joined [n, S·k], the dW workspace [S,
// splits, k, m]. Every lane's outputs are the unlaned kernel's on the lane's
// own operands bit for bit: its mask at its solo index r·k + c with its
// seed, and each output's sum in the unlaned kernel's order (the f32 FMA
// chains over the contraction ascending in zero-padded steps of 32; the bf16
// fragments, k16 steps and dX's three terms; the dW split plan and the
// ordered split sums).
struct LaneArgs {
  int64_t x_lane, ldx, ldo;
};

__device__ __forceinline__ MaskArgs lane_mask(MaskArgs ma, int lane) {
  return MaskArgs{ma.seed + lane, ma.thr};
}

// The rest of the forward bf16 lanes: lane = blockIdx.y, each lane its own
// persistent grid over its x (x + s·x_lane, rows ldx apart) and its W.
template <bool kAl4>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
fwd_mma_lanes_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     float* __restrict__ out, int64_t n, int k, int m, LaneArgs la,
                     int kw_max, int vec, MaskArgs ma, uint32_t ik2) {
  const int lane = blockIdx.y;
  fwd_mma_body<kAl4>(x + lane * la.x_lane, w + (int64_t)lane * k * m, out + (int64_t)lane * m,
                     n, k, m, la.ldx, la.ldo, kw_max, vec, lane_mask(ma, lane), ik2);
}

// bf16 dW: block (slab, n-block, lane·splits + split) as the unlaned grid of
// each lane, x at x + s·x_lane (rows ldx apart), g's lane columns read in
// place from the joined g (rows lanes·m apart, 4-byte copies).
template <bool kAl4>
__global__ void __launch_bounds__(kDwMaxSlab, 2)
dw_mma_lanes_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ ws, int64_t n, int k, int m, int lanes, int64_t x_lane,
                    int64_t ldx, int slab, int64_t rows_per_split, int splits, int vec,
                    MaskArgs ma, uint32_t ik2) {
  const int lane = blockIdx.z / splits;
  dw_mma_body<kAl4>(x + lane * x_lane, g + (int64_t)lane * m,
                    ws + (int64_t)lane * splits * k * m, n, k, m, ldx, (int64_t)lanes * m, slab,
                    rows_per_split, blockIdx.z % splits, vec, 0, lane_mask(ma, lane), ik2);
}

// ---- f32 over seed lanes ---------------------------------------------------
// The f32 kernels of the cora-sized batches (x [2708, 1433] shared by 8
// lanes, W [8, 1433, 72]; layer 1 over the joined [2708, 8·72]) are bound by
// operations on CUDA cores.
//   * The forward over a shared x (fwd_fma_shared_kernel): the lanes' output
//     columns stand side by side, each lane's padded to a multiple of 4
//     ("virtual" columns), so a thread's 4 columns are one lane's. A block
//     owns 64 rows and a tile of vt virtual columns, the parts of the lanes
//     it spans (fwd_col_tile: as wide as the grid still covers the card
//     twice). Each 32-wide step of the contraction copies x's piece once for
//     the block's lanes and W's piece into a 2-stage ring (4-byte cp.async,
//     zeros past the edges), the next step's copies in flight while this
//     step computes; a pass then masks x's piece into one plane a lane, each
//     lane with its seed at its solo index. A thread owns up to kItems tiles
//     of 4 × 4 outputs anywhere in the block's columns (a register tile
//     across lanes), each output an FMA chain in the unlaned kernel's order.
//   * The forward over a joined x, dW and dX (fwd_fma_lanes_kernel,
//     dw_fma_lanes_kernel, dx_lanes_kernel): the unlaned body once a lane
//     (blockIdx.z, or y for dX), the joined g's lane columns read in place.
//     A tile across lanes took longer there on an H100 (device time, dW
//     over the shared x 0.4398 against 0.4242 ms, over the joined x 0.0319
//     against 0.0247; the forward over the joined x 0.0166 against 0.0160;
//     dX, a block's row tile for every lane, 0.0558 against 0.0160).
__global__ void __launch_bounds__(kFmaThreads)
fwd_fma_lanes_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int64_t n, int k, int m, LaneArgs la,
                     MaskArgs ma, float inv_keep) {
  const int lane = blockIdx.z;
  fwd_fma_body(x + lane * la.x_lane, w + (int64_t)lane * k * m, out + (int64_t)lane * m, n, k,
               m, la.ldx, la.ldo, lane_mask(ma, lane), inv_keep);
}

__global__ void __launch_bounds__(kFmaThreads)
dw_fma_lanes_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ ws, int64_t n, int k, int m, int lanes, int64_t x_lane,
                    int64_t ldx, int64_t rows_per_split, int splits, MaskArgs ma,
                    float inv_keep) {
  const int lane = blockIdx.z / splits;
  dw_fma_body(x + lane * x_lane, g + (int64_t)lane * m, ws + (int64_t)lane * splits * k * m, n,
              k, m, ldx, (int64_t)lanes * m, rows_per_split, blockIdx.z % splits,
              lane_mask(ma, lane), inv_keep);
}

constexpr int kGrpThreads = 256;
constexpr int kPlane = kRows + 4;          // a plane's row stride (floats)
constexpr int kPiece = kRows * kFmaChunk;  // floats of x's piece: 64 rows × 32 columns
constexpr int kGrpSmem = 110 * 1024;       // shared bytes a block at most
constexpr int kTilePlanes = 9;             // lanes a column tile spans at most

// x's piece of rows r0.. (64) and columns c0.. (32) into `raw` [64][32],
// 4-byte copies, zeros past n or k.
__device__ __forceinline__ void issue_x(float* raw, const float* __restrict__ x, int64_t ldx,
                                        int64_t n, int k, int64_t r0, int c0) {
  for (int e = threadIdx.x; e < kPiece; e += kGrpThreads) {
    const int r = e / kFmaChunk;
    const int c = e - r * kFmaChunk;
    const bool ok = r0 + r < n && c0 + c < k;
    cp_async4(raw + e, ok ? x + (r0 + r) * ldx + c0 + c : x, ok ? 4 : 0);
  }
}

// A thread's share of a [32][vcols] piece of W: column v = tid % vcols,
// rows tid / vcols, tid / vcols + step, ... (step = threads / vcols; the
// threads past step · vcols copy nothing), so that no copy divides.
struct ColCopy {
  int v, r0, step, l, c;

  // the piece's columns are virtual columns v0 .. v0 + vcols - 1 (lane l =
  // column / mp of the launch)
  __device__ __forceinline__ ColCopy(int vcols, int mp, int v0) {
    v = threadIdx.x % vcols;
    r0 = threadIdx.x / vcols;
    step = kGrpThreads / vcols;
    l = (v0 + v) / mp;
    c = v0 + v - l * mp;
  }
};

// W's rows k0.. (32) of the tile's lanes as [32][vcols] (lane l's column c
// at l·mp + c), zeros past k rows or m columns; `wl` is this thread's
// column of W (lane l, column c) at row 0
__device__ __forceinline__ void issue_w(float* dst, const float* __restrict__ wl,
                                        const ColCopy& cc, int k, int m, int vcols, int k0) {
  if (cc.r0 >= cc.step) return;
  for (int kk = cc.r0; kk < kFmaChunk; kk += cc.step) {
    const bool ok = k0 + kk < k && cc.c < m;
    cp_async4(dst + kk * vcols + cc.v, ok ? wl + (int64_t)(k0 + kk) * m : wl, ok ? 4 : 0);
  }
}

// The P lanes' masked planes from x's staged piece `raw`: plane l [32 k]
// [kPlane] holds lane lo + l's where(keep, x·inv_keep, 0) at column c, row
// r; the mask index is the solo (r0 + r)·k + c0 + c.
__device__ __forceinline__ void mask_planes(float* __restrict__ planes, const float* raw,
                                            int64_t n, int k, int64_t r0, int c0, int P,
                                            const uint2* keys, uint32_t thr, float inv_keep) {
  constexpr int kQuads = kPiece / 4;
  for (int e = threadIdx.x; e < P * kQuads; e += kGrpThreads) {
    const int l = e / kQuads;
    const int f = (e - l * kQuads) * 4;
    const int r = f / kFmaChunk;
    const int c = f - r * kFmaChunk;
    const float4 xv = *reinterpret_cast<const float4*>(raw + f);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int64_t row = r0 + r;
    const int col = c0 + c;
    if (row < n && col < k) {
      const Mask mk{keys[l].x, keys[l].y, thr};
      const unsigned keep = mk.keep4(row * k + col);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((keep >> q) & 1u) v[q] = round_to<float>(xs[q] * inv_keep);
    }
    float* dst = planes + l * kFmaChunk * kPlane;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[(c + q) * kPlane + r] = v[q];
  }
}

// the tile's seeds as (lo, hi) words, read once a block
__device__ __forceinline__ void load_keys(uint2* keys, MaskArgs ma, int s0, int G) {
  if ((int)threadIdx.x < G) {
    const unsigned long long key = __ldg(ma.seed + s0 + threadIdx.x);
    keys[threadIdx.x] = make_uint2((uint32_t)key, (uint32_t)(key >> 32));
  }
  __syncthreads();
}

// acc[i][j] += a[i]·b[j] in the unlaned fma_block's operand order
__device__ __forceinline__ void fma44(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
  }
}

// The tile's products of one 32-wide step: item t of this thread adds
// planes[aoff + kk·kPlane] (4 rows) times b[boff + kk·vcols] (4 of the
// tile's columns), kk ascending.
template <int kItems>
__device__ __forceinline__ void grp_step(float (&acc)[kItems][4][4], const float* a_s,
                                         const float* b_s, const int (&aoff)[kItems],
                                         const int (&boff)[kItems], int vcols, int items) {
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int kk = 0; kk < kFmaChunk; ++kk) {
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      if (tid + t * kGrpThreads < items)
        fma44(acc[t], *reinterpret_cast<const float4*>(a_s + aoff[t] + kk * kPlane),
              *reinterpret_cast<const float4*>(b_s + boff[t] + kk * vcols));
    }
  }
}

// f32 forward over a shared x: block (64-row tile, a tile of vt virtual
// columns: parts of lanes lo .. lo + P - 1, at most pmax); out[r, s·m + c]
// = xm_s · W[s]. x's piece comes once a block and W's piece through 2-stage
// rings.
template <int kItems>  // tiles of 4 × 4 outputs a thread: vt / 64, at least 1
__global__ void __launch_bounds__(kGrpThreads, kItems > 1 ? 2 : 4)
fwd_fma_shared_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int64_t n, int k, int m, int lanes, int vt,
                      int pmax, MaskArgs ma, float inv_keep) {
  extern __shared__ __align__(16) float gsm[];
  __shared__ uint2 keys[kTilePlanes];
  const int mp = (m + 3) & ~3;
  const int v0 = blockIdx.y * vt;
  const int vcols = min(vt, lanes * mp - v0);  // a multiple of 4
  const int lo = v0 / mp;
  const int P = (v0 + vcols - 1) / mp - lo + 1;
  const int items = 16 * (vcols / 4);
  const int plane = kFmaChunk * kPlane;
  float* a_s = gsm;                 // [P][32 k][kPlane]: 4 rows a float4
  float* raw = a_s + pmax * plane;  // [2][64 rows][32 k]
  float* b_s = raw + 2 * kPiece;    // [2][32 k][vcols]
  const int wstage = kFmaChunk * vt;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int tid = threadIdx.x;
  load_keys(keys, ma, lo, P);
  int aoff[kItems], boff[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int it = tid + t * kGrpThreads;
    const int cg = it >> 4;
    aoff[t] = ((v0 + cg * 4) / mp - lo) * plane + (it & 15) * 4;
    boff[t] = cg * 4;
  }
  const ColCopy cc(vcols, mp, v0);
  const float* wl = w + (int64_t)min(cc.l, lanes - 1) * k * m + min(cc.c, m - 1);
  float acc[kItems][4][4] = {};
  const int chunks = (k + kFmaChunk - 1) / kFmaChunk;
  issue_x(raw, x, k, n, k, r0, 0);
  issue_w(b_s, wl, cc, k, m, vcols, 0);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {  // the next step's pieces, into the other stage
      const int st = (ch + 1) & 1;
      issue_x(raw + st * kPiece, x, k, n, k, r0, (ch + 1) * kFmaChunk);
      issue_w(b_s + st * wstage, wl, cc, k, m, vcols, (ch + 1) * kFmaChunk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    mask_planes(a_s, raw + (ch & 1) * kPiece, n, k, r0, ch * kFmaChunk, P, keys, ma.thr,
                inv_keep);
    __syncthreads();
    grp_step(acc, a_s, b_s + (ch & 1) * wstage, aoff, boff, vcols, items);
    __syncthreads();
  }
  cp_async_wait<0>();
  const int64_t ldo = (int64_t)lanes * m;
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int it = tid + t * kGrpThreads;
    if (it >= items) continue;
    const int va = v0 + (it >> 4) * 4;
    const int l = va / mp;
    const int c0 = va - l * mp;
    float* o = out + (int64_t)l * m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = r0 + (it & 15) * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (row < n && c0 + j < m) o[row * ldo + c0 + j] = acc[t][i][j];
    }
  }
}

// ---- dX over seed lanes ------------------------------------------------------
// bf16, m <= 64 (dx_mma_lanes_kernel): a persistent grid of one 16-warp
// block an SM walks 64-row tiles (4 row groups × 4 column quarters), and a
// block takes each of its tiles for every lane of its group (blockIdx.y;
// one group of all lanes when their g's ring fits half the block's shared
// memory), so one block writes whole rows of the joined dX [n, S·k], every
// lane of a row together. The tile's rows of the joined g are staged once
// for the group through a 2-stage ring, read in place: one flat run of
// 16-byte copies when the group is every lane, else 4-byte copies of the
// group's columns. W comes per lane from its copy in mma fragment order that
// dx_wfrag_kernel writes at the start of the launch (each lane's [k, m] as
// the unlaned kernel stages it), through a 2-stage ring (of column chunks
// where a lane's W does not fit a stage), so that the next lane's W streams
// in while one computes. A lane's fragments, product order, mask and store
// are the unlaned dx_mma_body's.
// The f32 dX and bf16 with m > 64 (dx_lanes_kernel): dx_body once a lane
// (blockIdx.y), g's lane columns read in place.

// W [lanes, k, m] bf16 in dX's fragment order, every pair of 16 columns:
// lane s's word ((pair·kks + step)·32 + ln)·4 + reg at s·words_lane
__global__ void dx_wfrag_kernel(const __nv_bfloat16* __restrict__ w, uint32_t* __restrict__ out,
                                int k, int m, int kks, int64_t words_lane, int lanes) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < words_lane * lanes;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t lane = e / words_lane;
    const int64_t f = e - lane * words_lane;
    const int reg = (int)(f & 3);
    const int ln = (int)((f >> 2) & 31);
    const int64_t ps = f >> 7;
    const int gg = ln >> 2;
    const int col = 16 * (int)(ps / kks) + 4 * (gg >> 1) + (gg & 1) + 2 * (reg >> 1);
    const int j = 16 * (int)(ps % kks) + 8 * (reg & 1) + 2 * (ln & 3);
    const __nv_bfloat16* wl = w + lane * k * m;
    uint32_t v = 0;
    if (col < k) {
      if (j < m) v = bf16_bits(wl + (int64_t)col * m + j);
      if (j + 1 < m) v |= bf16_bits(wl + (int64_t)col * m + j + 1) << 16;
    }
    out[e] = v;
  }
}

template <int kKS, bool kAl4>
__global__ void __launch_bounds__(kDxLaneWarps * 32, 1)
dx_mma_lanes_kernel(const float* __restrict__ g, const uint4* __restrict__ wfrag,
                    __nv_bfloat16* __restrict__ dx, int64_t n, int k, int m, int lanes,
                    int group, int cw, MaskArgs ma, float inv_keep) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int s0 = blockIdx.y * group;
  const int G = min(group, lanes - s0);
  const int gcols = G * m;                    // staged g floats a row
  const int64_t ldg = (int64_t)lanes * m;
  const int64_t ldx = (int64_t)lanes * k;
  const int gstage = kDxRows * group * m;     // floats a g stage, a multiple of 4
  float* gring = reinterpret_cast<float*>(smem);
  const int pairs_all = (k + 15) / 16;
  const int cpairs = cw / 16;                 // pairs a W chunk
  const int chunks = (pairs_all + cpairs - 1) / cpairs;
  const int wstage = cpairs * kKS * 32;       // uint4 a W stage
  uint4* wring = reinterpret_cast<uint4*>(smem + 2 * gstage * 4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int q = lane & 3;
  const int64_t n_tiles = (n + kDxRows - 1) / kDxRows;
  if ((int64_t)blockIdx.x >= n_tiles) return;
  const int my_tiles = (int)((n_tiles - 1 - blockIdx.x) / gridDim.x + 1);
  const int per_tile = G * chunks;            // items a tile: (lane, W chunk)
  const int items = my_tiles * per_tile;
  const int lr = (warp & 3) * 16 + g8;        // fragment rows lr, lr + 8 of the tile
  const int quarter = warp >> 2;              // this warp's column pairs: quarter, + 4, ...
  const bool flat = G == lanes;               // a tile's rows of g are one contiguous run
  const int64_t ng = n * ldg;

  // tile jt's rows of the group's g into g stage jt & 1 (nothing past the
  // last tile); one commit group
  auto issue_g = [&](int jt) {
    if (jt < my_tiles) {
      const int64_t r0 = (blockIdx.x + (int64_t)jt * gridDim.x) * kDxRows;
      float* dst = gring + (jt & 1) * gstage;
      if (flat) {
        const int64_t e0 = r0 * ldg;
        for (int e = tid; e < kDxRows * gcols / 4; e += blockDim.x) {
          const int64_t left = ng - (e0 + 4 * e);
          const int bytes = left >= 4 ? 16 : (left > 0 ? (int)left * 4 : 0);
          cp_async16(dst + 4 * e, bytes ? g + e0 + 4 * e : g, bytes);
        }
      } else {
        for (int e = tid; e < kDxRows * gcols; e += blockDim.x) {
          const int r = e / gcols;
          const bool ok = r0 + r < n;
          cp_async4(dst + e, ok ? g + (r0 + r) * ldg + (int64_t)s0 * m + (e - r * gcols) : g,
                    ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  // item i's W chunk (lane, chunk) into W stage i & 1; one commit group
  auto issue_w = [&](int i) {
    if (i < items) {
      const int rem = i % per_tile;
      const int l = rem / chunks;
      const int c = rem - l * chunks;
      const int pc = min(cpairs, pairs_all - c * cpairs);
      const uint4* src =
          wfrag + ((int64_t)(s0 + l) * pairs_all + (int64_t)c * cpairs) * kKS * 32;
      uint4* dst = wring + (i & 1) * wstage;
      for (int e = tid; e < pc * kKS * 32; e += blockDim.x) cp_async16(dst + e, src + e, 16);
    }
    cp_async_commit();
  };

  issue_g(0);
  issue_w(0);
  for (int i = 0; i < items; ++i) {
    // the next tile's g at a tile's first item, into the stage the tile
    // before read; the next item's W into the stage item i - 1 read
    const bool first = i % per_tile == 0;
    if (first) issue_g(i / per_tile + 1);
    issue_w(i + 1);
    if (first) {  // all but the groups just issued: this tile's g and item i's W
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    const int jt = i / per_tile;
    const int rem = i - jt * per_tile;
    const int l = rem / chunks;
    const int c = rem - l * chunks;
    const int pairs = min(cpairs, pairs_all - c * cpairs);
    const int c0w = c * cw;
    const float* gs = gring + (jt & 1) * gstage + l * m;  // lane l's columns, rows gcols apart
    const uint4* wf = wring + (i & 1) * wstage;
    const int64_t row = (blockIdx.x + (int64_t)jt * gridDim.x) * kDxRows + lr;
    const unsigned long long key = __ldg(ma.seed + s0 + l);
    const Mask mk{(uint32_t)key, (uint32_t)(key >> 32), ma.thr};
    __nv_bfloat16* dxl = dx + (int64_t)(s0 + l) * k;
    // A = g split into three bf16 terms: a[term][s][reg], term 0 = lo
    uint32_t a[3][kKS][4];
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int r = lr + 8 * (reg & 1);
        const int j = 16 * s + 2 * q + 8 * (reg >> 1);
        const float v0 = j < m ? gs[r * gcols + j] : 0.0f;
        const float v1 = j + 1 < m ? gs[r * gcols + j + 1] : 0.0f;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const float r0 = v0 - __low2float(hi);
        const float r1 = v1 - __high2float(hi);
        const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
        a[2][s][reg] = *reinterpret_cast<const uint32_t*>(&hi);
        a[1][s][reg] = *reinterpret_cast<const uint32_t*>(&mid);
        a[0][s][reg] = pack_bf16(r0 - __low2float(mid), r1 - __high2float(mid));
      }
    }
#pragma unroll 2  // two pairs' mma chains in flight
    for (int pr = quarter; pr < pairs; pr += 4) {
      float ca[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      uint4 b[kKS];
#pragma unroll
      for (int s = 0; s < kKS; ++s) b[s] = wf[(pr * kKS + s) * 32 + lane];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int s = 0; s < kKS; ++s) {
          mma_bf16(ca, a[t][s][0], a[t][s][1], a[t][s][2], a[t][s][3], b[s].x, b[s].y);
          mma_bf16(cb, a[t][s][0], a[t][s][1], a[t][s][2], a[t][s][3], b[s].z, b[s].w);
        }
      }
      const int col = c0w + 16 * pr + 4 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t orow = row + 8 * h;
        if (orow < n && col < k) {
          const int64_t bidx = orow * k + col;
          __nv_bfloat16* dst = dxl + orow * ldx + col;
          const unsigned bits = keep4<kAl4>(mk, bidx);
          const float v[4] = {(bits & 1u) ? ca[2 * h] * inv_keep : 0.0f,
                              (bits & 2u) ? ca[2 * h + 1] * inv_keep : 0.0f,
                              (bits & 4u) ? cb[2 * h] * inv_keep : 0.0f,
                              (bits & 8u) ? cb[2 * h + 1] * inv_keep : 0.0f};
          if (kAl4 && aligned4(dst)) {
            __stcs(reinterpret_cast<uint2*>(dst),
                   make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t)
              if (col + t < k) dst[t] = __float2bfloat16_rn(v[t]);
          }
        }
      }
    }
    __syncthreads();  // the stages item i read are free for the copies issued next
  }
  cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(kDxThreads)
dx_lanes_kernel(const float* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx,
                int64_t n, int k, int m, int lanes, MaskArgs ma, float inv_keep) {
  const int lane = blockIdx.y;
  dx_body<T>(g + (int64_t)lane * m, w + (int64_t)lane * k * m, dx + (int64_t)lane * k, n, k, m,
             (int64_t)lanes * m, (int64_t)lanes * k, lane_mask(ma, lane), inv_keep);
}

unsigned cdiv(int64_t a, int64_t b) { return (unsigned)((a + b - 1) / b); }

constexpr int kSplitRows = 64;  // a dW split's rows are a multiple of this

// inv_keep (already a bf16 value, so its top 16 bits) as a bf16x2 word
uint32_t bf16x2_of(float v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return (u >> 16) | (u & 0xFFFF0000u);
}

// The blocks of `kernel` (threads, dynamic shared bytes smem) that the
// current card holds at once: the SM count times the occupancy calculator's
// blocks an SM. The kernel's dynamic shared memory limit is raised once per
// card to what a block may opt in to beside its static shared memory.
// Answers are cached by (kernel, card, threads, smem): a launch costs no
// driver call beyond the launch itself.
template <typename K>
int resident_blocks(K kernel, int threads, int smem, int* blocks) {
  struct Entry {
    const void* fn;
    int dev, threads, smem, blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cache = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  bool raised = false;
  for (int i = 0; i < n_cache; ++i) {
    const Entry& e = cache[i];
    if (e.fn != fn || e.dev != dev) continue;
    raised = true;
    if (e.threads == threads && e.smem == smem) {
      *blocks = e.blocks;
      return 0;
    }
  }
  int sms = 0, per_sm = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && !raised) {  // all the opt-in memory beside the static
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)attr.sharedSizeBytes);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (n_cache < 64) cache[n_cache++] = Entry{fn, dev, threads, smem, *blocks};
  return 0;
}

// `kernel` over min(tiles, resident blocks) × `lanes` blocks.
template <typename K, typename... Args>
int launch_persistent(K kernel, int64_t tiles, unsigned lanes, int threads, int smem,
                      cudaStream_t s, Args... args) {
  int blocks = 0;
  const int rc = resident_blocks(kernel, threads, smem, &blocks);
  if (rc) return rc;
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  kernel<<<dim3(grid, lanes), threads, smem, s>>>(args...);
  return 0;
}

// la: the seed lanes' layout (null: one unlaned launch)
int fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, float* out, int64_t n, int k,
             int m, MaskArgs mk, float inv_keep, cudaStream_t s, const LaneArgs* la = nullptr,
             int lanes = 1) {
  const int np = (min(kNB, m) + 15) / 16;  // n-tile pairs of the widest W chunk
  const int kw_max = kWBytes / (np * 32) / kKC * kKC;
  const int kw = min(kw_max, (k + kKC - 1) / kKC * kKC);
  const int smem = kFwdWarps * kFwdStages * kFwdStageBytes + kw * np * 32;
  // 16-byte copies when every row of every lane starts 16-byte aligned
  const int vec = k % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                  (!la || (la->ldx % 8 == 0 && la->x_lane % 8 == 0));
  const int64_t tiles = (n + 16 * kFwdWarps - 1) / (16 * kFwdWarps);
  const uint32_t ik2 = bf16x2_of(inv_keep);
  const int threads = kFwdWarps * 32;
  if (la) {
    if (k % 4 == 0)
      return launch_persistent(fwd_mma_lanes_kernel<true>, tiles, lanes, threads, smem, s, x,
                               w, out, n, k, m, *la, kw_max, vec, mk, ik2);
    return launch_persistent(fwd_mma_lanes_kernel<false>, tiles, lanes, threads, smem, s, x, w,
                             out, n, k, m, *la, kw_max, vec, mk, ik2);
  }
  if (k % 4 == 0)
    return launch_persistent(fwd_mma_kernel<true>, tiles, 1, threads, smem, s, x, w, out, n, k,
                             m, kw_max, vec, mk, ik2);
  return launch_persistent(fwd_mma_kernel<false>, tiles, 1, threads, smem, s, x, w, out, n, k,
                           m, kw_max, vec, mk, ik2);
}

template <int kKS>
int dx_bf16(const float* g, const __nv_bfloat16* w, __nv_bfloat16* dx, int64_t n, int k,
            int m, MaskArgs mk, float inv_keep, cudaStream_t s) {
  const int cw_max = kWBytes / (kKS * 512) * 16;  // output columns a W chunk (a multiple of 16)
  const int cw = min(cw_max, (k + 15) / 16 * 16);
  const int smem = 2 * kDxRows * m * 4 + cw / 16 * kKS * 512;
  const int64_t tiles = (n + kDxRows - 1) / kDxRows;
  const int threads = kDxWarps * 32;
  if (k % 4 == 0)
    return launch_persistent(dx_mma_kernel<kKS, true>, tiles, 1, threads, smem, s, g, w, dx, n,
                             k, m, cw_max, mk, inv_keep);
  return launch_persistent(dx_mma_kernel<kKS, false>, tiles, 1, threads, smem, s, g, w, dx, n,
                           k, m, cw_max, mk, inv_keep);
}

// The laned bf16 dX (m <= 64): W's fragments into `wfrag` (lanes ×
// ceil(k/16) pairs × kKS × 512 bytes), then the persistent grid × lane
// groups, one block an SM. The group is every lane when their g's ring fits
// half the block's shared memory; W's 2-stage ring takes the rest.
template <int kKS>
int dx_bf16_lanes(const float* g, const __nv_bfloat16* w, void* wfrag, __nv_bfloat16* dx,
                  int64_t n, int k, int m, int lanes, MaskArgs mk, float inv_keep,
                  cudaStream_t s) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // one block an SM: g's 2-stage ring at most half of its shared memory, W's
  // 2-stage ring of column chunks the rest
  const int ring_lane = 2 * kDxRows * m * 4;
  const int group = max(1, min(lanes, optin / 2 / ring_lane));
  const int gbytes = group * ring_lane;
  const int pairs_all = (k + 15) / 16;
  const int cpairs = min(pairs_all, (optin - gbytes) / 2 / (kKS * 512));
  if (cpairs < 1) return (int)cudaErrorInvalidValue;
  const int smem = gbytes + 2 * cpairs * kKS * 512;
  const int64_t words_lane = (int64_t)pairs_all * kKS * 128;
  const unsigned wblocks = cdiv(words_lane * lanes, 256) < 1024u ? cdiv(words_lane * lanes, 256)
                                                                 : 1024u;
  dx_wfrag_kernel<<<wblocks, 256, 0, s>>>(w, static_cast<uint32_t*>(wfrag), k, m, kKS,
                                          words_lane, lanes);
  const int64_t tiles = (n + kDxRows - 1) / kDxRows;
  const unsigned groups = cdiv(lanes, group);
  const auto* wf = static_cast<const uint4*>(wfrag);
  if (k % 4 == 0)
    return launch_persistent(dx_mma_lanes_kernel<kKS, true>, tiles, groups, kDxLaneWarps * 32,
                             smem, s, g, wf, dx, n, k, m, lanes, group, cpairs * 16, mk, inv_keep);
  return launch_persistent(dx_mma_lanes_kernel<kKS, false>, tiles, groups, kDxLaneWarps * 32,
                           smem, s, g, wf, dx, n, k, m, lanes, group, cpairs * 16, mk, inv_keep);
}

// The f32 forward over a shared x: its column tile, the widest of 256,
// 128, 64 and 32 virtual columns whose lanes' planes (at most kTilePlanes)
// and block fit kGrpSmem and whose grid (tiles × column tiles) covers the
// card's SMs twice, else the narrowest that fits; its planes at most and
// shared bytes.
int fwd_col_tile(int lanes, int m, int64_t tiles, int* vt, int* pmax, int* smem) {
  const int mp = (m + 3) & ~3;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *vt = 0;
  for (int cand = 256; cand >= 32; cand /= 2) {
    const int p = min(lanes, (cand + mp - 1) / mp + 1);
    const int bytes = (p * kFmaChunk * kPlane + 2 * kPiece + 2 * kFmaChunk * cand) * 4;
    if (p > kTilePlanes || bytes > kGrpSmem) continue;
    *vt = cand;
    *pmax = p;
    *smem = bytes;
    if (tiles * cdiv((int64_t)lanes * mp, cand) >= 2 * (int64_t)sms) break;
  }
  return *vt ? 0 : (int)cudaErrorInvalidValue;
}

// Raise `kernel`'s dynamic shared memory limit to `smem` (once a size).
template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x and w alike. x: [n, k], w: [k, m],
// out: [n, m] f32, all contiguous. seed points to the uint64 seed in device
// memory. inv_keep is 1/keep rounded to x's dtype.
// Each entry point returns cudaGetLastError() after its launches.
extern "C" int pgcn_dropout_matmul_fwd(const void* x, const void* w, float* out,
                                       int dtype, int64_t n, int k, int m,
                                       const unsigned long long* seed, uint32_t thr,
                                       float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const MaskArgs mk{seed, thr};
  if (dtype == 0) {
    const dim3 grid(cdiv(n, kRows), cdiv(m, kTN));
    fwd_fma_kernel<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(x),
                                                static_cast<const float*>(w), out, n,
                                                k, m, mk, inv_keep);
  } else if (dtype == 1) {
    const int rc = fwd_bf16(static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(w), out, n, k, m, mk, inv_keep, s);
    if (rc) return rc;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The blocks of the dW kernel for x's dtype (and, for bf16, x-column slab
// width `slab`) that the card holds at once: the wrapper sizes the row
// splits from it.
extern "C" int pgcn_dropout_matmul_dw_blocks(int dtype, int slab, int* blocks) {
  if (dtype == 0) return resident_blocks(dw_fma_kernel, kFmaThreads, 0, blocks);
  if (dtype != 1 || slab % 64 || slab < 64 || slab > kDwMaxSlab)
    return (int)cudaErrorInvalidValue;
  return resident_blocks(dw_mma_kernel<true>, slab, dw_smem_bytes(slab), blocks);
}

// g: [n, m] f32; ws: [splits, k, m] f32 scratch; dw: [k, m] in x's dtype.
// Split i covers rows [i·rows_per_split, (i+1)·rows_per_split); rows_per_split
// is a multiple of 64 and splits the least count that covers n. bf16 blocks
// own `slab` columns of x (a multiple of 64, at most 320; f32 ignores it).
extern "C" int pgcn_dropout_matmul_dw(const void* x, const float* g, float* ws,
                                      void* dw, int dtype, int64_t n, int k, int m,
                                      int slab, int splits, int64_t rows_per_split,
                                      const unsigned long long* seed, uint32_t thr,
                                      float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0 || splits <= 0 || rows_per_split <= 0 ||
      rows_per_split % kSplitRows ||
      (int64_t)splits != (n + rows_per_split - 1) / rows_per_split)
    return (int)cudaErrorInvalidValue;
  const MaskArgs mk{seed, thr};
  const int64_t km = (int64_t)k * m;
  const unsigned rblocks = cdiv(km, 256) < 1024u ? cdiv(km, 256) : 1024u;
  if (dtype == 0) {
    const dim3 grid(cdiv(k, kRows), cdiv(m, kTN), (unsigned)splits);
    dw_fma_kernel<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(x), g, ws, n, k,
                                               m, rows_per_split, mk, inv_keep);
    reduce_splits_kernel<float><<<rblocks, 256, 0, s>>>(ws, splits, km,
                                                       static_cast<float*>(dw));
  } else if (dtype == 1) {
    if (slab % 64 || slab < 64 || slab > kDwMaxSlab) return (int)cudaErrorInvalidValue;
    const int smem = dw_smem_bytes(slab);
    const int vec = k % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
    const uint32_t ik2 = bf16x2_of(inv_keep);
    const dim3 grid(cdiv(k, slab), cdiv(m, kDwNB), (unsigned)splits);
    auto kernel = k % 4 == 0 ? dw_mma_kernel<true> : dw_mma_kernel<false>;
    int resident = 0;  // raises the kernel's shared memory limit, once
    const int rc = resident_blocks(kernel, slab, smem, &resident);
    if (rc) return rc;
    // g's rows as flat 16-byte runs when one column block covers them
    const int gflat = m <= kDwNB && (reinterpret_cast<uintptr_t>(g) & 15u) == 0;
    kernel<<<grid, slab, smem, s>>>(static_cast<const __nv_bfloat16*>(x), g, ws, n, k, m,
                                    slab, rows_per_split, vec, gflat, mk, ik2);
    reduce_splits_kernel<__nv_bfloat16><<<rblocks, 256, 0, s>>>(
        ws, splits, km, static_cast<__nv_bfloat16*>(dw));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g: [n, m] f32 (16-byte aligned for bf16); w: [k, m] in x's dtype; dx:
// [n, k] in x's dtype. inv_keep here is the f32 1/keep (not rounded to x's
// dtype). bf16 with m <= 64 takes the tensor-core kernel, the rest dx_kernel.
extern "C" int pgcn_dropout_matmul_dx(const float* g, const void* w, void* dx, int dtype,
                                      int64_t n, int k, int m,
                                      const unsigned long long* seed, uint32_t thr,
                                      float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const MaskArgs mk{seed, thr};
  if (dtype == 0) {
    dx_kernel<float><<<cdiv(n, kRows), kDxThreads, 0, s>>>(
        g, static_cast<const float*>(w), static_cast<float*>(dx), n, k, m, mk, inv_keep);
  } else if (dtype == 1 && m <= 64) {
    if (reinterpret_cast<uintptr_t>(g) & 15u) return (int)cudaErrorMisalignedAddress;
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* out = static_cast<__nv_bfloat16*>(dx);
    const int ks = (m + 15) / 16;
    const int rc = ks == 1   ? dx_bf16<1>(g, wb, out, n, k, m, mk, inv_keep, s)
                   : ks == 2 ? dx_bf16<2>(g, wb, out, n, k, m, mk, inv_keep, s)
                   : ks == 3 ? dx_bf16<3>(g, wb, out, n, k, m, mk, inv_keep, s)
                             : dx_bf16<4>(g, wb, out, n, k, m, mk, inv_keep, s);
    if (rc) return rc;
  } else if (dtype == 1) {
    dx_kernel<__nv_bfloat16><<<cdiv(n, kRows), kDxThreads, 0, s>>>(
        g, static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(dx), n, k,
        m, mk, inv_keep);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Seed lanes (the block comment above LaneArgs). x: joined [n, lanes·k]
// (x_lane = k, ldx = lanes·k) or shared [n, k] (x_lane = 0, ldx = k); w:
// [lanes, k, m] in x's dtype; out: [n, lanes·m] f32; seeds: lanes uint64 in
// device memory, lane s's the s-th.
extern "C" int pgcn_dropout_matmul_fwd_lanes(const void* x, const void* w, float* out,
                                             int dtype, int64_t n, int k, int m, int lanes,
                                             int64_t x_lane, int64_t ldx,
                                             const unsigned long long* seeds, uint32_t thr,
                                             float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0 || lanes <= 0 || lanes > 65535 || x_lane < 0 || ldx < k)
    return (int)cudaErrorInvalidValue;
  const MaskArgs mk{seeds, thr};
  if (dtype == 0 && x_lane == 0) {  // a tile across lanes, x's piece once a block
    const int64_t tiles = (n + kRows - 1) / kRows;
    int vt = 0, pmax = 0, smem = 0;
    int rc = fwd_col_tile(lanes, m, tiles, &vt, &pmax, &smem);
    if (rc) return rc;
    const dim3 grid((unsigned)tiles, cdiv((int64_t)lanes * ((m + 3) & ~3), vt));
    auto kernel = vt >= 256   ? fwd_fma_shared_kernel<4>
                  : vt == 128 ? fwd_fma_shared_kernel<2>
                              : fwd_fma_shared_kernel<1>;
    rc = allow_smem(kernel, smem);
    if (rc) return rc;
    kernel<<<grid, kGrpThreads, smem, s>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w), out, n, k, m, lanes, vt,
                                           pmax, mk, inv_keep);
  } else if (dtype == 0) {  // one lane a block
    const LaneArgs la{x_lane, ldx, (int64_t)lanes * m};
    const dim3 grid(cdiv(n, kRows), cdiv(m, kTN), (unsigned)lanes);
    fwd_fma_lanes_kernel<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(x),
                                                      static_cast<const float*>(w), out, n, k,
                                                      m, la, mk, inv_keep);
  } else if (dtype == 1) {
    const LaneArgs la{x_lane, ldx, (int64_t)lanes * m};
    const int rc = fwd_bf16(static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(w), out, n, k, m, mk, inv_keep, s,
                            &la, lanes);
    if (rc) return rc;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g: joined [n, lanes·m] f32, read in place; ws: [lanes, splits, k, m] f32
// scratch; dw: [lanes, k, m] in x's dtype. slab, splits and rows_per_split
// are the unlaned launch's for one lane's [n, k] x.
extern "C" int pgcn_dropout_matmul_dw_lanes(const void* x, const float* g, float* ws, void* dw,
                                            int dtype, int64_t n, int k, int m, int lanes,
                                            int64_t x_lane, int64_t ldx, int slab, int splits,
                                            int64_t rows_per_split,
                                            const unsigned long long* seeds, uint32_t thr,
                                            float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0 || lanes <= 0 || x_lane < 0 || ldx < k || splits <= 0 ||
      (int64_t)splits * lanes > 65535 || rows_per_split <= 0 || rows_per_split % kSplitRows ||
      (int64_t)splits != (n + rows_per_split - 1) / rows_per_split)
    return (int)cudaErrorInvalidValue;
  const MaskArgs mk{seeds, thr};
  const int64_t km = (int64_t)k * m;
  const unsigned rblocks = cdiv(km * lanes, 256) < 1024u ? cdiv(km * lanes, 256) : 1024u;
  if (dtype == 0) {
    const dim3 grid(cdiv(k, kRows), cdiv(m, kTN), (unsigned)(splits * lanes));
    dw_fma_lanes_kernel<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(x), g, ws, n, k,
                                                     m, lanes, x_lane, ldx, rows_per_split,
                                                     splits, mk, inv_keep);
    reduce_splits_lanes_kernel<float><<<rblocks, 256, 0, s>>>(ws, splits, km, lanes,
                                                             static_cast<float*>(dw));
  } else if (dtype == 1) {
    if (slab % 64 || slab < 64 || slab > kDwMaxSlab) return (int)cudaErrorInvalidValue;
    const int smem = dw_smem_bytes(slab);
    const int vec = k % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                    ldx % 8 == 0 && x_lane % 8 == 0;
    const uint32_t ik2 = bf16x2_of(inv_keep);
    const dim3 grid(cdiv(k, slab), cdiv(m, kDwNB), (unsigned)(splits * lanes));
    auto kernel = k % 4 == 0 ? dw_mma_lanes_kernel<true> : dw_mma_lanes_kernel<false>;
    int resident = 0;  // raises the kernel's shared memory limit, once
    const int rc = resident_blocks(kernel, slab, smem, &resident);
    if (rc) return rc;
    kernel<<<grid, slab, smem, s>>>(static_cast<const __nv_bfloat16*>(x), g, ws, n, k, m,
                                    lanes, x_lane, ldx, slab, rows_per_split, splits, vec, mk,
                                    ik2);
    reduce_splits_lanes_kernel<__nv_bfloat16><<<rblocks, 256, 0, s>>>(
        ws, splits, km, lanes, static_cast<__nv_bfloat16*>(dw));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g: joined [n, lanes·m] f32 (16-byte aligned for bf16), read in place; w:
// [lanes, k, m] in x's dtype; dx: joined [n, lanes·k] in x's dtype; wfrag:
// bf16 with m <= 64, lanes·ceil(k/16)·ceil(m/16)·512 bytes of scratch for
// W's fragments (else unread). inv_keep is the f32 1/keep.
extern "C" int pgcn_dropout_matmul_dx_lanes(const float* g, const void* w, void* wfrag,
                                            void* dx, int dtype, int64_t n, int k, int m,
                                            int lanes, const unsigned long long* seeds,
                                            uint32_t thr, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || m <= 0 || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const MaskArgs mk{seeds, thr};
  const dim3 grid(cdiv(n, kRows), (unsigned)lanes);
  if (dtype == 0) {
    dx_lanes_kernel<float><<<grid, kDxThreads, 0, s>>>(
        g, static_cast<const float*>(w), static_cast<float*>(dx), n, k, m, lanes, mk, inv_keep);
  } else if (dtype == 1 && m <= 64) {
    if ((reinterpret_cast<uintptr_t>(g) & 15u) || (reinterpret_cast<uintptr_t>(wfrag) & 15u))
      return (int)cudaErrorMisalignedAddress;
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* out = static_cast<__nv_bfloat16*>(dx);
    const int ks = (m + 15) / 16;
    const int rc =
        ks == 1   ? dx_bf16_lanes<1>(g, wb, wfrag, out, n, k, m, lanes, mk, inv_keep, s)
        : ks == 2 ? dx_bf16_lanes<2>(g, wb, wfrag, out, n, k, m, lanes, mk, inv_keep, s)
        : ks == 3 ? dx_bf16_lanes<3>(g, wb, wfrag, out, n, k, m, lanes, mk, inv_keep, s)
                  : dx_bf16_lanes<4>(g, wb, wfrag, out, n, k, m, lanes, mk, inv_keep, s);
    if (rc) return rc;
  } else if (dtype == 1) {
    dx_lanes_kernel<__nv_bfloat16><<<grid, kDxThreads, 0, s>>>(
        g, static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(dx), n, k, m,
        lanes, mk, inv_keep);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
