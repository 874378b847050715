// Flash attention backward for Hopper (sm_90a), mma.sync route: f32, and
// bf16 at head dims the wgmma kernels do not take.
//
// Replaces the three backward TPU kernels of
// paddle_tpu/ops/flash_attention.py (launched by _bwd):
//   flash_attention_bwd_dq          <- _bwd_dq_kernel           (row 3)
//   flash_attention_bwd_dkv         <- _bwd_dkv_kernel          (row 4)
//   flash_attention_bwd_single_tile <- _bwd_single_tile_kernel  (row 2)
// Same function: with the forward's natural-log LSE and
// delta = rowsum(dO * O) (computed by the caller, f32, or given by it),
//   P  = exp2(q k^T * scale * log2 e - lse * log2 e)   (no online softmax)
//   dS = P * (dO v^T - delta) * scale
//   dQ = dS k,  dK = dS^T q,  dV = P^T dO,
// causal positions k > q masked to P = 0 exactly (a select, never
// exp2 of -inf - -inf). Inputs q/k/v/dO f32 or bf16, LSE and delta f32,
// f32 accumulation; dQ/dK/dV written in the input dtype or in f32 (the
// out_dtype override ring attention reads). The reference casts P and dS
// to the input dtype before its bf16 products; these kernels keep them in
// f32 (the chip check compares against the plain version on
// f32-upcast inputs).
//
// Layout: every tensor keeps the public [B, S, H, D] layout and rows
// (b, s, h, :) are read with strides, as the forward kernel does; LSE and
// delta are [B*H, S]. The reference's [B*H, S, D] transpose is never made.
//
// What bounds them on the H100: operations. dQ does 6, dK/dV 8 and the
// merged kernel 10 * B*H*Sq*Sk*D flops (halved when causal): 67 TFLOP/s
// as f32 FMAs outside the tensor cores, or 165 TFLOP/s effective as
// 3xTF32 on them (495 TFLOP/s TF32, three products each). Their bytes (q,
// k, v, dO once, the gradients once) are far below either line at S 2048.
//
// Numerics: every f32 product runs on the tensor cores as 3xTF32,
// whatever torch.backends.cuda.matmul.allow_tf32 says. An f32 operand x is
// split at fragment load into hi = x rounded to TF32 (to nearest, ties
// away: cvt.rna's rounding) and lo = x - hi, which the tensor core
// truncates to TF32; x*y is summed as lo*hi + hi*lo + hi*hi (small
// products first, as CUTLASS's fast-f32 path does), each TF32 product
// exact in the f32 accumulator. What is dropped (lo*lo, and the bits of
// lo below TF32) is a few 2^-22 of |x y| per product against 2^-24 for
// one f32 FMA rounding: far inside BWD_F32_TOL (3e-5) over 2048 keys. One
// TF32 product alone (2^-11) is not. tests/test_torch_flash_backward.py
// emulates both on the CPU: the split alone, and with this file's
// accumulation order under a model of the tensor cores' truncation
// (published for earlier NVIDIA parts, not measured on this one;
// chip_smoke.py holds the kernels themselves). The TPU kernel's own f32
// products were reduced-precision MXU passes (Precision.DEFAULT). The
// tensor core truncates each accumulation, so a long-lived accumulator
// (dQ, dK, dV) takes each tile's product as a sum from zero and one f32
// add. bf16 operands are exact: with bf16 inputs S and dP run on the
// bf16 mma (m16n8k16, the same exact products), and the gradient
// products take two TF32 products (P and dS are f32, made here).
//
// What the design does about the bound:
//  * Products: mma.sync.m16n8k8 (f32 += tf32 x tf32), one warp owning 16
//    rows of the resident side. wgmma's tf32 form takes K-major operands
//    in shared memory only, so dV = P^T dO and dK = dS^T q would need
//    transposed copies of dO and q; mma.sync reads them as they lie.
//  * Splitting costs more issue slots than the products: cvt.rna.tf32
//    compiles to a sequence that also tests for NaN, so hi is rounded
//    with two integer operations, lo is left for the tensor core to
//    truncate, P and dS are split once a tile, the small products of the
//    gradient products get an accumulator of their own, and the
//    row-major fragments (A, and B over the head dim) arrive by ldmatrix,
//    four registers an instruction.
//  * No shuffle or shared stage between the two products of a tile: the
//    m16n8 accumulator gives a thread columns 2t, 2t+1 of each 8-column
//    block, and the m16n8k8 A fragment wants k = t, t+4. A sum over k does
//    not care about the order of its terms, so logical k = t is read as
//    key 2t and k = t + 4 as key 2t + 1 in both operands: P and dS go from
//    their accumulators straight into the next product's A fragment, and
//    the B operand reads rows 2t and 2t + 1.
//  * Shared tiles are row-major with a row pitch of pad16(D) + one
//    16-byte chunk (4 mod 8 words for f32, 8 mod 16 elements for bf16):
//    the ldmatrix rows, and the element reads [2t][g] (B over the keys or
//    queries), hit 32 distinct banks.
//  * dQ: one block of 8 warps per (b*h, 128 queries) (64 queries of 4
//    warps above D 128); q and dO resident, K/V tiles of 32 keys (16
//    above D 128) through a 2-stage cp.async ring (16-byte copies), one
//    barrier a tile. The causal loop stops at the diagonal tile, a warp
//    whose rows see none of a tile's keys skips it, and q tiles run
//    heaviest first.
//  * dK/dV: one block of 8 warps per (b*h, 128 keys) (64 keys of 4 warps
//    above D 128); K and V resident, q/dO/lse/delta tiles through the
//    ring, from the diagonal on. The dK and dV accumulators (2 x 16 rows x
//    D a warp) take 128 registers at D 128: above that the block makes
//    passes over parts of the head dim (launch_dkv_d).
//  * Merged (single tile): one block holds no 1024 x 1024 tile, so the
//    merged kernel is the dK/dV kernel that also stages each tile's dS^T
//    in shared memory and adds dS k (the same mma) into an f32 dQ scratch
//    with atomicAdd: P and dS are computed once. The last block of each
//    (b*h) to finish (a ticket counter, after a __threadfence) converts
//    that head's scratch to the output dtype, so one launch does all.
//    With an f32 output the scratch is the output.
//  * Ragged lengths (S = 1000 is one reference tile): rows past S load as
//    zero, their P is masked to 0 and they are never written.
// Not yet: wgmma (transposed operand copies), operands split once a block
// (their hi and lo halves would not fit beside the tiles at D 128 f32), a
// separate pass for the merged kernel's atomics.
#include <cstdint>
#include <type_traits>

#include "attention_simt.cuh"

using namespace ptt;
using namespace ptt::simt;

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------
// A (16 x 8) fragment of an f32 operand, split into hi and lo; B (8 x 8)
// fragment, split when LO (f32) and hi alone for a bf16 value (exact in
// TF32)
struct FragA {
  uint32_t hi[4], lo[4];
};
template <bool LO>
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi = x rounded to TF32 (half a TF32 ulp added, the 13 low bits cleared:
// cvt.rna's rounding of finite values, in two integer operations); lo =
// x - hi (exact), passed as it is: the tensor core reads the top 19 bits
// of a tf32 operand, so lo is truncated to TF32, as in CUTLASS's fast-f32
// path. A NaN x keeps lo NaN.
template <bool LO>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (LO) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);  // a bf16 value: already a TF32 value
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 inputs: S and dP on mma.sync.m16n8k16 (f32 += bf16 x bf16), the
// same exact products a TF32 product of bf16 values gives, half the
// instructions
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: lo*hi and hi*lo into the accumulator before hi*hi
template <bool BLO>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB<BLO>& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  if constexpr (BLO) mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// four 8 x 16-byte blocks of shared memory, one register each: lane l
// gives the address of row l % 8 of block l / 8 and receives 32-bit word
// l % 4 of row l / 4 of every block
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ FragA split_a(const float (&x)[4]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split<true>(x[i], f.hi[i], f.lo[i]);
  return f;
}

// Fragment reads from row-major shared tiles; lane = 4 g + t.
// f32 A over the head dim: rows g, g + 8, columns t, t + 4 of s, the four
// 8 x 4 blocks by one ldmatrix.
__device__ __forceinline__ FragA lda_rows(const float* s, int ld, int lane) {
  const int m = lane >> 3, i = lane & 7;
  uint32_t r[4];
  ldsm_x4(r, s + (i + 8 * (m & 1)) * ld + 4 * (m >> 1));
  const float x[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]),
                      __uint_as_float(r[2]), __uint_as_float(r[3])};
  return split_a(x);
}
// f32 B over the head dim for two n-blocks (k = column, n = row of s):
// rows g and 8 + g, columns t, t + 4, by one ldmatrix
__device__ __forceinline__ void ldb_rows2(FragB<true> (&f)[2], const float* s,
                                          int ld, int lane) {
  const int m = lane >> 3, i = lane & 7;
  uint32_t r[4];
  ldsm_x4(r, s + (i + 8 * (m >> 1)) * ld + 4 * (m & 1));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    split<true>(__uint_as_float(r[2 * h]), f[h].hi[0], f[h].lo[0]);
    split<true>(__uint_as_float(r[2 * h + 1]), f[h].hi[1], f[h].lo[1]);
  }
}
// B over 8 rows of s (keys or queries; n = column): logical k = t, t + 4
// read rows 2t, 2t + 1 (the permutation of the file note)
template <typename T>
__device__ __forceinline__ FragB<std::is_same<T, float>::value> ldb_cols(
    const T* s, int ld, int lane) {
  constexpr bool LO = std::is_same<T, float>::value;
  const int g = lane >> 2, t = lane & 3;
  FragB<LO> f;
  split<LO>(to_f32(s[2 * t * ld + g]), f.hi[0], f.lo[0]);
  split<LO>(to_f32(s[(2 * t + 1) * ld + g]), f.hi[1], f.lo[1]);
  return f;
}
// A whose k runs over the rows of s (rows = k, columns = A's rows), with
// the same permutation: s[2t][g], s[2t][g + 8], s[2t + 1][g], s[2t + 1][g + 8]
__device__ __forceinline__ FragA lda_cols(const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float x[4] = {s[2 * t * ld + g], s[2 * t * ld + g + 8],
                      s[(2 * t + 1) * ld + g], s[(2 * t + 1) * ld + g + 8]};
  return split_a(x);
}
// A from an m16n8 accumulator (rows g, g + 8; columns 2t, 2t + 1) under
// the permutation: no data moves between lanes
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split_a(x);
}

// 4 bytes by cp.async, zero-filled when `ok` is false
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void store_out(void* base, long i, float x,
                                          int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(base)[i] = x;
}

// element e of an m16n8 accumulator: row g + 8 (e >> 1), column 2t + (e & 1)
__device__ __forceinline__ int acc_row(int g, int e) {
  return g + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int t, int e) { return 2 * t + (e & 1); }

// S (or S^T) and dP (or dP^T) of one tile: s[n] += a_s b_s[n], p[n] +=
// a_p b_p[n] over the head dim, a from the warp's 16 rows of the resident
// tiles (sa_s, sa_p), b from 8 NB rows of the streamed ones (sb_s, sb_p).
// UNROLL2: two head-dim steps in flight (more registers).
template <int NB, bool UNROLL2, typename T>
__device__ __forceinline__ void scores(float (&s)[NB][4], float (&p)[NB][4],
                                       const T* sa_s, const T* sa_p,
                                       const T* sb_s, const T* sb_p, int ld,
                                       int dp, int lane) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = p[n][e] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    auto step = [&](int kk) {
      const FragA as = lda_rows(sa_s + kk, ld, lane);
      const FragA ap = lda_rows(sa_p + kk, ld, lane);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        FragB<true> bs[2], bp[2];
        ldb_rows2(bs, sb_s + n * 8 * ld + kk, ld, lane);
        ldb_rows2(bp, sb_p + n * 8 * ld + kk, ld, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma3(s[n + h], as, bs[h]);
          mma3(p[n + h], ap, bp[h]);
        }
      }
    };
    if constexpr (UNROLL2) {
#pragma unroll 2
      for (int kk = 0; kk < dp; kk += 8) step(kk);
    } else {
#pragma unroll 1
      for (int kk = 0; kk < dp; kk += 8) step(kk);
    }
  } else {
    // bf16: 16 head-dim values a step; the same ldmatrix blocks hold
    // eight bf16 a row
    const int m = lane >> 3, i = lane & 7;
    const int a_off = (i + 8 * (m & 1)) * ld + 8 * (m >> 1);
    const int b_off = (i + 8 * (m >> 1)) * ld + 8 * (m & 1);
#pragma unroll 2
    for (int kk = 0; kk < dp; kk += 16) {
      uint32_t as[4], ap[4];
      ldsm_x4(as, sa_s + a_off + kk);
      ldsm_x4(ap, sa_p + a_off + kk);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bs[4], bp[4];
        ldsm_x4(bs, sb_s + n * 8 * ld + b_off + kk);
        ldsm_x4(bp, sb_p + n * 8 * ld + b_off + kk);
        mma_bf16(s[n], as, bs[0], bs[1]);
        mma_bf16(s[n + 1], as, bs[2], bs[3]);
        mma_bf16(p[n], ap, bp[0], bp[1]);
        mma_bf16(p[n + 1], ap, bp[2], bp[3]);
      }
    }
  }
}

// acc[j] += x y over columns c0 + 8 j (< dp) of a streamed tile: x the
// warp's 16 x 8 NB operand (P, or dS, made in registers and split once a
// tile), y the tile's 8 NB rows of ld-pitched shared memory. The tensor
// cores truncate each accumulation (toward zero), which over the 3 S / 8
// products into one long-lived accumulator biases dK and dV beyond the
// f32 tolerance at S 2048; so this tile's sum starts from 0, JB column
// blocks at a time, and joins the accumulator in one f32 add. With an f32
// y (BLO) the small products go to an accumulator of their own: twice the
// independent mma chains. Only whole groups of JB column blocks are
// skipped past the head dim: a test between single mma groups kept the
// compiler from interleaving them. A block of a group past dp reads
// column dp - 8 instead, and its sums are never stored.
template <int JB, int NB, int NDH, typename T>
__device__ __forceinline__ void tile_product(float (&acc)[NDH][4],
                                             const FragA (&x)[NB], const T* y,
                                             int ld, int c0, int dp,
                                             int lane) {
  constexpr bool BLO = std::is_same<T, float>::value;
#pragma unroll
  for (int j0 = 0; j0 < NDH; j0 += JB) {
    if (c0 + 8 * j0 >= dp) break;
    float big[JB][4], small[JB][4];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[jj][e] = small[jj][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int col = min(c0 + 8 * (j0 + jj), dp - 8);
        const FragB<BLO> b = ldb_cols(y + n * 8 * ld + col, ld, lane);
        if constexpr (BLO) {
          mma_tf32(small[jj], x[n].lo, b.hi[0], b.hi[1]);
          mma_tf32(small[jj], x[n].hi, b.lo[0], b.lo[1]);
          mma_tf32(big[jj], x[n].hi, b.hi[0], b.hi[1]);
        } else {
          mma3(big[jj], x[n], b);
        }
      }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j0 + jj][e] += BLO ? small[jj][e] + big[jj][e] : big[jj][e];
  }
}

// ---------------------------------------------------------------------------
// dQ (row 3): block (b*h, q tile of BQ = 16 NW queries), key tiles of BK
// through the ring; NDH head-dim column blocks of 8 per accumulator
// ---------------------------------------------------------------------------
template <typename T, int NW, int BK, int NDH, int JB>
__global__ void __launch_bounds__(NW * 32, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dq,
                    int Sq, int Sk, int H, int D, int causal, float scale,
                    float scale_log2, int out_bf16, int vec) {
  constexpr int BQ = 16 * NW, NB = BK / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int dp = pad16(D), ld = dp + kChunk<T>;
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][ld]
  T* sDO = sQ + BQ * ld;                   // [BQ][ld]
  T* sK = sDO + BQ * ld;                   // [2][BK][ld]
  T* sV = sK + 2 * BK * ld;                // [2][BK][ld]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const long rs = (long)H * D;  // one sequence position
  const T* qb = q + (long)b * Sq * rs + (long)h * D;
  const T* ob = dout + (long)b * Sq * rs + (long)h * D;
  const T* kb = k + (long)b * Sk * rs + (long)h * D;
  const T* vb = v + (long)b * Sk * rs + (long)h * D;

  for (int r = warp; r < BQ; r += NW) {
    const bool ok = q0 + r < Sq;
    const long off = ok ? (q0 + r) * rs : 0;
    copy_row(sQ + r * ld, qb + off, D, dp, ok, vec, lane);
    copy_row(sDO + r * ld, ob + off, D, dp, ok, vec, lane);
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    lse2[i] = qi < Sq ? lse[(long)bh * Sq + qi] * kLog2e : 0.f;
    dl[i] = qi < Sq ? delta[(long)bh * Sq + qi] : 0.f;
  }

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    for (int r = warp; r < BK; r += NW) {
      const bool ok = k0 + r < Sk;
      const long off = ok ? (k0 + r) * rs : 0;
      copy_row(sK + (stage * BK + r) * ld, kb + off, D, dp, ok, vec, lane);
      copy_row(sV + (stage * BK + r) * ld, vb + off, D, dp, ok, vec, lane);
    }
  };

  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);
  const bool rows_live = q0 + r0 < Sq;
  for (int c0 = 0; c0 < dp; c0 += 8 * NDH) {
    float acc[NDH][4];
#pragma unroll
    for (int j = 0; j < NDH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    __syncthreads();  // the previous pass is done with the ring
    load_kv(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nkt; ++kt) {
      cp_async_wait<0>();
      // tile kt (and q, dO) landed for every thread, and every thread is
      // done with tile kt - 1, whose stage the next copy refills
      __syncthreads();
      if (kt + 1 < nkt) {
        load_kv(kt + 1, (kt + 1) & 1);
        cp_async_commit();
      }
      const int k0 = kt * BK;
      // the warp's 16 rows see none of this tile's keys
      if (!rows_live || (causal && k0 > q0 + r0 + 15)) continue;
      const T* cK = sK + (kt & 1) * BK * ld;
      const T* cV = sV + (kt & 1) * BK * ld;
      float s[NB][4], dpv[NB][4];
      scores<NB, true>(s, dpv, sQ + r0 * ld, sDO + r0 * ld, cK, cV, ld, dp,
                       lane);
      // P and dS in place of S
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, qi = q0 + r0 + acc_row(g, e);
          const int kj = k0 + n * 8 + acc_col(t, e);
          const bool live = qi < Sq && kj < Sk && !(causal && kj > qi);
          const float p = live ? exp2f(s[n][e] * scale_log2 - lse2[i]) : 0.f;
          s[n][e] = p * (dpv[n][e] - dl[i]) * scale;
        }
      // dQ[:, c0 .. c0 + 8 NDH) += dS k
      FragA ads[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) ads[n] = a_from_acc(s[n]);
      tile_product<JB, NB, NDH>(acc, ads, cK, ld, c0, dp, lane);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + r0 + acc_row(g, e);
      if (qi >= Sq) continue;
      const long row = (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int j = 0; j < NDH; ++j) {
        const int d = c0 + 8 * j + acc_col(t, e);
        if (d < D) store_out(dq, row + d, acc[j][e], out_bf16);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV (row 4), and with DQ the merged single-tile kernel (row 2):
// block (b*h, key tile of BK = 16 NW keys), query tiles of BQ through the
// ring; NDH head-dim column blocks of 8 per accumulator pass, NDMAX those
// of the largest head dim of the instantiation (the merged dQ partial)
// ---------------------------------------------------------------------------
template <typename T, int NW, int BQ, int NDH, int NDMAX, int JB, bool DQ>
__global__ void __launch_bounds__(NW * 32, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, void* __restrict__ dk,
                     void* __restrict__ dv, float* __restrict__ dq_acc,
                     int* __restrict__ tickets, void* __restrict__ dq,
                     int Sq, int Sk, int H, int D, int causal, float scale,
                     float scale_log2, int out_bf16, int vec) {
  constexpr int BK = 16 * NW, NB = BQ / 8, LDS = BQ + 4;
  // the merged dQ partial [BQ x D]: MB row blocks of 16, WC warps a row
  // block, NDQ column blocks of 8 a warp
  constexpr int MB = BQ / 16, WC = NW / MB, NDQ = NDMAX / WC;
  static_assert(NW % MB == 0 && NDMAX % WC == 0, "dQ partial split");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int s_last;
  const int dp = pad16(D), ld = dp + kChunk<T>;
  T* sK = reinterpret_cast<T*>(smem_raw);  // [BK][ld]
  T* sV = sK + BK * ld;                    // [BK][ld]
  T* sQ = sV + BK * ld;                    // [2][BQ][ld]
  T* sDO = sQ + 2 * BQ * ld;               // [2][BQ][ld]
  float* sL = reinterpret_cast<float*>(sDO + 2 * BQ * ld);  // [2][BQ] lse
  float* sDl = sL + 2 * BQ;                                 // [2][BQ] delta
  float* sDS = sDl + 2 * BQ;  // [BK][LDS] dS^T (merged kernel only)

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, kr0 = warp * 16;
  const long rs = (long)H * D;
  const T* qb = q + (long)b * Sq * rs + (long)h * D;
  const T* ob = dout + (long)b * Sq * rs + (long)h * D;
  const T* kb = k + (long)b * Sk * rs + (long)h * D;
  const T* vb = v + (long)b * Sk * rs + (long)h * D;
  const float* lb = lse + (long)bh * Sq;
  const float* db = delta + (long)bh * Sq;

  for (int r = warp; r < BK; r += NW) {
    const bool ok = k0 + r < Sk;
    const long off = ok ? (k0 + r) * rs : 0;
    copy_row(sK + r * ld, kb + off, D, dp, ok, vec, lane);
    copy_row(sV + r * ld, vb + off, D, dp, ok, vec, lane);
  }

  const int nqt = (Sq + BQ - 1) / BQ, qt0 = causal ? k0 / BQ : 0;
  auto load_q = [&](int qt, int stage) {
    const int qs = qt * BQ;
    for (int r = warp; r < BQ; r += NW) {
      const bool ok = qs + r < Sq;
      const long off = ok ? (qs + r) * rs : 0;
      copy_row(sQ + (stage * BQ + r) * ld, qb + off, D, dp, ok, vec, lane);
      copy_row(sDO + (stage * BQ + r) * ld, ob + off, D, dp, ok, vec, lane);
    }
    for (int i = tid; i < BQ; i += NW * 32) {
      const bool ok = qs + i < Sq;
      cp_async4(sL + stage * BQ + i, lb + (ok ? qs + i : 0), ok);
      cp_async4(sDl + stage * BQ + i, db + (ok ? qs + i : 0), ok);
    }
  };

  const bool rows_live = k0 + kr0 < Sk;
  for (int c0 = 0; c0 < dp; c0 += 8 * NDH) {
    float dka[NDH][4], dva[NDH][4];
#pragma unroll
    for (int j = 0; j < NDH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
    __syncthreads();  // the previous pass is done with the ring
    if (qt0 < nqt) load_q(qt0, 0);
    cp_async_commit();
    for (int qt = qt0; qt < nqt; ++qt) {
      const int st = (qt - qt0) & 1;
      cp_async_wait<0>();
      // tile qt (and K, V) landed for every thread, and every thread is
      // done with tile qt - 1 (its ring stage and, merged, sDS)
      __syncthreads();
      if (qt + 1 < nqt) {
        load_q(qt + 1, st ^ 1);
        cp_async_commit();
      }
      const int qs = qt * BQ;
      const T* cQ = sQ + st * BQ * ld;
      const T* cO = sDO + st * BQ * ld;
      const float* cL = sL + st * BQ;
      const float* cD = sDl + st * BQ;
      // the warp's 16 keys see none of this tile's queries
      const bool live_w = rows_live && !(causal && qs + BQ - 1 < k0 + kr0);
      float sT[NB][4] = {}, dpT[NB][4] = {};
      if (live_w)
        scores<NB, false>(sT, dpT, sK + kr0 * ld, sV + kr0 * ld, cQ, cO, ld,
                          dp, lane);
      // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + acc_col(t, e), qc = qs + col;
          const int kr = k0 + kr0 + acc_row(g, e);
          const bool live =
              live_w && qc < Sq && kr < Sk && !(causal && kr > qc);
          const float p = live ? exp2f(sT[n][e] * scale_log2 -
                                       cL[col] * kLog2e)
                               : 0.f;
          sT[n][e] = p;
          dpT[n][e] = p * (dpT[n][e] - cD[col]) * scale;
        }
      if constexpr (DQ) {
        // the merged kernel stages dS^T in shared memory for its dQ
        // partial; the dK product below reads this thread's own elements
        // back, so dS leaves the registers before the dV product
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sDS[(kr0 + acc_row(g, e)) * LDS + n * 8 + acc_col(t, e)] =
                dpT[n][e];
      }
      if (live_w) {
        // dV += P^T dO, then dK += dS^T q, over columns c0 .. c0 + 8 NDH;
        // P and dS split once a tile
        FragA ax[NB];
#pragma unroll
        for (int n = 0; n < NB; ++n) ax[n] = a_from_acc(sT[n]);
        tile_product<JB, NB, NDH>(dva, ax, cO, ld, c0, dp, lane);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if constexpr (DQ) {
            float c[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c[e] = sDS[(kr0 + acc_row(g, e)) * LDS + n * 8 + acc_col(t, e)];
            ax[n] = a_from_acc(c);
          } else {
            ax[n] = a_from_acc(dpT[n]);
          }
        }
        tile_product<JB, NB, NDH>(dka, ax, cQ, ld, c0, dp, lane);
      }
      if constexpr (DQ) {
        if (c0 == 0) {
          // this tile's dS k over the block's keys, added into the f32
          // dQ scratch: [BQ x D] by all warps from the staged dS^T
          __syncthreads();
          const int mb = warp % MB, cb = (warp / MB) * NDQ;
          float part[NDQ][4];
#pragma unroll
          for (int j = 0; j < NDQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
          const int nkc = (min(BK, Sk - k0) + 7) / 8;
          for (int kc = 0; kc < nkc; ++kc) {
            const FragA a = lda_cols(sDS + kc * 8 * LDS + mb * 16, LDS, lane);
            // a column block past dp reads column dp - 8; never stored
#pragma unroll
            for (int j = 0; j < NDQ; ++j)
              mma3(part[j], a,
                   ldb_cols(sK + kc * 8 * ld + min((cb + j) * 8, dp - 8), ld,
                            lane));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qs + mb * 16 + acc_row(g, e);
            if (qi >= Sq) continue;
            const long base = (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
            for (int j = 0; j < NDQ; ++j) {
              const int d = (cb + j) * 8 + acc_col(t, e);
              if (d < D) atomicAdd(dq_acc + base + d, part[j][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = k0 + kr0 + acc_row(g, e);
      if (kr >= Sk) continue;
      const long row = (((long)b * Sk + kr) * H + h) * D;
#pragma unroll
      for (int j = 0; j < NDH; ++j) {
        const int d = c0 + 8 * j + acc_col(t, e);
        if (d < D) {
          store_out(dk, row + d, dka[j][e], out_bf16);
          store_out(dv, row + d, dva[j][e], out_bf16);
        }
      }
    }
  }

  if (DQ && dq != nullptr) {
    // the last block of this (b*h) converts the head's dQ scratch
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(tickets + bh, 1) == (int)gridDim.y - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (int idx = tid; idx < Sq * D; idx += NW * 32) {
        const int s = idx / D, d = idx - s * D;
        const long off = (((long)b * Sq + s) * H + h) * D + d;
        store_out(dq, off, __ldcg(dq_acc + off), out_bf16);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float* dq_acc;
  int* tickets;
  int B, Sq, Sk, H, D, causal, out_bf16;
  float scale;
  cudaStream_t st;
};

// 16-byte staging copies need D to fill whole chunks and 16-byte aligned
// q/k/v/dO (every row then starts aligned)
template <typename T>
int vec_ok(const Args& a) {
  const uintptr_t any = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                        (uintptr_t)a.dout;
  return a.D % kChunk<T> == 0 && any % 16 == 0;
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NW, int BK, int NDH, int JB>
cudaError_t launch_dq(const Args& a) {
  constexpr int BQ = 16 * NW;
  const size_t smem =
      sizeof(T) * (size_t)(2 * BQ + 4 * BK) * (pad16(a.D) + kChunk<T>);
  auto kern = flash_bwd_dq_kernel<T, NW, BK, NDH, JB>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, NW * 32, smem, a.st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, a.dq, a.Sq, a.Sk, a.H, a.D, a.causal, a.scale,
      a.scale * kLog2e, a.out_bf16, vec_ok<T>(a));
  return cudaGetLastError();
}

template <typename T, int NW, int BQ, int NDH, int NDMAX, int JB, bool DQ>
cudaError_t launch_dkv(const Args& a) {
  constexpr int BK = 16 * NW;
  const size_t smem =
      sizeof(T) * (size_t)(2 * BK + 4 * BQ) * (pad16(a.D) + kChunk<T>) +
      sizeof(float) * (4 * BQ + (DQ ? BK * (BQ + 4) : 0));
  auto kern = flash_bwd_dkv_kernel<T, NW, BQ, NDH, NDMAX, JB, DQ>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sk + BK - 1) / BK);
  kern<<<grid, NW * 32, smem, a.st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, a.dk, a.dv, a.dq_acc, a.tickets, a.dq, a.Sq, a.Sk, a.H, a.D,
      a.causal, a.scale, a.scale * kLog2e, a.out_bf16, vec_ok<T>(a));
  return cudaGetLastError();
}

// kind: 0 = dQ, 1 = dK/dV, 2 = merged single tile. f32 up to D 128: 8
// warps (128 rows of the resident side), streamed tiles of 32 rows (16
// for the merged kernel at D 128, whose dQ partial needs the registers),
// one pass; above: 4 warps, tiles of 16, dK/dV in two passes of 128
// columns. bf16 (S and dP one bf16 product per 16 head-dim values, so a
// pass is cheap): tiles of 16 and passes of 64 columns, so dK and dV fit
// in registers.
template <typename T, bool DQ>
cudaError_t launch_dkv_d(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.D <= 64) return launch_dkv<T, 8, 32, 8, 8, 2, DQ>(a);
    if (a.D <= 128) return launch_dkv<T, 8, DQ ? 16 : 32, 16, 16, 2, DQ>(a);
    return launch_dkv<T, 4, 16, 16, 32, 2, DQ>(a);
  } else {
    if (a.D <= 64) return launch_dkv<T, 8, 16, 8, 8, 2, DQ>(a);
    if (a.D <= 128) return launch_dkv<T, 8, 16, 8, 16, 2, DQ>(a);
    return launch_dkv<T, 4, 16, 8, 32, 2, DQ>(a);
  }
}

template <typename T>
cudaError_t launch_kind(int kind, const Args& a) {
  if (kind == 0) {
    if (a.D <= 64) return launch_dq<T, 8, 32, 8, 4>(a);
    if (a.D <= 128) return launch_dq<T, 8, 32, 16, 4>(a);
    return launch_dq<T, 4, 16, 32, 2>(a);
  }
  if (kind == 1) return launch_dkv_d<T, false>(a);
  return launch_dkv_d<T, true>(a);
}

int launch(int kind, const Args& a, int dtype, int out_dtype) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.H < 1 || a.D < 1 || a.D > 256)
    return (int)cudaErrorInvalidValue;
  if (out_dtype != DT_F32 && out_dtype != DT_BF16)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) return (int)launch_kind<float>(kind, a);
  if (dtype == DT_BF16) return (int)launch_kind<__nv_bfloat16>(kind, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entries (ops/flash_attention.py). q/dout [B, Sq, H, D], k/v
// [B, Sk, H, D], lse/delta [B*H, Sq] f32, gradients shaped like their
// inputs in out_dtype; all contiguous. dtype codes: 0 = f32, 1 = bf16.
// Each returns its launch's cudaError_t.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int B, int Sq, int Sk, int H,
                                      int D, int causal, float scale,
                                      int dtype, int out_dtype,
                                      void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, nullptr,
         B, Sq, Sk, H, D, causal, out_dtype == DT_BF16, scale,
         (cudaStream_t)stream};
  return launch(0, a, dtype, out_dtype);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int D, int causal,
                                       float scale, int dtype, int out_dtype,
                                       void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, nullptr, nullptr,
         B, Sq, Sk, H, D, causal, out_dtype == DT_BF16, scale,
         (cudaStream_t)stream};
  return launch(1, a, dtype, out_dtype);
}

// dq_acc: zeroed f32 [B, Sq, H, D] scratch; tickets: zeroed int [B*H].
// dq == NULL means the output is f32 and dq_acc is the output itself.
extern "C" int flash_attention_bwd_single_tile(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    float* dq_acc, int* tickets, int B, int Sq, int Sk, int H, int D,
    int causal, float scale, int dtype, int out_dtype, void* stream) {
  if (dq_acc == nullptr || (dq != nullptr && tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, tickets,
         B, Sq, Sk, H, D, causal, out_dtype == DT_BF16, scale,
         (cudaStream_t)stream};
  return launch(2, a, dtype, out_dtype);
}
