// Flash attention forward on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd) for bf16 q/k/v at head dim 64 or 128; f32 and other
// head dims keep flash_attention_fwd.cu (ops/flash_attention.py:
// _tc_route). Same function: o = softmax(q k^T * scale) v with an online
// softmax in base 2 (scores scaled by scale * log2 e, exp2), f32 row max
// and sum, P rounded to bf16 before P.V as the reference does
// (`p.astype(v.dtype)`), an f32 O accumulator and a bf16 output, and the
// natural-log LSE lse[b*H + h, s] = (m + log2 l) * ln 2 that the backward
// and ring attention read. The row sum takes the unrounded P, as the
// reference's does. Rows with no live key write o = 0 and never NaN.
//
// Layout: q, k, v, o keep the public [B, S, H, D] layout. TMA reads them
// through 4-D tensor maps of dims (D, H, S, B): a box is 64 values of D for
// `rows` consecutive s of one (b, h), so no transpose is ever made.
//
// What bounds it on the H100: operations. 4 * B*H*Sq*Sk*D flops (halved
// when causal) against 989 TFLOP/s bf16 on the tensor cores; q/k/v/o bytes
// take less time than that at S = 2048.
//
// What the design does about it:
//  * One block per (b*h, 128 query rows): two consumer warpgroups of 64
//    rows each and one producer warpgroup, of which one thread issues
//    every TMA load. The producer gives up registers (setmaxnreg 24) so
//    each consumer thread can hold 240: the 64 x D O accumulator and the
//    64 x 128 score tile stay in registers, without spills.
//  * The producer loads the Q tile once and streams K/V tiles of 128 keys
//    into a 2-stage ring of shared memory (full / empty mbarriers), so the
//    next tile's copy overlaps this tile's products.
//  * S = Q K^T by wgmma with both operands in shared memory (K-major, the
//    128-byte swizzle TMA wrote). The softmax runs on the accumulator in
//    registers (row max and sum over the 4 threads of a quad). P is packed
//    to bf16 in registers straight from the S accumulator, which is the A
//    operand layout of wgmma's register form, and O += P V reads V from
//    shared memory as an MN-major B operand: P never touches memory.
//  * D = 128 rows are 256 bytes: two 64-wide boxes ("halves") per tile,
//    matched by the descriptors (a k step of the Q K^T product picks its
//    half; the P V product's N spans both halves through the leading-byte
//    offset).
//  * Causal: the key loop stops at the diagonal tile and only that tile
//    (and a ragged last tile) masks. Blocks take the longest query tiles
//    first (blockIdx.y counts from the last tile down).
//  * Ragged S (1000): TMA fills rows past S with zeros, keys >= Sk are
//    masked, rows >= Sq are never stored.
// Not yet: two consumer warpgroups ping-ponging softmax against products,
// intra-warpgroup overlap of S(k+1) with P V(k), a persistent grid.
#include "common.cuh"
#include "hopper.cuh"

using namespace ptt;
using namespace ptt::hopper;

namespace {

constexpr int kBQ = 128, kBK = 128, kThreads = 384, kStages = 2;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kQHalf = kBQ * 128;             // bytes of one half
  static constexpr int kKVHalf = kBK * 128;
  static constexpr int kQ = kHalves * kQHalf;
  static constexpr int kKV = kHalves * kKVHalf;        // one K or V tile
  static constexpr int kK0 = kQ;
  static constexpr int kV0 = kK0 + kStages * kKV;
  static constexpr int kBars = kV0 + kStages * kKV;    // q, full[2], empty[2]
  static constexpr int kBytes = kBars + 64 + 1024;     // + alignment slack
};

// S[64 x 128] = Q_wg[64 x D] . K_tile[128 x D]^T
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[64], const uint8_t* q,
                                           const uint8_t* k) {
  using L = FwdSmem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int half = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n128k16_ss<0>(s, desc_sw128(q + half * L::kQHalf + off, 16, 1024),
                           desc_sw128(k + half * L::kKVHalf + off, 16, 1024),
                           kk > 0);
  }
}

// O[64 x D] += P[64 x 128] (registers, bf16) . V_tile[128 x D] (MN-major)
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&p)[kBK / 16][4],
                                           const uint8_t* v) {
  using L = FwdSmem<D>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = desc_sw128(v + kk * 16 * 128, L::kKVHalf, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs<1>(o, p[kk], db, 1);
    else
      wgmma_m64n64k16_rs<1>(o, p[kk], db, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int Sq, int Sk, int H, int causal, float scale_log2) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sK = smem + L::kK0;
  uint8_t* sV = smem + L::kV0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest tiles first
  int nkt = (Sk + kBK - 1) / kBK;
  if (causal) nkt = min(nkt, (q0 + kBQ - 1) / kBK + 1);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_bar, L::kQ);
      for (int c = 0; c < L::kHalves; ++c)
        tma_load_4d(sQ + c * L::kQHalf, &tm_q, q_bar, 64 * c, h, q0, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
        uint8_t* k_dst = sK + s * L::kKV;
        uint8_t* v_dst = sV + s * L::kKV;
        for (int c = 0; c < L::kHalves; ++c) {
          tma_load_4d(k_dst + c * L::kKVHalf, &tm_k, &full[s], 64 * c, h,
                      kt * kBK, b);
          tma_load_4d(v_dst + c * L::kKVHalf, &tm_v, &full[s], 64 * c, h,
                      kt * kBK, b);
        }
      }
    }
  } else {
    // ---------------- consumers: rows q0 + 64 wg .. + 63 ----------------
    setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row_base = q0 + wg * 64 + warp * 16 + g;    // + 8 r
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint8_t* q_wg = sQ + wg * 64 * 128;

    mbar_wait(q_bar, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % kStages, k0 = kt * kBK;
      mbar_wait(&full[s], (kt / kStages) & 1);

      float sc[64];
      wgmma_fence();
      qk_product<D>(sc, q_wg, sK + s * L::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool masked = k0 + kBK > Sk || (causal && kt == nkt - 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + 8 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[4 * j + 2 * r + e] * scale_log2;
            if (masked) {
              const int col = k0 + 8 * j + 2 * t + e;
              if (col >= Sk || (causal && col > row)) x = -INFINITY;
            }
            sc[4 * j + 2 * r + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - m_use);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * j + 2 * r + e] - m_use);
            sc[4 * j + 2 * r + e] = p;
            rs += p;
          }
        l[r] = l[r] * alpha + rs;          // this thread's columns only
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[4 * j + 2 * r + e] *= alpha;
      }

      // P to bf16 in registers, all of it before the products read it
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(sc, kk, pa[kk]);
      fence_regs(acc);
      wgmma_fence();
      pv_product<D>(acc, pa, sV + s * L::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = row_base + 8 * r;
      if (row >= Sq) continue;
      const float ls = lr == 0.f ? 1.f : lr;
      __nv_bfloat16* orow = o + (((long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float x0 = acc[4 * j + 2 * r] / ls;
        const float x1 = acc[4 * j + 2 * r + 1] / ls;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(x0, x1);
      }
      if (t == 0) lse[(long)bh * Sq + row] = (m[r] + log2f(ls)) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int causal,
                   float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = bshd_tensor_map(&tq, q, B, Sq, H, D, kBQ);
  if (err == cudaSuccess) err = bshd_tensor_map(&tk, k, B, Sk, H, D, kBK);
  if (err == cudaSuccess) err = bshd_tensor_map(&tv, v, B, Sk, H, D, kBK);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_tc_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FwdSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, FwdSmem<D>::kBytes, st>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, Sq, Sk, H, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// C entry (ops/flash_attention.py). bf16 q [B, Sq, H, D], k/v [B, Sk, H, D],
// o [B, Sq, H, D] bf16, lse [B*H, Sq] f32; all contiguous, 16-byte aligned,
// D 64 or 128. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd_tc(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Sq, int Sk, int H, int D,
                                      int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return (int)launch<128>(q, k, v, o, lse, B, Sq, Sk, H, causal, scale, st);
  if (D == 64)
    return (int)launch<64>(q, k, v, o, lse, B, Sq, Sk, H, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
