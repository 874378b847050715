// The f32 attention core shared by the SIMT flash forward
// (flash_attention_fwd.cu) and the chunk rows of the ragged paged kernel
// (ragged_paged_attention.cu): register-tiled score and P.V products on
// the FMA units, fed from shared memory, with an online softmax in base 2.
//
// Block shape (Shape): NTY x NTX threads (the NTX lanes of a row group sit
// in one warp, so a row's reductions are NTX-lane shuffles). Thread
// (ty, tx) owns the RM query rows ty + NTY i and the KN keys tx + NTX j of
// a score tile (BQ = NTY RM rows by BK = NTX KN keys), and the matching RM
// rows by 4 NCH head-dim columns tx 4 + 4 NTX c + e of the output
// accumulator.
//
// Shared-memory layouts (element type T of the operand as stored, f32,
// bf16 or int8, converted to f32 on the read):
//  * Q tile [BQ][ldq], K tile [BK][ldk]: a row is one query or key, head
//    dim contiguous, zero-padded to dp (a multiple of 16 elements, the
//    product's length). ldq and ldk carry one 16-byte chunk more, so
//    the 4-row groups a warp reads at one head-dim offset fall in distinct
//    banks. The score product reads 4 head-dim values of a row as one
//    float4 (8 bytes for bf16, 4 for int8): per 4 head-dim steps a thread
//    issues RM + KN such loads for 4 RM KN FMAs (8 a load at 4 x 4).
//  * V tile [BK][ldv], no padding: the NTX lanes of a row group read 4 NTX
//    consecutive columns of one key row.
//  * P: each warp's own [BK][TYW RM] tile (TYW = 32 / NTX row groups per
//    warp), written once as float4s by the thread that holds it and read
//    back by the same warp only, so P costs a __syncwarp, not a block
//    barrier. Per key the P.V product issues RM / 4 P loads and NCH V
//    loads for 4 RM NCH FMAs.
// Both products keep two fragment sets that ping-pong, so the next step's
// shared loads are in flight while this step's FMAs run: without that,
// each warp waited on its loads (8 warps an SM do not hide them).
#pragma once

#include "common.cuh"

namespace ptt {
namespace simt {

// ---------------------------------------------------------------------------
// cp.async (16 bytes a thread), zero-filled when the source is past the end
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// elements per 16-byte chunk
template <typename T>
constexpr int kChunk = 16 / (int)sizeof(T);

// One row of D elements from global memory into dp elements of shared
// memory (dp a multiple of 16 and >= D), the tail [D, dp) zeroed; `ok`
// false zero-fills the row. Warp-wide: lane `lane` copies chunks lane,
// lane + 32, ... With `vec` (D a whole number of 16-byte chunks, rows
// 16-byte aligned) the copy is a cp.async of 16 bytes a lane; otherwise
// plain element loads and stores.
template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* __restrict__ src,
                                         int D, int dp, bool ok, bool vec,
                                         int lane) {
  constexpr int C = kChunk<T>;
  if (vec) {
    for (int c = lane; c < dp / C; c += 32) {
      const bool in = ok && c * C < D;
      cp_async16(dst + c * C, in ? src + c * C : src, in);
    }
    return;
  }
  for (int d = lane; d < dp; d += 32) dst[d] = ok && d < D ? src[d] : T{};
}

// head-dim length of the shared tiles and of the products
__host__ __device__ inline int pad16(int D) { return (D + 15) / 16 * 16; }

// A block shape of the core: NTY x NTX threads, RM query rows and KN keys
// a thread (BQ x BK tiles), at least MINB blocks an SM (launch bound).
// Both kernels use Tile128 up to D 128 and Tile256 above it (below).
// smem: the P tiles, a [BQ] Q tile of QT and a 2-stage K/V ring of KT,
// plus `extra` bytes.
template <int NTY_, int NTX_, int RM_, int KN_, int MINB_>
struct Shape {
  static constexpr int NTY = NTY_, NTX = NTX_, RM = RM_, KN = KN_;
  static constexpr int MINB = MINB_, THREADS = NTY * NTX, NW = THREADS / 32;
  static constexpr int BQ = NTY * RM, BK = NTX * KN, TYW = 32 / NTX;
  static constexpr int P_FLOATS = NW * BK * TYW * RM;
  template <typename QT, typename KT>
  static size_t smem(int D, size_t extra = 0) {
    const int dp = pad16(D);
    return sizeof(float) * P_FLOATS + extra +
           sizeof(QT) * (size_t)BQ * (dp + kChunk<QT>) +
           sizeof(KT) * (size_t)2 * BK * (2 * dp + kChunk<KT>);
  }
};

// 128 threads, 64 queries by 32 keys, 4 x 4 a thread; 108.5 KB of shared
// memory at D 128 f32, so two blocks share an SM. On the H100, 8 x 4
// patches (16 lanes a row group, 64-key tiles, one block an SM), 4 x 8
// patches and 256-thread blocks of 128 queries ran slower or no faster.
using Tile128 = Shape<16, 8, 4, 4, 2>;
// above D 128: 2 query rows a thread, so the output patch stays at 64
// registers
using Tile256 = Shape<16, 8, 2, 4, 2>;

// 4 consecutive shared elements as f32
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// int8: each byte b, offset to b + 128, is placed under the exponent of
// 2^23 (one byte permute) and 2^23 + 128 subtracted: exact, and no
// quarter-rate int-to-float conversion
__device__ __forceinline__ float4 lds4(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) -
                         kBias,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) -
                         kBias,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7442)) -
                         kBias,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7443)) -
                         kBias);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// reductions over the NTX lanes of a row group (consecutive lanes)
template <int NTX>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = NTX / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int NTX>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = NTX / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The running softmax state of a thread's RM rows and its output patch.
template <int RM, int NCH>
struct RowState {
  float m[RM], l[RM], o[RM][NCH][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
    }
  }
};

// s[i][j] = q_row(ty + NTY i) . k_row(tx + NTX j) over dp head-dim values
// (dp a multiple of 16; the padded tail of both tiles is zero). Two
// fragment sets ping-pong: the next 4 head-dim values load while this
// step's FMAs run.
template <int RM, int KN, int NTY, int NTX, typename QT, typename KT>
__device__ __forceinline__ void scores(const QT* sQ, int ldq, const KT* sK,
                                       int ldk, int dp, int ty, int tx,
                                       float (&s)[RM][KN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
  const QT* qp = sQ + ty * ldq;
  const KT* kp = sK + tx * ldk;
  float4 a0[RM], b0[KN], a1[RM], b1[KN];
  auto load = [&](float4(&a)[RM], float4(&b)[KN], int d) {
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = lds4(qp + i * NTY * ldq + d);
#pragma unroll
    for (int j = 0; j < KN; ++j) b[j] = lds4(kp + j * NTX * ldk + d);
  };
  auto mac = [&](const float4(&a)[RM], const float4(&b)[KN]) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
  };
  load(a0, b0, 0);
  for (int d = 0; d < dp; d += 8) {
    load(a1, b1, d + 4);
    mac(a0, b0);
    load(a0, b0, d + 8 < dp ? d + 8 : d);  // the last reload is unused
    mac(a1, b1);
  }
}

// Online softmax over one key tile, base 2. In: s = scaled scores (times
// log2 e), -INFINITY where masked. Out: s = the tile's weights exp2(s - m)
// (0 where masked or where the row has seen nothing yet), m, l updated and
// the output patch rescaled by exp2(m_old - m_new).
template <int RM, int KN, int NCH, int NTX>
__device__ __forceinline__ void softmax_update(float (&s)[RM][KN],
                                               RowState<RM, NCH>& st) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float rmax = s[i][0];
#pragma unroll
    for (int j = 1; j < KN; ++j) rmax = fmaxf(rmax, s[i][j]);
    const float mn = fmaxf(st.m[i], group_max<NTX>(rmax));
    float rs = 0.f, alpha = 1.f;
    if (mn != -INFINITY) {
      alpha = exp2f(st.m[i] - mn);
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : exp2f(s[i][j] - mn);
        s[i][j] = p;
        rs += p;
      }
      st.m[i] = mn;
    } else {
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
    }
    st.l[i] = st.l[i] * alpha + group_sum<NTX>(rs);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[i][c][e] *= alpha;
  }
}

// RM consecutive floats of shared memory (RM 2: one float2; RM 4 or 8:
// float4s)
template <int RM>
__device__ __forceinline__ void lds_rows(const float* p, float (&out)[RM]) {
  if constexpr (RM == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  } else {
#pragma unroll
    for (int r = 0; r < RM; r += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + r);
      out[r] = t.x, out[r + 1] = t.y, out[r + 2] = t.z, out[r + 3] = t.w;
    }
  }
}

// o += P V over one key tile. p[i][j] is the weight of row ty + NTY i and
// key tx + NTX j; sPw is this warp's [BK][TYW RM] P tile; V columns past
// dp (a multiple of 4) are not read. Two fragment sets ping-pong: the
// next key's P and V load while this key's FMAs run.
template <int RM, int KN, int NCH, int NTY, int NTX, typename VT>
__device__ __forceinline__ void pv(const float (&p)[RM][KN], float* sPw,
                                   const VT* sV, int ldv, int dp, int ty,
                                   int tx, RowState<RM, NCH>& st) {
  constexpr int TYW = 32 / NTX, LDP = TYW * RM, BK = KN * NTX;
  static_assert(RM == 2 || RM % 4 == 0, "P rows go out as float2/float4");
  const int r0 = (ty % TYW) * RM;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    float* dst = sPw + (tx + NTX * j) * LDP + r0;
    if constexpr (RM == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(p[0][j], p[1][j]);
    } else {
#pragma unroll
      for (int r = 0; r < RM; r += 4)
        *reinterpret_cast<float4*>(dst + r) =
            make_float4(p[r][j], p[r + 1][j], p[r + 2][j], p[r + 3][j]);
    }
  }
  __syncwarp();
  bool col_ok[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) col_ok[c] = tx * 4 + 4 * NTX * c < dp;
  const VT* vp = sV + tx * 4;
  float p0[RM], p1[RM];
  float4 v0[NCH], v1[NCH];
  auto load = [&](float(&pr)[RM], float4(&v)[NCH], int kk) {
    lds_rows<RM>(sPw + kk * LDP + r0, pr);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      v[c] = col_ok[c] ? lds4(vp + kk * ldv + 4 * NTX * c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto mac = [&](const float(&pr)[RM], const float4(&v)[NCH]) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        st.o[i][c][0] = fmaf(pr[i], v[c].x, st.o[i][c][0]);
        st.o[i][c][1] = fmaf(pr[i], v[c].y, st.o[i][c][1]);
        st.o[i][c][2] = fmaf(pr[i], v[c].z, st.o[i][c][2]);
        st.o[i][c][3] = fmaf(pr[i], v[c].w, st.o[i][c][3]);
      }
  };
  load(p0, v0, 0);
#pragma unroll 2
  for (int kk = 0; kk < BK; kk += 2) {
    load(p1, v1, kk + 1);
    mac(p0, v0);
    load(p0, v0, kk + 2 < BK ? kk + 2 : kk);  // the last reload is unused
    mac(p1, v1);
  }
  __syncwarp();  // the P tile is rewritten by the next key tile
}

}  // namespace simt
}  // namespace ptt
