// Ragged paged attention over a page-table KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/paged_attention.py::_ragged_kernel
// (launched by _ragged_attention_pallas). Same function: query t of row r
// attends every cache position <= pos0[r] + t through the row's page table,
// softmax in natural exp with f32 accumulation, scale 1/sqrt(D); pages past
// the row's last attendable position pos0 + true_len - 1 are never read; a
// query with nothing attendable returns zeros. Pools are f32 or bf16 and
// queries f32 or bf16 (a bf16 pool under f32 queries upcasts on load, as
// _gather_attend does); the output has the query dtype. Pools may also be
// int8 with per-page per-head f32 scales [P, NH] (the TPU kernel's int8
// branch): a page's values times that page's scale for the block's head,
// then the same online softmax. The null page carries scale 0, so its
// bytes read as zeros.
//
// What bounds it on the H100: bytes at decode (T = 1): every K/V element
// of the attended pages is used once, so the least time is the attended
// K/V bytes plus q/o over 3.35 TB/s. Chunk rows (T > 1, 256 in the
// engine's prefill) reuse each page across the row's queries and are
// bound by the f32 FMA rate (67 TFLOP/s, TF32 off) instead. So the two
// kinds of row take two kernels, picked by T at the launch:
//
// Decode rows (ragged_kernel, one query a row):
//  * The TPU grid walked every (row, page) step and predicated dead pages
//    off; here a block loops only over pages its query can attend (loop
//    bound, not predication), and the rows of the last page past the
//    row's frontier are not loaded either.
//  * Every byte arrives by a 16-byte load. A group of LG lanes covers one
//    K/V row: at D 128, 32 lanes for f32, 16 for bf16 (two rows a load
//    instruction) and 8 for int8 (four rows); the query and accumulator
//    registers follow the same layout. Dots reduce by shuffles inside the
//    group; the accumulators stay partial per group until the end.
//  * A warp issues all K and V loads of a chunk of rows (8 f32 rows, 16
//    bf16 or int8 rows: 8 KB at D 128 for f32 and bf16, 4 KB for int8)
//    before it uses any.
//  * A decode group has only R * NH (row, head) pairs, 128 in the
//    engine's tick: short of two waves, each row's pages are split over
//    blocks of 4 warps (flash-decoding), as many ranges as one wave of
//    blocks holds and none under 4 pages; each split writes its
//    unnormalised state (acc, max, sum) to the wrapper's scratch, and the
//    split that finishes last (a ticket a row and head) merges them, so
//    a decode call stays one launch.
//  * int8 pools: a chunk lies in one page, so a page's scale for the
//    block's head is one scalar per chunk. It is folded into the score
//    after the group sum and into the weights before the P.V
//    accumulation, so the inner loops multiply raw int8 values (converted
//    to f32) and the dequantized page never exists.
//  * Online softmax in base 2 (scores scaled by scale * log2 e), as the
//    chunk rows and the merge kernel use.
//
// Chunk rows (ragged_chunk_kernel, below): the register-tiled f32 core of
// attention_simt.cuh (online softmax in base 2), K/V pages staged in
// shared memory by cp.async, described there.
//
// Both: page 0, the null page, is an ordinary readable page; masking
// compares global positions j * ps + p against pos0 + t, never offsets in
// a page. No tensor cores yet (bf16 chunk rows could take wgmma query
// tiles).
#include <algorithm>
#include <type_traits>

#include "attention_simt.cuh"

using namespace ptt;

namespace {

// ---------------------------------------------------------------------------
// Decode rows (T == 1)
// ---------------------------------------------------------------------------
// 4 warps a block, at least 3 blocks an SM (168 registers a thread at
// most, for the K and V loads in flight). Compared on the H100 with
// blocks of 8 and of 16 warps (8 rows of 200-1900 positions, 16 heads,
// D 128, and the serving engine's decode groups): no slower for f32
// pools, within 2 microseconds for bf16, faster for int8 pools and for
// groups of few rows.
constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecMinBlocks = 3;
constexpr int kDecMinPagesPerSplit = kDecWarps;  // a page a warp at least
constexpr int kDecMaxSplit = 64;  // page splits a row (the merge's room)

// 16 bytes of a K/V row as f32: 4 f32, 8 bf16 (a bf16 is the high half of
// its f32) or 16 int8 values, lowest address first
__device__ __forceinline__ void unpack16(const uint4& w, float (&o)[4]) {
  o[0] = __uint_as_float(w.x);
  o[1] = __uint_as_float(w.y);
  o[2] = __uint_as_float(w.z);
  o[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(const uint4& w, float (&o)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(u[i] << 16);
    o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
// int8: byte b + 128 placed in the low mantissa bits of 2^23 (one byte
// permute) is the float 2^23 + b + 128 exactly; one subtraction leaves b,
// which spares the quarter-rate integer-to-float conversion
__device__ __forceinline__ void unpack16(const uint4& w, float (&o)[16]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = u[i] ^ 0x80808080u;  // two's complement + 128
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[4 * i + k] = __uint_as_float(__byte_perm(b, 0x4B000000u,
                                                 0x7540u | k)) -
                     8388736.0f;  // 2^23 + 128
  }
}

// The 16-byte chunk of a K/V row that starts at element d0, raw; zeros past
// D or when `ok` is false. `vec`: rows are 16-byte aligned and D a whole
// number of chunks (one 16-byte load); otherwise element loads.
template <typename KT>
__device__ __forceinline__ uint4 load_chunk(const KT* __restrict__ row,
                                            int d0, int D, bool ok,
                                            bool vec) {
  constexpr int VE = 16 / (int)sizeof(KT);
  // the element's bits as a plain integer type of its size
  using RT = std::conditional_t<
      sizeof(KT) == 4, uint32_t,
      std::conditional_t<sizeof(KT) == 2, uint16_t, uint8_t>>;
  union {
    uint4 u;
    RT e[VE];
  } c;
  c.u = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || d0 >= D) return c.u;
  if (vec) return *reinterpret_cast<const uint4*>(row + d0);
  const RT* src = reinterpret_cast<const RT*>(row) + d0;
#pragma unroll
  for (int e = 0; e < VE; ++e)
    if (d0 + e < D) c.e[e] = src[e];
  return c.u;
}

// Sums of G partial dot products over the LG lanes of each lane group,
// scattered: G - 1 shuffles halve the set at each step (the lane with bit
// o set keeps the upper half), then the LG / G lanes left holding the
// same row add up. Lane lg of a group returns the total of its row
// u = lg / (LG / G): fewer shuffles than G separate reductions, and the
// scores land one a lane.
template <int N, int O, int G>
__device__ __forceinline__ void halve(float (&v)[G], int lane) {
  if constexpr (N > 1) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float send = upper ? v[k] : v[k + N / 2];
      const float keep = upper ? v[k + N / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    halve<N / 2, O / 2>(v, lane);
  }
}

template <int LG, int G>
__device__ __forceinline__ float reduce_scatter(float (&v)[G], int lane) {
  halve<G, LG / 2>(v, lane);
  float x = v[0];
#pragma unroll
  for (int o = LG / G / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Merge of a decode row's page splits, run by the block of the split that
// finished last: the splits' max and sum are read once, in parallel,
// into shared memory with each split's weight exp2(m - max) (0 for a split
// that attended nothing); then each thread sums its head-dim values over
// the splits that attended something, the loads independent of each
// other. `pr`: the row's nsplit states (D values, max, sum) in L2.
template <typename QT>
__device__ __forceinline__ void merge_splits(const float* pr, QT* orow,
                                             int D, int nsplit,
                                             float* sm_m, float* sm_l,
                                             float* sm_c) {
  const int tid = threadIdx.x;
  if (tid < nsplit) {
    sm_m[tid] = __ldcg(pr + tid * (D + 2) + D);
    sm_l[tid] = __ldcg(pr + tid * (D + 2) + D + 1);
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, sm_m[sp]);
  if (tid < nsplit)
    sm_c[tid] = sm_m[tid] == -INFINITY ? 0.f : exp2f(sm_m[tid] - mx);
  __syncthreads();
  float den = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) den += sm_l[sp] * sm_c[sp];
  for (int d = tid; d < D; d += blockDim.x) {
    float num = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < nsplit; ++sp)
      if (sm_c[sp] != 0.f) num += __ldcg(pr + sp * (D + 2) + d) * sm_c[sp];
    orow[d] = from_f32<QT>(den > 0.f ? num / den : 0.f);
  }
}

// One block per (head, split, row): the row's attendable pages are cut in
// up to `nsplit` equal ranges (flash-decoding), and the
// block's 4 warps take the range's chunks of CR rows in turn. A lane group
// of LG lanes covers one K/V row with 16-byte loads (lane lg of the group
// holds head-dim chunks lg, lg + LG, ..: CPL chunks of VE values), so one
// load instruction of the warp reads RPW = 32 / LG rows. For each chunk a
// warp issues all its K and V loads (2 G instructions) before it uses any,
// then: scores (G dots a lane, reduced and scattered over the group, one
// row a lane), an online-softmax step in base 2 (one warp max; the
// denominator stays a per-lane partial), and P.V into per-group partial
// accumulators that are summed across the groups once, at the end. Every
// step runs on all G rows, without a branch, so the rows' independent
// chains overlap. The warps merge through shared memory; with nsplit > 1
// the block writes its unnormalised accumulator, max and denominator to
// `part` and takes a ticket of its (row, head); the block whose ticket
// completes the row merges all its splits (merge_splits) and puts the
// ticket back to 0 for the next call.
template <typename QT, typename KT, int LG, int CPL>
__global__ void __launch_bounds__(kDecThreads, kDecMinBlocks)
ragged_kernel(const QT* __restrict__ q, const KT* __restrict__ kpool,
              const KT* __restrict__ vpool, const int* __restrict__ page_table,
              const int* __restrict__ pos0, const int* __restrict__ true_len,
              const float* __restrict__ kscale,
              const float* __restrict__ vscale, QT* __restrict__ out,
              float* __restrict__ part, int* __restrict__ tickets, int NH,
              int D, int ps, int NPs, float scale_log2, int vec,
              int nsplit) {
  constexpr bool I8 = std::is_same<KT, int8_t>::value;
  constexpr int VE = 16 / (int)sizeof(KT);  // values a 16-byte chunk
  constexpr int RPW = 32 / LG;              // rows a warp-wide load
  constexpr int NV = CPL * VE;              // values a lane keeps a row
  // K (and V) loads a chunk: up to 8 16-byte loads a lane, at most 16
  // rows (a page of the engine), no more rows than a group has lanes
  constexpr int G0 = 8 / CPL < 16 / RPW ? 8 / CPL : 16 / RPW;
  constexpr int G = G0 < LG ? G0 : LG;
  constexpr int CR = G * RPW;               // rows a chunk (<= 16)
  constexpr int DUP = LG / G;               // lanes holding one row's score
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ float sm_m[kDecWarps], sm_l[kDecWarps];
  __shared__ float sm_acc[kDecWarps][LG * NV];

  const int h = blockIdx.x, sp = blockIdx.y, r = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lg = lane % LG, sub = lane / LG;
  const int crow = sub + RPW * (lg / DUP);  // the chunk row scored here
  const bool rep = lg % DUP == 0;           // the row's one counted copy
  const int p0 = pos0[r];
  // the query attends positions <= p0, and no page past the row's last
  // real position is read
  const int last = min(p0 + true_len[r] - 1, p0);
  const int n_pages = last < 0 ? 0 : min(last / ps + 1, NPs);
  // this row's own splits: up to nsplit equal shares of its pages, none
  // under kDecMinPagesPerSplit pages (a short row takes fewer blocks and
  // merges fewer states; a row of one share writes its output itself)
  const int rs = max(1, min(nsplit, (n_pages + kDecMinPagesPerSplit - 1) /
                                        kDecMinPagesPerSplit));
  if (sp >= rs) return;
  const int jb = (int)((long)sp * n_pages / rs);
  const int je = (int)((long)(sp + 1) * n_pages / rs);
  const int cpp = (ps + CR - 1) / CR;  // chunks a page
  const int items = max(0, je - jb) * cpp;

  float qr[NV], acc[NV];
  const QT* qrow = q + ((long)r * NH + h) * D;
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int d = (lg + LG * i) * VE + e;
      qr[i * VE + e] = d < D ? to_f32(qrow[d]) * scale_log2 : 0.f;
      acc[i * VE + e] = 0.f;
    }
  float m = -INFINITY, l = 0.f;  // l: this lane's share of the sum

  const int* tab = page_table + (long)r * NPs;
  const long row_stride = (long)NH * D;  // one token of one page
  const long page_stride = (long)ps * row_stride;
  // the page of the warp's next chunk is read a chunk ahead
  int page_next = warp < items ? tab[jb + warp / cpp] : 0;
  for (int it = warp; it < items; it += kDecWarps) {
    const int j = jb + it / cpp, pb = (it % cpp) * CR;
    const int page = page_next;
    if (it + kDecWarps < items) page_next = tab[jb + (it + kDecWarps) / cpp];
    const KT* kb = kpool + (long)page * page_stride + (long)h * D;
    const KT* vb = vpool + (long)page * page_stride + (long)h * D;
    const int lim = min(ps, last - j * ps + 1);  // rows of the page read
    uint4 kr[G][CPL], vr[G][CPL];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = pb + sub + RPW * u;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        kr[u][i] = load_chunk(kb + p * row_stride, (lg + LG * i) * VE, D,
                              p < lim, vec != 0);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = pb + sub + RPW * u;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        vr[u][i] = load_chunk(vb + p * row_stride, (lg + LG * i) * VE, D,
                              p < lim, vec != 0);
    }
    float ksc = 1.f, vsc = 1.f;
    if constexpr (I8) {
      ksc = kscale[(long)page * NH + h];
      vsc = vscale[(long)page * NH + h];
    }
    // scores: this lane ends with chunk row crow's (base-2, scaled) score
    float dots[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      dots[u] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float kv[VE];
        unpack16(kr[u][i], kv);
#pragma unroll
        for (int e = 0; e < VE; ++e) dots[u] += qr[i * VE + e] * kv[e];
      }
    }
    float sc = reduce_scatter<LG, G>(dots, lane);
    if constexpr (I8) sc *= ksc;
    if (pb + crow >= lim) sc = -INFINITY;
    const float mn = fmaxf(m, warp_max(sc));
    if (mn == -INFINITY) continue;  // nothing attendable yet (uniform)
    const float alpha = exp2f(m - mn);
    const float pe = exp2f(sc - mn);  // 0 for rows not attended
    l = l * alpha + (rep ? pe : 0.f);
    m = mn;
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] *= alpha;
    const float wl = I8 ? pe * vsc : pe;  // the V scale rides the weights
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float w = __shfl_sync(FULL, wl, sub * LG + u * DUP);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float vv[VE];
        unpack16(vr[u][i], vv);
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[i * VE + e] += w * vv[e];
      }
    }
  }

  // the warp's state: denominator over its lanes, accumulator over its
  // lane groups
  l = warp_sum(l);
#pragma unroll
  for (int o = LG; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] += __shfl_xor_sync(FULL, acc[k], o);
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        sm_acc[warp][(lg + LG * i) * VE + e] = acc[i * VE + e];
  }
  __syncthreads();
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float cw[kDecWarps], den = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) {
    cw[w] = sm_m[w] == -INFINITY ? 0.f : exp2f(sm_m[w] - mx);
    den += sm_l[w] * cw[w];
  }
  const long row = (long)r * NH + h;
  float* prow = part + (row * nsplit + sp) * (D + 2);
  for (int d = threadIdx.x; d < D; d += kDecThreads) {
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) num += sm_acc[w][d] * cw[w];
    if (rs == 1)
      out[row * D + d] = from_f32<QT>(den > 0.f ? num / den : 0.f);
    else
      prow[d] = num;
  }
  if (rs == 1) return;
  if (threadIdx.x == 0) {
    prow[D] = mx;  // -inf for a split with nothing attendable
    prow[D + 1] = den;
  }
  // this split's state is visible to every block before its ticket is
  __threadfence();
  __syncthreads();
  __shared__ int sm_last;
  if (threadIdx.x == 0) {
    sm_last = atomicAdd(tickets + row, 1) == rs - 1;
    if (sm_last) tickets[row] = 0;
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  __shared__ float sm_sm[kDecMaxSplit], sm_sl[kDecMaxSplit],
      sm_sc[kDecMaxSplit];
  merge_splits<QT>(part + row * nsplit * (D + 2), out + row * D, D, rs,
                   sm_sm, sm_sl, sm_sc);
}

// Chunk rows (T > 1): the register-tiled core of attention_simt.cuh. A
// block owns (row, head, query tile of 64) and walks the key positions
// its tile can attend in key tiles of 32: whole pages at page sizes 8, 16
// and 32, each page row copied through the page table into a 2-stage
// cp.async ring (tile k+1 loads while tile k computes; one barrier a
// tile). Positions past the tile's last page are zero-filled, never
// read. int8 pages: a key's page scales ride in shared memory beside the
// tile; the K scale multiplies that key's score column, the V scale its
// P column (after the row sum), so the products run on the raw values,
// converted once a tile to f32 tiles in shared memory.
// A prefill group has few blocks (R 2, T 256, 16 heads: 128, against 264
// resident on the card), so when blocks are short of two waves each
// tile's keys are split in up to max_split contiguous ranges: every split
// writes its unnormalised accumulator, m and l to the wrapper's scratch,
// and ragged_chunk_merge combines them.
template <typename QT, typename KT, class C, int NCH>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
ragged_chunk_kernel(const QT* __restrict__ q, const KT* __restrict__ kpool,
                    const KT* __restrict__ vpool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ pos0,
                    const int* __restrict__ true_len,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale, QT* __restrict__ out,
                    float* __restrict__ part, int T, int NH, int D, int ps,
                    int NPs, float scale_log2, int vec, int nsplit) {
  using namespace simt;
  constexpr bool I8 = std::is_same<KT, int8_t>::value;
  constexpr int NTY = C::NTY, NTX = C::NTX, RM = C::RM, KN = C::KN;
  constexpr int BQ = C::BQ, BK = C::BK, NW = C::NW;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int dp = pad16(D), ldq = dp + kChunk<QT>, ldk = dp + kChunk<KT>;
  const int ldv = dp;
  float* sP = reinterpret_cast<float*>(smem_raw);  // [NW][BK][TYW RM]
  float* sKs = sP + C::P_FLOATS;                   // [2][BK] page scales
  float* sVs = sKs + 2 * BK;                       // [2][BK]
  QT* sQ = reinterpret_cast<QT*>(sVs + 2 * BK);    // [BQ][ldq]
  KT* sK = reinterpret_cast<KT*>(sQ + BQ * ldq);   // [2][BK][ldk]
  KT* sV = sK + 2 * BK * ldk;                      // [2][BK][ldv]
  // int8 pools: each landed tile is converted once to f32 tiles, which
  // the products read (16 row groups read every element)
  using CT = std::conditional_t<I8, float, KT>;
  float* sKf = reinterpret_cast<float*>(sV + 2 * BK * ldv);  // [BK][dp + 4]
  float* sVf = sKf + BK * (dp + 4);                          // [BK][dp]

  const int h = blockIdx.x, r = blockIdx.z / nsplit;
  const int sp = blockIdx.z - r * nsplit;  // this block's share of the keys
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tile first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % NTX, ty = tid / NTX;
  const int p0 = pos0[r];
  const int last = p0 + true_len[r] - 1;  // row's last attendable position
  const int nq = min(BQ, T - t0);         // queries of this tile (>= 1)
  const int tile_last = min(last, p0 + t0 + nq - 1);
  const int n_pages = tile_last < 0 ? 0 : min(tile_last / ps + 1, NPs);
  const int nkeys = n_pages * ps;  // positions of the pages read
  const long row_stride = (long)NH * D;  // one token of one page
  const int* tab = page_table + (long)r * NPs;

  const QT* qb = q + ((long)r * T + t0) * row_stride + (long)h * D;
  for (int i = warp; i < BQ; i += NW) {
    const bool ok = i < nq;
    copy_row(sQ + i * ldq, ok ? qb + i * row_stride : qb, D, dp, ok, vec,
             lane);
  }
  auto load_kv = [&](int kt, int stage) {
    for (int i = warp; i < BK; i += NW) {
      const int kp = kt * BK + i;
      const bool ok = kp < nkeys;
      const int page = ok ? tab[kp / ps] : 0;
      const long off =
          ok ? ((long)page * ps + kp % ps) * row_stride + (long)h * D : 0;
      copy_row(sK + (stage * BK + i) * ldk, kpool + off, D, dp, ok, vec,
               lane);
      copy_row(sV + (stage * BK + i) * ldv, vpool + off, D, dp, ok, vec,
               lane);
      if constexpr (I8) {
        if (lane == 0) {
          sKs[stage * BK + i] = ok ? kscale[(long)page * NH + h] : 0.f;
          sVs[stage * BK + i] = ok ? vscale[(long)page * NH + h] : 0.f;
        }
      }
    }
  };

  const int nkt = (nkeys + BK - 1) / BK;
  const int kb = sp * nkt / nsplit, ke = (sp + 1) * nkt / nsplit;
  if (kb < ke) load_kv(kb, 0);
  cp_async_commit();

  RowState<RM, NCH> st;
  st.init();
  float* sPw = sP + warp * BK * C::TYW * RM;
  for (int kt = kb; kt < ke; ++kt) {
    cp_async_wait<0>();
    // tile kt (and Q) landed for every thread, and every thread is done
    // with tile kt - 1, whose stage the next copy refills
    __syncthreads();
    if (kt + 1 < ke) {
      load_kv(kt + 1, (kt + 1 - kb) & 1);
      cp_async_commit();
    }
    const int sb = ((kt - kb) & 1) * BK;
    const CT *cK, *cV;
    int ldck, ldcv;
    if constexpr (I8) {
      for (int i = warp; i < BK; i += NW)
        for (int c = 4 * lane; c < dp; c += 128) {
          *reinterpret_cast<float4*>(sKf + i * (dp + 4) + c) =
              lds4(sK + (sb + i) * ldk + c);
          *reinterpret_cast<float4*>(sVf + i * dp + c) =
              lds4(sV + (sb + i) * ldv + c);
        }
      __syncthreads();
      cK = sKf, cV = sVf, ldck = dp + 4, ldcv = dp;
    } else {
      cK = sK + sb * ldk, cV = sV + sb * ldv, ldck = ldk, ldcv = ldv;
    }
    float s[RM][KN];
    scores<RM, KN, NTY, NTX>(sQ, ldq, cK, ldck, dp, ty, tx, s);
    float ksc[KN], vsc[KN];
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      ksc[j] = I8 ? sKs[sb + tx + NTX * j] * scale_log2 : scale_log2;
      vsc[j] = I8 ? sVs[sb + tx + NTX * j] : 1.f;
    }
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = p0 + t0 + ty + NTY * i;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int kp = k0 + tx + NTX * j;
        s[i][j] = kp < nkeys && kp <= qpos ? s[i][j] * ksc[j] : -INFINITY;
      }
    }
    softmax_update<RM, KN, NCH, NTX>(s, st);
    if constexpr (I8) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) s[i][j] *= vsc[j];
    }
    pv<RM, KN, NCH, NTY, NTX>(s, sPw, cV, ldcv, dp, ty, tx, st);
  }
  cp_async_wait<0>();  // an empty split still copied its Q tile

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = ty + NTY * i;
    if (t >= nq) continue;
    const long row = ((long)r * T + t0 + t) * NH + h;
    if (nsplit == 1) {
      const float ls = st.l[i] == 0.f ? 1.f : st.l[i];
      QT* orow = out + row * D;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx * 4 + 4 * NTX * c + e;
          if (d < D) orow[d] = from_f32<QT>(st.o[i][c][e] / ls);
        }
    } else {  // this split's softmax state: [D] accumulator, m, l
      float* prow = part + (row * nsplit + sp) * (D + 2);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx * 4 + 4 * NTX * c + e;
          if (d < D) prow[d] = st.o[i][c][e];
        }
      if (tx == 0) {
        prow[D] = st.m[i];
        prow[D + 1] = st.l[i];
      }
    }
  }
}

// Merge of a chunk row's key splits: one block per (row, query, head),
// the splits' states rescaled to their common max (base 2).
template <typename QT>
__global__ void ragged_chunk_merge(const float* __restrict__ part,
                                   QT* __restrict__ out, int D, int nsplit) {
  const long row = blockIdx.x;
  const float* pr = part + row * nsplit * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pr[s * (D + 2) + D]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float den = 0.f, num = 0.f;
    for (int s = 0; s < nsplit && mx != -INFINITY; ++s) {
      const float m = pr[s * (D + 2) + D];
      if (m == -INFINITY) continue;
      const float c = exp2f(m - mx);
      den += pr[s * (D + 2) + D + 1] * c;
      num += pr[s * (D + 2) + d] * c;
    }
    out[row * D + d] = from_f32<QT>(den > 0.f ? num / den : 0.f);
  }
}

// Dmax: the largest head dim of the instantiation (NCH covers it)
template <typename QT, typename KT, class C, int Dmax>
cudaError_t launch_chunk(const void* q, const void* k, const void* v,
                         const int* tab, const int* p0, const int* tl,
                         const float* ks, const float* vs, void* o,
                         float* part, int max_split, int R, int T, int NH,
                         int D, int ps, int NPs, float scale,
                         cudaStream_t st) {
  constexpr int NCH = (Dmax + 4 * C::NTX - 1) / (4 * C::NTX);
  const int nqt = (T + C::BQ - 1) / C::BQ;
  // split the keys of each (row, head, query tile) when the group has
  // too few blocks to keep two waves of resident blocks on the card
  int nsplit = 1;
  if (part != nullptr && max_split > 1) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const long blocks = (long)R * NH * nqt, want = 2L * C::MINB * sms;
    nsplit = (int)std::min<long>(
        max_split, std::max<long>(1, (want + blocks - 1) / blocks));
  }
  const bool i8 = std::is_same<KT, int8_t>::value;
  const size_t smem = C::template smem<QT, KT>(
      D, sizeof(float) * C::BK * (4 + (i8 ? 2 * simt::pad16(D) + 4 : 0)));
  cudaError_t err = cudaFuncSetAttribute(
      ragged_chunk_kernel<QT, KT, C, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = D % simt::kChunk<QT> == 0 && D % simt::kChunk<KT> == 0 &&
                  (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const dim3 grid(NH, nqt, R * nsplit);
  ragged_chunk_kernel<QT, KT, C, NCH><<<grid, C::THREADS, smem, st>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, tab, p0, tl, ks, vs, (QT*)o,
      part, T, NH, D, ps, NPs, scale * 1.4426950408889634f, vec, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  ragged_chunk_merge<QT><<<R * T * NH, 128, 0, st>>>(part, (QT*)o, D, nsplit);
  return cudaGetLastError();
}

// Decode rows: how many page ranges each row is split in (at most
// max_split, of at least kDecMinPagesPerSplit pages). A decode group of 8
// rows by 16 heads has 128 blocks.
template <typename QT, typename KT, int LG, int CPL>
cudaError_t decode_splits(int max_split, int R, int NH, int NPs,
                          int* nsplit) {
  *nsplit = 1;
  max_split = std::min(max_split, kDecMaxSplit);
  if (max_split <= 1) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ragged_kernel<QT, KT, LG, CPL>, kDecThreads, 0);
  if (e != cudaSuccess) return e;
  // a group short of two waves of resident blocks is cut in as many page
  // ranges as one wave holds (a second, partial wave costs more than the
  // ranges gain)
  const long blocks = (long)R * NH, wave = (long)per_sm * sms;
  if (blocks < 2 * wave)
    *nsplit = (int)std::max<long>(
        1, std::min<long>({(long)max_split, wave / blocks,
                           (NPs + kDecMinPagesPerSplit - 1) /
                               kDecMinPagesPerSplit}));
  return cudaSuccess;
}

// Decode rows: the launch of one (LG, CPL) kernel and, when it split the
// rows, the merge. Given `nsplit_out`, it reports the split count there
// and launches nothing.
template <typename QT, typename KT, int LG, int CPL>
cudaError_t launch_decode_lg(const void* q, const void* k, const void* v,
                             const int* tab, const int* p0, const int* tl,
                             const float* ks, const float* vs, void* o,
                             float* part, int* tickets, int max_split, int R,
                             int NH, int D, int ps, int NPs, float scale,
                             cudaStream_t st, int* nsplit_out) {
  auto kern = ragged_kernel<QT, KT, LG, CPL>;
  int nsplit = 1;
  cudaError_t err = decode_splits<QT, KT, LG, CPL>(
      (part != nullptr && tickets != nullptr) || nsplit_out != nullptr
          ? max_split
          : 1,
      R, NH, NPs, &nsplit);
  if (err != cudaSuccess) return err;
  if (nsplit_out != nullptr) {
    *nsplit_out = nsplit;
    return cudaSuccess;
  }
  const int vec = (D * (int)sizeof(KT)) % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const dim3 grid(NH, nsplit, R);
  kern<<<grid, kDecThreads, 0, st>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, tab, p0, tl, ks, vs, (QT*)o,
      part, tickets, NH, D, ps, NPs, scale * 1.4426950408889634f, vec,
      nsplit);
  return cudaGetLastError();
}

// Decode rows: a lane group just wide enough for a row's 16-byte chunks
template <typename QT, typename KT>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* tab, const int* p0, const int* tl,
                          const float* ks, const float* vs, void* o,
                          float* part, int* tickets, int max_split, int R,
                          int NH, int D, int ps, int NPs, float scale,
                          cudaStream_t st, int* nsplit_out = nullptr) {
  constexpr int VE = 16 / (int)sizeof(KT);
  const int nch = (D + VE - 1) / VE;  // 16-byte chunks a row
#define PTT_DECODE(LG, CPL)                                                  \
  return launch_decode_lg<QT, KT, LG, CPL>(                                  \
      q, k, v, tab, p0, tl, ks, vs, o, part, tickets, max_split, R, NH, D,   \
      ps, NPs, scale, st, nsplit_out)
  if (nch <= 4) PTT_DECODE(4, 1);
  if (nch <= 8) PTT_DECODE(8, 1);
  if (nch <= 16) PTT_DECODE(16, 1);
  if constexpr (VE <= 8) {  // f32 and bf16 rows of more than 16 chunks
    if (nch <= 32) PTT_DECODE(32, 1);
  }
  if constexpr (VE == 4) {  // f32 above D 128
    if (nch <= 64) PTT_DECODE(32, 2);
  }
#undef PTT_DECODE
  return cudaErrorInvalidValue;
}

template <typename QT, typename KT>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* tab, const int* p0, const int* tl,
                     const float* ks, const float* vs, void* o, float* part,
                     int* tickets, int max_split, int R, int T, int NH, int D,
                     int ps, int NPs, float scale, cudaStream_t st) {
  if (T == 1)
    return launch_decode<QT, KT>(q, k, v, tab, p0, tl, ks, vs, o, part,
                                 tickets, max_split, R, NH, D, ps, NPs, scale,
                                 st);
  // chunk rows: above D 128 a thread keeps 2 query rows, so its output
  // patch stays at 64 registers
  if (D <= 64)
    return launch_chunk<QT, KT, simt::Tile128, 64>(
        q, k, v, tab, p0, tl, ks, vs, o, part, max_split, R, T, NH, D, ps,
        NPs, scale, st);
  if (D <= 128)
    return launch_chunk<QT, KT, simt::Tile128, 128>(
        q, k, v, tab, p0, tl, ks, vs, o, part, max_split, R, T, NH, D, ps,
        NPs, scale, st);
  return launch_chunk<QT, KT, simt::Tile256, 256>(
      q, k, v, tab, p0, tl, ks, vs, o, part, max_split, R, T, NH, D, ps, NPs,
      scale, st);
}

}  // namespace

// C entry (ops/paged_attention.py). All tensors contiguous:
//   q [R, T, NH, D], k_pool/v_pool [P, ps, NH, D], page_table [R, NPs]
//   int32, pos0/true_len [R] int32, k_scale/v_scale [P, NH] f32 (int8
//   pools; null otherwise), out [R, T, NH, D] (q dtype), scratch f32 of
//   R * T * NH * max_split * (D + 2) floats for the splits of a row's
//   keys: chunk rows' key ranges (T > 1), decode rows' page ranges
//   (T == 1); null or max_split <= 1: no split. tickets: R * NH int32,
//   all 0 (decode rows split only with them; each call leaves them 0),
//   one set a stream.
// dtype codes: 0 = f32, 1 = bf16, 2 = int8 (pools only). Returns the
// launch's cudaError_t.
extern "C" int ragged_paged_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const int* page_table, const int* pos0,
                                      const int* true_len,
                                      const float* k_scale,
                                      const float* v_scale, void* out, int R,
                                      int T, int NH, int D, int ps, int NPs,
                                      int q_dtype, int kv_dtype, float scale,
                                      float* scratch, int max_split,
                                      int* tickets, void* stream) {
  if (R < 1 || T < 1 || D < 1 || D > 256 || ps < 1 || ps > 32 || NPs < 1)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == DT_INT8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PTT_RAGGED(QC, KC, QT, KT)                                          \
  if (q_dtype == QC && kv_dtype == KC)                                      \
    return (int)launch_t<QT, KT>(q, k_pool, v_pool, page_table, pos0,       \
                                 true_len, k_scale, v_scale, out, scratch,  \
                                 tickets, max_split, R, T, NH, D, ps, NPs,  \
                                 scale, st);
  PTT_RAGGED(DT_F32, DT_F32, float, float)
  PTT_RAGGED(DT_F32, DT_BF16, float, __nv_bfloat16)
  PTT_RAGGED(DT_BF16, DT_BF16, __nv_bfloat16, __nv_bfloat16)
  PTT_RAGGED(DT_BF16, DT_F32, __nv_bfloat16, float)
  PTT_RAGGED(DT_F32, DT_INT8, float, int8_t)
  PTT_RAGGED(DT_BF16, DT_INT8, __nv_bfloat16, int8_t)
#undef PTT_RAGGED
  return (int)cudaErrorInvalidValue;
}

// How many page ranges the decode-row kernel splits each row of a T == 1
// call in, for these sizes on the current device (what
// ragged_paged_attention would launch with this max_split); -1 on an
// unknown dtype pair or size.
extern "C" int ragged_decode_splits(int R, int NH, int D, int NPs,
                                    int q_dtype, int kv_dtype,
                                    int max_split) {
  int n = -1;
#define PTT_SPLITS(QC, KC, QT, KT)                                           \
  if (q_dtype == QC && kv_dtype == KC)                                       \
    return launch_decode<QT, KT>(nullptr, nullptr, nullptr, nullptr,         \
                                 nullptr, nullptr, nullptr, nullptr,         \
                                 nullptr, nullptr, nullptr, max_split, R,    \
                                 NH, D, 16, NPs, 1.f, nullptr,               \
                                 &n) == cudaSuccess                          \
               ? n                                                           \
               : -1;
  PTT_SPLITS(DT_F32, DT_F32, float, float)
  PTT_SPLITS(DT_F32, DT_BF16, float, __nv_bfloat16)
  PTT_SPLITS(DT_BF16, DT_BF16, __nv_bfloat16, __nv_bfloat16)
  PTT_SPLITS(DT_BF16, DT_F32, __nv_bfloat16, float)
  PTT_SPLITS(DT_F32, DT_INT8, float, int8_t)
  PTT_SPLITS(DT_BF16, DT_INT8, __nv_bfloat16, int8_t)
#undef PTT_SPLITS
  return -1;
}
