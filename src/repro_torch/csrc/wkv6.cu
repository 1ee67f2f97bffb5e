// Chunked WKV6 (RWKV6 linear attention, per-channel decay) for Hopper
// (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernel wkv6_chunked_kernel
// (src/repro/kernels/rwkv6_scan/kernel.py:77, body _kernel :32-74). Per
// (batch b, head h), over the tokens of a sequence, with lw <= 0 the log
// decay:
//
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//
// computed chunk by chunk in the TPU kernel's closed form. Within a chunk
// of n <= kC tokens, with cw the inclusive cumulative sum of lw over the
// chunk (per channel) and ce the exclusive one (ce[t] = cw[t-1], ce[0] = 0):
//
//   A[t,s] = sum_k r[t,k] k[s,k] exp(ce[t,k] - cw[s,k])     (s < t)
//   A[t,t] = sum_k r[t,k] u[k] k[t,k]
//   y      = A v + (r o exp(ce)) S_in
//   S_out  = diag(exp(cw[n-1])) S_in + (k o exp(cw[n-1] - cw))^T v
//
// What bounds it: at rwkv6-7b's prefill (one prompt of T = 512, 64 heads of
// 64) bytes on paper: the call reads r, k, v, lw and writes y, 42 MB in f32,
// and writes the 1 MB state, some 13 us at 3.35 TB/s, against some 0.8
// GFLOP of f32 work in this closed form (12 us at 67 TFLOP/s on the CUDA
// cores), 32K exps a chunk of them on the SFU. At decode (8 slots, T = 1)
// bytes: it reads and writes the 8 MB state, 5 us.
//
// Prefill (wkv6_split_kernel), the design of csrc/ssd.cu with a decay per
// channel:
//   * each sequence is split across the blocks of a thread-block cluster: a
//     grid of n_split * B * H blocks along x, the n_split consecutive blocks
//     of one (b, h) one cluster. The caller passes n_split (1 to the
//     portable 8), computed from shapes alone (ref.split_count): the most
//     whose clusters are all resident at once. Block j takes consecutive
//     whole chunks, [j C / n, (j+1) C / n) of the C = ceil(T / kC);
//   * pass 1, from a zero state: each block walks its chunks, writing its
//     local outputs y_loc (intra-chunk term plus the carry of its own local
//     state L) to y and keeping L in registers; its total decay is the
//     hd-vector delta = exp(cwb_end), cwb the running sum of lw over all its
//     tokens. It leaves L and delta in its shared memory;
//   * a cluster barrier; the states entering the blocks fold in block
//     order, S_0 = S0, S_{i+1} = diag(delta_i) S_i + L_i. The cluster shares
//     the fold through distributed shared memory: each block takes a slice
//     of the state's elements, writes S_i into block i's shared memory and
//     S_n to s_out. Each element is read from S0 and written to s_out by one
//     thread, so s_out may be s0 (the model's decode). A second cluster
//     barrier, then pass 2 adds the carry of the state that entered the
//     block, y_t += (r_t o exp(cwb_{t-1})) S_in, with cwb_{t-1} the block's
//     EXCLUSIVE running sum (0 at its first token): y reads the state before
//     token t. Pass 2 reloads r and lw, which L2 still holds, and recomputes
//     the sums in pass 1's order; the first block of a zero state skips it;
//   * inside a chunk, three block barriers. Each warp loads the chunk's
//     rows with lanes along tokens and hd / 8 channels a lane, so the
//     cumulative sums are warp scans (shuffles) in one fixed order, and each
//     lane forms its token's decayed r and k, the diagonal r u k and the
//     sub-diagonal r_t k_{t-1} (its exponent is exactly 0) at once. Then the
//     warps split: warps 0-3 form A's remaining lower triangle, 2 x 2 per
//     thread, each term with its own exp2 of an exponent <= 0 (so nothing
//     overflows however strong the decay; no factored exp(-cw), TPU kernel
//     :14-17), while warps 4-7 form the carry (r o exp(ce)) L in 4-token by
//     4-column register tiles and update the state held in their registers.
//     The SFU-bound A and the FMA-bound products overlap. After a barrier
//     warps 4-7 add A v and write y. The next chunk's rows are prefetched
//     into L2 while A is formed;
//   * tiles are rows padded to a multiple of 4 floats plus 4, so float4
//     reads of different rows fall on other banks; decays are kept as
//     log2 sums so that every exp is one ex2.
//
// Decode (wkv6_decode_kernel, T = 1 and n_split = 1): a streaming path. One
// block a (b, h); each thread loads its rows of the state straight into
// registers as 16-byte loads, all in flight together, applies S <- diag(w)
// S + k v^T and writes S back from registers. y = r (S_old + diag(u) k v^T)
// reduces over the state's rows (the k-dim): lanes run along v, a warp's
// rows reduce with shuffles and the warps' partials in one small
// shared-memory step.
//
// Chunk-entry states (training): given a pointer (null in serving), each
// block also writes the state entering each of its chunks, (B, H, C, hd,
// hd), which the backward in plain PyTorch reads (rwkv6_scan/ref.py
// wkv6_vjp). Pass 1 stores the block's local state at each chunk's start
// beside the carry's copy in shared memory; a block that a state enters
// (every block but the first of a zero state) adds, in pass 2, the fold's
// correction diag(exp(cwb before the chunk)) S_in, whose decay it has just
// recomputed there. So the states are the true ones at every cluster
// split, and y and the final state stay bit-equal to a launch without the
// pointer: nothing they read changes. The decode path writes S0 (or
// zeros) as its one chunk's state.
//
// Every sum runs in a fixed order (no float atomics): two runs give the
// same bits. r, k, v and lw are read in model layout (B, T, H, hd) through
// their strides (unit stride along hd); y and the state are contiguous. The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns a CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 32;         // tokens per chunk: one warp's lanes in the scan
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;   // blocks per cluster, the portable most
constexpr unsigned kAll = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kATiles = 120;   // 2 x 2 tiles of A strictly below its diagonal 2 x 2 blocks

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The inclusive cumulative sum over a chunk's lanes, in a fixed order.
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kAll, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// N consecutive floats (N = 2, 4 or 8) from global memory: 16- or 8-byte
// loads where the address allows, else scalar.
template <int N>
__device__ __forceinline__ void load_n(const float* __restrict__ p, bool vec, float (&o)[N]) {
  if (vec) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
        o[i] = x.x, o[i + 1] = x.y, o[i + 2] = x.z, o[i + 3] = x.w;
      }
    } else {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p));
      o[0] = x.x, o[1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __ldg(p + i);
  }
}

// N consecutive floats into shared memory (16-byte aligned at N % 4 == 0).
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// N consecutive floats from shared memory.
template <int N>
__device__ __forceinline__ void lds_n(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = ld4(p + i);
      o[i] = x.x, o[i + 1] = x.y, o[i + 2] = x.z, o[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
    o[0] = p[0];
  }
}

template <int HD>
struct Layout {
  static constexpr int CPW = HD / kWarps;          // channels a lane in the chunk loads
  static constexpr int EQ = HD / 4;                // float4 groups along a row
  static constexpr int LD = HD + 4;                // token rows (kC x HD)
  static constexpr int TL = kC + 4;                // (r o exp(ce))^T rows (HD x kC)
  static constexpr int AL = kC + 4;                // A^T rows (kC x kC), [s][t]
  static constexpr int SL = HD + 4;                // state rows (HD x HD), [k][v]
  static constexpr int kR = 0;                     // r; in pass 2 with kK, S_in
  static constexpr int kK = kR + kC * LD;          // k
  static constexpr int kV = kK + kC * LD;          // v
  static constexpr int kCe = kV + kC * LD;         // ce, in log2 units
  static constexpr int kCw = kCe + kC * LD;        // cw, in log2 units
  static constexpr int kKt = kCw + kC * LD;        // k o exp(cw_end - cw)
  static constexpr int kRt = kKt + kC * LD;        // (r o exp(ce))^T
  static constexpr int kA = kRt + HD * TL;         // A^T
  static constexpr int kL = kA + kC * AL;          // L, read by the blocks of the cluster
  static constexpr int kPd = kL + HD * SL;         // per-warp partials of A[t,t]
  static constexpr int kPs = kPd + kWarps * kC;    // per-warp partials of A[t,t-1]
  static constexpr int kTail = kPs + kWarps * kC;  // exp(cw_end) a channel
  static constexpr int kU = kTail + HD;            // u
  static constexpr int kDelta = kU + HD;           // the block's total decay a channel
  static constexpr size_t kBytes = sizeof(float) * (kDelta + HD);
  static_assert(HD * SL <= 2 * kC * LD, "S_in fits where r and k were");
  // warps 4-7: the carry and y, YT tokens x 4 columns a thread; the state,
  // SK rows x 4 columns a thread (HD = 16: half the threads)
  static constexpr int YT = HD / 16 > 0 ? HD / 16 : 1;
  static constexpr int SK = HD * HD / 512 > 0 ? HD * HD / 512 : 1;
  static constexpr int ST_THREADS = HD / SK * EQ;
  // pass 2 on all warps: YT2 tokens x 4 columns a thread
  static constexpr int YT2 = HD / 32 > 0 ? HD / 32 : 1;
  static constexpr int Y2_THREADS = kC / YT2 * EQ;
};

// acc[i][:] += sum_k xt[k][t0 + i] * m[k][4 q ..], xt a (HD x kC) transposed
// token matrix, m a (HD x HD) state: YT tokens x 4 columns of a carry.
template <int HD, int YT, int XL, int ML>
__device__ __forceinline__ void carry_tile(const float* xt, const float* m, int t0, int q,
                                           float (&acc)[YT][4]) {
#pragma unroll 4
  for (int k = 0; k < HD; ++k) {
    const float4 mv = ld4(m + k * ML + 4 * q);
    float xv[YT];
    lds_n<YT>(xt + k * XL + t0, xv);
#pragma unroll
    for (int i = 0; i < YT; ++i) {
      acc[i][0] = fmaf(xv[i], mv.x, acc[i][0]);
      acc[i][1] = fmaf(xv[i], mv.y, acc[i][1]);
      acc[i][2] = fmaf(xv[i], mv.z, acc[i][2]);
      acc[i][3] = fmaf(xv[i], mv.w, acc[i][3]);
    }
  }
}

// Two blocks an SM (128 registers a thread, 84 KB of shared memory at hd =
// 64): an H100 keeps 132 clusters of 2 resident, 62 of 4 and 30 of 8
// (ref.RESIDENT_CLUSTERS, which the card tests check).
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_split_kernel(const float* __restrict__ r, long long r_sb, long long r_st, long long r_sh,
                  const float* __restrict__ k, long long k_sb, long long k_st, long long k_sh,
                  const float* __restrict__ v, long long v_sb, long long v_st, long long v_sh,
                  const float* __restrict__ lw, long long w_sb, long long w_st, long long w_sh,
                  const float* __restrict__ u, const float* s0, float* __restrict__ y,
                  float* s_out, float* __restrict__ chunk_states, int T, int H) {
  using LT = Layout<HD>;
  constexpr int CPW = LT::CPW, EQ = LT::EQ, LD = LT::LD, TL = LT::TL, AL = LT::AL, SL = LT::SL;
  constexpr int YT = LT::YT, SK = LT::SK, YT2 = LT::YT2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* rs = smem + LT::kR;
  float* ks = smem + LT::kK;
  float* vs = smem + LT::kV;
  float* ces = smem + LT::kCe;
  float* cws = smem + LT::kCw;
  float* kts = smem + LT::kKt;
  float* rtt = smem + LT::kRt;
  float* at = smem + LT::kA;
  float* lt = smem + LT::kL;
  float* sin = smem + LT::kR;  // S_in of this block, written by the fold (pass 1 is over)
  float* pds = smem + LT::kPd;
  float* pss = smem + LT::kPs;
  float* tails = smem + LT::kTail;
  float* us = smem + LT::kU;
  float* delta = smem + LT::kDelta;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / n_split, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_chunks = (T + kC - 1) / kC;
  const int c_begin = rank * n_chunks / n_split, c_end = (rank + 1) * n_chunks / n_split;
  const int e0 = warp * CPW;  // the lane's channels in the chunk loop

  const float* rb = r + b * r_sb + h * r_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* wb = lw + b * w_sb + h * w_sh;
  // this sequence's chunk-entry states, (C, HD, HD), or null
  float* csb = chunk_states != nullptr ? chunk_states + static_cast<long long>(bh) * n_chunks * HD * HD
                                       : nullptr;
  const long long y_st = static_cast<long long>(H) * HD;
  float* yb = y + (static_cast<long long>(b) * T * H + h) * HD;  // + t y_st + e
  // 16- or 8-byte loads of a lane's channels where every row allows them
  constexpr int VB = CPW % 4 == 0 ? 16 : 8;
  auto rows_vec = [](const float* p, long long st) {
    return (reinterpret_cast<uintptr_t>(p) % VB == 0) && (st * 4) % VB == 0;
  };
  const bool vr = rows_vec(rb + e0, r_st), vk = rows_vec(kb + e0, k_st);
  const bool vv = rows_vec(vb + e0, v_st), vw = rows_vec(wb + e0, w_st);

  for (int i = tid; i < kC * AL; i += kThreads) at[i] = 0.0f;  // A^T's upper triangle stays 0
  for (int i = tid; i < HD; i += kThreads) us[i] = u[h * HD + i];

  // warps 4-7: y tile (tokens yg YT .., columns 4 yq ..), state tile (rows
  // sg SK .., columns 4 sq ..)
  const int wt = tid - 128;
  const int yq = wt % EQ, yg = wt / EQ;
  const bool st_owner = wt >= 0 && wt < LT::ST_THREADS;
  const int sq = wt % EQ, sg = wt / EQ;
  float st[SK][4];
#pragma unroll
  for (int i = 0; i < SK; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[i][c] = 0.0f;
  // warps 0-3: the A tile (t 2I, 2I+1; s 2J, 2J+1), J < I
  int ti = 1;
  while (ti * (ti + 1) / 2 <= tid) ++ti;
  const int tj = tid - ti * (ti - 1) / 2;

  float run[CPW];  // the block's running sum of lw * log2(e) a channel
#pragma unroll
  for (int j = 0; j < CPW; ++j) run[j] = 0.0f;

  // pass 1: local outputs and state, from zero
  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * kC, n = min(kC, T - t0);
    float rr[CPW], kk[CPW], vvv[CPW], ww[CPW];
    if (lane < n) {
      const long long t = t0 + lane;
      load_n<CPW>(rb + t * r_st + e0, vr, rr);
      load_n<CPW>(kb + t * k_st + e0, vk, kk);
      load_n<CPW>(vb + t * v_st + e0, vv, vvv);
      load_n<CPW>(wb + t * w_st + e0, vw, ww);
    } else {
#pragma unroll
      for (int j = 0; j < CPW; ++j) rr[j] = kk[j] = vvv[j] = ww[j] = 0.0f;
    }
    __syncthreads();  // (a) the previous chunk's readers are done
    {
      float ce[CPW], cw[CPW], rt[CPW], kt[CPW];
      float pd = 0.0f, ps = 0.0f;
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        cw[j] = warp_scan(ww[j] * kLog2e, lane);  // every warp, the same bits
        const float prev = __shfl_up_sync(kAll, cw[j], 1);
        ce[j] = lane > 0 ? prev : 0.0f;
        const float end = __shfl_sync(kAll, cw[j], kC - 1);
        rt[j] = rr[j] * ex2(ce[j]);
        kt[j] = kk[j] * ex2(end - cw[j]);
        if (lane == 0) tails[e0 + j] = ex2(end);
        run[j] += end;
        pd = fmaf(rr[j] * us[e0 + j], kk[j], pd);
        const float kprev = __shfl_up_sync(kAll, kk[j], 1);  // exp(ce[t] - cw[t-1]) = 1 exactly
        ps = fmaf(rr[j], lane > 0 ? kprev : 0.0f, ps);
        rtt[(e0 + j) * TL + lane] = rt[j];
      }
      store_n<CPW>(rs + lane * LD + e0, rr);
      store_n<CPW>(ks + lane * LD + e0, kk);
      store_n<CPW>(vs + lane * LD + e0, vvv);
      store_n<CPW>(ces + lane * LD + e0, ce);
      store_n<CPW>(cws + lane * LD + e0, cw);
      store_n<CPW>(kts + lane * LD + e0, kt);
      pds[warp * kC + lane] = pd;
      pss[warp * kC + lane] = ps;
    }
    if (st_owner) {  // L at the chunk's start, for the carry (and the chunk's state)
#pragma unroll
      for (int i = 0; i < SK; ++i) {
        const float4 l4 = make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
        *reinterpret_cast<float4*>(lt + (sg * SK + i) * SL + 4 * sq) = l4;
        if (csb != nullptr)
          *reinterpret_cast<float4*>(csb + (static_cast<long long>(c) * HD + sg * SK + i) * HD + 4 * sq) = l4;
      }
    }
    __syncthreads();  // (b)

    float acc[YT][4];
    if (warp < 4) {
      if (c + 1 < c_end && lane + kC < T - t0) {  // the next chunk's rows into L2
        const long long t = t0 + kC + lane;
        const float* p = warp == 0 ? rb + t * r_st : warp == 1 ? kb + t * k_st
                       : warp == 2 ? vb + t * v_st : wb + t * w_st;
#pragma unroll
        for (int off = 0; off < HD; off += 32) prefetch_l2(p + off);
      }
      if (tid < kATiles) {  // A[t,s], s < t, off the diagonal 2 x 2 blocks
        const int ta = 2 * ti, sa = 2 * tj;
        float a[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 2
        for (int e = 0; e < HD; e += 4) {
          const float4 r0 = ld4(rs + ta * LD + e), r1 = ld4(rs + (ta + 1) * LD + e);
          const float4 c0 = ld4(ces + ta * LD + e), c1 = ld4(ces + (ta + 1) * LD + e);
          const float4 k0 = ld4(ks + sa * LD + e), k1 = ld4(ks + (sa + 1) * LD + e);
          const float4 w0 = ld4(cws + sa * LD + e), w1 = ld4(cws + (sa + 1) * LD + e);
          const float4 rv[2] = {r0, r1}, cv[2] = {c0, c1}, kv[2] = {k0, k1}, wv[2] = {w0, w1};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              a[i][j] = fmaf(rv[i].x * kv[j].x, ex2(cv[i].x - wv[j].x), a[i][j]);
              a[i][j] = fmaf(rv[i].y * kv[j].y, ex2(cv[i].y - wv[j].y), a[i][j]);
              a[i][j] = fmaf(rv[i].z * kv[j].z, ex2(cv[i].z - wv[j].z), a[i][j]);
              a[i][j] = fmaf(rv[i].w * kv[j].w, ex2(cv[i].w - wv[j].w), a[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) at[(sa + j) * AL + ta + i] = a[i][j];
      } else {  // the diagonal and the sub-diagonal of the diagonal blocks
        for (int t = 4 * (tid - kATiles); t < 4 * (tid - kATiles) + 4; ++t) {
          float d = 0.0f, o = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            d += pds[w * kC + t];
            o += pss[w * kC + t];
          }
          at[t * AL + t] = d;
          if (t & 1) at[(t - 1) * AL + t] = o;
        }
      }
    } else {
      // the carry (r o exp(ce)) L of the block's own state, then the state
      // update in registers
#pragma unroll
      for (int i = 0; i < YT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
      if (c > c_begin) carry_tile<HD, YT, TL, SL>(rtt, lt, yg * YT, yq, acc);
      if (st_owner) {
#pragma unroll
        for (int i = 0; i < SK; ++i) {
          const float tl = tails[sg * SK + i];
#pragma unroll
          for (int q = 0; q < 4; ++q) st[i][q] *= tl;
        }
        for (int s = 0; s < n; ++s) {
          const float4 vq = ld4(vs + s * LD + 4 * sq);
          float kv[SK];
          lds_n<SK>(kts + s * LD + sg * SK, kv);
#pragma unroll
          for (int i = 0; i < SK; ++i) {
            st[i][0] = fmaf(kv[i], vq.x, st[i][0]);
            st[i][1] = fmaf(kv[i], vq.y, st[i][1]);
            st[i][2] = fmaf(kv[i], vq.z, st[i][2]);
            st[i][3] = fmaf(kv[i], vq.w, st[i][3]);
          }
        }
      }
    }
    __syncthreads();  // (c) A is complete
    if (warp >= 4) {  // y = carry + A v, for the tile's tokens
      const int ty = yg * YT;
      const int t_hi = min(ty + YT - 1, n - 1);  // A^T is zero above each token
#pragma unroll 4
      for (int s = 0; s <= t_hi; ++s) {
        const float4 vq = ld4(vs + s * LD + 4 * yq);
        float av[YT];
        lds_n<YT>(at + s * AL + ty, av);
#pragma unroll
        for (int i = 0; i < YT; ++i) {
          acc[i][0] = fmaf(av[i], vq.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], vq.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], vq.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], vq.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < YT; ++i)
        if (ty + i < n)
          *reinterpret_cast<float4*>(yb + (t0 + ty + i) * y_st + 4 * yq) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  // L and delta for the fold (the last readers of lt were before (c))
  if (st_owner) {
#pragma unroll
    for (int i = 0; i < SK; ++i)
      *reinterpret_cast<float4*>(lt + (sg * SK + i) * SL + 4 * sq) =
          make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < CPW; ++j) delta[e0 + j] = ex2(run[j]);
  }

  // the states entering the blocks, in block order: S_0 = S0, S_{i+1} =
  // diag(delta_i) S_i + L_i. Block r takes every n_split-th float4 of the
  // state, reads each block's L_i and delta_i through distributed shared
  // memory, writes S_i into block i's sin and the final state to s_out.
  // Each element is read from S0 and written to s_out by one thread.
  cluster.sync();
  for (int j = rank * kThreads + tid; j < HD * EQ; j += n_split * kThreads) {
    const int kr = j / EQ, e = 4 * (j % EQ);
    float dl[kMaxSplit];
    float4 lv[kMaxSplit];
#pragma unroll
    for (int i = 0; i < kMaxSplit; ++i) {
      if (i < n_split) {
        dl[i] = cluster.map_shared_rank(delta, i)[kr];
        lv[i] = ld4(cluster.map_shared_rank(lt, i) + kr * SL + e);
      }
    }
    const long long g = (static_cast<long long>(bh) * HD + kr) * HD + e;
    float4 sv = s0 != nullptr ? make_float4(s0[g], s0[g + 1], s0[g + 2], s0[g + 3])
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kMaxSplit; ++i) {
      if (i < n_split) {
        *reinterpret_cast<float4*>(cluster.map_shared_rank(sin, i) + kr * SL + e) = sv;
        sv.x = fmaf(dl[i], sv.x, lv[i].x);
        sv.y = fmaf(dl[i], sv.y, lv[i].y);
        sv.z = fmaf(dl[i], sv.z, lv[i].z);
        sv.w = fmaf(dl[i], sv.w, lv[i].w);
      }
    }
    s_out[g] = sv.x;
    s_out[g + 1] = sv.y;
    s_out[g + 2] = sv.z;
    s_out[g + 3] = sv.w;
  }
  cluster.sync();  // every block's sin is complete; no block leaves while another reads it
  if (rank == 0 && s0 == nullptr) return;  // nothing enters the first block

  // pass 2: y_t += (r_t o exp(cwb_{t-1})) S_in, cwb_{t-1} the block's
  // exclusive running sum, recomputed in pass 1's order
  const int q2 = tid % EQ, g2 = tid / EQ;
#pragma unroll
  for (int j = 0; j < CPW; ++j) run[j] = 0.0f;
  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * kC, n = min(kC, T - t0);
    float rr[CPW], ww[CPW];
    if (lane < n) {
      const long long t = t0 + lane;
      load_n<CPW>(rb + t * r_st + e0, vr, rr);
      load_n<CPW>(wb + t * w_st + e0, vw, ww);
    } else {
#pragma unroll
      for (int j = 0; j < CPW; ++j) rr[j] = ww[j] = 0.0f;
    }
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const float cw = warp_scan(ww[j] * kLog2e, lane);
      const float prev = __shfl_up_sync(kAll, cw, 1);
      const float ce = lane > 0 ? prev : 0.0f;
      rtt[(e0 + j) * TL + lane] = rr[j] * ex2(run[j] + ce);
      if (lane == 0) tails[e0 + j] = ex2(run[j]);  // the decay from S_in to the chunk's start
      run[j] += __shfl_sync(kAll, cw, kC - 1);
    }
    __syncthreads();
    if (csb != nullptr) {  // the chunk's state: the local one pass 1 wrote, plus diag(decay) S_in
      float* cs = csb + static_cast<long long>(c) * HD * HD;
      for (int j = tid; j < HD * EQ; j += kThreads) {
        const int kr = j / EQ, e = 4 * (j % EQ);
        const float dk = tails[kr];
        const float4 sv = ld4(sin + kr * SL + e);
        float4* dst = reinterpret_cast<float4*>(cs + kr * HD + e);
        const float4 lv = *dst;
        *dst = make_float4(fmaf(dk, sv.x, lv.x), fmaf(dk, sv.y, lv.y), fmaf(dk, sv.z, lv.z),
                           fmaf(dk, sv.w, lv.w));
      }
    }
    if (tid < LT::Y2_THREADS) {
      const int ty = g2 * YT2;
      float a2[YT2][4];
      float4 yv[YT2];  // pass 1's outputs, read before the products
#pragma unroll
      for (int i = 0; i < YT2; ++i) {
        if (ty + i < n) yv[i] = *reinterpret_cast<const float4*>(yb + (t0 + ty + i) * y_st + 4 * q2);
#pragma unroll
        for (int q = 0; q < 4; ++q) a2[i][q] = 0.0f;
      }
      carry_tile<HD, YT2, TL, SL>(rtt, sin, ty, q2, a2);
#pragma unroll
      for (int i = 0; i < YT2; ++i)
        if (ty + i < n)
          *reinterpret_cast<float4*>(yb + (t0 + ty + i) * y_st + 4 * q2) =
              make_float4(yv[i].x + a2[i][0], yv[i].y + a2[i][1], yv[i].z + a2[i][2],
                          yv[i].w + a2[i][3]);
    }
  }
}

// T = 1: one block a (b, h), the state streamed through registers.
template <int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_decode_kernel(const float* __restrict__ r, long long r_sb, long long r_sh,
                   const float* __restrict__ k, long long k_sb, long long k_sh,
                   const float* __restrict__ v, long long v_sb, long long v_sh,
                   const float* __restrict__ lw, long long w_sb, long long w_sh,
                   const float* __restrict__ u, const float* s0, float* __restrict__ y,
                   float* s_out, float* __restrict__ chunk_states, int H) {
  constexpr int NG = HD / 4;                // lanes a row, float4 each
  constexpr int RPP = kThreads / NG;        // rows a pass of the block
  constexpr int RI = (HD + RPP - 1) / RPP;  // rows a thread
  __shared__ float4 red[kWarps][NG];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = tid % NG, r0 = tid / NG;
  const long long base = static_cast<long long>(bh) * HD * HD;
  // every load before the first store: s_out may be s0, so a load placed
  // after a store could not be moved ahead of it
  float4 s[RI];
  float rv[RI], kv[RI], wv[RI], uv[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + RPP * i;
    const bool ok = row < HD;
    s[i] = (s0 != nullptr && ok) ? ld4(s0 + base + row * HD + 4 * g) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    rv[i] = ok ? r[b * r_sb + h * r_sh + row] : 0.0f;
    kv[i] = ok ? k[b * k_sb + h * k_sh + row] : 0.0f;
    wv[i] = ok ? lw[b * w_sb + h * w_sh + row] : 0.0f;
    uv[i] = ok ? u[h * HD + row] : 0.0f;
  }
  const float* vp = v + b * v_sb + h * v_sh + 4 * g;
  const float4 vq = make_float4(vp[0], vp[1], vp[2], vp[3]);
  float4 part = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + RPP * i;
    const float ukr = uv[i] * kv[i];
    const float4 so = s[i];
    part.x = fmaf(rv[i], fmaf(ukr, vq.x, so.x), part.x);
    part.y = fmaf(rv[i], fmaf(ukr, vq.y, so.y), part.y);
    part.z = fmaf(rv[i], fmaf(ukr, vq.z, so.z), part.z);
    part.w = fmaf(rv[i], fmaf(ukr, vq.w, so.w), part.w);
    const float w = expf(wv[i]);
    if (row < HD) {
      *reinterpret_cast<float4*>(s_out + base + row * HD + 4 * g) =
          make_float4(fmaf(w, so.x, kv[i] * vq.x), fmaf(w, so.y, kv[i] * vq.y),
                      fmaf(w, so.z, kv[i] * vq.z), fmaf(w, so.w, kv[i] * vq.w));
      if (chunk_states != nullptr)  // one chunk: the state entering it
        *reinterpret_cast<float4*>(chunk_states + base + row * HD + 4 * g) = so;
    }
  }
#pragma unroll
  for (int off = NG; off < 32; off <<= 1) {
    part.x += __shfl_xor_sync(kAll, part.x, off);
    part.y += __shfl_xor_sync(kAll, part.y, off);
    part.z += __shfl_xor_sync(kAll, part.z, off);
    part.w += __shfl_xor_sync(kAll, part.w, off);
  }
  if (lane < NG) red[warp][lane] = part;
  __syncthreads();
  if (tid < HD) {
    const float* rf = reinterpret_cast<const float*>(red);
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += rf[w * HD + tid];
    y[static_cast<long long>(bh) * HD + tid] = acc;
  }
}

template <int HD>
int launch(const float* r, const long long* rs, const float* k, const long long* ks,
           const float* v, const long long* vs, const float* lw, const long long* ws,
           const float* u, const float* s0, float* y, float* s_out, float* chunk_states, int b,
           int t, int h, int n_split, cudaStream_t stream) {
  if (t == 1 && n_split == 1) {
    wkv6_decode_kernel<HD><<<b * h, kThreads, 0, stream>>>(r, rs[0], rs[2], k, ks[0], ks[2], v,
                                                           vs[0], vs[2], lw, ws[0], ws[2], u, s0,
                                                           y, s_out, chunk_states, h);
    return static_cast<int>(cudaGetLastError());
  }
  auto kern = wkv6_split_kernel<HD>;
  const size_t smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split * b * h);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, r, rs[0], rs[1], rs[2], k, ks[0], ks[1], ks[2], v, vs[0],
                           vs[1], vs[2], lw, ws[0], ws[1], ws[2], u, s0, y, s_out, chunk_states, t,
                           h);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int max_clusters(int n_split, int* out) {
  auto kern = wkv6_split_kernel<HD>;
  const size_t smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kern, &cfg));
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r, k, v, lw (B, T, H, hd) f32, each with element strides {batch, token,
// head} and unit stride along hd; u (H, hd) f32 contiguous; s0 (B, H, hd,
// hd) f32 contiguous and 16-byte aligned, or null for a zero state; y (B, T,
// H, hd) and s_out (B, H, hd, hd) f32 contiguous. s_out may be s0.
// chunk_states, null or (B, H, C, hd, hd) f32 contiguous with C = ceil(T /
// 32): the state entering each chunk. hd 16, 32 or 64; n_split, the blocks
// of a cluster each sequence is split over, 1 to 8 (T = 1 with n_split = 1
// takes the decode path). Returns a CUDA error code (cudaErrorInvalidValue
// for an hd not built or a split outside 1..8).
int wkv6_forward(const float* r, const long long* r_strides, const float* k,
                 const long long* k_strides, const float* v, const long long* v_strides,
                 const float* lw, const long long* lw_strides, const float* u, const float* s0,
                 float* y, float* s_out, float* chunk_states, int b, int t, int h, int hd,
                 int n_split, void* stream) {
  if (n_split < 1 || n_split > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WKV_ARGS r, r_strides, k, k_strides, v, v_strides, lw, lw_strides, u, s0, y, s_out, \
                 chunk_states, b, t, h, n_split, st
  if (hd == 16) return launch<16>(WKV_ARGS);
  if (hd == 32) return launch<32>(WKV_ARGS);
  if (hd == 64) return launch<64>(WKV_ARGS);
#undef WKV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of n_split prefill blocks at head_dim hd the card keeps
// resident at once (cudaOccupancyMaxActiveClusters), into *out; a CUDA
// error code.
int wkv6_max_active_clusters(int hd, int n_split, int* out) {
  if (n_split < 1 || n_split > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 16) return max_clusters<16>(n_split, out);
  if (hd == 32) return max_clusters<32>(n_split, out);
  if (hd == 64) return max_clusters<64>(n_split, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
