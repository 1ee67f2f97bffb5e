// Chunked Mamba2 SSD scan for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernel ssd_chunked_kernel
// (src/repro/kernels/mamba2_scan/kernel.py:76, body _kernel :29-73). Per
// (batch b, head h), over the steps of a sequence, with a scalar decay
// dt_t * A_h <= 0 per step:
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T        S: (P, N)
//   y_t = S_t C_t + D x_t
//
// computed chunk by chunk in the TPU kernel's closed form. Within a chunk
// of n <= kC steps, with cw the inclusive cumulative sum of dt * A:
//
//   G[t,s] = exp(cw[t] - cw[s]) dt[s]                  (s <= t)
//   y      = ((C B^T) o G) x + exp(cw) o (C S_in^T) + D x
//   S_out  = exp(cw[n-1]) S_in + (x o (exp(cw[n-1] - cw) dt))^T B
//
// What bounds it: at zamba2-1.2b's prefill (one prompt of T = 512, 64
// heads, P = N = 64) operations. The call reads x and writes y (17 MB in
// f32), reads dt, B and C (0.4 MB) and writes the 1 MB state: some 5 us at
// 3.35 TB/s, against some 0.6 GFLOP of f32 work in this closed form, most
// of it the carried state's products (9 us at 67 TFLOP/s on the CUDA
// cores). At decode (8 slots, T = 1) bytes: it reads and writes the 8 MB
// state, 5 us.
//
// Prefill (ssd_split_kernel), the design:
//   * each sequence is split across the blocks of a thread-block cluster:
//     a grid of n_split * B * H blocks along x (as many as a grid takes),
//     the n_split consecutive blocks of one (b, h) one cluster.
//     The caller passes n_split (1 to the portable 8), which the wrapper
//     computes from shapes alone (ref.split_count): the most whose
//     clusters are all resident at once, as a cluster left for a second
//     wave waits a whole block's time; at T = 512 and 64 heads, 2, so 128
//     blocks where one block a (b, h) gave 64 on 132 SMs.
//     Block j takes consecutive whole chunks, [j C / n, (j+1) C / n) of the
//     C = ceil(T / kC), so the work of one sequence runs side by side;
//   * pass 1, from a zero state: each block walks its chunks, forming its
//     local outputs y_loc (the intra-chunk term, the carry of its own local
//     state L and D x, written to y) and its local state L <- exp(cw_end) L
//     + dS, held in registers, and its total decay delta = exp(cwb_end),
//     cwb the running sum of dt A over all its steps. It leaves L (as L^T)
//     and delta in its shared memory;
//   * a cluster barrier; then the states entering the blocks, in block
//     order, S_0 = S0 and S_{i+1} = delta_i S_i + L_i (every exponent still
//     <= 0). The cluster shares this fold: each block takes a slice of the
//     state's elements, reads every block's L_i and delta_i through
//     distributed shared memory, writes S_i into block i's shared memory
//     and the final state S_n to s_out. Each element is read from S0 and
//     written to s_out by one thread, so s_out may be s0 (the model's
//     decode). A second cluster barrier: no block leaves while another
//     reads or writes its shared memory;
//   * pass 2: each block adds the carry of the state that entered it,
//     y += diag(exp(cwb)) C S^T, to the outputs it wrote (the first block
//     of a zero state skips it). It reloads C and dt, which L2 still holds,
//     and recomputes cwb in pass 1's order, so no per-chunk state is kept;
//   * the products stay f32 on the CUDA cores, register-tiled: a thread
//     owns 2 x 2 of the Gram matrix C B^T, 2 steps x 4 columns of y (the
//     intra-chunk and carry products in one loop, one float4 of x or L^T
//     serving both steps) and 4 x 4 of the state update (x and B read as
//     float4), from shared memory rows padded to a multiple of 4 floats
//     plus 4, so that rows fall on other banks; L is kept transposed
//     (L^T[e][p]) so the carry and the fold read float4 along p;
//   * each chunk's x, B, C and dt are loaded into registers, all loads of a
//     thread in flight together, before the barrier that lets them into
//     shared memory; the cumulative sum of a chunk is a warp scan
//     (shuffles), taken by every warp in the same order.
//
// Decode (ssd_decode_kernel, T = 1 and n_split = 1): a streaming path. One
// block a (b, h); each thread loads its rows of the state straight into
// registers as 16-byte loads, all of them in flight together, applies
// S <- exp(dt A) S + dt x_p B^T, writes S back from registers, and reduces
// y_p = S_p . C over the row's lanes with a butterfly of shuffles, plus
// D x_p. No shared memory and no chunk machinery.
//
// Chunk-entry states (training): given a pointer (null in serving), each
// block also writes the state entering each of its chunks, (B, H, C, P,
// N), which the backward in plain PyTorch reads (mamba2_scan/ref.py
// ssd_vjp). Pass 1 copies its local state L (kept as L^T in shared memory
// for the carry) at each chunk's start; a block that a state enters (every
// block but the first of a zero state) adds, in pass 2, the fold's
// correction exp(cwb before the chunk) S_in. So the states are the true
// ones at every cluster split, and y and the final state stay bit-equal to
// a launch without the pointer. The decode path writes S0 (or zeros) as
// its one chunk's state.
//
// Every sum runs in a fixed order (no float atomics): two runs give the
// same bits. x, dt, B and C are read in model layout through their strides
// (unit stride along P and N); y and the state are contiguous. The entry
// point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns a CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 32;         // steps per chunk: one warp's lanes in the scan
constexpr int kThreads = 256;
constexpr int kMaxSplit = 8;   // blocks per cluster, the portable most
constexpr unsigned kAll = 0xffffffffu;

// Rows t0..t0+n-1 of a kC x W tile (zero past n, row stride ld) into
// registers: every load of the thread in flight together.
template <int W>
struct TileRegs {
  static constexpr int R = kC * W / kThreads;
  float v[R];
  __device__ __forceinline__ void load(const float* __restrict__ src, long long ld, int n, int tid) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = tid + k * kThreads, t = i / W;
      v[k] = t < n ? src[t * ld + i % W] : 0.0f;
    }
  }
  template <int LD>
  __device__ __forceinline__ void store(float* dst, int tid) const {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = tid + k * kThreads;
      dst[(i / W) * LD + i % W] = v[k];
    }
  }
};

template <int P, int N>
struct Layout {
  static constexpr int XL = P + 4;    // x rows (kC x P)
  static constexpr int NL = N + 4;    // B and C rows (kC x N)
  static constexpr int ML = kC + 4;   // (C B^T) o G rows (kC x kC)
  static constexpr int SL = P + 4;    // L^T and S_in^T rows (N x P)
  static constexpr int kX = 0;
  static constexpr int kB = kX + kC * XL;
  static constexpr int kCm = kB + kC * NL;
  static constexpr int kM = kCm + kC * NL;
  static constexpr int kL = kM + kC * ML;
  static constexpr int kS = kL + N * SL;
  static constexpr int kE = kS + N * SL;  // exp(cw) a step, or exp(cwb) in pass 2
  static constexpr int kW = kE + kC;      // exp(cw_end - cw) dt a step
  static constexpr int kMisc = kW + kC;   // [0] = the block's total decay
  static constexpr size_t kBytes = sizeof(float) * (kMisc + 4);
  // thread tiles
  static constexpr int PG = P / 4;                   // float4 groups along p
  static constexpr int YT = kThreads / PG;           // y: threads along t
  static constexpr int RT = (kC + YT - 1) / YT;      // y: steps a thread
  static constexpr int ST = kThreads / PG;           // state: threads along e
  static constexpr int RE = (N + ST - 1) / ST;       // state: e a thread
};

// The inclusive cumulative sum over a chunk's lanes, in a fixed order.
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kAll, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Two blocks an SM (128 registers a thread): an H100 keeps 132 clusters
// of 2 resident, 62 of 4 and 30 of 8 (ref.RESIDENT_CLUSTERS, which the
// card tests check). Three blocks an SM (85 registers) keep more resident
// but spill more, and ran slower there.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_split_kernel(const float* __restrict__ x, long long x_sb, long long x_st, long long x_sh,
                 const float* __restrict__ dt, long long d_sb, long long d_st, long long d_sh,
                 const float* __restrict__ bm, long long b_sb, long long b_st,
                 const float* __restrict__ cm, long long c_sb, long long c_st,
                 const float* __restrict__ a_log_decay, const float* __restrict__ dskip,
                 const float* s0, float* __restrict__ y, float* s_out,
                 float* __restrict__ chunk_states, int T, int H) {
  using LT = Layout<P, N>;
  constexpr int XL = LT::XL, NL = LT::NL, ML = LT::ML, SL = LT::SL;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + LT::kX;
  float* bs = smem + LT::kB;
  float* cs = smem + LT::kCm;
  float* ms = smem + LT::kM;
  float* lt = smem + LT::kL;    // L^T, read by the blocks of the cluster
  float* sint = smem + LT::kS;  // S_in^T of this block, written by the fold
  float* ecw = smem + LT::kE;
  float* wts = smem + LT::kW;
  float* misc = smem + LT::kMisc;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / n_split, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32;
  const float a = a_log_decay[h], d = dskip[h];
  const int n_chunks = (T + kC - 1) / kC;
  const int c_begin = rank * n_chunks / n_split, c_end = (rank + 1) * n_chunks / n_split;

  // tiles: Gram (t in {gt, gt+16}, s in {gs, gs+16}); y (steps yt + YT i,
  // columns 4 yp..); state (columns 4 sp.. of p, rows se RE .. se RE + RE-1 of e)
  const int gt = tid / 16, gs = tid % 16;
  const int yp = tid % LT::PG, yt = tid / LT::PG;
  const int sp = tid % LT::PG, se = tid / LT::PG;
  float st[LT::RE][4];
#pragma unroll
  for (int i = 0; i < LT::RE; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[i][c] = 0.0f;
  for (int i = tid; i < N * SL; i += kThreads) lt[i] = 0.0f;

  const float* xb = x + b * x_sb + h * x_sh;
  const float* db = dt + b * d_sb + h * d_sh;
  const float* bb = bm + b * b_sb;
  const float* cb = cm + b * c_sb;
  float* yb = y + (static_cast<long long>(b) * T * H + h) * P;  // + (t H) P + p
  const long long y_st = static_cast<long long>(H) * P;
  // this sequence's chunk-entry states, (C, P, N), or null
  float* csb = chunk_states != nullptr ? chunk_states + static_cast<long long>(bh) * n_chunks * P * N
                                       : nullptr;

  // pass 1: local outputs and state, from zero
  float run = 0.0f;  // cwb before the chunk
  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * kC, n = min(kC, T - t0);
    TileRegs<P> xr;
    TileRegs<N> br, cr;
    xr.load(xb + t0 * x_st, x_st, n, tid);
    br.load(bb + t0 * b_st, b_st, n, tid);
    cr.load(cb + t0 * c_st, c_st, n, tid);
    const float dtl = lane < n ? db[(t0 + lane) * d_st] : 0.0f;
    __syncthreads();  // the previous chunk's readers are done
    xr.template store<XL>(xs, tid);
    br.template store<NL>(bs, tid);
    cr.template store<NL>(cs, tid);
    if (csb != nullptr) {  // L at the chunk's start (L^T is stable until this chunk's last barrier)
      float* dst = csb + static_cast<long long>(c) * P * N;
      for (int j = tid; j < P * N; j += kThreads) dst[j] = lt[(j % N) * SL + j / N];
    }
    const float cw = warp_scan(dtl * a, lane);  // every warp, the same bits
    const float cw_end = __shfl_sync(kAll, cw, kC - 1);
    if (tid < kC) {
      ecw[lane] = expf(cw);
      wts[lane] = expf(cw_end - cw) * dtl;
    }
    __syncthreads();
    {  // (C B^T) o G, lower triangle, zero elsewhere
      float g[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
      for (int e = 0; e < N; e += 4) {
        const float4 c0 = ld4(cs + gt * NL + e), c1 = ld4(cs + (gt + 16) * NL + e);
        const float4 b0 = ld4(bs + gs * NL + e), b1 = ld4(bs + (gs + 16) * NL + e);
        g[0][0] = dot4(c0, b0, g[0][0]);
        g[0][1] = dot4(c0, b1, g[0][1]);
        g[1][0] = dot4(c1, b0, g[1][0]);
        g[1][1] = dot4(c1, b1, g[1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = gt + 16 * i, s = gs + 16 * j;
          const float cwt = __shfl_sync(kAll, cw, t), cws = __shfl_sync(kAll, cw, s);
          const float dts = __shfl_sync(kAll, dtl, s);
          ms[t * ML + s] = (s <= t && t < n) ? g[i][j] * (expf(cwt - cws) * dts) : 0.0f;
        }
    }
    __syncthreads();
    // y_loc = ((C B^T) o G) x + exp(cw) (C L^T) + D x for the thread's RT
    // steps together (one float4 of x or L^T serves them all), then the
    // state's dS
    {
      float intra[LT::RT][4], carry[LT::RT][4];
#pragma unroll
      for (int i = 0; i < LT::RT; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) intra[i][k] = carry[i][k] = 0.0f;
      const int t_hi = min(yt + LT::YT * (LT::RT - 1), n - 1);  // M is zero past each step
#pragma unroll 4
      for (int s = 0; s <= t_hi; ++s) {
        const float4 xv = ld4(xs + s * XL + 4 * yp);
#pragma unroll
        for (int i = 0; i < LT::RT; ++i) fma4(intra[i], ms[(yt + LT::YT * i) % kC * ML + s], xv);
      }
      if (c > c_begin) {
#pragma unroll 4
        for (int e = 0; e < N; ++e) {
          const float4 lv = ld4(lt + e * SL + 4 * yp);
#pragma unroll
          for (int i = 0; i < LT::RT; ++i) fma4(carry[i], cs[(yt + LT::YT * i) % kC * NL + e], lv);
        }
      }
#pragma unroll
      for (int i = 0; i < LT::RT; ++i) {
        const int t = yt + LT::YT * i;
        if (t >= n) continue;
        const float4 xv = ld4(xs + t * XL + 4 * yp);
        const float et = ecw[t];
        float4 out;
        out.x = intra[i][0] + et * carry[i][0] + d * xv.x;
        out.y = intra[i][1] + et * carry[i][1] + d * xv.y;
        out.z = intra[i][2] + et * carry[i][2] + d * xv.z;
        out.w = intra[i][3] + et * carry[i][3] + d * xv.w;
        *reinterpret_cast<float4*>(yb + (t0 + t) * y_st + 4 * yp) = out;
      }
    }
    float ds[LT::RE][4];
#pragma unroll
    for (int i = 0; i < LT::RE; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) ds[i][k] = 0.0f;
    for (int s = 0; s < n; ++s) {
      const float w = wts[s];
      const float4 xv = ld4(xs + s * XL + 4 * sp);
      const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
      float bv[LT::RE];
      if constexpr (LT::RE == 4) {
        const float4 b4 = ld4(bs + s * NL + 4 * se);
        bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
      } else {
#pragma unroll
        for (int i = 0; i < LT::RE; ++i) bv[i] = se * LT::RE + i < N ? bs[s * NL + se * LT::RE + i] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < LT::RE; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) ds[i][k] = fmaf(xw[k], bv[i], ds[i][k]);
    }
    __syncthreads();  // every reader of L^T and of this chunk's tiles is done
    const float decay = expf(cw_end);
#pragma unroll
    for (int i = 0; i < LT::RE; ++i) {
      const int e = se * LT::RE + i;
      if (e < N) {
#pragma unroll
        for (int k = 0; k < 4; ++k) st[i][k] = fmaf(decay, st[i][k], ds[i][k]);
        *reinterpret_cast<float4*>(lt + e * SL + 4 * sp) = make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
      }
    }
    run += cw_end;
  }
  if (tid == 0) misc[0] = expf(run);

  // the states entering the blocks, in block order: S_0 = S0, S_{i+1} =
  // delta_i S_i + L_i. The cluster shares the work: block r takes every
  // n_split-th float4 of the state, reads each block's L_i and delta_i
  // through distributed shared memory, writes S_i into block i's sint and
  // the final state S_n to s_out. Each element is read from S0 and written
  // to s_out by one thread, so s_out may be S0.
  cluster.sync();
  {
    float dl[kMaxSplit];
#pragma unroll
    for (int i = 0; i < kMaxSplit; ++i) dl[i] = i < n_split ? *cluster.map_shared_rank(misc, i) : 0.0f;
    for (int j = rank * kThreads + tid; j < N * LT::PG; j += n_split * kThreads) {
      const int e = j / LT::PG, p = 4 * (j % LT::PG);
      float4 lv[kMaxSplit];
#pragma unroll
      for (int i = 0; i < kMaxSplit; ++i)
        if (i < n_split) lv[i] = ld4(cluster.map_shared_rank(lt, i) + e * SL + p);
      const long long g = (static_cast<long long>(bh) * P + p) * N + e;
      float4 sv = s0 != nullptr ? make_float4(s0[g], s0[g + N], s0[g + 2 * N], s0[g + 3 * N])
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < kMaxSplit; ++i) {
        if (i < n_split) {
          *reinterpret_cast<float4*>(cluster.map_shared_rank(sint, i) + e * SL + p) = sv;
          sv.x = fmaf(dl[i], sv.x, lv[i].x);
          sv.y = fmaf(dl[i], sv.y, lv[i].y);
          sv.z = fmaf(dl[i], sv.z, lv[i].z);
          sv.w = fmaf(dl[i], sv.w, lv[i].w);
        }
      }
      s_out[g] = sv.x;
      s_out[g + N] = sv.y;
      s_out[g + 2 * N] = sv.z;
      s_out[g + 3 * N] = sv.w;
    }
  }
  cluster.sync();  // every block's sint is complete; no block leaves while another reads it
  if (rank == 0 && s0 == nullptr) return;  // nothing enters the first block

  // pass 2: y += exp(cwb) o (C S_in^T)
  run = 0.0f;
  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * kC, n = min(kC, T - t0);
    TileRegs<N> cr;
    cr.load(cb + t0 * c_st, c_st, n, tid);
    const float dtl = lane < n ? db[(t0 + lane) * d_st] : 0.0f;
    __syncthreads();
    cr.template store<NL>(cs, tid);
    const float cw = warp_scan(dtl * a, lane);
    if (tid < kC) ecw[lane] = expf(run + cw);
    const float to_chunk = expf(run);  // the decay from S_in to the chunk's start
    run += __shfl_sync(kAll, cw, kC - 1);
    __syncthreads();
    if (csb != nullptr) {  // the chunk's state: the local one pass 1 wrote, plus decay x S_in
      float* dst = csb + static_cast<long long>(c) * P * N;
      for (int j = tid; j < P * N; j += kThreads) dst[j] = fmaf(to_chunk, sint[(j % N) * SL + j / N], dst[j]);
    }
    float carry[LT::RT][4];
    float4 yv[LT::RT];  // pass 1's outputs, read before the products
#pragma unroll
    for (int i = 0; i < LT::RT; ++i) {
      const int t = yt + LT::YT * i;
      if (t < n) yv[i] = *reinterpret_cast<const float4*>(yb + (t0 + t) * y_st + 4 * yp);
#pragma unroll
      for (int k = 0; k < 4; ++k) carry[i][k] = 0.0f;
    }
#pragma unroll 4
    for (int e = 0; e < N; ++e) {
      const float4 sv = ld4(sint + e * SL + 4 * yp);
#pragma unroll
      for (int i = 0; i < LT::RT; ++i) fma4(carry[i], cs[(yt + LT::YT * i) % kC * NL + e], sv);
    }
#pragma unroll
    for (int i = 0; i < LT::RT; ++i) {
      const int t = yt + LT::YT * i;
      if (t >= n) continue;
      float4* yo = reinterpret_cast<float4*>(yb + (t0 + t) * y_st + 4 * yp);
      float4 v = yv[i];
      const float et = ecw[t];
      v.x = fmaf(et, carry[i][0], v.x);
      v.y = fmaf(et, carry[i][1], v.y);
      v.z = fmaf(et, carry[i][2], v.z);
      v.w = fmaf(et, carry[i][3], v.w);
      *yo = v;
    }
  }
}

// T = 1: one block a (b, h), the state streamed through registers.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_decode_kernel(const float* __restrict__ x, long long x_sb, long long x_sh,
                  const float* __restrict__ dt, long long d_sb, long long d_sh,
                  const float* __restrict__ bm, long long b_sb,
                  const float* __restrict__ cm, long long c_sb,
                  const float* __restrict__ a_log_decay, const float* __restrict__ dskip,
                  const float* s0, float* __restrict__ y, float* s_out,
                  float* __restrict__ chunk_states, int H) {
  constexpr int NG = N / 4;                 // lanes a row, float4 each
  constexpr int RPP = kThreads / NG;        // rows a pass of the block
  constexpr int RI = (P + RPP - 1) / RPP;   // rows a thread
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, g = tid % NG, r0 = tid / NG;
  const long long base = static_cast<long long>(bh) * P * N;
  // every load before the first store: s_out may be s0, so a load placed
  // after a store could not be moved ahead of it
  const float* xb = x + b * x_sb + h * x_sh;
  float4 s[RI];
  float xr[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int p = r0 + RPP * i;
    s[i] = (s0 != nullptr && p < P) ? ld4(s0 + base + p * N + 4 * g) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    xr[i] = p < P ? xb[p] : 0.0f;
  }
  const float dtv = dt[b * d_sb + h * d_sh];
  const float decay = expf(dtv * a_log_decay[h]), dsk = dskip[h];
  const float* bb = bm + b * b_sb + 4 * g;
  const float* cb = cm + b * c_sb + 4 * g;
  const float4 bv = make_float4(bb[0], bb[1], bb[2], bb[3]);
  const float4 cv = make_float4(cb[0], cb[1], cb[2], cb[3]);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int p = r0 + RPP * i;
    const float xp = xr[i];
    const float u = dtv * xp;
    float4 v = s[i];
    v.x = fmaf(decay, v.x, u * bv.x);
    v.y = fmaf(decay, v.y, u * bv.y);
    v.z = fmaf(decay, v.z, u * bv.z);
    v.w = fmaf(decay, v.w, u * bv.w);
    float part = dot4(v, cv, 0.0f);
#pragma unroll
    for (int off = 1; off < NG; off <<= 1) part += __shfl_xor_sync(kAll, part, off);
    if (p < P) {
      if (chunk_states != nullptr)  // one chunk: the state entering it
        *reinterpret_cast<float4*>(chunk_states + base + p * N + 4 * g) = s[i];
      *reinterpret_cast<float4*>(s_out + base + p * N + 4 * g) = v;
      if (g == 0) y[static_cast<long long>(bh) * P + p] = fmaf(dsk, xp, part);
    }
  }
}

template <int P, int N>
int launch(const float* x, const long long* xs, const float* dt, const long long* ds,
           const float* bm, const long long* bs, const float* cm, const long long* cs,
           const float* a, const float* d, const float* s0, float* y, float* s_out,
           float* chunk_states, int b, int t, int h, int n_split, cudaStream_t stream) {
  if (t == 1 && n_split == 1) {
    ssd_decode_kernel<P, N><<<b * h, kThreads, 0, stream>>>(x, xs[0], xs[2], dt, ds[0], ds[2], bm,
                                                            bs[0], cm, cs[0], a, d, s0, y, s_out,
                                                            chunk_states, h);
    return static_cast<int>(cudaGetLastError());
  }
  auto kern = ssd_split_kernel<P, N>;
  const size_t smem = Layout<P, N>::kBytes;
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
  err = cudaLaunchKernelEx(&cfg, kern, x, xs[0], xs[1], xs[2], dt, ds[0], ds[1], ds[2], bm, bs[0],
                           bs[1], cm, cs[0], cs[1], a, d, s0, y, s_out, chunk_states, t, h);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int max_clusters(int n_split, int* out) {
  auto kern = ssd_split_kernel<P, N>;
  const size_t smem = Layout<P, N>::kBytes;
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

// x (B, T, H, P) with element strides {batch, step, head}; dt (B, T, H)
// with strides {batch, step, head}; B and C (B, T, N) with strides {batch,
// step}; unit stride along P and N; A and D (H,) f32 contiguous; s0 (B, H,
// P, N) f32 contiguous and 16-byte aligned, or null for a zero state; y (B,
// T, H, P) and s_out (B, H, P, N) f32 contiguous. s_out may be s0.
// chunk_states, null or (B, H, C, P, N) f32 contiguous with C = ceil(T /
// 32): the state entering each chunk. P and N each 16, 32 or 64; n_split,
// the blocks of a cluster each sequence is split over, 1 to 8 (T = 1 with
// n_split = 1 takes the decode path).
// Returns a CUDA error code (cudaErrorInvalidValue for a size not built or
// a split outside 1..8).
int ssd_forward(const float* x, const long long* x_strides, const float* dt,
                const long long* dt_strides, const float* bm, const long long* b_strides,
                const float* cm, const long long* c_strides, const float* a, const float* d,
                const float* s0, float* y, float* s_out, float* chunk_states, int b, int t, int h,
                int p, int n, int n_split, void* stream) {
  if (n_split < 1 || n_split > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_ARGS x, x_strides, dt, dt_strides, bm, b_strides, cm, c_strides, a, d, s0, y, s_out, \
                 chunk_states, b, t, h, n_split, st
#define SSD_N(P)                                          \
  if (n == 16) return launch<P, 16>(SSD_ARGS);            \
  if (n == 32) return launch<P, 32>(SSD_ARGS);            \
  if (n == 64) return launch<P, 64>(SSD_ARGS);
  if (p == 16) { SSD_N(16) }
  if (p == 32) { SSD_N(32) }
  if (p == 64) { SSD_N(64) }
#undef SSD_N
#undef SSD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of n_split prefill blocks the card keeps resident at
// once (cudaOccupancyMaxActiveClusters), into *out; a CUDA error code.
int ssd_max_active_clusters(int p, int n, int n_split, int* out) {
  if (n_split < 1 || n_split > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_N(P)                                                   \
  if (n == 16) return max_clusters<P, 16>(n_split, out);           \
  if (n == 32) return max_clusters<P, 32>(n_split, out);           \
  if (n == 64) return max_clusters<P, 64>(n_split, out);
  if (p == 16) { SSD_N(16) }
  if (p == 32) { SSD_N(32) }
  if (p == 64) { SSD_N(64) }
#undef SSD_N
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
