// Paged decode attention for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernel paged_attention_kernel
// (src/repro/kernels/paged_attention/kernel.py:73, body _kernel :33-70): for
// each sequence b and KV head h, the G query heads of the group attend once
// over the first lengths[b] positions of a paged K/V pool (Hkv, P, ps, d),
// position t living in row t % ps of page page_table[b, t / ps], with an
// online softmax in f32 and scale 1/sqrt(d).
//
// What bounds it: bytes. Every K and V element up to each length is read
// once and used for G dot products, so decode stays far below the card's
// ridge: 8 slots of some 540 positions at 2-5 KV heads of 64-128 move
// 4.5-5.5 MB, under 2 us at 3.35 TB/s. The kernel is bound by latency
// instead: the launch, a block's chain of dependent loads (its length, its
// page ids, then K/V), the merges and cluster barriers, and the longest
// block's walk over its chunks.
//
// What the design does about it:
//   * the sequence is split across the blocks of a thread-block cluster:
//     grid (Hkv, B, n_split), the n_split blocks of one (KV head, sequence)
//     one cluster. The caller passes n_split (1 to the portable 8),
//     which the wrapper computes from shapes alone (ref.split_count), so
//     it never reads lengths back; block r walks positions
//     [r span, (r+1) span), span = ceil(pp * ps / n_split), up to
//     min(length, pp * ps), and a block whose span starts past that
//     leaves an empty partial (m = -1e30, l = 0) and computes nothing. At
//     8 slots over S = 1024 that is 128 blocks for 2 KV heads, not 16;
//   * within a block, positions, not query heads, are spread over the
//     8 warps: warp w takes positions 4w..4w+3 of each chunk of 32, eight
//     lanes a position, so each K/V element is read once for all G heads
//     and no warp idles at G = 1 or 3. Each warp keeps its own online
//     softmax state for the G heads. The kernel is built for G rounded up
//     to 1, 2, 4 or 8, so its head loops carry no branch (one G = 8 build
//     with the loops guarded by the group ran 1.36x slower at G = 1, and
//     slower at G = 3 and 8, on an H100: `check_attention` in chip_smoke.py);
//   * K and V are staged in shared memory in their own type by cp.async
//     16-byte copies, two chunks ahead of the one in use (three stages),
//     through the pool's strides (the per-slot cache's page view needs no
//     copy), zero-filled past the span's end, and widened at use;
//   * the merge: the warps' (m, l, acc) merge in warp order into the
//     block's partial in shared memory; after a cluster barrier the blocks
//     read each other's partials through distributed shared memory, each
//     merging a slice of the outputs in split order. Both merges take each
//     head's factors exp(m_x - m) once, then sum the columns with every
//     load of a thread in flight together. No global scratch, no second
//     launch, and two runs give the same bits;
//   * the arithmetic is the TPU kernel's, in f32 on the CUDA cores (G <= 8
//     rows do not fill a tensor-core tile, and bytes bound it anyway):
//     scores times 1/sqrt(d), masked, p = exp(s - m_new), acc and l
//     rescaled by exp(m - m_new), the final divide clamped at 1e-30.
// Page ids follow JAX's indexing: a negative id counts from the end, what
// is still out of range is clamped.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 32;     // positions staged per step: 4 per warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;     // the chunk in use and two in flight
constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kMaxSplit = 8;   // blocks per cluster, the portable most
constexpr float kNegInf = -1e30f;

// Shared memory: K/V stages (reused for the warps' partials after the
// walk), q in f32, and the block's partial that block 0 reads remotely.
template <typename TKV, int D>
struct Layout {
  static constexpr int kStageElems = kChunk * D;  // one of K or V
  static constexpr size_t kStageBytes = 2 * kStageElems * sizeof(TKV);
  static constexpr size_t kWarpBytes = sizeof(float) * kWarps * kMaxG * (D + 3);
  static constexpr size_t kWork = kStages * kStageBytes > kWarpBytes ? kStages * kStageBytes : kWarpBytes;
  static constexpr size_t kQ = kWork;
  static constexpr size_t kPart = kQ + sizeof(float) * kMaxG * D;
  static constexpr size_t kBytes = kPart + sizeof(float) * kMaxG * (D + 2);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// N consecutive elements at p (2, 4 or a multiple of 4 / 8), widened.
template <int N>
__device__ __forceinline__ void widen(const float* p, float* f) {
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x, f[1] = x.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + k);
      f[k] = x.x, f[k + 1] = x.y, f[k + 2] = x.z, f[k + 3] = x.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* f) {
  if constexpr (N == 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = x.x, f[1] = x.y;
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 x = __bfloat1622float2(e[0]), y = __bfloat1622float2(e[1]);
    f[0] = x.x, f[1] = x.y, f[2] = y.x, f[3] = y.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + k);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(e[j]);
        f[k + 2 * j] = x.x, f[k + 2 * j + 1] = x.y;
      }
    }
  }
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// GM: the group size rounded up to 1, 2, 4 or 8. The head loops run GM
// heads without a branch (q rows past the group are zeros, their outputs
// dropped), so the compiler interleaves the heads' shuffle and exp chains.
template <typename TQ, typename TKV, int D, int GM>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, long long q_sb, long long q_sh,
                    const TKV* __restrict__ kp, long long k_sh, long long k_sp, long long k_sr,
                    const TKV* __restrict__ vp, long long v_sh, long long v_sp, long long v_sr,
                    const int32_t* __restrict__ page_table, int pp, long long n_phys,
                    const int32_t* __restrict__ lengths, int ps, int group, int span,
                    float scale, TQ* __restrict__ out) {
  using L = Layout<TKV, D>;
  constexpr int kSeg = 16 / sizeof(TKV);     // elements per 16-byte copy
  constexpr int kSegs = D / kSeg;            // copies per row
  constexpr int kLaneSegs = kSegs / 8;       // per lane in the score product
  constexpr int kDims = D / 32;              // output columns per lane
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  TKV* stages = reinterpret_cast<TKV*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* part_m = reinterpret_cast<float*>(smem + L::kPart);  // [kMaxG]
  float* part_l = part_m + kMaxG;                              // [kMaxG]
  float* part_acc = part_l + kMaxG;                            // [kMaxG][D]

  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, b = blockIdx.y, r = blockIdx.z, n_split = gridDim.z;
  const int hkv = gridDim.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cap = static_cast<long long>(pp) * ps;
  const int len = static_cast<int>(min(static_cast<long long>(lengths[b]), cap));
  const int start = r * span;
  const int end = min(start + span, len);
  const int32_t* pt = page_table + static_cast<long long>(b) * pp;

  for (int i = threadIdx.x; i < GM * D; i += kThreads) {  // q, while lengths[b] arrives
    const int g = i / D, e = i % D;
    qs[i] = g < group ? to_f32(q[b * q_sb + (static_cast<long long>(h) * group + g) * q_sh + e]) : 0.0f;
  }
  if (start >= end) {  // an empty span: an empty partial
    for (int i = threadIdx.x; i < group * D; i += kThreads) part_acc[i] = 0.0f;
    if (threadIdx.x < group) part_m[threadIdx.x] = kNegInf, part_l[threadIdx.x] = 0.0f;
  } else {
    const TKV* kh = kp + h * k_sh;
    const TKV* vh = vp + h * v_sh;
    const int n_chunks = (end - start + kChunk - 1) / kChunk;
    auto issue = [&](int c) {  // chunk c into stage c % kStages, one commit group
      if (c < n_chunks) {
        TKV* ks = stages + (c % kStages) * 2 * L::kStageElems;
        TKV* vs = ks + L::kStageElems;
        for (int i = threadIdx.x; i < kChunk * kSegs; i += kThreads) {
          const int row = i / kSegs, e = (i % kSegs) * kSeg;
          const int pos = start + c * kChunk + row;
          const bool valid = pos < end;
          long long page = pt[(valid ? pos : start) / ps];
          page = page < 0 ? page + n_phys : page;
          page = page < 0 ? 0 : (page >= n_phys ? n_phys - 1 : page);
          const long long prow = (valid ? pos : start) % ps;
          cp_async16(ks + row * D + e, kh + page * k_sp + prow * k_sr + e, valid);
          cp_async16(vs + row * D + e, vh + page * v_sp + prow * v_sr + e, valid);
        }
      }
      cp_async_commit();
    };
    issue(0);
    issue(1);

    // lane: position p = lane / 8 of the warp's four, segments e + 8j of its row
    const int p = lane >> 3, e = lane & 7;
    float m[GM], l[GM], acc[GM][kDims];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = kNegInf;
      l[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[g][c] = 0.0f;
    }
    for (int c = 0; c < n_chunks; ++c) {
      issue(c + 2);
      cp_async_wait<2>();
      __syncthreads();  // chunk c (and q) visible to every warp
      const TKV* ks = stages + (c % kStages) * 2 * L::kStageElems;
      const TKV* vs = ks + L::kStageElems;
      const int row = 4 * w + p;
      const bool valid = start + c * kChunk + row < end;

      float kf[kLaneSegs][kSeg];
#pragma unroll
      for (int j = 0; j < kLaneSegs; ++j) widen<kSeg>(ks + row * D + (e + 8 * j) * kSeg, kf[j]);
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        s[g] = 0.0f;
#pragma unroll
        for (int j = 0; j < kLaneSegs; ++j) {
          float qf[kSeg];
          widen<kSeg>(qs + g * D + (e + 8 * j) * kSeg, qf);
#pragma unroll
          for (int k = 0; k < kSeg; ++k) s[g] = fmaf(qf[k], kf[j][k], s[g]);
        }
      }
      // the row's dot product over its 8 lanes, then the warp's 4 positions
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
        s[g] = valid ? s[g] * scale : kNegInf;
        float cmax = s[g];
#pragma unroll
        for (int off = 8; off < 32; off <<= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
        const float m_new = fmaxf(m[g], cmax);
        const float corr = expf(m[g] - m_new);
        s[g] = valid ? expf(s[g] - m_new) : 0.0f;  // p
        float psum = s[g];
#pragma unroll
        for (int off = 8; off < 32; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[g] = l[g] * corr + psum;
        m[g] = m_new;
#pragma unroll
        for (int k = 0; k < kDims; ++k) acc[g][k] *= corr;
      }
      // PV: lane owns columns lane * kDims .. + kDims - 1
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        float vf[kDims];
        widen<kDims>(vs + (4 * w + pr) * D + lane * kDims, vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float pg = __shfl_sync(0xffffffffu, s[g], 8 * pr);
#pragma unroll
          for (int k = 0; k < kDims; ++k) acc[g][k] = fmaf(pg, vf[k], acc[g][k]);
        }
      }
      __syncthreads();  // stage c % kStages is refilled by the next issue
    }
    cp_async_wait<0>();

    // the warps' partials, merged in warp order into the block's: one
    // thread a head finds the largest m and each warp's factor, then every
    // thread sums its columns
    float* wm = reinterpret_cast<float*>(smem);  // [kWarps][kMaxG]
    float* wl = wm + kWarps * kMaxG;             // [kWarps][kMaxG]
    float* wf = wl + kWarps * kMaxG;             // [kWarps][kMaxG], exp(m_w - m)
    float* wacc = wf + kWarps * kMaxG;           // [kWarps][kMaxG][D]
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (lane == 0) wm[w * kMaxG + g] = m[g], wl[w * kMaxG + g] = l[g];
#pragma unroll
      for (int k = 0; k < kDims; ++k) wacc[(w * kMaxG + g) * D + lane * kDims + k] = acc[g][k];
    }
    __syncthreads();
    if (threadIdx.x < group) {
      const int g = threadIdx.x;
      float mx = kNegInf, lsum = 0.0f;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) mx = fmaxf(mx, wm[x * kMaxG + g]);
#pragma unroll
      for (int x = 0; x < kWarps; ++x) {
        const float f = expf(wm[x * kMaxG + g] - mx);
        wf[x * kMaxG + g] = f;
        lsum += wl[x * kMaxG + g] * f;
      }
      part_m[g] = mx, part_l[g] = lsum;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < group * D; i += kThreads) {
      const int g = i / D;
      float a = 0.0f;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) a += wacc[x * kMaxG * D + i] * wf[x * kMaxG + g];
      part_acc[i] = a;
    }
  }

  // the blocks of the cluster merge the partials in split order, reading
  // each other's shared memory: every block takes each head's factors
  // exp(m_x - m), then its slice of the G * D outputs, every remote load
  // of a thread in flight together
  cluster.sync();
  {
    float* cf = reinterpret_cast<float*>(smem);  // [kMaxSplit][kMaxG], then l [kMaxG]
    float* cl = cf + kMaxSplit * kMaxG;
    if (threadIdx.x < group) {
      const int g = threadIdx.x;
      float pm[kMaxSplit], pl[kMaxSplit];
#pragma unroll
      for (int x = 0; x < kMaxSplit; ++x) {
        pm[x] = x < n_split ? cluster.map_shared_rank(part_m, x)[g] : kNegInf;
        pl[x] = x < n_split ? cluster.map_shared_rank(part_l, x)[g] : 0.0f;
      }
      float mx = kNegInf, lsum = 0.0f;
#pragma unroll
      for (int x = 0; x < kMaxSplit; ++x) mx = fmaxf(mx, pm[x]);
#pragma unroll
      for (int x = 0; x < kMaxSplit; ++x) {
        if (x >= n_split) break;
        const float f = expf(pm[x] - mx);
        cf[x * kMaxG + g] = f;
        lsum += pl[x] * f;
      }
      cl[g] = lsum;
    }
    __syncthreads();
    const int total = group * D, per = (total + n_split - 1) / n_split;
    const int hi = min(total, (r + 1) * per);
    TQ* orow = out + (static_cast<long long>(b) * hkv + h) * group * D;
    for (int i = r * per + threadIdx.x; i < hi; i += kThreads) {
      const int g = i / D;
      float pa[kMaxSplit];
#pragma unroll
      for (int x = 0; x < kMaxSplit; ++x) pa[x] = x < n_split ? cluster.map_shared_rank(part_acc, x)[i] : 0.0f;
      float a = 0.0f;
#pragma unroll
      for (int x = 0; x < kMaxSplit; ++x) {
        if (x >= n_split) break;
        a += pa[x] * cf[x * kMaxG + g];
      }
      from_f32(a / fmaxf(cl[g], 1e-30f), orow + i);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename TQ, typename TKV, int D, int GM>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, const void* page_table, int pp,
           long long n_phys, const void* lengths, int ps, int b, int hkv, int group,
           int n_split, float scale, void* out, cudaStream_t st) {
  auto kern = paged_decode_kernel<TQ, TKV, D, GM>;
  const size_t smem = Layout<TKV, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(pp) * ps;
  const int span = static_cast<int>((cap + n_split - 1) / n_split);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hkv, b, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const TQ*>(q), qs[0], qs[1],
                           static_cast<const TKV*>(k), ks[0], ks[1], ks[2],
                           static_cast<const TKV*>(v), vs[0], vs[1], vs[2],
                           static_cast<const int32_t*>(page_table), pp, n_phys,
                           static_cast<const int32_t*>(lengths), ps, group, span, scale,
                           static_cast<TQ*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, D) with strides {batch, head}; k and v pools (Hkv, P, ps, D)
// with strides {head, page, row}; unit stride along D everywhere.
// page_table (B, pp) and lengths (B,) int32, contiguous; out (B, Hq, D)
// contiguous in q's type. q_kind / kv_kind: 0 = float32, 1 = bfloat16;
// head_dim 64 or 128; group = Hq / Hkv <= 8; n_split blocks a sequence,
// 1 to 8. Returns a CUDA error code (cudaErrorInvalidValue for a
// combination not built or an n_split out of range).
int pa_decode(const void* q, const long long* q_strides, const void* k,
              const long long* k_strides, const void* v, const long long* v_strides,
              const void* page_table, int pp, long long n_phys, const void* lengths,
              int ps, int q_kind, int kv_kind, int head_dim, int b, int hkv, int group,
              int n_split, float scale, void* out, void* stream) {
  if (b == 0 || hkv == 0) return static_cast<int>(cudaGetLastError());
  if (group < 1 || group > kMaxG || n_split < 1 || n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS q, q_strides, k, k_strides, v, v_strides, page_table, pp, n_phys, lengths, \
                ps, b, hkv, group, n_split, scale, out, st
#define PA_GM(TQ, TKV, D)                                                   \
  if (group == 1) return launch<TQ, TKV, D, 1>(PA_ARGS);                    \
  if (group == 2) return launch<TQ, TKV, D, 2>(PA_ARGS);                    \
  if (group <= 4) return launch<TQ, TKV, D, 4>(PA_ARGS);                    \
  return launch<TQ, TKV, D, 8>(PA_ARGS);
#define PA_HD(TQ, TKV)                                                      \
  if (head_dim == 64) { PA_GM(TQ, TKV, 64) }                                \
  if (head_dim == 128) { PA_GM(TQ, TKV, 128) }
  if (q_kind == 0 && kv_kind == 0) { PA_HD(float, float) }
  if (q_kind == 0 && kv_kind == 1) { PA_HD(float, __nv_bfloat16) }
  if (q_kind == 1 && kv_kind == 0) { PA_HD(__nv_bfloat16, float) }
  if (q_kind == 1 && kv_kind == 1) { PA_HD(__nv_bfloat16, __nv_bfloat16) }
#undef PA_HD
#undef PA_GM
#undef PA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
