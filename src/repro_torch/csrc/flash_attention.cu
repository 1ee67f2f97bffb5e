// Flash attention forward for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py:76, body _kernel :31-73):
// blocked causal or non-causal attention with an online softmax in f32,
// GQA (query head h reads KV head h / group), keys at kpos >= lk_valid
// masked, and, when causal, kpos <= qpos + q_offset.
//
// What bounds it: at the serving prefill (one prompt of L = 512, head_dim
// 64 or 128) the work is 4 * Hq * L^2/2 * D operations (QK^T and PV, half
// of them under the causal mask) against 2.6-4.7 MB of q, k, v and o: in
// bf16 that is below the card's ridge (about 295 operations a byte), so
// bytes bound the card there, at 1-2 us. The kernel is bound by latency
// instead: the launch, the first loads, and the walk of the longest causal
// q tile (8 key tiles at L = 512), which runs on one SM and, at D = 128,
// on that SM's tensor cores. In f32 (zamba2's shared block) the CUDA
// cores' 67 TFLOP/s bound it.
//
// bf16 (fa_tc_kernel), the design:
//   * one block per (q tile of 64 rows, q head, batch), the q tiles in
//     reverse order, so the causal tiles that walk the most keys start
//     first; the TPU's sequential KV grid axis becomes a walk over 64-row
//     K/V tiles, which stops at the diagonal when causal and at lk_valid.
//     Two consumer warpgroups split the walk, even and odd tiles, each with
//     its own online softmax, and run side by side on the SM; at the end
//     warpgroup 1 hands (m, l, acc) to warpgroup 0 through shared memory,
//     which merges them in that order. The last 64-row tile of a 512-token
//     causal prompt walks 4 tiles a warpgroup instead of 8;
//   * both products on the tensor cores, `wgmma.mma_async` with f32
//     accumulators (m64n64k16; m64n128k16 for P V at D = 128), issued by the
//     warpgroup (128 threads) that owns the tile. S = Q K^T reads Q and K
//     from shared memory, K-major (K's own rows).
//     O += P V takes P from registers: the S accumulator's fragment is the
//     A-operand fragment of a 16-bit product, so P never goes through
//     shared memory; V is read MN-major (the transpose bit bf16 allows),
//     so it is never transposed in memory;
//   * loads by TMA: one tensor map a tensor over its real 4-D shape and
//     byte strides (v may be a transposed projection view: no copy), boxes
//     of 64 x 64 with the 128-byte swizzle the wgmma descriptors name, two
//     boxes a row at D = 128. One producer warp keeps a ring of four K/V
//     stages in flight on mbarriers; TMA's zero fill past the tensor's end
//     replaces the masking of ragged tiles. The score mask (lk_valid,
//     causal, q_offset) stays, and a tile that every row sees whole skips
//     it; exponentials go to the special-function unit (ex2.approx);
//   * the TPU kernel's numerics: it takes p in f32 into PV (kernel.py:44,
//     :64-66). A bf16 operand carries 8 bits, so p goes in as three bf16
//     parts, p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2), in
//     three products into one accumulator: the 24 bits of f32 p, each
//     product with v exact. Two parts (16 bits) leave errors of some 1e-6
//     on outputs that cancel to 1e-5, past one bf16 step of them (measured
//     with ref.flash_attention_tiled_ref). The parts make P V three times
//     the tensor-core work of Q K^T: on the longest causal tiles at D = 128
//     that work sets the SM's pace. Scores are scaled by 1/sqrt(d), masked
//     to -1e30, acc and l rescaled by exp(m - m_new), the final divide
//     clamped at 1e-30; every sum runs in a fixed order, so two runs give
//     the same bits.
//
// f32 (fa_simt_kernel), the first kernel's design, kept for f32 callers:
// q, k and v staged in shared memory, both products as f32 FMAs on a
// 16 x 16 thread grid (thread (ty, tx) owns rows 4ty..4ty+3, score columns
// tx + 16j, output columns 4tx.. and 64 + 4tx..), rows' max and sum as
// half-warp shuffles, P through shared memory.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns a CUDA error code (cudaGetLastError(), or
// kTensorMapError when cuTensorMapEncodeTiled refuses a tensor map).

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is reached through cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per tile
constexpr float kNegInf = -1e30f;
constexpr int kTensorMapError = 10000;  // beyond every cudaError_t

// ---------------------------------------------------------------------------
// f32: products on the CUDA cores

constexpr int kSimtThreads = 256;  // 16 x 16
constexpr int kPStride = kBK + 4;

template <int D>
struct SimtTile {
  static constexpr int kStride = D + 4;  // floats per staged row
  static constexpr int kCols = D / 64;   // float4 output groups per thread
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((kBQ + 2 * kBK) * kStride + kBQ * kPStride);
};

// Stage `rows` rows of D floats (row r at src + r * row_stride) into dst,
// each row kStride floats apart; rows at or past `valid` are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, long long row_stride,
                                           int valid, float* __restrict__ dst) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kSimtThreads) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const float4 f = r < valid ? *reinterpret_cast<const float4*>(src + r * row_stride + c)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(dst + r * SimtTile<D>::kStride + c) = f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float lane_of(float4 v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
fa_simt_kernel(const float* __restrict__ q, long long q_sb, long long q_sh, long long q_sl,
               const float* __restrict__ k, long long k_sb, long long k_sh, long long k_sl,
               const float* __restrict__ v, long long v_sb, long long v_sh, long long v_sl,
               float* __restrict__ o, int hq, int group, int lq, int lk, int causal,
               int lk_valid, int q_offset, float scale) {
  using TL = SimtTile<D>;
  constexpr int S = TL::kStride;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * S;
  float* vs = ks + kBK * S;
  float* ps = vs + kBK * S;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;
  stage_rows<D, kBQ>(q + b * q_sb + h * q_sh + q0 * q_sl, q_sl, lq - q0, qs);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float m[4], l[4], acc[4][4 * TL::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * TL::kCols; ++c) acc[i][c] = 0.0f;
  }

  // keys any row of this block can see
  const int kv_lim = min(lk_valid, lk);
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, min(lq, q0 + kBQ) - 1 + q_offset + 1);
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D, kBK>(kb + k0 * k_sl, k_sl, lk - k0, ks);
    stage_rows<D, kBK>(vb + k0 * v_sl, v_sl, lk - k0, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * S + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * S + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < kv_lim && (!causal || kpos <= qpos + q_offset);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * TL::kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * ty + i) * kPStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kPStride + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * S + 4 * tx;
#pragma unroll
        for (int g = 0; g < TL::kCols; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + 64 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = lane_of(pa[i], u);
            acc[i][4 * g + 0] = fmaf(p, w.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, w.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, w.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, w.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * hq + h) * lq + row) * D + 4 * tx;
#pragma unroll
    for (int g = 0; g < TL::kCols; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) orow[64 * g + c] = acc[i][4 * g + c] / denom;
  }
}

template <int D>
int launch_simt(const void* q, const long long* qs, const void* k, const long long* ks,
                const void* v, const long long* vs, void* o, int b, int hq, int hkv, int lq,
                int lk, int causal, int lk_valid, int q_offset, float scale, cudaStream_t st) {
  auto kern = fa_simt_kernel<D>;
  const size_t smem = SimtTile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
  kern<<<grid, kSimtThreads, smem, st>>>(
      static_cast<const float*>(q), qs[0], qs[1], qs[2], static_cast<const float*>(k), ks[0],
      ks[1], ks[2], static_cast<const float*>(v), vs[0], vs[1], vs[2], static_cast<float*>(o),
      hq, hq / hkv, lq, lk, causal, lk_valid, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: wgmma on tiles brought in by TMA

constexpr int kConsumers = 2;                         // warpgroups: warps 0-7
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kTcThreads = kConsumerThreads + 32;     // and one producer warp
constexpr int kStages = 4;                            // K/V tiles in flight
constexpr int kPParts = 3;                            // bf16 parts of p in PV
constexpr int kBoxBytes = 64 * 64 * 2;                // one 64 x 64 bf16 box, 8 KB

template <int D>
struct TcSmem {
  static constexpr int kTile = kBoxBytes * (D / 64);  // 64 rows of D
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;  // q, full[kStages], empty[kStages]
  // after the walk the stages hold warpgroup 1's m, l and acc for warpgroup 0
  static constexpr int kXchg = kK;
  static_assert(sizeof(float) * 128 * (4 + 32 * (D / 64)) <= 2 * kStages * kTile, "exchange");
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;     // room to align the tiles to 1 KB
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a tile in the 128-byte swizzle
// TMA wrote: start address >> 4 (bits 0-13), leading byte offset >> 4
// (16-29), stride byte offset >> 4 (32-45), layout 1 = 128-byte swizzle
// (62-63). The stride offset is 1024 B, eight 128-byte rows, in both
// majors; the leading offset is the distance between 64-element boxes
// along MN for the MN-major V, and unused (16 B) in the K-major layouts.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D8(o)                                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),      \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_D32_REGS                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) = A (64 x 16) B (16 x 64) [+ d when accumulate], A and B
// bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B bf16
// in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_tn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define WG_D64_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) B (16 x 128), B bf16
// in shared memory, MN-major: two 64-column boxes, the descriptor's leading
// byte offset apart.
__device__ __forceinline__ void wgmma_rs_tn_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D64_REGS
#undef WG_D32_REGS
#undef WG_D8

// e^x as 2^(x log2 e) on the special-function unit: one multiply and one
// MUFU.EX2 (relative error 2^-22) where expf takes some ten instructions; the
// rounding of x log2 e moves p by some 1e-7, as expf's own argument does.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Thread t of the consumer warpgroup holds, of a 64 x 64 accumulator, rows
// r = 16 (t / 32) + (t % 32) / 4 and r + 8: element i of its 32 sits at
// row r + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, int hq,
             int group, int lq, int lk, int causal, int lk_valid, int q_offset, float scale) {
  using SM = TcSmem<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + SM::kQ;
  const uint32_t bar_q = base + SM::kBars;
  const uint32_t bar_full = bar_q + 8;                 // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 s

  const int qt = gridDim.x - 1 - blockIdx.x;  // the heaviest causal tiles first
  const int q0 = qt * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kv_lim = min(lk_valid, lk);
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, min(lq, q0 + kBQ) - 1 + q_offset + 1);
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);  // one warpgroup consumes a tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {  // the producer warp: tiles in order
    if (lane == 0) {
      const int hk = h / group;
      mbar_expect_tx(bar_q, SM::kTile);
      for (int c = 0; c < kBoxes; ++c) tma_load_4d(q_s + c * kBoxBytes, &q_map, bar_q, 64 * c, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * SM::kTile);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(base + SM::kK + s * SM::kTile + c * kBoxBytes, &k_map, full, 64 * c, t * kBK, hk, b);
          tma_load_4d(base + SM::kV + s * SM::kTile + c * kBoxBytes, &v_map, full, 64 * c, t * kBK, hk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg takes key tiles wg, wg + 2, ...
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int r0 = 16 * (warp % 4) + lane / 4;  // and r0 + 8
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  const int cq = 2 * (lane % 4);  // column of element 0 within each group of 8
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float acc[32 * kBoxes];  // columns 64c.. in elements 32c..
#pragma unroll
  for (int i = 0; i < 32 * kBoxes; ++i) acc[i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int t = wg; t < n_tiles; t += kConsumers) {
    const int s = t % kStages;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    const uint32_t k_s = base + SM::kK + s * SM::kTile;
    const uint32_t v_s = base + SM::kV + s * SM::kTile;

    // S = Q K^T over D in steps of 16: box kk / 4, 32 bytes a step within it
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;  // the first product overwrites them
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss(sc, smem_desc(q_s + off, 16), smem_desc(k_s + off, 16), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scale, mask (not on a tile every row sees whole), online softmax for
    // rows r0 (elements 4i, 4i+1) and r0 + 8 (4i+2, 4i+3)
    const int k0 = t * kBK;
    if (k0 + kBK <= kv_lim && (!causal || k0 + kBK - 1 <= q0 + q_offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k0 + 8 * i + cq + j;
          const bool in = kpos < kv_lim;
          const bool v0 = in && (!causal || kpos <= qpos0 + q_offset);
          const bool v1 = in && (!causal || kpos <= qpos1 + q_offset);
          sc[4 * i + j] = v0 ? sc[4 * i + j] * scale : kNegInf;
          sc[4 * i + 2 + j] = v1 ? sc[4 * i + 2 + j] * scale : kNegInf;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx0 = fmaxf(mx0, sc[4 * i + j]);
        mx1 = fmaxf(mx1, sc[4 * i + 2 + j]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp_fast(m0 - mn0), corr1 = exp_fast(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[4 * i + j] = exp_fast(sc[4 * i + j] - mn0);
        sc[4 * i + 2 + j] = exp_fast(sc[4 * i + 2 + j] - mn1);
        sum0 += sc[4 * i + j];
        sum1 += sc[4 * i + 2 + j];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[32 * c + 4 * i] *= corr0;
        acc[32 * c + 4 * i + 1] *= corr0;
        acc[32 * c + 4 * i + 2] *= corr1;
        acc[32 * c + 4 * i + 3] *= corr1;
      }

    // P as A operands in kPParts bf16 parts, each the rounding of what the
    // parts before it left: keys 16kk..16kk+15 are elements 8kk..8kk+7, in
    // register j the pair (8kk + 2j, 8kk + 2j + 1), lower column low
    uint32_t pa[kPParts][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[8 * kk + 2 * j], y = sc[8 * kk + 2 * j + 1];
#pragma unroll
        for (int u = 0; u < kPParts; ++u) {
          const __nv_bfloat162 part = __floats2bfloat162_rn(x, y);
          pa[u][kk][j] = bf16x2_bits(part);
          if (u + 1 < kPParts) {
            x -= __low2float(part);  // exact: what rounding dropped
            y -= __high2float(part);
          }
        }
      }

    // O += P V: V's rows 16kk.. start 2048 bytes apart, box c holds columns 64c..;
    // at D = 128 one product spans both boxes
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(v_s + kk * 2048, kBoxBytes);
#pragma unroll
      for (int u = 0; u < kPParts; ++u) {
        if constexpr (kBoxes == 2)  // both boxes in one m64n128k16
          wgmma_rs_tn_n128(acc, pa[u][kk], dv);
        else
          wgmma_rs_tn(acc, pa[u][kk], dv);
      }
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * s);  // this stage may be refilled
  }

  // warpgroup 1 hands its m, l and acc to warpgroup 0 through the drained
  // stages (named barrier 1: the 256 consumer threads); 0 merges in order
  float* xchg = reinterpret_cast<float*>(smem_raw + (base - raw) + SM::kXchg);
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
  if (wg == 1) {
    xchg[0 * 128 + tid] = m0;
    xchg[1 * 128 + tid] = m1;
    xchg[2 * 128 + tid] = l0;
    xchg[3 * 128 + tid] = l1;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) xchg[(4 + 32 * c + i) * 128 + tid] = acc[32 * c + i];
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
  if (wg == 1) return;
  {
    const float mo0 = xchg[tid], mo1 = xchg[128 + tid];
    const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
    const float a0 = expf(m0 - mn0), b0 = expf(mo0 - mn0);
    const float a1 = expf(m1 - mn1), b1 = expf(mo1 - mn1);
    l0 = l0 * a0 + xchg[2 * 128 + tid] * b0;
    l1 = l1 * a1 + xchg[3 * 128 + tid] * b1;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float other = xchg[(4 + 32 * c + i) * 128 + tid];
        acc[32 * c + i] = (i / 2) % 2 ? acc[32 * c + i] * a1 + other * b1 : acc[32 * c + i] * a0 + other * b0;
      }
  }

  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long row_base = (static_cast<long long>(b) * hq + h) * lq;
#pragma unroll
  for (int c = 0; c < kBoxes; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * c + 8 * i + cq;
      if (qpos0 < lq)
        *reinterpret_cast<__nv_bfloat162*>(o + (row_base + qpos0) * D + col) =
            __floats2bfloat162_rn(acc[32 * c + 4 * i] / den0, acc[32 * c + 4 * i + 1] / den0);
      if (qpos1 < lq)
        *reinterpret_cast<__nv_bfloat162*>(o + (row_base + qpos1) * D + col) =
            __floats2bfloat162_rn(acc[32 * c + 4 * i + 2] / den1, acc[32 * c + 4 * i + 3] / den1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that cudart has loaded, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a (B, H, L, D) bf16 tensor with element strides
// {batch, head, row} and unit stride along D, in 64 x 64 boxes with the
// 128-byte swizzle; reads past its extent fill zeros. A dim of extent 1
// takes the packed stride (TMA wants every stride a multiple of 16
// bytes, and torch may give such a dim any stride).
bool make_map(CUtensorMap* map, const void* ptr, const long long* strides, int b, int h, int l,
              int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(l),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  cuuint64_t bytes[3];
  cuuint64_t packed = static_cast<cuuint64_t>(d) * 2;
  for (int i = 0; i < 3; ++i) {
    const long long s = strides[2 - i];  // row, head, batch
    bytes[i] = dims[i + 1] == 1 ? packed : static_cast<cuuint64_t>(s) * 2;
    packed = bytes[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const long long* qs, const void* k, const long long* ks,
              const void* v, const long long* vs, void* o, int b, int hq, int hkv, int lq,
              int lk, int causal, int lk_valid, int q_offset, float scale, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, qs, b, hq, lq, D) || !make_map(&km, k, ks, b, hkv, lk, D) ||
      !make_map(&vm, v, vs, b, hkv, lk, D))
    return kTensorMapError;
  auto kern = fa_tc_kernel<D>;
  const size_t smem = TcSmem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
  kern<<<grid, kTcThreads, smem, st>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o), hq, hq / hkv,
                                       lq, lk, causal, lk_valid, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  if (code == kTensorMapError) return "cuTensorMapEncodeTiled refused a tensor map for q, k or v";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), each with element strides
// {batch, head, row} and unit stride along D; o (B, Hq, Lq, D) contiguous.
// kind: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Returns a CUDA error
// code (cudaErrorInvalidValue for a kind or head_dim not built).
int fa_forward(const void* q, const long long* q_strides, const void* k,
               const long long* k_strides, const void* v, const long long* v_strides,
               void* o, int kind, int head_dim, int b, int hq, int hkv, int lq, int lk,
               int causal, int lk_valid, int q_offset, float scale, void* stream) {
  if (b == 0 || lq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, q_strides, k, k_strides, v, v_strides, o, b, hq, hkv, lq, lk, causal, \
                lk_valid, q_offset, scale, st
  if (kind == 0 && head_dim == 64) return launch_simt<64>(FA_ARGS);
  if (kind == 0 && head_dim == 128) return launch_simt<128>(FA_ARGS);
  if (kind == 1 && head_dim == 64) return launch_tc<64>(FA_ARGS);
  if (kind == 1 && head_dim == 128) return launch_tc<128>(FA_ARGS);
#undef FA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
