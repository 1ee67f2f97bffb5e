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
// on that SM's tensor cores. In f32 (zamba2's shared block, 32 heads of
// 64) exact products on the tensor cores take three TF32 products each:
// 3 x 1.08 GFLOP at 495 TFLOP/s, 6.5 us for the card, against 16 us on
// the CUDA cores' 67 TFLOP/s.
//
// One kernel, fa_tc_kernel<T, D>, for both types. The design:
//   * one block per (q tile of 64 rows, q head, batch), the q tiles in
//     reverse order, so the causal tiles that walk the most keys start
//     first; the TPU's sequential KV grid axis becomes a walk over 64-row
//     K/V tiles, which stops at the diagonal when causal and at lk_valid.
//     Two consumer warpgroups split the walk, even and odd tiles, each with
//     its own online softmax, and run side by side on the SM; at the end
//     warpgroup 1 hands (m, l, acc) to warpgroup 0 through shared memory,
//     which merges them in that order. The last 64-row tile of a 512-token
//     causal prompt walks 4 tiles a warpgroup instead of 8;
//   * loads by TMA: one tensor map a tensor over its real 4-D shape and
//     byte strides (v may be a transposed projection view: no copy), boxes
//     of 64 rows of 128 bytes (64 bf16 or 32 f32 columns) with the 128-byte
//     swizzle the wgmma descriptors name. One producer warp keeps a ring of
//     K/V stages in flight on mbarriers (four; two for f32 at D = 128, what
//     227 KB hold beside the TF32 parts); TMA's zero fill past the tensor's
//     end replaces the masking of ragged tiles. The score mask (lk_valid,
//     causal, q_offset) stays, and a tile that every row sees whole skips
//     it; exponentials go to the special-function unit (ex2.approx);
//   * scores are scaled by 1/sqrt(d), masked to -1e30, acc and l rescaled
//     by exp(m - m_new), the final divide clamped at 1e-30; every sum runs
//     in a fixed order, so two runs give the same bits;
//   * on request (a non-null lse pointer) the epilogue also writes each
//     row's softmax stats, lse = m + log(l) in f32, 0 where l = 0: what the
//     training backward recomputes p = exp(s - lse) from, as the
//     reference's custom VJP saves it (src/repro/models/common.py:184-186).
//     A serving launch passes null and stores nothing more.
//
// bf16, the products: both on `wgmma.mma_async` with f32 accumulators
// (m64n64k16; m64n128k16 for P V at D = 128), issued by the warpgroup that
// owns the tile. S = Q K^T reads Q and K from shared memory, K-major (K's
// own rows). O += P V takes P from registers: the S accumulator's fragment
// is the A-operand fragment of a 16-bit product, so P never goes through
// shared memory; V is read MN-major (the transpose bit bf16 allows), so it
// is never transposed in memory. The TPU kernel takes p in f32 into PV
// (kernel.py:44, :64-66). A bf16 operand carries 8 bits, so p goes in as
// three bf16 parts, p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 -
// p2), in three products into one accumulator: the 24 bits of f32 p, each
// product with v exact. Two parts (16 bits) leave errors of some 1e-6 on
// outputs that cancel to 1e-5, past one bf16 step of them (measured with
// ref.flash_attention_tiled_ref).
//
// f32, the products: on the tensor cores in TF32, as three products. Each
// f32 operand x splits as big = tf32(x) and small = tf32(x - big), both
// rounded to nearest (cvt.rna: the tensor core truncates a raw f32), and
// each product is Ab Bb + Ab Bs + As Bb in f32 accumulators: what is
// dropped, As Bs and the rounding of the small parts, is some 2^-21 of the
// product, so the result keeps 21-22 bits. One TF32 product keeps 11 bits:
// at L = 512, D = 64 its outputs miss flash_attention_ref by 1e-3; two
// products (Ab Bb + Ab Bs) leave A's rounding, 6e-4; three, 1e-6, inside
// the unchanged 2e-5 (ref.flash_attention_tf32_ref on the CPU, products =
// 1, 2, 3). The splits:
//   - Q once a block, by both warpgroups: big in place, small beside it;
//     K once a tile by the warpgroup that takes it, 64 columns at a time:
//     big in place, small in 16 KB of its own. Both are elementwise over
//     TMA's swizzled tiles, so the swizzle holds, then made visible to
//     wgmma (fence.proxy.async). S = Q K^T is three m64n64k8 TF32 wgmma a
//     step of 8, both operands K-major as TF32 requires, as in bf16;
//   - O += P V: P's accumulator fragment is not a TF32 A fragment (its
//     column pairs differ), but ordering each 8 keys 0, 2, 4, 6, 1, 3, 5, 7
//     in both P and V (a sum's order over k is free) makes the
//     accumulator's elements the A fragment as they are, so P stays in
//     registers. TF32 wgmma takes B K-major only (the transpose bit is for
//     16-bit types), so at D = 64 the warpgroup writes V's TF32 parts
//     transposed into shared memory, keys in that order, once a tile, and
//     takes PV on m64n64k8 wgmma. At D = 128 the two parts of V^T (64 KB a
//     warpgroup) do not fit beside the ring, and PV runs on mma.sync
//     m16n8k8, each warp its 16 rows, reading V's rows where TMA put them
//     and splitting them in registers: each warp reads and splits the whole
//     tile, four times the work of the transpose (PERF.md times both at
//     zamba2's shape with repro_torch.kernels.compare);
//   - ex2.approx stays, as in bf16: its 2^-22 is below the split's.
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
// wgmma on tiles brought in by TMA, for both types

constexpr int kConsumers = 2;                         // warpgroups: warps 0-7
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kTcThreads = kConsumerThreads + 32;     // and one producer warp
constexpr int kPParts = 3;                            // bf16 parts of p in PV
constexpr int kBoxBytes = 64 * 128;                   // one box: 64 rows of one 128-byte swizzle row, 8 KB
constexpr int kSmemMax = 232448;                      // what a block may use

// f32 O += P V runs on TF32 wgmma over V^T where V^T fits beside the ring
// (D = 64), on mma.sync where it does not (D = 128). Building with
// -DFA_F32_PV_MMA_SYNC takes mma.sync at D = 64 as well, which
// repro_torch.kernels.compare times against the default.
#ifdef FA_F32_PV_MMA_SYNC
constexpr bool kPvWgmmaAt64 = false;
#else
constexpr bool kPvWgmmaAt64 = true;
#endif

// The shared memory of one block, in bytes from a 1 KB boundary. A box is
// 64 rows of 128 bytes (64 bf16 or 32 f32 columns), a tile 64 rows of D.
// f32 also keeps Q's small TF32 part beside Q (split in place) and, for
// each consumer warpgroup, the small part of 64 columns of its K tile (the
// big part is written over the tile in place), then of its V^T when PV
// runs on wgmma, whose big part has two boxes of its own; the ring is 4
// tiles deep at D = 64 and 2 at D = 128, what 227 KB hold.
template <typename T, int D>
struct TcSmem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr bool kPvWgmma = kF32 && D == 64 && kPvWgmmaAt64;
  static constexpr int kBoxCols = 128 / sizeof(T);
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kTile = kBoxBytes * kBoxes;
  static constexpr int kStages = kF32 && D == 128 ? 2 : 4;  // K/V tiles in flight
  static constexpr int kQ = 0;
  static constexpr int kQs = kQ + kTile;
  static constexpr int kK = kQs + (kF32 ? kTile : 0);
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kKs = kV + kStages * kTile;   // + wg * 2 boxes
  static constexpr int kVt = kKs + (kF32 ? kConsumers * 2 * kBoxBytes : 0);  // + wg * 2 boxes
  static constexpr int kBars = kVt + (kPvWgmma ? kConsumers * 2 * kBoxBytes : 0);  // q, full[], empty[]
  // after the walk the stages hold warpgroup 1's m, l and acc for warpgroup 0
  static constexpr int kXchg = kK;
  static_assert(sizeof(float) * 128 * (4 + 32 * (D / 64)) <= 2 * kStages * kTile, "exchange");
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;     // room to align the tiles to 1 KB
  static_assert(kAlloc <= kSmemMax, "shared memory");
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

// d (64 x 64, f32) = A (64 x 8) B (8 x 64) [+ d when accumulate], A and B
// TF32 in shared memory, both K-major (the only major TF32 takes).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32_REGS
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 8, TF32 in registers) B (8 x 64), B TF32
// in shared memory, K-major. A's fragment is mma_tf32's, warp w rows 16w..
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D64_REGS
#undef WG_D32_REGS
#undef WG_D8

// d (16 x 8, f32) += A (16 x 8) B (8 x 8), TF32 fragments in registers:
// a0 (row g, col c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4),
// b0 (row c, col g), b1 (c + 4, g), d as the wgmma accumulator, for lane
// 4 g + c.
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The nearest TF32 (10 mantissa bits), ties away from zero: the tensor
// core would truncate the raw f32 instead.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each TF32: small is what rounding x dropped, rounded.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));  // the difference is exact
}

// Generic writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Split n4 float4s of f32 at `big` into TF32 parts, the big part in place
// and the small one at the same offset from `small`: an elementwise map,
// so the swizzle TMA wrote holds for both.
__device__ __forceinline__ void split_tile(float* big, float* small, int n4, int tid, int threads) {
  for (int i = tid; i < n4; i += threads) {
    float4 v = reinterpret_cast<float4*>(big)[i];
    uint32_t b[4], sm[4];
    tf32_split(v.x, b[0], sm[0]);
    tf32_split(v.y, b[1], sm[1]);
    tf32_split(v.z, b[2], sm[2]);
    tf32_split(v.w, b[3], sm[3]);
    reinterpret_cast<uint4*>(big)[i] = make_uint4(b[0], b[1], b[2], b[3]);
    reinterpret_cast<uint4*>(small)[i] = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

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

// S = Q K^T over D for bf16: steps of 16, box kk / 4, 32 bytes a step within it.
template <int D>
__device__ __forceinline__ void scores_bf16(float (&sc)[32], uint32_t q_s, uint32_t k_s) {
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
}

// S = Q K^T over D for f32, as three TF32 products Qb Kb + Qb Ks + Qs Kb
// (steps of 8, box kk / 4, 32 bytes a step within it), 64 columns at a
// time: the warpgroup splits K's columns 64c.. (two boxes) into the big
// part in place and the small part in its own two boxes at ks_s, then
// multiplies. The named barrier (2 + wg) keeps the split from overwriting
// what another warp's products still read, and makes it whole first.
template <int D>
__device__ __forceinline__ void scores_tf32(float (&sc)[32], uint32_t q_s, uint32_t qs_s,
                                            uint32_t k_s, uint32_t ks_s, float* k_ptr,
                                            float* ks_ptr, int tid, int wg) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    named_sync(2 + wg, 128);
    split_tile(k_ptr + c * 2 * kBoxBytes / 4, ks_ptr, 2 * kBoxBytes / 16, tid, 128);
    fence_proxy_async();
    named_sync(2 + wg, 128);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      const uint32_t qo = 2 * c * kBoxBytes + off;
      const uint64_t qb = smem_desc(q_s + qo, 16), qs = smem_desc(qs_s + qo, 16);
      const uint64_t kb = smem_desc(k_s + qo, 16), ks = smem_desc(ks_s + off, 16);
      wgmma_tf32(sc, qb, kb, c > 0 || kk > 0);
      wgmma_tf32(sc, qb, ks, 1);
      wgmma_tf32(sc, qs, kb, 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
  }
}

// Scale, mask (not on a tile every row sees whole) and the online softmax
// of one key tile for rows r0 (elements 4i, 4i+1) and r0 + 8 (4i+2, 4i+3):
// sc becomes p, acc and l are rescaled by exp(m - m_new).
template <int NA>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&acc)[NA], float& m0,
                                             float& m1, float& l0, float& l1, int k0, int q0,
                                             int qpos0, int qpos1, int cq, int kv_lim,
                                             int causal, int q_offset, float scale) {
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
  for (int i = 0; i < NA / 4; ++i) {
    acc[4 * i] *= corr0;
    acc[4 * i + 1] *= corr0;
    acc[4 * i + 2] *= corr1;
    acc[4 * i + 3] *= corr1;
  }
}

// O += P V for bf16: P as A operands in kPParts bf16 parts, each the
// rounding of what the parts before it left: keys 16kk..16kk+15 are
// elements 8kk..8kk+7, in register j the pair (8kk + 2j, 8kk + 2j + 1),
// lower column low. V's rows 16kk.. start 2048 bytes apart, box c holds
// columns 64c..; at D = 128 one product spans both boxes.
template <int D>
__device__ __forceinline__ void pv_bf16(float (&acc)[32 * (D / 64)], const float (&sc)[32],
                                        uint32_t v_s) {
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
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = smem_desc(v_s + kk * 2048, kBoxBytes);
#pragma unroll
    for (int u = 0; u < kPParts; ++u) {
      if constexpr (D == 128)  // both boxes in one m64n128k16
        wgmma_rs_tn_n128(acc, pa[u][kk], dv);
      else
        wgmma_rs_tn(acc, pa[u][kk], dv);
    }
  }
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
}

// O += P V for f32, as three TF32 products Pb Vb + Pb Vs + Ps Vb with
// mma.sync m16n8k8, each warp its 16 rows (D = 128, where V^T does not fit
// for wgmma); mma.sync reads V's rows as TMA wrote them.
// P stays in registers: within each 8 keys, logical column c of the A
// fragment is key 2c and column c + 4 key 2c + 1, so the accumulator's own
// elements (4kk, 4kk+2; 4kk+1, 4kk+3) are the fragment, and B takes V's
// rows in the same order: b0 = V[8kk + 2c][n], b1 = V[8kk + 2c + 1][n].
// Element (row, col) of the f32 tile lives in box col / 32 at 16-byte
// chunk ((col % 32) / 4) ^ (row % 8) of its 128-byte row: for the 32 lanes
// (row % 8 = 2c or 2c + 1, col = 8j + g) that is 32 different banks.
template <int D>
__device__ __forceinline__ void pv_tf32(float (&acc)[32 * (D / 64)], const float (&sc)[32],
                                        const uint8_t* v_tile, int lane) {
  const int g = lane / 4, c4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ab[4], as[4];
    tf32_split(sc[4 * kk], ab[0], as[0]);
    tf32_split(sc[4 * kk + 2], ab[1], as[1]);
    tf32_split(sc[4 * kk + 1], ab[2], as[2]);
    tf32_split(sc[4 * kk + 3], ab[3], as[3]);
    const int r0 = 8 * kk + 2 * c4;  // r0 % 8 = 2 c4, r0 + 1 one more
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + g, cc = col % 32;
      const uint8_t* box = v_tile + (col / 32) * kBoxBytes + (cc % 4) * 4;
      const float v0 = *reinterpret_cast<const float*>(box + r0 * 128 + (((cc / 4) ^ (2 * c4)) * 16));
      const float v1 =
          *reinterpret_cast<const float*>(box + (r0 + 1) * 128 + (((cc / 4) ^ (2 * c4 + 1)) * 16));
      uint32_t b0, b1, s0, s1;
      tf32_split(v0, b0, s0);
      tf32_split(v1, b1, s1);
      mma_tf32(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3], ab, b0, b1);
      mma_tf32(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3], ab, s0, s1);
      mma_tf32(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3], as, b0, b1);
    }
  }
}

// O += P V for f32 at D = 64 on TF32 wgmma, the three products as
// pv_tf32 takes them. TF32 wgmma reads B K-major only, so the warpgroup
// first writes its V tile's TF32 parts transposed, V^T (64 columns of V by
// 64 keys, two boxes of 32 keys, swizzled as TMA writes K) into vt
// (big) and vts (small). Each 8 keys go in P's fragment order 0, 2, 4, 6,
// 1, 3, 5, 7 (see pv_tf32), so P's accumulator elements are the A
// fragment as they are. In step k thread t reads key t % 64, columns
// 4 (t / 64 + 2k)..: the eight lanes of a quarter warp read eight rows,
// each another 16-byte chunk of its 128 bytes, and a warp's 32 keys fill
// one 128-byte row of V^T, so neither side conflicts on the banks. The
// caller keeps vts free (the named barriers around this) and makes the
// writes visible to wgmma.
__device__ __forceinline__ void transpose_v_tf32(const uint8_t* v_tile, uint8_t* vt, uint8_t* vts,
                                                 int tid) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int key = tid % 64, c4 = tid / 64 + 2 * k;  // columns 4 c4..
    const float4 v = *reinterpret_cast<const float4*>(
        v_tile + (c4 / 8) * kBoxBytes + key * 128 + (((c4 % 8) ^ (key % 8)) * 16));
    const int r = key % 8, pos = key - r + (r % 2 ? 4 + r / 2 : r / 2);
    const int box = pos / 32, pp = pos % 32;
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * c4 + j;
      const int off = box * kBoxBytes + n * 128 + (((pp / 4) ^ (n % 8)) * 16) + (pp % 4) * 4;
      uint32_t big, small;
      tf32_split(e[j], big, small);
      *reinterpret_cast<uint32_t*>(vt + off) = big;
      *reinterpret_cast<uint32_t*>(vts + off) = small;
    }
  }
}

__device__ __forceinline__ void pv_tf32_wgmma(float (&acc)[32], const float (&sc)[32], uint32_t vt_s,
                                              uint32_t vts_s) {
  uint32_t ab[8][4], as[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    tf32_split(sc[4 * kk], ab[kk][0], as[kk][0]);
    tf32_split(sc[4 * kk + 2], ab[kk][1], as[kk][1]);
    tf32_split(sc[4 * kk + 1], ab[kk][2], as[kk][2]);
    tf32_split(sc[4 * kk + 3], ab[kk][3], as[kk][3]);
  }
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    const uint64_t vb = smem_desc(vt_s + off, 16), vs = smem_desc(vts_s + off, 16);
    wgmma_tf32_rs(acc, ab[kk], vb);
    wgmma_tf32_rs(acc, ab[kk], vs);
    wgmma_tf32_rs(acc, as[kk], vb);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, T* __restrict__ o, float* __restrict__ lse,
             int hq, int group, int lq, int lk, int causal, int lk_valid, int q_offset, float scale) {
  using SM = TcSmem<T, D>;
  constexpr int kStages = SM::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
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
      for (int c = 0; c < SM::kBoxes; ++c)
        tma_load_4d(q_s + c * kBoxBytes, &q_map, bar_q, SM::kBoxCols * c, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * SM::kTile);
        for (int c = 0; c < SM::kBoxes; ++c) {
          const int col = SM::kBoxCols * c;
          tma_load_4d(base + SM::kK + s * SM::kTile + c * kBoxBytes, &k_map, full, col, t * kBK, hk, b);
          tma_load_4d(base + SM::kV + s * SM::kTile + c * kBoxBytes, &v_map, full, col, t * kBK, hk, b);
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
  float acc[32 * (D / 64)];  // columns 64c.. in elements 32c..
#pragma unroll
  for (int i = 0; i < 32 * (D / 64); ++i) acc[i] = 0.0f;

  mbar_wait(bar_q, 0);
  if constexpr (SM::kF32) {  // Q's TF32 parts, once for both warpgroups
    split_tile(reinterpret_cast<float*>(gbase + SM::kQ), reinterpret_cast<float*>(gbase + SM::kQs),
               SM::kTile / 16, threadIdx.x, kConsumerThreads);
    fence_proxy_async();
    named_sync(1, kConsumerThreads);
  }
  for (int t = wg; t < n_tiles; t += kConsumers) {
    const int s = t % kStages;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    const uint32_t k_s = base + SM::kK + s * SM::kTile;
    const uint32_t v_s = base + SM::kV + s * SM::kTile;
    float sc[32];
    if constexpr (SM::kF32)
      scores_tf32<D>(sc, q_s, base + SM::kQs, k_s, base + SM::kKs + wg * 2 * kBoxBytes,
                     reinterpret_cast<float*>(gbase + SM::kK + s * SM::kTile),
                     reinterpret_cast<float*>(gbase + SM::kKs + wg * 2 * kBoxBytes), tid, wg);
    else
      scores_bf16<D>(sc, q_s, k_s);
    softmax_tile(sc, acc, m0, m1, l0, l1, t * kBK, q0, qpos0, qpos1, cq, kv_lim, causal, q_offset,
                 scale);
    if constexpr (SM::kPvWgmma) {
      const int ks = SM::kKs + wg * 2 * kBoxBytes, vt = SM::kVt + wg * 2 * kBoxBytes;
      named_sync(2 + wg, 128);  // every warp's score products have read ks
      transpose_v_tf32(gbase + SM::kV + s * SM::kTile, gbase + vt, gbase + ks, tid);
      fence_proxy_async();
      named_sync(2 + wg, 128);
      pv_tf32_wgmma(acc, sc, base + vt, base + ks);
    } else if constexpr (SM::kF32)
      pv_tf32<D>(acc, sc, gbase + SM::kV + s * SM::kTile, lane);
    else
      pv_bf16<D>(acc, sc, v_s);
    mbar_arrive(bar_empty + 8 * s);  // this stage may be refilled
  }

  // warpgroup 1 hands its m, l and acc to warpgroup 0 through the drained
  // stages (named barrier 1: the 256 consumer threads); 0 merges in order
  float* xchg = reinterpret_cast<float*>(gbase + SM::kXchg);
  named_sync(1, kConsumerThreads);
  if (wg == 1) {
    xchg[0 * 128 + tid] = m0;
    xchg[1 * 128 + tid] = m1;
    xchg[2 * 128 + tid] = l0;
    xchg[3 * 128 + tid] = l1;
#pragma unroll
    for (int i = 0; i < 32 * (D / 64); ++i) xchg[(4 + i) * 128 + tid] = acc[i];
  }
  named_sync(1, kConsumerThreads);
  if (wg == 1) return;
  {
    const float mo0 = xchg[tid], mo1 = xchg[128 + tid];
    const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
    const float a0 = expf(m0 - mn0), b0 = expf(mo0 - mn0);
    const float a1 = expf(m1 - mn1), b1 = expf(mo1 - mn1);
    l0 = l0 * a0 + xchg[2 * 128 + tid] * b0;
    l1 = l1 * a1 + xchg[3 * 128 + tid] * b1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < 32 * (D / 64); ++i) {
      const float other = xchg[(4 + i) * 128 + tid];
      acc[i] = (i / 2) % 2 ? acc[i] * a1 + other * b1 : acc[i] * a0 + other * b0;
    }
  }

  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long row_base = (static_cast<long long>(b) * hq + h) * lq;
  // the softmax stats a backward recomputes p from, when asked: lse = m +
  // log(l) in the units of s (scaled scores, natural log: exp_fast takes
  // e^x), 0 where l = 0 (a row no key reached); the 4 lanes of a row hold
  // the same m and l, and the first writes
  if (lse != nullptr && lane % 4 == 0) {
    if (qpos0 < lq) lse[row_base + qpos0] = l0 > 0.0f ? m0 + logf(l0) : 0.0f;
    if (qpos1 < lq) lse[row_base + qpos1] = l1 > 0.0f ? m1 + logf(l1) : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * c + 8 * i + cq;
      const float* a = acc + 32 * c + 4 * i;
      if constexpr (SM::kF32) {
        if (qpos0 < lq)
          *reinterpret_cast<float2*>(o + (row_base + qpos0) * D + col) = make_float2(a[0] / den0, a[1] / den0);
        if (qpos1 < lq)
          *reinterpret_cast<float2*>(o + (row_base + qpos1) * D + col) = make_float2(a[2] / den1, a[3] / den1);
      } else {
        if (qpos0 < lq)
          *reinterpret_cast<__nv_bfloat162*>(o + (row_base + qpos0) * D + col) =
              __floats2bfloat162_rn(a[0] / den0, a[1] / den0);
        if (qpos1 < lq)
          *reinterpret_cast<__nv_bfloat162*>(o + (row_base + qpos1) * D + col) =
              __floats2bfloat162_rn(a[2] / den1, a[3] / den1);
      }
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

// A tensor map over a (B, H, L, D) tensor of `elem`-byte elements (bf16 or
// f32) with element strides {batch, head, row} and unit stride along D, in
// boxes of 64 rows by one 128-byte swizzle row (64 bf16 or 32 f32); reads
// past its extent fill zeros. A dim of extent 1 takes the packed stride
// (TMA wants every stride a multiple of 16 bytes, and torch may give such
// a dim any stride).
bool make_map(CUtensorMap* map, const void* ptr, const long long* strides, int b, int h, int l,
              int d, int elem) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(l),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  cuuint64_t bytes[3];
  cuuint64_t packed = static_cast<cuuint64_t>(d) * elem;
  for (int i = 0; i < 3; ++i) {
    const long long s = strides[2 - i];  // row, head, batch
    bytes[i] = dims[i + 1] == 1 ? packed : static_cast<cuuint64_t>(s) * elem;
    packed = bytes[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem), 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(ptr), dims, bytes, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_tc(const void* q, const long long* qs, const void* k, const long long* ks,
              const void* v, const long long* vs, void* o, float* lse, int b, int hq, int hkv,
              int lq, int lk, int causal, int lk_valid, int q_offset, float scale, cudaStream_t st) {
  constexpr int kElem = sizeof(T);
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, qs, b, hq, lq, D, kElem) || !make_map(&km, k, ks, b, hkv, lk, D, kElem) ||
      !make_map(&vm, v, vs, b, hkv, lk, D, kElem))
    return kTensorMapError;
  auto kern = fa_tc_kernel<T, D>;
  const size_t smem = TcSmem<T, D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
  kern<<<grid, kTcThreads, smem, st>>>(qm, km, vm, static_cast<T*>(o), lse, hq, hq / hkv, lq, lk,
                                       causal, lk_valid, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  if (code == kTensorMapError) return "cuTensorMapEncodeTiled refused a tensor map for q, k or v";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), each with element strides
// {batch, head, row} and unit stride along D; o (B, Hq, Lq, D) contiguous;
// lse null, or f32 (B, Hq, Lq) contiguous for each row's log-sum-exp of
// its scaled, masked scores (0 for a row no key reached).
// kind: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Returns a CUDA error
// code (cudaErrorInvalidValue for a kind or head_dim not built).
int fa_forward(const void* q, const long long* q_strides, const void* k,
               const long long* k_strides, const void* v, const long long* v_strides,
               void* o, int kind, int head_dim, int b, int hq, int hkv, int lq, int lk,
               int causal, int lk_valid, int q_offset, float scale, float* lse, void* stream) {
  if (b == 0 || lq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, q_strides, k, k_strides, v, v_strides, o, lse, b, hq, hkv, lq, lk, causal, \
                lk_valid, q_offset, scale, st
  if (kind == 0 && head_dim == 64) return launch_tc<float, 64>(FA_ARGS);
  if (kind == 0 && head_dim == 128) return launch_tc<float, 128>(FA_ARGS);
  if (kind == 1 && head_dim == 64) return launch_tc<__nv_bfloat16, 64>(FA_ARGS);
  if (kind == 1 && head_dim == 128) return launch_tc<__nv_bfloat16, 128>(FA_ARGS);
#undef FA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
