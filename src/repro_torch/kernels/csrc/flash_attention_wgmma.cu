// GQA flash attention (forward) in bf16 on Hopper's tensor cores, causal or
// not, with an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:29
// (_flash_kernel, launched by flash_attention_hsd at :95 through
// pl.pallas_call). That kernel ran a (B, H, q-tile, kv-tile) grid whose kv
// axis is sequential on the TensorCore, kept the online-softmax state
// (m, l, acc) in VMEM scratch across kv steps, skipped tiles outside the
// causal/window band with pl.when, and fed both products to the MXU.
//
// Computes what that kernel and csrc/flash_attention.cu (the f32 path)
// compute: q (B, H, S, D), k (B, KH, S, D), v (B, KH, S, Dv), o (B, H, S,
// Dv), all bf16 and contiguous; kv head h / (H / KH); the caller's scale
// (D^-0.5 by default) applied to the f32 scores; mask pos_k <= pos_q when
// causal, and pos_k > pos_q - window when window > 0, with a -1e30
// sentinel; each row ends divided by max(l, 1e-30). Any S (ragged edges
// masked); Sq == Skv only (the wrapper enforces it).
//
// What bounds it on Hopper: operations at the global shapes (4*D flops a
// live (q, k) pair against q, k, v and o moved once: at S = 32768 the
// operations take ~40x longer than the bytes at the bf16 tensor-core rate),
// and launch and tail latency at window 512, where each 128-row tile meets
// only 5-11 kv tiles. The design answers:
//   * both products on the bf16 tensor cores with wgmma (f32 accumulators):
//     S = Q.K^T with both operands in shared memory (K-major), then
//     O += P.V with P in registers as the A operand and V read MN-major from
//     shared memory (the transpose bit of bf16 wgmma), so P never goes
//     through shared memory;
//   * tiles arrive by TMA: one producer thread loads Q once and streams K and
//     V tiles into a ring of STAGES shared-memory slots, each signalled by an
//     mbarrier (expect_tx), and the consumers release a slot by arriving on
//     its "empty" barrier; loads stay in flight while the consumers compute.
//     The tensor maps cover the 4-D view (D, S, heads, B) with 128-byte
//     swizzled boxes of 64 columns, the layout wgmma reads without bank
//     conflicts; rows past S and columns past D come back as zeros, so
//     D = 16, 32, 96 and 112 run padded to 64, 128 (the zero columns add
//     nothing) and a ragged last tile needs no special load;
//   * V has a head dim of its own (MLA: Dk = 96 or 192 against Dv = 64 or
//     128), a template parameter and not a padding of V: the V ring, V's and
//     O's tensor maps and the O accumulator are DVP (Dv in whole 64-column
//     boxes) wide, so P.V and the output store run at Dv, and Q.K^T walks the
//     DP / 64 boxes of Q and K whatever their count (3 at Dk = 192);
//   * one CTA per (128 query rows, head, batch): two consumer warpgroups of
//     64 rows each, plus a producer warpgroup that gives its registers to
//     them (setmaxnreg), so the f32 accumulator of 64 x 256 (128 registers a
//     thread at D = 256) fits without spills; while one warpgroup runs its
//     softmax the other's wgmma keeps the tensor cores busy;
//   * the kv loop visits only the tiles that meet the CTA's causal/window
//     band, a warpgroup skips a tile that is wholly outside its own rows'
//     band, the element mask runs only on tiles that cross an edge (the
//     diagonal, the window's start, the end of S), and the heaviest (latest)
//     q tiles are scheduled first;
//   * the softmax runs in base 2 on scores pre-multiplied by scale * log2(e)
//     (one multiply, one subtract, one ex2.approx per score); m and l stay in
//     f32, l sums the f32 probabilities, and only the copy of P fed to the
//     P.V product is rounded to bf16 -- the one rounding the f32 plain
//     version does not do;
//   * nothing spills (ptxas -v): mbarrier waits carry no watchdog trap (a
//     __trap() there made ptxas spill and serialise the wgmma pipeline),
//     and the epilogue multiplies by an approximate reciprocal instead of
//     calling IEEE division's slow path; the one fused multiply-add is
//     explicit, so the repository's -fmad=false flag (kept for the JRBA
//     kernel's bit identity) changes nothing here.
// The host side (box sizes, stages, shared-memory bytes, grid) is planned in
// kernels/flash_attention.py (wgmma_plan); the launcher checks that the plan
// matches the compiled instance. cuTensorMapEncodeTiled is a driver-API
// function, reached through cudaGetDriverEntryPointByVersion so the library links
// only the runtime.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;           // query rows of a CTA: two consumer warpgroups of 64
constexpr int COLS = 64;          // bf16 columns of one 128-byte swizzled box
constexpr int ROW_BYTES = 128;    // bytes of one box row
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;    // threads that arrive on a slot's "empty" barrier
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65536
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PLAN_MISMATCH = -1;     // the host's plan is not a compiled instance
constexpr int ENCODE_ERROR = 10000;   // + the CUresult of cuTensorMapEncodeTiled

// Shared memory of one instance; kernels/flash_attention.py (WgmmaPlan)
// computes the same bytes.
template <int DP, int DVP, int BK, int STAGES>
struct Layout {
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int K_BYTES = BK * DP * 2;   // one K tile
  static constexpr int V_BYTES = BK * DVP * 2;  // one V tile
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  static constexpr int BARRIERS = 1 + 3 * STAGES;  // q, and k full, v full, empty per slot
  static constexpr int SMEM = 1024 + BAR_OFFSET + 8 * BARRIERS;  // 1024: alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Waits for the phase of ``parity`` to complete. (No watchdog: a __trap()
// here makes ptxas spill and serialise the wgmma pipeline.)
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

// one 128-byte-swizzled box of the 4-D tensor map into shared memory,
// completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand (layout
// type 1): start address, leading and stride byte offsets, each >> 4. A
// descriptor plus (bytes >> 4) starts that many bytes later (addresses stay
// below 2^18, so the 14-bit field never carries).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads of wgmma accumulators across the wait
template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x in one MUFU instruction (about 2^-22 relative error; flushes results
// below 2^-126 to 0, nothing next to the row's largest p of 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 in, f32 accumulators (d[4c..4c+3]: rows r and r+8 of
// columns 8c + 2*(lane%4) and +1, r = 16*warp + lane/4). wgmma_ss: A and B
// K-major in shared memory, scale_d 0 overwrites d. wgmma_rs: A in registers
// (the m16n8k16 A fragment of each warp's 16 rows), B MN-major in shared
// memory, accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The CTA's tile: the heaviest (latest) q tiles first, every (batch, head) of
// a tile together; the kv tiles of BK keys that meet its causal/window band
// (when not causal, every tile from the window's start to the end of S).
// Each warpgroup computes it after its setmaxnreg, so no value lives across
// the change of register budget.
struct Tile {
  int b, h, kh, bh, q0, t0, ntiles;
};

template <int BK>
__device__ __forceinline__ Tile tile_of(int H, int KH, int S, int window, int causal) {
  const int nq = (S + BQ - 1) / BQ;
  const int BH = gridDim.x / nq;
  Tile t;
  t.bh = blockIdx.x % BH;
  t.b = t.bh / H;
  t.h = t.bh % H;
  t.kh = t.h / (H / KH);
  t.q0 = (nq - 1 - blockIdx.x / BH) * BQ;
  const int k_last = causal ? min(t.q0 + BQ, S) - 1 : S - 1;
  const int k_first = window > 0 ? max(0, t.q0 - window + 1) : 0;
  t.t0 = k_first / BK;
  t.ntiles = k_last / BK - t.t0 + 1;
  return t;
}

template <int DP, int DVP, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H,
                int KH, int S, int Dv, int window, int causal, float scale_log2) {
  using L = Layout<DP, DVP, BK, STAGES>;
  static_assert(DP % COLS == 0 && DVP % COLS == 0 && BK % 16 == 0, "tile shapes");
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                       // [DP/64][BQ rows][128 B]
  const uint32_t sK = base + L::Q_BYTES;          // STAGES x [DP/64][BK rows][128 B]
  const uint32_t sV = sK + STAGES * L::K_BYTES;   // STAGES x [DVP/64][BK rows][128 B]
  const uint32_t q_full = base + L::BAR_OFFSET;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const Tile t = tile_of<BK>(H, KH, S, window, causal);
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DP / COLS; ++c)
        tma_load(sQ + c * BQ * ROW_BYTES, &tq, q_full, c * COLS, t.q0, t.h, t.b);
      for (int j = 0; j < t.ntiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);  // the first round passes at once
        const int k0 = (t.t0 + j) * BK;
        const uint32_t kdst = sK + s * L::K_BYTES, vdst = sV + s * L::V_BYTES;
        mbar_expect_tx(k_full(s), L::K_BYTES);
#pragma unroll
        for (int c = 0; c < DP / COLS; ++c)
          tma_load(kdst + c * BK * ROW_BYTES, &tk, k_full(s), c * COLS, k0, t.kh, t.b);
        mbar_expect_tx(v_full(s), L::V_BYTES);
#pragma unroll
        for (int c = 0; c < DVP / COLS; ++c)
          tma_load(vdst + c * BK * ROW_BYTES, &tv, v_full(s), c * COLS, k0, t.kh, t.b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows q0 + 64*cw .. +63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const Tile t = tile_of<BK>(H, KH, S, window, causal);
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32, lane = tid % 32;
  const int qw0 = t.q0 + 64 * cw;
  const int qw_last = min(qw0 + 63, S - 1);
  const int row0 = qw0 + 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int col0 = 2 * (lane % 4);              // and columns col0, col0 + 1 of each 8
  const uint32_t qa = sQ + cw * 64 * ROW_BYTES;

  float acc[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's partial row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < t.ntiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int k0 = (t.t0 + j) * BK;
    // does the tile meet this warpgroup's band at all?
    const bool live =
        qw0 < S && (!causal || k0 <= qw_last) && !(window > 0 && k0 + BK - 1 <= qw0 - window);
    mbar_wait(k_full(s), parity);
    if (live) {
      // Q (this warpgroup's 64 rows) and K, both K-major: a k-step of 16
      // columns is 32 bytes inside a swizzled row, a 64-column box BQ*128
      // (Q) or BK*128 (K) bytes further; 8-row groups 1024 bytes apart
      const uint64_t dq = smem_desc(qa, 16, 1024);
      const uint64_t dk = smem_desc(sK + s * L::K_BYTES, 16, 1024);
      float sc[BK / 2];
      wg_fence();
#pragma unroll
      for (int c = 0; c < DP / COLS; ++c)
#pragma unroll
        for (int kk = 0; kk < COLS / 16; ++kk)
          wgmma_ss(sc, dq + ((c * BQ * ROW_BYTES + kk * 32) >> 4),
                   dk + ((c * BK * ROW_BYTES + kk * 32) >> 4), (c | kk) != 0);
      wg_commit();
      wg_wait_all();
      reg_fence(sc);

      // scores in log2 units; the element mask only where the tile crosses
      // the diagonal (when causal), the window's start or the end of S
      const bool edge = (causal && k0 + BK - 1 > qw0) || k0 + BK > S ||
                        (window > 0 && k0 <= qw_last - window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float u = sc[i] * scale_log2;
        if (edge) {
          const int pq = row0 + 8 * ((i >> 1) & 1);
          const int pk = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const bool in = (!causal || pk <= pq) && pk < S && (window <= 0 || pk > pq - window);
          u = in ? u : NEG_INF;
        }
        sc[i] = u;
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // a row's 64 columns are spread over the 4 lanes of a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(sc[i] - m[r]);
        sum[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], corr[r], sum[r]);
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // P in bf16 as the A fragments of BK/16 k-steps: k-step kk takes the
      // accumulator columns 16kk..16kk+15, which this thread already holds
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      mbar_wait(v_full(s), parity);
      reg_fence(acc);
      wg_fence();
      // V tile: keys are K (16 a step, 2048 bytes), head columns are N,
      // MN-major: 64-column boxes BK*128 bytes apart, 8-key groups 1024 apart
      const uint64_t dv = smem_desc(sV + s * L::V_BYTES, BK * ROW_BYTES, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, pa[kk], dv + ((kk * 16 * ROW_BYTES) >> 4));
      wg_commit();
      wg_wait_all();
      reg_fence(acc);
    } else {
      mbar_wait(v_full(s), parity);  // the slot is released only once it is filled
    }
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    // 1 / max(l, 1e-30) to about 1 ulp, then bf16: IEEE division branches
    // to a slow-path subroutine, which cost 2-16% of the kernel's time
    float inv;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(fmaxf(l[r], 1e-30f)));
    __nv_bfloat16* out = o + ((size_t)t.bh * S + row) * Dv;
#pragma unroll
    for (int c = 0; c < DVP / 8; ++c) {
      const int col = 8 * c + col0;
      if (col < Dv)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    // the CUDA 12.0 ABI of the function (runtime 12.5 or later)
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-D view (D, S, heads, B) of a contiguous (B, heads, S, D) bf16 tensor,
// read in boxes of 64 columns x ``rows`` rows with the 128-byte swizzle;
// out-of-bounds elements read as zero
int tensor_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2,
                                 (cuuint64_t)heads * S * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)COLS, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <int DP, int DVP, int BK, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH, int S,
           int D, int Dv, int window, int causal, float scale, int block_k, int stages,
           int smem, int grid, cudaStream_t stream) {
  using L = Layout<DP, DVP, BK, STAGES>;
  static_assert(L::SMEM <= 232448, "the tiles exceed a block's shared memory");
  const int tiles = (S + BQ - 1) / BQ;
  if (block_k != BK || stages != STAGES || smem != L::SMEM || grid != tiles * B * H)
    return PLAN_MISMATCH;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, D, S, H, B, BQ);
  if (!err) err = tensor_map(&tk, k, D, S, KH, B, BK);
  if (!err) err = tensor_map(&tv, v, Dv, S, KH, B, BK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma<DP, DVP, BK, STAGES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_wgmma<DP, DVP, BK, STAGES><<<grid, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, KH, S, Dv, window, causal != 0,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel instance of the plan (d_pad, dv_pad, block_k, stages,
// smem_bytes, grid) that kernels/flash_attention.py computed; D is q's and
// k's head dim, Dv v's and o's; causal is 0 or 1, scale multiplies the f32
// scores. Returns 0 on success, a cudaError_t code, PLAN_MISMATCH (-1) when
// the plan is not a compiled instance's, or ENCODE_ERROR (10000) + the
// CUresult of a failed cuTensorMapEncodeTiled. Does not synchronise.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            int B, int H, int KH, int S, int D, int Dv,
                                            int window, int causal, float scale, int d_pad,
                                            int dv_pad, int block_k, int stages, int smem_bytes,
                                            int grid, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || S < 1 || D < 8 || D % 8 != 0 || D > d_pad ||
      Dv < 8 || Dv % 8 != 0 || Dv > dv_pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_WGMMA(DP, DVP, BK)                                                                 \
  if (d_pad == DP && dv_pad == DVP)                                                              \
    return launch<DP, DVP, BK, 2>(q, k, v, o, B, H, KH, S, D, Dv, window, causal, scale, block_k, \
                                  stages, smem_bytes, grid, st);
  FLASH_WGMMA(64, 64, 128)
  FLASH_WGMMA(128, 128, 128)
  FLASH_WGMMA(256, 256, 64)
  FLASH_WGMMA(128, 64, 128)   // minicpm3-4b's MLA: Dk = 96, Dv = 64
  FLASH_WGMMA(192, 128, 128)  // deepseek-v2's MLA: Dk = 192, Dv = 128
#undef FLASH_WGMMA
  return PLAN_MISMATCH;
}
