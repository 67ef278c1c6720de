// RWKV-6 (Finch) wkv scan (forward), bf16 on the tensor cores: y only, as the
// TPU kernel returns it.
//
// Replaces, for bf16 tensors, the TPU kernel src/repro/kernels/rwkv6.py
// (_rwkv6_kernel, launched by rwkv6_scan_hsd through pl.pallas_call). That
// kernel ran a (B, H, chunk) grid whose chunk axis is sequential on the
// TensorCore, carried the P x P f32 state S[p_key][p_val] in VMEM scratch and
// computed a chunk's products as dot_generals on the MXU. f32 tensors take
// csrc/rwkv6_scan.cu (exact f32 on the CUDA cores).
//
// Per chunk of Q <= 16 rows, with cw the inclusive cumsum of logw (<= 0) and
// cw_prev = cw - logw:
//   qn = r exp(cw_prev) (<= |r|),  kn = k exp(-cw) (<= e^(Q |logw|_max) |k|)
//   A[i][j] = qn_i . kn_j for j < i,  r_i . (u * k_i) for j == i,  0 above
//   y_i     = sum_j A[i][j] v_j + qn_i . S
//   S       = diag(exp(cw_Q)) S + sum_j (k_j exp(cw_Q - cw_j)) v_j^T
// The factorization against the chunk start is exact while kn stays finite
// (e^43.5 at Q = 16 under the model's clamp |logw| <= e), so the wrapper
// refuses Q > 16. The mask is a select, never a product: above the diagonal
// qn . kn may be huge. A chunk shorter than 16 rows is padded with zero rows
// (r = k = v = logw = 0), which change nothing.
//
// Layout: r, k, v (B, H, S, P) and y bf16, logw (B, H, S, P) f32, u (H, P)
// f32; every tensor is read through the strides the launcher is given, with
// only its last axis dense, so the model's (B, S, H, P) tensors are read in
// place.
//
// What bounds it on Hopper: the bytes (r, k, v, y bf16 and logw f32, 1.0 GB
// at rwkv6-3b's S=32768, 0.30 ms at 3.35 TB/s) against ~5e10 operations. The
// first version (csrc/rwkv6_scan.cu) ran every product as f32 FMAs on the
// CUDA cores, a block per (b, h, 16 value columns) walking all 2048 chunks
// with five block barriers each: 160 blocks for 132 SMs, bound by that
// chain's latency, 63x its bound. This one answers that:
//   * the products run on the tensor cores as mma.sync m16n8k16 (a chunk of
//     16 rows is one m16 tile, P = 64 four k16 steps) with f32 accumulators;
//     mma.sync and not wgmma: the products are 16 to 64 wide;
//   * the operands built in f32 (qn, kn, A, kdec and the state) enter their
//     products as bf16 hi + lo pairs: hi.hi + hi.lo + lo.hi where both sides
//     are built, hi.x + lo.x where the other side (v) is bf16 already.
//     Rounded to bf16 alone they take the scan past the agreement limit,
//     where the pairs stay well inside it (tests/test_torch_ssm.py emulates
//     both sets of rounding points on the CPU);
//   * the state stays f32 in accumulator fragments from chunk to chunk, held
//     transposed (value column q by key channel p): that layout is exactly
//     the B operand qn . S reads, so the state never leaves registers; kdec
//     goes through a small shared tile to reach the layout of its product;
//   * each warp works alone, with no block barrier: a block is one warp that
//     owns (b, h, a segment of the sequence, NCOL value columns). It loads
//     its chunks by cp.async one chunk ahead into two stages, scans the
//     chunk's decays itself (a thread per two key channels) and orders its
//     shared tiles with __syncwarp;
//   * parallelism beyond the 40 (b, h) pairs of rwkv6-3b: the sequence is cut
//     into segments (the chunked state-passing scheme of flash-linear-
//     attention). Grid 1 runs every segment but the last from a zero state
//     and stores its end state and its summed log decay; grid 2 passes the
//     states along, S_in[s] = diag(exp(ld[s-1])) S_in[s-1] + S_end[s-1], in
//     place; grid 3 runs every segment from its S_in and writes y. A
//     sequence of one segment runs grid 3 alone, from zero.
// Exponentials are ex2.approx of x log2(e) (relative error near 2^-21, below
// the hi + lo pairs' 2^-17).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_pass.cuh"

namespace {

constexpr int QT = 16;  // rows of a chunk tile (chunks shorter than 16 are zero-padded)
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long r_b, r_h, r_s;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long w_b, w_h, w_s;
  long long y_b, y_h, y_s;
};

// Shared memory of one warp (bytes): two stages of a chunk (r, k, v in bf16,
// logw in f32 with a 17th row for the chunk's total decay) and the hi and lo
// parts of kdec.
template <int P, int NCOL>
struct Smem {
  static constexpr int RS = P + 8;     // bf16 row stride of r, k and kdec: no ldmatrix conflicts
  static constexpr int VS = NCOL + 8;  // bf16 row stride of v
  static constexpr int WS = P + 8;     // f32 row stride of logw
  static constexpr int R_OFF = 0;
  static constexpr int K_OFF = R_OFF + QT * RS * 2;
  static constexpr int V_OFF = K_OFF + QT * RS * 2;
  static constexpr int W_OFF = V_OFF + QT * VS * 2;
  static constexpr int STAGE = W_OFF + (QT + 1) * WS * 4;
  static constexpr int KD_OFF = 2 * STAGE;  // [hi, lo][QT][RS]
  static constexpr int BYTES = KD_OFF + 2 * QT * RS * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where ``in`` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float exp_(float x) { return ex2(x * LOG2E); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}

// (a, b) as bf16 hi and lo parts: hi + lo carries 16 significant bits, and
// a product fed both parts is exact to about 2^-17 (x - hi is exact in f32)
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack(a, b);
  const float2 h = unpack(hi);
  lo = pack(a - h.x, b - h.y);
}

// Issue the loads of one chunk (rows c0..c0+Q-1; rows Q..15 zero) into a
// stage: 16-byte cp.async where every row is 16-byte aligned (vec), else
// plain loads and stores. Without r (the state pass) only k, v and logw.
template <int P, int NCOL, bool WITH_R>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const __nv_bfloat16* rb,
                                           const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                           const float* wb, long long c0, int Q,
                                           const Strides& st, bool vec) {
  using L = Smem<P, NCOL>;
  __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(stage + L::R_OFF);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(stage + L::K_OFF);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(stage + L::V_OFF);
  float* ws = reinterpret_cast<float*>(stage + L::W_OFF);
  const int lane = threadIdx.x & 31;
  if (vec) {
    constexpr int GB = P / 8, GV = NCOL / 8, GW = P / 4;  // 16-byte granules a row
    for (int i = lane; i < QT * GB; i += 32) {
      const int r = i / GB, g = 8 * (i - r * GB);
      const bool in = r < Q;
      const long long row = c0 + (in ? r : 0);
      if (WITH_R) cp_async16(rs + r * L::RS + g, rb + row * st.r_s + g, in);
      cp_async16(ks + r * L::RS + g, kb + row * st.k_s + g, in);
    }
    for (int i = lane; i < QT * GV; i += 32) {
      const int r = i / GV, g = 8 * (i - r * GV);
      const bool in = r < Q;
      cp_async16(vs + r * L::VS + g, vb + (c0 + (in ? r : 0)) * st.v_s + g, in);
    }
    for (int i = lane; i < QT * GW; i += 32) {
      const int r = i / GW, g = 4 * (i - r * GW);
      const bool in = r < Q;
      cp_async16(ws + r * L::WS + g, wb + (c0 + (in ? r : 0)) * st.w_s + g, in);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = lane; i < QT * P; i += 32) {
      const int r = i / P, p = i - r * P;
      const bool in = r < Q;
      if (WITH_R) rs[r * L::RS + p] = in ? rb[(c0 + r) * st.r_s + p] : zero;
      ks[r * L::RS + p] = in ? kb[(c0 + r) * st.k_s + p] : zero;
      ws[r * L::WS + p] = in ? wb[(c0 + r) * st.w_s + p] : 0.f;
    }
    for (int i = lane; i < QT * NCOL; i += 32) {
      const int r = i / NCOL, p = i - r * NCOL;
      vs[r * L::VS + p] = r < Q ? vb[(c0 + r) * st.v_s + p] : zero;
    }
  }
  cp_async_commit();
}

// One warp: (b, h, segment, NCOL value columns). WITH_Y: run the segment
// from its entering state (zero, or ``state`` when it holds one) and write y;
// else run it from zero and store its end state in ``state`` and its summed
// log decay in ``decay``.
template <int P, int NCOL, bool WITH_Y>
__global__ void __launch_bounds__(32)
rwkv6_mma_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, __nv_bfloat16* __restrict__ y,
                 float* __restrict__ state, float* __restrict__ decay, int H, int S, int Q,
                 int seg_chunks, int nseg, Strides st, int vec) {
  static_assert(P % 16 == 0 && P <= 64 && NCOL % 16 == 0 && NCOL <= P, "P, NCOL");
  using L = Smem<P, NCOL>;
  constexpr int KS = P / 16;    // k16 steps over the key channels
  constexpr int NP = P / 8;     // n8 tiles of the state over the key channels
  constexpr int MQ = NCOL / 16; // m16 tiles of the state over this warp's value columns
  constexpr int NY = NCOL / 8;  // n8 tiles of y
  extern __shared__ __align__(128) unsigned char smem[];

  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row within a matrix, matrix
  const int col0 = blockIdx.x * NCOL, seg = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh - b * H;
  const __nv_bfloat16* rb = r + b * st.r_b + h * st.r_h;
  const __nv_bfloat16* kb = k + b * st.k_b + h * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + h * st.v_h + col0;
  const float* wb = logw + b * st.w_b + h * st.w_h;
  __nv_bfloat16* kdh = reinterpret_cast<__nv_bfloat16*>(smem + L::KD_OFF);
  __nv_bfloat16* kdl = kdh + QT * L::RS;
  // this segment's state in the workspace, [q][p] (none for one segment)
  float* seg_state = nseg > 1 ? state + ((size_t)bh * nseg + seg) * P * P : nullptr;

  const int nchunks = S / Q;
  const int c_begin = seg * seg_chunks;
  const int c_end = min(nchunks, c_begin + seg_chunks);

  // the state, transposed: tile (mq, np) holds value columns col0 + 16 mq +
  // g (+8) by key channels 8 np + 2t (+1)
  float sa[MQ][NP][4];
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      float2 a = make_float2(0.f, 0.f), c = a;
      if (WITH_Y && nseg > 1) {
        const float* s0 = seg_state + (size_t)(col0 + 16 * mq + g) * P + 8 * np + 2 * t;
        a = *reinterpret_cast<const float2*>(s0);
        c = *reinterpret_cast<const float2*>(s0 + 8 * P);
      }
      sa[mq][np][0] = a.x;
      sa[mq][np][1] = a.y;
      sa[mq][np][2] = c.x;
      sa[mq][np][3] = c.y;
    }
  const float* uh = u + h * P;  // read where used: registers are the scarce resource
  float2 ld = make_float2(0.f, 0.f);  // the segment's summed log decay, channels 2 lane (+1)

  load_chunk<P, NCOL, WITH_Y>(smem, rb, kb, vb, wb, (long long)c_begin * Q, Q, st, vec);
  for (int c = c_begin; c < c_end; ++c) {
    unsigned char* stage = smem + ((c - c_begin) & 1) * L::STAGE;
    const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(stage + L::R_OFF);
    const __nv_bfloat16* ks_ = reinterpret_cast<const __nv_bfloat16*>(stage + L::K_OFF);
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(stage + L::V_OFF);
    float* ws = reinterpret_cast<float*>(stage + L::W_OFF);
    cp_async_wait_all();
    __syncwarp();  // the chunk is in its stage; the other stage's readers are done
    if (c + 1 < c_end)
      load_chunk<P, NCOL, WITH_Y>(smem + ((c + 1 - c_begin) & 1) * L::STAGE, rb, kb, vb, wb,
                                  (long long)(c + 1) * Q, Q, st, vec);

    // the decays' exclusive cumsums, in place (row i: cw_prev_i, row 16: the
    // chunk's total), a thread per two key channels
    if (2 * lane < P) {
      float2 run = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        float2* w = reinterpret_cast<float2*>(ws + i * L::WS + 2 * lane);
        const float2 x = *w;
        *w = run;
        run.x += x.x;
        run.y += x.y;
      }
      *reinterpret_cast<float2*>(ws + QT * L::WS + 2 * lane) = run;
      ld.x += run.x;
      ld.y += run.y;
    }
    __syncwarp();

    float gacc[2][4], yacc[NY][4];
    float bon[2] = {0.f, 0.f};  // the u bonus of rows g and g + 8, this thread's channels
    if (WITH_Y) {
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[0][e] = gacc[1][e] = 0.f;
#pragma unroll
      for (int n = 0; n < NY; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // this thread's positions: rows g and g + 8, key channels
      // 16 ks + 8 hh + 2t (+1), in the m16n8k16 fragment layouts
      uint32_t qh[4], ql[4], knh[2][2], knl[2][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 16 * ks + 8 * hh + 2 * t;
        const float2 end = *reinterpret_cast<const float2*>(ws + QT * L::WS + p);
        const float2 uu = WITH_Y ? __ldg(reinterpret_cast<const float2*>(uh + p))
                                 : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = g + 8 * half;
          const float2 kk = unpack(*reinterpret_cast<const uint32_t*>(ks_ + i * L::RS + p));
          const float2 cwp = *reinterpret_cast<const float2*>(ws + i * L::WS + p);
          const float2 cw = *reinterpret_cast<const float2*>(ws + (i + 1) * L::WS + p);
          uint32_t hi, lo;
          split(kk.x * exp_(end.x - cw.x), kk.y * exp_(end.y - cw.y), hi, lo);
          *reinterpret_cast<uint32_t*>(kdh + i * L::RS + p) = hi;
          *reinterpret_cast<uint32_t*>(kdl + i * L::RS + p) = lo;
          if (WITH_Y) {
            const float2 rr = unpack(*reinterpret_cast<const uint32_t*>(rs + i * L::RS + p));
            split(rr.x * exp_(cwp.x), rr.y * exp_(cwp.y), qh[2 * hh + half], ql[2 * hh + half]);
            split(kk.x * exp_(-cw.x), kk.y * exp_(-cw.y), knh[half][hh], knl[half][hh]);
            bon[half] += rr.x * uu.x * kk.x + rr.y * uu.y * kk.y;
          }
        }
      }
      if (WITH_Y) {
        // G = qn kn^T over this k-step: n-tile 0 is keys j = 0..7, 1 is 8..15
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma(gacc[nt], qh, knh[nt][0], knh[nt][1]);
          mma(gacc[nt], qh, knl[nt][0], knl[nt][1]);
          mma(gacc[nt], ql, knh[nt][0], knh[nt][1]);
        }
        // y += qn S: the B fragments come from the state's own registers
#pragma unroll
        for (int n = 0; n < NY; ++n) {
          const int mq = n >> 1, e0 = 2 * (n & 1);
          uint32_t b0h, b0l, b1h, b1l;
          split(sa[mq][2 * ks][e0], sa[mq][2 * ks][e0 + 1], b0h, b0l);
          split(sa[mq][2 * ks + 1][e0], sa[mq][2 * ks + 1][e0 + 1], b1h, b1l);
          mma(yacc[n], qh, b0h, b1h);
          mma(yacc[n], qh, b0l, b1l);
          mma(yacc[n], ql, b0h, b1h);
        }
      }
    }
    __syncwarp();  // kdec's hi and lo tiles are complete

    if (WITH_Y) {
      // the bonus over all key channels: the quad's four threads
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        bon[half] += __shfl_xor_sync(0xffffffffu, bon[half], 1);
        bon[half] += __shfl_xor_sync(0xffffffffu, bon[half], 2);
      }
      // A from G's accumulators (the A fragment layout over keys j), masked
      // by a select: G below the diagonal, the bonus on it, zero above
      uint32_t ah[4], al[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = g + 8 * half;
          float a2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * nt + 2 * t + e;
            a2[e] = j < i ? gacc[nt][2 * half + e] : (j == i ? bon[half] : 0.f);
          }
          split(a2[0], a2[1], ah[2 * nt + half], al[2 * nt + half]);
        }
      // y += A v
#pragma unroll
      for (int n = 0; n < NY; n += 2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vs + ((lm & 1) * 8 + lr) * L::VS + 8 * n + (lm >> 1) * 8);
        mma(yacc[n], ah, vf[0], vf[1]);
        mma(yacc[n], al, vf[0], vf[1]);
        mma(yacc[n + 1], ah, vf[2], vf[3]);
        mma(yacc[n + 1], al, vf[2], vf[3]);
      }
      __nv_bfloat16* yrow = y + b * st.y_b + h * st.y_h + col0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = g + 8 * half;
        if (i < Q) {
          __nv_bfloat16* out = yrow + ((long long)c * Q + i) * st.y_s;
#pragma unroll
          for (int n = 0; n < NY; ++n)
            *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) =
                pack(yacc[n][2 * half], yacc[n][2 * half + 1]);
        }
      }
    }

    // S = diag(exp(cw_Q)) S + kdec^T v, held transposed: S^T += v^T kdec,
    // v^T straight from the stage (bf16), kdec as hi + lo
    uint32_t va[MQ][4];
#pragma unroll
    for (int mq = 0; mq < MQ; ++mq)
      ldsm_x4_t(va[mq], vs + ((lm >> 1) * 8 + lr) * L::VS + 16 * mq + (lm & 1) * 8);
#pragma unroll
    for (int np = 0; np < NP; np += 2) {
      // exp(cw_Q) at this thread's channels of the two n-tiles, from the
      // stage's total row (it stays until the chunk after next is loaded)
      float dec[2][2];
#pragma unroll
      for (int q2 = 0; q2 < 2; ++q2) {
        const float2 end =
            *reinterpret_cast<const float2*>(ws + QT * L::WS + 8 * (np + q2) + 2 * t);
        dec[q2][0] = exp_(end.x);
        dec[q2][1] = exp_(end.y);
      }
      uint32_t kh[4], kl[4];
      ldsm_x4_t(kh, kdh + ((lm & 1) * 8 + lr) * L::RS + 8 * np + (lm >> 1) * 8);
      ldsm_x4_t(kl, kdl + ((lm & 1) * 8 + lr) * L::RS + 8 * np + (lm >> 1) * 8);
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq) {
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) {
          const int n = np + q2;
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[mq][n][e] *= dec[q2][e & 1];
          mma(sa[mq][n], va[mq], kh[2 * q2], kh[2 * q2 + 1]);
          mma(sa[mq][n], va[mq], kl[2 * q2], kl[2 * q2 + 1]);
        }
      }
    }
  }

  if (!WITH_Y) {
#pragma unroll
    for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        float* s0 = seg_state + (size_t)(col0 + 16 * mq + g) * P + 8 * np + 2 * t;
        *reinterpret_cast<float2*>(s0) = make_float2(sa[mq][np][0], sa[mq][np][1]);
        *reinterpret_cast<float2*>(s0 + 8 * P) = make_float2(sa[mq][np][2], sa[mq][np][3]);
      }
    if (blockIdx.x == 0 && 2 * lane < P)
      *reinterpret_cast<float2*>(decay + ((size_t)bh * nseg + seg) * P + 2 * lane) = ld;
  }
}

// Grid 2: the entering state of every segment, in place of the end states
// grid 1 stored (csrc/scan_pass.cuh); a state element [q][p] decays by its
// key channel p.
__global__ void rwkv6_pass_states(float* __restrict__ state, const float* __restrict__ decay,
                                  int BH, int P, int nseg) {
  scan_pass_states(state, decay, BH, P * P, P, nseg);
}

template <int P, int NCOL>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u,
           void* y, float* state, float* decay, int B, int H, int S, int Q, int seg_chunks,
           const Strides& st, int vec, cudaStream_t stream) {
  using L = Smem<P, NCOL>;
  const auto* rp = static_cast<const __nv_bfloat16*>(r);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const int nchunks = S / Q;
  const int nseg = (nchunks + seg_chunks - 1) / seg_chunks;
  if (nseg > 1) {
    cudaError_t err = cudaFuncSetAttribute(rwkv6_mma_kernel<P, NCOL, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    rwkv6_mma_kernel<P, NCOL, false><<<dim3(P / NCOL, nseg - 1, B * H), 32, L::BYTES, stream>>>(
        rp, kp, vp, logw, u, yp, state, decay, H, S, Q, seg_chunks, nseg, st, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)B * H * P * P;
    rwkv6_pass_states<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(state, decay, B * H, P,
                                                                          nseg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(rwkv6_mma_kernel<P, NCOL, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  rwkv6_mma_kernel<P, NCOL, true><<<dim3(P / NCOL, nseg, B * H), 32, L::BYTES, stream>>>(
      rp, kp, vp, logw, u, yp, state, decay, H, S, Q, seg_chunks, nseg, st, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: r, k, v, logw, y (b, h, s) each, in elements; every last axis is
// dense and u is contiguous. ncol: the value columns a warp takes, which
// the caller's segment plan counts on; the instances built take 32 at P = 32
// and 64, 16 at P = 16 and 48, and any other ncol is refused.
// seg_chunks: chunks of a segment; when the sequence has more than one
// segment, state holds B*H*nseg*P*P floats and decay B*H*nseg*P (nseg =
// ceil((S/Q) / seg_chunks)), else both may be null. vec says that every row
// of r, k, v and logw is 16-byte aligned. Runs one grid, or three when there
// is more than one segment. Returns the first failing launch's
// cudaGetLastError() code (0 on success). Does not synchronise.
extern "C" int rwkv6_scan_mma_launch(const void* r, const void* k, const void* v,
                                     const void* logw, const void* u, void* y, void* state,
                                     void* decay, int B, int H, int S, int P, int Q, int ncol,
                                     int seg_chunks, const long long* strides, int vec,
                                     void* stream) {
  if (B < 1 || H < 1 || S < 1 || P < 16 || P > 64 || P % 16 != 0 || Q < 1 || Q > QT ||
      S % Q != 0 || ncol != (P % 32 == 0 ? 32 : 16) || seg_chunks < 1 || strides[14] % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int nseg = (S / Q + seg_chunks - 1) / seg_chunks;
  if (nseg > 1 && (state == nullptr || decay == nullptr)) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(logw);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  float* df = static_cast<float*>(decay);
  switch (P) {
    case 16: return launch<16, 16>(r, k, v, wf, uf, y, sf, df, B, H, S, Q, seg_chunks, st, vec, cs);
    case 32: return launch<32, 32>(r, k, v, wf, uf, y, sf, df, B, H, S, Q, seg_chunks, st, vec, cs);
    case 48: return launch<48, 16>(r, k, v, wf, uf, y, sf, df, B, H, S, Q, seg_chunks, st, vec, cs);
    default: return launch<64, 32>(r, k, v, wf, uf, y, sf, df, B, H, S, Q, seg_chunks, st, vec, cs);
  }
}
