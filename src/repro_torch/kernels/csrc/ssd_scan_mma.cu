// Mamba-2 SSD chunked scan (forward), bf16 on the tensor cores: y only, as
// the TPU kernel returns it.
//
// Replaces, for bf16 tensors, the TPU kernel src/repro/kernels/ssd.py
// (_ssd_kernel, launched by ssd_scan_hsd through pl.pallas_call). That
// kernel ran a (B, H, chunk) grid whose chunk axis is sequential on the
// TensorCore, carried the N x P f32 state in VMEM scratch from one chunk to
// the next, and computed a chunk's four products as dot_generals on the MXU.
// f32 tensors take csrc/ssd_scan.cu (exact f32 on the CUDA cores).
//
// Per chunk of Q rows, with la = dt * A (<= 0) and cum its inclusive cumsum:
//   G     = C B^T                                    (Q x Q, over N)
//   W_ij  = G_ij exp(cum_i - cum_j) dt_j  for j <= i, else 0
//   y     = W x  +  diag(exp(cum)) C H               (Q x P)
//   H     = exp(cum_Q) H + (B o w)^T x,  w_j = exp(cum_Q - cum_j) dt_j
// exp(cum_i - cum_j) is taken only where j <= i: above the diagonal it may be
// +inf, and 0 * inf would be NaN (the mask is a select, never a product).
// A chunk of q rows runs in the tile instance of Q >= q rows (16, 32, 64 or
// 128; the wrapper picks the smallest): rows q..Q-1 of every tile stay zero
// (x = B = C = 0 and dt = 0), so their log-decay is 0, cum past row q-1 and
// the state's decay exp(cum at row q-1) are unchanged, they add nothing to
// the state, and their y is never stored. Chunk boundaries stay at multiples
// of q, where the reference puts them.
//
// Layout: x (B, H, S, P), B and C (B, S, N) and y in bf16, dt (B, H, S) and
// A (H,) in f32; every operand is read through the strides the launcher is
// given, with only its last axis dense, so the model's (B, S, H, P) tensors
// are read in place.
//
// What bounds it on Hopper: at zamba2-7b's shape (S=32768, H=112, P=N=64,
// chunk 64) the bytes of x and y (2 x 470 MB, 0.29 ms at 3.35 TB/s) against
// 7.7e10 operations (0.08 ms on the tensor cores). The first version ran
// the four products as f32 FMAs on the CUDA cores, with each chunk's loads
// before its compute and five block barriers a chunk: 35x its bound. This
// one answers that:
//   * the four products run on the tensor cores as mma.sync m16n8k16 (bf16
//     operands from shared memory by ldmatrix, f32 accumulators). mma.sync
//     and not wgmma: the products are 16 to 128 wide, and Q = 16 must work;
//   * the operands built in f32, W, B o w and H, enter their products as
//     bf16 hi + lo pairs (two products each; x, B and C are bf16 already):
//     rounded to bf16 alone, the state took the kernel 5x past the
//     agreement limit at S=1024 (a CPU emulation of the rounding points). H
//     stays f32 in its accumulator fragments from chunk to chunk (each warp
//     owns 16 state rows); only its hi and lo copies in shared memory,
//     double buffered, feed C H. W never leaves registers: G's accumulator
//     fragments are W's A fragments once scaled, masked and split;
//   * the next chunk's x, B, C and dt load by cp.async into a second stage
//     while the current chunk computes, so the loads leave the serial chain;
//   * one block barrier a chunk: each warp scans the chunk's decays itself
//     (Q values, a warp scan), and the double buffers cover the rest;
//   * one block of four warps per (b, h, slice of PB value columns): value
//     columns are independent, so a head splits over P/PB blocks; warps
//     split a chunk's rows (and its columns when Q < 64).
// Exponentials are ex2.approx on base-2 cumsums (relative error near 2^-22,
// below the hi + lo pairs' 2^-17).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int NS = 64;        // state rows N, padded with zeros to 64
constexpr int NSTR = NS + 8;  // bf16 row stride of the C and B tiles: 144 B, no ldmatrix conflicts
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long x_b, x_h, x_s;
  long long dt_b, dt_h, dt_s;
  long long b_b, b_s;
  long long c_b, c_s;
  long long y_b, y_h, y_s;
};

// Shared memory of one block, in bytes: two stages of a chunk (C, B, x in
// bf16, dt in f32), two copies of the state as bf16 hi and lo parts, and
// each warp's base-2 cumsum and state weights w.
template <int Q, int PB>
struct Smem {
  static constexpr int XSTR = PB + 8;  // bf16 row stride of the x and state tiles
  static constexpr int C_OFF = 0;
  static constexpr int B_OFF = C_OFF + Q * NSTR * 2;
  static constexpr int X_OFF = B_OFF + Q * NSTR * 2;
  static constexpr int DT_OFF = X_OFF + Q * XSTR * 2;
  static constexpr int STAGE = DT_OFF + Q * 4;
  static constexpr int H_OFF = 2 * STAGE;  // [copy][hi, lo][NS][XSTR]
  static constexpr int HB = NS * XSTR * 2;
  static constexpr int W_OFF = H_OFF + 4 * HB;
  static constexpr int BYTES = W_OFF + WARPS * 2 * Q * 4;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
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

// Issue the loads of one chunk (rows c0..c0+q-1) into a stage: 16-byte
// cp.async where every row is 16-byte aligned (vec), else plain loads and
// stores; dt 4 bytes at a time. Columns N..63 of C and B and rows q..Q-1 of
// every tile are never written, so they stay zero.
template <int Q, int PB>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const __nv_bfloat16* Cb,
                                           const __nv_bfloat16* Bb, const __nv_bfloat16* xb,
                                           const float* dtb, long long c0, int q, int N,
                                           const Strides& st, bool vec) {
  using L = Smem<Q, PB>;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(stage + L::C_OFF);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(stage + L::B_OFF);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + L::X_OFF);
  float* dts = reinterpret_cast<float*>(stage + L::DT_OFF);
  const int tid = threadIdx.x;
  if (vec) {
    const int gpr = N / 8;  // 16-byte granules a row of C or B
    for (int i = tid; i < q * gpr; i += THREADS) {
      const int r = i / gpr, g = 8 * (i - r * gpr);
      cp_async16(cs + r * NSTR + g, Cb + (c0 + r) * st.c_s + g);
      cp_async16(bs + r * NSTR + g, Bb + (c0 + r) * st.b_s + g);
    }
    constexpr int XG = PB / 8;
    for (int i = tid; i < q * XG; i += THREADS) {
      const int r = i / XG, g = 8 * (i - r * XG);
      cp_async16(xs + r * L::XSTR + g, xb + (c0 + r) * st.x_s + g);
    }
  } else {
    for (int i = tid; i < q * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      cs[r * NSTR + n] = Cb[(c0 + r) * st.c_s + n];
      bs[r * NSTR + n] = Bb[(c0 + r) * st.b_s + n];
    }
    for (int i = tid; i < q * PB; i += THREADS) {
      const int r = i / PB, p = i - r * PB;
      xs[r * L::XSTR + p] = xb[(c0 + r) * st.x_s + p];
    }
  }
  for (int i = tid; i < q; i += THREADS) cp_async4(dts + i, dtb + (c0 + i) * st.dt_s);
  cp_async_commit();
}

template <int Q, int PB>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y, int S,
                    int q, int N, Strides st, int vec) {
  static_assert(Q % 16 == 0 && PB % 16 == 0 && PB <= 64, "Q, PB multiples of 16; PB <= 64");
  using L = Smem<Q, PB>;
  constexpr int RT = Q / 16;                  // row tiles of a chunk
  constexpr int WR = RT < WARPS ? RT : WARPS; // warps along the rows
  constexpr int WC = WARPS / WR;              // warps along the value columns
  constexpr int RTW = RT / WR;                // row tiles a warp
  constexpr int NT = PB / 8;                  // n-tiles of 8 value columns
  constexpr int NTW = NT / WC > 0 ? NT / WC : 1;  // n-tiles of y a warp
  constexpr int KQ = Q / 16;                  // k-steps over a chunk's rows
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row group, thread in group
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row within a matrix, matrix
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h];
  const __nv_bfloat16* xb = x + b * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const __nv_bfloat16* Bb = Bm + b * st.b_b;
  const __nv_bfloat16* Cb = Cm + b * st.c_b;
  __nv_bfloat16* yb = y + b * st.y_b + h * st.y_h + p0;
  const int nk = (N + 15) / 16;  // k-steps over the state rows
  float* cum = reinterpret_cast<float*>(smem + L::W_OFF) + warp * 2 * Q;  // base-2 cumsum
  float* wj = cum + Q;  // exp(cum_Q - cum_j) dt_j

  // zeros everywhere: the padding columns of C and B, and the first state
  for (int i = tid; i < L::BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int nchunks = S / q;
  load_chunk<Q, PB>(smem, Cb, Bb, xb, dtb, 0, q, N, st, vec);

  // this warp's state rows 16*warp.. (all PB columns), f32, across chunks
  const bool owns_state = 16 * warp < N;
  float hacc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[nt][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    unsigned char* stage = smem + (c & 1) * L::STAGE;
    const __nv_bfloat16* cs = reinterpret_cast<const __nv_bfloat16*>(stage + L::C_OFF);
    const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(stage + L::B_OFF);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage + L::X_OFF);
    const float* dts = reinterpret_cast<const float*>(stage + L::DT_OFF);
    // the state entering this chunk (hi, then lo) and the one leaving it
    const __nv_bfloat16* hcur =
        reinterpret_cast<const __nv_bfloat16*>(smem + L::H_OFF + (c & 1) * 2 * L::HB);
    __nv_bfloat16* hnext =
        reinterpret_cast<__nv_bfloat16*>(smem + L::H_OFF + ((c + 1) & 1) * 2 * L::HB);
    cp_async_wait_all();
    // the chunk's stage and the state's bf16 copy are complete; every read
    // of the other stage and the other copy is done
    __syncthreads();
    if (c + 1 < nchunks)
      load_chunk<Q, PB>(smem + ((c + 1) & 1) * L::STAGE, Cb, Bb, xb, dtb, (long long)(c + 1) * q,
                        q, N, st, vec);

    // base-2 inclusive cumsum of dt * A, and w, by this warp for itself
    float carry = 0.f;
#pragma unroll
    for (int base = 0; base < Q; base += 32) {
      const int i = base + lane;
      float v = i < Q ? dts[i] * a : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (i < Q) cum[i] = v * LOG2E;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    const float cum_q = carry * LOG2E;
    for (int i = lane; i < Q; i += 32) wj[i] = ex2(cum_q - cum[i]) * dts[i];
    __syncwarp();

    // y on this warp's row tiles and value columns:
    //   y = exp(cum) o (C H) + W x, each of H and W fed as hi + lo
#pragma unroll
    for (int ri = 0; ri < RTW; ++ri) {
      const int rt = (warp % WR) + ri * WR;
      const int cg = warp / WR;
      const bool cols = cg * NTW < NT;  // this warp has value columns of y
      const int pc = cg * NTW * 8;      // its first value column
      const int i0 = 16 * rt + gq;
      const float ci0 = cum[i0], ci1 = cum[i0 + 8];
      // C's A fragments for the row tile, one per k-step over N
      uint32_t cf[NS / 16][4];
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk)
        if (kk < nk)
          ldsm_x4(cf[kk], cs + (16 * rt + (lm & 1) * 8 + lr) * NSTR + 16 * kk + (lm >> 1) * 8);
      float acc[NTW][4];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      if (cols) {
        // C H over the state rows, then the rows' decay exp(cum_i)
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const __nv_bfloat16* hp = hcur + part * NS * L::XSTR;
#pragma unroll
          for (int np = 0; np < NTW; np += 2) {
            const int pcol = pc + 8 * np + (lm >> 1) * 8;
#pragma unroll
            for (int kk = 0; kk < NS / 16; ++kk) {
              if (kk < nk) {
                uint32_t hf[4];
                ldsm_x4_t(hf, hp + (16 * kk + (lm & 1) * 8 + lr) * L::XSTR + pcol);
                mma(acc[np], cf[kk], hf[0], hf[1]);
                if (np + 1 < NTW) mma(acc[np + 1], cf[kk], hf[2], hf[3]);
              }
            }
          }
        }
        const float e0 = ex2(ci0), e1 = ex2(ci1);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          acc[nt][0] *= e0;
          acc[nt][1] *= e0;
          acc[nt][2] *= e1;
          acc[nt][3] *= e1;
        }
      }
      // G = C B^T on the causal column tiles j < 16 (rt + 1)
      float g[Q / 8][4];
#pragma unroll
      for (int jt = 0; jt < Q / 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[jt][e] = 0.f;
#pragma unroll
      for (int jp = 0; jp < Q / 16; ++jp) {
        if (jp > rt) break;
#pragma unroll
        for (int kk = 0; kk < NS / 16; ++kk) {
          if (kk < nk) {
            uint32_t bf[4];
            ldsm_x4(bf, bs + (16 * jp + (lm >> 1) * 8 + lr) * NSTR + 16 * kk + (lm & 1) * 8);
            mma(g[2 * jp], cf[kk], bf[0], bf[1]);
            mma(g[2 * jp + 1], cf[kk], bf[2], bf[3]);
          }
        }
      }
      // W = mask(G exp(cum_i - cum_j) dt_j), as hi and lo A fragments over j
      uint32_t wh[KQ][4], wl[KQ][4];
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        float wv[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jt = 2 * kk + half;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 8 * (e >> 1), j = 8 * jt + 2 * tq + (e & 1);
            const float ci = e >> 1 ? ci1 : ci0;
            wv[half][e] = (kk <= rt && j <= i) ? g[jt][e] * ex2(ci - cum[j]) * dts[j] : 0.f;
          }
        }
        split(wv[0][0], wv[0][1], wh[kk][0], wl[kk][0]);
        split(wv[0][2], wv[0][3], wh[kk][1], wl[kk][1]);
        split(wv[1][0], wv[1][1], wh[kk][2], wl[kk][2]);
        split(wv[1][2], wv[1][3], wh[kk][3], wl[kk][3]);
      }
      if (cols) {
        // W x over the causal k-steps
#pragma unroll
        for (int np = 0; np < NTW; np += 2) {
          const int pcol = pc + 8 * np + (lm >> 1) * 8;
#pragma unroll
          for (int kk = 0; kk < KQ; ++kk) {
            if (kk > rt) break;
            uint32_t xf[4];
            ldsm_x4_t(xf, xs + (16 * kk + (lm & 1) * 8 + lr) * L::XSTR + pcol);
            mma(acc[np], wh[kk], xf[0], xf[1]);
            mma(acc[np], wl[kk], xf[0], xf[1]);
            if (np + 1 < NTW) {
              mma(acc[np + 1], wh[kk], xf[2], xf[3]);
              mma(acc[np + 1], wl[kk], xf[2], xf[3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {  // the chunk's rows only, never the padding
          const int p = pc + 8 * nt + 2 * tq;
          __nv_bfloat16* out = yb + ((long long)c * q + i0) * st.y_s + p;
          if (i0 < q) *reinterpret_cast<uint32_t*>(out) = pack(acc[nt][0], acc[nt][1]);
          if (i0 + 8 < q)
            *reinterpret_cast<uint32_t*>(out + 8 * st.y_s) = pack(acc[nt][2], acc[nt][3]);
        }
      }
    }

    // H = exp(cum_Q) H + (B o w)^T x on this warp's 16 state rows, B o w
    // fed as hi + lo
    if (owns_state) {
      const float gl = ex2(cum_q);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[nt][e] *= gl;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t af[4], ah[4], al[4];
        ldsm_x4_t(af, bs + (16 * kk + (lm >> 1) * 8 + lr) * NSTR + 16 * warp + (lm & 1) * 8);
        const int j0 = 16 * kk + 2 * tq;
        const float w0 = wj[j0], w1 = wj[j0 + 1], w8 = wj[j0 + 8], w9 = wj[j0 + 9];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack(af[r]);
          if (r < 2) split(v.x * w0, v.y * w1, ah[r], al[r]);
          else split(v.x * w8, v.y * w9, ah[r], al[r]);
        }
#pragma unroll
        for (int np = 0; np < NT; np += 2) {
          uint32_t xf[4];
          ldsm_x4_t(xf, xs + (16 * kk + (lm & 1) * 8 + lr) * L::XSTR + 8 * np + (lm >> 1) * 8);
          mma(hacc[np], ah, xf[0], xf[1]);
          mma(hacc[np], al, xf[0], xf[1]);
          if (np + 1 < NT) {
            mma(hacc[np + 1], ah, xf[2], xf[3]);
            mma(hacc[np + 1], al, xf[2], xf[3]);
          }
        }
      }
      // hi and lo parts for the next chunk's C H
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        __nv_bfloat16* hp = hnext + (16 * warp + gq) * L::XSTR + 8 * nt + 2 * tq;
        uint32_t hi, lo;
        split(hacc[nt][0], hacc[nt][1], hi, lo);
        *reinterpret_cast<uint32_t*>(hp) = hi;
        *reinterpret_cast<uint32_t*>(hp + NS * L::XSTR) = lo;
        split(hacc[nt][2], hacc[nt][3], hi, lo);
        *reinterpret_cast<uint32_t*>(hp + 8 * L::XSTR) = hi;
        *reinterpret_cast<uint32_t*>(hp + (NS + 8) * L::XSTR) = lo;
      }
    }
  }
}

template <int Q, int PB>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           void* y, int B, int H, int S, int P, int N, int q, const Strides& st, int vec,
           cudaStream_t stream) {
  using L = Smem<Q, PB>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel<Q, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P / PB, H, B);
  ssd_scan_mma_kernel<Q, PB><<<grid, THREADS, L::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y), S, q, N, st, vec);
  return (int)cudaGetLastError();
}

template <int PB>
int dispatch_q(int tile, const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, int B, int H, int S, int P, int N, int q,
               const Strides& st, int vec, cudaStream_t s) {
  switch (tile) {
    case 16: return launch<16, PB>(x, dt, A, Bm, Cm, y, B, H, S, P, N, q, st, vec, s);
    case 32: return launch<32, PB>(x, dt, A, Bm, Cm, y, B, H, S, P, N, q, st, vec, s);
    case 64: return launch<64, PB>(x, dt, A, Bm, Cm, y, B, H, S, P, N, q, st, vec, s);
    case 128: return launch<128, PB>(x, dt, A, Bm, Cm, y, B, H, S, P, N, q, st, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The value columns a block takes: 32 where they divide P, else 16. At
// zamba2-7b's heads (P=64) 32 columns a block (224 blocks) ran faster than 64
// (112 blocks, under one an SM) and 16.

// strides: x (b, h, s), dt (b, h, s), B (b, s), C (b, s), y (b, h, s), in
// elements; every last axis is dense. Q: the chunk, any length dividing S;
// tile: the instance it runs in (16, 32, 64 or 128, at least Q; the caller
// picks the smallest). vec says that x, B and C rows are 16-byte aligned
// (cp.async by 16 bytes) and N a multiple of 8. Returns the launch's
// cudaGetLastError() code (0 on success). Does not synchronise.
extern "C" int ssd_scan_mma_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, void* y, int B, int H, int S, int P, int N,
                                   int Q, int tile, const long long* strides, int vec,
                                   void* stream) {
  if (B < 1 || H < 1 || S < 1 || N < 1 || N > NS || P < 16 || P % 16 != 0 || Q < 1 ||
      Q > tile || S % Q != 0 || (vec && N % 8 != 0) || strides[12] % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8], strides[9],
                   strides[10], strides[11], strides[12]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  if (P % 32 == 0)
    return dispatch_q<32>(tile, x, dtf, Af, Bm, Cm, y, B, H, S, P, N, Q, st, vec, s);
  return dispatch_q<16>(tile, x, dtf, Af, Bm, Cm, y, B, H, S, P, N, Q, st, vec, s);
}
