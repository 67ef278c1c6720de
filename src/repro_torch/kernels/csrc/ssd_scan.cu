// Mamba-2 SSD chunked scan (forward), f32 on the CUDA cores: y only, as the
// TPU kernel returns it.
//
// Replaces, for f32 tensors, the TPU kernel src/repro/kernels/ssd.py
// (_ssd_kernel, launched by ssd_scan_hsd through pl.pallas_call); bf16
// tensors take csrc/ssd_scan_mma.cu, on the tensor cores. That kernel ran a
// (B, H, chunk) grid whose chunk axis is sequential on the TensorCore and
// carried the N x P f32 state in VMEM scratch from one chunk to the next.
//
// Per chunk of q rows, with la = dt * A (<= 0) and cum its inclusive cumsum:
//   G     = C B^T                                          (q x q, over N)
//   y_i   = sum_{j<=i} G_ij exp(cum_i - cum_j) dt_j x_j  +  exp(cum_i) C_i . state
//   state = exp(cum_q) state + sum_j exp(cum_q - cum_j) dt_j B_j x_j^T
// exp(cum_i - cum_j) is computed only where j <= i: above the diagonal it may
// be +inf, and 0 * inf would be NaN (the mask is a select, never a product).
// A chunk of q rows runs in the tile instance of Q >= q rows (16, 32, 64 or
// 128): rows q..Q-1 of every tile stay zero (dt = 0 there, so the decay and
// the state are unchanged) and their y is never stored.
//
// Layout: x (B, H, S, P), y, dt (B, H, S), A (H,), B and C (B, S, N), all
// f32; every operand is read through the strides the launcher is given, with
// only its last axis dense, so the model's (B, S, H, P) tensors are read in
// place. Exact f32: every product is an explicit __fmaf_rn FMA (the
// repository's -fmad=false does not split them), exponentials are expf.
//
// What bounds it on Hopper: at zamba2-7b's shape (S=32768, H=112, P=N=64,
// chunk 64) its 7.7e10 f32 operations on the CUDA cores (1.15 ms at 67
// TFLOP/s; the bytes take 0.56 ms). The first version ran a block
// per (b, h, 32 value columns) that walked every chunk: the chain of chunks,
// each with synchronous loads, a one-warp cumsum and five block barriers,
// with C B^T recomputed by every block (224 times what the bound counts,
// 44% of its FMAs), held it at 8.5x its bound. This design answers that:
//   * C B^T once per (b, chunk): grid 0 writes G (B, S/q, q, round4(q)) to a
//     workspace (8.4 MB at S=32768, inside the 50 MB L2), and the head
//     blocks read it;
//   * a block per (b, h, PB value columns) walks every chunk of the
//     sequence and writes y: at zamba2-7b's 112 heads that is 112 blocks of
//     64 columns, one an SM (a block of the y pass takes 175 KB of shared
//     memory at chunk 64). A sequence split with state passing, as
//     csrc/rwkv6_scan_mma.cu runs it, was built and timed: 2, 4 and 8
//     segments were slower than one at S=4096 and S=32768, since the split's
//     extra grids (end states from zero, then the passing) cost more than
//     the blocks it adds gain on a card the heads already fill;
//   * the next chunk's G, C, B, x and dt load by cp.async into a second
//     stage while the current chunk computes (16 bytes a copy where rows are
//     16-byte aligned, else 4); tiles keep their natural row-major layout
//     with a 4-float row pad, so every shared load is a broadcast or
//     conflict-free;
//   * the products in SGEMM register tiles: y (TQ rows x TC columns a
//     thread) reads C and W rows as float4 broadcasts and the state and x
//     rows as float4s; the state (4 rows x TC columns a thread) stays in
//     registers across chunks, with two shared copies (entering, leaving)
//     for C H; W x stops at the thread's last row (the causal half), and
//     the two warps of a scheduler take a short and a long causal run;
//   * one block barrier a chunk: each warp scans the chunk's decays itself
//     (a shuffle scan into its own copy) and builds in place the rows of W
//     and the columns of B o w that its own threads read, loads before
//     stores.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;      // 16 x 16
constexpr int WARPS = THREADS / 32;
constexpr int NS = 64;            // state rows N, padded with zeros to 64
constexpr int CS = NS + 4;        // f32 row stride of the C and B tiles
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

struct Strides {
  long long x_b, x_h, x_s;
  long long dt_b, dt_h, dt_s;
  long long b_b, b_s;
  long long c_b, c_s;
  long long y_b, y_h, y_s;
};

// Shared memory of the scan kernel, in floats. A stage holds one chunk: G
// (then W, in place), C, B (then B o w, in place), x and dt. Each warp writes
// only the rows of W and the columns of B its own threads read. Two copies of
// the state: the one entering a chunk (read by C H) and the one leaving it.
// Each warp keeps its cumsum and w. Two stages where they fit, else one
// (Q = 128).
template <int Q, int PB>
struct Smem {
  static constexpr int GS = Q + 4;   // row stride of the G / W tile
  static constexpr int XS = PB + 4;  // row stride of the x tile and the state copies
  static constexpr int G_OFF = 0;
  static constexpr int C_OFF = G_OFF + Q * GS;
  static constexpr int B_OFF = C_OFF + Q * CS;
  static constexpr int X_OFF = B_OFF + Q * CS;
  static constexpr int DT_OFF = X_OFF + Q * XS;
  static constexpr int STAGE = DT_OFF + Q;
  static constexpr int HCOPY = NS * XS;
  static constexpr int REST = 2 * HCOPY + WARPS * 2 * Q;
  static constexpr int STAGES = (2 * STAGE + REST) * 4 <= SMEM_MAX ? 2 : 1;
  static constexpr int H_OFF = STAGES * STAGE;
  static constexpr int CUM_OFF = H_OFF + 2 * HCOPY;
  static constexpr int FLOATS = CUM_OFF + WARPS * 2 * Q;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(BYTES <= SMEM_MAX, "shared memory");
  static_assert(STAGE % 4 == 0 && HCOPY % 4 == 0, "16-byte aligned tiles");
};

// K consecutive floats of shared memory, 4K-byte aligned
template <int K>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = p[i];
  }
}

template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&in)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(in[i], in[i + 1], in[i + 2], in[i + 3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = in[i];
  }
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Issue the loads of one chunk (rows c0..c0+q-1) into a stage: 16-byte
// cp.async where every row of x, B and C is 16-byte aligned (vec), else 4
// bytes at a time; G from the wrapper's workspace, q rows of gsw floats; dt 4
// bytes at a time. Rows q..Q-1 and columns N..63 are never written, so they
// stay zero.
template <int Q, int PB>
__device__ __forceinline__ void load_chunk(float* stage, const float* xb, const float* dtb,
                                           const float* Bb, const float* Cb, const float* Gc,
                                           long long c0, int q, int N, int gsw,
                                           const Strides& st, bool vec) {
  using L = Smem<Q, PB>;
  float* gs = stage + L::G_OFF;
  float* cs = stage + L::C_OFF;
  float* bs = stage + L::B_OFF;
  float* xs = stage + L::X_OFF;
  float* dts = stage + L::DT_OFF;
  const int tid = threadIdx.x;
  if (vec) {
    const int gn = N / 4;  // 16-byte granules a row of B or C
    for (int i = tid; i < q * gn; i += THREADS) {
      const int r = i / gn, g = 4 * (i - r * gn);
      cp_async16(cs + r * CS + g, Cb + (c0 + r) * st.c_s + g);
      cp_async16(bs + r * CS + g, Bb + (c0 + r) * st.b_s + g);
    }
    constexpr int GX = PB / 4;
    for (int i = tid; i < q * GX; i += THREADS) {
      const int r = i / GX, g = 4 * (i - r * GX);
      cp_async16(xs + r * L::XS + g, xb + (c0 + r) * st.x_s + g);
    }
  } else {
    for (int i = tid; i < q * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      cp_async4(cs + r * CS + n, Cb + (c0 + r) * st.c_s + n);
      cp_async4(bs + r * CS + n, Bb + (c0 + r) * st.b_s + n);
    }
    for (int i = tid; i < q * PB; i += THREADS) {
      const int r = i / PB, p = i - r * PB;
      cp_async4(xs + r * L::XS + p, xb + (c0 + r) * st.x_s + p);
    }
  }
  const int gg = gsw / 4;
  for (int i = tid; i < q * gg; i += THREADS) {
    const int r = i / gg, g = 4 * (i - r * gg);
    cp_async16(gs + r * L::GS + g, Gc + (long long)r * gsw + g);
  }
  for (int i = tid; i < q; i += THREADS) cp_async4(dts + i, dtb + (c0 + i) * st.dt_s);
  cp_async_commit();
}

// Grid 0: G = C B^T of every (b, chunk), rows i and columns j < q, into
// G[b][c][i][j] (row stride gsw). A block per chunk; a thread's rows are
// ty + 16 r and columns tx + 16 s, so the B rows a quarter-warp reads lie
// in distinct banks.
template <int Q>
__global__ void __launch_bounds__(THREADS)
ssd_gram_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ G, int S, int q, int N, Strides st, int vec) {
  constexpr int TQ = Q / 16;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;
  float* bs = smem + Q * CS;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = blockIdx.x, b = blockIdx.y;
  const int nchunks = S / q, gsw = (q + 3) & ~3, n4 = (N + 3) & ~3;
  const long long c0 = (long long)c * q;
  const float* Bb = Bm + b * st.b_b;
  const float* Cb = Cm + b * st.c_b;
  for (int i = tid; i < 2 * Q * CS / 4; i += THREADS)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (vec) {
    const int gn = N / 4;
    for (int i = tid; i < q * gn; i += THREADS) {
      const int r = i / gn, g = 4 * (i - r * gn);
      cp_async16(cs + r * CS + g, Cb + (c0 + r) * st.c_s + g);
      cp_async16(bs + r * CS + g, Bb + (c0 + r) * st.b_s + g);
    }
  } else {
    for (int i = tid; i < q * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      cp_async4(cs + r * CS + n, Cb + (c0 + r) * st.c_s + n);
      cp_async4(bs + r * CS + n, Bb + (c0 + r) * st.b_s + n);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  float acc[TQ][TQ];
#pragma unroll
  for (int r = 0; r < TQ; ++r)
#pragma unroll
    for (int s = 0; s < TQ; ++s) acc[r][s] = 0.f;
  for (int n = 0; n < n4; n += 4) {
    float4 cv[TQ], bv[TQ];
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
      cv[r] = *reinterpret_cast<const float4*>(cs + (ty + 16 * r) * CS + n);
      bv[r] = *reinterpret_cast<const float4*>(bs + (tx + 16 * r) * CS + n);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < TQ; ++r)
#pragma unroll
        for (int s = 0; s < TQ; ++s)
          acc[r][s] = __fmaf_rn(comp(cv[r], k), comp(bv[s], k), acc[r][s]);
  }
  float* Gc = G + ((size_t)b * nchunks + c) * q * gsw;
#pragma unroll
  for (int r = 0; r < TQ; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int s = 0; s < TQ; ++s) {
      const int j = tx + 16 * s;
      if (i < q && j < q) Gc[(size_t)i * gsw + j] = acc[r][s];
    }
  }
}

// One block: (b, h, PB value columns p0..), every chunk from a zero state;
// writes y.
template <int Q, int PB>
__global__ void __launch_bounds__(THREADS, 1)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ G,
               float* __restrict__ y, int H, int S, int q, int N, Strides st, int vec) {
  static_assert(Q % 16 == 0 && Q <= 128 && PB % 16 == 0 && PB <= 64, "Q, PB");
  using L = Smem<Q, PB>;
  constexpr int TQ = Q / 16;   // rows of y a thread: yt * TQ ..
  constexpr int TC = PB / 16;  // value columns a thread, of y and of the state: tx * TC ..
  constexpr int TN = NS / 16;  // state rows a thread: ty * TN ..
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  // the rows of y are a warp's 2 TQ rows of block rb: warps w and w + 4,
  // which share a scheduler, take blocks w and 7 - w, so that the causal
  // W x gives every scheduler the same number of steps
  const int rb = warp < WARPS / 2 ? warp : 3 * WARPS / 2 - 1 - warp;
  const int yt = 2 * rb + (ty & 1);  // the thread's row group of y
  const int p0 = blockIdx.x * PB, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const float a = A[h];
  const float* xb = x + b * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const float* Bb = Bm + b * st.b_b;
  const float* Cb = Cm + b * st.c_b;
  float* yb = y + b * st.y_b + h * st.y_h + p0;
  const int nchunks = S / q, gsw = (q + 3) & ~3, n4 = (N + 3) & ~3, q4 = (q + 3) & ~3;
  float* cum = smem + L::CUM_OFF + warp * 2 * Q;  // this warp's cumsum of dt A
  float* wj = cum + Q;                            // exp(cum_q - cum_j) dt_j
  const float* Gb = G + (size_t)b * nchunks * q * gsw;

  for (int i = tid; i < L::FLOATS / 4; i += THREADS)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the state, rows ty * TN + r and columns tx * TC + c of the slice, f32
  // across chunks, from zero (the zeroed shared copies hold it too)
  float hs[TN][TC];
#pragma unroll
  for (int r = 0; r < TN; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) hs[r][c] = 0.f;

  if (L::STAGES == 2)
    load_chunk<Q, PB>(smem, xb, dtb, Bb, Cb, Gb, 0, q, N, gsw, st, vec);
  for (int c = 0; c < nchunks; ++c) {
    float* stage = smem + (L::STAGES == 2 ? (c & 1) * L::STAGE : 0);
    if (L::STAGES == 1) {
      __syncthreads();  // every read of the stage is done
      load_chunk<Q, PB>(stage, xb, dtb, Bb, Cb, Gb + (size_t)c * q * gsw, (long long)c * q, q, N,
                        gsw, st, vec);
    }
    cp_async_wait_all();
    // the chunk is in its stage; every read of the other stage, and of the
    // state copy this chunk writes, is done
    __syncthreads();
    if (L::STAGES == 2 && c + 1 < nchunks)
      load_chunk<Q, PB>(smem + ((c + 1) & 1) * L::STAGE, xb, dtb, Bb, Cb,
                        Gb + (size_t)(c + 1) * q * gsw, (long long)(c + 1) * q, q, N, gsw, st,
                        vec);
    float* gw = stage + L::G_OFF;
    const float* cs = stage + L::C_OFF;
    float* bs = stage + L::B_OFF;
    const float* xs = stage + L::X_OFF;
    const float* dts = stage + L::DT_OFF;

    // inclusive cumsum of dt * A, and w, by this warp for itself
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
      if (i < Q) cum[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    const float ctot = carry;
    for (int i = lane; i < Q; i += 32) wj[i] = expf(ctot - cum[i]) * dts[i];
    __syncwarp();

    // This warp's share of W and B o w, in place: the rows of W its threads'
    // y reads (row block rb) and the columns of B their state rows read, so
    // no block barrier stands between them and the products. Every load
    // comes before the stores: the stores may alias them.
    {  // W = mask(G exp(cum_i - cum_j) dt_j), up to the last 4-column group read
      constexpr int WR = 2 * TQ;                 // rows of the warp
      constexpr int JS = Q < 32 ? 1 : Q / 32;    // columns of a lane: lane + 32 js
      const int r0 = rb * WR;
      const int jl = min(Q, (r0 + WR + 3) & ~3);
#pragma unroll
      for (int js = 0; js < JS; ++js) {
        const int j = lane + 32 * js;
        if (j < jl) {
          const float cj = cum[j], dj = dts[j];
          float g[WR], ci[WR];
#pragma unroll
          for (int r = 0; r < WR; ++r) {
            g[r] = gw[(r0 + r) * L::GS + j];
            ci[r] = cum[r0 + r];
          }
#pragma unroll
          for (int r = 0; r < WR; ++r) {
            const int i = r0 + r;
            gw[i * L::GS + j] = (j <= i && i < q) ? g[r] * expf(ci[r] - cj) * dj : 0.f;
          }
        }
      }
    }
    {  // B o w on the warp's 2 TN columns: only its state update reads them
      constexpr int JB = (Q + 15) / 16;  // rows of a lane: lane / 2 + 16 m
      const int c0 = warp * 2 * TN + 4 * (lane & 1);
      if (c0 < n4) {
        float4 bv[JB];
        float wv[JB];
#pragma unroll
        for (int m = 0; m < JB; ++m) {
          const int j = (lane >> 1) + 16 * m;
          if (j < q) {
            bv[m] = *reinterpret_cast<const float4*>(bs + j * CS + c0);
            wv[m] = wj[j];
          }
        }
#pragma unroll
        for (int m = 0; m < JB; ++m) {
          const int j = (lane >> 1) + 16 * m;
          if (j < q)
            *reinterpret_cast<float4*>(bs + j * CS + c0) =
                make_float4(bv[m].x * wv[m], bv[m].y * wv[m], bv[m].z * wv[m], bv[m].w * wv[m]);
        }
      }
    }
    __syncwarp();

    {
      // y on rows yt * TQ + r, columns tx * TC + cc:
      //   exp(cum_i) (C H) over the state rows, then W x up to the last row
      const float* hc = smem + L::H_OFF + (c & 1) * L::HCOPY;
      float acc[TQ][TC];
#pragma unroll
      for (int r = 0; r < TQ; ++r)
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) acc[r][cc] = 0.f;
#pragma unroll 2
      for (int n = 0; n < n4; n += 4) {
        float4 cv[TQ];
#pragma unroll
        for (int r = 0; r < TQ; ++r)
          cv[r] = *reinterpret_cast<const float4*>(cs + (yt * TQ + r) * CS + n);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float hv[TC];
          load_vec<TC>(hc + (n + kk) * L::XS + tx * TC, hv);
#pragma unroll
          for (int r = 0; r < TQ; ++r)
#pragma unroll
            for (int cc = 0; cc < TC; ++cc)
              acc[r][cc] = __fmaf_rn(comp(cv[r], kk), hv[cc], acc[r][cc]);
        }
      }
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
        const float e = expf(cum[yt * TQ + r]);
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) acc[r][cc] *= e;
      }
      const int jend = min(Q, ((yt + 1) * TQ + 3) & ~3);
#pragma unroll 2
      for (int j = 0; j < jend; j += 4) {
        float4 wv[TQ];
#pragma unroll
        for (int r = 0; r < TQ; ++r)
          wv[r] = *reinterpret_cast<const float4*>(gw + (yt * TQ + r) * L::GS + j);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float xv[TC];
          load_vec<TC>(xs + (j + kk) * L::XS + tx * TC, xv);
#pragma unroll
          for (int r = 0; r < TQ; ++r)
#pragma unroll
            for (int cc = 0; cc < TC; ++cc)
              acc[r][cc] = __fmaf_rn(comp(wv[r], kk), xv[cc], acc[r][cc]);
        }
      }
#pragma unroll
      for (int r = 0; r < TQ; ++r) {  // the chunk's rows only, never the padding
        const int row = yt * TQ + r;
        if (row < q) store_vec<TC>(yb + ((long long)c * q + row) * st.y_s + tx * TC, acc[r]);
      }
    }

    {  // state = exp(cum_q) state + (B o w)^T x, rows ty * TN .., columns tx * TC ..
      const float gl = expf(ctot);
      float acc[TN][TC];
#pragma unroll
      for (int r = 0; r < TN; ++r)
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) acc[r][cc] = 0.f;
#pragma unroll 4
      for (int j = 0; j < q4; ++j) {  // rows q..q4-1 are zero
        const float4 bv = *reinterpret_cast<const float4*>(bs + j * CS + ty * TN);
        float xv[TC];
        load_vec<TC>(xs + j * L::XS + tx * TC, xv);
#pragma unroll
        for (int r = 0; r < TN; ++r)
#pragma unroll
          for (int cc = 0; cc < TC; ++cc)
            acc[r][cc] = __fmaf_rn(comp(bv, r), xv[cc], acc[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < TN; ++r) {
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) hs[r][cc] = hs[r][cc] * gl + acc[r][cc];
        // the copy the next chunk's C H reads
        store_vec<TC>(smem + L::H_OFF + ((c + 1) & 1) * L::HCOPY + (ty * TN + r) * L::XS +
                          tx * TC,
                      hs[r]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int Q, int PB>
int launch(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           float* y, float* G, int B, int H, int S, int P, int N, int q, const Strides& st,
           int vec, cudaStream_t stream) {
  const int nchunks = S / q;
  const int gram_smem = 2 * Q * CS * 4;
  cudaError_t err = set_smem(ssd_gram_kernel<Q>, gram_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_gram_kernel<Q><<<dim3(nchunks, B), THREADS, gram_smem, stream>>>(Bm, Cm, G, S, q, N, st,
                                                                       vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  using L = Smem<Q, PB>;
  err = set_smem(ssd_f32_kernel<Q, PB>, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  ssd_f32_kernel<Q, PB><<<dim3(P / PB, B * H), THREADS, L::BYTES, stream>>>(
      x, dt, A, Bm, Cm, G, y, H, S, q, N, st, vec);
  return (int)cudaGetLastError();
}

template <int Q>
int dispatch_pb(int pb, const float* x, const float* dt, const float* A, const float* Bm,
                const float* Cm, float* y, float* G, int B, int H, int S, int P, int N, int q,
                const Strides& st, int vec, cudaStream_t s) {
  if (pb == 64) return launch<Q, 64>(x, dt, A, Bm, Cm, y, G, B, H, S, P, N, q, st, vec, s);
  return launch<Q, 16>(x, dt, A, Bm, Cm, y, G, B, H, S, P, N, q, st, vec, s);
}

}  // namespace

// strides: x (b, h, s), dt (b, h, s), B (b, s), C (b, s), y (b, h, s), in
// elements; every last axis is dense; every operand is f32. Q: the chunk,
// any length dividing S; tile: the instance it runs in (16, 32, 64 or 128,
// at least Q; the caller picks the smallest). pb: the value columns a block
// takes: 64 where they divide P, else 16; any other is refused. G: B * (S/Q)
// * Q * round4(Q) floats, 16-byte aligned. vec says that every row of x, B
// and C is 16-byte aligned and N a multiple of 4. y must be 16-byte aligned
// with strides of multiples of 4 floats. Runs two grids (G, y). Returns the
// first failing launch's cudaGetLastError() code (0 on success). Does not
// synchronise.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* G, int B, int H, int S, int P,
                               int N, int Q, int tile, int pb, const long long* strides, int vec,
                               void* stream) {
  if (B < 1 || H < 1 || H > 65535 / B || S < 1 || N < 1 || N > NS || P < 16 || P % 16 != 0 ||
      Q < 1 || Q > tile || S % Q != 0 || pb != (P % 64 == 0 ? 64 : 16) || G == nullptr ||
      reinterpret_cast<uintptr_t>(G) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      strides[10] % 4 != 0 || strides[11] % 4 != 0 || strides[12] % 4 != 0 ||
      (vec && N % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8], strides[9],
                   strides[10], strides[11], strides[12]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* gf = static_cast<float*>(G);
  switch (tile) {
    case 16: return dispatch_pb<16>(pb, xf, dtf, Af, bf, cf, yf, gf, B, H, S, P, N, Q, st, vec, s);
    case 32: return dispatch_pb<32>(pb, xf, dtf, Af, bf, cf, yf, gf, B, H, S, P, N, Q, st, vec, s);
    case 64: return dispatch_pb<64>(pb, xf, dtf, Af, bf, cf, yf, gf, B, H, S, P, N, Q, st, vec, s);
    case 128:
      return dispatch_pb<128>(pb, xf, dtf, Af, bf, cf, yf, gf, B, H, S, P, N, Q, st, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
