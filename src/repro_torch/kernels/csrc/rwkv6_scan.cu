// RWKV-6 (Finch) wkv scan (forward), f32 on the CUDA cores: y only, as the
// TPU kernel returns it.
//
// Replaces, for f32 tensors, the TPU kernel src/repro/kernels/rwkv6.py
// (_rwkv6_kernel, launched by rwkv6_scan_hsd through pl.pallas_call); bf16
// tensors take csrc/rwkv6_scan_mma.cu, on the tensor cores. That kernel ran
// a (B, H, chunk) grid whose chunk axis is sequential on the TensorCore and
// carried the P x P f32 state S[p_key][p_val] in VMEM scratch.
//
// Per chunk of Q <= 16 rows, with cw the inclusive cumsum of logw (<= 0) and
// cw_prev = cw - logw:
//   qn = r exp(cw_prev) (<= |r|),  kn = k exp(-cw) (<= e^(Q |logw|_max) |k|)
//   A[i][j] = qn_i . kn_j for j < i,  r_i . (u * k_i) for j == i,  0 above
//   y_i     = sum_j A[i][j] v_j + qn_i . S
//   S       = diag(exp(cw_Q)) S + sum_j (k_j exp(cw_Q - cw_j)) v_j^T
// The factorization against the chunk start is exact while kn stays finite:
// under the model's clamp |logw| <= e that is e^43.5 at Q = 16 and would be
// e^174 at Q = 64, so the launcher refuses Q > 16. The causal mask is a
// select, never a product: above the diagonal qn . kn may be huge. A chunk
// shorter than 16 rows is padded with zero rows (r = k = v = logw = 0), which
// change nothing.
//
// Layout: r, k, v, y and logw (B, H, S, P) f32, u (H, P) f32; every tensor
// is read through the strides the launcher is given, with only its last axis
// dense, so the model's (B, S, H, P) tensors are read in place. Exact f32:
// every product is an explicit __fmaf_rn FMA (the repository's -fmad=false
// does not split them), exponentials are expf.
//
// What bounds it on Hopper: at rwkv6-3b's shape (S=32768, H=40, P=64) the
// bytes (r, k, v, logw and y, 1.7 GB, 0.50 ms at 3.35 TB/s) against 3.7e10
// f32 operations (0.55 ms at 67 TFLOP/s, the sequence split's second pass
// included). The first version ran a block of 256 threads per (b, h,
// 16 value columns) that walked all 2048 chunks with five block barriers
// each: 160 blocks for 132 SMs, bound by that chain's latency at 32x its
// bound. This one takes the decomposition of the bf16 kernel
// (csrc/rwkv6_scan_mma.cu) with f32 FMAs in place of mma.sync:
//   * a block per (b, h, a segment of the sequence), a warp per NCOL value
//     columns of the head (two at rwkv6-3b's P = 64): the warps share the
//     chunk's stages, loaded by cp.async one chunk ahead, and its decays, so
//     a head's exponentials are taken once, a thread per key channel, and a
//     block's shared memory (38 KB) lets an SM hold six blocks, twelve
//     warps; two block barriers a chunk, and __syncwarp within a warp;
//   * parallelism beyond the 40 (b, h) pairs: the sequence is cut into
//     segments (rwkv6.segment_chunks, the same plan as the bf16 kernel's,
//     for the same warps); grid 1 runs every segment but the last from a zero
//     state to its end state and summed log decay, grid 2
//     (csrc/scan_pass.cuh) passes the states along, grid 3 runs every segment
//     from its entering state and writes y. One segment runs grid 3 alone;
//   * the state stays f32 in registers: lane (c, half) of a warp holds value
//     columns col0 + c + 16 m by the half's P/2 key channels (64 registers
//     at P = 64 and 32 columns). Every product reads its other operand from
//     shared memory as float4 broadcasts across a half-warp, and the halves'
//     partial sums over the key channels meet by one shuffle; each warp
//     builds the 16 x 16 A it reads itself;
//   * the decay pass writes qn, kn and kdec in place of r, logw and k; the u
//     bonus meets by a reduce-scatter of a warp's 16 partial sums (16
//     shuffles) and the warps' shares in shared memory.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "scan_pass.cuh"

namespace {

constexpr int QT = 16;  // rows of a chunk tile (chunks shorter than 16 are zero-padded)
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long r_b, r_h, r_s;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long w_b, w_h, w_s;
  long long y_b, y_h, y_s;
};

// Shared memory of one block, in floats: two stages of a chunk (r, k and
// logw 16 rows of P, then qn, kdec and kn in place; v 16 rows of P), each
// warp's A, exp(cw_Q) of each key channel, and each warp's share of the u
// bonus of each row. Rows are padded by 4 floats, so the float4 reads of 8
// distinct rows in a quarter-warp fall in distinct banks.
template <int P, int NCOL>
struct Smem {
  static constexpr int NW = P / NCOL;  // warps of a block
  static constexpr int RS = P + 4;
  static constexpr int AS = QT + 4;
  static constexpr int R_OFF = 0;
  static constexpr int K_OFF = R_OFF + QT * RS;
  static constexpr int W_OFF = K_OFF + QT * RS;
  static constexpr int V_OFF = W_OFF + QT * RS;
  static constexpr int STAGE = V_OFF + QT * RS;
  static constexpr int A_OFF = 2 * STAGE;          // [NW][QT][AS]
  static constexpr int D_OFF = A_OFF + NW * QT * AS;
  static constexpr int BON_OFF = D_OFF + P;        // [NW][QT]
  static constexpr int FLOATS = BON_OFF + NW * QT;
  static constexpr int BYTES = FLOATS * 4;
};

// Issue the loads of one chunk (rows c0..c0+Q-1) into a stage, by all the
// block's threads: 16-byte cp.async where every row is 16-byte aligned
// (vec), else 4 bytes at a time. Rows Q..15 are never loaded: they stay
// zero. Without r (the state pass) only k, v and logw.
template <int P, int NCOL, bool WITH_R>
__device__ __forceinline__ void load_chunk(float* stage, const float* rb, const float* kb,
                                           const float* vb, const float* wb, long long c0, int Q,
                                           const Strides& st, bool vec) {
  using L = Smem<P, NCOL>;
  constexpr int THREADS = 32 * L::NW;
  float* rs = stage + L::R_OFF;
  float* ks = stage + L::K_OFF;
  float* ws = stage + L::W_OFF;
  float* vs = stage + L::V_OFF;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int GP = P / 4;  // 16-byte granules a row
    for (int i = tid; i < Q * GP; i += THREADS) {
      const int r = i / GP, g = 4 * (i - r * GP);
      const long long row = c0 + r;
      if (WITH_R) cp_async16(rs + r * L::RS + g, rb + row * st.r_s + g);
      cp_async16(ks + r * L::RS + g, kb + row * st.k_s + g);
      cp_async16(ws + r * L::RS + g, wb + row * st.w_s + g);
      cp_async16(vs + r * L::RS + g, vb + row * st.v_s + g);
    }
  } else {
    for (int i = tid; i < Q * P; i += THREADS) {
      const int r = i / P, p = i - r * P;
      const long long row = c0 + r;
      if (WITH_R) cp_async4(rs + r * L::RS + p, rb + row * st.r_s + p);
      cp_async4(ks + r * L::RS + p, kb + row * st.k_s + p);
      cp_async4(ws + r * L::RS + p, wb + row * st.w_s + p);
      cp_async4(vs + r * L::RS + p, vb + row * st.v_s + p);
    }
  }
  cp_async_commit();
}

// Each lane holds one partial sum for each of 16 rows; returns the warp's
// total of row (lane >> 1) & 15, held by lanes 2i and 2i + 1. Each step keeps
// half of the rows and trades the other half with the partner lane.
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool up = lane & 16;
    const float keep = up ? v[j + 8] : v[j], send = up ? v[j] : v[j + 8];
    v[j] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool up = lane & 8;
    const float keep = up ? v[j + 4] : v[j], send = up ? v[j] : v[j + 4];
    v[j] = keep + __shfl_xor_sync(FULL, send, 8);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool up = lane & 4;
    const float keep = up ? v[j + 2] : v[j], send = up ? v[j] : v[j + 2];
    v[j] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  {
    const bool up = lane & 2;
    const float keep = up ? v[1] : v[0], send = up ? v[0] : v[1];
    v[0] = keep + __shfl_xor_sync(FULL, send, 2);
  }
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// One block: (b, h, segment), a warp per NCOL value columns. WITH_Y: run
// the segment from its entering state (zero, or ``state`` when it holds one)
// and write y; else run it from zero and store its end state in ``state``
// and its summed log decay in ``decay``.
// Registers: a block of two warps (P = 64) is left to ptxas, which keeps it
// within the 168 that let an SM run the six blocks its shared memory holds
// (asking for a minimum of blocks an SM made it spill there); the other
// widths ask for one block an SM, so ptxas gives them the registers they
// need instead of spilling.
template <int P, int NCOL, bool WITH_Y>
__global__ void __launch_bounds__(32 * (P / NCOL), P / NCOL == 2 ? 0 : 1)
rwkv6_f32_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, float* __restrict__ y, float* __restrict__ state,
                 float* __restrict__ decay, int H, int S, int Q, int seg_chunks, int nseg,
                 Strides st, int vec) {
  static_assert(P % 16 == 0 && P <= 64 && NCOL % 16 == 0 && P % NCOL == 0, "P, NCOL");
  using L = Smem<P, NCOL>;
  constexpr int THREADS = 32 * L::NW;
  constexpr int HP = P / 2;      // key channels of a half-warp in the products
  constexpr int NQ = NCOL / 16;  // value columns of a lane: col0 + c + 16 m
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, c = lane & 15, hf = lane >> 4;
  const int col0 = warp * NCOL, seg = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const float* rb = r + b * st.r_b + h * st.r_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const float* wb = logw + b * st.w_b + h * st.w_h;
  float* at = smem + L::A_OFF + warp * QT * L::AS;  // this warp's A
  float* dec = smem + L::D_OFF;
  float* bsum = smem + L::BON_OFF;
  // this segment's state in the workspace, [q][p] (none for one segment)
  float* seg_state = nseg > 1 ? state + ((size_t)bh * nseg + seg) * P * P : nullptr;
  const int nchunks = S / Q;
  const int c_begin = seg * seg_chunks;
  const int c_end = min(nchunks, c_begin + seg_chunks);

  for (int i = tid; i < L::FLOATS / 4; i += THREADS)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the state S[p][q], key channels hf * HP + pp by value columns col0 + c + 16 m
  float s[NQ][HP];
#pragma unroll
  for (int m = 0; m < NQ; ++m)
#pragma unroll
    for (int pp = 0; pp < HP; pp += 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (WITH_Y && nseg > 1)
        a = *reinterpret_cast<const float4*>(seg_state + (size_t)(col0 + c + 16 * m) * P +
                                             hf * HP + pp);
      s[m][pp] = a.x; s[m][pp + 1] = a.y; s[m][pp + 2] = a.z; s[m][pp + 3] = a.w;
    }
  // the decays run a thread per key channel: p = tid + THREADS e, e < CPT
  constexpr int CPT = (P + THREADS - 1) / THREADS;
  float ld[CPT];  // the segment's summed log decay of each of them
#pragma unroll
  for (int e = 0; e < CPT; ++e) ld[e] = 0.f;

  load_chunk<P, NCOL, WITH_Y>(smem, rb, kb, vb, wb, (long long)c_begin * Q, Q, st, vec);
  for (int ch = c_begin; ch < c_end; ++ch) {
    float* stage = smem + ((ch - c_begin) & 1) * L::STAGE;
    float* rs = stage + L::R_OFF;
    float* ks = stage + L::K_OFF;
    float* ws = stage + L::W_OFF;
    const float* vs = stage + L::V_OFF;
    cp_async_wait_all();
    // the chunk is in its stage; every read of the other stage, of A, of the
    // decays and of the bonus shares is done
    __syncthreads();
    if (ch + 1 < c_end)
      load_chunk<P, NCOL, WITH_Y>(smem + ((ch + 1 - c_begin) & 1) * L::STAGE, rb, kb, vb, wb,
                                  (long long)(ch + 1) * Q, Q, st, vec);

    // the decays of this thread's channels over the chunk's rows: qn in
    // place of r, kn in place of logw, then kdec in place of k
    float bon[QT];  // this thread's share of each row's u bonus
#pragma unroll
    for (int i = 0; i < QT; ++i) bon[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int p = tid + THREADS * e;
      if (p < P) {
        // the cumsum first, then each half of the rows with its loads before
        // its stores (a store may alias a later load)
        const float uu = WITH_Y ? __ldg(u + h * P + p) : 0.f;
        float cw[QT];
#pragma unroll
        for (int i = 0; i < QT; ++i) cw[i] = ws[i * L::RS + p];
        float run = 0.f;
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          run += cw[i];
          cw[i] = run;
        }
#pragma unroll
        for (int i0 = 0; i0 < QT; i0 += QT / 2) {
          float rr[QT / 2], kk[QT / 2];
#pragma unroll
          for (int ii = 0; ii < QT / 2; ++ii) {
            kk[ii] = ks[(i0 + ii) * L::RS + p];
            rr[ii] = WITH_Y ? rs[(i0 + ii) * L::RS + p] : 0.f;
          }
#pragma unroll
          for (int ii = 0; ii < QT / 2; ++ii) {
            const int i = i0 + ii;
            if (WITH_Y) {
              const float cwp = i > 0 ? cw[i - 1] : 0.f;
              bon[i] += rr[ii] * uu * kk[ii];
              rs[i * L::RS + p] = rr[ii] * expf(cwp);
              ws[i * L::RS + p] = kk[ii] * expf(-cw[i]);
            }
            ks[i * L::RS + p] = kk[ii] * expf(run - cw[i]);
          }
        }
        dec[p] = expf(run);
        ld[e] += run;
      }
    }
    if (WITH_Y) {  // this warp's share of each row's bonus
      const float part = reduce_scatter16(bon, lane);
      if ((lane & 1) == 0) bsum[warp * QT + (lane >> 1)] = part;
    }
    __syncthreads();  // qn, kn, kdec, the decays and the bonus shares are complete

    if (WITH_Y) {
      // A row c: qn_c . kn_j over this half's key channels, then both halves
      float acc[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[j] = 0.f;
#pragma unroll
      for (int pp = 0; pp < HP; pp += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(rs + c * L::RS + hf * HP + pp);
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(ws + j * L::RS + hf * HP + pp);
          acc[j] = __fmaf_rn(qv.x, kv.x, acc[j]);
          acc[j] = __fmaf_rn(qv.y, kv.y, acc[j]);
          acc[j] = __fmaf_rn(qv.z, kv.z, acc[j]);
          acc[j] = __fmaf_rn(qv.w, kv.w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[j] += __shfl_xor_sync(FULL, acc[j], 16);
      if (hf == 0) {  // masked by a select: the strict lower part, the bonus on the diagonal
        float bc = 0.f;
#pragma unroll
        for (int w = 0; w < L::NW; ++w) bc += bsum[w * QT + c];
#pragma unroll
        for (int j = 0; j < QT; j += 4) {
          float a4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a4[e] = j + e < c ? acc[j + e] : (j + e == c ? bc : 0.f);
          *reinterpret_cast<float4*>(at + c * L::AS + j) = make_float4(a4[0], a4[1], a4[2], a4[3]);
        }
      }
      __syncwarp();

      // y on rows i, columns col0 + c + 16 m: qn_i . S over this half's key
      // channels plus A v over this half's keys j = 8 hf .., then both halves
      float vv[8][NQ];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int m = 0; m < NQ; ++m) vv[jj][m] = vs[(8 * hf + jj) * L::RS + col0 + c + 16 * m];
      float* yrow = y + b * st.y_b + h * st.y_h + col0 + c;
#pragma unroll
      for (int i0 = 0; i0 < QT; i0 += QT / 2) {  // two halves of the rows: fewer live sums
        float ya[QT / 2][NQ];
#pragma unroll
        for (int ii = 0; ii < QT / 2; ++ii) {
          const int i = i0 + ii;
          float (&yi)[NQ] = ya[ii];
#pragma unroll
          for (int m = 0; m < NQ; ++m) yi[m] = 0.f;
#pragma unroll
          for (int pp = 0; pp < HP; pp += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(rs + i * L::RS + hf * HP + pp);
#pragma unroll
            for (int m = 0; m < NQ; ++m) {
              yi[m] = __fmaf_rn(qv.x, s[m][pp], yi[m]);
              yi[m] = __fmaf_rn(qv.y, s[m][pp + 1], yi[m]);
              yi[m] = __fmaf_rn(qv.z, s[m][pp + 2], yi[m]);
              yi[m] = __fmaf_rn(qv.w, s[m][pp + 3], yi[m]);
            }
          }
          const float4 a0 = *reinterpret_cast<const float4*>(at + i * L::AS + 8 * hf);
          const float4 a1 = *reinterpret_cast<const float4*>(at + i * L::AS + 8 * hf + 4);
#pragma unroll
          for (int m = 0; m < NQ; ++m) {
            yi[m] = __fmaf_rn(a0.x, vv[0][m], yi[m]);
            yi[m] = __fmaf_rn(a0.y, vv[1][m], yi[m]);
            yi[m] = __fmaf_rn(a0.z, vv[2][m], yi[m]);
            yi[m] = __fmaf_rn(a0.w, vv[3][m], yi[m]);
            yi[m] = __fmaf_rn(a1.x, vv[4][m], yi[m]);
            yi[m] = __fmaf_rn(a1.y, vv[5][m], yi[m]);
            yi[m] = __fmaf_rn(a1.z, vv[6][m], yi[m]);
            yi[m] = __fmaf_rn(a1.w, vv[7][m], yi[m]);
          }
        }
#pragma unroll
        for (int ii = 0; ii < QT / 2; ++ii) {
          const int i = i0 + ii;
#pragma unroll
          for (int m = 0; m < NQ; ++m) {
            const float tot = ya[ii][m] + __shfl_xor_sync(FULL, ya[ii][m], 16);
            // half hf stores the columns m with m % 2 == hf: a row's 32 lanes
            // write 32 consecutive columns
            if (i < Q && (NQ == 1 ? hf == 0 : (m & 1) == hf))
              yrow[((long long)ch * Q + i) * st.y_s + 16 * m] = tot;
          }
        }
      }
    }

    // S = diag(exp(cw_Q)) S + kdec^T v, on this lane's channels and columns
#pragma unroll
    for (int pp = 0; pp < HP; pp += 4) {
      const float4 d = *reinterpret_cast<const float4*>(dec + hf * HP + pp);
#pragma unroll
      for (int m = 0; m < NQ; ++m) {
        s[m][pp] *= d.x; s[m][pp + 1] *= d.y; s[m][pp + 2] *= d.z; s[m][pp + 3] *= d.w;
      }
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      float vi[NQ];
#pragma unroll
      for (int m = 0; m < NQ; ++m) vi[m] = vs[i * L::RS + col0 + c + 16 * m];
#pragma unroll
      for (int pp = 0; pp < HP; pp += 4) {
        const float4 kd = *reinterpret_cast<const float4*>(ks + i * L::RS + hf * HP + pp);
#pragma unroll
        for (int m = 0; m < NQ; ++m) {
          s[m][pp] = __fmaf_rn(kd.x, vi[m], s[m][pp]);
          s[m][pp + 1] = __fmaf_rn(kd.y, vi[m], s[m][pp + 1]);
          s[m][pp + 2] = __fmaf_rn(kd.z, vi[m], s[m][pp + 2]);
          s[m][pp + 3] = __fmaf_rn(kd.w, vi[m], s[m][pp + 3]);
        }
      }
    }
  }

  if (!WITH_Y) {
#pragma unroll
    for (int m = 0; m < NQ; ++m)
#pragma unroll
      for (int pp = 0; pp < HP; pp += 4)
        *reinterpret_cast<float4*>(seg_state + (size_t)(col0 + c + 16 * m) * P + hf * HP + pp) =
            make_float4(s[m][pp], s[m][pp + 1], s[m][pp + 2], s[m][pp + 3]);
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int p = tid + THREADS * e;
      if (p < P) decay[((size_t)bh * nseg + seg) * P + p] = ld[e];
    }
  }
}

// Grid 2: the state entering every segment, in place of the end states grid 1
// stored; a state element [q][p] decays by its key channel p.
__global__ void rwkv6_f32_pass_states(float* __restrict__ state, const float* __restrict__ decay,
                                      int BH, int P, int nseg) {
  scan_pass_states(state, decay, BH, P * P, P, nseg);
}

template <int P, int NCOL>
int launch(const float* r, const float* k, const float* v, const float* logw, const float* u,
           float* y, float* state, float* decay, int B, int H, int S, int Q, int seg_chunks,
           const Strides& st, int vec, cudaStream_t stream) {
  using L = Smem<P, NCOL>;
  constexpr int THREADS = 32 * L::NW;
  const int nchunks = S / Q;
  const int nseg = (nchunks + seg_chunks - 1) / seg_chunks;
  if (nseg > 1) {
    cudaError_t err = cudaFuncSetAttribute(rwkv6_f32_kernel<P, NCOL, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    rwkv6_f32_kernel<P, NCOL, false><<<dim3(nseg - 1, B * H), THREADS, L::BYTES, stream>>>(
        r, k, v, logw, u, y, state, decay, H, S, Q, seg_chunks, nseg, st, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)B * H * P * P;
    rwkv6_f32_pass_states<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(state, decay, B * H,
                                                                              P, nseg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(rwkv6_f32_kernel<P, NCOL, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  rwkv6_f32_kernel<P, NCOL, true><<<dim3(nseg, B * H), THREADS, L::BYTES, stream>>>(
      r, k, v, logw, u, y, state, decay, H, S, Q, seg_chunks, nseg, st, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: r, k, v, logw, y (b, h, s) each, in elements; every last axis is
// dense and u is contiguous; every tensor is f32. ncol: the value columns a
// warp takes, which the caller's segment plan counts on; the instances built
// take 32 at P = 32 and 64, 16 at P = 16 and 48, and any other ncol is
// refused. seg_chunks: chunks of a segment; when the sequence has more than
// one segment, state holds B*H*nseg*P*P floats and decay B*H*nseg*P (nseg =
// ceil((S/Q) / seg_chunks)), else both may be null. vec says that every row
// of r, k, v and logw is 16-byte aligned. Runs one grid, or three when there
// is more than one segment. Returns the first failing launch's
// cudaGetLastError() code (0 on success). Does not synchronise.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* logw,
                                 const void* u, void* y, void* state, void* decay, int B, int H,
                                 int S, int P, int Q, int ncol, int seg_chunks,
                                 const long long* strides, int vec, void* stream) {
  if (B < 1 || H < 1 || S < 1 || P < 16 || P > 64 || P % 16 != 0 || Q < 1 || Q > QT ||
      S % Q != 0 || ncol != (P % 32 == 0 ? 32 : 16) || seg_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int nseg = (S / Q + seg_chunks - 1) / seg_chunks;
  if (nseg > 1 && (state == nullptr || decay == nullptr)) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(logw);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  float* df = static_cast<float*>(decay);
  switch (P) {
    case 16:
      return launch<16, 16>(rf, kf, vf, wf, uf, yf, sf, df, B, H, S, Q, seg_chunks, st, vec, cs);
    case 32:
      return launch<32, 32>(rf, kf, vf, wf, uf, yf, sf, df, B, H, S, Q, seg_chunks, st, vec, cs);
    case 48:
      return launch<48, 16>(rf, kf, vf, wf, uf, yf, sf, df, B, H, S, Q, seg_chunks, st, vec, cs);
    default:
      return launch<64, 32>(rf, kf, vf, wf, uf, yf, sf, df, B, H, S, Q, seg_chunks, st, vec, cs);
  }
}
