// Mamba-2 SSD chunked scan (forward), f32 on the CUDA cores: y only, as the
// TPU kernel returns it.
//
// Replaces, for f32 tensors, the TPU kernel src/repro/kernels/ssd.py
// (_ssd_kernel, launched by ssd_scan_hsd through pl.pallas_call); bf16
// tensors take csrc/ssd_scan_mma.cu, on the tensor cores. That kernel ran a (B, H, chunk) grid
// whose chunk axis is sequential on the TensorCore and carried the N x P f32
// state in VMEM scratch from one chunk to the next.
//
// Per chunk of Q rows, with la = dt * A (<= 0) and cum its inclusive cumsum:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j  +  exp(cum_i) C_i . state
//   state = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
// exp(cum_i - cum_j) is computed only where j <= i: above the diagonal it may
// be +inf, and 0 * inf would be NaN (the mask is a select, never a product).
//
// Layout: x (B, H, S, P), y, dt (B, H, S), A (H,), B and C (B, S, N), all
// f32; every operand is read through
// the strides the launcher is given, with only its last axis dense, so the
// model's (B, S, H, P) tensors are read in place. f32 arithmetic throughout.
//
// Hopper has no sequential grid axis: blocks run in no order. So each block
// owns one (b, h, slice of PB value columns) and walks every chunk itself,
// with the N x PB state slice in shared memory. Columns are independent
// (y[:, p] reads only x[:, p] and state[:, p]), so a head's P columns split
// over P/PB blocks (zamba2-7b: 112 heads x 2 = 224 blocks for 132 SMs); each
// block recomputes the chunk's Q x Q matrix C.B^T, which B and C (shared by
// every head) make the same for all of them.
//
// What bounds it on Hopper: at zamba2-7b's shape (S=32768, H=112, P=N=64,
// chunk 64) its 7.7e10 f32 operations on the CUDA cores (1.15 ms at 67
// TFLOP/s); in practice its shared-memory loads and FMAs per chunk (about
// 0.85k loads and 2.3k FMAs a thread). Exact f32 keeps it off the tensor
// cores. The design answers the bound it has:
//   * C.B^T in a TQ x TQ register tile a thread (TQ = Q/16), operands read
//     from n-major tiles with one vector load each;
//   * W = mask(C.B^T * decay) * dt is stored transposed, so the product
//     W.x reads a thread's TQ rows with one vector load per j and stops at
//     the thread's last row (the causal half is skipped);
//   * B is pre-scaled by exp(cum_Q - cum_j) dt_j in place once y is done,
//     so the state update is one FMA per term;
//   * the chunk's cumsum is a warp scan with shuffles;
//   * products are explicit fmaf, so the repository's -fmad=false flag does
//     not split them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int MAX_N = 64;     // state rows: the update keeps 4 rows of 16 a thread

struct Strides {
  long long x_b, x_h, x_s;
  long long dt_b, dt_h, dt_s;
  long long b_b, b_s;
  long long c_b, c_s;
  long long y_b, y_h, y_s;
};

// K consecutive floats from 16-byte-aligned (K >= 4) or K-aligned shared memory
template <int K>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
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
__device__ __forceinline__ void store_vec(float* p, const float* in) {
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

template <int Q, int PB>
constexpr size_t smem_floats(int N) {
  constexpr int QS = Q + 4;
  return 2 * (size_t)N * QS + (size_t)Q * QS + (size_t)Q * PB + (size_t)N * PB + 4 * Q;
}

template <int Q, int PB>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y, int S, int N, Strides st) {
  static_assert(Q % 16 == 0 && PB % 16 == 0, "Q and PB must be multiples of 16");
  constexpr int TQ = Q / 16;  // rows (and columns of C.B^T) of a thread
  constexpr int QS = Q + 4;   // row stride of the n-major tiles and of W^T
  constexpr int PC = PB / 16; // value columns of a thread
  extern __shared__ __align__(16) float smem[];
  float* cT = smem;           // [N][QS]  C of the chunk, n-major
  float* bT = cT + N * QS;    // [N][QS]  B of the chunk, n-major
  float* wT = bT + N * QS;    // [Q][QS]  W^T: wT[j][i] = W[i][j]
  float* xs = wT + Q * QS;    // [Q][PB]  x of the chunk
  float* hs = xs + Q * PB;    // [N][PB]  the state slice
  float* cum = hs + N * PB;   // [Q]      inclusive cumsum of dt * A
  float* ecum = cum + Q;      // [Q]      exp(cum)
  float* dts = ecum + Q;      // [Q]
  float* wj = dts + Q;        // [Q]      exp(cum_Q - cum_j) dt_j

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h];
  const float* xb = x + b * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const float* Bb = Bm + b * st.b_b;
  const float* Cb = Cm + b * st.c_b;
  float* yb = y + b * st.y_b + h * st.y_h + p0;

  for (int i = tid; i < N * PB; i += THREADS) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      const long long row = c0 + r;
      cT[n * QS + r] = Cb[row * st.c_s + n];
      bT[n * QS + r] = Bb[row * st.b_s + n];
    }
    for (int i = tid; i < Q * PB; i += THREADS) {
      const int r = i / PB, p = i - r * PB;
      xs[i] = xb[(long long)(c0 + r) * st.x_s + p];
    }
    if (tid < Q) dts[tid] = dtb[(long long)(c0 + tid) * st.dt_s];
    __syncthreads();

    if (tid < 32) {  // inclusive cumsum of dt * A: one warp, 32 rows a step
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        float v = i < Q ? dts[i] * a : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (i < Q) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      for (int i = tid; i < Q; i += 32) {  // rows this lane wrote
        ecum[i] = expf(cum[i]);
        wj[i] = expf(carry - cum[i]) * dts[i];
      }
    }
    __syncthreads();

    // W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0, on
    // rows ty*TQ.. and columns tx*TQ..; tiles above the diagonal are never read
    {
      float g[TQ][TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[TQ], bv[TQ];
        load_vec<TQ>(cT + n * QS + ty * TQ, cv);
        load_vec<TQ>(bT + n * QS + tx * TQ, bv);
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TQ; ++j) g[i][j] = __fmaf_rn(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int col = tx * TQ + j;
        float w[TQ];
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const int row = ty * TQ + i;
          w[i] = col <= row ? g[i][j] * expf(cum[row] - cum[col]) * dts[col] : 0.f;
        }
        store_vec<TQ>(wT + col * QS + ty * TQ, w);
      }
    }
    __syncthreads();

    // y on rows ty*TQ + i, columns tx + 16c: W.x (up to the last row) plus
    // exp(cum_i) C_i . state
    {
      float acc[TQ][PC], inter[TQ][PC];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[i][c] = inter[i][c] = 0.f;
      const int jend = (ty + 1) * TQ;
      for (int j = 0; j < jend; ++j) {
        float w[TQ], xv[PC];
        load_vec<TQ>(wT + j * QS + ty * TQ, w);
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = xs[j * PB + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[i][c] = __fmaf_rn(w[i], xv[c], acc[i][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[TQ], hv[PC];
        load_vec<TQ>(cT + n * QS + ty * TQ, cv);
#pragma unroll
        for (int c = 0; c < PC; ++c) hv[c] = hs[n * PB + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int c = 0; c < PC; ++c) inter[i][c] = __fmaf_rn(cv[i], hv[c], inter[i][c]);
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int row = ty * TQ + i;
        const float e = ecum[row];
        float* out = yb + (long long)(c0 + row) * st.y_s + tx;
#pragma unroll
        for (int c = 0; c < PC; ++c) out[16 * c] = acc[i][c] + e * inter[i][c];
      }
    }
    // B_j scaled by exp(cum_Q - cum_j) dt_j, in place: only the state
    // update below reads bT from here on
    for (int i = tid; i < N * Q; i += THREADS) {
      const int n = i / Q, j = i - n * Q;
      bT[n * QS + j] *= wj[j];
    }
    __syncthreads();

    // state[n][p] = exp(cum_Q) state[n][p] + sum_j (B_j[n] w_j) x_j[p], on
    // rows ty + 16r, columns tx + 16c
    {
      const float gl = ecum[Q - 1];
      float acc[MAX_N / 16][PC];
#pragma unroll
      for (int r = 0; r < MAX_N / 16; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float xv[PC];
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = xs[j * PB + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < MAX_N / 16; ++r) {
          const int n = ty + 16 * r;
          if (n < N) {
            const float bw = bT[n * QS + j];
#pragma unroll
            for (int c = 0; c < PC; ++c) acc[r][c] = __fmaf_rn(bw, xv[c], acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAX_N / 16; ++r) {
        const int n = ty + 16 * r;
        if (n < N) {
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            float* s = hs + n * PB + tx + 16 * c;
            *s = *s * gl + acc[r][c];
          }
        }
      }
    }
  }
}

template <int Q, int PB>
int launch(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           float* y, int B, int H, int S, int P, int N, const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_floats<Q, PB>(N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<Q, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P / PB, H, B);
  ssd_scan_kernel<Q, PB><<<grid, THREADS, smem, stream>>>(x, dt, A, Bm, Cm, y, S, N, st);
  return (int)cudaGetLastError();
}

template <int PB>
int dispatch_q(int Q, const float* x, const float* dt, const float* A, const float* Bm,
               const float* Cm, float* y, int B, int H, int S, int P, int N, const Strides& st,
               cudaStream_t s) {
  switch (Q) {
    case 16: return launch<16, PB>(x, dt, A, Bm, Cm, y, B, H, S, P, N, st, s);
    case 32: return launch<32, PB>(x, dt, A, Bm, Cm, y, B, H, S, P, N, st, s);
    case 64: return launch<64, PB>(x, dt, A, Bm, Cm, y, B, H, S, P, N, st, s);
    case 128: return launch<128, PB>(x, dt, A, Bm, Cm, y, B, H, S, P, N, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: x (b, h, s), dt (b, h, s), B (b, s), C (b, s), y (b, h, s), in
// elements; every last axis is dense; every operand is f32. Returns the
// launch's cudaGetLastError() code (0 on success). Does not synchronise.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, int B, int H, int S, int P, int N,
                               int Q, const long long* strides, void* stream) {
  if (B < 1 || H < 1 || S < 1 || N < 1 || N > MAX_N || P < 16 || P % 16 != 0 || Q < 1 ||
      S % Q != 0)
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
  // 32 value columns a block where P allows it, else 16
  if (P % 32 == 0) return dispatch_q<32>(Q, xf, dtf, Af, bf, cf, yf, B, H, S, P, N, st, s);
  return dispatch_q<16>(Q, xf, dtf, Af, bf, cf, yf, B, H, S, P, N, st, s);
}
