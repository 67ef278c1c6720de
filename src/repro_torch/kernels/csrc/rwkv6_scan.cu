// RWKV-6 (Finch) wkv scan (forward): y only, as the TPU kernel returns it.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py (_rwkv6_kernel,
// launched by rwkv6_scan_hsd through pl.pallas_call). That kernel ran a
// (B, H, chunk) grid whose chunk axis is sequential on the TensorCore and
// carried the P x P f32 state S[p_key][p_val] in VMEM scratch.
//
// Per chunk of Q <= 16 rows, with cw the inclusive cumsum of logw (<= 0) and
// cw_prev = cw - logw:
//   qn = r exp(cw_prev) (<= 1),  kn = k exp(-cw) (<= e^(Q |logw|_max))
//   A[i][j] = qn_i . kn_j for j < i,  r_i . (u * k_i) for j == i,  0 above
//   y_i     = sum_j A[i][j] v_j + qn_i . S
//   S       = diag(exp(cw_Q)) S + sum_j (k_j exp(cw_Q - cw_j)) v_j^T
// The factorization against the chunk start is exact while kn stays finite:
// under the model's clamp |logw| <= e that is e^43.5 at Q = 16 and would be
// e^174 at Q = 64, so the launcher refuses Q > 16. The causal mask is a
// select (the strict lower triangle plus the u bonus on the diagonal), never
// a product: above the diagonal qn . kn may be huge.
//
// Layout: r, k, v, y and logw (B, H, S, P) f32, u (H, P) f32 (bf16 tensors
// go to csrc/rwkv6_scan_mma.cu, on the tensor cores); r, k, v, logw and y are read through the
// strides the launcher is given, with only the last axis dense, so the
// model's (B, S, H, P) tensors are read in place. f32 arithmetic throughout.
//
// Hopper has no sequential grid axis: each block owns one (b, h, slice of
// VB = 16 value columns) and walks every chunk, with its P x VB slice of the
// state in shared memory. Value columns are independent (y[:, q] reads only
// v[:, q] and S[:, q]), so a head's P = 64 columns split over 4 blocks
// (rwkv6-3b: 40 heads x 4 = 160 blocks for 132 SMs); each block recomputes
// the chunk's Q x Q matrix A.
//
// What bounds it on Hopper: at the model's shape the bytes (r, k, v, y and
// logw, 1.7 GB at S=32768) against 2.6e10 flops, 0.50 ms at 3.35 TB/s. The chunk loop is a chain of 2048 dependent steps a block, each a few
// hundred FMAs a thread between five barriers, so the first version is bound
// by that chain's latency. The design answers it:
//   * the next chunk's r, k, logw and v are loaded into registers while the
//     current one is computed (one load each of at most 4 values a thread);
//   * per-channel prefix sums run one thread per key channel, in place;
//   * products are explicit fmaf, so the repository's -fmad=false flag does
//     not split them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 16;            // chunk length
constexpr int MAX_P = 64;            // key (and value) channels of a head
constexpr int VB = 16;               // value columns of a block
constexpr int PF = MAX_Q * MAX_P / THREADS;  // prefetched values of r, k, logw a thread

struct Strides {
  long long r_b, r_h, r_s;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long w_b, w_h, w_s;
  long long y_b, y_h, y_s;
};

__global__ void __launch_bounds__(THREADS)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, float* __restrict__ y, int S, int P, int Q,
                  Strides st) {
  __shared__ float qs[MAX_Q][MAX_P + 1];  // r, then r exp(cw_prev)
  __shared__ float ks[MAX_Q][MAX_P + 1];  // k, then k exp(-cw)
  __shared__ float ls[MAX_Q][MAX_P + 1];  // logw, then cw, then k exp(cw_Q - cw)
  __shared__ float rk[MAX_Q][MAX_P + 1];  // r u k
  __shared__ float vs[MAX_Q][VB];
  __shared__ float ss[MAX_P][VB];         // S[p][q0 + q]
  __shared__ float am[MAX_Q][MAX_Q + 1];
  __shared__ float dec[MAX_P];            // exp(cw_Q)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * VB, h = blockIdx.y, b = blockIdx.z;
  const float* rb = r + b * st.r_b + h * st.r_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h + q0;
  const float* wb = logw + b * st.w_b + h * st.w_h;
  float* yb = y + b * st.y_b + h * st.y_h + q0;
  const float up = tid < P ? u[h * P + tid] : 0.f;
  const int QP = Q * P;

  for (int i = tid; i < P * VB; i += THREADS) ss[i / VB][i % VB] = 0.f;

  // registers holding the next chunk: element e = tid + THREADS m of the
  // chunk's Q x P (row-major) r, k, logw, and element tid of its Q x VB v
  float pr[PF], pk[PF], pw[PF], pv = 0.f;
  auto fetch = [&](int c0) {
#pragma unroll
    for (int m = 0; m < PF; ++m) {
      const int e = tid + THREADS * m;
      if (e < QP) {
        const long long i = c0 + e / P;
        const int p = e % P;
        pr[m] = rb[i * st.r_s + p];
        pk[m] = kb[i * st.k_s + p];
        pw[m] = wb[i * st.w_s + p];
      }
    }
    if (tid < Q * VB) pv = vb[(long long)(c0 + tid / VB) * st.v_s + tid % VB];
  };
  fetch(0);

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int m = 0; m < PF; ++m) {
      const int e = tid + THREADS * m;
      if (e < QP) {
        qs[e / P][e % P] = pr[m];
        ks[e / P][e % P] = pk[m];
        ls[e / P][e % P] = pw[m];
      }
    }
    if (tid < Q * VB) vs[tid / VB][tid % VB] = pv;
    if (c0 + Q < S) fetch(c0 + Q);  // in flight while this chunk is computed
    __syncthreads();

    if (tid < P) {  // key channel p = tid, its Q rows in order
      const int p = tid;
      float cw = 0.f;
      for (int i = 0; i < Q; ++i) {
        const float l = ls[i][p];
        cw = cw + l;
        const float cw_prev = cw - l;
        const float rv = qs[i][p];
        rk[i][p] = rv * up * ks[i][p];
        qs[i][p] = rv * expf(cw_prev);
        ls[i][p] = cw;
      }
      for (int i = 0; i < Q; ++i) {
        const float kv = ks[i][p], c = ls[i][p];
        ks[i][p] = kv * expf(-c);
        ls[i][p] = kv * expf(cw - c);
      }
      dec[p] = expf(cw);
    }
    __syncthreads();

    if (tid < Q * Q) {  // A[i][j]
      const int i = tid / Q, j = tid % Q;
      float a = 0.f;
      if (j < i) {
        for (int p = 0; p < P; ++p) a = __fmaf_rn(qs[i][p], ks[j][p], a);
      } else if (j == i) {
        for (int p = 0; p < P; ++p) a += rk[i][p];
      }
      am[i][j] = a;
    }
    __syncthreads();

    if (tid < Q * VB) {  // y[i][q0 + q]
      const int i = tid / VB, q = tid % VB;
      float intra = 0.f, inter = 0.f;
      for (int j = 0; j <= i; ++j) intra = __fmaf_rn(am[i][j], vs[j][q], intra);
      for (int p = 0; p < P; ++p) inter = __fmaf_rn(qs[i][p], ss[p][q], inter);
      yb[(long long)(c0 + i) * st.y_s + q] = intra + inter;
    }
    __syncthreads();

    for (int e = tid; e < P * VB; e += THREADS) {  // S[p][q0 + q]
      const int p = e / VB, q = e % VB;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = __fmaf_rn(ls[j][p], vs[j][q], acc);
      ss[p][q] = ss[p][q] * dec[p] + acc;
    }
  }
}

}  // namespace

// strides: r, k, v, logw, y (b, h, s) each, in elements; every last axis is
// dense and u is contiguous. Returns the launch's cudaGetLastError() code (0
// on success). f32 tensors only. Does not synchronise.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* logw,
                                 const void* u, void* y, int B, int H, int S, int P, int Q,
                                 const long long* strides, void* stream) {
  if (B < 1 || H < 1 || S < 1 || P < VB || P > MAX_P || P % VB != 0 || Q < 1 || Q > MAX_Q ||
      S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14]};
  rwkv6_scan_kernel<<<dim3(P / VB, H, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u), static_cast<float*>(y), S,
      P, Q, st);
  return (int)cudaGetLastError();
}
