// Causal GQA flash attention (forward) in f32 on the CUDA cores, with an
// optional sliding window: the exact path, for f32 tensors. bf16 tensors go
// to csrc/flash_attention_wgmma.cu, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention_hsd through pl.pallas_call).
// That kernel ran a (B, H, q-tile, kv-tile) grid whose kv axis is sequential
// on the TensorCore, kept the online-softmax state (m, l, acc) in VMEM
// scratch that persists across kv steps, and skipped tiles outside the
// causal/window band with pl.when.
//
// Layout: q (B, H, S, D), k and v (B, KH, S, D), o (B, H, S, D), all f32 and
// contiguous; f32 products and softmax. kv head h/(H/KH).
// Mask: pos_k <= pos_q, and pos_k > pos_q - window when window > 0, with a
// -1e30 sentinel (never -inf, so a row whose first tile is fully masked gives
// no NaN); each row ends divided by max(l, 1e-30). Any S: ragged edges are
// masked. Sq == Skv only (the wrapper enforces it).
//
// Why f32 stays on the CUDA cores: TF32 on the tensor cores keeps about three
// decimal digits, and this path is the exact yardstick the f32 model checks
// hold to a few 1e-7 of the largest logit. What bounds it on Hopper:
// operations. A (q, k) pair costs 4*D flops for 8*D bytes of k and v that a
// q-tile of 64 rows shares, so the kernel does ~32 flops per byte it loads,
// far above the card's balance point for f32 arithmetic outside the tensor
// cores; its ceiling is the 67 TFLOP/s f32 rate. The design answers the
// bound it has:
//   * one block of 256 threads per (q-tile of 64 rows, head, batch); heavy
//     (late, long-causal) tiles are scheduled first;
//   * a loop inside the block over only the 64-key tiles that meet the
//     causal/window band replaces the TPU's sequential kv grid axis and its
//     pl.when skip;
//   * Q (pre-scaled by D^-0.5, as the TPU kernel scales it) and K are staged
//     transposed in shared memory, so each thread's 4x4 block of scores
//     reads one float4 of q and one of k per d and issues 16 FMAs;
//   * the running m, l and a 4 x D/16 slice of acc stay in registers; the
//     row max and row sum reduce over the 16 threads of a row group with
//     warp shuffles; P goes through shared memory once per tile for P.V;
//   * products are explicit fmaf, so the repository's -fmad=false flag
//     (kept for the JRBA kernel's bit identity) does not split them.
// At D = 256 the tiles take 217 KB of shared memory, above the static
// 48 KB: the launcher raises the block's dynamic shared-memory limit.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;         // query rows of a block
constexpr int BK = 64;         // keys of a kv tile
constexpr int THREADS = 256;   // 16 row groups x 16 column threads
constexpr int TS = BQ + 4;     // row stride of the transposed tiles (floats)
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "the transposed tiles share one row stride");

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)D * TS + (size_t)BK * D + (size_t)BK * TS;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int H, int KH, int S, int window, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DC = D / 16;  // output columns of one thread
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;         // [D][TS]  q * scale, transposed
  float* kT = qT + D * TS;  // [D][TS]  k, transposed
  float* vs = kT + D * TS;  // [BK][D]  v
  float* pT = vs + BK * D;  // [BK][TS] probabilities, transposed

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t qbase = ((size_t)b * H + h) * (size_t)S * D;
  const size_t kbase = ((size_t)b * KH + kh) * (size_t)S * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qT[d * TS + r] = q0 + r < S ? q[qbase + (size_t)(q0 + r) * D + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_first / BK) * BK; k0 <= q_last; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < S;
      const size_t off = kbase + (size_t)(k0 + c) * D + d;
      kT[d * TS + c] = in ? k[off] : 0.f;
      vs[c * D + d] = in ? v[off] : 0.f;
    }
    __syncthreads();

    // scores of rows 4ty..4ty+3 against keys 4tx..4tx+3
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * TS + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kT + d * TS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(av[i], cv[j], s[i][j]);
    }

    // mask, online softmax; a row's 16 column threads are lanes of one
    // 16-lane half warp, so xor shuffles over 8..1 stay inside the row group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pq = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pk = k0 + 4 * tx + j;
        const bool live = pk <= pq && pk < S && (window <= 0 || pk > pq - window);
        s[i][j] = live ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (4 * tx + j) * TS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[rows 4ty..4ty+3][cols tx + 16c] += P . V
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pT + c * TS + 4 * ty);
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float x = vs[c * D + tx + 16 * cc];
        acc[0][cc] = __fmaf_rn(p.x, x, acc[0][cc]);
        acc[1][cc] = __fmaf_rn(p.y, x, acc[1][cc]);
        acc[2][cc] = __fmaf_rn(p.z, x, acc[2][cc]);
        acc[3][cc] = __fmaf_rn(p.w, x, acc[3][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pq = q0 + 4 * ty + i;
    if (pq >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = o + qbase + (size_t)pq * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH, int S,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, KH, S, window, scale);
  return (int)cudaGetLastError();
}

int dispatch(int D, const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
             int S, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, H, KH, S, window, scale, stream);
    case 32: return launch<32>(q, k, v, o, B, H, KH, S, window, scale, stream);
    case 64: return launch<64>(q, k, v, o, B, H, KH, S, window, scale, stream);
    case 96: return launch<96>(q, k, v, o, B, H, KH, S, window, scale, stream);
    case 112: return launch<112>(q, k, v, o, B, H, KH, S, window, scale, stream);
    case 128: return launch<128>(q, k, v, o, B, H, KH, S, window, scale, stream);
    case 256: return launch<256>(q, k, v, o, B, H, KH, S, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaGetLastError() code (0 on success); f32 tensors
// only. Does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int KH, int S, int D, int window,
                                      float scale, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || S < 1) return (int)cudaErrorInvalidValue;
  return dispatch(D, q, k, v, o, B, H, KH, S, window, scale, static_cast<cudaStream_t>(stream));
}
