// GQA flash attention (forward) in f32 on the CUDA cores, causal or not, with
// an optional sliding window: the exact path, for f32 tensors. bf16 tensors go
// to csrc/flash_attention_wgmma.cu, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention_hsd through pl.pallas_call).
// That kernel ran a (B, H, q-tile, kv-tile) grid whose kv axis is sequential
// on the TensorCore, kept the online-softmax state (m, l, acc) in VMEM
// scratch that persists across kv steps, and skipped tiles outside the
// causal/window band with pl.when.
//
// Layout: q (B, H, S, D), k (B, KH, S, D), v (B, KH, S, DV), o (B, H, S,
// DV), all f32 and contiguous; f32 products and softmax. kv head h/(H/KH).
// V and O have a head dim of their own (MLA: D = 96 or 192 against DV = 64
// or 128), a template parameter, so P V and the store run at DV. Rows of q,
// k and v load by 16 bytes when the three bases are 16-byte aligned (every
// row is then, as D and DV are multiples of 16), else element by element.
// Mask: pos_k <= pos_q when causal, and pos_k > pos_q - window when
// window > 0, with a -1e30 sentinel (never -inf, so a row whose first tile is
// fully masked gives no NaN); each row ends divided by max(l, 1e-30). The
// caller's scale multiplies q (D^-0.5 by default, as the TPU kernel scales
// it). Any S: ragged edges are masked. Sq == Skv only (the wrapper enforces
// it).
//
// Why f32 stays on the CUDA cores: TF32 on the tensor cores keeps about three
// decimal digits, and this path is the exact yardstick the f32 model checks
// hold to a few 1e-7 of the largest logit. What bounds it on Hopper:
// operations, 4*D flops a live (q, k) pair against q, k, v and o moved once,
// at the 67 TFLOP/s f32 rate. The first version (a 4x4 register tile a
// thread, K staged transposed by scalar stores, synchronous loads, three
// barriers a tile) ran at 39% of that bound at D = 112: its products waited
// on shared-memory loads, not on the FMA pipes. This one is laid out like an
// SGEMM:
//   * a block of 256 threads owns 16*RM query rows (RM = 8: 128 rows; RM = 4
//     at D = 256, where the tiles would not fit and gemma3's four heads need
//     the blocks); thread (ty, tx) owns rows RM*ty.. of its warp's 2*RM rows;
//   * S = Q K^T: each thread scores its RM rows against BK/16 keys
//     (tx + 16j), reading q and k by float4 along D from tiles kept in their
//     natural row-major layout, padded so neither the cp.async stores nor the
//     reads conflict: RM + BK/16 float4 loads for 4*RM*BK/16 FMAs;
//   * O += P V: P goes to a tile private to the warp (no block barrier), each
//     thread reads its RM probabilities of a key by float4 (one address for
//     the 16 threads of a row group) and DV/16 values of v, by float4 where
//     DV is a multiple of 64;
//   * K and V are loaded by cp.async behind the compute: where two stages of
//     them fit (D <= 112, and (96, 64)), tile j+1 while tile j is
//     computed, one block barrier a tile; else V of tile j while S of tile
//     j is computed and K of tile j+1 while P V of tile j is, two barriers
//     a tile;
//   * the running m, the partial l (summed over the row's 16 threads once, at
//     the end) and acc stay in registers; the row max reduces over the 16
//     threads with xor shuffles;
//   * a warp skips the tiles that miss its rows' band; the block loop visits
//     only the tiles that meet the block's band, heaviest (latest) q tiles
//     first;
//   * products are explicit __fmaf_rn, so the repository's -fmad=false flag
//     (kept for the JRBA kernel's bit identity) does not split them.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// One instance: head dims D (q, k) and DV (v, o), RM query rows a thread, BK
// keys a kv tile, RG row groups (ty) of 16 key / column threads (tx) a block.
template <int D, int DV, int RM, int BK, int RG>
struct Cfg {
  static_assert(D % 16 == 0 && DV % 16 == 0 && RM % 4 == 0 && BK % 16 == 0 && RG % 2 == 0,
                "tile shapes");
  static constexpr int THREADS = 16 * RG;
  static constexpr int WARPS = RG / 2;
  static constexpr int BQ = RG * RM;                 // query rows of a block
  static constexpr int KPT = BK / 16;                // keys of a tile a thread scores
  static constexpr int DC = DV / 16;                 // output columns of a thread
  static constexpr int VW = DV % 64 == 0 ? 4 : 1;    // value columns read at once
  static constexpr int QS = D + 4;                   // row stride of the Q and K tiles
  static constexpr int WR = 2 * RM;                  // query rows of a warp
  static constexpr int PS = WR + 4;                  // row (key) stride of a warp's P tile
  static constexpr int KV = BK * QS + BK * DV;       // one stage: a K and a V tile
  static constexpr int P_FLOATS = WARPS * BK * PS;
  // two stages (one barrier a tile) where they fit the block's 227 KB
  static constexpr int STAGES = (BQ * QS + 2 * KV + P_FLOATS) * 4 <= 232448 ? 2 : 1;
  static constexpr int K_OFF = BQ * QS;              // floats
  static constexpr int V_OFF = K_OFF + BK * QS;
  static constexpr int P_OFF = K_OFF + STAGES * KV;
  static constexpr int FLOATS = P_OFF + P_FLOATS;
  static constexpr size_t BYTES = (size_t)FLOATS * sizeof(float);
  // blocks an SM is to hold: two where RM = 4 leaves the registers for it
  // and the tiles fit twice in its 228 KB (1 KB reserved a block)
  static constexpr int BLOCKS = RM == 4 && BYTES + 1024 <= 116736 ? 2 : 1;
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

// 4 bytes (one element) from global to shared memory; zero where ``in`` is
// false
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows k0.. of one (b, kv head) K or V tile into shared memory at row stride
// ``stride``, by 16 bytes where ``vec`` says the rows are aligned for it, else
// element by element; rows past S read as zeros
template <int D, int BK, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src, int k0, int S,
                                          bool vec) {
  constexpr int G = D / 4;  // 16-byte granules a row
  for (int i = threadIdx.x; i < BK * G; i += THREADS) {
    const int r = i / G, c = 4 * (i - r * G);
    const bool in = k0 + r < S;
    const float* from = src + (size_t)(in ? k0 + r : 0) * D + c;
    if (vec) {
      cp_async16(dst + r * stride + c, from, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + r * stride + c + e, from + e, in);
    }
  }
  cp_async_commit();
}

template <int D, int DV, int RM, int BK, int RG>
__global__ void __launch_bounds__(16 * RG, (Cfg<D, DV, RM, BK, RG>::BLOCKS))
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int H, int KH, int S, int window, int causal, float scale,
          int vec) {
  using C = Cfg<D, DV, RM, BK, RG>;
  constexpr int THREADS = C::THREADS;
  constexpr int BQ = C::BQ, KPT = C::KPT, DC = C::DC, VW = C::VW, QS = C::QS, PS = C::PS;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [BQ][QS]  q * scale
  // stage s: K [BK][QS] at K_OFF + s * KV, V [BK][DV] at V_OFF + s * KV

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (latest) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, ty = tid >> 4, tx = tid & 15;
  float* pw = smem + C::P_OFF + warp * BK * PS + RM * (ty & 1);  // [key][this thread's rows]
  const size_t qbase = ((size_t)b * H + h) * (size_t)S * D;
  const float* kb = k + ((size_t)b * KH + kh) * (size_t)S * D;
  const float* vb = v + ((size_t)b * KH + kh) * (size_t)S * DV;

  // the band of kv tiles that meets the block's rows
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? min(q0 + BQ, S) - 1 : S - 1;
  const int t0 = k_first / BK;
  const int n_tiles = k_last / BK - t0 + 1;
  load_tile<D, BK, THREADS>(smem + C::K_OFF, QS, kb, t0 * BK, S, vec);
  if (C::STAGES == 2) load_tile<DV, BK, THREADS>(smem + C::V_OFF, DV, vb, t0 * BK, S, vec);

  for (int i = tid; i < BQ * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = 4 * (i - r * (D / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      const float* from = q + qbase + (size_t)(q0 + r) * D + c;
      x = vec ? ld4(from) : make_float4(from[0], from[1], from[2], from[3]);
      x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
    *reinterpret_cast<float4*>(qs + r * QS + c) = x;
  }

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  // this warp's rows, for its band test
  const int wr0 = q0 + C::WR * warp;
  const int wr_last = min(wr0 + C::WR - 1, S - 1);
  const float* qrow = qs + RM * ty * QS;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = (t0 + j) * BK;
    const int stage = C::STAGES == 2 ? (j & 1) : 0;
    const float* ks = smem + C::K_OFF + stage * C::KV;
    const float* vs = smem + C::V_OFF + stage * C::KV;
    cp_async_wait_all();
    // K tile j (and Q) visible, and V tile j with two stages; every warp is
    // done with tile j - 1
    __syncthreads();
    if (C::STAGES == 1) {
      load_tile<DV, BK, THREADS>(smem + C::V_OFF, DV, vb, k0, S, vec);
    } else if (j + 1 < n_tiles) {  // tile j + 1 into the other stage
      load_tile<D, BK, THREADS>(smem + C::K_OFF + (stage ^ 1) * C::KV, QS, kb, k0 + BK, S, vec);
      load_tile<DV, BK, THREADS>(smem + C::V_OFF + (stage ^ 1) * C::KV, DV, vb, k0 + BK, S,
                                 vec);
    }
    const bool live = wr0 < S && (!causal || k0 <= wr_last) &&
                      !(window > 0 && k0 + BK - 1 <= wr0 - window);
    if (live) {
      // scores of rows RM*ty.. against keys tx + 16jj
      float s[RM][KPT];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        float4 kf[KPT];
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) kf[jj] = ld4(ks + (tx + 16 * jj) * QS + d);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float4 a = ld4(qrow + i * QS + d);
#pragma unroll
          for (int jj = 0; jj < KPT; ++jj) {
            float t = __fmaf_rn(a.x, kf[jj].x, s[i][jj]);
            t = __fmaf_rn(a.y, kf[jj].y, t);
            t = __fmaf_rn(a.z, kf[jj].z, t);
            s[i][jj] = __fmaf_rn(a.w, kf[jj].w, t);
          }
        }
      }

      // the element mask only where the tile crosses the diagonal (when
      // causal), the window's start or the end of S; then the online softmax.
      // A row's 16 key threads are one half warp: xor shuffles over 8..1
      // stay inside it.
      const bool edge = (causal && k0 + BK - 1 > wr0) || k0 + BK > S ||
                        (window > 0 && k0 <= wr_last - window);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int pq = q0 + RM * ty + i;
        float mx = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) {
          if (edge) {
            const int pk = k0 + tx + 16 * jj;
            const bool in = (!causal || pk <= pq) && pk < S && (window <= 0 || pk > pq - window);
            s[i][jj] = in ? s[i][jj] : NEG_INF;
          }
          mx = fmaxf(mx, s[i][jj]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) {
          s[i][jj] = expf(s[i][jj] - m_new);
          sum += s[i][jj];
        }
        l[i] = l[i] * corr + sum;  // this thread's keys; the row's 16 sum at the end
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      }
      // P into the warp's tile: key-major, this thread's RM rows contiguous
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj)
#pragma unroll
        for (int i = 0; i < RM; i += 4)
          *reinterpret_cast<float4*>(pw + (tx + 16 * jj) * PS + i) =
              make_float4(s[i][jj], s[i + 1][jj], s[i + 2][jj], s[i + 3][jj]);
      __syncwarp();
    }
    if (C::STAGES == 1) {
      cp_async_wait_all();
      __syncthreads();  // V tile j visible; every warp is done reading K tile j
      if (j + 1 < n_tiles) load_tile<D, BK, THREADS>(smem + C::K_OFF, QS, kb, k0 + BK, S, vec);
    }
    if (live) {
      // acc[rows][columns] += P . V over the tile's keys
#pragma unroll 8
      for (int c2 = 0; c2 < BK; ++c2) {
        float p[RM];
#pragma unroll
        for (int i = 0; i < RM; i += 4) {
          const float4 t = ld4(pw + c2 * PS + i);
          p[i] = t.x;
          p[i + 1] = t.y;
          p[i + 2] = t.z;
          p[i + 3] = t.w;
        }
        const float* vr = vs + c2 * DV;
#pragma unroll
        for (int cg = 0; cg < DC / VW; ++cg) {
          float x[VW];
          if constexpr (VW == 4) {
            const float4 t = ld4(vr + 4 * tx + 64 * cg);
            x[0] = t.x;
            x[1] = t.y;
            x[2] = t.z;
            x[3] = t.w;
          } else {
            x[0] = vr[tx + 16 * cg];
          }
#pragma unroll
          for (int e = 0; e < VW; ++e)
#pragma unroll
            for (int i = 0; i < RM; ++i)
              acc[i][VW * cg + e] = __fmaf_rn(p[i], x[e], acc[i][VW * cg + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int pq = q0 + RM * ty + i;
    if (pq >= S) continue;
    const float denom = fmaxf(li, 1e-30f);
    float* row = o + ((size_t)b * H + h) * (size_t)S * DV + (size_t)pq * DV;
#pragma unroll
    for (int cg = 0; cg < DC / VW; ++cg)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int col = VW == 4 ? 4 * tx + 64 * cg + e : tx + 16 * cg;
        row[col] = acc[i][VW * cg + e] / denom;
      }
  }
}

template <int D, int DV, int RM, int BK, int RG>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH, int S,
           int window, int causal, float scale, int vec, cudaStream_t stream) {
  using C = Cfg<D, DV, RM, BK, RG>;
  static_assert(C::BYTES <= 232448, "the tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, DV, RM, BK, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  flash_fwd<D, DV, RM, BK, RG><<<grid, C::THREADS, C::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, KH, S, window, causal, scale, vec);
  return (int)cudaGetLastError();
}

// 8 query rows a thread (128-row blocks of 256 threads) and 64-key tiles; 4
// rows at D = 256. The probe's diagnostic builds of other widths ran slower
// (PERF.md). (192, 128) fits one stage (219 KB) at 8 rows.
int dispatch(int D, int DV, const void* q, const void* k, const void* v, void* o, int B, int H,
             int KH, int S, int window, int causal, float scale, int vec, cudaStream_t st) {
  if (D == 16 && DV == 16)
    return launch<16, 16, 8, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  if (D == 32 && DV == 32)
    return launch<32, 32, 8, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  if (D == 64 && DV == 64)
    return launch<64, 64, 8, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  if (D == 96 && DV == 96)
    return launch<96, 96, 8, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  if (D == 112 && DV == 112)
    return launch<112, 112, 8, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  if (D == 128 && DV == 128)
    return launch<128, 128, 8, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  if (D == 256 && DV == 256)
    return launch<256, 256, 4, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  if (D == 96 && DV == 64)  // minicpm3-4b's MLA
    return launch<96, 64, 8, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  if (D == 192 && DV == 128)  // deepseek-v2's MLA
    return launch<192, 128, 8, 64, 16>(q, k, v, o, B, H, KH, S, window, causal, scale, vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's cudaGetLastError() code (0 on success); f32 tensors
// only. D is q's and k's head dim, DV v's and o's; causal is 0 or 1; scale
// multiplies q; vec says that q, k and v are 16-byte aligned. Does not
// synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int KH, int S, int D, int DV, int window,
                                      int causal, float scale, int vec, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || S < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(D, DV, q, k, v, o, B, H, KH, S, window, causal != 0, scale, vec != 0,
                  static_cast<cudaStream_t>(stream));
}
