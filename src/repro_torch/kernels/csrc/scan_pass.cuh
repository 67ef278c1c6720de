// The middle grid of the RWKV-6 scans' sequence split (the chunked state
// passing of flash-linear-attention), shared by csrc/rwkv6_scan.cu and
// csrc/rwkv6_scan_mma.cu. The first grid runs every segment of the sequence
// but the last from a zero state and stores its end state, E floats a
// segment, and its summed log decay, DP floats a segment (one per key
// channel, or one for the whole state); element e of a state decays by
// exp(decay[e % DP]). This pass replaces the end states, in place, by the
// state entering each segment:
//   S_in[0] = 0,  S_in[s] = exp(ld[s - 1]) S_in[s - 1] + S_end[s - 1]
// A thread per (batch x head, element), serial over the segments. The last
// grid then runs every segment from its S_in and writes y.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void scan_pass_states(float* __restrict__ state,
                                                 const float* __restrict__ decay, long long BH,
                                                 int E, int DP, int nseg) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BH * E) return;
  const long long bh = idx / E, e = idx - bh * E;
  const int d = (int)(e % DP);
  float s = 0.f;
  for (int sg = 0; sg < nseg; ++sg) {
    float* at = state + (bh * nseg + sg) * E + e;
    const float end = sg + 1 < nseg ? *at : 0.f;
    *at = s;
    if (sg + 1 < nseg) s = expf(decay[(bh * nseg + sg) * DP + d]) * s + end;
  }
}
