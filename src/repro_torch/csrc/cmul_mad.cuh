// The FFT-domain channel MAD shared by cmul_mad.cu and os_segment.cu.
//
//   O[s, j, b] = sum_i X[s, i, b] * W[j, i, b]   (+ nb[j] on the real part of b == 0)
//
// Complex operands are PyTorch complex64 tensors, read interleaved as
// float2 (the TPU kernel's split real/imag planes existed only because
// Pallas has no complex dtype).
//
// Bound on the H100: bytes.  Each bin does 8 flops per (i, j) pair and
// reads one X and one W value per pair, far below the ~20 flop/byte the
// card needs to be compute bound in fp32.
//
// Design: one thread per bin (neighbouring threads on neighbouring bins,
// so every load is coalesced), a tile of TJ output channels per block,
// and the input-channel sum carried in registers by a loop inside the
// thread — Hopper blocks run in no order, so the TPU kernel's sequential
// f-chunk grid axis becomes this loop.  The batch S is also walked inside
// the block in tiles of TS samples, so one W value loaded into registers
// serves TS samples; a grid z axis splits S only when the bin x channel
// grid alone is too small to fill the card.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMadThreads = 256;
constexpr int kMadTJ = 8;  // output channels per block
constexpr int kMadTS = 4;  // samples per register tile

template <int TJ, int TS>
__global__ void cmul_mad_kernel(const float2* __restrict__ X,
                                const float2* __restrict__ W,
                                const float* __restrict__ nb,
                                float2* __restrict__ O, int S, int f, int fp,
                                long long B, int s_chunk) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int j0 = blockIdx.y * TJ;
  const int s_begin = blockIdx.z * s_chunk;
  const int s_end = min(S, s_begin + s_chunk);
  for (int s0 = s_begin; s0 < s_end; s0 += TS) {
    float2 acc[TS][TJ];
#pragma unroll
    for (int ss = 0; ss < TS; ++ss)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) acc[ss][jj] = make_float2(0.f, 0.f);
    for (int i = 0; i < f; ++i) {
      float2 w[TJ];
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj)
        w[jj] = (j0 + jj < fp) ? W[((long long)(j0 + jj) * f + i) * B + b]
                               : make_float2(0.f, 0.f);
#pragma unroll
      for (int ss = 0; ss < TS; ++ss) {
        if (s0 + ss < s_end) {
          const float2 x = X[((long long)(s0 + ss) * f + i) * B + b];
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj) {
            acc[ss][jj].x = fmaf(x.x, w[jj].x, fmaf(-x.y, w[jj].y, acc[ss][jj].x));
            acc[ss][jj].y = fmaf(x.x, w[jj].y, fmaf(x.y, w[jj].x, acc[ss][jj].y));
          }
        }
      }
    }
#pragma unroll
    for (int ss = 0; ss < TS; ++ss) {
      if (s0 + ss >= s_end) continue;
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const int j = j0 + jj;
        if (j >= fp) continue;
        float2 o = acc[ss][jj];
        // DC-bin bias: b[j] * prod(fft_shape) on the real part of flat bin 0
        if (nb != nullptr && b == 0) o.x += nb[j];
        O[((long long)(s0 + ss) * fp + j) * B + b] = o;
      }
    }
  }
}

// Launch on ``stream``; returns cudaGetLastError() after the launch.
inline cudaError_t launch_cmul_mad(const float2* X, const float2* W,
                                   const float* nb, float2* O, int S, int f,
                                   int fp, long long B, cudaStream_t stream) {
  if (S <= 0 || fp <= 0 || B <= 0) return cudaGetLastError();
  dim3 grid((unsigned)((B + kMadThreads - 1) / kMadThreads),
            (unsigned)((fp + kMadTJ - 1) / kMadTJ), 1);
  // split S over grid z only as far as needed for ~1024 blocks in flight
  const long long blocks_xy = (long long)grid.x * grid.y;
  const int s_tiles = (S + kMadTS - 1) / kMadTS;
  long long nz = (1024 + blocks_xy - 1) / blocks_xy;
  if (nz > s_tiles) nz = s_tiles;
  if (nz < 1) nz = 1;
  const int s_chunk = (int)((s_tiles + nz - 1) / nz) * kMadTS;
  grid.z = (unsigned)((S + s_chunk - 1) / s_chunk);
  cmul_mad_kernel<kMadTJ, kMadTS><<<grid, kMadThreads, 0, stream>>>(
      X, W, nb, O, S, f, fp, B, s_chunk);
  return cudaGetLastError();
}

}  // namespace
