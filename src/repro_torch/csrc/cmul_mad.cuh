// The FFT-domain channel MAD shared by cmul_mad.cu and os_segment.cu.
//
//   O[s, j, b] = sum_i X[s, i, b] * W[j, i, b]   (+ nb[j] on the real part of b == 0)
//
// Complex operands are PyTorch complex64 tensors, read interleaved as
// float2 (the TPU kernel's split real/imag planes existed only because
// Pallas has no complex dtype).  For each bin b this is a small complex
// product (S x f) . (f x f'), with bins innermost in memory.
//
// Bound on the H100: it depends on S.  Per bin the MAD does 8*S*f*f'
// flops on 8*(S*f + f*f' + S*f') compulsory bytes; at f = f' = 80 that is
// 11 flop/byte at S = 16 (the reuse path's fft_cached layers: bytes-bound,
// W alone is most of the traffic) and 35-38 at S >= 126 (the dense path's
// layer-2 segments and its S = 128 and 1024 layers: operation-bound).  The
// card's fp32 ridge is ~20 flop/byte (67 TFLOP/s over 3.35 TB/s).
//
// Design: a batched, register-tiled SIMT product that serves both.  A
// block of 128 threads owns BT contiguous bins, TS samples and 16 output
// channels, and walks f in chunks of 4 input channels: X[s-tile, i-chunk,
// bins] and W[j-tile, i-chunk, bins] are copied into shared memory by
// cp.async (16-byte copies of two bins when the bin count is even, 8-byte
// otherwise), in a ring of 4 chunks, so the next chunks' loads are in
// flight while the current one is multiplied.  Each thread keeps a 4 x 8
// tile of complex accumulators (4 samples x 8 channels) for one bin: per
// input channel it reads 12 complex values from shared memory for 32
// complex FMAs, and the lanes of a warp that share a bin read one W value
// by broadcast.
// * Bytes-bound (S <= 16): TS = 16 over 16 bins, so one s-tile covers
//   every sample and each W value is read from device memory exactly once;
//   X is read once per j-tile (f'/16), by neighbouring blocks, so mostly
//   from L2.
// * Operation-bound (S > 16): TS = 32 over 8 bins; the s- and j-tiles of
//   one bin tile run as neighbouring blocks, so W and X re-reads come from
//   L2.
// The j-tile of 16 leaves no empty channel at f' = 80 (a j-tile of 32
// computed 96).  The input-channel sum is the loop over chunks inside the
// block (Hopper blocks run in no order, so the TPU kernel's sequential
// f-chunk grid axis becomes this loop); f, S, f' and the bin count need
// not be multiples of any tile: the copies zero-fill what lies outside and
// the stores are masked.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16, 8 or 4 bytes; when ``pred`` is false nothing is read
// (``src`` is then only a valid address) and the bytes are zero-filled
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async8z(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 8 : 0));
}
__device__ __forceinline__ void cp_async4z(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kMadThreads = 128;
constexpr int kMadRS = 4;      // samples a thread
constexpr int kMadRJ = 8;      // output channels a thread
constexpr int kMadGJ = 2;      // j-groups a block: 16 output channels
constexpr int kMadTJ = kMadGJ * kMadRJ;
constexpr int kMadKC = 4;      // input channels a stage
constexpr int kMadStages = 4;  // cp.async ring depth

// A block: BT bins x GS s-groups x 2 j-groups, one thread each, with no
// register cap (ptxas gives 156-166 registers a thread and no spills:
// three blocks an SM; a cap of 128 spilled and was slower)
template <int BT, int GS>
constexpr int mad_smem_bytes() {
  return kMadStages * kMadKC * (GS * kMadRS + kMadTJ) * BT * 8;
}

template <int BT, int GS, int VEC>
__global__ void __launch_bounds__(kMadThreads)
    cmul_mad_kernel(const float2* __restrict__ X, const float2* __restrict__ W,
                    const float* __restrict__ nb, float2* __restrict__ O, int S,
                    int f, int fp, long long B, int nj, int ns) {
  static_assert(BT * GS * kMadGJ == kMadThreads, "one thread per (bin, s-group, j-group)");
  constexpr int TS = GS * kMadRS, TJ = kMadTJ, GJ = kMadGJ;
  constexpr int XS = kMadKC * TS * BT, WS = kMadKC * TJ * BT;  // stage sizes
  extern __shared__ float4 mad_smem[];
  float2* Xs = reinterpret_cast<float2*>(mad_smem);  // [stage][kc][TS][BT]
  float2* Ws = Xs + kMadStages * XS;                 // [stage][kc][TJ][BT]

  // thread: one bin, samples gs + GS*u and channels gj + GJ*v; the lanes
  // of a warp cover BT bins of neighbouring s-groups and one j-group
  const int tid = threadIdx.x;
  const int bin = tid % BT, g = tid / BT;
  const int gs = g % GS, gj = g / GS;
  // j-tiles fastest, then s-tiles, then bin tiles: blocks sharing an X or
  // a W tile run side by side
  long long blk = blockIdx.x;
  const int j0 = (int)(blk % nj) * TJ;
  blk /= nj;
  const int s0 = (int)(blk % ns) * TS;
  const long long b0 = (blk / ns) * BT;
  const int nk = (f + kMadKC - 1) / kMadKC;

  auto load_stage = [&](int stage, int kc) {
    const int i0 = kc * kMadKC;
    float2* xd = Xs + stage * XS;
    float2* wd = Ws + stage * WS;
    constexpr int VPR = BT / VEC;  // copies a row
    for (int e = tid; e < kMadKC * TS * VPR; e += kMadThreads) {
      const int v = e % VPR, r = e / VPR;
      const int ss = r % TS, kk = r / TS;
      const long long b = b0 + v * VEC;
      const bool ok = s0 + ss < S && i0 + kk < f && b < B;
      const float2* src = ok ? X + ((long long)(s0 + ss) * f + i0 + kk) * B + b : X;
      float2* dst = xd + (kk * TS + ss) * BT + v * VEC;
      if (VEC == 2) cp_async16z(dst, src, ok); else cp_async8z(dst, src, ok);
    }
    for (int e = tid; e < kMadKC * TJ * VPR; e += kMadThreads) {
      const int v = e % VPR, r = e / VPR;
      const int jj = r % TJ, kk = r / TJ;
      const long long b = b0 + v * VEC;
      const bool ok = j0 + jj < fp && i0 + kk < f && b < B;
      const float2* src = ok ? W + ((long long)(j0 + jj) * f + i0 + kk) * B + b : W;
      float2* dst = wd + (kk * TJ + jj) * BT + v * VEC;
      if (VEC == 2) cp_async16z(dst, src, ok); else cp_async8z(dst, src, ok);
    }
  };

  float2 acc[kMadRS][kMadRJ];
#pragma unroll
  for (int u = 0; u < kMadRS; ++u)
#pragma unroll
    for (int v = 0; v < kMadRJ; ++v) acc[u][v] = make_float2(0.f, 0.f);

#pragma unroll
  for (int st = 0; st < kMadStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kMadStages - 2>();  // chunk kc has landed
    __syncthreads();                  // ... for every thread; chunk kc-1 is consumed
    if (kc + kMadStages - 1 < nk)
      load_stage((kc + kMadStages - 1) % kMadStages, kc + kMadStages - 1);
    cp_async_commit();
    const float2* xs = Xs + (kc % kMadStages) * XS;
    const float2* ws = Ws + (kc % kMadStages) * WS;
#pragma unroll
    for (int kk = 0; kk < kMadKC; ++kk) {
      float2 x[kMadRS];
#pragma unroll
      for (int u = 0; u < kMadRS; ++u) x[u] = xs[(kk * TS + gs + GS * u) * BT + bin];
#pragma unroll
      for (int v = 0; v < kMadRJ; ++v) {
        const float2 w = ws[(kk * TJ + gj + GJ * v) * BT + bin];
#pragma unroll
        for (int u = 0; u < kMadRS; ++u) {
          acc[u][v].x = fmaf(x[u].x, w.x, fmaf(-x[u].y, w.y, acc[u][v].x));
          acc[u][v].y = fmaf(x[u].x, w.y, fmaf(x[u].y, w.x, acc[u][v].y));
        }
      }
    }
  }
  cp_async_wait<0>();

  const long long b = b0 + bin;
  if (b >= B) return;
#pragma unroll
  for (int u = 0; u < kMadRS; ++u) {
    const int s = s0 + gs + GS * u;
    if (s >= S) continue;
#pragma unroll
    for (int v = 0; v < kMadRJ; ++v) {
      const int j = j0 + gj + GJ * v;
      if (j >= fp) continue;
      float2 o = acc[u][v];
      // DC-bin bias: b[j] * prod(fft_shape) on the real part of flat bin 0
      if (nb != nullptr && b == 0) o.x += nb[j];
      O[((long long)s * fp + j) * B + b] = o;
    }
  }
}

template <int BT, int GS, int VEC>
cudaError_t launch_mad_tiles(const float2* X, const float2* W, const float* nb,
                             float2* O, int S, int f, int fp, long long B,
                             cudaStream_t stream) {
  constexpr int smem = mad_smem_bytes<BT, GS>();
  const cudaError_t err = cudaFuncSetAttribute(
      cmul_mad_kernel<BT, GS, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nj = (fp + kMadTJ - 1) / kMadTJ, ns = (S + GS * kMadRS - 1) / (GS * kMadRS);
  const long long blocks = ((B + BT - 1) / BT) * nj * ns;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cmul_mad_kernel<BT, GS, VEC><<<(unsigned)blocks, kMadThreads, smem, stream>>>(
      X, W, nb, O, S, f, fp, B, nj, ns);
  return cudaGetLastError();
}

template <int BT, int GS>
cudaError_t launch_mad_vec(const float2* X, const float2* W, const float* nb,
                           float2* O, int S, int f, int fp, long long B,
                           cudaStream_t stream) {
  // 16-byte copies need every row start 16-byte aligned: an even bin count
  // and 16-byte aligned operands
  const bool vec = B % 2 == 0 &&
                   ((reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(W)) & 15) == 0;
  return vec ? launch_mad_tiles<BT, GS, 2>(X, W, nb, O, S, f, fp, B, stream)
             : launch_mad_tiles<BT, GS, 1>(X, W, nb, O, S, f, fp, B, stream);
}

// Launch on ``stream``; returns cudaGetLastError() after the launch.  The
// s-tile follows S: 16 samples over 16 bins up to S = 16 (every sample in
// one s-tile), else 32 over 8 bins; the j-tile is 16 output channels
// (f' = 80 fills five exactly).
inline cudaError_t launch_cmul_mad(const float2* X, const float2* W,
                                   const float* nb, float2* O, int S, int f,
                                   int fp, long long B, cudaStream_t stream) {
  if (S <= 0 || fp <= 0 || B <= 0) return cudaGetLastError();
  if (S <= 16) return launch_mad_vec<16, 4>(X, W, nb, O, S, f, fp, B, stream);
  return launch_mad_vec<8, 8>(X, W, nb, O, S, f, fp, B, stream);
}

}  // namespace
