// Direct 3D 'valid' cross-correlation (ZNNi's direct conv primitive).
//
// Replaces the Pallas kernel ``conv3d_blocked`` of
// src/repro/kernels/direct_conv3d/kernel.py:
//
//   out[s, j, x, y, z] = sum_{i, dx, dy, dz} w[j, i, dx, dy, dz]
//                                           * x[s, i, x + dx, y + dy, z + dz]
//
// The TPU kernel runs the k^3 offsets as (f'_blk x f) @ (f x tile) MXU
// matmuls with f' padded to FP_BLOCK = 8.  Here every product is an fp32
// FMA outside the tensor cores (TF32 would miss the reference tolerance of
// atol 1e-3 / rtol 1e-4), and f' is not padded: n337's last layer has
// f' = 3, where padding to 8 would waste 2.7x of the work.
//
// What bounds it on the H100: bytes, at both of n337's call sites, which
// are opposite regimes.  Layer 0 (f = 1, f' = 80, k = 2) writes ~2 GB of
// output from a 26 MB input: the output write bounds it.  The last layer
// (f = 80, f' = 3, k = 3) reads ~0.33 GB and writes 6 MB: the input read
// bounds it.  The operations (~8 GFLOP) are a tenth of either.
//
// Design: one block per (sample, x-tile of RX output rows, y-tile, z-tile)
// and f' tile of FPT output channels.  Threads lie along z (neighbouring
// threads on neighbouring addresses, for the input loads and the output
// stores) and y; each keeps an RX x FPT register tile of accumulators.
// For each input channel the block stages its input tile with the (k-1)
// halo and the f' tile's k^3 weights in shared memory, then every weight
// loaded into registers is applied to RX input values.  FPT is 1, 2, 3
// or 4 when f' is at most 4, else 8, so no channel is computed and thrown
// away except in a ragged last f' tile.
#include <cuda_runtime.h>

namespace {

constexpr int kRX = 4;  // output x-rows per thread

template <int FPT>
__global__ void conv3d_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              float* __restrict__ out, int f, int fp, int nx,
                              int ny, int nz, int kx, int ky, int kz, int npx,
                              int npy, int npz, int tiles_x, int tiles_y,
                              int tiles_z) {
  extern __shared__ float smem[];
  const int TZ = blockDim.x, TY = blockDim.y;
  const int hx = kRX + kx - 1, hy = TY + ky - 1, hz = TZ + kz - 1;
  const int k3 = kx * ky * kz;
  float* tile = smem;                // hx * hy * hz input values
  float* ws = smem + hx * hy * hz;   // FPT * k3 weights
  long long b = blockIdx.x;
  const int tzi = (int)(b % tiles_z); b /= tiles_z;
  const int tyi = (int)(b % tiles_y); b /= tiles_y;
  const int txi = (int)(b % tiles_x);
  const long long s = b / tiles_x;
  const int j0 = blockIdx.y * FPT;
  const int nj = min(FPT, fp - j0);
  const int x0 = txi * kRX, y0 = tyi * TY, z0 = tzi * TZ;
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TZ + tz, nthr = TZ * TY;
  const int n_tile = hx * hy * hz;
  const long long plane = (long long)nx * ny * nz;

  float acc[kRX][FPT];
#pragma unroll
  for (int r = 0; r < kRX; ++r)
#pragma unroll
    for (int j = 0; j < FPT; ++j) acc[r][j] = 0.f;

  for (int i = 0; i < f; ++i) {
    const float* xi = x + (s * f + i) * plane;
    for (int e = tid; e < n_tile; e += nthr) {
      const int zz = e % hz;
      const int t = e / hz;
      const int yy = t % hy, xx = t / hy;
      const int gx = x0 + xx, gy = y0 + yy, gz = z0 + zz;
      tile[e] = (gx < nx && gy < ny && gz < nz)
                    ? xi[((long long)gx * ny + gy) * nz + gz]
                    : 0.f;
    }
    for (int e = tid; e < FPT * k3; e += nthr) {
      const int j = e / k3, r = e % k3;
      ws[e] = j < nj ? w[((long long)(j0 + j) * f + i) * k3 + r] : 0.f;
    }
    __syncthreads();
    for (int dx = 0; dx < kx; ++dx)
      for (int dy = 0; dy < ky; ++dy)
        for (int dz = 0; dz < kz; ++dz) {
          const int r = (dx * ky + dy) * kz + dz;
          float wv[FPT];
#pragma unroll
          for (int j = 0; j < FPT; ++j) wv[j] = ws[j * k3 + r];
#pragma unroll
          for (int rx = 0; rx < kRX; ++rx) {
            const float v = tile[((rx + dx) * hy + ty + dy) * hz + tz + dz];
#pragma unroll
            for (int j = 0; j < FPT; ++j) acc[rx][j] = fmaf(wv[j], v, acc[rx][j]);
          }
        }
    __syncthreads();
  }

  const int oy = y0 + ty, oz = z0 + tz;
  if (oy >= npy || oz >= npz) return;
#pragma unroll
  for (int rx = 0; rx < kRX; ++rx) {
    const int ox = x0 + rx;
    if (ox >= npx) break;
#pragma unroll
    for (int j = 0; j < FPT; ++j) {
      if (j < nj)
        out[(((s * fp + j0 + j) * npx + ox) * (long long)npy + oy) * npz + oz] =
            acc[rx][j];
    }
  }
}

int pow2_at_least(int n, int cap) {
  int p = 1;
  while (p < n && p < cap) p *= 2;
  return p;
}

template <int FPT>
cudaError_t launch(const float* x, const float* w, float* out, int S, int f,
                   int fp, int nx, int ny, int nz, int kx, int ky, int kz,
                   cudaStream_t stream) {
  const int npx = nx - kx + 1, npy = ny - ky + 1, npz = nz - kz + 1;
  const int TZ = pow2_at_least(npz, 32);
  const int TY = pow2_at_least(npy, 256 / TZ);
  const int tiles_x = (npx + kRX - 1) / kRX;
  const int tiles_y = (npy + TY - 1) / TY;
  const int tiles_z = (npz + TZ - 1) / TZ;
  const size_t smem = sizeof(float) *
      ((size_t)(kRX + kx - 1) * (TY + ky - 1) * (TZ + kz - 1) +
       (size_t)FPT * kx * ky * kz);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3d_kernel<FPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)S * tiles_x * tiles_y * tiles_z;
  dim3 grid((unsigned)blocks, (unsigned)((fp + FPT - 1) / FPT));
  conv3d_kernel<FPT><<<grid, dim3(TZ, TY), smem, stream>>>(
      x, w, out, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz, tiles_x,
      tiles_y, tiles_z);
  return cudaGetLastError();
}

}  // namespace

extern "C" int conv3d_f32(const float* x, const float* w, float* out, int S,
                          int f, int fp, int nx, int ny, int nz, int kx,
                          int ky, int kz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || fp <= 0) return (int)cudaGetLastError();
  switch (fp) {
    case 1: return (int)launch<1>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, st);
    case 2: return (int)launch<2>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, st);
    case 3: return (int)launch<3>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, st);
    case 4: return (int)launch<4>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, st);
    default: return (int)launch<8>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, st);
  }
}
