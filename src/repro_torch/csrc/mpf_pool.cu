// Max-pooling fragments (ZNNi section V).
//
// Replaces the Pallas kernel ``mpf_pool_blocked`` of
// src/repro/kernels/mpf_pool/kernel.py, and through its window extents
// (mx, my, mz) also covers ``mpf_pool_window_blocked``: the fragment
// extents come from the window, not from the input shape.
//
//   out[s*p^3 + o, c, v] = max_{d in [0,p)^3} x[s, c, o + p*v + d]
//   with o = (ox, oy, oz), ox = o / p^2, oy = (o / p) % p, oz = o % p
//
// The output batch order s*p^3 + o is the one recombine_fragments inverts;
// another order gives plausible but wrong dense output.
//
// Bound on the H100: bytes.  No arithmetic but compares; the input is
// read once from device memory (the p^3 fragments re-read it from L1/L2)
// and the output, which is as large as the input, written once.
//
// Design: one thread per output element, neighbouring threads on
// neighbouring z outputs.  The TPU kernel's channel padding to F_BLOCK=8
// was a tiling constraint of that chip and is gone.
#include <cuda_runtime.h>

namespace {

__global__ void mpf_pool_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int S, int f, int nx,
                                int ny, int nz, int p, int mx, int my,
                                int mz) {
  const long long P3 = (long long)p * p * p;
  const long long total = (long long)S * P3 * f * mx * my * mz;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    long long t = idx;
    const int vz = (int)(t % mz); t /= mz;
    const int vy = (int)(t % my); t /= my;
    const int vx = (int)(t % mx); t /= mx;
    const int c = (int)(t % f); t /= f;
    const int o = (int)(t % P3);
    const long long s = t / P3;
    const int ox = o / (p * p), oy = (o / p) % p, oz = o % p;
    const float* src = x + ((s * f + c) * nx + (ox + p * vx)) * (long long)ny * nz
                       + (long long)(oy + p * vy) * nz + (oz + p * vz);
    float m = src[0];
    for (int dx = 0; dx < p; ++dx)
      for (int dy = 0; dy < p; ++dy)
        for (int dz = 0; dz < p; ++dz)
          m = fmaxf(m, src[((long long)dx * ny + dy) * nz + dz]);
    out[idx] = m;
  }
}

}  // namespace

extern "C" int mpf_pool_f32(const float* x, float* out, int S, int f, int nx,
                            int ny, int nz, int p, int mx, int my, int mz,
                            void* stream) {
  const long long total = (long long)S * p * p * p * f * mx * my * mz;
  if (total <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  mpf_pool_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, out, S, f, nx, ny, nz, p, mx, my, mz);
  return (int)cudaGetLastError();
}
