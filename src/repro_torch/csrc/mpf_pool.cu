// Max-pooling fragments (ZNNi section V).
//
// Replaces the Pallas kernels ``mpf_pool_blocked`` and, through its
// window extents (mx, my, mz), ``mpf_pool_window_blocked`` of
// src/repro/kernels/mpf_pool/kernel.py: for the windowed form the wrapper
// (ops.mpf_pool_window) passes the fragment extents of the window and the
// uncropped input extents, so the crop never materializes.
//
//   out[s*p^3 + o, c, v] = max_{d in [0,p)^3} x[s, c, o + p*v + d]
//   with o = (ox, oy, oz), ox = o / p^2, oy = (o / p) % p, oz = o % p
//
// The output batch order s*p^3 + o is the one recombine_fragments inverts;
// another order gives plausible but wrong dense output.
//
// Bound on the H100: bytes.  No arithmetic but compares; the compulsory
// traffic is the input (the window of it) read once and the output, as
// large as the input, written once.
//
// Design.  On each axis u = o + p*v maps [0, p*m) one-to-one onto the
// pairs (o, v), so the p^3 fragments together are one rearrangement of
// the stride-1 sliding max M[u] = max_d x[u + d] over [0, p*m)^3: every
// input value feeds all the fragments from one load.  A block owns one
// (s, c), a (y, z) tile of M of TILE positions (tz_n columns along z, a
// multiple of 32, by ty_n rows) and a run of up to XC planes along x.  It
// walks its planes in x order, keeping the last p input planes of its tile
// (tile + p - 1 rows and columns) in a ring of p + AHEAD shared-memory
// slots: the next plane is copied in by 4-byte cp.async (rows are not
// 16-byte aligned: nz is odd on the served shapes) while the current one
// is reduced, so every input value is read from device memory once, plus
// the p - 1 halo rows and columns of a tile and the p - 1 planes that
// start a run.  Each thread owns POS positions of the tile, with lanes
// along z: the reads of a position hit consecutive shared-memory words
// across a warp, and the warp's stores land as contiguous runs of the p
// fragment rows that share (ox, oy).  p = 2, the pool of every net in
// configs/znni_nets.py, is a template argument and runs separably: each
// position's 2 x 2 (y, z) max of a plane is taken once and kept in a
// register for the next x step, four shared-memory reads a position and
// plane instead of eight.  Other p read all p^3 values, with p read at run
// time.  fmaxf of finite values is exact, so the result is bitwise the
// plain version's.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int POS = 4;               // positions of M a thread owns per plane
constexpr int TILE = THREADS * POS;  // positions of a (y, z) tile
constexpr int XC = 16;               // planes of M along x a block walks
constexpr int AHEAD = 1;  // input planes in flight past the p reduced

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // every cp.async group but the N newest has landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// P > 0: the pool size at compile time; P == 0: p_rt at run time
template <int P>
__global__ void __launch_bounds__(THREADS)
mpf_pool_kernel(const float* __restrict__ x, float* __restrict__ out, int f,
                int nx, int ny, int nz, int p_rt, int mx, int my, int mz,
                int ty_n, int tz_n, int nxc, int nyt, int nzt) {
  extern __shared__ float ring[];  // [p + AHEAD][ty_n + p - 1][tz_n + p - 1]
  const int p = P > 0 ? P : p_rt;
  const int pitch = tz_n + p - 1;
  const int plane = (ty_n + p - 1) * pitch;
  const int Mx = p * mx, My = p * my, Mz = p * mz;

  // block -> (x run, z tile, y tile, s*f + c), x run fastest: the runs
  // that share a boundary plane are in flight together
  long long blk = blockIdx.x;
  const int xc = (int)(blk % nxc); blk /= nxc;
  const int zt = (int)(blk % nzt); blk /= nzt;
  const int yt = (int)(blk % nyt);
  const long long sc = blk / nyt;
  const long long s = sc / f;
  const int c = (int)(sc % f);
  const int ux0 = xc * XC, ux1 = min(ux0 + XC, Mx);
  const int uy0 = yt * ty_n, uz0 = zt * tz_n;
  const int nrow = min(ty_n, My - uy0) + p - 1;  // input rows and columns
  const int ncol = min(tz_n, Mz - uz0) + p - 1;  // of the tile
  const long long nyz = (long long)ny * nz;
  const float* xin = x + sc * nx * nyz + (long long)uy0 * nz + uz0;

  // output: ((s*p^3 + o)*f + c)*m^3 + v, o = (ox*p + oy)*p + oz
  const long long m3 = (long long)mx * my * mz;
  const long long fr = (long long)f * m3;  // stride of o
  const long long base = (s * p * p * p * f + c) * m3;
  int soff[POS];
  long long ooff[POS];
  bool ok[POS];
#pragma unroll
  for (int k = 0; k < POS; ++k) {
    const int pos = threadIdx.x + k * THREADS;
    const int ty = pos / tz_n, tz = pos - ty * tz_n;
    const int uy = uy0 + ty, uz = uz0 + tz;
    ok[k] = uy < My && uz < Mz;
    soff[k] = ty * pitch + tz;
    ooff[k] = ((uy % p) * p + uz % p) * fr + (long long)(uy / p) * mz + uz / p;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slots = p + AHEAD;
  // input plane xi into ring slot xi % slots, one cp.async group a plane
  // (an empty group past the run's last plane, ux1 + p - 2, keeps the
  // count the wait relies on)
  auto load = [&](int xi) {
    if (xi <= ux1 + p - 2) {
      float* dst = ring + (xi % slots) * plane;
      const float* src = xin + xi * nyz;
      for (int r = warp; r < nrow; r += WARPS)
        for (int col = lane; col < ncol; col += 32)
          cp_async4(dst + r * pitch + col, src + (long long)r * nz + col);
    }
    cp_async_commit();
  };

  float prev[POS];
  for (int i = 0; i < slots - 1; ++i) load(ux0 + i);
  for (int ux = ux0; ux < ux1; ++ux) {
    load(ux + slots - 1);  // into the slot of plane ux - 1
    cp_async_wait<AHEAD>();  // planes up to ux + p - 1 have landed
    __syncthreads();
    const long long obase =
        base + (long long)(ux % p) * p * p * fr + (long long)(ux / p) * my * mz;
#pragma unroll
    for (int k = 0; k < POS; ++k) {
      if (!ok[k]) continue;
      float m;
      if constexpr (P == 2) {
        auto yz = [&](int xi) {  // the (y, z) max of plane xi at position k
          const float* pl = ring + (xi % slots) * plane + soff[k];
          return fmaxf(fmaxf(pl[0], pl[1]), fmaxf(pl[pitch], pl[pitch + 1]));
        };
        if (ux == ux0) prev[k] = yz(ux);
        const float cur = yz(ux + 1);
        m = fmaxf(prev[k], cur);
        prev[k] = cur;
      } else {
        m = ring[(ux % slots) * plane + soff[k]];
        for (int dx = 0; dx < p; ++dx) {
          const float* pl = ring + ((ux + dx) % slots) * plane + soff[k];
          for (int dy = 0; dy < p; ++dy)
            for (int dz = 0; dz < p; ++dz) m = fmaxf(m, pl[dy * pitch + dz]);
        }
      }
      out[obase + ooff[k]] = m;
    }
    __syncthreads();  // the next iteration refills the slot of plane ux
  }
}

template <int P>
int launch(const float* x, float* out, int S, int f, int nx, int ny, int nz, int p,
           int mx, int my, int mz, int ty_n, int tz_n, int nxc, int nyt, int nzt,
           long long blocks, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mpf_pool_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mpf_pool_kernel<P><<<(unsigned)blocks, THREADS, smem, stream>>>(
      x, out, f, nx, ny, nz, p, mx, my, mz, ty_n, tz_n, nxc, nyt, nzt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mpf_pool_f32(const float* x, float* out, int S, int f, int nx,
                            int ny, int nz, int p, int mx, int my, int mz,
                            void* stream) {
  if (p < 1) return (int)cudaErrorInvalidValue;
  if ((long long)S * f * mx * my * mz <= 0) return (int)cudaGetLastError();
  // the z tile: the narrowest multiple of 32 up to 128 that covers p*mz
  const int Mz = p * mz;
  const int tz_n = Mz <= 32 ? 32 : (Mz <= 64 ? 64 : 128);
  const int ty_n = TILE / tz_n;
  const int nxc = (p * mx + XC - 1) / XC;
  const int nyt = (p * my + ty_n - 1) / ty_n;
  const int nzt = (Mz + tz_n - 1) / tz_n;
  const long long blocks = (long long)S * f * nxc * nyt * nzt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (p + AHEAD) * (ty_n + p - 1) * (tz_n + p - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p == 2)
    return launch<2>(x, out, S, f, nx, ny, nz, p, mx, my, mz, ty_n, tz_n, nxc, nyt,
                     nzt, blocks, smem, st);
  return launch<0>(x, out, S, f, nx, ny, nz, p, mx, my, mz, ty_n, tz_n, nxc, nyt,
                   nzt, blocks, smem, st);
}
