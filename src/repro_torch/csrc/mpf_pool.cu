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

// ---------------------------------------------------------------------------
// mpf_pool_bwd: the gradient of mpf_pool with respect to x.
//
// No Pallas kernel has a backward: the reference takes this gradient from
// JAX's autodiff of its pool.  The port's forward is hand-written, so its
// backward is too.
//
//   gx[s, c, u] = sum over the fragments o whose window (o, v) holds u and
//                 whose first maximum in tap order lies at u of
//                 gy[s*p^3 + o, c, v]
//
// Ties go to the first maximum in tap order d = (dx*p + dy)*p + dz;
// PyTorch's and JAX's max split a tie's gradient evenly instead, so the
// kernel and the plain version (ref.mpf_pool_bwd) agree bitwise, and the
// plain autograd of ref.mpf_pool agrees only on inputs without ties in a
// window.
//
// Bound on the H100: bytes (x and gy read once, gx written once; no
// arithmetic but compares).
//
// Design.  A block owns one (s, c) and a tile of tx * ty * tz voxels
// (multiples of p along each axis, tx = ty = 8 for p = 2, tz up to 62 and
// as even a cut of nz as p allows), aligned to p.  It stages the tile's x
// with a (p - 1) halo on each side into shared memory once (rows along z,
// eight rows of loads a warp in flight before their stores), and clears a
// gx box of the same extent.  Then, fragment by fragment in the order of
// o, each warp takes rows of that fragment's windows that touch the tile
// (lanes on consecutive vz, so each row's gy reads coalesce), finds each
// window's first maximum once from shared memory, and adds the window's gy
// to the gx box there; a barrier separates the fragments.  The windows of
// one fragment are disjoint, so no two threads add at one voxel, and each
// voxel sums the windows it won in the order of o, as the plain version
// does: no atomics, bitwise equal.  A window across the tile's edge is
// evaluated by every tile it touches; what it adds in the box's halo is
// scratch, so no bounds test.  Last the box's tile is written once,
// coalesced.  Index math inside a tile is 32-bit (a row table gives each
// row's first window).  p = 2, every net's pool in configs/znni_nets.py,
// is a template argument; other p read p at run time.  (Staging gy in
// shared memory as well measured slower on the card, PR 21.)
// kernels/mpf_pool/ref.py:mpf_pool_bwd_tiled replays the tiles on the CPU.
namespace {

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_TXY = 8;    // tile extent along x and y, rounded up to p
constexpr int BWD_TZMAX = 62; // tile extent along z at most, rounded up to p
                              // (32 windows a row for p = 2)

struct BwdTiles {
  int tx, ty, tz, ntx, nty, ntz, rmax;
  size_t smem;
};

BwdTiles bwd_tiles(int nx, int ny, int nz, int p) {
  BwdTiles t;
  t.tx = t.ty = (BWD_TXY + p - 1) / p * p;
  const int cuts = (nz + BWD_TZMAX - 1) / BWD_TZMAX;
  t.tz = ((nz + cuts - 1) / cuts + p - 1) / p * p;
  t.ntx = (nx + t.tx - 1) / t.tx;
  t.nty = (ny + t.ty - 1) / t.ty;
  t.ntz = (nz + t.tz - 1) / t.tz;
  // the rows (vx, vy) of one fragment's windows that touch a tile, at most
  t.rmax = (t.tx / p + 1) * (t.ty / p + 1);
  const size_t box = (size_t)(t.tx + 2 * p - 2) * (t.ty + 2 * p - 2) * (t.tz + 2 * p - 2);
  t.smem = sizeof(float) * (2 * box) + sizeof(int) * 2 * (size_t)p * p * p * t.rmax;
  return t;
}

// P > 0: the pool size at compile time; P == 0: p_rt at run time
template <int P>
__global__ void __launch_bounds__(BWD_THREADS)
mpf_pool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                    float* __restrict__ gx, int f, int nx, int ny, int nz, int p_rt,
                    int mx, int my, int mz, int tx, int ty, int tz, int ntx, int nty,
                    int ntz, int rmax) {
  extern __shared__ float bsm[];
  const int p = P > 0 ? P : p_rt, q = p - 1, p3 = p * p * p;
  const int bx = tx + 2 * q, by = ty + 2 * q, bz = tz + 2 * q, box = bx * by * bz;
  float* xs = bsm;                 // [bx][by][bz]: x from the tile's corner - q
  float* gs = xs + box;            // gx in the same box; its halo is scratch
  int* rows = reinterpret_cast<int*>(gs + box);  // [p^3][rmax]
  int* gyrows = rows + p3 * rmax;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // block -> (z tile, y tile, x tile, s*f + c), z fastest (the grid's
  // size is below 2^31, so 32-bit)
  unsigned blk = blockIdx.x;
  const int zt = (int)(blk % ntz); blk /= ntz;
  const int yt = (int)(blk % nty); blk /= nty;
  const int xt = (int)(blk % ntx);
  const int scb = (int)(blk / ntx);
  const long long sc = scb;
  const long long s = scb / f;
  const int c = scb - (int)s * f;
  const int X0 = xt * tx, Y0 = yt * ty, Z0 = zt * tz;
  const float* xv = x + sc * nx * (long long)ny * nz;

  // on an axis the windows v of fragment offset o that touch the tile
  // [U0, U0 + T) are U0/p - (o > 0) .. U0/p + T/p - 1, within [0, m)
  const int ax0 = X0 / p, ay0 = Y0 / p, az0 = Z0 / p;
  auto windows = [&](int o, int& vx0, int& vy0, int& vz0, int& wx, int& wy, int& wz) {
    vx0 = max(0, ax0 - (o / (p * p) > 0));
    vy0 = max(0, ay0 - ((o / p) % p > 0));
    vz0 = max(0, az0 - (o % p > 0));
    wx = max(0, min(mx, ax0 + tx / p) - vx0);
    wy = max(0, min(my, ay0 + ty / p) - vy0);
    wz = max(0, min(mz, az0 + tz / p) - vz0);
  };

  // x with its halo, eight rows a warp in flight before their stores (zero
  // outside the volume, where no valid window has a tap; bz <= 96)
  {
    constexpr int RB = 8;
    for (int r0 = warp * RB; r0 < bx * by; r0 += BWD_WARPS * RB) {
      float v[RB][3];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int row = r0 + i;
        const int a = row / by, b = row - a * by;
        const int ux = X0 - q + a, uy = Y0 - q + b;
        const bool in = row < bx * by && ux >= 0 && ux < nx && uy >= 0 && uy < ny;
        const float* src = in ? xv + ((long long)ux * ny + uy) * nz : xv;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int e = lane + 32 * k, uz = Z0 - q + e;
          v[i][k] = in && e < bz && uz >= 0 && uz < nz ? __ldg(src + uz) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (r0 + i < bx * by && lane + 32 * k < bz) xs[(r0 + i) * bz + lane + 32 * k] = v[i][k];
    }
  }
  // each fragment's rows of windows: the first window's first tap in the box
  for (int e = tid; e < p3 * rmax; e += BWD_THREADS) {
    const int o = e / rmax, row = e - o * rmax;
    int vx0, vy0, vz0, wx, wy, wz;
    windows(o, vx0, vy0, vz0, wx, wy, wz);
    if (row < wx * wy) {
      const int ix = row / wy, iy = row - ix * wy;
      rows[e] = ((o / (p * p) + p * (vx0 + ix) - X0 + q) * by + (o / p) % p +
                 p * (vy0 + iy) - Y0 + q) * bz + o % p + p * vz0 - Z0 + q;
      gyrows[e] = ((vx0 + ix) * my + vy0 + iy) * mz + vz0;
    }
  }
  for (int e = tid; e < box; e += BWD_THREADS) gs[e] = 0.f;
  __syncthreads();

  const long long m3 = (long long)mx * my * mz;
  // fragment by fragment, in the order of o: a warp takes rows of the
  // fragment's windows, its lanes consecutive vz (several rows a warp when
  // a row holds fewer than 32 windows).  Each window's gy goes to its first
  // maximum's place in the box; where that lies in the halo it is another
  // tile's, and never written out.
  for (int o = 0; o < p3; ++o) {
    int vx0, vy0, vz0, wx, wy, wz;
    windows(o, vx0, vy0, vz0, wx, wy, wz);
    const float* gyo = gy + ((s * p3 + o) * f + c) * m3;
    const int* gro = gyrows + o * rmax;
    const int* ro = rows + o * rmax;
    const int rpw = wz >= 32 || wz == 0 ? 1 : 32 / wz;  // rows a warp takes at once
    const int lr = wz >= 32 || wz == 0 ? 0 : lane / wz;
    const int iz0 = lane - lr * wz, zstep = wz >= 32 ? 32 : wz;
    for (int row = warp * rpw + lr; lr < rpw && row < wx * wy; row += BWD_WARPS * rpw) {
      const int r0 = ro[row];
      const float* grow = gyo + gro[row];
      for (int iz = iz0; iz < wz; iz += zstep) {
        const int w0 = r0 + p * iz;
        float best = xs[w0];
        int at = w0;
        if constexpr (P > 0) {
#pragma unroll
          for (int d = 1; d < P * P * P; ++d) {
            const int t = w0 + (d / (P * P)) * by * bz + ((d / P) % P) * bz + d % P;
            const float v = xs[t];
            if (v > best) {
              best = v;
              at = t;
            }
          }
        } else {
          for (int d = 1; d < p3; ++d) {
            const int t = w0 + (d / (p * p)) * by * bz + ((d / p) % p) * bz + d % p;
            const float v = xs[t];
            if (v > best) {
              best = v;
              at = t;
            }
          }
        }
        gs[at] += grow[iz];
      }
    }
    __syncthreads();
  }

  // the tile's own voxels, written once
  float* gxv = gx + sc * nx * (long long)ny * nz;
  for (int row = warp; row < tx * ty; row += BWD_WARPS) {
    const int a = row / ty, b = row - a * ty;
    const int ux = X0 + a, uy = Y0 + b;
    if (ux >= nx || uy >= ny) continue;
    float* dst = gxv + ((long long)ux * ny + uy) * nz + Z0;
    const float* src = gs + ((a + q) * by + b + q) * bz + q;
    for (int e = lane; e < tz && Z0 + e < nz; e += 32) dst[e] = src[e];
  }
}

template <int P>
int launch_bwd(const float* x, const float* gy, float* gx, int f, int nx, int ny, int nz,
               int p, int mx, int my, int mz, const BwdTiles& t, long long blocks,
               cudaStream_t stream) {
  if (t.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mpf_pool_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
    if (err != cudaSuccess) return (int)err;
  }
  mpf_pool_bwd_kernel<P><<<(unsigned)blocks, BWD_THREADS, t.smem, stream>>>(
      x, gy, gx, f, nx, ny, nz, p, mx, my, mz, t.tx, t.ty, t.tz, t.ntx, t.nty, t.ntz, t.rmax);
  return (int)cudaGetLastError();
}

}  // namespace

// gx (S, f, nx, ny, nz) from x of the same shape and gy (S*p^3, f, mx, my, mz)
extern "C" int mpf_pool_bwd_f32(const float* x, const float* gy, float* gx, int S, int f,
                                int nx, int ny, int nz, int p, int mx, int my, int mz,
                                void* stream) {
  if (p < 1) return (int)cudaErrorInvalidValue;
  if ((long long)S * f * nx * ny * nz <= 0) return (int)cudaGetLastError();
  const BwdTiles t = bwd_tiles(nx, ny, nz, p);
  const long long blocks = (long long)S * f * t.ntx * t.nty * t.ntz;
  if (blocks > 0x7fffffffLL || t.smem > 227 * 1024 || t.tz + 2 * (p - 1) > 96 ||
      (long long)mx * my * mz >= (1LL << 31))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p == 2) return launch_bwd<2>(x, gy, gx, f, nx, ny, nz, p, mx, my, mz, t, blocks, st);
  return launch_bwd<0>(x, gy, gx, f, nx, ny, nz, p, mx, my, mz, t, blocks, st);
}
