// Weight gradient of the direct 3D 'valid' cross-correlation.
//
// No Pallas kernel has a backward: the reference trains through
// ``conv3d_blocked`` (src/repro/kernels/direct_conv3d/kernel.py) and takes
// its gradients from JAX's autodiff.  The port's forward conv is
// hand-written (csrc/direct_conv3d.cu), so its gradients are too: the
// input gradient runs through that forward kernel (a full correlation of
// the padded output gradient with the flipped, transposed weights, in
// kernels/direct_conv3d/ops.py), and this file computes
//
//   dw[j, i, dx, dy, dz] = sum_{s, x, y, z} g[s, j, x, y, z]
//                                           * x[s, i, x + dx, y + dy, z + dz]
//
// for g (S, f', n'^3) and x (S, f, n^3), n = n' + k - 1.  A product of
// (f' x R) by (R x f*k^3) with R = S * n'^3 summed over, fp32 FMAs
// outside the tensor cores (TF32 would miss the reference's tolerance).
//
// Bound on the H100: operations at n337's 80 -> 80 layers (layer 2's
// dw is 574 GFLOP, 8.6 ms at 67 TFLOP/s, from 1.2 GB of input); bytes at
// layer 0 (f = 1: 0.6 GB of g for 2.5 GFLOP).
//
// Fixed reduction order, no float atomics.  The R positions are cut into
// C chunks of whole items (an item is one (s, x, TY rows of y) of g); a
// block sums one chunk for one tile of (j, i) into registers, in a fixed
// order, and writes its partial sums to scratch[C][f'][f][k^3]; a second
// kernel adds the C partials of each weight in chunk order.  Every launch
// at the same shapes on the same card cuts the same chunks, so a step is
// bitwise repeatable (a resumed training run equals an uninterrupted one).
//
// Design.  A thread owns JT = 4 output channels, IT = 4 input channels,
// one (dx, dy) and DZ = 3 consecutive dz (kz is covered by ceil(kz / 3)
// thread groups): 48 accumulators.  A block holds JG x IG such threads for
// every tap group, and per item stages the item's g rows (JG*JT channels,
// TY rows, z padded with zeros to a multiple of 8) and the x rows they
// meet (IG*IT channels, kx planes, TY + ky - 1 rows, z padded with zeros)
// in shared memory.  For each 8 z positions a thread loads its IT x rows
// of 8 + 2 values into registers once, then for each of its JT channels
// the 8 g values (two float4 reads, shared by the threads of one channel
// group) and does 96 FMAs: 72 shared-memory reads per 384 FMAs.
// kernels/direct_conv3d/ref.py:conv3d_wgrad_chunked replays this
// decomposition (the plan, the chunks, the tiles, the padding) on the CPU.
#include <cuda_runtime.h>

namespace {

constexpr int JT = 4;  // output channels a thread owns
constexpr int IT = 4;  // input channels a thread owns
constexpr int DZ = 3;  // dz offsets a thread owns
constexpr int ZT = 8;  // z positions a step
constexpr int MAX_THREADS = 256;
constexpr size_t SMEM_MAX = 100 * 1024;  // two blocks an SM

struct WgradPlan {
  int tzg, JG, IG, threads, TY, Zp, XR, gpitch, nyt, jtiles, itiles, C;
  long long items;
  size_t smem;
};

// false when no tile fits (k^2 * ceil(kz / 3) above 256 thread groups, or
// one row of g and x above the shared memory)
bool wgrad_plan(int S, int f, int fp, int kx, int ky, int kz, int npx, int npy, int npz,
                int sms, WgradPlan* p) {
  p->tzg = (kz + DZ - 1) / DZ;
  const int tg = kx * ky * p->tzg;
  if (tg > MAX_THREADS) return false;
  const int budget = MAX_THREADS / tg;
  const int jneed = (fp + JT - 1) / JT, ineed = (f + IT - 1) / IT;
  int root = 1;
  while ((root + 1) * (root + 1) <= budget) ++root;
  p->JG = min(jneed, root);
  p->IG = min(ineed, budget / p->JG);
  p->JG = min(jneed, budget / p->IG);
  p->threads = (p->JG * p->IG * tg + 31) / 32 * 32;
  p->Zp = (npz + ZT - 1) / ZT * ZT;
  p->XR = p->Zp + DZ * p->tzg;
  for (p->TY = min(npy, 8);; --p->TY) {
    p->gpitch = p->TY * p->Zp + 4;  // one channel's rows; spreads the channel groups' banks
    p->smem = sizeof(float) * ((size_t)p->JG * JT * p->gpitch +
                               (size_t)p->IG * IT * kx * (p->TY + ky - 1) * p->XR);
    if (p->smem <= SMEM_MAX) break;
    if (p->TY == 1) return false;
  }
  p->nyt = (npy + p->TY - 1) / p->TY;
  p->items = (long long)S * npx * p->nyt;
  p->jtiles = (fp + p->JG * JT - 1) / (p->JG * JT);
  p->itiles = (f + p->IG * IT - 1) / (p->IG * IT);
  const long long tiles = (long long)p->jtiles * p->itiles;
  if (tiles > 65535) return false;
  // about four blocks an SM in all, and no chunk without an item
  const long long want = (4LL * sms + tiles - 1) / tiles;
  p->C = static_cast<int>(max(1LL, min(want, p->items)));
  return true;
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
conv3d_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ part, int f, int fp, int nx, int ny, int nz,
                    int kx, int ky, int kz, int npx, int npy, int npz, int tzg, int JG,
                    int IG, int TY, int Zp, int XR, int gpitch, int nyt, int jtiles,
                    long long items, int C) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);  // [JG*JT][gpitch]: [TY][Zp] a channel
  const int yrows = TY + ky - 1;
  float* xs = gs + JG * JT * gpitch;  // [IG*IT][kx][yrows][XR]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarp = nthr >> 5;
  const int c = blockIdx.x;
  const int j0 = (blockIdx.y % jtiles) * JG * JT, i0 = (blockIdx.y / jtiles) * IG * IT;
  const int nj = min(JG * JT, fp - j0), ni = min(IG * IT, f - i0);

  // thread -> (i group fastest, j group, dz group, dy, dx)
  int u = tid;
  const int ig = u % IG; u /= IG;
  const int jg = u % JG; u /= JG;
  const int dzc = u % tzg; u /= tzg;
  const int dy = u % ky;
  const int dx = u / ky;
  const bool active = dx < kx;

  float acc[JT][IT][DZ];
#pragma unroll
  for (int a = 0; a < JT; ++a)
#pragma unroll
    for (int b = 0; b < IT; ++b)
#pragma unroll
      for (int d = 0; d < DZ; ++d) acc[a][b][d] = 0.f;

  const long long it0 = items * c / C, it1 = items * (c + 1) / C;
  const long long pvol = (long long)npx * npy * npz, vol = (long long)nx * ny * nz;
  for (long long item = it0; item < it1; ++item) {
    const int tyi = static_cast<int>(item % nyt);
    const long long rest = item / nyt;
    const int px = static_cast<int>(rest % npx);
    const long long s = rest / npx;
    const int py0 = tyi * TY, tyn = min(TY, npy - py0);
    __syncthreads();  // the previous item is done with the tiles
    // g rows (jj, r), z padded with zeros to Zp
    for (int row = warp; row < JG * JT * TY; row += nwarp) {
      const int jj = row / TY, r = row - jj * TY;
      float* dst = gs + jj * gpitch + r * Zp;
      const bool ok = jj < nj && r < tyn;
      const float* src =
          g + (s * fp + j0 + jj) * pvol + ((long long)px * npy + py0 + r) * npz;
      for (int z = lane; z < Zp; z += 32) dst[z] = ok && z < npz ? src[z] : 0.f;
    }
    // x rows (ii, dx, yr), z padded with zeros to XR
    for (int row = warp; row < IG * IT * kx * yrows; row += nwarp) {
      const int yr = row % yrows, q = row / yrows;
      const int ddx = q % kx, ii = q / kx;
      float* dst = xs + row * XR;
      const bool ok = ii < ni && yr < tyn + ky - 1;
      const float* src =
          x + (s * f + i0 + ii) * vol + ((long long)(px + ddx) * ny + py0 + yr) * nz;
      for (int z = lane; z < XR; z += 32) dst[z] = ok && z < nz ? src[z] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < tyn; ++r) {
      const float* grow = gs + jg * JT * gpitch + r * Zp;
      const float* xrow = xs + ((ig * IT * kx + dx) * yrows + r + dy) * XR + dzc * DZ;
      for (int z0 = 0; z0 < Zp; z0 += ZT) {
        float xv[IT][ZT + DZ - 1];
#pragma unroll
        for (int b = 0; b < IT; ++b)
#pragma unroll
          for (int e = 0; e < ZT + DZ - 1; ++e) xv[b][e] = xrow[b * kx * yrows * XR + z0 + e];
#pragma unroll
        for (int a = 0; a < JT; ++a) {
          const float4 g0 = *reinterpret_cast<const float4*>(grow + a * gpitch + z0);
          const float4 g1 = *reinterpret_cast<const float4*>(grow + a * gpitch + z0 + 4);
          const float gv[ZT] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int b = 0; b < IT; ++b)
#pragma unroll
            for (int d = 0; d < DZ; ++d)
#pragma unroll
              for (int e = 0; e < ZT; ++e) acc[a][b][d] = fmaf(gv[e], xv[b][e + d], acc[a][b][d]);
        }
      }
    }
  }

  if (!active) return;
  const int k3 = kx * ky * kz;
  float* out = part + (long long)c * fp * f * k3;
#pragma unroll
  for (int a = 0; a < JT; ++a)
#pragma unroll
    for (int b = 0; b < IT; ++b)
#pragma unroll
      for (int d = 0; d < DZ; ++d) {
        const int j = jg * JT + a, i = ig * IT + b, dz = dzc * DZ + d;
        if (j < nj && i < ni && dz < kz)
          out[(((long long)(j0 + j) * f + i0 + i) * kx + dx) * ky * kz + dy * kz + dz] =
              acc[a][b][d];
      }
}

// dw[e] = sum over the C chunks, in chunk order
__global__ void conv3d_wgrad_reduce(const float* __restrict__ part, float* __restrict__ dw,
                                    long long E, int C) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += part[(long long)c * E + e];
  dw[e] = s;
}

bool plan_for(int S, int f, int fp, int kx, int ky, int kz, int npx, int npy, int npz,
              WgradPlan* p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  return wgrad_plan(S, f, fp, kx, ky, kz, npx, npy, npz, sms, p);
}

}  // namespace

// The chunks C of the partial sums (the wrapper allocates C * f' * f * k^3
// floats of scratch), or -1 when no tile fits
extern "C" int conv3d_wgrad_chunks(int S, int f, int fp, int nx, int ny, int nz, int kx,
                                   int ky, int kz) {
  WgradPlan p;
  if (!plan_for(S, f, fp, kx, ky, kz, nx - kx + 1, ny - ky + 1, nz - kz + 1, &p)) return -1;
  return p.C;
}

// x (S, f, n^3), g (S, f', n'^3), part (C, f', f, k^3) scratch, dw (f', f, k^3)
extern "C" int conv3d_wgrad_f32(const float* x, const float* g, float* part, float* dw,
                                int S, int f, int fp, int nx, int ny, int nz, int kx, int ky,
                                int kz, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npx = nx - kx + 1, npy = ny - ky + 1, npz = nz - kz + 1;
  if (S <= 0 || f <= 0 || fp <= 0 || npx <= 0 || npy <= 0 || npz <= 0)
    return (int)cudaErrorInvalidValue;
  WgradPlan p;
  if (!plan_for(S, f, fp, kx, ky, kz, npx, npy, npz, &p) || p.C != C)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  conv3d_wgrad_kernel<<<dim3((unsigned)p.C, (unsigned)(p.jtiles * p.itiles)), p.threads,
                        p.smem, st>>>(x, g, part, f, fp, nx, ny, nz, kx, ky, kz, npx, npy,
                                      npz, p.tzg, p.JG, p.IG, p.TY, p.Zp, p.XR, p.gpitch,
                                      p.nyt, p.jtiles, p.items, p.C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long E = (long long)fp * f * kx * ky * kz;
  conv3d_wgrad_reduce<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(part, dw, E, C);
  return (int)cudaGetLastError();
}
