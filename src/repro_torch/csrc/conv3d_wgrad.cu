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
// for g (S, f', n'^3) and x (S, f, n^3), n = n' + k - 1: a GEMM of
// M = f*k^3 rows (i, dx, dy, dz) of an implicit im2col of x, N = f'
// columns j of g, and K = S*n'^3 output positions summed over.
//
// Bound on the H100: operations at n337's 80 -> 80 layers (layer 2's dw is
// 574 GFLOP: 8.6 ms at 67 TFLOP/s fp32, 3.5 ms as 3xTF32 at 495 TFLOP/s);
// bytes at layer 0 (f = 1: 0.6 GB of g for 2.5 GFLOP) and at the last
// layer (f' = 3: 21 MB of x).
//
// Tensor cores at fp32 accuracy (3xTF32).  Products run as
// mma.sync.m16n8k8 TF32 with A from x and B from g.  Each operand a is
// split into hi = tf32(a) and lo = tf32(a - hi) (cvt.rna, round to nearest,
// ties away from zero), and each k-step accumulates a_lo*b_hi, then
// a_hi*b_lo, then a_hi*b_hi in fp32: the dropped a_lo*b_lo is 2^-22 of
// the product, where TF32 alone keeps 2^-11.  The tensor cores' fp32 sum
// truncates, so a block sums each item (at most 256 positions, 96 mma a
// fragment) in fresh accumulators and adds the item's sums into running
// totals with fp32 adds that round to nearest.
//
// Design.  An item is TY output rows of one (s, x) plane, or TX whole
// planes of one s; its positions flattened, K of them, padded with zeros
// to a multiple of 8.  A block of 8 warps owns a tile of BM rows (BM = 128
// or 256: 2 m16 tiles a warp) and BN columns (8, 16, 40 or 80, the
// narrowest that covers f' and leaves room for an item; 80 = n337's f' in
// 10 n8 tiles) and walks its
// chunk's items in order, staging each item by 4-byte cp.async (rows of g
// and x start at any float: n' and n are odd on n337's shapes) into one of
// two shared-memory stages while the other is computed: g's rows of the
// item for the block's columns (pitch = 4 mod 8 floats, so a B fragment's
// 32 lanes hit 32 banks) and x's rows for the channels the block's rows
// span, with the kx - 1 planes and ky - 1 rows beyond the item (row pitch
// chosen so the 8 rows of an A fragment's taps fall on distinct banks).
// The A fragment of row m = (i, dx, dy, dz) at position k is read from the
// x stage at rowoff(m) + koff(k): the im2col exists only as these two
// offset tables (rowoff in registers, koff in shared memory).  Rows beyond
// f*k^3 and positions beyond K read a valid, zero-filled address and are
// never stored.
//
// Fixed reduction order, no float atomics.  The items are cut into C
// chunks; the plan depends only on the shapes and the SM count.  A block
// sums one chunk for one tile in a fixed order and writes its partial sums
// to scratch[C][f'][f*k^3]; conv3d_wgrad_reduce adds the C partials of
// each weight in chunk order.  Every launch at the same shapes on the
// same card cuts the same chunks and issues the same mma sequence, so a
// step is bitwise repeatable (a resumed training run equals an
// uninterrupted one).  kernels/direct_conv3d/ref.py:conv3d_wgrad_mma
// replays this decomposition (the plan, the chunks, the tiles, the stages'
// offset tables and the 3xTF32 split) on the CPU.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MW = 2;         // m16 tiles a warp owns
constexpr int KMAX = 256;     // positions an item holds at most
constexpr size_t SMEM_MAX = 110 * 1024;  // two blocks an SM

struct WgradPlan {
  int NW, WN, BM, BN, mtiles, ntiles, CI, XP, TY, TX, KI, KP, GP, nyg, nxg, C;
  long long items;
  size_t smem;
};

// the x stage's row pitch: at least nz, and no multiple of it (1x or 2x,
// the rows an A fragment's 8 taps step over) within 5 of a multiple of 32
int x_pitch(int nz) {
  auto near = [](int v) {
    const int r = v % 32;
    return r < 6 || r > 26;
  };
  int p = nz;
  while (near(p) || near(2 * p)) ++p;
  return p;
}

// false when no item fits the shared memory or the grid is too large
bool wgrad_plan(int S, int f, int fp, int kx, int ky, int kz, int npx, int npy, int npz,
                int sms, WgradPlan* p) {
  const long long k3 = (long long)kx * ky * kz, M = f * k3;
  if (M >= (1LL << 31)) return false;
  const int nz = npz + kz - 1;
  p->XP = x_pitch(nz);
  // output-channel tiles of 8, 16, 40 or 80 columns (NW n8 tiles a warp,
  // WN warps across): the narrowest that covers f', or a narrower one when
  // no item fits beside the wider (rows of g longer than ~250 positions)
  constexpr int NW[4] = {1, 2, 5, 5}, WN[4] = {1, 1, 1, 2};
  int best = 0;
  for (int t = fp <= 8 ? 0 : fp <= 16 ? 1 : fp <= 40 ? 2 : 3; t >= 0 && best == 0; --t) {
    p->NW = NW[t];
    p->WN = WN[t];
    p->BN = 8 * p->NW * p->WN;
    p->BM = 16 * MW * (WARPS / p->WN);
    p->CI = (int)std::min<long long>(f, (p->BM - 1) / k3 + 2);
    // the largest item (TY rows, or TX whole planes) of at most KMAX
    // positions (or one row) whose two stages fit
    for (int ty = 1; ty <= npy; ++ty) {
      for (int tx = 1; tx <= (ty == npy ? npx : 1); ++tx) {
        const int ki = tx * ty * npz;
        if (ki > KMAX && ki > npz) break;
        const int kp = (ki + 7) / 8 * 8, gp = kp + 4;
        const size_t floats = (size_t)p->BN * gp +
                              (size_t)p->CI * (tx + kx - 1) * (ty + ky - 1) * p->XP;
        const size_t smem = sizeof(float) * 2 * floats + sizeof(int) * kp;
        if (smem > SMEM_MAX) break;
        if (ki > best) {
          best = ki;
          p->TY = ty; p->TX = tx; p->KI = ki; p->KP = kp; p->GP = gp; p->smem = smem;
        }
      }
    }
  }
  if (best == 0) return false;
  p->mtiles = (int)((M + p->BM - 1) / p->BM);
  p->ntiles = (fp + p->BN - 1) / p->BN;
  p->nyg = (npy + p->TY - 1) / p->TY;
  p->nxg = (npx + p->TX - 1) / p->TX;
  p->items = (long long)S * p->nxg * p->nyg;
  const long long tiles = (long long)p->mtiles * p->ntiles;
  if (tiles > 65535) return false;
  // one wave of two blocks an SM, and no chunk without an item
  p->C = (int)std::max(1LL, std::min((long long)(2 * sms) / tiles, p->items));
  return true;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// hi = cvt.rna.tf32.f32(v); lo = the same rounding of v - hi (finite
// whenever v is), done as an integer add and mask: bitwise what cvt.rna
// gives a finite value, at the integer units' rate (lo by cvt too took
// 28.9 against 28.1 ms at layer 2 in chip_smoke's kernel lines, PR 21; cvt
// keeps hi's inf and nan)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}
// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, fp32 out
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NW n8 tiles a warp, WN warps along N (8 / WN along M)
template <int NW, int WN>
__global__ void __launch_bounds__(THREADS, 2)
conv3d_wgrad_mma(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ part, int f, int fp, int nx, int ny, int nz, int kx,
                 int ky, int kz, int npx, int npy, int npz, int mtiles, int CI, int XP,
                 int TY, int TX, int KI, int KP, int GP, int nyg, int nxg, long long items,
                 int C) {
  constexpr int WM = WARPS / WN, BN = 8 * NW * WN, BM = 16 * MW * WM;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int k3 = kx * ky * kz, M = f * k3;
  const int yrows = TY + ky - 1, planes = TX + kx - 1;
  const int PS = yrows * XP, CS = planes * PS;  // x stage: [CI][planes][yrows][XP]
  const int GSZ = BN * GP, STAGE = GSZ + CI * CS;  // a stage: g [BN][GP], then x
  int* ktab = reinterpret_cast<int*>(sm + 2 * STAGE);  // [KP]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int c = blockIdx.x;
  const int mt = blockIdx.y % mtiles, nt = blockIdx.y / mtiles;
  const int m0 = mt * BM, j0 = nt * BN;
  const int ilo = m0 / k3;
  const int nj = min(BN, fp - j0), ni = min(CI, f - ilo);

  // koff: position -> offset in the x stage (0 for the padding)
  for (int kk = tid; kk < KP; kk += THREADS) {
    int off = 0;
    if (kk < KI) {
      const int z = kk % npz, r = kk / npz;
      off = (r / TY) * PS + (r % TY) * XP + z;
    }
    ktab[kk] = off;
  }
  // the padding positions [KI, KP) of g stay zero
  for (int e = tid; e < 2 * BN * (KP - KI); e += THREADS) {
    const int st = e / (BN * (KP - KI)), r = e % (BN * (KP - KI));
    sm[st * STAGE + (r / (KP - KI)) * GP + KI + r % (KP - KI)] = 0.f;
  }

  // this lane's A rows: groupID and groupID + 8 of each of its m16 tiles
  int roff[MW][2];
#pragma unroll
  for (int u = 0; u < MW; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (wm * MW + u) * 16 + grp + 8 * h;
      int off = 0;
      if (m < M) {
        const int i = m / k3, t = m - i * k3;
        const int dz = t % kz, q = t / kz;
        off = (i - ilo) * CS + (q / ky) * PS + (q % ky) * XP + dz;
      }
      roff[u][h] = off;
    }
  const int mw0 = m0 + wm * MW * 16, nw0 = wn * NW * 8;  // the warp's tile
  bool mlive[MW], nlive[NW];
#pragma unroll
  for (int u = 0; u < MW; ++u) mlive[u] = mw0 + u * 16 < M;
#pragma unroll
  for (int t = 0; t < NW; ++t) nlive[t] = nw0 + t * 8 < nj;
  bool all_live = true;
#pragma unroll
  for (int u = 0; u < MW; ++u) all_live = all_live && mlive[u];
#pragma unroll
  for (int t = 0; t < NW; ++t) all_live = all_live && nlive[t];

  // item -> stage st: g rows (j, plane) of TY*npz positions, x rows
  // (channel, plane, row) of nz; what lies outside the volume is zero
  const long long pvol = (long long)npx * npy * npz, vol = (long long)nx * ny * nz;
  auto load = [&](long long item, int st) {
    const int yg = (int)(item % nyg);
    const long long r = item / nyg;
    const int xg = (int)(r % nxg);
    const long long s = r / nxg;
    const int py0 = yg * TY, px0 = xg * TX;
    const int tyn = min(TY, npy - py0), txn = min(TX, npx - px0);
    float* gs = sm + st * STAGE;
    float* xs = gs + GSZ;
    const int glen = TY * npz, gval = tyn * npz;
    for (int row = warp; row < BN * TX; row += WARPS) {
      const int jj = row / TX, xl = row - jj * TX;
      const bool ok = jj < nj && xl < txn;
      const float* src = ok ? g + (s * fp + j0 + jj) * pvol +
                                  ((long long)(px0 + xl) * npy + py0) * npz
                            : g;
      float* dst = gs + jj * GP + xl * glen;
      for (int e = lane; e < glen; e += 32) cp_async4(dst + e, ok ? src + e : g, ok && e < gval);
    }
    const int xr = planes * yrows;
    for (int row = warp; row < CI * xr; row += WARPS) {
      const int ii = row / xr, q = row - ii * xr;
      const int pl = q / yrows, yr = q - pl * yrows;
      const bool ok = ii < ni && pl < txn + kx - 1 && yr < tyn + ky - 1;
      const float* src = ok ? x + (s * f + ilo + ii) * vol +
                                  ((long long)(px0 + pl) * ny + py0 + yr) * nz
                            : x;
      float* dst = xs + ii * CS + pl * PS + yr * XP;
      for (int z = lane; z < nz; z += 32) cp_async4(dst + z, ok ? src + z : x, ok);
    }
    cp_async_commit();
  };

  float tot[MW][NW][4];
#pragma unroll
  for (int u = 0; u < MW; ++u)
#pragma unroll
    for (int t = 0; t < NW; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[u][t][e] = 0.f;

  const long long it0 = items * c / C, it1 = items * (c + 1) / C;
  if (it0 < it1) load(it0, 0);
  for (long long item = it0; item < it1; ++item) {
    const int st = (int)((item - it0) & 1);
    if (item + 1 < it1)
      load(item + 1, st ^ 1);
    else
      cp_async_commit();  // an empty group keeps the wait's count
    cp_async_wait1();
    __syncthreads();
    const float* gs = sm + st * STAGE + (nw0 + grp) * GP + tig;
    const float* xs = sm + st * STAGE + GSZ;
    float acc[MW][NW][4];
#pragma unroll
    for (int u = 0; u < MW; ++u)
#pragma unroll
      for (int t = 0; t < NW; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][t][e] = 0.f;
    // one k-step: 8 positions; ALL: every tile of the warp holds live rows
    // and columns (the checks leave the unrolled loop then)
    auto kstep = [&](int kb, auto all) {
      const int k0 = ktab[kb + tig], k1 = ktab[kb + tig + 4];
      uint32_t ah[MW][4], al[MW][4];
#pragma unroll
      for (int u = 0; u < MW; ++u) {
        split(xs[roff[u][0] + k0], ah[u][0], al[u][0]);
        split(xs[roff[u][1] + k0], ah[u][1], al[u][1]);
        split(xs[roff[u][0] + k1], ah[u][2], al[u][2]);
        split(xs[roff[u][1] + k1], ah[u][3], al[u][3]);
      }
#pragma unroll
      for (int t = 0; t < NW; ++t) {
        if (!decltype(all)::value && !nlive[t]) continue;
        uint32_t bh0, bl0, bh1, bl1;
        split(gs[t * 8 * GP + kb], bh0, bl0);
        split(gs[t * 8 * GP + kb + 4], bh1, bl1);
#pragma unroll
        for (int u = 0; u < MW; ++u) {
          if (!decltype(all)::value && !mlive[u]) continue;
          mma(acc[u][t], al[u], bh0, bh1);
          mma(acc[u][t], ah[u], bl0, bl1);
          mma(acc[u][t], ah[u], bh0, bh1);
        }
      }
    };
    if (all_live)
      for (int kb = 0; kb < KP; kb += 8) kstep(kb, std::true_type{});
    else
      for (int kb = 0; kb < KP; kb += 8) kstep(kb, std::false_type{});
#pragma unroll
    for (int u = 0; u < MW; ++u)
#pragma unroll
      for (int t = 0; t < NW; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[u][t][e] += acc[u][t][e];
    __syncthreads();  // the stage is free for the item after next
  }

  // C fragment: (row grp, cols 2*tig, 2*tig + 1), then row grp + 8
  float* out = part + (long long)c * fp * M;
#pragma unroll
  for (int u = 0; u < MW; ++u)
#pragma unroll
    for (int t = 0; t < NW; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mw0 + u * 16 + grp + 8 * (e >> 1);
        const int j = j0 + nw0 + t * 8 + 2 * tig + (e & 1);
        if (m < M && j < fp) out[(long long)j * M + m] = tot[u][t][e];
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

template <int NW, int WN>
int launch(const float* x, const float* g, float* part, int f, int fp, int nx, int ny,
           int nz, int kx, int ky, int kz, int npx, int npy, int npz, const WgradPlan& p,
           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_wgrad_mma<NW, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  conv3d_wgrad_mma<NW, WN><<<dim3((unsigned)p.C, (unsigned)(p.mtiles * p.ntiles)), THREADS,
                             p.smem, st>>>(x, g, part, f, fp, nx, ny, nz, kx, ky, kz, npx,
                                           npy, npz, p.mtiles, p.CI, p.XP, p.TY, p.TX, p.KI,
                                           p.KP, p.GP, p.nyg, p.nxg, p.items, p.C);
  return (int)cudaGetLastError();
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
  int err;
  if (p.NW == 1)
    err = launch<1, 1>(x, g, part, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz, p, st);
  else if (p.NW == 2)
    err = launch<2, 1>(x, g, part, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz, p, st);
  else if (p.WN == 1)
    err = launch<5, 1>(x, g, part, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz, p, st);
  else
    err = launch<5, 2>(x, g, part, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz, p, st);
  if (err != 0) return err;
  const long long E = (long long)fp * f * kx * ky * kz;
  conv3d_wgrad_reduce<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(part, dw, E, C);
  return (int)cudaGetLastError();
}
